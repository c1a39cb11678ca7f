"""The int8 serving products of the port (kernels/int8_matmul.py, P1's
counterpart) and the int8 conv/dense arithmetic around them
(core/quantize.py), on the CPU, where the wrappers take their plain
versions.

- The plain s8 product is exact: equal to JAX's int8 x int8 -> int32
  ``dot_general`` at P1's own tile (tools/exp_pallas_int8.py:36-46).
- The plain bf16 product keeps f32 (never rounds to bf16): within the f32
  summation bound K * 2^-24 * sum |a b| of JAX's f32-accumulated
  ``dot_general`` on the same bf16 values.
- The quantized conv (im2col into the product, groups as its batch) is
  exactly the integer convolution for int8 operands, at "SAME", symmetric,
  strided, dilated and grouped settings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multi_modal_csi_tpu_torch.core.quantize import conv_forward
from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
from multi_modal_csi_tpu_torch.nn import layers as P
from test_torch_port_layers import gen

torch.set_num_threads(1)

P1_TILE = (256, 272, 424)         # M, K, N (tools/exp_pallas_int8.py:36)


def int8_operands(m, k, n, seed=0, groups=None):
    rng = np.random.default_rng(seed)
    lead = () if groups is None else (groups,)
    a = rng.integers(-128, 128, lead + (m, k), dtype=np.int8)
    b = rng.integers(-128, 128, lead + (n, k), dtype=np.int8)
    return a, b


def test_int8_reference_exact_against_jax_at_p1_tile():
    m, k, n = P1_TILE
    a, b = int8_operands(m, k, n)
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(b).T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    got = K.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        K.int8_matmul_reference(torch.from_numpy(a),
                                torch.from_numpy(b)).numpy(), want)


def test_bf16_reference_keeps_f32_against_jax_at_p1_tile():
    m, k, n = P1_TILE
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((n, k)), jnp.bfloat16)
    want = np.asarray(jax.lax.dot_general(
        a, b.T, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32))
    ta = torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    tb = torch.from_numpy(np.array(b.astype(jnp.float32))).bfloat16()
    got = K.bf16_matmul_f32(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    mag = np.abs(np.asarray(a, np.float64)) @ np.abs(np.asarray(b,
                                                               np.float64)).T
    assert np.all(np.abs(got.numpy() - want) <= k * 2.0 ** -24 * mag)
    # not rounded to bf16, as F.linear on bf16 operands would be
    assert not torch.equal(got, got.bfloat16().float())


@pytest.mark.parametrize("m,k,n,groups", [(1, 1, 1, None), (17, 33, 65, None),
                                          (30, 270 * 3, 27, None),
                                          (9, 46, 12, 3)])
def test_wrappers_exact_and_grouped(m, k, n, groups):
    a, b = (torch.from_numpy(t) for t in int8_operands(m, k, n, 2, groups))
    got = K.int8_matmul(a, b)
    want = torch.from_numpy(np.matmul(a.numpy().astype(np.int64),
                                      np.swapaxes(b.numpy(), -1, -2)
                                      .astype(np.int64)).astype(np.int32))
    assert torch.equal(got, want)
    fa, fb = a.float().bfloat16(), b.float().bfloat16()
    got = K.bf16_matmul_f32(fa, fb)
    assert got.dtype == torch.float32
    # |a|, |b| <= 128 are exact in bf16: integer products summed in f32,
    # exact while |sum| < 2^24
    assert torch.equal(got, want.float())


@pytest.mark.parametrize("bad", ["dtype", "shape", "k0", "k-overflow",
                                 "groups"])
def test_wrappers_refuse_what_the_kernel_does_not_take(bad):
    a, b = (torch.from_numpy(t) for t in int8_operands(4, 8, 4))
    if bad == "dtype":
        a = a.float()
    elif bad == "shape":
        b = b[:, :7]
    elif bad == "k0":
        a, b = a[:, :0], b[:, :0]
    elif bad == "k-overflow":
        a = torch.zeros((1, K.MAX_K_S8 + 1), dtype=torch.int8)
        b = torch.zeros((1, K.MAX_K_S8 + 1), dtype=torch.int8)
    else:
        a = a[None]
    with pytest.raises((TypeError, ValueError)):
        K.int8_matmul(a, b)
    assert K.MAX_K_S8 * 128 ** 2 <= 2 ** 31 - 1


def _pads(padding, length, k, stride, dilation):
    conv = P.Conv1d(4, 4, k, stride=stride, padding=padding,
                    dilation=dilation, generator=gen())
    return conv.pads(length)


@pytest.mark.parametrize("k,stride,padding,dilation,groups", [
    (3, 1, "SAME", 1, 1), (2, 1, "SAME", 1, 1), (3, 1, 2, 2, 1),
    (5, 2, 1, 1, 1), (4, 4, "VALID", 1, 1), (3, 1, "SAME", 1, 3)],
    ids=["same", "same-k2", "dilated", "strided", "k-eq-stride", "grouped"])
def test_int8_conv_is_the_integer_convolution(k, stride, padding, dilation,
                                              groups):
    """conv_forward with unit scales under w8a8 against the exact integer
    convolution (float64 conv1d of the int8 values)."""
    rng = np.random.default_rng(3)
    c, n, length = 12, 9, 23
    xq = rng.integers(-127, 128, (2, length, c)).astype(np.float32)
    w = torch.from_numpy(rng.integers(-127, 128, (n, c // groups, k),
                                      dtype=np.int8))
    pads = _pads(padding, length, k, stride, dilation)
    got = conv_forward(torch.from_numpy(xq), w, torch.ones(n),
                       torch.tensor(1.0), pads=pads, stride=stride,
                       dilation=dilation, groups=groups)
    want = F.conv1d(F.pad(torch.from_numpy(xq).double().transpose(1, 2),
                          pads), w.double(), stride=stride,
                    dilation=dilation, groups=groups).transpose(1, 2)
    assert got.shape == want.shape
    assert torch.equal(got.double(), want)
