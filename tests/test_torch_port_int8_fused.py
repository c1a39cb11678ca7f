"""The fused path of the port's int8 serving (kernels/int8_matmul.py:
``quantize_columns``, the prologue, and ``quantized_product``, the product
with its epilogue) on the CPU, where both take their plain versions,
against the JAX package's core/quantize.py on the same seeded numpy
inputs, int8 weights and scales.

- The prologue's int8 codes are JAX's ``quantize_activation`` bit for bit,
  laid out as the columns of JAX's ``conv_forward`` (the padded input
  unfolded in the weight's (channel, tap) order), at the padded stride
  with zeros in the pad, at K = 270 and 810 and at odd pads, strides,
  dilations and groups.
- The int32 product of those columns with the int8 weight is JAX's
  int8 x int8 -> int32 ``dot`` / ``conv_general_dilated`` bit for bit.
- ``quantized_product`` with a bias and either output type is JAX's
  ``dense_forward`` / ``conv_forward`` plus the bias and the cast, within
  test_torch_port_quantize.py's LAYER_TOL of the output's largest
  magnitude; a bf16 output also within one bf16 rounding (2^-8 of the
  value), since XLA:CPU may contract the rescale and the bias into an FMA
  and the cast can then land on the other side.
- Padding changes nothing: the padded product equals the unpadded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from multi_modal_csi_tpu.core import quantize as qz
from multi_modal_csi_tpu_torch.core import quantize as Q
from multi_modal_csi_tpu_torch.kernels import int8_matmul as K
from multi_modal_csi_tpu_torch.nn import layers as P
from test_torch_port_layers import gen

torch.set_num_threads(1)

LAYER_TOL = 1e-5          # of the output's largest magnitude (as in
                          # test_torch_port_quantize.py)
BF16_STEP = 2.0 ** -8     # one bf16 rounding of the value
SCALE = np.float32(0.05)

# (batch, length, channels, k, stride, dilation, pads, groups, out)
GEOMETRIES = {
    "dense-270": (2, 9, 270, 1, 1, 1, (0, 0), 1, 64),
    "dilated-810": (2, 12, 270, 3, 1, 2, (2, 2), 1, 40),
    "same-k2": (2, 11, 20, 2, 1, 1, (0, 1), 1, 12),
    "strided-odd": (3, 17, 12, 5, 2, 1, (1, 2), 1, 9),
    "k-eq-stride": (2, 20, 16, 4, 4, 1, (0, 0), 1, 8),
    "grouped": (2, 13, 12, 3, 1, 3, (3, 3), 3, 9),
}


def inputs(name, seed=0):
    b, length, c, k, stride, dil, pads, groups, n = GEOMETRIES[name]
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((b, length, c))).astype(np.float32)
    x[0, 0, :8] = (np.arange(-4, 4) + 0.5) * SCALE   # ties at half steps
    w = rng.integers(-127, 128, (n, c // groups, k), dtype=np.int8)
    ws = (1e-3 + 1e-2 * rng.random(n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return x, w, ws, bias


def numpy_columns(xq, k, stride, dil, pads, groups):
    """The im2col of channels-last xq (B, L, C): (B L_out, G, C/G k) in
    the (channel, tap) order of the (N, C/G, k) weight."""
    b, length, c = xq.shape
    xp = np.pad(xq, ((0, 0), pads, (0, 0)))
    lout = (length + sum(pads) - (k - 1) * dil - 1) // stride + 1
    taps = [xp[:, t * dil: t * dil + (lout - 1) * stride + 1: stride]
            for t in range(k)]                           # k x (B, L_out, C)
    cols = np.stack(taps, axis=-1)                        # (B, L_out, C, k)
    return cols.reshape(b * lout, groups, c // groups * k)


def jax_conv(x, kernel, stride, dil, pads, groups, int32=False):
    dn = jax.lax.conv_dimension_numbers(x.shape, kernel.shape,
                                        ("NHC", "HIO", "NHC"))
    return jax.lax.conv_general_dilated(
        x, kernel, window_strides=(stride,), padding=[pads],
        rhs_dilation=(dil,), dimension_numbers=dn,
        feature_group_count=groups,
        preferred_element_type=jnp.int32 if int32 else None)


class _JaxQuantized(fnn.Module):
    """Calls JAX's own dense_forward / conv_forward on an int8 kernel,
    with kernel_scale (and input_scale) given as params."""
    conv: tuple = ()

    @fnn.compact
    def __call__(self, x, kernel):
        if not self.conv:
            return qz.dense_forward(self, x, kernel)
        stride, dil, pads, groups = self.conv
        dn = jax.lax.conv_dimension_numbers(x.shape, kernel.shape,
                                            ("NHC", "HIO", "NHC"))
        return qz.conv_forward(self, x, kernel, window_strides=(stride,),
                               padding=[pads], rhs_dilation=(dil,),
                               dimension_numbers=dn,
                               feature_group_count=groups)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_prologue_codes_and_columns_match_jax(name):
    x, _, _, _ = inputs(name)
    _, _, c, k, stride, dil, pads, groups, _ = GEOMETRIES[name]
    xq = np.asarray(qz.quantize_activation(jnp.asarray(x), SCALE))
    got = K.quantize_columns(torch.from_numpy(x), torch.tensor(SCALE), k,
                             stride, dil, pads, groups)
    want = numpy_columns(xq, k, stride, dil, pads, groups)
    kg = c // groups * k
    assert got.dtype == torch.int8
    assert got.shape[:2] == want.shape[:2] and got.shape[2] % 16 == 0
    assert got.shape[2] == K.padded_width(kg, torch.int8) >= kg
    np.testing.assert_array_equal(got[..., :kg].numpy(), want)
    assert not got[..., kg:].any()
    # w8: the same columns of x as bf16, at a stride of 8 bf16 values
    got = K.quantize_columns(torch.from_numpy(x), None, k, stride, dil,
                             pads, groups)
    want = numpy_columns(np.asarray(jnp.asarray(x, jnp.bfloat16)
                                    .astype(jnp.float32)),
                         k, stride, dil, pads, groups)
    assert got.dtype == torch.bfloat16 and got.shape[2] % 8 == 0
    np.testing.assert_array_equal(got[..., :kg].float().numpy(), want)
    assert not got[..., kg:].any()


@pytest.mark.parametrize("name", ["dense-270", "dilated-810", "grouped"])
def test_int32_product_matches_jax_bit_for_bit(name):
    x, w, _, _ = inputs(name, 1)
    _, _, c, k, stride, dil, pads, groups, n = GEOMETRIES[name]
    kernel = jnp.asarray(np.transpose(w, (2, 1, 0)))         # (k, C/G, N)
    xq = qz.quantize_activation(jnp.asarray(x), SCALE)
    want = np.asarray(jax_conv(xq, kernel, stride, dil, pads, groups, True))
    a = K.quantize_columns(torch.from_numpy(x), torch.tensor(SCALE), k,
                           stride, dil, pads, groups)
    kg = c // groups * k
    b = K.pad_columns(torch.from_numpy(w).reshape(groups, n // groups, kg))
    got = K.int8_matmul(a.transpose(0, 1).contiguous(), b)   # (G, M, N/G)
    got = got.transpose(0, 1).reshape(want.shape)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("name", ["dense-270", "dilated-810", "strided-odd",
                                  "grouped"])
def test_quantized_product_matches_jax(name, mode, out_dtype):
    x, w, ws, bias = inputs(name, 2)
    _, _, c, k, stride, dil, pads, groups, n = GEOMETRIES[name]
    kernel = jnp.asarray(np.transpose(w, (2, 1, 0)))
    params = {"kernel_scale": jnp.asarray(ws)}
    if mode == "w8a8":
        params["input_scale"] = jnp.float32(SCALE)
    xj = jnp.asarray(x)
    if name == "dense-270":
        y = _JaxQuantized().apply({"params": params}, xj, kernel[0])
    else:
        y = _JaxQuantized(conv=(stride, dil, pads, groups)).apply(
            {"params": params}, xj, kernel)
    jdtype = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    want = np.asarray((y + jnp.asarray(bias)).astype(jdtype)
                      .astype(jnp.float32))

    s = torch.tensor(SCALE) if mode == "w8a8" else None
    a = K.quantize_columns(torch.from_numpy(x), s, k, stride, dil, pads,
                           groups)
    kg = c // groups * k
    b = K.pad_columns(torch.from_numpy(w).reshape(n, kg))
    if groups > 1:
        b = b.reshape(groups, n // groups, -1)
    got = K.quantized_product(a, b, torch.from_numpy(ws), s,
                              torch.from_numpy(bias), out_dtype, k=kg)
    assert got.dtype == out_dtype and got.shape == (want.shape[0]
                                                    * want.shape[1], n)
    got = got.float().numpy().reshape(want.shape)
    tol = LAYER_TOL * np.abs(want).max()
    if out_dtype == torch.bfloat16:
        tol = tol + BF16_STEP * np.abs(want)
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("k", [270, 810, 46, 1])
def test_padded_product_equals_unpadded(k):
    rng = np.random.default_rng(k)
    m, n = 37, 30
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    ws = torch.from_numpy((1e-2 * rng.random(n)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    ap, bp = K.pad_columns(a), K.pad_columns(b)
    assert ap.shape[1] % 16 == 0 and not ap[:, k:].any()
    assert torch.equal(K.int8_matmul_reference(ap, bp),
                       K.int8_matmul_reference(a, b))
    s = torch.tensor(SCALE)
    for out_dtype in (torch.float32, torch.bfloat16):
        assert torch.equal(
            K.quantized_product(ap, bp, ws, s, bias, out_dtype, k=k),
            K.quantized_product(a, b, ws, s, bias, out_dtype, k=k))
        abf = a.to(torch.bfloat16)
        assert torch.equal(
            K.quantized_product(K.pad_columns(abf), bp, ws, None, bias,
                                out_dtype, k=k),
            K.quantized_product(abf, b, ws, None, bias, out_dtype, k=k))


def test_padded_weights_are_made_once_and_stay_out_of_the_state_dict():
    """quantize_model and load_quantized give each int8 weight its padded
    copy as a non-persistent buffer: the state dict is the same, and the
    layers' outputs do not change."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 12, 20)).astype(np.float32))

    def model():
        torch.manual_seed(0)
        return torch.nn.Sequential(
            P.Conv1d(20, 24, 3, padding="SAME", generator=gen()),
            P.Linear(24, 16, generator=gen())).eval()

    m = model()
    Q.quantize_for_serving(m, [x], mode="w8a8", min_size=1)
    for layer in m:
        kg = layer.weight[0].numel()
        padded = layer.weight_padded
        assert padded.dtype == torch.int8 and padded.shape[1] % 16 == 0
        assert torch.equal(padded[:, :kg],
                           layer.weight.reshape(len(padded), kg))
        assert not padded[:, kg:].any()
    state = m.state_dict()
    assert not any(name.endswith("_padded") for name in state)
    loaded = Q.load_quantized(model(), state)
    assert all(torch.equal(a.weight_padded, b.weight_padded)
               for a, b in zip(m, loaded))
    with torch.no_grad():
        assert torch.equal(m(x), loaded(x))


@pytest.mark.parametrize("bad", ["f32-a", "int8-a-no-scale", "bf16-a-scale",
                                 "out-int32", "k-too-wide", "scale-shape",
                                 "groups"])
def test_quantized_product_refuses_what_the_kernel_does_not_take(bad):
    a = torch.zeros((4, 32), dtype=torch.int8)
    b = torch.zeros((6, 32), dtype=torch.int8)
    ws, s, out, k = torch.ones(6), torch.tensor(1.0), torch.float32, 30
    if bad == "f32-a":
        a = a.float()
    elif bad == "int8-a-no-scale":
        s = None
    elif bad == "bf16-a-scale":
        a = a.to(torch.bfloat16)
    elif bad == "out-int32":
        out = torch.int32
    elif bad == "k-too-wide":
        k = 33
    elif bad == "scale-shape":
        ws = torch.ones(5)
    else:
        b = b.reshape(2, 3, 32)
    with pytest.raises((TypeError, ValueError)):
        K.quantized_product(a, b, ws, s, None, out, k=k)


@pytest.mark.parametrize("bad", ["int8-x", "2d-x", "groups", "no-rows"])
def test_quantize_columns_refuses_what_the_kernel_does_not_take(bad):
    x, kw = torch.zeros((2, 8, 12)), {}
    if bad == "int8-x":
        x = x.to(torch.int8)
    elif bad == "2d-x":
        x = x[0]
    elif bad == "groups":
        kw = {"groups": 5}
    else:
        kw = {"k": 20}
    with pytest.raises(ValueError):
        K.quantize_columns(x, torch.tensor(1.0), **kw)


def test_split_count_and_direct_operand():
    """Split-K only where the tiles leave SMs idle and K is long; a bf16
    activation goes to the product as it is only where 4-byte copies
    divide its rows."""
    assert K.split_count(1, 2560, 270, 27008) == 5          # 60 tiles
    assert K.split_count(1, 256000, 270, 816) == 1          # 6000 tiles
    assert K.split_count(1, 1280, 2048, 272) == 1           # K too short
    assert K.split_count(1, 1280, 270, 2048) == 4           # 30 tiles
    x = torch.zeros((2, 3, 270), dtype=torch.bfloat16)
    rows = K.direct_operand(x)
    assert rows.shape == (6, 270) and rows.data_ptr() == x.data_ptr()
    assert K.direct_operand(x.float()) is None
    assert K.direct_operand(torch.zeros((6, 27), dtype=torch.bfloat16)) is None
    assert K.direct_operand(x[..., 1:]) is None             # 538-byte rows
    assert K.direct_operand(x.transpose(1, 2)) is None      # strided columns


def test_prologue_reads_a_transposed_input_as_it_is():
    """A channels-last view of a channels-first tensor (as a float conv
    returns it) gives the columns of its contiguous copy."""
    x, _, _, _ = inputs("dilated-810", 4)
    _, _, c, k, stride, dil, pads, groups, _ = GEOMETRIES["dilated-810"]
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
    assert not xt.is_contiguous()
    for scale in (torch.tensor(SCALE), None):
        assert torch.equal(
            K.quantize_columns(xt, scale, k, stride, dil, pads, groups),
            K.quantize_columns(xt.contiguous(), scale, k, stride, dil, pads,
                               groups))
