"""The port's attention backward (K2: kernels/flash_attention.py::
flash_attention_backward and the differentiable flash_attention_trainable)
on the CPU, where they take their plain versions, against ``jax.vjp`` of
the JAX package's ``flash_attention_trainable`` with its Pallas kernels in
interpret mode.

Shapes: THAT's left (2, 150, 10, 27) and right (2, 270, 10, 15) at batch
2, a ragged (3, 70, 10, 15) with 97 keys, and a cross case (2, 128, 6, 45)
with 420 keys. Inputs and the output gradient are standard normals from a
numpy seed.

Tolerances, per gradient, against that gradient's largest magnitude:
f32 1e-5, the JAX package's own bound for its kernel
(tests/test_kernels.py:165-168); measured at most 6e-7. bf16 2**-7, one
bf16 rounding step of the largest value: both sides store dQ, dK, dV in
bf16 and round the weights for dV, and an f32 sum taken in another order
can land on the other side of a rounding step; measured at most 7e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.kernels.flash_attention import (
    flash_attention_trainable as jax_trainable)
from multi_modal_csi_tpu_torch import kernels
from multi_modal_csi_tpu_torch.kernels.flash_attention import (
    flash_attention, flash_attention_backward,
    flash_attention_backward_reference, flash_attention_trainable)

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
SHAPES = {
    "that-left": ((2, 150, 10, 27), 150),
    "that-right": ((2, 270, 10, 15), 270),
    "ragged": ((3, 70, 10, 15), 97),
    "cross": ((2, 128, 6, 45), 420),
}


def _arrays(case, seed=0):
    shape, nk = SHAPES[case]
    rng = np.random.default_rng(seed)
    b, nq, h, d = shape
    q = rng.standard_normal(shape).astype(np.float32)
    k = rng.standard_normal((b, nk, h, d)).astype(np.float32)
    v = rng.standard_normal((b, nk, h, d)).astype(np.float32)
    do = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, do


@functools.cache
def _jax_grads(case, dtype):
    """dQ, dK, dV from jax.vjp of the JAX package's trainable kernel in
    interpret mode, as f32 numpy."""
    jdt = getattr(jnp, dtype)
    q, k, v, do = (jnp.asarray(a).astype(jdt) for a in _arrays(case))
    _, vjp = jax.vjp(lambda *a: jax_trainable(*a, interpret=True), q, k, v)
    return tuple(np.asarray(g.astype(jnp.float32)) for g in vjp(do))


def _torch(case, dtype):
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(tdt) for a in _arrays(case)]


def _assert_close(got, want, dtype):
    for name, g, w in zip("qkv", got, want):
        err = np.abs(g.float().numpy() - w).max()
        assert err <= TOL[dtype] * np.abs(w).max(), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_backward_matches_jax_kernel(case, dtype):
    q, k, v, do = _torch(case, dtype)
    got = flash_attention_backward(q, k, v, do)
    assert [g.dtype for g in got] == [q.dtype] * 3
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    _assert_close(got, _jax_grads(case, dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_trainable_function_matches_jax_vjp(case, dtype):
    """The autograd Function: the forward is K1's, the gradients K2's, in
    the inputs' dtype, for an output gradient of any layout."""
    q, k, v, do = _torch(case, dtype)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_trainable(*leaves)
    assert torch.equal(out.detach(), flash_attention(q, k, v))
    # a non-contiguous f32 output gradient, as a transposed product gives
    out.backward(do.float().transpose(1, 2).contiguous().transpose(1, 2))
    got = [t.grad for t in leaves]
    assert [g.dtype for g in got] == [q.dtype] * 3
    _assert_close(got, _jax_grads(case, dtype), dtype)


def test_cpu_backward_counts_no_launch():
    kernels.reset_launch_counts()
    q, k, v, do = _torch("ragged", "float32")
    got = flash_attention_backward(q, k, v, do)
    want = flash_attention_backward_reference(q, k, v, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernels.LAUNCH_COUNTS == {}


@pytest.mark.parametrize("bad", ["do-shape", "do-device", "k-dtype",
                                 "strided"])
def test_backward_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, do = _torch("ragged", "float32")
    if bad == "do-shape":
        do = do[:, :10]
    elif bad == "do-device":
        do = do.to("meta")
    elif bad == "k-dtype":
        k = k.to(torch.bfloat16)
    else:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_backward(q, k, v, do)
