"""The port's low-rank-bias attention module (multi_modal_csi_tpu_torch.
kernels.flash_attention_lowrank) on the CPU, where it takes its plain
version, against the JAX package's Pallas kernel run in interpret mode.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against the plain version there. The shapes are the JAX package's own test
shapes (tests/test_kernels.py:85-86): scaled-down MViT-v2 blocks with the
class-token row and column of the bias zero, and the no-bias case, with Nq
and Nk multiples of no tile. Tolerances: f32 2e-5 absolute, the JAX test's
bound; bf16 2**-7 of the largest |out|, about one bf16 step of it (both
sides round the weights and the output to bf16, and an f32 sum taken in
another order can put a value on the other side of a step); the row
log-sum-exp 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.kernels.flash_attention import (
    flash_attention_lowrank_bias as jax_lowrank)
from multi_modal_csi_tpu_torch import kernels
from multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank import (
    flash_attention_lowrank_bias, flash_attention_lowrank_bias_reference)

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_TOL = 2.0 ** -7
LSE_RTOL = 1e-5
SHAPES = {                      # (B, H, Nq, Nk, D, M)
    "v2-stage1": (2, 1, 300, 37, 16, 5),
    "v2-stage2": (1, 2, 513, 129, 8, 11),
    "v2-stage3": (2, 4, 257, 128, 24, 9),
    "v1-no-bias": (1, 8, 128, 128, 96, 0),
}


def _inputs(shape, seed=0):
    """numpy q, k, v, r, s (r, s None without bias); the bias's class-token
    row and column are zero, as MViT passes them."""
    rng = np.random.default_rng(seed)
    b, h, nq, nk, d, m = shape
    q = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, nk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, nk, d)).astype(np.float32)
    r = s = None
    if m:
        r = rng.standard_normal((b, h, nq, m)).astype(np.float32)
        s = rng.standard_normal((m, nk)).astype(np.float32)
        r[:, :, 0] = 0.0
        s[:, 0] = 0.0
    return q, k, v, r, s


def _torch(arrays, dtype):
    q, k, v, r, s = arrays
    cast = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return cast + [None if a is None else torch.from_numpy(a) for a in (r, s)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plain_version_matches_jax_kernel(case, dtype):
    arrays = _inputs(SHAPES[case])
    q, k, v, r, s = arrays
    jdt = getattr(jnp, dtype)
    jr = None if r is None else jnp.asarray(r)
    js = None if s is None else jnp.asarray(s)
    want, want_lse = jax_lowrank(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), jr, js, interpret=True, return_lse=True)
    want = np.asarray(want.astype(jnp.float32))
    want_lse = np.asarray(want_lse)[:, :, :q.shape[2], 0]

    got, lse = flash_attention_lowrank_bias(*_torch(arrays, getattr(
        torch, dtype)), return_lse=True)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    tol = F32_TOL if dtype == "float32" else BF16_TOL * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=LSE_RTOL)


def test_cpu_tensors_take_plain_version_without_counting():
    kernels.reset_launch_counts()
    args = _torch(_inputs(SHAPES["v2-stage1"]), torch.float32)
    got = flash_attention_lowrank_bias(*args)
    assert torch.equal(got, flash_attention_lowrank_bias_reference(*args))
    assert kernels.LAUNCH_COUNTS.get("flash_attention_lowrank_bias", 0) == 0


@pytest.mark.parametrize("bad", [
    "rank", "heads", "head-dim", "no-keys", "dtype", "mixed", "strided",
    "r-without-s", "r-rows", "s-keys", "factor-dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v, r, s = _torch(_inputs((2, 2, 70, 40, 8, 5)), torch.float32)
    if bad == "rank":
        q = q[0]
    elif bad == "heads":
        k = k[:, :1].contiguous()
    elif bad == "head-dim":
        v = v[..., :4].contiguous()
    elif bad == "no-keys":
        k, v, s = (k[:, :, :0].contiguous(), v[:, :, :0].contiguous(),
                   s[:, :0].contiguous())
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.to(torch.bfloat16)
    elif bad == "strided":
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "r-without-s":
        s = None
    elif bad == "r-rows":
        r = r[:, :, :69].contiguous()
    elif bad == "s-keys":
        s = s[:, :39].contiguous()
    else:
        r = r.to(torch.bfloat16)
    with pytest.raises((ValueError, TypeError)):
        flash_attention_lowrank_bias(q, k, v, r, s)
