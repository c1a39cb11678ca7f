"""The port's flash backward of the low-rank-bias attention (K4,
multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank) on the CPU,
where it takes its plain version, against ``jax.vjp`` of the JAX
package's ``flash_attention_lowrank_bias_trainable`` run in interpret mode
(its Pallas backward, ``_flash_lowrank_bwd``).

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
against the plain version there. Shapes: the JAX test's own
(tests/test_kernels.py:114-141, bias factors scaled by 0.1 there and here),
a case with MViT's zero class-token row in r and zero column in s, and a
bias of 70 factor columns (more than the kernels' chunk of 64). Both sides
get the same numpy inputs and output cotangent. Tolerance: every
cotangent within 1e-4 of its largest magnitude in f32 (the JAX test's own
bound); in bf16 within 2**-7 of it, one bf16 rounding step of the largest
value (both sides round dQ, dK, dV and the forward's output to bf16, and
f32 sums taken in another order can land a value on the other side of a
step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.kernels.flash_attention import (
    flash_attention_lowrank_bias_trainable as jax_trainable)
from multi_modal_csi_tpu_torch import kernels
from multi_modal_csi_tpu_torch.kernels import flash_attention_lowrank as LR
from multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank import (
    flash_attention_lowrank_bias, flash_attention_lowrank_bias_backward,
    flash_attention_lowrank_bias_backward_reference,
    flash_attention_lowrank_bias_trainable)

torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
SHAPES = {                      # (B, H, Nq, Nk, D, M)
    "jax-bias": (2, 2, 300, 130, 32, 11),
    "jax-no-bias": (1, 2, 513, 129, 8, 0),
    "class-token": (2, 1, 257, 65, 16, 9),
    "wide-bias": (1, 2, 130, 70, 8, 70),
}


def _inputs(shape, seed=0):
    """numpy q, k, v, r, s, do; r and s None without a bias. The
    class-token case zeroes r's first row and s's first column."""
    rng = np.random.default_rng(seed)
    b, h, nq, nk, d, m = shape
    q, do = (rng.standard_normal((b, h, nq, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, h, nk, d)).astype(np.float32)
            for _ in range(2))
    r = s = None
    if m:
        r = 0.1 * rng.standard_normal((b, h, nq, m)).astype(np.float32)
        s = 0.1 * rng.standard_normal((m, nk)).astype(np.float32)
        if shape == SHAPES["class-token"]:
            r[:, :, 0] = 0.0
            s[:, 0] = 0.0
    return q, k, v, r, s, do


def _jax_grads(arrays, dtype):
    """(dq, dk, dv[, dr, ds]) of the JAX trainable kernel as f32 numpy."""
    q, k, v, r, s, do = arrays
    jdt = getattr(jnp, dtype)
    args = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    if r is not None:
        args += [jnp.asarray(r), jnp.asarray(s)]
    out, vjp = jax.vjp(lambda *a: jax_trainable(*a, interpret=True), *args)
    grads = vjp(jnp.asarray(do).astype(out.dtype))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _torch(arrays, dtype):
    q, k, v, r, s, do = arrays
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    r, s = (None if a is None else torch.from_numpy(a) for a in (r, s))
    return q, k, v, r, s, do


def _assert_close(got, want, dtype):
    assert len(got) == len(want)
    for name, g, w in zip("qkvrs", got, want):
        g = g.float().numpy()
        assert g.shape == w.shape, name
        top = np.abs(w).max()
        assert np.abs(g - w).max() <= TOL[dtype] * top, (
            name, np.abs(g - w).max(), top)


@pytest.mark.parametrize(
    "case,dtype", [(c, "float32") for c in sorted(SHAPES)]
    + [("jax-bias", "bfloat16"), ("class-token", "bfloat16")])
def test_plain_backward_matches_jax_kernel(case, dtype):
    arrays = _inputs(SHAPES[case])
    want = _jax_grads(arrays, dtype)
    q, k, v, r, s, do = _torch(arrays, dtype)
    out, lse = flash_attention_lowrank_bias(q, k, v, r, s, return_lse=True)
    got = flash_attention_lowrank_bias_backward(q, k, v, r, s, out, lse, do)
    dq, dk, dv, dr, ds = got
    assert (dq.dtype, dk.dtype, dv.dtype) == (q.dtype,) * 3
    if r is None:
        assert dr is None and ds is None
        got = got[:3]
    else:
        assert dr.dtype == ds.dtype == torch.float32
        assert dr.shape == r.shape and ds.shape == s.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_autograd_function_matches_jax_kernel(case):
    arrays = _inputs(SHAPES[case], seed=1)
    want = _jax_grads(arrays, "float32")
    q, k, v, r, s, do = _torch(arrays, "float32")
    leaves = [t.requires_grad_() for t in (q, k, v, r, s) if t is not None]
    out = flash_attention_lowrank_bias_trainable(q, k, v, r, s)
    assert torch.equal(out.detach(), flash_attention_lowrank_bias(
        *(t.detach() if t is not None else None for t in (q, k, v, r, s))))
    out.backward(do)
    _assert_close([t.grad for t in leaves], want, "float32")


def test_cpu_tensors_take_plain_versions_without_counting(monkeypatch):
    """On CPU tensors the wrapper returns the plain version's gradients,
    through each kernel's plain version, and counts no launch."""
    calls = []
    for part in ("dq", "dkv"):
        real = getattr(LR, f"lowrank_backward_{part}_reference")
        monkeypatch.setattr(
            LR, f"lowrank_backward_{part}_reference",
            lambda *a, _real=real, _part=part: calls.append(_part)
            or _real(*a))
    kernels.reset_launch_counts()
    q, k, v, r, s, do = _torch(_inputs(SHAPES["class-token"]), "float32")
    out, lse = flash_attention_lowrank_bias(q, k, v, r, s, return_lse=True)
    got = flash_attention_lowrank_bias_backward(q, k, v, r, s, out, lse, do)
    want = flash_attention_lowrank_bias_backward_reference(
        q, k, v, r, s, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert calls == ["dq", "dkv", "dq", "dkv"]
    assert not any(name.startswith("flash_attention_lowrank")
                   for name in kernels.LAUNCH_COUNTS)


@pytest.mark.parametrize("bad", [
    "r-without-s", "head-dim-160", "out-shape", "out-dtype", "do-shape",
    "lse-shape", "lse-dtype", "s-keys"])
def test_backward_rejects_what_the_kernels_do_not_take(bad):
    shape = (1, 2, 70, 40, 160 if bad == "head-dim-160" else 8, 5)
    q, k, v, r, s, do = _torch(_inputs(shape), "float32")
    out, lse = flash_attention_lowrank_bias(q, k, v, r, s, return_lse=True)
    if bad == "r-without-s":
        s = None
    elif bad == "out-shape":
        out = out[:, :, :69].contiguous()
    elif bad == "out-dtype":
        out = out.to(torch.bfloat16)
    elif bad == "do-shape":
        do = do[..., :4]
    elif bad == "lse-shape":
        lse = lse[:, :1].contiguous()
    elif bad == "lse-dtype":
        lse = lse.double()
    elif bad == "s-keys":
        s = s[:, :39].contiguous()
    with pytest.raises((ValueError, TypeError)):
        flash_attention_lowrank_bias_backward(q, k, v, r, s, out, lse, do)
