"""The arithmetic order of K2's float32 instantiation (THAT training's
attention backward: the query pass and the dK/dV pass of
``csrc/tc_attention_bwd.cuh``, launched by ``csrc/flash_attention_bwd.cu``),
emulated in PyTorch on the CPU and held against ``jax.vjp`` of the JAX
package's ``flash_attention_trainable`` with its Pallas kernels in
interpret mode.

The CUDA kernels run only on the card; this test holds their order of
operations before the card sees it. The query pass (``f32_bwd_k2_order``):
- the head dim zero-padded to a multiple of 8 (the tf32 mma depth);
- key tiles of 32; sweep 1 forms S = (Q K^T) scale as the dK/dV pass forms
  S^T (3xTF32: lo.hi + hi.lo summed apart, each k-step's hi.hi added in
  f32) and dP = dO V^T as 3xTF32 in one sum, and keeps the online row max
  m, l = sum exp(S - m) and c = sum exp(S - m) dP, both rescaled when m
  moves; LSE = m + log l, delta = c / l;
- sweep 2 forms S and dP again, w = exp(S - lse), dl = w (dP - delta) and
  dQ += dl K per tile as 3xTF32, each tile's product formed alone; dQ
  times 1/sqrt(D) at the end.
The dK/dV pass is K4's body without the bias (``f32_bwd_dkv_order`` of
``tests/test_torch_port_tc_attention_order.py``) at one split, fed the
query pass's LSE and delta. Held within 1e-5 of each gradient's largest
magnitude, the JAX package's own bound for its K2
(``tests/test_kernels.py:165-168``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.kernels.flash_attention import (
    flash_attention_trainable as jax_trainable)
from test_torch_port_tc_attention_order import (_logits, _tf32_product,
                                                f32_bwd_dkv_order,
                                                split_tf32)

torch.set_num_threads(1)

KEY_TILE = 32      # kDqKeys of the query pass
TOL = 1e-5

# (B, Nq, H, D) and Nk at batch 2: THAT's left (D = 27) and right (D = 15)
# streams, THAT's right with fewer keys than queries (Nq != Nk, a ragged
# last key tile), and a cross case at D = 45 (span 64) with more keys
SHAPES = {"that-left": ((2, 150, 2, 27), 150),
          "that-right": ((2, 270, 2, 15), 270),
          "ragged": ((2, 70, 3, 15), 97),
          "cross": ((2, 128, 2, 45), 300)}


def f32_bwd_k2_order(q, k, v, do):
    """K2's f32 kernels on (G, Nq, D) q, do and (G, Nk, D) k, v in f32.
    Returns dQ, dK, dV (f32, unpadded) and the query pass's LSE and delta
    (G, Nq)."""
    d = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    pad = -d % 8
    qp, kp, vp, dop = (torch.nn.functional.pad(t, (0, pad))
                       for t in (q, k, v, do))
    g, nq, _ = qp.shape
    nk = kp.shape[1]
    (q_hi, q_lo), (k_hi, k_lo) = split_tf32(qp), split_tf32(kp)
    tiles = [slice(k0, k0 + KEY_TILE) for k0 in range(0, nk, KEY_TILE)]

    def tile(keys):
        s = _logits(q_hi, q_lo, k_hi[:, keys], k_lo[:, keys], scale)
        return s, _tf32_product("gqd", "gkd->gqk", dop, vp[:, keys])

    m = torch.full((g, nq, 1), -math.inf)
    l = torch.zeros((g, nq, 1))
    c = torch.zeros((g, nq, 1))
    for keys in tiles:                      # sweep 1: the statistics
        s, dp = tile(keys)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        x = torch.exp(s - m_new)
        l = l * alpha + x.sum(dim=-1, keepdim=True)
        c = c * alpha + (x * dp).sum(dim=-1, keepdim=True)
        m = m_new
    lse, delta = m + torch.log(l), c / l
    dq = torch.zeros_like(qp)
    for keys in tiles:                      # sweep 2: dQ
        s, dp = tile(keys)
        dl = torch.exp(s - lse) * (dp - delta)
        dq = dq + _tf32_product("gqk", "gkd->gqd", dl, kp[:, keys])
    lse, delta = lse.squeeze(-1), delta.squeeze(-1)
    dk, dv, _ = f32_bwd_dkv_order(q, k, v, None, None, do, lse, delta, 1)
    return (dq * scale)[..., :d], dk, dv, lse, delta


def _arrays(name):
    shape, nk = SHAPES[name]
    b, nq, h, d = shape
    rng = np.random.default_rng(len(name) + d)
    q, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, nk, h, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, do


def _heads(t):
    """(B, N, H, D) numpy -> (B H, N, D) torch, K2's groups b H + h."""
    b, n, h, d = t.shape
    return torch.from_numpy(t).permute(0, 2, 1, 3).reshape(b * h, n, d)


def _tokens(t, b, h):
    """(B H, N, D) torch -> (B, N, H, D) numpy."""
    return t.reshape(b, h, t.shape[1], t.shape[2]).permute(0, 2, 1,
                                                          3).numpy()


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k2_f32_order_matches_jax_kernel(name):
    """dQ, dK and dV of the emulated order within 1e-5 of each gradient's
    largest magnitude of JAX's K2 (interpret mode)."""
    q, k, v, do = _arrays(name)
    b, _, h, _ = q.shape
    _, vjp = jax.vjp(lambda *a: jax_trainable(*a, interpret=True),
                     *(jnp.asarray(t) for t in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = f32_bwd_k2_order(*(_heads(t) for t in (q, k, v, do)))[:3]
    for grad, g, w in zip(("dq", "dk", "dv"), got, want):
        g = _tokens(g, b, h)
        assert g.shape == w.shape, grad
        err = np.abs(g - w).max()
        assert err <= TOL * np.abs(w).max(), (grad, err)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k2_f32_statistics_and_weights(name):
    """The query pass's LSE and delta against float64 (1e-6 relative and
    1e-5 of delta's largest magnitude), and the weights the dK/dV pass
    forms from the same logits and that LSE: each row sums to 1 within
    1e-5."""
    q, k, v, do = (_heads(t) for t in _arrays(name))
    _, _, _, lse, delta = f32_bwd_k2_order(q, k, v, do)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    s64 = torch.einsum("gqd,gkd->gqk", q64, k64) / math.sqrt(q.shape[-1])
    lse64 = torch.logsumexp(s64, dim=-1)
    w64 = torch.softmax(s64, dim=-1)
    delta64 = (w64 * torch.einsum("gqd,gkd->gqk", do64, v64)).sum(dim=-1)
    assert ((lse.double() - lse64).abs() / lse64.abs()).max() <= 1e-6
    assert ((delta.double() - delta64).abs().max()
            <= TOL * delta64.abs().max())
    d = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    pad = -d % 8
    (q_hi, q_lo), (k_hi, k_lo) = (split_tf32(torch.nn.functional.pad(
        t, (0, pad))) for t in (q, k))
    w = torch.exp(_logits(q_hi, q_lo, k_hi, k_lo, scale) - lse[..., None])
    assert (w.sum(dim=-1) - 1.0).abs().max() <= 1e-5
