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

K2's bfloat16 instantiation (``bf16_bwd_k2_order``) is the same two
passes on the bf16 tensor-core fragments: the query pass forms S and dP
as bf16 products summed in f32 per k-step of 16 (``_k16_sum``), keeps the
same online statistics, and forms dQ per 32-key tile from dl split into
bf16 hi + lo; the dK/dV pass is K4's bf16 body without the bias
(``bf16_bwd_dkv_order``) at one split in K2's form, dV from w rounded once
to bf16 (the TPU kernel's ``w.astype``). Both copy each head's rows in
aligned pieces from h D - sh on (``k2_bf16_copy``, the launcher's
``bwd_pick_copy``), so the head's element c sits at position sh + c and
the k-steps of 16 group the products by position. Held within 2^-7 of
each gradient's largest magnitude of JAX's K2 in bf16 (chip_smoke.py's
BWD_TOL in bf16), and its f32 sums before the bf16 store within 1e-4 of
the plain version's.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.kernels.flash_attention import (
    flash_attention_trainable as jax_trainable)
from multi_modal_csi_tpu_torch.kernels.flash_attention import (
    flash_attention_backward_sums)
from test_torch_port_tc_attention_order import (MAX_SHARED_BYTES, _bf16,
                                                _bf16_split, _k16_sum,
                                                _logits, _tf32_product,
                                                bf16_bwd_dkv_order,
                                                bf16_dkv_smem,
                                                f32_bwd_dkv_order, place,
                                                split_tf32, take)

torch.set_num_threads(1)

KEY_TILE = 32      # kDqKeys of the query pass
QUERY_ROWS = 64    # kDqRows: 4 warps of 16 query rows
TOL = 1e-5
BF16_TOL = 2.0 ** -7
SUMS_TOL = 1e-4

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


def k2_bf16_copy(heads, d):
    """K2's bf16 copies (``csrc/tc_attention_bwd.cuh``, ``bwd_pick_copy``)
    for contiguous (B, N, H, D) tensors: the widest of 8, 4, 2 or 1 bf16
    that divides the row stride H D and keeps every head's shifted span,
    h D mod the width + D, within 128 positions. Returns the width and the
    span, or None past D = 128."""
    for vec in (8, 4, 2, 1):
        if heads * d % vec == 0:
            span = max(h * d % vec + d for h in range(min(heads, vec)))
            if span <= 128:
                return vec, span
    return None


def k2_shifts(b, heads, d):
    """Each group's (b H + h) position of element 0: h D mod the width."""
    vec, _ = k2_bf16_copy(heads, d)
    return [g % heads * d % vec for g in range(b * heads)]


def bf16_bwd_k2_order(q, k, v, do, shifts=None, round_w=True, dq_lo=True):
    """K2's bf16 kernels on (G, Nq, D) q, do and (G, Nk, D) k, v holding
    bf16 values, each group's element 0 at position ``shifts[g]``
    (``k2_shifts``). ``round_w``: dV from w rounded once (K2's form; False
    takes K4's hi + lo); ``dq_lo``: dQ from dl's hi + lo (False: hi
    alone). Returns dQ, dK, dV as f32 sums before their bf16 store, and the
    query pass's LSE and delta (G, Nq)."""
    d = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    qp, kp, vp, dop = (place(t.float(), shifts) for t in (q, k, v, do))
    g, nq, _ = qp.shape
    tiles = [slice(k0, k0 + KEY_TILE) for k0 in range(0, kp.shape[1],
                                                        KEY_TILE)]

    def tile(keys):
        return (_k16_sum("gqd,gkd->gqk", qp, kp[:, keys]) * scale,
                _k16_sum("gqd,gkd->gqk", dop, vp[:, keys]))

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
        dl_hi, dl_lo = _bf16_split(torch.exp(s - lse) * (dp - delta))
        part = torch.einsum("gqk,gkd->gqd", dl_hi, kp[:, keys])
        if dq_lo:
            part = torch.einsum("gqk,gkd->gqd", dl_lo, kp[:, keys]) + part
        dq = dq + part
    lse, delta = lse.squeeze(-1), delta.squeeze(-1)
    dk, dv, _ = bf16_bwd_dkv_order(q, k, v, None, None, do, lse, delta, 1,
                                   round_w=round_w, shifts=shifts)
    return take(dq * scale, d, shifts), dk, dv, lse, delta


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


@functools.lru_cache(maxsize=None)
def _bf16_case(name):
    """SHAPES[name]'s seeded inputs rounded to bf16 as (B H, N, D) torch
    groups with the launcher's shifts, and the gradients of jax.vjp of
    JAX's K2 in bf16 (interpret mode) as f32 numpy (B, N, H, D)."""
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (_bf16(t) for t in
                                                _arrays(name))
    _, vjp = jax.vjp(lambda *a: jax_trainable(*a, interpret=True), jq, jk,
                     jv)
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jdo)]
    groups = [_heads(t.float().numpy()) for t in (tq, tk, tv, tdo)]
    b, _, h, d = want[0].shape
    return groups, k2_shifts(b, h, d), want


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k2_bf16_order_matches_jax_kernel(name):
    """dQ, dK and dV of the emulated bf16 order, rounded to bf16 as the
    kernels store them, within 2^-7 of each gradient's largest magnitude
    of JAX's K2 in bf16 (interpret mode)."""
    groups, shifts, want = _bf16_case(name)
    b, _, h, _ = want[0].shape
    got = bf16_bwd_k2_order(*groups, shifts)[:3]
    for grad, g, w in zip(("dq", "dk", "dv"), got, want):
        g = _tokens(g.to(torch.bfloat16).float(), b, h)
        assert g.shape == w.shape, grad
        err = np.abs(g - w).max()
        assert err <= BF16_TOL * np.abs(w).max(), (grad, err)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k2_bf16_sums_match_plain_version(name):
    """The emulated order's f32 sums before the bf16 store against the
    plain version's (``flash_attention_backward_sums``) on the same bf16
    inputs, within 1e-4 of each maximum. Both round w once to bf16 for
    dV, from f32 weights formed in another order (exp(S - lse) here,
    exp(S - max) / sum there), so a weight near a rounding midpoint can
    land one bf16 step apart: dV is held after those steps times dO are
    added to the plain version's, and they must be rare (under 1e-3 of
    the weights) and one step each. The bound sees the kernels' two
    choices: dV from w kept in hi + lo (not rounded once, as the TPU
    kernel rounds it) or dQ from dl's hi alone misses it."""
    groups, shifts, want = _bf16_case(name)
    b, _, h, _ = want[0].shape
    q, k, v, do = (torch.from_numpy(_tokens(t, b, h)).to(torch.bfloat16)
                   for t in groups)
    plain = [_heads(t.numpy()) for t in
             flash_attention_backward_sums(q, k, v, do)]
    # the weights each side rounds for dV: the kernels' from their bf16
    # products and LSE, the plain version's softmax in f32
    qg, kg, _, dog = groups
    lse = bf16_bwd_k2_order(*groups, shifts)[3]
    scale = torch.tensor(1.0 / math.sqrt(qg.shape[-1]), dtype=torch.float32)
    w_k = torch.exp(_k16_sum("gqd,gkd->gqk", place(qg, shifts),
                             place(kg, shifts)) * scale - lse[..., None])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w_p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    w_p = (w_p / w_p.sum(dim=-1, keepdim=True)).flatten(0, 1)
    w_k, w_p = (w.to(torch.bfloat16).float() for w in (w_k, w_p))
    steps = w_k - w_p
    flipped = steps != 0
    assert flipped.float().mean() < 1e-3
    assert torch.equal(w_k[flipped].to(torch.bfloat16).view(torch.int16)
                       .int().sub(w_p[flipped].to(torch.bfloat16)
                                  .view(torch.int16).int()).abs(),
                       torch.ones_like(w_k[flipped], dtype=torch.int32))
    plain[2] = plain[2] + torch.einsum("gqk,gqd->gkd", steps, dog)

    def errs(**form):
        got = bf16_bwd_k2_order(*groups, shifts, **form)[:3]
        return [((g - p).abs().max() / p.abs().max()).item()
                for g, p in zip(got, plain)]

    assert max(errs()) <= SUMS_TOL, errs()
    assert errs(round_w=False)[2] > SUMS_TOL
    assert errs(dq_lo=False)[0] > SUMS_TOL


@pytest.mark.parametrize("heads,d,vec,span", [
    (10, 27, 2, 28), (10, 15, 2, 16), (6, 45, 2, 46), (2, 27, 2, 28),
    (3, 15, 1, 15), (1, 27, 1, 27), (4, 32, 8, 32), (1, 128, 8, 128),
    (4, 126, 4, 128), (3, 96, 8, 96)])
def test_k2_bf16_copies(heads, d, vec, span):
    """K2's bf16 copy width and widest shifted span: THAT's heads (10 of
    27 and 15) move in 4-byte pieces, every odd head one position on, in
    the same span of k-steps as without the shift (32 and 16), so the same
    instantiation; an odd row stride copies element by element; a width
    that would push a head past 128 positions gives way to a narrower
    one."""
    assert k2_bf16_copy(heads, d) == (vec, span)
    assert -(-span // 16) <= 8
    if d <= 32:
        assert -(-span // 16) == -(-d // 16)
    shifts = k2_shifts(2, heads, d)
    assert all(sh + d <= span for sh in shifts)
    assert shifts[:heads] == shifts[heads:]


def bf16_k2_dq_smem(ks):
    """Shared memory of one bf16 query-pass block (``csrc/
    tc_attention_bwd.cuh``, ``smem_bytes_dq_bf16``): Q and dO of 64 rows
    and two ring stages of K and V of 32 keys, all bf16 rows of
    16 ks + 8."""
    return 2 * (16 * ks + 8) * (2 * QUERY_ROWS + 4 * KEY_TILE)


@pytest.mark.parametrize("ks", [1, 2, 4, 6, 8])
def test_k2_bf16_dq_grid(ks):
    """K2's bf16 query pass at a span of ``ks`` k-steps of 16 fits in a
    block's shared memory, and at spans up to 32 (THAT's heads) three
    blocks fit an SM's 228 KB (its launch bounds' 3, 1 KB reserved a
    block); its dK/dV pass, the bf16 body at <ks, 0> (128 keys a block),
    fits too, two blocks an SM at those spans. THAT's left stream at the
    training batch of 16 gives the query pass B H ceil(Nq / 64) = 480
    blocks."""
    smem = bf16_k2_dq_smem(ks)
    assert smem <= MAX_SHARED_BYTES
    dkv = bf16_dkv_smem(ks, 0, 128)
    assert dkv <= MAX_SHARED_BYTES
    if ks <= 2:
        assert 3 * (smem + 1024) <= 228 * 1024
        assert 2 * (dkv + 1024) <= 228 * 1024
    if ks == 2:
        b, nq, h, d = 16, 150, 10, 27
        assert -(-d // 16) == ks
        assert b * h * -(-nq // QUERY_ROWS) == 480
