"""The arithmetic order of the tensor-core attention kernels (K1,
``csrc/flash_attention.cu``, and K3, ``csrc/flash_attention_lowrank.cu``,
both on ``csrc/tc_attention.cuh``: the bf16 body and the f32 body of
both), emulated in PyTorch on the CPU and held against the JAX package's
Pallas kernels in interpret mode.

The CUDA kernels run only on the card; this test holds their order of
operations before the card sees it. The kernels:
- pad the head dim D with zeros to a multiple of 16 (the mma depth);
- stream keys in tiles of 64, keys past Nk masked to -inf;
- per tile, the logits q.k in f32 times 1/sqrt(D), then the bias r.s as
  3xTF32 products on the tensor cores (each f32 factor split into tf32
  hi + lo, the sum of lo.hi, hi.lo and hi.hi accumulated in f32, which
  keeps f32's precision);
- keep a running row max m and sum l (online softmax), rescaling l and
  the output accumulator by exp(m_old - m_new) when the max moves;
- round the UNNORMALISED weights exp(logit - m) to bf16 and accumulate
  P.V in f32, dividing by l once at the end; the LSE is m + log(l).

The TPU kernels round the normalised weights instead. Tolerances are
``chip_smoke.py``'s own: K1 ``BF16_TOL`` 2^-6 absolute, K3 2^-7 of the
largest |out|, the LSE 1e-5 relative. This module is a helper of the tests
only; the package's plain versions keep the TPU order.

K3's f32 body (``f32_order``) makes the same pass at f32 precision:
- key tiles of 64 (8 warps over 128 rows, where those tiles fit in shared
  memory: D <= 96 and, at D = 96, M <= 64) or 32;
- q.k as 3xTF32 at each k-step of 8: lo.hi + hi.lo summed apart, each
  k-step's hi.hi added in f32 in order, then (big + small) times
  1/sqrt(D);
- the bias as the plain version's f32 GEMM forms it, one FMA chain over
  the factor columns in order, added in f32;
- f32 weights, never rounded; each tile's P.V as 3xTF32 (the weights and
  V split alike), added to the rescaled output; the division at the end.
Held against JAX's K3 in f32 within ``F32_TOL`` 2e-5 and the LSE within
1e-5 relative. K1's f32 instantiation runs the same body without the bias,
in the key tile its launcher's rule picks (``f32_key_tile``: 32 at
THAT's heads), on the (B, N, H, D) layout; held against JAX's K1 in f32
within the same 2e-5.

K4's f32 dK/dV/dS body (``csrc/tc_attention_bwd.cuh``, ``f32_bwd_dkv_order``)
takes the query range in tiles of 32 rows, split over blocks as the
wrapper's ``dkv_splits`` says, with the keys as the rows of the products:
- S^T = K Q^T as 3xTF32 (lo.hi + hi.lo summed apart, each k-step's hi.hi
  added in f32), times 1/sqrt(D), plus the bias S^T R^T as 3xTF32 in one
  sum; w = exp(logits - lse) in f32 (the LSE from the forward's logits,
  whose bias is an FMA chain);
- dP^T = V dO^T as 3xTF32 in one sum; dl = w (dP - delta);
- per tile, dV = w^T dO, dK = dl^T Q and dS = dl^T R as 3xTF32, each
  added to its split's sums in f32; dK times 1/sqrt(D) once per split;
- the wrapper's sum of the splits' partials in order (dS also over B H).
Held against ``jax.vjp`` of JAX's K4 in interpret mode within 1e-4 of each
gradient's largest magnitude (the JAX test's own bound,
``tests/test_torch_port_lowrank_backward.py``).

K4's f32 dQ/dR kernel, the query pass with the bias of the same header
(``f32_bwd_dq_order``), takes one sweep over key tiles of 32 with the
queries as the rows of the products:
- S = Q K^T as K2's query pass forms it (3xTF32, lo.hi + hi.lo summed
  apart, each k-step's hi.hi added in f32), times 1/sqrt(D), plus the
  bias R S as 3xTF32 in one sum; w = exp(S - lse) with the forward's LSE;
- dP = dO V^T as 3xTF32 in one sum; dl = w (dP - delta) with the
  wrapper's delta;
- per tile, dQ = dl K and dR = dl S^T as 3xTF32, each added to the row's
  sums in f32; dQ times 1/sqrt(D) at the end.
Held against the same ``jax.vjp`` within the same 1e-4.

K4's bf16 dK/dV/dS body (the same header, ``bf16_bwd_dkv_order``) takes
the f32 body's query tiles and splits with bf16 q, k, v and dO:
- S^T = K Q^T and dP^T = V dO^T as f32 sums of exact bf16 products over
  k-steps of 16; the bias S^T R^T and dS as 3xTF32, as the f32 body;
- w and dl in f32; dV = w^T dO and dK = dl^T Q per tile from w and dl
  split into bf16 hi + lo (lo.B + hi.B), each tile added in f32;
- the wrapper's sum of the splits' partials, then dK and dV rounded to
  bf16.
Held against ``jax.vjp`` of JAX's K4 in interpret mode in bf16 within
2^-7 of each gradient's largest magnitude (chip_smoke.py's bf16 bound),
and its f32 sums before the rounding against the plain version's within
1e-4 (16 bits of w and dl, where bf16 alone keeps 8). The grid test holds
every bf16 instantiation's shared memory (``bf16_dkv_smem``) and MViT's
splits.
"""

import functools

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_modal_csi_tpu.kernels.flash_attention import (
    flash_attention as jax_flash_attention,
    flash_attention_lowrank_bias as jax_lowrank,
    flash_attention_lowrank_bias_trainable as jax_trainable)
from multi_modal_csi_tpu_torch.kernels.flash_attention_lowrank import (
    QUERY_TILE, WAVE_SHARE, dkv_splits, lowrank_backward_dkv_reference,
    lowrank_backward_dq_reference)

torch.set_num_threads(1)

KEY_TILE = 64
K1_TOL = 2.0 ** -6
K3_SHARE = 2.0 ** -7
LSE_RTOL = 1e-5
F32_TOL = 2e-5
BWD_TOL = 1e-4
DQ_KEY_TILE = 32    # kDqrKeys of the query pass with the bias
MAX_SHARED_BYTES = 232448
H100_SMS = 132


def tf32(x):
    """x rounded to tf32's 10 mantissa bits, to nearest with ties away
    from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def tc_order(q, k, v, r=None, s=None):
    """The kernels' order on (G, Nq, D) q and (G, Nk, D) k, v holding bf16
    values, with optional f32 r (G, Nq, M) and s (M, Nk). Returns the f32
    output before its bf16 store, and the f32 LSE (G, Nq)."""
    d = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    pad = -d % 16
    q, k, v = (torch.nn.functional.pad(t.float(), (0, pad)) for t in (q, k, v))
    g, nq, _ = q.shape
    nk = k.shape[1]
    m = torch.full((g, nq, 1), -math.inf)
    l = torch.zeros((g, nq, 1))
    acc = torch.zeros_like(q)
    if r is not None:
        r_hi, r_lo = split_tf32(r)
        s_hi, s_lo = split_tf32(s)
    for k0 in range(0, nk, KEY_TILE):
        kt, vt = k[:, k0:k0 + KEY_TILE], v[:, k0:k0 + KEY_TILE]
        lg = torch.einsum("gqd,gkd->gqk", q, kt) * scale
        if r is not None:
            keys = slice(k0, k0 + KEY_TILE)
            lg = lg + r_lo @ s_hi[:, keys]
            lg = lg + r_hi @ s_lo[:, keys]
            lg = lg + r_hi @ s_hi[:, keys]
        m_new = torch.maximum(m, lg.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(lg - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "gqk,gkd->gqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    return (acc / l)[..., :d], (m + torch.log(l)).squeeze(-1)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16(a):
    """numpy f32 -> (torch bf16, jax bf16) of the same values."""
    return torch.from_numpy(a).to(torch.bfloat16), jnp.asarray(a).astype(
        jnp.bfloat16)


@pytest.mark.parametrize("d", [8, 15, 24, 27])
def test_k1_order_matches_jax_kernel(d):
    """K1's (B, N, H, D) layout: 2 x 70 queries, 150 keys (two full tiles
    and a ragged one), 3 heads."""
    rng = np.random.default_rng(d)
    b, nq, nk, h = 2, 70, 150, 3
    (q, jq), (k, jk), (v, jv) = (_bf16(_normal(rng, (b, n, h, d)))
                                 for n in (nq, nk, nk))
    want = np.asarray(jax_flash_attention(jq, jk, jv, interpret=True)
                      .astype(jnp.float32))

    def heads(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, -1, d)

    out, _ = tc_order(heads(q), heads(k), heads(v))
    got = out.to(torch.bfloat16).float().reshape(b, h, nq, d).permute(
        0, 2, 1, 3)
    err = np.abs(got.numpy() - want).max()
    assert err <= K1_TOL, err


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
@pytest.mark.parametrize("d", [8, 15, 24, 27])
def test_k3_order_matches_jax_kernel(d, bias):
    """K3's (B, H, N, D) layout: 100 queries, 150 keys, 2 heads; the bias
    of rank 5 with the class token's row and column at 0, as MViT's."""
    rng = np.random.default_rng(100 + d)
    b, h, nq, nk, m = 1, 2, 100, 150, 5
    (q, jq), (k, jk), (v, jv) = (_bf16(_normal(rng, (b, h, n, d)))
                                 for n in (nq, nk, nk))
    r = s = jr = js = None
    if bias:
        r_np, s_np = _normal(rng, (b, h, nq, m)), _normal(rng, (m, nk))
        r_np[:, :, 0] = 0.0
        s_np[:, 0] = 0.0
        r, s = torch.from_numpy(r_np), torch.from_numpy(s_np)
        jr, js = jnp.asarray(r_np), jnp.asarray(s_np)
    want, want_lse = jax_lowrank(jq, jk, jv, jr, js, interpret=True,
                                 return_lse=True)
    want = np.asarray(want.astype(jnp.float32))
    want_lse = np.asarray(want_lse)[:, :, :nq, 0]

    out, lse = tc_order(q.reshape(b * h, nq, d), k.reshape(b * h, nk, d),
                        v.reshape(b * h, nk, d),
                        None if r is None else r.reshape(b * h, nq, m), s)
    got = out.to(torch.bfloat16).float().reshape(b, h, nq, d).numpy()
    err = np.abs(got - want).max()
    assert err <= K3_SHARE * np.abs(want).max(), err
    rel = (np.abs(lse.reshape(b, h, nq).numpy() - want_lse)
           / np.abs(want_lse)).max()
    assert rel <= LSE_RTOL, rel


def f32_key_tile(d, m):
    """The f32 launcher's key tile (``csrc/tc_attention.cuh``,
    ``launch_f32_span``): 32 at spans of one or two k-steps of 16 without
    the bias (4 warps over 64 rows with registers for 4 blocks an SM:
    K1's THAT heads); else 64 where the 8-warp configuration's shared
    memory fits (the K, V ring and the Q tile at a row stride of
    16 ceil(D/16) + 4 floats, the R strip and the S ring), else 32."""
    ks = -(-d // 16)
    if ks <= 2 and not m:
        return 32
    m8 = -(-m // 8) * 8
    rows = 2 * 2 * 64 + 128
    need = 4 * (rows * (16 * ks + 4)
                + (128 * (m8 + 4) + 2 * m8 * 72 if m else 0))
    return 64 if ks <= 6 and need <= MAX_SHARED_BYTES else 32


def _fma_chain(r, s):
    """r @ s (r (G, Nq, M), s (M, Nk)) as one FMA chain over M in order,
    each step rounded once to f32, as the plain version's f32 GEMM forms
    it."""
    acc = torch.zeros((r.shape[0], r.shape[1], s.shape[1]))
    for i in range(r.shape[2]):
        acc = (r[:, :, i:i + 1].double() * s[i].double()
               + acc.double()).float()
    return acc


def f32_order(q, k, v, r=None, s=None):
    """The f32 body (K3's and K1's f32 kernels) on (G, Nq, D) q and
    (G, Nk, D) k, v in f32, with optional r (G, Nq, M) and s (M, Nk), in
    the launcher's key tiles (``f32_key_tile``). Returns the f32 output
    and LSE."""
    d = q.shape[-1]
    tile = f32_key_tile(d, 0 if r is None else r.shape[-1])
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    pad = -d % 8
    q, k, v = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    g, nq, span = q.shape
    nk = k.shape[1]
    q_hi, q_lo = split_tf32(q)
    m = torch.full((g, nq, 1), -math.inf)
    l = torch.zeros((g, nq, 1))
    acc = torch.zeros_like(q)
    bias = None if r is None else _fma_chain(r, s)
    for k0 in range(0, nk, tile):
        keys = slice(k0, k0 + tile)
        k_hi, k_lo = split_tf32(k[:, keys])
        big = torch.zeros((g, nq, k_hi.shape[1]))
        for c in range(0, span, 8):
            cols = slice(c, c + 8)
            big = big + torch.einsum("gqd,gkd->gqk", q_hi[..., cols],
                                     k_hi[..., cols])
        small = (torch.einsum("gqd,gkd->gqk", q_lo, k_hi)
                 + torch.einsum("gqd,gkd->gqk", q_hi, k_lo))
        lg = (big + small) * scale
        if bias is not None:
            lg = lg + bias[:, :, keys]
        m_new = torch.maximum(m, lg.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(lg - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        (p_hi, p_lo), (v_hi, v_lo) = split_tf32(p), split_tf32(v[:, keys])
        pv = (torch.einsum("gqk,gkd->gqd", p_lo, v_hi)
              + torch.einsum("gqk,gkd->gqd", p_hi, v_lo)
              + torch.einsum("gqk,gkd->gqd", p_hi, v_hi))
        acc = acc * alpha + pv
        m = m_new
    return (acc / l)[..., :d], (m + torch.log(l)).squeeze(-1)


# chip_smoke.py's LOWRANK_ODD (the JAX package's K3 test shapes) as
# (B, H, Nq, Nk, D, M), and two MViT-width heads of 200 rows, not a
# multiple of either query tile: M = 37 (64-key tiles) and M = 70 (past
# the 8-warp configuration's shared memory: 32-key tiles); without the
# bias, heads of D <= 32 take 32-key tiles too
F32_SHAPES = {"odd-300": (2, 1, 300, 37, 16, 5),
              "odd-513": (1, 2, 513, 129, 8, 11),
              "odd-257": (2, 4, 257, 128, 24, 9),
              "odd-128": (1, 8, 128, 128, 96, 0),
              "d96-m37": (1, 1, 200, 300, 96, 37),
              "d96-m70": (1, 1, 200, 300, 96, 70)}


@pytest.mark.parametrize("name,bias", [
    (name, bias) for name, shape in F32_SHAPES.items()
    for bias in ((False, True) if shape[-1] else (False,))],
    ids=lambda x: x if isinstance(x, str) else ("bias" if x else "no-bias"))
def test_k3_f32_order_matches_jax_kernel(name, bias):
    """K3's f32 order against JAX's K3 in f32: out within 2e-5, the LSE
    within 1e-5 relative; the bias's class-token row and column at 0, as
    MViT's and chip_smoke.py's."""
    b, h, nq, nk, d, m = F32_SHAPES[name]
    rng = np.random.default_rng(200 + d + m)
    q, k, v = (_normal(rng, (b, h, n, d)) for n in (nq, nk, nk))
    r = s = None
    if bias:
        r, s = _normal(rng, (b, h, nq, m)), _normal(rng, (m, nk))
        r[:, :, 0] = 0.0
        s[:, 0] = 0.0
    want, want_lse = jax_lowrank(
        *(jnp.asarray(t) for t in (q, k, v)),
        None if r is None else jnp.asarray(r),
        None if s is None else jnp.asarray(s), interpret=True,
        return_lse=True)
    want = np.asarray(want)
    want_lse = np.asarray(want_lse)[:, :, :nq, 0]

    def groups(t, n):
        return torch.from_numpy(t).reshape(b * h, n, -1)

    out, lse = f32_order(groups(q, nq), groups(k, nk), groups(v, nk),
                         None if r is None else groups(r, nq),
                         None if s is None else torch.from_numpy(s))
    got = out.reshape(b, h, nq, d).numpy()
    assert f32_key_tile(d, m if bias else 0) == (
        32 if (name == "d96-m70" and bias) or (d <= 32 and not bias)
        else 64)
    err = np.abs(got - want).max()
    assert err <= F32_TOL, err
    rel = (np.abs(lse.reshape(b, h, nq).numpy() - want_lse)
           / np.abs(want_lse)).max()
    assert rel <= LSE_RTOL, rel


@pytest.mark.parametrize("d", [8, 15, 24, 27, 45])
def test_k1_f32_order_matches_jax_kernel(d):
    """K1's f32 order (the f32 body in the key tile its launcher picks)
    against JAX's K1 in f32 in interpret mode, within F32_TOL 2e-5: the
    (B, N, H, D) layout with 3 heads, so the heads sit at offsets h D of
    each token row, and 150 queries and 97 keys, neither a multiple of a
    tile."""
    rng = np.random.default_rng(400 + d)
    b, nq, nk, h = 2, 150, 97, 3
    q, k, v = (_normal(rng, (b, n, h, d)) for n in (nq, nk, nk))
    want = np.asarray(jax_flash_attention(
        *(jnp.asarray(t) for t in (q, k, v)), interpret=True))

    def heads(t):
        return torch.from_numpy(t).permute(0, 2, 1, 3).reshape(b * h, -1, d)

    out, _ = f32_order(heads(q), heads(k), heads(v))
    got = out.reshape(b, h, nq, d).permute(0, 2, 1, 3).numpy()
    assert want.dtype == np.float32
    err = np.abs(got - want).max()
    assert err <= F32_TOL, err


def _tf32_product(a_eq, b_eq, a, b):
    """a . b as 3xTF32 in one sum: lo.hi + hi.lo + hi.hi (einsum
    ``a_eq,b_eq``)."""
    (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
    eq = f"{a_eq},{b_eq}"
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


def _logits(q_hi, q_lo, k_hi, k_lo, scale):
    """(Q K^T) scale over the padded span as 3xTF32, the small terms
    summed apart and each k-step's hi.hi added in f32 (K2's and K4's
    query passes)."""
    big = torch.zeros((q_hi.shape[0], q_hi.shape[1], k_hi.shape[1]))
    for c in range(0, q_hi.shape[-1], 8):
        cols = slice(c, c + 8)
        big = big + torch.einsum("gqd,gkd->gqk", q_hi[..., cols],
                                 k_hi[..., cols])
    small = (torch.einsum("gqd,gkd->gqk", q_hi, k_lo)
             + torch.einsum("gqd,gkd->gqk", q_lo, k_hi))
    return (big + small) * scale


def f32_bwd_dq_order(q, k, v, r, s, do, lse, delta):
    """K4's f32 dQ/dR kernel on (G, Nq, D) q, do and (G, Nk, D) k, v in
    f32, optional r (G, Nq, M) and s (M, Nk), the forward's LSE and delta
    (G, Nq). Returns the f32 dQ (G, Nq, D) and dR (G, Nq, M) or None."""
    d = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    pad = -d % 8
    q, k, v, do = (torch.nn.functional.pad(t, (0, pad))
                   for t in (q, k, v, do))
    (q_hi, q_lo), (k_hi, k_lo) = split_tf32(q), split_tf32(k)
    dq = torch.zeros_like(q)
    dr = None if r is None else torch.zeros_like(r)
    for k0 in range(0, k.shape[1], DQ_KEY_TILE):
        keys = slice(k0, k0 + DQ_KEY_TILE)
        logits = _logits(q_hi, q_lo, k_hi[:, keys], k_lo[:, keys], scale)
        if r is not None:
            logits = logits + _tf32_product("gqm", "mk->gqk", r, s[:, keys])
        w = torch.exp(logits - lse[..., None])
        dp = _tf32_product("gqd", "gkd->gqk", do, v[:, keys])
        dl = w * (dp - delta[..., None])
        dq = dq + _tf32_product("gqk", "gkd->gqd", dl, k[:, keys])
        if dr is not None:
            dr = dr + _tf32_product("gqk", "mk->gqm", dl, s[:, keys])
    return (dq * scale)[..., :d], dr


def f32_bwd_dkv_order(q, k, v, r, s, do, lse, delta, splits):
    """K4's f32 dK/dV/dS kernel on (G, Nq, D) q, do and (G, Nk, D) k, v
    in f32, optional r (G, Nq, M) and s (M, Nk), the forward's LSE and
    delta (G, Nq), the query tiles split ``splits`` ways. Returns the f32
    dK, dV (G, Nk, D) and dS (M, Nk) or None."""
    d = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    pad = -d % 8
    q, k, v, do = (torch.nn.functional.pad(t, (0, pad))
                   for t in (q, k, v, do))
    g, nq, span = q.shape
    k_hi, k_lo = split_tf32(k)
    bias = None if r is None else _tf32_product("km", "gqm->gkq", s.T, r)
    tiles = -(-nq // QUERY_TILE)
    parts = []
    for split in range(splits):
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(k)
        ds = None if r is None else torch.zeros((g, s.shape[1], r.shape[-1]))
        for t in range(split * tiles // splits,
                       (split + 1) * tiles // splits):
            rows = slice(t * QUERY_TILE, (t + 1) * QUERY_TILE)
            qt, dot = q[:, rows], do[:, rows]
            q_hi, q_lo = split_tf32(qt)
            big = torch.zeros((g, k.shape[1], qt.shape[1]))
            for c in range(0, span, 8):
                cols = slice(c, c + 8)
                big = big + torch.einsum("gkd,gqd->gkq", k_hi[..., cols],
                                         q_hi[..., cols])
            small = (torch.einsum("gkd,gqd->gkq", k_lo, q_hi)
                     + torch.einsum("gkd,gqd->gkq", k_hi, q_lo))
            logits = (big + small) * scale
            if bias is not None:
                logits = logits + bias[:, :, rows]
            w = torch.exp(logits - lse[:, None, rows])
            dp = _tf32_product("gkd", "gqd->gkq", v, dot)
            dl = w * (dp - delta[:, None, rows])
            dv = dv + _tf32_product("gkq", "gqd->gkd", w, dot)
            dk = dk + _tf32_product("gkq", "gqd->gkd", dl, qt)
            if ds is not None:
                ds = ds + _tf32_product("gkq", "gqm->gkm", dl, r[:, rows])
        parts.append((dk * scale, dv, ds))
    dk = torch.stack([p[0] for p in parts]).sum(dim=0)[..., :d]
    dv = torch.stack([p[1] for p in parts]).sum(dim=0)[..., :d]
    ds = None if r is None else torch.stack(
        [p[2] for p in parts]).sum(dim=(0, 1)).T
    return dk, dv, ds


def _bf16_split(x):
    """f32 x as bf16 hi (x rounded to nearest) and lo (the remainder
    rounded), both as f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _k16_sum(eq, a, b):
    """einsum ``eq`` over the last dimension of a and b (bf16 values, the
    span a multiple of 16) as the tensor cores take it: each k-step's 16
    exact products summed in f32, the k-steps added in order."""
    acc = None
    for c in range(0, a.shape[-1], 16):
        part = torch.einsum(eq, a[..., c:c + 16], b[..., c:c + 16])
        acc = part if acc is None else acc + part
    return acc


def place(t, shifts=None):
    """(G, N, D) t in shared memory's positions: group g's element c at
    position shifts[g] + c (all 0 if None), zeros elsewhere, over a span of
    whole k-steps of 16."""
    g, n, d = t.shape
    shifts = [0] * g if shifts is None else shifts
    out = t.new_zeros((g, n, -(-(max(shifts) + d) // 16) * 16))
    for i, sh in enumerate(shifts):
        out[i, :, sh:sh + d] = t[i]
    return out


def take(t, d, shifts=None):
    """The columns ``place`` put each group's D elements in."""
    shifts = [0] * t.shape[0] if shifts is None else shifts
    return torch.stack([t[i, :, sh:sh + d] for i, sh in enumerate(shifts)])


def bf16_bwd_dkv_order(q, k, v, r, s, do, lse, delta, splits,
                       round_w=False, shifts=None):
    """K4's bf16 dK/dV/dS kernel on (G, Nq, D) q, do and (G, Nk, D) k, v
    holding bf16 values, optional f32 r (G, Nq, M) and s (M, Nk), the
    forward's LSE and delta (G, Nq), the query tiles split ``splits`` ways.
    K2's form: ``round_w``, dV from w's bf16 hi alone (w rounded once), and
    ``shifts``, each group's position of element 0 (``place``). Returns
    the f32 dK, dV (G, Nk, D) before their bf16 rounding and dS (M, Nk)
    or None."""
    d = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    q, k, v, do = (place(t.float(), shifts) for t in (q, k, v, do))
    g, nq, _ = q.shape
    bias = None if r is None else _tf32_product("km", "gqm->gkq", s.T, r)
    tiles = -(-nq // QUERY_TILE)
    parts = []
    for split in range(splits):
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(k)
        ds = None if r is None else torch.zeros((g, s.shape[1], r.shape[-1]))
        for t in range(split * tiles // splits,
                       (split + 1) * tiles // splits):
            rows = slice(t * QUERY_TILE, (t + 1) * QUERY_TILE)
            qt, dot = q[:, rows], do[:, rows]
            logits = _k16_sum("gkd,gqd->gkq", k, qt) * scale
            if bias is not None:
                logits = logits + bias[:, :, rows]
            w = torch.exp(logits - lse[:, None, rows])
            dp = _k16_sum("gkd,gqd->gkq", v, dot)
            dl = w * (dp - delta[:, None, rows])
            (w_hi, w_lo), (dl_hi, dl_lo) = _bf16_split(w), _bf16_split(dl)
            dv = dv + (torch.einsum("gkq,gqd->gkd", w_hi, dot) if round_w
                       else torch.einsum("gkq,gqd->gkd", w_lo, dot)
                       + torch.einsum("gkq,gqd->gkd", w_hi, dot))
            dk = dk + (torch.einsum("gkq,gqd->gkd", dl_lo, qt)
                       + torch.einsum("gkq,gqd->gkd", dl_hi, qt))
            if ds is not None:
                ds = ds + _tf32_product("gkq", "gqm->gkm", dl, r[:, rows])
        parts.append((dk * scale, dv, ds))
    dk = take(torch.stack([p[0] for p in parts]).sum(dim=0), d, shifts)
    dv = take(torch.stack([p[1] for p in parts]).sum(dim=0), d, shifts)
    ds = None if r is None else torch.stack(
        [p[2] for p in parts]).sum(dim=(0, 1)).T
    return dk, dv, ds


def bf16_bwd_dq_order(q, k, v, r, s, do, lse, delta):
    """K4's bf16 dQ/dR kernel, the bf16 query pass with the bias, on
    (G, Nq, D) q, do and (G, Nk, D) k, v holding bf16 values, optional f32
    r (G, Nq, M) and s (M, Nk), the forward's LSE and delta (G, Nq), over
    key tiles of 32. Returns the f32 dQ (G, Nq, D) before its bf16
    rounding and dR (G, Nq, M) or None."""
    d = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    pad = -d % 16
    q, k, v, do = (torch.nn.functional.pad(t.float(), (0, pad))
                   for t in (q, k, v, do))
    dq = torch.zeros_like(q)
    dr = None if r is None else torch.zeros_like(r)
    for k0 in range(0, k.shape[1], DQ_KEY_TILE):
        keys = slice(k0, k0 + DQ_KEY_TILE)
        kt = k[:, keys]
        logits = _k16_sum("gqd,gkd->gqk", q, kt) * scale
        if r is not None:
            logits = logits + _tf32_product("gqm", "mk->gqk", r, s[:, keys])
        w = torch.exp(logits - lse[..., None])
        dp = _k16_sum("gqd,gkd->gqk", do, v[:, keys])
        dl = w * (dp - delta[..., None])
        dl_hi, dl_lo = _bf16_split(dl)
        dq = dq + (torch.einsum("gqk,gkd->gqd", dl_lo, kt)
                   + torch.einsum("gqk,gkd->gqd", dl_hi, kt))
        if dr is not None:
            dr = dr + _tf32_product("gqk", "mk->gqm", dl, s[:, keys])
    return (dq * scale)[..., :d], dr


# (B, H, Nq, Nk, D, M): the JAX K4 test's shapes (tests/test_kernels.py,
# bias factors scaled by 0.1 there and here) and one with MViT's zero
# class-token row in r and column in s
BWD_SHAPES = {"jax-bias": (2, 2, 300, 130, 32, 11),
              "jax-no-bias": (1, 2, 513, 129, 8, 0),
              "class-token": (2, 1, 257, 65, 16, 9)}


@functools.lru_cache(maxsize=None)
def _k4_case(name):
    """BWD_SHAPES[name]'s seeded inputs as (B H, N, .) torch groups, the
    f32 forward order's output and LSE, delta, and the gradients of
    jax.vjp of JAX's trainable K3/K4 in interpret mode (dQ, dK, dV and,
    with a bias, dR and dS)."""
    b, h, nq, nk, d, m = BWD_SHAPES[name]
    rng = np.random.default_rng(300 + d + m)
    q, do = (_normal(rng, (b, h, nq, d)) for _ in range(2))
    k, v = (_normal(rng, (b, h, nk, d)) for _ in range(2))
    r = s = None
    if m:
        r, s = 0.1 * _normal(rng, (b, h, nq, m)), 0.1 * _normal(rng, (m, nk))
        if name == "class-token":
            r[:, :, 0] = 0.0
            s[:, 0] = 0.0
    args = [jnp.asarray(t) for t in (q, k, v)]
    if m:
        args += [jnp.asarray(r), jnp.asarray(s)]
    _, vjp = jax.vjp(lambda *a: jax_trainable(*a, interpret=True), *args)
    want = [np.asarray(x) for x in vjp(jnp.asarray(do))]

    def groups(t, n):
        return torch.from_numpy(t).reshape(b * h, n, -1)

    tq, tk, tv, tdo = (groups(t, n) for t, n in
                       ((q, nq), (k, nk), (v, nk), (do, nq)))
    tr = None if r is None else groups(r, nq)
    ts = None if s is None else torch.from_numpy(s)
    out, lse = f32_order(tq, tk, tv, tr, ts)
    delta = (tdo * out).sum(dim=-1)
    return (tq, tk, tv, tr, ts, tdo, lse, delta), want


@pytest.mark.parametrize("name", sorted(BWD_SHAPES))
def test_k4_f32_bwd_dkv_order_matches_jax_kernel(name):
    """K4's f32 dK/dV/dS order, fed the f32 forward order's output and
    LSE, against jax.vjp of JAX's trainable K3/K4 in interpret mode: dK,
    dV and dS within 1e-4 of each gradient's largest magnitude."""
    b, h, nq, nk, d, m = BWD_SHAPES[name]
    args, want = _k4_case(name)
    want = [want[1], want[2]] + ([want[4]] if m else [])
    # 128 keys a block at these widths, as the launcher's keys entry
    # reports them (chip_smoke.py prints it at every f32 shape)
    splits = dkv_splits(b * h * -(-nk // 128), nq, H100_SMS)
    assert 1 < splits <= -(-nq // QUERY_TILE)
    dk, dv, ds = f32_bwd_dkv_order(*args, splits)
    got = [dk.reshape(b, h, nk, d), dv.reshape(b, h, nk, d)]
    got += [ds] if m else []
    for name_, g, w in zip(("dk", "dv", "ds"), got, want):
        assert g.shape == w.shape, name_
        err = np.abs(g.numpy() - w).max()
        assert err <= BWD_TOL * np.abs(w).max(), (name_, err)


@pytest.mark.parametrize("name", sorted(BWD_SHAPES))
def test_k4_f32_bwd_dq_order_matches_jax_kernel(name):
    """K4's f32 dQ/dR order (the query pass with the bias), fed the f32
    forward order's output and LSE, against jax.vjp of JAX's trainable
    K3/K4 in interpret mode: dQ and dR within 1e-4 of each gradient's
    largest magnitude."""
    b, h, nq, nk, d, m = BWD_SHAPES[name]
    args, want = _k4_case(name)
    dq, dr = f32_bwd_dq_order(*args)
    got = [dq.reshape(b, h, nq, d)]
    got += [dr.reshape(b, h, nq, m)] if m else []
    want = [want[0]] + ([want[3]] if m else [])
    assert (dr is None) == (m == 0)
    for name_, g, w in zip(("dq", "dr"), got, want):
        assert g.shape == w.shape, name_
        err = np.abs(g.numpy() - w).max()
        assert err <= BWD_TOL * np.abs(w).max(), (name_, err)


@functools.lru_cache(maxsize=None)
def _k4_bf16_case(name):
    """BWD_SHAPES[name]'s seeded inputs in bf16 (the factors f32) as
    (B H, N, .) torch groups, the bf16 forward order's LSE and delta (from
    its output rounded to bf16, as the port takes it), and the gradients
    of jax.vjp of JAX's trainable K3/K4 in interpret mode in bf16 (dQ, dK,
    dV and, with a bias, dR and dS), as f32 numpy."""
    b, h, nq, nk, d, m = BWD_SHAPES[name]
    rng = np.random.default_rng(500 + d + m)
    q, do = (_normal(rng, (b, h, nq, d)) for _ in range(2))
    k, v = (_normal(rng, (b, h, nk, d)) for _ in range(2))
    r = s = None
    if m:
        r, s = 0.1 * _normal(rng, (b, h, nq, m)), 0.1 * _normal(rng, (m, nk))
        if name == "class-token":
            r[:, :, 0] = 0.0
            s[:, 0] = 0.0
    (tq, jq), (tk, jk), (tv, jv), (tdo, jdo) = (_bf16(t) for t in (q, k, v,
                                                                   do))
    args = [jq, jk, jv] + ([jnp.asarray(r), jnp.asarray(s)] if m else [])
    _, vjp = jax.vjp(lambda *a: jax_trainable(*a, interpret=True), *args)
    want = [np.asarray(x.astype(jnp.float32)) for x in vjp(jdo)]

    def groups(t, n):
        return t.reshape(b * h, n, -1)

    tq, tk, tv, tdo = (groups(t, n) for t, n in
                       ((tq, nq), (tk, nk), (tv, nk), (tdo, nq)))
    tr = None if r is None else groups(torch.from_numpy(r), nq)
    ts = None if s is None else torch.from_numpy(s)
    out, lse = tc_order(tq, tk, tv, tr, ts)
    out = out.to(torch.bfloat16).float()
    delta = (tdo.float() * out).sum(dim=-1)
    return (tq, tk, tv, tr, ts, tdo, lse, delta), want


@pytest.mark.parametrize("name", sorted(BWD_SHAPES))
def test_k4_bf16_bwd_dkv_order_matches_jax_kernel(name):
    """K4's bf16 dK/dV/dS order (bf16 products for S^T and dP^T, the bias
    and dS as 3xTF32, dV and dK from w and dl split into bf16 hi + lo), fed
    the bf16 forward order's LSE, against jax.vjp of JAX's trainable K3/K4
    in interpret mode in bf16: dK and dV rounded to bf16, and dS, within
    2^-7 of each gradient's largest magnitude (chip_smoke.py's
    LOWRANK_BWD_TOL in bf16). Its f32 sums before the rounding against
    the plain version's f32 sums on the same inputs within 1e-4 of each
    maximum: the split keeps 16 bits of w and dl, not 8."""
    b, h, nq, nk, d, m = BWD_SHAPES[name]
    args, want = _k4_bf16_case(name)
    want = [want[1], want[2]] + ([want[4]] if m else [])
    # 128 keys a block at these widths, as the launcher's keys entry
    # reports them (chip_smoke.py prints it at every shape)
    splits = dkv_splits(b * h * -(-nk // 128), nq, H100_SMS)
    assert 1 < splits <= -(-nq // QUERY_TILE)
    dk, dv, ds = bf16_bwd_dkv_order(*args, splits)
    got = [dk.to(torch.bfloat16).float(), dv.to(torch.bfloat16).float()]
    got += [ds] if m else []
    for name_, g, w in zip(("dk", "dv", "ds"), got, want):
        g = g.reshape(w.shape).numpy()
        err = np.abs(g - w).max()
        assert err <= K3_SHARE * np.abs(w).max(), (name_, err)
    q, k, v, r, s, do, lse, delta = args
    plain = lowrank_backward_dkv_reference(
        q.float()[None], k.float()[None], v.float()[None],
        None if r is None else r[None], s, do.float()[None], lse[None],
        delta[None])
    for name_, g, p in zip(("dk", "dv", "ds"), (dk, dv, ds), plain):
        if p is None:
            assert g is None
            continue
        p = p.reshape(g.shape)
        err = (g - p).abs().max().item()
        assert err <= BWD_TOL * p.abs().max().item(), (name_, err)


@pytest.mark.parametrize("name", sorted(BWD_SHAPES))
def test_k4_bf16_bwd_dq_order_matches_jax_kernel(name):
    """K4's bf16 dQ/dR order (bf16 products for S and dP, the bias and dR
    as 3xTF32, dQ from dl split into bf16 hi + lo), fed the bf16 forward
    order's LSE, against jax.vjp of JAX's trainable K3/K4 in interpret
    mode in bf16: dQ rounded to bf16, and dR, within 2^-7 of each
    gradient's largest magnitude (chip_smoke.py's LOWRANK_BWD_TOL in
    bf16). Its f32 sums before the rounding against the plain version's
    f32 sums on the same inputs within 1e-4 of each maximum: the split
    keeps 16 bits of dl, not 8."""
    b, h, nq, nk, d, m = BWD_SHAPES[name]
    args, want = _k4_bf16_case(name)
    want = [want[0]] + ([want[3]] if m else [])
    dq, dr = bf16_bwd_dq_order(*args)
    assert (dr is None) == (m == 0)
    got = [dq.to(torch.bfloat16).float()] + ([dr] if m else [])
    for name_, g, w in zip(("dq", "dr"), got, want):
        g = g.reshape(w.shape).numpy()
        err = np.abs(g - w).max()
        assert err <= K3_SHARE * np.abs(w).max(), (name_, err)
    q, k, v, r, s, do, lse, delta = args
    plain = lowrank_backward_dq_reference(
        q.float()[None], k.float()[None], v.float()[None],
        None if r is None else r[None], s, do.float()[None], lse[None],
        delta[None])
    for name_, g, p in zip(("dq", "dr"), (dq, dr), plain):
        if p is None:
            assert g is None
            continue
        p = p.reshape(g.shape)
        err = (g - p).abs().max().item()
        assert err <= BWD_TOL * p.abs().max().item(), (name_, err)


# MViT's training blocks 0-2 at batch 2 (chip_smoke.py's
# LOWRANK_BWD_SHAPES) and the JAX test's shapes, as (B*H, Nq, Nk); each
# with both key blocks the f32 body takes (the launcher reports which)
GRID_SHAPES = [(2, 72129, 1128), (4, 18033, 4509), (4, 18033, 1128),
               (4, 300, 130), (2, 513, 129), (2, 130, 70), (1, 200, 100),
               (1, 31, 5), (64, 72129, 4509)]


@pytest.mark.parametrize("bh,nq,nk", GRID_SHAPES)
def test_k4_f32_dkv_grid(bh, nq, nk):
    """The f32 dK/dV/dS grid at 128 and at 64 keys a block: at most one
    split a query tile of 32 rows; the fewest splits whose blocks keep
    WAVE_SHARE of an H100's SMs busy over their waves (one block an SM),
    which MViT's blocks reach, or where none does, the best share."""
    tiles = -(-nq // QUERY_TILE)
    for keys in (128, 64):
        key_blocks = bh * -(-nk // keys)
        splits = dkv_splits(key_blocks, nq, H100_SMS)
        assert 1 <= splits <= tiles

        def share(n):
            blocks = key_blocks * n
            return blocks / (-(-blocks // H100_SMS) * H100_SMS)

        shares = [share(n) for n in range(1, tiles + 1)]
        if nq > 10000:   # MViT's blocks: enough tiles to fill the waves
            assert share(splits) >= WAVE_SHARE
        if share(splits) >= WAVE_SHARE:
            assert all(x < WAVE_SHARE for x in shares[:splits - 1])
        else:
            assert share(splits) == max(shares)


# MViT's training blocks 0-2 at batch 2 as (B*H, Nq, Nk, D, M of v2's
# bias): chip_smoke.py's LOWRANK_BWD_SHAPES
MVIT_BWD_SHAPES = [(2, 72129, 1128, 96, 37), (4, 18033, 4509, 96, 51),
                   (4, 18033, 1128, 96, 37)]
BWD_BF16_STAGES = 2     # tc::kBwdBf16Stages: query tiles in the ring


def _dkv_keys(ks, m):
    """BwdShape's keys a block: 64 where dK, dV (16 ks) and dS^T (4 m-tiles
    of the bucket ``bwd_m_tiles`` puts m in) take more than 128 registers
    a thread, else 128."""
    mt = 0 if m == 0 else 2 if m <= 16 else 5 if m <= 40 else 7 if m <= 56 \
        else 16
    return 64 if 16 * ks + 4 * mt > 128 else 128


def bf16_dkv_smem(ks, m, keys, stages=BWD_BF16_STAGES):
    """Shared memory of one bf16 dK/dV/dS block (``csrc/
    tc_attention_bwd.cuh``, ``smem_bytes_bwd_bf16``): K and V as bf16 rows
    of 16 ks + 8, S^T and a tile's R tf32 lo parts as f32 rows of
    round8(M) + 4, and per ring stage Q and dO (bf16), R, the LSE and delta
    of 32 query rows."""
    ld, rs = 16 * ks + 8, (-(-m // 8) * 8 + 4 if m else 0)
    return (2 * 2 * keys * ld + 4 * (keys + QUERY_TILE) * rs
            + stages * (2 * 2 * QUERY_TILE * ld
                        + 4 * (QUERY_TILE * rs + 2 * QUERY_TILE)))


@pytest.mark.parametrize("bh,nq,nk,d,m", MVIT_BWD_SHAPES)
def test_k4_bf16_dkv_grid(bh, nq, nk, d, m):
    """The bf16 dK/dV/dS body at MViT's training shapes: every
    instantiation (spans of 1, 2, 4, 6 or 8 k-steps of 16, each bucket's
    widest bias: 0, 16, 40, 56 or 128 factor columns, keys a block as
    ``BwdShape`` gives them: 64 where dK, dV and dS^T would take more than
    128 registers a thread) fits in a block's shared memory; the splits of
    MViT's grid lie in 1..ceil(Nq / 32) and keep WAVE_SHARE of an H100's
    SMs busy."""
    for ks in (1, 2, 4, 6, 8):
        for widest in (0, 16, 40, 56, 128):
            keys = _dkv_keys(ks, widest)
            assert bf16_dkv_smem(ks, widest, keys) <= MAX_SHARED_BYTES, (
                ks, widest)
    keys = _dkv_keys(-(-d // 16), m)
    assert keys == 128
    splits = dkv_splits(bh * -(-nk // keys), nq, H100_SMS)
    assert 1 <= splits <= -(-nq // QUERY_TILE)
    blocks = bh * -(-nk // keys) * splits
    assert blocks / (-(-blocks // H100_SMS) * H100_SMS) >= WAVE_SHARE


def bf16_dq_smem(ks, m):
    """Shared memory of one bf16 dQ/dR block (``csrc/tc_attention_bwd.cuh``,
    ``smem_bytes_dqr_bf16``, 8 warps of 16 query rows): Q and dO as bf16
    rows of 16 ks + 8, their R rows as f32 rows of round8(M) + 4, and two
    ring stages of K and V (bf16, 32 keys) and the s tile (f32, round8(M)
    rows of 40)."""
    ld, rows, m8 = 16 * ks + 8, 128, -(-m // 8) * 8
    rs = m8 + 4 if m else 0
    return (2 * 2 * rows * ld + 4 * rows * rs
            + 2 * (2 * 2 * DQ_KEY_TILE * ld + 4 * m8 * (DQ_KEY_TILE + 8)))


@pytest.mark.parametrize("ks", [1, 2, 4, 6, 8])
def test_k4_bf16_dq_grid(ks):
    """The bf16 dQ/dR pass at a span of ``ks`` k-steps of 16 takes 8 warps
    of 16 query rows at every bucket (``kDqrBf16Warps``): each
    instantiation, at the bucket's widest bias (0, 16, 40, 56 or 128
    factor columns), fits in a block's shared memory, 212,992 bytes at the
    widest (D = 128, M = 128). MViT's D = 96 with M <= 56 takes 128,512
    bytes, and its blocks 0-2 have B H ceil(Nq / 128) blocks, at least
    four for each of the H100's SMs."""
    for widest in (0, 16, 40, 56, 128):
        assert bf16_dq_smem(ks, widest) <= MAX_SHARED_BYTES, (ks, widest)
    assert bf16_dq_smem(8, 128) == 212992
    if ks == 6:
        for bh, nq, nk, d, m in MVIT_BWD_SHAPES:
            assert -(-d // 16) == ks and m <= 56
            assert bh * -(-nq // 128) >= 4 * H100_SMS
        assert bf16_dq_smem(ks, 56) == 128512
