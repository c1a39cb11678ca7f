"""The arithmetic order of the tensor-core attention kernels (K1,
``csrc/flash_attention.cu``, and K3, ``csrc/flash_attention_lowrank.cu``,
both on ``csrc/tc_attention.cuh``: the bf16 body of both and K3's f32
body), emulated in PyTorch on the CPU and held against the JAX package's
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
1e-5 relative.

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
"""

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
    F32_QUERY_TILE, WAVE_SHARE, dkv_splits)

torch.set_num_threads(1)

KEY_TILE = 64
K1_TOL = 2.0 ** -6
K3_SHARE = 2.0 ** -7
LSE_RTOL = 1e-5
F32_TOL = 2e-5
BWD_TOL = 1e-4
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
    """The f32 launcher's key tile: 64 where the 8-warp configuration's
    shared memory fits (the K, V ring and the Q tile at a row stride of
    16 ceil(D/16) + 4 floats, the R strip and the S ring), else 32."""
    ks = -(-d // 16)
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
    """K3's f32 kernel on (G, Nq, D) q and (G, Nk, D) k, v in f32, with
    optional r (G, Nq, M) and s (M, Nk). Returns the f32 output and LSE."""
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
# the 8-warp configuration's shared memory: 32-key tiles)
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
    assert f32_key_tile(d, m if bias else 0) == (32 if name == "d96-m70"
                                                 and bias else 64)
    err = np.abs(got - want).max()
    assert err <= F32_TOL, err
    rel = (np.abs(lse.reshape(b, h, nq).numpy() - want_lse)
           / np.abs(want_lse)).max()
    assert rel <= LSE_RTOL, rel


def _tf32_product(a_eq, b_eq, a, b):
    """a . b as 3xTF32 in one sum: lo.hi + hi.lo + hi.hi (einsum
    ``a_eq,b_eq``)."""
    (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
    eq = f"{a_eq},{b_eq}"
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + torch.einsum(eq, a_hi, b_hi))


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
    tiles = -(-nq // F32_QUERY_TILE)
    parts = []
    for split in range(splits):
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(k)
        ds = None if r is None else torch.zeros((g, s.shape[1], r.shape[-1]))
        for t in range(split * tiles // splits,
                       (split + 1) * tiles // splits):
            rows = slice(t * F32_QUERY_TILE, (t + 1) * F32_QUERY_TILE)
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


# (B, H, Nq, Nk, D, M): the JAX K4 test's shapes (tests/test_kernels.py,
# bias factors scaled by 0.1 there and here) and one with MViT's zero
# class-token row in r and column in s
BWD_SHAPES = {"jax-bias": (2, 2, 300, 130, 32, 11),
              "jax-no-bias": (1, 2, 513, 129, 8, 0),
              "class-token": (2, 1, 257, 65, 16, 9)}


@pytest.mark.parametrize("name", sorted(BWD_SHAPES))
def test_k4_f32_bwd_dkv_order_matches_jax_kernel(name):
    """K4's f32 dK/dV/dS order, fed the f32 forward order's output and
    LSE, against jax.vjp of JAX's trainable K3/K4 in interpret mode: dK,
    dV and dS within 1e-4 of each gradient's largest magnitude."""
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
    want = [want[1], want[2]] + ([want[4]] if m else [])

    def groups(t, n):
        return torch.from_numpy(t).reshape(b * h, n, -1)

    tq, tk, tv, tdo = (groups(t, n) for t, n in
                       ((q, nq), (k, nk), (v, nk), (do, nq)))
    tr = None if r is None else groups(r, nq)
    ts = None if s is None else torch.from_numpy(s)
    out, lse = f32_order(tq, tk, tv, tr, ts)
    delta = (tdo * out).sum(dim=-1)
    # 128 keys a block at these widths, as the launcher's keys entry
    # reports them (chip_smoke.py prints it at every f32 shape)
    splits = dkv_splits(b * h * -(-nk // 128), nq, torch.float32, H100_SMS)
    assert 1 < splits <= -(-nq // F32_QUERY_TILE)
    dk, dv, ds = f32_bwd_dkv_order(tq, tk, tv, tr, ts, tdo, lse, delta,
                                   splits)
    got = [dk.reshape(b, h, nk, d), dv.reshape(b, h, nk, d)]
    got += [ds] if m else []
    for name_, g, w in zip(("dk", "dv", "ds"), got, want):
        assert g.shape == w.shape, name_
        err = np.abs(g.numpy() - w).max()
        assert err <= BWD_TOL * np.abs(w).max(), (name_, err)


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
    tiles = -(-nq // F32_QUERY_TILE)
    for keys in (128, 64):
        key_blocks = bh * -(-nk // keys)
        splits = dkv_splits(key_blocks, nq, torch.float32, H100_SMS)
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
