// The tensor-core backward bodies of the attention, for Hopper (sm_90a):
// at f32 precision, every product as 3xTF32 on mma.sync m16n8k8,
//   - tc::attention_bwd_dkv_f32_kernel, the keys as the rows: K4's dK/dV/dS
//     kernel in float32 (MViT training's backward; it replaces
//     multi_modal_csi_tpu/kernels/flash_attention.py::_tiled_bwd_dkv_kernel,
//     :492, pallas_call :632, on _bwd_tile_wdl :457), launched by
//     flash_attention_lowrank_bwd.cu's dtype 0, and, without the bias, K2's
//     dK/dV pass;
//   - tc::attention_bwd_dq_f32_kernel, the queries as the rows: K2's query
//     pass (THAT training's backward in float32; with the dK/dV pass it
//     replaces flash_attention.py::flash_attention_trainable, :271, body
//     _bwd_kernel_plain :163, pallas_call :247), launched by
//     flash_attention_bwd.cu's dtype 0. See "The query pass" below;
//   - tc::attention_bwd_dq_lowrank_f32_kernel, the same query pass with
//     the bias, the forward's statistics and dR: K4's dQ/dR kernel in
//     float32, launched by flash_attention_lowrank_bwd.cu's dtype 0. See
//     "The query pass with the bias" below;
// and in bfloat16
//   - tc::attention_bwd_dkv_bf16_kernel, the same key-major decomposition
//     with bf16 K, V, Q and dO: K4's dK/dV/dS kernel in bfloat16 (MViT's
//     bf16 training, the same TPU kernel), launched by
//     flash_attention_lowrank_bwd.cu's dtype 1, and, without the bias and
//     in K2's form (its last template argument), K2's bf16 dK/dV pass. See
//     "The bf16 body" below;
//   - tc::attention_bwd_dq_lowrank_bf16_kernel, the query pass with the
//     bias with bf16 Q, dO, K and V: K4's dQ/dR kernel in bfloat16,
//     launched by flash_attention_lowrank_bwd.cu's dtype 1. See "The bf16
//     query pass with the bias" below;
//   - tc::attention_bwd_dq_bf16_kernel, K2's query pass with bf16 Q, dO,
//     K and V: with the bf16 dK/dV pass, K2 in bfloat16 (THAT's bf16
//     training), launched by flash_attention_bwd.cu's dtype 1. See "The
//     bf16 query pass" below.
//
// What the dK/dV kernel computes, per (b h) and key: logits = (q.k) scale
// [+ r.s]; w = exp(logits - lse), in f32 and never rounded; dw = dO.v;
// dl = w (dw - delta); dV = sum_rows w dO; dK = scale sum_rows dl q;
// dS = r^T dl, summed over the rows. Each block writes f32 partials over
// its split of the query range: dK and dV in the key layout at a stride of
// `part` elements a split (K4: (splits, BH, Nk, D); K2 takes one split,
// straight into its gradients) and (splits, BH, M, Nk) for dS; the
// wrapper sums them in a fixed order. No atomics: the gradients repeat
// run to run.
//
// Layout. The rows of group grp = b H + h start at bwd_base(p, grp, n) =
// b n row + h D and lie `row` elements apart: K4's (BH, N, D) is H = 1 and
// a row of D, K2's (B, N, H, D) a row of H D. The LSE and delta are
// (BH, Nq) f32.
//
// Bound on an H100 SXM. Per (query, key) pair the dK/dV kernel does four
// products over D (S^T, dP^T, dV, dK: 8 D operations) and two over M (the
// bias and dS: 4 M), the dQ/dR kernel three over D (S, dP, dQ: 6 D) and
// two over M (the bias and dR: 4 M); the bytes (q, k, v, dO, r, s, lse,
// delta once, the gradients once) are tens of MB, under 0.1 ms. So both
// are bound by operations: at f32 precision every product is three TF32
// products (3xTF32) on the tensor cores, whose dense peak is 495 TFLOP/s,
// or one f32 FMA on the CUDA cores (67 TFLOP/s).
//
// Design.
//   - One block of 8 warps per (b h, key block, split of the query
//     tiles). Each warp owns a strip of 16 keys: 128 keys a block, or 64
//     where the accumulators would not fit in registers (SPLIT = 2: two
//     warps share a strip, each taking half of dK's and dV's columns and
//     half of dS's). The block's K and V rows and S's columns (as S^T,
//     key-major) stay in shared memory for the whole block; its query
//     tiles of 32 rows (Q, dO, their R rows, the LSE and delta) stream
//     through a two-stage cp.async ring, as K and V stream in the
//     forward.
//   - Transposed tiles. S^T = K Q^T and dP^T = V dO^T are 3xTF32
//     mma.sync m16n8k8 with the strip's 16 keys as the rows of the
//     product and the tile's query rows as its n-columns. For S^T lo.hi +
//     hi.lo are summed apart and each k-step's hi.hi added in f32
//     (mma3_apart), as the forward forms q.k; dP^T takes one accumulator
//     (faster on the card, and as near the plain version). w^T and
//     dl^T then lie in the accumulator registers with the keys as rows
//     and feed the A fragments of three products with no shuffle and no
//     trip through shared memory (a thread's elements of query rows 2t
//     and 2t + 1 of an n-tile are taken as A columns t and t + 4, and the
//     B fragment reads those rows):
//     dV += w^T dO, dK += dl^T Q, dS^T += dl^T R. Each tile's product is
//     formed alone (3xTF32 into a fresh accumulator) and added to the
//     running sums in f32, so its terms truncate at the tile's magnitude,
//     not at that of a sum over thousands of rows.
//   - The bias r.s is S^T R^T, 3xTF32 in one accumulator over the factor
//     columns (S^T rows the A operand, R rows the B operand, both split
//     on load), then added to the scaled q.k. The forward's f32 body
//     forms it as an FMA chain, so w's logits differ from the LSE's by
//     f32 rounding; on an H100 this form beat that chain by 1.4 ms per
//     MViT-v2 step, within the check's tolerance (PERF.md).
//   - Each tile's Q and dO, the B operands of four products read by all 8
//     warps, are split into tf32 hi (in place) and lo (a copy beside the
//     ring) once, by the whole block, rather than by every warp at every
//     load; that fits in shared memory up to D = 96 (225.8 KB at M = 51),
//     and at D = 128 each warp splits what it loads. K and V (A operands)
//     are split at each k-step: split once, they would need twice their
//     shared memory. R (dS's B operand) is split on load.
//   - Rows of 16 KS + 4 floats (K, V, Q, dO) and of round8(M) + 4 (R,
//     S^T) keep the 32-bit fragment loads on 32 banks.
//   - Registers: dK and dV take 8 KS floats a thread each and dS^T 4 MT;
//     S^T and dP^T over 32 rows 16 each, S^T's small sums 16 more. The
//     bias columns come in buckets of m-tiles (MT) and the head dim in
//     spans of 1, 2, 4, 6 or 8 k-steps of 16 (KS), zero-padded, so 25
//     instantiations cover D <= 128 and M <= 128 (K4); K2 takes the five
//     without the bias, <KS, 0>.
// Keys and query rows past the ends are zero-filled by cp.async, and
// their weights set to 0; keys past Nk are not stored.
//
// The query pass (K2 in float32; JAX's K2 saves no statistics, so this
// pass forms them). Per query row: the logits S = (q.k) scale, the LSE,
// delta = sum_k w dP with dP = dO.v, and dQ = scale sum_k dl k with
// dl = w (dP - delta), w = exp(S - lse) in f32. The dK/dV pass then reads
// the LSE and delta (written (BH, Nq) f32).
//   - One block of 4 warps per (b h, 64 query rows), 16 rows a warp; key
//     tiles of 32 stream through a two-stage cp.async ring twice. Sweep 1
//     forms S and dP per tile and keeps the online row max m, sum
//     l = sum exp(S - m) and beside it c = sum exp(S - m) dP, both
//     rescaled when m moves: LSE = m + log l and delta = c / l at its end.
//     Sweep 2 forms S and dP again, w = exp(S - lse), dl = w (dP - delta)
//     and dQ += dl K, each tile's product formed alone and added in f32.
//   - S = Q K^T is formed as the dK/dV pass forms S^T = K Q^T: hi.lo and
//     lo.hi summed apart, each k-step's hi.hi added in f32, every mma
//     adding the same products as its counterpart there (mma3_apart_t,
//     mma3_t), so the LSE and the dK/dV pass's w come from the same
//     logits and a row of w sums to 1.
//   - dl lies in the accumulator registers with the queries as rows and
//     is dQ's A fragment as it lies (a thread's keys 2t and 2t + 1 are A
//     columns t and t + 4; K's B fragment reads those keys' rows).
//   - Each key tile is split into tf32 hi (in place) and lo (beside the
//     ring) once, by the block: K and V are B operands read by all 4 warps
//     in three products. Q and dO, each warp's own A operands, are split
//     once a block at spans of 16 and 32 (THAT's heads); wider spans split
//     them at each k-step, whose lo planes would leave room for fewer
//     blocks.
//   - Grid: B H ceil(Nq / 64) blocks (480 for THAT's left stream at batch
//     16), 3 an SM at spans up to 32.
//
// The query pass with the bias (K4's dQ/dR kernel in float32, MViT
// training's backward; it replaces flash_attention.py::
// _tiled_bwd_dq_kernel, :480, pallas_call :591, on _bwd_tile_wdl :457),
// launched by flash_attention_lowrank_bwd.cu's dtype 0:
// tc::attention_bwd_dq_lowrank_f32_kernel. Per query row: logits =
// (q.k) scale + r.s; w = exp(logits - lse) with the forward's LSE (K3's)
// and the wrapper's delta, both read once a row; dl = w (dO.v - delta);
// dQ = scale sum_k dl k and dR = sum_k dl s^T, each row written once,
// straight into place: no partials, no atomics.
//   - One sweep over key tiles of 32 (K, V and the tile's columns of s,
//     (M, Nk), stream through a two-stage cp.async ring); Q, dO and the
//     R rows stay in shared memory for the block. 8 warps of 16 query rows
//     (128 a block, as K3's f32 forward) where the tiles fit in shared
//     memory at the bucket's widest bias, else 4 (DqrShape); at MViT's
//     D = 96 and M <= 56 that is 8 warps and 227.8 KB, one block an SM.
//   - S and dP as in K2's pass (mma3_apart_t, mma3_t). The bias r.s is
//     3xTF32 in one accumulator over the factor columns, R's rows the A
//     operand and the tile's s columns the B operand, each mma adding the
//     products of its counterpart in the dK/dV/dS body's S^T R^T (mma3_t),
//     so both K4 kernels form the same logits; then S += r.s.
//   - dl lies in the accumulators with the queries as rows and is the A
//     fragment of both tile products as it lies: dQ += dl K (K's rows at
//     keys 2t and 2t + 1) and dR += dl s^T (the s tile read across its
//     rows at the same keys: one 8-byte load a fragment). Each is formed
//     alone for the tile, one n-tile at a time (4 fresh registers), and
//     added in f32, the order of K2's pass.
//   - K and V, B operands read by every warp in three products, are split
//     into tf32 hi (in place) and lo (beside the ring) once a tile by the
//     block up to spans of 96; at 128 each warp splits what it loads. Q,
//     dO, R and s are split as loaded (their lo planes would not fit).
//   - Registers at D = 96, M = 51: dQ 48 floats a thread, dR 28, S, its
//     small sums and dP 48, dl's split fragments 32.
//   - Grid: B H ceil(Nq / 128) blocks (1128 at MViT-v2's block 0, 564 at
//     blocks 1 and 2, over 132 SMs).
//
// The bf16 body (K4's dK/dV/dS in bfloat16): what the f32 body computes,
// with q, k, v and dO in bf16, r and s in f32, the same blocks (8 warps of
// 16 keys, BwdShape's SPLIT), 32-row query tiles and f32 partials per
// split, no atomics.
//   - K and V (bf16 rows of 16 KS + 8: an odd multiple of 16 bytes, so
//     ldmatrix reads no bank twice) and S^T (f32) stay in shared memory for
//     the block; each query tile's Q and dO (bf16), R rows, LSE and delta
//     stream through a ring of kBwdBf16Stages stages, copied by 16-byte
//     cp.async where D, the row stride and the bases allow (a row of D = 96
//     is 192 bytes); the bf16 tiles take half the f32 body's bytes, which
//     buys the deeper ring (the depth timed by probes/k4_bf16_dkv_stages.py).
//   - S^T = K Q^T and dP^T = V dO^T are bf16 mma.sync m16n8k16 with f32
//     accumulators, one pass each (a bf16 product is exact in f32): K or V
//     the A operand (ldmatrix of the strip's rows), the tile's Q or dO rows
//     the B operand (ldmatrix, as the forward reads K).
//   - The bias S^T R^T and dS^T += dl^T R stay 3xTF32 on m16n8k8, as in the
//     f32 body (r and s are f32; K3's bf16 forward forms its bias as 3xTF32
//     too, so the LSE and these logits come from the same form): the C
//     fragment of m16n8k16 has m16n8k8's layout, so dl's accumulators feed
//     the tf32 A fragment as they lie. Each tile's R rows (B operands of
//     both, read by all 8 warps) are split into tf32 hi (in place) and lo
//     (beside the ring) once, by the block; S^T (A operand) is split at
//     each load, as its lo copy would leave no room at D <= 64 with
//     M > 120.
//   - dV += w^T dO and dK += dl^T Q: n-tiles 2 kk and 2 kk + 1 of the
//     accumulators (16 query rows) are one k16 A fragment with the keys as
//     rows, as the forward's weights feed P.V; each f32 value of w and dl
//     is split into bf16 hi = bf16(x) and lo = bf16(x - hi), and lo.B then
//     hi.B are accumulated against the exact bf16 dO or Q (ldmatrix .trans:
//     the query rows are the k dimension). Each product keeps 16 significant
//     bits of w and dl (a relative error of at most 2^-17 a term; the
//     outputs are rounded to bf16, 2^-9). Each tile's product is formed in
//     a fresh accumulator and added to the running sums in f32; dK takes
//     its scale once a split.
//   - Registers at D = 96, M <= 56: dK and dV 48 floats a thread each, dS^T
//     28; S^T, dP^T and the bias 16 each; the split fragments 16 (w, dl)
//     and 32 (dl as tf32): up to 255 a thread, one block an SM.
//   - The launcher (launch_bwd_dkv_bf16, BwdParamsOf<bf16>) takes the same
//     25 shapes through with_bwd_shape and refuses D > 128 or M > 128;
//     without the bias, <KS, 0> reads any layout bwd_base describes.
//   - K2's form (<KS, 0, kBwdBf16Stages, true>, K2 in bfloat16), two
//     changes at compile time, K4's instantiations unchanged: dV takes w's
//     bf16 hi alone, w rounded once to nearest even as the TPU kernel's
//     w.astype(bf16) (flash_attention.py:191), while dK keeps dl's hi +
//     lo; and at one split dK (scaled once) and dV are rounded to bf16 and
//     stored straight into K2's (B, Nk, H, D) gradients (p.dk_out,
//     p.dv_out), with no f32 partials. Its rows come by K2's shifted
//     copies (see The bf16 copies of K2, at bwd_pick_copy), so the stray
//     positions are masked in the S^T and dP^T fragments.
//
// The bf16 query pass with the bias (K4's dQ/dR in bfloat16, the same TPU
// kernel as the f32 pass): what the f32 pass computes, with q, k, v and dO
// in bf16 and r, s, the LSE and delta in f32; dQ stored as bf16, dR as
// f32; the same grid (8 warps of 16 query rows, one sweep over key tiles
// of 32 through a two-stage cp.async ring), rows written once, no atomics.
//   - Q and dO (resident) and each tile's K and V are bf16 rows of
//     16 KS + 8 in shared memory, copied by 16-byte cp.async where D, the
//     row stride and the bases allow; the R rows (resident) and the s tile
//     stay f32, as in the f32 pass. A block takes 128,512 bytes at MViT's
//     D = 96, M <= 56, and 212,992 at D = 128, M = 128: 8 warps at every
//     bucket (kDqrBf16Warps).
//   - S = Q K^T and dP = dO V^T are bf16 mma.sync m16n8k16 with f32
//     accumulators, one pass each (a bf16 product is exact in f32): Q or
//     dO the A operand (ldmatrix of the warp's rows), the tile's K or V
//     rows the B operand (ldmatrix, as the forward reads K).
//   - The bias r.s is 3xTF32 on m16n8k8 in one sum, formed as the f32
//     pass forms it (mma3_t over R's rows and the s tile's columns), so
//     both K4 bf16 kernels build the same logits (K3's bf16 forward forms
//     its bias as 3xTF32 too); the m16n8k16 C fragment has m16n8k8's
//     layout, so the sum adds into S as it lies.
//   - dQ += dl K: n-tiles 2 kk and 2 kk + 1 of dl (queries as rows) are
//     one k16 A fragment, as the forward's weights feed P.V; each value is
//     split into bf16 hi + lo (a_split_bf16) and lo.K then hi.K are
//     accumulated against the exact bf16 K (ldmatrix .trans: the keys are
//     the k dimension), the tile's product in a fresh accumulator added to
//     dQ in f32 (add_tile_product); dQ is scaled once and rounded to bf16
//     at the end.
//   - dR += dl s^T stays 3xTF32 as in the f32 pass (dl split into tf32 hi
//     + lo, the s tile read across its rows): dR is an f32 output.
//   - Registers at D = 96, M <= 56: dQ 48 floats a thread, dR 28, S and
//     dP 32, the bias 16, dl's split fragments 16 (bf16) and 32 (tf32).
//   - The launcher (launch_bwd_dq_lowrank_bf16, BwdParamsOf<bf16>) takes
//     the same 25 shapes through with_bwd_shape and refuses D > 128 or
//     M > 128.
//
// The bf16 query pass (K2 in bfloat16; with the bf16 dK/dV body in K2's
// form it replaces flash_attention.py::flash_attention_trainable in bf16):
// what the f32 query pass computes, in its grid (4 warps of 16 query
// rows, 64 a block; key tiles of 32 through a two-stage cp.async ring,
// streamed twice; 3 blocks an SM at spans up to 32), with q, k, v and dO
// in bf16 and dQ stored as bf16.
//   - Sweep 1 keeps the online row max m, l = sum exp(S - m) and
//     c = sum exp(S - m) dP, rescaled when m moves, and writes
//     LSE = m + log l and delta = c / l (f32, (BH, Nq)); sweep 2 forms S
//     and dP again, w = exp(S - lse), dl = w (dP - delta), dQ += dl K.
//   - S = Q K^T and dP = dO V^T are bf16 mma.sync m16n8k16 with f32
//     accumulators (Q or dO the A operand by ldmatrix, the tile's K or V
//     the B operand), as the bf16 query pass with the bias forms them; dQ
//     += dl K from dl split into bf16 hi + lo (a_split_bf16, lo.K then
//     hi.K against K by ldmatrix .trans, the tile's product in a fresh
//     accumulator added in f32: add_tile_product); dQ is scaled once.
//   - Q, dO (resident) and each tile's K and V are bf16 rows of 16 KS + 8:
//     20,480 bytes a block at THAT's span of 32 (smem_bytes_dq_bf16).
//   - Rows come by K2's shifted copies (The bf16 copies of K2, at
//     bwd_pick_copy): the stray positions are masked in the S and dP
//     fragments, and position sh + c is stored as dQ's column c.
//   - Rows past Nq and keys past Nk are zero-filled and their weights set
//     to 0, as in the f32 pass. launch_bwd_bf16 runs it and then the bf16
//     dK/dV body in K2's form, at the span that holds the shifted heads.

#pragma once

#include "tc_attention.cuh"

namespace tc {

// a B fragment pair (offsets o0 and o1 of p) as tf32 hi and lo: taken
// split (hi at p, lo at plo) or split here
template <bool PRE>
__device__ __forceinline__ void load_b(const float* p, const float* plo,
                                       int o0, int o1, uint32_t (&bhi)[2],
                                       uint32_t (&blo)[2]) {
  if constexpr (PRE) {
    bhi[0] = __float_as_uint(p[o0]);
    bhi[1] = __float_as_uint(p[o1]);
    blo[0] = __float_as_uint(plo[o0]);
    blo[1] = __float_as_uint(plo[o1]);
  } else {
    split_tf32(p[o0], bhi[0], blo[0]);
    split_tf32(p[o1], bhi[1], blo[1]);
  }
}

// A fragment pairs of rows g8 and g8 + 8 (offsets o and o + 8 ld of p) at
// columns t4 and t4 + 4: taken split (hi at p, lo at plo) or split here
template <bool PRE>
__device__ __forceinline__ void load_a(const float* p, const float* plo,
                                       int o, int ld, uint32_t (&ahi)[4],
                                       uint32_t (&alo)[4]) {
  const int off[4] = {o, o + 8 * ld, o + 4, o + 8 * ld + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (PRE) {
      ahi[i] = __float_as_uint(p[off[i]]);
      alo[i] = __float_as_uint(plo[off[i]]);
    } else {
      split_tf32(p[off[i]], ahi[i], alo[i]);
    }
  }
}

// T: the element of q, k, v and dO (float, or bf16 in the bf16 body)
template <typename T>
struct BwdParamsOf {
  const T* q;          // Nq rows a group (see Layout)
  const T* k;          // Nk rows a group
  const T* v;          // Nk rows a group
  const float* r;      // (BH, Nq, M)
  const float* s;      // (M, Nk)
  const T* dout;       // q's layout
  float* lse;          // (BH, Nq): the query pass writes it, dK/dV reads
  float* delta;        // (BH, Nq)
  T* dq;               // q's layout and dtype (the query passes)
  float* dr;           // (BH, Nq, M): the query pass with the bias
  float* dk;           // k's layout, `part` elements a split
  float* dv;
  T* dk_out;           // K2's bf16 dK/dV pass: k's layout and dtype, in
  T* dv_out;           // place (one split)
  float* ds;           // (splits, BH, M, Nk)
  long long part;      // elements between two splits' dK (dV) partials
  int bh, heads, nq, nk, d, m;
  int row;             // elements between consecutive rows of a group
  int splits;          // blocks sharing one key block's query tiles
  int key_blocks;
  int q_tiles;
  int vec;             // elements per copy of a row: f32 4, 2 or 1; bf16
                       // 8, 4, 2 or 1
  int vec_s;           // f32 elements per copy of s: 4 or 1
  float scale;
};
typedef BwdParamsOf<float> BwdParams;

// the element offset of group grp's first row of n (b n row + h D)
template <typename T>
__device__ __forceinline__ long long bwd_base(const BwdParamsOf<T>& p,
                                              int grp, int n) {
  return (long long)(grp / p.heads) * n * p.row +
         (long long)(grp % p.heads) * p.d;
}

// the position of element 0 of group grp's rows in a tile (sh): its head's
// offset h D modulo the copy width. K2's bf16 launcher may pick a width
// that does not divide D and copies from h D - sh on (see The bf16 copies
// of K2); every other launcher picks one that divides D, so sh = 0.
template <typename T>
__device__ __forceinline__ int shift_of(const BwdParamsOf<T>& p, int grp) {
  return (int)((long long)(grp % p.heads) * p.d % p.vec);
}

// a k16 A fragment's pairs at columns 2 t4 (a[0], a[1]) and 8 + 2 t4
// (a[2], a[3]) masked by lo and hi (pair_mask)
__device__ __forceinline__ void mask_a(uint32_t (&a)[4], uint32_t lo,
                                       uint32_t hi) {
  a[0] &= lo;
  a[1] &= lo;
  a[2] &= hi;
  a[3] &= hi;
}

// the 4 floats at offset o (16-byte aligned) split into tf32 hi, in place,
// and lo, at the same offset of `lo`
__device__ __forceinline__ void split4(float* hi, float* lo, int o) {
  float4* hp = reinterpret_cast<float4*>(hi + o);
  const float4 x = *hp;
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  *hp = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                    __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo + o) =
      make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                  __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// rows of 16 KS floats (row stride LD) split into tf32 hi, in place, and
// lo, at the same offsets of `lo`, by the whole block
template <int KS, int LD, int THREADS>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int rows) {
  for (int i = threadIdx.x; i < rows * 4 * KS; i += THREADS)
    split4(hi, lo, (i / (4 * KS)) * LD + (i % (4 * KS)) * 4);
}

// n floats (a multiple of 4, from a 16-byte boundary) split likewise
template <int THREADS>
__device__ __forceinline__ void split_flat(float* hi, float* lo, int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * THREADS) split4(hi, lo, i);
}

constexpr int kBwdWarps = 8;
constexpr int kBwdRows = 32;  // query rows per tile

// Two warps share a key strip where dK, dV and dS^T would take more than
// 128 registers a thread.
template <int KS, int MT>
struct BwdShape {
  static constexpr int SPLIT = 16 * KS + 4 * MT > 128 ? 2 : 1;
  static constexpr int KEYS = 16 * kBwdWarps / SPLIT;
  // Q and dO split once a tile into tf32 hi and lo in shared memory (their
  // lo copy fits beside the ring up to spans of 96); else split on load
  static constexpr bool PRE = KS <= kF32WideSteps;
};

// dynamic shared memory of one block: K and V, S^T, two ring stages of
// Q, dO, R, the LSE and delta, and (pre) the lo copy of Q and dO
inline size_t smem_bytes_bwd(int ks, int m, int keys, bool pre) {
  const size_t ld = 16 * ks + 4, rs = m ? r_stride(m) : 0;
  return sizeof(float) *
         (keys * (2 * ld + rs) + 2 * (kBwdRows * (2 * ld + rs) + 2 * kBwdRows) +
          (pre ? 2 * kBwdRows * ld : 0));
}

// the m-tiles of 8 factor columns an instantiation holds: M = 0, <= 16,
// <= 40 (MViT's 37), <= 56 (51), <= 128
inline int bwd_m_tiles(int m) {
  return m == 0 ? 0 : m <= 16 ? 2 : m <= 40 ? 5 : m <= 56 ? 7 : 16;
}

// 2 blocks an SM without the bias at spans up to 32 (at most 128 registers
// a thread), else 1
template <int KS, int MT>
__global__ void __launch_bounds__(32 * kBwdWarps, MT == 0 && KS <= 2 ? 2 : 1)
    attention_bwd_dkv_f32_kernel(BwdParams p) {
  constexpr bool BIAS = MT > 0;
  constexpr int SPLIT = BwdShape<KS, MT>::SPLIT;
  constexpr int KEYS = BwdShape<KS, MT>::KEYS;
  constexpr bool PRE = BwdShape<KS, MT>::PRE;
  constexpr int THREADS = 32 * kBwdWarps, QT = kBwdRows;
  constexpr int LD = 16 * KS + 4;
  constexpr int K8 = 2 * KS;                     // k-steps of 8 over the span
  constexpr int NQ = QT / 8;                     // n-tiles of 8 query rows
  constexpr int ND = K8 / SPLIT;                 // this warp's dK, dV n-tiles
  constexpr int NM = BIAS ? (MT + SPLIT - 1) / SPLIT : 1;  // its dS^T ones
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m8 = BIAS ? round8(p.m) : 0;
  const int rs = BIAS ? r_stride(p.m) : 0;
  float* sk = reinterpret_cast<float*>(smem_raw);  // [KEYS][LD]
  float* sv = sk + KEYS * LD;                      // [KEYS][LD]
  float* sst = sv + KEYS * LD;                     // [KEYS][rs]: S^T
  float* ring = sst + KEYS * rs;                   // [2][stage]
  // a stage: Q [QT][LD], dO [QT][LD], R [QT][rs], the LSE and delta [QT]
  const int stage = QT * (2 * LD + rs) + 2 * QT;
  float* slo = ring + 2 * stage;  // [2 QT][LD]: Q's and dO's tf32 lo parts

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int strip = warp / SPLIT, half = warp % SPLIT;
  int bid = blockIdx.x;
  const int kblock = bid % p.key_blocks;
  bid /= p.key_blocks;
  const int split = bid % p.splits;
  const int grp = bid / p.splits;
  const int k0 = kblock * KEYS;
  const int keys = min(KEYS, p.nk - k0);
  const int t_begin = (int)((long long)split * p.q_tiles / p.splits);
  const int t_end = (int)((long long)(split + 1) * p.q_tiles / p.splits);
  const int d = p.d;  // a multiple of the copy width
  const int chunks = d / p.vec;
  int cshift = 0;
  while ((1 << cshift) < chunks) ++cshift;
  const long long qoff = bwd_base(p, grp, p.nq);
  const float* qb = p.q + qoff;
  const float* dob = p.dout + qoff;

  // the copies fill columns [0, D) of each row; the span's columns past D
  // are zeroed once (K and V, and both stages' Q and dO), so the padded
  // products add nothing
  if (d < 16 * KS) {
    const int pad = 16 * KS - d;
    for (int i = threadIdx.x; i < 2 * KEYS * pad; i += THREADS)
      sk[(i / pad) * LD + d + i % pad] = 0.f;  // sk and sv are adjacent
    for (int i = threadIdx.x; i < 4 * QT * pad; i += THREADS) {
      const int row = i / pad;  // stage row / (2 QT), Q and dO adjacent
      ring[(row / (2 * QT)) * stage + (row % (2 * QT)) * LD + d + i % pad] =
          0.f;
    }
  }

  auto fetch = [&](int t) {
    float* st = ring + ((t - t_begin) & 1) * stage;
    const int row0 = t * QT, rows = min(QT, p.nq - row0);
    copy_rows<LD, QT, THREADS>(st, qb + (long long)row0 * p.row, p.row, rows,
                               chunks, cshift, p.vec, p.q);
    copy_rows<LD, QT, THREADS>(st + QT * LD, dob + (long long)row0 * p.row,
                               p.row, rows, chunks, cshift, p.vec, p.dout);
    if constexpr (BIAS)
      copy_r<QT, THREADS>(st + 2 * QT * LD, p.r, grp, p.nq, row0, rows, p.m,
                          rs);
    if (threadIdx.x < 2 * QT) {  // the LSE, then delta
      const int i = threadIdx.x % QT;
      const float* src = threadIdx.x < QT ? p.lse : p.delta;
      const bool ok = i < rows;
      cp_async<4>(st + QT * (2 * LD + rs) + threadIdx.x,
                  ok ? src + (long long)grp * p.nq + row0 + i : src, ok);
    }
  };

  // prologue: the block's K, V and S^T rows with tile 0, then tile 1
  const long long kvoff = bwd_base(p, grp, p.nk) + (long long)k0 * p.row;
  copy_rows<LD, KEYS, THREADS>(sk, p.k + kvoff, p.row, keys, chunks, cshift,
                               p.vec, p.k);
  copy_rows<LD, KEYS, THREADS>(sv, p.v + kvoff, p.row, keys, chunks, cshift,
                               p.vec, p.v);
  if constexpr (BIAS)
    for (int i = threadIdx.x; i < rs * KEYS; i += THREADS) {
      const int c = i / KEYS, key = i - c * KEYS;  // keys fastest: coalesced
      const bool ok = c < p.m && key < keys;
      cp_async<4>(sst + key * rs + c,
                  ok ? p.s + (long long)c * p.nk + k0 + key : p.s, ok);
    }
  fetch(t_begin);
  cp_commit();
  if (t_begin + 1 < t_end) fetch(t_begin + 1);
  cp_commit();

  float dk[ND][4], dv[ND][4], dst[NM][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[i][e] = 0.f;

  // this lane's keys: strip rows g8 and g8 + 8 (the A fragments' rows)
  const int key_row = strip * 16 + g8;
  const bool idle = strip * 16 >= keys;  // a ragged last key block
  const bool key_ok0 = key_row < keys, key_ok1 = key_row + 8 < keys;
  const float* ka = sk + key_row * LD + t4;
  const float* va = sv + key_row * LD + t4;
  const float* sa = sst + key_row * rs + t4;

  for (int t = t_begin; t < t_end; ++t) {
    cp_wait<1>();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();
    float* stg = ring + ((t - t_begin) & 1) * stage;
    if constexpr (PRE) {  // Q and dO into tf32 hi (in place) and lo
      split_rows<KS, LD, THREADS>(stg, slo, 2 * QT);
      __syncthreads();
    }
    const float* sq = stg;
    const float* sdo = sq + QT * LD;
    const float* sq_lo = slo;
    const float* sdo_lo = slo + QT * LD;
    const float* sr = sdo + QT * LD;
    const float* sl = sr + QT * rs;  // the LSE; delta at sl + QT
    const int rows = min(QT, p.nq - t * QT);

    if (!idle) {
      // S^T = K Q^T, 3xTF32 with the small terms apart; the B fragment of
      // n-tile j is query rows 8 j + g8 at columns 8 kk + t4 and + 4
      float w[NQ][4], small[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[j][e] = small[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K8; ++kk) {
        uint32_t ahi[4], alo[4];
        split_tf32(ka[8 * kk], ahi[0], alo[0]);
        split_tf32(ka[8 * kk + 8 * LD], ahi[1], alo[1]);
        split_tf32(ka[8 * kk + 4], ahi[2], alo[2]);
        split_tf32(ka[8 * kk + 8 * LD + 4], ahi[3], alo[3]);
        const int bo = g8 * LD + 8 * kk + t4;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          uint32_t bhi[2], blo[2];
          load_b<PRE>(sq, sq_lo, bo + 8 * j * LD, bo + 8 * j * LD + 4, bhi,
                      blo);
          mma3_apart(w[j], small[j], ahi, alo, bhi, blo);
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[j][e] = (w[j][e] + small[j][e]) * p.scale;

      if constexpr (BIAS) {  // + r s: S^T R^T as 3xTF32 in one sum
        float (&b)[NQ][4] = small;
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) b[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {
          if (8 * kk >= m8) break;
          uint32_t ahi[4], alo[4];
          split_tf32(sa[8 * kk], ahi[0], alo[0]);
          split_tf32(sa[8 * kk + 8 * rs], ahi[1], alo[1]);
          split_tf32(sa[8 * kk + 4], ahi[2], alo[2]);
          split_tf32(sa[8 * kk + 8 * rs + 4], ahi[3], alo[3]);
          const int bo = g8 * rs + 8 * kk + t4;
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            uint32_t bhi[2], blo[2];
            load_b<false>(sr, nullptr, bo + 8 * j * rs, bo + 8 * j * rs + 4,
                          bhi, blo);
            mma3(b[j], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) w[j][e] += b[j][e];
      }

      // w = exp(logits - lse); 0 for rows past Nq and keys past Nk
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t4);
        w[j][0] = expf(w[j][0] - l.x);
        w[j][1] = expf(w[j][1] - l.y);
        w[j][2] = expf(w[j][2] - l.x);
        w[j][3] = expf(w[j][3] - l.y);
      }
      if (rows < QT || !key_ok1) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int row = 8 * j + 2 * t4;
          if (row >= rows || !key_ok0) w[j][0] = 0.f;
          if (row + 1 >= rows || !key_ok0) w[j][1] = 0.f;
          if (row >= rows || !key_ok1) w[j][2] = 0.f;
          if (row + 1 >= rows || !key_ok1) w[j][3] = 0.f;
        }
      }

      // dP^T = V dO^T, 3xTF32 in one accumulator; dl = w (dP - delta)
      float dl[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dl[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K8; ++kk) {
        uint32_t ahi[4], alo[4];
        split_tf32(va[8 * kk], ahi[0], alo[0]);
        split_tf32(va[8 * kk + 8 * LD], ahi[1], alo[1]);
        split_tf32(va[8 * kk + 4], ahi[2], alo[2]);
        split_tf32(va[8 * kk + 8 * LD + 4], ahi[3], alo[3]);
        const int bo = g8 * LD + 8 * kk + t4;
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          uint32_t bhi[2], blo[2];
          load_b<PRE>(sdo, sdo_lo, bo + 8 * j * LD, bo + 8 * j * LD + 4, bhi,
                      blo);
          mma3(dl[j], ahi, alo, bhi, blo);
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 dt =
            *reinterpret_cast<const float2*>(sl + QT + 8 * j + 2 * t4);
        dl[j][0] = w[j][0] * (dl[j][0] - dt.x);
        dl[j][1] = w[j][1] * (dl[j][1] - dt.y);
        dl[j][2] = w[j][2] * (dl[j][2] - dt.x);
        dl[j][3] = w[j][3] * (dl[j][3] - dt.y);
      }

      // dV += w^T dO: A columns t4 and t4 + 4 of k-step j are query rows
      // 8 j + 2 t4 and + 1, this lane's accumulator columns as they lie
      uint32_t ahi[NQ][4], alo[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        split_tf32(w[j][0], ahi[j][0], alo[j][0]);  // key g8, row 2 t4
        split_tf32(w[j][2], ahi[j][1], alo[j][1]);  // key g8 + 8
        split_tf32(w[j][1], ahi[j][2], alo[j][2]);  // row 2 t4 + 1
        split_tf32(w[j][3], ahi[j][3], alo[j][3]);
      }
      const int bo = 2 * t4 * LD + g8;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int dn = half * ND + i;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int o = bo + 8 * j * LD + 8 * dn;
          uint32_t bhi[2], blo[2];
          load_b<PRE>(sdo, sdo_lo, o, o + LD, bhi, blo);
          mma3(acc, ahi[j], alo[j], bhi, blo);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[i][e] += acc[e];
      }

      // dK += dl^T Q (the scale at the end), dS^T += dl^T R
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        split_tf32(dl[j][0], ahi[j][0], alo[j][0]);
        split_tf32(dl[j][2], ahi[j][1], alo[j][1]);
        split_tf32(dl[j][1], ahi[j][2], alo[j][2]);
        split_tf32(dl[j][3], ahi[j][3], alo[j][3]);
      }
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int dn = half * ND + i;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int o = bo + 8 * j * LD + 8 * dn;
          uint32_t bhi[2], blo[2];
          load_b<PRE>(sq, sq_lo, o, o + LD, bhi, blo);
          mma3(acc, ahi[j], alo[j], bhi, blo);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[i][e] += acc[e];
      }
      if constexpr (BIAS) {
        const int ro = 2 * t4 * rs + g8;
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          const int mt = half * NM + i;
          if (8 * mt >= m8) continue;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int o = ro + 8 * j * rs + 8 * mt;
            uint32_t bhi[2], blo[2];
            load_b<false>(sr, nullptr, o, o + rs, bhi, blo);
            mma3(acc, ahi[j], alo[j], bhi, blo);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[i][e] += acc[e];
        }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (t + 2 < t_end) fetch(t + 2);
    cp_commit();  // an empty group keeps the wait count uniform
  }

  // the partials of this lane's keys: dK scaled once, here
  const long long part = (long long)split * p.bh + grp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_row + 8 * h;
    if (key >= keys) continue;
    const long long o = split * p.part + kvoff + (long long)key * p.row;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (half * ND + i) + 2 * t4 + e;
        if (c < d) {
          p.dk[o + c] = dk[i][2 * h + e] * p.scale;
          p.dv[o + c] = dv[i][2 * h + e];
        }
      }
    }
    if constexpr (BIAS) {
#pragma unroll
      for (int i = 0; i < NM; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * (half * NM + i) + 2 * t4 + e;
          if (c < p.m)
            p.ds[(part * p.m + c) * p.nk + k0 + key] = dst[i][2 * h + e];
        }
      }
    }
  }
}

// ----------------------------------------------------------------------
// The bf16 dK/dV/dS body
// ----------------------------------------------------------------------

// query tiles in the bf16 body's cp.async ring (PERF.md: 2, 3 and 4 timed
// at MViT's training blocks)
constexpr int kBwdBf16Stages = 2;

// dynamic shared memory of one bf16 block: K and V (bf16 rows of 16 ks + 8),
// S^T, the tf32 lo parts of a tile's R, and `stages` ring stages of Q and
// dO (bf16), R, the LSE and delta
inline size_t smem_bytes_bwd_bf16(int ks, int m, int keys, int stages) {
  const size_t ld = 16 * ks + 8, rs = m ? r_stride(m) : 0;
  return sizeof(bf16) * 2 * keys * ld +
         sizeof(float) * (keys + kBwdRows) * rs +
         stages * (sizeof(bf16) * 2 * kBwdRows * ld +
                   sizeof(float) * (kBwdRows * rs + 2 * kBwdRows));
}

// x0 and x1 as bf16 pairs hi + lo: hi rounded to nearest, lo the rounded
// remainder (16 significant bits of each value; x0 in the low halves)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

// The A fragments (k-steps of 16 query rows) of x^T, x the accumulators of
// NQ n-tiles of 8 query rows with the strip's keys as rows: a k-step's
// n-tiles 2 kk and 2 kk + 1 are its columns 0-7 and 8-15, as the forward's
// weights feed P.V; each value split into bf16 hi + lo
template <int NQ>
__device__ __forceinline__ void a_split_bf16(const float (&x)[NQ][4],
                                             uint32_t (&hi)[NQ / 2][4],
                                             uint32_t (&lo)[NQ / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NQ / 2; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // key g8 (i even) or g8 + 8, n-tile
      const float* c = x[2 * kk + i / 2];  // 2 kk + i / 2
      split_bf16(c[2 * (i % 2)], c[2 * (i % 2) + 1], hi[kk][i], lo[kk][i]);
    }
}

// acc[i] += (hi + lo) B over one tile's query rows for this warp's n-tiles
// n0 + i of 8 columns: lo B, then hi B, into a fresh accumulator, then
// added in f32 (!LO: hi B alone). B is the tile's bf16 rows of dO or Q
// (row stride LD), the query rows the k dimension, so ldmatrix reads it
// transposed.
template <int ND, int KQ, int LD, bool LO = true>
__device__ __forceinline__ void add_tile_product(float (&acc)[ND][4],
                                                 const uint32_t (&hi)[KQ][4],
                                                 const uint32_t (&lo)[KQ][4],
                                                 const bf16* b, int n0,
                                                 int lane) {
#pragma unroll
  for (int i = 0; i < ND; i += 2) {
    float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      uint32_t f[4];  // n-tile n0 + i (f[0], f[1]) and the next (f[2], f[3])
      ldmatrix_x4_trans(f, b + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8)
                                   * LD + 8 * (n0 + i) + (lane >> 4) * 8);
      if constexpr (LO) {
        mma(t[0], lo[kk], f[0], f[1]);
        mma(t[1], lo[kk], f[2], f[3]);
      }
      mma(t[0], hi[kk], f[0], f[1]);
      mma(t[1], hi[kk], f[2], f[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[i][e] += t[0][e];
      acc[i + 1][e] += t[1][e];
    }
  }
}

// The f32 body's decomposition (BwdShape: 8 warps of 16 keys, SPLIT) with
// bf16 K, V, Q and dO and STAGES query tiles in the ring; 2 blocks an SM
// without the bias at spans up to 32, else 1. K2: K2's form (see The bf16
// query pass), without the bias and at one split: dV from w's bf16 hi
// alone, dK and dV rounded to bf16 into p.dk_out and p.dv_out.
template <int KS, int MT, int STAGES, bool K2 = false>
__global__ void __launch_bounds__(32 * kBwdWarps, MT == 0 && KS <= 2 ? 2 : 1)
    attention_bwd_dkv_bf16_kernel(BwdParamsOf<bf16> p) {
  static_assert(!K2 || MT == 0, "K2's form has no bias");
  constexpr bool BIAS = MT > 0;
  constexpr int SPLIT = BwdShape<KS, MT>::SPLIT;
  constexpr int KEYS = BwdShape<KS, MT>::KEYS;
  constexpr int THREADS = 32 * kBwdWarps, QT = kBwdRows;
  constexpr int LD = 16 * KS + 8;   // bf16: an odd multiple of 16 bytes
  constexpr int NQ = QT / 8;        // n-tiles of 8 query rows
  constexpr int KQ = QT / 16;       // k-steps of 16 query rows
  constexpr int ND = 2 * KS / SPLIT;  // this warp's dK, dV n-tiles (even)
  constexpr int NM = BIAS ? (MT + SPLIT - 1) / SPLIT : 1;  // its dS^T ones
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m8 = BIAS ? round8(p.m) : 0;
  const int rs = BIAS ? r_stride(p.m) : 0;
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);               // [KEYS][LD]
  bf16* sv = sk + KEYS * LD;                                  // [KEYS][LD]
  float* sst = reinterpret_cast<float*>(sv + KEYS * LD);      // [KEYS][rs]
  float* sr_lo = sst + KEYS * rs;        // [QT][rs]: the tile's R's tf32
                                         // lo parts
  unsigned char* ring = reinterpret_cast<unsigned char*>(sr_lo + QT * rs);
  // a stage: Q [QT][LD] and dO [QT][LD] bf16, then R [QT][rs], the LSE
  // and delta [QT] f32
  const int stage =
      (int)(sizeof(bf16) * 2 * QT * LD + sizeof(float) * (QT * rs + 2 * QT));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int strip = warp / SPLIT, half = warp % SPLIT;
  int bid = blockIdx.x;
  const int kblock = bid % p.key_blocks;
  bid /= p.key_blocks;
  const int split = bid % p.splits;
  const int grp = bid / p.splits;
  const int k0 = kblock * KEYS;
  const int keys = min(KEYS, p.nk - k0);
  const int t_begin = (int)((long long)split * p.q_tiles / p.splits);
  const int t_end = (int)((long long)(split + 1) * p.q_tiles / p.splits);
  const int d = p.d;  // K4: a multiple of the copy width
  // K2: the head's element c at position sh + c (see The bf16 copies of
  // K2), positions outside [sh, sh + D) zeroed in the S^T and dP^T
  // fragments
  const int sh = K2 ? shift_of(p, grp) : 0;
  const int chunks = K2 ? (sh + d + p.vec - 1) / p.vec : d / p.vec;
  int cshift = 0;
  while ((1 << cshift) < chunks) ++cshift;
  const bool ragged = K2 && (sh != 0 || sh + d != 16 * KS);
  const long long qoff = bwd_base(p, grp, p.nq) - sh;
  const bf16* qb = p.q + qoff;
  const bf16* dob = p.dout + qoff;

  // the copies fill columns [0, D) of each row; the span's columns past D
  // are zeroed once (K and V, and every stage's Q and dO), so the padded
  // products add nothing (K2 masks its fragments instead: its copies may
  // write past position D)
  if (!K2 && d < 16 * KS) {
    const int pad = 16 * KS - d;
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < 2 * KEYS * pad; i += THREADS)
      sk[(i / pad) * LD + d + i % pad] = zero;  // sk and sv are adjacent
    for (int i = threadIdx.x; i < STAGES * 2 * QT * pad; i += THREADS) {
      const int row = i / pad;  // stage row / (2 QT), Q and dO adjacent
      reinterpret_cast<bf16*>(ring + (row / (2 * QT)) * stage)
          [(row % (2 * QT)) * LD + d + i % pad] = zero;
    }
  }

  // query tile t into ring stage `slot`
  auto fetch = [&](int t, int slot) {
    bf16* st = reinterpret_cast<bf16*>(ring + slot * stage);
    const int row0 = t * QT, rows = min(QT, p.nq - row0);
    copy_rows<LD, QT, THREADS>(st, qb + (long long)row0 * p.row, p.row, rows,
                               chunks, cshift, p.vec, d, p.q);
    copy_rows<LD, QT, THREADS>(st + QT * LD, dob + (long long)row0 * p.row,
                               p.row, rows, chunks, cshift, p.vec, d,
                               p.dout);
    float* sr = reinterpret_cast<float*>(st + 2 * QT * LD);
    if constexpr (BIAS) {
      copy_r<QT, THREADS>(sr, p.r, grp, p.nq, row0, rows, p.m, rs);
    }
    if (threadIdx.x < 2 * QT) {  // the LSE, then delta
      const int i = threadIdx.x % QT;
      const float* src = threadIdx.x < QT ? p.lse : p.delta;
      const bool ok = i < rows;
      cp_async<4>(sr + QT * rs + threadIdx.x,
                  ok ? src + (long long)grp * p.nq + row0 + i : src, ok);
    }
  };

  // prologue: the block's K, V and S^T rows with tile 0, then the next
  // STAGES - 1 tiles, a group each
  const long long kvoff = bwd_base(p, grp, p.nk) + (long long)k0 * p.row;
  copy_rows<LD, KEYS, THREADS>(sk, p.k + kvoff - sh, p.row, keys, chunks,
                               cshift, p.vec, d, p.k);
  copy_rows<LD, KEYS, THREADS>(sv, p.v + kvoff - sh, p.row, keys, chunks,
                               cshift, p.vec, d, p.v);
  if constexpr (BIAS) {
    for (int i = threadIdx.x; i < rs * KEYS; i += THREADS) {
      const int c = i / KEYS, key = i - c * KEYS;  // keys fastest: coalesced
      const bool ok = c < p.m && key < keys;
      cp_async<4>(sst + key * rs + c,
                  ok ? p.s + (long long)c * p.nk + k0 + key : p.s, ok);
    }
  }
#pragma unroll
  for (int i = 0; i < STAGES; ++i) {
    if (t_begin + i < t_end) fetch(t_begin + i, i);
    cp_commit();
  }

  float dk[ND][4], dv[ND][4], dst[NM][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[i][e] = 0.f;

  // this lane's keys: strip rows g8 and g8 + 8 (the accumulators' rows);
  // its ldmatrix row of the strip's K and V A fragments
  const int key_row = strip * 16 + g8;
  const bool idle = strip * 16 >= keys;  // a ragged last key block
  const bool key_ok0 = key_row < keys, key_ok1 = key_row + 8 < keys;
  const int ao = (strip * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int sa = key_row * rs + t4;  // S^T's A fragments

  int slot = 0;
  for (int t = t_begin; t < t_end; ++t) {
    cp_wait<STAGES - 1>();  // tile t has landed (later ones may be in flight)
    __syncthreads();
    bf16* sq = reinterpret_cast<bf16*>(ring + slot * stage);
    const bf16* sdo = sq + QT * LD;
    float* sr = reinterpret_cast<float*>(sq + 2 * QT * LD);
    const float* sl = sr + QT * rs;  // the LSE; delta at sl + QT
    const int rows = min(QT, p.nq - t * QT);
    if constexpr (BIAS) {  // R into tf32 hi (in place) and lo, once for
                           // every warp
      split_flat<THREADS>(sr, sr_lo, QT * rs);
      __syncthreads();
    }

    if (!idle) {
      // S^T = K Q^T and dP^T = V dO^T: bf16 mma.sync m16n8k16, K or V the
      // A operand; the B fragments of n-tiles 2 np and 2 np + 1 are query
      // rows 16 np + 0-15 at columns 16 kk + 0-15 (ldmatrix, as the
      // forward reads K)
      float w[NQ][4], dl[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[j][e] = dl[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, sk + ao + 16 * kk);
        ldmatrix_x4(va, sv + ao + 16 * kk);
        uint32_t lo = 0xffffffffu, hi = 0xffffffffu;
        if (ragged) {
          lo = pair_mask(16 * kk + 2 * t4, sh, d);
          hi = pair_mask(16 * kk + 8 + 2 * t4, sh, d);
          mask_a(ka, lo, hi);
          mask_a(va, lo, hi);
        }
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int bo = (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         16 * kk + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldmatrix_x4(b, sq + bo);
          mma(w[2 * np], ka, b[0] & lo, b[1] & hi);
          mma(w[2 * np + 1], ka, b[2] & lo, b[3] & hi);
          ldmatrix_x4(b, sdo + bo);
          mma(dl[2 * np], va, b[0] & lo, b[1] & hi);
          mma(dl[2 * np + 1], va, b[2] & lo, b[3] & hi);
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[j][e] *= p.scale;

      if constexpr (BIAS) {  // + r s: S^T R^T as 3xTF32 in one sum, as the
                             // f32 body forms it
        float b[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) b[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {
          if (8 * kk >= m8) break;
          uint32_t ahi[4], alo[4];
          load_a<false>(sst, nullptr, sa + 8 * kk, rs, ahi, alo);
          const int bo = g8 * rs + 8 * kk + t4;
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            uint32_t bhi[2], blo[2];
            load_b<true>(sr, sr_lo, bo + 8 * j * rs, bo + 8 * j * rs + 4, bhi,
                         blo);
            mma3(b[j], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) w[j][e] += b[j][e];
      }

      // w = exp(logits - lse), 0 for rows past Nq and keys past Nk;
      // dl = w (dP - delta)
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * t4);
        w[j][0] = expf(w[j][0] - l.x);
        w[j][1] = expf(w[j][1] - l.y);
        w[j][2] = expf(w[j][2] - l.x);
        w[j][3] = expf(w[j][3] - l.y);
      }
      if (rows < QT || !key_ok1) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const int row = 8 * j + 2 * t4;
          if (row >= rows || !key_ok0) w[j][0] = 0.f;
          if (row + 1 >= rows || !key_ok0) w[j][1] = 0.f;
          if (row >= rows || !key_ok1) w[j][2] = 0.f;
          if (row + 1 >= rows || !key_ok1) w[j][3] = 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const float2 dt =
            *reinterpret_cast<const float2*>(sl + QT + 8 * j + 2 * t4);
        dl[j][0] = w[j][0] * (dl[j][0] - dt.x);
        dl[j][1] = w[j][1] * (dl[j][1] - dt.y);
        dl[j][2] = w[j][2] * (dl[j][2] - dt.x);
        dl[j][3] = w[j][3] * (dl[j][3] - dt.y);
      }

      // dV += w^T dO and dK += dl^T Q (the scale at the end), w and dl
      // split into bf16 hi + lo (K2: dV from hi alone, w rounded once)
      uint32_t hi[KQ][4], lo[KQ][4];
      a_split_bf16<NQ>(w, hi, lo);
      add_tile_product<ND, KQ, LD, !K2>(dv, hi, lo, sdo, half * ND, lane);
      a_split_bf16<NQ>(dl, hi, lo);
      add_tile_product<ND, KQ, LD>(dk, hi, lo, sq, half * ND, lane);

      if constexpr (BIAS) {  // dS^T += dl^T R, 3xTF32 as in the f32 body
        uint32_t ahi[NQ][4], alo[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          split_tf32(dl[j][0], ahi[j][0], alo[j][0]);  // key g8, row 2 t4
          split_tf32(dl[j][2], ahi[j][1], alo[j][1]);  // key g8 + 8
          split_tf32(dl[j][1], ahi[j][2], alo[j][2]);  // row 2 t4 + 1
          split_tf32(dl[j][3], ahi[j][3], alo[j][3]);
        }
        const int ro = 2 * t4 * rs + g8;
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          const int mt = half * NM + i;
          if (8 * mt >= m8) continue;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const int o = ro + 8 * j * rs + 8 * mt;
            uint32_t bhi[2], blo[2];
            load_b<true>(sr, sr_lo, o, o + rs, bhi, blo);
            mma3(acc, ahi[j], alo[j], bhi, blo);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) dst[i][e] += acc[e];
        }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (t + STAGES < t_end) fetch(t + STAGES, slot);
    cp_commit();  // an empty group keeps the wait count uniform
    slot = slot + 1 == STAGES ? 0 : slot + 1;
  }

  // the partials of this lane's keys (K2: the gradients, in bf16): dK
  // scaled once, here
  const long long part = (long long)split * p.bh + grp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key_row + 8 * h;
    if (key >= keys) continue;
    const long long o = split * p.part + kvoff + (long long)key * p.row;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * (half * ND + i) + 2 * t4 + e - sh;
        if (c < 0 || c >= d) continue;
        if constexpr (K2) {
          store(p.dk_out + o + c, dk[i][2 * h + e] * p.scale);
          store(p.dv_out + o + c, dv[i][2 * h + e]);
        } else {
          p.dk[o + c] = dk[i][2 * h + e] * p.scale;
          p.dv[o + c] = dv[i][2 * h + e];
        }
      }
    }
    if constexpr (BIAS) {
#pragma unroll
      for (int i = 0; i < NM; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * (half * NM + i) + 2 * t4 + e;
          if (c < p.m)
            p.ds[(part * p.m + c) * p.nk + k0 + key] = dst[i][2 * h + e];
        }
      }
    }
  }
}

// ----------------------------------------------------------------------
// The query pass
// ----------------------------------------------------------------------

constexpr int kDqWarps = 4;
constexpr int kDqRows = 16 * kDqWarps;  // query rows per block
constexpr int kDqKeys = 32;             // keys per tile

// Q and dO split once a block at spans up to 32 (see The query pass)
template <int KS>
struct DqShape {
  static constexpr bool PRE = KS <= 2;
};

// dynamic shared memory of one query-pass block: Q and dO, two ring
// stages of K and V, K's and V's lo parts, and (pre) Q's and dO's
inline size_t smem_bytes_dq(int ks, bool pre) {
  return sizeof(float) * (16 * ks + 4) *
         ((pre ? 4 : 2) * kDqRows + 6 * kDqKeys);
}

// mma3 and mma3_apart with A's and B's roles swapped: each mma adds the
// products of the other order's mma (hi.lo, then lo.hi, then hi.hi), so
// S = Q K^T here is S^T = K Q^T of the dK/dV pass, and dP = dO V^T its
// dP^T = V dO^T
__device__ __forceinline__ void mma3_t(float (&d)[4],
                                       const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4],
                                       const uint32_t (&bhi)[2],
                                       const uint32_t (&blo)[2]) {
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

__device__ __forceinline__ void mma3_apart_t(float (&big)[4],
                                             float (&small)[4],
                                             const uint32_t (&ahi)[4],
                                             const uint32_t (&alo)[4],
                                             const uint32_t (&bhi)[2],
                                             const uint32_t (&blo)[2]) {
  mma_tf32(small, ahi, blo[0], blo[1]);
  mma_tf32(small, alo, bhi[0], bhi[1]);
  float hh[4];
  mma_tf32_new(hh, ahi, bhi[0], bhi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) big[e] += hh[e];
}

// 3 blocks an SM at spans up to 32 (at most 170 registers a thread)
template <int KS>
__global__ void __launch_bounds__(32 * kDqWarps, KS <= 2 ? 3 : 1)
    attention_bwd_dq_f32_kernel(BwdParams p) {
  constexpr bool PRE = DqShape<KS>::PRE;
  constexpr int THREADS = 32 * kDqWarps, ROWS = kDqRows, KEYS = kDqKeys;
  constexpr int LD = 16 * KS + 4;
  constexpr int K8 = 2 * KS;    // k-steps of 8 over the span, and dQ's
                                // n-tiles of 8 columns
  constexpr int NT = KEYS / 8;  // n-tiles of 8 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [ROWS][LD]
  float* sdo = sq + ROWS * LD;                     // [ROWS][LD]
  float* ring = sdo + ROWS * LD;   // [2][2 KEYS][LD]: K, then V
  float* kvlo = ring + 4 * KEYS * LD;  // [2 KEYS][LD]: their lo parts
  float* sqlo = kvlo + 2 * KEYS * LD;  // (pre) [ROWS][LD]: Q's lo parts,
  const float* sdolo = sqlo + ROWS * LD;  // then dO's

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int tile = blockIdx.x % p.q_tiles;
  const int grp = blockIdx.x / p.q_tiles;
  const int row0 = tile * ROWS;
  const int rows = min(ROWS, p.nq - row0);
  const int d = p.d;  // a multiple of the copy width
  const int chunks = d / p.vec;
  int cshift = 0;
  while ((1 << cshift) < chunks) ++cshift;
  const long long qoff = bwd_base(p, grp, p.nq) + (long long)row0 * p.row;
  const long long kvoff = bwd_base(p, grp, p.nk);
  const int tiles_k = (p.nk + KEYS - 1) / KEYS;

  // the copies fill columns [0, D) of each row; the span's columns past D
  // are zeroed once (Q, dO and both stages' K and V, adjacent), so the
  // padded products add nothing
  if (d < 16 * KS) {
    const int pad = 16 * KS - d;
    for (int i = threadIdx.x; i < (2 * ROWS + 4 * KEYS) * pad; i += THREADS)
      sq[(i / pad) * LD + d + i % pad] = 0.f;
  }

  // tiles u of the two sweeps: key tile u mod tiles_k, ring stage u & 1
  auto fetch = [&](int u) {
    float* st = ring + (u & 1) * 2 * KEYS * LD;
    const int k0 = (u < tiles_k ? u : u - tiles_k) * KEYS;
    const int valid = min(KEYS, p.nk - k0);
    const long long o = kvoff + (long long)k0 * p.row;
    copy_rows<LD, KEYS, THREADS>(st, p.k + o, p.row, valid, chunks, cshift,
                                 p.vec, p.k);
    copy_rows<LD, KEYS, THREADS>(st + KEYS * LD, p.v + o, p.row, valid,
                                 chunks, cshift, p.vec, p.v);
  };

  // prologue: Q and dO with tile 0, then tile 1
  copy_rows<LD, ROWS, THREADS>(sq, p.q + qoff, p.row, rows, chunks, cshift,
                               p.vec, p.q);
  copy_rows<LD, ROWS, THREADS>(sdo, p.dout + qoff, p.row, rows, chunks,
                               cshift, p.vec, p.dout);
  fetch(0);
  cp_commit();
  fetch(1);  // two sweeps: at least two tiles
  cp_commit();

  const bool idle = warp * 16 >= rows;  // a ragged last query tile
  const int ao = (warp * 16 + g8) * LD + t4;  // this lane's A fragments
  float dq[K8][4];
#pragma unroll
  for (int j = 0; j < K8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  // rows g8 and g8 + 8: the running max, this lane's shares of l and c;
  // after sweep 1 the LSE and delta
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f}, c_run[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};

  for (int u = 0; u < 2 * tiles_k; ++u) {
    cp_wait<1>();  // tile u has landed (u + 1 may be in flight)
    __syncthreads();
    float* kt = ring + (u & 1) * 2 * KEYS * LD;
    if constexpr (PRE)
      if (u == 0) split_rows<KS, LD, THREADS>(sq, sqlo, 2 * ROWS);
    split_rows<KS, LD, THREADS>(kt, kvlo, 2 * KEYS);
    __syncthreads();
    const float* vt = kt + KEYS * LD;
    const float* vlo = kvlo + KEYS * LD;
    const bool second = u >= tiles_k;
    const int k0 = (second ? u - tiles_k : u) * KEYS;

    if (!idle) {
      // S = Q K^T with the small terms apart and dP = dO V^T; the B
      // fragment of n-tile j is keys 8 j + g8 at columns 8 kk + t4 and + 4
      float sc[NT][4], small[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = small[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K8; ++kk) {
        uint32_t qhi[4], qlo[4], ohi[4], olo[4];
        load_a<PRE>(sq, sqlo, ao + 8 * kk, LD, qhi, qlo);
        load_a<PRE>(sdo, sdolo, ao + 8 * kk, LD, ohi, olo);
        const int bo = g8 * LD + 8 * kk + t4;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bhi[2], blo[2];
          load_b<true>(kt, kvlo, bo + 8 * j * LD, bo + 8 * j * LD + 4, bhi,
                       blo);
          mma3_apart_t(sc[j], small[j], qhi, qlo, bhi, blo);
          load_b<true>(vt, vlo, bo + 8 * j * LD, bo + 8 * j * LD + 4, bhi,
                       blo);
          mma3_t(dp[j], ohi, olo, bhi, blo);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = (sc[j][e] + small[j][e]) * p.scale;
      mask_keys(sc, k0, p.nk, t4);

      if (!second) {
        // the online max, l and c of this lane's rows
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m_run[i], mx[i]);  // finite: k0 < Nk
          const float alpha = expf(m_run[i] - m_new);
          m_run[i] = m_new;
          l_run[i] *= alpha;
          c_run[i] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = expf(sc[j][e] - m_run[e / 2]);
            l_run[e / 2] += x;
            c_run[e / 2] = fmaf(x, dp[j][e], c_run[e / 2]);
          }
      } else {
        // dl = w (dP - delta), w = exp(S - lse); then dQ += dl K, the
        // tile's product formed alone: A columns t4 and t4 + 4 of k-step j
        // are keys 8 j + 2 t4 and + 1, and K's B fragment reads their rows
        float acc[K8][4];
#pragma unroll
        for (int n = 0; n < K8; ++n)
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float dl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dl[e] = expf(sc[j][e] - lse[e / 2]) * (dp[j][e] - delta[e / 2]);
          uint32_t ahi[4], alo[4];
          split_tf32(dl[0], ahi[0], alo[0]);  // row g8, key 2 t4
          split_tf32(dl[2], ahi[1], alo[1]);  // row g8 + 8
          split_tf32(dl[1], ahi[2], alo[2]);  // key 2 t4 + 1
          split_tf32(dl[3], ahi[3], alo[3]);
          const int o = (8 * j + 2 * t4) * LD + g8;
#pragma unroll
          for (int n = 0; n < K8; ++n) {
            uint32_t bhi[2], blo[2];
            load_b<true>(kt, kvlo, o + 8 * n, o + LD + 8 * n, bhi, blo);
            mma3(acc[n], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int n = 0; n < K8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] += acc[n][e];
      }
    }

    if (u == tiles_k - 1 && !idle) {
      // the end of sweep 1: the rows' LSE and delta, kept and written
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
        l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
        c_run[i] += __shfl_xor_sync(0xffffffffu, c_run[i], 1);
        c_run[i] += __shfl_xor_sync(0xffffffffu, c_run[i], 2);
        lse[i] = m_run[i] + logf(l_run[i]);
        delta[i] = c_run[i] / l_run[i];
        const int row = warp * 16 + g8 + 8 * i;
        if (t4 == 0 && row < rows) {
          const long long o = (long long)grp * p.nq + row0 + row;
          p.lse[o] = lse[i];
          p.delta[o] = delta[i];
        }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (u + 2 < 2 * tiles_k) fetch(u + 2);
    cp_commit();  // an empty group keeps the wait count uniform
  }

  // dQ scaled once, here, in q's layout
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g8 + 8 * i;
    if (row >= rows) continue;
    const long long o = qoff + (long long)row * p.row;
#pragma unroll
    for (int n = 0; n < K8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t4 + e;
        if (c < d) p.dq[o + c] = dq[n][2 * i + e] * p.scale;
      }
  }
}

// ----------------------------------------------------------------------
// The bf16 query pass
// ----------------------------------------------------------------------

// dynamic shared memory of one bf16 query-pass block: Q and dO, and two
// ring stages of K and V, all bf16 rows of 16 ks + 8
constexpr size_t smem_bytes_dq_bf16(int ks) {
  return sizeof(bf16) * (16 * ks + 8) * (2 * kDqRows + 4 * kDqKeys);
}

// The f32 pass's grid and sweeps with bf16 Q, dO, K and V; 3 blocks an SM
// at spans up to 32, as the f32 pass
template <int KS>
__global__ void __launch_bounds__(32 * kDqWarps, KS <= 2 ? 3 : 1)
    attention_bwd_dq_bf16_kernel(BwdParamsOf<bf16> p) {
  constexpr int THREADS = 32 * kDqWarps, ROWS = kDqRows, KEYS = kDqKeys;
  constexpr int LD = 16 * KS + 8;   // bf16: an odd multiple of 16 bytes
  constexpr int ND = 2 * KS;        // dQ's n-tiles of 8 columns
  constexpr int NT = KEYS / 8;      // n-tiles of 8 keys
  constexpr int KQ = KEYS / 16;     // k-steps of 16 keys (dQ's product)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* sdo = sq + ROWS * LD;                    // [ROWS][LD]
  bf16* ring = sdo + ROWS * LD;  // [2][2 KEYS][LD]: K, then V

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int tile = blockIdx.x % p.q_tiles;
  const int grp = blockIdx.x / p.q_tiles;
  const int row0 = tile * ROWS;
  const int rows = min(ROWS, p.nq - row0);
  const int d = p.d;
  // the head's element c at position sh + c (see The bf16 copies)
  const int sh = shift_of(p, grp);
  const int chunks = (sh + d + p.vec - 1) / p.vec;
  int cshift = 0;
  while ((1 << cshift) < chunks) ++cshift;
  const bool ragged = sh != 0 || sh + d != 16 * KS;
  const long long qoff = bwd_base(p, grp, p.nq) + (long long)row0 * p.row;
  const long long kvoff = bwd_base(p, grp, p.nk) - sh;
  const int tiles_k = (p.nk + KEYS - 1) / KEYS;

  // tiles u of the two sweeps: key tile u mod tiles_k, ring stage u & 1
  auto fetch = [&](int u) {
    bf16* st = ring + (u & 1) * 2 * KEYS * LD;
    const int k0 = (u < tiles_k ? u : u - tiles_k) * KEYS;
    const int valid = min(KEYS, p.nk - k0);
    const long long o = kvoff + (long long)k0 * p.row;
    copy_rows<LD, KEYS, THREADS>(st, p.k + o, p.row, valid, chunks, cshift,
                                 p.vec, d, p.k);
    copy_rows<LD, KEYS, THREADS>(st + KEYS * LD, p.v + o, p.row, valid,
                                 chunks, cshift, p.vec, d, p.v);
  };

  // prologue: Q and dO with tile 0, then tile 1
  copy_rows<LD, ROWS, THREADS>(sq, p.q + qoff - sh, p.row, rows, chunks,
                               cshift, p.vec, d, p.q);
  copy_rows<LD, ROWS, THREADS>(sdo, p.dout + qoff - sh, p.row, rows, chunks,
                               cshift, p.vec, d, p.dout);
  fetch(0);
  cp_commit();
  fetch(1);  // two sweeps: at least two tiles
  cp_commit();

  const bool idle = warp * 16 >= rows;  // a ragged last query tile
  // this lane's ldmatrix row of the warp's Q and dO A fragments
  const int qa = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  // rows g8 and g8 + 8: the running max, this lane's shares of l and c;
  // after sweep 1 the LSE and delta
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f}, c_run[2] = {0.f, 0.f};
  float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};

  for (int u = 0; u < 2 * tiles_k; ++u) {
    cp_wait<1>();  // tile u has landed (u + 1 may be in flight)
    __syncthreads();
    const bf16* kt = ring + (u & 1) * 2 * KEYS * LD;
    const bf16* vt = kt + KEYS * LD;
    const bool second = u >= tiles_k;
    const int k0 = (second ? u - tiles_k : u) * KEYS;

    if (!idle) {
      // S = Q K^T and dP = dO V^T: bf16 mma.sync m16n8k16, Q or dO the A
      // operand; the B fragments of n-tiles 2 np and 2 np + 1 are keys
      // 16 np + 0-15 at columns 16 kk + 0-15 (ldmatrix, as the forward
      // reads K); positions outside [sh, sh + D) zeroed in every fragment
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[4], of[4];
        ldmatrix_x4(qf, sq + qa + 16 * kk);
        ldmatrix_x4(of, sdo + qa + 16 * kk);
        uint32_t lo = 0xffffffffu, hi = 0xffffffffu;
        if (ragged) {
          lo = pair_mask(16 * kk + 2 * t4, sh, d);
          hi = pair_mask(16 * kk + 8 + 2 * t4, sh, d);
          mask_a(qf, lo, hi);
          mask_a(of, lo, hi);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int bo = (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         16 * kk + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldmatrix_x4(b, kt + bo);
          mma(sc[2 * np], qf, b[0] & lo, b[1] & hi);
          mma(sc[2 * np + 1], qf, b[2] & lo, b[3] & hi);
          ldmatrix_x4(b, vt + bo);
          mma(dp[2 * np], of, b[0] & lo, b[1] & hi);
          mma(dp[2 * np + 1], of, b[2] & lo, b[3] & hi);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= p.scale;
      mask_keys(sc, k0, p.nk, t4);

      if (!second) {
        // the online max, l and c of this lane's rows
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
          mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
          const float m_new = fmaxf(m_run[i], mx[i]);  // finite: k0 < Nk
          const float alpha = expf(m_run[i] - m_new);
          m_run[i] = m_new;
          l_run[i] *= alpha;
          c_run[i] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = expf(sc[j][e] - m_run[e / 2]);
            l_run[e / 2] += x;
            c_run[e / 2] = fmaf(x, dp[j][e], c_run[e / 2]);
          }
      } else {
        // dl = w (dP - delta), w = exp(S - lse), in place of dP; then
        // dQ += dl K: n-tiles 2 kk and 2 kk + 1 of dl are the k16 A
        // fragment of keys 16 kk + 0-15, split into bf16 hi + lo; K the B
        // operand (ldmatrix .trans: the keys are the k dimension), the
        // tile's product formed alone and added in f32
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = expf(sc[j][e] - lse[e / 2]) * (dp[j][e] - delta[e / 2]);
        uint32_t hi[KQ][4], lo[KQ][4];
        a_split_bf16<NT>(dp, hi, lo);
        add_tile_product<ND, KQ, LD>(dq, hi, lo, kt, 0, lane);
      }
    }

    if (u == tiles_k - 1 && !idle) {
      // the end of sweep 1: the rows' LSE and delta, kept and written
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
        l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
        c_run[i] += __shfl_xor_sync(0xffffffffu, c_run[i], 1);
        c_run[i] += __shfl_xor_sync(0xffffffffu, c_run[i], 2);
        lse[i] = m_run[i] + logf(l_run[i]);
        delta[i] = c_run[i] / l_run[i];
        const int row = warp * 16 + g8 + 8 * i;
        if (t4 == 0 && row < rows) {
          const long long o = (long long)grp * p.nq + row0 + row;
          p.lse[o] = lse[i];
          p.delta[o] = delta[i];
        }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (u + 2 < 2 * tiles_k) fetch(u + 2);
    cp_commit();  // an empty group keeps the wait count uniform
  }

  // dQ scaled once and rounded to bf16, in q's layout (position sh + c
  // is column c)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g8 + 8 * i;
    if (row >= rows) continue;
    const long long o = qoff + (long long)row * p.row;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t4 + e - sh;
        if (c >= 0 && c < d) store(p.dq + o + c, dq[n][2 * i + e] * p.scale);
      }
  }
}

// ----------------------------------------------------------------------
// The query pass with the bias
// ----------------------------------------------------------------------

constexpr int kDqrKeys = 32;            // keys per tile
constexpr int kDqrSld = kDqrKeys + 8;   // s tile row stride (8 mod 32: both
                                        // of its B fragments hit 32 banks)

// Warps a block (16 query rows each): 8 where the tiles fit in shared
// memory at the m-tile bucket's widest bias (smem_bytes_dqr), else 4; K
// and V split once a tile up to spans of 96.
template <int KS, int MT>
struct DqrShape {
  static constexpr int WARPS = KS <= 4 || (KS == 6 && MT <= 7) ? 8 : 4;
  static constexpr bool PRE = KS <= kF32WideSteps;
};

// dynamic shared memory of one block: Q, dO and the R rows, two ring
// stages of K, V and the s tile, and (pre) K's and V's lo parts
inline size_t smem_bytes_dqr(int ks, int m, int warps, bool pre) {
  const size_t ld = 16 * ks + 4, rows = 16 * warps;
  const size_t rs = m ? r_stride(m) : 0, m8 = round8(m);
  return sizeof(float) * (rows * (2 * ld + rs) +
                          2 * (2 * kDqrKeys * ld + m8 * kDqrSld) +
                          (pre ? 2 * kDqrKeys * ld : 0));
}

template <int KS, int MT>
__global__ void __launch_bounds__(32 * DqrShape<KS, MT>::WARPS, 1)
    attention_bwd_dq_lowrank_f32_kernel(BwdParams p) {
  constexpr bool BIAS = MT > 0;
  constexpr int WARPS = DqrShape<KS, MT>::WARPS;
  constexpr bool PRE = DqrShape<KS, MT>::PRE;
  constexpr int THREADS = 32 * WARPS, ROWS = 16 * WARPS, KEYS = kDqrKeys;
  constexpr int LD = 16 * KS + 4, SLD = kDqrSld;
  constexpr int K8 = 2 * KS;    // k-steps of 8 over the span, and dQ's
                                // n-tiles of 8 columns
  constexpr int NT = KEYS / 8;  // n-tiles of 8 keys
  constexpr int NM = BIAS ? MT : 1;  // dR's n-tiles of 8 factor columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m8 = BIAS ? round8(p.m) : 0;
  const int rs = BIAS ? r_stride(p.m) : 0;
  float* sq = reinterpret_cast<float*>(smem_raw);  // [ROWS][LD]
  float* sdo = sq + ROWS * LD;                     // [ROWS][LD]
  float* sr = sdo + ROWS * LD;                     // [ROWS][rs]
  float* ring = sr + ROWS * rs;                    // [2][stage]
  // a stage: K [KEYS][LD], V [KEYS][LD], the s tile [m8][SLD]
  const int stage = 2 * KEYS * LD + m8 * SLD;
  float* kvlo = ring + 2 * stage;  // (pre) [2 KEYS][LD]: K's and V's lo

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int tile = blockIdx.x % p.q_tiles;
  const int grp = blockIdx.x / p.q_tiles;
  const int row0 = tile * ROWS;
  const int rows = min(ROWS, p.nq - row0);
  const int d = p.d;  // a multiple of the copy width
  const int chunks = d / p.vec;
  int cshift = 0;
  while ((1 << cshift) < chunks) ++cshift;
  const long long qoff = bwd_base(p, grp, p.nq) + (long long)row0 * p.row;
  const long long kvoff = bwd_base(p, grp, p.nk);
  const int tiles_k = (p.nk + KEYS - 1) / KEYS;

  // the copies fill columns [0, D) of each row; the span's columns past D
  // are zeroed once (Q and dO, adjacent, and both stages' K and V), so the
  // padded products add nothing
  if (d < 16 * KS) {
    const int pad = 16 * KS - d;
    for (int i = threadIdx.x; i < 2 * ROWS * pad; i += THREADS)
      sq[(i / pad) * LD + d + i % pad] = 0.f;
    for (int i = threadIdx.x; i < 4 * KEYS * pad; i += THREADS) {
      const int row = i / pad;  // stage row / (2 KEYS), K and V adjacent
      ring[(row / (2 * KEYS)) * stage + (row % (2 * KEYS)) * LD + d +
           i % pad] = 0.f;
    }
  }

  // key tile t into ring stage t & 1: its K and V rows and s columns
  // (keys past Nk and factor rows past M zero-filled)
  auto fetch = [&](int t) {
    float* st = ring + (t & 1) * stage;
    const int k0 = t * KEYS;
    const int valid = min(KEYS, p.nk - k0);
    const long long o = kvoff + (long long)k0 * p.row;
    copy_rows<LD, KEYS, THREADS>(st, p.k + o, p.row, valid, chunks, cshift,
                                 p.vec, p.k);
    copy_rows<LD, KEYS, THREADS>(st + KEYS * LD, p.v + o, p.row, valid,
                                 chunks, cshift, p.vec, p.v);
    if constexpr (BIAS)
      copy_s<KEYS, SLD, THREADS>(st + 2 * KEYS * LD, p.s, p.m, m8, p.nk, k0,
                                 p.vec_s);
  };

  // prologue: Q, dO and the R rows with tile 0, then tile 1
  copy_rows<LD, ROWS, THREADS>(sq, p.q + qoff, p.row, rows, chunks, cshift,
                               p.vec, p.q);
  copy_rows<LD, ROWS, THREADS>(sdo, p.dout + qoff, p.row, rows, chunks,
                               cshift, p.vec, p.dout);
  if constexpr (BIAS)
    copy_r<ROWS, THREADS>(sr, p.r, grp, p.nq, row0, rows, p.m, rs);
  fetch(0);
  cp_commit();
  if (tiles_k > 1) fetch(1);
  cp_commit();

  const bool idle = warp * 16 >= rows;  // a ragged last query tile
  const int ao = (warp * 16 + g8) * LD + t4;  // this lane's A fragments
  const int ro = (warp * 16 + g8) * rs + t4;  // and R's
  // rows g8 and g8 + 8: the forward's LSE and delta
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g8 + 8 * i;
    const long long o = (long long)grp * p.nq + row0 + row;
    lse[i] = row < rows ? p.lse[o] : 0.f;
    delta[i] = row < rows ? p.delta[o] : 0.f;
  }
  float dq[K8][4], dr[NM][4];
#pragma unroll
  for (int n = 0; n < K8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
  for (int i = 0; i < NM; ++i) dr[i][0] = dr[i][1] = dr[i][2] = dr[i][3] = 0.f;

  for (int t = 0; t < tiles_k; ++t) {
    cp_wait<1>();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();
    const float* kt = ring + (t & 1) * stage;
    const float* vt = kt + KEYS * LD;
    const float* st = vt + KEYS * LD;
    if constexpr (PRE) {  // K and V into tf32 hi (in place) and lo
      split_rows<KS, LD, THREADS>(ring + (t & 1) * stage, kvlo, 2 * KEYS);
      __syncthreads();
    }
    const float* klo = kvlo;
    const float* vlo = kvlo + KEYS * LD;

    if (!idle) {
      // S = Q K^T with the small terms apart and dP = dO V^T; the B
      // fragment of n-tile j is keys 8 j + g8 at columns 8 kk + t4 and + 4
      float sc[NT][4], small[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = small[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < K8; ++kk) {
        uint32_t qhi[4], qlo[4], ohi[4], olo[4];
        load_a<false>(sq, nullptr, ao + 8 * kk, LD, qhi, qlo);
        load_a<false>(sdo, nullptr, ao + 8 * kk, LD, ohi, olo);
        const int bo = g8 * LD + 8 * kk + t4;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bhi[2], blo[2];
          load_b<PRE>(kt, klo, bo + 8 * j * LD, bo + 8 * j * LD + 4, bhi,
                      blo);
          mma3_apart_t(sc[j], small[j], qhi, qlo, bhi, blo);
          load_b<PRE>(vt, vlo, bo + 8 * j * LD, bo + 8 * j * LD + 4, bhi,
                      blo);
          mma3_t(dp[j], ohi, olo, bhi, blo);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[j][e] = (sc[j][e] + small[j][e]) * p.scale;

      if constexpr (BIAS) {  // + r s: R S as 3xTF32 in one sum
        float (&b)[NT][4] = small;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) b[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {
          if (8 * kk >= m8) break;
          uint32_t ahi[4], alo[4];
          load_a<false>(sr, nullptr, ro + 8 * kk, rs, ahi, alo);
          // the B fragment of n-tile j: factor rows 8 kk + t4 and + 4 of
          // the s tile at key 8 j + g8
          const int so = (8 * kk + t4) * SLD + g8;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t bhi[2], blo[2];
            load_b<false>(st, nullptr, so + 8 * j, so + 8 * j + 4 * SLD, bhi,
                          blo);
            mma3_t(b[j], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += b[j][e];
      }
      mask_keys(sc, t * KEYS, p.nk, t4);

      // dl = w (dP - delta), w = exp(S - lse), split as the A fragment of
      // k-step j: A columns t4 and t4 + 4 are keys 8 j + 2 t4 and + 1
      uint32_t ahi[NT][4], alo[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float dl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dl[e] = expf(sc[j][e] - lse[e / 2]) * (dp[j][e] - delta[e / 2]);
        split_tf32(dl[0], ahi[j][0], alo[j][0]);  // row g8, key 2 t4
        split_tf32(dl[2], ahi[j][1], alo[j][1]);  // row g8 + 8
        split_tf32(dl[1], ahi[j][2], alo[j][2]);  // key 2 t4 + 1
        split_tf32(dl[3], ahi[j][3], alo[j][3]);
      }

      // dQ += dl K, the tile's product formed alone: K's B fragment reads
      // keys 8 j + 2 t4 and + 1 at column 8 n + g8
      const int ko = 2 * t4 * LD + g8;
#pragma unroll
      for (int n = 0; n < K8; ++n) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bhi[2], blo[2];
          const int o = ko + 8 * j * LD + 8 * n;
          load_b<PRE>(kt, klo, o, o + LD, bhi, blo);
          mma3(acc, ahi[j], alo[j], bhi, blo);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] += acc[e];
      }

      // dR += dl s^T: the B fragment of n-tile i is factor row 8 i + g8 of
      // the s tile at keys 8 j + 2 t4 and + 1, adjacent
      if constexpr (BIAS) {
        const int so = g8 * SLD + 2 * t4;
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          if (8 * i >= m8) break;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float2 x =
                *reinterpret_cast<const float2*>(st + so + 8 * i * SLD + 8 * j);
            uint32_t bhi[2], blo[2];
            split_tf32(x.x, bhi[0], blo[0]);
            split_tf32(x.y, bhi[1], blo[1]);
            mma3(acc, ahi[j], alo[j], bhi, blo);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) dr[i][e] += acc[e];
        }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (t + 2 < tiles_k) fetch(t + 2);
    cp_commit();  // an empty group keeps the wait count uniform
  }

  // dQ scaled once, in q's layout; dR as summed, (BH, Nq, M)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g8 + 8 * i;
    if (row >= rows) continue;
    const long long o = qoff + (long long)row * p.row;
#pragma unroll
    for (int n = 0; n < K8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t4 + e;
        if (c < d) p.dq[o + c] = dq[n][2 * i + e] * p.scale;
      }
    if constexpr (BIAS) {
      const long long dro = ((long long)grp * p.nq + row0 + row) * p.m;
#pragma unroll
      for (int n = 0; n < NM; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t4 + e;
          if (c < p.m) p.dr[dro + c] = dr[n][2 * i + e];
        }
    }
  }
}

// ----------------------------------------------------------------------
// The bf16 query pass with the bias
// ----------------------------------------------------------------------

// Warps a block (16 query rows each): 8 at every bucket, whose widest
// bias fits (212,992 bytes at D = 128, M = 128; the launcher asserts it)
constexpr int kDqrBf16Warps = 8;

// dynamic shared memory of one bf16 query-pass block: Q and dO (bf16 rows
// of 16 ks + 8), the R rows, and two ring stages of K and V (bf16) and
// the s tile
constexpr size_t smem_bytes_dqr_bf16(int ks, int m) {
  return sizeof(bf16) * 2 * (16 * kDqrBf16Warps) * (16 * ks + 8) +
         sizeof(float) * (16 * kDqrBf16Warps) * (m ? r_stride(m) : 0) +
         2 * (sizeof(bf16) * 2 * kDqrKeys * (16 * ks + 8) +
              sizeof(float) * round8(m) * kDqrSld);
}

template <int KS, int MT>
__global__ void __launch_bounds__(32 * kDqrBf16Warps, 1)
    attention_bwd_dq_lowrank_bf16_kernel(BwdParamsOf<bf16> p) {
  constexpr bool BIAS = MT > 0;
  constexpr int WARPS = kDqrBf16Warps;
  constexpr int THREADS = 32 * WARPS, ROWS = 16 * WARPS, KEYS = kDqrKeys;
  constexpr int LD = 16 * KS + 8;   // bf16: an odd multiple of 16 bytes
  constexpr int SLD = kDqrSld;
  constexpr int ND = 2 * KS;        // dQ's n-tiles of 8 columns
  constexpr int NT = KEYS / 8;      // n-tiles of 8 keys
  constexpr int KQ = KEYS / 16;     // k-steps of 16 keys (dQ's product)
  constexpr int NM = BIAS ? MT : 1;  // dR's n-tiles of 8 factor columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m8 = BIAS ? round8(p.m) : 0;
  const int rs = BIAS ? r_stride(p.m) : 0;
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);           // [ROWS][LD]
  bf16* sdo = sq + ROWS * LD;                             // [ROWS][LD]
  float* sr = reinterpret_cast<float*>(sdo + ROWS * LD);  // [ROWS][rs]
  unsigned char* ring = reinterpret_cast<unsigned char*>(sr + ROWS * rs);
  // a stage: K [KEYS][LD] and V [KEYS][LD] bf16, then the s tile
  // [m8][SLD] f32
  const int stage =
      (int)(sizeof(bf16) * 2 * KEYS * LD + sizeof(float) * m8 * SLD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int tile = blockIdx.x % p.q_tiles;
  const int grp = blockIdx.x / p.q_tiles;
  const int row0 = tile * ROWS;
  const int rows = min(ROWS, p.nq - row0);
  const int d = p.d;  // a multiple of the copy width
  const int chunks = d / p.vec;
  int cshift = 0;
  while ((1 << cshift) < chunks) ++cshift;
  const long long qoff = bwd_base(p, grp, p.nq) + (long long)row0 * p.row;
  const long long kvoff = bwd_base(p, grp, p.nk);
  const int tiles_k = (p.nk + KEYS - 1) / KEYS;

  // the copies fill columns [0, D) of each row; the span's columns past D
  // are zeroed once (Q and dO, adjacent, and both stages' K and V), so the
  // padded products add nothing
  if (d < 16 * KS) {
    const int pad = 16 * KS - d;
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < 2 * ROWS * pad; i += THREADS)
      sq[(i / pad) * LD + d + i % pad] = zero;
    for (int i = threadIdx.x; i < 4 * KEYS * pad; i += THREADS) {
      const int row = i / pad;  // stage row / (2 KEYS), K and V adjacent
      reinterpret_cast<bf16*>(ring + (row / (2 * KEYS)) * stage)
          [(row % (2 * KEYS)) * LD + d + i % pad] = zero;
    }
  }

  // key tile t into ring stage t & 1: its K and V rows and s columns
  // (keys past Nk and factor rows past M zero-filled)
  auto fetch = [&](int t) {
    bf16* st = reinterpret_cast<bf16*>(ring + (t & 1) * stage);
    const int k0 = t * KEYS;
    const int valid = min(KEYS, p.nk - k0);
    const long long o = kvoff + (long long)k0 * p.row;
    copy_rows<LD, KEYS, THREADS>(st, p.k + o, p.row, valid, chunks, cshift,
                                 p.vec, d, p.k);
    copy_rows<LD, KEYS, THREADS>(st + KEYS * LD, p.v + o, p.row, valid,
                                 chunks, cshift, p.vec, d, p.v);
    if constexpr (BIAS) {
      copy_s<KEYS, SLD, THREADS>(reinterpret_cast<float*>(st + 2 * KEYS * LD),
                                 p.s, p.m, m8, p.nk, k0, p.vec_s);
    }
  };

  // prologue: Q, dO and the R rows with tile 0, then tile 1
  copy_rows<LD, ROWS, THREADS>(sq, p.q + qoff, p.row, rows, chunks, cshift,
                               p.vec, d, p.q);
  copy_rows<LD, ROWS, THREADS>(sdo, p.dout + qoff, p.row, rows, chunks,
                               cshift, p.vec, d, p.dout);
  if constexpr (BIAS) {
    copy_r<ROWS, THREADS>(sr, p.r, grp, p.nq, row0, rows, p.m, rs);
  }
  fetch(0);
  cp_commit();
  if (tiles_k > 1) fetch(1);
  cp_commit();

  const bool idle = warp * 16 >= rows;  // a ragged last query tile
  // this lane's ldmatrix row of the warp's Q and dO A fragments, and R's
  // tf32 A fragments
  const int qa = (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int ro = (warp * 16 + g8) * rs + t4;
  // rows g8 and g8 + 8: the forward's LSE and delta
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g8 + 8 * i;
    const long long o = (long long)grp * p.nq + row0 + row;
    lse[i] = row < rows ? p.lse[o] : 0.f;
    delta[i] = row < rows ? p.delta[o] : 0.f;
  }
  float dq[ND][4], dr[NM][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
  for (int i = 0; i < NM; ++i) dr[i][0] = dr[i][1] = dr[i][2] = dr[i][3] = 0.f;

  for (int t = 0; t < tiles_k; ++t) {
    cp_wait<1>();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();
    const bf16* kt = reinterpret_cast<const bf16*>(ring + (t & 1) * stage);
    const bf16* vt = kt + KEYS * LD;
    const float* st = reinterpret_cast<const float*>(vt + KEYS * LD);

    if (!idle) {
      // S = Q K^T and dP = dO V^T: bf16 mma.sync m16n8k16, Q or dO the A
      // operand; the B fragments of n-tiles 2 np and 2 np + 1 are keys
      // 16 np + 0-15 at columns 16 kk + 0-15 (ldmatrix, as the forward
      // reads K)
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qf[4], of[4];
        ldmatrix_x4(qf, sq + qa + 16 * kk);
        ldmatrix_x4(of, sdo + qa + 16 * kk);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int bo = (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         16 * kk + ((lane >> 3) & 1) * 8;
          uint32_t b[4];
          ldmatrix_x4(b, kt + bo);
          mma(sc[2 * np], qf, b[0], b[1]);
          mma(sc[2 * np + 1], qf, b[2], b[3]);
          ldmatrix_x4(b, vt + bo);
          mma(dp[2 * np], of, b[0], b[1]);
          mma(dp[2 * np + 1], of, b[2], b[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= p.scale;

      if constexpr (BIAS) {  // + r s: R S as 3xTF32 in one sum, as the f32
                             // pass forms it
        float b[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) b[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < MT; ++kk) {
          if (8 * kk >= m8) break;
          uint32_t ahi[4], alo[4];
          load_a<false>(sr, nullptr, ro + 8 * kk, rs, ahi, alo);
          // the B fragment of n-tile j: factor rows 8 kk + t4 and + 4 of
          // the s tile at key 8 j + g8
          const int so = (8 * kk + t4) * SLD + g8;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            uint32_t bhi[2], blo[2];
            load_b<false>(st, nullptr, so + 8 * j, so + 8 * j + 4 * SLD, bhi,
                          blo);
            mma3_t(b[j], ahi, alo, bhi, blo);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += b[j][e];
      }
      mask_keys(sc, t * KEYS, p.nk, t4);

      // dl = w (dP - delta), w = exp(S - lse), in place of dP
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[j][e] = expf(sc[j][e] - lse[e / 2]) * (dp[j][e] - delta[e / 2]);
      const float (&dl)[NT][4] = dp;

      // dQ += dl K: n-tiles 2 kk and 2 kk + 1 of dl are the k16 A fragment
      // of keys 16 kk + 0-15, split into bf16 hi + lo; K the B operand
      // (ldmatrix .trans: the keys are the k dimension), the tile's product
      // formed alone and added in f32
      {
        uint32_t hi[KQ][4], lo[KQ][4];
        a_split_bf16<NT>(dl, hi, lo);
        add_tile_product<ND, KQ, LD>(dq, hi, lo, kt, 0, lane);
      }

      // dR += dl s^T, 3xTF32 as in the f32 pass: A columns t4 and t4 + 4
      // of k-step j are keys 8 j + 2 t4 and + 1; the B fragment of n-tile
      // i is factor row 8 i + g8 of the s tile at those keys, adjacent
      if constexpr (BIAS) {
        uint32_t ahi[NT][4], alo[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split_tf32(dl[j][0], ahi[j][0], alo[j][0]);  // row g8, key 2 t4
          split_tf32(dl[j][2], ahi[j][1], alo[j][1]);  // row g8 + 8
          split_tf32(dl[j][1], ahi[j][2], alo[j][2]);  // key 2 t4 + 1
          split_tf32(dl[j][3], ahi[j][3], alo[j][3]);
        }
        const int so = g8 * SLD + 2 * t4;
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          if (8 * i >= m8) break;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float2 x =
                *reinterpret_cast<const float2*>(st + so + 8 * i * SLD + 8 * j);
            uint32_t bhi[2], blo[2];
            split_tf32(x.x, bhi[0], blo[0]);
            split_tf32(x.y, bhi[1], blo[1]);
            mma3(acc, ahi[j], alo[j], bhi, blo);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) dr[i][e] += acc[e];
        }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (t + 2 < tiles_k) fetch(t + 2);
    cp_commit();  // an empty group keeps the wait count uniform
  }

  // dQ scaled once and rounded to bf16, in q's layout; dR as summed,
  // (BH, Nq, M)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g8 + 8 * i;
    if (row >= rows) continue;
    const long long o = qoff + (long long)row * p.row;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t4 + e;
        if (c < d) store(p.dq + o + c, dq[n][2 * i + e] * p.scale);
      }
    if constexpr (BIAS) {
      const long long dro = ((long long)grp * p.nq + row0 + row) * p.m;
#pragma unroll
      for (int n = 0; n < NM; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t4 + e;
          if (c < p.m) p.dr[dro + c] = dr[n][2 * i + e];
        }
    }
  }
}

// ----------------------------------------------------------------------
// Launchers
// ----------------------------------------------------------------------

template <int KS, int MT>
int launch_bwd_dkv_f32_steps(BwdParams p, cudaStream_t stream) {
  constexpr int KEYS = BwdShape<KS, MT>::KEYS;
  const size_t smem =
      smem_bytes_bwd(KS, MT ? p.m : 0, KEYS, BwdShape<KS, MT>::PRE);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dkv_f32_kernel<KS, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  p.key_blocks = (p.nk + KEYS - 1) / KEYS;
  p.q_tiles = (p.nq + kBwdRows - 1) / kBwdRows;
  const long long blocks = (long long)p.bh * p.key_blocks * p.splits;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  attention_bwd_dkv_f32_kernel<KS, MT>
      <<<(unsigned)blocks, 32 * kBwdWarps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KS, int MT, int STAGES, bool K2 = false>
int launch_bwd_dkv_bf16_steps(BwdParamsOf<bf16> p, cudaStream_t stream) {
  constexpr int KEYS = BwdShape<KS, MT>::KEYS;
  const size_t smem = smem_bytes_bwd_bf16(KS, MT ? p.m : 0, KEYS, STAGES);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dkv_bf16_kernel<KS, MT, STAGES, K2>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  p.key_blocks = (p.nk + KEYS - 1) / KEYS;
  p.q_tiles = (p.nq + kBwdRows - 1) / kBwdRows;
  const long long blocks = (long long)p.bh * p.key_blocks * p.splits;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  attention_bwd_dkv_bf16_kernel<KS, MT, STAGES, K2>
      <<<(unsigned)blocks, 32 * kBwdWarps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_bwd_dq_f32_steps(BwdParams p, cudaStream_t stream) {
  const size_t smem = smem_bytes_dq(KS, DqShape<KS>::PRE);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_f32_kernel<KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  p.q_tiles = (p.nq + kDqRows - 1) / kDqRows;
  const long long blocks = (long long)p.bh * p.q_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  attention_bwd_dq_f32_kernel<KS>
      <<<(unsigned)blocks, 32 * kDqWarps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KS>
int launch_bwd_dq_bf16_steps(BwdParamsOf<bf16> p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_dq_bf16(KS);
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_bf16_kernel<KS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  p.q_tiles = (p.nq + kDqRows - 1) / kDqRows;
  const long long blocks = (long long)p.bh * p.q_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  attention_bwd_dq_bf16_kernel<KS>
      <<<(unsigned)blocks, 32 * kDqWarps, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int KS, int MT>
int launch_bwd_dq_lowrank_f32_steps(BwdParams p, cudaStream_t stream) {
  constexpr int WARPS = DqrShape<KS, MT>::WARPS;
  const size_t smem =
      smem_bytes_dqr(KS, MT ? p.m : 0, WARPS, DqrShape<KS, MT>::PRE);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_lowrank_f32_kernel<KS, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  p.vec_s = MT && p.nk % 4 == 0 && aligned(p.s, 16) ? 4 : 1;
  p.q_tiles = (p.nq + 16 * WARPS - 1) / (16 * WARPS);
  const long long blocks = (long long)p.bh * p.q_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  attention_bwd_dq_lowrank_f32_kernel<KS, MT>
      <<<(unsigned)blocks, 32 * WARPS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// f.template run<KS, MT>() for the instantiation that takes head dim d
// (spans of 1, 2, 4, 6 or 8 k-steps of 16) and m factor columns
template <int KS, typename F>
int with_bwd_m_tiles(int m, const F& f) {
  switch (bwd_m_tiles(m)) {
    case 0: return f.template run<KS, 0>();
    case 2: return f.template run<KS, 2>();
    case 5: return f.template run<KS, 5>();
    case 7: return f.template run<KS, 7>();
    default: return f.template run<KS, 16>();
  }
}

template <typename F>
int with_bwd_shape(int d, int m, const F& f) {
  if (d <= 16) return with_bwd_m_tiles<1>(m, f);
  switch ((d + 31) / 32) {
    case 1: return with_bwd_m_tiles<2>(m, f);
    case 2: return with_bwd_m_tiles<4>(m, f);
    case 3: return with_bwd_m_tiles<6>(m, f);
    default: return with_bwd_m_tiles<8>(m, f);
  }
}

inline bool bwd_sizes_ok(int d, int m) {
  return d > 0 && d <= 16 * kMaxSteps && m >= 0 && m <= kMaxRank;
}

// Keys per block of the dK/dV/dS kernels (f32 and bf16) at head dim d and
// m factor columns (BwdShape's KEYS: 128, or 64 where two warps share a
// strip), 0 for sizes the launchers refuse.
struct BwdKeys {
  template <int KS, int MT>
  int run() const { return BwdShape<KS, MT>::KEYS; }
};

inline int bwd_dkv_keys(int d, int m) {
  return bwd_sizes_ok(d, m) ? with_bwd_shape(d, m, BwdKeys{}) : 0;
}

struct BwdLaunch {
  const BwdParams& p;
  cudaStream_t stream;
  template <int KS, int MT>
  int run() const { return launch_bwd_dkv_f32_steps<KS, MT>(p, stream); }
};

// The sizes (D <= 128, M <= kMaxRank, else cudaErrorInvalidValue), the
// copy width (the widest of 16, 8 or 4 bytes, or one element, that divides
// D, the row stride and the base addresses: f32 4, 2 or 1 elements, bf16
// 8, 4, 2 or 1) and the scale of every launcher but K2's bf16 one
// (bwd_pick_copy)
template <typename T>
inline int bwd_prepare(BwdParamsOf<T>& p) {
  if (!bwd_sizes_ok(p.d, p.m)) return (int)cudaErrorInvalidValue;
  p.vec = 1;
  for (int vec = 16 / (int)sizeof(T); vec > 1; vec /= 2)
    if (p.d % vec == 0 && p.row % vec == 0 &&
        aligned(p.q, (int)sizeof(T) * vec) &&
        aligned(p.k, (int)sizeof(T) * vec) &&
        aligned(p.v, (int)sizeof(T) * vec) &&
        aligned(p.dout, (int)sizeof(T) * vec)) {
      p.vec = vec;
      break;
    }
  p.scale = (float)(1.0 / std::sqrt((double)p.d));  // 1.0 / math.sqrt(d)
  return 0;
}

// The launchers below are templates (Params is BwdParams but where said),
// so that a source builds the kernels of the launcher it calls and no
// others.

// The f32 dK/dV/dS launcher (K4: 25 kernels); 1 <= splits <= ceil(Nq /
// 32) (the caller's check). Returns a cudaError_t.
template <typename Params>
int launch_bwd_dkv_f32(Params p, cudaStream_t stream) {
  const int err = bwd_prepare(p);
  if (err != 0) return err;
  return with_bwd_shape(p.d, p.m, BwdLaunch{p, stream});
}

struct BwdBf16Launch {
  const BwdParamsOf<bf16>& p;
  cudaStream_t stream;
  template <int KS, int MT>
  int run() const {
    return launch_bwd_dkv_bf16_steps<KS, MT, kBwdBf16Stages>(p, stream);
  }
};

// The bf16 dK/dV/dS launcher (K4: 25 kernels; Params is
// BwdParamsOf<bf16>); 1 <= splits <= ceil(Nq / 32) (the caller's check).
// Returns a cudaError_t.
template <typename Params>
int launch_bwd_dkv_bf16(Params p, cudaStream_t stream) {
  const int err = bwd_prepare(p);
  if (err != 0) return err;
  return with_bwd_shape(p.d, p.m, BwdBf16Launch{p, stream});
}

struct DqrLaunch {
  const BwdParams& p;
  cudaStream_t stream;
  template <int KS, int MT>
  int run() const {
    return launch_bwd_dq_lowrank_f32_steps<KS, MT>(p, stream);
  }
};

// The f32 dQ/dR launcher (K4: 25 kernels), the query pass with the bias:
// dQ into p.dq, dR into p.dr, from the LSE and delta at p.lse and
// p.delta. Returns a cudaError_t.
template <typename Params>
int launch_bwd_dq_lowrank_f32(Params p, cudaStream_t stream) {
  const int err = bwd_prepare(p);
  if (err != 0) return err;
  return with_bwd_shape(p.d, p.m, DqrLaunch{p, stream});
}

template <int KS, int MT>
int launch_bwd_dq_lowrank_bf16_steps(BwdParamsOf<bf16> p,
                                     cudaStream_t stream) {
  constexpr int WARPS = kDqrBf16Warps;
  static_assert(smem_bytes_dqr_bf16(KS, 8 * MT) <= kMaxSharedBytes,
                "the m-tile bucket's widest bias does not fit");
  const size_t smem = smem_bytes_dqr_bf16(KS, MT ? p.m : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_bwd_dq_lowrank_bf16_kernel<KS, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  p.vec_s = MT && p.nk % 4 == 0 && aligned(p.s, 16) ? 4 : 1;
  p.q_tiles = (p.nq + 16 * WARPS - 1) / (16 * WARPS);
  const long long blocks = (long long)p.bh * p.q_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  attention_bwd_dq_lowrank_bf16_kernel<KS, MT>
      <<<(unsigned)blocks, 32 * WARPS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

struct DqrBf16Launch {
  const BwdParamsOf<bf16>& p;
  cudaStream_t stream;
  template <int KS, int MT>
  int run() const {
    return launch_bwd_dq_lowrank_bf16_steps<KS, MT>(p, stream);
  }
};

// The bf16 dQ/dR launcher (K4: 25 kernels; Params is BwdParamsOf<bf16>),
// the bf16 query pass with the bias: dQ (bf16) into p.dq, dR into p.dr,
// from the LSE and delta at p.lse and p.delta. Returns a cudaError_t.
template <typename Params>
int launch_bwd_dq_lowrank_bf16(Params p, cudaStream_t stream) {
  const int err = bwd_prepare(p);
  if (err != 0) return err;
  return with_bwd_shape(p.d, p.m, DqrBf16Launch{p, stream});
}

// K2's two passes at a span of KS k-steps of 16, without the bias: the
// query pass (dQ, and the LSE and delta into p.lse and p.delta), then the
// dK/dV pass at one split, the gradients in place
template <int KS>
int launch_bwd_span(BwdParams p, cudaStream_t stream) {
  const int err = launch_bwd_dq_f32_steps<KS>(p, stream);
  if (err != 0) return err;
  return launch_bwd_dkv_f32_steps<KS, 0>(p, stream);
}

template <int KS>
int launch_bwd_span(BwdParamsOf<bf16> p, cudaStream_t stream) {
  const int err = launch_bwd_dq_bf16_steps<KS>(p, stream);
  if (err != 0) return err;
  return launch_bwd_dkv_bf16_steps<KS, 0, kBwdBf16Stages, true>(p, stream);
}

// K2's kernels at the span that holds `positions` (1, 2, 4, 6 or 8
// k-steps of 16; Params is BwdParams or BwdParamsOf<bf16>, prepared).
// Returns a cudaError_t.
template <typename Params>
int launch_bwd_k2(Params p, int positions, cudaStream_t stream) {
  if (positions <= 16) return launch_bwd_span<1>(p, stream);
  switch ((positions + 31) / 32) {
    case 1: return launch_bwd_span<2>(p, stream);
    case 2: return launch_bwd_span<4>(p, stream);
    case 3: return launch_bwd_span<6>(p, stream);
    default: return launch_bwd_span<8>(p, stream);
  }
}

// K2's f32 launcher (10 kernels): the f32 query pass, then the f32 dK/dV
// body without the bias; D <= 128, else cudaErrorInvalidValue. Returns a
// cudaError_t.
template <typename Params>
int launch_bwd_f32(Params p, cudaStream_t stream) {
  p.m = 0;
  const int err = bwd_prepare(p);
  if (err != 0) return err;
  return launch_bwd_k2(p, p.d, stream);
}

// The bf16 copies of K2. K2's (B, N, H, D) rows hold every head of a token
// side by side, and THAT's heads (D = 27, 15) are odd: no copy wider than
// one bf16 divides D, and cp.async cannot move one. So K2's bf16 launcher
// picks copies as K1's bf16 body does (pick_copy): the widest of 8, 4, 2
// or 1 bf16 (16, 8, 4 or 2 bytes) that divides the row stride and the
// base addresses and keeps every head's shifted span, sh + D with
// sh = h D mod the width, within 128 positions. Each row is then copied
// from h D - sh on, in aligned pieces, and the head's element c lands at
// position sh + c; the other positions hold a neighbouring head's elements
// or nothing, and both kernels zero them in every fragment of a product
// over the head dim (pair_mask) and store position sh + c as column c. A
// width of 1 (an odd row stride) copies element by element. Sets p.vec
// and p.scale and returns the widest span, or 0 where D > 128.
inline int bwd_pick_copy(BwdParamsOf<bf16>& p) {
  if (!bwd_sizes_ok(p.d, 0)) return 0;
  p.scale = (float)(1.0 / std::sqrt((double)p.d));  // 1.0 / math.sqrt(d)
  for (int vec = 8; vec >= 1; vec /= 2) {
    const int bytes = (int)sizeof(bf16) * vec;
    if (p.row % vec || !aligned(p.q, bytes) || !aligned(p.k, bytes) ||
        !aligned(p.v, bytes) || !aligned(p.dout, bytes))
      continue;
    int span = p.d;
    for (int h = 0; h < p.heads && h < vec; ++h)
      span = span > h * p.d % vec + p.d ? span : h * p.d % vec + p.d;
    if (span <= 16 * kMaxSteps) {
      p.vec = vec;
      return span;
    }
  }
  return 0;
}

// K2's bf16 launcher (10 kernels; Params is BwdParamsOf<bf16>): the bf16
// query pass, then the bf16 dK/dV body in K2's form, both with the copies
// above; D <= 128, else cudaErrorInvalidValue. Returns a cudaError_t.
template <typename Params>
int launch_bwd_bf16(Params p, cudaStream_t stream) {
  p.m = 0;
  const int span = bwd_pick_copy(p);
  if (span == 0) return (int)cudaErrorInvalidValue;
  return launch_bwd_k2(p, span, stream);
}

}  // namespace tc
