// The tensor-core backward bodies of the attention at f32 precision, for
// Hopper (sm_90a), every product as 3xTF32 on mma.sync m16n8k8:
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
//     flash_attention_bwd.cu's dtype 0. See "The query pass" below.
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
// bias and dS: 4 M); the bytes (q, k, v, dO, r, s, lse, delta once, the
// gradients once) are tens of MB, under 0.1 ms. So it is bound by
// operations: at f32 precision every product is three TF32 products
// (3xTF32) on the tensor cores, whose dense peak is 495 TFLOP/s, or one
// f32 FMA on the CUDA cores (67 TFLOP/s).
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
// The bias (K4's dQ/dR) would add r.s to S and take the forward's LSE and
// delta in place of sweep 1; it is not instantiated.

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

struct BwdParams {
  const float* q;      // Nq rows a group (see Layout)
  const float* k;      // Nk rows a group
  const float* v;      // Nk rows a group
  const float* r;      // (BH, Nq, M)
  const float* s;      // (M, Nk)
  const float* dout;   // q's layout
  float* lse;          // (BH, Nq): the query pass writes it, dK/dV reads
  float* delta;        // (BH, Nq)
  float* dq;           // q's layout (the query pass)
  float* dk;           // k's layout, `part` elements a split
  float* dv;
  float* ds;           // (splits, BH, M, Nk)
  long long part;      // elements between two splits' dK (dV) partials
  int bh, heads, nq, nk, d, m;
  int row;             // elements between consecutive rows of a group
  int splits;          // blocks sharing one key block's query tiles
  int key_blocks;
  int q_tiles;
  int vec;             // f32 elements per copy of a row: 4, 2 or 1
  float scale;
};

// the element offset of group grp's first row of n (b n row + h D)
__device__ __forceinline__ long long bwd_base(const BwdParams& p, int grp,
                                              int n) {
  return (long long)(grp / p.heads) * n * p.row +
         (long long)(grp % p.heads) * p.d;
}

// rows of 16 KS floats (row stride LD) split into tf32 hi, in place, and
// lo, at the same offsets of `lo`, by the whole block
template <int KS, int LD, int THREADS>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int rows) {
  for (int i = threadIdx.x; i < rows * 4 * KS; i += THREADS) {
    const int o = (i / (4 * KS)) * LD + (i % (4 * KS)) * 4;
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

// Keys per block of the f32 dK/dV/dS kernel at head dim d and m factor
// columns (BwdShape's KEYS: 128, or 64 where two warps share a strip), 0
// for sizes the launcher refuses.
struct BwdKeys {
  template <int KS, int MT>
  int run() const { return BwdShape<KS, MT>::KEYS; }
};

inline int bwd_dkv_f32_keys(int d, int m) {
  return bwd_sizes_ok(d, m) ? with_bwd_shape(d, m, BwdKeys{}) : 0;
}

struct BwdLaunch {
  const BwdParams& p;
  cudaStream_t stream;
  template <int KS, int MT>
  int run() const { return launch_bwd_dkv_f32_steps<KS, MT>(p, stream); }
};

// The sizes (D <= 128, M <= kMaxRank, else cudaErrorInvalidValue), the
// copy width (the widest of 4, 2 or 1 floats that divides D, the row
// stride and the base addresses) and the scale of both launchers
inline int bwd_prepare(BwdParams& p) {
  if (!bwd_sizes_ok(p.d, p.m)) return (int)cudaErrorInvalidValue;
  p.vec = 1;
  for (int vec = 4; vec > 1; vec /= 2)
    if (p.d % vec == 0 && p.row % vec == 0 && aligned(p.q, 4 * vec) &&
        aligned(p.k, 4 * vec) && aligned(p.v, 4 * vec) &&
        aligned(p.dout, 4 * vec)) {
      p.vec = vec;
      break;
    }
  p.scale = (float)(1.0 / std::sqrt((double)p.d));  // 1.0 / math.sqrt(d)
  return 0;
}

// The two launchers below are templates (Params is BwdParams), so that a
// source builds the kernels of the launcher it calls and no others.

// The f32 dK/dV/dS launcher (K4: 25 kernels); 1 <= splits <= ceil(Nq /
// 32) (the caller's check). Returns a cudaError_t.
template <typename Params>
int launch_bwd_dkv_f32(Params p, cudaStream_t stream) {
  const int err = bwd_prepare(p);
  if (err != 0) return err;
  return with_bwd_shape(p.d, p.m, BwdLaunch{p, stream});
}

template <int KS>
int launch_bwd_f32_span(BwdParams p, cudaStream_t stream) {
  const int err = launch_bwd_dq_f32_steps<KS>(p, stream);
  if (err != 0) return err;
  return launch_bwd_dkv_f32_steps<KS, 0>(p, stream);
}

// K2's f32 launcher (10 kernels), without the bias: the query pass (dQ,
// and the LSE and delta into p.lse and p.delta), then the dK/dV pass;
// D <= 128, else cudaErrorInvalidValue. Returns a cudaError_t.
template <typename Params>
int launch_bwd_f32(Params p, cudaStream_t stream) {
  p.m = 0;
  const int err = bwd_prepare(p);
  if (err != 0) return err;
  if (p.d <= 16) return launch_bwd_f32_span<1>(p, stream);
  switch ((p.d + 31) / 32) {
    case 1: return launch_bwd_f32_span<2>(p, stream);
    case 2: return launch_bwd_f32_span<4>(p, stream);
    case 3: return launch_bwd_f32_span<6>(p, stream);
    default: return launch_bwd_f32_span<8>(p, stream);
  }
}

}  // namespace tc
