// Tensor-core attention, softmax(q k^T / sqrt(D) [+ r s]) v, for Hopper
// (sm_90a). Two bodies on one ring (cp_async, copy_chunks, copy_s, copy_r),
// tile loop, online softmax (mask_keys, online_softmax) and epilogue
// (finish):
//   - attention_kernel, bfloat16: the bf16 instantiations of K1
//     (flash_attention.cu, the THAT family's (B, N, H, D) layout) and K3
//     (flash_attention_lowrank.cu, MViT's (B, H, N, D) layout with the f32
//     low-rank bias and the row LSE);
//   - attention_f32_kernel, float32 at f32 precision: the f32
//     instantiations of K1 (THAT training's forward) and K3 (MViT
//     training's forward), QK^T and P.V as 3xTF32.
// tc_attention_bwd.cuh builds the backward bodies (K4's and K2's f32
// kernels, K4's bf16 dK/dV/dS) on the same pieces.
//
// Arithmetic of the bf16 body (the order
// tests/test_torch_port_tc_attention_order.py holds against the TPU kernels
// on the CPU):
//   - logits q.k as bf16 products summed in f32 on the tensor cores
//     (mma.sync m16n8k16), times 1/sqrt(D) with the true D; then the bias
//     r.s at f32 precision as 3xTF32 products on the tensor cores (mma.sync
//     m16n8k8: each f32 factor split into tf32 hi + lo, lo.hi + hi.lo +
//     hi.hi accumulated in f32, straight into the logits' accumulators);
//   - one pass over key tiles of 64 with an online softmax: a running row
//     max m and sum l in f32 registers, the accumulator and l rescaled by
//     exp(m_old - m_new) when the max moves;
//   - the unnormalised weights exp(logit - m) rounded to bf16 and fed from
//     the logits' accumulator registers straight into the A fragments of the
//     P.V mma (f32 accumulation); the division by l comes once, at the end;
//     the TPU rounds the normalised weights instead, within one bf16 step;
//   - the row LSE m + log(l) in f32 (K3).
//
// Arithmetic of the f32 body (held by the same test, f32_order): the same
// pass, with q.k and P.V as 3xTF32 products on mma.sync m16n8k8 (lo.hi +
// hi.lo + hi.hi of the split factors; for q.k the small terms summed
// apart and each k-step's hi.hi added in f32; each key tile's P.V formed
// alone and added to the rescaled output), the bias r.s as one f32 FMA
// chain over the factor columns on the CUDA cores (bias_steps), the
// weights kept in f32 (never rounded) and the division by l at the end.
// 3xTF32 is good to about 2^-22 of each product: f32's precision, not
// TF32's.
//
// Tiles of the bf16 body. One block of 4 warps takes one (group, head) and
// 64 query rows, 16 rows a warp; the Q tile is staged once through shared
// memory into registers (A fragments). Key tiles of 64 stream through a
// two-stage shared-memory ring filled with cp.async, so tile t + 1's K, V
// and S chunk arrive while tile t computes. Rows are padded to 16 * KS + 8
// elements (an odd multiple of 16 bytes), so ldmatrix reads no bank twice;
// the f32 R strip (resident) and S chunks (in the ring) have row strides
// that keep the tf32 fragment reads off each other's banks too. KS =
// ceil(span / 16) is a template parameter (the head dim's span in k-steps),
// as is the bias. Without the bias and at KS <= 6 (D <= 96) an SM holds 3
// blocks (at most 170 registers a thread, no spills); else 2.
//
// Tiles of the f32 body. WARPS warps take 16 * WARPS query rows and key
// tiles of KEYS, with registers budgeted for MINB blocks an SM
// (picked by the launcher's rule, launch_f32_span): 8 warps over 128
// rows and tiles of 64, one block an SM, where those tiles fit (D <= 96
// and, at D = 96, M <= 64: MViT's shapes); else 4 warps over 64 rows and
// tiles of 32, two blocks an SM at D = 96; and for spans of 16 or 32
// without the bias (K1's heads) 4 warps over 64 rows and tiles of 32 with
// registers for 4 blocks an SM.
// ldmatrix moves 16-bit data, so the tf32 fragments are 32-bit shared
// loads: K, V and Q have a row stride of 16 * KS + 4 floats (4 mod 8), so
// the 8 keys x 4 columns of a K fragment, the 4 x 8 of a V fragment and
// Q's 8 rows x 4 columns each hit 32 banks. Q stays in shared memory (in
// registers its raw fragments would take 48 of the 255 a thread at D = 96)
// and is split at each k-step; K and V are split as their fragments are
// loaded, by every warp.
// The weights need no shuffle into P.V's A fragments: a thread's logits of
// keys 2t and 2t + 1 (its accumulator columns) are taken as the A columns t
// and t + 4, and V's B fragment reads rows 2t and 2t + 1 to match, which
// permutes the keys of each k-step alike on both sides of the product.
//
// Alignment. A head's row starts at an element offset o (h * D in K1's
// token-major layout). The bf16 launcher picks the widest copy of 8, 4 or 2
// bf16 (16, 8 or 4 bytes) that divides the row strides and the base
// addresses; row i of a tile is then copied from o - sh
// on, sh = o mod the copy width, so a head of D = 27 at an odd offset still
// moves in aligned 4-byte pieces (and D = 96 in 16-byte pieces). In shared
// memory the head's element c lands at position sh + c; the positions
// outside [sh, sh + D) hold a neighbouring head's elements or nothing and
// are zeroed in the Q and K fragments (registers), so the padded products
// are exact; V's stray columns feed only output columns that are never
// stored. A bf16 copy width of 1 (odd row strides) loads synchronously.
// The f32 body takes the widest copy of 4, 2 or 1 floats that divides D,
// the row stride and the base addresses (prepare_f32: 1 float at K1's D =
// 27 or 15, 4 at K3's D = 96), so no head is shifted, and zeroes the
// span's columns past D in shared memory once instead of masking each
// fragment. Keys and rows past the ends are zero-filled by cp.async and
// the keys' logits set to -inf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;            // the bf16 body's
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;   // query rows per block
constexpr int kKeys = 64;            // keys per tile (== kRows: Q is staged
                                     // in the second K stage)
constexpr int kMaxSteps = 8;         // head-dim span <= 128 (8 x 16)
constexpr int kMaxRank = 128;        // bias factor columns
constexpr size_t kMaxSharedBytes = 232448;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSLd = kKeys + 8;      // S chunk row stride (floats): the B
                                     // fragments' rows hit different banks
constexpr int kF32WideSteps = 6;     // the f32 body's 8-warp configuration
                                     // takes spans up to 96 (D <= 96)

template <typename T>
struct ParamsOf {
  const T* q;
  const T* k;
  const T* v;
  T* out;
  const float* r;  // (groups, nq, m) f32, K3's bias rows
  const float* s;  // (m, nk) f32
  float* lse;      // (groups, nq) f32, or null
  int groups;      // B (K1) or B*H (K3)
  int heads;       // H (K1) or 1 (K3)
  int nq, nk, d, m;
  int row;         // elements between consecutive tokens: H*D or D
  int vec;         // elements per copy: 8, 4, 2 or 1
  int vec_s;       // f32 elements per copy of S: 4 or 1
  int tiles;       // query tiles
  float scale;
};
typedef ParamsOf<bf16> Params;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of N bytes; zero-filled when !valid (src is then any valid
// address and is not read)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int bytes = valid ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b, a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b, a 16 x 8 tf32 (row), b 8 x 8 tf32 (col), d 16 x 8 f32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32's 10 mantissa bits, to nearest with ties away from
// zero: cvt.rna.tf32.f32 on finite x in two integer operations (ptxas
// expands the cvt with a branch around the non-finite case, about three
// times as many instructions on the f32 body's hot loop)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 of x, both tf32 (3xTF32: hi hi + hi lo +
// lo hi keeps f32's precision; lo lo is below it); x finite
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d = a b (no accumulator), a 16 x 8 tf32, b 8 x 8 tf32, d 16 x 8 f32
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += a b at f32 precision: lo hi + hi lo + hi hi, in that order, the
// factors given split
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4],
                                     const uint32_t (&bhi)[2],
                                     const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi[0], bhi[1]);
  mma_tf32(d, ahi, blo[0], blo[1]);
  mma_tf32(d, ahi, bhi[0], bhi[1]);
}

// the same product with b split here
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0,
                                           float b1) {
  uint32_t bhi[2], blo[2];
  split_tf32(b0, bhi[0], blo[0]);
  split_tf32(b1, bhi[1], blo[1]);
  mma3(d, ahi, alo, bhi, blo);
}

// The same product for the f32 bodies, with the sums kept apart: lo hi +
// hi lo accumulate in `small`, and hi hi is formed alone and added to
// `big` in f32 (round to nearest). The tensor cores align and truncate
// the addends of one mma to the largest of them, so the small terms added
// straight into a large accumulator lose their low bits, always toward
// zero; kept apart, each k-step truncates only at its own magnitude.
__device__ __forceinline__ void mma3_apart(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t (&bhi)[2],
                                           const uint32_t (&blo)[2]) {
  mma_tf32(small, alo, bhi[0], bhi[1]);
  mma_tf32(small, ahi, blo[0], blo[1]);
  float hh[4];
  mma_tf32_new(hh, ahi, bhi[0], bhi[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) big[e] += hh[e];
}

// the same with b split here
__device__ __forceinline__ void mma_3xtf32_apart(float (&big)[4],
                                                 float (&small)[4],
                                                 const uint32_t (&ahi)[4],
                                                 const uint32_t (&alo)[4],
                                                 float b0, float b1) {
  uint32_t bhi[2], blo[2];
  split_tf32(b0, bhi[0], blo[0]);
  split_tf32(b1, bhi[1], blo[1]);
  mma3_apart(big, small, ahi, alo, bhi, blo);
}

// two f32 rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the 32-bit mask keeping the bf16 pair at positions p, p + 1 that lie in
// [sh, sh + d)
__device__ __forceinline__ uint32_t pair_mask(int p, int sh, int d) {
  const uint32_t lo = (unsigned)(p - sh) < (unsigned)d ? 0xffffu : 0u;
  const uint32_t hi = (unsigned)(p + 1 - sh) < (unsigned)d ? 0xffff0000u : 0u;
  return lo | hi;
}

// ROWS rows of one head into a tile of row stride LD: row i from src0 +
// i * row, positions [0, chunks * V), rows >= valid zeroed. Each row's
// chunks are spread over 1 << cshift slots (the next power of two), so a
// thread finds its row and chunk by shifts.
template <typename T, int LD, int V, int ROWS = kKeys, int THREADS = kThreads>
__device__ __forceinline__ void copy_chunks(T* dst, const T* src0,
                                            long long row, int valid,
                                            int chunks, int cshift,
                                            const T* any) {
  const int mask = (1 << cshift) - 1;
  for (int i = threadIdx.x; i < ROWS << cshift; i += THREADS) {
    const int r = i >> cshift, c = i & mask;
    if (c < chunks) {
      const bool ok = r < valid;
      cp_async<(int)sizeof(T) * V>(dst + r * LD + c * V,
                                   ok ? src0 + r * row + c * V : any, ok);
    }
  }
}

// bf16 rows: 8-, 4- or 2-element copies by cp.async (16, 8 or 4 bytes)
template <int LD, int ROWS = kKeys, int THREADS = kThreads>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src0,
                                          long long row, int valid,
                                          int chunks, int cshift, int vec,
                                          int d, const bf16* any) {
  switch (vec) {
    case 8:
      copy_chunks<bf16, LD, 8, ROWS, THREADS>(dst, src0, row, valid, chunks,
                                              cshift, any);
      break;
    case 4:
      copy_chunks<bf16, LD, 4, ROWS, THREADS>(dst, src0, row, valid, chunks,
                                              cshift, any);
      break;
    case 2:
      copy_chunks<bf16, LD, 2, ROWS, THREADS>(dst, src0, row, valid, chunks,
                                              cshift, any);
      break;
    default:  // odd strides: synchronous, element by element
      for (int i = threadIdx.x; i < ROWS * d; i += THREADS) {
        const int r = i / d, c = i - r * d;
        dst[r * LD + c] = r < valid ? src0[r * row + c] : __float2bfloat16(0.f);
      }
  }
}

// f32 rows: 4-, 2- or 1-element copies, all by cp.async
template <int LD, int ROWS, int THREADS>
__device__ __forceinline__ void copy_rows(float* dst, const float* src0,
                                          long long row, int valid,
                                          int chunks, int cshift, int vec,
                                          const float* any) {
  switch (vec) {
    case 4:
      copy_chunks<float, LD, 4, ROWS, THREADS>(dst, src0, row, valid, chunks,
                                               cshift, any);
      break;
    case 2:
      copy_chunks<float, LD, 2, ROWS, THREADS>(dst, src0, row, valid, chunks,
                                               cshift, any);
      break;
    default:
      copy_chunks<float, LD, 1, ROWS, THREADS>(dst, src0, row, valid, chunks,
                                               cshift, any);
  }
}

// S columns [k0, k0 + KEYS) of rows [0, m8) as f32 [m8][SLD]; rows >= m
// and keys >= nk zeroed
template <int KEYS = kKeys, int SLD = kSLd, int THREADS = kThreads>
__device__ __forceinline__ void copy_s(float* dst, const float* s, int m,
                                       int m8, int nk, int k0, int vec_s) {
  if (vec_s == 4) {
    for (int i = threadIdx.x; i < m8 * (KEYS / 4); i += THREADS) {
      const int row = i / (KEYS / 4), key = (i - row * (KEYS / 4)) * 4;
      const bool ok = row < m && k0 + key < nk;
      cp_async<16>(dst + row * SLD + key,
                   ok ? s + (size_t)row * nk + k0 + key : s, ok);
    }
  } else {
    for (int i = threadIdx.x; i < m8 * KEYS; i += THREADS) {
      const int row = i / KEYS, key = i - row * KEYS;
      const bool ok = row < m && k0 + key < nk;
      cp_async<4>(dst + row * SLD + key,
                  ok ? s + (size_t)row * nk + k0 + key : s, ok);
    }
  }
}

// the bias factor columns padded to the tf32 mma depth of 8, and the R
// strip's row stride (4 mod 8 floats: the A fragments' rows hit
// different banks)
__host__ __device__ constexpr int round8(int m) { return (m + 7) & ~7; }
__host__ __device__ constexpr int r_stride(int m) { return round8(m) + 4; }

// the R strip of ROWS rows from row0 of group grp, columns [0, rs), the
// columns >= m and rows >= rows zeroed
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_r(float* sr, const float* r, int grp,
                                       int nq, int row0, int rows, int m,
                                       int rs) {
  const float* rb = r + ((long long)grp * nq + row0) * m;
  for (int i = threadIdx.x; i < ROWS * rs; i += THREADS) {
    const int row = i / rs, c = i - row * rs;
    const bool ok = row < rows && c < m;
    cp_async<4>(sr + i, ok ? rb + (long long)row * m + c : r, ok);
  }
}

// s += r s over the factor columns [0, m8) as 3xTF32 on the tensor cores,
// for NT n-tiles of 8 keys: ra is this lane's R strip row g8 at column t4
// (row stride rs), sb the S chunk's row t4 at key g8 (row stride SLD)
template <int NT, int SLD>
__device__ __forceinline__ void add_bias(float (&s)[NT][4], const float* ra,
                                         const float* sb, int m8, int rs) {
  for (int c = 0; c < m8; c += 8) {
    uint32_t ahi[4], alo[4];
    split_tf32(ra[c], ahi[0], alo[0]);               // row g8, col t4
    split_tf32(ra[c + 8 * rs], ahi[1], alo[1]);      // row g8 + 8
    split_tf32(ra[c + 4], ahi[2], alo[2]);           // col t4 + 4
    split_tf32(ra[c + 8 * rs + 4], ahi[3], alo[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j)  // rows t4 and t4 + 4, key g8
      mma_3xtf32(s[j], ahi, alo, sb[c * SLD + j * 8],
                 sb[(c + 4) * SLD + j * 8]);
  }
}

// Four steps of the f32 body's bias on the CUDA cores: for each of this
// lane's logits (rows g8 and g8 + 8, keys 8 j + 2 t4 and + 1) b += r s over
// the factor columns [c, c + 4), one FMA each, in order. Run over the
// columns from 0 with b at 0, that is one FMA chain, which is how the plain
// version's f32 GEMM forms r @ s (bit for bit on an H100). r0 and r1 are
// the R strip's rows g8 and g8 + 8 (16-byte aligned, zero past m), sb the
// S chunk at key 2 t4 (row stride SLD; rows past m zero, so the padded
// columns add fma(0, 0, b) = b).
template <int NT, int SLD>
__device__ __forceinline__ void bias_steps(float (&b)[NT][4], const float* r0,
                                           const float* r1, const float* sb,
                                           int c) {
  const float4 x0 = *reinterpret_cast<const float4*>(r0 + c);
  const float4 x1 = *reinterpret_cast<const float4*>(r1 + c);
  const float a0[4] = {x0.x, x0.y, x0.z, x0.w};
  const float a1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 y =
          *reinterpret_cast<const float2*>(sb + (c + i) * SLD + 8 * j);
      b[j][0] = fmaf(a0[i], y.x, b[j][0]);
      b[j][1] = fmaf(a0[i], y.y, b[j][1]);
      b[j][2] = fmaf(a1[i], y.x, b[j][2]);
      b[j][3] = fmaf(a1[i], y.y, b[j][3]);
    }
  }
}

// the logits of keys past nk set to -inf (this lane's keys k0 + 8 j + 2 t4
// and the next)
template <int NT>
__device__ __forceinline__ void mask_keys(float (&s)[NT][4], int k0, int nk,
                                          int t4) {
  if (k0 + 8 * NT <= nk) return;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int key = k0 + j * 8 + 2 * t4;
    if (key >= nk) s[j][0] = s[j][2] = -INFINITY;
    if (key + 1 >= nk) s[j][1] = s[j][3] = -INFINITY;
  }
}

// one key tile of the online softmax for this lane's rows g8 (e = 0, 1) and
// g8 + 8 (e = 2, 3): the running max m and this lane's share of the sums l
// move to the tile, l is rescaled by alpha = exp(m_old - m_new), and s
// becomes the unnormalised weights exp(s - m); the caller rescales its
// output accumulator by alpha
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4],
                                               float (&alpha)[2],
                                               float (&m_run)[2],
                                               float (&l_run)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float neg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i]);  // finite: key k0 < Nk
    alpha[i] = exp2f((m_run[i] - m_new) * kLog2e);
    neg[i] = -m_new * kLog2e;
    m_run[i] = m_new;
    l_run[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(fmaf(s[j][e], kLog2e, neg[e / 2]));
      l_run[e / 2] += s[j][e];
    }
  }
}

__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// the epilogue: this lane's output columns of its rows (local rows
// `first` + g8 and + 8) divided by the row sums, and the LSE m + log(l)
template <typename T, int NO>
__device__ __forceinline__ void finish(const ParamsOf<T>& p,
                                       const float (&o)[NO][4],
                                       const float (&m_run)[2],
                                       float (&l_run)[2], int grp, int h,
                                       int row0, int rows, int first, int sh,
                                       int g8, int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = first + g8 + 8 * i;
    if (row >= rows) continue;
    const long long base =
        ((long long)grp * p.nq + row0 + row) * p.row + (long long)h * p.d;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t4 + e - sh;
        if (c >= 0 && c < p.d) store(p.out + base + c, o[j][2 * i + e] / l_run[i]);
      }
    }
    if (p.lse != nullptr && t4 == 0)
      p.lse[(long long)grp * p.nq + row0 + row] = m_run[i] + logf(l_run[i]);
  }
}

// dynamic shared memory of one bf16 block: the K and V ring, and with the
// bias the R strip and the S ring
inline size_t smem_bytes(int ks, int m) {
  const size_t kv = 2 * 2 * (size_t)kKeys * (16 * ks + 8) * sizeof(bf16);
  return kv + (m ? sizeof(float) * ((size_t)kRows * r_stride(m) +
                                     2 * (size_t)round8(m) * kSLd)
                 : 0);
}

// 3 blocks an SM without the bias at D <= 96, else 2 (see Tiles above)
template <int KS, bool BIAS>
__global__ void __launch_bounds__(kThreads, (BIAS || KS > 6) ? 2 : 3)
    attention_kernel(Params p) {
  constexpr int LD = 16 * KS + 8;  // an odd multiple of 8 elements
  constexpr int NT_O = 2 * KS;  // output n-tiles of 8 positions
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [2][kKeys][LD]
  bf16* sv = sk + 2 * kKeys * LD;                // [2][kKeys][LD]
  const int m8 = BIAS ? round8(p.m) : 0;
  const int rs = BIAS ? r_stride(p.m) : 0;
  float* sr = reinterpret_cast<float*>(sv + 2 * kKeys * LD);  // [kRows][rs]
  float* ss = sr + kRows * rs;                   // [2][m8][kSLd]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  int bid = blockIdx.x;
  const int h = bid % p.heads;
  bid /= p.heads;
  const int tile = bid % p.tiles;
  const int grp = bid / p.tiles;
  const int row0 = tile * kRows;
  const int rows = min(kRows, p.nq - row0);
  const int d = p.d;
  const int sh = p.vec > 1 ? (h * d) % p.vec : 0;
  const int chunks = p.vec > 1 ? (sh + d + p.vec - 1) / p.vec : 0;
  int cshift = 0;
  while ((1 << cshift) < chunks) ++cshift;
  const bool ragged = sh != 0 || sh + d != 16 * KS;
  const long long hoff = (long long)h * d - sh;
  const bf16* qb = p.q + ((long long)grp * p.nq + row0) * p.row + hoff;
  const bf16* kb = p.k + (long long)grp * p.nk * p.row + hoff;
  const bf16* vb = p.v + (long long)grp * p.nk * p.row + hoff;
  const int tiles_k = (p.nk + kKeys - 1) / kKeys;

  auto fetch = [&](int t) {
    const int st = t & 1, k0 = t * kKeys;
    const int valid = min(kKeys, p.nk - k0);
    copy_rows<LD>(sk + st * kKeys * LD, kb + (long long)k0 * p.row, p.row,
                  valid, chunks, cshift, p.vec, d, p.k);
    copy_rows<LD>(sv + st * kKeys * LD, vb + (long long)k0 * p.row, p.row,
                  valid, chunks, cshift, p.vec, d, p.v);
    if constexpr (BIAS)
      copy_s(ss + st * m8 * kSLd, p.s, p.m, m8, p.nk, k0, p.vec_s);
  };

  // prologue: Q into the second K stage, the R strip and tile 0 together
  copy_rows<LD>(sk + kKeys * LD, qb, p.row, rows, chunks, cshift, p.vec, d,
                p.q);
  if constexpr (BIAS)
    copy_r<kRows, kThreads>(sr, p.r, grp, p.nq, row0, rows, p.m, rs);
  fetch(0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    ldmatrix_x4(qf[kk], sk + kKeys * LD + (warp * 16 + lane % 16) * LD +
                            kk * 16 + (lane / 16) * 8);
    if (ragged) {
      const uint32_t lo = pair_mask(kk * 16 + 2 * t4, sh, d);
      const uint32_t hi = pair_mask(kk * 16 + 8 + 2 * t4, sh, d);
      qf[kk][0] &= lo;
      qf[kk][1] &= lo;
      qf[kk][2] &= hi;
      qf[kk][3] &= hi;
    }
  }
  __syncthreads();  // the Q stage is read; tile 1 may overwrite it
  if (tiles_k > 1) fetch(1);
  cp_commit();

  float o[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int t = 0; t < tiles_k; ++t) {
    const int st = t & 1, k0 = t * kKeys;
    cp_wait<1>();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();
    const bf16* kt = sk + st * kKeys * LD;
    const bf16* vt = sv + st * kKeys * LD;

    // logits of this warp's 16 rows x 64 keys: 8 n-tiles of 8 keys
    float s_acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s_acc[j][0] = s_acc[j][1] = s_acc[j][2] = s_acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t lo = 0xffffffffu, hi = 0xffffffffu;
      if (ragged) {
        lo = pair_mask(kk * 16 + 2 * t4, sh, d);
        hi = pair_mask(kk * 16 + 8 + 2 * t4, sh, d);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma(s_acc[2 * np], qf[kk], b[0] & lo, b[1] & hi);
        mma(s_acc[2 * np + 1], qf[kk], b[2] & lo, b[3] & hi);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] *= p.scale;

    if constexpr (BIAS)  // + r s in f32 as 3xTF32 on the tensor cores
      add_bias<8, kSLd>(s_acc, sr + (warp * 16 + g8) * rs + t4,
                        ss + st * m8 * kSLd + t4 * kSLd + g8, m8, rs);
    mask_keys(s_acc, k0, p.nk, t4);
    float alpha[2];
    online_softmax(s_acc, alpha, m_run, l_run);
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // P.V: the weights' accumulator pairs are the A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s_acc[2 * kk][0], s_acc[2 * kk][1]);
      a[1] = pack_bf16(s_acc[2 * kk][2], s_acc[2 * kk][3]);
      a[2] = pack_bf16(s_acc[2 * kk + 1][0], s_acc[2 * kk + 1][1]);
      a[3] = pack_bf16(s_acc[2 * kk + 1][2], s_acc[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                   dp * 16 + (lane >> 4) * 8);
        mma(o[2 * dp], a, b[0], b[1]);
        mma(o[2 * dp + 1], a, b[2], b[3]);
      }
    }

    __syncthreads();  // every warp is done with stage st
    if (t + 2 < tiles_k) fetch(t + 2);
    cp_commit();  // an empty group keeps the wait count uniform
  }

  finish(p, o, m_run, l_run, grp, h, row0, rows, warp * 16, sh, g8, t4);
}

template <int KS, bool BIAS>
int launch_steps(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(KS, BIAS ? p.m : 0);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<KS, BIAS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)p.groups * p.heads * p.tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  attention_kernel<KS, BIAS><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

inline bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// the bf16 body's widest copy (8, 4, 2 or 1 elements) that divides the row
// stride and the base addresses and keeps every head's shifted span within
// 128 positions (a copy of 1 always does, as D <= 128); sets p.vec and
// returns the span in k-steps of 16
inline int pick_copy(Params& p) {
  p.vec = 1;
  for (int vec = 8; vec >= 1; vec /= 2) {
    const int bytes = (int)sizeof(bf16) * vec;
    if (p.row % vec || !aligned(p.q, bytes) || !aligned(p.k, bytes) ||
        !aligned(p.v, bytes))
      continue;
    int span = p.d;
    for (int h = 0; h < p.heads && h < vec; ++h)
      span = span > (h * p.d) % vec + p.d ? span : (h * p.d) % vec + p.d;
    if (span <= 16 * kMaxSteps) {
      p.vec = vec;
      return (span + 15) / 16;
    }
  }
  return 0;
}

// The bf16 launcher: picks the copy widths and the head-dim span (in
// k-steps of 16), refuses a span above 128 (D > 128) and, with the bias,
// more than kMaxRank factor columns. Returns a cudaError_t.
template <bool BIAS>
int launch(Params p, cudaStream_t stream) {
  if (p.d > 16 * kMaxSteps) return (int)cudaErrorInvalidValue;
  if (BIAS && (p.m <= 0 || p.m > kMaxRank)) return (int)cudaErrorInvalidValue;
  const int steps = pick_copy(p);  // a copy of 1 loads synchronously
  p.vec_s = BIAS && p.nk % 4 == 0 && aligned(p.s, 16) ? 4 : 1;
  p.tiles = (p.nq + kRows - 1) / kRows;
  p.scale = (float)(1.0 / std::sqrt((double)p.d));  // 1.0 / math.sqrt(d)
  switch (steps) {
    case 1: return launch_steps<1, BIAS>(p, stream);
    case 2: return launch_steps<2, BIAS>(p, stream);
    case 3: return launch_steps<3, BIAS>(p, stream);
    case 4: return launch_steps<4, BIAS>(p, stream);
    case 5: return launch_steps<5, BIAS>(p, stream);
    case 6: return launch_steps<6, BIAS>(p, stream);
    case 7: return launch_steps<7, BIAS>(p, stream);
    case 8: return launch_steps<8, BIAS>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------
// The f32 body
// ----------------------------------------------------------------------

// dynamic shared memory of one f32 block: the K and V ring and the Q tile
// (rows of 16 * ks + 4 floats), and with the bias the R strip and the S
// ring
template <int WARPS, int KEYS>
constexpr size_t smem_bytes_f32(int ks, int m) {
  const size_t rows = 2 * 2 * (size_t)KEYS + 16 * WARPS;
  return sizeof(float) *
         (rows * (16 * ks + 4) +
          (m ? (size_t)16 * WARPS * r_stride(m) +
                   2 * (size_t)round8(m) * (KEYS + 8)
             : 0));
}

// MINB blocks of WARPS warps an SM (see launch_f32_span below)
template <int KS, bool BIAS, int WARPS, int KEYS, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB)
    attention_f32_kernel(ParamsOf<float> p) {
  constexpr int THREADS = 32 * WARPS, ROWS = 16 * WARPS;
  constexpr int SLD = KEYS + 8;  // the S chunk's row stride
  constexpr int LD = 16 * KS + 4;
  constexpr int K8 = 2 * KS;     // k-steps of 8 over the span, and output
                                 // n-tiles of 8 positions
  constexpr int NT = KEYS / 8;   // n-tiles of 8 keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // [2][KEYS][LD]
  float* sv = sk + 2 * KEYS * LD;                  // [2][KEYS][LD]
  float* sq = sv + 2 * KEYS * LD;                  // [ROWS][LD]
  const int m8 = BIAS ? round8(p.m) : 0;
  const int rs = BIAS ? r_stride(p.m) : 0;
  float* sr = sq + ROWS * LD;                      // [ROWS][rs]
  float* ss = sr + ROWS * rs;                      // [2][m8][SLD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  int bid = blockIdx.x;
  const int h = bid % p.heads;
  bid /= p.heads;
  const int tile = bid % p.tiles;
  const int grp = bid / p.tiles;
  const int row0 = tile * ROWS;
  const int rows = min(ROWS, p.nq - row0);
  const int d = p.d;  // a multiple of the copy width (see prepare_f32)
  const int chunks = d / p.vec;
  int cshift = 0;
  while ((1 << cshift) < chunks) ++cshift;
  const long long hoff = (long long)h * d;
  const float* qb = p.q + ((long long)grp * p.nq + row0) * p.row + hoff;
  const float* kb = p.k + (long long)grp * p.nk * p.row + hoff;
  const float* vb = p.v + (long long)grp * p.nk * p.row + hoff;
  const int tiles_k = (p.nk + KEYS - 1) / KEYS;

  // the copies fill columns [0, D) of each row; the span's columns past D
  // are zeroed once, so the padded products add nothing
  if (d < 16 * KS) {
    const int pad = 16 * KS - d;
    for (int i = threadIdx.x; i < (4 * KEYS + ROWS) * pad; i += THREADS)
      sk[(i / pad) * LD + d + i % pad] = 0.f;  // sk, sv and sq are adjacent
  }

  auto fetch = [&](int t) {
    const int st = t & 1, k0 = t * KEYS;
    const int valid = min(KEYS, p.nk - k0);
    copy_rows<LD, KEYS, THREADS>(sk + st * KEYS * LD,
                                 kb + (long long)k0 * p.row, p.row, valid,
                                 chunks, cshift, p.vec, p.k);
    copy_rows<LD, KEYS, THREADS>(sv + st * KEYS * LD,
                                 vb + (long long)k0 * p.row, p.row, valid,
                                 chunks, cshift, p.vec, p.v);
    if constexpr (BIAS)
      copy_s<KEYS, SLD, THREADS>(ss + st * m8 * SLD, p.s, p.m, m8, p.nk, k0,
                                 p.vec_s);
  };

  // prologue: the Q tile, the R strip and tile 0 together, then tile 1
  copy_rows<LD, ROWS, THREADS>(sq, qb, p.row, rows, chunks, cshift, p.vec,
                               p.q);
  if constexpr (BIAS)
    copy_r<ROWS, THREADS>(sr, p.r, grp, p.nq, row0, rows, p.m, rs);
  fetch(0);
  cp_commit();
  if (tiles_k > 1) fetch(1);
  cp_commit();
  // Q's A fragments, raw f32 (rows g8 and g8 + 8, columns t4 and t4 + 4),
  // read from shared memory at each k-step: in registers they would take
  // 4 K8 a thread
  const float* qa = sq + (warp * 16 + g8) * LD + t4;

  float o[K8][4];
#pragma unroll
  for (int j = 0; j < K8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int t = 0; t < tiles_k; ++t) {
    const int st = t & 1, k0 = t * KEYS;
    cp_wait<1>();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();
    const float* kt = sk + st * KEYS * LD;
    const float* vt = sv + st * KEYS * LD;

    // logits of this warp's 16 rows x KEYS keys, 3xTF32; the K fragment
    // of n-tile j is keys 8 j + g8 at columns 8 kk + t4 and + 4
    float s_acc[NT][4], s_small[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[j][e] = s_small[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < K8; ++kk) {
      uint32_t qhi[4], qlo[4];
      split_tf32(qa[8 * kk], qhi[0], qlo[0]);
      split_tf32(qa[8 * kk + 8 * LD], qhi[1], qlo[1]);
      split_tf32(qa[8 * kk + 4], qhi[2], qlo[2]);
      split_tf32(qa[8 * kk + 8 * LD + 4], qhi[3], qlo[3]);
      const float* kp = kt + g8 * LD + 8 * kk + t4;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_3xtf32_apart(s_acc[j], s_small[j], qhi, qlo, kp[8 * j * LD],
                         kp[8 * j * LD + 4]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s_acc[j][e] = (s_acc[j][e] + s_small[j][e]) * p.scale;

    if constexpr (BIAS) {  // + r s, formed and added as the plain version's
      float (&bias)[NT][4] = s_small;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) bias[j][e] = 0.f;
      const float* r0 = sr + (warp * 16 + g8) * rs;
#pragma unroll 2
      for (int c = 0; c < m8; c += 4)
        bias_steps<NT, SLD>(bias, r0, r0 + 8 * rs, ss + st * m8 * SLD + 2 * t4,
                            c);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[j][e] += bias[j][e];
    }
    mask_keys(s_acc, k0, p.nk, t4);
    float alpha[2];
    online_softmax(s_acc, alpha, m_run, l_run);

    // P.V, one k-step per n-tile j of 8 keys: this lane's weights of keys
    // 8 j + 2 t4 and + 1 are the A columns t4 and t4 + 4 as they lie, and
    // V's B fragment reads those keys' rows at columns 8 dn + g8. The
    // tile's product is formed alone and added to the rescaled output
    // (o alpha + tile, in f32), so its terms truncate at the tile's
    // magnitude, not the running sum's.
    float pv[K8][4];
#pragma unroll
    for (int j = 0; j < K8; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ahi[4], alo[4];
      split_tf32(s_acc[j][0], ahi[0], alo[0]);  // row g8, key 2 t4
      split_tf32(s_acc[j][2], ahi[1], alo[1]);  // row g8 + 8
      split_tf32(s_acc[j][1], ahi[2], alo[2]);  // key 2 t4 + 1
      split_tf32(s_acc[j][3], ahi[3], alo[3]);
      const float* vp = vt + (8 * j + 2 * t4) * LD + g8;
#pragma unroll
      for (int dn = 0; dn < K8; ++dn)
        mma_3xtf32(pv[dn], ahi, alo, vp[8 * dn], vp[LD + 8 * dn]);
    }
#pragma unroll
    for (int j = 0; j < K8; ++j) {
      o[j][0] = fmaf(o[j][0], alpha[0], pv[j][0]);
      o[j][1] = fmaf(o[j][1], alpha[0], pv[j][1]);
      o[j][2] = fmaf(o[j][2], alpha[1], pv[j][2]);
      o[j][3] = fmaf(o[j][3], alpha[1], pv[j][3]);
    }

    __syncthreads();  // every warp is done with stage st
    if (t + 2 < tiles_k) fetch(t + 2);
    cp_commit();  // an empty group keeps the wait count uniform
  }

  finish(p, o, m_run, l_run, grp, h, row0, rows, warp * 16, 0, g8, t4);
}

template <int KS, bool BIAS, int WARPS, int KEYS, int MINB>
int launch_f32_steps(ParamsOf<float> p, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32<WARPS, KEYS>(KS, BIAS ? p.m : 0);
  if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_f32_kernel<KS, BIAS, WARPS, KEYS, MINB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  p.tiles = (p.nq + 16 * WARPS - 1) / (16 * WARPS);
  const long long blocks = (long long)p.groups * p.heads * p.tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  attention_f32_kernel<KS, BIAS, WARPS, KEYS, MINB>
      <<<(unsigned)blocks, 32 * WARPS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The launcher's rule over the f32 body's configurations (warps of 16
// query rows, keys a tile, and the blocks an SM that __launch_bounds__
// budgets registers for: 65536 / (32 warps blocks) a thread, at most 255).
// Without the bias, at spans of one or two k-steps (K1's heads of D = 15
// and 27): 4 warps over 64 rows, 32-key tiles and registers for 4 blocks
// an SM. A block of such a head does little work, so the blocks in flight
// decide: 16 warps an SM at 99-128 registers without spills, against 8 in
// one block at 160-197. Of six candidates timed on an H100 it was the
// fastest per THAT and THAT_ENCODER training step at batch 16, 256 and
// 512 (probes/k1_f32_configs.py, PERF.md section 6), so the rule reads
// neither Nq nor the SM count. Else 8 warps over 128 rows and 64-key
// tiles where they fit in shared memory at spans up to kF32WideSteps
// (MViT's D = 96), else 4 warps and 32-key tiles. A configuration's row
// tile never changes a row's arithmetic; its key tile does (where the
// online softmax rescales). Each span builds only the configurations the
// rule can reach: one without the bias.
constexpr int kF32SmallSteps = 2;
template <int KS, bool BIAS>
int launch_f32_span(const ParamsOf<float>& p, cudaStream_t stream) {
  if constexpr (KS <= kF32SmallSteps && !BIAS) {
    return launch_f32_steps<KS, BIAS, 4, 32, 4>(p, stream);
  } else if constexpr (KS <= kF32WideSteps && !BIAS) {
    static_assert(smem_bytes_f32<8, 64>(KS, 0) <= kMaxSharedBytes);
    return launch_f32_steps<KS, BIAS, 8, 64, 1>(p, stream);
  } else {
    if constexpr (KS <= kF32WideSteps)
      if (smem_bytes_f32<8, 64>(KS, p.m) <= kMaxSharedBytes)
        return launch_f32_steps<KS, BIAS, 8, 64, 1>(p, stream);
    return launch_f32_steps<KS, BIAS, 4, 32, 2>(p, stream);
  }
}

// The f32 sizes (D <= 128 and, with the bias, at most kMaxRank factor
// columns, else cudaErrorInvalidValue), the copy width (the widest of 4,
// 2 or 1 floats that divides D, the row stride and the base addresses, so
// no head is shifted: 1 float at K1's D = 27 and 15) and the scale. Returns
// the span in k-steps of 16, or 0 for refused sizes.
template <bool BIAS>
int prepare_f32(ParamsOf<float>& p) {
  if (p.d <= 0 || p.d > 16 * kMaxSteps) return 0;
  if (BIAS && (p.m <= 0 || p.m > kMaxRank)) return 0;
  p.vec = 1;
  for (int vec = 4; vec > 1; vec /= 2)
    if (p.d % vec == 0 && p.row % vec == 0 && aligned(p.q, 4 * vec) &&
        aligned(p.k, 4 * vec) && aligned(p.v, 4 * vec)) {
      p.vec = vec;
      break;
    }
  p.vec_s = BIAS && p.nk % 4 == 0 && aligned(p.s, 16) ? 4 : 1;
  p.scale = (float)(1.0 / std::sqrt((double)p.d));  // 1.0 / math.sqrt(d)
  return (p.d + 15) / 16;
}

// The f32 launcher: prepare_f32, then the configuration launch_f32_span
// picks. Returns a cudaError_t.
template <bool BIAS>
int launch_f32(ParamsOf<float> p, cudaStream_t stream) {
  switch (prepare_f32<BIAS>(p)) {
    case 1: return launch_f32_span<1, BIAS>(p, stream);
    case 2: return launch_f32_span<2, BIAS>(p, stream);
    case 3: return launch_f32_span<3, BIAS>(p, stream);
    case 4: return launch_f32_span<4, BIAS>(p, stream);
    case 5: return launch_f32_span<5, BIAS>(p, stream);
    case 6: return launch_f32_span<6, BIAS>(p, stream);
    case 7: return launch_f32_span<7, BIAS>(p, stream);
    case 8: return launch_f32_span<8, BIAS>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc
