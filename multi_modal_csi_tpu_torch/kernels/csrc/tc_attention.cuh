// Tensor-core bf16 attention, softmax(q k^T / sqrt(D) [+ r s]) v, for
// Hopper (sm_90a): the body shared by the bf16 instantiations of K1
// (flash_attention.cu, the THAT family's (B, N, H, D) layout) and K3
// (flash_attention_lowrank.cu, MViT's (B, H, N, D) layout with the f32
// low-rank bias and the row LSE).
//
// Arithmetic (the order tests/test_torch_port_tc_attention_order.py holds
// against the TPU kernels on the CPU):
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
// Tiles. One block of 4 warps takes one (group, head) and 64 query rows,
// 16 rows a warp; the Q tile is staged once through shared memory into
// registers (A fragments). Key tiles of 64 stream through a two-stage
// shared-memory ring filled with cp.async, so tile t + 1's K, V and S chunk
// arrive while tile t computes. Rows are padded to 16 * KS + 8 elements
// (an odd multiple of 16 bytes), so ldmatrix reads no bank twice; the f32
// R strip (resident) and S chunks (in the ring) have row strides that keep
// the tf32 fragment reads off each other's banks too. KS = ceil(span / 16)
// is a template parameter (the head dim's span in k-steps), as is the
// bias. Without the bias and at KS <= 6 (D <= 96) an SM holds 3 blocks
// (at most 170 registers a thread, no spills); else 2.
//
// Alignment. A head's row starts at an element offset o (h * D in K1's
// token-major layout). The launcher picks the widest copy of 8, 4 or 2
// elements (16, 8 or 4 bytes) that divides the row strides and the base
// addresses; row i of a tile is then copied from o - sh on, sh = o mod the
// copy width, so a head of D = 27 at an odd offset still moves in aligned
// 4-byte pieces (and D = 96 in 16-byte pieces). In shared memory the head's
// element c lands at position sh + c; the positions outside [sh, sh + D)
// hold a neighbouring head's elements or nothing and are zeroed in the Q
// and K fragments (registers), so the padded products are exact; V's stray
// columns feed only output columns that are never stored. A copy width of
// 1 (odd row strides) loads synchronously. Keys and rows past the ends are
// zero-filled by cp.async and the keys' logits set to -inf.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
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

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* out;
  const float* r;  // (groups, nq, m) f32, K3's bias rows
  const float* s;  // (m, nk) f32
  float* lse;      // (groups, nq) f32, or null
  int groups;      // B (K1) or B*H (K3)
  int heads;       // H (K1) or 1 (K3)
  int nq, nk, d, m;
  int row;         // elements between consecutive tokens: H*D or D
  int vec;         // elements per copy: 8, 4, 2 or 1 (synchronous)
  int vec_s;       // f32 elements per copy of S: 4 or 1
  int tiles;       // query tiles of kRows
  float scale;
};

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

// x = hi + lo to about 2^-22 of x, both tf32 (3xTF32: hi hi + hi lo +
// lo hi keeps f32's precision; lo lo is below it)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
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

// kKeys rows of one head into a tile of row stride LD: row i from src0 +
// i * row, positions [0, chunks * vec), rows >= valid zeroed. Each row's
// chunks are spread over 1 << cshift slots (the next power of two), so a
// thread finds its row and chunk by shifts.
template <int LD, int V>
__device__ __forceinline__ void copy_chunks(bf16* dst, const bf16* src0,
                                            long long row, int valid,
                                            int chunks, int cshift,
                                            const bf16* any) {
  const int mask = (1 << cshift) - 1;
  for (int i = threadIdx.x; i < kKeys << cshift; i += kThreads) {
    const int r = i >> cshift, c = i & mask;
    if (c < chunks) {
      const bool ok = r < valid;
      cp_async<2 * V>(dst + r * LD + c * V, ok ? src0 + r * row + c * V : any,
                      ok);
    }
  }
}

template <int LD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src0,
                                          long long row, int valid,
                                          int chunks, int cshift, int vec,
                                          int d, const bf16* any) {
  switch (vec) {
    case 8:
      copy_chunks<LD, 8>(dst, src0, row, valid, chunks, cshift, any);
      break;
    case 4:
      copy_chunks<LD, 4>(dst, src0, row, valid, chunks, cshift, any);
      break;
    case 2:
      copy_chunks<LD, 2>(dst, src0, row, valid, chunks, cshift, any);
      break;
    default:  // odd strides: synchronous, element by element
      for (int i = threadIdx.x; i < kKeys * d; i += kThreads) {
        const int r = i / d, c = i - r * d;
        dst[r * LD + c] = r < valid ? src0[r * row + c] : __float2bfloat16(0.f);
      }
  }
}

// S columns [k0, k0 + kKeys) of rows [0, m8) as f32 [m8][kSLd]; rows >= m
// and keys >= nk zeroed
__device__ __forceinline__ void copy_s(float* dst, const float* s, int m,
                                       int m8, int nk, int k0, int vec_s) {
  if (vec_s == 4) {
    for (int i = threadIdx.x; i < m8 * (kKeys / 4); i += kThreads) {
      const int row = i / (kKeys / 4), key = (i - row * (kKeys / 4)) * 4;
      const bool ok = row < m && k0 + key < nk;
      cp_async<16>(dst + row * kSLd + key,
                   ok ? s + (size_t)row * nk + k0 + key : s, ok);
    }
  } else {
    for (int i = threadIdx.x; i < m8 * kKeys; i += kThreads) {
      const int row = i / kKeys, key = i - row * kKeys;
      const bool ok = row < m && k0 + key < nk;
      cp_async<4>(dst + row * kSLd + key,
                  ok ? s + (size_t)row * nk + k0 + key : s, ok);
    }
  }
}

// the bias factor columns padded to the tf32 mma depth of 8, and the R
// strip's row stride (4 mod 8 floats: the A fragments' rows hit
// different banks)
__host__ __device__ inline int round8(int m) { return (m + 7) & ~7; }
__host__ __device__ inline int r_stride(int m) { return round8(m) + 4; }

// dynamic shared memory of one block: the K and V ring, and with the bias
// the R strip and the S ring
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
  if constexpr (BIAS) {
    const float* rb = p.r + ((long long)grp * p.nq + row0) * p.m;
    for (int i = threadIdx.x; i < kRows * rs; i += kThreads) {
      const int r = i / rs, c = i - r * rs;
      const bool ok = r < rows && c < p.m;
      cp_async<4>(sr + i, ok ? rb + (long long)r * p.m + c : p.r, ok);
    }
  }
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

    if constexpr (BIAS) {  // + r s in f32 as 3xTF32 on the tensor cores
      const float* ra = sr + (warp * 16 + g8) * rs + t4;
      const float* sb = ss + st * m8 * kSLd + t4 * kSLd + g8;
      for (int c = 0; c < m8; c += 8) {
        uint32_t ahi[4], alo[4];
        split_tf32(ra[c], ahi[0], alo[0]);               // row g8, col t4
        split_tf32(ra[c + 8 * rs], ahi[1], alo[1]);      // row g8 + 8
        split_tf32(ra[c + 4], ahi[2], alo[2]);           // col t4 + 4
        split_tf32(ra[c + 8 * rs + 4], ahi[3], alo[3]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t bhi[2], blo[2];
          split_tf32(sb[c * kSLd + j * 8], bhi[0], blo[0]);  // row t4, key g8
          split_tf32(sb[(c + 4) * kSLd + j * 8], bhi[1], blo[1]);
          mma_tf32(s_acc[j], alo, bhi[0], bhi[1]);
          mma_tf32(s_acc[j], ahi, blo[0], blo[1]);
          mma_tf32(s_acc[j], ahi, bhi[0], bhi[1]);
        }
      }
    }
    if (k0 + kKeys > p.nk) {  // keys past Nk
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + j * 8 + 2 * t4;
        if (key >= p.nk) s_acc[j][0] = s_acc[j][2] = -INFINITY;
        if (key + 1 >= p.nk) s_acc[j][1] = s_acc[j][3] = -INFINITY;
      }
    }

    // online softmax: rows g8 (e = 0, 1) and g8 + 8 (e = 2, 3)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s_acc[j][0], s_acc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s_acc[j][2], s_acc[j][3]));
    }
    float alpha[2], neg[2];
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
    for (int j = 0; j < NT_O; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s_acc[j][e] = exp2f(fmaf(s_acc[j][e], kLog2e, neg[e / 2]));
        l_run[e / 2] += s_acc[j][e];
      }
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

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g8 + 8 * i;
    if (row >= rows) continue;
    const long long base =
        ((long long)grp * p.nq + row0 + row) * p.row + (long long)h * d;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = j * 8 + 2 * t4 + e - sh;
        if (c >= 0 && c < d)
          p.out[base + c] = __float2bfloat16(o[j][2 * i + e] / l_run[i]);
      }
    }
    if (p.lse != nullptr && t4 == 0)
      p.lse[(long long)grp * p.nq + row0 + row] = m_run[i] + logf(l_run[i]);
  }
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

// The launcher: picks the copy widths and the head-dim span (in k-steps of
// 16), refuses a span above 128 (D > 128) and, with the bias, more than
// kMaxRank factor columns. Returns a cudaError_t.
template <bool BIAS>
int launch(Params p, cudaStream_t stream) {
  if (p.d > 16 * kMaxSteps) return (int)cudaErrorInvalidValue;
  if (BIAS && (p.m <= 0 || p.m > kMaxRank)) return (int)cudaErrorInvalidValue;
  int steps = 0;
  p.vec = 1;
  for (int vec = 8; vec > 1; vec /= 2) {
    if (p.row % vec || !aligned(p.q, 2 * vec) || !aligned(p.k, 2 * vec) ||
        !aligned(p.v, 2 * vec))
      continue;
    int span = p.d;
    for (int h = 0; h < p.heads && h < vec; ++h)
      span = span > (h * p.d) % vec + p.d ? span : (h * p.d) % vec + p.d;
    if (span <= 16 * kMaxSteps) {
      p.vec = vec;
      steps = (span + 15) / 16;
      break;
    }
  }
  if (p.vec == 1) steps = (p.d + 15) / 16;
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

}  // namespace tc
