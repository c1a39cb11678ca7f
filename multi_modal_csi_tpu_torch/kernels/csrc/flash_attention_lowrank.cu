// Attention with a low-rank additive bias, softmax(q k^T / sqrt(D) + r s) v,
// for MViT's pooling attention, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel multi_modal_csi_tpu/kernels/flash_attention.py::
// flash_attention_lowrank_bias (body _tiled_kernel, pallas_call at :399).
// Same arithmetic:
//   - logits (q . k) in f32 (bf16 products are exact in f32), times
//     1/sqrt(D) with the true head dim D, plus the bias (r . s) in f32;
//   - row max, exp and sum in f32; weights = exp / sum, rounded to v's dtype;
//   - P.V accumulated in f32; output stored in q's dtype; the row's
//     log-sum-exp max + log(sum) stored in f32.
// r (B, H, Nq, M) and s (M, Nk) are f32; M = 0 means no bias (MViT-v1).
// The (Nq, Nk) logits and bias never leave the chip.
//
// Layout: q (B, H, Nq, D), k and v (B, H, Nk, D), out (B, H, Nq, D), lse
// (B, H, Nq), all contiguous. The TPU kernel's transposes to (B, H, D, N)
// and its key padding folded into the factors (_fold_pad) were devices of
// the TPU's tiling; here every loop is bounded by the true Nq, Nk and M.
//
// Two instantiations, chosen by dtype. K and V of one (b, h) do not fit in
// a block's shared memory at MViT's shapes (1128 keys of D = 96 are 423 KB
// in bf16, 4509 keys 1690 KB, against 227 KB), so in both the keys stream
// through in tiles of 64.
//
// bfloat16 (serving): the tensor-core kernel of tc_attention.cuh. One block
// of 4 warps per (b h, 64 query rows), the Q tile in registers as mma
// fragments and, with the bias, the tile's R strip (64 rows x M f32) in
// shared memory; the K, V and S chunks of the next key tile arrive by
// cp.async (16-byte pieces of D = 96's 192-byte rows) while this one
// computes. QK^T and P.V run on mma.sync m16n8k16 (bf16 in, f32
// accumulators; D zero-padded to a multiple of 16), with one online
// softmax pass: the logits are computed once, the unnormalised weights
// rounded to bf16 straight from the accumulators into P.V's fragments, the
// division by the row sum at the end. The bias r s keeps f32's precision
// ("bias math is always f32" in the TPU kernel) as a 3xTF32 product on the
// tensor cores (mma.sync m16n8k8; r and s split into tf32 hi + lo, and lo hi
// + hi lo + hi hi summed in f32), from R's strip and S's chunk in shared
// memory straight into the logits' accumulators, once per (query tile, key
// tile); M = 0 (MViT-v1) is its own template with no bias code. The bf16
// launcher takes M <= 128.
//
// float32 (training's forward): one block of 256 threads per (b h, 64 query
// rows); the Q tile (transposed, f32) and, when M <= 64, the tile's R strip
// stay in shared memory. Two passes over the key tiles of 64:
//   1. the logits of each tile (each thread a 4 x 4 register tile of rows x
//      keys: a K^T tile and an S chunk in shared memory, the Q and R columns
//      read as float4), then the running row max and the rescaled row sum,
//      which at the end are the row's max and sum, and the LSE;
//   2. the same logits again, the weights exp(l - max) / sum rounded to v's
//      dtype into shared memory, the V tile into the K tile's place, and
//      P.V into a (4 rows x D/16 columns) register accumulator per thread.
// Pass 1's sum is rescaled tile by tile (online), so it may differ from a
// sum over all keys at once in the last bits; the weights and the output
// are otherwise the TPU kernel's.
//
// Bound on an H100 SXM. At MViT's serving shapes (batch 2, bf16) a block's
// launch reads q, k, v, r and s and writes out and lse once: 2 x 72129 x 96
// x 2 bytes of q at block 0, a few tens of MB at most, under 20 us at 3.35
// TB/s. Its products are 4 Nq Nk D operations in bf16 and 2 Nq Nk M in f32
// for the bias: at block 0, 62 G and 12 G, 63 us and 180 us at the 989
// TFLOP/s bf16 and 67 TFLOP/s f32 peaks. So the work is bound by
// operations: MViT-v1's forward by the bf16 tensor cores (0.482 ms for its
// 16 calls), MViT-v2's f32 kernel by the f32 bias product (2.090 ms). The
// bf16 kernel computes the bias as three TF32 products (495 TFLOP/s), so
// its MViT-v2 bound is 1.135 ms; it puts every product on the tensor cores
// and computes each logit once, so what remains is the softmax's exp and
// rescaling, the bias's tf32 splits and the shared-memory fragment loads.
// The f32 kernel runs every product on CUDA cores and computes the logits
// twice, so it is limited by its FMA rate.
//
// Limits: D <= 128 (the Q and K tiles in shared memory); any Nq, Nk >= 1
// and M >= 0 in f32 (S and R stream in chunks of 64 when M > 64), M <= 128
// in bf16. The launcher refuses other sizes and returns cudaGetLastError()
// so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "tc_attention.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each 4 rows x 4 keys
constexpr int kTQ = 64;        // query rows per block
constexpr int kTK = 64;        // keys per tile
constexpr int kMC = 64;        // bias factor columns per chunk
constexpr int kMaxD = 128;
constexpr int kMaxCols = kMaxD / 16;  // output columns per thread
constexpr int kLd = 68;        // row stride of the 64-wide tiles (floats):
                               // float4-aligned, transposed stores 4-way

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

// max and sum over the 16 lanes that share a row group (lanes 0-15 or
// 16-31 of the warp)
__device__ __forceinline__ float group_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory in floats: Q^T (D x kLd), the K^T or V tile (D x kLd),
// the R chunk^T and the S chunk (kMC x kLd each), the weights^T (kTK x kLd).
size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(2 * d + 3 * kMC) * kLd;
}

struct Tiles {
  float* qs;  // qs[c * kLd + row]
  float* kv;  // K tile: kv[c * kLd + key]; V tile: kv[key * d + c]
  float* rs;  // rs[m * kLd + row]
  float* ss;  // ss[m * kLd + key]
  float* ps;  // ps[key * kLd + row]
};

// rows [0, kTQ) of the block's R strip, factor columns [m0, m0 + mc)
__device__ __forceinline__ void load_r(const Tiles& t, const float* rb,
                                       int rows, int m_dim, int m0, int mc) {
  for (int i = threadIdx.x; i < kTQ * mc; i += kThreads) {
    const int row = i / mc;
    const int m = i - row * mc;
    t.rs[m * kLd + row] = row < rows ? rb[(size_t)row * m_dim + m0 + m] : 0.f;
  }
}

// This thread's 4 x 4 logits (rows ty*4 + i, keys k0 + tx*4 + j) of the key
// tile at k0; keys past nk come out as -inf. Leaves the K tile in t.kv.
template <typename T>
__device__ __forceinline__ void tile_logits(
    float (&lg)[4][4], const Tiles& t, const T* kb, const float* rb,
    const float* s, int rows, int nk, int d, int m_dim, bool r_resident,
    int k0, float scale) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  __syncthreads();  // the previous tile's readers are done with t.kv, t.ss
  const int keys = min(kTK, nk - k0);
  for (int i = threadIdx.x; i < kTK * d; i += kThreads) {
    const int key = i / d;
    const int c = i - key * d;
    t.kv[c * kLd + key] = key < keys ? to_float(kb[(size_t)k0 * d + i]) : 0.f;
  }
  float bias[4][4] = {};
  if (m_dim == 0) __syncthreads();
  for (int m0 = 0; m0 < m_dim; m0 += kMC) {
    const int mc = min(kMC, m_dim - m0);
    if (m0 > 0) __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < mc * kTK; i += kThreads) {
      const int m = i / kTK;
      const int key = i - m * kTK;
      t.ss[m * kLd + key] =
          key < keys ? s[(size_t)(m0 + m) * nk + k0 + key] : 0.f;
    }
    if (!r_resident) load_r(t, rb, rows, m_dim, m0, mc);
    __syncthreads();
    for (int m = 0; m < mc; ++m) {
      const float4 a = *reinterpret_cast<const float4*>(t.rs + m * kLd + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(t.ss + m * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) bias[i][j] = fmaf(av[i], bv[j], bias[i][j]);
    }
  }
  float acc[4][4] = {};
  for (int c = 0; c < d; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(t.qs + c * kLd + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(t.kv + c * kLd + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      lg[i][j] = tx * 4 + j < keys ? acc[i][j] * scale + bias[i][j]
                                   : -INFINITY;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    lowrank_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ r,
                   const float* __restrict__ s, T* __restrict__ out,
                   float* __restrict__ lse, int nq, int nk, int d, int m_dim,
                   int tiles, float scale) {
  extern __shared__ float smem[];
  Tiles t;
  t.qs = smem;
  t.kv = t.qs + d * kLd;
  t.rs = t.kv + d * kLd;
  t.ss = t.rs + kMC * kLd;
  t.ps = t.ss + kMC * kLd;

  const int bh = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - bh * tiles) * kTQ;
  const int rows = min(kTQ, nq - row0);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const T* qb = q + ((size_t)bh * nq + row0) * d;
  const T* kb = k + (size_t)bh * nk * d;
  const T* vb = v + (size_t)bh * nk * d;
  const float* rb = m_dim ? r + ((size_t)bh * nq + row0) * m_dim : nullptr;

  for (int i = threadIdx.x; i < kTQ * d; i += kThreads) {
    const int row = i / d;
    const int c = i - row * d;
    t.qs[c * kLd + row] = row < rows ? to_float(qb[i]) : 0.f;
  }
  const bool r_resident = m_dim <= kMC;
  if (m_dim && r_resident) load_r(t, rb, rows, m_dim, 0, m_dim);

  // pass 1: row max and sum
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  for (int k0 = 0; k0 < nk; k0 += kTK) {
    float lg[4][4];
    tile_logits(lg, t, kb, rb, s, rows, nk, d, m_dim, r_resident, k0, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(lg[i][0], lg[i][1]), fmaxf(lg[i][2], lg[i][3]));
      const float m_new = fmaxf(m_run[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(lg[i][j] - m_new);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + group_sum(sum);
      m_run[i] = m_new;
    }
  }

  // pass 2: weights rounded to v's dtype, P.V in f32
  const int cols = (d + 15) / 16;
  float acc[4][kMaxCols] = {};
  for (int k0 = 0; k0 < nk; k0 += kTK) {
    float lg[4][4];
    tile_logits(lg, t, kb, rb, s, rows, nk, d, m_dim, r_resident, k0, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t.ps[(tx * 4 + j) * kLd + ty * 4 + i] =
            to_float(from_float<T>(expf(lg[i][j] - m_run[i]) / l_run[i]));
    __syncthreads();  // the K tile is read, the weights are written
    const int keys = min(kTK, nk - k0);
    for (int i = threadIdx.x; i < kTK * d; i += kThreads)
      t.kv[i] = i < keys * d ? to_float(vb[(size_t)k0 * d + i]) : 0.f;
    __syncthreads();
    for (int key = 0; key < keys; ++key) {
      const float4 p =
          *reinterpret_cast<const float4*>(t.ps + key * kLd + ty * 4);
      const float* vr = t.kv + key * d;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j < cols) {
          const float x = vr[min(tx + 16 * j, d - 1)];
          acc[0][j] = fmaf(p.x, x, acc[0][j]);
          acc[1][j] = fmaf(p.y, x, acc[1][j]);
          acc[2][j] = fmaf(p.z, x, acc[2][j]);
          acc[3][j] = fmaf(p.w, x, acc[3][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row >= rows) continue;
    const size_t o = ((size_t)bh * nq + row0 + row) * d;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = tx + 16 * j;
      if (j < cols && c < d) out[o + c] = from_float<T>(acc[i][j]);
    }
    if (tx == 0) lse[(size_t)bh * nq + row0 + row] = m_run[i] + logf(l_run[i]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* r,
           const float* s, void* out, float* lse, int bh, int nq, int nk,
           int d, int m_dim, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lowrank_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (nq + kTQ - 1) / kTQ;
  const long long blocks = (long long)bh * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // the same scale as 1.0 / math.sqrt(d) rounded to f32
  const float scale = (float)(1.0 / std::sqrt((double)d));
  lowrank_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), r, s, static_cast<T*>(out), lse, nq, nk, d,
      m_dim, tiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); r, s and lse are
// float32; r and s may be null when m = 0. bh = batch x heads. Returns a
// cudaError_t (0 = launched); cudaErrorInvalidValue for a non-positive size,
// a negative m, a missing factor, a head dim above 128, or in bf16 more
// than 128 factor columns.
int mmcsi_flash_attention_lowrank(const void* q, const void* k, const void* v,
                                  const void* r, const void* s, void* out,
                                  void* lse, int bh, int nq, int nk, int d,
                                  int m, int dtype, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > kMaxD || m < 0)
    return (int)cudaErrorInvalidValue;
  if (m > 0 && (r == nullptr || s == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* rf = static_cast<const float*>(r);
  const float* sf = static_cast<const float*>(s);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(q, k, v, rf, sf, out, lf, bh, nq, nk, d, m, st);
    case 1: {
      tc::Params p = {};
      p.q = static_cast<const tc::bf16*>(q);
      p.k = static_cast<const tc::bf16*>(k);
      p.v = static_cast<const tc::bf16*>(v);
      p.out = static_cast<tc::bf16*>(out);
      p.r = rf;
      p.s = sf;
      p.lse = lf;
      p.groups = bh;
      p.heads = 1;
      p.nq = nq;
      p.nk = nk;
      p.d = d;
      p.m = m;
      p.row = d;
      return m ? tc::launch<true>(p, st) : tc::launch<false>(p, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
