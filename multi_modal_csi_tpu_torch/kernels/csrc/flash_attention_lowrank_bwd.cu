// Flash backward of the attention with a low-rank additive bias,
//   out = softmax(q k^T * scale + r s) v,   scale = 1/sqrt(D),
// for MViT's pooling attention in training, written by hand for Hopper
// (sm_90a): the gradients with respect to q, k, v and the bias factors r, s.
//
// Replaces the two TPU kernels of multi_modal_csi_tpu/kernels/
// flash_attention.py::flash_attention_lowrank_bias_trainable (backward
// _flash_lowrank_bwd :550): the dQ/dR kernel _tiled_bwd_dq_kernel (:480,
// pallas_call :591) and the dK/dV/dS kernel _tiled_bwd_dkv_kernel (:492,
// pallas_call :632), both built on _bwd_tile_wdl (:457). Same arithmetic,
// every value in f32 (bf16 inputs convert exactly):
//   logits = (q . k) * scale + (r . s)
//   w  = exp(logits - lse)            lse from the forward (K3), kept in f32
//   dw = dO . v
//   dl = w * (dw - delta)             delta = rowsum(dO * out), the wrapper's
//   dQ = (dl . k) * scale,  dR = dl . s^T            per query row
//   dV = w^T . dO,  dK = (dl^T . q) * scale,  dS = r^T . dl    per key
// dV takes the unrounded f32 weights, as the TPU kernel does. dQ is stored
// in q's dtype and dR in f32; dK, dV and dS are stored as f32 partials.
// r (B, H, Nq, M) and s (M, Nk) are f32; M = 0 means no bias (MViT-v1).
// No (Nq, Nk) matrix ever leaves the chip.
//
// Layout, all contiguous: q, dO, dQ (BH, Nq, D); k, v (BH, Nk, D); r, dR
// (BH, Nq, M); s (M, Nk); lse, delta (BH, Nq); the partials dK, dV
// (splits, BH, Nk, D) and dS (splits, BH, M, Nk). The wrapper sums the
// partials over the splits, and dS over BH as well, in a fixed order: no
// atomics anywhere, so the gradients repeat run to run. The TPU's padding
// folded into the factors (_fold_pad) became loops bounded by the true Nq,
// Nk and M.
//
// What runs where (tc_attention_bwd.cuh says how each tensor-core body
// works); each launcher refuses D > 128 or M > 128 and never runs another
// kernel:
//   - float32 (MViT training's default), both kernels on the tensor cores,
//     every product at f32 precision as 3xTF32: dQ/dR is the query pass
//     with the bias, tc::attention_bwd_dq_lowrank_f32_kernel (8 warps of
//     16 query rows, one sweep over 32-key tiles, the forward's LSE and
//     delta read once a row), and dK/dV/dS the key-major body,
//     tc::attention_bwd_dkv_f32_kernel;
//   - bfloat16 (bf16 training, opt-in): dK/dV/dS is the bf16 key-major
//     body, tc::attention_bwd_dkv_bf16_kernel (S^T, dP^T, dV and dK as
//     bf16 mma.sync m16n8k16, w and dl split into bf16 hi + lo; the bias
//     and dS as 3xTF32); dQ/dR is still dq_kernel below, on the CUDA
//     cores (M <= 128 is not its limit: it streams the bias in chunks).
//
// dq_kernel (bfloat16 only). Neither K and V (1128 keys of D = 96 are 866
// KB in f32) nor Q and dO (72129 rows) of one (b, h) fit in a block's
// shared memory, so it streams key tiles of 64 and rebuilds each (64 query
// x 64 key) block of logits: one block per (b h, 64 query rows), 256
// threads as 16 x 16, each a 4 x 4 register tile, the transposed tiles read
// as float4, the bias factors streamed in chunks of 64 columns. Q^T, dO^T
// and (M <= 64) the R strip stay in shared memory (153 KB at MViT's D = 96,
// 187 KB at D = 128: one block an SM). dl goes to shared memory, and each
// thread accumulates a 4 row x D/16 column slice of dQ and a 4 x 4 slice
// of dR (M <= 64) in registers; for M > 64 each chunk's dR is added to the
// block's own rows in device memory.
//
// Bound on an H100 SXM. The backward's products are 10 Nq Nk D operations
// at q's dtype (QK^T, dO V^T, dQ, dK, dV) and 6 Nq Nk M in f32 (the bias,
// dR, dS); the bytes (q, k, v, dO, r and the gradients once) are a few tens
// of MB, under 30 us at 3.35 TB/s. At MViT-v2's training blocks 0-2,
// batch 2, f32, that is 10.45 ms of operations at 67 TFLOP/s, or 5.88 ms
// with every product as 3xTF32 at 495 TFLOP/s: the work is bound by
// operations. Every kernel rebuilds the logits and dO V^T (14 Nq Nk D
// + 8 Nq Nk M in all); dq_kernel runs every product as an f32 FMA and is
// limited by the rate of FMA instructions.
//
// Limits: D <= 128 (the tiles in shared memory); any Nq, Nk >= 1, M >= 0
// (M <= 128 but in dq_kernel); dK/dV/dS 1 <= splits <= ceil(Nq / 32), its
// query tile. The launchers refuse other sizes with cudaErrorInvalidValue
// and return cudaGetLastError() after the launch, so a refused launch is
// seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "tc_attention_bwd.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each 4 x 4 of a tile
constexpr int kTQ = 64;        // query rows per tile
constexpr int kTK = 64;        // keys per tile
constexpr int kMC = 64;        // bias factor columns per chunk
constexpr int kMaxD = 128;
constexpr int kMaxCols = kMaxD / 16;  // head-dim columns per thread
constexpr int kLd = 68;        // row stride of the 64-wide tiles (floats):
                               // float4-aligned, transposed stores 4-way

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ void unpack(const float4 a, float (&v)[4]) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// acc[i][j] += sum_c a[c][ty*4 + i] * b[c][tx*4 + j] over c < n, the two
// operands stored transposed (a[c * kLd + row], b[c * kLd + col])
__device__ __forceinline__ void outer_sum(float (&acc)[4][4], const float* a,
                                          const float* b, int n) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  for (int c = 0; c < n; ++c) {
    float av[4], bv[4];
    unpack(*reinterpret_cast<const float4*>(a + c * kLd + ty * 4), av);
    unpack(*reinterpret_cast<const float4*>(b + c * kLd + tx * 4), bv);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// rows [0, n) of the row-major (., d) array x into dst[c * kLd + row] as
// f32, 64 rows; rows past n are zero
template <typename T>
__device__ __forceinline__ void load_t(float* dst, const T* x, int n, int d) {
  for (int i = threadIdx.x; i < 64 * d; i += kThreads) {
    const int row = i / d;
    const int c = i - row * d;
    dst[c * kLd + row] = row < n ? to_float(x[i]) : 0.f;
  }
}

// columns [m0, m0 + mc) of rows [0, n) of a row-major (., m_dim) f32 array
// into dst[m * kLd + row]; rows past n are zero
__device__ __forceinline__ void load_cols(float* dst, const float* x, int n,
                                          int m_dim, int m0, int mc) {
  for (int i = threadIdx.x; i < 64 * mc; i += kThreads) {
    const int row = i / mc;
    const int m = i - row * mc;
    dst[m * kLd + row] = row < n ? x[(size_t)row * m_dim + m0 + m] : 0.f;
  }
}

// rows [m0, m0 + mc) of s (m_dim, nk), keys [k0, k0 + n) into
// dst[m * kLd + key]; keys past n are zero
__device__ __forceinline__ void load_s(float* dst, const float* s, int n,
                                       int nk, int k0, int m0, int mc) {
  for (int i = threadIdx.x; i < mc * kTK; i += kThreads) {
    const int m = i / kTK;
    const int key = i - m * kTK;
    dst[m * kLd + key] = key < n ? s[(size_t)(m0 + m) * nk + k0 + key] : 0.f;
  }
}

// dq_kernel's shared memory: four (D x kLd) f32 tiles and three
// (64 x kLd) ones
size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(4 * d + 3 * 64) * kLd;
}

// One block per (b h, 64 query rows): dQ and dR. Instantiated for
// bfloat16 only; float32 runs tc::attention_bwd_dq_lowrank_f32_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ r,
              const float* __restrict__ s, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, float* __restrict__ dr, int nq, int nk,
              int d, int m_dim, int tiles, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;             // Q^T   qs[c * kLd + row]
  float* dos = qs + d * kLd;    // dO^T  dos[c * kLd + row]
  float* ks = dos + d * kLd;    // K^T   ks[c * kLd + key]
  float* vs = ks + d * kLd;     // V^T   vs[c * kLd + key]
  float* rs = vs + d * kLd;     // R^T   rs[m * kLd + row]
  float* ss = rs + kMC * kLd;   // S     ss[m * kLd + key]
  float* ps = ss + kMC * kLd;   // dl^T  ps[key * kLd + row]

  const int bh = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - bh * tiles) * kTQ;
  const int rows = min(kTQ, nq - row0);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t qoff = (size_t)bh * nq + row0;
  const T* kb = k + (size_t)bh * nk * d;
  const T* vb = v + (size_t)bh * nk * d;
  const float* rb = m_dim ? r + qoff * m_dim : nullptr;
  float* drb = m_dim ? dr + qoff * m_dim : nullptr;
  const bool r_resident = m_dim <= kMC;

  load_t(qs, q + qoff * d, rows, d);
  load_t(dos, dout + qoff * d, rows, d);
  if (m_dim && r_resident) load_cols(rs, rb, rows, m_dim, 0, m_dim);

  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    lse_r[i] = row < rows ? lse[qoff + row] : 0.f;
    delta_r[i] = row < rows ? delta[qoff + row] : 0.f;
    // dR over several chunks is summed in device memory: start at zero
    if (!r_resident && row < rows)
      for (int m = tx; m < m_dim; m += 16) drb[(size_t)row * m_dim + m] = 0.f;
  }

  const int cols = (d + 15) / 16;
  float acc[4][kMaxCols] = {};
  float dr_acc[4][4] = {};
  for (int k0 = 0; k0 < nk; k0 += kTK) {
    const int keys = min(kTK, nk - k0);
    __syncthreads();  // the previous tile's readers are done
    load_t(ks, kb + (size_t)k0 * d, keys, d);
    load_t(vs, vb + (size_t)k0 * d, keys, d);

    // the bias (r . s) of the tile, chunk by chunk
    float bias[4][4] = {};
    for (int m0 = 0; m0 < m_dim; m0 += kMC) {
      const int mc = min(kMC, m_dim - m0);
      if (m0 > 0) __syncthreads();  // the previous chunk's readers are done
      load_s(ss, s, keys, nk, k0, m0, mc);
      if (!r_resident) load_cols(rs, rb, rows, m_dim, m0, mc);
      __syncthreads();
      outer_sum(bias, rs, ss, mc);
    }
    if (m_dim == 0) __syncthreads();
    float lg[4][4] = {}, dw[4][4] = {};
    outer_sum(lg, qs, ks, d);
    outer_sum(dw, dos, vs, d);

    // dl = w (dw - delta), w = exp(logits - lse) in f32; 0 past the keys
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float w = tx * 4 + j < keys
                            ? expf(lg[i][j] * scale + bias[i][j] - lse_r[i])
                            : 0.f;
        ps[(tx * 4 + j) * kLd + ty * 4 + i] = w * (dw[i][j] - delta_r[i]);
      }
    __syncthreads();

    // dQ += dl K (scaled at the end)
    for (int key = 0; key < keys; ++key) {
      float p[4];
      unpack(*reinterpret_cast<const float4*>(ps + key * kLd + ty * 4), p);
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j) {
        if (j < cols) {
          const float x = ks[min(tx + 16 * j, d - 1) * kLd + key];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
        }
      }
    }

    // dR += dl S^T
    if (m_dim && r_resident) {
      for (int key = 0; key < keys; ++key) {
        float p[4];
        unpack(*reinterpret_cast<const float4*>(ps + key * kLd + ty * 4), p);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = ss[min(tx + 16 * j, m_dim - 1) * kLd + key];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dr_acc[i][j] = fmaf(p[i], x, dr_acc[i][j]);
        }
      }
    } else if (m_dim) {
      for (int m0 = 0; m0 < m_dim; m0 += kMC) {
        const int mc = min(kMC, m_dim - m0);
        __syncthreads();  // the previous chunk's readers are done
        load_s(ss, s, keys, nk, k0, m0, mc);
        __syncthreads();
        float part[4][4] = {};
        for (int key = 0; key < keys; ++key) {
          float p[4];
          unpack(*reinterpret_cast<const float4*>(ps + key * kLd + ty * 4),
                 p);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x = ss[min(tx + 16 * j, mc - 1) * kLd + key];
#pragma unroll
            for (int i = 0; i < 4; ++i) part[i][j] = fmaf(p[i], x, part[i][j]);
          }
        }
        // this thread's own elements of the block's own rows: no race
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = tx + 16 * j;
            if (row < rows && m < mc)
              drb[(size_t)row * m_dim + m0 + m] += part[i][j];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (row >= rows) continue;
    const size_t o = (qoff + row) * d;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int c = tx + 16 * j;
      if (j < cols && c < d) dq[o + c] = from_float<T>(acc[i][j] * scale);
    }
    if (m_dim && r_resident) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = tx + 16 * j;
        if (m < m_dim) drb[(size_t)row * m_dim + m] = dr_acc[i][j];
      }
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// the same scale as 1.0 / math.sqrt(d) rounded to f32
float head_scale(int d) { return (float)(1.0 / std::sqrt((double)d)); }

bool sizes_ok(int bh, int nq, int nk, int d, int m, const void* r,
              const void* s) {
  if (bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > kMaxD || m < 0)
    return false;
  return m == 0 || (r != nullptr && s != nullptr);
}

// the tensor-core launchers' parameters (T: float or bf16): the inputs,
// one head a group and a row of D ((BH, N, D))
template <typename T>
tc::BwdParamsOf<T> bwd_params(const void* q, const void* k, const void* v,
                              const float* r, const float* s,
                              const void* dout, const float* lse,
                              const float* delta, int bh, int nq, int nk,
                              int d, int m) {
  tc::BwdParamsOf<T> p = {};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.r = r;
  p.s = s;
  p.dout = static_cast<const T*>(dout);
  p.lse = const_cast<float*>(lse);  // read only by K4's kernels
  p.delta = const_cast<float*>(delta);
  p.bh = bh;
  p.heads = 1;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.m = m;
  p.row = d;
  return p;
}

int launch_dq_f32(const void* q, const void* k, const void* v, const float* r,
                  const float* s, const void* dout, const float* lse,
                  const float* delta, void* dq, float* dr, int bh, int nq,
                  int nk, int d, int m, cudaStream_t stream) {
  tc::BwdParams p = bwd_params<float>(q, k, v, r, s, dout, lse, delta, bh,
                                      nq, nk, d, m);
  p.dq = static_cast<float*>(dq);
  p.dr = dr;
  return tc::launch_bwd_dq_lowrank_f32(p, stream);
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const float* r,
              const float* s, const void* dout, const float* lse,
              const float* delta, void* dq, float* dr, int bh, int nq, int nk,
              int d, int m, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  const int err = allow_smem(dq_kernel<T>, smem);
  if (err != 0) return err;
  const int tiles = (nq + kTQ - 1) / kTQ;
  const long long blocks = (long long)bh * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  dq_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), r, s, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), dr, nq, nk, d, m, tiles, head_scale(d));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and dq); r, s, lse,
// delta and dr are float32; r, s and dr may be null when m = 0. bh = batch
// x heads. Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for
// a non-positive size, a negative m, a missing factor, a head dim above
// 128, or in float32 (the tensor-core query pass) m above 128.
int mmcsi_flash_attention_lowrank_bwd_dq(
    const void* q, const void* k, const void* v, const void* r,
    const void* s, const void* dout, const void* lse, const void* delta,
    void* dq, void* dr, int bh, int nq, int nk, int d, int m, int dtype,
    void* stream) {
  if (!sizes_ok(bh, nq, nk, d, m, r, s) || (m > 0 && dr == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* rf = static_cast<const float*>(r);
  const float* sf = static_cast<const float*>(s);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* drf = static_cast<float*>(dr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_dq_f32(q, k, v, rf, sf, dout, lf, df, dq, drf, bh, nq, nk,
                           d, m, st);
    case 1:
      return launch_dq<__nv_bfloat16>(q, k, v, rf, sf, dout, lf, df, dq, drf,
                                      bh, nq, nk, d, m, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As above, with the f32 partials dk, dv (splits, bh, nk, d) and ds
// (splits, bh, m, nk; may be null when m = 0); 1 <= splits <= ceil(nq / 32)
// (the tensor-core bodies' query tile); both dtypes also refuse m > 128.
int mmcsi_flash_attention_lowrank_bwd_dkv(
    const void* q, const void* k, const void* v, const void* r,
    const void* s, const void* dout, const void* lse, const void* delta,
    void* dk, void* dv, void* ds, int bh, int nq, int nk, int d, int m,
    int splits, int dtype, void* stream) {
  if (!sizes_ok(bh, nq, nk, d, m, r, s) || (m > 0 && ds == nullptr) ||
      splits < 1 || splits > (nq + tc::kBwdRows - 1) / tc::kBwdRows)
    return (int)cudaErrorInvalidValue;
  const float* rf = static_cast<const float*>(r);
  const float* sf = static_cast<const float*>(s);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto partials = [&](auto p) {
    p.dk = static_cast<float*>(dk);
    p.dv = static_cast<float*>(dv);
    p.ds = static_cast<float*>(ds);
    p.part = (long long)bh * nk * d;
    p.splits = splits;
    return p;
  };
  switch (dtype) {
    case 0: {
      const tc::BwdParams p = partials(
          bwd_params<float>(q, k, v, rf, sf, dout, lf, df, bh, nq, nk, d, m));
      return tc::launch_bwd_dkv_f32(p, st);
    }
    case 1: {
      const tc::BwdParamsOf<__nv_bfloat16> p =
          partials(bwd_params<__nv_bfloat16>(q, k, v, rf, sf, dout, lf, df,
                                             bh, nq, nk, d, m));
      return tc::launch_bwd_dkv_bf16(p, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Keys per block of the dK/dV/dS kernel of `dtype` (0 float32, 1
// bfloat16) at head dim d and m bias factor columns (128, or 64 where two
// warps share a key strip), 0 for sizes or a dtype it refuses: the
// wrapper's grid of splits is sized by it.
int mmcsi_flash_attention_lowrank_bwd_dkv_keys(int d, int m, int dtype) {
  return dtype == 0 || dtype == 1 ? tc::bwd_dkv_keys(d, m) : 0;
}

}  // extern "C"
