// Backward of the fused attention softmax(q k^T / sqrt(D)) v for the
// THAT-family training shapes, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel multi_modal_csi_tpu/kernels/flash_attention.py::
// flash_attention_trainable (backward body _bwd_kernel_plain, pallas_call at
// :247). Same arithmetic, per (b, h), with no statistics saved by the
// forward:
//   - logits in f32, times 1/sqrt(D) with the true head dim D; row max, exp
//     and sum in f32; w = exp / sum in f32;
//   - dw = dO V^T in f32; dl = w * (dw - rowsum(dw * w)), f32;
//   - dQ = dl K * scale and dK = dl^T Q * scale from the f32 dl;
//     dV = bf(w)^T dO, with w rounded to dO's dtype first (:191);
//   - every sum in f32; dQ, dK, dV stored in the input dtype (:257-259).
// The wrapper casts dO to q's dtype before the launch, as the TPU kernel
// does (:239).
//
// Layout: q, dO (B, Nq, H, D) and k, v (B, Nk, H, D), contiguous, as the
// attention's projections produce them (token stride H*D). No transposes
// outside the kernels.
//
// Two instantiations, by dtype:
//   - float32 (THAT training): two kernels of the tensor-core backward body
//     of tc_attention_bwd.cuh, every product as 3xTF32 on mma.sync (that
//     header says how): the query pass (dQ, and each row's LSE and delta
//     into the caller's f32 work buffer), then the dK/dV pass, which reads
//     them. One block of the dK/dV pass takes every query tile of its key
//     block and writes the gradients in place: splitting the query range
//     over blocks, as K4 does, was slower at every THAT shape on an H100
//     (PERF.md).
//   - bfloat16: the CUDA-core kernel below.
//
// Design of the bfloat16 kernel. dK and dV sum over every query row of a
// (b, h), so one block owns one (b, h) and runs two passes over it, with no
// atomics and so a result that does not depend on scheduling order:
//   0. stage that (b, h)'s Q, dO, K and V in shared memory as f32, each with
//      an odd row stride so lanes reading different rows hit different
//      banks;
//   1. query pass: warps own query rows i. Lanes over keys j compute the
//      logits, the row max and sum (warp shuffles), w, dw and
//      delta_i = rowsum(dw * w); the row's dl goes to a per-warp
//      shared-memory row, from which lanes over the head dim form dQ_i.
//      The row's max, sum and delta stay in shared memory;
//   2. key pass: warps own key rows j. Lanes over query rows i recompute
//      the logit and dw exactly as pass 1 did (the same FMA order, so the
//      same w), form dl_ij and bf(w_ij) into two per-warp rows, from which
//      lanes over the head dim form dK_j and dV_j.
// Pass 2 recomputes QK^T and dO V^T, so the kernel does 7 instead of the
// 5 products of D-long dot products per (i, j).
//
// Bound on an H100 SXM. At THAT's training shapes (batch 16: left
// (16, 150, 10, 27) and right (16, 270, 10, 15)) one f32 launch reads q, k,
// v, dO and writes dQ, dK, dV: 7 x 2.6 MB = 18.1 MB, 5.4 us at 3.35 TB/s;
// its 10*B*H*Nq*Nk*D operations (0.97 GFLOP left, 1.75 right) take 14.5
// and 26.1 us at the 67 TFLOP/s f32 peak, 5.9 and 10.6 us as 3xTF32 at the
// 495 TFLOP/s TF32 peak, or 1.0 and 1.8 us at the 989 TFLOP/s bf16
// tensor-core peak. So f32 is bound by operations and bf16 by bytes. The
// bf16 kernel runs on the CUDA cores with one shared-memory load per FMA,
// so it is limited by shared-memory and FMA issue, and one block per (b,
// h) gives only B*H blocks (160 at batch 16 on 132 SMs).
//
// Limits: float32 takes D <= 128 at any Nq and Nk (its kernels stream
// their tiles: the query pass's shared memory depends on the span alone,
// the dK/dV pass's on the span); bfloat16 the shapes whose Q, dO, K and V
// of one (b, h) and the kernel's per-warp rows fit in shared memory
// (232,448 bytes a block; smem_bytes below). The wrapper's backward_fits
// says the same. The launcher refuses other shapes instead of running
// anything else, and returns cudaGetLastError() so a refused launch is
// seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "tc_attention_bwd.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr size_t kMaxSharedBytes = 232448;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of the bf16 kernel in floats, the entry check of both
// dtypes: Q and dO (Nq rows), K and V (Nk rows), all at the odd stride
// D | 1; the max, sum and delta of each query row; two rows of max(Nq, Nk)
// per warp.
size_t smem_bytes(int nq, int nk, int d) {
  const size_t stride = (size_t)(d | 1);
  const size_t row = (size_t)(nq > nk ? nq : nk);
  return sizeof(float) * (2 * (size_t)nq * stride + 2 * (size_t)nk * stride +
                          3 * (size_t)nq + 2 * (size_t)kWarps * row);
}

// Load one (b, h) slice of a (B, N, H, D) tensor into shared rows of stride
// ds.
__device__ __forceinline__ void stage(float* dst, const bf16* src, int n,
                                      int d, int ds, size_t tok) {
  for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    dst[r * ds + c] = __bfloat162float(src[r * tok + c]);
  }
}

// sum_c a[c] * b[c] in f32, c in order: pass 1 and pass 2 both call this,
// so both see the same logit and the same dw for an (i, j) pair.
__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_bwd_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               bf16* __restrict__ dq, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int nq, int nk,
                               int heads, int d, float scale) {
  extern __shared__ float smem[];
  const int ds = d | 1;
  const int row = nq > nk ? nq : nk;
  float* qs = smem;
  float* dos = qs + (size_t)nq * ds;
  float* ks = dos + (size_t)nq * ds;
  float* vs = ks + (size_t)nk * ds;
  float* row_max = vs + (size_t)nk * ds;
  float* row_sum = row_max + nq;
  float* row_delta = row_sum + nq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* r0 = row_delta + nq + (size_t)warp * 2 * row;
  float* r1 = r0 + row;

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const size_t tok = (size_t)heads * d;  // stride between tokens
  const size_t qoff = (size_t)b * nq * tok + (size_t)h * d;
  const size_t koff = (size_t)b * nk * tok + (size_t)h * d;
  stage(qs, q + qoff, nq, d, ds, tok);
  stage(dos, dout + qoff, nq, d, ds, tok);
  stage(ks, k + koff, nk, d, ds, tok);
  stage(vs, v + koff, nk, d, ds, tok);
  __syncthreads();

  // lane split of a product over a row: dp lanes over the head dim (the
  // smallest power of two >= D, at most 32), 32 / dp groups over the row
  int dp = 1;
  while (dp < d && dp < 32) dp *= 2;
  const int groups = 32 / dp;
  const int g = lane / dp;
  const int c0 = lane - g * dp;

  // pass 1: query rows; r0 holds the logits then w, r1 holds dl
  for (int i = warp; i < nq; i += kWarps) {
    const float* qi = qs + (size_t)i * ds;
    const float* doi = dos + (size_t)i * ds;
    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      const float s = dot(qi, ks + (size_t)j * ds, d) * scale;
      r0[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(r0[j] - m);
      r0[j] = e;
      l += e;
    }
    l = warp_sum(l);
    float delta = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float w = r0[j] / l;
      const float dw = dot(doi, vs + (size_t)j * ds, d);
      r0[j] = w;
      r1[j] = dw;
      delta = fmaf(dw, w, delta);
    }
    delta = warp_sum(delta);
    for (int j = lane; j < nk; j += 32) r1[j] = r0[j] * (r1[j] - delta);
    if (lane == 0) {
      row_max[i] = m;
      row_sum[i] = l;
      row_delta[i] = delta;
    }
    __syncwarp();

    const size_t out = qoff + (size_t)i * tok;
    for (int base = 0; base < d; base += dp) {
      const int c = base + c0;
      float acc = 0.f;
      if (c < d)
        for (int j = g; j < nk; j += groups)
          acc = fmaf(r1[j], ks[(size_t)j * ds + c], acc);
      for (int o = dp; o < 32; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (g == 0 && c < d) dq[out + c] = __float2bfloat16(acc * scale);
    }
    __syncwarp();  // the next row overwrites r0 and r1
  }
  __syncthreads();  // every row's max, sum and delta are in place

  // pass 2: key rows; r0 holds dl, r1 holds w rounded to bf16 (nearest
  // even, as astype does)
  for (int j = warp; j < nk; j += kWarps) {
    const float* kj = ks + (size_t)j * ds;
    const float* vj = vs + (size_t)j * ds;
    for (int i = lane; i < nq; i += 32) {
      const float s = dot(qs + (size_t)i * ds, kj, d) * scale;
      const float w = expf(s - row_max[i]) / row_sum[i];
      const float dw = dot(dos + (size_t)i * ds, vj, d);
      r0[i] = w * (dw - row_delta[i]);
      r1[i] = __bfloat162float(__float2bfloat16(w));
    }
    __syncwarp();

    const size_t out = koff + (size_t)j * tok;
    for (int base = 0; base < d; base += dp) {
      const int c = base + c0;
      float acc_k = 0.f;
      float acc_v = 0.f;
      if (c < d)
        for (int i = g; i < nq; i += groups) {
          acc_k = fmaf(r0[i], qs[(size_t)i * ds + c], acc_k);
          acc_v = fmaf(r1[i], dos[(size_t)i * ds + c], acc_v);
        }
      for (int o = dp; o < 32; o <<= 1) {
        acc_k += __shfl_xor_sync(0xffffffffu, acc_k, o);
        acc_v += __shfl_xor_sync(0xffffffffu, acc_v, o);
      }
      if (g == 0 && c < d) {
        dk[out + c] = __float2bfloat16(acc_k * scale);
        dv[out + c] = __float2bfloat16(acc_v);
      }
    }
    __syncwarp();
  }
}

int launch_bf16(const void* q, const void* k, const void* v,
                const void* dout, void* dq, void* dk, void* dv, int batch,
                int nq, int nk, int heads, int d, cudaStream_t stream) {
  const size_t smem = smem_bytes(nq, nk, d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)batch * heads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // the same scale as 1.0 / math.sqrt(d) rounded to f32
  const float scale = (float)(1.0 / std::sqrt((double)d));
  flash_attention_bwd_kernel<<<(unsigned)blocks, kWarps * 32, smem,
                               stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      nq, nk, heads, d, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, dout and the three
// gradients alike; float32 also takes `work`, f32 (2, batch x heads, nq),
// for the rows' LSE and then delta (bfloat16 does not read it). Returns a
// cudaError_t (0 = launched); cudaErrorInvalidValue for a non-positive
// size, float32 at d > 128, or in bfloat16 a (b, h) that does not fit in
// shared memory.
int mmcsi_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* work, int batch, int nq, int nk,
                              int heads, int d, int dtype, void* stream) {
  if (batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      tc::BwdParams p = {};
      p.q = static_cast<const float*>(q);
      p.k = static_cast<const float*>(k);
      p.v = static_cast<const float*>(v);
      p.dout = static_cast<const float*>(dout);
      p.bh = batch * heads;
      p.lse = static_cast<float*>(work);
      p.delta = p.lse + (long long)p.bh * nq;
      p.dq = static_cast<float*>(dq);
      p.dk = static_cast<float*>(dk);
      p.dv = static_cast<float*>(dv);
      p.heads = heads;
      p.nq = nq;
      p.nk = nk;
      p.d = d;
      p.row = heads * d;
      p.splits = 1;  // the gradients in place
      return tc::launch_bwd_f32(p, s);
    }
    case 1:
      if (smem_bytes(nq, nk, d) > kMaxSharedBytes)
        return (int)cudaErrorInvalidValue;
      return launch_bf16(q, k, v, dout, dq, dk, dv, batch, nq, nk, heads, d,
                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
