// Fused multi-head attention softmax(q k^T / sqrt(D)) v for the THAT-family
// serving shapes, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel multi_modal_csi_tpu/kernels/flash_attention.py::
// flash_attention (body _kernel, pallas_call at :144). Its arithmetic:
//   - logits in f32 (bf16 products are exact in f32), times 1/sqrt(D) with
//     the true head dim D;
//   - row max, exp and sum in f32; weights = exp / sum, rounded to v's dtype
//     (the bf16 kernel rounds exp and divides by the sum at the end);
//   - P.V accumulated in f32; output stored in q's dtype.
// No mask, no dropout.
//
// Layout: q (B, Nq, H, D), k and v (B, Nk, H, D), contiguous, as the
// attention's projections produce them (token stride H*D). The TPU kernel's
// (B, H, D, N) transposes existed only for VMEM tiling; this kernel reads the
// projection layout directly, so the port adds no transposes.
//
// Two instantiations, chosen by dtype:
//
// bfloat16 (serving): the tensor-core kernel of tc_attention.cuh. One block
// of 4 warps per (b, 64 query rows, h), h fastest so the heads of one token
// row are read together; key tiles of 64 stream through a cp.async ring, QK^T
// and P.V on mma.sync m16n8k16 with f32 accumulators, one pass with an online
// softmax (the unnormalised weights rounded to bf16, the division at the end).
// The trap is alignment: a head's row is D * 2 = 54 bytes (D = 27) or 30
// (D = 15) at byte offsets 54 h, so no 16-byte copy fits; token rows of H*D =
// 270 or 150 elements are 4-byte aligned, so each head's row moves in aligned
// 4-byte pieces starting one element early where 54 h is not a multiple of 4,
// and lands at that shift in a tile zero-padded to 32 (D = 27, 45: 48) or 16
// (D = 15) positions; the stray positions are zeroed in the fragments. Keys
// stream, so any Nk runs; the launcher refuses only D > 128.
//
// float32 (training): one block per (b, h, tile of 64 query rows); 8 warps,
// one query row per warp at a time. The block stages that (b, h)'s whole K
// and V in shared memory as f32 (K with an odd row stride, so lanes reading
// different keys hit different banks), then each warp
//   1. computes its row's Nk logits, one key per lane, into a per-warp
//      shared-memory row;
//   2. reduces max and sum with warp shuffles and rounds the weights;
//   3. forms the output with lanes over the head dim; when D <= 16, two lane
//      groups split the keys and a shuffle adds their halves.
// K and V of one (b, h) must fit in shared memory (232,448 bytes a block);
// the launcher refuses larger Nk*D instead of running anything else.
//
// Bound on an H100 SXM. At the THAT serving shapes (bs256, bf16: left
// (256, 150, 10, 27), right (256, 270, 10, 15)) one launch reads q, k, v
// and writes out, 4 x 20.7 MB = 82.9 MB, about 25 us at 3.35 TB/s; its
// 6.2 (left) or 11.2 (right) GFLOP take 6 or 11 us at the 989 TFLOP/s bf16
// tensor-core peak. So the work is bound by bytes, and the bf16 kernel is
// judged by how close it comes to reading q, k and v once at full rate: the
// query tiles of one (b, h) re-read its K and V from L2, not from memory,
// and the 4-byte pieces of neighbouring heads share sectors. The f32 kernel
// runs its products on CUDA cores and is limited by its FMA rate.
//
// The launcher returns cudaGetLastError() so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "tc_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerBlock = 64;
constexpr size_t kMaxSharedBytes = 232448;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory in floats: K (Nk rows at odd stride), V (Nk x D), one
// weight row (Nk) and one query row (D) per warp.
size_t smem_bytes(int nk, int d) {
  return sizeof(float) * ((size_t)nk * (d | 1) + (size_t)nk * d +
                          (size_t)kWarps * nk + (size_t)kWarps * d);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int nq, int nk, int heads, int d, int tiles,
                           float scale) {
  extern __shared__ float smem[];
  const int k_stride = d | 1;
  float* ks = smem;
  float* vs = ks + (size_t)nk * k_stride;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ws = vs + (size_t)nk * d + (size_t)warp * nk;
  float* qs = vs + (size_t)nk * d + (size_t)kWarps * nk + (size_t)warp * d;

  const int bh = blockIdx.x / tiles;
  const int tile = blockIdx.x - bh * tiles;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const size_t tok = (size_t)heads * d;  // stride between tokens

  const T* kb = k + (size_t)b * nk * tok + (size_t)h * d;
  const T* vb = v + (size_t)b * nk * tok + (size_t)h * d;
  for (int i = threadIdx.x; i < nk * d; i += blockDim.x) {
    const int j = i / d;
    const int c = i - j * d;
    ks[j * k_stride + c] = to_float(kb[j * tok + c]);
    vs[i] = to_float(vb[j * tok + c]);
  }
  __syncthreads();

  // P.V lane split: dp lanes over the head dim (the smallest power of two
  // >= D, at most 32), 32 / dp groups over the keys.
  int dp = 1;
  while (dp < d && dp < 32) dp *= 2;
  const int groups = 32 / dp;
  const int g = lane / dp;
  const int c0 = lane - g * dp;

  const int row_end = min(nq, (tile + 1) * kRowsPerBlock);
  for (int row = tile * kRowsPerBlock + warp; row < row_end; row += kWarps) {
    const size_t qoff = ((size_t)b * nq + row) * tok + (size_t)h * d;
    for (int c = lane; c < d; c += 32) qs[c] = to_float(q[qoff + c]);
    __syncwarp();

    float m = -INFINITY;
    for (int j = lane; j < nk; j += 32) {
      const float* kr = ks + j * k_stride;
      float s = 0.f;
      for (int c = 0; c < d; ++c) s = fmaf(qs[c], kr[c], s);
      s *= scale;
      ws[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(ws[j] - m);
      ws[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < nk; j += 32)
      ws[j] = to_float(from_float<T>(ws[j] / l));
    __syncwarp();

    for (int base = 0; base < d; base += dp) {
      const int c = base + c0;
      float acc = 0.f;
      if (c < d)
        for (int j = g; j < nk; j += groups)
          acc = fmaf(ws[j], vs[j * d + c], acc);
      for (int o = dp; o < 32; o <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (g == 0 && c < d) out[qoff + c] = from_float<T>(acc);
    }
    __syncwarp();  // the next row overwrites qs and ws
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int nq, int nk, int heads, int d, cudaStream_t stream) {
  const size_t smem = smem_bytes(nk, d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (nq + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = (long long)batch * heads * tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // the same scale as 1.0 / math.sqrt(d) rounded to f32
  const float scale = (float)(1.0 / std::sqrt((double)d));
  flash_attention_kernel<T><<<(unsigned)blocks, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), nq, nk, heads, d, tiles,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a non-positive size, for f32 K and V that do
// not fit in shared memory, or for a bf16 head dim above 128.
int mmcsi_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int batch, int nq, int nk, int heads,
                          int d, int dtype, void* stream) {
  if (batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (smem_bytes(nk, d) > kMaxSharedBytes)
        return (int)cudaErrorInvalidValue;
      return launch<float>(q, k, v, out, batch, nq, nk, heads, d, s);
    case 1: {
      tc::Params p = {};
      p.q = static_cast<const tc::bf16*>(q);
      p.k = static_cast<const tc::bf16*>(k);
      p.v = static_cast<const tc::bf16*>(v);
      p.out = static_cast<tc::bf16*>(out);
      p.groups = batch;
      p.heads = heads;
      p.nq = nq;
      p.nk = nk;
      p.d = d;
      p.row = heads * d;
      return tc::launch<false>(p, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
