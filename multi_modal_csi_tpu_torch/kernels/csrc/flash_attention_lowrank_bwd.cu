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
//   - bfloat16 (bf16 training, opt-in), both kernels on the tensor cores
//     with bf16 q, k, v and dO: dQ/dR is the bf16 query pass with the
//     bias, tc::attention_bwd_dq_lowrank_bf16_kernel (the f32 pass's grid;
//     S, dP and dQ as bf16 mma.sync m16n8k16, dl split into bf16 hi + lo
//     for dQ; the bias and dR as 3xTF32), and dK/dV/dS the bf16 key-major
//     body, tc::attention_bwd_dkv_bf16_kernel (S^T, dP^T, dV and dK as
//     bf16 mma.sync m16n8k16, w and dl split into bf16 hi + lo; the bias
//     and dS as 3xTF32).
//
// Bound on an H100 SXM. The backward's products are 10 Nq Nk D operations
// at q's dtype (QK^T, dO V^T, dQ, dK, dV) and 6 Nq Nk M in f32 (the bias,
// dR, dS); the bytes (q, k, v, dO, r and the gradients once) are a few tens
// of MB, under 30 us at 3.35 TB/s. At MViT-v2's training blocks 0-2,
// batch 2, f32, that is 10.45 ms of operations at 67 TFLOP/s, or 5.88 ms
// with every product as 3xTF32 at 495 TFLOP/s: the work is bound by
// operations. Both kernels rebuild the logits and dO V^T (14 Nq Nk D
// + 8 Nq Nk M in all); in bf16 the head-dim products run at the bf16 rate
// and the bias products as 3xTF32.
//
// Limits: D <= 128 and M <= 128 (the instantiations' spans and m-tile
// buckets); any Nq, Nk >= 1, M >= 0; dK/dV/dS 1 <= splits <= ceil(Nq /
// 32), its query tile. The launchers refuse other sizes with
// cudaErrorInvalidValue and return cudaGetLastError() after the launch,
// so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_attention_bwd.cuh"

namespace {

constexpr int kMaxD = 128;

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

int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const float* r, const float* s, const void* dout,
                   const float* lse, const float* delta, void* dq, float* dr,
                   int bh, int nq, int nk, int d, int m, cudaStream_t stream) {
  tc::BwdParamsOf<__nv_bfloat16> p = bwd_params<__nv_bfloat16>(
      q, k, v, r, s, dout, lse, delta, bh, nq, nk, d, m);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dr = dr;
  return tc::launch_bwd_dq_lowrank_bf16(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and dq); r, s, lse,
// delta and dr are float32; r, s and dr may be null when m = 0. bh = batch
// x heads. Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for
// a non-positive size, a negative m, a missing factor, a head dim above
// 128 or m above 128.
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
      return launch_dq_bf16(q, k, v, rf, sf, dout, lf, df, dq, drf, bh, nq,
                            nk, d, m, st);
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
