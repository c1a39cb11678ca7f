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
// Both dtypes run two kernels of the tensor-core backward body of
// tc_attention_bwd.cuh (that header says how each works): the query pass
// (dQ, and each row's LSE and delta into the caller's f32 work buffer
// (2, B*H, Nq)), then the dK/dV pass, which reads them. One block of the
// dK/dV pass takes every query tile of its key block and writes the
// gradients in place: splitting the query range over blocks, as K4 does,
// was slower at every THAT shape on an H100 (PERF.md).
//   - float32 (THAT training): every product as 3xTF32 on mma.sync
//     m16n8k8 (tc::attention_bwd_dq_f32_kernel, then
//     tc::attention_bwd_dkv_f32_kernel without the bias).
//   - bfloat16 (bf16 training): the bf16 query pass
//     (tc::attention_bwd_dq_bf16_kernel: S, dP on bf16 mma.sync m16n8k16,
//     dQ from dl split into bf16 hi + lo), then the bf16 dK/dV body in
//     K2's form (tc::attention_bwd_dkv_bf16_kernel<KS, 0, 2, true>: dV
//     from w rounded once to bf16, as the TPU kernel's w.astype; dK from
//     dl's hi + lo; dK and dV rounded to bf16 in place). At THAT's odd
//     heads (D = 27, 15) no copy wider than one bf16 divides D, so both
//     kernels copy each head's rows as K1's bf16 body does, in aligned
//     4-byte pieces from h D - sh on, and mask the stray positions in
//     their fragments (tc_attention_bwd.cuh, The bf16 copies of K2): on
//     an H100 that took 0.3917 ms per THAT bf16 step against 0.5836 with
//     element-by-element copies (PERF.md).
//
// Bound on an H100 SXM. At THAT's training shapes (batch 16: left
// (16, 150, 10, 27) and right (16, 270, 10, 15)) one f32 launch reads q, k,
// v, dO and writes dQ, dK, dV: 7 x 2.6 MB = 18.1 MB, 5.4 us at 3.35 TB/s;
// its 10*B*H*Nq*Nk*D operations (0.97 GFLOP left, 1.75 right) take 14.5
// and 26.1 us at the 67 TFLOP/s f32 peak, 5.9 and 10.6 us as 3xTF32 at the
// 495 TFLOP/s TF32 peak, or 1.0 and 1.8 us at the 989 TFLOP/s bf16
// tensor-core peak. So f32 is bound by operations and bf16 (half the
// bytes, 2.7 us) by bytes. The query pass forms S and dP in both of its
// sweeps and the dK/dV pass forms them again: 9 products over D a (query,
// key) pair where 5 would do.
//
// Limits: D <= 128 at any Nq and Nk in both dtypes (the kernels stream
// their tiles: each pass's shared memory depends on the span alone). The
// wrapper's backward_fits says the same. The launcher refuses other shapes
// instead of running anything else, and returns cudaGetLastError() so a
// refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_attention_bwd.cuh"

namespace {

// both dtypes' parameters (T: float or bf16): the inputs, each (b, h) a
// group with rows of heads * d, the work buffer's LSE and delta, one split
template <typename T>
tc::BwdParamsOf<T> k2_params(const void* q, const void* k, const void* v,
                             const void* dout, void* work, int batch, int nq,
                             int nk, int heads, int d) {
  tc::BwdParamsOf<T> p = {};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.dout = static_cast<const T*>(dout);
  p.bh = batch * heads;
  p.lse = static_cast<float*>(work);
  p.delta = p.lse + (long long)p.bh * nq;
  p.heads = heads;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.row = heads * d;
  p.splits = 1;  // the gradients in place
  return p;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, dout and the three
// gradients alike; `work` is f32 (2, batch x heads, nq) for the rows' LSE
// and then delta. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a non-positive size or d > 128.
int mmcsi_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* dout, void* dq, void* dk, void* dv,
                              void* work, int batch, int nq, int nk,
                              int heads, int d, int dtype, void* stream) {
  if (batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      tc::BwdParams p =
          k2_params<float>(q, k, v, dout, work, batch, nq, nk, heads, d);
      p.dq = static_cast<float*>(dq);
      p.dk = static_cast<float*>(dk);
      p.dv = static_cast<float*>(dv);
      return tc::launch_bwd_f32(p, s);
    }
    case 1: {
      tc::BwdParamsOf<__nv_bfloat16> p = k2_params<__nv_bfloat16>(
          q, k, v, dout, work, batch, nq, nk, heads, d);
      p.dq = static_cast<__nv_bfloat16*>(dq);
      p.dk_out = static_cast<__nv_bfloat16*>(dk);
      p.dv_out = static_cast<__nv_bfloat16*>(dv);
      return tc::launch_bwd_bf16(p, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
