// Fused multi-head attention softmax(q k^T / sqrt(D)) v for the THAT
// family's serving (bf16) and training (f32) shapes, written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel multi_modal_csi_tpu/kernels/flash_attention.py::
// flash_attention (body _kernel, pallas_call at :144). Its arithmetic:
//   - logits in f32 (bf16 products are exact in f32), times 1/sqrt(D) with
//     the true head dim D;
//   - row max, exp and sum in f32; weights = exp / sum, rounded to v's dtype
//     (both instantiations here divide by the sum at the end instead);
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
// float32 (training): the f32 body of tc_attention.cuh, the one K3's f32
// instantiation runs, at f32 precision on the tensor cores: the same blocks
// over (b, query tile, h), h fastest, and the same streamed key tiles and
// online softmax, with q.k as 3xTF32 mma.sync m16n8k8 (each f32 factor split
// into tf32 hi + lo; lo.hi + hi.lo summed apart from each k-step's hi.hi),
// the weights exp(logit - m) kept in f32, each key tile's P.V as 3xTF32
// added to the rescaled output, and the division by l at the end. The TPU
// kernel (and the plain version) divide before P.V instead; both orders are
// f32-exact to about 2^-22 a product. A head's row of D = 27 or 15 floats
// sits at an odd offset 27 h or 15 h of its token row, so the launcher takes
// the widest copy that divides D, the row and the base addresses (4-byte
// cp.async at THAT's heads); no head is shifted and no neighbouring head's
// element is read, and the span's columns past D are zeroed once in shared
// memory. Keys stream, so any Nk runs; the launcher refuses only D > 128.
// The configuration is the launcher's rule, tc::launch_f32_span: THAT's
// heads span one or two k-steps of 16, so a block's work is small and the
// rule takes 4 warps over 64 query rows with 32-key tiles and registers
// for 4 blocks an SM, for the number of warps in flight.
//
// Bound on an H100 SXM. At the THAT serving shapes (bs256, bf16: left
// (256, 150, 10, 27), right (256, 270, 10, 15)) one launch reads q, k, v
// and writes out, 4 x 20.7 MB = 82.9 MB, about 25 us at 3.35 TB/s; its
// 6.2 (left) or 11.2 (right) GFLOP take 6 or 11 us at the 989 TFLOP/s bf16
// tensor-core peak. So the work is bound by bytes, and the bf16 kernel is
// judged by how close it comes to reading q, k and v once at full rate: the
// query tiles of one (b, h) re-read its K and V from L2, not from memory,
// and the 4-byte pieces of neighbouring heads share sectors.
// f32 at THAT's training batch of 16: left (16, 150, 10, 27) moves 10.4 MB
// (3.1 us) for 0.39 GFLOP, 5.8 us at the 67 TFLOP/s f32 peak and 2.4 us as
// 3xTF32 (three TF32 products over the 495 TFLOP/s TF32 peak); right
// (16, 270, 10, 15) 10.4 MB (3.1 us) for 0.70 GFLOP, 10.4 or 4.2 us;
// THAT_ENCODER's right (16, 270, 10, 27) 18.7 MB (5.6 us) for 1.26 GFLOP,
// 18.8 or 7.6 us. Per THAT step (4 left + 1 right) that is 0.034 ms at
// the f32 peak and 0.017 as 3xTF32 (THAT_ENCODER 0.042 and 0.020): a few
// microseconds a launch, so the kernel is held by latency (the prologue's
// copies, a few key tiles a row block in sequence) and by how many blocks
// the card holds at once, not by either rate.
//
// The launcher returns cudaGetLastError() so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_attention.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched);
// cudaErrorInvalidValue for a non-positive size or a head dim above 128.
int mmcsi_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int batch, int nq, int nk, int heads,
                          int d, int dtype, void* stream) {
  if (batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      tc::ParamsOf<float> p = {};  // r, s and lse null: no bias, no LSE
      p.q = static_cast<const float*>(q);
      p.k = static_cast<const float*>(k);
      p.v = static_cast<const float*>(v);
      p.out = static_cast<float*>(out);
      p.groups = batch;
      p.heads = heads;
      p.nq = nq;
      p.nk = nk;
      p.d = d;
      p.row = heads * d;
      return tc::launch_f32<false>(p, s);
    }
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
