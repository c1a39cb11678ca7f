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
// through in tiles: of 64 in bf16; of 64 in f32 where the 8-warp
// configuration's tiles fit in shared memory (MViT's D = 96 and M <= 64),
// else of 32.
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
// float32 (training's forward): the f32 body of tc_attention.cuh, on the
// same ring, tile loop and online softmax at f32 precision. One block of 8
// warps per (b h, 128 query rows) with key tiles of 64 where those tiles
// fit in shared memory (MViT's D = 96 and M <= 64), else 4 warps per 64
// rows with tiles of 32. QK^T and P.V run on mma.sync m16n8k8 as 3xTF32
// (each factor split into tf32 hi + lo with cvt.rna; lo hi + hi lo and
// each k-step's hi hi summed apart in f32, as the tensor cores truncate
// the addends of one mma to the largest), so those products keep f32's
// precision; one pass computes each logit once; the weights stay f32 (v's
// dtype: the TPU kernel's rounding to it is the identity), each tile's
// P.V is added to the rescaled output, and the division by the row sum
// comes once, at the end; the LSE is m + log(l) in f32.
//
// The bias r s runs on the CUDA cores: per logit one FMA chain over the
// factor columns in order, as the plain version's f32 GEMM forms it (bit
// for bit on an H100). At MViT's shapes with unit-normal factors of rank
// 37-51 the bias reaches about 40 and that GEMM's own rounding about 1.9e-5
// (against float64), the size of the 2e-5 tolerance: a 3xTF32 bias, closer
// to float64 than the plain version, still landed 2.03e-5 from it.
//
// Bound on an H100 SXM. At MViT's serving shapes (batch 2, bf16) a block's
// launch reads q, k, v, r and s and writes out and lse once: 2 x 72129 x 96
// x 2 bytes of q at block 0, a few tens of MB at most, under 20 us at 3.35
// TB/s. Its products are 4 Nq Nk D operations in bf16 and 2 Nq Nk M in f32
// for the bias: at block 0, 62 G and 12 G, 63 us and 180 us at the 989
// TFLOP/s bf16 and 67 TFLOP/s f32 peaks. So the work is bound by
// operations: MViT-v1's forward by the bf16 tensor cores (0.482 ms for its
// 16 calls), MViT-v2's by the bias product. The bf16 kernel computes the
// bias as three TF32 products (495 TFLOP/s), so its MViT-v2 bound is
// 1.135 ms; what remains is the softmax's exp and rescaling, the bias's
// tf32 splits and the shared-memory fragment loads. At the training blocks
// 0-2 in f32 the operations take 4.03 ms a MViT-v2 step at the 67 TFLOP/s
// f32 peak, 1.64 ms with every product as 3xTF32. The f32 kernel runs
// three tf32 mma.sync per product and splits each K, V, Q and weight
// fragment in every warp that loads it; the bias's FMA chain runs at the
// CUDA cores' rate.
//
// Limits: D <= 128 and M <= 128 in both dtypes (the R strip and the S ring
// in shared memory); any Nq, Nk >= 1. The launcher refuses other sizes and
// returns cudaGetLastError() so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tc_attention.cuh"

namespace {

constexpr int kMaxD = 16 * tc::kMaxSteps;

template <typename T>
tc::ParamsOf<T> params(const void* q, const void* k, const void* v,
                       const void* r, const void* s, void* out, void* lse,
                       int bh, int nq, int nk, int d, int m) {
  tc::ParamsOf<T> p = {};
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.out = static_cast<T*>(out);
  p.r = static_cast<const float*>(r);
  p.s = static_cast<const float*>(s);
  p.lse = static_cast<float*>(lse);
  p.groups = bh;
  p.heads = 1;
  p.nq = nq;
  p.nk = nk;
  p.d = d;
  p.m = m;
  p.row = d;
  return p;
}

bool refused(const void* r, const void* s, int bh, int nq, int nk, int d,
             int m) {
  return bh <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > kMaxD || m < 0 ||
         m > tc::kMaxRank || (m > 0 && (r == nullptr || s == nullptr));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out); r, s and lse are
// float32; r and s may be null when m = 0. bh = batch x heads. Returns a
// cudaError_t (0 = launched); cudaErrorInvalidValue for a non-positive size,
// a negative m, a missing factor, a head dim above 128 or more than 128
// factor columns.
int mmcsi_flash_attention_lowrank(const void* q, const void* k, const void* v,
                                  const void* r, const void* s, void* out,
                                  void* lse, int bh, int nq, int nk, int d,
                                  int m, int dtype, void* stream) {
  if (refused(r, s, bh, nq, nk, d, m)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      const auto p = params<float>(q, k, v, r, s, out, lse, bh, nq, nk, d, m);
      return m ? tc::launch_f32<true>(p, st) : tc::launch_f32<false>(p, st);
    }
    case 1: {
      const auto p = params<tc::bf16>(q, k, v, r, s, out, lse, bh, nq, nk, d,
                                      m);
      return m ? tc::launch<true>(p, st) : tc::launch<false>(p, st);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
