// CSI amplitude and phase in one pass, written by hand for Hopper (sm_90a):
//   amp = sqrt(re * re + im * im),  phase = atan2(im, re),
// elementwise over re and im of any shape, float32.
//
// Replaces the TPU kernel multi_modal_csi_tpu/kernels/csi_preprocess.py::
// amplitude_phase (body _amp_kernel, pallas_call at :57). On the TPU the
// kernel computes the amplitude only and the phase is an XLA arctan2 after
// it, because TPU Pallas has no atan2; here the phase goes in the same pass.
//
// Arithmetic. The amplitude is rounded exactly as the plain PyTorch version
// (amplitude_phase_reference) rounds it: two products, one sum and a
// square root, each correctly rounded to f32 (__fmul_rn, __fadd_rn,
// __fsqrt_rn).
// nvcc would otherwise contract re * re + im * im into an FMA, which rounds
// once where PyTorch rounds twice. The phase is CUDA's atan2f, which CUDA
// documents at 3 ulp; torch.atan2 on the card calls the same function.
//
// Bound on an H100 SXM. Each element reads re and im and writes amp and
// phase, 16 bytes, against some 25 operations (atan2f's polynomial
// included), so the pass is bound by bytes: one WiMANS trace (3000, 270) is
// 810,000 elements, 12.96 MB, 3.9 us at 3.35 TB/s. Design for that: the
// buffer is treated as flat; when all four pointers are 16-byte aligned
// each thread moves float4 vectors (one 16-byte load per input, one store
// per output), in a grid-stride loop over a grid of at most 8 blocks of
// 256 threads per SM, and the last n % 4 elements are done one at a time;
// otherwise the same loop runs on single floats. One launch either way. No
// shared memory: nothing is reused.
//
// The launcher returns cudaGetLastError() so a refused launch is seen.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ void amp_phase(float re, float im, float* amp,
                                          float* phase) {
  *amp = __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
  *phase = atan2f(im, re);
}

// One launch covers the whole buffer. With kVec4 (all pointers 16-byte
// aligned) the grid-stride loop moves float4 vectors and the last n % 4
// elements follow one at a time; without it every element goes singly.
template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
    amp_phase_kernel(const float* __restrict__ re, const float* __restrict__ im,
                     float* __restrict__ amp, float* __restrict__ phase,
                     long long n) {
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long tail = 0;
  if (kVec4) {
    const long long n4 = n / 4;
    const float4* re4 = reinterpret_cast<const float4*>(re);
    const float4* im4 = reinterpret_cast<const float4*>(im);
    for (long long i = tid; i < n4; i += stride) {
      const float4 r = re4[i];
      const float4 m = im4[i];
      float4 a, p;
      amp_phase(r.x, m.x, &a.x, &p.x);
      amp_phase(r.y, m.y, &a.y, &p.y);
      amp_phase(r.z, m.z, &a.z, &p.z);
      amp_phase(r.w, m.w, &a.w, &p.w);
      reinterpret_cast<float4*>(amp)[i] = a;
      reinterpret_cast<float4*>(phase)[i] = p;
    }
    tail = n4 * 4;
  }
  for (long long i = tail + tid; i < n; i += stride)
    amp_phase(re[i], im[i], amp + i, phase + i);
}

unsigned grid_for(long long items) {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      sms = 132;
  }
  const long long needed = (items + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  return (unsigned)(needed < most ? needed : most);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// re, im, amp, phase: n contiguous float32 values each. Returns a
// cudaError_t (0 = launched); cudaErrorInvalidValue for n <= 0.
int mmcsi_csi_preprocess(const void* re, const void* im, void* amp,
                         void* phase, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(re);
  const float* m = static_cast<const float*>(im);
  float* a = static_cast<float*>(amp);
  float* p = static_cast<float*>(phase);
  if (aligned16(r) && aligned16(m) && aligned16(a) && aligned16(p))
    amp_phase_kernel<true><<<grid_for((n + 3) / 4), kThreads, 0, s>>>(r, m, a,
                                                                     p, n);
  else
    amp_phase_kernel<false><<<grid_for(n), kThreads, 0, s>>>(r, m, a, p, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
