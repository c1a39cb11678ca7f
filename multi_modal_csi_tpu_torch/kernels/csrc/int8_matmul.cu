// Tiled tensor-core matrix product C = A B^T of int8 serving, written by
// hand for Hopper (sm_90a), in two instantiations of one body:
//   s8:   A (M, K) int8, B (N, K) int8 -> C (M, N) int32, exact;
//   bf16: A (M, K) bf16, B (N, K) bf16 -> C (M, N) f32, f32 accumulation.
// B is torch's (out, in) weight layout, which is mma's ".row.col" form, so
// nothing is transposed. A leading group dimension G (A (G, M, K), B (G, N,
// K), C (G, M, N), all contiguous) runs over blockIdx.z: a grouped
// convolution is one launch.
//
// Replaces the TPU kernel tools/exp_pallas_int8.py::main's one-tile bodies
// kernel_s8 (:43, s8 x s8 -> s32) and kernel_bf16 (:48, bf16 x bf16 -> f32),
// pallas_call at :74: the products that the JAX package's int8 serving runs
// in core/quantize.py::dense_forward and conv_forward (w8a8: int8 x int8 ->
// int32; w8 and the attention projections: bf16 x bf16 -> f32). As there,
// the kernel computes the product only: the per-channel rescale, the bias
// and the cast stay outside it.
//
// Design: simple and right first. One block of four warps per 64 x 128
// output tile (2 x 2 warps of 32 x 64). K streams through shared memory in
// steps of 32 bytes (32 int8 or 16 bf16 values), double-buffered: while the
// warps multiply one step, the next is read from device memory into
// registers and stored into the other buffer, one __syncthreads a step.
// Fragments come from shared memory by ldmatrix (rows padded to 48 bytes,
// so the eight 16-byte rows of one 8 x 8 matrix hit distinct banks) and go
// to mma.sync m16n8k32 s8 (s32 accumulators) or m16n8k16 bf16 (f32
// accumulators); both consume a 32-byte K step with the same fragment
// layout, so one body serves both. The M, N and K tails are zero-filled in
// shared memory: zeros add nothing to an integer sum, and nothing to a
// float sum of finite values.
//
// Unaligned rows. A row of K = 270 int8 values is 270 bytes, so rows after
// the first are not 16-byte aligned. The launcher picks the widest access
// V in {16, 8, 4, 2, 1} bytes that divides the row length in bytes and both
// base addresses, and the kernel is instantiated for each V: every access
// is a whole V-byte vector that lies either inside the row or past its end
// (zero-filled). No copy pads the operands. The main path's K of 512, 2048
// and 27,000 int8 take 16 or 8 bytes; 270, 810 and 1350 take 2.
//
// int32 overflow: |sum| <= 128^2 K, which fits in int32 for K <= 131,071
// (int8 includes -128; the JAX package's quantizer clips to +-127). The
// launcher refuses larger K for s8. Offsets are 64-bit (M reaches 768,000
// rows at DETR's pointwise conv).
//
// Bound on an H100 SXM: bytes M K + N K + 4 M N (s8) or 2 M K + 2 N K +
// 4 M N (bf16) over 3.35 TB/s, against 2 M N K operations over 1,979 TOP/s
// int8 or 989 TFLOP/s bf16. DETR's dilated conv (256000, 810) x (270, 810)
// is 0.27 GB and 112 G operations: 80 us of bytes, 57 us of operations;
// most of the serving products are bound by bytes (N = 270 is narrow). This
// version is limited by its synchronous loads and mma.sync issue; wgmma
// with TMA pipelines and a fused rescale epilogue are the later steps.
//
// The launcher returns cudaGetLastError() so a refused launch is seen.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;           // output rows per block
constexpr int kBN = 128;          // output columns per block
constexpr int kThreads = 128;     // four warps, 2 x 2 over the tile
constexpr int kStep = 32;         // K bytes per step
constexpr int kRow = 48;          // shared-memory bytes per staged row
constexpr long long kMaxKS8 = 131071;

template <int V> struct Vec;
template <> struct Vec<16> { using T = int4; };
template <> struct Vec<8> { using T = int2; };
template <> struct Vec<4> { using T = int; };
template <> struct Vec<2> { using T = short; };
template <> struct Vec<1> { using T = char; };

// One operand tile of ROWS rows x 32 bytes, V bytes per access: each thread
// reads its vectors of the next step into registers (zero where the row or
// the K range ends) and later stores them into a shared-memory buffer.
template <int V, int ROWS>
struct Tile {
  using T = typename Vec<V>::T;
  static constexpr int kPerRow = kStep / V;
  static constexpr int kPerThread = ROWS * kPerRow / kThreads;
  T r[kPerThread];

  __device__ __forceinline__ void fetch(const unsigned char* g,
                                        long long row0, long long rows,
                                        long long row_bytes, long long k0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int rr = idx / kPerRow;
      const long long k = k0 + (long long)(idx - rr * kPerRow) * V;
      const long long row = row0 + rr;
      T v{};
      if (row < rows && k < row_bytes)
        v = *reinterpret_cast<const T*>(g + row * row_bytes + k);
      r[i] = v;
    }
  }

  __device__ __forceinline__ void store(unsigned char* s) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int rr = idx / kPerRow;
      *reinterpret_cast<T*>(s + rr * kRow + (idx - rr * kPerRow) * V) = r[i];
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const unsigned char* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Acc is int (s8 operands) or float (bf16 operands); V the access width.
// a, b, c are group 0's bases; a_group, b_group, c_group the group strides
// in bytes (a, b) and elements (c).
template <typename Acc, int V>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const unsigned char* __restrict__ a,
                       const unsigned char* __restrict__ b,
                       Acc* __restrict__ c, long long m, long long n,
                       long long row_bytes, long long a_group,
                       long long b_group, long long c_group) {
  __shared__ __align__(16) unsigned char as[2][kBM * kRow];
  __shared__ __align__(16) unsigned char bs[2][kBN * kRow];

  const long long m0 = (long long)blockIdx.x * kBM;
  const long long n0 = (long long)blockIdx.y * kBN;
  a += (long long)blockIdx.z * a_group;
  b += (long long)blockIdx.z * b_group;
  c += (long long)blockIdx.z * c_group;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32;   // the warp's rows in the tile
  const int wn = (warp % 2) * 64;   // and columns

  Acc acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  // ldmatrix row addresses of this lane: A's four 8 x 16-byte matrices are
  // (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) -> a0..a3; B's are, for two
  // neighbouring n8 tiles, (n 0-7, bytes 0-15 | 16-31) -> b0, b1 of the
  // first and (n 8-15, ...) of the second.
  const int a_off = (wm + (lane % 8) + ((lane / 8) % 2) * 8) * kRow +
                    (lane / 16) * 16;
  const int b_off = (wn + (lane % 8) + (lane / 16) * 8) * kRow +
                    ((lane / 8) % 2) * 16;

  Tile<V, kBM> ta;
  Tile<V, kBN> tb;
  const long long steps = (row_bytes + kStep - 1) / kStep;
  ta.fetch(a, m0, m, row_bytes, 0);
  tb.fetch(b, n0, n, row_bytes, 0);
  ta.store(as[0]);
  tb.store(bs[0]);
  __syncthreads();

  for (long long s = 0; s < steps; ++s) {
    const int buf = (int)(s & 1);
    const bool more = s + 1 < steps;
    if (more) {
      ta.fetch(a, m0, m, row_bytes, (s + 1) * kStep);
      tb.fetch(b, n0, n, row_bytes, (s + 1) * kStep);
    }
    unsigned fa[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldmatrix_x4(fa[i], as[buf] + a_off + i * 16 * kRow);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      unsigned fb[4];
      ldmatrix_x4(fb, bs[buf] + b_off + j * 8 * kRow);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma(acc[i][j], fa[i], fb[0], fb[1]);
        mma(acc[i][j + 1], fa[i], fb[2], fb[3]);
      }
    }
    if (more) {
      ta.store(as[buf ^ 1]);
      tb.store(bs[buf ^ 1]);
    }
    __syncthreads();
  }

  // accumulator e of an m16n8 tile: row g (e < 2) or g + 8, column 2t + e % 2
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = m0 + wm + i * 16 + g + (e / 2) * 8;
        const long long col = n0 + wn + j * 8 + 2 * t + e % 2;
        if (row < m && col < n) c[row * n + col] = acc[i][j][e];
      }
}

int widest_access(long long row_bytes, const void* a, const void* b) {
  const std::uintptr_t bits = (std::uintptr_t)row_bytes |
                              reinterpret_cast<std::uintptr_t>(a) |
                              reinterpret_cast<std::uintptr_t>(b);
  int v = 16;
  while (v > 1 && (bits & (std::uintptr_t)(v - 1))) v /= 2;
  return v;
}

template <typename Acc>
int launch(const void* a, const void* b, void* c, long long groups,
           long long m, long long n, long long k, int elem,
           cudaStream_t stream) {
  const long long row_bytes = k * elem;
  const long long m_tiles = (m + kBM - 1) / kBM;
  const long long n_tiles = (n + kBN - 1) / kBN;
  if (m_tiles > 2147483647LL || n_tiles > 65535 || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)m_tiles, (unsigned)n_tiles, (unsigned)groups);
  const auto* pa = static_cast<const unsigned char*>(a);
  const auto* pb = static_cast<const unsigned char*>(b);
  auto* pc = static_cast<Acc*>(c);
  const long long ag = m * row_bytes, bg = n * row_bytes, cg = m * n;
  switch (widest_access(row_bytes, a, b)) {
    case 16:
      int8_matmul_kernel<Acc, 16><<<grid, kThreads, 0, stream>>>(
          pa, pb, pc, m, n, row_bytes, ag, bg, cg);
      break;
    case 8:
      int8_matmul_kernel<Acc, 8><<<grid, kThreads, 0, stream>>>(
          pa, pb, pc, m, n, row_bytes, ag, bg, cg);
      break;
    case 4:
      int8_matmul_kernel<Acc, 4><<<grid, kThreads, 0, stream>>>(
          pa, pb, pc, m, n, row_bytes, ag, bg, cg);
      break;
    case 2:
      int8_matmul_kernel<Acc, 2><<<grid, kThreads, 0, stream>>>(
          pa, pb, pc, m, n, row_bytes, ag, bg, cg);
      break;
    default:
      int8_matmul_kernel<Acc, 1><<<grid, kThreads, 0, stream>>>(
          pa, pb, pc, m, n, row_bytes, ag, bg, cg);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = int8 operands, int32 output; 1 = bfloat16 operands, float32
// output. a (groups, m, k), b (groups, n, k), c (groups, m, n), contiguous.
// Returns a cudaError_t (0 = launched); cudaErrorInvalidValue for a
// non-positive size, an unknown dtype, or int8 K above 131,071.
int mmcsi_int8_matmul(const void* a, const void* b, void* c, int dtype,
                      long long groups, long long m, long long n, long long k,
                      void* stream) {
  if (groups <= 0 || m <= 0 || n <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      if (k > kMaxKS8) return (int)cudaErrorInvalidValue;
      return launch<int>(a, b, c, groups, m, n, k, 1, s);
    case 1:
      return launch<float>(a, b, c, groups, m, n, k, 2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
