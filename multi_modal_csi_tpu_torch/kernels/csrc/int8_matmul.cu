// The products of int8 serving on Hopper (sm_90a): a tiled tensor-core
// product C = A B^T with the per-channel rescale, the bias and the cast
// fused into its epilogue, and the prologue that writes its int8 (or bf16)
// A operand from the activation in one pass.
//
// Replaces the TPU kernel tools/exp_pallas_int8.py::main's one-tile bodies
// kernel_s8 (:43, s8 x s8 -> s32) and kernel_bf16 (:48, bf16 x bf16 -> f32),
// pallas_call at :74: the products that the JAX package's int8 serving runs
// in core/quantize.py::dense_forward and conv_forward (w8a8: int8 x int8 ->
// int32; w8 and the attention projections: bf16 x bf16 -> f32), where XLA
// fuses the activation quantization and the rescale around its dot. Here
// the same fusion is written by hand.
//
// Modes of the product (one body):
//   0 s8:        A int8,  B int8  -> int32 accumulators (mma m16n8k32), exact;
//   1 bf16:      A bf16,  B bf16  -> f32 accumulators (mma m16n8k16);
//   2 bf16 x s8: A bf16,  B int8  widened to bf16 on its way from shared
//                memory into the fragments (exact: |q| <= 128), the JAX
//                package's "inline dequant" of the w8 weight.
// B is torch's (out, in) weight layout, which is mma's ".row.col" form.
//
// Bound on an H100 SXM: the serving products have N = 270 to 2048 and K =
// 270 to 27,000, so most are bound by bytes: A read once (M K bytes in
// int8), B once, the output written once (4 M N bytes as f32, 2 M N as
// bf16). The design follows the byte streams:
//   - Operands reach shared memory only by asynchronous copies (cp.async)
//     of V = 16 bytes (4 for an unpadded bf16 activation whose rows are
//     540 bytes long) through a ring of kStages = 3 stages, so two
//     stages of loads are in flight while the tensor cores work on one;
//     one __syncthreads a stage. A stage holds 32 bytes of each row (one
//     mma k-step) for short K, and 128 bytes (four k-steps under one
//     barrier) from kLongK = 768 bytes of K on. The prologue writes A, and
//     the model's loading pads B once, at row strides that are multiples
//     of 16 bytes with zeros in the pad: zeros add nothing to the sums, so
//     the loop runs over the padded width.
//   - Tiles of 128 x 96: N = 270 takes 3 column tiles (288 columns, 6.7%
//     spare), and the column tiles of one row tile are neighbours in the
//     launch order, so A comes from device memory once and then from L2.
//   - Split-K where the tiles do not fill the card and K is long (DETR's
//     (2560, 27000) x 270: 60 tiles): each split writes its partial sums
//     to a workspace and a second kernel adds them in split order (integers
//     exactly; floats in a fixed order) and applies the epilogue.
//   - The epilogue stages each half tile in shared memory and writes it as
//     contiguous row segments: out = cast(float(acc) * scale[n] + bias[n])
//     in f32 or bf16, with __int2float_rn, __fmul_rn, __fadd_rn and
//     __float2bfloat16_rn, so that no multiply-add is contracted into an
//     FMA and the result is bit-equal to the eager chain y.float() * s,
//     + bias, .to(dtype). The int32 / f32 product never reaches device
//     memory. The bare product (kind 0) writes the accumulators as they
//     are.
// The prologue (mmcsi_int8_columns) reads the channels-last activation (B,
// L, C), bf16 or f32, once and writes the (B L_out, G, Kp) columns of the
// product: the im2col of a 1-D convolution in the weight's (channel, tap)
// order (a Linear is k = 1), each value q = clamp(rint(x / s), -127, 127)
// as int8 (IEEE division, round half to even, as torch.round and
// jnp.round), or x as bf16 (the w8 operand), zeros at the padded positions
// and in the row pad. It quantizes each input value once, into a window in
// shared memory from which the columns are written, and reads x through
// its strides (a transposed view is not copied). A window too wide for
// shared memory (above 200 KB for one row) is written straight from x.
// The 3-D prologue (mmcsi_int8_columns3d) does the same for a 3-D
// convolution of a channels-last (B, T, H, W, C) activation with symmetric
// zero padding, writing (B To Ho Wo, Kp) rows in the weight's (channel,
// kt, kh, kw) order (a 2-D convolution is its T = 1, kt = 1 case): one
// block takes a run of output rows along W at one (b, t_out, h_out), reads
// the kt x kh x span_W x C window they cover once into shared memory,
// quantized once, and writes the rows from there in 4-byte words.
//
// The implicit conv (mmcsi_int8_conv3d) is the product kernel with another
// A loader: it reads the conv window itself, so a 2-D or 3-D conv of C >=
// 16 channels writes no columns. It replaces the 3-D prologue's columns for
// those convs (the stems' C = 3 keep them), and is what XLA does with the
// windows of the JAX package's int8 conv (core/quantize.py::conv_forward,
// lax.conv_general_dilated on the int8 codes, fused). A is the activation's
// codes (B, T, H, W, Cp), quantized once by the 1-D prologue at k = 1 (or
// the bf16 activation itself for w8 where C is a multiple of 8): Cp is C
// with zeros up to a multiple of 16 bytes, cpe = Cp x element bytes. Row m
// of the product is the output position (b, to, ho, wo), and K runs
// tap-major, (kt, kh, kw, Cp), as does the weight's copy (N, kt kh kw Cp).
// A 16-byte copy of A never straddles two taps (cpe is a multiple of 16):
// it reads Cp's bytes at one tap straight from the codes, with src-size 0
// where the tap falls in the zero padding. Each loader thread owns fixed
// rows of the tile and decodes their (b, to, ho, wo) and window corner once
// a tile; it carries its copies' tap (dt, dh, dw) and byte within the tap
// from one ring stage to the next with a carry, so no copy costs a
// division. The rest of the kernel (ring, tiles, split-K, epilogue) is the
// product's, so a w8a8 output is bit for bit that of the 3-D prologue
// followed by the product (exact int32 sums, whatever the K order).
// Bound on an H100 SXM at ResNet3D-18's layer1 conv (64 clips of (45, 56,
// 56, 64), 3x3x3 to 64, w8a8): 2 M N K = 2 x 9,031,680 x 64 x 1,728 = 2.0
// TOP, 1.01 ms at 1,979 TOP/s, against 0.52 ms of bytes (578 MB of int8
// codes read, 1.16 GB of bf16 written), so operations bound it. What the
// design does about it: the codes are read from L2 by each of the 27 taps
// and from device memory about once, the 128-row tiles of one row of
// output tiles are neighbours in the launch order; 96-column tiles spend a
// third of the tensor-core work on N = 64 convs (ResNet's layer1, S3D's
// stem), a cost left for a later tile shape.
//
// int32 overflow: |sum| <= 128^2 K fits for K <= 131,071; the launchers
// refuse larger K in mode 0. Offsets are 64-bit. Each launcher returns
// cudaGetLastError() so a refused launch is seen.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 128;          // output rows per block
constexpr int kBN = 96;           // output columns per block
constexpr int kThreads = 2 * kBM; // kBM / 16 warps, (kBM / 32) x 2 over
                                  // the tile
constexpr int kWarpN = 48;        // columns per warp: 6 n8 tiles
constexpr int kSub = 32;          // A bytes per mma k-step (32 int8 with
                                  // m16n8k32, 16 bf16 with m16n8k16)
constexpr int kLongK = 768;       // A bytes of K from which a ring stage
                                  // holds 128 bytes of each row, not 32
constexpr int kStages = 3;        // cp.async ring depth

// A ring of kStages stages of STEP A bytes per row: rows at an odd
// multiple of 16 bytes, so the eight 16-byte rows of one ldmatrix matrix
// hit distinct banks
template <int STEP>
struct Ring {
  static constexpr int kRow = STEP + 16;
  static constexpr int kStageBytes = (kBM + kBN) * kRow;
  static constexpr int kBytes = kStages * kStageBytes;
};
constexpr int kOutLd = kBN + 4;   // epilogue staging row stride (words)
constexpr long long kMaxKS8 = 131071;

static_assert(kBN == 3 * 32, "the epilogue gives each lane 3 columns");
static_assert(kBM % 64 == 0, "the epilogue stages 64 rows at a time");
static_assert(Ring<kSub>::kBytes >= kBM / 2 * kOutLd * 4,
              "the epilogue's half tile must fit in the ring");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of V bytes; zero-filled when !valid (src is then any valid
// address and is not read)
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int bytes = valid ? V : 0;
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(V), "r"(bytes));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const unsigned char* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

// two int8 values (k, k + 1) as a packed pair of bf16, k's in the low half
__device__ __forceinline__ unsigned widen_pair(unsigned short v) {
  const float lo = (float)(signed char)(v & 0xff);
  const float hi = (float)(signed char)(v >> 8);
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

// The implicit conv's geometry (all zero for a plain product): A is the
// channels-last codes (B, T, H, W, Cp), one position cpe bytes
struct Conv {
  int t, h, w;             // the input's sizes
  int to, ho, wo;          // the output's
  int kt, kh, kw;          // the kernel
  int vt, vh, vw;          // the strides
  int pt, ph, pw;          // the low pads
  int cpe;                 // bytes of one position's codes, 16 n
};

struct Product {
  const unsigned char* a;  // group 0's A, rows lda bytes apart
  const unsigned char* b;  // group 0's B, rows ldb bytes apart
  void* c;                 // output (kind 1, 2) or the int32 / f32 sum
  void* work;              // split-K partial sums, (splits, G, M, N), or null
  const float* scale;      // (G N) per-column weight scale, or null (kind 0)
  const float* input_scale;  // the activation's scale (w8a8), or null
  const void* bias;        // (G N) f32 or bf16 bias, or null
  long long m, n;          // rows and columns per group
  long long a_bytes, lda, a_group;  // bytes of A's row to read (the rest
                                    // reads as zeros), stride, group stride
  long long b_bytes, ldb, b_group;
  long long ldc, c_group;           // output strides in elements
  long long steps;                  // K steps of one ring stage
  long long split_steps;            // steps per split
  int groups, splits;
  int kind;                         // 0 raw sums, 1 f32, 2 bf16
  int bias_bf16;                    // the bias is bf16 (else f32)
  Conv conv;                        // the implicit conv's A (CONV only)
};

template <int MODE>
struct Traits {
  using Acc = int;
  static constexpr int kBShift = 0;   // B bytes per A byte: 1 >> kBShift
};
template <>
struct Traits<1> {
  using Acc = float;
  static constexpr int kBShift = 0;
};
template <>
struct Traits<2> {
  using Acc = float;
  static constexpr int kBShift = 1;   // int8 weights against bf16 A
};

template <typename Acc>
__device__ __forceinline__ float to_float(Acc v) {
  if constexpr (std::is_same<Acc, int>::value)
    return __int2float_rn(v);
  else
    return v;
}

// the scale of column i as the eager chain forms it: weight_scale *
// input_scale (w8a8), or weight_scale
__device__ __forceinline__ float column_scale(const Product& p, long long i) {
  const float s = p.scale[i];
  return p.input_scale ? __fmul_rn(s, *p.input_scale) : s;
}

__device__ __forceinline__ float column_bias(const Product& p, long long i) {
  if (!p.bias) return 0.0f;
  return p.bias_bf16 ? __bfloat162float(static_cast<const bf16*>(p.bias)[i])
                     : static_cast<const float*>(p.bias)[i];
}

// one output element at offset ``at``: the raw sum (kind 0), or float(sum)
// * s (+ b when there is a bias) as f32 or bf16, each step rounded as the
// eager chain rounds it (no contraction into an FMA)
template <typename Acc>
__device__ __forceinline__ void store_value(const Product& p, long long at,
                                            Acc v, float s, float b) {
  if (p.kind == 0) {
    static_cast<Acc*>(p.c)[at] = v;
    return;
  }
  float x = __fmul_rn(to_float(v), s);
  if (p.bias) x = __fadd_rn(x, b);
  if (p.kind == 1)
    static_cast<float*>(p.c)[at] = x;
  else
    static_cast<bf16*>(p.c)[at] = __float2bfloat16_rn(x);
}

// Loads K step s of one tile's A into ring stage st: kBM rows of STEP
// bytes, V bytes a copy, zeros past a row's end or past the last row.
template <int V, int STEP>
__device__ __forceinline__ void load_a(const Product& p,
                                       const unsigned char* a, long long m0,
                                       long long s, unsigned char* st) {
  constexpr int kRow = Ring<STEP>::kRow;
  constexpr int kAPer = STEP / V;
  const long long ka = s * STEP;
#pragma unroll
  for (int i = 0; i < kBM * kAPer / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kAPer, ch = (idx - r * kAPer) * V;
    const long long row = m0 + r, at = ka + ch;
    const bool ok = row < p.m && at < p.a_bytes;
    cp_async<V>(st + r * kRow + ch, ok ? a + row * p.lda + at : a, ok);
  }
}

// B's part of K step s: kBN rows of kBStep bytes into the stage after A.
template <int MODE, int V, int STEP>
__device__ __forceinline__ void load_b(const Product& p,
                                       const unsigned char* b, long long n0,
                                       long long s, unsigned char* st) {
  constexpr int kBStep = STEP >> Traits<MODE>::kBShift;
  constexpr int kRow = Ring<STEP>::kRow;
  constexpr int kBPer = kBStep / V;
  const long long kb = s * kBStep;
  unsigned char* bs = st + kBM * kRow;
#pragma unroll
  for (int i = 0; i < (kBN * kBPer + kThreads - 1) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < kBN * kBPer) {
      const int r = idx / kBPer, ch = (idx - r * kBPer) * V;
      const long long row = n0 + r, at = kb + ch;
      const bool ok = row < p.n && at < p.b_bytes;
      cp_async<V>(bs + r * kRow + ch, ok ? b + row * p.ldb + at : b, ok);
    }
  }
}

// The implicit conv's A loader, 16-byte copies. Thread x copies bytes ch =
// (x % kPer) 16 of each stage's row for kRows rows of the tile, x / kPer +
// 32 i apart (every copy of the thread at the same K offset, so at one
// tap); each row's window corner (its byte offset and (t0, h0, w0), the
// output position times the stride less the pad) is decoded once a tile,
// and the tap (dt, dh, dw) with the byte cb within it advance by STEP bytes
// a stage. Stages are loaded in order, from the split's first.
template <int STEP>
struct ConvRows {
  static constexpr int kPer = STEP / 16;                // copies a row
  static constexpr int kStride = kThreads / kPer;       // rows apart
  static constexpr int kRows = kBM / kStride;           // rows a thread
  long long base[kRows];
  int t0[kRows], h0[kRows], w0[kRows];
  int ch, cb, dt, dh, dw;

  __device__ __forceinline__ void start(const Product& p, long long m0,
                                        long long s0) {
    const Conv& q = p.conv;
    ch = (threadIdx.x % kPer) * 16;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long m = m0 + threadIdx.x / kPer + i * kStride;
      if (m < p.m) {
        long long rest = m / q.wo;
        const int wo = (int)(m - rest * q.wo);
        long long next = rest / q.ho;
        const int ho = (int)(rest - next * q.ho);
        rest = next / q.to;
        const int to = (int)(next - rest * q.to);
        t0[i] = to * q.vt - q.pt;
        h0[i] = ho * q.vh - q.ph;
        w0[i] = wo * q.vw - q.pw;
        base[i] = (((rest * q.t + t0[i]) * q.h + h0[i]) * q.w + w0[i]) *
                  (long long)q.cpe;
      } else {                       // past the last row: never in bounds
        t0[i] = -(1 << 30);
        h0[i] = w0[i] = 0;
        base[i] = 0;
      }
    }
    const long long k0 = s0 * STEP + ch;
    const long long tap = k0 / q.cpe;
    cb = (int)(k0 - tap * q.cpe);
    const long long plane = (long long)q.kh * q.kw;
    dt = (int)min(tap / plane, (long long)q.kt);
    const int rem = (int)(tap - (long long)dt * plane);
    dh = rem / q.kw;
    dw = rem - dh * q.kw;
  }

  __device__ __forceinline__ void load(const Product& p,
                                       const unsigned char* a,
                                       unsigned char* st) {
    constexpr int kRow = Ring<STEP>::kRow;
    const Conv& q = p.conv;
    const long long delta =
        ((long long)(dt * q.h + dh) * q.w + dw) * q.cpe + cb;
    const bool tap_ok = dt < q.kt;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = threadIdx.x / kPer + i * kStride;
      const bool ok = tap_ok && (unsigned)(t0[i] + dt) < (unsigned)q.t &&
                      (unsigned)(h0[i] + dh) < (unsigned)q.h &&
                      (unsigned)(w0[i] + dw) < (unsigned)q.w;
      cp_async<16>(st + r * kRow + ch, ok ? a + (base[i] + delta) : a, ok);
    }
    cb += STEP;                      // the next stage's tap
    while (cb >= q.cpe) {
      cb -= q.cpe;
      if (++dw == q.kw) {
        dw = 0;
        if (++dh == q.kh) {
          dh = 0;
          ++dt;
        }
      }
    }
  }
};

template <int MODE, int V, int STEP, bool CONV>
__global__ void __launch_bounds__(kThreads)
    product_kernel(const Product p) {
  using Acc = typename Traits<MODE>::Acc;
  constexpr int kRow = Ring<STEP>::kRow;
  constexpr int kStageBytes = Ring<STEP>::kStageBytes;
  extern __shared__ __align__(16) unsigned char ring[];

  const long long n_tiles = (p.n + kBN - 1) / kBN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;
  const long long n0 = (long long)(blockIdx.x % n_tiles) * kBN;
  const int g = blockIdx.z / p.splits;
  const int split = blockIdx.z - g * p.splits;
  const unsigned char* a = p.a + (long long)g * p.a_group;
  const unsigned char* b = p.b + (long long)g * p.b_group;
  const long long s0 = (long long)split * p.split_steps;
  const long long s1 = min(p.steps, s0 + p.split_steps);
  const long long steps = s1 > s0 ? s1 - s0 : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32;       // the warp's rows in the tile
  const int wn = (warp % 2) * kWarpN;   // and columns

  Acc acc[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = Acc(0);

  // ldmatrix row addresses of this lane: A's four 8 x 16-byte matrices are
  // (rows 0-7 | 8-15) x (bytes 0-15 | 16-31) -> a0..a3; B's are, for two
  // neighbouring n8 tiles, (n 0-7, bytes 0-15 | 16-31) -> b0, b1 of the
  // first and (n 8-15, ...) of the second.
  const int a_off = (wm + (lane % 8) + ((lane / 8) % 2) * 8) * kRow +
                    (lane / 16) * 16;
  const int b_off = kBM * kRow + (wn + (lane % 8) + (lane / 16) * 8) * kRow +
                    ((lane / 8) % 2) * 16;
  // mode 2: this lane's B values, rows n = lane / 4, bytes 2t and 2t + 8
  const int w_off = kBM * kRow + (wn + lane / 4) * kRow + (lane % 4) * 2;

  // K steps are loaded in order, s0 first (the conv loader counts on it)
  ConvRows<STEP> window;
  if constexpr (CONV) window.start(p, m0, s0);
  auto load_step = [&](long long s, unsigned char* st) {
    if constexpr (CONV)
      window.load(p, a, st);
    else
      load_a<V, STEP>(p, a, m0, s, st);
    load_b<MODE, V, STEP>(p, b, n0, s, st);
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps) load_step(s0 + st, ring + st * kStageBytes);
    cp_commit();
  }
  for (long long s = 0; s < steps; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();
    // stage (s - 1) % kStages was read by every warp before the barrier
    const long long next = s + kStages - 1;
    if (next < steps)
      load_step(s0 + next, ring + (next % kStages) * kStageBytes);
    cp_commit();

    const unsigned char* st = ring + (s % kStages) * kStageBytes;
#pragma unroll
    for (int kk = 0; kk < STEP / kSub; ++kk) {
      unsigned fa[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(fa[i], st + a_off + i * 16 * kRow + kk * kSub);
      if constexpr (MODE == 2) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const unsigned char* w = st + w_off + j * 8 * kRow + kk * kSub / 2;
          const unsigned b0 =
              widen_pair(*reinterpret_cast<const unsigned short*>(w));
          const unsigned b1 =
              widen_pair(*reinterpret_cast<const unsigned short*>(w + 8));
#pragma unroll
          for (int i = 0; i < 2; ++i) mma(acc[i][j], fa[i], b0, b1);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 6; j += 2) {
          unsigned fb[4];
          ldmatrix_x4(fb, st + b_off + j * 8 * kRow + kk * kSub);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma(acc[i][j], fa[i], fb[0], fb[1]);
            mma(acc[i][j + 1], fa[i], fb[2], fb[3]);
          }
        }
      }
    }
  }
  cp_wait<0>();

  // Epilogue: each 64 rows of the tile (warps 0-3, then 4-7) are staged in
  // the ring as 32-bit sums and written out row by row: warp w takes rows
  // w, w + 8, ..., its lanes columns lane, lane + 32 and lane + 64, whose
  // scale and bias it holds in registers.
  Acc* tile = reinterpret_cast<Acc*>(ring);
  float cs[3], cb[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const long long col = n0 + lane + 32 * q;
    const bool ok = p.kind && !p.work && col < p.n;
    cs[q] = ok ? column_scale(p, g * p.n + col) : 0.0f;
    cb[q] = ok ? column_bias(p, g * p.n + col) : 0.0f;
  }
  const int gq = lane / 4, t = lane % 4;
  for (int half = 0; half < kBM / 64; ++half) {
    __syncthreads();
    if (wm / 64 == half) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 6; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // accumulator e of an m16n8 tile: row gq (e < 2) or gq + 8,
            // column 2t + e % 2
            const int r = wm % 64 + i * 16 + gq + (e / 2) * 8;
            const int col = wn + j * 8 + 2 * t + e % 2;
            tile[r * kOutLd + col] = acc[i][j][e];
          }
    }
    __syncthreads();
    for (int r = warp; r < 64; r += kThreads / 32) {
      const long long row = m0 + half * 64 + r;
      if (row >= p.m) break;
      const Acc* src = tile + r * kOutLd;
      if (p.work) {
        Acc* dst = static_cast<Acc*>(p.work) +
                   ((long long)blockIdx.z * p.m + row) * p.n + n0;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int col = lane + 32 * q;
          if (n0 + col < p.n) dst[col] = src[col];
        }
      } else {
        const long long at = g * p.c_group + row * p.ldc + n0;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int col = lane + 32 * q;
          if (n0 + col < p.n)
            store_value<Acc>(p, at + col, src[col], cs[q], cb[q]);
        }
      }
    }
  }
}

// Split-K's second pass: the partial sums of each output element added in
// split order, then the epilogue.
template <typename Acc>
__global__ void __launch_bounds__(256) reduce_kernel(const Product p) {
  const long long per_group = p.m * p.n;
  const long long total = (long long)p.groups * per_group;
  const Acc* work = static_cast<const Acc*>(p.work);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long g = i / per_group, rest = i - g * per_group;
    const long long row = rest / p.n, col = rest - row * p.n;
    Acc sum = work[(g * p.splits) * per_group + rest];
    for (int s = 1; s < p.splits; ++s)
      sum += work[(g * p.splits + s) * per_group + rest];
    const long long ci = g * p.n + col;
    store_value<Acc>(p, g * p.c_group + row * p.ldc + col, sum,
                     p.kind ? column_scale(p, ci) : 0.0f,
                     column_bias(p, ci));
  }
}

// The ring is dynamic shared memory (more than the 48 KB a launch gets
// without asking, at STEP = 128).
template <int MODE, int V, int STEP, bool CONV>
int launch_product(dim3 grid, const Product& p, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      product_kernel<MODE, V, STEP, CONV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<STEP>::kBytes);
  if (err != cudaSuccess) return (int)err;
  product_kernel<MODE, V, STEP, CONV>
      <<<grid, kThreads, Ring<STEP>::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// the implicit conv copies 16 bytes only
template <int MODE, int STEP, bool CONV>
int launch_width(dim3 grid, const Product& p, int v, cudaStream_t stream) {
  if constexpr (CONV)
    return launch_product<MODE, 16, STEP, true>(grid, p, stream);
  else
    return v == 16 ? launch_product<MODE, 16, STEP, false>(grid, p, stream)
                   : launch_product<MODE, 4, STEP, false>(grid, p, stream);
}

// Long K (kLongK A bytes or more) takes stages of 128 bytes a row, so that
// one barrier serves four mma k-steps; short K takes stages of 32 bytes,
// so that little of the last stage is padding.
template <int MODE, bool CONV = false>
int launch_mode(Product p, long long k_bytes, int v, cudaStream_t stream) {
  const int step = k_bytes >= kLongK ? 128 : kSub;
  p.steps = (k_bytes + step - 1) / step;
  if (p.splits > p.steps) p.splits = (int)p.steps;
  if (p.splits == 1) p.work = nullptr;
  p.split_steps = (p.steps + p.splits - 1) / p.splits;
  const long long tiles = ((p.m + kBM - 1) / kBM) * ((p.n + kBN - 1) / kBN);
  const long long z = (long long)p.groups * p.splits;
  if (tiles > 2147483647LL || z > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)tiles, 1, (unsigned)z);
  const int err = step == kSub
                      ? launch_width<MODE, kSub, CONV>(grid, p, v, stream)
                      : launch_width<MODE, 128, CONV>(grid, p, v, stream);
  if (err || !p.work) return err;
  const long long total = (long long)p.groups * p.m * p.n;
  const unsigned blocks = (unsigned)std::min((total + 255) / 256, 132LL * 16);
  reduce_kernel<typename Traits<MODE>::Acc><<<blocks, 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// the copy of 16 bytes, else 4, that divides every row stride, row
// length, group stride and base address of both operands; 0 if neither
int widest_copy(const Product& p) {
  const std::uintptr_t bits =
      (std::uintptr_t)(p.a_bytes | p.lda | p.a_group | p.b_bytes | p.ldb |
                       p.b_group) |
      reinterpret_cast<std::uintptr_t>(p.a) |
      reinterpret_cast<std::uintptr_t>(p.b);
  return !(bits & 15) ? 16 : !(bits & 3) ? 4 : 0;
}

// The prologue. One block takes a tile of up to 64 consecutive output
// rows of one batch item and group: it reads the input window those rows
// cover ((rows - 1) stride + (k - 1) dilation + 1 positions x C/G
// channels, zeros outside the input) once, quantizes (or casts) each value
// once into shared memory, and then writes the rows' columns from there,
// a warp (or more) a row, neighbouring lanes on neighbouring columns. x is read
// through its strides (sb, sl, sc elements) with the lanes on whichever of
// channels and positions is unit-stride, so both a channels-last input and
// a transposed view read coalesced, and no copy is made. Each lane carries
// its column's (channel, tap) from one step of columns to the next by
// adding (step / k, step % k) with a carry, so no column costs a division.
struct Columns {
  long long sb, sl, sc;        // x's strides in elements
  long long tiles;             // batch x groups x tiles of rows
  int length, channels, lout, k, stride, dilation, pad_lo, groups, kp;
  int tile_rows;               // output rows a block takes at most
};

template <typename Out>
__device__ __forceinline__ Out column_value(float f, float s) {
  if constexpr (sizeof(Out) == 1) {
    const float q = rintf(__fdiv_rn(f, s));
    return (Out)(int)fminf(fmaxf(q, -127.0f), 127.0f);
  } else {
    return __float2bfloat16_rn(f);
  }
}

template <typename In>
__device__ __forceinline__ float input_value(const In* xg, const Columns& q,
                                             int pos, int c) {
  if (pos < 0 || pos >= q.length) return 0.0f;
  const In v = xg[pos * q.sl + c * q.sc];
  if constexpr (sizeof(In) == 2)
    return __bfloat162float(v);
  else
    return v;
}

template <typename In, typename Out>
__global__ void __launch_bounds__(256)
    columns_kernel(const In* __restrict__ x, Out* __restrict__ out,
                   const float* __restrict__ scale, const Columns q) {
  extern __shared__ __align__(16) unsigned char window_bytes[];
  Out* win = reinterpret_cast<Out*>(window_bytes);
  constexpr int kWarps = 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cg = q.channels / q.groups, kg = cg * q.k;
  const long long per_group = (q.lout + q.tile_rows - 1) / q.tile_rows;
  const bool channels_fast = q.sc <= q.sl;
  const float s = scale ? *scale : 1.0f;
  for (long long t = blockIdx.x; t < q.tiles; t += gridDim.x) {
    const long long bg = t / per_group;            // batch * groups + group
    const int lo0 = (int)(t - bg * per_group) * q.tile_rows;
    const long long bi = bg / q.groups;
    const int g = (int)(bg - bi * q.groups);
    const int rows = min(q.tile_rows, q.lout - lo0);
    const int p0 = lo0 * q.stride - q.pad_lo;
    const int span = (rows - 1) * q.stride + (q.k - 1) * q.dilation + 1;
    const In* xg = x + bi * q.sb + (long long)g * cg * q.sc;
    __syncthreads();                 // the last tile's window has been read
    if (channels_fast) {
      for (int w = warp; w < span; w += kWarps)
        for (int c = lane; c < cg; c += 32)
          win[w * cg + c] = column_value<Out>(input_value(xg, q, p0 + w, c),
                                              s);
    } else {
      for (int c = warp; c < cg; c += kWarps)
        for (int w = lane; w < span; w += 32)
          win[w * cg + c] = column_value<Out>(input_value(xg, q, p0 + w, c),
                                              s);
    }
    __syncthreads();
    // a row takes kWarps / rows warps when the tile has fewer rows than
    // warps (a long-K conv whose window fits one row at a time)
    const Out zero = column_value<Out>(0.0f, 1.0f);
    const int per_row = rows >= kWarps ? 1 : kWarps / rows;
    const int j0 = lane + 32 * (warp % per_row), step = 32 * per_row;
    const int step_c = step / q.k, step_tap = step % q.k;
    for (int r = warp / per_row; r < rows; r += kWarps / per_row) {
      Out* o = out + ((bi * q.lout + lo0 + r) * q.groups + g) * q.kp;
      const Out* wr = win + r * q.stride * cg;
      int c = j0 / q.k, tap = j0 % q.k;
      for (int j = j0; j < q.kp; j += step) {
        o[j] = j < kg ? wr[tap * q.dilation * cg + c] : zero;
        c += step_c;
        tap += step_tap;
        if (tap >= q.k) {
          tap -= q.k;
          ++c;
        }
      }
    }
  }
}

// The prologue for a window too wide for shared memory (a Linear over
// hundreds of thousands of features, MLP's layer_0): no window. A block
// takes kDirectCols columns of one row at a time, each thread 8 of them
// 256 apart, straight from x, so a channels-last row is read once at
// consecutive addresses for k = 1, 8 loads in flight a thread. Bit-equal
// to the windowed kernel (the same column_value).
constexpr int kDirectCols = 2048;

template <typename In, typename Out>
__global__ void __launch_bounds__(256)
    columns_direct_kernel(const In* __restrict__ x, Out* __restrict__ out,
                          const float* __restrict__ scale, const Columns q) {
  const int cg = q.channels / q.groups, kg = cg * q.k;
  const long long chunks = (q.kp + kDirectCols - 1) / kDirectCols;
  const float s = scale ? *scale : 1.0f;
  const Out zero = column_value<Out>(0.0f, 1.0f);
  for (long long t = blockIdx.x; t < q.tiles * chunks; t += gridDim.x) {
    const long long r = t / chunks;          // (b lout + lo) groups + g
    const int j0 = (int)(t - r * chunks) * kDirectCols + threadIdx.x;
    const int g = (int)(r % q.groups);
    const long long bl = r / q.groups;
    const long long bi = bl / q.lout;
    const int p0 = (int)(bl - bi * q.lout) * q.stride - q.pad_lo;
    const In* xg = x + bi * q.sb + (long long)g * cg * q.sc;
    Out* o = out + r * q.kp;
#pragma unroll
    for (int i = 0; i < kDirectCols / 256; ++i) {
      const int j = j0 + i * 256;
      if (j < q.kp) {
        Out v = zero;
        if (j < kg) {
          const int c = j / q.k, tap = j - c * q.k;
          v = column_value<Out>(
              input_value(xg, q, p0 + tap * q.dilation, c), s);
        }
        o[j] = v;
      }
    }
  }
}

template <typename In, typename Out>
int launch_columns(const void* x, void* out, const float* scale,
                   const long long* strides, long long batch,
                   long long length, long long channels, long long lout,
                   int k, int stride, int dilation, int pad_lo, int groups,
                   long long kp, cudaStream_t stream) {
  if (length >= (1LL << 31) || channels >= (1LL << 31) ||
      lout >= (1LL << 31) || kp >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const long long cg = channels / groups;
  auto window = [&](long long rows) {
    return ((rows - 1) * stride + (long long)(k - 1) * dilation + 1) * cg *
           (long long)sizeof(Out);
  };
  long long rows = 64;              // the most rows whose window fits in
  while (rows > 1 && window(rows) > 48 * 1024) rows /= 2;   // 48 KB
  const long long bytes = window(rows);
  if (bytes > 200 * 1024) {         // one row's window: no shared memory
    const Columns q{strides[0], strides[1], strides[2],
                    batch * lout * groups, (int)length, (int)channels,
                    (int)lout, k, stride, dilation, pad_lo, groups, (int)kp,
                    1};
    const unsigned blocks = (unsigned)std::min(
        q.tiles * ((kp + kDirectCols - 1) / kDirectCols), 132LL * 16);
    columns_direct_kernel<In, Out><<<blocks, 256, 0, stream>>>(
        static_cast<const In*>(x), static_cast<Out*>(out), scale, q);
    return (int)cudaGetLastError();
  }
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        columns_kernel<In, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const Columns q{strides[0], strides[1], strides[2],
                  batch * groups * ((lout + rows - 1) / rows),
                  (int)length, (int)channels, (int)lout, k, stride,
                  dilation, pad_lo, groups, (int)kp, (int)rows};
  const unsigned blocks = (unsigned)std::min(q.tiles, 132LL * 16);
  columns_kernel<In, Out><<<blocks, 256, (size_t)bytes, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), scale, q);
  return (int)cudaGetLastError();
}

// The 3-D prologue. One block takes a run of up to tile_rows output rows
// along Wo at one (batch item, t_out, h_out). It reads the window those
// rows cover -- kt x kh lines of span = (rows - 1) sw + kw positions along
// W, each of C channels, zeros in the padding -- once, quantizes (or
// casts) each value once into shared memory, and then writes the rows
// from there. Lanes run over a line's (position, channel) pairs flattened,
// so a channels-last x is read at consecutive addresses whatever C is
// (the stems' C = 3 included). The rows are written in 4-byte words of
// 4 int8 (or 2 bf16) columns, neighbouring lanes on neighbouring words of
// a row; each thread finds its words' window offsets once, and where a
// row has fewer words than the block has threads the threads split the
// rows among them.
struct Columns3d {
  long long sb, st, sh, sw, sc;   // x's strides in elements
  long long tiles;                // batch x To x Ho x runs along Wo
  int t, h, w, c;                 // x's sizes
  int kt, kh, kw;                 // the kernel
  int vt, vh, vw;                 // the strides
  int pt, ph, pw;                 // the low (and high) pads
  int to, ho, wo;                 // the output's sizes
  int k, kp, tile_rows;           // columns, padded columns, rows a block
};

template <typename In, typename Out>
__global__ void __launch_bounds__(256)
    columns3d_kernel(const In* __restrict__ x, Out* __restrict__ out,
                     const float* __restrict__ scale, const Columns3d q) {
  extern __shared__ __align__(16) unsigned char window_bytes[];
  Out* win = reinterpret_cast<Out*>(window_bytes);
  constexpr int kPer = 4 / (int)sizeof(Out);     // columns in a word
  const int words = q.kp / kPer, taps = q.kt * q.kh * q.kw;
  const int plane = q.kh * q.kw;
  const long long runs = (q.wo + q.tile_rows - 1) / q.tile_rows;
  const float s = scale ? *scale : 1.0f;
  const Out zero = column_value<Out>(0.0f, 1.0f);
  // words a thread steps over, and the rows it takes of each
  const int nthreads = (int)blockDim.x;
  const bool wide = words >= nthreads;
  const int lane = wide ? (int)threadIdx.x : (int)threadIdx.x % words;
  const int wstep = wide ? nthreads : words;
  const int rstep = wide ? 1 : nthreads / words;
  // threads past the last whole group of words take no rows
  const int r0 = wide ? 0
                      : (int)threadIdx.x < rstep * words
                            ? (int)threadIdx.x / words
                            : q.tile_rows;
  unsigned* out_words = reinterpret_cast<unsigned*>(out);
  for (long long tile = blockIdx.x; tile < q.tiles; tile += gridDim.x) {
    long long rest = tile;
    const int run = (int)(rest % runs);
    rest /= runs;
    const int ho = (int)(rest % q.ho);
    rest /= q.ho;
    const int to = (int)(rest % q.to);
    const long long bi = rest / q.to;
    const int wo0 = run * q.tile_rows;
    const int rows = min(q.tile_rows, q.wo - wo0);
    const int line = ((rows - 1) * q.vw + q.kw) * q.c;   // values a line
    const int w0 = wo0 * q.vw - q.pw;
    const In* xb = x + bi * q.sb;
    __syncthreads();                 // the last tile's window has been read
    for (int i = threadIdx.x; i < q.kt * q.kh * line; i += nthreads) {
      const int l = i / line, r = i - l * line;
      const int dt = l / q.kh, dh = l - dt * q.kh;
      const int wi = r / q.c, c = r - wi * q.c;
      const int ti = to * q.vt - q.pt + dt, hi = ho * q.vh - q.ph + dh;
      const int wx = w0 + wi;
      float f = 0.0f;
      if (ti >= 0 && ti < q.t && hi >= 0 && hi < q.h && wx >= 0 &&
          wx < q.w) {
        const In v = xb[ti * q.st + hi * q.sh + wx * q.sw + c * q.sc];
        if constexpr (sizeof(In) == 2)
          f = __bfloat162float(v);
        else
          f = v;
      }
      win[i] = column_value<Out>(f, s);
    }
    __syncthreads();
    const long long row0 =
        ((bi * q.to + to) * q.ho + ho) * (long long)q.wo + wo0;
    for (int wd = lane; wd < words; wd += wstep) {
      int off[kPer];
#pragma unroll
      for (int v = 0; v < kPer; ++v) {
        const int j = wd * kPer + v;
        if (j < q.k) {
          const int c = j / taps, tap = j - c * taps;
          const int dt = tap / plane, rem = tap - dt * plane;
          const int dh = rem / q.kw, dw = rem - dh * q.kw;
          off[v] = (dt * q.kh + dh) * line + dw * q.c + c;
        } else {
          off[v] = -1;
        }
      }
      for (int r = r0; r < rows; r += rstep) {
        const int shift = r * q.vw * q.c;
        unsigned word = 0;
#pragma unroll
        for (int v = 0; v < kPer; ++v) {
          const Out val = off[v] >= 0 ? win[off[v] + shift] : zero;
          unsigned bits;
          if constexpr (sizeof(Out) == 1)
            bits = (unsigned)(unsigned char)val;
          else
            bits = (unsigned)__bfloat16_as_ushort(val);
          word |= bits << (8 * (int)sizeof(Out) * v);
        }
        out_words[(row0 + r) * words + wd] = word;
      }
    }
  }
}

template <typename In, typename Out>
int launch_columns3d(const void* x, void* out, const float* scale,
                     const long long* shape, const long long* strides,
                     const int* kernel, const int* stride, const int* pads,
                     const int* dims, long long kp, cudaStream_t stream) {
  const long long c = shape[4];
  const long long k = c * kernel[0] * kernel[1] * kernel[2];
  auto window = [&](long long rows) {
    return (long long)kernel[0] * kernel[1] *
           ((rows - 1) * stride[2] + kernel[2]) * c * (long long)sizeof(Out);
  };
  long long rows = std::min<long long>(64, dims[2]);   // the most rows
  while (rows > 1 && window(rows) > 48 * 1024)          // whose window
    rows = (rows + 1) / 2;                              // fits in 48 KB
  const long long bytes = window(rows);
  if (bytes > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        columns3d_kernel<In, Out>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long runs = (dims[2] + rows - 1) / rows;
  const Columns3d q{strides[0], strides[1], strides[2], strides[3],
                    strides[4],
                    shape[0] * dims[0] * dims[1] * runs,
                    (int)shape[1], (int)shape[2], (int)shape[3], (int)c,
                    kernel[0], kernel[1], kernel[2],
                    stride[0], stride[1], stride[2],
                    pads[0], pads[1], pads[2],
                    dims[0], dims[1], dims[2],
                    (int)k, (int)kp, (int)rows};
  const unsigned blocks = (unsigned)std::min(q.tiles, 132LL * 16);
  columns3d_kernel<In, Out><<<blocks, 256, (size_t)bytes, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(out), scale, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The product C = A B^T per group, with the epilogue of ``kind`` (0: the
// int32 / f32 sums; 1: f32 and 2: bf16 of float(sum) * s + bias, s =
// scale[n] * *input_scale when input_scale is given, else scale[n]; the
// bias bf16 when bias_bf16, else f32).
// mode: 0 int8 x int8, 1 bf16 x bf16, 2 bf16 x int8 (B widened). K runs
// over k_bytes bytes of A (B's int8 rows over half as many in mode 2);
// a_bytes / b_bytes bytes of each row are read and the rest reads as
// zeros. With splits > 1, ``work`` holds
// (splits, groups, m, n) partial sums (int32 or f32) and a second kernel
// finishes. Strides: lda, ldb, a_group, b_group in bytes; ldc, c_group in
// elements. Returns a cudaError_t (0 = launched); cudaErrorInvalidValue
// for a non-positive size, a mode or kind it does not know, no copy width
// of 4 bytes or more, a missing scale, splits without a workspace, or an
// int8 K past 131,072 padded bytes (the wrapper refuses K above 131,071).
int mmcsi_int8_matmul(const void* a, const void* b, void* c, void* work,
                      const float* scale, const float* input_scale,
                      const void* bias, int bias_bf16, int mode, int kind,
                      int groups, int splits, long long m,
                      long long n, long long k_bytes, long long a_bytes,
                      long long lda, long long a_group, long long b_bytes,
                      long long ldb, long long b_group, long long ldc,
                      long long c_group, void* stream) {
  Product p{static_cast<const unsigned char*>(a),
            static_cast<const unsigned char*>(b),
            c, splits > 1 ? work : nullptr, scale, input_scale, bias, m, n,
            a_bytes, lda, a_group, b_bytes, ldb, b_group, ldc, c_group,
            0, 0, groups, splits, kind, bias_bf16, Conv{}};
  if (groups <= 0 || m <= 0 || n <= 0 || k_bytes <= 0 || splits <= 0 ||
      kind < 0 || kind > 2 || (kind && !scale) ||
      (splits > 1 && !work) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (mode == 0 && k_bytes > kMaxKS8 + 1)
    return (int)cudaErrorInvalidValue;
  const int v = widest_copy(p);
  if (!v) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch_mode<0>(p, k_bytes, v, s);
    case 1:
      return launch_mode<1>(p, k_bytes, v, s);
    default:
      return launch_mode<2>(p, k_bytes, v, s);
  }
}

// The implicit conv: the product of the codes a (shape[0..4] = B, T, H,
// W, Cp; contiguous; int8 in mode 0, bf16 in mode 2) under a kernel
// (kt, kh, kw) at strides stride[0..2] with symmetric zero pads pads[0..2],
// whose output sizes dims[0..2] the caller computed, and the tap-major
// int8 weight b (N rows ldb bytes apart, kt kh kw Cp values of each read),
// with ``kind``'s epilogue into c (B To Ho Wo, N) as mmcsi_int8_matmul's;
// splits > 1 as there. Returns a cudaError_t; cudaErrorInvalidValue for a
// mode other than 0 or 2, a row of codes (Cp bytes of each) that is not 16
// n bytes with n >= 1, an unaligned a, b or ldb, an int8 K past 131,072
// bytes, or a shape it does not take.
int mmcsi_int8_conv3d(const void* a, const void* b, void* c, void* work,
                      const float* scale, const float* input_scale,
                      const void* bias, int bias_bf16, int mode, int kind,
                      int splits, const long long* shape, const int* kernel,
                      const int* stride, const int* pads, const int* dims,
                      long long n, long long ldb, void* stream) {
  const long long ea = mode == 0 ? 1 : 2;
  const long long cpe = shape[4] * ea;
  bool bad = (mode != 0 && mode != 2) || kind < 0 || kind > 2 ||
             (kind && !scale) || splits <= 0 || (splits > 1 && !work) ||
             n <= 0 || cpe < 16 || cpe % 16 || cpe >= (1LL << 31) ||
             ldb <= 0 || ldb % 16 ||
             ((reinterpret_cast<std::uintptr_t>(a) |
               reinterpret_cast<std::uintptr_t>(b)) & 15);
  long long taps = 1, rows = shape[0];
  for (int i = 0; i < 4; ++i)
    bad = bad || shape[i] <= 0 || shape[i] >= (1LL << 31);
  for (int i = 0; i < 3; ++i) {
    bad = bad || kernel[i] <= 0 || stride[i] <= 0 || pads[i] < 0 ||
          dims[i] <= 0 ||
          dims[i] != (shape[1 + i] + 2 * pads[i] - kernel[i]) / stride[i] + 1;
    taps *= kernel[i];
    rows *= dims[i];
  }
  const long long k_bytes = taps * cpe;
  if (bad || ldb < taps * shape[4] || (mode == 0 && k_bytes > kMaxKS8 + 1))
    return (int)cudaErrorInvalidValue;
  Product p{static_cast<const unsigned char*>(a),
            static_cast<const unsigned char*>(b),
            c, splits > 1 ? work : nullptr, scale, input_scale, bias, rows, n,
            k_bytes, cpe, 0, taps * shape[4], ldb, 0, n, 0,
            0, 0, 1, splits, kind, bias_bf16,
            Conv{(int)shape[1], (int)shape[2], (int)shape[3],
                 dims[0], dims[1], dims[2],
                 kernel[0], kernel[1], kernel[2],
                 stride[0], stride[1], stride[2],
                 pads[0], pads[1], pads[2], (int)cpe}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mode == 0 ? launch_mode<0, true>(p, k_bytes, 16, s)
                   : launch_mode<2, true>(p, k_bytes, 16, s);
}

// The prologue: x (batch, length, channels) at element strides
// strides[0..2] (non-negative), bf16 (in_dtype 1) or f32 (0); out (batch
// lout, groups, kp) contiguous, int8 (out_dtype 0, quantized by *scale) or
// bf16 (1, cast); kp a multiple of 16 bytes of the output type, out
// 16-byte aligned. Returns a cudaError_t; cudaErrorInvalidValue for a
// shape or type it does not take.
int mmcsi_int8_columns(const void* x, void* out, const float* scale,
                       const long long* strides, int in_dtype,
                       int out_dtype, long long batch,
                       long long length, long long channels, long long lout,
                       int k, int stride, int dilation, int pad_lo,
                       int groups, long long kp, void* stream) {
  const int per = out_dtype == 0 ? 16 : 8;
  if (batch <= 0 || length <= 0 || channels <= 0 || lout <= 0 || k <= 0 ||
      stride <= 0 || dilation <= 0 || groups <= 0 || channels % groups ||
      kp % per || kp < channels / groups * k || in_dtype < 0 ||
      in_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      (out_dtype == 0 && !scale) || strides[0] < 0 || strides[1] < 0 ||
      strides[2] < 0 || (reinterpret_cast<std::uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (in_dtype == 0 && out_dtype == 0)
    return launch_columns<float, signed char>(
        x, out, scale, strides, batch, length, channels, lout, k, stride,
        dilation, pad_lo, groups, kp, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_columns<bf16, signed char>(
        x, out, scale, strides, batch, length, channels, lout, k, stride,
        dilation, pad_lo, groups, kp, s);
  if (in_dtype == 0)
    return launch_columns<float, bf16>(x, out, nullptr, strides, batch,
                                       length, channels, lout, k, stride,
                                       dilation, pad_lo, groups, kp, s);
  return launch_columns<bf16, bf16>(x, out, nullptr, strides, batch, length,
                                    channels, lout, k, stride, dilation,
                                    pad_lo, groups, kp, s);
}

// The 3-D prologue: x (shape[0..4] = B, T, H, W, C) at element strides
// strides[0..4] (non-negative), bf16 (in_dtype 1) or f32 (0); a kernel
// (kt, kh, kw) at strides stride[0..2] with symmetric zero pads
// pads[0..2], whose output sizes dims[0..2] the caller computed; out (B
// To Ho Wo, kp) contiguous, int8 (out_dtype 0, quantized by *scale) or
// bf16 (1, cast); kp a multiple of 16 bytes of the output type, at least
// C kt kh kw, out 16-byte aligned. Returns a cudaError_t;
// cudaErrorInvalidValue for a shape or type it does not take (a window
// of one output row past 200 KB of shared memory among them).
int mmcsi_int8_columns3d(const void* x, void* out, const float* scale,
                         const long long* shape, const long long* strides,
                         const int* kernel, const int* stride,
                         const int* pads, const int* dims, int in_dtype,
                         int out_dtype, long long kp, void* stream) {
  const int per = out_dtype == 0 ? 16 : 8;
  bool bad = in_dtype < 0 || in_dtype > 1 || out_dtype < 0 ||
             out_dtype > 1 || (out_dtype == 0 && !scale) || kp % per ||
             (reinterpret_cast<std::uintptr_t>(out) & 15);
  long long taps = 1, rows = 1;
  for (int i = 0; i < 5; ++i)
    bad = bad || shape[i] <= 0 || shape[i] >= (1LL << 31) || strides[i] < 0;
  for (int i = 0; i < 3; ++i) {
    bad = bad || kernel[i] <= 0 || stride[i] <= 0 || pads[i] < 0 ||
          dims[i] <= 0 ||
          dims[i] != (shape[1 + i] + 2 * pads[i] - kernel[i]) / stride[i] + 1;
    taps *= kernel[i];
    rows *= dims[i];
  }
  if (bad || kp < shape[4] * taps || kp >= (1LL << 31) ||
      shape[0] * rows >= (1LL << 40))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_columns3d<float, signed char>(
        x, out, scale, shape, strides, kernel, stride, pads, dims, kp, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_columns3d<bf16, signed char>(
        x, out, scale, shape, strides, kernel, stride, pads, dims, kp, s);
  if (in_dtype == 0)
    return launch_columns3d<float, bf16>(x, out, nullptr, shape, strides,
                                         kernel, stride, pads, dims, kp, s);
  return launch_columns3d<bf16, bf16>(x, out, nullptr, shape, strides,
                                      kernel, stride, pads, dims, kp, s);
}

}  // extern "C"
