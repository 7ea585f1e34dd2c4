// The jaxrng draws (gridgcn_torch/utils/jaxrng.py) as one kernel a draw.
//
// Built by gridgcn_torch/kernels/rng.py once, at the first draw on a CUDA
// device:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -fmad=false -o librng-<hash>.so rng.cu
// Plain C interface, loaded with ctypes. rng_draw_launch enqueues one kernel
// on the caller's stream, does not synchronise, allocates nothing (the
// wrapper allocates the output), and returns cudaGetLastError().
//
// Replaces no TPU kernel: the JAX package draws with jax.random, which XLA
// fuses into the program's own loops. The port's plain version (the op's CPU
// implementation, kernels/rng.py draw_ref) hashes with masked int64 torch
// ops, ~170-180 kernels a draw on the card. Here element i of key row b is
// the threefry2x32 hash of the counter (0, off + i) under that row's key
// (JAX's partitionable layout: the flat row-major index), then one of three
// epilogues, chosen at compile time:
//   kBits     x0 ^ x1, stored as int64 (callers do int64 arithmetic on it);
//   kUniform  the top 23 bits as the mantissa of a float in [1, 2), minus 1;
//             unless (lo, scale) is (0, 1), f * scale + lo rounded once to
//             float32 (XLA:CPU's fused multiply-add) and clamped below at lo;
//   kGumbel   -log(-log(u)) of that uniform, each log XLA:CPU's Cephes log
//             (utils/xla_math.py log) repeated operation for operation.
// Every float operation is an explicitly rounded intrinsic and the file is
// built with -fmad=false, so nothing is contracted: the values are the plain
// version's bit for bit, which are JAX's on the CPU.
//
// Bound: latency. A whole-scene draw writes at most 81920 int64 (0.66 MB,
// ~0.2 us at 3.35 TB/s) and hashes with ~100 integer operations a value
// (~8e6, a few us over 132 SMs); a draw's cost is its launch. One thread a
// value, a grid-stride loop. The keys are read from a device int64
// [rows, 2] (kernels/rng.py copies a numpy key there without blocking).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

enum Epilogue : int { kBits = 0, kUniform = 1, kGumbel = 2 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of the counter (0, x1) under (k0, k1), halves XOR-ed: 20
// rounds, a key injection every 4 (jaxrng.py _threefry2x32)
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = k0;
  x1 += k1;
#define ROUND(r) x0 += x1; x1 = rotl(x1, r); x1 ^= x0;
#define ROUNDS_A ROUND(13) ROUND(15) ROUND(26) ROUND(6)
#define ROUNDS_B ROUND(17) ROUND(29) ROUND(16) ROUND(24)
  ROUNDS_A x0 += k1; x1 += k2 + 1u;
  ROUNDS_B x0 += k2; x1 += k0 + 2u;
  ROUNDS_A x0 += k0; x1 += k1 + 3u;
  ROUNDS_B x0 += k1; x1 += k2 + 4u;
  ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef ROUNDS_B
#undef ROUNDS_A
#undef ROUND
  return x0 ^ x1;
}

// a * b + c rounded once to float32: the double product is exact, the
// double sum rounds (utils/xla_math.py fma32)
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

// utils/xla_math.py log, operation for operation; its constants rounded to
// float32, written exactly
constexpr float kTiny = 0x1p-126f;
__device__ float xla_log(float x) {
  x = x < kTiny ? kTiny : x;
  const int xb = __float_as_int(x);
  float e = __fadd_rn(static_cast<float>((xb >> 23) - 0x7F), 1.0f);
  const float m = __int_as_float((xb & ~0x7F800000) | 0x3F000000);
  const bool low = m < 0x1.6a09e6p-1f;
  e = __fsub_rn(e, low ? 1.0f : 0.0f);
  x = __fadd_rn(__fsub_rn(m, 1.0f), low ? m : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float y = fma32(fma32(x, 0x1.204376p-4f, -0x1.d7a37p-4f), x,
                  0x1.de4a34p-4f);
  const float y1 = fma32(fma32(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x,
                         -0x1.555cap-3f);
  const float y2 = fma32(fma32(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x,
                         0x1.555554p-2f);
  y = fma32(fma32(y, x3, y1), x3, y2);
  y = fma32(y, x3, __fmul_rn(-0x1.bd0106p-13f, e));
  x = __fsub_rn(x, __fmul_rn(0.5f, x2));
  x = __fadd_rn(x, y);
  return __fadd_rn(x, __fmul_rn(0x1.63p-1f, e));
}

__device__ __forceinline__ float uniform(uint32_t b, float lo, float scale) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  if (lo == 0.0f && scale == 1.0f) return f;
  const float v = fma32(f, scale, lo);
  return v < lo ? lo : v;
}

template <int EPI>
__global__ void __launch_bounds__(kThreads)
    draw_kernel(const int64_t* __restrict__ keys, int64_t total, int64_t n,
                uint32_t off, float lo, float scale, void* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < total; j += stride) {
    const int64_t b = n == total ? 0 : j / n;
    const uint32_t i = static_cast<uint32_t>(j - b * n);
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * b]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * b + 1]);
    const uint32_t bits = threefry_bits(k0, k1, off + i);
    if constexpr (EPI == kBits) {
      static_cast<int64_t*>(out)[j] = static_cast<int64_t>(bits);
    } else {
      float u = uniform(bits, lo, scale);
      if constexpr (EPI == kGumbel) u = -xla_log(-xla_log(u));
      static_cast<float*>(out)[j] = u;
    }
  }
}

}  // namespace

// One draw of `rows` rows of n values each into `out` (int64 for kBits,
// float32 otherwise) under the keys `keys` (device int64 [rows, 2]).
// Counters off .. off + n - 1 (the caller keeps off + n <= 2^32).
extern "C" int rng_draw_launch(int epilogue, const int64_t* keys,
                               long long rows, long long n, unsigned int off,
                               float lo, float scale, void* out,
                               void* stream) {
  const int64_t total = static_cast<int64_t>(rows) * n;
  if (total <= 0) return 0;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (epilogue) {
    case kBits:
      draw_kernel<kBits><<<blocks, kThreads, 0, st>>>(keys, total, n, off, lo,
                                                      scale, out);
      break;
    case kUniform:
      draw_kernel<kUniform><<<blocks, kThreads, 0, st>>>(
          keys, total, n, off, lo, scale, out);
      break;
    case kGumbel:
      draw_kernel<kGumbel><<<blocks, kThreads, 0, st>>>(
          keys, total, n, off, lo, scale, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
