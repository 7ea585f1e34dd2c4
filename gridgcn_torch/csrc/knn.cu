// Hopper kernels for the decoder's 3-NN query ("flash-kNN").
//
// Built by gridgcn_torch/kernels/knn.py at first CUDA use:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libknn-<hash>.so knn.cu
// Plain C interface, loaded with ctypes. Each launch function enqueues one
// kernel on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() so that a refused launch is reported.
//
// Both kernels keep the [Nq, Ns] distance matrix out of device memory, as
// the TPU kernels did: one thread owns one query, walks every support
// column in ascending order and keeps its 3 nearest in registers. Support
// tiles are staged through shared memory, where all threads of a warp read
// the same column (a broadcast, no bank conflicts).
//
// Bound on the H100 at the main path's largest call (Nq 81920 x Ns 8192,
// 6.7e8 pairs): the inputs and outputs are ~5 MB (~1.5 us at 3.35 TB/s),
// so both kernels are bound by operations -- the per-pair distance
// arithmetic and the top-3 compare -- not by memory. This first version
// runs them on the CUDA cores; the K=16 split-bf16 contraction of
// knn3_mxu is exactly one mma.sync.m16n8k16 tile, the natural redesign
// for a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // queries per block, one per thread
constexpr int kTileExact = 1024;     // support columns per staged tile
constexpr int kTileMxu = 512;        // 512 columns x 16 rows x 4 B = 32 KB
constexpr float kBig = 1e30f;        // distance of a masked support
constexpr float kValidMax = 5e29f;   // d2 below this is a real neighbor

// Running top-3 of unique int32 keys, ascending: equal to three min passes
// that each exclude the earlier winners.
__device__ __forceinline__ void insert3(int key, int& k0, int& k1, int& k2) {
  if (key < k2) {
    if (key < k1) {
      k2 = k1;
      if (key < k0) {
        k1 = k0;
        k0 = key;
      } else {
        k1 = key;
      }
    } else {
      k2 = key;
    }
  }
}

// Running top-3 of (value, column), ascending. Columns arrive in ascending
// order and the compare is strict, so a tie keeps the lower column first.
__device__ __forceinline__ void insert3f(float d, int i, float& d0, int& i0,
                                         float& d1, int& i1, float& d2,
                                         int& i2) {
  if (d < d2) {
    if (d < d1) {
      d2 = d1;
      i2 = i1;
      if (d < d0) {
        d1 = d0;
        i1 = i0;
        d0 = d;
        i0 = i;
      } else {
        d1 = d;
        i1 = i;
      }
    } else {
      d2 = d;
      i2 = i;
    }
  }
}

// knn3_exact -- replaces the JAX package's ops/pallas/knn.py _knn_kernel
// (via flash_knn): exact k=3 NN, bit for bit.
//   d2  = (dx*dx + dy*dy) + dz*dz in fp32, each operation rounded on its
//         own (__f*_rn: no FMA contraction), 1e30 for masked supports and
//         for the padded columns Ns <= col < ns_pad;
//   key = (bits(d2) & ~low) | col, low = 2^idx_bits - 1;
//   the 3 smallest keys give idx = key & low and the truncated
//   d2 = bits(key & ~low), as the TPU kernel returns them.
// With fewer than 3 valid supports the invalid slots hold the lowest
// masked or padded columns (possibly >= Ns), as in the reference.
__global__ void __launch_bounds__(kThreads)
knn3_exact_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
                  const float* __restrict__ s, const uint8_t* __restrict__ s_mask,
                  int nq, int ns, int ns_pad, int idx_bits,
                  float* __restrict__ out_d, int* __restrict__ out_i,
                  uint8_t* __restrict__ out_v) {
  __shared__ float4 tile[kTileExact];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const int low = (1 << idx_bits) - 1;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < nq) {
    qx = q[3 * qi];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  int k0 = 0x7FFFFFFF, k1 = 0x7FFFFFFF, k2 = 0x7FFFFFFF;
  for (int c0 = 0; c0 < ns_pad; c0 += kTileExact) {
    const int n = min(kTileExact, ns_pad - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int c = c0 + t;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < ns) {
        v.x = s[3 * c];
        v.y = s[3 * c + 1];
        v.z = s[3 * c + 2];
        v.w = s_mask[c] ? 1.f : 0.f;
      }
      tile[t] = v;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float4 v = tile[t];
      const float dx = __fsub_rn(qx, v.x);
      const float dy = __fsub_rn(qy, v.y);
      const float dz = __fsub_rn(qz, v.z);
      float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                           __fmul_rn(dz, dz));
      d2 = v.w > 0.5f ? d2 : kBig;
      insert3((__float_as_int(d2) & ~low) | (c0 + t), k0, k1, k2);
    }
  }
  if (qi < nq) {
    const bool qv = q_mask[qi] != 0;
    const int keys[3] = {k0, k1, k2};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float d = __int_as_float(keys[j] & ~low);
      out_d[3 * qi + j] = d;
      out_i[3 * qi + j] = keys[j] & low;
      out_v[3 * qi + j] = (qv && d < kValidMax) ? 1 : 0;
    }
  }
}

// Split-bf16 halves of x: hi = x rounded to bf16, lo = the residual
// rounded to bf16 (x ~ hi + lo to ~2^-16 relative), as floats.
__device__ __forceinline__ void split_bf16(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(__fsub_rn(x, hi)));
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// Center of the valid supports' bounding box, c = (min + max) / 2 per axis
// (0 when no support is valid), reduced by the whole block; every thread
// returns it. The same value as kernels/knn.py mxu_center.
__device__ void support_center(const float* __restrict__ s,
                               const uint8_t* __restrict__ s_mask, int ns,
                               float c[3]) {
  __shared__ float red[2][3][kThreads / 32];
  const float inf = __int_as_float(0x7F800000);
  float mn[3] = {inf, inf, inf}, mx[3] = {-inf, -inf, -inf};
  for (int i = threadIdx.x; i < ns; i += kThreads) {
    if (s_mask[i]) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        mn[a] = fminf(mn[a], s[3 * i + a]);
        mx[a] = fmaxf(mx[a], s[3 * i + a]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      mn[a] = fminf(mn[a], __shfl_xor_sync(0xFFFFFFFFu, mn[a], off));
      mx[a] = fmaxf(mx[a], __shfl_xor_sync(0xFFFFFFFFu, mx[a], off));
    }
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      red[0][a][warp] = mn[a];
      red[1][a][warp] = mx[a];
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float lo = inf, hi = -inf;
    for (int w = 0; w < kThreads / 32; ++w) {
      lo = fminf(lo, red[0][a][w]);
      hi = fmaxf(hi, red[1][a][w]);
    }
    c[a] = lo <= hi ? __fmul_rn(__fadd_rn(lo, hi), 0.5f) : 0.f;
  }
}

// knn3_mxu -- replaces the JAX package's ops/pallas/knn.py _knn_kernel_mxu
// (via flash_knn_mxu): near-exact k=3 NN from the split-bf16 expanded form.
// Queries and supports are first moved by the same offset, the center c of
// the valid supports' bounding box: distances do not change, and the
// split error, which grows with |x|^2, then depends on the scene's extent
// and not on its offset from the origin (the TPU kernel splits the raw
// coordinates). Each query row and support column is then packed in
// registers / shared memory exactly as kernels/knn.py mxu_pack packs them:
//   q row: [q_hi | q_lo | q_hi | qn_hi qn_lo | 1 1 | 0 0 0],  qn = |q|^2+1
//   s col: [-2s_hi; -2s_hi; -2s_lo; 1 1; sn_hi sn_lo; 0 0 0], sn = |s|^2
// (sn = 1e30 for masked supports; padded columns Ns <= col < ns_pad carry
// only sn_hi = bf16(1e30)), so their K=16 product is d2 + 1. The 16
// products are exact in fp32 and summed by an FMA chain; the running top-3
// is exact, ties to the lower column -- the TPU kernel's lane-fold
// collisions (a j-th neighbor lost to a nearer one in the same lane) do not
// happen here. Outputs: d2 = max(d2+1 - 1, 0), idx = min(col, Ns-1),
// valid = d2 < 5e29 and the query is valid.
__global__ void __launch_bounds__(kThreads)
knn3_mxu_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
                const float* __restrict__ s, const uint8_t* __restrict__ s_mask,
                int nq, int ns, int ns_pad, float* __restrict__ out_d,
                int* __restrict__ out_i, uint8_t* __restrict__ out_v) {
  // tile[col][0..3] holds the column's 16 packed values as 4 float4
  __shared__ float4 tile[kTileMxu][4];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  float cen[3];
  support_center(s, s_mask, ns, cen);
  float qv[16];
  {
    float x[3] = {0.f, 0.f, 0.f};
    if (qi < nq) {
#pragma unroll
      for (int a = 0; a < 3; ++a) x[a] = __fsub_rn(q[3 * qi + a], cen[a]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      split_bf16(x[a], qv[a], qv[3 + a]);
      qv[6 + a] = qv[a];
    }
    split_bf16(__fadd_rn(sq_norm(x[0], x[1], x[2]), 1.0f), qv[9], qv[10]);
    qv[11] = 1.f;
    qv[12] = 1.f;
    qv[13] = qv[14] = qv[15] = 0.f;
  }
  const float inf = __int_as_float(0x7F800000);
  const float big_hi = __bfloat162float(__float2bfloat16_rn(kBig));
  float d0 = inf, d1 = inf, d2 = inf;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int c0 = 0; c0 < ns_pad; c0 += kTileMxu) {
    const int n = min(kTileMxu, ns_pad - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int c = c0 + t;
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = 0.f;
      if (c < ns) {
        const float x = __fsub_rn(s[3 * c], cen[0]);
        const float y = __fsub_rn(s[3 * c + 1], cen[1]);
        const float z = __fsub_rn(s[3 * c + 2], cen[2]);
        const float xs[3] = {x, y, z};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          float hi, lo;
          split_bf16(xs[a], hi, lo);
          v[a] = -2.f * hi;
          v[3 + a] = -2.f * hi;
          v[6 + a] = -2.f * lo;
        }
        v[9] = 1.f;
        v[10] = 1.f;
        split_bf16(s_mask[c] ? sq_norm(x, y, z) : kBig, v[11], v[12]);
      } else {
        v[11] = big_hi;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tile[t][r] = make_float4(v[4 * r], v[4 * r + 1], v[4 * r + 2],
                                 v[4 * r + 3]);
      }
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v = tile[t][r];
        acc = fmaf(qv[4 * r], v.x, acc);
        acc = fmaf(qv[4 * r + 1], v.y, acc);
        acc = fmaf(qv[4 * r + 2], v.z, acc);
        acc = fmaf(qv[4 * r + 3], v.w, acc);
      }
      insert3f(acc, c0 + t, d0, i0, d1, i1, d2, i2);
    }
  }
  if (qi < nq) {
    const bool qm = q_mask[qi] != 0;
    const float ds[3] = {d0, d1, d2};
    const int is[3] = {i0, i1, i2};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float d = fmaxf(ds[j] - 1.0f, 0.0f);
      out_d[3 * qi + j] = d;
      out_i[3 * qi + j] = min(is[j], ns - 1);
      out_v[3 * qi + j] = (qm && d < kValidMax) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int knn3_exact_launch(const float* q, const uint8_t* q_mask,
                                 const float* s, const uint8_t* s_mask,
                                 int nq, int ns, int ns_pad, int idx_bits,
                                 float* out_d, int* out_i, uint8_t* out_v,
                                 void* stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  knn3_exact_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits, out_d, out_i, out_v);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int knn3_mxu_launch(const float* q, const uint8_t* q_mask,
                               const float* s, const uint8_t* s_mask,
                               int nq, int ns, int ns_pad, float* out_d,
                               int* out_i, uint8_t* out_v, void* stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  knn3_mxu_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      q, q_mask, s, s_mask, nq, ns, ns_pad, out_d, out_i, out_v);
  return static_cast<int>(cudaGetLastError());
}
