// Hopper kernels for the decoder's 3-NN query ("flash-kNN").
//
// Built by gridgcn_torch/kernels/knn.py once for each list length k
// (1..16), and once for all the longer lists (17..128, -DKNN_K=0), at the
// first CUDA call that asks for it:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -DKNN_K=k -o libknn_k<k>-<hash>.so knn.cu
// Plain C interface, loaded with ctypes. Each launch function enqueues its
// kernels on the caller's stream, does not synchronise, allocates nothing
// (the wrapper allocates outputs and scratch), and returns
// cudaGetLastError() so that a refused launch is reported.
//
// Both kernels keep the [Nq, Ns] distance matrix out of device memory, as
// the TPU kernels did, and keep a running top-k per query in registers.
// They are templates on the list length K; a build instantiates them for
// K = KNN_K (1 <= KNN_K <= kMaxK = 16), one library per length, so that
// the 16 builds run side by side. The decoder's k = 3 is the main path,
// and its instantiation is the design described below. Lists of 17..128
// (the reference's bound: its kernels write or fold their winners into
// 128-lane rows) take the list kernels at the end of this file instead:
// one build, k a runtime argument, each list a warp queue spread over the
// registers of a warp's 32 lanes (WarpSelect).
// At the main path's largest call (Nq 81920 x Ns 8192, 6.7e8 pairs) the
// inputs and outputs are ~5 MB (~1.5 us at 3.35 TB/s), so both kernels are
// bound by operations, not by memory:
//
// * knn3_mxu (replaces the JAX package's ops/pallas/knn.py _knn_kernel_mxu)
//   runs the K=16 split-bf16 contraction on the tensor cores, one
//   mma.sync.m16n8k16 per 16 queries x 8 supports: 32 bf16 flop/pair at
//   989 TFLOP/s is 22 us. Selection needs at least one CUDA-core compare per
//   pair, ~20-25 us over 6.7e8 pairs on 132 SMs x 128 lanes, so a lane first
//   tests the smaller of its two new values against the row's threshold
//   and inserts only when one passes. A one-block pack kernel centers and
//   packs the supports once per call, in the order in which the B fragments
//   are read, so the main kernel only streams them through shared memory
//   (cp.async, double-buffered). The support axis is split across the warps
//   of a block when there are too few queries to fill the card.
// * knn3_exact (replaces _knn_kernel) stays fp32 on the CUDA cores with each
//   operation rounded on its own (8 flop/pair at 67 TFLOP/s is 82 us; each
//   of those takes a dispatch slot of its own, as do the key's pack and the
//   compare). Each thread owns 4 queries, so one shared-memory support load
//   feeds four independent chains, and a group of G lanes shares them and
//   splits the support columns, with G chosen so that the small decoder
//   calls fill the card too. A pair costs its 8 rounded operations and one
//   float compare against the threshold; the key's pack, the mask and the
//   insert (a branch-free min/max network) run only when one passes.
//
// The top-3 insert is a divergent branch, and what it costs depends on how
// often it is taken. The decoder's supports come sorted by voxel, so a scan
// in column order approaches each query slab by slab and finds a new
// third-nearest at almost every step. Both kernels therefore visit the
// columns in the order p -> p * step mod n (visit_step: step ~ 5n/8, coprime
// to n), which spreads consecutive visits over the whole scene, and test
// each candidate against a threshold that the lanes sharing a query agree
// on (the smallest of their third-best values): nothing above it can reach
// the merged top-3. Out-of-order visits keep knn3_mxu's tie rule (the lower
// column first) by comparing (value, column) pairs; knn3_exact's keys are
// unique.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kExactThreads = 256;   // knn3_exact: 8 warps a block
constexpr int kQ = 4;                // knn3_exact: queries per thread
constexpr int kShare = 32;           // knn3_exact: visits between agreements
constexpr int kMxuWarps = 4;         // knn3_mxu: 4 warps, 32 queries each
constexpr int kMxuThreads = 32 * kMxuWarps;
constexpr int kPackThreads = 1024;   // the one-block support pack
constexpr int kTileExact = 2048;     // exact: 2048 columns x 16 B = 32 KB
constexpr int kStageCols = 512;      // mxu: 512 columns x 32 B = 16 KB
constexpr int kRefresh = 4;          // mxu: n8 tiles between threshold updates
constexpr float kBig = 1e30f;        // distance of a masked support
constexpr float kValidMax = 5e29f;   // d2 below this is a real neighbor
constexpr int kKeyMax = 0x7FFFFFFF;
constexpr int kMasked = static_cast<int>(0x80000000u);  // staged column flag
constexpr int kMaxK = 16;            // the longest list instantiated
constexpr int kMaxListK = 128;       // the list kernels' longest list
#ifndef KNN_K
#define KNN_K 3
#endif
// 1..16: the register kernels for that k; 0: the list kernels (17..128)
static_assert(KNN_K >= 0 && KNN_K <= kMaxK, "KNN_K must be in 0..16");

// a * b mod n for 0 <= a < n + 256 and 0 <= b < n: a 32-bit remainder
// where the product fits (a 64-bit one is a slow library routine)
__host__ __device__ __forceinline__ int mul_mod(int a, int b, int n) {
  if (n <= 46340) return static_cast<int>(static_cast<unsigned>(a) * b % n);
  return static_cast<int>(static_cast<long long>(a) * b % n);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// The visit order's step for n columns (or n8 tiles): an odd number near
// 5n/8 that is coprime to n, so p -> p * step mod n is a bijection that
// puts consecutive visits far apart. kernels/knn.py visit_step is the same.
int visit_step(int n) {
  int a = (n * 5) / 8 | 1;
  for (;;) {
    int x = a, y = n;
    while (y != 0) {
      const int r = x % y;
      x = y;
      y = r;
    }
    if (x == 1) return a;
    a += 2;
  }
}

// (bits & hi) | col in one LOP3 (col has no bit of hi); the compiler
// emits two
__device__ __forceinline__ int pack_key(int bits, int hi, int col) {
  int k;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(k) : "r"(bits), "r"(hi),
      "r"(col));
  return k;
}

// Running top-K of unique int32 keys k[0] < ... < k[K-1], equal to K min
// passes that each exclude the earlier winners: a min/max network, no
// branch.
template <int K>
__device__ __forceinline__ void insert_key(int key, int (&k)[K]) {
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int u = max(k[j], key);
    k[j] = min(k[j], key);
    key = u;
  }
  k[K - 1] = min(k[K - 1], key);
}

// knn3_exact -- replaces the JAX package's ops/pallas/knn.py _knn_kernel
// (via flash_knn): exact K-NN, bit for bit.
//   d2  = (dx*dx + dy*dy) + dz*dz in fp32, each operation rounded on its
//         own (__f*_rn: no FMA contraction), 1e30 for masked supports and
//         for the padded columns Ns <= col < ns_pad;
//   key = (bits(d2) & ~low) | col, low = 2^idx_bits - 1;
//   the K smallest keys give idx = key & low and the truncated
//   d2 = bits(key & ~low), as the TPU kernel returns them.
// With fewer than K valid supports the invalid slots hold the lowest
// masked or padded columns (possibly >= Ns), as in the reference.
//
// Staged tile slot t of the tile at c0 holds column c = (c0 + t) * step
// mod ns_pad as {x, y, z, c}, with the sign bit of c set where the column
// is masked or padded. G consecutive lanes share kQ = 4 queries of the
// block (so one shared-memory load feeds 4 chains); lane l of the group
// visits slots l, l+G, ... . A pair's d2 first meets a float test that
// passes every key at or below the group's K-th best key once the low
// idx_bits are cut (and NaN): only then are the mask, the key and the
// insert computed. The group agrees on that key every kShare visits. Keys
// are unique, so the visit order does not matter and the group's top-K is
// K shuffle-min passes over the lanes' top-Ks.
template <int K, int G>
__global__ void __launch_bounds__(kExactThreads)
knn3_exact_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
                  const float* __restrict__ s, const uint8_t* __restrict__ s_mask,
                  int nq, int ns, int ns_pad, int idx_bits, int step,
                  float* __restrict__ out_d, int* __restrict__ out_i,
                  uint8_t* __restrict__ out_v) {
  // 32 slots past the tile for the last visits' prefetch
  __shared__ float4 tile[kTileExact + 32];
  constexpr int kQueries = kQ * kExactThreads / G;  // per block
  const int lig = threadIdx.x % G;                  // lane in group
  const int q0 = blockIdx.x * kQueries + kQ * (threadIdx.x / G);
  const int low = (1 << idx_bits) - 1;
  // the largest f32 whose key, cut to ~low, is at most k's (NaN for kKeyMax)
  auto bound = [low](int k) { return __int_as_float(k | low); };
  float p[kQ][3];
  int key[kQ][K];
  float tf[kQ];
#pragma unroll
  for (int h = 0; h < kQ; ++h) {
#pragma unroll
    for (int a = 0; a < 3; ++a) p[h][a] = q0 + h < nq ? q[3 * (q0 + h) + a] : 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) key[h][j] = kKeyMax;
    tf[h] = bound(kKeyMax);
  }
  const int stage_step = mul_mod(kExactThreads % ns_pad, step, ns_pad);
  for (int c0 = 0; c0 < ns_pad; c0 += kTileExact) {
    const int n = min(kTileExact, ns_pad - c0);    // a multiple of 128
    __syncthreads();
    int c = mul_mod(c0 + threadIdx.x, step, ns_pad);
    for (int t = threadIdx.x; t < n; t += kExactThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, __int_as_float(c | kMasked));
      if (c < ns) {
        v.x = s[3 * c];
        v.y = s[3 * c + 1];
        v.z = s[3 * c + 2];
        if (s_mask[c]) v.w = __int_as_float(c);
      }
      tile[t] = v;
      c += stage_step;
      if (c >= ns_pad) c -= ns_pad;
    }
    __syncthreads();
    float4 next = tile[lig];
#pragma unroll 4
    for (int i = 0; i < n / G; ++i) {
      const float4 v = next;
      next = tile[lig + (i + 1) * G];
      float d[kQ];
      bool pass = false;
#pragma unroll
      for (int h = 0; h < kQ; ++h) {
        const float dx = __fsub_rn(p[h][0], v.x);
        const float dy = __fsub_rn(p[h][1], v.y);
        const float dz = __fsub_rn(p[h][2], v.z);
        d[h] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz));
        pass |= !(d[h] > tf[h]);
      }
      if (pass) {
        const int w = __float_as_int(v.w);
        const int col = w & low;
#pragma unroll
        for (int h = 0; h < kQ; ++h) {
          const float dm = w >= 0 ? d[h] : kBig;
          insert_key<K>(pack_key(__float_as_int(dm), ~low, col), key[h]);
        }
      }
      if (i % kShare == kShare - 1) {
        // the group's lowest K-th best key bounds what can still enter
#pragma unroll
        for (int h = 0; h < kQ; ++h) {
          int k = key[h][K - 1];
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1) {
            k = min(k, __shfl_xor_sync(0xFFFFFFFFu, k, off));
          }
          tf[h] = bound(k);
        }
      }
    }
  }
  // merge the group's G lists: each pass takes the smallest head and the
  // lane that holds it moves on to its next key
  int top[kQ][K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int h = 0; h < kQ; ++h) {
      int m = key[h][0];
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) {
        m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
      }
      if (key[h][0] == m) {
#pragma unroll
        for (int i = 0; i < K - 1; ++i) key[h][i] = key[h][i + 1];
        key[h][K - 1] = kKeyMax;
      }
      top[h][j] = m;
    }
  }
  if (lig != 0) return;
#pragma unroll
  for (int h = 0; h < kQ; ++h) {
    const int qi = q0 + h;
    if (qi >= nq) continue;
    const bool qv = q_mask[qi] != 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float d = __int_as_float(top[h][j] & ~low);
      out_d[K * qi + j] = d;
      out_i[K * qi + j] = top[h][j] & low;
      out_v[K * qi + j] = (qv && d < kValidMax) ? 1 : 0;
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

// Two bf16 in one register, `lo` in the low half: the element with the
// lower K (or N) index of an mma fragment pair. Both values are already
// bf16, so the conversion is exact.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// mxu_pack -- once per knn3_mxu call, one block: the center c of the valid
// supports' bounding box, (min + max) / 2 per axis (0 when no support is
// valid), as kernels/knn.py mxu_center computes it, and every support
// column packed as kernels/knn.py mxu_pack packs it, moved by c first, in
// the visit order: packed n8 tile p holds the columns of tile p * step mod
// (ns_pad / 8). Each column is
//   s col: [-2s_hi; -2s_hi; -2s_lo; 1 1; sn_hi sn_lo; 0 0 0], sn = |s|^2
// (sn = 1e30 for masked supports; padded columns Ns <= col < ns_pad carry
// only sn_hi = bf16(1e30)). Packed column pc's 16 bf16 (32 B) sit at
// pack[2pc], pack[2pc + 1] in mma fragment order: positions 4t..4t+3 hold
// K = 2t, 2t+1, 2t+8, 2t+9, the b0 and b1 registers of the lane with
// threadID_in_group t, so one 8-byte load per lane reads both. center[0..2]
// = c, center[3] = 0.
__global__ void __launch_bounds__(kPackThreads)
mxu_pack_kernel(const float* __restrict__ s, const uint8_t* __restrict__ s_mask,
                int ns, int ns_pad, int step, uint4* __restrict__ pack,
                float* __restrict__ center) {
  __shared__ float red[2][3][kPackThreads / 32];
  __shared__ float cen[3];
  const float inf = __int_as_float(0x7F800000);
  float mn[3] = {inf, inf, inf}, mx[3] = {-inf, -inf, -inf};
  for (int i = threadIdx.x; i < ns; i += kPackThreads) {
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
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      red[0][a][threadIdx.x / 32] = mn[a];
      red[1][a][threadIdx.x / 32] = mx[a];
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    float lo = inf, hi = -inf;
    for (int w = 0; w < kPackThreads / 32; ++w) {
      lo = fminf(lo, red[0][a][w]);
      hi = fmaxf(hi, red[1][a][w]);
    }
    const float c = lo <= hi ? __fmul_rn(__fadd_rn(lo, hi), 0.5f) : 0.f;
    cen[a] = c;
    center[a] = c;
    if (a == 0) center[3] = 0.f;
  }
  __syncthreads();
  const float big_hi = __bfloat162float(__float2bfloat16_rn(kBig));
  const int ntiles = ns_pad / 8;
  for (int pc = threadIdx.x; pc < ns_pad; pc += kPackThreads) {
    const int c = mul_mod(pc / 8, step, ntiles) * 8 + pc % 8;
    float v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = 0.f;
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
    uint32_t w[8];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      w[2 * t] = bf16x2(v[2 * t], v[2 * t + 1]);
      w[2 * t + 1] = bf16x2(v[2 * t + 8], v[2 * t + 9]);
    }
    pack[2 * pc] = make_uint4(w[0], w[1], w[2], w[3]);
    pack[2 * pc + 1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// (d, i) before (e, j) in the order of three first-occurrence argmin passes
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// (d, i) into slot J or above of a top-K list it precedes at slot J: the
// entry at J - 1 moves down when (d, i) precedes it too. Nested branches,
// the shape the k = 3 kernel was tuned with: a loop with early exits
// compiled to a markedly slower knn3_mxu at k = 3.
template <int J, int K>
__device__ __forceinline__ void merge_from(float d, int i, float (&v)[K],
                                           int (&id)[K]) {
  if constexpr (J == 0) {
    v[0] = d;
    id[0] = i;
  } else {
    if (before(d, i, v[J - 1], id[J - 1])) {
      v[J] = v[J - 1];
      id[J] = id[J - 1];
      merge_from<J - 1, K>(d, i, v, id);
    } else {
      v[J] = d;
      id[J] = i;
    }
  }
}

// Top-K merge of lists from disjoint column sets, lexicographic: (d, i)
// enters where it precedes, the later entries move down one.
template <int K>
__device__ __forceinline__ void merge_k(float d, int i, float (&v)[K],
                                        int (&id)[K]) {
  if (before(d, i, v[K - 1], id[K - 1])) merge_from<K - 1, K>(d, i, v, id);
}

// The query row of the K=16 product, as kernels/knn.py mxu_pack packs it
// after moving q by the support center c:
//   q row: [q_hi | q_lo | q_hi | qn_hi qn_lo | 1 1 | 0 0 0],  qn = |q|^2+1
// so that row . col = d2 + 1. Rows past nq take q = c.
__device__ __forceinline__ void query_row(const float* __restrict__ q, int nq,
                                          int qi, const float (&c)[3],
                                          float (&v)[16]) {
  float x[3] = {0.f, 0.f, 0.f};
  if (qi < nq) {
#pragma unroll
    for (int a = 0; a < 3; ++a) x[a] = __fsub_rn(q[3 * qi + a], c[a]);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    split_bf16(x[a], v[a], v[3 + a]);
    v[6 + a] = v[a];
  }
  split_bf16(__fadd_rn(sq_norm(x[0], x[1], x[2]), 1.0f), v[9], v[10]);
  v[11] = 1.f;
  v[12] = 1.f;
  v[13] = v[14] = v[15] = 0.f;
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// knn3_mxu -- replaces the JAX package's ops/pallas/knn.py _knn_kernel_mxu
// (via flash_knn_mxu): near-exact K-NN from the split-bf16 expanded form.
// Queries and supports are moved by the same offset, the support center c
// (mxu_pack_kernel): distances do not change, and the split error, which
// grows with |x|^2, then depends on the scene's extent and not on its
// offset from the origin (the TPU kernel splits the raw coordinates).
//
// A warp owns 32 queries, two m16 tiles, whose A fragments it packs once in
// registers; SPLIT warps of the block share those queries and take every
// SPLIT-th n8 tile of each staged stage of packed columns. Per n8 tile a
// lane loads its B fragment (8 B), runs two mma.sync (d2 + 1 of 2 x 16
// queries x 8 supports in f32) and holds 2 columns of 4 query rows; it
// inserts them only where the smaller passes the row's threshold, the
// lowest K-th best value of the quad's four lanes (refreshed every
// kRefresh tiles). The top-K is exact with ties to the lower column: every
// insert and merge -- within the quad by shuffles, across the SPLIT warps
// through shared memory -- orders (value, column) pairs, as three
// first-occurrence argmin passes do. The TPU kernel's lane-fold collisions
// (a j-th neighbor lost to a nearer one in the same lane) do not happen
// here. Outputs: d2 = max(d2+1 - 1, 0), idx = min(col, Ns-1), valid =
// d2 < 5e29 and the query is valid.
// Registers hold 4 rows' lists of K (value, column) pairs: K = 3 keeps 4
// blocks an SM, longer lists take fewer.
template <int K, int SPLIT>
__global__ void __launch_bounds__(kMxuThreads, K <= 4 ? 4 : (K <= 8 ? 2 : 1))
knn3_mxu_kernel(const float* __restrict__ q, const uint8_t* __restrict__ q_mask,
                const uint4* __restrict__ pack, const float* __restrict__ center,
                int nq, int ns, int ns_pad, int step,
                float* __restrict__ out_d, int* __restrict__ out_i,
                uint8_t* __restrict__ out_v) {
  // two stages of 512 packed columns; reused for the cross-warp merge
  __shared__ __align__(16) uint4 stage[2][kStageCols * 2];
  constexpr int kQueries = 32 * kMxuWarps / SPLIT;   // per block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;     // mma groupID, thread in group
  const int part = warp % SPLIT;
  const int qw = (warp / SPLIT) * 32;       // the warp's first query, local
  const int qbase = blockIdx.x * kQueries;

  uint32_t a[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};
  {
    const float c[3] = {center[0], center[1], center[2]};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float r0[16], r1[16];
      query_row(q, nq, qbase + qw + 16 * mt + g, c, r0);
      query_row(q, nq, qbase + qw + 16 * mt + g + 8, c, r1);
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        if (tt == t) {
          a[mt][0] = bf16x2(r0[2 * tt], r0[2 * tt + 1]);
          a[mt][1] = bf16x2(r1[2 * tt], r1[2 * tt + 1]);
          a[mt][2] = bf16x2(r0[2 * tt + 8], r0[2 * tt + 9]);
          a[mt][3] = bf16x2(r1[2 * tt + 8], r1[2 * tt + 9]);
        }
      }
    }
  }
  // rows 2mt (query g of tile mt) and 2mt+1 (query g+8)
  const float inf = __int_as_float(0x7F800000);
  float bv[4][K], thr[4];
  int bi[4][K];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    thr[r] = inf;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bv[r][k] = inf;
      bi[r][k] = kKeyMax;
    }
  }

  const int ntiles = ns_pad / 8;
  const int n_stages = (ns_pad + kStageCols - 1) / kStageCols;
  const int warp_step = SPLIT * step % ntiles;
  auto load_stage = [&](int st) {
    const int c0 = st * kStageCols;
    const int n = 2 * min(kStageCols, ns_pad - c0);
    for (int i = threadIdx.x; i < n; i += kMxuThreads) {
      cp_async16(&stage[st & 1][i], &pack[2 * c0 + i]);
    }
  };
  load_stage(0);
  cp_async_commit();
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) load_stage(st + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int p0 = st * (kStageCols / 8);
    const int ntile = min(kStageCols, ns_pad - st * kStageCols) / 8;
    const uint2* buf = reinterpret_cast<const uint2*>(stage[st & 1]);
    // the original n8 tile of packed tile p0 + j
    int orig = mul_mod(p0 + part, step, ntiles);
    // ntile / SPLIT is a multiple of kRefresh: ntile is a multiple of 16
    for (int j0 = part; j0 < ntile; j0 += SPLIT * kRefresh) {
#pragma unroll
      for (int k = 0; k < kRefresh; ++k) {
        const uint2 b = buf[32 * (j0 + SPLIT * k) + lane];
        const int col = 8 * orig + 2 * t;
        orig += warp_step;
        if (orig >= ntiles) orig -= ntiles;
        float d[2][4];
        mma_bf16_16816(d[0], a[0], b.x, b.y);
        mma_bf16_16816(d[1], a[1], b.x, b.y);
        float m[4];
        bool pass = false;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          m[r] = fminf(d[r / 2][2 * (r % 2)], d[r / 2][2 * (r % 2) + 1]);
          pass |= m[r] <= thr[r];
        }
        if (pass) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (m[r] <= thr[r]) {
              merge_k<K>(d[r / 2][2 * (r % 2)], col, bv[r], bi[r]);
              merge_k<K>(d[r / 2][2 * (r % 2) + 1], col + 1, bv[r], bi[r]);
              thr[r] = fminf(thr[r], bv[r][K - 1]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = bv[r][K - 1];
        x = fminf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 1));
        thr[r] = fminf(x, __shfl_xor_sync(0xFFFFFFFFu, x, 2));
      }
    }
    __syncthreads();
  }

  // the quad's four lanes hold the same rows: merge them by shuffles
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float ov[K];
      int oi[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ov[k] = __shfl_xor_sync(0xFFFFFFFFu, bv[r][k], off);
        oi[k] = __shfl_xor_sync(0xFFFFFFFFu, bi[r][k], off);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) merge_k<K>(ov[k], oi[k], bv[r], bi[r]);
    }
  }
  // then the SPLIT warps that share the queries, through shared memory
  float* mv = reinterpret_cast<float*>(&stage[0][0]);   // [SPLIT][kQueries][K]
  int* mi = reinterpret_cast<int*>(&stage[1][0]);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int ql = qw + 16 * (r / 2) + 8 * (r % 2) + g;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        mv[(part * kQueries + ql) * K + k] = bv[r][k];
        mi[(part * kQueries + ql) * K + k] = bi[r][k];
      }
    }
  }
  __syncthreads();
  const int ql = threadIdx.x;
  const int qi = qbase + ql;
  if (ql >= kQueries || qi >= nq) return;
  float v[K];
  int id[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = mv[ql * K + k];
    id[k] = mi[ql * K + k];
  }
#pragma unroll
  for (int p = 1; p < SPLIT; ++p) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      merge_k<K>(mv[(p * kQueries + ql) * K + k],
                 mi[(p * kQueries + ql) * K + k], v, id);
    }
  }
  const bool qm = q_mask[qi] != 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float d = fmaxf(v[k] - 1.0f, 0.0f);
    out_d[K * qi + k] = d;
    out_i[K * qi + k] = min(id[k], ns - 1);
    out_v[K * qi + k] = (qm && d < kValidMax) ? 1 : 0;
  }
}

// Blocks of `queries_per_block` queries that cover nq.
int blocks_for(int nq, int queries_per_block) {
  return (nq + queries_per_block - 1) / queries_per_block;
}

template <int K>
int exact_launch(const float* q, const uint8_t* q_mask, const float* s,
                 const uint8_t* s_mask, int nq, int ns, int ns_pad,
                 int idx_bits, float* out_d, int* out_i, uint8_t* out_v,
                 cudaStream_t st) {
  const int step = visit_step(ns_pad);
  // lanes per kQ queries: the fewest that still give every SM 4 blocks
  const int want = 4 * sm_count();
  const int b4 = blocks_for(nq, kQ * kExactThreads / 4);
  const int b8 = blocks_for(nq, kQ * kExactThreads / 8);
  const int b16 = blocks_for(nq, kQ * kExactThreads / 16);
  const int b32 = blocks_for(nq, kQ * kExactThreads / 32);
  if (b4 >= want) {
    knn3_exact_kernel<K, 4><<<b4, kExactThreads, 0, st>>>(
        q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits, step, out_d, out_i,
        out_v);
  } else if (b8 >= want) {
    knn3_exact_kernel<K, 8><<<b8, kExactThreads, 0, st>>>(
        q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits, step, out_d, out_i,
        out_v);
  } else if (b16 >= want) {
    knn3_exact_kernel<K, 16><<<b16, kExactThreads, 0, st>>>(
        q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits, step, out_d, out_i,
        out_v);
  } else {
    knn3_exact_kernel<K, 32><<<b32, kExactThreads, 0, st>>>(
        q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits, step, out_d, out_i,
        out_v);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int mxu_launch(const float* q, const uint8_t* q_mask, const uint4* pack,
               const float* center, int nq, int ns, int ns_pad, float* out_d,
               int* out_i, uint8_t* out_v, cudaStream_t st) {
  const int step = visit_step(ns_pad / 8);
  // warps sharing a query tile: the fewest that still give every SM 4
  // blocks (each SPLIT-th n8 tile of a stage goes to one of them)
  const int want = 4 * sm_count();
  const int b1 = blocks_for(nq, 32 * kMxuWarps);
  const int b2 = blocks_for(nq, 32 * kMxuWarps / 2);
  const int b4 = blocks_for(nq, 32 * kMxuWarps / 4);
  if (b1 >= want) {
    knn3_mxu_kernel<K, 1><<<b1, kMxuThreads, 0, st>>>(
        q, q_mask, pack, center, nq, ns, ns_pad, step, out_d, out_i, out_v);
  } else if (b2 >= want) {
    knn3_mxu_kernel<K, 2><<<b2, kMxuThreads, 0, st>>>(
        q, q_mask, pack, center, nq, ns, ns_pad, step, out_d, out_i, out_v);
  } else {
    knn3_mxu_kernel<K, 4><<<b4, kMxuThreads, 0, st>>>(
        q, q_mask, pack, center, nq, ns, ns_pad, step, out_d, out_i, out_v);
  }
  return static_cast<int>(cudaGetLastError());
}

#if KNN_K == 0
// ------------------------------------------------------------------------
// The list kernels: 17 <= k <= kMaxListK, k a runtime argument. A list of
// up to 128 does not fit in one lane's registers, so it is spread over a
// warp (WarpSelect: Johnson, Douze & Jegou, "Billion-scale similarity
// search with GPUs", section 4). Each query's running top-k is a warp
// queue of 32 * P keys sorted across the 32 lanes (slot r * 32 + lane in
// register r of that lane; P = ceil(k / 32) rounded up to a power of two
// for the bitonic networks, so 65..96 take four registers like 97..128),
// and each lane keeps a thread queue of T candidates in registers. A
// candidate is compared once with the queue's k-th key (the threshold, the
// same in every lane) and pushed only if it is smaller. When a thread
// queue is full somewhere in the warp (__any_sync), the warp merges: a
// bitonic sort of the 32 * T queued keys over shuffles, the lowest 32 * P
// of both sets by one min against the reversed sort, a bitonic merge, and
// a new threshold. No list lives in shared memory and no lane branches for
// longer than a push. Keys are unique (each carries its column), so the
// result is the k smallest in order whatever the visit order:
// knn3_exact_ref bit for bit, and knn3_mxu_ref's ties to the lower column.
// Both kernels run 8 warps a block and kListQ = 4 queries a warp, lanes
// across the columns, 16 resident warps an SM. At the main path's 81920 x
// 8192 and k = 128 a query makes ~700-900 pushes (k * (1 + ln(n / k))
// with a threshold that moves only at merges) and ~7-15 merges of ~30
// shuffle stages each. On an H100 80GB HBM3 at 700 W (chip_smoke.py) the
// four decoder calls at k = 128 take ~2.2 ms (exact) and ~5.2 ms (mxu),
// against ~14.7 ms for torch.topk(torch.cdist(q, s), k) and 58 / 108 ms
// for the lists in shared memory that these kernels replace.

constexpr int kListThreads = 256;   // both list kernels: 8 warps a block
constexpr int kListQ = 4;           // queries a warp
constexpr int kListQueries = kListThreads / 32 * kListQ;   // a block: 32
// Thread-queue lengths (powers of two), the fastest of 2, 4 and 8 on an
// H100 (PERF.md section 6)
constexpr int kListTExact = 8;
constexpr int kListTMxu = 4;
constexpr int kListTile = 2048;     // exact: 2048 columns x 16 B = 32 KB
constexpr int kListStage = 1024;    // mxu: 1024 packed columns x 32 B = 32 KB
constexpr int kListRound = 64;      // mxu: columns a warp computes at once
constexpr int kListRow = kListRound + 8;   // their row stride: no conflicts

// Warp-queue registers a lane holds for a list of k: ceil(k / 32) rounded
// up to a power of two.
int list_regs(int k) { return k <= 32 ? 1 : (k <= 64 ? 2 : 4); }

template <class K>
__device__ __forceinline__ K key_min(K a, K b) { return b < a ? b : a; }
template <class K>
__device__ __forceinline__ K key_max(K a, K b) { return b < a ? a : b; }

// One compare-exchange of a bitonic network across lanes: this lane's key
// and the one of lane ^ j (j < 32); the lower lane of the pair keeps the
// smaller in an ascending run (`up`), the larger in a descending one.
template <class K>
__device__ __forceinline__ K lane_exchange(K v, int j, bool up) {
  const K o = __shfl_xor_sync(0xFFFFFFFFu, v, j);
  const bool lower = (threadIdx.x & j) == 0;
  return lower == up ? key_min(v, o) : key_max(v, o);
}

// Compare-exchange of registers a < b of every lane: b keeps the larger.
template <class K>
__device__ __forceinline__ void reg_exchange(K& a, K& b, bool up) {
  const K lo = key_min(a, b), hi = key_max(a, b);
  a = up ? lo : hi;
  b = up ? hi : lo;
}

// Bitonic sort, ascending, of the warp's 32 * R keys v[r] (element r * 32
// + lane): distances below 32 are shuffles, above it register pairs.
template <class K, int R>
__device__ __forceinline__ void warp_sort(K (&v)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 2; kk <= 32 * R; kk <<= 1) {
#pragma unroll
    for (int j = kk >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (j < 32) {
          v[r] = lane_exchange(v[r], j, ((r * 32 + lane) & kk) == 0);
        } else if ((r & (j / 32)) == 0) {
          reg_exchange(v[r], v[r | (j / 32)], ((r * 32) & kk) == 0);
        }
      }
    }
  }
}

// w (32 * P keys, sorted) becomes the lowest 32 * P of w and c (32 * T
// keys, sorted): the element-wise min of w and c reversed is a bitonic
// sequence of exactly those keys (c counts as the largest key past its
// end), which a bitonic merge sorts.
template <class K, int P, int T>
__device__ __forceinline__ void warp_merge(K (&w)[P], const K (&c)[T]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    if (P - 1 - r < T) {
      w[r] = key_min(w[r], __shfl_sync(0xFFFFFFFFu, c[P - 1 - r], 31 - lane));
    }
  }
#pragma unroll
  for (int j = 16 * P; j > 0; j >>= 1) {
#pragma unroll
    for (int r = 0; r < P; ++r) {
      if (j < 32) {
        w[r] = lane_exchange(w[r], j, true);
      } else if ((r & (j / 32)) == 0) {
        reg_exchange(w[r], w[r | (j / 32)], true);
      }
    }
  }
}

// One query's selection state in a warp: the warp queue, this lane's
// thread queue (`fill` keys, the newest first, the largest key past them)
// and the threshold, the warp queue's k-th key.
template <class K, int P, int T>
struct WarpSelect {
  K w[P];
  K tq[T];
  K thr;
  int fill;

  __device__ __forceinline__ void init(K big) {
#pragma unroll
    for (int r = 0; r < P; ++r) w[r] = big;
#pragma unroll
    for (int t = 0; t < T; ++t) tq[t] = big;
    thr = big;
    fill = 0;
  }

  __device__ __forceinline__ void push(K key) {
#pragma unroll
    for (int t = T - 1; t > 0; --t) tq[t] = tq[t - 1];
    tq[0] = key;
    ++fill;
  }
};

// The whole warp merges the thread queues of query h (warp-uniform) into
// its warp queue and takes the new threshold, the k-th key. The query's
// keys are selected into one working copy and back, so the kernel holds
// one copy of the merge's code: a copy for each query (64-bit keys) left
// the visit loop no room in the instruction cache and ran 2-5x slower.
template <class K, int P, int T>
__device__ __forceinline__ void merge_query(
    WarpSelect<K, P, T> (&sel)[kListQ], int h, int k, K big) {
  K w[P], c[T];
#pragma unroll
  for (int r = 0; r < P; ++r) w[r] = sel[0].w[r];
#pragma unroll
  for (int t = 0; t < T; ++t) c[t] = sel[0].tq[t];
#pragma unroll
  for (int i = 1; i < kListQ; ++i) {
    if (i == h) {
#pragma unroll
      for (int r = 0; r < P; ++r) w[r] = sel[i].w[r];
#pragma unroll
      for (int t = 0; t < T; ++t) c[t] = sel[i].tq[t];
    }
  }
  warp_sort(c);
  warp_merge(w, c);
  const int kr = (k - 1) >> 5;
  K x = w[0];
#pragma unroll
  for (int r = 1; r < P; ++r) {
    if (r == kr) x = w[r];
  }
  const K thr = __shfl_sync(0xFFFFFFFFu, x, (k - 1) & 31);
#pragma unroll
  for (int i = 0; i < kListQ; ++i) {
    if (i == h) {
#pragma unroll
      for (int r = 0; r < P; ++r) sel[i].w[r] = w[r];
#pragma unroll
      for (int t = 0; t < T; ++t) sel[i].tq[t] = big;
      sel[i].thr = thr;
      sel[i].fill = 0;
    }
  }
}

// Merge each query whose thread queue is full in some lane (`last`: each
// that holds any key); true if any did. One vote when none is.
template <class K, int P, int T>
__device__ __forceinline__ bool merge_full(
    WarpSelect<K, P, T> (&sel)[kListQ], int k, K big, bool last = false) {
  const int need = last ? 1 : T;
  bool full = false;
#pragma unroll
  for (int h = 0; h < kListQ; ++h) full |= sel[h].fill >= need;
  if (!__any_sync(0xFFFFFFFFu, full)) return false;
  unsigned todo = 0u;
#pragma unroll
  for (int h = 0; h < kListQ; ++h) {
    if (__any_sync(0xFFFFFFFFu, sel[h].fill >= need)) todo |= 1u << h;
  }
#pragma unroll 1
  while (todo != 0u) {
    const int h = __ffs(todo) - 1;
    todo &= todo - 1u;
    merge_query(sel, h, k, big);
  }
  return true;
}

// knn3_exact for 17 <= k <= 128 (replaces the JAX package's ops/pallas/
// knn.py _knn_kernel at those k): knn3_exact_kernel's staged tile (the
// visit order p -> p * step mod ns_pad), rounded arithmetic and packed
// keys. Warp w of the block owns kListQ queries; lane l visits tile slots
// l, l + 32, ..., so one float4 read from shared memory feeds kListQ
// distance chains. A pair's d2 first meets a float test that passes every
// key below the query's threshold once the low idx_bits are cut (and NaN,
// the bound while the queue is not full); only then is its key packed and
// compared.
template <int P>
__global__ void __launch_bounds__(kListThreads, 2)
knn_list_exact_kernel(const float* __restrict__ q,
                      const uint8_t* __restrict__ q_mask,
                      const float* __restrict__ s,
                      const uint8_t* __restrict__ s_mask, int nq, int ns,
                      int ns_pad, int idx_bits, int step, int k,
                      float* __restrict__ out_d, int* __restrict__ out_i,
                      uint8_t* __restrict__ out_v) {
  __shared__ float4 tile[kListTile];
  const int lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kListQueries + (threadIdx.x / 32) * kListQ;
  const int low = (1 << idx_bits) - 1;
  float p[kListQ][3];
  float tf[kListQ];   // the largest d2 whose key, cut, can pass thr
  WarpSelect<int, P, kListTExact> sel[kListQ];
#pragma unroll
  for (int h = 0; h < kListQ; ++h) {
#pragma unroll
    for (int a = 0; a < 3; ++a) p[h][a] = q0 + h < nq ? q[3 * (q0 + h) + a] : 0.f;
    sel[h].init(kKeyMax);
    tf[h] = __int_as_float(kKeyMax);   // NaN: every d2 passes
  }
  const int stage_step = mul_mod(kListThreads % ns_pad, step, ns_pad);
  for (int c0 = 0; c0 < ns_pad; c0 += kListTile) {
    const int n = min(kListTile, ns_pad - c0);     // a multiple of 128
    __syncthreads();
    int c = mul_mod(c0 + threadIdx.x, step, ns_pad);
    for (int t = threadIdx.x; t < n; t += kListThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, __int_as_float(c | kMasked));
      if (c < ns) {
        v.x = s[3 * c];
        v.y = s[3 * c + 1];
        v.z = s[3 * c + 2];
        if (s_mask[c]) v.w = __int_as_float(c);
      }
      tile[t] = v;
      c += stage_step;
      if (c >= ns_pad) c -= ns_pad;
    }
    __syncthreads();
    float4 next = tile[lane];
#pragma unroll 1
    for (int i = 0; i < n / 32; ++i) {
      const float4 v = next;
      if (i + 1 < n / 32) next = tile[lane + 32 * (i + 1)];
      const int w = __float_as_int(v.w);
      const int col = w & low;
#pragma unroll
      for (int h = 0; h < kListQ; ++h) {
        const float dx = __fsub_rn(p[h][0], v.x);
        const float dy = __fsub_rn(p[h][1], v.y);
        const float dz = __fsub_rn(p[h][2], v.z);
        float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                            __fmul_rn(dz, dz));
        d = w >= 0 ? d : kBig;
        if (!(d > tf[h])) {
          const int key = pack_key(__float_as_int(d), ~low, col);
          if (key < sel[h].thr) sel[h].push(key);
        }
      }
      if (merge_full(sel, k, kKeyMax)) {
#pragma unroll
        for (int h = 0; h < kListQ; ++h) {
          tf[h] = __int_as_float(sel[h].thr | low);
        }
      }
    }
  }
  merge_full(sel, k, kKeyMax, true);
#pragma unroll
  for (int h = 0; h < kListQ; ++h) {
    const int qi = q0 + h;
    if (qi >= nq) break;
    const bool qv = q_mask[qi] != 0;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int e = 32 * r + lane;
      if (e < k) {
        const int key = sel[h].w[r];
        const float d = __int_as_float(key & ~low);
        out_d[k * qi + e] = d;
        out_i[k * qi + e] = key & low;
        out_v[k * qi + e] = (qv && d < kValidMax) ? 1 : 0;
      }
    }
  }
}

// (value, column) as one 64-bit key whose unsigned order is that of
// before() for a value that is not NaN: the value's bits made monotone,
// then the column.
__device__ __forceinline__ unsigned long long pair_key(float v, int col) {
  const unsigned b = __float_as_uint(v);
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) |
         static_cast<unsigned>(col);
}

__device__ __forceinline__ float pair_value(unsigned long long key) {
  const unsigned o = static_cast<unsigned>(key >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// knn3_mxu for 17 <= k <= 128 (replaces _knn_kernel_mxu at those k): the
// same packed supports (mxu_pack_kernel) and the same mma.sync per n8
// tile, so the same d2 + 1 bits. The block stages kListStage packed
// columns in shared memory at a time (the only barriers); warp w owns
// kListQ queries, rows 0..3 of its A fragment (the other 12 rows zero), so
// it needs no other warp's work: per kListRound columns it runs one mma
// per n8 tile into a [kListQ x kListRound] buffer of its own, then selects
// over it with lane l reading columns l, l + 32 (conflict-free). A block
// that shares one (32 queries x 256 columns) tile, every mma row used,
// ran slower on an H100 at k = 32 and 128, and slower still with
// 128-column tiles: the time follows its barriers, one a tile (PERF.md
// section 6). Keys are (value, column) packed by
// pair_key: the order of first-occurrence argmin passes (ties to the lower
// column), as knn3_mxu_kernel and knn3_mxu_ref; NaN never enters (the
// float prefilter v <= the threshold's value fails on it).
template <int P>
__global__ void __launch_bounds__(kListThreads, 2)
knn_list_mxu_kernel(const float* __restrict__ q,
                    const uint8_t* __restrict__ q_mask,
                    const uint4* __restrict__ pack,
                    const float* __restrict__ center, int nq, int ns,
                    int ns_pad, int step, int k, float* __restrict__ out_d,
                    int* __restrict__ out_i, uint8_t* __restrict__ out_v) {
  __shared__ __align__(16) uint4 stage[2 * kListStage];
  __shared__ __align__(16) float dist[kListThreads / 32][kListQ * kListRow];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kListQueries + warp * kListQ;

  // rows g < kListQ: this warp's queries; the rest zero
  uint32_t a0 = 0u, a2 = 0u;
  if (g < kListQ) {
    const float c[3] = {center[0], center[1], center[2]};
    float r[16];
    query_row(q, nq, q0 + g, c, r);
    a0 = bf16x2(r[2 * t], r[2 * t + 1]);
    a2 = bf16x2(r[2 * t + 8], r[2 * t + 9]);
  }
  const uint32_t a[4] = {a0, 0u, a2, 0u};
  // at first (inf, kKeyMax) as in knn3_mxu_kernel
  const float inf = __int_as_float(0x7F800000);
  const unsigned long long big = pair_key(inf, kKeyMax);
  WarpSelect<unsigned long long, P, kListTMxu> sel[kListQ];
  float tv[kListQ];   // the threshold's value: what may pass
#pragma unroll
  for (int h = 0; h < kListQ; ++h) {
    sel[h].init(big);
    tv[h] = inf;
  }
  const uint2* frag = reinterpret_cast<const uint2*>(stage);
  float* mine = dist[warp];
  const int ntiles = ns_pad / 8;
  const int step4 = 4 * step % ntiles;   // 32 packed columns: 4 n8 tiles
  for (int c0 = 0; c0 < ns_pad; c0 += kListStage) {
    const int n = min(kListStage, ns_pad - c0);    // a multiple of 128
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * n; i += kListThreads) {
      stage[i] = pack[2 * c0 + i];
    }
    __syncthreads();
    // this lane's column: packed n8 tile c0 / 8 + 4i + lane / 8 holds
    // original tile (that) * step mod ntiles
    int orig = mul_mod(c0 / 8 + lane / 8, step, ntiles);
#pragma unroll 1
    for (int r0 = 0; r0 < n; r0 += kListRound) {
#pragma unroll
      for (int j = 0; j < kListRound / 8; ++j) {
        const uint2 b = frag[32 * (r0 / 8 + j) + lane];
        float d[4];
        mma_bf16_16816(d, a, b.x, b.y);
        if (g < kListQ) {
          *reinterpret_cast<float2*>(mine + g * kListRow + 8 * j + 2 * t) =
              make_float2(d[0], d[1]);
        }
      }
      __syncwarp();
#pragma unroll 1
      for (int i = 0; i < kListRound / 32; ++i) {
        const int col = 8 * orig + (lane & 7);
        orig += step4;
        if (orig >= ntiles) orig -= ntiles;
#pragma unroll
        for (int h = 0; h < kListQ; ++h) {
          const float v = mine[h * kListRow + 32 * i + lane];
          if (v <= tv[h]) {
            const unsigned long long key = pair_key(v, col);
            if (key < sel[h].thr) sel[h].push(key);
          }
        }
        if (merge_full(sel, k, big)) {
#pragma unroll
          for (int h = 0; h < kListQ; ++h) tv[h] = pair_value(sel[h].thr);
        }
      }
      __syncwarp();
    }
  }
  merge_full(sel, k, big, true);
#pragma unroll
  for (int h = 0; h < kListQ; ++h) {
    const int qi = q0 + h;
    if (qi >= nq) break;
    const bool qm = q_mask[qi] != 0;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int e = 32 * r + lane;
      if (e < k) {
        const unsigned long long key = sel[h].w[r];
        const float d = fmaxf(pair_value(key) - 1.0f, 0.0f);
        out_d[k * qi + e] = d;
        out_i[k * qi + e] = min(static_cast<int>(key & 0xFFFFFFFFu), ns - 1);
        out_v[k * qi + e] = (qm && d < kValidMax) ? 1 : 0;
      }
    }
  }
}

int list_exact_launch(const float* q, const uint8_t* q_mask, const float* s,
                      const uint8_t* s_mask, int nq, int ns, int ns_pad,
                      int idx_bits, int k, float* out_d, int* out_i,
                      uint8_t* out_v, cudaStream_t st) {
  const int blocks = blocks_for(nq, kListQueries);
  const int step = visit_step(ns_pad);
  switch (list_regs(k)) {
    case 1:
      knn_list_exact_kernel<1><<<blocks, kListThreads, 0, st>>>(
          q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits, step, k, out_d,
          out_i, out_v);
      break;
    case 2:
      knn_list_exact_kernel<2><<<blocks, kListThreads, 0, st>>>(
          q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits, step, k, out_d,
          out_i, out_v);
      break;
    default:
      knn_list_exact_kernel<4><<<blocks, kListThreads, 0, st>>>(
          q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits, step, k, out_d,
          out_i, out_v);
  }
  return static_cast<int>(cudaGetLastError());
}

int list_mxu_launch(const float* q, const uint8_t* q_mask, const uint4* pack,
                    const float* center, int nq, int ns, int ns_pad, int k,
                    float* out_d, int* out_i, uint8_t* out_v,
                    cudaStream_t st) {
  const int blocks = blocks_for(nq, kListQueries);
  const int step = visit_step(ns_pad / 8);
  switch (list_regs(k)) {
    case 1:
      knn_list_mxu_kernel<1><<<blocks, kListThreads, 0, st>>>(
          q, q_mask, pack, center, nq, ns, ns_pad, step, k, out_d, out_i,
          out_v);
      break;
    case 2:
      knn_list_mxu_kernel<2><<<blocks, kListThreads, 0, st>>>(
          q, q_mask, pack, center, nq, ns, ns_pad, step, k, out_d, out_i,
          out_v);
      break;
    default:
      knn_list_mxu_kernel<4><<<blocks, kListThreads, 0, st>>>(
          q, q_mask, pack, center, nq, ns, ns_pad, step, k, out_d, out_i,
          out_v);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // KNN_K == 0

}  // namespace

extern "C" int knn3_exact_launch(const float* q, const uint8_t* q_mask,
                                 const float* s, const uint8_t* s_mask,
                                 int nq, int ns, int ns_pad, int idx_bits,
                                 int k, float* out_d, int* out_i,
                                 uint8_t* out_v, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#if KNN_K == 0
  if (k <= kMaxK || k > kMaxListK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return list_exact_launch(q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits, k,
                           out_d, out_i, out_v, st);
#else
  // this library's list length only
  if (k != KNN_K) return static_cast<int>(cudaErrorInvalidValue);
  return exact_launch<KNN_K>(q, q_mask, s, s_mask, nq, ns, ns_pad, idx_bits,
                             out_d, out_i, out_v, st);
#endif
}

// scratch: the packed support operand (ns_pad x 32 B), then the center
// (16 B); 16-byte aligned
extern "C" int mxu_pack_launch(const float* s, const uint8_t* s_mask, int ns,
                               int ns_pad, void* scratch, void* stream) {
  uint4* pack = static_cast<uint4*>(scratch);
  mxu_pack_kernel<<<1, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      s, s_mask, ns, ns_pad, visit_step(ns_pad / 8), pack,
      reinterpret_cast<float*>(pack + 2 * ns_pad));
  return static_cast<int>(cudaGetLastError());
}

// Two launches: the support pack into `scratch` (as mxu_pack_launch), then
// the product with its top-k.
extern "C" int knn3_mxu_launch(const float* q, const uint8_t* q_mask,
                               const float* s, const uint8_t* s_mask,
                               int nq, int ns, int ns_pad, int k,
                               void* scratch, float* out_d, int* out_i,
                               uint8_t* out_v, void* stream) {
#if KNN_K == 0
  if (k <= kMaxK || k > kMaxListK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#else
  if (k != KNN_K) return static_cast<int>(cudaErrorInvalidValue);
#endif
  const int err = mxu_pack_launch(s, s_mask, ns, ns_pad, scratch, stream);
  if (err != 0) return err;
  const uint4* pack = static_cast<const uint4*>(scratch);
  const float* center = reinterpret_cast<const float*>(pack + 2 * ns_pad);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#if KNN_K == 0
  return list_mxu_launch(q, q_mask, pack, center, nq, ns, ns_pad, k, out_d,
                         out_i, out_v, st);
#else
  return mxu_launch<KNN_K>(q, q_mask, pack, center, nq, ns, ns_pad, out_d,
                           out_i, out_v, st);
#endif
}
