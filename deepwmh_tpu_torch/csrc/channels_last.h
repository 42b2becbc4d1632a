// What K1's kernels (instance_norm_stats.cu, instance_norm_act.cu and
// instance_norm_act_backward.cu) share: the 16-byte loads and stores of a
// channels-last activation x [N, M, C] in bf16 or f32, the walk over one
// sample's rows, and the two-level sum of per-block [2, C] partials that
// makes the statistics passes deterministic.
//
// The walk. A block is `rows` rows x C/V threads (V elements in 16 bytes);
// a thread keeps one group of V channels and walks a strided range of the M
// rows. Narrow widths (C < V, V % C == 0: C = 1, 2, 4 in bf16, 1, 2 in f32)
// keep the 16-byte loads: a sample's flat [M * C] run is walked as 16-byte
// vectors (a "row" is one vector, a block `rows` of them), lane j of a
// vector holding channel (head + j) % C, head being the elements before the
// sample's first 16-byte boundary. The head and the elements after the last
// whole vector (at most V - 1 each) are left to the caller, which does them
// one by one.
//
// The two-level sum. Blocks run in no order, so each reduces its rows
// through shared memory to one [2, C] f32 partial. The blocks are cut into
// about sqrt(G) groups: the last block of a group to finish (a
// __threadfence() and an atomicAdd ticket on the group's counter, which it
// then resets to 0) adds the group's partials, and the last group to finish
// (a second ticket) adds the groups' sums, each in a fixed order, in double.
// No float atomics: the result has the same bits on every run, whichever
// blocks come last. Each of those sums is a chain of dependent loads; one
// chain over all G partials took longer than the data at the middle shapes
// (8 us of 24 at [1, 129024, 128]), so it is two chains of about sqrt(G),
// with kFinalUnroll loads in flight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFinalUnroll = 4;  // partials in flight per thread of a summing block

// 16 bytes of T as V floats, and back; one element at a time for the
// narrow path's head and tail. round() is the cast to T and back.
template <typename T>
struct Io16;

template <>
struct Io16<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static void unpack(const uint4& raw, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float (&v)[8]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return raw;
  }
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float load1(const __nv_bfloat16* p) { return __bfloat162float(p[0]); }
  __device__ static void store1(__nv_bfloat16* p, float v) { p[0] = __float2bfloat16_rn(v); }
};

template <>
struct Io16<float> {
  static constexpr int kWidth = 4;
  __device__ static void unpack(const uint4& raw, float (&v)[4]) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
  __device__ static uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  __device__ static float round(float v) { return v; }
  __device__ static float load1(const float* p) { return __ldg(p); }
  __device__ static void store1(float* p, float v) { p[0] = v; }
};

// Threads of a block of `rows` rows: C / V a row, one on the narrow path.
__host__ __device__ inline int block_threads(int rows, int C, int V) {
  return C < V ? rows : rows * (C / V);
}

// Sample n's walk: on the narrow path `head` elements before its first
// 16-byte boundary, `count` whole vectors, then the tail up to M * C; the
// wide path walks M rows with no head.
struct Walk {
  long long head, count;
};

__device__ inline Walk walk(int n, long long M, int C, int V) {
  if (C >= V) return {0, M};
  const long long L = M * C;
  long long head = (V - (long long)n * L % V) % V;
  if (head > L) head = L;
  return {head, (L - head) / V};
}

// Adds the rows [0, count) of a per-block array of [2, C] sums (row k of
// sample n at src + n * n_stride + k * 2 * C) per (n, c): thread i takes
// (n, c) = i % Q and the slice of rows k = i / Q (mod S), summed in double
// with kFinalUnroll rows in flight, into sa/sb [S][Q]. Then the caller adds
// the S slices in order: a fixed order of additions, whichever block runs.
template <typename P>
__device__ void sum_rows(const P* __restrict__ src, size_t n_stride, int count, int C,
                         int Q, int S, double* sa, double* sb) {
  for (int i = threadIdx.x; i < S * Q; i += blockDim.x) {
    const int qi = i % Q;
    const P* p = src + (size_t)(qi / C) * n_stride + qi % C;
    double a = 0.0, b = 0.0;
    int k = i / Q;
    for (; k + (kFinalUnroll - 1) * S < count; k += kFinalUnroll * S) {
      P pa[kFinalUnroll], pb[kFinalUnroll];
#pragma unroll
      for (int u = 0; u < kFinalUnroll; ++u) {
        pa[u] = __ldcg(p + (size_t)(k + u * S) * 2 * C);
        pb[u] = __ldcg(p + (size_t)(k + u * S) * 2 * C + C);
      }
#pragma unroll
      for (int u = 0; u < kFinalUnroll; ++u) {
        a += pa[u];
        b += pb[u];
      }
    }
    for (; k < count; k += S) {
      a += __ldcg(p + (size_t)k * 2 * C);
      b += __ldcg(p + (size_t)k * 2 * C + C);
    }
    sa[i] = a;
    sb[i] = b;
  }
  __syncthreads();
}

// The per-(n, c) sums that two_level_sum leaves in shared memory: S slices
// [S][Q] of each, Q = N * C.
struct Slices {
  double *a, *b;
  int S, Q;
  // the slices of (n, c) = qi, added in order
  __device__ void add(int qi, double& sa, double& sb) const {
    sa = 0.0;
    sb = 0.0;
    for (int sl = 0; sl < S; ++sl) {
      sa += a[sl * Q + qi];
      sb += b[sl * Q + qi];
    }
  }
};

// The end of a statistics pass over grid (G, N), each thread having left its
// rows' sums in shared memory, ss = smem [rows][C] and sq = ss + rows * C
// (f32). partial: [N, G, 2, C] f32; group_sum: [N, groups, 2, C] f64;
// ticket: groups + 1 counters, 0 on entry and reset to 0 by the blocks they
// elect. The blocks g of one group (group_blocks of them, every sample) add
// their partials when the last of them finishes; the last group to finish
// adds the groups' sums. Returns true in that one block alone, with the
// sums in `out` (over smem, which must hold two_level_shared_bytes()).
__device__ inline bool two_level_sum(double* smem, int rows, int C, int group_blocks,
                                     float* __restrict__ partial,
                                     double* __restrict__ group_sum,
                                     unsigned int* __restrict__ ticket, Slices& out) {
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int n = blockIdx.y;
  const int N = gridDim.y;
  const float* ss = reinterpret_cast<const float*>(smem);
  const float* sq = ss + rows * C;
  __syncthreads();
  float* mine = partial + ((size_t)n * G + g) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < rows; ++k) {
      a += ss[k * C + c];
      b += sq[k * C + c];
    }
    mine[c] = a;
    mine[C + c] = b;
  }

  const int Q = N * C;
  const int S = max(1, (int)blockDim.x / Q);
  const int n_groups = (G + group_blocks - 1) / group_blocks;
  const int j = g / group_blocks;
  const int g0 = j * group_blocks;
  const int in_group = min(G, g0 + group_blocks) - g0;
  out = Slices{smem, smem + S * Q, S, Q};
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket + j, 1u) == (unsigned int)(in_group * N) - 1u;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  sum_rows(partial + (size_t)g0 * 2 * C, (size_t)G * 2 * C, in_group, C, Q, S, out.a,
           out.b);
  for (int qi = threadIdx.x; qi < Q; qi += blockDim.x) {
    double a, b;
    out.add(qi, a, b);
    double* out_g = group_sum + ((size_t)(qi / C) * n_groups + j) * 2 * C + qi % C;
    out_g[0] = a;
    out_g[C] = b;
  }
  if (threadIdx.x == 0) ticket[j] = 0u;

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket + n_groups, 1u) == (unsigned int)n_groups - 1u;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  sum_rows(group_sum, (size_t)n_groups * 2 * C, n_groups, C, Q, S, out.a, out.b);
  if (threadIdx.x == 0) ticket[n_groups] = 0u;
  return true;
}

// two_level_sum's shared memory: the rows' sums in f32, then the last
// block's S x N x C slices in double (S * N * C <= max(threads, N * C)).
inline size_t two_level_shared_bytes(int threads, int rows, int N, int C) {
  const int Q = N * C;
  const size_t reduce = 2 * (size_t)rows * C * sizeof(float);
  const size_t finalize = 2 * (size_t)(threads > Q ? threads : Q) * sizeof(double);
  return reduce > finalize ? reduce : finalize;
}

}  // namespace
