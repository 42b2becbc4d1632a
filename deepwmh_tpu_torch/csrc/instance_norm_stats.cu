// Per-(sample, channel) instance-norm statistics of a channels-last
// activation, for Hopper (sm_90a).
//
// Replaces deepwmh_tpu/ops/pallas_kernels.py instance_norm_stats_pallas
// (body _inorm_stats_kernel): x [N, M, C] (M = prod(spatial)) in bf16 or
// f32 -> mean = sum(x) / M and var = sum(x^2) / M - mean^2, both f32 [N, C].
// The variance is the raw fast-variance form; the caller clamps it at 0.
//
// What bounds it: device-memory bandwidth at full resolution (every element
// is read once and costs two FMAs: about 0.16 ms for the [1, 8.26M, 32] bf16
// activation at 3.35 TB/s), and the fixed cost of a launch at the deep
// stages, whose few thousand rows take microseconds to read.
//
// What the design does about it:
// - The activation is read in place in its channels-last layout: each
//   thread loads 16 bytes (8 bf16 or 4 f32 of consecutive channels) per row,
//   and neighbouring threads read neighbouring addresses, so a warp reads
//   contiguous 512-byte spans. A block is `rows` rows x C/V threads; each
//   thread keeps a fixed channel group and walks a strided range of rows.
// - Each thread issues kUnroll independent 16-byte loads before it adds any
//   of them, so that more bytes are in flight per SM than one load a thread
//   gives (the first version reached 78% of the bound at full resolution).
//   The grid is one wave of resident blocks.
// - One launch per call. The TPU kernel carried its sums across a
//   sequential grid; blocks here run in no order, so each block reduces its
//   rows through shared memory to one [2, C] partial. The blocks are cut
//   into about sqrt(G) groups: the last block of a group to finish (a
//   __threadfence() and an atomicAdd ticket on the group's counter, which
//   it then resets to 0) adds the group's partials, and the last group to
//   finish (a second ticket) adds the groups' sums, each in a fixed order,
//   in double. No float atomics: the result has the same bits on every
//   run, whichever blocks come last. Each of those sums is a chain of
//   dependent loads; one chain over all G partials took longer than the
//   data at the middle shapes (8 us of 24 at [1, 129024, 128]), so it is
//   two chains of about sqrt(G), with kFinalUnroll loads in flight. A
//   thread-block cluster reducing through distributed shared memory would
//   also avoid a second launch, but only where G fits in one cluster (at
//   most 16 blocks), i.e. at the deep stages alone.
// - G is capped so that every thread walks at least 16 rows: on the deep,
//   narrow-spatial stages more blocks would only add partials.
// - Narrow widths (C < V, V % C == 0: C = 1, 2, 4 in bf16, 1, 2 in f32, the
//   widths the TPU kernel's 128 % C == 0 contract adds) keep the 16-byte
//   loads: a sample's flat [M * C] run is read as 16-byte vectors (a "row"
//   of the walk is one vector, a block 256 of them), and lane j of a vector
//   holds channel (head + j) % C, head being the elements before the
//   sample's first 16-byte boundary. Each thread folds its V lanes into C
//   channel sums in lane order; the head and the elements after the last
//   whole vector (at most V - 1 each) are read one by one by thread 0 of
//   block 0. The partials and their two-level sum are the wide path's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;        // 16-byte loads in flight per thread
constexpr int kFinalUnroll = 4;   // partials in flight per thread of a summing block

template <typename T>
struct Vec16;

template <>
struct Vec16<__nv_bfloat16> {
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
};

template <>
struct Vec16<float> {
  static constexpr int kWidth = 4;
  __device__ static void unpack(const uint4& raw, float (&v)[4]) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
};

// Adds the rows [0, count) of a per-block array of [2, C] sums (row k of
// sample n at src + n * n_stride + k * 2 * C) per (n, c): thread i takes
// (n, c) = i % Q and the slice of rows k = i / Q (mod S), summed in double
// with kFinalUnroll rows in flight, into sa/sb [S][Q]. Then the caller adds
// the S slices in order: a fixed order of additions, whichever block runs.
template <typename P>
__device__ void sum_rows(const P* __restrict__ src, size_t n_stride,
                         int count, int C, int Q, int S, double* sa,
                         double* sb) {
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

// Threads of a block of `rows` rows: C / V a row, one on the narrow path.
__host__ __device__ inline int block_threads(int rows, int C, int V) {
  return C < V ? rows : rows * (C / V);
}

// The narrow path's split of sample n's flat run of L = M * C elements:
// `head` elements before its first 16-byte boundary, `vecs` whole 16-byte
// vectors, then the tail up to L.
struct NarrowSplit {
  long long head, vecs;
};

__device__ inline NarrowSplit narrow_split(int n, long long L, int V) {
  long long head = (V - (long long)n * L % V) % V;
  if (head > L) head = L;
  return {head, (L - head) / V};
}

template <typename T>
__device__ inline float load_one(const T* p);
template <>
__device__ inline float load_one<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}
template <>
__device__ inline float load_one<float>(const float* p) {
  return __ldg(p);
}

// grid (G, N), block block_threads(rows, C, V) threads, dynamic shared memory
// shared_bytes().
// partial: [N, G, 2, C] f32 (sum, then sum of squares); ticket: one
// counter, 0 on entry and reset to 0 by the last block.
template <typename T>
__global__ void inorm_stats_kernel(const T* __restrict__ x,
                                   float* __restrict__ partial,
                                   double* __restrict__ group_sum,
                                   unsigned int* __restrict__ ticket,
                                   float* __restrict__ mean,
                                   float* __restrict__ var, long long M, int C,
                                   int rows, int group_blocks, float inv_m) {
  constexpr int V = Vec16<T>::kWidth;
  const bool narrow = C < V;
  const int groups = narrow ? 1 : C / V;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int n = blockIdx.y;
  const int N = gridDim.y;
  const int cg = threadIdx.x % groups;
  const int r = threadIdx.x / groups;

  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] = 0.f;
    q[i] = 0.f;
  }
  // the wide path walks M rows of C / V vectors, a thread one channel
  // group; the narrow path walks a sample's whole 16-byte vectors
  const T* sample = x + (size_t)n * (size_t)M * C;
  const NarrowSplit split = narrow_split(n, M * C, V);
  const uint4* base = reinterpret_cast<const uint4*>(
      narrow ? sample + split.head : sample + (size_t)cg * V);
  const size_t row_vecs = narrow ? 1 : (size_t)C / V;  // 16-byte vectors per row
  const long long count = narrow ? split.vecs : M;
  const long long step = (long long)G * rows;
  long long m = (long long)g * rows + r;
  for (; m + (kUnroll - 1) * step < count; m += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      raw[u] = __ldg(base + (size_t)(m + u * step) * row_vecs);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[V];
      Vec16<T>::unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    }
  }
  for (; m < count; m += step) {
    float v[V];
    Vec16<T>::unpack(__ldg(base + (size_t)m * row_vecs), v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] += v[i];
      q[i] = fmaf(v[i], v[i], q[i]);
    }
  }

  extern __shared__ double smem_d[];
  float* ss = reinterpret_cast<float*>(smem_d);  // [rows][C]
  float* sq = ss + rows * C;                      // [rows][C]
  if (!narrow) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      ss[r * C + cg * V + i] = s[i];
      sq[r * C + cg * V + i] = q[i];
    }
  } else {
    // lanes folded into channels in lane order; block 0's thread 0 adds
    // the head and the tail, element by element
    for (int c = 0; c < C; ++c) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if ((split.head + i) % C == c) {
          a += s[i];
          b += q[i];
        }
      }
      if (g == 0 && r == 0) {
        const long long L = M * C;
        for (long long e = 0; e < split.head; ++e) {
          if (e % C == c) {
            const float v = load_one(sample + e);
            a += v;
            b = fmaf(v, v, b);
          }
        }
        for (long long e = split.head + split.vecs * V; e < L; ++e) {
          if (e % C == c) {
            const float v = load_one(sample + e);
            a += v;
            b = fmaf(v, v, b);
          }
        }
      }
      ss[r * C + c] = a;
      sq[r * C + c] = b;
    }
  }
  __syncthreads();
  float* out = partial + ((size_t)n * G + g) * 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < rows; ++k) {
      a += ss[k * C + c];
      b += sq[k * C + c];
    }
    out[c] = a;
    out[C + c] = b;
  }

  // The blocks g of one group (group_blocks of them, every sample) add
  // their partials when the last of them finishes; the last group to
  // finish adds the groups' sums. Two short chains of dependent adds
  // instead of one of G, and each ticket is reset by the block it elects.
  const int Q = N * C;
  const int S = max(1, (int)blockDim.x / Q);
  const int n_groups = (G + group_blocks - 1) / group_blocks;
  const int j = g / group_blocks;
  const int g0 = j * group_blocks;
  const int in_group = min(G, g0 + group_blocks) - g0;
  double* sa = smem_d;      // [S][Q]
  double* sb = sa + S * Q;  // [S][Q]
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(ticket + j, 1u) == (unsigned int)(in_group * N) - 1u;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  sum_rows(partial + (size_t)g0 * 2 * C, (size_t)G * 2 * C, in_group, C, Q, S,
           sa, sb);
  for (int qi = threadIdx.x; qi < Q; qi += blockDim.x) {
    double a = 0.0, b = 0.0;
    for (int sl = 0; sl < S; ++sl) {
      a += sa[sl * Q + qi];
      b += sb[sl * Q + qi];
    }
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
  if (!is_last) return;
  __threadfence();
  sum_rows(group_sum, (size_t)n_groups * 2 * C, n_groups, C, Q, S, sa, sb);
  for (int qi = threadIdx.x; qi < Q; qi += blockDim.x) {
    double a = 0.0, b = 0.0;
    for (int sl = 0; sl < S; ++sl) {
      a += sa[sl * Q + qi];
      b += sb[sl * Q + qi];
    }
    const float mu = (float)a * inv_m;
    mean[qi] = mu;
    var[qi] = (float)b * inv_m - mu * mu;
  }
  if (threadIdx.x == 0) ticket[n_groups] = 0u;
}

// the rows' sums in f32, then the last block's S x N x C slices in double
// (S * N * C <= max(threads, N * C))
size_t shared_bytes(int threads, int rows, int N, int C) {
  const int Q = N * C;
  const size_t reduce = 2 * (size_t)rows * C * sizeof(float);
  const size_t finalize = 2 * (size_t)(threads > Q ? threads : Q) * sizeof(double);
  return reduce > finalize ? reduce : finalize;
}

template <typename T>
int launch(const void* x, void* partial, void* group_sum, void* ticket,
           void* mean, void* var, int N, long long M, int C, int rows, int G,
           int group_blocks, float inv_m, cudaStream_t stream) {
  const int threads = block_threads(rows, C, Vec16<T>::kWidth);
  inorm_stats_kernel<T><<<dim3(G, N), threads,
                          shared_bytes(threads, rows, N, C), stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial),
      static_cast<double*>(group_sum), static_cast<unsigned int*>(ticket),
      static_cast<float*>(mean), static_cast<float*>(var), M, C, rows,
      group_blocks, inv_m);
  return (int)cudaGetLastError();
}

}  // namespace

// How many blocks of `rows` rows fit on one SM at once (the grid is sized
// to one wave of them); 0 if the shape cannot launch.
extern "C" int inorm_stats_blocks_per_sm(int bf16, int N, int C, int rows) {
  const int threads = block_threads(rows, C, bf16 ? 8 : 4);
  const size_t smem = shared_bytes(threads, rows, N, C);
  int blocks = 0;
  cudaError_t err =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, inorm_stats_kernel<__nv_bfloat16>, threads, smem)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, inorm_stats_kernel<float>, threads, smem);
  return err == cudaSuccess ? blocks : 0;
}

// Returns the launch's error code. partial holds N * G * 2 * C floats and
// group_sum N * ceil(G / group_blocks) * 2 * C doubles; ticket holds
// ceil(G / group_blocks) + 1 unsigned ints, 0 before the call and 0 after
// it, used by one stream at a time.
extern "C" int inorm_stats_bf16(const void* x, void* partial, void* group_sum,
                                void* ticket, void* mean, void* var, int N,
                                long long M, int C, int rows, int G,
                                int group_blocks, float inv_m, void* stream) {
  return launch<__nv_bfloat16>(x, partial, group_sum, ticket, mean, var, N, M,
                               C, rows, G, group_blocks, inv_m,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int inorm_stats_f32(const void* x, void* partial, void* group_sum,
                               void* ticket, void* mean, void* var, int N,
                               long long M, int C, int rows, int G,
                               int group_blocks, float inv_m, void* stream) {
  return launch<float>(x, partial, group_sum, ticket, mean, var, N, M, C, rows,
                       G, group_blocks, inv_m, static_cast<cudaStream_t>(stream));
}
