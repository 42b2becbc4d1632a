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
//   rows through shared memory to one [2, C] partial, and the partials are
//   added in a fixed order, in double, by two_level_sum (channels_last.h):
//   the last block of each of about sqrt(G) groups, then the last group,
//   elected by atomicAdd tickets. No float atomics: the result has the same
//   bits on every run, whichever blocks come last. A thread-block cluster
//   reducing through distributed shared memory would also avoid a second
//   launch, but only where G fits in one cluster (at most 16 blocks), i.e.
//   at the deep stages alone.
// - G is capped so that every thread walks at least 16 rows: on the deep,
//   narrow-spatial stages more blocks would only add partials.
// - Narrow widths (C < V, V % C == 0: C = 1, 2, 4 in bf16, 1, 2 in f32, the
//   widths the TPU kernel's 128 % C == 0 contract adds) keep the 16-byte
//   loads: a sample's flat [M * C] run is read as 16-byte vectors, lane j of
//   a vector holding channel (head + j) % C (channels_last.h's walk). Each
//   thread folds its V lanes into C channel sums in lane order; the head and
//   the elements after the last whole vector are read one by one by thread 0
//   of block 0. The partials and their two-level sum are the wide path's.

#include "channels_last.h"

namespace {

constexpr int kUnroll = 4;        // 16-byte loads in flight per thread
constexpr int kMaxThreads = 256;  // kernels.py's THREADS

// grid (G, N), block block_threads(rows, C, V) threads, dynamic shared memory
// two_level_shared_bytes(). partial: [N, G, 2, C] f32 (sum, then sum of
// squares); group_sum and ticket as two_level_sum takes them.
//
// The grid is one wave of resident blocks, so G, and with it which rows each
// thread adds up, follows the registers a thread takes. The launch bounds cap
// them at 80 (three blocks of kMaxThreads a multiprocessor), so the sums keep
// their order, and their bits, whatever the compiler makes of the code around
// the loop. Wider blocks (C > 2048 in bf16, 1024 in f32) are refused.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 3)
    inorm_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                       double* __restrict__ group_sum, unsigned int* __restrict__ ticket,
                       float* __restrict__ mean, float* __restrict__ var, long long M,
                       int C, int rows, int group_blocks, float inv_m) {
  constexpr int V = Io16<T>::kWidth;
  const bool narrow = C < V;
  const int groups = narrow ? 1 : C / V;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int n = blockIdx.y;
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
  const Walk wk = walk(n, M, C, V);
  const uint4* base = reinterpret_cast<const uint4*>(
      narrow ? sample + wk.head : sample + (size_t)cg * V);
  const size_t row_vecs = narrow ? 1 : (size_t)C / V;  // 16-byte vectors per row
  const long long step = (long long)G * rows;
  long long m = (long long)g * rows + r;
  for (; m + (kUnroll - 1) * step < wk.count; m += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      raw[u] = __ldg(base + (size_t)(m + u * step) * row_vecs);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[V];
      Io16<T>::unpack(raw[u], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    }
  }
  for (; m < wk.count; m += step) {
    float v[V];
    Io16<T>::unpack(__ldg(base + (size_t)m * row_vecs), v);
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
        if ((wk.head + i) % C == c) {
          a += s[i];
          b += q[i];
        }
      }
      if (g == 0 && r == 0) {
        const long long L = M * C;
        for (long long e = 0; e < wk.head; ++e) {
          if (e % C == c) {
            const float v = Io16<T>::load1(sample + e);
            a += v;
            b = fmaf(v, v, b);
          }
        }
        for (long long e = wk.head + wk.count * V; e < L; ++e) {
          if (e % C == c) {
            const float v = Io16<T>::load1(sample + e);
            a += v;
            b = fmaf(v, v, b);
          }
        }
      }
      ss[r * C + c] = a;
      sq[r * C + c] = b;
    }
  }

  Slices sums;
  if (!two_level_sum(smem_d, rows, C, group_blocks, partial, group_sum, ticket, sums))
    return;
  for (int qi = threadIdx.x; qi < sums.Q; qi += blockDim.x) {
    double a, b;
    sums.add(qi, a, b);
    const float mu = (float)a * inv_m;
    mean[qi] = mu;
    var[qi] = (float)b * inv_m - mu * mu;
  }
}

template <typename T>
int launch(const void* x, void* partial, void* group_sum, void* ticket,
           void* mean, void* var, int N, long long M, int C, int rows, int G,
           int group_blocks, float inv_m, cudaStream_t stream) {
  const int threads = block_threads(rows, C, Io16<T>::kWidth);
  inorm_stats_kernel<T><<<dim3(G, N), threads,
                          two_level_shared_bytes(threads, rows, N, C), stream>>>(
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
  if (threads > kMaxThreads) return 0;
  const size_t smem = two_level_shared_bytes(threads, rows, N, C);
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
