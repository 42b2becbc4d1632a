// Per-(sample, channel) instance-norm statistics of a channels-last
// activation, for Hopper (sm_90a).
//
// Replaces deepwmh_tpu/ops/pallas_kernels.py instance_norm_stats_pallas
// (body _inorm_stats_kernel): x [N, M, C] (M = prod(spatial)) in bf16 or
// f32 -> mean = sum(x) / M and var = sum(x^2) / M - mean^2, both f32 [N, C].
// The variance is the raw fast-variance form; the caller clamps it at 0.
//
// What bounds it: device-memory bandwidth. Every element is read once and
// costs two FMAs, so the least time is N*M*C*sizeof(T) / 3.35 TB/s (about
// 0.16 ms for the full-resolution [1, 8.26M, 32] bf16 activation).
//
// What the design does about it:
// - The activation is read in place in its channels-last layout: each
//   thread loads 16 bytes (8 bf16 or 4 f32 of consecutive channels) per row,
//   and neighbouring threads read neighbouring addresses, so a warp reads
//   contiguous 512-byte spans.
// - A block is `rows` rows x C/V threads; each thread keeps a fixed channel
//   group and walks a strided range of rows, accumulating in f32 registers.
//   The grid (N, G) puts about 8 blocks on every SM, enough loads in flight
//   to approach the memory rate.
// - The TPU kernel carried its sums across a sequential grid; blocks here
//   run in no order, so each block reduces its rows through shared memory
//   to one [2, C] partial, and a second small kernel sums the G partials in
//   a fixed order (in double), 32 slices of them at a time so that the sum
//   is not one long chain of dependent loads. No float atomics: the result
//   is the same on every run.
// - G is capped so that every thread still walks at least 8 rows: on the
//   deep, narrow-spatial stages more blocks would only add partials.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
struct Vec16;

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Vec16<float> {
  static constexpr int kWidth = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    float4 raw = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = raw.x;
    v[1] = raw.y;
    v[2] = raw.z;
    v[3] = raw.w;
  }
};

// grid (N, G), block rows * (C / V) threads, dynamic shared 2 * rows * C floats.
// partial: [N, G, 2, C] f32 (sum, then sum of squares).
template <typename T>
__global__ void inorm_partial_kernel(const T* __restrict__ x,
                                     float* __restrict__ partial,
                                     long long M, int C, int rows) {
  constexpr int V = Vec16<T>::kWidth;
  const int groups = C / V;
  const int n = blockIdx.x;
  const int g = blockIdx.y;
  const int G = gridDim.y;
  const int cg = threadIdx.x % groups;
  const int r = threadIdx.x / groups;

  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] = 0.f;
    q[i] = 0.f;
  }
  const T* base = x + (size_t)n * (size_t)M * C + (size_t)cg * V;
  const long long step = (long long)G * rows;
#pragma unroll 4
  for (long long m = (long long)g * rows + r; m < M; m += step) {
    float v[V];
    Vec16<T>::load(base + (size_t)m * C, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      s[i] += v[i];
      q[i] = fmaf(v[i], v[i], q[i]);
    }
  }

  extern __shared__ float smem[];
  float* ss = smem;             // [rows][C]
  float* sq = smem + rows * C;  // [rows][C]
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ss[r * C + cg * V + i] = s[i];
    sq[r * C + cg * V + i] = q[i];
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
}

// grid (N, ceil(C / 32)), block (32, 32): threadIdx.x picks a channel and
// threadIdx.y a stride-32 slice of the G partials, summed in double; the 32
// slices are then added in a fixed order.
__global__ void inorm_finalize_kernel(const float* __restrict__ partial,
                                      float* __restrict__ mean,
                                      float* __restrict__ var, int C, int G,
                                      float inv_m) {
  __shared__ double sa[32][33];
  __shared__ double sb[32][33];
  const int n = blockIdx.x;
  const int c = blockIdx.y * 32 + threadIdx.x;
  double a = 0.0, b = 0.0;
  if (c < C) {
    for (int g = threadIdx.y; g < G; g += 32) {
      const float* p = partial + ((size_t)n * G + g) * 2 * C;
      a += p[c];
      b += p[C + c];
    }
  }
  sa[threadIdx.y][threadIdx.x] = a;
  sb[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    for (int y = 1; y < 32; ++y) {
      a += sa[y][threadIdx.x];
      b += sb[y][threadIdx.x];
    }
    const float mu = (float)a * inv_m;
    mean[n * C + c] = mu;
    var[n * C + c] = (float)b * inv_m - mu * mu;
  }
}

template <typename T>
static int launch(const void* x, void* partial, void* mean, void* var, int N,
                  long long M, int C, int rows, int G, float inv_m,
                  cudaStream_t stream) {
  constexpr int V = Vec16<T>::kWidth;
  const int threads = rows * (C / V);
  const size_t smem = 2 * (size_t)rows * C * sizeof(float);
  inorm_partial_kernel<T><<<dim3(N, G), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), M, C, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  inorm_finalize_kernel<<<dim3(N, (C + 31) / 32), dim3(32, 32), 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(mean),
      static_cast<float*>(var), C, G, inv_m);
  return (int)cudaGetLastError();
}

extern "C" int inorm_stats_bf16(const void* x, void* partial, void* mean,
                                void* var, int N, long long M, int C, int rows,
                                int G, float inv_m, void* stream) {
  return launch<__nv_bfloat16>(x, partial, mean, var, N, M, C, rows, G, inv_m,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int inorm_stats_f32(const void* x, void* partial, void* mean,
                               void* var, int N, long long M, int C, int rows,
                               int G, float inv_m, void* stream) {
  return launch<float>(x, partial, mean, var, N, M, C, rows, G, inv_m,
                       static_cast<cudaStream_t>(stream));
}
