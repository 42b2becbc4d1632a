// The pass that consumes K1's statistics: instance-norm normalize + affine
// + leaky ReLU of a channels-last activation, for Hopper (sm_90a).
//
// Part of K1's redesign (K1 replaces deepwmh_tpu/ops/pallas_kernels.py
// instance_norm_stats_pallas). The JAX package computes the statistics with
// that kernel and leaves "(x - mean) * w + bias", the cast and the leaky ReLU
// to XLA as one fused pass (deepwmh_tpu/unet/model.py ConvNormAct, the
// fused_stats path); the port ran them as six plain-torch passes over f32
// copies. Here they are one pass:
//
//   out[n, m, c] = leaky(cast(((x - mean[n, c]) * mul[n, c]) + bias[n, c]))
//
// x, out [N, M, C] bf16 or f32; mean, mul f32 [N, C]; bias f32 [N, C] or [C]
// (bias_n_stride C or 0). cast rounds to nearest even into x's dtype;
// leaky(v) = v > 0 ? v : v * slope in f32, rounded again. The f32 subtract,
// multiply and add are each rounded on their own (__fsub_rn, __fmul_rn,
// __fadd_rn: nvcc would otherwise contract the multiply and add into an
// FMA), so the result has the bits of the plain chain
// (instance_norm_act_reference).
//
// What bounds it: device-memory bandwidth. Each element is read once and
// written once (4 bytes in bf16: about 0.32 ms for the full-resolution
// [1, 8.26M, 32] activation at 3.35 TB/s), against about 40 bytes for the
// six plain passes.
//
// What the design does about it: the layout and walk of the statistics
// kernel. A block is `rows` rows x C/V threads; a thread keeps one group of
// V channels (16 bytes), so it loads its V means, multipliers and biases
// once per sample and then streams rows with kUnroll independent 16-byte
// loads in flight, storing 16 bytes per row.
//
// Narrow widths (C < V, V % C == 0) walk a sample's flat [M * C] run as
// 16-byte vectors, lane j holding channel (head + j) % C (head: the elements
// before the sample's first 16-byte boundary), as the statistics kernel
// does; the head and the elements after the last whole vector (at most
// V - 1 each) go one by one through the same rounded steps, on thread 0 of
// block 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;

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
  // round to bf16, then the leaky ReLU on the rounded value, rounded again
  __device__ static uint4 act_pack(const float (&v)[8], float slope) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = __bfloat162float(__float2bfloat16_rn(v[2 * i]));
      float b = __bfloat162float(__float2bfloat16_rn(v[2 * i + 1]));
      a = a > 0.f ? a : __fmul_rn(a, slope);
      b = b > 0.f ? b : __fmul_rn(b, slope);
      h[i] = __floats2bfloat162_rn(a, b);
    }
    return raw;
  }
  __device__ static float load1(const __nv_bfloat16* p) { return __bfloat162float(p[0]); }
  __device__ static void act_store1(__nv_bfloat16* p, float v, float slope) {
    float a = __bfloat162float(__float2bfloat16_rn(v));
    a = a > 0.f ? a : __fmul_rn(a, slope);
    p[0] = __float2bfloat16_rn(a);
  }
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
  __device__ static uint4 act_pack(const float (&v)[4], float slope) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = v[i] > 0.f ? v[i] : __fmul_rn(v[i], slope);
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                      __float_as_uint(a[2]), __float_as_uint(a[3]));
  }
  __device__ static float load1(const float* p) { return __ldg(p); }
  __device__ static void act_store1(float* p, float v, float slope) {
    p[0] = v > 0.f ? v : __fmul_rn(v, slope);
  }
};

// Threads of a block of `rows` rows: C / V a row, one on the narrow path.
__host__ __device__ inline int block_threads(int rows, int C, int V) {
  return C < V ? rows : rows * (C / V);
}

// grid (G, N), block block_threads(rows, C, V) threads
template <typename T>
__global__ void inorm_act_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 const float* __restrict__ mean,
                                 const float* __restrict__ mul,
                                 const float* __restrict__ bias,
                                 int bias_n_stride, long long M, int C,
                                 int rows, float slope) {
  constexpr int V = Io16<T>::kWidth;
  const bool narrow = C < V;
  const int groups = narrow ? 1 : C / V;
  const int n = blockIdx.y;
  const int cg = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const float* mean_n = mean + (size_t)n * C;
  const float* mul_n = mul + (size_t)n * C;
  const float* bias_n = bias + (size_t)n * bias_n_stride;

  // the wide path walks M rows; the narrow path splits the sample's flat
  // run into head elements before its first 16-byte boundary, `count`
  // whole vectors, then the tail
  const long long L = M * C;
  long long head = narrow ? (V - (long long)n * L % V) % V : 0;
  if (head > L) head = L;
  const long long count = narrow ? (L - head) / V : M;

  float mu[V], w[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = narrow ? (int)((head + i) % C) : cg * V + i;
    mu[i] = __ldg(mean_n + c);
    w[i] = __ldg(mul_n + c);
    b[i] = __ldg(bias_n + c);
  }
  const size_t offset =
      (size_t)n * (size_t)M * C + (narrow ? (size_t)head : (size_t)cg * V);
  const uint4* src = reinterpret_cast<const uint4*>(x + offset);
  uint4* dst = reinterpret_cast<uint4*>(out + offset);
  const size_t row_vecs = narrow ? 1 : (size_t)C / V;
  const long long step = (long long)gridDim.x * rows;

  if (narrow && blockIdx.x == 0 && r == 0) {
    const T* xs = x + (size_t)n * (size_t)M * C;
    T* os = out + (size_t)n * (size_t)M * C;
    auto one = [&](long long e) {
      const int c = (int)(e % C);
      const float v = __fadd_rn(
          __fmul_rn(__fsub_rn(Io16<T>::load1(xs + e), __ldg(mean_n + c)), __ldg(mul_n + c)),
          __ldg(bias_n + c));
      Io16<T>::act_store1(os + e, v, slope);
    };
    for (long long e = 0; e < head; ++e) one(e);
    for (long long e = head + count * V; e < L; ++e) one(e);
  }

  auto apply = [&](const uint4& raw) {
    float v[V];
    Io16<T>::unpack(raw, v);
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], mu[i]), w[i]), b[i]);
    return Io16<T>::act_pack(v, slope);
  };

  long long m = (long long)blockIdx.x * rows + r;
  for (; m + (kUnroll - 1) * step < count; m += kUnroll * step) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      raw[u] = __ldg(src + (size_t)(m + u * step) * row_vecs);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      dst[(size_t)(m + u * step) * row_vecs] = apply(raw[u]);
  }
  for (; m < count; m += step)
    dst[(size_t)m * row_vecs] = apply(__ldg(src + (size_t)m * row_vecs));
}

template <typename T>
int launch(const void* x, void* out, const void* mean, const void* mul,
           const void* bias, int bias_n_stride, int N, long long M, int C,
           int rows, int G, float slope, cudaStream_t stream) {
  inorm_act_kernel<T><<<dim3(G, N), block_threads(rows, C, Io16<T>::kWidth), 0,
                        stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const float*>(mean), static_cast<const float*>(mul),
      static_cast<const float*>(bias), bias_n_stride, M, C, rows, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// How many blocks of `rows` rows fit on one SM at once (the grid is sized
// to one wave of them); 0 if the shape cannot launch.
extern "C" int inorm_act_blocks_per_sm(int bf16, int C, int rows) {
  const int threads = block_threads(rows, C, bf16 ? 8 : 4);
  int blocks = 0;
  cudaError_t err =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, inorm_act_kernel<__nv_bfloat16>, threads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, inorm_act_kernel<float>, threads, 0);
  return err == cudaSuccess ? blocks : 0;
}

// Returns the launch's error code.
extern "C" int inorm_act_bf16(const void* x, void* out, const void* mean,
                              const void* mul, const void* bias,
                              int bias_n_stride, int N, long long M, int C,
                              int rows, int G, float slope, void* stream) {
  return launch<__nv_bfloat16>(x, out, mean, mul, bias, bias_n_stride, N, M, C,
                               rows, G, slope,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int inorm_act_f32(const void* x, void* out, const void* mean,
                             const void* mul, const void* bias,
                             int bias_n_stride, int N, long long M, int C,
                             int rows, int G, float slope, void* stream) {
  return launch<float>(x, out, mean, mul, bias, bias_n_stride, N, M, C, rows,
                       G, slope, static_cast<cudaStream_t>(stream));
}
