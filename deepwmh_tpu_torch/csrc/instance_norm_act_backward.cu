// The backward of K1's chain (instance norm -> affine -> cast -> leaky ReLU)
// of a channels-last activation, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX trainer differentiates flax GroupNorm with
// XLA, and the JAX package's K1 has no VJP. With it, training runs K1
// forward and this backward (ops/kernels.py instance_norm_act_fn) instead of
// autograd through an out-of-place f32 chain of about ten passes.
//
// The forward (K1's two kernels) is
//   out[n, m, c] = leaky(cast(((x - mean) * mul) + bias)),
//   mul = rsqrt(max(var, 0) + eps) * weight,
// with mean and var the instance statistics of x over M = prod(spatial).
// Given dout, autograd's rules through the plain chain give, per (n, c),
//   z  = cast(((x - mean) * mul) + bias)   (recomputed with the apply
//        kernel's rounded steps, so the same leaky-ReLU branch is taken)
//   g  = z > 0 ? dout : cast(dout * slope) (leaky_relu_backward in x's
//        dtype; the cast's backward is exact)
//   xc = x - mean,  x^ = xc * rstd,  rstd = rsqrt(max(var, 0) + eps)
//   dx = cast(mul * (g - sum(g) / M - xc * k2)),
//   k2 = [var >= 0] * rstd^2 * sum(g * xc) / M   (clamp_min's mask)
// and the weight's and bias's gradients sum(g * x^) and sum(g) over the
// samples. x, dout, dx [N, M, C] bf16 or f32; mean, mul, var, k1 = sum(g) /
// M, k2 f32 [N, C]; bias f32 [N, C] or [C] (bias_n_stride C or 0).
//
// Two passes, because the sums over a sample are needed before the first
// dx: one sample's stage-0 activation (168 MB per tensor at the flagship
// train patch) cannot stay on chip between them.
// (a) inorm_act_bwd_stats_kernel: reads x and dout, sums g and g * xc per
//     (n, c). The layout, walk and two-level sum of K1's statistics kernel
//     (channels_last.h): block partials in f32, then about sqrt(G)
//     groups elected by atomicAdd tickets, each sum in a fixed order in
//     double, so two calls give the same bits (remat's recompute of a block
//     and its backward rely on it). The last block forms, in double, k1,
//     k2 (rstd is constant per (n, c), so it multiplies sum(g * xc) after
//     the sum) and the weight's and bias's gradients, summing the samples
//     in order: the [N, C] work of the backward, in the same launch.
// (b) inorm_act_bwd_dx_kernel: the apply kernel's walk; reads x and dout,
//     writes dx, each f32 step rounded on its own (__fsub_rn, __fmul_rn),
//     so the result has the bits of instance_norm_act_bwd_dx_reference.
//
// What bounds it: device-memory bandwidth. (a) reads 4 bytes an element in
// bf16, (b) reads 4 and writes 2: 10 bytes against the 6 that any backward
// must move (dout and x read once, dx written once), so about 60% of that
// bound is this design's ceiling, against about 50 bytes an element for
// autograd's plain chain with its f32 copies. What the design does about
// it: 16-byte loads of both tensors, kUnroll rows of each in flight per
// thread, a grid of one wave of resident blocks, and nothing of the
// activation's size kept between the passes.
//
// Narrow widths (C < V, V % C == 0: C = 1, 2, 4 bf16 and 1, 2 f32) walk a
// sample's flat [M * C] run as 16-byte vectors, lane j holding channel
// (head + j) % C, as K1's kernels do; x and dout share the layout, so they
// share the head. The head and the elements after the last whole vector
// (at most V - 1 each) are done one by one by thread 0 of block 0.

#include "channels_last.h"

namespace {

constexpr int kUnroll = 4;  // rows of each tensor in flight per thread

// g of one element from x - mean (xc) and dout: the forward's pre-activation
// recomputed with the apply kernel's rounded steps, then the leaky ReLU's
// backward in T.
template <typename T>
__device__ inline float grad_in(float xc, float dout, float w, float b, float slope) {
  const float z = Io16<T>::round(__fadd_rn(__fmul_rn(xc, w), b));
  return z > 0.f ? dout : Io16<T>::round(__fmul_rn(dout, slope));
}

// (a) grid (G, N), block block_threads(rows, C, V) threads, dynamic shared
// memory two_level_shared_bytes(). partial: [N, G, 2, C] f32 (sum of g, then
// of g * xc); group_sum and ticket as two_level_sum takes them. out: k1
// [N, C], k2 [N, C], the weight's gradient [C], the bias's [C], f32.
template <typename T>
__global__ void inorm_act_bwd_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ dout, const float* __restrict__ mean,
    const float* __restrict__ mul, const float* __restrict__ bias, int bias_n_stride,
    float* __restrict__ partial, double* __restrict__ group_sum,
    unsigned int* __restrict__ ticket, const float* __restrict__ var,
    float* __restrict__ out_terms, long long M, int C, int rows, int group_blocks,
    float slope, float eps) {
  constexpr int V = Io16<T>::kWidth;
  const bool narrow = C < V;
  const int groups = narrow ? 1 : C / V;
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int n = blockIdx.y;
  const int N = gridDim.y;
  const int cg = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const float* mean_n = mean + (size_t)n * C;
  const float* mul_n = mul + (size_t)n * C;
  const float* bias_n = bias + (size_t)n * bias_n_stride;
  const Walk wk = walk(n, M, C, V);

  float mu[V], w[V], b[V], s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = narrow ? (int)((wk.head + i) % C) : cg * V + i;
    mu[i] = __ldg(mean_n + c);
    w[i] = __ldg(mul_n + c);
    b[i] = __ldg(bias_n + c);
    s[i] = 0.f;
    q[i] = 0.f;
  }
  const size_t sample = (size_t)n * (size_t)M * C;
  const size_t offset = sample + (narrow ? (size_t)wk.head : (size_t)cg * V);
  const uint4* xv = reinterpret_cast<const uint4*>(x + offset);
  const uint4* dv = reinterpret_cast<const uint4*>(dout + offset);
  const size_t row_vecs = narrow ? 1 : (size_t)C / V;
  const long long step = (long long)G * rows;

  auto add = [&](const uint4& rx, const uint4& rd) {
    float xf[V], df[V];
    Io16<T>::unpack(rx, xf);
    Io16<T>::unpack(rd, df);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float xc = __fsub_rn(xf[i], mu[i]);
      const float gi = grad_in<T>(xc, df[i], w[i], b[i], slope);
      s[i] += gi;
      q[i] = fmaf(gi, xc, q[i]);
    }
  };
  long long m = (long long)g * rows + r;
  for (; m + (kUnroll - 1) * step < wk.count; m += kUnroll * step) {
    uint4 rx[kUnroll], rd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      rx[u] = __ldg(xv + (size_t)(m + u * step) * row_vecs);
      rd[u] = __ldg(dv + (size_t)(m + u * step) * row_vecs);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add(rx[u], rd[u]);
  }
  for (; m < wk.count; m += step)
    add(__ldg(xv + (size_t)m * row_vecs), __ldg(dv + (size_t)m * row_vecs));

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
      float a = 0.f, bb = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if ((wk.head + i) % C == c) {
          a += s[i];
          bb += q[i];
        }
      }
      if (g == 0 && r == 0) {
        const long long L = M * C;
        auto one = [&](long long e) {
          const float xc = __fsub_rn(Io16<T>::load1(x + sample + e), __ldg(mean_n + c));
          const float gi = grad_in<T>(xc, Io16<T>::load1(dout + sample + e),
                                      __ldg(mul_n + c), __ldg(bias_n + c), slope);
          a += gi;
          bb = fmaf(gi, xc, bb);
        };
        for (long long e = c; e < wk.head; e += C) one(e);
        for (long long e = wk.head + wk.count * V; e < L; ++e)
          if (e % C == c) one(e);
      }
      ss[r * C + c] = a;
      sq[r * C + c] = bb;
    }
  }
  Slices sums;
  if (!two_level_sum(smem_d, rows, C, group_blocks, partial, group_sum, ticket, sums))
    return;
  // column qi of the slices is read by its own thread alone, so its first
  // row takes sum(g) and sum(g * x^) for the samples' sums below
  const int Q = sums.Q;
  for (int qi = threadIdx.x; qi < Q; qi += blockDim.x) {
    double a, bb;
    sums.add(qi, a, bb);
    const double v = var[qi];
    const double rstd = 1.0 / sqrt((v > 0.0 ? v : 0.0) + (double)eps);
    out_terms[qi] = (float)(a / (double)M);
    out_terms[Q + qi] = v >= 0.0 ? (float)(bb * rstd * rstd / (double)M) : 0.f;
    sums.a[qi] = a;
    sums.b[qi] = bb * rstd;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    double dw = 0.0, db = 0.0;
    for (int k = 0; k < N; ++k) {
      dw += sums.b[k * C + c];
      db += sums.a[k * C + c];
    }
    out_terms[2 * Q + c] = (float)dw;
    out_terms[2 * Q + C + c] = (float)db;
  }
}

// (b) grid (G, N), block block_threads(rows, C, V) threads.
template <typename T>
__global__ void inorm_act_bwd_dx_kernel(
    const T* __restrict__ x, const T* __restrict__ dout, T* __restrict__ dx,
    const float* __restrict__ mean, const float* __restrict__ mul,
    const float* __restrict__ bias, int bias_n_stride, const float* __restrict__ k1,
    const float* __restrict__ k2, long long M, int C, int rows, float slope) {
  constexpr int V = Io16<T>::kWidth;
  const bool narrow = C < V;
  const int groups = narrow ? 1 : C / V;
  const int n = blockIdx.y;
  const int cg = threadIdx.x % groups;
  const int r = threadIdx.x / groups;
  const size_t nc = (size_t)n * C;
  const float* bias_n = bias + (size_t)n * bias_n_stride;
  const Walk wk = walk(n, M, C, V);

  // dx of one element of channel c: mul * ((g - k1) - xc * k2), each step
  // rounded on its own
  auto one = [](float xv, float dv, float mu_c, float w_c, float b_c, float k1_c,
                float k2_c, float slope_) {
    const float xc = __fsub_rn(xv, mu_c);
    const float gi = grad_in<T>(xc, dv, w_c, b_c, slope_);
    return __fmul_rn(w_c, __fsub_rn(__fsub_rn(gi, k1_c), __fmul_rn(xc, k2_c)));
  };

  float mu[V], w[V], b[V], c1[V], c2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = narrow ? (int)((wk.head + i) % C) : cg * V + i;
    mu[i] = __ldg(mean + nc + c);
    w[i] = __ldg(mul + nc + c);
    b[i] = __ldg(bias_n + c);
    c1[i] = __ldg(k1 + nc + c);
    c2[i] = __ldg(k2 + nc + c);
  }
  const size_t sample = (size_t)n * (size_t)M * C;
  const size_t offset = sample + (narrow ? (size_t)wk.head : (size_t)cg * V);
  const uint4* xv = reinterpret_cast<const uint4*>(x + offset);
  const uint4* dv = reinterpret_cast<const uint4*>(dout + offset);
  uint4* ov = reinterpret_cast<uint4*>(dx + offset);
  const size_t row_vecs = narrow ? 1 : (size_t)C / V;
  const long long step = (long long)gridDim.x * rows;

  if (narrow && blockIdx.x == 0 && r == 0) {
    const long long L = M * C;
    auto elem = [&](long long e) {
      const size_t c = nc + e % C;
      Io16<T>::store1(dx + sample + e,
                      one(Io16<T>::load1(x + sample + e), Io16<T>::load1(dout + sample + e),
                          __ldg(mean + c), __ldg(mul + c), __ldg(bias_n + e % C),
                          __ldg(k1 + c), __ldg(k2 + c), slope));
    };
    for (long long e = 0; e < wk.head; ++e) elem(e);
    for (long long e = wk.head + wk.count * V; e < L; ++e) elem(e);
  }

  auto apply = [&](const uint4& rx, const uint4& rd) {
    float xf[V], df[V];
    Io16<T>::unpack(rx, xf);
    Io16<T>::unpack(rd, df);
#pragma unroll
    for (int i = 0; i < V; ++i) xf[i] = one(xf[i], df[i], mu[i], w[i], b[i], c1[i], c2[i], slope);
    return Io16<T>::pack(xf);
  };
  long long m = (long long)blockIdx.x * rows + r;
  for (; m + (kUnroll - 1) * step < wk.count; m += kUnroll * step) {
    uint4 rx[kUnroll], rd[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      rx[u] = __ldg(xv + (size_t)(m + u * step) * row_vecs);
      rd[u] = __ldg(dv + (size_t)(m + u * step) * row_vecs);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      ov[(size_t)(m + u * step) * row_vecs] = apply(rx[u], rd[u]);
  }
  for (; m < wk.count; m += step)
    ov[(size_t)m * row_vecs] = apply(__ldg(xv + (size_t)m * row_vecs),
                                     __ldg(dv + (size_t)m * row_vecs));
}

template <typename T>
int launch_stats(const void* x, const void* dout, const void* mean, const void* mul,
                 const void* bias, int bias_n_stride, void* partial, void* group_sum,
                 void* ticket, const void* var, void* out_terms, int N, long long M, int C,
                 int rows, int G, int group_blocks, float slope, float eps,
                 cudaStream_t stream) {
  const int threads = block_threads(rows, C, Io16<T>::kWidth);
  inorm_act_bwd_stats_kernel<T><<<dim3(G, N), threads,
                                  two_level_shared_bytes(threads, rows, N, C), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout),
      static_cast<const float*>(mean), static_cast<const float*>(mul),
      static_cast<const float*>(bias), bias_n_stride, static_cast<float*>(partial),
      static_cast<double*>(group_sum), static_cast<unsigned int*>(ticket),
      static_cast<const float*>(var), static_cast<float*>(out_terms), M, C, rows,
      group_blocks, slope, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* x, const void* dout, void* dx, const void* mean, const void* mul,
              const void* bias, int bias_n_stride, const void* k1, const void* k2, int N,
              long long M, int C, int rows, int G, float slope, cudaStream_t stream) {
  inorm_act_bwd_dx_kernel<T><<<dim3(G, N), block_threads(rows, C, Io16<T>::kWidth), 0,
                               stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dout), static_cast<T*>(dx),
      static_cast<const float*>(mean), static_cast<const float*>(mul),
      static_cast<const float*>(bias), bias_n_stride, static_cast<const float*>(k1),
      static_cast<const float*>(k2), M, C, rows, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// How many blocks of `rows` rows fit on one SM at once (the grid is sized
// to one wave of them); 0 if the shape cannot launch.
extern "C" int inorm_act_bwd_stats_blocks_per_sm(int bf16, int N, int C, int rows) {
  const int threads = block_threads(rows, C, bf16 ? 8 : 4);
  const size_t smem = two_level_shared_bytes(threads, rows, N, C);
  int blocks = 0;
  cudaError_t err =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, inorm_act_bwd_stats_kernel<__nv_bfloat16>, threads, smem)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, inorm_act_bwd_stats_kernel<float>, threads, smem);
  return err == cudaSuccess ? blocks : 0;
}

extern "C" int inorm_act_bwd_dx_blocks_per_sm(int bf16, int C, int rows) {
  const int threads = block_threads(rows, C, bf16 ? 8 : 4);
  int blocks = 0;
  cudaError_t err =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, inorm_act_bwd_dx_kernel<__nv_bfloat16>, threads, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, inorm_act_bwd_dx_kernel<float>, threads, 0);
  return err == cudaSuccess ? blocks : 0;
}

// Each returns the launch's error code. partial holds N * G * 2 * C floats
// and group_sum N * ceil(G / group_blocks) * 2 * C doubles; ticket holds
// ceil(G / group_blocks) + 1 unsigned ints, 0 before the call and 0 after
// it, used by one stream at a time; out_terms 2 * N * C + 2 * C floats.
extern "C" int inorm_act_bwd_stats_bf16(const void* x, const void* dout, const void* mean,
                                        const void* mul, const void* bias, int bias_n_stride,
                                        void* partial, void* group_sum, void* ticket,
                                        const void* var, void* out_terms, int N, long long M,
                                        int C, int rows, int G, int group_blocks, float slope,
                                        float eps, void* stream) {
  return launch_stats<__nv_bfloat16>(x, dout, mean, mul, bias, bias_n_stride, partial,
                                     group_sum, ticket, var, out_terms, N, M, C, rows, G,
                                     group_blocks, slope, eps,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" int inorm_act_bwd_stats_f32(const void* x, const void* dout, const void* mean,
                                       const void* mul, const void* bias, int bias_n_stride,
                                       void* partial, void* group_sum, void* ticket,
                                       const void* var, void* out_terms, int N, long long M,
                                       int C, int rows, int G, int group_blocks, float slope,
                                       float eps, void* stream) {
  return launch_stats<float>(x, dout, mean, mul, bias, bias_n_stride, partial, group_sum,
                             ticket, var, out_terms, N, M, C, rows, G, group_blocks, slope,
                             eps, static_cast<cudaStream_t>(stream));
}

extern "C" int inorm_act_bwd_dx_bf16(const void* x, const void* dout, void* dx,
                                     const void* mean, const void* mul, const void* bias,
                                     int bias_n_stride, const void* k1, const void* k2, int N,
                                     long long M, int C, int rows, int G, float slope,
                                     void* stream) {
  return launch_dx<__nv_bfloat16>(x, dout, dx, mean, mul, bias, bias_n_stride, k1, k2, N, M,
                                  C, rows, G, slope, static_cast<cudaStream_t>(stream));
}

extern "C" int inorm_act_bwd_dx_f32(const void* x, const void* dout, void* dx,
                                    const void* mean, const void* mul, const void* bias,
                                    int bias_n_stride, const void* k1, const void* k2, int N,
                                    long long M, int C, int rows, int G, float slope,
                                    void* stream) {
  return launch_dx<float>(x, dout, dx, mean, mul, bias, bias_n_stride, k1, k2, N, M, C, rows,
                          G, slope, static_cast<cudaStream_t>(stream));
}
