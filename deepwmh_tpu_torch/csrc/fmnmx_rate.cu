// A measurement probe, not a kernel of the port: how many f32 min/max
// instructions (FMNMX) the card issues per second, the rate K2's operations
// bound (median3.cu) rests on. chip_smoke.py builds and times it.
//
// Each thread runs `rounds` rounds of 64 min/max on 8 registers: two layers
// of four compare-exchanges, four times, so every layer has 8 independent
// instructions and no round simplifies into another. The SASS holds 64
// FMNMX in the loop.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void ce(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

__global__ void fmnmx_rate_kernel(float* out, int rounds, float sentinel) {
  float w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = sentinel * (float)((threadIdx.x * 7 + i * 13) % 17);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ce(w[0], w[1]);
      ce(w[2], w[3]);
      ce(w[4], w[5]);
      ce(w[6], w[7]);
      ce(w[1], w[2]);
      ce(w[3], w[4]);
      ce(w[5], w[6]);
      ce(w[7], w[0]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += w[i] * (float)(i + 1);
  // the store keeps the work alive; sentinel is chosen so it never happens
  if (s == sentinel) out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// 64 * rounds min/max per thread, blocks x threads threads; pass
// sentinel = 0.5 (no sum of the values equals it).
extern "C" int fmnmx_rate(void* out, int blocks, int threads, int rounds,
                          float sentinel, void* stream) {
  fmnmx_rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), rounds, sentinel);
  return (int)cudaGetLastError();
}
