// K2's selection scheme as device functions. Generated from the lists in
// deepwmh_tpu_torch/ops/kernels.py by median27_header(); do not edit by
// hand (tests/test_torch_port_analysis.py checks that the two agree).
#pragma once

// compare-exchange: the min stays on a, the max goes to b
__device__ __forceinline__ void m27_ce(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// sorts one 3-value column in place
__device__ __forceinline__ void m27_column(float (&w)[3]) {
  m27_ce(w[0], w[1]);
  m27_ce(w[1], w[2]);
  m27_ce(w[0], w[1]);
}

// w: three sorted columns (dx = 0, 1, 2); s: the slab's 9 values sorted
__device__ __forceinline__ void m27_slab(float (&w)[9], float (&s)[9]) {
  m27_ce(w[0], w[3]);
  m27_ce(w[2], w[5]);
  m27_ce(w[2], w[3]);
  m27_ce(w[1], w[4]);
  m27_ce(w[1], w[2]);
  m27_ce(w[4], w[3]);
  m27_ce(w[0], w[6]);
  m27_ce(w[3], w[6]);
  m27_ce(w[2], w[8]);
  m27_ce(w[2], w[3]);
  m27_ce(w[8], w[6]);
  m27_ce(w[1], w[7]);
  m27_ce(w[5], w[7]);
  m27_ce(w[4], w[5]);
  m27_ce(w[1], w[2]);
  m27_ce(w[4], w[3]);
  m27_ce(w[5], w[8]);
  m27_ce(w[7], w[6]);
  s[0] = w[0];
  s[1] = w[1];
  s[2] = w[2];
  s[3] = w[4];
  s[4] = w[3];
  s[5] = w[5];
  s[6] = w[8];
  s[7] = w[7];
  s[8] = w[6];
}

// w: two sorted slabs; p[r] = rank 4 + r of their 18 values
__device__ __forceinline__ void m27_pair(float (&w)[18], float (&p)[10]) {
  m27_ce(w[0], w[9]);
  m27_ce(w[8], w[17]);
  m27_ce(w[8], w[9]);
  m27_ce(w[4], w[13]);
  m27_ce(w[4], w[8]);
  m27_ce(w[13], w[9]);
  m27_ce(w[2], w[11]);
  m27_ce(w[6], w[15]);
  m27_ce(w[6], w[11]);
  m27_ce(w[2], w[4]);
  m27_ce(w[6], w[8]);
  m27_ce(w[11], w[13]);
  m27_ce(w[15], w[9]);
  m27_ce(w[1], w[10]);
  m27_ce(w[5], w[14]);
  m27_ce(w[5], w[10]);
  m27_ce(w[3], w[12]);
  m27_ce(w[7], w[16]);
  m27_ce(w[7], w[12]);
  m27_ce(w[3], w[5]);
  m27_ce(w[7], w[10]);
  m27_ce(w[12], w[14]);
  m27_ce(w[1], w[2]);
  m27_ce(w[3], w[4]);
  m27_ce(w[5], w[6]);
  m27_ce(w[7], w[8]);
  m27_ce(w[10], w[11]);
  m27_ce(w[12], w[13]);
  m27_ce(w[14], w[15]);
  m27_ce(w[16], w[9]);
  p[0] = w[4];
  p[1] = w[5];
  p[2] = w[6];
  p[3] = w[7];
  p[4] = w[8];
  p[5] = w[10];
  p[6] = w[11];
  p[7] = w[12];
  p[8] = w[13];
  p[9] = w[14];
}

// rank 13 of the pair's 18 values and a third sorted slab's 9
__device__ __forceinline__ float m27_select(const float (&p)[10], const float (&s)[9]) {
  float m = p[0];
  m = fmaxf(m, fminf(p[1], s[8]));
  m = fmaxf(m, fminf(p[2], s[7]));
  m = fmaxf(m, fminf(p[3], s[6]));
  m = fmaxf(m, fminf(p[4], s[5]));
  m = fmaxf(m, fminf(p[5], s[4]));
  m = fmaxf(m, fminf(p[6], s[3]));
  m = fmaxf(m, fminf(p[7], s[2]));
  m = fmaxf(m, fminf(p[8], s[1]));
  m = fmaxf(m, fminf(p[9], s[0]));
  return m;
}
