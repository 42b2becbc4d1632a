// 3x3x3 median with a constant-0 boundary, for Hopper (sm_90a).
//
// Replaces deepwmh_tpu/ops/pallas_kernels.py median3_pallas (body
// _median3_kernel, network _median27): in [D, H, W] f32 -> out [D, H, W]
// f32, out[z, y, x] = the median (rank 13 of 27) of in[z-1..z+1, y-1..y+1,
// x-1..x+1], with zeros outside the volume.
//
// Defined on finite input. fminf/fmaxf drop a NaN where torch.sort puts it
// last, so a window holding a NaN may give another value than the plain
// version. Stage-1's input is finite (the NLL zeroes NaNs first). -0.0 and
// +0.0 compare equal, so either may come out where the median is a zero.
//
// What bounds it: operations. Each voxel is read once and written once
// (8 bytes: about 0.02 ms for a 192x224x192 volume at 3.35 TB/s), but the
// selection network runs hundreds of min/max instructions per voxel.
//
// What the design does about it (a first version: simple and right):
// - A block owns a TZ x TY x TX output tile and stages the tile with its
//   one-voxel halo in shared memory, writing zeros where the halo leaves
//   the volume, so every global value is loaded once per block and the
//   boundary needs no test in the network.
// - Each thread gathers its 27 neighbours into registers (fully unrolled,
//   constant indices, so the array does not spill) and runs _median27's
//   odd-even transposition network: 27 passes of compare-exchanges
//   (fminf + fmaxf), rank 13 is the median. Outputs of the network that
//   never reach rank 13 are dead code, which the compiler removes.
// - Not yet done (a later version): sharing sorted columns between
//   neighbouring outputs, a smaller selection network, several outputs
//   per thread.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int TZ = 2;
constexpr int kThreads = TX * TY * TZ;
constexpr int kN = 27;

__global__ void __launch_bounds__(kThreads)
    median3_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int D, int H, int W) {
  __shared__ float tile[TZ + 2][TY + 2][TX + 2];
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * TZ;
  const int tid = threadIdx.x + TX * (threadIdx.y + TY * threadIdx.z);
  constexpr int kTile = (TZ + 2) * (TY + 2) * (TX + 2);
  for (int i = tid; i < kTile; i += kThreads) {
    const int lx = i % (TX + 2);
    const int r = i / (TX + 2);
    const int ly = r % (TY + 2);
    const int lz = r / (TY + 2);
    const int gx = x0 + lx - 1;
    const int gy = y0 + ly - 1;
    const int gz = z0 + lz - 1;
    float v = 0.f;
    if (gx >= 0 && gx < W && gy >= 0 && gy < H && gz >= 0 && gz < D)
      v = __ldg(in + ((size_t)gz * H + gy) * W + gx);
    tile[lz][ly][lx] = v;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const int z = z0 + threadIdx.z;
  if (x >= W || y >= H || z >= D) return;

  float w[kN];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        w[dz * 9 + dy * 3 + dx] =
            tile[threadIdx.z + dz][threadIdx.y + dy][threadIdx.x + dx];

#pragma unroll
  for (int pass = 0; pass < kN; ++pass) {
#pragma unroll
    for (int i = pass & 1; i < kN - 1; i += 2) {
      const float lo = fminf(w[i], w[i + 1]);
      const float hi = fmaxf(w[i], w[i + 1]);
      w[i] = lo;
      w[i + 1] = hi;
    }
  }
  out[((size_t)z * H + y) * W + x] = w[kN / 2];
}

}  // namespace

// Returns the launch's error code: a grid beyond the card's limits
// (more than 65535 tiles along H or D) is refused there.
extern "C" int median3_f32(const void* in, void* out, int D, int H, int W,
                           void* stream) {
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, (D + TZ - 1) / TZ);
  median3_kernel<<<grid, dim3(TX, TY, TZ), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), D, H, W);
  return (int)cudaGetLastError();
}
