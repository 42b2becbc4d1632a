// 3x3x3 median with a constant-0 boundary, for Hopper (sm_90a).
//
// Replaces deepwmh_tpu/ops/pallas_kernels.py median3_pallas (body
// _median3_kernel, network _median27): in [B, D, H, W] f32 -> out [B, D, H,
// W] f32, out[b, z, y, x] = the median (rank 13 of 27) of in[b, z-1..z+1,
// y-1..y+1, x-1..x+1], with zeros outside volume b (B = 1 is one volume;
// a batch is what vmap of the Pallas kernel computes). One launch covers
// the batch: blockIdx.z is (b, depth chunk), and a chunk reads planes of
// its own volume only, so plane D of volume b is a zero, never volume
// b + 1's first plane.
//
// Defined on finite input. fminf/fmaxf drop a NaN where torch.sort puts it
// last, so a window holding a NaN may give another value than the plain
// version. Stage-1's input is finite (the NLL zeroes NaNs first). -0.0 and
// +0.0 compare equal, so either may come out where the median is a zero.
//
// What bounds it: operations. Each voxel is read once and written once
// (8 bytes: about 0.02 ms for a 192x224x192 volume at 3.35 TB/s), but a
// selection of rank 13 of 27 takes many min/max instructions per voxel: the
// first version ran _median27's pruned network (520 per voxel) from scratch
// for every output.
//
// What the design does about it: neighbouring windows share 18 of their 27
// values, and this kernel shares the sorting work on them
// (median27_network.h, generated from the lists in ops/kernels.py, which a
// CPU test proves correct on every 0/1 input):
// - A warp covers 32 consecutive x of one row y; a thread walks kChunk
//   outputs along z. At each z-plane it loads its column in[z, y-1..y+1, x]
//   and sorts it (m27_column); the sorted columns at x-1 and x+1 come from
//   the neighbouring lanes by shuffles (lanes 0 and 31 sort the one column
//   beyond the warp's edge themselves), so each column is sorted once for
//   the three outputs along x whose windows hold it.
// - The three sorted columns merge into the plane's sorted 3x3 slab
//   (m27_slab), once for the three outputs along z that hold it.
// - Two consecutive slabs (planes z, z+1) merge into the ranks 4..13 of
//   their 18 values (m27_pair), once for the two outputs z (with slab z-1)
//   and z+1 (with slab z+2); m27_select then takes rank 13 of 27 with a
//   max of mins over the pair and the third slab.
// That is 90 min/max per output in the steady state against 520
// (median27_shared_ops). The values come straight from global memory (each
// is loaded by the three warps of rows y-1, y, y+1, which L1 serves); no
// shared memory and no __syncthreads.

#include <cuda_runtime.h>

#include "median27_network.h"

namespace {

constexpr int kWarpsPerBlock = 8;  // rows y per block
constexpr int kChunk = 16;         // outputs along z per thread (even)

struct Volume {
  const float* __restrict__ in;
  int D, H, W;
};

// the column in[z, y-1..y+1, x], zeros outside the volume, sorted
__device__ __forceinline__ void sorted_column(const Volume& v, int z, int y,
                                              int x, float (&c)[3]) {
  const bool inside = z >= 0 && z < v.D && x >= 0 && x < v.W;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int yy = y - 1 + k;
    c[k] = (inside && yy >= 0 && yy < v.H)
               ? __ldg(v.in + ((size_t)z * v.H + yy) * v.W + x)
               : 0.f;
  }
  m27_column(c);
}

// the sorted 3x3 slab of plane z around (y, x); every lane of the warp
// takes part (the shuffles need all 32)
__device__ __forceinline__ void sorted_slab(const Volume& v, int z, int y,
                                            int x, int halo_x, int lane,
                                            float (&s)[9]) {
  float own[3], halo[3], w[9];
  sorted_column(v, z, y, x, own);
  sorted_column(v, z, y, halo_x, halo);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float left = __shfl_up_sync(0xffffffffu, own[k], 1);
    const float right = __shfl_down_sync(0xffffffffu, own[k], 1);
    w[k] = lane == 0 ? halo[k] : left;
    w[3 + k] = own[k];
    w[6 + k] = lane == 31 ? halo[k] : right;
  }
  m27_slab(w, s);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    median3_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int D, int H, int W, int chunks) {
  // volume b of the batch, then its own depth chunk
  const int b = blockIdx.z / chunks;
  const size_t offset = (size_t)b * D * H * W;
  in += offset;
  out += offset;
  const Volume v{in, D, H, W};
  const int lane = threadIdx.x;
  const int x = blockIdx.x * 32 + lane;
  const int y = blockIdx.y * kWarpsPerBlock + threadIdx.y;
  if (y >= H) return;  // a whole warp: the shuffles stay full
  // lane 0 sorts the column left of the warp, lane 31 the one right of it;
  // the other lanes' halo is outside the volume (zeros, unused)
  const int halo_x = lane == 0 ? x - 1 : (lane == 31 ? x + 1 : -1);
  const bool store = x < W;
  const int z0 = (blockIdx.z - b * chunks) * kChunk;

  float prev[9], a[9];
  sorted_slab(v, z0 - 1, y, x, halo_x, lane, prev);
  sorted_slab(v, z0, y, x, halo_x, lane, a);
#pragma unroll 1
  for (int z = z0; z < z0 + kChunk && z < D; z += 2) {
    float b[9], c[9], w[18], p[10];
    sorted_slab(v, z + 1, y, x, halo_x, lane, b);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      w[k] = a[k];
      w[9 + k] = b[k];
    }
    m27_pair(w, p);
    if (store) out[((size_t)z * H + y) * W + x] = m27_select(p, prev);
    sorted_slab(v, z + 2, y, x, halo_x, lane, c);
    if (store && z + 1 < D) out[((size_t)(z + 1) * H + y) * W + x] = m27_select(p, c);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      prev[k] = b[k];
      a[k] = c[k];
    }
  }
}

}  // namespace

// Returns the launch's error code: a grid beyond the card's limits
// (more than 65535 blocks along H, or along B x the depth chunks) is
// refused there.
extern "C" int median3_f32(const void* in, void* out, int B, int D, int H,
                           int W, void* stream) {
  const int chunks = (D + kChunk - 1) / kChunk;
  const dim3 grid((W + 31) / 32, (H + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  B * chunks);
  median3_kernel<<<grid, dim3(32, kWarpsPerBlock), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), D, H, W,
      chunks);
  return (int)cudaGetLastError();
}
