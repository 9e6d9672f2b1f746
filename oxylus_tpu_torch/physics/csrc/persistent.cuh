// What the banded and the dense rigid-body kernels share as persistent
// cooperative launches: a grid-wide barrier between passes that can also
// charge each pass's SM cycles to a kind, warp helpers for fixed-order sums
// and ascending lists, and the host-side launch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define FULL_MASK 0xffffffffu

// The barrier between two passes. With `cycles` set, block 0's first thread
// adds the SM cycles since the previous barrier to cycles[kind]: block 0
// waits there for every block, so each interval is the slowest block's pass
// plus the barrier itself.
struct PassClock {
  unsigned long long* cycles;
  long long t0;
  __device__ void start() {
    if (cycles && blockIdx.x == 0 && threadIdx.x == 0) t0 = clock64();
  }
  __device__ void end(cg::grid_group& grid, int kind) {
    grid.sync();
    if (cycles && blockIdx.x == 0 && threadIdx.x == 0) {
      const long long t = clock64();
      cycles[kind] += (unsigned long long)(t - t0);
      t0 = t;
    }
  }
};

// sum over the warp in a fixed tree (lane 0 holds the total), so every run
// adds the same values in the same order
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// position of the (e + 1)-th set bit of m (e < popc(m))
__device__ __forceinline__ int nth_bit(unsigned m, int e) {
  for (int i = 0; i < e; ++i) m &= m - 1u;
  return __ffs(m) - 1;
}

// Launch `fn(args)` cooperatively with `tpb` threads a block and enough
// blocks for `warps` warps, as many as can be resident at once (every block
// must be, for the grid barrier); returns a cudaError_t code.
static inline int launch_persistent(const void* fn, void* args, int warps, int tpb, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, tpb, 0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int want = (warps + tpb / 32 - 1) / (tpb / 32);
  const int grid = want < per_sm * sms ? want : per_sm * sms;
  void* params[] = {args};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(tpb), params, 0, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  return (int)e;
}
