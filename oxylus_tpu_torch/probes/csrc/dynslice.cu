// Windowed banded gather for Hopper (sm_90a).
//
// Replaces the TPU probe kernel scripts/probe_dynslice.py::kernel (:28,
// launched by pallas_call at :53). Plain PyTorch version:
// oxylus_tpu_torch/probes/dynslice.py::dynslice_reference.
//
// What it computes: for i = 128c + j (8 chunks of 128 lanes) and the window
// start ws = clamp(128c, 0, 768), out[r, i] = bf16(x[r, i + d[i]]) when
// 0 <= i + d[i] - ws < 256, else 0; then out[0, 0:128] is doubled (the TPU
// kernel's scratch echo of chunk 0's row 0). The TPU kernel builds a
// (256, 128) one-hot matrix per chunk and multiplies by it on the matrix unit
// because Mosaic has no lane gather; its product has one term, so the result
// is exactly the gathered bf16 value, which is what this kernel reads.
//
// What bounds it on the card: nothing but launch latency. It moves 20 KB (x
// 8 KB and d 4 KB read, out 8 KB written), 6 ns at 3.35 TB/s, and does a few
// integer operations per lane.
//
// What the design does about it: one block of 1024 threads, one thread per
// output lane for both rows; the two rows are staged in shared memory with
// coalesced loads, so each gather reads shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int B = 1024;
constexpr int BCHUNK = 128;
constexpr int SLAB = 256;

__global__ void __launch_bounds__(B) dynslice_kernel(const float* __restrict__ x, const int* __restrict__ d,
                                                     float* __restrict__ out) {
  __shared__ float xs[2][B];
  const int i = threadIdx.x;
  xs[0][i] = x[i];
  xs[1][i] = x[B + i];
  __syncthreads();
  const int c = i / BCHUNK;
  const int ws = max(0, min(c * BCHUNK, B - SLAB));
  const int src = i + d[i];
  const bool inside = src - ws >= 0 && src - ws < SLAB;
  for (int r = 0; r < 2; ++r) {
    float v = inside ? __bfloat162float(__float2bfloat16_rn(xs[r][src])) : 0.0f;
    if (r == 0 && i < BCHUNK) v = v + v;
    out[r * B + i] = v;
  }
}

}  // namespace

// x: (2, 1024) f32, d: (1, 1024) i32, out: (2, 1024) f32.
extern "C" int probe_dynslice(const void* x, const void* d, void* out, void* stream) {
  dynslice_kernel<<<1, B, 0, (cudaStream_t)stream>>>((const float*)x, (const int*)d, (float*)out);
  return (int)cudaGetLastError();
}
