// Hierarchical-Z min pyramid for Hopper (sm_90a).
//
// Replaces the TPU kernels oxylus_tpu/ops/hiz.py::_spd_tile_kernel (:103) and
// _spd_tail_kernel (:110), launched by build_hiz_pallas (:141, :161). Plain
// PyTorch version: oxylus_tpu_torch/ops/hiz.py::hiz_reference.
//
// What it computes: from the depth padded with 0 to multiples of 128x512 (the
// wrapper pads it), levels 1 and 2 by one block per 128x512 tile, each output
// the min of its 2x2 block; then the tail levels ((h+1)/2, (w+1)/2) until the
// smaller side is 1 or there are n_levels levels, where a partner missing at an
// odd size reads 0 (the TPU kernel's selection matmul gives a zero row there),
// so the last row or column of an odd level is 0. Min is exact: the result
// equals the plain version's bit for bit.
//
// What bounds it on the card: bytes. It reads the padded depth once (9.4 MB at
// 1080p) and writes a third of that; ~3 us at 3.35 TB/s. The TPU kernel's
// even/odd selection matmuls exist because Mosaic has no strided value
// slices; here each thread reads a 4x4 input block as four 16-byte loads and
// writes one level-2 texel and its four level-1 texels.
//
// What the design does about it: the tiled launch reads every input byte once
// with coalesced float4 loads; the tail (levels of at most 1/16 of the input)
// runs as one block of 1024 threads that walks the levels with a barrier
// between them, so the whole pyramid is two launches.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_H = 128;
constexpr int TILE_W = 512;
constexpr int THREADS = 256;
constexpr int TAIL_THREADS = 1024;

__global__ void __launch_bounds__(THREADS) hiz_tiles_kernel(const float* __restrict__ base, int wp,
                                                           float* __restrict__ mip1, float* __restrict__ mip2) {
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const int w1 = wp / 2, w2 = wp / 4;
  for (int o = threadIdx.x; o < (TILE_H / 4) * (TILE_W / 4); o += THREADS) {
    const int oy = o / (TILE_W / 4), ox = o % (TILE_W / 4);
    float4 r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r[k] = *reinterpret_cast<const float4*>(base + (size_t)(y0 + 4 * oy + k) * wp + x0 + 4 * ox);
    const float a00 = fminf(fminf(r[0].x, r[0].y), fminf(r[1].x, r[1].y));
    const float a01 = fminf(fminf(r[0].z, r[0].w), fminf(r[1].z, r[1].w));
    const float a10 = fminf(fminf(r[2].x, r[2].y), fminf(r[3].x, r[3].y));
    const float a11 = fminf(fminf(r[2].z, r[2].w), fminf(r[3].z, r[3].w));
    const size_t m1 = (size_t)(y0 / 2 + 2 * oy) * w1 + x0 / 2 + 2 * ox;
    *reinterpret_cast<float2*>(mip1 + m1) = make_float2(a00, a01);
    *reinterpret_cast<float2*>(mip1 + m1 + w1) = make_float2(a10, a11);
    mip2[(size_t)(y0 / 4 + oy) * w2 + x0 / 4 + ox] = fminf(fminf(a00, a01), fminf(a10, a11));
  }
}

// One block: each level reads the previous one from global memory, after a
// block barrier (which orders the block's global writes before its reads).
__global__ void __launch_bounds__(TAIL_THREADS) hiz_tail_kernel(float* buf, int h, int w, int n_tail) {
  const float* cur = buf;
  float* out = buf + (size_t)h * w;
  for (int lvl = 0; lvl < n_tail; ++lvl) {
    const int ho = (h + 1) / 2, wo = (w + 1) / 2;
    for (int o = threadIdx.x; o < ho * wo; o += TAIL_THREADS) {
      const int i = o / wo, j = o % wo;
      const bool has_c = 2 * j + 1 < w, has_r = 2 * i + 1 < h;
      const float* p = cur + (size_t)(2 * i) * w + 2 * j;
      const float v00 = p[0];
      const float v01 = has_c ? p[1] : 0.0f;
      const float v10 = has_r ? p[w] : 0.0f;
      const float v11 = (has_c && has_r) ? p[w + 1] : 0.0f;
      out[o] = fminf(fminf(v00, v01), fminf(v10, v11));
    }
    __syncthreads();
    cur = out;
    out += (size_t)ho * wo;
    h = ho;
    w = wo;
  }
}

}  // namespace

// base: (hp, wp) padded depth; out: levels 1 .. n_levels-1 back to back.
extern "C" int hiz_build(const void* base, int hp, int wp, int n_levels, void* out, void* stream) {
  if (hp <= 0 || wp <= 0 || hp % TILE_H != 0 || wp % TILE_W != 0 || n_levels < 3) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* mip1 = (float*)out;
  float* mip2 = mip1 + (size_t)(hp / 2) * (wp / 2);
  hiz_tiles_kernel<<<dim3(wp / TILE_W, hp / TILE_H), THREADS, 0, s>>>((const float*)base, wp, mip1, mip2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_levels > 3) hiz_tail_kernel<<<1, TAIL_THREADS, 0, s>>>(mip2, hp / 4, wp / 4, n_levels - 3);
  return (int)cudaGetLastError();
}
