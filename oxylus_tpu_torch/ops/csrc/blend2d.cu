// Ordered alpha blend of sorted sprites over 32x32 screen tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernels oxylus_tpu/ops/raster2d_pallas.py::_blend_kernel (:41)
// and _blend_kernel_depth (:55), launched by blend_tiles_pallas (:260). Plain
// PyTorch version: oxylus_tpu_torch/ops/blend2d.py::blend_tiles_reference, which
// this file mirrors operation for operation (built with -fmad=false, so results
// are bit-identical).
//
// What it computes, per 32x32 tile (one thread block, one thread per pixel):
// the first cnt entries of the tile's sprite list, in order. Per entry, from the
// tile's packed field row [p00x p00y e0x e0y e1x e1y idet cut_eff eid flip
// (depth)], staged in shared memory: the pixel centre's sprite-local (lu, lv),
// inside where both lie in [0, 1]; u = lu + flip*(1 - 2 lu) and v = 1 - lv;
// fu, fv = clip(., 0, 1)*15; the four bilinear taps around (fu, fv) of the
// sprite's pre-tinted 16x16 texel plane, u0 = min(floor(fu), 14), u1 = u0 + 1
// (the same in v), each weighted by the TPU kernel's tent weights
// max(1 - |fv - gv|, 0)*max(1 - |fu - gu|, 0) (0 on a tap past an integer or
// edge coordinate; those weights are nonzero on no other texel) and summed
// ((t00 + t01) + t10) + t11; a = ta*inside, 0 below cut_eff, and in the depth
// variant 0 unless the record's reverse-Z depth is strictly nearer than the
// scene's (a test, no write); then premultiplied over, c = c*(1 - a) + t*a,
// alpha = alpha*(1 - a) + a, and the entity id where a > 0.5 (carried as float,
// cast at the end). Empty tiles write (0, 0, 0, 0) and vid -1. Colour and vid
// are written straight into the cropped (H, W, 4) / (H, W) images.
//
// What bounds it on the card: per live (tile, entry) pair, ~70 float operations
// for each of the tile's 1024 pixels (the local coordinates, the tent weights,
// the 4-tap sum over 4 channels, the blend), against the float32 rate of the
// SMs (67 TFLOP/s); the bytes (the packed fields, the texel planes the tiles
// reference, 20 B of output per pixel) are far below that for the scenes it
// serves.
//
// What the design does about it: a tile's fields are loaded once into shared
// memory and read as broadcasts; each thread keeps its pixel's colour, alpha
// and id in registers across the tile's entries; the texel taps are 16-byte
// loads through the L1 (one sprite's plane is 4 KB). A shared-memory texel
// plane per entry, warp-level skipping of entries whose quad misses a warp's
// rows, and TMA staging are later work.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 32;
constexpr int PIX = TILE * TILE;
constexpr int TEX = 16;
constexpr int N_FIELDS = 10;

__device__ __forceinline__ float clip01(float x) { return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x); }

__device__ __forceinline__ float tent(float c, int g) {
  const float w = 1.0f - fabsf(c - (float)g);
  return w < 0.0f ? 0.0f : w;
}

template <bool kDepth>
__global__ void __launch_bounds__(PIX) blend2d_kernel(
    const int* __restrict__ tile_list, const int* __restrict__ cnt, const float* __restrict__ fields,
    const float4* __restrict__ tex, const float* __restrict__ scene_depth, int k_cap, int n_fld, int n_tex, int tx,
    int width, int height, float4* __restrict__ color_out, int* __restrict__ vid_out) {
  extern __shared__ float smem[];
  float* s_fld = smem;                                     // [n][n_fld]
  int* s_sid = reinterpret_cast<int*>(smem + k_cap * n_fld);  // [n]

  const int t = blockIdx.x;
  const int lin = threadIdx.x;
  const int n = cnt[t];
  const float* row = fields + (size_t)t * k_cap * n_fld;
  for (int i = lin; i < n * n_fld; i += PIX) s_fld[i] = row[i];
  for (int i = lin; i < n; i += PIX) {
    int sid = tile_list[(size_t)t * k_cap + i];
    s_sid[i] = sid < 0 ? 0 : (sid >= n_tex ? n_tex - 1 : sid);
  }
  __syncthreads();

  const int lx = lin % TILE, ly = lin / TILE;
  const int gx = (t % tx) * TILE + lx;
  const int gy = (t / tx) * TILE + ly;
  if (gx >= width || gy >= height) return;
  const float px = ((float)((t % tx) * TILE) + (float)lx) + 0.5f;
  const float py = ((float)((t / tx) * TILE) + (float)ly) + 0.5f;
  const size_t o = (size_t)gy * width + gx;
  const float sdep = kDepth ? scene_depth[o] : 0.0f;

  float cr = 0.0f, cg = 0.0f, cb = 0.0f, ca = 0.0f, vid = -1.0f;
  for (int k = 0; k < n; ++k) {
    const float* f = s_fld + k * n_fld;
    const float p00x = f[0], p00y = f[1], e0x = f[2], e0y = f[3], e1x = f[4], e1y = f[5];
    const float idet = f[6], cut = f[7], eid = f[8], flip = f[9];
    const float rx = px - p00x;
    const float ry = py - p00y;
    const float lu = (rx * e1y - ry * e1x) * idet;
    const float lv = (ry * e0x - rx * e0y) * idet;
    const bool inside = lu >= 0.0f && lu <= 1.0f && lv >= 0.0f && lv <= 1.0f;
    const float u = lu + flip * (1.0f - 2.0f * lu);
    const float v = 1.0f - lv;
    const float fu = clip01(u) * (float)(TEX - 1);
    const float fv = clip01(v) * (float)(TEX - 1);
    int u0 = (int)fu, v0 = (int)fv;
    u0 = u0 < 0 ? 0 : (u0 > TEX - 2 ? TEX - 2 : u0);
    v0 = v0 < 0 ? 0 : (v0 > TEX - 2 ? TEX - 2 : v0);
    const float wu[2] = {tent(fu, u0), tent(fu, u0 + 1)};
    const float wv[2] = {tent(fv, v0), tent(fv, v0 + 1)};
    const float4* plane = tex + (size_t)s_sid[k] * (TEX * TEX);
    float tr = 0.0f, tg = 0.0f, tb = 0.0f, ta = 0.0f;
#pragma unroll
    for (int dv = 0; dv < 2; ++dv) {
#pragma unroll
      for (int du = 0; du < 2; ++du) {
        const float4 tap = __ldg(plane + (v0 + dv) * TEX + (u0 + du));
        const float w = wv[dv] * wu[du];
        if (dv == 0 && du == 0) {
          tr = tap.x * w;
          tg = tap.y * w;
          tb = tap.z * w;
          ta = tap.w * w;
        } else {
          tr = tr + tap.x * w;
          tg = tg + tap.y * w;
          tb = tb + tap.z * w;
          ta = ta + tap.w * w;
        }
      }
    }
    float a = ta * (inside ? 1.0f : 0.0f);
    a = a < cut ? 0.0f : a;
    if (kDepth) a = f[N_FIELDS] > sdep ? a : 0.0f;
    const float one_m = 1.0f - a;
    cr = cr * one_m + tr * a;
    cg = cg * one_m + tg * a;
    cb = cb * one_m + tb * a;
    ca = ca * one_m + a;
    vid = a > 0.5f ? eid : vid;
  }
  color_out[o] = make_float4(cr, cg, cb, ca);
  vid_out[o] = (int)vid;
}

}  // namespace

extern "C" int blend2d(const void* tile_list, const void* cnt, const void* fields, const void* tex,
                       const void* scene_depth, int n_tiles, int k_cap, int n_fld, int n_tex, int width, int height,
                       void* color, void* vid, void* stream) {
  const int tx = (width + TILE - 1) / TILE;
  const int ty = (height + TILE - 1) / TILE;
  const bool with_depth = scene_depth != nullptr;
  if (n_tiles != tx * ty || k_cap <= 0 || n_tex <= 0 || n_fld != N_FIELDS + (with_depth ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k_cap * n_fld * sizeof(float) + (size_t)k_cap * sizeof(int);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (with_depth) {
    blend2d_kernel<true><<<n_tiles, PIX, smem, s>>>(
        (const int*)tile_list, (const int*)cnt, (const float*)fields, (const float4*)tex, (const float*)scene_depth,
        k_cap, n_fld, n_tex, tx, width, height, (float4*)color, (int*)vid);
  } else {
    blend2d_kernel<false><<<n_tiles, PIX, smem, s>>>(
        (const int*)tile_list, (const int*)cnt, (const float*)fields, (const float4*)tex, nullptr, k_cap, n_fld,
        n_tex, tx, width, height, (float4*)color, (int*)vid);
  }
  return (int)cudaGetLastError();
}
