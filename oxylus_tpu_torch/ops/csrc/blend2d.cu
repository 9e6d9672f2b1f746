// Ordered alpha blend of sorted sprites over 32x32 screen tiles, for Hopper (sm_90a).
//
// Replaces the TPU kernels oxylus_tpu/ops/raster2d_pallas.py::_blend_kernel (:41)
// and _blend_kernel_depth (:55), launched by blend_tiles_pallas (:260). Plain
// PyTorch version: oxylus_tpu_torch/ops/blend2d.py::blend_tiles_reference, whose
// per-pixel arithmetic this file repeats operation for operation (built with
// -fmad=false, so results are bit-identical).
//
// What it computes, per 32x32 tile: the first cnt entries of the tile's sprite
// list, in order. Per entry, from the tile's packed field row [p00x p00y e0x
// e0y e1x e1y idet cut_eff eid flip (depth)]: the pixel centre's sprite-local
// (lu, lv), inside where both lie in [0, 1]; u = lu + flip*(1 - 2 lu) and
// v = 1 - lv; fu, fv = clip(., 0, 1)*15; the four bilinear taps around
// (fu, fv) of the sprite's pre-tinted 16x16 texel plane, u0 = min(floor(fu),
// 14), u1 = u0 + 1 (the same in v), each weighted by the TPU kernel's tent
// weights max(1 - |fv - gv|, 0)*max(1 - |fu - gu|, 0) (0 on a tap past an
// integer or edge coordinate; those weights are nonzero on no other texel) and
// summed ((t00 + t01) + t10) + t11; a = ta*inside, 0 below cut_eff, and in the
// depth variant 0 unless the record's reverse-Z depth is strictly nearer than
// the scene's (a test, no write); then premultiplied over, c = c*(1 - a) + t*a,
// alpha = alpha*(1 - a) + a, and the entity id where a > 0.5 (carried as float,
// cast at the end). Empty tiles write (0, 0, 0, 0) and vid -1. Colour and vid
// are written straight into the cropped (H, W, 4) / (H, W) images.
//
// What bounds it on the card: the bytes (the live entries' fields, the texels
// they need, 20 B of output per pixel; the scene depth in the depth variant);
// the ~88 float operations per live (entry, pixel) are below that at the SMs'
// float32 rate (67 TFLOP/s) for the scenes it serves. Its time is latency: a
// pixel takes its tile's entries in order, each a chain of dependent steps,
// so the tiles with the most entries (64, where config 2's particle emitters
// crowd) set the time.
//
// What the design does about it (the first port ran one 1024-thread CTA per
// tile, a thread a pixel, so a full tile's 64 steps ran on one SM, one
// dependent step after another, and the full tiles started wherever their
// index put them in the grid):
// - A tile's pixels are split over STRIPS CTAs of 32x4 pixels, 128 threads, a
//   thread a pixel, at least 8 CTAs an SM: a full tile runs on 8 SMs. A
//   pixel's entries are never split: each pixel takes them strictly in list
//   order in one thread ("over" is associative only up to rounding).
// - Windows of WIN entries: a thread computes the window's taps first (they
//   do not depend on the colour so far, so their loads and arithmetic
//   overlap) and then applies the window's steps in order.
// - Per-warp skip. A warp is an 8x4 block. Each lane computes its pixel's
//   (lu, lv) as the step does; where no image pixel of the warp is inside the
//   quad of any entry of the window and none has u or v NaN (a degenerate
//   quad), the warp skips the window's taps and steps. Those steps are the
//   identity there, given finite texels of magnitude below 2^125 (the
//   pre-tinted planes of pack_blend_inputs: textures in [0, 1] or 1, times the
//   record's tint): fu and fv are finite, so the tap sums are finite,
//   a = ta*0 is +-0, 1 - a = 1, c*1 + t*(+-0) = c and the id is kept, except
//   that -0 + +0 = +0. So a warp also takes every window while one of its
//   image pixels holds a colour or alpha of -0 or NaN (a tint of -0 or below
//   0, or a NaN quad, can put it there). The cutoff and the depth test need
//   no skip of their own: they only zero a.
// - Fullest tiles first: a one-CTA counting sort orders the tiles by entry
//   count, and CTA i takes strip i % STRIPS of the (i / STRIPS)-th, so the
//   full tiles start at once instead of where their index falls.
// - The taps read the planes through the read-only cache. Staging each
//   window's planes in shared memory (cp.async, a ring of windows, with an L2
//   prefetch) measured slower than these reads on every input tried (the ring
//   needs two block barriers a window), as did an L1 prefetch a window ahead.
// - The depth variant reads the scene depth once per pixel. A tile with no
//   entry writes its zeros and returns before any barrier.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 32;
constexpr int STRIP = 4;                  // rows of a tile one CTA takes
constexpr int STRIPS = TILE / STRIP;      // CTAs a tile
constexpr int THREADS = TILE * STRIP;     // a pixel a thread
constexpr int WARPS = THREADS / 32;
constexpr int BW = 8, BH = 4;             // a warp's block of the strip
constexpr int BLOCKS_X = TILE / BW;
static_assert(BLOCKS_X * (STRIP / BH) == WARPS, "one block per warp");
constexpr int MIN_BLOCKS = 8;             // CTAs an SM must hold (registers: at most 64 a thread)
constexpr int WIN = 2;                    // entries a window: their taps are computed together
constexpr int TEX = 16;
constexpr int PLANE = TEX * TEX;          // float4 texels in a sprite's plane (4 KB)
constexpr int N_FIELDS = 10;
constexpr int ORDER_THREADS = 1024;
constexpr int MAX_K = 512;                // entries a tile (the wrapper's MAX_K)

__device__ __forceinline__ float clip01(float x) { return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x); }

__device__ __forceinline__ float tent(float c, int g) {
  const float w = 1.0f - fabsf(c - (float)g);
  return w < 0.0f ? 0.0f : w;
}

// -0 or NaN: the values a skipped step could change
__device__ __forceinline__ bool unsettled(float x) { return __float_as_uint(x) == 0x80000000u || x != x; }

// The pixel centre's sprite-local coordinates, as the step computes them.
__device__ __forceinline__ void local_uv(const float* f, float px, float py, float& lu, float& lv) {
  const float rx = px - f[0];
  const float ry = py - f[1];
  lu = (rx * f[5] - ry * f[4]) * f[6];
  lv = (ry * f[2] - rx * f[3]) * f[6];
}

// The tiles by entry count, fullest first (a counting sort; the order within
// a count is the atomics', and no result depends on it). One CTA.
__global__ void __launch_bounds__(ORDER_THREADS) blend_order_kernel(const int* __restrict__ cnt, int n_tiles, int k_cap,
                                                                   int* __restrict__ order) {
  __shared__ int s_at[MAX_K + 1];  // per count: its tiles, then where its next tile goes
  for (int b = threadIdx.x; b <= k_cap; b += ORDER_THREADS) s_at[b] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += ORDER_THREADS) atomicAdd(&s_at[k_cap - min(max(cnt[t], 0), k_cap)], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int b = 0; b <= k_cap; ++b) {
      const int m = s_at[b];
      s_at[b] = run;
      run += m;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles; t += ORDER_THREADS)
    order[atomicAdd(&s_at[k_cap - min(max(cnt[t], 0), k_cap)], 1)] = t;
}

template <bool kDepth>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) blend2d_kernel(
    const int* __restrict__ tile_list, const int* __restrict__ cnt, const float* __restrict__ fields,
    const float4* __restrict__ tex, const float* __restrict__ scene_depth, const int* __restrict__ order, int k_cap,
    int n_fld, int n_tex, int tx, int width, int height, float4* __restrict__ color_out, int* __restrict__ vid_out) {
  extern __shared__ float s_fld[];                        // [k_cap][n_fld]
  int* s_sid = reinterpret_cast<int*>(s_fld + k_cap * n_fld);  // [k_cap] the entry's plane

  const int t = order[blockIdx.x / STRIPS];
  const int strip = blockIdx.x % STRIPS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's pixel, in its warp's 8x4 block of the strip
  const int lx = (warp % BLOCKS_X) * BW + lane % BW;
  const int ly = strip * STRIP + (warp / BLOCKS_X) * BH + lane / BW;
  const int tx0 = (t % tx) * TILE, ty0 = (t / tx) * TILE;
  const bool img = tx0 + lx < width && ty0 + ly < height;
  const size_t o = (size_t)(ty0 + ly) * width + (tx0 + lx);
  const int n = cnt[t];
  if (n == 0) {  // uniform over the CTA
    if (img) {
      color_out[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      vid_out[o] = -1;
    }
    return;
  }
  const float* row = fields + (size_t)t * k_cap * n_fld;
  for (int i = tid; i < n * n_fld; i += THREADS) s_fld[i] = row[i];
  for (int i = tid; i < n; i += THREADS) {
    const int sid = tile_list[(size_t)t * k_cap + i];
    s_sid[i] = sid < 0 ? 0 : (sid >= n_tex ? n_tex - 1 : sid);
  }
  const float px = ((float)tx0 + (float)lx) + 0.5f;
  const float py = ((float)ty0 + (float)ly) + 0.5f;
  const float sdep = kDepth && img ? scene_depth[o] : 0.0f;
  __syncthreads();

  float cr = 0.0f, cg = 0.0f, cb = 0.0f, ca = 0.0f, vid = -1.0f;
  bool unsettled_warp = false;  // an image pixel of the warp holds -0 or NaN
  for (int k0 = 0; k0 < n; k0 += WIN) {
    float lu[WIN], lv[WIN], u[WIN], v[WIN];
    bool inside[WIN];
    bool need = false;
#pragma unroll
    for (int i = 0; i < WIN; ++i) {
      const float* f = s_fld + min(k0 + i, n - 1) * n_fld;  // past n: the last entry again, never applied
      local_uv(f, px, py, lu[i], lv[i]);
      inside[i] = lu[i] >= 0.0f && lu[i] <= 1.0f && lv[i] >= 0.0f && lv[i] <= 1.0f;
      u[i] = lu[i] + f[9] * (1.0f - 2.0f * lu[i]);
      v[i] = 1.0f - lv[i];
      need |= k0 + i < n && (inside[i] || u[i] != u[i] || v[i] != v[i]);
    }
    if (!__any_sync(0xffffffffu, img && need) && !unsettled_warp) continue;  // every step is the identity here
    // the window's taps, independent of one another
    float tr[WIN], tg[WIN], tb[WIN], ta[WIN];
#pragma unroll
    for (int i = 0; i < WIN; ++i) {
      const float4* plane = tex + (size_t)s_sid[min(k0 + i, n - 1)] * PLANE;
      const float fu = clip01(u[i]) * (float)(TEX - 1);
      const float fv = clip01(v[i]) * (float)(TEX - 1);
      int u0 = (int)fu, v0 = (int)fv;
      u0 = u0 < 0 ? 0 : (u0 > TEX - 2 ? TEX - 2 : u0);
      v0 = v0 < 0 ? 0 : (v0 > TEX - 2 ? TEX - 2 : v0);
      const float wu[2] = {tent(fu, u0), tent(fu, u0 + 1)};
      const float wv[2] = {tent(fv, v0), tent(fv, v0 + 1)};
#pragma unroll
      for (int dv = 0; dv < 2; ++dv) {
#pragma unroll
        for (int du = 0; du < 2; ++du) {
          const float4 tap = __ldg(plane + (v0 + dv) * TEX + (u0 + du));
          const float wt = wv[dv] * wu[du];
          if (dv == 0 && du == 0) {
            tr[i] = tap.x * wt;
            tg[i] = tap.y * wt;
            tb[i] = tap.z * wt;
            ta[i] = tap.w * wt;
          } else {
            tr[i] = tr[i] + tap.x * wt;
            tg[i] = tg[i] + tap.y * wt;
            tb[i] = tb[i] + tap.z * wt;
            ta[i] = ta[i] + tap.w * wt;
          }
        }
      }
    }
    // the steps, in list order
#pragma unroll
    for (int i = 0; i < WIN; ++i) {
      if (k0 + i >= n) break;
      const float* f = s_fld + (k0 + i) * n_fld;
      float a = ta[i] * (inside[i] ? 1.0f : 0.0f);
      a = a < f[7] ? 0.0f : a;
      if (kDepth) a = f[N_FIELDS] > sdep ? a : 0.0f;
      const float one_m = 1.0f - a;
      cr = cr * one_m + tr[i] * a;
      cg = cg * one_m + tg[i] * a;
      cb = cb * one_m + tb[i] * a;
      ca = ca * one_m + a;
      vid = a > 0.5f ? f[8] : vid;
    }
    unsettled_warp = __any_sync(0xffffffffu, img && (unsettled(cr) || unsettled(cg) || unsettled(cb) || unsettled(ca)));
  }
  if (img) {
    color_out[o] = make_float4(cr, cg, cb, ca);
    vid_out[o] = (int)vid;
  }
}

// The launch's dynamic shared memory, opted into past the default 48 KB.
template <bool kDepth>
cudaError_t prepare(int k_cap, int n_fld, size_t* smem) {
  *smem = (size_t)k_cap * (n_fld + 1) * sizeof(int);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(blend2d_kernel<kDepth>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <bool kDepth>
int info(int k_cap, int n_fld, int* out) {
  size_t smem;
  cudaError_t e = prepare<kDepth>(k_cap, n_fld, &smem);
  cudaFuncAttributes fa;
  int blocks = 0;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, blend2d_kernel<kDepth>);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, blend2d_kernel<kDepth>, THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + smem);
  out[2] = blocks;
  out[3] = (int)fa.localSizeBytes;
  return 0;
}

}  // namespace

// `order` is a workspace of n_tiles ints.
extern "C" int blend2d(const void* tile_list, const void* cnt, const void* fields, const void* tex,
                       const void* scene_depth, void* order, int n_tiles, int k_cap, int n_fld, int n_tex, int width,
                       int height, void* color, void* vid, void* stream) {
  const int tx = (width + TILE - 1) / TILE;
  const int ty = (height + TILE - 1) / TILE;
  const bool with_depth = scene_depth != nullptr;
  if (n_tiles != tx * ty || k_cap <= 0 || k_cap > MAX_K || n_tex <= 0 || n_fld != N_FIELDS + (with_depth ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t e = with_depth ? prepare<true>(k_cap, n_fld, &smem) : prepare<false>(k_cap, n_fld, &smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  blend_order_kernel<<<1, ORDER_THREADS, 0, s>>>((const int*)cnt, n_tiles, k_cap, (int*)order);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (with_depth) {
    blend2d_kernel<true><<<n_tiles * STRIPS, THREADS, smem, s>>>(
        (const int*)tile_list, (const int*)cnt, (const float*)fields, (const float4*)tex, (const float*)scene_depth,
        (const int*)order, k_cap, n_fld, n_tex, tx, width, height, (float4*)color, (int*)vid);
  } else {
    blend2d_kernel<false><<<n_tiles * STRIPS, THREADS, smem, s>>>(
        (const int*)tile_list, (const int*)cnt, (const float*)fields, (const float4*)tex, nullptr, (const int*)order,
        k_cap, n_fld, n_tex, tx, width, height, (float4*)color, (int*)vid);
  }
  return (int)cudaGetLastError();
}

// The launch's resources for `with_depth`, `k_cap` and `n_fld` into out[4]:
// registers a thread, shared memory a CTA (bytes), CTAs resident per SM, local
// memory a thread (bytes: spills).
extern "C" int blend2d_info(int with_depth, int k_cap, int n_fld, int* out) {
  if (k_cap <= 0) return (int)cudaErrorInvalidValue;
  return with_depth ? info<true>(k_cap, n_fld, out) : info<false>(k_cap, n_fld, out);
}
