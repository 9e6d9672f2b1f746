// Tile G-buffer raster for Hopper (sm_90a).
//
// Replaces the TPU kernel oxylus_tpu/ops/raster3d.py::_make_tile_kernel (:936),
// launched by rasterize_gbuffer_tiles (:1073). Plain PyTorch version:
// oxylus_tpu_torch/ops/raster3d.py::_raster_tiles_plain, which this file mirrors
// operation for operation (built with -fmad=false, so results are bit-identical).
//
// What it computes, per 64x64 tile (one thread block, 256 threads, 16 pixels
// each): the tile's triangle entries (from setup3d.bin_triangles_per_tile) in
// rounds of 64. Per round the 64 entries' 15 plane coefficients are staged in
// shared memory with the tile-local constant c' = (c + a*x0) + y0*b, each split
// into bf16 hi and lo parts (round to nearest even), and every pixel evaluates
// e = a_hi*xl + b_hi*yl + c'_hi + a_lo*xl + b_lo*yl + c'_lo (in that order) for
// the five planes (e0 e1 e2 zn wd) at local centres k + 0.5: the TPU kernel's
// hi/lo bf16 matmul, whose products are exact, so depths match the JAX
// package (a plain float32 evaluation changes many of them). It tests cover
// (all of e0, e1, e2, zn, wd - zn, wd - 1e-30 >= 0), keeps the max of the key
// (bits(zn * (1 / max(wd, 1e-30))) & ~127) | (127 - slot) with a strict > across
// rounds. Before each round the block-wide min of key & ~127 is compared with
// the suffix-max nearest depth of the remaining rounds (near_r): once every
// pixel of the tile, the ones past the image edge included, is nearer, the
// tile stops (the TPU kernel's early-out, kept exactly: it decides exact-depth
// ties). Then each pixel reads its winner's 64-float attribute row
// [a | b | c | consts] x 16 and writes lanes 0-7 = (a*px + b*py + c) / ss
// (ss = lane 8) and lanes 8-15 = the material constants, as bf16 (round to
// nearest even), with depth and vid = tile*256 + entry, straight into the
// cropped (H, W) images: no untile pass.
//
// What bounds it on the card: the phase-A plane evaluation, ~50 float
// operations per (entry, pixel) of every round run, against the float32 rate
// of the SMs (67 TFLOP/s); the outputs (40 B per pixel, 83 MB at 1080p) are
// the bytes bound. The TPU kernel's one-hot selection matmuls are MXU layout,
// not the algorithm: here each winner's attributes are one row read.
//
// What the design does about it: coefficients are loaded once per round into
// shared memory and read as broadcasts; each thread keeps its 16 pixels' keys
// and winners in registers across rounds; the early-out skips the rounds an
// occluded tile cannot change. Tiled shared-memory staging of several rounds,
// warp-level culling of covered entries and tensor-core plane evaluation are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int TILE = 64;
constexpr int PIX = TILE * TILE;
constexpr int ROUND = 64;
constexpr int THREADS = 256;
constexpr int PPT = PIX / THREADS;  // pixels per thread
constexpr int COMB_W = 83;          // attrB 64 | coeff 15 | tz | material | instance | packed id
constexpr int PLANE_OFF = 64;

// x rounded to bf16 (nearest even) and back: the hi part of the hi/lo split
__device__ __forceinline__ float bf16_hi(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__global__ void __launch_bounds__(THREADS) raster_tiles_kernel(
    const int* __restrict__ entries, const float* __restrict__ comb, const int* __restrict__ counts,
    const int* __restrict__ near_r, int k2, int tx, int width, int height,
    float* __restrict__ depth_out, int* __restrict__ vid_out, __nv_bfloat16* __restrict__ gb_out) {
  // per plane and entry: a, b, c' as bf16-valued hi and lo parts
  __shared__ float s_ah[5][ROUND], s_al[5][ROUND];
  __shared__ float s_bh[5][ROUND], s_bl[5][ROUND];
  __shared__ float s_ch[5][ROUND], s_cl[5][ROUND];
  __shared__ int s_warp_min[THREADS / 32];
  __shared__ int s_go;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int rounds = k2 / ROUND;
  const float x0 = (float)((t % tx) * TILE);
  const float y0 = (float)((t / tx) * TILE);
  // pixel p = tid + i*THREADS: local x is the same for all i, local y steps by 4
  const float xl = (float)(tid % TILE) + 0.5f;
  const int row0 = tid / TILE;

  int key[PPT];
  int vid[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    key[i] = 0;
    vid[i] = -1;
  }

  const int n = counts[t];
  const int rounds_n = (n + ROUND - 1) / ROUND;
  for (int r0 = 0;; ++r0) {
    // ---- early-out: block-wide min of the resolved depth bits ----
    int m = INT_MAX;
#pragma unroll
    for (int i = 0; i < PPT; ++i) m = min(m, key[i]);
    for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((tid & 31) == 0) s_warp_min[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
      int bm = s_warp_min[0];
      for (int w = 1; w < THREADS / 32; ++w) bm = min(bm, s_warp_min[w]);
      const int dmin = bm & ~127;
      s_go = (r0 < rounds_n) && (dmin < near_r[t * rounds + min(r0, rounds - 1)]);
    }
    __syncthreads();
    if (!s_go) break;

    // ---- stage the round's plane coefficients ----
    if (tid < ROUND) {
      const int e = entries[t * k2 + r0 * ROUND + tid];
      const float* row = comb + (size_t)(e < 0 ? 0 : e) * COMB_W + PLANE_OFF;
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        // a missing entry never covers: e0's constant is -1e30, everything else 0
        const float a = e >= 0 ? row[3 * p + 0] : 0.0f;
        const float b = e >= 0 ? row[3 * p + 1] : 0.0f;
        const float c = e >= 0 ? row[3 * p + 2] : (p == 0 ? -1e30f : 0.0f);
        const float cp = (c + x0 * a) + y0 * b;
        s_ah[p][tid] = bf16_hi(a);
        s_al[p][tid] = bf16_hi(a - bf16_hi(a));
        s_bh[p][tid] = bf16_hi(b);
        s_bl[p][tid] = bf16_hi(b - bf16_hi(b));
        s_ch[p][tid] = bf16_hi(cp);
        s_cl[p][tid] = bf16_hi(cp - bf16_hi(cp));
      }
    }
    __syncthreads();

    // ---- phase A: cover + packed reverse-Z key, strict max ----
    for (int s = 0; s < ROUND; ++s) {
      float ah[5], al[5], bh[5], bl[5], ch[5], cl[5];
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        ah[p] = s_ah[p][s];
        al[p] = s_al[p][s];
        bh[p] = s_bh[p][s];
        bl[p] = s_bl[p][s];
        ch[p] = s_ch[p][s];
        cl[p] = s_cl[p][s];
      }
      const int code = 127 - s;
      const int won = t * 256 + r0 * ROUND + s;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float yl = (float)(row0 + i * (THREADS / TILE)) + 0.5f;
        float e[5];
#pragma unroll
        for (int p = 0; p < 5; ++p)
          e[p] = ((((ah[p] * xl + bh[p] * yl) + ch[p]) + al[p] * xl) + bl[p] * yl) + cl[p];
        const float zn = e[3], wd = e[4];
        const bool cover = e[0] >= 0.0f && e[1] >= 0.0f && e[2] >= 0.0f && zn >= 0.0f &&
                           (wd - zn) >= 0.0f && (wd - 1e-30f) >= 0.0f;
        if (cover) {
          const float z = zn * (1.0f / fmaxf(wd, 1e-30f));
          const int zi = (__float_as_int(z) & ~127) | code;
          if (zi > key[i]) {
            key[i] = zi;
            vid[i] = won;
          }
        }
      }
    }
    __syncthreads();  // the next round overwrites the staged coefficients
  }

  // ---- phase B: the winner's G-buffer lanes, written cropped ----
  const int gx = (t % tx) * TILE + (tid % TILE);
  const float px = x0 + xl;
#pragma unroll 1
  for (int i = 0; i < PPT; ++i) {
    const int ly = row0 + i * (THREADS / TILE);
    const int gy = (t / tx) * TILE + ly;
    if (gx >= width || gy >= height) continue;
    const size_t o = (size_t)gy * width + gx;
    depth_out[o] = __int_as_float(key[i] & ~127);
    vid_out[o] = vid[i];
    __align__(16) __nv_bfloat16 lanes[16];
    if (vid[i] >= 0) {
      const int row = entries[t * k2 + (vid[i] - t * 256)];
      const float* A = comb + (size_t)row * COMB_W;
      const float py = y0 + ((float)ly + 0.5f);
      float v[9];
#pragma unroll
      for (int l = 0; l < 9; ++l) v[l] = (A[l] * px + A[16 + l] * py) + A[32 + l];
      const float rw = 1.0f / (fabsf(v[8]) > 1e-12f ? v[8] : 1.0f);
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        lanes[l] = __float2bfloat16_rn(v[l] * rw);
        lanes[8 + l] = __float2bfloat16_rn(A[48 + l]);
      }
    } else {
#pragma unroll
      for (int l = 0; l < 16; ++l) lanes[l] = __float2bfloat16_rn(0.0f);
    }
    uint4* dst = reinterpret_cast<uint4*>(gb_out + o * 16);
    const uint4* src = reinterpret_cast<const uint4*>(lanes);
    dst[0] = src[0];
    dst[1] = src[1];
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

extern "C" int raster_tiles(const void* entries, const void* comb, const void* counts, const void* near_r,
                            int n_tiles, int k2, int width, int height, void* depth, void* vid, void* gb,
                            void* stream) {
  const int tx = (width + TILE - 1) / TILE;
  const int ty = (height + TILE - 1) / TILE;
  if (k2 <= 0 || k2 % ROUND != 0 || k2 > 256 || n_tiles != tx * ty) return (int)cudaErrorInvalidValue;
  raster_tiles_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)entries, (const float*)comb, (const int*)counts, (const int*)near_r, k2, tx, width, height,
      (float*)depth, (int*)vid, (__nv_bfloat16*)gb);
  return (int)cudaGetLastError();
}
