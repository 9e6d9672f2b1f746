// Depth-only visbuffer raster for Hopper (sm_90a).
//
// Replaces the TPU kernel oxylus_tpu/ops/raster3d.py::_raster_kernel (:153),
// launched by rasterize_pallas (:228). Plain PyTorch version:
// oxylus_tpu_torch/ops/raster_depth.py::rasterize_depth_reference, which this
// file mirrors operation for operation (built with -fmad=false and IEEE
// division, so results are bit-identical).
//
// What it computes, per 64x64 tile (one thread block, 256 threads, 16 pixels
// each): the first cnt entries of the tile's meshlet list (cnt = the number of
// entries >= 0), each read as vm = max(entry, 0). Per entry the meshlet's 64
// triangles' five plane coefficients (e0 e1 e2 zn wd) x (a b c) are staged in
// shared memory with the tile-local constant c' = (c + x0*a) + y0*b, each of a,
// b and c' split into bf16 hi and lo parts (round to nearest even); every pixel
// evaluates e = a_hi*xl + b_hi*yl + c'_hi + a_lo*xl + b_lo*yl + c'_lo (in that
// order) at local centres k + 0.5 (the TPU kernel's bf16 hi/lo matmul, whose
// products are exact), tests cover (e0, e1, e2 >= 0, wd > 0, 0 <= zn <= wd),
// takes z = zn / wd, keeps the first slot with the largest z (-1 where nothing
// covers), and replaces the pixel where that z is strictly nearer than what
// it holds (depth starts at 0, vid at -1; vid = vm*256 + slot). Depth and vid
// are written straight into the cropped (H, W) images: no untile pass.
//
// What bounds it on the card: the plane evaluation, ~55 float operations per
// (entry, pixel, slot) of every live entry, against the float32 rate of the
// SMs (67 TFLOP/s); the bytes (one 3.75 KB coefficient block per referenced
// meshlet, 8 B per output pixel) are far below that.
//
// What the design does about it: each entry's coefficients are loaded once
// into shared memory and read as broadcasts; each thread keeps its 16 pixels'
// depth and vid in registers across the tile's entries. Several entries per
// stage, tensor-core plane evaluation and an early out for fully covered
// tiles are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

namespace {

constexpr int TILE = 64;
constexpr int PIX = TILE * TILE;
constexpr int THREADS = 256;
constexpr int PPT = PIX / THREADS;  // pixels per thread
constexpr int SLOTS = 64;           // triangles per meshlet
constexpr int PLANES = 5;
constexpr int COLS = PLANES * SLOTS;  // coefficient columns per row (a, b, c)

// x rounded to bf16 (nearest even) and back: the hi part of the hi/lo split
__device__ __forceinline__ float bf16_hi(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__global__ void __launch_bounds__(THREADS) raster_depth_kernel(
    const float* __restrict__ coeff, const int* __restrict__ tile_list, int k_cap, int tx, int width,
    int height, float* __restrict__ depth_out, int* __restrict__ vid_out) {
  // per plane and slot: a, b, c' as bf16-valued hi and lo parts
  __shared__ float s_ah[PLANES][SLOTS], s_al[PLANES][SLOTS];
  __shared__ float s_bh[PLANES][SLOTS], s_bl[PLANES][SLOTS];
  __shared__ float s_ch[PLANES][SLOTS], s_cl[PLANES][SLOTS];
  __shared__ int s_cnt;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int* row = tile_list + (size_t)t * k_cap;
  const float x0 = (float)((t % tx) * TILE);
  const float y0 = (float)((t / tx) * TILE);
  // pixel p = tid + i*THREADS: local x is the same for all i, local y steps by 4
  const float xl = (float)(tid % TILE) + 0.5f;
  const int row0 = tid / TILE;

  if (tid == 0) s_cnt = 0;
  __syncthreads();
  int mine = 0;
  for (int k = tid; k < k_cap; k += THREADS) mine += row[k] >= 0;
  if (mine) atomicAdd(&s_cnt, mine);
  __syncthreads();
  const int cnt = s_cnt;

  float depth[PPT];
  int vid[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    depth[i] = 0.0f;
    vid[i] = -1;
  }

  for (int k = 0; k < cnt; ++k) {
    const int vm = max(row[k], 0);
    // ---- stage the entry's plane coefficients ----
    const float* blk = coeff + (size_t)vm * 3 * COLS;
    for (int q = tid; q < COLS; q += THREADS) {
      const int p = q / SLOTS, s = q % SLOTS;
      const float a = blk[q], b = blk[COLS + q], c = blk[2 * COLS + q];
      const float cp = (c + x0 * a) + y0 * b;
      s_ah[p][s] = bf16_hi(a);
      s_al[p][s] = bf16_hi(a - bf16_hi(a));
      s_bh[p][s] = bf16_hi(b);
      s_bl[p][s] = bf16_hi(b - bf16_hi(b));
      s_ch[p][s] = bf16_hi(cp);
      s_cl[p][s] = bf16_hi(cp - bf16_hi(cp));
    }
    __syncthreads();

    // ---- per pixel: the entry's first nearest covering slot ----
    float best[PPT];
    int arg[PPT];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      best[i] = -INFINITY;
      arg[i] = 0;
    }
    for (int s = 0; s < SLOTS; ++s) {
      float ah[PLANES], al[PLANES], bh[PLANES], bl[PLANES], ch[PLANES], cl[PLANES];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        ah[p] = s_ah[p][s];
        al[p] = s_al[p][s];
        bh[p] = s_bh[p][s];
        bl[p] = s_bl[p][s];
        ch[p] = s_ch[p][s];
        cl[p] = s_cl[p][s];
      }
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float yl = (float)(row0 + i * (THREADS / TILE)) + 0.5f;
        float e[PLANES];
#pragma unroll
        for (int p = 0; p < PLANES; ++p)
          e[p] = ((((ah[p] * xl + bh[p] * yl) + ch[p]) + al[p] * xl) + bl[p] * yl) + cl[p];
        const float zn = e[3], wd = e[4];
        const bool cover = e[0] >= 0.0f && e[1] >= 0.0f && e[2] >= 0.0f && wd > 0.0f && zn >= 0.0f && zn <= wd;
        const float zm = cover ? zn / (wd > 0.0f ? wd : 1.0f) : -1.0f;
        if (zm > best[i]) {  // strict: the first slot holding the max wins
          best[i] = zm;
          arg[i] = s;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      if (best[i] > depth[i]) {
        depth[i] = best[i];
        vid[i] = vm * 256 + arg[i];
      }
    }
    __syncthreads();  // the next entry overwrites the staged coefficients
  }

  const int gx = (t % tx) * TILE + (tid % TILE);
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int gy = (t / tx) * TILE + row0 + i * (THREADS / TILE);
    if (gx >= width || gy >= height) continue;
    const size_t o = (size_t)gy * width + gx;
    depth_out[o] = depth[i];
    vid_out[o] = vid[i];
  }
}

}  // namespace

extern "C" int raster_depth(const void* coeff, const void* tile_list, int n_vm, int n_tiles, int k_cap, int width,
                            int height, void* depth, void* vid, void* stream) {
  const int tx = (width + TILE - 1) / TILE;
  const int ty = (height + TILE - 1) / TILE;
  if (n_vm <= 0 || k_cap <= 0 || n_tiles != tx * ty) return (int)cudaErrorInvalidValue;
  raster_depth_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)coeff, (const int*)tile_list, k_cap, tx, width, height, (float*)depth, (int*)vid);
  return (int)cudaGetLastError();
}
