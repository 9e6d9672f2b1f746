// Group-hit G-buffer raster for Hopper (sm_90a).
//
// Replaces the TPU kernels oxylus_tpu/ops/raster3d.py::_make_gbuffer_kernel
// (:355, streamed attributes) and _make_gbuffer_kernel_resident (:544,
// resident bf16 hi/lo attributes), both launched by rasterize_gbuffer_pallas
// (:692). The two differ only in how phase B selects the winner's attribute
// coefficients; this kernel reads the winner's float32 row, which is what the
// streamed kernel computes (hi + the float32 rest). Plain PyTorch version:
// oxylus_tpu_torch/ops/raster_groups.py::_raster_groups_plain, which this file
// mirrors operation for operation (built with -fmad=false, so results are
// bit-identical).
//
// What it computes, per tile of TILE x TILE pixels (TILE 32 or 64; one thread
// block of 256 threads, TILE*TILE/256 pixels each): the tile's list of dense
// triangle groups, k = 0, 1, ... while k < cnt (entries >= 0 in the row) and
// the block-wide min of the pixels' keys with the low 7 bits cleared (all
// TILE^2 pixels, those past the image edge included) is below the k-th near
// bound (int32 bits of a float depth). Per group g = max(list[k], 0) its R
// slots' 15 plane coefficients are staged in shared memory with the tile-local
// constant c' = (c + x0*a) + y0*b, each split into bf16 hi and lo parts
// (round to nearest even); every pixel evaluates, for the five planes
// (e0 e1 e2 zn wd), e = a_hi*xl + b_hi*yl + c'_hi + a_lo*xl + b_lo*yl + c'_lo in
// that order at local centres k + 0.5, tests cover (e0, e1, e2, zn, wd - zn,
// wd - 1e-30 all >= 0: the TPU kernel's min-tree, NaN included), and keeps
// the max of the key (bits(zn * (1 / max(wd, 1e-30))) & ~127) | (127 - slot),
// replacing the pixel's key only where strictly larger: slots in order within
// a group and groups in list order give the TPU kernel's winner (the max over
// a group's slots, then a strict > across groups). vid = g*256 + slot. Phase
// B: each hit pixel reads its winner's row g*R + slot and writes lanes 0-7 =
// ((a*px + b*py) + c) * (1 / ss) (ss = lane 8, where |ss| > 1e-12, else 1)
// and lanes 8-15 = the material constants, as bf16 (round to nearest even),
// with depth = key & ~127, straight into the cropped (H, W) images. Planes and
// attributes use the global tile id t + tile_base (a band of a sharded image);
// the outputs are written at local tile t.
//
// What bounds it on the card: the phase-A plane evaluation, ~53 float
// operations per (slot, pixel) of every group walked, against the SMs'
// float32 rate (67 TFLOP/s); the outputs (40 B per pixel, 83 MB at 1080p) are
// the bytes bound. The TPU kernels' one-hot selection matmuls (and the DMA
// double buffer of the streamed one) are TPU layout, not the algorithm: here
// the winner's attributes are one row read.
//
// What the design does about it: each group's coefficients are split once per
// (tile, group) into shared memory and read as broadcasts; each thread keeps
// its pixels' keys and winners in registers across the walk; the early-out
// stops a tile once nothing behind can win. Skipping dead slots, splitting a
// tile's groups over warps with an ordered merge, and tensor-core plane
// evaluation are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SLOTS = 128;
constexpr int PLANE_OFF = 64;  // the 15 plane coefficients in a row, after attrB (64)

__device__ __forceinline__ float bf16_hi(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <int TILE>
__global__ void __launch_bounds__(THREADS) raster_groups_kernel(
    const float* __restrict__ rows, int row_w, const int* __restrict__ tile_list, const int* __restrict__ near,
    int k_cap, int n_slots, int tx, int tile_base, int width, int height, float* __restrict__ depth_out,
    int* __restrict__ vid_out, __nv_bfloat16* __restrict__ gb_out) {
  constexpr int PIX = TILE * TILE;
  constexpr int PPT = PIX / THREADS;       // pixels per thread
  constexpr int ROW_STEP = THREADS / TILE;  // local rows between a thread's pixels
  // per plane and slot: a, b, c' as bf16-valued hi and lo parts
  __shared__ float s_ah[5][MAX_SLOTS], s_al[5][MAX_SLOTS];
  __shared__ float s_bh[5][MAX_SLOTS], s_bl[5][MAX_SLOTS];
  __shared__ float s_ch[5][MAX_SLOTS], s_cl[5][MAX_SLOTS];
  __shared__ int s_warp_min[THREADS / 32];
  __shared__ int s_group;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tg = t + tile_base;
  const float x0 = (float)((tg % tx) * TILE);
  const float y0 = (float)((tg / tx) * TILE);
  // pixel p = tid + i*THREADS: local x is the same for all i, local y steps by ROW_STEP
  const float xl = (float)(tid % TILE) + 0.5f;
  const int row0 = tid / TILE;
  const int* list = tile_list + (size_t)t * k_cap;

  int cnt = 0;  // entries >= 0 in the tile's row
  for (int j0 = 0; j0 < k_cap; j0 += THREADS) cnt += __syncthreads_count(j0 + tid < k_cap && list[j0 + tid] >= 0);

  int key[PPT];
  int vid[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    key[i] = 0;
    vid[i] = -1;
  }

  for (int k = 0; k < cnt; ++k) {
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
      s_group = ((bm & ~127) < near[(size_t)t * k_cap + k]) ? max(list[k], 0) : -1;
    }
    __syncthreads();
    const int g = s_group;
    if (g < 0) break;

    // ---- stage the group's plane coefficients ----
    if (tid < n_slots) {
      const float* row = rows + ((size_t)g * n_slots + tid) * row_w + PLANE_OFF;
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        const float a = row[3 * p + 0];
        const float b = row[3 * p + 1];
        const float c = row[3 * p + 2];
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
    for (int s = 0; s < n_slots; ++s) {
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
      const int won = g * 256 + s;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float yl = (float)(row0 + i * ROW_STEP) + 0.5f;
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
    __syncthreads();  // the next group overwrites the staged coefficients
  }

  // ---- phase B: the winner's G-buffer lanes, written cropped ----
  const int gx = (t % tx) * TILE + (tid % TILE);
  const float px = x0 + xl;
#pragma unroll 1
  for (int i = 0; i < PPT; ++i) {
    const int ly = row0 + i * ROW_STEP;
    const int gy = (t / tx) * TILE + ly;
    if (gx >= width || gy >= height) continue;
    const size_t o = (size_t)gy * width + gx;
    depth_out[o] = __int_as_float(key[i] & ~127);
    vid_out[o] = vid[i];
    __align__(16) __nv_bfloat16 lanes[16];
    if (vid[i] >= 0) {
      const float* A = rows + ((size_t)(vid[i] >> 8) * n_slots + (vid[i] & 255)) * row_w;
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

extern "C" int raster_groups(const void* rows, int row_w, const void* tile_list, const void* near, int n_tiles,
                             int k_cap, int n_slots, int tile, int tile_base, int width, int height, void* depth,
                             void* vid, void* gb, void* stream) {
  if ((tile != 32 && tile != 64) || n_slots <= 0 || n_slots > MAX_SLOTS || row_w < PLANE_OFF + 15 || k_cap <= 0 ||
      tile_base < 0)
    return (int)cudaErrorInvalidValue;
  const int tx = (width + tile - 1) / tile;
  const int ty = (height + tile - 1) / tile;
  if (n_tiles != tx * ty) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return (int)cudaSuccess;
  auto* r = (const float*)rows;
  auto* tl = (const int*)tile_list;
  auto* nr = (const int*)near;
  auto* d = (float*)depth;
  auto* v = (int*)vid;
  auto* g = (__nv_bfloat16*)gb;
  if (tile == 64)
    raster_groups_kernel<64><<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        r, row_w, tl, nr, k_cap, n_slots, tx, tile_base, width, height, d, v, g);
  else
    raster_groups_kernel<32><<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        r, row_w, tl, nr, k_cap, n_slots, tx, tile_base, width, height, d, v, g);
  return (int)cudaGetLastError();
}
