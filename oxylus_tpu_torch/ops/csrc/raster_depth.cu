// Depth-only visbuffer raster for Hopper (sm_90a).
//
// Replaces the TPU kernel oxylus_tpu/ops/raster3d.py::_raster_kernel (:153),
// launched by rasterize_pallas (:228). Plain PyTorch version:
// oxylus_tpu_torch/ops/raster_depth.py::rasterize_depth_reference, whose
// per-pixel arithmetic this file repeats operation for operation (built with
// -fmad=false and IEEE division, so results are bit-identical).
//
// What it computes, per 64x64 tile: the first cnt entries of the tile's
// meshlet list (cnt = the number of entries >= 0), each read as
// vm = max(entry, 0). Per entry the meshlet's 64 triangles' five plane
// coefficients (e0 e1 e2 zn wd) x (a b c) are staged with the tile-local
// constant c' = (c + x0*a) + y0*b, each of a, b and c' split into bf16 hi and
// lo parts (round to nearest even); a pixel evaluates
// e = a_hi*xl + b_hi*yl + c'_hi + a_lo*xl + b_lo*yl + c'_lo (in that order) at
// local centres k + 0.5 (the TPU kernel's bf16 hi/lo matmul, whose products
// are exact), tests cover (e0, e1, e2 >= 0, wd > 0, 0 <= zn <= wd) and takes
// z = zn / wd. The sequential rule keeps, per pixel, the largest z > 0 over all
// (entry k, slot s) and the first (k, s) in lexicographic order that reaches
// it (depth 0 and vid -1 where none does; vid = vm*256 + s).
//
// What bounds it on the card: counted on what a call's data needs, the bytes
// (8 B per output pixel, one 3.75 KB coefficient block per referenced
// meshlet): the least evaluation an exact design needs, ~52 float operations
// at each covered (slot, pixel), takes less time at the SMs' float32 rate (67
// TFLOP/s). This kernel's time is the evaluation it does at every (slot,
// pixel) the reject keeps, and each CTA's chain of entries.
//
// What the design does about it (the first port ran one CTA per tile over all
// its entries and all 64 slots at all 4096 pixels, so the fullest tile set a
// level's time while most SMs idled):
// - Spread: one CTA of 256 threads per (tile, 32x32 sub-tile, chunk of
//   `chunk` entries); each warp takes a 16x8 block of the sub-tile, 4 pixels a
//   lane. A tile's 4 sub-tiles and its entry chunks run on as many CTAs; CTAs
//   of chunks past the tile's cnt exit at once.
// - Exact ordered merge: a CTA keeps, per pixel, the sequential rule's winner
//   over its own entries (strict replacement in ascending (k, s) from z = 0),
//   packs it as key = (float_bits(z) << 32) | (0xFFFFFFFF - (k*64 + s)) where
//   z > 0, and takes an unsigned 64-bit atomicMax into a per-pixel key buffer
//   (zeroed first). z lies in (0, 1], so the bit order is the value order, and
//   among equal z the smallest (k, s) has the largest low word: the maximum key
//   is the sequential rule's result, whatever order the CTAs finish in. A
//   decode pass writes depth = bits, vid = max(tile_list[t, k], 0)*256 + s, and
//   depth 0, vid -1 where the key is 0.
// - Conservative reject per (sub-tile, slot), computed once per entry while its
//   coefficients are staged: a slot is skipped only when one of its planes
//   shows that it covers no pixel centre of the sub-tile (plane_reject.cuh);
//   each warp then tests the slots left at its own 16x8 block's corners the
//   same way. A skipped slot gives z = -1 at every pixel there, which never
//   wins. The division z = zn / wd runs only where a slot covers.
// - Staging: the next entry's coefficient block is copied into shared memory
//   with cp.async while the current one is evaluated (two buffers).

#include <cuda_runtime.h>
#include <cstdint>

#include "plane_reject.cuh"

namespace {

constexpr int TILE = 64;
constexpr int SUB = 32;                                // sub-tile side
constexpr int SUBS_X = TILE / SUB;
constexpr int SUBS = SUBS_X * SUBS_X;                  // sub-tiles per tile
constexpr int THREADS = 256;
constexpr int BW = 16, BH = 8;                         // a warp's block of the sub-tile
constexpr int BLOCKS_X = SUB / BW;
static_assert(BLOCKS_X * (SUB / BH) == THREADS / 32, "one block per warp");
constexpr int ROW_STEP = 32 / BW;                      // rows between a lane's pixels
constexpr int PPT = BW * BH / 32;                      // pixels per thread
constexpr int SLOTS = 64;                              // triangles per meshlet
constexpr int PLANES = 5;
constexpr int COLS = PLANES * SLOTS;                   // coefficient columns per row (a, b, c)
constexpr int BLK = 3 * COLS;                          // floats per meshlet block
constexpr int BLK_CHUNKS = BLK * 4 / 16;               // 16-byte cp.async pieces per block
static_assert(COLS % 32 == 0 && (COLS - THREADS) % 32 == 0, "the stage loop's ballots need whole warps");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void prefetch_block(float* dst, const float* coeff, int vm, int tid) {
  const float* src = coeff + (size_t)vm * BLK;
  for (int i = tid; i < BLK_CHUNKS; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS, 4) raster_depth_chunks(
    const float* __restrict__ coeff, const int* __restrict__ tile_list, int k_cap, int chunk, int tx, int width,
    int height, unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float s_raw[2][BLK];  // the entry's (a, b, c) rows, double-buffered
  // per column (plane-major, p*64 + s): a, b, c' as bf16-valued hi and lo parts
  __shared__ float s_ah[COLS], s_al[COLS], s_bh[COLS], s_bl[COLS], s_ch[COLS], s_cl[COLS];
  __shared__ float s_mg[COLS];            // minus each column's reject margin
  __shared__ unsigned s_dead[COLS / 32];  // the sub-tile's reject bits, word w: plane w/2, slots 32*(w%2) + lane

  const int t = blockIdx.x / SUBS, q = blockIdx.x % SUBS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* row = tile_list + (size_t)t * k_cap;

  // cnt: every warp counts the row's entries >= 0 itself (no barrier)
  int cnt = 0;
  for (int k0 = 0; k0 < k_cap; k0 += 32) {
    const int k = k0 + lane;
    cnt += __popc(__ballot_sync(0xffffffffu, k < k_cap && row[k] >= 0));
  }
  const int k_begin = blockIdx.y * chunk;
  if (k_begin >= cnt) return;  // uniform over the CTA
  const int k_end = min(cnt, k_begin + chunk);

  const float x0 = (float)((t % tx) * TILE), y0 = (float)((t / tx) * TILE);
  const int sx0 = (q % SUBS_X) * SUB, sy0 = (q / SUBS_X) * SUB;
  // the sub-tile's and the warp's block's corner centres, in tile-local coordinates
  const float cx0 = (float)sx0 + 0.5f, cx1 = (float)(sx0 + SUB) - 0.5f;
  const float cy0 = (float)sy0 + 0.5f, cy1 = (float)(sy0 + SUB) - 0.5f;
  const int bx0 = sx0 + (warp % BLOCKS_X) * BW, by0 = sy0 + (warp / BLOCKS_X) * BH;
  const float wx0 = (float)bx0 + 0.5f, wx1 = (float)(bx0 + BW) - 0.5f;
  const float wy0 = (float)by0 + 0.5f, wy1 = (float)(by0 + BH) - 0.5f;
  // pixel i of this lane: local x fixed, local y steps by ROW_STEP
  const float xl = (float)(bx0 + lane % BW) + 0.5f;
  const int row0 = by0 + lane / BW;

  float best[PPT];
  unsigned arg[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    best[i] = 0.0f;  // only z > 0 replaces, as the sequential rule's depth starts at 0
    arg[i] = 0u;
  }

  prefetch_block(s_raw[0], coeff, max(row[k_begin], 0), tid);
  for (int k = k_begin; k < k_end; ++k) {
    const int buf = (k - k_begin) & 1;
    cp_async_wait_all();
    __syncthreads();  // entry k's block has landed; every thread is done with entry k-1's stage
    if (k + 1 < k_end) prefetch_block(s_raw[buf ^ 1], coeff, max(row[k + 1], 0), tid);

    // ---- stage entry k: tile-local constant, hi/lo split, reject bits ----
    const float* raw = s_raw[buf];
    for (int col = tid; col < COLS; col += THREADS) {
      const float a = raw[col], b = raw[COLS + col], c = raw[2 * COLS + col];
      const float cp = (c + x0 * a) + y0 * b;
      const float ah = bf16_hi(a), al = bf16_hi(a - ah);
      const float bh = bf16_hi(b), bl = bf16_hi(b - bh);
      const float ch = bf16_hi(cp), cl = bf16_hi(cp - ch);
      s_ah[col] = ah; s_al[col] = al;
      s_bh[col] = bh; s_bl[col] = bl;
      s_ch[col] = ch; s_cl[col] = cl;
      const float mg = -reject_margin(ah, al, bh, bl, ch, cl);
      s_mg[col] = mg;
      const bool dead = plane_dead(col >= 4 * SLOTS, mg, ah, bh, ch, al, bl, cl, cx0, cx1, cy0, cy1);
      const unsigned bits = __ballot_sync(0xffffffffu, dead);
      if (lane == 0) s_dead[col >> 5] = bits;
    }
    __syncthreads();

    // ---- the warp's block: lane j tests slots j and j + 32 if the sub-tile kept them ----
    unsigned long long dead = 0ull;
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
      dead |= (unsigned long long)s_dead[2 * p] | ((unsigned long long)s_dead[2 * p + 1] << 32);
    unsigned long long live = 0ull;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = half * 32 + lane;
      bool keep = !((dead >> s) & 1ull);
      for (int p = 0; p < PLANES && keep; ++p) {
        const int c = p * SLOTS + s;
        keep = !plane_dead(p == PLANES - 1, s_mg[c], s_ah[c], s_bh[c], s_ch[c], s_al[c], s_bl[c], s_cl[c], wx0, wx1,
                           wy0, wy1);
      }
      live |= (unsigned long long)__ballot_sync(0xffffffffu, keep) << (32 * half);
    }

    // ---- evaluate the slots no plane rejects, in ascending slot order ----
    // Plane by plane, so a lane holds one plane's six parts, its pixels' cover
    // flags and their zn and wd, not all five planes at once (64 registers:
    // 4 CTAs, 32 warps a SM). Each plane value is the same sum as before.
    while (live) {
      const int s = __ffsll((long long)live) - 1;
      live &= live - 1;
      bool cover[PPT];
      float zn[PPT], wd[PPT];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const int c = p * SLOTS + s;
        const float ah = s_ah[c], al = s_al[c], bh = s_bh[c], bl = s_bl[c], ch = s_ch[c], cl = s_cl[c];
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float e = plane(ah, bh, ch, al, bl, cl, xl, (float)(row0 + i * ROW_STEP) + 0.5f);
          if (p == 0) cover[i] = e >= 0.0f;
          else if (p < 3) cover[i] = cover[i] && e >= 0.0f;
          else if (p == 3) zn[i] = e;
          else wd[i] = e;
        }
      }
      const unsigned idx = (unsigned)(k * SLOTS + s);
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        // e0, e1, e2 >= 0, wd > 0, 0 <= zn <= wd; elsewhere z = -1, which never replaces
        if (cover[i] && wd[i] > 0.0f && zn[i] >= 0.0f && zn[i] <= wd[i]) {
          const float zm = zn[i] / wd[i];
          if (zm > best[i]) {  // strict: the first (k, s) holding the max wins
            best[i] = zm;
            arg[i] = idx;
          }
        }
      }
    }
  }

  const int gx = (int)x0 + bx0 + lane % BW;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int gy = (int)y0 + row0 + i * ROW_STEP;
    if (gx >= width || gy >= height || !(best[i] > 0.0f)) continue;
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(best[i]) << 32) | (unsigned long long)(0xFFFFFFFFu - arg[i]);
    atomicMax(keys + (size_t)gy * width + gx, key);
  }
}

__global__ void raster_depth_decode(const unsigned long long* __restrict__ keys, const int* __restrict__ tile_list,
                                    int k_cap, int tx, int width, int height, float* __restrict__ depth_out,
                                    int* __restrict__ vid_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= width * height) return;
  const unsigned long long key = keys[o];
  float depth = 0.0f;
  int vid = -1;
  if (key != 0ull) {
    const unsigned idx = 0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull);
    const int gx = o % width, gy = o / width;
    const int t = (gy / TILE) * tx + gx / TILE;
    const int vm = max(tile_list[(size_t)t * k_cap + idx / SLOTS], 0);
    depth = __uint_as_float((unsigned)(key >> 32));
    vid = vm * 256 + (int)(idx % SLOTS);
  }
  depth_out[o] = depth;
  vid_out[o] = vid;
}

}  // namespace

// keys: width*height unsigned 64-bit words of scratch (zeroed here).
extern "C" int raster_depth(const void* coeff, const void* tile_list, int n_vm, int n_tiles, int k_cap, int width,
                            int height, int chunk, void* keys, void* depth, void* vid, void* stream) {
  const int tx = (width + TILE - 1) / TILE;
  const int ty = (height + TILE - 1) / TILE;
  if (n_vm <= 0 || k_cap <= 0 || chunk <= 0 || width <= 0 || height <= 0 || n_tiles != tx * ty)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n_pix = (size_t)width * height;
  cudaError_t e = cudaMemsetAsync(keys, 0, n_pix * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(n_tiles * SUBS), (unsigned)((k_cap + chunk - 1) / chunk));
  raster_depth_chunks<<<grid, THREADS, 0, s>>>((const float*)coeff, (const int*)tile_list, k_cap, chunk, tx, width,
                                               height, (unsigned long long*)keys);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  raster_depth_decode<<<(unsigned)((n_pix + 255) / 256), 256, 0, s>>>(
      (const unsigned long long*)keys, (const int*)tile_list, k_cap, tx, width, height, (float*)depth, (int*)vid);
  return (int)cudaGetLastError();
}
