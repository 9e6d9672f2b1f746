// Tile G-buffer raster for Hopper (sm_90a).
//
// Replaces the TPU kernel oxylus_tpu/ops/raster3d.py::_make_tile_kernel (:936),
// launched by rasterize_gbuffer_tiles (:1073). Plain PyTorch version:
// oxylus_tpu_torch/ops/raster3d.py::_raster_tiles_plain, whose per-pixel
// arithmetic this file repeats operation for operation (built with
// -fmad=false, so results are bit-identical).
//
// What it computes, per tile of TILE x TILE pixels (TILE 16, 32 or 64): the
// tile's triangle entries (from setup3d.bin_triangles_per_tile) in rounds of
// 64. Per round the 64 entries' 15 plane coefficients are staged with the
// tile-local constant
// c' = (c + a*x0) + y0*b, each split into bf16 hi and lo parts (round to
// nearest even), and a pixel evaluates
// e = a_hi*xl + b_hi*yl + c'_hi + a_lo*xl + b_lo*yl + c'_lo (in that order) for
// the five planes (e0 e1 e2 zn wd) at local centres k + 0.5: the TPU kernel's
// hi/lo bf16 matmul, whose products are exact, so depths match the JAX
// package. It tests cover (all of e0, e1, e2, zn, wd - zn, wd - 1e-30 >= 0) and
// keeps the max of the key (bits(zn * (1 / max(wd, 1e-30))) & ~127) | (127 - slot)
// with a strict > across rounds. Before each round the tile-wide min of
// key & ~127 is compared with the suffix-max nearest depth of the remaining
// rounds (near_r): once every pixel of the tile, the ones past the image edge
// included, is nearer, the tile stops (the TPU kernel's early-out, kept
// exactly: it decides exact-depth ties, so it stays tile-wide and in round
// order). Then each pixel reads its winner's 64-float attribute row
// [a | b | c | consts] x 16 and writes lanes 0-7 = (a*px + b*py + c) / ss
// (ss = lane 8) and lanes 8-15 = the material constants, as bf16 (round to
// nearest even), with depth and vid = tg*256 + entry, straight into the
// cropped (H, W) images. tg = t + tile_base is the image's tile id of the
// input's tile t (a band of a larger image): x0, y0, px, py and vid use it,
// the outputs are written at tile t.
//
// What bounds it on the card: the outputs' bytes (40 B per pixel, 83 MB at
// 1080p, at every tile edge). The least evaluation an exact design needs, the
// planes at each covered (entry, pixel) pair and one region test per (entry,
// CTA), is far below that at the SMs' float32 rate (67 TFLOP/s).
//
// What the design does about it (the first port ran one CTA per 64^2 tile and
// evaluated every slot of every round at all 4096 pixels, 16 a thread):
// - A 64^2 tile is a thread-block cluster of 4 CTAs, one per 32x32 sub-tile,
//   256 threads each; each warp takes a 16x8 block of the sub-tile, 4 pixels a
//   lane. Rounds stay sequential in the cluster: before each round after the
//   first, every CTA publishes its sub-tile's min key in its shared memory,
//   the cluster synchronises, and every CTA reads the four values through
//   distributed shared memory and takes the same decision. The value is
//   double-buffered by round parity: a CTA can reach round r + 2's write only
//   after round r + 1's cluster barrier, which every neighbour reaches after
//   its round-r read. Every pixel sees the same (round, slot) comparisons as
//   in the one-CTA kernel, so no merge is needed.
// - A 32^2 tile is one such CTA alone, and a 16^2 tile one CTA of 64 threads
//   (two warps, each a 16x8 block): no cluster, and the tile-wide min behind
//   the early-out is the CTA's own.
// - Conservative reject per (CTA square, slot), computed once per round while
//   the coefficients are staged, then per (warp block, slot): a slot is
//   skipped only where one of its planes, at the region's four corner
//   centres, proves it covers no pixel centre there (plane_reject.cuh, with
//   the terms bounded over the tile, span = TILE - 0.5). The depth raster's
//   bound carries over: both kernels evaluate the same hi/lo
//   sum at the same tile-local centres (k + 0.5 <= TILE - 0.5), and cover here
//   needs e0, e1, e2, zn >= 0 and wd - 1e-30 >= 0, which wd <= -margin at
//   every centre (so wd < 0) rules out as wd > 0 does there. A missing entry
//   (e0 constant -1e30) and a dead slot fail on e0. A skipped slot covers
//   none of the pixels it is skipped for, so key and vid never change by it.
// - Phase B: the keys and vids go through shared memory so that each warp
//   writes 32 pixels of whole rows of the CTA's square (one 32-px row, or two
//   16-px rows): depth and vid stores of whole rows, and the 32 pixels' 1 KB
//   of G-buffer lanes staged in shared memory and written as 512-byte row
//   segments. The tile's entry list is read from shared memory, and a
//   thread's 4 rows are unrolled so their loads overlap.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <climits>
#include <cstdint>

#include "plane_reject.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS_MAX = 256;
constexpr int BW = 16, BH = 8;            // a warp's block of the CTA's square
constexpr int ROW_STEP = 32 / BW;         // rows between a lane's pixels
constexpr int PPT = BW * BH / 32;         // pixels per thread
constexpr int ROUND = 64;
constexpr int PLANES = 5;
constexpr int COLS = PLANES * ROUND;      // staged columns per round, plane-major (p*64 + slot)
constexpr int MAX_K2 = 256;
constexpr int COMB_W = 83;                // attrB 64 | coeff 15 | tz | material | instance | packed id
constexpr int PLANE_OFF = 64;

// The launch geometry of a tile edge: a CTA rasters a SUB x SUB square (a
// 32^2 sub-tile of a 64^2 tile's cluster, else the whole tile), a warp per
// 16x8 block of it.
template <int TILE>
struct Geometry {
  static constexpr int SUB = TILE < 32 ? TILE : 32;
  static constexpr int SUBS_X = TILE / SUB;
  static constexpr int CLUSTER = SUBS_X * SUBS_X;  // CTAs per tile
  static constexpr int BLOCKS_X = SUB / BW;
  static constexpr int WARPS = SUB * SUB / (BW * BH);
  static constexpr int THREADS = WARPS * 32;
  static constexpr int ROWS_PER_PASS = 32 / SUB;   // phase B: rows of the square a warp's 32 pixels span
  static constexpr int B_PASSES = SUB * SUB / THREADS;
  static_assert(BLOCKS_X * (SUB / BH) == WARPS, "one block per warp");
  static_assert(COLS % 32 == 0 && (COLS - THREADS) % 32 == 0, "the stage loop's ballots need whole warps");
  static_assert(SUB * ROWS_PER_PASS == 32, "phase B: a warp's 32 pixels are whole rows of the square");
  static_assert(THREADS <= THREADS_MAX, "");
};

template <int TILE>
__global__ void __launch_bounds__(Geometry<TILE>::THREADS) raster_tiles_kernel(
    const int* __restrict__ entries, const float* __restrict__ comb, const int* __restrict__ counts,
    const int* __restrict__ near_r, int k2, int tx, int tile_base, int width, int height,
    float* __restrict__ depth_out, int* __restrict__ vid_out, __nv_bfloat16* __restrict__ gb_out) {
  using G = Geometry<TILE>;
  constexpr int SUB = G::SUB, SUBS_X = G::SUBS_X, CLUSTER = G::CLUSTER, THREADS = G::THREADS, WARPS = G::WARPS;
  constexpr int BLOCKS_X = G::BLOCKS_X;
  constexpr float SPAN = TILE - 0.5f;      // the reject margin's bound on the tile-local centres
  // per column (p*64 + slot): a, b, c' as bf16-valued hi and lo parts, minus the reject margin
  __shared__ float s_ah[COLS], s_al[COLS], s_bh[COLS], s_bl[COLS], s_ch[COLS], s_cl[COLS], s_mg[COLS];
  __shared__ unsigned s_dead[COLS / 32];  // the square's reject bits, word w: plane w/2, slots 32*(w%2) + lane
  __shared__ int s_row[MAX_K2];           // the tile's entries
  __shared__ int s_warp_min[WARPS];
  __shared__ int s_min[2];                // this sub-tile's min key, by round parity; read by the cluster
  __shared__ int s_go;
  __shared__ int s_key[SUB * SUB], s_vid[SUB * SUB];  // phase B's hand-over
  __shared__ __align__(16) __nv_bfloat16 s_gb[WARPS][32 * 16];  // a warp's 32 pixels of G-buffer lanes

  const int t = blockIdx.x / CLUSTER;
  int q = 0;
  if constexpr (CLUSTER > 1) q = (int)cg::this_cluster().block_rank();
  const int tg = t + tile_base;  // the image's tile: coordinates and vid
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rounds = k2 / ROUND;
  const float x0 = (float)((tg % tx) * TILE), y0 = (float)((tg / tx) * TILE);
  // the square's and the warp's block's corner centres, in tile-local coordinates
  const int sx0 = (q % SUBS_X) * SUB, sy0 = (q / SUBS_X) * SUB;
  const float cx0 = (float)sx0 + 0.5f, cx1 = (float)(sx0 + SUB) - 0.5f;
  const float cy0 = (float)sy0 + 0.5f, cy1 = (float)(sy0 + SUB) - 0.5f;
  const int bx0 = sx0 + (warp % BLOCKS_X) * BW, by0 = sy0 + (warp / BLOCKS_X) * BH;
  const float wx0 = (float)bx0 + 0.5f, wx1 = (float)(bx0 + BW) - 0.5f;
  const float wy0 = (float)by0 + 0.5f, wy1 = (float)(by0 + BH) - 0.5f;
  // pixel i of this lane: local x fixed, local y steps by ROW_STEP
  const float xl = (float)(bx0 + lane % BW) + 0.5f;
  const int row0 = by0 + lane / BW;

  for (int k = tid; k < k2; k += THREADS) s_row[k] = entries[(size_t)t * k2 + k];
  int key[PPT];
  int vid[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    key[i] = 0;
    vid[i] = -1;
  }
  __syncthreads();

  const int n = counts[t];
  const int rounds_n = (n + ROUND - 1) / ROUND;
  for (int r0 = 0;; ++r0) {
    // ---- early-out: the tile-wide min of the resolved depth bits ----
    bool go;
    if (r0 == 0) {
      go = rounds_n > 0 && 0 < near_r[t * rounds];  // every key is still 0
    } else {
      int m = INT_MAX;
#pragma unroll
      for (int i = 0; i < PPT; ++i) m = min(m, key[i]);
      for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) s_warp_min[warp] = m;
      __syncthreads();  // also: every warp is done with the last round's staged coefficients
      if (tid == 0) {
        int bm = s_warp_min[0];
        for (int w = 1; w < WARPS; ++w) bm = min(bm, s_warp_min[w]);
        if constexpr (CLUSTER > 1)
          s_min[r0 & 1] = bm;
        else  // the CTA is the tile
          s_go = (r0 < rounds_n) && ((bm & ~127) < near_r[t * rounds + min(r0, rounds - 1)]);
      }
      if constexpr (CLUSTER > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // the four sub-tiles' mins of this round are published
        if (tid == 0) {
          int tm = INT_MAX;
          for (int j = 0; j < CLUSTER; ++j) tm = min(tm, *cluster.map_shared_rank(&s_min[r0 & 1], j));
          s_go = (r0 < rounds_n) && ((tm & ~127) < near_r[t * rounds + min(r0, rounds - 1)]);
        }
      }
      __syncthreads();
      go = s_go;
    }
    if (!go) break;

    // ---- stage the round: tile-local constant, hi/lo split, the square's reject bits ----
    for (int col = tid; col < COLS; col += THREADS) {
      const int p = col / ROUND, s = col % ROUND;
      const int e = s_row[r0 * ROUND + s];
      const float* row = comb + (size_t)(e < 0 ? 0 : e) * COMB_W + PLANE_OFF + 3 * p;
      // a missing entry never covers: e0's constant is -1e30, everything else 0
      const float a = e >= 0 ? row[0] : 0.0f;
      const float b = e >= 0 ? row[1] : 0.0f;
      const float c = e >= 0 ? row[2] : (p == 0 ? -1e30f : 0.0f);
      const float cp = (c + x0 * a) + y0 * b;
      const float ah = bf16_hi(a), al = bf16_hi(a - ah);
      const float bh = bf16_hi(b), bl = bf16_hi(b - bh);
      const float ch = bf16_hi(cp), cl = bf16_hi(cp - ch);
      s_ah[col] = ah; s_al[col] = al;
      s_bh[col] = bh; s_bl[col] = bl;
      s_ch[col] = ch; s_cl[col] = cl;
      const float mg = -reject_margin(ah, al, bh, bl, ch, cl, SPAN);
      s_mg[col] = mg;
      const bool dead = plane_dead(p == PLANES - 1, mg, ah, bh, ch, al, bl, cl, cx0, cx1, cy0, cy1);
      const unsigned bits = __ballot_sync(0xffffffffu, dead);
      if (lane == 0) s_dead[col >> 5] = bits;
    }
    __syncthreads();

    // ---- the warp's block: lane j tests slots j and j + 32 if the square kept them ----
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
        const int c = p * ROUND + s;
        keep = !plane_dead(p == PLANES - 1, s_mg[c], s_ah[c], s_bh[c], s_ch[c], s_al[c], s_bl[c], s_cl[c], wx0, wx1,
                           wy0, wy1);
      }
      live |= (unsigned long long)__ballot_sync(0xffffffffu, keep) << (32 * half);
    }

    // ---- phase A over the slots left, in ascending slot order: cover + packed key, strict max ----
    while (live) {
      const int s = __ffsll((long long)live) - 1;
      live &= live - 1;
      float ah[PLANES], al[PLANES], bh[PLANES], bl[PLANES], ch[PLANES], cl[PLANES];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const int c = p * ROUND + s;
        ah[p] = s_ah[c];
        al[p] = s_al[c];
        bh[p] = s_bh[c];
        bl[p] = s_bl[c];
        ch[p] = s_ch[c];
        cl[p] = s_cl[c];
      }
      const int code = 127 - s;
      const int won = tg * 256 + r0 * ROUND + s;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float yl = (float)(row0 + i * ROW_STEP) + 0.5f;
        float e[PLANES];
#pragma unroll
        for (int p = 0; p < PLANES; ++p) e[p] = plane(ah[p], bh[p], ch[p], al[p], bl[p], cl[p], xl, yl);
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
  }
  // The cluster's CTAs read each other's s_min up to the last round: none may
  // exit before all have; phase B runs between the arrival and the wait.
  if constexpr (CLUSTER > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // ---- phase B: the winner's G-buffer lanes, written cropped, a warp per 32 pixels of whole rows ----
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int o = (row0 + i * ROW_STEP - sy0) * SUB + (bx0 - sx0 + lane % BW);
    s_key[o] = key[i];
    s_vid[o] = vid[i];
  }
  __syncthreads();
  const int lx = sx0 + lane % SUB;  // tile-local; a warp takes whole rows of the square
  const int gx0 = (t % tx) * TILE + sx0;  // the square's first image column
  const float px = x0 + ((float)lx + 0.5f);
  uint4* row_gb = reinterpret_cast<uint4*>(s_gb[warp]);
#pragma unroll
  for (int i = 0; i < G::B_PASSES; ++i) {
    const int pass = warp + i * WARPS;  // the square's pixels 32*pass .. 32*pass + 31
    const int sly = pass * G::ROWS_PER_PASS + lane / SUB;
    const int ly = sy0 + sly;
    const int gy0 = (t / tx) * TILE + sy0 + pass * G::ROWS_PER_PASS;  // the pass's first image row
    if (gy0 >= height) continue;  // every row of the pass: uniform over the warp
    const int gy = gy0 + lane / SUB;
    const int kk = s_key[pass * 32 + lane], vv = s_vid[pass * 32 + lane];
    if (gy < height && gx0 + lane % SUB < width) {
      const size_t o = (size_t)gy * width + gx0 + lane % SUB;
      depth_out[o] = __int_as_float(kk & ~127);
      vid_out[o] = vv;
    }
    __align__(16) __nv_bfloat16 lanes[16];
    if (vv >= 0) {
      const float* A = comb + (size_t)s_row[vv - tg * 256] * COMB_W;
      const float py = y0 + ((float)ly + 0.5f);
      float v[9];
#pragma unroll
      for (int l = 0; l < 9; ++l) v[l] = (__ldg(A + l) * px + __ldg(A + 16 + l) * py) + __ldg(A + 32 + l);
      const float rw = 1.0f / (fabsf(v[8]) > 1e-12f ? v[8] : 1.0f);
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        lanes[l] = __float2bfloat16_rn(v[l] * rw);
        lanes[8 + l] = __float2bfloat16_rn(__ldg(A + 48 + l));
      }
    } else {
#pragma unroll
      for (int l = 0; l < 16; ++l) lanes[l] = __float2bfloat16_rn(0.0f);
    }
    // the 32 pixels x 32 bytes leave as row segments of 512 bytes (SUB 16) or one of 1 KB (SUB 32)
    row_gb[2 * lane] = reinterpret_cast<const uint4*>(lanes)[0];
    row_gb[2 * lane + 1] = reinterpret_cast<const uint4*>(lanes)[1];
    __syncwarp();
#pragma unroll
    for (int j = lane; j < 64; j += 32) {
      const int pj = j / 2, y = gy0 + pj / SUB, x = gx0 + pj % SUB;
      if (y < height && x < width) reinterpret_cast<uint4*>(gb_out + ((size_t)y * width + x) * 16)[j & 1] = row_gb[j];
    }
    __syncwarp();
  }
  if constexpr (CLUSTER > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int TILE>
int launch(const void* entries, const void* comb, const void* counts, const void* near_r, int n_tiles, int k2,
           int width, int height, int tile_base, void* depth, void* vid, void* gb, void* stream) {
  using G = Geometry<TILE>;
  const int tx = (width + TILE - 1) / TILE;
  const int ty = (height + TILE - 1) / TILE;
  if (k2 <= 0 || k2 % ROUND != 0 || k2 > MAX_K2 || n_tiles <= 0 || n_tiles != tx * ty || tile_base < 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_tiles * G::CLUSTER));
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G::CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = G::CLUSTER > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, raster_tiles_kernel<TILE>, (const int*)entries, (const float*)comb,
                                           (const int*)counts, (const int*)near_r, k2, tx, tile_base, width, height,
                                           (float*)depth, (int*)vid, (__nv_bfloat16*)gb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// One cluster of 4 CTAs per 64^2 tile, one CTA per 32^2 or 16^2 tile; an
// unknown tile edge, bad sizes or a refused launch return an error.
extern "C" int raster_tiles(const void* entries, const void* comb, const void* counts, const void* near_r,
                            int n_tiles, int k2, int width, int height, int tile, int tile_base, void* depth,
                            void* vid, void* gb, void* stream) {
  switch (tile) {
    case 16:
      return launch<16>(entries, comb, counts, near_r, n_tiles, k2, width, height, tile_base, depth, vid, gb, stream);
    case 32:
      return launch<32>(entries, comb, counts, near_r, n_tiles, k2, width, height, tile_base, depth, vid, gb, stream);
    case 64:
      return launch<64>(entries, comb, counts, near_r, n_tiles, k2, width, height, tile_base, depth, vid, gb, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
