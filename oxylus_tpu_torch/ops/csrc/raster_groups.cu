// Group-hit G-buffer raster for Hopper (sm_90a).
//
// Replaces the TPU kernels oxylus_tpu/ops/raster3d.py::_make_gbuffer_kernel
// (:355, streamed attributes) and _make_gbuffer_kernel_resident (:544,
// resident bf16 hi/lo attributes), both launched by rasterize_gbuffer_pallas
// (:692). The two differ only in how phase B selects the winner's attribute
// coefficients; this kernel reads the winner's float32 row, which is what the
// streamed kernel computes (hi + the float32 rest). Plain PyTorch version:
// oxylus_tpu_torch/ops/raster_groups.py::_raster_groups_plain, whose per-pixel
// arithmetic this file repeats operation for operation (built with
// -fmad=false, so results are bit-identical).
//
// What it computes, per tile of TILE x TILE pixels (TILE 32 or 64): the
// tile's list of dense triangle groups, k = 0, 1, ... while k < cnt (entries
// >= 0 in the row) and the tile-wide min of the pixels' keys with the low 7
// bits cleared (all TILE^2 pixels, those past the image edge included) is
// below the k-th near bound (int32 bits of a float depth). Per group
// g = max(list[k], 0) its R slots' 15 plane coefficients are staged with the
// tile-local constant c' = (c + x0*a) + y0*b, each split into bf16 hi and lo
// parts (round to nearest even); a pixel evaluates, for the five planes
// (e0 e1 e2 zn wd), e = a_hi*xl + b_hi*yl + c'_hi + a_lo*xl + b_lo*yl + c'_lo in
// that order at local centres k + 0.5, tests cover (e0, e1, e2, zn, wd - zn,
// wd - 1e-30 all >= 0: the TPU kernel's min-tree, NaN included), and keeps
// the max of the key (bits(zn * (1 / max(wd, 1e-30))) & ~127) | (127 - slot),
// replacing the pixel's key only where strictly larger: the slot codes differ
// within a group, so slots in ascending order within a group and groups in
// list order give the TPU kernel's winner (the max over a group's slots, then
// a strict > across groups). vid = g*256 + slot. Phase B: each hit pixel reads
// its winner's row g*R + slot and writes lanes 0-7 =
// ((a*px + b*py) + c) * (1 / ss) (ss = lane 8, where |ss| > 1e-12, else 1)
// and lanes 8-15 = the material constants, as bf16 (round to nearest even),
// with depth = key & ~127, straight into the cropped (H, W) images. Planes and
// attributes use the global tile id t + tile_base (a band of a sharded image);
// the outputs are written at local tile t.
//
// What bounds it on the card: the outputs' bytes (40 B per pixel, 83 MB at
// 1080p). The least evaluation an exact design needs, a slot test per walked
// (tile, group) and the planes at the pixels of each slot's span, is far
// below that at the SMs' float32 rate (67 TFLOP/s). The TPU kernels' one-hot
// selection matmuls (and the DMA double buffer of the streamed one) are TPU
// layout, not the algorithm: here the winner's attributes are one row read.
//
// What the design does about it (the first port ran one 256-thread CTA per
// tile and evaluated every slot of every walked group at all TILE^2 pixels,
// 16 a thread, one SM walking a tile's whole list):
// - A 64^2 tile is a thread-block cluster of 4 CTAs, one per 32x32 sub-tile;
//   a 32^2 tile is one CTA. 256 threads a CTA, each warp a 16x8 block of the
//   sub-tile, 4 pixels a lane. Groups stay sequential in list order in the
//   cluster, and the early-out stays tile-wide: it decides exact-depth ties.
// - The early-out without a barrier a group: before each group after the
//   first, each CTA publishes its sub-tile's min key for that group (a release
//   store into its own shared memory, one slot a group). The tile's min is at
//   most the sub-tile's, so a CTA whose own min is below the group's near
//   bound walks on at once; only a CTA whose own min is not reads the other
//   sub-tiles' slots through distributed shared memory (acquire loads, waiting
//   for each to be published). Every CTA so takes the tile-wide decision. The
//   slots are set to a sentinel, and the cluster synchronises once, before the
//   walk of a tile with a group.
// - Conservative reject per (sub-tile, slot), computed while the group's
//   coefficients are staged, then per (warp block, slot): a slot is skipped
//   only where one of its planes, at the region's four corner centres, proves
//   it covers no pixel centre there (plane_reject.cuh, whose margin holds for
//   tile-local centres <= 63.5, both tiles here). An empty slot (e0 constant
//   -1e30) fails on e0. A skipped slot covers none of the pixels it is skipped
//   for, so key and vid never change by it. Phase A walks only the slots left.
// - The next group's 15 coefficients a slot are copied into shared memory
//   with cp.async, slot by slot (coalesced), while the current group is
//   evaluated; the tile's list and near bounds are staged once, and its
//   entries counted with one block-wide reduction.
// - Phase B: the keys and vids go through shared memory so that each warp
//   writes whole 32-pixel rows of the sub-tile: 128-byte depth and vid
//   stores, and the row's 1 KB of G-buffer lanes staged in shared memory and
//   written as two contiguous 512-byte warp stores.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <climits>
#include <cstdint>

#include "plane_reject.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SUB = 32;                   // sub-tile side: one CTA each
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;             // CTAs an SM must hold (registers: at most 85 a thread)
constexpr int WARPS = THREADS / 32;
constexpr int BW = 16, BH = 8;            // a warp's block of the sub-tile
constexpr int BLOCKS_X = SUB / BW;
static_assert(BLOCKS_X * (SUB / BH) == WARPS, "one block per warp");
constexpr int ROW_STEP = 32 / BW;         // rows between a lane's pixels
constexpr int PPT = BW * BH / 32;         // pixels per thread
constexpr int B_ROWS = SUB * SUB / THREADS;  // phase B: rows of the sub-tile per warp
constexpr int PLANES = 5;
constexpr int MAX_SLOTS = 128;            // the slot code 127 - slot
constexpr int MAX_WORDS = MAX_SLOTS / 32;
constexpr int MAX_COLS = PLANES * MAX_SLOTS;  // staged columns, plane-major (p*32*words + slot)
constexpr int PLANE_OFF = 64;             // the 15 plane coefficients in a row, after attrB (64)
constexpr size_t DYN_DEFAULT = 4 * 1024;  // dynamic shared memory that fits beside the static without opting in
constexpr int COEFFS = 15;                // plane coefficients a slot: (a, b, c) of e0 e1 e2 zn wd
constexpr int UNPUBLISHED = INT_MIN;      // a step's min key not yet published (keys are >= 0)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// This CTA's min key of a step, released to the cluster.
__device__ __forceinline__ void publish(int* slot, int v) {
  asm volatile("st.release.cluster.shared::cta.s32 [%0], %1;\n" ::"r"((unsigned)__cvta_generic_to_shared(slot)), "r"(v)
               : "memory");
}

// Rank `rank`'s copy of `slot` once it is published.
__device__ __forceinline__ int await_remote(int* slot, int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"((unsigned)__cvta_generic_to_shared(slot)), "r"(rank));
  int v;
  do {
    asm volatile("ld.acquire.cluster.shared::cluster.s32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  } while (v == UNPUBLISHED);
  return v;
}

template <int TILE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) raster_groups_kernel(
    const float* __restrict__ rows, int row_w, const int* __restrict__ tile_list, const int* __restrict__ near,
    int k_cap, int n_slots, int tx, int tile_base, int width, int height, float* __restrict__ depth_out,
    int* __restrict__ vid_out, __nv_bfloat16* __restrict__ gb_out) {
  constexpr int SUBS_X = TILE / SUB;
  constexpr int CLUSTER = SUBS_X * SUBS_X;  // CTAs per tile
  // per column: a, b, c' as bf16-valued hi and lo parts, minus the reject margin
  __shared__ float s_ah[MAX_COLS], s_al[MAX_COLS], s_bh[MAX_COLS], s_bl[MAX_COLS], s_ch[MAX_COLS], s_cl[MAX_COLS],
      s_mg[MAX_COLS];
  __shared__ unsigned s_dead[MAX_COLS / 32];  // the sub-tile's reject bits, word p*words + w: slots 32*w + lane
  __shared__ float s_raw[MAX_SLOTS * COEFFS];  // the next group's plane coefficients, slot-major
  __shared__ int s_warp_cnt[WARPS], s_warp_min[WARPS];
  __shared__ int s_go;
  __shared__ int s_key[SUB * SUB], s_vid[SUB * SUB];  // phase B's hand-over
  __shared__ __align__(16) __nv_bfloat16 s_gb[WARPS][SUB * 16];  // a warp's row of G-buffer lanes
  extern __shared__ int s_dyn[];
  int* s_list = s_dyn;              // [k_cap] max(entry, 0)
  int* s_near = s_dyn + k_cap;      // [k_cap]
  int* s_step = s_dyn + 2 * k_cap;  // [k_cap] this sub-tile's min key before each group; read by the cluster

  const int t = blockIdx.x / CLUSTER;
  int q = 0;  // this CTA's sub-tile
  if constexpr (CLUSTER > 1) q = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tg = t + tile_base;
  const float x0 = (float)((tg % tx) * TILE), y0 = (float)((tg / tx) * TILE);
  // the sub-tile's and the warp's block's corner centres, in tile-local coordinates
  const int sx0 = (q % SUBS_X) * SUB, sy0 = (q / SUBS_X) * SUB;
  const float cx0 = (float)sx0 + 0.5f, cx1 = (float)(sx0 + SUB) - 0.5f;
  const float cy0 = (float)sy0 + 0.5f, cy1 = (float)(sy0 + SUB) - 0.5f;
  const int bx0 = sx0 + (warp % BLOCKS_X) * BW, by0 = sy0 + (warp / BLOCKS_X) * BH;
  const float wx0 = (float)bx0 + 0.5f, wx1 = (float)(bx0 + BW) - 0.5f;
  const float wy0 = (float)by0 + 0.5f, wy1 = (float)(by0 + BH) - 0.5f;
  // pixel i of this lane: local x fixed, local y steps by ROW_STEP
  const float xl = (float)(bx0 + lane % BW) + 0.5f;
  const int row0 = by0 + lane / BW;
  const int words = (n_slots + 31) >> 5;  // slot words per plane
  const int rp = 32 * words;              // staged columns per plane
  const int cols = PLANES * rp;

  // ---- stage the tile's list and near bounds; count its entries >= 0 ----
  int c = 0;
  for (int k = tid; k < k_cap; k += THREADS) {
    const int e = tile_list[(size_t)t * k_cap + k];
    s_list[k] = max(e, 0);
    s_near[k] = near[(size_t)t * k_cap + k];
    s_step[k] = UNPUBLISHED;
    c += e >= 0;
  }
  c = __reduce_add_sync(0xffffffffu, c);
  if (lane == 0) s_warp_cnt[warp] = c;
  int key[PPT];
  int vid[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    key[i] = 0;
    vid[i] = -1;
  }
  // a group's 15 plane coefficients a slot into s_raw, copied slot by slot (coalesced), without waiting
  auto fetch_raw = [&](int g) {
    const float* base = rows + (size_t)g * n_slots * row_w + PLANE_OFF;
    for (int i = tid; i < n_slots * COEFFS; i += THREADS)
      cp_async4(&s_raw[i], base + (size_t)(i / COEFFS) * row_w + i % COEFFS);
  };
  __syncthreads();
  int cnt = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) cnt += s_warp_cnt[w];
  if (cnt > 0) {
    fetch_raw(s_list[0]);
    if constexpr (CLUSTER > 1) cg::this_cluster().sync();  // every CTA's s_step is initialised before any is read
  }

  for (int k = 0;; ++k) {
    // ---- early-out: the tile-wide min of the resolved depth bits ----
    bool go;
    if (k == 0) {
      cp_async_wait_all();
      __syncthreads();                // group 0's coefficients are in s_raw
      go = cnt > 0 && 0 < s_near[0];  // every key is still 0
    } else {
      int m = INT_MAX;
#pragma unroll
      for (int i = 0; i < PPT; ++i) m = min(m, key[i]);
      m = __reduce_min_sync(0xffffffffu, m);
      if (lane == 0) s_warp_min[warp] = m;
      cp_async_wait_all();
      __syncthreads();  // also: every warp is done with the last group's columns, and this group's s_raw has landed
      if (tid == 0) {
        int bm = s_warp_min[0];
        for (int w = 1; w < WARPS; ++w) bm = min(bm, s_warp_min[w]);
        if (k < k_cap) publish(&s_step[k], bm);
        // The tile's min is at most this sub-tile's: below the near bound, every CTA walks on. Only when
        // this sub-tile's is not does the decision need the cluster's values, which each CTA publishes
        // before it decides, so every CTA decides the same.
        bool more = k < cnt && (bm & ~127) < s_near[k];
        if constexpr (CLUSTER > 1) {
          if (k < cnt && !more) {
            int tm = bm;
            for (int j = 0; j < CLUSTER; ++j)
              if (j != q) tm = min(tm, await_remote(&s_step[k], j));
            more = (tm & ~127) < s_near[k];
          }
        }
        s_go = more;
      }
      __syncthreads();
      go = s_go;
    }
    if (!go) break;
    const int g = s_list[k];

    // ---- stage the group: tile-local constant, hi/lo split, the sub-tile's reject bits ----
    for (int col = tid; col < cols; col += THREADS) {
      const int p = col / rp, s = col - p * rp;
      const bool have = s < n_slots;
      const float* r = s_raw + (have ? s : 0) * COEFFS + 3 * p;
      // a column past R never covers: e0's constant is -1e30, everything else 0
      const float a = have ? r[0] : 0.0f;
      const float b = have ? r[1] : 0.0f;
      const float cc = have ? r[2] : (p == 0 ? -1e30f : 0.0f);
      const float cp = (cc + x0 * a) + y0 * b;
      const float ah = bf16_hi(a), al = bf16_hi(a - ah);
      const float bh = bf16_hi(b), bl = bf16_hi(b - bh);
      const float ch = bf16_hi(cp), cl = bf16_hi(cp - ch);
      s_ah[col] = ah; s_al[col] = al;
      s_bh[col] = bh; s_bl[col] = bl;
      s_ch[col] = ch; s_cl[col] = cl;
      const float mg = -reject_margin(ah, al, bh, bl, ch, cl);
      s_mg[col] = mg;
      const bool dead = plane_dead(p == PLANES - 1, mg, ah, bh, ch, al, bl, cl, cx0, cx1, cy0, cy1);
      const unsigned bits = __ballot_sync(0xffffffffu, dead);  // cols and THREADS are whole warps
      if (lane == 0) s_dead[col >> 5] = bits;
    }
    __syncthreads();
    if (k + 1 < cnt) fetch_raw(s_list[k + 1]);  // loads while this group is evaluated

    // ---- the warp's block: lane j tests slots j, j + 32, ... if the sub-tile kept them ----
    unsigned live[MAX_WORDS];
#pragma unroll
    for (int w = 0; w < MAX_WORDS; ++w) {
      live[w] = 0u;
      if (w < words) {
        const int s = w * 32 + lane;
        unsigned dead = 0u;
#pragma unroll
        for (int p = 0; p < PLANES; ++p) dead |= s_dead[p * words + w];
        bool keep = s < n_slots && !((dead >> lane) & 1u);
        for (int p = 0; p < PLANES && keep; ++p) {
          const int cc = p * rp + s;
          keep = !plane_dead(p == PLANES - 1, s_mg[cc], s_ah[cc], s_bh[cc], s_ch[cc], s_al[cc], s_bl[cc], s_cl[cc],
                             wx0, wx1, wy0, wy1);
        }
        live[w] = __ballot_sync(0xffffffffu, keep);
      }
    }

    // ---- phase A over the slots left, in ascending slot order: cover + packed key, strict max ----
#pragma unroll
    for (int w = 0; w < MAX_WORDS; ++w) {
      unsigned m = live[w];
      while (m) {
        const int s = w * 32 + __ffs(m) - 1;
        m &= m - 1;
        float ah[PLANES], al[PLANES], bh[PLANES], bl[PLANES], ch[PLANES], cl[PLANES];
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
          const int cc = p * rp + s;
          ah[p] = s_ah[cc];
          al[p] = s_al[cc];
          bh[p] = s_bh[cc];
          bl[p] = s_bl[cc];
          ch[p] = s_ch[cc];
          cl[p] = s_cl[cc];
        }
        const int code = 127 - s;
        const int won = g * 256 + s;
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
  }
  // The cluster's CTAs read each other's s_step up to the last group: none
  // may exit before all have; phase B runs between the arrival and the wait.
  if constexpr (CLUSTER > 1) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // ---- phase B: the winner's G-buffer lanes, written cropped, a warp per sub-tile row ----
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int o = (row0 + i * ROW_STEP - sy0) * SUB + (bx0 - sx0 + lane % BW);
    s_key[o] = key[i];
    s_vid[o] = vid[i];
  }
  __syncthreads();
  const int lx = sx0 + lane;  // tile-local; a warp takes whole rows of the sub-tile
  const int gx0 = (t % tx) * TILE + sx0;
  const float px = x0 + ((float)lx + 0.5f);
  uint4* row_gb = reinterpret_cast<uint4*>(s_gb[warp]);
#pragma unroll
  for (int i = 0; i < B_ROWS; ++i) {
    const int sly = warp + i * WARPS;
    const int ly = sy0 + sly;
    const int gy = (t / tx) * TILE + ly;
    if (gy >= height) continue;  // the whole row: uniform over the warp
    const int kk = s_key[sly * SUB + lane], vv = s_vid[sly * SUB + lane];
    const size_t o0 = (size_t)gy * width + gx0;  // the row's first pixel
    if (gx0 + lane < width) {
      depth_out[o0 + lane] = __int_as_float(kk & ~127);
      vid_out[o0 + lane] = vv;
    }
    __align__(16) __nv_bfloat16 lanes[16];
    if (vv >= 0) {
      const float* A = rows + ((size_t)(vv >> 8) * n_slots + (vv & 255)) * row_w;
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
    // the row's 32 pixels x 32 bytes leave as two 512-byte warp stores
    row_gb[2 * lane] = reinterpret_cast<const uint4*>(lanes)[0];
    row_gb[2 * lane + 1] = reinterpret_cast<const uint4*>(lanes)[1];
    __syncwarp();
#pragma unroll
    for (int j = lane; j < 2 * SUB; j += 32)
      if (gx0 + j / 2 < width) reinterpret_cast<uint4*>(gb_out + (o0 + j / 2) * 16)[j & 1] = row_gb[j];
    __syncwarp();
  }
  if constexpr (CLUSTER > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int TILE>
cudaLaunchConfig_t launch_config(int n_tiles, size_t dyn, cudaStream_t stream, cudaLaunchAttribute* attr) {
  constexpr int CLUSTER = (TILE / SUB) * (TILE / SUB);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_tiles * CLUSTER));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  return cfg;
}

// The kernel's dynamic shared memory for k_cap list entries, opted into past the default.
template <int TILE>
cudaError_t prepare(int k_cap, size_t* dyn) {
  *dyn = 3 * (size_t)k_cap * sizeof(int);
  if (*dyn <= DYN_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(raster_groups_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*dyn);
}

template <int TILE>
int launch(const void* rows, int row_w, const void* tile_list, const void* near, int n_tiles, int k_cap, int n_slots,
           int tx, int tile_base, int width, int height, void* depth, void* vid, void* gb, void* stream) {
  size_t dyn;
  cudaError_t e = prepare<TILE>(k_cap, &dyn);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<TILE>(n_tiles, dyn, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, raster_groups_kernel<TILE>, (const float*)rows, row_w, (const int*)tile_list,
                         (const int*)near, k_cap, n_slots, tx, tile_base, width, height, (float*)depth, (int*)vid,
                         (__nv_bfloat16*)gb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int TILE>
int info(int k_cap, int* out) {
  size_t dyn;
  cudaError_t e = prepare<TILE>(k_cap, &dyn);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, raster_groups_kernel<TILE>);
  int blocks = 0, clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, raster_groups_kernel<TILE>, THREADS, dyn);
  if (e == cudaSuccess && TILE > SUB) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config<TILE>(1, dyn, nullptr, attr);
    e = cudaOccupancyMaxActiveClusters(&clusters, raster_groups_kernel<TILE>, &cfg);
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = fa.numRegs;
  out[1] = (int)(fa.sharedSizeBytes + dyn);
  out[2] = blocks;
  out[3] = clusters;
  out[4] = (TILE / SUB) * (TILE / SUB);
  return 0;
}

}  // namespace

// One cluster of (tile / 32)^2 CTAs per tile; a refused launch returns its error.
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
  if (tile == 64)
    return launch<64>(rows, row_w, tile_list, near, n_tiles, k_cap, n_slots, tx, tile_base, width, height, depth, vid,
                      gb, stream);
  return launch<32>(rows, row_w, tile_list, near, n_tiles, k_cap, n_slots, tx, tile_base, width, height, depth, vid,
                    gb, stream);
}

// The launch's resources for `tile` and `k_cap` into out[5]: registers a
// thread, shared memory a CTA (bytes), CTAs resident per SM, clusters
// resident on the card (0 without a cluster), CTAs per cluster.
extern "C" int raster_groups_info(int tile, int k_cap, int* out) {
  if ((tile != 32 && tile != 64) || k_cap <= 0) return (int)cudaErrorInvalidValue;
  return tile == 64 ? info<64>(k_cap, out) : info<32>(k_cap, out);
}
