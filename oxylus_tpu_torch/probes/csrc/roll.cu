// Rotate, vector-chain, matrix-product, argmax-extraction and dynamic-trip
// probes for Hopper (sm_90a).
//
// Replaces the TPU probe kernels of scripts/probe_roll.py (:41-139, each
// launched by run's pallas_call at :15): k_dynroll, k_rollrate,
// k_dynrollrate, k_vpu, k_vpu_big, k_mxu, k_extract and k_dyntrip. Plain
// PyTorch versions: oxylus_tpu_torch/probes/roll.py::*_reference. Every
// repetition loop runs inside the kernel, as the TPU kernels' fori_loop does.
//
// What they compute and what bounds them on the card (data-sheet peaks, H100
// SXM):
// - roll_chain: acc = sum over i < n_iter of roll(x, s_i) along 128 lanes, or
//   one roll; s_i a launch argument or base + i % step_mod (a power of two)
//   with base read from device memory at run time. Bound: the adds, 2000 *
//   1024 for the script's chain, 0.03 us of float32 rate; the rotates are data
//   movement. In fact bound by the latency of each element's 2000 dependent
//   adds (~2.2 ns each on an H100, 4.4 us in all).
// - vector_chain: 8 dependent float32 operations per element and iteration
//   (4 mul, 4 add/sub, no fused multiply-add under -fmad=false). Bound: 8 *
//   n * n_iter operations at 67 TFLOP/s (which counts an FMA as two), 0.24 us
//   for (8, 128) x 2000; in fact the latency of the dependent chain.
// - matmul_f32: out = sum over reps of a (m, k) . b (k, n) in full float32 by
//   FFMA on the CUDA cores, as Mosaic's f32 dot; bound 2mkn*reps at 67
//   TFLOP/s. matmul_bf16: the same with bf16 operands on the tensor cores,
//   float32 accumulation; bound at 989 TFLOP/s. Both operands stay in shared
//   memory for all repetitions, as k_mxu keeps them in VMEM; the sums run in
//   another order than the plain version's acc + (a . b), exact on integer
//   sums below 2^24 (the script's all-ones inputs), else within
//   product_bound.
// - argmax_extract: per 128-lane row, `rounds` times: the first maximum of the
//   score, out[idx] += 1 + round, score[idx] = -1, where score = x where
//   x mod 3 < 1 (floor mod, as jnp.remainder) else -1. Bound: bytes, 8 KB.
// - dynamic_trip: acc = sum of x over a trip count read from device memory
//   at run time; bound 37 * 1024 adds, 0.6 ns.
//
// What the design does about it: the roll chain is a thread per output
// element, blocks of CHAIN_THREADS = 128 (the script's 1024 elements on 8
// SMs; 32 to 256 measured within 1 % of each other on an H100, each warp
// waiting on its own chain). The shifts s_i take D = min(step_mod, 128)
// values (1 for a static shift), so element (r, j) loads the D rotated values
// x[r, (j - base - k) mod 128], k < D, into registers once and adds them in
// iteration order, acc = acc + v[i % D] from 0.0f: the plain version's sums,
// one add an iteration, none reassociated. Without `accumulate` it loads the
// last iteration's value alone, a block a row through shared memory, so that
// the shift's read overlaps the row's. argmax_extract keeps a 128-lane row in
// one warp, four values per thread (lane l holds lanes l, l+32, l+64, l+96),
// and reduces by a shuffle tree. The vector chain is one thread per element.
//
// The products run on a planned grid (roll.product_plan) of m-tiles x n-tiles
// x k-slices x repetition groups, about one wave of the 132 SMs: each CTA
// stages its blocks of a and b in shared memory once and runs its group's
// repetitions on them; a second launch adds the k_slices x rep_groups
// float32 partials of each output in a fixed order (no atomics: the same
// inputs give the same bits). matmul_f32: 8 x 8 outputs a thread from two
// float4 of a and two of b a k step (16 floats loaded per 64 FFMA; a staged
// k-major so both are conflict-free), tiles of 128 x 128 (k-slice 64) or,
// for n < 64, 128 x 16 with 4 warps each on a quarter of the k-slice. Every
// multiply-add is __fmaf_rn: the library is built with -fmad=false. The
// 1024 x 1024 x 128 product is 8 m-tiles x 16 k-slices = 128 CTAs, each
// doing all 500 repetitions. matmul_bf16, the tensor-core product:
// wgmma.mma_async m64n128k16 (m64n16k16 for n < 64), a from registers
// (loaded once: a does not change across repetitions), b from shared memory
// in the no-swizzle K-major layout, two warpgroups a 128-row tile, k-slice
// 256 (128), the 1024 shape as 8 x 4 tiles x 4 groups of 125 repetitions.
// The same grid with mma.sync.m16n8k16 fragments from shared memory by
// ldmatrix took 1.5x as long at 1024 x 1024 x 128 on an H100 and was dropped. Rows,
// columns and k past the edges are zero in shared memory and masked at the
// store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WIDTH = 128;
constexpr int ROW_WARPS = 8;  // rows per block for the one-warp-per-row kernels
constexpr int CHAIN_THREADS = 128;  // threads a block of the roll chain

int blocks_for(int n, int per) { return (n + per - 1) / per; }

// The roll chain: a thread per element e = (row, j); D distinct shifts, each
// value loaded once. C adds a loop trip, a multiple of D, so that v[k % D] is
// a register.
template <int D>
__global__ void __launch_bounds__(CHAIN_THREADS) roll_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                                  int n, int shift, const int* shift_ptr, int n_iter) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int j = e & (WIDTH - 1);
  const float* xr = x + (e - j);
  const int base = ((shift_ptr ? *shift_ptr : shift) % WIDTH + WIDTH) % WIDTH;
  float v[D];
#pragma unroll
  for (int k = 0; k < D; ++k) v[k] = k < n_iter ? xr[(j - base - k) & (WIDTH - 1)] : 0.0f;
  constexpr int C = D < 8 ? 8 : D;
  float acc = 0.0f;
  int i = 0;
  for (; i + C <= n_iter; i += C) {
#pragma unroll
    for (int k = 0; k < C; ++k) acc = acc + v[k % D];
  }
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (i + k < n_iter) acc = acc + v[k % D];
  out[e] = acc;
}

// Without `accumulate`: the last iteration's roll, by base + last_step. A
// block per row: the row is staged in shared memory while the shift is read,
// so the two loads overlap.
__global__ void __launch_bounds__(WIDTH) roll_last_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                          int shift, const int* shift_ptr, int last_step) {
  __shared__ float row[WIDTH];
  const int j = threadIdx.x;
  const size_t at = (size_t)blockIdx.x * WIDTH + j;
  row[j] = x[at];
  const int base = ((shift_ptr ? *shift_ptr : shift) % WIDTH + WIDTH) % WIDTH;
  __syncthreads();
  out[at] = row[(j - base - last_step) & (WIDTH - 1)];
}

__global__ void vector_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int n_iter) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float xv = x[e];
  float acc = xv;
  for (int i = 0; i < n_iter; ++i) {
    const float a = acc * 1.000001f + xv;
    const float b = a * a - xv;
    const float c = b * 0.5f + a;
    acc = c * c + b;
  }
  out[e] = acc;
}

// ---- the products: out = sum over reps of a . b, with both operands resident ----
//
// A planned grid (`roll.product_plan` on the host) of m-tiles x n-tiles x
// k-slices x repetition groups; block b is (tm, tn, s, g) with tm fastest.
// Each CTA stages its (128 x k_slice) block of a and (k_slice x tile_n) block
// of b in shared memory once (zero past the edges), runs its group's
// repetitions on them, and writes one float32 partial; a second launch adds
// the partials of each output in a fixed order (product_reduce_kernel). The
// same inputs give the same bits.

struct ProductGrid {
  int tiles_m, tiles_n, k_slices, rep_groups, k_slice, reps;
};

struct ProductBlock {
  int m0, n0, k0, part, reps;
};

constexpr int PROD_TILE_M = 128;
constexpr int PROD_SMEM_MAX = 232448;  // 227 KB a CTA

__device__ __forceinline__ ProductBlock product_block(const ProductGrid& pg, int tile_n) {
  int b = blockIdx.x;
  const int tm = b % pg.tiles_m;
  b /= pg.tiles_m;
  const int tn = b % pg.tiles_n;
  b /= pg.tiles_n;
  const int s = b % pg.k_slices, g = b / pg.k_slices;
  ProductBlock r;
  r.m0 = tm * PROD_TILE_M;
  r.n0 = tn * tile_n;
  r.k0 = s * pg.k_slice;
  r.part = g * pg.k_slices + s;
  r.reps = pg.reps / pg.rep_groups + (g < pg.reps % pg.rep_groups ? 1 : 0);
  return r;
}

// The FFMA product. LM lanes along m and 32 / LM along n give each lane an
// 8 x 8 register tile (rows in two runs of 4, 4 * LM apart; columns likewise,
// 4 * LN apart), read from shared memory as two float4 of a (stored k-major,
// a transposed) and two of b per k: 16 floats loaded per 64 FFMA. WM x WN
// warps tile the CTA's outputs and WK warps split its k-slice into runs
// whose sums are added in warp order at the end.
// MIN_BLOCKS caps the registers for that many CTAs an SM: on an H100 the wide
// tile ran 11 % faster with two (128 registers) even where the plan puts one
// on an SM.
template <int LM_, int WM_, int WN_, int WK_, int MIN_BLOCKS_>
struct F32Tiles {
  static constexpr int LM = LM_, WM = WM_, WN = WN_, WK = WK_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int LN = 32 / LM, BM = 8 * LM * WM, BN = 8 * LN * WN, THREADS = 32 * WM * WN * WK;
  static_assert(BM == PROD_TILE_M, "the plan's tile rows");
};
using F32Wide = F32Tiles<4, 4, 2, 1, 2>;     // 128 x 128 outputs, 8 warps of 32 x 64
using F32Narrow = F32Tiles<16, 1, 1, 4, 1>;  // 128 x 16 outputs, 4 warps each on a quarter of the k-slice
constexpr int F32_UNROLL = 8;             // k steps per loop trip

__device__ __forceinline__ void load_f32_frag(const float* as, const float* bs, int kk, int bm, int bn, int a_half,
                                              int b_half, float4 (&fa)[2], float4 (&fb)[2]) {
  fa[0] = *reinterpret_cast<const float4*>(as + kk * bm);
  fa[1] = *reinterpret_cast<const float4*>(as + kk * bm + a_half);
  fb[0] = *reinterpret_cast<const float4*>(bs + kk * bn);
  fb[1] = *reinterpret_cast<const float4*>(bs + kk * bn + b_half);
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma_tile(float (&acc)[8][8], const float4 (&fa)[2], const float4 (&fb)[2]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = lane4(fa[i / 4], i % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(x, lane4(fb[j / 4], j % 4), acc[i][j]);
  }
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS) matmul_f32_kernel(const float* __restrict__ a,
                                                                const float* __restrict__ b, float* __restrict__ dst,
                                                                int m, int k, int n, ProductGrid pg) {
  extern __shared__ __align__(16) float fsm[];
  const int ks = pg.k_slice;
  float* as = fsm;                // [ks][BM]: a transposed
  float* bs = fsm + ks * C::BM;   // [ks][BN]
  const ProductBlock blk = product_block(pg, C::BN);
  // stage: a's float4 along k, consecutive threads on consecutive rows (conflict-free transposed stores)
  for (int i = threadIdx.x; i < C::BM * (ks / 4); i += C::THREADS) {
    const int row = i % C::BM, kq = (i / C::BM) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (blk.m0 + row < m && blk.k0 + kq < k)
      v = __ldg(reinterpret_cast<const float4*>(a + (size_t)(blk.m0 + row) * k + blk.k0 + kq));
    as[(kq + 0) * C::BM + row] = v.x;
    as[(kq + 1) * C::BM + row] = v.y;
    as[(kq + 2) * C::BM + row] = v.z;
    as[(kq + 3) * C::BM + row] = v.w;
  }
  for (int i = threadIdx.x; i < ks * (C::BN / 4); i += C::THREADS) {
    const int kk = i / (C::BN / 4), nq = (i % (C::BN / 4)) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (blk.k0 + kk < k && blk.n0 + nq < n)
      v = __ldg(reinterpret_cast<const float4*>(b + (size_t)(blk.k0 + kk) * n + blk.n0 + nq));
    *reinterpret_cast<float4*>(bs + kk * C::BN + nq) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wk = warp / (C::WM * C::WN), wm = (warp % (C::WM * C::WN)) / C::WN, wn = warp % C::WN;
  const int tm = lane / C::LN, tn = lane % C::LN;
  const int row0 = wm * 8 * C::LM + tm * 4, col0 = wn * 8 * C::LN + tn * 4;
  const float* a_lane = as + row0;
  const float* b_lane = bs + col0;
  const int ksw = ks / C::WK, kbeg = wk * ksw, kend = kbeg + ksw;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // the repetitions' k steps as one flat sequence; the fragments of step s + 1 load while step s multiplies
  float4 fa[2][2], fb[2][2];
  load_f32_frag(a_lane, b_lane, kbeg, C::BM, C::BN, 4 * C::LM, 4 * C::LN, fa[0], fb[0]);
  int kk0 = kbeg;
  const int trips = blk.reps * (ksw / F32_UNROLL);
  for (int it = 0; it < trips; ++it) {
    const int next = kk0 + F32_UNROLL == kend ? kbeg : kk0 + F32_UNROLL;
#pragma unroll
    for (int u = 0; u < F32_UNROLL; ++u) {
      const int kn = u + 1 < F32_UNROLL ? kk0 + u + 1 : next;
      load_f32_frag(a_lane, b_lane, kn, C::BM, C::BN, 4 * C::LM, 4 * C::LN, fa[(u + 1) & 1], fb[(u + 1) & 1]);
      fma_tile(acc, fa[u & 1], fb[u & 1]);
    }
    kk0 = next;
  }

  if (C::WK > 1) {  // the k-runs' sums added in warp order through shared memory
    __syncthreads();
    float* red = fsm;  // [WK - 1][BM][BN]
    if (wk > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          red[((wk - 1) * C::BM + row0 + (i / 4) * 4 * C::LM + i % 4) * C::BN + col0 + (j / 4) * 4 * C::LN + j % 4] =
              acc[i][j];
    }
    __syncthreads();
    if (wk > 0) return;
    for (int w = 1; w < C::WK; ++w)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = acc[i][j] + red[((w - 1) * C::BM + row0 + (i / 4) * 4 * C::LM + i % 4) * C::BN + col0 +
                                      (j / 4) * 4 * C::LN + j % 4];
  }
  float* out = dst + (size_t)blk.part * m * n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = blk.m0 + row0 + (i / 4) * 4 * C::LM + i % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = blk.n0 + col0 + h * 4 * C::LN;
      if (row < m && col < n)
        *reinterpret_cast<float4*>(out + (size_t)row * n + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    }
  }
}

// out[e] = the partials' sum at e: warp w adds partials w, w + 32, ... in
// order, then the 32 warp sums are added in warp order. 128 outputs a CTA.
constexpr int RED_WARPS = 32;

__global__ void __launch_bounds__(RED_WARPS * 32) product_reduce_kernel(const float4* __restrict__ part,
                                                                        float4* __restrict__ out, int parts,
                                                                        int count4) {
  __shared__ float4 sums[RED_WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t e = (size_t)blockIdx.x * 32 + lane;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int p = warp; p < parts; p += RED_WARPS) {
    const float4 v = __ldg(part + (size_t)p * count4 + e);
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < RED_WARPS; ++w) {
    const float4 v = sums[w][lane];
    s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
  }
  out[e] = s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// The bf16 products' CTA: 256 threads, 128 rows; tile_n 128 with a k-slice of
// 256, or 16 with 128.
constexpr int BF16_THREADS = 256;
template <int BN>
struct Bf16Tiles {
  static constexpr int KS = BN == 128 ? 256 : 128, KSTEPS = KS / 16;
};

// a's fragment rows (row, row + 8) at k, as wgmma's register A holds them:
// (row, k..k+1), (row + 8, k..k+1), (row, k+8..), (row + 8, k+8..).
__device__ __forceinline__ void load_a_frag(const uint16_t* a, int m, int k, int row, int kk, uint32_t (&f)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = row + 8 * (q & 1), c = kk + 8 * (q >> 1);
    f[q] = r < m && c < k ? __ldg(reinterpret_cast<const uint32_t*>(a + (size_t)r * k + c)) : 0u;
  }
}

// The tensor-core product: wgmma.mma_async m64nBNk16, a from registers (each
// warpgroup's 64 rows of the k-slice, loaded once: KSTEPS x 4 registers), b
// from shared memory in wgmma's no-swizzle K-major layout: 8 x 8 core
// matrices of 128 contiguous bytes, core (n / 8, k / 8) at
// ((n / 8) * KS / 8 + k / 8) * 128 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(d, i) F4(d, i), F4(d, i + 4), F4(d, i + 8), F4(d, i + 12)

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : F4(d, 0), F4(d, 4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, "
      "%45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : F16(d, 0), F16(d, 16), F16(d, 32), F16(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BN>
__global__ void __launch_bounds__(BF16_THREADS) matmul_bf16_wgmma_kernel(const uint16_t* __restrict__ a,
                                                                         const uint16_t* __restrict__ b,
                                                                         float* __restrict__ dst, int m, int k, int n,
                                                                         ProductGrid pg) {
  constexpr int KS = Bf16Tiles<BN>::KS, KSTEPS = Bf16Tiles<BN>::KSTEPS, KB = KS / 8;
  extern __shared__ __align__(128) uint16_t bsm[];
  const ProductBlock blk = product_block(pg, BN);
  // stage b: consecutive threads on consecutive k (conflict-free 2-byte stores into the core rows)
  for (int i = threadIdx.x; i < KS * (BN / 8); i += BF16_THREADS) {
    const int kk = i % KS, nq = (i / KS) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (blk.k0 + kk < k && blk.n0 + nq < n)
      v = __ldg(reinterpret_cast<const uint4*>(b + (size_t)(blk.k0 + kk) * n + blk.n0 + nq));
    const uint16_t* e = reinterpret_cast<const uint16_t*>(&v);
    uint16_t* core = bsm + ((nq / 8) * KB + kk / 8) * 64 + kk % 8;
#pragma unroll
    for (int r = 0; r < 8; ++r) core[r * 8] = e[r];
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wg_row = blk.m0 + 64 * (warp / 4);
  const int row = wg_row + 16 * (warp % 4) + g;
  uint32_t af[KSTEPS][4];
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) load_a_frag(a, m, k, row, blk.k0 + 16 * j + 2 * t, af[j]);
  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
  __syncthreads();
  if (wg_row >= m) return;  // a warpgroup wholly past the last row (the 48-row case)
  const uint32_t base = smem_u32(bsm);
  wgmma_fence();
  for (int r = 0; r < blk.reps; ++r) {
#pragma unroll
    for (int j = 0; j < KSTEPS; ++j) wgmma_rs(d, af[j], wgmma_desc(base + j * 256, 128, KB * 128));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  float* out = dst + (size_t)blk.part * m * n;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = blk.n0 + 8 * i + 2 * t;
    if (col >= n) continue;
    if (row < m) *reinterpret_cast<float2*>(out + (size_t)row * n + col) = make_float2(d[4 * i], d[4 * i + 1]);
    if (row + 8 < m)
      *reinterpret_cast<float2*>(out + (size_t)(row + 8) * n + col) = make_float2(d[4 * i + 2], d[4 * i + 3]);
  }
}

// Checks the host's plan against the shapes: the tile rows, the grid and the
// shared memory must be what the kernel computes from them.
bool plan_ok(int m, int k, int n, int reps, int tile_m, int tile_n, int k_slice, int rep_groups, int grid, int smem,
             int want_smem, ProductGrid* pg) {
  if (tile_m != PROD_TILE_M || k_slice <= 0 || rep_groups < 1 || rep_groups > reps || smem != want_smem ||
      smem > PROD_SMEM_MAX)
    return false;
  pg->tiles_m = (m + tile_m - 1) / tile_m;
  pg->tiles_n = (n + tile_n - 1) / tile_n;
  pg->k_slices = (k + k_slice - 1) / k_slice;
  pg->rep_groups = rep_groups;
  pg->k_slice = k_slice;
  pg->reps = reps;
  return (long long)pg->tiles_m * pg->tiles_n * pg->k_slices * rep_groups == grid;
}

template <class T>
cudaError_t launch_product(void (*kernel)(const T*, const T*, float*, int, int, int, ProductGrid), int threads,
                           int smem, int grid, const void* a, const void* b, void* out, void* partials, int m, int k,
                           int n, const ProductGrid& pg, cudaStream_t st) {
  const int parts = pg.k_slices * pg.rep_groups;
  if (parts > 1 && partials == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, st>>>((const T*)a, (const T*)b, (float*)(parts > 1 ? partials : out), m, k, n, pg);
  e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  const int count4 = m * n / 4;
  product_reduce_kernel<<<count4 / 32, RED_WARPS * 32, 0, st>>>((const float4*)partials, (float4*)out, parts, count4);
  return cudaGetLastError();
}

// Whether (bv, bi) beats (av, ai): NaN above all, then the larger value, then the smaller index.
__device__ __forceinline__ bool beats(float bv, int bi, float av, int ai) {
  const bool bn = isnan(bv), an = isnan(av);
  if (bn != an) return bn;
  if (!bn && bv != av) return bv > av;
  return bi < ai;
}

__global__ void __launch_bounds__(ROW_WARPS * 32) argmax_extract_kernel(const float* __restrict__ x,
                                                                        float* __restrict__ out, int rows,
                                                                        int rounds) {
  const int row = blockIdx.x * ROW_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  float score[4], o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float v = x[(size_t)row * WIDTH + lane + 32 * q];
    float m = fmodf(v, 3.0f);
    if (m != 0.0f && m < 0.0f) m = m + 3.0f;
    score[q] = m < 1.0f ? v : -1.0f;
    o[q] = 0.0f;
  }
  for (int k = 0; k < rounds; ++k) {
    float bv = score[0];
    int bi = lane;
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      if (beats(score[q], lane + 32 * q, bv, bi)) {
        bv = score[q];
        bi = lane + 32 * q;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d /= 2) {
      const float ov = __shfl_xor_sync(FULL, bv, d);
      const int oi = __shfl_xor_sync(FULL, bi, d);
      if (beats(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (lane + 32 * q == bi) {
        o[q] = o[q] + (1.0f + (float)k);
        score[q] = -1.0f;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) out[(size_t)row * WIDTH + lane + 32 * q] = o[q];
}

__global__ void dynamic_trip_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
                                    const int* __restrict__ trip_ptr) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int trip = *trip_ptr;
  const float xv = x[e];
  float acc = 0.0f;
  for (int i = 0; i < trip; ++i) acc = acc + xv;
  out[e] = acc;
}

}  // namespace

extern "C" {

// x, out: (rows, 128) f32. shift_ptr null: the shift is `shift`; else it is
// *shift_ptr, read on the card. Iteration i rolls by that plus i % step_mod
// (step_mod 0: plus nothing; else a power of two); with `accumulate` the rolls
// are summed (roll_chain_kernel), else the last is written (roll_last_kernel).
int probe_roll_chain(const void* x, void* out, int rows, int shift, const void* shift_ptr, int n_iter, int step_mod,
                     int accumulate, void* stream) {
  if (rows <= 0 || n_iter < 1 || step_mod < 0 || (step_mod & (step_mod - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int n = rows * WIDTH, grid = blocks_for(n, CHAIN_THREADS);
  const float* xf = (const float*)x;
  float* of = (float*)out;
  const int* sp = (const int*)shift_ptr;
  cudaStream_t st = (cudaStream_t)stream;
  if (!accumulate) {
    roll_last_kernel<<<rows, WIDTH, 0, st>>>(xf, of, shift, sp, step_mod ? (n_iter - 1) & (step_mod - 1) : 0);
    return (int)cudaGetLastError();
  }
  // the distinct shifts: i % step_mod, and mod 128 no more than 128 of them
  switch (step_mod == 0 ? 1 : step_mod < WIDTH ? step_mod : WIDTH) {
    case 1: roll_chain_kernel<1><<<grid, CHAIN_THREADS, 0, st>>>(xf, of, n, shift, sp, n_iter); break;
    case 2: roll_chain_kernel<2><<<grid, CHAIN_THREADS, 0, st>>>(xf, of, n, shift, sp, n_iter); break;
    case 4: roll_chain_kernel<4><<<grid, CHAIN_THREADS, 0, st>>>(xf, of, n, shift, sp, n_iter); break;
    case 8: roll_chain_kernel<8><<<grid, CHAIN_THREADS, 0, st>>>(xf, of, n, shift, sp, n_iter); break;
    case 16: roll_chain_kernel<16><<<grid, CHAIN_THREADS, 0, st>>>(xf, of, n, shift, sp, n_iter); break;
    case 32: roll_chain_kernel<32><<<grid, CHAIN_THREADS, 0, st>>>(xf, of, n, shift, sp, n_iter); break;
    case 64: roll_chain_kernel<64><<<grid, CHAIN_THREADS, 0, st>>>(xf, of, n, shift, sp, n_iter); break;
    default: roll_chain_kernel<128><<<grid, CHAIN_THREADS, 0, st>>>(xf, of, n, shift, sp, n_iter); break;
  }
  return (int)cudaGetLastError();
}

int probe_vector_chain(const void* x, void* out, int n, int n_iter, void* stream) {
  if (n <= 0 || n_iter < 0) return (int)cudaErrorInvalidValue;
  vector_chain_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n, n_iter);
  return (int)cudaGetLastError();
}

// a (m, k), b (k, n) f32 -> out (m, n) f32; m % 32 == 0, n % 16 == 0, k % 4 == 0.
// The launch plan (tile_m, tile_n, k_slice, rep_groups, grid, smem) is
// roll.product_plan's; partials holds k_slices * rep_groups (m, n) float32
// partials (may be null when that is 1). A plan that does not fit the shapes
// is refused.
int probe_matmul_f32(const void* a, const void* b, void* out, void* partials, int m, int k, int n, int reps,
                     int tile_m, int tile_n, int k_slice, int rep_groups, int grid, int smem, void* stream) {
  if (m <= 0 || m % 32 || k <= 0 || k % 4 || n <= 0 || n % 16 || reps < 1) return (int)cudaErrorInvalidValue;
  const bool wide = tile_n == F32Wide::BN;
  if (!wide && tile_n != F32Narrow::BN) return (int)cudaErrorInvalidValue;
  const int wk = wide ? F32Wide::WK : F32Narrow::WK;
  if (k_slice % (F32_UNROLL * wk)) return (int)cudaErrorInvalidValue;
  const int stage = k_slice * (PROD_TILE_M + tile_n), red = (wk - 1) * PROD_TILE_M * tile_n;
  ProductGrid pg;
  if (!plan_ok(m, k, n, reps, tile_m, tile_n, k_slice, rep_groups, grid, smem, 4 * (stage > red ? stage : red), &pg))
    return (int)cudaErrorInvalidValue;
  if (wide)
    return (int)launch_product(matmul_f32_kernel<F32Wide>, F32Wide::THREADS, smem, grid, a, b, out, partials, m, k,
                               n, pg, (cudaStream_t)stream);
  return (int)launch_product(matmul_f32_kernel<F32Narrow>, F32Narrow::THREADS, smem, grid, a, b, out, partials, m, k,
                             n, pg, (cudaStream_t)stream);
}

// a (m, k), b (k, n) bf16 -> out (m, n) f32; m, k, n multiples of 16; the
// plan and partials as above.
int probe_matmul_bf16(const void* a, const void* b, void* out, void* partials, int m, int k, int n, int reps,
                      int tile_m, int tile_n, int k_slice, int rep_groups, int grid, int smem, void* stream) {
  if (m <= 0 || m % 16 || k <= 0 || k % 16 || n <= 0 || n % 16 || reps < 1) return (int)cudaErrorInvalidValue;
  const bool wide = tile_n == 128;
  if (!wide && tile_n != 16) return (int)cudaErrorInvalidValue;
  const int ks = wide ? Bf16Tiles<128>::KS : Bf16Tiles<16>::KS;
  ProductGrid pg;
  if (k_slice != ks || !plan_ok(m, k, n, reps, tile_m, tile_n, k_slice, rep_groups, grid, smem, 2 * ks * tile_n, &pg))
    return (int)cudaErrorInvalidValue;
  return (int)launch_product(wide ? matmul_bf16_wgmma_kernel<128> : matmul_bf16_wgmma_kernel<16>, BF16_THREADS, smem,
                             grid, a, b, out, partials, m, k, n, pg, (cudaStream_t)stream);
}

// x, out: (rows, 128) f32.
int probe_argmax_extract(const void* x, void* out, int rows, int rounds, void* stream) {
  if (rows <= 0 || rounds < 0) return (int)cudaErrorInvalidValue;
  argmax_extract_kernel<<<blocks_for(rows, ROW_WARPS), ROW_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, rows, rounds);
  return (int)cudaGetLastError();
}

// x, out: n f32; the trip count is *trip_ptr (i32 on the card).
int probe_dynamic_trip(const void* x, void* out, int n, const void* trip_ptr, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  dynamic_trip_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n,
                                                                            (const int*)trip_ptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
