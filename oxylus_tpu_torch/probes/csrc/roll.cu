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
//   movement. In fact bound by instruction issue: the script's 8 rows are one
//   block of 8 warps, 2 per scheduler, each issuing ~26 instructions per
//   iteration (4 shuffles, 8 selects, 4 adds, the shift's integer work).
// - vector_chain: 8 dependent float32 operations per element and iteration
//   (4 mul, 4 add/sub, no fused multiply-add under -fmad=false). Bound: 8 *
//   n * n_iter operations at 67 TFLOP/s (which counts an FMA as two), 0.24 us
//   for (8, 128) x 2000; in fact the latency of the dependent chain.
// - matmul_f32: acc += a (m, k) . b (k, n) repeated `reps` times in full
//   float32 by FFMA on the CUDA cores, as Mosaic's f32 dot; bound 2mkn*reps at
//   67 TFLOP/s. matmul_bf16: the same with bf16 operands on the tensor cores
//   by mma.sync.m16n8k16, float32 accumulation; bound at 989 TFLOP/s. Both
//   accumulate every repetition's product into the running sum directly, so
//   the additions run in another order than acc + (a . b); with integer sums
//   below 2^24 (the script's all-ones inputs) the result is exact either way.
// - argmax_extract: per 128-lane row, `rounds` times: the first maximum of the
//   score, out[idx] += 1 + round, score[idx] = -1, where score = x where
//   x mod 3 < 1 (floor mod, as jnp.remainder) else -1. Bound: bytes, 8 KB.
// - dynamic_trip: acc = sum of x over a trip count read from device memory
//   at run time; bound 37 * 1024 adds, 0.6 ns.
//
// What the design does about it: a 128-lane row lives in one warp, four values
// per thread (lane l holds lanes l, l+32, l+64, l+96), so a rotate by s =
// 32 qs + rs is four shfl.sync.idx by rs plus a register rotate by qs or
// qs + 1: no shared memory and no barrier. The register rotate is two stages
// of selects (written as `q == 0 ? y0 : q == 1 ? ...` it compiled to branch
// regions and cost 4x), and the shift is computed from i alone, so unrolled
// iterations overlap. The shuffle is volatile asm, so the compiler cannot
// hoist a loop-invariant rotate out of the chain: each iteration measures
// one. The chain can rotate through shared memory instead (via_smem). The
// same layout gives argmax by a shuffle tree. The
// vector chain is one thread per element. matmul_f32 gives each thread a 2 x 2
// output tile and reads float4 of a and float2 of b per 4 k from L1;
// matmul_bf16 gives each warp a 16 x 16 tile (two m16n8k16 products per k
// step), fragments loaded straight from global memory (a row-major for the
// "row" operand; b's (k, n) pairs packed from two 16-bit loads for "col").
// wgmma, TMA and shared-memory staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WIDTH = 128;
constexpr int ROW_WARPS = 8;  // rows per block for the one-warp-per-row kernels

int blocks_for(int n, int per) { return (n + per - 1) / per; }

__device__ __forceinline__ float shfl_idx(float v, int src) {
  float r;
  asm volatile("shfl.sync.idx.b32 %0, %1, %2, 0x1f, 0xffffffff;\n" : "=f"(r) : "f"(v), "r"(src));
  return r;
}

// v[q] holds lane `lane` + 32q of a 128-lane row; o = the row rolled by s in [0, 128):
// o at lane j is v at lane (j - s) mod 128. The register rotate o[q] = y[(q - r) & 3]
// is two stages of selects (by 1, then by 2), so it compiles to FSEL, not to branches.
__device__ __forceinline__ void roll128(const float (&v)[4], float (&o)[4], int s, int lane) {
  const int rs = s & 31;
  float y[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) y[q] = shfl_idx(v[q], (lane - rs) & 31);
  const int r = (lane >= rs ? s >> 5 : (s >> 5) + 1) & 3;
  const bool by1 = r & 1, by2 = r & 2;
  float z[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) z[q] = by1 ? y[(q + 3) & 3] : y[q];
#pragma unroll
  for (int q = 0; q < 4; ++q) o[q] = by2 ? z[(q + 2) & 3] : z[q];
}

// One warp per 128-lane row. Iteration i rolls by (base + (i & step_mask)) mod
// 128: no value carried from one iteration to the next but the sums, so the
// unrolled iterations' shuffles overlap. SMEM: the rotate goes through the
// warp's row in shared memory (store, __syncwarp, load rotated, __syncwarp;
// volatile, so every iteration does it) instead of shuffles. ACC: sum the
// rolls, else keep the last.
template <bool SMEM, bool ACC>
__global__ void __launch_bounds__(ROW_WARPS * 32) roll_chain_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                                    int rows, int shift, const int* shift_ptr,
                                                                    int n_iter, int step_mask) {
  __shared__ float staged[ROW_WARPS][WIDTH];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROW_WARPS + warp;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * WIDTH;
  volatile float* srow = staged[warp];
  float v[4], acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = xr[lane + 32 * q];
  const int base = ((shift_ptr ? *shift_ptr : shift) % WIDTH + WIDTH) % WIDTH;
#pragma unroll 8
  for (int i = 0; i < n_iter; ++i) {
    const int s = (base + (i & step_mask)) & (WIDTH - 1);
    float o[4];
    if (SMEM) {
#pragma unroll
      for (int q = 0; q < 4; ++q) srow[lane + 32 * q] = v[q];
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q] = srow[(lane + 32 * q - s) & (WIDTH - 1)];
      __syncwarp();
    } else {
      roll128(v, o, s, lane);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] = ACC ? acc[q] + o[q] : o[q];
  }
  float* outr = out + (size_t)row * WIDTH;
#pragma unroll
  for (int q = 0; q < 4; ++q) outr[lane + 32 * q] = acc[q];
}

template <bool SMEM>
cudaError_t launch_roll_chain(const float* x, float* out, int rows, int shift, const int* shift_ptr, int n_iter,
                              int step_mask, bool accumulate, cudaStream_t st) {
  const dim3 grid(blocks_for(rows, ROW_WARPS)), block(ROW_WARPS * 32);
  if (accumulate)
    roll_chain_kernel<SMEM, true><<<grid, block, 0, st>>>(x, out, rows, shift, shift_ptr, n_iter, step_mask);
  else
    roll_chain_kernel<SMEM, false><<<grid, block, 0, st>>>(x, out, rows, shift, shift_ptr, n_iter, step_mask);
  return cudaGetLastError();
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

// Block tile 32 x BN, thread tile 2 x 2: 16 * BN / 2 threads.
template <int BN>
__global__ void __launch_bounds__(16 * BN / 2) matmul_f32_kernel(const float* __restrict__ a,
                                                                 const float* __restrict__ b, float* __restrict__ out,
                                                                 int k, int n, int reps) {
  const int tx = threadIdx.x % (BN / 2), ty = threadIdx.x / (BN / 2);
  const int row = blockIdx.y * 32 + 2 * ty, col = blockIdx.x * BN + 2 * tx;
  const float* a0 = a + (size_t)row * k;
  const float* a1 = a0 + k;
  float c00 = 0.0f, c01 = 0.0f, c10 = 0.0f, c11 = 0.0f;
  for (int r = 0; r < reps; ++r) {
    for (int kk = 0; kk < k; kk += 4) {
      const float4 x0 = __ldg(reinterpret_cast<const float4*>(a0 + kk));
      const float4 x1 = __ldg(reinterpret_cast<const float4*>(a1 + kk));
      const float ra[2][4] = {{x0.x, x0.y, x0.z, x0.w}, {x1.x, x1.y, x1.z, x1.w}};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 y = __ldg(reinterpret_cast<const float2*>(b + (size_t)(kk + q) * n + col));
        c00 = __fmaf_rn(ra[0][q], y.x, c00);
        c01 = __fmaf_rn(ra[0][q], y.y, c01);
        c10 = __fmaf_rn(ra[1][q], y.x, c10);
        c11 = __fmaf_rn(ra[1][q], y.y, c11);
      }
    }
  }
  *reinterpret_cast<float2*>(out + (size_t)row * n + col) = make_float2(c00, c01);
  *reinterpret_cast<float2*>(out + (size_t)(row + 1) * n + col) = make_float2(c10, c11);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int MMA_WARPS = 4;

// Each warp one 16 x 16 output tile: two m16n8k16 products per k step.
__global__ void __launch_bounds__(MMA_WARPS * 32) matmul_bf16_kernel(const uint16_t* __restrict__ a,
                                                                     const uint16_t* __restrict__ b,
                                                                     float* __restrict__ out, int m, int k, int n,
                                                                     int reps) {
  const int tiles_n = n / 16;
  const int tile = blockIdx.x * MMA_WARPS + threadIdx.x / 32;
  if (tile >= (m / 16) * tiles_n) return;
  const int m0 = (tile / tiles_n) * 16, n0 = (tile % tiles_n) * 16;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const uint16_t* ar0 = a + (size_t)(m0 + g) * k + 2 * t;
  const uint16_t* ar1 = ar0 + (size_t)8 * k;
  float c[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  for (int r = 0; r < reps; ++r) {
    for (int k0 = 0; k0 < k; k0 += 16) {
      const uint32_t af[4] = {
          __ldg(reinterpret_cast<const uint32_t*>(ar0 + k0)), __ldg(reinterpret_cast<const uint32_t*>(ar1 + k0)),
          __ldg(reinterpret_cast<const uint32_t*>(ar0 + k0 + 8)),
          __ldg(reinterpret_cast<const uint32_t*>(ar1 + k0 + 8))};
      const uint16_t* bk = b + (size_t)(k0 + 2 * t) * n + n0 + g;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint16_t* bc = bk + nt * 8;
        const uint32_t bf[2] = {
            (uint32_t)__ldg(bc) | ((uint32_t)__ldg(bc + n) << 16),
            (uint32_t)__ldg(bc + (size_t)8 * n) | ((uint32_t)__ldg(bc + (size_t)9 * n) << 16)};
        mma_bf16_16816(c[nt], af, bf);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = n0 + nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(out + (size_t)(m0 + g) * n + col) = make_float2(c[nt][0], c[nt][1]);
    *reinterpret_cast<float2*>(out + (size_t)(m0 + g + 8) * n + col) = make_float2(c[nt][2], c[nt][3]);
  }
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
// are summed, else the last is written; via_smem: the rotate goes through
// shared memory.
int probe_roll_chain(const void* x, void* out, int rows, int shift, const void* shift_ptr, int n_iter, int step_mod,
                     int accumulate, int via_smem, void* stream) {
  if (rows <= 0 || n_iter < 1 || step_mod < 0 || (step_mod & (step_mod - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int step_mask = step_mod ? step_mod - 1 : 0;
  auto launch = via_smem ? launch_roll_chain<true> : launch_roll_chain<false>;
  return (int)launch((const float*)x, (float*)out, rows, shift, (const int*)shift_ptr, n_iter, step_mask,
                     accumulate != 0, (cudaStream_t)stream);
}

int probe_vector_chain(const void* x, void* out, int n, int n_iter, void* stream) {
  if (n <= 0 || n_iter < 0) return (int)cudaErrorInvalidValue;
  vector_chain_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>((const float*)x, (float*)out, n, n_iter);
  return (int)cudaGetLastError();
}

// a (m, k), b (k, n) f32 -> out (m, n) f32; m % 32 == 0, n % 16 == 0, k % 4 == 0.
int probe_matmul_f32(const void* a, const void* b, void* out, int m, int k, int n, int reps, void* stream) {
  if (m <= 0 || m % 32 || k <= 0 || k % 4 || n <= 0 || n % 16 || reps < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n % 32 == 0)
    matmul_f32_kernel<32><<<dim3(n / 32, m / 32), 16 * 16, 0, s>>>((const float*)a, (const float*)b, (float*)out, k, n,
                                                                   reps);
  else
    matmul_f32_kernel<16><<<dim3(n / 16, m / 32), 16 * 8, 0, s>>>((const float*)a, (const float*)b, (float*)out, k, n,
                                                                  reps);
  return (int)cudaGetLastError();
}

// a (m, k), b (k, n) bf16 -> out (m, n) f32; m, k, n multiples of 16.
int probe_matmul_bf16(const void* a, const void* b, void* out, int m, int k, int n, int reps, void* stream) {
  if (m <= 0 || m % 16 || k <= 0 || k % 16 || n <= 0 || n % 16 || reps < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (m / 16) * (n / 16);
  matmul_bf16_kernel<<<blocks_for(tiles, MMA_WARPS), MMA_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)a, (const uint16_t*)b, (float*)out, m, k, n, reps);
  return (int)cudaGetLastError();
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
