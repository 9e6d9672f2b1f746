// bf16 hi/lo split with a transposed-RHS tensor-core product for Hopper (sm_90a).
//
// Replaces the TPU probe kernel scripts/probe_dot_rhs_t.py::kernel (:21,
// launched by pallas_call at :50). Plain PyTorch version:
// oxylus_tpu_torch/probes/dot_rhs_t.py::dot_rhs_t_reference.
//
// What it computes: vcat = v[r, 0:128] concatenated over the 8 rows of v (K =
// 1024 values), hi = bf16(vcat), lo = bf16(vcat - hi); the 12 rows hi, lo, hi,
// lo, ... times m^T with float32 accumulation: out (12, N) = rows (12, K) .
// m (N, K)^T. The TPU kernel stages the rows in SMEM scratch and concatenates
// lane slices because of its (8, 128) layout; here the split is done as the
// rows are loaded.
//
// What bounds it on the card: bytes. m is 768 KB of bf16 (N = 384), v's used
// part 4 KB, out 18 KB: 0.24 us at 3.35 TB/s; the 9.4 MFLOP take 0.01 us at
// 989 TFLOP/s. Replayed in a CUDA graph, m stays in the 50 MB L2, so the time
// is latency: the launch, one round trip for m, the chain of products and the
// sum of the K-slices. The first port ran 6 blocks whose warps each walked K
// in 64 dependent mma.sync steps, each waiting on its own 32-bit loads of m.
//
// The design: a block of 8 warps per 8 columns of out (N / 8 blocks); warp s
// takes K-slice s (v's row s, 128 values) in 8 mma.sync.m16n8k16 steps
// straight from registers. Within each 32-wide block of K the two steps' k
// order is permuted (the same permutation on both operands, so each step still
// sums 16 exact products of matching pairs): lane (g, t) then holds K values
// 8t..8t+7 of the block, one 16-byte load of m's row and two of v, all issued
// before the first product. The 8 warps' partial 16 x 8 tiles are added
// through shared memory in slice order, so every run gives the same bits.
// (A wgmma.m64n16k16 design in clusters of 8 blocks, summing the slices
// through distributed shared memory, measured 1.5x slower: PERF.md, row 9a.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;
constexpr int BCHUNK = 128;
constexpr int K = R * BCHUNK;
constexpr int N2 = 12;
constexpr int MMA_WARPS = R;  // one per K-slice

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo_k, __nv_bfloat16 hi_k) {
  return (uint32_t)__bfloat16_as_ushort(lo_k) | ((uint32_t)__bfloat16_as_ushort(hi_k) << 16);
}

// Row `row` of the split (even: hi, odd: lo, 12 and past: 0) at two values x0, x1 (k, k+1).
__device__ __forceinline__ uint32_t split_pair(float x0, float x1, int row) {
  if (row >= N2) return 0u;
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  if (!(row & 1)) return pack_bf16(h0, h1);
  return pack_bf16(__float2bfloat16_rn(x0 - __bfloat162float(h0)), __float2bfloat16_rn(x1 - __bfloat162float(h1)));
}

// 8 consecutive floats of a row of v; vector loads where the row allows them
__device__ __forceinline__ void load8(const float* p, bool vec, float (&x)[8]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = p[q];
  }
}

// 8 consecutive bf16 of a row of m as 16 bytes; one vector load where m is 16-byte aligned
__device__ __forceinline__ uint4 load_m8(const __nv_bfloat16* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = (uint32_t)h[2 * q] | ((uint32_t)h[2 * q + 1] << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(MMA_WARPS * 32) dot_mma_kernel(const float* __restrict__ v, int v_cols, bool v_vec,
                                                                const __nv_bfloat16* __restrict__ m, bool m_vec,
                                                                int n, float* __restrict__ out) {
  __shared__ float4 part[MMA_WARPS][32];
  const int slice = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * 8;
  const __nv_bfloat16* mrow = m + (size_t)(n0 + g) * K + slice * BCHUNK;
  const float* vrow = v + (size_t)slice * v_cols;
  uint4 bq[BCHUNK / 32];
  float x[BCHUNK / 32][8];
#pragma unroll
  for (int q = 0; q < BCHUNK / 32; ++q) {  // every load of the slice first
    bq[q] = load_m8(mrow + 32 * q + 8 * t, m_vec);
    load8(vrow + 32 * q + 8 * t, v_vec, x[q]);
  }
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < BCHUNK / 32; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // step h of the block: K values 8t + 4h .. 8t + 4h + 3
      const float* xh = x[q] + 4 * h;
      const uint32_t a[4] = {split_pair(xh[0], xh[1], g), split_pair(xh[0], xh[1], g + 8),
                             split_pair(xh[2], xh[3], g), split_pair(xh[2], xh[3], g + 8)};
      const uint32_t b[2] = {h ? bq[q].z : bq[q].x, h ? bq[q].w : bq[q].y};
      mma_bf16_16816(c, a, b);
    }
  }
  part[slice][lane] = make_float4(c[0], c[1], c[2], c[3]);
  __syncthreads();
  if (slice != 0) return;
  float4 sum = part[0][lane];
#pragma unroll
  for (int q = 1; q < MMA_WARPS; ++q) {
    const float4 p = part[q][lane];
    sum.x += p.x; sum.y += p.y; sum.z += p.z; sum.w += p.w;
  }
  const int col = n0 + 2 * t;  // fragment: rows g (x, y) and g + 8 (z, w), columns 2t, 2t + 1
  out[(size_t)g * n + col] = sum.x;
  out[(size_t)g * n + col + 1] = sum.y;
  if (g + 8 < N2) {
    out[(size_t)(g + 8) * n + col] = sum.z;
    out[(size_t)(g + 8) * n + col + 1] = sum.w;
  }
}

}  // namespace

// v: (8, v_cols) f32 with v_cols >= 128; m: (n, 1024) bf16, n a multiple of 8; out: (12, n) f32.
extern "C" int probe_dot_rhs_t(const void* v, int v_cols, const void* m, int n, void* out, void* stream) {
  if (v_cols < BCHUNK || n <= 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  const bool v_vec = v_cols % 4 == 0 && (uintptr_t)v % 16 == 0, m_vec = (uintptr_t)m % 16 == 0;
  dot_mma_kernel<<<n / 8, MMA_WARPS * 32, 0, (cudaStream_t)stream>>>((const float*)v, v_cols, v_vec,
                                                                    (const __nv_bfloat16*)m, m_vec, n, (float*)out);
  return (int)cudaGetLastError();
}
