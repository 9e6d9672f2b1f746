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
// 989 TFLOP/s. At this size the launch itself (a few us) is the real floor.
//
// What the design does about it: each block splits vcat into bf16 hi and lo
// arrays in shared memory (4 KB); each warp owns 8 output columns and walks K
// in steps of 16 with mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate),
// rows padded from 12 to 16 with zeros. B fragments are 32-bit loads straight
// from m, which is (N, K) row-major: exactly the "col" layout mma.sync wants
// for B, so the transposed-RHS product needs no transpose. wgmma and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 8;
constexpr int BCHUNK = 128;
constexpr int K = R * BCHUNK;
constexpr int N2 = 12;
constexpr int WARPS = 8;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row `row` of the padded 16-row A operand, as 32 bits holding columns k, k+1.
__device__ __forceinline__ uint32_t a_pair(const __nv_bfloat16* hi, const __nv_bfloat16* lo, int row, int k) {
  if (row >= N2) return 0u;
  const __nv_bfloat16* src = (row & 1) ? lo : hi;
  return *reinterpret_cast<const uint32_t*>(src + k);
}

__global__ void __launch_bounds__(WARPS * 32) dot_rhs_t_kernel(const float* __restrict__ v, int v_cols,
                                                               const __nv_bfloat16* __restrict__ m, int n,
                                                               float* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 hi[K];
  __shared__ __align__(16) __nv_bfloat16 lo[K];
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const float x = v[(i / BCHUNK) * v_cols + i % BCHUNK];
    const __nv_bfloat16 h = __float2bfloat16_rn(x);
    hi[i] = h;
    lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = (blockIdx.x * WARPS + warp) * 8;
  if (n0 >= n) return;
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* mrow = m + (size_t)(n0 + g) * K;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a[4] = {a_pair(hi, lo, g, k0 + 2 * t), a_pair(hi, lo, g + 8, k0 + 2 * t),
                           a_pair(hi, lo, g, k0 + 2 * t + 8), a_pair(hi, lo, g + 8, k0 + 2 * t + 8)};
    const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(mrow + k0 + 2 * t),
                           *reinterpret_cast<const uint32_t*>(mrow + k0 + 2 * t + 8)};
    mma_bf16_16816(c, a, b);
  }
  const int col = n0 + 2 * t;
  out[g * n + col] = c[0];
  out[g * n + col + 1] = c[1];
  if (g + 8 < N2) {
    out[(g + 8) * n + col] = c[2];
    out[(g + 8) * n + col + 1] = c[3];
  }
}

}  // namespace

// v: (8, v_cols) f32 with v_cols >= 128; m: (n, 1024) bf16, n a multiple of 8; out: (12, n) f32.
extern "C" int probe_dot_rhs_t(const void* v, int v_cols, const void* m, int n, void* out, void* stream) {
  if (v_cols < BCHUNK || n <= 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  const int blocks = (n / 8 + WARPS - 1) / WARPS;
  dot_rhs_t_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>((const float*)v, v_cols,
                                                                     (const __nv_bfloat16*)m, n, (float*)out);
  return (int)cudaGetLastError();
}
