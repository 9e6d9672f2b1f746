// Hierarchical-Z min pyramid for Hopper (sm_90a).
//
// Replaces the TPU kernels oxylus_tpu/ops/hiz.py::_spd_tile_kernel (:103) and
// _spd_tail_kernel (:110), launched by build_hiz_pallas (:141, :161). Plain
// PyTorch version: oxylus_tpu_torch/ops/hiz.py::hiz_reference.
//
// What it computes: the depth padded with 0 to (hp, wp), multiples of 128x512
// (level 0, returned too), then levels that halve it, each output the min of
// its 2x2 block, until the smaller side is 1 or there are n_levels levels. A
// level past 7 can have an odd size; its missing partner reads 0 (the TPU
// kernel's selection matmul gives a zero row there), so the last row or column
// of an odd level is 0. Min is exact: the result equals the plain version's
// bit for bit, in whatever order the blocks finish.
//
// What bounds it on the card: bytes. It reads the depth once (8.3 MB at
// 1080p), writes the padded base (9.4 MB) and the levels above it (a third of
// that); ~6 us at 3.35 TB/s.
//
// What the design does about it (the first port ran a pad copy, a 36-CTA
// tiled kernel for levels 1-2 and a one-CTA tail for the rest): one launch.
// - One CTA of 256 threads per 64x64 block of the padded base (576 at 1080p):
//   it reads the unpadded depth (0 past its edge), writes its block of the
//   base, and reduces the block in shared memory through levels 1-6, writing
//   each. Since hp % 128 == 0 and wp % 512 == 0, levels 1-7 halve exactly.
// - The last CTA to finish reduces the tail: each CTA counts itself in a
//   device-scope counter after a __threadfence(), so the one that reads
//   (blocks - 1) knows every block's levels are written. It reads level 6
//   through L2 (__ldcg), walks the remaining levels in shared memory with the
//   zero-partner rule, and resets the counter (a zeroed int32 the wrapper
//   keeps per device) for the next call.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 64;        // base texels a side per CTA
constexpr int BLOCK_LEVELS = 6;  // levels a CTA reduces: 64 -> 1
constexpr int THREADS = 256;
constexpr int Q = BLOCK / 2;     // level-1 texels a side per CTA
constexpr int BUF = 4096;        // floats per shared buffer (levels and tail)
static_assert(Q * Q <= BUF, "level 1 fits a buffer");

__global__ void __launch_bounds__(THREADS) hiz_kernel(const float* __restrict__ depth, int h, int w, int hp, int wp,
                                                     int n_levels, float* __restrict__ base, float* __restrict__ out,
                                                     unsigned* __restrict__ counter) {
  __shared__ float s_a[BUF], s_b[BUF];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * BLOCK, y0 = blockIdx.y * BLOCK;
  const int lv_block = min(BLOCK_LEVELS, n_levels - 1);

  // ---- level 0 and level 1: a thread per 2x2 quad, lanes along x ----
  for (int k = 0; k < Q * Q / THREADS; ++k) {
    const int qy = tid / Q + k * (THREADS / Q), qx = tid % Q;
    const int gy = y0 + 2 * qy, gx = x0 + 2 * qx;
    float v[2][2];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx)
        v[dy][dx] = (gy + dy < h && gx + dx < w) ? depth[(size_t)(gy + dy) * w + gx + dx] : 0.0f;
      *reinterpret_cast<float2*>(base + (size_t)(gy + dy) * wp + gx) = make_float2(v[dy][0], v[dy][1]);
    }
    const float m = fminf(fminf(v[0][0], v[0][1]), fminf(v[1][0], v[1][1]));
    s_a[qy * Q + qx] = m;
    out[(size_t)(y0 / 2 + qy) * (wp / 2) + x0 / 2 + qx] = m;
  }
  __syncthreads();

  // ---- levels 2 .. lv_block of the block, in shared memory ----
  float* src = s_a;
  float* dst = s_b;
  size_t off = 0;  // level lv - 1's offset in `out`
  int side = Q;
  for (int lv = 2; lv <= lv_block; ++lv) {
    off += (size_t)(hp >> (lv - 1)) * (wp >> (lv - 1));
    const int so = side / 2, wk = wp >> lv;
    for (int o = tid; o < so * so; o += THREADS) {
      const int oy = o / so, ox = o % so;
      const float* p = src + (2 * oy) * side + 2 * ox;
      const float m = fminf(fminf(p[0], p[1]), fminf(p[side], p[side + 1]));
      dst[o] = m;
      out[off + (size_t)((y0 >> lv) + oy) * wk + (x0 >> lv) + ox] = m;
    }
    __syncthreads();
    float* tmp = src;
    src = dst;
    dst = tmp;
    side = so;
  }

  // ---- the last CTA to finish walks the tail ----
  __threadfence();  // every thread's writes are visible device-wide ...
  __syncthreads();  // ... before the block counts itself
  if (tid == 0) s_last = atomicAdd(counter, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  int hk = hp >> lv_block, wk = wp >> lv_block;
  const float* in_g = out + off;  // level lv_block, written by every CTA
  size_t off_out = off + (size_t)hk * wk;
  // every tail level fits a buffer once the first does (the sizes only shrink)
  const bool in_smem = ((hk + 1) / 2) * ((wk + 1) / 2) <= BUF;
  const float* in_s = nullptr;
  float* out_s = s_a;
  for (int lv = lv_block + 1; lv < n_levels; ++lv) {
    const int ho = (hk + 1) / 2, wo = (wk + 1) / 2;
    for (int o = tid; o < ho * wo; o += THREADS) {
      const int i = o / wo, j = o % wo;
      const bool has_c = 2 * j + 1 < wk, has_r = 2 * i + 1 < hk;
      const int p = (2 * i) * wk + 2 * j;
      auto ld = [&](int idx) { return in_s ? in_s[idx] : __ldcg(in_g + idx); };
      const float v00 = ld(p);
      const float v01 = has_c ? ld(p + 1) : 0.0f;
      const float v10 = has_r ? ld(p + wk) : 0.0f;
      const float v11 = (has_c && has_r) ? ld(p + wk + 1) : 0.0f;
      const float m = fminf(fminf(v00, v01), fminf(v10, v11));
      out[off_out + o] = m;
      if (in_smem) out_s[o] = m;
    }
    __syncthreads();
    in_g = out + off_out;
    off_out += (size_t)ho * wo;
    hk = ho;
    wk = wo;
    if (in_smem) {
      in_s = out_s;
      out_s = out_s == s_a ? s_b : s_a;
    }
  }
  if (tid == 0) *counter = 0u;  // every CTA has counted itself
}

}  // namespace

// depth: (h, w); base: (hp, wp) padded level 0; out: levels 1 .. n_levels-1
// back to back; counter: one zeroed unsigned int, left zeroed. Calls that share
// a counter must run one after another (one stream).
extern "C" int hiz_build(const void* depth, int h, int w, int hp, int wp, int n_levels, void* base, void* out,
                         void* counter, void* stream) {
  if (h <= 0 || w <= 0 || hp < h || wp < w || hp % 128 != 0 || wp % 512 != 0 || n_levels < 2)
    return (int)cudaErrorInvalidValue;
  hiz_kernel<<<dim3(wp / BLOCK, hp / BLOCK), THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)depth, h, w, hp, wp, n_levels, (float*)base, (float*)out, (unsigned*)counter);
  return (int)cudaGetLastError();
}
