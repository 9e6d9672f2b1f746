// The hi/lo plane sum of the TPU rasters and the conservative region reject
// built on it, shared by raster_depth.cu and raster_tiles.cu. Both kernels
// evaluate a plane the same way: a, b and the tile-local constant
// c' = (c + x0*a) + y0*b, each split into bf16 hi and lo parts, summed at
// tile-local centres k + 0.5 (k < tile <= 64) in the TPU kernel's order.

#pragma once

#include <cuda_bf16.h>
#include <cmath>

// x rounded to bf16 (nearest even) and back: the hi part of the hi/lo split
static __device__ __forceinline__ float bf16_hi(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The plane sum in the TPU kernel's order. Its six products are exact (bf16
// parts times centres k + 0.5 with k < 64 need at most 15 bits); only the five
// additions round.
static __device__ __forceinline__ float plane(float ah, float bh, float ch, float al, float bl, float cl, float x,
                                              float y) {
  return ((((ah * x + bh * y) + ch) + al * x) + bl * y) + cl;
}

// The reject's margin. Five rounded additions of six terms err by at most
// g5 * T with g5 = 5u / (1 - 5u), u = 2^-24, and T the sum of the terms'
// magnitudes, here bounded over the whole tile (x, y <= span = tile - 0.5):
// T = (|ah| + |al| + |bh| + |bl|) * span + |ch| + |cl|. With E the exact
// affine function of the six parts, a centre p of a region and its corner
// centres c: e(p) <= E(p) + g5*T <= max_c E(c) + g5*T <= max_c e(c) + 2*g5*T,
// since an affine function takes its largest value over a rectangle at a
// corner. So max_c e(c) < -2*g5*T proves e(p) < 0 at every centre. The margin
// 2^-20 * T = 16u * T exceeds 2*g5*T = 10u/(1 - 5u) * T with room for the
// rounding of T itself (a few u); the added 2^-126 covers what underflow can
// lose (at most 2^-150 per operation, 11 operations per evaluation). An
// infinite or NaN margin rejects nothing. The default span is a 64-px
// tile's, which bounds the terms of any smaller tile too.
static __device__ __forceinline__ float reject_margin(float ah, float al, float bh, float bl, float ch, float cl,
                                                      float span = 63.5f) {
  return ((fabsf(ah) + fabsf(al) + fabsf(bh) + fabsf(bl)) * span + fabsf(ch) + fabsf(cl)) * 0x1p-20f + 0x1p-126f;
}

// The reject test of one plane at a rectangle's four corner centres: e0 e1 e2
// zn need >= 0 somewhere for a cover, wd needs > 0 somewhere. `mg` is minus
// the margin; an infinite or NaN one rejects nothing.
static __device__ __forceinline__ bool plane_dead(bool is_wd, float mg, float ah, float bh, float ch, float al,
                                                  float bl, float cl, float x0, float x1, float y0, float y1) {
  const float e00 = plane(ah, bh, ch, al, bl, cl, x0, y0), e01 = plane(ah, bh, ch, al, bl, cl, x1, y0);
  const float e10 = plane(ah, bh, ch, al, bl, cl, x0, y1), e11 = plane(ah, bh, ch, al, bl, cl, x1, y1);
  return isfinite(mg) && (is_wd ? (e00 <= mg && e01 <= mg && e10 <= mg && e11 <= mg)
                                : (e00 < mg && e01 < mg && e10 < mg && e11 < mg));
}
