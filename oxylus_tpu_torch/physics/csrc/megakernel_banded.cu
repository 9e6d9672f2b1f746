// Rank-banded rigid-body substeps for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by `oxylus_tpu_torch/_build.py`.
//
// Replaces the TPU kernel `oxylus_tpu/physics/megakernel_banded.py::_banded_kernel`
// (launched by `megakernel_substeps_banded`). Same contract, written from what
// the TPU kernel computes rather than its (128, 256) VMEM chunk × slab blocks:
// bodies arrive sorted by slab rank, and pair (row a, column b = a + d) is live
// only for 1 <= d <= BAND = 128, each unordered pair once, the row side taking
// -j and the column side +j. Per substep: gravity, rotations, AABBs; every
// `geom_every` substeps the pair geometry (AABB test, the SAT manifold of
// `compact_sat.cuh`, depth and Baumgarte-bias caches, per-body pair counts),
// otherwise a bias refresh from the drift since the last SAT; the 4 analytic
// hub planes; mass-split effective masses; with `warm > 0` a warm pass and
// `iterations` accumulated-impulse sweeps over bf16 pair λ caches (stored with
// __float2bfloat16_rn, as the TPU kernel's LAM_DT), else `iterations` cold
// projected-Jacobi sweeps; optional sleeping (every substep, a substep skipped
// when every movable body sleeps); integration.
//
// Design. The pair space is kept as (d, a) planes, field-major: pair index
// (d - 1) * B + a, so a warp's threads read neighbouring bodies and
// neighbouring partners. Each pass of the substep is one launch, one thread
// per pair or per body; the substep loop runs in C, so a 60-substep call is
// one Python call. A sweep's pair threads read one velocity snapshot and
// write their impulse and both torques; then one thread per body sums its
// row side over d ascending and its column side over the rows that pair with
// it, chunk by chunk (128-row chunks, in chunk order, as the TPU kernel adds
// its slabs), so no float atomics are used and every run gives the same
// bits. Pairs that are not live (AABBs apart, or past the last rank) are
// skipped: their impulse is exactly zero in the TPU kernel. The last chunk's
// clamped slab (offset B - 256) changes where the TPU kernel stores a pair,
// not which pairs are live, so it needs nothing here.
//
// What bounds it on the card: at the flagship size (B = 1024) a substep
// touches ~21 MB of pair scratch that stays in L2, so the work is small and
// latency-bound: 4 or 5 + 2 × (iterations + 1) dependent launches per substep
// (12 or 13 in the bench's configuration) and the per-body sums' serial loops
// over 128 partners dominate. Geometry in shared memory, one persistent launch per call and
// CUDA graphs are later work.
//
// Built with -fmad=false: every product and sum rounds on its own, as the plain
// PyTorch version's separate tensor ops do, so the two differ only where sums
// are taken in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_sat.cuh"

namespace {  // private to this file: the compact kernel has kernels of the same names

#define BAND 128
#define BCHUNK 128
#define N_PLANE 4
#define PLANE_SC 16
#define N_SLOT 4
#define NPK (N_PLANE * N_SLOT)
#define N_LAM 7
#define N_PGEO 27
#define N_PIMP 9
#define N_PGP 9
#define TPB 128

// per-body input rows (see `megakernel_compact._input_rows`)
enum {
  I_P = 0, I_V = 3, I_W = 6, I_Q = 9, I_INVM = 13, I_IM3 = 14, I_H = 17, I_RAD = 20, I_HLEN = 21,
  I_FRIC = 22, I_GRAV = 24, I_DOF = 25, I_BOX = 28, I_DYN = 29, I_MOV = 30, I_ACT = 31,
  I_SLEEP0 = 32, I_TIMER0 = 33, I_REFF2 = 34, I_CANSLEEP = 35,
};
// pair geometry fields, each BAND × B: the normal, then per slot k at
// G_SLOT + 6k: lever arm (3), 1/kn, bias, depth at the last SAT (-1e30: pair
// not live, so slot 0's depth marks the live pairs)
enum { G_N = 0, G_SLOT = 3 };
// plane geometry fields, each NPK × B
enum { P_R = 0, P_IKN = 3, P_BIAS = 4, P_N = 5, P_MU = 8 };

struct Ws {
  float *st;       // 13 × B: pos, linvel, angvel, quat
  float *rot;      // 9 × B row-major rotation
  float *eh;       // 3 × B AABB half extents (+margin)
  float *ca;       // 3 × B capsule half-segment
  float *ime;      // 4 × B mass-split inverse mass / inertia
  float *p0;       // 3 × B positions at the last SAT
  float *paircnt, *slp, *tmr, *pusher, *moving;  // B each
  float *pgeo;     // N_PGEO × BAND × B
  float *pimp;     // N_PIMP × BAND × B: j, torque_a, torque_b
  float *pgp;      // N_PGP × NPK × B
  float *plam;     // 4 × NPK × B
  int *gate;       // 1: some movable body awake this substep (sleep mode)
  __nv_bfloat16 *lam;  // N_LAM × BAND × B
};

size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

size_t carve(Ws* w, char* base, int b_) {
  size_t off = 0;
  const size_t b = b_, pb = size_t(BAND) * b_, qb = size_t(NPK) * b_;
  auto take = [&](size_t bytes) { char* p = base ? base + off : nullptr; off = align_up(off + bytes); return p; };
  w->st = (float*)take(13 * b * 4);
  w->rot = (float*)take(9 * b * 4);
  w->eh = (float*)take(3 * b * 4);
  w->ca = (float*)take(3 * b * 4);
  w->ime = (float*)take(4 * b * 4);
  w->p0 = (float*)take(3 * b * 4);
  w->paircnt = (float*)take(b * 4);
  w->slp = (float*)take(b * 4);
  w->tmr = (float*)take(b * 4);
  w->pusher = (float*)take(b * 4);
  w->moving = (float*)take(b * 4);
  w->pgeo = (float*)take(N_PGEO * pb * 4);
  w->pimp = (float*)take(N_PIMP * pb * 4);
  w->pgp = (float*)take(N_PGP * qb * 4);
  w->plam = (float*)take(4 * qb * 4);
  w->gate = (int*)take(4);
  w->lam = (__nv_bfloat16*)take(N_LAM * pb * 2);
  return off;
}

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

#define GATED if (w.gate && *w.gate == 0) return;
#define BODY_THREAD                                     \
  const int a = blockIdx.x * blockDim.x + threadIdx.x; \
  if (a >= b) return;
// pair (a, a + d); threads past the last rank return
#define PAIR_THREAD                                       \
  const int idx = blockIdx.x * blockDim.x + threadIdx.x; \
  if (idx >= BAND * b) return;                           \
  const int a = idx % b, d = idx / b + 1, j = a + d;     \
  if (j >= b) return;
#define LIVE(w, idx, pb) ((w).pgeo[(G_SLOT + 5) * (pb) + (idx)] > -1e29f)

__global__ void k_init(const float* __restrict__ rows, Ws w, int b) {
  BODY_THREAD
  for (int f = 0; f < 13; ++f) w.st[f * b + a] = rows[f * b + a];
  w.slp[a] = rows[I_SLEEP0 * b + a];
  w.tmr[a] = rows[I_TIMER0 * b + a];
  for (int f = 0; f < 4 * NPK; ++f) w.plam[size_t(f) * b + a] = 0.f;
  for (int f = 0; f < N_LAM * BAND; ++f) w.lam[size_t(f) * b + a] = __float2bfloat16_rn(0.f);
}

__global__ void k_awake(const float* __restrict__ rows, Ws w, int b) {
  BODY_THREAD
  if (rows[I_MOV * b + a] * (1.f - w.slp[a]) > 0.5f) atomicOr(w.gate, 1);
}

__global__ void k_pre(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, int b, int sleep) {
  BODY_THREAD GATED
  const float dt = sc[0], margin = sc[6];
  float grav_dt = rows[I_GRAV * b + a] * rows[I_DYN * b + a] * dt;
  if (sleep) grav_dt = grav_dt * (1.f - w.slp[a]);
  for (int c = 0; c < 3; ++c) w.st[(I_V + c) * b + a] = w.st[(I_V + c) * b + a] + sc[1 + c] * grav_dt;
  const float qx = w.st[9 * b + a], qy = w.st[10 * b + a], qz = w.st[11 * b + a], qw = w.st[12 * b + a];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz, xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float r[9] = {1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy),
                      2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx),
                      2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)};
  for (int k = 0; k < 9; ++k) w.rot[k * b + a] = r[k];
  const bool box = rows[I_BOX * b + a] > 0.5f;
  const float rad = rows[I_RAD * b + a], hlen = rows[I_HLEN * b + a];
  const float lh[3] = {box ? rows[I_H * b + a] : rad, box ? rows[(I_H + 1) * b + a] : rad + hlen,
                       box ? rows[(I_H + 2) * b + a] : rad};
  for (int k = 0; k < 3; ++k) {
    w.eh[k * b + a] = fabsf(r[3 * k]) * lh[0] + fabsf(r[3 * k + 1]) * lh[1] + fabsf(r[3 * k + 2]) * lh[2] + margin;
    w.ca[k * b + a] = r[3 * k + 1] * hlen;
  }
}

__device__ __forceinline__ void load_body(const float* __restrict__ rows, const Ws& w, int b, int i, Body& B) {
  for (int k = 0; k < 9; ++k) B.r[k / 3][k % 3] = w.rot[k * b + i];
  for (int c = 0; c < 3; ++c) { B.h[c] = rows[(I_H + c) * b + i]; B.ca[c] = w.ca[c * b + i]; }
  B.rad = rows[I_RAD * b + i];
  B.box = rows[I_BOX * b + i];
}

// Pair geometry at a rebuild: the AABB test, then for live pairs the SAT
// manifold, depth and bias caches; other pairs get depth and bias -1e30.
__global__ void k_geom(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, int b) {
  PAIR_THREAD GATED
  const size_t pb = size_t(BAND) * b;
  float dc[3];
  bool live = true;
  for (int c = 0; c < 3; ++c) {
    dc[c] = w.st[c * b + j] - w.st[c * b + a];
    live = live && (fabsf(dc[c]) <= w.eh[c * b + a] + w.eh[c * b + j]);
  }
  live = live && ((rows[I_DYN * b + a] + rows[I_DYN * b + j]) > 0.5f) &&
         ((rows[I_ACT * b + a] * rows[I_ACT * b + j]) > 0.5f);
  float* g = w.pgeo;
  if (!live) {
    for (int k = 0; k < N_SLOT; ++k) {
      g[(G_SLOT + 6 * k + 4) * pb + idx] = -1e30f;
      g[(G_SLOT + 6 * k + 5) * pb + idx] = -1e30f;
    }
    return;
  }
  Body A, B;
  load_body(rows, w, b, a, A);
  load_body(rows, w, b, j, B);
  Manifold m;
  pair_manifold(dc[0], dc[1], dc[2], A, B, m);
  const float baum_dt = sc[4] / sc[0], slop = sc[5];
  for (int c = 0; c < 3; ++c) g[(G_N + c) * pb + idx] = m.n[c];
  for (int k = 0; k < N_SLOT; ++k) {
    const int o = G_SLOT + 6 * k;
    for (int c = 0; c < 3; ++c) g[(o + c) * pb + idx] = m.p[k][c];
    const float d0 = m.depth[k];
    g[(o + 5) * pb + idx] = d0;
    g[(o + 4) * pb + idx] = d0 > 0.f ? baum_dt * fmaxf(d0 - slop, 0.f) : -1e30f;
  }
}

// Live pairs per body (as row plus as column) and the positions of this SAT.
__global__ void k_count(Ws w, int b) {
  BODY_THREAD GATED
  const size_t pb = size_t(BAND) * b;
  float cnt = 0.f;
  for (int d = 1; d <= BAND && a + d < b; ++d) cnt = cnt + (LIVE(w, size_t(d - 1) * b + a, pb) ? 1.f : 0.f);
  for (int d = 1; d <= BAND && a - d >= 0; ++d) cnt = cnt + (LIVE(w, size_t(d - 1) * b + a - d, pb) ? 1.f : 0.f);
  w.paircnt[a] = cnt;
  for (int c = 0; c < 3; ++c) w.p0[c * b + a] = w.st[c * b + a];
}

// Between rebuilds: the bias from the cached depth less the drift along the
// cached normal since the last SAT.
__global__ void k_refresh(const float* __restrict__ sc, Ws w, int b) {
  PAIR_THREAD GATED
  const size_t pb = size_t(BAND) * b;
  if (!LIVE(w, idx, pb)) return;
  float* g = w.pgeo;
  float dd[3];
  for (int c = 0; c < 3; ++c) dd[c] = (w.st[c * b + j] - w.p0[c * b + j]) - (w.st[c * b + a] - w.p0[c * b + a]);
  const float drift = dd[0] * g[G_N * pb + idx] + dd[1] * g[(G_N + 1) * pb + idx] + dd[2] * g[(G_N + 2) * pb + idx];
  const float baum_dt = sc[4] / sc[0], slop = sc[5];
  for (int k = 0; k < N_SLOT; ++k) {
    const int o = G_SLOT + 6 * k;
    const float dv = g[(o + 5) * pb + idx] - drift;
    g[(o + 4) * pb + idx] = dv > 0.f ? baum_dt * fmaxf(dv - slop, 0.f) : -1e30f;
  }
}

// The 4 analytic hub planes for body a (all N_SLOT support points per plane),
// then the mass-split inverse masses and the plane effective masses.
__global__ void k_planes(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, int b) {
  BODY_THREAD GATED
  const size_t qb = size_t(NPK) * b;
  const float dt = sc[0], margin = sc[6], baum_dt = sc[4] / dt, slop = sc[5];
  float ax[3][3], h[3], p[3];
  for (int k = 0; k < 3; ++k) {
    for (int c = 0; c < 3; ++c) ax[k][c] = w.rot[(3 * c + k) * b + a];
    h[k] = rows[(I_H + k) * b + a];
    p[k] = w.st[k * b + a];
  }
  const bool box = rows[I_BOX * b + a] > 0.5f, dyn = rows[I_DYN * b + a] > 0.5f, act = rows[I_ACT * b + a] > 0.5f;
  const float rad = rows[I_RAD * b + a], hlen = rows[I_HLEN * b + a], fric = rows[I_FRIC * b + a];
  float cav[3];
  for (int c = 0; c < 3; ++c) cav[c] = w.ca[c * b + a];
  const float su[4] = {1.f, 1.f, -1.f, -1.f}, sv[4] = {1.f, -1.f, 1.f, -1.f}, cap_sgn[4] = {1.f, -1.f, 0.f, 0.f};
  float plane_cnt = 0.f;
  for (int pl = 0; pl < N_PLANE; ++pl) {
    const float* P = sc + 8 + pl * PLANE_SC;
    const float dp[3] = {p[0] - P[0], p[1] - P[1], p[2] - P[2]};
    const float side = P[3] * dp[0] + P[4] * dp[1] + P[5] * dp[2];
    const float sgn_p = side >= 0.f ? 1.f : -1.f;
    const float ne[3] = {P[3] * sgn_p, P[4] * sgn_p, P[5] * sgn_p};
    float f[3], uf[3], vf[3];
    incident_face(ax, h, ne[0], ne[1], ne[2], 1.f, f, uf, vf);
    for (int k = 0; k < N_SLOT; ++k) {
      const size_t qa = size_t(N_SLOT * pl + k) * b + a;
      const bool use_box_pt = box || k >= 2;
      const bool shape_gate = k >= 2 ? box : (k == 1 ? (box || hlen > 1e-6f) : true);
      float ra[3], wc[3];
      for (int c = 0; c < 3; ++c) {
        ra[c] = use_box_pt ? f[c] + su[k] * uf[c] + sv[k] * vf[c] : cap_sgn[k] * cav[c] - ne[c] * rad;
        wc[c] = dp[c] + ra[c];
      }
      const float depth = P[14] - (ne[0] * wc[0] + ne[1] * wc[1] + ne[2] * wc[2]);
      const float pu = P[6] * wc[0] + P[7] * wc[1] + P[8] * wc[2];
      const float pv = P[9] * wc[0] + P[10] * wc[1] + P[11] * wc[2];
      const bool inb = (fabsf(pu) <= P[12] + margin) && (fabsf(pv) <= P[13] + margin);
      const bool touching = (P[12] > 0.f) && dyn && shape_gate && inb && (depth > 0.f) && act;
      for (int c = 0; c < 3; ++c) {
        w.pgp[(P_R + c) * qb + qa] = ra[c];
        w.pgp[(P_N + c) * qb + qa] = ne[c];
      }
      w.pgp[P_BIAS * qb + qa] = touching ? baum_dt * fmaxf(depth - slop, 0.f) : -1e30f;
      w.pgp[P_MU * qb + qa] = sqrtf(fric * P[15]);
      plane_cnt = plane_cnt + (touching ? 1.f : 0.f);
    }
  }
  const float split = fmaxf(w.paircnt[a] + plane_cnt, 1.f);
  const float ime = rows[I_INVM * b + a] * split;
  float im[3];
  for (int c = 0; c < 3; ++c) im[c] = rows[(I_IM3 + c) * b + a] * split;
  w.ime[a] = ime;
  for (int c = 0; c < 3; ++c) w.ime[(1 + c) * b + a] = im[c];
  for (int q = 0; q < NPK; ++q) {
    const size_t qa = size_t(q) * b + a;
    float r[3], n[3];
    for (int c = 0; c < 3; ++c) { r[c] = w.pgp[(P_R + c) * qb + qa]; n[c] = w.pgp[(P_N + c) * qb + qa]; }
    const float cx = r[1] * n[2] - r[2] * n[1], cy = r[2] * n[0] - r[0] * n[2], cz = r[0] * n[1] - r[1] * n[0];
    w.pgp[P_IKN * qb + qa] = 1.f / (ime + im[0] * (cx * cx) + im[1] * (cy * cy) + im[2] * (cz * cz) + 1e-9f);
  }
}

// Pair effective masses at a rebuild, with this substep's mass split.
__global__ void k_pair_ikn(Ws w, int b) {
  PAIR_THREAD GATED
  const size_t pb = size_t(BAND) * b;
  if (!LIVE(w, idx, pb)) return;
  float* g = w.pgeo;
  const float n[3] = {g[G_N * pb + idx], g[(G_N + 1) * pb + idx], g[(G_N + 2) * pb + idx]};
  float dc[3];
  for (int c = 0; c < 3; ++c) dc[c] = w.st[c * b + j] - w.st[c * b + a];
  const float ime = w.ime[a], imx = w.ime[b + a], imy = w.ime[2 * b + a], imz = w.ime[3 * b + a];
  const float cime = w.ime[j], cimx = w.ime[b + j], cimy = w.ime[2 * b + j], cimz = w.ime[3 * b + j];
  for (int k = 0; k < N_SLOT; ++k) {
    const int o = G_SLOT + 6 * k;
    const float ra[3] = {g[o * pb + idx], g[(o + 1) * pb + idx], g[(o + 2) * pb + idx]};
    const float rbv[3] = {ra[0] - dc[0], ra[1] - dc[1], ra[2] - dc[2]};
    const float an[3] = {ra[1] * n[2] - ra[2] * n[1], ra[2] * n[0] - ra[0] * n[2], ra[0] * n[1] - ra[1] * n[0]};
    const float bn[3] = {rbv[1] * n[2] - rbv[2] * n[1], rbv[2] * n[0] - rbv[0] * n[2], rbv[0] * n[1] - rbv[1] * n[0]};
    const float ang_a = imx * (an[0] * an[0]) + imy * (an[1] * an[1]) + imz * (an[2] * an[2]);
    const float ang_b = cimx * (bn[0] * bn[0]) + cimy * (bn[1] * bn[1]) + cimz * (bn[2] * bn[2]);
    g[(o + 3) * pb + idx] = 1.f / (ime + cime + ang_a + ang_b + 1e-9f);
  }
}

// One pair, one pass: reads the pass's velocity snapshot, updates the pair's
// λ caches (warm mode) and writes j, torque_a and torque_b for the body pass.
// A pair that is not live writes zeros (and, in the warm pass, zero caches),
// which is what the TPU kernel's arithmetic gives it.
__global__ void k_solve_pairs(const float* __restrict__ rows, Ws w, int b, int is_warm, float warm) {
  PAIR_THREAD GATED
  const size_t pb = size_t(BAND) * b;
  float jt[3] = {0.f, 0.f, 0.f}, ta[3] = {0.f, 0.f, 0.f}, tb[3] = {0.f, 0.f, 0.f};
  __nv_bfloat16* lam = w.lam;
  if (!LIVE(w, idx, pb)) {
    if (is_warm)
      for (int f = 0; f < N_LAM; ++f) lam[f * pb + idx] = __float2bfloat16_rn(0.f);
  } else {
    const float* g = w.pgeo;
    const float n[3] = {g[G_N * pb + idx], g[(G_N + 1) * pb + idx], g[(G_N + 2) * pb + idx]};
    float dc[3], rv_[3], rw_[3], cv_[3], cw_[3];
    for (int c = 0; c < 3; ++c) {
      dc[c] = w.st[c * b + j] - w.st[c * b + a];
      rv_[c] = w.st[(I_V + c) * b + a]; rw_[c] = w.st[(I_W + c) * b + a];
      cv_[c] = w.st[(I_V + c) * b + j]; cw_[c] = w.st[(I_W + c) * b + j];
    }
    const float mu = sqrtf(rows[I_FRIC * b + a] * rows[I_FRIC * b + j]);
    auto rel_vel = [&](const float ra[3], const float rbv[3], float out[3]) {
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
        out[c] = (cv_[c] + cw_[c1] * rbv[c2] - cw_[c2] * rbv[c1]) - (rv_[c] + rw_[c1] * ra[c2] - rw_[c2] * ra[c1]);
      }
    };
    // `acc + a*b - c*d`, the TPU kernel's association
    auto apply = [&](const float jv[3], const float ra[3], const float rbv[3]) {
      for (int c = 0; c < 3; ++c) jt[c] = jt[c] + jv[c];
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
        ta[c] = ta[c] + ra[c1] * jv[c2] - ra[c2] * jv[c1];
      }
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
        tb[c] = tb[c] + rbv[c1] * jv[c2] - rbv[c2] * jv[c1];
      }
    };
    if (warm > 0.f) {
      // per-slot normal impulses, then one friction solve at the touching points' centroid
      float sum_ln = 0.f, c_a[3] = {0.f, 0.f, 0.f}, c_w = 0.f;
      for (int k = 0; k < N_SLOT; ++k) {
        const int o = G_SLOT + 6 * k;
        const float ra[3] = {g[o * pb + idx], g[(o + 1) * pb + idx], g[(o + 2) * pb + idx]};
        const float rbv[3] = {ra[0] - dc[0], ra[1] - dc[1], ra[2] - dc[2]};
        const float bias = g[(o + 4) * pb + idx];
        const float touch = bias > -1e29f ? 1.f : 0.f;
        const size_t li = size_t(k) * pb + idx;
        const float ln_old = __bfloat162float(lam[li]);
        float ln_eff, dl;
        if (is_warm) {
          ln_eff = bf(ln_old * (touch * warm));
          dl = ln_eff;
        } else {
          float rv[3];
          rel_vel(ra, rbv, rv);
          const float vn = rv[0] * n[0] + rv[1] * n[1] + rv[2] * n[2];
          ln_eff = bf(fmaxf(ln_old - (vn - bias) * g[(o + 3) * pb + idx], 0.f));
          dl = ln_eff - ln_old;
        }
        lam[li] = __float2bfloat16_rn(ln_eff);
        sum_ln = sum_ln + ln_eff;
        const float jv[3] = {n[0] * dl, n[1] * dl, n[2] * dl};
        apply(jv, ra, rbv);
        for (int c = 0; c < 3; ++c) c_a[c] = c_a[c] + touch * ra[c];
        c_w = c_w + touch;
      }
      const float inv_cw = 1.f / fmaxf(c_w, 1.f);
      const float ra[3] = {c_a[0] * inv_cw, c_a[1] * inv_cw, c_a[2] * inv_cw};
      const float rbv[3] = {ra[0] - dc[0], ra[1] - dc[1], ra[2] - dc[2]};
      float lt_old[3], lt_s[3], dj[3];
      for (int c = 0; c < 3; ++c) lt_old[c] = __bfloat162float(lam[size_t(N_SLOT + c) * pb + idx]);
      if (is_warm) {
        const float gate = (c_w > 0.5f ? 1.f : 0.f) * warm;
        for (int c = 0; c < 3; ++c) { lt_s[c] = bf(lt_old[c] * gate); dj[c] = lt_s[c]; }
      } else {
        float rv[3];
        rel_vel(ra, rbv, rv);
        const float vn = rv[0] * n[0] + rv[1] * n[1] + rv[2] * n[2];
        const float ikn0 = g[(G_SLOT + 3) * pb + idx];
        float lt_c[3];
        for (int c = 0; c < 3; ++c) lt_c[c] = lt_old[c] - (rv[c] - vn * n[c]) * ikn0;
        const float ltl = sqrtf(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9f;
        const float tscale = fminf(mu * sum_ln / ltl, 1.f);
        for (int c = 0; c < 3; ++c) { lt_s[c] = bf(lt_c[c] * tscale); dj[c] = lt_s[c] - lt_old[c]; }
      }
      for (int c = 0; c < 3; ++c) lam[size_t(N_SLOT + c) * pb + idx] = __float2bfloat16_rn(lt_s[c]);
      apply(dj, ra, rbv);
    } else {
      // cold projected Jacobi: per slot, normal and friction from this pass's velocities
      for (int k = 0; k < N_SLOT; ++k) {
        const int o = G_SLOT + 6 * k;
        const float ra[3] = {g[o * pb + idx], g[(o + 1) * pb + idx], g[(o + 2) * pb + idx]};
        const float rbv[3] = {ra[0] - dc[0], ra[1] - dc[1], ra[2] - dc[2]};
        const float ikn = g[(o + 3) * pb + idx], bias = g[(o + 4) * pb + idx];
        float rv[3];
        rel_vel(ra, rbv, rv);
        const float vn = rv[0] * n[0] + rv[1] * n[1] + rv[2] * n[2];
        const float lamn = fmaxf(-(vn - bias) * ikn, 0.f);
        const float tv[3] = {rv[0] - vn * n[0], rv[1] - vn * n[1], rv[2] - vn * n[2]};
        const float tvl = sqrtf(tv[0] * tv[0] + tv[1] * tv[1] + tv[2] * tv[2]) + 1e-9f;
        const float lam_t = fminf(tvl * ikn, mu * lamn);
        float jv[3];
        for (int c = 0; c < 3; ++c) jv[c] = n[c] * lamn - tv[c] / tvl * lam_t;
        apply(jv, ra, rbv);
      }
    }
  }
  for (int c = 0; c < 3; ++c) {
    w.pimp[c * pb + idx] = jt[c];
    w.pimp[(3 + c) * pb + idx] = ta[c];
    w.pimp[(6 + c) * pb + idx] = tb[c];
  }
}

// Body a: -(its row side's sum) + (its column side's, chunk by chunk in chunk
// order), its plane contacts one (plane, slot) at a time, then the Jacobi
// velocity update.
__global__ void k_solve_bodies(const float* __restrict__ rows, Ws w, int b, int is_warm, float warm, int sleep) {
  BODY_THREAD GATED
  const size_t pb = size_t(BAND) * b, qb = size_t(NPK) * b;
  float acc[3], tq[3];
  for (int c = 0; c < 6; ++c) {
    const float* jr = w.pimp + size_t(c) * pb;           // j (c < 3), torque_a (c >= 3)
    const float* jc = w.pimp + size_t(c < 3 ? c : c + 3) * pb;  // j, torque_b
    float row = 0.f;
    for (int d = 1; d <= BAND && a + d < b; ++d) row = row + jr[size_t(d - 1) * b + a];
    float col = 0.f, part = 0.f;
    const int i0 = a - BAND < 0 ? 0 : a - BAND;
    int chunk = i0 / BCHUNK;
    for (int i = i0; i < a; ++i) {
      if (i / BCHUNK != chunk) { col = col + part; part = 0.f; chunk = i / BCHUNK; }
      part = part + jc[size_t(a - i - 1) * b + i];
    }
    col = col + part;
    (c < 3 ? acc[c] : tq[c - 3]) = -row + col;
  }
  float v[3], om[3];
  for (int c = 0; c < 3; ++c) { v[c] = w.st[(I_V + c) * b + a]; om[c] = w.st[(I_W + c) * b + a]; }
  for (int q = 0; q < NPK; ++q) {
    const size_t qa = size_t(q) * b + a;
    float r[3], n[3], lam[4], pj[3];
    for (int c = 0; c < 3; ++c) { r[c] = w.pgp[(P_R + c) * qb + qa]; n[c] = w.pgp[(P_N + c) * qb + qa]; }
    for (int f = 0; f < 4; ++f) lam[f] = w.plam[f * qb + qa];
    const float bias = w.pgp[P_BIAS * qb + qa];
    if (is_warm) {
      const float pt = (bias > -1e29f ? 1.f : 0.f) * warm;
      for (int f = 0; f < 4; ++f) lam[f] = lam[f] * pt;
      for (int c = 0; c < 3; ++c) pj[c] = n[c] * lam[0] + lam[1 + c];
    } else {
      const float ikn = w.pgp[P_IKN * qb + qa], mu = w.pgp[P_MU * qb + qa];
      float rv[3], tv[3];
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
        rv[c] = v[c] + om[c1] * r[c2] - om[c2] * r[c1];
      }
      const float vn = rv[0] * n[0] + rv[1] * n[1] + rv[2] * n[2];
      for (int c = 0; c < 3; ++c) tv[c] = rv[c] - vn * n[c];
      if (warm > 0.f) {
        const float ln_new = fmaxf(lam[0] - (vn - bias) * ikn, 0.f);
        const float dlam = ln_new - lam[0];
        float lt_c[3];
        for (int c = 0; c < 3; ++c) lt_c[c] = lam[1 + c] - tv[c] * ikn;
        const float ltl = sqrtf(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9f;
        const float tscale = fminf(mu * ln_new / ltl, 1.f);
        for (int c = 0; c < 3; ++c) {
          const float lt_n = lt_c[c] * tscale;
          pj[c] = n[c] * dlam + (lt_n - lam[1 + c]);
          lam[1 + c] = lt_n;
        }
        lam[0] = ln_new;
      } else {
        const float lamn = fmaxf(-(vn - bias) * ikn, 0.f);
        const float tvl = sqrtf(tv[0] * tv[0] + tv[1] * tv[1] + tv[2] * tv[2]) + 1e-9f;
        const float lam_t = fminf(tvl * ikn, mu * lamn);
        for (int c = 0; c < 3; ++c) pj[c] = n[c] * lamn - tv[c] / tvl * lam_t;
      }
    }
    if (warm > 0.f)
      for (int f = 0; f < 4; ++f) w.plam[f * qb + qa] = lam[f];
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + pj[c];
    for (int c = 0; c < 3; ++c) {
      const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
      tq[c] = tq[c] + r[c1] * pj[c2] - r[c2] * pj[c1];
    }
  }
  float mov_f = rows[I_MOV * b + a];
  if (sleep) mov_f = mov_f * (1.f - w.slp[a]);
  const float inv_m = rows[I_INVM * b + a];
  for (int c = 0; c < 3; ++c) {
    w.st[(I_V + c) * b + a] = v[c] + acc[c] * inv_m * rows[(I_DOF + c) * b + a] * mov_f;
    w.st[(I_W + c) * b + a] = om[c] + tq[c] * rows[(I_IM3 + c) * b + a] * mov_f;
  }
}

__global__ void k_sleep_flags(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, int b) {
  BODY_THREAD GATED
  const float* v = w.st + I_V * b;
  const float* om = w.st + I_W * b;
  const float v2 = v[a] * v[a] + v[b + a] * v[b + a] + v[2 * b + a] * v[2 * b + a];
  const float w2 = om[a] * om[a] + om[b + a] * om[b + a] + om[2 * b + a] * om[2 * b + a];
  const float moving = v2 + rows[I_REFF2 * b + a] * w2 >= sc[8 + N_PLANE * PLANE_SC] ? 1.f : 0.f;
  w.moving[a] = moving;
  w.pusher[a] = rows[I_DYN * b + a] * (1.f - w.slp[a]) * moving;
}

__device__ __forceinline__ float pair_touch(const Ws& w, size_t pb, size_t pi) {
  float t = 0.f;
  for (int k = 0; k < N_SLOT; ++k) t = fmaxf(t, w.pgeo[(G_SLOT + 6 * k + 4) * pb + pi] > -1e29f ? 1.f : 0.f);
  return t;
}

// Wake propagation from touching pairs whose other side is an awake moving
// dynamic body (both pair directions), the deactivation timers; sleeping
// bodies stop. Every term is 0 or 1, so the sums' order does not matter.
__global__ void k_sleep_update(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, int b) {
  BODY_THREAD GATED
  const size_t pb = size_t(BAND) * b;
  float col = 0.f, row = 0.f;
  for (int i = (a - BAND < 0 ? 0 : a - BAND); i < a; ++i)
    col = col + pair_touch(w, pb, size_t(a - i - 1) * b + i) * w.pusher[i];
  for (int d = 1; d <= BAND && a + d < b; ++d) row = row + pair_touch(w, pb, size_t(d - 1) * b + a) * w.pusher[a + d];
  const float wk = col + row > 0.5f ? 1.f : 0.f;
  const float dt = sc[0], sleep_time = sc[8 + N_PLANE * PLANE_SC + 1];
  const float eligible = (1.f - w.moving[a]) * rows[I_CANSLEEP * b + a] * (1.f - wk);
  const float timer = (w.tmr[a] + dt) * eligible;
  const float fall = (timer >= sleep_time ? 1.f : 0.f) * eligible;
  const float s = fminf(w.slp[a] * (1.f - wk) + fall, 1.f);
  w.slp[a] = s;
  w.tmr[a] = timer;
  const float keep = 1.f - s;
  for (int c = 0; c < 6; ++c) w.st[(I_V + c) * b + a] = w.st[(I_V + c) * b + a] * keep;
}

__global__ void k_integrate(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, int b, int sleep) {
  BODY_THREAD GATED
  const float dt = sc[0];
  const float mov = rows[I_MOV * b + a];
  float mov_dt = mov * dt;
  if (sleep) mov_dt = mov_dt * (1.f - w.slp[a]);
  for (int c = 0; c < 3; ++c) w.st[c * b + a] = w.st[c * b + a] + w.st[(I_V + c) * b + a] * mov_dt;
  const float hq = 0.5f * dt;
  const float wx = w.st[6 * b + a], wy = w.st[7 * b + a], wz = w.st[8 * b + a];
  const float qx = w.st[9 * b + a], qy = w.st[10 * b + a], qz = w.st[11 * b + a], qw = w.st[12 * b + a];
  const float mov_f = sleep ? mov * (1.f - w.slp[a]) : mov;
  const float dqx = hq * (wx * qw + wy * qz - wz * qy);
  const float dqy = hq * (-wx * qz + wy * qw + wz * qx);
  const float dqz = hq * (wx * qy - wy * qx + wz * qw);
  const float dqw = hq * (-wx * qx - wy * qy - wz * qz);
  const float nx = qx + dqx * mov_f, ny = qy + dqy * mov_f, nz = qz + dqz * mov_f, nw = qw + dqw * mov_f;
  const float qn = rsqrtf(nx * nx + ny * ny + nz * nz + nw * nw + 1e-12f);
  w.st[9 * b + a] = nx * qn; w.st[10 * b + a] = ny * qn; w.st[11 * b + a] = nz * qn; w.st[12 * b + a] = nw * qn;
}

__global__ void k_out(const float* __restrict__ rows, Ws w, int b, float* __restrict__ out, int sleep) {
  BODY_THREAD
  for (int f = 0; f < 13; ++f) out[f * b + a] = w.st[f * b + a];
  out[13 * b + a] = sleep ? w.slp[a] : rows[I_SLEEP0 * b + a];
  out[14 * b + a] = sleep ? w.tmr[a] : rows[I_TIMER0 * b + a];
}

}  // namespace

// ---------------------------------------------------------------------------
// host entry points (plain C, loaded with ctypes); errors are cudaError_t codes
// (`kernel_error_string` names them)
// ---------------------------------------------------------------------------

extern "C" size_t banded_workspace_bytes(int b) {
  Ws w;
  return carve(&w, nullptr, b);
}

#define LAUNCH(kernel, n, ...)                                          \
  do {                                                                 \
    kernel<<<((n) + TPB - 1) / TPB, TPB, 0, stream>>>(__VA_ARGS__);    \
    cudaError_t e_ = cudaGetLastError();                               \
    if (e_ != cudaSuccess) return (int)e_;                             \
  } while (0)

extern "C" int banded_substeps(const float* scalars, const float* rows, float* out, void* workspace, int b,
                               int n_substeps, int iterations, float warm, int geom_every, int sleep,
                               void* stream_ptr) {
  if (b < BCHUNK + BAND || b % BCHUNK != 0 || n_substeps < 0 || iterations < 0 || geom_every < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Ws w;
  carve(&w, (char*)workspace, b);
  if (!sleep) w.gate = nullptr;  // no gate: every substep runs
  const int npairs = BAND * b;
  LAUNCH(k_init, b, rows, w, b);
  for (int step = 0; step < n_substeps; ++step) {
    if (sleep) {
      // a substep runs only while some movable body is awake
      cudaError_t e = cudaMemsetAsync(w.gate, 0, sizeof(int), stream);
      if (e != cudaSuccess) return (int)e;
      LAUNCH(k_awake, b, rows, w, b);
    }
    LAUNCH(k_pre, b, scalars, rows, w, b, sleep);
    const bool rebuild = step % geom_every == 0;
    if (rebuild) {
      LAUNCH(k_geom, npairs, scalars, rows, w, b);
      LAUNCH(k_count, b, w, b);
    } else {
      LAUNCH(k_refresh, npairs, scalars, w, b);
    }
    LAUNCH(k_planes, b, scalars, rows, w, b);
    if (rebuild) LAUNCH(k_pair_ikn, npairs, w, b);
    for (int it = warm > 0.f ? 0 : 1; it <= iterations; ++it) {
      const int is_warm = it == 0;
      LAUNCH(k_solve_pairs, npairs, rows, w, b, is_warm, warm);
      LAUNCH(k_solve_bodies, b, rows, w, b, is_warm, warm, sleep);
    }
    if (sleep) {
      LAUNCH(k_sleep_flags, b, scalars, rows, w, b);
      LAUNCH(k_sleep_update, b, scalars, rows, w, b);
    }
    LAUNCH(k_integrate, b, scalars, rows, w, b, sleep);
  }
  LAUNCH(k_out, b, rows, w, b, out, sleep);
  return 0;
}
