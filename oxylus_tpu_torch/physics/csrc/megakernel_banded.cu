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
// `compact_sat.cuh`, depth caches, per-body pair counts), otherwise a bias
// refresh from the drift since the last SAT; the 4 analytic hub planes;
// mass-split effective masses; with `warm > 0` a warm pass and `iterations`
// accumulated-impulse sweeps over bf16 pair λ caches (stored with
// __float2bfloat16_rn, as the TPU kernel's LAM_DT), else `iterations` cold
// projected-Jacobi sweeps; optional sleeping (every substep, the rest of the
// call skipped once every movable body sleeps); integration.
//
// What bounds it on the card: at the flagship size (B = 1024) the function is
// small (a few hundred million operations a 60-substep call, ~0.005 ms at the
// float32 peak), so the time is the chain of dependent passes. The first port
// spent it in ~13 launches a substep and in one thread per body walking all
// 2 × 128 band partners six times a sweep (`k_solve_bodies`, 87 % of a call).
//
// Design. One persistent cooperative launch runs the whole call; a grid-wide
// barrier separates the passes (per substep: the geometry and the lists at a
// rebuild, then one pass per sweep; with sleeping a pre pass and a sleep
// pass). A warp owns one body in every pass:
// - at a rebuild its lanes take the 128 band deltas, test the AABBs, and a
//   __ballot_sync gives the body's live-pair mask and, in ascending delta, its
//   row list; the lanes then run the live pairs' SATs side by side. The next
//   pass reads the other bodies' masks into the column list (ascending delta).
//   Pair fields are stored a · BAND + d - 1, so a body's row pairs are
//   neighbours in memory;
// - in a sweep its lanes take the body's live pairs, row and column, and the
//   4 × 4 hub-plane points, and each lane computes its pair's impulse from the
//   sweep's velocity snapshot; lane 0 adds the terms in the first port's
//   order (which in most bodies gives the plain version's bits: a 1-ulp
//   difference would flip some bf16 λ roundings and grow over a call).
//   Each pair is thus solved by both of its bodies' warps with the same
//   arithmetic on the same inputs (so the same bits); the row body's warp
//   writes its λ caches, once per pair. Velocities and λ caches are read from
//   one buffer and written to the other, so a sweep needs one barrier;
//   positions likewise, so the last sweep also integrates and, without
//   sleeping, computes the next substep's gravity, pose terms and planes.
// Dead pairs are never visited: their impulse is exactly zero in the TPU
// kernel, and a pair that leaves the live set at a rebuild has its λ caches
// zeroed then, as the TPU kernel's next warm pass would. No float atomics;
// every run gives the same bits. The bias is recomputed from the cached depth
// where it is used (at a rebuild the drift is exactly zero).
//
// Built with -fmad=false: every product and sum rounds on its own, as the plain
// PyTorch version's separate tensor ops do, so the two differ only where sums
// are taken in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_sat.cuh"
#include "persistent.cuh"

namespace {  // private to this file: the other physics kernels have helpers of the same names

#define BAND 128
#define MASK_W (BAND / 32)
#define N_PLANE 4
#define PLANE_SC 16
#define N_SLOT 4
#define NPK (N_PLANE * N_SLOT)
#define N_LAM 7
#define N_PGP 9
#define TPB 256

// per-body input rows (see `megakernel_compact._input_rows`)
enum {
  I_P = 0, I_V = 3, I_W = 6, I_Q = 9, I_INVM = 13, I_IM3 = 14, I_H = 17, I_RAD = 20, I_HLEN = 21,
  I_FRIC = 22, I_GRAV = 24, I_DOF = 25, I_BOX = 28, I_DYN = 29, I_MOV = 30, I_ACT = 31,
  I_SLEEP0 = 32, I_TIMER0 = 33, I_REFF2 = 34, I_CANSLEEP = 35,
};
// pair geometry fields, each B × BAND (pair (a, a + d) at a · BAND + d - 1):
// the normal, then per slot k at G_SLOT + 5k: lever arm (3), 1/kn, depth at
// the last SAT
enum { G_N = 0, G_SLOT = 3, N_PGEO = 23 };
// plane geometry fields, each NPK × B
enum { P_R = 0, P_IKN = 3, P_BIAS = 4, P_N = 5, P_MU = 8 };
// pose rows: position, quaternion
enum { S_Q = 3, N_POSE = 7 };
// the passes whose SM cycles `cycles` collects (`megakernel_banded.PASSES`),
// then the sweep passes' warp cycles split: the pair impulses (what the first
// port's k_solve_pairs did) and the body's sums with its plane points (its
// k_solve_bodies), summed over warps
enum { PASS_PRE = 0, PASS_GEOM = 1, PASS_LISTS = 2, PASS_SWEEP = 3, PASS_SLEEP = 4, WARP_PAIRS = 5, WARP_SUMS = 6 };

struct Ws {
  float *pose[2];   // N_POSE × B each: this substep's and the next
  float *vel[2];    // 6 × B each: linear, angular velocity; a sweep reads one and writes the other
  float *rot;       // 9 × B row-major rotation
  float *eh, *ca;   // 3 × B each: AABB half extents (+margin), capsule half-segment
  float *ime;       // 4 × B mass-split inverse mass / inertia
  float *p0;        // 3 × B positions at the last SAT
  float *slp, *tmr, *pusher, *moving, *pcnt;  // B each (pcnt: touching plane points)
  int *nrow, *ncol;  // B each: live pairs as row, as column
  int *gate;         // 2: some movable body awake (sleep mode), per substep parity
  unsigned *mask;    // MASK_W × B: bit d - 1 of body a: pair (a, a + d) live
  unsigned char *rowl, *coll;  // BAND × B each: d - 1 of each live pair, d ascending (rows), descending (columns)
  float *pgeo;       // N_PGEO × B × BAND
  float *pgp;        // N_PGP × NPK × B
  float *plam;       // 4 × NPK × B
  __nv_bfloat16 *lam[2];  // N_LAM × B × BAND each
};

struct Args {
  const float* sc;
  const float* rows;
  float* out;
  unsigned long long* cycles;
  Ws w;
  int b, n_substeps, iterations, geom_every, sleep;
  float warm;
};

size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

size_t carve(Ws* w, char* base, int b_) {
  size_t off = 0;
  const size_t b = b_, pb = size_t(BAND) * b_, qb = size_t(NPK) * b_;
  auto take = [&](size_t bytes) { char* p = base ? base + off : nullptr; off = align_up(off + bytes); return p; };
  for (int i = 0; i < 2; ++i) {
    w->pose[i] = (float*)take(N_POSE * b * 4);
    w->vel[i] = (float*)take(6 * b * 4);
  }
  w->rot = (float*)take(9 * b * 4);
  w->eh = (float*)take(3 * b * 4);
  w->ca = (float*)take(3 * b * 4);
  w->ime = (float*)take(4 * b * 4);
  w->p0 = (float*)take(3 * b * 4);
  w->slp = (float*)take(b * 4);
  w->tmr = (float*)take(b * 4);
  w->pusher = (float*)take(b * 4);
  w->moving = (float*)take(b * 4);
  w->pcnt = (float*)take(b * 4);
  w->nrow = (int*)take(b * 4);
  w->ncol = (int*)take(b * 4);
  w->gate = (int*)take(2 * 4);
  w->mask = (unsigned*)take(MASK_W * b * 4);
  w->rowl = (unsigned char*)take(pb);
  w->coll = (unsigned char*)take(pb);
  w->pgeo = (float*)take(N_PGEO * pb * 4);
  w->pgp = (float*)take(N_PGP * qb * 4);
  w->plam = (float*)take(4 * qb * 4);
  w->lam[0] = (__nv_bfloat16*)take(2 * N_LAM * pb * 2);  // both buffers in one block, zeroed as one
  w->lam[1] = base ? w->lam[0] + N_LAM * pb : nullptr;
  return off;
}

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float pair_bias(float dv, float baum_dt, float slop) {
  return dv > 0.f ? baum_dt * fmaxf(dv - slop, 0.f) : -1e30f;
}

__device__ __forceinline__ void quat_rot(const float* pose, int b, int a, float r[9]) {
  const float qx = pose[S_Q * b + a], qy = pose[(S_Q + 1) * b + a], qz = pose[(S_Q + 2) * b + a],
              qw = pose[(S_Q + 3) * b + a];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz, xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  r[0] = 1.f - 2.f * (yy + zz); r[1] = 2.f * (xy - wz); r[2] = 2.f * (xz + wy);
  r[3] = 2.f * (xy + wz); r[4] = 1.f - 2.f * (xx + zz); r[5] = 2.f * (yz - wx);
  r[6] = 2.f * (xz - wy); r[7] = 2.f * (yz + wx); r[8] = 1.f - 2.f * (xx + yy);
}

__device__ __forceinline__ void load_body(const Args& A, int i, Body& B) {
  const int b = A.b;
  for (int k = 0; k < 9; ++k) B.r[k / 3][k % 3] = A.w.rot[k * b + i];
  for (int c = 0; c < 3; ++c) { B.h[c] = A.rows[(I_H + c) * b + i]; B.ca[c] = A.w.ca[c * b + i]; }
  B.rad = A.rows[I_RAD * b + i];
  B.box = A.rows[I_BOX * b + i];
}

// The mass split from this substep's contact count, then the plane points'
// effective masses (lane q < NPK takes plane point q).
__device__ void body_masses(const Args& A, int a, int lane, float paircnt, float plane_cnt) {
  const Ws& w = A.w;
  const int b = A.b;
  const size_t qb = size_t(NPK) * b;
  const float split = fmaxf(paircnt + plane_cnt, 1.f);
  const float ime = A.rows[I_INVM * b + a] * split;
  float im[3];
  for (int c = 0; c < 3; ++c) im[c] = A.rows[(I_IM3 + c) * b + a] * split;
  if (lane == 0) {
    w.ime[a] = ime;
    for (int c = 0; c < 3; ++c) w.ime[(1 + c) * b + a] = im[c];
  }
  if (lane < NPK) {
    const size_t qa = size_t(lane) * b + a;
    float r[3], n[3];
    for (int c = 0; c < 3; ++c) { r[c] = w.pgp[(P_R + c) * qb + qa]; n[c] = w.pgp[(P_N + c) * qb + qa]; }
    const float cx = r[1] * n[2] - r[2] * n[1], cy = r[2] * n[0] - r[0] * n[2], cz = r[0] * n[1] - r[1] * n[0];
    w.pgp[P_IKN * qb + qa] = 1.f / (ime + im[0] * (cx * cx) + im[1] * (cy * cy) + im[2] * (cz * cz) + 1e-9f);
  }
}

// Body a at the start of a substep (one warp): gravity on `vcur`, rotation,
// AABB half extents and capsule segment, then the 4 analytic hub planes, lane
// q < NPK taking plane N_SLOT-slot point q; with `with_ikn` (no rebuild this
// substep, so the pair count is known) the masses too.
__device__ void pre(const Args& A, int a, int lane, int pc, float* vcur, bool with_ikn) {
  const Ws& w = A.w;
  const float* sc = A.sc;
  const float* rows = A.rows;
  const int b = A.b;
  const float* pose = w.pose[pc];
  float r[9];
  quat_rot(pose, b, a, r);
  const bool box = rows[I_BOX * b + a] > 0.5f;
  const float rad = rows[I_RAD * b + a], hlen = rows[I_HLEN * b + a];
  const float dt = sc[0], margin = sc[6];
  if (lane == 0) {
    float grav_dt = rows[I_GRAV * b + a] * rows[I_DYN * b + a] * dt;
    if (A.sleep) grav_dt = grav_dt * (1.f - w.slp[a]);
    for (int c = 0; c < 3; ++c) vcur[c * b + a] = vcur[c * b + a] + sc[1 + c] * grav_dt;
    for (int k = 0; k < 9; ++k) w.rot[k * b + a] = r[k];
    const float lh[3] = {box ? rows[I_H * b + a] : rad, box ? rows[(I_H + 1) * b + a] : rad + hlen,
                         box ? rows[(I_H + 2) * b + a] : rad};
    for (int k = 0; k < 3; ++k) {
      w.eh[k * b + a] = fabsf(r[3 * k]) * lh[0] + fabsf(r[3 * k + 1]) * lh[1] + fabsf(r[3 * k + 2]) * lh[2] + margin;
      w.ca[k * b + a] = r[3 * k + 1] * hlen;
    }
  }
  bool touching = false;
  if (lane < NPK) {
    const size_t qb = size_t(NPK) * b, qa = size_t(lane) * b + a;
    const int pl = lane / N_SLOT, k = lane % N_SLOT;
    const float baum_dt = sc[4] / dt, slop = sc[5];
    float ax[3][3], h[3], p[3], cav[3];
    for (int kk = 0; kk < 3; ++kk) {
      for (int c = 0; c < 3; ++c) ax[kk][c] = r[3 * c + kk];
      h[kk] = rows[(I_H + kk) * b + a];
      p[kk] = pose[kk * b + a];
      cav[kk] = r[3 * kk + 1] * hlen;
    }
    const bool dyn = rows[I_DYN * b + a] > 0.5f, act = rows[I_ACT * b + a] > 0.5f;
    const float fric = rows[I_FRIC * b + a];
    const float su[4] = {1.f, 1.f, -1.f, -1.f}, sv[4] = {1.f, -1.f, 1.f, -1.f}, cap_sgn[4] = {1.f, -1.f, 0.f, 0.f};
    const float* P = sc + 8 + pl * PLANE_SC;
    const float dp[3] = {p[0] - P[0], p[1] - P[1], p[2] - P[2]};
    const float side = P[3] * dp[0] + P[4] * dp[1] + P[5] * dp[2];
    const float sgn_p = side >= 0.f ? 1.f : -1.f;
    const float ne[3] = {P[3] * sgn_p, P[4] * sgn_p, P[5] * sgn_p};
    float f[3], uf[3], vf[3];
    incident_face(ax, h, ne[0], ne[1], ne[2], 1.f, f, uf, vf);
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
    touching = (P[12] > 0.f) && dyn && shape_gate && inb && (depth > 0.f) && act;
    for (int c = 0; c < 3; ++c) {
      w.pgp[(P_R + c) * qb + qa] = ra[c];
      w.pgp[(P_N + c) * qb + qa] = ne[c];
    }
    w.pgp[P_BIAS * qb + qa] = touching ? baum_dt * fmaxf(depth - slop, 0.f) : -1e30f;
    w.pgp[P_MU * qb + qa] = sqrtf(fric * P[15]);
  }
  const float plane_cnt = (float)__popc(__ballot_sync(FULL_MASK, touching));
  if (lane == 0) w.pcnt[a] = plane_cnt;
  if (with_ikn) body_masses(A, a, lane, (float)(w.nrow[a] + w.ncol[a]), plane_cnt);
}

// Rebuild, body a's row side (one warp, lanes over the deltas): the AABB
// test of every band pair, the live mask and row list, λ caches of pairs
// that left the live set zeroed, then each live pair's SAT.
__device__ void geom(const Args& A, int a, int lane, int pc) {
  const Ws& w = A.w;
  const float* rows = A.rows;
  const int b = A.b;
  const size_t pb = size_t(BAND) * b;
  const float* pose = w.pose[pc];
  float pa[3], eha[3];
  for (int c = 0; c < 3; ++c) { pa[c] = pose[c * b + a]; eha[c] = w.eh[c * b + a]; }
  const float dyn_a = rows[I_DYN * b + a], act_a = rows[I_ACT * b + a];
  unsigned m[MASK_W];
  int n = 0;
#pragma unroll
  for (int r = 0; r < MASK_W; ++r) {
    const int d = 32 * r + lane + 1, j = a + d;
    bool live = j < b;
    if (live) {
      for (int c = 0; c < 3; ++c) live = live && (fabsf(pose[c * b + j] - pa[c]) <= eha[c] + w.eh[c * b + j]);
      live = live && ((dyn_a + rows[I_DYN * b + j]) > 0.5f) && ((act_a * rows[I_ACT * b + j]) > 0.5f);
    }
    m[r] = __ballot_sync(FULL_MASK, live);
    const bool was = (w.mask[size_t(a) * MASK_W + r] >> lane) & 1u;
    if (A.warm > 0.f && was && !live) {
      const size_t pi = size_t(a) * BAND + d - 1;
      for (int f = 0; f < N_LAM; ++f) {
        w.lam[0][f * pb + pi] = __float2bfloat16_rn(0.f);
        w.lam[1][f * pb + pi] = __float2bfloat16_rn(0.f);
      }
    }
    n += __popc(m[r]);
  }
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < MASK_W; ++r) w.mask[size_t(a) * MASK_W + r] = m[r];
    w.nrow[a] = n;
  }
  float* g = w.pgeo;
  for (int e = lane; e < n; e += 32) {
    int d = 0, rest = e;
#pragma unroll
    for (int r = 0; r < MASK_W; ++r) {
      const int c = __popc(m[r]);
      if (d == 0 && rest < c) d = 32 * r + nth_bit(m[r], rest) + 1;
      if (d == 0) rest -= c;
    }
    const int j = a + d;
    const size_t pi = size_t(a) * BAND + d - 1;
    w.rowl[size_t(a) * BAND + e] = (unsigned char)(d - 1);
    Body RA, RB;
    load_body(A, a, RA);
    load_body(A, j, RB);
    Manifold mm;
    pair_manifold(pose[j] - pa[0], pose[b + j] - pa[1], pose[2 * b + j] - pa[2], RA, RB, mm);
    for (int c = 0; c < 3; ++c) g[(G_N + c) * pb + pi] = mm.n[c];
    for (int k = 0; k < N_SLOT; ++k) {
      const int o = G_SLOT + 5 * k;
      for (int c = 0; c < 3; ++c) g[(o + c) * pb + pi] = mm.p[k][c];
      g[(o + 4) * pb + pi] = mm.depth[k];
    }
  }
}

// Rebuild, body a's column side (one warp): the column list from the other
// bodies' masks (row bodies ascending), the positions of this SAT, then the
// masses.
__device__ void lists(const Args& A, int a, int lane, int pc) {
  const Ws& w = A.w;
  const int b = A.b;
  int base = 0;
#pragma unroll
  for (int r = MASK_W - 1; r >= 0; --r) {  // d descending: the row bodies ascending
    const int d = 32 * r + lane + 1, i = a - d;
    const bool live = i >= 0 && ((w.mask[size_t(i) * MASK_W + r] >> lane) & 1u);
    const unsigned m = __ballot_sync(FULL_MASK, live);
    if (live) w.coll[size_t(a) * BAND + base + __popc(m & ~((2u << lane) - 1u))] = (unsigned char)(d - 1);
    base += __popc(m);
  }
  if (lane == 0) {
    w.ncol[a] = base;
    for (int c = 0; c < 3; ++c) w.p0[c * b + a] = w.pose[pc][c * b + a];
  }
  body_masses(A, a, lane, (float)(w.nrow[a] + base), w.pcnt[a]);
}

// Pair (R, C = R + d): its normal, lever arms, 1/kn and this substep's biases.
// `fresh` (the first sweep after a rebuild): 1/kn from this substep's mass
// split, stored by the row body's warp (`owner`).
struct PairGeo {
  float n[3], dc[3], ra[N_SLOT][3], ikn[N_SLOT], bias[N_SLOT];
};

__device__ __forceinline__ void pair_geo(const Args& A, int R, int C, size_t pi, int pc, bool rebuild, bool fresh,
                                         bool owner, PairGeo& G) {
  const Ws& w = A.w;
  const int b = A.b;
  const size_t pb = size_t(BAND) * b;
  const float* g = w.pgeo;
  const float* pose = w.pose[pc];
  for (int c = 0; c < 3; ++c) {
    G.n[c] = g[(G_N + c) * pb + pi];
    G.dc[c] = pose[c * b + C] - pose[c * b + R];
  }
  float drift = 0.f;
  if (!rebuild) {
    float dd[3];
    for (int c = 0; c < 3; ++c)
      dd[c] = (pose[c * b + C] - w.p0[c * b + C]) - (pose[c * b + R] - w.p0[c * b + R]);
    drift = dd[0] * G.n[0] + dd[1] * G.n[1] + dd[2] * G.n[2];
  }
  const float baum_dt = A.sc[4] / A.sc[0], slop = A.sc[5];
  for (int k = 0; k < N_SLOT; ++k) {
    const int o = G_SLOT + 5 * k;
    for (int c = 0; c < 3; ++c) G.ra[k][c] = g[(o + c) * pb + pi];
    const float d0 = g[(o + 4) * pb + pi];
    G.bias[k] = pair_bias(rebuild ? d0 : d0 - drift, baum_dt, slop);
  }
  if (!fresh) {
    for (int k = 0; k < N_SLOT; ++k) G.ikn[k] = g[(G_SLOT + 5 * k + 3) * pb + pi];
    return;
  }
  const float* n = G.n;
  const float ime = w.ime[R], imx = w.ime[b + R], imy = w.ime[2 * b + R], imz = w.ime[3 * b + R];
  const float cime = w.ime[C], cimx = w.ime[b + C], cimy = w.ime[2 * b + C], cimz = w.ime[3 * b + C];
  for (int k = 0; k < N_SLOT; ++k) {
    const float* ra = G.ra[k];
    const float rbv[3] = {ra[0] - G.dc[0], ra[1] - G.dc[1], ra[2] - G.dc[2]};
    const float an[3] = {ra[1] * n[2] - ra[2] * n[1], ra[2] * n[0] - ra[0] * n[2], ra[0] * n[1] - ra[1] * n[0]};
    const float bn[3] = {rbv[1] * n[2] - rbv[2] * n[1], rbv[2] * n[0] - rbv[0] * n[2], rbv[0] * n[1] - rbv[1] * n[0]};
    const float ang_a = imx * (an[0] * an[0]) + imy * (an[1] * an[1]) + imz * (an[2] * an[2]);
    const float ang_b = cimx * (bn[0] * bn[0]) + cimy * (bn[1] * bn[1]) + cimz * (bn[2] * bn[2]);
    G.ikn[k] = 1.f / (ime + cime + ang_a + ang_b + 1e-9f);
    if (owner) w.pgeo[(G_SLOT + 5 * k + 3) * pb + pi] = G.ikn[k];
  }
}

// One pair, one pass: from the pass's velocity snapshot `vin` and λ caches
// `lin`, the pair's j, torque_a and torque_b; the owner writes the updated
// caches to `lout`.
__device__ void pair_solve(const Args& A, int R, int C, size_t pi, const PairGeo& G, const float* vin,
                           const __nv_bfloat16* lin, __nv_bfloat16* lout, bool owner, bool is_warm, float jt[3],
                           float ta[3], float tb[3]) {
  const int b = A.b;
  const size_t pb = size_t(BAND) * b;
  const float warm = A.warm;
  for (int c = 0; c < 3; ++c) { jt[c] = 0.f; ta[c] = 0.f; tb[c] = 0.f; }
  const float* n = G.n;
  const float* dc = G.dc;
  float rv_[3], rw_[3], cv_[3], cw_[3];
  for (int c = 0; c < 3; ++c) {
    rv_[c] = vin[c * b + R]; rw_[c] = vin[(3 + c) * b + R];
    cv_[c] = vin[c * b + C]; cw_[c] = vin[(3 + c) * b + C];
  }
  const float mu = sqrtf(A.rows[I_FRIC * b + R] * A.rows[I_FRIC * b + C]);
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
    // the pair's caches, all read before any is written
    float lold[N_LAM];
    for (int f = 0; f < N_LAM; ++f) lold[f] = __bfloat162float(lin[size_t(f) * pb + pi]);
    // per-slot normal impulses, then one friction solve at the touching points' centroid
    float sum_ln = 0.f, c_a[3] = {0.f, 0.f, 0.f}, c_w = 0.f;
    for (int k = 0; k < N_SLOT; ++k) {
      const float* ra = G.ra[k];
      const float rbv[3] = {ra[0] - dc[0], ra[1] - dc[1], ra[2] - dc[2]};
      const float bias = G.bias[k];
      const float touch = bias > -1e29f ? 1.f : 0.f;
      const size_t li = size_t(k) * pb + pi;
      const float ln_old = lold[k];
      float ln_eff, dl;
      if (is_warm) {
        ln_eff = bf(ln_old * (touch * warm));
        dl = ln_eff;
      } else {
        float rv[3];
        rel_vel(ra, rbv, rv);
        const float vn = rv[0] * n[0] + rv[1] * n[1] + rv[2] * n[2];
        ln_eff = bf(fmaxf(ln_old - (vn - bias) * G.ikn[k], 0.f));
        dl = ln_eff - ln_old;
      }
      if (owner) lout[li] = __float2bfloat16_rn(ln_eff);
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
    for (int c = 0; c < 3; ++c) lt_old[c] = lold[N_SLOT + c];
    if (is_warm) {
      const float gate = (c_w > 0.5f ? 1.f : 0.f) * warm;
      for (int c = 0; c < 3; ++c) { lt_s[c] = bf(lt_old[c] * gate); dj[c] = lt_s[c]; }
    } else {
      float rv[3];
      rel_vel(ra, rbv, rv);
      const float vn = rv[0] * n[0] + rv[1] * n[1] + rv[2] * n[2];
      const float ikn0 = G.ikn[0];
      float lt_c[3];
      for (int c = 0; c < 3; ++c) lt_c[c] = lt_old[c] - (rv[c] - vn * n[c]) * ikn0;
      const float ltl = sqrtf(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9f;
      const float tscale = fminf(mu * sum_ln / ltl, 1.f);
      for (int c = 0; c < 3; ++c) { lt_s[c] = bf(lt_c[c] * tscale); dj[c] = lt_s[c] - lt_old[c]; }
    }
    if (owner)
      for (int c = 0; c < 3; ++c) lout[size_t(N_SLOT + c) * pb + pi] = __float2bfloat16_rn(lt_s[c]);
    apply(dj, ra, rbv);
  } else {
    // cold projected Jacobi: per slot, normal and friction from this pass's velocities
    for (int k = 0; k < N_SLOT; ++k) {
      const float* ra = G.ra[k];
      const float rbv[3] = {ra[0] - dc[0], ra[1] - dc[1], ra[2] - dc[2]};
      const float ikn = G.ikn[k], bias = G.bias[k];
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

// The pair (R, C, d) of list entry e of body a: row entries first.
__device__ __forceinline__ void list_pair(const Ws& w, int a, int e, int nr, int& R, int& C, int& d) {
  const bool row = e < nr;
  d = 1 + (row ? w.rowl[size_t(a) * BAND + e] : w.coll[size_t(a) * BAND + e - nr]);
  R = row ? a : a - d;
  C = row ? a + d : a;
}

// What a lane keeps through one substep's sweeps when its warp owns one body
// for the whole call: the body's list sizes, the lane's first pair (its
// geometry and biases do not change within a substep) and its plane point.
struct SweepCache {
  int nr, n, R, C, d;
  PairGeo G;
  float r[3], pn[3], bias, ikn, mu, lam[4];
};

// One sweep for body a (one warp): lanes compute its pairs' impulses (over
// its row and column lists, 32 at a time) and its plane points (lane q < NPK);
// lane 0 adds them, taken from the lanes by shuffles, in the first port's
// order: the row side over d ascending, the column side over the row body
// ascending, chunk by chunk (128-row chunks in chunk order, as the TPU kernel
// adds its slabs), -row + column, then the touching plane points one at a
// time. With the few terms a body has, this gives the plain version's bits in
// most bodies, so the bf16 λ caches round as the plain version's do. Lane 0
// writes the Jacobi update to `vout`. With `cache` the lane's pair and plane
// point are read from it (loaded in the substep's first sweep, `load`).
__device__ __forceinline__ void sweep_body(const Args& A, int a, int lane, int pc, bool rebuild, bool fresh,
                                           bool is_warm, const float* vin, float* vout, const __nv_bfloat16* lin,
                                           __nv_bfloat16* lout, SweepCache* cache, bool load) {
  const Ws& w = A.w;
  const float* rows = A.rows;
  const int b = A.b;
  const size_t qb = size_t(NPK) * b;
  if (cache && load) {
    cache->nr = w.nrow[a];
    cache->n = cache->nr + w.ncol[a];
  }
  const int nr = cache ? cache->nr : w.nrow[a], n = cache ? cache->n : nr + w.ncol[a];
  // the body's own velocities and update factors, loaded before the pairs so their latency hides
  float v[3], om[3], upd[8];
  for (int c = 0; c < 3; ++c) {
    v[c] = vin[c * b + a];
    om[c] = vin[(3 + c) * b + a];
    upd[c] = rows[(I_DOF + c) * b + a];
    upd[3 + c] = rows[(I_IM3 + c) * b + a];
  }
  upd[6] = rows[I_INVM * b + a];
  upd[7] = rows[I_MOV * b + a];
  float row[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, col[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int chunk = -1;
  const bool timing = A.cycles != nullptr;
  long long mark = timing ? clock64() : 0, pairs_cy = 0, sums_cy = 0;
  for (int base = 0; base < n; base += 32) {
    float t[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // j and the body's torque: torque_a as row, torque_b as column
    int R = a, C = a, d = 0;
    if (base + lane < n) {
      PairGeo G_;
      PairGeo& G = cache && base == 0 ? cache->G : G_;
      if (cache && base == 0 && !load) {
        R = cache->R; C = cache->C; d = cache->d;
      } else {
        list_pair(w, a, base + lane, nr, R, C, d);
        pair_geo(A, R, C, size_t(R) * BAND + d - 1, pc, rebuild, fresh, R == a, G);
        if (cache && base == 0) { cache->R = R; cache->C = C; cache->d = d; }
      }
      const bool owner = R == a;
      const size_t pi = size_t(R) * BAND + d - 1;
      float jt[3], ta[3], tb[3];
      pair_solve(A, R, C, pi, G, vin, lin, lout, owner, is_warm, jt, ta, tb);
      for (int c = 0; c < 3; ++c) { t[c] = jt[c]; t[3 + c] = owner ? ta[c] : tb[c]; }
    }
    if (timing) {
      __syncwarp();
      const long long now = clock64();
      pairs_cy += now - mark;
      mark = now;
    }
    const int m = n - base < 32 ? n - base : 32;
#pragma unroll 4
    for (int l = 0; l < m; ++l) {
      float v[6];
      for (int k = 0; k < 6; ++k) v[k] = __shfl_sync(FULL_MASK, t[k], l);
      const int rb = __shfl_sync(FULL_MASK, R, l);
      if (lane != 0) continue;
      if (base + l < nr) {
        for (int k = 0; k < 6; ++k) row[k] = row[k] + v[k];
      } else {
        if (rb / BAND != chunk) {
          for (int k = 0; k < 6; ++k) { col[k] = col[k] + part[k]; part[k] = 0.f; }
          chunk = rb / BAND;
        }
        for (int k = 0; k < 6; ++k) part[k] = part[k] + v[k];
      }
    }
    if (timing) {
      const long long now = clock64();
      sums_cy += now - mark;
      mark = now;
    }
  }
  float acc[3], tq[3];
  for (int c = 0; c < 3; ++c) {
    acc[c] = -row[c] + (col[c] + part[c]);
    tq[c] = -row[3 + c] + (col[3 + c] + part[3 + c]);
  }
  float r[3] = {0.f, 0.f, 0.f}, pj[3] = {0.f, 0.f, 0.f};
  bool touching = false;
  if (lane < NPK) {
    const size_t qa = size_t(lane) * b + a;
    const float warm = A.warm;
    float n_[3], lam[4], bias, ikn, mu;
    if (!cache || load) {
      for (int c = 0; c < 3; ++c) { r[c] = w.pgp[(P_R + c) * qb + qa]; n_[c] = w.pgp[(P_N + c) * qb + qa]; }
      for (int f = 0; f < 4; ++f) lam[f] = w.plam[f * qb + qa];
      bias = w.pgp[P_BIAS * qb + qa];
      ikn = w.pgp[P_IKN * qb + qa];
      mu = w.pgp[P_MU * qb + qa];
    } else {
      for (int c = 0; c < 3; ++c) { r[c] = cache->r[c]; n_[c] = cache->pn[c]; }
      for (int f = 0; f < 4; ++f) lam[f] = cache->lam[f];
      bias = cache->bias;
      ikn = cache->ikn;
      mu = cache->mu;
    }
    touching = bias > -1e29f;
    if (is_warm) {
      const float pt = (bias > -1e29f ? 1.f : 0.f) * warm;
      for (int f = 0; f < 4; ++f) lam[f] = lam[f] * pt;
      for (int c = 0; c < 3; ++c) pj[c] = n_[c] * lam[0] + lam[1 + c];
    } else {
      float rv[3], tv[3];
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
        rv[c] = v[c] + om[c1] * r[c2] - om[c2] * r[c1];
      }
      const float vn = rv[0] * n_[0] + rv[1] * n_[1] + rv[2] * n_[2];
      for (int c = 0; c < 3; ++c) tv[c] = rv[c] - vn * n_[c];
      if (warm > 0.f) {
        const float ln_new = fmaxf(lam[0] - (vn - bias) * ikn, 0.f);
        const float dlam = ln_new - lam[0];
        float lt_c[3];
        for (int c = 0; c < 3; ++c) lt_c[c] = lam[1 + c] - tv[c] * ikn;
        const float ltl = sqrtf(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9f;
        const float tscale = fminf(mu * ln_new / ltl, 1.f);
        for (int c = 0; c < 3; ++c) {
          const float lt_n = lt_c[c] * tscale;
          pj[c] = n_[c] * dlam + (lt_n - lam[1 + c]);
          lam[1 + c] = lt_n;
        }
        lam[0] = ln_new;
      } else {
        const float lamn = fmaxf(-(vn - bias) * ikn, 0.f);
        const float tvl = sqrtf(tv[0] * tv[0] + tv[1] * tv[1] + tv[2] * tv[2]) + 1e-9f;
        const float lam_t = fminf(tvl * ikn, mu * lamn);
        for (int c = 0; c < 3; ++c) pj[c] = n_[c] * lamn - tv[c] / tvl * lam_t;
      }
    }
    if (warm > 0.f)
      for (int f = 0; f < 4; ++f) w.plam[f * qb + qa] = lam[f];
    if (cache) {
      for (int c = 0; c < 3; ++c) { cache->r[c] = r[c]; cache->pn[c] = n_[c]; }
      for (int f = 0; f < 4; ++f) cache->lam[f] = lam[f];
      cache->bias = bias;
      cache->ikn = ikn;
      cache->mu = mu;
    }
  }
  // a plane point that does not touch adds a zero impulse (±0), so only the touching ones are added
  for (unsigned tm = __ballot_sync(FULL_MASK, touching); tm; tm &= tm - 1) {
    const int q = __ffs(tm) - 1;
    float rq[3], jq[3];
    for (int c = 0; c < 3; ++c) { rq[c] = __shfl_sync(FULL_MASK, r[c], q); jq[c] = __shfl_sync(FULL_MASK, pj[c], q); }
    for (int c = 0; c < 3; ++c) acc[c] = acc[c] + jq[c];
    for (int c = 0; c < 3; ++c) {
      const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
      tq[c] = tq[c] + rq[c1] * jq[c2] - rq[c2] * jq[c1];
    }
  }
  if (lane == 0) {
    float mov_f = upd[7];
    if (A.sleep) mov_f = mov_f * (1.f - w.slp[a]);
    for (int c = 0; c < 3; ++c) {
      vout[c * b + a] = v[c] + acc[c] * upd[6] * upd[c] * mov_f;
      vout[(3 + c) * b + a] = om[c] + tq[c] * upd[3 + c] * mov_f;
    }
    if (timing) {
      sums_cy += clock64() - mark;
      atomicAdd(&A.cycles[WARP_PAIRS], (unsigned long long)pairs_cy);
      atomicAdd(&A.cycles[WARP_SUMS], (unsigned long long)sums_cy);
    }
  }
}

// Body a's positions and orientation from pose[pc] into pose[pc ^ 1] (one thread).
__device__ void integrate(const Args& A, int a, int pc, const float* vel) {
  const Ws& w = A.w;
  const int b = A.b;
  const float* p = w.pose[pc];
  float* q = w.pose[pc ^ 1];
  const float dt = A.sc[0];
  const float mov = A.rows[I_MOV * b + a];
  float mov_dt = mov * dt;
  if (A.sleep) mov_dt = mov_dt * (1.f - w.slp[a]);
  for (int c = 0; c < 3; ++c) q[c * b + a] = p[c * b + a] + vel[c * b + a] * mov_dt;
  const float hq = 0.5f * dt;
  const float wx = vel[3 * b + a], wy = vel[4 * b + a], wz = vel[5 * b + a];
  const float qx = p[S_Q * b + a], qy = p[(S_Q + 1) * b + a], qz = p[(S_Q + 2) * b + a], qw = p[(S_Q + 3) * b + a];
  const float mov_f = A.sleep ? mov * (1.f - w.slp[a]) : mov;
  const float dqx = hq * (wx * qw + wy * qz - wz * qy);
  const float dqy = hq * (-wx * qz + wy * qw + wz * qx);
  const float dqz = hq * (wx * qy - wy * qx + wz * qw);
  const float dqw = hq * (-wx * qx - wy * qy - wz * qz);
  const float nx = qx + dqx * mov_f, ny = qy + dqy * mov_f, nz = qz + dqz * mov_f, nw = qw + dqw * mov_f;
  const float qn = rsqrtf(nx * nx + ny * ny + nz * nz + nw * nw + 1e-12f);
  q[S_Q * b + a] = nx * qn; q[(S_Q + 1) * b + a] = ny * qn; q[(S_Q + 2) * b + a] = nz * qn;
  q[(S_Q + 3) * b + a] = nw * qn;
}

// Sleep flags of body a from its velocity after the last sweep (one thread).
__device__ void sleep_flags(const Args& A, int a, const float* vel) {
  const Ws& w = A.w;
  const int b = A.b;
  const float v2 = vel[a] * vel[a] + vel[b + a] * vel[b + a] + vel[2 * b + a] * vel[2 * b + a];
  const float w2 = vel[3 * b + a] * vel[3 * b + a] + vel[4 * b + a] * vel[4 * b + a] + vel[5 * b + a] * vel[5 * b + a];
  const float moving = v2 + A.rows[I_REFF2 * b + a] * w2 >= A.sc[8 + N_PLANE * PLANE_SC] ? 1.f : 0.f;
  w.moving[a] = moving;
  w.pusher[a] = A.rows[I_DYN * b + a] * (1.f - w.slp[a]) * moving;
}

// Wake propagation from touching pairs whose other side is an awake moving
// dynamic body (both pair directions; every term is 0 or 1, so an any() is
// the sum's test), the deactivation timers, sleeping bodies stop; then the
// integration, and the next substep's gate.
__device__ void sleep_update(const Args& A, int a, int lane, int pc, float* vel, int step) {
  const Ws& w = A.w;
  const int b = A.b;
  const int nr = w.nrow[a], nc = w.ncol[a];
  bool wake = false;
  for (int e = lane; e < nr + nc; e += 32) {
    int R, C, d;
    list_pair(w, a, e, nr, R, C, d);
    const size_t pi = size_t(R) * BAND + d - 1;
    PairGeo G;
    pair_geo(A, R, C, pi, pc, (step % A.geom_every) == 0, false, false, G);
    bool touch = false;
    for (int k = 0; k < N_SLOT; ++k) touch = touch || G.bias[k] > -1e29f;
    wake = wake || (touch && w.pusher[R == a ? C : R] > 0.5f);
  }
  const float wk = __any_sync(FULL_MASK, wake) ? 1.f : 0.f;
  if (lane != 0) return;
  const float dt = A.sc[0], sleep_time = A.sc[8 + N_PLANE * PLANE_SC + 1];
  const float eligible = (1.f - w.moving[a]) * A.rows[I_CANSLEEP * b + a] * (1.f - wk);
  const float timer = (w.tmr[a] + dt) * eligible;
  const float fall = (timer >= sleep_time ? 1.f : 0.f) * eligible;
  const float s = fminf(w.slp[a] * (1.f - wk) + fall, 1.f);
  w.slp[a] = s;
  w.tmr[a] = timer;
  const float keep = 1.f - s;
  for (int c = 0; c < 6; ++c) vel[c * b + a] = vel[c * b + a] * keep;
  integrate(A, a, pc, vel);
  if (A.rows[I_MOV * b + a] * (1.f - s) > 0.5f) atomicOr(&w.gate[(step + 1) & 1], 1);
}

__global__ void __launch_bounds__(TPB, 1) k_banded(const __grid_constant__ Args A) {
  cg::grid_group grid = cg::this_grid();
  const Ws& w = A.w;
  const float* rows = A.rows;
  const int b = A.b;
  const int tid = blockIdx.x * TPB + threadIdx.x, nthreads = gridDim.x * TPB;
  const int lane = threadIdx.x & 31, gwarp = tid >> 5, nwarps = nthreads >> 5;
  const int ge = A.geom_every;
  const bool warm_mode = A.warm > 0.f;
  PassClock clock{A.cycles, 0};
  clock.start();

  // ---- init: state from the input rows, caches zeroed; without sleeping the first substep's pre
  if (warm_mode) {
    const size_t words = size_t(N_LAM) * BAND * b;  // both bf16 buffers as 32-bit words
    for (size_t i = tid; i < words; i += nthreads) ((unsigned*)w.lam[0])[i] = 0u;
  }
  for (int i = tid; i < MASK_W * b; i += nthreads) w.mask[i] = 0u;
  if (tid == 0) { w.gate[0] = 0; w.gate[1] = 0; }
  for (int a = gwarp; a < b; a += nwarps) {
    if (lane == 0) {
      for (int f = 0; f < 3; ++f) {
        w.pose[0][f * b + a] = rows[(I_P + f) * b + a];
        w.vel[0][f * b + a] = rows[(I_V + f) * b + a];
        w.vel[0][(3 + f) * b + a] = rows[(I_W + f) * b + a];
      }
      for (int f = 0; f < 4; ++f) w.pose[0][(S_Q + f) * b + a] = rows[(I_Q + f) * b + a];
      w.slp[a] = rows[I_SLEEP0 * b + a];
      w.tmr[a] = rows[I_TIMER0 * b + a];
      w.nrow[a] = 0;
      w.ncol[a] = 0;
    }
    if (lane < NPK)
      for (int f = 0; f < 4; ++f) w.plam[(size_t(f) * NPK + lane) * b + a] = 0.f;
    __syncwarp();
    if (!A.sleep && A.n_substeps > 0) pre(A, a, lane, 0, w.vel[0], false);
  }
  clock.end(grid, PASS_PRE);
  if (A.sleep) {
    for (int a = tid; a < b; a += nthreads)
      if (rows[I_MOV * b + a] * (1.f - w.slp[a]) > 0.5f) atomicOr(&w.gate[0], 1);
    clock.end(grid, PASS_PRE);
  }

  int pc = 0, cur = 0, lcur = 0;  // pose, velocity and λ-cache buffers in use (the same in every thread)
  const int first = warm_mode ? 0 : 1;
  // with a warp for each body, a lane keeps its pair and plane point through a substep's sweeps
  SweepCache cache;
  SweepCache* keep = b <= nwarps ? &cache : nullptr;
  for (int step = 0; step < A.n_substeps; ++step) {
    const bool rebuild = step % ge == 0;
    if (A.sleep) {
      // a substep runs only while some movable body is awake; once none is, none wakes
      if (__ldcg(&w.gate[step & 1]) == 0) break;
      if (tid == 0) w.gate[(step + 1) & 1] = 0;
      for (int a = gwarp; a < b; a += nwarps) pre(A, a, lane, pc, w.vel[cur], !rebuild);
      clock.end(grid, PASS_PRE);
    }
    if (rebuild) {
      for (int a = gwarp; a < b; a += nwarps) geom(A, a, lane, pc);
      clock.end(grid, PASS_GEOM);
      for (int a = gwarp; a < b; a += nwarps) lists(A, a, lane, pc);
      clock.end(grid, PASS_LISTS);
    }
    const bool more = step + 1 < A.n_substeps;
    const bool next_ikn = more && (step + 1) % ge != 0;
    bool pre_done = false;
    if (first > A.iterations) {
      // no sweep: the velocities stay; finish the substep in a pass of its own
      for (int a = gwarp; a < b; a += nwarps)
        if (lane == 0) {
          if (A.sleep) sleep_flags(A, a, w.vel[cur]);
          else integrate(A, a, pc, w.vel[cur]);
        }
      clock.end(grid, PASS_SWEEP);
    }
    for (int it = first; it <= A.iterations; ++it) {
      const bool is_warm = it == 0, fresh = rebuild && it == first, last = it == A.iterations;
      // the next substep's pre may share the last sweep's pass unless that pass reads
      // the masses it would overwrite (a fresh sweep computes 1/kn from both bodies')
      const bool fuse = last && !A.sleep && more && !fresh;
      const float* vin = w.vel[cur];
      float* vout = w.vel[cur ^ 1];
      for (int a = gwarp; a < b; a += nwarps) {
        sweep_body(A, a, lane, pc, rebuild, fresh, is_warm, vin, vout, w.lam[lcur], w.lam[lcur ^ 1], keep,
                   it == first);
        if (!last) continue;
        if (lane == 0) {
          if (A.sleep) sleep_flags(A, a, vout);
          else integrate(A, a, pc, vout);
        }
        if (fuse) {
          __syncwarp();
          pre(A, a, lane, pc ^ 1, vout, next_ikn);
        }
      }
      pre_done = pre_done || fuse;
      cur ^= 1;
      if (warm_mode) lcur ^= 1;
      clock.end(grid, PASS_SWEEP);
    }
    if (A.sleep) {
      for (int a = gwarp; a < b; a += nwarps) sleep_update(A, a, lane, pc, w.vel[cur], step);
      clock.end(grid, PASS_SLEEP);
    }
    pc ^= 1;
    if (!A.sleep && more && !pre_done) {
      for (int a = gwarp; a < b; a += nwarps) pre(A, a, lane, pc, w.vel[cur], next_ikn);
      clock.end(grid, PASS_PRE);
    }
  }

  for (int a = tid; a < b; a += nthreads) {
    for (int f = 0; f < 3; ++f) {
      A.out[(I_P + f) * b + a] = w.pose[pc][f * b + a];
      A.out[(I_V + f) * b + a] = w.vel[cur][f * b + a];
      A.out[(I_W + f) * b + a] = w.vel[cur][(3 + f) * b + a];
    }
    for (int f = 0; f < 4; ++f) A.out[(I_Q + f) * b + a] = w.pose[pc][(S_Q + f) * b + a];
    A.out[13 * b + a] = A.sleep ? w.slp[a] : rows[I_SLEEP0 * b + a];
    A.out[14 * b + a] = A.sleep ? w.tmr[a] : rows[I_TIMER0 * b + a];
  }
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

// One cooperative launch for the whole call. `cycles` (or null): per pass
// kind, the SM cycles of block 0 from barrier to barrier, added to.
extern "C" int banded_substeps(const float* scalars, const float* rows, float* out, void* workspace,
                               unsigned long long* cycles, int b, int n_substeps, int iterations, float warm,
                               int geom_every, int sleep, void* stream) {
  if (b < 2 * BAND || b % BAND != 0 || n_substeps < 0 || iterations < 0 || geom_every < 1)
    return (int)cudaErrorInvalidValue;
  Args args;
  carve(&args.w, (char*)workspace, b);
  args.sc = scalars;
  args.rows = rows;
  args.out = out;
  args.cycles = cycles;
  args.b = b;
  args.n_substeps = n_substeps;
  args.iterations = iterations;
  args.geom_every = geom_every;
  args.sleep = sleep;
  args.warm = warm;
  return launch_persistent((const void*)k_banded, &args, b, TPB, (cudaStream_t)stream);
}
