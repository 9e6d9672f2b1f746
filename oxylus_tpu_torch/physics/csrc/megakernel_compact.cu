// Compact rigid-body substeps for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by `oxylus_tpu_torch/_build.py`.
//
// Replaces the TPU kernel `oxylus_tpu/physics/megakernel_compact.py::_compact_kernel`
// (launched by `megakernel_substeps_compact`). Same contract: bodies arrive
// sorted by slab rank; per substep gravity, AABBs, every `geom_every` substeps a
// rebuild (in-band discovery keeping the first R overlapping partners by
// ascending rank delta, λ-cache remap by partner delta, SAT manifolds),
// otherwise a bias refresh; hub-plane contacts, mass-split effective masses, a
// warm pass plus `iterations` projected-Jacobi sweeps over one velocity snapshot
// each, optional sleeping, integration. Pair λ caches are bf16 stored with
// __float2bfloat16_rn, as the TPU kernel's LAM_DT.
//
// What bounds it on the card: at the flagship size (B=1024, R=16) a substep
// touches a few MB that stay in L2, so the work is small and latency-bound —
// ~15 dependent launches per substep, each a few microseconds, and the
// rebuild's walks over the band dominate. The design keeps it deterministic:
// one thread per body or per (slot, body) pair for the solver, field-major
// (SoA) buffers so neighbouring threads read neighbouring addresses, and the
// whole substep loop driven from C so a 60-substep call costs one Python call.
// The rebuild's three walks (k_discover, k_remap, k_reverse) run a warp per
// body: lanes take consecutive rank deltas (k_reverse: each lane one delta,
// looping over its R slots; k_remap: one lane per new slot), and
// __ballot_sync with a __popc prefix keeps the first R partners in ascending
// delta and the first matching slot per delta, so d_new, rev, revcnt,
// paircnt and ovf are the same integers as the serial walks give. (One thread
// per body walked band × R strided reads in k_reverse: half the call's device
// time.) The col-side impulse scatter uses that reverse index (per body, the
// (slot, row) pairs that name it, in ascending delta), so results do not
// depend on thread timing and no atomics are needed. One persistent launch
// per call, shared-memory tiles and CUDA graphs are later work.
//
// Built with -fmad=false: every product and sum rounds on its own, as the plain
// PyTorch version's separate tensor ops do, so the two differ only where sums
// are taken in another order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_sat.cuh"

#define N_PLANE 4
#define PLANE_SC 16
#define N_SLOT 4
#define N_LAM 7
#define N_PGEO 34
#define N_PIMP 9
#define N_PGP 9
#define SLEEP_EVERY 4
#define MAX_R 32

// per-body input rows (see `_input_rows`)
enum {
  I_P = 0, I_V = 3, I_W = 6, I_Q = 9, I_INVM = 13, I_IM3 = 14, I_H = 17, I_RAD = 20, I_HLEN = 21,
  I_FRIC = 22, I_GRAV = 24, I_DOF = 25, I_BOX = 28, I_DYN = 29, I_MOV = 30, I_ACT = 31,
  I_SLEEP0 = 32, I_TIMER0 = 33, I_REFF2 = 34, I_CANSLEEP = 35,
};
// pair geometry fields, each (R, B)
enum { G_N = 0, G_MU = 3, G_D0 = 4, G_DC = 7, G_SLOT = 10 };  // slot k: +6k: ra(3) ikn bias depth0
// plane geometry fields, each (NPK, B)
enum { P_R = 0, P_IKN = 3, P_BIAS = 4, P_N = 5, P_MU = 8 };

struct Dims {
  int b, R, band, n_planes, npk;
};

struct Ws {
  float *st;       // 13 × B: pos, linvel, angvel, quat
  float *rot;      // 9 × B row-major rotation
  float *eh;       // 3 × B AABB half extents (+margin)
  float *ca;       // 3 × B capsule half-segment
  float *ime;      // 4 × B mass-split inverse mass / inertia
  float *paircnt, *ovf, *slp, *tmr, *pusher, *moving;  // B each
  float *pgeo;     // N_PGEO × R × B
  float *pimp;     // N_PIMP × R × B: j, torque_a, torque_b
  float *pgp;      // N_PGP × NPK × B
  float *plam;     // 4 × NPK × B
  int *d_cur, *d_new;  // R × B partner rank deltas (0 = empty)
  int *rev;        // band × B: pair index (r*B + a) of pairs whose partner is this body
  int *revcnt;     // B
  int *gate;       // 1: any body awake this substep (sleep mode)
  __nv_bfloat16 *lam_cur, *lam_next;  // N_LAM × R × B
};

static size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

static size_t carve(Ws* w, char* base, Dims d) {
  size_t off = 0;
  size_t b = d.b, rb = size_t(d.R) * d.b, pb = size_t(d.npk) * d.b;
  auto take = [&](size_t bytes) { char* p = base ? base + off : nullptr; off = align_up(off + bytes); return p; };
  w->st = (float*)take(13 * b * 4);
  w->rot = (float*)take(9 * b * 4);
  w->eh = (float*)take(3 * b * 4);
  w->ca = (float*)take(3 * b * 4);
  w->ime = (float*)take(4 * b * 4);
  w->paircnt = (float*)take(b * 4);
  w->ovf = (float*)take(b * 4);
  w->slp = (float*)take(b * 4);
  w->tmr = (float*)take(b * 4);
  w->pusher = (float*)take(b * 4);
  w->moving = (float*)take(b * 4);
  w->pgeo = (float*)take(N_PGEO * rb * 4);
  w->pimp = (float*)take(N_PIMP * rb * 4);
  w->pgp = (float*)take(N_PGP * pb * 4);
  w->plam = (float*)take(4 * pb * 4);
  w->d_cur = (int*)take(rb * 4);
  w->d_new = (int*)take(rb * 4);
  w->rev = (int*)take(size_t(d.band) * b * 4);
  w->revcnt = (int*)take(b * 4);
  w->gate = (int*)take(4);
  w->lam_cur = (__nv_bfloat16*)take(N_LAM * rb * 2);
  w->lam_next = (__nv_bfloat16*)take(N_LAM * rb * 2);
  return off;
}

#define GATED if (w.gate && *w.gate == 0) return;
#define BODY_THREAD                                     \
  const int a = blockIdx.x * blockDim.x + threadIdx.x; \
  if (a >= d.b) return;
// one warp per body: launch with LAUNCH_WARPS
#define BODY_WARP                                                  \
  const int a = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;      \
  const int lane = threadIdx.x & 31;                               \
  if (a >= d.b) return;
#define FULL_MASK 0xffffffffu
#define PAIR_THREAD                                       \
  const int idx = blockIdx.x * blockDim.x + threadIdx.x; \
  if (idx >= d.R * d.b) return;                          \
  const int a = idx % d.b;

__global__ void k_init(const float* __restrict__ rows, Ws w, Dims d) {
  BODY_THREAD
  const int b = d.b;
  for (int f = 0; f < 13; ++f) w.st[f * b + a] = rows[f * b + a];
  w.slp[a] = rows[I_SLEEP0 * b + a];
  w.tmr[a] = rows[I_TIMER0 * b + a];
  w.ovf[a] = 0.f;
  for (int r = 0; r < d.R; ++r) {
    w.d_cur[r * b + a] = 0;
    for (int f = 0; f < N_LAM; ++f) w.lam_cur[(f * d.R + r) * b + a] = __float2bfloat16_rn(0.f);
  }
  for (int f = 0; f < 4; ++f)
    for (int q = 0; q < d.npk; ++q) w.plam[(f * d.npk + q) * b + a] = 0.f;
}

__global__ void k_awake(const float* __restrict__ rows, Ws w, Dims d) {
  BODY_THREAD
  if (rows[I_MOV * d.b + a] * (1.f - w.slp[a]) > 0.5f) atomicOr(w.gate, 1);
}

__global__ void k_pre(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, Dims d, int sleep) {
  BODY_THREAD GATED
  const int b = d.b;
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

// Row body a scans ranks a+1 … min(a+band, B-1), keeps the first R overlapping
// candidates in ascending delta, counts the rest as dropped. A warp per body:
// lane l tests delta base + l; a ballot's __popc prefix gives each kept
// candidate its slot.
__global__ void k_discover(const float* __restrict__ rows, Ws w, Dims d) {
  BODY_WARP GATED
  const int b = d.b;
  const float dyn_a = rows[I_DYN * b + a], act_a = rows[I_ACT * b + a];
  float p[3], e[3];
  for (int c = 0; c < 3; ++c) { p[c] = w.st[c * b + a]; e[c] = w.eh[c * b + a]; }
  int found = 0;  // overlapping candidates in the deltas walked so far
  for (int base = 1; base <= d.band && a + base < b; base += 32) {
    const int dd = base + lane, j = a + dd;
    bool active = false;
    if (dd <= d.band && j < b) {
      bool ov = true;
      for (int c = 0; c < 3; ++c) ov = ov && (fabsf(w.st[c * b + j] - p[c]) <= e[c] + w.eh[c * b + j]);
      active = ov && ((dyn_a + rows[I_DYN * b + j]) > 0.5f) && ((act_a * rows[I_ACT * b + j]) > 0.5f);
    }
    const unsigned m = __ballot_sync(FULL_MASK, active);
    const int slot = found + __popc(m & ((1u << lane) - 1u));
    if (active && slot < d.R) w.d_new[slot * b + a] = dd;
    found += __popc(m);
  }
  const int kept = min(found, d.R);
  for (int r = kept + lane; r < d.R; r += 32) w.d_new[r * b + a] = 0;
  if (lane == 0) {
    w.paircnt[a] = (float)kept;
    w.ovf[a] = (float)(found - kept);
  }
}

// New slot inherits the λ of the old slot with the same partner delta (the
// last such slot, as a serial walk over the old slots finds it); unmatched
// slots start cold. A warp per body, lane rn the new slot rn.
__global__ void k_remap(Ws w, Dims d) {
  BODY_WARP GATED
  const int b = d.b;
  const int dc = lane < d.R ? w.d_cur[lane * b + a] : 0;
  const int dn = lane < d.R ? w.d_new[lane * b + a] : 0;
  int src = -1;
  for (int ro = 0; ro < d.R; ++ro)
    if (__shfl_sync(FULL_MASK, dc, ro) == dn && dn > 0) src = ro;
  if (lane < d.R)
    for (int f = 0; f < N_LAM; ++f)
      w.lam_next[(f * d.R + lane) * b + a] =
          src >= 0 ? w.lam_cur[(f * d.R + src) * b + a] : __float2bfloat16_rn(0.f);
}

// Reverse index: the pairs (r, i) whose partner is body j, in ascending delta;
// also adds the col-side pair count. A warp per body: lane l takes delta
// base + l (row i = j - delta, coalesced over the lanes) and finds the first
// of i's slots holding that delta, reading REV_BATCH slots at a time so their
// loads overlap; a ballot's __popc prefix keeps the order.
#define REV_BATCH 16
__global__ void k_reverse(Ws w, Dims d) {
  BODY_WARP GATED
  const int b = d.b, j = a;
  int cnt = 0;
  for (int base = 1; base <= d.band && j - base >= 0; base += 32) {
    const int dd = base + lane, i = j - dd;
    int hit = -1;
    if (dd <= d.band && i >= 0)
      for (int r0 = 0; r0 < d.R && hit < 0; r0 += REV_BATCH) {
        int v[REV_BATCH];
#pragma unroll
        for (int u = 0; u < REV_BATCH; ++u) v[u] = r0 + u < d.R ? w.d_cur[(r0 + u) * b + i] : 0;
#pragma unroll
        for (int u = REV_BATCH - 1; u >= 0; --u)  // the first slot that holds dd (deltas are >= 1)
          if (v[u] == dd) hit = r0 + u;
      }
    const unsigned m = __ballot_sync(FULL_MASK, hit >= 0);
    if (hit >= 0) w.rev[(cnt + __popc(m & ((1u << lane) - 1u))) * b + j] = hit * b + i;
    cnt += __popc(m);
  }
  if (lane == 0) {
    w.revcnt[j] = cnt;
    w.paircnt[j] = w.paircnt[j] + (float)cnt;
  }
}

__device__ __forceinline__ void load_body(const float* __restrict__ rows, const Ws& w, int b, int i, Body& B) {
  for (int k = 0; k < 9; ++k) B.r[k / 3][k % 3] = w.rot[k * b + i];
  for (int c = 0; c < 3; ++c) { B.h[c] = rows[(I_H + c) * b + i]; B.ca[c] = w.ca[c * b + i]; }
  B.rad = rows[I_RAD * b + i];
  B.box = rows[I_BOX * b + i];
}

__global__ void k_sat(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, Dims d) {
  PAIR_THREAD GATED
  const int b = d.b;
  const size_t rb = size_t(d.R) * b;
  const int dd = w.d_cur[idx];
  const int j = a + dd;
  Body A, B;
  load_body(rows, w, b, a, A);
  load_body(rows, w, b, j, B);
  float dc[3];
  for (int c = 0; c < 3; ++c) dc[c] = w.st[c * b + j] - w.st[c * b + a];
  Manifold m;
  pair_manifold(dc[0], dc[1], dc[2], A, B, m);
  float* g = w.pgeo;
  for (int c = 0; c < 3; ++c) {
    g[(G_N + c) * rb + idx] = m.n[c];
    g[(G_D0 + c) * rb + idx] = dc[c];
    g[(G_DC + c) * rb + idx] = dc[c];
  }
  g[G_MU * rb + idx] = sqrtf(rows[I_FRIC * b + a] * rows[I_FRIC * b + j]);
  const float baum_dt = sc[4] / sc[0], slop = sc[5];
  for (int k = 0; k < N_SLOT; ++k) {
    const int o = G_SLOT + 6 * k;
    for (int c = 0; c < 3; ++c) g[(o + c) * rb + idx] = m.p[k][c];
    const float d0 = dd > 0 ? m.depth[k] : -1e30f;
    g[(o + 5) * rb + idx] = d0;
    g[(o + 4) * rb + idx] = d0 > 0.f ? baum_dt * fmaxf(d0 - slop, 0.f) : -1e30f;
  }
}

__global__ void k_refresh(const float* __restrict__ sc, Ws w, Dims d) {
  PAIR_THREAD GATED
  const int b = d.b;
  const size_t rb = size_t(d.R) * b;
  const int j = a + w.d_cur[idx];
  float* g = w.pgeo;
  float dc[3], ddv[3];
  for (int c = 0; c < 3; ++c) {
    dc[c] = w.st[c * b + j] - w.st[c * b + a];
    ddv[c] = dc[c] - g[(G_D0 + c) * rb + idx];
    g[(G_DC + c) * rb + idx] = dc[c];
  }
  const float drift = ddv[0] * g[G_N * rb + idx] + ddv[1] * g[(G_N + 1) * rb + idx] + ddv[2] * g[(G_N + 2) * rb + idx];
  const float baum_dt = sc[4] / sc[0], slop = sc[5];
  for (int k = 0; k < N_SLOT; ++k) {
    const int o = G_SLOT + 6 * k;
    const float d0 = g[(o + 5) * rb + idx];
    const float dv = d0 - drift;
    g[(o + 4) * rb + idx] = (dv > 0.f) && (d0 > -1e29f) ? baum_dt * fmaxf(dv - slop, 0.f) : -1e30f;
  }
}

// Analytic hub planes for body a (all N_SLOT support points per plane), then the
// mass-split inverse masses and the plane effective masses.
__global__ void k_planes(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, Dims d) {
  BODY_THREAD GATED
  const int b = d.b;
  const size_t pb = size_t(d.npk) * b;
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
  for (int pl = 0; pl < d.n_planes; ++pl) {
    const float* P = sc + 8 + pl * PLANE_SC;
    const float dp[3] = {p[0] - P[0], p[1] - P[1], p[2] - P[2]};
    const float side = P[3] * dp[0] + P[4] * dp[1] + P[5] * dp[2];
    const float sgn_p = side >= 0.f ? 1.f : -1.f;
    const float ne[3] = {P[3] * sgn_p, P[4] * sgn_p, P[5] * sgn_p};
    float f[3], uf[3], vf[3];
    incident_face(ax, h, ne[0], ne[1], ne[2], 1.f, f, uf, vf);
    float cnt = 0.f;
    for (int k = 0; k < N_SLOT; ++k) {
      const int q = N_SLOT * pl + k;
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
        w.pgp[(P_R + c) * pb + size_t(q) * b + a] = ra[c];
        w.pgp[(P_N + c) * pb + size_t(q) * b + a] = ne[c];
      }
      w.pgp[P_BIAS * pb + size_t(q) * b + a] = touching ? baum_dt * fmaxf(depth - slop, 0.f) : -1e30f;
      w.pgp[P_MU * pb + size_t(q) * b + a] = sqrtf(fric * P[15]);
      cnt = cnt + (touching ? 1.f : 0.f);
    }
    plane_cnt = plane_cnt + cnt;
  }
  const float split = fmaxf(w.paircnt[a] + plane_cnt, 1.f);
  const float ime = rows[I_INVM * b + a] * split;
  float im[3];
  for (int c = 0; c < 3; ++c) im[c] = rows[(I_IM3 + c) * b + a] * split;
  w.ime[a] = ime;
  for (int c = 0; c < 3; ++c) w.ime[(1 + c) * b + a] = im[c];
  for (int q = 0; q < d.npk; ++q) {
    float r[3], n[3];
    for (int c = 0; c < 3; ++c) {
      r[c] = w.pgp[(P_R + c) * pb + size_t(q) * b + a];
      n[c] = w.pgp[(P_N + c) * pb + size_t(q) * b + a];
    }
    const float cx = r[1] * n[2] - r[2] * n[1], cy = r[2] * n[0] - r[0] * n[2], cz = r[0] * n[1] - r[1] * n[0];
    w.pgp[P_IKN * pb + size_t(q) * b + a] = 1.f / (ime + im[0] * (cx * cx) + im[1] * (cy * cy) + im[2] * (cz * cz) + 1e-9f);
  }
}

__global__ void k_pair_ikn(Ws w, Dims d) {
  PAIR_THREAD GATED
  const int b = d.b;
  const size_t rb = size_t(d.R) * b;
  const int j = a + w.d_cur[idx];
  float* g = w.pgeo;
  const float n[3] = {g[G_N * rb + idx], g[(G_N + 1) * rb + idx], g[(G_N + 2) * rb + idx]};
  const float dc[3] = {g[G_DC * rb + idx], g[(G_DC + 1) * rb + idx], g[(G_DC + 2) * rb + idx]};
  const float ime = w.ime[a], imx = w.ime[b + a], imy = w.ime[2 * b + a], imz = w.ime[3 * b + a];
  const float cime = w.ime[j], cimx = w.ime[b + j], cimy = w.ime[2 * b + j], cimz = w.ime[3 * b + j];
  for (int k = 0; k < N_SLOT; ++k) {
    const int o = G_SLOT + 6 * k;
    const float ra[3] = {g[o * rb + idx], g[(o + 1) * rb + idx], g[(o + 2) * rb + idx]};
    const float rbv[3] = {ra[0] - dc[0], ra[1] - dc[1], ra[2] - dc[2]};
    const float an[3] = {ra[1] * n[2] - ra[2] * n[1], ra[2] * n[0] - ra[0] * n[2], ra[0] * n[1] - ra[1] * n[0]};
    const float bn[3] = {rbv[1] * n[2] - rbv[2] * n[1], rbv[2] * n[0] - rbv[0] * n[2], rbv[0] * n[1] - rbv[1] * n[0]};
    const float ang_a = imx * (an[0] * an[0]) + imy * (an[1] * an[1]) + imz * (an[2] * an[2]);
    const float ang_b = cimx * (bn[0] * bn[0]) + cimy * (bn[1] * bn[1]) + cimz * (bn[2] * bn[2]);
    g[(o + 3) * rb + idx] = 1.f / (ime + cime + ang_a + ang_b + 1e-9f);
  }
}

#include "compact_solve.cuh"
