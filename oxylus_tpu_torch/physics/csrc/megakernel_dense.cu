// Dense all-pairs rigid-body substeps for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by `oxylus_tpu_torch/_build.py`.
//
// Replaces the TPU kernel `oxylus_tpu/physics/megakernel.py::_kernel`
// (launched by `megakernel_substeps`). Same contract, written from what the
// TPU kernel computes rather than its (CHUNK, B) VMEM blocks: per substep
// gravity, rotations, AABB half extents and capsule half-segments; per body
// the count of AABB overlaps as row plus as column (mass splitting); then
// `iterations` stateless projected-Jacobi sweeps over every overlapping
// ordered pair's contact (capsule/capsule, box/capsule both ways, box/box face
// SAT with 4 clamped incident-face corners — the geometry of `compact_sat.cuh`,
// which is the same function), the summed impulses applied with the raw
// masses; then integration.
//
// What bounds it on the card: the function is small (one AABB test per
// unordered pair, one contact geometry per overlapping ordered pair and 93
// operations per touching point and sweep: ~0.0003 ms at the float32 peak for
// a substep of the flagship pile), so the time is the chain of dependent
// passes. The first port took ~13 launches a substep and re-derived every
// overlapping pair's geometry in each of the 10 sweeps, twice (once from each
// body), though positions do not move within a substep.
//
// Design. One persistent cooperative launch runs the whole call; a grid-wide
// barrier separates the passes (per substep: the count, the geometry, one pass
// per sweep). A warp owns one body in every pass:
// - the count: its lanes test all B partners, staged through shared memory
//   by the block, a __ballot_sync with a __popc prefix writes the
//   overlapping partners in ascending order (the first CAP of them) and the
//   count sets the mass split;
// - the geometry: its lanes take the body's partners and compute each
//   ordered pair's contact once per substep, the body as row: normal, offset,
//   μ, and per touching point the lever arm, kn and bias; and where the
//   partner is in its own list, the entry's place there (a binary search), so
//   the partner's pair with this body as column is found without a search;
// - a sweep: its lanes take the body's partners, each evaluating the
//   velocity-dependent impulse of the pair with the body as row (-j, -r_a × j)
//   and of the pair with it as column (+j, +r_b × j) from the cached
//   contacts, summed per manifold slot and per side (row, column) as the
//   plain version sums them; each slot's lane sums meet in a fixed shuffle
//   tree, then the slots are added in order (see `SlotSums`). Velocities and
//   poses are read from one buffer and written to the other, so the last
//   sweep also integrates and starts the next substep.
// A body with more than CAP partners keeps none: its partners compute its
// contact with them (it as row) in their geometry pass, and in every sweep it
// walks all B partners and derives both contacts of each overlapping pair on
// the fly with the same code (unless it does not move: a static body's sum is
// multiplied by 0, so it is not taken; the flagship's floor has ~100
// partners). Such bodies are counted per substep into `stats` (bodies past
// the cap, most partners seen). No float atomics; every run gives the same bits.
// Non-touching manifold points are skipped: their impulse is exactly zero in
// the TPU kernel.
//
// Built with -fmad=false: every product and sum rounds on its own, as the plain
// PyTorch version's separate tensor ops do, so the two differ only where sums
// are taken in another order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_sat.cuh"
#include "persistent.cuh"

namespace {  // private to this file: the other physics kernels have helpers of the same names

// per-body input rows (see `megakernel.py::_input_rows`)
enum {
  I_P = 0, I_V = 3, I_W = 6, I_Q = 9, I_INVM = 13, I_IM3 = 14, I_H = 17, I_RAD = 20, I_HLEN = 21,
  I_FRIC = 22, I_GRAV = 24, I_DOF = 25, I_BOX = 28, I_DYN = 29, I_MOV = 30, I_ACT = 31,
};
// scalars: dt, gravity(3), baumgarte, slop, margin, n_sub
enum { S_DT = 0, S_G = 1, S_BAUM = 4, S_SLOP = 5, S_MARGIN = 6 };
// body rows, each B: position, quaternion, row-major rotation, AABB half
// extents (+margin), capsule half-segment
enum { B_P = 0, B_Q = 3, B_ROT = 7, B_EH = 16, B_CA = 19, N_BODY = 22 };
// contact fields of an ordered pair (row body a, its list entry k), each B ×
// CAP: normal, offset c - a, μ, then per point s at G_SLOT + 5s: lever arm
// (3), kn (0: not touching), bias
enum { G_N = 0, G_DC = 3, G_MU = 6, G_SLOT = 7, N_GEO = 27 };
// the passes whose SM cycles `cycles` collects (`megakernel.PASSES`)
enum { PASS_PRE = 0, PASS_COUNT = 1, PASS_GEOM = 2, PASS_SWEEP = 3 };

#define CAP 64
#define TPB 256

struct Ws {
  float* body[2];  // N_BODY × B each: this substep's and the next
  float* vel[2];   // 6 × B each: linear, angular velocity; a sweep reads one and writes the other
  float* eff;      // 4 × B mass-split inverse mass and inertia
  int* cnt;        // B: overlapping partners
  int* list;       // B × CAP: the first CAP partners, ascending
  int* rev;        // B × CAP: the entry's place in the partner's list, or -1 (partner past the cap)
  float* geo;      // N_GEO × B × CAP: the contact (body, partner)
  float* cgeo;     // N_GEO × B × CAP: the contact (partner, body) where the partner is past the cap
};

struct Args {
  const float* sc;
  const float* rows;
  float* out;
  int* stats;
  unsigned long long* cycles;
  Ws w;
  int b, n_substeps, iterations;
};

size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

size_t carve(Ws* w, char* base, int b_) {
  size_t off = 0;
  const size_t b = b_;
  auto take = [&](size_t bytes) { char* p = base ? base + off : nullptr; off = align_up(off + bytes); return p; };
  for (int i = 0; i < 2; ++i) {
    w->body[i] = (float*)take(N_BODY * b * 4);
    w->vel[i] = (float*)take(6 * b * 4);
  }
  w->eff = (float*)take(4 * b * 4);
  w->cnt = (int*)take(b * 4);
  w->list = (int*)take(b * CAP * 4);
  w->rev = (int*)take(b * CAP * 4);
  w->geo = (float*)take(N_GEO * b * CAP * 4);
  w->cgeo = (float*)take(N_GEO * b * CAP * 4);
  return off;
}

// gravity on body a's velocities, then its rotation, AABB and capsule
// segment from the pose in `bb` (one thread)
__device__ void prep(const Args& A, int a, float* bb, float* vel) {
  const float* sc = A.sc;
  const float* rows = A.rows;
  const int b = A.b;
  const float dt = sc[S_DT];
  const float grav = rows[I_GRAV * b + a], dyn = rows[I_DYN * b + a];
  for (int k = 0; k < 3; ++k) vel[k * b + a] = vel[k * b + a] + sc[S_G + k] * grav * dt * dyn;
  const float qx = bb[(B_Q + 0) * b + a], qy = bb[(B_Q + 1) * b + a];
  const float qz = bb[(B_Q + 2) * b + a], qw = bb[(B_Q + 3) * b + a];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float r[9] = {1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy),
                      2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx),
                      2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)};
  for (int k = 0; k < 9; ++k) bb[(B_ROT + k) * b + a] = r[k];
  const bool box = rows[I_BOX * b + a] > 0.5f;
  const float rad = rows[I_RAD * b + a], hlen = rows[I_HLEN * b + a];
  const float lh[3] = {box ? rows[(I_H + 0) * b + a] : rad, box ? rows[(I_H + 1) * b + a] : rad + hlen,
                       box ? rows[(I_H + 2) * b + a] : rad};
  const float margin = sc[S_MARGIN];
  for (int k = 0; k < 3; ++k) {
    bb[(B_EH + k) * b + a] = fabsf(r[3 * k]) * lh[0] + fabsf(r[3 * k + 1]) * lh[1] + fabsf(r[3 * k + 2]) * lh[2] + margin;
    bb[(B_CA + k) * b + a] = r[3 * k + 1] * hlen;
  }
}

// ordered pair (i, j) is live: AABBs overlap, one side dynamic, both active, i != j
__device__ __forceinline__ bool pair_active(const Args& A, const float* bb, int i, int j) {
  const int b = A.b;
  if (i == j) return false;
  for (int k = 0; k < 3; ++k) {
    if (!(fabsf(bb[(B_P + k) * b + j] - bb[(B_P + k) * b + i]) <= bb[(B_EH + k) * b + i] + bb[(B_EH + k) * b + j]))
      return false;
  }
  return (A.rows[I_DYN * b + i] + A.rows[I_DYN * b + j]) > 0.5f && (A.rows[I_ACT * b + i] * A.rows[I_ACT * b + j]) > 0.5f;
}

__device__ __forceinline__ void load_body(const Args& A, const float* bb, int i, Body& B) {
  const int b = A.b;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) B.r[r][c] = bb[(B_ROT + 3 * r + c) * b + i];
  for (int k = 0; k < 3; ++k) {
    B.h[k] = A.rows[(I_H + k) * b + i];
    B.ca[k] = bb[(B_CA + k) * b + i];
  }
  B.rad = A.rows[I_RAD * b + i];
  B.box = A.rows[I_BOX * b + i];
}

// An ordered pair's contact for this substep: what a sweep's impulse needs
// besides the velocities.
struct Contact {
  float n[3], dc[3], mu, ra[4][3], kn[4], bias[4];
};

// the contact of (row body a, column body c), from the substep's poses and mass split
__device__ void contact_geo(const Args& A, const float* bb, int a, int c, Contact& G) {
  const int b = A.b;
  const float* rows = A.rows;
  const float* eff = A.w.eff;
  Body RA, RC;
  load_body(A, bb, a, RA);
  load_body(A, bb, c, RC);
  for (int k = 0; k < 3; ++k) G.dc[k] = bb[(B_P + k) * b + c] - bb[(B_P + k) * b + a];
  Manifold m;
  pair_manifold(G.dc[0], G.dc[1], G.dc[2], RA, RC, m);
  const float nx = m.n[0], ny = m.n[1], nz = m.n[2];
  for (int k = 0; k < 3; ++k) G.n[k] = m.n[k];
  G.mu = sqrtf(rows[I_FRIC * b + a] * rows[I_FRIC * b + c]);
  const float dt = A.sc[S_DT], baum = A.sc[S_BAUM], slop = A.sc[S_SLOP];
  const float ime_a = eff[a], ime_c = eff[c];
  const float ia[3] = {eff[1 * b + a], eff[2 * b + a], eff[3 * b + a]};
  const float ic[3] = {eff[1 * b + c], eff[2 * b + c], eff[3 * b + c]};
  for (int s = 0; s < 4; ++s) {
    const float depth = m.depth[s];
    for (int k = 0; k < 3; ++k) G.ra[s][k] = m.p[s][k];
    G.kn[s] = 0.f;  // not touching: the TPU kernel's impulse is exactly 0
    G.bias[s] = 0.f;
    if (!(depth > 0.f)) continue;
    const float rax = m.p[s][0], ray = m.p[s][1], raz = m.p[s][2];
    const float rbx = rax - G.dc[0], rby = ray - G.dc[1], rbz = raz - G.dc[2];
    const float anx = ray * nz - raz * ny, any = raz * nx - rax * nz, anz = rax * ny - ray * nx;
    const float bnx = rby * nz - rbz * ny, bny = rbz * nx - rbx * nz, bnz = rbx * ny - rby * nx;
    const float ang_a = ia[0] * (anx * anx) + ia[1] * (any * any) + ia[2] * (anz * anz);
    const float ang_b = ic[0] * (bnx * bnx) + ic[1] * (bny * bny) + ic[2] * (bnz * bnz);
    G.kn[s] = ime_a + ime_c + ang_a + ang_b + 1e-9f;
    G.bias[s] = baum / dt * fmaxf(depth - slop, 0.f);
  }
}

__device__ __forceinline__ size_t geo_at(int b, int f, int a, int k) { return (size_t(f) * b + a) * CAP + k; }

__device__ void store_contact(float* g, const Args& A, int a, int k, const Contact& G) {
  const int b = A.b;
  for (int c = 0; c < 3; ++c) {
    g[geo_at(b, G_N + c, a, k)] = G.n[c];
    g[geo_at(b, G_DC + c, a, k)] = G.dc[c];
  }
  g[geo_at(b, G_MU, a, k)] = G.mu;
  for (int s = 0; s < 4; ++s) {
    const int o = G_SLOT + 5 * s;
    for (int c = 0; c < 3; ++c) g[geo_at(b, o + c, a, k)] = G.ra[s][c];
    g[geo_at(b, o + 3, a, k)] = G.kn[s];
    g[geo_at(b, o + 4, a, k)] = G.bias[s];
  }
}

__device__ void load_contact(const float* g, const Args& A, int a, int k, Contact& G) {
  const int b = A.b;
  for (int c = 0; c < 3; ++c) {
    G.n[c] = g[geo_at(b, G_N + c, a, k)];
    G.dc[c] = g[geo_at(b, G_DC + c, a, k)];
  }
  G.mu = g[geo_at(b, G_MU, a, k)];
  for (int s = 0; s < 4; ++s) {
    const int o = G_SLOT + 5 * s;
    for (int c = 0; c < 3; ++c) G.ra[s][c] = g[geo_at(b, o + c, a, k)];
    G.kn[s] = g[geo_at(b, o + 3, a, k)];
    G.bias[s] = g[geo_at(b, o + 4, a, k)];
  }
}

// A body's impulse terms in one sweep, kept per manifold slot as the plain
// version keeps them: it sums each slot over all partners (a (B, B) sum per
// slot), then the slots in order, the body's terms as row body (racc) apart
// from its terms as column body (cacc). Grouped another way (a pair's slots
// first, row and column terms together) the `physics` cell's 60-substep call
// from the flagship's start ends ~0.1 m/s from the plain version: the pile
// there amplifies rounding (`time_redesigns.py` prints the plain version's own
// spread under a 1e-6 m/s nudge, `dense_physics_nudge`).
struct SlotSums {
  float j[4][3];  // Σ over partners of the slot's impulse
  float t[4][3];  // Σ over partners of the slot's lever arm × impulse
};

// Adds the impulses of the ordered pair (row body a, column body c) for one
// sweep from its contact into `S`, per slot: j and, with `row`, r_a × j, or
// else r_c × j.
__device__ __forceinline__ void pair_impulse(const Contact& G, const float* vin, int b, int a, int c, bool row,
                                             SlotSums& S) {
  const float nx = G.n[0], ny = G.n[1], nz = G.n[2];
  const float va[3] = {vin[0 * b + a], vin[1 * b + a], vin[2 * b + a]};
  const float wa[3] = {vin[3 * b + a], vin[4 * b + a], vin[5 * b + a]};
  const float vc[3] = {vin[0 * b + c], vin[1 * b + c], vin[2 * b + c]};
  const float wc[3] = {vin[3 * b + c], vin[4 * b + c], vin[5 * b + c]};
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const float kn = G.kn[s];
    if (!(kn > 0.f)) continue;
    const float rax = G.ra[s][0], ray = G.ra[s][1], raz = G.ra[s][2];
    const float rbx = rax - G.dc[0], rby = ray - G.dc[1], rbz = raz - G.dc[2];
    const float rvx = vc[0] + wc[1] * rbz - wc[2] * rby - (va[0] + wa[1] * raz - wa[2] * ray);
    const float rvy = vc[1] + wc[2] * rbx - wc[0] * rbz - (va[1] + wa[2] * rax - wa[0] * raz);
    const float rvz = vc[2] + wc[0] * rby - wc[1] * rbx - (va[2] + wa[0] * ray - wa[1] * rax);
    const float vn = rvx * nx + rvy * ny + rvz * nz;
    const float lam = fmaxf(-(vn - G.bias[s]) / kn, 0.f);
    const float tvx = rvx - vn * nx, tvy = rvy - vn * ny, tvz = rvz - vn * nz;
    const float tvl = sqrtf(tvx * tvx + tvy * tvy + tvz * tvz) + 1e-9f;
    const float lam_t = fminf(tvl / kn, G.mu * lam);
    const float jx = nx * lam - tvx / tvl * lam_t;
    const float jy = ny * lam - tvy / tvl * lam_t;
    const float jz = nz * lam - tvz / tvl * lam_t;
    const float px = row ? rax : rbx, py = row ? ray : rby, pz = row ? raz : rbz;
    S.j[s][0] += jx; S.j[s][1] += jy; S.j[s][2] += jz;
    S.t[s][0] += py * jz - pz * jy; S.t[s][1] += pz * jx - px * jz; S.t[s][2] += px * jy - py * jx;
  }
}

// The count (one warp per body, 8 bodies a block): the block stages its
// partners' positions, AABB half extents and flags through shared memory,
// TILE at a time; each warp tests its body against them, and a __ballot_sync
// with a __popc prefix writes the overlapping partners in ascending order (the
// first CAP kept); then the mass split (row count + column count). The test
// is `pair_active`'s on the same values.
#define TILE 1024
__device__ void count_pass(const Args& A, const float* bb) {
  __shared__ float sp[3][TILE], se[3][TILE], sdyn[TILE], sact[TILE];
  const Ws& w = A.w;
  const float* rows = A.rows;
  const int b = A.b;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = blockIdx.x * (TPB / 32); i0 < b; i0 += gridDim.x * (TPB / 32)) {
    const int i = i0 + warp;
    const bool mine = i < b;
    float pi_[3], ei[3], dyn_i = 0.f, act_i = 0.f;
    for (int k = 0; k < 3; ++k) {
      pi_[k] = mine ? bb[(B_P + k) * b + i] : 0.f;
      ei[k] = mine ? bb[(B_EH + k) * b + i] : 0.f;
    }
    if (mine) { dyn_i = rows[I_DYN * b + i]; act_i = rows[I_ACT * b + i]; }
    int total = 0;
    for (int t0 = 0; t0 < b; t0 += TILE) {
      const int nt = b - t0 < TILE ? b - t0 : TILE;
      __syncthreads();
      for (int j = threadIdx.x; j < nt; j += TPB) {
        for (int k = 0; k < 3; ++k) {
          sp[k][j] = bb[(B_P + k) * b + t0 + j];
          se[k][j] = bb[(B_EH + k) * b + t0 + j];
        }
        sdyn[j] = rows[I_DYN * b + t0 + j];
        sact[j] = rows[I_ACT * b + t0 + j];
      }
      __syncthreads();
      if (!mine) continue;
      for (int base = 0; base < nt; base += 32) {
        const int jl = base + lane, j = t0 + jl;
        bool act = jl < nt && j != i;
        for (int k = 0; k < 3 && act; ++k) act = fabsf(sp[k][jl] - pi_[k]) <= ei[k] + se[k][jl];
        act = act && (dyn_i + sdyn[jl]) > 0.5f && (act_i * sact[jl]) > 0.5f;
        const unsigned m = __ballot_sync(FULL_MASK, act);
        if (act) {
          const int pos = total + __popc(m & lanes_below(lane));
          if (pos < CAP) w.list[size_t(i) * CAP + pos] = j;
        }
        total += __popc(m);
      }
    }
    if (!mine || lane != 0) continue;
    w.cnt[i] = total;
    const float cnt = (float)total;
    const float split = fmaxf(cnt + cnt, 1.f);
    w.eff[0 * b + i] = rows[I_INVM * b + i] * split;
    for (int k = 0; k < 3; ++k) w.eff[(1 + k) * b + i] = rows[(I_IM3 + k) * b + i] * split;
    if (total > CAP) {
      atomicAdd(&A.stats[0], 1);
      atomicMax(&A.stats[1], total);
    }
  }
}

// The contacts of body i as row (one warp, lanes over its partners), and each
// entry's place in the partner's list; where the partner is past the cap, the
// partner's contact with i as column instead. A body past the cap keeps none.
__device__ void geom_body(const Args& A, int i, int lane, const float* bb) {
  const Ws& w = A.w;
  const int n = w.cnt[i];
  if (n > CAP) return;
  for (int k = lane; k < n; k += 32) {
    const int c = w.list[size_t(i) * CAP + k];
    Contact G;
    contact_geo(A, bb, i, c, G);
    store_contact(w.geo, A, i, k, G);
    const int nc = w.cnt[c];
    int at = -1;
    if (nc > CAP) {
      contact_geo(A, bb, c, i, G);
      store_contact(w.cgeo, A, i, k, G);
    } else {
      const int* lc = w.list + size_t(c) * CAP;
      int lo = 0, hi = nc - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lc[mid] < i) lo = mid + 1; else hi = mid;
      }
      at = lo;  // the overlap test is symmetric, so i is in c's list
    }
    w.rev[size_t(i) * CAP + k] = at;
  }
}

// One projected-Jacobi sweep for body i (one warp): velocities vin → vout. A
// body that does not move (static, or inactive) keeps its velocities: its
// update is the (finite) sum times mov = 0, so its sum is not taken.
__device__ void sweep_body(const Args& A, int i, int lane, const float* bb, const float* vin, float* vout) {
  const Ws& w = A.w;
  const float* rows = A.rows;
  const int b = A.b;
  const float mov = rows[I_MOV * b + i];
  // the body's own velocities and update factors, loaded before the pairs so their latency hides
  float own[6], upd[7];
  for (int k = 0; k < 6; ++k) own[k] = vin[k * b + i];
  if (mov == 0.f) {
    if (lane == 0)
      for (int k = 0; k < 6; ++k) vout[k * b + i] = own[k];
    return;
  }
  upd[0] = rows[I_INVM * b + i];
  for (int k = 0; k < 3; ++k) {
    upd[1 + k] = rows[(I_DOF + k) * b + i];
    upd[4 + k] = rows[(I_IM3 + k) * b + i];
  }
  const int n = w.cnt[i];
  SlotSums rs, cs;  // the body's terms as row body and as column body
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 3; ++k) rs.j[q][k] = rs.t[q][k] = cs.j[q][k] = cs.t[q][k] = 0.f;
  Contact G;
  if (n > CAP) {
    for (int j = lane; j < b; j += 32) {
      if (!pair_active(A, bb, i, j)) continue;
      contact_geo(A, bb, i, j, G);
      pair_impulse(G, vin, b, i, j, true, rs);
      contact_geo(A, bb, j, i, G);
      pair_impulse(G, vin, b, j, i, false, cs);
    }
  } else {
    for (int k = lane; k < n; k += 32) {
      const int c = w.list[size_t(i) * CAP + k];
      load_contact(w.geo, A, i, k, G);
      pair_impulse(G, vin, b, i, c, true, rs);
      const int at = w.rev[size_t(i) * CAP + k];
      if (at >= 0) load_contact(w.geo, A, c, at, G);
      else load_contact(w.cgeo, A, i, k, G);
      pair_impulse(G, vin, b, c, i, false, cs);
    }
  }
  // each slot over the partners (a fixed tree over the lanes), then the slots in
  // order: racc = 0 - S0 - S1 - S2 - S3 as row body, cacc = C0 + C1 + C2 + C3 as
  // column body, the body's update racc + cacc (the plain version's sums)
  float racc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, cacc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      racc[k] = racc[k] - warp_sum(rs.j[q][k]);
      cacc[k] = cacc[k] + warp_sum(cs.j[q][k]);
      racc[3 + k] = racc[3 + k] - warp_sum(rs.t[q][k]);
      cacc[3 + k] = cacc[3 + k] + warp_sum(cs.t[q][k]);
    }
  if (lane == 0) {
    for (int k = 0; k < 3; ++k) {
      vout[k * b + i] = own[k] + (racc[k] + cacc[k]) * upd[0] * upd[1 + k] * mov;
      vout[(3 + k) * b + i] = own[3 + k] + (racc[3 + k] + cacc[3 + k]) * upd[4 + k] * mov;
    }
  }
}

// positions and orientation of body a from `p` into `q` (one thread)
__device__ void integrate(const Args& A, int a, const float* p, float* q, const float* vel) {
  const int b = A.b;
  const float dt = A.sc[S_DT], mov = A.rows[I_MOV * b + a];
  for (int k = 0; k < 3; ++k) q[(B_P + k) * b + a] = p[(B_P + k) * b + a] + vel[k * b + a] * dt * mov;
  const float wx = vel[3 * b + a], wy = vel[4 * b + a], wz = vel[5 * b + a];
  const float qx = p[(B_Q + 0) * b + a], qy = p[(B_Q + 1) * b + a];
  const float qz = p[(B_Q + 2) * b + a], qw = p[(B_Q + 3) * b + a];
  const float hq = 0.5f * dt;
  const float dqx = hq * (wx * qw + wy * qz - wz * qy);
  const float dqy = hq * (-wx * qz + wy * qw + wz * qx);
  const float dqz = hq * (wx * qy - wy * qx + wz * qw);
  const float dqw = hq * (-wx * qx - wy * qy - wz * qz);
  const float nqx = qx + dqx * mov, nqy = qy + dqy * mov, nqz = qz + dqz * mov, nqw = qw + dqw * mov;
  const float qn = rsqrtf(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw + 1e-12f);
  q[(B_Q + 0) * b + a] = nqx * qn;
  q[(B_Q + 1) * b + a] = nqy * qn;
  q[(B_Q + 2) * b + a] = nqz * qn;
  q[(B_Q + 3) * b + a] = nqw * qn;
}

__global__ void __launch_bounds__(TPB, 1) k_dense(const __grid_constant__ Args A) {
  cg::grid_group grid = cg::this_grid();
  const Ws& w = A.w;
  const float* rows = A.rows;
  const int b = A.b;
  const int tid = blockIdx.x * TPB + threadIdx.x, nthreads = gridDim.x * TPB;
  const int lane = threadIdx.x & 31, gwarp = tid >> 5, nwarps = nthreads >> 5;
  PassClock clock{A.cycles, 0};
  clock.start();

  // ---- init: state from the input rows and the first substep's gravity and pose terms
  for (int a = tid; a < b; a += nthreads) {
    for (int k = 0; k < 3; ++k) {
      w.body[0][(B_P + k) * b + a] = rows[(I_P + k) * b + a];
      w.vel[0][k * b + a] = rows[(I_V + k) * b + a];
      w.vel[0][(3 + k) * b + a] = rows[(I_W + k) * b + a];
    }
    for (int k = 0; k < 4; ++k) w.body[0][(B_Q + k) * b + a] = rows[(I_Q + k) * b + a];
    if (A.n_substeps > 0) prep(A, a, w.body[0], w.vel[0]);
  }
  clock.end(grid, PASS_PRE);

  int pc = 0, cur = 0;  // pose and velocity buffers in use (the same in every thread)
  for (int step = 0; step < A.n_substeps; ++step) {
    const float* bb = w.body[pc];
    float* bnext = w.body[pc ^ 1];
    const bool more = step + 1 < A.n_substeps;
    count_pass(A, bb);
    clock.end(grid, PASS_COUNT);
    for (int i = gwarp; i < b; i += nwarps) geom_body(A, i, lane, bb);
    clock.end(grid, PASS_GEOM);
    for (int it = 0; it < A.iterations || it == 0; ++it) {
      const bool sweep = it < A.iterations, last = it + 1 >= A.iterations;
      const float* vin = w.vel[cur];
      float* vout = sweep ? w.vel[cur ^ 1] : w.vel[cur];
      for (int i = gwarp; i < b; i += nwarps) {
        if (sweep) sweep_body(A, i, lane, bb, vin, vout);
        if (last && lane == 0) {
          integrate(A, i, bb, bnext, vout);
          if (more) prep(A, i, bnext, vout);
        }
      }
      if (sweep) cur ^= 1;
      clock.end(grid, PASS_SWEEP);
    }
    pc ^= 1;
  }

  for (int a = tid; a < b; a += nthreads) {
    for (int k = 0; k < 3; ++k) {
      A.out[(I_P + k) * b + a] = w.body[pc][(B_P + k) * b + a];
      A.out[(I_V + k) * b + a] = w.vel[cur][k * b + a];
      A.out[(I_W + k) * b + a] = w.vel[cur][(3 + k) * b + a];
    }
    for (int k = 0; k < 4; ++k) A.out[(I_Q + k) * b + a] = w.body[pc][(B_Q + k) * b + a];
  }
}

}  // namespace

extern "C" size_t dense_workspace_bytes(int b) {
  Ws w;
  return carve(&w, nullptr, b);
}

// One cooperative launch for the whole call; `out` (13 × B: pos, linvel,
// angvel, quat) receives the state. `stats` (2 ints): bodies past the cap per
// substep are added to stats[0], the most partners such a body had is
// stats[1]'s maximum. `cycles` (or null): per pass kind, the SM cycles of
// block 0 from barrier to barrier, added to.
extern "C" int dense_substeps(const float* scalars, const float* rows, float* out, void* workspace, int* stats,
                              unsigned long long* cycles, int b, int n_substeps, int iterations, void* stream) {
  if (b < 32 || b % 32 != 0 || n_substeps < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  Args args;
  carve(&args.w, (char*)workspace, b);
  args.sc = scalars;
  args.rows = rows;
  args.out = out;
  args.stats = stats;
  args.cycles = cycles;
  args.b = b;
  args.n_substeps = n_substeps;
  args.iterations = iterations;
  return launch_persistent((const void*)k_dense, &args, b, TPB, (cudaStream_t)stream);
}
