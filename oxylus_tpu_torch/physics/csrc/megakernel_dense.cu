// Dense all-pairs rigid-body substeps for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by `oxylus_tpu_torch/_build.py`.
//
// Replaces the TPU kernel `oxylus_tpu/physics/megakernel.py::_kernel`
// (launched by `megakernel_substeps`). Same contract, written from what the
// TPU kernel computes rather than its (CHUNK, B) VMEM blocks: per substep
// gravity, rotations, AABB half extents and capsule half-segments; per body
// the count of AABB overlaps as row plus as column (mass splitting); then
// `iterations` stateless projected-Jacobi sweeps, each recomputing every
// overlapping ordered pair's contact (capsule/capsule, box/capsule both ways,
// box/box face SAT with 4 clamped incident-face corners — the geometry of
// `compact_sat.cuh`, which is the same function) and applying the summed
// impulses with the raw masses; then integration.
//
// Design. A sweep needs every body's velocity from the previous sweep, and
// blocks run in no order, so each sweep is its own launch reading one
// velocity buffer and writing the other. One warp owns one body i: its 32
// lanes split the partners j, each lane evaluating pair (i, j) with i as row
// (contributing -j and -r_a×j) and pair (j, i) with i as column (+j, +r_b×j),
// and the lanes' sums meet in a fixed shuffle tree. Each ordered pair is
// therefore evaluated twice, once by each of its bodies, but no body's sum
// needs atomics and every run gives the same bits. Pairs that do not overlap
// (most of them) cost one AABB test; non-touching manifold points are skipped,
// as their impulse is exactly zero in the TPU kernel. Per substep: 1 + 1 +
// `iterations` + 1 launches.
//
// What bounds it on the card: floating-point operations. The function needs,
// per substep, one AABB test per unordered pair and one contact geometry per
// overlapping ordered pair (positions do not move within a substep), and per
// sweep only the velocity-dependent impulse of each touching point
// (`chip_smoke.py` phase 6 counts them on the flagship pile). This kernel instead re-derives every overlapping pair's geometry in every
// sweep, twice (once from each body), and at these sizes its launches (13 per
// substep) and the serial sweep chain set the time. Geometry cached once per
// substep, shared-memory tiles of partner data and one persistent cooperative
// launch per call are later work.
//
// Built with -fmad=false: every product and sum rounds on its own, as the plain
// PyTorch version's separate tensor ops do, so the two differ only where sums
// are taken in another order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_sat.cuh"

namespace {  // Ws, carve and the kernels stay private to this file (the compact kernel has its own Ws)

// per-body input rows (see `megakernel.py::_input_rows`)
enum {
  I_P = 0, I_V = 3, I_W = 6, I_Q = 9, I_INVM = 13, I_IM3 = 14, I_H = 17, I_RAD = 20, I_HLEN = 21,
  I_FRIC = 22, I_GRAV = 24, I_DOF = 25, I_BOX = 28, I_DYN = 29, I_MOV = 30, I_ACT = 31,
};
// scalars: dt, gravity(3), baumgarte, slop, margin, n_sub
enum { S_DT = 0, S_G = 1, S_BAUM = 4, S_SLOP = 5, S_MARGIN = 6 };

#define WARPS_PER_BLOCK 4
#define BODY_BLOCK 128

struct Ws {
  float* rot;   // 9 × B row-major rotation
  float* eh;    // 3 × B AABB half extents (+margin)
  float* ca;    // 3 × B capsule half-segment
  float* eff;   // 4 × B mass-split inverse mass and inertia
  float* valt;  // 6 × B the second velocity buffer
};

static size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

static size_t carve(Ws* w, char* base, int b) {
  size_t off = 0;
  auto take = [&](size_t n) { float* p = base ? (float*)(base + off) : nullptr; off = align_up(off + n * 4); return p; };
  w->rot = take(9 * size_t(b));
  w->eh = take(3 * size_t(b));
  w->ca = take(3 * size_t(b));
  w->eff = take(4 * size_t(b));
  w->valt = take(6 * size_t(b));
  return off;
}

// gravity on the velocities, then rotation, AABB and capsule segment from the pose
__global__ void dense_prep(const float* __restrict__ sc, const float* __restrict__ rows, float* st, Ws w, int b) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= b) return;
  const float dt = sc[S_DT];
  const float grav = rows[I_GRAV * b + a], dyn = rows[I_DYN * b + a];
  for (int k = 0; k < 3; ++k) st[(I_V + k) * b + a] = st[(I_V + k) * b + a] + sc[S_G + k] * grav * dt * dyn;

  const float qx = st[(I_Q + 0) * b + a], qy = st[(I_Q + 1) * b + a];
  const float qz = st[(I_Q + 2) * b + a], qw = st[(I_Q + 3) * b + a];
  const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
  const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
  const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
  const float r[9] = {1.f - 2.f * (yy + zz), 2.f * (xy - wz), 2.f * (xz + wy),
                      2.f * (xy + wz), 1.f - 2.f * (xx + zz), 2.f * (yz - wx),
                      2.f * (xz - wy), 2.f * (yz + wx), 1.f - 2.f * (xx + yy)};
  for (int k = 0; k < 9; ++k) w.rot[k * b + a] = r[k];
  const bool box = rows[I_BOX * b + a] > 0.5f;
  const float rad = rows[I_RAD * b + a], hlen = rows[I_HLEN * b + a];
  const float lh[3] = {box ? rows[(I_H + 0) * b + a] : rad, box ? rows[(I_H + 1) * b + a] : rad + hlen,
                       box ? rows[(I_H + 2) * b + a] : rad};
  const float margin = sc[S_MARGIN];
  for (int k = 0; k < 3; ++k) {
    w.eh[k * b + a] = fabsf(r[3 * k]) * lh[0] + fabsf(r[3 * k + 1]) * lh[1] + fabsf(r[3 * k + 2]) * lh[2] + margin;
    w.ca[k * b + a] = r[3 * k + 1] * hlen;
  }
}

// ordered pair (a, b) is live: AABBs overlap, one side dynamic, both active, a != b
__device__ __forceinline__ bool pair_active(const float* st, const float* rows, const Ws& w, int b, int i, int j) {
  if (i == j) return false;
  for (int k = 0; k < 3; ++k) {
    if (!(fabsf(st[(I_P + k) * b + j] - st[(I_P + k) * b + i]) <= w.eh[k * b + i] + w.eh[k * b + j])) return false;
  }
  return (rows[I_DYN * b + i] + rows[I_DYN * b + j]) > 0.5f && (rows[I_ACT * b + i] * rows[I_ACT * b + j]) > 0.5f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// overlap count as row plus as column (the same test both ways) → mass-split inverse masses
__global__ void dense_count(const float* __restrict__ rows, const float* st, Ws w, int b) {
  const int i = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= b) return;
  float cnt = 0.f;
  for (int j = lane; j < b; j += 32) cnt += pair_active(st, rows, w, b, i, j) ? 1.f : 0.f;
  cnt = warp_sum(cnt);
  if (lane == 0) {
    const float split = fmaxf(cnt + cnt, 1.f);  // row count + column count
    w.eff[0 * b + i] = rows[I_INVM * b + i] * split;
    for (int k = 0; k < 3; ++k) w.eff[(1 + k) * b + i] = rows[(I_IM3 + k) * b + i] * split;
  }
}

__device__ __forceinline__ void load_body(const float* st, const float* rows, const Ws& w, int b, int i, Body& B) {
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) B.r[r][c] = w.rot[(3 * r + c) * b + i];
  for (int k = 0; k < 3; ++k) {
    B.h[k] = rows[(I_H + k) * b + i];
    B.ca[k] = w.ca[k * b + i];
  }
  B.rad = rows[I_RAD * b + i];
  B.box = rows[I_BOX * b + i];
}

// Impulses of the ordered pair (row body a, column body c) for one sweep:
// returns Σ_points j, Σ r_a × j and Σ r_c × j.
__device__ void pair_impulse(const float* sc, const float* st, const float* vin, const float* rows, const Ws& w,
                             int b, int a, int c, float jsum[3], float tqa[3], float tqc[3]) {
  Body A, C;
  load_body(st, rows, w, b, a, A);
  load_body(st, rows, w, b, c, C);
  const float dxc = st[(I_P + 0) * b + c] - st[(I_P + 0) * b + a];
  const float dyc = st[(I_P + 1) * b + c] - st[(I_P + 1) * b + a];
  const float dzc = st[(I_P + 2) * b + c] - st[(I_P + 2) * b + a];
  Manifold m;
  pair_manifold(dxc, dyc, dzc, A, C, m);
  const float nx = m.n[0], ny = m.n[1], nz = m.n[2];
  const float mu = sqrtf(rows[I_FRIC * b + a] * rows[I_FRIC * b + c]);
  const float dt = sc[S_DT], baum = sc[S_BAUM], slop = sc[S_SLOP];
  const float va[3] = {vin[0 * b + a], vin[1 * b + a], vin[2 * b + a]};
  const float wa[3] = {vin[3 * b + a], vin[4 * b + a], vin[5 * b + a]};
  const float vc[3] = {vin[0 * b + c], vin[1 * b + c], vin[2 * b + c]};
  const float wc[3] = {vin[3 * b + c], vin[4 * b + c], vin[5 * b + c]};
  const float ime_a = w.eff[a], ime_c = w.eff[c];
  const float ia[3] = {w.eff[1 * b + a], w.eff[2 * b + a], w.eff[3 * b + a]};
  const float ic[3] = {w.eff[1 * b + c], w.eff[2 * b + c], w.eff[3 * b + c]};
  for (int k = 0; k < 3; ++k) { jsum[k] = 0.f; tqa[k] = 0.f; tqc[k] = 0.f; }
  for (int s = 0; s < 4; ++s) {
    const float depth = m.depth[s];
    if (!(depth > 0.f)) continue;  // not touching: the TPU kernel's impulse is exactly 0
    const float rax = m.p[s][0], ray = m.p[s][1], raz = m.p[s][2];
    const float rbx = rax - dxc, rby = ray - dyc, rbz = raz - dzc;
    const float rvx = vc[0] + wc[1] * rbz - wc[2] * rby - (va[0] + wa[1] * raz - wa[2] * ray);
    const float rvy = vc[1] + wc[2] * rbx - wc[0] * rbz - (va[1] + wa[2] * rax - wa[0] * raz);
    const float rvz = vc[2] + wc[0] * rby - wc[1] * rbx - (va[2] + wa[0] * ray - wa[1] * rax);
    const float vn = rvx * nx + rvy * ny + rvz * nz;
    const float anx = ray * nz - raz * ny, any = raz * nx - rax * nz, anz = rax * ny - ray * nx;
    const float bnx = rby * nz - rbz * ny, bny = rbz * nx - rbx * nz, bnz = rbx * ny - rby * nx;
    const float ang_a = ia[0] * (anx * anx) + ia[1] * (any * any) + ia[2] * (anz * anz);
    const float ang_b = ic[0] * (bnx * bnx) + ic[1] * (bny * bny) + ic[2] * (bnz * bnz);
    const float kn = ime_a + ime_c + ang_a + ang_b + 1e-9f;
    const float bias = baum / dt * fmaxf(depth - slop, 0.f);
    const float lam = fmaxf(-(vn - bias) / kn, 0.f);
    const float tvx = rvx - vn * nx, tvy = rvy - vn * ny, tvz = rvz - vn * nz;
    const float tvl = sqrtf(tvx * tvx + tvy * tvy + tvz * tvz) + 1e-9f;
    const float lam_t = fminf(tvl / kn, mu * lam);
    const float jx = nx * lam - tvx / tvl * lam_t;
    const float jy = ny * lam - tvy / tvl * lam_t;
    const float jz = nz * lam - tvz / tvl * lam_t;
    jsum[0] += jx; jsum[1] += jy; jsum[2] += jz;
    tqa[0] += ray * jz - raz * jy; tqa[1] += raz * jx - rax * jz; tqa[2] += rax * jy - ray * jx;
    tqc[0] += rby * jz - rbz * jy; tqc[1] += rbz * jx - rbx * jz; tqc[2] += rbx * jy - rby * jx;
  }
}

// one projected-Jacobi sweep: velocities vin → vout (6 × B each)
__global__ void dense_sweep(const float* __restrict__ sc, const float* __restrict__ rows, const float* st, Ws w,
                        const float* vin, float* vout, int b) {
  const int i = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= b) return;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float js[3], ta[3], tc[3];
  for (int j = lane; j < b; j += 32) {
    if (!pair_active(st, rows, w, b, i, j)) continue;
    pair_impulse(sc, st, vin, rows, w, b, i, j, js, ta, tc);  // i as row: -j, -r_a × j
    for (int k = 0; k < 3; ++k) { acc[k] -= js[k]; acc[3 + k] -= ta[k]; }
    pair_impulse(sc, st, vin, rows, w, b, j, i, js, ta, tc);  // i as column: +j, +r_b × j
    for (int k = 0; k < 3; ++k) { acc[k] += js[k]; acc[3 + k] += tc[k]; }
  }
  for (int k = 0; k < 6; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
    const float invm = rows[I_INVM * b + i], mov = rows[I_MOV * b + i];
    for (int k = 0; k < 3; ++k) {
      vout[k * b + i] = vin[k * b + i] + acc[k] * invm * rows[(I_DOF + k) * b + i] * mov;
      vout[(3 + k) * b + i] = vin[(3 + k) * b + i] + acc[3 + k] * rows[(I_IM3 + k) * b + i] * mov;
    }
  }
}

__global__ void dense_integrate(const float* __restrict__ sc, const float* __restrict__ rows, float* st, int b) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= b) return;
  const float dt = sc[S_DT], mov = rows[I_MOV * b + a];
  for (int k = 0; k < 3; ++k) st[(I_P + k) * b + a] = st[(I_P + k) * b + a] + st[(I_V + k) * b + a] * dt * mov;
  const float wx = st[(I_W + 0) * b + a], wy = st[(I_W + 1) * b + a], wz = st[(I_W + 2) * b + a];
  const float qx = st[(I_Q + 0) * b + a], qy = st[(I_Q + 1) * b + a];
  const float qz = st[(I_Q + 2) * b + a], qw = st[(I_Q + 3) * b + a];
  const float hq = 0.5f * dt;
  const float dqx = hq * (wx * qw + wy * qz - wz * qy);
  const float dqy = hq * (-wx * qz + wy * qw + wz * qx);
  const float dqz = hq * (wx * qy - wy * qx + wz * qw);
  const float dqw = hq * (-wx * qx - wy * qy - wz * qz);
  const float nqx = qx + dqx * mov, nqy = qy + dqy * mov, nqz = qz + dqz * mov, nqw = qw + dqw * mov;
  const float qn = rsqrtf(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw + 1e-12f);
  st[(I_Q + 0) * b + a] = nqx * qn;
  st[(I_Q + 1) * b + a] = nqy * qn;
  st[(I_Q + 2) * b + a] = nqz * qn;
  st[(I_Q + 3) * b + a] = nqw * qn;
}

}  // namespace

extern "C" size_t dense_workspace_bytes(int b) {
  Ws w;
  return carve(&w, nullptr, b);
}

#define LAUNCH_CHECK()                       \
  do {                                       \
    cudaError_t e_ = cudaGetLastError();     \
    if (e_ != cudaSuccess) return (int)e_;   \
  } while (0)

// `out` (13 × B: pos, linvel, angvel, quat) holds the state through the call;
// the input rows' first 13 rows are the same fields in the same order.
extern "C" int dense_substeps(const float* scalars, const float* rows, float* out, void* workspace, int b,
                              int n_substeps, int iterations, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Ws w;
  carve(&w, (char*)workspace, b);
  cudaError_t e = cudaMemcpyAsync(out, rows, size_t(13) * b * sizeof(float), cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return (int)e;
  const int body_blocks = (b + BODY_BLOCK - 1) / BODY_BLOCK;
  const int warp_blocks = (b + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  float* v_state = out + size_t(I_V) * b;  // linvel and angvel rows, contiguous
  for (int sub = 0; sub < n_substeps; ++sub) {
    dense_prep<<<body_blocks, BODY_BLOCK, 0, s>>>(scalars, rows, out, w, b);
    LAUNCH_CHECK();
    dense_count<<<warp_blocks, 32 * WARPS_PER_BLOCK, 0, s>>>(rows, out, w, b);
    LAUNCH_CHECK();
    float* vin = v_state;
    float* vout = w.valt;
    for (int it = 0; it < iterations; ++it) {
      dense_sweep<<<warp_blocks, 32 * WARPS_PER_BLOCK, 0, s>>>(scalars, rows, out, w, vin, vout, b);
      LAUNCH_CHECK();
      float* t = vin; vin = vout; vout = t;
    }
    if (vin != v_state) {
      e = cudaMemcpyAsync(v_state, vin, size_t(6) * b * sizeof(float), cudaMemcpyDeviceToDevice, s);
      if (e != cudaSuccess) return (int)e;
    }
    dense_integrate<<<body_blocks, BODY_BLOCK, 0, s>>>(scalars, rows, out, b);
    LAUNCH_CHECK();
  }
  return 0;
}
