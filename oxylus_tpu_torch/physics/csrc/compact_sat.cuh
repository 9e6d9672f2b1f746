// Contact geometry for one (row body A, partner B) pair of the compact kernel:
// capsule/capsule closest points, box/capsule both ways, and box/box SAT over
// the six face axes with a 4-point clipped incident-face manifold. Scalar
// float32 code written in the same operation order as `_sat` in
// `megakernel_compact.py`; built with -fmad=false so each product and sum
// rounds as it does in the plain PyTorch version.
#pragma once

struct Body {
  float r[3][3];  // rotation, row-major
  float h[3];     // box half extents
  float rad;      // capsule/sphere radius
  float ca[3];    // capsule half-segment vector (world)
  float box;      // 1 = box
};

struct Manifold {
  float n[3];
  float p[4][3];  // contact points relative to A
  float depth[4];
};

__device__ __forceinline__ float sgnf(float x) { return (float)((x > 0.f) - (x < 0.f)); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

// Face of a box most anti-parallel (×toward) to n: centre offset f, half edges u, v.
// axes[k] = (column k of the rotation), h[k] the half extent along it.
__device__ __forceinline__ void incident_face(const float ax[3][3], const float h[3], float nx, float ny,
                                              float nz, float toward, float f[3], float u[3], float v[3]) {
  float dots[3], absd[3];
  for (int k = 0; k < 3; ++k) {
    dots[k] = ax[k][0] * nx + ax[k][1] * ny + ax[k][2] * nz;
    absd[k] = fabsf(dots[k]);
  }
  bool k0 = (absd[0] >= absd[1]) && (absd[0] >= absd[2]);
  bool k1 = (!k0) && (absd[1] >= absd[2]);
  bool k2 = (!k0) && (!k1);
  float m[3] = {k0 ? 1.f : 0.f, k1 ? 1.f : 0.f, k2 ? 1.f : 0.f};
  for (int c = 0; c < 3; ++c) { f[c] = 0.f; u[c] = 0.f; v[c] = 0.f; }
  for (int k = 0; k < 3; ++k) {
    float sg = -sgnf(dots[k] + 1e-12f) * toward;
    int k1_ = (k + 1) % 3, k2_ = (k + 2) % 3;
    for (int c = 0; c < 3; ++c) {
      f[c] = f[c] + m[k] * sg * ax[k][c] * h[k];
      u[c] = u[c] + m[k] * ax[k1_][c] * h[k1_];
      v[c] = v[c] + m[k] * ax[k2_][c] * h[k2_];
    }
  }
}

__device__ __forceinline__ float proj_extent(const Body& B, float ax, float ay, float az) {
  return fabsf(ax * B.r[0][0] + ay * B.r[1][0] + az * B.r[2][0]) * B.h[0] +
         fabsf(ax * B.r[0][1] + ay * B.r[1][1] + az * B.r[2][1]) * B.h[1] +
         fabsf(ax * B.r[0][2] + ay * B.r[1][2] + az * B.r[2][2]) * B.h[2];
}

// static: megakernel_dense.cu includes this header too, and each object file
// keeps its own copy
static __device__ void pair_manifold(float dxc, float dyc, float dzc, const Body& A, const Body& B, Manifold& out) {
  const float d[3] = {dxc, dyc, dzc};
  bool both_round = (A.box < 0.5f) && (B.box < 0.5f);
  bool a_box = A.box > 0.5f, b_box = B.box > 0.5f;

  // capsule-capsule closest points
  float bd2 = B.ca[0] * B.ca[0] + B.ca[1] * B.ca[1] + B.ca[2] * B.ca[2] + 1e-9f;
  float tb = clampf(-(dxc * B.ca[0] + dyc * B.ca[1] + dzc * B.ca[2]) / bd2, -1.f, 1.f);
  float bp[3], sp[3];
  for (int c = 0; c < 3; ++c) bp[c] = -d[c] + tb * B.ca[c];
  float ad2 = A.ca[0] * A.ca[0] + A.ca[1] * A.ca[1] + A.ca[2] * A.ca[2] + 1e-9f;
  float ta = clampf((bp[0] * A.ca[0] + bp[1] * A.ca[1] + bp[2] * A.ca[2]) / ad2, -1.f, 1.f);
  for (int c = 0; c < 3; ++c) sp[c] = bp[c] - ta * A.ca[c];
  float dist_cc = sqrtf(sp[0] * sp[0] + sp[1] * sp[1] + sp[2] * sp[2]) + 1e-9f;
  float ncc[3], pcc[3];
  for (int c = 0; c < 3; ++c) ncc[c] = -sp[c] / dist_cc;
  float depth_cc = A.rad + B.rad - dist_cc;
  for (int c = 0; c < 3; ++c) pcc[c] = ta * A.ca[c] + ncc[c] * (A.rad + depth_cc * 0.5f);

  // box(A) - capsule/sphere(B)
  float la[3], dd[3], fd[3];
  for (int k = 0; k < 3; ++k) {
    la[k] = A.r[0][k] * dxc + A.r[1][k] * dyc + A.r[2][k] * dzc;
    dd[k] = la[k] - clampf(la[k], -A.h[k], A.h[k]);
    fd[k] = A.h[k] - fabsf(la[k]);
  }
  float out_d = sqrtf(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]);
  bool outside = out_d > 1e-6f;
  float fmin_ = fminf(fd[0], fminf(fd[1], fd[2]));
  float nin[3] = {
      fd[0] <= fmin_ + 1e-9f ? sgnf(la[0]) : 0.f,
      (fd[1] <= fmin_ + 1e-9f) && (fd[0] > fmin_ + 1e-9f) ? sgnf(la[1]) : 0.f,
      (fd[2] <= fmin_ + 1e-9f) && (fd[1] > fmin_ + 1e-9f) && (fd[0] > fmin_ + 1e-9f) ? sgnf(la[2]) : 0.f};
  float nl[3], nbc[3], pbc[3];
  for (int k = 0; k < 3; ++k) nl[k] = outside ? dd[k] / (out_d + 1e-9f) : nin[k];
  float depth_bc = (outside ? -out_d : fmin_) + B.rad;
  for (int k = 0; k < 3; ++k) nbc[k] = A.r[k][0] * nl[0] + A.r[k][1] * nl[1] + A.r[k][2] * nl[2];
  for (int k = 0; k < 3; ++k) pbc[k] = d[k] - nbc[k] * B.rad;

  // capsule/sphere(A) - box(B)
  float lb[3], ed[3], gd[3];
  for (int k = 0; k < 3; ++k) {
    lb[k] = B.r[0][k] * -dxc + B.r[1][k] * -dyc + B.r[2][k] * -dzc;
    ed[k] = lb[k] - clampf(lb[k], -B.h[k], B.h[k]);
    gd[k] = B.h[k] - fabsf(lb[k]);
  }
  float eod = sqrtf(ed[0] * ed[0] + ed[1] * ed[1] + ed[2] * ed[2]);
  bool eoutside = eod > 1e-6f;
  float gmin = fminf(gd[0], fminf(gd[1], gd[2]));
  float mn[3] = {
      gd[0] <= gmin + 1e-9f ? sgnf(lb[0]) : 0.f,
      (gd[1] <= gmin + 1e-9f) && (gd[0] > gmin + 1e-9f) ? sgnf(lb[1]) : 0.f,
      (gd[2] <= gmin + 1e-9f) && (gd[1] > gmin + 1e-9f) && (gd[0] > gmin + 1e-9f) ? sgnf(lb[2]) : 0.f};
  float ml[3], ncb[3], pcb[3];
  for (int k = 0; k < 3; ++k) ml[k] = eoutside ? ed[k] / (eod + 1e-9f) : mn[k];
  float depth_cb = (eoutside ? -eod : gmin) + A.rad;
  for (int k = 0; k < 3; ++k) ncb[k] = -(B.r[k][0] * ml[0] + B.r[k][1] * ml[1] + B.r[k][2] * ml[2]);
  for (int k = 0; k < 3; ++k) pcb[k] = ncb[k] * A.rad;

  // box-box SAT over the 6 face axes
  float best = 1e30f, nbb[3] = {0.f, 0.f, 0.f}, ref_is_a = 1.f;
  for (int i = 0; i < 6; ++i) {
    const Body& S = i < 3 ? A : B;
    int k = i % 3;
    float ax = S.r[0][k], ay = S.r[1][k], az = S.r[2][k];
    float ov = proj_extent(A, ax, ay, az) + proj_extent(B, ax, ay, az) - fabsf(ax * dxc + ay * dyc + az * dzc);
    if (ov < best) {
      best = ov;
      nbb[0] = ax; nbb[1] = ay; nbb[2] = az;
      ref_is_a = i < 3 ? 1.f : 0.f;
    }
  }
  float sg = sgnf(nbb[0] * dxc + nbb[1] * dyc + nbb[2] * dzc + 1e-12f);
  float nbx = nbb[0] * sg, nby = nbb[1] * sg, nbz = nbb[2] * sg;
  float depth_bb = best;

  float a_ax[3][3], b_ax[3][3];
  for (int k = 0; k < 3; ++k)
    for (int c = 0; c < 3; ++c) { a_ax[k][c] = A.r[c][k]; b_ax[k][c] = B.r[c][k]; }
  float fb[3], ub[3], vb[3], fa[3], ua[3], va[3];
  incident_face(b_ax, B.h, nbx, nby, nbz, 1.f, fb, ub, vb);
  incident_face(a_ax, A.h, nbx, nby, nbz, -1.f, fa, ua, va);
  float pa_n = proj_extent(A, nbx, nby, nbz);
  float pb_n = proj_extent(B, nbx, nby, nbz);
  bool ref_a = ref_is_a > 0.5f;
  const float su[4] = {1.f, 1.f, -1.f, -1.f}, sv[4] = {1.f, -1.f, 1.f, -1.f};
  float bbp[4][3], bbd[4];
  for (int s = 0; s < 4; ++s) {
    float cb[3], cbc[3], cav[3], cac[3], l[3];
    for (int c = 0; c < 3; ++c) cb[c] = d[c] + fb[c] + su[s] * ub[c] + sv[s] * vb[c];
    float dep_b = pa_n - (cb[0] * nbx + cb[1] * nby + cb[2] * nbz);
    for (int k = 0; k < 3; ++k) l[k] = clampf(A.r[0][k] * cb[0] + A.r[1][k] * cb[1] + A.r[2][k] * cb[2], -A.h[k], A.h[k]);
    for (int c = 0; c < 3; ++c) cbc[c] = A.r[c][0] * l[0] + A.r[c][1] * l[1] + A.r[c][2] * l[2];
    for (int c = 0; c < 3; ++c) cav[c] = fa[c] + su[s] * ua[c] + sv[s] * va[c];
    float dep_a = pb_n + ((cav[0] - dxc) * nbx + (cav[1] - dyc) * nby + (cav[2] - dzc) * nbz);
    for (int k = 0; k < 3; ++k)
      l[k] = clampf(B.r[0][k] * (cav[0] - dxc) + B.r[1][k] * (cav[1] - dyc) + B.r[2][k] * (cav[2] - dzc), -B.h[k], B.h[k]);
    for (int c = 0; c < 3; ++c) cac[c] = d[c] + B.r[c][0] * l[0] + B.r[c][1] * l[1] + B.r[c][2] * l[2];
    for (int c = 0; c < 3; ++c) bbp[s][c] = ref_a ? cbc[c] : cac[c];
    float dep = ref_a ? dep_b : dep_a;
    bbd[s] = depth_bb > 0.f ? dep : -1e9f;
  }

  // select by shape kind: round/round, box/round, round/box, box/box
  int kind = both_round ? 0 : (a_box && !b_box) ? 1 : (!a_box && b_box) ? 2 : 3;
  const float nbbv[3] = {nbx, nby, nbz};
  for (int c = 0; c < 3; ++c) {
    out.n[c] = kind == 0 ? ncc[c] : kind == 1 ? nbc[c] : kind == 2 ? ncb[c] : nbbv[c];
    out.p[0][c] = kind == 0 ? pcc[c] : kind == 1 ? pbc[c] : kind == 2 ? pcb[c] : bbp[0][c];
  }
  out.depth[0] = kind == 0 ? depth_cc : kind == 1 ? depth_bc : kind == 2 ? depth_cb : bbd[0];
  bool is_bb = a_box && b_box;
  for (int s = 1; s < 4; ++s) {
    for (int c = 0; c < 3; ++c) out.p[s][c] = bbp[s][c];
    out.depth[s] = is_bb ? bbd[s] : -1e9f;
  }
}
