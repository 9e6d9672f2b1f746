// Solver, sleeping, integration and the host entry points of the compact
// kernel; included at the end of megakernel_compact.cu.
#pragma once

__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// One pair (slot r of body a): per-point normal impulses and the pair friction
// at the manifold centroid. Reads the sweep's velocity snapshot, updates the
// pair's λ caches and writes j, torque_a, torque_b for the body pass.
__global__ void k_solve_pairs(Ws w, Dims d, int is_warm, float warm) {
  PAIR_THREAD GATED
  const int b = d.b;
  const size_t rb = size_t(d.R) * b;
  const int j = a + w.d_cur[idx];
  const float* g = w.pgeo;
  const float n[3] = {g[G_N * rb + idx], g[(G_N + 1) * rb + idx], g[(G_N + 2) * rb + idx]};
  const float dc[3] = {g[G_DC * rb + idx], g[(G_DC + 1) * rb + idx], g[(G_DC + 2) * rb + idx]};
  float rv_[3], rw_[3], cv_[3], cw_[3];
  for (int c = 0; c < 3; ++c) {
    rv_[c] = w.st[(I_V + c) * b + a]; rw_[c] = w.st[(I_W + c) * b + a];
    cv_[c] = w.st[(I_V + c) * b + j]; cw_[c] = w.st[(I_W + c) * b + j];
  }
  auto rel_vel = [&](const float ra[3], const float rbv[3], float out[3]) {
    for (int c = 0; c < 3; ++c) {
      const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
      out[c] = (cv_[c] + cw_[c1] * rbv[c2] - cw_[c2] * rbv[c1]) - (rv_[c] + rw_[c1] * ra[c2] - rw_[c2] * ra[c1]);
    }
  };
  float jt[3] = {0.f, 0.f, 0.f}, ta[3] = {0.f, 0.f, 0.f}, tb[3] = {0.f, 0.f, 0.f};
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
  __nv_bfloat16* lam = w.lam_cur;
  float sum_ln = 0.f, c_a[3] = {0.f, 0.f, 0.f}, c_w = 0.f;
  for (int k = 0; k < N_SLOT; ++k) {
    const int o = G_SLOT + 6 * k;
    const float ra[3] = {g[o * rb + idx], g[(o + 1) * rb + idx], g[(o + 2) * rb + idx]};
    const float rbv[3] = {ra[0] - dc[0], ra[1] - dc[1], ra[2] - dc[2]};
    const float bias = g[(o + 4) * rb + idx];
    const float touch = bias > -1e29f ? 1.f : 0.f;
    const size_t li = size_t(k) * rb + idx;
    const float ln_old = __bfloat162float(lam[li]);
    float ln_eff, dl;
    if (is_warm) {
      ln_eff = bf(ln_old * (touch * warm));
      dl = ln_eff;
    } else {
      float rv[3];
      rel_vel(ra, rbv, rv);
      const float vn = rv[0] * n[0] + rv[1] * n[1] + rv[2] * n[2];
      ln_eff = bf(fmaxf(ln_old - (vn - bias) * g[(o + 3) * rb + idx], 0.f));
      dl = ln_eff - ln_old;
    }
    lam[li] = __float2bfloat16_rn(ln_eff);
    sum_ln = sum_ln + ln_eff;
    const float jv[3] = {n[0] * dl, n[1] * dl, n[2] * dl};
    apply(jv, ra, rbv);
    for (int c = 0; c < 3; ++c) c_a[c] = c_a[c] + touch * ra[c];
    c_w = c_w + touch;
  }
  // pair friction at the manifold centroid
  const float inv_cw = 1.f / fmaxf(c_w, 1.f);
  const float ra[3] = {c_a[0] * inv_cw, c_a[1] * inv_cw, c_a[2] * inv_cw};
  const float rbv[3] = {ra[0] - dc[0], ra[1] - dc[1], ra[2] - dc[2]};
  float lt_old[3], lt_s[3], dj[3];
  for (int c = 0; c < 3; ++c) lt_old[c] = __bfloat162float(lam[size_t(N_SLOT + c) * rb + idx]);
  if (is_warm) {
    const float gate = (c_w > 0.5f ? 1.f : 0.f) * warm;
    for (int c = 0; c < 3; ++c) { lt_s[c] = bf(lt_old[c] * gate); dj[c] = lt_s[c]; }
  } else {
    float rv[3];
    rel_vel(ra, rbv, rv);
    const float vn = rv[0] * n[0] + rv[1] * n[1] + rv[2] * n[2];
    const float ikn0 = g[(G_SLOT + 3) * rb + idx];
    float lt_c[3];
    for (int c = 0; c < 3; ++c) lt_c[c] = lt_old[c] - (rv[c] - vn * n[c]) * ikn0;
    const float ltl = sqrtf(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9f;
    const float tscale = fminf(g[G_MU * rb + idx] * sum_ln / ltl, 1.f);
    for (int c = 0; c < 3; ++c) { lt_s[c] = bf(lt_c[c] * tscale); dj[c] = lt_s[c] - lt_old[c]; }
  }
  for (int c = 0; c < 3; ++c) lam[size_t(N_SLOT + c) * rb + idx] = __float2bfloat16_rn(lt_s[c]);
  apply(dj, ra, rbv);
  for (int c = 0; c < 3; ++c) {
    w.pimp[c * rb + idx] = jt[c];
    w.pimp[(3 + c) * rb + idx] = ta[c];
    w.pimp[(6 + c) * rb + idx] = tb[c];
  }
}

// Body a: -j / -torque_a of its own slots, +j / +torque_b of the pairs that name
// it (reverse index), its plane contacts, then the Jacobi velocity update.
__global__ void k_solve_bodies(const float* __restrict__ rows, Ws w, Dims d, int is_warm, float warm, int sleep) {
  BODY_THREAD GATED
  const int b = d.b;
  const size_t rb = size_t(d.R) * b, pb = size_t(d.npk) * b;
  float acc[3], tq[3];
  for (int c = 0; c < 3; ++c) {
    float sj = 0.f, st_ = 0.f, cj = 0.f, ct = 0.f;
    for (int r = 0; r < d.R; ++r) {
      sj = sj + w.pimp[c * rb + size_t(r) * b + a];
      st_ = st_ + w.pimp[(3 + c) * rb + size_t(r) * b + a];
    }
    for (int e = 0; e < w.revcnt[a]; ++e) {
      const int pi = w.rev[e * b + a];
      cj = cj + w.pimp[c * rb + pi];
      ct = ct + w.pimp[(6 + c) * rb + pi];
    }
    acc[c] = -sj + cj;
    tq[c] = -st_ + ct;
  }
  float v[3], om[3];
  for (int c = 0; c < 3; ++c) { v[c] = w.st[(I_V + c) * b + a]; om[c] = w.st[(I_W + c) * b + a]; }
  float pj_sum[3] = {0.f, 0.f, 0.f}, pt_sum[3] = {0.f, 0.f, 0.f};
  for (int q = 0; q < d.npk; ++q) {
    const size_t qa = size_t(q) * b + a;
    float r[3], n[3], lam[4], pj[3];
    for (int c = 0; c < 3; ++c) { r[c] = w.pgp[(P_R + c) * pb + qa]; n[c] = w.pgp[(P_N + c) * pb + qa]; }
    for (int f = 0; f < 4; ++f) lam[f] = w.plam[f * pb + qa];
    const float bias = w.pgp[P_BIAS * pb + qa];
    if (is_warm) {
      const float pt = (bias > -1e29f ? 1.f : 0.f) * warm;
      for (int f = 0; f < 4; ++f) lam[f] = lam[f] * pt;
      for (int c = 0; c < 3; ++c) pj[c] = n[c] * lam[0] + lam[1 + c];
    } else {
      const float ikn = w.pgp[P_IKN * pb + qa];
      float rv[3];
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
        rv[c] = v[c] + om[c1] * r[c2] - om[c2] * r[c1];
      }
      const float vn = rv[0] * n[0] + rv[1] * n[1] + rv[2] * n[2];
      const float ln_new = fmaxf(lam[0] - (vn - bias) * ikn, 0.f);
      const float dlam = ln_new - lam[0];
      float lt_c[3];
      for (int c = 0; c < 3; ++c) lt_c[c] = lam[1 + c] - (rv[c] - vn * n[c]) * ikn;
      const float ltl = sqrtf(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9f;
      const float tscale = fminf(w.pgp[P_MU * pb + qa] * ln_new / ltl, 1.f);
      for (int c = 0; c < 3; ++c) {
        const float lt_n = lt_c[c] * tscale;
        pj[c] = n[c] * dlam + (lt_n - lam[1 + c]);
        lam[1 + c] = lt_n;
      }
      lam[0] = ln_new;
    }
    for (int f = 0; f < 4; ++f) w.plam[f * pb + qa] = lam[f];
    for (int c = 0; c < 3; ++c) {
      const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
      pj_sum[c] = pj_sum[c] + pj[c];
      pt_sum[c] = pt_sum[c] + (r[c1] * pj[c2] - r[c2] * pj[c1]);
    }
  }
  float mov_f = rows[I_MOV * b + a];
  if (sleep) mov_f = mov_f * (1.f - w.slp[a]);
  const float inv_m = rows[I_INVM * b + a];
  for (int c = 0; c < 3; ++c) {
    w.st[(I_V + c) * b + a] = v[c] + (acc[c] + pj_sum[c]) * inv_m * rows[(I_DOF + c) * b + a] * mov_f;
    w.st[(I_W + c) * b + a] = om[c] + (tq[c] + pt_sum[c]) * rows[(I_IM3 + c) * b + a] * mov_f;
  }
}

__global__ void k_sleep_flags(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, Dims d) {
  BODY_THREAD GATED
  const int b = d.b;
  float v2 = 0.f, w2 = 0.f;
  const float* v = w.st + I_V * b;
  const float* om = w.st + I_W * b;
  v2 = v[a] * v[a] + v[b + a] * v[b + a] + v[2 * b + a] * v[2 * b + a];
  w2 = om[a] * om[a] + om[b + a] * om[b + a] + om[2 * b + a] * om[2 * b + a];
  const float sp2 = v2 + rows[I_REFF2 * b + a] * w2;
  const float moving = sp2 >= sc[8 + N_PLANE * PLANE_SC] ? 1.f : 0.f;
  w.moving[a] = moving;
  w.pusher[a] = rows[I_DYN * b + a] * (1.f - w.slp[a]) * moving;
}

__device__ __forceinline__ float pair_touch(const Ws& w, size_t rb, int pi) {
  float t = 0.f;
  for (int k = 0; k < N_SLOT; ++k) t = fmaxf(t, w.pgeo[(G_SLOT + 6 * k + 4) * rb + pi] > -1e29f ? 1.f : 0.f);
  return t;
}

// Wake propagation from moving partners (both pair directions) and the
// deactivation timers; sleeping bodies stop.
__global__ void k_sleep_update(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, Dims d) {
  BODY_THREAD GATED
  const int b = d.b;
  const size_t rb = size_t(d.R) * b;
  float wake = 0.f, col = 0.f;
  for (int r = 0; r < d.R; ++r) {
    const int pi = r * b + a;
    wake = wake + pair_touch(w, rb, pi) * w.pusher[a + w.d_cur[pi]];
  }
  for (int e = 0; e < w.revcnt[a]; ++e) {
    const int pi = w.rev[e * b + a];
    col = col + pair_touch(w, rb, pi) * w.pusher[pi % b];
  }
  wake = wake + col;
  const float wk = wake > 0.5f ? 1.f : 0.f;
  const float dt = sc[0], sleep_time = sc[8 + N_PLANE * PLANE_SC + 1];
  const float eligible = (1.f - w.moving[a]) * rows[I_CANSLEEP * b + a] * (1.f - wk);
  const float timer = (w.tmr[a] + dt * (float)SLEEP_EVERY) * eligible;
  const float fall = (timer >= sleep_time ? 1.f : 0.f) * eligible;
  const float s = fminf(w.slp[a] * (1.f - wk) + fall, 1.f);
  w.slp[a] = s;
  w.tmr[a] = timer;
  const float keep = 1.f - s;
  for (int c = 0; c < 6; ++c) w.st[(I_V + c) * b + a] = w.st[(I_V + c) * b + a] * keep;
}

__global__ void k_integrate(const float* __restrict__ sc, const float* __restrict__ rows, Ws w, Dims d, int sleep) {
  BODY_THREAD GATED
  const int b = d.b;
  const float dt = sc[0];
  float mov = rows[I_MOV * b + a];
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

__global__ void k_out(const float* __restrict__ rows, Ws w, Dims d, float* __restrict__ out, int sleep) {
  BODY_THREAD
  const int b = d.b;
  for (int f = 0; f < 13; ++f) out[f * b + a] = w.st[f * b + a];
  out[13 * b + a] = sleep ? w.slp[a] : rows[I_SLEEP0 * b + a];
  out[14 * b + a] = sleep ? w.tmr[a] : rows[I_TIMER0 * b + a];
  out[15 * b + a] = w.ovf[a];
}

// ---------------------------------------------------------------------------
// host entry points (plain C, loaded with ctypes)
// ---------------------------------------------------------------------------

enum { ERR_ARGS = 10000 };

extern "C" size_t compact_workspace_bytes(int b, int R, int band, int n_planes) {
  Ws w;
  Dims d{b, R, band, n_planes, n_planes * N_SLOT};
  return carve(&w, nullptr, d);
}

extern "C" const char* compact_error_string(int err) {
  if (err == ERR_ARGS) return "invalid arguments (sizes out of range)";
  return cudaGetErrorString((cudaError_t)err);
}

#define LAUNCH(kernel, n, ...)                                                  \
  do {                                                                         \
    kernel<<<((n) + TPB - 1) / TPB, TPB, 0, stream>>>(__VA_ARGS__);            \
    cudaError_t e_ = cudaGetLastError();                                       \
    if (e_ != cudaSuccess) return (int)e_;                                     \
  } while (0)
// a warp per body: n bodies take 32 n threads
#define LAUNCH_WARPS(kernel, n, ...) LAUNCH(kernel, 32 * (n), __VA_ARGS__)

extern "C" int compact_substeps(const float* scalars, const float* rows, float* out, void* workspace, int b,
                                int R, int band, int n_planes, int n_substeps, int iterations, float warm,
                                int geom_every, int sleep, void* stream_ptr) {
  const int TPB = 128;
  if (b <= 0 || R <= 0 || R > MAX_R || band <= 0 || n_planes < 1 || n_planes > N_PLANE || n_substeps < 0 ||
      iterations < 0 || geom_every < 1)
    return ERR_ARGS;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Dims d{b, R, band, n_planes, n_planes * N_SLOT};
  Ws w;
  carve(&w, (char*)workspace, d);
  if (!sleep) w.gate = nullptr;  // no gate: every substep runs
  LAUNCH(k_init, b, rows, w, d);
  const int nrb = R * b;
  for (int step = 0; step < n_substeps; ++step) {
    if (sleep) {
      // a substep runs only while some movable body is awake
      cudaError_t e = cudaMemsetAsync(w.gate, 0, sizeof(int), stream);
      if (e != cudaSuccess) return (int)e;
      LAUNCH(k_awake, b, rows, w, d);
    }
    LAUNCH(k_pre, b, scalars, rows, w, d, sleep);
    const bool rebuild = step % geom_every == 0;
    if (rebuild) {
      LAUNCH_WARPS(k_discover, b, rows, w, d);
      LAUNCH_WARPS(k_remap, b, w, d);
      // the new partner deltas and remapped caches become current
      int* t = w.d_cur; w.d_cur = w.d_new; w.d_new = t;
      __nv_bfloat16* l = w.lam_cur; w.lam_cur = w.lam_next; w.lam_next = l;
      LAUNCH_WARPS(k_reverse, b, w, d);
      LAUNCH(k_sat, nrb, scalars, rows, w, d);
    } else {
      LAUNCH(k_refresh, nrb, scalars, w, d);
    }
    LAUNCH(k_planes, b, scalars, rows, w, d);
    if (rebuild) LAUNCH(k_pair_ikn, nrb, w, d);
    for (int it = 0; it <= iterations; ++it) {
      const int is_warm = it == 0;
      LAUNCH(k_solve_pairs, nrb, w, d, is_warm, warm);
      LAUNCH(k_solve_bodies, b, rows, w, d, is_warm, warm, sleep);
    }
    if (sleep && step % SLEEP_EVERY == SLEEP_EVERY - 1) {
      LAUNCH(k_sleep_flags, b, scalars, rows, w, d);
      LAUNCH(k_sleep_update, b, scalars, rows, w, d);
    }
    LAUNCH(k_integrate, b, scalars, rows, w, d, sleep);
  }
  LAUNCH(k_out, b, rows, w, d, out, sleep);
  return 0;
}
