"""Compacted-neighbour rigid-body substeps (counterpart of
`oxylus_tpu/physics/megakernel_compact.py`).

One call advances every body by `n_substeps` fixed substeps. Per substep:
gravity, rotation matrices and margin-expanded AABBs; every `geom_every`
substeps a rebuild — in-band discovery over the slab-rank order (row body `a`
scans ranks a+1 … min(a+band, B-1) and keeps its first R overlapping
candidates in ascending rank delta, counting the rest as dropped), the λ-cache
remap by partner delta, and SAT 4-point box/box plus capsule/sphere manifolds;
otherwise a cheap refresh of the Baumgarte bias from partner drift. Every
substep: analytic hub-plane contacts, mass-split effective masses, one warm
pass plus `iterations` projected-Jacobi sweeps (each sweep reads one velocity
snapshot), optional sleeping, integration. Pair λ caches are bf16, as
`LAM_DT` is in the JAX kernel; they start cold at every call.

Two implementations share one interface, `(scalars (74,), rows (36, B)) →
(16, B)`, both in sorted (slab-rank) body order:

- `compact_substeps_reference`: plain PyTorch, vectorised on (R, B) lanes. The
  wrapper uses it for tensors on the CPU; `chip_smoke.py` holds the CUDA
  kernel against it on the card.
- the CUDA kernel in `csrc/megakernel_compact.cu`, for tensors on a card.
  There is no fallback: a CUDA tensor reaches the kernel or the call raises.

`megakernel_substeps_compact` wraps either with the stable slab-rank sort, the
permutation, the scalar block and the inverse permutation. `LAUNCHES` counts
calls that went to the CUDA kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .megakernel_banded import (
    BAND,
    N_PLANE,
    PLANE_SC,
    _permute_state,
    extract_hub_planes,
    slab_rank_key,
    slab_rank_perm,
)
from .state import BODY_DYNAMIC, BODY_STATIC, SHAPE_BOX, PhysicsParams, PhysicsState

Tensor = torch.Tensor

BCHUNK = 128          # capacity granularity (the TPU kernel's row chunk)
R = 16                # default compacted neighbour slots per body
N_SLOT = 4            # manifold points per pair
LAM_DT = torch.bfloat16
SLEEP_EVERY = 4       # sleep bookkeeping cadence in substeps (15 Hz)
N_SCALARS = 8 + N_PLANE * PLANE_SC + 2
N_ROWS = 36
N_OUT = 16

# kernel launches made by `megakernel_substeps_compact` (one per call that ran
# on a card); read and reset by callers that must prove the kernel ran
LAUNCHES = 0


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _rot_rows(qx, qy, qz, qw):
    xx = qx * qx; yy = qy * qy; zz = qz * qz
    xy = qx * qy; xz = qx * qz; yz = qy * qz
    wx = qw * qx; wy = qw * qy; wz = qw * qz
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


def _incident_face(axes3, nbx, nby, nbz, toward_n_sign):
    """Face of a box most anti-parallel (×toward_n_sign) to the normal: centre
    offset f and half-edge vectors u, v."""
    dots = [a[0] * nbx + a[1] * nby + a[2] * nbz for a in axes3]
    absd = [torch.abs(d) for d in dots]
    k0 = (absd[0] >= absd[1]) & (absd[0] >= absd[2])
    k1 = (~k0) & (absd[1] >= absd[2])
    k2 = (~k0) & (~k1)
    masks = [k0.float(), k1.float(), k2.float()]
    f = [0.0, 0.0, 0.0]; u = [0.0, 0.0, 0.0]; v = [0.0, 0.0, 0.0]
    for k in range(3):
        m = masks[k]
        sgn_k = -torch.sign(dots[k] + 1e-12) * toward_n_sign
        hk = axes3[k][3]
        hu = axes3[(k + 1) % 3][3]
        hv = axes3[(k + 2) % 3][3]
        for c in range(3):
            f[c] = f[c] + m * sgn_k * axes3[k][c] * hk
            u[c] = u[c] + m * axes3[(k + 1) % 3][c] * hu
            v[c] = v[c] + m * axes3[(k + 2) % 3][c] * hv
    return f, u, v


def _sat(dxc, dyc, dzc, rr, r_h, r_rad, r_box, ca, cr, c_h, c_rad, c_box):
    """Contact normal and N_SLOT (point, depth) pairs for row body A and partner
    B at offset (dxc, dyc, dzc); points are relative to A. Row values are
    (1, B), partner values (R, B)."""
    r_hx, r_hy, r_hz = r_h
    c_hx, c_hy, c_hz = c_h
    both_round = (r_box < 0.5) & (c_box < 0.5)
    a_box = r_box > 0.5
    b_box = c_box > 0.5

    # capsule-capsule closest points
    adx, ady, adz = ca[0]
    bdx, bdy, bdz = ca[1]
    bd2 = bdx * bdx + bdy * bdy + bdz * bdz + 1e-9
    tb = torch.clamp(-(dxc * bdx + dyc * bdy + dzc * bdz) / bd2, -1.0, 1.0)
    bxp = -dxc + tb * bdx
    byp = -dyc + tb * bdy
    bzp = -dzc + tb * bdz
    ad2 = adx * adx + ady * ady + adz * adz + 1e-9
    ta = torch.clamp((bxp * adx + byp * ady + bzp * adz) / ad2, -1.0, 1.0)
    sxp = bxp - ta * adx
    syp = byp - ta * ady
    szp = bzp - ta * adz
    dist_cc = torch.sqrt(sxp * sxp + syp * syp + szp * szp) + 1e-9
    ncc = (-sxp / dist_cc, -syp / dist_cc, -szp / dist_cc)
    depth_cc = r_rad + c_rad - dist_cc
    pcc = tuple(t * a + n * (r_rad + depth_cc * 0.5) for t, a, n in zip((ta, ta, ta), (adx, ady, adz), ncc))

    # box(A) - capsule/sphere(B)
    la = [rr[0][k] * dxc + rr[1][k] * dyc + rr[2][k] * dzc for k in range(3)]
    cl = [torch.clamp(la[k], -r_h[k], r_h[k]) for k in range(3)]
    dd = [la[k] - cl[k] for k in range(3)]
    out_d = torch.sqrt(dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2])
    outside = out_d > 1e-6
    fd = [r_h[k] - torch.abs(la[k]) for k in range(3)]
    fmin = torch.minimum(fd[0], torch.minimum(fd[1], fd[2]))
    zero = torch.zeros_like(dxc)
    nin_x = torch.where(fd[0] <= fmin + 1e-9, torch.sign(la[0]), zero)
    nin_y = torch.where((fd[1] <= fmin + 1e-9) & (fd[0] > fmin + 1e-9), torch.sign(la[1]), zero)
    nin_z = torch.where(
        (fd[2] <= fmin + 1e-9) & (fd[1] > fmin + 1e-9) & (fd[0] > fmin + 1e-9), torch.sign(la[2]), zero
    )
    nl = [torch.where(outside, dd[k] / (out_d + 1e-9), nin) for k, nin in enumerate((nin_x, nin_y, nin_z))]
    sd = torch.where(outside, -out_d, fmin)
    depth_bc = sd + c_rad
    nbc = [rr[k][0] * nl[0] + rr[k][1] * nl[1] + rr[k][2] * nl[2] for k in range(3)]
    pbc = (dxc - nbc[0] * c_rad, dyc - nbc[1] * c_rad, dzc - nbc[2] * c_rad)

    # capsule/sphere(A) - box(B)
    lb = [cr[0][k] * -dxc + cr[1][k] * -dyc + cr[2][k] * -dzc for k in range(3)]
    cb = [torch.clamp(lb[k], -c_h[k], c_h[k]) for k in range(3)]
    ed = [lb[k] - cb[k] for k in range(3)]
    eod = torch.sqrt(ed[0] * ed[0] + ed[1] * ed[1] + ed[2] * ed[2])
    eoutside = eod > 1e-6
    gd = [c_h[k] - torch.abs(lb[k]) for k in range(3)]
    gmin = torch.minimum(gd[0], torch.minimum(gd[1], gd[2]))
    min_x = torch.where(gd[0] <= gmin + 1e-9, torch.sign(lb[0]), zero)
    min_y = torch.where((gd[1] <= gmin + 1e-9) & (gd[0] > gmin + 1e-9), torch.sign(lb[1]), zero)
    min_z = torch.where(
        (gd[2] <= gmin + 1e-9) & (gd[1] > gmin + 1e-9) & (gd[0] > gmin + 1e-9), torch.sign(lb[2]), zero
    )
    ml = [torch.where(eoutside, ed[k] / (eod + 1e-9), mn) for k, mn in enumerate((min_x, min_y, min_z))]
    esd = torch.where(eoutside, -eod, gmin)
    depth_cb = esd + r_rad
    ncb = [-(cr[k][0] * ml[0] + cr[k][1] * ml[1] + cr[k][2] * ml[2]) for k in range(3)]
    pcb = tuple(n * r_rad for n in ncb)

    # box-box SAT over the 6 face axes
    def proj_pair(ax, ay, az):
        pa = (
            torch.abs(ax * rr[0][0] + ay * rr[1][0] + az * rr[2][0]) * r_hx
            + torch.abs(ax * rr[0][1] + ay * rr[1][1] + az * rr[2][1]) * r_hy
            + torch.abs(ax * rr[0][2] + ay * rr[1][2] + az * rr[2][2]) * r_hz
        )
        pb = (
            torch.abs(ax * cr[0][0] + ay * cr[1][0] + az * cr[2][0]) * c_hx
            + torch.abs(ax * cr[0][1] + ay * cr[1][1] + az * cr[2][1]) * c_hy
            + torch.abs(ax * cr[0][2] + ay * cr[1][2] + az * cr[2][2]) * c_hz
        )
        return pa + pb - torch.abs(ax * dxc + ay * dyc + az * dzc)

    best = torch.full_like(dxc, 1e30)
    one = torch.ones_like(dxc)
    nbb = [zero, zero, zero]
    ref_is_a = one
    axes = [(rr[0][k], rr[1][k], rr[2][k], 1.0) for k in range(3)]
    axes += [(cr[0][k], cr[1][k], cr[2][k], 0.0) for k in range(3)]
    for ax, ay, az, from_a in axes:
        ov = proj_pair(ax, ay, az)
        better = ov < best
        best = torch.where(better, ov, best)
        nbb = [torch.where(better, a * one, n) for a, n in zip((ax, ay, az), nbb)]
        ref_is_a = torch.where(better, from_a * one, ref_is_a)
    sgn = torch.sign(nbb[0] * dxc + nbb[1] * dyc + nbb[2] * dzc + 1e-12)
    nbx, nby, nbz = nbb[0] * sgn, nbb[1] * sgn, nbb[2] * sgn
    depth_bb = best

    a_axes = [(rr[0][k], rr[1][k], rr[2][k], r_h[k]) for k in range(3)]
    b_axes = [(cr[0][k], cr[1][k], cr[2][k], c_h[k]) for k in range(3)]
    fb, ub, vb = _incident_face(b_axes, nbx, nby, nbz, 1.0)
    fa, ua, va = _incident_face(a_axes, nbx, nby, nbz, -1.0)
    pa_n = (
        torch.abs(nbx * rr[0][0] + nby * rr[1][0] + nbz * rr[2][0]) * r_hx
        + torch.abs(nbx * rr[0][1] + nby * rr[1][1] + nbz * rr[2][1]) * r_hy
        + torch.abs(nbx * rr[0][2] + nby * rr[1][2] + nbz * rr[2][2]) * r_hz
    )
    pb_n = (
        torch.abs(nbx * cr[0][0] + nby * cr[1][0] + nbz * cr[2][0]) * c_hx
        + torch.abs(nbx * cr[0][1] + nby * cr[1][1] + nbz * cr[2][1]) * c_hy
        + torch.abs(nbx * cr[0][2] + nby * cr[1][2] + nbz * cr[2][2]) * c_hz
    )
    ref_a = ref_is_a > 0.5
    bb_pts = []
    for su, sv in ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)):
        cbx_ = dxc + fb[0] + su * ub[0] + sv * vb[0]
        cby_ = dyc + fb[1] + su * ub[1] + sv * vb[1]
        cbz_ = dzc + fb[2] + su * ub[2] + sv * vb[2]
        dep_b = pa_n - (cbx_ * nbx + cby_ * nby + cbz_ * nbz)
        lxa = torch.clamp(rr[0][0] * cbx_ + rr[1][0] * cby_ + rr[2][0] * cbz_, -r_hx, r_hx)
        lya = torch.clamp(rr[0][1] * cbx_ + rr[1][1] * cby_ + rr[2][1] * cbz_, -r_hy, r_hy)
        lza = torch.clamp(rr[0][2] * cbx_ + rr[1][2] * cby_ + rr[2][2] * cbz_, -r_hz, r_hz)
        cbx_c = rr[0][0] * lxa + rr[0][1] * lya + rr[0][2] * lza
        cby_c = rr[1][0] * lxa + rr[1][1] * lya + rr[1][2] * lza
        cbz_c = rr[2][0] * lxa + rr[2][1] * lya + rr[2][2] * lza
        cax_ = fa[0] + su * ua[0] + sv * va[0]
        cay_ = fa[1] + su * ua[1] + sv * va[1]
        caz_ = fa[2] + su * ua[2] + sv * va[2]
        dep_a = pb_n + ((cax_ - dxc) * nbx + (cay_ - dyc) * nby + (caz_ - dzc) * nbz)
        lxb = torch.clamp(cr[0][0] * (cax_ - dxc) + cr[1][0] * (cay_ - dyc) + cr[2][0] * (caz_ - dzc), -c_hx, c_hx)
        lyb = torch.clamp(cr[0][1] * (cax_ - dxc) + cr[1][1] * (cay_ - dyc) + cr[2][1] * (caz_ - dzc), -c_hy, c_hy)
        lzb = torch.clamp(cr[0][2] * (cax_ - dxc) + cr[1][2] * (cay_ - dyc) + cr[2][2] * (caz_ - dzc), -c_hz, c_hz)
        cax_c = dxc + cr[0][0] * lxb + cr[0][1] * lyb + cr[0][2] * lzb
        cay_c = dyc + cr[1][0] * lxb + cr[1][1] * lyb + cr[1][2] * lzb
        caz_c = dzc + cr[2][0] * lxb + cr[2][1] * lyb + cr[2][2] * lzb
        px_k = torch.where(ref_a, cbx_c, cax_c)
        py_k = torch.where(ref_a, cby_c, cay_c)
        pz_k = torch.where(ref_a, cbz_c, caz_c)
        dep_k = torch.where(ref_a, dep_b, dep_a)
        dep_k = torch.where(depth_bb > 0.0, dep_k, torch.full_like(dep_k, -1e9))
        bb_pts.append((px_k, py_k, pz_k, dep_k))

    def sel(cc, bc, cb2, bb):
        out = torch.where(both_round, cc, bb)
        out = torch.where(a_box & ~b_box, bc, out)
        return torch.where(~a_box & b_box, cb2, out)

    normal = tuple(sel(ncc[k], nbc[k], ncb[k], (nbx, nby, nbz)[k]) for k in range(3))
    is_bb = a_box & b_box
    neg = torch.full_like(depth_cc, -1e9)
    slots = [
        (sel(pcc[0], pbc[0], pcb[0], bb_pts[0][0]),
         sel(pcc[1], pbc[1], pcb[1], bb_pts[0][1]),
         sel(pcc[2], pbc[2], pcb[2], bb_pts[0][2]),
         sel(depth_cc, depth_bc, depth_cb, bb_pts[0][3]))
    ]
    for k in range(1, N_SLOT):
        slots.append((bb_pts[k][0], bb_pts[k][1], bb_pts[k][2], torch.where(is_bb, bb_pts[k][3], neg)))
    return normal, slots


def compact_substeps_reference(
    scalars: Tensor,
    rows: Tensor,
    *,
    n_substeps: int,
    iterations: int = 3,
    warm: float = 0.7,
    geom_every: int = 2,
    sleep: bool = False,
    band: int = BAND,
    r_slots: int = R,
    n_planes: int = N_PLANE,
) -> Tensor:
    """Plain PyTorch version of the compact kernel on sorted bodies.

    `scalars` (74,) f32: dt, gravity(3), baumgarte, slop, AABB margin, n_sub,
    N_PLANE×PLANE_SC plane scalars, sleep velocity², sleep time. `rows` (36, B)
    f32 per-body inputs in `_input_rows` order. Returns (16, B): pos(3),
    linvel(3), angvel(3), quat(4), asleep, sleep timer, dropped candidates at
    the last rebuild."""
    dev = rows.device
    f32 = torch.float32
    b = rows.shape[1]
    nr = r_slots
    sc = scalars
    dt = sc[0]
    g = (sc[1], sc[2], sc[3])
    baum_dt = sc[4] / dt
    slop = sc[5]
    margin = sc[6]
    sleep_v2 = sc[8 + N_PLANE * PLANE_SC]
    sleep_time = sc[8 + N_PLANE * PLANE_SC + 1]

    (px, py, pz, vx, vy, vz, wx, wy, wz, qx, qy, qz, qw,
     inv_mass, im3x, im3y, im3z, hx, hy, hz, rad, hlen,
     fric, _rest, grav, dofx, dofy, dofz, is_box, dynamic, movable, act,
     asleep0, timer0, r_eff2, can_sleep) = rows.clone().unbind(0)

    ids = torch.arange(b, device=dev)
    d_cur = torch.zeros((nr, b), dtype=torch.int64, device=dev)
    lam = torch.zeros((N_SLOT + 3, nr, b), dtype=LAM_DT, device=dev)
    npk = n_planes * N_SLOT
    plam = torch.zeros((4, npk, b), dtype=f32, device=dev)
    ovf = torch.zeros(b, dtype=f32, device=dev)
    paircnt = torch.zeros(b, dtype=f32, device=dev)
    s_sleep = asleep0.clone()
    s_timer = timer0.clone()
    neg30 = torch.full((nr, b), -1e30, dtype=f32, device=dev)

    deltas = torch.arange(1, band + 1, device=dev)[:, None]  # (band, 1)
    cols = ids[None, :] + deltas
    in_band = cols < b
    cols = torch.clamp(cols, max=b - 1)

    rows4 = torch.arange(N_SLOT, device=dev)[:, None]
    su4 = torch.where(rows4 < 2, 1.0, -1.0).to(f32)
    sv4 = torch.where(rows4 % 2 == 0, 1.0, -1.0).to(f32)
    cap_sgn = torch.where(rows4 == 0, 1.0, torch.where(rows4 == 1, -1.0, 0.0)).to(f32)

    geo: dict[str, Tensor] = {}
    for step_i in range(n_substeps):
        if sleep and float(torch.sum(movable * (1.0 - s_sleep))) <= 0.5:
            continue
        # --- gravity -------------------------------------------------------
        grav_dt = grav * dynamic * dt
        if sleep:
            grav_dt = grav_dt * (1.0 - s_sleep)
        vx = vx + g[0] * grav_dt
        vy = vy + g[1] * grav_dt
        vz = vz + g[2] * grav_dt

        rr = _rot_rows(qx, qy, qz, qw)
        box_b = is_box > 0.5
        lh = (torch.where(box_b, hx, rad), torch.where(box_b, hy, rad + hlen), torch.where(box_b, hz, rad))
        eh = [
            torch.abs(rr[k][0]) * lh[0] + torch.abs(rr[k][1]) * lh[1] + torch.abs(rr[k][2]) * lh[2] + margin
            for k in range(3)
        ]
        cax, cay, caz = rr[0][1] * hlen, rr[1][1] * hlen, rr[2][1] * hlen

        rebuild = step_i % geom_every == 0
        if rebuild:
            # --- discovery: first R in-band candidates by ascending delta ---
            pos = (px, py, pz)
            overlap = in_band.clone()
            for k in range(3):
                overlap &= torch.abs(pos[k][cols] - pos[k]) <= eh[k] + eh[k][cols]
            active = overlap & ((dynamic + dynamic[cols]) > 0.5) & ((act * act[cols]) > 0.5)
            ai = active.to(torch.int64)
            pref = torch.cumsum(ai, dim=0) - ai
            kept = active & (pref < nr)
            d_new = torch.zeros((nr, b), dtype=torch.int64, device=dev)
            kd, ka = torch.nonzero(kept, as_tuple=True)
            d_new[pref[kd, ka], ka] = kd + 1
            ovf = (active & ~kept).sum(0).to(f32)
            paircnt = kept.sum(0).to(f32)
            paircnt = paircnt.index_put((cols[kd, ka],), torch.ones_like(ka, dtype=f32), accumulate=True)

            # --- λ remap: new slot inherits the old slot with the same delta -
            match = (d_cur[None, :, :] == d_new[:, None, :]) & (d_new[:, None, :] > 0)
            lam = (lam.float()[:, None] * match[None].float()).sum(2).to(LAM_DT)
            d_cur = d_new
            partner = ids[None, :] + d_cur

            # --- SAT manifolds on (R, B) lanes -------------------------------
            G = lambda t: t[partner]
            dxc, dyc, dzc = G(px) - px, G(py) - py, G(pz) - pz
            crr = tuple(tuple(G(rr[i][j]) for j in range(3)) for i in range(3))
            normal, slots = _sat(
                dxc, dyc, dzc, rr, (hx, hy, hz), rad, is_box,
                ((cax, cay, caz), (G(cax), G(cay), G(caz))), crr,
                (G(hx), G(hy), G(hz)), G(rad), G(is_box),
            )
            pair_valid = d_cur > 0
            geo = {
                "n": normal, "mu": torch.sqrt(fric * G(fric)),
                "d0": (dxc, dyc, dzc), "dc": (dxc, dyc, dzc),
                "ra": [s[:3] for s in slots],
                "depth0": [torch.where(pair_valid, s[3], neg30) for s in slots],
            }
            geo["bias"] = [
                torch.where(d0 > 0.0, baum_dt * torch.clamp(d0 - slop, min=0.0), neg30)
                for d0 in geo["depth0"]
            ]
        else:
            # --- refresh: partner drift along the cached normal -------------
            dc = (px[partner] - px, py[partner] - py, pz[partner] - pz)
            dd = [dc[k] - geo["d0"][k] for k in range(3)]
            nx, ny, nz = geo["n"]
            drift = dd[0] * nx + dd[1] * ny + dd[2] * nz
            geo["dc"] = dc
            geo["bias"] = [
                torch.where((d0 - drift > 0.0) & (d0 > -1e29), baum_dt * torch.clamp(d0 - drift - slop, min=0.0), neg30)
                for d0 in geo["depth0"]
            ]

        # --- analytic hub planes, every substep ------------------------------
        body_ax = [(rr[0][k], rr[1][k], rr[2][k], (hx, hy, hz)[k]) for k in range(3)]
        dyn_b = dynamic > 0.5
        use_box_pt = box_b | (rows4 >= 2)
        shape_gate = torch.where(
            rows4 >= 2, box_b.float(), torch.where(rows4 == 1, (box_b | (hlen > 1e-6)).float(), 1.0)
        ) > 0.5
        plane_cnt = torch.zeros(b, dtype=f32, device=dev)
        pg = {k: [] for k in ("rx", "ry", "rz", "bias", "nx", "ny", "nz", "mu")}
        for p in range(n_planes):
            o = 8 + p * PLANE_SC
            P = sc[o : o + PLANE_SC]
            dpx, dpy, dpz = px - P[0], py - P[1], pz - P[2]
            side = P[3] * dpx + P[4] * dpy + P[5] * dpz
            sgn_p = torch.where(side >= 0.0, 1.0, -1.0).to(f32)
            nex, ney, nez = P[3] * sgn_p, P[4] * sgn_p, P[5] * sgn_p
            f, uf, vf = _incident_face(body_ax, nex, ney, nez, 1.0)
            rax = torch.where(use_box_pt, f[0] + su4 * uf[0] + sv4 * vf[0], cap_sgn * cax - nex * rad)
            ray = torch.where(use_box_pt, f[1] + su4 * uf[1] + sv4 * vf[1], cap_sgn * cay - ney * rad)
            raz = torch.where(use_box_pt, f[2] + su4 * uf[2] + sv4 * vf[2], cap_sgn * caz - nez * rad)
            wxc, wyc, wzc = dpx + rax, dpy + ray, dpz + raz
            depth = P[14] - (nex * wxc + ney * wyc + nez * wzc)
            pu = P[6] * wxc + P[7] * wyc + P[8] * wzc
            pv = P[9] * wxc + P[10] * wyc + P[11] * wzc
            inb = (torch.abs(pu) <= P[12] + margin) & (torch.abs(pv) <= P[13] + margin)
            touching = (P[12] > 0.0) & dyn_b & shape_gate & inb & (depth > 0.0) & (act > 0.5)
            pg["rx"].append(rax); pg["ry"].append(ray); pg["rz"].append(raz)
            pg["bias"].append(torch.where(touching, baum_dt * torch.clamp(depth - slop, min=0.0), -1e30))
            for key, val in (("nx", nex), ("ny", ney), ("nz", nez)):
                pg[key].append(val.expand(N_SLOT, b))
            pg["mu"].append(torch.sqrt(fric * P[15]).expand(N_SLOT, b))
            plane_cnt = plane_cnt + touching.float().sum(0)
        pg = {k: torch.cat(v, 0) for k, v in pg.items()}

        split = torch.clamp(paircnt + plane_cnt, min=1.0)
        ime, imex, imey, imez = inv_mass * split, im3x * split, im3y * split, im3z * split

        nx, ny, nz = geo["n"]
        dxc, dyc, dzc = geo["dc"]
        if rebuild:
            c_ime, c_imex, c_imey, c_imez = ime[partner], imex[partner], imey[partner], imez[partner]
            geo["ikn"] = []
            for rax, ray, raz in geo["ra"]:
                rbx, rby, rbz = rax - dxc, ray - dyc, raz - dzc
                an = (ray * nz - raz * ny, raz * nx - rax * nz, rax * ny - ray * nx)
                bn = (rby * nz - rbz * ny, rbz * nx - rbx * nz, rbx * ny - rby * nx)
                ang_a = imex * (an[0] * an[0]) + imey * (an[1] * an[1]) + imez * (an[2] * an[2])
                ang_b = c_imex * (bn[0] * bn[0]) + c_imey * (bn[1] * bn[1]) + c_imez * (bn[2] * bn[2])
                geo["ikn"].append(1.0 / (ime + c_ime + ang_a + ang_b + 1e-9))

        cxn = pg["ry"] * pg["nz"] - pg["rz"] * pg["ny"]
        cyn = pg["rz"] * pg["nx"] - pg["rx"] * pg["nz"]
        czn = pg["rx"] * pg["ny"] - pg["ry"] * pg["nx"]
        p_ikn = 1.0 / (ime + imex * (cxn * cxn) + imey * (cyn * cyn) + imez * (czn * czn) + 1e-9)

        mov_f = movable * (1.0 - s_sleep) if sleep else movable

        # --- warm pass + projected-Jacobi sweeps -------------------------------
        for it in range(iterations + 1):
            is_warm = it == 0
            r_v = (vx, vy, vz)
            r_w = (wx, wy, wz)
            if not is_warm:
                c_v = (vx[partner], vy[partner], vz[partner])
                c_w = (wx[partner], wy[partner], wz[partner])
            jt = [0.0, 0.0, 0.0]; ta = [0.0, 0.0, 0.0]; tbq = [0.0, 0.0, 0.0]

            # cross products are written `acc + a*b - c*d` in the JAX kernel's
            # association, so float32 rounding matches it term for term
            def apply(j, ra, rb):
                for c in range(3):
                    jt[c] = jt[c] + j[c]
                for c in range(3):
                    c1, c2 = (c + 1) % 3, (c + 2) % 3
                    ta[c] = ta[c] + ra[c1] * j[c2] - ra[c2] * j[c1]
                for c in range(3):
                    c1, c2 = (c + 1) % 3, (c + 2) % 3
                    tbq[c] = tbq[c] + rb[c1] * j[c2] - rb[c2] * j[c1]

            def point_vel(v, w, r, c):
                c1, c2 = (c + 1) % 3, (c + 2) % 3
                return v[c] + w[c1] * r[c2] - w[c2] * r[c1]

            def rel_vel(ra, rb):
                return tuple(point_vel(c_v, c_w, rb, c) - point_vel(r_v, r_w, ra, c) for c in range(3))

            sum_ln = 0.0
            c_a = [0.0, 0.0, 0.0]
            c_wt = 0.0
            for k in range(N_SLOT):
                ra = geo["ra"][k]
                rb = (ra[0] - dxc, ra[1] - dyc, ra[2] - dzc)
                bias = geo["bias"][k]
                touch = (bias > -1e29).float()
                if is_warm:
                    lamw = (lam[k].float() * (touch * warm)).to(LAM_DT)
                    lam[k] = lamw
                    ln_eff = lamw.float()
                    dl = ln_eff
                else:
                    rv = rel_vel(ra, rb)
                    vn = rv[0] * nx + rv[1] * ny + rv[2] * nz
                    ln_old = lam[k].float()
                    ln_store = torch.clamp(ln_old - (vn - bias) * geo["ikn"][k], min=0.0).to(LAM_DT)
                    lam[k] = ln_store
                    ln_eff = ln_store.float()
                    dl = ln_eff - ln_old
                sum_ln = sum_ln + ln_eff
                apply((nx * dl, ny * dl, nz * dl), ra, rb)
                c_a = [c_a[c] + touch * ra[c] for c in range(3)]
                c_wt = c_wt + touch

            # pair friction at the manifold centroid
            inv_cw = 1.0 / torch.clamp(c_wt, min=1.0)
            ra = tuple(c_a[c] * inv_cw for c in range(3))
            rb = (ra[0] - dxc, ra[1] - dyc, ra[2] - dzc)
            lt_old = [lam[N_SLOT + c].float() for c in range(3)]
            if is_warm:
                gate = (c_wt > 0.5).float() * warm
                lt_s = [(lt_old[c] * gate).to(LAM_DT) for c in range(3)]
                dj = [lt_s[c].float() for c in range(3)]
            else:
                rv = rel_vel(ra, rb)
                vn = rv[0] * nx + rv[1] * ny + rv[2] * nz
                tv = (rv[0] - vn * nx, rv[1] - vn * ny, rv[2] - vn * nz)
                lt_c = [lt_old[c] - tv[c] * geo["ikn"][0] for c in range(3)]
                ltl = torch.sqrt(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9
                tscale = torch.clamp(geo["mu"] * sum_ln / ltl, max=1.0)
                lt_s = [(lt_c[c] * tscale).to(LAM_DT) for c in range(3)]
                dj = [lt_s[c].float() - lt_old[c] for c in range(3)]
            for c in range(3):
                lam[N_SLOT + c] = lt_s[c]
            apply(dj, ra, rb)

            # row side: -j / -torque_a; col side: +j / +torque_b at the partner
            col = torch.zeros((6, b), dtype=f32, device=dev)
            col.index_put_(
                (torch.arange(6, device=dev)[:, None], partner.reshape(1, -1).expand(6, -1)),
                torch.stack([*jt, *tbq]).reshape(6, -1),
                accumulate=True,
            )
            acc = [-torch.sum(jt[c], 0) + col[c] for c in range(3)]
            tq = [-torch.sum(ta[c], 0) + col[3 + c] for c in range(3)]

            # plane-contact impulses (body side only)
            prr = (pg["rx"], pg["ry"], pg["rz"])
            pn = (pg["nx"], pg["ny"], pg["nz"])
            if is_warm:
                ptouch = (pg["bias"] > -1e29).float() * warm
                plam = plam * ptouch
                pj = [pn[c] * plam[0] + plam[1 + c] for c in range(3)]
            else:
                rvp = tuple(point_vel(r_v, r_w, prr, c) for c in range(3))
                vn = rvp[0] * pn[0] + rvp[1] * pn[1] + rvp[2] * pn[2]
                ln_old = plam[0]
                ln_new = torch.clamp(ln_old - (vn - pg["bias"]) * p_ikn, min=0.0)
                dlam = ln_new - ln_old
                tv = [rvp[c] - vn * pn[c] for c in range(3)]
                lt_c = [plam[1 + c] - tv[c] * p_ikn for c in range(3)]
                ltl = torch.sqrt(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9
                tscale = torch.clamp(pg["mu"] * ln_new / ltl, max=1.0)
                lt_n = [lt_c[c] * tscale for c in range(3)]
                pj = [pn[c] * dlam + (lt_n[c] - plam[1 + c]) for c in range(3)]
                plam = torch.stack([ln_new, *lt_n])
            for c in range(3):
                acc[c] = acc[c] + torch.sum(pj[c], 0)
            for c in range(3):
                tq[c] = tq[c] + torch.sum(prr[(c + 1) % 3] * pj[(c + 2) % 3] - prr[(c + 2) % 3] * pj[(c + 1) % 3], 0)

            vx = vx + acc[0] * inv_mass * dofx * mov_f
            vy = vy + acc[1] * inv_mass * dofy * mov_f
            vz = vz + acc[2] * inv_mass * dofz * mov_f
            wx = wx + tq[0] * im3x * mov_f
            wy = wy + tq[1] * im3y * mov_f
            wz = wz + tq[2] * im3z * mov_f

        # --- sleeping: wake propagation + deactivation timers (15 Hz) --------
        if sleep and step_i % SLEEP_EVERY == SLEEP_EVERY - 1:
            sp2 = vx * vx + vy * vy + vz * vz + r_eff2 * (wx * wx + wy * wy + wz * wz)
            moving = (sp2 >= sleep_v2).float()
            pusher = dynamic * (1.0 - s_sleep) * moving
            touch = torch.zeros((nr, b), dtype=f32, device=dev)
            for bias in geo["bias"]:
                touch = torch.maximum(touch, (bias > -1e29).float())
            wake = torch.sum(touch * pusher[partner], 0)
            wake = wake + torch.zeros(b, dtype=f32, device=dev).index_put(
                (partner.reshape(-1),), (touch * pusher).reshape(-1), accumulate=True
            )
            wk = (wake > 0.5).float()
            eligible = (1.0 - moving) * can_sleep * (1.0 - wk)
            timer = (s_timer + dt * SLEEP_EVERY) * eligible
            fall = (timer >= sleep_time).float() * eligible
            s_sleep = torch.clamp(s_sleep * (1.0 - wk) + fall, max=1.0)
            s_timer = timer
            keep = 1.0 - s_sleep
            vx, vy, vz, wx, wy, wz = (t * keep for t in (vx, vy, vz, wx, wy, wz))

        # --- integrate positions and orientations ----------------------------
        mov_dt = movable * dt
        if sleep:
            mov_dt = mov_dt * (1.0 - s_sleep)
        px = px + vx * mov_dt
        py = py + vy * mov_dt
        pz = pz + vz * mov_dt
        hq = 0.5 * dt
        mov_f = movable * (1.0 - s_sleep) if sleep else movable
        dqx = hq * (wx * qw + wy * qz - wz * qy)
        dqy = hq * (-wx * qz + wy * qw + wz * qx)
        dqz = hq * (wx * qy - wy * qx + wz * qw)
        dqw = hq * (-wx * qx - wy * qy - wz * qz)
        nqx, nqy, nqz, nqw = qx + dqx * mov_f, qy + dqy * mov_f, qz + dqz * mov_f, qw + dqw * mov_f
        qn = torch.rsqrt(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw + 1e-12)
        qx, qy, qz, qw = nqx * qn, nqy * qn, nqz * qn, nqw * qn

    if not sleep:
        s_sleep, s_timer = asleep0, timer0
    return torch.stack([px, py, pz, vx, vy, vz, wx, wy, wz, qx, qy, qz, qw, s_sleep, s_timer, ovf])


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _compact_cuda(
    scalars: Tensor, rows: Tensor, *, n_substeps: int, iterations: int, warm: float,
    geom_every: int, sleep: bool, band: int, r_slots: int, n_planes: int,
) -> Tensor:
    """Launch the CUDA kernel pipeline on PyTorch's current stream. Raises on a
    build or launch error; never falls back."""
    from .._build import load_kernel_library

    lib = load_kernel_library()
    b = rows.shape[1]
    if scalars.shape != (N_SCALARS,) or rows.shape != (N_ROWS, b):
        raise ValueError(f"bad shapes: scalars {tuple(scalars.shape)}, rows {tuple(rows.shape)}")
    for t in (scalars, rows):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != rows.device:
            raise ValueError("scalars and rows must be contiguous float32 tensors on one card")
    ws = torch.empty(
        lib.compact_workspace_bytes(b, r_slots, band, n_planes), dtype=torch.uint8, device=rows.device
    )
    out = torch.empty((N_OUT, b), dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.compact_substeps(
        scalars.data_ptr(), rows.data_ptr(), out.data_ptr(), ws.data_ptr(),
        b, r_slots, band, n_planes, n_substeps, iterations, ctypes.c_float(warm),
        geom_every, int(sleep), stream,
    )
    if err != 0:
        raise RuntimeError(f"compact kernel launch failed: {lib.compact_error_string(err).decode()}")
    return out


def run_compact(scalars: Tensor, rows: Tensor, **kw) -> Tensor:
    """Device dispatch: the CUDA kernel for tensors on a card (counted in
    `LAUNCHES`), the plain version for tensors on the CPU, nothing else."""
    global LAUNCHES
    if rows.is_cuda:
        out = _compact_cuda(scalars, rows, **kw)
        LAUNCHES += 1
        return out
    if rows.device.type == "cpu":
        return compact_substeps_reference(scalars, rows, **kw)
    raise ValueError(f"no compact-kernel implementation for device {rows.device}")


# ---------------------------------------------------------------------------
# Launch wrapper
# ---------------------------------------------------------------------------

_SCALARS: dict[tuple, tuple[Tensor, Tensor]] = {}


def _scalar_block(ps: PhysicsState, params: PhysicsParams, dt, n_substeps, geom_every, plane_block):
    """The (74,) scalar block: the host scalars around the device's plane
    block. The host parts are made on the device once per (device, values):
    a copy from host memory waits for the card's queue, so a call that made
    them anew could not overlap the previous call's kernel."""
    f32 = np.float32
    sleep_v = f32(params.sleep_velocity)
    head = (float(dt), *map(float, params.gravity), float(params.baumgarte), float(params.penetration_slop),
            0.04 * geom_every,  # AABB margin scales with the geometry stride
            float(n_substeps))
    tail = (float(sleep_v * sleep_v), float(params.sleep_time))  # the square rounded in float32, as on the card
    key = (ps.device, head, tail)
    if key not in _SCALARS:
        _SCALARS[key] = tuple(torch.tensor(v, dtype=torch.float32, device=ps.device) for v in (head, tail))
    h, t = _SCALARS[key]
    return torch.cat([h, plane_block.to(torch.float32), t])


def _input_rows(sp: PhysicsState, hub_sorted: Tensor) -> Tensor:
    f = lambda x: x.to(torch.float32)
    dyn = f((sp.body_type == BODY_DYNAMIC) & sp.active)
    movable = f((sp.body_type != BODY_STATIC) & sp.active)
    is_box = f(sp.shape_type == SHAPE_BOX)
    act_pair = f(sp.active) * (1.0 - f(hub_sorted))  # hubs leave the pair phase
    r_eff = torch.maximum(torch.amax(sp.half_extent, dim=1), sp.radius + sp.half_length)
    can_sleep = dyn * (1.0 - f(sp.is_character))
    return torch.stack(
        [
            *sp.pos.unbind(1), *sp.linvel.unbind(1), *sp.angvel.unbind(1), *sp.quat.unbind(1),
            sp.inv_mass, *sp.inv_inertia.unbind(1), *sp.half_extent.unbind(1),
            sp.radius, sp.half_length, sp.friction, sp.restitution, sp.gravity_factor,
            *sp.dof_mask_lin.unbind(1), is_box, dyn, movable, act_pair,
            f(sp.asleep), sp.sleep_timer, r_eff * r_eff, can_sleep,
        ]
    ).contiguous()


def megakernel_substeps_compact(
    ps: PhysicsState,
    params: PhysicsParams,
    dt,
    n_substeps: int = 1,
    iterations: int = 3,
    warm: float = 0.7,
    geom_every: int = 2,
    sleep: bool = False,
    with_overflow: bool = False,
    band: int = BAND,
    r_slots: int | None = None,
    n_planes: int = N_PLANE,
):
    """Slab-rank sort once per call, run the compact substeps for `n_substeps`,
    permute results back to slot order.

    Returns the advanced PhysicsState; with `with_overflow=True` returns
    `(state, dropped)` where `dropped` (a 0-d tensor) counts the in-band AABB
    candidates that did not fit the neighbour slots at the last rebuild."""
    b = ps.num_slots
    nr = R if r_slots is None else r_slots
    if band % BCHUNK != 0 or band < BCHUNK:
        raise ValueError(f"band must be a positive multiple of {BCHUNK}, got {band}")
    if not 1 <= n_planes <= N_PLANE:
        raise ValueError(f"n_planes must be in 1..{N_PLANE}, got {n_planes}")
    if b % BCHUNK != 0 or b < BCHUNK + band:
        raise ValueError(f"compact kernel needs capacity a multiple of {BCHUNK} and >= {BCHUNK + band}")
    if not warm > 0.0:
        raise ValueError("the compact kernel implements the warm-started solver only")
    if ps.has_proxies:
        raise ValueError("compound bodies are not supported on the compact kernel path")

    plane_block, is_hub = extract_hub_planes(ps)
    perm = slab_rank_perm(slab_rank_key(ps, exclude=is_hub))
    sp = _permute_state(ps, perm)
    scalars = _scalar_block(ps, params, dt, n_substeps, geom_every, plane_block)
    out = run_compact(
        scalars, _input_rows(sp, is_hub[perm]),
        n_substeps=n_substeps, iterations=iterations, warm=warm, geom_every=geom_every,
        sleep=sleep, band=band, r_slots=nr, n_planes=n_planes,
    )
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(b, device=perm.device)
    o = out[:, inv]
    new_ps = dataclasses.replace(
        ps,
        prev_pos=ps.pos,
        prev_quat=ps.quat,
        pos=o[0:3].T.contiguous(),
        linvel=o[3:6].T.contiguous(),
        angvel=o[6:9].T.contiguous(),
        quat=o[9:13].T.contiguous(),
        asleep=o[13] > 0.5,
        sleep_timer=o[14].contiguous(),
    )
    if with_overflow:
        return new_ps, torch.sum(out[15])
    return new_ps
