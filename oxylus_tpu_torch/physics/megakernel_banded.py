"""Rank-banded rigid-body substeps (counterpart of
`oxylus_tpu/physics/megakernel_banded.py`), and the host helpers that the
banded and the compact kernels share.

Bodies are sorted by an x-slab-major rank so that every pair of touching bodies
lies within a small rank distance (the "band"); large static boxes ("hubs")
leave the pair phase and become analytic bounded planes. The helpers compute
that sort key, extract the hub planes, permute body state, and report how well
a band covers a scene.

The banded substeps: one call advances every body by `n_substeps` fixed
substeps over the pair space of 128-row chunks against 256-lane slabs of
ranks, where pair (row a, column b) is live only when 1 ≤ b − a ≤ BAND = 128,
so each unordered pair is seen once (the row side takes −j, the column side
+j). Per substep: gravity, rotations, margin-expanded AABBs; every
`geom_every` substeps the pair geometry (AABB test, SAT manifold, depth and
bias caches, per-body pair counts), otherwise a bias refresh from the drift
since the last SAT; the 4 analytic hub planes; mass-split effective masses
(pairs at each rebuild); with `warm > 0` a warm pass and `iterations`
accumulated-impulse sweeps over bf16 pair λ caches, else `iterations` cold
projected-Jacobi sweeps; optional sleeping (wake propagation and timers every
substep, a substep skipped when every movable body sleeps); integration.

Two implementations share one interface, `(scalars (74,), rows (36, B)) →
(15, B)` in sorted (slab-rank) order, with the compact kernel's scalar block
and input rows:

- `banded_substeps_reference`: plain PyTorch on whole (chunk, 128, 256) pair
  tensors, the column sums taken chunk by chunk in chunk order as the TPU
  kernel does. The wrapper uses it for tensors on the CPU; `chip_smoke.py`
  holds the CUDA kernel against it on the card.
- the CUDA kernel in `csrc/megakernel_banded.cu`, for tensors on a card: one
  persistent cooperative launch a call, a warp per body summing only its
  live pairs. There is no fallback: a CUDA tensor reaches the kernel or the
  call raises.

`megakernel_substeps_banded` wraps either with the stable slab-rank sort, the
permutation, the scalar block and the inverse permutation. `LAUNCHES` counts
calls that went to the CUDA kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .state import BODY_STATIC, SHAPE_BOX, PhysicsParams, PhysicsState

Tensor = torch.Tensor

BAND = 128            # max rank_b - rank_a for a pair (the banded kernel's fixed band, the compact kernel's default)
BCHUNK = 128          # rows per chunk of the pair space
SLAB = BCHUNK + BAND  # 256 columns per chunk
N_SLOT = 4            # manifold points per pair
LAM_DT = torch.bfloat16  # pair impulse caches, as the TPU kernel's
N_OUT = 15
N_PLANE = 4           # analytic bounded-plane slots (large static "hub" boxes)
PLANE_SC = 16         # scalars per plane in the scalar block
HUB_MIN_FACE_AREA = 25.0  # m²: static boxes with a larger face become analytic planes


def _part1by1(x: Tensor) -> Tensor:
    """Spread the low 16 bits of x so there is a zero bit between each."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    return (x | (x << 1)) & 0x55555555


def morton_rank_key(ps: PhysicsState, exclude: Tensor | None = None) -> Tensor:
    """Sort key: inactive (and excluded hub) bodies last, others by Morton(x, z)
    cell (vertical columns stay rank-adjacent under y-gravity)."""
    lo = ps.pos.min(0).values
    hi = ps.pos.max(0).values
    span = torch.clamp(hi - lo, min=1e-3)
    qx = torch.clamp((ps.pos[:, 0] - lo[0]) / span[0] * 1023.0, 0, 1023).to(torch.int32)
    qz = torch.clamp((ps.pos[:, 2] - lo[2]) / span[2] * 1023.0, 0, 1023).to(torch.int32)
    morton = _part1by1(qx) | (_part1by1(qz) << 1)
    last = ~ps.active if exclude is None else (~ps.active) | exclude
    return morton + last.to(torch.int32) * (1 << 22)


def slab_rank_key(ps: PhysicsState, exclude: Tensor | None = None) -> Tensor:
    """x-slab-major, z-minor sort key (f32), computed in the JAX module's order.
    Slab width ≈ 1.1 mean body diameters, so each slab holds about one body
    column per z cell and lateral neighbours sit within ~2 slab populations."""
    act = ps.active if exclude is None else ps.active & ~exclude
    actf = act.to(torch.float32)
    n = torch.clamp(torch.sum(actf), min=1.0)
    eff_half = torch.maximum(torch.amax(ps.half_extent, dim=1), ps.radius)
    cell = 2.2 * torch.sum(eff_half * actf) / n  # ≈ 1.1 × mean diameter
    cell = torch.clamp(cell, min=1e-3)
    big = 3e9  # a Python scalar: a tensor made from it would be a blocking copy to the card
    lo_x = torch.amin(torch.where(act, ps.pos[:, 0], big))
    lo_z = torch.amin(torch.where(act, ps.pos[:, 2], big))
    hi_z = torch.amax(torch.where(act, ps.pos[:, 2], -big))
    qx = torch.floor((ps.pos[:, 0] - lo_x) / cell)
    zn = (ps.pos[:, 2] - lo_z) / torch.clamp(hi_z - lo_z, min=1e-3)
    key = qx + torch.clamp(zn, 0.0, 0.999)
    return torch.where(act, key, big)


def slab_rank_perm(key: Tensor) -> Tensor:
    """Stable ascending sort of the key: ties keep slot order, as the JAX
    `lax.sort((key, iota), num_keys=1)` does."""
    return torch.sort(key, stable=True).indices


def _hub_scores(ps: PhysicsState) -> Tensor:
    sorted_ext = torch.sort(ps.half_extent, dim=1).values  # ascending
    face_area = 4.0 * sorted_ext[:, 1] * sorted_ext[:, 2]
    candidate = (ps.body_type == BODY_STATIC) & (ps.shape_type == SHAPE_BOX) & ps.active
    return torch.where(candidate, face_area, torch.full_like(face_area, -1.0))


def extract_hub_planes(ps: PhysicsState) -> tuple[Tensor, Tensor]:
    """Find up to N_PLANE large static boxes and describe them as bounded planes.

    Returns (plane_scalars (N_PLANE*PLANE_SC,), is_hub (B,) bool). Each plane row
    is [center(3), n(3), u(3), v(3), half_u, half_v, half_thickness, friction]
    with half_u = -1 marking an unused slot. Top-k ties resolve to the lower
    slot, as `lax.top_k` does."""
    hub_score = _hub_scores(ps)
    order = torch.sort(hub_score, descending=True, stable=True).indices[:N_PLANE]
    vals = hub_score[order]
    hub_ok = vals > HUB_MIN_FACE_AREA
    is_hub = torch.zeros(ps.num_slots, dtype=torch.bool, device=ps.device)
    is_hub[order] = hub_ok

    x, y, z, w = ps.quat[order].unbind(-1)
    r = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )  # (N_PLANE, 3, 3)
    h = ps.half_extent[order]  # (N_PLANE, 3)
    ax = torch.argsort(h, dim=1, stable=True)  # thin axis first → plane normal
    cols = lambda k: torch.gather(r, 2, ax[:, k][:, None, None].expand(-1, 3, 1))[..., 0]
    h_of = lambda k: torch.gather(h, 1, ax[:, k : k + 1])[:, 0]
    hu = torch.where(hub_ok, h_of(1), torch.full_like(vals, -1.0))
    rows = torch.cat(
        [
            ps.pos[order], cols(0), cols(1), cols(2),
            torch.stack([hu, h_of(2), h_of(0), ps.friction[order]], dim=-1),
        ],
        dim=1,
    )  # (N_PLANE, PLANE_SC)
    return rows.reshape(-1), is_hub


def count_hub_planes(ps: PhysicsState) -> int:
    """Host-side count of the hub planes extract_hub_planes would emit (1..N_PLANE),
    used to size the compact kernel's plane-contact rows to the scene."""
    he = ps.half_extent.cpu().numpy()
    ext = np.sort(he, axis=1)
    area = 4.0 * ext[:, 1] * ext[:, 2]
    is_hub = (
        (ps.body_type.cpu().numpy() == BODY_STATIC)
        & (ps.shape_type.cpu().numpy() == SHAPE_BOX)
        & ps.active.cpu().numpy()
        & (area > HUB_MIN_FACE_AREA)
    )
    return max(1, min(int(is_hub.sum()), N_PLANE))


def band_coverage_report(ps: PhysicsState, margin: float = 0.1, band: int | None = None) -> dict:
    """How well does the ±band rank window cover the AABB-overlap pair set?
    Dense O(B²) — for set-up checks and tests, not the hot path.

    Returns {"pairs": in-overlap pair count, "outside_band": pairs the band mask
    would reject this launch, "max_rank_dist": worst pair rank distance}."""
    _, is_hub = extract_hub_planes(ps)
    key = slab_rank_key(ps, exclude=is_hub)
    rank = torch.argsort(slab_rank_perm(key))
    eff = torch.maximum(torch.amax(ps.half_extent, dim=1), ps.radius) + margin
    lo = ps.pos - eff[:, None]
    hi = ps.pos + eff[:, None]
    overlap = torch.all((lo[:, None, :] <= hi[None, :, :]) & (hi[:, None, :] >= lo[None, :, :]), dim=-1)
    act = ps.active & ~is_hub
    valid = act[:, None] & act[None, :] & (rank[:, None] < rank[None, :])
    pair = overlap & valid
    dist = torch.abs(rank[:, None] - rank[None, :])
    return {
        "pairs": int(torch.sum(pair)),
        "outside_band": int(torch.sum(pair & (dist > (BAND if band is None else band)))),
        "max_rank_dist": int(torch.amax(torch.where(pair, dist, torch.zeros_like(dist)))),
    }


_PERMUTED_FIELDS = (
    "pos", "prev_pos", "linvel", "angvel", "quat", "prev_quat",
    "inv_mass", "inv_inertia", "half_extent", "radius", "radius2", "half_length",
    "friction", "restitution", "gravity_factor", "dof_mask_lin",
    "body_type", "shape_type", "active", "entity", "is_character",
    "ground_normal_y", "asleep", "sleep_timer",
)


def _permute_state(ps: PhysicsState, perm: Tensor) -> PhysicsState:
    return dataclasses.replace(ps, **{f: getattr(ps, f)[perm] for f in _PERMUTED_FIELDS})


# ---------------------------------------------------------------------------
# Banded substeps: plain PyTorch version
# ---------------------------------------------------------------------------

# kernel launches made by `megakernel_substeps_banded` (one per call that ran
# on a card); read and reset by callers that must prove the kernel ran
LAUNCHES = 0

# What `PASS_CYCLES` holds: the kernel's passes, then (named "warps: ...")
# the sweep passes' warp time split.
PASSES = ("pre", "geom", "lists", "sweep", "sleep", "warps: pairs", "warps: sums")
# None, or an int64 tensor of len(PASSES) on the card: while it is set, every
# call adds each pass kind's SM cycles (block 0's, barrier to barrier) to it,
# so a profiler can split the one launch (`profile_flagship`), and its sweep
# warps' cycles in the pair impulses and in the body's sums with its plane
# points (what the first port's k_solve_pairs and k_solve_bodies did), summed
# over warps.
PASS_CYCLES: Tensor | None = None


def _cycles_ptr(cycles: Tensor | None, n: int, dev: torch.device) -> int | None:
    """The device pointer of a pass-cycle tensor (or None), after checking it."""
    if cycles is None:
        return None
    if cycles.dtype != torch.int64 or cycles.shape != (n,) or cycles.device != dev:
        raise ValueError(f"pass cycles must be an int64 tensor of {n} on {dev}")
    return cycles.data_ptr()


def slab_starts(b: int) -> list[int]:
    """First column of each chunk's slab; the last chunk's slab is clamped to
    end at the last rank, so its offset is b - SLAB, not its own start."""
    return [max(0, min(c * BCHUNK, b - SLAB)) for c in range(b // BCHUNK)]


def banded_substeps_reference(
    scalars: Tensor,
    rows: Tensor,
    *,
    n_substeps: int,
    iterations: int = 10,
    warm: float = 0.0,
    geom_every: int = 1,
    sleep: bool = False,
) -> Tensor:
    """Plain PyTorch version of the banded kernel on sorted bodies.

    `scalars` (74,) f32: dt, gravity(3), baumgarte, slop, AABB margin, n_sub,
    N_PLANE×PLANE_SC plane scalars, sleep velocity², sleep time. `rows`
    (36, B) f32 per-body inputs (`megakernel_compact._input_rows`). Returns
    (15, B): pos(3), linvel(3), angvel(3), quat(4), asleep, sleep timer.
    Row-side values are (chunk, 128, 1), slab values (chunk, 1, 256), so each
    (row, lane) of the pair space is one element of a (chunk, 128, 256) tensor,
    as in the TPU kernel's scratch."""
    from .megakernel_compact import _incident_face, _rot_rows, _sat

    dev = rows.device
    f32 = torch.float32
    b = rows.shape[1]
    nc = b // BCHUNK
    starts = slab_starts(b)
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

    ridx = torch.arange(b, device=dev).reshape(nc, BCHUNK, 1)
    cidx = (torch.tensor(starts, device=dev)[:, None] + torch.arange(SLAB, device=dev)).reshape(nc, 1, SLAB)
    delta = cidx - ridx
    in_band = (delta >= 1) & (delta <= BAND)
    R = lambda t: t[ridx]   # row body of each chunk row
    C = lambda t: t[cidx]   # column body of each slab lane
    neg30 = torch.tensor(-1e30, dtype=f32, device=dev)

    def row_sum(m: Tensor) -> Tensor:
        return m.sum(-1).reshape(*m.shape[:-3], b)

    def col_sum(m: Tensor) -> Tensor:
        """Per body, the sum over the rows that pair with it as column: per
        chunk over its rows, then the chunks' slabs added in chunk order."""
        part = m.sum(-2)  # (..., nc, SLAB)
        acc = torch.zeros((*m.shape[:-3], b), dtype=f32, device=dev)
        for c, cs in enumerate(starts):
            acc[..., cs : cs + SLAB] = acc[..., cs : cs + SLAB] + part[..., c, :]
        return acc

    if warm > 0.0:
        lam = torch.zeros((N_SLOT + 3, nc, BCHUNK, SLAB), dtype=LAM_DT, device=dev)
        plam = torch.zeros((N_PLANE, N_SLOT, 4, b), dtype=f32, device=dev)  # λn, λt(3)
    s_sleep = asleep0.clone()
    s_timer = timer0.clone()
    su = (1.0, 1.0, -1.0, -1.0)
    sv = (1.0, -1.0, 1.0, -1.0)
    planes = [sc[8 + p * PLANE_SC : 8 + (p + 1) * PLANE_SC] for p in range(N_PLANE)]

    for step_i in range(n_substeps):
        if sleep and float(torch.sum(movable * (1.0 - s_sleep))) <= 0.5:
            continue  # every movable body asleep: the substep does nothing
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
        dxc, dyc, dzc = C(px) - R(px), C(py) - R(py), C(pz) - R(pz)

        # --- pair geometry every geom_every substeps, else a bias refresh ----
        rebuild = step_i % geom_every == 0
        if rebuild:
            overlap = in_band
            for k, d in enumerate((dxc, dyc, dzc)):
                overlap = overlap & (torch.abs(d) <= R(eh[k]) + C(eh[k]))
            active = overlap & ((R(dynamic) + C(dynamic)) > 0.5) & ((R(act) * C(act)) > 0.5)
            ovf = active.to(f32)
            paircnt = row_sum(ovf) + col_sum(ovf)
            normal, slots = _sat(
                dxc, dyc, dzc, tuple(tuple(R(rr[i][j]) for j in range(3)) for i in range(3)),
                (R(hx), R(hy), R(hz)), R(rad), R(is_box),
                ((R(cax), R(cay), R(caz)), (C(cax), C(cay), C(caz))),
                tuple(tuple(C(rr[i][j]) for j in range(3)) for i in range(3)),
                (C(hx), C(hy), C(hz)), C(rad), C(is_box),
            )
            nx, ny, nz = normal
            ra = [s[:3] for s in slots]
            depth0 = [torch.where(active, s[3], neg30) for s in slots]
            bias = [torch.where(d0 > 0.0, baum_dt * torch.clamp(d0 - slop, min=0.0), neg30) for d0 in depth0]
            p0 = (px, py, pz)
        else:
            dd = [(C(p) - C(q)) - (R(p) - R(q)) for p, q in zip((px, py, pz), p0)]
            drift = dd[0] * nx + dd[1] * ny + dd[2] * nz
            depth = [d0 - drift for d0 in depth0]
            bias = [torch.where(d > 0.0, baum_dt * torch.clamp(d - slop, min=0.0), neg30) for d in depth]

        # --- analytic hub planes (per body, every substep) -----------------
        body_ax = [(rr[0][k], rr[1][k], rr[2][k], (hx, hy, hz)[k]) for k in range(3)]
        dyn_b = dynamic > 0.5
        plane_cnt = torch.zeros(b, dtype=f32, device=dev)
        pgeo = []  # per (plane, slot): (ra(3), bias, plane normal toward the body)
        for P in planes:
            dp = (px - P[0], py - P[1], pz - P[2])
            side = P[3] * dp[0] + P[4] * dp[1] + P[5] * dp[2]
            sgn_p = torch.where(side >= 0.0, 1.0, -1.0).to(f32)
            ne = (P[3] * sgn_p, P[4] * sgn_p, P[5] * sgn_p)
            f, uf, vf = _incident_face(body_ax, *ne, 1.0)
            for k in range(N_SLOT):
                bp = [f[c] + su[k] * uf[c] + sv[k] * vf[c] for c in range(3)]
                if k >= 2:
                    r = bp
                    shape_ok = box_b
                else:
                    sg = 1.0 if k == 0 else -1.0
                    cap = (sg * cax - ne[0] * rad, sg * cay - ne[1] * rad, sg * caz - ne[2] * rad)
                    r = [torch.where(box_b, bp[c], cap[c]) for c in range(3)]
                    shape_ok = box_b | (hlen > 1e-6) if k == 1 else torch.ones_like(box_b)
                wc = [dp[c] + r[c] for c in range(3)]
                depth = P[14] - (ne[0] * wc[0] + ne[1] * wc[1] + ne[2] * wc[2])
                pu = P[6] * wc[0] + P[7] * wc[1] + P[8] * wc[2]
                pv = P[9] * wc[0] + P[10] * wc[1] + P[11] * wc[2]
                inb = (torch.abs(pu) <= P[12] + margin) & (torch.abs(pv) <= P[13] + margin)
                touching = (P[12] > 0.0) & dyn_b & shape_ok & inb & (depth > 0.0) & (act > 0.5)
                pgeo.append((r, torch.where(touching, baum_dt * torch.clamp(depth - slop, min=0.0), neg30), ne))
                plane_cnt = plane_cnt + touching.to(f32)

        split = torch.clamp(paircnt + plane_cnt, min=1.0)
        ime, imex, imey, imez = inv_mass * split, im3x * split, im3y * split, im3z * split

        # --- effective masses: pairs at each rebuild, planes every substep --
        if rebuild:
            ikn = []
            for rax, ray, raz in ra:
                rbx, rby, rbz = rax - dxc, ray - dyc, raz - dzc
                an = (ray * nz - raz * ny, raz * nx - rax * nz, rax * ny - ray * nx)
                bn = (rby * nz - rbz * ny, rbz * nx - rbx * nz, rbx * ny - rby * nx)
                ang_a = R(imex) * (an[0] * an[0]) + R(imey) * (an[1] * an[1]) + R(imez) * (an[2] * an[2])
                ang_b = C(imex) * (bn[0] * bn[0]) + C(imey) * (bn[1] * bn[1]) + C(imez) * (bn[2] * bn[2])
                ikn.append(1.0 / (R(ime) + C(ime) + ang_a + ang_b + 1e-9))
        p_ikn = []
        for r, _, ne in pgeo:
            cxn = r[1] * ne[2] - r[2] * ne[1]
            cyn = r[2] * ne[0] - r[0] * ne[2]
            czn = r[0] * ne[1] - r[1] * ne[0]
            p_ikn.append(1.0 / (ime + imex * (cxn * cxn) + imey * (cyn * cyn) + imez * (czn * czn) + 1e-9))

        # --- solver: warm pass + sweeps over the cached geometry ------------
        mu = torch.sqrt(R(fric) * C(fric))
        mov_f = movable * (1.0 - s_sleep) if sleep else movable
        passes = ([True] if warm > 0.0 else []) + [False] * iterations
        for is_warm in passes:
            r_v, r_w = (R(vx), R(vy), R(vz)), (R(wx), R(wy), R(wz))
            c_v, c_w = (C(vx), C(vy), C(vz)), (C(wx), C(wy), C(wz))
            jt = [0.0, 0.0, 0.0]; ta = [0.0, 0.0, 0.0]; tbq = [0.0, 0.0, 0.0]

            # cross products are written `acc + a*b - c*d` in the JAX kernel's
            # association, so float32 rounding matches it term for term
            def apply(j, ra_, rb_):
                for c in range(3):
                    jt[c] = jt[c] + j[c]
                for c in range(3):
                    c1, c2 = (c + 1) % 3, (c + 2) % 3
                    ta[c] = ta[c] + ra_[c1] * j[c2] - ra_[c2] * j[c1]
                for c in range(3):
                    c1, c2 = (c + 1) % 3, (c + 2) % 3
                    tbq[c] = tbq[c] + rb_[c1] * j[c2] - rb_[c2] * j[c1]

            def point_vel(v, w, r, c):
                c1, c2 = (c + 1) % 3, (c + 2) % 3
                return v[c] + w[c1] * r[c2] - w[c2] * r[c1]

            def rel_vel(ra_, rb_):
                return tuple(point_vel(c_v, c_w, rb_, c) - point_vel(r_v, r_w, ra_, c) for c in range(3))

            if warm > 0.0:
                # per-slot normal impulses against the bf16 caches, then one
                # friction solve per pair at the touching points' centroid
                sum_ln = 0.0
                c_a = [0.0, 0.0, 0.0]
                c_wt = 0.0
                for k in range(N_SLOT):
                    rk = ra[k]
                    rb = (rk[0] - dxc, rk[1] - dyc, rk[2] - dzc)
                    touch = (bias[k] > -1e29).to(f32)
                    if is_warm:
                        lamw = (lam[k].float() * (touch * warm)).to(LAM_DT)
                        lam[k] = lamw
                        ln_eff = lamw.float()
                        dl = ln_eff
                    else:
                        rv = rel_vel(rk, rb)
                        vn = rv[0] * nx + rv[1] * ny + rv[2] * nz
                        ln_old = lam[k].float()
                        ln_store = torch.clamp(ln_old - (vn - bias[k]) * ikn[k], min=0.0).to(LAM_DT)
                        lam[k] = ln_store
                        ln_eff = ln_store.float()
                        dl = ln_eff - ln_old
                    sum_ln = sum_ln + ln_eff
                    apply((nx * dl, ny * dl, nz * dl), rk, rb)
                    c_a = [c_a[c] + touch * rk[c] for c in range(3)]
                    c_wt = c_wt + touch
                inv_cw = 1.0 / torch.clamp(c_wt, min=1.0)
                rk = tuple(c_a[c] * inv_cw for c in range(3))
                rb = (rk[0] - dxc, rk[1] - dyc, rk[2] - dzc)
                lt_old = [lam[N_SLOT + c].float() for c in range(3)]
                if is_warm:
                    gate = (c_wt > 0.5).to(f32) * warm
                    lt_s = [(lt_old[c] * gate).to(LAM_DT) for c in range(3)]
                    dj = [lt_s[c].float() for c in range(3)]
                else:
                    rv = rel_vel(rk, rb)
                    vn = rv[0] * nx + rv[1] * ny + rv[2] * nz
                    tv = (rv[0] - vn * nx, rv[1] - vn * ny, rv[2] - vn * nz)
                    lt_c = [lt_old[c] - tv[c] * ikn[0] for c in range(3)]
                    ltl = torch.sqrt(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9
                    tscale = torch.clamp(mu * sum_ln / ltl, max=1.0)
                    lt_s = [(lt_c[c] * tscale).to(LAM_DT) for c in range(3)]
                    dj = [lt_s[c].float() - lt_old[c] for c in range(3)]
                for c in range(3):
                    lam[N_SLOT + c] = lt_s[c]
                apply(dj, rk, rb)
            else:
                for k in range(N_SLOT):
                    rk = ra[k]
                    rb = (rk[0] - dxc, rk[1] - dyc, rk[2] - dzc)
                    rv = rel_vel(rk, rb)
                    vn = rv[0] * nx + rv[1] * ny + rv[2] * nz
                    lamn = torch.clamp(-(vn - bias[k]) * ikn[k], min=0.0)
                    tv = (rv[0] - vn * nx, rv[1] - vn * ny, rv[2] - vn * nz)
                    tvl = torch.sqrt(tv[0] * tv[0] + tv[1] * tv[1] + tv[2] * tv[2]) + 1e-9
                    lam_t = torch.minimum(tvl * ikn[k], mu * lamn)
                    apply(tuple(n * lamn - t / tvl * lam_t for n, t in zip((nx, ny, nz), tv)), rk, rb)

            # row side -j / -torque_a, column side +j / +torque_b
            rows_s = row_sum(torch.stack([*jt, *ta]))
            cols_s = col_sum(torch.stack([*jt, *tbq]))
            acc = [-rows_s[c] + cols_s[c] for c in range(3)]
            tq = [-rows_s[3 + c] + cols_s[3 + c] for c in range(3)]

            # plane contacts (body side only), added one (plane, slot) at a time
            bv, bw = (vx, vy, vz), (wx, wy, wz)
            for i, (r, pbias, ne) in enumerate(pgeo):
                p, k = divmod(i, N_SLOT)
                if is_warm:
                    touch = (pbias > -1e29).to(f32) * warm
                    pl = plam[p, k]
                    lamw = pl[0] * touch
                    j = [ne[c] * lamw + pl[1 + c] * touch for c in range(3)]
                    plam[p, k] = torch.stack([lamw, pl[1] * touch, pl[2] * touch, pl[3] * touch])
                else:
                    rv = tuple(point_vel(bv, bw, r, c) for c in range(3))
                    vn = rv[0] * ne[0] + rv[1] * ne[1] + rv[2] * ne[2]
                    tv = [rv[c] - vn * ne[c] for c in range(3)]
                    mu_p = torch.sqrt(fric * planes[p][15])
                    if warm > 0.0:
                        pl = plam[p, k]
                        ln_new = torch.clamp(pl[0] - (vn - pbias) * p_ikn[i], min=0.0)
                        dlam = ln_new - pl[0]
                        lt_c = [pl[1 + c] - tv[c] * p_ikn[i] for c in range(3)]
                        ltl = torch.sqrt(lt_c[0] * lt_c[0] + lt_c[1] * lt_c[1] + lt_c[2] * lt_c[2]) + 1e-9
                        tscale = torch.clamp(mu_p * ln_new / ltl, max=1.0)
                        lt_n = [lt_c[c] * tscale for c in range(3)]
                        j = [ne[c] * dlam + (lt_n[c] - pl[1 + c]) for c in range(3)]
                        plam[p, k] = torch.stack([ln_new, *lt_n])
                    else:
                        lamn = torch.clamp(-(vn - pbias) * p_ikn[i], min=0.0)
                        tvl = torch.sqrt(tv[0] * tv[0] + tv[1] * tv[1] + tv[2] * tv[2]) + 1e-9
                        lam_t = torch.minimum(tvl * p_ikn[i], mu_p * lamn)
                        j = [ne[c] * lamn - tv[c] / tvl * lam_t for c in range(3)]
                for c in range(3):
                    acc[c] = acc[c] + j[c]
                for c in range(3):
                    c1, c2 = (c + 1) % 3, (c + 2) % 3
                    tq[c] = tq[c] + r[c1] * j[c2] - r[c2] * j[c1]

            vx = vx + acc[0] * inv_mass * dofx * mov_f
            vy = vy + acc[1] * inv_mass * dofy * mov_f
            vz = vz + acc[2] * inv_mass * dofz * mov_f
            wx = wx + tq[0] * im3x * mov_f
            wy = wy + tq[1] * im3y * mov_f
            wz = wz + tq[2] * im3z * mov_f

        # --- sleeping: wake propagation + deactivation timers ---------------
        if sleep:
            sp2 = vx * vx + vy * vy + vz * vz + r_eff2 * (wx * wx + wy * wy + wz * wz)
            moving = (sp2 >= sleep_v2).to(f32)
            pusher = dynamic * (1.0 - s_sleep) * moving
            touch = (bias[0] > -1e29).to(f32)
            for k in range(1, N_SLOT):
                touch = torch.maximum(touch, (bias[k] > -1e29).to(f32))
            wake = col_sum(touch * R(pusher)) + row_sum(touch * C(pusher))
            wk = (wake > 0.5).to(f32)
            eligible = (1.0 - moving) * can_sleep * (1.0 - wk)
            timer = (s_timer + dt) * eligible
            fall = (timer >= sleep_time).to(f32) * eligible
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
    return torch.stack([px, py, pz, vx, vy, vz, wx, wy, wz, qx, qy, qz, qw, s_sleep, s_timer])


# ---------------------------------------------------------------------------
# Banded substeps: CUDA kernel and launch wrapper
# ---------------------------------------------------------------------------

def _banded_cuda(
    scalars: Tensor, rows: Tensor, *, n_substeps: int, iterations: int, warm: float, geom_every: int, sleep: bool,
) -> Tensor:
    """Launch the CUDA kernel on PyTorch's current stream: one cooperative
    launch for the whole call. Raises on a build or launch error; never falls
    back."""
    from .._build import load_kernel_library
    from .megakernel_compact import N_ROWS, N_SCALARS

    lib = load_kernel_library()
    b = rows.shape[1]
    if scalars.shape != (N_SCALARS,) or rows.shape != (N_ROWS, b) or b % BCHUNK != 0 or b < SLAB:
        raise ValueError(f"bad shapes: scalars {tuple(scalars.shape)}, rows {tuple(rows.shape)}")
    for t in (scalars, rows):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != rows.device:
            raise ValueError("scalars and rows must be contiguous float32 tensors on one card")
    ws = torch.empty(lib.banded_workspace_bytes(b), dtype=torch.uint8, device=rows.device)
    out = torch.empty((N_OUT, b), dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.banded_substeps(
        scalars.data_ptr(), rows.data_ptr(), out.data_ptr(), ws.data_ptr(),
        _cycles_ptr(PASS_CYCLES, len(PASSES), rows.device), b, n_substeps, iterations, ctypes.c_float(warm),
        geom_every, int(sleep), stream,
    )
    if err != 0:
        raise RuntimeError(f"banded kernel launch failed: {lib.kernel_error_string(err).decode()}")
    return out


def run_banded(scalars: Tensor, rows: Tensor, **kw) -> Tensor:
    """Device dispatch: the CUDA kernel for tensors on a card (counted in
    `LAUNCHES`), the plain version for tensors on the CPU, nothing else."""
    global LAUNCHES
    if rows.is_cuda:
        out = _banded_cuda(scalars, rows, **kw)
        LAUNCHES += 1
        return out
    if rows.device.type == "cpu":
        return banded_substeps_reference(scalars, rows, **kw)
    raise ValueError(f"no banded-kernel implementation for device {rows.device}")


def pair_work(ps: PhysicsState, geom_every: int = 1) -> dict[str, int]:
    """What one pair rebuild of the banded substeps must compute on `ps` in
    sorted order, for operation counts of the kernel's function: the in-band
    candidate pairs (`candidates`), the live pairs by shape kind, row body
    first (`box_box`, `box_round`, `round_box`, `round_round`), and their
    touching manifold points (`points`), as `megakernel.pair_work` counts
    them for the dense kernel."""
    from .megakernel import pair_contacts
    from .megakernel_compact import _input_rows

    _, is_hub = extract_hub_planes(ps)
    perm = slab_rank_perm(slab_rank_key(ps, exclude=is_hub))
    r = _input_rows(_permute_state(ps, perm), is_hub[perm])
    _, active, _, slots = pair_contacts(r[0:3], r[9:13], r[17:20], r[20], r[21], r[28], r[29], r[31],
                                        0.04 * geom_every)
    ids = torch.arange(ps.num_slots, device=ps.device)
    delta = ids[None, :] - ids[:, None]
    band = (delta >= 1) & (delta <= BAND)
    live = active & band
    box = r[28] > 0.5
    rb, cb = box[:, None], box[None, :]
    kinds = {"box_box": rb & cb, "box_round": rb & ~cb, "round_box": ~rb & cb, "round_round": ~rb & ~cb}
    work = {"candidates": int(band.sum())}
    work.update({k: int((live & m).sum()) for k, m in kinds.items()})
    work["points"] = sum(int((live & (sl[3] > 0.0)).sum()) for sl in slots)
    return work


def megakernel_substeps_banded(
    ps: PhysicsState,
    params: PhysicsParams,
    dt,
    n_substeps: int = 1,
    iterations: int = 10,
    warm: float = 0.0,
    geom_every: int = 1,
    sleep: bool = False,
) -> PhysicsState:
    """Slab-rank sort once per call, run the banded substeps for `n_substeps`,
    permute results back to slot order. Capacity must be a multiple of 128
    and at least 256; compound proxies are refused."""
    from .megakernel_compact import _input_rows, _scalar_block

    b = ps.num_slots
    if b % BCHUNK != 0 or b < SLAB:
        raise ValueError(f"banded kernel needs capacity a multiple of {BCHUNK} and >= {SLAB}, got {b}")
    if ps.has_proxies:
        raise ValueError("compound bodies are not supported on the banded kernel path; use physics_substep")

    plane_block, is_hub = extract_hub_planes(ps)
    perm = slab_rank_perm(slab_rank_key(ps, exclude=is_hub))
    sp = _permute_state(ps, perm)
    out = run_banded(
        _scalar_block(ps, params, dt, n_substeps, geom_every, plane_block), _input_rows(sp, is_hub[perm]),
        n_substeps=n_substeps, iterations=iterations, warm=warm, geom_every=geom_every, sleep=sleep,
    )
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(b, device=perm.device)
    o = out[:, inv]
    return dataclasses.replace(
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
