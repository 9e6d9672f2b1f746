"""One fixed-timestep rigid-body substep: broadphase → narrowphase → solver →
integrate (counterpart of `oxylus_tpu/physics/step.py`, plain PyTorch).

- broadphase: dense (B, B) AABB overlap and a cumsum compaction to
  `max_pairs` slots; overflowing pairs are dropped.
- narrowphase: analytic contacts for box / capsule / tapered capsule / sphere /
  cylinder pairs, up to `points_per_pair` manifold points each, plus the static
  triangle-mesh collider (`mesh_contacts`).
- solver: mass-splitting projected Jacobi with warm-started accumulated normal
  and friction impulses, Baumgarte bias, restitution (max combine) and friction
  (geometric-mean combine).
- integrate: semi-implicit Euler, exponential-map rotation update, optional
  gyroscopic midpoint update, sleeping with wake propagation.

The JAX module has two contact↔body exchanges (`comm="matmul"`, incidence
matmuls shaped for the TPU's per-op cost, and `comm="scatter"`); they compute
the same function, and the port has one: gathers and `index_add_`. Scatters
that the JAX module writes with `mode="drop"` aim their dropped rows at a spare
row that is cut off afterwards, so no shape depends on the data. `lax.top_k`
becomes a stable descending sort, so equal depths keep the lower index first,
as `top_k` does.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import math3d
from .state import (
    BODY_DYNAMIC,
    BODY_STATIC,
    SHAPE_BOX,
    SHAPE_CYLINDER,
    SHAPE_MESH,
    PhysicsParams,
    PhysicsState,
)

Tensor = torch.Tensor
F32 = torch.float32


def _p(v, device) -> Tensor:
    """A solver parameter as a float32 tensor, as the JAX params carry them."""
    return torch.as_tensor(v, dtype=F32, device=device)


def _norm(v: Tensor, keepdim: bool = False) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def _top_k(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """`lax.top_k` over the last axis: the k largest, ties lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """Gather rows of x (..., N, 3) at idx (..., K) → (..., K, 3)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _roots(ps: PhysicsState) -> Tensor:
    ids = torch.arange(ps.num_slots, dtype=torch.int32, device=ps.device)
    return torch.where(ps.parent >= 0, ps.parent, ids).long()


def _scatter_drop(n: int, idx: Tensor, vals: Tensor, reduce: str, init) -> Tensor:
    """(n,) buffer filled with `init`, reduced with vals at idx; idx == n drops."""
    out = torch.full((n + 1,), init, dtype=vals.dtype, device=vals.device)
    out = out.scatter_reduce(0, idx.long(), vals, reduce=reduce, include_self=True)
    return out[:n]


# ---------------------------------------------------------------------------
# Broadphase
# ---------------------------------------------------------------------------

def shape_local_halfbox(ps: PhysicsState) -> Tensor:
    """Conservative local-frame half extents of each collider."""
    rmax = torch.maximum(ps.radius, ps.radius2)  # radius2 == 0 → uniform radius
    cap = torch.stack([rmax, ps.half_length + rmax, rmax], dim=-1)
    cyl = torch.stack([ps.radius, ps.half_length, ps.radius], dim=-1)
    out = torch.where((ps.shape_type == SHAPE_BOX)[:, None], ps.half_extent, cap)
    return torch.where((ps.shape_type == SHAPE_CYLINDER)[:, None], cyl, out)


def world_aabbs(ps: PhysicsState, dt, margin) -> tuple[Tensor, Tensor]:
    rot = math3d.quat_to_mat3(ps.quat)
    center = ps.pos + torch.einsum("bij,bj->bi", rot, ps.offset)
    half = torch.einsum("bij,bj->bi", torch.abs(rot), shape_local_halfbox(ps))
    half = half + margin + torch.abs(ps.linvel) * dt
    return center - half, center + half


def broadphase_mask(ps: PhysicsState, params: PhysicsParams, dt) -> Tensor:
    """(B, B) bool: the pairs a < b the broadphase keeps, before compaction."""
    b = ps.num_slots
    bmin, bmax = world_aabbs(ps, dt, _p(params.speculative_margin, ps.device))
    overlap = torch.all((bmin[:, None, :] <= bmax[None, :, :]) & (bmin[None, :, :] <= bmax[:, None, :]), dim=-1)
    ids = torch.arange(b, device=ps.device)
    dyn = ps.body_type == BODY_DYNAMIC
    mask = overlap & (ids[:, None] < ids[None, :]) & ps.active[:, None] & ps.active[None, :]
    mask = mask & (dyn[:, None] | dyn[None, :])
    # mesh-collider slots only carry material; their geometry is mesh_contacts()'s
    not_mesh = ps.shape_type != SHAPE_MESH
    mask = mask & not_mesh[:, None] & not_mesh[None, :]
    if ps.has_proxies:
        # sub-colliders of one compound never collide with each other or their root
        root = _roots(ps)
        mask = mask & (root[:, None] != root[None, :])
    return mask


def broadphase_pairs(ps: PhysicsState, params: PhysicsParams, dt) -> tuple[Tensor, Tensor, Tensor]:
    """All-pairs AABB overlap → compacted (ia, ib, valid) with capacity
    `max_pairs`, in row-major pair order; pairs past the capacity are dropped."""
    b = ps.num_slots
    p = params.max_pairs
    flat = broadphase_mask(ps, params, dt).reshape(-1)
    fi = flat.to(torch.int64)
    slots = torch.cumsum(fi, 0) - 1
    target = torch.where(flat & (slots < p), slots, torch.full_like(slots, p))  # p: the spare slot
    src = torch.arange(b * b, dtype=torch.int32, device=ps.device)
    pair_flat = torch.zeros(p + 1, dtype=torch.int32, device=ps.device).scatter(0, target, src)[:p]
    count = torch.clamp(fi.sum(), max=p)
    valid = torch.arange(p, device=ps.device) < count
    return pair_flat // b, pair_flat % b, valid


# ---------------------------------------------------------------------------
# Narrowphase
# ---------------------------------------------------------------------------

def _closest_segment_segment(p1, q1, p2, q2, with_params: bool = False):
    """Closest points between segments [p1, q1], [p2, q2]; batched, branch-free."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = torch.sum(d1 * d1, dim=-1)
    e = torch.sum(d2 * d2, dim=-1)
    f = torch.sum(d2 * r, dim=-1)
    c = torch.sum(d1 * r, dim=-1)
    bb = torch.sum(d1 * d2, dim=-1)
    denom = a * e - bb * bb
    # degenerate segment 2 (a sphere): the closest point on segment 1 to p2
    s_point = torch.clamp(-c / torch.clamp(a, min=1e-12), 0.0, 1.0)
    s = torch.where(denom > 1e-12, torch.clamp((bb * f - c * e) / torch.clamp(denom, min=1e-12), 0.0, 1.0), s_point)
    zero = torch.zeros_like(e)
    t = torch.where(e > 1e-12, (bb * s + f) / torch.clamp(e, min=1e-12), zero)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.where(e > 1e-12, torch.clamp((bb * t_cl - c) / torch.clamp(a, min=1e-12), 0.0, 1.0), s)
    s = torch.where(a > 1e-12, s, zero)
    c1 = p1 + d1 * s[..., None]
    c2 = p2 + d2 * t_cl[..., None]
    if with_params:
        return c1, c2, s, t_cl
    return c1, c2


def _capsule_segment(center, rot, half_length):
    e = rot[..., :, 1] * half_length[..., None]  # local Y column
    return center - e, center + e


def _contact_capsule_capsule(ca, ra_rot, hla, rad_a, rad2_a, cb, rb_rot, hlb, rad_b, rad2_b):
    """Swept sphere against swept sphere; tapered capsules use the radius
    interpolated at the closest-point parameter."""
    p1, q1 = _capsule_segment(ca, ra_rot, hla)
    p2, q2 = _capsule_segment(cb, rb_rot, hlb)
    c1, c2, s, t = _closest_segment_segment(p1, q1, p2, q2, with_params=True)
    r_a = rad_a + (rad2_a - rad_a) * s  # segment runs bottom (-Y) → top (+Y)
    r_b = rad_b + (rad2_b - rad_b) * t
    d = c2 - c1
    dist = _norm(d)
    safe = dist > 1e-9  # concentric: push up
    up = torch.tensor([0.0, 1.0, 0.0], dtype=F32, device=ca.device)
    n = torch.where(safe[..., None], d / torch.clamp(dist, min=1e-9)[..., None], up)
    depth = r_a + r_b - dist
    point = (c1 + n * r_a[..., None] + c2 - n * r_b[..., None]) * 0.5
    return n, point, depth


def _point_box_signed(p_local, half):
    """Signed distance of a point to a box in the box frame and the outward
    closest feature: (closest_local, normal_local, depth), depth > 0 inside."""
    clamped = torch.minimum(torch.maximum(p_local, -half), half)
    delta = p_local - clamped
    out_dist = _norm(delta)
    outside = out_dist > 1e-9
    n_out = delta / torch.clamp(out_dist, min=1e-9)[..., None]
    # inside: push out along the axis of least penetration
    face_dist = half - torch.abs(p_local)
    axis = torch.argmin(face_dist, dim=-1)
    sign = torch.sign(torch.gather(p_local, -1, axis[..., None]))[..., 0]
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    n_in = torch.nn.functional.one_hot(axis, 3).to(p_local.dtype) * sign[..., None]
    min_face = torch.amin(face_dist, dim=-1)
    inside_closest = p_local + n_in * min_face[..., None]
    closest = torch.where(outside[..., None], clamped, inside_closest)
    normal = torch.where(outside[..., None], n_out, n_in)
    depth = torch.where(outside, -out_dist, min_face)
    return closest, normal, depth


def _to_local(rot, v):
    """R^T v."""
    return torch.einsum("...ji,...j->...i", rot, v)


def _to_world(rot, v):
    """R v."""
    return torch.einsum("...ij,...j->...i", rot, v)


def _contact_box_capsule(cb_box, rot_box, half, cc, rot_cap, hl, rad, rad2, k_points):
    """Box (a) against capsule / sphere / tapered capsule (b): 3 samples along
    the segment, closest-feature test in the box frame. Normal a→b."""
    p2, q2 = _capsule_segment(cc, rot_cap, hl)
    normals, points, depths = [], [], []
    for t in (0.0, 0.5, 1.0):
        sp = p2 + (q2 - p2) * t
        r_t = rad + (rad2 - rad) * t
        closest_l, n_l, sd = _point_box_signed(_to_local(rot_box, sp - cb_box), half)
        n_w = _to_world(rot_box, n_l)
        surf = cb_box + _to_world(rot_box, closest_l)
        depth = sd + r_t  # sd < 0 outside: depth = rad - dist
        normals.append(n_w)
        points.append((surf + (sp - n_w * r_t[..., None])) * 0.5)
        depths.append(depth)
    n = torch.stack(normals, dim=-2)
    pt = torch.stack(points, dim=-2)
    dp = torch.stack(depths, dim=-1)
    pad = k_points - 3
    if pad > 0:
        n = torch.cat([n, torch.zeros_like(n[..., :pad, :])], dim=-2)
        pt = torch.cat([pt, torch.zeros_like(pt[..., :pad, :])], dim=-2)
        dp = torch.cat([dp, torch.full_like(dp[..., :pad], -1e9)], dim=-1)
    # a sphere needs one sample; drop the duplicate ends
    slot = torch.arange(dp.shape[-1], device=dp.device)
    dup = (hl[..., None] <= 1e-6) & (slot > 0)
    dp = torch.where(dup, torch.full_like(dp, -1e9), dp)
    return n, pt, dp


def _contact_box_cylinder(cb_box, rot_box, half, cc, rot_cyl, hl, rad, k_points):
    """Box (a) against flat-capped cylinder (b), axis local Y: 4 rim points of
    the near cap as zero-radius point-box tests, 2 interior axis samples with
    the cylinder's radius; the deepest k kept."""
    axis = rot_cyl[..., :, 1]
    to_box = cb_box - cc
    cap_sign = torch.sign(torch.sum(to_box * axis, dim=-1))
    cap_sign = torch.where(cap_sign == 0.0, torch.ones_like(cap_sign), cap_sign)
    near_cap = cc + axis * (cap_sign * hl)[..., None]

    d_perp = to_box - torch.sum(to_box * axis, dim=-1, keepdim=True) * axis
    d_len = _norm(d_perp, keepdim=True)
    fallback = rot_cyl[..., :, 0]  # any radial direction when coaxial
    d_hat = torch.where(d_len > 1e-6, d_perp / torch.clamp(d_len, min=1e-6), fallback)
    t_hat = torch.linalg.cross(axis, d_hat)

    candidates = []  # (point, radius): radius 0 for rim points
    for dirn, sgn in ((d_hat, 1.0), (d_hat, -1.0), (t_hat, 1.0), (t_hat, -1.0)):
        candidates.append((near_cap + dirn * (sgn * rad)[..., None], torch.zeros_like(rad)))
    p_bot = cc - axis * hl[..., None]
    p_top = cc + axis * hl[..., None]
    for t in (0.3, 0.7):
        candidates.append((p_bot + (p_top - p_bot) * t, rad))

    normals, points, depths = [], [], []
    for sp, r_s in candidates:
        closest_l, n_l, sd = _point_box_signed(_to_local(rot_box, sp - cb_box), half)
        n_w = _to_world(rot_box, n_l)
        surf = cb_box + _to_world(rot_box, closest_l)
        normals.append(n_w)
        points.append((surf + (sp - n_w * r_s[..., None])) * 0.5)
        depths.append(sd + r_s)
    n = torch.stack(normals, dim=-2)
    pt = torch.stack(points, dim=-2)
    dp = torch.stack(depths, dim=-1)
    top_dp, top_idx = _top_k(dp, k_points)
    return _take(n, top_idx), _take(pt, top_idx), top_dp


_BOX_CORNERS = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]


def _box_corners(device) -> Tensor:
    return torch.tensor(_BOX_CORNERS, dtype=F32, device=device)  # (8, 3)


def _contact_box_box(ca, rot_a, half_a, cb, rot_b, half_b, k_points):
    """Box-box: 15-axis SAT. A face-axis winner gives a corner manifold (the
    deepest corners of each box inside the other); an edge-axis winner one
    contact at the closest points of the two supporting edges."""
    d = cb - ca
    a_cols = rot_a.transpose(-1, -2)  # rows = a's axes
    b_cols = rot_b.transpose(-1, -2)
    cross = torch.linalg.cross(a_cols[..., :, None, :].expand(*a_cols.shape[:-2], 3, 3, 3),
                               b_cols[..., None, :, :].expand(*b_cols.shape[:-2], 3, 3, 3))
    cross = cross.reshape(cross.shape[:-3] + (9, 3))
    cross_len = _norm(cross)
    cross_ok = cross_len > 1e-6
    cross_n = cross / torch.clamp(cross_len, min=1e-6)[..., None]
    axes = torch.cat([a_cols, b_cols, cross_n], dim=-2)  # (P, 15, 3)

    # projection radius of a box onto axis L: Σ_j |(R^T L)_j| h_j
    axes_in_a = torch.einsum("...ni,...ij->...nj", axes, rot_a)
    axes_in_b = torch.einsum("...ni,...ij->...nj", axes, rot_b)
    proj_a = torch.einsum("...nj,...j->...n", torch.abs(axes_in_a), half_a)
    proj_b = torch.einsum("...nj,...j->...n", torch.abs(axes_in_b), half_b)
    dist_on_axis = torch.abs(torch.einsum("...ki,...i->...k", axes, d))
    overlap = proj_a + proj_b - dist_on_axis  # (P, 15)
    # degenerate cross axes can neither separate nor win; edge axes carry a small
    # bias so a face axis wins ties
    edge_slot = torch.arange(15, device=d.device) >= 6
    ok = torch.cat([torch.ones_like(cross_ok[..., :6]), cross_ok], dim=-1)
    inf = torch.full_like(overlap, float("inf"))
    separated = torch.any(torch.where(ok, overlap, inf) < 0.0, dim=-1)
    bias = torch.where(edge_slot, 1e-4, 0.0).to(F32)
    best = torch.argmin(torch.where(ok, overlap + bias, inf), dim=-1)
    best_is_edge = best >= 6
    n = torch.gather(axes, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    n = n * torch.sign(torch.sum(n * d, dim=-1, keepdim=True) + 1e-12)  # orient a→b

    s_a = torch.gather(proj_a, -1, best[..., None])[..., 0]
    s_b = torch.gather(proj_b, -1, best[..., None])[..., 0]

    corners = _box_corners(d.device)
    corners_b = cb[..., None, :] + torch.einsum("...ij,...kj->...ki", rot_b, corners * half_b[..., None, :])
    corners_a = ca[..., None, :] + torch.einsum("...ij,...kj->...ki", rot_a, corners * half_a[..., None, :])

    def corner_inclusion(pts, box_c, box_rot, box_half):
        """Signed distance of corners into the other box (> 0 inside): a
        lateral inclusion filter, not the penetration depth."""
        local = torch.einsum("...ji,...kj->...ki", box_rot, pts - box_c[..., None, :])
        return _point_box_signed(local, box_half[..., None, :])[2]

    inc_b = corner_inclusion(corners_b, ca, rot_a, half_a)
    inc_a = corner_inclusion(corners_a, cb, rot_b, half_b)
    # penetration along the SAT normal against the opposing face's support plane
    dp_b = s_a[..., None] - torch.einsum("...ki,...i->...k", corners_b - ca[..., None, :], n)
    dp_a = s_b[..., None] + torch.einsum("...ki,...i->...k", corners_a - cb[..., None, :], n)
    eps = 1e-3
    dp_b = torch.where(inc_b > -eps, dp_b, torch.full_like(dp_b, -1e9))
    dp_a = torch.where(inc_a > -eps, dp_a, torch.full_like(dp_a, -1e9))
    cand_pts = torch.cat([corners_b, corners_a], dim=-2)  # (P, 16, 3)
    cand_dp = torch.cat([dp_b, dp_a], dim=-1)
    cand_dp = torch.where(separated[..., None], torch.full_like(cand_dp, -1e9), cand_dp)
    top_dp, top_idx = _top_k(cand_dp, k_points)
    top_pts = _take(cand_pts, top_idx)

    # edge-edge contact: closest points of the two supporting edges
    ei = torch.clamp(best - 6, min=0) // 3
    ej = torch.clamp(best - 6, min=0) % 3

    def support_edge(c, cols, half, ax_idx, toward):
        """Edge of the box most along `toward`, directed along axis ax_idx."""
        sgn = torch.sign(torch.einsum("...ki,...i->...k", cols, toward))
        sgn = torch.where(sgn == 0.0, torch.ones_like(sgn), sgn)
        onehot = torch.nn.functional.one_hot(ax_idx, 3).to(c.dtype)
        mid = c + torch.einsum("...k,...ki->...i", sgn * half * (1.0 - onehot), cols)
        h_i = torch.sum(half * onehot, dim=-1)
        dirv = torch.einsum("...k,...ki->...i", onehot, cols)
        return mid - dirv * h_i[..., None], mid + dirv * h_i[..., None]

    pa0, pa1 = support_edge(ca, a_cols, half_a, ei, n)
    pb0, pb1 = support_edge(cb, b_cols, half_b, ej, -n)
    ea_c, eb_c = _closest_segment_segment(pa0, pa1, pb0, pb1)
    edge_pt = (ea_c + eb_c) * 0.5
    edge_dp = torch.gather(overlap, -1, best[..., None])[..., 0]
    edge_dp = torch.where(separated, torch.full_like(edge_dp, -1e9), edge_dp)

    use_edge = (best_is_edge & ~separated)[..., None]
    slot0 = torch.arange(k_points, device=d.device) == 0
    top_dp = torch.where(use_edge, torch.where(slot0, edge_dp[..., None], torch.full_like(top_dp, -1e9)), top_dp)
    top_pts = torch.where(use_edge[..., None], edge_pt[..., None, :], top_pts)
    return n[..., None, :].expand(top_pts.shape), top_pts, top_dp


def mesh_contacts(ps: PhysicsState, params: PhysicsParams):
    """Per-body contacts against the static triangle-mesh world: one XZ-grid
    bucket gather per body, then sample-vs-triangle-plane tests (boxes by
    their 8 corners, round shapes by 3 segment samples with the local radius).
    Returns (normal, point, depth, valid, c_ia, c_ib) flattened to (B·k,)."""
    k = params.points_per_pair
    b = ps.num_slots
    dev = ps.device
    tri = ps.mesh_tri
    grid = ps.mesh_grid
    meta = ps.mesh_grid_meta
    k_tri = grid.shape[1]

    rot = math3d.quat_to_mat3(ps.quat)
    center = ps.pos + torch.einsum("bij,bj->bi", rot, ps.offset)
    corners = torch.einsum("bij,bsj->bsi", rot, _box_corners(dev)[None] * ps.half_extent[:, None, :]) + center[:, None, :]
    p1, q1 = _capsule_segment(center, rot, ps.half_length)
    ts = torch.tensor([0.0, 0.5, 1.0], dtype=F32, device=dev)
    seg = p1[:, None, :] + (q1 - p1)[:, None, :] * ts[None, :, None]
    rad2 = torch.where(ps.radius2 > 0.0, ps.radius2, ps.radius)
    seg_r = ps.radius[:, None] + (rad2 - ps.radius)[:, None] * ts[None, :]
    is_box = (ps.shape_type == SHAPE_BOX)[:, None]
    samples = torch.where(is_box[..., None], corners, torch.cat([seg, seg[:, :1].expand(b, 5, 3)], dim=1))
    radii = torch.where(is_box, torch.zeros((b, 8), dtype=F32, device=dev),
                        torch.cat([seg_r, torch.full((b, 5), -1e9, dtype=F32, device=dev)], dim=1))
    s_n = samples.shape[1]

    # candidate triangles from the body's XZ grid cell
    ox, oz, cell, gxf, gzf = meta[0], meta[1], meta[2], meta[3], meta[4]
    cx = torch.minimum(torch.clamp(torch.floor((center[:, 0] - ox) / cell), min=0.0), gxf - 1.0).to(torch.int32)
    cz = torch.minimum(torch.clamp(torch.floor((center[:, 2] - oz) / cell), min=0.0), gzf - 1.0).to(torch.int32)
    tids = grid[(cz * gxf.to(torch.int32) + cx).long()]
    t_ok = tids >= 0
    tv = tri[torch.clamp(tids, min=0).long()]
    va, vb, vc = tv[:, :, 0], tv[:, :, 1], tv[:, :, 2]
    nrm = torch.linalg.cross(vb - va, vc - va)
    n_t = nrm / torch.clamp(_norm(nrm, keepdim=True), min=1e-9)

    rel = samples[:, None, :, :] - va[:, :, None, :]
    d = torch.sum(rel * n_t[:, :, None, :], dim=-1)  # (B, K_tri, S)
    proj = samples[:, None, :, :] - d[..., None] * n_t[:, :, None, :]
    # lateral tolerance: admit contacts near an edge, or a seam between two
    # faces becomes a crack bodies fall through
    tol = radii[:, None, :] * 0.5 + 0.03 + torch.abs(d) * 0.35

    def edge_ok(v0, v1):
        ev = v1 - v0
        inv_len = 1.0 / torch.clamp(_norm(ev, keepdim=True), min=1e-9)
        pv = proj - v0[:, :, None, :]
        lat = torch.sum(torch.linalg.cross(ev[:, :, None, :].expand_as(pv), pv) * n_t[:, :, None, :], dim=-1)
        return lat * inv_len >= -tol

    inside = edge_ok(va, vb) & edge_ok(vb, vc) & edge_ok(vc, va)
    depth = radii[:, None, :] - d
    max_pen = 0.35  # don't grab geometry far below the surface
    valid = inside & t_ok[..., None] & (depth > -_p(params.speculative_margin, dev)) & (depth < max_pen)
    depth_m = torch.where(valid, depth, torch.full_like(depth, -1e9))

    top_dp, top_i = _top_k(depth_m.reshape(b, k_tri * s_n), k)
    top_pt = _take(proj.reshape(b, k_tri * s_n, 3), top_i)
    top_n = _take(n_t[:, :, None, :].expand(b, k_tri, s_n, 3).reshape(b, k_tri * s_n, 3), top_i)

    dyn = (ps.body_type == BODY_DYNAMIC) & ps.active
    c_valid = (top_dp > -1e8) & dyn[:, None]
    c_ia = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(k)
    c_ib = ps.mesh_body.to(torch.int32).expand(b * k).clone()
    # normal convention a→b (body→mesh) = -triangle normal
    return (-top_n).reshape(b * k, 3), top_pt.reshape(b * k, 3), top_dp.reshape(b * k), c_valid.reshape(b * k), c_ia, c_ib


def narrowphase(ps: PhysicsState, params: PhysicsParams, ia: Tensor, ib: Tensor, pair_valid: Tensor):
    """Contact generation for the compacted pairs. Returns per-contact-point
    tensors flattened to (P·K,): normal (a→b), point, depth, valid, c_ia, c_ib,
    and per pair `touching`."""
    k = params.points_per_pair
    rot = math3d.quat_to_mat3(ps.quat)
    center = ps.pos + torch.einsum("bij,bj->bi", rot, ps.offset)
    ia_l, ib_l = ia.long(), ib.long()
    ca, cb = center[ia_l], center[ib_l]
    ra, rb = rot[ia_l], rot[ib_l]
    ha, hb = ps.half_extent[ia_l], ps.half_extent[ib_l]
    rad_a, rad_b = ps.radius[ia_l], ps.radius[ib_l]
    hla, hlb = ps.half_length[ia_l], ps.half_length[ib_l]
    ta, tb = ps.shape_type[ia_l], ps.shape_type[ib_l]
    p = ia.shape[0]
    # radius2 == 0 means "uniform" (state filled outside build.py)
    rad2 = torch.where(ps.radius2 > 0.0, ps.radius2, ps.radius)
    rad2_a, rad2_b = rad2[ia_l], rad2[ib_l]

    # round-round (cylinders degrade to capsules here; box-cylinder is exact below)
    n_cc, pt_cc, dp_cc = _contact_capsule_capsule(ca, ra, hla, rad_a, rad2_a, cb, rb, hlb, rad_b, rad2_b)
    n_cc = n_cc[:, None, :].expand(p, k, 3)
    pt_cc = pt_cc[:, None, :].expand(p, k, 3)
    dp_cc = torch.cat([dp_cc[:, None], torch.full((p, k - 1), -1e9, dtype=F32, device=ps.device)], dim=-1)

    n_bc, pt_bc, dp_bc = _contact_box_capsule(ca, ra, ha, cb, rb, hlb, rad_b, rad2_b, k)
    n_cb, pt_cb, dp_cb = _contact_box_capsule(cb, rb, hb, ca, ra, hla, rad_a, rad2_a, k)
    n_cb = -n_cb  # normal a→b
    n_bcy, pt_bcy, dp_bcy = _contact_box_cylinder(ca, ra, ha, cb, rb, hlb, rad_b, k)
    n_cyb, pt_cyb, dp_cyb = _contact_box_cylinder(cb, rb, hb, ca, ra, hla, rad_a, k)
    n_cyb = -n_cyb
    n_bb, pt_bb, dp_bb = _contact_box_box(ca, ra, ha, cb, rb, hb, k)

    a_box = (ta == SHAPE_BOX)[:, None]
    b_box = (tb == SHAPE_BOX)[:, None]
    a_cyl = (ta == SHAPE_CYLINDER)[:, None]
    b_cyl = (tb == SHAPE_CYLINDER)[:, None]

    def sel(cc, bc, cb_, bb, bcy, cyb):
        def w(mask, val, out):
            return torch.where(mask[..., None] if cc.dim() == 3 else mask, val, out)

        out = w((~a_box) & (~b_box), cc, bb)  # round/cylinder vs round/cylinder
        out = w(a_box & (~b_box), bc, out)    # box vs round
        out = w((~a_box) & b_box, cb_, out)   # round vs box
        out = w(a_box & b_cyl, bcy, out)      # box vs cylinder (exact caps)
        return w(a_cyl & b_box, cyb, out)     # cylinder vs box

    normal = sel(n_cc, n_bc, n_cb, n_bb, n_bcy, n_cyb)
    point = sel(pt_cc, pt_bc, pt_cb, pt_bb, pt_bcy, pt_cyb)
    depth = sel(dp_cc, dp_bc, dp_cb, dp_bb, dp_bcy, dp_cyb)

    sa, sb = ps.is_sensor[ia_l], ps.is_sensor[ib_l]
    valid = (depth > -_p(params.speculative_margin, ps.device)) & pair_valid[:, None] & ~(sa | sb)[:, None]
    touching = torch.any((depth > 0.0) & pair_valid[:, None] & ~(sa & sb)[:, None], dim=-1)
    return (
        normal.reshape(p * k, 3),
        point.reshape(p * k, 3),
        depth.reshape(p * k),
        valid.reshape(p * k),
        ia.repeat_interleave(k),
        ib.repeat_interleave(k),
        touching,
    )


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

def make_segment_reducer(idx: Tensor, num_segments: int):
    """Sort-based segmented sum (the JAX package's scatter-free reduction):
    the rows are sorted by segment once, and each reduction is a gather, a
    cumulative sum and the differences at the segment bounds. Returns
    reduce(values (C, …)) → (num_segments, …)."""
    sorted_idx, order = torch.sort(idx, stable=True)
    seg_ids = torch.arange(num_segments, dtype=sorted_idx.dtype, device=idx.device)
    ends = torch.searchsorted(sorted_idx, seg_ids, right=True)
    starts = torch.searchsorted(sorted_idx, seg_ids, right=False)

    def reduce(values: Tensor) -> Tensor:
        csum = torch.cumsum(values[order], dim=0)
        csum = torch.cat([torch.zeros_like(csum[:1]), csum], dim=0)
        return csum[ends] - csum[starts]

    return reduce


def _world_inv_inertia(ps: PhysicsState) -> Tensor:
    rot = math3d.quat_to_mat3(ps.quat)
    return torch.einsum("bij,bj,bkj->bik", rot, ps.inv_inertia, rot)


def solve_velocity(
    ps: PhysicsState,
    params: PhysicsParams,
    dt,
    normal: Tensor,
    point: Tensor,
    depth: Tensor,
    valid: Tensor,
    c_ia: Tensor,
    c_ib: Tensor,
) -> tuple[Tensor, Tensor]:
    """Mass-splitting projected-Jacobi impulse solver with warm-started
    accumulated impulses. Returns (linvel, angvel). Either `comm` value
    computes this same function: per-pair body velocities are gathered, pair
    impulses summed into bodies with `index_add_`, invalid pairs aimed at a
    spare row that is dropped."""
    b = ps.num_slots
    k = params.points_per_pair
    dev = ps.device
    p_pairs = c_ia.shape[0] // k
    inv_iw = _world_inv_inertia(ps)

    normal = normal.reshape(p_pairs, k, 3)
    point = point.reshape(p_pairs, k, 3)
    depth = depth.reshape(p_pairs, k)
    valid = valid.reshape(p_pairs, k)
    ia = c_ia.reshape(p_pairs, k)[:, 0].long()
    ib = c_ib.reshape(p_pairs, k)[:, 0].long()
    if ps.has_proxies:
        # contacts on sub-collider proxies resolve against the compound root
        root = _roots(ps)
        ia, ib = root[ia], root[ib]
    pair_valid = torch.any(valid, dim=1)
    validf = valid.to(F32)
    ia_safe = torch.where(pair_valid, ia, b)  # b: the spare row, dropped
    ib_safe = torch.where(pair_valid, ib, b)

    def reduce_sides(vals_a: Tensor, vals_b: Tensor) -> Tensor:
        """(P, F) per side → (B, F): Σ_b vals_b − Σ_a vals_a."""
        out = torch.zeros((b + 1, vals_a.shape[-1]), dtype=vals_a.dtype, device=dev)
        out.index_add_(0, ib_safe, vals_b)
        out.index_add_(0, ia_safe, -vals_a)
        return out[:b]

    def gather_vel6(v6: Tensor):
        return v6[ia], v6[ib]

    point_count = torch.sum(validf, dim=1)
    cnt = torch.zeros(b + 1, dtype=F32, device=dev).index_add_(0, ia_safe, point_count)[:b]
    cnt = cnt + torch.zeros(b + 1, dtype=F32, device=dev).index_add_(0, ib_safe, point_count)[:b]
    split = torch.clamp(cnt, min=1.0)

    im_a = (ps.inv_mass * split)[ia][:, None]
    im_b = (ps.inv_mass * split)[ib][:, None]
    ii_a = (inv_iw * split[:, None, None])[ia]
    ii_b = (inv_iw * split[:, None, None])[ib]
    r_a = point - ps.pos[ia][:, None, :]
    r_b = point - ps.pos[ib][:, None, :]

    def k_along(dirn: Tensor) -> Tensor:  # (P, K, 3) → (P, K)
        rxn_a = torch.linalg.cross(r_a, dirn)
        rxn_b = torch.linalg.cross(r_b, dirn)
        ang_a = torch.sum(torch.einsum("pij,pkj->pki", ii_a, rxn_a) * rxn_a, dim=-1)
        ang_b = torch.sum(torch.einsum("pij,pkj->pki", ii_b, rxn_b) * rxn_b, dim=-1)
        return im_a + im_b + ang_a + ang_b

    kn = torch.clamp(k_along(normal), min=1e-9)
    # tangent basis per point
    up = torch.abs(normal[..., 1:2]) < 0.9
    ref = torch.where(up, torch.tensor([0.0, 1.0, 0.0], device=dev), torch.tensor([1.0, 0.0, 0.0], device=dev))
    t1 = torch.linalg.cross(normal, ref.expand_as(normal))
    t1 = t1 / torch.clamp(_norm(t1, keepdim=True), min=1e-9)
    t2 = torch.linalg.cross(normal, t1)
    kt1 = torch.clamp(k_along(t1), min=1e-9)
    kt2 = torch.clamp(k_along(t2), min=1e-9)

    # combine rules (Jolt defaults): restitution max, friction geometric mean
    e = torch.maximum(ps.restitution[ia], ps.restitution[ib])[:, None]
    mu = torch.sqrt(ps.friction[ia] * ps.friction[ib])[:, None]

    def rel_vel(va6: Tensor, vb6: Tensor) -> Tensor:  # (P, 6) each → (P, K, 3)
        va = va6[:, None, :3] + torch.linalg.cross(va6[:, None, 3:].expand_as(r_a), r_a)
        vb = vb6[:, None, :3] + torch.linalg.cross(vb6[:, None, 3:].expand_as(r_b), r_b)
        return vb - va

    v6 = torch.cat([ps.linvel, ps.angvel], dim=-1)
    va6_0, vb6_0 = gather_vel6(v6)
    vn0 = torch.sum(rel_vel(va6_0, vb6_0) * normal, dim=-1)
    zero = torch.zeros_like(depth)
    bounce = torch.where(vn0 < -_p(params.restitution_threshold, dev), -e * vn0, zero)
    bias = (_p(params.baumgarte, dev) / dt) * torch.clamp(depth - _p(params.penetration_slop, dev), min=0.0)
    target = torch.maximum(bounce, bias)

    dof6 = torch.cat([ps.dof_mask_lin, ps.dof_mask_ang], dim=-1)
    acc_n, acc_t1, acc_t2 = zero, zero, zero
    for _ in range(params.velocity_iterations):
        va6, vb6 = gather_vel6(v6)
        vrel = rel_vel(va6, vb6)
        vn = torch.sum(vrel * normal, dim=-1)
        dl = -(vn - target) / kn
        new_acc = torch.clamp(acc_n + dl, min=0.0)
        dl = torch.where(valid, new_acc - acc_n, zero)
        acc_n = torch.where(valid, new_acc, acc_n)

        vt1 = torch.sum(vrel * t1, dim=-1)
        vt2 = torch.sum(vrel * t2, dim=-1)
        max_f = mu * acc_n
        new_t1 = torch.minimum(torch.maximum(acc_t1 - vt1 / kt1, -max_f), max_f)
        new_t2 = torch.minimum(torch.maximum(acc_t2 - vt2 / kt2, -max_f), max_f)
        dt1 = torch.where(valid, new_t1 - acc_t1, zero)
        dt2 = torch.where(valid, new_t2 - acc_t2, zero)
        acc_t1 = torch.where(valid, new_t1, acc_t1)
        acc_t2 = torch.where(valid, new_t2, acc_t2)

        j = normal * dl[..., None] + t1 * dt1[..., None] + t2 * dt2[..., None]
        j_pair = torch.sum(j, dim=1)  # net impulse on b
        tq_a = torch.sum(torch.linalg.cross(r_a, j), dim=1)
        tq_b = torch.sum(torch.linalg.cross(r_b, j), dim=1)
        d6 = reduce_sides(torch.cat([j_pair, tq_a], dim=-1), torch.cat([j_pair, tq_b], dim=-1))
        dlv = d6[:, :3] * ps.inv_mass[:, None]
        dav = torch.einsum("bij,bj->bi", inv_iw, d6[:, 3:])
        v6 = v6 + torch.cat([dlv, dav], dim=-1) * dof6
    return v6[:, :3], v6[:, 3:]


# ---------------------------------------------------------------------------
# Full substep
# ---------------------------------------------------------------------------

def physics_substep(ps: PhysicsState, params: PhysicsParams, dt: float) -> PhysicsState:
    """Advance all bodies by one fixed timestep `dt` (the 1/60 s tick of
    `Scene.cpp:720-729`)."""
    dev = ps.device
    b_slots = ps.num_slots
    if ps.has_proxies:
        # sub-collider proxies track their compound root's pose and velocity
        root = _roots(ps)
        ps = dataclasses.replace(
            ps, pos=ps.pos[root], quat=ps.quat[root], linvel=ps.linvel[root], angvel=ps.angvel[root],
            prev_pos=ps.prev_pos[root], prev_quat=ps.prev_quat[root],
        )

    dyn = (ps.body_type == BODY_DYNAMIC) & ps.active
    # sleeping bodies are frozen this substep: no gravity, infinite mass in
    # contacts, no integration
    awake = ~ps.asleep
    dyn_awake = dyn & awake
    dynf = dyn_awake.to(F32)[:, None]
    prev_pos, prev_quat = ps.pos, ps.quat

    # forces: gravity and drag (v *= max(0, 1 - c·dt)), dynamic bodies only
    gravity = _p(params.gravity, dev)
    lv = ps.linvel + gravity[None, :] * (ps.gravity_factor[:, None] * dt) * dynf
    one = torch.ones((), dtype=F32, device=dev)
    drag_l = torch.where(dyn[:, None], torch.clamp(1.0 - ps.linear_drag[:, None] * dt, min=0.0), one)
    drag_a = torch.where(dyn[:, None], torch.clamp(1.0 - ps.angular_drag[:, None] * dt, min=0.0), one)
    lv = lv * drag_l
    av = ps.angvel * drag_a
    lv = torch.where(dyn[:, None], lv * ps.dof_mask_lin, lv)
    av = torch.where(dyn[:, None], av * ps.dof_mask_ang, av)
    static = ((ps.body_type == BODY_STATIC) | ~ps.active)[:, None]
    lv = torch.where(static, torch.zeros_like(lv), lv)
    av = torch.where(static, torch.zeros_like(av), av)
    ps = dataclasses.replace(ps, linvel=lv, angvel=av)

    # collide
    ia, ib, pair_valid = broadphase_pairs(ps, params, dt)
    normal, point, depth, valid, c_ia, c_ib, _ = narrowphase(ps, params, ia, ib, pair_valid)
    if ps.mesh_tri is not None:
        # static mesh-collider contacts join the same stream
        mn, mp, md, mv, mia, mib = mesh_contacts(ps, params)
        normal = torch.cat([normal, mn])
        point = torch.cat([point, mp])
        depth = torch.cat([depth, md])
        valid = torch.cat([valid, mv])
        c_ia = torch.cat([c_ia, mia])
        c_ib = torch.cat([c_ib, mib])

    # grounding (character controllers): per-body max support-normal y; normal
    # points a→b, so b's support normal is +n, a's is -n
    touching = valid & (depth > -_p(params.penetration_slop, dev))
    c_ia_g, c_ib_g = c_ia.long(), c_ib.long()
    if ps.has_proxies:  # grounding aggregates onto compound roots
        root = _roots(ps)
        c_ia_g, c_ib_g = root[c_ia_g], root[c_ib_g]
    ia_safe = torch.where(touching, c_ia_g, b_slots)
    ib_safe = torch.where(touching, c_ib_g, b_slots)
    ny = normal[:, 1]
    neg1 = torch.full_like(ny, -1.0)
    gy = _scatter_drop(b_slots, ib_safe, torch.where(touching, ny, neg1), "amax", -1.0)
    gy = torch.maximum(gy, _scatter_drop(b_slots, ia_safe, torch.where(touching, -ny, neg1), "amax", -1.0))
    ps = dataclasses.replace(ps, ground_normal_y=gy)

    # solve (sleeping bodies take part as infinite-mass obstacles)
    ps_solve = ps
    if params.allow_sleeping:
        ps_solve = dataclasses.replace(
            ps,
            inv_mass=torch.where(awake, ps.inv_mass, torch.zeros_like(ps.inv_mass)),
            inv_inertia=torch.where(awake[:, None], ps.inv_inertia, torch.zeros_like(ps.inv_inertia)),
        )
    lv, av = solve_velocity(ps_solve, params, dt, normal, point, depth, valid, c_ia, c_ib)
    lv = torch.where(dyn_awake[:, None], lv, ps.linvel)
    av = torch.where(dyn_awake[:, None], av, ps.angvel)

    # integrate positions (kinematic bodies move by their velocity too)
    kin_or_dyn = (ps.active & (ps.body_type != BODY_STATIC) & awake)[:, None]
    new_pos = torch.where(kin_or_dyn, ps.pos + lv * dt, ps.pos)
    new_quat = torch.where(kin_or_dyn, math3d.quat_integrate(ps.quat, av, dt), ps.quat)

    # gyroscopic term: conserve angular momentum L = I_w(q)·ω through the
    # rotation update, with one midpoint fixed-point pass
    gyro = (ps.apply_gyro & dyn_awake & torch.all(ps.inv_inertia > 0.0, dim=-1))[:, None]
    r_old = math3d.quat_to_mat3(ps.quat)
    inertia_body = 1.0 / torch.clamp(ps.inv_inertia, min=1e-12)
    l_world = torch.einsum("bij,bj->bi", r_old, inertia_body * torch.einsum("bji,bj->bi", r_old, av))

    def omega_from_l(q):
        r = math3d.quat_to_mat3(q)
        return torch.einsum("bij,bj->bi", r, ps.inv_inertia * torch.einsum("bji,bj->bi", r, l_world))

    av_end = omega_from_l(new_quat)
    q_mid = math3d.quat_integrate(ps.quat, 0.5 * (av + av_end), dt)
    new_quat = torch.where(gyro, q_mid, new_quat)
    av = torch.where(gyro, omega_from_l(q_mid), av)

    # sleeping (Jolt PhysicsSettings thresholds)
    asleep, sleep_timer = ps.asleep, ps.sleep_timer
    if params.allow_sleeping:
        r_eff = torch.maximum(torch.amax(ps.half_extent, dim=1), ps.radius + ps.half_length)
        speed2 = torch.sum(lv * lv, dim=-1) + r_eff * r_eff * torch.sum(av * av, dim=-1)
        sv = _p(params.sleep_velocity, dev)
        moving = speed2 >= sv * sv
        # wake propagation: only an awake moving dynamic partner wakes a body
        pusher = dyn_awake & moving
        other_a = (touching & pusher[c_ia_g]).to(torch.int32)
        other_b = (touching & pusher[c_ib_g]).to(torch.int32)
        wake = _scatter_drop(b_slots, ib_safe, other_a, "amax", 0)
        wake = torch.maximum(wake, _scatter_drop(b_slots, ia_safe, other_b, "amax", 0)) > 0
        eligible = ~moving & dyn & ~ps.is_character
        sleep_timer = torch.where(eligible & ~wake, ps.sleep_timer + dt, torch.zeros_like(ps.sleep_timer))
        fall_asleep = eligible & ~wake & (sleep_timer >= _p(params.sleep_time, dev))
        asleep = (ps.asleep & ~wake) | fall_asleep
        # deactivated bodies carry exactly zero velocity
        lv = torch.where(asleep[:, None], torch.zeros_like(lv), lv)
        av = torch.where(asleep[:, None], torch.zeros_like(av), av)

    return dataclasses.replace(
        ps, pos=new_pos, quat=new_quat, linvel=lv, angvel=av, prev_pos=prev_pos, prev_quat=prev_quat,
        asleep=asleep, sleep_timer=sleep_timer,
    )
