"""Triangle setup + tile binning for the visbuffer raster (counterpart of
`oxylus_tpu/ops/setup3d.py`).

For every visible meshlet the 64 triangle slots are processed densely: gather
the prebaked vertex pack, transform to clip space, reject backfacing and
behind-the-eye triangles, and emit the homogeneous (Olano–Greer) edge and depth
plane coefficients the raster evaluates per pixel, the perspective attribute
planes, and per-triangle screen bounds. Then per-tile triangle shortlists for
the tile raster (`bin_triangles_per_tile`), built from per-tile meshlet lists.
Entry order and counts must equal the JAX package's: the vid encodes the entry.

The group raster (`RenderSpec(raster_path="group")`) rasters dense triangle
groups instead: `compact_triangles` re-groups a pass's surviving triangles, or
`passthrough_groups` keeps the source meshlets as the groups; either is binned
per tile by `bin_meshlets_to_tiles` on its group bounds.

Visbuffer id packing: (visible-meshlet slot << 8) | local triangle.
"""

from __future__ import annotations

import torch

from ..utils import math3d

Tensor = torch.Tensor

TRIS_PER_MESHLET = 64
VERTS_PER_MESHLET = 64


def _dot4_pairwise(m: Tensor, v: Tensor) -> Tensor:
    """Σ_k m[..., k]·v[..., k] over k < 4 as (p0 + p1) + (p2 + p3): the rounding
    of XLA's CPU batched matmul for these contractions."""
    p = m * v
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def _cross3(a: Tensor, b: Tensor) -> Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def setup_triangles(
    gscene,
    entity_world: Tensor,   # (N, 4, 4)
    vm_instance: Tensor,    # (VM,) visible meshlet-instance → instance index
    vm_meshlet: Tensor,     # (VM,) global meshlet index
    vm_valid: Tensor,       # (VM,)
    view_proj: Tensor,      # (4, 4)
    width: int,
    height: int,
    backface_enabled: bool = True,
    near_w: float = 0.05,
) -> dict:
    """Per-meshlet per-triangle raster data: coeffs (VM, 64, 5, 3), attr_planes
    (VM, 64, 9, 3), tri_valid (VM, 64), packed_id, per-meshlet and per-triangle
    screen bounds, and screen xyz; for the decode path (`ops/decode3d.py`) the
    clip-space vertices clip (VM, 64, 3, 4), the vertex pack packed_verts
    (VM, 64, 3, 8), slots_per_tri (1: no near-plane clipping) and tri_of_slot
    (VM, 64), each slot's triangle."""
    vm = vm_meshlet.shape[0]
    dev = vm_meshlet.device
    ml = vm_meshlet.long()
    tri_slots = torch.arange(TRIS_PER_MESHLET, dtype=torch.int32, device=dev)[None, :]
    tri_in_range = tri_slots < gscene.ml_tri_count[ml][:, None]

    packed = gscene.ml_packed_verts[ml].reshape(vm, 64, 3, 8)  # pos | nrm | uv
    pos = packed[..., 0:3]
    nrm_v = packed[..., 3:6]
    uv_v = packed[..., 6:8]

    world = entity_world[gscene.inst_entity[vm_instance.long()].long()]  # (VM,4,4)
    mvp = _dot4_pairwise(view_proj[None, :, None, :], world.transpose(1, 2)[:, None, :, :])  # (VM,4,4)
    pos_h = torch.cat([pos, torch.ones_like(pos[..., :1])], dim=-1)  # (VM,64,3,4)
    clip = _dot4_pairwise(mvp[:, None, None, :, :], pos_h[..., None, :])  # (VM,64,3,4)

    # world normal + uv + per-triangle tangent, interpolated by the raster
    rot = world[:, None, None, :3, :3]
    wnrm_v = math3d.dot_fma(rot, nrm_v[..., None, :])
    wpos_v = math3d.dot_fma(rot, pos[..., None, :]) + world[:, None, None, :3, 3]
    e1w = wpos_v[..., 1, :] - wpos_v[..., 0, :]
    e2w = wpos_v[..., 2, :] - wpos_v[..., 0, :]
    duv1 = uv_v[..., 1, :] - uv_v[..., 0, :]
    duv2 = uv_v[..., 2, :] - uv_v[..., 0, :]
    detuv = duv1[..., 0] * duv2[..., 1] - duv2[..., 0] * duv1[..., 1]
    t_raw = e1w * duv2[..., 1:2] - e2w * duv1[..., 1:2]  # ∝ detuv · T
    b_raw = e2w * duv1[..., 0:1] - e1w * duv2[..., 0:1]  # ∝ detuv · B
    one = torch.ones((), dtype=torch.float32, device=dev)
    sgn = torch.where(detuv < 0.0, -one, one)[..., None]
    t_len = math3d._norm(t_raw)
    t_hat = sgn * t_raw / torch.clamp(t_len, min=1e-20)
    ng = torch.linalg.cross(e1w, e2w)
    hand = torch.sum(torch.linalg.cross(ng, t_hat) * (b_raw * sgn), dim=-1, keepdim=True)
    w_hand = torch.where(hand < 0.0, -one, one)
    tan_ok = (torch.abs(detuv)[..., None] > 1e-12) & (t_len > 1e-9)
    t_enc = torch.where(tan_ok, t_hat * (0.75 + 0.25 * w_hand), 0.0)  # (VM,64,3)
    attrs = torch.cat([wnrm_v, uv_v, t_enc[..., None, :].expand(wnrm_v.shape)], dim=-1)  # (VM,64,3,8)

    # ---- homogeneous triangle setup (no near-plane clipping) ----------------
    x_c, y_c, z_c, w_c = clip.unbind(-1)  # (VM, 64, 3)
    xp = (x_c * 0.5 + 0.5 * w_c) * width
    yp = (y_c * 0.5 + 0.5 * w_c) * height
    v = torch.stack([xp, yp, w_c], dim=-1)  # (VM, 64, 3 verts, 3)
    v0, v1, v2 = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    e0 = _cross3(v1, v2)
    e1 = _cross3(v2, v0)
    e2 = _cross3(v0, v1)
    det = math3d.dot_fma(e0, v0)  # det < 0 ⇔ front (CCW)

    front = det < 0.0
    keep_winding = front if backface_enabled else torch.abs(det) > 1e-20
    tri_valid = tri_in_range & keep_winding & (torch.abs(det) > 1e-20) & vm_valid[:, None]
    all_behind = torch.all(w_c < near_w, dim=-1)
    tri_valid = tri_valid & ~all_behind

    maxc = torch.maximum(
        torch.max(torch.abs(e0), dim=-1).values,
        torch.maximum(torch.max(torch.abs(e1), dim=-1).values, torch.max(torch.abs(e2), dim=-1).values),
    )
    s = torch.where(det < 0.0, -one, one) / torch.clamp(maxc, min=1e-30)
    e0 = e0 * s[..., None]
    e1 = e1 * s[..., None]
    e2 = e2 * s[..., None]

    # zn = Σ zᵢ·eᵢ, wd = Σ wᵢ·eᵢ, ss = Σ eᵢ: depth zn/wd, attributes (Σ aᵢ·eᵢ)/ss
    zn = e0 * z_c[..., 0, None] + e1 * z_c[..., 1, None] + e2 * z_c[..., 2, None]
    wd = e0 * w_c[..., 0, None] + e1 * w_c[..., 1, None] + e2 * w_c[..., 2, None]
    ss = e0 + e1 + e2

    coeffs = torch.stack([e0, e1, e2, zn, wd], dim=-2)  # (VM, 64, 5, 3)
    coeffs = torch.where(tri_valid[..., None, None], coeffs, 0.0)
    coeffs[..., 0, 2] = torch.where(tri_valid, coeffs[..., 0, 2], -1e30)  # e0 ≡ -1e30 never covers

    attr_planes = (
        attrs[..., 0, :, None] * e0[..., None, :]
        + attrs[..., 1, :, None] * e1[..., None, :]
        + attrs[..., 2, :, None] * e2[..., None, :]
    )  # (VM, 64, 8attr, 3coeff)
    attr_planes = torch.cat([ss[..., None, :], attr_planes], dim=-2)
    attr_planes = torch.where(tri_valid[..., None, None], attr_planes, 0.0)

    vm_slot = torch.arange(vm, dtype=torch.int32, device=dev)[:, None]
    packed_id = (vm_slot << 8) | tri_slots

    # screen bounds for binning: a vertex near/behind w = 0 projects unboundedly
    # → bin the triangle to the whole screen
    safe = w_c > near_w
    all_safe = torch.all(safe, dim=-1)
    wsafe = torch.where(safe, w_c, 1.0)
    sx = torch.where(safe, (x_c / wsafe * 0.5 + 0.5) * width, 0.0)
    sy = torch.where(safe, (y_c / wsafe * 0.5 + 0.5) * height, 0.0)
    sz = torch.where(safe, z_c / wsafe, 1.0)

    big = 1e9
    txmin = torch.where(tri_valid, torch.where(all_safe, sx.min(-1).values, 0.0), big)
    txmax = torch.where(tri_valid, torch.where(all_safe, sx.max(-1).values, float(width)), -big)
    tymin = torch.where(tri_valid, torch.where(all_safe, sy.min(-1).values, 0.0), big)
    tymax = torch.where(tri_valid, torch.where(all_safe, sy.max(-1).values, float(height)), -big)
    return {
        "coeffs": coeffs,
        "attr_planes": attr_planes,
        "tri_valid": tri_valid,
        "packed_id": packed_id,
        "slots_per_tri": 1,
        "tri_of_slot": tri_slots.expand(vm, TRIS_PER_MESHLET),
        "ml_xmin": txmin.min(-1).values,
        "ml_xmax": txmax.max(-1).values,
        "ml_ymin": tymin.min(-1).values,
        "ml_ymax": tymax.max(-1).values,
        "tri_xmin": txmin,
        "tri_xmax": txmax,
        "tri_ymin": tymin,
        "tri_ymax": tymax,
        "clip": clip,
        "packed_verts": packed,
        "sxyz": torch.stack([sx, sy, sz], dim=-1),
    }


def compact_triangles(
    setup: dict,
    tri_mask: Tensor,       # (VM, R) triangles to keep (validity ∧ pass visibility)
    slot_material: Tensor,  # (VM,) material index per source meshlet
    slot_instance: Tensor,  # (VM,) instance index per source meshlet
    group: int = 64,        # triangles per dense raster group
    width: float = 1920.0,
    height: float = 1080.0,
) -> dict:
    """Re-group a pass's surviving triangles into dense raster groups of
    `group` slots (the reference's `cull_triangles` compaction).

    Source meshlets are ordered by (coarse depth bucket, 6-bit screen morton
    code of their clamped bounds' centre), meshlets without a surviving
    triangle last; their surviving triangles are packed in that order, and
    every per-triangle field rides one combined row gather (integers as
    float32, exact below 2^24). The sort is stable: meshlets with equal keys
    keep their cull order. The JAX package sorts without asking for
    stability (`tests/test_torch_raster_groups.py` checks what its CPU sort
    gives).

    Returns coeffs (G, group, 5, 3) (unused slots: zeros and an e0 constant of
    -1e30, never covering), attr_planes (G, group, 9, 3), tri_valid, the
    groups' screen bounds ml_xmin/xmax/ymin/ymax and nearest depth ml_near,
    slot_material / slot_instance / packed_id per dense slot (0, 0, -1 where
    unused), slot_rows (None: the renderer reads the material rows through
    `slot_material`, so the JAX function's `mat_rows` is not taken), count
    (surviving triangles, 0-d int32), and, beyond the JAX dict, tri_z (G,
    group): each slot's nearest depth (-1 where unused), the column
    `raster3d.build_tile_comb` reads."""
    dev = tri_mask.device
    vm, r = tri_mask.shape
    n = vm * r
    n_groups = n // group
    xmin = torch.clamp(setup["tri_xmin"], 0.0, width)
    xmax = torch.clamp(setup["tri_xmax"], -1.0, width)
    ymin = torch.clamp(setup["tri_ymin"], 0.0, height)
    ymax = torch.clamp(setup["tri_ymax"], -1.0, height)
    tz = setup["sxyz"][..., 2].max(-1).values  # (VM, R) per-triangle nearest z

    # meshlet-level (depth bucket, morton) order
    bits = 6
    any_tri = tri_mask.any(1)
    mx0 = torch.where(tri_mask, xmin, 1e9).min(1).values
    mx1 = torch.where(tri_mask, xmax, -1e9).max(1).values
    my0 = torch.where(tri_mask, ymin, 1e9).min(1).values
    my1 = torch.where(tri_mask, ymax, -1e9).max(1).values
    m_near = torch.where(tri_mask, tz, -1.0).max(1).values
    cx = torch.clamp((mx0 + mx1) * (0.5 / width) * (1 << bits), 0, (1 << bits) - 1).to(torch.int32)
    cy = torch.clamp((my0 + my1) * (0.5 / height) * (1 << bits), 0, (1 << bits) - 1).to(torch.int32)
    mo = torch.zeros_like(cx)
    for b in range(bits):
        mo = mo | (((cx >> b) & 1) << (2 * b)) | (((cy >> b) & 1) << (2 * b + 1))
    zb = torch.clamp(((1.0 - m_near) * 4.0).to(torch.int32), 0, 3)
    key = torch.where(any_tri, zb * (1 << 20) + mo, 1 << 30)
    perm = torch.sort(key, stable=True).indices  # (VM,) meshlet order

    # compaction targets: index math only; lanes not kept write past the end
    mask_o = tri_mask[perm].reshape(n)
    slots = torch.cumsum(mask_o.to(torch.int32), 0, dtype=torch.int32) - 1
    count = torch.clamp(slots[-1] + 1, min=0)
    src_flat = (perm[:, None] * r + torch.arange(r, device=dev)).reshape(n)
    target = torch.where(mask_o, slots.long(), n)
    final_src = torch.zeros(n + 1, dtype=torch.long, device=dev)
    final_src[target] = src_flat
    final_src = final_src[:n]
    valid = torch.arange(n, device=dev) < count

    # one combined row gather of every per-triangle field
    n_attr = setup["attr_planes"].shape[2]
    cols = [
        setup["coeffs"].reshape(vm, r, 15),
        setup["attr_planes"].reshape(vm, r, n_attr * 3),
        torch.stack([xmin, xmax, ymin, ymax, tz], dim=-1),
        slot_material.to(torch.float32)[:, None, None].expand(vm, r, 1),
        slot_instance.to(torch.float32)[:, None, None].expand(vm, r, 1),
        setup["packed_id"].to(torch.float32)[..., None],  # < 2^24, f32-exact
    ]
    d = torch.cat(cols, dim=-1).reshape(n, 15 + n_attr * 3 + 8)[final_src]

    coeffs = torch.where(valid[:, None], d[:, 0:15], 0.0).reshape(n, 5, 3)
    coeffs[:, 0, 2] = torch.where(valid, coeffs[:, 0, 2], -1e30)
    attr_planes = torch.where(valid[:, None], d[:, 15 : 15 + n_attr * 3], 0.0)
    o = 15 + n_attr * 3
    big = 1e9
    xmin_d = torch.where(valid, d[:, o + 0], big).reshape(n_groups, group)
    xmax_d = torch.where(valid, d[:, o + 1], -big).reshape(n_groups, group)
    ymin_d = torch.where(valid, d[:, o + 2], big).reshape(n_groups, group)
    ymax_d = torch.where(valid, d[:, o + 3], -big).reshape(n_groups, group)
    tz_d = torch.where(valid, d[:, o + 4], -1.0).reshape(n_groups, group)
    mat_d = torch.where(valid, d[:, o + 5].to(torch.int32), 0)
    inst_d = torch.where(valid, d[:, o + 6].to(torch.int32), 0)
    pid_d = torch.where(valid, d[:, o + 7].to(torch.int32), -1)
    return {
        "coeffs": coeffs.reshape(n_groups, group, 5, 3),
        "attr_planes": attr_planes.reshape(n_groups, group, n_attr, 3),
        "tri_valid": valid.reshape(n_groups, group),
        "ml_xmin": xmin_d.min(1).values,
        "ml_xmax": xmax_d.max(1).values,
        "ml_ymin": ymin_d.min(1).values,
        "ml_ymax": ymax_d.max(1).values,
        "ml_near": tz_d.max(1).values,
        "slot_material": mat_d.reshape(n_groups, group),
        "slot_instance": inst_d.reshape(n_groups, group),
        "packed_id": pid_d.reshape(n_groups, group),
        "slot_rows": None,
        "count": count,
        "tri_z": tz_d,
    }


def passthrough_groups(setup: dict, tri_mask: Tensor, slot_material: Tensor, slot_instance: Tensor) -> dict:
    """Dense-group dict without re-grouping: source meshlets are the raster
    groups. The fields the shared slot rows read (`raster3d.build_tile_comb`)
    and those the group raster's binning and early-out read (group bounds,
    ml_near, count), as the JAX function gives them, and slot_rows None; the
    tile path's binning reads `passthrough_bounds`."""
    vm, r = tri_mask.shape
    tz = torch.max(setup["sxyz"][..., 2], dim=-1).values  # (VM, R) per-tri nearest z
    coeffs = torch.where(tri_mask[..., None, None], setup["coeffs"], 0.0)
    coeffs[..., 0, 2] = torch.where(tri_mask, coeffs[..., 0, 2], -1e30)
    xmin = torch.clamp(setup["tri_xmin"], min=0.0)
    ymin = torch.clamp(setup["tri_ymin"], min=0.0)
    return {
        "coeffs": coeffs,
        "attr_planes": torch.where(tri_mask[..., None, None], setup["attr_planes"], 0.0),
        "tri_valid": tri_mask,
        "ml_xmin": torch.where(tri_mask, xmin, 1e9).min(1).values,
        "ml_xmax": torch.where(tri_mask, setup["tri_xmax"], -1e9).max(1).values,
        "ml_ymin": torch.where(tri_mask, ymin, 1e9).min(1).values,
        "ml_ymax": torch.where(tri_mask, setup["tri_ymax"], -1e9).max(1).values,
        "ml_near": torch.where(tri_mask, tz, -1.0).max(1).values,
        "slot_material": slot_material[:, None].expand(vm, r),
        "slot_instance": slot_instance[:, None].expand(vm, r),
        "packed_id": torch.where(tri_mask, setup["packed_id"], -1),
        "slot_rows": None,
        "count": tri_mask.sum(dtype=torch.int32),
        "tri_z": torch.where(tri_mask, tz, -1.0),
    }


def passthrough_bounds(setup: dict, tri_mask: Tensor) -> dict:
    """Just the fields triangle binning reads, under a pass's triangle mask."""
    xmin = torch.where(tri_mask, setup["tri_xmin"], 1e9)
    xmax = torch.where(tri_mask, setup["tri_xmax"], -1e9)
    ymin = torch.where(tri_mask, setup["tri_ymin"], 1e9)
    ymax = torch.where(tri_mask, setup["tri_ymax"], -1e9)
    return {
        "tri_valid": tri_mask,
        "tri_xmin": xmin,
        "tri_xmax": xmax,
        "tri_ymin": ymin,
        "tri_ymax": ymax,
        "ml_xmin": xmin.min(1).values,
        "ml_xmax": xmax.max(1).values,
        "ml_ymin": ymin.min(1).values,
        "ml_ymax": ymax.max(1).values,
    }


def _first_reaching(cum: Tensor, k: int) -> Tensor:
    """For a monotone row `cum`, the first position where it reaches j+1, for
    j < k (the row length where it never does): Σ_n [cum_n < j+1]."""
    ranks = torch.arange(1, k + 1, dtype=cum.dtype, device=cum.device).expand(cum.shape[0], k).contiguous()
    return torch.searchsorted(cum.contiguous(), ranks, right=False)


def bin_meshlets_to_tiles(setup: dict, width: int, height: int, tile: int, k_per_tile: int) -> tuple[Tensor, Tensor]:
    """Per-tile meshlet lists: (tile_list (T, K) i32 slot or -1, overflow () i32
    — dropped meshlet-tile pairs)."""
    dev = setup["ml_xmin"].device
    tx = (width + tile - 1) // tile
    ty = (height + tile - 1) // tile
    tids = torch.arange(tx * ty, device=dev)
    tile_x0 = ((tids % tx) * tile).to(torch.float32)[:, None]
    tile_y0 = ((tids // tx) * tile).to(torch.float32)[:, None]
    has_tris = setup["ml_xmax"] >= setup["ml_xmin"]
    overlap = (
        (setup["ml_xmax"][None, :] >= tile_x0)
        & (setup["ml_xmin"][None, :] < tile_x0 + tile)
        & (setup["ml_ymax"][None, :] >= tile_y0)
        & (setup["ml_ymin"][None, :] < tile_y0 + tile)
        & has_tris[None, :]
    )  # (T, VM)
    cum = torch.cumsum(overlap.to(torch.int32), dim=1, dtype=torch.int32)
    pos = _first_reaching(cum, k_per_tile).to(torch.int32)
    ranks = torch.arange(1, k_per_tile + 1, dtype=torch.int32, device=dev)[None, :]
    tile_list = torch.where(cum[:, -1:] >= ranks, pos, -1)
    overflow = torch.clamp(cum[:, -1] - k_per_tile, min=0).sum(dtype=torch.int32)
    return tile_list, overflow


def bin_triangles_per_tile(
    dense: dict, width: int, height: int, tile: int, k_groups: int, k2: int
) -> tuple[Tensor, Tensor, Tensor]:
    """Per-tile triangle shortlists: group bboxes → per-tile group lists
    (`k_groups` cap), then the K·R candidates per tile masked by each
    triangle's own bbox overlap and rank-compacted to `k2` entries, in group
    order (front to back). Returns (entries (T, k2) i32 — flat slot g·R + r or
    -1, counts (T,) i32 clipped to k2, overflow () i32 — dropped tile-triangle
    pairs, the stage-1 group overflow included)."""
    g_list, g_ovf = bin_meshlets_to_tiles(dense, width, height, tile, k_groups)
    r = dense["tri_valid"].shape[1]
    t_n, k = g_list.shape
    dev = g_list.device
    tx = (width + tile - 1) // tile
    gl = torch.clamp(g_list, min=0).long()

    fields = torch.cat(
        [
            torch.clamp(dense["tri_xmin"], 0.0, float(width)),
            torch.clamp(dense["tri_xmax"], -1.0, float(width)),
            torch.clamp(dense["tri_ymin"], 0.0, float(height)),
            torch.clamp(dense["tri_ymax"], -1.0, float(height)),
            dense["tri_valid"].to(torch.float32),
        ],
        dim=1,
    )  # (G, 5R)
    cand = fields[gl]  # (T, K, 5R)
    cx0 = cand[:, :, 0 * r : 1 * r].reshape(t_n, k * r)
    cx1 = cand[:, :, 1 * r : 2 * r].reshape(t_n, k * r)
    cy0 = cand[:, :, 2 * r : 3 * r].reshape(t_n, k * r)
    cy1 = cand[:, :, 3 * r : 4 * r].reshape(t_n, k * r)
    cv = cand[:, :, 4 * r : 5 * r].reshape(t_n, k * r) > 0.5

    tids = torch.arange(t_n, device=dev)
    tile_x0 = ((tids % tx) * tile).to(torch.float32)[:, None]
    tile_y0 = ((tids // tx) * tile).to(torch.float32)[:, None]
    live_k = (g_list >= 0)[:, :, None].expand(t_n, k, r).reshape(t_n, k * r)
    m = (cx1 >= tile_x0) & (cx0 < tile_x0 + tile) & (cy1 >= tile_y0) & (cy0 < tile_y0 + tile) & cv & live_k

    cum = torch.cumsum(m.to(torch.int32), dim=1, dtype=torch.int32)
    cnt_raw = cum[:, -1]
    overflow = torch.clamp(cnt_raw - k2, min=0).sum(dtype=torch.int32) + g_ovf
    cnt = torch.clamp(cnt_raw, max=k2)
    pos = _first_reaching(cum, k2)  # (T, k2)
    have = cnt_raw[:, None] >= torch.arange(1, k2 + 1, dtype=torch.int32, device=dev)[None, :]
    k_of = torch.clamp(torch.div(pos, r, rounding_mode="floor"), 0, k - 1)
    r_of = pos % r
    flat = (torch.gather(gl, 1, k_of) * r + r_of).to(torch.int32)
    entries = torch.where(have, flat, -1)
    return entries, cnt, overflow
