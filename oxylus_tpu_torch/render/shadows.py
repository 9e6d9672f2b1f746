"""Directional-light shadows: page-cached clipmap shadow maps, their resolve,
and screen-space contact shadows (counterpart of `oxylus_tpu/render/shadows.py`).

Each clipmap level is a depth-only meshlet raster (`ops/raster_depth.py`, the
CUDA kernel on a card) of a stable, texel-snapped orthographic light view at
doubling world extent. `render_shadow_clipmaps_cached` keeps each 64×64-texel
page's depth across frames and re-renders only pages that the frame's pixels
sample (`mark_visible_pages`) and that are invalid: the level's light matrix
moved, or a moved instance's bounding sphere (now or last frame) overlaps the
page. Per level it takes one of three branches, as the JAX module's
`lax.switch` does: keep the cached map, render the dirty region at the small
capacity (`dyn_capacity`), or render at the full capacity. The six branch
indices come to the host in one read.

`SHADOW_MAP_SIZE`, `NUM_CLIPMAPS`, `PAGE` and `PAGES` are module constants read
at call time (`NUM_CLIPMAPS` as `clipmap_matrices`' default), so a caller can
shrink the maps by setting them, as the CPU tests do.

Known defect, reproduced: the small tier expands every valid instance at
`dyn_capacity = min(768, capacity)` before the crop cull, so in a scene with
more meshlets than that the casters past the first 768 meshlet-instances are
dropped from the dirty pages (`tests/test_torch_shadows.py` names it).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.cull import cull_meshlets, expand_meshlet_instances
from ..ops import raster_depth
from ..ops.raster3d import TILE
from ..ops.setup3d import bin_meshlets_to_tiles, setup_triangles
from ..utils import math3d

Tensor = torch.Tensor

SHADOW_MAP_SIZE = 1024
NUM_CLIPMAPS = 6
PAGE = TILE  # shadow page == raster tile
PAGES = SHADOW_MAP_SIZE // PAGE  # pages per map side


def _norm(v: Tensor, dim: int = -1) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=dim))


def clipmap_matrices(
    light_dir: Tensor, focus: Tensor, first_width: float = 10.0, num_clipmaps: int = NUM_CLIPMAPS,
    depth_range: float = 200.0,
) -> Tensor:
    """(L, 4, 4) stable light view-projections. Level i covers a world box of
    width first_width·2^i centred, texel-snapped, on the focus; `light_dir` is
    the direction the light travels."""
    dev = light_dir.device
    up = torch.where(torch.abs(light_dir[1]) > 0.99, torch.tensor([1.0, 0.0, 0.0], device=dev),
                     torch.tensor([0.0, 1.0, 0.0], device=dev))
    eye = focus - light_dir * (depth_range * 0.5)
    view = math3d.look_at(eye, focus, up)
    focus_ls = math3d.mat4_transform_point(view, focus)
    mats = []
    for lvl in range(num_clipmaps):
        width = first_width * (2.0**lvl)
        texel = width / SHADOW_MAP_SIZE
        snap = torch.floor(focus_ls[:2] / texel) * texel - focus_ls[:2]
        half = width * 0.5
        proj = math3d.ortho_reverse_z(-half + snap[0], half + snap[0], -half + snap[1], half + snap[1], 0.0,
                                      depth_range, device=dev)
        mats.append(math3d.mat4_mul(proj, view))
    return torch.stack(mats)


def _render_level(gscene, entity_world: Tensor, vp: Tensor, planes: Tensor, capacity: int, k_per_tile: int,
                  page_mask: Tensor | None = None) -> Tensor:
    """One level's depth-only raster: expand every valid instance at LOD 0,
    frustum-cull against `planes` (no cone culling for an orthographic light),
    set up, bin to 64-px pages and raster. `page_mask` (PAGES²,) masks the
    tile lists of pages that need no render to -1."""
    s = SHADOW_MAP_SIZE
    lod = torch.zeros_like(gscene.inst_mesh)
    mi_i, mi_m, mi_v = expand_meshlet_instances(gscene, gscene.inst_valid, lod, capacity)
    vm_i, vm_m, vm_v, _ = cull_meshlets(
        gscene, entity_world, mi_i, mi_m, mi_v, planes, torch.zeros(3, device=vp.device), capacity=capacity,
        cone_enabled=False,
    )
    setup = setup_triangles(gscene, entity_world, vm_i, vm_m, vm_v, vp, s, s, backface_enabled=False)
    tile_list, _ = bin_meshlets_to_tiles(setup, s, s, PAGE, k_per_tile)
    if page_mask is not None:
        tile_list = torch.where(page_mask[:, None], tile_list, -1)
    cm = raster_depth.pack_coeff_matrix(setup["coeffs"], setup["tri_valid"])
    depth, _ = raster_depth.rasterize_depth(cm, tile_list, s, s)
    return depth


def render_shadow_clipmaps(gscene, entity_world: Tensor, light_vps: Tensor, capacity: int = 2048,
                           k_per_tile: int = 32) -> Tensor:
    """Depth-only meshlet raster per clipmap → (L, S, S) reverse-Z depth maps."""
    return torch.stack([
        _render_level(gscene, entity_world, vp, math3d.frustum_planes_from_mat(vp), capacity, k_per_tile)
        for vp in light_vps
    ])


def mark_visible_pages(world_pos: Tensor, hit: Tensor, light_vps: Tensor) -> Tensor:
    """(L, PAGES²) bool: the shadow pages the screen pixels sample, dilated by
    one page so PCF taps at page borders stay resident."""
    n_lvls = light_vps.shape[0]
    wp = world_pos.reshape(-1, 3)
    ok = hit.reshape(-1)
    x, y, z = wp[:, 0], wp[:, 1], wp[:, 2]
    m = light_vps

    def proj(r: int) -> Tensor:  # (L, NP)
        return ((m[:, r, 0, None] * x[None] + m[:, r, 1, None] * y[None]) + m[:, r, 2, None] * z[None]) + m[:, r, 3, None]

    cw = torch.clamp(torch.abs(proj(3)), min=1e-9)
    u = proj(0) / cw * 0.5 + 0.5
    v = proj(1) / cw * 0.5 + 0.5
    inside = ok[None] & (u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)
    px = torch.clamp(u * PAGES, -1.0, float(PAGES)).to(torch.int32).clamp(0, PAGES - 1)
    py = torch.clamp(v * PAGES, -1.0, float(PAGES)).to(torch.int32).clamp(0, PAGES - 1)
    lvl = torch.arange(n_lvls, device=wp.device)[:, None]
    idx = (lvl * PAGES + py) * PAGES + px
    marks = torch.zeros(n_lvls * PAGES * PAGES, dtype=torch.float32, device=wp.device)
    marks.scatter_add_(0, idx.reshape(-1).long(), inside.reshape(-1).to(torch.float32))
    m2 = (marks.reshape(n_lvls, 1, PAGES, PAGES) > 0.5).to(torch.float32)
    m2 = F.max_pool2d(m2, 3, stride=1, padding=1)
    return m2.reshape(n_lvls, -1) > 0.5


def _page_footprints(vp: Tensor, c_ws: Tensor, r_ws: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Instances' bounding spheres in page units of one level: (u, v, ru, rv)."""
    ch = torch.cat([c_ws, torch.ones_like(c_ws[:, :1])], dim=-1)
    clip = math3d.dot_fma(vp[None], ch[:, None, :])  # (I, 4)
    u = (clip[:, 0] * 0.5 + 0.5) * PAGES
    v = (clip[:, 1] * 0.5 + 0.5) * PAGES
    # radius scale = norm of the VP row (the light view rotates)
    ru = r_ws * _norm(vp[0, :3]) * 0.5 * PAGES
    rv = r_ws * _norm(vp[1, :3]) * 0.5 * PAGES
    return u, v, ru, rv


def render_shadow_clipmaps_cached(
    gscene, entity_world: Tensor, light_vps: Tensor, prev: dict | None, capacity: int = 2048, k_per_tile: int = 32,
    visible_pages: Tensor | None = None,
) -> tuple[Tensor, dict]:
    """Page-cached clipmaps with visible-page residency. Returns (maps (L, S, S),
    carry); feed the carry back as `prev`. One host read per frame after the
    first: the six levels' branches."""
    n_lvls = light_vps.shape[0]
    s = SHADOW_MAP_SIZE
    dev = entity_world.device
    have_prev = prev is not None and "world" in prev

    # which entities moved since last frame?
    if have_prev:
        changed_e = torch.any(torch.abs(entity_world - prev["world"]) > 1e-6, dim=2).any(dim=1)
    else:
        changed_e = torch.ones(entity_world.shape[0], dtype=torch.bool, device=dev)
    inst_entity = gscene.inst_entity.long()
    inst_changed = changed_e[inst_entity] & gscene.inst_valid

    # conservative world bounding spheres at the current and the previous
    # transform: a moved instance invalidates where its stale shadow lies too
    mesh = gscene.inst_mesh.long()
    amin, amax = gscene.mesh_aabb_min[mesh], gscene.mesh_aabb_max[mesh]
    c_local = (amin + amax) * 0.5
    r_local = _norm((amax - amin) * 0.5)

    def sphere_of(world_mats: Tensor) -> tuple[Tensor, Tensor]:
        iw = world_mats[inst_entity]
        c = math3d.dot_fma(iw[:, :3, :3], c_local[:, None, :]) + iw[:, :3, 3]
        scale = torch.max(_norm(iw[:, :3, :3], dim=1), dim=-1).values
        return c, r_local * scale

    spheres = [sphere_of(entity_world)]
    if have_prev:
        spheres.append(sphere_of(prev["world"]))

    page_ids = torch.arange(PAGES * PAGES, dtype=torch.int32, device=dev)
    page_x = (page_ids % PAGES).to(torch.float32)
    page_y = torch.div(page_ids, PAGES, rounding_mode="floor").to(torch.float32)

    dyn_pages_out, render_lvls, resident_out = [], [], []
    for lvl in range(n_lvls):
        vp = light_vps[lvl]
        if prev is not None and "vps" in prev:
            vpc = torch.any(torch.abs(vp - prev["vps"][lvl]) > 1e-7)
        else:
            vpc = torch.ones((), dtype=torch.bool, device=dev)
        dyn_pages = torch.zeros(PAGES * PAGES, dtype=torch.bool, device=dev)
        for c_ws, r_ws in spheres:
            u, v, ru, rv = _page_footprints(vp, c_ws, r_ws)
            lo_u = torch.where(inst_changed, u - ru, 1e9)
            hi_u = torch.where(inst_changed, u + ru, -1e9)
            lo_v = torch.where(inst_changed, v - rv, 1e9)
            hi_v = torch.where(inst_changed, v + rv, -1e9)
            overlap = (
                (page_x[:, None] + 1.0 >= lo_u[None, :]) & (page_x[:, None] <= hi_u[None, :])
                & (page_y[:, None] + 1.0 >= lo_v[None, :]) & (page_y[:, None] <= hi_v[None, :])
            )  # (P, I)
            dyn_pages = dyn_pages | torch.any(overlap, dim=1)
        dyn_pages_out.append(dyn_pages)
        prev_dyn = prev["dyn_pages"][lvl] if prev is not None and "dyn_pages" in prev else torch.ones_like(dyn_pages)
        invalid = dyn_pages | prev_dyn | vpc
        # residency: pages to (re)render = visible ∧ (invalid ∨ ¬resident)
        if visible_pages is not None:
            vis_p = visible_pages[lvl]
            prev_res = prev["resident"][lvl] if prev is not None and "resident" in prev else torch.zeros_like(vis_p)
            resident = prev_res & ~invalid
            need = vis_p & ~resident
            resident_out.append(resident | need)
        else:
            need = invalid
            resident_out.append(torch.ones_like(invalid))
        render_lvls.append(need)

    def pix_mask(page_mask: Tensor) -> Tensor:
        return page_mask.reshape(PAGES, 1, PAGES, 1).expand(PAGES, PAGE, PAGES, PAGE).reshape(s, s)

    if prev is not None and "maps" in prev:
        # per-level tier: the small tier culls to the dirty pages' region at
        # dyn_capacity when a conservative estimate of the meshlets there fits
        dyn_capacity = min(768, capacity)
        inst_ml = gscene.mesh_lod_meshlet_count[mesh, 0]
        c_all, r_all = spheres[0]
        crops, branch = [], []
        for lvl in range(n_lvls):
            dirty = render_lvls[lvl]
            any_d = torch.any(dirty)
            u_lo = torch.min(torch.where(dirty, page_x, torch.inf))
            u_hi = torch.max(torch.where(dirty, page_x + 1.0, -torch.inf))
            v_lo = torch.min(torch.where(dirty, page_y, torch.inf))
            v_hi = torch.max(torch.where(dirty, page_y + 1.0, -torch.inf))
            crops.append((any_d, u_lo, u_hi, v_lo, v_hi))
            u, v, ru, rv = _page_footprints(light_vps[lvl], c_all, r_all)
            ov = (u + ru >= u_lo) & (u - ru <= u_hi) & (v + rv >= v_lo) & (v - rv <= v_hi) & gscene.inst_valid
            est = torch.sum(torch.where(ov, inst_ml, 0))
            branch.append(torch.where(any_d, torch.where(est <= dyn_capacity, 1, 2), 0))
        branch = torch.stack(branch).tolist()  # the one host read of the stage
        maps = []
        for lvl in range(n_lvls):
            vp = light_vps[lvl]
            if branch[lvl] == 0:
                maps.append(prev["maps"][lvl])
                continue
            if branch[lvl] == 1:
                # crop matrix: maps the dirty NDC sub-rect to full NDC, so the
                # frustum planes cull to the dirty region
                any_d, u_lo, u_hi, v_lo, v_hi = crops[lvl]
                a0 = torch.where(any_d, u_lo / PAGES * 2.0 - 1.0, 3.0)
                a1 = torch.where(any_d, u_hi / PAGES * 2.0 - 1.0, 3.5)
                b0 = torch.where(any_d, v_lo / PAGES * 2.0 - 1.0, 3.0)
                b1 = torch.where(any_d, v_hi / PAGES * 2.0 - 1.0, 3.5)
                sx = 2.0 / torch.clamp(a1 - a0, min=1e-6)
                sy = 2.0 / torch.clamp(b1 - b0, min=1e-6)
                crop = torch.eye(4, dtype=torch.float32, device=dev)
                crop[0, 0], crop[0, 3] = sx, -(a1 + a0) * 0.5 * sx
                crop[1, 1], crop[1, 3] = sy, -(b1 + b0) * 0.5 * sy
                planes = math3d.frustum_planes_from_mat(math3d.mat4_mul(crop, vp))
                cap = dyn_capacity
            else:
                planes, cap = math3d.frustum_planes_from_mat(vp), capacity
            depth = _render_level(gscene, entity_world, vp, planes, cap, k_per_tile, render_lvls[lvl])
            maps.append(torch.where(pix_mask(render_lvls[lvl]), depth, prev["maps"][lvl]))
        maps = torch.stack(maps)
    else:
        maps = torch.stack([
            _render_level(gscene, entity_world, vp, math3d.frustum_planes_from_mat(vp), capacity, k_per_tile,
                          render_lvls[lvl])
            for lvl, vp in enumerate(light_vps)
        ])
    carry = {
        "maps": maps,
        "vps": light_vps,
        "dyn_pages": torch.stack(dyn_pages_out),
        "world": entity_world,
        "resident": torch.stack(resident_out),
    }
    return maps, carry


def resolve_shadows(world_pos: Tensor, hit: Tensor, light_vps: Tensor, shadow_maps: Tensor,
                    bias: float = 2e-3) -> Tensor:
    """Screen-space shadow factor (1 = lit): the finest clipmap containing the
    pixel, 2×2 PCF with edge-clamped neighbours."""
    s = shadow_maps.shape[-1]
    n_lvls = light_vps.shape[0]
    shape = world_pos.shape[:2]
    dev = world_pos.device
    best_lvl = torch.full(shape, n_lvls - 1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(shape, device=dev)
    best_v = torch.zeros(shape, device=dev)
    best_z = torch.zeros(shape, device=dev)
    any_inside = torch.zeros(shape, dtype=torch.bool, device=dev)
    for lvl in range(n_lvls - 1, -1, -1):
        clip = math3d.mat4_point_image(light_vps[lvl], world_pos)
        ndc = clip[..., :3] / torch.clamp(torch.abs(clip[..., 3:4]), min=1e-9)
        u = ndc[..., 0] * 0.5 + 0.5
        v = ndc[..., 1] * 0.5 + 0.5
        z = ndc[..., 2]
        inside = (u > 0.01) & (u < 0.99) & (v > 0.01) & (v < 0.99) & (z > 0.0) & (z < 1.0)
        best_lvl = torch.where(inside, lvl, best_lvl)
        best_u = torch.where(inside, u, best_u)
        best_v = torch.where(inside, v, best_v)
        best_z = torch.where(inside, z, best_z)
        any_inside = any_inside | inside
    x = torch.clamp((best_u * s).to(torch.int32), 0, s - 1)
    y = torch.clamp((best_v * s).to(torch.int32), 0, s - 1)
    x1 = torch.clamp(x + 1, max=s - 1)
    y1 = torch.clamp(y + 1, max=s - 1)
    flat = shadow_maps.reshape(-1)
    base = best_lvl * (s * s)
    lit = torch.zeros(shape, device=dev)
    for yy, xx in ((y, x), (y, x1), (y1, x), (y1, x1)):
        # reverse-Z: lit when the pixel is at or nearer than the occluder (within bias)
        tap = flat[(base + yy * s + xx).long()]
        lit = lit + torch.where(best_z + bias >= tap, 1.0, 0.0)
    factor = torch.where(any_inside, lit * 0.25, 1.0)
    return torch.where(hit, factor, 1.0)


def contact_shadows(depth: Tensor, world_pos: Tensor, hit: Tensor, light_dir: Tensor, view_proj: Tensor,
                    steps: int = 8, thickness: float = 0.1, length: float = 0.05) -> Tensor:
    """Short-range screen-space march toward the sun; 0 = contact-shadowed.
    Each step reads the depth texel its sample lands on, clamped into the 4×4
    window around the mid step's texel (the JAX module's one-gather window)."""
    h, w = depth.shape
    win = 4
    to_light = -light_dir
    ts = torch.arange(1, steps + 1, dtype=torch.float32, device=depth.device) * (length / steps)
    sample_ws = world_pos[None] + to_light[None, None, None, :] * ts[:, None, None, None]
    clip = math3d.mat4_point_image(view_proj, sample_ws)  # (S, H, W, 4)
    wc = torch.clamp(torch.abs(clip[..., 3]), min=1e-9)
    ndc = clip[..., :3] / wc[..., None]
    sx = torch.clamp(((ndc[..., 0] * 0.5 + 0.5) * w).to(torch.int32), 0, w - 1)
    sy = torch.clamp(((ndc[..., 1] * 0.5 + 0.5) * h).to(torch.int32), 0, h - 1)
    ox = torch.clamp(sx[steps // 2] - (win // 2 - 1), 0, w - win)  # (H, W)
    oy = torch.clamp(sy[steps // 2] - (win // 2 - 1), 0, h - win)
    tx = torch.clamp(ox[None] + torch.clamp(sx - ox[None], 0, win - 1), max=w - 1)
    ty = torch.clamp(oy[None] + torch.clamp(sy - oy[None], 0, win - 1), max=h - 1)
    scene_depth = depth.reshape(-1)[(ty * w + tx).long()]  # (S, H, W)
    # occluder: scene surface nearer than the ray point by less than `thickness`
    delta = scene_depth - ndc[..., 2]
    occluded = torch.any((delta > 1e-5) & (delta < thickness), dim=0)
    return torch.where(occluded & hit, 0.0, 1.0)
