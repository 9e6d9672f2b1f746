"""Tiled 2D sprite rasterizer (counterpart of `oxylus_tpu/ops/raster2d.py`).

Sprites are projected, key-sorted back to front (invalid last, then layer,
then far to near, then higher y first), binned to 32×32 screen tiles with a
fixed per-tile capacity, and composited per tile in sorted order by the blend
kernel (`ops/blend2d.py`). Also returns a sprite-id visbuffer (i32 entity id
per pixel, -1 where nothing covers).

This is the JAX package's device branch (`use_pallas=True`, `:108-181`): one
29-column packed record gathered once in sorted order, binning over the first
`MAX_VISIBLE` sorted sprites, their 16×16 texture tiles, and the blend. The
port runs it on every device. The JAX package's XLA branch (full-resolution
`sample_atlas_bilinear` per pixel, which it takes on the CPU) is not ported:
a difference by design (`ROADMAP.md` C).
"""

from __future__ import annotations

import torch

from .blend2d import MAX_VISIBLE, TILE, blend_tiles, resample_texture_tiles

Tensor = torch.Tensor

_INVALID_LAYER = 2**31 - 1


def f32_to_sortable_u32(x: Tensor) -> Tensor:
    """The u32 key of `oxylus_tpu/ops/sampling.py::f32_to_sortable_u32` (float
    order kept: bits ^ 0xFFFFFFFF for a set sign bit, else bits ^ 0x80000000),
    as int64 holding the unsigned value: torch has no uint32 arithmetic, so
    the bits go through int32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    flip = torch.where(bits >= 2**31, 0xFFFFFFFF, 0x80000000)
    return bits ^ flip


def _mat4_mul_pairwise(a: Tensor, b: Tensor) -> Tensor:
    """Batched 4×4 product `a @ b`, the four float32 products summed pairwise,
    (p0 + p1) + (p2 + p3): the rounding of the JAX package's projection
    einsums on the CPU (every op rounds on its own, so it does not depend on
    the device's matmul library)."""
    p = [a[..., :, k, None] * b[..., None, k, :] for k in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def sprite_sort_order(depth: Tensor, y_world: Tensor, sort_y: Tensor, layer: Tensor, valid: Tensor) -> Tensor:
    """Draw order, the JAX package's `lax.sort` over (invalid→2³¹−1 | layer,
    depth key, −y key when `sort_y` else the key of 0.0) with the index as the
    last operand: lexicographic and stable. Chained stable sorts from the
    last key to the first give the same permutation."""
    zkey = f32_to_sortable_u32(depth)
    ykey = f32_to_sortable_u32(torch.where(sort_y, -y_world, torch.zeros_like(y_world)))
    primary = torch.where(valid, layer.to(torch.int64), _INVALID_LAYER)
    order = torch.arange(depth.shape[0], device=depth.device)
    for key in (ykey, zkey, primary):
        order = order[torch.sort(key[order], stable=True).indices]
    return order.to(torch.int32)


def tile_overlaps(prefix: Tensor, width: int, height: int) -> Tensor:
    """(T, S') bool: which records of the packed sorted prefix (columns 16-19
    the screen bounds xmin, xmax, ymin, ymax, 20 on screen) overlap each 32²
    tile of a width × height image, tiles in row-major order."""
    tx = (width + TILE - 1) // TILE
    t_idx = torch.arange(tx * ((height + TILE - 1) // TILE), device=prefix.device)
    x0 = ((t_idx % tx) * TILE).to(torch.float32)[:, None]
    y0 = (torch.div(t_idx, tx, rounding_mode="floor") * TILE).to(torch.float32)[:, None]
    return (
        (prefix[None, :, 17] >= x0)
        & (prefix[None, :, 16] < x0 + TILE)
        & (prefix[None, :, 19] >= y0)
        & (prefix[None, :, 18] < y0 + TILE)
        & (prefix[None, :, 20] > 0.5)
    )


def rasterize_sprites(
    world: Tensor,        # (S, 4, 4) sprite world matrices (unit quad in XY plane)
    entity_id: Tensor,    # (S,) i32 for the picking visbuffer
    layer: Tensor,        # (S,) i32
    sort_y: Tensor,       # (S,) bool
    flip_x: Tensor,       # (S,) bool
    valid: Tensor,        # (S,) bool
    view_proj: Tensor,    # (4, 4)
    materials,            # GPUMaterials, fields (S, ...) resolved per sprite
    atlas: Tensor,        # (A, A, 4) uint8
    *,
    width: int,
    height: int,
    k_per_tile: int = 64,
    scene_depth: Tensor | None = None,
    stats: dict | None = None,
) -> tuple[Tensor, Tensor]:
    """Returns (color (H, W, 4) f32 premultiplied-over result, visbuffer (H, W) i32).
    The material fields are resolved per sprite, so the JAX signature's
    `material_idx` (read by its XLA branch only) is not taken.

    `scene_depth` (H, W) f32 reverse-Z: when given, each sprite is
    depth-tested (no write) against it, as the reference's alpha pass draws
    into the scene depth buffer with a greater-or-equal test and writes off.

    `stats`, when given, receives the binning's (tile, record) pairs as 0-d
    device tensors: "tile_pairs" (every overlap of the visible prefix) and
    "tile_dropped" (those past `k_per_tile` a tile)."""
    s = world.shape[0]
    dev = world.device
    n_tiles = ((width + TILE - 1) // TILE) * ((height + TILE - 1) // TILE)

    # --- project quad corners ------------------------------------------------
    corners_local = torch.tensor(
        [[-0.5, -0.5, 0.0, 1.0], [0.5, -0.5, 0.0, 1.0], [-0.5, 0.5, 0.0, 1.0], [0.5, 0.5, 0.0, 1.0]],
        dtype=torch.float32, device=dev,
    )  # (4 corners, 4)
    mvp = _mat4_mul_pairwise(view_proj, world)  # (S, 4, 4)
    clip = _mat4_mul_pairwise(mvp, corners_local.T).transpose(1, 2)  # (S, 4 corners, 4)
    w = clip[..., 3]
    w_clip = torch.clamp(torch.abs(w), min=1e-6) * torch.sign(torch.where(w == 0, 1.0, w))
    ndc = clip[..., :3] / w_clip[..., None]
    sx = (ndc[..., 0] * 0.5 + 0.5) * width
    sy = (ndc[..., 1] * 0.5 + 0.5) * height
    nz = ndc[..., 2]
    depth = (((nz[:, 0] + nz[:, 1]) + nz[:, 2]) + nz[:, 3]) / 4.0  # (S,)

    xmin, xmax = sx.min(-1).values, sx.max(-1).values
    ymin, ymax = sy.min(-1).values, sy.max(-1).values
    on_screen = (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height) & valid

    # --- sort ---------------------------------------------------------------
    order = sprite_sort_order(depth, world[:, 1, 3], sort_y, layer, on_screen).long()

    # everything needed after the sort, packed so the sort costs one row gather
    m = materials
    p00x, p00y = sx[:, 0], sy[:, 0]
    e0x, e0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
    e1x, e1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
    det = e0x * e1y - e0y * e1x
    inv_det = torch.where(torch.abs(det) > 1e-9, 1.0 / det, 0.0)
    flags = m.flags.to(torch.int64)
    f32 = lambda a: a.to(torch.float32)
    packed = torch.stack(
        [
            p00x, p00y, e0x, e0y, e1x, e1y, inv_det,
            m.albedo_color[:, 0], m.albedo_color[:, 1], m.albedo_color[:, 2], m.albedo_color[:, 3],
            m.alpha_cutoff,
            f32((flags & (1 << 8)) != 0),
            f32((flags & 1) != 0),
            f32(entity_id),
            f32(flip_x),
            # binning columns
            xmin, xmax, ymin, ymax, f32(on_screen),
            # texture-window columns (for resampling the visible prefix)
            m.uv_size[:, 0], m.uv_size[:, 1], m.uv_offset[:, 0], m.uv_offset[:, 1],
            m.albedo_rect[:, 0], m.albedo_rect[:, 1], m.albedo_rect[:, 2], m.albedo_rect[:, 3],
        ],
        dim=-1,
    )  # (S, 29)
    ps = packed[order]  # the one gather
    records = ps[:, :16]

    # --- binning (T, S') → (T, K) over the sorted visible prefix ---------------
    # only the first MAX_VISIBLE sorted sprites have texture tiles, so only
    # they can be drawn
    overlap = tile_overlaps(ps[: min(s, MAX_VISIBLE)], width, height)  # (T, S')
    # cum[t, s] = overlaps among sorted sprites 0..s; the k-th list entry is
    # #{s : cum[t, s] <= k} (the first index where cum reaches k + 1): a
    # binary search per rank on the nondecreasing row
    cum = torch.cumsum(overlap.to(torch.int32), dim=1).contiguous()
    ranks0 = torch.arange(k_per_tile, dtype=torch.int32, device=dev)
    tile_list = torch.searchsorted(cum, ranks0.expand(n_tiles, k_per_tile).contiguous(), right=True).to(torch.int32)
    tile_list = torch.where(cum[:, -1:] > ranks0[None, :], tile_list, -1)  # (T, K)
    if stats is not None:
        stats["tile_pairs"] = cum[:, -1].sum()
        stats["tile_dropped"] = torch.clamp(cum[:, -1] - k_per_tile, min=0).sum()
    if s > MAX_VISIBLE:
        tile_list = torch.where(tile_list < MAX_VISIBLE, tile_list, -1)

    tiles = resample_texture_tiles(ps[:MAX_VISIBLE], atlas)
    return blend_tiles(
        records, tiles, tile_list, width, height,
        rec_depth=depth[order] if scene_depth is not None else None, scene_depth=scene_depth,
    )
