"""Multi-card scaling on `torch.distributed` (counterpart of
`oxylus_tpu/parallel/sharding.py`): worlds parallelism and screen sharding of
one frame.

A mesh is the initialised default process group seen as a 1-D `DeviceMesh`
(`make_mesh`): one process per card on NCCL, or CPU processes on gloo. Each
rank holds its own shard; what the JAX module leaves to `shard_map` and
`jit`, this module writes out as per-rank work and the collectives between.

- **Worlds axis**: `replicate_worlds` gives each rank `n_worlds / size` copies
  of a state stacked on a leading axis; `worlds_step` steps them one world at
  a time (the JAX module vmaps, but vmap cannot trace the ctypes kernels or
  the wrappers' host reads, so a kernel launches once per world);
  `worlds_reduce_mean` is a local sum and one all-reduce.
- **Tile axis**: `rasterize_tiles_sharded` splits the tile list by tiles;
  `render_frame_sharded` and `render_frame_sharded_production` split the
  frame into bands of tile rows. A band's work is a chain of stage functions
  (`band_hdr`, or `band_gbuffer_production` then `band_shade`; then
  `band_ldr`, then `band_fxaa`), joined by the collectives: the all-reduce
  of the luminance histogram (so every band applies the frame's exposure),
  one-row halo exchanges (so FXAA, and the textured albedo's upsampling,
  see the seams as on one card) and the all-gather of the bands. The stage
  functions take a band index and run without a group, so one process can
  run the bands in turn.

Where this module differs from the JAX one:
- a band's histogram counts only its rows inside the image. The last band's
  rows past the height (a partial last tile row, then the padded tile rows)
  are left out, so the exposure is the single-card frame's at any height.
  The JAX module counts them, and a hit there moves its exposure;
- the textured production frame exchanges a half-resolution halo row before
  upsampling a band's albedo modulation, so its seams equal the single-card
  frame; the JAX module resizes each band alone, which clamps at the seams;
- `render_frame_sharded_production` takes the group raster's slot rows
  (`raster3d.build_tile_comb`) and `n_slots` in place of the MXU-layout
  `(cm_gb, attr_gb)`, and has no `interpret`: dispatch follows the tensors'
  device, as everywhere in the port.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops import raster3d
from ..ops.decode3d import decode_visbuffer
from ..ops.raster3d import TILE, gbuffer_from_raster
from ..ops.raster_groups import rasterize_gbuffer_groups
from ..ops.sampling import pack_atlas_taps, sample_material_textures
from ..render.pbr import apply_pbr
from ..render.postfx import adapt_exposure, apply_fxaa, apply_tonemap, luminance_histogram
from ..utils.imgops import point_downsample, resize_linear

Tensor = torch.Tensor

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
HIST_MIN_LOG2, HIST_INV_RANGE = -11.5, 1.0 / 29.5
FXAA_REACH = 1  # rows: apply_fxaa reads one-pixel neighbours only
TEXTURE_REACH = 1  # rows: the textured albedo's 2× upsampling reads one half-resolution row past its own


def make_mesh(n_devices: int | None = None, axis: str = "worlds", device=None):
    """The initialised default process group as a 1-D `DeviceMesh` with the
    dimension name `axis`: on the card unless `device="cpu"`. The group must
    exist (`torch.distributed.init_process_group`), on NCCL for the card and
    gloo for the CPU, and `n_devices` (None: any) must be its size; anything
    else raises. No backend is swapped."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (torch.distributed.init_process_group)")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the process group has {size} ranks")
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise RuntimeError(f"a mesh on {dev.type} needs the {BACKENDS[dev.type]} backend, the group runs {backend}")
    return DeviceMesh(dev.type, torch.arange(size), mesh_dim_names=(axis,))


def _group(mesh, axis: str):
    """(process group, this rank's index, size) along `axis`."""
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


# ---------------------------------------------------------------------------
# Worlds parallelism
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    """`fn` over the tensors of a state: dataclass fields, dict values, list
    and tuple items; other leaves (None, flags) are kept."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _tree_stack(trees: list):
    """Stack equal-structured states on a new leading axis; a non-tensor leaf
    is taken from the first."""
    first = trees[0]
    if isinstance(first, Tensor):
        return torch.stack(trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{f.name: _tree_stack([getattr(t, f.name) for t in trees])
                                             for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_stack(list(items)) for items in zip(*trees))
    return first


def _leading(tree) -> int:
    sizes = []
    _tree_map(lambda x: sizes.append(x.shape[0]), tree)
    if not sizes:
        raise ValueError("a batch of worlds holds no tensor")
    return sizes[0]


def replicate_worlds(tree, n_worlds: int, mesh=None, axis: str = "worlds"):
    """This rank's share of `n_worlds` copies of a state (`PhysicsState`,
    `SceneState` or any dataclass, dict or tuple of tensors): n_worlds / size
    copies stacked on a leading axis, on the state's device. Copies, not
    views. `mesh=None`: one process holds every world. A count that does not
    divide over the ranks raises."""
    size = 1 if mesh is None else _group(mesh, axis)[2]
    if n_worlds % size:
        raise ValueError(f"{n_worlds} worlds do not divide over {size} ranks")
    n_local = n_worlds // size
    return _tree_map(lambda x: x.unsqueeze(0).repeat((n_local,) + (1,) * x.dim()), tree)


def worlds_step(step_fn):
    """Lift a per-world step to a batch of worlds: the returned function takes
    batches (leading world axis) for each of `step_fn`'s arguments, steps
    each world and stacks the results. One call of `step_fn` per world."""

    def step(*batches):
        n = _leading(batches)
        outs = [step_fn(*(_tree_map(lambda x, w=w: x[w], b) for b in batches)) for w in range(n)]
        return _tree_stack(outs)

    return step


def worlds_reduce_mean(values: Tensor, mesh=None, axis: str = "worlds") -> Tensor:
    """The mean over every rank's worlds (leading axis): the local sum, one
    all-reduce over `mesh` (None: the default group if one is initialised,
    else this process alone), divided by the global world count."""
    total = values.sum(0)
    n = values.shape[0]
    group = None if mesh is None else mesh.get_group(axis)
    if mesh is not None or (dist.is_available() and dist.is_initialized()):
        dist.all_reduce(total, group=group)
        n *= dist.get_world_size(group)
    return total / torch.full((), float(n), device=values.device)


# ---------------------------------------------------------------------------
# Tile-sharded rasterization
# ---------------------------------------------------------------------------

def _gather_cat(x: Tensor, group) -> Tensor:
    """Every rank's `x` concatenated along the first axis, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def rasterize_tiles_sharded(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int, mesh,
                            axis: str = "worlds") -> tuple[Tensor, Tensor]:
    """The decode path's raster (`raster3d.rasterize_reference`) split over the
    ranks by tiles: the tile list (T, K) is padded with empty tiles to a
    multiple of the size, rank r rasters tiles [r·n, (r+1)·n) at their
    screen positions, the blocks are all-gathered and untiled. Every rank
    returns the full (depth (H, W) f32, vid (H, W) i32)."""
    group, rank, size = _group(mesh, axis)
    t, k_cap = tile_list.shape
    pad = (-t) % size
    if pad:
        tile_list = torch.cat([tile_list, torch.full((pad, k_cap), -1, dtype=tile_list.dtype,
                                                     device=tile_list.device)])
    n_local = tile_list.shape[0] // size
    block = tile_list[rank * n_local:(rank + 1) * n_local]
    depth, vid = raster3d.rasterize_reference_tiles(coeff_mat, block, width, tile_base=rank * n_local)
    depth, vid = _gather_cat(depth, group), _gather_cat(vid, group)
    tx, ty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    return raster3d._untile(depth[:tx * ty], width, height), raster3d._untile(vid[:tx * ty], width, height)


# ---------------------------------------------------------------------------
# Band-sharded frames: per-band stages and the collectives between them
# ---------------------------------------------------------------------------

def band_plan(width: int, height: int, n_bands: int, tile: int = TILE) -> tuple[int, int]:
    """(tiles a band, band height in rows): the tile rows padded up to a
    multiple of `n_bands`, each band the same number of whole tile rows."""
    tx, ty = (width + tile - 1) // tile, (height + tile - 1) // tile
    rows_local = -(-ty // n_bands)
    return rows_local * tx, rows_local * tile


def band_tiles(tile_list: Tensor, width: int, height: int, n_bands: int, band: int, tile: int = TILE) -> Tensor:
    """Band `band`'s rows of the tile list (T, K), the tiles past the image
    (padding to whole bands) empty."""
    n_local, _ = band_plan(width, height, n_bands, tile)
    tx, ty = (width + tile - 1) // tile, (height + tile - 1) // tile
    lo, hi = band * n_local, (band + 1) * n_local
    real = tile_list[min(lo, tx * ty):min(hi, tx * ty)]
    if real.shape[0] == n_local:
        return real
    fill = torch.full((n_local - real.shape[0], tile_list.shape[1]), -1, dtype=tile_list.dtype,
                      device=tile_list.device)
    return torch.cat([real, fill])


def _band_geometry(band_list: Tensor, width: int, band: int, tile: int) -> tuple[int, int]:
    """(tile_base, band height) of band `band`'s tile list."""
    n_local = band_list.shape[0]
    return band * n_local, n_local // ((width + tile - 1) // tile) * tile


def band_hdr(setup: dict, coeff_mat: Tensor, band_list: Tensor, vm_instance: Tensor, gscene, entity_world: Tensor,
             materials, atlas: Tensor, lights, camera_pos: Tensor, ambient_color, width: int, height: int,
             band: int) -> tuple[Tensor, Tensor]:
    """Band `band` of `render_frame_sharded`'s frame (`band_list` from
    `band_tiles`): the decode path's raster at the band's tiles, the decode at
    the image's NDC rows, then `band_shade`. Returns (hdr (bh, W, 3), the
    band's luminance histogram over its rows inside the image)."""
    tile_base, bh = _band_geometry(band_list, width, band, TILE)
    _, vid = raster3d.rasterize_reference(coeff_mat, band_list, width, bh, tile_base=tile_base)
    gbuf = decode_visbuffer(vid, setup, vm_instance, gscene, entity_world, materials, atlas, width=width,
                            height=bh, row_offset=band * bh, full_height=height)
    return band_shade(gbuf, None, None, None, lights, camera_pos, ambient_color, height, band)


def band_gbuffer_production(rows: Tensor, n_slots: int, band_list: Tensor, ml_near_eo: Tensor,
                            inv_view_proj: Tensor, width: int, height: int, band: int, *, tile: int = TILE,
                            slot_rows: Tensor | None = None,
                            atlas: Tensor | None = None) -> tuple[dict, Tensor | None]:
    """Band `band` of `render_frame_sharded_production`'s frame up to its
    G-buffer: the group raster (kernel #7 on the card) at the band's tiles
    (`tile_base`), unpacked at the image's NDC rows. With `slot_rows` (G·R,
    32) and `atlas` (A, A, 4) u8 also the albedo's texture modulation at half
    resolution (bh/2, ⌈W/2⌉, 3), sampled through the packed float32 taps at
    every second pixel (1 where nothing was hit). Returns (G-buffer, the
    modulation or None)."""
    tile_base, bh = _band_geometry(band_list, width, band, tile)
    depth, vid, gb = rasterize_gbuffer_groups(rows, band_list, width, bh, n_slots, ml_near=ml_near_eo, tile=tile,
                                              tile_base=tile_base)
    ivp = torch.as_tensor(inv_view_proj, dtype=torch.float32, device=depth.device)
    gbuf = gbuffer_from_raster(gb, vid, depth, ivp, row_offset=band * bh, full_height=height)
    if slot_rows is None or atlas is None:
        return gbuf, None
    uv_h = point_downsample(gbuf["uv"].to(torch.float32), 2)
    vid_h = point_downsample(vid, 2)
    flat_h = torch.clamp((vid_h >> 8) * n_slots + (vid_h & 255), 0, slot_rows.shape[0] - 1)
    tex = sample_material_textures(slot_rows[flat_h.long()], pack_atlas_taps(atlas), atlas.shape[0], uv_h,
                                   features=("albedo",))
    return gbuf, torch.where((vid_h >= 0)[..., None], tex["albedo_rgb"], 1.0)


def band_shade(gbuf: dict, tex_h: Tensor | None, tex_above: Tensor | None, tex_below: Tensor | None, lights,
               camera_pos: Tensor, ambient_color, height: int, band: int) -> tuple[Tensor, Tensor]:
    """PBR of a band's G-buffer (bh, W). With a half-resolution modulation
    `tex_h`, the albedo is first multiplied by it resized to full resolution
    between the neighbouring bands' seam rows of theirs (`tex_above`,
    `tex_below` (1, ⌈W/2⌉, 3); None at the frame's top and bottom, where the
    resize clamps as on one card), so a seam textures as the single-card
    frame. Returns (hdr, the luminance histogram of the band's rows inside
    the image)."""
    bh, width = gbuf["albedo"].shape[:2]
    if tex_h is not None:
        padded = torch.cat([t for t in (tex_above, tex_h, tex_below) if t is not None])
        lo = 0 if tex_above is None else 2
        alb_mod = resize_linear(padded, (2 * padded.shape[0], width, 3))[lo:lo + bh]
        gbuf = dict(gbuf, albedo=gbuf["albedo"] * alb_mod)
    amb = torch.as_tensor(ambient_color, dtype=torch.float32, device=gbuf["albedo"].device)
    hdr = apply_pbr(gbuf, lights, camera_pos, amb)
    rows_in = max(0, min(bh, height - band * bh))
    return hdr, luminance_histogram(hdr[:rows_in], HIST_MIN_LOG2, HIST_INV_RANGE)


def band_ldr(hdr: Tensor, hist_total: Tensor, prev_luminance=1.0, dt=1.0 / 60.0,
             tonemapper: int = 1) -> tuple[Tensor, Tensor]:
    """Exposure from the frame's histogram (every band's, summed), then the
    tonemap of the band. Returns (ldr, new adapted luminance)."""
    prev = torch.as_tensor(prev_luminance, dtype=torch.float32, device=hdr.device)
    exposure, new_lum = adapt_exposure(hist_total, prev, dt)
    return apply_tonemap(hdr, tonemapper, exposure), new_lum


def band_fxaa(ldr: Tensor, above: Tensor | None, below: Tensor | None) -> Tensor:
    """FXAA of a band between its neighbours' seam rows (`above`, `below`
    (1, W, 3); None at the frame's top and bottom: the band's own edge row,
    as FXAA pads one card's frame)."""
    above = ldr[:1] if above is None else above
    below = ldr[-1:] if below is None else below
    return apply_fxaa(torch.cat([above, ldr, below]))[1:-1]


def exchange_halo(x: Tensor, group) -> tuple[Tensor | None, Tensor | None]:
    """(the row above, the row below) this rank's band `x`: rank i sends its
    last row to i + 1 and its first row to i − 1 in one batch of
    point-to-point operations; None past the first and the last rank."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    above = below = None
    ops = []
    if rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        above = torch.empty_like(x[:1])
        ops += [dist.P2POp(dist.isend, x[:1].contiguous(), peer, group),
                dist.P2POp(dist.irecv, above, peer, group)]
    if rank < size - 1:
        peer = dist.get_global_rank(group, rank + 1)
        below = torch.empty_like(x[-1:])
        ops += [dist.P2POp(dist.isend, x[-1:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, below, peer, group)]
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return above, below


def _join_bands(hdr: Tensor, hist: Tensor, group, height: int, prev_luminance, dt,
                tonemapper: int) -> tuple[Tensor, Tensor]:
    """The collectives after a band's HDR: histogram all-reduce, exposure and
    tonemap, halo exchange, FXAA, the bands all-gathered and cropped."""
    dist.all_reduce(hist, group=group)
    ldr, new_lum = band_ldr(hdr, hist, prev_luminance, dt, tonemapper)
    above, below = exchange_halo(ldr, group)
    return _gather_cat(band_fxaa(ldr, above, below), group)[:height], new_lum


def render_frame_sharded(setup: dict, coeff_mat: Tensor, tile_list: Tensor, vm_instance: Tensor, gscene,
                         entity_world: Tensor, materials, atlas: Tensor, lights, camera_pos: Tensor, ambient_color,
                         width: int, height: int, mesh, axis: str = "worlds", *, prev_luminance=1.0,
                         dt=1.0 / 60.0, tonemapper: int = 1) -> tuple[Tensor, Tensor]:
    """The decode path's frame core (raster → decode → PBR → exposure →
    tonemap → FXAA) split over the ranks by bands of 64-px tile rows, the
    tile rows padded to a multiple of the size. Geometry prep (cull, setup,
    binning) is the caller's and the same on every rank. Returns (ldr (H, W,
    3), new adapted luminance) on every rank: equal to the single-card chain
    but on the last `FXAA_REACH` row where the height is not a multiple of
    size · 64 (the last band's FXAA sees its rows past the image there
    instead of the edge row)."""
    group, rank, size = _group(mesh, axis)
    band_list = band_tiles(tile_list, width, height, size, rank)
    hdr, hist = band_hdr(setup, coeff_mat, band_list, vm_instance, gscene, entity_world, materials, atlas, lights,
                         camera_pos, ambient_color, width, height, rank)
    return _join_bands(hdr, hist, group, height, prev_luminance, dt, tonemapper)


def render_frame_sharded_production(rows: Tensor, n_slots: int, tile_list: Tensor, ml_near_eo: Tensor, lights,
                                    camera_pos: Tensor, ambient_color, inv_view_proj: Tensor, width: int,
                                    height: int, mesh, axis: str = "worlds", *, slot_rows: Tensor | None = None,
                                    atlas: Tensor | None = None, tile: int | None = None, prev_luminance=1.0,
                                    dt=1.0 / 60.0, tonemapper: int = 1) -> tuple[Tensor, Tensor]:
    """The group route's frame core split over the ranks by bands of tile
    rows: each band runs the group raster (kernel #7 on the card, one launch
    with the band's `tile_base`) and the G-buffer unpack at the image's rows
    (`band_gbuffer_production`), the optional textured albedo (its
    half-resolution seam rows exchanged with the neighbours) and PBR
    (`band_shade`), joined by the same collectives as
    `render_frame_sharded`. `rows` (G·R, ≥ 79) and
    `n_slots` R are one pass's dense groups as `raster3d.build_tile_comb`
    packs them (R is the JAX function's `raster_group`), `tile_list` (T, K)
    the groups binned per tile of `tile` px (32 or 64; None: 64), `ml_near_eo`
    (G,) the suffix-maxed near bounds. Returns (ldr (H, W, 3), new adapted
    luminance) on every rank: equal to the single-card chain but on the last
    `FXAA_REACH` rows (and `TEXTURE_REACH` more, textured) where the height is
    not a multiple of size · `tile`."""
    tile = tile or TILE
    group, rank, size = _group(mesh, axis)
    band_list = band_tiles(tile_list, width, height, size, rank, tile)
    gbuf, tex_h = band_gbuffer_production(rows, n_slots, band_list, ml_near_eo, inv_view_proj, width, height, rank,
                                          tile=tile, slot_rows=slot_rows, atlas=atlas)
    tex_above, tex_below = (None, None) if tex_h is None else exchange_halo(tex_h, group)
    hdr, hist = band_shade(gbuf, tex_h, tex_above, tex_below, lights, camera_pos, ambient_color, height, rank)
    return _join_bands(hdr, hist, group, height, prev_luminance, dt, tonemapper)

