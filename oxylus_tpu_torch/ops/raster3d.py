"""Tile G-buffer raster (counterpart of the tile path of `oxylus_tpu/ops/raster3d.py`).

Per tile of `tile`² pixels (`TILES`: 16, 32 or 64), the triangles binned to it
(`setup3d.bin_triangles_per_tile`) are resolved in rounds of 64 entries, front
to back: five plane evaluations per entry and pixel (edges e0 e1 e2, depth
numerator zn, w denominator wd), a cover
test, and a reverse-Z max over a packed key (z bits & ~127) | (127 − slot), with
an early-out once every pixel of the tile is nearer than anything the
remaining rounds can hold. Then the winner's 16 G-buffer lanes are evaluated
per pixel. vid = tile·256 + entry, so `flat = (vid >> 8)·K2 + (vid & 255)`
indexes the per-(tile, entry) slot tables. With `tile_base` the call rasters a
band of a larger image: its tile t is the image's tile t + tile_base, whose
coordinates place the planes and the attributes and whose id goes into vid,
while the outputs hold the band alone (the JAX signature's band sharding).

`rasterize_gbuffer_tiles` is the wrapper: for CPU tensors it runs the plain
PyTorch version `rasterize_tiles_reference`; for CUDA tensors the hand-written
kernel `csrc/raster_tiles.cu` (counted in `LAUNCHES`), or it raises. Both use
the same operation order, so they agree bit for bit (nvcc -fmad=false).

Plane values. The TPU kernel evaluates each plane at tile-local pixel centres
(k + 0.5) with the tile-local constant c' = (c + a·x0) + b·y0, as a bf16 matmul
of the hi/lo split of (a, b, c') against the exact pixel coordinates: every
product is exact and the float32 sum runs a_hi·x + b_hi·y + c'_hi + a_lo·x +
b_lo·y + c'_lo. The port computes exactly that sum (`_split_hilo`). Evaluating
the planes in plain float32 instead changes the resolved depth (bits & ~127) on
many covered pixels, because the hi/lo sum is only ~2^-17 accurate; this way
the depth matches the JAX package. Phase B's attribute
rows are evaluated in float32: the bf16 output absorbs the difference.

The kernel's input is the shared per-slot row matrix `comb` from
`build_tile_comb` and the entry lists: it reads each entry's row directly, so
`pack_tile_blocks` gathers only the slot tables and the per-round nearest-z
table, not the TPU kernel's per-(tile, round) plane blocks.

The kernel runs a 64² tile as a cluster of 4 CTAs, one per SUB² sub-tile,
which take the early-out together (tile-wide, round by round); a 32² or 16²
tile is one CTA (`cta_side`, `cluster_size`). It skips a slot in a CTA's
square, then in each warp's WARP_W × WARP_H block, only where a plane proves
it covers no pixel centre there (`tile_region_reject`, `tile_warp_reject`; the
test the depth raster uses, `plane_region_reject`, with the margin's span the
tile's, `tile - 0.5`).
`tile_work` counts what that rule evaluates. The main path does not call
them: they are plain mirrors of the kernel's rules for the tests
(`tests/test_torch_raster_tiles_reject.py`) and `chip_smoke.py`.

`rasterize_reference` is the decode path's raster (`RenderSpec(use_pallas=
False)`), a port of the JAX package's XLA function of that name, which that
path runs on every device: depth and vid = (vm << 8) | slot over per-tile
meshlet lists, the planes in float32 at global pixel centres. It is not the
plain version of a kernel. It and the depth raster's plain version
(`raster_depth.rasterize_depth_reference`) walk the live (tile, entry) pairs
with one walk (`walk_live_pairs`, `fold_live_pairs`), each with its own plane
evaluation and chunk size.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

TILE = 64
TILES = (16, 32, 64)  # tile edges the tile raster takes
TILE_ROUND = 64   # entries resolved per round
MAX_K2 = 256      # entries per tile at most: vid's entry field is 8 bits
N_GB_ATTR = 16    # G-buffer lanes: [nrm xyz, uv, tangent xyz, alb rgb, metallic, roughness, emissive rgb]
ATTR_W = 64       # per-slot attribute row: [a(16) | b(16) | c(16) | consts(16)]
COMB_W = ATTR_W + 15 + 4  # comb row: attrB 64 | coeffs 15 | tz | material | instance | packed id
PLANE_OFF = ATTR_W       # the 15 plane coefficients, plane-major (e0 e1 e2 zn wd) × (a b c)
TILES_PER_CHUNK = 16     # plain version: 64² tiles evaluated together (more of a smaller tile)
N_DEPTH_PLANES = 5       # rasterize_reference's planes: e0 e1 e2 | zn wd
REF_CHUNK_BYTES = 1 << 29  # rasterize_reference: the largest temporary of one chunk of tiles
SUB = 32                 # the kernel's sub-tile side: one CTA of a 64² tile's cluster each
WARP_W, WARP_H = 16, 8   # a warp's block of the CTA's square
# the reject's margin: 2^-20 of the plane terms' magnitudes over the tile (the
# pixel coordinates bounded by the tile's last centre, tile - 0.5), plus
# 2^-126 for underflow (the bound is derived in csrc/plane_reject.cuh)
REJECT_MARGIN_SCALE, REJECT_MARGIN_FLOOR = 2.0**-20, 2.0**-126

LAUNCHES = 0


def check_tile(tile: int) -> None:
    """Raise `ValueError` for a tile edge the tile raster does not take."""
    if tile not in TILES:
        raise ValueError(f"tile={tile}: the tile raster takes tiles of {', '.join(map(str, TILES))} px")


def cta_side(tile: int) -> int:
    """The side of the square one CTA of the kernel rasters: a 32² sub-tile of
    a 64² tile's cluster, else the whole tile."""
    return min(tile, SUB)


def cluster_size(tile: int) -> int:
    """CTAs per tile: 4 (a thread-block cluster) at 64, else 1."""
    return (tile // cta_side(tile)) ** 2


def _tile_origins(tiles: Tensor, tile: int, width: int) -> tuple[Tensor, Tensor]:
    """Float32 pixel origins (x0, y0) of the image's tiles `tiles` (global ids)."""
    tx = (width + tile - 1) // tile
    x0 = (tiles % tx) * tile
    return x0.to(torch.float32), (torch.div(tiles, tx, rounding_mode="floor") * tile).to(torch.float32)


def pack_gbuffer_coeff_matrix(attr_planes: Tensor, mat_consts: Tensor) -> Tensor:
    """The attribute rows attrB (VM·R, 64) of the JAX function of this name: four
    16-lane groups [a₀…a₇ ssₐ 0×7 | b₀…b₇ ss_b 0×7 | c₀…c₇ ss_c 0×7 | consts×8 0×8],
    so attr = a·px + b·py + c evaluates the 8 perspective planes plus the
    ss = Σeᵢ divisor in lane 8, and the fourth group carries the material
    constants. Its phase-A plane matrix is MXU layout: the port's raster reads
    the planes from the slot rows."""
    vm, r = attr_planes.shape[0], attr_planes.shape[1]
    ap = attr_planes[:, :, 1:9, :]
    ssp = attr_planes[:, :, 0, :]
    z7 = torch.zeros((vm, r, 7), dtype=ap.dtype, device=ap.device)
    z8 = torch.zeros((vm, r, 8), dtype=ap.dtype, device=ap.device)
    if mat_consts.dim() == 2:
        consts = mat_consts[:, None, :].expand(vm, r, 8).to(ap.dtype)
    else:
        consts = mat_consts.to(ap.dtype)
    attr_b = torch.cat(
        [ap[..., 0], ssp[..., 0:1], z7, ap[..., 1], ssp[..., 1:2], z7, ap[..., 2], ssp[..., 2:3], z7, consts, z8],
        dim=-1,
    )
    return attr_b.reshape(vm * r, ATTR_W)


def build_tile_comb(dense: dict, consts: Tensor) -> Tensor:
    """The per-slot row matrix every raster pass reads, (G·R, 83):
    [attrB 64 | coeff 15 | tz | material | instance | packed id]. Built once per
    frame from the full visible set and shared by the passes; a pass's entries
    only reference slots valid in that pass, so sharing is exact."""
    g, r = dense["tri_valid"].shape
    attr_b = pack_gbuffer_coeff_matrix(dense["attr_planes"], consts)
    parts = [
        attr_b.reshape(g, r, ATTR_W),
        dense["coeffs"].reshape(g, r, 15),
        dense["tri_z"][..., None],
        dense["slot_material"].to(torch.float32)[..., None],
        dense["slot_instance"].to(torch.float32)[..., None],
        dense["packed_id"].to(torch.float32)[..., None],  # < 2^24, f32-exact
    ]
    return torch.cat(parts, dim=-1).reshape(g * r, COMB_W).contiguous()


def pack_tile_blocks(entries: Tensor, comb: Tensor) -> dict:
    """Per-(tile, entry) inputs of the raster and the downstream slot tables.

    Returns dict:
      entries (T, K2) i32 — flat slot ids into `comb` or -1
      comb    (G·R, 83) f32 — the shared slot rows (not copied)
      near_r  (T, ROUNDS) i32 — suffix-max nearest-z bit patterns per round
      tables  (material, instance, packed_id) per (tile, entry), each (T·K2,),
              equal to the JAX package's
    """
    t_n, k2 = entries.shape
    if k2 % TILE_ROUND != 0 or k2 > MAX_K2:
        raise ValueError(f"k2 = {k2}: must be a multiple of {TILE_ROUND} and at most {MAX_K2} (vid's entry field "
                         "is 8 bits)")
    rounds = k2 // TILE_ROUND
    have = entries >= 0
    d = comb[torch.clamp(entries, min=0).reshape(-1).long(), PLANE_OFF + 15 :]  # (T·K2, 4)
    tz_e = torch.where(have, d[:, 0].reshape(t_n, k2), -1.0)
    near_round = torch.clamp(tz_e, min=0.0).reshape(t_n, rounds, TILE_ROUND).max(-1).values
    near_sfx = torch.flip(torch.cummax(torch.flip(near_round, [1]), 1).values, [1])
    tables = (
        torch.where(have, d[:, 1].reshape(t_n, k2).to(torch.int32), 0).reshape(-1),
        torch.where(have, d[:, 2].reshape(t_n, k2).to(torch.int32), 0).reshape(-1),
        torch.where(have, d[:, 3].reshape(t_n, k2).to(torch.int32), -1).reshape(-1),
    )
    return {
        "entries": entries.to(torch.int32).contiguous(),
        "comb": comb,
        "near_r": near_sfx.contiguous().view(torch.int32),
        "tables": tables,
    }


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _tile_local_pixels(device, tile: int = TILE) -> tuple[Tensor, Tensor]:
    lin = torch.arange(tile * tile, device=device)
    return (lin % tile).to(torch.float32) + 0.5, torch.div(lin, tile, rounding_mode="floor").to(torch.float32) + 0.5


def _split_hilo(x: Tensor) -> tuple[Tensor, Tensor]:
    """x ≈ hi + lo with hi = bf16(x) and lo = bf16(x − hi), both round to nearest even."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _raster_tiles_plain(entries: Tensor, comb: Tensor, counts: Tensor, near_r: Tensor, width: int, height: int,
                        tile: int = TILE, tile_base: int = 0):
    """Plain version, vectorised over (tiles, 64 entries, tile² pixels) in
    chunks of tiles, in the kernel's operation order. Tile t of the input is
    tile t + `tile_base` of the image: its planes and attributes use that
    tile's pixel coordinates and vid its id. Returns (depth, vid, gb,
    rounds_run (T,) i32, covered (T,) i64), the last two the rounds each tile
    ran and the covered (entry, pixel) pairs in them, which measure the work
    this input needs."""
    dev = entries.device
    t_n, k2 = entries.shape
    rounds = k2 // TILE_ROUND
    pix = tile * tile
    tx = (width + tile - 1) // tile
    ty = (height + tile - 1) // tile
    xl, yl = _tile_local_pixels(dev, tile)
    slot_code = (127 - torch.arange(TILE_ROUND, dtype=torch.int32, device=dev))[None, :, None]
    depth_t = torch.empty((t_n, pix), dtype=torch.float32, device=dev)
    vid_t = torch.empty((t_n, pix), dtype=torch.int32, device=dev)
    gb_t = torch.empty((t_n, pix, N_GB_ATTR), dtype=torch.bfloat16, device=dev)
    rounds_run = torch.zeros(t_n, dtype=torch.int32, device=dev)
    covered = torch.zeros(t_n, dtype=torch.int64, device=dev)
    chunk = TILES_PER_CHUNK * (TILE * TILE // pix)
    for c0 in range(0, t_n, chunk):
        c1 = min(c0 + chunk, t_n)
        tg = torch.arange(c0, c1, device=dev) + tile_base  # the image's tile ids
        x0, y0 = (o[:, None, None] for o in _tile_origins(tg, tile, width))
        rounds_n = torch.div(counts[c0:c1] + TILE_ROUND - 1, TILE_ROUND, rounding_mode="floor")
        key = torch.zeros((c1 - c0, pix), dtype=torch.int32, device=dev)
        vid = torch.full((c1 - c0, pix), -1, dtype=torch.int32, device=dev)
        active = torch.ones(c1 - c0, dtype=torch.bool, device=dev)
        for r0 in range(rounds):
            dmin = key.min(1).values & ~127
            active = active & (r0 < rounds_n) & (dmin < near_r[c0:c1, min(r0, rounds - 1)])
            rounds_run[c0:c1] += active.to(torch.int32)
            ent = entries[c0:c1, r0 * TILE_ROUND : (r0 + 1) * TILE_ROUND]  # (C, 64)
            co = comb[torch.clamp(ent, min=0).long(), PLANE_OFF : PLANE_OFF + 15]
            co = torch.where((ent >= 0)[..., None], co, 0.0).reshape(c1 - c0, TILE_ROUND, 5, 3)
            a, b, c = co[..., 0], co[..., 1], co[..., 2]  # (C, 64, 5)
            c = torch.where((ent >= 0)[..., None] | (torch.arange(5, device=dev) > 0), c, -1e30)
            cp = (c + x0 * a) + y0 * b  # tile-local constant
            (a_h, a_l), (b_h, b_l), (c_h, c_l) = (_split_hilo(v[..., None]) for v in (a, b, cp))
            e = ((((a_h * xl + b_h * yl) + c_h) + a_l * xl) + b_l * yl) + c_l  # (C, 64, 5, PIX)
            e0, e1, e2, zn, wd = e.unbind(2)
            m = torch.minimum(torch.minimum(e0, e1), e2)
            q = torch.minimum(torch.minimum(m, zn), torch.minimum(wd - zn, wd - 1e-30))
            cover = q >= 0
            covered[c0:c1] += (cover & active[:, None, None]).sum((1, 2))
            z = zn * (1.0 / torch.clamp(wd, min=1e-30))
            zi = (z.view(torch.int32) & ~127) | slot_code
            keyk = torch.where(cover, zi, -1).max(1).values  # (C, PIX)
            better = (keyk > key) & active[:, None]
            won = (tg[:, None] * 256 + r0 * TILE_ROUND + (127 - (keyk & 127))).to(torch.int32)
            vid = torch.where(better, won, vid)
            key = torch.where(better, keyk, key)
        depth_t[c0:c1] = (key & ~127).view(torch.float32)
        vid_t[c0:c1] = vid

        # phase B: the winner's attribute row, evaluated at global pixel centres
        hit = vid >= 0
        entry = torch.where(hit, vid - tg[:, None].to(torch.int32) * 256, 0).long()
        row = torch.gather(entries[c0:c1].long(), 1, entry)
        row = torch.where(hit, row, 0).clamp(min=0)
        attr = comb[row, :ATTR_W]  # (C, PIX, 64)
        attr = torch.where(hit[..., None], attr, 0.0)
        px = (x0[:, :, 0] + xl)[..., None]
        py = (y0[:, :, 0] + yl)[..., None]
        lanes = (attr[..., 0:16] * px + attr[..., 16:32] * py) + attr[..., 32:48]
        ssb = lanes[..., 8:9]
        rw = 1.0 / torch.where(torch.abs(ssb) > 1e-12, ssb, 1.0)
        gb_t[c0:c1, :, 0:8] = (lanes[..., 0:8] * rw).to(torch.bfloat16)
        gb_t[c0:c1, :, 8:16] = attr[..., 48:56].to(torch.bfloat16)

    def untile(a):
        a = a.reshape(ty, tx, tile, tile, *a.shape[2:]).transpose(1, 2)
        return a.reshape(ty * tile, tx * tile, *a.shape[4:])[:height, :width].contiguous()

    return untile(depth_t), untile(vid_t), untile(gb_t), rounds_run, covered


def rasterize_tiles_reference(entries, comb, counts, near_r, width, height, tile=TILE, tile_base=0):
    """The plain PyTorch version of the CUDA kernel: (depth, vid, gb)."""
    return _raster_tiles_plain(entries, comb, counts, near_r, width, height, tile, tile_base)[:3]


def plane_region_reject(ah, al, bh, bl, ch, cl, is_wd, rw: int, rh: int, tile: int = TILE) -> Tensor:
    """The kernels' reject test of planes given by their hi/lo parts (each
    (...,), tile-local constant), over the rw × rh regions of a tile of
    `tile`² pixels: (..., tile // rh, tile // rw) bool, True where the plane,
    evaluated as the pixels evaluate it at the region's four corner centres,
    is below -margin at all four (e0, e1, e2, zn), or at or below it where
    `is_wd`, with margin = ((|a_h| + |a_l| + |b_h| + |b_l|) · (tile - 0.5) +
    |c'_h| + |c'_l|) · 2^-20 + 2^-126 finite."""
    margin = (((((ah.abs() + al.abs()) + bh.abs()) + bl.abs()) * (tile - 0.5) + ch.abs()) + cl.abs()) \
        * REJECT_MARGIN_SCALE + REJECT_MARGIN_FLOOR
    dev = ah.device
    lo_x = torch.arange(tile // rw, dtype=torch.float32, device=dev) * rw + 0.5
    lo_y = torch.arange(tile // rh, dtype=torch.float32, device=dev)[:, None] * rh + 0.5
    ex = lambda v: v[..., None, None]
    ah, al, bh, bl, ch, cl, mg = map(ex, (ah, al, bh, bl, ch, cl, -margin))
    below = at_or_below = None
    for cx in (lo_x, lo_x + (rw - 1)):
        for cy in (lo_y, lo_y + (rh - 1)):
            e = ((((ah * cx + bh * cy) + ch) + al * cx) + bl * cy) + cl
            lt, le = e < mg, e <= mg
            below = lt if below is None else below & lt
            at_or_below = le if at_or_below is None else at_or_below & le
    return torch.where(ex(is_wd), at_or_below, below) & torch.isfinite(mg)


def tile_region_reject(entries: Tensor, comb: Tensor, width: int, rw: int, rh: int, tile: int = TILE,
                       tile_base: int = 0) -> Tensor:
    """The tile raster's reject over the rw × rh regions of each tile: (tiles,
    K2, tile // rh, tile // rw) bool, True where a plane of entry k's slot (a
    missing entry: a = b = 0 and e0's constant -1e30, as the kernel stages it)
    proves, by `plane_region_reject`, that it covers no pixel centre of the
    region."""
    dev = entries.device
    t_n, k2 = entries.shape
    x0, y0 = (o[:, None, None] for o in _tile_origins(torch.arange(t_n, device=dev) + tile_base, tile, width))
    have = (entries >= 0)[..., None]
    co = comb[torch.clamp(entries, min=0).long(), PLANE_OFF : PLANE_OFF + 15]
    co = torch.where(have, co, 0.0).reshape(t_n, k2, 5, 3)
    a, b, c = co[..., 0], co[..., 1], co[..., 2]  # (T, K2, 5)
    c = torch.where(have | (torch.arange(5, device=dev) > 0), c, -1e30)
    cp = (c + x0 * a) + y0 * b
    (ah, al), (bh, bl), (ch, cl) = (_split_hilo(v) for v in (a, b, cp))
    is_wd = torch.arange(5, device=dev) == 4
    return plane_region_reject(ah, al, bh, bl, ch, cl, is_wd, rw, rh, tile).any(2)


def tile_warp_reject(entries: Tensor, comb: Tensor, width: int, tile: int = TILE, tile_base: int = 0) -> Tensor:
    """The slots each warp of the tile raster skips: (tiles, K2, tile // WARP_H,
    tile // WARP_W) bool over the tile's WARP_W × WARP_H blocks, one per warp:
    what its CTA's square (`cta_side`) rejects and what the same test at its
    own block's corners does."""
    side = cta_side(tile)
    sub = tile_region_reject(entries, comb, width, side, side, tile, tile_base)
    sub = sub.repeat_interleave(side // WARP_H, 2).repeat_interleave(side // WARP_W, 3)
    return sub | tile_region_reject(entries, comb, width, WARP_W, WARP_H, tile, tile_base)


def tile_work(entries: Tensor, comb: Tensor, rounds_run: Tensor, width: int, tile: int = TILE,
              tile_base: int = 0) -> dict[str, int]:
    """What the tile raster does in the rounds each tile ran (`rounds_run`, from
    `_raster_tiles_plain`): `real`, the entries ≥ 0 of those rounds; `region_tests`,
    one reject test per (real entry, CTA); `evaluated`, the (entry, pixel)
    pairs at which a warp evaluates the planes, each warp block's slots that
    `tile_warp_reject` keeps at its WARP_W·WARP_H pixels; and the grid, `clusters`
    (one per tile), `cluster` (CTAs a tile) and `ctas`."""
    t_n, k2 = entries.shape
    ran = torch.div(torch.arange(k2, device=entries.device), TILE_ROUND, rounding_mode="floor")[None] \
        < rounds_run[:, None]
    real = int(((entries >= 0) & ran).sum())
    kept = ~tile_warp_reject(entries, comb, width, tile, tile_base) & ran[:, :, None, None]
    n_cta = cluster_size(tile)
    return {"real": real, "region_tests": real * n_cta, "evaluated": int(kept.sum()) * WARP_W * WARP_H,
            "clusters": t_n, "cluster": n_cta, "ctas": t_n * n_cta}


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _raster_tiles_cuda(entries, comb, counts, near_r, width, height, tile, tile_base):
    """Launch `raster_tiles` on PyTorch's current stream. Raises on a build or
    launch error; never falls back."""
    from .._build import load_kernel_library

    lib = load_kernel_library()
    t_n, k2 = entries.shape
    dev = entries.device
    for name, t, dt in (("entries", entries, torch.int32), ("comb", comb, torch.float32),
                        ("counts", counts, torch.int32), ("near_r", near_r, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {dev}")
    if comb.dim() != 2 or comb.shape[1] != COMB_W or near_r.shape != (t_n, k2 // TILE_ROUND) or counts.shape != (t_n,):
        raise ValueError("bad raster input shapes")
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    vid = torch.empty((height, width), dtype=torch.int32, device=dev)
    gb = torch.empty((height, width, N_GB_ATTR), dtype=torch.bfloat16, device=dev)
    err = lib.raster_tiles(
        entries.data_ptr(), comb.data_ptr(), counts.data_ptr(), near_r.data_ptr(),
        t_n, k2, width, height, tile, tile_base, depth.data_ptr(), vid.data_ptr(), gb.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"raster_tiles launch failed: {lib.kernel_error_string(err).decode()}")
    return depth, vid, gb


def _untile(a: Tensor, width: int, height: int) -> Tensor:
    tx, ty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    a = a.reshape(ty, tx, TILE, TILE).transpose(1, 2)
    return a.reshape(ty * TILE, tx * TILE)[:height, :width].contiguous()


def walk_live_pairs(coeff_mat: Tensor, tile_list: Tensor, live: Tensor, planes, chunk: int, k0: int = 0,
                    k1: int | None = None):
    """The (tile, entry) pairs that `live` (T, K) marks, with k0 ≤ entry < k1,
    entry by entry, at most `chunk` tiles together, listed in one host read:
    yields (tiles (C,), entry k, meshlets (C,) = max(tile_list[t, k], 0),
    cover (C, n, PIX), z (C, n, PIX), -1 where a slot does not cover).
    `planes(blk, tiles, n)` gives the planes e0 e1 e2 zn wd (C, 5, n, PIX) of
    the first n slots of the (C, 3, 5R) blocks at the tiles' pixels; a slot
    covers where e0, e1, e2 ≥ 0, wd > 0 and 0 ≤ zn ≤ wd, and its depth is
    zn / wd. A chunk is evaluated only up to its meshlets' last real slot: an
    invalid slot's e0 is the constant -1e30 (a = b = 0), it covers nothing,
    so the slots past it change neither the largest depth nor its first
    slot."""
    dev = coeff_mat.device
    r = coeff_mat.shape[-1] // N_DEPTH_PLANES
    e0 = coeff_mat[:, :, :r]
    real = ~((e0[:, 0] == 0) & (e0[:, 1] == 0) & (e0[:, 2] < 0))
    n_real = torch.where(real, torch.arange(r, device=dev) + 1, 0).max(1).values  # one past the last real slot
    ks = torch.arange(live.shape[1], device=dev)
    live = live & (ks >= k0) & (ks < (live.shape[1] if k1 is None else k1))
    k_idx, t_idx = torch.nonzero(live.t(), as_tuple=True)
    vm_all = torch.clamp(tile_list[t_idx, k_idx], min=0).long()
    host_k, host_n = torch.stack([k_idx, n_real[vm_all]]).tolist()
    start = 0
    while start < len(host_k):
        stop = start + 1
        while stop < len(host_k) and stop - start < chunk and host_k[stop] == host_k[start]:
            stop += 1
        n = max(host_n[start:stop])
        if n:
            tg, vm = t_idx[start:stop], vm_all[start:stop]
            e0, e1, e2, zn, wd = planes(coeff_mat[vm], tg, n).unbind(1)
            cover = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (wd > 0) & (zn >= 0) & (zn <= wd)
            yield tg, host_k[start], vm, cover, torch.where(cover, zn / torch.where(wd > 0, wd, 1.0), -1.0)
        start = stop


def fold_live_pairs(pairs, n_tiles: int, width: int, height: int, device) -> tuple[Tensor, Tensor]:
    """Fold `walk_live_pairs`' pairs into (depth (H, W) f32 reverse-Z, 0 far …
    1 near; vid (H, W) i32 = (vm << 8) | slot, -1 empty): an entry's winner
    is the first slot of the largest depth, and it replaces a pixel only
    where strictly nearer."""
    depth, vid = fold_live_pairs_tiled(pairs, n_tiles, device)
    return _untile(depth, width, height), _untile(vid, width, height)


def fold_live_pairs_tiled(pairs, n_tiles: int, device) -> tuple[Tensor, Tensor]:
    """`fold_live_pairs` in the tiles' layout: (depth, vid) (n_tiles, 64²),
    row t the pixels of the walked tile list's tile t, row-major."""
    depth = torch.zeros((n_tiles, TILE * TILE), dtype=torch.float32, device=device)
    vid = torch.full((n_tiles, TILE * TILE), -1, dtype=torch.int32, device=device)
    for tg, _, vm, _, zm in pairs:
        best = zm.max(1).values  # (C, PIX)
        slot = torch.arange(zm.shape[1], dtype=torch.int32, device=device)[None, :, None]
        arg = torch.where(zm >= best[:, None], slot, 1 << 20).min(1).values
        better = best > depth[tg]
        depth[tg] = torch.where(better, best, depth[tg])
        vid[tg] = torch.where(better, (vm.to(torch.int32) << 8)[:, None] | arg, vid[tg])
    return depth, vid


def _fma_planes(px: Tensor, py: Tensor, blk: Tensor, n: int) -> Tensor:
    """(C, 5, n, PIX) f32: the planes px·a + py·b + c of the first n slots of
    the (C, 3, 5R) blocks, rounded as XLA's CPU dot over (px, py, 1) does, a
    fused multiply-add chain: round(fma(py, b, round(px·a)) + c), the fused
    step formed exactly in float64."""
    c_n = blk.shape[0]
    r = blk.shape[-1] // N_DEPTH_PLANES
    a, b, c = (blk[:, i].reshape(c_n, N_DEPTH_PLANES, r)[..., :n, None] for i in range(3))
    t1 = px * a
    t2 = (py.double() * b.double() + t1.double()).float()
    return t2 + c


def rasterize_reference(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int,
                        tile_base: int = 0) -> tuple[Tensor, Tensor]:
    """Depth and vid of the meshlets listed per 64² tile (the JAX package's
    `rasterize_reference`): `coeff_mat` (VM, 3, 5R) from
    `raster_depth.pack_coeff_matrix`, `tile_list` (T, K) meshlet or -1.
    Every entry ≥ 0 is folded, in order of k (`fold_live_pairs`), its planes
    in float32 at global pixel centres. Returns (depth (H, W) f32, vid (H, W)
    i32).

    With `tile_base` the call rasters a band of a taller image: tile t of the
    list is the image's tile t + `tile_base` (its planes are evaluated at that
    tile's pixels), and `height` is the band's, a multiple of 64 but for the
    image's last band (the band form of the JAX sharded frames' shard body).

    The pairs are walked in chunks of tiles whose largest temporary (the
    float64 fused step over every slot) stays within `REF_CHUNK_BYTES`; the
    tiles are independent, so the chunking does not change the result."""
    tx, ty = (width + TILE - 1) // TILE, (height + TILE - 1) // TILE
    if tile_list.shape[0] != tx * ty:
        raise ValueError(f"{tile_list.shape[0]} tile rows for a {width}×{height} image")
    depth, vid = rasterize_reference_tiles(coeff_mat, tile_list, width, tile_base)
    return _untile(depth, width, height), _untile(vid, width, height)


def rasterize_reference_tiles(coeff_mat: Tensor, tile_list: Tensor, width: int,
                              tile_base: int = 0) -> tuple[Tensor, Tensor]:
    """`rasterize_reference` left in the tiles' layout: (depth, vid)
    (T, 64²), row t the pixels of the image's tile t + `tile_base`, which may
    be any run of tiles (a block of the tile list split by tiles, not rows),
    tiles past the image included."""
    dev = coeff_mat.device
    if int(tile_base) < 0:
        raise ValueError(f"tile_base={tile_base}: a band starts at a tile id >= 0")
    tx = (width + TILE - 1) // TILE
    if coeff_mat.shape[0] == 0:
        tile_list = tile_list[:, :0]
    lin = torch.arange(TILE * TILE, device=dev)
    lx, ly = lin % TILE, torch.div(lin, TILE, rounding_mode="floor")

    def planes(blk: Tensor, tg: Tensor, n: int) -> Tensor:
        tg = tg + int(tile_base)
        px = ((tg % tx) * TILE)[:, None, None, None] + lx
        py = (torch.div(tg, tx, rounding_mode="floor") * TILE)[:, None, None, None] + ly
        return _fma_planes(px.to(torch.float32) + 0.5, py.to(torch.float32) + 0.5, blk, n)

    chunk = max(1, REF_CHUNK_BYTES // (coeff_mat.shape[-1] * TILE * TILE * 8))
    pairs = walk_live_pairs(coeff_mat, tile_list, tile_list >= 0, planes, chunk)
    return fold_live_pairs_tiled(pairs, tile_list.shape[0], dev)


def run_tiles(entries, comb, counts, near_r, width, height, tile=TILE, tile_base=0):
    """Device dispatch: the CUDA kernel for tensors on a card (counted in
    `LAUNCHES`), the plain version for tensors on the CPU, nothing else. A
    tile outside `TILES` or a negative `tile_base` raises first."""
    global LAUNCHES
    check_tile(tile)
    if tile_base < 0:
        raise ValueError(f"tile_base={tile_base}: a band starts at a tile id >= 0")
    if entries.is_cuda:
        out = _raster_tiles_cuda(entries, comb, counts, near_r, width, height, tile, tile_base)
        LAUNCHES += 1
        return out
    if entries.device.type == "cpu":
        return rasterize_tiles_reference(entries, comb, counts, near_r, width, height, tile, tile_base)
    raise ValueError(f"no raster implementation for device {entries.device}")


def rasterize_gbuffer_tiles(blocks: dict, counts: Tensor, width: int, height: int, tile: int = TILE,
                            tile_base: int = 0):
    """The tile raster over `pack_tile_blocks` output, at a tile edge of
    `TILES` (any other raises `ValueError`). The input's tiles are the image's
    tiles `tile_base` on, covering `width` × `height` (a band of a larger image
    with `tile_base` > 0). Returns (depth (H, W) f32 reverse-Z, vid (H, W) i32
    = (t + tile_base)·256 + entry or -1, gb (H, W, 16) bf16)."""
    check_tile(tile)
    tile_base = int(tile_base)
    tx, ty = (width + tile - 1) // tile, (height + tile - 1) // tile
    if blocks["entries"].shape[0] != tx * ty:
        raise ValueError(f"{blocks['entries'].shape[0]} tiles for a {width}×{height} image at tile {tile}")
    return run_tiles(blocks["entries"], blocks["comb"], counts.to(torch.int32).contiguous(),
                     blocks["near_r"], width, height, tile, tile_base)


def gbuffer_from_raster(gb: Tensor, vid: Tensor, depth: Tensor, inv_view_proj: Tensor, row_offset: float = 0.0,
                        full_height: int | None = None) -> dict[str, Tensor]:
    """Unpack the (H, W, 16) bf16 attribute image into the G-buffer dict; world
    position is reconstructed from the f32 depth through the inverse
    view-projection. For a band of a taller image, `row_offset` is the global
    row of the band's first row and `full_height` the image's height (the
    NDC rows are the image's)."""
    hit = vid >= 0
    hitf = hit[..., None]
    g = lambda sl: gb[sl].to(torch.float32)
    nrm = g((..., slice(0, 3)))
    nrm = nrm / torch.clamp(torch.sqrt(torch.sum(nrm * nrm, dim=-1, keepdim=True)), min=1e-9)
    h, w = depth.shape
    ndc_x = (torch.arange(w, dtype=torch.float32, device=depth.device)[None, :] + 0.5) * (2.0 / w) - 1.0
    fh = h if full_height is None else full_height
    rows = torch.full((), float(row_offset), device=depth.device) + torch.arange(h, dtype=torch.float32,
                                                                                 device=depth.device)
    ndc_y = (rows[:, None] + 0.5) * (2.0 / fh) - 1.0
    m = inv_view_proj
    hx = m[0, 0] * ndc_x + m[0, 1] * ndc_y + m[0, 2] * depth + m[0, 3]
    hy = m[1, 0] * ndc_x + m[1, 1] * ndc_y + m[1, 2] * depth + m[1, 3]
    hz = m[2, 0] * ndc_x + m[2, 1] * ndc_y + m[2, 2] * depth + m[2, 3]
    hw = m[3, 0] * ndc_x + m[3, 1] * ndc_y + m[3, 2] * depth + m[3, 3]
    inv_w = 1.0 / torch.where(torch.abs(hw) > 1e-12, hw, 1.0)
    wpos = torch.stack([hx * inv_w, hy * inv_w, hz * inv_w], dim=-1)
    return {
        "hit": hit,
        "world_pos": torch.where(hitf, wpos, 0.0),
        "normal": torch.where(hitf, nrm, 0.0),
        "uv": g((..., slice(3, 5))),
        "tangent": torch.where(hitf, g((..., slice(5, 8))), 0.0),
        "albedo": torch.where(hitf, g((..., slice(8, 11))), 0.0),
        "metallic": torch.where(hit, g((..., 11)), 0.0),
        "roughness": torch.where(hit, g((..., 12)), 1.0),
        "emissive": torch.where(hitf, g((..., slice(13, 16))), 0.0),
        "occlusion": torch.ones_like(depth),
    }
