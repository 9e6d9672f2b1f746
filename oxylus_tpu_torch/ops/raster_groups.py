"""Group-hit G-buffer raster (counterpart of `rasterize_gbuffer_pallas` in
`oxylus_tpu/ops/raster3d.py`, the renderer's `raster_path="group"`).

Per tile of `tile`² pixels (32 or 64), the tile's list of dense triangle
groups (`setup3d.compact_triangles` or `passthrough_groups`, binned by
`setup3d.bin_meshlets_to_tiles`) is walked front to back. Phase A, per group
k: the five planes (edges e0 e1 e2, depth numerator zn, w denominator wd) of
all R slots at the tile's pixels, a slot covers where min(e0, e1, e2, zn,
wd − zn, wd − 1e-30) ≥ 0, its key is (bits(zn · (1 / max(wd, 1e-30))) & ~127)
| (127 − slot), the largest key of the group wins the pixel where it is
strictly larger than the pixel's key so far (the earlier group wins a tie, the
lower slot within a group), and vid = group·256 + slot. Before each group the
walk stops once the smallest key of the tile, its pixels past the image edge
included, is at least the group's near bound (the early-out; `kstop` groups
walked). Phase B: each hit pixel evaluates its winner's attribute row
(a·px + b·py) + c at global pixel centres, lanes 0-7 divided by lane 8 (ss,
where |ss| > 1e-12) and lanes 8-15 the material constants, all as bf16.
Depth is the key with its low 7 bits cleared; pixels with no hit get depth 0,
vid -1 and zero lanes.

Plane values are the TPU kernel's: the tile-local constant c' = (c + x0·a) +
y0·b, then a, b and c' each split into bf16 hi and lo parts, summed as
a_hi·x + b_hi·y + c'_hi + a_lo·x + b_lo·y + c'_lo at tile-local centres
(`raster3d._split_hilo`), as the port's tile raster does.

The input is the per-slot row matrix of `raster3d.build_tile_comb` built from
one pass's dense groups: [attrB 64 | coeff 15 | …], slot s of group g at row
g·R + s. The TPU package has two kernels for this function, which differ only
in phase B: the resident one (`_make_gbuffer_kernel_resident`) selects the
winner's coefficients as bf16 hi + bf16(a − hi), exact to ~2^-16; the streamed
one (`_make_gbuffer_kernel`) as bf16 hi + the float32 rest, which is the
float32 coefficient. Which one runs is a TPU VMEM-budget decision
(`VMEM_BUDGET_BYTES`). One CUDA kernel, `csrc/raster_groups.cu`, replaces
both: it reads the winner's float32 row, so it computes the streamed one.

`rasterize_gbuffer_groups` is the wrapper: it builds the per-(tile, k) near
table, then CPU tensors take the plain PyTorch version
`rasterize_groups_reference`, CUDA tensors the kernel (counted in
`LAUNCHES`), anything else raises. Both compute the same operations in the
same order (nvcc -fmad=false), so they agree exactly.

The kernel spreads a 64² tile over a cluster of 4 CTAs (one per 32²
sub-tile; a 32² tile is one CTA), each warp a WARP_W × WARP_H block, and
skips a slot for a sub-tile or a warp's block where one of its planes proves
it covers no pixel centre there (`group_warp_reject`, the test of
`raster3d.plane_region_reject`); the walk and its early-out stay tile-wide
and in list order. `group_work` counts what it evaluates.
"""

from __future__ import annotations

import torch

from .raster3d import ATTR_W, N_GB_ATTR, PLANE_OFF, WARP_H, WARP_W, _split_hilo, plane_region_reject

Tensor = torch.Tensor

TILES = (32, 64)      # tile edges the kernel takes
MAX_SLOTS = 128       # the slot code 127 − slot needs slot < 128
F32_MAX_BITS = 0x7F7FFFFF  # the near bound without ml_near: float32 max, as int32 bits
CHUNK_ELEMS = 1 << 24  # plain version: (tile, slot, pixel) elements evaluated together
SUB = 32              # the kernel's sub-tile side: one CTA each
REJECT_PAIRS = 256    # `group_work`: (tile, group) pairs tested together

LAUNCHES = 0


def _local_pixels(tile: int, device) -> tuple[Tensor, Tensor]:
    lin = torch.arange(tile * tile, device=device)
    return (lin % tile).to(torch.float32) + 0.5, torch.div(lin, tile, rounding_mode="floor").to(torch.float32) + 0.5


def near_table(tile_list: Tensor, ml_near: Tensor | None) -> Tensor:
    """(T, K) i32: per (tile, k) the int32 bit pattern of max(ml_near, 0) of
    the k-th group (max(entry, 0)), or of float32 max without `ml_near`."""
    if ml_near is None:
        return torch.full(tile_list.shape, F32_MAX_BITS, dtype=torch.int32, device=tile_list.device)
    near = torch.clamp(ml_near.to(torch.float32), min=0.0)[torch.clamp(tile_list, min=0).long()]
    return near.contiguous().view(torch.int32)


def _raster_groups_plain(rows: Tensor, tile_list: Tensor, near: Tensor, width: int, height: int, n_slots: int,
                         tile: int, tile_base: int, measure: bool = False):
    """The plain version, vectorised over chunks of tiles, the R slots and the
    tile's pixels, walking k in the kernel's operation order. Returns
    (depth, vid, gb, walked (T,) i32, covered (T,) i64, spans (T,) i64): the
    groups each tile walked before its early-out, and, with `measure` (else
    zeros), in them the covered (slot, image pixel) pairs and the pixels of
    each slot's span, the smallest rectangle holding its covered image
    pixels in the tile. They measure the work this input needs."""
    dev = rows.device
    t_n, k_cap = tile_list.shape
    r = n_slots
    pix = tile * tile
    tx = (width + tile - 1) // tile
    ty = (height + tile - 1) // tile
    xl, yl = _local_pixels(tile, dev)
    xi, yi = xl.to(torch.int32), yl.to(torch.int32)  # the pixels' tile-local column and row
    cnt = (tile_list >= 0).sum(1)
    gl = torch.clamp(tile_list, min=0).to(torch.int32)
    slot = torch.arange(r, dtype=torch.int32, device=dev)
    slot_code = (127 - slot)[None, :, None]
    depth_t = torch.empty((t_n, pix), dtype=torch.float32, device=dev)
    vid_t = torch.empty((t_n, pix), dtype=torch.int32, device=dev)
    gb_t = torch.empty((t_n, pix, N_GB_ATTR), dtype=torch.bfloat16, device=dev)
    walked = torch.zeros(t_n, dtype=torch.int32, device=dev)
    covered = torch.zeros(t_n, dtype=torch.int64, device=dev)
    spans = torch.zeros(t_n, dtype=torch.int64, device=dev)
    chunk = max(1, CHUNK_ELEMS // (r * pix))
    for c0 in range(0, t_n, chunk):
        c1 = min(c0 + chunk, t_n)
        tg = torch.arange(c0, c1, device=dev) + tile_base  # global tile ids: plane and attribute coordinates
        x0 = ((tg % tx) * tile).to(torch.float32)
        y0 = (torch.div(tg, tx, rounding_mode="floor") * tile).to(torch.float32)
        key = torch.zeros((c1 - c0, pix), dtype=torch.int32, device=dev)
        vid = torch.full((c1 - c0, pix), -1, dtype=torch.int32, device=dev)
        active = torch.ones(c1 - c0, dtype=torch.bool, device=dev)
        if measure:  # which pixels of the output tiles lie in the image
            lt = torch.arange(c0, c1, device=dev)
            inside = (((lt % tx) * tile)[:, None] + xi < width) & ((lt // tx * tile)[:, None] + yi < height)
        for k in range(k_cap):
            dmin = key.min(1).values & ~127
            active = active & (k < cnt[c0:c1]) & (dmin < near[c0:c1, k])
            live = torch.nonzero(active)[:, 0]  # the tiles still walking: only they are evaluated
            if live.numel() == 0:
                break
            walked[c0 + live] += 1
            g = gl[c0 + live, k]  # (L,)
            co = rows[(g[:, None] * r + slot).long(), PLANE_OFF : PLANE_OFF + 15].reshape(-1, r, 5, 3, 1)
            a, b, c = co[:, :, :, 0], co[:, :, :, 1], co[:, :, :, 2]  # (L, R, 5, 1)
            cp = (c + x0[live, None, None, None] * a) + y0[live, None, None, None] * b  # tile-local constant
            (a_h, a_l), (b_h, b_l), (c_h, c_l) = (_split_hilo(v) for v in (a, b, cp))

            def plane(p: int) -> Tensor:  # (L, R, PIX)
                return ((((a_h[:, :, p] * xl + b_h[:, :, p] * yl) + c_h[:, :, p]) + a_l[:, :, p] * xl)
                        + b_l[:, :, p] * yl) + c_l[:, :, p]

            m = torch.minimum(torch.minimum(plane(0), plane(1)), plane(2))
            zn, wd = plane(3), plane(4)
            q = torch.minimum(torch.minimum(m, zn), torch.minimum(wd - zn, wd - 1e-30))
            cover = q >= 0
            if measure:
                cov = cover & inside[live, None, :]
                covered[c0 + live] += cov.sum((1, 2))
                x_lo, x_hi = torch.where(cov, xi, tile).amin(2), torch.where(cov, xi, -1).amax(2)
                y_lo, y_hi = torch.where(cov, yi, tile).amin(2), torch.where(cov, yi, -1).amax(2)
                spans[c0 + live] += (torch.clamp(x_hi - x_lo + 1, min=0) * torch.clamp(y_hi - y_lo + 1, min=0)).sum(1)
            z = zn * (1.0 / torch.clamp(wd, min=1e-30))
            zi = (z.view(torch.int32) & ~127) | slot_code
            keyk = torch.where(cover, zi, -1).max(1).values  # (L, PIX)
            key_l = key[live]
            better = keyk > key_l
            won = g[:, None] * 256 + (127 - (keyk & 127))
            vid[live] = torch.where(better, won, vid[live])
            key[live] = torch.where(better, keyk, key_l)
        depth_t[c0:c1] = (key & ~127).view(torch.float32)
        vid_t[c0:c1] = vid

        # phase B: the winner's attribute row at global pixel centres
        hit = vid >= 0
        row = torch.where(hit, (vid >> 8) * r + (vid & 255), 0).long()
        attr = torch.where(hit[..., None], rows[row, :ATTR_W], 0.0)  # (C, PIX, 64)
        px = (x0[:, None] + xl)[..., None]
        py = (y0[:, None] + yl)[..., None]
        lanes = (attr[..., 0:16] * px + attr[..., 16:32] * py) + attr[..., 32:48]
        ssb = lanes[..., 8:9]
        rw = 1.0 / torch.where(torch.abs(ssb) > 1e-12, ssb, 1.0)
        gb_t[c0:c1, :, 0:8] = (lanes[..., 0:8] * rw).to(torch.bfloat16)
        gb_t[c0:c1, :, 8:16] = attr[..., 48:56].to(torch.bfloat16)

    def untile(a: Tensor) -> Tensor:  # local tile t sits at (t // tx, t % tx) of the output
        a = a.reshape(ty, tx, tile, tile, *a.shape[2:]).transpose(1, 2)
        return a.reshape(ty * tile, tx * tile, *a.shape[4:])[:height, :width].contiguous()

    return untile(depth_t), untile(vid_t), untile(gb_t), walked, covered, spans


def rasterize_groups_reference(rows, tile_list, near, width, height, n_slots, tile, tile_base):
    """The plain PyTorch version of the CUDA kernel: (depth, vid, gb)."""
    return _raster_groups_plain(rows, tile_list, near, width, height, n_slots, tile, tile_base)[:3]


def group_region_reject(rows: Tensor, groups: Tensor, tiles: Tensor, n_slots: int, tile: int, width: int,
                        tile_base: int, rw: int, rh: int) -> Tensor:
    """The kernel's reject over the rw × rh regions of a tile, per (tile,
    group) pair: (P, R, tile // rh, tile // rw) bool, True where a plane of
    slot s of group `groups[i]`, staged for local tile `tiles[i]` as the
    kernel stages it (tile-local constant at global tile `tiles[i] +
    tile_base`, hi/lo split), proves by `raster3d.plane_region_reject` that
    the slot covers no pixel centre of the region."""
    dev = rows.device
    tx = (width + tile - 1) // tile
    tg = tiles.long() + tile_base
    x0 = ((tg % tx) * tile).to(torch.float32)[:, None, None]
    y0 = (torch.div(tg, tx, rounding_mode="floor") * tile).to(torch.float32)[:, None, None]
    slot = torch.arange(n_slots, device=dev)
    co = rows[groups.long()[:, None] * n_slots + slot, PLANE_OFF : PLANE_OFF + 15].reshape(-1, n_slots, 5, 3)
    a, b, c = co[..., 0], co[..., 1], co[..., 2]  # (P, R, 5)
    cp = (c + x0 * a) + y0 * b
    (ah, al), (bh, bl), (ch, cl) = (_split_hilo(v) for v in (a, b, cp))
    is_wd = torch.arange(5, device=dev) == 4
    return plane_region_reject(ah, al, bh, bl, ch, cl, is_wd, rw, rh)[..., : tile // rh, : tile // rw].any(2)


def group_warp_reject(rows: Tensor, groups: Tensor, tiles: Tensor, n_slots: int, tile: int, width: int,
                      tile_base: int) -> Tensor:
    """The slots each warp of the kernel skips, per (tile, group) pair: (P, R,
    tile // WARP_H, tile // WARP_W) bool over the tile's warp blocks: what its
    sub-tile's reject skips and what the same test at its own block's corners
    does."""
    args = (rows, groups, tiles, n_slots, tile, width, tile_base)
    sub = group_region_reject(*args, SUB, SUB)
    sub = sub.repeat_interleave(SUB // WARP_H, 2).repeat_interleave(SUB // WARP_W, 3)
    return sub | group_region_reject(*args, WARP_W, WARP_H)


def group_work(rows: Tensor, tile_list: Tensor, walked: Tensor, n_slots: int, tile: int, width: int,
               tile_base: int) -> dict[str, int]:
    """What the kernel does over the groups each tile walked (`walked`, from
    `_raster_groups_plain`): `pairs`, the walked (tile, group) pairs;
    `first_port`, the slot-pixels the first port evaluated (every slot at all
    tile² pixels of each pair); `evaluated`, the slot-pixels the kernel's warps
    evaluate, each warp block's slots that `group_warp_reject` keeps at its
    WARP_W·WARP_H pixels; and the grid, `ctas` and `cluster` (CTAs a tile)."""
    k_walk = torch.arange(tile_list.shape[1], device=tile_list.device)[None, :] < walked[:, None]
    t_idx, k_idx = torch.nonzero(k_walk, as_tuple=True)
    groups = torch.clamp(tile_list[t_idx, k_idx], min=0)
    kept = 0
    for c0 in range(0, groups.numel(), REJECT_PAIRS):
        rej = group_warp_reject(rows, groups[c0 : c0 + REJECT_PAIRS], t_idx[c0 : c0 + REJECT_PAIRS], n_slots, tile,
                                width, tile_base)
        kept += int((~rej).sum())
    cluster = (tile // SUB) ** 2
    return {"pairs": groups.numel(), "first_port": groups.numel() * n_slots * tile * tile,
            "evaluated": kept * WARP_W * WARP_H, "ctas": tile_list.shape[0] * cluster, "cluster": cluster}


def kernel_info(tile: int, k_cap: int) -> dict[str, int]:
    """The kernel's launch resources on the current card: registers a thread,
    shared memory a CTA, CTAs resident per SM, clusters resident on the card
    (0 for tile 32, which launches no cluster), CTAs a cluster."""
    import ctypes

    from .._build import load_kernel_library

    lib = load_kernel_library()
    out = (ctypes.c_int * 5)()
    err = lib.raster_groups_info(tile, k_cap, out)
    if err != 0:
        raise RuntimeError(f"raster_groups_info failed: {lib.kernel_error_string(err).decode()}")
    return dict(zip(("regs", "smem_bytes", "ctas_per_sm", "clusters_resident", "cluster"), out))


def _raster_groups_cuda(rows, tile_list, near, width, height, n_slots, tile, tile_base):
    """Launch `raster_groups` on PyTorch's current stream. Raises on a build or
    launch error; never falls back."""
    from .._build import load_kernel_library

    lib = load_kernel_library()
    dev = rows.device
    for name, t, dt in (("rows", rows, torch.float32), ("tile_list", tile_list, torch.int32),
                        ("near", near, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {dev}")
    if near.shape != tile_list.shape or rows.dim() != 2:
        raise ValueError(f"near {tuple(near.shape)} must match tile_list {tuple(tile_list.shape)}; rows must be 2-D")
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    vid = torch.empty((height, width), dtype=torch.int32, device=dev)
    gb = torch.empty((height, width, N_GB_ATTR), dtype=torch.bfloat16, device=dev)
    t_n, k_cap = tile_list.shape
    err = lib.raster_groups(
        rows.data_ptr(), rows.shape[1], tile_list.data_ptr(), near.data_ptr(), t_n, k_cap, n_slots, tile, tile_base,
        width, height, depth.data_ptr(), vid.data_ptr(), gb.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"raster_groups launch failed: {lib.kernel_error_string(err).decode()}")
    return depth, vid, gb


def run_groups(rows, tile_list, near, width, height, n_slots, tile, tile_base):
    """Device dispatch: the CUDA kernel for tensors on a card (counted in
    `LAUNCHES`), the plain version for tensors on the CPU, nothing else."""
    global LAUNCHES
    if rows.is_cuda:
        out = _raster_groups_cuda(rows, tile_list, near, width, height, n_slots, tile, tile_base)
        LAUNCHES += 1
        return out
    if rows.device.type == "cpu":
        return rasterize_groups_reference(rows, tile_list, near, width, height, n_slots, tile, tile_base)
    raise ValueError(f"no group raster implementation for device {rows.device}")


def rasterize_gbuffer_groups(rows: Tensor, tile_list: Tensor, width: int, height: int, n_slots: int,
                             ml_near: Tensor | None = None, tile: int = 64, tile_base: int = 0):
    """The group raster (the counterpart of `rasterize_gbuffer_pallas`).

    rows (G·R, ≥ 79) f32 — `raster3d.build_tile_comb` of the pass's dense groups
    tile_list (T, K) i32 — per-tile group lists (entries ≥ 0 counted, each read
        as max(entry, 0)), T = ⌈width/tile⌉·⌈height/tile⌉
    n_slots — R, the slots per group (≤ 128)
    ml_near (G,) f32 or None — each group's conservative nearest reverse-Z
        depth, suffix-maxed over the list order; None disables the early-out
    tile — 32 or 64
    tile_base — the first tile's global id: planes and attributes are
        evaluated at the pixels of tile t + tile_base (a band of a sharded
        image), outputs written at tile t

    Returns (depth (H, W) f32 reverse-Z, vid (H, W) i32 = group·256 + slot or
    -1, gb (H, W, 16) bf16)."""
    if tile not in TILES:
        raise ValueError(f"tile={tile}: the group raster takes {TILES}-px tiles")
    if not 0 < n_slots <= MAX_SLOTS or rows.dim() != 2 or rows.shape[0] % n_slots != 0 \
            or rows.shape[1] < PLANE_OFF + 15:
        raise ValueError(f"rows {tuple(rows.shape)} with {n_slots} slots per group (at most {MAX_SLOTS})")
    tx, ty = (width + tile - 1) // tile, (height + tile - 1) // tile
    if tile_list.shape[0] != tx * ty:
        raise ValueError(f"{tile_list.shape[0]} tile rows for a {width}×{height} image at tile {tile}")
    if int(tile_base) < 0:
        raise ValueError(f"tile_base={tile_base} must be ≥ 0")
    tile_list = tile_list.to(torch.int32).contiguous()
    near = near_table(tile_list, ml_near)
    return run_groups(rows.contiguous(), tile_list, near, width, height, n_slots, tile, int(tile_base))
