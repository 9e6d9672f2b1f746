"""Depth-only visbuffer raster over per-tile meshlet lists (counterpart of
`rasterize_pallas` and `pack_coeff_matrix` in `oxylus_tpu/ops/raster3d.py`).
The shadow clipmaps draw through it (`render/shadows.py`).

Per 64×64 tile, the first `cnt` entries of the tile's list, `cnt` being the
number of entries ≥ 0, each read as the meshlet `vm = max(entry, 0)`, as the
TPU kernel reads them: so a list whose rows are masked to -1 draws nothing
there. Per entry the meshlet's 64 triangles' five planes (edges e0 e1 e2,
depth numerator zn, w denominator wd) are evaluated at the tile's pixels, a
triangle covers where e0, e1, e2 ≥ 0, wd > 0 and 0 ≤ zn ≤ wd, its reverse-Z
depth is zn / wd, the entry's winner is the first slot holding the largest
depth (-1 where nothing covers), and it replaces the tile's pixel only where
strictly nearer: depth starts at 0 (far), vid at -1, and vid = vm·256 + slot.

Plane values are the TPU kernel's: the tile-local constant c' = (c + x0·a) +
y0·b, then a, b and c' each split into a bf16 hi part and a bf16 lo part, and
the sum a_hi·x + b_hi·y + c'_hi + a_lo·x + b_lo·y + c'_lo at tile-local pixel
centres (k + 0.5), in that order (`raster3d._split_hilo`). The JAX package on
the CPU runs `rasterize_reference` instead, plain float32 at global pixel
centres, so the two differ on knife-edge pixels (`tests/test_torch_raster_depth.py`
states both tolerances).

`rasterize_depth` is the wrapper: CPU tensors take the plain PyTorch version
`rasterize_depth_reference`, CUDA tensors the kernel `csrc/raster_depth.cu`
(counted in `LAUNCHES`), anything else raises. Both compute the same
per-pixel operations in the same order (nvcc -fmad=false, IEEE division), so
they agree exactly.

The kernel spreads a tile over one CTA per (tile, SUB² sub-tile, chunk of
ENTRIES_PER_CTA entries), skips a slot in a sub-tile, and then in each warp's
WARP_W × WARP_H block, only where a plane proves it covers no pixel centre
there (`subtile_reject`, `warp_reject`), and merges the CTAs' winners exactly
through per-pixel 64-bit keys (`encode_keys`, `decode_keys`): the largest key
is the largest depth, then the first (entry, slot). Those functions and
`chunk_keys` are plain mirrors of the kernel's rules for the tests
(`tests/test_torch_raster_depth_merge.py`); the main path does not call them.
"""

from __future__ import annotations

import torch

from .raster3d import (
    N_DEPTH_PLANES,
    TILE,
    _split_hilo,
    _tile_local_pixels,
    _untile,
    fold_live_pairs,
    plane_region_reject,
    walk_live_pairs,
)

Tensor = torch.Tensor

SLOTS = 64  # triangles per meshlet, as the kernel takes them
TILES_PER_CHUNK = 16  # plain version: live tiles evaluated together per entry
SUB = 32  # the kernel's sub-tile side
SUBS = (TILE // SUB) ** 2  # sub-tiles per tile
WARP_W, WARP_H = 16, 8  # a warp's block of the sub-tile
ENTRIES_PER_CTA = 4  # the kernel's entry chunk: one CTA per (tile, sub-tile, chunk)
KEY_LOW = 0xFFFFFFFF

LAUNCHES = 0


def pack_coeff_matrix(coeffs: Tensor, tri_valid: Tensor) -> Tensor:
    """(VM, R, 5, 3) → (VM, 3, 5R): rows (a, b, c), columns plane-major
    [e0·R | e1·R | e2·R | zn·R | wd·R]. Invalid triangles already carry an e0
    constant of -1e30 (`setup3d.setup_triangles`), so they never cover."""
    vm, r = coeffs.shape[0], coeffs.shape[1]
    return coeffs.permute(0, 3, 2, 1).reshape(vm, 3, N_DEPTH_PLANES * r).contiguous()


def _tile_grid(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def rasterize_depth_reference(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int) -> tuple[Tensor, Tensor]:
    """The plain PyTorch version of the CUDA kernel. Only live (tile, entry)
    pairs are evaluated: entry by entry, the tiles that hold it, in chunks of
    TILES_PER_CHUNK. Returns (depth (H, W) f32, vid (H, W) i32)."""
    tx, ty = _tile_grid(width, height)
    if tile_list.shape[0] != tx * ty:
        raise ValueError(f"{tile_list.shape[0]} tile rows for a {width}×{height} map")
    pairs = _live_pair_planes(coeff_mat, tile_list, width, height)
    return fold_live_pairs(pairs, tx * ty, width, height, coeff_mat.device)


def _live_pair_planes(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int, k0: int = 0,
                      k1: int | None = None):
    """The plain version's evaluation of the live (tile, entry) pairs (each
    tile's first `cnt` entries) with k0 ≤ entry < k1, entry by entry, in
    chunks of TILES_PER_CHUNK tiles (`raster3d.walk_live_pairs`): yields
    (tiles (C,), entry k, meshlets (C,), cover (C, n, PIX), z (C, n, PIX))
    over the chunk's slots up to its last real one, z = -1 where a slot does
    not cover. The planes are the kernel's: the tile-local constant, each
    coefficient split into bf16 hi and lo parts, at tile-local centres."""
    dev = coeff_mat.device
    tx, _ = _tile_grid(width, height)
    r = coeff_mat.shape[-1] // N_DEPTH_PLANES
    xl, yl = _tile_local_pixels(dev)

    def planes(blk: Tensor, tg: Tensor, n: int) -> Tensor:  # (C, 5, n, PIX)
        x0 = ((tg % tx) * TILE).to(torch.float32)[:, None]
        y0 = (torch.div(tg, tx, rounding_mode="floor") * TILE).to(torch.float32)[:, None]
        a, b, c = blk[:, 0], blk[:, 1], blk[:, 2]
        cp = (c + x0 * a) + y0 * b  # tile-local constant
        (a_h, a_l), (b_h, b_l), (c_h, c_l) = (
            (p.reshape(blk.shape[0], N_DEPTH_PLANES, r)[..., :n, None] for p in _split_hilo(v)) for v in (a, b, cp))
        return ((((a_h * xl + b_h * yl) + c_h) + a_l * xl) + b_l * yl) + c_l

    cnt = (tile_list >= 0).sum(1)
    live = torch.arange(tile_list.shape[1], device=dev)[None, :] < cnt[:, None]
    return walk_live_pairs(coeff_mat, tile_list, live, planes, TILES_PER_CHUNK, k0, k1)


def _region_reject(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int, rw: int, rh: int) -> Tensor:
    """The kernel's reject test over the rw × rh regions of each tile:
    (tiles, TILE // rh, TILE // rw, K, R) bool, True where a plane of slot s of
    entry k proves it covers no pixel centre of the region
    (`raster3d.plane_region_reject`). Entries past the tile's cnt are False."""
    dev = coeff_mat.device
    tx, _ = _tile_grid(width, height)
    n_tiles, k_all = tile_list.shape
    r = coeff_mat.shape[-1] // N_DEPTH_PLANES
    cnt = (tile_list >= 0).sum(1)
    k_cap = int(cnt.max()) if n_tiles else 0  # the entries past every tile's cnt are False
    t = torch.arange(n_tiles, device=dev)
    x0 = ((t % tx) * TILE).to(torch.float32)[:, None, None]
    y0 = (torch.div(t, tx, rounding_mode="floor") * TILE).to(torch.float32)[:, None, None]
    blk = coeff_mat[torch.clamp(tile_list[:, :k_cap], min=0).long()]  # (T, K, 3, 5R)
    a, b, c = blk[:, :, 0], blk[:, :, 1], blk[:, :, 2]
    cp = (c + x0 * a) + y0 * b
    (ah, al), (bh, bl), (ch, cl) = (_split_hilo(v) for v in (a, b, cp))
    is_wd = torch.arange(N_DEPTH_PLANES * r, device=dev) >= (N_DEPTH_PLANES - 1) * r
    live = torch.arange(k_cap, device=dev)[None, :] < cnt[:, None]
    dead = plane_region_reject(ah, al, bh, bl, ch, cl, is_wd, rw, rh)  # (T, K, 5R, rows, columns)
    dead = dead.reshape(n_tiles, k_cap, N_DEPTH_PLANES, r, TILE // rh, TILE // rw).any(2)
    dead = dead.permute(0, 3, 4, 1, 2) & live[:, None, None, :, None]
    return torch.nn.functional.pad(dead, (0, 0, 0, k_all - k_cap))


def subtile_reject(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int) -> Tensor:
    """The kernel's reject per sub-tile, in plain PyTorch: (tiles, TILE // SUB,
    TILE // SUB, K, R) bool, True where the CTA of that SUB² sub-tile skips
    slot s of entry k (`_region_reject` at the sub-tile's corners)."""
    return _region_reject(coeff_mat, tile_list, width, height, SUB, SUB)


def warp_reject(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int) -> Tensor:
    """The slots each warp skips, in plain PyTorch: (tiles, TILE // WARP_H,
    TILE // WARP_W, K, R) bool over the tile's WARP_W × WARP_H blocks, one per
    warp: what its sub-tile's reject skips and what the same test at its own
    block's corners does."""
    sub = subtile_reject(coeff_mat, tile_list, width, height)
    sub = sub.repeat_interleave(SUB // WARP_H, 1).repeat_interleave(SUB // WARP_W, 2)
    return sub | _region_reject(coeff_mat, tile_list, width, height, WARP_W, WARP_H)


def encode_keys(z: Tensor, idx: Tensor) -> Tensor:
    """The kernel's merge key as int64: (float_bits(z) << 32) | (0xFFFFFFFF -
    idx) where z > 0, else 0; idx = entry·64 + slot. z ∈ (0, 1], so the key
    orders by z, then by the smallest idx; it stays below 2^63."""
    bits = z.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(z > 0, (bits << 32) | (KEY_LOW - idx.to(torch.int64)), 0)


def decode_keys(keys: Tensor, tile_list: Tensor, width: int, height: int) -> tuple[Tensor, Tensor]:
    """The kernel's decode pass: (H, W) int64 keys → depth (float bits of the
    high word) and vid = max(tile_list[t, k], 0)·256 + s; depth 0 and vid -1
    where the key is 0."""
    tx, _ = _tile_grid(width, height)
    dev = keys.device
    gy, gx = torch.meshgrid(torch.arange(height, device=dev), torch.arange(width, device=dev), indexing="ij")
    t = torch.div(gy, TILE, rounding_mode="floor") * tx + torch.div(gx, TILE, rounding_mode="floor")
    idx = KEY_LOW - (keys & KEY_LOW)
    vm = torch.clamp(tile_list.long()[t, torch.div(idx, SLOTS, rounding_mode="floor").clamp(max=tile_list.shape[1] - 1)],
                     min=0)
    hit = keys != 0
    depth = torch.where(hit, (keys >> 32).to(torch.int32).view(torch.float32), 0.0)
    vid = torch.where(hit, vm * 256 + idx % SLOTS, -1).to(torch.int32)
    return depth, vid


def chunk_keys(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int, k0: int, k1: int) -> Tensor:
    """(H, W) int64: per pixel, the key of the sequential rule's winner over the
    entries k0 ≤ k < k1 alone (what the kernel's CTAs of that chunk leave in the
    key buffer), 0 where none of them covers it with z > 0."""
    n_tiles = tile_list.shape[0]
    keys = torch.zeros((n_tiles, TILE * TILE), dtype=torch.int64, device=coeff_mat.device)
    for tg, k, _, _, zm in _live_pair_planes(coeff_mat, tile_list, width, height, k0, k1):
        best = zm.max(1).values
        slot = torch.arange(zm.shape[1], device=zm.device)[None, :, None]
        arg = torch.where(zm >= best[:, None], slot, 1 << 20).min(1).values
        keys[tg] = torch.maximum(keys[tg], encode_keys(best, k * SLOTS + arg))
    return _untile(keys, width, height)


def launch_grid(tile_list: Tensor) -> dict[str, int]:
    """The kernel's grid for one call: sub-tile side, entries per chunk, the
    CTAs launched (tiles × SUBS × ⌈K / ENTRIES_PER_CTA⌉) and those with work
    (the rest exit after counting the tile's entries)."""
    cnt = (tile_list >= 0).sum(1)
    return {"sub": SUB, "chunk": ENTRIES_PER_CTA,
            "ctas": tile_list.shape[0] * SUBS * -(-tile_list.shape[1] // ENTRIES_PER_CTA),
            "live_ctas": int((SUBS * torch.div(cnt + ENTRIES_PER_CTA - 1, ENTRIES_PER_CTA, rounding_mode="floor")).sum())}


def live_work(coeff_mat: Tensor, tile_list: Tensor, width: int | None = None, height: int | None = None) -> dict[str, int]:
    """What one call's data needs done: the live (tile, entry) pairs (each
    tile's first `cnt` entries), the real triangles over those pairs (slots
    whose e0 plane is not the dead constant a = b = 0, c < 0), and the distinct
    meshlets they reference with those meshlets' real triangles. Given the
    map's size, also `covered`, the (entry, slot, pixel) triples whose slot
    covers the pixel in the plain evaluation (the least evaluation an exact
    design needs), and `evaluated`, the (entry, slot, pixel) triples the kernel
    evaluates: each warp's slots that `warp_reject` keeps, at its block's
    pixels."""
    r = coeff_mat.shape[-1] // N_DEPTH_PLANES
    dead = (coeff_mat[:, 0, :r] == 0) & (coeff_mat[:, 1, :r] == 0) & (coeff_mat[:, 2, :r] < 0)
    tris = (~dead).sum(1)  # (VM,)
    cnt = (tile_list >= 0).sum(1)
    live = torch.arange(tile_list.shape[1], device=tile_list.device)[None, :] < cnt[:, None]
    vm = torch.clamp(tile_list, min=0).long()
    used = torch.zeros(coeff_mat.shape[0], dtype=torch.bool, device=coeff_mat.device)
    used[vm[live]] = True
    work = {"pairs": int(live.sum()), "pair_tris": int(torch.where(live, tris[vm], 0).sum()),
            "meshlets": int(used.sum()), "meshlet_tris": int(tris[used].sum())}
    if width is not None:
        work["covered"] = sum(int(cov.sum()) for *_, cov, _ in _live_pair_planes(coeff_mat, tile_list, width, height))
        kept = live[:, None, None, :, None] & ~warp_reject(coeff_mat, tile_list, width, height)
        work["evaluated"] = int(kept.sum()) * WARP_W * WARP_H
    return work


def _raster_depth_cuda(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int) -> tuple[Tensor, Tensor]:
    """Launch `raster_depth` on PyTorch's current stream. Raises on a build or
    launch error; never falls back."""
    from .._build import load_kernel_library

    lib = load_kernel_library()
    dev = coeff_mat.device
    tx, ty = _tile_grid(width, height)
    for name, t, dt in (("coeff_mat", coeff_mat, torch.float32), ("tile_list", tile_list, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {dev}")
    if coeff_mat.dim() != 3 or coeff_mat.shape[1:] != (3, N_DEPTH_PLANES * SLOTS) or coeff_mat.shape[0] == 0:
        raise ValueError(f"coeff_mat {tuple(coeff_mat.shape)}: (VM ≥ 1, 3, 320) expected")
    if tile_list.dim() != 2 or tile_list.shape[0] != tx * ty:
        raise ValueError(f"tile_list {tuple(tile_list.shape)} for a {width}×{height} map")
    if coeff_mat.data_ptr() % 16:
        coeff_mat = coeff_mat.clone()  # the kernel copies meshlet blocks in 16-byte pieces
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    vid = torch.empty((height, width), dtype=torch.int32, device=dev)
    keys = torch.empty((height, width), dtype=torch.int64, device=dev)  # scratch, zeroed by the kernel's launcher
    err = lib.raster_depth(
        coeff_mat.data_ptr(), tile_list.data_ptr(), coeff_mat.shape[0], tile_list.shape[0], tile_list.shape[1],
        width, height, ENTRIES_PER_CTA, keys.data_ptr(), depth.data_ptr(), vid.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"raster_depth launch failed: {lib.kernel_error_string(err).decode()}")
    return depth, vid


def rasterize_depth(coeff_mat: Tensor, tile_list: Tensor, width: int, height: int) -> tuple[Tensor, Tensor]:
    """Depth + vid over per-tile meshlet lists: (depth (H, W) f32 reverse-Z,
    vid (H, W) i32 = vm·256 + slot or -1). The CUDA kernel for tensors on a card
    (counted in `LAUNCHES`), the plain version for tensors on the CPU, nothing
    else."""
    global LAUNCHES
    if coeff_mat.is_cuda:
        out = _raster_depth_cuda(coeff_mat, tile_list.to(torch.int32).contiguous(), width, height)
        LAUNCHES += 1
        return out
    if coeff_mat.device.type == "cpu":
        return rasterize_depth_reference(coeff_mat, tile_list, width, height)
    raise ValueError(f"no depth raster implementation for device {coeff_mat.device}")
