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
operations in the same order (nvcc -fmad=false, IEEE division), so they agree
exactly.
"""

from __future__ import annotations

import torch

from .raster3d import TILE, _split_hilo, _tile_local_pixels

Tensor = torch.Tensor

N_DEPTH_PLANES = 5  # e0 e1 e2 | zn wd
TILES_PER_CHUNK = 16  # plain version: live tiles evaluated together per entry

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
    dev = coeff_mat.device
    tx, ty = _tile_grid(width, height)
    n_tiles = tx * ty
    if tile_list.shape[0] != n_tiles:
        raise ValueError(f"{tile_list.shape[0]} tile rows for a {width}×{height} map")
    r = coeff_mat.shape[-1] // N_DEPTH_PLANES
    xl, yl = _tile_local_pixels(dev)
    slot_iota = torch.arange(r, dtype=torch.int32, device=dev)[None, :, None]
    depth = torch.zeros((n_tiles, TILE * TILE), dtype=torch.float32, device=dev)
    vid = torch.full((n_tiles, TILE * TILE), -1, dtype=torch.int32, device=dev)
    cnt = (tile_list >= 0).sum(1)
    for k in range(int(cnt.max()) if n_tiles else 0):
        live = torch.nonzero(cnt > k)[:, 0]
        for c0 in range(0, live.numel(), TILES_PER_CHUNK):
            tg = live[c0 : c0 + TILES_PER_CHUNK]
            vm = torch.clamp(tile_list[tg, k], min=0).to(torch.int32)
            blk = coeff_mat[vm.long()]  # (C, 3, 5R)
            # A slot whose e0 plane is a negative constant (every invalid
            # triangle: a = b = 0, c = -1e30) covers no pixel, so slots past
            # the chunk's last live one change neither the max nor the first
            # max: evaluate the prefix only.
            dead = (blk[:, 0, :r] == 0) & (blk[:, 1, :r] == 0) & (blk[:, 2, :r] < 0)
            n_live = int(torch.nonzero(~dead.all(0)).max()) + 1 if bool((~dead).any()) else 0
            if n_live == 0:
                continue
            x0 = ((tg % tx) * TILE).to(torch.float32)[:, None]
            y0 = (torch.div(tg, tx, rounding_mode="floor") * TILE).to(torch.float32)[:, None]
            a, b, c = blk[:, 0], blk[:, 1], blk[:, 2]
            cp = (c + x0 * a) + y0 * b  # tile-local constant
            (a_h, a_l), (b_h, b_l), (c_h, c_l) = (_split_hilo(v[..., None]) for v in (a, b, cp))

            def plane(p: int) -> Tensor:  # (C, n_live, PIX)
                s = slice(p * r, p * r + n_live)
                return ((((a_h[:, s] * xl + b_h[:, s] * yl) + c_h[:, s]) + a_l[:, s] * xl) + b_l[:, s] * yl) + c_l[:, s]

            zn, wd = plane(3), plane(4)
            cover = (plane(0) >= 0) & (plane(1) >= 0) & (plane(2) >= 0) & (wd > 0) & (zn >= 0) & (zn <= wd)
            zm = torch.where(cover, zn / torch.where(wd > 0, wd, 1.0), -1.0)
            best = zm.max(1).values  # (C, PIX)
            arg = torch.where(zm >= best[:, None], slot_iota[:, :n_live], 1 << 20).min(1).values
            better = best > depth[tg]
            depth[tg] = torch.where(better, best, depth[tg])
            vid[tg] = torch.where(better, vm[:, None] * 256 + arg, vid[tg])

    def untile(a: Tensor) -> Tensor:
        a = a.reshape(ty, tx, TILE, TILE).transpose(1, 2)
        return a.reshape(ty * TILE, tx * TILE)[:height, :width].contiguous()

    return untile(depth), untile(vid)


def live_work(coeff_mat: Tensor, tile_list: Tensor) -> dict[str, int]:
    """What one call's data needs done: the live (tile, entry) pairs (each
    tile's first `cnt` entries), the real triangles over those pairs (slots
    whose e0 plane is not the dead constant a = b = 0, c < 0), and the distinct
    meshlets they reference with those meshlets' real triangles."""
    r = coeff_mat.shape[-1] // N_DEPTH_PLANES
    dead = (coeff_mat[:, 0, :r] == 0) & (coeff_mat[:, 1, :r] == 0) & (coeff_mat[:, 2, :r] < 0)
    tris = (~dead).sum(1)  # (VM,)
    cnt = (tile_list >= 0).sum(1)
    live = torch.arange(tile_list.shape[1], device=tile_list.device)[None, :] < cnt[:, None]
    vm = torch.clamp(tile_list, min=0).long()
    used = torch.zeros(coeff_mat.shape[0], dtype=torch.bool, device=coeff_mat.device)
    used[vm[live]] = True
    return {"pairs": int(live.sum()), "pair_tris": int(torch.where(live, tris[vm], 0).sum()),
            "meshlets": int(used.sum()), "meshlet_tris": int(tris[used].sum())}


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
    if coeff_mat.dim() != 3 or coeff_mat.shape[1:] != (3, N_DEPTH_PLANES * 64) or coeff_mat.shape[0] == 0:
        raise ValueError(f"coeff_mat {tuple(coeff_mat.shape)}: (VM ≥ 1, 3, 320) expected")
    if tile_list.dim() != 2 or tile_list.shape[0] != tx * ty:
        raise ValueError(f"tile_list {tuple(tile_list.shape)} for a {width}×{height} map")
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    vid = torch.empty((height, width), dtype=torch.int32, device=dev)
    err = lib.raster_depth(
        coeff_mat.data_ptr(), tile_list.data_ptr(), coeff_mat.shape[0], tile_list.shape[0], tile_list.shape[1],
        width, height, depth.data_ptr(), vid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
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
