"""Ordered alpha blend of sorted sprites over 32×32 screen tiles (counterpart of
`oxylus_tpu/ops/raster2d_pallas.py`: `blend_tiles_pallas`, its kernels
`_blend_kernel` / `_blend_kernel_depth`, `resample_texture_tiles` and
`build_sprite_texture_tiles`).

Per tile, the first `cnt` entries of the tile's sprite list (`cnt` = the
number of entries ≥ 0; lists are a valid prefix), in order, each blended
over the tile's pixels with premultiplied over:

- the sprite-local coordinates of the pixel centre, `lu = (rx·e1y − ry·e1x)·idet`
  and `lv = (ry·e0x − rx·e0y)·idet`, inside where both lie in [0, 1];
- `u = lu + flip·(1 − 2·lu)` (arithmetic, as the TPU kernel flips), `v = 1 − lv`,
  then the texel coordinates `fu, fv = clip(·, 0, 1)·15`;
- a bilinear sample of the sprite's pre-tinted 16×16 texel plane. The TPU
  kernel takes it as a (8, 256)·(256, PIX) product with tent weights
  `max(1 − |fv − gv|, 0)·max(1 − |fu − gu|, 0)`; those are nonzero on at most
  the four texels around (fu, fv), so both versions here take exactly those
  four taps, `u0 = min(⌊fu⌋, 14)`, `u1 = u0 + 1` (and the same in v), whose
  weights are the same tent weights (0 on the tap past an integer or edge
  coordinate), summed ((t00 + t01) + t10) + t11;
- `a = ta·inside`, dropped below the cutoff (`cut_eff`, −1 unless the material
  is alpha-masked), and in the depth variant kept only where the record's
  reverse-Z depth is strictly nearer than the scene's (a test, no write);
- `c = c·(1 − a) + t·a` per colour channel, `alpha = alpha·(1 − a) + a`, and the
  entity id taken where `a > 0.5` (carried as float, cast at the end).

Empty tiles are (0, 0, 0, 0) with vid −1. The outputs are the cropped
(H, W, 4) colour and (H, W) vid images, written directly (the TPU kernel's
(T·1024, 4) blocks and `untile` give the same values).

`run_blend` is the dispatch: CPU tensors take the plain PyTorch version
`blend_tiles_reference`, CUDA tensors the kernel `csrc/blend2d.cu` (counted in
`LAUNCHES`), anything else raises. Both compute the same operations in the
same order (nvcc -fmad=false), so they agree exactly. Against the JAX
interpret-mode kernel the colour agrees to float32 rounding: the TPU kernel's
product sums its taps in the matrix unit's order.

The kernel splits a tile's pixels over TILE × STRIP strips, a CTA each, walks
the entries in windows of WIN, and skips a window for a warp (a WARP_W ×
WARP_H block) whose image pixels it leaves unchanged (`blend_skip_model`
holds that rule in plain PyTorch and counts what the kernel evaluates). The
rule needs the texel planes finite, below 2^125 in magnitude, as
`pack_blend_inputs` makes them from finite textures and tints.
"""

from __future__ import annotations

import torch

from ..render.debugdraw import to_int32_saturating

Tensor = torch.Tensor

TILE = 32
PIX = TILE * TILE
TEX = 16  # per-sprite texture tile resolution
MAX_VISIBLE = 1024  # sprites whose texture windows are resampled per frame
N_FIELDS = 10  # p00x p00y e0x e0y e1x e1y idet cut_eff eid flip [+ depth]
MAX_K = 512  # entries per tile the kernel stages in shared memory
TILES_PER_CHUNK = 64  # plain version: live tiles evaluated together per entry
STRIP = 4  # the kernel's CTA: TILE × STRIP pixels of a tile, a thread each
WARP_W, WARP_H = 8, 4  # a warp's block of the strip
WARPS = PIX // 32  # the kernel's warps a tile
WIN = 2  # the kernel's window: entries whose taps a warp computes together

LAUNCHES = 0


def _tile_grid(width: int, height: int) -> tuple[int, int]:
    return (width + TILE - 1) // TILE, (height + TILE - 1) // TILE


def pack_blend_inputs(records: Tensor, textures: Tensor, tile_list: Tensor,
                      rec_depth: Tensor | None = None) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """`blend_tiles_pallas`'s host packing: (tile_list (T, K) i32, cnt (T,) i32,
    fields (T, K, C) f32 gathered per tile from the 10-column field matrix
    [p00x p00y e0x e0y e1x e1y idet cut_eff eid flip] (+ the record depth:
    C = 11), texel planes (V, 16, 16, 4) pre-tinted as
    `where(has_tex, textures, 1)·tint`)."""
    tile_list = tile_list.to(torch.int32).contiguous()
    cnt = (tile_list >= 0).sum(1, dtype=torch.int32)
    cut_eff = torch.where(records[:, 12] > 0.5, records[:, 11], -1.0)
    cols = [records[:, 0:7], cut_eff[:, None], records[:, 14:16]]
    if rec_depth is not None:
        cols.append(rec_depth[:, None])
    fmat = torch.cat(cols, dim=1)
    fields = fmat[torch.clamp(tile_list, min=0).long()].contiguous()  # the one gather
    v_cap = textures.shape[0]
    tint = records[:v_cap, 7:11]
    has_tex = records[:v_cap, 13] > 0.5
    tinted = torch.where(has_tex[:, None, None, None], textures, 1.0) * tint[:, None, None, :]
    return tile_list, cnt, fields, tinted.contiguous()


def blend_tiles_reference(tile_list: Tensor, cnt: Tensor, fields: Tensor, tex: Tensor, width: int, height: int,
                          scene_depth: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """The plain PyTorch version of the CUDA kernel on packed inputs. Only live
    (tile, entry) pairs are evaluated: entry by entry, the tiles that hold it,
    in chunks of TILES_PER_CHUNK. Returns (color (H, W, 4) f32, vid (H, W) i32)."""
    dev = fields.device
    tx, ty = _tile_grid(width, height)
    n_tiles = tx * ty
    if tile_list.shape[0] != n_tiles:
        raise ValueError(f"{tile_list.shape[0]} tile rows for a {width}×{height} image")
    with_depth = scene_depth is not None
    lin = torch.arange(PIX, device=dev)
    lx, ly = (lin % TILE).to(torch.float32), (lin // TILE).to(torch.float32)
    color = torch.zeros((n_tiles, PIX, 4), dtype=torch.float32, device=dev)
    vid = torch.full((n_tiles, PIX), -1.0, dtype=torch.float32, device=dev)
    if with_depth:
        sd = torch.nn.functional.pad(scene_depth, (0, tx * TILE - width, 0, ty * TILE - height))
        sd = sd.reshape(ty, TILE, tx, TILE).transpose(1, 2).reshape(n_tiles, PIX)
    tex_flat = tex.reshape(-1, 4)
    n_tex = tex.shape[0]
    for k in range(int(cnt.max()) if n_tiles else 0):
        live = torch.nonzero(cnt > k)[:, 0]
        for c0 in range(0, live.numel(), TILES_PER_CHUNK):
            tg = live[c0 : c0 + TILES_PER_CHUNK]
            f = fields[tg, k]  # (C, n_fld)
            sid = torch.clamp(tile_list[tg, k].long(), 0, n_tex - 1)[:, None]
            x0 = ((tg % tx) * TILE).to(torch.float32)[:, None]
            y0 = (torch.div(tg, tx, rounding_mode="floor") * TILE).to(torch.float32)[:, None]
            px = x0 + lx + 0.5
            py = y0 + ly + 0.5
            p00x, p00y, e0x, e0y, e1x, e1y, idet, cut, eid, flip = (f[:, i : i + 1] for i in range(N_FIELDS))
            rx = px - p00x
            ry = py - p00y
            lu = (rx * e1y - ry * e1x) * idet
            lv = (ry * e0x - rx * e0y) * idet
            inside = (lu >= 0.0) & (lu <= 1.0) & (lv >= 0.0) & (lv <= 1.0)
            u = lu + flip * (1.0 - 2.0 * lu)
            v = 1.0 - lv
            fu = torch.clamp(u, 0.0, 1.0) * (TEX - 1)
            fv = torch.clamp(v, 0.0, 1.0) * (TEX - 1)
            u0 = torch.clamp(fu.to(torch.int64), 0, TEX - 2)
            v0 = torch.clamp(fv.to(torch.int64), 0, TEX - 2)

            def tent(c: Tensor, g: Tensor) -> Tensor:
                return torch.clamp(1.0 - torch.abs(c - g.to(torch.float32)), min=0.0)

            wu = (tent(fu, u0), tent(fu, u0 + 1))
            wv = (tent(fv, v0), tent(fv, v0 + 1))
            texel = None
            for dv in (0, 1):
                for du in (0, 1):
                    tap = tex_flat[sid * (TEX * TEX) + (v0 + dv) * TEX + (u0 + du)]  # (C, PIX, 4)
                    term = tap * (wv[dv] * wu[du])[..., None]
                    texel = term if texel is None else texel + term
            a = texel[..., 3] * inside.to(torch.float32)
            a = torch.where(a < cut, 0.0, a)
            if with_depth:
                a = torch.where(f[:, N_FIELDS : N_FIELDS + 1] > sd[tg], a, 0.0)
            one_m = 1.0 - a
            old = color[tg]
            rgb = old[..., :3] * one_m[..., None] + texel[..., :3] * a[..., None]
            alpha = old[..., 3] * one_m + a
            color[tg] = torch.cat([rgb, alpha[..., None]], dim=-1)
            vid[tg] = torch.where(a > 0.5, eid, vid[tg])

    def untile(x: Tensor, ch: int) -> Tensor:
        x = x.reshape(ty, tx, TILE, TILE, ch).transpose(1, 2)
        return x.reshape(ty * TILE, tx * TILE, ch)[:height, :width].contiguous()

    return untile(color, 4), untile(vid.to(torch.int32)[..., None], 1)[..., 0]


def _warp_of_pixel(dev) -> Tensor:
    """(PIX,) the kernel's warp (0 … WARPS - 1) of each tile pixel: WARP_W × WARP_H
    blocks, row-major within each TILE × STRIP strip, strips top to bottom."""
    lin = torch.arange(PIX, device=dev)
    x, y = lin % TILE, lin // TILE
    per_strip = (TILE // WARP_W) * (STRIP // WARP_H)
    return (y // STRIP) * per_strip + ((y % STRIP) // WARP_H) * (TILE // WARP_W) + x // WARP_W


def _local_uv(f: Tensor, px: Tensor, py: Tensor) -> tuple[Tensor, Tensor]:
    p00x, p00y, e0x, e0y, e1x, e1y, idet = (f[:, i : i + 1] for i in range(7))
    rx = px - p00x
    ry = py - p00y
    return (rx * e1y - ry * e1x) * idet, (ry * e0x - rx * e0y) * idet


def blend_skip_model(tile_list: Tensor, cnt: Tensor, fields: Tensor, tex: Tensor, width: int, height: int,
                     scene_depth: Tensor | None = None, settle: bool = True):
    """The kernel's per-warp skip, in plain PyTorch: each warp (a WARP_W ×
    WARP_H block of a tile) walks its tile's entries in windows of WIN and
    takes a window where one of its image pixels needs one of the window's
    entries (inside the quad, or u or v NaN) or, with `settle`, while one of
    its image pixels holds a colour or alpha channel of -0 or NaN; it then
    applies every entry of the window, in order, with
    `blend_tiles_reference`'s arithmetic. Elsewhere its pixels keep their
    values. Returns (color (H, W, 4), vid (H, W), evaluated): the (entry,
    warp) pairs the warps evaluate. Without `settle` the skip is the bare
    geometric one, which differs from the plain version where a -0 channel
    meets a window that misses the pixel."""
    dev = fields.device
    tx, ty = _tile_grid(width, height)
    n_tiles = tx * ty
    with_depth = scene_depth is not None
    lin = torch.arange(PIX, device=dev)
    lx, ly = (lin % TILE).to(torch.float32), (lin // TILE).to(torch.float32)
    warp_of = _warp_of_pixel(dev)
    order = torch.argsort(warp_of, stable=True)  # pixels grouped by warp, 32 each
    t_all = torch.arange(n_tiles, device=dev)
    img = (((t_all % tx) * TILE)[:, None] + lin % TILE < width) \
        & ((torch.div(t_all, tx, rounding_mode="floor") * TILE)[:, None] + lin // TILE < height)
    color = torch.zeros((n_tiles, PIX, 4), dtype=torch.float32, device=dev)
    vid = torch.full((n_tiles, PIX), -1.0, dtype=torch.float32, device=dev)
    unsettled = torch.zeros((n_tiles, WARPS), dtype=torch.bool, device=dev)
    if with_depth:
        sd = torch.nn.functional.pad(scene_depth, (0, tx * TILE - width, 0, ty * TILE - height))
        sd = sd.reshape(ty, TILE, tx, TILE).transpose(1, 2).reshape(n_tiles, PIX)
    tex_flat = tex.reshape(-1, 4)
    n_tex = tex.shape[0]
    evaluated = 0
    by_warp = lambda x: x[:, order].reshape(x.shape[0], WARPS, 32).any(2)
    for k in range(int(cnt.max()) if n_tiles else 0):
        tg = torch.nonzero(cnt > k)[:, 0]
        f = fields[tg, k]
        sid = torch.clamp(tile_list[tg, k].long(), 0, n_tex - 1)[:, None]
        x0 = ((tg % tx) * TILE).to(torch.float32)[:, None]
        y0 = (torch.div(tg, tx, rounding_mode="floor") * TILE).to(torch.float32)[:, None]
        px = x0 + lx + 0.5
        py = y0 + ly + 0.5
        cut, eid, flip = f[:, 7:8], f[:, 8:9], f[:, 9:10]
        lu, lv = _local_uv(f, px, py)
        inside = (lu >= 0.0) & (lu <= 1.0) & (lv >= 0.0) & (lv <= 1.0)
        u = lu + flip * (1.0 - 2.0 * lu)
        v = 1.0 - lv
        if k % WIN == 0:  # a window starts: the warps that take it
            need = torch.zeros((tg.numel(), WARPS), dtype=torch.bool, device=dev)
            for i in range(k, k + WIN):
                fi = fields[tg, min(i, fields.shape[1] - 1)]
                li, vi = _local_uv(fi, px, py)
                ui = li + fi[:, 9:10] * (1.0 - 2.0 * li)
                hit = (li >= 0.0) & (li <= 1.0) & (vi >= 0.0) & (vi <= 1.0) | torch.isnan(ui) | torch.isnan(1.0 - vi)
                need |= by_warp(img[tg] & hit & (cnt[tg] > i)[:, None])
            take_all = torch.zeros((n_tiles, WARPS), dtype=torch.bool, device=dev)
            take_all[tg] = need | unsettled[tg] if settle else need
        take = take_all[tg]
        evaluated += int(take.sum())
        fu = torch.clamp(u, 0.0, 1.0) * (TEX - 1)
        fv = torch.clamp(v, 0.0, 1.0) * (TEX - 1)
        u0 = torch.clamp(fu.to(torch.int64), 0, TEX - 2)
        v0 = torch.clamp(fv.to(torch.int64), 0, TEX - 2)

        def tent(c: Tensor, g: Tensor) -> Tensor:
            return torch.clamp(1.0 - torch.abs(c - g.to(torch.float32)), min=0.0)

        wu = (tent(fu, u0), tent(fu, u0 + 1))
        wv = (tent(fv, v0), tent(fv, v0 + 1))
        texel = None
        for dv in (0, 1):
            for du in (0, 1):
                tap = tex_flat[sid * (TEX * TEX) + (v0 + dv) * TEX + (u0 + du)]
                term = tap * (wv[dv] * wu[du])[..., None]
                texel = term if texel is None else texel + term
        a = texel[..., 3] * inside.to(torch.float32)
        a = torch.where(a < cut, 0.0, a)
        if with_depth:
            a = torch.where(f[:, N_FIELDS : N_FIELDS + 1] > sd[tg], a, 0.0)
        one_m = 1.0 - a
        old = color[tg]
        rgb = old[..., :3] * one_m[..., None] + texel[..., :3] * a[..., None]
        alpha = old[..., 3] * one_m + a
        take_px = take[:, warp_of]
        new = torch.where(take_px[..., None], torch.cat([rgb, alpha[..., None]], dim=-1), old)
        color[tg] = new
        vid[tg] = torch.where(take_px & (a > 0.5), eid, vid[tg])
        # after the last entry of a window it took, a warp notes whether it holds -0 or NaN
        last = ((cnt[tg] == k + 1) | (k % WIN == WIN - 1))[:, None]
        odd = ((new.view(torch.int32) == torch.iinfo(torch.int32).min) | torch.isnan(new)).any(2) & img[tg]
        unsettled[tg] = torch.where(take & last, by_warp(odd), unsettled[tg])

    def untile(x: Tensor, ch: int) -> Tensor:
        x = x.reshape(ty, tx, TILE, TILE, ch).transpose(1, 2)
        return x.reshape(ty * TILE, tx * TILE, ch)[:height, :width].contiguous()

    return untile(color, 4), untile(vid.to(torch.int32)[..., None], 1)[..., 0], evaluated


def kernel_info(with_depth: bool, k_cap: int) -> dict[str, int]:
    """The kernel's launch resources on the current card for `k_cap` entries
    a tile: registers a thread, shared memory a CTA, CTAs resident per SM,
    local memory a thread (spills)."""
    import ctypes

    from .._build import load_kernel_library

    lib = load_kernel_library()
    out = (ctypes.c_int * 4)()
    err = lib.blend2d_info(int(with_depth), k_cap, N_FIELDS + int(with_depth), out)
    if err != 0:
        raise RuntimeError(f"blend2d_info failed: {lib.kernel_error_string(err).decode()}")
    return dict(zip(("regs", "smem_bytes", "ctas_per_sm", "local_bytes"), out))


def _blend_cuda(tile_list: Tensor, cnt: Tensor, fields: Tensor, tex: Tensor, width: int, height: int,
                scene_depth: Tensor | None) -> tuple[Tensor, Tensor]:
    """Launch `blend2d` on PyTorch's current stream. Raises on a build or
    launch error; never falls back."""
    from .._build import load_kernel_library

    lib = load_kernel_library()
    dev = fields.device
    tx, ty = _tile_grid(width, height)
    with_depth = scene_depth is not None
    checks = [("tile_list", tile_list, torch.int32), ("cnt", cnt, torch.int32), ("fields", fields, torch.float32),
              ("tex", tex, torch.float32)]
    if with_depth:
        checks.append(("scene_depth", scene_depth, torch.float32))
    for name, t, dt in checks:
        if t.dtype != dt or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {dev}")
    t_cnt, k_cap = tile_list.shape
    n_fld = N_FIELDS + int(with_depth)
    if t_cnt != tx * ty or cnt.shape != (t_cnt,) or not 0 < k_cap <= MAX_K:
        raise ValueError(f"tile_list {tuple(tile_list.shape)}, cnt {tuple(cnt.shape)} for a {width}×{height} image "
                         f"(K ≤ {MAX_K})")
    if fields.shape != (t_cnt, k_cap, n_fld):
        raise ValueError(f"fields {tuple(fields.shape)}: ({t_cnt}, {k_cap}, {n_fld}) expected")
    if tex.dim() != 4 or tex.shape[1:] != (TEX, TEX, 4) or tex.shape[0] == 0:
        raise ValueError(f"tex {tuple(tex.shape)}: (V ≥ 1, {TEX}, {TEX}, 4) expected")
    if with_depth and scene_depth.shape != (height, width):
        raise ValueError(f"scene_depth {tuple(scene_depth.shape)} for a {width}×{height} image")
    color = torch.empty((height, width, 4), dtype=torch.float32, device=dev)
    vid = torch.empty((height, width), dtype=torch.int32, device=dev)
    order = torch.empty(t_cnt, dtype=torch.int32, device=dev)  # the kernel's tile order, fullest first
    err = lib.blend2d(
        tile_list.data_ptr(), cnt.data_ptr(), fields.data_ptr(), tex.data_ptr(),
        scene_depth.data_ptr() if with_depth else None, order.data_ptr(), t_cnt, k_cap, n_fld, tex.shape[0], width,
        height, color.data_ptr(), vid.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"blend2d launch failed: {lib.kernel_error_string(err).decode()}")
    return color, vid


def run_blend(tile_list: Tensor, cnt: Tensor, fields: Tensor, tex: Tensor, width: int, height: int,
              scene_depth: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """The blend on packed inputs: the CUDA kernel for tensors on a card
    (counted in `LAUNCHES`), the plain version for tensors on the CPU, nothing
    else."""
    global LAUNCHES
    if fields.is_cuda:
        sd = None if scene_depth is None else scene_depth.to(torch.float32).contiguous()
        out = _blend_cuda(tile_list, cnt, fields, tex, width, height, sd)
        LAUNCHES += 1
        return out
    if fields.device.type == "cpu":
        return blend_tiles_reference(tile_list, cnt, fields, tex, width, height, scene_depth)
    raise ValueError(f"no sprite blend implementation for device {fields.device}")


def blend_tiles(records: Tensor, textures: Tensor, tile_list: Tensor, width: int, height: int,
                rec_depth: Tensor | None = None, scene_depth: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """`blend_tiles_pallas`: records (S, 16) f32 sorted sprite records,
    textures (V, 16, 16, 4) per-sprite texel tiles (V ≤ S; the tile lists
    reference only the first V records), tile_list (T, K) sorted sprite slots,
    valid prefix then -1. With `scene_depth` (H, W) reverse-Z, each record's
    `rec_depth` is depth-tested against it. Returns (color (H, W, 4) f32
    premultiplied, vid (H, W) i32)."""
    if (rec_depth is None) != (scene_depth is None):
        raise ValueError("rec_depth and scene_depth go together")
    tl, cnt, fields, tex = pack_blend_inputs(records, textures, tile_list, rec_depth)
    return run_blend(tl, cnt, fields, tex, width, height, scene_depth)


def resample_texture_tiles(packed_prefix: Tensor, atlas: Tensor) -> Tensor:
    """(S, 16, 16, 4) f32 texel tiles from the packed sorted-record matrix
    (`ops/raster2d.py` layout: cols 21:23 uv_size, 23:25 uv_offset, 25:29
    albedo_rect), nearest texel of the atlas at a separable 16×16 grid over
    each sprite's window. The JAX package takes atlases ≤ 256 through one-hot
    products and larger ones through a gather; both give the atlas texel, so
    one gather serves both here. The rect coordinates are cast to int32
    saturating and the divisors are scalars on the operands' device, as in
    `build_sprite_texture_tiles`."""
    a = atlas.shape[0]
    dev = packed_prefix.device
    uv_size = packed_prefix[:, 21:23]
    uv_offset = packed_prefix[:, 23:25]
    rect = packed_prefix[:, 25:29]
    us = torch.arange(TEX, dtype=torch.float32, device=dev) / torch.full((), TEX - 1.0, device=dev)
    uu = torch.remainder(uv_offset[:, None, 0] + us[None, :] * uv_size[:, None, 0], 1.0)  # (S, TEX)
    vv = torch.remainder(uv_offset[:, None, 1] + us[None, :] * uv_size[:, None, 1], 1.0)
    ax = (rect[:, None, 0] + uu * (rect[:, None, 2] - rect[:, None, 0])) * a
    ay = (rect[:, None, 1] + vv * (rect[:, None, 3] - rect[:, None, 1])) * a
    ix = torch.clamp(to_int32_saturating(ax), 0, a - 1).long()  # (S, TEX) column indices
    iy = torch.clamp(to_int32_saturating(ay), 0, a - 1).long()  # (S, TEX) row indices
    return atlas[iy[:, :, None], ix[:, None, :]].to(torch.float32) / torch.full((), 255.0, device=atlas.device)


def _mod1(x: Tensor) -> Tensor:
    """`jnp.mod(x, 1.0)` as XLA computes it: the truncated remainder, plus 1
    where it is negative (so a value just below 0 rounds to 1.0)."""
    r = torch.fmod(x, 1.0)
    return torch.where((r != 0) & (r < 0), r + 1.0, r)


def build_sprite_texture_tiles(materials, atlas: Tensor) -> Tensor:
    """(S, 16, 16, 4) f32 texel tiles, one per row of `materials` (per-sprite
    material views, whose uv_size / uv_offset carry the animated window):
    the nearest atlas texel at a 16×16 grid of each sprite's texture window
    (uv grid → material uv transform, wrapped into [0, 1) → albedo rect), in
    one gather over `atlas` (A, A, 4) u8, on its device. The rect coordinates
    are cast to int32 saturating, as XLA casts them. The divisors are scalars
    on the atlas's device: CUDA divides by a CPU scalar as a product with its
    reciprocal, an ulp off the CPU's (and XLA's) division."""
    a = atlas.shape[0]
    dev = atlas.device
    us = torch.arange(TEX, dtype=torch.float32, device=dev) / torch.full((), TEX - 1.0, device=dev)
    uv_size, uv_offset, rect = materials.uv_size, materials.uv_offset, materials.albedo_rect
    uu = _mod1(uv_offset[:, None, None, 0] + us[None, None, :] * uv_size[:, None, None, 0])  # (S, 1, TEX)
    vv = _mod1(uv_offset[:, None, None, 1] + us[None, :, None] * uv_size[:, None, None, 1])  # (S, TEX, 1)
    ax = (rect[:, None, None, 0] + uu * (rect[:, None, None, 2] - rect[:, None, None, 0])) * a
    ay = (rect[:, None, None, 1] + vv * (rect[:, None, None, 3] - rect[:, None, None, 1])) * a
    ix = torch.clamp(to_int32_saturating(ax), 0, a - 1).long()
    iy = torch.clamp(to_int32_saturating(ay), 0, a - 1).long()
    return atlas[iy, ix].to(torch.float32) / torch.full((), 255.0, device=dev)
