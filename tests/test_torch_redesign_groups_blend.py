"""The rules the group G-buffer raster kernel (`ops/csrc/raster_groups.cu`)
and the sprite blend kernel (`ops/csrc/blend2d.cu`) add to their plain
versions, held in plain PyTorch (no JAX in this file):

- the group raster's reject per (sub-tile, slot) and per (warp block, slot),
  `raster_groups.group_region_reject` and `group_warp_reject`, at tile 64 and
  32 and on a band (`tile_base` ≠ 0): no slot they reject covers a pixel
  centre of that region in the plain evaluation;
- a plain model of the new group walk (each warp block evaluates only the
  slots its reject keeps; the early-out is decided over the whole tile before
  each group, in list order) equals `_raster_groups_plain` exactly, depth bits
  and vids; on a tile whose early-out decides an exact-depth tie, the same
  model with the early-out decided per 32² sub-tile, or with none, does not;
- the blend's per-warp entry skip (`blend2d.blend_skip_model`) is bit-equal
  (colour bits, vid) to `blend_tiles_reference` on a full K = 64 tile with
  flipped, alpha-masked and negatively tinted entries, on the depth variant
  with tied depths, and where a colour channel holds -0, which the bare
  geometric skip would turn into +0 against the plain version.

Inputs: `chip_smoke.seeded_groups` (near-to-far groups, crowds, a slab whose
near bound ties the resolved depth, duplicated triangles and slots, empty
slots) binned per tile at a size that is not a multiple of the tile, and
`chip_smoke.seeded_blend_inputs` (the card's seeded sprites) at a small size.
"""

import numpy as np
import pytest
import torch

from chip_smoke import _tile_triangle, group_rows, seeded_blend_inputs, seeded_groups
from oxylus_tpu_torch.ops import blend2d, raster_groups, setup3d
from oxylus_tpu_torch.ops.raster3d import PLANE_OFF, WARP_H, WARP_W, _split_hilo

torch.set_num_threads(1)

W, H = 200, 150  # 4 × 3 tiles of 64, 7 × 5 of 32; the last column and row cropped
K = 12           # groups a tile


def _group_case(seed, tile, n_slots, with_near, band):
    """Group raster inputs (rows, tile_list, near, width, height, R, tile,
    tile_base): 24 seeded groups, 6 in each crowd, binned K a tile; `band`
    (first, end) keeps those tile rows (tile_base = first · tiles a row)."""
    coeffs, attr_planes, consts, valid, ml_near, bounds = seeded_groups(seed, W, H, 24, n_slots, (6, 60), 6)
    rows = group_rows(coeffs, attr_planes, consts, valid, "cpu")
    tl, _ = setup3d.bin_meshlets_to_tiles({k: torch.from_numpy(v) for k, v in bounds.items()}, W, H, tile, K)
    h, base = H, 0
    if band is not None:
        tx = (W + tile - 1) // tile
        base, h = band[0] * tx, min(H, band[1] * tile) - band[0] * tile
        tl = tl[band[0] * tx : band[1] * tx].contiguous()
    near_eo = torch.flip(torch.cummax(torch.flip(torch.from_numpy(ml_near), [0]), 0).values, [0])
    near = raster_groups.near_table(tl, near_eo if with_near else None)
    return rows, tl, near, W, h, n_slots, tile, base


def _tie_case(full: bool):
    """One 64² tile, two groups of 32 slots at z = 0.5 on constant depth
    planes, near bounds 0.5. Group 0: slots 10 and 11 cover all of the tile
    but its bottom-right sub-tile; with `full`, slot 12 covers that one too.
    Group 1: slot 5 (a larger slot code) over part of the top-left sub-tile.
    bits(0.5) has no bits under 127, so group 1 ties group 0's masked depth
    and wins wherever it is evaluated; the tile-wide early-out walks group 1
    unless the tile is full."""
    rng = np.random.default_rng(7)
    verts = {(0, 10): [(31.9, -1e4), (31.9, 1e4), (-1e4, 0.0)],   # x < 31.9
             (0, 11): [(-1e4, 31.9), (1e4, 31.9), (0.0, -1e4)],   # y < 31.9
             (0, 12): [(31.0, 31.0), (1e4, 31.0), (31.0, 1e4)],   # the bottom-right sub-tile
             (1, 5): [(4.0, 4.0), (24.0, 6.0), (8.0, 26.0)]}      # inside the top-left sub-tile
    r = 32
    coeffs = np.zeros((2, r, 5, 3), np.float32)
    coeffs[:, :, 0, 2] = -1e30
    valid = np.zeros((2, r), bool)
    for (g, s), v in verts.items():
        if (g, s) == (0, 12) and not full:
            continue
        coeffs[g, s] = _tile_triangle(rng, v, "tie")[0]
        valid[g, s] = True
    attr_planes = np.zeros((2, r, 9, 3), np.float32)
    attr_planes[..., 0, 2] = 1.0
    consts = np.zeros((2, r, 8), np.float32)
    rows = group_rows(coeffs, attr_planes, consts, valid, "cpu")
    tl = torch.tensor([[0, 1] + [-1] * (K - 2)], dtype=torch.int32)
    near = raster_groups.near_table(tl, torch.tensor([0.5, 0.5]))
    return rows, tl, near, 64, 64, r, 64, 0


def _group_keys(rows, g, tg, n_slots, tile, width):
    """Group g's slots at the pixels of global tile tg, in the plain version's
    operation order: (cover (R, tile²), key (R, tile²))."""
    tx = (width + tile - 1) // tile
    xl, yl = raster_groups._local_pixels(tile, "cpu")
    slot = torch.arange(n_slots)
    co = rows[g * n_slots + slot, PLANE_OFF : PLANE_OFF + 15].reshape(n_slots, 5, 3, 1)
    a, b, c = co[:, :, 0], co[:, :, 1], co[:, :, 2]
    x0, y0 = torch.tensor(float(tg % tx * tile)), torch.tensor(float(tg // tx * tile))
    cp = (c + x0 * a) + y0 * b
    (a_h, a_l), (b_h, b_l), (c_h, c_l) = (_split_hilo(v) for v in (a, b, cp))

    def plane(p):
        return ((((a_h[:, p] * xl + b_h[:, p] * yl) + c_h[:, p]) + a_l[:, p] * xl) + b_l[:, p] * yl) + c_l[:, p]

    m = torch.minimum(torch.minimum(plane(0), plane(1)), plane(2))
    zn, wd = plane(3), plane(4)
    q = torch.minimum(torch.minimum(m, zn), torch.minimum(wd - zn, wd - 1e-30))
    z = zn * (1.0 / torch.clamp(wd, min=1e-30))
    return q >= 0, (z.view(torch.int32) & ~127) | (127 - slot.to(torch.int32))[:, None]


def _per_pixel(region, rw, rh, tile):
    """(..., tile // rh, tile // rw) → (..., tile²): each region's value at its pixels."""
    return region.repeat_interleave(rh, -2).repeat_interleave(rw, -1).reshape(*region.shape[:-2], tile * tile)


def _walk_model(rows, tl, near, width, height, n_slots, tile, base, decide="tile"):
    """Plain model of the cluster kernel: groups in list order, each slot in
    ascending order at the pixels of the warp blocks whose reject keeps it,
    strict > on the packed key; before each group the early-out compares the
    min of key & ~127 over the whole tile (`decide="tile"`, the kernel), over
    each 32² sub-tile on its own ("subtile"), or walks every listed group
    ("none"). Returns (depth (H, W), vid (H, W))."""
    t_n, k_cap = tl.shape
    pix = tile * tile
    lin = torch.arange(pix)
    subs = tile // raster_groups.SUB
    sub = (lin // tile // raster_groups.SUB) * subs + (lin % tile) // raster_groups.SUB
    cnt = (tl >= 0).sum(1)
    key = torch.zeros((t_n, pix), dtype=torch.int32)
    vid = torch.full((t_n, pix), -1, dtype=torch.int32)
    for t in range(t_n):
        active = torch.ones(subs * subs, dtype=torch.bool)
        for k in range(k_cap):
            if decide == "tile":
                dmin = (key[t].min() & ~127).expand(subs * subs)
            else:
                dmin = torch.stack([key[t, sub == q].min() for q in range(subs * subs)]) & ~127
            active &= (k < cnt[t]) & ((dmin < near[t, k]) | (decide == "none"))
            if not active.any():
                break
            g = max(int(tl[t, k]), 0)
            cover, zi = _group_keys(rows, g, t + base, n_slots, tile, width)
            rej = raster_groups.group_warp_reject(rows, torch.tensor([g]), torch.tensor([t]), n_slots, tile, width,
                                                  base)[0]
            keep = ~_per_pixel(rej, WARP_W, WARP_H, tile)
            run = active[sub]
            for s in range(n_slots):
                upd = run & cover[s] & keep[s] & (zi[s] > key[t])
                key[t] = torch.where(upd, zi[s], key[t])
                vid[t] = torch.where(upd, torch.tensor(g * 256 + s, dtype=torch.int32), vid[t])
    tx, ty = (width + tile - 1) // tile, t_n // ((width + tile - 1) // tile)

    def untile(a):
        return a.reshape(ty, tx, tile, tile).transpose(1, 2).reshape(ty * tile, tx * tile)[:height, :width]

    return untile((key & ~127).view(torch.float32)), untile(vid)


GROUP_CASES = {"t64_near": (3, 64, 32, True, None), "t32_band": (4, 32, 32, False, (1, 4)),
               "t64_band": (5, 64, 64, True, (1, 3))}


@pytest.fixture(scope="module")
def groups():
    """Per case, its inputs and the plain version's (depth, vid, walked)."""
    out = {name: _group_case(*spec) for name, spec in GROUP_CASES.items()}
    out["tie"], out["tie_full"] = _tie_case(False), _tie_case(True)
    result = {}
    for name, args in out.items():
        d, v, _, walked, _, _ = raster_groups._raster_groups_plain(*args)
        result[name] = (args, d, v, walked)
    return result


def test_group_cases_exercise_the_rules(groups):
    stopped = full = 0
    for name in GROUP_CASES:
        (rows, tl, *_), _, vid, walked = groups[name]
        cnt = (tl >= 0).sum(1)
        assert (vid >= 0).any() and (vid < 0).any()
        stopped += int((walked < cnt).sum())
        full += int((cnt == K).sum())
    assert stopped > 0 and full > 0  # the early-out ends some walk; some list is full
    assert groups["t32_band"][0][7] > 0 and groups["t64_band"][0][7] > 0  # tile_base ≠ 0
    assert int(groups["tie"][3][0]) == 2 and int(groups["tie_full"][3][0]) == 1


@pytest.mark.parametrize("name", list(GROUP_CASES))
@pytest.mark.parametrize("level", ["subtile", "warp"])
def test_rejected_slots_cover_no_pixel_of_their_region(groups, name, level):
    """Neither the sub-tile's reject nor a warp's (the sub-tile's and its own
    block's) skips a slot that covers a pixel centre of its region, in any
    listed (tile, group) pair."""
    (rows, tl, _, w, _, r, tile, base), *_ = groups[name]
    t_idx, k_idx = torch.nonzero(tl >= 0, as_tuple=True)
    g = tl[t_idx, k_idx]
    if level == "subtile":
        sub = raster_groups.SUB
        rej, rw, rh = raster_groups.group_region_reject(rows, g, t_idx, r, tile, w, base, sub, sub), sub, sub
    else:
        rej, rw, rh = raster_groups.group_warp_reject(rows, g, t_idx, r, tile, w, base), WARP_W, WARP_H
    cover = torch.stack([_group_keys(rows, int(gg), int(t) + base, r, tile, w)[0] for gg, t in zip(g, t_idx)])
    assert not (_per_pixel(rej, rw, rh, tile) & cover).any()
    assert rej.float().mean() > 0.5  # the reject does skip work


def test_reject_takes_empty_slots(groups):
    (rows, tl, _, w, _, r, tile, base), *_ = groups["t64_near"]
    t_idx, k_idx = torch.nonzero(tl >= 0, as_tuple=True)
    g = tl[t_idx, k_idx].long()
    rej = raster_groups.group_region_reject(rows, g, t_idx, r, tile, w, base, raster_groups.SUB, raster_groups.SUB)
    empty = rows[:, PLANE_OFF + 2].reshape(-1, r) == -1e30  # e0's constant: the empty-slot sentinel
    assert empty.any() and rej[empty[g]].all()


@pytest.mark.parametrize("name", list(GROUP_CASES) + ["tie", "tie_full"])
def test_walk_model_equals_the_plain_version(groups, name):
    args, want_d, want_v, _ = groups[name]
    d, v = _walk_model(*args)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(v, want_v)


def test_the_tile_wide_early_out_decides_a_tie(groups):
    """Group 1's triangle ties group 0's masked depth with a larger slot
    code. The tile with an uncovered sub-tile walks group 1 everywhere, so it
    wins in the top-left sub-tile; an early-out per sub-tile would stop that
    sub-tile before group 1. The full tile stops before group 1; a walk that
    went on would let the tie win."""
    args, want_d, want_v, _ = groups["tie"]
    won = want_v == 256 + 5
    assert won.any() and int(want_v[40, 40]) == -1  # group 1 won in the top-left, the bottom-right is empty
    d, v = _walk_model(*args, decide="subtile")
    assert not (v == 256 + 5).any() and not torch.equal(v, want_v)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))  # the depth ties; the vid tells them apart

    args, _, want_v, _ = groups["tie_full"]
    assert not (want_v == 256 + 5).any() and (want_v >= 0).all()
    _, v = _walk_model(*args, decide="none")
    assert (v == 256 + 5).any()


def test_group_work_counts_what_the_kernel_evaluates(groups):
    (rows, tl, _, w, _, r, tile, base), _, _, walked = groups["t64_band"]
    work = raster_groups.group_work(rows, tl, walked, r, tile, w, base)
    assert work["pairs"] == int(walked.sum()) > 0
    assert 0 < work["evaluated"] < work["first_port"] == work["pairs"] * r * tile * tile
    assert (work["ctas"], work["cluster"]) == (tl.shape[0] * 4, 4)


def _neg_zero_tile():
    """One 32² tile, WIN + 1 entries: sprite 0 at entry WIN - 1 (the end of the
    first window), sprite 1 at every other. Sprite 0 covers rows 0-3: its
    plane's red is 0 tinted by -0.5 (so -0) and its alpha 1 tinted by 2, so
    a ≈ 2, 1 - a < 0 and red = +0·(1 - a) + (-0)·a = -0 there. Sprite 1
    covers rows 16-31 only, so the second window misses rows 0-3: the plain
    version adds red·(+0) = +0 to their -0, which gives +0."""
    rec = torch.zeros((2, 16))
    rec[0, 0:7] = torch.tensor([0.0, 0.0, 32.0, 0.0, 0.0, 4.0, 1.0 / 128.0])
    rec[1, 0:7] = torch.tensor([0.0, 16.0, 32.0, 0.0, 0.0, 16.0, 1.0 / 512.0])
    rec[0, 7:11] = torch.tensor([-0.5, 1.0, 1.0, 2.0])
    rec[1, 7:11] = torch.tensor([0.5, 0.5, 0.5, 0.8])
    rec[:, 11], rec[:, 13], rec[:, 14] = -1.0, 1.0, torch.tensor([0.0, 1.0])
    tex = torch.full((2, blend2d.TEX, blend2d.TEX, 4), 0.5)
    tex[0, ..., 0], tex[:, ..., 3] = 0.0, 1.0
    n = blend2d.WIN + 1
    tl = torch.full((1, 8), -1, dtype=torch.int32)
    tl[0, :n] = 1
    tl[0, blend2d.WIN - 1] = 0
    return (*blend2d.pack_blend_inputs(rec, tex, tl), 32, 32, None)


SPRITES_W, SPRITES_H = 160, 96  # 5 × 3 blend tiles


@pytest.fixture(scope="module")
def sprites():
    """Blend cases and the plain version's (colour, vid) of each."""
    cases = {"crowd": seeded_blend_inputs(21, SPRITES_W, SPRITES_H, 64, 96, False, "cpu", tint_lo=-0.5),
             "depth": seeded_blend_inputs(22, SPRITES_W - 7, SPRITES_H - 5, 64, 96, True, "cpu", tint_lo=-0.5),
             "neg_zero": _neg_zero_tile()}
    return {name: (args, blend2d.blend_tiles_reference(*args)) for name, args in cases.items()}


def test_blend_cases_exercise_the_rules(sprites):
    (tl, cnt, fields, tex, *_), _ = sprites["crowd"]
    assert int(cnt.max()) == 64  # a full tile
    live = torch.arange(64)[None, :] < cnt[:, None]
    assert (fields[..., 9][live] == 1).any() and (fields[..., 7][live] >= 0).any()  # flipped, alpha-masked
    assert (tex < 0).any()  # negative tints
    (tl, cnt, fields, _, w, h, sd), _ = sprites["depth"]
    rec_depth = fields[..., 10][torch.arange(tl.shape[1])[None, :] < cnt[:, None]]
    assert bool(torch.isin(rec_depth, sd.reshape(-1)).any())  # record depths tie scene depths
    (_, _, _, _, _, _, _), (color, _) = sprites["neg_zero"]
    assert float(color[0, 0, 0]) == 0.0 and not torch.signbit(color[0, 0, 0])  # the plain version's +0


@pytest.mark.parametrize("name", ["crowd", "depth", "neg_zero"])
def test_blend_skip_model_is_bit_equal_to_the_plain_version(sprites, name):
    args, (want_c, want_v) = sprites[name]
    color, vid, evaluated = blend2d.blend_skip_model(*args)
    assert torch.equal(color.view(torch.int32), want_c.view(torch.int32))
    assert torch.equal(vid, want_v)
    pairs = int(args[1].sum())
    assert 0 < evaluated <= pairs * blend2d.WARPS
    if name != "neg_zero":
        assert evaluated < 0.6 * pairs * blend2d.WARPS  # the skip does skip work


def test_bare_skip_breaks_signed_zero(sprites):
    """Without the -0 rule, the warps over rows 0-3 skip the second window and
    keep red -0 where the plain version writes +0; with it, they take that
    window while they hold -0."""
    args, (want_c, _) = sprites["neg_zero"]
    bare, _, bare_evaluated = blend2d.blend_skip_model(*args, settle=False)
    assert not torch.equal(bare.view(torch.int32), want_c.view(torch.int32))
    assert torch.equal(bare, want_c)  # equal as values: only the sign of a zero differs
    _, _, evaluated = blend2d.blend_skip_model(*args)
    assert evaluated == bare_evaluated + blend2d.TILE // blend2d.WARP_W  # the row's warps, one more entry each


def test_packed_texel_planes_are_finite(sprites):
    """The skip needs finite texels below 2^125: `pack_blend_inputs` tints
    textures in [0, 1] (or 1 where untextured) by the records' tints."""
    for args, _ in sprites.values():
        tex = args[3]
        assert bool(torch.isfinite(tex).all()) and float(tex.abs().max()) < 2.0 ** 125
