"""The rules the tile G-buffer raster kernel (`ops/csrc/raster_tiles.cu`) and
the single-pass HiZ kernel (`ops/csrc/hiz.cu`) add to their plain versions,
held in plain PyTorch (no JAX in this file):

- the tile raster's reject per (sub-tile, slot) and per (warp block, slot),
  `raster3d.tile_region_reject` and `tile_warp_reject`: no slot they reject
  covers a pixel centre of that region in the plain evaluation;
- a plain model of the cluster kernel (each warp block evaluates only the
  slots its reject keeps; the early-out is decided over the whole tile before
  each round) equals `_raster_tiles_plain` exactly, depth bits and vids; the
  same model with the early-out decided per sub-tile, or with none, does not
  on a tile whose early-out decides an exact-depth tie;
- both hold at the kernel's other tile edges, 16 and 32 (one CTA a tile, the
  margin's span the tile's), on a seeded input and the tie input re-tiled;
- a tile edge outside (16, 32, 64) is refused with `ValueError` by the
  wrapper and by the bench's `OX_TILE`;
- a plain model of the single-pass HiZ (each 64² block's own levels, then the
  tail), `hiz.hiz_block_levels`, equals `hiz_reference` on every level.

Inputs: seeded planar triangles at an image size that is not a multiple of
the tile (vertices snapped to pixel centres, so edges run through centres;
slivers whose only covered centres lie on a sub-tile's border rows and
columns; triangles that cover a single corner centre; wd planes crossing
zero; dead slots; missing entries; tile-covering triangles in front, so the
early-out fires), sorted front to back per tile as the binning sorts them, and
a tile whose early-out decides an exact-depth tie: `chip_smoke.seeded_tiles`
and `tie_tiles`, which `chip_smoke.py` phase 5 also runs through the kernel.
"""

import numpy as np
import pytest
import torch

from chip_smoke import seeded_tiles, tie_tiles
from oxylus_tpu_torch.ops import hiz
from oxylus_tpu_torch.ops import raster3d as tr

torch.set_num_threads(1)

K2, TILE = 192, tr.TILE
PIX = TILE * TILE


def _tile_keys(entries, comb, width, tile=TILE, tile_base=0):
    """Per (tile, entry, tile pixel): the plain version's cover and packed key
    (bits(z) & ~127) | (127 - slot), every entry at every pixel, in its
    operation order."""
    t_n, k2 = entries.shape
    tx = (width + tile - 1) // tile
    xl, yl = tr._tile_local_pixels(entries.device, tile)
    code = (127 - torch.arange(k2) % tr.TILE_ROUND).to(torch.int32)[:, None]
    covers, keys = [], []
    for t in range(t_n):
        tg = t + tile_base
        x0, y0 = float((tg % tx) * tile), float((tg // tx) * tile)
        ent = entries[t]
        co = comb[torch.clamp(ent, min=0).long(), tr.PLANE_OFF : tr.PLANE_OFF + 15]
        co = torch.where((ent >= 0)[:, None], co, 0.0).reshape(k2, 5, 3)
        a, b, c = co[..., 0], co[..., 1], co[..., 2]
        c = torch.where((ent >= 0)[:, None] | (torch.arange(5) > 0), c, -1e30)
        cp = (c + x0 * a) + y0 * b
        (a_h, a_l), (b_h, b_l), (c_h, c_l) = (tr._split_hilo(v[..., None]) for v in (a, b, cp))
        e = ((((a_h * xl + b_h * yl) + c_h) + a_l * xl) + b_l * yl) + c_l  # (K2, 5, PIX)
        e0, e1, e2, zn, wd = e.unbind(1)
        q = torch.minimum(torch.minimum(torch.minimum(torch.minimum(e0, e1), e2), zn),
                          torch.minimum(wd - zn, wd - 1e-30))
        z = zn * (1.0 / torch.clamp(wd, min=1e-30))
        covers.append(q >= 0)
        keys.append((z.view(torch.int32) & ~127) | code)
    return torch.stack(covers), torch.stack(keys)


def _per_pixel(region: torch.Tensor, rw: int, rh: int, tile=TILE) -> torch.Tensor:
    """(T, K2, tile // rh, tile // rw) → (T, K2, tile²), each region's value at its pixels."""
    return region.repeat_interleave(rh, 2).repeat_interleave(rw, 3).reshape(*region.shape[:2], tile * tile)


def _cluster_model(entries, comb, counts, near_r, width, height, tile=TILE, tile_base=0, decide="tile"):
    """Plain model of the cluster kernel: rounds in order, each slot in
    ascending order at the pixels of the warp blocks whose reject keeps it,
    strict > on the packed key; before each round the early-out compares the
    min of key & ~127 over the whole tile (`decide="tile"`, the kernel), over
    each CTA's square on its own ("subtile"), or runs every round ("none").
    Returns (depth (H, W), vid (H, W))."""
    t_n, k2 = entries.shape
    pix, side, n_cta = tile * tile, tr.cta_side(tile), tr.cluster_size(tile)
    cover, zi = _tile_keys(entries, comb, width, tile, tile_base)
    keep = _per_pixel(~tr.tile_warp_reject(entries, comb, width, tile, tile_base), tr.WARP_W, tr.WARP_H, tile)
    lin = torch.arange(pix)
    sub = (lin // tile // side) * (tile // side) + (lin % tile) // side  # each pixel's CTA
    rounds_n = (counts + tr.TILE_ROUND - 1) // tr.TILE_ROUND
    key = torch.zeros((t_n, pix), dtype=torch.int32)
    vid = torch.full((t_n, pix), -1, dtype=torch.int32)
    active = torch.ones((t_n, n_cta), dtype=torch.bool)
    for r0 in range(k2 // tr.TILE_ROUND):
        if decide == "tile":
            dmin = (key.min(1).values & ~127)[:, None].expand(t_n, n_cta)
        else:
            dmin = torch.stack([key[:, sub == q].min(1).values for q in range(n_cta)], 1) & ~127
        go = (r0 < rounds_n)[:, None] & ((dmin < near_r[:, r0 : r0 + 1]) | (decide == "none"))
        active = active & go
        run = active[:, sub]  # (T, PIX)
        for s in range(tr.TILE_ROUND):
            k = r0 * tr.TILE_ROUND + s
            upd = run & cover[:, k] & keep[:, k] & (zi[:, k] > key)
            key = torch.where(upd, zi[:, k], key)
            vid = torch.where(upd, ((torch.arange(t_n)[:, None] + tile_base) * 256 + k).to(torch.int32), vid)
    tx, ty = (width + tile - 1) // tile, (height + tile - 1) // tile

    def untile(a):
        return a.reshape(ty, tx, tile, tile).transpose(1, 2).reshape(ty * tile, tx * tile)[:height, :width]

    return untile((key & ~127).view(torch.float32)), untile(vid)


SEEDED = ["seeded0", "seeded1", "seeded2"]
SCENES = SEEDED + ["tie", "tie_full"]
# the kernel's other tile edges, each on a seeded input and the tie input re-tiled
OTHER_TILES = [(name, tile) for tile in (16, 32) for name in ("seeded0", "tie")]


@pytest.fixture(scope="module")
def scenes():
    """Per scene, its raster inputs (at 64² tiles under the scene's name, at
    another tile under (name, tile)) and the plain version's (depth, vid,
    rounds run)."""
    make = {f"seeded{s}": lambda tile, s=s: seeded_tiles(s, "cpu", tile=tile) for s in (0, 1, 2)}
    make["tie"] = lambda tile: tie_tiles(False, "cpu", tile=tile)
    make["tie_full"] = lambda tile: tie_tiles(True, "cpu", tile=tile)
    result = {}
    for key in SCENES + OTHER_TILES:
        name, tile = (key, TILE) if isinstance(key, str) else key
        args = make[name](tile)
        d, v, _, rounds_run, _ = tr._raster_tiles_plain(*args)
        result[key] = (args, d, v, rounds_run)
    return result


def _cases(levels=None):
    """The scenes at 64² tiles under their old ids, then the other tiles."""
    out = [pytest.param(name, id=name) for name in SCENES]
    out += [pytest.param(key, id=f"{key[0]}-tile{key[1]}") for key in OTHER_TILES]
    if levels is None:
        return out
    return [pytest.param(level, *c.values, id=f"{level}-{c.id}") for level in levels for c in out]


def test_scenes_exercise_the_rules(scenes):
    stopped = 0
    for name in SEEDED:
        (entries, _, counts, *_), _, vid, rounds_run = scenes[name]
        assert (vid >= 0).float().mean() > 0.3 and (vid < 0).any()
        rounds_n = (counts + tr.TILE_ROUND - 1) // tr.TILE_ROUND
        stopped += int((rounds_run < rounds_n).sum())
        assert ((entries < 0) & (torch.arange(K2)[None] < counts[:, None])).any()  # missing entries in the lists
    assert stopped > 0  # the early-out fires on some tile
    assert int(scenes["tie"][3][0]) == 2 and int(scenes["tie_full"][3][0]) == 1


@pytest.mark.parametrize("level, name", _cases(["subtile", "warp"]))
def test_rejected_slots_cover_no_pixel_of_their_region(scenes, name, level):
    """Neither the CTA's reject (a 64² tile's sub-tile, or the whole smaller
    tile) nor a warp's (the CTA's and its own block's) skips a slot that
    covers a pixel centre of its region."""
    (entries, comb, _, _, w, _, tile, base), *_ = scenes[name]
    side = tr.cta_side(tile)
    if level == "subtile":
        rej, rw, rh = tr.tile_region_reject(entries, comb, w, side, side, tile, base), side, side
    else:
        rej, rw, rh = tr.tile_warp_reject(entries, comb, w, tile, base), tr.WARP_W, tr.WARP_H
    cover, _ = _tile_keys(entries, comb, w, tile, base)
    assert not (_per_pixel(rej, rw, rh, tile) & cover).any()
    real = (entries >= 0)[:, :, None, None].expand_as(rej)
    assert int(rej[real].sum()) > 0.3 * int(real.sum())  # the reject does skip work


def test_reject_takes_missing_entries_and_dead_slots(scenes):
    (entries, comb, _, _, w, *_), *_ = scenes["seeded1"]
    rej = tr.tile_region_reject(entries, comb, w, tr.SUB, tr.SUB)
    co = comb[:, tr.PLANE_OFF : tr.PLANE_OFF + 3]
    dead_row = (co[:, 0] == 0) & (co[:, 1] == 0) & (co[:, 2] < 0)
    dead = (entries < 0) | dead_row[entries.clamp(min=0).long()]
    assert dead.any() and (entries < 0).any()
    assert rej[dead].all()


@pytest.mark.parametrize("name", _cases())
def test_cluster_model_equals_the_plain_version(scenes, name):
    args, want_d, want_v, _ = scenes[name]
    d, v = _cluster_model(*args)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))
    assert torch.equal(v, want_v)


def test_the_tile_wide_early_out_decides_a_tie(scenes):
    """Round 1's triangle ties round 0's masked depth with a larger slot code.
    The tile with an uncovered sub-tile runs round 1 everywhere, so it wins in
    the top-left sub-tile; an early-out per sub-tile would stop that sub-tile
    before round 1. The full tile stops before round 1; a design that ran it
    anyway would let the tie win."""
    args, want_d, want_v, _ = scenes["tie"]
    won = want_v == 64 + 5
    assert won.any() and int(want_v[40, 40]) == -1  # round 1 won in the top-left, the bottom-right is empty
    d, v = _cluster_model(*args, decide="subtile")
    assert not (v == 64 + 5).any() and not torch.equal(v, want_v)
    assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))  # the depth ties; the vid tells them apart

    args, _, want_v, _ = scenes["tie_full"]
    assert not (want_v == 64 + 5).any() and (want_v >= 0).all()
    _, v = _cluster_model(*args, decide="none")
    assert (v == 64 + 5).any()


def test_tile_work_counts_what_the_kernel_evaluates(scenes):
    (entries, comb, counts, _, w, *_), _, _, rounds_run = scenes["seeded0"]
    work = tr.tile_work(entries, comb, rounds_run, w)
    real_prefix = int(torch.minimum(counts, rounds_run * tr.TILE_ROUND).sum())
    assert work["real"] <= real_prefix and work["real"] > 0
    assert 0 < work["evaluated"] < work["real"] * PIX
    assert tr.cluster_size(TILE) == work["cluster"] == 4
    assert work["region_tests"] == work["real"] * 4
    assert (work["clusters"], work["ctas"]) == (entries.shape[0], entries.shape[0] * 4)


@pytest.mark.parametrize("tile", [48, 128])
def test_tiles_outside_the_kernels_are_refused(scenes, monkeypatch, tile):
    """A tile edge outside `raster3d.TILES` raises `ValueError` naming the tiles
    taken, before dispatch (here on CPU tensors), in the wrapper and in the
    bench's `OX_TILE`. The JAX tile kernel runs any tile up to 64 (48 too):
    a difference by design."""
    from oxylus_tpu_torch import bench

    (entries, comb, counts, near_r, w, h, *_), *_ = scenes["seeded0"]
    blocks = {"entries": entries, "comb": comb, "near_r": near_r}
    with pytest.raises(ValueError, match="16, 32, 64"):
        tr.rasterize_gbuffer_tiles(blocks, counts, w, h, tile=tile)
    with pytest.raises(ValueError, match="16, 32, 64"):
        tr.run_tiles(entries, comb, counts, near_r, w, h, tile)
    for cell in ("frame3d", "sponza"):
        monkeypatch.setenv("OX_TILE", str(tile))
        with pytest.raises(ValueError, match="OX_TILE"):
            bench.raster_env(cell)


@pytest.mark.parametrize("h, w, odd", [(1080, 1920, True), (100, 700, False), (129, 513, False)],
                         ids=["1080x1920", "100x700", "129x513"])
def test_hiz_block_split_equals_the_reference(h, w, odd):
    rng = np.random.default_rng(h + w)
    d = rng.uniform(0.05, 1.0, (h, w)).astype(np.float32)
    d[: h // 3, : w // 4] = 0.0  # empty (far) regions, like a raster output
    d[h // 2 :, w // 2 :: 7] = 0.0
    depth = torch.from_numpy(d)
    want = hiz.hiz_reference(depth)
    got = hiz.hiz_block_levels(depth)
    assert [tuple(m.shape) for m in got] == [tuple(m.shape) for m in want]
    for lvl, (g, r) in enumerate(zip(got, want)):
        assert torch.equal(g, r), f"level {lvl}"
    # the blocks own levels 1-6, the tail the rest (at 1080p with odd sizes, whose partners read 0)
    assert len(want) > hiz.BLOCK_LEVELS + 1
    assert any(n % 2 == 1 and n > 1 for m in want[hiz.BLOCK_LEVELS + 1 :] for n in m.shape) == odd
