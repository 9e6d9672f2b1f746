"""The two rules the depth raster kernel (`ops/csrc/raster_depth.cu`) adds to
the sequential one, held in plain PyTorch against `rasterize_depth_reference`
(no JAX in this file):

- the reject per (sub-tile, slot) and per (warp block, slot),
  `raster_depth.subtile_reject` and `warp_reject`: no slot they reject covers
  a pixel centre of that region in the plain evaluation;
- the ordered merge through 64-bit keys (`encode_keys`, `chunk_keys`,
  `decode_keys`): the per-pixel keys of entry chunks, merged by max in any
  order, decode to the reference's depth and vid exactly (bits and ids).

Inputs: seeded planar triangles at a map size that is not a multiple of the
tile (vertices snapped to pixel centres, so edges run through centres;
slivers whose only covered centres lie on a sub-tile's border rows and
columns; triangles that cover a single corner centre; wd planes crossing
zero; dead slots; repeated meshlets and slots for depth ties; list rows with
holes and masked rows), and the port's own shadow levels of
`tests/test_torch_shadows.py`'s two-cube scene at 256² (`SHADOW_MAP_SIZE` and
`PAGES` patched for this file only). Every comparison is exact.
"""

import contextlib

import numpy as np
import pytest
import torch

from oxylus_tpu_torch.assets.bake import bake_mesh
from oxylus_tpu_torch.frame5 import cube_mesh
from oxylus_tpu_torch.ops import raster_depth as rd
from oxylus_tpu_torch.render import shadows as ts
from oxylus_tpu_torch.render.scene3d import upload_meshes

torch.set_num_threads(1)

W, H = 160, 100  # 3 × 2 tiles, the last column and row cropped
N_VM, K_CAP, TILE = 24, 8, 64


def _edge(p, q, inside):
    """The edge function through p and q (a·x + b·y + c), positive on the side of `inside`."""
    a, b = q[1] - p[1], -(q[0] - p[0])
    c = -(a * p[0] + b * p[1])
    s = 1.0 if a * inside[0] + b * inside[1] + c >= 0 else -1.0
    return s * a, s * b, s * c


def _plane_through(v, z):
    """The plane z = a·x + b·y + c through three (x, y) vertices with values z."""
    m = np.array([[x, y, 1.0] for x, y in v])
    return np.linalg.solve(m, np.asarray(z, np.float64))


def _triangle_coeffs(rng, v, kind):
    """(5, 3) plane coefficients (e0 e1 e2 zn wd) × (a b c) of a triangle."""
    cen = np.mean(v, 0)
    rows = [_edge(v[i], v[(i + 1) % 3], cen if kind != "sliver" else v[(i + 2) % 3]) for i in range(3)]
    z = rng.uniform(0.05, 0.95, 3)
    if kind == "tie":
        z[:] = 0.5
    if kind == "wd_cross":  # wd falls below 0 across the map: covers only where it is positive
        wd = _plane_through(v, rng.uniform(-0.5, 1.5, 3))
    elif kind == "perspective":
        wd = _plane_through(v, rng.uniform(0.5, 2.0, 3))
    else:
        wd = np.array([0.0, 0.0, 1.0])
    zn = _plane_through(v, z) if kind != "perspective" else _plane_through(v, z * (wd[:2] @ np.array(v).T + wd[2]))
    return np.array(rows + [tuple(zn), tuple(wd)], np.float64)


def _centre(rng, lo, hi):
    return float(rng.integers(lo, hi)) + 0.5


def _seeded_scene(seed):
    rng = np.random.default_rng(seed)
    cm = np.zeros((N_VM, 3, 5 * rd.SLOTS), np.float32)
    for m in range(N_VM):
        n_real = int(rng.integers(1, rd.SLOTS + 1)) if m % 5 else rd.SLOTS
        for s in range(rd.SLOTS):
            if s >= n_real or rng.uniform() < 0.1:  # dead: e0 = -1e30 constant
                co = _triangle_coeffs(rng, [(0, 0), (1, 0), (0, 1)], "flat")
                co[0] = (0.0, 0.0, -1e30)
            else:
                kind = rng.choice(["flat", "snapped", "sliver", "corner", "wd_cross", "perspective", "tie"])
                if kind in ("snapped", "tie", "wd_cross"):  # vertices on pixel centres: edges through centres
                    v = [(_centre(rng, 0, W), _centre(rng, 0, H)) for _ in range(3)]
                elif kind == "sliver":  # an edge along a sub-tile's border row or column of centres
                    sx, sy = int(rng.integers(0, W // 32 + 1)) * 32, int(rng.integers(0, H // 32 + 1)) * 32
                    row = sy + (0.5 if rng.uniform() < 0.5 else -0.5)
                    x0, x1 = sx + 0.5, sx + 0.5 + float(rng.integers(2, 40))
                    if rng.uniform() < 0.5:
                        v = [(x0, row), (x1, row), ((x0 + x1) / 2, row - 7.0 * np.sign(rng.uniform(-1, 1)))]
                    else:
                        col = sx + 0.5
                        v = [(col, row), (col, row + 30.0), (col - 9.0, row + 15.0)]
                elif kind == "corner":  # a small triangle around one corner centre of a sub-tile
                    cx, cy = int(rng.integers(0, W // 32 + 1)) * 32 + 0.5, int(rng.integers(0, H // 32 + 1)) * 32 + 0.5
                    v = [(cx, cy), (cx + 0.9, cy + 0.2), (cx + 0.3, cy + 0.8)]
                else:
                    c = rng.uniform([-20, -20], [W + 20, H + 20])
                    v = [tuple(c + rng.normal(0, rng.choice([2.0, 15.0, 60.0]), 2)) for _ in range(3)]
                if abs((v[1][0] - v[0][0]) * (v[2][1] - v[0][1]) - (v[1][1] - v[0][1]) * (v[2][0] - v[0][0])) < 1e-3:
                    v[2] = (v[2][0] + 3.0, v[2][1] + 5.0)
                co = _triangle_coeffs(rng, v, kind)
            cm[m, :, np.arange(5) * rd.SLOTS + s] = co.astype(np.float32)
        if m % 7 == 3:  # a repeated slot: a depth tie inside one meshlet
            cm[m, :, np.arange(5) * rd.SLOTS + 9] = cm[m, :, np.arange(5) * rd.SLOTS + 4]
    n_tiles = -(-W // TILE) * -(-H // TILE)
    tl = rng.integers(0, N_VM, (n_tiles, K_CAP)).astype(np.int32)
    tl[rng.uniform(size=tl.shape) < 0.2] = -1
    tl[1] = -1  # an empty tile
    tl[2, 1] = -1  # a hole between live entries: entry 1 reads meshlet 0 while it is below cnt
    tl[3, :4] = tl[3, 0]  # one meshlet four times: depth ties across entries
    return torch.from_numpy(cm), torch.from_numpy(tl), W, H


@contextlib.contextmanager
def _small_maps():
    saved = ts.SHADOW_MAP_SIZE, ts.PAGES
    ts.SHADOW_MAP_SIZE, ts.PAGES = 256, 4
    try:
        yield
    finally:
        ts.SHADOW_MAP_SIZE, ts.PAGES = saved


def _shadow_levels():
    """The depth raster's inputs of the port's six shadow levels for the
    two-cube scene of `tests/test_torch_shadows.py`."""
    gscene = upload_meshes([bake_mesh(*cube_mesh())], [(0, 0, 0), (0, 1, 0)], max_instances=2)
    world = torch.eye(4).repeat(2, 1, 1)
    world[1, 0, 3] = 3.0
    sun = torch.tensor([0.3, -0.8, 0.2])
    calls = []
    raster = rd.rasterize_depth

    def record(cm, tl, w, h):
        calls.append((cm, tl.to(torch.int32), w, h))
        return raster(cm, tl, w, h)

    with _small_maps():
        vps = ts.clipmap_matrices(sun / sun.norm(), torch.zeros(3), first_width=10.0)
        rd.rasterize_depth = record
        try:
            ts.render_shadow_clipmaps(gscene, world, vps)
        finally:
            rd.rasterize_depth = raster
    return calls


@pytest.fixture(scope="module")
def scenes():
    """Per scene, its raster calls, each with the reference's (depth, vid)."""
    out = {f"seeded{s}": [_seeded_scene(s)] for s in (0, 1, 2)}
    out["shadows"] = _shadow_levels()
    return {name: [(c, rd.rasterize_depth_reference(*c)) for c in calls] for name, calls in out.items()}


SCENES = ["seeded0", "seeded1", "seeded2", "shadows"]


def test_scenes_exercise_the_rules(scenes):
    for name in SCENES[:3]:
        (_, (_, vid)), = scenes[name]
        assert (vid >= 0).float().mean() > 0.3 and (vid < 0).any()
    assert len(scenes["shadows"]) == ts.NUM_CLIPMAPS
    assert sum(int((vid >= 0).sum()) for _, (_, vid) in scenes["shadows"]) > 1000


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("level", ["subtile", "warp"])
def test_rejected_slots_cover_no_pixel_of_their_region(scenes, name, level):
    """Neither the sub-tile's reject nor a warp's (the sub-tile's and its own
    block's) skips a slot that covers a pixel centre of its region."""
    reject, rw, rh = {"subtile": (rd.subtile_reject, rd.SUB, rd.SUB),
                      "warp": (rd.warp_reject, rd.WARP_W, rd.WARP_H)}[level]
    n_rejected = n_live = 0
    for (cm, tl, w, h), _ in scenes[name]:
        rej = reject(cm, tl, w, h)  # (T, rows, columns, K, R)
        for tg, k, _, cover, _ in rd._live_pair_planes(cm, tl, w, h):
            c, n = cover.shape[:2]
            per_region = cover.reshape(c, n, TILE // rh, rh, TILE // rw, rw).any(5).any(3).permute(0, 2, 3, 1)
            r = rej[tg, :, :, k, :n]
            assert not (r & per_region).any(), f"{name}: entry {k} rejects a slot that covers a pixel"
            n_rejected += int(r.sum())
            n_live += r.numel()
    assert n_rejected > 0.3 * n_live  # the reject does skip work


def test_reject_takes_every_dead_slot(scenes):
    (cm, tl, w, h), _ = scenes["seeded1"][0]
    rej = rd.subtile_reject(cm, tl, w, h)
    dead = (cm[:, 0, : rd.SLOTS] == 0) & (cm[:, 1, : rd.SLOTS] == 0) & (cm[:, 2, : rd.SLOTS] < 0)
    live = torch.arange(K_CAP)[None, :] < (tl >= 0).sum(1)[:, None]
    want = (dead[tl.clamp(min=0).long()] & live[:, :, None])[:, None, None].expand_as(rej)
    assert (rej | ~want).all()
    assert not rej[~live[:, None, None, :, None].expand_as(rej)].any()  # nothing past cnt


@pytest.mark.parametrize("name", SCENES)
def test_chunk_keys_merged_in_any_order_equal_the_reference(scenes, name):
    rng = np.random.default_rng(5)
    for (cm, tl, w, h), (want_d, want_v) in scenes[name]:
        bounds = list(range(0, tl.shape[1], rd.ENTRIES_PER_CTA))
        parts = [rd.chunk_keys(cm, tl, w, h, k0, k0 + rd.ENTRIES_PER_CTA) for k0 in bounds]
        keys = torch.zeros((h, w), dtype=torch.int64)
        for i in rng.permutation(len(parts)):
            keys = torch.maximum(keys, parts[i])
        d, v = rd.decode_keys(keys, tl, w, h)
        assert torch.equal(d.view(torch.int32), want_d.view(torch.int32))
        assert torch.equal(v, want_v)


def test_keys_order_by_depth_then_first_entry_and_slot():
    z = torch.tensor([0.25, 0.25, 0.5, 1.0, 1.0e-30, 0.0, -0.0, -1.0])
    idx = torch.tensor([7, 3, 500, 2047, 0, 1, 1, 1])
    keys = rd.encode_keys(z, idx)
    assert (keys[5:] == 0).all() and (keys[:5] > 0).all()
    assert keys[1] > keys[0] > 0 and keys[2] > keys[1] and keys[3] > keys[2] and keys[0] > keys[4]
    assert int(keys.max()) < 2**63 - 1


def test_launch_grid_counts_ctas_with_work():
    tl = torch.full((6, 32), -1, dtype=torch.int32)
    tl[0, :32] = 1  # the fullest tile: 4 sub-tiles × 8 chunks
    tl[1, :5] = 2
    tl[2, 3] = 0  # cnt 1: entry 0 reads max(-1, 0)
    g = rd.launch_grid(tl)
    assert g["ctas"] == 6 * rd.SUBS * 32 // rd.ENTRIES_PER_CTA
    per = lambda n: rd.SUBS * -(-n // rd.ENTRIES_PER_CTA)
    assert g["live_ctas"] == per(32) + per(5) + per(1)
    assert per(32) >= 16  # the fullest tile spans at least 16 CTAs
