"""Tile- and band-sharded frames (`oxylus_tpu_torch/parallel/sharding.py`) on 4
gloo ranks against the JAX module on `make_mesh(4)`, on
`tests/test_sharding.py`'s cube.

- `rasterize_tiles_sharded` at 128×64 (the tile list split by tiles, 8 tiles
  over 4 ranks): depth within 1e-6 and vid equal to the JAX function's.
- `render_frame_sharded` at 128×256 (one tile row a rank) and at 128×320 (5
  tile rows padded to 8: the last two bands hold padded rows): JAX's own
  bound against its single-device chain (`tests/test_sharding.py`), the
  frame's largest difference below 1e-3 and more than 99 % of its pixels
  within 2e-5; the adapted luminance to rtol 1e-6, equal on every rank.
- At 128×256 the sharded frame is bit-equal to the port's own single-device
  stage chain (raster, decode, PBR, histogram, exposure, tonemap, FXAA).
- The band decode (`decode_visbuffer(row_offset=, full_height=)`) of the
  second band against the JAX function with the same offset: `hit` equal,
  every plane within 1e-5 where hit (`tests/test_torch_decode.py`'s bound on
  the jitted JAX function).

One module-scoped fixture spawns the 4 ranks once, from a thread while the JAX
side computes; the rank function imports only the port, JAX is imported inside
the fixture.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.ops import raster3d
from oxylus_tpu_torch.ops.decode3d import decode_visbuffer
from oxylus_tpu_torch.parallel import dryrun, sharding
from oxylus_tpu_torch.render.pbr import apply_pbr
from oxylus_tpu_torch.render.postfx import adapt_exposure, apply_fxaa, apply_tonemap, luminance_histogram

torch.set_num_threads(1)

RANKS = 4
RASTER_SIZE = (128, 64)
FRAME_SIZES = ((128, 256), (128, 320))
DEPTH_TOL, FRAME_MAX, FRAME_NEAR, FRAME_NEAR_SHARE, LUM_RTOL, PLANE_TOL = 1e-6, 1e-3, 2e-5, 0.99, 1e-6, 1e-5


def _port(case: dict) -> dict:
    """The port's inputs of one JAX case, through `bridge`."""
    t = lambda a: torch.from_numpy(np.array(a))
    setup = {k: t(v) for k, v in case["setup"].items() if isinstance(v, np.ndarray)}
    setup["slots_per_tri"] = int(case["setup"]["slots_per_tri"])
    return dict(setup=setup, cm=t(case["cm"]), tiles=t(case["tiles"]), vm_inst=t(case["vm_inst"]),
                gscene=bridge.gpu_scene_from_numpy(case["gscene"]), world=t(case["world"]),
                mats=bridge.gpu_materials_from_numpy(case["mats"]), atlas=t(case["atlas"]),
                lights=bridge.lights_from_numpy(case["lights"]), cam_pos=t(case["cam_pos"]),
                ambient=t(case["ambient"]), w=case["w"], h=case["h"])


def _frame_args(p: dict) -> tuple:
    return (p["setup"], p["cm"], p["tiles"], p["vm_inst"], p["gscene"], p["world"], p["mats"], p["atlas"],
            p["lights"], p["cam_pos"], p["ambient"], p["w"], p["h"])


def _rank(rank, n, device, raster_case, frame_cases):
    mesh = sharding.make_mesh(n, device=device)
    p = _port(raster_case)
    depth, vid = sharding.rasterize_tiles_sharded(p["cm"], p["tiles"], p["w"], p["h"], mesh)
    frames = [sharding.render_frame_sharded(*_frame_args(_port(c)), mesh, prev_luminance=1.0, dt=1 / 60,
                                            tonemapper=1) for c in frame_cases]
    return dict(depth=depth.numpy(), vid=vid.numpy(), frames=[(f.numpy(), float(lum)) for f, lum in frames])


def _single_chain(p: dict) -> tuple[np.ndarray, float]:
    """The port's single-device stage chain of `test_sharding.py`'s reference."""
    _, vid = raster3d.rasterize_reference(p["cm"], p["tiles"], p["w"], p["h"])
    gbuf = decode_visbuffer(vid, p["setup"], p["vm_inst"], p["gscene"], p["world"], p["mats"], p["atlas"],
                            width=p["w"], height=p["h"])
    hdr = apply_pbr(gbuf, p["lights"], p["cam_pos"], p["ambient"])
    hist = luminance_histogram(hdr, -11.5, 1.0 / 29.5)
    exposure, lum = adapt_exposure(hist, torch.tensor(1.0), 1 / 60)
    return apply_fxaa(apply_tonemap(hdr, 1, exposure)).numpy(), float(lum)


@pytest.fixture(scope="module")
def run():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from oxylus_tpu.assets.bake import bake_mesh
    from oxylus_tpu.assets.material import empty_gpu_materials
    from oxylus_tpu.ops.cull import cull_meshlets, expand_meshlet_instances
    from oxylus_tpu.ops.decode3d import decode_visbuffer as jdecode
    from oxylus_tpu.ops.raster3d import TILE, pack_coeff_matrix, rasterize_reference
    from oxylus_tpu.ops.setup3d import bin_meshlets_to_tiles, setup_triangles
    from oxylus_tpu.parallel.sharding import make_mesh, rasterize_tiles_sharded, render_frame_sharded
    from oxylus_tpu.render.pbr import Lights
    from oxylus_tpu.render.scene3d import upload_meshes
    from tests.test_render3d import cube_mesh, look_down_z_camera

    mesh = make_mesh(RANKS)
    gscene = upload_meshes([bake_mesh(*cube_mesh())], [(0, 0, 0)])
    world = jnp.broadcast_to(jnp.eye(4), (2, 4, 4)).astype(jnp.float32)
    mats = empty_gpu_materials(16)
    atlas = jnp.zeros((16, 16, 4), jnp.uint8)
    n1 = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    lights = Lights(
        kind=jnp.zeros((4,), jnp.int32), color=jnp.ones((4, 3), jnp.float32),
        intensity=jnp.full((4,), 3.0, jnp.float32), position=jnp.zeros((4, 3), jnp.float32),
        direction=jnp.broadcast_to(-n1, (4, 3)), radius=jnp.ones((4,), jnp.float32),
        inner_cone=jnp.zeros((4,), jnp.float32), outer_cone=jnp.ones((4,), jnp.float32),
        valid=jnp.asarray([True, False, False, False]), count=jnp.int32(1),
    )
    ambient = jnp.full((3,), 0.1, jnp.float32)

    def case(w, h):
        cam = look_down_z_camera(aspect=w / h)
        inst, meshlet, valid = expand_meshlet_instances(gscene, jnp.asarray([True]), jnp.asarray([0]), capacity=16)
        vm_inst, vm_ml, vm_valid, _ = cull_meshlets(gscene, world, inst, meshlet, valid, cam.frustum_planes,
                                                    cam.position, capacity=16)
        setup = setup_triangles(gscene, world, vm_inst, vm_ml, vm_valid, cam.view_projection, w, h)
        tiles, _ = bin_meshlets_to_tiles(setup, w, h, TILE, 8)
        cm = pack_coeff_matrix(setup["coeffs"], setup["tri_valid"])
        return dict(setup=setup, cm=cm, tiles=tiles, vm_inst=vm_inst, gscene=gscene, world=world, mats=mats,
                    atlas=atlas, lights=lights, cam_pos=cam.position, ambient=ambient, w=w, h=h)

    def host(c):
        """NumPy and plain dicts only: the ranks import no JAX to unpickle them."""
        out = jax.device_get({k: v for k, v in c.items() if k not in ("gscene", "mats", "lights")})
        out.update({k: jax.device_get(dataclasses.asdict(c[k])) for k in ("gscene", "mats", "lights")})
        return out

    rc = case(*RASTER_SIZE)
    fcs = [case(w, h) for w, h in FRAME_SIZES]
    pool = ThreadPoolExecutor(1)  # the ranks run while the JAX side computes
    ranks = pool.submit(dryrun.spawn_ranks, _rank, RANKS, "cpu", args=(host(rc), [host(c) for c in fcs]))
    want_raster = jax.device_get(rasterize_tiles_sharded(rc["cm"], rc["tiles"], *RASTER_SIZE, mesh))
    want_frames = [jax.device_get(render_frame_sharded(
        c["setup"], c["cm"], c["tiles"], c["vm_inst"], gscene, world, mats, atlas, lights, c["cam_pos"], ambient,
        c["w"], c["h"], mesh, prev_luminance=1.0, dt=1 / 60, tonemapper=1)) for c in fcs]

    # the second band of the first frame, decoded at its global rows
    c0 = fcs[0]
    _, vid_full = rasterize_reference(c0["cm"], c0["tiles"], c0["w"], c0["h"])
    bh = c0["h"] // RANKS
    vid_band = vid_full[bh:2 * bh]
    want_band = jax.device_get(jdecode(vid_band, c0["setup"], c0["vm_inst"], gscene, world, mats, atlas,
                                       width=c0["w"], height=bh, row_offset=bh, full_height=c0["h"]))
    frame_cases = [host(c) for c in fcs]
    ranks = ranks.result()
    pool.shutdown()
    return dict(want_raster=want_raster, want_frames=want_frames, ranks=ranks, frame_cases=frame_cases,
                band=dict(vid=np.asarray(vid_band), bh=bh, want=want_band))


def test_tile_sharded_raster_and_band_decode_match_jax(run):
    want_d, want_v = run["want_raster"]
    for r in run["ranks"]:
        assert r["depth"].shape == want_d.shape == (RASTER_SIZE[1], RASTER_SIZE[0])
        assert float(np.abs(r["depth"] - want_d).max()) <= DEPTH_TOL
        np.testing.assert_array_equal(r["vid"], want_v)
    assert (want_v >= 0).mean() > 0.05

    p = _port(run["frame_cases"][0])
    b = run["band"]
    got = decode_visbuffer(torch.from_numpy(np.array(b["vid"])), p["setup"], p["vm_inst"], p["gscene"], p["world"], p["mats"],
                           p["atlas"], width=p["w"], height=b["bh"], row_offset=b["bh"], full_height=p["h"])
    hit = b["want"]["hit"]
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    assert hit.mean() > 0.05
    for k, w in b["want"].items():
        if k == "hit":
            continue
        err = float(np.abs(got[k].numpy() - w)[hit].max())
        assert err <= PLANE_TOL, (k, err)


def test_band_sharded_frames_match_jax(run):
    for (want_ldr, want_lum), i in zip(run["want_frames"], range(len(FRAME_SIZES))):
        w, h = FRAME_SIZES[i]
        lums = [r["frames"][i][1] for r in run["ranks"]]
        assert lums == [lums[0]] * RANKS
        np.testing.assert_allclose(lums[0], float(want_lum), rtol=LUM_RTOL)
        ldr = run["ranks"][0]["frames"][i][0]
        assert ldr.shape == want_ldr.shape == (h, w, 3)
        for r in run["ranks"][1:]:
            np.testing.assert_array_equal(r["frames"][i][0], ldr)
        diff = np.abs(ldr - want_ldr).max(-1)
        assert diff.max() < FRAME_MAX, (w, h, diff.max())
        assert (diff <= FRAME_NEAR).mean() > FRAME_NEAR_SHARE, (w, h, (diff <= FRAME_NEAR).mean())


def test_band_sharded_frame_is_the_single_device_chain(run):
    want, want_lum = _single_chain(_port(run["frame_cases"][0]))
    ldr, lum = run["ranks"][0]["frames"][0]
    assert lum == want_lum
    np.testing.assert_array_equal(ldr, want)
    assert float(ldr.std()) > 0.01  # the lit cube is in the frame
