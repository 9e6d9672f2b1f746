"""The port's 3D frame on the tile raster route at 32-px tiles against the
JAX package's.

`RendererInstance.render` of both packages with `RenderSpec(tile=32)` on the
tile route, on the config-5 scene as `tests/test_torch_render3d.py` cuts it
(12 objects, 40 boxes, 256×144, its camera, material table and JAX device
paths; the JAX tile kernel in interpret mode through `gbuffer_interpret`),
with the atmosphere, shadows, GTAO and SSR off, as
`tests/test_torch_render3d_group.py` runs the group route. Two frames: the
boxes standing as a wall in front of the objects (one pass, no pyramid yet),
then the boxes back in the air from its carry (the early pass, the pyramid,
and the late pass for what the wall hid).

Bounds: final images PSNR ≥ 40 dB; hit masks ≥ 99.9 % equal, depth ≥ 99.5 %
equal on jointly hit pixels, ids resolved through the slot tables (stride
K2 = 192) ≥ 99 % (`test_gbuffer_raster.py:342`); the same binning drops; the
same carry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.render import camera as jcamera
from oxylus_tpu_torch import bridge, frame5
from oxylus_tpu_torch.ops import raster3d as tr
from oxylus_tpu_torch.render.renderer3d import RendererInstance
from tests.test_torch_render3d import (  # noqa: F401 (the module-scoped shadow-map fixture)
    PSNR_MIN, W, H, _camera, _fractions, _jax_runner, _port_spec, _small_shadow_maps, jax_device_paths, psnr,
)
from tests.test_torch_shadows import host_branches

torch.set_num_threads(1)

TILE = 32
KEYS = ("final", "visbuffer", "depth", "slot_packed_id", "bin_overflow", "expand_overflow", "slot_group")
FRAMES = ("wall", "air")  # the boxes' state per frame, each from the previous frame's carry


@pytest.fixture(scope="module")
def frames():
    """Both packages' frames on the tile route at 32-px tiles: (port, JAX) per frame."""
    runner, _ = _jax_runner()
    cfg = dataclasses.replace(runner.config, vbgtao_enable=False, ssr_enable=False)
    cam_idx = runner._resolve_camera_idx()
    mats, atlas = runner.bindings.materials, runner.bindings.atlas
    state1 = runner.state
    world = np.array(state1.world)
    boxes = np.array([s.startswith("box_") for s in (runner.scene._names[i] or "" for i in range(len(world)))])
    world[boxes, :3, :3] *= 1.25  # the wall of test_torch_render3d.py's first frame
    world[boxes, 1, 3] -= 1.5
    world[boxes, 2, 3] += 4.0
    states = {"wall": dataclasses.replace(state1, world=jnp.asarray(world)), "air": state1}

    gscene = bridge.gpu_scene_from_numpy(jax.device_get(runner.gscene))
    tmats = bridge.gpu_materials_from_numpy(jax.device_get(mats))
    tatlas = torch.zeros((64, 64, 4), dtype=torch.uint8)
    tcfg = frame5.RendererConfig(ssr_enable=False, vbgtao_enable=False)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    spec = dataclasses.replace(runner.renderer3d.spec, raster_path="tile", tile=TILE)
    runner.renderer3d.spec = spec
    renderer = RendererInstance(_port_spec(spec))
    jcarry, tcarry, out = {}, {}, []
    for name in FRAMES:
        st = states[name]
        cam = jcamera.camera_from_state(st, cam_idx, jnp.float32(W / H))
        with jax_device_paths(), host_branches():
            ctx = runner.renderer3d.render(st, runner.gscene, cam, mats, atlas, cfg, prev=jcarry, atmosphere=None,
                                           enable_shadows=False, static_lights=runner._static_lights)
        jcarry = ctx["carry"]
        want = jax.device_get({k: ctx[k] for k in KEYS}) | {"carry_keys": sorted(jcarry)}
        calls = []
        launches = tr.LAUNCHES
        orig = tr.run_tiles

        def counting(*a, **k):
            calls.append((tuple(a[0].shape), a[6]))
            return orig(*a, **k)

        tr.run_tiles = counting
        try:
            tctx = renderer.render(bridge.scene_state_from_numpy(jax.device_get(st)), gscene,
                                   _camera(jax.device_get(cam)), tmats, tatlas, tcfg, prev=tcarry, atmosphere=None,
                                   enable_shadows=False, static_lights=runner._static_lights)
        finally:
            tr.run_tiles = orig
        assert tr.LAUNCHES == launches  # CPU tensors: the plain version
        tcarry = tctx["carry"]
        got = {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in tctx.items() if k in KEYS} \
            | {"carry_keys": sorted(tcarry), "tile_calls": calls}
        out.append((got, want))
    return out


@pytest.mark.parametrize("frame", [0, 1], ids=list(FRAMES))
def test_tile32_frame_matches_jax(frames, frame):
    got, want = frames[frame]
    k2 = got["slot_group"]
    assert k2 == want["slot_group"] == 192
    hit_eq, depth_eq, id_eq, fill = _fractions(got, want, k2)
    assert fill > 0.1
    assert hit_eq >= 0.999 and depth_eq >= 0.995 and id_eq >= 0.99, (hit_eq, depth_eq, id_eq)
    assert psnr(got["final"], want["final"]) >= PSNR_MIN
    assert int(got["expand_overflow"]) == int(want["expand_overflow"]) == 0
    assert int(got["bin_overflow"]) == int(want["bin_overflow"])
    assert got["carry_keys"] == want["carry_keys"]
    # every pass rasters 32-px tiles, 8 × 5 of them; the first frame of a carry
    # has no pyramid yet: one pass; the boxes moved from the wall reveal what
    # it hid: the early and the late pass (K2 128)
    n_tiles = (W // TILE) * -(-H // TILE)
    assert got["tile_calls"] == ([((n_tiles, 192), TILE)] if frame == 0
                                 else [((n_tiles, 192), TILE), ((n_tiles, 128), TILE)])
    assert got["slot_packed_id"].size == want["slot_packed_id"].size
