"""The port's 3D frame on the group raster route against the JAX package's.

`RendererInstance.render` of both packages with `RenderSpec(raster_path="group")`
on the config-5 scene as `tests/test_torch_render3d.py` cuts it (12 objects, 40
boxes, 256×144, its camera, material table and JAX device paths; the JAX group
kernel in interpret mode through `gbuffer_interpret`), with the atmosphere,
shadows, GTAO and SSR off (`test_torch_render3d.py` holds those):

- `compact_raster=True` (the group route's default, `compact_triangles`), two
  frames: the first (the boxes stand as a wall in front of the objects: one
  pass, no pyramid yet), then the boxes back in the air from its carry (the
  early pass, the pyramid, and the late pass for what the wall hid);
- `compact_raster=False` (the source meshlets as the groups), one frame.

Bounds: final images PSNR ≥ 40 dB; hit masks ≥ 99.9 % equal, depth ≥ 99.5 %
equal on jointly hit pixels, ids resolved through the slot tables (stride R:
64 slots per dense group) ≥ 99 % (`test_gbuffer_raster.py:342`); the same
binning drops; the same carry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.render import camera as jcamera
from oxylus_tpu_torch import bridge, frame5
from oxylus_tpu_torch.ops import raster3d as tr
from oxylus_tpu_torch.ops import raster_groups as tg
from oxylus_tpu_torch.render.renderer3d import RenderSpec, RendererInstance
from tests.test_torch_render3d import (  # noqa: F401 (the module-scoped shadow-map fixture)
    PSNR_MIN, W, H, _camera, _fractions, _jax_runner, _port_spec, _small_shadow_maps, jax_device_paths, psnr,
)
from tests.test_torch_shadows import host_branches

torch.set_num_threads(1)

KEYS = ("final", "visbuffer", "depth", "slot_packed_id", "bin_overflow", "expand_overflow", "slot_group")
# name: (compact_raster, frames: the boxes' state per frame, each from the previous frame's carry)
ROUTES = {"compact": (True, ("wall", "air")), "passthrough": (False, ("air",))}


@pytest.fixture(scope="module")
def frames():
    """Both packages' frames on the group route, per route name."""
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
    out = {}
    for route, (compact, names) in ROUTES.items():
        spec = dataclasses.replace(runner.renderer3d.spec, raster_path="group", compact_raster=compact)
        runner.renderer3d.spec = spec
        renderer = RendererInstance(_port_spec(spec))
        jcarry, tcarry, got, want = {}, {}, [], []
        for name in names:
            st = states[name]
            cam = jcamera.camera_from_state(st, cam_idx, jnp.float32(W / H))
            with jax_device_paths(), host_branches():
                ctx = runner.renderer3d.render(st, runner.gscene, cam, mats, atlas, cfg, prev=jcarry,
                                               atmosphere=None, enable_shadows=False,
                                               static_lights=runner._static_lights)
            jcarry = ctx["carry"]
            want.append(jax.device_get({k: ctx[k] for k in KEYS}) | {"carry_keys": sorted(jcarry)})
            calls = []
            launches = tg.LAUNCHES, tr.LAUNCHES
            orig = tg.run_groups

            def counting(*a, **k):
                calls.append(tuple(a[1].shape))
                return orig(*a, **k)

            tg.run_groups = counting
            try:
                tctx = renderer.render(bridge.scene_state_from_numpy(jax.device_get(st)), gscene,
                                       _camera(jax.device_get(cam)), tmats, tatlas, tcfg, prev=tcarry,
                                       atmosphere=None, enable_shadows=False,
                                       static_lights=runner._static_lights)
            finally:
                tg.run_groups = orig
            assert (tg.LAUNCHES, tr.LAUNCHES) == launches  # CPU tensors: the plain versions
            tcarry = tctx["carry"]
            got.append({k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in tctx.items() if k in KEYS}
                       | {"carry_keys": sorted(tcarry), "group_calls": calls})
        out[route] = (got, want)
    return out


@pytest.mark.parametrize("route, frame", [("compact", 0), ("compact", 1), ("passthrough", 0)])
def test_group_route_frame_matches_jax(frames, route, frame):
    got, want = (f[frame] for f in frames[route])
    assert got["slot_group"] == want["slot_group"] == 64
    hit_eq, depth_eq, id_eq, fill = _fractions(got, want, 64)
    assert fill > 0.1
    assert hit_eq >= 0.999 and depth_eq >= 0.995 and id_eq >= 0.99, (hit_eq, depth_eq, id_eq)
    assert psnr(got["final"], want["final"]) >= PSNR_MIN
    assert int(got["expand_overflow"]) == int(want["expand_overflow"]) == 0
    assert int(got["bin_overflow"]) == int(want["bin_overflow"])
    assert got["carry_keys"] == want["carry_keys"]
    # the first frame of a carry has no pyramid yet: one pass; the boxes
    # moved from the wall reveal what it hid: the early and the late pass
    assert len(got["group_calls"]) == (2 if (route, frame) == ("compact", 1) else 1)
    assert got["slot_packed_id"].size == want["slot_packed_id"].size


def test_raster_path_other_than_tile_or_group_is_refused():
    with pytest.raises(NotImplementedError):
        RendererInstance(RenderSpec(width=W, height=H, raster_path="band")).render(
            None, None, None, None, None, frame5.RendererConfig())
