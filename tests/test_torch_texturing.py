"""The port's textured and alpha-masked tile route against the JAX package's.

Three scenes of `tests/test_texturing.py`, rendered by both packages'
`RendererInstance.render` on the tile route (the JAX tile raster in interpret
mode, `RenderSpec(gbuffer_interpret=True)`; its HiZ through the interpret-mode
device path and its `lax.cond` as Python branches, as
`tests/test_torch_render3d.py` runs them; the JAX graph op by op):

- `test_alpha_mask_discard_in_3d_frame`'s scene: a red, half-transparent
  alpha-masked quad in front of a green opaque wall, albedo texturing only;
  the JAX test's own red-and-green assertions must hold for the port;
- the same scene over two frames: first with an opaque occluder in front of
  everything, then with the occluder gone, so the wall hidden in the first
  pyramid is revealed and the late pass runs; the masked pass's vids then sit
  after the early and the late pass's groups, and the quad's texture must
  still resolve to its own material (red where it is kept);
- `test_production_sampler_matches_decode`'s plane: one material with albedo,
  normal, metallic-roughness with its shared-rect occlusion and emissive
  maps, under a sun.

Bounds: depth and vid ≥ 99.5 % equal (the tile raster's bound,
`tests/test_torch_raster_tiles.py`); the G-buffer's albedo, normal,
metallic, roughness, occlusion and emissive within 2e-2 on the pixels whose
vid is equal in a 5×5 neighbourhood (the quarter-resolution samples spread
over 4 pixels and the linear upsample one more); the final image PSNR ≥ 40 dB
(the goldens' bound)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.assets import material as jmat
from oxylus_tpu.assets.bake import bake_mesh as jbake
from oxylus_tpu.core.config import RendererConfig as JConfig
from oxylus_tpu.render.camera import camera_matrices as jcamera_matrices
from oxylus_tpu.render.renderer3d import RenderSpec as JSpec
from oxylus_tpu.render.renderer3d import RendererInstance as JRenderer
from oxylus_tpu.render.scene3d import upload_meshes as jupload
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu.scene.state import SceneSpec as JSceneSpec
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.assets import material as tmat
from oxylus_tpu_torch.core.config import RendererConfig
from oxylus_tpu_torch.ops import raster3d as tr
from oxylus_tpu_torch.render.renderer3d import RenderSpec, RendererInstance
from tests.test_render3d import cube_mesh, look_down_z_camera
from tests.test_renderer3d_full import plane_mesh
from tests.test_torch_render3d import _camera, jax_device_paths, psnr
from tests.test_torch_shadows import host_branches

torch.set_num_threads(1)

W = H = 128
GB_KEYS = ("albedo", "normal", "metallic", "roughness", "occlusion", "emissive")
GB_TOL, EQ_MIN, PSNR_MIN = 2e-2, 0.995, 40.0


def _mask_scene(occluder: bool):
    """The alpha-mask scene: atlas, materials (wall, masked quad), JAX state,
    gscene and camera; with `occluder`, an opaque slab in front of both."""
    atlas = np.zeros((64, 64, 4), np.uint8)
    atlas[:, :, 0] = 220
    atlas[:, :32, 3] = 255  # alpha 255 on the left half of the rect, 0 on the right
    rects = {"alb": (0.0, 0.0, 1.0, 1.0)}
    mats = [dict(albedo_color=(0.1, 0.9, 0.1, 1.0)),
            dict(albedo_color=(1.0, 1.0, 1.0, 1.0), albedo_texture="alb", alpha_mode=jmat.ALPHA_MASK,
                 alpha_cutoff=0.5)]
    s = JScene("amask", spec=JSceneSpec(max_entities=8))
    wall = s.create_entity("wall")
    wall.add("TransformComponent", position=(0.0, 0.0, -2.0), scale=(8.0, 8.0, 0.5))
    quad = s.create_entity("quad")
    quad.add("TransformComponent", position=(0.0, 0.0, 0.0), scale=(3.0, 3.0, 0.1))
    baked = jbake(*cube_mesh())
    inst = [(0, wall.index, 0), (1, quad.index, 1)]
    if occluder:
        occ = s.create_entity("occluder")
        occ.add("TransformComponent", position=(0.0, 0.0, 2.0), scale=(8.0, 8.0, 0.5))
        # a small opaque block beside the quad: its footprint is small enough
        # for a fine pyramid level, so the occluder's depth hides it there
        small = s.create_entity("block")
        small.add("TransformComponent", position=(-2.5, 2.5, -1.0), scale=(0.6, 0.6, 0.6))
        inst += [(0, occ.index, 0), (0, small.index, 0)]
    return {"atlas": atlas, "rects": rects, "mats": mats, "state": s.to_device_state(),
            "gscene": jupload([baked, baked], inst, max_instances=4),
            "camera": look_down_z_camera(aspect=1.0, pos=(0.0, 0.0, 5.0)), "features": ("albedo",), "masked": True}


def _plane_scene():
    """The production-sampler plane: the 4-quadrant atlas (albedo, normal map,
    metallic-roughness with occlusion, emissive) and a sun."""
    atlas = np.zeros((64, 64, 4), np.uint8)
    atlas[0:32, 0:32] = (200, 80, 40, 255)
    atlas[0:32, 32:64, 0:3] = ((np.array([0.6, 0.0, 0.8]) * 0.5 + 0.5) * 255.0).astype(np.uint8)
    atlas[0:32, 32:64, 3] = 255
    atlas[32:64, 0:32] = (128, 64, 192, 255)
    atlas[32:64, 32:64] = (0, 255, 0, 255)
    rects = {"alb": (0.0, 0.0, 0.5, 0.5), "nrm": (0.5, 0.0, 1.0, 0.5), "mr": (0.0, 0.5, 0.5, 1.0),
             "em": (0.5, 0.5, 1.0, 1.0)}
    mats = [dict(albedo_color=(1.0, 1.0, 1.0, 1.0), metallic_factor=1.0, roughness_factor=1.0,
                 emissive_color=(2.0, 2.0, 2.0), albedo_texture="alb", normal_texture="nrm",
                 metallic_roughness_texture="mr", occlusion_texture="mr", emissive_texture="em")]
    s = JScene("plane", spec=JSceneSpec(max_entities=8))
    plane = s.create_entity("plane")
    plane.add("TransformComponent", position=(0.0, 0.0, 0.0))
    sun = s.create_entity("sun")
    sun.add("TransformComponent", rotation=(-0.3826834, 0.0, 0.0, 0.9238795))
    sun.add("LightComponent", type="Directional", intensity=4.0)
    f = jnp.float32
    cam = jcamera_matrices(position=jnp.array([0.0, 3.0, 3.0]), yaw=f(-np.pi / 2), pitch=f(-0.78), tilt=f(0.0),
                           fov_deg=f(60.0), near=f(0.1), far=f(100.0), zoom=f(1.0), projection_kind=jnp.int32(0),
                           aspect=f(W / H))
    return {"atlas": atlas, "rects": rects, "mats": mats, "state": s.to_device_state(),
            "gscene": jupload([jbake(*plane_mesh(size=4.0))], [(0, plane.index, 0)], max_instances=2),
            "camera": cam, "features": ("albedo", "normal", "emissive", "mr"), "masked": False}


def _render_both(sc, states, capacity=8):
    """Both renderers over `states` (one frame each, the carry fed back).
    Returns (JAX frames, port frames, the port's tile raster K2s per frame)."""
    spec = dict(width=W, height=H, max_visible_meshlets=64)
    cfg_kw = dict(vbgtao_enable=False, bloom_enable=False)
    jr = JRenderer(JSpec(**spec, gbuffer_interpret=True))
    jm = jmat.pack_materials([jmat.Material(**m) for m in sc["mats"]], sc["rects"], capacity)
    kw = dict(textured=True, texture_features=sc["features"], alpha_masked=sc["masked"])
    want, prev = [], {}
    with jax_device_paths(), host_branches():
        for st in states:
            ctx = jr.render(st, sc["gscene"], sc["camera"], jm, jnp.asarray(sc["atlas"]),
                            dataclasses.replace(JConfig(), **cfg_kw), prev=prev, **kw)
            prev = ctx["carry"]
            want.append(jax.device_get({k: ctx[k] for k in ("depth", "visbuffer", "final", "gbuffer")}))
    tr_ = RendererInstance(RenderSpec(**spec))
    tm = tmat.pack_materials([tmat.Material(**m) for m in sc["mats"]], sc["rects"], capacity, device="cpu")
    gscene = bridge.gpu_scene_from_numpy(jax.device_get(sc["gscene"]))
    cam = _camera(jax.device_get(sc["camera"]))
    got, k2s, prev = [], [], {}
    orig = tr.run_tiles
    calls = []
    tr.run_tiles = lambda *a: (calls.append(a[0].shape[1]), orig(*a))[1]
    try:
        for st in states:
            n0 = len(calls)
            ctx = tr_.render(bridge.scene_state_from_numpy(jax.device_get(st)), gscene, cam, tm,
                             torch.from_numpy(sc["atlas"]), dataclasses.replace(RendererConfig(), **cfg_kw),
                             prev=prev, **kw)
            prev = ctx["carry"]
            got.append({"depth": ctx["depth"].numpy(), "visbuffer": ctx["visbuffer"].numpy(),
                        "final": ctx["final"].numpy(), "gbuffer": {k: v.numpy() for k, v in ctx["gbuffer"].items()},
                        "slot_material": ctx["slot_material"].numpy()})
            k2s.append(calls[n0:])
    finally:
        tr.run_tiles = orig
    return want, got, k2s


def _assert_frame_matches(got, want):
    vid_eq = got["visbuffer"] == want["visbuffer"]
    assert (got["depth"] == want["depth"]).mean() >= EQ_MIN and vid_eq.mean() >= EQ_MIN
    # pixels whose 5×5 neighbourhood has equal vids in both packages
    pad = np.pad(~vid_eq, 2, constant_values=False)
    near_diff = np.zeros_like(vid_eq)
    for dy in range(5):
        for dx in range(5):
            near_diff |= pad[dy : dy + H, dx : dx + W]
    calm = ~near_diff
    assert calm.mean() > 0.9
    for k in GB_KEYS:
        err = np.abs(got["gbuffer"][k] - np.asarray(want["gbuffer"][k]))[calm].max()
        assert err <= GB_TOL, (k, err)
    assert psnr(got["final"], want["final"]) >= PSNR_MIN


def _red_green(frame):
    """`test_alpha_mask_discard_in_3d_frame`'s assertions: inside the quad's
    footprint the kept half is red, the discarded half shows the green wall,
    and no pixel is a hole."""
    alb, vid = frame["gbuffer"]["albedo"][..., :3], frame["visbuffer"]
    c, span = W // 2, int(W * 0.23)
    red = (alb[..., 0] > 0.5) & (alb[..., 1] < 0.3)
    green = (alb[..., 1] > 0.5) & (alb[..., 0] < 0.3)
    inner = np.s_[c - span // 2 : c + span // 2, c - span // 2 : c + span // 2]
    assert red[inner].mean() > 0.25, f"masked quad missing ({red[inner].mean():.2f})"
    assert green[inner].mean() > 0.25, f"discard shows holes ({green[inner].mean():.2f})"
    assert (vid[inner] >= 0).all(), "discarded pixels must fall through to the wall"
    return red


@pytest.fixture(scope="module")
def masked_frames():
    sc = _mask_scene(occluder=False)
    return _render_both(sc, [sc["state"]])


def test_alpha_mask_discard_matches_jax(masked_frames):
    want, got, k2s = masked_frames
    assert k2s == [[256, 128]]  # the opaque pass, then the masked pass at its own K2
    _assert_frame_matches(got[0], want[0])
    for frame in (want[0], got[0]):
        _red_green(frame)


def test_masked_vids_follow_the_late_pass():
    """Frame 0: the occluder hides wall, quad and a small block, and fills the
    pyramid. Frame 1: the occluder is moved out of view; the block, hidden in
    the first pyramid at a fine level, fails the early test and the late pass
    rasters it (the wall's footprint reaches the pyramid's far padding, so it
    passes early), and the masked pass the quad, whose vids follow both
    passes' groups and still resolve to the quad's material."""
    sc = _mask_scene(occluder=True)
    st0 = sc["state"]
    world = np.array(st0.world)
    occ_idx = int(np.asarray(sc["gscene"].inst_entity)[2])
    world[occ_idx, 0, 3] = 100.0  # far outside the frustum
    st1 = dataclasses.replace(st0, world=jnp.asarray(world))
    want, got, k2s = _render_both(sc, [st0, st1])
    assert k2s == [[256, 128], [256, 128, 128]]  # frame 1: early, late, masked
    for g, w in zip(got, want):
        _assert_frame_matches(g, w)
    red = _red_green(got[1])
    _red_green(want[1])
    k2 = 256
    groups_before_masked = got[1]["slot_material"].size // k2 - (H // 64) * (W // 64)  # all but the masked pass's
    vid = got[1]["visbuffer"]
    assert (vid[red] >= groups_before_masked * 256).all()  # the kept quad pixels carry the masked pass's offset
    flat = (vid[red] >> 8) * k2 + (vid[red] & 255)
    assert (got[1]["slot_material"][flat] == 1).all()  # ... and resolve to the quad's material


def test_production_sampler_scene_matches_jax():
    sc = _plane_scene()
    want, got, k2s = _render_both(sc, [sc["state"]])
    assert k2s == [[256]]  # no masked material: no masked pass
    _assert_frame_matches(got[0], want[0])
    g = got[0]["gbuffer"]
    hit = g["hit"]
    # every map sampled: albedo (200, 80, 40)/255, metallic 192/255, occlusion 128/255, emissive green ×2
    np.testing.assert_allclose(np.median(g["albedo"][hit], 0), [200 / 255, 80 / 255, 40 / 255], atol=0.02)
    assert abs(np.median(g["metallic"][hit]) - 192 / 255) < 0.02 and abs(np.median(g["occlusion"][hit]) - 128 / 255) < 0.02
    assert np.median(g["emissive"][hit][:, 1]) > 1.9 and np.median(g["emissive"][hit][:, 0]) < 0.02
    assert np.median(np.abs(g["normal"][hit][:, 0])) > 0.3  # the tilted normal map moved the normals off +Y


def test_only_the_nearest_masked_fragment_resolves():
    """ROADMAP C, a reference defect reproduced: the masked pass keeps one
    fragment per pixel, the nearest masked one. Two masked quads stand in
    front of a green wall: the near one red with its texture's right half cut
    out (alpha 0), the far one blue and whole. Where the near quad's cutout
    lies over the far quad, the engine this ports from would show the blue
    quad; the G-buffer path shows the wall, because the far quad's fragment
    never reached the pass (`renderer3d.py:471-515` in the JAX package)."""
    atlas = np.zeros((64, 64, 4), np.uint8)
    atlas[..., :3] = 220
    atlas[:, :32, 3] = 255  # the left half of the atlas opaque, the right half cut out
    rects = {"half": (0.0, 0.0, 1.0, 1.0), "whole": (0.0, 0.0, 0.5, 1.0)}
    mats = tmat.pack_materials([
        tmat.Material(albedo_color=(0.1, 0.9, 0.1, 1.0)),
        tmat.Material(albedo_color=(1.0, 0.1, 0.1, 1.0), albedo_texture="half", alpha_mode=tmat.ALPHA_MASK,
                      alpha_cutoff=0.5),
        tmat.Material(albedo_color=(0.1, 0.1, 1.0, 1.0), albedo_texture="whole", alpha_mode=tmat.ALPHA_MASK,
                      alpha_cutoff=0.5),
    ], rects, 8, device="cpu")
    s = JScene("stacked", spec=JSceneSpec(max_entities=8))
    for name, z, scale in (("wall", -2.0, (8.0, 8.0, 0.5)), ("far", -1.0, (3.0, 3.0, 0.1)),
                           ("near", 0.0, (3.0, 3.0, 0.1))):
        s.create_entity(name).add("TransformComponent", position=(0.0, 0.0, z), scale=scale)
    baked = jbake(*cube_mesh())
    state = bridge.scene_state_from_numpy(jax.device_get(s.to_device_state()))
    cam = _camera(jax.device_get(look_down_z_camera(aspect=1.0, pos=(0.0, 0.0, 5.0))))
    cfg = dataclasses.replace(RendererConfig(), vbgtao_enable=False, bloom_enable=False)
    c, span = W // 2, int(W * 0.23)

    def inner_colours(instances):
        gscene = bridge.gpu_scene_from_numpy(jax.device_get(jupload([baked] * 3, instances, max_instances=4)))
        ctx = RendererInstance(RenderSpec(width=W, height=H, max_visible_meshlets=64)).render(
            state, gscene, cam, mats, torch.from_numpy(atlas), cfg, textured=True, texture_features=("albedo",),
            alpha_masked=True)
        inner = ctx["gbuffer"]["albedo"].numpy()[c - span // 2 : c + span // 2, c - span // 2 : c + span // 2]
        red = (inner[..., 0] > 0.5) & (inner[..., 2] < 0.3)
        green = (inner[..., 1] > 0.5) & (inner[..., 0] < 0.3) & (inner[..., 2] < 0.3)
        blue = (inner[..., 2] > 0.5) & (inner[..., 0] < 0.3)
        return red.mean(), green.mean(), blue.mean()

    wall, far, near = (0, s.entity("wall").index, 0), (1, s.entity("far").index, 2), (2, s.entity("near").index, 1)
    assert inner_colours([wall, far])[2] > 0.9  # alone, the far quad covers the centre
    red, green, blue = inner_colours([wall, far, near])
    assert red > 0.25 and green > 0.25  # the near quad's kept half, and the wall through its cutout
    assert blue == 0.0  # the far masked quad behind the cutout never shows
