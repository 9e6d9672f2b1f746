"""The port's 3D frame against the JAX package's.

Host and culling stages are compared on small inputs; then whole frames on the
config-5 scene (`oxylus_tpu_torch/frame5.py`) cut to 12 objects and 40 boxes
(capacity 256, the least the compact kernel takes) at 256×144, with the camera
moved from (0, 8, 30) to (0, 3, 9) so the smaller scene fills the frame:

- frame parity: `RendererInstance.render` of both packages on one carried
  state, gscene, camera and material table, two frames (the boxes move in
  between and reveal objects, so the second runs both occlusion passes);
- runner parity: the port's `SceneRunner(render_mode="3d", use_megakernel=True)`
  for three frames against the JAX runner's fused frame (`runtime.py:552-569`)
  composed from `frame_step` with its compact kernel in interpret mode,
  `camera_from_state` and `render`.

The JAX renderer runs its tile raster in interpret mode
(`RenderSpec(gbuffer_interpret=True)`), and its `build_hiz` is patched, for this
module only, to the device path `build_hiz_pallas` in interpret mode: the JAX
package on the CPU builds a power-of-two pyramid instead, with other level
shapes. The JAX frame graph runs op by op, not under one `jax.jit`: a jit fuses
the setup arithmetic and contracts products into fused multiply-adds, which
moves plane coefficients by float32 rounding and so the depth resolved to 16
bits on many pixels; op by op, every op rounds on its own as the port's do. Bounds: final images PSNR ≥ 40 dB (the goldens' bound,
`test_golden_images.py:96`); hit masks ≥ 99.9 % equal, depth ≥ 99.5 % equal on
jointly hit pixels, ids resolved through the slot tables ≥ 99 % equal
(`test_gbuffer_raster.py:342`); bodies within the slice-1 bounds."""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import oxylus_tpu.ops.hiz as jhiz
import oxylus_tpu.physics.megakernel_compact as jmc
from oxylus_tpu.assets.bake import bake_mesh as jbake_mesh
from oxylus_tpu.ops import cull as jcull
from oxylus_tpu.physics.state import PhysicsParams as JParams
from oxylus_tpu.render import camera as jcamera
from oxylus_tpu.render import pbr as jpbr
from oxylus_tpu.render import postfx as jpostfx
from oxylus_tpu.runtime import SceneRunner as JRunner
from oxylus_tpu.scene import frame as jframe
from oxylus_tpu.scene import state as jstate
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu_torch import bridge, frame5
from oxylus_tpu_torch.assets.bake import bake_mesh
from oxylus_tpu_torch.ops import cull as tcull
from oxylus_tpu_torch.ops import raster3d as tr
from oxylus_tpu_torch.ops.compact import masked_compact
from oxylus_tpu_torch.render import camera as tcamera
from oxylus_tpu_torch.render import pbr as tpbr
from oxylus_tpu_torch.render import postfx as tpostfx
from oxylus_tpu_torch.render.renderer3d import RenderSpec, RendererInstance
from oxylus_tpu_torch.runtime import SceneRunner
from tests.test_native_bake import sphere_mesh
from tests.test_render3d import cube_mesh

torch.set_num_threads(1)

W, H = 256, 144
N_OBJECTS, N_BOXES, MAX_BODIES = 12, 40, 256
DT = 1.0 / 40.0
RUNNER_FRAMES = 3
CAMERA_POS = (0.0, 3.0, 9.0)
ATOL = {"pos": 5e-5, "linvel": 1e-3, "angvel": 5e-3, "quat": 1e-4}  # test_torch_frame.py's bounds
PSNR_MIN = 40.0


def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


@contextlib.contextmanager
def jax_device_paths():
    """The JAX package's device kernels in interpret mode: `build_hiz` becomes
    `build_hiz_pallas` with `pallas_call(interpret=True)`, and the compact
    kernel runs with `interpret=True`."""
    orig_pc, orig_hiz, orig_mc = pl.pallas_call, jhiz.build_hiz, jmc.megakernel_substeps_compact
    pl.pallas_call = functools.partial(orig_pc, interpret=True)
    jhiz.build_hiz = jhiz.build_hiz_pallas
    jmc.megakernel_substeps_compact = functools.partial(orig_mc, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call, jhiz.build_hiz, jmc.megakernel_substeps_compact = orig_pc, orig_hiz, orig_mc


def _jax_runner():
    s = JScene("full_frame", spec=jstate.SceneSpec(max_entities=1024, max_bodies=MAX_BODIES))
    frame5.populate_frame5(s, N_OBJECTS, N_BOXES)
    s.set_field(s.entity("camera").index, "TransformComponent", "position", CAMERA_POS)
    s.renderer_config = dataclasses.replace(s.renderer_config, vbgtao_enable=False, ssr_enable=False)
    from oxylus_tpu.render.renderer3d import RenderSpec as JSpec

    meshes = [jbake_mesh(*cube_mesh()), jbake_mesh(*sphere_mesh(16, 32))]
    spec = JSpec(width=W, height=H, compact_raster=False, tris_per_tile=192, bin_groups_per_tile=32)
    runner = JRunner(s, width=W, height=H, render_mode="3d", meshes=meshes, render_spec=spec, use_megakernel=True)
    runner.renderer3d.spec = dataclasses.replace(runner.renderer3d.spec, gbuffer_interpret=True)
    return runner, meshes


@pytest.fixture(scope="module")
def jax_side():
    """Everything the JAX package computes for this module, in one place (its
    interpret-mode compiles are shared by the frame and runner runs)."""
    runner, meshes = _jax_runner()
    keys = ("final", "visbuffer", "depth", "slot_packed_id", "bin_overflow", "expand_overflow")

    def _render(state, gscene, camera, materials, atlas, prev):
        ctx = runner.renderer3d.render(state, gscene, camera, materials, atlas, runner.config, prev=prev,
                                       static_lights=runner._static_lights)
        return {k: ctx[k] for k in keys}, ctx["carry"]

    render = _render  # eager: each op rounds on its own, as the port's do (a jit fuses and contracts)
    step = jax.jit(jframe.frame_step.__wrapped__, static_argnames=("spec", "has_bodies", "physics_mega"))
    cam_idx = runner._resolve_camera_idx()
    aspect = jnp.float32(W / H)
    mats, atlas = runner.bindings.materials, runner.bindings.atlas
    out = {"meshes": meshes, "gscene": jax.device_get(runner.gscene), "spec": runner.renderer3d.spec,
           "static_lights": runner._static_lights, "materials": jax.device_get(mats)}
    with jax_device_paths():
        # frame parity: two frames of the renderer; in the first the boxes, scaled
        # by 1.25 so they touch, stand as a wall in front of the objects, in the
        # second they are back in the air, so objects hidden in the first frame's
        # pyramid are revealed (late pass)
        state1 = runner.state
        world = np.array(state1.world)
        boxes = np.array([s.startswith("box_") for s in (runner.scene._names[i] or "" for i in range(len(world)))])
        world[boxes, :3, :3] *= 1.25
        world[boxes, 1, 3] -= 1.5
        world[boxes, 2, 3] += 4.0
        state0 = dataclasses.replace(state1, world=jnp.asarray(world))
        frames, carry = [], {}
        for st in (state0, state1):
            cam = jcamera.camera_from_state(st, cam_idx, aspect)
            res, carry = render(st, runner.gscene, cam, mats, atlas, carry)
            frames.append(jax.device_get(dict(res, state=st, camera=cam)))
        out["frames"] = frames
        # runner parity: the fused frame, composed
        state, ps, carry, images = runner.state, runner.ps, {}, []
        for _ in range(RUNNER_FRAMES):
            state, ps = step(state, ps, JParams(), jnp.float32(DT), runner.scene.spec, has_bodies=True,
                             physics_mega=True)
            cam = jcamera.camera_from_state(state, cam_idx, aspect)
            res, carry = render(state, runner.gscene, cam, mats, atlas, carry)
            images.append(np.asarray(res["final"]))
        out["runner"] = dict(images=images, ps=jax.device_get(ps), carry=jax.device_get(carry))
    return out


def _port_spec(jspec) -> RenderSpec:
    kw = {f.name: getattr(jspec, f.name) for f in dataclasses.fields(RenderSpec)}
    return RenderSpec(**kw)


def _camera(c) -> tcamera.CameraMatrices:
    return tcamera.CameraMatrices(**{f.name: torch.from_numpy(np.array(getattr(c, f.name)))
                                     for f in dataclasses.fields(tcamera.CameraMatrices)})


@pytest.fixture(scope="module")
def port_frames(jax_side):
    """The port's renderer on the JAX frames' inputs."""
    renderer = RendererInstance(_port_spec(jax_side["spec"]))
    gscene = bridge.gpu_scene_from_numpy(jax_side["gscene"])
    mats = bridge.gpu_materials_from_numpy(jax_side["materials"])
    atlas = torch.zeros((64, 64, 4), dtype=torch.uint8)
    config = frame5.RendererConfig(vbgtao_enable=False, ssr_enable=False)
    calls = []
    orig = tr.run_tiles

    def counting(*a, **k):
        calls.append(a[0].shape[1])
        return orig(*a, **k)

    tr.run_tiles = counting
    try:
        carry, out = {}, []
        for f in jax_side["frames"]:
            n0 = len(calls)
            st = bridge.scene_state_from_numpy(f["state"])
            ctx = renderer.render(st, gscene, _camera(f["camera"]), mats, atlas, config, prev=carry,
                                  static_lights=jax_side["static_lights"])
            carry = ctx["carry"]
            out.append({k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in ctx.items()
                        if k in ("final", "visbuffer", "depth", "slot_packed_id", "bin_overflow", "expand_overflow")})
            out[-1]["raster_k2"] = calls[n0:]
    finally:
        tr.run_tiles = orig
    return out


def test_bake_matches_jax(jax_side):
    for jm, mesh_fn in zip(jax_side["meshes"], (cube_mesh, lambda: sphere_mesh(16, 32))):
        want = bridge.baked_mesh_to_numpy(jm)
        got = bridge.baked_mesh_to_numpy(bake_mesh(*mesh_fn()))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(jax_side["meshes"][1].lods) > 1  # the sphere has an LOD chain


def test_frame5_meshes_are_the_test_meshes():
    for a, b in zip(frame5.cube_mesh(), cube_mesh()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(frame5.sphere_mesh(16, 32), sphere_mesh(16, 32)):
        np.testing.assert_array_equal(a, b)


def test_runner_uploads_the_jax_gscene(jax_side):
    scene, kw = frame5.build_frame5_scene(W, H, N_OBJECTS, N_BOXES, max_bodies=MAX_BODIES, device="cpu")
    runner = SceneRunner(scene, **kw)
    got = bridge.gpu_scene_to_numpy(runner.gscene)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jax_side["gscene"], k)), err_msg=k)
    assert runner.renderer3d.spec == _port_spec(jax_side["spec"])
    assert runner._static_lights == jax_side["static_lights"]


def test_camera_from_state_matches_jax(jax_side):
    f = jax_side["frames"][0]
    cam_idx = int(np.nonzero(np.asarray(f["state"].mask["CameraComponent"]))[0][0])
    got = tcamera.camera_from_state(bridge.scene_state_from_numpy(f["state"]), cam_idx, W / H)
    for fld in dataclasses.fields(tcamera.CameraMatrices):
        np.testing.assert_allclose(getattr(got, fld.name).numpy(), np.asarray(getattr(f["camera"], fld.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=fld.name)
    np.testing.assert_allclose(got.view_projection.numpy(), np.asarray(f["camera"].view_projection),
                               rtol=1e-6, atol=1e-6)


def test_cull_and_compact_match_exactly(jax_side):
    f = jax_side["frames"][1]
    gs_j, cam = jax.tree_util.tree_map(jnp.asarray, jax_side["gscene"]), f["camera"]
    world = jnp.asarray(f["state"].world)
    cap = jax_side["spec"].max_meshlet_instances
    vis, lod = jcull.cull_instances(gs_j, world, jnp.asarray(cam.frustum_planes), jnp.asarray(cam.position),
                                    jnp.float32(H * abs(float(cam.projection[1, 1])) / 2.0))
    mi = jcull.expand_meshlet_instances(gs_j, vis, lod, cap, with_overflow=True)
    vm = jcull.cull_meshlets(gs_j, world, *mi[:3], jnp.asarray(cam.frustum_planes), jnp.asarray(cam.position),
                             capacity=jax_side["spec"].max_visible_meshlets, depth_sort=True)
    gs_t, tw = bridge.gpu_scene_from_numpy(jax_side["gscene"]), torch.from_numpy(np.asarray(world))
    pl_t, pos_t = torch.from_numpy(np.asarray(cam.frustum_planes)), torch.from_numpy(np.asarray(cam.position))
    tvis, tlod = tcull.cull_instances(gs_t, tw, pl_t, pos_t, torch.tensor(H * abs(float(cam.projection[1, 1])) / 2.0))
    tmi = tcull.expand_meshlet_instances(gs_t, tvis, tlod, cap, with_overflow=True)
    tvm = tcull.cull_meshlets(gs_t, tw, *tmi[:3], pl_t, pos_t, capacity=jax_side["spec"].max_visible_meshlets,
                              depth_sort=True)
    for got, want in zip((tvis, tlod, *tmi, *tvm), (vis, lod, *mi, *vm)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(tvm[3]) < len(tvm[0])  # some meshlets culled, some kept
    mask = np.random.default_rng(1).uniform(size=300) < 0.3
    from oxylus_tpu.ops.compact import masked_compact as jmasked

    for cap in (50, 200):  # overflowing and not
        for got, want in zip(masked_compact(torch.from_numpy(mask), cap), jmasked(jnp.asarray(mask), cap)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gbuffer(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    g = {
        "normal": n, "world_pos": rng.uniform(-3, 3, (h, w, 3)).astype(np.float32),
        "albedo": rng.uniform(0, 1, (h, w, 3)).astype(np.float32),
        "metallic": rng.uniform(0, 1, (h, w)).astype(np.float32),
        "roughness": rng.uniform(0, 1, (h, w)).astype(np.float32),
        "emissive": rng.uniform(0, 0.2, (h, w, 3)).astype(np.float32),
        "hit": rng.uniform(size=(h, w)) < 0.8,
    }
    return g


def test_apply_pbr_matches_jax(jax_side):
    st = jax_side["frames"][0]["state"]
    comp = dict(st.comp)
    lc = {k: np.array(v) for k, v in comp["LightComponent"].items()}
    mask = np.array(st.mask["LightComponent"]).copy()
    world = np.array(st.world).copy()
    # add a point and a spot light next to the sun, 11 lights in all with 9 in the static blocks
    rng = np.random.default_rng(3)
    free = np.nonzero(~np.array(st.alive))[0][:10]
    for j, i in enumerate(free):
        mask[i] = True
        lc["type"][i] = 1 + j % 2
        lc["intensity"][i] = 3.0
        lc["radius"][i] = 6.0
        world[i, :3, 3] = rng.uniform(-3, 3, 3)
    alive = np.array(st.alive).copy()
    alive[free] = True
    st2 = dataclasses.replace(st, alive=alive, world=world, comp=dict(comp, LightComponent=lc),
                              mask=dict(st.mask, LightComponent=mask))
    g = _gbuffer(5)
    cam_pos = np.array([0.5, 4.0, 9.0], np.float32)
    amb = np.array([0.03, 0.03, 0.03], np.float32)
    jl = jpbr.lights_from_state(jax.tree_util.tree_map(jnp.asarray, st2))
    tl = tpbr.lights_from_state(bridge.scene_state_from_numpy(st2))
    for fld in ("kind", "color", "intensity", "position", "valid", "count"):
        np.testing.assert_array_equal(getattr(tl, fld).numpy(), np.asarray(getattr(jl, fld)), err_msg=fld)
    for static in (1, 9):
        want = np.asarray(jpbr.apply_pbr({k: jnp.asarray(v) for k, v in g.items()}, jl, jnp.asarray(cam_pos),
                                         jnp.asarray(amb), static_lights=static))
        got = tpbr.apply_pbr({k: torch.from_numpy(v) for k, v in g.items()}, tl, torch.from_numpy(cam_pos),
                             torch.from_numpy(amb), static_lights=static).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tonemapper", [0, 1, 2, 3])
def test_postfx_matches_jax(tonemapper):
    rng = np.random.default_rng(tonemapper)
    hdr = (rng.uniform(0, 1, (72, 128, 3)) ** 4 * 6).astype(np.float32)
    jb = np.asarray(jpostfx.apply_bloom(jnp.asarray(hdr)))
    tb = tpostfx.apply_bloom(torch.from_numpy(hdr)).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-5)
    jt = np.asarray(jpostfx.apply_tonemap(jnp.asarray(jb), tonemapper=tonemapper, exposure=1.3))
    tt = tpostfx.apply_tonemap(torch.from_numpy(jb), tonemapper=tonemapper, exposure=1.3).numpy()
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-5)
    jf = np.asarray(jpostfx.apply_fxaa(jnp.asarray(jt)))
    tf = tpostfx.apply_fxaa(torch.from_numpy(jt)).numpy()
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        tpostfx.apply_tonemap(torch.from_numpy(jb), film_grain=0.1)


def _fractions(got, want, k2):
    hit, hit_j = got["visbuffer"] >= 0, want["visbuffer"] >= 0
    joint = hit & hit_j
    flat = lambda v, n: np.clip((v >> 8) * k2 + (v & 255), 0, n - 1)
    ids = got["slot_packed_id"][flat(got["visbuffer"], got["slot_packed_id"].size)]
    ids_j = want["slot_packed_id"][flat(want["visbuffer"], want["slot_packed_id"].size)]
    return ((hit == hit_j).mean(), (got["depth"][joint] == want["depth"][joint]).mean(),
            (ids[joint] == ids_j[joint]).mean(), hit_j.mean())


@pytest.mark.parametrize("frame", [0, 1])
def test_render_frame_matches_jax(jax_side, port_frames, frame):
    want, got = jax_side["frames"][frame], port_frames[frame]
    hit_eq, depth_eq, id_eq, fill = _fractions(got, want, jax_side["spec"].tris_per_tile)
    assert fill > 0.1
    assert hit_eq >= 0.999 and depth_eq >= 0.995 and id_eq >= 0.99, (hit_eq, depth_eq, id_eq)
    assert psnr(got["final"], want["final"]) >= PSNR_MIN
    assert int(got["expand_overflow"]) == int(want["expand_overflow"]) == 0
    assert int(got["bin_overflow"]) == int(want["bin_overflow"])
    # frame 0 has no pyramid yet: one pass; frame 1 runs the early pass and the late pass
    assert got["raster_k2"] == ([192] if frame == 0 else [192, 128])


@pytest.fixture(scope="module")
def port_runner():
    scene, kw = frame5.build_frame5_scene(W, H, N_OBJECTS, N_BOXES, max_bodies=MAX_BODIES, device="cpu")
    scene.set_field(scene.entity("camera").index, "TransformComponent", "position", CAMERA_POS)
    runner = SceneRunner(scene, **kw)
    images = [runner.step(DT).numpy() for _ in range(RUNNER_FRAMES)]
    return runner, images


def test_runner_bodies_match_jax(jax_side, port_runner):
    runner, _ = port_runner
    want = jax_side["runner"]["ps"]
    got = bridge.physics_state_to_numpy(runner.ps)
    for k, tol in ATOL.items():
        np.testing.assert_allclose(got[k], np.asarray(getattr(want, k)), rtol=0, atol=tol, err_msg=k)
    assert np.abs(got["linvel"]).max() > 0.5  # the boxes are falling


def test_runner_images_match_jax(jax_side, port_runner):
    runner, images = port_runner
    for got, want in zip(images, jax_side["runner"]["images"]):
        assert got.shape == (H, W, 3) and np.isfinite(got).all() and got.min() >= 0 and got.max() <= 1
        assert psnr(got, want) >= PSNR_MIN
    assert set(runner.carry) == {"hiz", "expand_overflow", "bin_overflow"}
    assert int(runner.carry["expand_overflow"]) == 0
