"""The port's 3D frame against the JAX package's.

Host and culling stages are compared on small inputs; then whole frames of
the full config 5 (atmosphere, clipmap shadows, GTAO, SSR, aerial
perspective) on the config-5 scene (`oxylus_tpu_torch/frame5.py`) cut to 12
objects and 40 boxes (capacity 256, the least the compact kernel takes) at
256×144, with the camera moved from (0, 8, 30) to (0, 3, 9) so the smaller
scene fills the frame:

- frame parity: `RendererInstance.render` of both packages on one carried
  state, gscene, camera and material table, three frames: the first (the
  boxes, scaled by 1.25, stand as a wall in front of the objects), the same
  state again (a static-frame memo hit: shadow term, AO and aerial apply come
  from the carry; the shadow pages the first frame marked dynamic re-render
  once), then the boxes back in the air (the memo misses, the shadow pages
  under the moved boxes re-render, and objects hidden in the first pyramid are
  revealed: the late pass runs);
- runner parity (`tests/test_torch_render3d_runner.py`): the port's
  `SceneRunner(**build_frame5_scene(...)[1])` for three frames against the JAX
  runner built as `bench._build_frame5_runner` does, its fused frame
  (`runtime.py:552-569`) composed from `frame_step` with its compact kernel in
  interpret mode, `camera_from_state` and `render`;
- the golden scene (`tests/test_torch_render3d_golden.py`,
  `tests/test_golden_images.py::_world`) with the `sky`, `shadows` and `full`
  settings, against the JAX renderer on the same tile path and against the
  stored goldens (made by the JAX decode path, `use_pallas=False`).

The three files share this module's helpers and its module-scoped shadow-map
fixture; each runs its own JAX side, so the test workers take them in
parallel.

The JAX renderer runs its tile raster in interpret mode
(`RenderSpec(gbuffer_interpret=True)`), and its `build_hiz` is patched, for this
module only, to the device path `build_hiz_pallas` in interpret mode: the JAX
package on the CPU builds a power-of-two pyramid instead, with other level
shapes. Its shadows draw through `rasterize_pallas` in interpret mode (the
module's `rasterize_reference` name patched for this module only: the port's
depth raster mirrors the kernel), and both packages' shadow maps are shrunk to
256² (`SHADOW_MAP_SIZE = 256`, `PAGES = 4`). Its `lax.cond` / `lax.switch`
caches run as Python branches on their concrete predicates, as the port takes
them on the host. The JAX frame graph runs op by op, not under one `jax.jit`:
a jit fuses the setup arithmetic and contracts products into fused
multiply-adds, which moves plane coefficients by float32 rounding and so the
depth resolved to 16 bits on many pixels; op by op, every op rounds on its own
as the port's do. The functions the JAX package jits itself (the sky LUTs,
`gtao`, `ssr_trace`) stay jitted. Bounds: final images PSNR ≥ 40 dB (the
goldens' bound, `test_golden_images.py:96`); hit masks ≥ 99.9 % equal, depth
≥ 99.5 % equal on jointly hit pixels, ids resolved through the slot tables ≥
99 % equal (`test_gbuffer_raster.py:342`); the shadow factor within 1e-6 on
≥ 99 % of pixels, the AO within 1/32 on ≥ 99 % (`test_torch_gtao_ssr.py`:
the jitted `gtao` moves a sector on a few pixels); bodies within the slice-1
bounds."""

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
import oxylus_tpu.render.shadows as jshadows
from oxylus_tpu.assets.bake import bake_mesh as jbake_mesh
from oxylus_tpu.ops import cull as jcull
from oxylus_tpu.ops.raster3d import rasterize_pallas
from oxylus_tpu.render import camera as jcamera
from oxylus_tpu.render import pbr as jpbr
from oxylus_tpu.render import postfx as jpostfx
from oxylus_tpu.render.sky import AtmosphereParams as JAtmosphere
from oxylus_tpu.runtime import SceneRunner as JRunner
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
from oxylus_tpu_torch.render import shadows as tshadows
from oxylus_tpu_torch.render import sky as tsky
from oxylus_tpu_torch.render.renderer3d import RenderSpec, RendererInstance
from oxylus_tpu_torch.runtime import SceneRunner
from tests.test_native_bake import sphere_mesh
from tests.test_render3d import cube_mesh
from tests.test_torch_shadows import host_branches

torch.set_num_threads(1)

W, H = 256, 144
N_OBJECTS, N_BOXES, MAX_BODIES = 12, 40, 256
CAMERA_POS = (0.0, 3.0, 9.0)
PSNR_MIN = 40.0
SHADOW_MAP, SHADOW_PAGES = 256, 4
FRAME_KEYS = ("final", "visbuffer", "depth", "slot_packed_id", "bin_overflow", "expand_overflow", "shadow", "ao")


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


@pytest.fixture(scope="module", autouse=True)
def _small_shadow_maps():
    """Both packages' shadow maps at 256² with 4 pages a side, and the JAX
    module's CPU raster through the interpret-mode kernel, for this module."""
    saved = [(m, k, getattr(m, k)) for m in (jshadows, tshadows) for k in ("SHADOW_MAP_SIZE", "PAGES")]
    saved.append((jshadows, "rasterize_reference", jshadows.rasterize_reference))
    for m in (jshadows, tshadows):
        m.SHADOW_MAP_SIZE, m.PAGES = SHADOW_MAP, SHADOW_PAGES
    jshadows.rasterize_reference = functools.partial(rasterize_pallas, interpret=True)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def _jax_runner():
    """`bench._build_frame5_runner` at this module's size."""
    s = JScene("full_frame", spec=jstate.SceneSpec(max_entities=1024, max_bodies=MAX_BODIES))
    frame5.populate_frame5(s, N_OBJECTS, N_BOXES)
    s.set_field(s.entity("camera").index, "TransformComponent", "position", CAMERA_POS)
    from oxylus_tpu.render.renderer3d import RenderSpec as JSpec

    meshes = [jbake_mesh(*cube_mesh()), jbake_mesh(*sphere_mesh(16, 32))]
    spec = JSpec(width=W, height=H, compact_raster=False, tris_per_tile=192, bin_groups_per_tile=32)
    runner = JRunner(s, width=W, height=H, render_mode="3d", meshes=meshes, render_spec=spec, use_megakernel=True,
                     enable_shadows=True)
    # the atmosphere, with its LUT cache prewarmed as the JAX runner does, but
    # from the port's LUTs (see `_jax_sky_luts`)
    runner.atmosphere = JAtmosphere()
    _jax_sky_luts(runner.renderer3d)
    runner.config = dataclasses.replace(runner.config, ssr_enable=True)
    runner.renderer3d.spec = dataclasses.replace(runner.renderer3d.spec, gbuffer_interpret=True)
    return runner, meshes


def _jax_sky_luts(renderer) -> None:
    """Fill a JAX renderer's LUT cache for `AtmosphereParams()` with the port's
    transmittance and multiple-scattering LUTs. The JAX functions at their full
    step counts take minutes to compile on the CPU (`multiscatter_lut` unrolls
    160 march steps); `tests/test_torch_sky.py` holds the two packages' LUTs
    against each other, so here both frame graphs read the same LUTs."""
    t_lut = tsky.transmittance_lut(bridge.atmosphere_from_jax(JAtmosphere()))
    ms_lut = tsky.multiscatter_lut(bridge.atmosphere_from_jax(JAtmosphere()), t_lut)
    renderer._sky_cache[JAtmosphere()] = (jnp.asarray(t_lut.numpy()), jnp.asarray(ms_lut.numpy()))


def jax_renderer(runner):
    """The JAX runner's renderer as `render(state, gscene, camera, materials,
    atlas, prev) -> (frame resources, carry)`, eager: each op rounds on its
    own, as the port's do (a jit fuses and contracts)."""

    def render(state, gscene, camera, materials, atlas, prev):
        ctx = runner.renderer3d.render(state, gscene, camera, materials, atlas, runner.config, prev=prev,
                                       atmosphere=runner.atmosphere, enable_shadows=runner.enable_shadows,
                                       static_lights=runner._static_lights)
        return {k: ctx[k] for k in FRAME_KEYS}, ctx["carry"]

    return render


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's side of this module: its runner's scene, gscene and
    material table, and three renderer frames."""
    runner, meshes = _jax_runner()
    render = jax_renderer(runner)
    cam_idx = runner._resolve_camera_idx()
    aspect = jnp.float32(W / H)
    mats, atlas = runner.bindings.materials, runner.bindings.atlas
    out = {"meshes": meshes, "gscene": jax.device_get(runner.gscene), "spec": runner.renderer3d.spec,
           "static_lights": runner._static_lights, "materials": jax.device_get(mats),
           "config": runner.config}
    with jax_device_paths(), host_branches():
        # frame parity: three frames of the renderer; in the first the boxes,
        # scaled by 1.25 so they touch, stand as a wall in front of the objects,
        # the second repeats it (a static-frame memo hit), in the third they are
        # back in the air, so objects hidden in the pyramid are revealed (late pass)
        state1 = runner.state
        world = np.array(state1.world)
        boxes = np.array([s.startswith("box_") for s in (runner.scene._names[i] or "" for i in range(len(world)))])
        world[boxes, :3, :3] *= 1.25
        world[boxes, 1, 3] -= 1.5
        world[boxes, 2, 3] += 4.0
        state0 = dataclasses.replace(state1, world=jnp.asarray(world))
        frames, carry = [], {}
        for st in (state0, state0, state1):
            if len(frames) == 2:
                out["carry1"] = jax.device_get(carry)  # the carry frame 2 starts from
            cam = jcamera.camera_from_state(st, cam_idx, aspect)
            res, carry = render(st, runner.gscene, cam, mats, atlas, carry)
            frames.append(jax.device_get(dict(res, state=st, camera=cam, carry_keys=sorted(carry))))
        out["frames"] = frames
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
    config = frame5.RendererConfig(ssr_enable=True)
    assert dataclasses.asdict(config) == dataclasses.asdict(jax_side["config"])  # the JAX runner's config
    atmosphere = bridge.atmosphere_from_jax(JAtmosphere())
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
                                  atmosphere=atmosphere, enable_shadows=True, static_lights=jax_side["static_lights"])
            carry = ctx["carry"]
            out.append({k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in ctx.items() if k in FRAME_KEYS})
            out[-1]["raster_k2"] = calls[n0:]
            out[-1]["carry_keys"] = sorted(carry)
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
    # chromatic aberration and vignette through the whole chain (held apart from the
    # curves within 1e-6 by `test_torch_debugviews_postfx.py`)
    fx = dict(tonemapper=tonemapper, exposure=1.3, chromatic_aberration=0.5, vignette=0.4)
    jt = np.asarray(jpostfx.apply_tonemap(jnp.asarray(jb), **fx))
    tt = tpostfx.apply_tonemap(torch.from_numpy(jb), **fx).numpy()
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-5)


def _fractions(got, want, k2):
    hit, hit_j = got["visbuffer"] >= 0, want["visbuffer"] >= 0
    joint = hit & hit_j
    flat = lambda v, n: np.clip((v >> 8) * k2 + (v & 255), 0, n - 1)
    ids = got["slot_packed_id"][flat(got["visbuffer"], got["slot_packed_id"].size)]
    ids_j = want["slot_packed_id"][flat(want["visbuffer"], want["slot_packed_id"].size)]
    return ((hit == hit_j).mean(), (got["depth"][joint] == want["depth"][joint]).mean(),
            (ids[joint] == ids_j[joint]).mean(), hit_j.mean())


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_render_frame_matches_jax(jax_side, port_frames, frame):
    want, got = jax_side["frames"][frame], port_frames[frame]
    hit_eq, depth_eq, id_eq, fill = _fractions(got, want, jax_side["spec"].tris_per_tile)
    assert fill > 0.1
    assert hit_eq >= 0.999 and depth_eq >= 0.995 and id_eq >= 0.99, (hit_eq, depth_eq, id_eq)
    assert psnr(got["final"], want["final"]) >= PSNR_MIN
    assert int(got["expand_overflow"]) == int(want["expand_overflow"]) == 0
    assert int(got["bin_overflow"]) == int(want["bin_overflow"])
    assert got["carry_keys"] == want["carry_keys"]
    # frame 0 has no pyramid yet: one pass; frame 1 reveals nothing; frame 2
    # runs the early pass and the late pass
    assert got["raster_k2"] == ([192, 128] if frame == 2 else [192])


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_frame_shadow_and_ao_match_jax(jax_side, port_frames, frame):
    want, got = jax_side["frames"][frame], port_frames[frame]
    assert (np.abs(got["shadow"] - want["shadow"]) <= 1e-6).mean() >= 0.99
    assert (np.abs(got["ao"] - want["ao"]) <= 1.0 / 32).mean() >= 0.99
    assert want["shadow"].min() < 0.5 and want["ao"].min() < 0.9  # shadowed and occluded pixels


def test_static_frame_memo_hit_and_miss(jax_side, port_frames):
    """Frame 1 repeats frame 0: both packages reuse its shadow term and AO;
    frame 2 moved the boxes: both recompute them."""
    for frames in (jax_side["frames"], port_frames):
        for k in ("shadow", "ao"):
            np.testing.assert_array_equal(frames[1][k], frames[0][k])
            assert (frames[2][k] != frames[1][k]).any()


def test_frame_from_the_jax_carry_matches_jax(jax_side):
    """The JAX renderer's carry after frame 1 (HiZ, shadow cache, sky and
    aerial LUTs with their keys, the static-frame memo's terms) carried into
    the port through `bridge`: exactly round-tripped, and the port's frame 2
    rendered from it matches the JAX frame 2 (the frame bounds above)."""
    carry1 = jax_side["carry1"]
    got = bridge.render_carry_from_numpy(carry1)
    assert {"shadow_cache", "sky_view_lut", "sky_key", "aerial_lut", "static_term_key", "shadow_full", "ao_full",
            "aerial_apply", "hiz"} <= set(got)
    back = bridge.render_carry_to_numpy(got)
    flat = lambda c: dict(jax.tree_util.tree_flatten_with_path(c)[0])
    want_leaves, got_leaves = flat(carry1), flat(back)
    assert want_leaves.keys() == got_leaves.keys()
    for k, v in want_leaves.items():
        np.testing.assert_array_equal(got_leaves[k], np.asarray(v), err_msg=str(k))
        assert got_leaves[k].dtype == np.asarray(v).dtype
    f = jax_side["frames"][2]
    renderer = RendererInstance(_port_spec(jax_side["spec"]))
    ctx = renderer.render(bridge.scene_state_from_numpy(f["state"]), bridge.gpu_scene_from_numpy(jax_side["gscene"]),
                          _camera(f["camera"]), bridge.gpu_materials_from_numpy(jax_side["materials"]),
                          torch.zeros((64, 64, 4), dtype=torch.uint8), frame5.RendererConfig(ssr_enable=True),
                          prev=got, atmosphere=bridge.atmosphere_from_jax(JAtmosphere()), enable_shadows=True,
                          static_lights=jax_side["static_lights"])
    assert psnr(ctx["final"].numpy(), f["final"]) >= PSNR_MIN
    assert (np.abs(ctx["shadow"].numpy() - f["shadow"]) <= 1e-6).mean() >= 0.99


def test_static_memo_key_misses_intrinsics_and_collides_on_swaps():
    """ROADMAP C: the static-frame memo's key (`renderer3d.py:702-709` in the
    JAX package) is the xor of the world matrices' int32 bit patterns, the sun,
    and the camera's position, forward and up. It leaves out the camera's
    intrinsics, so a fov change keeps the key (the memo would reuse a shadow
    term, AO and aerial apply drawn for the old projection), and the xor does
    not depend on order, so two entities' transforms swapped keep it too. The
    port reproduces the key bit for bit and does not fix it."""
    from oxylus_tpu_torch.render.renderer3d import static_frame_key, world_signature

    rng = np.random.default_rng(7)
    world = rng.normal(size=(12, 4, 4)).astype(np.float32)
    want = jax.lax.reduce(jax.lax.bitcast_convert_type(jnp.asarray(world), jnp.int32), jnp.int32(0),
                          jax.lax.bitwise_xor, (0, 1, 2))
    assert int(world_signature(torch.from_numpy(world))) == int(want)
    swapped = world[[3, 1, 2, 0, *range(4, 12)]]
    assert not np.array_equal(swapped, world)
    assert int(world_signature(torch.from_numpy(swapped))) == int(want)  # the collision
    sun = torch.tensor([0.3, -0.8, 0.2])
    keys = []
    for fov in (60.0, 75.0):
        cam = tcamera.camera_matrices(torch.tensor([0.0, 3.0, 9.0]), torch.tensor(-np.pi / 2), torch.tensor(-0.2),
                                      torch.tensor(0.0), torch.tensor(fov), torch.tensor(0.1), torch.tensor(100.0),
                                      torch.tensor(1.0), torch.tensor(0), torch.tensor(W / H))
        keys.append((static_frame_key(torch.from_numpy(world), sun, cam), cam.projection))
    assert not torch.equal(keys[0][1], keys[1][1])  # another projection ...
    assert torch.equal(keys[0][0], keys[1][0])  # ... the same key: a memo hit
