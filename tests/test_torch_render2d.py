"""The port's 2D path (`render/renderer2d.py`, `ops/raster2d.py`, the 2D
runner) and the 3D particle composite against the JAX package.

One JAX state carries into both packages through `bridge.scene_state_from_numpy`,
particles included (the spawn RNG streams differ by design, so each package
spawning its own would draw other positions). The scene: an orthographic
camera, 24 rotated sprites of assorted sizes on 3 layers (some y-sorted, some
flipped, every 3rd animated on a 4-column sheet), one emitter, and a material
table with textured, alpha-masked, alpha-blended, tinted and windowed
materials over a 64² atlas, at 192×108 with 32 entries per tile.

- `render_2d`, `render_2d_with_particles` (quads and billboards) and
  `render_particles_3d` against the JAX device branch (`use_pallas=True`,
  the blend kernel in interpret mode, forced by this test as
  `tests/test_raster2d_pallas.py` does): colour within 1e-5 absolute (the
  TPU kernel sums its bilinear taps in its matrix product's order), vid
  equal.
- The 2D runner with the textured, alpha-masked table against the JAX
  runner's state through the same device branch (1e-5, vid equal), and an
  untextured scene without emitters against the JAX runner's own CPU path
  (its XLA branch, full-resolution atlas sampling) at
  `tests/test_raster2d_pallas.py`'s bound: atol 2e-2, vid equal.
- The scene of `tests/test_particles_render.py::test_particles_composite_in_3d_frame`
  in the port's 3D runner: the front emitter tints the frame, the one behind
  the wall is occluded; and the renderer's Forward2D stage on that frame
  against the JAX stage's steps on the same inputs (1e-5).
- The config-2 and config-3 builders give the same scenes in both packages,
  and `build_entity_material_map` the same map.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oxylus_tpu.ops.raster2d_pallas as jrp
import oxylus_tpu.render.renderer2d as jr2d
from oxylus_tpu.assets.material import GPUMaterials as JMaterials
from oxylus_tpu.render import camera as jcamera
from oxylus_tpu.runtime import SceneRunner as JRunner
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu.scene.state import SceneSpec as JSpec
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.assets.bake import bake_mesh
from oxylus_tpu_torch.frame2d import build_frame2d_scene, populate_frame2d
from oxylus_tpu_torch.frame3d import build_frame3d_scene, populate_frame3d
from oxylus_tpu_torch.frame5 import cube_mesh
from oxylus_tpu_torch.render import camera as tcamera
from oxylus_tpu_torch.render import renderer2d as tr2d
from oxylus_tpu_torch.render.renderer3d import RenderSpec
from oxylus_tpu_torch.runtime import SceneRunner
from oxylus_tpu_torch.scene.scene import Scene as TScene
from oxylus_tpu_torch.scene.state import SceneSpec as TSpec

torch.set_num_threads(1)

W, H = 192, 108
K = 32
N_SPRITES = 24
COLOR_ATOL = 1e-5
XLA_ATOL = 2e-2  # tests/test_raster2d_pallas.py: the device branch's 16² texel tiles against full-resolution sampling
MAT_UUIDS = [f"00000000-0000-0001-0000-00000000000{i}" for i in range(5)]  # words below 2^53: see ROADMAP C


def _materials() -> dict:
    """A 5-slot table (8 slots, the rest default): untextured white, textured
    and alpha-masked (cutoff 0.5), textured and blended with a tint, untextured
    translucent red, textured through a quarter window of its rect."""
    m = 8
    t = {
        "albedo_color": np.ones((m, 4), np.float32), "emissive_color": np.zeros((m, 3), np.float32),
        "roughness_factor": np.zeros(m, np.float32), "metallic_factor": np.zeros(m, np.float32),
        "alpha_cutoff": np.full(m, 0.1, np.float32), "flags": np.full(m, 1 << 7, np.uint32),
        "uv_size": np.ones((m, 2), np.float32), "uv_offset": np.zeros((m, 2), np.float32),
        "albedo_rect": np.zeros((m, 4), np.float32), "normal_rect": np.zeros((m, 4), np.float32),
        "emissive_rect": np.zeros((m, 4), np.float32), "mr_rect": np.zeros((m, 4), np.float32),
        "occlusion_rect": np.zeros((m, 4), np.float32), "sampling_mode": np.zeros(m, np.int32),
    }
    t["flags"][1], t["alpha_cutoff"][1], t["albedo_rect"][1] = 1 | 1 << 8, 0.5, (0.0, 0.0, 0.5, 0.5)
    t["flags"][2], t["albedo_color"][2], t["albedo_rect"][2] = 1 | 1 << 9, (0.8, 0.6, 1.0, 0.9), (0.5, 0.0, 1.0, 0.5)
    t["flags"][3], t["albedo_color"][3] = 1 << 9, (1.0, 0.1, 0.1, 0.7)
    t["flags"][4], t["albedo_rect"][4] = 1 | 1 << 7, (0.0, 0.5, 1.0, 1.0)
    t["uv_size"][4], t["uv_offset"][4] = (0.5, 0.5), (0.25, 0.5)
    return t


def _atlas() -> np.ndarray:
    rng = np.random.default_rng(4)
    atlas = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
    atlas[..., 3] = np.where(rng.uniform(size=(64, 64)) < 0.3, 0, atlas[..., 3])  # holes for the mask
    return atlas


def _populate(s, emitter: bool = True) -> None:
    """The sprite scene, through the Scene API both packages share."""
    rng = np.random.default_rng(2)
    cam = s.create_entity("camera")
    cam.add("TransformComponent", position=(0.0, 0.0, 10.0))
    cam.add("CameraComponent", projection="Orthographic", zoom=2.0)
    for i in range(N_SPRITES):
        e = s.create_entity(f"sprite_{i}")
        ang = rng.uniform(-np.pi, np.pi)
        e.add("TransformComponent", position=(rng.uniform(-3.2, 3.2), rng.uniform(-1.8, 1.8), 0.0),
              rotation=(0.0, 0.0, np.sin(ang / 2), np.cos(ang / 2)), scale=tuple(rng.uniform(0.4, 1.6, 2)) + (1.0,))
        e.add("SpriteComponent", layer=i % 3, sort_y=bool(i % 2), flip_x=bool(i % 5 == 1),
              material=MAT_UUIDS[i % len(MAT_UUIDS)])
        if i % 3 == 0:
            e.add("SpriteAnimationComponent", num_frames=8, fps=12, columns=4, inverted=bool(i % 2))
    if emitter:
        e = s.create_entity("emitter")
        e.add("TransformComponent", position=(0.5, 0.2, 0.0))
        e.add("ParticleSystemComponent", rate_over_time=200, start_lifetime=1.5, start_size=(0.3, 0.3, 0.3, 1.0),
              start_color=(0.4, 0.9, 1.0, 0.6), start_velocity=(0.0, 1.0, 0.0))


def _material_idx(n: int) -> np.ndarray:
    idx = np.zeros(n, np.int32)
    idx[1 : N_SPRITES + 1] = np.arange(N_SPRITES) % len(MAT_UUIDS)  # entity 0 is the camera
    return idx


def _bindings(n: int, textured: bool = True):
    mats = _materials() if textured else {k: v[:1].repeat(8, 0) for k, v in _materials().items()}
    atlas, idx = _atlas(), _material_idx(n)
    jb = jr2d.SpriteBatchBindings(materials=JMaterials(**{k: jnp.asarray(v) for k, v in mats.items()}),
                                  atlas=jnp.asarray(atlas), entity_material_idx=jnp.asarray(idx))
    tb = tr2d.SpriteBatchBindings(materials=bridge.gpu_materials_from_numpy(mats), atlas=torch.from_numpy(atlas),
                                  entity_material_idx=torch.from_numpy(idx))
    return jb, tb


class _DeviceBranch:
    """The JAX raster's device branch for the duration of a `with`:
    `rasterize_sprites(use_pallas=True)` and the blend kernel in interpret
    mode (the JAX package's own `render_*` functions are called unjitted, so
    the forced branch is traced here and not taken from a jit cache)."""

    def __enter__(self):
        self.saved = (jr2d.rasterize_sprites, jrp.blend_tiles_pallas)
        jr2d.rasterize_sprites = functools.partial(self.saved[0], use_pallas=True)
        jrp.blend_tiles_pallas = functools.partial(self.saved[1], interpret=True)

    def __exit__(self, *exc):
        jr2d.rasterize_sprites, jrp.blend_tiles_pallas = self.saved


def _jax_state(frames: int, emitter: bool = True, textured: bool = True):
    """The JAX runner's state after `frames` headless frames, its camera and bindings."""
    s = JScene("sprites", spec=JSpec(max_entities=64, max_particles=128))
    _populate(s, emitter)
    jb, tb = _bindings(s.spec.padded_entities(), textured)
    runner = JRunner(s, width=W, height=H, render_mode="none", bindings=jb)
    for _ in range(frames):
        runner.step()
    return runner, jb, tb


def _cameras(jstate, cam_idx):
    """The carried state, and the JAX camera in both packages' types: the
    two packages' `camera_from_state` agree to 1e-6 (`tests/test_torch_render3d.py`),
    and the raster is held here on one camera."""
    tstate = bridge.scene_state_from_numpy(jax.device_get(jstate))
    jcam = jcamera.camera_from_state(jstate, cam_idx, jnp.float32(W / H))
    tcam = tcamera.CameraMatrices(**{f.name: torch.from_numpy(np.array(getattr(jcam, f.name)))
                                     for f in dataclasses.fields(tcamera.CameraMatrices)})
    return tstate, jcam, tcam


@pytest.fixture(scope="module")
def sprite_state():
    runner, jb, tb = _jax_state(12)
    st = runner.state
    assert int(np.asarray(st.particles.alive).sum()) > 20  # the premise: particles in flight
    tstate, jcam, tcam = _cameras(st, runner._resolve_camera_idx())
    return dict(jstate=st, tstate=tstate, jcam=jcam, tcam=tcam, jb=jb, tb=tb)


def _assert_match(got, want, atol=COLOR_ATOL):
    gc, gv = (t.numpy() for t in got)
    wc, wv = (np.asarray(a) for a in want)
    assert gc.shape == wc.shape and gv.shape == wv.shape == (H, W)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=atol)
    np.testing.assert_array_equal(gv, wv)
    assert (wv >= 0).mean() > 0.05  # the premise: sprites cover the frame
    return gc, gv


def test_render_2d_matches_jax_device_branch(sprite_state):
    d = sprite_state
    with _DeviceBranch():
        want = jr2d.render_2d(d["jstate"], d["jcam"], d["jb"], width=W, height=H, k_per_tile=K)
    got = tr2d.render_2d(d["tstate"], d["tcam"], d["tb"], width=W, height=H, k_per_tile=K)
    _, vid = _assert_match(got, want)
    assert len(np.unique(vid)) > N_SPRITES // 2


@pytest.mark.parametrize("billboard", [False, True], ids=["quads", "billboards"])
def test_render_2d_with_particles_matches_jax_device_branch(sprite_state, billboard):
    d = sprite_state
    with _DeviceBranch():
        want = jr2d.render_2d_with_particles.__wrapped__(d["jstate"], d["jcam"], d["jb"], width=W, height=H,
                                                          k_per_tile=K, billboard=billboard)
    got = tr2d.render_2d_with_particles(d["tstate"], d["tcam"], d["tb"], width=W, height=H, k_per_tile=K,
                                        billboard=billboard)
    _, vid = _assert_match(got, want)
    emitter = N_SPRITES + 1
    assert (vid == emitter).any()  # particles drew over the sprites


def test_sprite_animation_uv_matches_jax(sprite_state):
    d = sprite_state
    n = d["tstate"].alive.shape[0]
    want = jr2d.sprite_animation_uv(d["jstate"], jnp.arange(n))
    got = tr2d.sprite_animation_uv(d["tstate"], torch.arange(n))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[0]) != 1.0).any()  # animated windows


def _particles_3d_state():
    """Emitters seen by a perspective camera, after 10 frames: red before z = 0
    on the right, green behind it on the left, blue behind it on the right."""
    s = JScene("p3d", spec=JSpec(max_entities=16, max_particles=128))
    cam = s.create_entity("camera")
    cam.add("TransformComponent", position=(0.0, 0.0, 10.0))
    cam.add("CameraComponent", fov=60.0)
    for name, pos, col in (("front", (1.5, 0.0, 3.0), (1.0, 0.2, 0.1, 0.8)),
                           ("behind_left", (-2.0, 0.0, -3.0), (0.1, 1.0, 0.2, 0.8)),
                           ("behind_right", (2.0, 0.0, -3.0), (0.1, 0.2, 1.0, 0.8))):
        e = s.create_entity(name)
        e.add("TransformComponent", position=pos)
        e.add("ParticleSystemComponent", rate_over_time=120, start_lifetime=5.0, start_size=(0.6, 0.6, 0.6, 1.0),
              start_color=col, start_velocity=(0.0, 0.5, 0.0), gravity_modifier=0.0)
    runner = JRunner(s, width=W, height=H, render_mode="none")
    for _ in range(10):
        runner.step()
    return runner


def test_render_particles_3d_matches_jax_device_branch():
    runner = _particles_3d_state()
    st = runner.state
    tstate, jcam, tcam = _cameras(st, runner._resolve_camera_idx())
    # a wall at z = 0 over the right half of the frame (reverse-Z NDC depth of
    # z = 0 from 10 m), nothing over the left half
    cam_z = float(np.asarray(jcam.view_projection)[2, 3] / np.asarray(jcam.view_projection)[3, 3])
    depth = np.zeros((H, W), np.float32)
    depth[:, W // 2 :] = cam_z
    jmats = jr2d.default_bindings(16).materials
    with _DeviceBranch():
        want = jr2d.render_particles_3d(st, jcam, jnp.asarray(depth), jnp.zeros((8, 8, 4), jnp.uint8), jmats,
                                        width=W, height=H, k_per_tile=K)
    got = tr2d.render_particles_3d(tstate, tcam, torch.from_numpy(depth), torch.zeros((8, 8, 4), dtype=torch.uint8),
                                   tr2d.default_bindings(16).materials, width=W, height=H, k_per_tile=K)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=COLOR_ATOL)
    # the premise: the wall hides the right half's far emitter only
    dominant = lambda c: (want[..., c] > 0.2) & (want[..., c] > want[..., (c + 1) % 3] + want[..., (c + 2) % 3])
    red, green, blue = dominant(0), dominant(1), dominant(2)
    assert red[:, W // 2 :].any() and green[:, : W // 2].any() and not blue.any()


def test_runner_2d_textured_alpha_masked_matches_jax():
    """The 2D runner renders textured and alpha-masked materials (no longer
    refused) and matches the JAX runner's state through the device branch."""
    runner, jb, tb = _jax_state(3, emitter=False)
    s = TScene("sprites", spec=TSpec(max_entities=64, max_particles=128), device="cpu")
    _populate(s, emitter=False)
    port = SceneRunner(s, width=W, height=H, render_mode="2d", bindings=tb, device="cpu")
    assert port._has_particles is False
    for _ in range(3):
        img = port.step()
    assert img.shape == (H, W, 4) and bool(torch.isfinite(img).all())
    jstate = runner.state
    tstate, jcam, tcam = _cameras(jstate, runner._resolve_camera_idx())
    with _DeviceBranch():
        want = jr2d.render_2d_with_particles.__wrapped__(jstate, jcam, jb, width=W, height=H)
    np.testing.assert_allclose(img.numpy(), np.asarray(want[0]), rtol=0, atol=COLOR_ATOL)
    got = tr2d.render_2d_with_particles(port.state, port.active_camera(), tb, width=W, height=H)
    _assert_match(got, want)
    # the premise: the textures show (many distinct red values)
    assert np.unique(np.round(np.asarray(want[0])[..., 0], 3)).size > 50


def test_runner_2d_matches_jax_xla_path():
    """Untextured sprites, no emitter: the port's runner against the JAX
    runner's own CPU path for 3 frames, images and the last frame's vid."""
    s = JScene("sprites", spec=JSpec(max_entities=64, max_particles=128))
    _populate(s, emitter=False)
    jb, tb = _bindings(s.spec.padded_entities(), textured=False)
    jrun = JRunner(s, width=W, height=H, render_mode="2d", bindings=jb)
    t = TScene("sprites", spec=TSpec(max_entities=64, max_particles=128), device="cpu")
    _populate(t, emitter=False)
    trun = SceneRunner(t, width=W, height=H, render_mode="2d", bindings=tb, device="cpu")
    for _ in range(3):
        want, got = np.asarray(jrun.step()), trun.step().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=XLA_ATOL)
    _, want_v = jr2d.render_2d_with_particles(jrun.state, jrun.active_camera(), jb, width=W, height=H)
    _, got_v = tr2d.render_2d_with_particles(trun.state, trun.active_camera(), tb, width=W, height=H)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert (np.asarray(want_v) >= 0).mean() > 0.05


@pytest.fixture(scope="module")
def composite_runner():
    """The scene of `tests/test_particles_render.py::test_particles_composite_in_3d_frame`
    in the port's 3D runner at 96×64, after 8 frames: a wall at z = 0, a red
    emitter before it and a green one behind it."""
    s = TScene("p3d", spec=TSpec(max_entities=16, max_particles=64), device="cpu")
    cam = s.create_entity("camera")
    cam.add("TransformComponent", position=(0.0, 0.0, 10.0))
    cam.add("CameraComponent", fov=60.0)
    sun = s.create_entity("sun")
    sun.add("TransformComponent", rotation=(-0.383, 0.0, 0.0, 0.924))
    sun.add("LightComponent", type="Directional", intensity=4.0)
    wall = s.create_entity("wall")
    wall.add("TransformComponent", position=(0.0, 0.0, 0.0), scale=(8.0, 8.0, 0.5))
    wall.add("MeshComponent", mesh_index=0)

    def emitter(name, pos, color):
        e = s.create_entity(name)
        e.add("TransformComponent", position=pos)
        e.add("ParticleSystemComponent", rate_over_time=120, start_lifetime=5.0, start_velocity=(0.0, 0.0, 0.0),
              start_size=(0.6, 0.6, 0.6, 1.0), start_color=color, gravity_modifier=0.0)

    emitter("front", (0.0, 0.0, 3.0), (4.0, 0.0, 0.0, 1.0))  # camera side
    emitter("behind", (0.0, 0.0, -3.0), (0.0, 4.0, 0.0, 1.0))  # occluded
    runner = SceneRunner(s, width=96, height=64, render_mode="3d", meshes=[bake_mesh(*cube_mesh())],
                         render_spec=RenderSpec(width=96, height=64), device="cpu")
    images = [runner.step() for _ in range(8)]
    return runner, images


def test_particles_composite_in_3d_frame(composite_runner):
    """`tests/test_particles_render.py::test_particles_composite_in_3d_frame`
    in the port: billboards blend over the lit frame after lighting and are
    depth-tested against opaque geometry. A red emitter in front of a wall
    tints the frame; a green emitter behind the wall is fully occluded."""
    runner, images = composite_runner
    assert runner._has_particles
    c = images[-1].numpy()[..., :3]
    center = c[24:40, 36:60]
    red_dom = (center[..., 0] > 0.25) & (center[..., 0] > center[..., 1] + center[..., 2])
    assert red_dom.any(), f"front particles missing (max {center.max(0).max(0)})"
    green_dom = (c[..., 1] > 0.25) & (c[..., 1] > c[..., 0] + c[..., 2])
    assert not green_dom.any(), "occluded particles leaked through the wall"
    assert int(runner.state.particles.alive.sum()) > 0


def test_forward2d_stage_matches_jax(composite_runner):
    """The renderer's Forward2D stage against the JAX stage's own steps on the
    port's inputs (its state, camera and scene depth, captured by stage
    callbacks): the quarter-resolution layer through the JAX device branch,
    `jax.image.resize` to full size, and the premultiplied over, within 1e-5."""
    from types import SimpleNamespace

    from oxylus_tpu_torch.render.renderer3d import RenderStage

    runner, _ = composite_runner
    seen = {}

    def before(ctx):
        seen.update(hdr=ctx["hdr"].clone(), depth=ctx["depth"].clone())
        return ctx

    def after(ctx):
        seen.update(out=ctx["hdr"], layer=ctx["particle_layer"])
        return ctx

    renderer = runner.renderer3d
    renderer.add_stage_callback(RenderStage.FORWARD_2D, "before", before)
    renderer.add_stage_callback(RenderStage.FORWARD_2D, "after", after)
    try:
        runner.step()
    finally:
        renderer.stage_callbacks.clear()
    st = bridge.scene_state_to_numpy(runner.state)
    cam = runner.active_camera()
    jstate = SimpleNamespace(
        particles=SimpleNamespace(**{k: jnp.asarray(v) for k, v in st["particles"].items()}),
        comp={"ParticleSystemComponent": {k: jnp.asarray(v) for k, v in st["comp"]["ParticleSystemComponent"].items()}},
    )
    # the port's camera, its view-projection included (the two packages'
    # products of the same matrices agree to 1e-6, not in every bit)
    jcam = SimpleNamespace(**{k: jnp.asarray(getattr(cam, k).numpy()) for k in ("right", "up", "forward", "view_projection")})
    h, w = 64, 96
    with _DeviceBranch():
        quarter = jr2d.render_particles_3d(jstate, jcam, jnp.asarray(seen["depth"].numpy()[::4, ::4]),
                                           jnp.zeros((64, 64, 4), jnp.uint8), jr2d.default_bindings(16).materials,
                                           width=w // 4, height=h // 4)
    layer = np.asarray(jax.image.resize(quarter, (h, w, 4), method="linear"))
    np.testing.assert_allclose(seen["layer"].numpy(), layer, rtol=0, atol=COLOR_ATOL)
    want = seen["hdr"].numpy() * (1.0 - layer[..., 3:4]) + layer[..., :3]
    np.testing.assert_allclose(seen["out"].numpy(), want, rtol=0, atol=COLOR_ATOL)
    assert (layer[..., 3] > 0.1).any()  # the premise: the front emitter shows


def test_frame_builders_match_the_jax_scenes():
    """`build_frame2d_scene` / `build_frame3d_scene` make the scenes their
    populate functions make in the JAX package (the bench's configs 2 and 3)."""
    for build, populate, spec_kw in ((build_frame2d_scene, populate_frame2d,
                                      dict(max_entities=2048, max_particles=2048)),
                                     (build_frame3d_scene, populate_frame3d, dict(max_entities=1024))):
        ts, kw = build(device="cpu")
        js = JScene("ref", spec=JSpec(**spec_kw))
        populate(js)
        assert dataclasses.asdict(ts.spec) == dataclasses.asdict(js.spec)
        got, want = bridge.scene_state_to_numpy(ts.to_device_state()), jax.device_get(js.to_device_state())
        for k in ("alive", "parent", "world"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(want, k)), err_msg=k)
        for c, fields in got["comp"].items():
            np.testing.assert_array_equal(got["mask"][c], np.asarray(want.mask[c]), err_msg=c)
            for f, v in fields.items():
                np.testing.assert_array_equal(v, np.asarray(want.comp[c][f]).astype(v.dtype), err_msg=f"{c}.{f}")
        assert kw["width"] == 1920 and kw["height"] == 1080


def test_entity_material_map_matches_jax():
    slots = {u: i + 1 for i, u in enumerate(MAT_UUIDS[1:])}
    maps = []
    for scene_cls, spec_cls in ((JScene, JSpec), (TScene, TSpec)):
        kw = {} if scene_cls is JScene else {"device": "cpu"}
        s = scene_cls("sprites", spec=spec_cls(max_entities=64, max_particles=128), **kw)
        _populate(s, emitter=False)
        maps.append((jr2d if scene_cls is JScene else tr2d).build_entity_material_map(s, slots))
    np.testing.assert_array_equal(maps[1], maps[0])
    np.testing.assert_array_equal(maps[1][: N_SPRITES + 1], _material_idx(64)[: N_SPRITES + 1])
