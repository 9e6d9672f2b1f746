"""The port's frame step and runner against the JAX package.

Scene: 40 boxes squeezed into a touching pile on the floor, some with pose
interpolation, a child entity riding a box, a particle emitter and an animated
sprite. dt = 1/40 s, so frames take one or two 60 Hz substeps and the
interpolation alpha is fractional.

- `frame_step` with the compact kernel against the JAX `frame_step` with its
  compact kernel run in interpret mode (patched in for this module only).
  Physics differs only through the TPU kernel's bf16 hi/lo partner gathers
  (see test_torch_megakernel_compact.py), so the same bounds apply: 5e-5 m,
  1e-3 m/s, 5e-3 rad/s, 1e-4 on quaternions; world matrices 1e-4.
- The runner's separate-stage routes against the JAX runner on the same pile
  at capacity 128 without the emitter, frames of 1/60, 1/30 and 1/45 s (1, 2
  and 1 substeps): the headless dense branch (the JAX runner interprets its
  kernel), the default `use_megakernel=False` runner (`physics_substep`), and
  a 3D runner's `step(render=False)`. Both sides compute the same float32
  operations and differ in the order of sums: 1e-5 on every body field and on
  world matrices (observed ≤ 1e-6). The accumulator matches exactly.
- `entry()`'s frame step (255 boxes, capacity 512, `max_pairs=2048`) against
  the JAX `entry()` for 2 frames, at the same bound."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oxylus_tpu.physics.megakernel_compact as jmc
from oxylus_tpu.physics.state import PhysicsParams as JParams
from oxylus_tpu.scene import frame as jframe
from oxylus_tpu.scene import particles as jparticles
from oxylus_tpu.scene import state as jstate
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.physics import megakernel_compact as tmc
from oxylus_tpu_torch.physics.state import PhysicsParams
from oxylus_tpu_torch.runtime import SceneRunner
from oxylus_tpu_torch.scene import frame as tframe
from oxylus_tpu_torch.scene import particles as tparticles
from oxylus_tpu_torch.scene import state as tstate
from oxylus_tpu_torch.scene.scene import Scene as _TScene

torch.set_num_threads(1)
TScene = functools.partial(_TScene, device="cpu")  # the port defaults to the card

DT = 1.0 / 40.0
N_FRAMES = 3
ATOL = {"pos": 5e-5, "linvel": 1e-3, "angvel": 5e-3, "quat": 1e-4}
COMP_ATOL = {"translation": 5e-5, "previous_translation": 5e-5, "rotation": 1e-4,
             "previous_rotation": 1e-4, "position": 5e-5}


def _pile_scene(Scene, SceneSpec, max_bodies=256, emitter=True):
    s = Scene("pile", spec=SceneSpec(max_entities=64, max_bodies=max_bodies, max_particles=128))
    floor = s.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0))
    floor.add("BoxColliderComponent", size=(12.0, 1.0, 12.0), friction=0.5)
    rng = np.random.default_rng(11)
    boxes = []
    for i in range(40):
        gx, gy, gz = i % 4, (i // 16), (i // 4) % 4
        j = rng.uniform(-0.03, 0.03, 3)
        e = s.create_entity(f"box{i}")
        e.add("TransformComponent", position=((gx - 2) * 0.81 + j[0], -0.11 + gy * 0.8 + j[1], (gz - 2) * 0.81 + j[2]))
        e.add("BoxColliderComponent", size=(0.4, 0.4, 0.4), friction=0.5)
        e.add("RigidBodyComponent", interpolation=bool(i % 2))
        boxes.append(e)
    rider = s.create_entity("rider")
    rider.add("TransformComponent", position=(0.0, 0.6, 0.0), scale=(0.5, 0.5, 0.5))
    rider.child_of(boxes[37])
    if emitter:
        em = s.create_entity("emitter")
        em.add("TransformComponent", position=(1.0, 2.0, 0.0))
        em.add("ParticleSystemComponent", rate_over_time=10)  # first spawn at t = 0.1 s
    sp = s.create_entity("sprite")
    sp.add("TransformComponent")
    sp.add("SpriteAnimationComponent", num_frames=8, fps=12, columns=4)
    s.runtime_start()
    return s


@pytest.fixture(scope="module")
def jax_frames():
    """Three frames of the JAX frame step, its compact kernel in interpret mode."""
    s = _pile_scene(JScene, jstate.SceneSpec)
    step = jax.jit(jframe.frame_step.__wrapped__, static_argnames=("spec", "has_bodies", "physics_mega"))
    orig = jmc.megakernel_substeps_compact
    jmc.megakernel_substeps_compact = functools.partial(orig, interpret=True)
    try:
        state, ps = s.to_device_state(), s.physics_state
        for _ in range(N_FRAMES):
            state, ps = step(state, ps, JParams(), jnp.float32(DT), s.spec, has_bodies=True, physics_mega=True)
    finally:
        jmc.megakernel_substeps_compact = orig
    return jax.device_get(state), jax.device_get(ps)


@pytest.fixture(scope="module")
def port_frames():
    s = _pile_scene(TScene, tstate.SceneSpec)
    state, ps = s.to_device_state(), s.physics_state
    for _ in range(N_FRAMES):
        state, ps = tframe.frame_step(state, ps, PhysicsParams(), DT, s.spec, has_bodies=True, physics_mega=True)
    return bridge.scene_state_to_numpy(state), bridge.physics_state_to_numpy(ps)


@pytest.mark.parametrize("field", ["pos", "linvel", "angvel", "quat"])
def test_frame_step_bodies_match_jax(jax_frames, port_frames, field):
    np.testing.assert_allclose(port_frames[1][field], np.asarray(getattr(jax_frames[1], field)), rtol=0, atol=ATOL[field])


def test_frame_step_accumulator_matches_jax(jax_frames, port_frames):
    np.testing.assert_array_equal(port_frames[1]["accumulator"], np.asarray(jax_frames[1].accumulator))
    assert 0.0 < float(port_frames[1]["accumulator"]) < 1.0 / 60.0  # a fractional alpha was exercised


@pytest.mark.parametrize("comp,field", [
    ("RigidBodyComponent", "translation"), ("RigidBodyComponent", "rotation"),
    ("RigidBodyComponent", "previous_translation"), ("RigidBodyComponent", "previous_rotation"),
    ("TransformComponent", "position"), ("TransformComponent", "rotation"),
])
def test_frame_step_components_match_jax(jax_frames, port_frames, comp, field):
    want = np.asarray(jax_frames[0].comp[comp][field])
    np.testing.assert_allclose(port_frames[0]["comp"][comp][field], want, rtol=0, atol=COMP_ATOL[field])


def test_frame_step_world_and_clocks_match_jax(jax_frames, port_frames):
    jst, (st, _) = jax_frames[0], port_frames
    np.testing.assert_allclose(st["world"], np.asarray(jst.world), rtol=0, atol=1e-4)
    np.testing.assert_allclose(st["previous_world"], np.asarray(jst.previous_world), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(st["time"], np.asarray(jst.time))
    np.testing.assert_array_equal(st["frame"], np.asarray(jst.frame))
    for comp, field in (("SpriteAnimationComponent", "current_time"), ("ParticleSystemComponent", "system_time")):
        np.testing.assert_array_equal(st["comp"][comp][field], np.asarray(jst.comp[comp][field]))
    _assert_pool_equal(jst.particles, st["particles"])


def _bodyless_pile():
    s = _pile_scene(TScene, tstate.SceneSpec)
    for i in np.nonzero(s._alive)[0]:
        for comp in ("RigidBodyComponent", "BoxColliderComponent"):
            if s._comp_mask[comp][i]:
                s.remove_component(int(i), comp)
    s.runtime_start()  # rebuild the physics state without the bodies
    return s


def test_runner_runs_the_frame_step():
    """A body-less headless runner (`SceneRunner(render_mode="none")`, here on
    its dense branch) gives the frame step's state exactly: particles, sprites
    and transforms."""
    want = _bodyless_pile()
    assert not bool(want.physics_state.active.any())
    state, ps = want.to_device_state(), want.physics_state
    for _ in range(N_FRAMES):
        state, ps = tframe.frame_step(state, ps, PhysicsParams(), DT, want.spec, has_bodies=False)
    runner = SceneRunner(_bodyless_pile(), render_mode="none", use_megakernel=True, device="cpu")
    runner.run(N_FRAMES, dt=DT)
    got = bridge.scene_state_to_numpy(runner.state)
    ref = bridge.scene_state_to_numpy(state)
    np.testing.assert_array_equal(got["world"], ref["world"])
    np.testing.assert_array_equal(got["time"], ref["time"])
    for k, v in ref["particles"].items():
        np.testing.assert_array_equal(got["particles"][k], v, err_msg=k)
    host = runner.sync_to_host()
    np.testing.assert_array_equal(host._comp_data["TransformComponent"]["position"][:64],
                                  ref["comp"]["TransformComponent"]["position"])


RUNNER_DTS = (1.0 / 60.0, 1.0 / 30.0, 1.0 / 45.0)  # 1, 2 and 1 substeps
RUNNER_ATOL = 1e-5
ROUTES = {
    "dense": dict(render_mode="none", use_megakernel=True),
    "substep": dict(render_mode="none", use_megakernel=False),
    "3d_render_false": dict(render_mode="3d", use_megakernel=True),
}


def _cube_meshes(bake):
    from oxylus_tpu_torch.frame5 import cube_mesh

    return [bake(*cube_mesh())]


@pytest.fixture(scope="module", params=list(ROUTES))
def runner_pair(request):
    """The JAX runner and the port's, on the same pile, after RUNNER_DTS."""
    from oxylus_tpu.assets.bake import bake_mesh as jbake
    from oxylus_tpu.runtime import SceneRunner as JRunner
    from oxylus_tpu_torch.assets.bake import bake_mesh

    kw = ROUTES[request.param]
    render = kw["render_mode"] == "none"
    jkw, tkw = dict(kw), dict(kw)
    if kw["render_mode"] == "3d":
        jkw["meshes"], tkw["meshes"] = _cube_meshes(jbake), _cube_meshes(bake_mesh)
    jr = JRunner(_pile_scene(JScene, jstate.SceneSpec, max_bodies=128, emitter=False), **jkw)
    tr = SceneRunner(_pile_scene(TScene, tstate.SceneSpec, max_bodies=128, emitter=False), device="cpu", **tkw)
    for dt in RUNNER_DTS:
        jr.step(dt, render=render)
        tr.step(dt, render=render)
    return jax.device_get(jr.ps), jax.device_get(jr.state), bridge.physics_state_to_numpy(tr.ps), \
        bridge.scene_state_to_numpy(tr.state)


@pytest.mark.parametrize("field", ["pos", "linvel", "angvel", "quat", "prev_pos"])
def test_runner_routes_match_jax(runner_pair, field):
    jps, _, tps, _ = runner_pair
    np.testing.assert_allclose(tps[field], np.asarray(getattr(jps, field)), rtol=0, atol=RUNNER_ATOL)


def test_runner_routes_frame_state_matches_jax(runner_pair):
    jps, jst, tps, tst = runner_pair
    np.testing.assert_array_equal(tps["accumulator"], np.asarray(jps.accumulator))
    np.testing.assert_allclose(tst["world"], np.asarray(jst.world), rtol=0, atol=RUNNER_ATOL)
    for comp, field in (("RigidBodyComponent", "translation"), ("TransformComponent", "position"),
                        ("TransformComponent", "rotation")):
        np.testing.assert_allclose(tst["comp"][comp][field], np.asarray(jst.comp[comp][field]), rtol=0,
                                   atol=RUNNER_ATOL, err_msg=f"{comp}.{field}")
    np.testing.assert_array_equal(tst["time"], np.asarray(jst.time))
    np.testing.assert_array_equal(tst["frame"], np.asarray(jst.frame))
    # the premise: the pile is in contact (velocities are not free fall)
    fall = -9.81 * 4 / 60.0
    assert np.abs(np.asarray(jps.linvel)[1:41, 1] - fall).max() > 0.05


def test_runner_refuses_unported_routes():
    """A runner on another device than its scene is refused. The 2D renderer,
    the 3D particle composite, textured and alpha-masked materials on both
    raster routes, and audio are taken now: the runner derives its texturing
    gates from the flag bits, the group route renders them, and a scene with an
    audio component gets an engine that mixes a block each step."""
    s = _pile_scene(TScene, tstate.SceneSpec)
    assert SceneRunner(s, render_mode="2d", use_megakernel=True, device="cpu")._has_particles
    with pytest.raises(ValueError):  # the scene lives on the CPU
        SceneRunner(s, render_mode="3d", use_megakernel=True, device="meta")
    from oxylus_tpu_torch.assets.bake import bake_mesh
    from oxylus_tpu_torch.assets.material import FLAG_ALPHA_MASK, FLAG_HAS_ALBEDO
    from oxylus_tpu_torch.render.renderer2d import default_bindings

    assert SceneRunner(s, render_mode="3d", use_megakernel=True, meshes=_cube_meshes(bake_mesh),
                       device="cpu")._has_particles
    from oxylus_tpu_torch.render.camera import camera_matrices
    from oxylus_tpu_torch.render.renderer3d import RenderSpec

    for flag, what, gates in ((FLAG_HAS_ALBEDO, "texturing", (("albedo",), True, False)),
                              (FLAG_ALPHA_MASK, "alpha-masked", ((), False, True))):
        b = default_bindings(s.spec.padded_entities(), device="cpu")
        b.materials.flags[0] |= flag
        runner = SceneRunner(s, width=64, height=48, render_mode="3d", meshes=_cube_meshes(bake_mesh), bindings=b,
                             device="cpu", render_spec=RenderSpec(width=64, height=48, raster_path="group"))
        assert (runner._texture_features, runner._textured, runner._has_alpha_mask) == gates, what
        f = lambda v: torch.tensor(v, dtype=torch.float32)
        cam = camera_matrices(position=f([0.0, 1.5, 6.0]), yaw=f(-np.pi / 2), pitch=f(-0.2), tilt=f(0.0),
                              fov_deg=f(60.0), near=f(0.1), far=f(100.0), zoom=f(1.0),
                              projection_kind=torch.tensor(0, dtype=torch.int32), aspect=f(64 / 48))
        ctx = runner.renderer3d.render(runner.state, runner.gscene, cam, b.materials, b.atlas, runner.config,
                                       textured=runner._textured, texture_features=runner._texture_features,
                                       alpha_masked=runner._has_alpha_mask)
        assert bool(torch.isfinite(ctx["final"]).all()) and ctx["slot_group"] == runner.renderer3d.spec.raster_group, what
        SceneRunner(s, render_mode="2d", bindings=b, device="cpu")  # the 2D path samples and masks itself
    audio = _pile_scene(TScene, tstate.SceneSpec, emitter=False)
    e = audio.create_entity("speaker")
    e.add("TransformComponent")
    e.add("AudioSourceComponent")
    runner = SceneRunner(audio, device="cpu")
    assert runner.audio_engine is not None
    runner.step()
    assert runner.last_audio_block.shape == (800, 2)


def test_runner_takes_the_full_config5_frame():
    """The atmosphere, shadows, GTAO and SSR are no longer refused: the runner
    of `build_frame5_scene` (the JAX package's config 5) is built with all four
    on, its sky LUTs prewarmed once for its atmosphere."""
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.render.sky import AtmosphereParams

    scene, kw = build_frame5_scene(64, 48, n_objects=4, n_boxes=20, max_bodies=256, device="cpu")
    assert kw["atmosphere"] == AtmosphereParams() and kw["enable_shadows"]
    runner = SceneRunner(scene, **kw)
    assert runner.config.vbgtao_enable and runner.config.ssr_enable
    assert list(runner.renderer3d._sky_cache) == [AtmosphereParams()]
    t_lut, ms_lut = runner.renderer3d._sky_cache[AtmosphereParams()]
    assert t_lut.shape == (64, 256, 3) and ms_lut.shape == (32, 32, 3)


def test_fused_frame_runs_physics_substep_when_compact_is_not_eligible():
    """A 3D runner whose scene the compact kernel cannot take (capacity 128)
    steps its physics in the fused frame with `physics_substep`, as the JAX
    runner does: its bodies equal `frame_step(..., physics_mega=False)`'s, and
    the compact kernel is not called."""
    from oxylus_tpu_torch.frame5 import build_frame5_scene

    scene, kw = build_frame5_scene(64, 48, n_objects=4, n_boxes=20, max_bodies=128, device="cpu")
    runner = SceneRunner(scene, **kw)
    state, ps = runner.state, runner.ps  # frame_step makes new tensors, so these stay the start state
    calls = []
    orig = tframe.megakernel_substeps_compact
    tframe.megakernel_substeps_compact = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        for dt in (1.0 / 60.0, 1.0 / 30.0):
            image = runner.step(dt)
            state, ps = tframe.frame_step(state, ps, PhysicsParams(), dt, scene.spec, physics_mega=False)
    finally:
        tframe.megakernel_substeps_compact = orig
    assert tuple(image.shape) == (48, 64, 3) and not calls
    for field in ("pos", "linvel", "angvel", "quat"):
        torch.testing.assert_close(getattr(runner.ps, field), getattr(ps, field), rtol=0, atol=0)
    torch.testing.assert_close(runner.state.world, state.world, rtol=0, atol=0)


def test_entry_frame_step_matches_jax(monkeypatch):
    """The port's `entry()` against `__graft_entry__.entry()`, 2 frames."""
    import __graft_entry__
    from oxylus_tpu_torch.flagship import entry

    # entry() would point JAX's persistent compile cache into the checkout for
    # the rest of this test process
    monkeypatch.setattr(__graft_entry__, "_enable_compile_cache", lambda: None)
    jfn, (jst, jps, jparams, jdt) = __graft_entry__.entry()
    jfn = jax.jit(jfn)
    fn, (st, ps, params, dt) = entry(device="cpu")
    assert params.max_pairs == jparams.max_pairs == 2048 and ps.num_slots == 512
    for _ in range(2):
        jst, jps = jfn(jst, jps, jparams, jdt)
        st, ps = fn(st, ps, params, dt)
    jps = jax.device_get(jps)
    for field in ("pos", "linvel", "quat"):
        np.testing.assert_allclose(getattr(ps, field).numpy(), np.asarray(getattr(jps, field)), rtol=0,
                                   atol=RUNNER_ATOL, err_msg=field)
    np.testing.assert_allclose(st.world.numpy(), np.asarray(jst.world), rtol=0, atol=RUNNER_ATOL)
    np.testing.assert_array_equal(ps.accumulator.numpy(), np.asarray(jps.accumulator))


def _assert_pool_equal(jpool, tpool, skip_pos_rows=None):
    for k in ("alive", "emitter", "age", "lifetime", "vel", "cursor", "pos"):
        want = np.asarray(getattr(jpool, k))
        got = tpool[k]
        if k == "pos" and skip_pos_rows is not None:
            want, got = np.delete(want, skip_pos_rows, 0), np.delete(got, skip_pos_rows, 0)
        np.testing.assert_array_equal(got, want, err_msg=k)


def _emitter_state(system_time):
    s = _pile_scene(JScene, jstate.SceneSpec)
    st = s.to_device_state()
    psys = dict(st.comp["ParticleSystemComponent"])
    psys["system_time"] = jnp.full_like(psys["system_time"], system_time)
    psys["burst_count"] = jnp.full_like(psys["burst_count"], 3)
    return s.spec, dataclasses.replace(st, comp=dict(st.comp, ParticleSystemComponent=psys))


@pytest.mark.parametrize("system_time", [0.02, 0.05])
def test_particle_update_matches_exactly_without_spawns(system_time):
    spec, jst = _emitter_state(system_time)
    dt = jnp.float32(1.0 / 60.0)
    want = jax.device_get(jparticles.particle_update(jst, spec, dt))
    got = bridge.scene_state_to_numpy(
        tparticles.particle_update(bridge.scene_state_from_numpy(jax.device_get(jst)), tstate.SceneSpec(**dataclasses.asdict(spec)), torch.tensor(1.0 / 60.0))
    )
    _assert_pool_equal(want.particles, got["particles"])
    assert not np.asarray(want.particles.alive).any()  # the premise: no spawn this frame
    for k, v in want.comp["ParticleSystemComponent"].items():
        np.testing.assert_array_equal(got["comp"]["ParticleSystemComponent"][k], np.asarray(v), err_msg=k)


def test_particle_update_spawn_frame():
    """A frame that spawns: everything matches exactly except spawn positions,
    which come from different random streams; those must lie on the emitter's
    position_start → position_end segment."""
    spec, jst = _emitter_state(0.095)  # crosses t = 0.1 s: one rate spawn
    dt = jnp.float32(1.0 / 60.0)
    want = jax.device_get(jparticles.particle_update(jst, spec, dt))
    got = bridge.scene_state_to_numpy(
        tparticles.particle_update(bridge.scene_state_from_numpy(jax.device_get(jst)), tstate.SceneSpec(**dataclasses.asdict(spec)), torch.tensor(1.0 / 60.0))
    )
    spawned = np.nonzero(np.asarray(want.particles.alive))[0]
    assert len(spawned) >= 1
    _assert_pool_equal(want.particles, got["particles"], skip_pos_rows=spawned)
    psys = want.comp["ParticleSystemComponent"]
    em = int(np.asarray(want.particles.emitter)[spawned[0]])
    lo = np.asarray(jst.world)[em, :3, 3] + np.asarray(psys["position_start"])[em]
    hi = np.asarray(jst.world)[em, :3, 3] + np.asarray(psys["position_end"])[em]
    assert hi[0] != lo[0] and np.all(hi[1:] == lo[1:])  # the default segment runs along x
    vel = np.asarray(want.particles.vel)
    for pos in (np.asarray(want.particles.pos), got["particles"]["pos"]):
        spawn = pos[spawned] - vel[spawned] * (1.0 / 60.0)  # undo the first integration step
        t = (spawn[:, 0] - lo[0]) / (hi[0] - lo[0])
        assert np.all((t >= -1e-4) & (t <= 1 + 1e-4))
        np.testing.assert_allclose(spawn[:, 1:], np.broadcast_to(lo[1:], spawn[:, 1:].shape), atol=1e-5)
