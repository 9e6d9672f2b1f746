"""Two runner faults of the port, repaired, held against the JAX runner.

- The entity capacity grows mid-run: `max_entities=8`, a camera and five
  sprites, then a deferred spawn of six more sprites in the first frame, so
  `Scene._grow` doubles the capacity 8 → 16. The runner re-pads its
  per-entity bindings and keeps their material assignments, as the JAX runner
  does (`oxylus_tpu/runtime.py:271-282`). Both 2D runners render three
  frames; images within `tests/test_torch_render2d.py`'s runner bound against
  the JAX runner's own CPU path (2e-2), vids equal.
- An empty particle pool, `SceneSpec(max_particles=0)`: the frame step and
  the headless dense branch run (the pool update used to divide by the pool
  size) and match the JAX runner after three frames, the emitter clocks too,
  at `tests/test_torch_frame.py`'s runner bound (1e-5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oxylus_tpu.render.renderer2d as jr2d
from oxylus_tpu.assets.material import GPUMaterials as JMaterials
from oxylus_tpu.runtime import SceneRunner as JRunner
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu.scene.state import SceneSpec as JSpec
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.render import renderer2d as tr2d
from oxylus_tpu_torch.runtime import SceneRunner
from oxylus_tpu_torch.scene.scene import Scene as _TScene
from oxylus_tpu_torch.scene.state import SceneSpec as TSpec

torch.set_num_threads(1)
TScene = functools.partial(_TScene, device="cpu")  # the port defaults to the card

W, H = 128, 96
XLA_ATOL = 2e-2  # tests/test_torch_render2d.py: the port's blend against the JAX runner's XLA branch
RUNNER_ATOL = 1e-5  # tests/test_torch_frame.py: the runner routes differ only in the order of sums
FRAMES = 3


def _materials() -> dict:
    """Untextured slots: white, translucent red, opaque green."""
    m = 4
    t = {
        "albedo_color": np.ones((m, 4), np.float32), "emissive_color": np.zeros((m, 3), np.float32),
        "roughness_factor": np.zeros(m, np.float32), "metallic_factor": np.zeros(m, np.float32),
        "alpha_cutoff": np.full(m, 0.1, np.float32), "flags": np.full(m, 1 << 7, np.uint32),
        "uv_size": np.ones((m, 2), np.float32), "uv_offset": np.zeros((m, 2), np.float32),
        "albedo_rect": np.zeros((m, 4), np.float32), "normal_rect": np.zeros((m, 4), np.float32),
        "emissive_rect": np.zeros((m, 4), np.float32), "mr_rect": np.zeros((m, 4), np.float32),
        "occlusion_rect": np.zeros((m, 4), np.float32), "sampling_mode": np.zeros(m, np.int32),
    }
    t["albedo_color"][1] = (1.0, 0.1, 0.1, 0.7)
    t["albedo_color"][2] = (0.1, 0.9, 0.2, 1.0)
    return t


def _sprite(s, i, x, y):
    e = s.create_entity(f"sprite_{i}")
    e.add("TransformComponent", position=(x, y, 0.0), scale=(0.9, 0.9, 1.0))
    e.add("SpriteComponent", layer=i % 2)


def _grown_scene(Scene, Spec):
    s = Scene("grow", spec=Spec(max_entities=8, max_particles=16))
    cam = s.create_entity("camera")
    cam.add("TransformComponent", position=(0.0, 0.0, 10.0))
    cam.add("CameraComponent", projection="Orthographic", zoom=2.0)
    for i in range(5):
        _sprite(s, i, -2.0 + i, 0.6)

    def spawn(scene):
        for i in range(6):
            _sprite(scene, 5 + i, -2.5 + i, -0.6)

    s.defer(spawn)
    return s


def test_runner_2d_survives_entity_capacity_growth():
    mats = _materials()
    atlas = np.full((8, 8, 4), 255, np.uint8)
    idx = np.array([0, 1, 2, 1, 2, 1, 0, 0], np.int32)  # entity 0 is the camera
    jb = jr2d.SpriteBatchBindings(materials=JMaterials(**{k: jnp.asarray(v) for k, v in mats.items()}),
                                  atlas=jnp.asarray(atlas), entity_material_idx=jnp.asarray(idx))
    tb = tr2d.SpriteBatchBindings(materials=bridge.gpu_materials_from_numpy(mats), atlas=torch.from_numpy(atlas),
                                  entity_material_idx=torch.from_numpy(idx))
    js, ts = _grown_scene(JScene, JSpec), _grown_scene(TScene, TSpec)
    assert js.spec.padded_entities() == ts.spec.padded_entities() == 8
    jrun = JRunner(js, width=W, height=H, render_mode="2d", bindings=jb)
    trun = SceneRunner(ts, width=W, height=H, render_mode="2d", bindings=tb, device="cpu")
    for _ in range(FRAMES):
        want, got = np.asarray(jrun.step()), trun.step().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=XLA_ATOL)
    assert trun.state.alive.shape[0] == 16 and int(trun.state.alive.sum()) == 12
    np.testing.assert_array_equal(trun.bindings.entity_material_idx.numpy(),
                                  np.asarray(jrun.bindings.entity_material_idx))
    np.testing.assert_array_equal(trun.bindings.entity_material_idx[:8].numpy(), idx)
    _, want_v = jr2d.render_2d_with_particles(jrun.state, jrun.active_camera(), jrun.bindings, width=W, height=H)
    _, got_v = tr2d.render_2d_with_particles(trun.state, trun.active_camera(), trun.bindings, width=W, height=H)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # the premise: the spawned sprites (entities 6-11) are on screen
    assert np.isin(np.arange(6, 12), np.asarray(want_v)).all()


def _empty_pool_scene(Scene, Spec):
    s = Scene("no_particles", spec=Spec(max_entities=32, max_bodies=128, max_particles=0))
    floor = s.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0))
    floor.add("BoxColliderComponent", size=(12.0, 1.0, 12.0), friction=0.5)
    for i in range(6):
        e = s.create_entity(f"box{i}")
        e.add("TransformComponent", position=((i % 3 - 1) * 0.81, -0.11 + (i // 3) * 0.8, 0.0))
        e.add("BoxColliderComponent", size=(0.4, 0.4, 0.4), friction=0.5)
        e.add("RigidBodyComponent")
    em = s.create_entity("emitter")
    em.add("TransformComponent", position=(1.0, 2.0, 0.0))
    em.add("ParticleSystemComponent", rate_over_time=100)  # would spawn every frame
    s.runtime_start()
    return s


@pytest.mark.parametrize("use_megakernel", [False, True], ids=["frame_step", "dense"])
def test_empty_particle_pool_runs_and_matches_jax(use_megakernel):
    jr = JRunner(_empty_pool_scene(JScene, JSpec), render_mode="none", use_megakernel=use_megakernel)
    tr = SceneRunner(_empty_pool_scene(TScene, TSpec), render_mode="none", use_megakernel=use_megakernel,
                     device="cpu")
    for _ in range(FRAMES):
        jr.step()
        tr.step()
    jps, jst = jax.device_get(jr.ps), jax.device_get(jr.state)
    tps, tst = bridge.physics_state_to_numpy(tr.ps), bridge.scene_state_to_numpy(tr.state)
    for field in ("pos", "linvel", "angvel", "quat"):
        np.testing.assert_allclose(tps[field], np.asarray(getattr(jps, field)), rtol=0, atol=RUNNER_ATOL)
    np.testing.assert_allclose(tst["world"], np.asarray(jst.world), rtol=0, atol=RUNNER_ATOL)
    psys_t, psys_j = tst["comp"]["ParticleSystemComponent"], jst.comp["ParticleSystemComponent"]
    np.testing.assert_array_equal(psys_t["system_time"], np.asarray(psys_j["system_time"]))
    assert tst["particles"]["alive"].shape == (0,)
    np.testing.assert_array_equal(tst["particles"]["cursor"], np.asarray(jst.particles.cursor))
    # the premise: the emitter's clock ran
    assert psys_t["system_time"].max() > 0.04
