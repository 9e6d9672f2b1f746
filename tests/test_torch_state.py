"""Parity of the port's host model and device boundary with the JAX package:
schema registry, `to_device_state`, `build_physics_state`, transform
propagation, and the slab-rank / hub-plane helpers of the compact kernel."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.physics import megakernel_banded as jband
from oxylus_tpu.scene import components as JC
from oxylus_tpu.scene import state as jstate
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.physics import megakernel_banded as tband
from oxylus_tpu_torch.scene import components as TC
from oxylus_tpu_torch.scene import state as tstate
from oxylus_tpu_torch.scene.scene import Scene as _TScene

from tests.test_megakernel_banded import _falling_boxes

torch.set_num_threads(1)
TScene = functools.partial(_TScene, device="cpu")  # the port defaults to the card


def _hierarchy_scene(Scene, SceneSpec):
    """Rotated/scaled hierarchy three levels deep plus one body of every collider kind."""
    s = Scene("parity", spec=SceneSpec(max_entities=64, max_bodies=256, max_particles=64))
    floor = s.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0))
    floor.add("BoxColliderComponent", size=(20.0, 1.0, 20.0), friction=0.6)
    rng = np.random.default_rng(3)
    parent = None
    for i in range(3):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        e = s.create_entity(f"node{i}")
        e.add("TransformComponent", position=tuple(rng.uniform(-2, 2, 3)), rotation=tuple(q),
              scale=tuple(rng.uniform(0.5, 2.0, 3)))
        if parent is not None:
            e.child_of(parent)
        parent = e
    colliders = [
        ("BoxColliderComponent", dict(size=(0.3, 0.4, 0.5))),
        ("SphereColliderComponent", dict(radius=0.35)),
        ("CapsuleColliderComponent", dict(radius=0.2, height=0.8)),
        ("TaperedCapsuleColliderComponent", dict(top_radius=0.1, bottom_radius=0.3, height=0.6)),
        ("CylinderColliderComponent", dict(radius=0.25, height=0.7)),
    ]
    for i, (cname, kw) in enumerate(colliders):
        e = s.create_entity(f"body{i}")
        e.add("TransformComponent", position=(i * 1.5, 1.0 + i, 0.0))
        e.add(cname, friction=0.3 + 0.1 * i, **kw)
        e.add("RigidBodyComponent", mass=1.0 + i, allowed_dofs=0b111111 if i else 0b110111)
    em = s.create_entity("emitter")
    em.add("TransformComponent", position=(0.0, 3.0, 0.0))
    em.add("ParticleSystemComponent", rate_over_time=12)
    em.child_of(parent)
    sp = s.create_entity("sprite")
    sp.add("TransformComponent")
    sp.add("SpriteComponent", layer=2)
    sp.add("SpriteAnimationComponent", num_frames=8, fps=12, columns=4)
    s.runtime_start()
    return s


@pytest.fixture(scope="module")
def scenes():
    return (_hierarchy_scene(JScene, jstate.SceneSpec), _hierarchy_scene(TScene, tstate.SceneSpec))


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.uint32 and b.dtype == np.uint64:
        # JAX without x64 stores the schema's uint64 (UUID words) as uint32 on
        # the device; the port keeps uint64. Values must still agree.
        b = b.astype(np.uint32)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=path)


def test_component_registry_matches_jax():
    assert [c.name for c in TC.COMPONENTS] == [c.name for c in JC.COMPONENTS]
    for jc, tc in zip(JC.COMPONENTS, TC.COMPONENTS):
        assert (tc.module, tc.tag, tc.networked, tc.path) == (jc.module, jc.tag, jc.networked, jc.path)
        assert [f.name for f in tc.fields] == [f.name for f in jc.fields], jc.name
        for jf, tf in zip(jc.fields, tc.fields):
            assert tf.kind.value == jf.kind.value and tf.enum_values == jf.enum_values
            assert tf.default == jf.default and tf.shape == jf.shape and tf.dtype == jf.dtype
            np.testing.assert_array_equal(tf.default_array(), jf.default_array())
    assert TC.DEVICE_COMPONENTS == JC.DEVICE_COMPONENTS


def test_to_device_state_matches_exactly(scenes):
    js, ts = scenes
    jst = jax.device_get(js.to_device_state())
    got = bridge.scene_state_to_numpy(ts.to_device_state())
    for name in ("alive", "parent", "level", "world", "previous_world", "time", "frame"):
        _assert_tree_equal(getattr(jst, name), got[name], name)
    _assert_tree_equal(jst.comp, got["comp"], "comp")
    _assert_tree_equal(jst.mask, got["mask"], "mask")
    _assert_tree_equal(dataclasses.asdict(jst.particles), got["particles"], "particles")


def test_scene_state_bridge_round_trip(scenes):
    js, _ = scenes
    jst = jax.device_get(js.to_device_state())
    back = bridge.scene_state_to_numpy(bridge.scene_state_from_numpy(jst))
    _assert_tree_equal(jst.comp, back["comp"], "comp")
    np.testing.assert_array_equal(back["world"], jst.world)


def test_propagate_transforms_matches_exactly(scenes):
    js, ts = scenes
    spec = js.spec
    jst = js.to_device_state()
    # move every entity so the sweep recomputes real parent chains
    rng = np.random.default_rng(5)
    pos = np.asarray(jst.comp["TransformComponent"]["position"]) + rng.normal(size=(spec.padded_entities(), 3)).astype(np.float32)
    comp = dict(jst.comp)
    comp["TransformComponent"] = dict(comp["TransformComponent"], position=jnp.asarray(pos))
    jst = dataclasses.replace(jst, comp=comp)
    want = np.asarray(jstate.propagate_transforms(jst, spec))
    got = tstate.propagate_transforms(bridge.scene_state_from_numpy(jax.device_get(jst)), ts.spec)
    assert int(np.asarray(jst.level).max()) >= 3
    np.testing.assert_array_equal(got.numpy(), want)


def test_build_physics_state_matches_exactly(scenes):
    js, ts = scenes
    want = jax.device_get(js.physics_state)
    got = bridge.physics_state_to_numpy(ts.physics_state)
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if w is None or f.name == "has_proxies":
            assert got[f.name] == w, f.name
            continue
        _assert_tree_equal(np.asarray(w), got[f.name], f.name)


def test_physics_state_bridge_round_trip():
    ps = jax.device_get(_falling_boxes(n_boxes=20, max_bodies=256))
    back = bridge.physics_state_to_numpy(bridge.physics_state_from_numpy(ps))
    for f in dataclasses.fields(ps):
        if f.name not in ("has_proxies",) and getattr(ps, f.name) is not None:
            _assert_tree_equal(np.asarray(getattr(ps, f.name)), back[f.name], f.name)


@pytest.fixture(scope="module")
def banded_scene():
    jps = _falling_boxes()
    return jps, bridge.physics_state_from_numpy(jax.device_get(jps))


def test_slab_rank_key_and_sort_match(banded_scene):
    jps, tps = banded_scene
    _, jhub = jband.extract_hub_planes(jps)
    _, thub = tband.extract_hub_planes(tps)
    np.testing.assert_array_equal(thub.numpy(), np.asarray(jhub))
    jkey = jband.slab_rank_key(jps, exclude=jhub)
    tkey = tband.slab_rank_key(tps, exclude=thub)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    _, jperm = jax.lax.sort((jkey, jnp.arange(jps.num_slots, dtype=jnp.int32)), num_keys=1)
    np.testing.assert_array_equal(tband.slab_rank_perm(tkey).numpy(), np.asarray(jperm))


def test_extract_hub_planes_matches(banded_scene):
    jps, tps = banded_scene
    jblock, _ = jband.extract_hub_planes(jps)
    tblock, _ = tband.extract_hub_planes(tps)
    np.testing.assert_array_equal(tblock.numpy(), np.asarray(jblock))
    assert tband.count_hub_planes(tps) == jband.count_hub_planes(jps) == 1


@pytest.mark.parametrize("band", [None, 64])
def test_band_coverage_report_matches(banded_scene, band):
    jps, tps = banded_scene
    assert tband.band_coverage_report(tps, band=band) == jband.band_coverage_report(jps, band=band)


def test_permute_state_matches(banded_scene):
    jps, tps = banded_scene
    perm = np.random.default_rng(0).permutation(jps.num_slots).astype(np.int32)
    jp = jax.device_get(jband._permute_state(jps, jnp.asarray(perm)))
    tp = bridge.physics_state_to_numpy(tband._permute_state(tps, torch.from_numpy(perm).long()))
    for name in jband._PERMUTED_FIELDS:
        np.testing.assert_array_equal(tp[name], np.asarray(getattr(jp, name)), err_msg=name)


def test_build_physics_state_on_flagship_matches():
    """`build_flagship` and the JAX `_build_flagship` make the same bodies."""
    from __graft_entry__ import _build_flagship

    from oxylus_tpu_torch.flagship import build_flagship

    kw = dict(max_entities=128, max_bodies=256, max_particles=64)
    want = jax.device_get(_build_flagship(n_boxes=100, spec_kw=kw).physics_state)
    got = bridge.physics_state_to_numpy(build_flagship(100, spec_kw=kw, device="cpu").physics_state)
    for name in ("pos", "quat", "inv_mass", "inv_inertia", "half_extent", "friction", "active", "body_type"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want, name)), err_msg=name)


def test_physics_params_bridge_keeps_defaults():
    from oxylus_tpu.physics.state import PhysicsParams as JParams
    from oxylus_tpu_torch.physics.state import PhysicsParams

    got = dataclasses.asdict(bridge.physics_params_from_numpy(jax.device_get(JParams())))
    want = dataclasses.asdict(PhysicsParams())
    assert got.keys() == want.keys()
    for k, v in want.items():
        # the JAX defaults are float32 arrays; the port's kernel reads float32 too
        same = np.float32(v) == np.float32(got[k]) if isinstance(v, (float, tuple)) else v == got[k]
        assert np.all(same), k


_rng = np.random.default_rng(9)
_Q = _rng.normal(size=(64, 4)).astype(np.float32)
_Q /= np.linalg.norm(_Q, axis=-1, keepdims=True)
_Q2 = (_Q + 0.05 * _rng.normal(size=(64, 4))).astype(np.float32)
_V = _rng.normal(size=(64, 3)).astype(np.float32)
_S = _rng.uniform(0.5, 2.0, size=(64, 3)).astype(np.float32)
MATH_CASES = {
    "quat_normalize": (lambda m: m.quat_normalize, (_Q2,)),
    "quat_mul": (lambda m: m.quat_mul, (_Q, _Q2)),
    "quat_conj": (lambda m: m.quat_conj, (_Q,)),
    "quat_rotate": (lambda m: m.quat_rotate, (_Q, _V)),
    "quat_to_mat3": (lambda m: m.quat_to_mat3, (_Q,)),
    "quat_slerp": (lambda m: (lambda a, b: m.quat_slerp(a, b, 0.3)), (_Q, _Q2)),
    "quat_from_axis_angle": (lambda m: m.quat_from_axis_angle, (_V, _S[:, 0])),
    "quat_integrate": (lambda m: (lambda q, w: m.quat_integrate(q, w, 1.0 / 60.0)), (_Q, _V)),
    "trs_to_mat4": (lambda m: m.trs_to_mat4, (_V, _Q, _S)),
}


@pytest.mark.parametrize("name", sorted(MATH_CASES))
def test_math3d_matches_jax(name):
    """Elementwise formulas in the same order; 2e-6 covers the float32 rounding of
    sin/arccos/sqrt and cross products in two libraries."""
    from oxylus_tpu.utils import math3d as jm
    from oxylus_tpu_torch.utils import math3d as tm

    pick, args = MATH_CASES[name]
    want = np.asarray(pick(jm)(*(jnp.asarray(a) for a in args)))
    got = pick(tm)(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert tm.quat_identity((2,)).numpy().tolist() == np.asarray(jm.quat_identity((2,))).tolist()


def test_mat4_mul_matches_xla_batched_dot():
    from oxylus_tpu_torch.utils import math3d as tm

    a = _rng.normal(size=(64, 4, 4)).astype(np.float32)
    b = _rng.normal(size=(64, 4, 4)).astype(np.float32)
    want = np.asarray(jnp.matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(tm.mat4_mul(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
