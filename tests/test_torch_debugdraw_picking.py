"""The port's debug renderer and picking against the JAX package's: the shape queues,
the line raster over a seeded image (exactly), its line samples (bit for bit with
`jnp.linspace`), screen rays (within 1e-5), entity picks (exactly) and body ray casts
on a seeded physics state carried through `bridge.py` (the same body, the distance
within 1e-5)."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.render import debugdraw as jdd
from oxylus_tpu.render import picking as jpick
from oxylus_tpu.render.camera import camera_matrices
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.render import debugdraw as tdd
from oxylus_tpu_torch.render import picking as tpick

torch.set_num_threads(1)

H, W = 48, 64


def _camera(yaw=-np.pi / 2, pitch=-0.3, pos=(0.5, 2.0, 6.0), aspect=W / H):
    return camera_matrices(
        position=jnp.asarray(pos, jnp.float32), yaw=jnp.float32(yaw), pitch=jnp.float32(pitch),
        tilt=jnp.float32(0.0), fov_deg=jnp.float32(60.0), near=jnp.float32(0.1), far=jnp.float32(100.0),
        zoom=jnp.float32(1.0), projection_kind=jnp.int32(0), aspect=jnp.float32(aspect),
    )


def _fill(dr, rng):
    """The same seeded shapes through `dr`'s queue API."""
    for _ in range(6):
        dr.draw_line(rng.uniform(-3, 3, 3), rng.uniform(-3, 3, 3), rng.uniform(0, 1, 3))
    dr.draw_line((-1.0, 0.0, 9.0), (1.0, 0.5, 12.0))  # behind the camera: clipped by w
    dr.draw_line((-80.0, 0.0, -1.0), (90.0, 1.0, -2.0), (1.0, 0.0, 1.0))  # leaves the image
    dr.draw_aabb(rng.uniform(-2, 0, 3), rng.uniform(0, 2, 3), (1.0, 0.2, 0.0))
    dr.draw_sphere(rng.uniform(-1, 1, 3), 0.8, (0.0, 0.4, 1.0), segments=8)
    inv = np.linalg.inv(np.asarray(_camera(yaw=-1.2, pos=(0.0, 1.0, 3.0)).view_projection))
    dr.draw_frustum(inv.astype(np.float32))


def _pair(capacity=tdd.MAX_LINES, seed=3):
    j, t = jdd.DebugRenderer(capacity), tdd.DebugRenderer(capacity)
    _fill(j, np.random.default_rng(seed))
    _fill(t, np.random.default_rng(seed))
    return j, t


def test_shape_queues_match():
    j, t = _pair()
    assert t._count == j._count == 8 + 12 + 3 * 8 + 12
    for k in ("_a", "_b", "_color"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k), err_msg=k)
    # the frustum also takes the inverse as a torch tensor
    inv = np.linalg.inv(np.asarray(_camera().view_projection)).astype(np.float32)
    jf, tf = jdd.DebugRenderer(), tdd.DebugRenderer()
    jf.draw_frustum(inv)
    tf.draw_frustum(torch.from_numpy(inv))
    np.testing.assert_array_equal(tf._a[:12], jf._a[:12])


def test_aabb_is_12_lines_and_capacity_caps():
    for mod in (jdd, tdd):
        dr = mod.DebugRenderer()
        dr.draw_aabb((0, 0, 0), (1, 2, 3))
        assert dr._count == 12
        capped = mod.DebugRenderer(capacity=10)
        for _ in range(20):
            capped.draw_line((0, 0, 0), (1, 1, 1))
        assert capped._count == 10
        capped.reset()
        assert capped._count == 0


@pytest.mark.parametrize("n", [1, 2, 7, 100, 256, 1000])
def test_line_samples_equal_jnp_linspace(n):
    want = np.asarray(jnp.linspace(0.0, 1.0, n))
    got = tdd.line_samples(n).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_int32_cast_saturates_as_xla():
    x = np.array([-3.7, -0.5, 0.0, 0.99, 63.9, 2.5e9, -2.5e9, 3e38, -3e38, np.inf, -np.inf, np.nan,
                  2147483520.0, -2147483648.0], np.float32)
    got = tdd.to_int32_saturating(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    inside = np.abs(x) < 2**31
    np.testing.assert_array_equal(got[inside], want[inside])
    # beyond the range both land past any image edge, on the same side; NaN → 0
    np.testing.assert_array_equal(np.clip(got, -1, W), np.clip(want, -1, W))


@pytest.mark.parametrize("seed", [3, 11])
def test_rasterize_over_matches_jax_exactly(seed):
    j, t = _pair(seed=seed)
    rng = np.random.default_rng(seed + 100)
    image = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    vp = np.array(_camera().view_projection)
    want = np.asarray(j.rasterize_over(jnp.asarray(image), jnp.asarray(vp)))
    src = torch.from_numpy(image.copy())
    got = t.rasterize_over(src, torch.from_numpy(vp)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got != image).any(axis=-1).sum() > 50  # lines were drawn
    np.testing.assert_array_equal(src.numpy(), image)  # the input is not written
    # an empty queue returns the image itself
    empty = torch.from_numpy(image)
    assert tdd.DebugRenderer().rasterize_over(empty, torch.from_numpy(vp)) is empty


def test_screen_ray_within_1e5():
    cam = _camera()
    vp = np.array(cam.view_projection)
    tcam = SimpleNamespace(view_projection=torch.from_numpy(vp))
    for x, y in ((0, 0), (31.5, 20), (W - 1, H - 1), (10, 40)):
        jo, jd = jpick.screen_ray(cam, x, y, W, H)
        to, td = tpick.screen_ray(tcam, x, y, W, H)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def _visbuffer(rng, n_slots, group):
    vm = rng.integers(0, n_slots, (H, W))
    vid = (vm << 8) | rng.integers(0, group, (H, W))
    vid[rng.uniform(size=(H, W)) < 0.3] = -1
    return vid.astype(np.int32)


def test_pick_entities_match_jax_exactly():
    rng = np.random.default_rng(5)
    n_slots, group, n_inst = 12, 64, 9
    vid = _visbuffer(rng, n_slots, group)
    vm_instance = rng.integers(0, n_inst, n_slots).astype(np.int32)
    slot_instance = rng.integers(0, n_inst, n_slots * group - 5).astype(np.int32)  # short: the clip acts
    inst_entity = rng.integers(0, 40, n_inst).astype(np.int32)
    jg = SimpleNamespace(inst_entity=jnp.asarray(inst_entity))
    tg = SimpleNamespace(inst_entity=torch.from_numpy(inst_entity))
    id2d = rng.integers(-1, 30, (H, W)).astype(np.int32)
    points = [(0, 0), (W - 1, H - 1), (-5, 3), (W + 9, H + 2), (17.8, 9.2)] + [
        tuple(p) for p in rng.integers(0, (W, H), (40, 2))]
    n_miss = 0
    for x, y in points:
        assert int(tpick.pick_entity_2d(torch.from_numpy(id2d), x, y)) == int(jpick.pick_entity_2d(jnp.asarray(id2d), x, y))
        for tab in (None, slot_instance):
            want = jpick.pick_entity_3d(jnp.asarray(vid), jnp.asarray(vm_instance), jg, x, y,
                                        slot_instance=None if tab is None else jnp.asarray(tab))
            got = tpick.pick_entity_3d(torch.from_numpy(vid), torch.from_numpy(vm_instance), tg, x, y,
                                       slot_instance=None if tab is None else torch.from_numpy(tab))
            assert got.dtype == torch.int32 and int(got) == int(want), (x, y, tab is None)
            n_miss += int(want) == -1
    assert 0 < n_miss < 2 * len(points)


@pytest.fixture(scope="module")
def bodies():
    """A seeded JAX physics state: boxes, spheres, capsules and cylinders in random
    poses (one inactive), and the same state in the port through `bridge.py`."""
    from oxylus_tpu.scene.scene import Scene
    from oxylus_tpu.scene.state import SceneSpec

    rng = np.random.default_rng(21)
    s = Scene("rays", spec=SceneSpec(max_entities=32, max_bodies=32))
    shapes = (("BoxColliderComponent", dict(size=(1.0, 0.6, 1.4))),
              ("SphereColliderComponent", dict(radius=0.45)),
              ("CapsuleColliderComponent", dict(height=1.2, radius=0.3)),
              ("CylinderColliderComponent", dict(height=0.8, radius=0.5)))
    for i in range(16):
        e = s.create_entity(f"b{i}")
        e.add("TransformComponent", position=tuple(rng.uniform(-3, 3, 3)))
        comp, kw = shapes[i % 4]
        e.add(comp, **kw)
        e.add("RigidBodyComponent")
    s.runtime_start()
    ps = jax.device_get(s.physics_state)
    q = rng.normal(size=np.asarray(ps.quat).shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    active = np.asarray(ps.active).copy()
    active[np.nonzero(active)[0][3]] = False
    ps = dataclasses.replace(ps, quat=q, active=active)
    return jax.tree_util.tree_map(jnp.asarray, ps), bridge.physics_state_from_numpy(ps)


def test_cast_ray_bodies_matches_jax(bodies):
    jps, tps = bodies
    rng = np.random.default_rng(8)
    hits = 0
    for k in range(24):
        origin = rng.uniform(-6, 6, 3).astype(np.float32)
        target = rng.uniform(-2, 2, 3).astype(np.float32) if k % 3 else -origin
        d = (target - origin) / np.linalg.norm(target - origin)
        d = d.astype(np.float32)
        if k == 5:
            d[1] = 0.0  # an axis-parallel component: the 1e-9 guard
        for max_dist in (1000.0, 2.0):
            ji, jt = jpick.cast_ray_bodies(jps, jnp.asarray(origin), jnp.asarray(d), max_dist)
            ti, tt = tpick.cast_ray_bodies(tps, torch.from_numpy(origin), torch.from_numpy(d), max_dist)
            assert int(ti) == int(ji), (k, max_dist)
            np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5, atol=1e-5)
            hits += int(ji) >= 0
    assert hits >= 8
