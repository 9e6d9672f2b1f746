"""The port's `physics/step.py` against the JAX module, on the same state fed
through the bridge.

Scene ("zoo"): a static floor and a static triangle-mesh terrain, and bodies
touching in every shape pair the narrowphase knows — box/box, box/sphere,
box/capsule, box/tapered capsule, box/cylinder (both orders), capsule/tapered
capsule, cylinder/sphere — plus a static sensor overlapping a sphere, a
compound (box + sphere proxies), a character capsule, a kinematic box, a
DOF-masked box, a spinning gyroscopic box and two bodies on the terrain's
slopes; seeded random velocities, two bodies asleep at the start.

Tolerances. Broadphase pairs are compared exactly. The JAX functions run op by
op on the CPU, where each op rounds as the port's does, except the small
contractions (`einsum`, `scatter-add`), which XLA and PyTorch may sum in other
orders: contact quantities and one solver call within 1e-6 (contacts came out
identical); after 4 substeps (jitted on the JAX side) 1e-6 m, m/s and on
quaternions, 5e-6 rad/s (observed ≤ 2.4e-7); which bodies sleep, and the sleep
timers, must match exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.physics import step as jstep
from oxylus_tpu.physics.state import PhysicsParams as JParams
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu.scene.state import SceneSpec as JSpec
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.physics import step as tstep

from tests.test_colliders import _terrain_mesh
from tests.test_golden_trajectory import GOLDEN, build_golden_scene

torch.set_num_threads(1)

DT = 1.0 / 60.0
N_SUB = 4
ATOL_SUB = {"pos": 1e-6, "quat": 1e-6, "linvel": 1e-6, "angvel": 5e-6, "ground_normal_y": 1e-6,
            "sleep_timer": 0.0}
SLEEPY = dict(sleep_velocity=0.3, sleep_time=0.03)


def _zoo_scene() -> tuple[JScene, dict]:
    """The zoo scene, started, and its entity index by name."""
    s = JScene("zoo", spec=JSpec(max_entities=64, max_bodies=64))
    index = {}

    def ent(name, pos, collider, kw, rb=None, rot=(0.0, 0.0, 0.0, 1.0)):
        e = s.create_entity(name)
        index[name] = e.index
        e.add("TransformComponent", position=pos, rotation=rot)
        e.add(collider, **kw)
        if rb is not None:
            e.add("RigidBodyComponent", **rb)
        return e

    ent("floor", (0.0, -1.0, 0.0), "BoxColliderComponent", dict(size=(20.0, 1.0, 20.0), friction=0.6))
    ter = s.create_entity("terrain")
    ter.add("TransformComponent", position=(10.0, 0.0, 0.0))
    ter.add("MeshComponent", mesh_index=0)
    ter.add("MeshColliderComponent", friction=0.6)
    s.set_collision_meshes({0: _terrain_mesh()})

    dyn = dict(mass=1.0)
    s45 = float(np.sqrt(0.5))
    ent("box_a", (0.0, 0.38, 0.0), "BoxColliderComponent", dict(size=(0.4, 0.4, 0.4), friction=0.5), dyn)
    ent("ball_on_box", (0.1, 1.07, 0.05), "SphereColliderComponent", dict(radius=0.3, friction=0.4), dyn)
    ent("capsule", (-1.2, 0.19, 0.0), "CapsuleColliderComponent", dict(radius=0.2, height=0.8), dyn,
        rot=(0.0, 0.0, s45, s45))
    ent("tapered", (-1.2, 0.59, 0.45), "TaperedCapsuleColliderComponent",
        dict(top_radius=0.1, bottom_radius=0.3, height=0.6), dyn)
    ent("cylinder", (1.2, 0.29, 0.0), "CylinderColliderComponent", dict(radius=0.3, height=0.6), dyn)
    ent("ball_by_cyl", (1.74, 0.24, 0.0), "SphereColliderComponent", dict(radius=0.25), dyn)
    ent("box_on_cyl", (1.2, 0.83, 0.1), "BoxColliderComponent", dict(size=(0.25, 0.25, 0.25)), dyn)
    ent("sensor", (0.1, 1.07, 0.5), "BoxColliderComponent", dict(size=(0.3, 0.3, 0.3)),
        dict(type="Static", is_sensor=True))
    comp = ent("compound", (0.0, 0.2, -1.5), "BoxColliderComponent", dict(size=(0.2, 0.2, 0.2), offset=(-0.5, 0.0, 0.0)),
               dict(mass=2.0))
    comp.add("SphereColliderComponent", radius=0.25, offset=(0.5, 0.0, 0.0))
    hero = s.create_entity("hero")
    index["hero"] = hero.index
    hero.add("TransformComponent", position=(2.5, 0.66, -1.0))
    hero.add("CharacterControllerComponent")
    ent("kinematic", (3.0, 0.5, 2.0), "BoxColliderComponent", dict(size=(0.3, 0.3, 0.3)), dict(type="Kinematic"))
    ent("dof_box", (-2.5, 0.29, -1.0), "BoxColliderComponent", dict(size=(0.3, 0.3, 0.3)),
        dict(mass=1.0, allowed_dofs=0b100011))
    ent("spinner", (-3.0, 3.0, 2.0), "BoxColliderComponent", dict(size=(0.1, 0.2, 0.4)), dyn)
    rng = np.random.default_rng(5)
    for i in range(3):  # a short stack
        j = rng.uniform(-0.03, 0.03, 2)
        ent(f"stack{i}", (-2.5 + j[0], 0.28 + 0.58 * i, 1.0 + j[1]), "BoxColliderComponent",
            dict(size=(0.3, 0.3, 0.3), friction=0.5), dyn)
    ent("terrain_ball", (11.6, 1.0, 0.3), "SphereColliderComponent", dict(radius=0.4), dyn)
    ent("terrain_box", (8.5, 0.95, 0.0), "BoxColliderComponent", dict(size=(0.3, 0.3, 0.3)), dyn)
    s.runtime_start()
    return s, index


@pytest.fixture(scope="module")
def zoo():
    """The zoo's JAX state with seeded velocities, the spinner gyroscopic, and
    the stack's top two boxes asleep."""
    s, index = _zoo_scene()
    ps = jax.device_get(s.physics_state)
    ent = np.asarray(ps.entity)
    slot = lambda name: int(np.nonzero(ent == index[name])[0][0])
    dyn = np.asarray(ps.active) & (np.asarray(ps.body_type) == 2) & ~np.asarray(ps.is_character)
    rng = np.random.default_rng(9)
    lin = np.asarray(ps.linvel).copy()
    ang = np.asarray(ps.angvel).copy()
    lin[dyn] = rng.normal(0.0, 0.2, (int(dyn.sum()), 3))
    ang[dyn] = rng.normal(0.0, 0.5, (int(dyn.sum()), 3))
    ang[slot("spinner")] = (3.0, 0.2, 0.1)
    lin[slot("kinematic")] = (0.5, 0.0, 0.0)
    gyro = np.asarray(ps.apply_gyro).copy()
    gyro[slot("spinner")] = True
    asleep = np.asarray(ps.asleep).copy()
    for name in ("stack1", "stack2"):
        asleep[slot(name)] = True
        lin[slot(name)] = 0.0
        ang[slot(name)] = 0.0
    ps = dataclasses.replace(
        ps, linvel=lin.astype(np.float32), angvel=ang.astype(np.float32), apply_gyro=gyro, asleep=asleep,
    )
    return jax.tree_util.tree_map(jnp.asarray, ps), slot


def _torch_pair(jps, **params):
    jparams = JParams(**{k: (jnp.float32(v) if isinstance(v, float) else v) for k, v in params.items()})
    tps = bridge.physics_state_from_numpy(jax.device_get(jps))
    return jparams, tps, bridge.physics_params_from_numpy(jax.device_get(jparams))


@pytest.mark.parametrize("max_pairs", [256, 8])
def test_broadphase_pairs_exact(zoo, max_pairs):
    jps, _ = zoo
    jparams, tps, tparams = _torch_pair(jps, max_pairs=max_pairs)
    want = [np.asarray(v) for v in jstep.broadphase_pairs(jps, jparams, DT)]
    got = [v.numpy() for v in tstep.broadphase_pairs(tps, tparams, DT)]
    for w, g, name in zip(want, got, ("ia", "ib", "valid")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    found = int(tstep.broadphase_mask(tps, tparams, DT).sum())
    assert (found > max_pairs) == (max_pairs == 8)  # the small capacity overflows
    assert int(got[2].sum()) == min(found, max_pairs)


@pytest.fixture(scope="module")
def contacts(zoo):
    jps, _ = zoo
    jparams, tps, tparams = _torch_pair(jps, max_pairs=256)
    ia, ib, pv = jstep.broadphase_pairs(jps, jparams, DT)
    want = jax.device_get(jstep.narrowphase(jps, jparams, ia, ib, pv))
    tia, tib, tpv = (torch.from_numpy(np.array(v)) for v in (ia, ib, pv))
    got = [v.numpy() for v in tstep.narrowphase(tps, tparams, tia, tib, tpv)]
    return want, got, (np.asarray(ia), np.asarray(ib), np.asarray(pv)), jps


def test_zoo_covers_every_shape_pair(contacts):
    """Guards the premise: every narrowphase branch has a touching pair."""
    want, _, (ia, ib, pv), jps = contacts
    shape = np.asarray(jps.shape_type)
    sensor = np.asarray(jps.is_sensor)
    parent = np.asarray(jps.parent)
    touching = np.asarray(want[6]) & pv
    kinds = {(int(shape[a]), int(shape[b])) for a, b, t in zip(ia, ib, touching) if t}
    assert {(0, 0), (0, 1), (1, 1), (0, 2), (2, 0), (1, 2)} <= kinds | {(b, a) for a, b in kinds}
    assert (0, 2) in kinds and (2, 0) in kinds  # box/cylinder in both orders
    assert any(sensor[a] or sensor[b] for a, b, t in zip(ia, ib, touching) if t)
    assert any(parent[a] >= 0 or parent[b] >= 0 for a, b, t in zip(ia, ib, touching) if t)
    assert (np.asarray(jps.radius2) != np.asarray(jps.radius))[np.asarray(jps.active)].any()  # tapered


@pytest.mark.parametrize("i,name", [(0, "normal"), (1, "point"), (2, "depth")])
def test_narrowphase_matches_jax(contacts, i, name):
    want, got, _, _ = contacts
    valid = np.asarray(want[3])
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[6], np.asarray(want[6]))  # touching per pair
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    np.testing.assert_array_equal(got[5], np.asarray(want[5]))
    np.testing.assert_allclose(got[i][valid], np.asarray(want[i])[valid], rtol=0, atol=1e-6, err_msg=name)


def test_mesh_contacts_match_jax(zoo):
    jps, slot = zoo
    jparams, tps, tparams = _torch_pair(jps)
    want = jax.device_get(jstep.mesh_contacts(jps, jparams))
    got = [v.numpy() for v in tstep.mesh_contacts(tps, tparams)]
    valid = np.asarray(want[3])
    k = jparams.points_per_pair
    on_terrain = valid.reshape(-1, k).any(1)
    assert on_terrain[slot("terrain_ball")] and on_terrain[slot("terrain_box")]
    np.testing.assert_array_equal(got[3], valid)
    np.testing.assert_array_equal(got[4], np.asarray(want[4]))
    np.testing.assert_array_equal(got[5], np.asarray(want[5]))
    for i in range(3):
        np.testing.assert_allclose(got[i][valid], np.asarray(want[i])[valid], rtol=0, atol=1e-6)


def test_top_k_keeps_the_lower_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e9, 3.0, -1e9]])
    vals, idx = tstep._top_k(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("comm", ["matmul", "scatter"])
def test_solve_velocity_matches_jax(zoo, comm):
    """One solver call on the zoo's contacts (pairs and terrain); the JAX side
    runs its `comm` branch, the port its one path."""
    jps, _ = zoo
    jparams, tps, tparams = _torch_pair(jps, max_pairs=256, comm=comm)
    ia, ib, pv = jstep.broadphase_pairs(jps, jparams, DT)
    nrm, pt, dp, va, cia, cib, _ = jstep.narrowphase(jps, jparams, ia, ib, pv)
    mesh = jstep.mesh_contacts(jps, jparams)
    stream = [jnp.concatenate([a, m]) for a, m in zip((nrm, pt, dp, va, cia, cib), mesh)]
    want = jax.device_get(jstep.solve_velocity(jps, jparams, DT, *stream))
    got = tstep.solve_velocity(tps, tparams, DT, *(torch.from_numpy(np.array(v)) for v in stream))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert np.abs(np.asarray(want[0]) - np.asarray(jps.linvel)).max() > 0.05  # contacts acted


@pytest.fixture(scope="module")
def substeps(zoo):
    jps, _ = zoo
    jparams, tps, tparams = _torch_pair(jps, max_pairs=256, **SLEEPY)
    jsub = jax.jit(lambda p: jstep.physics_substep(p, jparams, DT))
    start_asleep = np.asarray(jps.asleep)
    for _ in range(N_SUB):
        jps = jsub(jps)
        tps = tstep.physics_substep(tps, tparams, DT)
    return jax.device_get(jps), bridge.physics_state_to_numpy(tps), start_asleep


@pytest.mark.parametrize("field", ["pos", "quat", "linvel", "angvel", "ground_normal_y", "sleep_timer"])
def test_physics_substep_matches_jax(substeps, field):
    want, got, _ = substeps
    np.testing.assert_allclose(got[field], np.asarray(getattr(want, field)), rtol=0, atol=ATOL_SUB[field])


def test_physics_substep_sleep_and_bookkeeping(substeps, zoo):
    want, got, start_asleep = substeps
    _, slot = zoo
    np.testing.assert_array_equal(got["asleep"], np.asarray(want.asleep))
    np.testing.assert_allclose(got["prev_pos"], np.asarray(want.prev_pos), rtol=0, atol=ATOL_SUB["pos"])
    asleep = np.asarray(want.asleep)
    assert asleep.any() and (asleep != start_asleep).any()  # some bodies slept or woke
    assert np.asarray(want.ground_normal_y)[slot("hero")] > 0.7  # the character stands on the floor
    root = slot("compound")
    proxy = int(np.nonzero(np.asarray(want.parent) == root)[0][0])
    np.testing.assert_array_equal(got["pos"][proxy], got["pos"][root])  # proxies follow the root


def test_golden_trajectory():
    """The port's substep over `build_golden_scene` meets the thresholds of
    tests/test_golden_trajectory.py against the stored rollout."""
    golden = np.load(GOLDEN)["traj"]
    s = build_golden_scene()
    s.runtime_start()
    ps = bridge.physics_state_from_numpy(jax.device_get(s.physics_state))
    params = bridge.physics_params_from_numpy(jax.device_get(JParams(max_pairs=256)))
    traj = []
    for k in range(300):
        ps = tstep.physics_substep(ps, params, 1 / 60)
        if k % 30 == 29:
            traj.append(ps.pos[:13].numpy().copy())
    traj = np.stack(traj)
    np.testing.assert_allclose(traj[0], golden[0], atol=1e-3)
    np.testing.assert_allclose(traj[2], golden[2], atol=0.05)
    assert np.abs(traj[-1] - golden[-1]).max() < 0.5
    assert traj[:, 1:, 1].min() > -0.1
    assert np.abs(traj).max() < 50.0
