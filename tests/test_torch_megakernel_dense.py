"""The port's dense substeps (plain PyTorch version, as the wrapper runs it for
CPU tensors) against the JAX dense kernel in interpret mode, on the same
bodies fed through the bridge.

Scene: capacity 128, a static floor, a stack of boxes, spheres on the floor
and on a box, and a capsule lying 1 cm into a sphere, so that box/box,
box/sphere, sphere/box and round/round pairs all touch. The state in contact
is made by two JAX substeps from the placed bodies and bridged over.

Tolerance: both sides compute the same float32 operations; per-body sums over
the 128 columns (and the mass-split counts' sums) are taken in another order,
so they may differ at rounding level: 1e-6 m, m/s, rad/s and on quaternions
for one substep, 1e-5 after 3 and after 60 (a pile amplifies rounding from
substep to substep; observed ≤ 7.5e-8, ≤ 3.0e-7 and ≤ 4.3e-7). The 60-substep
case holds one port call against 60 chained JAX one-substep calls: the
yardstick `chip_smoke.py` holds the dense kernel's 60-substep call to. Free
fall matches exactly."""

import jax
import numpy as np
import pytest
import torch

from oxylus_tpu.physics.megakernel import megakernel_substeps as jax_dense
from oxylus_tpu.physics.state import PhysicsParams as JParams
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu.scene.state import SceneSpec as JSpec
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.physics import megakernel as mk

torch.set_num_threads(1)

DT = 1.0 / 60.0
FIELDS = ("pos", "linvel", "angvel", "quat")
ATOL = {1: 1e-6, 3: 1e-5, 60: 1e-5}


def _scene(with_compound: bool = False) -> JScene:
    s = JScene("dense", spec=JSpec(max_entities=64, max_bodies=128))
    floor = s.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0))
    floor.add("BoxColliderComponent", size=(20.0, 1.0, 20.0), friction=0.6)
    rng = np.random.default_rng(4)

    def body(pos, collider, rot=(0.0, 0.0, 0.0, 1.0), **kw):
        e = s.create_entity("b")
        e.add("TransformComponent", position=pos, rotation=rot)
        e.add(collider, **kw)
        e.add("RigidBodyComponent", mass=1.0)
        return e

    for i in range(4):  # a stack, each box pressed 1 cm into the one below
        j = rng.uniform(-0.05, 0.05, 2)
        body((j[0], 0.29 + 0.59 * i, j[1]), "BoxColliderComponent", size=(0.3, 0.3, 0.3), friction=0.5)
    body((0.05, 2.64, 0.0), "SphereColliderComponent", radius=0.3)  # on top of the stack
    body((1.5, 0.39, 0.0), "SphereColliderComponent", radius=0.4)
    s45 = float(np.sqrt(0.5))
    body((2.09, 0.2, 0.0), "CapsuleColliderComponent", rot=(s45, 0.0, 0.0, s45), radius=0.2, height=1.0)
    for i in range(6):  # loose boxes and spheres on the floor
        x, z = -2.0 + 0.8 * i, -1.5
        if i % 2:
            body((x, 0.24, z), "SphereColliderComponent", radius=0.25)
        else:
            body((x, 0.24, z), "BoxColliderComponent", size=(0.25, 0.25, 0.25))
    if with_compound:
        e = body((0.0, 3.0, 3.0), "BoxColliderComponent", size=(0.2, 0.2, 0.2), offset=(-0.4, 0.0, 0.0))
        e.add("SphereColliderComponent", radius=0.2, offset=(0.4, 0.0, 0.0))
    s.runtime_start()
    return s


@pytest.fixture(scope="module")
def runs():
    params = JParams()
    one = jax.jit(lambda p: jax_dense(p, params, DT, n_substeps=1, interpret=True))
    ps = _scene().physics_state
    ps = one(one(ps))  # settle into contact
    tparams = bridge.physics_params_from_numpy(jax.device_get(params))
    tps = bridge.physics_state_from_numpy(jax.device_get(ps))
    out = {}
    chained = ps
    for _ in range(60):
        chained = one(chained)
    wants = {1: one(ps), 3: jax_dense(ps, params, DT, n_substeps=3, interpret=True), 60: chained}
    for n, want in wants.items():
        got = mk.megakernel_substeps(tps, tparams, DT, n_substeps=n)
        out[n] = (jax.device_get(want), bridge.physics_state_to_numpy(got))
    return jax.device_get(ps), out


@pytest.mark.parametrize("n", [1, 3, 60])
@pytest.mark.parametrize("field", FIELDS)
def test_plain_matches_jax_kernel(runs, n, field):
    _, out = runs
    want, got = out[n]
    np.testing.assert_allclose(got[field], np.asarray(getattr(want, field)), rtol=0, atol=ATOL[n])


@pytest.mark.parametrize("n", [1, 3, 60])
def test_prev_pose_is_the_pose_before_the_call(runs, n):
    start, out = runs
    _, got = out[n]
    np.testing.assert_array_equal(got["prev_pos"], np.asarray(start.pos))
    np.testing.assert_array_equal(got["prev_quat"], np.asarray(start.quat))


def test_state_is_in_contact_with_every_pair_kind(runs):
    """Guards the premise: the bridged state has touching box/box, box/round
    and round/round pairs, and the substep's contacts change velocities."""
    start, out = runs
    pos = np.asarray(start.pos)
    box = np.asarray(start.shape_type) == 0
    act = np.asarray(start.active)
    rad = np.where(box, np.asarray(start.half_extent).max(1), np.asarray(start.radius) + np.asarray(start.half_length))
    idx = np.nonzero(act)[0][1:]  # skip the floor
    kinds = set()
    for a in idx:
        for b in idx:
            if a < b and np.linalg.norm(pos[a] - pos[b]) < rad[a] + rad[b] + 0.01:
                kinds.add((bool(box[a]), bool(box[b])))
    assert {(True, True), (False, False)} <= kinds and ((True, False) in kinds or (False, True) in kinds)
    want, _ = out[1]
    free = np.asarray(start.linvel)[idx, 1] - 9.81 * DT
    assert np.abs(np.asarray(want.linvel)[idx, 1] - free).max() > 0.05


def test_pair_work_counts_the_state_in_contact(runs):
    """`pair_work` (the operation counts' input): a pair is counted once each
    way, every kind overlaps in this scene, and the touching points are at
    least one per touching kind."""
    start, _ = runs
    tps = bridge.physics_state_from_numpy(start)
    work = mk.pair_work(tps)
    assert work["box_round"] == work["round_box"] > 0
    assert work["box_box"] > 0 and work["round_round"] > 0 and work["box_box"] % 2 == 0
    assert work["points"] >= 3


def test_free_fall_matches_exactly():
    s = JScene("ff", spec=JSpec(max_entities=8, max_bodies=64))
    for i in range(3):
        e = s.create_entity(f"b{i}")
        e.add("TransformComponent", position=(3.0 * i, 10.0, 0.0))
        e.add("BoxColliderComponent" if i % 2 else "SphereColliderComponent")
        e.add("RigidBodyComponent")
    s.runtime_start()
    want = jax.device_get(jax_dense(s.physics_state, JParams(), DT, n_substeps=2, interpret=True))
    got = mk.megakernel_substeps(bridge.physics_state_from_numpy(jax.device_get(s.physics_state)),
                                 bridge.physics_params_from_numpy(jax.device_get(JParams())), DT, n_substeps=2)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))


def test_cpu_tensors_take_the_plain_version():
    tps = bridge.physics_state_from_numpy(jax.device_get(_scene().physics_state))
    before = mk.LAUNCHES
    out = mk.megakernel_substeps(tps, bridge.physics_params_from_numpy(jax.device_get(JParams())), DT)
    assert mk.LAUNCHES == before  # no kernel launch on the CPU
    assert torch.isfinite(out.pos).all()


def test_wrapper_refuses_unsupported_inputs():
    params = bridge.physics_params_from_numpy(jax.device_get(JParams()))
    s = JScene("odd", spec=JSpec(max_entities=8, max_bodies=96))
    s.runtime_start()
    with pytest.raises(ValueError, match="multiple of 64"):
        mk.megakernel_substeps(bridge.physics_state_from_numpy(jax.device_get(s.physics_state)), params, DT)
    compound = bridge.physics_state_from_numpy(jax.device_get(_scene(with_compound=True).physics_state))
    assert compound.has_proxies
    with pytest.raises(ValueError, match="compound"):
        mk.megakernel_substeps(compound, params, DT)
    with pytest.raises(ValueError):
        mk.run_dense(torch.zeros(mk.N_SCALARS, device="meta"), torch.zeros((mk.N_ROWS, 64), device="meta"),
                     n_substeps=1, iterations=10)
