"""Worlds parallelism (`oxylus_tpu_torch/parallel/sharding.py`) on 4 gloo
ranks against the JAX module on `make_mesh(4)` of the conftest's virtual
devices.

- `tests/test_sharding.py::test_worlds_parallel_physics`' scene (a ball over
  a floor, 32 body slots): 8 worlds, 2 a rank, 120 `physics_substep`s through
  `worlds_step`. Every world within `tests/test_torch_physics_step.py`'s
  substep bound (`ATOL_SUB`) of the JAX worlds, the worlds identical to each
  other on every rank, `worlds_reduce_mean` of the ball's height within 1e-6
  of the JAX value.
- `test_worlds_sharded_megakernel_matches_single`'s stack of 12 boxes: the
  compact call (4 substeps, the plain version on the CPU) over 4 worlds a
  rank, each world bit-equal to the port's own single call. The JAX kernel is
  not run again here: the port's single call is held against it elsewhere
  (`tests/test_torch_megakernel_compact.py`).
- The refusals: a world count that does not divide over the ranks, a mesh of
  another size than the group, a mesh on the CPU without a group or on a card
  that is not there.

One module-scoped fixture spawns the 4 ranks once (`dryrun.spawn_ranks`, from a
thread, while the JAX side computes); the rank function lives here and imports
only the port, so JAX is imported inside the fixture (the spawned processes
import this module for it).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.parallel import dryrun, sharding

torch.set_num_threads(1)

RANKS, WORLDS, SUBSTEPS, COMPACT_WORLDS = 4, 8, 120, 16
ATOL_SUB = {"pos": 1e-6, "quat": 1e-6, "linvel": 1e-6, "angvel": 5e-6}  # tests/test_torch_physics_step.py:42
MEAN_TOL = 1e-6


def _rank(rank, n, device, ball_np, params_np, boxes_np):
    """On one rank: the ball worlds and the compact worlds; returns NumPy."""
    from oxylus_tpu_torch.physics.megakernel_compact import megakernel_substeps_compact
    from oxylus_tpu_torch.physics.state import PhysicsParams
    from oxylus_tpu_torch.physics.step import physics_substep

    mesh = sharding.make_mesh(n, device=device)
    params = bridge.physics_params_from_numpy(params_np)
    batched = sharding.replicate_worlds(bridge.physics_state_from_numpy(ball_np), WORLDS, mesh)
    step = sharding.worlds_step(lambda p: physics_substep(p, params, 1 / 60))
    for _ in range(SUBSTEPS):
        batched = step(batched)
    mean_y = sharding.worlds_reduce_mean(batched.pos[:, 1, 1], mesh)

    kern = functools.partial(megakernel_substeps_compact, params=PhysicsParams(), dt=1 / 60, n_substeps=4,
                             iterations=3, warm=0.7, geom_every=2)
    boxes = bridge.physics_state_from_numpy(boxes_np)
    single = kern(boxes)
    worlds = sharding.worlds_step(kern)(sharding.replicate_worlds(boxes, COMPACT_WORLDS, mesh))

    refused = []
    for call in (lambda: sharding.replicate_worlds(boxes, 6, mesh), lambda: sharding.make_mesh(n + 1, device=device)):
        try:
            call()
        except ValueError:
            refused.append(True)
    return dict(
        ball={k: getattr(batched, k).numpy() for k in ATOL_SUB}, mean_y=float(mean_y),
        compact_pos=worlds.pos.numpy(), compact_vel=worlds.linvel.numpy(),
        single_pos=single.pos.numpy(), single_vel=single.linvel.numpy(), refused=refused,
    )


@pytest.fixture(scope="module")
def run():
    import jax

    from oxylus_tpu.parallel.sharding import make_mesh, replicate_worlds, worlds_reduce_mean, worlds_step
    from oxylus_tpu.physics.state import PhysicsParams
    from oxylus_tpu.physics.step import physics_substep
    from oxylus_tpu.scene.scene import Scene
    from oxylus_tpu.scene.state import SceneSpec

    s = Scene("w", spec=SceneSpec(max_entities=32, max_bodies=32))
    floor = s.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0))
    floor.add("BoxColliderComponent", size=(20.0, 1.0, 20.0))
    ball = s.create_entity("ball")
    ball.add("TransformComponent", position=(0.0, 2.0, 0.0))
    ball.add("SphereColliderComponent", radius=0.5)
    ball.add("RigidBodyComponent")
    s.runtime_start()

    b = Scene("wmk", spec=SceneSpec(max_entities=512, max_bodies=256))
    floor = b.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0))
    floor.add("BoxColliderComponent", size=(20.0, 1.0, 20.0), friction=0.5)
    rng = np.random.default_rng(2)
    for i in range(12):
        e = b.create_entity(f"b{i}")
        j = rng.uniform(-0.03, 0.03, 3)
        e.add("TransformComponent", position=(j[0], 1.0 + i * 1.1 + j[1], j[2]))
        e.add("BoxColliderComponent", size=(0.5, 0.5, 0.5))
        e.add("RigidBodyComponent", type="Dynamic", mass=1.0)
    b.runtime_start()

    params = PhysicsParams(max_pairs=64)
    pool = ThreadPoolExecutor(1)  # the ranks run while the JAX side computes
    ranks = pool.submit(dryrun.spawn_ranks, _rank, RANKS, "cpu", args=(
        jax.device_get(s.physics_state), jax.device_get(params), jax.device_get(b.physics_state)))
    batched = replicate_worlds(s.physics_state, WORLDS, make_mesh(RANKS))
    step = worlds_step(lambda p: physics_substep(p, params, 1 / 60))
    for i in range(SUBSTEPS):
        batched = step(batched)
        if i % 10 == 9:
            jax.block_until_ready(batched)
    want = dict(ball={k: np.asarray(getattr(batched, k)) for k in ATOL_SUB},
                mean_y=float(worlds_reduce_mean(batched.pos[:, 1, 1])))
    pool.shutdown()
    return want, ranks.result()


def test_worlds_physics_match_jax(run):
    want, ranks = run
    for field, atol in ATOL_SUB.items():
        got = np.concatenate([r["ball"][field] for r in ranks])
        assert got.shape == want["ball"][field].shape and got.shape[0] == WORLDS
        np.testing.assert_allclose(got, want["ball"][field], rtol=0, atol=atol, err_msg=field)
        np.testing.assert_array_equal(got, np.broadcast_to(got[:1], got.shape))  # identical worlds stay identical
    assert abs(ranks[0]["ball"]["pos"][0, 1, 1] - 0.5) < 0.06  # the ball rests on the floor
    for r in ranks:
        assert abs(r["mean_y"] - want["mean_y"]) <= MEAN_TOL
        assert r["mean_y"] == ranks[0]["mean_y"]


def test_compact_worlds_equal_the_single_call(run):
    _, ranks = run
    for r in ranks:
        assert r["compact_pos"].shape[0] == COMPACT_WORLDS // RANKS
        for w in range(r["compact_pos"].shape[0]):
            np.testing.assert_array_equal(r["compact_pos"][w], r["single_pos"])
            np.testing.assert_array_equal(r["compact_vel"][w], r["single_vel"])
    assert float(np.abs(ranks[0]["single_vel"]).max()) > 0.1  # the boxes moved


def test_refusals(run):
    _, ranks = run
    assert all(r["refused"] == [True, True] for r in ranks)
    with pytest.raises(RuntimeError):
        sharding.make_mesh(device="cpu")  # no process group in this process
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            sharding.make_mesh()
        with pytest.raises(RuntimeError):
            dryrun.spawn_ranks(_rank, RANKS)
