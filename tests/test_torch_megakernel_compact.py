"""The port's compact substeps (plain PyTorch version, as the wrapper runs it for
CPU tensors) against the JAX compact kernel in interpret mode, on the same
bodies fed through the bridge.

Tolerance: the TPU kernel gathers partner state and scatters impulses through
bf16 hi/lo matmuls (about 2^-17 relative per value); the port indexes exactly.
On the contact-rich pile below over 6 substeps that leaves differences of
~1e-5 m, ~3e-4 m/s and ~2e-3 rad/s, so the bounds are 5e-5 m, 1e-3 m/s,
5e-3 rad/s and 1e-4 on quaternions — inside the compact-vs-banded bound of the
JAX tests (5e-3 m, 5e-2 m/s). The sleeping run uses the same bounds; which
bodies fall asleep must match exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.physics.megakernel_compact import megakernel_substeps_compact as jax_compact
from oxylus_tpu.physics.state import PhysicsParams as JParams
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.physics import megakernel_compact as mc
from oxylus_tpu_torch.physics.state import PhysicsParams

from tests.test_megakernel_banded import _falling_boxes

torch.set_num_threads(1)

DT = 1.0 / 60.0
ATOL = {"pos": 5e-5, "linvel": 1e-3, "angvel": 5e-3, "quat": 1e-4}
KW = dict(iterations=3, warm=0.7, geom_every=2)
# Sleep parameters under which part of the pile falls asleep at the first sleep
# check (substep 4 of 6): the threshold sits in a gap of the bodies' speeds
# there (0.94 and 1.09 m/s), far from rounding-level flips.
SLEEPY = dict(sleep_velocity=1.0, sleep_time=0.05)


def _pile(ps):
    """The same bodies squeezed into a touching pile resting on the floor, with
    seeded random velocities: every contact path (discovery, remap, SAT,
    planes, friction) is live from the first substep."""
    pos = np.asarray(ps.pos).copy()
    dyn = np.asarray(ps.active).copy()
    dyn[0] = False  # the floor
    pos[dyn, 0] *= 0.68
    pos[dyn, 2] *= 0.68
    pos[dyn, 1] = (pos[dyn, 1] - 2.0) * 0.68 - 0.11
    vel = np.zeros_like(pos)
    vel[dyn] = np.random.default_rng(1).normal(0.0, 0.3, (int(dyn.sum()), 3)).astype(np.float32)
    return dataclasses.replace(ps, pos=jnp.asarray(pos), linvel=jnp.asarray(vel))


def _run_both(ps, n_substeps, params=None, **kw):
    params = params or {}
    jparams = JParams(**{k: jnp.float32(v) for k, v in params.items()})
    want, wd = jax_compact(ps, jparams, DT, n_substeps=n_substeps, interpret=True, with_overflow=True, **KW, **kw)
    tps = bridge.physics_state_from_numpy(jax.device_get(ps))
    got, gd = mc.megakernel_substeps_compact(
        tps, PhysicsParams(**params), DT, n_substeps=n_substeps, with_overflow=True, **KW, **kw
    )
    return jax.device_get(want), float(wd), bridge.physics_state_to_numpy(got), float(gd)


@pytest.fixture(scope="module")
def runs():
    fall = _falling_boxes(n_boxes=40, max_bodies=256)
    pile = _pile(fall)
    return {
        "fall": _run_both(fall, 6),
        "pile": _run_both(pile, 6),
        "sleep": _run_both(pile, 6, params=SLEEPY, sleep=True),
    }


@pytest.mark.parametrize("scene", ["fall", "pile", "sleep"])
@pytest.mark.parametrize("field", ["pos", "linvel", "angvel", "quat"])
def test_plain_matches_jax_kernel(runs, scene, field):
    want, _, got, _ = runs[scene]
    np.testing.assert_allclose(got[field], np.asarray(getattr(want, field)), rtol=0, atol=ATOL[field])


@pytest.mark.parametrize("scene", ["fall", "pile", "sleep"])
def test_dropped_counts_and_bookkeeping_match(runs, scene):
    want, wd, got, gd = runs[scene]
    assert gd == wd
    np.testing.assert_array_equal(got["prev_pos"], np.asarray(want.prev_pos))
    np.testing.assert_array_equal(got["asleep"], np.asarray(want.asleep))
    np.testing.assert_array_equal(got["sleep_timer"], np.asarray(want.sleep_timer))


def test_pile_is_in_contact(runs):
    """Guards the test's own premise: the pile scene really exercises contacts."""
    want, _, got, _ = runs["pile"]
    fall_only = np.asarray(want.linvel)[1:41, 1] - (-9.81 * 6 * DT)
    assert np.abs(np.asarray(want.angvel)).max() > 0.05
    assert np.abs(fall_only).max() > 0.1


def test_sleep_run_puts_part_of_the_pile_to_sleep(runs):
    """Guards the sleeping run's premise: some dynamic bodies fell asleep (their
    velocities zeroed), others were woken or kept moving."""
    want, _, _, _ = runs["sleep"]
    asleep = np.asarray(want.asleep)[1:41]
    assert 0 < asleep.sum() < 40
    assert not np.abs(np.asarray(want.linvel)[1:41][asleep]).any()


def test_wide_band_narrow_slots_match_jax():
    """band=256, r_slots=8 at capacity 512 — the knobs the flagship bench uses."""
    ps = _pile(_falling_boxes(n_boxes=40, max_bodies=512))
    want, wd, got, gd = _run_both(ps, 6, band=256, r_slots=8, n_planes=1)
    assert gd == wd
    for field in ("pos", "linvel", "angvel", "quat"):
        np.testing.assert_allclose(got[field], np.asarray(getattr(want, field)), rtol=0, atol=ATOL[field])


def test_cpu_tensors_take_the_plain_version():
    tps = bridge.physics_state_from_numpy(jax.device_get(_falling_boxes(n_boxes=8, max_bodies=256)))
    before = mc.LAUNCHES
    out = mc.megakernel_substeps_compact(tps, PhysicsParams(), DT, n_substeps=2, sleep=True)
    assert mc.LAUNCHES == before  # no kernel launch on the CPU
    assert torch.isfinite(out.pos).all() and out.asleep.dtype == torch.bool


def test_wrapper_rejects_unsupported_inputs():
    tps = bridge.physics_state_from_numpy(jax.device_get(_falling_boxes(n_boxes=8, max_bodies=256)))
    with pytest.raises(ValueError):
        mc.megakernel_substeps_compact(tps, PhysicsParams(), DT, band=256)  # capacity < 128 + band
    with pytest.raises(ValueError):
        mc.megakernel_substeps_compact(tps, PhysicsParams(), DT, warm=0.0)
    rows = torch.zeros((mc.N_ROWS, 256), device="meta")
    with pytest.raises(ValueError):
        mc.run_compact(torch.zeros(mc.N_SCALARS, device="meta"), rows, n_substeps=1)
