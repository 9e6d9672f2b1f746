"""The port's banded substeps (plain PyTorch version, as the wrapper runs it
for CPU tensors) against the JAX banded kernel in interpret mode.

One state: `tests/test_megakernel_banded.py::_falling_boxes` (40 boxes,
capacity 256, two 128-row chunks, so the second chunk's slab is the clamped
one) squeezed into a touching pile with seeded velocities
(`tests/test_torch_megakernel_compact.py::_pile`), carried over with
`bridge.physics_state_from_numpy`. Five substeps in three configurations:
cold (`iterations=10`), the bench's (`iterations=3, warm=0.7, geom_every=2`:
the bf16 λ caches and the bias refresh both run) and the bench's with
sleeping.

Tolerance: both sides compute the same float32 operations in the same order
and differ only in the order of the row and column sums (XLA's reduction
against torch's). Observed ≤ 1.2e-7 m, 2.4e-7 m/s, 7.2e-7 rad/s; the bounds
are 1e-5 m (the target), 1e-4 m/s, 1e-4 rad/s and 1e-5 on quaternions.
Which bodies sleep and their timers must match exactly.

Also the reference quirk the port keeps: `bench.py` checks the bench's
adaptive band (256 on the flagship) for every route, while the banded kernel
covers BAND = 128 only; at band 128 the flagship's start state has pairs
outside the band, the same in both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.physics.megakernel_banded import band_coverage_report as jax_coverage
from oxylus_tpu.physics.megakernel_banded import megakernel_substeps_banded as jax_banded
from oxylus_tpu.physics.state import PhysicsParams as JParams
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.physics import megakernel_banded as mb
from oxylus_tpu_torch.physics.state import PhysicsParams

from tests.test_megakernel_banded import _falling_boxes
from tests.test_torch_megakernel_compact import _pile

torch.set_num_threads(1)

DT = 1.0 / 60.0
N_SUB = 5
ATOL = {"pos": 1e-5, "linvel": 1e-4, "angvel": 1e-4, "quat": 1e-5}
BENCH = dict(iterations=3, warm=0.7, geom_every=2)
# Under these parameters 9 of the 40 boxes fall asleep within the 5 substeps:
# 3 substeps below 1 m/s reach the timer (0.05 s against 0.04 s; 2 give 0.033 s)
SLEEPY = dict(sleep_velocity=1.0, sleep_time=0.04)
CASES = {
    "cold": (dict(iterations=10), {}),
    "bench": (BENCH, {}),
    "sleep": (dict(BENCH, sleep=True), SLEEPY),
}


def _run_both(ps, kw, params):
    jparams = JParams(**{k: jnp.float32(v) for k, v in params.items()})
    want = jax_banded(ps, jparams, DT, n_substeps=N_SUB, interpret=True, **kw)
    tps = bridge.physics_state_from_numpy(jax.device_get(ps))
    got = mb.megakernel_substeps_banded(tps, PhysicsParams(**params), DT, n_substeps=N_SUB, **kw)
    return jax.device_get(want), bridge.physics_state_to_numpy(got)


@pytest.fixture(scope="module")
def runs():
    pile = _pile(_falling_boxes(n_boxes=40, max_bodies=256))
    return {name: _run_both(pile, kw, params) for name, (kw, params) in CASES.items()}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("field", ["pos", "linvel", "angvel", "quat"])
def test_plain_matches_jax_kernel(runs, case, field):
    want, got = runs[case]
    np.testing.assert_allclose(got[field], np.asarray(getattr(want, field)), rtol=0, atol=ATOL[field])


@pytest.mark.parametrize("case", list(CASES))
def test_bookkeeping_matches(runs, case):
    want, got = runs[case]
    np.testing.assert_array_equal(got["prev_pos"], np.asarray(want.prev_pos))
    np.testing.assert_array_equal(got["asleep"], np.asarray(want.asleep))
    np.testing.assert_array_equal(got["sleep_timer"], np.asarray(want.sleep_timer))


def test_pile_is_in_contact(runs):
    """Guards the premise: the pile's contacts act in every configuration."""
    for want, _ in runs.values():
        fall_only = np.asarray(want.linvel)[1:41, 1] - (-9.81 * N_SUB * DT)
        assert np.abs(fall_only).max() > 0.1
        assert np.abs(np.asarray(want.angvel)).max() > 0.05


def test_sleep_run_puts_part_of_the_pile_to_sleep(runs):
    want, _ = runs["sleep"]
    asleep = np.asarray(want.asleep)[1:41]
    assert 0 < asleep.sum() < 40
    assert not np.abs(np.asarray(want.linvel)[1:41][asleep]).any()


def test_cpu_tensors_take_the_plain_version():
    tps = bridge.physics_state_from_numpy(jax.device_get(_falling_boxes(n_boxes=8, max_bodies=256)))
    before = mb.LAUNCHES
    out = mb.megakernel_substeps_banded(tps, PhysicsParams(), DT, n_substeps=2, sleep=True, **BENCH)
    assert mb.LAUNCHES == before  # no kernel launch on the CPU
    assert torch.isfinite(out.pos).all() and out.asleep.dtype == torch.bool


def test_wrapper_rejects_unsupported_inputs():
    tps = bridge.physics_state_from_numpy(jax.device_get(_falling_boxes(n_boxes=8, max_bodies=128)))
    with pytest.raises(ValueError):
        mb.megakernel_substeps_banded(tps, PhysicsParams(), DT)  # capacity < 256
    rows = torch.zeros((36, 256), device="meta")
    with pytest.raises(ValueError):
        mb.run_banded(torch.zeros(74, device="meta"), rows, n_substeps=1, iterations=1, warm=0.0, geom_every=1,
                      sleep=False)


def test_slab_starts_clamp_the_last_chunk():
    assert mb.slab_starts(256) == [0, 0]
    assert mb.slab_starts(1024) == [0, 128, 256, 384, 512, 640, 768, 768]


def test_flagship_pairs_outside_the_banded_kernels_band():
    """The reference quirk (ROADMAP C): at the banded kernel's BAND = 128 the
    flagship's start state leaves pairs outside the band (worst rank distance
    138), equally in both packages, though bench.py's coverage gate passes at
    its adaptive band of 256."""
    from __graft_entry__ import _build_flagship
    from oxylus_tpu_torch.flagship import build_flagship

    want = jax_coverage(_build_flagship(n_boxes=1022).physics_state, band=mb.BAND)
    got = mb.band_coverage_report(build_flagship(1022, device="cpu").physics_state, band=mb.BAND)
    assert got == want
    assert got["outside_band"] > 0 and got["max_rank_dist"] > mb.BAND
    assert max(128, -(-(got["max_rank_dist"] + 96) // 128) * 128) == 256  # the bench's adaptive band
