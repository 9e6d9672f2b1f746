"""The port's contact events (`physics/events.py` and the runner's
`track_contacts` hook) against the JAX package.

- `query_contacts` on the zoo scene of test_torch_physics_step.py: the
  touching entity pairs are exactly equal.
- The two trackers diff the same host arrays into the same events.
- A runner with `track_contacts=True` (the default `physics_substep` route,
  sleep thresholds raised so bodies fall asleep within the run) fires the same
  contact and activation callbacks, frame by frame, as the JAX runner; with
  `contact_events_every=2` only every other frame dispatches.
"""

import jax
import numpy as np
import pytest
import torch

from oxylus_tpu.physics import events as jevents
from oxylus_tpu.physics.state import PhysicsParams as JParams
from oxylus_tpu.runtime import SceneRunner as JRunner
from oxylus_tpu.scene import state as jstate
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.physics import events as tevents
from oxylus_tpu_torch.physics.state import PhysicsParams
from oxylus_tpu_torch.runtime import SceneRunner
from oxylus_tpu_torch.scene import state as tstate

from tests.test_torch_frame import TScene, _pile_scene
from tests.test_torch_physics_step import _zoo_scene

torch.set_num_threads(1)

SLEEPY = dict(sleep_velocity=2.0, sleep_time=0.05)
FRAMES = 8


def test_query_contacts_matches_jax():
    s, _ = _zoo_scene()
    jps = s.physics_state
    want = [np.asarray(v) for v in jax.device_get(jevents.query_contacts(jps, JParams()))]
    got = [t.numpy() for t in tevents.query_contacts(bridge.physics_state_from_numpy(jax.device_get(jps)), PhysicsParams())]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert want[2].sum() >= 10  # many touching pairs


def test_trackers_diff_like_jax():
    rng = np.random.default_rng(2)
    jc, tc = jevents.ContactTracker(), tevents.ContactTracker()
    ja, ta = jevents.ActivationTracker(), tevents.ActivationTracker()
    entity = np.array([-1, 3, 4, 5, 6, 7], np.int32)
    for _ in range(5):
        ea, eb = rng.integers(0, 6, 16).astype(np.int32), rng.integers(0, 6, 16).astype(np.int32)
        valid = rng.random(16) < 0.5
        assert tc.update_from_arrays(ea, eb, valid) == jc.update_from_arrays(ea, eb, valid)
        asleep = rng.random(6) < 0.5
        assert ta.update_from_arrays(asleep, entity) == ja.update_from_arrays(asleep, entity)


class Recorder:
    """A script system that logs the contact and activation callbacks."""

    def __init__(self):
        self.log = []
        self.frame = 0

    def on_scene_start(self, scene):
        pass

    def on_scene_stop(self, scene):
        pass

    def on_scene_update(self, scene, dt):
        self.frame += 1

    def on_fixed_update(self, scene, dt):
        pass

    def on_scene_render(self, scene, size):
        pass

    def on_contact_added(self, scene, a, b):
        self.log.append((self.frame, "added", a, b))

    def on_contact_persisted(self, scene, a, b):
        self.log.append((self.frame, "persisted", a, b))

    def on_contact_removed(self, scene, a, b):
        self.log.append((self.frame, "removed", a, b))

    def on_body_activated(self, scene, e):
        self.log.append((self.frame, "activated", e))

    def on_body_deactivated(self, scene, e):
        self.log.append((self.frame, "deactivated", e))


def _run(Scene, SceneSpec, Runner, params, every, **kw):
    s = _pile_scene(Scene, SceneSpec, max_bodies=128, emitter=False)
    rec = Recorder()
    s.lua_systems["recorder"] = rec
    runner = Runner(s, physics_params=params, track_contacts=True, contact_events_every=every, **kw)
    for _ in range(FRAMES):
        runner.step(1.0 / 60.0)
    return sorted(rec.log)


@pytest.fixture(scope="module", params=[1, 2])
def logs(request):
    jparams = JParams(**{k: np.float32(v) for k, v in SLEEPY.items()})
    want = _run(JScene, jstate.SceneSpec, JRunner, jparams, request.param)
    got = _run(TScene, tstate.SceneSpec, SceneRunner, PhysicsParams(**SLEEPY), request.param, device="cpu")
    return request.param, want, got


def test_runner_fires_the_jax_callbacks(logs):
    _, want, got = logs
    assert got == want


def test_runner_callbacks_cover_every_kind(logs):
    """Guards the premise: contacts were added and persisted, bodies fell
    asleep, and with contact_events_every=2 only odd script frames dispatch
    (frame_index 0, 2, 4, … is script frame 1, 3, 5, …)."""
    every, want, _ = logs
    kinds = {e[1] for e in want}
    assert {"added", "persisted", "deactivated"} <= kinds
    frames = {e[0] for e in want}
    assert frames <= set(range(1, FRAMES + 1, every))
