"""Contact events: touching-pair extraction and added/persisted/removed
dispatch (counterpart of `oxylus_tpu/physics/events.py`).

The device computes the touching-pair list on demand (one extra broadphase
and narrowphase outside the solver); host-side trackers diff consecutive
frames into events for script systems.
"""

from __future__ import annotations

import numpy as np
import torch

from .state import PhysicsParams, PhysicsState
from .step import broadphase_pairs, narrowphase

Tensor = torch.Tensor


def query_contacts(ps: PhysicsState, params: PhysicsParams) -> tuple[Tensor, Tensor, Tensor]:
    """Returns (entity_a, entity_b, valid): touching pairs as entity indices."""
    dt = torch.tensor(1.0 / 60.0, dtype=torch.float32, device=ps.device)
    ia, ib, pair_valid = broadphase_pairs(ps, params, dt)
    _, _, depth, valid, _, _, _ = narrowphase(ps, params, ia, ib, pair_valid)
    k = params.points_per_pair
    p = ia.shape[0]
    # resting bodies hover a hair above contact (Baumgarte equilibrium), so report
    # touch within the speculative margin like Jolt's contact listener does
    slop = torch.tensor(params.penetration_slop, dtype=torch.float32, device=ps.device)
    threshold = -(slop + torch.tensor(params.speculative_margin, dtype=torch.float32, device=ps.device))
    touching = torch.any((depth.reshape(p, k) > threshold) & valid.reshape(p, k), dim=1)
    ent_a = ps.entity[ia.long()]
    ent_b = ps.entity[ib.long()]
    return ent_a, ent_b, touching & (ent_a >= 0) & (ent_b >= 0)


class ContactTracker:
    """Host-side frame-to-frame contact diffing → script lifecycle callbacks."""

    def __init__(self) -> None:
        self._previous: set[tuple[int, int]] = set()

    def update(self, ps: PhysicsState, params: PhysicsParams):
        """Returns (added, persisted, removed) sets of (entity_a, entity_b) pairs."""
        ent_a, ent_b, valid = (t.cpu().numpy() for t in query_contacts(ps, params))
        return self.update_from_arrays(ent_a, ent_b, valid)

    def update_from_arrays(self, ent_a, ent_b, valid):
        """Diff from arrays already on the host (the runner reads every event
        array in one transfer)."""
        current = {(int(min(a, b)), int(max(a, b))) for a, b, v in zip(ent_a, ent_b, valid) if v}
        added = current - self._previous
        persisted = current & self._previous
        removed = self._previous - current
        self._previous = current
        return added, persisted, removed

    def dispatch(self, scene, ps: PhysicsState, params: PhysicsParams) -> None:
        """Fire script callbacks on the scene's systems (LuaSystem contact hooks)."""
        added, persisted, removed = self.update(ps, params)
        for system in scene.lua_systems.values():
            for a, b in added:
                system.on_contact_added(scene, a, b)
            for a, b in persisted:
                system.on_contact_persisted(scene, a, b)
            for a, b in removed:
                system.on_contact_removed(scene, a, b)


class ActivationTracker:
    """Host-side sleep-state diffing → `on_body_activated` /
    `on_body_deactivated` script callbacks (activation = leaving the solver's
    sleep mask)."""

    def __init__(self) -> None:
        self._prev_asleep = None

    def update(self, ps: PhysicsState):
        """Returns (activated_entities, deactivated_entities) as int lists."""
        return self.update_from_arrays(ps.asleep.cpu().numpy(), ps.entity.cpu().numpy())

    def update_from_arrays(self, asleep, entity):
        asleep = np.asarray(asleep)
        entity = np.asarray(entity)
        if self._prev_asleep is None:
            self._prev_asleep = asleep
            return [], []
        woke = (~asleep) & self._prev_asleep
        slept = asleep & (~self._prev_asleep)
        self._prev_asleep = asleep
        ok = entity >= 0
        return [int(e) for e in entity[woke & ok]], [int(e) for e in entity[slept & ok]]

    def dispatch(self, scene, ps: PhysicsState) -> None:
        activated, deactivated = self.update(ps)
        if not activated and not deactivated:
            return
        for system in scene.lua_systems.values():
            for e in activated:
                system.on_body_activated(scene, e)
            for e in deactivated:
                system.on_body_deactivated(scene, e)
