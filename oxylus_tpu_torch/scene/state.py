"""Device-side scene state: dataclasses of tensors advanced by the frame step
(counterpart of `oxylus_tpu/scene/state.py`).

Fixed-capacity SoA component arrays with validity masks plus an entity table
(parent index, hierarchy level); world transforms are recomputed every step by
a level-ordered batched pass (`propagate_transforms`). Capacities and hierarchy
depth are static (`SceneSpec`). Component fields keep the schema's NumPy dtypes
(`torch.from_numpy`), so uint32/uint64 fields stay unsigned on the device and
are converted where arithmetic reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..utils import math3d
from . import components as C

Tensor = torch.Tensor


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static shape/capacity configuration. Defaults follow the reference's
    published capacities: 1024 bodies, 60 Hz fixed tick."""

    max_entities: int = 1024
    max_depth: int = 8
    max_particles: int = 4096
    max_bodies: int = 1024
    max_contacts: int = 4096
    physics_interval: float = 1.0 / 60.0
    max_substeps: int = 4

    def padded_entities(self) -> int:
        return _round_up(max(self.max_entities, 8), 8)


@dataclasses.dataclass
class SceneState:
    """The state `frame_step` advances.

    - `alive`:   (N,) bool — entity slot in use
    - `parent`:  (N,) i32  — parent entity index, -1 for roots
    - `level`:   (N,) i32  — hierarchy depth (0 = root), computed on the host
    - `world`/`previous_world`: (N, 4, 4) f32
    - `comp`:    {component: {field: (N, …)}} SoA tensors
    - `mask`:    {component: (N,) bool} presence masks
    - `particles`: ParticlePool
    - `time` () f32, `frame` () i32
    """

    alive: Tensor
    parent: Tensor
    level: Tensor
    world: Tensor
    previous_world: Tensor
    comp: dict[str, dict[str, Tensor]]
    mask: dict[str, Tensor]
    particles: Any
    time: Tensor
    frame: Tensor

    @property
    def device(self) -> torch.device:
        return self.alive.device

    def count(self) -> Tensor:
        return torch.sum(self.alive.to(torch.int32))


def _identity_worlds(n: int, device) -> Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).expand(n, 4, 4).clone()


def empty_state(spec: SceneSpec, device: torch.device | str | None = None) -> SceneState:
    """The empty scene state on `device` (the card unless the CPU is asked for)."""
    from .particles import empty_pool

    device = resolve_device(device)

    n = spec.padded_entities()
    comp: dict[str, dict[str, Tensor]] = {}
    mask: dict[str, Tensor] = {}
    for cdef in C.COMPONENTS:
        if cdef.name not in C.DEVICE_COMPONENTS or cdef.tag:
            continue
        fields = {}
        for f in cdef.fields:
            if f.kind == C.FieldKind.STRING:
                continue
            base = np.broadcast_to(f.default_array(), (n,) + f.shape).copy()
            fields[f.name] = torch.from_numpy(base).to(device)
        comp[cdef.name] = fields
        mask[cdef.name] = torch.zeros((n,), dtype=torch.bool, device=device)
    eye = _identity_worlds(n, device)
    return SceneState(
        alive=torch.zeros((n,), dtype=torch.bool, device=device),
        parent=torch.full((n,), -1, dtype=torch.int32, device=device),
        level=torch.zeros((n,), dtype=torch.int32, device=device),
        world=eye,
        previous_world=eye.clone(),
        comp=comp,
        mask=mask,
        particles=empty_pool(spec, device),
        time=torch.zeros((), dtype=torch.float32, device=device),
        frame=torch.zeros((), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Transform hierarchy
# ---------------------------------------------------------------------------

def local_matrices(state: SceneState) -> Tensor:
    t = state.comp["TransformComponent"]
    return math3d.trs_to_mat4(t["position"], t["rotation"], t["scale"])


def propagate_transforms(state: SceneState, spec: SceneSpec, local: Tensor | None = None) -> Tensor:
    """Batched parent-chain world-matrix recompute: `max_depth` masked batched 4×4
    matmul sweeps; at sweep L every entity at level L picks up its (already
    final) parent's world matrix."""
    if local is None:
        local = local_matrices(state)
    parent = torch.clamp(state.parent, min=0).long()  # roots gather themselves; masked below
    world = local
    for lvl in range(1, spec.max_depth):
        composed = math3d.mat4_mul(world[parent], local)
        world = torch.where((state.level == lvl)[:, None, None], composed, world)
    return world


def refresh_world_transforms(state: SceneState, spec: SceneSpec) -> SceneState:
    """Recompute world matrices, rolling the previous-frame matrices."""
    new_world = propagate_transforms(state, spec)
    return dataclasses.replace(state, previous_world=state.world, world=new_world)


# ---------------------------------------------------------------------------
# Host → device
# ---------------------------------------------------------------------------

def compute_levels(parent: np.ndarray, alive: np.ndarray, max_depth: int) -> np.ndarray:
    """Host-side hierarchy level computation (re-run on reparent, which is rare)."""
    n = parent.shape[0]
    level = np.zeros(n, np.int32)
    for i in range(n):
        if not alive[i]:
            continue
        l, p = 0, parent[i]
        while p >= 0 and l < max_depth:
            l += 1
            p = parent[p]
        level[i] = l
    return level
