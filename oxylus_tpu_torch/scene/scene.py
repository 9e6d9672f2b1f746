"""Host-side Scene: entity/component store, hierarchy, runtime lifecycle
(counterpart of `oxylus_tpu/scene/scene.py`).

The analog of `ox::Scene` (`Scene.hpp:59-222`): owns the entity table and SoA
component arrays on the host (NumPy), mirrors them into a `SceneState` of tensors
on the scene's device for the frame step, and runs the lifecycle the reference
runs (`runtime_start` creates physics bodies from collider components —
`Scene.cpp:1040-1072`). The host model is a copy of the JAX module's; only the
device boundary (`to_device_state`, `sync_from_device`, `merge_host_edits`,
`apply_pending_body_ops`) speaks torch. The device is chosen at construction:
the card unless `device="cpu"` is given, resolved strictly (no CPU fallback).
`copy()` clones through the JSON serializer (`scene/serialize.py`), on the same
device.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..core import uuid as uuidlib
from ..core.config import RendererConfig
from ..device import resolve_device
from . import components as C
from .state import SceneSpec, SceneState, _identity_worlds, compute_levels

log = logging.getLogger("oxylus.scene")


class Entity:
    """Lightweight handle: scene + slot index (like a flecs::entity)."""

    __slots__ = ("scene", "index")

    def __init__(self, scene: "Scene", index: int):
        self.scene = scene
        self.index = index

    # -- identity -----------------------------------------------------------
    @property
    def name(self) -> str:
        return self.scene._names[self.index]

    @name.setter
    def name(self, value: str) -> None:
        self.scene._names[self.index] = value

    @property
    def alive(self) -> bool:
        return bool(self.scene._alive[self.index])

    # -- hierarchy ----------------------------------------------------------
    @property
    def parent(self) -> "Entity | None":
        p = int(self.scene._parent[self.index])
        return Entity(self.scene, p) if p >= 0 else None

    def child_of(self, parent: "Entity | None") -> "Entity":
        self.scene.set_parent(self.index, parent.index if parent is not None else -1)
        return self

    def children(self) -> Iterator["Entity"]:
        idx = np.nonzero((self.scene._parent == self.index) & self.scene._alive)[0]
        for i in idx:
            yield Entity(self.scene, int(i))

    # -- components ---------------------------------------------------------
    def add(self, comp: str, **fields: Any) -> "Entity":
        self.scene.add_component(self.index, comp, **fields)
        return self

    def remove(self, comp: str) -> "Entity":
        self.scene.remove_component(self.index, comp)
        return self

    def has(self, comp: str) -> bool:
        return self.scene.has_component(self.index, comp)

    def get(self, comp: str) -> dict[str, Any]:
        return self.scene.get_component(self.index, comp)

    def set(self, comp: str, **fields: Any) -> "Entity":
        return self.add(comp, **fields)

    def add_tag(self, tag: str) -> "Entity":
        cdef = C.lookup(tag)
        if cdef is not None and cdef.tag:
            # known tag component: store its canonical path and fire observers
            self.scene.add_component(self.index, cdef.name)
        else:
            self.scene._tags[self.index].add(tag)
        return self

    def has_tag(self, tag: str) -> bool:
        tags = self.scene._tags[self.index]
        if tag in tags:
            return True
        cdef = C.lookup(tag)
        return cdef is not None and cdef.tag and cdef.path in tags

    def destruct(self) -> None:
        self.scene.destroy_entity(self.index)

    def __repr__(self) -> str:
        return f"Entity({self.index!r}, {self.name!r})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Entity) and other.scene is self.scene and other.index == self.index
        )

    def __hash__(self) -> int:
        return hash((id(self.scene), self.index))


class Scene:
    def __init__(self, name: str = "scene", spec: SceneSpec | None = None, device=None):
        self.scene_name = name
        self.spec = spec or SceneSpec()
        self.device = resolve_device(device)
        n = self.spec.padded_entities()

        self._alive = np.zeros(n, np.bool_)
        self._parent = np.full(n, -1, np.int32)
        self._names: list[str | None] = [None] * n
        self._tags: list[set[str]] = [set() for _ in range(n)]
        self._free: list[int] = list(range(n - 1, -1, -1))

        # SoA component storage (host mirror of the device pytree)
        self._comp_mask: dict[str, np.ndarray] = {}
        self._comp_data: dict[str, dict[str, np.ndarray]] = {}
        for cdef in C.COMPONENTS:
            if cdef.tag:
                continue
            self._comp_mask[cdef.name] = np.zeros(n, np.bool_)
            fields = {}
            for f in cdef.fields:
                if f.kind == C.FieldKind.STRING:
                    continue
                fields[f.name] = np.broadcast_to(f.default_array(), (n,) + f.shape).copy()
            self._comp_data[cdef.name] = fields

        # lifecycle / configuration
        self.renderer_config = RendererConfig()
        self.script_uuids: list[str] = []
        self.lua_systems: dict[str, Any] = {}
        # script-defined ECS systems/observers (the reference lets Lua scripts
        # define flecs systems/observers/queries — `LuaFlecsBindings.cpp`);
        # handle → record, insertion-ordered within each phase
        self.script_ecs_systems: dict[int, dict[str, Any]] = {}
        self._observers: dict[int, tuple[str, str, Callable]] = {}
        self._next_handle = 1
        self.running = False
        self.physics_state = None  # built at runtime_start
        self._device_dirty = True
        self._cached_device_state: SceneState | None = None
        self.deferred_functions: list[Callable[["Scene"], None]] = []
        # queued body-dynamics ops (AddForce/AddTorque/..., see body_add_force)
        self._pending_body_ops: list[tuple] = []

    # ------------------------------------------------------------------ entities
    def create_entity(self, name: str = "") -> Entity:
        if not self._free:
            self._grow()
        i = self._free.pop()
        self._alive[i] = True
        self._parent[i] = -1
        base = name or "entity"
        final = base
        suffix = 1
        existing = {self._names[j] for j in np.nonzero(self._alive)[0] if j != i}
        while final in existing:
            final = f"{base}_{suffix}"
            suffix += 1
        self._names[i] = final
        self._tags[i] = set()
        self._device_dirty = True
        return Entity(self, i)

    def destroy_entity(self, index: int) -> None:
        for child in list(Entity(self, index).children()):
            self.destroy_entity(child.index)
        # fire remove observers before clearing state (flecs OnRemove fires on
        # entity destruction too — `Scene.cpp` observers see the dying entity)
        if self._observers:
            for name, m in self._comp_mask.items():
                if m[index]:
                    self._fire_observers(name, "remove", index)
            for path in list(self._tags[index]):
                cdef = C.lookup(path)
                if cdef is not None:
                    self._fire_observers(cdef.name, "remove", index)
        self._alive[index] = False
        self._names[index] = None
        self._tags[index] = set()
        self._parent[index] = -1
        for name, m in self._comp_mask.items():
            if m[index]:
                m[index] = False
                for f in C.BY_NAME[name].fields:
                    if f.kind == C.FieldKind.STRING:
                        continue
                    self._comp_data[name][f.name][index] = f.default_array()
        self._free.append(index)
        self._device_dirty = True

    def entity(self, name: str) -> Entity | None:
        for i in np.nonzero(self._alive)[0]:
            if self._names[i] == name:
                return Entity(self, int(i))
        return None

    def entities(self) -> Iterator[Entity]:
        for i in np.nonzero(self._alive)[0]:
            yield Entity(self, int(i))

    def root_entities(self) -> Iterator[Entity]:
        for i in np.nonzero(self._alive & (self._parent < 0))[0]:
            yield Entity(self, int(i))

    def set_parent(self, index: int, parent_index: int) -> None:
        # cycle guard
        p = parent_index
        while p >= 0:
            if p == index:
                raise ValueError("reparent would create a cycle")
            p = int(self._parent[p])
        self._parent[index] = parent_index
        self._device_dirty = True

    def _grow(self) -> None:
        old = self._alive.shape[0]
        new = old * 2
        self.spec = dataclasses.replace(self.spec, max_entities=new)
        pad = lambda a, fill: np.concatenate([a, np.full((new - old,) + a.shape[1:], fill, a.dtype)])
        self._alive = pad(self._alive, False)
        self._parent = pad(self._parent, -1)
        self._names += [None] * (new - old)
        self._tags += [set() for _ in range(new - old)]
        self._free = list(range(new - 1, old - 1, -1)) + self._free
        for name, cdef in C.BY_NAME.items():
            if cdef.tag:
                continue
            self._comp_mask[name] = pad(self._comp_mask[name], False)
            for f in cdef.fields:
                if f.kind == C.FieldKind.STRING:
                    continue
                arr = self._comp_data[name][f.name]
                tail = np.broadcast_to(f.default_array(), (new - old,) + f.shape).copy()
                self._comp_data[name][f.name] = np.concatenate([arr, tail])
        self._device_dirty = True

    # ------------------------------------------------------------------ components
    def add_component(self, index: int, comp: str, **fields: Any) -> None:
        cdef = C.lookup(comp)
        if cdef is None:
            raise KeyError(f"unknown component {comp!r}")
        if cdef.tag:
            was_tagged = cdef.path in self._tags[index]
            self._tags[index].add(cdef.path)
            if not was_tagged:
                self._fire_observers(cdef.name, "add", index)
            return
        was_present = bool(self._comp_mask[cdef.name][index])
        self._comp_mask[cdef.name][index] = True
        if not was_present:
            for f in cdef.fields:
                if f.kind == C.FieldKind.STRING:
                    continue
                self._comp_data[cdef.name][f.name][index] = f.default_array()
        for k, v in fields.items():
            self.set_field(index, cdef.name, k, v)
        self._device_dirty = True
        if not was_present:
            self._fire_observers(cdef.name, "add", index)

    def remove_component(self, index: int, comp: str) -> None:
        cdef = C.lookup(comp)
        if cdef is None:
            raise KeyError(f"unknown component {comp!r}")
        if cdef.tag:
            if cdef.path in self._tags[index]:
                self._tags[index].discard(cdef.path)
                self._fire_observers(cdef.name, "remove", index)
            return
        was_present = bool(self._comp_mask[cdef.name][index])
        self._comp_mask[cdef.name][index] = False
        self._device_dirty = True
        if was_present:
            self._fire_observers(cdef.name, "remove", index)

    def has_component(self, index: int, comp: str) -> bool:
        cdef = C.lookup(comp)
        if cdef is None:
            return False
        if cdef.tag:
            return cdef.path in self._tags[index]
        return bool(self._comp_mask[cdef.name][index])

    def set_field(self, index: int, comp: str, field: str, value: Any) -> None:
        cdef = C.BY_NAME[comp]
        f = cdef.field(field)
        if f.kind == C.FieldKind.UUID:
            if isinstance(value, str):
                value = uuidlib.uuid_to_u64_pair(value)
        elif f.kind == C.FieldKind.ENUM and isinstance(value, str):
            value = f.enum_values.index(value)
        self._comp_data[comp][field][index] = np.asarray(value)
        self._device_dirty = True

    def get_field(self, index: int, comp: str, field: str) -> Any:
        return np.array(self._comp_data[comp][field][index])

    def get_component(self, index: int, comp: str) -> dict[str, Any]:
        cdef = C.BY_NAME[comp]
        if not self._comp_mask[comp][index]:
            raise KeyError(f"entity {index} has no {comp}")
        out = {}
        for f in cdef.fields:
            if f.kind == C.FieldKind.STRING:
                continue
            v = self._comp_data[comp][f.name][index]
            if f.kind == C.FieldKind.UUID:
                out[f.name] = uuidlib.u64_pair_to_uuid(v[0], v[1])
            elif f.kind == C.FieldKind.ENUM:
                out[f.name] = f.enum_values[int(v)]
            elif f.shape == ():
                out[f.name] = v.item()
            else:
                out[f.name] = np.array(v)
        return out

    def query(self, *comps: str) -> Iterator[Entity]:
        """Entities that have every listed component (flecs-query analog)."""
        m = self._alive.copy()
        for comp in comps:
            cdef = C.lookup(comp)
            if cdef is None:
                return
            if cdef.tag:
                tag_mask = np.array([cdef.path in t for t in self._tags], np.bool_)
                m &= tag_mask
            else:
                m &= self._comp_mask[cdef.name]
        for i in np.nonzero(m)[0]:
            yield Entity(self, int(i))

    # --------------------------------------------- script systems & observers
    # Scripts (and engine code) can register host-side ECS systems and
    # component add/remove observers, mirroring the reference's Lua flecs
    # bindings (`Oxylus/src/Scripting/LuaFlecsBindings.cpp`:
    # world:system / world:observer / world:query). Systems run in phase order
    # at `progress()` — the analog of `flecs::world::progress()` driven from
    # `Scene::runtime_update` (`Scene.cpp:1157`).

    PHASES = ("pre_update", "update", "post_update")

    def register_system(
        self,
        fn: Callable,
        comps: tuple[str, ...] | list[str] = (),
        phase: str = "update",
        name: str | None = None,
    ) -> int:
        """Register a host-side system. With `comps`, `fn(entity, dt)` is called
        for every matching entity (flecs `each`); without, `fn(scene, dt)` once
        per progress. Returns a handle for `unregister_system`."""
        if phase not in self.PHASES:
            raise ValueError(f"unknown phase {phase!r}; one of {self.PHASES}")
        h = self._next_handle
        self._next_handle += 1
        self.script_ecs_systems[h] = {
            "fn": fn, "comps": tuple(comps), "phase": phase, "name": name or getattr(fn, "__name__", "system"),
        }
        return h

    def unregister_system(self, handle: int) -> None:
        self.script_ecs_systems.pop(handle, None)

    def observe(self, comp: str, event: str, fn: Callable) -> int:
        """Observer on component/tag add|remove: `fn(entity)` fires when the
        component is added to / removed from an entity (flecs OnAdd/OnRemove)."""
        if event not in ("add", "remove"):
            raise ValueError("event must be 'add' or 'remove'")
        cdef = C.lookup(comp)
        if cdef is None:
            raise KeyError(f"unknown component {comp!r}")
        h = self._next_handle
        self._next_handle += 1
        self._observers[h] = (cdef.name, event, fn)
        return h

    def unobserve(self, handle: int) -> None:
        self._observers.pop(handle, None)

    def _fire_observers(self, comp_name: str, event: str, index: int) -> None:
        if not self._observers:
            return
        for key, ev, fn in list(self._observers.values()):
            if key != comp_name or ev != event:
                continue
            try:
                fn(Entity(self, index))
            except Exception:  # noqa: BLE001 — observer errors must not kill the engine
                log.exception("observer error on %s %s", event, comp_name)

    def progress(self, dt: float) -> None:
        """Run registered host-side systems in phase order (flecs progress analog)."""
        if not self.script_ecs_systems:
            return
        for phase in self.PHASES:
            for rec in list(self.script_ecs_systems.values()):
                if rec["phase"] != phase:
                    continue
                try:
                    if rec["comps"]:
                        for e in self.query(*rec["comps"]):
                            rec["fn"](e, dt)
                    else:
                        rec["fn"](self, dt)
                except Exception:  # noqa: BLE001
                    log.exception("system %s error", rec["name"])

    # ------------------------------------------------------------------ device mirror
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        # always a copy: on the CPU `.to` alone would share the host mirror's
        # memory, and a host edit would reach the state before a merge
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, copy=True)

    def to_device_state(self) -> SceneState:
        """Build (or fetch cached) the SceneState on the scene's device."""
        if not self._device_dirty and self._cached_device_state is not None:
            return self._cached_device_state
        from .particles import empty_pool
        from .state import refresh_world_transforms

        spec = self.spec
        n = spec.padded_entities()
        level = compute_levels(self._parent[:n], self._alive[:n], spec.max_depth)
        comp = {}
        mask = {}
        for name in self._comp_mask:
            if name not in C.DEVICE_COMPONENTS:
                continue
            comp[name] = {k: self._tensor(v[:n]) for k, v in self._comp_data[name].items()}
            mask[name] = self._tensor(self._comp_mask[name][:n])
        eye = _identity_worlds(n, self.device)
        state = SceneState(
            alive=self._tensor(self._alive[:n]),
            parent=self._tensor(self._parent[:n]),
            level=self._tensor(level),
            world=eye,
            previous_world=eye,
            comp=comp,
            mask=mask,
            particles=empty_pool(spec, self.device),
            time=torch.zeros((), dtype=torch.float32, device=self.device),
            frame=torch.zeros((), dtype=torch.int32, device=self.device),
        )
        state = refresh_world_transforms(state, spec)
        state = dataclasses.replace(state, previous_world=state.world)
        self._cached_device_state = state
        self._device_dirty = False
        return state

    def sync_from_device(self, state: SceneState) -> None:
        """Copy device simulation results back into the host mirror (for saving,
        inspection, scripting). Pulls only component fields."""
        for name, fields in state.comp.items():
            if name not in self._comp_data:
                continue
            for k, v in fields.items():
                self._comp_data[name][k][: v.shape[0]] = v.cpu().numpy()
        # cached state stays valid: the device state IS the truth
        self._cached_device_state = state
        self._device_dirty = False

    def merge_host_edits(self, state: SceneState) -> SceneState:
        """Re-upload host-mirror component data into an existing device state,
        preserving device-only simulation fields (particle pool, time/frame,
        previous_world). Used after scripts mutate the host scene mid-run; new
        physics bodies still require a `runtime_start`."""
        from .state import refresh_world_transforms

        spec = self.spec
        n = spec.padded_entities()
        old_n = int(state.alive.shape[0])
        if n != old_n:
            # a script-created entity grew the capacity: re-pad the device-only
            # per-entity arrays (new rows get identity transforms)
            ident = _identity_worlds(n - old_n, self.device)
            state = dataclasses.replace(
                state,
                world=torch.cat([state.world, ident]),
                previous_world=torch.cat([state.previous_world, ident]),
            )
        comp = {
            name: {k: self._tensor(self._comp_data[name][k][:n]) for k in fields}
            for name, fields in state.comp.items()
        }
        mask = {name: self._tensor(self._comp_mask[name][:n]) for name in state.mask}
        level = compute_levels(self._parent[:n], self._alive[:n], spec.max_depth)
        st = dataclasses.replace(
            state,
            alive=self._tensor(self._alive[:n]),
            parent=self._tensor(self._parent[:n]),
            level=self._tensor(level),
            comp=comp,
            mask=mask,
        )
        st = refresh_world_transforms(st, spec)
        if n != old_n:
            prev = st.previous_world.clone()
            prev[old_n:] = st.world[old_n:]
            st = dataclasses.replace(st, previous_world=prev)
        self._cached_device_state = st
        self._device_dirty = False
        return st

    # ------------------------------------------------------------------ lifecycle
    def defer(self, fn: Callable[["Scene"], None]) -> None:
        self.deferred_functions.append(fn)

    def run_deferred(self) -> None:
        fns, self.deferred_functions = self.deferred_functions, []
        for fn in fns:
            fn(self)

    # ---- script-facing body dynamics API -----------------------------------
    # Mirrors the Jolt body methods the reference binds to Lua
    # (`Oxylus/src/Scripting/LuaPhysicsBindings.cpp:175,248-273`):
    # AddForce/AddTorque/AddImpulse/AddAngularImpulse/SetApplyGyroscopicForce.
    # Ops accumulate host-side and are folded into the device PhysicsState by
    # `apply_pending_body_ops` right before the next physics dispatch — forces
    # apply over one 60 Hz tick (Jolt clears force accumulators each Update).

    def body_add_force(self, entity_index: int, force) -> None:
        self._pending_body_ops.append(("force", int(entity_index), tuple(force), None))

    def body_add_torque(self, entity_index: int, torque) -> None:
        self._pending_body_ops.append(("torque", int(entity_index), tuple(torque), None))

    def body_add_impulse(self, entity_index: int, impulse, point=None) -> None:
        pt = None if point is None else tuple(point)
        self._pending_body_ops.append(("impulse", int(entity_index), tuple(impulse), pt))

    def body_add_angular_impulse(self, entity_index: int, impulse) -> None:
        self._pending_body_ops.append(("ang_impulse", int(entity_index), tuple(impulse), None))

    def body_set_apply_gyroscopic(self, entity_index: int, flag: bool = True) -> None:
        self._pending_body_ops.append(("gyro", int(entity_index), bool(flag), None))

    def apply_pending_body_ops(self, ps, h: float = 1.0 / 60.0):
        """Fold queued body ops into a PhysicsState. Forces/torques convert to
        velocity deltas over one fixed tick `h`; impulses apply directly."""
        from ..utils import math3d as _m3

        ops, self._pending_body_ops = self._pending_body_ops, []
        if not ops or ps is None:
            return ps
        host = lambda t: t.cpu().numpy().copy()
        ent = host(ps.entity)
        slot_of = {int(e): s for s, e in enumerate(ent) if e >= 0}
        linvel = host(ps.linvel)
        angvel = host(ps.angvel)
        gyro = host(ps.apply_gyro)
        inv_mass = host(ps.inv_mass)
        pos = host(ps.pos)
        quat = host(ps.quat)
        inv_inertia = host(ps.inv_inertia)
        touched_vel = touched_gyro = False
        for kind, e, v, point in ops:
            s = slot_of.get(e)
            if s is None:
                continue
            if kind == "gyro":
                gyro[s] = v
                touched_gyro = True
                continue
            rot = _m3.quat_to_mat3(torch.from_numpy(quat[s][None])).numpy()[0]
            inv_iw = rot @ np.diag(inv_inertia[s]) @ rot.T
            v = np.asarray(v, np.float32)
            if kind == "force":
                linvel[s] += v * inv_mass[s] * h
            elif kind == "torque":
                angvel[s] += inv_iw @ v * h
            elif kind == "impulse":
                linvel[s] += v * inv_mass[s]
                if point is not None:
                    angvel[s] += inv_iw @ np.cross(np.asarray(point, np.float32) - pos[s], v)
            elif kind == "ang_impulse":
                angvel[s] += inv_iw @ v
            touched_vel = True
        rep = {}
        if touched_vel:
            rep.update(linvel=self._tensor(linvel), angvel=self._tensor(angvel))
        if touched_gyro:
            rep.update(apply_gyro=self._tensor(gyro))
        return dataclasses.replace(ps, **rep) if rep else ps

    def set_collision_meshes(self, meshes: dict) -> None:
        """Register raw triangle geometry for MeshColliderComponent entities:
        {mesh_index: (positions (V,3), indices (I,))}. The reference resolves the
        entity's MeshComponent model into a Jolt MeshShape at body construction
        (`Scene.cpp:1717-1850`); here the caller provides the triangle source
        (typically BakedMesh.positions/indices) before runtime_start()."""
        self._collision_meshes = dict(meshes)

    def runtime_start(self) -> None:
        """Create the physics world from collider components
        (mirrors `Scene::physics_init`, `Scene.cpp:1040-1072`)."""
        from ..physics.build import build_physics_state

        self.physics_state = build_physics_state(self, self.device)
        self.running = True
        for system in self.lua_systems.values():
            system.on_scene_start(self)

    def runtime_stop(self) -> None:
        for system in self.lua_systems.values():
            system.on_scene_stop(self)
        self.physics_state = None
        self.running = False

    def copy(self) -> "Scene":
        """Clone via JSON round-trip, exactly like the reference (`Scene.cpp:2095-2108`)."""
        from .serialize import scene_from_json, scene_to_json

        data = scene_to_json(self)
        new_scene = scene_from_json(data, spec=self.spec, device=self.device)
        new_scene.scene_name = f"{self.scene_name}_copy"
        return new_scene
