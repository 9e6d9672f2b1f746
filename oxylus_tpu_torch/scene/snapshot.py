"""Scene snapshot / delta replication library (a copy of `oxylus_tpu/scene/snapshot.py`).

Host-side re-implementation of the reference's delta-compressed scene replication
(`Oxylus/include/Scene/SceneSnapshot.hpp:11-48`, `src/Scene/SceneSnapshot.cpp`): a ring
of 32 sequence-numbered `SceneState` snapshots; per-entity component payload hashes;
`delta(last_acked)` emits only created/removed entities and changed components since
the acknowledged sequence. Components marked with the `Networked` trait replicate
(TransformComponent, SpriteComponent — `Components.cpp:58,75`); entities opt in via the
`Core.Networked` tag. Payloads are the host mirror's field bytes in registry order and
hashes are 8-byte blake2b, so the bytes equal the JAX package's for the same scene and
a port peer can talk to a JAX one. Snapshot the host mirror: call
`SceneRunner.sync_to_host()` first to see the card's latest state.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np

from . import components as C

SNAPSHOT_RING = 32

NETWORKED_COMPONENTS = tuple(c.name for c in C.COMPONENTS if c.networked)


@dataclasses.dataclass
class EntitySnapshot:
    name: str
    tags: tuple[str, ...]
    components: dict[str, bytes]          # component → payload bytes
    hashes: dict[str, int]                # component → payload hash


@dataclasses.dataclass
class SceneSnapshot:
    sequence: int
    entities: dict[int, EntitySnapshot]   # entity index → snapshot


@dataclasses.dataclass
class SnapshotDelta:
    sequence: int
    base_sequence: int                    # -1 = full snapshot
    created: dict[int, dict[str, Any]]    # entity → {name, tags, components{name: payload}}
    removed: tuple[int, ...]
    changed: dict[int, dict[str, bytes]]  # entity → {component: payload}


def _component_payload(scene, idx: int, comp: str) -> bytes:
    cdef = C.BY_NAME[comp]
    parts = []
    for f in cdef.fields:
        if f.kind == C.FieldKind.STRING:
            continue
        parts.append(np.ascontiguousarray(scene._comp_data[comp][f.name][idx]).tobytes())
    return b"".join(parts)


def _payload_hash(payload: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(payload, digest_size=8).digest(), "little")


def decode_component_payload(comp: str, payload: bytes) -> dict[str, np.ndarray]:
    cdef = C.BY_NAME[comp]
    out = {}
    off = 0
    for f in cdef.fields:
        if f.kind == C.FieldKind.STRING:
            continue
        arr = np.zeros(f.shape, f.dtype)
        nbytes = arr.nbytes
        out[f.name] = np.frombuffer(payload[off : off + nbytes], f.dtype).reshape(f.shape or ())
        off += nbytes
    return out


class SceneSnapshotBuilder:
    """Per-connection snapshot state: ring of snapshots + ack tracking."""

    def __init__(self) -> None:
        self._ring: dict[int, SceneSnapshot] = {}
        self._sequence = 0
        self.last_acked: int = -1

    def take_snapshot(self, scene) -> SceneSnapshot:
        self._sequence += 1
        entities: dict[int, EntitySnapshot] = {}
        networked_path = C.BY_NAME["Networked"].path
        for i in np.nonzero(scene._alive)[0]:
            i = int(i)
            if networked_path not in scene._tags[i]:
                continue
            comps: dict[str, bytes] = {}
            hashes: dict[str, int] = {}
            for comp in NETWORKED_COMPONENTS:
                if scene._comp_mask[comp][i]:
                    payload = _component_payload(scene, i, comp)
                    comps[comp] = payload
                    hashes[comp] = _payload_hash(payload)
            entities[i] = EntitySnapshot(
                name=scene._names[i] or "",
                tags=tuple(sorted(scene._tags[i])),
                components=comps,
                hashes=hashes,
            )
        snap = SceneSnapshot(sequence=self._sequence, entities=entities)
        self._ring[self._sequence % SNAPSHOT_RING] = snap
        return snap

    def ack(self, sequence: int) -> None:
        if sequence > self.last_acked:
            self.last_acked = sequence

    def get(self, sequence: int) -> SceneSnapshot | None:
        snap = self._ring.get(sequence % SNAPSHOT_RING)
        return snap if snap is not None and snap.sequence == sequence else None

    def delta(self, snap: SceneSnapshot, base_sequence: int | None = None) -> SnapshotDelta:
        """Delta vs the last-acked (or given) sequence; full snapshot if the base has
        left the ring (the reference's fallback when a client falls behind)."""
        base_seq = self.last_acked if base_sequence is None else base_sequence
        base = self.get(base_seq) if base_seq >= 0 else None

        if base is None:
            created = {
                i: {
                    "name": e.name,
                    "tags": e.tags,
                    "components": dict(e.components),
                }
                for i, e in snap.entities.items()
            }
            return SnapshotDelta(snap.sequence, -1, created, (), {})

        created = {}
        changed = {}
        for i, e in snap.entities.items():
            b = base.entities.get(i)
            if b is None:
                created[i] = {"name": e.name, "tags": e.tags, "components": dict(e.components)}
                continue
            diff = {
                comp: payload
                for comp, payload in e.components.items()
                if b.hashes.get(comp) != e.hashes[comp]
            }
            if diff:
                changed[i] = diff
        removed = tuple(i for i in base.entities if i not in snap.entities)
        return SnapshotDelta(snap.sequence, base.sequence, created, removed, changed)


def apply_delta(scene, delta: SnapshotDelta, entity_map: dict[int, int] | None = None) -> dict[int, int]:
    """Apply a delta to a replica scene. `entity_map` maps source entity index →
    replica entity index (maintained across calls). Returns the updated map."""
    entity_map = dict(entity_map or {})

    for src_idx in delta.removed:
        dst = entity_map.pop(src_idx, None)
        if dst is not None and scene._alive[dst]:
            scene.destroy_entity(dst)

    def write_components(dst: int, comps: dict[str, bytes]) -> None:
        for comp, payload in comps.items():
            scene.add_component(dst, comp)
            for fname, value in decode_component_payload(comp, payload).items():
                scene._comp_data[comp][fname][dst] = value
        scene._device_dirty = True

    for src_idx, spec in delta.created.items():
        if src_idx in entity_map and scene._alive[entity_map[src_idx]]:
            dst = entity_map[src_idx]
        else:
            e = scene.create_entity(spec["name"])
            dst = e.index
            entity_map[src_idx] = dst
        for tag in spec["tags"]:
            scene._tags[dst].add(tag)
        write_components(dst, spec["components"])

    for src_idx, comps in delta.changed.items():
        dst = entity_map.get(src_idx)
        if dst is None:
            continue
        write_components(dst, comps)

    return entity_map
