"""Scene JSON serialization — wire-compatible with reference scene files (a copy of
`oxylus_tpu/scene/serialize.py`; both packages write the same text for the same scene
and read each other's files).

Schema (pinned from `Oxylus/src/Scene/Scene.cpp:1948-2215`):

    {
      "name": str,
      "config": { …RendererCVar sections… },
      "scripts": [ {"uuid": str}, … ],
      "entities": [
        { "name": str,
          "tags": [flecs-path, …],
          "components": [ { "Core.TransformComponent": {…fields…} }, … ],
          "children": [ …same shape… ] },
        …
      ]
    }

Field values follow flecs meta JSON: structs as objects of member names
(vec3 → {"x","y","z"}, quat → {"x","y","z","w"}), enums as constant-name strings,
UUIDs as canonical strings (`Components.cpp:40-47`), bools/numbers native. Only root
entities (with TransformComponent, not Hidden) are written; unknown components are
skipped with a warning, matching `json_to_entity` (`Scene.cpp:2026-2036`). Floats
are written as Python floats of the float32 values, so float32 → JSON → float32 is
exact. A loaded scene lives on the device the caller names (the card unless "cpu").
"""

from __future__ import annotations

import json
import logging
from typing import Any

import numpy as np

from ..core import uuid as uuidlib
from ..core.config import RendererConfig
from . import components as C
from .scene import Entity, Scene
from .state import SceneSpec

log = logging.getLogger("oxylus.scene")

_VEC_KEYS = {2: ("x", "y"), 3: ("x", "y", "z"), 4: ("x", "y", "z", "w")}


def _field_to_json(f: C.Field, value: np.ndarray) -> Any:
    if f.kind == C.FieldKind.BOOL:
        return bool(value)
    if f.kind in (C.FieldKind.I32, C.FieldKind.U16, C.FieldKind.U32, C.FieldKind.U64):
        return int(value)
    if f.kind == C.FieldKind.F32:
        return float(value)
    if f.kind == C.FieldKind.ENUM:
        return f.enum_values[int(value)] if f.enum_values else int(value)
    if f.kind == C.FieldKind.UUID:
        return uuidlib.u64_pair_to_uuid(int(value[0]), int(value[1]))
    if f.kind in (C.FieldKind.VEC2, C.FieldKind.VEC3, C.FieldKind.VEC4, C.FieldKind.QUAT):
        keys = _VEC_KEYS[value.shape[-1]]
        return {k: float(v) for k, v in zip(keys, value)}
    raise TypeError(f"unserializable field kind {f.kind}")


def _field_from_json(f: C.Field, value: Any) -> Any:
    if f.kind == C.FieldKind.BOOL:
        return bool(value)
    if f.kind in (C.FieldKind.I32, C.FieldKind.U16, C.FieldKind.U32, C.FieldKind.U64):
        return int(value)
    if f.kind == C.FieldKind.F32:
        return float(value)
    if f.kind == C.FieldKind.ENUM:
        if isinstance(value, str):
            # flecs writes bare constant names; accept fully-scoped paths too
            name = value.rsplit(".", 1)[-1]
            return f.enum_values.index(name)
        return int(value)
    if f.kind == C.FieldKind.UUID:
        return uuidlib.uuid_to_u64_pair(value)
    if f.kind in (C.FieldKind.VEC2, C.FieldKind.VEC3, C.FieldKind.VEC4, C.FieldKind.QUAT):
        n = C._KIND_SHAPE[f.kind][0]
        keys = _VEC_KEYS[n]
        if isinstance(value, dict):
            return [float(value.get(k, 0.0)) for k in keys]
        return [float(v) for v in value]  # tolerate array form
    raise TypeError(f"undeserializable field kind {f.kind}")


def entity_to_json(e: Entity) -> dict[str, Any]:
    scene = e.scene
    i = e.index
    comps = []
    for cdef in C.COMPONENTS:
        if cdef.tag:
            continue
        if not scene._comp_mask[cdef.name][i]:
            continue
        fields = {}
        for f in cdef.fields:
            if f.kind == C.FieldKind.STRING:
                continue
            fields[f.name] = _field_to_json(f, scene._comp_data[cdef.name][f.name][i])
        comps.append({cdef.path: fields})
    return {
        "name": e.name,
        "tags": sorted(scene._tags[i]),
        "components": comps,
        "children": [entity_to_json(c) for c in e.children()],
    }


def json_to_entity(scene: Scene, parent: Entity | None, obj: dict[str, Any], requested_assets: list[str]) -> Entity | None:
    name = obj.get("name")
    if name is None:
        log.error("Entities must have names!")
        return None
    e = scene.create_entity(str(name))
    if parent is not None:
        e.child_of(parent)

    for tag in obj.get("tags", ()):
        tdef = C.lookup(tag)
        if tdef is not None and tdef.tag:
            scene._tags[e.index].add(tdef.path)
        else:
            scene._tags[e.index].add(str(tag))

    for comp_obj in obj.get("components", ()):
        for comp_name, fields in comp_obj.items():
            cdef = C.lookup(comp_name)
            if cdef is None:
                log.warning("Skipping unknown component %s", comp_name)
                continue
            e.add(cdef.name)
            for fname, fval in fields.items():
                try:
                    f = cdef.field(fname)
                except KeyError:
                    log.warning("%s: unknown field %s", cdef.name, fname)
                    continue
                parsed = _field_from_json(f, fval)
                scene.set_field(e.index, cdef.name, fname, parsed)
                if f.kind == C.FieldKind.UUID and fval and not uuidlib.is_nil_pair(*parsed):
                    requested_assets.append(str(fval))

    for child in obj.get("children", ()):
        if json_to_entity(scene, e, child, requested_assets) is None:
            return None
    return e


def scene_to_json(scene: Scene) -> dict[str, Any]:
    entities = []
    for e in scene.root_entities():
        if scene._comp_mask["TransformComponent"][e.index] and not e.has("Hidden"):
            entities.append(entity_to_json(e))
    return {
        "name": scene.scene_name,
        "config": scene.renderer_config.to_json(),
        "scripts": [{"uuid": u} for u in scene.script_uuids],
        "entities": entities,
    }


def scene_from_json(obj: dict[str, Any], spec: SceneSpec | None = None, asset_manager=None, device=None) -> Scene:
    name = obj.get("name")
    if name is None:
        raise ValueError("Scenes must have names!")
    scene = Scene(str(name), spec=spec, device=device)

    config = obj.get("config")
    if config is not None:
        scene.renderer_config = RendererConfig.from_json(config)

    requested_assets: list[str] = []
    for script in obj.get("scripts", ()):
        u = script.get("uuid")
        if u:
            scene.script_uuids.append(u)
            requested_assets.append(u)

    entities = obj.get("entities")
    if entities is None:
        raise ValueError("No entities field found in scene!")
    for ent in entities:
        if json_to_entity(scene, None, ent, requested_assets) is None:
            raise ValueError("corrupt entity JSON")

    if asset_manager is not None:
        for asset_uuid in dict.fromkeys(requested_assets):  # dedupe, keep order
            asset = asset_manager.get_asset(asset_uuid)
            if asset is None:
                log.warning("Ghost asset found! %s", asset_uuid)
                continue
            asset_manager.load_asset(asset_uuid)
    return scene


def save_to_file(scene: Scene, path) -> None:
    with open(path, "w") as fh:
        json.dump(scene_to_json(scene), fh, indent=2)


def load_from_file(path, spec: SceneSpec | None = None, asset_manager=None, device=None) -> Scene:
    with open(path) as fh:
        return scene_from_json(json.load(fh), spec=spec, asset_manager=asset_manager, device=device)
