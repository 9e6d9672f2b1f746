"""Scripting: per-scene script instances with the engine lifecycle (a copy of
`oxylus_tpu/scripting/system.py`).

The reference embeds Lua (sol2) with per-scene `LuaSystem` instances resolving lifecycle
callbacks from a script's environment (`Oxylus/include/Scripting/LuaSystem.hpp:25-100`):
on_add/on_remove/on_scene_start/on_scene_stop/on_scene_update/on_fixed_update/
on_scene_render + Jolt contact hooks. Here scripts are **Python modules/sources**
executed in an isolated namespace with the same callback contract — the host language
*is* the scripting language, bound to the engine API (Scene, Entity, components).

A `ScriptManager` module owns compiled scripts keyed by asset UUID (`LuaManager`
analog); a scene's live instances are `ScriptSystem`s in `Scene.lua_systems`, whose
hooks `SceneRunner` dispatches each frame.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

log = logging.getLogger("oxylus.script")

LIFECYCLE = (
    "on_add",
    "on_remove",
    "on_scene_start",
    "on_scene_stop",
    "on_scene_update",
    "on_fixed_update",
    "on_scene_render",
    "on_contact_added",
    "on_contact_persisted",
    "on_contact_removed",
    "on_body_activated",
    "on_body_deactivated",
)


@dataclasses.dataclass
class Script:
    """A compiled script asset: source + module-level namespace."""

    name: str
    source: str
    namespace: dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def compile(cls, name: str, source: str, extra_globals: dict | None = None) -> "Script":
        ns: dict[str, Any] = {"__name__": f"oxylus_script.{name}"}
        if extra_globals:
            ns.update(extra_globals)
        code = compile(source, filename=f"<script {name}>", mode="exec")
        exec(code, ns)  # noqa: S102 — scripts are first-party game code, like Lua in the reference
        return cls(name=name, source=source, namespace=ns)


class ScriptSystem:
    """One scene's live instance of a script (reference `LuaSystem`): its own
    environment dict plus resolved lifecycle callbacks."""

    def __init__(self, script: Script, scene=None):
        self.script = script
        self.scene = scene
        self.env: dict[str, Any] = {}
        self._callbacks: dict[str, Callable] = {}
        for name in LIFECYCLE:
            fn = script.namespace.get(name)
            if callable(fn):
                self._callbacks[name] = fn

    def has(self, name: str) -> bool:
        return name in self._callbacks

    def _call(self, name: str, *args) -> None:
        fn = self._callbacks.get(name)
        if fn is None:
            return
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 — script errors must not kill the engine
            log.exception("script %s: error in %s", self.script.name, name)

    # lifecycle forwarding (names match the reference contract)
    def on_add(self, scene) -> None:
        self._call("on_add", scene, self.env)

    def on_remove(self, scene) -> None:
        self._call("on_remove", scene, self.env)

    def on_scene_start(self, scene) -> None:
        self._call("on_scene_start", scene, self.env)

    def on_scene_stop(self, scene) -> None:
        self._call("on_scene_stop", scene, self.env)

    def on_scene_update(self, scene, dt: float) -> None:
        self._call("on_scene_update", scene, dt, self.env)

    def on_fixed_update(self, scene, dt: float) -> None:
        self._call("on_fixed_update", scene, dt, self.env)

    def on_scene_render(self, scene, extent, format=None) -> None:
        self._call("on_scene_render", scene, extent, self.env)

    def on_contact_added(self, scene, body_a: int, body_b: int, manifold=None) -> None:
        self._call("on_contact_added", scene, body_a, body_b, manifold)

    def on_contact_persisted(self, scene, body_a: int, body_b: int, manifold=None) -> None:
        self._call("on_contact_persisted", scene, body_a, body_b, manifold)

    def on_contact_removed(self, scene, body_a: int, body_b: int) -> None:
        self._call("on_contact_removed", scene, body_a, body_b)

    def on_body_activated(self, scene, entity: int) -> None:
        self._call("on_body_activated", scene, entity)

    def on_body_deactivated(self, scene, entity: int) -> None:
        self._call("on_body_deactivated", scene, entity)


class ScriptManager:
    """Module owning compiled scripts (reference `LuaManager` + bindings)."""

    MODULE_NAME = "ScriptManager"

    def __init__(self) -> None:
        self.scripts: dict[str, Script] = {}  # uuid → Script
        self._api_globals: dict[str, Any] = {}

    def init(self, app=None) -> None:
        # the "bindings": engine API exposed to scripts
        from ..scene import components as C
        from ..scene.scene import Entity, Scene

        self._api_globals = {
            "Scene": Scene,
            "Entity": Entity,
            "components": C,
        }
        if app is not None:
            self._api_globals["app"] = app

    def deinit(self, app=None) -> None:
        self.scripts.clear()

    def load_script(self, uuid: str, source: str, name: str | None = None) -> Script:
        script = Script.compile(name or uuid[:8], source, self._api_globals)
        self.scripts[uuid] = script
        return script

    def create_system(self, uuid: str, scene=None) -> ScriptSystem | None:
        script = self.scripts.get(uuid)
        if script is None:
            log.warning("unknown script %s", uuid)
            return None
        return ScriptSystem(script, scene)
