"""Editor state: selection, undo/redo, play-in-editor (counterpart of
`oxylus_tpu/editor/context.py`).

Headless re-design of the reference editor core (`OxylusEditor/src/Editor.cpp`:
scene play/stop/simulate states, `UndoRedoSystem`, entity selection)
— the same state machine without an ImGui frontend. The panels (panels.py) render
into plain data structures a UI layer (or a test) can consume. Edits go through
`Scene.set_field` into the host mirror, which reaches a device state through
`Scene.merge_host_edits`, as every host edit does; play runs a `Scene.copy()`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from ..scene.scene import Scene


class SceneStateKind(enum.Enum):
    EDIT = 0
    PLAY = 1
    SIMULATE = 2  # physics runs, scripts don't (the reference's Simulate mode)
    PAUSED = 3


@dataclasses.dataclass
class _EditCommand:
    """Undoable component-field edit (Editor.cpp routes edits through
    UndoRedoSystem commands)."""

    entity: int
    component: str
    field: str
    before: Any
    after: Any


class EditorContext:
    def __init__(self, scene: Scene):
        self.edit_scene = scene
        self.runtime_scene: Scene | None = None
        self.state = SceneStateKind.EDIT
        self.selection: list[int] = []
        self._undo: list[_EditCommand] = []
        self._redo: list[_EditCommand] = []

    # ------------------------------------------------------------- selection
    @property
    def scene(self) -> Scene:
        return self.runtime_scene if self.runtime_scene is not None else self.edit_scene

    def select(self, entity: int, additive: bool = False) -> None:
        if not additive:
            self.selection.clear()
        if entity >= 0 and entity not in self.selection:
            self.selection.append(entity)

    def clear_selection(self) -> None:
        self.selection.clear()

    # ------------------------------------------------------------- undo/redo
    def set_field(self, entity: int, component: str, field: str, value) -> None:
        """Edit a component field through the undo stack."""
        sc = self.scene
        before = sc.get_field(entity, component, field)
        sc.set_field(entity, component, field, value)
        self._undo.append(_EditCommand(entity, component, field, before, value))
        self._redo.clear()

    def undo(self) -> bool:
        if not self._undo:
            return False
        cmd = self._undo.pop()
        self.scene.set_field(cmd.entity, cmd.component, cmd.field, cmd.before)
        self._redo.append(cmd)
        return True

    def redo(self) -> bool:
        if not self._redo:
            return False
        cmd = self._redo.pop()
        self.scene.set_field(cmd.entity, cmd.component, cmd.field, cmd.after)
        self._undo.append(cmd)
        return True

    @property
    def undo_count(self) -> int:
        return len(self._undo)

    @property
    def redo_count(self) -> int:
        return len(self._redo)

    # ------------------------------------------------------------- play state
    def on_scene_play(self) -> Scene:
        """Copy the edit scene and start its runtime (`Editor.cpp` play: the edit
        scene stays untouched; stop restores it)."""
        self.runtime_scene = self.edit_scene.copy()
        self.runtime_scene.runtime_start()
        self.state = SceneStateKind.PLAY
        return self.runtime_scene

    def on_scene_simulate(self) -> Scene:
        sc = self.on_scene_play()
        self.state = SceneStateKind.SIMULATE
        return sc

    def on_scene_pause(self) -> None:
        if self.state in (SceneStateKind.PLAY, SceneStateKind.SIMULATE):
            self.state = SceneStateKind.PAUSED

    def on_scene_resume(self) -> None:
        if self.state == SceneStateKind.PAUSED:
            self.state = SceneStateKind.PLAY

    def on_scene_stop(self) -> Scene:
        self.runtime_scene = None
        self.state = SceneStateKind.EDIT
        return self.edit_scene
