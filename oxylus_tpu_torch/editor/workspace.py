"""Editor workspace panels: text editor, settings, project management, and the
panel registry (headless panels-as-data, like `editor/panels.py`; counterpart of
`oxylus_tpu/editor/workspace.py`).

References:
- `Oxylus/src/UI/TextEditor.cpp` (multi-document tabs, dirty
  tracking, close queue with unsaved confirmation, save callback)
- `OxylusEditor/src/Panels/EditorSettingsPanel.cpp` (general +
  keybinds tabs, properties written back to the editor's systems)
- `OxylusEditor/src/Panels/ProjectPanel.cpp` (project selector:
  recent list, new-project, load → mount + open start scene)
- `OxylusEditor/src/Panels/EditorPanelRegistry.hpp` (typed
  add/get, update_all/render_all, window menu)
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable


# ---------------------------------------------------------------------------
# Text editor (TextEditor.cpp)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TextDocument:
    name: str
    path: Path | None = None
    content: str = ""
    dirty: bool = False
    open: bool = True
    cursor: int = 0  # character offset

    def insert(self, text: str) -> None:
        self.content = self.content[: self.cursor] + text + self.content[self.cursor :]
        self.cursor += len(text)
        self.dirty = True

    def delete(self, count: int = 1) -> None:
        """Backspace-delete `count` chars before the cursor."""
        start = max(self.cursor - count, 0)
        self.content = self.content[:start] + self.content[self.cursor :]
        self.cursor = start
        self.dirty = True

    def set_content(self, text: str) -> None:
        self.content = text
        self.cursor = min(self.cursor, len(text))
        self.dirty = True

    def lines(self) -> list[str]:
        return self.content.split("\n")


class TextEditorPanel:
    """Multi-document text editor: tabbed documents, dirty tracking, a close
    queue that holds unsaved documents for confirmation (TextEditor.cpp:27-31,
    52-101), and a save callback hook."""

    PANEL_NAME = "Text Editor"

    def __init__(self, save_file_callback: Callable[[str], None] | None = None):
        self.documents: dict[str, TextDocument] = {}
        self.active: str | None = None
        self.close_queue: list[str] = []
        self.save_file_callback = save_file_callback
        self.visible = False

    # -- documents ----------------------------------------------------------
    def open_file(self, file_path) -> TextDocument:
        path = Path(file_path)
        name = path.name
        if name in self.documents:  # re-open focuses the existing tab
            self.active = name
            return self.documents[name]
        doc = TextDocument(name=name, path=path, content=path.read_text() if path.exists() else "")
        self.documents[name] = doc
        self.active = name
        self.visible = True
        return doc

    def open_scratch(self, name: str, content: str = "") -> TextDocument:
        doc = TextDocument(name=name, content=content)
        self.documents[name] = doc
        self.active = name
        return doc

    def save(self, name: str | None = None) -> None:
        doc = self.documents[name or self.active]
        if doc.path is not None:
            doc.path.write_text(doc.content)
        if self.save_file_callback is not None:
            self.save_file_callback(doc.content)
        doc.dirty = False

    # -- close queue (unsaved-confirmation protocol) ------------------------
    def request_close(self, name: str) -> bool:
        """Returns True if closed immediately; dirty documents stay open and
        enter the close queue for confirmation (TextEditor.cpp:27-31)."""
        doc = self.documents.get(name)
        if doc is None:
            return True
        if doc.dirty:
            doc.open = True
            if name not in self.close_queue:
                self.close_queue.append(name)
            return False
        self._force_close(name)
        return True

    def confirm_close(self, save: bool) -> None:
        """Resolve the queue: save-and-close or discard-and-close everything."""
        for name in list(self.close_queue):
            if save:
                self.save(name)
            self._force_close(name)
        self.close_queue.clear()

    def cancel_close(self) -> None:
        self.close_queue.clear()

    def _force_close(self, name: str) -> None:
        self.documents.pop(name, None)
        if self.active == name:
            self.active = next(iter(self.documents), None)

    # -- panel-as-data ------------------------------------------------------
    def build(self) -> dict[str, Any]:
        return {
            "tabs": [
                {"name": d.name, "dirty": d.dirty, "active": d.name == self.active}
                for d in self.documents.values()
            ],
            "body": self.documents[self.active].lines() if self.active else [],
            "close_queue": list(self.close_queue),
        }


# ---------------------------------------------------------------------------
# Editor settings (EditorSettingsPanel.cpp)
# ---------------------------------------------------------------------------

class EditorSettingsPanel:
    """General + Keybinds tabs. General properties write straight back to the
    systems they configure (undo history size ↔ EditorContext); keybinds edit
    the action→key table with a listening state for rebinds."""

    PANEL_NAME = "Editor Settings"
    TABS = ("General", "Keybinds")

    def __init__(self, ctx=None):
        self.ctx = ctx
        self.visible = False
        self.tab = "General"
        self.waiting_for_bind: str | None = None
        self.keybinds: dict[str, int] = {  # action → key code (editor context)
            "editor.save_scene": ord("S"),
            "editor.undo": ord("Z"),
            "editor.redo": ord("Y"),
            "editor.duplicate": ord("D"),
            "editor.delete": 127,
            "editor.play": ord("P"),
        }
        self.general: dict[str, Any] = {"undo_history_size": 256, "ui_scale": 1.0}

    def set_general(self, key: str, value) -> None:
        self.general[key] = value
        if key == "undo_history_size" and self.ctx is not None:
            # apply to the undo system like the reference does
            setattr(self.ctx, "max_history", int(value))

    def begin_rebind(self, action: str) -> None:
        self.waiting_for_bind = action

    def feed_key(self, key: int) -> bool:
        """While listening, the next key press becomes the binding."""
        if self.waiting_for_bind is None:
            return False
        self.keybinds[self.waiting_for_bind] = int(key)
        self.waiting_for_bind = None
        return True

    def build(self) -> dict[str, Any]:
        return {
            "tabs": list(self.TABS),
            "tab": self.tab,
            "general": dict(self.general),
            "keybinds": [
                {"action": a, "key": k, "listening": a == self.waiting_for_bind}
                for a, k in self.keybinds.items()
            ],
        }


# ---------------------------------------------------------------------------
# Project panel (ProjectPanel.cpp)
# ---------------------------------------------------------------------------

class ProjectPanel:
    """Project selector: recent-projects list, new-project creation, and
    load-for-editor (load .oxproj → mount into VFS/assets → open start scene;
    missing paths are pruned from recents, ProjectPanel.cpp:26-47)."""

    PANEL_NAME = "Projects"

    def __init__(self, vfs=None, asset_manager=None):
        self.vfs = vfs
        self.asset_manager = asset_manager
        self.recent: list[str] = []
        self.active_project = None
        self.visible = True

    def add_recent(self, path) -> None:
        p = str(path)
        if p in self.recent:
            self.recent.remove(p)
        self.recent.insert(0, p)
        del self.recent[8:]

    def new_project(self, directory, name: str, asset_dir: str = "Assets"):
        from ..core.project import Project, ProjectConfig

        directory = Path(directory)
        (directory / asset_dir).mkdir(parents=True, exist_ok=True)
        proj = Project(ProjectConfig(name=name, asset_directory=asset_dir), directory=directory)
        path = proj.save(directory / f"{name}.oxproj")
        self.add_recent(path)
        self.active_project = proj
        return proj

    def load_project_for_editor(self, filepath, spec=None, device=None):
        """Returns (project, start_scene | None); prunes dead recents. The start
        scene loads onto `device`: the card unless "cpu"."""
        from ..core.project import Project

        filepath = Path(filepath)
        if not filepath.exists():
            if str(filepath) in self.recent:
                self.recent.remove(str(filepath))
            return None, None
        proj = Project.load(filepath)
        if self.vfs is not None:
            proj.mount(self.vfs, self.asset_manager)
        scene = None
        if proj.config.start_scene:
            try:
                scene = proj.load_start_scene(spec=spec, asset_manager=self.asset_manager, device=device)
            except FileNotFoundError:
                scene = None
        self.active_project = proj
        self.add_recent(filepath)
        self.visible = False  # selector closes on successful load
        return proj, scene

    def build(self) -> dict[str, Any]:
        return {
            "recent": list(self.recent),
            "active": self.active_project.config.name if self.active_project else None,
            "visible": self.visible,
        }


# ---------------------------------------------------------------------------
# Panel registry (EditorPanelRegistry.hpp)
# ---------------------------------------------------------------------------

class EditorPanelRegistry:
    """Typed panel store: one instance per panel class, `add`/`get` by type,
    bulk update/render, and the Window-menu listing of toggleable panels."""

    def __init__(self) -> None:
        self._panels: dict[type, Any] = {}

    def add(self, cls: type, *args, **kwargs):
        if cls not in self._panels:
            self._panels[cls] = cls(*args, **kwargs)
        return self._panels[cls]

    def get(self, cls: type):
        return self._panels[cls]

    def __contains__(self, cls: type) -> bool:
        return cls in self._panels

    def update_all(self) -> None:
        for p in self._panels.values():
            update = getattr(p, "update", None)
            if callable(update):
                update()

    def render_all(self) -> dict[str, Any]:
        """Headless render: build every visible panel's data structure."""
        out: dict[str, Any] = {}
        for p in self._panels.values():
            if getattr(p, "visible", True) and hasattr(p, "build"):
                out[getattr(p, "PANEL_NAME", type(p).__name__)] = p.build()
        return out

    def window_menu(self) -> list[dict[str, Any]]:
        return [
            {"name": getattr(p, "PANEL_NAME", type(p).__name__), "visible": getattr(p, "visible", True)}
            for p in self._panels.values()
        ]

    def toggle(self, name: str) -> None:
        for p in self._panels.values():
            if getattr(p, "PANEL_NAME", type(p).__name__) == name:
                p.visible = not getattr(p, "visible", True)
