"""Debug UI widgets: console, scene hierarchy, asset registry, net stats
(counterpart of `oxylus_tpu/ui/widgets.py`).

Headless re-creations of the reference's ImGui debug widgets (`Oxylus/include/UI/
{RuntimeConsole,SceneHierarchyViewer,AssetManagerViewer,NetStatsViewer}.hpp`):
each widget renders to text (for terminal/TUI/log display) and exposes the same data
queries a graphical frontend would bind. `RuntimeConsole` registers as a log sink
(`Log::add_callback` analog) and executes CVar get/set commands exactly like the
reference console.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any

from ..scene import components as C


class RuntimeConsole(logging.Handler):
    """Scrollback console + command execution (reference `RuntimeConsole`)."""

    def __init__(self, cvars=None, capacity: int = 512):
        super().__init__()
        self.lines: deque[tuple[float, int, str]] = deque(maxlen=capacity)
        self.cvars = cvars
        self.commands: dict[str, Any] = {}
        self.register_command("help", lambda *a: ", ".join(sorted(self.commands)))
        self.register_command("clear", lambda *a: self.lines.clear() or "")

    # logging sink
    def emit(self, record: logging.LogRecord) -> None:
        self.lines.append((record.created, record.levelno, record.getMessage()))

    def attach(self, logger: logging.Logger | None = None) -> None:
        (logger or logging.getLogger()).addHandler(self)

    def register_command(self, name: str, fn) -> None:
        self.commands[name] = fn

    def execute(self, line: str) -> str:
        """`> cvar_name` prints, `> cvar_name value` sets, otherwise command lookup."""
        parts = line.strip().split()
        if not parts:
            return ""
        name, args = parts[0], parts[1:]
        if name in self.commands:
            out = self.commands[name](*args)
            result = str(out) if out is not None else ""
        elif self.cvars is not None and name in self.cvars.names():
            if args:
                self.cvars.set(name, args[0])
                result = f"{name} = {self.cvars.get(name)}"
            else:
                result = f"{name} = {self.cvars.get(name)}"
        else:
            result = f"unknown command or cvar: {name}"
        self.lines.append((time.time(), logging.INFO, f"> {line}\n{result}"))
        return result

    def render_text(self, last: int = 20) -> str:
        rows = list(self.lines)[-last:]
        level_tag = {logging.DEBUG: "D", logging.INFO: "I", logging.WARNING: "W", logging.ERROR: "E"}
        return "\n".join(f"[{level_tag.get(lvl, '?')}] {msg}" for _, lvl, msg in rows)


class SceneHierarchyViewer:
    """Entity tree view (reference `SceneHierarchyViewer`)."""

    def __init__(self, scene):
        self.scene = scene

    def render_text(self) -> str:
        out: list[str] = [f"Scene: {self.scene.scene_name}"]

        def walk(entity, depth):
            comps = [
                c.name.replace("Component", "")
                for c in C.COMPONENTS
                if not c.tag and self.scene._comp_mask[c.name][entity.index]
            ]
            out.append("  " * depth + f"- {entity.name} [{', '.join(comps)}]")
            for child in entity.children():
                walk(child, depth + 1)

        for root in self.scene.root_entities():
            walk(root, 1)
        return "\n".join(out)


class AssetManagerViewer:
    """Asset registry table (reference `AssetManagerViewer`)."""

    def __init__(self, asset_manager):
        self.assets = asset_manager

    def render_text(self) -> str:
        rows = ["uuid                                 type      refs  loaded  path"]
        for a in self.assets.registry_snapshot():
            rows.append(
                f"{a.uuid}  {a.type.value:<8}  {a.ref_count:<4}  {str(a.is_loaded):<6}  {a.path}"
            )
        return "\n".join(rows)


class NetStatsViewer:
    """Per-peer traffic stats (reference `NetStatsViewer`)."""

    def __init__(self, network_manager):
        self.net = network_manager

    def render_text(self) -> str:
        rows = ["host        peer                  sent(b/pk)      recv(b/pk)"]
        for i, server in enumerate(self.net.servers):
            for peer in server.peers.values():
                rows.append(
                    f"server[{i}]  {peer.name:<20.20}  {peer.bytes_sent}/{peer.packets_sent}"
                    f"      {peer.bytes_received}/{peer.packets_received}"
                )
        for i, client in enumerate(self.net.clients):
            p = client.server
            rows.append(
                f"client[{i}]  {p.name:<20.20}  {p.bytes_sent}/{p.packets_sent}"
                f"      {p.bytes_received}/{p.packets_received}"
            )
        return "\n".join(rows)
