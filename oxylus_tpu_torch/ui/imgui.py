"""Immediate-mode GUI layer (counterpart of `oxylus_tpu/ui/imgui.py`: the
reference's `ImGuiRenderer` module, Dear-ImGui-over-vuk).

Widgets are declared every frame between `new_frame()` and
`render()`; the layer tracks hot/active ids against the engine's Input state and
emits panels/text into a `UIDocument`, which composites over the frame on the
frame's device (`UIDocument.composite_over`) — no foreign renderer. The id
stack / same-frame interaction rules follow Dear ImGui's model (hot = hovered
this frame, active = pressed until release).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .text import GLYPH_H, GLYPH_W, UIDocument

PAD = 6
ROW_H = 18
TEXT_SCALE = 1.0


@dataclasses.dataclass
class _WindowState:
    x: float
    y: float
    w: float
    h: float
    cursor_y: float = 0.0
    collapsed: bool = False


class ImGuiRenderer:
    """Module: depends on Input (like the reference's module_dependencies)."""

    MODULE_NAME = "ImGuiRenderer"
    module_dependencies = ("Input",)

    def __init__(self, width: int = 1920, height: int = 1080):
        self.width = width
        self.height = height
        self.doc = UIDocument(width, height)
        self._windows: dict[str, _WindowState] = {}
        self._cur: _WindowState | None = None
        self._cur_title: str | None = None
        self._hot: str | None = None
        self._active: str | None = None
        self._values: dict[str, Any] = {}
        self._input = None
        self._frame_open = False

    # -- module lifecycle ---------------------------------------------------
    def init(self, app=None) -> None:
        if app is not None and hasattr(app, "get_module"):
            self._input = app.get_module("Input")

    def deinit(self, app=None) -> None:
        self._windows.clear()

    # -- frame --------------------------------------------------------------
    def new_frame(self, input_module=None) -> None:
        if input_module is not None:
            self._input = input_module
        self.doc.clear()
        self._hot = None
        self._frame_open = True

    def _mouse(self):
        if self._input is None:
            return (-1.0, -1.0, False)
        mx, my = self._input.get_mouse_position()
        return float(mx), float(my), self._input.get_mouse_held(0)

    # -- windows ------------------------------------------------------------
    def begin(self, title: str, x: float = 20, y: float = 20, w: float = 260, h: float = 200) -> bool:
        st = self._windows.setdefault(title, _WindowState(x, y, w, h))
        self._cur = st
        self._cur_title = title
        st.cursor_y = st.y + ROW_H + PAD
        # title bar (click toggles collapse, like ImGui's arrow)
        bar_id = f"{title}##bar"
        if self._clicked(st.x, st.y, st.w, ROW_H, bar_id):
            st.collapsed = not st.collapsed
        self.doc.add_panel(st.x, st.y, st.w, ROW_H, color=(0.16, 0.3, 0.45, 0.95))
        self.doc.add_text(st.x + PAD, st.y + 4, title, color=(1, 1, 1, 1))
        if not st.collapsed:
            self.doc.add_panel(st.x, st.y + ROW_H, st.w, st.h - ROW_H, color=(0.08, 0.08, 0.1, 0.85))
        return not st.collapsed

    def end(self) -> None:
        self._cur = None
        self._cur_title = None

    # -- widgets ------------------------------------------------------------
    def _row(self, height: float = ROW_H) -> tuple[float, float, float]:
        st = self._cur
        assert st is not None, "widget outside begin()/end()"
        y = st.cursor_y
        st.cursor_y += height + 2
        return st.x + PAD, y, st.w - 2 * PAD

    def _hover(self, x, y, w, h) -> bool:
        mx, my, _ = self._mouse()
        return (x <= mx < x + w) and (y <= my < y + h)

    def _clicked(self, x, y, w, h, wid: str) -> bool:
        mx, my, down = self._mouse()
        over = self._hover(x, y, w, h)
        if over:
            self._hot = wid
        if over and down and self._active is None:
            self._active = wid
            return False
        if not down and self._active == wid:
            self._active = None
            return over
        return False

    def text(self, s: str, color=(0.9, 0.9, 0.9, 1)) -> None:
        x, y, _ = self._row()
        self.doc.add_text(x, y + 3, s, color=color)

    def button(self, label: str) -> bool:
        x, y, w = self._row()
        wid = f"{self._cur_title}/{label}"
        clicked = self._clicked(x, y, w, ROW_H, wid)
        base = (0.25, 0.45, 0.7, 1) if self._hot == wid else (0.2, 0.33, 0.5, 1)
        if self._active == wid:
            base = (0.35, 0.55, 0.8, 1)
        self.doc.add_panel(x, y, w, ROW_H, color=base)
        self.doc.add_text(x + PAD, y + 4, label)
        return clicked

    def checkbox(self, label: str, default: bool = False) -> bool:
        x, y, w = self._row()
        wid = f"{self._cur_title}/{label}"
        val = bool(self._values.get(wid, default))
        if self._clicked(x, y, w, ROW_H, wid):
            val = not val
        self._values[wid] = val
        box = (0.3, 0.8, 0.4, 1) if val else (0.25, 0.25, 0.3, 1)
        self.doc.add_panel(x, y + 3, 12, 12, color=box)
        self.doc.add_text(x + 18, y + 4, label)
        return val

    def slider_float(self, label: str, lo: float, hi: float, default: float) -> float:
        x, y, w = self._row()
        wid = f"{self._cur_title}/{label}"
        val = float(self._values.get(wid, default))
        mx, my, down = self._mouse()
        over = self._hover(x, y, w, ROW_H)
        if over:
            self._hot = wid
        if over and down:
            self._active = wid
        if self._active == wid:
            if down:
                val = lo + (hi - lo) * min(max((mx - x) / max(w, 1e-6), 0.0), 1.0)
            else:
                self._active = None
        self._values[wid] = val
        t = (val - lo) / max(hi - lo, 1e-9)
        self.doc.add_panel(x, y + 4, w, 10, color=(0.2, 0.2, 0.25, 1))
        self.doc.add_panel(x, y + 4, w * t, 10, color=(0.3, 0.6, 0.9, 1))
        self.doc.add_text(x + PAD, y + 3, f"{label}: {val:.3g}")
        return val

    def get_value(self, window: str, label: str, default=None):
        return self._values.get(f"{window}/{label}", default)

    # -- output -------------------------------------------------------------
    def render(self, frame=None):
        """End the frame. With `frame` (H, W, 3|4): composite and return the image,
        on the frame's device for a tensor; without: return the raw sprite batch."""
        self._frame_open = False
        if frame is not None:
            return self.doc.composite_over(frame)
        return self.doc.build_batch()

    def update(self, dt=None) -> None:  # ModuleRegistry update hook
        pass
