"""Game-UI document system (counterpart of `oxylus_tpu/ui/rml.py`: the
reference's RmlUI module family, `Oxylus/src/UI/{RmlUI,RmlView,RmlSystem,RmlRenderer}.cpp`
— RmlUi-over-vuk; the document/styling engine itself lives in the third-party
RmlUi library there).

A self-contained RML (XML markup) + RCSS (CSS subset)
engine. Documents are parsed into an element tree, styled by cascading rules
(specificity + document order + inline), laid out with a block box model
(px / % sizes, margin, padding, text wrapping on the engine's bitmap font),
data-bound with `{{ name }}` interpolation against a data model, and emitted
as panels/text into a `UIDocument`, which composites over the frame on the
frame's device, exactly like the ImGui layer. Input routing (hover view, capture
view while a button is held) mirrors `RmlUI.cpp`'s router semantics.
"""

from __future__ import annotations

import dataclasses
import re
import xml.etree.ElementTree as ET
from typing import Any, Callable

from .text import GLYPH_H, GLYPH_W, UIDocument

# ---------------------------------------------------------------------------
# RCSS: parsing + cascade
# ---------------------------------------------------------------------------

_COLOR_NAMES = {
    "black": (0, 0, 0, 1), "white": (1, 1, 1, 1), "red": (1, 0, 0, 1),
    "green": (0, 0.8, 0, 1), "blue": (0.2, 0.4, 1, 1), "grey": (0.5, 0.5, 0.5, 1),
    "gray": (0.5, 0.5, 0.5, 1), "yellow": (1, 0.9, 0.2, 1), "orange": (1, 0.6, 0.1, 1),
    "transparent": (0, 0, 0, 0),
}


def parse_color(v: str):
    v = v.strip()
    if v in _COLOR_NAMES:
        return _COLOR_NAMES[v]
    if v.startswith("#"):
        s = v[1:]
        if len(s) == 3:
            s = "".join(c * 2 for c in s)
        r = int(s[0:2], 16) / 255.0
        g = int(s[2:4], 16) / 255.0
        b = int(s[4:6], 16) / 255.0
        a = int(s[6:8], 16) / 255.0 if len(s) >= 8 else 1.0
        return (r, g, b, a)
    m = re.match(r"rgba?\(([^)]*)\)", v)
    if m:
        parts = [float(p) for p in m.group(1).split(",")]
        rgb = [p / 255.0 if p > 1 else p for p in parts[:3]]
        a = parts[3] if len(parts) > 3 else 1.0
        return (*rgb, a)
    return (1, 1, 1, 1)


@dataclasses.dataclass
class Rule:
    selector: str
    specificity: tuple[int, int, int]  # (#id, .class, tag) counts
    order: int
    props: dict[str, str]


def _specificity(sel: str) -> tuple[int, int, int]:
    ids = sel.count("#")
    classes = sel.count(".") + sel.count(":")
    tags = len([p for p in re.split(r"[\s>.#:]+", sel) if p and not p.startswith((".", "#"))])
    return (ids, classes, tags)


def parse_rcss(text: str) -> list[Rule]:
    """Parse an RCSS sheet into cascade-ordered rules. Supports comments,
    grouped selectors (`a, b { … }`), descendant combinators, and the
    `:hover` / `:active` pseudo-classes."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    rules: list[Rule] = []
    order = 0
    for m in re.finditer(r"([^{}]+)\{([^}]*)\}", text):
        sels, body = m.group(1), m.group(2)
        props: dict[str, str] = {}
        for decl in body.split(";"):
            if ":" in decl:
                k, v = decl.split(":", 1)
                props[k.strip()] = v.strip()
        for sel in sels.split(","):
            sel = " ".join(sel.split())
            if sel:
                rules.append(Rule(sel, _specificity(sel), order, dict(props)))
                order += 1
    return rules


def _simple_matches(part: str, el: "Element", pseudo: set[str]) -> bool:
    # split a compound selector like div.menu#main:hover into pieces
    m = re.match(r"^([a-zA-Z*][\w-]*)?((?:[.#:][\w-]+)*)$", part)
    if not m:
        return False
    tag, rest = m.group(1), m.group(2) or ""
    if tag and tag != "*" and tag != el.tag:
        return False
    for piece in re.findall(r"[.#:][\w-]+", rest):
        if piece[0] == ".":
            if piece[1:] not in el.classes:
                return False
        elif piece[0] == "#":
            if el.id != piece[1:]:
                return False
        else:  # pseudo-class
            if piece[1:] not in pseudo:
                return False
    return True


def selector_matches(sel: str, el: "Element", pseudo: set[str]) -> bool:
    """Descendant-combinator matching, rightmost-first (CSS semantics)."""
    parts = sel.split()
    if not parts:
        return False
    if not _simple_matches(parts[-1], el, pseudo):
        return False
    node = el.parent
    i = len(parts) - 2
    while i >= 0:
        while node is not None and not _simple_matches(parts[i], node, set()):
            node = node.parent
        if node is None:
            return False
        node = node.parent
        i -= 1
    return True


_INHERITED = {"color", "font-size", "text-align"}

_DEFAULTS = {
    "display": "block",
    "color": "white",
    "background-color": "transparent",
    "width": "auto",
    "height": "auto",
    "padding": "0",
    "margin": "0",
    "font-size": "1",
    "text-align": "left",
}


# ---------------------------------------------------------------------------
# RML: document tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Element:
    tag: str
    id: str = ""
    classes: set[str] = dataclasses.field(default_factory=set)
    attrs: dict[str, str] = dataclasses.field(default_factory=dict)
    text: str = ""
    children: list["Element"] = dataclasses.field(default_factory=list)
    parent: "Element | None" = None
    # computed during style/layout
    style: dict[str, str] = dataclasses.field(default_factory=dict)
    box: tuple[float, float, float, float] = (0, 0, 0, 0)  # x y w h (border box)

    def find(self, id: str) -> "Element | None":
        if self.id == id:
            return self
        for c in self.children:
            got = c.find(id)
            if got is not None:
                return got
        return None


def parse_rml(text: str) -> Element:
    """Parse an RML document (XML) into the element tree. The conventional
    shape is `<rml><head>…</head><body>…</body></rml>`; the body element is
    returned as the root. Inline `<style>` blocks in head are collected onto
    `root.attrs['__styles__']`."""
    xml_root = ET.fromstring(text)
    styles: list[str] = []

    def convert(node: ET.Element, parent: Element | None) -> Element:
        cls = set((node.get("class") or "").split())
        el = Element(
            tag=node.tag,
            id=node.get("id") or "",
            classes=cls,
            attrs={k: v for k, v in node.attrib.items()},
            text=(node.text or "").strip(),
            parent=parent,
        )
        for child in node:
            if child.tag == "style":
                styles.append(child.text or "")
                continue
            el.children.append(convert(child, el))
            tail = (child.tail or "").strip()
            if tail:
                el.children.append(Element(tag="#text", text=tail, parent=el))
        return el

    if xml_root.tag == "rml":
        body = None
        for child in xml_root:
            if child.tag == "head":
                for sub in child:
                    if sub.tag == "style":
                        styles.append(sub.text or "")
            elif child.tag == "body":
                body = child
        root = convert(body if body is not None else xml_root, None)
    else:
        root = convert(xml_root, None)
    root.attrs["__styles__"] = "\n".join(styles)
    return root


# ---------------------------------------------------------------------------
# Style resolution + block layout
# ---------------------------------------------------------------------------

def _px(v: str, rel: float) -> float:
    v = v.strip()
    if v.endswith("%"):
        return float(v[:-1]) / 100.0 * rel
    if v.endswith("px"):
        v = v[:-2]
    try:
        return float(v)
    except ValueError:
        return 0.0


class RmlDocument:
    """One loaded document: markup + stylesheets + data model → layout → batch.

    The RmlUi analog of `Rml::ElementDocument`: `set_data`/`bind` drive the
    `{{ name }}` data bindings; `layout()` computes the block-model boxes;
    `emit()` writes panels/text into a `UIDocument` for the 2D raster path.
    """

    def __init__(self, rml: str, rcss: str = "", width: int = 1920, height: int = 1080):
        self.root = parse_rml(rml)
        self.rules = parse_rcss(self.root.attrs.get("__styles__", "") + "\n" + rcss)
        self.width = width
        self.height = height
        self.data: dict[str, Any] = {}
        self.handlers: dict[str, Callable[[Element], None]] = {}
        self.hover: Element | None = None
        self.active: Element | None = None
        self._dirty = True

    # -- data model ---------------------------------------------------------
    def set_data(self, **values: Any) -> None:
        self.data.update(values)
        self._dirty = True

    def bind(self, event_name: str, fn: Callable[[Element], None]) -> None:
        self.handlers[event_name] = fn

    def _interp(self, s: str) -> str:
        def sub(m):
            key = m.group(1).strip()
            cur: Any = self.data
            for part in key.split("."):
                if isinstance(cur, dict) and part in cur:
                    cur = cur[part]
                else:
                    return ""
            return str(cur)

        return re.sub(r"\{\{([^}]*)\}\}", sub, s)

    # -- style --------------------------------------------------------------
    def _computed(self, el: Element, inherited: dict[str, str]) -> dict[str, str]:
        pseudo = set()
        if el is self.hover:
            pseudo.add("hover")
        if el is self.active:
            pseudo.add("active")
        matched = [
            r for r in self.rules if selector_matches(r.selector, el, pseudo)
        ]
        matched.sort(key=lambda r: (r.specificity, r.order))
        style = dict(_DEFAULTS)
        for k in _INHERITED:
            if k in inherited:
                style[k] = inherited[k]
        for r in matched:
            style.update(r.props)
        if "style" in el.attrs:  # inline beats everything
            for decl in el.attrs["style"].split(";"):
                if ":" in decl:
                    k, v = decl.split(":", 1)
                    style[k.strip()] = v.strip()
        return style

    # -- layout -------------------------------------------------------------
    def layout(self) -> None:
        """Block layout: vertical flow, padding/margin boxes, px/% sizes,
        wrapped text runs measured with the bitmap font metrics."""
        self._lay(self.root, 0.0, 0.0, float(self.width), {})
        self._dirty = False

    def _lay(self, el: Element, x: float, y: float, avail_w: float, inherited: dict) -> float:
        el.style = st = self._computed(el, inherited)
        if st["display"] == "none":
            el.box = (x, y, 0.0, 0.0)
            return 0.0
        margin = _px(st["margin"], avail_w)
        pad = _px(st["padding"], avail_w)
        w = avail_w - 2 * margin if st["width"] == "auto" else _px(st["width"], avail_w)
        inner_w = max(w - 2 * pad, 0.0)
        cx = x + margin + pad
        cy = y + margin + pad

        child_inherit = {k: st[k] for k in _INHERITED}
        content_h = 0.0
        # text content first (wrapped at the font's glyph advance)
        text = self._interp(el.text) if el.text else ""
        el.attrs["__lines__"] = lines = []
        if text:
            scale = float(st.get("font-size", "1") or 1)
            max_chars = max(int(inner_w // (GLYPH_W * scale)), 1)
            for para in text.split("\n"):
                words, cur = para.split(), ""
                for word in words:
                    trial = (cur + " " + word).strip()
                    if len(trial) <= max_chars or not cur:
                        cur = trial
                    else:
                        lines.append(cur)
                        cur = word
                lines.append(cur)
            content_h += len(lines) * GLYPH_H * scale
        child_y = cy + content_h
        for c in el.children:
            used = self._lay(c, cx, child_y, inner_w, child_inherit)
            child_y += used
            content_h += used
        h = content_h + 2 * pad if st["height"] == "auto" else _px(st["height"], self.height)
        el.box = (x + margin, y + margin, w, h)
        return h + 2 * margin

    # -- input --------------------------------------------------------------
    def _hit(self, el: Element, mx: float, my: float) -> Element | None:
        if el.style.get("display") == "none":
            return None
        bx, by, bw, bh = el.box
        inside = bx <= mx < bx + bw and by <= my < by + bh
        # children are on top (later in paint order)
        for c in reversed(el.children):
            got = self._hit(c, mx, my)
            if got is not None:
                return got
        if inside and el.tag != "#text":
            return el
        return None

    def process_mouse(self, mx: float, my: float, down: bool) -> Element | None:
        """Hover/active tracking + onclick dispatch (fires on release inside,
        like RmlUi). Returns the clicked element, if any."""
        if self._dirty:
            self.layout()
        target = self._hit(self.root, mx, my)
        if target is not self.hover:
            self.hover = target
            self._dirty = True
        clicked = None
        if down and self.active is None and target is not None:
            self.active = target
            self._dirty = True
        elif not down and self.active is not None:
            if target is self.active:
                clicked = target
                name = target.attrs.get("onclick", "")
                if name and name in self.handlers:
                    self.handlers[name](target)
            self.active = None
            self._dirty = True
        return clicked

    # -- paint --------------------------------------------------------------
    def emit(self, doc: UIDocument) -> None:
        """Emit the laid-out document into a UIDocument sprite batch."""
        if self._dirty:
            self.layout()
        self._paint(self.root, doc)

    def _paint(self, el: Element, doc: UIDocument) -> None:
        st = el.style
        if st.get("display") == "none":
            return
        bx, by, bw, bh = el.box
        bg = parse_color(st.get("background-color", "transparent"))
        if bg[3] > 0 and bw > 0 and bh > 0:
            doc.add_panel(bx, by, bw, bh, color=bg)
        lines = el.attrs.get("__lines__") or []
        if lines:
            scale = float(st.get("font-size", "1") or 1)
            color = parse_color(st.get("color", "white"))
            pad = _px(st.get("padding", "0"), bw)
            for i, line in enumerate(lines):
                lw = len(line) * GLYPH_W * scale
                if st.get("text-align") == "center":
                    tx = bx + (bw - lw) / 2
                elif st.get("text-align") == "right":
                    tx = bx + bw - pad - lw
                else:
                    tx = bx + pad
                doc.add_text(tx, by + pad + i * GLYPH_H * scale, line, color=color, scale=scale)
        for c in el.children:
            self._paint(c, doc)


# ---------------------------------------------------------------------------
# Views + module (input routing — RmlUI.cpp:60-180 semantics)
# ---------------------------------------------------------------------------

class RmlView:
    """One document context + its viewport placement on the window
    (`RmlView.cpp`: one per Scene; registers itself with the module)."""

    def __init__(self, name: str, document: RmlDocument, ui: "RmlUIModule | None" = None):
        self.name = name
        self.document = document
        self.viewport_origin = (0.0, 0.0)
        self.viewport_size = (float(document.width), float(document.height))
        self.keyboard_focused = False
        self._ui = ui
        if ui is not None:
            ui.register_view(self)

    def close(self) -> None:
        if self._ui is not None:
            self._ui.unregister_view(self)
            self._ui = None

    def set_viewport(self, origin, size, keyboard_focused: bool = False) -> None:
        self.viewport_origin = (float(origin[0]), float(origin[1]))
        self.viewport_size = (float(size[0]), float(size[1]))
        self.keyboard_focused = keyboard_focused

    def contains(self, x: float, y: float) -> bool:
        ox, oy = self.viewport_origin
        w, h = self.viewport_size
        return ox <= x < ox + w and oy <= y < oy + h

    def to_local(self, x: float, y: float) -> tuple[float, float]:
        # scale window coords into context space (viewport may be letterboxed)
        ox, oy = self.viewport_origin
        w, h = self.viewport_size
        sx = self.document.width / max(w, 1e-6)
        sy = self.document.height / max(h, 1e-6)
        return (x - ox) * sx, (y - oy) * sy

    def update(self, surface_size: tuple[int, int] | None = None) -> UIDocument:
        """Collect this frame's geometry (RmlView::update): returns the filled
        UIDocument; composite/batch it through the engine's 2D path."""
        if surface_size is not None:
            self.document.width, self.document.height = surface_size
            self.document._dirty = True
        out = UIDocument(self.document.width, self.document.height)
        self.document.emit(out)
        return out


class RmlUIModule:
    """Module: owns the view registry and routes window input — mouse follows
    the cursor, keyboard follows the focused view, and while a button is held
    the press target keeps the mouse (capture), so dragging past the view's
    edge still delivers the release (`RmlUI.hpp:47-50`)."""

    MODULE_NAME = "RmlUI"
    module_dependencies = ("Input",)

    def __init__(self) -> None:
        self.views: list[RmlView] = []
        self.hovered_view: RmlView | None = None
        self.capture_view: RmlView | None = None
        self.last_mouse: tuple[float, float] = (0.0, 0.0)
        self.held = False

    def init(self, app=None) -> None: ...

    def deinit(self, app=None) -> None:
        self.views.clear()
        self.hovered_view = self.capture_view = None

    def register_view(self, view: RmlView) -> None:
        if view not in self.views:
            self.views.append(view)

    def unregister_view(self, view: RmlView) -> None:
        if view in self.views:
            self.views.remove(view)
        if self.hovered_view is view:
            self.hovered_view = None
        if self.capture_view is view:
            self.capture_view = None

    def _view_at(self, x: float, y: float) -> RmlView | None:
        for v in reversed(self.views):  # later-registered views are on top
            if v.contains(x, y):
                return v
        return None

    def process_mouse_move(self, x: float, y: float) -> None:
        self.last_mouse = (x, y)
        target = self.capture_view or self._view_at(x, y)
        if target is not self.hovered_view and self.hovered_view is not None:
            # leave: clear the old view's hover state
            self.hovered_view.document.process_mouse(-1e9, -1e9, self.held)
        self.hovered_view = target
        if target is not None:
            lx, ly = target.to_local(x, y)
            target.document.process_mouse(lx, ly, self.held)

    def process_mouse_button(self, down: bool) -> Element | None:
        x, y = self.last_mouse
        self.held = down
        if down:
            self.capture_view = self._view_at(x, y)
        target = self.capture_view
        clicked = None
        if target is not None:
            lx, ly = target.to_local(x, y)
            clicked = target.document.process_mouse(lx, ly, down)
        if not down:
            self.capture_view = None
        return clicked

    def keyboard_view(self) -> RmlView | None:
        for v in self.views:
            if v.keyboard_focused:
                return v
        return None
