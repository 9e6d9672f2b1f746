"""Editor panels as data (the reference's ImGui panels, headless; counterpart of
`oxylus_tpu/editor/panels.py`).

Each panel's `build()` produces a plain structure a frontend renders; mutations go
back through EditorContext so they hit the undo stack. Reference:
`OxylusEditor/src/Panels/SceneHierarchyPanel.cpp` (entity tree +
drag-reparent), `InspectorPanel.cpp` (per-component field editors),
`ViewportPanel.cpp` (picking + gizmo + play toolbar).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..scene import components as C
from .context import EditorContext
from .gizmo import GizmoMode, GizmoOp, gizmo_drag, pick_gizmo_axis


@dataclasses.dataclass
class HierarchyNode:
    entity: int
    name: str
    selected: bool
    children: list["HierarchyNode"]


class SceneHierarchyPanel:
    def __init__(self, ctx: EditorContext):
        self.ctx = ctx

    def build(self) -> list[HierarchyNode]:
        sc = self.ctx.scene
        kids: dict[int, list[int]] = {}
        roots: list[int] = []
        n = sc._alive.shape[0]
        for i in range(n):
            if not sc._alive[i]:
                continue
            p = int(sc._parent[i])
            if p < 0:
                roots.append(i)
            else:
                kids.setdefault(p, []).append(i)

        def node(i: int) -> HierarchyNode:
            return HierarchyNode(
                entity=i,
                name=sc._names[i],
                selected=i in self.ctx.selection,
                children=[node(c) for c in kids.get(i, [])],
            )

        return [node(r) for r in roots]

    def reparent(self, entity: int, new_parent: int | None) -> None:
        self.ctx.scene.set_parent(entity, -1 if new_parent is None else new_parent)

    def rename(self, entity: int, name: str) -> None:
        self.ctx.scene._names[entity] = name


@dataclasses.dataclass
class FieldView:
    name: str
    kind: str       # "float" | "int" | "bool" | "vec" | "enum" | "uuid" | "string"
    value: Any
    enum_values: tuple[str, ...] | None = None


@dataclasses.dataclass
class ComponentView:
    name: str
    fields: list[FieldView]


class InspectorPanel:
    def __init__(self, ctx: EditorContext):
        self.ctx = ctx

    def build(self, entity: int | None = None) -> list[ComponentView]:
        sc = self.ctx.scene
        if entity is None:
            if not self.ctx.selection:
                return []
            entity = self.ctx.selection[0]
        views = []
        for cdef in C.COMPONENTS:
            if cdef.tag or not sc._comp_mask.get(cdef.name, np.zeros(1, bool))[entity]:
                continue
            fields = []
            for f in cdef.fields:
                v = sc.get_field(entity, cdef.name, f.name)
                kind = f.kind.name.lower()
                fields.append(
                    FieldView(
                        name=f.name,
                        kind=kind,
                        value=v.tolist() if hasattr(v, "tolist") else v,
                        enum_values=tuple(f.enum_values) if f.enum_values else None,
                    )
                )
            views.append(ComponentView(name=cdef.name, fields=fields))
        return views

    def edit(self, entity: int, component: str, field: str, value) -> None:
        self.ctx.set_field(entity, component, field, value)

    def add_component(self, entity: int, component: str, **fields) -> None:
        from ..scene.scene import Entity

        Entity(self.ctx.scene, entity).add(component, **fields)

    def remove_component(self, entity: int, component: str) -> None:
        from ..scene.scene import Entity

        Entity(self.ctx.scene, entity).remove(component)


class ViewportPanel:
    """Picking + gizmo interaction against a rendered frame.

    `pick(x, y)` reads one pixel of the renderer's entity-id image on that image's
    device (the reference's one-pixel GPU readback); gizmo methods mutate the
    selected entity's TransformComponent through the undo stack."""

    def __init__(self, ctx: EditorContext, width: int = 1920, height: int = 1080):
        self.ctx = ctx
        self.width = width
        self.height = height
        self.gizmo_op = GizmoOp.TRANSLATE
        self.gizmo_mode = GizmoMode.WORLD
        self.snap = 0.0

    def pick(self, visbuffer, x: int, y: int) -> int:
        """Select the entity at pixel (x, y), with NumPy's index rules: negative
        indices wrap, out-of-range ones raise `IndexError`."""
        if isinstance(visbuffer, torch.Tensor):
            eid = int(visbuffer[int(y), int(x)].item())
        else:
            eid = int(np.asarray(visbuffer)[int(y), int(x)])
        self.ctx.select(eid)
        return eid

    def _transform(self, entity: int):
        sc = self.ctx.scene
        return (
            sc.get_field(entity, "TransformComponent", "position"),
            sc.get_field(entity, "TransformComponent", "rotation"),
            sc.get_field(entity, "TransformComponent", "scale"),
        )

    def pick_axis(self, camera, x: float, y: float) -> int:
        if not self.ctx.selection:
            return -1
        pos, rot, _ = self._transform(self.ctx.selection[0])
        return pick_gizmo_axis(
            camera, x, y, self.width, self.height, pos, rot, self.gizmo_mode
        )

    def drag(self, camera, axis: int, p0, p1) -> dict:
        if not self.ctx.selection:
            return {}
        e = self.ctx.selection[0]
        pos, rot, scale = self._transform(e)
        upd = gizmo_drag(
            camera, self.gizmo_op, axis, p0, p1, self.width, self.height,
            pos, rot, scale, self.gizmo_mode, self.snap,
        )
        for field, value in upd.items():
            self.ctx.set_field(e, "TransformComponent", field, value)
        return upd


# ---------------------------------------------------------------------------
# Content browser + thumbnails (`OxylusEditor/src/Panels/ContentPanel.cpp`)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ContentEntry:
    """One row/tile of the content browser."""

    name: str
    path: str
    is_dir: bool
    asset_type: str          # AssetType name, "NONE" for unknown files
    uuid: str | None = None  # registered asset UUID (from .oxasset sidecar)


class ContentPanel:
    """Directory-browsing panel over the project's asset tree (reference
    `ContentPanel.cpp`): typed entries via the AssetManager's extension map and
    `.oxasset` sidecars, breadcrumb navigation, and cached thumbnails
    (the reference renders thumbnails into a texture cache; here they are small
    RGBA arrays a frontend can blit)."""

    THUMB = 64

    def __init__(self, ctx: EditorContext, root: str, asset_manager=None):
        import os

        self.ctx = ctx
        self.root = os.path.abspath(root)
        self.current = self.root
        self.assets = asset_manager
        self._thumbs: dict[str, Any] = {}

    # -- navigation ---------------------------------------------------------
    def navigate(self, path: str) -> None:
        import os

        p = os.path.abspath(path)
        if os.path.commonpath([p, self.root]) != self.root:
            raise ValueError("content browser cannot leave the project root")
        if os.path.isdir(p):
            self.current = p

    def go_up(self) -> None:
        import os

        if self.current != self.root:
            self.navigate(os.path.dirname(self.current))

    def breadcrumbs(self) -> list[str]:
        import os

        rel = os.path.relpath(self.current, self.root)
        return [os.path.basename(self.root)] + ([] if rel == "." else rel.split(os.sep))

    # -- listing ------------------------------------------------------------
    def build(self) -> list[ContentEntry]:
        import json
        import os

        from ..assets.manager import _EXT_TYPES, AssetType

        entries: list[ContentEntry] = []
        try:
            names = sorted(os.listdir(self.current))
        except OSError:
            return entries
        for name in names:
            if name.endswith(".oxasset"):
                continue  # sidecars render as badges on their asset, not rows
            full = os.path.join(self.current, name)
            if os.path.isdir(full):
                entries.append(ContentEntry(name, full, True, "DIRECTORY"))
                continue
            ext = os.path.splitext(name)[1].lower()
            at = _EXT_TYPES.get(ext, AssetType.NONE)
            uuid = None
            side = full + ".oxasset"
            if os.path.exists(side):
                try:
                    uuid = json.load(open(side)).get("uuid")
                except Exception:
                    uuid = None
            entries.append(ContentEntry(name, full, False, at.name, uuid))
        # directories first, like the reference
        entries.sort(key=lambda e: (not e.is_dir, e.name.lower()))
        return entries

    # -- thumbnails ---------------------------------------------------------
    def thumbnail(self, path: str):
        """(THUMB, THUMB, 4) u8 RGBA preview, cached. Textures downsample the
        real image; other types get a flat type-color tile (the reference uses
        baked icons)."""
        if path in self._thumbs:
            return self._thumbs[path]
        import os

        import numpy as np_

        from ..assets.manager import _EXT_TYPES, AssetType

        size = self.THUMB
        ext = os.path.splitext(path)[1].lower()
        at = _EXT_TYPES.get(ext, AssetType.NONE)
        thumb = None
        if at == AssetType.TEXTURE:
            try:
                from ..assets.texture import Texture

                tex = Texture.load(path)
                img = np_.asarray(tex.pixels)
                ys = (np_.arange(size) * img.shape[0] // size).clip(0, img.shape[0] - 1)
                xs = (np_.arange(size) * img.shape[1] // size).clip(0, img.shape[1] - 1)
                thumb = img[ys][:, xs]
                if thumb.shape[-1] == 3:
                    thumb = np_.concatenate(
                        [thumb, np_.full(thumb.shape[:2] + (1,), 255, np_.uint8)], -1
                    )
            except Exception:
                thumb = None
        if thumb is None:
            colors = {
                AssetType.MODEL: (90, 140, 220, 255),
                AssetType.SCENE: (120, 200, 120, 255),
                AssetType.MATERIAL: (220, 140, 90, 255),
                AssetType.AUDIO: (200, 120, 200, 255),
                AssetType.SCRIPT: (230, 210, 100, 255),
            }
            c = colors.get(at, (128, 128, 128, 255))
            thumb = np_.tile(np_.array(c, np_.uint8), (size, size, 1))
        self._thumbs[path] = thumb
        return thumb

    def import_asset(self, path: str) -> str | None:
        """Create/refresh the `.oxasset` sidecar via the AssetManager."""
        if self.assets is None:
            return None
        return self.assets.import_asset(path)
