from .context import EditorContext, SceneStateKind
from .gizmo import GizmoMode, GizmoOp, gizmo_drag, pick_gizmo_axis
from .panels import InspectorPanel, SceneHierarchyPanel, ViewportPanel

__all__ = [
    "EditorContext",
    "SceneStateKind",
    "GizmoMode",
    "GizmoOp",
    "gizmo_drag",
    "pick_gizmo_axis",
    "InspectorPanel",
    "SceneHierarchyPanel",
    "ViewportPanel",
]
