"""Transform gizmo math (the ImGuizmo role, headless; counterpart of
`oxylus_tpu/editor/gizmo.py`).

The reference viewport manipulates the selected entity's transform with ImGuizmo
(`OxylusEditor/src/Panels/ViewportPanel.cpp`: translate / rotate /
scale ops, local/world modes, snapping). Here the same interaction is pure math on
camera rays: `pick_gizmo_axis` hit-tests the axis handles under a pixel,
`gizmo_drag` converts a pixel drag into a transform delta. A frontend (or a test)
drives it with pixel coordinates; the engine applies results through
EditorContext.set_field so edits are undoable. The math is a few scalars, so it
runs in NumPy on the host: a camera whose vectors are tensors (the port's
`CameraMatrices`, on the card or the CPU) is read in one host copy.
"""

from __future__ import annotations

import enum
from types import SimpleNamespace

import numpy as np
import torch


class GizmoOp(enum.Enum):
    TRANSLATE = 0
    ROTATE = 1
    SCALE = 2


class GizmoMode(enum.Enum):
    LOCAL = 0
    WORLD = 1


_AXES = np.eye(3, dtype=np.float32)


def host_camera(camera) -> SimpleNamespace:
    """The camera's position and basis as host float32 arrays. Tensors are
    stacked and copied to the host once; anything else goes through NumPy.
    `fov_deg` is kept only where the camera has one: neither package's
    `CameraMatrices` carries it, so `camera_ray` casts every such ray at 60°."""
    vecs = (camera.position, camera.forward, camera.right, camera.up)
    if isinstance(camera.position, torch.Tensor):
        pos, fwd, right, up = torch.stack([v.to(torch.float32) for v in vecs]).cpu().numpy()
    else:
        pos, fwd, right, up = (np.asarray(v, np.float32) for v in vecs)
    out = SimpleNamespace(position=pos, forward=fwd, right=right, up=up)
    if hasattr(camera, "fov_deg"):
        out.fov_deg = camera.fov_deg
    return out


def camera_ray(camera, px: float, py: float, width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """World-space ray through a pixel center (origin, direction)."""
    camera = host_camera(camera)
    ndc_x = (px + 0.5) / width * 2.0 - 1.0
    ndc_y = (py + 0.5) / height * 2.0 - 1.0
    fwd = np.asarray(camera.forward, np.float32)
    right = np.asarray(camera.right, np.float32)
    up = np.asarray(camera.up, np.float32)
    tan_half = float(np.tan(np.radians(float(getattr(camera, "fov_deg", 60.0))) / 2.0))
    aspect = width / height
    d = fwd + right * (ndc_x * tan_half * aspect) - up * (ndc_y * tan_half)
    d = d / max(np.linalg.norm(d), 1e-9)
    return np.asarray(camera.position, np.float32), d


def _axis_dirs(rotation_quat, mode: GizmoMode) -> np.ndarray:
    if mode == GizmoMode.WORLD or rotation_quat is None:
        return _AXES
    x, y, z, w = [float(v) for v in rotation_quat]
    r = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    return r.T  # rows = world-space axis directions


def _ray_segment_distance(ro, rd, a, b) -> float:
    """Min distance between a ray and a segment (handle hit test)."""
    u = rd
    v = b - a
    w0 = ro - a
    aa = u @ u
    bb = u @ v
    cc = v @ v
    dd = u @ w0
    ee = v @ w0
    den = aa * cc - bb * bb
    if abs(den) < 1e-9:
        s, t = 0.0, np.clip(ee / max(cc, 1e-9), 0.0, 1.0)
    else:
        s = max((bb * ee - cc * dd) / den, 0.0)
        t = np.clip((aa * ee - bb * dd) / den, 0.0, 1.0)
    p = ro + u * s
    q = a + v * t
    return float(np.linalg.norm(p - q))


def pick_gizmo_axis(
    camera, px: float, py: float, width: int, height: int,
    position, rotation_quat=None,
    mode: GizmoMode = GizmoMode.WORLD,
    handle_length: float = 1.0,
    pick_radius: float = 0.15,
) -> int:
    """Which axis handle (0=X 1=Y 2=Z, -1 none) is under the pixel."""
    camera = host_camera(camera)
    ro, rd = camera_ray(camera, px, py, width, height)
    pos = np.asarray(position, np.float32)
    # scale handles with distance so picking feels constant-size on screen
    dist = float(np.linalg.norm(pos - ro))
    scale = max(dist * 0.2, 1e-3) * handle_length
    axes = _axis_dirs(rotation_quat, mode)
    best, best_d = -1, pick_radius * scale
    for i in range(3):
        d = _ray_segment_distance(ro, rd, pos, pos + axes[i] * scale)
        if d < best_d:
            best, best_d = i, d
    return best


def gizmo_drag(
    camera,
    op: GizmoOp,
    axis: int,
    p0: tuple[float, float],
    p1: tuple[float, float],
    width: int,
    height: int,
    position,
    rotation_quat=None,
    scale=None,
    mode: GizmoMode = GizmoMode.WORLD,
    snap: float = 0.0,
) -> dict:
    """Convert a pixel drag (p0 → p1) into a transform update.

    Returns {"position"| "rotation"| "scale": new value} for the edited channel.
    Translate/scale project the drag onto the axis line; rotate maps the drag to
    an angle around the axis (trackball-on-axis, ImGuizmo behavior).
    """
    camera = host_camera(camera)
    pos = np.asarray(position, np.float32)
    axes = _axis_dirs(rotation_quat, mode)
    ax = axes[axis]
    ro0, rd0 = camera_ray(camera, p0[0], p0[1], width, height)
    ro1, rd1 = camera_ray(camera, p1[0], p1[1], width, height)

    def closest_t_on_axis(ro, rd):
        """Parameter along the axis line closest to the pixel ray (Ericson 5.1.8:
        t = (b·e − c·d)/(a·c − b²) for lines P(t)=pos+t·u, Q(s)=ro+s·v)."""
        u = ax
        v = rd
        w0 = pos - ro
        aa = u @ u
        bb = u @ v
        cc = v @ v
        dd = u @ w0
        ee = v @ w0
        den = aa * cc - bb * bb
        if abs(den) < 1e-9:
            return 0.0
        return float((bb * ee - cc * dd) / den)

    t0 = closest_t_on_axis(ro0, rd0)
    t1 = closest_t_on_axis(ro1, rd1)
    delta = t1 - t0

    if op == GizmoOp.TRANSLATE:
        if snap > 0.0:
            delta = round(delta / snap) * snap
        return {"position": (pos + ax * delta).tolist()}

    if op == GizmoOp.SCALE:
        s = np.asarray(scale if scale is not None else (1.0, 1.0, 1.0), np.float32)
        factor = 1.0 + delta
        if snap > 0.0:
            factor = max(round(factor / snap) * snap, snap)
        new = s.copy()
        new[axis] = max(s[axis] * factor, 1e-4)
        return {"scale": new.tolist()}

    # ROTATE: pixel-drag angle around the axis (screen-space arc length heuristic)
    drag = (p1[0] - p0[0]) + (p1[1] - p0[1])
    angle = drag * 0.01
    if snap > 0.0:
        snap_rad = np.radians(snap)
        angle = round(angle / snap_rad) * snap_rad
    half = angle / 2.0
    dq = np.array([*(ax * np.sin(half)), np.cos(half)], np.float32)  # xyzw
    q = np.asarray(rotation_quat if rotation_quat is not None else (0, 0, 0, 1), np.float32)
    x1, y1, z1, w1 = dq
    x2, y2, z2, w2 = q
    out = np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        np.float32,
    )
    out = out / max(np.linalg.norm(out), 1e-9)
    return {"rotation": out.tolist()}
