"""Debug renderer: line/triangle/shape accumulation + device line raster
(counterpart of `oxylus_tpu/render/debugdraw.py`).

The reference `DebugRenderer` (`Oxylus/include/Render/DebugRenderer.hpp:20-53`, cap 10k
lines): per-frame queues of lines, triangles, AABBs, spheres, frustra, capsules that the
debug pass draws over the frame. Here shapes accumulate host-side into fixed-capacity
NumPy arrays, and `rasterize_over` samples every line at 256 points on the image's device
and writes them with one scatter-max (`index_reduce_(..., "amax")`, order-independent,
so deterministic), giving the JAX package's image bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.setup3d import _dot4_pairwise

Tensor = torch.Tensor

MAX_LINES = 10_000  # DebugRenderer.hpp:32-34

# the largest float32 below 2^31: the float → int32 cast saturates to it
_I32_MAX_F32 = 2147483520.0


def line_samples(max_steps: int, device=None) -> Tensor:
    """`jnp.linspace(0, 1, max_steps)` bit for bit: XLA divides the iota by
    `max_steps - 1` as a product with its float32 reciprocal, and ends on 1.0."""
    if max_steps == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    div = max_steps - 1
    t = torch.arange(div, dtype=torch.float32, device=device) * torch.tensor(1.0 / div, dtype=torch.float32)
    return torch.cat([t, torch.ones(1, dtype=torch.float32, device=device)])


def to_int32_saturating(x: Tensor) -> Tensor:
    """float32 → int32 truncating toward zero. Out-of-range values (and NaN, as 0)
    are clamped in float first, so the CPU, the card and XLA agree on them; every
    value already in the int32 range keeps its truncation."""
    x = torch.nan_to_num(x, nan=0.0, posinf=_I32_MAX_F32, neginf=-(2.0**31))
    return torch.clamp(x, -(2.0**31), _I32_MAX_F32).to(torch.int32)


def _project(view_proj: Tensor, p: Tensor) -> Tensor:
    """(N, 3) points → (N, 4) clip coordinates, `einsum("ij,nj->ni")` with the
    four products summed pairwise, as XLA's CPU einsum (and the triangle setup)."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    return _dot4_pairwise(view_proj[None, :, :], ph[:, None, :])


class DebugRenderer:
    MODULE_NAME = "DebugRenderer"

    def __init__(self, capacity: int = MAX_LINES):
        self.capacity = capacity
        self._a = np.zeros((capacity, 3), np.float32)
        self._b = np.zeros((capacity, 3), np.float32)
        self._color = np.zeros((capacity, 3), np.float32)
        self._count = 0

    def init(self, app=None) -> None: ...
    def deinit(self, app=None) -> None: ...

    def reset(self) -> None:
        self._count = 0

    # ------------------------------------------------------------- shapes
    def draw_line(self, a, b, color=(0.0, 1.0, 0.0)) -> None:
        if self._count >= self.capacity:
            return
        i = self._count
        self._a[i] = a
        self._b[i] = b
        self._color[i] = color
        self._count += 1

    def draw_aabb(self, bmin, bmax, color=(0.0, 1.0, 0.0)) -> None:
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        xs = [bmin[0], bmax[0]]
        ys = [bmin[1], bmax[1]]
        zs = [bmin[2], bmax[2]]
        corners = np.array([[x, y, z] for x in xs for y in ys for z in zs], np.float32)
        edges = [
            (0, 1), (2, 3), (4, 5), (6, 7),  # z edges
            (0, 2), (1, 3), (4, 6), (5, 7),  # y edges
            (0, 4), (1, 5), (2, 6), (3, 7),  # x edges
        ]
        for i, j in edges:
            self.draw_line(corners[i], corners[j], color)

    def draw_sphere(self, center, radius, color=(0.0, 1.0, 0.0), segments: int = 16) -> None:
        center = np.asarray(center, np.float32)
        t = np.linspace(0, 2 * np.pi, segments + 1)
        for axis in range(3):
            u = np.zeros((len(t), 3), np.float32)
            i, j = (axis + 1) % 3, (axis + 2) % 3
            u[:, i] = np.cos(t) * radius
            u[:, j] = np.sin(t) * radius
            pts = center + u
            for k in range(segments):
                self.draw_line(pts[k], pts[k + 1], color)

    def draw_frustum(self, inv_view_proj, color=(1.0, 1.0, 0.0)) -> None:
        ndc = np.array(
            [[x, y, z, 1.0] for z in (0.001, 1.0) for y in (-1, 1) for x in (-1, 1)], np.float32
        )  # reverse-Z: both planes covered
        if isinstance(inv_view_proj, torch.Tensor):
            inv_view_proj = inv_view_proj.detach().cpu().numpy()
        world = (np.asarray(inv_view_proj) @ ndc.T).T
        world = world[:, :3] / world[:, 3:4]
        edges = [(0, 1), (1, 3), (3, 2), (2, 0), (4, 5), (5, 7), (7, 6), (6, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
        for i, j in edges:
            self.draw_line(world[i], world[j], color)

    # ------------------------------------------------------------- raster
    def rasterize_over(self, image: Tensor, view_proj: Tensor, max_steps: int = 256) -> Tensor:
        """Overlay all queued lines on `image` (H, W, 3) via sampled line drawing,
        on the image's device; returns a new image."""
        if self._count == 0:
            return image
        h, w = image.shape[:2]
        n = self._count
        dev = image.device
        lines = torch.from_numpy(np.concatenate([self._a[:n], self._b[:n], self._color[:n]], 1)).to(dev)
        a, b, col = lines[:, 0:3], lines[:, 3:6], lines[:, 6:9]
        view_proj = view_proj.to(device=dev, dtype=torch.float32)

        def project(p):
            clip = _project(view_proj, p)
            wc = clip[..., 3]
            ok = wc > 1e-6
            ndc = clip[..., :2] / torch.clamp(torch.abs(wc), min=1e-6)[..., None]
            sx = (ndc[..., 0] * 0.5 + 0.5) * w
            sy = (ndc[..., 1] * 0.5 + 0.5) * h
            return sx, sy, ok

        ax, ay, aok = project(a)
        bx, by, bok = project(b)
        ok = aok & bok
        t = line_samples(max_steps, dev)[None, :]  # (1, S)
        px = to_int32_saturating(ax[:, None] + (bx - ax)[:, None] * t)  # (N, S)
        py = to_int32_saturating(ay[:, None] + (by - ay)[:, None] * t)
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h) & ok[:, None]
        px = torch.clamp(px, 0, w - 1)
        py = torch.clamp(py, 0, h - 1)
        flat = (py.to(torch.int64) * w + px).reshape(-1)
        colors = torch.broadcast_to(col[:, None, :], (n, max_steps, 3)).reshape(-1, 3)
        src = torch.where(inside.reshape(-1, 1), colors, -1.0)
        out = image.reshape(-1, 3).clone()
        out.index_reduce_(0, flat, src.to(out.dtype), "amax", include_self=True)
        return out.reshape(h, w, 3)
