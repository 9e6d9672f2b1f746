"""Screen-ray + visbuffer mouse picking (counterpart of `oxylus_tpu/render/picking.py`).

Reference: `Camera::get_screen_ray` (`Oxylus/src/Render/Camera.cpp:78+`) and the
editor's viewport picking, which reads the entity id from the 2D/3D id targets.
Here both styles exist:
- `screen_ray`: unproject a pixel into a world ray (for physics ray casts / gizmos);
- `pick_entity_*`: O(1) lookup in the id buffers the rasterizers already produce
  (2D path emits entity ids; 3D path's visbuffer resolves through the meshlet tables).
Every function runs on its tensors' device.
"""

from __future__ import annotations

import torch

from ..physics.step import shape_local_halfbox
from ..utils import math3d

Tensor = torch.Tensor


def screen_ray(camera, x: float, y: float, width: int, height: int) -> tuple[Tensor, Tensor]:
    """Pixel → (origin, direction) world-space ray."""
    ndc_x = (x + 0.5) / width * 2.0 - 1.0
    ndc_y = (y + 0.5) / height * 2.0 - 1.0
    inv_vp = math3d.mat4_inverse(camera.view_projection)
    dev = inv_vp.device
    # reverse-Z: near plane at ndc z = 1
    near_h = inv_vp @ torch.tensor([ndc_x, ndc_y, 1.0, 1.0], dtype=torch.float32, device=dev)
    far_h = inv_vp @ torch.tensor([ndc_x, ndc_y, 1e-4, 1.0], dtype=torch.float32, device=dev)
    near = near_h[:3] / near_h[3]
    far = far_h[:3] / far_h[3]
    direction = far - near
    direction = direction / torch.clamp(torch.linalg.norm(direction), min=1e-9)
    return near, direction


def _pixel(shape, x, y) -> tuple[int, int]:
    h, w = shape
    return min(max(int(y), 0), h - 1), min(max(int(x), 0), w - 1)


def pick_entity_2d(visbuffer: Tensor, x: int, y: int) -> Tensor:
    """Entity id at a pixel of the 2D id buffer (-1 = none)."""
    return visbuffer[_pixel(visbuffer.shape, x, y)]


def pick_entity_3d(
    visbuffer: Tensor, vm_instance: Tensor, gscene, x: int, y: int,
    slot_instance: Tensor | None = None,
    slot_group: int = 64,
) -> Tensor:
    """Entity id at a pixel of the 3D visbuffer: id → vm slot → instance → entity.
    `slot_instance` (VM·64,) resolves ids from the dense-compacted raster path
    (renderer ctx["slot_instance"]); without it ids are meshlet-relative."""
    pid = visbuffer[_pixel(visbuffer.shape, x, y)].to(torch.int64)
    pos = torch.clamp(pid, min=0)
    vm_slot = pos >> 8
    if slot_instance is not None:
        flat = torch.clamp(vm_slot * slot_group + (pos & 255), 0, slot_instance.shape[0] - 1)
        inst = slot_instance[flat]
    else:
        inst = vm_instance[vm_slot]
    entity = gscene.inst_entity[inst.to(torch.int64)]
    return torch.where(pid >= 0, entity, torch.full_like(entity, -1))


def cast_ray_bodies(ps, origin: Tensor, direction: Tensor, max_dist: float = 1000.0):
    """Physics ray cast against all body AABBs (`Scene::cast_ray` analog,
    `Scene.cpp:1323-1332` — the reference casts into the Jolt broadphase).
    Returns (body_index or -1, distance)."""
    rot = math3d.quat_to_mat3(ps.quat)
    center = ps.pos + torch.einsum("bij,bj->bi", rot, ps.offset)
    half = torch.einsum("bij,bj->bi", torch.abs(rot), shape_local_halfbox(ps))
    bmin = center - half
    bmax = center + half

    inv_d = 1.0 / torch.where(torch.abs(direction) > 1e-9, direction, torch.full_like(direction, 1e-9))
    t0 = (bmin - origin[None, :]) * inv_d[None, :]
    t1 = (bmax - origin[None, :]) * inv_d[None, :]
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & ps.active & (tmin < max_dist)
    dist = torch.where(hit, torch.clamp(tmin, min=0.0), torch.full_like(tmin, float("inf")))
    best = torch.argmin(dist)
    found = torch.isfinite(dist[best])
    return (torch.where(found, best, torch.full_like(best, -1)),
            torch.where(found, dist[best], torch.full_like(dist[best], max_dist)))
