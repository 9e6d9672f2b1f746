"""Camera matrices from components (counterpart of `oxylus_tpu/render/camera.py`).

Yaw/pitch spherical forward basis, right-handed lookAt view, reversed-Z
perspective (far/near swapped) or the fixed ±100 ortho for 2D, Vulkan Y flip.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils import math3d

Tensor = torch.Tensor


@dataclasses.dataclass
class CameraMatrices:
    view: Tensor             # (4,4)
    projection: Tensor       # (4,4)
    position: Tensor         # (3,)
    forward: Tensor          # (3,)
    up: Tensor               # (3,)
    right: Tensor            # (3,)
    near: Tensor             # ()
    far: Tensor              # ()
    frustum_planes: Tensor   # (6,4)

    @property
    def view_projection(self) -> Tensor:
        return math3d.mat4_mul(self.projection, self.view)


def camera_matrices(position, yaw, pitch, tilt, fov_deg, near, far, zoom, projection_kind, aspect) -> CameraMatrices:
    cos_pitch = torch.cos(pitch)
    forward = torch.stack([torch.cos(yaw) * cos_pitch, torch.sin(pitch), torch.sin(yaw) * cos_pitch], dim=-1)
    forward = forward / torch.clamp(math3d._norm(forward), min=1e-9)
    tilt_up = torch.stack([tilt, torch.ones_like(tilt), tilt], dim=-1)
    right = torch.linalg.cross(forward, tilt_up)
    right = right / torch.clamp(math3d._norm(right), min=1e-9)
    up = torch.linalg.cross(right, forward)
    up = up / torch.clamp(math3d._norm(up), min=1e-9)

    view = math3d.look_at(position, position + forward, up)
    persp = math3d.perspective_reverse_z(fov_deg * (math.pi / 180.0), aspect, near, far)
    ortho = math3d.ortho_reverse_z(-aspect * zoom, aspect * zoom, -zoom, zoom, -100.0, 100.0, device=position.device)
    proj = torch.where(projection_kind == 0, persp, ortho)

    vp = math3d.mat4_mul(proj, view)
    return CameraMatrices(
        view=view, projection=proj, position=position, forward=forward, up=up, right=right,
        near=torch.as_tensor(near, dtype=torch.float32), far=torch.as_tensor(far, dtype=torch.float32),
        frustum_planes=math3d.frustum_planes_from_mat(vp),
    )


def camera_from_state(state, entity_index: int, aspect) -> CameraMatrices:
    """Matrices for the camera component on `entity_index` of a SceneState."""
    cam = state.comp["CameraComponent"]
    t = state.comp["TransformComponent"]
    i = entity_index
    aspect = torch.as_tensor(aspect, dtype=torch.float32, device=state.device)
    return camera_matrices(
        position=t["position"][i], yaw=cam["yaw"][i], pitch=cam["pitch"][i], tilt=cam["tilt"][i],
        fov_deg=cam["fov"][i], near=cam["near_clip"][i], far=cam["far_clip"][i], zoom=cam["zoom"][i],
        projection_kind=cam["projection"][i], aspect=aspect,
    )
