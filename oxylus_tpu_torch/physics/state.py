"""Batched rigid-body physics state (counterpart of `oxylus_tpu/physics/state.py`).

All bodies live in fixed-capacity SoA tensors. Shape model: box → half extents;
sphere → capsule with half_length 0; capsule → segment + radius (axis local Y);
cylinder and tapered capsule as in the JAX module.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

Tensor = torch.Tensor

# body_type codes (match RigidBodyComponent::BodyType order)
BODY_STATIC = 0
BODY_KINEMATIC = 1
BODY_DYNAMIC = 2

# shape codes
SHAPE_BOX = 0
SHAPE_CAPSULE = 1
SHAPE_CYLINDER = 2
SHAPE_MESH = 3


@dataclasses.dataclass(frozen=True)
class PhysicsParams:
    """Solver configuration; defaults follow Jolt's PhysicsSettings as the JAX
    module does. Plain Python numbers: they only feed the kernel's scalar block."""

    gravity: tuple[float, float, float] = (0.0, -9.81, 0.0)
    baumgarte: float = 0.2
    penetration_slop: float = 0.02
    speculative_margin: float = 0.02
    restitution_threshold: float = 1.0
    sleep_velocity: float = 0.05
    sleep_time: float = 0.5
    velocity_iterations: int = 10
    max_pairs: int = 4096
    points_per_pair: int = 4
    comm: str = "matmul"
    allow_sleeping: bool = True


# field name → (per-body trailing shape, dtype) of every per-body tensor
BODY_FIELDS: dict[str, tuple[tuple[int, ...], torch.dtype]] = {
    "active": ((), torch.bool),
    "entity": ((), torch.int32),
    "body_type": ((), torch.int32),
    "shape_type": ((), torch.int32),
    "pos": ((3,), torch.float32),
    "quat": ((4,), torch.float32),
    "linvel": ((3,), torch.float32),
    "angvel": ((3,), torch.float32),
    "prev_pos": ((3,), torch.float32),
    "prev_quat": ((4,), torch.float32),
    "inv_mass": ((), torch.float32),
    "inv_inertia": ((3,), torch.float32),
    "half_extent": ((3,), torch.float32),
    "radius": ((), torch.float32),
    "radius2": ((), torch.float32),
    "half_length": ((), torch.float32),
    "offset": ((3,), torch.float32),
    "friction": ((), torch.float32),
    "restitution": ((), torch.float32),
    "gravity_factor": ((), torch.float32),
    "linear_drag": ((), torch.float32),
    "angular_drag": ((), torch.float32),
    "dof_mask_lin": ((3,), torch.float32),
    "dof_mask_ang": ((3,), torch.float32),
    "is_sensor": ((), torch.bool),
    "apply_gyro": ((), torch.bool),
    "is_character": ((), torch.bool),
    "ground_normal_y": ((), torch.float32),
    "parent": ((), torch.int32),
    "asleep": ((), torch.bool),
    "sleep_timer": ((), torch.float32),
}
MESH_FIELDS = ("mesh_tri", "mesh_grid", "mesh_grid_meta", "mesh_body")


@dataclasses.dataclass
class PhysicsState:
    # identity
    active: Tensor          # (B,) bool
    entity: Tensor          # (B,) i32 — owning entity slot, -1 if none
    body_type: Tensor       # (B,) i32
    shape_type: Tensor      # (B,) i32
    # pose & motion
    pos: Tensor             # (B, 3) f32
    quat: Tensor            # (B, 4) f32 xyzw
    linvel: Tensor          # (B, 3)
    angvel: Tensor          # (B, 3)
    prev_pos: Tensor        # (B, 3) pose at the previous fixed tick
    prev_quat: Tensor       # (B, 4)
    # mass
    inv_mass: Tensor        # (B,)
    inv_inertia: Tensor     # (B, 3) diagonal inverse inertia in body frame
    # shape
    half_extent: Tensor     # (B, 3) box half extents
    radius: Tensor          # (B,)
    radius2: Tensor         # (B,)
    half_length: Tensor     # (B,)
    offset: Tensor          # (B, 3) collider local offset
    # material / flags
    friction: Tensor
    restitution: Tensor
    gravity_factor: Tensor
    linear_drag: Tensor
    angular_drag: Tensor
    dof_mask_lin: Tensor    # (B, 3)
    dof_mask_ang: Tensor    # (B, 3)
    is_sensor: Tensor
    apply_gyro: Tensor
    is_character: Tensor
    ground_normal_y: Tensor
    parent: Tensor          # (B,) i32 — root body slot of a compound proxy, -1 otherwise
    asleep: Tensor          # (B,) bool
    sleep_timer: Tensor     # (B,) f32
    accumulator: Tensor     # () f32 fixed-step accumulator
    mesh_tri: Tensor | None = None
    mesh_grid: Tensor | None = None
    mesh_grid_meta: Tensor | None = None
    mesh_body: Tensor | None = None
    has_proxies: bool = False

    @property
    def num_slots(self) -> int:
        return self.active.shape[0]

    @property
    def device(self) -> torch.device:
        return self.active.device


def empty_physics_state(max_bodies: int, device: torch.device | str | None = None) -> PhysicsState:
    """The empty body table on `device` (the card unless the CPU is asked for)."""
    device = resolve_device(device)
    b = max_bodies
    fields = {}
    for name, (shape, dtype) in BODY_FIELDS.items():
        fields[name] = torch.zeros((b,) + shape, dtype=dtype, device=device)
    fields["entity"].fill_(-1)
    fields["parent"].fill_(-1)
    fields["quat"][:, 3] = 1.0
    fields["prev_quat"][:, 3] = 1.0
    fields["gravity_factor"].fill_(1.0)
    fields["dof_mask_lin"].fill_(1.0)
    fields["dof_mask_ang"].fill_(1.0)
    return PhysicsState(
        accumulator=torch.zeros((), dtype=torch.float32, device=device), **fields
    )


def box_inertia(mass, half) -> np.ndarray:
    """Solid-box diagonal inertia: (1/3) m (h_j² + h_k²). NumPy: host construction."""
    half = np.asarray(half)
    hx2, hy2, hz2 = half[..., 0] ** 2, half[..., 1] ** 2, half[..., 2] ** 2
    return (np.asarray(mass)[..., None] / 3.0) * np.stack(
        [hy2 + hz2, hx2 + hz2, hx2 + hy2], axis=-1
    )


def cylinder_inertia(mass, radius, half_length) -> np.ndarray:
    """Solid cylinder, axis local Y: Iy = ½mr², Ix = Iz = m(3r² + h²)/12."""
    r, h = np.asarray(radius), np.asarray(half_length) * 2.0
    mass = np.asarray(mass)
    iy = 0.5 * mass * r**2
    ix = mass * (3.0 * r**2 + h**2) / 12.0
    return np.stack([ix, iy, ix], axis=-1)


def capsule_inertia(mass, radius, half_length) -> np.ndarray:
    """Capsule (axis Y) inertia: cylinder + two hemispheres composite."""
    r, h = np.asarray(radius), np.asarray(half_length) * 2.0
    mass = np.asarray(mass)
    v_cyl = np.pi * r**2 * h
    v_sph = (4.0 / 3.0) * np.pi * r**3
    v_tot = np.maximum(v_cyl + v_sph, 1e-12)
    m_cyl = mass * v_cyl / v_tot
    m_sph = mass * v_sph / v_tot
    i_cyl_y = 0.5 * m_cyl * r**2
    i_cyl_x = m_cyl * (r**2 / 4.0 + h**2 / 12.0)
    i_sph_y = 0.4 * m_sph * r**2
    d = h / 2.0 + 3.0 * r / 8.0  # hemisphere COM offset from capsule center
    i_sph_x = 0.4 * m_sph * r**2 + m_sph * d**2
    return np.stack([i_cyl_x + i_sph_x, i_cyl_y + i_sph_y, i_cyl_x + i_sph_x], axis=-1)
