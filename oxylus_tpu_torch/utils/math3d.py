"""Batched 3D math on torch tensors (counterpart of `oxylus_tpu/utils/math3d.py`).

Same conventions as the JAX module: quaternions are (x, y, z, w), matrices are
row-major and applied as `M @ v`, every function takes arbitrary leading batch
dimensions with the component axis last. Only the functions the headless frame
step uses are ported so far. Norms are written as `sqrt(sum(q*q))`, the form
`jnp.linalg.norm` lowers to, so float32 results track the JAX module.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_identity(shape=(), device=None) -> Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32, device=device)
    q[..., 3] = 1.0
    return q


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def quat_normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    return q / torch.clamp(_norm(q), min=eps)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b, both (..., 4) xyzw."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q: Tensor) -> Tensor:
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype, device=q.device)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector v (..., 3) by quaternion q (..., 4)."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def quat_to_mat3(q: Tensor) -> Tensor:
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_slerp(a: Tensor, b: Tensor, t) -> Tensor:
    """Spherical lerp with shortest-path sign fix; falls back to nlerp near 0 angle."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0.0, -b, b)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-4
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    if t.dim() < a.dim():
        t = t[..., None]
    safe_sin = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    wa = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    wb = torch.where(use_lerp, t, torch.sin(t * theta) / safe_sin)
    return quat_normalize(wa * a + wb * b)


def quat_from_axis_angle(axis: Tensor, angle) -> Tensor:
    axis = axis / torch.clamp(_norm(axis), min=1e-12)
    half = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device) * 0.5
    s = torch.sin(half)[..., None]
    return torch.cat([axis * s, torch.cos(half)[..., None]], dim=-1)


def quat_integrate(q: Tensor, omega: Tensor, dt) -> Tensor:
    """Integrate orientation by angular velocity omega (rad/s, world frame) over dt
    with the exact-angle exponential map."""
    angle = _norm(omega)
    half = 0.5 * angle * dt
    axis = omega / torch.clamp(angle, min=1e-12)
    s = torch.sin(half)
    dq = torch.cat([axis * s, torch.cos(half)], dim=-1)
    return quat_normalize(quat_mul(dq, q))


# ---------------------------------------------------------------------------
# Matrices
# ---------------------------------------------------------------------------

def trs_to_mat4(t: Tensor, r: Tensor, s: Tensor) -> Tensor:
    """translate * rotate * scale, the reference's local transform. t,s: (...,3);
    r: (...,4) quat xyzw."""
    rot = quat_to_mat3(r)
    m = torch.zeros(t.shape[:-1] + (4, 4), dtype=torch.float32, device=t.device)
    m[..., :3, :3] = rot * s[..., None, :]  # scale columns
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def mat4_mul(a: Tensor, b: Tensor) -> Tensor:
    """Batched 4×4 product as a fused multiply-add chain over k = 0..3 — the
    rounding of XLA's batched dot on the CPU. Each step forms the float32
    product exactly in float64, adds, and rounds to float32, so the result
    does not depend on the device's matmul library."""
    out = torch.zeros(torch.broadcast_shapes(a.shape, b.shape), dtype=torch.float64, device=a.device)
    for k in range(a.shape[-1]):
        out = (out + a[..., :, k, None].double() * b[..., None, k, :].double()).float().double()
    return out.float()
