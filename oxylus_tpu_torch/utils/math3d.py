"""Batched 3D math on torch tensors (counterpart of `oxylus_tpu/utils/math3d.py`).

Same conventions as the JAX module: quaternions are (x, y, z, w), matrices are
row-major and applied as `M @ v`, every function takes arbitrary leading batch
dimensions with the component axis last. Only the functions the frame step,
the camera, the culling chain and triangle setup use are ported. Norms are
written as `sqrt(sum(q*q))`, the form `jnp.linalg.norm` lowers to, and the small
matrix-vector contractions round as XLA's CPU dot does (`dot_fma`), so float32
results track the JAX module.
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


def mat3_to_quat(m: Tensor) -> Tensor:
    """Rotation matrix (..., 3, 3) → quaternion (x, y, z, w): of the four
    reconstructions the one with the largest diagonal term, normalised."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def _q(tw, tx, ty, tz):
        return torch.stack([tx, ty, tz, tw], dim=-1)

    qs = torch.stack([
        _q(1 + tr, m21 - m12, m02 - m20, m10 - m01),
        _q(m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20),
        _q(m02 - m20, m01 + m10, 1 + m11 - m00 - m22, m12 + m21),
        _q(m10 - m01, m02 + m20, m12 + m21, 1 + m22 - m00 - m11),
    ], dim=-2)  # (..., 4, 4)
    idx = torch.argmax(torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1), dim=-1)
    q = torch.take_along_dim(qs, idx[..., None, None], dim=-2)[..., 0, :]
    return quat_normalize(q)


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


def dot_fma(a: Tensor, b: Tensor) -> Tensor:
    """Σ_k a[..., k]·b[..., k] (broadcast) as a fused multiply-add chain over
    k = 0, 1, …: the rounding of XLA's CPU dot for matrix-vector contractions.
    Each step forms the product exactly in float64, adds, and rounds to float32."""
    out = None
    for k in range(a.shape[-1]):
        p = a[..., k].double() * b[..., k].double()
        out = p.float() if out is None else (out.double() + p).float()
    return out


def mat4_identity(shape=(), device=None) -> Tensor:
    return torch.eye(4, dtype=torch.float32, device=device).expand(tuple(shape) + (4, 4)).clone()


def mat4_transform_point(m: Tensor, p: Tensor) -> Tensor:
    return mat4_transform_dir(m, p) + m[..., :3, 3]


def mat4_transform_dir(m: Tensor, d: Tensor) -> Tensor:
    return dot_fma(m[..., :3, :3], d[..., None, :])


def mat4_decompose(m: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """mat4 → (translation, quat, scale). Assumes no shear/negative scale."""
    t = m[..., :3, 3]
    basis = m[..., :3, :3]
    s = torch.sqrt(torch.sum(basis * basis, dim=-2))  # column norms
    rot = basis / torch.clamp(s[..., None, :], min=1e-12)
    return t, mat3_to_quat(rot), s


def look_at(eye: Tensor, center: Tensor, up: Tensor) -> Tensor:
    """Right-handed lookAt matching glm::lookAt."""
    f = center - eye
    f = f / torch.clamp(_norm(f), min=1e-12)
    s = torch.linalg.cross(f, up)
    s = s / torch.clamp(_norm(s), min=1e-12)
    u = torch.linalg.cross(s, f)
    m = mat4_identity(eye.shape[:-1], device=eye.device)
    m[..., 0, :3] = s
    m[..., 1, :3] = u
    m[..., 2, :3] = -f
    m[..., 0, 3] = -torch.sum(s * eye, dim=-1)
    m[..., 1, 3] = -torch.sum(u * eye, dim=-1)
    m[..., 2, 3] = torch.sum(f * eye, dim=-1)
    return m


def perspective_reverse_z(fov_y_rad: Tensor, aspect, near, far) -> Tensor:
    """Reversed-Z perspective with the Vulkan Y flip (glm::perspective(fov,
    aspect, far, near), then proj[1][1] *= -1). Depth: far → 0, near → 1."""
    tan_half = torch.tan(fov_y_rad / 2.0)
    z_near, z_far = far, near
    m = torch.zeros(fov_y_rad.shape + (4, 4), dtype=torch.float32, device=fov_y_rad.device)
    m[..., 0, 0] = 1.0 / (aspect * tan_half)
    m[..., 1, 1] = -(1.0 / tan_half)
    m[..., 2, 2] = z_far / (z_near - z_far)
    m[..., 2, 3] = -(z_far * z_near) / (z_far - z_near)
    m[..., 3, 2] = -1.0
    return m


def ortho_reverse_z(left, right, bottom, top, near, far, device=None) -> Tensor:
    """Reversed-Z ortho with swapped planes and the Y flip."""
    z_near, z_far = far, near
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = -(2.0 / (top - bottom))
    m[2, 2] = -1.0 / (z_far - z_near)
    m[2, 3] = -z_near / (z_far - z_near)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = (top + bottom) / (top - bottom)
    m[3, 3] = 1.0
    return m


def mat4_inverse(m: Tensor) -> Tensor:
    return torch.linalg.inv(m)


def aabb_union(min_a: Tensor, max_a: Tensor, min_b: Tensor, max_b: Tensor) -> tuple[Tensor, Tensor]:
    return torch.minimum(min_a, min_b), torch.maximum(max_a, max_b)


def aabb_transform(m: Tensor, bmin: Tensor, bmax: Tensor) -> tuple[Tensor, Tensor]:
    """Transform an AABB by an affine matrix → world AABB (Arvo's method)."""
    center = (bmin + bmax) * 0.5
    extent = (bmax - bmin) * 0.5
    new_center = mat4_transform_point(m, center)
    new_extent = dot_fma(torch.abs(m[..., :3, :3]), extent[..., None, :])
    return new_center - new_extent, new_center + new_extent


def frustum_planes_from_mat(vp: Tensor) -> Tensor:
    """The 6 normalized frustum planes (a, b, c, d) of a projection·view matrix,
    (..., 6, 4); inside ⇔ dot(plane.xyz, p) + plane.w ≥ 0."""
    r0, r1, r2, r3 = vp[..., 0, :], vp[..., 1, :], vp[..., 2, :], vp[..., 3, :]
    planes = torch.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r2, r3 - r2], dim=-2)
    return planes / torch.clamp(_norm(planes[..., :3]), min=1e-12)


def aabb_vs_frustum(planes: Tensor, bmin: Tensor, bmax: Tensor) -> Tensor:
    """Conservative AABB-in-frustum test. planes (..., 6, 4); bmin/bmax (..., 3) → bool."""
    center = (bmin + bmax) * 0.5
    extent = (bmax - bmin) * 0.5
    d = dot_fma(planes[..., :3], center[..., None, :]) + planes[..., 3]
    r = dot_fma(torch.abs(planes[..., :3]), extent[..., None, :])
    return torch.all(d + r >= 0.0, dim=-1)


def srgb_to_linear(c: Tensor) -> Tensor:
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: Tensor) -> Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def mat4_point_image(m: Tensor, p: Tensor) -> Tensor:
    """Transform an image of 3-D points (..., 3) by a 4×4 matrix → (..., 4) clip
    coordinates, each row summed left to right as the JAX module writes it."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack([((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3] for i in range(4)], dim=-1)


def mat3_dir_image(m: Tensor, d: Tensor) -> Tensor:
    """Rotate an image of 3-D vectors (..., 3) by a 3×3 matrix."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([(m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z for i in range(3)], dim=-1)
