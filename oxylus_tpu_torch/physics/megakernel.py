"""Dense all-pairs rigid-body substeps (counterpart of
`oxylus_tpu/physics/megakernel.py`, the headless runner's `use_megakernel`
physics).

One call advances every body by `n_substeps` fixed substeps. Per substep:
gravity on dynamic bodies; rotation matrices, AABB half extents (margin
0.04 m) and capsule half-segments; per body the count of AABB overlaps with
every other body, as row plus as column, for mass splitting; then
`iterations` stateless projected-Jacobi sweeps. Every sweep recomputes the
contact of every ordered pair (a, b), a ≠ b, that overlaps with a dynamic
side: capsule/capsule, box/capsule both ways, and the box/box face-axis SAT
with 4 clamped incident-face corners (the same geometry as the compact
kernel's `_sat`); λ = max(0, -(vn - bias)/k) per touching point, friction
clamped by µλ of the same sweep; row body a takes -j, column body b +j, and
the sums are applied with the raw masses after the sweep. Then positions and
first-order renormalised quaternions. Restitution is passed but unused.

Two implementations share one interface, `(scalars (8,), rows (32, B)) →
(13, B)`:

- `dense_substeps_reference`: plain PyTorch on whole (B, B) pair tensors. The
  wrapper uses it for tensors on the CPU; `chip_smoke.py` holds the CUDA
  kernel against it on the card.
- the CUDA kernel in `csrc/megakernel_dense.cu`, for tensors on a card: one
  persistent cooperative launch a call, each overlapping ordered pair's
  contact computed once a substep (a body past `CAP` partners derives its
  own in every sweep; `cap_stats` counts them). There is no fallback: a CUDA
  tensor reaches the kernel or the call raises.

`megakernel_substeps` builds the scalar block and the input rows from a
`PhysicsState`; `LAUNCHES` counts calls that went to the CUDA kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .megakernel_compact import _rot_rows, _sat
from .state import BODY_DYNAMIC, BODY_STATIC, SHAPE_BOX, PhysicsParams, PhysicsState

Tensor = torch.Tensor

CHUNK = 64   # capacity granularity (the TPU kernel's row block)
N_SCALARS = 8
N_ROWS = 32
N_OUT = 13
MARGIN = 0.04  # AABB margin (m), fixed as in the TPU kernel

# kernel launches made by `megakernel_substeps` (one per call that ran on a
# card); read and reset by callers that must prove the kernel ran
LAUNCHES = 0

CAP = 64  # partners a body keeps for the kernel's sweeps; a body past it walks all B in each sweep
# The kernel's passes, in the order of `PASS_CYCLES` (as `megakernel_banded.PASS_CYCLES`).
PASSES = ("pre", "count", "geom", "sweep")
PASS_CYCLES: Tensor | None = None

_STATS: dict[tuple[torch.device, int], Tensor] = {}


def _stats(dev: torch.device, stream: int) -> Tensor:
    """The cap statistics of (`dev`, raw stream handle `stream`), an int32
    (2,) tensor made zeroed at its first use. The kernel adds the bodies past
    `CAP` in each substep to [0] and keeps the most partners such a body had
    in [1]; a caller that wants one call's figures zeroes it first. Calls on
    other streams never add to it."""
    key = (dev, stream)
    if key not in _STATS:
        _STATS[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _STATS[key]


def cap_stats(dev: torch.device) -> Tensor:
    """`_stats` of the card's current stream."""
    return _stats(dev, torch.cuda.current_stream(dev).cuda_stream)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def pair_contacts(p, q, half, rad, hlen, is_box, dyn, act, margin):
    """One substep's pair geometry on whole (B, B) tensors, row body a along
    dim 0 and column body b along dim 1: the offsets b - a, the `active` mask
    (AABBs overlap, one side dynamic, both active, a ≠ b), the pair normal and
    the 4 (point relative to a, depth) slots. `p` and `q` are the position and
    quaternion components, `half` the box half extents."""
    b = p[0].shape[0]
    R = lambda t: t[:, None]
    C = lambda t: t[None, :]
    rr = _rot_rows(*q)
    box_b = is_box > 0.5
    lh = (torch.where(box_b, half[0], rad), torch.where(box_b, half[1], rad + hlen), torch.where(box_b, half[2], rad))
    eh = [
        torch.abs(rr[k][0]) * lh[0] + torch.abs(rr[k][1]) * lh[1] + torch.abs(rr[k][2]) * lh[2] + margin
        for k in range(3)
    ]
    ca = [rr[k][1] * hlen for k in range(3)]
    d = [C(t) - R(t) for t in p]
    active = (
        (torch.abs(d[0]) <= R(eh[0]) + C(eh[0]))
        & (torch.abs(d[1]) <= R(eh[1]) + C(eh[1]))
        & (torch.abs(d[2]) <= R(eh[2]) + C(eh[2]))
        & ((R(dyn) + C(dyn)) > 0.5)
        & ((R(act) * C(act)) > 0.5)
        & ~torch.eye(b, dtype=torch.bool, device=p[0].device)
    )
    normal, slots = _sat(
        d[0], d[1], d[2], tuple(tuple(R(rr[i][j]) for j in range(3)) for i in range(3)),
        tuple(R(h) for h in half), R(rad), R(is_box), (tuple(R(c) for c in ca), tuple(C(c) for c in ca)),
        tuple(tuple(C(rr[i][j]) for j in range(3)) for i in range(3)), tuple(C(h) for h in half), C(rad), C(is_box),
    )
    return d, active, normal, slots


def dense_substeps_reference(scalars: Tensor, rows: Tensor, *, n_substeps: int, iterations: int = 10) -> Tensor:
    """Plain PyTorch version of the dense kernel.

    `scalars` (8,) f32: dt, gravity(3), baumgarte, slop, AABB margin, n_sub.
    `rows` (32, B) f32 per-body inputs in `_input_rows` order. Returns (13, B):
    pos(3), linvel(3), angvel(3), quat(4). Row-side values are (B, 1) columns,
    column-side values (1, B) rows, so every pair (a, b) is one element of a
    (B, B) tensor."""
    dt = scalars[0]
    g = (scalars[1], scalars[2], scalars[3])
    baumgarte, slop, margin = scalars[4], scalars[5], scalars[6]

    (px, py, pz, vx, vy, vz, wx, wy, wz, qx, qy, qz, qw,
     inv_mass, im3x, im3y, im3z, hx, hy, hz, rad, hlen,
     fric, _rest, grav, dofx, dofy, dofz, is_box, dyn, mov, act) = rows.clone().unbind(0)

    R = lambda t: t[:, None]  # row body a
    C = lambda t: t[None, :]  # column body b
    mu = torch.sqrt(R(fric) * C(fric))

    for _ in range(n_substeps):
        # --- gravity (dynamic bodies) ------------------------------------------
        vy = vy + g[1] * grav * dt * dyn
        vx = vx + g[0] * grav * dt * dyn
        vz = vz + g[2] * grav * dt * dyn

        # --- pairs and contacts: positions do not change within the substep, so
        # every sweep's recomputed geometry is this one
        (dxc, dyc, dzc), active, (nx, ny, nz), slots = pair_contacts(
            (px, py, pz), (qx, qy, qz, qw), (hx, hy, hz), rad, hlen, is_box, dyn, act, margin
        )

        # --- mass splitting: overlaps as row plus as column --------------------
        ov = active.float()
        split = torch.clamp(torch.sum(ov, 1) + torch.sum(ov, 0), min=1.0)
        ime, imx, imy, imz = inv_mass * split, im3x * split, im3y * split, im3z * split

        for _ in range(iterations):
            racc = [0.0] * 6
            cacc = [0.0] * 6
            for rax, ray, raz, depth in slots:
                tf = (active & (depth > 0.0)).float()
                rbx, rby, rbz = rax - dxc, ray - dyc, raz - dzc
                rvx = C(vx) + C(wy) * rbz - C(wz) * rby - (R(vx) + R(wy) * raz - R(wz) * ray)
                rvy = C(vy) + C(wz) * rbx - C(wx) * rbz - (R(vy) + R(wz) * rax - R(wx) * raz)
                rvz = C(vz) + C(wx) * rby - C(wy) * rbx - (R(vz) + R(wx) * ray - R(wy) * rax)
                vn = rvx * nx + rvy * ny + rvz * nz
                an = (ray * nz - raz * ny, raz * nx - rax * nz, rax * ny - ray * nx)
                bn = (rby * nz - rbz * ny, rbz * nx - rbx * nz, rbx * ny - rby * nx)
                ang_a = R(imx) * (an[0] * an[0]) + R(imy) * (an[1] * an[1]) + R(imz) * (an[2] * an[2])
                ang_b = C(imx) * (bn[0] * bn[0]) + C(imy) * (bn[1] * bn[1]) + C(imz) * (bn[2] * bn[2])
                kn = R(ime) + C(ime) + ang_a + ang_b + 1e-9
                bias = baumgarte / dt * torch.clamp(depth - slop, min=0.0)
                lam = torch.clamp(-(vn - bias) / kn, min=0.0) * tf
                tvx, tvy, tvz = rvx - vn * nx, rvy - vn * ny, rvz - vn * nz
                tvl = torch.sqrt(tvx * tvx + tvy * tvy + tvz * tvz) + 1e-9
                lam_t = torch.minimum(tvl / kn, mu * lam) * tf
                jx = nx * lam - tvx / tvl * lam_t
                jy = ny * lam - tvy / tvl * lam_t
                jz = nz * lam - tvz / tvl * lam_t
                tq_a = (ray * jz - raz * jy, raz * jx - rax * jz, rax * jy - ray * jx)
                tq_b = (rby * jz - rbz * jy, rbz * jx - rbx * jz, rbx * jy - rby * jx)
                for c, (j, ta, tb) in enumerate(zip((jx, jy, jz), tq_a, tq_b)):
                    racc[c] = racc[c] - torch.sum(j, 1)
                    cacc[c] = cacc[c] + torch.sum(j, 0)
                    racc[3 + c] = racc[3 + c] - torch.sum(ta, 1)
                    cacc[3 + c] = cacc[3 + c] + torch.sum(tb, 0)
            acc = [racc[c] + cacc[c] for c in range(6)]
            # applied with the raw masses (mass splitting put the count into kn)
            vx = vx + acc[0] * inv_mass * dofx * mov
            vy = vy + acc[1] * inv_mass * dofy * mov
            vz = vz + acc[2] * inv_mass * dofz * mov
            wx = wx + acc[3] * im3x * mov
            wy = wy + acc[4] * im3y * mov
            wz = wz + acc[5] * im3z * mov

        # --- integrate positions and orientations -------------------------------
        px = px + vx * dt * mov
        py = py + vy * dt * mov
        pz = pz + vz * dt * mov
        hq = 0.5 * dt
        dqx = hq * (wx * qw + wy * qz - wz * qy)
        dqy = hq * (-wx * qz + wy * qw + wz * qx)
        dqz = hq * (wx * qy - wy * qx + wz * qw)
        dqw = hq * (-wx * qx - wy * qy - wz * qz)
        nqx, nqy, nqz, nqw = qx + dqx * mov, qy + dqy * mov, qz + dqz * mov, qw + dqw * mov
        qn = torch.rsqrt(nqx * nqx + nqy * nqy + nqz * nqz + nqw * nqw + 1e-12)
        qx, qy, qz, qw = nqx * qn, nqy * qn, nqz * qn, nqw * qn

    return torch.stack([px, py, pz, vx, vy, vz, wx, wy, wz, qx, qy, qz, qw])


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

def _dense_cuda(scalars: Tensor, rows: Tensor, *, n_substeps: int, iterations: int) -> Tensor:
    """Launch the CUDA kernel on PyTorch's current stream: one cooperative
    launch for the whole call. Raises on a build or launch error; never falls
    back."""
    from .._build import load_kernel_library
    from .megakernel_banded import _cycles_ptr

    lib = load_kernel_library()
    b = rows.shape[1]
    if scalars.shape != (N_SCALARS,) or rows.shape != (N_ROWS, b) or b % CHUNK != 0:
        raise ValueError(f"bad shapes: scalars {tuple(scalars.shape)}, rows {tuple(rows.shape)}")
    for t in (scalars, rows):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != rows.device:
            raise ValueError("scalars and rows must be contiguous float32 tensors on one card")
    ws = torch.empty(lib.dense_workspace_bytes(b), dtype=torch.uint8, device=rows.device)
    out = torch.empty((N_OUT, b), dtype=torch.float32, device=rows.device)
    dev = rows.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.dense_substeps(scalars.data_ptr(), rows.data_ptr(), out.data_ptr(), ws.data_ptr(),
                             _stats(dev, stream).data_ptr(), _cycles_ptr(PASS_CYCLES, len(PASSES), dev), b,
                             n_substeps, iterations, stream)
    if err != 0:
        raise RuntimeError(f"dense kernel launch failed: {lib.kernel_error_string(err).decode()}")
    return out


def run_dense(scalars: Tensor, rows: Tensor, **kw) -> Tensor:
    """Device dispatch: the CUDA kernel for tensors on a card (counted in
    `LAUNCHES`), the plain version for tensors on the CPU, nothing else."""
    global LAUNCHES
    if rows.is_cuda:
        out = _dense_cuda(scalars, rows, **kw)
        LAUNCHES += 1
        return out
    if rows.device.type == "cpu":
        return dense_substeps_reference(scalars, rows, **kw)
    raise ValueError(f"no dense-kernel implementation for device {rows.device}")


# ---------------------------------------------------------------------------
# Launch wrapper
# ---------------------------------------------------------------------------

_SCALARS: dict[tuple, Tensor] = {}


def _scalar_block(ps: PhysicsState, params: PhysicsParams, dt, n_substeps: int) -> Tensor:
    """The (8,) scalar block on the state's device, made once per (device,
    values): the dense runner's call repeats the same block every frame, and
    the kernel only reads it."""
    vals = (float(dt), *map(float, params.gravity), float(params.baumgarte), float(params.penetration_slop), MARGIN,
            float(n_substeps))
    key = (ps.device, vals)
    if key not in _SCALARS:
        _SCALARS[key] = torch.tensor(vals, dtype=torch.float32, device=ps.device)
    return _SCALARS[key]


def _input_rows(ps: PhysicsState) -> Tensor:
    f = lambda x: x.to(torch.float32)
    return torch.stack([
        *ps.pos.unbind(1), *ps.linvel.unbind(1), *ps.angvel.unbind(1), *ps.quat.unbind(1),
        ps.inv_mass, *ps.inv_inertia.unbind(1), *ps.half_extent.unbind(1), ps.radius, ps.half_length,
        ps.friction, ps.restitution, ps.gravity_factor, *ps.dof_mask_lin.unbind(1),
        f(ps.shape_type == SHAPE_BOX), f((ps.body_type == BODY_DYNAMIC) & ps.active),
        f((ps.body_type != BODY_STATIC) & ps.active), f(ps.active),
    ]).contiguous()


def pair_work(ps: PhysicsState) -> dict[str, int]:
    """What one dense substep from `ps` must compute, counted on this state
    (gravity moves no position before the contacts): the overlapping ordered
    pairs by shape kind, row body first (`box_box`, `box_round`, `round_box`,
    `round_round`; capsules and spheres are round), and the touching manifold
    points (`points`). For operation counts of the kernel's function."""
    r = _input_rows(ps)
    box = r[28] > 0.5
    _, active, _, slots = pair_contacts(r[0:3], r[9:13], r[17:20], r[20], r[21], r[28], r[29], r[31], MARGIN)
    rb, cb = box[:, None], box[None, :]
    kinds = {"box_box": rb & cb, "box_round": rb & ~cb, "round_box": ~rb & cb, "round_round": ~rb & ~cb}
    work = {k: int((active & m).sum()) for k, m in kinds.items()}
    work["points"] = sum(int((active & (sl[3] > 0.0)).sum()) for sl in slots)
    return work


def megakernel_substeps(
    ps: PhysicsState,
    params: PhysicsParams,
    dt,
    n_substeps: int = 1,
    iterations: int = 10,
) -> PhysicsState:
    """Run `n_substeps` fixed steps in one call; `prev_pos`/`prev_quat` become
    the pose before the call. Capacity must be a multiple of 64; compound
    proxies are refused (the XLA substep, `physics_substep`, takes them)."""
    b = ps.num_slots
    if b % CHUNK != 0:
        raise ValueError(f"the dense kernel needs a body capacity that is a multiple of {CHUNK}, got {b}")
    if ps.has_proxies:
        raise ValueError("compound bodies are not supported on the dense kernel; use physics_substep")
    out = run_dense(_scalar_block(ps, params, dt, n_substeps), _input_rows(ps),
                    n_substeps=n_substeps, iterations=iterations)
    return dataclasses.replace(
        ps,
        prev_pos=ps.pos,
        prev_quat=ps.quat,
        pos=out[0:3].T.contiguous(),
        linvel=out[3:6].T.contiguous(),
        angvel=out[6:9].T.contiguous(),
        quat=out[9:13].T.contiguous(),
    )
