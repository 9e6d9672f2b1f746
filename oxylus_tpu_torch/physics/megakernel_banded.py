"""Host-side helpers of the rank-banded physics kernels (counterpart of the
helpers in `oxylus_tpu/physics/megakernel_banded.py`).

Bodies are sorted by an x-slab-major rank so that every pair of touching bodies
lies within a small rank distance (the "band"); large static boxes ("hubs")
leave the pair phase and become analytic bounded planes. These helpers compute
that sort key, extract the hub planes, permute body state, and report how well
a band covers a scene. They are what the compact kernel's launch needs; the
banded kernel itself is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import BODY_STATIC, SHAPE_BOX, PhysicsState

Tensor = torch.Tensor

BAND = 128            # default max rank_b - rank_a for a candidate pair
N_PLANE = 4           # analytic bounded-plane slots (large static "hub" boxes)
PLANE_SC = 16         # scalars per plane in the scalar block
HUB_MIN_FACE_AREA = 25.0  # m²: static boxes with a larger face become analytic planes


def slab_rank_key(ps: PhysicsState, exclude: Tensor | None = None) -> Tensor:
    """x-slab-major, z-minor sort key (f32), computed in the JAX module's order.
    Slab width ≈ 1.1 mean body diameters, so each slab holds about one body
    column per z cell and lateral neighbours sit within ~2 slab populations."""
    act = ps.active if exclude is None else ps.active & ~exclude
    actf = act.to(torch.float32)
    n = torch.clamp(torch.sum(actf), min=1.0)
    eff_half = torch.maximum(torch.amax(ps.half_extent, dim=1), ps.radius)
    cell = 2.2 * torch.sum(eff_half * actf) / n  # ≈ 1.1 × mean diameter
    cell = torch.clamp(cell, min=1e-3)
    big = torch.tensor(3e9, dtype=torch.float32, device=ps.device)
    lo_x = torch.amin(torch.where(act, ps.pos[:, 0], big))
    lo_z = torch.amin(torch.where(act, ps.pos[:, 2], big))
    hi_z = torch.amax(torch.where(act, ps.pos[:, 2], -big))
    qx = torch.floor((ps.pos[:, 0] - lo_x) / cell)
    zn = (ps.pos[:, 2] - lo_z) / torch.clamp(hi_z - lo_z, min=1e-3)
    key = qx + torch.clamp(zn, 0.0, 0.999)
    return torch.where(act, key, big)


def slab_rank_perm(key: Tensor) -> Tensor:
    """Stable ascending sort of the key: ties keep slot order, as the JAX
    `lax.sort((key, iota), num_keys=1)` does."""
    return torch.sort(key, stable=True).indices


def _hub_scores(ps: PhysicsState) -> Tensor:
    sorted_ext = torch.sort(ps.half_extent, dim=1).values  # ascending
    face_area = 4.0 * sorted_ext[:, 1] * sorted_ext[:, 2]
    candidate = (ps.body_type == BODY_STATIC) & (ps.shape_type == SHAPE_BOX) & ps.active
    return torch.where(candidate, face_area, torch.full_like(face_area, -1.0))


def extract_hub_planes(ps: PhysicsState) -> tuple[Tensor, Tensor]:
    """Find up to N_PLANE large static boxes and describe them as bounded planes.

    Returns (plane_scalars (N_PLANE*PLANE_SC,), is_hub (B,) bool). Each plane row
    is [center(3), n(3), u(3), v(3), half_u, half_v, half_thickness, friction]
    with half_u = -1 marking an unused slot. Top-k ties resolve to the lower
    slot, as `lax.top_k` does."""
    hub_score = _hub_scores(ps)
    order = torch.sort(hub_score, descending=True, stable=True).indices[:N_PLANE]
    vals = hub_score[order]
    hub_ok = vals > HUB_MIN_FACE_AREA
    is_hub = torch.zeros(ps.num_slots, dtype=torch.bool, device=ps.device)
    is_hub[order] = hub_ok

    x, y, z, w = ps.quat[order].unbind(-1)
    r = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )  # (N_PLANE, 3, 3)
    h = ps.half_extent[order]  # (N_PLANE, 3)
    ax = torch.argsort(h, dim=1, stable=True)  # thin axis first → plane normal
    cols = lambda k: torch.gather(r, 2, ax[:, k][:, None, None].expand(-1, 3, 1))[..., 0]
    h_of = lambda k: torch.gather(h, 1, ax[:, k : k + 1])[:, 0]
    hu = torch.where(hub_ok, h_of(1), torch.full_like(vals, -1.0))
    rows = torch.cat(
        [
            ps.pos[order], cols(0), cols(1), cols(2),
            torch.stack([hu, h_of(2), h_of(0), ps.friction[order]], dim=-1),
        ],
        dim=1,
    )  # (N_PLANE, PLANE_SC)
    return rows.reshape(-1), is_hub


def count_hub_planes(ps: PhysicsState) -> int:
    """Host-side count of the hub planes extract_hub_planes would emit (1..N_PLANE),
    used to size the compact kernel's plane-contact rows to the scene."""
    he = ps.half_extent.cpu().numpy()
    ext = np.sort(he, axis=1)
    area = 4.0 * ext[:, 1] * ext[:, 2]
    is_hub = (
        (ps.body_type.cpu().numpy() == BODY_STATIC)
        & (ps.shape_type.cpu().numpy() == SHAPE_BOX)
        & ps.active.cpu().numpy()
        & (area > HUB_MIN_FACE_AREA)
    )
    return max(1, min(int(is_hub.sum()), N_PLANE))


def band_coverage_report(ps: PhysicsState, margin: float = 0.1, band: int | None = None) -> dict:
    """How well does the ±band rank window cover the AABB-overlap pair set?
    Dense O(B²) — for set-up checks and tests, not the hot path.

    Returns {"pairs": in-overlap pair count, "outside_band": pairs the band mask
    would reject this launch, "max_rank_dist": worst pair rank distance}."""
    _, is_hub = extract_hub_planes(ps)
    key = slab_rank_key(ps, exclude=is_hub)
    rank = torch.argsort(slab_rank_perm(key))
    eff = torch.maximum(torch.amax(ps.half_extent, dim=1), ps.radius) + margin
    lo = ps.pos - eff[:, None]
    hi = ps.pos + eff[:, None]
    overlap = torch.all((lo[:, None, :] <= hi[None, :, :]) & (hi[:, None, :] >= lo[None, :, :]), dim=-1)
    act = ps.active & ~is_hub
    valid = act[:, None] & act[None, :] & (rank[:, None] < rank[None, :])
    pair = overlap & valid
    dist = torch.abs(rank[:, None] - rank[None, :])
    return {
        "pairs": int(torch.sum(pair)),
        "outside_band": int(torch.sum(pair & (dist > (BAND if band is None else band)))),
        "max_rank_dist": int(torch.amax(torch.where(pair, dist, torch.zeros_like(dist)))),
    }


_PERMUTED_FIELDS = (
    "pos", "prev_pos", "linvel", "angvel", "quat", "prev_quat",
    "inv_mass", "inv_inertia", "half_extent", "radius", "radius2", "half_length",
    "friction", "restitution", "gravity_factor", "dof_mask_lin",
    "body_type", "shape_type", "active", "entity", "is_character",
    "ground_normal_y", "asleep", "sleep_timer",
)


def _permute_state(ps: PhysicsState, perm: Tensor) -> PhysicsState:
    return dataclasses.replace(ps, **{f: getattr(ps, f)[perm] for f in _PERMUTED_FIELDS})
