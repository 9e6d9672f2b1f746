"""Ground-truth ambient occlusion, visibility-bitmask variant (counterpart of
`oxylus_tpu/render/gtao.py`).

Per pixel and hemisphere slice, a 32-bit sector mask over the arc around the
projected normal; every sample marks the angular interval its
thickness-extruded surface subtends, so visibility behind thin occluders is
recovered. Taps are fixed integer screen offsets (edge-clamped shifts), as in
the JAX module. The masks are uint32 there; here they are int64 tensors
holding the same 32 bits, and the population count is the usual bit-parallel
sum. Then an edge-aware 3×3 blur (`denoise_ao`).

The JAX `gtao` is `jax.jit`-ed, so XLA contracts its products into fused
multiply-adds; run op by op (`jax.disable_jit()`) it rounds as this module does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

QUALITY_PRESETS = {0: (1, 2), 1: (2, 2), 2: (3, 3), 3: (3, 3)}  # slices, samples per side
N_BITS = 32
MASK32 = 0xFFFFFFFF


def _acos_fast(x: Tensor) -> Tensor:
    """Abramowitz–Stegun 4.4.45 polynomial acos (~1e-3 absolute error)."""
    ax = torch.abs(x)
    p = torch.sqrt(torch.clamp(1.0 - ax, min=0.0)) * (1.5707288 + ax * (-0.2121144 + ax * (0.0742610 - ax * 0.0187293)))
    return torch.where(x >= 0, p, math.pi - p)


def prefilter_depth(depth: Tensor, mips: int = 5) -> list[Tensor]:
    """Depth mip chain: 2×2 min-reduce for conservative reach."""
    out = [depth]
    cur = depth
    for _ in range(mips - 1):
        if min(cur.shape) < 2:
            break
        h2, w2 = cur.shape[0] // 2 * 2, cur.shape[1] // 2 * 2
        c = cur[:h2, :w2]
        cur = torch.minimum(torch.minimum(c[0::2, 0::2], c[1::2, 0::2]), torch.minimum(c[0::2, 1::2], c[1::2, 1::2]))
        out.append(cur)
    return out


def _bits_below(k: Tensor) -> Tensor:
    """k in [0, 32] → the low-k ones of a 32-bit mask."""
    kk = torch.clamp(k, 0, N_BITS).to(torch.int64)
    return (torch.ones_like(kk) << kk) - 1


def _popcount32(x: Tensor) -> Tensor:
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _norm_keep(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def gtao(view_pos: Tensor, view_normal: Tensor, hit: Tensor, radius: float = 0.5, thickness: float = 0.25,
         final_power: float = 1.2, quality_level: int = 3) -> Tensor:
    """AO factor (H, W), 1 = fully open, from view-space positions (z < 0 into
    the screen) and normals."""
    h, w = hit.shape
    n_slices, n_samples = QUALITY_PRESETS.get(quality_level, (3, 3))
    view_dir = -view_pos / torch.clamp(_norm_keep(view_pos), min=1e-6)

    max_px = 24
    pad = F.pad(view_pos.permute(2, 0, 1)[None], (max_px,) * 4, mode="replicate")[0].permute(1, 2, 0)

    def tap(dy: int, dx: int) -> Tensor:  # edge-clamped static shift of view_pos
        return pad[max_px + dy : max_px + dy + h, max_px + dx : max_px + dx + w]

    ao_acc = torch.zeros((h, w), device=view_pos.device)
    nrm = view_normal
    for s in range(n_slices):
        angle = (s + 0.5) * math.pi / n_slices
        ux, uy = math.cos(angle), math.sin(angle)
        # slice tangent in view space (screen x right, y down → view -y up)
        t_scr = torch.tensor([ux, -uy, 0.0], dtype=torch.float32, device=view_pos.device)
        t2 = t_scr[None, None, :] - torch.sum(t_scr * view_dir, dim=-1, keepdim=True) * view_dir
        t2 = t2 / torch.clamp(_norm_keep(t2), min=1e-6)
        # projected-normal angle γ in the (view_dir, t2) slice frame
        n_v = torch.sum(nrm * view_dir, dim=-1)
        n_t = torch.sum(nrm * t2, dim=-1)
        n_len = torch.sqrt(torch.clamp(n_v * n_v + n_t * n_t, min=1e-12))
        gamma = torch.sign(n_t) * _acos_fast(torch.clamp(n_v / n_len, -1.0, 1.0))
        arc_lo = gamma - math.pi / 2  # hemisphere arc of the surface normal

        mask = torch.zeros((h, w), dtype=torch.int64, device=view_pos.device)
        for sign in (1.0, -1.0):
            for i in range(1, n_samples + 1):
                step = max_px * (i / n_samples) ** 1.5
                dx = int(round(ux * step * sign))
                dy = int(round(uy * step * sign))
                if dx == 0 and dy == 0:
                    dx = int(sign)
                delta = tap(dy, dx) - view_pos
                d2 = torch.sum(delta * delta, dim=-1)
                rs = torch.rsqrt(torch.clamp(d2, min=1e-12))
                dist = d2 * rs
                # front/back angles: the sample and its thickness extrusion away
                # from the camera (view_dir points toward the camera)
                cos_f = torch.sum(delta * view_dir, dim=-1) * rs
                delta_b = delta - view_dir * thickness
                rs_b = torch.rsqrt(torch.clamp(torch.sum(delta_b * delta_b, dim=-1), min=1e-12))
                cos_b = torch.sum(delta_b * view_dir, dim=-1) * rs_b
                a_f = sign * _acos_fast(torch.clamp(cos_f, -1.0, 1.0))
                a_b = sign * _acos_fast(torch.clamp(cos_b, -1.0, 1.0))
                # the occluded interval in sector space over [γ-π/2, γ+π/2]
                u_lo = (torch.minimum(a_f, a_b) - arc_lo) / math.pi * N_BITS
                u_hi = (torch.maximum(a_f, a_b) - arc_lo) / math.pi * N_BITS
                lo = torch.floor(u_lo).to(torch.int32)
                hi = torch.ceil(u_hi).to(torch.int32)
                seg = _bits_below(hi) & (~_bits_below(lo) & MASK32)
                mask = mask | torch.where(dist < radius, seg, 0)
        occ = _popcount32(mask).to(torch.float32) / N_BITS
        ao_acc = ao_acc + (1.0 - occ)

    ao = torch.clamp(ao_acc / n_slices, 0.0, 1.0) ** final_power
    return torch.where(hit, ao, 1.0)


def denoise_ao(ao: Tensor, depth: Tensor, sigma_depth: float = 0.05) -> Tensor:
    """Edge-aware 3×3 blur: weights fall off across depth edges."""
    h, w = ao.shape
    ap = F.pad(ao[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    dp = F.pad(depth[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    acc = torch.zeros_like(ao)
    wsum = torch.zeros_like(ao)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            a = ap[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            d = dp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            wgt = torch.exp(-torch.abs(d - depth) / sigma_depth)
            acc = acc + a * wgt
            wsum = wsum + wgt
    return acc / torch.clamp(wsum, min=1e-6)
