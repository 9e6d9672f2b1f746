"""PBR lighting: GGX/Smith/Schlick BRDF + punctual lights, applied fullscreen
(counterpart of `oxylus_tpu/render/pbr.py`).

Lights are shaded in blocks of up to 8 on component planes (LB, H, W). The
first `static_lights` lights are covered by blocks unrolled in Python (full
blocks of 8 and one partial block sized to the remainder); lights past that
hint run in a tail of 8-blocks, whose length comes from the light count read on
the host (the JAX package's dynamic tail loop).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.compact import masked_compact
from .sky import eval_sh_ambient

Tensor = torch.Tensor

MAX_LIGHTS = 256
LIGHT_DIRECTIONAL = 0
LIGHT_SPOT = 1
LIGHT_POINT = 2


@dataclasses.dataclass
class Lights:
    kind: Tensor       # (L,) i32
    color: Tensor      # (L, 3)
    intensity: Tensor  # (L,)
    position: Tensor   # (L, 3)
    direction: Tensor  # (L, 3) normalized, points *from* the light
    radius: Tensor     # (L,)
    inner_cone: Tensor  # (L,) radians
    outer_cone: Tensor  # (L,) radians
    valid: Tensor      # (L,) bool
    count: Tensor      # () i32 — live lights


def lights_from_state(state, capacity: int = MAX_LIGHTS) -> Lights:
    """Gather LightComponent entities into the fixed light table."""
    lc = state.comp["LightComponent"]
    mask = state.mask["LightComponent"] & state.alive
    idx, valid, count = masked_compact(mask, capacity)
    idx = idx.long()
    world = state.world[idx]
    fwd = -world[:, :3, 2]  # the entity's -Z column
    fwd = fwd / torch.clamp(torch.sqrt(torch.sum(fwd * fwd, dim=-1, keepdim=True)), min=1e-9)
    deg = math.pi / 180.0
    return Lights(
        kind=lc["type"][idx], color=lc["color"][idx], intensity=lc["intensity"][idx],
        position=world[:, :3, 3], direction=fwd, radius=lc["radius"][idx],
        inner_cone=lc["inner_cone_angle"][idx] * deg, outer_cone=lc["outer_cone_angle"][idx] * deg,
        valid=valid, count=count,
    )


def brdf(n, v, l, albedo, metallic, roughness):
    """Cook-Torrance specular + Lambert diffuse, metallic workflow."""
    dot = lambda a, b: torch.sum(a * b, dim=-1)
    h = v + l
    h = h / torch.clamp(torch.sqrt(dot(h, h))[..., None], min=1e-9)
    nol = torch.clamp(dot(n, l), min=0.0)
    nov = torch.clamp(dot(n, v), min=1e-4)
    noh = torch.clamp(dot(n, h), min=0.0)
    voh = torch.clamp(dot(v, h), min=0.0)
    rough = torch.clamp(roughness, 0.045, 1.0)
    f0 = 0.04 * (1.0 - metallic[..., None]) + albedo * metallic[..., None]
    a2 = (rough * rough) ** 2
    dd = noh * noh * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * dd * dd, min=1e-9)
    gv = nol * torch.sqrt(torch.clamp(nov * nov * (1.0 - a2) + a2, min=1e-9))
    gl = nov * torch.sqrt(torch.clamp(nol * nol * (1.0 - a2) + a2, min=1e-9))
    vis = 0.5 / torch.clamp(gv + gl, min=1e-9)
    f = f0 + (1.0 - f0) * (1.0 - voh[..., None]) ** 5
    specular = (d * vis)[..., None] * f
    diffuse = albedo * (1.0 - metallic[..., None]) / math.pi
    return (diffuse + specular) * nol[..., None]


def apply_pbr(
    gbuffer: dict[str, Tensor],
    lights: Lights,
    camera_pos: Tensor,
    ambient_color: Tensor,
    background: Tensor | None = None,
    ao: Tensor | None = None,
    shadow: Tensor | None = None,
    static_lights: int = 8,
    live_lights: int | None = None,
) -> Tensor:
    """Fullscreen lighting. `shadow` (H, W) multiplies the first directional
    light; `ao` multiplies the ambient term. `ambient_color` is a flat (3,)
    colour or (9, 3) SH-2 coefficients of the sky's irradiance. `live_lights`
    is `lights.count` already read on the host (the renderer reads it before
    the raster, where the read stalls least); None reads it here. Returns
    linear HDR (H, W, 3)."""
    n = gbuffer["normal"]
    wp = gbuffer["world_pos"]
    albedo = gbuffer["albedo"][..., :3]
    metallic = gbuffer["metallic"]
    roughness = gbuffer["roughness"]

    v = camera_pos[None, None, :] - wp
    v = v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-9)

    l_cap = lights.kind.shape[0]
    lb_w = min(8, l_cap)
    static_lights = max(1, min(static_lights, l_cap))

    nx, ny, nz = n.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    wx, wy, wz = wp.unbind(-1)
    rough = torch.clamp(roughness, 0.045, 1.0)
    a2p = (rough * rough) ** 2
    nov = torch.clamp(nx * vx + ny * vy + nz * vz, min=1e-4)
    f0 = [0.04 * (1.0 - metallic) + albedo[..., c] * metallic for c in range(3)]
    diff = [albedo[..., c] * (1.0 - metallic) / math.pi for c in range(3)]

    def light_block(s0: int, lb: int, acc: Tensor, dyn_min: int | None = None) -> Tensor:
        gi = torch.arange(s0, s0 + lb, dtype=torch.int32, device=acc.device)
        sl = lambda a: a[s0 : s0 + lb]
        col = lambda a: a[:, None, None]
        kind = sl(lights.kind)
        lvalid = sl(lights.valid) & (gi < lights.count)
        if dyn_min is not None:  # the tail's first block may overlap the partial static block
            lvalid = lvalid & (gi >= dyn_min)
        is_dir = col(kind == LIGHT_DIRECTIONAL)
        pos = sl(lights.position)
        ldx, ldy, ldz = (col(sl(lights.direction)[:, c]) for c in range(3))

        tlx = col(pos[:, 0]) - wx[None]
        tly = col(pos[:, 1]) - wy[None]
        tlz = col(pos[:, 2]) - wz[None]
        dist = torch.sqrt(tlx * tlx + tly * tly + tlz * tlz)
        inv = 1.0 / torch.clamp(dist, min=1e-9)
        lx = torch.where(is_dir, -ldx, tlx * inv)
        ly = torch.where(is_dir, -ldy, tly * inv)
        lz = torch.where(is_dir, -ldz, tlz * inv)

        d2 = (dist * col(1.0 / torch.clamp(sl(lights.radius), min=1e-4))) ** 2
        window = torch.clamp(1.0 - d2 * d2, 0.0, 1.0) ** 2
        atten_pt = window / torch.clamp(dist * dist, min=1e-4)
        cd = lx * ldx + ly * ldy + lz * ldz
        cos_outer = col(torch.cos(sl(lights.outer_cone) * 0.5))
        cos_inner = col(torch.cos(torch.clamp(sl(lights.inner_cone), min=1e-3) * 0.5))
        spot = torch.clamp((cd - cos_outer) / torch.clamp(cos_inner - cos_outer, min=1e-4), 0.0, 1.0)
        one = torch.ones((), dtype=torch.float32, device=acc.device)
        atten = torch.where(is_dir, one, torch.where(col(kind == LIGHT_SPOT), atten_pt * spot * spot, atten_pt))
        if shadow is not None:
            atten = torch.where(is_dir & col(gi == 0), atten * shadow[None], atten)

        hx, hy, hz = vx[None] + lx, vy[None] + ly, vz[None] + lz
        hinv = 1.0 / torch.clamp(torch.sqrt(hx * hx + hy * hy + hz * hz), min=1e-9)
        nol = torch.clamp(nx[None] * lx + ny[None] * ly + nz[None] * lz, min=0.0)
        noh = torch.clamp((nx[None] * hx + ny[None] * hy + nz[None] * hz) * hinv, min=0.0)
        voh = torch.clamp((vx[None] * hx + vy[None] * hy + vz[None] * hz) * hinv, min=0.0)
        dd = noh * noh * (a2p[None] - 1.0) + 1.0
        d_ggx = a2p[None] / torch.clamp(math.pi * dd * dd, min=1e-9)
        gv = nol * torch.sqrt(torch.clamp(nov[None] ** 2 * (1.0 - a2p[None]) + a2p[None], min=1e-9))
        gl = nov[None] * torch.sqrt(torch.clamp(nol * nol * (1.0 - a2p[None]) + a2p[None], min=1e-9))
        vis = 0.5 / torch.clamp(gv + gl, min=1e-9)
        fres = (1.0 - voh) ** 5
        dv = d_ggx * vis
        scale = torch.where(lvalid[:, None, None], nol * atten, 0.0)
        out = []
        for c in range(3):
            rad_c = col(sl(lights.color)[:, c] * sl(lights.intensity))
            spec_c = dv * (f0[c][None] + (1.0 - f0[c][None]) * fres)
            out.append(torch.sum((diff[c][None] + spec_c) * scale * rad_c, dim=0))
        return acc + torch.stack(out, dim=-1)

    acc = torch.zeros_like(albedo)
    full, rem = divmod(static_lights, lb_w)
    for b in range(full):
        acc = light_block(b * lb_w, lb_w, acc)
    if rem:
        acc = light_block(full * lb_w, rem, acc)
    count = int(lights.count) if live_lights is None else live_lights
    if count > static_lights:
        for b in range(static_lights // lb_w, (count + lb_w - 1) // lb_w):
            acc = light_block(b * lb_w, lb_w, acc, dyn_min=static_lights)

    if ambient_color.dim() == 2:  # (9, 3) SH coefficients → directional sky irradiance
        ambient = albedo * eval_sh_ambient(ambient_color, n)
    else:
        ambient = albedo * ambient_color[None, None, :]
    if ao is not None:
        ambient = ambient * ao[..., None]
    hdr = acc + ambient + gbuffer["emissive"]
    if background is None:
        background = torch.zeros_like(hdr)
    return torch.where(gbuffer["hit"][..., None], hdr, background)
