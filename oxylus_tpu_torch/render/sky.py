"""Physically-based sky: the Hillaire-style atmosphere LUT chain (counterpart of
`oxylus_tpu/render/sky.py`).

Transmittance LUT (64×256, once per atmosphere), multiple-scattering LUT
(32×32, once), a sky-view LUT (192×312, lat-long around the camera) sampled for
the background and projected to SH-2 ambient, and an aerial-perspective
froxel LUT (16×32×16, world-direction lat-long × distance slices). Step counts
are fixed per call, as in the JAX module; every march is a Python loop over
whole-image tensor ops. `AtmosphereParams` is a frozen, hashable dataclass:
it keys the renderer's LUT cache.
"""

from __future__ import annotations

import dataclasses
import math

import torch

Tensor = torch.Tensor

GROUND_RADIUS_KM = 6360.0
ATMOSPHERE_RADIUS_KM = 6460.0

TRANSMITTANCE_SIZE = (64, 256)   # (H, W)
MULTISCATTER_SIZE = (32, 32)
SKY_VIEW_SIZE = (192, 312)       # (H, W)
AERIAL_SIZE = (16, 32, 16)       # lat × lon × distance slices


@dataclasses.dataclass(frozen=True)
class AtmosphereParams:
    rayleigh_scattering: tuple = (5.802, 13.558, 33.100)  # 1e-3 / km
    rayleigh_density: float = 8.0
    mie_scattering: tuple = (3.996, 3.996, 3.996)
    mie_density: float = 1.2
    mie_extinction: float = 4.44
    mie_asymmetry: float = 0.8
    ozone_absorption: tuple = (0.650, 1.881, 0.085)
    ozone_height: float = 25.0
    ozone_thickness: float = 15.0

    @classmethod
    def from_component(cls, comp: dict) -> "AtmosphereParams":
        g = comp.get
        asym = float(g("mie_asymmetry", 3.6))
        return cls(
            rayleigh_scattering=tuple(comp["rayleigh_scattering"]),
            rayleigh_density=float(comp["rayleigh_density"]),
            mie_scattering=tuple(comp["mie_scattering"]),
            mie_density=float(comp["mie_density"]),
            mie_extinction=float(comp["mie_extinction"]),
            # the component stores asymmetry scaled ×4.5 in reference content; clamp to g < 1
            mie_asymmetry=min(asym / 4.5, 0.95) if asym > 1.0 else asym,
            ozone_absorption=tuple(comp["ozone_absorption"]),
            ozone_height=float(comp["ozone_height"]),
            ozone_thickness=float(comp["ozone_thickness"]),
        )


def _vec(v: tuple, device) -> Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _densities(p: AtmosphereParams, h_km: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    rayleigh = torch.exp(-h_km / p.rayleigh_density)
    mie = torch.exp(-h_km / p.mie_density)
    ozone = torch.clamp(1.0 - torch.abs(h_km - p.ozone_height) / p.ozone_thickness, min=0.0)
    return rayleigh, mie, ozone


def _extinction(p: AtmosphereParams, h_km: Tensor) -> Tensor:
    """(…, 3) extinction coefficient at altitude h (1e-3/km units)."""
    dr, dm, do = _densities(p, h_km)
    dev = h_km.device
    return dr[..., None] * _vec(p.rayleigh_scattering, dev) + dm[..., None] * p.mie_extinction + do[..., None] * _vec(
        p.ozone_absorption, dev
    )


def _ray_sphere_exit(origin_r: Tensor, mu: Tensor, radius: float) -> Tensor:
    """Distance to a sphere of `radius` from height origin_r along cos-zenith mu
    (the ray is assumed to exit: the atmosphere top)."""
    b = origin_r * mu
    c = origin_r * origin_r - radius * radius
    disc = torch.clamp(b * b - c, min=0.0)
    return torch.clamp(-b + torch.sqrt(disc), min=0.0)


def _ray_ground_hit(origin_r: Tensor, mu: Tensor) -> Tensor:
    b = origin_r * mu
    c = origin_r * origin_r - GROUND_RADIUS_KM * GROUND_RADIUS_KM
    disc = b * b - c
    hit = (disc >= 0.0) & (mu < 0.0)
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    return torch.where(hit & (t > 0.0), t, torch.inf)


def transmittance_lut(params: AtmosphereParams, steps: int = 40, device=None) -> Tensor:
    """(64, 256, 3) transmittance from a point at height u to the atmosphere top
    along cos-zenith mu."""
    h, w = TRANSMITTANCE_SIZE
    u_h = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    u_mu = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    r = GROUND_RADIUS_KM + u_h[:, None] * (ATMOSPHERE_RADIUS_KM - GROUND_RADIUS_KM)
    mu = u_mu[None, :] * 2.0 - 1.0
    r = r.expand(h, w)
    t_exit = _ray_sphere_exit(r, mu, ATMOSPHERE_RADIUS_KM)
    dt = t_exit / steps
    ts = (torch.arange(steps, dtype=torch.float32, device=device) + 0.5)[:, None, None] * dt[None]
    sample_r = torch.sqrt(r[None] ** 2 + ts**2 + 2.0 * r[None] * ts * mu[None])
    h_km = torch.clamp(sample_r - GROUND_RADIUS_KM, min=0.0)
    ext = _extinction(params, h_km)  # (steps, H, W, 3) in 1e-3/km
    optical = torch.sum(ext, dim=0) * dt[..., None] * 1e-3
    return torch.exp(-optical)


def _sample_transmittance(lut: Tensor, r: Tensor, mu: Tensor) -> Tensor:
    h, w = TRANSMITTANCE_SIZE
    u_h = (r - GROUND_RADIUS_KM) / (ATMOSPHERE_RADIUS_KM - GROUND_RADIUS_KM)
    u_mu = mu * 0.5 + 0.5
    iy = torch.clamp((u_h * h).to(torch.int32), 0, h - 1).long()
    ix = torch.clamp((u_mu * w).to(torch.int32), 0, w - 1).long()
    return lut[iy, ix]


def _phase_rayleigh(c: Tensor) -> Tensor:
    return 3.0 / (16.0 * math.pi) * (1.0 + c * c)


def _phase_mie(c: Tensor, g: float) -> Tensor:
    g2 = g * g
    return (
        3.0 / (8.0 * math.pi) * ((1.0 - g2) * (1.0 + c * c))
        / ((2.0 + g2) * torch.clamp((1.0 + g2 - 2.0 * g * c) ** 1.5, min=1e-6))
    )


def multiscatter_lut(params: AtmosphereParams, trans_lut: Tensor, steps: int = 20) -> Tensor:
    """(32, 32, 3) isotropic multiple-scattering factor Ψ(height, sun angle)
    (Hillaire eq. 5-7, 8 directions over the sphere)."""
    dev = trans_lut.device
    h, w = MULTISCATTER_SIZE
    u_h = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    u_mu = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    r = GROUND_RADIUS_KM + u_h[:, None] * (ATMOSPHERE_RADIUS_KM - GROUND_RADIUS_KM)
    mu_sun = u_mu[None, :] * 2.0 - 1.0
    r = r.expand(h, w)
    sun_dir = torch.stack([torch.sqrt(1 - mu_sun**2), mu_sun, torch.zeros_like(mu_sun)], dim=-1)

    golden = (1 + 5**0.5) / 2
    n_dir = 8
    i = torch.arange(n_dir, dtype=torch.float32, device=dev)
    theta = 2 * math.pi * i / golden
    z = 1 - 2 * (i + 0.5) / n_dir
    sin_t = torch.sqrt(1 - z * z)
    dirs = torch.stack([sin_t * torch.cos(theta), z, sin_t * torch.sin(theta)], dim=-1)  # (D, 3)
    scat_r0, scat_m0 = _vec(params.rayleigh_scattering, dev), _vec(params.mie_scattering, dev)

    l_total = torch.zeros((h, w, 3), device=dev)
    f_total = torch.zeros((h, w, 3), device=dev)
    for d in range(n_dir):
        mu_d = dirs[d, 1]
        t_top = _ray_sphere_exit(r, mu_d, ATMOSPHERE_RADIUS_KM)
        t_gnd = _ray_ground_hit(r, torch.full_like(r, 0.0) + mu_d)
        t_max = torch.minimum(t_top, t_gnd)
        t_max = torch.where(torch.isfinite(t_max), t_max, t_top)
        dt = t_max / steps
        trans_acc = torch.ones((h, w, 3), device=dev)
        cos_dir_sun = torch.sum(dirs[d] * sun_dir, dim=-1)
        for s in range(steps):
            t = (s + 0.5) * dt
            sr = torch.sqrt(r**2 + t**2 + 2 * r * t * mu_d)
            h_km = torch.clamp(sr - GROUND_RADIUS_KM, 0.0, 100.0)
            dr_, dm_, _ = _densities(params, h_km)
            scat = (dr_[..., None] * scat_r0 + dm_[..., None] * scat_m0) * 1e-3
            ext = _extinction(params, h_km) * 1e-3
            cos_sun = torch.clamp((r * mu_sun + t * cos_dir_sun) / torch.clamp(sr, min=1e-3), -1.0, 1.0)
            t_sun = _sample_transmittance(trans_lut, sr, cos_sun)
            step_trans = torch.exp(-ext * dt[..., None])
            phase = 1.0 / (4.0 * math.pi)
            l_total = l_total + trans_acc * scat * phase * t_sun * dt[..., None]
            f_total = f_total + trans_acc * scat * dt[..., None]
            trans_acc = trans_acc * step_trans
    l_2nd = l_total / n_dir
    f_ms = f_total / n_dir
    return l_2nd / torch.clamp(1.0 - f_ms, min=1e-4)


def _latlong_dirs(lat_n: int, lon_n: int, device) -> tuple[Tensor, Tensor, Tensor]:
    """Directions of the horizon-dense lat-long map, (lat_n, lon_n, 3), with
    the per-row latitude and the row parameter v."""
    v = (torch.arange(lat_n, dtype=torch.float32, device=device) + 0.5) / lat_n
    u = (torch.arange(lon_n, dtype=torch.float32, device=device) + 0.5) / lon_n
    lat = v * 2.0 - 1.0
    lat = torch.sign(lat) * lat * lat * (math.pi / 2)
    lon = u * 2.0 * math.pi - math.pi
    cos_lat = torch.cos(lat)[:, None]
    dirs = torch.stack(
        [
            (cos_lat * torch.sin(lon)[None, :]).expand(lat_n, lon_n),
            torch.sin(lat)[:, None].expand(lat_n, lon_n),
            (-cos_lat * torch.cos(lon)[None, :]).expand(lat_n, lon_n),
        ],
        dim=-1,
    )
    return dirs, cos_lat, v


def _march_step(params, trans_lut, ms_lut, r0, mu, sun_y, cos_theta, ph_r, ph_m, t, dt, lum, trans_acc):
    """One in-scattering step of the sky-view and aerial marches."""
    dev = mu.device
    sr = torch.sqrt(r0**2 + t**2 + 2.0 * r0 * t * mu)
    h_km = torch.clamp(sr - GROUND_RADIUS_KM, 0.0, 100.0)
    dr_, dm_, _ = _densities(params, h_km)
    scat_r = dr_[..., None] * _vec(params.rayleigh_scattering, dev) * 1e-3
    scat_m = dm_[..., None] * _vec(params.mie_scattering, dev) * 1e-3
    ext = _extinction(params, h_km) * 1e-3
    cos_sun = torch.clamp((r0 * sun_y + t * cos_theta) / torch.clamp(sr, min=1e-3), -1.0, 1.0)
    t_sun = _sample_transmittance(trans_lut, sr, cos_sun)
    ms_u = torch.clamp((sr - GROUND_RADIUS_KM) / (ATMOSPHERE_RADIUS_KM - GROUND_RADIUS_KM), 0.0, 1.0)
    ms_v = cos_sun * 0.5 + 0.5
    iy = torch.clamp((ms_u * MULTISCATTER_SIZE[0]).to(torch.int32), 0, MULTISCATTER_SIZE[0] - 1).long()
    ix = torch.clamp((ms_v * MULTISCATTER_SIZE[1]).to(torch.int32), 0, MULTISCATTER_SIZE[1] - 1).long()
    psi = ms_lut[iy, ix]
    in_scatter = scat_r * (ph_r[..., None] * t_sun + psi) + scat_m * (ph_m[..., None] * t_sun + psi)
    step_trans = torch.exp(-ext * dt)
    # energy-conserving integration (Hillaire): (1 - T_step) / ext
    lum = lum + trans_acc * in_scatter * (1.0 - step_trans) / torch.clamp(ext, min=1e-7)
    return lum, trans_acc * step_trans


def sky_view_lut(
    params: AtmosphereParams, trans_lut: Tensor, ms_lut: Tensor, sun_dir: Tensor,
    camera_height_km: float = 0.2, sun_intensity=10.0, steps: int = 32,
) -> Tensor:
    """(192, 312, 3) lat-long radiance LUT around the camera; `sun_dir` (3,)
    points toward the sun."""
    dev = trans_lut.device
    h, w = SKY_VIEW_SIZE
    r0 = GROUND_RADIUS_KM + torch.clamp(torch.tensor(camera_height_km, dtype=torch.float32, device=dev), min=0.01)
    dirs, _, _ = _latlong_dirs(h, w, dev)
    mu = dirs[..., 1]
    r0_img = r0.expand(mu.shape)
    t_top = _ray_sphere_exit(r0_img, mu, ATMOSPHERE_RADIUS_KM)
    t_gnd = _ray_ground_hit(r0_img, mu)
    t_max = torch.where(torch.isfinite(t_gnd), t_gnd, t_top)
    dt = t_max / steps
    cos_theta = torch.sum(dirs * sun_dir[None, None, :], dim=-1)
    ph_r = _phase_rayleigh(cos_theta)
    ph_m = _phase_mie(cos_theta, params.mie_asymmetry)
    lum = torch.zeros((h, w, 3), device=dev)
    trans_acc = torch.ones((h, w, 3), device=dev)
    for s in range(steps):
        t = (s + 0.5) * dt
        lum, trans_acc = _march_step(params, trans_lut, ms_lut, r0, mu, sun_dir[1], cos_theta, ph_r, ph_m, t,
                                     dt[..., None], lum, trans_acc)
    return lum * sun_intensity


def _dir_to_latlong(d: Tensor) -> tuple[Tensor, Tensor]:
    """Map parameters (vv, uu) in [0, 1] of unit directions on the lat-long maps."""
    lat = torch.arcsin(torch.clamp(d[..., 1], -1.0, 1.0))
    lon = torch.arctan2(d[..., 0], -d[..., 2])
    vv = torch.sqrt(torch.abs(lat) / (math.pi / 2)) * torch.sign(lat) * 0.5 + 0.5
    uu = (lon + math.pi) / (2 * math.pi)
    return vv, uu


def sample_sky_view(lut: Tensor, dirs: Tensor) -> Tensor:
    """Sample the lat-long sky-view LUT with world directions (..., 3)."""
    h, w = lut.shape[:2]
    d = dirs / torch.clamp(torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)), min=1e-9)
    vv, uu = _dir_to_latlong(d)
    iy = torch.clamp((vv * h).to(torch.int32), 0, h - 1).long()
    ix = torch.clamp((uu * w).to(torch.int32), 0, w - 1).long()
    return lut[iy, ix]


def sky_ambient(lut: Tensor) -> Tensor:
    """Flat ambient estimate: mean upper-hemisphere radiance."""
    return torch.mean(lut[lut.shape[0] // 2 :], dim=(0, 1))


def aerial_perspective(
    params: AtmosphereParams, trans_lut: Tensor, ms_lut: Tensor, world_pos: Tensor, hit: Tensor,
    camera_pos: Tensor, sun_dir: Tensor, sun_intensity=10.0, meters_per_km: float = 1000.0,
    start_km: float = 0.0, steps: int = 8,
) -> tuple[Tensor, Tensor]:
    """Per-pixel aerial perspective (the froxel LUT's march evaluated directly
    at each pixel): returns (in_scatter (H, W, 3), transmittance (H, W, 3)) to
    composite as `color * T + L` for pixels beyond `start_km`."""
    dev = world_pos.device
    rel = (world_pos - camera_pos[None, None, :]) / meters_per_km  # km
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    dirn = rel / torch.clamp(dist, min=1e-6)[..., None]
    march = torch.clamp(dist - start_km, min=0.0)
    r0 = GROUND_RADIUS_KM + torch.clamp(camera_pos[1] / meters_per_km, min=0.01)
    mu = dirn[..., 1]
    cos_theta = torch.sum(dirn * sun_dir[None, None, :], dim=-1)
    ph_r = _phase_rayleigh(cos_theta)
    ph_m = _phase_mie(cos_theta, params.mie_asymmetry)
    dt = march / steps
    lum = torch.zeros(world_pos.shape[:2] + (3,), device=dev)
    trans_acc = torch.ones(world_pos.shape[:2] + (3,), device=dev)
    for s_ in range(steps):
        t = (s_ + 0.5) * dt + start_km
        lum, trans_acc = _march_step(params, trans_lut, ms_lut, r0, mu, sun_dir[1], cos_theta, ph_r, ph_m, t,
                                     dt[..., None], lum, trans_acc)
    lum = lum * sun_intensity
    hitf = hit[..., None]
    return torch.where(hitf, lum, 0.0), torch.where(hitf, trans_acc, 1.0)


def aerial_lut(
    params: AtmosphereParams, trans_lut: Tensor, ms_lut: Tensor, camera_height_km: Tensor, sun_dir: Tensor,
    sun_intensity=10.0, max_km: float = 4.0,
) -> Tensor:
    """Aerial-perspective froxel LUT (LAT, LON, S, 6): [in-scatter rgb |
    transmittance rgb] cumulative from the camera to slice distance
    (s + 1)/S·max_km along world-direction cells; `sun_dir` points toward the sun."""
    dev = trans_lut.device
    lat_n, lon_n, s_n = AERIAL_SIZE
    dirs, _, _ = _latlong_dirs(lat_n, lon_n, dev)
    r0 = GROUND_RADIUS_KM + torch.clamp(camera_height_km, min=0.01)
    mu = dirs[..., 1]
    cos_theta = torch.sum(dirs * sun_dir[None, None, :], dim=-1)
    ph_r = _phase_rayleigh(cos_theta)
    ph_m = _phase_mie(cos_theta, params.mie_asymmetry)
    dt = max_km / s_n
    lum = torch.zeros((lat_n, lon_n, 3), device=dev)
    trans_acc = torch.ones((lat_n, lon_n, 3), device=dev)
    slices = []
    for s_ in range(s_n):
        t = (float(s_) + 0.5) * dt
        lum, trans_acc = _march_step(params, trans_lut, ms_lut, r0, mu, sun_dir[1], cos_theta, ph_r, ph_m, t, dt,
                                     lum, trans_acc)
        slices.append(torch.cat([lum, trans_acc], dim=-1))
    lut = torch.stack(slices, dim=2)  # (LAT, LON, S, 6)
    return torch.cat([lut[..., :3] * sun_intensity, lut[..., 3:]], dim=-1)


def apply_aerial_lut(
    lut: Tensor, world_pos: Tensor, hit: Tensor, camera_pos: Tensor, max_km: float = 4.0,
    meters_per_km: float = 1000.0,
) -> tuple[Tensor, Tensor]:
    """Per-pixel froxel fetch: nearest direction cell, linear in distance.
    Returns (in-scatter (H, W, 3), transmittance (H, W, 3))."""
    lat_n, lon_n, s_n = lut.shape[:3]
    rel = (world_pos - camera_pos[None, None, :]) / meters_per_km
    dist = torch.sqrt(torch.sum(rel * rel, dim=-1))
    d = rel / torch.clamp(dist, min=1e-6)[..., None]
    vv, uu = _dir_to_latlong(d)
    iy = torch.clamp((vv * lat_n).to(torch.int32), 0, lat_n - 1).long()
    ix = torch.clamp((uu * lon_n).to(torch.int32), 0, lon_n - 1).long()
    sf = torch.clamp(dist / max_km * s_n - 0.5, 0.0, s_n - 1.0)
    s0 = torch.floor(sf).to(torch.int32)
    s1 = torch.clamp(s0 + 1, max=s_n - 1)
    w1 = (sf - s0.to(torch.float32))[..., None]
    a = lut[iy, ix, s0.long()]
    b = lut[iy, ix, s1.long()]
    res = a * (1.0 - w1) + b * w1
    hitf = hit[..., None]
    return torch.where(hitf, res[..., :3], 0.0), torch.where(hitf, res[..., 3:], 1.0)


def sky_sh_ambient(lut: Tensor) -> Tensor:
    """Project the sky-view LUT onto 2nd-order spherical harmonics → (9, 3)."""
    h, w = lut.shape[:2]
    dirs, cos_lat, v = _latlong_dirs(h, w, lut.device)
    dx, dy, dz = dirs.unbind(-1)
    # solid-angle weight: d(lat)/dv changes with the sqrt warp; cos(lat) band weight
    dlat_dv = math.pi * torch.abs(v * 2.0 - 1.0) + 1e-3
    weight = (cos_lat[:, 0] * dlat_dv)[:, None].expand(h, w)
    y = [
        0.282095 * torch.ones_like(dx),
        0.488603 * dy,
        0.488603 * dz,
        0.488603 * dx,
        1.092548 * dx * dy,
        1.092548 * dy * dz,
        0.315392 * (3.0 * dz * dz - 1.0),
        1.092548 * dx * dz,
        0.546274 * (dx * dx - dy * dy),
    ]
    norm = torch.sum(weight) + 1e-9
    return torch.stack([torch.sum(lut * (yi * weight)[..., None], dim=(0, 1)) / norm * (4 * math.pi) for yi in y])


def eval_sh_ambient(coeffs: Tensor, normals: Tensor) -> Tensor:
    """Evaluate SH-2 irradiance for normals (..., 3) → (..., 3)
    (Ramamoorthi-Hanrahan convolution weights folded in)."""
    x, y_, z = normals[..., 0], normals[..., 1], normals[..., 2]
    a0, a1, a2 = 3.141593, 2.094395, 0.785398
    basis = [
        a0 * 0.282095 * torch.ones_like(x),
        a1 * 0.488603 * y_,
        a1 * 0.488603 * z,
        a1 * 0.488603 * x,
        a2 * 1.092548 * x * y_,
        a2 * 1.092548 * y_ * z,
        a2 * 0.315392 * (3.0 * z * z - 1.0),
        a2 * 1.092548 * x * z,
        a2 * 0.546274 * (x * x - y_ * y_),
    ]
    out = basis[0][..., None] * coeffs[0]
    for i in range(1, 9):
        out = out + basis[i][..., None] * coeffs[i]
    return torch.clamp(out / math.pi, min=0.0)
