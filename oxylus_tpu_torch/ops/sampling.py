"""Texture sampling (counterpart of `oxylus_tpu/ops/sampling.py`).

The atlas (A, A, 4) uint8 is the engine's bindless texture table. Samplers
take normalised texture-local UVs and an atlas rect (u0, v0, u1, v1).

- `pack_atlas_taps`: (A·A, 16) rows, each texel with its 2×2 bilinear
  neighbourhood [c00 | c10 | c01 | c11] (edge-clamped), so one row gather is a
  bilinear sample. The renderer packs it as bfloat16, as the JAX renderer does.
- `pack_material_tables`: (M, 32) f32 material rows (every texture's rect and
  presence flag, the alpha cutoff and mask flag), the row layout that rides
  the tile raster's slot tables as float16.
- `sample_material_textures`: albedo (+ alpha), tangent-space normal,
  metallic-roughness with the occlusion that shares the MR rect, and emissive,
  each one tap of the packed table; `features` picks which.
- `perturb_normal`: the sampled tangent-space normal applied to the
  interpolated shading normal with the per-triangle tangent.
- `sample_atlas_bilinear`: the decode path's sampler (`ops/decode3d.py`):
  four taps of the uint8 atlas per sample, each clamped inside the rect
  window, with the material's wrap and filter mode.

Every function evaluates the JAX expressions in their order, op by op, so the
outputs round as the JAX package's do (`tests/test_torch_sampling.py`). A
distinct occlusion rect is not sampled on this path, as in the JAX package
(lane 24 is set only when the occlusion texture shares the MR rect).
"""

from __future__ import annotations

import torch

from ..assets.material import (
    FLAG_ALPHA_MASK,
    FLAG_HAS_ALBEDO,
    FLAG_HAS_EMISSIVE,
    FLAG_HAS_METALLIC_ROUGHNESS,
    FLAG_HAS_NORMAL,
    FLAG_HAS_OCCLUSION,
)
from ..render.debugdraw import to_int32_saturating

Tensor = torch.Tensor

FEATURES = ("albedo", "normal", "mr", "emissive")


def _wrap_uv(uv: Tensor, mode: Tensor) -> Tensor:
    """mode 0/4: repeat, 1/3: clamp (linear/nearest × repeated/clamped)."""
    repeat = torch.remainder(uv, 1.0)
    clamp = torch.clamp(uv, 0.0, 1.0)
    is_clamp = (mode == 1) | (mode == 3)
    return torch.where(is_clamp[..., None], clamp, repeat)


def sample_atlas_bilinear(atlas: Tensor, rect: Tensor, uv: Tensor, sampling_mode: Tensor | None = None) -> Tensor:
    """Sample the (A, A, 4) uint8 atlas at the local UVs `uv` (..., 2) inside
    the normalised rects `rect` (..., 4) = (u0, v0, u1, v1): the UV wrapped by
    `sampling_mode` (0/4 repeat, 1/3 clamp; None: repeat), then bilinear, or
    the nearest texel for modes 2 and 3, each tap clamped inside the rect's
    texels and the atlas (cast to int32 saturating, as XLA casts). Returns
    (..., 4) f32 in [0, 1]."""
    a = atlas.shape[0]
    if sampling_mode is None:
        sampling_mode = torch.zeros(uv.shape[:-1], dtype=torch.int32, device=uv.device)
    uv = _wrap_uv(uv, sampling_mode)
    u0, v0, u1, v1 = rect.unbind(-1)
    px = (u0 + uv[..., 0] * (u1 - u0)) * a - 0.5
    py = (v0 + uv[..., 1] * (v1 - v0)) * a - 0.5
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    fx = (px - x0)[..., None]
    fy = (py - y0)[..., None]
    # the taps stay inside the rect's texels: bilinear never bleeds into an atlas neighbour
    rx0 = torch.ceil(u0 * a - 0.5)
    ry0 = torch.ceil(v0 * a - 0.5)
    rx1 = torch.floor(u1 * a - 0.5)
    ry1 = torch.floor(v1 * a - 0.5)

    div = torch.full((), 255.0, device=atlas.device)

    def tap(xi: Tensor, yi: Tensor) -> Tensor:
        x = torch.clamp(to_int32_saturating(torch.minimum(torch.maximum(xi, rx0), rx1)), 0, a - 1)
        y = torch.clamp(to_int32_saturating(torch.minimum(torch.maximum(yi, ry0), ry1)), 0, a - 1)
        return atlas[y.long(), x.long()].to(torch.float32) / div

    nearest = (sampling_mode == 2) | (sampling_mode == 3)
    c00 = tap(x0, y0)
    c10 = tap(x0 + 1, y0)
    c01 = tap(x0, y0 + 1)
    c11 = tap(x0 + 1, y0 + 1)
    bilinear = c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy) + c01 * (1 - fx) * fy + c11 * fx * fy
    near = tap(torch.round(px), torch.round(py))
    return torch.where(nearest[..., None], near, bilinear)


def pack_atlas_taps(atlas: Tensor, dtype=torch.float32) -> Tensor:
    """(A·A, 16) rows [c00 rgba | c10 | c01 | c11] of the atlas in [0, 1]:
    each texel with its right, lower and lower-right neighbours (the last row
    and column repeat). The divisor is a scalar on the atlas's device: CUDA
    divides by a CPU scalar as a product with its reciprocal."""
    a = atlas.to(torch.float32) / torch.full((), 255.0, device=atlas.device)
    right = torch.cat([a[:, 1:], a[:, -1:]], dim=1)
    down = torch.cat([a[1:], a[-1:]], dim=0)
    down_right = torch.cat([down[:, 1:], down[:, -1:]], dim=1)
    return torch.cat([a, right, down, down_right], dim=-1).reshape(-1, 16).to(dtype)


def pack_material_tables(materials) -> Tensor:
    """(M, 32) f32 material rows:
      0:2 uv_size, 2:4 uv_offset,
      4:8 albedo_rect, 8 has_albedo, 9:13 normal_rect, 13 has_normal,
      14:18 mr_rect, 18 has_mr, 19:23 emissive_rect, 23 has_emissive,
      24 occlusion present and sharing the MR rect (the glTF packing),
      25 alpha_cutoff, 26 is_alpha_mask, 27:32 zero."""
    f = materials.flags
    m = f.shape[0]

    def has(bit: int) -> Tensor:
        return ((f & bit) > 0).to(torch.float32)[:, None]

    occ_shared = torch.all(torch.abs(materials.occlusion_rect - materials.mr_rect) < 1e-6, dim=-1)
    return torch.cat(
        [
            materials.uv_size, materials.uv_offset,
            materials.albedo_rect, has(FLAG_HAS_ALBEDO),
            materials.normal_rect, has(FLAG_HAS_NORMAL),
            materials.mr_rect, has(FLAG_HAS_METALLIC_ROUGHNESS),
            materials.emissive_rect, has(FLAG_HAS_EMISSIVE),
            has(FLAG_HAS_OCCLUSION) * occ_shared.to(torch.float32)[:, None],
            materials.alpha_cutoff[:, None],
            has(FLAG_ALPHA_MASK),
            torch.zeros((m, 5), dtype=torch.float32, device=f.device),
        ],
        dim=-1,
    )


def _tap_rect(atlas_taps: Tensor, atlas_size: int, rect: Tensor, uvw: Tensor):
    """One packed 2×2 bilinear tap for an atlas rect at the wrapped UV `uvw`:
    the window is kept inside the rect (no bleeding across atlas neighbours)
    and the weights re-derived against the clamped corner. Returns (taps
    (..., 16) f32, fx, fy)."""
    a = atlas_size
    px = (rect[..., 0] + uvw[..., 0] * (rect[..., 2] - rect[..., 0])) * a - 0.5
    py = (rect[..., 1] + uvw[..., 1] * (rect[..., 3] - rect[..., 1])) * a - 0.5
    rx0 = torch.ceil(rect[..., 0] * a - 0.5)
    ry0 = torch.ceil(rect[..., 1] * a - 0.5)
    rx1 = torch.floor(rect[..., 2] * a - 0.5)
    ry1 = torch.floor(rect[..., 3] * a - 0.5)
    x0 = torch.clamp(torch.clamp(torch.floor(px), rx0, rx1 - 1.0), 0, a - 2)
    y0 = torch.clamp(torch.clamp(torch.floor(py), ry0, ry1 - 1.0), 0, a - 2)
    fx = torch.clamp(px - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(py - y0, 0.0, 1.0)[..., None]
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)
    taps = atlas_taps[(yi * a + xi).reshape(-1)].reshape(*uvw.shape[:-1], 16).to(torch.float32)
    return taps, fx, fy


def _bilerp4(taps: Tensor, fx: Tensor, fy: Tensor) -> Tensor:
    """(..., 4) rgba from the packed 2×2 tap row."""
    return (
        taps[..., 0:4] * (1 - fx) * (1 - fy)
        + taps[..., 4:8] * fx * (1 - fy)
        + taps[..., 8:12] * (1 - fx) * fy
        + taps[..., 12:16] * fx * fy
    )


def sample_material_textures(mat_rows: Tensor, atlas_taps: Tensor, atlas_size: int, uv: Tensor,
                             features: tuple = FEATURES) -> dict[str, Tensor]:
    """Sample the material textures at `uv` (..., 2), one packed tap each, for
    the rows `mat_rows` (..., 32) of `pack_material_tables` (repeat wrap).

    Returns a dict with neutral values where a texture is absent or its
    feature not asked for: albedo_rgb (..., 3) = 1, alpha (..., 1) = 1,
    normal_ts (..., 3) = (0, 0, 1), mr (..., 2) = 1 [metallic = B, roughness =
    G, glTF], occlusion (..., 1) = 1 (R of the MR texture when they share a
    rect), emissive_rgb (..., 3) = 1."""
    uv_t = uv * mat_rows[..., 0:2] + mat_rows[..., 2:4]
    uvw = uv_t - torch.floor(uv_t)  # repeat wrap
    one = torch.ones((*uv.shape[:-1], 1), dtype=torch.float32, device=uv.device)
    out = {
        "albedo_rgb": torch.cat([one, one, one], dim=-1),
        "alpha": one,
        "normal_ts": torch.cat([0.0 * one, 0.0 * one, one], dim=-1),
        "mr": torch.cat([one, one], dim=-1),
        "occlusion": one,
        "emissive_rgb": torch.cat([one, one, one], dim=-1),
    }
    if "albedo" in features:
        taps, fx, fy = _tap_rect(atlas_taps, atlas_size, mat_rows[..., 4:8], uvw)
        rgba = _bilerp4(taps, fx, fy)
        has = mat_rows[..., 8:9] > 0.5
        out["albedo_rgb"] = torch.where(has, rgba[..., 0:3], 1.0)
        out["alpha"] = torch.where(has, rgba[..., 3:4], 1.0)
    if "normal" in features:
        taps, fx, fy = _tap_rect(atlas_taps, atlas_size, mat_rows[..., 9:13], uvw)
        rgb = _bilerp4(taps, fx, fy)[..., 0:3]
        has = mat_rows[..., 13:14] > 0.5
        # the 3-component +Y-up tangent-space encoding, RGBA8 as authored
        out["normal_ts"] = torch.where(has, rgb * 2.0 - 1.0, out["normal_ts"])
    if "mr" in features:
        taps, fx, fy = _tap_rect(atlas_taps, atlas_size, mat_rows[..., 14:18], uvw)
        rgba = _bilerp4(taps, fx, fy)
        has = mat_rows[..., 18:19] > 0.5
        out["mr"] = torch.where(has, torch.cat([rgba[..., 2:3], rgba[..., 1:2]], dim=-1), 1.0)
        out["occlusion"] = torch.where(mat_rows[..., 24:25] > 0.5, rgba[..., 0:1], 1.0)
    if "emissive" in features:
        taps, fx, fy = _tap_rect(atlas_taps, atlas_size, mat_rows[..., 19:23], uvw)
        rgb = _bilerp4(taps, fx, fy)[..., 0:3]
        has = mat_rows[..., 23:24] > 0.5
        out["emissive_rgb"] = torch.where(has, rgb, 1.0)
    return out


def _norm(x: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def perturb_normal(normal: Tensor, tangent_enc: Tensor, normal_ts: Tensor) -> Tensor:
    """Apply a tangent-space normal to the shading normal with the per-triangle
    tangent of the attribute planes (handedness in |T|: 1 → +1, 0.5 → −1;
    T = 0: no tangent frame, the normal is kept). T is re-orthogonalised
    against the normal per pixel (Gram-Schmidt)."""
    n = normal
    t_len = _norm(tangent_enc)
    has_t = t_len > 0.25
    w_hand = torch.where(t_len < 0.75, -1.0, 1.0)
    t = tangent_enc / torch.clamp(t_len, min=1e-20)
    t = t - torch.sum(t * n, dim=-1, keepdim=True) * n
    t = t / torch.clamp(_norm(t), min=1e-20)
    b = w_hand * _cross(n, t)
    np_ = normal_ts[..., 0:1] * t + normal_ts[..., 1:2] * b + normal_ts[..., 2:3] * n
    np_ = np_ / torch.clamp(_norm(np_), min=1e-20)
    return torch.where(has_t, np_, n)
