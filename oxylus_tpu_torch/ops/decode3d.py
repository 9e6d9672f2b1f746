"""Visbuffer decode → G-buffer (counterpart of `oxylus_tpu/ops/decode3d.py`).

The decode path of the renderer (`RenderSpec(use_pallas=False)`): from the
vid (vm << 8) | slot of each pixel, fetch the triangle's three clip-space
vertices and its vertex pack from the setup, reconstruct perspective-correct
barycentrics analytically at the pixel centre, interpolate the object-space
position, normal and UV, move them to world space through the instance's
world matrix, derive the triangle's world tangent frame, evaluate the
material with full-rate atlas samples (albedo, emissive, metallic-roughness,
occlusion, normal map) and emit the G-buffer planes the lighting reads.

The contractions over a triangle's three vertices and over a 3×3 matrix are
summed as XLA's CPU dot sums them, a fused multiply-add chain
(`math3d.dot_fma`), so the planes round as the JAX package's jitted function.
"""

from __future__ import annotations

import torch

from ..utils import math3d
from .sampling import perturb_normal, sample_atlas_bilinear

Tensor = torch.Tensor


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def decode_visbuffer(
    vid: Tensor,          # (H, W) i32 (vm << 8) | slot, -1 = sky
    setup: dict,          # setup3d.setup_triangles: clip, packed_verts, slots_per_tri
    vm_instance: Tensor,  # (VM,)
    gscene,
    entity_world: Tensor,
    materials,
    atlas: Tensor,
    *,
    width: int,
    height: int,
    row_offset: int = 0,
    full_height: int | None = None,
) -> dict[str, Tensor]:
    """The G-buffer dict of `vid`: hit, albedo, normal, emissive, metallic,
    roughness, occlusion, world_pos, uv and tangent (the per-triangle tangent
    with its handedness in |T|: 1 → +1, 0.5 → −1; 0 without a UV frame), each
    zero (roughness and occlusion one) where nothing was hit; uv as
    interpolated there too. For a band of a taller image, `row_offset` is the
    global row of vid[0] and `full_height` the image's height. The pixel
    centres are divided by scalars on vid's device: CUDA divides by a CPU
    scalar as a product with its reciprocal."""
    dev = vid.device
    hit = vid >= 0
    pid = torch.clamp(vid, min=0)
    vm_slot = (pid >> 8).long()
    tri = torch.div(pid & 0xFF, setup["slots_per_tri"], rounding_mode="floor").long()
    clip = setup["clip"][vm_slot, tri]            # (H, W, 3, 4)
    packed = setup["packed_verts"][vm_slot, tri]  # (H, W, 3, 8): pos | nrm | uv

    fh = height if full_height is None else full_height
    rows = torch.full((), float(row_offset), device=dev) + torch.arange(height, dtype=torch.float32, device=dev)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / torch.full((), float(width), device=dev)
    xs = xs * 2.0 - 1.0
    ys = (rows + 0.5) / torch.full((), float(fh), device=dev) * 2.0 - 1.0
    ndc_x = xs[None, :].expand(height, width)
    ndc_y = ys[:, None].expand(height, width)

    # barycentrics from the 2D homogeneous cross products of the pixel ray
    # with the clip-space vertices, weighted by 1/w (perspective-correct)
    cx, cy, cw = clip[..., 0], clip[..., 1], clip[..., 3]
    inv_w = 1.0 / torch.clamp(torch.abs(cw), min=1e-9) * torch.sign(cw)  # 0 where w = 0
    px_ = cx * inv_w - ndc_x[..., None]
    py_ = cy * inv_w - ndc_y[..., None]

    def cross2(i: int, j: int) -> Tensor:
        return px_[..., i] * py_[..., j] - px_[..., j] * py_[..., i]

    b0 = cross2(1, 2) * inv_w[..., 0]
    b1 = cross2(2, 0) * inv_w[..., 1]
    b2 = cross2(0, 1) * inv_w[..., 2]
    bsum = b0 + b1 + b2
    inv_sum = torch.where(torch.abs(bsum) > 1e-12, 1.0 / bsum, 0.0)
    bary = torch.stack([b0, b1, b2], dim=-1) * inv_sum[..., None]  # (H, W, 3)

    pos_v, nrm_v, uv_v = packed[..., 0:3], packed[..., 3:6], packed[..., 6:8]
    bary_k = bary[..., :, None]
    normal_obj = math3d.dot_fma(bary_k.transpose(-1, -2), nrm_v.transpose(-1, -2))  # Σ_k bary_k · v_k
    uv = math3d.dot_fma(bary_k.transpose(-1, -2), uv_v.transpose(-1, -2))
    pos_obj = math3d.dot_fma(bary_k.transpose(-1, -2), pos_v.transpose(-1, -2))

    inst = vm_instance.long()[vm_slot]
    world = entity_world[gscene.inst_entity.long()[inst]]  # (H, W, 4, 4)
    rot = world[..., :3, :3]
    world_pos = math3d.dot_fma(rot, pos_obj[..., None, :]) + world[..., :3, 3]
    # the normal through the rotation part (rigid bodies, uniform scale)
    world_nrm = math3d.dot_fma(rot, normal_obj[..., None, :])
    world_nrm = world_nrm / torch.clamp(math3d._norm(world_nrm), min=1e-9)

    # the triangle's world tangent frame, the algebra of setup3d.setup_triangles
    wv = math3d.dot_fma(rot[..., None, :, :], pos_v[..., None, :]) + world[..., None, :3, 3]  # (H, W, 3, 3)
    e1w = wv[..., 1, :] - wv[..., 0, :]
    e2w = wv[..., 2, :] - wv[..., 0, :]
    duv1 = uv_v[..., 1, :] - uv_v[..., 0, :]
    duv2 = uv_v[..., 2, :] - uv_v[..., 0, :]
    detuv = duv1[..., 0] * duv2[..., 1] - duv2[..., 0] * duv1[..., 1]
    t_raw = e1w * duv2[..., 1:2] - e2w * duv1[..., 1:2]
    b_raw = e2w * duv1[..., 0:1] - e1w * duv2[..., 0:1]
    sgn = torch.where(detuv < 0.0, -1.0, 1.0)[..., None]
    t_len = math3d._norm(t_raw)
    t_hat = sgn * t_raw / torch.clamp(t_len, min=1e-20)
    ng = _cross(e1w, e2w)
    hand = torch.sum(_cross(ng, t_hat) * (b_raw * sgn), dim=-1, keepdim=True)
    w_hand = torch.where(hand < 0.0, -1.0, 1.0)
    tan_ok = (torch.abs(detuv)[..., None] > 1e-12) & (t_len > 1e-9)
    tangent_enc = torch.where(tan_ok, t_hat * (0.75 + 0.25 * w_hand), 0.0)

    # the material, every texture at full rate
    mat = gscene.inst_material.long()[inst]  # (H, W)
    uv_t = uv * materials.uv_size[mat] + materials.uv_offset[mat]
    mode = materials.sampling_mode[mat]
    flags = materials.flags[mat]

    def sample(rect: Tensor) -> Tensor:
        return sample_atlas_bilinear(atlas, rect[mat], uv_t, mode)

    texel = torch.where(((flags & 1) > 0)[..., None], sample(materials.albedo_rect), 1.0)
    albedo = texel * materials.albedo_color[mat]
    em_tex = sample(materials.emissive_rect)
    emissive = torch.where(((flags & 4) > 0)[..., None], em_tex[..., :3], 1.0) * materials.emissive_color[mat]
    has_mr = (flags & 8) > 0
    mr_tex = sample(materials.mr_rect)
    # glTF: metallic = B, roughness = G
    metallic = torch.where(has_mr, mr_tex[..., 2], 1.0) * materials.metallic_factor[mat]
    roughness = torch.where(has_mr, mr_tex[..., 1], 1.0) * materials.roughness_factor[mat]
    occ_tex = sample(materials.occlusion_rect)
    occlusion = torch.where((flags & 16) > 0, occ_tex[..., 0], 1.0)
    nrm_tex = sample(materials.normal_rect)
    flat_n = torch.tensor([0.0, 0.0, 1.0], device=dev)
    nrm_ts = torch.where(((flags & 2) > 0)[..., None], nrm_tex[..., :3] * 2.0 - 1.0, flat_n)
    world_nrm = perturb_normal(world_nrm, tangent_enc, nrm_ts)

    hitf = hit[..., None]
    return {
        "hit": hit,
        "albedo": torch.where(hitf, albedo, 0.0),
        "normal": torch.where(hitf, world_nrm, 0.0),
        "emissive": torch.where(hitf, emissive, 0.0),
        "metallic": torch.where(hit, metallic, 0.0),
        "roughness": torch.where(hit, roughness, 1.0),
        "occlusion": torch.where(hit, occlusion, 1.0),
        "world_pos": torch.where(hitf, world_pos, 0.0),
        "uv": uv,
        "tangent": torch.where(hitf, tangent_enc, 0.0),
    }
