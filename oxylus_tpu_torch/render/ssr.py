"""Screen-space reflections (counterpart of `oxylus_tpu/render/ssr.py`).

A fixed-step screen-space march of the reflected eye ray against the depth
buffer at reduced resolution, composited over the lit image by Schlick
Fresnel × gloss, with confidence-weighted upsampling.
"""

from __future__ import annotations

import torch

from ..utils.imgops import point_downsample as _pds
from ..utils.imgops import resize_linear
from ..utils.math3d import mat4_point_image

Tensor = torch.Tensor


def _norm_keep(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def ssr_trace(depth: Tensor, world_pos: Tensor, normal: Tensor, hit: Tensor, hdr: Tensor, camera_pos: Tensor,
              view_proj: Tensor, steps: int = 8, max_distance: float = 20.0,
              thickness: float = 0.6) -> tuple[Tensor, Tensor]:
    """Returns (reflection colour (H, W, 3), confidence (H, W) in [0, 1])."""
    h, w = depth.shape
    dev = depth.device
    view = world_pos - camera_pos[None, None, :]
    vdir = view / torch.clamp(_norm_keep(view), min=1e-6)
    rdir = vdir - 2.0 * torch.sum(vdir * normal, dim=-1, keepdim=True) * normal

    found = torch.zeros((h, w), dtype=torch.bool, device=dev)
    hit_x = torch.zeros((h, w), dtype=torch.int32, device=dev)
    hit_y = torch.zeros((h, w), dtype=torch.int32, device=dev)
    flat = depth.reshape(-1)
    for i in range(1, steps + 1):
        t = max_distance * (i / steps) ** 2  # finer steps near the surface
        clip = mat4_point_image(view_proj, world_pos + rdir * t)
        wc = torch.clamp(clip[..., 3], min=1e-6)
        ndc = clip[..., :3] / wc[..., None]
        sx = ((ndc[..., 0] * 0.5 + 0.5) * w).to(torch.int32)
        sy = ((ndc[..., 1] * 0.5 + 0.5) * h).to(torch.int32)
        inside = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h) & (clip[..., 3] > 0)
        sxc = torch.clamp(sx, 0, w - 1)
        syc = torch.clamp(sy, 0, h - 1)
        scene_z = flat[(syc * w + sxc).long()]
        ray_z = ndc[..., 2]
        # reverse-Z: the scene surface occludes the ray when it is nearer
        # (larger) than the ray sample, within `thickness` in linear-ish terms
        blocked = (scene_z > ray_z + 1e-5) & (scene_z - ray_z < thickness * 0.05)
        new_hit = inside & blocked & ~found
        hit_x = torch.where(new_hit, sxc, hit_x)
        hit_y = torch.where(new_hit, syc, hit_y)
        found = found | new_hit

    color = hdr.reshape(-1, hdr.shape[-1])[(hit_y * w + hit_x).long()]
    # fade near screen edges (information leaves the screen)
    u = hit_x.to(torch.float32) / w
    v = hit_y.to(torch.float32) / h
    edge = (
        torch.clamp(u * 10.0, 0, 1) * torch.clamp((1 - u) * 10.0, 0, 1)
        * torch.clamp(v * 10.0, 0, 1) * torch.clamp((1 - v) * 10.0, 0, 1)
    )
    return color, torch.where(found & hit, edge, 0.0)


def apply_ssr(hdr: Tensor, gbuffer: dict, depth: Tensor, camera_pos: Tensor, view_proj: Tensor, steps: int = 8,
              max_roughness: float = 0.5, scale: int = 8) -> Tensor:
    """SSR traced at 1/`scale` resolution and composited over the lit image on
    smooth surfaces, Schlick Fresnel driving the mix."""
    h, w = depth.shape
    q = lambda a: _pds(a, scale)
    color4, conf4 = ssr_trace(q(depth), q(gbuffer["world_pos"]), q(gbuffer["normal"]), q(gbuffer["hit"]), q(hdr),
                              camera_pos, view_proj, steps=steps)
    # premultiplied-confidence upsampling: texels where the march missed hold
    # hdr[0, 0]; weight them out of the bilinear average
    color = resize_linear(color4 * conf4[..., None], (h, w, 3))
    conf = resize_linear(conf4, (h, w))
    color = color / torch.clamp(conf[..., None], min=1e-4)

    rough = gbuffer["roughness"]
    metal = gbuffer["metallic"]
    albedo = gbuffer["albedo"][..., :3]
    nrm = gbuffer["normal"]
    view = camera_pos[None, None, :] - gbuffer["world_pos"]
    vdir = view / torch.clamp(_norm_keep(view), min=1e-6)
    n_dot_v = torch.clamp(torch.sum(nrm * vdir, dim=-1), 0.0, 1.0)
    f0 = 0.04 * (1.0 - metal[..., None]) + albedo * metal[..., None]
    fresnel = f0 + (1.0 - f0) * ((1.0 - n_dot_v[..., None]) ** 5)
    gloss = torch.clamp(1.0 - rough / max_roughness, 0.0, 1.0)
    weight = conf[..., None] * fresnel * gloss[..., None]
    weight = torch.where(gbuffer["hit"][..., None], weight, 0.0)
    return hdr * (1.0 - weight) + color * weight
