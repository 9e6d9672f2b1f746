"""Debug visualization modes for the 3D frame (counterpart of
`oxylus_tpu/render/debugviews.py`).

Implements the reference's `rr.debug_view` modes (`Oxylus/src/Render/RendererCVar.cpp:16-23`,
shader `apply_debug_view`): 0 None, 1 Triangles, 2 Meshlets, 4 Materials, 5 Mesh
Instances, 6 Mesh LoDs, 7 Albedo, 8 Normals, 9 Emissive, 10 Metallic, 11 Roughness,
13 SSAO. Id-keyed modes hash the visbuffer id into stable pastel colors like the
reference's debug palette. The vid packing is the JAX package's, so every mode gives
its image exactly on the same inputs.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

DEBUG_NONE = 0
DEBUG_TRIANGLES = 1
DEBUG_MESHLETS = 2
DEBUG_MATERIALS = 4
DEBUG_INSTANCES = 5
DEBUG_LODS = 6
DEBUG_ALBEDO = 7
DEBUG_NORMALS = 8
DEBUG_EMISSIVE = 9
DEBUG_METALLIC = 10
DEBUG_ROUGHNESS = 11
DEBUG_SSAO = 13

_M32 = 0xFFFFFFFF


def _hash_color(ids: Tensor) -> Tensor:
    """Stable id → pastel RGB. The JAX module hashes in uint32 with wraparound;
    PyTorch's uint32 arithmetic is incomplete, so this hashes in int64 masked to
    32 bits after every product (the same bits: both factors are below 2^32)."""
    h = ids.to(torch.int64) & _M32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    # a scalar on the ids' device: CUDA divides by a CPU scalar as a product with its
    # reciprocal, an ulp off the CPU's (and XLA's) division
    scale = torch.full((), 255.0, device=ids.device)
    r = ((h >> 0) & 0xFF).to(torch.float32) / scale
    g = ((h >> 8) & 0xFF).to(torch.float32) / scale
    b = ((h >> 16) & 0xFF).to(torch.float32) / scale
    return torch.stack([r, g, b], dim=-1) * 0.7 + 0.3


def apply_debug_view(mode: int, ctx: dict) -> Tensor | None:
    """Returns the debug image for `mode`, or None for DEBUG_NONE / unknown modes.
    Expects renderer ctx keys: visbuffer, gbuffer, vm_instance, gscene, ao."""
    if mode == DEBUG_NONE:
        return None
    vid = ctx["visbuffer"]
    gb = ctx["gbuffer"]
    hit = gb["hit"][..., None]
    bg = torch.zeros(vid.shape + (3,), dtype=torch.float32, device=vid.device)
    pos = torch.clamp(vid.to(torch.int64), min=0)

    if mode == DEBUG_TRIANGLES:
        return torch.where(hit, _hash_color(pos), bg)
    if mode == DEBUG_MESHLETS:
        return torch.where(hit, _hash_color(pos >> 8), bg)
    if mode in (DEBUG_MATERIALS, DEBUG_INSTANCES, DEBUG_LODS):
        vm_slot = pos >> 8
        if "slot_instance" in ctx:
            # dense-compacted raster path: resolve through the per-slot table
            tab = ctx["slot_instance"]
            grp = ctx.get("slot_group", 64)
            flat = torch.clamp(vm_slot * grp + (pos & 255), 0, tab.shape[0] - 1)
            inst = tab[flat]
        else:
            inst = ctx["vm_instance"][vm_slot]
        gscene = ctx["gscene"]
        if mode == DEBUG_MATERIALS:
            ids = gscene.inst_material[inst.to(torch.int64)]
        elif mode == DEBUG_INSTANCES:
            ids = inst
        else:  # LODs — color by the meshlet's source mesh LOD bucket
            ids = ctx["vm_meshlet"][vm_slot]  # meshlet index encodes the lod window
        return torch.where(hit, _hash_color(ids), bg)
    if mode == DEBUG_ALBEDO:
        return torch.where(hit, gb["albedo"][..., :3], bg)
    if mode == DEBUG_NORMALS:
        return torch.where(hit, gb["normal"] * 0.5 + 0.5, bg)
    if mode == DEBUG_EMISSIVE:
        return torch.where(hit, gb["emissive"], bg)
    if mode == DEBUG_METALLIC:
        return torch.where(hit, gb["metallic"][..., None].expand(bg.shape), bg)
    if mode == DEBUG_ROUGHNESS:
        return torch.where(hit, gb["roughness"][..., None].expand(bg.shape), bg)
    if mode == DEBUG_SSAO and ctx.get("ao") is not None:
        return torch.where(hit, ctx["ao"][..., None].expand(bg.shape), bg)
    return None
