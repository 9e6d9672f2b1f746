"""GPU material SoA as torch tensors (counterpart of `oxylus_tpu/assets/material.py`).

Only the device table the 3D frame reads, its empty constructor and the flag
bits are ported; the host `Material` asset and `pack_materials` come with
texturing. `flags` is int32 here (the JAX table's uint32 bits all fit below
2^10), because torch has no bitwise ops on uint32 tensors.
"""

from __future__ import annotations

import dataclasses

import torch

# MaterialFlag bits (texture-present + alpha mode flags)
FLAG_HAS_ALBEDO = 1 << 0
FLAG_HAS_NORMAL = 1 << 1
FLAG_HAS_EMISSIVE = 1 << 2
FLAG_HAS_METALLIC_ROUGHNESS = 1 << 3
FLAG_HAS_OCCLUSION = 1 << 4
FLAG_FLIP_X = 1 << 6
FLAG_ALPHA_OPAQUE = 1 << 7
FLAG_ALPHA_MASK = 1 << 8
FLAG_ALPHA_BLEND = 1 << 9

GPU_MATERIAL_FIELDS = (
    "albedo_color", "emissive_color", "roughness_factor", "metallic_factor",
    "alpha_cutoff", "flags", "uv_size", "uv_offset",
    "albedo_rect", "normal_rect", "emissive_rect", "mr_rect", "occlusion_rect",
    "sampling_mode",
)


@dataclasses.dataclass
class GPUMaterials:
    """SoA mirror of all loaded materials; `*_rect` are atlas windows
    (u0, v0, u1, v1), a zero-area rect meaning "texture absent"."""

    albedo_color: torch.Tensor      # (M, 4) f32
    emissive_color: torch.Tensor    # (M, 3) f32
    roughness_factor: torch.Tensor  # (M,) f32
    metallic_factor: torch.Tensor   # (M,) f32
    alpha_cutoff: torch.Tensor      # (M,) f32
    flags: torch.Tensor             # (M,) i32
    uv_size: torch.Tensor           # (M, 2) f32
    uv_offset: torch.Tensor         # (M, 2) f32
    albedo_rect: torch.Tensor       # (M, 4) f32
    normal_rect: torch.Tensor       # (M, 4) f32
    emissive_rect: torch.Tensor     # (M, 4) f32
    mr_rect: torch.Tensor           # (M, 4) f32
    occlusion_rect: torch.Tensor    # (M, 4) f32
    sampling_mode: torch.Tensor     # (M,) i32

    @property
    def capacity(self) -> int:
        return self.flags.shape[0]


def empty_gpu_materials(capacity: int, device=None) -> GPUMaterials:
    m = capacity
    f32 = dict(dtype=torch.float32, device=device)
    z = lambda *s: torch.zeros(s, **f32)
    return GPUMaterials(
        albedo_color=torch.ones((m, 4), **f32),
        emissive_color=z(m, 3),
        roughness_factor=z(m),
        metallic_factor=z(m),
        alpha_cutoff=torch.full((m,), 0.1, **f32),
        flags=torch.full((m,), FLAG_ALPHA_OPAQUE, dtype=torch.int32, device=device),
        uv_size=torch.ones((m, 2), **f32),
        uv_offset=z(m, 2),
        albedo_rect=z(m, 4),
        normal_rect=z(m, 4),
        emissive_rect=z(m, 4),
        mr_rect=z(m, 4),
        occlusion_rect=z(m, 4),
        sampling_mode=torch.zeros((m,), dtype=torch.int32, device=device),
    )
