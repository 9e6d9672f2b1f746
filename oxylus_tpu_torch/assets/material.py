"""Material asset and the GPU material SoA as torch tensors (counterpart of
`oxylus_tpu/assets/material.py`).

The host `Material` (the engine's material asset, with texture references by
name), `pack_materials` (host list + atlas rects → the device table on an
explicit device), the alpha-mode, sampling-mode and flag constants, and the
device table `GPUMaterials` the 3D frame reads. `flags` is int32 here (the JAX
table's uint32 bits all fit below 2^10), because torch has no bitwise ops on
uint32 tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

# AlphaMode
ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2

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

# SamplingMode
SAMPLE_LINEAR_REPEATED = 0
SAMPLE_LINEAR_CLAMPED = 1
SAMPLE_NEAREST_REPEATED = 2
SAMPLE_NEAREST_CLAMPED = 3
SAMPLE_LINEAR_REPEATED_ANISO = 4

GPU_MATERIAL_FIELDS = (
    "albedo_color", "emissive_color", "roughness_factor", "metallic_factor",
    "alpha_cutoff", "flags", "uv_size", "uv_offset",
    "albedo_rect", "normal_rect", "emissive_rect", "mr_rect", "occlusion_rect",
    "sampling_mode",
)


@dataclasses.dataclass
class Material:
    """Host material: factors, alpha mode and texture names (keys of the atlas rects)."""

    albedo_color: tuple = (1.0, 1.0, 1.0, 1.0)
    uv_size: tuple = (1.0, 1.0)
    uv_offset: tuple = (0.0, 0.0)
    emissive_color: tuple = (0.0, 0.0, 0.0)
    roughness_factor: float = 0.0
    metallic_factor: float = 0.0
    alpha_mode: int = ALPHA_OPAQUE
    alpha_cutoff: float = 0.1
    sampling_mode: int = SAMPLE_LINEAR_REPEATED
    albedo_texture: str = ""
    normal_texture: str = ""
    emissive_texture: str = ""
    metallic_roughness_texture: str = ""
    occlusion_texture: str = ""

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        for k in ("albedo_color", "uv_size", "uv_offset", "emissive_color"):
            d[k] = list(d[k])
        return d

    @classmethod
    def from_json(cls, obj: dict) -> "Material":
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name in obj:
                v = obj[f.name]
                kw[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)


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


def pack_materials(materials: list[Material], atlas_rects: dict[str, tuple], capacity: int,
                   device=None) -> GPUMaterials:
    """Host bake: the material list and the texture-name → atlas-rect map → the
    device table of `capacity` rows on `device` (the card unless "cpu", as
    `device.resolve_device` takes it). A texture sets its flag bit and rect only
    when its name is in `atlas_rects`."""
    m = capacity
    h = {
        "albedo_color": np.ones((m, 4), np.float32),
        "emissive_color": np.zeros((m, 3), np.float32),
        "roughness_factor": np.zeros(m, np.float32),
        "metallic_factor": np.zeros(m, np.float32),
        "alpha_cutoff": np.full(m, 0.1, np.float32),
        "flags": np.full(m, FLAG_ALPHA_OPAQUE, np.int32),
        "uv_size": np.ones((m, 2), np.float32),
        "uv_offset": np.zeros((m, 2), np.float32),
        "albedo_rect": np.zeros((m, 4), np.float32),
        "normal_rect": np.zeros((m, 4), np.float32),
        "emissive_rect": np.zeros((m, 4), np.float32),
        "mr_rect": np.zeros((m, 4), np.float32),
        "occlusion_rect": np.zeros((m, 4), np.float32),
        "sampling_mode": np.zeros(m, np.int32),
    }
    alpha_flag = {ALPHA_OPAQUE: FLAG_ALPHA_OPAQUE, ALPHA_MASK: FLAG_ALPHA_MASK, ALPHA_BLEND: FLAG_ALPHA_BLEND}
    tex_flag_rect = (
        ("albedo_texture", FLAG_HAS_ALBEDO, "albedo_rect"),
        ("normal_texture", FLAG_HAS_NORMAL, "normal_rect"),
        ("emissive_texture", FLAG_HAS_EMISSIVE, "emissive_rect"),
        ("metallic_roughness_texture", FLAG_HAS_METALLIC_ROUGHNESS, "mr_rect"),
        ("occlusion_texture", FLAG_HAS_OCCLUSION, "occlusion_rect"),
    )
    for i, mat in enumerate(materials[:m]):
        h["albedo_color"][i] = mat.albedo_color
        h["emissive_color"][i] = mat.emissive_color
        h["roughness_factor"][i] = mat.roughness_factor
        h["metallic_factor"][i] = mat.metallic_factor
        h["alpha_cutoff"][i] = mat.alpha_cutoff
        h["uv_size"][i] = mat.uv_size
        h["uv_offset"][i] = mat.uv_offset
        h["sampling_mode"][i] = mat.sampling_mode
        flags = alpha_flag.get(mat.alpha_mode, FLAG_ALPHA_OPAQUE)
        for attr, bit, rect_key in tex_flag_rect:
            name = getattr(mat, attr)
            if name and name in atlas_rects:
                flags |= bit
                h[rect_key][i] = atlas_rects[name]
        h["flags"][i] = flags
    dev = resolve_device(device)
    return GPUMaterials(**{k: torch.from_numpy(v).to(dev) for k, v in h.items()})
