"""The 2D path's binding tables (counterpart of `oxylus_tpu/render/renderer2d.py`).

Only `SpriteBatchBindings` and `default_bindings` are ported: the 3D runner takes
its material table and atlas from them. The sprite raster is a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ..assets.material import GPUMaterials, empty_gpu_materials


@dataclasses.dataclass
class SpriteBatchBindings:
    """Device-resident bindings: the material table, the atlas and the
    per-entity material index map (rebuilt on asset/scene edits only)."""

    materials: GPUMaterials
    atlas: torch.Tensor                # (A, A, 4) uint8
    entity_material_idx: torch.Tensor  # (N,) i32 — sprite entity → material slot


def default_bindings(n_entities: int, capacity: int = 256, atlas_size: int = 64, device=None) -> SpriteBatchBindings:
    return SpriteBatchBindings(
        materials=empty_gpu_materials(capacity, device=device),
        atlas=torch.zeros((atlas_size, atlas_size, 4), dtype=torch.uint8, device=device),
        entity_material_idx=torch.zeros((n_entities,), dtype=torch.int32, device=device),
    )
