"""Culling chain (counterpart of `oxylus_tpu/ops/cull.py`): instance cull + LOD
select → meshlet expansion → meshlet cull, as fixed-shape masked passes.

- `cull_instances`: frustum test on instance world AABBs + LOD selection by
  projected pixel error (the coarsest LOD whose screen error stays under
  `acceptable_lod_error`).
- `expand_meshlet_instances`: per-instance meshlet ranges flattened by
  `prefix_expand`.
- `cull_meshlets`: world AABB frustum test + normal-cone backface rejection,
  then compaction to the visible-meshlet list, optionally ordered nearest
  first with a STABLE sort (entry order decides the raster's vids and its
  early-out, so ties must keep the JAX order: `jnp.argsort` is stable).
"""

from __future__ import annotations

import torch

from ..utils import math3d
from .compact import masked_compact, prefix_expand

Tensor = torch.Tensor


def cull_instances(
    gscene,
    entity_world: Tensor,
    frustum_planes: Tensor,
    camera_pos: Tensor,
    proj_scale_px: Tensor,
    acceptable_lod_error: float = 2.0,
    frustum_enabled: bool = True,
) -> tuple[Tensor, Tensor]:
    """Returns (visible (I,) bool, lod (I,) i32)."""
    mesh = gscene.inst_mesh.long()
    world = entity_world[gscene.inst_entity.long()]
    bmin, bmax = math3d.aabb_transform(world, gscene.mesh_aabb_min[mesh], gscene.mesh_aabb_max[mesh])
    visible = gscene.inst_valid
    if frustum_enabled:
        visible = visible & math3d.aabb_vs_frustum(frustum_planes[None], bmin, bmax)

    center = (bmin + bmax) * 0.5
    dist = math3d._norm(center - camera_pos[None, :])[:, 0]
    col_norms = torch.sqrt(torch.sum(world[:, :3, :3] * world[:, :3, :3], dim=1))
    scale = torch.max(col_norms, dim=-1).values
    errs = gscene.mesh_lod_error[mesh]  # (I, MAX_LODS)
    err_px = errs * scale[:, None] * proj_scale_px / torch.clamp(dist, min=1e-3)[:, None]
    acceptable = err_px < acceptable_lod_error  # LOD0 has error 0 → always ok
    lod_ids = torch.arange(acceptable.shape[1], dtype=torch.int32, device=acceptable.device)[None, :]
    in_chain = lod_ids < gscene.mesh_lod_count[mesh][:, None]
    pick = torch.where(acceptable & in_chain, lod_ids, -1)
    lod = torch.clamp(torch.max(pick, dim=-1).values, min=0)
    return visible, lod


def expand_meshlet_instances(gscene, visible: Tensor, lod: Tensor, capacity: int, with_overflow: bool = False):
    """Visible instances × selected-LOD meshlet ranges → flat meshlet-instance
    records (instance, meshlet, valid), plus the count the capacity dropped
    when `with_overflow`."""
    mesh = gscene.inst_mesh.long()
    lod_i = lod.long()[:, None]
    counts = torch.where(visible, torch.gather(gscene.mesh_lod_meshlet_count[mesh], 1, lod_i)[:, 0], 0)
    offsets = torch.gather(gscene.mesh_lod_meshlet_offset[mesh], 1, lod_i)[:, 0]
    inst, rank, valid = prefix_expand(counts, capacity)
    meshlet = torch.where(valid, offsets[inst.long()] + rank, 0)
    if with_overflow:
        overflow = torch.clamp(counts.sum(dtype=torch.int32) - capacity, min=0)
        return inst, meshlet, valid, overflow
    return inst, meshlet, valid


def cull_meshlets(
    gscene,
    entity_world: Tensor,
    mi_instance: Tensor,
    mi_meshlet: Tensor,
    mi_valid: Tensor,
    frustum_planes: Tensor,
    camera_pos: Tensor,
    capacity: int,
    cone_enabled: bool = True,
    frustum_enabled: bool = True,
    depth_sort: bool = False,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Returns compacted (vm_instance, vm_meshlet, vm_valid, count); with
    `depth_sort`, survivors ordered by conservative nearest camera distance."""
    world = entity_world[gscene.inst_entity[mi_instance.long()].long()]
    ml = mi_meshlet.long()
    center_l = gscene.ml_center[ml]
    extent_l = gscene.ml_extent[ml]
    bmin, bmax = math3d.aabb_transform(world, center_l - extent_l, center_l + extent_l)
    mask = mi_valid
    if frustum_enabled:
        mask = mask & math3d.aabb_vs_frustum(frustum_planes[None], bmin, bmax)

    # normal-cone backface rejection (meshopt convention):
    # cull when dot(center - cam, axis) ≥ cutoff·|center - cam| + radius
    center_w = (bmin + bmax) * 0.5
    radius = math3d._norm((bmax - bmin) * 0.5)[:, 0]
    axis_w = math3d.mat4_transform_dir(world, gscene.ml_cone_axis[ml])
    axis_w = axis_w / torch.clamp(math3d._norm(axis_w), min=1e-9)
    dvec = center_w - camera_pos[None, :]
    dlen = math3d._norm(dvec)[:, 0]
    cutoff = gscene.ml_cone_cutoff[ml]
    cone_cull = (torch.sum(dvec * axis_w, dim=-1) >= cutoff * dlen + radius) & (cutoff < 0.99)
    if cone_enabled:
        mask = mask & ~cone_cull

    idx, valid, count = masked_compact(mask, capacity)
    idx = idx.long()
    if depth_sort:
        key = torch.where(valid, (dlen - radius)[idx], torch.inf)
        order = torch.argsort(key, stable=True)
        idx, valid = idx[order], valid[order]
    return mi_instance[idx], mi_meshlet[idx], valid, count
