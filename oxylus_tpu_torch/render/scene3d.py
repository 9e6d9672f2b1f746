"""Device-resident 3D scene geometry buffers (counterpart of
`oxylus_tpu/render/scene3d.py`).

Every baked mesh and LOD is flattened into global SoA tensors: one vertex pool,
one meshlet table, one indirection pool, with per-mesh LOD windows, plus the
prebaked per-meshlet vertex pack (one row per meshlet, [pos | nrm | uv] per
corner of each of the 64 triangle slots) that triangle setup gathers. Instances
bind a mesh to a transform (entity) and a material. The host bake is NumPy and
identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..assets.bake import MAX_LODS, BakedMesh

Tensor = torch.Tensor

GPU_SCENE_FIELDS = (
    "positions", "normals", "uvs",
    "ml_vertex_offset", "ml_vertex_count", "ml_tri_offset", "ml_tri_count",
    "ml_center", "ml_extent", "ml_cone_axis", "ml_cone_cutoff",
    "indirect_vertices", "local_triangles", "ml_packed_verts",
    "mesh_lod_meshlet_offset", "mesh_lod_meshlet_count", "mesh_lod_error",
    "mesh_aabb_min", "mesh_aabb_max", "mesh_lod_count",
    "inst_mesh", "inst_entity", "inst_material", "inst_valid",
)


@dataclasses.dataclass
class GPUScene:
    # vertex pool
    positions: Tensor          # (V, 3) f32
    normals: Tensor            # (V, 3) f32
    uvs: Tensor                # (V, 2) f32
    # meshlet table (all meshes, all LODs)
    ml_vertex_offset: Tensor   # (M,) i32 into indirect_vertices
    ml_vertex_count: Tensor    # (M,) i32
    ml_tri_offset: Tensor      # (M,) i32 into local_triangles
    ml_tri_count: Tensor       # (M,) i32
    ml_center: Tensor          # (M, 3) f32 (mesh local space)
    ml_extent: Tensor          # (M, 3) f32
    ml_cone_axis: Tensor       # (M, 3) f32
    ml_cone_cutoff: Tensor     # (M,) f32
    indirect_vertices: Tensor  # (IV,) i32 global vertex index
    local_triangles: Tensor    # (LT, 3) i32 meshlet-local vertex slot
    ml_packed_verts: Tensor    # (M, 64·3·8) f32
    # mesh table
    mesh_lod_meshlet_offset: Tensor  # (meshes, MAX_LODS) i32
    mesh_lod_meshlet_count: Tensor   # (meshes, MAX_LODS) i32
    mesh_lod_error: Tensor           # (meshes, MAX_LODS) f32
    mesh_aabb_min: Tensor            # (meshes, 3) f32
    mesh_aabb_max: Tensor            # (meshes, 3) f32
    mesh_lod_count: Tensor           # (meshes,) i32
    # instances
    inst_mesh: Tensor          # (I,) i32
    inst_entity: Tensor        # (I,) i32 transform source entity
    inst_material: Tensor      # (I,) i32
    inst_valid: Tensor         # (I,) bool

    @property
    def num_instances(self) -> int:
        return self.inst_mesh.shape[0]

    @property
    def num_meshlets(self) -> int:
        return self.ml_vertex_offset.shape[0]


def worst_case_meshlet_instances(meshes: list[BakedMesh], instances: list[tuple[int, int, int]]) -> int:
    """Static upper bound on simultaneously-visible meshlet instances: each
    instance renders exactly one LOD, so its worst case is its mesh's largest
    per-LOD meshlet count. Lets the renderer clamp its compaction capacities to
    the scene (the sorts scale with capacity — PERF_NOTES.md)."""
    per_mesh = [max((lod.meshlets.count for lod in m.lods), default=0) for m in meshes]
    return sum(per_mesh[mi] for (mi, _e, _m) in instances if mi < len(per_mesh))


def upload_meshes(
    meshes: list[BakedMesh], instances: list[tuple[int, int, int]], max_instances: int = 0, device=None
) -> GPUScene:
    """Flatten baked meshes + (mesh, entity, material) instance bindings to `device`."""
    pos_l, nrm_l, uv_l = [], [], []
    mvo, mvc, mto, mtc = [], [], [], []
    ctr, ext, cax, ccut = [], [], [], []
    indirect_l, local_l = [], []
    lod_off = np.zeros((len(meshes), MAX_LODS), np.int32)
    lod_cnt = np.zeros((len(meshes), MAX_LODS), np.int32)
    lod_err = np.full((len(meshes), MAX_LODS), 1e9, np.float32)
    aabb_min = np.zeros((len(meshes), 3), np.float32)
    aabb_max = np.zeros((len(meshes), 3), np.float32)
    lod_count = np.zeros(len(meshes), np.int32)

    v_base = 0
    for mi, mesh in enumerate(meshes):
        pos_l.append(mesh.positions)
        nrm_l.append(mesh.normals)
        uv_l.append(mesh.uvs)
        aabb_min[mi] = mesh.aabb_min
        aabb_max[mi] = mesh.aabb_max
        lod_count[mi] = len(mesh.lods)
        for li, lod in enumerate(mesh.lods):
            md = lod.meshlets
            lod_off[mi, li] = len(mvo)
            lod_cnt[mi, li] = md.count
            # bake stores error RELATIVE to the mesh AABB diagonal (scale-stable,
            # like meshopt's simplify result before meshopt_simplifyScale —
            # AssetManager_GLTF.cpp:746-793); the LOD select projects mesh-local
            # units through the instance scale, so convert here. Without this a
            # 20-unit wall's 0.006-relative LOD error read as 6 mm and the
            # selector collapsed Sponza-class scenes to their coarsest LODs.
            lod_err[mi, li] = lod.error * max(
                float(np.linalg.norm(mesh.aabb_max - mesh.aabb_min)), 1e-9
            )
            iv_base = sum(len(x) for x in indirect_l)
            lt_base = sum(len(x) for x in local_l)
            mvo.extend((md.vertex_offset + iv_base).tolist())
            mvc.extend(md.vertex_count.tolist())
            mto.extend((md.triangle_offset + lt_base).tolist())
            mtc.extend(md.triangle_count.tolist())
            ctr.append(md.center)
            ext.append(md.extent)
            cax.append(md.cone_axis)
            ccut.append(md.cone_cutoff)
            indirect_l.append(md.indirect_vertices.astype(np.int64) + v_base)
            local_l.append(md.local_triangles)
        # LODs past the chain reuse the last level (runtime clamps by lod_count)
        for li in range(len(mesh.lods), MAX_LODS):
            lod_off[mi, li] = lod_off[mi, len(mesh.lods) - 1]
            lod_cnt[mi, li] = lod_cnt[mi, len(mesh.lods) - 1]
            lod_err[mi, li] = lod_err[mi, len(mesh.lods) - 1]
        v_base += len(mesh.positions)

    # prebake packed per-meshlet vertex data (numpy, once per upload)
    mvo_np = np.asarray(mvo, np.int64)
    mtc_np = np.asarray(mtc, np.int64)
    mto_np = np.asarray(mto, np.int64)
    n_ml = len(mvo_np)
    if n_ml:
        lt_np = np.concatenate([x.astype(np.int64) for x in local_l]) if local_l else np.zeros((0, 3), np.int64)
        iv_np = np.concatenate([x.astype(np.int64) for x in indirect_l]) if indirect_l else np.zeros(0, np.int64)
        pos_np = np.concatenate(pos_l).astype(np.float32)
        nrm_np = np.concatenate(nrm_l).astype(np.float32)
        uv_np = np.concatenate(uv_l).astype(np.float32)
        slots = np.arange(64, dtype=np.int64)[None, :]
        tri_idx = mto_np[:, None] + np.minimum(slots, np.maximum(mtc_np[:, None] - 1, 0))
        local3 = lt_np[tri_idx]                                   # (M, 64, 3)
        gv = iv_np[mvo_np[:, None, None] + local3]                # (M, 64, 3)
        packed = np.concatenate(
            [pos_np[gv], nrm_np[gv], uv_np[gv]], axis=-1
        ).astype(np.float32)                                      # (M, 64, 3, 8)
    else:
        packed = np.zeros((0, 64, 3, 8), np.float32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cat = lambda lst, dtype, d=None: t(
        np.concatenate(lst).astype(dtype) if lst else np.zeros((0,) if d is None else (0, d), dtype)
    )
    n_inst = max(max_instances, len(instances), 1)
    inst_mesh = np.zeros(n_inst, np.int32)
    inst_entity = np.zeros(n_inst, np.int32)
    inst_material = np.zeros(n_inst, np.int32)
    inst_valid = np.zeros(n_inst, np.bool_)
    for i, (mesh_idx, entity, material) in enumerate(instances):
        inst_mesh[i] = mesh_idx
        inst_entity[i] = entity
        inst_material[i] = material
        inst_valid[i] = True

    return GPUScene(
        positions=cat(pos_l, np.float32, 3),
        normals=cat(nrm_l, np.float32, 3),
        uvs=cat(uv_l, np.float32, 2),
        ml_vertex_offset=t(np.asarray(mvo, np.int32)),
        ml_vertex_count=t(np.asarray(mvc, np.int32)),
        ml_tri_offset=t(np.asarray(mto, np.int32)),
        ml_tri_count=t(np.asarray(mtc, np.int32)),
        ml_center=cat(ctr, np.float32, 3),
        ml_extent=cat(ext, np.float32, 3),
        ml_cone_axis=cat(cax, np.float32, 3),
        ml_cone_cutoff=cat(ccut, np.float32),
        indirect_vertices=cat(indirect_l, np.int32),
        local_triangles=cat([x.astype(np.int32) for x in local_l], np.int32, 3),
        ml_packed_verts=t(packed.reshape(len(packed), -1)),
        mesh_lod_meshlet_offset=t(lod_off),
        mesh_lod_meshlet_count=t(lod_cnt),
        mesh_lod_error=t(lod_err),
        mesh_aabb_min=t(aabb_min),
        mesh_aabb_max=t(aabb_max),
        mesh_lod_count=t(lod_count),
        inst_mesh=t(inst_mesh),
        inst_entity=t(inst_entity),
        inst_material=t(inst_material),
        inst_valid=t(inst_valid),
    )
