"""Geometry bake: LOD chain + meshlet clustering + bounds, producing the GPU schema.

Host asset code, copied from `oxylus_tpu/assets/bake.py` (NumPy only): the port
bakes the same arrays from the same meshes. The native C++ kernels come from
the repo's `native/geometry.cpp`, built by `assets/native.py` into the port's
own build directory; without a compiler the NumPy fallbacks run, as in the JAX
package.

Re-creates the reference's import-time bake (`Oxylus/src/Asset/
AssetManager_GLTF.cpp:661-940`, backed by meshoptimizer) with our own algorithms:

- vertex dedup/remap (exact-position weld),
- LOD chain: grid vertex-clustering decimation per level (target ~half the triangles,
  cumulative error = cluster cell size — the same "error" contract the runtime LOD
  select consumes; a quadric-error C++ simplifier is the planned upgrade),
- meshlets: morton-ordered greedy packing under the reference limits
  (≤64 vertices / ≤64 triangles per meshlet, `Asset/Model.hpp:14-15`),
- per-meshlet bounds: AABB + normal cone (quantization-compatible with
  `GPU::MeshletBounds`, `SceneGPU.hpp:83-89`).

Output arrays mirror `GPU::Mesh/MeshLOD/Meshlet` (`SceneGPU.hpp:118-151`) as SoA numpy,
ready to upload or save to `.npz` packs (the `.oxpack` analog).
"""

from __future__ import annotations

import dataclasses

import numpy as np

MESHLET_MAX_VERTS = 64
MESHLET_MAX_TRIS = 64
MAX_LODS = 8


@dataclasses.dataclass
class MeshletData:
    # per-meshlet tables (reference GPU::Meshlet offsets/counts)
    vertex_offset: np.ndarray    # (M,) u32 into indirect_vertices
    vertex_count: np.ndarray     # (M,) u32
    triangle_offset: np.ndarray  # (M,) u32 into local_triangles
    triangle_count: np.ndarray   # (M,) u32
    indirect_vertices: np.ndarray  # (sumV,) u32 → mesh vertex index
    local_triangles: np.ndarray    # (sumT, 3) u8 local vertex index
    # bounds (GPU::MeshletBounds)
    center: np.ndarray           # (M, 3) f32
    extent: np.ndarray           # (M, 3) f32
    cone_axis: np.ndarray        # (M, 3) f32
    cone_cutoff: np.ndarray      # (M,) f32

    @property
    def count(self) -> int:
        return len(self.vertex_offset)


@dataclasses.dataclass
class LODData:
    meshlets: MeshletData
    index_count: int
    error: float  # cumulative simplification error (AssetManager_GLTF.cpp:746-793)


@dataclasses.dataclass
class BakedMesh:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray    # (V, 3) f32
    uvs: np.ndarray        # (V, 2) f32
    lods: list[LODData]
    aabb_min: np.ndarray
    aabb_max: np.ndarray
    material: int = -1


def weld_vertices(positions, normals, uvs, indices):
    """Exact-duplicate vertex weld + remap (meshopt remap analog)."""
    keys = np.concatenate([positions, normals, uvs], axis=1)
    _, first_idx, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    remap = rank[inverse]
    new_idx = remap[indices]
    return positions[first_idx[order]], normals[first_idx[order]], uvs[first_idx[order]], new_idx.astype(np.uint32)


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords → 30-bit morton code."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(x[:, 0]) | (spread(x[:, 1]) << np.uint64(1)) | (spread(x[:, 2]) << np.uint64(2))


def simplify_grid(positions: np.ndarray, indices: np.ndarray, cell_size: float):
    """Vertex-clustering decimation: snap vertices to a grid, merge clusters, drop
    degenerate triangles. Returns (indices', representative_map, error)."""
    mn = positions.min(axis=0)
    cells = np.floor((positions - mn) / max(cell_size, 1e-9)).astype(np.int64)
    _, cluster = np.unique(cells, axis=0, return_inverse=True)
    # representative vertex per cluster: first occurrence
    tri = cluster[indices.reshape(-1, 3)]
    keep = (tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2]) & (tri[:, 0] != tri[:, 2])
    # map cluster → representative original vertex
    n_clusters = cluster.max() + 1 if len(cluster) else 0
    rep = np.full(n_clusters, -1, np.int64)
    np.minimum.at(rep, cluster, np.arange(len(cluster)))
    rep = np.where(rep < 0, 0, rep)
    new_indices = rep[tri[keep]].astype(np.uint32).reshape(-1)
    return new_indices, float(cell_size)


def build_meshlets(positions: np.ndarray, indices: np.ndarray) -> MeshletData:
    """Morton-ordered greedy meshlet packing under 64v/64t. Uses the native C++
    kernel (`native/geometry.cpp::ox_build_meshlets`) when available; the numpy
    path below is the portable fallback."""
    tris = indices.reshape(-1, 3)
    nt = len(tris)
    if nt == 0:
        z = np.zeros(0, np.uint32)
        return MeshletData(z, z, z, z, z, np.zeros((0, 3), np.uint8), *(np.zeros((0, 3), np.float32),) * 2, np.zeros((0, 3), np.float32), np.zeros(0, np.float32))

    from .native import build_meshlets_native

    native = build_meshlets_native(positions, indices, MESHLET_MAX_VERTS, MESHLET_MAX_TRIS)
    if native is not None:
        v_off, v_cnt, t_off, t_cnt, indirect, local = native
        v_off = v_off.astype(np.uint32)
        v_cnt = v_cnt.astype(np.uint32)
        t_off = t_off.astype(np.uint32)
        t_cnt = t_cnt.astype(np.uint32)
        indirect = indirect.astype(np.uint32)
        local = local.astype(np.uint8)
    else:
        centroids = positions[tris].mean(axis=1)
        mn, mx = centroids.min(0), centroids.max(0)
        scale = np.where(mx - mn > 1e-12, (mx - mn), 1.0)
        q = np.clip(((centroids - mn) / scale) * 1023.0, 0, 1023).astype(np.uint32)
        order = np.argsort(_morton3(q), kind="stable")
        tris_sorted = tris[order]

        v_off_l, v_cnt_l, t_off_l, t_cnt_l = [], [], [], []
        indirect_l, local_l = [], []
        start = 0
        while start < nt:
            # binary search the largest chunk ≤64 tris with ≤64 unique verts
            hi = min(MESHLET_MAX_TRIS, nt - start)
            lo = 1
            best = 1
            while lo <= hi:
                mid = (lo + hi) // 2
                nuniq = len(np.unique(tris_sorted[start : start + mid]))
                if nuniq <= MESHLET_MAX_VERTS:
                    best = mid
                    lo = mid + 1
                else:
                    hi = mid - 1
            chunk = tris_sorted[start : start + best]
            uniq, inv = np.unique(chunk, return_inverse=True)
            v_off_l.append(len(indirect_l))
            v_cnt_l.append(len(uniq))
            t_off_l.append(len(local_l))
            t_cnt_l.append(best)
            indirect_l.extend(uniq.tolist())
            local_l.extend(inv.reshape(-1, 3).astype(np.uint8).tolist())
            start += best

        indirect = np.asarray(indirect_l, np.uint32)
        local = np.asarray(local_l, np.uint8).reshape(-1, 3)
        v_off = np.asarray(v_off_l, np.uint32)
        v_cnt = np.asarray(v_cnt_l, np.uint32)
        t_off = np.asarray(t_off_l, np.uint32)
        t_cnt = np.asarray(t_cnt_l, np.uint32)

    # bounds + cones
    m = len(v_off)
    center = np.zeros((m, 3), np.float32)
    extent = np.zeros((m, 3), np.float32)
    cone_axis = np.zeros((m, 3), np.float32)
    cone_cutoff = np.ones(m, np.float32)
    for i in range(m):
        verts = positions[indirect[v_off[i] : v_off[i] + v_cnt[i]]]
        bmin, bmax = verts.min(0), verts.max(0)
        center[i] = (bmin + bmax) * 0.5
        extent[i] = (bmax - bmin) * 0.5
        lt = local[t_off[i] : t_off[i] + t_cnt[i]].astype(np.int64)
        tv = verts[lt]
        n = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        nlen = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.maximum(nlen, 1e-12)
        axis = n.mean(axis=0)
        alen = np.linalg.norm(axis)
        if alen > 1e-6:
            axis = axis / alen
            min_dot = float(np.min(n @ axis))
            cone_axis[i] = axis
            # cutoff per meshopt convention: cull when dot(view, axis) >= cutoff fails
            cone_cutoff[i] = min(1.0, np.sqrt(max(0.0, 1.0 - min_dot * min_dot))) if min_dot > 0 else 1.0
        else:
            cone_cutoff[i] = 1.0  # no cone (double-sided cluster)

    return MeshletData(
        vertex_offset=v_off,
        vertex_count=v_cnt,
        triangle_offset=t_off,
        triangle_count=t_cnt,
        indirect_vertices=indirect,
        local_triangles=local,
        center=center,
        extent=extent,
        cone_axis=cone_axis,
        cone_cutoff=cone_cutoff,
    )


def bake_mesh(
    positions: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    indices: np.ndarray,
    material: int = -1,
    max_lods: int = MAX_LODS,
    quantize: bool = True,
) -> BakedMesh:
    positions = np.ascontiguousarray(positions, np.float32)
    normals = np.ascontiguousarray(normals, np.float32)
    uvs = np.ascontiguousarray(uvs, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32)
    if quantize:
        # half-precision quantization parity with the reference bake
        # (AssetManager_GLTF.cpp:721-737: positions f16, normals 10:10:10, uv f16) —
        # values are rounded through the quantized grids so culling/LOD decisions
        # match an engine storing them quantized
        positions = positions.astype(np.float16).astype(np.float32)
        uvs = uvs.astype(np.float16).astype(np.float32)
        normals = np.round(np.clip(normals, -1.0, 1.0) * 511.0) / 511.0
    positions, normals, uvs, indices = weld_vertices(positions, normals, uvs, indices)

    aabb_min = positions.min(axis=0) if len(positions) else np.zeros(3, np.float32)
    aabb_max = positions.max(axis=0) if len(positions) else np.zeros(3, np.float32)
    diag = float(np.linalg.norm(aabb_max - aabb_min))

    from .native import simplify_native

    lods: list[LODData] = []
    cur_indices = indices
    error = 0.0
    # LOD 0 = full resolution; each next level targets half the triangles
    # (AssetManager_GLTF.cpp:746-793: stop when error > 0.5 or no progress).
    # Preferred path: native QEM edge-collapse (geometry.cpp); fallback: grid clustering.
    cell = diag / 256.0 if diag > 0 else 0.0
    for lod in range(max_lods):
        lods.append(
            LODData(
                meshlets=build_meshlets(positions, cur_indices),
                index_count=len(cur_indices),
                error=error,
            )
        )
        if lod == max_lods - 1 or len(cur_indices) <= 3 * 4:
            break
        target = len(cur_indices) // 2
        native = simplify_native(positions, cur_indices, target, max_error=(0.5 * diag) ** 2)
        if native is not None:
            new_indices, abs_err = native
            new_err = max(error, abs_err / max(diag, 1e-9))
        else:
            tries = 0
            new_indices = cur_indices
            new_err = error
            while tries < 8:
                cand, cell_err = simplify_grid(positions, cur_indices, cell)
                if len(cand) <= max(target, 12) or cell > diag:
                    new_indices = cand
                    new_err = error + cell_err / max(diag, 1e-9)
                    break
                cell *= 1.7
                tries += 1
            else:
                break
        if (
            len(new_indices) == 0
            or len(new_indices) >= len(cur_indices)
            or new_err > 0.5
        ):
            break
        cur_indices, error = np.asarray(new_indices, np.uint32), new_err
        cell *= 1.4

    return BakedMesh(
        positions=positions,
        normals=normals,
        uvs=uvs,
        lods=lods,
        aabb_min=aabb_min.astype(np.float32),
        aabb_max=aabb_max.astype(np.float32),
        material=material,
    )
