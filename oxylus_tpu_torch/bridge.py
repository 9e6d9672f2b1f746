"""State carry-over between the JAX package and the port, through NumPy.

`*_from_numpy` accepts the JAX package's `SceneState`, `PhysicsState`,
`PhysicsParams`, `GPUScene`, `GPUMaterials` or `Lights` after `jax.device_get` (objects
whose fields are NumPy arrays), or a plain dict with the same keys, and builds
the port's tensors on `device`; a JAX `BakedMesh` (NumPy already) becomes the
port's `BakedMesh`.
`*_to_numpy` returns a dict of NumPy arrays with the JAX field names, ready for
`dataclasses.replace(jax_state, **{k: jnp.asarray(v) ...})`. Dtypes are kept
(bool, int32, uint32, uint64, float32), so a round trip is exact. This module
imports no JAX: the caller does the `device_get`.

`atmosphere_from_jax` copies a JAX `AtmosphereParams` field by field, and
`render_carry_from_numpy` / `render_carry_to_numpy` carry a renderer's frame
carry (`prev`: the HiZ levels, the shadow cache, the sky and aerial LUTs and
their keys, the static-frame memo's terms), so both packages can render one
frame from a shared carry.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .assets.bake import BakedMesh, LODData, MeshletData
from .assets.material import GPU_MATERIAL_FIELDS, GPUMaterials
from .physics.state import BODY_FIELDS, MESH_FIELDS, PhysicsParams, PhysicsState
from .render.pbr import Lights
from .render.scene3d import GPU_SCENE_FIELDS, GPUScene
from .render.sky import AtmosphereParams
from .scene.particles import ParticlePool
from .scene.state import SceneState

POOL_FIELDS = ("alive", "emitter", "age", "lifetime", "pos", "vel", "cursor")
_PARAM_FLOATS = (
    "baumgarte", "penetration_slop", "speculative_margin", "restitution_threshold",
    "sleep_velocity", "sleep_time",
)
_PARAM_STATIC = ("velocity_iterations", "max_pairs", "points_per_pair", "comm", "allow_sleeping")


def _get(src: Any, name: str, default=None):
    if isinstance(src, dict):
        return src.get(name, default)
    return getattr(src, name, default)


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def physics_state_from_numpy(src: Any, device: torch.device | str = "cpu") -> PhysicsState:
    fields = {name: _t(_get(src, name), device) for name in BODY_FIELDS}
    mesh = {name: _t(_get(src, name), device) for name in MESH_FIELDS if _get(src, name) is not None}
    return PhysicsState(
        accumulator=_t(np.asarray(_get(src, "accumulator"), np.float32), device),
        has_proxies=bool(_get(src, "has_proxies", False)),
        **fields,
        **mesh,
    )


def physics_state_to_numpy(ps: PhysicsState) -> dict:
    out = {name: _np(getattr(ps, name)) for name in BODY_FIELDS}
    out["accumulator"] = _np(ps.accumulator)
    for name in MESH_FIELDS:
        v = getattr(ps, name)
        out[name] = None if v is None else _np(v)
    out["has_proxies"] = ps.has_proxies
    return out


def physics_params_from_numpy(src: Any) -> PhysicsParams:
    kw = {name: float(np.asarray(_get(src, name))) for name in _PARAM_FLOATS}
    kw["gravity"] = tuple(float(v) for v in np.asarray(_get(src, "gravity")))
    kw.update({name: _get(src, name) for name in _PARAM_STATIC})
    return PhysicsParams(**kw)


def scene_state_from_numpy(src: Any, device: torch.device | str = "cpu") -> SceneState:
    pool = _get(src, "particles")
    return SceneState(
        alive=_t(_get(src, "alive"), device),
        parent=_t(_get(src, "parent"), device),
        level=_t(_get(src, "level"), device),
        world=_t(_get(src, "world"), device),
        previous_world=_t(_get(src, "previous_world"), device),
        comp={
            name: {k: _t(v, device) for k, v in fields.items()}
            for name, fields in _get(src, "comp").items()
        },
        mask={name: _t(v, device) for name, v in _get(src, "mask").items()},
        particles=ParticlePool(**{k: _t(_get(pool, k), device) for k in POOL_FIELDS}),
        time=_t(np.asarray(_get(src, "time"), np.float32), device),
        frame=_t(np.asarray(_get(src, "frame"), np.int32), device),
    )


def scene_state_to_numpy(st: SceneState) -> dict:
    return {
        "alive": _np(st.alive),
        "parent": _np(st.parent),
        "level": _np(st.level),
        "world": _np(st.world),
        "previous_world": _np(st.previous_world),
        "comp": {name: {k: _np(v) for k, v in fields.items()} for name, fields in st.comp.items()},
        "mask": {name: _np(v) for name, v in st.mask.items()},
        "particles": {k: _np(getattr(st.particles, k)) for k in POOL_FIELDS},
        "time": _np(st.time),
        "frame": _np(st.frame),
    }


def gpu_scene_from_numpy(src: Any, device: torch.device | str = "cpu") -> GPUScene:
    return GPUScene(**{name: _t(_get(src, name), device) for name in GPU_SCENE_FIELDS})


def gpu_scene_to_numpy(gs: GPUScene) -> dict:
    return {name: _np(getattr(gs, name)) for name in GPU_SCENE_FIELDS}


def gpu_materials_from_numpy(src: Any, device: torch.device | str = "cpu") -> GPUMaterials:
    """The JAX table's uint32 `flags` become int32 (every bit is below 2^10)."""
    kw = {name: _t(_get(src, name), device) for name in GPU_MATERIAL_FIELDS}
    kw["flags"] = kw["flags"].to(torch.int32)
    return GPUMaterials(**kw)


_MESHLET_FIELDS = (
    "vertex_offset", "vertex_count", "triangle_offset", "triangle_count", "indirect_vertices",
    "local_triangles", "center", "extent", "cone_axis", "cone_cutoff",
)


def lights_from_numpy(src: Any, device: torch.device | str = "cpu") -> Lights:
    return Lights(**{f.name: _t(_get(src, f.name), device) for f in dataclasses.fields(Lights)})


def baked_mesh_from_numpy(src: Any) -> BakedMesh:
    lods = [
        LODData(
            meshlets=MeshletData(**{k: np.array(getattr(lod.meshlets, k), copy=True) for k in _MESHLET_FIELDS}),
            index_count=int(lod.index_count), error=float(lod.error),
        )
        for lod in src.lods
    ]
    return BakedMesh(
        positions=np.array(src.positions, copy=True), normals=np.array(src.normals, copy=True),
        uvs=np.array(src.uvs, copy=True), lods=lods, aabb_min=np.array(src.aabb_min, copy=True),
        aabb_max=np.array(src.aabb_max, copy=True), material=int(src.material),
    )


def baked_mesh_to_numpy(mesh: Any) -> dict:
    """Every array of a BakedMesh (either package's) under a flat key."""
    out = {k: np.asarray(getattr(mesh, k)) for k in ("positions", "normals", "uvs", "aabb_min", "aabb_max")}
    for i, lod in enumerate(mesh.lods):
        out[f"lod{i}.index_count"] = np.asarray(lod.index_count)
        out[f"lod{i}.error"] = np.asarray(lod.error)
        for k in _MESHLET_FIELDS:
            out[f"lod{i}.{k}"] = np.asarray(getattr(lod.meshlets, k))
    return out


def atmosphere_from_jax(src: Any) -> AtmosphereParams:
    """A JAX `AtmosphereParams` (or a dict of its fields) as the port's."""
    kw = {}
    for f in dataclasses.fields(AtmosphereParams):
        v = _get(src, f.name)
        kw[f.name] = tuple(float(x) for x in v) if isinstance(v, (tuple, list)) else float(v)
    return AtmosphereParams(**kw)


def render_carry_from_numpy(src: Any, device: torch.device | str = "cpu") -> Any:
    """A renderer carry after `jax.device_get` (nested dicts, lists and tuples
    of arrays) as tensors on `device`, the nesting kept."""
    if isinstance(src, dict):
        return {k: render_carry_from_numpy(v, device) for k, v in src.items()}
    if isinstance(src, (list, tuple)):
        return type(src)(render_carry_from_numpy(v, device) for v in src)
    return _t(np.asarray(src), device)


def render_carry_to_numpy(carry: Any) -> Any:
    """The inverse of `render_carry_from_numpy`."""
    if isinstance(carry, dict):
        return {k: render_carry_to_numpy(v) for k, v in carry.items()}
    if isinstance(carry, (list, tuple)):
        return type(carry)(render_carry_to_numpy(v) for v in carry)
    return _np(carry)
