"""Asset pack container (.oxpack analog) + resource compiler (a copy of
`oxylus_tpu/assets/pack.py`; a pack written by either package reads in the other).

The reference packs compiled shaders and assets into zstd `.oxpack` archives with a
name-keyed entry table (`Oxylus/include/Asset/AssetFile.hpp:12-99`), produced at build
time by the ResourceCompiler/rcli from a TOML manifest (`ResourceCompiler/`, manifest
schema `OxylusEditor/Assets/engine.toml`).

There is no SPIR-V here; the precompiled artifacts are baked geometry, texture
atlases, and material tables. This module keeps the same model: a name-keyed container
(a deflated zip of `.npy` members) plus a `compile_resources` entry point that consumes
a manifest and emits a pack, through the port's `bake`, `gltf` and `texture`.
`python -m oxylus_tpu_torch.assets.pack <manifest.toml|json> -o out.oxpack` is the rcli
analog. Texture members of any format `Texture.load` reads (KTX2 and DDS included) pack
to the JAX package's members.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path

import numpy as np

PACK_MAGIC = "OXPACK1"


def save_pack(path, entries: dict[str, dict[str, np.ndarray]], meta: dict | None = None) -> None:
    """Write a name-keyed pack: {entry_name: {array_name: ndarray}} (+ JSON meta)."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as z:
        manifest = {"magic": PACK_MAGIC, "entries": {}, "meta": meta or {}}
        for name, arrays in entries.items():
            manifest["entries"][name] = sorted(arrays)
            for key, arr in arrays.items():
                buf = io.BytesIO()
                np.save(buf, np.ascontiguousarray(arr))
                z.writestr(f"{name}/{key}.npy", buf.getvalue())
        z.writestr("manifest.json", json.dumps(manifest, indent=2))


def load_pack(path) -> tuple[dict[str, dict[str, np.ndarray]], dict]:
    with zipfile.ZipFile(path, "r") as z:
        manifest = json.loads(z.read("manifest.json"))
        if manifest.get("magic") != PACK_MAGIC:
            raise ValueError("not an oxpack container")
        entries: dict[str, dict[str, np.ndarray]] = {}
        for name, keys in manifest["entries"].items():
            entries[name] = {}
            for key in keys:
                entries[name][key] = np.load(io.BytesIO(z.read(f"{name}/{key}.npy")), allow_pickle=False)
    return entries, manifest.get("meta", {})


def baked_mesh_to_arrays(baked) -> dict[str, np.ndarray]:
    """Flatten a BakedMesh into pack arrays (schema mirrors GPU::Mesh/MeshLOD)."""
    out = {
        "positions": baked.positions,
        "normals": baked.normals,
        "uvs": baked.uvs,
        "aabb_min": baked.aabb_min,
        "aabb_max": baked.aabb_max,
        "material": np.asarray(baked.material, np.int32),
        "lod_count": np.asarray(len(baked.lods), np.int32),
    }
    for i, lod in enumerate(baked.lods):
        md = lod.meshlets
        p = f"lod{i}_"
        out[p + "error"] = np.asarray(lod.error, np.float32)
        out[p + "vertex_offset"] = md.vertex_offset
        out[p + "vertex_count"] = md.vertex_count
        out[p + "triangle_offset"] = md.triangle_offset
        out[p + "triangle_count"] = md.triangle_count
        out[p + "indirect_vertices"] = md.indirect_vertices
        out[p + "local_triangles"] = md.local_triangles
        out[p + "center"] = md.center
        out[p + "extent"] = md.extent
        out[p + "cone_axis"] = md.cone_axis
        out[p + "cone_cutoff"] = md.cone_cutoff
    return out


def arrays_to_baked_mesh(arrays: dict[str, np.ndarray]):
    from .bake import BakedMesh, LODData, MeshletData

    # npz round-trips scalars as 0-d or (1,) arrays depending on how they were
    # saved; ravel-index before scalar conversion (ndim>0 → int() is a NumPy
    # deprecation that will hard-error)
    _scalar = lambda a: np.asarray(a).ravel()[0]
    lods = []
    for i in range(int(_scalar(arrays["lod_count"]))):
        p = f"lod{i}_"
        md = MeshletData(
            vertex_offset=arrays[p + "vertex_offset"],
            vertex_count=arrays[p + "vertex_count"],
            triangle_offset=arrays[p + "triangle_offset"],
            triangle_count=arrays[p + "triangle_count"],
            indirect_vertices=arrays[p + "indirect_vertices"],
            local_triangles=arrays[p + "local_triangles"],
            center=arrays[p + "center"],
            extent=arrays[p + "extent"],
            cone_axis=arrays[p + "cone_axis"],
            cone_cutoff=arrays[p + "cone_cutoff"],
        )
        lods.append(
            LODData(
                meshlets=md,
                index_count=int(md.triangle_count.sum()) * 3,
                error=float(_scalar(arrays[p + "error"])),
            )
        )
    return BakedMesh(
        positions=arrays["positions"],
        normals=arrays["normals"],
        uvs=arrays["uvs"],
        lods=lods,
        aabb_min=arrays["aabb_min"],
        aabb_max=arrays["aabb_max"],
        material=int(_scalar(arrays["material"])),
    )


def compile_resources(manifest_path, output_path) -> dict:
    """rcli analog: read a manifest listing models/textures, bake everything, write
    one pack. Manifest (toml or json):

        [[models]]
        name = "sponza"
        path = "assets/sponza.glb"

        [[textures]]
        name = "noise"
        path = "assets/noise.png"
    """
    manifest_path = Path(manifest_path)
    if manifest_path.suffix == ".toml":
        import tomllib

        manifest = tomllib.loads(manifest_path.read_text())
    else:
        manifest = json.loads(manifest_path.read_text())

    from .bake import bake_mesh
    from .gltf import load_gltf
    from .texture import Texture

    entries: dict[str, dict[str, np.ndarray]] = {}
    base = manifest_path.parent
    for model in manifest.get("models", []):
        gltf = load_gltf(base / model["path"], load_images=False)
        for mi, prims in enumerate(gltf.meshes):
            for pi, prim in enumerate(prims):
                baked = bake_mesh(
                    prim.positions, prim.normals, prim.uvs, prim.indices, material=prim.material
                )
                entries[f"{model['name']}/mesh{mi}_{pi}"] = baked_mesh_to_arrays(baked)
    for tex in manifest.get("textures", []):
        t = Texture.load(base / tex["path"])
        entries[f"tex/{tex['name']}"] = {"pixels": t.pixels}

    save_pack(output_path, entries, meta={"source": str(manifest_path)})
    return {"entries": len(entries)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="oxpack", description="resource compiler (rcli analog)")
    ap.add_argument("manifest")
    ap.add_argument("-o", "--output", default="resources.oxpack")
    args = ap.parse_args(argv)
    info = compile_resources(args.manifest, args.output)
    print(f"packed {info['entries']} entries -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
