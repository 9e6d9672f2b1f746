"""glTF 2.0 importer (JSON + .bin and .glb containers), dependency-free
(counterpart of `oxylus_tpu/assets/gltf.py`).

Covers what the Oxylus engine's fastgltf-based importer consumes
(`src/Asset/AssetManager_GLTF.cpp`): mesh primitives
(positions/normals/uvs/indices), PBR materials (metallic-roughness, textures),
embedded + external images, node hierarchy with TRS transforms. Sparse accessors and
Draco/meshopt compression are not supported (assets in tests are plain).
A node's `matrix` becomes TRS with the port's `utils/math3d.mat3_to_quat`.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import struct
from pathlib import Path

import numpy as np
import torch

from ..utils.math3d import mat3_to_quat

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclasses.dataclass
class GltfPrimitive:
    positions: np.ndarray  # (V, 3) f32
    normals: np.ndarray    # (V, 3) f32
    uvs: np.ndarray        # (V, 2) f32
    indices: np.ndarray    # (I,) u32
    material: int          # material index or -1


@dataclasses.dataclass
class GltfMaterial:
    name: str = ""
    base_color: tuple = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 1.0
    roughness: float = 1.0
    emissive: tuple = (0.0, 0.0, 0.0)
    base_color_texture: int = -1  # image index
    metallic_roughness_texture: int = -1
    normal_texture: int = -1
    emissive_texture: int = -1
    occlusion_texture: int = -1
    alpha_mode: str = "OPAQUE"
    alpha_cutoff: float = 0.5


@dataclasses.dataclass
class GltfNode:
    name: str
    mesh: int  # mesh index or -1
    children: list[int]
    translation: tuple
    rotation: tuple  # xyzw
    scale: tuple


@dataclasses.dataclass
class GltfModel:
    meshes: list[list[GltfPrimitive]]  # per mesh: list of primitives
    materials: list[GltfMaterial]
    images: list[np.ndarray]  # decoded RGBA8 arrays
    nodes: list[GltfNode]
    root_nodes: list[int]


def _read_glb(data: bytes) -> tuple[dict, bytes | None]:
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError("not a GLB file")
    offset = 12
    gltf_json = None
    binary = None
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # JSON
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # BIN
            binary = chunk
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, binary


def _load_buffers(doc: dict, base_dir: Path, glb_bin: bytes | None) -> list[bytes]:
    out = []
    for buf in doc.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(glb_bin or b"")
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            out.append((base_dir / uri).read_bytes())
    return out


def _read_accessor(doc: dict, buffers: list[bytes], idx: int) -> np.ndarray:
    acc = doc["accessors"][idx]
    count = acc["count"]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize * n_comp

    bv = doc["bufferViews"][acc["bufferView"]]
    data = buffers[bv["buffer"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", itemsize)

    if stride == itemsize:
        arr = np.frombuffer(data, dtype=dtype, count=count * n_comp, offset=start)
    else:
        raw = np.frombuffer(data, np.uint8)
        rows = np.stack([raw[start + i * stride : start + i * stride + itemsize] for i in range(count)])
        arr = rows.view(dtype).reshape(count * n_comp)
    arr = arr.reshape(count, n_comp) if n_comp > 1 else arr
    if acc.get("normalized") and dtype in (np.uint8, np.uint16):
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return np.array(arr)


def _decode_image(doc: dict, buffers: list[bytes], base_dir: Path, idx: int) -> np.ndarray:
    import io

    from PIL import Image

    img = doc["images"][idx]
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            raw = base64.b64decode(uri.split(",", 1)[1])
            pil = Image.open(io.BytesIO(raw))
        else:
            pil = Image.open(base_dir / uri)
    else:
        bv = doc["bufferViews"][img["bufferView"]]
        data = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0)
        pil = Image.open(io.BytesIO(data[start : start + bv["byteLength"]]))
    return np.asarray(pil.convert("RGBA"))


def load_gltf(path, asset_manager=None, load_images: bool = True) -> GltfModel:
    path = Path(path)
    base_dir = path.parent
    if path.suffix.lower() == ".glb":
        doc, glb_bin = _read_glb(path.read_bytes())
    else:
        doc = json.loads(path.read_text())
        glb_bin = None
    buffers = _load_buffers(doc, base_dir, glb_bin)

    meshes: list[list[GltfPrimitive]] = []
    for mesh in doc.get("meshes", []):
        prims = []
        for prim in mesh.get("primitives", []):
            attrs = prim["attributes"]
            pos = _read_accessor(doc, buffers, attrs["POSITION"]).astype(np.float32)
            v = pos.shape[0]
            normals = (
                _read_accessor(doc, buffers, attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (v, 1))
            )
            uvs = (
                _read_accessor(doc, buffers, attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else np.zeros((v, 2), np.float32)
            )
            if "indices" in prim:
                indices = _read_accessor(doc, buffers, prim["indices"]).astype(np.uint32).reshape(-1)
            else:
                indices = np.arange(v, dtype=np.uint32)
            prims.append(
                GltfPrimitive(
                    positions=pos,
                    normals=normals,
                    uvs=uvs,
                    indices=indices,
                    material=prim.get("material", -1),
                )
            )
        meshes.append(prims)

    materials = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})

        def tex_image(tex_info):
            if tex_info is None:
                return -1
            tex = doc["textures"][tex_info["index"]]
            return tex.get("source", -1)

        materials.append(
            GltfMaterial(
                name=m.get("name", ""),
                base_color=tuple(pbr.get("baseColorFactor", [1, 1, 1, 1])),
                metallic=pbr.get("metallicFactor", 1.0),
                roughness=pbr.get("roughnessFactor", 1.0),
                emissive=tuple(m.get("emissiveFactor", [0, 0, 0])),
                base_color_texture=tex_image(pbr.get("baseColorTexture")),
                metallic_roughness_texture=tex_image(pbr.get("metallicRoughnessTexture")),
                normal_texture=tex_image(m.get("normalTexture")),
                emissive_texture=tex_image(m.get("emissiveTexture")),
                occlusion_texture=tex_image(m.get("occlusionTexture")),
                alpha_mode=m.get("alphaMode", "OPAQUE"),
                alpha_cutoff=m.get("alphaCutoff", 0.5),
            )
        )

    images = []
    if load_images:
        for i in range(len(doc.get("images", []))):
            try:
                images.append(_decode_image(doc, buffers, base_dir, i))
            except Exception:  # noqa: BLE001 — image decode failures leave a placeholder
                images.append(np.full((4, 4, 4), 255, np.uint8))

    nodes = []
    for n in doc.get("nodes", []):
        if "matrix" in n:
            m = np.array(n["matrix"], np.float32).reshape(4, 4).T  # column-major → row-major
            t = m[:3, 3]
            sc = np.linalg.norm(m[:3, :3], axis=0)
            rot3 = m[:3, :3] / np.maximum(sc[None, :], 1e-12)
            # row-major rotation → quaternion (xyzw)
            q = mat3_to_quat(torch.from_numpy(np.ascontiguousarray(rot3))).numpy()
            trs = (tuple(t), tuple(q), tuple(sc))
        else:
            trs = (
                tuple(n.get("translation", [0, 0, 0])),
                tuple(n.get("rotation", [0, 0, 0, 1])),
                tuple(n.get("scale", [1, 1, 1])),
            )
        nodes.append(
            GltfNode(
                name=n.get("name", f"node_{len(nodes)}"),
                mesh=n.get("mesh", -1),
                children=list(n.get("children", [])),
                translation=trs[0],
                rotation=trs[1],
                scale=trs[2],
            )
        )
    scene_idx = doc.get("scene", 0)
    scenes = doc.get("scenes", [{}])
    root_nodes = list(scenes[scene_idx].get("nodes", [])) if scenes else []

    return GltfModel(meshes=meshes, materials=materials, images=images, nodes=nodes, root_nodes=root_nodes)
