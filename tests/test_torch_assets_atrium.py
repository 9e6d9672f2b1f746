"""The port's atrium asset path (`oxylus_tpu_torch/assets/procgen.py`,
`assets/gltf.py`, `assets/texture.py`) against the JAX package's.

- `generate_atrium_glb(n_meshes=8, n_materials=4)` writes byte-identical GLBs
  from both packages, with equal summaries;
- `load_gltf` of it gives equal mesh arrays, materials, images, nodes and
  root nodes;
- a glTF whose nodes carry `matrix` (rotations that take each of the four
  quaternion reconstructions, scales, translations) loads to the same TRS in
  both packages: the port's `utils/math3d.mat3_to_quat` in place of the JAX
  one;
- the texture loader refuses the containers it does not port (KTX2, DDS)."""

import base64
import dataclasses
import json

import numpy as np
import pytest
import torch

from oxylus_tpu.assets import gltf as jgltf
from oxylus_tpu.assets import procgen as jprocgen
from oxylus_tpu_torch.assets import gltf as tgltf
from oxylus_tpu_torch.assets import procgen as tprocgen
from oxylus_tpu_torch.assets.texture import Texture

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def glbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("atrium")
    sj = jprocgen.generate_atrium_glb(d / "jax.glb", n_meshes=8, n_materials=4, seed=42)
    st = tprocgen.generate_atrium_glb(d / "port.glb", n_meshes=8, n_materials=4, seed=42)
    return d, sj, st


def test_atrium_glb_is_byte_identical(glbs):
    d, sj, st = glbs
    assert st == sj
    assert st["instances"] == 307 and st["meshes"] == 10
    assert (d / "port.glb").read_bytes() == (d / "jax.glb").read_bytes()


def _assert_models_equal(got, want):
    assert len(got.meshes) == len(want.meshes)
    for pg, pw in zip(got.meshes, want.meshes):
        assert len(pg) == len(pw)
        for a, b in zip(pg, pw):
            for f in ("positions", "normals", "uvs", "indices"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
                assert getattr(a, f).dtype == getattr(b, f).dtype
            assert a.material == b.material
    assert [dataclasses.asdict(m) for m in got.materials] == [dataclasses.asdict(m) for m in want.materials]
    assert len(got.images) == len(want.images)
    for a, b in zip(got.images, want.images):
        np.testing.assert_array_equal(a, b)
    assert len(got.nodes) == len(want.nodes)
    for a, b in zip(got.nodes, want.nodes):
        assert (a.name, a.mesh, a.children) == (b.name, b.mesh, b.children)
        for f in ("translation", "rotation", "scale"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f)
    assert got.root_nodes == want.root_nodes


def test_load_gltf_matches_jax(glbs):
    d, _, _ = glbs
    got, want = tgltf.load_gltf(d / "port.glb"), jgltf.load_gltf(d / "jax.glb")
    _assert_models_equal(got, want)
    assert {m.alpha_mode for m in got.materials} == {"OPAQUE", "MASK"}
    assert len(got.images) == 13  # 4 albedo, 4 normal, 4 metallic-roughness, 1 emissive


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


def test_node_matrices_give_the_jax_quaternions(tmp_path):
    """Rotations near identity (the w branch) and near 180° about x, y and z
    (the x, y and z branches), with scales and translations, as column-major
    `matrix` nodes of a .gltf with an embedded one-triangle buffer."""
    rng = np.random.default_rng(0)
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32).tobytes()
    nodes = []
    for axis, angle in [((0.2, 1, 0.1), 0.3), ((1, 0.1, 0.05), 3.1), ((0.1, 1, 0.2), 3.0), ((0.05, 0.1, 1), 3.12),
                        ((1, 1, 1), 2.0), ((0, 0, 1), -1.0)]:
        m = np.eye(4)
        m[:3, :3] = _rot(axis, angle) * rng.uniform(0.5, 2.0, 3)[None, :]
        m[:3, 3] = rng.uniform(-5, 5, 3)
        nodes.append({"mesh": 0, "matrix": [float(v) for v in m.T.reshape(-1)]})
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes,
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}}]}],
        "accessors": [{"bufferView": 0, "componentType": 5126, "count": 3, "type": "VEC3"}],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(tri)}],
        "buffers": [{"byteLength": len(tri), "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(tri).decode()}],
    }
    path = tmp_path / "matrices.gltf"
    path.write_text(json.dumps(doc))
    got, want = tgltf.load_gltf(path), jgltf.load_gltf(path)
    _assert_models_equal(got, want)
    for n in got.nodes:
        assert abs(np.linalg.norm(n.rotation) - 1.0) < 1e-6


def test_texture_containers_not_ported_raise(tmp_path):
    """The KTX2 and DDS readers refuse a file that is not their container with the
    JAX package's `ValueError` (`tests/test_torch_bcdec.py` holds what they read)."""
    from oxylus_tpu.assets.texture import Texture as JTexture

    for suffix, what in ((".ktx2", "not a KTX2 file"), (".dds", "not a DDS file")):
        p = tmp_path / f"t{suffix}"
        p.write_bytes(b"\0" * 128)
        for cls in (Texture, JTexture):
            with pytest.raises(ValueError, match=what):
                cls.load(p)
    arr = np.random.default_rng(1).integers(0, 256, (8, 6, 3), dtype=np.uint8)
    np.save(tmp_path / "t.npy", arr)
    tex = Texture.load(tmp_path / "t.npy")
    assert tex.pixels.shape == (8, 6, 4) and (tex.pixels[..., 3] == 255).all()
