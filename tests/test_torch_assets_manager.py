"""The port's asset manager and `.oxpack` container against the JAX package's.

The same files are imported by both managers (each reading the other's `.oxasset`
sidecars) and loaded for every asset type; payloads are compared. A pack written by
either package reads in the other, and `compile_resources` bakes the same entries."""

import importlib
import json
import logging
import wave

import numpy as np
import pytest
import torch
from PIL import Image

from oxylus_tpu.assets import manager as jman
from oxylus_tpu.assets import pack as jpack
from oxylus_tpu_torch.assets import manager as tman
from oxylus_tpu_torch.assets import pack as tpack

from tests.test_pack_gltf import write_test_gltf

torch.set_num_threads(1)
PKGS = {"jax": (jman, jpack), "port": (tman, tpack)}


def _write_wav(path, rate=22050, width=2, channels=1, seconds=0.05, seed=3):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    if width == 1:
        data = rng.integers(0, 256, (n, channels), dtype=np.uint8)
    else:
        dt = {2: np.int16, 4: np.int32}[width]
        data = rng.integers(np.iinfo(dt).min // 2, np.iinfo(dt).max // 2, (n, channels), dtype=dt)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


def make_assets(root):
    """One file of every importable type, plus a broken texture."""
    rng = np.random.default_rng(7)
    root.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (5, 6, 3), dtype=np.uint8), "RGB").save(root / "tex.png")
    np.save(root / "tex_raw.npy", rng.uniform(-0.2, 1.2, (4, 3, 4)).astype(np.float32))
    (root / "metal.oxmat").write_text(json.dumps({"albedo_color": [0.5, 0.25, 0.125, 1.0], "roughness_factor": 0.3}))
    write_test_gltf(root / "tri.gltf")
    (root / "level.json").write_text(json.dumps({"name": "lvl", "entities": []}))
    (root / "game.py").write_text("def on_scene_start(scene, env):\n    env['n'] = 1\n")
    _write_wav(root / "blip.wav")
    (root / "broken.png").write_bytes(b"not a png")
    return root


def _payload_view(kind, p):
    """Comparable form of a loaded payload."""
    if p is None:
        return None
    if kind == "Texture":
        return (p.name, p.pixels.tobytes(), p.pixels.shape, p.srgb)
    if kind == "Material":
        return json.dumps(p.to_json(), sort_keys=True)
    if kind == "Model":
        prims = [(q.positions.tobytes(), q.normals.tobytes(), q.uvs.tobytes(), q.indices.tobytes(), q.material)
                 for prims in p.meshes for q in prims]
        return (prims, [vars(m) for m in p.materials], [vars(n) for n in p.nodes], p.root_nodes,
                [i.tobytes() for i in p.images])
    if kind == "Audio":
        return (p.name, p.samples.tobytes(), p.samples.shape, p.sample_rate)
    return p  # scene dict, script text


@pytest.mark.parametrize("first", ["jax", "port"])
def test_import_and_load_every_type_matches_jax(tmp_path, first, caplog):
    """The package that imports first writes the sidecars; the other reads them
    and gets the same UUIDs. Every payload loads the same in both, and the broken
    file is logged and skipped by both."""
    root = make_assets(tmp_path / "assets")
    order = [first, "port" if first == "jax" else "jax"]
    managers = {name: PKGS[name][0].AssetManager() for name in order}
    found = {name: managers[name].scan_directory(root) for name in order}
    assert found["jax"] == found["port"] and len(found["port"]) == 8
    metas = sorted(p.name for p in root.glob("*.oxasset"))
    assert len(metas) == 8
    views, errors = {}, {}
    for name, mgr in managers.items():
        caplog.clear()
        with caplog.at_level(logging.ERROR, logger="oxylus.assets"):
            views[name] = {u: (mgr.get_asset(u).type.value, _payload_view(mgr.get_asset(u).type.value,
                                                                          mgr.load_asset(u)))
                           for u in found[name]}
        errors[name] = [r.getMessage().split(":")[0] for r in caplog.records]
    assert views["port"] == views["jax"]
    assert sorted(t for t, _ in views["port"].values()) == [
        "Audio", "Material", "Model", "Scene", "Script", "Texture", "Texture", "Texture"]
    assert sum(v is None for _, v in views["port"].values()) == 1  # the broken png
    assert errors["port"] == errors["jax"] and len(errors["port"]) == 1


def test_refcounts_and_typed_getters_match_jax(tmp_path):
    root = make_assets(tmp_path / "assets")
    out = []
    for name in ("jax", "port"):
        mgr = PKGS[name][0].AssetManager()
        tex = mgr.import_asset(root / "tex.png")
        mat = mgr.import_asset(root / "metal.oxmat")
        model = mgr.import_asset(root / "tri.gltf")
        seen = [mgr.import_asset(root / "missing.png"), mgr.load_asset("no-such-uuid"), mgr.unload_asset(tex)]
        mgr.load_asset(tex)
        mgr.load_asset(tex)
        seen += [mgr.get_asset(tex).ref_count, mgr.get_texture(tex) is not None, mgr.unload_asset(tex),
                 mgr.get_asset(tex).is_loaded, mgr.unload_asset(tex), mgr.get_asset(tex).is_loaded,
                 mgr.get_texture(tex), len(mgr.textures)]
        mgr.load_asset(mat)
        mgr.load_asset(model)
        seen += [mgr.get_material(mat).roughness_factor, len(mgr.get_model(model).meshes),
                 [u for u, _ in mgr.loaded_of_type(mgr.get_asset(mat).type)] == [mat],
                 sorted(a.type.value for a in mgr.registry_snapshot())]
        reg = mgr.register_asset(tex, mgr.get_asset(tex).type, "elsewhere.png")
        seen.append(reg.path)
        mgr.deinit()
        seen.append(mgr.get_asset(tex))
        out.append(seen)
    assert out[1] == out[0]


def _mesh_arrays(pack_mod):
    from tests.test_render3d import cube_mesh

    bake = importlib.import_module(pack_mod.__name__.replace(".pack", ".bake"))
    return pack_mod.baked_mesh_to_arrays(bake.bake_mesh(*cube_mesh()))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pack_written_by_either_reads_in_both(tmp_path, writer):
    wpack = PKGS[writer][1]
    entries = {"cube/mesh0_0": _mesh_arrays(wpack), "tex/noise": {
        "pixels": np.random.default_rng(1).integers(0, 256, (8, 8, 4), dtype=np.uint8)}}
    wpack.save_pack(tmp_path / "p.oxpack", entries, meta={"by": writer})
    loaded = [PKGS[name][1].load_pack(tmp_path / "p.oxpack") for name in ("jax", "port")]
    for got, meta in loaded:
        assert meta == {"by": writer} and set(got) == set(entries)
        for name, arrays in entries.items():
            assert set(got[name]) == set(arrays)
            for k, v in arrays.items():
                np.testing.assert_array_equal(got[name][k], v)
                assert got[name][k].dtype == np.asarray(v).dtype
    # the baked mesh round-trips through either package's reader
    meshes = [PKGS[name][1].arrays_to_baked_mesh(got["cube/mesh0_0"]) for name, (got, _) in zip(("jax", "port"), loaded)]
    for a, b in zip(*(tpack.baked_mesh_to_arrays(m).items() for m in meshes)):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])


def test_the_baked_cube_packs_the_same_arrays():
    j, t = _mesh_arrays(jpack), _mesh_arrays(tpack)
    assert list(t) == list(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["toml", "json"])
def test_compile_resources_matches_jax(tmp_path, fmt):
    src = tmp_path / "src"
    make_assets(src)
    models, textures = [{"name": "tri", "path": "src/tri.gltf"}], [{"name": "noise", "path": "src/tex.png"}]
    if fmt == "toml":
        text = "".join(f'[[{sec}]]\nname = "{e["name"]}"\npath = "{e["path"]}"\n\n'
                       for sec, lst in (("models", models), ("textures", textures)) for e in lst)
    else:
        text = json.dumps({"models": models, "textures": textures})
    manifest = tmp_path / f"manifest.{fmt}"
    manifest.write_text(text)
    infos = [jpack.compile_resources(manifest, tmp_path / "j.oxpack"),
             tpack.main([str(manifest), "-o", str(tmp_path / "t.oxpack")])]
    assert infos == [{"entries": 2}, 0]
    (je, jm), (te, tm) = jpack.load_pack(tmp_path / "j.oxpack"), tpack.load_pack(tmp_path / "t.oxpack")
    assert jm == tm and list(te) == list(je) == ["tri/mesh0_0", "tex/noise"]
    for name in je:
        assert list(te[name]) == list(je[name])
        for k in je[name]:
            np.testing.assert_array_equal(te[name][k], je[name][k], err_msg=f"{name}/{k}")


def test_compile_resources_refuses_ktx2_by_name(tmp_path):
    """A BasisLZ-supercompressed KTX2 member is refused, naming the file, by both
    packages' resource compilers (`tests/test_torch_bcdec.py` packs readable ones)."""
    import struct

    from oxylus_tpu_torch.assets.texture import _KTX2_MAGIC

    header = _KTX2_MAGIC + struct.pack("<9I", 37, 1, 4, 4, 0, 0, 1, 1, 1) + struct.pack("<4I2Q", 0, 0, 0, 0, 0, 0)
    (tmp_path / "t.ktx2").write_bytes(header + struct.pack("<3Q", 104, 64, 64) + bytes(64))
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps({"textures": [{"name": "t", "path": "t.ktx2"}]}))
    for pack in (tpack, jpack):
        with pytest.raises(ValueError, match=r"t\.ktx2: BasisLZ"):
            pack.compile_resources(manifest, tmp_path / "out.oxpack")


def test_scene_loader_loads_requested_assets(tmp_path):
    """`scene_from_json(asset_manager=...)` loads each requested asset once and
    warns about ghosts, as the JAX loader does."""
    from oxylus_tpu.scene import serialize as jser
    from oxylus_tpu_torch.scene import serialize as tser

    root = make_assets(tmp_path / "assets")
    out = []
    for (man, _), ser, kw in ((PKGS["jax"], jser, {}), (PKGS["port"], tser, {"device": "cpu"})):
        mgr = man.AssetManager()
        tex = mgr.import_asset(root / "tex.png")
        script = mgr.import_asset(root / "game.py")
        obj = {"name": "s", "scripts": [{"uuid": script}, {"uuid": "00000000-0000-0000-0000-00000000abcd"}],
               "entities": [{"name": "e", "components": [
                   {"Core.TransformComponent": {}},
                   {"Core.SpriteComponent": {"material": tex}},
                   {"Core.MeshComponent": {"material_uuid": tex, "model_uuid": "00000000-0000-0000-0000-000000000000"}},
               ]}]}
        scene = ser.scene_from_json(obj, asset_manager=mgr, **kw)
        out.append((scene.script_uuids, mgr.get_asset(tex).ref_count, mgr.get_asset(script).ref_count,
                    mgr.get_asset(script).is_loaded))
    assert out[1] == out[0] and out[1][1:] == (1, 1, True)
