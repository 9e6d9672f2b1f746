"""The port's BC decoder and KTX2/DDS readers against the JAX package's: every BC
format's decode exactly on seeded blocks, the containers through `Texture.load` (the
same pixels and srgb flag), every refusal as a `ValueError` in both packages, a
resource pack with a `.ktx2` and a `.dds` member, and the importer's typing quirk."""

import json
import struct

import numpy as np
import pytest
import torch

from oxylus_tpu.assets import bcdec as jbc
from oxylus_tpu.assets import manager as jman
from oxylus_tpu.assets import pack as jpack
from oxylus_tpu.assets import texture as jtex
from oxylus_tpu_torch.assets import bcdec as tbc
from oxylus_tpu_torch.assets import manager as tman
from oxylus_tpu_torch.assets import pack as tpack
from oxylus_tpu_torch.assets import texture as ttex

torch.set_num_threads(1)


def _blocks(rng, w, h, nbytes):
    return rng.integers(0, 256, ((h + 3) // 4) * ((w + 3) // 4) * nbytes, dtype=np.uint8)


def _bc7_blocks(rng, w, h):
    """Seeded BC7 blocks cycling through modes 0–7 and the reserved mode 8."""
    blocks = _blocks(rng, w, h, 16).reshape(-1, 16)
    for i in range(blocks.shape[0]):
        m = i % 9
        blocks[i, 0] = 0 if m == 8 else (blocks[i, 0] & ~np.uint8((1 << (m + 1)) - 1)) | np.uint8(1 << m)
    return blocks.tobytes()


@pytest.mark.parametrize("w,h", [(32, 32), (20, 14)])
def test_every_bc_format_decodes_as_jax(w, h):
    rng = np.random.default_rng(w * 100 + h)
    cases = (("decode_bc1", 8), ("decode_bc3", 16), ("decode_bc4", 8), ("decode_bc5", 16))
    for fn, nbytes in cases:
        data = _blocks(rng, w, h, nbytes).tobytes()
        want = getattr(jbc, fn)(data, w, h)
        got = getattr(tbc, fn)(data, w, h)
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (h, w, 4), fn
        np.testing.assert_array_equal(got, want, err_msg=fn)
    data = _bc7_blocks(rng, w, h)
    np.testing.assert_array_equal(tbc.decode_bc7(data, w, h), jbc.decode_bc7(data, w, h))


def test_vkformat_dispatch_matches_jax():
    rng = np.random.default_rng(1)
    for vk in list(range(128, 150)) + [23, 37]:
        nbytes = 8 if vk in (131, 132, 133, 134, 139, 140) else 16
        data = _bc7_blocks(rng, 8, 8) if vk in (145, 146) else _blocks(rng, 8, 8, nbytes).tobytes()
        want, got = jbc.decode_bc_vkformat(vk, data, 8, 8), tbc.decode_bc_vkformat(vk, data, 8, 8)
        assert (got is None) == (want is None), vk
        if want is not None:
            np.testing.assert_array_equal(got[0], want[0], err_msg=str(vk))
            assert got[1] is want[1]


def _ktx2(path, vk, blob, w, h, scheme=0, uncomp=None):
    header = ttex._KTX2_MAGIC + struct.pack("<9I", vk, 1, w, h, 0, 0, 1, 1, scheme)
    header += struct.pack("<4I2Q", 0, 0, 0, 0, 0, 0)
    path.write_bytes(header + struct.pack("<3Q", 104, len(blob), len(blob) if uncomp is None else uncomp) + blob)
    return path


def _dds(path, pixels, masks, fourcc=0, bits=32):
    h, w = pixels.shape[:2]
    header = struct.pack("<4s7I44x", b"DDS ", 124, 0x100F, h, w, w * 4, 0, 0)
    header += struct.pack("<8I", 32, 0x41 if masks[3] else 0x40, fourcc, bits, *masks)
    header += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    path.write_bytes(header + pixels.tobytes())
    return path


def _load_both(path, **kw):
    want, got = jtex.Texture.load(path, **kw), ttex.Texture.load(path, **kw)
    assert got.name == want.name and got.srgb == want.srgb and got.pixels.dtype == np.uint8
    np.testing.assert_array_equal(got.pixels, want.pixels)
    return got


def test_ktx2_textures_load_as_jax(tmp_path):
    rng = np.random.default_rng(2)
    rgba = rng.integers(0, 256, (12, 10, 4), dtype=np.uint8)
    rgb = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    cases = []
    for srgb in (True, False):
        for mod in (jtex, ttex):
            mod.write_ktx2(tmp_path / f"w_{mod.__name__}_{srgb}.ktx2", rgba, srgb=srgb)
        assert (tmp_path / f"w_{jtex.__name__}_{srgb}.ktx2").read_bytes() == (
            tmp_path / f"w_{ttex.__name__}_{srgb}.ktx2").read_bytes()
        cases.append((tmp_path / f"w_{ttex.__name__}_{srgb}.ktx2", srgb))
    ttex.write_ktx2(tmp_path / "rgb3.ktx2", rgb, srgb=False)  # written as RGBA8
    cases.append((tmp_path / "rgb3.ktx2", False))
    cases.append((_ktx2(tmp_path / "rgb8.ktx2", 29, rgb.tobytes(), 7, 9), True))
    ttex.write_ktx2(tmp_path / "z.ktx2", rgba, srgb=True, zstd=True)
    cases.append((tmp_path / "z.ktx2", True))
    cases.append((_ktx2(tmp_path / "bc7.ktx2", 146, _bc7_blocks(rng, 16, 12), 16, 12), True))
    cases.append((_ktx2(tmp_path / "bc1.ktx2", 131, _blocks(rng, 8, 8, 8).tobytes(), 8, 8), False))
    for path, srgb_fmt in cases:
        for srgb in (True, False):
            tex = _load_both(path, srgb=srgb)
            assert tex.srgb == (srgb and srgb_fmt), path
    np.testing.assert_array_equal(ttex.Texture.load(tmp_path / "z.ktx2").pixels, rgba)
    np.testing.assert_array_equal(ttex.Texture.load(tmp_path / "rgb8.ktx2").pixels[..., :3], rgb)


def test_dds_textures_load_as_jax(tmp_path):
    rng = np.random.default_rng(3)
    px = rng.integers(0, 256, (6, 9, 4), dtype=np.uint8)
    bgra = (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    rgba = (0xFF, 0xFF00, 0xFF0000, 0xFF000000)
    for name, masks in (("bgra", bgra), ("rgba", rgba), ("bgrx", bgra[:3] + (0,))):
        tex = _load_both(_dds(tmp_path / f"{name}.dds", px, masks))
        assert tex.srgb is True
        if name == "bgra":
            np.testing.assert_array_equal(tex.pixels, px[..., [2, 1, 0, 3]])
        if name == "bgrx":
            assert (tex.pixels[..., 3] == 255).all()


def test_every_refusal_raises_value_error_in_both(tmp_path):
    rng = np.random.default_rng(4)
    blob = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    px = rng.integers(0, 256, (4, 4, 4), dtype=np.uint8)
    cases = [
        (_ktx2(tmp_path / "basis.ktx2", 37, blob, 4, 4, scheme=1), "BasisLZ"),
        (_ktx2(tmp_path / "scheme3.ktx2", 37, blob, 4, 4, scheme=3), "supercompression scheme 3"),
        (_ktx2(tmp_path / "r16.ktx2", 70, blob, 4, 4), "unsupported vkFormat 70"),
        (_ktx2(tmp_path / "bc2.ktx2", 135, blob, 4, 4), "BC vkFormat 135"),
        (_ktx2(tmp_path / "bc6h.ktx2", 143, blob, 4, 4), "BC vkFormat 143"),
        (_dds(tmp_path / "dxt1.dds", px, (0, 0, 0, 0), fourcc=0x31545844), "compressed DDS"),
        (_dds(tmp_path / "rgb24.dds", px, (0xFF, 0xFF00, 0xFF0000, 0), bits=24), "32-bit"),
    ]
    (tmp_path / "junk.ktx2").write_bytes(bytes(128))
    (tmp_path / "junk.dds").write_bytes(bytes(128))
    cases += [(tmp_path / "junk.ktx2", "not a KTX2 file"), (tmp_path / "junk.dds", "not a DDS file")]
    for path, what in cases:
        for cls in (jtex.Texture, ttex.Texture):
            with pytest.raises(ValueError, match=what):
                cls.load(path)


def test_compile_resources_with_ktx2_and_dds_gives_the_jax_members(tmp_path):
    rng = np.random.default_rng(5)
    ttex.write_ktx2(tmp_path / "a.ktx2", rng.integers(0, 256, (8, 12, 4), dtype=np.uint8))
    _ktx2(tmp_path / "b.ktx2", 145, _bc7_blocks(rng, 8, 8), 8, 8)
    _dds(tmp_path / "c.dds", rng.integers(0, 256, (5, 7, 4), dtype=np.uint8), (0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    manifest = tmp_path / "m.json"
    manifest.write_text(json.dumps({"textures": [{"name": n, "path": p} for n, p in
                                                 (("a", "a.ktx2"), ("b", "b.ktx2"), ("c", "c.dds"))]}))
    infos = [jpack.compile_resources(manifest, tmp_path / "j.oxpack"),
             tpack.compile_resources(manifest, tmp_path / "t.oxpack")]
    assert infos[0] == infos[1]
    (je, jm), (te, tm) = jpack.load_pack(tmp_path / "j.oxpack"), tpack.load_pack(tmp_path / "t.oxpack")
    assert jm == tm and list(te) == list(je) and len(je) == 3
    for name in je:
        assert list(te[name]) == list(je[name])
        for k in je[name]:
            np.testing.assert_array_equal(te[name][k], je[name][k], err_msg=f"{name}/{k}")


def test_import_types_ktx2_and_dds_as_none_in_both(tmp_path):
    """Reference quirk kept: the importer's extension table has no `.ktx2`/`.dds`, so
    without a sidecar they register as `NONE` (and load as nothing) in both packages;
    with a `Texture` sidecar they load through `Texture.load`."""
    ttex.write_ktx2(tmp_path / "t.ktx2", np.full((4, 4, 4), 7, np.uint8))
    _dds(tmp_path / "d.dds", np.full((4, 4, 4), 9, np.uint8), (0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    for name in ("t.ktx2", "d.dds"):
        for man in (jman, tman):
            am = man.AssetManager()
            u = am.import_asset(tmp_path / name)
            assert am.get_asset(u).type == man.AssetType.NONE, (name, man.__name__)
            man.AssetManager.meta_path(tmp_path / name).unlink()
    for man in (jman, tman):
        am = man.AssetManager()
        man.AssetManager.meta_path(tmp_path / "t.ktx2").write_text(
            json.dumps({"uuid": "00000000-0000-0001-0000-000000000002", "type": "Texture"}))
        u = am.import_asset(tmp_path / "t.ktx2")
        assert am.get_asset(u).type == man.AssetType.TEXTURE and am.load_asset(u) is not None
        assert (am.load_asset(u).pixels == 7).all()
