"""The port's material tables and texture sampling (`oxylus_tpu_torch/ops/sampling.py`,
`assets/material.py`, `assets/texture.py`) against the JAX package's.

- `pack_materials` field by field and `pack_material_tables` exactly, on a
  table with every texture kind, shared and distinct occlusion rects, the
  alpha modes, uv transforms and unknown texture names;
- `TextureAtlas.pack_tight`: rects and pixels exactly;
- `pack_atlas_taps` as bfloat16: bits equal;
- `sample_material_textures` for each feature and `perturb_normal` on seeded
  UVs (wrapped past [0, 1], mirrored by a negative uv scale) and rows (as the
  renderer reads them: float16 rows widened to float32), within 1e-6;
- the textured route's float16 material rows per slot against the JAX
  package's (carried in its 115-lane `build_tile_comb` rows and gathered by
  `pack_tile_blocks`), and the port's 83-lane rows and slot tables, exactly;
- the linear upsamples the textured G-buffer and the masked pass take
  (`utils/imgops.resize_linear`, 2× and 4× from odd sizes, as `point_downsample`
  leaves them) against `jax.image.resize(method="linear")`.

The JAX functions run op by op (eager), as the port's do."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.assets import material as jmat
from oxylus_tpu.assets.texture import Texture as JTexture
from oxylus_tpu.assets.texture import TextureAtlas as JAtlas
from oxylus_tpu.ops import raster3d as jr
from oxylus_tpu.ops import sampling as js
from oxylus_tpu_torch.assets import material as tmat
from oxylus_tpu_torch.assets.texture import Texture, TextureAtlas
from oxylus_tpu_torch.ops import raster3d as tr
from oxylus_tpu_torch.ops import sampling as ts
from oxylus_tpu_torch.render import renderer3d
from oxylus_tpu_torch.utils.imgops import point_downsample, resize_linear

torch.set_num_threads(1)

TOL = 1e-6
# the JAX resize contracts with float32 weights it normalises, PyTorch lerps:
# off an exact 2× or 4× (odd sizes) the two round differently, by a few ulps
# of the values (≤ 1 here)
RESIZE_TOL = 4e-6


def _textures(seed=0):
    rng = np.random.default_rng(seed)
    sizes = [(16, 16), (32, 8), (8, 24), (20, 20), (12, 12), (40, 16), (4, 4)]
    return {f"t{i}": rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for i, (h, w) in enumerate(sizes)}


def _materials(mod):
    """Seven materials over the textures t0..t6 (a module's `Material`)."""
    M = mod.Material
    return [
        M(albedo_color=(0.9, 0.5, 0.2, 1.0), albedo_texture="t0", normal_texture="t1",
          metallic_roughness_texture="t2", occlusion_texture="t2", emissive_texture="t3",
          emissive_color=(1.0, 2.0, 0.5), metallic_factor=0.7, roughness_factor=0.4),
        M(albedo_texture="t4", alpha_mode=mod.ALPHA_MASK, alpha_cutoff=0.5, uv_size=(-1.0, 1.0)),
        M(metallic_roughness_texture="t5", occlusion_texture="t6", uv_size=(2.0, 3.0), uv_offset=(0.25, -0.5)),
        M(albedo_texture="missing", normal_texture="t1", alpha_mode=mod.ALPHA_BLEND),
        M(emissive_texture="t3", sampling_mode=mod.SAMPLE_NEAREST_CLAMPED),
        M(albedo_texture="t6", normal_texture="t0", metallic_roughness_texture="t5", occlusion_texture="t5",
          alpha_mode=mod.ALPHA_MASK, alpha_cutoff=0.3),
        M(),
    ]


@pytest.fixture(scope="module")
def tables():
    tex = _textures()
    j_px, j_rects = JAtlas.pack_tight({k: JTexture(name=k, pixels=v) for k, v in tex.items()})
    t_px, t_rects = TextureAtlas.pack_tight({k: Texture(name=k, pixels=v) for k, v in tex.items()})
    jm = jmat.pack_materials(_materials(jmat), j_rects, 16)
    tm = tmat.pack_materials(_materials(tmat), t_rects, 16, device="cpu")
    return {"j_px": j_px, "j_rects": j_rects, "t_px": t_px, "t_rects": t_rects, "jm": jm, "tm": tm}


def test_pack_tight_matches_jax(tables):
    np.testing.assert_array_equal(tables["t_px"], tables["j_px"])
    assert tables["t_rects"] == tables["j_rects"]
    assert tables["t_px"].shape[0] % 128 == 0


def test_pack_materials_matches_jax_field_by_field(tables):
    jm, tm = tables["jm"], tables["tm"]
    for name in tmat.GPU_MATERIAL_FIELDS:
        got, want = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        if name == "flags":
            assert got.dtype == np.int32 and want.dtype == np.uint32
            want = want.astype(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tm.flags.device.type == "cpu"
    for name in ("ALPHA_OPAQUE", "ALPHA_MASK", "ALPHA_BLEND", "SAMPLE_LINEAR_REPEATED", "SAMPLE_LINEAR_CLAMPED",
                 "SAMPLE_NEAREST_REPEATED", "SAMPLE_NEAREST_CLAMPED", "SAMPLE_LINEAR_REPEATED_ANISO"):
        assert getattr(tmat, name) == getattr(jmat, name), name
    m = _materials(tmat)[0]
    assert tmat.Material.from_json(m.to_json()) == m


def test_pack_material_tables_matches_jax(tables):
    got = ts.pack_material_tables(tables["tm"]).numpy()
    want = np.asarray(js.pack_material_tables(tables["jm"]))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (16, 32)
    assert got[0, 24] == 1.0 and got[2, 24] == 0.0 and got[5, 24] == 1.0  # occlusion shared, distinct, shared
    assert got[1, 26] == 1.0 and got[5, 26] == 1.0 and got[3, 8] == 0.0  # masked; an unknown texture name


def test_pack_atlas_taps_bf16_bits_match_jax(tables):
    got = ts.pack_atlas_taps(torch.from_numpy(tables["t_px"]), dtype=torch.bfloat16)
    want = np.asarray(js.pack_atlas_taps(jnp.asarray(tables["j_px"]), dtype=jnp.bfloat16))
    assert got.shape == want.shape == (tables["t_px"].shape[0] ** 2, 16)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    got32 = ts.pack_atlas_taps(torch.from_numpy(tables["t_px"])).numpy()
    np.testing.assert_array_equal(got32, np.asarray(js.pack_atlas_taps(jnp.asarray(tables["j_px"]))))


def _uvs_and_rows(tables, n=4096, seed=1):
    rng = np.random.default_rng(seed)
    rows32 = np.asarray(js.pack_material_tables(tables["jm"]))
    # the renderer's rows ride the slot tables as float16
    rows = rows32.astype(np.float16).astype(np.float32)[rng.integers(0, 7, n)]
    uv = rng.uniform(-2.0, 3.0, (n, 2)).astype(np.float32)  # wrapped past [0, 1]
    uv[: n // 8] = rng.uniform(0, 1, (n // 8, 2)).astype(np.float32)
    uv[n // 8 : n // 4] = np.round(uv[n // 8 : n // 4] * 16) / 16  # on texel corners
    return uv, rows


@pytest.mark.parametrize("feature", ["albedo", "normal", "mr", "emissive"])
def test_sample_material_textures_matches_jax(tables, feature):
    uv, rows = _uvs_and_rows(tables)
    a = tables["t_px"].shape[0]
    taps_t = ts.pack_atlas_taps(torch.from_numpy(tables["t_px"]), dtype=torch.bfloat16)
    taps_j = js.pack_atlas_taps(jnp.asarray(tables["j_px"]), dtype=jnp.bfloat16)
    got = ts.sample_material_textures(torch.from_numpy(rows), taps_t, a, torch.from_numpy(uv), features=(feature,))
    want = js.sample_material_textures(jnp.asarray(rows), taps_j, a, jnp.asarray(uv), features=(feature,))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=TOL, err_msg=k)
    sampled = {"albedo": "albedo_rgb", "normal": "normal_ts", "mr": "mr", "emissive": "emissive_rgb"}[feature]
    assert np.ptp(np.asarray(want[sampled])) > 0.1  # the feature was sampled, not defaulted


def test_perturb_normal_matches_jax():
    rng = np.random.default_rng(2)
    n = rng.normal(size=(2048, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t = rng.normal(size=(2048, 3)).astype(np.float32)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    hand = rng.choice(np.array([1.0, 0.5, 0.0], np.float32), 2048)  # +1, -1 (mirrored), no tangent frame
    t = t * hand[:, None]
    ts_n = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    ts_n[:, 2] = np.abs(ts_n[:, 2]) + 0.2
    got = ts.perturb_normal(torch.from_numpy(n), torch.from_numpy(t), torch.from_numpy(ts_n)).numpy()
    want = np.asarray(js.perturb_normal(jnp.asarray(n), jnp.asarray(t), jnp.asarray(ts_n)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[hand == 0.0], n[hand == 0.0])  # no frame: the normal is kept


def test_wrap_uv_matches_jax():
    rng = np.random.default_rng(3)
    uv = rng.uniform(-3, 3, (512, 2)).astype(np.float32)
    mode = rng.integers(0, 5, 512).astype(np.int32)
    got = ts._wrap_uv(torch.from_numpy(uv), torch.from_numpy(mode)).numpy()
    np.testing.assert_array_equal(got, np.asarray(js._wrap_uv(jnp.asarray(uv), jnp.asarray(mode))))


def test_tile_comb_material_rows_match_jax(tables):
    """The textured route's per-slot material rows: the JAX package carries
    them in its 115-lane comb and gathers a float16 slot table from it; the
    port reads the float16 rows through its material slot table
    (`renderer3d._textured_rows`). Equal at every entry, and the port's
    83-lane comb and three slot tables equal the JAX comb's first 83 lanes and
    its first three tables."""
    rng = np.random.default_rng(4)
    g, r = 6, 64
    valid = rng.uniform(size=(g, r)) < 0.7
    dense = {
        "tri_valid": valid,
        "coeffs": rng.normal(size=(g, r, 5, 3)).astype(np.float32),
        "attr_planes": rng.normal(size=(g, r, 9, 3)).astype(np.float32),
        "tri_z": np.where(valid, rng.uniform(0, 1, (g, r)), -1.0).astype(np.float32),
        "slot_material": np.repeat(rng.integers(0, 7, (g, 1)), r, 1).astype(np.int32),
        "slot_instance": np.repeat(rng.integers(0, 9, (g, 1)), r, 1).astype(np.int32),
        "packed_id": np.where(valid, rng.integers(0, 1 << 20, (g, r)), -1).astype(np.int32),
    }
    consts = rng.normal(size=(g, r, 8)).astype(np.float32)
    rows_j = js.pack_material_tables(tables["jm"])
    comb_j, n_row = jr.build_tile_comb({k: jnp.asarray(v) for k, v in dense.items()}, jnp.asarray(consts), rows_j)
    comb_t = tr.build_tile_comb({k: torch.from_numpy(v) for k, v in dense.items()}, torch.from_numpy(consts))
    assert n_row == 32 and comb_t.shape == (g * r, tr.COMB_W) and comb_j.shape == (g * r, tr.COMB_W + n_row)
    np.testing.assert_array_equal(comb_t.numpy(), np.asarray(comb_j)[:, : tr.COMB_W])
    entries = np.full((4, 128), -1, np.int32)
    for t in range(4):
        k = int(rng.integers(0, 129))
        entries[t, :k] = rng.integers(0, g * r, k)
    got = tr.pack_tile_blocks(torch.from_numpy(entries), comb_t)["tables"]
    want = jr.pack_tile_blocks(None, jnp.asarray(entries), comb=(comb_j, n_row))["tables"]
    assert len(got) == 3 and len(want) == 4 and want[3].dtype == jnp.float16
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    have = entries.reshape(-1) >= 0
    rows_t = renderer3d._textured_rows(tables["tm"])[got[0].long()]
    np.testing.assert_array_equal(rows_t.numpy()[have], np.asarray(want[3]).astype(np.float32)[have])


@pytest.mark.parametrize("shape", [(64, 96), (65, 97), (37, 53)], ids=["even", "odd", "odd2"])
def test_upsamples_match_jax_resize(shape):
    """The masked pass's alpha margin (one channel, 2×) and the packed
    upsamples (several channels, 2× and 4×), from the point-downsampled sizes."""
    h, w = shape
    rng = np.random.default_rng(h * w)
    full = rng.uniform(-1, 1, (h, w, 6)).astype(np.float32)
    for k, chans in ((2, 1), (2, 6), (4, 5)):
        small = point_downsample(torch.from_numpy(full[..., :chans]), k)
        img = small[..., 0] if chans == 1 else small
        out_shape = (h, w) if chans == 1 else (h, w, chans)
        got = resize_linear(img, out_shape).numpy()
        want = np.asarray(jax.image.resize(jnp.asarray(img.numpy()), out_shape, method="linear"))
        np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL, err_msg=f"{k}x {chans} channels")


def test_distinct_occlusion_rect_is_not_sampled(tables):
    """ROADMAP C, a reference defect reproduced: on the G-buffer path the
    occlusion map is read only from the metallic-roughness tap, when it
    shares the MR rect (`oxylus_tpu/ops/sampling.py:153-155`). Material 2's
    occlusion texture has a rect of its own, so its occlusion stays 1 in both
    packages though the texture is bound."""
    rows = ts.pack_material_tables(tables["tm"])[2:3].expand(64, 32)
    assert int(tables["tm"].flags[2]) & tmat.FLAG_HAS_OCCLUSION
    uv = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (64, 2)).astype(np.float32))
    a = tables["t_px"].shape[0]
    got = ts.sample_material_textures(rows, ts.pack_atlas_taps(torch.from_numpy(tables["t_px"])), a, uv,
                                      features=("mr",))
    want = js.sample_material_textures(jnp.asarray(rows.numpy()), js.pack_atlas_taps(jnp.asarray(tables["j_px"])),
                                       a, jnp.asarray(uv.numpy()), features=("mr",))
    assert (got["occlusion"] == 1.0).all() and (np.asarray(want["occlusion"]) == 1.0).all()
    assert got["mr"].std() > 0.05  # the MR texture itself is sampled
