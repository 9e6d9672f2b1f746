"""The decode path's functions (`RenderSpec(use_pallas=False)`) against the JAX
package's, on the CPU.

- `raster3d.rasterize_reference` against the jitted JAX function on the
  golden scene (`tests/test_golden_images.py::_world`: its setup, coefficient
  matrix and 64-px meshlet lists from the JAX package), and on a tied case
  (a meshlet listed twice in a tile, two slots with equal planes): depth
  within 1e-6, vid equal on ≥ 99.9 % of pixels (in fact on all: the port
  rounds the planes as XLA's CPU dot does, a fused multiply-add chain);
  walking the pairs in chunks changes nothing.
- `decode3d.decode_visbuffer` on the same vid and setup. With the golden
  scene's own materials, against the jitted JAX function: `hit` equal and
  every plane within 1e-5 where a pixel is hit; at a miss every plane but
  the UV is a constant, and the UV there is extrapolated from meshlet 0's
  slot 0, which no consumer reads, where the jit's fused multiply-adds move
  it by up to ~2e-5 of its size: held to 1e-4 relative. With the two
  instances given textured materials over the atlas of
  `tests/test_albedo_modulation.py` (every map, one material repeating and
  linear, one clamped and nearest), against the JAX function op by op
  (`jax.disable_jit()`, the repo's rule for the port, ROADMAP C "Op-by-op
  rounding"; its dots still round as fused multiply-add chains, as the port's
  do): every plane within 1e-6 at every pixel. The jitted function itself
  moves the textured planes by up to ~2.2e-4 from its op-by-op run: its
  barycentrics differ in the last bits and the texel density (128 texels
  over the rect, the UV doubled) scales that.
- `sampling.sample_atlas_bilinear` against the JAX function on
  `tests/test_albedo_modulation.py`'s three cases, and with each wrap and
  filter mode at UVs outside [0, 1]: within 1e-6."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.assets.material import Material, empty_gpu_materials, pack_materials
from oxylus_tpu.ops import raster3d as jr
from oxylus_tpu.ops import sampling as js
from oxylus_tpu.ops import setup3d as jset
from oxylus_tpu.ops.cull import cull_instances, cull_meshlets, expand_meshlet_instances
from oxylus_tpu.ops.decode3d import decode_visbuffer as jdecode
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.ops import raster3d as tr
from oxylus_tpu_torch.ops import raster_depth
from oxylus_tpu_torch.ops import sampling as ts
from oxylus_tpu_torch.ops.decode3d import decode_visbuffer
from tests import test_albedo_modulation as albedo_case
from tests.test_golden_images import H, W, _world

torch.set_num_threads(1)

DEPTH_TOL, VID_EQ_MIN, PLANE_TOL, MISS_UV_REL, SAMPLE_TOL = 1e-6, 0.999, 1e-5, 1e-4, 1e-6
OP_TOL = 1e-6


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _textured_materials():
    """The albedo case's atlas, and two materials sampling all of it: one
    repeating linearly at twice the UV, one clamped and nearest."""
    rng = np.random.default_rng(3)
    from oxylus_tpu.assets.texture import Texture, TextureAtlas

    atlas = TextureAtlas(size=128)
    for i in range(4):
        px = rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)
        atlas.add(f"t{i}", Texture(name=f"t{i}", pixels=px))
    pixels, rects = atlas.build()
    full = dict(albedo_texture="t0", normal_texture="t1", metallic_roughness_texture="t2", occlusion_texture="t3",
                emissive_texture="t3", emissive_color=(0.5, 0.4, 0.3), metallic_factor=0.8, roughness_factor=0.6)
    mats = [Material(uv_size=(2.0, 2.0), uv_offset=(0.1, 0.2), **full),
            Material(sampling_mode=3, albedo_color=(0.9, 0.7, 0.5, 1.0), **full)]
    return pixels, pack_materials(mats, rects, 4)


@jax.jit
def _front(gscene, world, cam):
    """The decode path's culling, setup, coefficient matrix and 64-px meshlet
    lists of the JAX renderer, in one jit (both packages' functions under test
    read these same arrays)."""
    proj_scale = H * jnp.abs(cam.projection[1, 1]) / 2
    vis, lod = cull_instances(gscene, world, cam.frustum_planes, cam.position, proj_scale)
    mi, ml, mv = expand_meshlet_instances(gscene, vis, lod, 1 << 13)
    vm_inst, vm_ml, vm_valid, _ = cull_meshlets(gscene, world, mi, ml, mv, cam.frustum_planes, cam.position,
                                                capacity=64, depth_sort=True)
    setup = jset.setup_triangles(gscene, world, vm_inst, vm_ml, vm_valid, cam.view_projection, W, H)
    tile_list, _ = jset.bin_meshlets_to_tiles(setup, W, H, 64, 64)
    return setup, jr.pack_coeff_matrix(setup["coeffs"], setup["tri_valid"]), tile_list, vm_inst


@pytest.fixture(scope="module")
def golden():
    """The golden scene through the JAX package: setup, coefficient matrix,
    meshlet lists, its jitted raster, its jitted decode with the scene's own
    materials, and its decode op by op with textured materials."""
    state, gscene, cam = _world()
    gscene = dataclasses.replace(gscene, inst_material=gscene.inst_material.at[1].set(1))
    world = state.world
    setup, cm, tile_list, vm_inst = _front(gscene, world, cam)
    depth, vid = jr.rasterize_reference(cm, tile_list, W, H)
    plain = empty_gpu_materials(4)
    gbuf = jdecode(vid, setup, vm_inst, gscene, world, plain, jnp.zeros((8, 8, 4), jnp.uint8), width=W, height=H)
    pixels, mats = _textured_materials()
    with jax.disable_jit():
        gbuf_tex = jdecode(vid, setup, vm_inst, gscene, world, mats, jnp.asarray(pixels), width=W, height=H)
    return jax.device_get(dict(setup=setup, cm=cm, tile_list=tile_list, depth=depth, vid=vid, gbuf=gbuf,
                               gbuf_tex=gbuf_tex, vm_inst=vm_inst, world=world, gscene=gscene, mats=mats,
                               plain=plain, pixels=pixels))


def test_pack_coeff_matrix_matches_jax(golden):
    s = golden["setup"]
    got = raster_depth.pack_coeff_matrix(_t(s["coeffs"]), _t(s["tri_valid"]))
    np.testing.assert_array_equal(got.numpy(), golden["cm"])


@pytest.mark.parametrize("chunk_bytes", [tr.REF_CHUNK_BYTES, 1])
def test_rasterize_reference_matches_jax(golden, monkeypatch, chunk_bytes):
    """Depth within 1e-6 and vid equal on ≥ 99.9 % of pixels (all, here);
    one pair at a time (`REF_CHUNK_BYTES` = 1) gives the same."""
    monkeypatch.setattr(tr, "REF_CHUNK_BYTES", chunk_bytes)
    depth, vid = tr.rasterize_reference(_t(golden["cm"]), _t(golden["tile_list"]), W, H)
    assert (golden["vid"] >= 0).mean() > 0.3
    err = np.abs(depth.numpy() - golden["depth"]).max()
    unequal = int((vid.numpy() != golden["vid"]).sum())
    assert err <= DEPTH_TOL, err
    assert 1 - unequal / vid.numel() >= VID_EQ_MIN, f"{unequal} pixels' vids differ"
    assert unequal == 0


def test_rasterize_reference_first_max_on_ties(golden):
    """A tile lists the same meshlet twice (the second entry ties every pixel
    of the first: kept by the strict compare), and a slot 7 past the
    meshlet's most frequent winning slot copies that slot's planes (argmax's
    first index): vids equal to the JAX function's, and every tied pixel
    names the first entry's first slot of the two."""
    cm = np.array(golden["cm"])
    r = cm.shape[-1] // 5
    live = [int(v) for v in np.unique(golden["tile_list"]) if v >= 0]
    vm = live[0]
    cover = golden["vid"] >> 8 == vm
    src_slot = int(np.bincount((golden["vid"][cover] & 255)).argmax())
    dup = (src_slot + 7) % r
    for p in range(5):
        cm[vm, :, p * r + dup] = cm[vm, :, p * r + src_slot]
    tl = np.array(golden["tile_list"])
    tl[:, 1:] = tl[:, :-1].copy()  # every list's first entry repeated
    want_d, want_v = jax.device_get(jr.rasterize_reference(jnp.asarray(cm), jnp.asarray(tl), W, H))
    depth, vid = tr.rasterize_reference(_t(cm), _t(tl), W, H)
    np.testing.assert_array_equal(vid.numpy(), want_v)
    assert np.abs(depth.numpy() - want_d).max() <= DEPTH_TOL
    tied = (want_v >> 8 == vm) & ((want_v & 255) == min(src_slot, dup))
    assert tied.sum() > 0 and not ((want_v >> 8 == vm) & ((want_v & 255) == max(src_slot, dup))).any()


def _decode_port(g, textured: bool):
    setup = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in g["setup"].items()}
    mats, atlas = (g["mats"], _t(g["pixels"])) if textured else (g["plain"], torch.zeros((8, 8, 4), dtype=torch.uint8))
    return decode_visbuffer(_t(g["vid"]), setup, _t(g["vm_inst"]), bridge.gpu_scene_from_numpy(g["gscene"]),
                            _t(g["world"]), bridge.gpu_materials_from_numpy(mats), atlas, width=W, height=H)


def test_decode_visbuffer_textured_matches_jax_op_by_op(golden):
    got = _decode_port(golden, textured=True)
    want = golden["gbuf_tex"]
    np.testing.assert_array_equal(got["hit"].numpy(), want["hit"])
    for k, w in want.items():
        if k != "hit":
            err = np.abs(got[k].numpy() - w).max()
            assert err <= OP_TOL, (k, err)
    # the textures were sampled: the albedo varies over the hit pixels
    assert want["albedo"][want["hit"]].std(0).min() > 0.05


def test_decode_visbuffer_matches_jitted_jax(golden):
    got = _decode_port(golden, textured=False)
    want = golden["gbuf"]
    hit = want["hit"]
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    assert hit.mean() > 0.3
    for k, w in want.items():
        if k == "hit":
            continue
        g = got[k].numpy()
        err = np.abs(g - w)[hit].max()
        assert err <= PLANE_TOL, (k, err)
        if k != "uv":
            np.testing.assert_array_equal(g[~hit], w[~hit], err_msg=k)
    rel = (np.abs(got["uv"].numpy() - want["uv"]) / np.maximum(np.abs(want["uv"]), 1.0))[~hit].max()
    assert rel <= MISS_UV_REL, rel


@pytest.mark.parametrize("case", range(4))
def test_sample_atlas_bilinear_albedo_cases_match_jax(case):
    """`tests/test_albedo_modulation.py`'s three cases (the oracle sampler at
    random UVs, an untextured material, the repeat wrap at 0.25 and 3.25)."""
    atlas_j, gpu_j = albedo_case._setup()
    atlas, gpu = _t(atlas_j), bridge.gpu_materials_from_numpy(jax.device_get(gpu_j))
    rng = np.random.default_rng(7)
    uv_a = np.full((2, 2, 2), 0.25, np.float32)
    m, u = [(rng.integers(0, 4, (24, 32)), rng.uniform(0.06, 0.94, (24, 32, 2)).astype(np.float32)),
            (np.full((8, 8), 4), np.full((8, 8, 2), 0.4, np.float32)),
            (np.zeros((2, 2), np.int64), uv_a), (np.zeros((2, 2), np.int64), uv_a + 3.0)][case]
    want = js.sample_atlas_bilinear(atlas_j, gpu_j.albedo_rect[m], jnp.asarray(u))
    got = ts.sample_atlas_bilinear(atlas, gpu.albedo_rect[_t(m).long()], _t(u))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= SAMPLE_TOL


@pytest.mark.parametrize("mode", range(5))
def test_sample_atlas_bilinear_modes_match_jax(mode):
    """Each sampling mode at UVs in [-2.5, 2.5] (repeat, clamp, nearest), in
    rects whose edges fall between texels (the per-tap clamp)."""
    atlas_j, gpu_j = albedo_case._setup()
    rng = np.random.default_rng(11 + mode)
    rect = np.concatenate([rng.uniform(0.0, 0.4, (64, 2)), rng.uniform(0.6, 1.0, (64, 2))], -1).astype(np.float32)
    uv = rng.uniform(-2.5, 2.5, (64, 2)).astype(np.float32)
    sm = np.full(64, mode, np.int32)
    want = js.sample_atlas_bilinear(atlas_j, jnp.asarray(rect), jnp.asarray(uv), jnp.asarray(sm))
    got = ts.sample_atlas_bilinear(_t(atlas_j), _t(rect), _t(uv), _t(sm))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= SAMPLE_TOL
