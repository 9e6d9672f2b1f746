"""The port's tile raster at its smaller tile edges against the JAX package's
tile kernel in interpret mode.

The cube scene of `tests/test_torch_raster_tiles.py` (128×96, K2 = 128, 8
group candidates), built and culled through the JAX package, binned,
packed and rastered by both packages:

- at 16-px tiles over the whole image (48 tiles);
- at 32-px tiles over a band, the image's tile rows 1 and 2 (`tile_base` = 4,
  height 64), whose lists are the whole image's rows 4 to 11. The port's band
  is also exactly the whole image's rows 32 to 95 (the same vids: the band's
  tile ids are the image's).

Binning, slot tables and near bounds must be exactly equal; the raster is held
to `test_torch_raster_tiles.py`'s bounds (hit masks ≥ 99.9 % equal, depth ≥
99.5 % of jointly hit pixels, ids through the tables ≥ 99 %, G-buffer lanes
within 2e-2 where the ids agree). The JAX runs share one module-scoped
fixture."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.assets.bake import bake_mesh
from oxylus_tpu.assets.material import empty_gpu_materials
from oxylus_tpu.ops import raster3d as jr
from oxylus_tpu.ops import setup3d as js
from oxylus_tpu.ops.cull import cull_instances, cull_meshlets, expand_meshlet_instances
from oxylus_tpu.render.camera import camera_matrices
from oxylus_tpu.render.scene3d import upload_meshes
from oxylus_tpu_torch.ops import raster3d as tr
from oxylus_tpu_torch.ops import setup3d as ts
from tests.test_render3d import cube_mesh

torch.set_num_threads(1)

W, H = 128, 96
K2, K_GROUPS, CAPACITY = 128, 8, 16
# name: (tile, first tile row of the band, tile rows of the band or None for the whole image)
CASES = {"tile16": (16, 0, None), "tile32_band": (32, 1, 2)}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def jax_cases():
    """The scene's setup through the JAX package, then per case its binning,
    packing and interpret-mode raster."""
    gscene = upload_meshes([bake_mesh(*cube_mesh())], [(0, 0, 0)])
    world = jnp.eye(4)[None]
    cam = camera_matrices(
        position=jnp.array([0.6, 0.8, 3.0]), yaw=jnp.float32(-jnp.pi / 2), pitch=jnp.float32(-0.2),
        tilt=jnp.float32(0.0), fov_deg=jnp.float32(60.0), near=jnp.float32(0.1), far=jnp.float32(100.0),
        zoom=jnp.float32(1.0), projection_kind=jnp.int32(0), aspect=jnp.float32(W / H),
    )
    vis, lod = cull_instances(gscene, world, cam.frustum_planes, cam.position, jnp.float32(55.0))
    inst, ml, valid = expand_meshlet_instances(gscene, vis, lod, capacity=CAPACITY)
    vm_inst, vm_ml, vm_valid, _ = cull_meshlets(
        gscene, world, inst, ml, valid, cam.frustum_planes, cam.position, capacity=CAPACITY, depth_sort=True
    )
    setup = js.setup_triangles(gscene, world, vm_inst, vm_ml, vm_valid, cam.view_projection, W, H)
    mats = empty_gpu_materials(4)
    mats = dataclasses.replace(
        mats,
        albedo_color=mats.albedo_color.at[0].set(jnp.array([0.7, 0.3, 0.1, 1.0])),
        metallic_factor=mats.metallic_factor.at[0].set(0.5),
        roughness_factor=mats.roughness_factor.at[0].set(0.4),
    )
    consts = jnp.concatenate(
        [mats.albedo_color[:, :3], mats.metallic_factor[:, None], mats.roughness_factor[:, None], mats.emissive_color],
        axis=1,
    )
    mat_idx = gscene.inst_material[vm_inst]
    dense = js.passthrough_groups(setup, setup["tri_valid"], mat_idx, vm_inst)
    bounds = js.passthrough_bounds(setup, setup["tri_valid"])
    comb = jr.build_tile_comb(dense, consts[dense["slot_material"]])
    out = {"setup": jax.device_get(setup), "mat_idx": np.asarray(mat_idx), "vm_inst": np.asarray(vm_inst),
           "consts": np.asarray(consts)}
    for name, (tile, row0, rows) in CASES.items():
        entries, cnts, ovf = js.bin_triangles_per_tile(bounds, W, H, tile, K_GROUPS, K2)
        tx = -(-W // tile)
        base, h = row0 * tx, (H if rows is None else rows * tile)
        n = tx * (-(-h // tile))
        band_e, band_c = entries[base : base + n], cnts[base : base + n]
        blocks = jr.pack_tile_blocks(None, band_e, comb=comb)
        raster = jr.rasterize_gbuffer_tiles(blocks, band_c, W, h, tile=tile, interpret=True, tile_base=base)
        out[name] = jax.device_get(dict(entries=entries, cnts=cnts, ovf=ovf, tables=blocks["tables"],
                                        near_r=blocks["near_r"], raster=raster, base=base, h=h, n=n))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_tile_raster_at_other_tiles_matches_jax(jax_cases, name):
    want = jax_cases[name]
    tile = CASES[name][0]
    base, h, n = int(want["base"]), int(want["h"]), int(want["n"])
    setup = {k: _t(v) for k, v in jax_cases["setup"].items() if isinstance(v, np.ndarray)}
    dense = ts.passthrough_groups(setup, setup["tri_valid"], _t(jax_cases["mat_idx"]).long(),
                                  _t(jax_cases["vm_inst"]))
    bounds = ts.passthrough_bounds(setup, setup["tri_valid"])
    entries, cnts, ovf = ts.bin_triangles_per_tile(bounds, W, H, tile, K_GROUPS, K2)
    np.testing.assert_array_equal(entries.numpy(), want["entries"])
    np.testing.assert_array_equal(cnts.numpy(), want["cnts"])
    assert int(ovf) == int(want["ovf"]) == 0
    assert int((cnts > 0).sum()) >= 4  # the cube spans several tiles at this edge
    comb = tr.build_tile_comb(dense, _t(jax_cases["consts"])[dense["slot_material"].long()])
    blocks = tr.pack_tile_blocks(entries[base : base + n], comb)
    for got, ref in zip(blocks["tables"], want["tables"]):
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(blocks["near_r"].numpy(), want["near_r"])

    launches = tr.LAUNCHES
    out = tr.rasterize_gbuffer_tiles(blocks, cnts[base : base + n], W, h, tile=tile, tile_base=base)
    assert tr.LAUNCHES == launches  # CPU tensors: the plain version
    d, v, g = out[0].numpy(), out[1].numpy(), out[2].float().numpy()
    d_j, v_j, g_j = want["raster"]
    assert d.shape == d_j.shape == (h, W)
    hit, hit_j = v >= 0, v_j >= 0
    assert hit_j.sum() > 0.05 * hit_j.size
    assert (hit == hit_j).mean() >= 0.999
    joint = hit & hit_j
    assert (d[joint] == d_j[joint]).mean() >= 0.995
    pid = blocks["tables"][2].numpy()
    flat = lambda vv: np.clip(((vv >> 8) - base) * K2 + (vv & 255), 0, pid.size - 1)  # the band's table rows
    ids, ids_j = pid[flat(v)], want["tables"][2][flat(v_j)]
    assert (ids[joint] == ids_j[joint]).mean() >= 0.99
    same = joint & (ids == ids_j)
    assert np.abs(g[same] - g_j.astype(np.float32)[same]).max() < 2e-2
    if base:
        # the band is the whole image's rows, vids included
        full = tr.rasterize_gbuffer_tiles(tr.pack_tile_blocks(entries, comb), cnts, W, H, tile=tile)
        y0 = base // (-(-W // tile)) * tile
        bits = lambda x: x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
        for a, b in zip(out, full):
            assert torch.equal(bits(a), bits(b[y0 : y0 + h]))
