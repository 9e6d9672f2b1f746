"""The port's triangle setup, tile binning, block packing and tile G-buffer
raster against the JAX package's, whose tile kernel runs in interpret mode.

The scene of `tests/test_gbuffer_raster.py` (a cube at 128×96, K2 = 128, 8
group candidates, as that test runs it), built and culled through the JAX
package and carried across as NumPy; the frame tests of
`test_torch_render3d.py` cover dense tiles with several rounds and the
early-out. Setup, binning and the slot tables must match
exactly or to float32 rounding; the raster is held to the JAX test's own
bounds (hit masks ≥ 99.9 % equal, depth ≥ 99.5 % of jointly hit pixels, ids
resolved through the tables ≥ 99 %, G-buffer lanes within 2e-2 where the ids
agree, `test_gbuffer_raster.py:335-342`)."""

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
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.ops import raster3d as tr
from oxylus_tpu_torch.ops import setup3d as ts
from tests.test_render3d import cube_mesh

torch.set_num_threads(1)

W, H = 128, 96
K2, K_GROUPS, CAPACITY = 128, 8, 16


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def case():
    cap, k2, k_groups = CAPACITY, K2, K_GROUPS
    gscene = upload_meshes([bake_mesh(*cube_mesh())], [(0, 0, 0)])
    world = jnp.eye(4)[None]
    cam = camera_matrices(
        position=jnp.array([0.6, 0.8, 3.0]), yaw=jnp.float32(-jnp.pi / 2), pitch=jnp.float32(-0.2),
        tilt=jnp.float32(0.0), fov_deg=jnp.float32(60.0), near=jnp.float32(0.1), far=jnp.float32(100.0),
        zoom=jnp.float32(1.0), projection_kind=jnp.int32(0), aspect=jnp.float32(W / H),
    )
    vis, lod = cull_instances(gscene, world, cam.frustum_planes, cam.position, jnp.float32(55.0))
    inst, ml, valid = expand_meshlet_instances(gscene, vis, lod, capacity=cap)
    vm_inst, vm_ml, vm_valid, _ = cull_meshlets(
        gscene, world, inst, ml, valid, cam.frustum_planes, cam.position, capacity=cap, depth_sort=True
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
    entries, cnts, ovf = js.bin_triangles_per_tile(bounds, W, H, jr.TILE, k_groups, k2)
    comb = jr.build_tile_comb(dense, consts[dense["slot_material"]])
    blocks = jr.pack_tile_blocks(None, entries, comb=comb)
    raster = jr.rasterize_gbuffer_tiles(blocks, cnts, W, H, interpret=True)
    want = jax.device_get(dict(
        setup=setup, dense=dense, bounds=bounds, entries=entries, cnts=cnts, ovf=ovf, tables=blocks["tables"],
        near_r=blocks["near_r"], raster=raster, inv_vp=jnp.linalg.inv(cam.view_projection),
    ))
    args = dict(
        gscene=bridge.gpu_scene_from_numpy(jax.device_get(gscene)), world=_t(world), vm_inst=_t(vm_inst),
        vm_ml=_t(vm_ml), vm_valid=_t(vm_valid), vp=_t(cam.view_projection), mat_idx=_t(mat_idx).long(),
        consts=_t(consts), k2=k2, k_groups=k_groups,
    )
    return want, args


def _port_setup(want):
    return {k: _t(v) for k, v in want["setup"].items() if isinstance(v, np.ndarray)}


def test_setup_triangles_matches_jax(case):
    want, a = case
    got = ts.setup_triangles(a["gscene"], a["world"], a["vm_inst"], a["vm_ml"], a["vm_valid"], a["vp"], W, H)
    np.testing.assert_array_equal(got["tri_valid"].numpy(), want["setup"]["tri_valid"])
    assert want["setup"]["tri_valid"].sum() > 0
    np.testing.assert_array_equal(got["packed_id"].numpy(), want["setup"]["packed_id"])
    for k in ("coeffs", "attr_planes", "sxyz", "tri_xmin", "tri_xmax", "tri_ymin", "tri_ymax", "clip"):
        g, w = got[k].numpy(), want["setup"][k]
        # 1e-6 relative to the largest coefficient of the same row
        scale = np.maximum(np.abs(w).max(-1, keepdims=True), 1e-30) if w.ndim > 2 else np.maximum(np.abs(w), 1.0)
        assert np.all(np.abs(g - w) <= 1e-6 * scale), k
    # the keys the decode path reads (`ops/decode3d.py`)
    np.testing.assert_array_equal(got["packed_verts"].numpy(), want["setup"]["packed_verts"])
    np.testing.assert_array_equal(got["tri_of_slot"].numpy(), want["setup"]["tri_of_slot"])
    assert got["slots_per_tri"] == want["setup"]["slots_per_tri"] == 1


def test_passthrough_and_binning_match_exactly(case):
    want, a = case
    setup = _port_setup(want)
    dense = ts.passthrough_groups(setup, setup["tri_valid"], a["mat_idx"], a["vm_inst"])
    for k in ("coeffs", "attr_planes", "tri_valid", "tri_z", "slot_material", "slot_instance", "packed_id"):
        np.testing.assert_array_equal(dense[k].numpy(), want["dense"][k], err_msg=k)
    bounds = ts.passthrough_bounds(setup, setup["tri_valid"])
    for k, v in want["bounds"].items():
        np.testing.assert_array_equal(bounds[k].numpy(), v, err_msg=k)
    entries, cnts, ovf = ts.bin_triangles_per_tile(bounds, W, H, tr.TILE, a["k_groups"], a["k2"])
    np.testing.assert_array_equal(entries.numpy(), want["entries"])
    np.testing.assert_array_equal(cnts.numpy(), want["cnts"])
    assert int(ovf) == int(want["ovf"]) == 0


def _port_blocks(want, a):
    setup = _port_setup(want)
    dense = ts.passthrough_groups(setup, setup["tri_valid"], a["mat_idx"], a["vm_inst"])
    comb = tr.build_tile_comb(dense, a["consts"][dense["slot_material"].long()])
    return tr.pack_tile_blocks(_t(want["entries"]), comb)


def test_pack_tile_blocks_tables_match_exactly(case):
    want, a = case
    blocks = _port_blocks(want, a)
    for got, ref in zip(blocks["tables"], want["tables"]):
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(blocks["near_r"].numpy(), want["near_r"])
    with pytest.raises(ValueError):
        tr.pack_tile_blocks(torch.full((4, 320), -1, dtype=torch.int32), blocks["comb"])


@pytest.fixture(scope="module")
def port_raster(case):
    want, a = case
    blocks = _port_blocks(want, a)
    launches = tr.LAUNCHES
    out = tr.rasterize_gbuffer_tiles(blocks, _t(want["cnts"]), W, H)
    assert tr.LAUNCHES == launches  # CPU tensors: the plain version
    return [o.float().numpy() if o.dtype == torch.bfloat16 else o.numpy() for o in out], blocks


def test_raster_matches_jax_interpret(case, port_raster):
    want, a = case
    (d, v, g), blocks = port_raster
    d_j, v_j, g_j = want["raster"]
    hit, hit_j = v >= 0, v_j >= 0
    assert hit_j.sum() > 0.05 * hit_j.size
    assert (hit == hit_j).mean() >= 0.999
    joint = hit & hit_j
    assert (d[joint] == d_j[joint]).mean() >= 0.995
    k2 = a["k2"]
    pid = blocks["tables"][2].numpy()
    flat = lambda vv: np.clip((vv >> 8) * k2 + (vv & 255), 0, pid.size - 1)
    ids, ids_j = pid[flat(v)], want["tables"][2][flat(v_j)]
    assert (ids[joint] == ids_j[joint]).mean() >= 0.99
    same = joint & (ids == ids_j)
    assert np.abs(g[same] - g_j.astype(np.float32)[same]).max() < 2e-2


def test_gbuffer_from_raster_matches_jax(case):
    want, _ = case
    from oxylus_tpu.ops.raster3d import gbuffer_from_raster as jgb

    d_j, v_j, g_j = want["raster"]
    ref = jax.device_get(jgb(jnp.asarray(g_j), jnp.asarray(v_j), jnp.asarray(d_j), jnp.asarray(want["inv_vp"])))
    got = tr.gbuffer_from_raster(torch.from_numpy(np.asarray(g_j, np.float32)).to(torch.bfloat16), _t(v_j), _t(d_j),
                                 _t(want["inv_vp"]))
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-5, err_msg=k)
