"""The port's depth-only raster (`ops/raster_depth.py`) against the JAX
package's `rasterize_pallas` in interpret mode (the TPU kernel's arithmetic)
and its plain-float32 oracle `rasterize_reference`.

The scene: the cubes of `tests/test_render3d.py`, ten of them at seeded
positions and rotations, seen by `look_down_z_camera` on a 256×256 map and
binned at 8 meshlets per 64-px tile; set up through the JAX package and carried
across as NumPy. Besides the binned lists: lists whose rows are masked to -1
(the shadow cache's page masking), an empty tile, and a row with a -1 between
live entries (the first `cnt` entries are read, each as max(entry, 0)).

Bounds: against the interpret-mode kernel, every pixel's depth and vid exactly
equal (same hi/lo plane sums in the same order). Against
`rasterize_reference` (global pixel centres, plain float32): hit masks ≥ 99 %
equal, depth within 1e-5 on ≥ 99 % of jointly hit pixels, vids equal on ≥ 99 %
of them; the difference sits on knife-edge pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.assets.bake import bake_mesh
from oxylus_tpu.ops import raster3d as jr
from oxylus_tpu.ops.cull import cull_instances, cull_meshlets, expand_meshlet_instances
from oxylus_tpu.ops.setup3d import bin_meshlets_to_tiles, setup_triangles
from oxylus_tpu.render.scene3d import upload_meshes
from oxylus_tpu.utils.math3d import quat_from_axis_angle, trs_to_mat4
from oxylus_tpu_torch.ops import raster_depth as rd
from tests.test_render3d import cube_mesh, look_down_z_camera

torch.set_num_threads(1)

S = 256
N_CUBES, CAPACITY, K_PER_TILE = 10, 16, 8


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    gscene = upload_meshes([bake_mesh(*cube_mesh())], [(0, i, 0) for i in range(N_CUBES)], max_instances=N_CUBES)
    pos = np.concatenate([rng.uniform(-1.2, 1.2, (N_CUBES, 2)), rng.uniform(-1.5, 0.8, (N_CUBES, 1))], 1)
    axis = rng.normal(size=(N_CUBES, 3))
    world = trs_to_mat4(jnp.asarray(pos, jnp.float32),
                        quat_from_axis_angle(jnp.asarray(axis, jnp.float32), jnp.asarray(rng.uniform(0, 3, N_CUBES),
                                                                                            jnp.float32)),
                        jnp.full((N_CUBES, 3), 0.6, jnp.float32))
    cam = look_down_z_camera(aspect=1.0, pos=(0.0, 0.0, 3.5))
    vis, lod = cull_instances(gscene, world, cam.frustum_planes, cam.position, jnp.float32(55.0))
    inst, ml, valid = expand_meshlet_instances(gscene, vis, lod, capacity=CAPACITY)
    vm_inst, vm_ml, vm_valid, _ = cull_meshlets(gscene, world, inst, ml, valid, cam.frustum_planes, cam.position,
                                                capacity=CAPACITY)
    setup = setup_triangles(gscene, world, vm_inst, vm_ml, vm_valid, cam.view_projection, S, S)
    tile_list, _ = bin_meshlets_to_tiles(setup, S, S, jr.TILE, K_PER_TILE)
    tl = np.asarray(tile_list)
    masked = tl.copy()
    masked[::3] = -1  # whole rows of pages that need no render
    holes = tl.copy()
    holes[5, 1] = -1  # a -1 between live entries: entry 1 reads meshlet 0, entry 2 is past cnt
    lists = {"binned": tl, "masked": masked, "holes": holes}
    cm = jr.pack_coeff_matrix(setup["coeffs"], setup["tri_valid"])
    want = {}
    for name, lst in lists.items():
        want[name] = {
            "pallas": jax.device_get(jr.rasterize_pallas(cm, jnp.asarray(lst), S, S, interpret=True)),
            "reference": jax.device_get(jr.rasterize_reference(cm, jnp.asarray(lst), S, S)),
        }
    return jax.device_get(dict(coeffs=setup["coeffs"], tri_valid=setup["tri_valid"], cm=cm)), lists, want


def test_pack_coeff_matrix_matches_jax(case):
    arrs, _, _ = case
    got = rd.pack_coeff_matrix(torch.from_numpy(np.array(arrs["coeffs"])), torch.from_numpy(np.array(arrs["tri_valid"])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(arrs["cm"]))


def test_case_has_depth_complexity(case):
    _, lists, _ = case
    tl = lists["binned"]
    counts = (tl >= 0).sum(1)
    assert counts.max() >= 4 and (counts == 0).any()  # overlapping tiles and empty tiles
    assert (lists["holes"][5] >= 0).sum() >= 2


@pytest.mark.parametrize("name", ["binned", "masked", "holes"])
def test_rasterize_depth_matches_interpret_kernel(case, name):
    arrs, lists, want = case
    launches = rd.LAUNCHES
    d, v = rd.rasterize_depth(torch.from_numpy(np.array(arrs["cm"])), torch.from_numpy(lists[name]), S, S)
    assert rd.LAUNCHES == launches  # CPU tensors: the plain version
    d_j, v_j = want[name]["pallas"]
    assert (v_j >= 0).mean() > 0.05
    np.testing.assert_array_equal(d.numpy(), d_j)
    np.testing.assert_array_equal(v.numpy(), v_j)
    if name == "masked":
        rows = np.zeros((S // 64, S // 64), bool).reshape(-1)
        rows[::3] = True
        px = np.repeat(np.repeat(rows.reshape(S // 64, S // 64), 64, 0), 64, 1)
        assert (v.numpy()[px] == -1).all() and (d.numpy()[px] == 0).all()


@pytest.mark.parametrize("name", ["binned", "masked"])
def test_rasterize_depth_near_plain_reference(case, name):
    arrs, lists, want = case
    d, v = (t.numpy() for t in rd.rasterize_depth(torch.from_numpy(np.array(arrs["cm"])),
                                                  torch.from_numpy(lists[name]), S, S))
    d_r, v_r = want[name]["reference"]
    hit, hit_r = v >= 0, v_r >= 0
    assert (hit == hit_r).mean() >= 0.99
    joint = hit & hit_r
    assert (np.abs(d[joint] - d_r[joint]) <= 1e-5).mean() >= 0.99
    assert (v[joint] == v_r[joint]).mean() >= 0.99


def test_rasterize_depth_refuses_other_devices(case):
    arrs, lists, _ = case
    with pytest.raises(ValueError):
        rd.rasterize_depth(torch.from_numpy(np.array(arrs["cm"])).to("meta"), torch.from_numpy(lists["binned"]), S, S)
