"""The port's dense triangle groups and group-hit G-buffer raster against the
JAX package's, whose group kernel (`rasterize_gbuffer_pallas`) runs in
interpret mode.

Two scenes at 128×96, built and culled (nearest first) through the JAX package
and carried across as NumPy: the cube of `tests/test_gbuffer_raster.py`, and 8
cubes and spheres in a cluster, each drawn twice in place, so their meshlets
overlap on screen, pairs share a (depth bucket, morton) key, depths tie across
groups and slots, and the early-out ends walks. Per scene:

- `compact_triangles` and `passthrough_groups` equal the JAX dicts exactly.
  The JAX package sorts the meshlet keys with `jax.lax.sort`, which does not
  promise a stable order; on the CPU it gives the stable one (checked here on
  keys with many ties), so the port's stable sort gives the same groups;
- the plain group raster against the interpret-mode kernel at tile 64 and 32,
  with and without `ml_near`, on a band of the image (`tile_base` ≠ 0), and
  against the streamed kernel too (`VMEM_BUDGET_BYTES` patched, in this test
  only, so that the resident kernel does not fit and the streamed one does):
  depth and vid exactly equal, so ids through the slot tables too; G-buffer
  lanes within 2e-2 (`test_gbuffer_raster.py`'s bound). They are not bit-equal:
  the jitted interpret-mode kernel contracts phase B's a·px + b·py into fused
  multiply-adds, which moves a lane that cancels by one bf16 step;
- synthetic groups (`chip_smoke.seeded_groups`, which makes the card's seeded
  inputs, here at 128×96) with depths tied across groups and slots and a group
  whose near bound equals the resolved depth where it is listed (the
  early-out's strict compare decides its pixels): depth and vid exactly equal
  too;
- the plain version's measured work (walked groups, covered pairs, spans) on
  a hand-counted input;
- CPU tensors take the plain version: `LAUNCHES` stays unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import group_rows, seeded_groups
from oxylus_tpu.assets.bake import bake_mesh
from oxylus_tpu.assets.material import empty_gpu_materials
from oxylus_tpu.ops import raster3d as jr
from oxylus_tpu.ops import setup3d as js
from oxylus_tpu.ops.cull import cull_instances, cull_meshlets, expand_meshlet_instances
from oxylus_tpu.render.camera import camera_matrices
from oxylus_tpu.render.scene3d import upload_meshes
from oxylus_tpu_torch.ops import raster3d as tr
from oxylus_tpu_torch.ops import raster_groups as tg
from oxylus_tpu_torch.ops import setup3d as ts
from tests.test_native_bake import sphere_mesh
from tests.test_render3d import cube_mesh

torch.set_num_threads(1)

W, H = 128, 96
R = 64  # slots per group: the meshlet size and compact_triangles' default group
GB_TOL = 2e-2
SCENES = ("cube", "cluster")
DENSE_KEYS = ("coeffs", "attr_planes", "tri_valid", "ml_xmin", "ml_xmax", "ml_ymin", "ml_ymax", "ml_near",
              "slot_material", "slot_instance", "packed_id", "count")
# name: (grouping, tile, group candidates per tile, with ml_near, band of tile rows or None)
RASTERS = {
    "compact-64": ("compact", 64, 8, True, None),
    "compact-32": ("compact", 32, 16, True, None),
    "passthrough-64-no-near": ("passthrough", 64, 8, False, None),
    "compact-32-band": ("compact", 32, 16, True, (1, 3)),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene(name):
    """(gscene, world, camera) of the named scene."""
    cam_pos, pitch = jnp.array([0.6, 0.8, 3.0]), -0.2
    if name == "cube":
        gscene = upload_meshes([bake_mesh(*cube_mesh())], [(0, 0, 0)])
        world = jnp.eye(4)[None]
    else:
        n = 17
        gscene = upload_meshes([bake_mesh(*cube_mesh()), bake_mesh(*sphere_mesh(16, 32))],
                               [(i % 2 if i < 16 else 0, i, 0) for i in range(n)])
        world = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        for i in range(16):  # objects 8-15 repeat 0-7 in place: equal keys, and depths tied across groups
            j = i % 8
            world[i, :3, 3] = [(j % 4) * 0.7 - 1.0, (j // 4) * 0.8 - 0.4, -0.5 * (j % 3)]
        # a slab in front of the cluster's left part: the tiles it covers end their walks early
        world[16, :3, :3] = np.diag([2.0, 3.0, 0.2]).astype(np.float32)
        world[16, :3, 3] = [-1.6, 0.3, 1.5]
        world = jnp.asarray(world)
        cam_pos, pitch = jnp.array([0.2, 0.5, 3.5]), -0.1
    cam = camera_matrices(
        position=cam_pos, yaw=jnp.float32(-jnp.pi / 2), pitch=jnp.float32(pitch), tilt=jnp.float32(0.0),
        fov_deg=jnp.float32(60.0), near=jnp.float32(0.1), far=jnp.float32(100.0), zoom=jnp.float32(1.0),
        projection_kind=jnp.int32(0), aspect=jnp.float32(W / H),
    )
    return gscene, world, cam


def _streamed_budget(vm: int, tile: int) -> int:
    """The VMEM budget at which `rasterize_gbuffer_pallas` takes the streamed
    kernel for these shapes: its bytes with the attribute matrix left out
    (`oxylus_tpu/ops/raster3d.py:752-766`), so the resident check fails by
    that matrix and the streamed assert passes."""
    pix = tile * tile
    out_block = 2 * jr.ROWG * pix * (4 + 4 + jr.N_GB_ATTR * 2)
    temp = 5 * R * pix * 4 + 8 * R * pix + 2 * R * pix * 2 + 128 * pix * 4 + 4 * jr.N_GB_ATTR * pix * 4 + (8 << 20)
    return vm * 8 * jr.N_GB_PLANES * R * 4 + out_block + temp


@pytest.fixture(scope="module")
def cases():
    """Per scene: the JAX setup, dense dicts, keys and rasters (NumPy), and the port's inputs."""
    out = {}
    for name in SCENES:
        gscene, world, cam = _scene(name)
        cap = 16 if name == "cube" else 128
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
            [mats.albedo_color[:, :3], mats.metallic_factor[:, None], mats.roughness_factor[:, None],
             mats.emissive_color], axis=1,
        )
        mat_idx = gscene.inst_material[vm_inst]
        dense = {
            "compact": js.compact_triangles(setup, setup["tri_valid"], mat_idx, vm_inst, width=float(W),
                                            height=float(H)),
            "passthrough": js.passthrough_groups(setup, setup["tri_valid"], mat_idx, vm_inst),
        }
        rasters = {}
        for case, (grouping, tile, k, with_near, band) in RASTERS.items():
            d = dense[grouping]
            cm, at = jr.pack_gbuffer_coeff_matrix(d["coeffs"], d["attr_planes"], d["tri_valid"],
                                                  consts[d["slot_material"]])
            near = jnp.flip(jax.lax.cummax(jnp.flip(d["ml_near"]))) if with_near else None
            tile_list, _ = js.bin_meshlets_to_tiles(d, W, H, tile, k)
            tx, h, base = (W + tile - 1) // tile, H, 0
            if band is not None:  # tile rows band[0]..band[1]-1, as the band-sharded frame passes them
                base, h = band[0] * tx, (band[1] - band[0]) * tile
                tile_list = tile_list[band[0] * tx : band[1] * tx]
            rasters[case] = jax.device_get(dict(
                out=jr.rasterize_gbuffer_pallas(cm, at, tile_list, W, h, interpret=True, ml_near=near, tile=tile,
                                                tile_base=base),
                tile_list=tile_list, height=h, base=base,
            ))
        # the streamed kernel: the budget patched for this call only (called
        # unjitted, so the module value is read now)
        d = dense["compact"]
        cm, at = jr.pack_gbuffer_coeff_matrix(d["coeffs"], d["attr_planes"], d["tri_valid"],
                                              consts[d["slot_material"]])
        tile_list, _ = js.bin_meshlets_to_tiles(d, W, H, 64, 8)
        saved = jr.VMEM_BUDGET_BYTES
        jr.VMEM_BUDGET_BYTES = _streamed_budget(cm.shape[0], 64)
        try:
            streamed = jr.rasterize_gbuffer_pallas.__wrapped__(
                cm, at, tile_list, W, H, interpret=True, ml_near=jnp.flip(jax.lax.cummax(jnp.flip(d["ml_near"]))),
            )
        finally:
            jr.VMEM_BUDGET_BYTES = saved
        rasters["streamed"] = jax.device_get(dict(out=streamed, tile_list=tile_list, height=H, base=0))
        out[name] = dict(
            setup=jax.device_get(setup), dense=jax.device_get(dense), rasters=rasters,
            mat_idx=_t(mat_idx).long(), vm_inst=_t(vm_inst), consts=_t(consts),
        )
    return out


def _port_setup(c):
    return {k: _t(v) for k, v in c["setup"].items() if isinstance(v, np.ndarray)}


def _port_dense(c, grouping):
    setup = _port_setup(c)
    if grouping == "compact":
        return ts.compact_triangles(setup, setup["tri_valid"], c["mat_idx"], c["vm_inst"], width=float(W),
                                    height=float(H))
    return ts.passthrough_groups(setup, setup["tri_valid"], c["mat_idx"], c["vm_inst"])


def test_jax_cpu_sort_is_stable_on_ties():
    """`compact_triangles`' `jax.lax.sort((key, src), num_keys=1)` on the CPU
    orders equal keys as a stable sort does, so the port's stable sort
    reproduces its groups."""
    rng = np.random.default_rng(7)
    for n in (16, 200, 4096):
        key = rng.integers(0, 5, n).astype(np.int32)
        key[rng.random(n) < 0.5] = 1 << 30
        _, perm = jax.lax.sort((jnp.asarray(key), jnp.arange(n, dtype=jnp.int32)), num_keys=1)
        np.testing.assert_array_equal(np.asarray(perm), torch.sort(torch.from_numpy(key), stable=True).indices)


@pytest.mark.parametrize("scene", SCENES)
def test_compact_triangles_matches_jax_exactly(cases, scene):
    c = cases[scene]
    got = _port_dense(c, "compact")
    want = c["dense"]["compact"]
    for k in DENSE_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert int(got["count"]) == int(c["setup"]["tri_valid"].sum()) > 0
    assert want["slot_rows"] is None and got["slot_rows"] is None
    # the dense slots' nearest depths, which the slot rows carry
    valid = want["tri_valid"]
    np.testing.assert_array_equal(got["tri_z"].numpy().max(1), np.where(valid.any(1), want["ml_near"], -1.0))


def test_cluster_meshlet_keys_tie(cases):
    """The cluster scene holds meshlets with equal (depth bucket, morton)
    keys, so the exact match above covers the order of ties."""
    setup = cases["cluster"]["setup"]
    mask = setup["tri_valid"]
    live = mask.any(1)
    cells = []
    for lo, hi, size in (("tri_xmin", "tri_xmax", W), ("tri_ymin", "tri_ymax", H)):
        c0 = np.where(mask, np.clip(setup[lo], 0, size), 1e9).min(1)
        c1 = np.where(mask, np.clip(setup[hi], -1, size), -1e9).max(1)
        cells.append(np.clip((c0 + c1) * np.float32(0.5 / size) * 64, 0, 63).astype(np.int32))
    near = np.where(mask, setup["sxyz"][..., 2].max(-1), -1.0).max(1)
    zb = np.clip(((1.0 - near) * 4.0).astype(np.int32), 0, 3)
    keys = list(zip(zb[live], cells[0][live], cells[1][live]))
    assert len(keys) > len(set(keys)) > 1


@pytest.mark.parametrize("scene", SCENES)
def test_passthrough_groups_matches_jax_exactly(cases, scene):
    c = cases[scene]
    got = _port_dense(c, "passthrough")
    want = c["dense"]["passthrough"]
    for k in DENSE_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert want["slot_rows"] is None and got["slot_rows"] is None


@pytest.fixture(scope="module")
def port_rasters(cases):
    """The port's group raster on the port's own dense groups, per scene and case."""
    out = {}
    launches = tg.LAUNCHES
    for name, c in cases.items():
        dense = {g: _port_dense(c, g) for g in ("compact", "passthrough")}
        for case, (grouping, tile, _, with_near, _) in list(RASTERS.items()) + [("streamed", ("compact", 64, 8, True,
                                                                                               None))]:
            d = dense[grouping]
            rows = tr.build_tile_comb(d, c["consts"][d["slot_material"].long()])
            near = torch.flip(torch.cummax(torch.flip(d["ml_near"], [0]), 0).values, [0]) if with_near else None
            ref = c["rasters"][case]
            res = tg.rasterize_gbuffer_groups(rows, _t(ref["tile_list"]), W, ref["height"], R, ml_near=near,
                                              tile=tile, tile_base=ref["base"])
            out[name, case] = [o.float().numpy() if o.dtype == torch.bfloat16 else o.numpy() for o in res]
    assert tg.LAUNCHES == launches  # CPU tensors: the plain version
    return out


def _check_raster(got, want, table):
    d, v, g = got
    d_j, v_j, g_j = want
    hit = v_j >= 0
    assert hit.mean() > 0.05
    np.testing.assert_array_equal(d.view(np.int32), d_j.view(np.int32))
    np.testing.assert_array_equal(v, v_j)  # so the ids through the slot tables agree too
    assert ((v[hit] >> 8) * R + (v[hit] & 255)).max() < table.size
    assert np.abs(g - g_j.astype(np.float32)).max() < GB_TOL


@pytest.mark.parametrize("case", list(RASTERS))
@pytest.mark.parametrize("scene", SCENES)
def test_group_raster_matches_jax_interpret(cases, port_rasters, scene, case):
    c = cases[scene]
    grouping = RASTERS[case][0]
    _check_raster(port_rasters[scene, case], c["rasters"][case]["out"], c["dense"][grouping]["packed_id"])


@pytest.mark.parametrize("scene", SCENES)
def test_group_raster_matches_the_streamed_kernel(cases, port_rasters, scene):
    c = cases[scene]
    _check_raster(port_rasters[scene, "streamed"], c["rasters"]["streamed"]["out"], c["dense"]["compact"]["packed_id"])


def test_early_out_ends_walks_in_the_cluster(cases):
    """The slab ends some tiles' walks early at tile 32 (with the result equal
    to the JAX kernel's above): the walked groups, as the plain version
    counts them, fall short of the lists there."""
    c = cases["cluster"]
    d = _port_dense(c, "compact")
    rows = tr.build_tile_comb(d, c["consts"][d["slot_material"].long()])
    near = torch.flip(torch.cummax(torch.flip(d["ml_near"], [0]), 0).values, [0])
    tile_list = _t(c["rasters"]["compact-32"]["tile_list"])
    out = tg._raster_groups_plain(rows, tile_list, tg.near_table(tile_list, near), W, H, R, 32, 0, measure=True)
    cnt = (tile_list >= 0).sum(1)
    assert (out[3] < cnt).any() and (out[3] <= cnt).all() and int(out[4].sum()) > 0
    assert (out[5] >= out[4]).all() and (out[5] <= out[3].long() * R * 32 * 32).all()


@pytest.mark.parametrize("tile, with_near", [(32, True), (64, True), (32, False)])
def test_group_raster_ties_match_jax_interpret(tile, with_near):
    """Tied depths across groups and slots, and a group whose near bound
    equals the resolved depth of the tiles it is listed in (the early-out's
    strict compare then ends the walk before it; a walk that went on would
    give its first slot the slab's second-slot pixels): the plain version
    equals the JAX kernel's depth and vid exactly."""
    r = 32
    coeffs, attr_planes, consts, valid, ml_near, bounds = seeded_groups(tile, W, H, 8, r, (6, 46), 0)
    near_eo = np.flip(np.maximum.accumulate(np.flip(ml_near)))
    tile_list, _ = js.bin_meshlets_to_tiles({k: jnp.asarray(v) for k, v in bounds.items()}, W, H, tile, 16)
    cm, at = jr.pack_gbuffer_coeff_matrix(jnp.asarray(coeffs), jnp.asarray(attr_planes), jnp.asarray(valid),
                                          jnp.asarray(consts))
    want = jax.device_get(jr.rasterize_gbuffer_pallas(cm, at, tile_list, W, H, interpret=True, tile=tile,
                                                      ml_near=jnp.asarray(near_eo) if with_near else None))
    rows = group_rows(coeffs, attr_planes, consts, valid, "cpu")
    got = tg.rasterize_gbuffer_groups(rows, _t(tile_list), W, H, r, ml_near=_t(near_eo) if with_near else None,
                                      tile=tile)
    got = [o.float().numpy() if o.dtype == torch.bfloat16 else o.numpy() for o in got]
    d, v, g = got
    hit = want[1] >= 0
    np.testing.assert_array_equal(d.view(np.int32), want[0].view(np.int32))
    np.testing.assert_array_equal(v, want[1])
    assert np.abs(g - want[2].astype(np.float32)).max() < GB_TOL
    assert hit.mean() > 0.3
    if with_near:  # the input decides the compare: with dmin <= near the walk would go on and change vids
        tl = _t(tile_list).to(torch.int32)
        near = tg.near_table(tl, _t(near_eo))
        on = tg._raster_groups_plain(rows, tl, near + 1, W, H, r, tile, 0)
        assert (on[1].numpy() != v).any()


def test_group_raster_refuses_what_the_kernel_does_not_take():
    rows = torch.zeros((2 * R, tr.COMB_W))
    tl = torch.full((4, 8), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tg.rasterize_gbuffer_groups(rows, tl, W, H, R, tile=16)
    with pytest.raises(ValueError):
        tg.rasterize_gbuffer_groups(torch.zeros((2 * 256, tr.COMB_W)), tl, W, H, 256)
    with pytest.raises(ValueError):
        tg.rasterize_gbuffer_groups(rows, tl[:3], W, H, R)
    with pytest.raises(ValueError):
        tg.run_groups(rows.to("meta"), tl, tl, W, H, R, 64, 0)
    d, v, g = tg.rasterize_gbuffer_groups(rows, tl, W, H, R)  # empty lists: no hit
    assert (v == -1).all() and (d == 0).all() and (g == 0).all()


def test_plain_measures_spans_on_image_pixels():
    """The measured work on a 40×40 image at tile 32 (the right and bottom
    tiles hold 8 image columns or rows): a slot over the whole plane, one over
    x ≤ 10 and one over x + y ≤ 10 (55 pixel centres, spanning 10 × 10)."""
    rows = torch.zeros((3, tr.COMB_W))
    planes = rows[:, tr.PLANE_OFF : tr.PLANE_OFF + 15].view(3, 5, 3)
    planes[:, :, 2] = torch.tensor([1.0, 1.0, 1.0, 0.25, 1.0])  # e0 e1 e2 zn wd: constant, covering
    planes[1, 0] = torch.tensor([-1.0, 0.0, 10.0])
    planes[2, 0] = torch.tensor([-1.0, -1.0, 10.0])
    tl = torch.zeros((4, 1), dtype=torch.int32)
    out = tg._raster_groups_plain(rows, tl, tg.near_table(tl, None), 40, 40, 3, 32, 0, measure=True)
    assert out[3].tolist() == [1, 1, 1, 1]
    assert out[4].tolist() == [1024 + 320 + 55, 256, 256 + 80, 64]
    assert out[5].tolist() == [1024 + 320 + 100, 256, 256 + 80, 64]
    unmeasured = tg._raster_groups_plain(rows, tl, tg.near_table(tl, None), 40, 40, 3, 32, 0)
    assert int(unmeasured[4].sum()) == 0 and int(unmeasured[5].sum()) == 0
    assert all(torch.equal(a, b) for a, b in zip(unmeasured[:4], out[:4]))
