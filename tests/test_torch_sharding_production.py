"""The band-sharded group-route frame
(`sharding.render_frame_sharded_production`) on 4 gloo ranks against the JAX
function on `make_mesh(4)` with its group kernel in interpret mode, on
`tests/test_sharding.py`'s cube at 128×128 and 32-px tiles (one tile row a
rank), untextured and with the cube's material sampling a seeded atlas
through `slot_rows`.

Both sides start from one `compact_triangles` output: the JAX dense groups
pack the JAX function's `(cm_gb, attr_gb)`, the port's (from the same setup,
equal to the JAX dict key by key) its slot rows (`raster3d.build_tile_comb`).

- Per band: the port's group raster at the band's `tile_base` against
  `rasterize_gbuffer_pallas(..., tile_base=, interpret=True)`: depth and vid
  exactly equal.
- Every rank's adapted luminance equal, and within 1e-6 relative of the JAX
  function's; the frame within the group route's bound of the JAX frame:
  PSNR ≥ 40 dB (`tests/test_torch_render3d_group.py`). The textured frame is
  held against the JAX function on one device: the port's bands exchange a
  half-resolution seam row before upsampling the albedo's texture, so its 4
  bands give the single-device frame, where the JAX module's bands each
  resize alone and clamp at the seams (also within 40 dB of that frame).

One module-scoped fixture spawns the 4 ranks once, from a thread while the JAX
side computes; the rank function imports only the port, JAX is imported inside
the fixture.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.ops import raster3d
from oxylus_tpu_torch.ops.raster_groups import rasterize_gbuffer_groups
from oxylus_tpu_torch.ops.setup3d import compact_triangles
from oxylus_tpu_torch.parallel import dryrun, sharding

torch.set_num_threads(1)

RANKS, W, H, TILE, GROUP, MPT = 4, 128, 128, 32, 64, 16
PSNR_MIN, LUM_RTOL = 40.0, 1e-6
DENSE_KEYS = ("coeffs", "attr_planes", "tri_valid", "ml_near", "slot_material", "slot_instance", "packed_id")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rank(rank, n, device, case):
    mesh = sharding.make_mesh(n, device=device)
    setup = {k: _t(v) for k, v in case["setup"].items() if isinstance(v, np.ndarray)}
    vm_inst = _t(case["vm_inst"])
    dense = compact_triangles(setup, setup["tri_valid"] & _t(case["vm_valid"])[:, None], _t(case["mat_idx"]),
                              vm_inst, group=GROUP, width=float(W), height=float(H))
    rows = raster3d.build_tile_comb(dense, _t(case["consts"])[dense["slot_material"].long()])
    near = _t(case["near_eo"])
    tiles = _t(case["tiles"])
    lights = bridge.lights_from_numpy(case["lights"])
    common = (lights, _t(case["cam_pos"]), _t(case["ambient"]), _t(case["inv_vp"]), W, H, mesh)
    frames = [sharding.render_frame_sharded_production(rows, GROUP, tiles, near, *common, tile=TILE, **kw)
              for kw in ({}, dict(slot_rows=_t(case["slot_rows"]), atlas=_t(case["atlas"])))]
    band = sharding.band_tiles(tiles, W, H, n, rank, TILE)
    n_local, bh = sharding.band_plan(W, H, n, TILE)
    depth, vid, _ = rasterize_gbuffer_groups(rows, band, W, bh, GROUP, ml_near=near, tile=TILE,
                                             tile_base=rank * n_local)
    return dict(dense={k: dense[k].numpy() for k in DENSE_KEYS}, depth=depth.numpy(), vid=vid.numpy(),
                frames=[(f.numpy(), float(lum)) for f, lum in frames])


@pytest.fixture(scope="module")
def run():
    import dataclasses

    import jax
    import jax.numpy as jnp

    from oxylus_tpu.assets.bake import bake_mesh
    from oxylus_tpu.assets.material import Material, pack_materials
    from oxylus_tpu.assets.texture import Texture, TextureAtlas
    from oxylus_tpu.ops import raster3d as jr
    from oxylus_tpu.ops.cull import cull_meshlets, expand_meshlet_instances
    from oxylus_tpu.ops.sampling import pack_material_tables
    from oxylus_tpu.ops.setup3d import bin_meshlets_to_tiles, compact_triangles as jcompact, setup_triangles
    from oxylus_tpu.parallel.sharding import make_mesh, render_frame_sharded_production
    from oxylus_tpu.render.pbr import Lights
    from oxylus_tpu.render.scene3d import upload_meshes
    from tests.test_render3d import cube_mesh, look_down_z_camera

    rng = np.random.default_rng(21)
    tex_atlas = TextureAtlas(size=64)
    tex_atlas.add("t0", Texture(name="t0", pixels=rng.integers(0, 256, (32, 32, 4), dtype=np.uint8)))
    pixels, rects = tex_atlas.build()
    mats = pack_materials([Material(albedo_texture="t0", albedo_color=(0.9, 0.8, 0.7, 1.0), metallic_factor=0.3,
                                    roughness_factor=0.6)], rects, 4)
    gscene = upload_meshes([bake_mesh(*cube_mesh())], [(0, 0, 0)])
    world = jnp.broadcast_to(jnp.eye(4), (2, 4, 4)).astype(jnp.float32)
    cam = look_down_z_camera(aspect=W / H, pos=(0.6, 0.8, 3.0))
    inst, ml, valid = expand_meshlet_instances(gscene, jnp.asarray([True]), jnp.asarray([0]), 16)
    vm_i, vm_m, vm_v, _ = cull_meshlets(gscene, world, inst, ml, valid, cam.frustum_planes, cam.position,
                                        capacity=16)
    setup = setup_triangles(gscene, world, vm_i, vm_m, vm_v, cam.view_projection, W, H)
    mat_idx = gscene.inst_material[vm_i]
    dense = jcompact(setup, setup["tri_valid"] & vm_v[:, None], mat_idx, vm_i, group=GROUP, width=float(W),
                     height=float(H))
    consts = jnp.concatenate([mats.albedo_color[:, :3], mats.metallic_factor[:, None],
                              mats.roughness_factor[:, None], mats.emissive_color], axis=1)
    cm_gb, attr_gb = jr.pack_gbuffer_coeff_matrix(dense["coeffs"], dense["attr_planes"], dense["tri_valid"],
                                                  consts[dense["slot_material"]])
    near_eo = jnp.flip(jax.lax.cummax(jnp.flip(dense["ml_near"])))
    tiles, _ = bin_meshlets_to_tiles(dense, W, H, TILE, MPT)
    slot_rows = pack_material_tables(mats)[dense["slot_material"].reshape(-1)]
    atlas = jnp.asarray(pixels)
    n1 = jnp.array([0.3, -0.5, -1.0], jnp.float32)
    lights = Lights(
        kind=jnp.zeros((4,), jnp.int32), color=jnp.ones((4, 3), jnp.float32),
        intensity=jnp.full((4,), 3.0, jnp.float32), position=jnp.zeros((4, 3), jnp.float32),
        direction=jnp.broadcast_to(n1 / jnp.linalg.norm(n1), (4, 3)), radius=jnp.ones((4,), jnp.float32),
        inner_cone=jnp.zeros((4,), jnp.float32), outer_cone=jnp.ones((4,), jnp.float32),
        valid=jnp.asarray([True, False, False, False]), count=jnp.int32(1),
    )
    ambient = jnp.full((3,), 0.1, jnp.float32)
    inv_vp = jnp.linalg.inv(cam.view_projection)

    case = jax.device_get(dict(setup=setup, vm_inst=vm_i, vm_valid=vm_v, mat_idx=mat_idx, consts=consts,
                               near_eo=near_eo, tiles=tiles, slot_rows=slot_rows, atlas=atlas,
                               lights=dataclasses.asdict(lights), cam_pos=cam.position, ambient=ambient,
                               inv_vp=inv_vp))
    pool = ThreadPoolExecutor(1)  # the ranks run while the JAX side computes
    ranks = pool.submit(dryrun.spawn_ranks, _rank, RANKS, "cpu", args=(case,))
    textured = dict(slot_rows=slot_rows, atlas=atlas)
    want_frames = [jax.device_get(render_frame_sharded_production(
        cm_gb, attr_gb, tiles, near_eo, lights, cam.position, ambient, inv_vp, W, H, make_mesh(n), tile=TILE,
        raster_group=GROUP, interpret=True, **kw)) for n, kw in ((RANKS, {}), (RANKS, textured), (1, textured))]
    tx = W // TILE
    n_local, bh = tx * (H // TILE // RANKS), H // RANKS
    want_bands = [jax.device_get(jr.rasterize_gbuffer_pallas(
        cm_gb, attr_gb, tiles[b * n_local:(b + 1) * n_local], W, bh, interpret=True, ml_near=near_eo, tile=TILE,
        tile_base=b * n_local)[:2]) for b in range(RANKS)]
    ranks = ranks.result()
    pool.shutdown()
    return dict(want_frames=want_frames, want_bands=want_bands, ranks=ranks,
                want_dense={k: np.asarray(dense[k]) for k in DENSE_KEYS})


def test_band_rasters_match_the_jax_kernel(run):
    for b, r in enumerate(run["ranks"]):
        for k in DENSE_KEYS:
            np.testing.assert_array_equal(r["dense"][k], run["want_dense"][k], err_msg=k)
        want_d, want_v = run["want_bands"][b]
        np.testing.assert_array_equal(r["depth"], want_d)
        np.testing.assert_array_equal(r["vid"], want_v)
    assert any((r["vid"] >= 0).mean() > 0.05 for r in run["ranks"])


def _psnr(a, b) -> float:
    return 10 * np.log10(1.0 / max(float(np.mean((a.astype(np.float64) - b) ** 2)), 1e-30))


@pytest.mark.parametrize("textured", [False, True])
def test_production_frames_match_jax(run, textured):
    """Untextured: against JAX's frame on the 4-device mesh. Textured: against
    JAX's on one device (no seams), which the port's 4 bands reproduce by
    design, and within the bound of JAX's 4-band frame too (whose seams
    resize each band alone)."""
    want_ldr, want_lum = run["want_frames"][2 if textured else 0]
    ldr, lum = run["ranks"][0]["frames"][int(textured)]
    assert [r["frames"][int(textured)][1] for r in run["ranks"]] == [lum] * RANKS
    for r in run["ranks"][1:]:
        np.testing.assert_array_equal(r["frames"][int(textured)][0], ldr)
    np.testing.assert_allclose(lum, float(want_lum), rtol=LUM_RTOL)
    assert ldr.shape == want_ldr.shape == (H, W, 3) and bool(np.isfinite(ldr).all())
    assert _psnr(ldr, want_ldr) >= PSNR_MIN, _psnr(ldr, want_ldr)
    assert float(ldr.std()) > 0.01
    if textured:
        assert _psnr(ldr, run["want_frames"][1][0]) >= PSNR_MIN, _psnr(ldr, run["want_frames"][1][0])
        # the texture shows: the textured frame is not the untextured one
        assert float(np.abs(ldr - run["ranks"][0]["frames"][0][0]).max()) > 0.05
