"""The port's config-4 builder (`oxylus_tpu_torch/sponza.py`) against the same
steps done through the JAX package's modules, on the atrium cut to 8 meshes
and 4 materials at 96×64.

`bench._build_sponza_runner` cannot run here as it is: it writes its GLB and
bake into the repo's `.cache/` at 120 meshes. So the JAX side repeats its
statements with the JAX modules (procgen, glTF import, bake, `pack_tight`,
`pack_materials`, the entities, the cull prepass with its capacities), and the builder's
constants (the raster settings, the capacity headroom and floors, the
camera, the sun and point lights, the material capacity, the scene spec) are
read from `bench.py`'s source and compared with the port's.

- the built scene: the entities' transforms and components, the runner's
  gscene (instances bound to their materials through `material_slots`), the
  material table, the atlas and the prepass counts and capacities equal the
  JAX ones, with at least one masked material on a baked mesh;
- one frame at 96×64 with the atmosphere and shadows off, through both
  renderers' textured, alpha-masked tile route (the JAX one in interpret mode,
  op by op, as `tests/test_torch_render3d.py` runs it): depth and vid ≥ 99.5 %
  equal, final image PSNR ≥ 40 dB;
- FXAA on an image in [0, 1] with saturated neighbours: the port's output
  equals the JAX function's bit for bit, and both exceed 1 by a rounding
  (under 1e-6), the bound `chip_smoke.py` allows the atrium's image."""

import ast
import dataclasses
import math
import os
import re
import uuid as _uuid

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.assets.bake import bake_mesh as jbake
from oxylus_tpu.assets.gltf import load_gltf as jload
from oxylus_tpu.assets.material import ALPHA_MASK, ALPHA_OPAQUE, Material, pack_materials
from oxylus_tpu.assets.procgen import generate_atrium_glb
from oxylus_tpu.assets.texture import Texture, TextureAtlas
from oxylus_tpu.ops import cull as jcull
from oxylus_tpu.render.postfx import apply_fxaa as japply_fxaa
from oxylus_tpu.render.camera import camera_matrices as jcamera_matrices
from oxylus_tpu.render.renderer2d import SpriteBatchBindings as JBindings
from oxylus_tpu.render.renderer3d import RenderSpec as JSpec
from oxylus_tpu.render.scene3d import upload_meshes as jupload
from oxylus_tpu.runtime import SceneRunner as JRunner
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu.scene.state import SceneSpec as JSceneSpec
from oxylus_tpu_torch import bridge, sponza
from oxylus_tpu_torch.render.camera import camera_from_state
from oxylus_tpu_torch.render.postfx import apply_fxaa
from oxylus_tpu_torch.runtime import SceneRunner
from tests.test_torch_render3d import jax_device_paths, psnr
from tests.test_torch_shadows import host_branches

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N_MESHES, N_MATERIALS = 96, 64, 8, 4


def _bench_source() -> str:
    src = open(os.path.join(ROOT, "bench.py")).read()
    fn = next(n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef) and n.name == "_build_sponza_runner")
    return ast.get_source_segment(src, fn)


def _jax_side(tmp):
    """`bench._build_sponza_runner`'s steps through the JAX modules, without its cache."""
    generate_atrium_glb(tmp / "atrium.glb", n_meshes=N_MESHES, n_materials=N_MATERIALS, seed=42)
    model = jload(tmp / "atrium.glb")
    meshes, mesh_mat = [], []
    for prims in model.meshes:
        p = prims[0]
        meshes.append(jbake(p.positions, p.normals, p.uvs, p.indices, material=p.material))
        mesh_mat.append(p.material)
    nodes = [(n.mesh, n.translation, n.rotation, n.scale) for n in model.nodes if n.mesh >= 0]
    pixels, rects = TextureAtlas.pack_tight({f"tex_{i}": Texture(name=f"tex_{i}", pixels=img)
                                             for i, img in enumerate(model.images)})
    mat_uuid = [str(_uuid.UUID(int=k + 1)) for k in range(len(model.materials))]
    tex = lambda idx: f"tex_{idx}" if idx >= 0 else ""
    mats = [Material(
        albedo_color=tuple(gm.base_color), metallic_factor=float(gm.metallic),
        roughness_factor=float(gm.roughness), emissive_color=tuple(gm.emissive),
        albedo_texture=tex(gm.base_color_texture), normal_texture=tex(gm.normal_texture),
        metallic_roughness_texture=tex(gm.metallic_roughness_texture), emissive_texture=tex(gm.emissive_texture),
        occlusion_texture=tex(gm.occlusion_texture),
        alpha_mode=ALPHA_MASK if gm.alpha_mode == "MASK" else ALPHA_OPAQUE, alpha_cutoff=float(gm.alpha_cutoff),
    ) for gm in model.materials]
    gpu_mats = pack_materials(mats, rects, 256)
    # the entities, as the bench writes them
    s = JScene("atrium", spec=JSceneSpec(max_entities=512))
    cam = s.create_entity("camera")
    cam.add("TransformComponent", position=(0.0, 4.0, 9.0))
    cam.add("CameraComponent", fov=65.0)
    s.set_field(cam.index, "CameraComponent", "pitch", -0.14)
    sun = s.create_entity("sun")
    sun.add("TransformComponent", rotation=(-0.383, 0.10, 0.0, 0.918))
    sun.add("LightComponent", type="Directional", intensity=4.0, color=(1.0, 0.95, 0.9))
    for k in range(6):
        pl = s.create_entity(f"pt_{k}")
        pl.add("TransformComponent", position=((k - 2.5) * 7.0, 2.5, 0.0))
        pl.add("LightComponent", type="Point", intensity=12.0, radius=9.0,
               color=(1.0, 0.7, 0.4) if k % 2 else (0.4, 0.7, 1.0))
    for ni, (mi, t, q, sc) in enumerate(nodes):
        e = s.create_entity(f"n_{ni}")
        e.add("TransformComponent", position=tuple(t), rotation=tuple(q), scale=tuple(sc))
        e.add("MeshComponent", mesh_index=mi, material_uuid=mat_uuid[mesh_mat[mi]])
    # the prepass, as the bench writes it
    pre_gscene = jupload(meshes, [(mi, ni, 0) for ni, (mi, *_r) in enumerate(nodes)])
    pre_world = np.tile(np.eye(4, dtype=np.float32), (len(nodes), 1, 1))
    for ni, (_mi, t, q, sc) in enumerate(nodes):
        x, y, z, w = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        pre_world[ni, :3, :3] = rot * np.asarray(sc, np.float32)[None, :]
        pre_world[ni, :3, 3] = t
    f = jnp.float32
    pre_cam = jcamera_matrices(position=jnp.array([0.0, 4.0, 9.0]), yaw=f(-np.pi / 2), pitch=f(-0.14), tilt=f(0.0),
                               fov_deg=f(65.0), near=f(0.05), far=f(1000.0), zoom=f(1.0),
                               projection_kind=jnp.int32(0), aspect=f(W / H))
    proj_scale = H * float(jax.device_get(jnp.abs(pre_cam.projection[1, 1]))) / 2.0
    pv, plod = jcull.cull_instances(pre_gscene, jnp.asarray(pre_world), pre_cam.frustum_planes, pre_cam.position,
                                    proj_scale)
    pmi, pml, pmv, _ovf = jcull.expand_meshlet_instances(pre_gscene, pv, plod, 1 << 17, with_overflow=True)
    _, _, _, pcnt = jcull.cull_meshlets(pre_gscene, jnp.asarray(pre_world), pmi, pml, pmv, pre_cam.frustum_planes,
                                        pre_cam.position, capacity=1 << 16)
    n_exp, n_vis = int(jnp.sum(pmv)), int(pcnt)
    cap = 1 << max(12, int(np.ceil(np.log2(max(4 * n_exp, 1)))))
    vm_cap = 1 << max(10, int(np.ceil(np.log2(max(4 * n_vis, 1)))))
    runner = JRunner(
        s, width=W, height=H, render_mode="3d", meshes=meshes,
        render_spec=JSpec(width=W, height=H, max_meshlet_instances=cap, max_visible_meshlets=vm_cap,
                          raster_group=64, tile=64, tris_per_tile=256, bin_groups_per_tile=32, meshlets_per_tile=64,
                          gbuffer_interpret=True),
        material_slots={u: k for k, u in enumerate(mat_uuid)},
        bindings=JBindings(materials=gpu_mats, atlas=jnp.asarray(pixels),
                           entity_material_idx=jnp.zeros((s.spec.padded_entities(),), jnp.int32)),
    )
    prepass = {"expanded": n_exp, "visible": n_vis, "max_meshlet_instances": cap, "max_visible_meshlets": vm_cap}
    return runner, pixels, prepass


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    jrunner, pixels, prepass = _jax_side(tmp_path_factory.mktemp("atrium"))
    scene, kw, info = sponza.build_sponza_scene(W, H, n_meshes=N_MESHES, n_materials=N_MATERIALS, device="cpu")
    return {"jrunner": jrunner, "pixels": pixels, "prepass": prepass, "scene": scene, "kw": kw, "info": info,
            "runner": SceneRunner(scene, **kw)}


def test_builder_matches_the_jax_steps(both):
    info, runner, jrunner = both["info"], both["runner"], both["jrunner"]
    assert info["prepass"] == both["prepass"]
    assert info["summary"]["instances"] == 307 and info["masked_materials"] and info["masked_meshes"]
    np.testing.assert_array_equal(both["kw"]["bindings"].atlas.numpy(), both["pixels"])
    got_m = bridge.gpu_materials_from_numpy(jax.device_get(jrunner.bindings.materials))
    for name in ("flags", "albedo_rect", "normal_rect", "mr_rect", "occlusion_rect", "emissive_rect", "albedo_color",
                 "alpha_cutoff", "emissive_color", "roughness_factor", "metallic_factor"):
        np.testing.assert_array_equal(getattr(runner.bindings.materials, name).numpy(),
                                      getattr(got_m, name).numpy(), err_msg=name)
    got = bridge.gpu_scene_to_numpy(runner.gscene)
    want = jax.device_get(jrunner.gscene)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want, k)), err_msg=k)
    assert set(np.asarray(want.inst_material).tolist()) & set(info["masked_materials"])  # masked instances bound
    st, jst = bridge.scene_state_to_numpy(runner.state), jax.device_get(jrunner.state)
    np.testing.assert_array_equal(st["alive"], np.asarray(jst.alive))
    np.testing.assert_allclose(st["world"], np.asarray(jst.world), rtol=0, atol=1e-6)
    for comp in ("TransformComponent", "MeshComponent", "LightComponent", "CameraComponent"):
        np.testing.assert_array_equal(st["mask"][comp], np.asarray(jst.mask[comp]), err_msg=comp)
        for k, v in st["comp"][comp].items():
            if k != "material_uuid":  # u64 words here, u32 in JAX without x64; bound through inst_material above
                np.testing.assert_array_equal(v, np.asarray(jst.comp[comp][k]), err_msg=f"{comp}.{k}")
    assert runner._texture_features == jrunner._texture_features and runner._has_alpha_mask == jrunner._has_alpha_mask
    spec, jspec = runner.renderer3d.spec, jrunner.renderer3d.spec
    for fld in dataclasses.fields(spec):
        assert getattr(spec, fld.name) == getattr(jspec, fld.name), fld.name


def test_builder_constants_are_the_bench_s():
    src = _bench_source()
    env = dict(re.findall(r'os\.environ\.get\("(OX_\w+)", "([\d.]+)"\)', src))
    assert {k: int(env[v]) for k, v in (("raster_group", "OX_RASTER_GROUP"), ("tile", "OX_TILE"),
                                        ("tris_per_tile", "OX_K2"), ("bin_groups_per_tile", "OX_BG"),
                                        ("meshlets_per_tile", "OX_MPT"))} == sponza.RASTER
    assert float(env["OX_CAP_MULT"]) == sponza.CAP_MULT
    assert [int(v) for v in re.findall(r"1 << max\((\d+), int\(np\.ceil", src)] == [12, 10]
    assert f"pack_materials(mats, rects, {sponza.MATERIAL_CAPACITY})" in src
    assert "SceneSpec(max_entities=512)" in src
    cam_pos = ast.literal_eval(re.search(r'cam\.add\("TransformComponent", position=(\([^)]*\))\)', src).group(1))
    assert cam_pos == sponza.CAMERA_POS
    assert float(re.search(r'"CameraComponent", fov=([\d.]+)', src).group(1)) == sponza.CAMERA_FOV
    assert float(re.search(r'"pitch", (-?[\d.]+)\)', src).group(1)) == sponza.CAMERA_PITCH
    # the lights: build the port's scene and read them back against the source's literals
    s = JScene("lights", spec=JSceneSpec(max_entities=16))
    sponza.populate_sponza(s, [], [], [])
    sun = s.entity("sun")
    sun_rot = ast.literal_eval(re.search(r'sun\.add\("TransformComponent", rotation=(\([^)]*\))\)', src).group(1))
    np.testing.assert_allclose(s.get_component(sun.index, "TransformComponent")["rotation"], sun_rot, rtol=1e-6)
    n_pt = int(re.search(r"for k in range\((\d+)\):\s*\n\s*pl = s\.create_entity", src).group(1))
    pos_expr = re.search(r'pl\.add\("TransformComponent", position=\((.*)\)\)', src).group(1)
    pt = re.search(r'"Point", intensity=([\d.]+), radius=([\d.]+)', src)
    names = [n for n in s._names if n and n.startswith("pt_")]
    assert len(names) == n_pt
    for k in range(n_pt):
        e = s.entity(f"pt_{k}")
        want = eval(f"({pos_expr})", {"k": k})  # the source's own expression of k
        np.testing.assert_allclose(s.get_component(e.index, "TransformComponent")["position"], want, rtol=1e-6)
        light = s.get_component(e.index, "LightComponent")
        assert math.isclose(light["intensity"], float(pt.group(1)), rel_tol=1e-6)
        assert math.isclose(light["radius"], float(pt.group(2)), rel_tol=1e-6)


def test_frame_matches_jax_tile_path(both):
    """One frame with the atmosphere and shadows off, from the same state,
    gscene, camera and tables."""
    jrunner, runner = both["jrunner"], both["runner"]
    cam_idx = jrunner._resolve_camera_idx()
    jcam = __import__("oxylus_tpu.render.camera", fromlist=["camera_from_state"]).camera_from_state(
        jrunner.state, cam_idx, jnp.float32(W / H))
    with jax_device_paths(), host_branches():
        jctx = jrunner.renderer3d.render(
            jrunner.state, jrunner.gscene, jcam, jrunner.bindings.materials, jrunner.bindings.atlas, jrunner.config,
            textured=jrunner._textured, texture_features=jrunner._texture_features,
            alpha_masked=jrunner._has_alpha_mask, static_lights=jrunner._static_lights)
        want = jax.device_get({k: jctx[k] for k in ("final", "depth", "visbuffer")})
    cam = camera_from_state(runner.state, runner._resolve_camera_idx(), W / H)
    ctx = runner.renderer3d.render(
        runner.state, runner.gscene, cam, runner.bindings.materials, runner.bindings.atlas, runner.config,
        textured=runner._textured, texture_features=runner._texture_features, alpha_masked=runner._has_alpha_mask,
        static_lights=runner._static_lights)
    assert (ctx["depth"].numpy() == want["depth"]).mean() >= 0.995
    assert (ctx["visbuffer"].numpy() == want["visbuffer"]).mean() >= 0.995
    assert (want["visbuffer"] >= 0).mean() > 0.5
    assert psnr(ctx["final"].numpy(), want["final"]) >= 40.0


def test_fxaa_rounds_past_one_as_jax():
    """FXAA's bilinear weights sum to 1 only to a few ulps, so a pixel among
    saturated neighbours can come out at 1.0000001 from an input in [0, 1]:
    the JAX function does so, and the port gives the same bits."""
    rng = np.random.default_rng(12)  # half the pixels white, the rest grey levels
    img = np.where(rng.uniform(size=(64, 96, 1)) < 0.5, 1.0, rng.uniform(0, 1, (64, 96, 1))).astype(np.float32)
    img = np.repeat(img, 3, -1)
    want = np.asarray(japply_fxaa(jnp.asarray(img)))
    got = apply_fxaa(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    assert img.min() >= 0.0 and img.max() <= 1.0
    assert 1.0 < want.max() <= 1.0 + 1e-6 and got.min() >= 0.0
