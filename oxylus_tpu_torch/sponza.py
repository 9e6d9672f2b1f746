"""The Sponza-class atrium (counterpart of `bench._build_sponza_runner`, the
JAX package's BASELINE config 4).

A static meshlet scene through the whole asset path: the procedural atrium
GLB (`assets/procgen.py`: 120 unique meshes plus the floor slab and the
banner sheet, 307 instances, ~1.08 M unique triangles, 24 materials with
albedo, normal and metallic-roughness maps, three emissive, two alpha-masked
lattices on 8 banners) is written to a temporary directory, imported
(`assets/gltf.py`) and baked (`assets/bake.py`, the native meshlet and LOD
bake). The images are packed into an atlas sized to its content
(`TextureAtlas.pack_tight`) and the glTF materials into the material table
(`pack_materials(..., 256)`), each material named by `UUID(int=k + 1)`
(small words, which `Scene.set_field` stores exactly).

The scene: a camera inside the court at (0, 4, 9), fov 65, pitched -0.14,
looking down the colonnade; a sun; six point lights; the 307 nodes with their
`material_uuid`. A cull prepass at that camera (instance cull and LOD,
meshlet expansion, meshlet cull) sizes the compaction capacities with 4×
headroom (floors 4096 meshlet instances, 1024 visible meshlets); the frame
gates `expand_overflow` and `bin_overflow` at 0, so an under-sized cap fails
the run rather than dropping work. The runner renders the atmosphere
(`AtmosphereParams()`), clipmap shadows, texturing and the alpha-masked pass
with the bench's raster settings (64² tiles, 256 triangle entries and 32
group candidates per tile, 64 meshlets per tile).

    scene, runner_kw, info = build_sponza_scene(1920, 1080)
    runner = SceneRunner(scene, **runner_kw)

The whole build takes about ten seconds of host time; nothing is cached.
"""

from __future__ import annotations

import math
import tempfile
import time
import uuid as _uuid
from pathlib import Path

import numpy as np
import torch

from .assets.bake import bake_mesh
from .assets.gltf import load_gltf
from .assets.material import ALPHA_MASK, ALPHA_OPAQUE, FLAG_ALPHA_MASK, Material, pack_materials
from .assets.procgen import generate_atrium_glb
from .assets.texture import Texture, TextureAtlas
from .device import resolve_device
from .ops.cull import cull_instances, cull_meshlets, expand_meshlet_instances
from .render.camera import camera_matrices
from .render.renderer2d import SpriteBatchBindings
from .render.renderer3d import RenderSpec
from .render.scene3d import upload_meshes
from .render.sky import AtmosphereParams
from .scene.scene import Scene
from .scene.state import SceneSpec

CAMERA_POS = (0.0, 4.0, 9.0)
CAMERA_FOV, CAMERA_PITCH = 65.0, -0.14
MATERIAL_CAPACITY = 256
CAP_MULT = 4  # capacity headroom over the prepass counts
RASTER = dict(raster_group=64, tile=64, tris_per_tile=256, bin_groups_per_tile=32, meshlets_per_tile=64)


def atrium_assets(n_meshes: int = 120, n_materials: int = 24, seed: int = 42) -> dict:
    """Generate the atrium GLB in a temporary directory, import and bake it.
    Returns the baked meshes, each mesh's material index, the mesh nodes as
    (mesh, translation, rotation, scale), the glTF materials and images, the
    generator's summary and the seconds each step took."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        glb = Path(tmp) / "atrium.glb"
        summary = generate_atrium_glb(glb, n_meshes=n_meshes, n_materials=n_materials, seed=seed)
        t1 = time.perf_counter()
        model = load_gltf(glb)
    t2 = time.perf_counter()
    meshes, mesh_mat = [], []
    for prims in model.meshes:
        p = prims[0]  # the generator writes one primitive per mesh
        meshes.append(bake_mesh(p.positions, p.normals, p.uvs, p.indices, material=p.material))
        mesh_mat.append(p.material)
    t3 = time.perf_counter()
    nodes = [(n.mesh, n.translation, n.rotation, n.scale) for n in model.nodes if n.mesh >= 0]
    return {"meshes": meshes, "mesh_mat": mesh_mat, "nodes": nodes, "materials": model.materials,
            "images": model.images, "summary": summary,
            "seconds": {"generate": t1 - t0, "load": t2 - t1, "bake": t3 - t2}}


def atrium_materials(gltf_materials, images, device=None):
    """The atlas (A, A, 4) uint8, the material table on `device` and the
    material uuid of each glTF material (`UUID(int=k + 1)`)."""
    pixels, rects = TextureAtlas.pack_tight(
        {f"tex_{i}": Texture(name=f"tex_{i}", pixels=img) for i, img in enumerate(images)})
    tex = lambda idx: f"tex_{idx}" if idx >= 0 else ""
    mats = [
        Material(
            albedo_color=tuple(gm.base_color), metallic_factor=float(gm.metallic),
            roughness_factor=float(gm.roughness), emissive_color=tuple(gm.emissive),
            albedo_texture=tex(gm.base_color_texture), normal_texture=tex(gm.normal_texture),
            metallic_roughness_texture=tex(gm.metallic_roughness_texture),
            emissive_texture=tex(gm.emissive_texture), occlusion_texture=tex(gm.occlusion_texture),
            alpha_mode=ALPHA_MASK if gm.alpha_mode == "MASK" else ALPHA_OPAQUE,
            alpha_cutoff=float(gm.alpha_cutoff),
        )
        for gm in gltf_materials
    ]
    mat_uuid = [str(_uuid.UUID(int=k + 1)) for k in range(len(gltf_materials))]
    return pixels, pack_materials(mats, rects, MATERIAL_CAPACITY, device=device), mat_uuid


def populate_sponza(scene, nodes, mesh_mat, mat_uuid) -> None:
    """Create the config-4 entities in `scene`. Uses only the Scene API both
    packages share, so the parity tests build the JAX scene with it too."""
    cam = scene.create_entity("camera")
    cam.add("TransformComponent", position=CAMERA_POS)
    cam.add("CameraComponent", fov=CAMERA_FOV)
    scene.set_field(cam.index, "CameraComponent", "pitch", CAMERA_PITCH)
    sun = scene.create_entity("sun")
    sun.add("TransformComponent", rotation=(-0.383, 0.10, 0.0, 0.918))
    sun.add("LightComponent", type="Directional", intensity=4.0, color=(1.0, 0.95, 0.9))
    for k in range(6):
        pl = scene.create_entity(f"pt_{k}")
        pl.add("TransformComponent", position=((k - 2.5) * 7.0, 2.5, 0.0))
        pl.add("LightComponent", type="Point", intensity=12.0, radius=9.0,
               color=(1.0, 0.7, 0.4) if k % 2 else (0.4, 0.7, 1.0))
    for ni, (mi, t, q, sc) in enumerate(nodes):
        e = scene.create_entity(f"n_{ni}")
        e.add("TransformComponent", position=tuple(t), rotation=tuple(q), scale=tuple(sc))
        e.add("MeshComponent", mesh_index=mi, material_uuid=mat_uuid[mesh_mat[mi]])


def node_worlds(nodes) -> np.ndarray:
    """(N, 4, 4) f32 world matrices of the nodes' TRS, as the JAX bench's prepass builds them."""
    world = np.tile(np.eye(4, dtype=np.float32), (len(nodes), 1, 1))
    for ni, (_mi, t, q, sc) in enumerate(nodes):
        x, y, z, w = q
        rot = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
        world[ni, :3, :3] = rot * np.asarray(sc, np.float32)[None, :]
        world[ni, :3, 3] = t
    return world


def prepass_caps(meshes, nodes, width: int, height: int, device, cap_mult: float = CAP_MULT) -> dict:
    """The cull prepass at the bench camera: the meshlet instances the
    selected LODs expand to and the meshlets that survive the cull, and the
    capacities they give (`cap_mult` headroom, 4× by default, rounded up to
    a power of two, floors 4096 and 1024)."""
    dev = resolve_device(device)
    gscene = upload_meshes(meshes, [(mi, ni, 0) for ni, (mi, *_r) in enumerate(nodes)], device=dev)
    world = torch.from_numpy(node_worlds(nodes)).to(dev)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    cam = camera_matrices(
        position=f32(CAMERA_POS), yaw=f32(-np.pi / 2), pitch=f32(CAMERA_PITCH), tilt=f32(0.0),
        fov_deg=f32(CAMERA_FOV), near=f32(0.05), far=f32(1000.0), zoom=f32(1.0),
        projection_kind=torch.tensor(0, dtype=torch.int32, device=dev), aspect=f32(width / height))
    proj_scale = height * float(torch.abs(cam.projection[1, 1])) / 2.0
    vis, lod = cull_instances(gscene, world, cam.frustum_planes, cam.position, proj_scale)
    mi_inst, mi_ml, mi_valid, _ovf = expand_meshlet_instances(gscene, vis, lod, 1 << 17, with_overflow=True)
    _, _, _, count = cull_meshlets(gscene, world, mi_inst, mi_ml, mi_valid, cam.frustum_planes, cam.position,
                                   capacity=1 << 16)
    n_exp, n_vis = (int(v) for v in torch.stack([mi_valid.sum(), count.to(torch.int64)]).tolist())
    return {"expanded": n_exp, "visible": n_vis,
            "max_meshlet_instances": 1 << max(12, int(math.ceil(math.log2(max(cap_mult * n_exp, 1))))),
            "max_visible_meshlets": 1 << max(10, int(math.ceil(math.log2(max(cap_mult * n_vis, 1)))))}


def build_sponza_scene(width: int = 1920, height: int = 1080, *, n_meshes: int = 120, n_materials: int = 24,
                       seed: int = 42, device=None, cap_mult: float = CAP_MULT, raster: dict | None = None):
    """Build the atrium on `device` (the card unless "cpu") and return (scene,
    SceneRunner keyword arguments, info): info holds the generator's summary,
    the seconds of each host step, the prepass counts and capacities, and the
    masked materials and meshes. `cap_mult` is the capacities' headroom over
    the prepass counts; `raster` overrides fields of `RASTER`, the bench's
    raster settings."""
    dev = resolve_device(device)
    assets = atrium_assets(n_meshes, n_materials, seed)
    pixels, gpu_mats, mat_uuid = atrium_materials(assets["materials"], assets["images"], device=dev)
    spec = SceneSpec(max_entities=512)
    scene = Scene("atrium", spec=spec, device=dev)
    populate_sponza(scene, assets["nodes"], assets["mesh_mat"], mat_uuid)
    t0 = time.perf_counter()
    caps = prepass_caps(assets["meshes"], assets["nodes"], width, height, dev, cap_mult)
    seconds = dict(assets["seconds"], prepass=time.perf_counter() - t0)
    render_spec = RenderSpec(width=width, height=height, max_meshlet_instances=caps["max_meshlet_instances"],
                             max_visible_meshlets=caps["max_visible_meshlets"], **{**RASTER, **(raster or {})})
    masked = [k for k, f in enumerate(gpu_mats.flags.tolist()) if f & FLAG_ALPHA_MASK]
    runner_kw = dict(
        width=width, height=height, render_mode="3d", meshes=assets["meshes"], render_spec=render_spec,
        atmosphere=AtmosphereParams(), enable_shadows=True,
        material_slots={u: k for k, u in enumerate(mat_uuid)},
        bindings=SpriteBatchBindings(
            materials=gpu_mats, atlas=torch.from_numpy(pixels).to(dev),
            entity_material_idx=torch.zeros((spec.padded_entities(),), dtype=torch.int32, device=dev),
        ),
        device=dev,
    )
    info = {"summary": assets["summary"], "seconds": seconds, "prepass": caps, "atlas": pixels.shape[0],
            "masked_materials": masked,
            "masked_meshes": [mi for mi, m in enumerate(assets["mesh_mat"]) if m in masked]}
    return scene, runner_kw, info
