"""The fused simulate-and-render frame's scene (counterpart of
`bench._build_frame5_runner`, the JAX package's BASELINE config 5).

A camera at (0, 8, 30) pitched down, a sun, a 100×1×100 m box-collider floor,
`n_objects` meshlet objects in a grid alternating cubes and 16×32 spheres, and
`n_boxes` dynamic unit boxes (half extent 0.5) in a cube over the floor with
seeded jitter (seed 5), capacity 512 bodies: eligible for the compact kernel.
The same seed and layout as the JAX builder, so both packages make the same
scene. The runner renders the whole config-5 frame: the atmosphere
(`AtmosphereParams()`), clipmap shadows, GTAO (on by default) and SSR, with
the bench's raster settings.

    scene, runner_kw = build_frame5_scene(1920, 1080)
    runner = SceneRunner(scene, **runner_kw)
"""

from __future__ import annotations

import numpy as np

from .assets.bake import bake_mesh
from .core.config import RendererConfig
from .render.renderer3d import RenderSpec
from .render.sky import AtmosphereParams
from .scene.scene import Scene
from .scene.state import SceneSpec


def cube_mesh(size=1.0):
    """Unit cube, CCW winding viewed from outside (glTF convention); a copy of
    `tests/test_render3d.py::cube_mesh`."""
    s = size / 2
    verts = []
    faces = []
    # 6 faces, 4 verts each
    face_defs = [
        # normal, corners (CCW from outside)
        ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
        ((0, 0, -1), [(s, -s, -s), (-s, -s, -s), (-s, s, -s), (s, s, -s)]),
        ((1, 0, 0), [(s, -s, s), (s, -s, -s), (s, s, -s), (s, s, s)]),
        ((-1, 0, 0), [(-s, -s, -s), (-s, -s, s), (-s, s, s), (-s, s, -s)]),
        ((0, 1, 0), [(-s, s, s), (s, s, s), (s, s, -s), (-s, s, -s)]),
        ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
    ]
    normals = []
    uvs = []
    for n, corners in face_defs:
        base = len(verts)
        verts.extend(corners)
        normals.extend([n] * 4)
        uvs.extend([(0, 0), (1, 0), (1, 1), (0, 1)])
        faces.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
    return (
        np.asarray(verts, np.float32),
        np.asarray(normals, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(faces, np.uint32).reshape(-1),
    )


def sphere_mesh(n_theta=24, n_phi=48, radius=1.0):
    """UV sphere; a copy of `tests/test_native_bake.py::sphere_mesh`."""
    verts = []
    for i in range(n_theta + 1):
        theta = np.pi * i / n_theta
        for j in range(n_phi):
            phi = 2 * np.pi * j / n_phi
            verts.append(
                [
                    radius * np.sin(theta) * np.cos(phi),
                    radius * np.cos(theta),
                    radius * np.sin(theta) * np.sin(phi),
                ]
            )
    verts = np.asarray(verts, np.float32)
    idx = []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = (i + 1) * n_phi + j
            d = (i + 1) * n_phi + (j + 1) % n_phi
            idx += [a, c, b, b, c, d]
    idx = np.asarray(idx, np.uint32)
    nrm = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    uv = np.zeros((len(verts), 2), np.float32)
    return verts, nrm.astype(np.float32), uv, idx


def populate_frame5(scene, n_objects: int = 150, n_boxes: int = 255) -> None:
    """Create the config-5 entities in `scene`. Uses only the Scene API both
    packages share, so the parity tests build the JAX scene with it too."""
    cam = scene.create_entity("camera")
    cam.add("TransformComponent", position=(0.0, 8.0, 30.0))
    cam.add("CameraComponent", fov=60.0)
    scene.set_field(cam.index, "CameraComponent", "pitch", -0.25)
    sun = scene.create_entity("sun")
    sun.add("TransformComponent", rotation=(-0.383, 0.0, 0.0, 0.924))
    sun.add("LightComponent", type="Directional", intensity=4.0)
    floor = scene.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0))
    floor.add("BoxColliderComponent", size=(100.0, 1.0, 100.0), friction=0.6)

    side = int(np.ceil(np.sqrt(n_objects)))
    for i in range(n_objects):
        e = scene.create_entity(f"obj_{i}")
        e.add("TransformComponent", position=((i % side - side / 2) * 3.0, 0.0, (i // side - side / 2) * 3.0))
        e.add("MeshComponent", mesh_index=i % 2)
    rng = np.random.default_rng(5)
    bside = int(np.ceil(n_boxes ** (1 / 3)))
    cnt = 0
    for ix in range(bside):
        for iy in range(bside):
            for iz in range(bside):
                if cnt >= n_boxes:
                    break
                e = scene.create_entity(f"box_{cnt}")
                j = rng.uniform(-0.05, 0.05, 3)
                e.add("TransformComponent", position=(
                    (ix - bside / 2) * 1.2 + j[0], 3.0 + iy * 1.2 + j[1], (iz - bside / 2) * 1.2 + j[2]))
                e.add("MeshComponent", mesh_index=0)
                e.add("BoxColliderComponent", size=(0.5, 0.5, 0.5))
                e.add("RigidBodyComponent", type="Dynamic", mass=1.0)
                cnt += 1


RASTER = dict(compact_raster=False, tris_per_tile=192, bin_groups_per_tile=32)


def build_frame5_scene(width: int = 1920, height: int = 1080, n_objects: int = 150, n_boxes: int = 255,
                       max_bodies: int = 512, device=None, raster: dict | None = None):
    """Build the scene on `device` (the card unless "cpu") and return
    (scene, SceneRunner keyword arguments). `raster` overrides fields of
    `RASTER`, the bench's raster settings."""
    scene = Scene("full_frame", spec=SceneSpec(max_entities=1024, max_bodies=max_bodies), device=device)
    populate_frame5(scene, n_objects, n_boxes)
    scene.renderer_config = RendererConfig(ssr_enable=True)
    # the bench's raster settings: passthrough groups, 192 triangle entries and
    # 32 group candidates per tile
    spec = RenderSpec(width=width, height=height, **{**RASTER, **(raster or {})})
    runner_kw = dict(
        width=width, height=height, render_mode="3d",
        meshes=[bake_mesh(*cube_mesh()), bake_mesh(*sphere_mesh(16, 32))],
        render_spec=spec, use_megakernel=True, atmosphere=AtmosphereParams(), enable_shadows=True,
        device=scene.device,
    )
    return scene, runner_kw
