"""The 3D frame with particles (counterpart of `bench._build_frame3d_runner`,
the JAX package's BASELINE config 3).

A camera at (0, 8, 30) pitched down, a sun, 8 point lights among the objects,
3 smoke-style emitters in view (120 particles/s, 2.5 s lifetime, rising at
1.5 m/s, no gravity), and `n_objects` meshlet objects in a grid alternating
cubes and 16×32 spheres, in `SceneSpec(max_entities=1024)` (4096 particle
slots); no rigid bodies. The runner renders the atmosphere
(`AtmosphereParams()`), clipmap shadows and the Forward2D particle composite
with the bench's raster settings (passthrough groups, 64² tiles, 192 triangle
entries and 32 group candidates per tile, 64 meshlets per tile).

    scene, runner_kw = build_frame3d_scene(1920, 1080)
    runner = SceneRunner(scene, **runner_kw)
"""

from __future__ import annotations

import numpy as np

from .assets.bake import bake_mesh
from .frame5 import cube_mesh, sphere_mesh
from .render.renderer3d import RenderSpec
from .render.sky import AtmosphereParams
from .scene.scene import Scene
from .scene.state import SceneSpec


def populate_frame3d(scene, n_objects: int = 200) -> None:
    """Create the config-3 entities in `scene`. Uses only the Scene API both
    packages share, so the parity tests build the JAX scene with it too."""
    cam = scene.create_entity("camera")
    cam.add("TransformComponent", position=(0.0, 8.0, 30.0))
    cam.add("CameraComponent", fov=60.0)
    scene.set_field(cam.index, "CameraComponent", "pitch", -0.25)
    sun = scene.create_entity("sun")
    sun.add("TransformComponent", rotation=(-0.383, 0.0, 0.0, 0.924))
    sun.add("LightComponent", type="Directional", intensity=4.0, color=(1.0, 0.95, 0.9))
    for k in range(8):
        pl = scene.create_entity(f"pt_{k}")
        pl.add("TransformComponent", position=((k - 3.5) * 6.0, 2.0, (k % 3 - 1) * 8.0))
        pl.add("LightComponent", type="Point", intensity=10.0, radius=8.0,
               color=(1.0, 0.7, 0.4) if k % 2 else (0.4, 0.7, 1.0))
    for k in range(3):
        em = scene.create_entity(f"em_{k}")
        em.add("TransformComponent", position=((k - 1) * 8.0, 1.0, 8.0))
        em.add("ParticleSystemComponent", rate_over_time=120, start_lifetime=2.5, start_velocity=(0.0, 1.5, 0.0),
               start_size=(0.5, 0.5, 0.5, 1.0), start_color=(1.0, 0.8, 0.5, 0.35), gravity_modifier=0.0)
    side = int(np.ceil(np.sqrt(n_objects)))
    for i in range(n_objects):
        e = scene.create_entity(f"obj_{i}")
        e.add("TransformComponent", position=((i % side - side / 2) * 3.0, 0.0, (i // side - side / 2) * 3.0))
        e.add("MeshComponent", mesh_index=i % 2)


RASTER = dict(compact_raster=False, tile=64, tris_per_tile=192, bin_groups_per_tile=32, meshlets_per_tile=64)


def build_frame3d_scene(width: int = 1920, height: int = 1080, n_objects: int = 200, device=None,
                        raster: dict | None = None):
    """Build the scene on `device` (the card unless "cpu") and return
    (scene, SceneRunner keyword arguments). `raster` overrides fields of
    `RASTER`, the bench's raster settings."""
    scene = Scene("meshlets", spec=SceneSpec(max_entities=1024), device=device)
    populate_frame3d(scene, n_objects)
    spec = RenderSpec(width=width, height=height, **{**RASTER, **(raster or {})})
    runner_kw = dict(
        width=width, height=height, render_mode="3d",
        meshes=[bake_mesh(*cube_mesh()), bake_mesh(*sphere_mesh(16, 32))],
        render_spec=spec, atmosphere=AtmosphereParams(), enable_shadows=True, device=scene.device,
    )
    return scene, runner_kw
