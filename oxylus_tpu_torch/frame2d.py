"""The 2D frame's scene (counterpart of `bench._make_sprite_scene`, the JAX
package's BASELINE config 2).

An orthographic camera at (0, 0, 10) with zoom 8, `n_sprites` sprites of
0.5 m on a square grid over 4 layers (every 4th animated: 8 frames at 12 fps
on a 4-column sheet) and `n_emitters` particle emitters at 200 particles/s
with a 1.5 s lifetime, in `SceneSpec(max_entities=2048, max_particles=2048)`:
the raster sorts 2048 + 2048 = 4096 records a frame. The runner renders it
through `render_2d_with_particles` with the default bindings (untextured
white sprites).

    scene, runner_kw = build_frame2d_scene(1920, 1080)
    runner = SceneRunner(scene, **runner_kw)
"""

from __future__ import annotations

import numpy as np

from .scene.scene import Scene
from .scene.state import SceneSpec


def populate_frame2d(scene, n_sprites: int = 512, n_emitters: int = 2) -> None:
    """Create the config-2 entities in `scene`. Uses only the Scene API both
    packages share, so the parity tests build the JAX scene with it too."""
    cam = scene.create_entity("camera")
    cam.add("TransformComponent", position=(0.0, 0.0, 10.0))
    cam.add("CameraComponent", projection="Orthographic", zoom=8.0)
    side = int(np.ceil(np.sqrt(n_sprites)))
    for i in range(n_sprites):
        e = scene.create_entity(f"tile_{i}")
        e.add("TransformComponent", position=((i % side - side / 2) * 0.5, (i // side - side / 2) * 0.5, 0.0),
              scale=(0.5, 0.5, 1.0))
        e.add("SpriteComponent", layer=i % 4)
        if i % 4 == 0:
            e.add("SpriteAnimationComponent", num_frames=8, fps=12, columns=4)
    for i in range(n_emitters):
        e = scene.create_entity(f"em_{i}")
        e.add("TransformComponent", position=(float(i), 2.0, 0.0))
        e.add("ParticleSystemComponent", rate_over_time=200, start_lifetime=1.5)


def build_frame2d_scene(width: int = 1920, height: int = 1080, n_sprites: int = 512, n_emitters: int = 2,
                        max_entities: int = 2048, max_particles: int = 2048, device=None):
    """Build the scene on `device` (the card unless "cpu") and return
    (scene, SceneRunner keyword arguments)."""
    scene = Scene("tilemap", spec=SceneSpec(max_entities=max_entities, max_particles=max_particles), device=device)
    populate_frame2d(scene, n_sprites, n_emitters)
    runner_kw = dict(width=width, height=height, render_mode="2d", device=scene.device)
    return scene, runner_kw
