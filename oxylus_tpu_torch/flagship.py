"""The flagship workload: the falling-boxes scene (counterpart of
`__graft_entry__._build_flagship` and `entry`).

A large static floor plus `n_boxes` unit-mass boxes (half extent 0.5) in a
cubic grid with seeded jitter, RNG seed 7 and the same layout as the JAX
package's function, so both packages make the same bodies. `n_piles > 1` spreads the
boxes over locally dense piles along x (the 10k-body capacity workload).
`entry()` is the repo's own frame step: 255 boxes at capacity 512 through
`frame_step` with the XLA-style substep (`physics/step.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .physics.state import PhysicsParams
from .scene.frame import frame_step
from .scene.scene import Scene
from .scene.state import SceneSpec


def build_flagship(n_boxes: int = 1022, n_piles: int = 1, spec_kw: dict | None = None, device=None) -> Scene:
    """Build and start (`runtime_start`) the falling-boxes scene on `device`
    (the card unless "cpu")."""
    kw = dict(max_entities=2048, max_bodies=1024, max_particles=1024)
    if spec_kw:
        kw.update(spec_kw)
    scene = Scene("falling_boxes", spec=SceneSpec(**kw), device=device)

    floor = scene.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0))
    floor.add("BoxColliderComponent", size=(1000.0, 1.0, 200.0), friction=0.6)

    rng = np.random.default_rng(7)
    per_pile = (n_boxes + n_piles - 1) // n_piles
    side = int(np.ceil(per_pile ** (1 / 3)))
    pile_gap = side * 1.2 + 30.0  # piles never share an x-slab rank window
    count = 0
    for pile in range(n_piles):
        x0 = (pile - (n_piles - 1) / 2) * pile_gap
        placed = 0
        for ix in range(side):
            for iy in range(side):
                for iz in range(side):
                    if count >= n_boxes or placed >= per_pile:
                        break
                    e = scene.create_entity(f"box_{count}")
                    jitter = rng.uniform(-0.05, 0.05, 3)
                    e.add(
                        "TransformComponent",
                        position=(
                            x0 + (ix - side / 2) * 1.2 + jitter[0],
                            1.0 + iy * 1.2 + jitter[1],
                            (iz - side / 2) * 1.2 + jitter[2],
                        ),
                    )
                    e.add("BoxColliderComponent", size=(0.5, 0.5, 0.5), friction=0.5)
                    e.add("RigidBodyComponent", type="Dynamic", mass=1.0)
                    count += 1
                    placed += 1

    scene.runtime_start()
    return scene


def entry(device=None):
    """Return `(fn, args)` for the flagship frame step, as
    `__graft_entry__.entry()` does: `fn(state, ps, params, dt)` is `frame_step`
    on the 255-box scene at capacity 512 with `PhysicsParams(max_pairs=2048)`
    and the physics substep of `physics/step.py`."""
    dev = resolve_device(device)
    scene = build_flagship(n_boxes=255, spec_kw=dict(max_entities=512, max_bodies=512), device=dev)
    spec = scene.spec

    def fn(state, ps, params, dt):
        return frame_step(state, ps, params, dt, spec)

    dt = torch.tensor(1.0 / 60.0, dtype=torch.float32, device=dev)
    return fn, (scene.to_device_state(), scene.physics_state, PhysicsParams(max_pairs=2048), dt)
