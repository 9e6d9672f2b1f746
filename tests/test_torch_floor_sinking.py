"""The flagship pile sinks into the floor in the JAX package too: the port's
runners and the JAX runners, stepped for the same frames on the CPU from the
same scene, leave the same lowest box centre.

- `substep`: the default runner (`use_megakernel=False`, `physics_substep`)
  on `entry()`'s scene, 255 boxes at capacity 512 with `max_pairs=2048`;
- `dense`: the headless dense branch (`use_megakernel=True`; the JAX runner
  interprets its kernel) on 255 flagship boxes at capacity 256.

Both run 62 frames of 1/60 s, the 2 warm-up and 60 measured frames of
`chip_smoke.py`'s phases 7 and 8. Both sides compute the same float32
operations and differ in the order of sums. On the substep route the bodies
agree at rounding level until a rounding-level difference flips one discrete
contact decision (frame 49); from then on single boxes differ by
centimetres, while the lowest centre, set by the pile's bottom layer, stays
within 5e-3 m in every frame (observed ≤ 1.92e-3 m, at frame 52; the dense
route agrees to 3e-8 m), against a sinking of more than 0.1 m. The
premise: the bottom boxes end deeper than a resting box (centre 0.5 m, the
floor's top at 0 m) by more than 5 cm.

    PYTHONPATH=. python tests/test_torch_floor_sinking.py [--route dense] [--boxes 1022] [--capacity 1024]

prints both packages' lowest box centre and the largest difference of any
box's position in every frame at the given size (the dense branch at the
flagship's 1022 boxes and capacity 1024 takes some minutes on the CPU)."""

import argparse

import jax

if __name__ == "__main__":  # under pytest, conftest.py forces the CPU
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest
import torch

import __graft_entry__
from oxylus_tpu.physics.state import PhysicsParams as JParams
from oxylus_tpu.runtime import SceneRunner as JRunner
from oxylus_tpu_torch.flagship import build_flagship
from oxylus_tpu_torch.physics.state import BODY_DYNAMIC, PhysicsParams
from oxylus_tpu_torch.runtime import SceneRunner

torch.set_num_threads(1)

FRAMES = 62
ATOL = 5e-3
SIZES = {"substep": (255, 512), "dense": (255, 256)}


def lowest_centres(route: str, boxes: int, capacity: int):
    """[(frame, JAX lowest box centre y, port lowest box centre y, largest
    position difference)] for every frame."""
    spec_kw = dict(max_entities=max(512, 2 * capacity), max_bodies=capacity)
    kw = dict(render_mode="none", use_megakernel=route == "dense")
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if route == "substep":
        jkw["physics_params"], tkw["physics_params"] = JParams(max_pairs=2048), PhysicsParams(max_pairs=2048)
    jr = JRunner(__graft_entry__._build_flagship(boxes, spec_kw=spec_kw), **jkw)
    tr = SceneRunner(build_flagship(boxes, spec_kw=spec_kw, device="cpu"), **tkw)
    dyn = (tr.ps.body_type == BODY_DYNAMIC) & tr.ps.active
    out = []
    for f in range(1, FRAMES + 1):
        jr.step(1.0 / 60.0)
        tr.step(1.0 / 60.0)
        jpos = np.asarray(jax.device_get(jr.ps.pos))
        tpos = tr.ps.pos.numpy()
        out.append((f, float(jpos[dyn.numpy(), 1].min()), float(tpos[dyn.numpy(), 1].min()),
                    float(np.abs(jpos - tpos).max())))
    return out


@pytest.mark.parametrize("route", list(SIZES))
def test_pile_sinks_as_in_the_jax_package(route):
    rows = lowest_centres(route, *SIZES[route])
    for f, jy, ty, _ in rows:
        assert abs(ty - jy) <= ATOL, (f, jy, ty)
    assert rows[-1][1] < 0.5 - 0.05  # the premise: the JAX runner's pile sinks


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--route", choices=list(SIZES), default="dense")
    ap.add_argument("--boxes", type=int)
    ap.add_argument("--capacity", type=int)
    a = ap.parse_args()
    boxes, capacity = a.boxes or SIZES[a.route][0], a.capacity or SIZES[a.route][1]
    print(f"{a.route} route, {boxes} boxes, capacity {capacity}: frame, lowest box centre y (m) JAX, port, "
          f"their difference, the largest difference of any box's position (m)")
    for f, jy, ty, dp in lowest_centres(a.route, boxes, capacity):
        print(f"{f} {jy:.6f} {ty:.6f} {abs(ty - jy):.3g} {dp:.3g}", flush=True)
