"""Where the time goes on the card, for the fused simulate-and-render 3D frame.

    python -m oxylus_tpu_torch.profile_frame3d [--frames N]

Builds the config-5 scene (`frame5.build_frame5_scene`, 1920×1080, 150 objects,
255 boxes), runs 2 warm-up frames and FRAMES untraced frames, then traces FRAMES
more with `torch.profiler` (CUPTI) and prints, on labelled lines:

- `frame3d wall per frame`: host wall time per frame, traced and untraced;
- `frame3d device busy per frame`: the sum of the device activities' durations
  per frame (one stream) and its share of the traced and untraced wall time;
- `frame3d kernel launches per frame`: the host's kernel-launch calls, and the
  launches of the port's own kernels (compact, raster, HiZ) per frame;
- `frame3d device <name>`: device time by activity name, with the port's three
  kernels first.

Needs a card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from .frame5 import build_frame5_scene
from .ops import hiz, raster3d
from .physics import megakernel_compact as mc
from .profile_flagship import _device_events, _launches, _table
from .runtime import SceneRunner

# name prefixes of the port's own kernels (after any "(anonymous namespace)::")
OWN_KERNELS = {"compact": "k_", "raster": "raster_tiles_kernel", "hiz": "hiz_"}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    frames = ap.parse_args().frames
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame3d needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    scene, kw = build_frame5_scene(1920, 1080, device="cuda")
    runner = SceneRunner(scene, **kw)
    runner.run(2)
    t0 = time.perf_counter()
    runner.run(frames)
    untraced = (time.perf_counter() - t0) / frames
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counts0 = (mc.LAUNCHES, raster3d.LAUNCHES, hiz.LAUNCHES)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.run(frames)
        traced = (time.perf_counter() - t0) / frames
    own = [(b - a) / frames for a, b in zip(counts0, (mc.LAUNCHES, raster3d.LAUNCHES, hiz.LAUNCHES))]
    events = _device_events(prof)
    for name, prefix in OWN_KERNELS.items():
        mine = [e for e in events if e.name.replace("(anonymous namespace)::", "").startswith(prefix)]
        print(f"frame3d own kernel {name}: {sum(e.time_range.elapsed_us() for e in mine) / frames:.1f} us per frame "
              f"over {len(mine) / frames:.1f} device launches per frame")
    busy = _table("frame3d", events, top=25) / 1e3 / frames
    print(f"frame3d wall per frame: {untraced * 1e3:.3f} ms untraced, {traced * 1e3:.3f} ms traced "
          f"({frames} frames after {frames + 2})")
    print(f"frame3d device busy per frame: {busy:.3f} ms = {100 * busy / (traced * 1e3):.1f} % of the traced, "
          f"{100 * busy / (untraced * 1e3):.1f} % of the untraced wall time; "
          f"{len(events) / frames:.1f} device activities per frame")
    print(f"frame3d kernel launches per frame: {_launches(prof) / frames:.1f} host launch calls; wrapper calls "
          f"compact {own[0]:.2f}, raster {own[1]:.2f}, hiz {own[2]:.2f}")


if __name__ == "__main__":
    main()
