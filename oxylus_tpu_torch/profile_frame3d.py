"""Where the time goes on the card, for the fused simulate-and-render 3D frame.

    python -m oxylus_tpu_torch.profile_frame3d [--frames N]

Builds the full config-5 scene (`frame5.build_frame5_scene`, 1920×1080, 150
objects, 255 boxes; atmosphere, clipmap shadows, GTAO, SSR), runs 2 warm-up
frames and FRAMES untraced frames, then traces FRAMES more with
`torch.profiler` (CUPTI) and prints, on labelled lines:

- `frame3d wall per frame`: host wall time per frame, traced and untraced;
- `frame3d device busy per frame`: the sum of the device activities' durations
  per frame (one stream) and its share of the traced and untraced wall time;
- `frame3d kernel launches per frame`: the host's kernel-launch calls, the
  launches of the port's own kernels (compact, raster, HiZ, depth raster) per
  frame, and the host reads (device-to-host copies) per frame;
- `frame3d stage <name>`: per frame, the device time of the kernels each stage
  launched, the stage's span on the device's timeline and its host time, for
  the stages of the frame (physics, the raster passes, HiZ, sky, the shadow
  maps with each clipmap level and tier, resolve, contact shadows, GTAO, PBR,
  SSR, aerial perspective, post), by `torch.profiler.record_function` ranges
  put around the stage functions for the traced frames only;
- `frame3d own kernel <name>` and `frame3d device <name>`: device time by
  kernel, the port's four kernels first.

Needs a card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import subprocess
import time

import torch

from . import runtime
from .frame5 import build_frame5_scene
from .ops import hiz, raster3d, raster_depth
from .physics import megakernel_compact as mc
from .profile_flagship import _device_events, _launches, _table
from .render import gtao, renderer3d, shadows, sky

# name prefixes of the port's own kernels (after any "(anonymous namespace)::")
OWN_KERNELS = {"compact": "k_", "raster": "raster_tiles_kernel", "hiz": "hiz_", "depth raster": "raster_depth_kernel"}
# the stage that launches each own kernel (the depth raster: the clipmap level, per call)
OWN_STAGE = {"compact": "physics (frame_step)", "raster": "tile raster", "hiz": "HiZ"}

# (module, function, stage) of every stage function wrapped in a range
STAGES = (
    (runtime, "frame_step", "physics (frame_step)"),
    (raster3d, "run_tiles", "tile raster"),
    (hiz, "build_hiz", "HiZ"),
    (sky, "sky_view_lut", "sky: view LUT"),
    (sky, "sample_sky_view", "sky: background"),
    (sky, "sky_sh_ambient", "sky: SH ambient"),
    (shadows, "mark_visible_pages", "shadows: visible pages"),
    (shadows, "render_shadow_clipmaps_cached", "shadows: clipmaps (all levels)"),
    (shadows, "resolve_shadows", "shadows: resolve"),
    (shadows, "contact_shadows", "shadows: contact"),
    (gtao, "gtao", "GTAO"),
    (gtao, "denoise_ao", "GTAO: denoise"),
    (renderer3d, "apply_pbr", "PBR"),
    (renderer3d, "apply_ssr", "SSR"),
    (sky, "aerial_lut", "aerial: LUT"),
    (sky, "apply_aerial_lut", "aerial: apply"),
    (renderer3d, "apply_bloom", "post: bloom"),
    (renderer3d, "apply_tonemap", "post: tonemap"),
    (renderer3d, "apply_fxaa", "post: FXAA"),
)


def _ranged(fn, name_of):
    def wrapped(*args, **kw):
        with torch.profiler.record_function(name_of(args)):
            return fn(*args, **kw)
    return wrapped


@contextlib.contextmanager
def stage_ranges(levels: list):
    """Wrap the stage functions in `record_function` ranges. A clipmap level's
    range is named by its level (the light matrix is a row of the (L, 4, 4)
    stack) and its tier (its capacity); the names of the levels rendered are
    appended to `levels` in call order (one depth raster launch each)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in STAGES]
    saved.append((shadows, "_render_level", shadows._render_level))
    for (mod, name, stage), (_, _, fn) in zip(STAGES, saved):
        setattr(mod, name, _ranged(fn, lambda args, stage=stage: f"stage:{stage}"))

    def level(args) -> str:
        levels.append(f"shadows: level {args[2].storage_offset() // 16} ({'full' if args[4] >= 2048 else 'small'} tier)")
        return "stage:" + levels[-1]

    shadows._render_level = _ranged(saved[-1][2], level)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _own_kernels_by_stage(events: list, levels: list) -> dict[str, float]:
    """Device µs of the port's own kernels by the stage that launched them. The
    profiler does not tie a kernel launched through the ctypes library to the
    range around it, so they are assigned here: each kind to its stage, and the
    depth raster's launches, in time order, to the levels rendered."""
    out: dict[str, float] = collections.defaultdict(float)
    by_kind = {k: sorted((e for e in events if e.name.replace("(anonymous namespace)::", "").startswith(p)),
                         key=lambda e: e.time_range.start) for k, p in OWN_KERNELS.items()}
    for kind, stage in OWN_STAGE.items():
        out[stage] += sum(e.time_range.elapsed_us() for e in by_kind[kind])
    for name, e in zip(levels, by_kind["depth raster"]):
        out[name] += e.time_range.elapsed_us()
    out["shadows: clipmaps (all levels)"] += sum(e.time_range.elapsed_us() for e in by_kind["depth raster"])
    return out


def _stage_table(prof, frames: int, own: dict[str, float]) -> None:
    """Per stage and frame: the device time of the kernels launched inside its
    range (PyTorch's, from the host-side range's `device_time_total`, plus the
    port's own from `own`), the span of the range on the device's timeline
    (first to last kernel, idle included), and the host time inside it."""
    rows = collections.defaultdict(lambda: [0.0, 0.0, 0.0, 0])
    for e in prof.events():
        if not e.name.startswith("stage:"):
            continue
        r = rows[e.name[len("stage:"):]]
        if e.device_type == torch.autograd.DeviceType.CPU:
            r[0] += e.device_time_total
            r[2] += e.cpu_time_total
            r[3] += 1
        else:  # the range as the profiler marks it on the device's timeline
            r[1] += e.time_range.elapsed_us()
    total = lambda kv: kv[1][0] + own.get(kv[0], 0.0)
    for name, (torch_us, span_us, cpu_us, n) in sorted(rows.items(), key=lambda kv: -total(kv)):
        own_us = own.get(name, 0.0)
        print(f"frame3d stage {name}: device {(torch_us + own_us) / frames / 1e3:.4f} ms (PyTorch ops "
              f"{torch_us / frames / 1e3:.4f}, own kernels {own_us / frames / 1e3:.4f}), span "
              f"{span_us / frames / 1e3:.3f} ms, host {cpu_us / frames / 1e3:.3f} ms per frame, "
              f"{n / frames:.2f} calls per frame")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    frames = ap.parse_args().frames
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame3d needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    scene, kw = build_frame5_scene(1920, 1080, device="cuda")
    runner = runtime.SceneRunner(scene, **kw)
    runner.run(2)
    t0 = time.perf_counter()
    runner.run(frames)
    untraced = (time.perf_counter() - t0) / frames
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    mods = (mc, raster3d, hiz, raster_depth)
    counts0 = [m.LAUNCHES for m in mods]
    levels: list[str] = []
    with stage_ranges(levels), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.run(frames)
        traced = (time.perf_counter() - t0) / frames
    own = [(m.LAUNCHES - c) / frames for m, c in zip(mods, counts0)]
    # the device's activities, without the stage ranges the profiler also marks on its timeline
    events = [e for e in _device_events(prof) if not e.name.startswith("stage:")]
    reads = sum(1 for e in events if "DtoH" in e.name or "Device -> Pageable" in e.name) / frames
    for name, prefix in OWN_KERNELS.items():
        mine = [e for e in events if e.name.replace("(anonymous namespace)::", "").startswith(prefix)]
        print(f"frame3d own kernel {name}: {sum(e.time_range.elapsed_us() for e in mine) / frames:.1f} us per frame "
              f"over {len(mine) / frames:.1f} device launches per frame")
    _stage_table(prof, frames, _own_kernels_by_stage(events, levels))
    busy = _table("frame3d", events, top=25) / 1e3 / frames
    print(f"frame3d wall per frame: {untraced * 1e3:.3f} ms untraced, {traced * 1e3:.3f} ms traced "
          f"({frames} frames after {frames + 2})")
    print(f"frame3d device busy per frame: {busy:.3f} ms = {100 * busy / (traced * 1e3):.1f} % of the traced, "
          f"{100 * busy / (untraced * 1e3):.1f} % of the untraced wall time; "
          f"{len(events) / frames:.1f} device activities per frame")
    print(f"frame3d kernel launches per frame: {_launches(prof) / frames:.1f} host launch calls; wrapper calls "
          f"compact {own[0]:.2f}, raster {own[1]:.2f}, hiz {own[2]:.2f}, depth raster {own[3]:.2f}; "
          f"host reads (device-to-host copies) {reads:.2f}")


if __name__ == "__main__":
    main()
