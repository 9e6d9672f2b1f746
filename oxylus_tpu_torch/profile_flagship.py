"""Where the time goes on the card, for the flagship's physics.

    python -m oxylus_tpu_torch.profile_flagship [MODE ...]

Traces with `torch.profiler` (CUPTI) and prints on labelled lines, in turn,
for each MODE given (all of them if none is):

- `physics`: CALLS 60-substep calls of the compact kernel with the bench's
  adaptive band, after one warm-up call: device time per kernel (sum, count,
  share; every kernel of the route), the total, the device span from the
  first kernel's start to the last one's end with the kernels' busy share of
  it (the rest is the gaps between dependent launches), and the host's
  kernel-launch calls;
- `physics-banded`: the same for the banded kernel (its fixed band of 128),
  then how its one launch splits: each pass kind's share of block 0's SM
  cycles from barrier to barrier (`megakernel_banded.PASS_CYCLES`) over the
  same calls, and its time per call from the traced device time;
- `physics-dense`: the same for the dense kernel (60-substep calls from the
  flagship's start state, 10 iterations: the `physics` cell's dense route),
  with its pass split (`megakernel.PASS_CYCLES`);
- `dense-runner`: the headless dense runner
  (`SceneRunner(render_mode="none", use_megakernel=True)`) on the flagship,
  on its pile after WARM_FRAMES frames: FRAMES untraced frames, then FRAMES
  traced; host wall time per frame, device busy time and its share, launches
  per frame (host calls and dense-kernel wrapper calls), device time by name.

The fused 3D frame is profiled by `profile_frame3d`. Needs a card; prints
the card's name and power limit first.
"""

from __future__ import annotations

import collections
import subprocess
import sys
import time

import torch

from .flagship import build_flagship
from .physics import megakernel as mk
from .physics import megakernel_banded as mb
from .physics import megakernel_compact as mc
from .physics.megakernel_banded import band_coverage_report, count_hub_planes
from .physics.state import PhysicsParams
from .runtime import SceneRunner

DT = 1.0 / 60.0
CALLS = 5
WARM_FRAMES, FRAMES = 62, 20


def _device_events(prof) -> list:
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _launches(prof) -> int:
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
               and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel"))


def _table(tag: str, events: list, top: int) -> float:
    """Prints device time by activity name; returns the total in µs."""
    by_name: dict[str, list[float]] = collections.defaultdict(list)
    for e in events:
        by_name[e.name.replace("(anonymous namespace)::", "").split("(")[0]].append(e.time_range.elapsed_us())
    total = sum(sum(v) for v in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, d in rows[:top]:
        print(f"{tag} device {name}: {sum(d):.1f} us over {len(d)} runs = {100 * sum(d) / max(total, 1e-9):.1f} %")
    return total


def profile_physics(dev, acts, tag: str) -> None:
    """60-substep calls of the `physics` cell's kernel routes: the compact
    kernel (`physics`, with the adaptive band), the banded one
    (`physics-banded`) or the dense one (`physics-dense`)."""
    ps = build_flagship(device=dev).physics_state
    kw = dict(n_substeps=60, iterations=3, warm=0.7, geom_every=2)
    mod = None
    if tag == "physics":
        rep = band_coverage_report(ps)
        kw.update(band=max(128, -(-(rep["max_rank_dist"] + 96) // 128) * 128), n_planes=count_hub_planes(ps))
        call = mc.megakernel_substeps_compact
    elif tag == "physics-banded":
        call, mod = mb.megakernel_substeps_banded, mb
    else:
        kw = dict(n_substeps=60)
        call, mod = mk.megakernel_substeps, mk
    params = PhysicsParams()
    start = call(ps, params, DT, **kw)
    torch.cuda.synchronize()
    ps = start
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(CALLS):
            ps = call(ps, params, DT, **kw)
        torch.cuda.synchronize()
    events = _device_events(prof)
    total = _table(tag, events, top=20)
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    print(f"{tag} device total: {total / 1e3:.3f} ms over {CALLS} calls = {total / 1e3 / CALLS:.3f} ms per call "
          f"({', '.join(f'{k} {v}' for k, v in kw.items() if k != 'n_substeps')})")
    print(f"{tag} device span: {span / 1e3 / CALLS:.3f} ms per call, kernels busy {100 * total / span:.1f} % of it")
    print(f"{tag} kernel launches: {_launches(prof)} for {CALLS} calls")
    if mod is None:
        return
    # the same calls again, with the one launch's pass split collected
    name = "k_banded" if mod is mb else "k_dense"
    kernel_us = sum(e.time_range.elapsed_us() for e in events if name in e.name) / CALLS
    mod.PASS_CYCLES = torch.zeros(len(mod.PASSES), dtype=torch.int64, device=dev)
    try:
        ps = start
        for _ in range(CALLS):
            ps = call(ps, params, DT, **kw)
        torch.cuda.synchronize()
        cycles = mod.PASS_CYCLES.tolist()
    finally:
        mod.PASS_CYCLES = None
    passes = [(p, c) for p, c in zip(mod.PASSES, cycles) if not p.startswith("warps:")]
    whole = max(sum(c for _, c in passes), 1)
    print(f"{tag} {name}: {kernel_us / 1e3:.3f} ms per call; passes (share of block 0's cycles, ms per call): "
          + ", ".join(f"{p} {100 * c / whole:.1f} % {kernel_us * c / whole / 1e3:.3f}" for p, c in passes))
    split = [(p, c) for p, c in zip(mod.PASSES, cycles) if p.startswith("warps:")]
    if split:
        warps = max(sum(c for _, c in split), 1)
        print(f"{tag} {name}: the sweep warps' cycles: "
              + ", ".join(f"{p[len('warps: '):]} {100 * c / warps:.1f} %" for p, c in split))


def profile_dense_runner(dev, acts) -> None:
    """The headless dense runner's frames on the flagship pile."""
    runner = SceneRunner(build_flagship(device=dev), render_mode="none", use_megakernel=True)
    runner.run(WARM_FRAMES)
    t0 = time.perf_counter()
    runner.run(FRAMES)
    untraced = (time.perf_counter() - t0) / FRAMES
    calls0 = mk.LAUNCHES
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.run(FRAMES)
        traced = (time.perf_counter() - t0) / FRAMES
    events = _device_events(prof)
    busy = _table("dense-runner", events, top=15) / 1e3 / FRAMES
    print(f"dense-runner wall per frame: {untraced * 1e3:.3f} ms untraced, {traced * 1e3:.3f} ms traced "
          f"({FRAMES} frames after {WARM_FRAMES + FRAMES})")
    print(f"dense-runner device busy per frame: {busy:.3f} ms = {100 * busy / (traced * 1e3):.1f} % of the traced, "
          f"{100 * busy / (untraced * 1e3):.1f} % of the untraced wall time")
    print(f"dense-runner launches per frame: {_launches(prof) / FRAMES:.1f} host launch calls, "
          f"{(mk.LAUNCHES - calls0) / FRAMES:.2f} dense-kernel calls")


MODES = ("physics", "physics-banded", "physics-dense", "dense-runner")


def main(argv: list[str]) -> None:
    modes = argv or list(MODES)
    if not set(modes) <= set(MODES):
        raise SystemExit(f"profile_flagship: modes are {', '.join(MODES)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_flagship needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for mode in modes:
        if mode == "dense-runner":
            profile_dense_runner(dev, acts)
        else:
            profile_physics(dev, acts, mode)


if __name__ == "__main__":
    main(sys.argv[1:])
