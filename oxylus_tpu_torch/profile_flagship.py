"""Where the time goes on the card, for the flagship's physics.

    python -m oxylus_tpu_torch.profile_flagship

Traces with `torch.profiler` (CUPTI) and prints on labelled lines, in turn:

- `physics`: CALLS 60-substep calls of the compact kernel with the bench's
  adaptive band, after one warm-up call: device time per kernel (sum, count,
  share; every kernel of the route), the total, the device span from the
  first kernel's start to the last one's end with the kernels' busy share of
  it (the rest is the gaps between dependent launches), and the host's
  kernel-launch calls;
- `physics-banded`: the same for the banded kernel (its fixed band of 128);
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
               and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))


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
    kernel (`physics`, with the adaptive band) or the banded one
    (`physics-banded`)."""
    ps = build_flagship(device=dev).physics_state
    kw = dict(n_substeps=60, iterations=3, warm=0.7, geom_every=2)
    if tag == "physics":
        rep = band_coverage_report(ps)
        kw.update(band=max(128, -(-(rep["max_rank_dist"] + 96) // 128) * 128), n_planes=count_hub_planes(ps))
        call = mc.megakernel_substeps_compact
    else:
        call = mb.megakernel_substeps_banded
    params = PhysicsParams()
    ps = call(ps, params, DT, **kw)
    torch.cuda.synchronize()
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_flagship needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profile_physics(dev, acts, "physics")
    profile_physics(dev, acts, "physics-banded")
    profile_dense_runner(dev, acts)


if __name__ == "__main__":
    main()
