"""Where the time goes on the card, for the flagship's physics shape.

    python -m oxylus_tpu_torch.profile_flagship

Traces with `torch.profiler` (CUPTI) and prints, on labelled lines (`physics`),
CALLS 60-substep calls of the compact kernel with the bench's adaptive band,
after one warm-up call: device time per kernel (sum, count, share), the total,
and the host's kernel-launch calls. The runner's frame is profiled by
`profile_frame3d` (the headless runner with bodies runs an unported kernel).

Needs a card; prints the card's name and power limit first.
"""

from __future__ import annotations

import collections
import subprocess

import torch

from .flagship import build_flagship
from .physics import megakernel_compact as mc
from .physics.megakernel_banded import band_coverage_report, count_hub_planes
from .physics.state import PhysicsParams

DT = 1.0 / 60.0
CALLS = 5


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_flagship needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    # --- physics shape: 60-substep calls -------------------------------------
    ps = build_flagship(device=dev).physics_state
    rep = band_coverage_report(ps)
    kw = dict(n_substeps=60, iterations=3, warm=0.7, geom_every=2,
              band=max(128, -(-(rep["max_rank_dist"] + 96) // 128) * 128), n_planes=count_hub_planes(ps))
    params = PhysicsParams()
    ps = mc.megakernel_substeps_compact(ps, params, DT, **kw)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(CALLS):
            ps = mc.megakernel_substeps_compact(ps, params, DT, **kw)
        torch.cuda.synchronize()
    events = _device_events(prof)
    total = _table("physics", events, top=15)
    print(f"physics device total: {total / 1e3:.3f} ms over {CALLS} calls = "
          f"{total / 1e3 / CALLS:.3f} ms per call (band {kw['band']}, planes {kw['n_planes']})")
    print(f"physics kernel launches: {_launches(prof)} for {CALLS} calls")


if __name__ == "__main__":
    main()
