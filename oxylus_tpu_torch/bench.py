"""The physics cells of the repo's `bench.py`, on the port.

    python -m oxylus_tpu_torch.bench [physics|physics10k]

prints one JSON line per cell (both when no cell is named): the metric, its
value in rigid-body steps per second, the unit and `vs_baseline` against the
repo's target of 10 M body-steps/s. Runs on the card; each cell's integrity
gates raise when they fail, as `bench.py`'s asserts do.

- `physics` (`bench.py::_run_physics`): the 1022-box flagship (capacity 1024),
  60-substep calls, 2 warm-up calls, then the median of 3 timed windows of 16
  calls, each ending in a sync.
- `physics10k` (`bench.py::_run_physics10k`): 10 000 boxes in 10 piles at
  capacity 10112, 8 calls per window.

The environment chooses the route as in `bench.py`: `OX_BENCH_KERNEL`
(`compact`, the default; `banded`; `dense`), `OX_BENCH_MEGA=0` (60 calls of
`physics_substep` per call instead of one kernel call), `OX_BENCH_GE` (the
compact and banded kernels' geometry stride, default 2), `OX_BENCH_SLEEP=1`
(sleeping on) and `OX_BENCH_RSLOTS` (the compact kernel's neighbour slots).
`OX_BENCH_WORLDS` other than 1, the JAX bench's vmapped batch of worlds, is
refused: stepping worlds side by side is not ported.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import torch

from .device import resolve_device
from .flagship import build_flagship
from .physics import megakernel, megakernel_banded, megakernel_compact
from .physics.megakernel_banded import band_coverage_report, count_hub_planes
from .physics.state import PhysicsParams
from .physics.step import physics_substep

TARGET = 10e6  # body-steps/s: the repo's physics target (BASELINE.json)
DROP_GATE = 0.002  # the compact route's dropped pairs over the whole horizon's pair events
KERNELS = ("compact", "banded", "dense")


def _gate(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"bench gate failed: {msg}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bench_physics(n_boxes=1022, steps_per_call=60, calls=16, warmup=2, mega=True, kernel="compact",
                  n_piles=1, spec_kw=None, device=None, worlds=1) -> dict:
    """Rigid-body steps per second on the flagship scene of `n_boxes` boxes
    in `n_piles` piles, one world, `steps_per_call` 60 Hz substeps per call.

    Gates, as `bench.py:32-216`: the adaptive rank band (the worst pair rank
    distance plus 96, rounded up to 128) covers the start state; with the
    compact kernel the pairs dropped over every launch stay within 0.2 % of
    the horizon's pair events; with any kernel the band still covers the end
    state. Returns the median window's rate (`rate`), `n_bodies`, `worlds`,
    the timed windows' seconds (`elapsed`), the band and the coverage reports
    at start and end, the dropped pairs (total, most in one launch, pair
    events; compact only) and the end state (`state`)."""
    if worlds != 1:
        raise ValueError("worlds > 1 (the JAX bench's vmapped batch of worlds) is not ported; use worlds=1")
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    dev = resolve_device(device)
    log = functools.partial(print, file=sys.stderr, flush=True)
    ps = build_flagship(n_boxes, n_piles=n_piles, spec_kw=spec_kw, device=dev).physics_state

    # the rank band must cover the scene's AABB-overlap pairs with headroom:
    # rank distances grow as piles collapse (bench.py:42-58)
    rep = band_coverage_report(ps)
    band = max(128, -(-(rep["max_rank_dist"] + 96) // 128) * 128)
    if band > 128:
        rep = band_coverage_report(ps, band=band)
    log(f"band coverage on bench scene (band={band}): {rep}")
    _gate(rep["outside_band"] == 0, f"bench scene breaks band coverage: {rep}")
    n_planes = count_hub_planes(ps)
    params = PhysicsParams(comm="matmul")
    n_bodies = int(ps.active.sum())
    dt = 1.0 / 60.0
    ge = int(os.environ.get("OX_BENCH_GE", "2"))
    sleep = os.environ.get("OX_BENCH_SLEEP", "0") == "1"

    gated = mega and kernel == "compact"  # the route that reports dropped pairs
    if gated:
        extra = {"band": band, "n_planes": n_planes}
        if os.environ.get("OX_BENCH_RSLOTS"):
            extra["r_slots"] = int(os.environ["OX_BENCH_RSLOTS"])
        step = functools.partial(megakernel_compact.megakernel_substeps_compact, iterations=3, warm=0.7,
                                 geom_every=ge, sleep=sleep, with_overflow=True, **extra)
    elif mega and kernel == "banded":
        # the banded kernel runs at its fixed BAND = 128, whatever the adaptive band
        step = functools.partial(megakernel_banded.megakernel_substeps_banded, iterations=3, warm=0.7,
                                 geom_every=ge, sleep=sleep)
    elif mega:
        step = megakernel.megakernel_substeps
    else:
        def step(p, prm, h, n_substeps):
            for _ in range(n_substeps):
                p = physics_substep(p, prm, h)
            return p

    drops = []  # each launch's dropped-pair count, on the device (compact)

    def run(p):
        if gated:
            p, d = step(p, params, dt, n_substeps=steps_per_call)
            drops.append(d)
            return p
        return step(p, params, dt, n_substeps=steps_per_call)

    for _ in range(warmup):
        ps = run(ps)
    _sync(dev)
    seg_rates, elapsed = [], 0.0
    for _ in range(3):  # the median of 3 windows damps one slow draw
        t0 = time.perf_counter()
        for _ in range(calls):
            ps = run(ps)
        _sync(dev)
        el = time.perf_counter() - t0
        elapsed += el
        seg_rates.append(n_bodies * steps_per_call * calls / el)
    seg_rates.sort()
    log(f"physics segment rates: {[f'{r / 1e6:.2f}M' for r in seg_rates]}")

    out = {"rate": seg_rates[1], "n_bodies": n_bodies, "worlds": worlds, "elapsed": elapsed, "band": band,
           "coverage_start": rep}
    if gated:
        # every launch is instrumented; the gate is a rate over the whole
        # horizon (t0 pair count × rebuilds), plus the worst single launch
        per_launch = torch.stack(drops).cpu()
        dropped = float(per_launch.sum())
        pair_events = rep["pairs"] * ((warmup + 3 * calls) * steps_per_call // ge)
        frac = dropped / max(pair_events, 1)
        log(f"slot-overflow dropped pairs (whole horizon): {dropped} ({frac * 100:.4f}% of ~{pair_events} pair "
            f"events; gate 0.2%); per-launch max {float(per_launch.max())}")
        _gate(frac <= DROP_GATE, f"bench scene drop rate too high: {dropped} dropped ({frac * 100:.3f}% > 0.2%)")
        out.update(dropped=dropped, dropped_max=float(per_launch.max()), pair_events=pair_events)
    if mega:
        # collapsing piles concentrate bodies into fewer slabs: the band must
        # still cover the end state
        rep_end = band_coverage_report(ps, band=band)
        log(f"band coverage at end state (band={band}): {rep_end}")
        _gate(rep_end["outside_band"] == 0, f"band coverage broke during the measured run: {rep_end}")
        out["coverage_end"] = rep_end
    out["state"] = ps
    return out


def _cell(rate: float, metric: str) -> dict:
    return {"metric": metric, "value": round(rate), "unit": "body-steps/s", "vs_baseline": round(rate / TARGET, 4)}


def _route() -> dict:
    return {"mega": os.environ.get("OX_BENCH_MEGA", "1") == "1", "kernel": os.environ.get("OX_BENCH_KERNEL", "compact")}


def run_physics(device=None) -> dict:
    """The `physics` cell: the 1022-box flagship in one world."""
    worlds = int(os.environ.get("OX_BENCH_WORLDS", "1"))
    r = bench_physics(worlds=worlds, device=device, **_route())
    return _cell(r["rate"], f"rigid-body-steps/sec (falling boxes, {r['worlds']}x{r['n_bodies']} bodies, 60Hz substeps)")


def run_physics10k(device=None) -> dict:
    """The `physics10k` cell: 10 000 boxes in 10 piles of 1000, so every
    x-slab holds few enough bodies for the band, at capacity 10112 (79
    chunks of 128, the tightest over 10 001 bodies)."""
    r = bench_physics(
        n_boxes=10000, n_piles=10, mega=True, calls=8, kernel=_route()["kernel"], device=device,
        spec_kw=dict(max_entities=16384, max_bodies=10112, max_particles=1024),
    )
    return _cell(r["rate"], f"rigid-body-steps/sec (rubble field, {r['worlds']}x{r['n_bodies']} bodies, 60Hz substeps)")


CELLS = {"physics": run_physics, "physics10k": run_physics10k}


def main(argv: list[str]) -> int:
    names = argv or list(CELLS)
    for name in names:
        if name not in CELLS:
            print(f"unknown cell {name!r}; cells: {', '.join(CELLS)}", file=sys.stderr)
            return 2
    for name in names:
        print(json.dumps(CELLS[name]()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
