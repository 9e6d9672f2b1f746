"""The six cells of the repo's `bench.py`, on the port.

    python -m oxylus_tpu_torch.bench [physics|physics10k|frame2d|frame3d|sponza|frame5 ...]
    OX_BENCH=physics python -m oxylus_tpu_torch.bench

A named cell prints its JSON line on stdout (the metric, its value, the unit
and `vs_baseline`); its integrity gates raise when they fail, as `bench.py`'s
asserts do. With no cell named on the command line, `OX_BENCH` names the one
cell to run, as in `bench.py:707-718` (any other value, or none, runs the
suite). With no cell named at all the whole suite runs in `bench.py`'s order,
each cell's line goes to stderr as it lands (a cell that raises reports value
0 and its error), and the one stdout line is the weakest cell with `suite`,
every cell's value and `vs_baseline`; the exit code is nonzero when a cell
failed. Runs on the card.

The physics cells (rigid-body steps per second against the repo's 10 M target):
- `physics` (`bench.py::_run_physics`): the 1022-box flagship (capacity 1024),
  60-substep calls, 2 warm-up calls, then the median of 3 timed windows of 16
  calls, each ending in a sync.
- `physics10k` (`bench.py::_run_physics10k`): 10 000 boxes in 10 piles at
  capacity 10112, 8 calls per window.

The environment chooses the physics route as in `bench.py`: `OX_BENCH_KERNEL`
(`compact`, the default; `banded`; `dense`), `OX_BENCH_BANDED=0` (the legacy
switch to the dense kernel, over `OX_BENCH_KERNEL`), `OX_BENCH_MEGA=0` (60 calls of
`physics_substep` per call instead of one kernel call), `OX_BENCH_GE` (the
compact and banded kernels' geometry stride, default 2), `OX_BENCH_SLEEP=1`
(sleeping on) and `OX_BENCH_RSLOTS` (the compact kernel's neighbour slots).
`OX_BENCH_WORLDS=N` steps N copies of the scene side by side on one card
(`parallel.sharding.worlds_step`: one kernel call a world, where the JAX
bench vmaps them into one), the rate counted as body-steps × worlds; the
drop and end-coverage gates apply at one world only, as in `bench.py`.

The frame cells (frames per second at 1920×1080 against 60 frames/s): 2
warm-up frames, then the median of 3 timed windows of `SceneRunner.step`,
each ending in a sync (`bench.py::_median_fps`), on the port's builders of
the JAX bench's scenes:
- `frame2d` (config 2, `frame2d.py`): windows of 30 frames; the 2D binning's
  (tile, record) pairs past 64 a tile are printed, ungated, as the JAX
  package drops them too;
- `frame3d` (config 3, `frame3d.py`): windows of 20;
- `sponza` (config 4, `sponza.py`): windows of 12; every frame from the last
  warm-up frame on must drop nothing in the meshlet expansion
  (`expand_overflow`) or the tile binning (`bin_overflow`);
- `frame5` (config 5, `frame5.py`, the bench's K2 192 and 32 groups): windows
  of 12; the worst frame's binning drop (the pairs past the binning
  capacities, as a share of the frame's pairs binned and dropped) is printed
  and gated at 5 %.
The frame2d and frame5 runners count their binned pairs
(`SceneRunner(binning_stats=True)`: a sum per pass on the card, read after
the clock stops); the other cells' frames do not.

The environment sets the frame cells' raster knobs as `bench.py` reads them
(`raster_env`): `frame3d` takes `OX_COMPACT`, `OX_TILE`, `OX_K2`, `OX_BG` and
`OX_MPT` (`bench.py:336-340`), `frame5` `OX_COMPACT`, `OX_K2` and `OX_BG`
(`:414-416`), `sponza` `OX_CAP_MULT`, `OX_RASTER_GROUP`, `OX_TILE`, `OX_MPT`,
`OX_K2` and `OX_BG` (`:594-610`), each with `bench.py`'s default. A value the
port cannot run is refused with the variable's name: `OX_TILE` other than 16,
32 or 64 (`raster3d.TILES`), `OX_K2` other than a multiple of 64 up to
256, a count below 1, a value that is not a number. `OX_BENCH_REBAKE=1` asks
`bench.py` to rebuild its cached atrium; the port caches nothing and builds it
every run.
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
from .frame2d import build_frame2d_scene
from .frame3d import build_frame3d_scene
from .frame5 import build_frame5_scene
from .ops import raster3d
from .physics import megakernel, megakernel_banded, megakernel_compact
from .physics.megakernel_banded import band_coverage_report, count_hub_planes
from .physics.state import PhysicsParams
from .parallel.sharding import replicate_worlds, worlds_step
from .physics.step import physics_substep

TARGET = 10e6  # body-steps/s: the repo's physics target (BASELINE.json)
FRAME_TARGET = 60.0  # frames/s: the frame cells' baseline
BIN_DROP_GATE = 0.05  # frame5: the share of a frame's binned pairs its binning capacities may drop
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
    in `n_piles` piles, `steps_per_call` 60 Hz substeps per call, in `worlds`
    copies stepped side by side (`parallel.sharding.worlds_step`, one call a
    world); the rate counts body-steps × worlds.

    Gates, as `bench.py:32-216`: the adaptive rank band (the worst pair rank
    distance plus 96, rounded up to 128) covers the start state; at one world,
    with the compact kernel the pairs dropped over every launch stay within
    0.2 % of the horizon's pair events, and with any kernel the band still
    covers the end state. Returns the median window's rate (`rate`),
    `n_bodies`, `worlds`, the timed windows' seconds (`elapsed`), the band and
    the coverage reports at start and end, the dropped pairs (total, most in
    one launch, pair events; gated runs only) and the end state (`state`,
    with a leading world axis when `worlds` > 1)."""
    if worlds < 1:
        raise ValueError(f"worlds={worlds}: at least one world")
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

    gated = mega and kernel == "compact" and worlds == 1  # the route that reports dropped pairs
    if mega and kernel == "compact":
        extra = {"band": band, "n_planes": n_planes}
        if os.environ.get("OX_BENCH_RSLOTS"):
            extra["r_slots"] = int(os.environ["OX_BENCH_RSLOTS"])
        step = functools.partial(megakernel_compact.megakernel_substeps_compact, iterations=3, warm=0.7,
                                 geom_every=ge, sleep=sleep, with_overflow=gated, **extra)
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

    if worlds > 1:
        run = worlds_step(run)
        ps = replicate_worlds(ps, worlds)

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
        seg_rates.append(n_bodies * worlds * steps_per_call * calls / el)
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
    if mega and worlds == 1:
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
    """The physics route from the environment, as `bench.py:72-74` reads it."""
    kernel = os.environ.get("OX_BENCH_KERNEL", "compact")
    if os.environ.get("OX_BENCH_BANDED") == "0":  # the legacy switch
        kernel = "dense"
    return {"mega": os.environ.get("OX_BENCH_MEGA", "1") == "1", "kernel": kernel}


def _env_number(name: str, default: str, kind=int):
    raw = os.environ.get(name, default)
    try:
        value = kind(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not a number") from None
    if value <= 0:
        raise ValueError(f"{name}={raw!r}: must be above 0")
    return value


def raster_env(cell: str) -> dict:
    """The raster knobs `bench.py` reads from the environment for a frame
    cell, with its defaults: `RenderSpec` fields, and for `sponza` also
    `cap_mult`. Raises, naming the variable, for a value the port cannot run."""
    if cell == "frame3d":  # bench.py:336-340
        names = {"compact_raster": "OX_COMPACT", "tile": "OX_TILE", "tris_per_tile": "OX_K2",
                 "bin_groups_per_tile": "OX_BG", "meshlets_per_tile": "OX_MPT"}
        defaults = {"OX_TILE": "64", "OX_K2": "192", "OX_BG": "32", "OX_MPT": "64"}
    elif cell == "frame5":  # bench.py:414-416
        names = {"compact_raster": "OX_COMPACT", "tris_per_tile": "OX_K2", "bin_groups_per_tile": "OX_BG"}
        defaults = {"OX_K2": "192", "OX_BG": "32"}
    elif cell == "sponza":  # bench.py:594-610
        names = {"cap_mult": "OX_CAP_MULT", "raster_group": "OX_RASTER_GROUP", "tile": "OX_TILE",
                 "meshlets_per_tile": "OX_MPT", "tris_per_tile": "OX_K2", "bin_groups_per_tile": "OX_BG"}
        defaults = {"OX_CAP_MULT": "4", "OX_RASTER_GROUP": "64", "OX_TILE": "64", "OX_MPT": "64", "OX_K2": "256",
                    "OX_BG": "32"}
    else:
        raise ValueError(f"{cell!r} has no raster knobs")
    out = {}
    for field, name in names.items():
        if name == "OX_COMPACT":
            out[field] = os.environ.get(name, "0") == "1"
        else:
            out[field] = _env_number(name, defaults[name], float if name == "OX_CAP_MULT" else int)
    if "tile" in out and out["tile"] not in raster3d.TILES:
        raise ValueError(f"OX_TILE={out['tile']}: the tile raster route takes tiles of "
                         f"{', '.join(map(str, raster3d.TILES))} px")
    k2 = out["tris_per_tile"]
    if k2 % raster3d.TILE_ROUND or k2 > raster3d.MAX_K2:
        raise ValueError(f"OX_K2={k2}: the tile raster takes a multiple of {raster3d.TILE_ROUND} up to "
                         f"{raster3d.MAX_K2} entries a tile")
    return out


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


def _frame_windows(runner, frames: int, warmup: int = 2, windows: int = 3) -> tuple[float, list, list]:
    """`warmup` frames, then `windows` timed windows of `frames` frames, each
    ending in a sync. Returns the median window's frame rate, the warm-up
    frames' and the timed frames' `runner.frame_stats` (device tensors, read
    after the clock stops)."""
    log = functools.partial(print, file=sys.stderr, flush=True)
    warm = []
    for _ in range(warmup):
        runner.step()
        warm.append(runner.frame_stats)
    _sync(runner.device)
    rates, timed = [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(frames):
            runner.step()
            timed.append(runner.frame_stats)
        _sync(runner.device)
        rates.append(frames / (time.perf_counter() - t0))
    rates.sort()
    log(f"frame segment rates: {[f'{r:.1f}' for r in rates]}")
    return rates[len(rates) // 2], warm, timed


def _read_stats(stats: list, keys: tuple) -> list[dict]:
    """Each frame's stats as host ints, in one read."""
    if not stats:
        return []
    flat = torch.stack([st[k].reshape(()).to(torch.int64) for st in stats for k in keys]).tolist()
    return [dict(zip(keys, flat[i : i + len(keys)])) for i in range(0, len(flat), len(keys))]


def _drop_share(st: dict) -> float:
    return st["bin_overflow"] / max(st["bin_pairs"] + st["bin_overflow"], 1)


def bench_frame_2d(width=1920, height=1080, frames=30, warmup=2, device=None) -> dict:
    """Frame-steps/s on config 2 (`bench.bench_frame_2d`)."""
    from .runtime import SceneRunner

    scene, runner_kw = build_frame2d_scene(width, height, device=resolve_device(device))
    runner = SceneRunner(scene, binning_stats=True, **runner_kw)
    rate, warm, timed = _frame_windows(runner, frames, warmup)
    st = _read_stats(timed, ("tile_dropped", "tile_pairs"))
    worst = max(st, key=lambda d: d["tile_dropped"])
    print(f"frame2d binning at K=64 (ungated): worst frame dropped {worst['tile_dropped']} of "
          f"{worst['tile_pairs']} (tile, record) pairs; last frame {st[-1]['tile_dropped']} of "
          f"{st[-1]['tile_pairs']}", file=sys.stderr, flush=True)
    return {"rate": rate, "tile_dropped": worst["tile_dropped"], "tile_pairs": worst["tile_pairs"]}


def bench_frame_3d(width=1920, height=1080, frames=20, warmup=2, device=None, n_objects=200) -> dict:
    """Frame-steps/s on config 3 (`bench.bench_frame_3d`)."""
    from .runtime import SceneRunner

    scene, runner_kw = build_frame3d_scene(width, height, n_objects, device=resolve_device(device),
                                           raster=raster_env("frame3d"))
    rate, _warm, _timed = _frame_windows(SceneRunner(scene, **runner_kw), frames, warmup)
    return {"rate": rate}


def bench_frame_5(width=1920, height=1080, frames=12, warmup=2, device=None, n_objects=150, n_boxes=255) -> dict:
    """Frame-steps/s on config 5 (`bench.bench_frame_5`), with the gate on
    every frame's binning drop share."""
    from .runtime import SceneRunner

    scene, runner_kw = build_frame5_scene(width, height, n_objects, n_boxes, device=resolve_device(device),
                                          raster=raster_env("frame5"))
    rate, warm, timed = _frame_windows(SceneRunner(scene, binning_stats=True, **runner_kw), frames, warmup)
    st = _read_stats(warm + timed, ("bin_overflow", "bin_pairs", "expand_overflow"))
    worst = max(st, key=_drop_share)
    share = _drop_share(worst)
    print(f"frame5 binning drops: worst frame {100 * share:.3f} % ({worst['bin_overflow']} of "
          f"{worst['bin_overflow'] + worst['bin_pairs']} pairs; gate 5 %); expand_overflow max "
          f"{max(d['expand_overflow'] for d in st)}", file=sys.stderr, flush=True)
    _gate(share <= BIN_DROP_GATE, f"frame5 binning dropped {100 * share:.3f} % of a frame's pairs")
    return {"rate": rate, "drop_share": share}


def bench_frame_sponza(width=1920, height=1080, frames=12, warmup=2, device=None) -> dict:
    """Frame-steps/s on config 4 (`bench.bench_frame_sponza`), with the
    overflow gates on the last warm-up frame and every timed frame."""
    from .runtime import SceneRunner
    from .sponza import build_sponza_scene

    raster = raster_env("sponza")
    scene, runner_kw, info = build_sponza_scene(width, height, device=resolve_device(device),
                                                cap_mult=raster.pop("cap_mult"), raster=raster)
    print(f"sponza: {info['summary']}; host seconds {info['seconds']}; prepass {info['prepass']}",
          file=sys.stderr, flush=True)
    rate, warm, timed = _frame_windows(SceneRunner(scene, **runner_kw), frames, warmup)
    st = _read_stats(warm[-1:] + timed, ("expand_overflow", "bin_overflow"))
    for key in ("expand_overflow", "bin_overflow"):
        n = max(d[key] for d in st)
        _gate(n == 0, f"sponza frame dropped work ({key}={n})")
    return {"rate": rate, "info": info}


def _frame_cell(fps: float, metric: str) -> dict:
    return {"metric": metric, "value": round(fps, 2), "unit": "frames/s",
            "vs_baseline": round(fps / FRAME_TARGET, 4)}


def run_frame2d(device=None) -> dict:
    return _frame_cell(bench_frame_2d(device=device)["rate"], "frame-steps/sec (2D tilemap + animated sprites, 1080p)")


def run_frame3d(device=None) -> dict:
    return _frame_cell(bench_frame_3d(device=device)["rate"],
                       "frame-steps/sec (meshlet scene + sky/shadows/post, 1080p)")


def run_frame5(device=None) -> dict:
    return _frame_cell(bench_frame_5(device=device)["rate"],
                       "frame-steps/sec (full frame: visbuffer+GTAO+SSR+shadows+physics, 1080p)")


def run_sponza(device=None) -> dict:
    return _frame_cell(bench_frame_sponza(device=device)["rate"],
                       "frame-steps/sec (Sponza-class atrium: 121 meshes/1M tris/24 textured materials via GLTF "
                       "import + native bake, 1080p)")


CELLS = {"physics": run_physics, "physics10k": run_physics10k, "frame2d": run_frame2d, "frame3d": run_frame3d,
         "sponza": run_sponza, "frame5": run_frame5}


def run_suite() -> tuple[dict, bool]:
    """Every cell in order, each line on stderr as it lands; a cell that
    raises reports value 0. Returns the weakest cell with `suite` added, and
    whether every cell passed."""
    results, ok = {}, True
    for name, fn in CELLS.items():
        try:
            r = fn()
        except Exception as e:  # one failed cell must not hide the others
            ok = False
            r = {"metric": f"{name} (FAILED: {type(e).__name__}: {e})", "value": 0.0, "unit": "-",
                 "vs_baseline": 0.0}
        print(json.dumps(r), file=sys.stderr, flush=True)
        results[name] = r
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    weakest = dict(min(results.values(), key=lambda r: r["vs_baseline"]))
    weakest["suite"] = {name: {"value": r["value"], "vs_baseline": r["vs_baseline"]} for name, r in results.items()}
    return weakest, ok


def main(argv: list[str]) -> int:
    for name in argv:
        if name not in CELLS:
            print(f"unknown cell {name!r}; cells: {', '.join(CELLS)}", file=sys.stderr)
            return 2
    if not argv and os.environ.get("OX_BENCH", "all") in CELLS:
        argv = [os.environ["OX_BENCH"]]
    if not argv:
        weakest, ok = run_suite()
        print(json.dumps(weakest), flush=True)
        return 0 if ok else 1
    for name in argv:
        print(json.dumps(CELLS[name]()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
