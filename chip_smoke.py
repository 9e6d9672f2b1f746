"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout and drives the
port's main path on the card, at the flagship's full size (1022 falling boxes,
capacity 1024) with bodies made from a fixed seed. Every kernel-vs-plain check
calls the kernel's wrapper, `megakernel_substeps_compact`, on card tensors and
holds it against the same call with the wrapper routed to the plain PyTorch
version, on the same tensors: both sides run the wrapper's own slab-rank sort,
permutation and inverse permutation on the card.

1. set-up: a card must be visible; the kernel library is built with nvcc;
2. kernel vs plain from the start state, for 8 and for 60 substeps, with the
   bench's adaptive band and `n_planes=count_hub_planes`;
3. main path: `SceneRunner(render_mode="none", use_megakernel=True)` steps the
   flagship 120 frames; the kernel must have been launched, the state finite
   and no box below the floor. Then, on the collapsing pile, kernel vs plain at
   the main path's shapes (one substep per call, band 128, 4 planes): one
   wrapper call and 8 runner frames, each frame compared from a shared state;
4. the `physics` cell's shape: 60-substep launches with the whole-horizon
   dropped-pair gate (<= 0.2% of pair events) and end-state band coverage;
   then kernel vs plain with sleeping on, on the pile the cell has settled.

Any failed check raises, so the script exits non-zero; it also exits non-zero,
without printing a result, when no card is visible or the package is absent.
The last two lines are a JSON object describing the kernel (launch count,
error, times) and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time

import torch

DT = 1.0 / 60.0
FLAGSHIP_BOXES = 1022
TOL_8 = 1e-5  # 8 substeps of free fall, or one substep in the pile: same operation
              # order (nvcc -fmad=false); only the order of per-body sums differs, so
              # differences stay at float32 rounding
TOL_60 = {"pos": 1e-3, "linvel": 1e-2, "angvel": 5e-2, "quat": 1e-3}  # several substeps
              # in contact: the pile amplifies rounding-level differences substep by substep
RMSE_CEIL_60 = 0.05  # m: the early-RMSE ceiling of the TPU device checks, never the target
DROP_GATE = 0.002    # whole-horizon dropped-pair share, as bench.py's physics gate
WARMUP, CALLS = 2, 48
FLOOR_MID_Y = -1.0   # m: the flagship floor slab's centre plane
MAIN_FRAMES, CMP_FRAMES = 120, 8
FIELDS = ("pos", "linvel", "angvel", "quat")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn()` over `reps` runs, by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def plain_on_card(mc):
    """Route the compact wrapper to the plain PyTorch version for card tensors,
    for the reference side of a comparison; the wrapper's sort and permutation
    still run. Outside this block card tensors reach the CUDA kernel."""
    kernel = mc.run_compact
    mc.run_compact = mc.compact_substeps_reference
    try:
        yield
    finally:
        mc.run_compact = kernel


def state_err(got, want) -> dict:
    return {k: (getattr(got, k) - getattr(want, k)).abs().max().item() for k in FIELDS}


def main() -> int:
    # ---- 1. set-up ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test needs a card", file=sys.stderr)
        return 2
    from oxylus_tpu_torch import _build
    from oxylus_tpu_torch.flagship import build_flagship
    from oxylus_tpu_torch.physics import megakernel_compact as mc
    from oxylus_tpu_torch.physics.megakernel_banded import band_coverage_report, count_hub_planes
    from oxylus_tpu_torch.physics.state import BODY_DYNAMIC, PhysicsParams
    from oxylus_tpu_torch.runtime import SceneRunner

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load_kernel_library()
    print(f"[1] kernel library built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    def kernel_vs_plain(label, ps, params, tol, **kw):
        """One wrapper call with the kernel and one routed to the plain version,
        on the same card state; checks every output and returns the kernel's."""
        got, gd = mc.megakernel_substeps_compact(ps, params, DT, with_overflow=True, **kw)
        with plain_on_card(mc):
            want, wd = mc.megakernel_substeps_compact(ps, params, DT, with_overflow=True, **kw)
        err = state_err(got, want)
        rmse = (got.pos - want.pos).pow(2).sum(1).mean().sqrt().item()
        timer_err = (got.sleep_timer - want.sleep_timer).abs().max().item()
        print(f"[{label}] kernel vs plain max abs err {err}, pos RMSE {rmse:.3g} m, "
              f"sleep-timer err {timer_err:.3g} s, dropped {(gd.item(), wd.item())}", flush=True)
        check(all(bool(torch.isfinite(getattr(got, k)).all()) for k in FIELDS), f"{label}: kernel output not finite")
        check(gd.item() == wd.item(), f"{label}: dropped counts differ")
        flips = int((got.asleep != want.asleep).sum())
        check(flips == 0, f"{label}: sleep flags differ on {flips} bodies")
        check(timer_err <= TOL_8, f"{label}: sleep timers differ by {timer_err}")
        for k, e in err.items():
            check(e <= (tol[k] if isinstance(tol, dict) else tol), f"{label}: {k} error {e}")
        check(rmse < RMSE_CEIL_60, f"{label}: position RMSE {rmse}")
        return got, err

    # ---- 2. kernel vs plain from the start state -------------------------------
    ps0 = build_flagship(FLAGSHIP_BOXES, device=dev).physics_state
    params = PhysicsParams()
    rep = band_coverage_report(ps0)
    band = max(128, -(-(rep["max_rank_dist"] + 96) // 128) * 128)  # bench.py's adaptive band
    n_planes = count_hub_planes(ps0)
    n_bodies = int(ps0.active.sum())
    print(f"[2] flagship: {n_bodies} bodies, capacity {ps0.num_slots}, band {band}, planes {n_planes}, t0 coverage {rep}")
    cell_kw = dict(iterations=3, warm=0.7, geom_every=2, band=band, n_planes=n_planes)
    kernel_vs_plain("2: 8 substeps", ps0, params, TOL_8, n_substeps=8, **cell_kw)
    kernel_vs_plain("2: 60 substeps", ps0, params, TOL_60, n_substeps=60, **cell_kw)
    call60 = lambda: mc.megakernel_substeps_compact(ps0, params, DT, n_substeps=60, **cell_kw)
    kernel_ms = cuda_ms(call60, 20)
    with plain_on_card(mc):
        plain_ms = cuda_ms(call60, 2)
    print(f"[2] 60-substep wrapper call at B={ps0.num_slots}: kernel {kernel_ms:.3f} ms, plain {plain_ms:.1f} ms ({card})")

    # ---- 3. the main path: the headless runner -------------------------------
    runner = SceneRunner(build_flagship(FLAGSHIP_BOXES, device=dev), render_mode="none", use_megakernel=True)
    mc.LAUNCHES = 0
    t0 = time.perf_counter()
    runner.run(MAIN_FRAMES)
    wall = time.perf_counter() - t0
    launches = mc.LAUNCHES
    ps = runner.ps
    dyn = ps.active & (ps.body_type == BODY_DYNAMIC)
    print(f"[3] runner: {MAIN_FRAMES} frames in {wall:.3f} s = {MAIN_FRAMES / wall:.1f} frames/s ({card}); "
          f"kernel launches {launches}")
    check(launches > 0, "the runner never launched the compact kernel")
    check(bool(torch.isfinite(ps.pos).all() and torch.isfinite(ps.linvel).all()), "runner state not finite")
    world = runner.state.world
    check(bool(torch.isfinite(world).all()) and tuple(world.shape[1:]) == (4, 4), "world matrices")
    min_y = ps.pos[dyn, 1].min().item()
    print(f"[3] lowest box centre y = {min_y:.4f} m (floor slab: top 0 m, mid-plane -1 m)")
    # The frame path restarts the λ caches every substep (one kernel call per
    # substep, as the JAX frame does), so the pile sinks into the floor: the JAX
    # reference reaches -0.73 m on the CPU at frame 100. A centre past the slab's
    # mid-plane would be pushed out through the bottom by the hub plane.
    check(min_y > FLOOR_MID_Y, "a box fell through the floor")

    # Kernel vs plain at the main path's shapes, on the collapsing pile: the
    # frame path's call (one substep, default band and planes) ...
    spec = runner.scene.spec
    _, main_err = kernel_vs_plain("3: main-path call", ps, runner.physics_params, TOL_8, n_substeps=1)
    # ... then whole runner frames. Each frame starts both sides from the same
    # state, the reference a copy of the runner whose compact calls go to the
    # plain version (frame_step builds new tensors, never writes into the
    # shared ones): the pile amplifies rounding-level differences from substep
    # to substep, so frames run on free would compare the pile's sensitivity,
    # not the kernel.
    frame_err = {k: 0.0 for k in FIELDS + ("world",)}
    for _ in range(CMP_FRAMES):
        ref = copy.copy(runner)
        runner.step()
        with plain_on_card(mc):
            ref.step()
        err = state_err(runner.ps, ref.ps)
        err["world"] = (runner.state.world - ref.state.world).abs().max().item()
        frame_err = {k: max(frame_err[k], e) for k, e in err.items()}
    print(f"[3] {CMP_FRAMES} runner frames (dt {DT:.6f} s, physics interval {spec.physics_interval:.6f} s), "
          f"each from a shared state: kernel vs plain max abs err {frame_err}", flush=True)
    for k, e in frame_err.items():
        check(e <= TOL_8, f"runner frames: {k} error {e}")
    main_path_err = max(*main_err.values(), *frame_err.values())  # at the main path's shapes

    # ---- 4. the physics cell's shape ------------------------------------------
    ps = ps0
    launch_drops = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for i in range(WARMUP + CALLS):
        if i == WARMUP:
            torch.cuda.synchronize()
            start.record()
        ps, d = mc.megakernel_substeps_compact(ps, params, DT, n_substeps=60, with_overflow=True, **cell_kw)
        launch_drops.append(d)
    end.record()
    torch.cuda.synchronize()
    cell_ms = start.elapsed_time(end) / CALLS
    drops = torch.stack(launch_drops).cpu()
    pair_events = rep["pairs"] * ((WARMUP + CALLS) * 60 // 2)
    frac = float(drops.sum()) / max(pair_events, 1)
    rep_end = band_coverage_report(ps, band=band)
    rate = n_bodies * 60 / (cell_ms / 1e3)
    print(f"[4] physics cell: {cell_ms:.3f} ms per 60-substep call = {rate / 1e6:.3f} M body-steps/s ({card})")
    print(f"[4] dropped pairs: whole horizon {float(drops.sum())} ({frac * 100:.4f}% of ~{pair_events}; gate 0.2%), "
          f"per-launch max {float(drops.max())}; end-state coverage {rep_end}")
    check(frac <= DROP_GATE, f"dropped-pair share {frac}")
    check(rep_end["outside_band"] == 0, f"band coverage broke: {rep_end}")
    check(bool(torch.isfinite(ps.pos).all()), "physics cell state not finite")

    # Sleeping, off on both paths above but carried by the kernel, on the pile
    # the cell has settled. The first sleep check comes after mc.SLEEP_EVERY
    # substeps, with the velocities a run without sleeping has then; the
    # threshold goes in the widest gap of those speeds (|v|² + r²|ω|², r = 0.5 m
    # the largest half extent, as the kernel measures it) between the 50th and
    # 95th percentile. So the fastest boxes keep moving, the rest fall asleep
    # unless a moving box wakes them, and no box sits near the threshold where
    # rounding could flip it. The call runs two sleep-gated substeps past that
    # check and stops before the next; six substeps in contact take the
    # multi-substep bounds.
    dyn = ps.active & (ps.body_type == BODY_DYNAMIC)
    probe = mc.megakernel_substeps_compact(ps, params, DT, n_substeps=mc.SLEEP_EVERY, **cell_kw)
    speeds = (probe.linvel.pow(2).sum(1) + probe.angvel.pow(2).sum(1) * 0.25).sqrt()[dyn].sort().values
    lo, hi = int(0.5 * len(speeds)), int(0.95 * len(speeds))
    j = lo + int((speeds[lo + 1 : hi + 1] - speeds[lo:hi]).argmax())
    sleepy = PhysicsParams(sleep_velocity=float(speeds[j] + speeds[j + 1]) / 2, sleep_time=0.05)
    slept, _ = kernel_vs_plain(
        "4: sleeping call", ps, sleepy, TOL_60, n_substeps=mc.SLEEP_EVERY + 2, sleep=True, **cell_kw
    )
    n_asleep = int(slept.asleep[dyn].sum())
    print(f"[4] sleeping call: {n_asleep} of {int(dyn.sum())} boxes asleep (sleep velocity "
          f"{sleepy.sleep_velocity:.4f} m/s, in the speed gap {speeds[j].item():.4f}-{speeds[j + 1].item():.4f})")
    check(0 < n_asleep < int(dyn.sum()), "the sleeping call put no box, or every box, to sleep")

    print(json.dumps({"kernels": [{
        "name": "compact_substeps",
        "route": "cuda",
        "source": "oxylus_tpu_torch/physics/csrc/megakernel_compact.cu",
        "replaces": "oxylus_tpu/physics/megakernel_compact.py:75",
        "launches": launches,
        "max_abs_err": main_path_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
