"""Times the depth raster (`ops/csrc/raster_depth.cu`), the compact
rigid-body kernel (`physics/csrc/megakernel_compact.cu`), the tile G-buffer
raster (`ops/csrc/raster_tiles.cu`), HiZ (`ops/csrc/hiz.cu`), the banded
and dense rigid-body kernels (`physics/csrc/megakernel_banded.cu`,
`megakernel_dense.cu`), the group G-buffer raster (`ops/csrc/raster_groups.cu`)
and the sprite blend (`ops/csrc/blend2d.cu`) at the main path's shapes on
one card, for this checkout or another one:

    python -m oxylus_tpu_torch.time_redesigns [SECTION ...]
    python oxylus_tpu_torch/time_redesigns.py --tree DIR [SECTION ...]   # DIR's oxylus_tpu_torch

SECTION names what to time, all of it when none is named: `kernels` (the
main path's and the physics cell's kernels and the bench rates below),
`dot_rhs_t`, `roll_lanes` and `dynslice` (the probes 9a, 9c's roll and 9b),
`groups` (the group raster), `blend` (the sprite blend), `products` (9d's
FFMA and bf16 products) and `tiles` (the tile raster at every tile edge).

The second form (only as a file: `-m` has imported this checkout's package
already) imports the package from DIR (for example a `git archive` of
an earlier commit, unpacked into a directory that git ignores), so two
versions of the kernels can be timed in turns on one card. Only entry points
that both versions share are called.

Prints the card's name and power limit, then one JSON object:
- `depth_levels_ms`: the config-5 runner's first frame's six full-tier shadow
  levels (1024², capacity 2048), each call's mean device time by CUDA events
  over REPS launches after one warm-up; `depth_six_ms` their sum;
  `depth_small_ms` the first small-tier call (capacity 768) of the frames
  after it. Each call is first held exactly (depth bits, vid) against
  `rasterize_depth_reference`.
- `compact_main_ms`: the main path's compact call (1 substep, the config-5
  runner's 255 boxes at capacity 512, after its frames);
  `compact_physics_ms`: a 60-substep call from the flagship's start state
  (1022 boxes, capacity 1024, the bench's adaptive band and hub planes, 3
  iterations, warm 0.7, geometry every 2 substeps); `compact_10k_ms`: the same
  from the `physics10k` start state (10 001 bodies, capacity 10112). Each
  first run through `compact_substeps_reference` on the same inputs: the
  bodies whose dropped-pair counts differ and the state rows' largest
  difference are printed (`chip_smoke.py` holds them to their bounds).
- `tiles_ms`: the tile raster's early pass (K2 = 192) and late pass (K2 =
  128) of one config-5 frame that runs both, `hiz_ms`: that frame's HiZ call;
  each `[events, graph]`: the mean device time by CUDA events over REPS calls
  back to back after one warm-up, and per call in a CUDA graph of REPS calls.
  Each call is first held exactly (depth bits, vid, G-buffer bits; every HiZ
  level) against its plain version.
- `banded_physics_ms`: a banded 60-substep call from the flagship's start
  state in the bench's configuration (3 iterations, warm 0.7, geometry every
  2 substeps); `dense_main_ms`: the dense runner's call (one substep, 10
  iterations) on the pile the headless dense runner reaches after 62 frames
  of the flagship (`chip_smoke.py` phase 7's); `dense_physics_ms`: a dense
  60-substep call from the flagship's start state (the `physics` cell's dense
  route). Each by CUDA events over REPS calls of the wrapper after one
  warm-up, first run through its plain version on the same inputs: the
  state's largest difference (`err`, and per field) and the sleep flags that
  differ are printed (`chip_smoke.py` holds them to their bounds). `*_launch_ms`: the same
  call's kernel launch alone (the arguments the wrapper passed it, without
  the wrapper's PyTorch ops); `banded_passes`, `dense_passes` (where the
  checkout's kernels split their launch, `PASS_CYCLES`): the SM cycles of
  one launch of the 60-substep calls by pass. `dense_physics_nudge`: the
  plain version's own spread over the dense 60-substep call, the largest
  difference per field after 1e-6 m/s is added to every dynamic body's
  linear velocity.
- `physics_rate`, `physics10k_rate`: the bench cells' body-steps/s
  (`bench.run_physics`, `bench.run_physics10k`; their gates hold or they
  raise); `banded_rate`, `dense_rate`: the `physics` cell's body-steps/s on
  its banded and dense routes (`bench.bench_physics(kernel=...)`).
- `dot_rhs_t_us`: the probe 9a on the script's inputs, µs per call in a
  CUDA graph of PROBE_REPS calls (`probes.time_us`); `matmul_us`:
  `torch.matmul` of the split rows, made beforehand, by mᵀ, timed the same
  way; the kernel's ratio to it. The call is first held within
  `sum_order_bound`. `roll_lanes_us`: 9c's roll of the script's (128, 384)
  block by 5, and `torch_roll_us`, `torch.roll`'s, with the ratio; the roll
  is first held exactly equal to `torch.roll` on the script's and the seeded
  cases. `dynslice_us`: 9b on the script's inputs, held exactly against its
  plain version first; `index_select_us`: `torch.index_select` of x's
  columns at the source lanes, computed beforehand: the probe's gather alone,
  without its bf16 rounding, window mask and row-0 echo, which no one call
  adds.
- `groups_ms`: the group raster's early and late pass of one config-5 frame
  on the group route (`RenderSpec(raster_path="group", compact_raster=True)`)
  that runs both; `blend2d_ms`: the config-2 2D runner's blend in its 62nd
  frame; `blend_layer_ms`: config 3's depth-tested particle layer in its 62nd
  frame. Each `[events, graph]` as `tiles_ms`, after the call is held
  exactly (depth bits, vid, G-buffer bits; colour bits, vid) against its
  plain version (`rasterize_groups_reference`, `blend_tiles_reference`).
- `tile_edges_ms`: the tile raster's early (K2 = 192) and late (K2 = 128)
  pass of one config-5 frame rendered from a shared state and a carry one
  frame old (the first of the runner's frames whose render runs both) at
  every tile edge the checkout takes (`raster3d.TILES`; 64 alone where it has
  none), by edge; each `[events, graph]` as `tiles_ms`, after the call is
  held exactly against `rasterize_tiles_reference`.
- `products`: 9d's two products at the script's five shapes, Σ over 500
  repetitions of seeded a·b, each first held within `product_bound` of
  `matmul_reference` (`of_bound`: the largest error as a share of it): `ms`,
  the kernel's device time per call in a CUDA graph of PROBE_REPS calls;
  `library_ms`, one
  `torch.matmul(a.repeat(1, 500), b.repeat(500, 1))` (the same 2·m·k·n·500
  operations in one call; operands made beforehand, TF32 off; bf16 in, bf16
  out) timed the same way; `tflops`, `to_library`, `bound_ms` (the
  operations at 67 or 989 TFLOP/s) and the checkout's launch plan. `sass`:
  the FFMA, HGMMA, HMMA, LDS and LDSM instructions of each product kernel in
  the built library (`cuobjdump -sass`), to show that the repetition loop
  was not hoisted.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

REPS = 20
PROBE_REPS = 200  # calls in the probes' CUDA graph, as `chip_smoke.py` phase 14
DT = 1.0 / 60.0
SECTIONS = ("kernels", "dot_rhs_t", "roll_lanes", "dynslice", "groups", "blend", "products", "tiles")
BLEND_FRAMES = 62  # the 2D and config-3 runners' frames before the blend is captured (chip_smoke's 2 + 60)
FIELDS = ("pos", "linvel", "angvel", "quat")


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int = REPS) -> float:
    """Device time per call of `fn` in a CUDA graph of `reps` calls (what the
    host adds per call, back to back, stays out)."""
    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


PLAIN = {"megakernel_banded": ("run_banded", "banded_substeps_reference"),
         "megakernel": ("run_dense", "dense_substeps_reference")}
CUDA = {"megakernel_banded": "_banded_cuda", "megakernel": "_dense_cuda"}  # the launch a dispatch makes


@contextlib.contextmanager
def plain_on(mod):
    """Route a kernel module's dispatch (`run_banded`, `run_dense`) to its plain
    version for card tensors while the block runs."""
    name, plain = PLAIN[mod.__name__.rsplit(".", 1)[1]]
    saved = getattr(mod, name)
    setattr(mod, name, getattr(mod, plain))
    try:
        yield
    finally:
        setattr(mod, name, saved)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None, help="the checkout whose oxylus_tpu_torch is timed")
    ap.add_argument("sections", nargs="*", choices=SECTIONS, help="what to time (all when none is named)")
    args = ap.parse_args(argv)
    want = set(args.sections or SECTIONS)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]  # run as a file: not the package dir
    if args.tree:
        sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("time_redesigns needs a card", file=sys.stderr)
        return 2
    from oxylus_tpu_torch import bench
    from oxylus_tpu_torch.flagship import build_flagship
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.ops import hiz, raster3d, raster_depth
    from oxylus_tpu_torch.physics import megakernel as mk
    from oxylus_tpu_torch.physics import megakernel_banded as mb
    from oxylus_tpu_torch.physics import megakernel_compact as mc
    from oxylus_tpu_torch.physics.megakernel_banded import band_coverage_report, count_hub_planes
    from oxylus_tpu_torch.physics.state import BODY_DYNAMIC, PhysicsParams
    from oxylus_tpu_torch.runtime import SceneRunner

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"tree": args.tree or ".", "package": raster_depth.__file__, "card": card}
    if want & {"dot_rhs_t", "roll_lanes", "dynslice"}:
        probes_section(torch, dev, out, want)
    if "groups" in want:
        groups_section(torch, dev, out)
    if "blend" in want:
        blend_section(torch, dev, out)
    if "products" in want:
        products_section(torch, dev, out)
    if "tiles" in want:
        tiles_section(torch, dev, out)
    if "kernels" not in want:
        print(json.dumps(out), flush=True)
        return 0

    # ---- the config-5 frame's captured calls: the depth raster's shadow levels, and the tile
    # raster's passes and HiZ of the first frame that runs the late pass ----
    scene, runner_kw = build_frame5_scene(1920, 1080, device=dev)
    runner = SceneRunner(scene, **runner_kw)
    calls, tiles, hizs, both = [], [], [], []
    raster, run_tiles, build_hiz = raster_depth.rasterize_depth, raster3d.run_tiles, hiz.build_hiz

    def step():
        calls.clear()
        tiles.clear()
        hizs.clear()
        runner.step()
        if not both and len(tiles) == 2 and hizs:
            both.extend([list(tiles), hizs[0]])

    raster_depth.rasterize_depth = lambda *a: (calls.append(a), raster(*a))[1]
    raster3d.run_tiles = lambda *a: (tiles.append(a), run_tiles(*a))[1]
    hiz.build_hiz = lambda *a: (hizs.append(a), build_hiz(*a))[1]
    try:
        step()
        first = list(calls)
        small = []
        for _ in range(30):
            step()
            small = [a for a in calls if a[0].shape[0] == 768]
            if small:
                break
        for _ in range(120):  # the late pass runs once the pile hides and uncovers objects
            if both:
                break
            step()
    finally:
        raster_depth.rasterize_depth, raster3d.run_tiles, hiz.build_hiz = raster, run_tiles, build_hiz
    if len(first) != 6 or not small or not both:
        raise RuntimeError(f"captured {len(first)} first-frame levels, {len(small)} small-tier calls and "
                           f"{'a' if both else 'no'} frame with both raster passes")

    def depth_ms(a):
        got, want = raster(*a), raster_depth.rasterize_depth_reference(*a)
        if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(got[1], want[1])):
            raise RuntimeError("depth raster kernel != plain")
        return cuda_ms(torch, lambda: raster(*a))

    out["depth_levels_ms"] = [depth_ms(a) for a in first]
    out["depth_six_ms"] = sum(out["depth_levels_ms"])
    out["depth_small_ms"] = depth_ms(small[0])

    # ---- the tile raster's two passes and HiZ on the frame captured above ----
    def tiles_ms(a):
        got, want = run_tiles(*a), raster3d.rasterize_tiles_reference(*a)
        if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(got[1], want[1])
                and torch.equal(got[2].view(torch.int16), want[2].view(torch.int16))):
            raise RuntimeError("tile raster kernel != plain")
        return [cuda_ms(torch, lambda: run_tiles(*a)), graph_ms(torch, lambda: run_tiles(*a))]

    out["tiles_ms"] = [tiles_ms(a) for a in both[0]]
    depth = both[1][0]
    if not all(torch.equal(g.view(torch.int32), r.view(torch.int32))
               for g, r in zip(build_hiz(depth), hiz.hiz_reference(depth))):
        raise RuntimeError("HiZ kernel != plain")
    out["hiz_ms"] = [cuda_ms(torch, lambda: build_hiz(depth)), graph_ms(torch, lambda: build_hiz(depth))]

    # ---- the compact kernel: the main path's call, the two physics shapes ----
    def compact_ms(ps, params, **kw):
        raw = []
        run = mc.run_compact

        def grab(scalars, rows, **k):
            raw.append((scalars, rows, k))
            return run(scalars, rows, **k)

        mc.run_compact = grab
        try:
            mc.megakernel_substeps_compact(ps, params, DT, **kw)
        finally:
            mc.run_compact = run
        scalars, rows, k = raw[0]
        got = mc._compact_cuda(scalars, rows, **k)
        want = mc.compact_substeps_reference(scalars, rows, **k)
        check = {"err": (got[:15] - want[:15]).abs().max().item(), "ovf_diff": int((got[15] != want[15]).sum())}
        return cuda_ms(torch, lambda: mc.megakernel_substeps_compact(ps, params, DT, **kw)), check

    out["compact_main_ms"], out["compact_main_check"] = compact_ms(runner.ps, runner.physics_params, n_substeps=1)
    params = PhysicsParams(comm="matmul")
    for key, flag in (("compact_physics", build_flagship(device=dev)),
                      ("compact_10k", build_flagship(10000, n_piles=10, device=dev, spec_kw=dict(
                          max_entities=16384, max_bodies=10112, max_particles=1024)))):
        ps = flag.physics_state
        band = max(128, -(-(band_coverage_report(ps)["max_rank_dist"] + 96) // 128) * 128)
        out[f"{key}_ms"], out[f"{key}_check"] = compact_ms(
            ps, params, n_substeps=60, iterations=3, warm=0.7, geom_every=2, band=band, n_planes=count_hub_planes(ps))

    # ---- the banded and the dense kernel: the physics cell's shapes and the dense runner's call ----
    def routed_ms(key, mod, call):
        got = call()
        with plain_on(mod):
            want = call()
        errs = {f: (getattr(got, f) - getattr(want, f)).abs().max().item() for f in FIELDS}
        out[f"{key}_check"] = {"err": max(errs.values()), "fields": errs,
                               "flips": int((got.asleep != want.asleep).sum())}
        out[f"{key}_ms"] = cuda_ms(torch, call)
        run, cuda = PLAIN[mod.__name__.rsplit(".", 1)[1]][0], CUDA[mod.__name__.rsplit(".", 1)[1]]
        dispatch, raw = getattr(mod, run), []
        setattr(mod, run, lambda *a, **k: (raw.append((a, k)), dispatch(*a, **k))[1])
        try:
            call()
        finally:
            setattr(mod, run, dispatch)
        launch = lambda: getattr(mod, cuda)(*raw[0][0], **raw[0][1])
        out[f"{key}_launch_ms"] = cuda_ms(torch, launch)
        return launch

    def passes(mod, launch):
        mod.PASS_CYCLES = torch.zeros(len(mod.PASSES), dtype=torch.int64, device=dev)
        try:
            launch()
            torch.cuda.synchronize()
            return dict(zip(mod.PASSES, mod.PASS_CYCLES.tolist()))
        finally:
            mod.PASS_CYCLES = None

    flag = build_flagship(device=dev).physics_state
    params = PhysicsParams()
    for key, mod, call in (
        ("banded_physics", mb, lambda: mb.megakernel_substeps_banded(flag, params, DT, n_substeps=60, iterations=3,
                                                                    warm=0.7, geom_every=2)),
        ("dense_physics", mk, lambda: mk.megakernel_substeps(flag, params, DT, n_substeps=60)),
    ):
        launch = routed_ms(key, mod, call)
        if hasattr(mod, "PASS_CYCLES"):
            out[f"{key.split('_')[0]}_passes"] = passes(mod, launch)
    # the plain version's own spread over that call: 1e-6 m/s added to every dynamic body's velocity
    dynamic = ((flag.body_type == BODY_DYNAMIC) & flag.active)[:, None]
    nudged = dataclasses.replace(flag, linvel=flag.linvel + 1e-6 * dynamic)
    with plain_on(mk):
        base, moved = (mk.megakernel_substeps(ps, params, DT, n_substeps=60) for ps in (flag, nudged))
    out["dense_physics_nudge"] = {f: (getattr(moved, f) - getattr(base, f)).abs().max().item() for f in FIELDS}
    dense_runner = SceneRunner(build_flagship(device=dev), render_mode="none", use_megakernel=True)
    dense_runner.run(62)
    pile = dense_runner.ps
    routed_ms("dense_main", mk, lambda: mk.megakernel_substeps(pile, dense_runner.physics_params, DT, n_substeps=1))

    # ---- the bench cells ----
    out["physics_rate"] = bench.run_physics(device=dev)["value"]
    out["physics10k_rate"] = bench.run_physics10k(device=dev)["value"]
    out["banded_rate"] = bench.bench_physics(kernel="banded", device=dev)["rate"]
    out["dense_rate"] = bench.bench_physics(kernel="dense", device=dev)["rate"]
    print(json.dumps(out), flush=True)
    return 0


def exact(torch, label, got, want) -> None:
    """Raise unless the kernel's outputs equal the plain version's bit for bit."""
    same = all(torch.equal(g.view(torch.int16 if g.element_size() == 2 else torch.int32),
                           w.view(torch.int16 if w.element_size() == 2 else torch.int32)) for g, w in zip(got, want))
    if not same:
        raise RuntimeError(f"{label}: kernel != plain")


def timed_pair(torch, fn) -> list[float]:
    return [cuda_ms(torch, fn), graph_ms(torch, fn)]


def groups_section(torch, dev, out) -> None:
    """The group raster's two passes on the config-5 group route (see the module's docstring)."""
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.ops import raster_groups
    from oxylus_tpu_torch.runtime import SceneRunner

    scene, runner_kw = build_frame5_scene(1920, 1080, device=dev)
    runner_kw["render_spec"] = dataclasses.replace(runner_kw["render_spec"], raster_path="group", compact_raster=True)
    runner = SceneRunner(scene, **runner_kw)
    run, calls = raster_groups.run_groups, []
    raster_groups.run_groups = lambda *a: (calls.append(a), run(*a))[1]
    try:
        for _ in range(120):  # the late pass runs once the pile hides and uncovers objects
            calls.clear()
            runner.step()
            if len(calls) == 2:
                break
    finally:
        raster_groups.run_groups = run
    if len(calls) != 2:
        raise RuntimeError("no config-5 group-route frame with both raster passes")
    out["groups_ms"] = []
    for a in calls:
        exact(torch, "group raster", run(*a), raster_groups.rasterize_groups_reference(*a))
        out["groups_ms"].append(timed_pair(torch, lambda: run(*a)))


def tiles_section(torch, dev, out) -> None:
    """The tile raster's two passes of one config-5 frame at every tile edge (see the module's docstring)."""
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.ops import raster3d
    from oxylus_tpu_torch.render.camera import camera_from_state
    from oxylus_tpu_torch.render.renderer3d import RendererInstance
    from oxylus_tpu_torch.runtime import SceneRunner

    scene, runner_kw = build_frame5_scene(1920, 1080, device=dev)
    runner = SceneRunner(scene, **runner_kw)
    spec = runner.renderer3d.spec
    edges = getattr(raster3d, "TILES", (64,))
    run, calls = raster3d.run_tiles, []
    for _ in range(120):  # the late pass runs once the pile hides and uncovers objects
        prev = runner.carry
        runner.step()
        cam = camera_from_state(runner.state, runner._resolve_camera_idx(), 1920 / 1080)
        passes = {}
        raster3d.run_tiles = lambda *a: (calls.append(a), run(*a))[1]
        try:
            for edge in edges:
                calls.clear()
                RendererInstance(dataclasses.replace(spec, tile=edge)).render(
                    runner.state, runner.gscene, cam, runner.bindings.materials, runner.bindings.atlas,
                    runner.config, prev=prev, atmosphere=runner.atmosphere, enable_shadows=runner.enable_shadows,
                    static_lights=runner._static_lights)
                passes[edge] = list(calls)
        finally:
            raster3d.run_tiles = run
        if all(len(c) == 2 for c in passes.values()):
            break
    else:
        raise RuntimeError("no config-5 frame with both tile raster passes")
    out["tile_edges_ms"] = {}
    for edge, pair in passes.items():
        for a in pair:
            exact(torch, f"tile raster at tile {edge}", run(*a), raster3d.rasterize_tiles_reference(*a))
        out["tile_edges_ms"][str(edge)] = [timed_pair(torch, lambda: run(*a)) for a in pair]


def blend_section(torch, dev, out) -> None:
    """The blend in the config-2 and config-3 frames (see the module's docstring)."""
    from oxylus_tpu_torch.frame2d import build_frame2d_scene
    from oxylus_tpu_torch.frame3d import build_frame3d_scene
    from oxylus_tpu_torch.ops import blend2d
    from oxylus_tpu_torch.runtime import SceneRunner

    run = blend2d.run_blend
    for key, build in (("blend2d", build_frame2d_scene), ("blend_layer", build_frame3d_scene)):
        scene, runner_kw = build(1920, 1080, device=dev)
        runner, calls = SceneRunner(scene, **runner_kw), []
        blend2d.run_blend = lambda *a: (calls.append(a), run(*a))[1]
        try:
            for _ in range(BLEND_FRAMES):
                calls.clear()
                runner.step()
        finally:
            blend2d.run_blend = run
        a = calls[-1]
        exact(torch, key, run(*a), blend2d.blend_tiles_reference(*a))
        out[f"{key}_ms"] = timed_pair(torch, lambda: run(*a))
        out[f"{key}_pairs"] = int(a[1].sum())


def probes_section(torch, dev, out, want) -> None:
    """The probes 9a, 9c's roll and 9b beside PyTorch calls (see the module's docstring)."""
    from oxylus_tpu_torch import probes
    from oxylus_tpu_torch.probes import dot_rhs_t, dynslice, mosaic_ops

    us = lambda fn: probes.time_us(fn, dev, PROBE_REPS)[0]
    if "dot_rhs_t" in want:
        v, m = dot_rhs_t.script_inputs(dev)
        diff = (dot_rhs_t.dot_rhs_t(v, m).double() - dot_rhs_t.dot_rhs_t_reference(v, m).double()).abs()
        if not bool((diff <= dot_rhs_t.sum_order_bound(v, m)).all()):
            raise RuntimeError("dot_rhs_t: kernel outside the sum-order bound of its plain version")
        vals, mt = dot_rhs_t.split_rows(v), m.t()
        out["matmul_us"] = us(lambda: torch.matmul(vals, mt))
        out["dot_rhs_t_us"] = us(lambda: dot_rhs_t.dot_rhs_t(v, m))
        out["dot_rhs_t_to_matmul"] = out["dot_rhs_t_us"] / out["matmul_us"]
    if "roll_lanes" in want:
        for name, kernel, args in mosaic_ops.script_cases(dev) + mosaic_ops.seeded_cases(41, dev):
            if kernel == "roll_lanes" and not torch.equal(mosaic_ops.roll_lanes(*args), torch.roll(args[0], args[1], 1)):
                raise RuntimeError(f"roll_lanes != torch.roll on {name}")
        x = next(args[0] for _, kernel, args in mosaic_ops.script_cases(dev) if kernel == "roll_lanes")
        out["torch_roll_us"] = us(lambda: torch.roll(x, 5, 1))
        out["roll_lanes_us"] = us(lambda: mosaic_ops.roll_lanes(x, 5))
        out["roll_lanes_to_torch_roll"] = out["roll_lanes_us"] / out["torch_roll_us"]
    if "dynslice" in want:
        x, d = dynslice.script_inputs(dev)
        if not torch.equal(dynslice.dynslice(x, d), dynslice.dynslice_reference(x, d)):
            raise RuntimeError("dynslice != its plain version")
        src = torch.clamp(torch.arange(dynslice.B, device=dev) + d[0].long(), 0, dynslice.B - 1)
        out["index_select_us"] = us(lambda: torch.index_select(x, 1, src))
        out["dynslice_us"] = us(lambda: dynslice.dynslice(x, d))



SASS_OPS = ("FFMA", "HGMMA", "HMMA", "LDS", "LDSM")


def sass_counts(lib_path) -> dict:
    """{kernel: {opcode: count}} of the product kernels in the library, from
    `cuobjdump -sass` (names demangled by cu++filt where the toolkit has it)."""
    import re
    import shutil

    tools = [shutil.which(t) or f"/usr/local/cuda/bin/{t}" for t in ("cuobjdump", "cu++filt")]
    text = subprocess.run([tools[0], "-sass", str(lib_path)], capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        head = re.match(r"\s+Function : (\S+)", line)
        if head:
            name = head.group(1) if "matmul" in head.group(1) or "product_reduce" in head.group(1) else None
            if name:
                counts[name] = dict.fromkeys(SASS_OPS, 0)
            continue
        op = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if name and op and op.group(1) in SASS_OPS:
            counts[name][op.group(1)] += 1
    if Path(tools[1]).is_file():
        names = subprocess.run([tools[1]], input="\n".join(counts), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(counts):
            counts = dict(zip(names, counts.values()))
    return counts


def products_section(torch, dev, out) -> None:
    """9d's products beside one torch.matmul of the concatenated operands (see the module's docstring)."""
    from oxylus_tpu_torch._build import build_kernel_library
    from oxylus_tpu_torch.probes import roll

    reps = roll.REPS_M
    rows = []
    for m, k, n, dtype in roll.MATMULS:
        a, b = roll.seeded_matrices(m + k + n, m, k, n, dtype, dev)
        want, tol = roll.matmul_reference(a, b, reps).double(), roll.product_bound(a, b, reps)
        flops = 2 * m * k * n * reps
        row = {"shape": [m, k, n], "dtype": str(dtype).split(".")[-1],
               "bound_ms": flops / roll.PEAK_TFLOPS[dtype] / 1e9}
        row["of_bound"] = ((roll.matmul_acc(a, b, reps).double() - want).abs() / tol).max().item()
        if not row["of_bound"] <= 1.0:
            raise RuntimeError(f"matmul {m}x{k}x{n} {row['dtype']}: {row['of_bound']} of product_bound")
        row["ms"] = graph_ms(torch, lambda: roll.matmul_acc(a, b, reps), PROBE_REPS)
        if hasattr(roll, "product_plan"):
            plan = roll.product_plan(m, k, n, reps, dtype)
            row["plan"] = {key: plan[key] for key in ("design", "tile_n", "k_slice", "rep_groups", "parts", "grid",
                                                      "threads", "smem_bytes")}
        a_cat, b_cat = a.repeat(1, reps), b.repeat(reps, 1)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            row["library_ms"] = graph_ms(torch, lambda: torch.matmul(a_cat, b_cat), PROBE_REPS)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        del a_cat, b_cat
        row["tflops"] = flops / row["ms"] / 1e9
        row["to_library"] = row["ms"] / row["library_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    out["products"] = rows
    out["sass"] = sass_counts(build_kernel_library())


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
