"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (the compact rigid-body kernel, the tile
G-buffer raster, the HiZ pyramid, the dense rigid-body kernel, the
depth-only shadow raster, the sprite blend, the banded rigid-body kernel,
the group-hit G-buffer raster and the Hopper probes) from the sources in this
checkout and drives
the port's paths on the card: the fused
simulate-and-render 3D frame of the config-5 scene at its full size
(1920×1080, 150 meshlet objects, 255 falling boxes, capacity 512), without
the atmosphere, shadows, GTAO and SSR (phase 3) and whole (phase 9), the
headless dense runner on the flagship (1022 boxes, capacity 1024), the
default runner on `entry()`'s scene (255 boxes, capacity 512), the 2D runner
on config 2 (phase 10), the 3D frame with particles on config 3 (phase
11), the physics bench cells (phase 12), the config-5 frame through the
group raster route (phase 13) and the Hopper probes (phase 14), with bodies
made from a fixed seed. Every
kernel-vs-plain check runs the kernel and its plain PyTorch version on the
same card tensors through the kernel's wrapper
(`megakernel_substeps_compact` and `megakernel_substeps_banded`, with their
sort and permutations; `megakernel_substeps`; `rasterize_depth`;
`run_blend`; `run_groups`).

1. set-up: a card must be visible; the kernel library is built with nvcc (one
   process per source, in parallel); the meshes are baked;
2. compact kernel vs plain from the flagship's start state, for 8 and for 60
   substeps, with the bench's adaptive band and `n_planes=count_hub_planes`;
3. slice 2's main path: `SceneRunner(**build_frame5_scene(1920, 1080)[1])`
   with the atmosphere, shadows, GTAO and SSR off runs 2
   warm-up frames, then 60 frames with every kernel's launch count set to 0
   just before; each kernel must have launched, the image be finite in [0, 1],
   the meshlet expansion may have dropped nothing (`expand_overflow`), no box
   may have fallen through the floor, and in none of the 60 frames may the
   binning capacity have dropped (`bin_overflow`) more than 5 % of the frame's
   pairs. Then the compact kernel vs plain at the main path's
   shapes: one wrapper call and 4 runner frames, each frame from a shared
   state;
4. the `physics` cell's shape on the flagship: 60-substep launches with the
   whole-horizon dropped-pair gate (<= 0.2% of pair events) and end-state band
   coverage; then compact vs plain with sleeping on, on the settled pile;
5. raster and HiZ kernels vs plain at the main path's shapes: one frame's
   raster inputs (the early pass, K2 = 192, and the late pass, K2 = 128, when a
   late pass runs) and HiZ input are captured and run through the wrappers
   `run_tiles` / `build_hiz` and through the plain versions (exactly equal),
   each wrapper timed with CUDA events; the early pass is binned again at
   K2 = 256, the most the vid's entry field holds, to report what that
   capacity would drop; then one frame is rendered with the kernels and with
   the plain versions from a shared state, and the two images must be equal;
6. the dense kernel vs plain from the flagship's start state, 8 free-fall
   substeps in one call (the contact half of this phase runs after phase 7,
   on its pile);
7. the headless dense runner, `SceneRunner(render_mode="none",
   use_megakernel=True)` on the flagship: 2 warm-up frames, then 60 frames
   with every launch count set to 0 just before; the dense kernel must have
   launched, the state be finite and no box centre below the floor's
   mid-plane; then 4 runner frames, each from a shared state, kernel vs plain;
   then phase 6's contact check: one substep from the pile, kernel vs plain,
   both timed, and the operations bound on that pile's pairs and points
   (`megakernel.pair_work`);
8. the default runner (`use_megakernel=False`, `physics_substep`) on
   `entry()`'s scene with `max_pairs=2048`: 60 frames, the broadphase's
   pairs and dropped pairs in every substep of them, the same state gates;
   `entry()`'s own frame step for 2 frames; then a few frames with
   `track_contacts=True`, counting the contact and activation callbacks;
9. the full config-5 frame, `SceneRunner(**build_frame5_scene(1920, 1080)[1])`
   (atmosphere, page-cached clipmap shadows through the depth raster, GTAO,
   SSR, aerial perspective): 2 warm-up frames, then 60 frames with every
   launch count set to 0 just before; all four of its kernels must have
   launched (the depth raster's launches per frame are printed), the image be
   finite in [0, 1], `expand_overflow` 0, phase 3's binning-drop gate hold in
   every frame and no box centre fall below y = -1 m. Then the depth raster
   vs plain, exactly equal (depth bits and vid), on the inputs captured in the
   first warm-up frame (no shadow cache: all six levels at the full tier) and
   in the first timed frame that renders a level at the small tier; the six
   full-tier calls timed with CUDA events against their plain versions and
   their bound; and one frame rendered with the kernels and with the plain
   versions from a shared state and carry (the carry one frame old, so shadow
   pages re-render), which must be identical;
10. config 2, `SceneRunner(**build_frame2d_scene(1920, 1080)[1])` (512
   sprites on 4 layers, 2 emitters, 4096 records a frame): 2 warm-up frames,
   then 60 frames with every launch count set to 0 just before; one blend
   launch per frame, the image finite in [0, 1] up to float32 rounding, the
   vids in [-1, 2048);
   then the blend kernel vs plain on one frame's captured inputs (colour bits
   and vid exactly equal), both timed, with the bound from those inputs, and
   on seeded, varied inputs at the same packed shapes (config 2's texel
   planes are all one white): random texel planes and tints, flipped,
   untextured and alpha-masked entries, full and empty tiles;
11. config 3, `SceneRunner(**build_frame3d_scene(1920, 1080)[1])` (200
   meshlet objects, 8 point lights, 3 emitters, atmosphere, shadows, GTAO,
   the quarter-resolution particle layer): every launch count set to 0, then
   2 warm-up frames and 60 timed frames (the static scene's shadow pages
   render in the first frame only); the depth-tested blend launched once per
   frame, the tile raster, HiZ and depth raster launched,
   the image finite in [0, 1]; the blend vs plain on a captured particle
   layer and on seeded inputs at its packed shapes with tied depths (exact,
   the particles being one constant colour); one frame rendered with the kernels and with the plain
   versions from a shared state and carry (identical);
12. the physics bench cells (`oxylus_tpu_torch/bench.py`): the banded kernel
   vs plain from the flagship's start state, 8 and 60 substeps in the bench's
   configuration (iterations 3, warm 0.7, geom_every 2) and 8 in the cold one
   (iterations 10), and 5 sleeping substeps on phase 4's pile with the sleep
   threshold in a gap of its speeds (flags and timers equal); then, with every
   launch count set to 0 just before, the `physics` cell through
   `bench_physics(kernel="banded")` (its gates, 50 banded launches, body-steps/s,
   the coverage at the kernel's BAND of 128 at start and end), one 60-substep
   call from its pile timed against the plain version and the bound from that
   pile's pairs (`megakernel_banded.pair_work`); `run_physics10k()` (the compact
   kernel at capacity 10112, its gates, 26 launches), compact vs plain on its
   end state for 4 substeps and one 60-substep call there timed against the
   plain version and its bound; the `dense` and `mega=False` routes, one call
   per window;
13. the config-5 frame through the group raster route: `build_frame5_scene`
   with `RenderSpec(raster_path="group", compact_raster=True)` (dense groups
   of 64 from `compact_triangles`, 64-px tiles, 64 groups a tile): 2 warm-up
   frames, then 60 frames with every launch count set to 0 just before; the
   group raster launched in every frame and the tile raster never; the compact
   kernel, HiZ and depth raster launched; the image finite in [0, 1],
   `expand_overflow` 0, no box centre below y = -1 m, and each frame's
   binning drop (group-tile pairs past 64 a tile, printed per frame) at most
   5 % of its pairs. Then the group raster vs plain, exactly equal (depth
   bits, vid, G-buffer bits), on one frame's captured passes (timed with CUDA
   events against their plain versions and the bound from the work the
   walked groups' slots need: the image pixels of each slot's span, the
   smallest rectangle holding its covered pixels in the tile) and on seeded,
   varied inputs (`seeded_group_inputs`, from `seeded_groups`): tile 32
   and 64, `ml_near` given and not, `tile_base` ≠ 0, R = 32, 64 and 128, empty
   tiles and full lists, depths tied across groups and slots, walks ended
   early; and one frame rendered with the kernels and with the plain versions
   from a shared state and carry (identical);
14. the Hopper probes (`oxylus_tpu_torch/probes`, kernel table row 9): every
   launch count set to 0, then `probes.run_all` (what `python -m
   oxylus_tpu_torch.probes` runs: the four TPU probe scripts' cases, each
   checked and timed) with every probe kernel launched; then each kernel held
   against its plain version on the scripts' and seeded inputs (exact; the
   bf16 and float32 products within their sum-order bounds), timed as a CUDA
   graph of 200 calls beside its plain version, its bound and, where one
   PyTorch call computes the same function, that call's time.

Any failed check raises, so the script exits non-zero; it also exits non-zero,
without printing a result, when no card is visible or the package is absent.
The last two lines are a JSON object describing the kernels (launch counts,
errors, times, bounds) and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import math
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
FLOOR_MID_Y = -1.0   # m: the floor slab's centre plane
BIN_DROP_GATE = 0.05  # share of a frame's binned pairs the binning capacity may drop
WIDTH, HEIGHT = 1920, 1080
MAIN_WARMUP, MAIN_FRAMES, CMP_FRAMES = 2, 60, 4
FIELDS = ("pos", "linvel", "angvel", "quat")
# the card's published peaks (H100 SXM data sheet): HBM bytes/s, float32 outside the tensor cores,
# dense bf16 on the tensor cores
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# Operations the raster's function needs, counted on this run's data. Per
# real entry (one a tile holds, in a round the tile ran) and tile pixel: 5
# planes × (4 mul + 5 add) of the hi/lo evaluation, then the cover test
# (wd - zn, wd - 1e-30, 5 mins, 1 compare)
RASTER_OPS_ENTRY_PIXEL = 53
RASTER_OPS_COVERED = 6  # per covered (entry, pixel): max, reciprocal, multiply, the key's and + or, max
RASTER_OPS_HIT = 45  # per hit pixel: 9 lanes × (2 mul + 2 add), the reciprocal, 8 multiplies
# Group raster: per walked (tile, group) and live slot, the test of the slot's
# screen bounds against the tile (4 compares); the planes and the cover test
# (RASTER_OPS_ENTRY_PIXEL) then only at the image pixels of its span
GROUP_OPS_SLOT_TILE = 4
# per overlapping body pair at a rebuild: the box-box SAT over 6 face axes, each
# two 23-operation extents, a 6-operation centre projection, 2 adds and a compare
# (the solver's per-pair sweeps are not counted)
COMPACT_OPS_PAIR = 330
# Dense kernel: the work its function needs in one substep, on this run's
# data. Positions do not move within a substep, so the AABB test (3 ×
# subtract, abs, add, compare, then the dynamic and active tests) is needed
# once per unordered pair and the contact geometry once per overlapping
# ordered pair, by its kind: round/round 71, box/round 78, round/box 81,
# box/box 599 (the face SAT 330, sign and normal 10, the incident face 32, the
# reference box's extent 23, 4 clamped corners of 51). Per touching point, 44
# operations once (lever arms, effective mass, bias) and 93 in every sweep
# (relative velocity, normal and friction λ, impulse, both torques, the four
# sums). Per-body work (gravity, pose, the sweeps' updates) is left out, so
# the bound stays a lower bound.
DENSE_OPS_TEST = 16
DENSE_OPS_PAIR = {"round_round": 71, "box_round": 78, "round_box": 81, "box_box": 599}
DENSE_OPS_POINT, DENSE_OPS_POINT_SWEEP = 44, 93
# Depth raster: per live (tile, entry) pair, per real triangle of its meshlet
# and tile pixel, five planes × (4 mul + 5 add) of the hi/lo evaluation, the
# 6 compares of the cover test and the first-max compare; per pair and pixel
# the fold into the tile (compare, select)
DEPTH_OPS_TRI_PIXEL, DEPTH_OPS_PAIR_PIXEL = 52, 2
FULL_TIER, SMALL_TIER = 2048, 768  # the shadow levels' capacities (`render_shadow_clipmaps_cached`)
# Sprite blend: float operations per live (tile, entry) pair and tile pixel:
# the local coordinates (2 sub, 2 × (2 mul, sub, mul)), the inside test (4
# compares), u and v (5), the two clips and scales (6), four tent weights (4
# × (sub, abs, sub, max)), four tap weights (4 mul), the four taps over four
# channels (16 mul, 12 add), the alpha (mul, cutoff compare), the blend
# (1 - a, 3 × (2 mul, add), 2 for alpha) and the id compare; the depth
# variant adds one compare
BLEND_OPS_ENTRY_PIXEL = 88
BLEND_OUT_BYTES_PIXEL = 20  # RGBA f32 + the i32 id
# The blend's premultiplied colour lies in [0, 1] up to float32 rounding: the
# four bilinear tap weights of the TPU kernel's formula sum to 1 only to a few
# ulps, so a white texel blends to 1.0000002 (the JAX device branch gives the
# same on config 2)
BLEND_RANGE_ROUNDING = 1e-6
ENTRY_BOXES, ENTRY_CAPACITY, ENTRY_MAX_PAIRS = 255, 512, 2048
EVENT_FRAMES = 4


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
def plain_on_card(*modules):
    """Route the given kernels' dispatch to their plain PyTorch versions for
    card tensors, for the reference side of a comparison (the wrappers' own
    torch code still runs). Outside this block card tensors reach the kernels."""
    saved = []
    for mod in modules:
        name, plain = PLAIN_ROUTES[mod.__name__]
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, getattr(mod, plain))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


PLAIN_ROUTES = {
    "oxylus_tpu_torch.physics.megakernel_compact": ("run_compact", "compact_substeps_reference"),
    "oxylus_tpu_torch.ops.raster3d": ("run_tiles", "rasterize_tiles_reference"),
    "oxylus_tpu_torch.ops.hiz": ("build_hiz", "hiz_reference"),
    "oxylus_tpu_torch.physics.megakernel": ("run_dense", "dense_substeps_reference"),
    "oxylus_tpu_torch.ops.raster_depth": ("rasterize_depth", "rasterize_depth_reference"),
    "oxylus_tpu_torch.ops.blend2d": ("run_blend", "blend_tiles_reference"),
    "oxylus_tpu_torch.physics.megakernel_banded": ("run_banded", "banded_substeps_reference"),
    "oxylus_tpu_torch.ops.raster_groups": ("run_groups", "rasterize_groups_reference"),
}


@contextlib.contextmanager
def capture(mod, name: str, into: list, keep=lambda args: args, result: bool = False):
    """Record `keep(args)` of every call of `mod.name` while the block runs,
    or with `result` `keep` of what the call returns."""
    fn = getattr(mod, name)

    def wrapped(*args, **kw):
        if not result:
            into.append(keep(args))
        out = fn(*args, **kw)
        if result:
            into.append(keep(out))
        return out

    setattr(mod, name, wrapped)
    try:
        yield
    finally:
        setattr(mod, name, fn)


def bound(n_bytes: int, n_ops: int, peak_ops: float = PEAK_F32) -> tuple[float, str]:
    """The least time the card could take (ms): the larger of bytes over the
    memory rate and operations over their peak rate (float32 on the SMs unless
    given), and which one it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def psnr(a, b) -> float:
    mse = (a.double() - b.double()).pow(2).mean().item()
    return float("inf") if mse == 0 else 10.0 * torch.log10(torch.tensor(1.0 / mse)).item()


def state_err(got, want) -> dict:
    return {k: (getattr(got, k) - getattr(want, k)).abs().max().item() for k in FIELDS}


def seeded_groups(seed, width, height, n_groups, n_slots, size, crowd):
    """Synthetic dense triangle groups at width×height, made from a seed with
    NumPy: `n_groups` groups of `n_slots` slots of screen-space triangles
    (w = 1), near to far by group, `size` = (lo, hi) px across, centred in
    the left four fifths of the image; with `crowd` > 0, groups [0, crowd)
    gather near the top left and [crowd, 2·crowd) under the slab below, so
    the tiles there list many groups. Then the ties the early-out and the
    keys must get right: group 1's first two slots are a slab over the lower
    left (x < 0.55·width, y > 0.45·height, past the image edge too, so the
    tiles' padding pixels lie under it), at a depth of 31/32 on constant
    depth planes (so it resolves to exactly that key), in front of the
    groups behind it, so the tiles it covers end their walks early; group
    2's first slot lies under the slab's second triangle at the same depth,
    so that group's near bound equals the resolved depth there and the
    early-out's strict compare decides whether it takes those pixels; every
    5th group repeats its predecessor's triangles in the same slots (depths
    tied across groups), every 7th slot the one before it (tied within a
    group), a third of the triangles have one depth quantised to 1/64 (keys
    tied on depth), and each group's last 3 slots are empty. Returns NumPy
    arrays: coeffs (G, R, 5, 3), attr_planes (G, R, 9, 3) (the ss plane
    first), consts (G, R, 8), valid (G, R), ml_near (G,) (each group's
    largest vertex depth) and the groups' screen bounds
    {ml_xmin, ml_xmax, ml_ymin, ml_ymax}."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f32 = np.float32
    n = n_groups * n_slots
    gi, si = np.arange(n) // n_slots, np.arange(n) % n_slots
    cx, cy = 0.8 * width * rng.random(n_groups), height * rng.random(n_groups)
    for c0, x0, y0 in ((0, 0.04, 0.07), (crowd, 0.18, 0.5)):
        cx[c0 : c0 + crowd] = width * (x0 + 0.04 * rng.random(crowd))
        cy[c0 : c0 + crowd] = height * (y0 + 0.07 * rng.random(crowd))
    d = size[0] + (size[1] - size[0]) * rng.random(n)
    vx = (cx[gi][:, None] + d[:, None] * (rng.random((n, 3)) - 0.5)).astype(f32)
    vy = (cy[gi][:, None] + d[:, None] * (rng.random((n, 3)) - 0.5)).astype(f32)
    zg = 0.95 - 0.9 * gi / n_groups  # near to far by group
    vz = np.clip(zg[:, None] + 0.05 * (rng.random((n, 3)) - 0.5), 0.01, 0.99).astype(f32)
    flat = rng.random(n) < 1 / 3
    vz[flat] = (np.round(vz[flat].mean(1) * 64) / 64)[:, None]
    slab, tie = (gi == 1) & (si < 2), (gi == 2) & (si == 0)
    x1, y0, y1 = 0.55 * width, 0.45 * height, height + 64.0
    vx[slab] = [[-8.0, x1, -8.0], [x1, x1, -8.0]]
    vy[slab] = [[y0, y0, y1], [y0, y1, y1]]
    vx[tie] = [0.53 * width, 0.53 * width, 0.33 * width]  # inside the slab's second triangle
    vy[tie] = [0.55 * height, 0.97 * height, 0.97 * height]
    vz[slab | tie] = 31 / 32
    for dup, back in ((gi % 5 == 4, n_slots), (si % 7 == 6, 1)):
        src = np.nonzero(dup)[0] - back
        for v in (vx, vy, vz):
            v[dup] = v[src]
    valid = si < n_slots - 3
    # barycentric planes λ_i = a_i·x + b_i·y + c_i, positive inside either winding
    j, k = [1, 2, 0], [2, 0, 1]
    dd = (vx[:, 1] - vx[:, 0]) * (vy[:, 2] - vy[:, 0]) - (vx[:, 2] - vx[:, 0]) * (vy[:, 1] - vy[:, 0])
    dd = np.where(np.abs(dd) < 1e-3, f32(1e-3), dd)[:, None]
    planes = np.stack([(vy[:, j] - vy[:, k]) / dd, (vx[:, k] - vx[:, j]) / dd,
                       (vx[:, j] * vy[:, k] - vx[:, k] * vy[:, j]) / dd], -1)  # (n, 3, 3)
    coeffs = np.concatenate([planes, (vz[:, :, None] * planes).sum(1, keepdims=True),
                             planes.sum(1, keepdims=True)], 1).astype(f32)
    coeffs[slab | tie, 3], coeffs[slab | tie, 4] = [0, 0, 31 / 32], [0, 0, 1]  # the depth is exactly 31/32
    attr_planes = np.concatenate([coeffs[:, 4:5], rng.uniform(-1e-2, 1e-2, (n, 8, 3))], 1).astype(f32)
    attr_planes[:, 1:, 2] = rng.uniform(-1, 1, (n, 8))
    coeffs[~valid], attr_planes[~valid] = 0.0, 0.0
    coeffs[~valid, 0, 2] = -1e30
    consts = rng.random((n, 8)).astype(f32)
    consts[~valid] = 0.0
    per_group = lambda v, fill, red: red(np.where(valid, v, fill).reshape(n_groups, n_slots), 1).astype(f32)
    bounds = {"ml_xmin": per_group(np.maximum(vx.min(1), 0), 1e9, np.min),
              "ml_xmax": per_group(vx.max(1), -1e9, np.max),
              "ml_ymin": per_group(np.maximum(vy.min(1), 0), 1e9, np.min),
              "ml_ymax": per_group(vy.max(1), -1e9, np.max)}
    shape = lambda a: a.reshape(n_groups, n_slots, *a.shape[1:])
    return (shape(coeffs), shape(attr_planes), shape(consts), shape(valid), per_group(vz.max(1), -1.0, np.max),
            bounds)


def group_rows(coeffs, attr_planes, consts, valid, device):
    """The group raster's slot rows (`raster3d.build_tile_comb`) of
    `seeded_groups`' arrays, on `device`."""
    from oxylus_tpu_torch.ops import raster3d

    t = lambda a: torch.from_numpy(a).to(device)
    zeros = torch.zeros(valid.shape, dtype=torch.int32, device=device)
    dense = {"coeffs": t(coeffs), "attr_planes": t(attr_planes), "tri_valid": t(valid),
             "tri_z": zeros.float(), "slot_material": zeros, "slot_instance": zeros, "packed_id": zeros}
    return raster3d.build_tile_comb(dense, t(consts))


def seeded_group_inputs(seed, tile, n_slots, with_near, band, dev):
    """Group raster inputs at the main path's size (1920×1080, or the tile
    rows `band` = (first, end) of it: tile_base ≠ 0): `seeded_groups` with
    256 groups of 8–128 px triangles, two crowds of 100 (full lists, one
    under the slab), binned per tile in group order by
    `bin_meshlets_to_tiles` (64 a tile); ml_near, when given, suffix-maxed
    in group order."""
    from oxylus_tpu_torch.ops import raster_groups, setup3d

    coeffs, attr_planes, consts, valid, ml_near, bounds = seeded_groups(seed, WIDTH, HEIGHT, 256, n_slots,
                                                                        (8, 128), 100)
    rows = group_rows(coeffs, attr_planes, consts, valid, dev)
    tl, _ = setup3d.bin_meshlets_to_tiles({k: torch.from_numpy(v).to(dev) for k, v in bounds.items()}, WIDTH,
                                          HEIGHT, tile, 64)
    h, base = HEIGHT, 0
    if band is not None:
        tx = (WIDTH + tile - 1) // tile
        base, h = band[0] * tx, (band[1] - band[0]) * tile
        tl = tl[band[0] * tx : band[1] * tx].contiguous()
    near_eo = torch.flip(torch.cummax(torch.flip(torch.from_numpy(ml_near), [0]), 0).values, [0]).to(dev)
    near = raster_groups.near_table(tl, near_eo if with_near else None)
    cnt = (tl >= 0).sum(1)
    check(int(cnt.max()) == 64 and bool((cnt == 0).any()), f"seeded group inputs {seed}: no full or empty list")
    return rows, tl, near, WIDTH, h, n_slots, tile, base


PROBE_REPS = 200  # timed launches per probe kernel (after one warm-up)


def probe_phase(dev, card: str, other_mods) -> list[dict]:
    """Phase 14: the Hopper probes (kernel table row 9). Drives
    `probes.run_all` (what `python -m oxylus_tpu_torch.probes` runs) with every
    launch count set to 0 just before, then holds each probe kernel against its
    plain version on the scripts' and seeded inputs, times both with CUDA
    events, and returns the `kernels` rows."""
    from oxylus_tpu_torch import probes
    from oxylus_tpu_torch.probes import dot_rhs_t, dynslice, mosaic_ops
    from oxylus_tpu_torch.probes import roll as proll

    probe_mods = probes.modules()
    for mod in tuple(other_mods) + tuple(probe_mods):
        mod.LAUNCHES = 0
    mosaic_ops.KERNEL_LAUNCHES.clear()
    proll.KERNEL_LAUNCHES.clear()
    t0 = time.perf_counter()
    lines = probes.run_all(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in lines:
        print(f"[14] {probes.format_line(r)}", flush=True)
    counts = {mod.__name__: mod.LAUNCHES for mod in probe_mods}
    mosaic_counts, roll_counts = dict(mosaic_ops.KERNEL_LAUNCHES), dict(proll.KERNEL_LAUNCHES)
    kernel_counts = {**{f"mosaic_ops.{k}": v for k, v in mosaic_counts.items()},
                     **{f"roll.{k}": v for k, v in roll_counts.items()}}
    print(f"[14] probes.run_all: {len(lines)} probes in {wall:.2f} s ({card}); launches {counts}; by kernel "
          f"{kernel_counts}", flush=True)
    check(len(lines) == 26, f"run_all gave {len(lines)} probe lines, not 26")
    for name, n in counts.items():
        check(n > 0, f"the probe run never launched a kernel of {name}")
    for kernel in mosaic_ops.OPS:
        check(mosaic_counts.get(kernel, 0) > 0, f"the probe run never launched mosaic_ops' {kernel} kernel")
    roll_kernels = ("roll_chain", "roll_chain_smem", "vector_chain", "matmul_f32", "matmul_bf16", "argmax_extract",
                    "dynamic_trip")
    for kernel in roll_kernels:
        check(roll_counts.get(kernel, 0) > 0, f"the probe run never launched roll's {kernel} kernel")
    for mod in other_mods:
        check(mod.LAUNCHES == 0, f"the probe run launched {mod.__name__}")

    def diff(got, want) -> float:
        """Max |got - want| over elements; NaN must meet NaN and inf the same inf."""
        got, want = got.float(), want.float()
        nan_ok = bool((torch.isnan(got) == torch.isnan(want)).all())
        inf_ok = bool(((got == want) | ~torch.isinf(want)).all())
        check(nan_ok and inf_ok, "NaN or inf positions differ")
        fin = torch.isfinite(want)
        return (got[fin] - want[fin]).abs().max().item() if bool(fin.any()) else 0.0

    def exact(label, got, want) -> float:
        err = diff(got, want)
        print(f"[14] {label}: max abs err {err}", flush=True)
        check(err == 0.0, f"{label}: kernel != plain")
        return err

    def within(label, got, want, tol) -> float:
        err = diff(got, want)
        worst = ((got.double() - want.double()).abs() / tol).max().item()
        print(f"[14] {label}: max abs err {err:.3g}, {worst:.3g} of its sum-order bound", flush=True)
        check(worst <= 1.0, f"{label}: kernel differs from plain past the sum-order bound")
        return err

    def timed(label, kernel_fn, plain_fn, n_bytes, n_ops, peak=PEAK_F32, library_fn=None, plain_reps=5):
        """Kernel and library call: device time per call from a CUDA graph of
        PROBE_REPS calls (`probes.time_us`; a single small launch called from
        Python waits on the host, whose time per call is printed beside it);
        the plain version (many small launches) from the host, by CUDA events."""
        us, host_us = probes.time_us(kernel_fn, dev, PROBE_REPS)
        plain = cuda_ms(plain_fn, plain_reps)
        lib = probes.time_us(library_fn, dev, PROBE_REPS)[0] * 1e-3 if library_fn is not None else None
        bd = bound(n_bytes, n_ops, peak)
        print(f"[14] {label}: kernel {us * 1e-3:.6f} ms a call in a CUDA graph ({host_us * 1e-3:.6f} ms called one "
              f"by one from the host), plain {plain:.4f} ms, library {'none' if lib is None else f'{lib:.6f} ms'}, "
              f"bound {bd[0]:.6f} ms ({bd[1]}: {n_bytes} bytes, {n_ops} operations at {peak / 1e12:g} T/s) ({card})",
              flush=True)
        return us * 1e-3, plain, bd, lib

    rows = []

    def row(name, source, replaces, launches, err, t):
        ms, plain, bd, lib = t
        rows.append({"name": name, "route": "cuda", "source": f"oxylus_tpu_torch/probes/csrc/{source}",
                     "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bd[0], "bound_by": bd[1], "library_ms": lib})

    # -- dynslice: exact on the script's inputs and on seeded offsets in [-40, 300)
    err = 0.0
    for label, (x, d) in (("script", dynslice.script_inputs(dev)), ("seed 3", dynslice.seeded_inputs(3, dev)),
                          ("seed 4", dynslice.seeded_inputs(4, dev))):
        err = max(err, exact(f"dynslice, {label}", dynslice.dynslice(x, d), dynslice.dynslice_reference(x, d)))
    x, d = dynslice.script_inputs(dev)
    t = timed("dynslice (2, 1024)", lambda: dynslice.dynslice(x, d), lambda: dynslice.dynslice_reference(x, d),
              x.numel() * 4 + d.numel() * 4 + x.numel() * 4, 0)
    row("probe_dynslice", "dynslice.cu", "scripts/probe_dynslice.py:28", counts[dynslice.__name__], err, t)

    # -- dot_rhs_t: within the sum-order bound on the script's sparse 0/1 m and on dense seeded m
    err = 0.0
    for label, (v, m) in (("script", dot_rhs_t.script_inputs(dev)), ("dense seed 7", dot_rhs_t.seeded_inputs(7, dev))):
        got = dot_rhs_t.dot_rhs_t(v, m)
        err = max(err, within(f"dot_rhs_t, {label}", got, dot_rhs_t.dot_rhs_t_reference(v, m),
                              dot_rhs_t.sum_order_bound(v, m)))
        script_err = dot_rhs_t.script_error(v, m, got)
        print(f"[14] dot_rhs_t, {label}: the script's check, out[0] + out[1] vs vcat·mᵀ, relative {script_err:.3g}")
        check(script_err < dot_rhs_t.SCRIPT_TOL, f"dot_rhs_t, {label}: script check {script_err}")
    v, m = dot_rhs_t.script_inputs(dev)
    vals = dot_rhs_t.split_rows(v)
    mt = m.t()
    n_ops = 2 * dot_rhs_t.N2 * m.shape[0] * dot_rhs_t.K
    t = timed("dot_rhs_t (12, 1024)·(384, 1024)ᵀ", lambda: dot_rhs_t.dot_rhs_t(v, m),
              lambda: dot_rhs_t.dot_rhs_t_reference(v, m), dot_rhs_t.K * 4 + m.numel() * 2 + 12 * m.shape[0] * 4,
              n_ops, PEAK_BF16, library_fn=lambda: torch.matmul(vals, mt))
    row("probe_dot_rhs_t", "dot_rhs_t.cu", "scripts/probe_dot_rhs_t.py:21", counts[dot_rhs_t.__name__], err, t)

    # -- mosaic ops: every script and seeded case exact
    errs = collections.defaultdict(float)
    for name, kernel, args in mosaic_ops.script_cases(dev) + mosaic_ops.seeded_cases(41, dev):
        errs[kernel] = max(errs[kernel], exact(f"mosaic_ops {name}", mosaic_ops.run_case(kernel, args),
                                               mosaic_ops.plain_case(kernel, args)))
    cases = {}
    for name, kernel, args in mosaic_ops.script_cases(dev):
        cases.setdefault(kernel, args)
    x = cases["scan"][0]
    n_el = x.numel()
    idx_l, idx_r = cases["take_lanes"][1].long(), cases["take_rows"][1].long()
    xb = cases["bf16_mul_add"][0]
    log_n = math.log2(x.shape[1])
    library = {
        "take_lanes": lambda: torch.take_along_dim(x, idx_l, 1),
        "take_rows": lambda: torch.take_along_dim(x, idx_r, 0),
        "scan": lambda: torch.cumsum(x, 1),
        "sort": lambda: torch.sort(x, 1),
        "argmax": lambda: torch.argmax(x, 1, keepdim=True),
        "roll_lanes": lambda: torch.roll(x, 5, 1),
        "bf16_mul_add": lambda: torch.addcmul(xb, xb, xb),  # one call; it rounds x + x·x once
    }
    sizes = {  # bytes moved, operations
        "take_lanes": (n_el * 12, 0), "take_rows": (n_el * 12, 0), "scan": (n_el * 8, n_el),
        "sort": (n_el * 8, int(n_el * log_n)), "argmax": (n_el * 4 + x.shape[0] * 4, n_el),
        "roll_lanes": (n_el * 8, 0), "bf16_mul_add": (n_el * 4, 2 * n_el),
    }
    lines_at = {"take_lanes": 37, "scan": 54, "sort": 70, "argmax": 78, "roll_lanes": 86, "take_rows": 95,
                "bf16_mul_add": 104}
    for kernel, args in cases.items():
        t = timed(f"mosaic_ops {kernel} (128, 384)", lambda: mosaic_ops.run_case(kernel, args),
                  lambda: mosaic_ops.plain_case(kernel, args), *sizes[kernel], library_fn=library[kernel])
        row(f"probe_{kernel}", "mosaic_ops.cu", f"scripts/probe_mosaic_ops.py:{lines_at[kernel]}",
            mosaic_counts.get(kernel, 0), errs[kernel], t)

    # -- roll: rotates, chains, extraction and trip exact; products exact on all ones, within the bound on seeded
    errs = collections.defaultdict(float)
    xs = proll.script_x(dev)
    xr = proll.seeded_x(51, (37, 128), dev)
    for label, xv in (("script", xs), ("seed 51, 37 rows", xr), ("seed 51 x3 rounded, ties", torch.round(xr * 3))):
        for via, key in (("shuffle", "roll_chain"), ("smem", "roll_chain_smem")):
            for shift in (5, -133, 517):
                errs[key] = max(errs[key], exact(
                    f"dynamic roll {shift} via {via}, {label}", proll.dynamic_roll(xv, proll.scalar(shift, dev), via),
                    proll.roll_chain_reference(xv, 1, shift, accumulate=False)))
            errs[key] = max(errs[key], exact(
                f"static roll x{proll.N_INNER} via {via}, {label}", proll.roll_chain(xv, proll.N_INNER, via=via),
                proll.roll_chain_reference(xv, proll.N_INNER, 1)))
            errs[key] = max(errs[key], exact(
                f"dynamic roll x{proll.N_INNER} via {via}, {label}",
                proll.dynamic_roll_chain(xv, proll.N_INNER, proll.scalar(proll.DYN_BASE, dev), via=via),
                proll.roll_chain_reference(xv, proll.N_INNER, proll.DYN_BASE, proll.DYN_STEP)))
        for n_iter in (1, 2, proll.N_INNER):
            errs["vector_chain"] = max(errs["vector_chain"], exact(
                f"vector chain x{n_iter}, {label}", proll.vector_chain(xv, n_iter),
                proll.vector_chain_reference(xv, n_iter)))
        errs["argmax_extract"] = max(errs["argmax_extract"], exact(
            f"argmax extract, {label}", proll.argmax_extract(xv), proll.argmax_extract_reference(xv, 16)))
        errs["dynamic_trip"] = max(errs["dynamic_trip"], exact(
            f"dynamic trip, {label}", proll.dynamic_trip(xv, proll.scalar(proll.DYN_TRIP, dev)),
            proll.dynamic_trip_reference(xv, proll.DYN_TRIP)))
    xb = proll.script_xb(dev)
    errs["vector_chain"] = max(errs["vector_chain"], exact(
        "vector chain x200 (128, 384)", proll.vector_chain(xb, proll.VPU_BIG_ITERS),
        proll.vector_chain_reference(xb, proll.VPU_BIG_ITERS)))
    for m_, k_, n_, dtype in proll.MATMULS + ((96, 80, 48, torch.float32), (48, 64, 80, torch.bfloat16)):
        kname = "matmul_f32" if dtype == torch.float32 else "matmul_bf16"
        if (m_, k_, n_, dtype) in proll.MATMULS:
            a, b = torch.ones(m_, k_, dtype=dtype, device=dev), torch.ones(k_, n_, dtype=dtype, device=dev)
            got = proll.matmul_acc(a, b, proll.REPS_M)
            check(bool((got == proll.REPS_M * k_).all()), f"{kname} {m_}x{k_}x{n_}: all-ones product != 500·k")
            errs[kname] = max(errs[kname], exact(f"{kname} {m_}x{k_}x{n_} all ones x{proll.REPS_M}", got,
                                                 proll.matmul_reference(a, b, proll.REPS_M)))
        a, b = proll.seeded_matrices(m_ + k_ + n_, m_, k_, n_, dtype, dev)
        errs[kname] = max(errs[kname], within(f"{kname} {m_}x{k_}x{n_} seeded x1", proll.matmul_acc(a, b, 1),
                                              proll.matmul_reference(a, b, 1), proll.product_bound(a, b, 1)))
    n_el = xs.numel()
    for via, key in (("shuffle", "roll_chain"), ("smem", "roll_chain_smem")):
        t = timed(f"{key} static x{proll.N_INNER} (8, 128)", lambda: proll.roll_chain(xs, proll.N_INNER, via=via),
                  lambda: proll.roll_chain_reference(xs, proll.N_INNER, 1), 2 * n_el * 4, proll.N_INNER * n_el,
                  plain_reps=2)
        print(f"[14] {key}: {t[0] * 1e6 / proll.N_INNER:.3f} ns per rotate-and-add of the (8, 128) block ({card})",
              flush=True)
        row(f"probe_{key}", "roll.cu", "scripts/probe_roll.py:56", roll_counts.get(key, 0), errs[key], t)
    t = timed(f"vector_chain x{proll.N_INNER} (8, 128)", lambda: proll.vector_chain(xs, proll.N_INNER),
              lambda: proll.vector_chain_reference(xs, proll.N_INNER), 2 * n_el * 4, 8 * proll.N_INNER * n_el,
              plain_reps=2)
    row("probe_vector_chain", "roll.cu", "scripts/probe_roll.py:76", roll_counts.get("vector_chain", 0),
        errs["vector_chain"], t)
    t_big = timed(f"vector_chain x{proll.VPU_BIG_ITERS} (128, 384)",
                  lambda: proll.vector_chain(xb, proll.VPU_BIG_ITERS),
                  lambda: proll.vector_chain_reference(xb, proll.VPU_BIG_ITERS), 2 * xb.numel() * 4,
                  8 * proll.VPU_BIG_ITERS * xb.numel(), plain_reps=2)
    print(f"[14] vector chain rates: (8, 128) x{proll.N_INNER} {8 * proll.N_INNER * n_el / t[0] / 1e9:.4f} TFLOP/s, "
          f"(128, 384) x{proll.VPU_BIG_ITERS} {8 * proll.VPU_BIG_ITERS * xb.numel() / t_big[0] / 1e9:.4f} TFLOP/s "
          f"of 67 ({card})", flush=True)
    m_, k_, n_ = 1024, 1024, 128
    for dtype, kname, line in ((torch.float32, "matmul_f32", 109), (torch.bfloat16, "matmul_bf16", 109)):
        a, b = torch.ones(m_, k_, dtype=dtype, device=dev), torch.ones(k_, n_, dtype=dtype, device=dev)
        flops = 2 * m_ * k_ * n_ * proll.REPS_M
        elt = 2 if dtype == torch.bfloat16 else 4
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        t = timed(f"{kname} {m_}x{k_}x{n_} x{proll.REPS_M}", lambda: proll.matmul_acc(a, b, proll.REPS_M),
                  lambda: proll.matmul_reference(a, b, proll.REPS_M), (m_ * k_ + k_ * n_) * elt + m_ * n_ * 4, flops,
                  peak, plain_reps=2)
        one = cuda_ms(lambda: torch.matmul(a, b), PROBE_REPS)
        print(f"[14] {kname}: {flops / t[0] / 1e9:.3f} TFLOP/s of {peak / 1e12:g}; torch.matmul of one product "
              f"{one:.5f} ms = {2 * m_ * k_ * n_ / one / 1e9:.3f} TFLOP/s, the yardstick, not used by the port ({card})",
              flush=True)
        row(f"probe_{kname}", "roll.cu", f"scripts/probe_roll.py:{line}", roll_counts.get(kname, 0), errs[kname], t)
    t = timed("argmax_extract 16 rounds (8, 128)", lambda: proll.argmax_extract(xs),
              lambda: proll.argmax_extract_reference(xs, 16), 2 * n_el * 4, 16 * n_el)
    row("probe_argmax_extract", "roll.cu", "scripts/probe_roll.py:120", roll_counts.get("argmax_extract", 0),
        errs["argmax_extract"], t)
    trip = proll.scalar(proll.DYN_TRIP, dev)
    t = timed(f"dynamic_trip {proll.DYN_TRIP} (8, 128)", lambda: proll.dynamic_trip(xs, trip),
              lambda: proll.dynamic_trip_reference(xs, proll.DYN_TRIP), 2 * n_el * 4 + 4, proll.DYN_TRIP * n_el)
    row("probe_dynamic_trip", "roll.cu", "scripts/probe_roll.py:139", roll_counts.get("dynamic_trip", 0),
        errs["dynamic_trip"], t)
    return rows


def main() -> int:
    # ---- 1. set-up ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test needs a card", file=sys.stderr)
        return 2
    from oxylus_tpu_torch import _build
    from oxylus_tpu_torch.assets.native import bake_path
    from oxylus_tpu_torch.flagship import build_flagship
    from oxylus_tpu_torch.frame2d import build_frame2d_scene
    from oxylus_tpu_torch.frame3d import build_frame3d_scene
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.ops import blend2d, raster2d, raster3d, raster_depth, raster_groups, setup3d
    from oxylus_tpu_torch.ops import hiz as hiz_ops
    from oxylus_tpu_torch.flagship import entry
    from oxylus_tpu_torch.physics import megakernel as mk
    from oxylus_tpu_torch import bench
    from oxylus_tpu_torch.physics import megakernel_banded as mb
    from oxylus_tpu_torch.physics import megakernel_compact as mc
    from oxylus_tpu_torch.physics import step as pstep
    from oxylus_tpu_torch.physics.megakernel_banded import band_coverage_report, count_hub_planes
    from oxylus_tpu_torch.physics.state import BODY_DYNAMIC, PhysicsParams
    from oxylus_tpu_torch.render import renderer3d
    from oxylus_tpu_torch.render.camera import camera_from_state
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

    # ---- 3. slice 2's main path: the fused 3D frame without sky, shadows, GTAO, SSR
    t0 = time.perf_counter()
    scene, runner_kw = build_frame5_scene(WIDTH, HEIGHT, device=dev)
    scene.renderer_config = dataclasses.replace(scene.renderer_config, vbgtao_enable=False, ssr_enable=False)
    runner_kw.update(atmosphere=None, enable_shadows=False)
    runner = SceneRunner(scene, **runner_kw)
    print(f"[3] config-5 scene and runner built in {time.perf_counter() - t0:.2f} s; meshes baked by the "
          f"{bake_path()} path; {int(runner.ps.active.sum())} bodies, capacity {runner.ps.num_slots}; "
          f"{runner.renderer3d.spec}", flush=True)
    runner.run(MAIN_WARMUP)
    kernel_mods = (mc, raster3d, hiz_ops)
    every_mod = kernel_mods + (mk, raster_depth, blend2d, mb, raster_groups)
    for mod in every_mod:
        mod.LAUNCHES = 0
    # per frame: its bin_overflow and where its raster calls' counts begin in `counts`
    counts, frames = [], []
    t0 = time.perf_counter()
    with capture(raster3d, "run_tiles", counts, keep=lambda args: args[2]):
        for _ in range(MAIN_FRAMES):
            n0 = len(counts)
            image = runner.step()
            frames.append((runner.carry["bin_overflow"], n0))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {mod.__name__: mod.LAUNCHES for mod in kernel_mods}
    ps = runner.ps
    dyn = ps.active & (ps.body_type == BODY_DYNAMIC)
    carry = runner.carry
    print(f"[3] 3D runner: {MAIN_FRAMES} frames at {WIDTH}x{HEIGHT} in {wall:.3f} s = {MAIN_FRAMES / wall:.2f} "
          f"frames/s ({card}); kernel launches {launches}; expand_overflow {int(carry['expand_overflow'])}; "
          f"image mean {image.mean().item():.5f}", flush=True)
    # On the JAX package's own settings (32 meshlet groups, K2 = 192 triangle
    # entries per tile) the config-5 pile crowds some tiles past the binning's
    # capacity, which drops their farthest meshlet-tile pairs (the group stage)
    # and tile-triangle pairs (the triangle stage). Gated per frame, the
    # frame's dropped pairs as a share of its pairs rastered plus dropped.
    ends = [n0 for _, n0 in frames[1:]] + [len(counts)]
    drops = []
    for (dropped, n0), n1 in zip(frames, ends):
        pairs = sum(int(c.sum()) for c in counts[n0:n1])
        drops.append((int(dropped) / max(pairs + int(dropped), 1), int(dropped), pairs))
    worst = max(drops)
    print(f"[3] binning drops over the {MAIN_FRAMES} frames: worst {100 * worst[0]:.3f} % ({worst[1]} of "
          f"{worst[1] + worst[2]} pairs), first frame {drops[0][1]}, last frame {drops[-1][1]}, "
          f"total {sum(d[1] for d in drops)}; frames that ran the late pass "
          f"{sum(n1 - n0 == 2 for (_, n0), n1 in zip(frames, ends))}", flush=True)
    check(worst[0] <= BIN_DROP_GATE, f"binning dropped {100 * worst[0]:.3f} % of a frame's pairs")
    for name, n in launches.items():
        check(n > 0, f"the main path never launched the {name} kernel")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3), f"image shape {tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()) and image.min().item() >= 0.0 and image.max().item() <= 1.0,
          "image not finite or outside [0, 1]")
    check(int(carry["expand_overflow"]) == 0, "the meshlet expansion dropped work")
    check(bool(torch.isfinite(ps.pos).all() and torch.isfinite(ps.linvel).all()), "runner state not finite")
    min_y = ps.pos[dyn, 1].min().item()
    print(f"[3] lowest box centre y = {min_y:.4f} m (floor slab: top 0 m, mid-plane -1 m)")
    check(min_y > FLOOR_MID_Y, "a box fell through the floor")

    # Compact kernel vs plain at the main path's shapes: the frame path's call
    # (one substep, default band and planes) ...
    spec = runner.scene.spec
    _, main_err = kernel_vs_plain("3: main-path call", ps, runner.physics_params, TOL_8, n_substeps=1)
    main_call = lambda: mc.megakernel_substeps_compact(ps, runner.physics_params, DT, n_substeps=1)
    compact_ms = cuda_ms(main_call, 20)
    with plain_on_card(mc):
        compact_plain_ms = cuda_ms(main_call, 3)
    print(f"[3] main-path compact call (1 substep, B={ps.num_slots}): kernel {compact_ms:.3f} ms, "
          f"plain {compact_plain_ms:.1f} ms ({card})", flush=True)
    # ... then whole runner frames. Each frame starts both sides from the same
    # state, the reference a copy of the runner whose compact calls go to the
    # plain version (frame_step and render build new tensors, never write into
    # the shared ones): a pile amplifies rounding-level differences from
    # substep to substep, so frames run on free would compare its sensitivity,
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
          f"each from a shared state: compact kernel vs plain max abs err {frame_err}", flush=True)
    for k, e in frame_err.items():
        check(e <= TOL_8, f"runner frames: {k} error {e}")
    compact_err = max(*main_err.values(), *frame_err.values())  # at the main path's shapes
    b = ps.num_slots
    main_pairs = band_coverage_report(ps)["pairs"]
    compact_bound = bound(
        (mc.N_SCALARS + (mc.N_ROWS + mc.N_OUT) * b) * 4,
        # the broadphase's 128 band candidates per body, 6 compares each, and the SAT of each overlapping pair
        b * 128 * 6 + main_pairs * COMPACT_OPS_PAIR,
    )
    print(f"[3] compact bound {compact_bound[0]:.3g} ms ({compact_bound[1]}; {main_pairs} overlapping pairs)")

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
    cell_pile = ps

    # ---- 5. raster and HiZ kernels vs plain at the main path's shapes ----------
    raster_calls, hiz_calls, bin_calls = [], [], []
    for _ in range(10):  # until a frame runs the late pass too
        for calls in (raster_calls, hiz_calls, bin_calls):
            calls.clear()
        with capture(raster3d, "run_tiles", raster_calls), capture(hiz_ops, "build_hiz", hiz_calls), \
                capture(renderer3d, "bin_triangles_per_tile", bin_calls):
            runner.step()
        if len(raster_calls) == 2:
            break
    raster_rows = []
    for args in raster_calls:
        entries, comb, counts, near_r, w, h = args
        label = f"5: raster K2={entries.shape[1]}"
        got = raster3d.run_tiles(*args)
        want_d, want_v, want_g, rounds_run, covered = raster3d._raster_tiles_plain(*args)
        torch.cuda.synchronize()
        d_err = (got[0] - want_d).abs().max().item()
        g_err = (got[2].float() - want_g.float()).abs().max().item()
        vid_diff = int((got[1] != want_v).sum())
        bits_diff = int((got[2].view(torch.int16) != want_g.view(torch.int16)).sum())
        hit = got[1] >= 0
        n_hit = int(hit.sum())
        v = got[1][hit].long()
        win_rows = torch.unique(entries[v >> 8, v & 255]).numel()
        ref_rows = torch.unique(entries[entries >= 0]).numel()
        ms = cuda_ms(lambda: raster3d.run_tiles(*args), 20)
        plain = cuda_ms(lambda: raster3d._raster_tiles_plain(*args), 2)
        rounds = int(rounds_run.sum())
        real = int(torch.minimum(counts, rounds_run * raster3d.TILE_ROUND).sum())  # entries of the rounds run
        n_cov = int(covered.sum())
        bd = bound(
            (entries.numel() + counts.numel() + near_r.numel() + ref_rows * 15 + win_rows * 64) * 4 + w * h * 40,
            real * 4096 * RASTER_OPS_ENTRY_PIXEL + n_cov * RASTER_OPS_COVERED + n_hit * RASTER_OPS_HIT,
        )
        print(f"[{label}] {entries.shape[0]} tiles, {int(counts.sum())} entries, {rounds} rounds run over {real} "
              f"entries, {n_cov} covered (entry, pixel) pairs, {n_hit} hit pixels: kernel vs plain depth err "
              f"{d_err}, gb err {g_err}, vid mismatches {vid_diff}, gb bit mismatches {bits_diff}; kernel {ms:.4f} "
              f"ms, plain {plain:.2f} ms, bound {bd[0]:.4f} ms ({bd[1]}) ({card})", flush=True)
        check(d_err == 0 and g_err == 0 and vid_diff == 0 and bits_diff == 0, f"{label}: kernel != plain")
        raster_rows.append((max(d_err, g_err), ms, plain, bd))
    check(len(raster_rows) >= 1, "no raster call captured")
    # What the widest triangle capacity the vid's 8-bit entry field allows
    # would drop: the early pass binned again at K2 = 256, and the part of the
    # drop that is the group stage's (meshlet-tile pairs past the
    # `bin_groups_per_tile` cap), which K2 cannot help.
    early_bin = bin_calls[0]
    drop_wide = int(setup3d.bin_triangles_per_tile(*early_bin[:5], 256)[2])
    drop_groups = int(setup3d.bin_meshlets_to_tiles(*early_bin[:5])[1])
    print(f"[5] early pass binning drops: {int(setup3d.bin_triangles_per_tile(*early_bin)[2])} at "
          f"K2={early_bin[5]}, {drop_wide} at K2=256, of which the group stage's {drop_groups} (at "
          f"{early_bin[4]} groups per tile)", flush=True)

    depth = hiz_calls[0][0]
    got = hiz_ops.build_hiz(depth)
    want = hiz_ops.hiz_reference(depth)
    torch.cuda.synchronize()
    check([tuple(m.shape) for m in got] == [tuple(m.shape) for m in want], "HiZ level shapes differ")
    hiz_err = max((g - r).abs().max().item() for g, r in zip(got, want))
    hiz_ms = cuda_ms(lambda: hiz_ops.build_hiz(depth), 50)
    hiz_plain_ms = cuda_ms(lambda: hiz_ops.hiz_reference(depth), 10)
    n_out = sum(m.numel() for m in got[1:])
    hiz_bound = bound((got[0].numel() + n_out) * 4, 3 * n_out)
    print(f"[5] HiZ of {tuple(depth.shape)} → {[tuple(m.shape) for m in got]}: kernel vs plain max abs err {hiz_err}; "
          f"kernel {hiz_ms:.4f} ms, plain {hiz_plain_ms:.3f} ms, bound {hiz_bound[0]:.4f} ms ({card})", flush=True)
    check(hiz_err == 0, "HiZ kernel != plain")

    cam = camera_from_state(runner.state, runner._resolve_camera_idx(), WIDTH / HEIGHT)
    render = lambda: runner.renderer3d.render(
        runner.state, runner.gscene, cam, runner.bindings.materials, runner.bindings.atlas, runner.config,
        prev=runner.carry, static_lights=runner._static_lights,
    )["final"]
    img_k = render()
    with plain_on_card(raster3d, hiz_ops):
        img_p = render()
    print(f"[5] one frame rendered with the kernels and with the plain versions from a shared state: PSNR "
          f"{psnr(img_k, img_p)} dB, identical {bool(torch.equal(img_k, img_p))}", flush=True)
    check(torch.equal(img_k, img_p), "kernel and plain frames differ")

    # ---- 6. dense kernel vs plain from the flagship's start state ------------------
    def dense_vs_plain(label, ps, n_substeps):
        got = mk.megakernel_substeps(ps, params, DT, n_substeps=n_substeps)
        with plain_on_card(mk):
            want = mk.megakernel_substeps(ps, params, DT, n_substeps=n_substeps)
        err = state_err(got, want)
        print(f"[{label}] dense kernel vs plain max abs err {err}", flush=True)
        check(all(bool(torch.isfinite(getattr(got, k)).all()) for k in FIELDS), f"{label}: kernel output not finite")
        for k, e in err.items():
            check(e <= TOL_8, f"{label}: {k} error {e}")
        return err

    dense_vs_plain("6: 8 free-fall substeps", ps0, 8)

    # ---- 7. the headless dense runner on the flagship -----------------------------
    flag = build_flagship(FLAGSHIP_BOXES, device=dev)
    runner = SceneRunner(flag, render_mode="none", use_megakernel=True)
    runner.run(MAIN_WARMUP)
    all_mods = every_mod
    for mod in all_mods:
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    runner.run(MAIN_FRAMES)  # ends in a sync
    wall = time.perf_counter() - t0
    launches.update({mod.__name__: mod.LAUNCHES for mod in (mk,)})
    path_launches = {mod.__name__: mod.LAUNCHES for mod in all_mods}
    ps = runner.ps
    dyn = ps.active & (ps.body_type == BODY_DYNAMIC)
    min_y = ps.pos[dyn, 1].min().item()
    print(f"[7] headless dense runner: {MAIN_FRAMES} frames of {int(dyn.sum())} boxes (capacity {ps.num_slots}) in "
          f"{wall:.3f} s = {MAIN_FRAMES / wall:.2f} frames/s ({card}); kernel launches {path_launches}; lowest box "
          f"centre y = {min_y:.4f} m (floor slab: top 0 m, mid-plane -1 m)", flush=True)
    check(path_launches[mk.__name__] > 0, "the headless dense runner never launched the dense kernel")
    check(bool(torch.isfinite(ps.pos).all() and torch.isfinite(ps.linvel).all()), "dense runner state not finite")
    check(min_y > FLOOR_MID_Y, "a box fell through the floor on the dense runner")
    frame_err = {k: 0.0 for k in FIELDS + ("world",)}
    for _ in range(CMP_FRAMES):
        ref = copy.copy(runner)
        runner.step()
        with plain_on_card(mk):
            ref.step()
        err = state_err(runner.ps, ref.ps)
        err["world"] = (runner.state.world - ref.state.world).abs().max().item()
        frame_err = {k: max(frame_err[k], e) for k, e in err.items()}
    print(f"[7] {CMP_FRAMES} dense runner frames, each from a shared state: kernel vs plain max abs err {frame_err}",
          flush=True)
    for k, e in frame_err.items():
        check(e <= TOL_8, f"dense runner frames: {k} error {e}")

    # phase 6's contact check, on the pile
    pile = runner.ps
    pile_err = dense_vs_plain("6: one substep from the phase-7 pile", pile, 1)
    dense_call = lambda: mk.megakernel_substeps(pile, params, DT, n_substeps=1)
    dense_ms = cuda_ms(dense_call, 20)
    with plain_on_card(mk):
        dense_plain_ms = cuda_ms(dense_call, 2)
    work = mk.pair_work(pile)
    n_points = work.pop("points")
    b = pile.num_slots
    iters = 10  # megakernel_substeps' default, which the runner uses
    dense_bound = bound(
        (mk.N_SCALARS + (mk.N_ROWS + mk.N_OUT) * b) * 4,
        b * (b - 1) // 2 * DENSE_OPS_TEST + sum(n * DENSE_OPS_PAIR[k] for k, n in work.items())
        + n_points * (DENSE_OPS_POINT + iters * DENSE_OPS_POINT_SWEEP),
    )
    print(f"[6] dense call (1 substep, B={b}, overlapping ordered pairs {work}, {n_points} touching points): "
          f"kernel {dense_ms:.4f} ms, plain {dense_plain_ms:.2f} ms, bound {dense_bound[0]:.6f} ms "
          f"({dense_bound[1]}) ({card})", flush=True)
    dense_err = max(*pile_err.values(), *frame_err.values())

    # ---- 8. the default runner on entry()'s scene ---------------------------------
    entry_params = PhysicsParams(max_pairs=ENTRY_MAX_PAIRS)
    escene = build_flagship(ENTRY_BOXES, spec_kw=dict(max_entities=512, max_bodies=ENTRY_CAPACITY), device=dev)
    runner = SceneRunner(escene, render_mode="none", use_megakernel=False, physics_params=entry_params)
    found = []  # pairs the broadphase found in every substep of the 60 frames (one reduction each)
    t0 = time.perf_counter()
    with capture(pstep, "broadphase_mask", found, keep=lambda mask: mask.sum(), result=True):
        runner.run(MAIN_FRAMES)
    wall = time.perf_counter() - t0
    found = torch.stack(found).cpu()
    dropped = (found - ENTRY_MAX_PAIRS).clamp(min=0)
    ps = runner.ps
    dyn = ps.active & (ps.body_type == BODY_DYNAMIC)
    min_y = ps.pos[dyn, 1].min().item()
    print(f"[8] default runner (physics_substep) on entry()'s scene: {MAIN_FRAMES} frames of {int(dyn.sum())} boxes "
          f"(capacity {ps.num_slots}) in {wall:.3f} s = {MAIN_FRAMES / wall:.2f} frames/s ({card}); broadphase "
          f"pairs over its {len(found)} substeps: most {int(found.max())}, last {int(found[-1])}; dropped "
          f"{int(dropped.sum())} in all, most {int(dropped.max())} in one substep (max_pairs {ENTRY_MAX_PAIRS}); "
          f"lowest box centre y = {min_y:.4f} m", flush=True)
    check(bool(torch.isfinite(ps.pos).all() and torch.isfinite(ps.linvel).all()), "default runner state not finite")
    check(min_y > FLOOR_MID_Y, "a box fell through the floor on the default runner")
    fn, (st, eps, eparams, edt) = entry(device=dev)
    for _ in range(2):
        st, eps = fn(st, eps, eparams, edt)
    check(bool(torch.isfinite(eps.pos).all()) and int(st.frame) == 2, "entry()'s frame step")
    counts = collections.Counter()

    class EventCounter:  # a script system that counts the event callbacks
        def __getattr__(self, name):
            if name.startswith("on_contact_") or name.startswith("on_body_"):
                return lambda *a: counts.update([name])
            return lambda *a: None

    escene.lua_systems["events"] = EventCounter()
    tracked = SceneRunner(escene, render_mode="none", physics_params=entry_params, track_contacts=True)
    tracked.state = runner.state
    tracked.replace_physics_state(runner.ps)
    tracked.run(EVENT_FRAMES)
    print(f"[8] {EVENT_FRAMES} frames with track_contacts=True: callbacks {dict(sorted(counts.items()))}", flush=True)
    check(counts["on_contact_added"] > 0 and counts["on_contact_persisted"] > 0, "no contact events on the pile")

    # ---- 9. the full config-5 frame ------------------------------------------------
    t0 = time.perf_counter()
    scene, runner_kw = build_frame5_scene(WIDTH, HEIGHT, device=dev)
    runner = SceneRunner(scene, **runner_kw)
    cfg = runner.config
    print(f"[9] full config-5 runner built in {time.perf_counter() - t0:.2f} s (sky LUTs included): atmosphere "
          f"{runner.atmosphere is not None}, shadows {runner.enable_shadows}, GTAO {cfg.vbgtao_enable}, SSR "
          f"{cfg.ssr_enable}", flush=True)
    check(runner.atmosphere is not None and runner.enable_shadows and cfg.vbgtao_enable and cfg.ssr_enable,
          "build_frame5_scene is not the full config 5")
    first_calls, small_calls = [], []
    with capture(raster_depth, "rasterize_depth", first_calls):
        runner.step()  # the first frame: no shadow cache, all six levels at the full tier
    runner.run(MAIN_WARMUP - 1)
    full_mods = (mc, raster3d, hiz_ops, raster_depth)
    for mod in every_mod:
        mod.LAUNCHES = 0
    counts, frames, depth_per_frame, tiers = [], [], [], collections.Counter()
    frame_calls: list = []
    t0 = time.perf_counter()
    with capture(raster3d, "run_tiles", counts, keep=lambda args: args[2]), \
            capture(raster_depth, "rasterize_depth", frame_calls):
        for _ in range(MAIN_FRAMES):
            n0, d0 = len(counts), raster_depth.LAUNCHES
            frame_calls.clear()
            image = runner.step()
            frames.append((runner.carry["bin_overflow"], n0))
            depth_per_frame.append(raster_depth.LAUNCHES - d0)
            tiers.update(args[0].shape[0] for args in frame_calls)
            if not small_calls:
                small_calls = [args for args in frame_calls if args[0].shape[0] == SMALL_TIER]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    full_launches = {mod.__name__: mod.LAUNCHES for mod in full_mods}
    launches[raster_depth.__name__] = raster_depth.LAUNCHES
    ps = runner.ps
    dyn = ps.active & (ps.body_type == BODY_DYNAMIC)
    carry = runner.carry
    ends = [n0 for _, n0 in frames[1:]] + [len(counts)]
    drops = []
    for (dropped, n0), n1 in zip(frames, ends):
        pairs = sum(int(c.sum()) for c in counts[n0:n1])
        drops.append((int(dropped) / max(pairs + int(dropped), 1), int(dropped), pairs))
    worst = max(drops)
    min_y = ps.pos[dyn, 1].min().item()
    print(f"[9] full config-5 runner: {MAIN_FRAMES} frames at {WIDTH}x{HEIGHT} in {wall:.3f} s = "
          f"{MAIN_FRAMES / wall:.2f} frames/s ({card}); kernel launches {full_launches}; depth raster launches per "
          f"frame {depth_per_frame}; depth raster calls by capacity ({FULL_TIER} full tier, {SMALL_TIER} small tier) "
          f"{dict(tiers)}; expand_overflow {int(carry['expand_overflow'])}; binning drops worst "
          f"{100 * worst[0]:.3f} % ({worst[1]} of {worst[1] + worst[2]} pairs); image mean "
          f"{image.mean().item():.5f}; lowest box centre y = {min_y:.4f} m", flush=True)
    for name, n in full_launches.items():
        check(n > 0, f"the full config-5 frame never launched the {name} kernel")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3), f"image shape {tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()) and image.min().item() >= 0.0 and image.max().item() <= 1.0,
          "full frame: image not finite or outside [0, 1]")
    check(int(carry["expand_overflow"]) == 0, "full frame: the meshlet expansion dropped work")
    check(worst[0] <= BIN_DROP_GATE, f"full frame: binning dropped {100 * worst[0]:.3f} % of a frame's pairs")
    check(bool(torch.isfinite(ps.pos).all() and torch.isfinite(ps.linvel).all()), "full frame: state not finite")
    check(min_y > FLOOR_MID_Y, "full frame: a box fell through the floor")
    check(len(first_calls) == 6 and all(a[0].shape[0] == FULL_TIER for a in first_calls),
          f"the first frame's depth raster calls: {[tuple(a[0].shape) for a in first_calls]}")
    check(len(small_calls) > 0, "no timed frame rendered a shadow level at the small tier")

    def depth_vs_plain(label, args):
        got = raster_depth.rasterize_depth(*args)
        want = raster_depth.rasterize_depth_reference(*args)
        torch.cuda.synchronize()
        d_bits = int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum())
        v_diff = int((got[1] != want[1]).sum())
        err = (got[0] - want[0]).abs().max().item()
        work = raster_depth.live_work(args[0], args[1])
        w, h = args[2], args[3]
        n_bytes = work["meshlet_tris"] * 5 * 3 * 4 + args[1].numel() * 4 + w * h * 8
        n_ops = work["pair_tris"] * 4096 * DEPTH_OPS_TRI_PIXEL + work["pairs"] * 4096 * DEPTH_OPS_PAIR_PIXEL
        bd = bound(n_bytes, n_ops)
        print(f"[{label}] coeff {tuple(args[0].shape)}, lists {tuple(args[1].shape)}, {work}: depth bit mismatches "
              f"{d_bits}, vid mismatches {v_diff}, hit pixels {int((got[1] >= 0).sum())}; bound {bd[0]:.5f} ms "
              f"({bd[1]})", flush=True)
        check(d_bits == 0 and v_diff == 0, f"{label}: depth raster kernel != plain")
        return err, n_bytes, n_ops

    # the first frame's six levels: timed one by one, summed, bounded on their total work
    depth_errs, depth_ms, depth_plain_ms, depth_bytes, depth_ops = [], 0.0, 0.0, 0, 0
    for i, args in enumerate(first_calls):
        err, n_bytes, n_ops = depth_vs_plain(f"9: depth raster, first frame, level {i}", args)
        ms = cuda_ms(lambda: raster_depth.rasterize_depth(*args), 20)
        plain = cuda_ms(lambda: raster_depth.rasterize_depth_reference(*args), 2)
        print(f"[9] level {i}: kernel {ms:.4f} ms, plain {plain:.2f} ms ({card})", flush=True)
        depth_errs.append(err)
        depth_ms, depth_plain_ms = depth_ms + ms, depth_plain_ms + plain
        depth_bytes, depth_ops = depth_bytes + n_bytes, depth_ops + n_ops
    for i, args in enumerate(small_calls):
        depth_errs.append(depth_vs_plain(f"9: depth raster, small tier, call {i}", args)[0])
    depth_err = max(depth_errs)
    depth_bound = bound(depth_bytes, depth_ops)
    print(f"[9] depth raster, the first frame's six levels: kernel {depth_ms:.4f} ms, plain {depth_plain_ms:.2f} ms, "
          f"bound {depth_bound[0]:.5f} ms ({depth_bound[1]}) ({card})", flush=True)

    # one frame with the kernels and with the plain versions, from a shared
    # state and a carry one frame old (the boxes moved: shadow pages re-render)
    prev = runner.carry
    runner.step()
    cam = camera_from_state(runner.state, runner._resolve_camera_idx(), WIDTH / HEIGHT)
    render = lambda: runner.renderer3d.render(
        runner.state, runner.gscene, cam, runner.bindings.materials, runner.bindings.atlas, runner.config,
        prev=prev, atmosphere=runner.atmosphere, enable_shadows=runner.enable_shadows,
        static_lights=runner._static_lights,
    )["final"]
    d0 = raster_depth.LAUNCHES
    img_k = render()
    rendered = raster_depth.LAUNCHES - d0
    with plain_on_card(raster3d, hiz_ops, raster_depth):
        img_p = render()
    print(f"[9] one full frame rendered with the kernels ({rendered} depth raster launches) and with the plain "
          f"versions from a shared state and carry: PSNR {psnr(img_k, img_p)} dB, identical "
          f"{bool(torch.equal(img_k, img_p))}", flush=True)
    check(rendered > 0, "the shared-carry frame rendered no shadow level")
    check(torch.equal(img_k, img_p), "full frame: kernel and plain frames differ")

    def binning_drops(prefix, w, h, k):
        """(dropped, binned) (tile, record) pairs of one frame's 2D binning:
        the overlaps of the sorted visible prefix per 32² tile, and those past
        the tile capacity `k`."""
        total = raster2d.tile_overlaps(prefix, w, h).sum(1)
        return int((total - k).clamp(min=0).sum()), int(total.sum())

    def blend_texels_needed(tl, cnt, fields, tex, w, h, sd) -> int:
        """Distinct texels the blend's function must read: per live (tile,
        entry) pair, the taps of nonzero weight at the pixels of the image
        inside the entry's quad (and, with scene depth, nearer than the
        scene), counted once per texel plane."""
        tx = (w + blend2d.TILE - 1) // blend2d.TILE
        lin = torch.arange(blend2d.PIX, device=dev)
        lx, ly = (lin % blend2d.TILE).float(), (lin // blend2d.TILE).float()
        t_idx, k_idx = torch.nonzero(torch.arange(tl.shape[1], device=dev)[None, :] < cnt[:, None], as_tuple=True)
        need = torch.zeros(tex.shape[0] * blend2d.TEX * blend2d.TEX, dtype=torch.bool, device=dev)
        for c0 in range(0, t_idx.numel(), 2048):
            t, k = t_idx[c0 : c0 + 2048], k_idx[c0 : c0 + 2048]
            f = fields[t, k]
            px = ((t % tx) * blend2d.TILE).float()[:, None] + lx + 0.5
            py = (torch.div(t, tx, rounding_mode="floor") * blend2d.TILE).float()[:, None] + ly + 0.5
            p00x, p00y, e0x, e0y, e1x, e1y, idet = (f[:, i : i + 1] for i in range(7))
            rx, ry = px - p00x, py - p00y
            lu = (rx * e1y - ry * e1x) * idet
            lv = (ry * e0x - rx * e0y) * idet
            use = (lu >= 0) & (lu <= 1) & (lv >= 0) & (lv <= 1) & (px < w) & (py < h)
            if sd is not None:
                use &= f[:, 10:11] > sd[py.long().clamp(max=h - 1), px.long().clamp(max=w - 1)]
            fu = torch.clamp(lu + f[:, 9:10] * (1 - 2 * lu), 0, 1) * (blend2d.TEX - 1)
            fv = torch.clamp(1 - lv, 0, 1) * (blend2d.TEX - 1)
            u0, v0 = fu.long().clamp(0, blend2d.TEX - 2), fv.long().clamp(0, blend2d.TEX - 2)
            plane = torch.clamp(tl[t, k].long(), 0, tex.shape[0] - 1)[:, None] * blend2d.TEX * blend2d.TEX
            for dv in (0, 1):
                for du in (0, 1):
                    weight = (1 - (fu - (u0 + du)).abs()).clamp(min=0) * (1 - (fv - (v0 + dv)).abs()).clamp(min=0)
                    need[(plane + (v0 + dv) * blend2d.TEX + u0 + du)[use & (weight > 0)]] = True
        return int(need.sum())

    def blend_vs_plain(label, args, timed=True):
        """The blend kernel and its plain version on packed inputs: colour bits
        and vid exactly equal. With `timed`, both timed and the bound from the
        inputs (the live entries' fields and list slots, the texels they need,
        the scene depth and the outputs; the live pairs' operations)."""
        tl, cnt, fields, tex, w, h, sd = args
        got = blend2d.run_blend(*args)
        want = blend2d.blend_tiles_reference(*args)
        torch.cuda.synchronize()
        c_bits = int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum())
        v_diff = int((got[1] != want[1]).sum())
        err = (got[0] - want[0]).abs().max().item()
        pairs = int(cnt.sum())
        msg = (f"[{label}] {w}x{h}, {tl.shape[0]} tiles, {pairs} live (tile, entry) pairs, worst tile "
               f"{int(cnt.max())} entries, {int((cnt == 0).sum())} empty tiles, depth test {sd is not None}: "
               f"colour bit mismatches {c_bits}, vid mismatches {v_diff}, max abs err {err}, alpha mean "
               f"{got[0][..., 3].mean().item():.5f}, pixels with an id {int((got[1] >= 0).sum())}")
        if not timed:
            print(msg, flush=True)
            check(c_bits == 0 and v_diff == 0, f"{label}: blend kernel != plain")
            return got, err
        texels = blend_texels_needed(*args)
        n_bytes = (pairs * (fields.shape[2] + 1) + cnt.numel() + texels * 4) * 4 \
            + w * h * (BLEND_OUT_BYTES_PIXEL + (4 if sd is not None else 0))
        bd = bound(n_bytes, pairs * blend2d.PIX * (BLEND_OPS_ENTRY_PIXEL + int(sd is not None)))
        ms = cuda_ms(lambda: blend2d.run_blend(*args), 50)
        plain = cuda_ms(lambda: blend2d.blend_tiles_reference(*args), 3)
        print(f"{msg}; {texels} texels needed; kernel {ms:.4f} ms, plain {plain:.2f} ms, bound {bd[0]:.5f} ms "
              f"({bd[1]}) ({card})", flush=True)
        check(c_bits == 0 and v_diff == 0, f"{label}: blend kernel != plain")
        return got, err, ms, plain, bd

    def seeded_blend_inputs(seed, w, h, k, n_sprites, with_depth):
        """Packed blend inputs at a main path's shapes (w×h, K = k), made from
        a seed: rotated sprites of assorted sizes, random texel planes from
        transparent to opaque, random tints, every 4th untextured, every 3rd
        alpha-masked at 0.45, every 2nd flipped; every 8th untextured of
        alpha 0.5, axis-aligned, 15 px, at a half-pixel corner, so that texel
        coordinates fall on integers and alphas on the id's 0.5 threshold; a
        cluster crowds the first tile past K and the right part of the image
        stays empty; with `with_depth` record and scene depths in eighths, so
        that some tie."""
        g = torch.Generator().manual_seed(seed)
        rnd = lambda *shape: torch.rand(shape, generator=g)
        n_crowd = k + 16
        cx = torch.cat([4 + 24 * rnd(n_crowd), 0.8 * w * rnd(n_sprites - n_crowd)])
        cy = torch.cat([4 + 24 * rnd(n_crowd), h * rnd(n_sprites - n_crowd)])
        sx, sy = 4 + w / 16 * rnd(n_sprites), 4 + w / 16 * rnd(n_sprites)
        th = (2 * rnd(n_sprites) - 1) * torch.pi
        i = torch.arange(n_sprites)
        axis = i % 8 == 7
        th[axis], sx[axis], sy[axis] = 0.0, 15.0, 15.0
        cx[axis], cy[axis] = cx[axis].round(), cy[axis].round()
        c, s = torch.cos(th), torch.sin(th)
        e0x, e0y, e1x, e1y = c * sx, s * sx, -s * sy, c * sy
        p00x, p00y = cx - 0.5 * (e0x + e1x), cy - 0.5 * (e0y + e1y)
        rec = torch.zeros((n_sprites, 16))
        rec[:, 0:7] = torch.stack([p00x, p00y, e0x, e0y, e1x, e1y, 1.0 / (e0x * e1y - e0y * e1x)], 1)
        rec[:, 7:11] = 0.3 + 0.7 * rnd(n_sprites, 4)
        rec[axis, 10] = 0.5
        rec[:, 11] = 0.45
        rec[:, 12] = (i % 3 == 0).float()
        rec[:, 13] = (i % 4 != 3).float()
        rec[:, 14] = i.float()
        rec[:, 15] = (i % 2 == 1).float()
        xs = torch.stack([p00x, p00x + e0x, p00x + e1x, p00x + e0x + e1x])
        ys = torch.stack([p00y, p00y + e0y, p00y + e1y, p00y + e0y + e1y])
        tex = rnd(n_sprites, blend2d.TEX, blend2d.TEX, 4)
        tex[..., 3] = torch.clamp(1.6 * rnd(n_sprites, blend2d.TEX, blend2d.TEX) - 0.3, 0, 1)
        tx, ty = (w + blend2d.TILE - 1) // blend2d.TILE, (h + blend2d.TILE - 1) // blend2d.TILE
        t = torch.arange(tx * ty)
        x0, y0 = ((t % tx) * blend2d.TILE).float()[:, None], ((t // tx) * blend2d.TILE).float()[:, None]
        hit = (xs.amax(0) >= x0) & (xs.amin(0) < x0 + blend2d.TILE) & (ys.amax(0) >= y0) \
            & (ys.amin(0) < y0 + blend2d.TILE)
        order = torch.where(hit, i, n_sprites).sort(1).values[:, :k]
        tl = torch.where(order < n_sprites, order, -1).to(torch.int32)
        rec_depth = torch.floor(8 * rnd(n_sprites)) / 8 if with_depth else None
        sd = (torch.floor(8 * rnd(h, w)) / 8).to(dev) if with_depth else None
        packed = blend2d.pack_blend_inputs(rec.to(dev), tex.to(dev), tl.to(dev),
                                           None if rec_depth is None else rec_depth.to(dev))
        tl_d, cnt, fields, _ = packed
        live = torch.arange(k, device=dev)[None, :] < cnt[:, None]
        flip, cut = fields[..., 9][live], fields[..., 7][live]
        check(int(cnt.max()) == k and bool((cnt == 0).any()) and bool((flip == 1).any())
              and bool((flip == 0).any()) and bool((cut >= 0).any()) and bool((cut < 0).any()),
              f"seeded blend inputs {w}x{h}: no full or empty tile, or no flipped or alpha-masked live entry")
        return (*packed, w, h, sd)

    # ---- 10. config 2: the 2D runner ------------------------------------------------
    t0 = time.perf_counter()
    scene, runner_kw = build_frame2d_scene(WIDTH, HEIGHT, device=dev)
    runner = SceneRunner(scene, **runner_kw)
    n_ent = scene.spec.padded_entities()
    print(f"[10] config-2 scene and 2D runner built in {time.perf_counter() - t0:.2f} s: "
          f"{int(scene._comp_mask['SpriteComponent'].sum())} sprites, {n_ent} entity slots, "
          f"{scene.spec.max_particles} particle slots", flush=True)
    runner.run(MAIN_WARMUP)
    for mod in every_mod:
        mod.LAUNCHES = 0
    per_frame, blend_args, on_screen, prefixes = [], [], [], []
    t0 = time.perf_counter()
    with capture(blend2d, "run_blend", blend_args), \
            capture(raster2d, "sprite_sort_order", on_screen, keep=lambda args: args[4].sum()), \
            capture(raster2d, "resample_texture_tiles", prefixes, keep=lambda args: args[0]):
        for _ in range(MAIN_FRAMES):
            blend_args.clear()
            on_screen.clear()
            prefixes.clear()
            b0 = blend2d.LAUNCHES
            image = runner.step()
            per_frame.append(blend2d.LAUNCHES - b0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    launches[blend2d.__name__] = blend2d.LAUNCHES
    n_particles = int(runner.state.particles.alive.sum())
    visible = min(int(on_screen[0]), blend2d.MAX_VISIBLE)
    dropped, binned = binning_drops(prefixes[0], WIDTH, HEIGHT, blend_args[0][0].shape[1])
    print(f"[10] 2D image range [{image.min().item()}, {image.max().item()}]", flush=True)
    print(f"[10] 2D runner (config 2): {MAIN_FRAMES} frames at {WIDTH}x{HEIGHT} in {wall:.3f} s = "
          f"{MAIN_FRAMES / wall:.2f} frames/s ({card}); kernel launches {path_launches}; blend launches per frame "
          f"{sorted(set(per_frame))}; last frame: {n_particles} live particles, {int(on_screen[0])} records on "
          f"screen, {visible} visible (MAX_VISIBLE {blend2d.MAX_VISIBLE}), worst tile "
          f"{int(blend_args[0][1].max())} entries, binning dropped {dropped} of {binned} (tile, record) pairs at "
          f"capacity {blend_args[0][0].shape[1]}; image mean "
          f"{image.mean().item():.5f}", flush=True)
    check(per_frame == [1] * MAIN_FRAMES, f"blend launches per frame {per_frame}")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 4), f"2D image shape {tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()) and image.min().item() >= 0.0
          and image.max().item() <= 1.0 + BLEND_RANGE_ROUNDING,
          f"2D image not finite or outside [0, 1] (+{BLEND_RANGE_ROUNDING} rounding): "
          f"[{image.min().item()}, {image.max().item()}]")
    check(n_particles > 0, "no live particle in the 2D frame")
    got, err10, blend_ms, blend_plain_ms, blend_bound = blend_vs_plain("10: blend, last frame", blend_args[0])
    vid = got[1]
    check(int(vid.min()) >= -1 and int(vid.max()) < n_ent and bool((vid >= 0).any()),
          f"2D vids in [{int(vid.min())}, {int(vid.max())}], not in [-1, {n_ent})")
    # config 2's planes are all one white, so also seeded, varied inputs at its packed shapes
    seeded = seeded_blend_inputs(10, WIDTH, HEIGHT, blend_args[0][0].shape[1], blend2d.MAX_VISIBLE, False)
    got, err = blend_vs_plain("10: blend, seeded sprites", seeded, timed=False)
    err10 = max(err10, err)
    check(bool((got[1] >= 0).any()), "seeded 2D blend: no pixel took an id")

    # ---- 11. config 3: the 3D frame with the particle composite ---------------------
    t0 = time.perf_counter()
    scene, runner_kw = build_frame3d_scene(WIDTH, HEIGHT, device=dev)
    runner = SceneRunner(scene, **runner_kw)
    print(f"[11] config-3 runner built in {time.perf_counter() - t0:.2f} s (sky LUTs included): particles "
          f"{runner._has_particles}, atmosphere {runner.atmosphere is not None}, shadows {runner.enable_shadows}, "
          f"GTAO {runner.config.vbgtao_enable}, SSR {runner.config.ssr_enable}", flush=True)
    check(runner._has_particles, "the config-3 runner leaves the particle composite out")
    # The scene is static, so its shadow pages render in the first frame and
    # stay in the page cache: the counts are read over the warm-up frames and
    # the timed ones, and the frame rate over the timed ones.
    for mod in every_mod:
        mod.LAUNCHES = 0
    per_frame, depth_per_frame, blend_args, prefixes = [], [], [], []
    with capture(blend2d, "run_blend", blend_args), \
            capture(raster2d, "resample_texture_tiles", prefixes, keep=lambda args: args[0]):
        for i in range(MAIN_WARMUP + MAIN_FRAMES):
            if i == MAIN_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            blend_args.clear()
            prefixes.clear()
            b0, d0 = blend2d.LAUNCHES, raster_depth.LAUNCHES
            image = runner.step()
            per_frame.append(blend2d.LAUNCHES - b0)
            depth_per_frame.append(raster_depth.LAUNCHES - d0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    launches[blend2d.__name__] += blend2d.LAUNCHES
    n_particles = int(runner.state.particles.alive.sum())
    tl, _, _, _, lw, lh, _ = blend_args[0]
    dropped, binned = binning_drops(prefixes[0], lw, lh, tl.shape[1])
    print(f"[11] 3D runner (config 3): {MAIN_FRAMES} frames at {WIDTH}x{HEIGHT} in {wall:.3f} s = "
          f"{MAIN_FRAMES / wall:.2f} frames/s ({card}); kernel launches over the {MAIN_WARMUP} warm-up and "
          f"{MAIN_FRAMES} timed frames {path_launches}; depth raster launches per frame {depth_per_frame}; blend "
          f"launches per frame {sorted(set(per_frame))}; last frame: {n_particles} live particles, particle layer "
          f"{lw}x{lh}, worst tile {int(blend_args[0][1].max())} entries, binning dropped {dropped} of {binned} "
          f"(tile, record) pairs at capacity {tl.shape[1]}; expand_overflow {int(runner.carry['expand_overflow'])}; "
          f"image mean {image.mean().item():.5f}", flush=True)
    check(per_frame == [1] * (MAIN_WARMUP + MAIN_FRAMES), f"blend launches per frame {per_frame}")
    check(blend_args[0][6] is not None, "the particle layer's blend is not the depth-tested variant")
    for mod in (raster3d, hiz_ops, raster_depth):
        check(path_launches[mod.__name__] > 0, f"the config-3 frame never launched the {mod.__name__} kernel")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3), f"image shape {tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()) and image.min().item() >= 0.0 and image.max().item() <= 1.0,
          "config-3 image not finite or outside [0, 1]")
    check(n_particles > 0, "no live particle in the config-3 frame")
    err11 = blend_vs_plain("11: depth-tested blend, last frame", blend_args[0])[1]
    # config 3's particles are one constant colour of alpha 0.35, so also seeded, varied inputs at its packed shapes
    seeded = seeded_blend_inputs(11, lw, lh, tl.shape[1], 256, True)
    got, err = blend_vs_plain("11: depth-tested blend, seeded sprites", seeded, timed=False)
    err11 = max(err11, err)
    check(bool((got[1] >= 0).any()), "seeded depth-tested blend: no pixel took an id")
    prev = runner.carry
    runner.step()
    cam = camera_from_state(runner.state, runner._resolve_camera_idx(), WIDTH / HEIGHT)
    render = lambda: runner.renderer3d.render(
        runner.state, runner.gscene, cam, runner.bindings.materials, runner.bindings.atlas, runner.config,
        prev=prev, atmosphere=runner.atmosphere, enable_shadows=runner.enable_shadows, particles=True,
        static_lights=runner._static_lights,
    )
    b0 = blend2d.LAUNCHES
    ctx_k = render()
    rendered = blend2d.LAUNCHES - b0
    with plain_on_card(raster3d, hiz_ops, raster_depth, blend2d):
        ctx_p = render()
    img_k, img_p = ctx_k["final"], ctx_p["final"]
    layer_eq = torch.equal(ctx_k["particle_layer"], ctx_p["particle_layer"])
    print(f"[11] one config-3 frame rendered with the kernels ({rendered} blend launch) and with the plain versions "
          f"from a shared state and carry: particle layers identical {layer_eq} (layer alpha mean "
          f"{ctx_k['particle_layer'][..., 3].mean().item():.5f}), images PSNR {psnr(img_k, img_p)} dB, identical "
          f"{bool(torch.equal(img_k, img_p))}", flush=True)
    check(rendered == 1 and layer_eq, "config 3: kernel and plain particle layers differ")
    check(torch.equal(img_k, img_p), "config 3: kernel and plain frames differ")

    # ---- 12. the physics bench cells: the banded kernel, physics10k, dense, substep
    def banded_vs_plain(label, ps, params, tol, **kw):
        """One wrapper call with the banded kernel and one routed to its plain
        version, on the same card state; checks every output, returns the kernel's."""
        got = mb.megakernel_substeps_banded(ps, params, DT, **kw)
        with plain_on_card(mb):
            want = mb.megakernel_substeps_banded(ps, params, DT, **kw)
        err = state_err(got, want)
        timer_err = (got.sleep_timer - want.sleep_timer).abs().max().item()
        flips = int((got.asleep != want.asleep).sum())
        print(f"[{label}] banded kernel vs plain max abs err {err} (bound {tol}), sleep-timer err {timer_err:.3g} s, "
              f"sleep-flag mismatches {flips}", flush=True)
        check(all(bool(torch.isfinite(getattr(got, k)).all()) for k in FIELDS), f"{label}: kernel output not finite")
        check(flips == 0, f"{label}: sleep flags differ on {flips} bodies")
        check(timer_err <= TOL_8, f"{label}: sleep timers differ by {timer_err}")
        for k, e in err.items():
            check(e <= (tol[k] if isinstance(tol, dict) else tol), f"{label}: {k} error {e}")
        return got, max(err.values())

    # 12a. the banded kernel vs plain: the bench's and the cold configuration
    # from the flagship's start state, and sleeping on the physics cell's pile
    bench_kw = dict(iterations=3, warm=0.7, geom_every=2)
    banded_err = 0.0
    for label, n_sub, kw, tol in (("12a: bench config, 8 substeps", 8, bench_kw, TOL_8),
                                  ("12a: bench config, 60 substeps", 60, bench_kw, TOL_60),
                                  ("12a: cold config, 8 substeps", 8, dict(iterations=10), TOL_8)):
        banded_err = max(banded_err, banded_vs_plain(label, ps0, params, tol, n_substeps=n_sub, **kw)[1])
    # Sleep threshold in the widest gap of the pile's speeds (|v|² + r²|ω|²,
    # r = 0.5 m) after one substep, between the 85th and 99th percentile: the
    # fastest boxes keep moving, boxes below it that no moving box touches fall
    # asleep after 3 substeps (0.05 s against a 0.04 s sleep time); 5 substeps.
    dyn = cell_pile.active & (cell_pile.body_type == BODY_DYNAMIC)
    probe = mb.megakernel_substeps_banded(cell_pile, params, DT, n_substeps=1, **bench_kw)
    speeds = (probe.linvel.pow(2).sum(1) + probe.angvel.pow(2).sum(1) * 0.25).sqrt()[dyn].sort().values
    lo, hi = int(0.85 * len(speeds)), int(0.99 * len(speeds))
    j = lo + int((speeds[lo + 1 : hi + 1] - speeds[lo:hi]).argmax())
    sleepy = PhysicsParams(sleep_velocity=float(speeds[j] + speeds[j + 1]) / 2, sleep_time=0.04)
    slept, err = banded_vs_plain("12a: sleeping, 5 substeps on the pile", cell_pile, sleepy, TOL_60, n_substeps=5,
                                 sleep=True, **bench_kw)
    banded_err = max(banded_err, err)
    n_asleep = int(slept.asleep[dyn].sum())
    print(f"[12a] sleeping call: {n_asleep} of {int(dyn.sum())} boxes asleep (sleep velocity "
          f"{sleepy.sleep_velocity:.4f} m/s, in the speed gap {speeds[j].item():.4f}-{speeds[j + 1].item():.4f})")
    check(0 < n_asleep < int(dyn.sum()), "the banded sleeping call put no box, or every box, to sleep")

    # 12b. the physics cell through the banded route, every launch count set to 0 just before
    for mod in every_mod:
        mod.LAUNCHES = 0
    cell = bench.bench_physics(kernel="banded", device=dev)
    banded_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    launches[mb.__name__] = mb.LAUNCHES
    pile = cell["state"]
    cov0, cov1 = band_coverage_report(ps0, band=mb.BAND), band_coverage_report(pile, band=mb.BAND)
    print(f"[12b] physics cell, banded route (1022 boxes, capacity 1024, 2 + 3 x 16 calls of 60 substeps): "
          f"{cell['rate'] / 1e6:.3f} M body-steps/s (median window) ({card}); kernel launches {banded_launches}; "
          f"the bench's coverage gates at band {cell['band']}: start {cell['coverage_start']}, end "
          f"{cell['coverage_end']}; what the kernel's BAND {mb.BAND} covers: start {cov0}, end {cov1}", flush=True)
    check(mb.LAUNCHES == 50, f"the banded route launched the banded kernel {mb.LAUNCHES} times, not 50")
    dyn = pile.active & (pile.body_type == BODY_DYNAMIC)
    min_y = pile.pos[dyn, 1].min().item()
    check(bool(torch.isfinite(pile.pos).all()) and min_y > FLOOR_MID_Y, f"banded cell: end state (lowest {min_y})")
    # one 60-substep call from the cell's own pile: kernel, plain, bound
    call60 = lambda: mb.megakernel_substeps_banded(pile, params, DT, n_substeps=60, **bench_kw)
    banded_ms = cuda_ms(call60, 10)
    with plain_on_card(mb):
        banded_plain_ms = cuda_ms(call60, 1)
    work = mb.pair_work(pile, geom_every=2)
    b = pile.num_slots
    n_rebuild, sweeps = 30, 60 * (bench_kw["iterations"] + 1)
    banded_bound = bound(
        (mc.N_SCALARS + (mc.N_ROWS + mb.N_OUT) * b) * 4,
        n_rebuild * (work["candidates"] * DENSE_OPS_TEST + sum(work[k] * n for k, n in DENSE_OPS_PAIR.items())
                     + work["points"] * DENSE_OPS_POINT) + work["points"] * sweeps * DENSE_OPS_POINT_SWEEP,
    )
    print(f"[12b] banded 60-substep call from the cell's pile (B={b}, {work}): kernel {banded_ms:.3f} ms, plain "
          f"{banded_plain_ms:.1f} ms, bound {banded_bound[0]:.6f} ms ({banded_bound[1]}) ({card})", flush=True)

    # 12c. physics10k: the compact kernel at capacity 10112, then compact vs
    # plain there on the cell's end state (the pile), and one call timed
    for mod in every_mod:
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    results10k = []
    with capture(bench, "bench_physics", results10k, result=True):
        cell10k = bench.run_physics10k(device=dev)
    r10k = results10k[0]
    pile10k = r10k["state"]
    print(f"[12c] physics10k: {json.dumps(cell10k)} in {time.perf_counter() - t0:.1f} s ({card}); compact launches "
          f"{mc.LAUNCHES}; dropped pairs {r10k['dropped']} of ~{r10k['pair_events']} pair events, per-launch max "
          f"{r10k['dropped_max']}; coverage at band {r10k['band']}: start {r10k['coverage_start']}, end "
          f"{r10k['coverage_end']}", flush=True)
    check(mc.LAUNCHES == 2 + 3 * 8, f"physics10k launched the compact kernel {mc.LAUNCHES} times")
    check(pile10k.num_slots == 10112 and r10k["n_bodies"] == 10001, f"physics10k capacity {pile10k.num_slots}")
    kw10k = dict(iterations=3, warm=0.7, geom_every=2, band=r10k["band"], n_planes=count_hub_planes(pile10k))
    kernel_vs_plain("12c: physics10k pile, 4 substeps", pile10k, params, TOL_60, n_substeps=4, **kw10k)
    call10k = lambda: mc.megakernel_substeps_compact(pile10k, params, DT, n_substeps=60, **kw10k)
    ms10k = cuda_ms(call10k, 5)
    with plain_on_card(mc):
        plain10k = cuda_ms(call10k, 1)
    pairs10k = r10k["coverage_end"]["pairs"]
    b = pile10k.num_slots
    bound10k = bound((mc.N_SCALARS + (mc.N_ROWS + mc.N_OUT) * b) * 4,
                     30 * (b * r10k["band"] * 6 + pairs10k * COMPACT_OPS_PAIR))
    print(f"[12c] compact 60-substep call from the physics10k pile (B={b}, band {r10k['band']}, {pairs10k} "
          f"overlapping pairs): kernel {ms10k:.3f} ms, plain {plain10k:.1f} ms, bound {bound10k[0]:.5f} ms "
          f"({bound10k[1]}) ({card})", flush=True)

    # 12d. the dense and the mega=False routes, one call per window
    for kern, mega in (("dense", True), ("compact", False)):
        r = bench.bench_physics(kernel=kern, mega=mega, calls=1, warmup=1, device=dev)
        print(f"[12d] physics cell, {'kernel=' + kern if mega else 'mega=False (physics_substep)'}: "
              f"{r['rate'] / 1e6:.4f} M body-steps/s ({card})", flush=True)
        check(bool(torch.isfinite(r["state"].pos).all()), f"{kern}/{mega}: end state not finite")

    # ---- 13. the config-5 frame through the group raster -----------------------------
    t0 = time.perf_counter()
    scene, runner_kw = build_frame5_scene(WIDTH, HEIGHT, device=dev)
    runner_kw["render_spec"] = dataclasses.replace(runner_kw["render_spec"], raster_path="group", compact_raster=True)
    runner = SceneRunner(scene, **runner_kw)
    gspec = runner.renderer3d.spec
    print(f"[13] config-5 runner on the group raster built in {time.perf_counter() - t0:.2f} s: raster_group "
          f"{gspec.raster_group}, tile {gspec.tile}, meshlets_per_tile {gspec.meshlets_per_tile}, compact_raster "
          f"{gspec.compact_raster}", flush=True)
    check(gspec.raster_group == 64 and gspec.tile == 64 and gspec.meshlets_per_tile == 64, f"group spec {gspec}")
    runner.run(MAIN_WARMUP)
    for mod in every_mod:
        mod.LAUNCHES = 0
    lists, frames, group_per_frame = [], [], []
    t0 = time.perf_counter()
    with capture(raster_groups, "run_groups", lists, keep=lambda args: args[1]):
        for _ in range(MAIN_FRAMES):
            n0, g0 = len(lists), raster_groups.LAUNCHES
            image = runner.step()
            frames.append((runner.carry["bin_overflow"], n0))
            group_per_frame.append(raster_groups.LAUNCHES - g0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    group_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    launches[raster_groups.__name__] = raster_groups.LAUNCHES
    ps = runner.ps
    dyn = ps.active & (ps.body_type == BODY_DYNAMIC)
    carry = runner.carry
    ends = [n0 for _, n0 in frames[1:]] + [len(lists)]
    # a frame's binning drop: meshlet-group-tile pairs past meshlets_per_tile, as a share of its pairs
    drops = []
    for (dropped, n0), n1 in zip(frames, ends):
        pairs = sum(int((tl >= 0).sum()) for tl in lists[n0:n1])
        drops.append((int(dropped) / max(pairs + int(dropped), 1), int(dropped), pairs))
    worst = max(drops)
    min_y = ps.pos[dyn, 1].min().item()
    print(f"[13] config-5 runner, group raster: {MAIN_FRAMES} frames at {WIDTH}x{HEIGHT} in {wall:.3f} s = "
          f"{MAIN_FRAMES / wall:.2f} frames/s ({card}); kernel launches {group_launches}; group raster launches per "
          f"frame {group_per_frame}; binning drops per frame {[d[1] for d in drops]}, worst {100 * worst[0]:.3f} % "
          f"({worst[1]} of {worst[1] + worst[2]} pairs); expand_overflow {int(carry['expand_overflow'])}; image mean "
          f"{image.mean().item():.5f}; lowest box centre y = {min_y:.4f} m", flush=True)
    check(all(n >= 1 for n in group_per_frame), f"group raster launches per frame {group_per_frame}")
    check(group_launches[raster3d.__name__] == 0, "the group route launched the tile raster")
    for mod in (mc, hiz_ops, raster_depth):
        check(group_launches[mod.__name__] > 0, f"the group-route frame never launched the {mod.__name__} kernel")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3), f"image shape {tuple(image.shape)}")
    check(bool(torch.isfinite(image).all()) and image.min().item() >= 0.0 and image.max().item() <= 1.0,
          "group route: image not finite or outside [0, 1]")
    check(int(carry["expand_overflow"]) == 0, "group route: the meshlet expansion dropped work")
    check(worst[0] <= BIN_DROP_GATE, f"group route: binning dropped {100 * worst[0]:.3f} % of a frame's pairs")
    check(bool(torch.isfinite(ps.pos).all() and torch.isfinite(ps.linvel).all()), "group route: state not finite")
    check(min_y > FLOOR_MID_Y, "group route: a box fell through the floor")

    def group_vs_plain(label, args, timed=True):
        """The group raster kernel and its plain version on the same inputs:
        depth bits, vid and G-buffer bits exactly equal. With `timed`, both
        timed, and the bound from the work these inputs need: per walked
        (tile, group), each live slot's test against the tile, then, per
        slot, the planes at the image pixels of its span (the smallest
        rectangle holding its covered pixels in the tile), the covered
        (slot, pixel) pairs and the hit pixels' attributes; the lists, the
        walked groups' coefficients, the winners' attribute rows and the
        outputs once."""
        rows, tl, near, w, h, n_slots, tile, base = args
        got = raster_groups.run_groups(*args)
        want_d, want_v, want_g, walked, covered, spans = raster_groups._raster_groups_plain(*args, measure=True)
        torch.cuda.synchronize()
        d_bits = int((got[0].view(torch.int32) != want_d.view(torch.int32)).sum())
        v_diff = int((got[1] != want_v).sum())
        g_bits = int((got[2].view(torch.int16) != want_g.view(torch.int16)).sum())
        err = max((got[0] - want_d).abs().max().item(), (got[2].float() - want_g.float()).abs().max().item())
        cnt = (tl >= 0).sum(1)
        hit = got[1] >= 0
        k_walk = torch.arange(tl.shape[1], device=dev)[None, :] < walked[:, None]
        groups = torch.clamp(tl, min=0)[k_walk].long()
        live = (rows[:, raster3d.PLANE_OFF + 2] != -1e30).reshape(-1, n_slots).sum(1)
        slot_pairs = int(live[groups].sum())
        used = torch.unique(groups)
        win_rows = torch.unique(got[1][hit]).numel()
        n_hit, n_cov, n_span = int(hit.sum()), int(covered.sum()), int(spans.sum())
        msg = (f"[{label}] {w}x{h}, tile {tile}, R {n_slots}, tile_base {base}, {tl.shape[0]} tiles, "
               f"{int(cnt.sum())} (tile, group) pairs listed, {int(walked.sum())} walked ({slot_pairs} live slot "
               f"walks, {slot_pairs * tile * tile} slot-pixels), worst list {int(cnt.max())}, "
               f"{int((cnt == 0).sum())} empty tiles, {n_span} span pixels, {n_cov} covered (slot, pixel) pairs, "
               f"{n_hit} hit pixels: depth bit mismatches {d_bits}, vid mismatches {v_diff}, gb bit mismatches "
               f"{g_bits}")
        check(d_bits == 0 and v_diff == 0 and g_bits == 0, f"{label}: group raster kernel != plain")
        if not timed:
            print(msg, flush=True)
            return err, walked, cnt
        n_bytes = (tl.numel() + near.numel() + int(live[used].sum()) * 15 + win_rows * 64) * 4 + w * h * 40
        bd = bound(n_bytes, slot_pairs * GROUP_OPS_SLOT_TILE + n_span * RASTER_OPS_ENTRY_PIXEL
                   + n_cov * RASTER_OPS_COVERED + n_hit * RASTER_OPS_HIT)
        ms = cuda_ms(lambda: raster_groups.run_groups(*args), 20)
        plain = cuda_ms(lambda: raster_groups._raster_groups_plain(*args), 2)
        print(f"{msg}; kernel {ms:.4f} ms, plain {plain:.2f} ms, bound {bd[0]:.5f} ms ({bd[1]}; bytes "
              f"{n_bytes / PEAK_BYTES * 1e3:.5f} ms) ({card})", flush=True)
        return err, ms, plain, bd

    # one frame's group raster inputs: the early pass, and the late pass when one runs
    group_calls = []
    for _ in range(10):
        group_calls.clear()
        with capture(raster_groups, "run_groups", group_calls):
            runner.step()
        if len(group_calls) == 2:
            break
    group_rows = []
    for i, args in enumerate(group_calls):
        group_rows.append(group_vs_plain(f"13: group raster, {('early', 'late')[i]} pass", args))
    group_err = max(r[0] for r in group_rows)

    early_outs = 0
    for seed, tile, n_slots, with_near, band in ((13, 64, 64, True, None), (14, 32, 128, False, None),
                                                 (15, 32, 32, True, (6, 24)), (16, 64, 128, True, (3, 12))):
        args = seeded_group_inputs(seed, tile, n_slots, with_near, band, dev)
        err, walked, cnt = group_vs_plain(f"13: group raster, seeded {seed}", args, timed=False)
        group_err = max(group_err, err)
        early_outs += int((walked < cnt).sum())
    print(f"[13] seeded inputs: {early_outs} tiles ended their walk early", flush=True)
    check(early_outs > 0, "no seeded tile ended its walk early")

    # one frame with the kernels and with the plain versions, from a shared state and carry
    prev = runner.carry
    runner.step()
    cam = camera_from_state(runner.state, runner._resolve_camera_idx(), WIDTH / HEIGHT)
    render = lambda: runner.renderer3d.render(
        runner.state, runner.gscene, cam, runner.bindings.materials, runner.bindings.atlas, runner.config,
        prev=prev, atmosphere=runner.atmosphere, enable_shadows=runner.enable_shadows,
        static_lights=runner._static_lights,
    )["final"]
    g0 = raster_groups.LAUNCHES
    img_k = render()
    rendered = raster_groups.LAUNCHES - g0
    with plain_on_card(raster_groups, hiz_ops, raster_depth):
        img_p = render()
    print(f"[13] one group-route frame rendered with the kernels ({rendered} group raster launches) and with the "
          f"plain versions from a shared state and carry: PSNR {psnr(img_k, img_p)} dB, identical "
          f"{bool(torch.equal(img_k, img_p))}", flush=True)
    check(rendered > 0, "the shared-carry frame launched no group raster")
    check(torch.equal(img_k, img_p), "group route: kernel and plain frames differ")

    # ---- 14. the Hopper probes (kernel table row 9) -----------------------------
    probe_rows = probe_phase(dev, card, every_mod)

    def row(name, source, replaces, mod, err, ms, plain, bd):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[mod.__name__], "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bd[0], "bound_by": bd[1], "library_ms": None}

    early = raster_rows[0]
    print(json.dumps({"kernels": [
        row("compact_substeps", "oxylus_tpu_torch/physics/csrc/megakernel_compact.cu",
            "oxylus_tpu/physics/megakernel_compact.py:75", mc, compact_err, compact_ms, compact_plain_ms,
            compact_bound),
        row("raster_tiles", "oxylus_tpu_torch/ops/csrc/raster_tiles.cu", "oxylus_tpu/ops/raster3d.py:936",
            raster3d, max(r[0] for r in raster_rows), early[1], early[2], early[3]),
        row("hiz_build", "oxylus_tpu_torch/ops/csrc/hiz.cu", "oxylus_tpu/ops/hiz.py:103", hiz_ops, hiz_err,
            hiz_ms, hiz_plain_ms, hiz_bound),
        row("dense_substeps", "oxylus_tpu_torch/physics/csrc/megakernel_dense.cu",
            "oxylus_tpu/physics/megakernel.py:46", mk, dense_err, dense_ms, dense_plain_ms, dense_bound),
        row("raster_depth", "oxylus_tpu_torch/ops/csrc/raster_depth.cu", "oxylus_tpu/ops/raster3d.py:153",
            raster_depth, depth_err, depth_ms, depth_plain_ms, depth_bound),
        row("blend2d", "oxylus_tpu_torch/ops/csrc/blend2d.cu", "oxylus_tpu/ops/raster2d_pallas.py:41", blend2d,
            max(err10, err11), blend_ms, blend_plain_ms, blend_bound),
        row("banded_substeps", "oxylus_tpu_torch/physics/csrc/megakernel_banded.cu",
            "oxylus_tpu/physics/megakernel_banded.py:80", mb, banded_err, banded_ms, banded_plain_ms, banded_bound),
        row("raster_groups", "oxylus_tpu_torch/ops/csrc/raster_groups.cu", "oxylus_tpu/ops/raster3d.py:355",
            raster_groups, group_err, group_rows[0][1], group_rows[0][2], group_rows[0][3]),
    ] + probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
