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
group raster route (phase 13), the Hopper probes (phase 14), the
Sponza-class atrium of config 4 with its textured and alpha-masked materials
(phase 15) and on the group raster route (phase 18), the port's bench suite
(phase 16), and the decode path (`RenderSpec(use_pallas=False)`) on the
golden scene (phase 17a) and the config-5 runner (phase 17b), and the app
path (phase 19: the config-5 scene with sound and a script through JSON, the
asset manager and `App.run`), and the default module roster on that scene
(phase 20: KTX2/DDS textures, the debug overlay, loopback replication, debug
views, picking and the graded tonemap), and the editor and the UI on that
scene and on config 2's sprite ids (phase 21: project, panels, undo, play and
stop, picks, ImGui and RML composites), and the tile raster route at 16- and
32-px tiles (phase 22: config 5 and the atrium, bands, sprite texture tiles),
and the sharded paths on a one-rank NCCL group and as 4 bands in turn (phase
23: worlds, the tile-sharded raster, the band-sharded frames, C8), with
bodies and the atrium made from a fixed seed. Every
kernel-vs-plain check runs the kernel and its plain PyTorch version on the
same card tensors through the kernel's wrapper
(`megakernel_substeps_compact` and `megakernel_substeps_banded`, with their
sort and permutations; `megakernel_substeps`; `rasterize_depth`;
`run_blend`; `run_groups`).

1. set-up: a card must be visible; the kernel library is built with nvcc (one
   process per source, in parallel); the meshes are baked;
2. compact kernel vs plain from the flagship's start state, for 8 and for 60
   substeps, with the bench's adaptive band and `n_planes=count_hub_planes`
   (here and in every compact check: the per-body dropped-pair row exactly
   equal, the state within its bound);
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
   each wrapper timed with CUDA events over back-to-back calls and as a CUDA
   graph of 20 calls; each raster pass prints its grid (clusters, CTAs) and
   three work counts: the first port's operations (every real entry at all
   4096 tile pixels), the least an exact design needs (a region test per
   real entry and sub-tile, the planes at the covered (entry, pixel) pairs),
   on which the bound is taken, and the (entry, pixel) pairs the kernel's
   reject leaves it to evaluate (`raster3d.tile_work`); HiZ's bound counts
   the depth read, the padded base and the levels written; the tile raster
   is also held exactly on seeded inputs (`seeded_tiles`: border slivers,
   single-corner covers, ties, missing entries, early-outs; `tie_tiles`: a
   tile whose early-out decides an exact-depth tie) and HiZ at seeded depths
   of other shapes (odd tail levels; a tail larger than the kernel's shared
   buffer); the early pass is binned again at
   K2 = 256, the most the vid's entry field holds, to report what that
   capacity would drop; then one frame is rendered with the kernels and with
   the plain versions from a shared state, and the two images must be equal;
6. the dense kernel vs plain from the flagship's start state, 8 free-fall
   substeps in one call (exactly equal) and 60 substeps in one call (the
   `physics` cell's dense call, in which the pile forms: within TOL_60), and
   one substep on `cap_scene` (one body past the kernel's cap of partners,
   counted by `megakernel.cap_stats`);
   every dense and banded check runs the kernel twice and requires the same
   bits (the contact half of this phase runs after phase 7, on its pile);
7. the headless dense runner, `SceneRunner(render_mode="none",
   use_megakernel=True)` on the flagship: 2 warm-up frames, then 60 frames
   with every launch count set to 0 just before; the dense kernel must have
   launched, the state be finite and no box centre below the floor's
   mid-plane; then 4 runner frames, each from a shared state, kernel vs plain;
   then phase 6's contact check: one substep from the pile, kernel vs plain,
   both timed (the wrapper, and the kernel's launch alone), and the operations
   bound on that pile's pairs and points (`megakernel.pair_work`) with the
   launch's share of it, and the device launches of one call (torch.profiler:
   one of the dense kernel);
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
   in the first timed frame that renders a level at the small tier; each of
   those calls timed with CUDA events against its plain version, with the
   kernel's grid (sub-tile, entry chunk, CTAs) and two bounds (on the covered
   (entry, slot, pixel) triples, and on every real slot at every pixel of
   each live pair); and one frame rendered with the kernels and with the plain
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
   threshold in a gap of its speeds (flags and timers equal), and both the
   banded (4 substeps) and the dense kernel (one) on a 2000-box pile at
   capacity 2048, past one warp per body; then, with every
   launch count set to 0 just before, the `physics` cell through
   `bench_physics(kernel="banded")` (its gates, 50 banded launches, body-steps/s,
   the coverage at the kernel's BAND of 128 at start and end), one 60-substep
   call from its pile timed against the plain version (the wrapper, and the
   kernel's launch alone) and the bound from that pile's pairs
   (`megakernel_banded.pair_work`) with the launch's share of it, and the
   device launches of one call (one of the banded kernel); `run_physics10k()` (the compact
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
   bf16 and float32 products within their sum-order bounds at 1, 7 and 500
   repetitions, two ragged shapes past their tiles at 1 and 7, each twice for
   the same bits, no rate above its data-sheet peak; `dot_rhs_t` also at n =
   72 and twice for the same bits), timed as a CUDA graph of 200 calls beside
   its plain version, its bound and, where one PyTorch call computes the same
   function, that call's time and the kernel's ratio to it (the products: one
   `torch.matmul` of the operands concatenated 500 times along k);
15. config 4, `build_sponza_scene(1920, 1080)` (the atrium GLB generated from
   seed 42 and imported and baked on the host; PIL's version, the seconds of
   each host step, the prepass capacities and the masked meshlets printed):
   every launch count set to 0, then 2 warm-up frames and 8 more; from the
   last warm-up frame on, `expand_overflow` and `bin_overflow` 0; every frame
   after the warm-up launches the tile raster for the opaque pass (K2 256)
   and the masked pass (K2 128, last) and HiZ; the depth raster launched (the
   static atrium's shadow pages render while the residency fills and stay
   cached); the image finite in [0, 1]; one frame rendered with the kernels
   and with the plain versions from a shared state and carry, without the
   shadow page cache so every level renders (identical), its tile raster
   passes held exactly against the plain version and timed with their
   bounds; seeded masked-pass inputs (K2 128) exactly equal to the plain
   version; frames/s over 3 windows of 12 frames;
16. `python -m oxylus_tpu_torch.bench` in a subprocess: every cell's line
   (value > 0 for all six) and the weakest cell with `suite` as its last line;
17a. the golden scene (`golden_scene`, `tests/test_golden_images.py`'s) on the
   decode path at 256×144 with each of the five goldens' settings: PSNR
   against the stored golden ≥ 40 dB (the goldens' bound) and ≥ 80 dB (the
   decode path's own: sound frames read ≥ 86.8, the tile route ≤ 42.7);
   PSNR ≥ 80 dB against the port's frame of the same scene on the CPU; the
   frame with the kernels equal to the frame with HiZ and the depth raster
   routed to their plain versions; HiZ and the depth raster launched, the
   tile and group rasters never;
17b. the config-5 runner, `build_frame5_scene(1920, 1080)` with
   `RenderSpec(use_pallas=False)`: 2 warm-up frames, then 10 frames timed on
   the host clock with every launch count set to 0 just before and the peak
   memory allocated; the compact kernel, HiZ and the depth raster launched,
   the tile and group rasters never; the image finite in [0, 1],
   `expand_overflow` 0, no box centre below y = -1 m;
18. (run after phase 15, on its atrium) config 4 on the group raster route
   (`raster_path="group"`, textured and alpha-masked): 3 frames with every
   launch count set to 0 just before; the group raster's opaque and masked
   passes in every frame, the tile raster never; phase 15's overflow gates;
   the image finite in [0, 1] up to 1e-6; one frame with the kernels and
   with the plain versions from a shared state and carry (identical), and
   its PSNR to the tile route's frame printed;
19. the app path at config 5's width (`app_phase`): an `AssetManager` imports a
   tone `.wav` and a counting script (sidecar UUIDs below 2^63); 16 falling
   boxes get a looping, spatialised `AudioSourceComponent` and the camera a
   listener; the scene is saved with `save_to_file` and loaded with
   `load_from_file(asset_manager=...)` (every index and component array kept
   exactly); `App.run` with the asset manager, a `ScriptManager`, an
   `AudioEngine` and an `Input` drives the runner on the App's engine for 12
   frames, each presented to a `Window` and marked on a `Profiler`. The loaded
   scene's first frame is bit-equal to the built scene's; all 16 sources bound
   and playing; 800 samples a frame; the hook's positions equal the state's;
   the script's counters; the profiler's frames and zones; the presented frame;
   a snapshot replicated through `delta`/`apply_delta` with equal hashes; the
   compact kernel, tile raster, HiZ and depth raster launched, no other.
20. the default module roster on phase 19's scene (`roster_phase`):
   `App().with_modules(*default_modules())` in the JAX package's order and
   names; its `AssetManager` imports a seeded BC7 KTX2, an RGBA8 KTX2 and a BGRA
   DDS (sidecars typed `Texture`) and a material sampling them, and loads phase
   19's JSON; the `Renderer` module's atlas and material table on the card equal
   `TextureAtlas.build()` and `pack_materials` on the CPU bit for bit. `App.run`
   drives the runner on the roster's `ScriptManager`, `AudioEngine` and
   `Physics` for 8 frames with every launch count set to 0 just before; each
   frame the `DebugRenderer` queues every body's AABB (12 lines each) and draws
   them over the image on the card (frames 1 and 8 equal `rasterize_over` on
   CPU copies, bit for bit), `sync_to_host` runs and the `NetworkManager`'s
   server replicates to a `NetClient` with a replica scene on 127.0.0.1 (each
   socket loop with a 2 s deadline); after the last frame the replica's
   component arrays equal the server scene's host mirror for every networked
   entity. The compact kernel, tile raster, HiZ and depth raster launched, no
   other. Then each debug view mode (1, 2, 4–11, 13) rendered once equals
   `apply_debug_view` on a CPU copy of its ctx; `pick_entity_3d` at 16 seeded
   pixels equals the host decode through the slot tables, `cast_ray_bodies`
   along `screen_ray` there gives the CPU's body and distance (within 1e-4
   relative) and hits at least once; `apply_tonemap` with chromatic aberration
   0.5, vignette 0.4 and grain 0.3 on the frame's HDR is within 1e-6 of the CPU.
21. the editor and the UI on phase 19's scene directory (`editor_phase`): a
   project whose start scene is phase 19's JSON, loaded by
   `ProjectPanel.load_project_for_editor` on the card; the hierarchy, the
   inspector of a box and the content listing equal to a CPU load's; a gizmo
   drag along the axis `ViewportPanel.pick_axis` returns at the box's handle
   (the update equal to the CPU's), then an inspector edit, undo, undo, redo,
   with the edit scene's device state after `merge_host_edits` bit-equal to
   the CPU scene's after each step; one edit frame, then `on_scene_simulate`
   and a `SceneRunner` over the runtime copy for 2 warm-up and 10 timed frames
   (frames/s by the host clock) and `on_scene_stop`: #1, #4, #5 and #6
   launched and no other, the image finite in [0, 1], the edit scene's device
   state and a new frame of it bit-equal to before play; config 2's sprite-id
   image from `render_2d_with_particles` (#8 launched, equal to the blend's
   plain version) and `ViewportPanel.pick` at 16 seeded pixels equal to its
   ids (each pick two views and one read of one element, by the operations
   it dispatches); an `ImGuiRenderer`
   window (a click, a toggle, a slider drag from injected mouse events through
   `Input`) and an `RmlDocument` (hover, click, data, an onclick handler)
   composited over the last play frame on the card, each within 1e-6 of the
   CPU's composite; the console, hierarchy, asset and network viewers' texts.
22. the tile raster route at the tile edges 16 and 32 (`tiles_phase`): kernel
   #4 bit-equal (depth, vid, G-buffer) to its plain version at tiles 16 and 32
   on `seeded_tiles` (three seeds, and two masked-pass inputs at K2 128) and
   `tie_tiles` re-tiled, and at tiles 64 and 32 on bands of `seeded_tiles`
   (`tile_base` > 0); `build_frame5_scene(1920, 1080, raster={"tile": t})`
   for t = 16 and 32: 2 warm-up frames, then 20 with every launch count set
   to 0 just before, #1, #4, #5 and #6 launched and no other, the image finite
   in [0, 1], `expand_overflow` 0, every frame's binning drop at most 5 %;
   from the tile-16 runner's state and a carry one frame old (the first of up
   to 10 frames whose render runs the late pass) one frame rendered at tiles
   64, 16 and 32 through `RendererInstance`, each early and late pass held
   exactly against the plain version and timed (events and a CUDA graph)
   beside its bound and CTA count; the atrium at `OX_TILE=32` through
   `bench.raster_env` (2 warm-up and 3 frames: the overflow gates, the opaque
   and masked passes at 32-px tiles, #4, #5, #6 launched and no other: the
   atrium has no bodies), its frame's passes held and timed;
   `build_sprite_texture_tiles` on the card bit-equal to the CPU on 256
   seeded sprites over a 512² atlas.
23. the sharded paths (`sharding_phase`, `oxylus_tpu_torch/parallel/`) under a
   real NCCL process group of one rank on the card, created and destroyed in
   the phase: first C8, `resample_texture_tiles` (phase 10's last frame),
   `pack_atlas_taps` (the atrium's atlas, float32 and bfloat16) and
   `sample_atlas_bilinear` (phase 17b's five calls of a frame, and seeded
   rects, UVs and modes over the atrium's atlas) bit-equal on the card to the
   CPU; 4 worlds of the flagship (1022 boxes, capacity 1024) through
   `worlds_step` over the compact kernel's 60-substep call, 4 launches, each
   world bit-equal to one single-world call, `worlds_reduce_mean` of the
   heights equal to their mean; 4 worlds of the dryrun's 31-box scene through
   `frame_step` for 10 frames, each bit-equal to the single-world
   `SceneRunner`; `rasterize_tiles_sharded` of config 5 at 1080p (phase 17b's
   culled meshlets) bit-equal to `rasterize_reference`; then at 1920×1080 and
   at 1920×1024 `render_frame_sharded` (config 5, decode path) and
   `render_frame_sharded_production` (config 5 at tiles 64 and 32; the
   atrium textured at 64 through `slot_rows` and its atlas), each as the
   one-rank call and as 4 bands run in turn through the stage functions (the
   joins written here): the 4-band frame and every band's adapted luminance
   bit-equal to the one-rank call, both bit-equal to the port's single-card
   stage chain but on the bottom rows FXAA's reach (and the textured
   albedo's upsampling) carries past the image (printed), at 1024 on every
   row; the group raster launched once for the one-rank call and once a band
   at `tile_base` 0, n, 2n, 3n. The frames are timed by events (one rank, 4
   bands), each band's group raster in a CUDA graph, the NCCL all-reduce of
   the histogram and the (empty) one-rank halo exchange by events.

Phase 5 also builds two depths' pyramids at once on two CUDA streams (the
HiZ wrapper keeps a finished-block counter per card and stream) and holds
each bit for bit against `hiz_reference`.

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
from torch.utils._python_dispatch import TorchDispatchMode

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
# per (real entry, sub-tile): the reject test of 5 planes, each its margin (6 abs, 6 add, 2 mul,
# negate) and 4 corner evaluations (4 mul + 5 add) with their compares
RASTER_OPS_REGION_TEST = 5 * (15 + 4 * 10)
GRAPH_REPS = 20  # calls in one CUDA graph, where a kernel is timed that way
# `seeded_tiles`: the image (3 × 2 tiles, the last column and row cropped), slot rows, K2
TILE_SEED_W, TILE_SEED_H, TILE_SEED_ROWS, TILE_SEED_K2 = 160, 100, 96, 192
HIZ_SEEDED_SHAPES = ((100, 700), (129, 513), (8320, 8320))  # odd tails; a tail past the shared buffer
HIZ_STREAM_SHAPE, HIZ_STREAM_ROUNDS = (4320, 7680), 8  # the two-stream check: 8K depths, so the launches overlap
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
# Depth raster: per evaluated (entry, slot, pixel), five planes × (4 mul + 5
# add) of the hi/lo evaluation, the 6 compares of the cover test and the
# first-max compare; per pair and pixel the fold into the tile (compare,
# select). The bound counts them at the covered (entry, slot, pixel) triples,
# the least an exact design must evaluate; the first port's count, every real
# slot at every pixel of each live pair with its fold, is printed beside it
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
# FXAA blends a pixel with its neighbours by bilinear weights that sum to 1
# only to a few ulps, so saturated neighbours (the atrium's emissive windows)
# give 1.0000001; the JAX function gives the same on an input in [0, 1]
# (tests/test_torch_sponza.py::test_fxaa_rounds_past_one_as_jax)
FXAA_RANGE_ROUNDING = 1e-6
ENTRY_BOXES, ENTRY_CAPACITY, ENTRY_MAX_PAIRS = 255, 512, 2048
WIDE_BOXES, WIDE_CAPACITY = 2000, 2048  # phase 12a: more bodies than the physics kernels' grid has warps
SPONZA_FRAMES, SPONZA_WINDOW = 8, 12  # phase 15: frames with the launches gated; frames per timed window
BENCH_TIMEOUT = 600  # s: phase 16's bench suite
GROUP_ATRIUM_FRAMES = 3  # phase 18: the atrium's frames on the group raster route
DECODE_FRAMES = 10  # phase 17b: timed frames of the config-5 runner on the decode path
GOLDEN_W, GOLDEN_H, GOLDEN_MIN_DB = 256, 144, 40.0  # phase 17a: the goldens' size and bound (tests/test_golden_images.py)
# phase 17a: the decode path's own bound to each golden. Sound frames read 86.81-93.80 dB on an H100 and
# 87.43-90.12 dB on the CPU; the port's tile route reads 41.27-42.71 dB on the same goldens, so a fault
# that costs the decode path tens of dB still clears the goldens' 40 dB but not this.
GOLDEN_DECODE_MIN_DB = 80.0
GOLDEN_SETTINGS = {  # tests/test_golden_images.py's five goldens
    "flat": {}, "sky": dict(atmosphere=True), "shadows": dict(atmosphere=True, enable_shadows=True),
    "full": dict(atmosphere=True, enable_shadows=True, ssr=True), "sky65": dict(atmosphere=True, fov_deg=65.0),
}
EVENT_FRAMES = 4
TILES_EDGES = (16, 32)  # phase 22: the tile route's other tile edges, driven on config 5
TILES_FRAMES = 20  # phase 22: gated frames of each config-5 runner after its warm-up
TILES_ATRIUM_FRAMES = 3  # phase 22: the atrium's frames at OX_TILE=32 after its warm-up
TILES_SPRITES = 256  # phase 22: per-sprite materials of the texture-tile check
SHARD_BANDS = 4  # phase 23: the bands run in turn on one card
SHARD_WORLDS = 4  # phase 23: worlds of the flagship and of the dryrun's 31-box scene
SHARD_FRAMES = 10  # phase 23: frame_step frames of the 31-box worlds
SHARD_EXACT_HEIGHT = 1024  # phase 23: a multiple of SHARD_BANDS · 64 (and · 32): no row past the image
SHARD_SLOTS = 64  # phase 23: slots per dense group of the group-route frames
SHARD_TILES = (64, 32)  # phase 23: the group-route frames' tile edges
SHARD_REPS = 5  # phase 23: timed calls of the group-route frames (the decode path's: 1)


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


def device_kernels(fn, name: str, attempts: int = 3) -> tuple[int, int]:
    """Device work of one call of `fn`, traced by torch.profiler (CUPTI) after
    a warm-up call: the kernels whose name holds `name`, and all device
    activities (the wrapper's PyTorch ops and copies included). A trace that
    recorded no device activity at all saw nothing, and is taken again, up to
    `attempts` times."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    return sum(name in n for n in names), len(names)


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


def cap_scene(ps):
    """The flagship's start state `ps` with its first dynamic box made a plate
    (half extents 0.6 m past the pile's box centres in x and z, 0.05 m in y)
    lying at y = 1.58 m, in the gap between the two lowest layers of boxes,
    some of whose tops (1.5 ± 0.05 m) it touches: its AABB overlaps well over
    `megakernel.CAP` boxes, every other box's a few, so one body is past the
    dense kernel's cap (`tests/test_torch_physics_redesign.py` checks this)."""
    from oxylus_tpu_torch.physics.state import BODY_DYNAMIC

    dyn = (ps.body_type == BODY_DYNAMIC) & ps.active
    i = int(torch.nonzero(dyn)[0])
    lo, hi = ps.pos[dyn].amin(0), ps.pos[dyn].amax(0)
    pos, half, quat = ps.pos.clone(), ps.half_extent.clone(), ps.quat.clone()
    pos[i] = torch.stack([(lo[0] + hi[0]) / 2, torch.tensor(1.58, device=ps.device), (lo[2] + hi[2]) / 2])
    half[i] = torch.stack([(hi[0] - lo[0]) / 2 + 0.6, torch.tensor(0.05, device=ps.device), (hi[2] - lo[2]) / 2 + 0.6])
    quat[i] = torch.tensor([0.0, 0.0, 0.0, 1.0], device=ps.device)
    return dataclasses.replace(ps, pos=pos, half_extent=half, quat=quat)


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


def seeded_blend_inputs(seed, w, h, k, n_sprites, with_depth, dev, tint_lo=0.3):
    """Packed blend inputs at a main path's shapes (w×h, K = k), made from
    a seed: rotated sprites of assorted sizes, random texel planes from
    transparent to opaque, random tints in [tint_lo, 1), every 4th
    untextured, every 3rd alpha-masked at 0.45, every 2nd flipped; every
    8th untextured of alpha 0.5, axis-aligned, 15 px, at a half-pixel
    corner, so that texel coordinates fall on integers and alphas on the
    id's 0.5 threshold; a cluster crowds the first tile past K and the right
    part of the image stays empty; with `with_depth` record and scene depths
    in eighths, so that some tie. On `dev`."""
    from oxylus_tpu_torch.ops import blend2d

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
    rec[:, 7:11] = tint_lo + (1 - tint_lo) * rnd(n_sprites, 4)
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


PROBE_REPS = 200  # timed launches per probe kernel (after one warm-up)
PRODUCT_RAGGED = ((96, 80, 48, torch.float32), (48, 64, 80, torch.bfloat16))  # past the product kernels' tiles


def _tri_edge(p, q, inside):
    """The edge function through p and q (a·x + b·y + c), positive on the side of `inside`."""
    a, b = q[1] - p[1], -(q[0] - p[0])
    c = -(a * p[0] + b * p[1])
    s = 1.0 if a * inside[0] + b * inside[1] + c >= 0 else -1.0
    return s * a, s * b, s * c


def _plane_through(v, z):
    """The plane z = a·x + b·y + c through three (x, y) vertices with values z."""
    import numpy as np

    m = np.array([[x, y, 1.0] for x, y in v])
    return np.linalg.solve(m, np.asarray(z, np.float64))


def _tile_triangle(rng, v, kind):
    """(5, 3) plane coefficients (e0 e1 e2 zn wd) × (a b c) of a triangle and
    its nearest depth (the largest vertex z, clipped to [0, 1])."""
    import numpy as np

    cen = np.mean(v, 0)
    rows = [_tri_edge(v[i], v[(i + 1) % 3], cen if kind != "sliver" else v[(i + 2) % 3]) for i in range(3)]
    z = rng.uniform(0.05, 0.85, 3) if kind != "cover" else rng.uniform(0.9, 0.99, 3)
    if kind == "tie":
        z[:] = 0.5
    if kind == "wd_cross":  # wd falls below 0 across the image: covers only where it is positive
        wv = rng.uniform(-0.5, 1.5, 3)
    elif kind == "perspective":
        wv = rng.uniform(0.5, 2.0, 3)
    else:
        wv = np.ones(3)
    wd = _plane_through(v, wv) if kind != "tie" else np.array([0.0, 0.0, 1.0])
    zn = _plane_through(v, z * wv) if kind != "tie" else np.array([0.0, 0.0, 0.5])  # z = 0.5 exactly
    tz = float(np.clip(np.max(z), 0.0, 1.0))
    return np.array(rows + [tuple(zn), tuple(wd)], np.float64), tz


def _pixel_centre(rng, lo, hi):
    return float(rng.integers(lo, hi)) + 0.5


def _tile_vertices(rng, kind, w, h):
    import numpy as np

    if kind in ("snapped", "tie", "wd_cross"):  # vertices on pixel centres: edges through centres
        return [(_pixel_centre(rng, 0, w), _pixel_centre(rng, 0, h)) for _ in range(3)]
    if kind == "sliver":  # an edge along a sub-tile's border row or column of centres
        sx, sy = int(rng.integers(0, w // 32 + 1)) * 32, int(rng.integers(0, h // 32 + 1)) * 32
        row = sy + (0.5 if rng.uniform() < 0.5 else -0.5)
        x0, x1 = sx + 0.5, sx + 0.5 + float(rng.integers(2, 40))
        if rng.uniform() < 0.5:
            return [(x0, row), (x1, row), ((x0 + x1) / 2, row - 7.0 * np.sign(rng.uniform(-1, 1)))]
        col = sx + (0.5 if rng.uniform() < 0.5 else -0.5)
        return [(col, row), (col, row + 30.0), (col - 9.0, row + 15.0)]
    if kind == "corner":  # a small triangle around one corner centre of a sub-tile or warp block
        cx = int(rng.integers(0, w // 16 + 1)) * 16 + 0.5
        cy = int(rng.integers(0, h // 8 + 1)) * 8 + 0.5
        return [(cx, cy), (cx + 0.9, cy + 0.2), (cx + 0.3, cy + 0.8)]
    if kind == "cover":  # the whole image and past its edge
        return [(-400.0, -400.0), (1200.0, -300.0), (-300.0, 1200.0)]
    c = rng.uniform([-20, -20], [w + 20, h + 20])
    return [tuple(c + rng.normal(0, rng.choice([2.0, 15.0, 60.0]), 2)) for _ in range(3)]


def _tile_comb(planes, tz, rng):
    """Slot rows as `build_tile_comb` lays them out: random attribute rows, the
    15 plane coefficients, tz, material, instance, packed id."""
    import numpy as np

    from oxylus_tpu_torch.ops import raster3d as tr

    n = len(planes)
    comb = np.zeros((n, tr.COMB_W), np.float32)
    comb[:, : tr.ATTR_W] = rng.normal(0, 1, (n, tr.ATTR_W))
    comb[:, tr.PLANE_OFF : tr.PLANE_OFF + 15] = np.stack(planes).reshape(n, 15)
    comb[:, tr.PLANE_OFF + 15] = tz
    comb[:, tr.PLANE_OFF + 16 :] = rng.integers(0, 50, (n, 3))
    return torch.from_numpy(comb)


def seeded_tiles(seed, dev, k2=TILE_SEED_K2, tile=64, band_row=0):
    """Tile raster inputs made from a seed with NumPy, (entries (T, K2), comb,
    counts, near_r, width, height, tile, tile_base) on `dev` at TILE_SEED_W ×
    TILE_SEED_H (not a multiple of any tile edge): planar triangles with
    vertices snapped to pixel centres, slivers along sub-tile borders,
    single-corner covers, wd planes crossing zero, depth ties, dead slots and
    tile-covering triangles in front (so the early-out fires); each tile's
    list sorted by tz, nearest first, with missing entries inside its count
    and -1 past it; one empty tile, one full. With `band_row` > 0 the input is
    a band of a taller image starting at that row of tiles (tile_base =
    band_row · tiles a row): the triangles are made in the band's coordinates
    and moved down to it, so the planes cover the band where they covered the
    image."""
    import numpy as np

    from oxylus_tpu_torch.ops import raster3d as tr

    w, h, n_rows = TILE_SEED_W, TILE_SEED_H, TILE_SEED_ROWS
    rng = np.random.default_rng(seed)
    kinds = ["flat", "snapped", "sliver", "corner", "wd_cross", "perspective", "tie", "dead", "cover"]
    planes, tz = [], []
    for i in range(n_rows):
        kind = kinds[i % len(kinds)] if i < 2 * len(kinds) else rng.choice(kinds, p=[.2, .2, .15, .1, .1, .1, .05,
                                                                                      .06, .04])
        if kind == "dead":  # e0 = -1e30 constant: never covers
            co, z = _tile_triangle(rng, [(0, 0), (1, 0), (0, 1)], "flat")
            co[0] = (0.0, 0.0, -1e30)
        else:
            v = _tile_vertices(rng, kind, w, h)
            if abs((v[1][0] - v[0][0]) * (v[2][1] - v[0][1]) - (v[1][1] - v[0][1]) * (v[2][0] - v[0][0])) < 1e-3:
                v[2] = (v[2][0] + 3.0, v[2][1] + 5.0)
            co, z = _tile_triangle(rng, v, kind)
        if band_row:  # a·x + b·(y - dy) + c: the triangle moved down by dy (a dead slot's e0 has b = 0)
            co[:, 2] -= co[:, 1] * (band_row * tile)
        planes.append(co.astype(np.float32))
        tz.append(z)
    comb = _tile_comb(planes, np.asarray(tz, np.float32), rng)
    tx = -(-w // tile)
    n_tiles = tx * -(-h // tile)
    entries = np.full((n_tiles, k2), -1, np.int32)
    counts = np.zeros(n_tiles, np.int32)
    for t in range(n_tiles):
        n = [0, k2, 70][t] if t < 3 else int(rng.integers(1, k2 + 1))
        rows = rng.integers(0, n_rows, n)
        rows = rows[np.argsort(-np.asarray(tz)[rows], kind="stable")]
        rows[rng.uniform(size=n) < 0.08] = -1  # missing entries inside the count
        entries[t, :n] = rows
        counts[t] = n
    entries, comb = torch.from_numpy(entries).to(dev), comb.to(dev)
    return (entries, comb, torch.from_numpy(counts).to(dev), tr.pack_tile_blocks(entries, comb)["near_r"], w, h,
            tile, band_row * tx)


def tie_tiles(full: bool, dev, tile=64):
    """A 64² image, two rounds. Round 0: two flat triangles at z = 0.5 (slots
    10 and 11) cover all of the image but its bottom-right 32² quarter; with
    `full`, a third (slot 12) covers that one too. Round 1: a triangle at the
    same z (slot 5: a larger slot code) over part of the top-left quarter.
    bits(0.5) has no bits under 127, so the round-1 triangle ties the masked
    depth and wins wherever it is evaluated; at 64² tiles (one tile, a quarter
    a CTA) the tile-wide early-out runs round 1 unless the tile is full. At a
    smaller `tile` every tile of the image gets the same list. On `dev`, as
    (entries, comb, counts, near_r, width, height, tile, tile_base)."""
    import numpy as np

    from oxylus_tpu_torch.ops import raster3d as tr

    rng = np.random.default_rng(7)
    verts = [[(31.9, -1e4), (31.9, 1e4), (-1e4, 0.0)],  # x < 31.9
             [(-1e4, 31.9), (1e4, 31.9), (0.0, -1e4)],  # y < 31.9
             [(31.0, 31.0), (1e4, 31.0), (31.0, 1e4)],  # the bottom-right sub-tile
             [(4.0, 4.0), (24.0, 6.0), (8.0, 26.0)]]    # round 1, inside the top-left sub-tile
    planes = [_tile_triangle(rng, v, "tie")[0].astype(np.float32) for v in verts]
    comb = _tile_comb(planes, np.full(4, 0.5, np.float32), rng)
    n_tiles = (tr.TILE // tile) ** 2
    entries = torch.full((n_tiles, 128), -1, dtype=torch.int32)
    entries[:, 10], entries[:, 11], entries[:, 64 + 5] = 0, 1, 3
    if full:
        entries[:, 12] = 2
    entries, comb = entries.to(dev), comb.to(dev)
    near_r = tr.pack_tile_blocks(entries, comb)["near_r"]
    counts = torch.full((n_tiles,), 128, dtype=torch.int32, device=dev)
    return entries, comb, counts, near_r, tr.TILE, tr.TILE, tile, 0


def tile_raster_vs_plain(dev, card: str, label: str, args) -> tuple:
    """One tile raster call's inputs (`run_tiles`' arguments): the kernel exactly
    against its plain version, timed (events and a CUDA graph) beside the plain
    version and the bound from this input's work. Returns (max abs err, graph
    ms, plain ms, bound, events ms, tile_work's counts)."""
    from oxylus_tpu_torch import probes
    from oxylus_tpu_torch.ops import raster3d

    entries, comb, counts, near_r, w, h, *rest = args
    tile, base = (rest + [raster3d.TILE, 0])[:2]
    pix = tile * tile
    got = raster3d.run_tiles(*args)
    want_d, want_v, want_g, rounds_run, covered = raster3d._raster_tiles_plain(*args)
    torch.cuda.synchronize()
    d_err = (got[0] - want_d).abs().max().item()
    g_err = (got[2].float() - want_g.float()).abs().max().item()
    d_bits = int((got[0].view(torch.int32) != want_d.view(torch.int32)).sum())
    vid_diff = int((got[1] != want_v).sum())
    bits_diff = int((got[2].view(torch.int16) != want_g.view(torch.int16)).sum())
    hit = got[1] >= 0
    n_hit = int(hit.sum())
    v = got[1][hit].long()
    win_rows = torch.unique(entries[(v >> 8) - base, v & 255]).numel()
    ref_rows = torch.unique(entries[entries >= 0]).numel()
    ms = cuda_ms(lambda: raster3d.run_tiles(*args), 20)
    graph_ms = probes.time_us(lambda: raster3d.run_tiles(*args), dev, GRAPH_REPS)[0] * 1e-3
    plain = cuda_ms(lambda: raster3d._raster_tiles_plain(*args), 2)
    rounds = int(rounds_run.sum())
    real = int(torch.minimum(counts, rounds_run * raster3d.TILE_ROUND).sum())  # entries of the rounds run
    n_cov = int(covered.sum())
    work = raster3d.tile_work(entries, comb, rounds_run, w, tile, base)
    n_bytes = (entries.numel() + counts.numel() + near_r.numel() + ref_rows * 15 + win_rows * 64) * 4 + w * h * 40
    old_ops = real * pix * RASTER_OPS_ENTRY_PIXEL + n_cov * RASTER_OPS_COVERED + n_hit * RASTER_OPS_HIT
    least_ops = (work["region_tests"] * RASTER_OPS_REGION_TEST
                 + n_cov * (RASTER_OPS_ENTRY_PIXEL + RASTER_OPS_COVERED) + n_hit * RASTER_OPS_HIT)
    bd = bound(n_bytes, least_ops)
    print(f"[{label}] tile {tile}, tile_base {base}: {entries.shape[0]} tiles, {int(counts.sum())} entries, {rounds} "
          f"rounds run over {real} entries ({work['real']} real), {n_cov} covered (entry, pixel) pairs, {n_hit} hit "
          f"pixels: kernel vs plain depth err {d_err}, depth bit mismatches {d_bits}, gb err {g_err}, vid mismatches "
          f"{vid_diff}, gb bit mismatches {bits_diff}; grid {work['clusters']} clusters of {work['cluster']} = "
          f"{work['ctas']} CTAs; work: the first port's count {old_ops} operations ({real * pix} (entry, pixel) "
          f"pairs), the least exact count {least_ops} ({work['region_tests']} region tests, {n_cov} covered "
          f"pairs), the kernel evaluates {work['evaluated']} (entry, pixel) pairs; kernel {ms:.4f} ms (events, "
          f"back to back), {graph_ms:.4f} ms (CUDA graph of {GRAPH_REPS}), plain {plain:.2f} ms, bound "
          f"{bd[0]:.4f} ms ({bd[1]}; {n_bytes} bytes, {least_ops} operations; on the first port's count "
          f"{bound(n_bytes, old_ops)[0]:.4f} ms) ({card})", flush=True)
    check(d_bits == 0 and d_err == 0 and g_err == 0 and vid_diff == 0 and bits_diff == 0,
          f"{label}: kernel != plain")
    check(work["evaluated"] < real * pix, f"{label}: the reject left every (entry, pixel) pair")
    return max(d_err, g_err), graph_ms, plain, bd, ms, work


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
    check(len(lines) == 24, f"run_all gave {len(lines)} probe lines, not 24")
    for r in lines:
        if r["name"].startswith("matmul"):
            check(r["tflops"] <= r["peak_tflops"], f"{r['name']}: {r['tflops']:.1f} TFLOP/s above the data sheet's "
                                                  f"{r['peak_tflops']}: a repetition hoisted out of the kernel's loop?")
    for name, n in counts.items():
        check(n > 0, f"the probe run never launched a kernel of {name}")
    for kernel in mosaic_ops.OPS:
        check(mosaic_counts.get(kernel, 0) > 0, f"the probe run never launched mosaic_ops' {kernel} kernel")
    roll_kernels = ("roll_chain", "roll_last", "vector_chain", "matmul_f32", "matmul_bf16", "argmax_extract",
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

    def exact(label, got, want, bits=False) -> float:
        """Max abs error, which must be 0; with `bits`, the same bits too (-0 apart from +0, NaN's payload)."""
        err = diff(got, want)
        print(f"[14] {label}: max abs err {err}", flush=True)
        check(err == 0.0, f"{label}: kernel != plain")
        check(not bits or torch.equal(got.view(torch.int32), want.view(torch.int32)), f"{label}: other bits than plain")
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
        ratio = "" if lib is None else f" = {us * 1e-3 / lib:.3f}x the library call"
        print(f"[14] {label}: kernel {us * 1e-3:.6f} ms a call in a CUDA graph ({host_us * 1e-3:.6f} ms called one "
              f"by one from the host){ratio}, plain {plain:.4f} ms, library {'none' if lib is None else f'{lib:.6f} ms'}"
              f", bound {bd[0]:.6f} ms ({bd[1]}: {n_bytes} bytes, {n_ops} operations at {peak / 1e12:g} T/s) ({card})",
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

    # -- dot_rhs_t: within the sum-order bound on the script's sparse 0/1 m, on dense seeded m and at n = 72
    # (9 blocks of 8 columns), the script's check, the same bits twice
    err = 0.0
    v72, m72 = dot_rhs_t.seeded_inputs(8, dev)
    for label, (v, m) in (("script", dot_rhs_t.script_inputs(dev)), ("dense seed 7", dot_rhs_t.seeded_inputs(7, dev)),
                          ("dense seed 8, n = 72", (v72, m72[:72].contiguous()))):
        got = dot_rhs_t.dot_rhs_t(v, m)
        err = max(err, within(f"dot_rhs_t, {label}", got, dot_rhs_t.dot_rhs_t_reference(v, m),
                              dot_rhs_t.sum_order_bound(v, m)))
        script_err = dot_rhs_t.script_error(v, m, got)
        same = torch.equal(got.view(torch.int32), dot_rhs_t.dot_rhs_t(v, m).view(torch.int32))
        print(f"[14] dot_rhs_t, {label}: the script's check, out[0] + out[1] vs vcat·mᵀ, relative {script_err:.3g}; "
              f"two runs give the same bits: {same}", flush=True)
        check(script_err < dot_rhs_t.SCRIPT_TOL, f"dot_rhs_t, {label}: script check {script_err}")
        check(same, f"dot_rhs_t, {label}: two runs differ")
    v, m = dot_rhs_t.script_inputs(dev)
    vals = dot_rhs_t.split_rows(v)
    mt = m.t()
    n_ops = 2 * dot_rhs_t.N2 * m.shape[0] * dot_rhs_t.K
    # the library call multiplies the split rows, made beforehand: the product without the split
    t = timed("dot_rhs_t (12, 1024)·(384, 1024)ᵀ", lambda: dot_rhs_t.dot_rhs_t(v, m),
              lambda: dot_rhs_t.dot_rhs_t_reference(v, m), dot_rhs_t.K * 4 + m.numel() * 2 + 12 * m.shape[0] * 4,
              n_ops, PEAK_BF16, library_fn=lambda: torch.matmul(vals, mt))
    row("probe_dot_rhs_t", "dot_rhs_t.cu", "scripts/probe_dot_rhs_t.py:21", counts[dot_rhs_t.__name__], err, t)

    # -- mosaic ops: every script and seeded case exact
    errs = collections.defaultdict(float)
    for name, kernel, args in mosaic_ops.script_cases(dev) + mosaic_ops.seeded_cases(41, dev):
        errs[kernel] = max(errs[kernel], exact(f"mosaic_ops {name}", mosaic_ops.run_case(kernel, args),
                                               mosaic_ops.plain_case(kernel, args), bits=kernel == "sort"))
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
        # no one call rounds x·x to bf16 before it adds x (addcmul rounds x + x·x once): no library time
        "bf16_mul_add": None,
    }
    sizes = {  # bytes moved, operations
        "take_lanes": (n_el * 12, 0), "take_rows": (n_el * 12, 0), "scan": (n_el * 8, n_el),
        "sort": (n_el * 8, int(n_el * log_n)), "argmax": (n_el * 4 + x.shape[0] * 4, n_el),
        "roll_lanes": (n_el * 8, 0), "bf16_mul_add": (n_el * 4, 2 * n_el),
    }
    lines_at = {"take_lanes": 37, "scan": 54, "sort": 70, "argmax": 78, "roll_lanes": 86, "take_rows": 95,
                "bf16_mul_add": 104}
    two_calls = probes.time_us(lambda: xb * xb + xb, dev, PROBE_REPS)[0] * 1e-3
    print(f"[14] bf16 x·x + x as two PyTorch calls (xb * xb + xb, each rounded to bf16): {two_calls:.6f} ms a pair "
          f"in a CUDA graph ({card})", flush=True)
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
        for shift in (5, -133, 517):
            errs["roll_last"] = max(errs["roll_last"], exact(
                f"dynamic roll {shift}, {label}", proll.dynamic_roll(xv, proll.scalar(shift, dev)),
                proll.roll_chain_reference(xv, 1, shift, accumulate=False)))
        errs["roll_chain"] = max(errs["roll_chain"], exact(
            f"static roll x{proll.N_INNER}, {label}", proll.roll_chain(xv, proll.N_INNER),
            proll.roll_chain_reference(xv, proll.N_INNER, 1)))
        errs["roll_chain"] = max(errs["roll_chain"], exact(
            f"dynamic roll x{proll.N_INNER}, {label}",
            proll.dynamic_roll_chain(xv, proll.N_INNER, proll.scalar(proll.DYN_BASE, dev)),
            proll.roll_chain_reference(xv, proll.N_INNER, proll.DYN_BASE, proll.DYN_STEP)))
        # every count of distinct shifts the kernel is built for (D = min(step_mod, 128)), 300 adds: a tail past
        # the last full trip of max(D, 8)
        for step_mod in (2, 8, 16, 32, 64, 128, 256):
            errs["roll_chain"] = max(errs["roll_chain"], exact(
                f"dynamic roll x300 step {step_mod}, base 517, {label}",
                proll.dynamic_roll_chain(xv, 300, proll.scalar(517, dev), step_mod),
                proll.roll_chain_reference(xv, 300, 517, step_mod)))
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
    # the products: all ones exact at the script's shapes; seeded a, b within the sum-order bound at 1, 7 and 500
    # repetitions (the ragged shapes, past the kernels' 128-row tiles, at 1 and 7), each twice with the same bits
    for m_, k_, n_, dtype in proll.MATMULS + PRODUCT_RAGGED:
        kname = "matmul_f32" if dtype == torch.float32 else "matmul_bf16"
        script = (m_, k_, n_, dtype) in proll.MATMULS
        if script:
            a, b = torch.ones(m_, k_, dtype=dtype, device=dev), torch.ones(k_, n_, dtype=dtype, device=dev)
            got = proll.matmul_acc(a, b, proll.REPS_M)
            check(bool((got == proll.REPS_M * k_).all()), f"{kname} {m_}x{k_}x{n_}: all-ones product != 500·k")
            errs[kname] = max(errs[kname], exact(f"{kname} {m_}x{k_}x{n_} all ones x{proll.REPS_M}", got,
                                                 proll.matmul_reference(a, b, proll.REPS_M)))
        a, b = proll.seeded_matrices(m_ + k_ + n_, m_, k_, n_, dtype, dev)
        for reps in (1, 7, proll.REPS_M) if script else (1, 7):
            label = f"{kname} {m_}x{k_}x{n_} seeded x{reps}"
            got = proll.matmul_acc(a, b, reps)
            errs[kname] = max(errs[kname], within(label, got, proll.matmul_reference(a, b, reps),
                                                  proll.product_bound(a, b, reps)))
            same = torch.equal(got.view(torch.int32), proll.matmul_acc(a, b, reps).view(torch.int32))
            plan = proll.product_plan(m_, k_, n_, reps, dtype)
            print(f"[14] {label}: two runs give the same bits: {same}; plan {plan['design']}, tile 128 x "
                  f"{plan['tile_n']}, k-slice {plan['k_slice']}, {plan['rep_groups']} repetition groups, "
                  f"{plan['grid']} CTAs, {plan['parts']} partials, {plan['smem_bytes']} B of shared memory", flush=True)
            check(same, f"{label}: two runs differ")
    n_el = xs.numel()
    t_vec = timed(f"vector_chain x{proll.N_INNER} (8, 128)", lambda: proll.vector_chain(xs, proll.N_INNER),
                  lambda: proll.vector_chain_reference(xs, proll.N_INNER), 2 * n_el * 4, 8 * proll.N_INNER * n_el,
                  plain_reps=2)
    t = timed(f"roll_chain static x{proll.N_INNER} (8, 128)", lambda: proll.roll_chain(xs, proll.N_INNER),
              lambda: proll.roll_chain_reference(xs, proll.N_INNER, 1), 2 * n_el * 4, proll.N_INNER * n_el,
              plain_reps=2)
    # the static chain is N_INNER dependent adds an element: in a graph it takes at least their latency, which the
    # vector chain's 8 dependent operations an iteration give; a time under 0.8 of that means adds were skipped
    op_ns = t_vec[0] * 1e6 / (8 * proll.N_INNER)
    chain_floor = proll.N_INNER * op_ns * 1e-6
    print(f"[14] roll_chain: {t[0] * 1e6 / proll.N_INNER:.3f} ns an iteration of the (8, 128) block; dependent-op "
          f"latency {op_ns:.4f} ns (the (8, 128) vector chain / {8 * proll.N_INNER}), so the chain's floor "
          f"{chain_floor:.6f} ms: {t[0] / chain_floor:.3f}x it ({card})", flush=True)
    check(t[0] >= 0.8 * chain_floor, f"roll_chain: {t[0]:.6f} ms under 0.8x its {proll.N_INNER}-add chain's latency "
                                     f"{chain_floor:.6f} ms: adds skipped?")
    row("probe_roll_chain", "roll.cu", "scripts/probe_roll.py:56", roll_counts.get("roll_chain", 0),
        errs["roll_chain"], t)
    shift5 = proll.scalar(proll.DYN_SHIFT, dev)
    # the library call takes its shift from the host; the kernel reads it on the card
    t = timed("roll_last: one roll by a shift read on the card (8, 128)", lambda: proll.dynamic_roll(xs, shift5),
              lambda: proll.roll_chain_reference(xs, 1, proll.DYN_SHIFT, accumulate=False), 2 * n_el * 4 + 4, 0,
              library_fn=lambda: torch.roll(xs, proll.DYN_SHIFT, 1))
    row("probe_roll_last", "roll.cu", "scripts/probe_roll.py:41", roll_counts.get("roll_last", 0),
        errs["roll_last"], t)
    row("probe_vector_chain", "roll.cu", "scripts/probe_roll.py:76", roll_counts.get("vector_chain", 0),
        errs["vector_chain"], t_vec)
    t_big = timed(f"vector_chain x{proll.VPU_BIG_ITERS} (128, 384)",
                  lambda: proll.vector_chain(xb, proll.VPU_BIG_ITERS),
                  lambda: proll.vector_chain_reference(xb, proll.VPU_BIG_ITERS), 2 * xb.numel() * 4,
                  8 * proll.VPU_BIG_ITERS * xb.numel(), plain_reps=2)
    print(f"[14] vector chain rates: (8, 128) x{proll.N_INNER} {8 * proll.N_INNER * n_el / t_vec[0] / 1e9:.4f} "
          f"TFLOP/s, (128, 384) x{proll.VPU_BIG_ITERS} "
          f"{8 * proll.VPU_BIG_ITERS * xb.numel() / t_big[0] / 1e9:.4f} TFLOP/s of 67 ({card})", flush=True)
    m_, k_, n_ = 1024, 1024, 128
    for dtype, kname, line in ((torch.float32, "matmul_f32", 109), (torch.bfloat16, "matmul_bf16", 109)):
        a, b = torch.ones(m_, k_, dtype=dtype, device=dev), torch.ones(k_, n_, dtype=dtype, device=dev)
        flops = 2 * m_ * k_ * n_ * proll.REPS_M
        elt = 2 if dtype == torch.bfloat16 else 4
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
        # the library call: one torch.matmul of the operands concatenated 500 times along k (made beforehand), the
        # same 2·m·k·n·500 operations; TF32 off, so float32 stays float32
        a_cat, b_cat = a.repeat(1, proll.REPS_M), b.repeat(proll.REPS_M, 1)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            t = timed(f"{kname} {m_}x{k_}x{n_} x{proll.REPS_M}", lambda: proll.matmul_acc(a, b, proll.REPS_M),
                      lambda: proll.matmul_reference(a, b, proll.REPS_M), (m_ * k_ + k_ * n_) * elt + m_ * n_ * 4,
                      flops, peak, library_fn=lambda: torch.matmul(a_cat, b_cat), plain_reps=2)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        cat_bytes = a_cat.numel() * elt + b_cat.numel() * elt
        del a_cat, b_cat
        rate = flops / t[0] / 1e9
        one = cuda_ms(lambda: torch.matmul(a, b), PROBE_REPS)
        print(f"[14] {kname}: {rate:.3f} TFLOP/s of {peak / 1e12:g} ({rate / (peak / 1e12):.1%}); the library call "
              f"{flops / (t[3] * 1e9):.3f} TFLOP/s on {cat_bytes / 1e9:.2f} GB of concatenated operands"
              f"{' (bytes-bound: %.3f ms to read them at 3.35 TB/s)' % (cat_bytes / PEAK_BYTES * 1e3) if elt == 2 else ''}"
              f"; torch.matmul of one product {one:.5f} ms = {2 * m_ * k_ * n_ / one / 1e9:.3f} TFLOP/s, the "
              f"yardstick, not used by the port ({card})", flush=True)
        check(rate <= peak / 1e12, f"{kname}: {rate:.1f} TFLOP/s above the data sheet's {peak / 1e12:g}: a "
                                   f"repetition hoisted out of the kernel's loop?")
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
    # the probes' floors: a launch (the least graph time of this phase's kernels) and their dependent chains at
    # op_ns a dependent operation
    low = min(rows, key=lambda r: r["ms"])
    print(f"[14] launch floor {low['ms']:.6f} ms ({low['name']}); each kernel's graph time over it: "
          f"{ {r['name']: round(r['ms'] / low['ms'], 3) for r in rows} } ({card})", flush=True)
    chains = {"roll_chain": proll.N_INNER, "vector_chain (8, 128)": 8 * proll.N_INNER,
              "vector_chain (128, 384)": 8 * proll.VPU_BIG_ITERS, "dynamic_trip": proll.DYN_TRIP}
    print(f"[14] dependent-chain floors at {op_ns:.4f} ns an operation: "
          f"{ {k: f'{n} ops, {n * op_ns * 1e-6:.6f} ms' for k, n in chains.items()} }; the (128, 384) vector chain "
          f"took {t_big[0]:.6f} ms ({card})", flush=True)
    return rows


def golden_scene(dev, fov_deg: float = 60.0):
    """The scene of the stored goldens (`tests/test_golden_images.py::_world`)
    on the port: a unit cube over a 20 m ground plane under a sun, the
    camera at (0, 1, 4) looking down -z. Returns (state, gscene, camera,
    materials)."""
    import numpy as np

    from oxylus_tpu_torch.assets.bake import bake_mesh
    from oxylus_tpu_torch.assets.material import empty_gpu_materials
    from oxylus_tpu_torch.frame5 import cube_mesh
    from oxylus_tpu_torch.render.camera import camera_matrices
    from oxylus_tpu_torch.render.scene3d import upload_meshes
    from oxylus_tpu_torch.scene.scene import Scene
    from oxylus_tpu_torch.scene.state import SceneSpec

    s = Scene("golden3d", spec=SceneSpec(max_entities=32), device=dev)
    ground = s.create_entity("ground")
    ground.add("TransformComponent", position=(0.0, -1.0, 0.0))
    cube = s.create_entity("cube")
    cube.add("TransformComponent", position=(0.0, 0.0, 0.0))
    sun = s.create_entity("sun")
    sun.add("TransformComponent", position=(0.0, 10.0, 0.0), rotation=(-0.3826834, 0.0, 0.0, 0.9238795))
    sun.add("LightComponent", type="Directional", color=(1.0, 0.98, 0.9), intensity=4.0)
    plane = (np.array([[-10, 0, -10], [10, 0, -10], [10, 0, 10], [-10, 0, 10]], np.float32),
             np.tile(np.array([[0, 1, 0]], np.float32), (4, 1)),
             np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32), np.array([0, 2, 1, 0, 3, 2], np.uint32))
    gscene = upload_meshes([bake_mesh(*cube_mesh()), bake_mesh(*plane)], [(0, cube.index, 0), (1, ground.index, 0)],
                           max_instances=4, device=dev)
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    cam = camera_matrices(position=f([0.0, 1.0, 4.0]), yaw=f(-math.pi / 2), pitch=f(0.0), tilt=f(0.0),
                          fov_deg=f(fov_deg), near=f(0.1), far=f(100.0), zoom=f(1.0),
                          projection_kind=torch.tensor(0, dtype=torch.int32, device=dev),
                          aspect=f(GOLDEN_W / GOLDEN_H))
    return s.to_device_state(), gscene, cam, empty_gpu_materials(8, device=dev)


def psnr_u8(img, golden) -> float:
    """`tests/test_golden_images.py::psnr` of a frame quantised as that test
    does against a stored uint8 golden."""
    q = torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8).double()
    mse = (q - torch.as_tensor(golden, device=img.device).double()).pow(2).mean().item()
    return 99.0 if mse == 0 else 20.0 * math.log10(255.0) - 10.0 * math.log10(mse)


APP_FRAMES, APP_WARMUP = 12, 2  # phase 19: App.run frames, the first APP_WARMUP untimed
APP_SOURCE_BOXES = tuple(range(0, 255, 16))  # phase 19: the 16 falling boxes that carry a source
APP_SNAPSHOT_FRAME = 6  # phase 19: the frame whose snapshot the incremental delta starts from
APP_HOOK_REPS = 10  # phase 19: calls of the audio hook and of `present` timed alone
APP_SCRIPT = '''
def on_scene_start(scene, env):
    env["start"] = env.get("start", 0) + 1

def on_scene_update(scene, dt, env):
    env["update"] = env.get("update", 0) + 1

def on_fixed_update(scene, dt, env):
    env["fixed"] = env.get("fixed", 0) + 1
'''


def app_phase(dev, card: str, every_mod) -> tuple[dict, dict]:
    """Phase 19, the app path: the config-5 scene with audio and a script saved
    to JSON, loaded through an `AssetManager`, and driven by `App.run` with the
    asset manager, a `ScriptManager`, an `AudioEngine` and an `Input` as its
    modules; the frame callback steps the runner, presents to a `Window` and
    marks a `Profiler` frame. Returns the kernels' launch counts in the App's
    frames, and what phases 20 and 21 load again: the directory holding the scene's
    JSON and its assets (to clean up), the scene spec and the runner's
    arguments."""
    import json as _json
    import tempfile
    import wave
    from pathlib import Path

    import numpy as np

    from oxylus_tpu_torch.assets.manager import AssetManager
    from oxylus_tpu_torch.audio.engine import SAMPLE_RATE, AudioClip, AudioEngine
    from oxylus_tpu_torch.core import uuid as uuidlib
    from oxylus_tpu_torch.core.app import App
    from oxylus_tpu_torch.core.input import Input, KeyCode
    from oxylus_tpu_torch.core.window import Window, frame_to_uint8
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.ops import raster3d
    from oxylus_tpu_torch.runtime import SceneRunner
    from oxylus_tpu_torch.scene import serialize, snapshot
    from oxylus_tpu_torch.scene.scene import Scene
    from oxylus_tpu_torch.scripting.system import ScriptManager
    from oxylus_tpu_torch.utils.profiler import PROFILER, Profiler

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="ox_app_")
    root = Path(tmp.name)
    rng = np.random.default_rng(19)
    # .oxasset sidecars with both UUID words below 2^63: `Scene.set_field` stores
    # larger words through float64 and would unbind the sources (ROADMAP C)
    small_uuid = lambda: uuidlib.u64_pair_to_uuid(int(rng.integers(1, 2**62)), int(rng.integers(1, 2**62)))
    clip_uuid, script_uuid = small_uuid(), small_uuid()
    tone = (AudioClip.tone(440.0, seconds=4.0).samples[:, 0] * 32767).astype(np.int16)
    with wave.open(str(root / "tone.wav"), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SAMPLE_RATE)
        w.writeframes(tone.tobytes())
    (root / "counter.py").write_text(APP_SCRIPT)
    for name, u, kind in (("tone.wav", clip_uuid, "Audio"), ("counter.py", script_uuid, "Script")):
        AssetManager.meta_path(root / name).write_text(_json.dumps({"uuid": u, "type": kind}))
    assets = AssetManager()
    check(assets.import_asset(root / "tone.wav") == clip_uuid, "19: the clip did not import under its sidecar UUID")
    check(assets.import_asset(root / "counter.py") == script_uuid, "19: the script did not import under its UUID")

    def build():
        scene, runner_kw = build_frame5_scene(WIDTH, HEIGHT, device=dev)
        scene.entity("camera").add("AudioListenerComponent", active=True).add_tag("Networked")
        for k in APP_SOURCE_BOXES:
            scene.entity(f"box_{k}").add("AudioSourceComponent", audio_source=clip_uuid, looping=True,
                                         spatialization=True, play_on_awake=True, min_distance=1.0)
        for k in range(255):
            scene.entity(f"box_{k}").add_tag("Networked")
        scene.script_uuids.append(script_uuid)
        return scene, runner_kw

    # ---- the round trip: every index and every component array kept exactly
    built, runner_kw = build()
    t0 = time.perf_counter()
    serialize.save_to_file(built, root / "scene.json")
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = serialize.load_from_file(root / "scene.json", spec=built.spec, asset_manager=assets, device=dev)
    t_load = time.perf_counter() - t0
    # SSR is not part of the reference's RendererCVar schema, so the JSON does not carry it
    check(not loaded.renderer_config.ssr_enable, "19: the JSON carried ssr_enable")
    loaded.renderer_config.ssr_enable = built.renderer_config.ssr_enable
    check(loaded.renderer_config == built.renderer_config, "19: the renderer config changed on the round trip")
    check(np.array_equal(loaded._alive, built._alive) and np.array_equal(loaded._parent, built._parent)
          and loaded._names == built._names and loaded._tags == built._tags, "19: an entity moved on the round trip")
    n_arrays = 0
    for comp, fields in built._comp_data.items():
        check(np.array_equal(loaded._comp_mask[comp], built._comp_mask[comp]), f"19: {comp}'s mask changed")
        for k, arr in fields.items():
            got = loaded._comp_data[comp][k]
            check(got.dtype == arr.dtype and np.array_equal(got, arr), f"19: {comp}.{k} changed on the round trip")
            n_arrays += 1
    check(all(assets.get_asset(u).is_loaded for u in (clip_uuid, script_uuid)), "19: a requested asset is not loaded")
    print(f"[19] config-5 scene with {len(APP_SOURCE_BOXES)} sources and a script: saved "
          f"({(root / 'scene.json').stat().st_size} bytes) in {t_save:.3f} s, loaded in {t_load:.3f} s; "
          f"{int(built._alive.sum())} entities kept their indices, {n_arrays} component arrays equal", flush=True)

    # ---- the first frame of the scene built directly, for the bit comparison
    t0 = time.perf_counter()
    direct = SceneRunner(built, **runner_kw)
    first_direct = direct.step().clone()
    torch.cuda.synchronize()
    del direct, built
    torch.cuda.empty_cache()
    t_direct = time.perf_counter() - t0

    # ---- the App: modules, the scene host and the frame callback
    scripts, engine, inputs = ScriptManager(), AudioEngine(), Input()

    class SceneHost:
        """Compiles the scene's script through the ScriptManager and builds the
        runner on the App's AudioEngine and AssetManager, at the App's init."""

        module_dependencies = (AssetManager, ScriptManager, AudioEngine)

        def init(self, app):
            source = assets.load_asset(script_uuid)
            scripts.load_script(script_uuid, source, name="counter")
            loaded.lua_systems[script_uuid] = scripts.create_system(script_uuid, loaded)
            self.runner = SceneRunner(loaded, **runner_kw, audio_engine=app.registry.get(AudioEngine),
                                      asset_manager=app.registry.get(AssetManager))

    host = SceneHost()
    app = App().with_name("chip_smoke app").with_modules(assets, scripts, engine, inputs, host)
    window, app_prof = Window(WIDTH, HEIGHT), Profiler()
    seen = {"samples": [], "blocks": [], "marks": [], "first_equal": None, "bound": None, "loaded": None}
    snapshots = snapshot.SceneSnapshotBuilder()
    spare = Window(WIDTH, HEIGHT)  # `present` timed alone, beside the App's window

    def frame(app_, ts):
        runner = host.runner
        inputs.inject_key_down(KeyCode.SPACE)  # pressed in the first frame, then held
        image = runner.step(DT)
        n = runner.frame_index
        seen.setdefault("keys", []).append((inputs.get_key_pressed(KeyCode.SPACE), inputs.get_key_held(KeyCode.SPACE)))
        if n == 1:
            seen["first_equal"] = torch.equal(image.view(torch.int32), first_direct.view(torch.int32))
        with app_prof.zone("present"):
            window.present(image)
        block = runner.last_audio_block
        seen["samples"].append(0 if block is None else block.shape[0])
        seen["blocks"].append(block)
        if n == APP_SNAPSHOT_FRAME:
            snap6 = snapshots.take_snapshot(runner.sync_to_host())
            seen["full"] = snapshots.delta(snap6)
            snapshots.ack(snap6.sequence)
        if n == APP_FRAMES:
            srcs = runner._audio_sources
            seen["bound"] = (len(srcs), sum(s.playing for s in srcs.values()))
            seen["loaded"] = [assets.get_asset(u).is_loaded for u in (clip_uuid, script_uuid)]
            seen["audio_zone"] = (PROFILER.zones["audio_frame"].calls, PROFILER.zones["audio_frame"].mean_ms)
            # the hook and `present` alone on an idle card (after the counts above)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(APP_HOOK_REPS):
                runner._audio_frame(DT)
            seen["hook_alone"] = (time.perf_counter() - t) / APP_HOOK_REPS * 1e3
            t = time.perf_counter()
            for _ in range(APP_HOOK_REPS):
                spare.present(image)
            seen["present_alone"] = (time.perf_counter() - t) / APP_HOOK_REPS * 1e3
        inputs.reset_pressed()
        app_prof.frame_mark()
        seen["marks"].append(time.perf_counter())
        return True

    PROFILER.zones.clear()
    PROFILER.frame_count = 0
    PROFILER.frame_times.clear()
    for mod in every_mod:
        mod.LAUNCHES = 0
    decode_calls: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with capture(raster3d, "rasterize_reference", decode_calls):
        app.run(frames=APP_FRAMES, frame_callback=frame)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    app_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    runner = host.runner
    marks = seen["marks"]
    fps = (APP_FRAMES - APP_WARMUP) / (marks[-1] - marks[APP_WARMUP - 1])

    # ---- the checks
    check(seen["first_equal"] is True, "19: the loaded scene's first frame differs from the built scene's")
    check(seen["loaded"] == [True, True], f"19: assets loaded {seen['loaded']}")
    check(seen["bound"] == (len(APP_SOURCE_BOXES),) * 2, f"19: sources bound and playing {seen['bound']}")
    check(seen["keys"] == [(True, True)] + [(False, True)] * (APP_FRAMES - 1), f"19: the key's edges {seen['keys']}")
    want = round(APP_FRAMES * SAMPLE_RATE / 60)
    total = sum(seen["samples"])
    check(all(abs(s - SAMPLE_RATE / 60) <= 1 for s in seen["samples"]) and abs(total - want) <= 1,
          f"19: the mixer produced {seen['samples']} samples, {total} against {want}")
    mix = np.concatenate(seen["blocks"])
    energy = (float(np.mean(mix[:, 0] ** 2)), float(np.mean(mix[:, 1] ** 2)))
    check(all(math.isfinite(e) and e > 0 for e in energy), f"19: channel energies {energy}")
    world = runner.state.world[:, :3, 3].cpu().numpy()
    src_err = max(float(np.abs(src.position - world[i]).max()) for i, src in runner._audio_sources.items())
    cam = loaded.entity("camera").index
    lst_err = float(np.abs(engine.listeners[0].position - world[cam]).max())
    check(src_err == 0.0 and lst_err == 0.0, f"19: hook positions differ from the state by {src_err}, {lst_err}")
    env = loaded.lua_systems[script_uuid].env
    h, acc, ticks = loaded.spec.physics_interval, 0.0, 0
    for _ in range(APP_FRAMES):  # the runner's 60 Hz script accumulator, replayed
        acc += DT
        n = 0
        while acc >= h and n < loaded.spec.max_substeps:
            acc -= h
            n += 1
        ticks += n
        acc = min(acc, h)
    check(env == {"start": 1, "update": APP_FRAMES, "fixed": ticks}, f"19: script counters {env}, {ticks} ticks")
    fused, (audio_calls, audio_ms) = PROFILER.zones["frame3d_fused"], seen["audio_zone"]
    check(PROFILER.frame_count == APP_FRAMES and fused.calls == APP_FRAMES and audio_calls == APP_FRAMES
          and app_prof.frame_count == APP_FRAMES, f"19: profiler frames {PROFILER.frame_count}, zones "
          f"{ {k: z.calls for k, z in PROFILER.zones.items()} }, app frames {app_prof.frame_count}")
    check(window.presented_frames == APP_FRAMES, f"19: {window.presented_frames} frames presented")
    check(np.array_equal(window.latest_frame, frame_to_uint8(runner.last_frame).cpu().numpy()),
          "19: the presented frame is not the runner's last image")
    image = runner.last_frame
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(image).all()),
          "19: the image is not finite or of the wrong shape")
    for mod in every_mod:
        n = app_launches[mod.__name__]
        if mod.__name__.rsplit(".", 1)[-1] in ("megakernel_compact", "raster3d", "hiz", "raster_depth"):
            check(n > 0, f"19: the app path never launched {mod.__name__}")
        else:
            check(n == 0, f"19: the app path launched {mod.__name__} {n} times")
    check(not decode_calls, "19: the app path ran the decode raster")

    # ---- the snapshot: frame 6's full delta and the incremental one since, applied
    # to a fresh port scene; its snapshot's hashes equal the synced scene's
    snap = snapshots.take_snapshot(runner.sync_to_host())
    inc = snapshots.delta(snap)
    check(seen["full"].base_sequence == -1 and inc.base_sequence == 1 and len(inc.changed) > 0,
          f"19: the deltas' bases {seen['full'].base_sequence}, {inc.base_sequence}, {len(inc.changed)} changed")
    replica = Scene("replica", spec=loaded.spec, device=dev)
    emap = snapshot.apply_delta(replica, inc, snapshot.apply_delta(replica, seen["full"]))
    rep = snapshot.SceneSnapshotBuilder().take_snapshot(replica)
    check({emap[i]: e.hashes for i, e in snap.entities.items()} == {i: e.hashes for i, e in rep.entities.items()}
          and len(snap.entities) == 1 + 255, f"19: the replica's snapshot differs ({len(snap.entities)} entities)")
    hook_alone, present_alone = seen["hook_alone"], seen["present_alone"]
    seconds = time.perf_counter() - t_phase
    print(f"[19] App.run: {APP_FRAMES} frames at {WIDTH}x{HEIGHT}, {fps:.3f} frames/s untraced after "
          f"{APP_WARMUP} warm-up ({card}); run {t_run:.3f} s, direct runner and its first frame {t_direct:.3f} s; "
          f"first frame bit-equal to the built scene's; {seen['bound'][0]} of {len(APP_SOURCE_BOXES)} sources bound "
          f"and playing; {total} samples (want {want}); channel energies {energy[0]:.6g}, {energy[1]:.6g}; hook "
          f"positions equal to the state; script counters {env}; profiler {PROFILER.frame_count} frames, "
          f"frame3d_fused {fused.calls} ({fused.mean_ms:.3f} ms host a frame); audio hook {audio_ms:.3f} ms "
          f"host a frame in the loop (it waits for the frame's queued work), {hook_alone:.3f} ms alone; present "
          f"{app_prof.zones['present'].mean_ms:.3f} ms in the loop, {present_alone:.3f} ms alone; peak memory "
          f"allocated {peak / 2**30:.3f} GiB; kernel launches {app_launches}; snapshot of "
          f"{len(snap.entities)} entities, incremental delta {len(inc.changed)} changed, replica hashes equal; "
          f"phase {seconds:.1f} s", flush=True)
    handoff = {"tmp": tmp, "root": root, "spec": loaded.spec, "runner_kw": runner_kw,
               "clip_uuid": clip_uuid, "script_uuid": script_uuid}
    del runner, host, app, loaded, replica
    torch.cuda.empty_cache()
    return app_launches, handoff


ROSTER_FRAMES, ROSTER_WARMUP = 8, 2  # phase 20: App.run frames, the first ROSTER_WARMUP untimed
# the JAX package's `default_modules()` in its order: each module's type name and MODULE_NAME
ROSTER_NAMES = ("ScriptManager", "AssetManager", "AudioEngine", "Physics", "Input", "NetworkManager",
                "Renderer", "DebugRenderer")
ROSTER_VIEWS = (1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 13)  # every debug view mode but 0 (none)
ROSTER_PICKS, ROSTER_PICKS_ON_HITS = 16, 12  # seeded pixels picked, of them drawn from hit pixels
# cast_ray_bodies' distance, card against CPU, relative to max(1 m, distance): the ray's inverse
# view-projection (`torch.linalg.inv`) and the AABB einsums round differently on the two devices
ROSTER_RAY_TOL = 1e-4
ROSTER_POST_TOL = 1e-6  # apply_tonemap with aberration, vignette and grain, card against CPU
ROSTER_FX = dict(chromatic_aberration=0.5, vignette=0.4, film_grain=0.3)
NET_DEADLINE = 2.0  # s: each loopback socket loop of phase 20
ROSTER_TIMING_REPS = 10  # calls of each debug view and of the graded tonemap timed by events


def _ktx2_bytes(vk_format: int, blob: bytes, w: int, h: int) -> bytes:
    """A single-level KTX2 container around `blob` (no supercompression)."""
    import struct

    from oxylus_tpu_torch.assets.texture import _KTX2_MAGIC

    header = _KTX2_MAGIC + struct.pack("<9I", vk_format, 1, w, h, 0, 0, 1, 1, 0)
    header += struct.pack("<4I2Q", 0, 0, 0, 0, 0, 0)
    return header + struct.pack("<3Q", 104, len(blob), len(blob)) + blob


def _dds_bytes(bgra) -> bytes:
    """An uncompressed 32-bit DDS with B, G, R, A byte order (masks 0xFF0000, 0xFF00, 0xFF, 0xFF000000)."""
    import struct

    h, w = bgra.shape[:2]
    header = struct.pack("<4s7I44x", b"DDS ", 124, 0x100F, h, w, w * 4, 0, 0)
    header += struct.pack("<8I", 32, 0x41, 0, 32, 0xFF0000, 0xFF00, 0xFF, 0xFF000000)
    header += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    return header + bgra.tobytes()


def roster_textures(root, rng, small_uuid) -> dict:
    """Phase 20's assets from `rng`: a BC7 KTX2 (seeded blocks through all eight
    modes), an uncompressed RGBA8 KTX2 (`write_ktx2`) and an uncompressed BGRA DDS,
    each with a `Texture` sidecar, and a material sampling the three. Returns
    {file name: UUID}."""
    import json as _json

    import numpy as np

    from oxylus_tpu_torch.assets.manager import AssetManager
    from oxylus_tpu_torch.assets.material import Material
    from oxylus_tpu_torch.assets.texture import write_ktx2

    blocks = rng.integers(0, 256, (16 * 16, 16), dtype=np.uint8)
    for i in range(blocks.shape[0]):
        m = i % 8
        blocks[i, 0] = (blocks[i, 0] & ~np.uint8((1 << (m + 1)) - 1)) | np.uint8(1 << m)
    (root / "bricks_bc7.ktx2").write_bytes(_ktx2_bytes(146, blocks.tobytes(), 64, 64))  # BC7 sRGB
    write_ktx2(root / "normal_rgba8.ktx2", rng.integers(0, 256, (48, 80, 4), dtype=np.uint8), srgb=False)
    (root / "glow_bgra.dds").write_bytes(_dds_bytes(rng.integers(0, 256, (40, 56, 4), dtype=np.uint8)))
    uuids = {}
    for name in ("bricks_bc7.ktx2", "normal_rgba8.ktx2", "glow_bgra.dds"):
        uuids[name] = small_uuid()
        AssetManager.meta_path(root / name).write_text(_json.dumps({"uuid": uuids[name], "type": "Texture"}))
    mat = Material(albedo_color=(1.0, 0.9, 0.8, 1.0), roughness_factor=0.6, albedo_texture=uuids["bricks_bc7.ktx2"],
                   normal_texture=uuids["normal_rgba8.ktx2"], emissive_texture=uuids["glow_bgra.dds"])
    uuids["bricks.oxmat"] = small_uuid()
    (root / "bricks.oxmat").write_text("{}")
    AssetManager.meta_path(root / "bricks.oxmat").write_text(
        _json.dumps({"uuid": uuids["bricks.oxmat"], "type": "Material", "material": mat.to_json()}))
    return uuids


def body_aabbs(ps):
    """(dynamic, mins, maxs) of every active body's world AABB, as host arrays (one copy)."""
    from oxylus_tpu_torch.physics.state import BODY_DYNAMIC
    from oxylus_tpu_torch.physics.step import shape_local_halfbox
    from oxylus_tpu_torch.utils import math3d

    rot = math3d.quat_to_mat3(ps.quat)
    center = ps.pos + torch.einsum("bij,bj->bi", rot, ps.offset)
    half = torch.einsum("bij,bj->bi", torch.abs(rot), shape_local_halfbox(ps))
    dyn = (ps.body_type == BODY_DYNAMIC).to(torch.float32)[:, None]
    box = torch.cat([dyn, center - half, center + half], 1)[ps.active].cpu().numpy()
    return box[:, 0] > 0, box[:, 1:4], box[:, 4:7]


def to_cpu(x):
    """A dataclass of tensors (or a tensor) copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    return dataclasses.replace(x, **{f.name: getattr(x, f.name).cpu() for f in dataclasses.fields(x)
                                     if isinstance(getattr(x, f.name), torch.Tensor)})


def debug_view_inputs(ctx, gscene) -> dict:
    """The renderer ctx entries `apply_debug_view` reads, copied to the host."""
    from types import SimpleNamespace

    out = {"visbuffer": ctx["visbuffer"].cpu(), "vm_instance": ctx["vm_instance"].cpu(),
           "vm_meshlet": ctx["vm_meshlet"].cpu(), "gscene": SimpleNamespace(inst_material=gscene.inst_material.cpu()),
           "gbuffer": {k: v.cpu() for k, v in ctx["gbuffer"].items() if isinstance(v, torch.Tensor)},
           "ao": None if ctx.get("ao") is None else ctx["ao"].cpu()}
    if "slot_instance" in ctx:
        out["slot_instance"], out["slot_group"] = ctx["slot_instance"].cpu(), ctx["slot_group"]
    return out


def render_ctx(runner, config) -> dict:
    """The runner's renderer on its current state and carry under `config`, as
    `SceneRunner._step_render3d_fused` calls it (the carry is left as it was)."""
    return runner.renderer3d.render(
        runner.state, runner.gscene, runner.active_camera(), runner.bindings.materials, runner.bindings.atlas,
        config, prev=runner.carry, atmosphere=runner.atmosphere, enable_shadows=runner.enable_shadows,
        textured=runner._textured, texture_features=runner._texture_features, particles=runner._has_particles,
        alpha_masked=runner._has_alpha_mask, static_lights=runner._static_lights, binning_stats=runner.binning_stats,
    )


def roster_phase(dev, card: str, every_mod, handoff: dict) -> dict:
    """Phase 20, the default module roster: `App().with_modules(*default_modules())`
    loads phase 19's JSON scene through the roster's `AssetManager`, with three
    seeded textures (BC7 KTX2, RGBA8 KTX2, BGRA DDS) and a material, and drives
    the runner on the roster's `AudioEngine` and `ScriptManager` for 8 frames:
    each frame the `DebugRenderer` draws every body's AABB over the image, the
    scene is synced to the host and the `NetworkManager`'s server replicates it
    to a loopback client. Then every debug view, picking, ray casts and the
    graded tonemap are held against the CPU. Returns the launch counts in the
    App's frames."""
    import json as _json
    from types import SimpleNamespace

    import numpy as np

    from oxylus_tpu_torch.assets.manager import AssetManager, AssetType
    from oxylus_tpu_torch.assets.material import FLAG_HAS_ALBEDO, FLAG_HAS_EMISSIVE, FLAG_HAS_NORMAL, pack_materials
    from oxylus_tpu_torch.assets.texture import TextureAtlas
    from oxylus_tpu_torch.audio.engine import AudioEngine
    from oxylus_tpu_torch.core import uuid as uuidlib
    from oxylus_tpu_torch.core.app import App
    from oxylus_tpu_torch.core.modules import Physics, default_modules
    from oxylus_tpu_torch.render.debugdraw import DebugRenderer
    from oxylus_tpu_torch.render.debugviews import apply_debug_view
    from oxylus_tpu_torch.render.picking import cast_ray_bodies, pick_entity_3d, screen_ray
    from oxylus_tpu_torch.render.postfx import apply_tonemap
    from oxylus_tpu_torch.runtime import SceneRunner
    from oxylus_tpu_torch.scene import components, serialize
    from oxylus_tpu_torch.scene.scene import Scene
    from oxylus_tpu_torch.scene.snapshot import NETWORKED_COMPONENTS
    from oxylus_tpu_torch.scripting.system import ScriptManager

    t_phase = time.perf_counter()
    root, spec, runner_kw = handoff["root"], handoff["spec"], handoff["runner_kw"]
    clip_uuid, script_uuid = handoff["clip_uuid"], handoff["script_uuid"]
    rng = np.random.default_rng(20)
    small_uuid = lambda: uuidlib.u64_pair_to_uuid(int(rng.integers(1, 2**62)), int(rng.integers(1, 2**62)))

    # ---- the roster, in the JAX package's order
    roster = default_modules()
    names = [(type(m).__name__, m.MODULE_NAME) for m in roster]
    check(names == [(n, n) for n in ROSTER_NAMES], f"20: the roster is {names}")
    scripts, assets, engine, physics, inputs, net, renderer, debug = roster
    check(renderer.device == dev, f"20: the Renderer module lives on {renderer.device}")

    # ---- textures and a material through the roster's asset manager; phase 19's scene
    uuids = roster_textures(root, rng, small_uuid)
    for name, u in uuids.items():
        check(assets.import_asset(root / name) == u, f"20: {name} did not import under its sidecar UUID")
        check(assets.load_asset(u) is not None, f"20: {name} did not load")
    for name, u in (("tone.wav", clip_uuid), ("counter.py", script_uuid)):
        check(assets.import_asset(root / name) == u, f"20: {name} did not import under its UUID")
    t0 = time.perf_counter()
    scene = serialize.load_from_file(root / "scene.json", spec=spec, asset_manager=assets, device=dev)
    scene.renderer_config.ssr_enable = True  # not in the JSON schema (phase 19)
    t_load = time.perf_counter() - t0

    class SceneHost:
        """Compiles the scene's script through the roster's ScriptManager and builds
        the runner on the roster's Physics params, AudioEngine and AssetManager."""

        module_dependencies = (AssetManager, ScriptManager, AudioEngine, Physics)

        def init(self, app):
            scripts.load_script(script_uuid, assets.load_asset(script_uuid), name="counter")
            scene.lua_systems[script_uuid] = scripts.create_system(script_uuid, scene)
            self.runner = SceneRunner(scene, **runner_kw, physics_params=app.registry.get(Physics).params,
                                      audio_engine=engine, asset_manager=assets)

    host = SceneHost()
    app = App().with_name("chip_smoke roster").with_modules(*roster, host)
    check([type(m).__name__ for m in app.registry][:len(ROSTER_NAMES)] == list(ROSTER_NAMES),
          "20: the App's registry changed the roster's order")

    # ---- the loopback server and client, connected before the App runs
    server = net.create_server()
    replica = Scene("replica", spec=spec, device=dev)
    client = net.create_client("127.0.0.1", server.port, name="chip_smoke")
    client.replica_scene = replica

    def pump(cond, what):
        end = time.monotonic() + NET_DEADLINE
        while not cond():
            check(time.monotonic() < end, f"20: {what} within {NET_DEADLINE} s")
            net.update()
            time.sleep(0.0005)

    pump(lambda: client.connected and len(server.peers) == 1, "no loopback handshake")
    peer = next(iter(server.peers.values()))

    seen = {"marks": [], "queue_ms": [], "overlay_ev": [], "sync_ms": [], "net_ms": [], "delta_bytes": [],
            "overlays": []}
    box_colors = np.array([[0.0, 1.0, 0.0], [1.0, 0.8, 0.0]], np.float32)

    def frame(app_, ts):
        runner = host.runner
        if runner.frame_index == 0:  # the Renderer module synced in this frame's update (the App's deinit unloads)
            seen["tables"] = (renderer.atlas_gpu.cpu(), to_cpu(renderer.materials_gpu), dict(renderer.material_slots),
                              assets.loaded_of_type(AssetType.TEXTURE), assets.loaded_of_type(AssetType.MATERIAL))
        image = runner.step(DT)
        n = runner.frame_index
        # every body's AABB over the final image
        t = time.perf_counter()
        debug.reset()
        dynamic, lo, hi = body_aabbs(runner.ps)
        for k in range(len(lo)):
            debug.draw_aabb(lo[k], hi[k], box_colors[0 if dynamic[k] else 1])
        seen["queue_ms"].append((time.perf_counter() - t) * 1e3)
        vp = runner.active_camera().view_projection
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        overlay = debug.rasterize_over(image, vp)
        ev[1].record()
        seen["overlay_ev"].append(ev)
        if n in (1, ROSTER_FRAMES):
            c = debug._count
            seen["overlays"].append((n, image.clone(), vp.clone(), debug._a[:c].copy(), debug._b[:c].copy(),
                                     debug._color[:c].copy(), overlay))
        # the host mirror, then a snapshot delta to every peer
        t = time.perf_counter()
        runner.sync_to_host()
        t_sync = time.perf_counter()
        sent = peer.bytes_sent
        server.replicate(scene)
        seen["sync_ms"].append((t_sync - t) * 1e3)
        seen["net_ms"].append((time.perf_counter() - t) * 1e3)
        seen["delta_bytes"].append(peer.bytes_sent - sent)
        if n == ROSTER_FRAMES:
            last = peer.snapshots._sequence
            pump(lambda: peer.snapshots.last_acked == last, "the last delta was not acknowledged")
            seen["lines"] = c
            seen["bodies"] = (len(lo), int(dynamic.sum()))
            seen["replica_checked"] = replica_equal()
        seen["marks"].append(time.perf_counter())
        return True

    def replica_equal() -> int:
        """Every networked entity's component arrays in the replica equal the
        server scene's host mirror; returns the entities compared."""
        emap = client.server.entity_map
        tag = components.BY_NAME["Networked"].path
        n = 0
        for i in np.nonzero(scene._alive)[0]:
            i = int(i)
            if tag not in scene._tags[i]:
                continue
            check(i in emap, f"20: entity {i} never reached the replica")
            d = emap[i]
            for comp in NETWORKED_COMPONENTS:
                check(bool(replica._comp_mask[comp][d]) == bool(scene._comp_mask[comp][i]), f"20: {comp} mask, entity {i}")
                if scene._comp_mask[comp][i]:
                    for f, arr in scene._comp_data[comp].items():
                        if arr.dtype != object:
                            check(np.array_equal(replica._comp_data[comp][f][d], arr[i]),
                                  f"20: the replica's {comp}.{f} of entity {i} differs")
            n += 1
        return n

    for mod in every_mod:
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    app.run(frames=ROSTER_FRAMES, frame_callback=frame)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    runner = host.runner
    marks = seen["marks"]
    fps = (ROSTER_FRAMES - ROSTER_WARMUP) / (marks[-1] - marks[ROSTER_WARMUP - 1])
    check(len(marks) == ROSTER_FRAMES and not app.is_running, f"20: {len(marks)} frames ran")
    check(renderer.atlas_gpu is None and not net.servers and not net.clients, "20: the roster's deinit did not run")

    # ---- the Renderer module's tables against the host build
    atlas_card, mats_card, slots_card, textures, materials = seen["tables"]
    atlas = TextureAtlas(size=renderer.atlas_size)
    for u, tex in textures:
        atlas.add(u, tex)
    pixels, rects = atlas.build()
    want_mats = pack_materials([m for _, m in materials], rects, renderer.max_materials, device="cpu")
    check(len(rects) == 3 and torch.equal(atlas_card, torch.from_numpy(pixels)) and bool(atlas_card.any()),
          "20: the Renderer module's atlas differs from TextureAtlas.build()")
    for f in dataclasses.fields(want_mats):
        got = getattr(mats_card, f.name)
        check(got.dtype == getattr(want_mats, f.name).dtype and torch.equal(got, getattr(want_mats, f.name)),
              f"20: the Renderer module's material {f.name} differs from pack_materials")
    flags = int(mats_card.flags[slots_card[uuids["bricks.oxmat"]]])
    check(flags & FLAG_HAS_ALBEDO and flags & FLAG_HAS_NORMAL and flags & FLAG_HAS_EMISSIVE,
          f"20: the material's texture flags {flags:#x}")

    # ---- the overlay: the card's equal to rasterize_over on CPU copies of the same inputs
    for n, image, vp, a, b, col, overlay in seen["overlays"]:
        cpu = DebugRenderer()
        cpu._a[:len(a)], cpu._b[:len(a)], cpu._color[:len(a)], cpu._count = a, b, col, len(a)
        want = cpu.rasterize_over(image.cpu(), vp.cpu())
        got = overlay.cpu()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)), f"20: frame {n}'s overlay differs from the CPU's")
        drawn = int((got != image.cpu()).any(-1).sum())
        check(drawn > 0, f"20: frame {n}'s overlay drew nothing")
        seen.setdefault("drawn", []).append(drawn)
    overlay_ms = [e[0].elapsed_time(e[1]) for e in seen["overlay_ev"]]
    check(seen["replica_checked"] == 1 + 255, f"20: {seen['replica_checked']} replicated entities compared")
    check(seen["delta_bytes"][-1] < seen["delta_bytes"][0], f"20: delta bytes {seen['delta_bytes']}")
    for mod in every_mod:
        n = launches[mod.__name__]
        if mod.__name__.rsplit(".", 1)[-1] in ("megakernel_compact", "raster3d", "hiz", "raster_depth"):
            check(n > 0, f"20: the roster's frames never launched {mod.__name__}")
        else:
            check(n == 0, f"20: the roster's frames launched {mod.__name__} {n} times")

    # ---- every debug view, rendered once, against apply_debug_view on a CPU copy of its ctx
    config = runner.config
    view_ms, ctx1 = {}, None
    for m in ROSTER_VIEWS:
        ctx = render_ctx(runner, dataclasses.replace(config, debug_view=m))
        want = apply_debug_view(m, debug_view_inputs(ctx, runner.gscene))
        check(want is not None, f"20: debug view {m} gave no image")
        check(torch.equal(ctx["final"].cpu().view(torch.int32), want.view(torch.int32)),
              f"20: debug view {m} differs from apply_debug_view on the CPU")
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        for _ in range(ROSTER_TIMING_REPS):
            apply_debug_view(m, ctx)
        ev[1].record()
        torch.cuda.synchronize()
        view_ms[m] = ev[0].elapsed_time(ev[1]) / ROSTER_TIMING_REPS
        if ctx1 is None:
            ctx1 = ctx
        else:
            del ctx

    # ---- picking at seeded pixels, and rays through them into the bodies, card against CPU
    vid = ctx1["visbuffer"].cpu().numpy()
    hits = np.argwhere(vid >= 0)
    check(len(hits) >= ROSTER_PICKS_ON_HITS, "20: the frame hit too few pixels to pick from")
    prng = np.random.default_rng(2020)
    pts = [tuple(int(v) for v in hits[k][::-1]) for k in prng.choice(len(hits), ROSTER_PICKS_ON_HITS, replace=False)]
    pts += [(int(prng.integers(0, WIDTH)), int(prng.integers(0, HEIGHT))) for _ in range(ROSTER_PICKS - len(pts))]
    tab = ctx1.get("slot_instance")
    tab_h = None if tab is None else tab.cpu().numpy()
    grp = ctx1.get("slot_group", 64)
    vm_inst_h, inst_ent_h = ctx1["vm_instance"].cpu().numpy(), runner.gscene.inst_entity.cpu().numpy()
    cam = runner.active_camera()
    cam_h = SimpleNamespace(view_projection=cam.view_projection.cpu())
    ps_h = to_cpu(runner.ps)
    picked, ray_hits, ray_err = [], 0, 0.0
    for x, y in pts:
        got = int(pick_entity_3d(ctx1["visbuffer"], ctx1["vm_instance"], runner.gscene, x, y,
                                 slot_instance=tab, slot_group=grp))
        pid = int(vid[y, x])
        if pid < 0:
            want = -1
        else:
            inst = (tab_h[min(max((pid >> 8) * grp + (pid & 255), 0), len(tab_h) - 1)] if tab_h is not None
                    else vm_inst_h[pid >> 8])
            want = int(inst_ent_h[inst])
        check(got == want, f"20: pick at ({x}, {y}) gave {got}, the host decode {want}")
        picked.append(got)
        o, d = screen_ray(cam, x, y, WIDTH, HEIGHT)
        bi, dist = cast_ray_bodies(runner.ps, o, d)
        o_h, d_h = screen_ray(cam_h, x, y, WIDTH, HEIGHT)
        bi_h, dist_h = cast_ray_bodies(ps_h, o_h, d_h)
        err = abs(float(dist) - float(dist_h)) / max(1.0, float(dist_h))
        check(int(bi) == int(bi_h) and err <= ROSTER_RAY_TOL,
              f"20: the ray at ({x}, {y}) hit {int(bi)} at {float(dist)}, on the CPU {int(bi_h)} at {float(dist_h)}")
        ray_err = max(ray_err, err)
        ray_hits += int(bi) >= 0
    check(ray_hits >= 1, "20: no ray hit a body")

    # ---- the graded tonemap on the frame's HDR: aberration, vignette and grain
    kw = dict(tonemapper=config.tonemapper, exposure=config.exposure, gamma=config.gamma, frame=runner.frame_index)
    hdr = ctx1["hdr"]
    graded = apply_tonemap(hdr, **kw, **ROSTER_FX)
    post_err = float((graded.cpu() - apply_tonemap(hdr.cpu(), **kw, **ROSTER_FX)).abs().max())
    check(post_err <= ROSTER_POST_TOL, f"20: the graded tonemap differs from the CPU's by {post_err}")
    check(bool((graded != apply_tonemap(hdr, **kw)).any()), "20: the effects changed nothing")
    post_ms = {}
    for label, fx in (("graded", ROSTER_FX), ("plain", {})):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        for _ in range(ROSTER_TIMING_REPS):
            apply_tonemap(hdr, **kw, **fx)
        ev[1].record()
        torch.cuda.synchronize()
        post_ms[label] = ev[0].elapsed_time(ev[1]) / ROSTER_TIMING_REPS

    n_fields = sum(len(fields) for name, fields in runner.state.comp.items() if name in scene._comp_data)
    seconds = time.perf_counter() - t_phase
    db = seen["delta_bytes"]
    print(f"[20] roster {[n for n, _ in names]} ({card}): scene loaded from phase 19's JSON in {t_load:.3f} s; "
          f"3 textures (BC7 KTX2 64x64, RGBA8 KTX2 80x48, BGRA DDS 56x40) and a material in the Renderer module's "
          f"tables on the card, equal to TextureAtlas.build() and pack_materials", flush=True)
    print(f"[20] App.run: {ROSTER_FRAMES} frames at {WIDTH}x{HEIGHT}, {fps:.3f} frames/s untraced after "
          f"{ROSTER_WARMUP} warm-up with the roster, the AABB overlay and replication; run {t_run:.3f} s; "
          f"{seen['bodies'][0]} bodies ({seen['bodies'][1]} dynamic), {seen['lines']} lines, {seen['drawn']} pixels drawn "
          f"(frames 1 and {ROSTER_FRAMES}), each overlay equal to the CPU's; queueing "
          f"{np.mean(seen['queue_ms'][ROSTER_WARMUP:]):.3f} ms host a frame, overlay "
          f"{np.mean(overlay_ms[ROSTER_WARMUP:]):.3f} ms by events a frame (first {overlay_ms[0]:.3f}); sync_to_host "
          f"+ replicate {np.mean(seen['net_ms'][ROSTER_WARMUP:]):.3f} ms host a frame (first {seen['net_ms'][0]:.3f}), "
          f"of which sync_to_host {np.mean(seen['sync_ms'][ROSTER_WARMUP:]):.3f} ms ({n_fields} host copies, one a "
          f"component field); "
          f"bytes per delta {db} (full {db[0]}, then {db[-1]}); replica equal to the host mirror for "
          f"{seen['replica_checked']} entities; peak memory allocated {peak / 2**30:.3f} GiB; kernel launches "
          f"{launches}", flush=True)
    print(f"[20] debug views {list(ROSTER_VIEWS)} each equal to apply_debug_view on the CPU; apply_debug_view ms "
          f"by events { {m: round(v, 4) for m, v in view_ms.items()} }; picks at {ROSTER_PICKS} seeded pixels equal "
          f"to the host decode ({sum(p >= 0 for p in picked)} on an entity); rays: {ray_hits} of {ROSTER_PICKS} hit a "
          f"body, the same body as on the CPU, distance within {ray_err:.3g} relative; graded tonemap "
          f"{ROSTER_FX} within {post_err:.3g} of the CPU, {post_ms['graded']:.4f} ms by events against "
          f"{post_ms['plain']:.4f} plain; phase {seconds:.1f} s", flush=True)
    del runner, host, app, scene, replica, ctx1
    torch.cuda.empty_cache()
    return launches


EDITOR_WARMUP, EDITOR_FRAMES = 2, 10  # phase 21: play frames, the first EDITOR_WARMUP untimed
EDITOR_PICKS, EDITOR_PICKS_ON_SPRITES = 16, 10  # phase 21: seeded pixels picked on config 2, of them on sprites
EDITOR_GIZMO_TOL = 1e-6  # the card-built camera's vectors against the CPU-built camera's (sin/cos round apart)
EDITOR_UI_TOL = 1e-6  # the UI composites on the card against the CPU's (the same float32 blend: exact expected)
EDITOR_RML = """
<rml><head><style>
.menu { background-color: #223344cc; width: 30%; margin: 40; padding: 10; }
.menu p { color: yellow; }
#title { font-size: 2; text-align: center; }
button { background-color: blue; height: 28; padding: 6; }
button:hover { background-color: orange; }
button:active { background-color: red; }
</style></head>
<body><div class="menu">
  <div id="title">{{ game.title }}</div>
  <p>Frame {{ frame }}: {{ fps }} frames/s</p>
  <button id="resume" onclick="resume">Resume</button>
</div></body></rml>
"""


class DispatchLog(TorchDispatchMode):
    """Records the name and the tensor arguments' shapes of every ATen operation
    dispatched while the block runs: what a host-side call really does to its
    tensors, on any device."""

    def __init__(self):
        super().__init__()
        self.ops: list[tuple[str, list[tuple[int, ...]]]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func.overloadpacket.__name__, [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]))
        return func(*args, **(kwargs or {}))


def state_leaves(st) -> dict:
    """Every tensor of a SceneState (its component and mask dicts and particle
    pool flattened), by name."""
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif isinstance(v, dict):
            for k, sub in v.items():
                if isinstance(sub, dict):
                    out.update({f"{f.name}.{k}.{kk}": t for kk, t in sub.items()})
                else:
                    out[f"{f.name}.{k}"] = sub
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{g.name}": getattr(v, g.name) for g in dataclasses.fields(v)
                        if isinstance(getattr(v, g.name), torch.Tensor)})
    return out


def states_bit_equal(got, want) -> list[str]:
    """The names of the tensors in which two SceneStates differ, bits, dtype or shape."""
    g, w = state_leaves(got), state_leaves(want)
    if g.keys() != w.keys():
        return sorted(g.keys() ^ w.keys())
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    return [k for k in w if g[k].dtype != w[k].dtype or g[k].shape != w[k].shape
            or not torch.equal(bits(g[k]).cpu(), bits(w[k]).cpu())]


def editor_phase(dev, card: str, every_mod, handoff: dict) -> dict:
    """Phase 21, the editor and the UI: phase 19's scene as a project's start scene,
    loaded by `ProjectPanel.load_project_for_editor` on the card and held against a
    CPU load (panels, a gizmo drag, an inspector edit with undo and redo, the device
    state after each step); one edit frame, then simulate for 12 frames and stop
    (the edit scene's state and frame unchanged); `ViewportPanel.pick` on config 2's
    sprite-id image against the blend's plain version; an ImGui window and an RML
    document composited over the last play frame against the CPU, and the debug
    widgets' texts. Returns the kernels' launch counts over the edit and play
    frames and config 2's sprite-id image."""
    import numpy as np

    from oxylus_tpu_torch.assets.manager import AssetManager
    from oxylus_tpu_torch.core.config import CVarSystem
    from oxylus_tpu_torch.core.input import Input
    from oxylus_tpu_torch.core.project import Project, ProjectConfig
    from oxylus_tpu_torch.core.vfs import VFS
    from oxylus_tpu_torch.editor import EditorContext, InspectorPanel, SceneHierarchyPanel, SceneStateKind, ViewportPanel
    from oxylus_tpu_torch.editor.gizmo import host_camera
    from oxylus_tpu_torch.editor.panels import ContentPanel
    from oxylus_tpu_torch.editor.workspace import ProjectPanel
    from oxylus_tpu_torch.frame2d import build_frame2d_scene
    from oxylus_tpu_torch.network.manager import NetworkManager
    from oxylus_tpu_torch.ops import blend2d
    from oxylus_tpu_torch.render.camera import camera_from_state
    from oxylus_tpu_torch.render.renderer2d import render_2d_with_particles
    from oxylus_tpu_torch.runtime import SceneRunner
    from oxylus_tpu_torch.scene import serialize
    from oxylus_tpu_torch.ui.imgui import ImGuiRenderer
    from oxylus_tpu_torch.ui.rml import RmlDocument
    from oxylus_tpu_torch.ui.text import UIDocument
    from oxylus_tpu_torch.ui.widgets import AssetManagerViewer, NetStatsViewer, RuntimeConsole, SceneHierarchyViewer

    t_phase = time.perf_counter()
    root, spec, runner_kw = handoff["root"], handoff["spec"], handoff["runner_kw"]
    tree = lambda nodes: [dataclasses.asdict(n) for n in nodes]

    # ---- the project: phase 19's JSON as its start scene, loaded on the card and on the CPU
    Project(ProjectConfig(name="chip_smoke", start_scene="scene.json", asset_directory="."),
            directory=root).save(root / "chip_smoke.oxproj")
    assets = AssetManager()
    projects = ProjectPanel(vfs=VFS(), asset_manager=assets)
    t0 = time.perf_counter()
    proj, scene = projects.load_project_for_editor(root / "chip_smoke.oxproj", spec=spec, device=dev)
    check(scene is not None and scene.device == dev, "21: the project's start scene did not load on the card")
    scene.renderer_config.ssr_enable = True  # not in the JSON schema (phase 19)
    ctx = EditorContext(scene)
    hierarchy, inspector = SceneHierarchyPanel(ctx), InspectorPanel(ctx)
    hier_card = tree(hierarchy.build())
    t_load = time.perf_counter() - t0
    cpu_scene = serialize.load_from_file(root / "scene.json", spec=spec, device="cpu")
    cpu_scene.renderer_config.ssr_enable = True
    cpu_ctx = EditorContext(cpu_scene)
    check(hier_card == tree(SceneHierarchyPanel(cpu_ctx).build()), "21: the hierarchy differs from the CPU load's")
    content = [dataclasses.asdict(e) for e in ContentPanel(ctx, str(root), asset_manager=assets).build()]
    check(projects.build()["active"] == "chip_smoke" and not projects.visible
          and any(e["name"] == "scene.json" and e["asset_type"] == "SCENE" for e in content),
          f"21: the project panel {projects.build()}, content {[e['name'] for e in content]}")

    # ---- editing: a gizmo drag and an inspector edit, then undo, undo, redo; the
    # device state after each step bit-equal to the CPU scene's
    st, st_cpu = scene.to_device_state(), cpu_scene.to_device_state()
    cam_i = scene.entity("camera").index
    cam = camera_from_state(st, cam_i, WIDTH / HEIGHT)
    cam_cpu = camera_from_state(st_cpu, cam_i, WIDTH / HEIGHT)
    host, host_cpu = host_camera(cam), host_camera(cam_cpu)
    cam_err = max(float(np.abs(getattr(host, k) - getattr(host_cpu, k)).max())
                  for k in ("position", "forward", "right", "up"))
    check(cam_err <= EDITOR_GIZMO_TOL, f"21: the card's camera vectors differ from the CPU's by {cam_err}")
    # the box whose X handle (70 % along it, world mode: the handle scales with its distance) is nearest the
    # image centre
    vp = cam.view_projection.cpu().numpy()
    best = None
    for ent in scene.entities():
        if not ent.name.startswith("box_"):
            continue
        e = ent.index
        p = scene.get_field(e, "TransformComponent", "position").astype(np.float32)
        scale = max(float(np.linalg.norm(p - host.position)) * 0.2, 1e-3)
        clip = vp @ np.append(p + np.array([0.7 * scale, 0.0, 0.0], np.float32), 1.0)
        if clip[3] <= 0:
            continue
        x, y = (clip[0] / clip[3] + 1) / 2 * WIDTH - 0.5, (clip[1] / clip[3] + 1) / 2 * HEIGHT - 0.5
        d = math.hypot(x - WIDTH / 2, y - HEIGHT / 2)
        if 0 <= x < 0.9 * WIDTH and 0 <= y < 0.9 * HEIGHT and (best is None or d < best[0]):
            best = (d, ent.name, e, p, x, y)
    check(best is not None, "21: no box's gizmo handle is on screen")
    _, box_name, box, pos, px, py = best
    t0 = time.perf_counter()
    insp_card = tree(inspector.build(box))
    t_load += time.perf_counter() - t0
    check(insp_card == tree(InspectorPanel(cpu_ctx).build(box)), "21: the inspector differs from the CPU load's")
    ctx.select(box)
    cpu_ctx.select(box)
    viewport, cpu_viewport = ViewportPanel(ctx, WIDTH, HEIGHT), ViewportPanel(cpu_ctx, WIDTH, HEIGHT)
    cam_host = to_cpu(cam)  # the CPU side reads the same camera: the gizmo math is host NumPy in both
    axis = viewport.pick_axis(cam, px, py)
    check(axis == cpu_viewport.pick_axis(cam_host, px, py) and axis >= 0, f"21: pick_axis gave {axis}")
    p1 = (px + WIDTH / 24, py + HEIGHT / 43)  # 80 and 25 px at 1080p
    drag = viewport.drag(cam, axis, (px, py), p1)
    check(drag == cpu_viewport.drag(cam_host, axis, (px, py), p1) and "position" in drag,
          f"21: the drag's update {drag} differs from the CPU's")
    moved = float(np.abs(np.asarray(drag["position"]) - pos).max())
    steps = []
    for step in ("edit", "undo", "undo", "redo"):
        for c, insp in ((ctx, inspector), (cpu_ctx, InspectorPanel(cpu_ctx))):
            if step == "edit":
                insp.edit(box, "TransformComponent", "scale", (1.0, 1.5, 0.75))
            else:
                check(getattr(c, step)(), f"21: {step} found nothing to do")
        st, st_cpu = scene.merge_host_edits(st), cpu_scene.merge_host_edits(st_cpu)
        diff = states_bit_equal(st, st_cpu)
        check(not diff, f"21: after {step} the edit scene's device state differs from the CPU's in {diff[:6]}")
        steps.append((step, ctx.undo_count, ctx.redo_count,
                      st.comp["TransformComponent"]["scale"][box].tolist(), st.world[box, :3, 3].tolist()))
    check([s[1:3] for s in steps] == [(2, 0), (1, 1), (0, 2), (1, 1)], f"21: undo/redo counts {steps}")
    check(steps[0][3] == [1.0, 1.5, 0.75] and steps[1][3] == steps[3][3] != steps[0][3],
          f"21: the inspector edit did not reach the device state: {steps}")
    check(steps[2][4] != steps[3][4], "21: the redone drag did not move the box's world transform")

    # ---- play: one edit frame, then simulate for the play frames, then stop
    for mod in every_mod:
        mod.LAUNCHES = 0
    edit_runner = SceneRunner(scene, **runner_kw)
    before = scene.merge_host_edits(st)
    edit_runner.state = before
    edit_frame = render_ctx(edit_runner, edit_runner.config)["final"].clone()
    fields_before = {(c, k): v.copy() for c, fs in scene._comp_data.items() for k, v in fs.items()}
    runtime = ctx.on_scene_simulate()
    check(ctx.state == SceneStateKind.SIMULATE and runtime is ctx.scene and runtime is not scene and runtime.running,
          "21: simulate did not start a runtime copy")
    play = SceneRunner(runtime, **runner_kw)
    for k in range(EDITOR_WARMUP + EDITOR_FRAMES):
        image = play.step(DT)
        if k == EDITOR_WARMUP - 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    torch.cuda.synchronize()
    fps = EDITOR_FRAMES / (time.perf_counter() - t0)
    last_play = image.clone()
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(image).all())
          and image.min().item() >= 0.0 and image.max().item() <= 1.0, "21: the play frame is not finite in [0, 1]")
    runtime_moved = float((play.state.world[box] - before.world[box]).abs().max())
    check(ctx.on_scene_stop() is scene and ctx.state == SceneStateKind.EDIT and ctx.runtime_scene is None,
          "21: stop did not return the edit scene")
    check(all(np.array_equal(v, fields_before[key]) for key, v in
              (((c, k), v) for c, fs in scene._comp_data.items() for k, v in fs.items())),
          "21: play changed the edit scene's host mirror")
    after = scene.merge_host_edits(st)
    diff = states_bit_equal(after, before)
    check(not diff, f"21: after stop the edit scene's device state differs from before play in {diff[:6]}")
    edit_runner.state = after
    again = render_ctx(edit_runner, edit_runner.config)["final"]
    check(torch.equal(again.view(torch.int32), edit_frame.view(torch.int32)),
          "21: the edit scene's frame after stop differs from the edit frame")
    check(not torch.equal(last_play, edit_frame), "21: the play frames did not move anything")
    torch.cuda.synchronize()
    play_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    for mod in every_mod:
        n = play_launches[mod.__name__]
        if mod.__name__.rsplit(".", 1)[-1] in ("megakernel_compact", "raster3d", "hiz", "raster_depth"):
            check(n > 0, f"21: the edit and play frames never launched {mod.__name__}")
        else:
            check(n == 0, f"21: the edit and play frames launched {mod.__name__} {n} times")
    del edit_runner, play, runtime
    torch.cuda.empty_cache()

    # ---- the viewport's pick on config 2's sprite-id image, against the blend's plain version
    scene2, kw2 = build_frame2d_scene(WIDTH, HEIGHT, device=dev)
    runner2 = SceneRunner(scene2, **kw2)
    runner2.run(MAIN_WARMUP)
    cam2 = runner2.active_camera()
    for mod in every_mod:
        mod.LAUNCHES = 0
    color, vis = render_2d_with_particles(runner2.state, cam2, runner2.bindings, width=WIDTH, height=HEIGHT)
    torch.cuda.synchronize()
    pick_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    with plain_on_card(blend2d):
        color_p, vis_p = render_2d_with_particles(runner2.state, cam2, runner2.bindings, width=WIDTH, height=HEIGHT)
    check(torch.equal(vis, vis_p) and torch.equal(color.view(torch.int32), color_p.view(torch.int32)),
          "21: the sprite image differs from the blend's plain version")
    for mod in every_mod:
        n = pick_launches[mod.__name__]
        check(n > 0 if mod is blend2d else n == 0, f"21: the sprite-id image launched {mod.__name__} {n} times")
    vis_h = vis_p.cpu().numpy()
    hits = np.argwhere(vis_h >= 0)
    prng = np.random.default_rng(2121)
    pts = [tuple(int(v) for v in hits[k][::-1]) for k in prng.choice(len(hits), EDITOR_PICKS_ON_SPRITES, replace=False)]
    pts += [(int(prng.integers(0, WIDTH)), int(prng.integers(0, HEIGHT))) for _ in range(EDITOR_PICKS - len(pts))]
    ctx2 = EditorContext(scene2)
    viewport2 = ViewportPanel(ctx2, WIDTH, HEIGHT)
    picked = []
    for x, y in pts:
        eid = viewport2.pick(vis, x, y)
        check(eid == int(vis_h[y, x]) and ctx2.selection == ([eid] if eid >= 0 else []),
              f"21: pick at ({x}, {y}) gave {eid} and selected {ctx2.selection}, the plain blend's id {int(vis_h[y, x])}")
        picked.append(eid)
    check(sum(e >= 0 for e in picked) >= EDITOR_PICKS_ON_SPRITES - 2, f"21: picks {picked}")
    # each pick reads one pixel: two views (`select`) and one read of the 0-d result, no other operation
    with DispatchLog() as log:
        for x, y in pts:
            viewport2.pick(vis, x, y)
    reads = [shapes for name, shapes in log.ops if name == "_local_scalar_dense"]
    check(reads == [[()]] * EDITOR_PICKS and {name for name, _ in log.ops} == {"select", "_local_scalar_dense"},
          f"21: the {EDITOR_PICKS} picks dispatched {log.ops}")
    del runner2, color, color_p, vis_p
    torch.cuda.empty_cache()

    # ---- the UI over the last play frame: an ImGui window and an RML document
    inputs = Input()
    gui = ImGuiRenderer(WIDTH, HEIGHT)
    row = lambda k: 40 + 18 + 6 + k * 20 + 5  # the middle of the window's k-th widget row (ROW_H 18, PAD 6)
    events = [[("move", 120, row(1)), ("down",)], [("up",)], [("move", 120, row(2)), ("down",)], [("up",)],
              [("move", 60, row(3)), ("down",)], [("move", 300, row(3))], [("up",)]]
    values = []
    for evs in events:
        for ev in evs:
            if ev[0] == "move":
                inputs.inject_mouse_move(ev[1], ev[2])
            elif ev[0] == "down":
                inputs.inject_mouse_down(0)
            else:
                inputs.inject_mouse_up(0)
        gui.new_frame(input_module=inputs)
        gui.begin("editor", x=40, y=40, w=360, h=160)
        gui.text(f"{fps:.2f} frames/s in play")
        values.append((gui.button("Step"), gui.checkbox("Gizmo snap"), gui.slider_float("Exposure", 0.0, 4.0, 1.0)))
        gui.end()
        if len(values) < len(events):
            gui.render()
        inputs.reset_pressed()
    clicks, toggled, slider = sum(v[0] for v in values), values[-1][1], values[-1][2]
    check(clicks == 1 and toggled is True and slider == gui.get_value("editor", "Exposure") and slider != 1.0,
          f"21: the ImGui widgets gave {values}")
    rml = RmlDocument(EDITOR_RML, width=WIDTH, height=HEIGHT)
    rml.set_data(game={"title": "OXYLUS EDITOR"}, frame=EDITOR_WARMUP + EDITOR_FRAMES, fps=f"{fps:.2f}")
    fired = []
    rml.bind("resume", lambda el: fired.append(el.id))
    rml.layout()
    bx, by, bw, bh = rml.root.find("resume").box
    for down in (False, True, False):
        rml.process_mouse(bx + bw / 2, by + bh / 2, down)
    rml.layout()
    check(fired == ["resume"] and rml.root.find("resume").style["background-color"] == "orange"
          and rml.root.find("title").attrs["__lines__"] == ["OXYLUS EDITOR"],
          f"21: the RML document: fired {fired}, the button's style {rml.root.find('resume').style}, the title's "
          f"lines {rml.root.find('title').attrs['__lines__']}")
    rml_doc = UIDocument(WIDTH, HEIGHT)
    rml.emit(rml_doc)
    ui_rows = []
    for label, doc, composite in (("imgui", gui.doc, lambda f: gui.render(frame=f)),
                                  ("rml", rml_doc, rml_doc.composite_over)):
        t0 = time.perf_counter()
        records, _ = doc.build_batch()
        batch_ms = (time.perf_counter() - t0) * 1e3
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        torch.cuda.synchronize()
        ev[0].record()
        out = composite(last_play)
        ev[1].record()
        torch.cuda.synchronize()
        want = doc.composite_over(last_play.cpu())
        check(out.device == dev and tuple(out.shape) == (HEIGHT, WIDTH, 4), f"21: the {label} composite's device")
        err = float((out.cpu() - want).abs().max())
        check(err <= EDITOR_UI_TOL, f"21: the {label} composite differs from the CPU's by {err}")
        check(bool((out[..., :3] != last_play).any()), f"21: the {label} composite drew nothing")
        ui_rows.append((label, len(records), batch_ms, ev[0].elapsed_time(ev[1]), err,
                        torch.equal(out.cpu().view(torch.int32), want.view(torch.int32))))

    # ---- the debug widgets' texts
    cvars = CVarSystem()
    cvars.bind_dataclass("renderer", scene.renderer_config)
    console = RuntimeConsole(cvars)
    said = [console.execute(c) for c in ("help", "renderer.exposure 1.25", "renderer.exposure", "nope")]
    check(said[1] == said[2] == "renderer.exposure = 1.25" and scene.renderer_config.exposure == 1.25
          and said[3].startswith("unknown"), f"21: the console said {said}")
    hier_lines = SceneHierarchyViewer(scene).render_text().splitlines()
    check(len(hier_lines) == 1 + int(scene._alive.sum()), f"21: the hierarchy viewer wrote {len(hier_lines)} lines")
    asset_lines = AssetManagerViewer(assets).render_text().splitlines()
    net = NetworkManager()
    server = net.create_server()
    client = net.create_client("127.0.0.1", server.port, name="editor")
    end = time.monotonic() + NET_DEADLINE
    while not (client.connected and server.peers):
        check(time.monotonic() < end, f"21: no loopback handshake within {NET_DEADLINE} s")
        net.update()
        time.sleep(0.0005)
    net_lines = NetStatsViewer(net).render_text().splitlines()
    net.deinit()
    check(len(net_lines) == 3 and net_lines[1].startswith("server[0]  editor"), f"21: net stats {net_lines}")
    check(any(line.endswith("scene.json") for line in asset_lines[1:]), f"21: the asset viewer listed {asset_lines}")

    seconds = time.perf_counter() - t_phase
    launches = {k: play_launches[k] + pick_launches[k] for k in play_launches}
    print(f"[21] project loaded for the editor on the card and panels built in {t_load * 1e3:.1f} ms "
          f"({int(scene._alive.sum())} entities; hierarchy, the inspector of {box_name} and the content listing equal to a "
          f"CPU load); camera vectors card vs CPU within {cam_err:.3g}; gizmo axis {axis}, drag moved {box_name} by "
          f"{moved:.4f} m, equal to the CPU's; edit, undo, undo, redo: the device state bit-equal to the CPU's after "
          f"each ({card})", flush=True)
    print(f"[21] play (simulate): {EDITOR_FRAMES} frames at {WIDTH}x{HEIGHT}, {fps:.3f} frames/s by the host clock "
          f"after {EDITOR_WARMUP} warm-up, ending in a sync; {box_name} moved {runtime_moved:.4f} m in play; after stop the "
          f"edit scene's device state and frame bit-equal to before play; launches over the edit and play frames "
          f"{play_launches}", flush=True)
    print(f"[21] config 2's sprite-id image: blend launches {pick_launches[blend2d.__name__]}, equal to the plain "
          f"version; {EDITOR_PICKS} picks equal to its ids ({sum(e >= 0 for e in picked)} on sprites), "
          f"each two views and one 4-byte read ({len(log.ops)} operations dispatched in all)", flush=True)
    for label, quads, batch_ms, comp_ms, err, exact in ui_rows:
        print(f"[21] {label}: {quads} quads composited over the last play frame; build_batch {batch_ms:.3f} ms host, "
              f"composite {comp_ms:.3f} ms by events ({card}); against the CPU's within {err:.3g} "
              f"({'bit-equal' if exact else 'not bit-equal'})", flush=True)
    print(f"[21] ImGui: one click, the checkbox on, the slider at {slider:.4f}; RML: hover and click, onclick fired "
          f"{fired}; widgets: console {said[1]!r}, hierarchy {len(hier_lines)} lines, assets {len(asset_lines) - 1}, "
          f"net stats {net_lines[1]!r}; launches {launches}; phase {seconds:.1f} s", flush=True)
    del scene, cpu_scene, ctx, cpu_ctx, last_play, edit_frame, again
    torch.cuda.empty_cache()
    return launches


def tiles_phase(dev, card: str, every_mod, per_frame_64: float) -> tuple[dict, list]:
    """Phase 22, the tile raster route at 16- and 32-px tiles: kernel #4 bit-equal
    to its plain version on seeded inputs at tiles 16 and 32, and at tiles 64 and
    32 on a band (`tile_base` > 0); the config-5 frame at 1080p on the tile route
    at 32- and 16-px tiles through `SceneRunner` (launch and drop gates), one
    frame's early and late passes captured at every tile edge from a shared
    state and carry, each held against the plain version and timed; the atrium
    at `OX_TILE=32` through `bench.raster_env` (its gates, both passes held and
    timed); `build_sprite_texture_tiles` on the card against the CPU. Returns
    the kernels' launch counts over the driven frames and the timed passes'
    rows (`per_frame_64`: the tile raster's launches per frame of phase 9's
    config-5 runner, the 64-px rows' path)."""
    import os

    import numpy as np

    from oxylus_tpu_torch import bench
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.ops import blend2d, hiz, raster3d, raster_depth
    from oxylus_tpu_torch.physics import megakernel_compact as mc
    from oxylus_tpu_torch.render.camera import camera_from_state
    from oxylus_tpu_torch.render.renderer3d import RendererInstance
    from oxylus_tpu_torch.runtime import SceneRunner
    from oxylus_tpu_torch.sponza import build_sponza_scene

    t_phase = time.perf_counter()
    # ---- seeded inputs: tiles 16 and 32, and bands at 64 and 32
    seeded = [(tile, f"seeded {s}", seeded_tiles(s, dev, tile=tile)) for tile in TILES_EDGES for s in range(3)]
    seeded += [(tile, f"tie, full {f}", tie_tiles(f, dev, tile=tile)) for tile in TILES_EDGES for f in (False, True)]
    seeded += [(tile, f"masked {s}", seeded_tiles(100 + s, dev, k2=128, tile=tile)) for tile in TILES_EDGES
               for s in range(2)]
    seeded += [(tile, f"band {s}", seeded_tiles(s, dev, tile=tile, band_row=2)) for tile in (64, 32) for s in range(2)]
    for tile, name, args in seeded:
        got, want = raster3d.run_tiles(*args), raster3d.rasterize_tiles_reference(*args)
        diff = sum(int((g.view(dt) != r.view(dt)).sum())
                   for g, r, dt in zip(got, want, (torch.int32, torch.int32, torch.int16)))
        check(diff == 0, f"22: tile raster at tile {tile} on {name}: {diff} depth, vid or G-buffer bits differ")
        check(bool((want[1] >= 0).any()), f"22: tile {tile} {name} covers no pixel")
    bases = sorted({int(a[7]) for _, n, a in seeded if n.startswith("band")})
    print(f"[22] tile raster on {len(seeded)} seeded inputs (tiles {TILES_EDGES}: seeded, tie and masked-pass "
          f"inputs; bands at tiles 64 and 32, tile_base {bases}): depth, vid and G-buffer bits equal to the plain "
          f"version", flush=True)
    check(all(b > 0 for b in bases), "22: a band input with tile_base 0")

    def tile_passes(runner, spec) -> list:
        # one frame's passes at every tile edge from a shared state and a carry one frame old: a
        # frame whose late pass runs, the first of up to 10 (the boxes keep falling)
        cam_of = lambda: camera_from_state(runner.state, runner._resolve_camera_idx(), WIDTH / HEIGHT)
        for _ in range(10):
            prev = runner.carry
            runner.step()
            cam = cam_of()
            passes = {}
            for edge in (64,) + TILES_EDGES:
                renderer = RendererInstance(dataclasses.replace(spec, tile=edge))
                calls = []
                with capture(raster3d, "run_tiles", calls):
                    renderer.render(runner.state, runner.gscene, cam, runner.bindings.materials,
                                    runner.bindings.atlas, runner.config, prev=prev, atmosphere=runner.atmosphere,
                                    enable_shadows=runner.enable_shadows, static_lights=runner._static_lights)
                passes[edge] = calls
            if all(len(c) == 2 for c in passes.values()):
                break
        check(all(len(c) == 2 for c in passes.values()), f"22: no frame ran the late pass at every tile edge: "
              f"{ {e: len(c) for e, c in passes.items()} }")
        out = []
        for edge, calls in passes.items():
            for name, args in zip(("early", "late"), calls):
                r = tile_raster_vs_plain(dev, card, f"22: config 5, tile {edge}, {name} pass K2={args[0].shape[1]}",
                                         args)
                out.append({"scene": "config 5", "tile": edge, "pass": name, "k2": args[0].shape[1], "row": r})
        return out

    # ---- the config-5 frame at 1080p on the tile route at each smaller tile edge
    launches = collections.Counter()
    gated_mods = (mc, raster3d, hiz, raster_depth)
    rows = []
    per_frame = {}
    for tile in TILES_EDGES:
        t0 = time.perf_counter()
        scene, runner_kw = build_frame5_scene(WIDTH, HEIGHT, device=dev, raster={"tile": tile})
        runner = SceneRunner(scene, **runner_kw)
        spec = runner.renderer3d.spec
        t_build = time.perf_counter() - t0
        runner.run(MAIN_WARMUP)
        for mod in every_mod:
            mod.LAUNCHES = 0
        counts, frames = [], []
        t0 = time.perf_counter()
        with capture(raster3d, "run_tiles", counts, keep=lambda args: args[2]):
            for _ in range(TILES_FRAMES):
                n0 = len(counts)
                image = runner.step()
                frames.append((runner.carry["bin_overflow"], n0))
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        run = {mod.__name__: mod.LAUNCHES for mod in every_mod}
        launches.update(run)
        per_frame[tile] = run[raster3d.__name__] / TILES_FRAMES
        ends = [n0 for _, n0 in frames[1:]] + [len(counts)]
        drops = []
        for (dropped, n0), n1 in zip(frames, ends):
            pairs = sum(int(c.sum()) for c in counts[n0:n1])
            drops.append((int(dropped) / max(pairs + int(dropped), 1), int(dropped), pairs))
        worst = max(drops)
        carry = runner.carry
        print(f"[22] config-5 runner at tile {tile} (tris_per_tile {spec.tris_per_tile}, bin_groups_per_tile "
              f"{spec.bin_groups_per_tile}) built in {t_build:.2f} s; {TILES_FRAMES} frames at {WIDTH}x{HEIGHT} in "
              f"{wall:.3f} s = {TILES_FRAMES / wall:.2f} frames/s ({card}); kernel launches {run}; tile raster "
              f"launches per frame {per_frame[tile]}; binning drops worst {100 * worst[0]:.3f} % ({worst[1]} of "
              f"{worst[1] + worst[2]} pairs); expand_overflow {int(carry['expand_overflow'])}", flush=True)
        for mod in every_mod:
            n = run[mod.__name__]
            check(n > 0 if mod in gated_mods else n == 0,
                  f"22: the tile-{tile} frames launched {mod.__name__} {n} times")
        check(tuple(image.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(image).all())
              and image.min().item() >= 0.0 and image.max().item() <= 1.0, f"22: tile {tile}: image not finite or "
              "outside [0, 1]")
        check(int(carry["expand_overflow"]) == 0, f"22: tile {tile}: the meshlet expansion dropped work")
        check(worst[0] <= BIN_DROP_GATE, f"22: tile {tile}: binning dropped {100 * worst[0]:.3f} % of a frame's pairs")

        if tile == TILES_EDGES[0]:
            rows += tile_passes(runner, spec)
        del runner, scene, runner_kw
        torch.cuda.empty_cache()
    per_frame[64] = per_frame_64
    for r in rows:
        r["launches_per_frame"] = per_frame[r["tile"]]

    # ---- the atrium at OX_TILE=32, as the bench reads it
    saved = os.environ.get("OX_TILE")
    os.environ["OX_TILE"] = "32"
    try:
        raster = bench.raster_env("sponza")
    finally:
        if saved is None:
            os.environ.pop("OX_TILE")
        else:
            os.environ["OX_TILE"] = saved
    cap_mult = raster.pop("cap_mult")
    t0 = time.perf_counter()
    scene, runner_kw, _ = build_sponza_scene(WIDTH, HEIGHT, device=dev, cap_mult=cap_mult, raster=raster)
    runner = SceneRunner(scene, **runner_kw)
    spec = runner.renderer3d.spec
    print(f"[22] atrium at OX_TILE=32 (bench.raster_env: {raster}, cap_mult {cap_mult}) built in "
          f"{time.perf_counter() - t0:.2f} s: {spec}", flush=True)
    check(spec.tile == 32 and spec.raster_path == "tile" and runner._textured and runner._has_alpha_mask,
          "22: the atrium runner is not on the textured, masked tile route at 32-px tiles")
    for mod in every_mod:
        mod.LAUNCHES = 0
    tiles_k2, stats = [], []
    with capture(raster3d, "run_tiles", tiles_k2, keep=lambda args: (args[0].shape[1], args[6])):
        for i in range(MAIN_WARMUP + TILES_ATRIUM_FRAMES):
            if i == MAIN_WARMUP:
                n_warm = len(tiles_k2)  # the calls of the frames after the warm-up start here
            stats.append((runner.step(), runner.frame_stats))
        torch.cuda.synchronize()
    run = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    launches.update(run)
    gates = [{k: int(v) for k, v in st.items()} for _, st in stats]
    image = stats[-1][0]
    print(f"[22] atrium, {MAIN_WARMUP} warm-up and {TILES_ATRIUM_FRAMES} frames: kernel launches {run}; tile raster "
          f"(K2, tile) per call {tiles_k2}; overflow after the warm-up "
          f"{[(g['expand_overflow'], g['bin_overflow']) for g in gates[MAIN_WARMUP - 1:]]}", flush=True)
    for g in gates[MAIN_WARMUP - 1:]:
        check(g["expand_overflow"] == 0 and g["bin_overflow"] == 0, f"22: an atrium frame dropped work: {g}")
    check(all(t == 32 for _, t in tiles_k2) and {k for k, _ in tiles_k2} == {256, 128},
          f"22: the atrium's tile raster calls {tiles_k2}")
    for mod in every_mod:  # the atrium has no bodies: #1 stays idle
        n = run[mod.__name__]
        check(n > 0 if mod in (raster3d, hiz, raster_depth) else n == 0,
              f"22: the atrium frames launched {mod.__name__} {n} times")
    check(bool(torch.isfinite(image).all()) and image.min().item() >= 0.0
          and image.max().item() <= 1.0 + FXAA_RANGE_ROUNDING, "22: atrium image not finite or outside [0, 1]")
    calls = []
    cam = camera_from_state(runner.state, runner._resolve_camera_idx(), WIDTH / HEIGHT)
    prev = {k: v for k, v in runner.carry.items() if k != "shadow_cache"}
    with capture(raster3d, "run_tiles", calls):
        runner.renderer3d.render(
            runner.state, runner.gscene, cam, runner.bindings.materials, runner.bindings.atlas, runner.config,
            prev=prev, atmosphere=runner.atmosphere, enable_shadows=runner.enable_shadows,
            textured=runner._textured, texture_features=runner._texture_features,
            alpha_masked=runner._has_alpha_mask, static_lights=runner._static_lights)
    names = ["opaque early", "opaque late", "masked"] if len(calls) == 3 else ["opaque", "masked"]
    per_k2 = collections.Counter(k for k, _ in tiles_k2[n_warm:])  # the frames after the warm-up
    for name, args in zip(names, calls):
        r = tile_raster_vs_plain(dev, card, f"22: atrium at tile 32, {name} pass K2={args[0].shape[1]}", args)
        rows.append({"scene": "atrium", "tile": 32, "pass": name, "k2": args[0].shape[1], "row": r,
                     "launches_per_frame": per_k2[args[0].shape[1]] / TILES_ATRIUM_FRAMES})
    del runner, scene, runner_kw, prev
    torch.cuda.empty_cache()

    # ---- build_sprite_texture_tiles on the card against the CPU
    from oxylus_tpu_torch.assets.material import empty_gpu_materials

    rng = np.random.default_rng(22)
    s = TILES_SPRITES
    lo = rng.uniform(-0.3, 0.9, (s, 2))
    fields = {"uv_size": rng.uniform(0.1, 1.5, (s, 2)), "uv_offset": rng.uniform(-2.5, 1.5, (s, 2)),
              "albedo_rect": np.concatenate([lo, lo + rng.uniform(0.02, 0.6, (s, 2))], 1)}
    fields["uv_offset"][:8] = -1e-9
    fields["albedo_rect"][8, 2] = 1e12
    atlas = torch.from_numpy(rng.integers(0, 256, (512, 512, 4), dtype=np.uint8))
    on_card, on_host = (dataclasses.replace(empty_gpu_materials(s, device=where),
                                            **{k: torch.from_numpy(v.astype(np.float32)).to(where)
                                               for k, v in fields.items()})
                        for where in (dev, torch.device("cpu")))
    got = blend2d.build_sprite_texture_tiles(on_card, atlas.to(dev))
    want = blend2d.build_sprite_texture_tiles(on_host, atlas)
    check(got.device == dev and tuple(got.shape) == (s, 16, 16, 4)
          and torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)),
          "22: build_sprite_texture_tiles on the card differs from the CPU")
    print(f"[22] build_sprite_texture_tiles: {s} sprites over a 512² atlas on the card, bit-equal to the CPU; "
          f"phase 22 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches), rows


def frame_inputs(runner, also=()) -> dict:
    """One more frame of `runner` with its renderer's culled meshlets and
    lighting inputs recorded (phase 23 builds its frames' geometry from
    them); `also`: (module, function, list) captures of the same frame."""
    from oxylus_tpu_torch.render import renderer3d

    culled, pbr = [], []
    with contextlib.ExitStack() as stack:
        stack.enter_context(capture(renderer3d, "cull_meshlets", culled, keep=lambda out: out[:3], result=True))
        stack.enter_context(capture(renderer3d, "apply_pbr", pbr, keep=lambda args: args[1:4]))
        for mod, name, into in also:
            stack.enter_context(capture(mod, name, into))
        runner.step()
    torch.cuda.synchronize()
    return dict(vm=culled[0], lights=pbr[0][0], ambient=pbr[0][2], gscene=runner.gscene, world=runner.state.world,
                state=runner.state, cam_idx=runner._camera_idx, materials=runner.bindings.materials,
                atlas=runner.bindings.atlas, backface=runner.config.culling_triangle,
                mpt=runner.renderer3d.spec.meshlets_per_tile)


def shard_geometry(fi: dict, w: int, h: int) -> dict:
    """A captured frame's inputs to the sharded frames at w × h: the triangle
    setup of its culled meshlets through its camera at that aspect, the
    decode path's coefficient matrix and 64-px lists of the visible
    meshlets, and `compact_triangles`' dense groups of SHARD_SLOTS (slot
    rows, suffix-maxed near bounds, float32 material rows, lists at each
    SHARD_TILES edge)."""
    from oxylus_tpu_torch.ops import raster3d, raster_depth
    from oxylus_tpu_torch.ops.sampling import pack_material_tables
    from oxylus_tpu_torch.ops.setup3d import bin_meshlets_to_tiles, compact_triangles, setup_triangles
    from oxylus_tpu_torch.render.camera import camera_from_state

    cam = camera_from_state(fi["state"], fi["cam_idx"], w / h)
    vm_inst, vm_ml, vm_valid = fi["vm"]
    setup = setup_triangles(fi["gscene"], fi["world"], vm_inst, vm_ml, vm_valid, cam.view_projection, w, h,
                            backface_enabled=fi["backface"])
    visible = dict(setup, ml_xmax=torch.where(vm_valid, setup["ml_xmax"], -1e9),
                   ml_xmin=torch.where(vm_valid, setup["ml_xmin"], 1e9))
    mats = fi["materials"]
    dense = compact_triangles(setup, setup["tri_valid"] & vm_valid[:, None],
                              fi["gscene"].inst_material[vm_inst.long()].long(), vm_inst, group=SHARD_SLOTS,
                              width=float(w), height=float(h))
    consts = torch.cat([mats.albedo_color[:, :3], mats.metallic_factor[:, None], mats.roughness_factor[:, None],
                        mats.emissive_color], dim=1)
    return dict(
        w=w, h=h, setup=setup, coeff_mat=raster_depth.pack_coeff_matrix(setup["coeffs"], setup["tri_valid"]),
        tiles=bin_meshlets_to_tiles(visible, w, h, raster3d.TILE, fi["mpt"])[0],
        rows=raster3d.build_tile_comb(dense, consts[dense["slot_material"].long()]),
        near_eo=torch.flip(torch.cummax(torch.flip(dense["ml_near"], [0]), 0).values, [0]),
        slot_rows=pack_material_tables(mats)[dense["slot_material"].reshape(-1).long()],
        group_tiles={t: bin_meshlets_to_tiles(dense, w, h, t, fi["mpt"])[0] for t in SHARD_TILES},
        cam_pos=cam.position, inv_vp=torch.linalg.inv(cam.view_projection),
    )


def single_card_frame(fi: dict, g: dict, tile: int | None, textured: bool) -> tuple:
    """The port's single-card stage chain of a frame, over the whole image:
    the decode path (`tile` None: `rasterize_reference`, `decode_visbuffer`)
    or the group raster at `tile` with `gbuffer_from_raster` (and the albedo
    times its half-resolution texture, resized to full resolution), then
    PBR, the histogram, exposure, tonemap and FXAA. Returns (ldr, lum)."""
    from oxylus_tpu_torch.ops import raster3d, raster_groups
    from oxylus_tpu_torch.ops.decode3d import decode_visbuffer
    from oxylus_tpu_torch.ops.sampling import pack_atlas_taps, sample_material_textures
    from oxylus_tpu_torch.parallel import sharding
    from oxylus_tpu_torch.render.pbr import apply_pbr
    from oxylus_tpu_torch.render.postfx import apply_fxaa, luminance_histogram
    from oxylus_tpu_torch.utils.imgops import point_downsample, resize_linear

    w, h = g["w"], g["h"]
    if tile is None:
        _, vid = raster3d.rasterize_reference(g["coeff_mat"], g["tiles"], w, h)
        gbuf = decode_visbuffer(vid, g["setup"], fi["vm"][0], fi["gscene"], fi["world"], fi["materials"],
                                fi["atlas"], width=w, height=h)
    else:
        depth, vid, gb = raster_groups.rasterize_gbuffer_groups(g["rows"], g["group_tiles"][tile], w, h, SHARD_SLOTS,
                                                               ml_near=g["near_eo"], tile=tile)
        gbuf = raster3d.gbuffer_from_raster(gb, vid, depth, g["inv_vp"])
        if textured:
            vid_h = point_downsample(vid, 2)
            flat = torch.clamp((vid_h >> 8) * SHARD_SLOTS + (vid_h & 255), 0, g["slot_rows"].shape[0] - 1)
            tex = sample_material_textures(g["slot_rows"][flat.long()], pack_atlas_taps(fi["atlas"]),
                                           fi["atlas"].shape[0], point_downsample(gbuf["uv"].float(), 2),
                                           features=("albedo",))
            mod = torch.where((vid_h >= 0)[..., None], tex["albedo_rgb"], 1.0)
            gbuf = dict(gbuf, albedo=gbuf["albedo"] * resize_linear(mod, (h, w, 3)))
    hdr = apply_pbr(gbuf, fi["lights"], g["cam_pos"], fi["ambient"])
    ldr, lum = sharding.band_ldr(hdr, luminance_histogram(hdr, sharding.HIST_MIN_LOG2, sharding.HIST_INV_RANGE))
    return apply_fxaa(ldr), lum


def bands_in_turn(fi: dict, g: dict, tile: int | None, textured: bool, n: int) -> tuple:
    """`n` bands of the sharded frame run in turn on one card through the
    stage functions, the collectives' joins written here: the bands'
    histograms summed, each band's seam rows (FXAA's, and the textured
    albedo's half-resolution ones) taken from its neighbours, the bands
    concatenated and cropped. Returns (ldr, every band's lum)."""
    from oxylus_tpu_torch.parallel import sharding

    w, h = g["w"], g["h"]
    if tile is None:
        hdrs = [sharding.band_hdr(g["setup"], g["coeff_mat"], sharding.band_tiles(g["tiles"], w, h, n, b),
                                  fi["vm"][0], fi["gscene"], fi["world"], fi["materials"], fi["atlas"], fi["lights"],
                                  g["cam_pos"], fi["ambient"], w, h, b) for b in range(n)]
    else:
        kw = dict(tile=tile, slot_rows=g["slot_rows"], atlas=fi["atlas"]) if textured else dict(tile=tile)
        gbs = [sharding.band_gbuffer_production(g["rows"], SHARD_SLOTS,
                                                sharding.band_tiles(g["group_tiles"][tile], w, h, n, b, tile),
                                                g["near_eo"], g["inv_vp"], w, h, b, **kw) for b in range(n)]
        tex = [t for _, t in gbs]
        hdrs = [sharding.band_shade(gb, t, tex[b - 1][-1:] if t is not None and b > 0 else None,
                                    tex[b + 1][:1] if t is not None and b < n - 1 else None, fi["lights"],
                                    g["cam_pos"], fi["ambient"], h, b) for b, (gb, t) in enumerate(gbs)]
    total = hdrs[0][1].clone()
    for _, hist in hdrs[1:]:
        total += hist
    ldrs, lums = zip(*(sharding.band_ldr(hdr, total) for hdr, _ in hdrs))
    out = [sharding.band_fxaa(ldr, ldrs[b - 1][-1:] if b > 0 else None, ldrs[b + 1][:1] if b < n - 1 else None)
           for b, ldr in enumerate(ldrs)]
    return torch.cat(out)[:h], [float(x) for x in lums]


def sharding_inputs(dev) -> dict:
    """Phase 23's inputs without phases 10, 15 and 17b, to run the phase
    alone: one frame each of config 2's 2D runner (its texture tiles'
    inputs), of the atrium and of config 5 on the decode path (their culled
    meshlets and lights, and the decode's bilinear samples), after 2 warm-up
    frames each, at 1920×1080."""
    from oxylus_tpu_torch.frame2d import build_frame2d_scene
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.ops import decode3d, raster2d
    from oxylus_tpu_torch.runtime import SceneRunner
    from oxylus_tpu_torch.sponza import build_sponza_scene

    captured = {"samples": []}
    scene, kw = build_frame2d_scene(WIDTH, HEIGHT, device=dev)
    runner = SceneRunner(scene, **kw)
    runner.run(MAIN_WARMUP)
    resample = []
    with capture(raster2d, "resample_texture_tiles", resample):
        runner.step()
    captured["resample"] = resample[-1]
    scene, kw, _ = build_sponza_scene(WIDTH, HEIGHT, device=dev)
    runner = SceneRunner(scene, **kw)
    runner.run(MAIN_WARMUP)
    captured["atrium"] = frame_inputs(runner)
    scene, kw = build_frame5_scene(WIDTH, HEIGHT, device=dev)
    kw["render_spec"] = dataclasses.replace(kw["render_spec"], use_pallas=False)
    runner = SceneRunner(scene, **kw)
    runner.run(MAIN_WARMUP)
    captured["frame5"] = frame_inputs(runner, also=((decode3d, "sample_atlas_bilinear", captured["samples"]),))
    return captured


def sharding_phase(dev, card: str, every_mod, captured: dict) -> dict:
    """Phase 23, the sharded paths (`oxylus_tpu_torch/parallel/sharding.py`)
    under a real NCCL group of one rank on the card, created and destroyed
    here; every frame also run as SHARD_BANDS bands in turn through the same
    stage functions, and the C8 repair held card against CPU on the captured
    inputs of phases 10, 15 and 17b. Returns the kernels' launch counts over
    the phase."""
    import functools
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from oxylus_tpu_torch import probes
    from oxylus_tpu_torch.flagship import build_flagship
    from oxylus_tpu_torch.ops import blend2d, raster3d, raster_groups, sampling
    from oxylus_tpu_torch.parallel import sharding
    from oxylus_tpu_torch.physics import megakernel_compact as mc
    from oxylus_tpu_torch.physics.megakernel_banded import band_coverage_report, count_hub_planes
    from oxylus_tpu_torch.physics.state import PhysicsParams
    from oxylus_tpu_torch.runtime import SceneRunner
    from oxylus_tpu_torch.scene.frame import frame_step

    t_phase = time.perf_counter()
    bits = lambda t: t.view(torch.int16 if t.element_size() == 2 else torch.int32) if t.is_floating_point() else t

    # ---- C8: the texture tiles, the atlas taps and the bilinear sampler, card against CPU
    def card_vs_cpu(label, fn, *args):
        got = fn(*args)
        want = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
        n_diff = int((bits(got).cpu() != bits(want)).sum())
        check(got.device == dev and n_diff == 0, f"23: {label} on the card differs from the CPU in {n_diff} values")
        return got.numel()

    rng = np.random.default_rng(23)
    prefix, atlas2 = captured["resample"]
    seeded_atlas = torch.from_numpy(rng.integers(0, 256, (512, 512, 4), dtype=np.uint8)).to(dev)
    n = card_vs_cpu("resample_texture_tiles", blend2d.resample_texture_tiles, prefix, atlas2)
    n_seeded = card_vs_cpu("resample_texture_tiles (seeded atlas)", blend2d.resample_texture_tiles, prefix,
                           seeded_atlas)
    # the form before the repair, a CPU scalar as the divisor: CUDA multiplies by its reciprocal
    old_form = int(((seeded_atlas.float() / 255.0).cpu().view(torch.int32)
                    != (seeded_atlas.cpu().float() / 255.0).view(torch.int32)).sum())
    print(f"[23] C8: resample_texture_tiles on phase 10's last frame ({prefix.shape[0]} records; its "
          f"{atlas2.shape[0]}² atlas holds {torch.unique(atlas2).numel()} byte values: {n} values; a seeded 512² "
          f"atlas: {n_seeded} values) bit-equal to the CPU; the seeded atlas divided by the CPU scalar 255 on the "
          f"card, the form before the repair: {old_form} of {seeded_atlas.numel()} quotients differ from the CPU's",
          flush=True)
    atrium_atlas = captured["atrium"]["atlas"]
    for dtype in (torch.float32, torch.bfloat16):
        n = card_vs_cpu(f"pack_atlas_taps({dtype})", lambda a, d=dtype: sampling.pack_atlas_taps(a, d), atrium_atlas)
        print(f"[23] C8: pack_atlas_taps of the atrium's {atrium_atlas.shape[0]}² atlas as {dtype}: {n} values "
              f"bit-equal to the CPU", flush=True)
    n = sum(card_vs_cpu("sample_atlas_bilinear (phase 17b)", sampling.sample_atlas_bilinear, *args)
            for args in captured["samples"])
    shape = (HEIGHT // 2, WIDTH // 2)
    lo = rng.uniform(0, 0.8, shape + (2,))
    seeded = (atrium_atlas, torch.from_numpy(np.concatenate([lo, lo + rng.uniform(0.01, 0.2, shape + (2,))], -1)
                                             .astype(np.float32)).to(dev),
              torch.from_numpy(rng.uniform(-1.5, 2.5, shape + (2,)).astype(np.float32)).to(dev),
              torch.from_numpy(rng.integers(0, 5, shape).astype(np.int32)).to(dev))
    n_seeded = card_vs_cpu("sample_atlas_bilinear (seeded)", sampling.sample_atlas_bilinear, *seeded)
    print(f"[23] C8: sample_atlas_bilinear on phase 17b's {len(captured['samples'])} calls of a frame ({n} values) "
          f"and on {shape[0]}x{shape[1]} seeded rects, UVs and modes over the atrium's atlas ({n_seeded} values): "
          f"bit-equal to the CPU", flush=True)

    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", init_method=f"file://{tmp.name}/store", world_size=1, rank=0, device_id=dev)
    try:
        mesh = sharding.make_mesh(1, device=dev)
        group = mesh.get_group("worlds")
        print(f"[23] process group: backend {dist.get_backend(group)}, {dist.get_world_size(group)} rank on "
              f"{dev}; mesh {mesh}", flush=True)
        check(dist.get_backend(group) == "nccl", "23: the group is not on NCCL")
        for mod in every_mod:
            mod.LAUNCHES = 0

        # ---- worlds at full width: the flagship's 60-substep compact calls
        ps0 = build_flagship(FLAGSHIP_BOXES, device=dev).physics_state
        rep = band_coverage_report(ps0)
        kern = functools.partial(mc.megakernel_substeps_compact, params=PhysicsParams(), dt=DT, n_substeps=60,
                                 iterations=3, warm=0.7, geom_every=2, n_planes=count_hub_planes(ps0),
                                 band=max(128, -(-(rep["max_rank_dist"] + 96) // 128) * 128))
        single = kern(ps0)
        l0 = mc.LAUNCHES
        worlds = sharding.worlds_step(kern)(sharding.replicate_worlds(ps0, SHARD_WORLDS, mesh))
        per_call = mc.LAUNCHES - l0
        diff = [sharding_world_diff(worlds, w, single) for w in range(SHARD_WORLDS)]
        heights = worlds.pos[..., 1]
        mean_y = sharding.worlds_reduce_mean(heights, mesh)
        mean_ok = torch.equal(bits(mean_y), bits(heights.mean(0)))
        print(f"[23] worlds: {SHARD_WORLDS} worlds of the flagship ({int(ps0.active.sum())} bodies, capacity "
              f"{ps0.num_slots}) through worlds_step over the compact kernel's 60-substep call: {per_call} compact "
              f"launches in the call; fields differing from one single-world call per world {diff}; "
              f"worlds_reduce_mean of the heights equal to their mean: {mean_ok}", flush=True)
        check(per_call == SHARD_WORLDS, f"23: the worlds' call launched the compact kernel {per_call} times")
        check(all(not d for d in diff), f"23: a world differs from the single-world call: {diff}")
        check(mean_ok, "23: worlds_reduce_mean differs from the worlds' mean")

        # ---- worlds of the dryrun's 31-box scene through frame_step, against the runner
        scene = build_flagship(31, spec_kw=dict(max_entities=64, max_bodies=64, max_particles=64), device=dev)
        params = PhysicsParams(max_pairs=256, velocity_iterations=4)
        spec = scene.spec
        states = sharding.replicate_worlds(scene.to_device_state(), SHARD_WORLDS, mesh)
        bodies = sharding.replicate_worlds(scene.physics_state, SHARD_WORLDS, mesh)
        step = sharding.worlds_step(lambda st, ps: frame_step(st, ps, params, DT, spec))
        runner = SceneRunner(scene, physics_params=params, render_mode="none", device=dev)
        for _ in range(SHARD_FRAMES):
            states, bodies = step(states, bodies)
            runner.step(DT)
        diff = [sharding_world_diff(states, w, runner.state) + sharding_world_diff(bodies, w, runner.ps)
                for w in range(SHARD_WORLDS)]
        print(f"[23] worlds: {SHARD_WORLDS} worlds of the 31-box scene, {SHARD_FRAMES} frame_step frames: tensors "
              f"differing from the single-world runner per world {diff}; mean body height "
              f"{float(sharding.worlds_reduce_mean(bodies.pos[..., 1].mean(-1), mesh)):.4f} m", flush=True)
        check(all(not d for d in diff), f"23: a world's frames differ from the runner's: {diff}")
        del worlds, states, bodies, runner

        # ---- the tile-sharded raster at config 5's 1080p
        f5 = captured["frame5"]
        g = shard_geometry(f5, WIDTH, HEIGHT)
        d1, v1 = sharding.rasterize_tiles_sharded(g["coeff_mat"], g["tiles"], WIDTH, HEIGHT, mesh)
        d0, v0 = raster3d.rasterize_reference(g["coeff_mat"], g["tiles"], WIDTH, HEIGHT)
        ok = torch.equal(bits(d1), bits(d0)) and torch.equal(v1, v0)
        print(f"[23] rasterize_tiles_sharded, config 5 at {WIDTH}x{HEIGHT} ({g['tiles'].shape[0]} tiles, "
              f"{int((g['tiles'] >= 0).sum())} (tile, meshlet) pairs, coverage {float((v1 >= 0).float().mean()):.3f}):"
              f" bit-equal to rasterize_reference {ok}", flush=True)
        check(ok, "23: the tile-sharded raster differs from rasterize_reference")

        # ---- the band-sharded frames: one NCCL rank, SHARD_BANDS bands in turn, the single-card chain
        frames = [("config 5, decode path", f5, None, False), ("config 5, group raster at 64", f5, 64, False),
                  ("config 5, group raster at 32", f5, 32, False),
                  ("the atrium, group raster at 64, textured", captured["atrium"], 64, True)]
        timed = []  # the 1080p frames timed after the checks: (label, one-rank call, 4-band run, band args)
        for height in (HEIGHT, SHARD_EXACT_HEIGHT):
            for label, fi, tile, textured in frames:
                g = shard_geometry(fi, WIDTH, height)
                kw = dict(slot_rows=g["slot_rows"], atlas=fi["atlas"]) if textured else {}
                if tile is None:
                    one = functools.partial(
                        sharding.render_frame_sharded, g["setup"], g["coeff_mat"], g["tiles"], fi["vm"][0],
                        fi["gscene"], fi["world"], fi["materials"], fi["atlas"], fi["lights"], g["cam_pos"],
                        fi["ambient"], WIDTH, height, mesh)
                else:
                    one = functools.partial(
                        sharding.render_frame_sharded_production, g["rows"], SHARD_SLOTS, g["group_tiles"][tile],
                        g["near_eo"], fi["lights"], g["cam_pos"], fi["ambient"], g["inv_vp"], WIDTH, height, mesh,
                        tile=tile, **kw)
                bases, b_args = [], []
                l0 = raster_groups.LAUNCHES
                with capture(raster_groups, "run_groups", bases, keep=lambda a: a[-1]):
                    ldr1, lum1 = one()
                one_launches = raster_groups.LAUNCHES - l0
                with capture(raster_groups, "run_groups", b_args):
                    ldr4, lums4 = bands_in_turn(fi, g, tile, textured, SHARD_BANDS)
                band_bases = [a[-1] for a in b_args]
                ldr0, lum0 = single_card_frame(fi, g, tile, textured)
                torch.cuda.synchronize()
                inner = height - sharding.FXAA_REACH - (sharding.TEXTURE_REACH if textured else 0)
                same4 = torch.equal(bits(ldr4), bits(ldr1)) and lums4 == [float(lum1)] * SHARD_BANDS
                px = (bits(ldr1) != bits(ldr0)).any(-1)
                rows_diff = torch.nonzero(px.any(-1)).flatten().tolist()
                inner_ok = not bool(px[:inner].any()) and float(lum1) == float(lum0)
                n_local = sharding.band_plan(WIDTH, height, SHARD_BANDS, tile or raster3d.TILE)[0]
                print(f"[23] {label}, {WIDTH}x{height}: new_lum one rank {float(lum1):.6f}, {SHARD_BANDS} bands "
                      f"{lums4[0]:.6f}, single card {float(lum0):.6f}; {SHARD_BANDS} bands bit-equal to one rank "
                      f"{same4}; against the single-card chain {int(px.sum())} pixels differ, in rows {rows_diff} "
                      f"(rows 0-{inner - 1} must be exact); group raster launches: one rank {one_launches} at "
                      f"tile_base {bases}, bands {len(band_bases)} at {band_bases}", flush=True)
                check(same4, f"23: {label} at {height}: the {SHARD_BANDS} bands differ from the one-rank frame")
                check(inner_ok, f"23: {label} at {height}: the frame differs from the single-card chain above row "
                                f"{inner}")
                check(height != SHARD_EXACT_HEIGHT or not rows_diff,
                      f"23: {label} at {height}: rows {rows_diff} differ from the single-card chain")
                check(bool(torch.isfinite(ldr1).all()) and tuple(ldr1.shape) == (height, WIDTH, 3),
                      f"23: {label}: frame shape {tuple(ldr1.shape)} or values not finite")
                if tile is not None:
                    check(one_launches == 1 and bases == [0], f"23: {label}: one-rank launches {bases}")
                    check(band_bases == [b * n_local for b in range(SHARD_BANDS)],
                          f"23: {label}: band launches at tile_base {band_bases}, not once a band")
                if height == HEIGHT and tile in (None, 64):
                    timed.append((label, one, functools.partial(bands_in_turn, fi, g, tile, textured, SHARD_BANDS),
                                  b_args))
        # the path's launches: the checks above; the timed calls below are not counted
        launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
        timings = {}
        for label, one, bands, b_args in timed:
            reps = SHARD_REPS if b_args else 1
            timings[label] = dict(one_rank_ms=cuda_ms(one, reps), bands_ms=cuda_ms(bands, reps))
            if b_args:
                timings[label]["group_band_graph_ms"] = [
                    probes.time_us(lambda a=a: raster_groups.run_groups(*a), dev, GRAPH_REPS)[0] * 1e-3
                    for a in b_args]
        hist = torch.zeros(256, dtype=torch.int32, device=dev)
        row = torch.zeros((1, WIDTH, 3), device=dev)
        timings["nccl_all_reduce_ms"] = cuda_ms(lambda: dist.all_reduce(hist, group=group), 20)
        timings["halo_ms"] = cuda_ms(lambda: sharding.exchange_halo(row, group), 20)
        print(f"[23] timings ({card}): {json.dumps(timings)}", flush=True)
        print(f"[23] kernel launches over the phase's checks {launches}; phase 23 took "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        check(launches[mc.__name__] >= SHARD_WORLDS and launches[raster_groups.__name__] > 0,
              f"23: the phase missed the compact kernel or the group raster: {launches}")
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    return launches


def sharding_world_diff(batch, w: int, want) -> list[str]:
    """The tensors in which world `w` of a batch differs from `want`, bits."""
    from oxylus_tpu_torch.parallel import sharding

    return states_bit_equal(sharding._tree_map(lambda x: x[w], batch), want)


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
    from oxylus_tpu_torch.ops import decode3d
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
    captured = {}  # phase 23's inputs, taken from the frames of phases 10, 15 and 17b
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.load_kernel_library()
    print(f"[1] kernel library built and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    def kernel_vs_plain(label, ps, params, tol, **kw):
        """One wrapper call with the kernel and one routed to the plain version,
        on the same card state; checks every output (the per-body dropped-pair
        row `ovf` exactly) and returns the kernel's."""
        ovf = []  # the raw output's row 15, per body in slab-rank order: kernel, then plain
        with capture(mc, "run_compact", ovf, keep=lambda out: out[15].clone(), result=True):
            got, gd = mc.megakernel_substeps_compact(ps, params, DT, with_overflow=True, **kw)
        with plain_on_card(mc), capture(mc, "run_compact", ovf, keep=lambda out: out[15].clone(), result=True):
            want, wd = mc.megakernel_substeps_compact(ps, params, DT, with_overflow=True, **kw)
        err = state_err(got, want)
        rmse = (got.pos - want.pos).pow(2).sum(1).mean().sqrt().item()
        timer_err = (got.sleep_timer - want.sleep_timer).abs().max().item()
        ovf_diff = int((ovf[0] != ovf[1]).sum())
        print(f"[{label}] kernel vs plain max abs err {err}, pos RMSE {rmse:.3g} m, "
              f"sleep-timer err {timer_err:.3g} s, dropped {(gd.item(), wd.item())}, ovf rows differ on {ovf_diff} "
              f"bodies", flush=True)
        check(all(bool(torch.isfinite(getattr(got, k)).all()) for k in FIELDS), f"{label}: kernel output not finite")
        check(gd.item() == wd.item(), f"{label}: dropped counts differ")
        check(ovf_diff == 0, f"{label}: the per-body dropped-pair rows differ on {ovf_diff} bodies")
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
    from oxylus_tpu_torch import probes

    raster_rows = [tile_raster_vs_plain(dev, card, f"5: raster K2={args[0].shape[1]}", args) for args in raster_calls]
    check(len(raster_rows) >= 1, "no raster call captured")
    # Seeded inputs the captured frame may lack: slivers on sub-tile borders, single-corner covers,
    # ties, missing entries, early-outs (`seeded_tiles`), and a tile whose tile-wide early-out
    # decides an exact-depth tie (`tie_tiles`)
    seeded = [seeded_tiles(seed, dev) for seed in range(3)] + [tie_tiles(full, dev) for full in (False, True)]
    for i, args in enumerate(seeded):
        got, want = raster3d.run_tiles(*args), raster3d.rasterize_tiles_reference(*args)
        diff = sum(int((g.view(dt) != r.view(dt)).sum())
                   for g, r, dt in zip(got, want, (torch.int32, torch.int32, torch.int16)))
        check(diff == 0, f"5: tile raster on seeded input {i}: {diff} depth, vid or G-buffer bits differ")
    print(f"[5] tile raster on {len(seeded)} seeded inputs ({TILE_SEED_W}x{TILE_SEED_H}, K2 = {TILE_SEED_K2}; "
          f"two 64² ties): depth, vid and G-buffer bits equal to the plain version", flush=True)
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
    hiz_bits = sum(int((g.view(torch.int32) != r.view(torch.int32)).sum()) for g, r in zip(got, want))
    hiz_ms = cuda_ms(lambda: hiz_ops.build_hiz(depth), 50)
    hiz_graph_ms = probes.time_us(lambda: hiz_ops.build_hiz(depth), dev, GRAPH_REPS)[0] * 1e-3
    hiz_plain_ms = cuda_ms(lambda: hiz_ops.hiz_reference(depth), 10)
    n_out = sum(m.numel() for m in got[1:])
    hiz_bytes = (depth.numel() + got[0].numel() + n_out) * 4  # the depth read; the base and the levels written
    hiz_bound = bound(hiz_bytes, 3 * n_out)
    hp, wp = got[0].shape
    print(f"[5] HiZ of {tuple(depth.shape)} → {[tuple(m.shape) for m in got]}: kernel vs plain max abs err {hiz_err}, "
          f"bit mismatches {hiz_bits}; one launch of {(hp // hiz_ops.BLOCK) * (wp // hiz_ops.BLOCK)} CTAs; kernel "
          f"{hiz_ms:.4f} ms (events, back to back), {hiz_graph_ms:.4f} ms (CUDA graph of {GRAPH_REPS}), plain "
          f"{hiz_plain_ms:.3f} ms, bound {hiz_bound[0]:.4f} ms ({hiz_bound[1]}: {hiz_bytes} bytes) ({card})", flush=True)
    check(hiz_bits == 0, "HiZ kernel != plain")
    gen = torch.Generator(device=dev).manual_seed(5)
    for h_s, w_s in HIZ_SEEDED_SHAPES:
        d = torch.rand((h_s, w_s), generator=gen, device=dev)
        d[: h_s // 3, : w_s // 4] = 0.0
        got_s, want_s = hiz_ops.build_hiz(d), hiz_ops.hiz_reference(d)
        check([tuple(m.shape) for m in got_s] == [tuple(m.shape) for m in want_s]
              and all(torch.equal(g.view(torch.int32), r.view(torch.int32)) for g, r in zip(got_s, want_s)),
              f"5: HiZ kernel != plain at {h_s}x{w_s}")
    print(f"[5] HiZ on seeded depths at {HIZ_SEEDED_SHAPES}: every level equal to the plain version", flush=True)
    check(hiz_err == 0, "HiZ kernel != plain")
    # Two pyramids built at once on two streams (ROADMAP C4): each stream
    # counts into its own finished-block counter, so both are exact and every
    # counter is left zeroed
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    pair = [torch.rand(HIZ_STREAM_SHAPE, generator=gen, device=dev) for _ in range(2)]
    want_pair = [hiz_ops.hiz_reference(d) for d in pair]
    torch.cuda.synchronize()
    bad = 0
    for _ in range(HIZ_STREAM_ROUNDS):
        outs = []
        for st, d in zip(streams, pair):
            with torch.cuda.stream(st):
                outs.append(hiz_ops.build_hiz(d))
        torch.cuda.synchronize()
        bad += sum(int((g.view(torch.int32) != r.view(torch.int32)).sum())
                   for out, want in zip(outs, want_pair) for g, r in zip(out, want))
    counters = [int(c.item()) for c in hiz_ops._COUNTERS.values()]
    print(f"[5] HiZ on two streams at once ({HIZ_STREAM_ROUNDS} rounds of two {HIZ_STREAM_SHAPE} depths): "
          f"{bad} bits differ from the plain version; {len(hiz_ops._COUNTERS)} counters kept (by card and "
          f"stream), values {counters}", flush=True)
    check(bad == 0, "HiZ on two streams differs from the plain version")
    check(len(hiz_ops._COUNTERS) >= 3 and not any(counters), "HiZ counters not kept per stream, or left nonzero")

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
    def dense_vs_plain(label, ps, n_substeps, tol=TOL_8):
        """The kernel twice (the same bits) and the plain version on one card state."""
        got = mk.megakernel_substeps(ps, params, DT, n_substeps=n_substeps)
        again = mk.megakernel_substeps(ps, params, DT, n_substeps=n_substeps)
        same = all(torch.equal(getattr(got, k), getattr(again, k)) for k in FIELDS)
        with plain_on_card(mk):
            want = mk.megakernel_substeps(ps, params, DT, n_substeps=n_substeps)
        err = state_err(got, want)
        print(f"[{label}] dense kernel vs plain max abs err {err}; two kernel runs give the same bits: {same}",
              flush=True)
        check(same, f"{label}: two runs of the dense kernel differ")
        check(all(bool(torch.isfinite(getattr(got, k)).all()) for k in FIELDS), f"{label}: kernel output not finite")
        for k, e in err.items():
            check(e <= (tol[k] if isinstance(tol, dict) else tol), f"{label}: {k} error {e}")
        return err

    free_err = dense_vs_plain("6: 8 free-fall substeps", ps0, 8)
    check(max(free_err.values()) == 0.0, f"free fall is not exact: {free_err}")
    # the physics cell's dense call: the pile forms in it (first contacts at substep ~20)
    dense60_err = dense_vs_plain("6: 60 substeps from the flagship's start", ps0, 60, TOL_60)
    # one body past the kernel's cap of partners: it walks all of them in every sweep
    stats = mk.cap_stats(dev)
    stats.zero_()
    cap_err = dense_vs_plain("6: the cap scene, one substep", cap_scene(ps0), 1)
    past, most = stats.tolist()
    print(f"[6] cap scene: bodies past the cap of {mk.CAP} partners, summed over substeps: {past} in two kernel "
          f"runs; the most partners {most}", flush=True)
    check(past == 2 and most > mk.CAP, f"the cap scene put {past / 2} bodies past the cap ({most} partners)")

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
    stats.zero_()
    pile_err = dense_vs_plain("6: one substep from the phase-7 pile", pile, 1)
    pile_past, pile_most = stats.tolist()
    dense_call = lambda: mk.megakernel_substeps(pile, params, DT, n_substeps=1)
    dense_ms = cuda_ms(dense_call, 20)
    with plain_on_card(mk):
        dense_plain_ms = cuda_ms(dense_call, 2)
    iters = 10  # megakernel_substeps' default, which the runner uses
    raw = []
    with capture(mk, "run_dense", raw):
        dense_call()
    dense_kernel_ms = cuda_ms(lambda: mk._dense_cuda(*raw[0], n_substeps=1, iterations=iters), 20)
    dense_launches, dense_ops = device_kernels(dense_call, "k_dense")
    work = mk.pair_work(pile)
    n_points = work.pop("points")
    b = pile.num_slots
    dense_bound = bound(
        (mk.N_SCALARS + (mk.N_ROWS + mk.N_OUT) * b) * 4,
        b * (b - 1) // 2 * DENSE_OPS_TEST + sum(n * DENSE_OPS_PAIR[k] for k, n in work.items())
        + n_points * (DENSE_OPS_POINT + iters * DENSE_OPS_POINT_SWEEP),
    )
    print(f"[6] dense call (1 substep, B={b}, overlapping ordered pairs {work}, {n_points} touching points; "
          f"bodies past the cap {pile_past // 2}, the most partners {pile_most}): wrapper {dense_ms:.4f} ms, the "
          f"kernel's launch alone {dense_kernel_ms:.4f} ms, plain {dense_plain_ms:.2f} ms, bound "
          f"{dense_bound[0]:.6f} ms ({dense_bound[1]}), {100 * dense_bound[0] / dense_kernel_ms:.3f} % of it by the "
          f"launch; device launches per call: {dense_launches} of the dense kernel, {dense_ops} device activities "
          f"in all ({card})", flush=True)
    check(dense_launches == 1, f"a dense call launched the dense kernel {dense_launches} times")
    dense_err = max(*pile_err.values(), *frame_err.values(), *cap_err.values(), *dense60_err.values())

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
        """The kernel vs its plain version, exactly (depth bits, vid); then
        both timed. Returns the error, the time, the plain version's, the
        bytes and two operation counts: every real slot at all tile pixels of
        each live pair (the first port's count), and the covered (entry, slot,
        pixel) triples alone (the least an exact design evaluates)."""
        got = raster_depth.rasterize_depth(*args)
        want = raster_depth.rasterize_depth_reference(*args)
        torch.cuda.synchronize()
        d_bits = int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum())
        v_diff = int((got[1] != want[1]).sum())
        err = (got[0] - want[0]).abs().max().item()
        w, h = args[2], args[3]
        work = raster_depth.live_work(args[0], args[1], w, h)
        n_bytes = work["meshlet_tris"] * 5 * 3 * 4 + args[1].numel() * 4 + w * h * 8
        ops_all = work["pair_tris"] * 4096 * DEPTH_OPS_TRI_PIXEL + work["pairs"] * 4096 * DEPTH_OPS_PAIR_PIXEL
        ops_covered = work["covered"] * DEPTH_OPS_TRI_PIXEL
        bd_all, bd = bound(n_bytes, ops_all), bound(n_bytes, ops_covered)
        ms = cuda_ms(lambda: raster_depth.rasterize_depth(*args), 20)
        plain = cuda_ms(lambda: raster_depth.rasterize_depth_reference(*args), 2)
        print(f"[{label}] coeff {tuple(args[0].shape)}, lists {tuple(args[1].shape)}, {work}, grid "
              f"{raster_depth.launch_grid(args[1])}: depth bit mismatches {d_bits}, vid mismatches {v_diff}, hit "
              f"pixels {int((got[1] >= 0).sum())}; kernel {ms:.4f} ms, plain {plain:.2f} ms; bound on the covered "
              f"triples {bd[0]:.5f} ms ({bd[1]}), on every real slot at every pixel {bd_all[0]:.5f} ms ({bd_all[1]}) "
              f"({card})", flush=True)
        check(d_bits == 0 and v_diff == 0, f"{label}: depth raster kernel != plain")
        return err, ms, plain, n_bytes, ops_all, ops_covered

    # the first frame's six levels and the small-tier calls: each checked,
    # timed and bounded; the six levels summed and bounded on their total work
    depth_errs, depth_ms, depth_plain_ms, depth_bytes, depth_ops_all, depth_ops = [], 0.0, 0.0, 0, 0, 0
    for i, args in enumerate(first_calls):
        err, ms, plain, n_bytes, ops_all, ops_covered = depth_vs_plain(f"9: depth raster, first frame, level {i}", args)
        depth_errs.append(err)
        depth_ms, depth_plain_ms = depth_ms + ms, depth_plain_ms + plain
        depth_bytes, depth_ops_all, depth_ops = depth_bytes + n_bytes, depth_ops_all + ops_all, depth_ops + ops_covered
    for i, args in enumerate(small_calls):
        depth_errs.append(depth_vs_plain(f"9: depth raster, small tier, call {i}", args)[0])
    depth_err = max(depth_errs)
    depth_bound = bound(depth_bytes, depth_ops)
    depth_bound_all = bound(depth_bytes, depth_ops_all)
    print(f"[9] depth raster, the first frame's six levels: kernel {depth_ms:.4f} ms, plain {depth_plain_ms:.2f} ms, "
          f"bound on the covered triples {depth_bound[0]:.5f} ms ({depth_bound[1]}), on every real slot at every "
          f"pixel {depth_bound_all[0]:.5f} ms ({depth_bound_all[1]}) ({card})", flush=True)

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

    def blend_vs_plain(label, args, timed=True, twice=False):
        """The blend kernel and its plain version on packed inputs: colour bits
        and vid exactly equal, and `blend2d.blend_skip_model` too; the grid,
        the kernel's registers and occupancy, and the (entry, warp) pairs its
        warps evaluate (the model's count) printed. With `twice`, a second launch
        gives the same bits. With `timed`, both timed and the bound from the
        inputs (the live entries' fields and list slots, the texels they need,
        the scene depth and the outputs; the live pairs' operations)."""
        tl, cnt, fields, tex, w, h, sd = args
        got = blend2d.run_blend(*args)
        want = blend2d.blend_tiles_reference(*args)
        m_color, m_vid, evaluated = blend2d.blend_skip_model(*args)
        torch.cuda.synchronize()
        c_bits = int((got[0].view(torch.int32) != want[0].view(torch.int32)).sum())
        v_diff = int((got[1] != want[1]).sum())
        m_diff = int((m_color.view(torch.int32) != want[0].view(torch.int32)).sum() + (m_vid != want[1]).sum())
        err = (got[0] - want[0]).abs().max().item()
        pairs = int(cnt.sum())
        info = blend2d.kernel_info(sd is not None, tl.shape[1])
        msg = (f"[{label}] {w}x{h}, {tl.shape[0]} tiles, {pairs} live (tile, entry) pairs, worst tile "
               f"{int(cnt.max())} entries, {int((cnt == 0).sum())} empty tiles, depth test {sd is not None}: "
               f"colour bit mismatches {c_bits}, vid mismatches {v_diff}, skip model mismatches {m_diff}, max abs "
               f"err {err}, alpha mean {got[0][..., 3].mean().item():.5f}, pixels with an id "
               f"{int((got[1] >= 0).sum())}; grid {tl.shape[0] * blend2d.TILE // blend2d.STRIP} CTAs of "
               f"{blend2d.TILE * blend2d.STRIP} ({blend2d.TILE}x{blend2d.STRIP} pixels) after a 1-CTA tile order, "
               f"{info['regs']} registers, {info['local_bytes']} B local, {info['smem_bytes']} B shared, "
               f"{info['ctas_per_sm']} CTAs per SM; (entry, warp) pairs evaluated {evaluated} of "
               f"{pairs * blend2d.WARPS}")
        check(c_bits == 0 and v_diff == 0, f"{label}: blend kernel != plain")
        check(m_diff == 0, f"{label}: the skip model != plain")
        if twice:
            again = blend2d.run_blend(*args)
            same = torch.equal(again[0].view(torch.int32), got[0].view(torch.int32)) and torch.equal(again[1], got[1])
            msg += f"; the same bits twice {same}"
            check(same, f"{label}: two launches differ")
        if not timed:
            print(msg, flush=True)
            return got, err
        texels = blend_texels_needed(*args)
        n_bytes = (pairs * (fields.shape[2] + 1) + cnt.numel() + texels * 4) * 4 \
            + w * h * (BLEND_OUT_BYTES_PIXEL + (4 if sd is not None else 0))
        bd = bound(n_bytes, pairs * blend2d.PIX * (BLEND_OPS_ENTRY_PIXEL + int(sd is not None)))
        ms = cuda_ms(lambda: blend2d.run_blend(*args), 50)
        plain = cuda_ms(lambda: blend2d.blend_tiles_reference(*args), 3)
        print(f"{msg}; {texels} texels needed; kernel {ms:.4f} ms, plain {plain:.2f} ms, bound {bd[0]:.5f} ms "
              f"({bd[1]}) ({card})", flush=True)
        return got, err, ms, plain, bd

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
    per_frame, blend_args, on_screen, prefixes, resample_args = [], [], [], [], []
    t0 = time.perf_counter()
    with capture(blend2d, "run_blend", blend_args), \
            capture(raster2d, "sprite_sort_order", on_screen, keep=lambda args: args[4].sum()), \
            capture(raster2d, "resample_texture_tiles", prefixes, keep=lambda args: args[0]), \
            capture(raster2d, "resample_texture_tiles", resample_args):
        for _ in range(MAIN_FRAMES):
            blend_args.clear()
            on_screen.clear()
            prefixes.clear()
            resample_args.clear()
            b0 = blend2d.LAUNCHES
            image = runner.step()
            per_frame.append(blend2d.LAUNCHES - b0)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    captured["resample"] = resample_args[0]  # phase 23's C8 check: the last frame's texture tiles
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
    seeded = seeded_blend_inputs(10, WIDTH, HEIGHT, blend_args[0][0].shape[1], blend2d.MAX_VISIBLE, False, dev)
    got, err = blend_vs_plain("10: blend, seeded sprites", seeded, timed=False)
    err10 = max(err10, err)
    check(bool((got[1] >= 0).any()), "seeded 2D blend: no pixel took an id")
    # crowded: a full K = 64 tile, tints down to -0.5 (negative colours and alphas)
    crowded = seeded_blend_inputs(12, WIDTH, HEIGHT, blend_args[0][0].shape[1], blend2d.MAX_VISIBLE, False, dev,
                                  tint_lo=-0.5)
    err10 = max(err10, blend_vs_plain("10: blend, crowded sprites, negative tints", crowded, timed=False,
                                      twice=True)[1])

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
    seeded = seeded_blend_inputs(11, lw, lh, tl.shape[1], 256, True, dev)
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
        """Two wrapper calls with the banded kernel (the same bits) and one
        routed to its plain version, on the same card state; checks every
        output, returns the kernel's."""
        got = mb.megakernel_substeps_banded(ps, params, DT, **kw)
        again = mb.megakernel_substeps_banded(ps, params, DT, **kw)
        same = all(torch.equal(getattr(got, k), getattr(again, k)) for k in FIELDS + ("asleep", "sleep_timer"))
        with plain_on_card(mb):
            want = mb.megakernel_substeps_banded(ps, params, DT, **kw)
        err = state_err(got, want)
        timer_err = (got.sleep_timer - want.sleep_timer).abs().max().item()
        flips = int((got.asleep != want.asleep).sum())
        print(f"[{label}] banded kernel vs plain max abs err {err} (bound {tol}), sleep-timer err {timer_err:.3g} s, "
              f"sleep-flag mismatches {flips}; two kernel runs give the same bits: {same}", flush=True)
        check(same, f"{label}: two runs of the banded kernel differ")
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
    # both kernels past one warp per body (their grid holds ~1056 warps), where a warp takes
    # bodies in turn: a pile of 2000 boxes at capacity 2048, in contact after 60 substeps
    wide = build_flagship(WIDE_BOXES, spec_kw=dict(max_entities=4096, max_bodies=WIDE_CAPACITY),
                          device=dev).physics_state
    wide = mb.megakernel_substeps_banded(wide, params, DT, n_substeps=60, **bench_kw)
    banded_err = max(banded_err, banded_vs_plain(f"12a: capacity {WIDE_CAPACITY}, bench config, 4 substeps", wide,
                                                 params, TOL_60, n_substeps=4, **bench_kw)[1])
    wide_err = dense_vs_plain(f"12a: capacity {WIDE_CAPACITY}, dense kernel, one substep", wide, 1)
    dense_err = max(dense_err, *wide_err.values())

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
    raw = []
    with capture(mb, "run_banded", raw):
        call60()
    banded_kernel_ms = cuda_ms(lambda: mb._banded_cuda(*raw[0], n_substeps=60, sleep=False, **bench_kw), 10)
    banded_launches, banded_ops = device_kernels(call60, "k_banded")
    check(banded_launches == 1, f"a banded call launched the banded kernel {banded_launches} times "
                                f"({banded_ops} device activities traced)")
    work = mb.pair_work(pile, geom_every=2)
    b = pile.num_slots
    n_rebuild, sweeps = 30, 60 * (bench_kw["iterations"] + 1)
    banded_bound = bound(
        (mc.N_SCALARS + (mc.N_ROWS + mb.N_OUT) * b) * 4,
        n_rebuild * (work["candidates"] * DENSE_OPS_TEST + sum(work[k] * n for k, n in DENSE_OPS_PAIR.items())
                     + work["points"] * DENSE_OPS_POINT) + work["points"] * sweeps * DENSE_OPS_POINT_SWEEP,
    )
    print(f"[12b] banded 60-substep call from the cell's pile (B={b}, {work}): wrapper {banded_ms:.3f} ms, the "
          f"kernel's launch alone {banded_kernel_ms:.3f} ms, plain {banded_plain_ms:.1f} ms, bound "
          f"{banded_bound[0]:.6f} ms ({banded_bound[1]}), {100 * banded_bound[0] / banded_kernel_ms:.3f} % of it by "
          f"the launch; device launches per call: {banded_launches} of the banded kernel, {banded_ops} device "
          f"activities in all ({card})", flush=True)

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

    def group_vs_plain(label, args, timed=True, twice=False):
        """The group raster kernel and its plain version on the same inputs:
        depth bits, vid and G-buffer bits exactly equal; the grid, the
        kernel's registers and occupancy, and the slot-pixels its warps
        evaluate (`raster_groups.group_work`) printed. With `twice`, a second
        launch gives the same bits. With `timed`, both
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
        work = raster_groups.group_work(rows, tl, walked, n_slots, tile, w, base)
        info = raster_groups.kernel_info(tile, tl.shape[1])
        msg = (f"[{label}] {w}x{h}, tile {tile}, R {n_slots}, tile_base {base}, {tl.shape[0]} tiles, "
               f"{int(cnt.sum())} (tile, group) pairs listed, {int(walked.sum())} walked ({slot_pairs} live slot "
               f"walks, {slot_pairs * tile * tile} slot-pixels), worst list {int(cnt.max())}, "
               f"{int((cnt == 0).sum())} empty tiles, {n_span} span pixels, {n_cov} covered (slot, pixel) pairs, "
               f"{n_hit} hit pixels: depth bit mismatches {d_bits}, vid mismatches {v_diff}, gb bit mismatches "
               f"{g_bits}; grid {work['ctas']} CTAs of 256 in clusters of {work['cluster']}, {info['regs']} "
               f"registers, {info['smem_bytes']} B shared, {info['ctas_per_sm']} CTAs per SM, "
               f"{info['clusters_resident']} clusters resident; slot-pixels evaluated {work['evaluated']} "
               f"(every slot at every pixel: {work['first_port']})")
        check(d_bits == 0 and v_diff == 0 and g_bits == 0, f"{label}: group raster kernel != plain")
        if twice:
            again = raster_groups.run_groups(*args)
            same = all(torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                                   b.view(torch.int16 if b.element_size() == 2 else torch.int32))
                       for a, b in zip(again, got))
            msg += f"; the same bits twice {same}"
            check(same, f"{label}: two launches differ")
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
    # crowded: no near bound, so every tile walks its whole list, the fullest ones at their cap of 64
    _, walked, cnt = group_vs_plain("13: group raster, crowded, no early-out",
                                    seeded_group_inputs(17, 64, 128, False, None, dev), timed=False, twice=True)
    check(bool((walked == cnt).all()) and int(walked.max()) == 64,
          "crowded group case: a walk ended early, or no list is full")

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

    # ---- 15. config 4: the Sponza-class atrium --------------------------------------
    import PIL

    from oxylus_tpu_torch.sponza import build_sponza_scene

    del runner, scene
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    scene, runner_kw, info = build_sponza_scene(WIDTH, HEIGHT, device=dev)
    runner = SceneRunner(scene, **runner_kw)
    gs = runner.gscene
    masked_inst = torch.isin(gs.inst_material, torch.tensor(info["masked_materials"], device=dev)) & gs.inst_valid
    lod0 = gs.mesh_lod_meshlet_count[gs.inst_mesh.long(), 0]
    print(f"[15] PIL {PIL.__version__}; atrium {info['summary']}; host seconds: generate "
          f"{info['seconds']['generate']:.2f}, load {info['seconds']['load']:.2f}, bake "
          f"{info['seconds']['bake']:.2f}, prepass {info['seconds']['prepass']:.2f}; prepass {info['prepass']}; "
          f"atlas {info['atlas']}²; masked materials {info['masked_materials']} on {int(masked_inst.sum())} "
          f"instances, {int(lod0[masked_inst].sum())} masked meshlets at LOD 0; runner built in "
          f"{time.perf_counter() - t0:.2f} s; texturing {runner._texture_features}, masked pass "
          f"{runner._has_alpha_mask}; {runner.renderer3d.spec}", flush=True)
    check(runner._textured and runner._has_alpha_mask and int(masked_inst.sum()) > 0,
          "the atrium runner leaves texturing or the masked pass out")
    for mod in every_mod:
        mod.LAUNCHES = 0
    tiles_k2, frame_marks, stats = [], [], []
    with capture(raster3d, "run_tiles", tiles_k2, keep=lambda args: args[0].shape[1]):
        for i in range(MAIN_WARMUP + SPONZA_FRAMES):
            frame_marks.append((len(tiles_k2), hiz_ops.LAUNCHES))
            image = runner.step()
            stats.append(runner.frame_stats)
        torch.cuda.synchronize()
    frame_marks.append((len(tiles_k2), hiz_ops.LAUNCHES))
    path_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    per_frame = [(tiles_k2[a[0]:b[0]], b[1] - a[1]) for a, b in zip(frame_marks, frame_marks[1:])]
    gates = [{k: int(v) for k, v in st.items()} for st in stats]
    print(f"[15] {MAIN_WARMUP} warm-up and {SPONZA_FRAMES} frames: kernel launches {path_launches}; per frame "
          f"(tile raster K2s, HiZ launches) {per_frame}; overflow after the warm-up "
          f"{[(g['expand_overflow'], g['bin_overflow']) for g in gates[MAIN_WARMUP - 1:]]}", flush=True)
    for g in gates[MAIN_WARMUP - 1:]:
        check(g["expand_overflow"] == 0 and g["bin_overflow"] == 0, f"sponza frame dropped work: {g}")
    for ks, n_hiz in per_frame[MAIN_WARMUP:]:
        check(len(ks) >= 2 and ks[0] == 256 and ks[-1] == 128 and n_hiz >= 1, f"a sponza frame missed the opaque "
              f"or masked raster pass or HiZ: K2s {ks}, HiZ launches {n_hiz}")
    # the static atrium's shadow pages render while its residency fills (the
    # warm-up) and stay cached after: the depth raster is counted over all
    # frames here and launched again below by the frame without a page cache
    check(path_launches[raster_depth.__name__] > 0, "the sponza frames never launched the depth raster")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3), f"sponza image shape {tuple(image.shape)}")
    print(f"[15] image range [{image.min().item()}, {image.max().item()}], mean {image.mean().item():.5f}", flush=True)
    check(bool(torch.isfinite(image).all()) and image.min().item() >= 0.0
          and image.max().item() <= 1.0 + FXAA_RANGE_ROUNDING, "sponza image not finite or outside [0, 1]")
    # one frame with the kernels and with the plain versions, from a shared
    # state and carry, the shadow page cache left out so every level renders
    prev = {k: v for k, v in runner.carry.items() if k != "shadow_cache"}
    cam = camera_from_state(runner.state, runner._resolve_camera_idx(), WIDTH / HEIGHT)
    sponza_calls = []
    render = lambda: runner.renderer3d.render(
        runner.state, runner.gscene, cam, runner.bindings.materials, runner.bindings.atlas, runner.config,
        prev=prev, atmosphere=runner.atmosphere, enable_shadows=runner.enable_shadows, textured=runner._textured,
        texture_features=runner._texture_features, alpha_masked=runner._has_alpha_mask,
        static_lights=runner._static_lights,
    )
    d0 = raster_depth.LAUNCHES
    sponza_depth, sponza_hiz = [], []
    with capture(raster3d, "run_tiles", sponza_calls), capture(raster_depth, "rasterize_depth", sponza_depth), \
            capture(hiz_ops, "build_hiz", sponza_hiz):
        ctx_k = render()
    rendered = raster_depth.LAUNCHES - d0
    with plain_on_card(raster3d, hiz_ops, raster_depth):
        ctx_p = render()
    img_k, img_p = ctx_k["final"], ctx_p["final"]
    print(f"[15] one sponza frame rendered with the kernels ({rendered} depth raster launches, tile raster K2s "
          f"{[a[0].shape[1] for a in sponza_calls]}) and with the plain versions from a shared state and carry: "
          f"PSNR {psnr(img_k, img_p)} dB, identical {bool(torch.equal(img_k, img_p))}", flush=True)
    check(rendered > 0, "the sponza comparison frame rendered no shadow level")
    check(torch.equal(img_k, img_p), "sponza: kernel and plain frames differ")
    # the frame's tile raster passes (opaque early, late, masked) held exactly
    # and timed; then seeded masked-pass inputs (K2 128)
    names = ["opaque early", "opaque late", "masked"] if len(sponza_calls) == 3 else ["opaque", "masked"]
    sponza_rows = [tile_raster_vs_plain(dev, card, f"15: sponza {n} pass K2={a[0].shape[1]}", a)
                   for n, a in zip(names, sponza_calls)]
    check(sponza_calls[-1][0].shape[1] == 128, "the sponza masked pass is not K2 128")
    # each pass's launches per gated frame: a frame's first tile raster call is
    # its opaque (early) pass, its last the masked pass, any between the late pass
    gated = per_frame[MAIN_WARMUP:]
    pass_launches = {"opaque": sum(min(len(ks), 1) for ks, _ in gated), "masked": sum(len(ks) >= 2 for ks, _ in gated),
                     "opaque late": sum(max(len(ks) - 2, 0) for ks, _ in gated)}
    pass_launches["opaque early"] = pass_launches["opaque"]
    sp_hiz_per_frame = sum(n for _, n in gated) / len(gated)
    print(f"[15] launches per frame over the {len(gated)} frames after the warm-up: tile raster "
          f"{ {k: v / len(gated) for k, v in pass_launches.items() if k != 'opaque early'} }, HiZ "
          f"{sp_hiz_per_frame}", flush=True)
    for seed in range(3):
        args = seeded_tiles(100 + seed, dev, k2=128)
        got, want = raster3d.run_tiles(*args), raster3d.rasterize_tiles_reference(*args)
        diff = sum(int((g.view(dt) != r.view(dt)).sum())
                   for g, r, dt in zip(got, want, (torch.int32, torch.int32, torch.int16)))
        check(diff == 0, f"15: tile raster on seeded masked-pass input {seed}: {diff} bits differ")
    print(f"[15] tile raster on 3 seeded masked-pass inputs (K2 = 128): depth, vid and G-buffer bits equal to the "
          f"plain version", flush=True)
    # the depth raster's levels and HiZ at the atrium's shapes, held exactly and timed with their bounds
    sp_depth = [depth_vs_plain(f"15: sponza depth raster, level {i}", args) for i, args in enumerate(sponza_depth)]
    sp_depth_bound = bound(sum(r[3] for r in sp_depth), sum(r[5] for r in sp_depth))
    print(f"[15] sponza depth raster, the frame's {len(sp_depth)} levels: kernel {sum(r[1] for r in sp_depth):.4f} "
          f"ms, plain {sum(r[2] for r in sp_depth):.2f} ms, bound on the covered triples {sp_depth_bound[0]:.5f} ms "
          f"({sp_depth_bound[1]}) ({card})", flush=True)
    sp_d = sponza_hiz[0][0]
    got, want = hiz_ops.build_hiz(sp_d), hiz_ops.hiz_reference(sp_d)
    sp_hiz_bits = sum(int((g.view(torch.int32) != r.view(torch.int32)).sum()) for g, r in zip(got, want))
    sp_hiz_err = max(float((g - r).abs().max()) for g, r in zip(got, want))
    sp_hiz_ms = probes.time_us(lambda: hiz_ops.build_hiz(sp_d), dev, GRAPH_REPS)[0] * 1e-3
    sp_hiz_plain = cuda_ms(lambda: hiz_ops.hiz_reference(sp_d), 10)
    sp_hiz_bound = bound((sp_d.numel() + got[0].numel() + sum(m.numel() for m in got[1:])) * 4,
                         3 * sum(m.numel() for m in got[1:]))
    print(f"[15] sponza HiZ of {tuple(sp_d.shape)}: bit mismatches {sp_hiz_bits}, max abs err {sp_hiz_err}; kernel {sp_hiz_ms:.4f} ms (CUDA "
          f"graph of {GRAPH_REPS}), plain {sp_hiz_plain:.3f} ms, bound {sp_hiz_bound[0]:.4f} ms ({sp_hiz_bound[1]}) "
          f"({card})", flush=True)
    check(sp_hiz_bits == 0, "sponza HiZ kernel != plain")
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run(SPONZA_WINDOW)
        rates.append(SPONZA_WINDOW / (time.perf_counter() - t0))
    print(f"[15] sponza frames/s over 3 windows of {SPONZA_WINDOW}: {sorted(rates)} ({card})", flush=True)

    # ---- 18. config 4 on the group raster route, textured and masked ---------------
    tile_runner = runner
    del ctx_k, ctx_p
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # phase 15's atrium (static: its runner left the scene as built)
    runner_kw = dict(runner_kw, render_spec=dataclasses.replace(runner_kw["render_spec"], raster_path="group"))
    runner = SceneRunner(scene, **runner_kw)
    gspec = runner.renderer3d.spec
    print(f"[18] atrium on the group raster route built in {time.perf_counter() - t0:.2f} s: raster_group "
          f"{gspec.raster_group}, tile {gspec.tile}, meshlets_per_tile {gspec.meshlets_per_tile}, compact_raster "
          f"{gspec.compact_raster}; texturing {runner._texture_features}, masked pass {runner._has_alpha_mask}",
          flush=True)
    check(runner._textured and runner._has_alpha_mask and gspec.raster_path == "group",
          "the atrium's group-route runner leaves texturing or the masked pass out")
    for mod in every_mod:
        mod.LAUNCHES = 0
    g18, stats = [], []
    t0 = time.perf_counter()
    for _ in range(GROUP_ATRIUM_FRAMES):
        g0 = raster_groups.LAUNCHES
        image = runner.step()
        stats.append(runner.frame_stats)
        g18.append(raster_groups.LAUNCHES - g0)
    torch.cuda.synchronize()
    wall18 = time.perf_counter() - t0
    atrium_group_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    gates = [{k: int(v) for k, v in st.items()} for st in stats]
    print(f"[18] {GROUP_ATRIUM_FRAMES} frames in {wall18:.3f} s ({card}): kernel launches {atrium_group_launches}; "
          f"group raster launches per frame {g18}; overflow per frame "
          f"{[(g['expand_overflow'], g['bin_overflow']) for g in gates]}; image range [{image.min().item()}, "
          f"{image.max().item()}], mean {image.mean().item():.5f}", flush=True)
    check(all(n >= 2 for n in g18), f"a group-route atrium frame missed its opaque or masked pass: {g18}")
    check(atrium_group_launches[raster3d.__name__] == 0, "the atrium's group route launched the tile raster")
    for g in gates[MAIN_WARMUP - 1:]:
        check(g["expand_overflow"] == 0 and g["bin_overflow"] == 0, f"group-route atrium frame dropped work: {g}")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(image).all())
          and image.min().item() >= 0.0 and image.max().item() <= 1.0 + FXAA_RANGE_ROUNDING,
          "group-route atrium image not finite or outside [0, 1]")
    # one frame with the kernels and with the plain versions from a shared
    # state and carry (no page cache: every shadow level renders), and the
    # same frame on the tile route
    prev = {k: v for k, v in runner.carry.items() if k != "shadow_cache"}
    cam = camera_from_state(runner.state, runner._resolve_camera_idx(), WIDTH / HEIGHT)

    def render18(renderer):
        return renderer.render(
            runner.state, runner.gscene, cam, runner.bindings.materials, runner.bindings.atlas, runner.config,
            prev=prev, atmosphere=runner.atmosphere, enable_shadows=runner.enable_shadows, textured=runner._textured,
            texture_features=runner._texture_features, alpha_masked=runner._has_alpha_mask,
            static_lights=runner._static_lights,
        )["final"]

    g0 = raster_groups.LAUNCHES
    img_k = render18(runner.renderer3d)
    rendered = raster_groups.LAUNCHES - g0
    with plain_on_card(raster_groups, hiz_ops, raster_depth):
        img_p = render18(runner.renderer3d)
    img_t = render18(tile_runner.renderer3d)
    print(f"[18] one atrium frame on the group route with the kernels ({rendered} group raster launches) and with "
          f"the plain versions from a shared state and carry: identical {bool(torch.equal(img_k, img_p))}; PSNR to "
          f"the tile route's frame {psnr(img_k, img_t):.2f} dB", flush=True)
    check(rendered >= 2, "the group-route comparison frame missed a raster pass")
    check(torch.equal(img_k, img_p), "group-route atrium: kernel and plain frames differ")
    # phase 23's inputs: one more atrium frame's culled meshlets, lights and atlas
    captured["atrium"] = frame_inputs(tile_runner)
    del runner, tile_runner, scene, runner_kw, prev, img_k, img_p, img_t
    torch.cuda.empty_cache()

    # ---- 16. the port's bench suite, as `python -m oxylus_tpu_torch.bench` runs it --------
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "oxylus_tpu_torch.bench"], capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT)
    bench_s = time.perf_counter() - t0
    cells = [ln for ln in proc.stderr.splitlines() if ln.startswith("{")]
    for ln in proc.stderr.splitlines():
        if ln.startswith("{") or "rates" in ln or "binning" in ln or "sponza" in ln or "gate" in ln:
            print(f"[16] {ln}", flush=True)
    last = json.loads(proc.stdout.strip().splitlines()[-1]) if proc.stdout.strip() else {}
    suite = last.get("suite", {})
    print(f"[16] bench suite exit {proc.returncode} in {bench_s:.1f} s; weakest cell {last.get('metric')} "
          f"{last.get('value')} ({card})", flush=True)
    check(proc.returncode == 0, f"the bench suite failed: {proc.stderr[-2000:]}")
    check(sorted(suite) == sorted(bench.CELLS) and all(c["value"] > 0 for c in suite.values()) and len(cells) == 6,
          f"the bench suite's cells: {suite}")

    # ---- 17a. the decode path on the golden scene -----------------------------------
    import numpy as np

    from oxylus_tpu_torch.core.config import RendererConfig
    from oxylus_tpu_torch.render.sky import AtmosphereParams

    golden_dir = __import__("pathlib").Path(__file__).resolve().parent / "tests" / "data"
    golden_spec = renderer3d.RenderSpec(width=GOLDEN_W, height=GOLDEN_H, max_visible_meshlets=64, use_pallas=False)
    for mod in every_mod:
        mod.LAUNCHES = 0
    golden_db = {}
    cpu = torch.device("cpu")

    def render_golden(kw: dict, on) -> torch.Tensor:
        state, gscene, cam, mats = golden_scene(on, kw.get("fov_deg", 60.0))
        cfg = RendererConfig(ssr_enable=True) if kw.get("ssr") else RendererConfig()
        return renderer3d.RendererInstance(golden_spec).render(
            state, gscene, cam, mats, torch.zeros((8, 8, 4), dtype=torch.uint8, device=on), cfg,
            atmosphere=AtmosphereParams() if kw.get("atmosphere") else None,
            enable_shadows=bool(kw.get("enable_shadows")))["final"]

    for name, kw in GOLDEN_SETTINGS.items():
        img_k = render_golden(kw, dev)
        with plain_on_card(hiz_ops, raster_depth):
            img_p = render_golden(kw, dev)
        img_c = render_golden(kw, cpu)  # the port's decode path on the CPU, launching nothing
        golden_db[name] = psnr_u8(img_k, np.load(golden_dir / f"golden_{name}.npy"))
        cpu_db = psnr_u8(img_k, torch.clamp(img_c * 255.0 + 0.5, 0, 255).to(torch.uint8).numpy())
        print(f"[17a] golden {name}: decode path on the card vs the stored golden {golden_db[name]:.2f} dB, vs the "
              f"port's CPU frame {cpu_db:.2f} dB; kernels vs plain versions identical "
              f"{bool(torch.equal(img_k, img_p))}", flush=True)
        check(cpu_db >= GOLDEN_DECODE_MIN_DB, f"golden {name}: {cpu_db:.2f} dB from the port's CPU frame")
        check(golden_db[name] >= GOLDEN_MIN_DB, f"golden {name}: PSNR {golden_db[name]:.2f} dB < {GOLDEN_MIN_DB}")
        check(golden_db[name] >= GOLDEN_DECODE_MIN_DB,
              f"golden {name}: PSNR {golden_db[name]:.2f} dB < {GOLDEN_DECODE_MIN_DB}, the decode path's own bound")
        check(torch.equal(img_k, img_p), f"golden {name}: kernel and plain frames differ")
    golden_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    print(f"[17a] kernel launches over the five goldens (each rendered twice, the second time with the plain "
          f"versions): {golden_launches}", flush=True)
    check(golden_launches[hiz_ops.__name__] > 0 and golden_launches[raster_depth.__name__] > 0,
          "the golden frames never launched HiZ or the depth raster")
    check(golden_launches[raster3d.__name__] == 0 and golden_launches[raster_groups.__name__] == 0,
          "the decode path launched a G-buffer raster kernel")

    # ---- 17b. the config-5 runner on the decode path at 1080p -------------------------
    t0 = time.perf_counter()
    scene, runner_kw = build_frame5_scene(WIDTH, HEIGHT, device=dev)
    runner_kw["render_spec"] = dataclasses.replace(runner_kw["render_spec"], use_pallas=False)
    runner = SceneRunner(scene, **runner_kw)
    print(f"[17b] config-5 runner on the decode path built in {time.perf_counter() - t0:.2f} s; "
          f"{runner.renderer3d.spec}", flush=True)
    runner.run(MAIN_WARMUP)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for mod in every_mod:
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    for _ in range(DECODE_FRAMES):
        image = runner.step()
    torch.cuda.synchronize()
    wall17 = time.perf_counter() - t0
    peak17 = torch.cuda.max_memory_allocated(dev)
    decode_launches = {mod.__name__: mod.LAUNCHES for mod in every_mod}
    ps = runner.ps
    dyn = ps.active & (ps.body_type == BODY_DYNAMIC)
    min_y = ps.pos[dyn, 1].min().item()
    carry = runner.carry
    print(f"[17b] config-5 runner, decode path: {DECODE_FRAMES} frames at {WIDTH}x{HEIGHT} in {wall17:.3f} s = "
          f"{DECODE_FRAMES / wall17:.3f} frames/s ({card}); peak memory allocated {peak17 / 2**30:.3f} GiB; kernel "
          f"launches {decode_launches}; expand_overflow {int(carry['expand_overflow'])}, bin_overflow "
          f"{int(carry['bin_overflow'])}; image mean {image.mean().item():.5f}; lowest box centre y = {min_y:.4f} m",
          flush=True)
    for mod in (mc, hiz_ops, raster_depth):
        check(decode_launches[mod.__name__] > 0, f"the decode-path frames never launched the {mod.__name__} kernel")
    check(decode_launches[raster3d.__name__] == 0 and decode_launches[raster_groups.__name__] == 0,
          "the decode path launched a G-buffer raster kernel")
    check(tuple(image.shape) == (HEIGHT, WIDTH, 3) and bool(torch.isfinite(image).all())
          and image.min().item() >= 0.0 and image.max().item() <= 1.0, "decode path: image not finite or outside [0, 1]")
    check(int(carry["expand_overflow"]) == 0, "decode path: the meshlet expansion dropped work")
    check(bool(torch.isfinite(ps.pos).all()) and min_y > FLOOR_MID_Y, "decode path: a box fell through the floor")
    # phase 23's inputs: one more frame's culled meshlets and lights, and its bilinear samples (C8)
    captured["samples"] = []
    captured["frame5"] = frame_inputs(runner, also=((decode3d, "sample_atlas_bilinear", captured["samples"]),))
    del runner, scene, runner_kw
    torch.cuda.empty_cache()

    # ---- 19. the app path: JSON scene, assets, script, audio and App.run at config 5 --------
    app_launches, handoff = app_phase(dev, card, every_mod)

    # ---- 20. the default module roster on phase 19's scene: textures, overlay, network, picking ----
    roster_launches = roster_phase(dev, card, every_mod, handoff)

    # ---- 21. the editor and the UI: phase 19's scene as a project, play/stop, picks, UI ----
    editor_launches = editor_phase(dev, card, every_mod, handoff)
    handoff["tmp"].cleanup()

    # ---- 22. the tile raster route at 16- and 32-px tiles: config 5, the atrium, bands, sprite tiles ----
    tiles_launches, tiles_rows = tiles_phase(dev, card, every_mod, full_launches[raster3d.__name__] / MAIN_FRAMES)

    # ---- 23. the sharded paths on a one-rank NCCL group and as 4 bands in turn; C8 card against CPU ----
    shard_launches = sharding_phase(dev, card, every_mod, captured)
    del captured

    def row(name, source, replaces, mod, err, ms, plain, bd):
        # launches on the paths of phases 17a (the five goldens, each twice), 17b (the decode
        # path's timed frames), 18 (the atrium's group-route frames), 19 (the App's frames), 20
        # (the roster's frames), 21 (the editor's edit and play frames and config 2's id image),
        # 22 (the config-5 frames at tiles 16 and 32 and the atrium's at 32) and 23 (the worlds and
        # the sharded frames)
        paths = {"goldens_17a": golden_launches[mod.__name__], "decode_runner_17b": decode_launches[mod.__name__],
                 "atrium_group_18": atrium_group_launches[mod.__name__], "app_19": app_launches[mod.__name__],
                 "roster_20": roster_launches[mod.__name__], "editor_21": editor_launches[mod.__name__],
                 "tiles_22": tiles_launches[mod.__name__], "sharding_23": shard_launches[mod.__name__]}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[mod.__name__], "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bd[0], "bound_by": bd[1], "library_ms": None, "path_launches": paths}

    early = raster_rows[0]
    print(json.dumps({"kernels": [
        row("compact_substeps", "oxylus_tpu_torch/physics/csrc/megakernel_compact.cu",
            "oxylus_tpu/physics/megakernel_compact.py:75", mc, compact_err, compact_ms, compact_plain_ms,
            compact_bound),
        dict(row("raster_tiles", "oxylus_tpu_torch/ops/csrc/raster_tiles.cu", "oxylus_tpu/ops/raster3d.py:936",
                 raster3d, max(r[0] for r in raster_rows + sponza_rows + [t["row"] for t in tiles_rows]), early[1],
                 early[2], early[3]),
             sponza_passes=[{"pass": n, "k2": a[0].shape[1],
                             "launches_per_frame": pass_launches[n] / len(gated), "max_abs_err": r[0], "ms": r[1],
                             "plain_ms": r[2],
                             "bound_ms": r[3][0], "bound_by": r[3][1]}
                            for n, a, r in zip(names, sponza_calls, sponza_rows)],
             tile_passes=[{"scene": t["scene"], "tile": t["tile"], "pass": t["pass"], "k2": t["k2"],
                           "ctas": t["row"][5]["ctas"], "launches_per_frame": t["launches_per_frame"],
                           "max_abs_err": t["row"][0], "ms": t["row"][1], "events_ms": t["row"][4],
                           "plain_ms": t["row"][2], "bound_ms": t["row"][3][0], "bound_by": t["row"][3][1]}
                          for t in tiles_rows]),
        dict(row("hiz_build", "oxylus_tpu_torch/ops/csrc/hiz.cu", "oxylus_tpu/ops/hiz.py:103", hiz_ops, hiz_err,
                 hiz_graph_ms, hiz_plain_ms, hiz_bound),
             sponza={"launches_per_frame": sp_hiz_per_frame, "max_abs_err": sp_hiz_err, "ms": sp_hiz_ms,
                     "plain_ms": sp_hiz_plain,
                     "bound_ms": sp_hiz_bound[0], "bound_by": sp_hiz_bound[1]}),
        dict(row("dense_substeps", "oxylus_tpu_torch/physics/csrc/megakernel_dense.cu",
                 "oxylus_tpu/physics/megakernel.py:46", mk, dense_err, dense_ms, dense_plain_ms, dense_bound),
             kernel_ms=dense_kernel_ms, device_launches_per_call=dense_launches),
        dict(row("raster_depth", "oxylus_tpu_torch/ops/csrc/raster_depth.cu", "oxylus_tpu/ops/raster3d.py:153",
                 raster_depth, max([depth_err] + [r[0] for r in sp_depth]), depth_ms, depth_plain_ms, depth_bound),
             sponza={"levels": len(sp_depth), "ms": sum(r[1] for r in sp_depth),
                     "plain_ms": sum(r[2] for r in sp_depth), "bound_ms": sp_depth_bound[0],
                     "bound_by": sp_depth_bound[1]}),
        row("blend2d", "oxylus_tpu_torch/ops/csrc/blend2d.cu", "oxylus_tpu/ops/raster2d_pallas.py:41", blend2d,
            max(err10, err11), blend_ms, blend_plain_ms, blend_bound),
        dict(row("banded_substeps", "oxylus_tpu_torch/physics/csrc/megakernel_banded.cu",
                 "oxylus_tpu/physics/megakernel_banded.py:80", mb, banded_err, banded_ms, banded_plain_ms,
                 banded_bound),
             kernel_ms=banded_kernel_ms, device_launches_per_call=banded_launches),
        row("raster_groups", "oxylus_tpu_torch/ops/csrc/raster_groups.cu", "oxylus_tpu/ops/raster3d.py:355",
            raster_groups, group_err, group_rows[0][1], group_rows[0][2], group_rows[0][3]),
    ] + probe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
