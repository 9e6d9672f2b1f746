"""Where the time goes on the card, for the fused simulate-and-render 3D frame
and for the 2D frame.

    python -m oxylus_tpu_torch.profile_frame3d [--frames N] [--config 5|4|3|2] [--raster-path tile|group] [--decode]

Builds the full config-5 scene (`frame5.build_frame5_scene`, 1920×1080, 150
objects, 255 boxes; atmosphere, clipmap shadows, GTAO, SSR), with
`--config 4` the Sponza-class atrium (`sponza.build_sponza_scene`: 307
instances, textured and alpha-masked materials; atmosphere, clipmap shadows,
GTAO), with `--config 3` the config-3 scene (`frame3d.build_frame3d_scene`, 200 objects,
8 point lights, 3 emitters; atmosphere, clipmap shadows, GTAO and the
Forward2D particle layer), or with `--config 2` the 2D scene
(`frame2d.build_frame2d_scene`, 512 sprites, 2 emitters); with
`--raster-path group` a 3D scene renders through the group raster route
(`RenderSpec(raster_path="group", compact_raster=True)`: `compact_triangles`
and the group kernel, a stage of its own), with `--decode` through the decode
path (`RenderSpec(use_pallas=False)`: the meshlet binning,
`rasterize_reference` and `decode_visbuffer`, a stage each). It runs 2 warm-up
frames and FRAMES untraced frames, then traces FRAMES more with
`torch.profiler` (CUPTI) and prints, on labelled lines (`frame3d`, or
`frame2d` for config 2):

- `wall per frame`: host wall time per frame, traced and untraced;
- `device busy per frame`: the sum of the device activities' durations per
  frame (one stream) and its share of the traced and untraced wall time;
- `kernel launches per frame`: the host's kernel-launch calls, the launches of
  the port's own kernels (compact, raster, HiZ, depth raster, sprite blend, group raster)
  per frame, and the host reads (device-to-host copies) per frame;
- `stage <name>`: per frame, the device time of the kernels each stage
  launched, the stage's span on the device's timeline and its host time, by
  `torch.profiler.record_function` ranges put around the stage functions for
  the traced frames only. In 3D: physics, the tile binning, the shared slot
  rows and the slot tables, each tile raster call by its K2 (on the group
  route its compaction, binning and raster), HiZ, the masked pass's alpha
  cutoff and merge, the textured G-buffer, sky, the
  shadow maps with each clipmap level and tier, resolve, contact shadows,
  GTAO, PBR, SSR, aerial perspective, the particle layer, post. In 2D: the
  frame step, the sprite and particle assembly around the raster, and inside
  the raster the sort, the texture tiles and the blend (packing + kernel);
- `own kernel <name>` and `device <name>`: device time by kernel, the port's
  own kernels first.

Needs a card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import subprocess
import time

import torch

from . import runtime
from .frame2d import build_frame2d_scene
from .frame3d import build_frame3d_scene
from .frame5 import build_frame5_scene
from .sponza import build_sponza_scene
from .ops import blend2d, hiz, raster2d, raster3d, raster_depth, raster_groups
from .physics import megakernel_compact as mc
from .profile_flagship import _device_events, _launches, _table
from .render import gtao, renderer2d, renderer3d, shadows, sky

# name prefixes of the port's own kernels, as `kernel_name` gives them, in the
# order of `mods` in `main`
OWN_KERNELS = {"compact": "k_", "raster": "raster_tiles_kernel", "hiz": "hiz_", "depth raster": "raster_depth_",
               "blend": "blend2d_kernel", "group raster": "raster_groups_kernel"}
# the depth raster's kernels per call (`raster_depth_chunks`, then `raster_depth_decode`; the
# key buffer's clear before them is a memset, in the device total but in no stage)
DEPTH_KERNELS_PER_CALL = 2
# the stages that launch each own kernel, the enclosing ones too (the depth
# raster: the clipmap level, per call)
OWN_STAGES_3D = {"compact": ("physics (frame_step)",), "hiz": ("HiZ",),
                 "blend": ("particles (Forward2D)",), "group raster": ("group raster",)}
OWN_STAGES_2D = {"blend": ("raster: blend (packing + kernel)", "raster (sort, binning, tiles, blend)",
                           "2D render (all)")}

# (module, function, stage) of every stage function wrapped in a range, per frame kind
STAGES_3D = (
    (runtime, "frame_step", "physics (frame_step)"),
    (renderer3d, "bin_triangles_per_tile", "tile binning"),
    (raster3d, "build_tile_comb", "tile comb (shared slot rows)"),
    (raster3d, "pack_tile_blocks", "tile blocks (slot tables)"),
    (renderer3d, "compact_triangles", "group route: compact_triangles"),
    (renderer3d, "bin_meshlets_to_tiles", "meshlet binning (group route, decode path)"),
    (raster3d, "rasterize_reference", "decode path: rasterize_reference"),
    (renderer3d, "decode_visbuffer", "decode path: decode_visbuffer"),
    (raster_groups, "run_groups", "group raster"),
    (hiz, "build_hiz", "HiZ"),
    (renderer3d, "alpha_mask_merge", "masked pass: alpha cutoff and merge"),
    (renderer3d, "texture_gbuffer", "textured G-buffer"),
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
    (renderer3d, "render_particles_3d", "particles (Forward2D)"),
    (renderer3d, "apply_bloom", "post: bloom"),
    (renderer3d, "apply_tonemap", "post: tonemap"),
    (renderer3d, "apply_fxaa", "post: FXAA"),
)
STAGES_2D = (
    (runtime, "frame_step", "frame step"),
    (runtime, "render_2d_with_particles", "2D render (all)"),
    (renderer2d, "rasterize_sprites", "raster (sort, binning, tiles, blend)"),
    (raster2d, "sprite_sort_order", "raster: sort"),
    (raster2d, "resample_texture_tiles", "raster: texture tiles"),
    (raster2d, "blend_tiles", "raster: blend (packing + kernel)"),
)
BUILDERS = {5: build_frame5_scene, 4: lambda w, h, device: build_sponza_scene(w, h, device=device)[:2],
            3: build_frame3d_scene, 2: build_frame2d_scene}


def kernel_name(event) -> str:
    """A device event's kernel name without the anonymous namespace and the
    `void ` that a template kernel's name starts with."""
    name = event.name.replace("(anonymous namespace)::", "")
    return name[len("void "):] if name.startswith("void ") else name


def _ranged(fn, name_of):
    def wrapped(*args, **kw):
        with torch.profiler.record_function(name_of(args)):
            return fn(*args, **kw)
    return wrapped


@contextlib.contextmanager
def stage_ranges(levels: list, stages=STAGES_3D, tiles: list | None = None):
    """Wrap the stage functions in `record_function` ranges. A clipmap level's
    range is named by its level (the light matrix is a row of the (L, 4, 4)
    stack) and its tier (its capacity); the names of the levels rendered are
    appended to `levels` in call order (one depth raster launch each). A tile
    raster call's range is named by its K2, and appended to `tiles` (one
    launch each)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in stages]
    saved.append((shadows, "_render_level", shadows._render_level))
    saved.append((raster3d, "run_tiles", raster3d.run_tiles))
    for (mod, name, stage), (_, _, fn) in zip(stages, saved):
        setattr(mod, name, _ranged(fn, lambda args, stage=stage: f"stage:{stage}"))

    def level(args) -> str:
        levels.append(f"shadows: level {args[2].storage_offset() // 16} ({'full' if args[4] >= 2048 else 'small'} tier)")
        return "stage:" + levels[-1]

    def tile_call(args) -> str:
        name = f"tile raster: K2 {args[0].shape[1]}"
        if tiles is not None:
            tiles.append(name)
        return "stage:" + name

    shadows._render_level = _ranged(saved[-2][2], level)
    raster3d.run_tiles = _ranged(saved[-1][2], tile_call)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _own_kernels_by_stage(events: list, levels: list, own_stages=OWN_STAGES_3D, tiles: list = ()) -> dict[str, float]:
    """Device µs of the port's own kernels by the stage that launched them. The
    profiler does not tie a kernel launched through the ctypes library to the
    range around it, so they are assigned here: each kind to its stage, the
    depth raster's launches, in time order, to the levels rendered, and the
    tile raster's to its calls (`tiles`)."""
    out: dict[str, float] = collections.defaultdict(float)
    by_kind = {k: sorted((e for e in events if kernel_name(e).startswith(p)),
                         key=lambda e: e.time_range.start) for k, p in OWN_KERNELS.items()}
    for kind, stages in own_stages.items():
        for stage in stages:
            out[stage] += sum(e.time_range.elapsed_us() for e in by_kind[kind])
    depth = by_kind["depth raster"]
    calls = [depth[i : i + DEPTH_KERNELS_PER_CALL] for i in range(0, len(depth), DEPTH_KERNELS_PER_CALL)]
    for name, call in zip(levels, calls):
        out[name] += sum(e.time_range.elapsed_us() for e in call)
    out["shadows: clipmaps (all levels)"] += sum(e.time_range.elapsed_us() for e in by_kind["depth raster"])
    for name, e in zip(tiles, by_kind["raster"]):
        out[name] += e.time_range.elapsed_us()
    return out


def _stage_table(prof, frames: int, own: dict[str, float], tag: str = "frame3d") -> None:
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
        print(f"{tag} stage {name}: device {(torch_us + own_us) / frames / 1e3:.4f} ms (PyTorch ops "
              f"{torch_us / frames / 1e3:.4f}, own kernels {own_us / frames / 1e3:.4f}), span "
              f"{span_us / frames / 1e3:.3f} ms, host {cpu_us / frames / 1e3:.3f} ms per frame, "
              f"{n / frames:.2f} calls per frame")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--config", type=int, choices=sorted(BUILDERS, reverse=True), default=5)
    ap.add_argument("--raster-path", choices=("tile", "group"), default="tile")
    ap.add_argument("--decode", action="store_true", help="render through the decode path (use_pallas=False)")
    args = ap.parse_args()
    frames = args.frames
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame3d needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0])
    two_d = args.config == 2
    tag = "frame2d" if two_d else "frame3d"
    if two_d and (args.raster_path != "tile" or args.decode):
        raise SystemExit("--raster-path and --decode are 3D options")
    print(f"{tag} config {args.config}, raster path {'decode' if args.decode else args.raster_path}")
    scene, kw = BUILDERS[args.config](1920, 1080, device="cuda")
    if args.raster_path == "group":
        kw["render_spec"] = dataclasses.replace(kw["render_spec"], raster_path="group", compact_raster=True)
    if args.decode:
        kw["render_spec"] = dataclasses.replace(kw["render_spec"], use_pallas=False)
    runner = runtime.SceneRunner(scene, **kw)
    runner.run(2)
    t0 = time.perf_counter()
    runner.run(frames)
    untraced = (time.perf_counter() - t0) / frames
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    mods = (mc, raster3d, hiz, raster_depth, blend2d, raster_groups)
    counts0 = [m.LAUNCHES for m in mods]
    levels: list[str] = []
    tiles: list[str] = []
    with stage_ranges(levels, STAGES_2D if two_d else STAGES_3D, tiles), \
            torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.run(frames)
        traced = (time.perf_counter() - t0) / frames
    own = [(m.LAUNCHES - c) / frames for m, c in zip(mods, counts0)]
    # the device's activities, without the stage ranges the profiler also marks on its timeline
    events = [e for e in _device_events(prof) if not e.name.startswith("stage:")]
    reads = sum(1 for e in events if "DtoH" in e.name or "Device -> Pageable" in e.name) / frames
    for (name, prefix), calls in zip(OWN_KERNELS.items(), own):
        mine = [e for e in events if kernel_name(e).startswith(prefix)]
        if calls > 0 and not mine:  # a renamed kernel would drop out of its stage unnoticed
            raise RuntimeError(f"{name}: {calls} wrapper calls per frame but no device kernel named {prefix}*")
        print(f"{tag} own kernel {name}: {sum(e.time_range.elapsed_us() for e in mine) / frames:.1f} us per frame "
              f"over {len(mine) / frames:.1f} device launches per frame")
    _stage_table(prof, frames, _own_kernels_by_stage(events, levels, OWN_STAGES_2D if two_d else OWN_STAGES_3D,
                                                     tiles), tag=tag)
    busy = _table(tag, events, top=25) / 1e3 / frames
    print(f"{tag} wall per frame: {untraced * 1e3:.3f} ms untraced, {traced * 1e3:.3f} ms traced "
          f"({frames} frames after {frames + 2})")
    print(f"{tag} device busy per frame: {busy:.3f} ms = {100 * busy / (traced * 1e3):.1f} % of the traced, "
          f"{100 * busy / (untraced * 1e3):.1f} % of the untraced wall time; "
          f"{len(events) / frames:.1f} device activities per frame")
    print(f"{tag} kernel launches per frame: {_launches(prof) / frames:.1f} host launch calls; wrapper calls "
          f"compact {own[0]:.2f}, raster {own[1]:.2f}, hiz {own[2]:.2f}, depth raster {own[3]:.2f}, "
          f"blend {own[4]:.2f}, group raster {own[5]:.2f}; "
          f"host reads (device-to-host copies) {reads:.2f}")


if __name__ == "__main__":
    main()
