"""The sharded paths run across ranks (counterpart of
`__graft_entry__.dryrun_multichip`).

    python -m oxylus_tpu_torch.parallel.dryrun --ranks N [--device cpu]

starts N processes in one process group (NCCL, one card a rank; or gloo on the
CPU with `--device cpu`) and runs the JAX dryrun's four stages on the port:
1. the 31-box flagship's `frame_step`, one world a rank, then the cross-world
   mean body height;
2. the tile-sharded raster of the cube;
3. the band-sharded full frame (decode path);
4. the band-sharded group-route frame.
Rank 0 prints the JAX dryrun's lines. More ranks than cards raises: NCCL puts
one rank on a device.

`spawn_ranks(fn, n, device)` is the launcher: `torch.multiprocessing` spawn,
each rank's group initialised from a `file://` store in a temporary
directory, `fn(rank, n, device, *args)` called in it and its return value
(tensors moved to the CPU) handed back to the caller by rank.
"""

from __future__ import annotations

import argparse
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from ..device import resolve_device
from .sharding import (
    _tree_map,
    make_mesh,
    rasterize_tiles_sharded,
    render_frame_sharded,
    render_frame_sharded_production,
    replicate_worlds,
    worlds_reduce_mean,
    worlds_step,
)


def _rank_main(rank: int, fn, n: int, dev_type: str, tmp: str, args: tuple) -> None:
    if dev_type == "cuda":
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    dist.init_process_group("nccl" if dev_type == "cuda" else "gloo", init_method=f"file://{tmp}/store",
                            world_size=n, rank=rank)
    try:
        out = fn(rank, n, device, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(_tree_map(lambda x: x.detach().cpu(), out), f)


def spawn_ranks(fn, n: int, device=None, args: tuple = ()) -> list:
    """Run `fn(rank, n, device, *args)` in `n` spawned processes of one
    process group, on the cards (NCCL, rank r on card r) unless
    `device="cpu"` (gloo, one thread a process). Returns the ranks' return
    values in rank order. `fn` must be importable by name (a module-level
    function); a rank that raises raises here."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("ranks on the card need the NCCL backend, which this PyTorch lacks")
        if n > torch.cuda.device_count():
            raise RuntimeError(f"{n} ranks but {torch.cuda.device_count()} card(s): NCCL puts one rank on a device")
    elif not dist.is_gloo_available():
        raise RuntimeError("CPU ranks need the gloo backend, which this PyTorch lacks")
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(fn, n, dev.type, tmp, tuple(args)), nprocs=n, start_method="spawn",
                           join=True)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def cube_frame(width: int, height: int, device, mpt: int = 8, group: int = 64, tile: int = 64) -> dict:
    """The dryrun's one-cube scene (`tests/test_render3d.py`'s cube and
    camera looking down -z from z = 3) on `device`: the cull, setup, 64-px
    meshlet lists and coefficient matrix of the decode path, one key light,
    empty materials and atlas, and the group route's inputs (dense groups of
    `group` slots, their slot rows, suffix-maxed near bounds and lists at
    `tile` px)."""
    import math

    from ..assets.bake import bake_mesh
    from ..assets.material import empty_gpu_materials
    from ..frame5 import cube_mesh
    from ..ops import raster3d, raster_depth
    from ..ops.cull import cull_meshlets, expand_meshlet_instances
    from ..ops.setup3d import bin_meshlets_to_tiles, compact_triangles, setup_triangles
    from ..render.camera import camera_matrices
    from ..render.pbr import Lights
    from ..render.scene3d import upload_meshes

    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    gsc = upload_meshes([bake_mesh(*cube_mesh())], [(0, 0, 0)], device=device)
    world = torch.eye(4, device=device).expand(2, 4, 4).contiguous()
    cam = camera_matrices(position=f32([0.0, 0.0, 3.0]), yaw=f32(-math.pi / 2), pitch=f32(0.0), tilt=f32(0.0),
                          fov_deg=f32(60.0), near=f32(0.1), far=f32(100.0), zoom=f32(1.0),
                          projection_kind=torch.tensor(0, dtype=torch.int32, device=device), aspect=f32(width / height))
    inst, ml, valid = expand_meshlet_instances(gsc, torch.tensor([True], device=device),
                                               torch.tensor([0], device=device), 16)
    vm_i, vm_m, vm_v, _ = cull_meshlets(gsc, world, inst, ml, valid, cam.frustum_planes, cam.position, capacity=16)
    setup = setup_triangles(gsc, world, vm_i, vm_m, vm_v, cam.view_projection, width, height)
    tiles, _ = bin_meshlets_to_tiles(setup, width, height, raster3d.TILE, mpt)
    mats = empty_gpu_materials(16, device=device)
    lights = Lights(
        kind=torch.zeros(4, dtype=torch.int32, device=device), color=torch.ones(4, 3, device=device),
        intensity=torch.full((4,), 3.0, device=device), position=torch.zeros(4, 3, device=device),
        direction=f32([0.0, 0.0, -1.0]).expand(4, 3).contiguous(), radius=torch.ones(4, device=device),
        inner_cone=torch.zeros(4, device=device), outer_cone=torch.ones(4, device=device),
        valid=torch.tensor([True, False, False, False], device=device),
        count=torch.tensor(1, dtype=torch.int32, device=device),
    )
    dense = compact_triangles(setup, setup["tri_valid"] & vm_v[:, None], gsc.inst_material[vm_i.long()], vm_i,
                              group=group, width=float(width), height=float(height))
    consts = torch.cat([mats.albedo_color[:, :3], mats.metallic_factor[:, None], mats.roughness_factor[:, None],
                        mats.emissive_color], dim=1)
    return dict(
        setup=setup, coeff_mat=raster_depth.pack_coeff_matrix(setup["coeffs"], setup["tri_valid"]), tiles=tiles,
        vm_instance=vm_i, gscene=gsc, world=world, materials=mats,
        atlas=torch.zeros((16, 16, 4), dtype=torch.uint8, device=device), lights=lights, camera=cam,
        ambient=torch.full((3,), 0.1, device=device),
        rows=raster3d.build_tile_comb(dense, consts[dense["slot_material"].long()]), n_slots=group,
        near_eo=torch.flip(torch.cummax(torch.flip(dense["ml_near"], [0]), 0).values, [0]),
        group_tiles=bin_meshlets_to_tiles(dense, width, height, tile, mpt)[0], tile=tile,
        inv_view_proj=torch.linalg.inv(cam.view_projection),
    )


def _dryrun_rank(rank: int, n: int, device) -> list[str]:
    """The four stages on this rank; returns the lines rank 0 prints."""
    from ..flagship import build_flagship
    from ..ops.raster3d import TILE
    from ..physics.state import PhysicsParams
    from ..scene.frame import frame_step

    mesh = make_mesh(n, device=device)
    lines = []
    scene = build_flagship(31, spec_kw=dict(max_entities=64, max_bodies=64, max_particles=64), device=device)
    spec = scene.spec
    params = PhysicsParams(max_pairs=256, velocity_iterations=4)
    states = replicate_worlds(scene.to_device_state(), n, mesh)
    bodies = replicate_worlds(scene.physics_state, n, mesh)
    _, stepped = worlds_step(lambda st, ps: frame_step(st, ps, params, 1.0 / 60.0, spec))(states, bodies)
    mean_y = worlds_reduce_mean(stepped.pos[..., 1].mean(-1), mesh)
    lines.append(f"dryrun_multichip: {n} worlds stepped; mean body height {float(mean_y):.3f}")

    w, h = 128, n * TILE  # one tile row a rank
    c = cube_frame(w, h, device)
    depth, vid = rasterize_tiles_sharded(c["coeff_mat"], c["tiles"], w, h, mesh)
    covered = float((vid >= 0).float().mean())
    lines.append(f"dryrun_multichip: tile-sharded raster over {n} devices; coverage {covered:.2f}")

    ldr, new_lum = render_frame_sharded(c["setup"], c["coeff_mat"], c["tiles"], c["vm_instance"], c["gscene"],
                                        c["world"], c["materials"], c["atlas"], c["lights"], c["camera"].position,
                                        c["ambient"], w, h, mesh)
    if tuple(ldr.shape) != (h, w, 3) or not bool(torch.isfinite(ldr).all()):
        raise RuntimeError(f"band-sharded frame: shape {tuple(ldr.shape)} or non-finite values")
    lines.append(f"dryrun_multichip: band-sharded full frame over {n} devices; adapted luminance {float(new_lum):.4f}")

    ldr_p, lum_p = render_frame_sharded_production(c["rows"], c["n_slots"], c["group_tiles"], c["near_eo"],
                                                   c["lights"], c["camera"].position, c["ambient"],
                                                   c["inv_view_proj"], w, h, mesh, tile=c["tile"])
    if tuple(ldr_p.shape) != (h, w, 3) or not bool(torch.isfinite(ldr_p).all()):
        raise RuntimeError(f"production frame: shape {tuple(ldr_p.shape)} or non-finite values")
    lines.append(f"dryrun_multichip: PRODUCTION group-raster G-buffer frame band-sharded over {n} devices; "
                 f"adapted luminance {float(lum_p):.4f}")
    return lines


def dryrun_multichip(n: int, device=None) -> list[str]:
    """Run the four stages on `n` ranks (the cards unless `device="cpu"`) and
    print rank 0's lines."""
    lines = spawn_ranks(_dryrun_rank, n, device)[0]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None, help="ranks (default: the card count; 4 on the CPU)")
    ap.add_argument("--device", default=None, help="cpu for gloo ranks; default the cards")
    a = ap.parse_args(argv)
    n = a.ranks or (4 if a.device == "cpu" else torch.cuda.device_count())
    dryrun_multichip(n, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
