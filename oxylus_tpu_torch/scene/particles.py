"""Particle pool (counterpart of `oxylus_tpu/scene/particles.py`).

A fixed-capacity SoA ring shared by the scene: emitters claim contiguous ring
slots via a prefix sum over per-emitter spawn counts, and integration is one
vector pass. Spawn positions draw from a `torch.Generator` seeded from
(0x0C5, frame) — deterministic and replayable like the JAX key
`fold_in(PRNGKey(0x0C5), frame)`, but a different stream, so spawn positions
differ from the JAX package while everything else matches.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from .state import SceneSpec, SceneState

Tensor = torch.Tensor

# spawn budget per frame (static): plenty for the reference's default 10/s emitters
MAX_SPAWNS_PER_FRAME = 256
SPAWN_SEED = 0x0C5


@dataclasses.dataclass
class ParticlePool:
    alive: Tensor     # (M,) bool
    emitter: Tensor   # (M,) i32 entity index of owning ParticleSystemComponent
    age: Tensor       # (M,) f32 seconds since spawn
    lifetime: Tensor  # (M,) f32
    pos: Tensor       # (M,3)
    vel: Tensor       # (M,3)
    cursor: Tensor    # () i32 ring cursor


def empty_pool(spec: SceneSpec, device: torch.device | str | None = None) -> ParticlePool:
    """The empty particle pool on `device` (the card unless the CPU is asked for)."""
    device = resolve_device(device)
    m = spec.max_particles
    return ParticlePool(
        alive=torch.zeros((m,), dtype=torch.bool, device=device),
        emitter=torch.full((m,), -1, dtype=torch.int32, device=device),
        age=torch.zeros((m,), dtype=torch.float32, device=device),
        lifetime=torch.zeros((m,), dtype=torch.float32, device=device),
        pos=torch.zeros((m, 3), dtype=torch.float32, device=device),
        vel=torch.zeros((m, 3), dtype=torch.float32, device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
    )


def spawn_uniforms(frame: int, device: torch.device) -> Tensor:
    """(MAX_SPAWNS_PER_FRAME, 1) uniforms in [0, 1) for one frame's spawns."""
    gen = torch.Generator(device=device)
    gen.manual_seed((SPAWN_SEED << 32) | (int(frame) & 0xFFFFFFFF))
    return torch.rand((MAX_SPAWNS_PER_FRAME, 1), generator=gen, device=device)


def _scatter(dst: Tensor, slot: Tensor, valid: Tensor, src: Tensor) -> Tensor:
    """dst[slot] = src on valid rows; ring slots are unique within one frame."""
    out = dst.clone()
    out[slot[valid].long()] = src[valid].to(dst.dtype)
    return out


def particle_update(state: SceneState, spec: SceneSpec, dt: Tensor) -> SceneState:
    """Emit and integrate particles (`Scene.cpp:793-959`). Reads the frame number
    on the host to seed the spawn draw."""
    pool = state.particles
    dev = state.alive.device
    psys = dict(state.comp["ParticleSystemComponent"])
    emitter_mask = state.mask["ParticleSystemComponent"] & state.alive

    sim_dt = dt * psys["simulation_speed"]

    # --- emitter clocks -----------------------------------------------------
    playing = emitter_mask & psys["play_on_awake"]
    t_prev = psys["system_time"]
    t_new = torch.where(playing, t_prev + sim_dt, t_prev)
    duration = torch.clamp(psys["duration"], min=1e-6)
    active_window = playing & (psys["looping"] | (t_new < duration + psys["start_delay"]))
    emitting = active_window & (t_new >= psys["start_delay"])

    # rate-over-time emission via integer crossings of the emission clock
    rate = psys["rate_over_time"].float()
    delay = psys["start_delay"]
    n_prev = torch.floor((t_prev - delay) * rate)
    n_new = torch.floor((t_new - delay) * rate)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    spawn_count = torch.where(emitting, torch.clamp(n_new - n_prev, min=0.0), zero).to(torch.int32)

    # rate-over-distance: emitters that moved more than 1 unit since the last
    # distance spawn emit rate_over_distance at once
    epos = state.world[:, :3, 3]
    lsp = psys["last_spawned_position"]
    moved = torch.sum((epos - lsp) ** 2, dim=-1) > 1.0
    rod = psys["rate_over_distance"].long()
    dist_emit = emitting & moved & (rod > 0)
    spawn_count = spawn_count + torch.where(dist_emit, rod, torch.zeros_like(rod)).to(torch.int32)
    psys["last_spawned_position"] = torch.where(dist_emit[:, None], epos, lsp)

    # bursts: burst_count particles at the start of each emission loop
    loops_prev = torch.floor((t_prev - delay) / duration)
    loops_new = torch.floor((t_new - delay) / duration)
    first_cross = (t_prev <= delay) & (t_new > delay)
    burst_events = torch.where(
        active_window, torch.clamp(loops_new - loops_prev, min=0.0) + first_cross.float(), zero
    ).to(torch.int32)
    spawn_count = spawn_count + psys["burst_count"].long().to(torch.int32) * burst_events
    spawn_count = torch.clamp(spawn_count, max=MAX_SPAWNS_PER_FRAME)

    psys["system_time"] = t_new
    comp = dict(state.comp)
    comp["ParticleSystemComponent"] = psys
    if spec.max_particles == 0:
        # an empty pool (the JAX runner admits such scenes): the emitter
        # clocks run, nothing spawns or integrates
        return dataclasses.replace(state, comp=comp)

    # --- allocate ring slots: prefix sum over emitters ----------------------
    prefix = torch.cumsum(spawn_count, dim=0, dtype=torch.int32)
    total = torch.clamp(prefix[-1], max=MAX_SPAWNS_PER_FRAME) if prefix.shape[0] > 0 else zero.int()

    s_idx = torch.arange(MAX_SPAWNS_PER_FRAME, dtype=torch.int32, device=dev)
    spawn_valid = s_idx < total
    emitter_of = torch.searchsorted(prefix, s_idx, right=True).to(torch.int32)
    emitter_of = torch.clamp(emitter_of, 0, state.alive.shape[0] - 1)
    slot = torch.remainder(pool.cursor + s_idx, spec.max_particles)

    eo = emitter_of.long()
    g = lambda k: psys[k][eo]
    world_off = state.world[eo][:, :3, 3]  # emitter world position
    u = spawn_uniforms(int(state.frame), dev)
    spawn_pos = world_off + g("position_start") + (g("position_end") - g("position_start")) * u

    new_pool = ParticlePool(
        alive=_scatter(pool.alive, slot, spawn_valid, torch.ones_like(spawn_valid)),
        emitter=_scatter(pool.emitter, slot, spawn_valid, emitter_of),
        age=_scatter(pool.age, slot, spawn_valid, torch.zeros_like(u[:, 0])),
        lifetime=_scatter(pool.lifetime, slot, spawn_valid, g("start_lifetime")),
        pos=_scatter(pool.pos, slot, spawn_valid, spawn_pos),
        vel=_scatter(pool.vel, slot, spawn_valid, g("start_velocity")),
        cursor=torch.remainder(pool.cursor + total, spec.max_particles).to(torch.int32),
    )

    # --- integrate live particles ------------------------------------------
    em = torch.clamp(new_pool.emitter, min=0).long()
    ge = lambda k: psys[k][em]
    step = dt * ge("simulation_speed")
    age = new_pool.age + step
    alive = new_pool.alive & (age < new_pool.lifetime)
    frac = torch.clamp(age / torch.clamp(new_pool.lifetime, min=1e-6), 0.0, 1.0)

    gravity = torch.tensor([0.0, -9.81, 0.0], dtype=torch.float32, device=dev)
    accel = gravity[None, :] * ge("gravity_modifier")[:, None]
    fol = torch.where(
        ge("force_over_lifetime_enabled")[:, None],
        ge("force_over_lifetime_start")
        + (ge("force_over_lifetime_end") - ge("force_over_lifetime_start")) * frac[:, None],
        zero,
    )
    vel = new_pool.vel + (accel + fol) * step[:, None]
    vol = torch.where(
        ge("velocity_over_lifetime_enabled")[:, None],
        ge("velocity_over_lifetime_start")
        + (ge("velocity_over_lifetime_end") - ge("velocity_over_lifetime_start")) * frac[:, None],
        zero,
    )
    pos = new_pool.pos + (vel + vol) * step[:, None]

    new_pool = dataclasses.replace(
        new_pool,
        age=torch.where(new_pool.alive, age, new_pool.age),
        alive=alive,
        vel=torch.where(alive[:, None], vel, new_pool.vel),
        pos=torch.where(alive[:, None], pos, new_pool.pos),
    )

    return dataclasses.replace(state, comp=comp, particles=new_pool)
