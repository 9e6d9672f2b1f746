"""The frame step: one `Scene::runtime_update` on tensors (counterpart of
`oxylus_tpu/scene/frame.py`).

  OnUpdate   — fixed-60 Hz physics accumulator → N substeps, body→component pose
               sync, per-frame pose interpolation into transforms
  PostUpdate — particles, sprite animation, world-matrix propagation

The JAX version is one jit'd graph. Here the ops run eagerly on the state's
device, with two host reads per frame: the substep count, so the physics stage
makes exactly that many kernel calls (the JAX version loops `max_substeps`
times under `lax.cond`), and the frame number that seeds particle spawns. Writes that the JAX version does with `mode="drop"`
scatters go to a spare row that is cut off afterwards, so no data-dependent
shape (and no further device sync) appears.
"""

from __future__ import annotations

import dataclasses

import torch

from ..physics.megakernel_compact import megakernel_substeps_compact
from ..physics.state import BODY_STATIC, PhysicsParams, PhysicsState
from ..physics.step import physics_substep
from ..utils import math3d
from .particles import particle_update
from .state import SceneSpec, SceneState, propagate_transforms

Tensor = torch.Tensor


def _scatter_rows(dst: Tensor, target: Tensor, src: Tensor) -> Tensor:
    """dst[target] = src where target < len(dst); rows aimed at len(dst) are dropped."""
    n = dst.shape[0]
    out = torch.cat([dst, dst[:1]])
    out[target.long()] = src.to(dst.dtype)
    return out[:n]


def sync_bodies_to_components(state: SceneState, ps: PhysicsState) -> SceneState:
    """`rigidbody_update` (`Scene.cpp:731-751`): copy body pose into
    RigidBodyComponent keeping previous values, scattered by owning entity."""
    rb = dict(state.comp["RigidBodyComponent"])
    has_ent = (ps.entity >= 0) & ps.active & (ps.body_type != BODY_STATIC)
    target = torch.where(has_ent, ps.entity, state.alive.shape[0])
    rb["previous_translation"] = _scatter_rows(rb["previous_translation"], target, ps.prev_pos)
    rb["previous_rotation"] = _scatter_rows(rb["previous_rotation"], target, ps.prev_quat)
    rb["translation"] = _scatter_rows(rb["translation"], target, ps.pos)
    rb["rotation"] = _scatter_rows(rb["rotation"], target, ps.quat)
    comp = dict(state.comp)
    comp["RigidBodyComponent"] = rb
    return dataclasses.replace(state, comp=comp)


def physics_interpolate(state: SceneState, ps: PhysicsState, alpha) -> SceneState:
    """`physics_interpolate` (`Scene.cpp:753-768`): blend body pose into
    TransformComponent by the accumulator alpha; bodies without the
    interpolation flag snap to the current pose."""
    rb = state.comp["RigidBodyComponent"]
    mask = state.mask["RigidBodyComponent"] & state.alive
    interp = rb["interpolation"]
    pos_lerp = rb["previous_translation"] + (rb["translation"] - rb["previous_translation"]) * alpha
    rot_slerp = math3d.quat_slerp(rb["previous_rotation"], rb["rotation"], alpha)
    new_pos = torch.where(interp[:, None], pos_lerp, rb["translation"])
    new_rot = torch.where(interp[:, None], rot_slerp, rb["rotation"])
    t = dict(state.comp["TransformComponent"])
    t["position"] = torch.where(mask[:, None], new_pos, t["position"])
    t["rotation"] = torch.where(mask[:, None], new_rot, t["rotation"])
    comp = dict(state.comp)
    comp["TransformComponent"] = t
    return dataclasses.replace(state, comp=comp)


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def character_controller_update(state: SceneState, ps: PhysicsState, dt: Tensor) -> PhysicsState:
    """`character_controller_update` (`Scene.cpp:770-789`): drive character
    capsules from CharacterControllerComponent input (ground/air
    accelerate-decelerate model; jump when grounded)."""
    cc = state.comp["CharacterControllerComponent"]
    ent = torch.clamp(ps.entity, min=0).long()
    is_char = ps.is_character & ps.active
    g = lambda k: cc[k][ent]
    grounded = ps.ground_normal_y > 0.7  # ~45° max slope
    move_xz = g("move_input").clone()
    move_xz[:, 1] = 0.0
    move_len = _norm(move_xz)
    move_dir = move_xz / torch.clamp(move_len, min=1e-6)
    moving = move_len[:, 0] > 1e-3

    max_speed = torch.where(grounded, g("max_ground_speed"), g("max_air_speed"))
    accel = torch.where(grounded, g("ground_acceleration"), g("air_acceleration"))
    decel = torch.where(grounded, g("ground_deceleration"), g("air_deceleration"))

    v = ps.linvel
    v_xz = v.clone()
    v_xz[:, 1] = 0.0
    desired = move_dir * (max_speed * torch.clamp(move_len[:, 0], max=1.0))[:, None]
    rate = torch.where(moving, accel, decel)
    delta = desired - v_xz
    delta_len = _norm(delta)
    step_len = torch.minimum(delta_len, (rate * dt)[:, None])
    v_new_xz = v_xz + delta / torch.clamp(delta_len, min=1e-6) * step_len

    jumping = g("jump_input") & grounded
    v_y = torch.where(jumping, g("jump_force"), v[:, 1])
    new_v = torch.cat([v_new_xz[:, :1], v_y[:, None], v_new_xz[:, 2:3]], dim=-1)
    return dataclasses.replace(ps, linvel=torch.where(is_char[:, None], new_v, ps.linvel))


def sync_characters_to_components(state: SceneState, ps: PhysicsState) -> SceneState:
    """Copy character body pose and grounding back into
    CharacterControllerComponent; characters drive their TransformComponent."""
    cc = dict(state.comp["CharacterControllerComponent"])
    is_char = ps.is_character & ps.active & (ps.entity >= 0)
    target = torch.where(is_char, ps.entity, state.alive.shape[0])
    cc["previous_translation"] = _scatter_rows(cc["previous_translation"], target, ps.prev_pos)
    cc["translation"] = _scatter_rows(cc["translation"], target, ps.pos)
    cc["is_grounded"] = _scatter_rows(cc["is_grounded"], target, ps.ground_normal_y > 0.7)
    comp = dict(state.comp)
    comp["CharacterControllerComponent"] = cc
    mask = state.mask["CharacterControllerComponent"] & state.alive
    t = dict(comp["TransformComponent"])
    t["position"] = torch.where(mask[:, None], cc["translation"], t["position"])
    comp["TransformComponent"] = t
    return dataclasses.replace(state, comp=comp)


def sprite_animation_update(state: SceneState, dt: Tensor) -> SceneState:
    """`sprite_animation_update` (`Scene.cpp:988-1037`): advance animation clocks."""
    sa = dict(state.comp["SpriteAnimationComponent"])
    mask = state.mask["SpriteAnimationComponent"] & state.alive
    fps = sa["fps"].float()
    num = torch.clamp(sa["num_frames"].float(), min=1.0)
    zero = torch.zeros((), dtype=torch.float32, device=fps.device)
    duration = torch.where(fps > 0.0, num / torch.clamp(fps, min=1e-6), zero)
    t = sa["current_time"] + dt
    looped = torch.where(
        (duration > 0.0) & sa["loop"], torch.remainder(t, duration), torch.minimum(t, duration)
    )
    sa["current_time"] = torch.where(mask, looped, sa["current_time"])
    comp = dict(state.comp)
    comp["SpriteAnimationComponent"] = sa
    return dataclasses.replace(state, comp=comp)


def step_physics_accumulated(
    ps: PhysicsState, params: PhysicsParams, spec: SceneSpec, dt: Tensor, substep_fn=None
) -> tuple[PhysicsState, Tensor]:
    """Fixed-interval accumulator driving up to `max_substeps` 1/60 s substeps per
    frame (`Scene.cpp:720-729`). Returns (state, alpha). Reads the substep count
    on the host (one sync per frame) and calls `substep_fn` that many times;
    the default is `physics_substep` at the physics interval."""
    h = spec.physics_interval
    if substep_fn is None:
        substep_fn = lambda q: physics_substep(q, params, h)
    acc = ps.accumulator + dt
    nsub = int(torch.clamp(torch.floor(acc / h), max=spec.max_substeps))
    for _ in range(nsub):
        ps = substep_fn(ps)
    acc = acc - torch.tensor(float(nsub), dtype=torch.float32, device=acc.device) * h
    acc = torch.clamp(acc, max=h)  # spiral-of-death clamp
    ps = dataclasses.replace(ps, accumulator=acc)
    return ps, torch.clamp(acc / h, 0.0, 1.0)


def frame_step(
    state: SceneState,
    ps: PhysicsState,
    params: PhysicsParams,
    dt,
    spec: SceneSpec,
    has_bodies: bool = True,
    physics_mega: bool = False,
) -> tuple[SceneState, PhysicsState]:
    """Advance the whole scene by one frame. The physics substeps run
    `physics_substep`, or with `physics_mega=True` the compact kernel
    (`megakernel_substeps_compact`, one call per substep with `n_substeps=1`,
    as the JAX fused path does); `has_bodies=False` skips the physics stage."""
    dt = torch.as_tensor(dt, dtype=torch.float32, device=state.device)

    # --- OnUpdate: physics
    if has_bodies:
        ps = character_controller_update(state, ps, dt)
        substep_fn = None
        if physics_mega:
            substep_fn = lambda q: megakernel_substeps_compact(q, params, spec.physics_interval, n_substeps=1)
        ps, alpha = step_physics_accumulated(ps, params, spec, dt, substep_fn)
        state = sync_bodies_to_components(state, ps)
        state = sync_characters_to_components(state, ps)
        state = physics_interpolate(state, ps, alpha)

    # --- PostUpdate: simulation systems
    state = particle_update(state, spec, dt)
    state = sprite_animation_update(state, dt)

    # --- transform hierarchy → world matrices (+ previous roll)
    new_world = propagate_transforms(state, spec)
    state = dataclasses.replace(
        state, previous_world=state.world, world=new_world, time=state.time + dt, frame=state.frame + 1
    )
    return state, ps
