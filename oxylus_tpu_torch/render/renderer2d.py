"""2D render path: sprite queue assembly + tiled rasterization (counterpart of
`oxylus_tpu/render/renderer2d.py`).

Sprite instances come straight from the SceneState SoA (SpriteComponent mask
and world matrices); sprite animation UV windows are derived from the
animation clock. Particles ride the same sorted, tiled pass as billboards
(`render_2d_with_particles`), or draw as a depth-tested layer over a 3D frame
(`render_particles_3d`, the renderer's Forward2D stage). The raster is
`ops/raster2d.rasterize_sprites` with the blend kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..assets.material import FLAG_ALPHA_BLEND, GPUMaterials, empty_gpu_materials
from ..ops.raster2d import rasterize_sprites
from ..utils import math3d
from .camera import CameraMatrices

Tensor = torch.Tensor


@dataclasses.dataclass
class SpriteBatchBindings:
    """Device-resident bindings: the material table, the atlas and the
    per-entity material index map (rebuilt on asset/scene edits only)."""

    materials: GPUMaterials
    atlas: torch.Tensor                # (A, A, 4) uint8
    entity_material_idx: torch.Tensor  # (N,) i32 — sprite entity → material slot


def default_bindings(n_entities: int, capacity: int = 256, atlas_size: int = 64, device=None) -> SpriteBatchBindings:
    return SpriteBatchBindings(
        materials=empty_gpu_materials(capacity, device=device),
        atlas=torch.zeros((atlas_size, atlas_size, 4), dtype=torch.uint8, device=device),
        entity_material_idx=torch.zeros((n_entities,), dtype=torch.int32, device=device),
    )


def sprite_animation_uv(state, entity_idx: Tensor) -> tuple[Tensor, Tensor]:
    """Per-sprite UV window from SpriteAnimationComponent (`Scene.cpp:988-1037`):
    frame = floor(current_time * fps) on a `columns`-wide sheet; `inverted`
    plays backwards. Returns (uv_size (S, 2), uv_offset (S, 2)) applied on top
    of the material's own uv transform; identity without an animation."""
    sa = state.comp["SpriteAnimationComponent"]
    ix = (lambda a: a) if entity_idx.shape[0] == state.alive.shape[0] else (lambda a: a[entity_idx.long()])
    has = ix(state.mask["SpriteAnimationComponent"])
    num = torch.clamp(ix(sa["num_frames"]).to(torch.int64), min=1)
    fps = ix(sa["fps"]).to(torch.float32)
    cols = torch.clamp(ix(sa["columns"]).to(torch.int64), min=1)
    t = ix(sa["current_time"])
    frame = torch.floor(t * fps).to(torch.int64)
    frame = torch.minimum(torch.clamp(frame, min=0), num - 1)
    frame = torch.where(ix(sa["inverted"]), num - 1 - frame, frame)
    rows = torch.div(num + cols - 1, cols, rounding_mode="floor")
    fx = (frame % cols).to(torch.float32)
    fy = torch.div(frame, cols, rounding_mode="floor").to(torch.float32)
    size = torch.stack([1.0 / cols.to(torch.float32), 1.0 / rows.to(torch.float32)], dim=-1)
    offset = torch.stack([fx, fy], dim=-1) * size
    return (
        torch.where(has[:, None], size, torch.ones_like(size)),
        torch.where(has[:, None], offset, torch.zeros_like(offset)),
    )


def _per_sprite(mats: GPUMaterials, idx: Tensor, **override) -> GPUMaterials:
    """The material table gathered per sprite, with some fields replaced."""
    idx = idx.long()
    kw = {f.name: getattr(mats, f.name)[idx] for f in dataclasses.fields(mats)}
    kw.update(override)
    return GPUMaterials(**kw)


def render_2d(state, camera: CameraMatrices, bindings: SpriteBatchBindings, *, width: int, height: int,
              k_per_tile: int = 64) -> tuple[Tensor, Tensor]:
    """Rasterize all sprite entities. Returns (color (H, W, 4), visbuffer (H, W) i32)."""
    n = state.alive.shape[0]
    sp = state.comp["SpriteComponent"]
    mask = state.mask["SpriteComponent"] & state.alive
    entity_idx = torch.arange(n, dtype=torch.int32, device=state.alive.device)
    anim_size, anim_off = sprite_animation_uv(state, entity_idx)
    mat_idx = bindings.entity_material_idx.long()
    mats = bindings.materials
    per_sprite = _per_sprite(
        mats, mat_idx,
        uv_size=mats.uv_size[mat_idx] * anim_size,
        uv_offset=mats.uv_offset[mat_idx] + anim_off * mats.uv_size[mat_idx],
    )
    return rasterize_sprites(
        world=state.world, entity_id=entity_idx, layer=sp["layer"].to(torch.int32),
        sort_y=sp["sort_y"], flip_x=sp["flip_x"], valid=mask, view_proj=camera.view_projection,
        materials=per_sprite, atlas=bindings.atlas, width=width, height=height, k_per_tile=k_per_tile,
    )


# the emitter fields particle_render_data reads, with their widths
_PARTICLE_FIELDS = (
    ("start_color", 4), ("color_over_lifetime_enabled", 1),
    ("color_over_lifetime_start", 4), ("color_over_lifetime_end", 4),
    ("color_by_speed_min_speed", 1), ("color_by_speed_max_speed", 1),
    ("color_by_speed_enabled", 1), ("color_by_speed_start", 4),
    ("color_by_speed_end", 4), ("start_size", 4),
    ("size_over_lifetime_enabled", 1), ("size_over_lifetime_start", 3),
    ("size_over_lifetime_end", 3), ("size_by_speed_enabled", 1),
    ("size_by_speed_start", 3), ("size_by_speed_end", 3),
    ("rotation_over_lifetime_start", 4), ("rotation_over_lifetime_end", 4),
    ("rotation_over_lifetime_enabled", 1), ("start_rotation", 4),
)


def particle_render_data(state, camera: CameraMatrices | None = None):
    """Per-particle render instances from the pool: (world (P, 4, 4), tint
    (P, 4), valid (P,), emitter entity (P,)). Quads lie in the XY plane, or
    face the camera when `camera` is given. Over-lifetime colour, size and
    rotation are functions of age evaluated here (the reference mutates
    particle entities every frame, `Scene.cpp:859-959`; same curves)."""
    pool = state.particles
    psys = state.comp["ParticleSystemComponent"]
    em = torch.clamp(pool.emitter, min=0).long()

    cols, off, o = [], {}, 0
    for name, w in _PARTICLE_FIELDS:
        v = psys[name]
        cols.append(v.to(torch.float32)[:, None] if v.dim() == 1 else v[:, :w].to(torch.float32))
        off[name] = (o, o + w)
        o += w
    packed = torch.cat(cols, dim=1)[em]  # (P, F), one gather

    def g(k):
        lo, hi = off[k]
        out = packed[:, lo:hi]
        if hi - lo == 1:
            return out[:, 0] > 0.5 if k.endswith("enabled") else out[:, 0]
        return out

    frac = torch.clamp(pool.age / torch.clamp(pool.lifetime, min=1e-6), 0.0, 1.0)[:, None]
    speed = torch.sqrt(torch.sum(pool.vel * pool.vel, dim=-1, keepdim=True))

    color = g("start_color")
    col_live = torch.where(
        g("color_over_lifetime_enabled")[:, None],
        g("color_over_lifetime_start") + (g("color_over_lifetime_end") - g("color_over_lifetime_start")) * frac,
        torch.ones_like(color),
    )
    sp_t = torch.clamp(
        (speed - g("color_by_speed_min_speed")[:, None])
        / torch.clamp((g("color_by_speed_max_speed") - g("color_by_speed_min_speed"))[:, None], min=1e-6),
        0.0, 1.0,
    )
    col_speed = torch.where(
        g("color_by_speed_enabled")[:, None],
        g("color_by_speed_start") + (g("color_by_speed_end") - g("color_by_speed_start")) * sp_t,
        torch.ones_like(color),
    )
    color = color * col_live * col_speed

    size = g("start_size")[:, :3]
    size_live = torch.where(
        g("size_over_lifetime_enabled")[:, None],
        g("size_over_lifetime_start") + (g("size_over_lifetime_end") - g("size_over_lifetime_start")) * frac,
        torch.ones_like(size),
    )
    size_speed = torch.where(
        g("size_by_speed_enabled")[:, None],
        g("size_by_speed_start") + (g("size_by_speed_end") - g("size_by_speed_start")) * sp_t,
        torch.ones_like(size),
    )
    size = size * size_live * size_speed

    rot = math3d.quat_slerp(g("rotation_over_lifetime_start"), g("rotation_over_lifetime_end"), frac[:, 0])
    rot = torch.where(g("rotation_over_lifetime_enabled")[:, None], rot, g("start_rotation"))

    world = math3d.trs_to_mat4(pool.pos, rot, size)
    if camera is not None:
        # billboard: the rotation block becomes the camera basis, scaled
        basis = torch.stack([camera.right, camera.up, camera.forward], dim=-1)  # (3, 3) columns
        world[:, :3, :3] = basis[None, :, :] * size[:, None, :]
    return world, color, pool.alive, pool.emitter


def _particle_material_fields(color: Tensor) -> dict:
    """Particles' per-record material fields: tint, no cutoff, alpha blend, no
    texture, the identity uv window."""
    m, dev = color.shape[0], color.device
    return dict(
        albedo_color=color,
        alpha_cutoff=torch.zeros(m, dtype=torch.float32, device=dev),
        flags=torch.full((m,), FLAG_ALPHA_BLEND, dtype=torch.int32, device=dev),
        uv_size=torch.ones((m, 2), dtype=torch.float32, device=dev),
        uv_offset=torch.zeros((m, 2), dtype=torch.float32, device=dev),
        albedo_rect=torch.zeros((m, 4), dtype=torch.float32, device=dev),
        sampling_mode=torch.zeros(m, dtype=torch.int32, device=dev),
    )


def render_2d_with_particles(state, camera: CameraMatrices, bindings: SpriteBatchBindings, *, width: int,
                             height: int, k_per_tile: int = 64, billboard: bool = False,
                             stats: dict | None = None) -> tuple[Tensor, Tensor]:
    """Sprites + particle billboards in one sorted, tiled pass (the reference
    feeds particles through the same RenderQueue2D,
    `RendererInstance.cpp:1336-1395`); particles sort after every sprite
    layer. Returns (color (H, W, 4), visbuffer (H, W) i32); `stats` as
    `rasterize_sprites` fills it."""
    n = state.alive.shape[0]
    dev = state.alive.device
    sp = state.comp["SpriteComponent"]
    sprite_mask = state.mask["SpriteComponent"] & state.alive
    entity_idx = torch.arange(n, dtype=torch.int32, device=dev)
    anim_size, anim_off = sprite_animation_uv(state, entity_idx)
    mats = bindings.materials
    mat_idx = bindings.entity_material_idx.long()

    p_world, p_color, p_valid, p_emitter = particle_render_data(state, camera if billboard else None)
    m = p_world.shape[0]
    cat = lambda a, b: torch.cat([a, b], dim=0)
    uv_size = mats.uv_size[mat_idx]
    sprite_fields = dict(
        albedo_color=mats.albedo_color[mat_idx], alpha_cutoff=mats.alpha_cutoff[mat_idx],
        flags=mats.flags[mat_idx].to(torch.int32), uv_size=uv_size * anim_size,
        uv_offset=mats.uv_offset[mat_idx] + anim_off * uv_size, albedo_rect=mats.albedo_rect[mat_idx],
        sampling_mode=torch.zeros(n, dtype=torch.int32, device=dev),
    )
    part_fields = _particle_material_fields(p_color)
    combined = _per_sprite(mats, torch.zeros(n + m, dtype=torch.int64, device=dev),
                           **{k: cat(v, part_fields[k]) for k, v in sprite_fields.items()})
    return rasterize_sprites(
        world=cat(state.world, p_world),
        entity_id=cat(entity_idx, p_emitter.to(torch.int32)),
        layer=cat(sp["layer"].to(torch.int32), torch.full((m,), 1 << 20, dtype=torch.int32, device=dev)),
        sort_y=cat(sp["sort_y"], torch.zeros(m, dtype=torch.bool, device=dev)),
        flip_x=cat(sp["flip_x"], torch.zeros(m, dtype=torch.bool, device=dev)),
        valid=cat(sprite_mask, p_valid),
        view_proj=camera.view_projection, materials=combined, atlas=bindings.atlas,
        width=width, height=height, k_per_tile=k_per_tile, stats=stats,
    )


def render_particles_3d(state, camera: CameraMatrices, scene_depth: Tensor, atlas: Tensor, materials, *, width: int,
                        height: int, k_per_tile: int = 64) -> Tensor:
    """Particle billboards as a depth-tested premultiplied RGBA layer (H, W, 4)
    over a 3D frame: the reference's Forward2D stage feeding particles through
    the sprite queue after PBR (`RendererInstance.cpp:945-1088`, `:1336-1395`).
    Billboards face the camera, sort back to front, blend, and are
    depth-tested (reverse-Z, no write) against the opaque scene depth."""
    p_world, p_color, p_valid, p_emitter = particle_render_data(state, camera)
    m, dev = p_world.shape[0], p_world.device
    part_mats = _per_sprite(materials, torch.zeros(m, dtype=torch.int64, device=dev),
                            **_particle_material_fields(p_color))
    color, _vis = rasterize_sprites(
        world=p_world, entity_id=p_emitter.to(torch.int32), layer=torch.zeros(m, dtype=torch.int32, device=dev),
        sort_y=torch.zeros(m, dtype=torch.bool, device=dev), flip_x=torch.zeros(m, dtype=torch.bool, device=dev),
        valid=p_valid, view_proj=camera.view_projection, materials=part_mats, atlas=atlas,
        width=width, height=height, k_per_tile=k_per_tile, scene_depth=scene_depth,
    )
    return color


def build_entity_material_map(scene, uuid_to_slot: dict[str, int]) -> np.ndarray:
    """Host: map each entity's SpriteComponent.material UUID to a material slot."""
    from ..core import uuid as uuidlib

    n = scene.spec.padded_entities()
    out = np.zeros(n, np.int32)
    mat = scene._comp_data["SpriteComponent"]["material"]
    mask = scene._comp_mask["SpriteComponent"]
    for i in range(n):
        if mask[i]:
            out[i] = uuid_to_slot.get(uuidlib.u64_pair_to_uuid(mat[i][0], mat[i][1]), 0)
    return out
