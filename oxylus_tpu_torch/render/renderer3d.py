"""RendererInstance: the per-scene frame graph of the 3D path (counterpart of
`oxylus_tpu/render/renderer3d.py`).

A fixed stage sequence with injectable before/after callbacks per stage and a
named-resource dict passed between stages. It runs: culling (instance cull +
LOD, meshlet expansion, meshlet cull sorted nearest first), triangle setup, the
G-buffer raster with the two-pass HiZ occlusion protocol (early pass
against the previous frame's pyramid, pyramid rebuild, late pass for what was
revealed, merge, second rebuild) on one of two routes, G-buffer unpack, the atmosphere (sky LUTs
cached per `AtmosphereParams`, sky-view LUT, background and SH-2 ambient),
page-cached clipmap shadows with their resolve and contact shadows, GTAO,
PBR lighting, SSR, aerial perspective, the Forward2D particle composite
(a quarter-resolution billboard layer through the sprite blend kernel,
depth-tested against the scene, upsampled and blended over the lit frame),
bloom, tonemap and FXAA. Everything runs eagerly on the tensors' device.

The raster routes (`RenderSpec.raster_path`): "tile" (the default) bins each
pass's triangles per tile and rasters them with `raster3d` (vid = tile·256 +
entry, slot tables per (tile, entry)); "group" re-groups each pass's triangles
into dense groups (`compact_triangles`, or the source meshlets with
`compact_raster=False`), bins the groups per tile and rasters them with
`raster_groups` (vid = group·256 + slot, slot tables per dense slot, the late
pass's vids after the early pass's groups). With `RenderSpec(use_pallas=False)`
the frame takes the JAX package's decode path instead, the path its goldens
were made on: each pass bins the visible meshlets to 64-px tiles
(`bin_meshlets_to_tiles`), rasters depth and vid = (vm << 8) | slot with
`raster3d.rasterize_reference`, and `ops/decode3d.decode_visbuffer` rebuilds
the G-buffer from the vids, sampling every texture kind at full rate whatever
`textured` says; that path runs no masked pass and sets no slot tables. HiZ
and the shadows' depth raster run their kernels on every path.

The JAX graph's device-side branches (`lax.cond` / `lax.switch`) are host
decisions here, taken the same way. Host reads per frame: one at the top
(the light count, and whether the static-frame key, the sun, the view and
the aerial key moved since the carried frame), with occlusion one for
whether anything was revealed, and with shadows one for the six clipmap
levels' branches (`render/shadows.py`).

Texturing and alpha masks (the tile and group routes). With `textured`, a
pixel resolves its 32-lane material row (`sampling.pack_material_tables`;
rounded to float16 on the tile route, as the JAX tile route's slot rows are,
and float32 on the group route, as the JAX group route's are) through its
slot's material, at the route's slot stride. The
G-buffer is then textured from the packed
bfloat16 atlas taps (`ops/sampling.py`): albedo and the tangent-space normal
sampled at half resolution, metallic-roughness with its shared-rect occlusion
and emissive at quarter resolution from the quarter-resolution vids, each
rate upsampled linearly in one packed call, then the normal perturbed at full
resolution; `texture_features` picks the kinds. With `alpha_masked`, the
opaque passes leave out the meshlets whose material has FLAG_ALPHA_MASK, and
those raster in their own pass (K2 `tris_per_tile_masked`, `bin_groups_masked`
groups, its tables stride-padded to the global K2): its nearest fragment
samples its albedo alpha at half resolution, the margin alpha − cutoff is
upsampled linearly, and the fragment wins a pixel where the margin is ≥ 0 and
it is nearer than the opaque result. Its vids follow every earlier pass's
groups (seg·256), and its tables are concatenated after theirs. Only the
nearest masked fragment resolves, and masked geometry stays out of the HiZ
pyramid, as in the JAX package.

The static-frame memo reuses the shadow term, AO and the aerial apply on
frames whose key (an xor of the world matrices' bit patterns, the sun, the
camera's position, forward and up) equals the carried one. The key leaves out
the camera's intrinsics and collides on swapped transforms, as in the JAX
package (`tests/test_torch_render3d.py` names both).

`config.debug_view` replaces the final image after FXAA with
`debugviews.apply_debug_view` of the frame's ctx, as in the JAX renderer.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable

import torch

from ..assets.material import FLAG_ALPHA_MASK
from ..ops import hiz as hiz_ops
from ..ops import raster3d, raster_depth, raster_groups
from ..ops import sampling
from ..ops.cull import cull_instances, cull_meshlets, expand_meshlet_instances
from ..ops.decode3d import decode_visbuffer
from ..ops.setup3d import (
    bin_meshlets_to_tiles,
    bin_triangles_per_tile,
    compact_triangles,
    passthrough_bounds,
    passthrough_groups,
    setup_triangles,
)
from ..utils import math3d
from ..utils.imgops import point_downsample as _pds
from ..utils.imgops import resize_linear
from . import gtao as gtao_ops
from . import shadows
from . import sky
from .camera import CameraMatrices
from .debugviews import apply_debug_view
from .pbr import apply_pbr, lights_from_state
from .postfx import adapt_exposure, apply_bloom, apply_fxaa, apply_tonemap, luminance_histogram
from .renderer2d import render_particles_3d
from .ssr import apply_ssr

Tensor = torch.Tensor

METERS_PER_KM = 50.0  # aerial perspective: game-scale worlds, 50 units ≈ 1 km of air


class RenderStage(enum.Enum):
    INITIALIZATION = "Initialization"
    CULLING = "Culling"
    VISBUFFER_ENCODE = "VisBufferEncode"
    VISBUFFER_DECODE = "VisBufferDecode"
    FORWARD_2D = "Forward2D"
    LIGHTING = "Lighting"
    POST_PROCESSING = "PostProcessing"
    ATMOSPHERE = "Atmosphere"
    DEBUG = "Debug"
    FINAL_OUTPUT = "FinalOutput"


StageCallback = Callable[[dict], dict]


@dataclasses.dataclass(frozen=True)
class RenderSpec:
    """Static capacities (defaults = the JAX package's)."""

    width: int = 1920
    height: int = 1080
    max_meshlet_instances: int = 1 << 13
    max_visible_meshlets: int = 4096
    meshlets_per_tile: int = 64
    use_pallas: bool = True      # the G-buffer raster; False: the decode path (rasterize_reference, decode_visbuffer)
    tile: int = 64               # the tile route takes 16, 32 or 64; the group route 32 or 64
    raster_group: int = 64       # slots per dense group (group route, compact_raster; ≤ 128)
    compact_raster: bool = True  # group route: compact_triangles, else the source meshlets as groups
    raster_path: str = "tile"    # "tile": per-tile triangle lists (raster3d); "group": group lists (raster_groups)
    tris_per_tile: int = 256     # entries per tile (multiple of 64, ≤ 256)
    bin_groups_per_tile: int = 64
    tris_per_tile_masked: int = 128
    bin_groups_masked: int = 16
    tris_per_tile_late: int = 128  # the late occlusion pass's reduced capacities
    bin_groups_late: int = 32


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to oxylus_tpu_torch yet")


def world_signature(world: Tensor) -> Tensor:
    """The xor of every int32 bit pattern of `world`, as a 0-d int32 tensor
    (bit b of the result is the parity of bit b over all words)."""
    bits = world.contiguous().view(torch.int32).reshape(-1)
    shifts = torch.arange(32, dtype=torch.int32, device=world.device)
    parity = ((bits[:, None] >> shifts) & 1).sum(0) & 1
    val = (parity << shifts.to(torch.int64)).sum()  # [0, 2^32)
    return ((val + 2**31) % 2**32 - 2**31).to(torch.int32)


def static_frame_key(world: Tensor, sun_dir: Tensor, camera: CameraMatrices) -> Tensor:
    """(13,) f32: the world signature's bits as a float, the sun, and the
    camera's position, forward and up."""
    sig = world_signature(world).reshape(1).view(torch.float32)
    return torch.cat([sig, sun_dir, camera.position, camera.forward, camera.up])


def _textured_rows(materials) -> Tensor:
    """The (M, 32) material rows as the textured route reads them: rounded
    to float16, as the JAX package stores its per-slot rows."""
    return sampling.pack_material_tables(materials).half().float()


def texture_gbuffer(gbuffer: dict, vid: Tensor, slot_material: Tensor, n_slots_r: int, rows: Tensor,
                    taps: Tensor, atlas_size: int, features: tuple) -> dict:
    """The G-buffer with the material textures applied: albedo and normal
    sampled at half resolution, metallic-roughness (with the shared-rect
    occlusion) and emissive at quarter resolution from the
    quarter-resolution vids, each rate upsampled linearly in one packed
    call, the normal perturbed at full resolution. `rows` are the (M, 32)
    material rows (`_textured_rows`)."""
    h, w = vid.shape
    n_tab = slot_material.shape[0]

    def slot_rows_at(vid_img: Tensor) -> Tensor:
        # vid = group·256 + slot; a miss gathers slot 0's row (masked below)
        flat = torch.clamp((vid_img >> 8) * n_slots_r + (vid_img & 255), 0, n_tab - 1).reshape(-1).long()
        return rows[slot_material[flat].long()]

    uv_h = _pds(gbuffer["uv"], 2).reshape(-1, 2)
    vid_h = _pds(vid, 2)
    h2, w2 = vid_h.shape
    hi_feats = tuple(f for f in features if f in ("albedo", "normal"))
    lo_feats = tuple(f for f in features if f in ("mr", "emissive"))
    tex = sampling.sample_material_textures(slot_rows_at(vid_h), taps, atlas_size, uv_h, features=hi_feats)
    valid_h = (vid_h >= 0).reshape(-1, 1)
    out = dict(gbuffer)
    hi_parts, hi_lanes = [], {}
    if "albedo" in hi_feats:
        hi_lanes["albedo"] = 0
        hi_parts.append(torch.where(valid_h, tex["albedo_rgb"], 1.0))
    if "normal" in hi_feats:
        hi_lanes["normal"] = sum(p.shape[-1] for p in hi_parts)
        flat_n = torch.tensor([0.0, 0.0, 1.0], device=vid.device)
        hi_parts.append(torch.where(valid_h, tex["normal_ts"], flat_n))
    if hi_parts:
        hc = sum(p.shape[-1] for p in hi_parts)
        hi_full = resize_linear(torch.cat(hi_parts, -1).reshape(h2, w2, hc), (h, w, hc))
    if lo_feats:
        vid_q = _pds(vid, 4)
        hq, wq = vid_q.shape
        tex_q = sampling.sample_material_textures(slot_rows_at(vid_q), taps, atlas_size,
                                                  _pds(gbuffer["uv"], 4).reshape(-1, 2), features=lo_feats)
        valid_q = (vid_q >= 0).reshape(-1, 1)
        lo_parts, lo_lanes = [], {}
        if "mr" in lo_feats:
            lo_lanes["mr"], lo_lanes["occ"] = 0, 2
            lo_parts += [torch.where(valid_q, tex_q["mr"], 1.0), torch.where(valid_q, tex_q["occlusion"], 1.0)]
        if "emissive" in lo_feats:
            lo_lanes["emissive"] = sum(p.shape[-1] for p in lo_parts)
            lo_parts.append(torch.where(valid_q, tex_q["emissive_rgb"], 1.0))
        lc = sum(p.shape[-1] for p in lo_parts)
        lo_full = resize_linear(torch.cat(lo_parts, -1).reshape(hq, wq, lc), (h, w, lc))
    if "albedo" in features:
        o = hi_lanes["albedo"]
        out["albedo"] = gbuffer["albedo"] * hi_full[..., o : o + 3]
    if "mr" in features:
        o = lo_lanes["mr"]
        out["metallic"] = gbuffer["metallic"] * lo_full[..., o]
        out["roughness"] = gbuffer["roughness"] * lo_full[..., o + 1]
        out["occlusion"] = gbuffer["occlusion"] * lo_full[..., lo_lanes["occ"]]
    if "emissive" in features:
        o = lo_lanes["emissive"]
        out["emissive"] = gbuffer["emissive"] * lo_full[..., o : o + 3]
    if "normal" in features:
        # the detail is sampled at half resolution, the frame it perturbs is full resolution
        o = hi_lanes["normal"]
        out["normal"] = torch.where(
            gbuffer["hit"][..., None],
            sampling.perturb_normal(gbuffer["normal"], gbuffer["tangent"], hi_full[..., o : o + 3]),
            gbuffer["normal"],
        )
    return out


def alpha_mask_merge(depth: Tensor, vid: Tensor, gb_img: Tensor, masked: tuple, seg: int, n_slots_r: int,
                     rows: Tensor, taps: Tensor, atlas_size: int) -> tuple[Tensor, Tensor, Tensor]:
    """The masked pass's per-pixel cutoff and merge: its nearest fragment's
    albedo alpha sampled at half resolution, the margin alpha − cutoff
    upsampled linearly, and the fragment taken where the margin is ≥ 0 and it
    is nearer than the opaque result. `masked` is the pass's (depth, vid, gb,
    bin_overflow, slot tables); its tables follow the `seg` groups of the
    earlier passes', so a taken vid moves up by seg·256. `rows` are the
    (M, 32) material rows, rounded to float16 on the textured route as the
    textured G-buffer reads them. Returns the merged (depth, vid, gb)."""
    d_m, v_m, gb_m, _ov, tabs_m = masked
    h, w = depth.shape
    uv_mh = _pds(gb_m[..., 3:5].to(torch.float32), 2).reshape(-1, 2)
    v_mh = _pds(v_m, 2)
    mh2, mw2 = v_mh.shape
    flat_mh = torch.clamp((v_mh >> 8) * n_slots_r + (v_mh & 255), 0, tabs_m[0].shape[0] - 1).reshape(-1).long()
    rows_m = rows[tabs_m[0][flat_mh].long()]
    tex_m = sampling.sample_material_textures(rows_m, taps, atlas_size, uv_mh, features=("albedo",))
    # the signed alpha margin, upsampled to full resolution: smooth cutout edges
    margin_h = torch.where(v_mh.reshape(-1) >= 0, tex_m["alpha"][..., 0] - rows_m[..., 25], -1.0)
    alpha_ok = resize_linear(margin_h.reshape(mh2, mw2), (h, w)) >= 0.0
    use_m = (v_m >= 0) & alpha_ok & (d_m > depth)
    return (torch.where(use_m, d_m, depth), torch.where(use_m, v_m + seg * 256, vid),
            torch.where(use_m[..., None], gb_m, gb_img))


@dataclasses.dataclass
class RendererInstance:
    spec: RenderSpec
    stage_callbacks: dict[tuple[RenderStage, str], list[StageCallback]] = dataclasses.field(default_factory=dict)
    _sky_cache: dict = dataclasses.field(default_factory=dict)  # AtmosphereParams → (transmittance, multiscatter)

    def sky_luts(self, atmosphere, device) -> tuple[Tensor, Tensor]:
        """The transmittance and multiple-scattering LUTs of `atmosphere`,
        built once and cached."""
        if atmosphere not in self._sky_cache:
            t_lut = sky.transmittance_lut(atmosphere, device=device)
            self._sky_cache[atmosphere] = (t_lut, sky.multiscatter_lut(atmosphere, t_lut))
        return self._sky_cache[atmosphere]

    def add_stage_callback(self, stage: RenderStage, when: str, cb: StageCallback) -> None:
        """Inject a pass before/after a stage."""
        if when not in ("before", "after"):
            raise ValueError(f"when={when!r}: 'before' or 'after'")
        self.stage_callbacks.setdefault((stage, when), []).append(cb)

    def _run_cbs(self, stage: RenderStage, when: str, ctx: dict) -> dict:
        for cb in self.stage_callbacks.get((stage, when), []):
            ctx = cb(ctx)
        return ctx

    def render(
        self,
        state,
        gscene,
        camera: CameraMatrices,
        materials,
        atlas: Tensor,
        config,
        prev: dict | None = None,
        ambient_color: Tensor | None = None,
        background: Tensor | None = None,
        atmosphere=None,
        enable_shadows: bool = False,
        enable_gtao: bool | None = None,
        sun_intensity: float = 10.0,
        first_clipmap_width: float = 10.0,
        textured: bool = False,
        texture_features: tuple = sampling.FEATURES,
        particles: bool = False,
        alpha_masked: bool = False,
        static_lights: int = 8,
        binning_stats: bool = False,
    ) -> dict:
        """Run the frame graph. Returns the resource dict (final image in
        "final", carried state under "carry" — feed it back as `prev`).
        `textured` samples the material textures of `texture_features`
        (albedo, normal, mr, emissive) on the G-buffer; `alpha_masked` rasters
        the alpha-masked materials in their own pass (both raster routes; the
        decode path takes neither: it samples every kind, masks none).
        `binning_stats` adds "bin_pairs", the (tile, entry) pairs every pass
        binned, to the returned dict (a device tensor)."""
        spec = self.spec
        if enable_gtao is None:
            enable_gtao = config.vbgtao_enable
        if spec.raster_path not in ("tile", "group"):
            raise _not_ported(f"raster_path={spec.raster_path!r}")
        w, h = spec.width, spec.height
        dev = state.device
        prev = prev or {}
        carry: dict[str, Any] = {}

        ctx: dict[str, Any] = {
            "state": state, "gscene": gscene, "camera": camera, "materials": materials, "atlas": atlas,
            "config": config, "width": w, "height": h,
        }
        ctx = self._run_cbs(RenderStage.INITIALIZATION, "after", ctx)
        world = state.world
        lights = lights_from_state(state)
        # the first directional light drives the sun and the shadows
        is_dir = (lights.kind == 0) & lights.valid
        sun_dir = torch.where(torch.any(is_dir), lights.direction[torch.argmax(is_dir.to(torch.int32))],
                              torch.tensor([0.0, -1.0, 0.0], device=dev))
        is_persp = torch.abs(camera.projection[3, 2]) > 1e-8
        inv_tan_half = torch.where(is_persp, torch.abs(camera.projection[1, 1]), 1.0)

        # The frame's keys, and the one host read that takes every decision
        # whose inputs are ready now: the light count, whether the static-frame
        # key changed (None on a frame without it), and whether the sky LUT,
        # the background and the aerial LUT must be recomputed. Each moved flag
        # is True where the carried frame lacks the entry.
        static_key_now = static_frame_key(world, sun_dir, camera)
        carry["static_term_key"] = static_key_now
        asks = {"static": ("static_term_key",)}
        keys = {"static": static_key_now}
        if atmosphere is not None:
            si = torch.as_tensor(sun_intensity, dtype=torch.float32, device=dev).reshape(1)
            sky_key_now = torch.cat([sun_dir, si])
            cam_h_km = camera.position[1] / METERS_PER_KM
            keys.update(
                sky=sky_key_now, amb=sky_key_now,
                bg=torch.cat([sky_key_now, camera.forward, camera.right, camera.up]),
                aerial=torch.cat([sky_key_now, torch.round(cam_h_km * 16.0).reshape(1)]),
            )
            asks.update(sky=("sky_view_lut", "sky_key"), amb=("sky_ambient", "sky_key"),
                        bg=("sky_background", "sky_cam_key"), aerial=("aerial_lut", "aerial_key"))
        prev_key = {"static": "static_term_key", "sky": "sky_key", "amb": "sky_key", "bg": "sky_cam_key",
                    "aerial": "aerial_key"}
        flags = [lights.count.reshape(1).to(torch.int64)]
        names = []
        for name, need in asks.items():
            if all(k in prev for k in need):
                old = prev[prev_key[name]]
                moved = torch.any(old != keys[name]) if name == "static" else torch.any(torch.abs(keys[name] - old) > 1e-7)
                flags.append(moved.reshape(1).to(torch.int64))
                names.append(name)
        host = torch.cat(flags).tolist()
        live_lights = host[0]
        moved = {name: True for name in asks}
        moved.update({name: bool(v) for name, v in zip(names, host[1:])})
        static_dirty = moved["static"] if "static" in names else None

        # ---- Culling ------------------------------------------------------
        ctx = self._run_cbs(RenderStage.CULLING, "before", ctx)
        proj_scale = h * inv_tan_half / 2.0
        vis, lod = cull_instances(
            gscene, world, camera.frustum_planes, camera.position, proj_scale, frustum_enabled=config.culling_frustum
        )
        mi_inst, mi_ml, mi_valid, expand_overflow = expand_meshlet_instances(
            gscene, vis, lod, spec.max_meshlet_instances, with_overflow=True
        )
        vm_inst, vm_ml, vm_valid, vm_count = cull_meshlets(
            gscene, world, mi_inst, mi_ml, mi_valid, camera.frustum_planes, camera.position,
            capacity=spec.max_visible_meshlets, frustum_enabled=config.culling_frustum,
            depth_sort=True,  # front-to-back tile lists → raster early-out
        )
        ctx.update(vm_instance=vm_inst, vm_meshlet=vm_ml, vm_valid=vm_valid, vm_count=vm_count)
        ctx = self._run_cbs(RenderStage.CULLING, "after", ctx)

        # ---- VisBuffer encode (two-pass occlusion protocol) ---------------
        setup = setup_triangles(
            gscene, world, vm_inst, vm_ml, vm_valid, camera.view_projection, w, h,
            backface_enabled=config.culling_triangle,
        )
        # the G-buffer raster (tile or group route), or the decode path: the
        # JAX package's XLA raster and full-rate decode, which samples every
        # texture kind and runs no masked pass
        use_gbuffer_raster = spec.use_pallas
        textured = textured and use_gbuffer_raster
        alpha_masked = alpha_masked and use_gbuffer_raster
        # the slot tables' stride: per (tile, entry) on the tile route, per dense group slot on the group route
        use_tile_raster = spec.raster_path == "tile"
        if use_tile_raster:
            n_slots_r = spec.tris_per_tile
        else:
            n_slots_r = spec.raster_group if spec.compact_raster else setup["tri_valid"].shape[1]
        if use_gbuffer_raster:
            mat_idx = gscene.inst_material[vm_inst.long()].long()
            # the opaque passes leave out the meshlets whose material is alpha-masked
            is_masked_vm = (materials.flags[mat_idx] & FLAG_ALPHA_MASK) > 0 if alpha_masked else None
            opaque_f = ~is_masked_vm if alpha_masked else None
            consts_m = torch.cat(
                [materials.albedo_color[:, :3], materials.metallic_factor[:, None],
                 materials.roughness_factor[:, None], materials.emissive_color],
                dim=1,
            )  # (M, 8) material-indexed constants
        else:
            opaque_f = None
            coeff_mat = raster_depth.pack_coeff_matrix(setup["coeffs"], setup["tri_valid"])
        if use_gbuffer_raster and use_tile_raster:
            # the per-slot row matrix is built once from the full visible set and
            # shared by the passes (a pass's entries only reference its valid slots)
            dense_full = passthrough_groups(setup, setup["tri_valid"], mat_idx, vm_inst)
            comb = raster3d.build_tile_comb(dense_full, consts_m[dense_full["slot_material"].long()])
        # the packed atlas taps and material rows the masked pass and the textured
        # G-buffer sample: on the tile route rounded to float16 where textured, as
        # the JAX tile route's slot rows are; the JAX group route gathers float32 rows
        taps = sampling.pack_atlas_taps(atlas, dtype=torch.bfloat16) if textured or alpha_masked else None
        mat_rows = None
        if textured and use_tile_raster:
            mat_rows = _textured_rows(materials)
        elif textured or alpha_masked:
            mat_rows = sampling.pack_material_tables(materials)
        pass_pairs: list[Tensor] = []  # with binning_stats, each pass's binned (tile, entry) pairs

        def raster_pass(vis_mask: Tensor, tri_filter: Tensor | None = None, k2: int | None = None,
                        k_groups: int | None = None):
            """One G-buffer raster pass → (depth, vid, gb, bin_overflow, slot
            tables): on the tile route stride-padded to the global entry
            stride; on the group route per dense slot of the pass's groups,
            whose capacities `k2` and `k_groups` do not touch. `tri_filter`
            (VM,) keeps a subset of the meshlets (the opaque / masked split)."""
            tri_mask = setup["tri_valid"] & vis_mask[:, None]
            if tri_filter is not None:
                tri_mask = tri_mask & tri_filter[:, None]
            if not use_tile_raster:
                if spec.compact_raster:
                    dense = compact_triangles(setup, tri_mask, mat_idx, vm_inst, group=spec.raster_group,
                                              width=float(w), height=float(h))
                else:
                    dense = passthrough_groups(setup, tri_mask, mat_idx, vm_inst)
                rows = raster3d.build_tile_comb(dense, consts_m[dense["slot_material"].long()])
                near_eo = torch.flip(torch.cummax(torch.flip(dense["ml_near"], [0]), 0).values, [0])
                tile_list, ov = bin_meshlets_to_tiles(dense, w, h, spec.tile, spec.meshlets_per_tile)
                if binning_stats:
                    pass_pairs.append((tile_list >= 0).sum())
                d, v, gb = raster_groups.rasterize_gbuffer_groups(rows, tile_list, w, h, n_slots_r, ml_near=near_eo,
                                                                  tile=spec.tile)
                tables = tuple(dense[k].reshape(-1).to(torch.int32)
                               for k in ("slot_material", "slot_instance", "packed_id"))
                return d, v, gb, ov, tables
            k2_p = k2 or spec.tris_per_tile
            bounds = passthrough_bounds(setup, tri_mask)
            entries, cnts, ov = bin_triangles_per_tile(bounds, w, h, spec.tile, k_groups or spec.bin_groups_per_tile, k2_p)
            if binning_stats:
                pass_pairs.append(cnts.sum())
            blocks = raster3d.pack_tile_blocks(entries, comb)
            d, v, gb = raster3d.rasterize_gbuffer_tiles(blocks, cnts, w, h, tile=spec.tile)
            tables = blocks["tables"]
            if k2_p != n_slots_r:
                # stride-pad to the global entry stride so flat = (vid >> 8)·K2 + entry
                # indexes the concatenated passes' tables uniformly
                def pad_tab(t: Tensor, fill: int) -> Tensor:
                    t2 = t.reshape(-1, k2_p)
                    return torch.nn.functional.pad(t2, (0, n_slots_r - k2_p), value=fill).reshape(-1)

                tables = tuple(pad_tab(t, -1 if i == 2 else 0) for i, t in enumerate(tables))
            return d, v, gb, ov, tables

        def decode_pass(vis_mask: Tensor, tri_filter: Tensor | None = None, k2: int | None = None,
                        k_groups: int | None = None):
            """One pass of the decode path → (depth, vid, None, bin_overflow,
            None): the visible meshlets binned to 64-px tiles by their screen
            bounds, rastered by `rasterize_reference`; vid = (vm << 8) | slot."""
            masked = dict(setup)
            masked["ml_xmax"] = torch.where(vis_mask, setup["ml_xmax"], -1e9)
            masked["ml_xmin"] = torch.where(vis_mask, setup["ml_xmin"], 1e9)
            tile_list, ov = bin_meshlets_to_tiles(masked, w, h, raster3d.TILE, spec.meshlets_per_tile)
            if binning_stats:
                pass_pairs.append((tile_list >= 0).sum())
            d, v = raster3d.rasterize_reference(coeff_mat, tile_list, w, h)
            return d, v, None, ov, None

        run_pass = raster_pass if use_gbuffer_raster else decode_pass

        # conservative nearest depth per meshlet for occlusion testing
        ml_near = torch.where(setup["tri_valid"], setup["sxyz"][..., 2].max(-1).values, -1.0).max(-1).values
        bounds4 = (setup["ml_xmin"], setup["ml_xmax"], setup["ml_ymin"], setup["ml_ymax"])

        use_occlusion = config.culling_occlusion and "hiz" in prev
        if use_occlusion:
            early_vis = hiz_ops.occlusion_test(prev["hiz"], *bounds4, ml_near, w, h) & vm_valid
            depth, vid, gb_img, overflow, slot_tables = run_pass(early_vis, opaque_f)
            hiz = hiz_ops.build_hiz(depth)
            late_vis = hiz_ops.occlusion_test(hiz, *bounds4, ml_near, w, h) & vm_valid & ~early_vis
            # the late pass exists only when something was revealed this frame
            if bool(late_vis.any()):
                d2, v2, gb2, overflow2, tables2 = run_pass(
                    late_vis, opaque_f,
                    k2=min(spec.tris_per_tile_late, spec.tris_per_tile),
                    k_groups=min(spec.bin_groups_late, spec.bin_groups_per_tile),
                )
                if slot_tables is not None:
                    # late vids index the second half of the combined slot tables
                    groups_per_pass = tables2[0].shape[0] // n_slots_r
                    v2 = torch.where(v2 >= 0, v2 + groups_per_pass * 256, v2)
                better = d2 > depth
                depth = torch.where(better, d2, depth)
                vid = torch.where(better, v2, vid)
                if gb_img is not None:
                    gb_img = torch.where(better[..., None], gb2, gb_img)
                hiz = hiz_ops.build_hiz(depth)
            else:
                overflow2 = torch.zeros((), dtype=torch.int32, device=dev)
                tables2 = None if slot_tables is None else tuple(torch.zeros_like(t) for t in slot_tables)
            if slot_tables is not None:
                slot_tables = tuple(torch.cat([a, b]) for a, b in zip(slot_tables, tables2))
            carry["hiz"] = hiz
            overflow = overflow + overflow2
        else:
            depth, vid, gb_img, overflow, slot_tables = run_pass(vm_valid, opaque_f)
            if config.culling_occlusion:
                carry["hiz"] = hiz_ops.build_hiz(depth)

        # ---- alpha-masked geometry: its own pass and a per-pixel cutoff ---
        if alpha_masked:
            vis_all = (early_vis | late_vis) if use_occlusion else vm_valid
            masked = raster_pass(
                vis_all, is_masked_vm,
                k2=min(spec.tris_per_tile_masked, spec.tris_per_tile),
                k_groups=min(spec.bin_groups_masked, spec.bin_groups_per_tile),
            )
            seg = slot_tables[0].shape[0] // n_slots_r  # groups already tabled
            depth, vid, gb_img = alpha_mask_merge(depth, vid, gb_img, masked, seg, n_slots_r, mat_rows, taps,
                                                  atlas.shape[0])
            slot_tables = tuple(torch.cat([a, b]) for a, b in zip(slot_tables, masked[4]))
            overflow = overflow + masked[3]

        ctx.update(depth=depth, visbuffer=vid, setup=setup, bin_overflow=overflow, expand_overflow=expand_overflow)
        if binning_stats:
            ctx["bin_pairs"] = torch.stack(pass_pairs).sum()
        if slot_tables is not None:
            ctx["slot_material"], ctx["slot_instance"], ctx["slot_packed_id"] = slot_tables
            ctx["slot_group"] = n_slots_r
        # surfaced through the carry so callers can assert no capacity dropped work
        carry["expand_overflow"] = expand_overflow
        carry["bin_overflow"] = overflow
        ctx = self._run_cbs(RenderStage.VISBUFFER_ENCODE, "after", ctx)

        # ---- Decode → GBuffer --------------------------------------------
        if use_gbuffer_raster:
            gbuffer = raster3d.gbuffer_from_raster(gb_img, vid, depth, torch.linalg.inv(camera.view_projection))
        else:
            gbuffer = decode_visbuffer(vid, setup, vm_inst, gscene, world, materials, atlas, width=w, height=h)
        if textured:
            gbuffer = texture_gbuffer(gbuffer, vid, slot_tables[0], n_slots_r, mat_rows, taps, atlas.shape[0],
                                      texture_features)
        ctx["gbuffer"] = gbuffer
        ctx = self._run_cbs(RenderStage.VISBUFFER_DECODE, "after", ctx)
        ctx["lights"] = lights

        def cached(name: str, compute: Callable[[], Any], moved_now: bool):
            """A term recomputed when its key moved or the carry lacks it,
            else taken from the carry (the JAX graph's `lax.cond`)."""
            out = compute() if moved_now or name not in prev else prev[name]
            carry[name] = out
            return out

        def static_cached(name: str, compute: Callable[[], Any]):
            """A term of the static-frame memo (`_static_cached` in the JAX graph)."""
            return cached(name, compute, static_dirty is None or static_dirty)

        # ---- Atmosphere ---------------------------------------------------
        if atmosphere is not None:
            t_lut, ms_lut = self.sky_luts(atmosphere, dev)
            sky_lut = cached("sky_view_lut", lambda: sky.sky_view_lut(atmosphere, t_lut, ms_lut, -sun_dir,
                                                                      sun_intensity=si), moved["sky"])
            carry["sky_key"] = keys["sky"]

            def compute_background() -> Tensor:
                # per-pixel view rays at half resolution (the even pixels of the
                # full-res fan), sampled, then upsampled: the sky is smooth
                xs = (torch.arange(0, w, 2, dtype=torch.float32, device=dev) + 0.5) / w * 2.0 - 1.0
                ys = (torch.arange(0, h, 2, dtype=torch.float32, device=dev) + 0.5) / h * 2.0 - 1.0
                tan_half = 1.0 / inv_tan_half  # the camera's true fov
                dirs = (
                    camera.forward[None, None, :]
                    + camera.right[None, None, :] * (xs[None, :, None] * tan_half * (w / h))
                    - camera.up[None, None, :] * (ys[:, None, None] * tan_half)
                )
                return resize_linear(sky.sample_sky_view(sky_lut, dirs), (h, w, 3))

            background = cached("sky_background", compute_background, moved["bg"])
            carry["sky_cam_key"] = keys["bg"]
            if ambient_color is None:
                ambient_color = cached("sky_ambient", lambda: sky.sky_sh_ambient(sky_lut) * 0.3, moved["amb"])
            ctx["sky_view_lut"] = sky_lut
            ctx["_sky_luts"] = (t_lut, ms_lut)
        ctx = self._run_cbs(RenderStage.ATMOSPHERE, "after", ctx)

        # ---- Shadows ------------------------------------------------------
        if enable_shadows:
            light_vps = shadows.clipmap_matrices(sun_dir, camera.position, first_width=first_clipmap_width)
            # residency: only pages this frame's shaded pixels sample are rendered
            vis_pages = shadows.mark_visible_pages(_pds(gbuffer["world_pos"], 8), _pds(gbuffer["hit"], 8), light_vps)
            shadow_maps, carry["shadow_cache"] = shadows.render_shadow_clipmaps_cached(
                gscene, world, light_vps, prev.get("shadow_cache"), visible_pages=vis_pages,
            )
            ctx["shadow_maps"] = shadow_maps

            def compute_shadow_term() -> Tensor:
                # resolve at quarter resolution, contact shadows at 1/8
                sh = resize_linear(shadows.resolve_shadows(_pds(gbuffer["world_pos"], 4), _pds(gbuffer["hit"], 4),
                                                           light_vps, shadow_maps), (h, w))
                if config.contact_shadows:
                    cs = shadows.contact_shadows(
                        _pds(depth, 8), _pds(gbuffer["world_pos"], 8), _pds(gbuffer["hit"], 8), sun_dir,
                        camera.view_projection, steps=config.contact_shadows_steps,
                        thickness=config.contact_shadows_thickness, length=max(config.contact_shadows_length, 0.05),
                    )
                    sh = sh * resize_linear(cs, (h, w))
                return sh

            ctx["shadow"] = static_cached("shadow_full", compute_shadow_term)

        # ---- GTAO ---------------------------------------------------------
        if enable_gtao:
            def compute_ao() -> Tensor:
                # half-resolution AO, denoised, upsampled
                wp_h = _pds(gbuffer["world_pos"], 2)
                view_pos = math3d.mat3_dir_image(camera.view[:3, :3], wp_h) + camera.view[:3, 3]
                view_nrm = math3d.mat3_dir_image(camera.view[:3, :3], _pds(gbuffer["normal"], 2))
                a = gtao_ops.gtao(
                    view_pos, view_nrm, _pds(gbuffer["hit"], 2), radius=config.vbgtao_radius,
                    thickness=config.vbgtao_thickness, final_power=config.vbgtao_final_power,
                    quality_level=config.vbgtao_quality_level,
                )
                return resize_linear(gtao_ops.denoise_ao(a, _pds(depth, 2)), (h, w))

            ctx["ao"] = static_cached("ao_full", compute_ao)

        # ---- Lighting -----------------------------------------------------
        ctx = self._run_cbs(RenderStage.LIGHTING, "before", ctx)
        if ambient_color is None:
            ambient_color = torch.tensor([0.03, 0.03, 0.03], dtype=torch.float32, device=dev)
        hdr = apply_pbr(
            gbuffer, lights, camera.position, ambient_color, background=background,
            ao=ctx.get("ao"), shadow=ctx.get("shadow"), static_lights=static_lights, live_lights=live_lights,
        )
        if config.ssr_enable:
            hdr = apply_ssr(hdr, gbuffer, depth, camera.position, camera.view_projection, steps=config.ssr_steps,
                            max_roughness=config.ssr_max_roughness)
        # aerial perspective through the froxel LUT: a function of (camera
        # height, sun, atmosphere) in world-direction space, rebuilt when its
        # quantised key moves
        if atmosphere is not None:
            t_lut2, ms_lut2 = ctx["_sky_luts"]
            ap_vol = cached("aerial_lut", lambda: sky.aerial_lut(atmosphere, t_lut2, ms_lut2, cam_h_km, -sun_dir,
                                                                 sun_intensity=si), moved["aerial"])
            carry["aerial_key"] = keys["aerial"]

            def compute_aerial_apply() -> tuple[Tensor, Tensor]:
                ap_l8, ap_t8 = sky.apply_aerial_lut(ap_vol, _pds(gbuffer["world_pos"], 8), _pds(gbuffer["hit"], 8),
                                                    camera.position, meters_per_km=METERS_PER_KM)
                return resize_linear(ap_l8, (h, w, 3)), resize_linear(ap_t8, (h, w, 3))

            ap_l, ap_t = static_cached("aerial_apply", compute_aerial_apply)
            hdr = torch.where(gbuffer["hit"][..., None], hdr * ap_t + ap_l, hdr)
        ctx["hdr"] = hdr
        ctx = self._run_cbs(RenderStage.LIGHTING, "after", ctx)

        # ---- Forward2D: particle billboards over the lit frame -------------
        # (the reference's 2D forward alpha blend runs after PBR and before
        # post, `RendererInstance.cpp:945-1088`; particles ride the sprite
        # queue, `:1336-1395`). The layer renders at quarter resolution, 1/16
        # of the tiles, and composites through one bilinear upsample.
        if particles:
            ctx = self._run_cbs(RenderStage.FORWARD_2D, "before", ctx)
            h4, w4 = h // 4, w // 4
            p_quarter = render_particles_3d(state, camera, _pds(depth, 4)[:h4, :w4], atlas, materials,
                                            width=w4, height=h4)
            p_layer = resize_linear(p_quarter, (h, w, 4))
            ctx["hdr"] = ctx["hdr"] * (1.0 - p_layer[..., 3:4]) + p_layer[..., :3]
            ctx["particle_layer"] = p_layer
            ctx = self._run_cbs(RenderStage.FORWARD_2D, "after", ctx)

        # ---- Post-processing ---------------------------------------------
        ctx = self._run_cbs(RenderStage.POST_PROCESSING, "before", ctx)
        hdr = ctx["hdr"]
        exposure = torch.tensor(config.exposure, dtype=torch.float32, device=dev)
        prev_lum = prev.get("adapt_luminance")
        if prev_lum is not None:
            hist = luminance_histogram(hdr, -11.5, 1.0 / 29.5)
            auto_exposure, new_lum = adapt_exposure(hist, prev_lum, prev.get("dt", 1.0 / 60.0))
            exposure = exposure * auto_exposure
            carry["adapt_luminance"] = new_lum
        if config.bloom_enable:
            hdr = apply_bloom(
                hdr, threshold=config.bloom_threshold, soft_threshold=config.bloom_soft_threshold,
                intensity=config.bloom_intensity, clamp_value=config.bloom_clamp,
            )
        ldr = apply_tonemap(hdr, tonemapper=config.tonemapper, exposure=exposure, gamma=config.gamma)
        if config.fxaa_enable:
            ldr = apply_fxaa(ldr)
        # debug view override (rr.debug_view modes, RendererCVar.cpp:16-23)
        if config.debug_view:
            dbg = apply_debug_view(config.debug_view, ctx)
            if dbg is not None:
                ldr = dbg
        ctx["final"] = ldr
        ctx["carry"] = carry
        ctx = self._run_cbs(RenderStage.POST_PROCESSING, "after", ctx)
        ctx = self._run_cbs(RenderStage.FINAL_OUTPUT, "after", ctx)
        return ctx
