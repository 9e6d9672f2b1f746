"""RendererInstance: the per-scene frame graph of the 3D path (counterpart of
`oxylus_tpu/render/renderer3d.py`).

A fixed stage sequence with injectable before/after callbacks per stage and a
named-resource dict passed between stages. This slice runs: culling (instance
cull + LOD, meshlet expansion, meshlet cull sorted nearest first), triangle
setup, the tile G-buffer raster with the two-pass HiZ occlusion protocol
(early pass against the previous frame's pyramid, pyramid rebuild, late pass
for what was revealed, merge, second rebuild), G-buffer unpack, PBR lighting
with a constant ambient colour, bloom, tonemap and FXAA. Everything runs
eagerly on the tensors' device.

Host reads per frame: the light count (read before the raster, where the read
stalls least) and, with occlusion, whether anything was revealed
(`jax.lax.cond(jnp.any(late_vis))` in the JAX graph).

Not ported yet, and refused with NotImplementedError: the atmosphere, shadows,
GTAO, SSR, particles, texturing, alpha-masked materials, debug views, the
group raster path and the non-kernel raster path. The static-frame memo only
feeds shadows, GTAO and the aerial terms, so it waits with them.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable

import torch

from ..ops import hiz as hiz_ops
from ..ops import raster3d
from ..ops.cull import cull_instances, cull_meshlets, expand_meshlet_instances
from ..ops.setup3d import bin_triangles_per_tile, passthrough_bounds, passthrough_groups, setup_triangles
from .camera import CameraMatrices
from .pbr import apply_pbr, lights_from_state
from .postfx import adapt_exposure, apply_bloom, apply_fxaa, apply_tonemap, luminance_histogram

Tensor = torch.Tensor


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
    use_pallas: bool = True      # the kernel raster; False (the JAX decode path) is not ported
    tile: int = 64
    raster_group: int = 64
    compact_raster: bool = True  # group path only
    raster_path: str = "tile"    # "group" is not ported
    tris_per_tile: int = 256     # entries per tile (multiple of 64, ≤ 256)
    bin_groups_per_tile: int = 64
    tris_per_tile_masked: int = 128
    bin_groups_masked: int = 16
    tris_per_tile_late: int = 128  # the late occlusion pass's reduced capacities
    bin_groups_late: int = 32


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to oxylus_tpu_torch yet")


@dataclasses.dataclass
class RendererInstance:
    spec: RenderSpec
    stage_callbacks: dict[tuple[RenderStage, str], list[StageCallback]] = dataclasses.field(default_factory=dict)

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
        textured: bool = False,
        particles: bool = False,
        alpha_masked: bool = False,
        static_lights: int = 8,
    ) -> dict:
        """Run the frame graph. Returns the resource dict (final image in
        "final", carried state under "carry" — feed it back as `prev`)."""
        spec = self.spec
        if enable_gtao is None:
            enable_gtao = config.vbgtao_enable
        for on, what in (
            (atmosphere is not None, "the atmosphere"), (enable_shadows, "shadows"), (enable_gtao, "GTAO"),
            (config.ssr_enable, "SSR"), (particles, "the particle composite"), (textured, "texturing"),
            (alpha_masked, "alpha-masked materials"), (bool(config.debug_view), "debug views"),
            (spec.raster_path != "tile", f"raster_path={spec.raster_path!r}"),
            (not spec.use_pallas, "the decode raster path (use_pallas=False)"),
        ):
            if on:
                raise _not_ported(what)
        w, h = spec.width, spec.height
        dev = state.device
        prev = prev or {}
        carry: dict[str, Any] = {}

        ctx: dict[str, Any] = {
            "state": state, "gscene": gscene, "camera": camera, "materials": materials, "atlas": atlas,
            "config": config, "width": w, "height": h,
        }
        ctx = self._run_cbs(RenderStage.INITIALIZATION, "after", ctx)
        lights = lights_from_state(state)
        live_lights = int(lights.count)

        # ---- Culling ------------------------------------------------------
        ctx = self._run_cbs(RenderStage.CULLING, "before", ctx)
        world = state.world
        is_persp = torch.abs(camera.projection[3, 2]) > 1e-8
        inv_tan_half = torch.where(is_persp, torch.abs(camera.projection[1, 1]), 1.0)
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
        n_slots_r = spec.tris_per_tile
        mat_idx = gscene.inst_material[vm_inst.long()].long()
        consts_m = torch.cat(
            [materials.albedo_color[:, :3], materials.metallic_factor[:, None],
             materials.roughness_factor[:, None], materials.emissive_color],
            dim=1,
        )  # (M, 8) material-indexed constants
        # the per-slot row matrix is built once from the full visible set and
        # shared by both passes (a pass's entries only reference its valid slots)
        dense_full = passthrough_groups(setup, setup["tri_valid"], mat_idx, vm_inst)
        comb = raster3d.build_tile_comb(dense_full, consts_m[dense_full["slot_material"].long()])

        def raster_pass(vis_mask: Tensor, k2: int | None = None, k_groups: int | None = None):
            """One G-buffer raster pass → (depth, vid, gb, bin_overflow,
            slot tables stride-padded to the global entry stride)."""
            tri_mask = setup["tri_valid"] & vis_mask[:, None]
            k2_p = k2 or spec.tris_per_tile
            bounds = passthrough_bounds(setup, tri_mask)
            entries, cnts, ov = bin_triangles_per_tile(bounds, w, h, spec.tile, k_groups or spec.bin_groups_per_tile, k2_p)
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

        # conservative nearest depth per meshlet for occlusion testing
        ml_near = torch.where(setup["tri_valid"], setup["sxyz"][..., 2].max(-1).values, -1.0).max(-1).values
        bounds4 = (setup["ml_xmin"], setup["ml_xmax"], setup["ml_ymin"], setup["ml_ymax"])

        use_occlusion = config.culling_occlusion and "hiz" in prev
        if use_occlusion:
            early_vis = hiz_ops.occlusion_test(prev["hiz"], *bounds4, ml_near, w, h) & vm_valid
            depth, vid, gb_img, overflow, slot_tables = raster_pass(early_vis)
            hiz = hiz_ops.build_hiz(depth)
            late_vis = hiz_ops.occlusion_test(hiz, *bounds4, ml_near, w, h) & vm_valid & ~early_vis
            # the late pass exists only when something was revealed this frame
            if bool(late_vis.any()):
                d2, v2, gb2, overflow2, tables2 = raster_pass(
                    late_vis,
                    k2=min(spec.tris_per_tile_late, spec.tris_per_tile),
                    k_groups=min(spec.bin_groups_late, spec.bin_groups_per_tile),
                )
                # late vids index the second half of the combined slot tables
                groups_per_pass = tables2[0].shape[0] // n_slots_r
                v2 = torch.where(v2 >= 0, v2 + groups_per_pass * 256, v2)
                better = d2 > depth
                depth = torch.where(better, d2, depth)
                vid = torch.where(better, v2, vid)
                gb_img = torch.where(better[..., None], gb2, gb_img)
                hiz = hiz_ops.build_hiz(depth)
            else:
                overflow2 = torch.zeros((), dtype=torch.int32, device=dev)
                tables2 = tuple(torch.zeros_like(t) for t in slot_tables)
            slot_tables = tuple(torch.cat([a, b]) for a, b in zip(slot_tables, tables2))
            carry["hiz"] = hiz
            overflow = overflow + overflow2
        else:
            depth, vid, gb_img, overflow, slot_tables = raster_pass(vm_valid)
            if config.culling_occlusion:
                carry["hiz"] = hiz_ops.build_hiz(depth)

        ctx.update(depth=depth, visbuffer=vid, setup=setup, bin_overflow=overflow, expand_overflow=expand_overflow)
        ctx["slot_material"], ctx["slot_instance"], ctx["slot_packed_id"] = slot_tables
        ctx["slot_group"] = n_slots_r
        # surfaced through the carry so callers can assert no capacity dropped work
        carry["expand_overflow"] = expand_overflow
        carry["bin_overflow"] = overflow
        ctx = self._run_cbs(RenderStage.VISBUFFER_ENCODE, "after", ctx)

        # ---- Decode → GBuffer --------------------------------------------
        gbuffer = raster3d.gbuffer_from_raster(gb_img, vid, depth, torch.linalg.inv(camera.view_projection))
        ctx["gbuffer"] = gbuffer
        ctx = self._run_cbs(RenderStage.VISBUFFER_DECODE, "after", ctx)
        ctx["lights"] = lights
        ctx = self._run_cbs(RenderStage.ATMOSPHERE, "after", ctx)

        # ---- Lighting -----------------------------------------------------
        ctx = self._run_cbs(RenderStage.LIGHTING, "before", ctx)
        if ambient_color is None:
            ambient_color = torch.tensor([0.03, 0.03, 0.03], dtype=torch.float32, device=dev)
        hdr = apply_pbr(
            gbuffer, lights, camera.position, ambient_color, background=background,
            ao=ctx.get("ao"), shadow=ctx.get("shadow"), static_lights=static_lights, live_lights=live_lights,
        )
        ctx["hdr"] = hdr
        ctx = self._run_cbs(RenderStage.LIGHTING, "after", ctx)

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
        ctx["final"] = ldr
        ctx["carry"] = carry
        ctx = self._run_cbs(RenderStage.POST_PROCESSING, "after", ctx)
        ctx = self._run_cbs(RenderStage.FINAL_OUTPUT, "after", ctx)
        return ctx
