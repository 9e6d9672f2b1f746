"""SceneRunner: the simulate(+render) loop over a scene (counterpart of
`oxylus_tpu/runtime.py`).

Routes as the JAX runner does:

- `render_mode="3d"` with meshes and a camera, when `step(render=True)`: the
  fused frame (`_step_render3d_fused`): `frame_step` (physics substeps through
  the compact kernel when `use_megakernel` is set and the scene is eligible,
  `physics_substep` otherwise), camera, then `RendererInstance.render`, with
  the Forward2D particle composite when the scene has an emitter. `step`
  returns the image.
- Otherwise the separate-stage path, and with `render_mode="2d"` and a camera
  the sprites and particles through `render_2d_with_particles` after it
  (`step` returns the premultiplied (H, W, 4) colour). With `use_megakernel`:
  a host-side 60 Hz accumulator, one dense-kernel call
  (`physics/megakernel.py`) with that frame's substep count, then body and
  character sync, interpolation, particles, sprites and transforms (no
  character controller, as in the JAX branch). Without it: `frame_step` with
  `physics_substep`.
- With `track_contacts`, contact and activation callbacks every
  `contact_events_every` frames, from one batched host read.

Which implementation a kernel runs is picked inside its wrapper by the tensors'
device: the CUDA kernel on a card, the plain version on the CPU. The runner
runs on the card unless `device="cpu"` is given; the scene must live on the
same device. Per-frame script hooks are carried over. Audio: scenes with an
`AudioSourceComponent` or `AudioListenerComponent` get an `AudioEngine` (or use the
one passed in), and after every frame route `_audio_frame` reads the audio
entities' world translations from the device in one gather and one host copy,
syncs the engine's sources and listeners (clips resolved by UUID through
`asset_manager`, or bound with `attach_audio_clip`) and mixes the frame's samples
on the host. Each step marks a frame of `utils.profiler.PROFILER` and runs in its
zones: `frame3d_fused` (the fused route), `frame_step` (the separate-stage
physics), `render_2d` and `audio_frame`.
`atmosphere` (an `AtmosphereParams`) and `enable_shadows` go to every
rendered frame, as in the JAX runner, and so do the texturing gates, taken
once from the bound materials' flag bits: the texture kinds some material
carries (`texture_features`; texturing is on when there is one) and whether
some material is alpha-masked (the 3D frame's masked pass).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .assets.bake import BakedMesh
from .assets.material import (
    FLAG_ALPHA_MASK,
    FLAG_HAS_ALBEDO,
    FLAG_HAS_EMISSIVE,
    FLAG_HAS_METALLIC_ROUGHNESS,
    FLAG_HAS_NORMAL,
)
from .audio.engine import SAMPLE_RATE, AudioEngine, sync_sources_from_scene
from .core import uuid as uuidlib
from .core.config import RendererConfig
from .device import resolve_device
from .physics.events import ActivationTracker, ContactTracker, query_contacts
from .physics.megakernel import megakernel_substeps
from .physics.state import PhysicsParams
from .render.camera import CameraMatrices, camera_from_state
from .render.renderer2d import SpriteBatchBindings, default_bindings, render_2d_with_particles
from .render.renderer3d import RenderSpec, RendererInstance
from .render.scene3d import GPUScene, upload_meshes, worst_case_meshlet_instances
from .scene import frame as _frame
from .scene.frame import frame_step
from .scene.particles import particle_update
from .scene.scene import Scene
from .scene.state import propagate_transforms
from .utils.profiler import PROFILER


class SceneRunner:
    def __init__(
        self,
        scene: Scene,
        *,
        width: int = 1920,
        height: int = 1080,
        physics_params: PhysicsParams | None = None,
        render_mode: str = "none",  # "none" | "2d" | "3d"
        use_megakernel: bool = False,
        track_contacts: bool = False,
        contact_events_every: int = 1,
        meshes: list[BakedMesh] | None = None,
        render_spec: RenderSpec | None = None,
        bindings: SpriteBatchBindings | None = None,
        atmosphere=None,
        enable_shadows: bool = False,
        audio_engine=None,
        asset_manager=None,
        material_slots: dict | None = None,
        binning_stats: bool = False,
        device=None,
    ) -> None:
        dev = resolve_device(device)
        if scene.device != dev:
            raise ValueError(f"the scene lives on {scene.device}, the runner was asked for {dev}")
        if render_mode not in ("none", "2d", "3d"):
            raise ValueError(f"render_mode={render_mode!r}: 'none', '2d' or '3d'")
        self.scene = scene
        self.device = dev
        self.width = width
        self.height = height
        self.physics_params = physics_params or PhysicsParams()
        self.render_mode = render_mode
        self.use_megakernel = use_megakernel
        # scripts that do not need per-frame contact events pay the extra
        # narrowphase and host read only every N frames
        self.contact_events_every = max(int(contact_events_every), 1)
        self.contact_tracker = ContactTracker() if track_contacts else None
        self.activation_tracker = ActivationTracker() if track_contacts else None
        self.config: RendererConfig = scene.renderer_config
        self.atmosphere = atmosphere
        self.enable_shadows = enable_shadows

        # audio: the reference runs audio_listener_update/audio_source_update
        # every frame inside world.progress (`Scene.cpp:681-716`); the runner
        # drives the engine per frame when the scene carries audio components.
        # Scenes without audio pay nothing (the engine stays None).
        self.asset_manager = asset_manager
        self.audio_engine = audio_engine
        self._audio_sources: dict[int, Any] = {}
        self._audio_accum = 0.0
        self._audio_entity_idx: tuple[np.ndarray, torch.Tensor] | None = None  # host and device indices
        self.last_audio_block = None
        if self.audio_engine is None:
            has_audio = bool(
                (scene._alive & scene._comp_mask["AudioSourceComponent"]).any()
                or (scene._alive & scene._comp_mask["AudioListenerComponent"]).any()
            )
            if has_audio:
                self.audio_engine = AudioEngine()
                self.audio_engine.init()

        if not scene.running:
            scene.runtime_start()
        self.state = scene.to_device_state()
        self.ps = scene.physics_state
        self.carry: dict[str, Any] = {}
        # the last rendered frame's binning counts, as device tensors (no host
        # read): 3D "bin_overflow", "expand_overflow" and, with
        # `binning_stats`, "bin_pairs"; 2D, with `binning_stats` only,
        # "tile_dropped" and "tile_pairs"
        self.binning_stats = binning_stats
        self.frame_stats: dict[str, Any] = {}
        self.frame_index = 0
        self.last_frame = None
        self._script_accum = 0.0  # host mirror of the 60 Hz tick for on_fixed_update
        self._camera_idx: int | None = None
        self._has_bodies: bool | None = None  # read from the state at the first frame that needs it
        self._mega_accum: float | None = None  # host mirror of the accumulator (use_megakernel branch)

        self.gscene: GPUScene | None = None
        if render_mode == "3d" and meshes:
            mesh_mask = scene._comp_mask["MeshComponent"]
            mesh_idx_field = scene._comp_data["MeshComponent"]["mesh_index"]
            mat_uuid_field = scene._comp_data["MeshComponent"]["material_uuid"]
            instances = []
            for i in np.nonzero(scene._alive & mesh_mask)[0]:
                mi = int(mesh_idx_field[int(i)]) if len(meshes) > 1 else 0
                mi = min(mi, max(len(meshes) - 1, 0))
                mat_slot = 0
                if material_slots:
                    hi, lo = (int(v) for v in mat_uuid_field[int(i)])
                    mat_slot = material_slots.get(uuidlib.u64_pair_to_uuid(hi, lo), 0)
                instances.append((mi, int(i), mat_slot))
            self.gscene = upload_meshes(meshes, instances, device=dev)
            # clamp the compaction capacities to the scene's provable worst case
            worst = worst_case_meshlet_instances(meshes, instances)
            cap = max(128, -(-worst // 128) * 128)
            spec = render_spec or RenderSpec(width=width, height=height)
            spec = dataclasses.replace(
                spec,
                max_meshlet_instances=min(spec.max_meshlet_instances, cap),
                max_visible_meshlets=min(spec.max_visible_meshlets, cap),
            )
            self.renderer3d = RendererInstance(spec)
            if atmosphere is not None:
                # build the transmittance and multiple-scattering LUTs now, once
                # per atmosphere, as the JAX runner prewarms its LUT cache
                self.renderer3d.sky_luts(atmosphere, dev)
        self.bindings = bindings or default_bindings(scene.spec.padded_entities(), device=dev)
        # static texturing gates: a texture kind is sampled only when some
        # bound material carries it, and the masked pass runs only when some
        # material is alpha-masked
        flags = self.bindings.materials.flags.cpu().numpy()
        self._texture_features = tuple(
            name for name, bit in (("albedo", FLAG_HAS_ALBEDO), ("normal", FLAG_HAS_NORMAL),
                                   ("emissive", FLAG_HAS_EMISSIVE), ("mr", FLAG_HAS_METALLIC_ROUGHNESS))
            if np.any(flags & bit)
        )
        self._textured = bool(self._texture_features)
        self._has_alpha_mask = bool(np.any(flags & FLAG_ALPHA_MASK))
        # static particle gate: scenes without emitters leave the Forward2D
        # particle composite out of the 3D frame
        self._has_particles = bool(
            scene.spec.max_particles > 0 and scene._comp_mask["ParticleSystemComponent"].any()
        )
        # lights covered by the unrolled PBR blocks: the scene's own lights
        self._static_lights = max(1, int(np.sum(scene._alive & scene._comp_mask["LightComponent"])))

    # ------------------------------------------------------------------ camera
    def _resolve_camera_idx(self) -> int:
        """First alive camera entity index, resolved once on the host and cached."""
        if self._camera_idx is None:
            mask = (self.state.mask["CameraComponent"] & self.state.alive).cpu().numpy()
            idx = np.nonzero(mask)[0]
            self._camera_idx = int(idx[0]) if len(idx) else -1
        return self._camera_idx

    def active_camera(self) -> CameraMatrices | None:
        if self._resolve_camera_idx() < 0:
            return None
        return camera_from_state(self.state, self._camera_idx, self.width / self.height)

    def invalidate_camera(self) -> None:
        self._camera_idx = None

    def replace_physics_state(self, ps) -> None:
        """Swap in externally built physics state (a loaded checkpoint, a spawn
        path that activates bodies); the cached has-bodies flag is re-derived."""
        self.ps = ps
        self._has_bodies = None

    def _bodies(self) -> bool:
        """Whether any body is active: read once (one host read), as the JAX
        runner decides once per scene whether the frame step has physics."""
        if self._has_bodies is None:
            self._has_bodies = bool(self.ps.active.any())
        return self._has_bodies

    # ------------------------------------------------------------------ scripting
    def _script_frame_begin(self, dt: float) -> None:
        """Per-frame script dispatch (`Scene.cpp:1139-1157`): deferred functions →
        script `on_scene_update` → fixed-tick `on_fixed_update` → registered host
        systems; host edits are merged back into the device state."""
        scene = self.scene
        has_scripts = bool(scene.lua_systems or scene.script_ecs_systems)
        if not (has_scripts or scene.deferred_functions):
            return
        scene.sync_from_device(self.state)
        if scene.deferred_functions:
            scene.run_deferred()
        if has_scripts:
            for system in scene.lua_systems.values():
                system.on_scene_update(scene, dt)
            h = scene.spec.physics_interval
            self._script_accum += dt
            nsub = 0
            while self._script_accum >= h and nsub < scene.spec.max_substeps:
                self._script_accum -= h
                nsub += 1
                for system in scene.lua_systems.values():
                    system.on_fixed_update(scene, h)
            self._script_accum = min(self._script_accum, h)
            scene.progress(dt)
        if scene._device_dirty:
            old_n = int(self.state.alive.shape[0])
            self.state = scene.merge_host_edits(self.state)
            self.invalidate_camera()
            self._audio_entity_idx = None  # audio entities may have changed
            new_n = int(self.state.alive.shape[0])
            if new_n != old_n:
                # the entity capacity grew mid-run: re-pad the per-entity
                # bindings, keeping the material assignments (the runner keeps
                # no other per-capacity cache; the camera index is re-resolved)
                b = self.bindings
                pad = torch.zeros((new_n - old_n,), dtype=b.entity_material_idx.dtype, device=self.device)
                self.bindings = dataclasses.replace(
                    b, entity_material_idx=torch.cat([b.entity_material_idx, pad])
                )
            self._static_lights = max(1, int(np.sum(scene._alive & scene._comp_mask["LightComponent"])))

    def _script_frame_end(self, image) -> None:
        if image is None or not self.scene.lua_systems:
            return
        for system in self.scene.lua_systems.values():
            system.on_scene_render(self.scene, (self.width, self.height))

    # ------------------------------------------------------------------ stepping
    def step(self, dt: float = 1.0 / 60.0, render: bool = True):
        """One frame: simulate (+render when enabled). Returns the final image
        ((H, W, 3) in [0, 1] in 3D, the premultiplied (H, W, 4) colour in 2D),
        or None."""
        self._script_frame_begin(dt)
        if self.scene._pending_body_ops and self.ps is not None:
            self.ps = self.scene.apply_pending_body_ops(self.ps, self.scene.spec.physics_interval)
        image = None
        if render and self.render_mode == "3d" and self.gscene is not None and self._resolve_camera_idx() >= 0:
            image = self._step_render3d_fused(dt)
        else:
            with PROFILER.zone("frame_step"):
                if self.use_megakernel:
                    self._step_dense(dt)
                else:
                    self.state, self.ps = frame_step(
                        self.state, self.ps, self.physics_params, dt, self.scene.spec, has_bodies=self._bodies()
                    )
        self._post_step_events()
        self._audio_frame(dt)
        self.frame_index += 1
        if render and self.render_mode == "2d":
            camera = self.active_camera()
            if camera is not None:
                self.frame_stats = {}
                with PROFILER.zone("render_2d"):
                    image, _vis = render_2d_with_particles(
                        self.state, camera, self.bindings, width=self.width, height=self.height,
                        stats=self.frame_stats if self.binning_stats else None,
                    )
        self._script_frame_end(image)
        self.last_frame = image
        PROFILER.frame_mark()
        return image

    def _step_dense(self, dt: float) -> None:
        """The headless throughput branch (`runtime.py:322-369`): physics in one
        dense-kernel call, then the frame's non-physics systems."""
        spec = self.scene.spec
        h = spec.physics_interval
        # host-side 60 Hz accumulator: read from the state once, then kept here
        acc = float(self.ps.accumulator) if self._mega_accum is None else self._mega_accum
        acc += dt
        nsub = min(int(acc // h), spec.max_substeps)
        acc = min(acc - nsub * h, h)  # spiral-of-death clamp
        self._mega_accum = acc
        if nsub > 0:
            self.ps = megakernel_substeps(self.ps, self.physics_params, h, n_substeps=nsub)
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=self.device)
        # rounded as the JAX runner rounds them (its cache of scalars)
        self.ps = dataclasses.replace(self.ps, accumulator=f32(round(acc, 4)))
        state = _frame.sync_bodies_to_components(self.state, self.ps)
        state = _frame.sync_characters_to_components(state, self.ps)
        state = _frame.physics_interpolate(state, self.ps, f32(round(acc / h, 3)))
        state = particle_update(state, spec, f32(dt))
        state = _frame.sprite_animation_update(state, f32(dt))
        new_world = propagate_transforms(state, spec)
        self.state = dataclasses.replace(
            state, previous_world=state.world, world=new_world, time=state.time + dt, frame=state.frame + 1
        )

    # ------------------------------------------------------------------ audio
    def attach_audio_clip(self, entity_index: int, clip, play: bool = True):
        """Bind an in-memory AudioClip to an AudioSourceComponent entity (the
        asset-manager-less path: scenes loaded from JSON resolve clips by UUID
        via `asset_manager` instead)."""
        if self.audio_engine is None:
            self.audio_engine = AudioEngine()
            self.audio_engine.init()
        src = self.audio_engine.create_source(clip)
        self._audio_sources[entity_index] = src
        if play:
            src.play()
        return src

    def _audio_frame(self, dt: float) -> None:
        """Per-frame audio (`oxylus_tpu/runtime.py:447-489`): the world
        translations of the audio entities from the device state (one gather
        and one host copy, the index tensor cached on the device), pushed into
        the engine via `sync_sources_from_scene`, velocities derived for
        doppler, and the mixer advanced by the frame's worth of samples.
        Mirrors the reference's PreUpdate audio systems (`Scene.cpp:681-716`)."""
        if self.audio_engine is None:
            return
        with PROFILER.zone("audio_frame"):
            scene = self.scene
            if self._audio_entity_idx is None:
                m = scene._alive & (
                    scene._comp_mask["AudioSourceComponent"] | scene._comp_mask["AudioListenerComponent"]
                )
                host_idx = np.nonzero(m)[0]
                self._audio_entity_idx = (host_idx, torch.as_tensor(host_idx, device=self.device))
            host_idx, dev_idx = self._audio_entity_idx
            if len(host_idx):
                # world-space positions of just the audio entities (the
                # translation column: matrices are column-translation)
                pos = self.state.world[dev_idx, :3, 3].cpu().numpy()
                scene._comp_data["TransformComponent"]["position"][host_idx] = pos
            old_src_pos = {i: np.array(s.position) for i, s in self._audio_sources.items()}
            old_lst_pos = [np.array(l.position) for l in self.audio_engine.listeners]
            sync_sources_from_scene(self.audio_engine, scene, self._audio_sources, self.asset_manager)
            if dt > 0:
                for i, src in self._audio_sources.items():
                    prev = old_src_pos.get(i)
                    if prev is not None:
                        src.velocity = (np.asarray(src.position) - prev) / dt
                for j, lst in enumerate(self.audio_engine.listeners):
                    if j < len(old_lst_pos):
                        lst.velocity = (np.asarray(lst.position) - old_lst_pos[j]) / dt
            self._audio_accum += dt * SAMPLE_RATE
            frames = int(self._audio_accum)
            self._audio_accum -= frames
            if frames > 0:
                self.last_audio_block = self.audio_engine.render_block(frames)

    def _post_step_events(self) -> None:
        """Contact and activation script callbacks off the post-step physics
        state, every `contact_events_every` frames."""
        if self.contact_tracker is None or self.frame_index % self.contact_events_every != 0:
            return
        ent_a, ent_b, valid = query_contacts(self.ps, self.physics_params)
        # one device→host transfer for both trackers
        host = torch.cat([ent_a, ent_b, valid.int(), self.ps.asleep.int(), self.ps.entity.int()]).cpu().numpy()
        p, b = ent_a.shape[0], self.ps.num_slots
        ent_a, ent_b, valid = host[:p], host[p:2 * p], host[2 * p:3 * p] > 0
        asleep, entity = host[3 * p:3 * p + b] > 0, host[3 * p + b:]
        added, persisted, removed = self.contact_tracker.update_from_arrays(ent_a, ent_b, valid)
        for system in self.scene.lua_systems.values():
            for a, b_ in added:
                system.on_contact_added(self.scene, a, b_)
            for a, b_ in persisted:
                system.on_contact_persisted(self.scene, a, b_)
            for a, b_ in removed:
                system.on_contact_removed(self.scene, a, b_)
        act, deact = self.activation_tracker.update_from_arrays(asleep, entity)
        for system in self.scene.lua_systems.values():
            for e in act:
                system.on_body_activated(self.scene, e)
            for e in deact:
                system.on_body_deactivated(self.scene, e)

    def _fused_mega_eligible(self) -> bool:
        """The compact kernel's shape conditions: single-collider bodies,
        128-aligned capacity >= 256, no characters."""
        ps = self.ps
        if ps.has_proxies:
            return False
        b = ps.num_slots
        if b % 128 != 0 or b < 256:
            return False
        return not bool(ps.is_character.any())

    def _step_render3d_fused(self, dt: float):
        """Simulate + camera + render (`runtime.py:539-582`). The physics
        substeps run the compact kernel with `use_megakernel` on eligible
        scenes, `physics_substep` otherwise."""
        has_bodies = self._bodies()
        physics_mega = self.use_megakernel and has_bodies and self._fused_mega_eligible()
        with PROFILER.zone("frame3d_fused"):
            self.state, self.ps = frame_step(
                self.state, self.ps, self.physics_params, dt, self.scene.spec,
                has_bodies=has_bodies, physics_mega=physics_mega,
            )
            camera = camera_from_state(self.state, self._camera_idx, self.width / self.height)
            ctx = self.renderer3d.render(
                self.state, self.gscene, camera, self.bindings.materials, self.bindings.atlas, self.config,
                prev=self.carry, atmosphere=self.atmosphere, enable_shadows=self.enable_shadows,
                textured=self._textured, texture_features=self._texture_features, particles=self._has_particles,
                alpha_masked=self._has_alpha_mask, static_lights=self._static_lights,
                binning_stats=self.binning_stats,
            )
        self.carry = ctx["carry"]
        self.frame_stats = {k: ctx[k] for k in ("bin_overflow", "bin_pairs", "expand_overflow") if k in ctx}
        return ctx["final"]

    def run(self, frames: int, dt: float = 1.0 / 60.0, render: bool = True):
        out = None
        for _ in range(frames):
            out = self.step(dt, render=render)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    # ------------------------------------------------------------------ sync
    def sync_to_host(self) -> Scene:
        self.scene.sync_from_device(self.state)
        return self.scene
