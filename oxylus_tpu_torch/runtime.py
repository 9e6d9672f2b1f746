"""SceneRunner: the simulate(+render) loop over a scene (counterpart of
`oxylus_tpu/runtime.py`).

Routes as the JAX runner does:

- `render_mode="3d"` with meshes and a camera: the fused frame
  (`_step_render3d_fused`): `frame_step` (physics substeps through the compact
  kernel when the scene is eligible and `use_megakernel` is set), camera, then
  `RendererInstance.render`. `step` returns the image.
- Otherwise the separate-stage path: with bodies and `use_megakernel` the JAX
  runner runs its dense kernel (`physics/megakernel.py::_kernel`), without it the
  XLA substep (`physics/step.py`); neither is ported, so both raise
  NotImplementedError. Body-less scenes run `frame_step` without physics.

Which implementation a kernel runs is picked inside its wrapper by the tensors'
device: the CUDA kernel on a card, the plain version on the CPU. The runner
runs on the card unless `device="cpu"` is given; the scene must live on the
same device. Per-frame script hooks are carried over; audio, contact events,
the 2D renderer and the unported render features raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .assets.bake import BakedMesh
from .assets.material import FLAG_ALPHA_MASK
from .core import uuid as uuidlib
from .core.config import RendererConfig
from .device import resolve_device
from .physics.state import PhysicsParams
from .render.camera import CameraMatrices, camera_from_state
from .render.renderer2d import SpriteBatchBindings, default_bindings
from .render.renderer3d import RenderSpec, RendererInstance
from .render.scene3d import GPUScene, upload_meshes, worst_case_meshlet_instances
from .scene.frame import frame_step
from .scene.scene import Scene

DENSE_KERNEL = "physics/megakernel.py::_kernel"


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to oxylus_tpu_torch yet")


class SceneRunner:
    def __init__(
        self,
        scene: Scene,
        *,
        width: int = 1920,
        height: int = 1080,
        physics_params: PhysicsParams | None = None,
        render_mode: str = "none",  # "none" | "3d"
        use_megakernel: bool = False,
        track_contacts: bool = False,
        meshes: list[BakedMesh] | None = None,
        render_spec: RenderSpec | None = None,
        bindings: SpriteBatchBindings | None = None,
        atmosphere=None,
        enable_shadows: bool = False,
        audio_engine=None,
        material_slots: dict | None = None,
        device=None,
    ) -> None:
        dev = resolve_device(device)
        if scene.device != dev:
            raise ValueError(f"the scene lives on {scene.device}, the runner was asked for {dev}")
        if render_mode not in ("none", "3d"):
            raise _not_ported(f"render_mode={render_mode!r}")
        if track_contacts:
            raise _not_ported("contact-event tracking (physics/events.py)")
        if atmosphere is not None or enable_shadows:
            raise _not_ported("the atmosphere and shadows")
        has_audio = bool(
            (scene._alive & scene._comp_mask["AudioSourceComponent"]).any()
            or (scene._alive & scene._comp_mask["AudioListenerComponent"]).any()
        )
        if audio_engine is not None or has_audio:
            raise _not_ported("audio")
        self.scene = scene
        self.device = dev
        self.width = width
        self.height = height
        self.physics_params = physics_params or PhysicsParams()
        self.render_mode = render_mode
        self.use_megakernel = use_megakernel
        self.config: RendererConfig = scene.renderer_config
        if not scene.running:
            scene.runtime_start()
        self.state = scene.to_device_state()
        self.ps = scene.physics_state
        self.carry: dict[str, Any] = {}
        self.frame_index = 0
        self.last_frame = None
        self._script_accum = 0.0  # host mirror of the 60 Hz tick for on_fixed_update
        self._camera_idx: int | None = None
        self._has_bodies = bool(self.ps.active.any())
        if self._has_bodies and render_mode == "none":
            self._refuse_separate_physics()

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
        self.bindings = bindings or default_bindings(scene.spec.padded_entities(), device=dev)
        flags = self.bindings.materials.flags.cpu().numpy()
        if np.any(flags & 0b1111):
            raise _not_ported("texturing")
        if np.any(flags & FLAG_ALPHA_MASK):
            raise _not_ported("alpha-masked materials")
        if scene.spec.max_particles > 0 and bool(scene._comp_mask["ParticleSystemComponent"].any()) and render_mode == "3d":
            raise _not_ported("the 3D particle composite")
        # lights covered by the unrolled PBR blocks: the scene's own lights
        self._static_lights = max(1, int(np.sum(scene._alive & scene._comp_mask["LightComponent"])))

    def _refuse_separate_physics(self) -> None:
        """The JAX runner's separate-stage physics: the dense kernel with
        `use_megakernel`, the XLA substep without it. Neither is ported."""
        if self.use_megakernel:
            raise _not_ported(
                f"the headless use_megakernel physics branch (the dense kernel {DENSE_KERNEL}, "
                "runtime.py:322-369)"
            )
        raise _not_ported("the XLA physics substep (physics/step.py, use_megakernel=False)")

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
            self.state = scene.merge_host_edits(self.state)
            self.invalidate_camera()
            self._static_lights = max(1, int(np.sum(scene._alive & scene._comp_mask["LightComponent"])))

    def _script_frame_end(self, image) -> None:
        if image is None or not self.scene.lua_systems:
            return
        for system in self.scene.lua_systems.values():
            system.on_scene_render(self.scene, (self.width, self.height))

    # ------------------------------------------------------------------ stepping
    def step(self, dt: float = 1.0 / 60.0, render: bool = True):
        """One frame: simulate (+render when enabled). Returns the final image
        (H, W, 3) in [0, 1], or None."""
        self._script_frame_begin(dt)
        if self.scene._pending_body_ops and self.ps is not None:
            self.ps = self.scene.apply_pending_body_ops(self.ps, self.scene.spec.physics_interval)
        if render and self.render_mode == "3d" and self.gscene is not None and self._resolve_camera_idx() >= 0:
            image = self._step_render3d_fused(dt)
        else:
            if self._has_bodies:
                self._refuse_separate_physics()
            self.state, self.ps = frame_step(
                self.state, self.ps, self.physics_params, dt, self.scene.spec, has_bodies=False
            )
            image = None
        self.frame_index += 1
        self._script_frame_end(image)
        self.last_frame = image
        return image

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
        """Simulate + camera + render (`runtime.py:539-582`)."""
        physics_mega = self.use_megakernel and self._has_bodies and self._fused_mega_eligible()
        if self._has_bodies and not physics_mega:
            raise _not_ported(
                "the XLA physics substep (physics/step.py), which the fused frame runs without "
                "use_megakernel or for scenes the compact kernel does not take"
            )
        self.state, self.ps = frame_step(
            self.state, self.ps, self.physics_params, dt, self.scene.spec,
            has_bodies=self._has_bodies, physics_mega=physics_mega,
        )
        camera = camera_from_state(self.state, self._camera_idx, self.width / self.height)
        ctx = self.renderer3d.render(
            self.state, self.gscene, camera, self.bindings.materials, self.bindings.atlas, self.config,
            prev=self.carry, static_lights=self._static_lights,
        )
        self.carry = ctx["carry"]
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
