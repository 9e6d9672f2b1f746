"""SceneRunner: the simulate loop over a scene (counterpart of `oxylus_tpu/runtime.py`).

Headless only (`render_mode="none"`): the renderers are later slices. Physics
runs through `frame_step(..., physics_mega=True)`, whose substeps are the
compact kernel — the routing of the JAX package's fused frame
(`_step_render3d_fused`), not its dense-kernel headless branch. A scene with
bodies must be eligible for that kernel (no compound proxies, capacity a
multiple of 128 and ≥ 256, no characters); which implementation runs is picked
inside the kernel wrapper by the tensors' device (the CUDA kernel on a card, the
plain version on the CPU). Per-frame script hooks are carried over; audio and
contact events are not ported yet and raise.
"""

from __future__ import annotations

import torch

from .physics.state import PhysicsParams
from .scene.frame import frame_step
from .scene.scene import Scene


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to oxylus_tpu_torch yet")


class SceneRunner:
    def __init__(
        self,
        scene: Scene,
        *,
        physics_params: PhysicsParams | None = None,
        render_mode: str = "none",
        use_megakernel: bool = False,
        track_contacts: bool = False,
        audio_engine=None,
    ) -> None:
        if render_mode != "none":
            raise _not_ported(f"render_mode={render_mode!r}")
        if track_contacts:
            raise _not_ported("contact-event tracking (physics/events.py)")
        has_audio = bool(
            (scene._alive & scene._comp_mask["AudioSourceComponent"]).any()
            or (scene._alive & scene._comp_mask["AudioListenerComponent"]).any()
        )
        if audio_engine is not None or has_audio:
            raise _not_ported("audio")
        self.scene = scene
        self.physics_params = physics_params or PhysicsParams()
        self.use_megakernel = use_megakernel
        if not scene.running:
            scene.runtime_start()
        self.state = scene.to_device_state()
        self.ps = scene.physics_state
        self.frame_index = 0
        self._script_accum = 0.0  # host mirror of the 60 Hz tick for on_fixed_update
        self._has_bodies = bool(self.ps.active.any())
        self._check_physics_route()

    def _check_physics_route(self) -> None:
        if not self._has_bodies:
            return
        if not self.use_megakernel:
            raise _not_ported("the XLA physics substep (use_megakernel=False)")
        if not self._fused_mega_eligible():
            raise _not_ported(
                "physics for this scene (compound proxies, characters, or a capacity that is not "
                "a multiple of 128 and >= 256 need the XLA substep)"
            )

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

    # ------------------------------------------------------------------ stepping
    def step(self, dt: float = 1.0 / 60.0):
        """One frame of simulation. Returns None (headless)."""
        self._script_frame_begin(dt)
        if self.scene._pending_body_ops and self.ps is not None:
            self.ps = self.scene.apply_pending_body_ops(self.ps, self.scene.spec.physics_interval)
        self.state, self.ps = frame_step(
            self.state, self.ps, self.physics_params, dt, self.scene.spec,
            has_bodies=self._has_bodies, physics_mega=self._has_bodies,
        )
        self.frame_index += 1
        return None

    def run(self, frames: int, dt: float = 1.0 / 60.0):
        for _ in range(frames):
            self.step(dt)
        if self.state.device.type == "cuda":
            torch.cuda.synchronize(self.state.device)
        return None

    # ------------------------------------------------------------------ sync
    def sync_to_host(self) -> Scene:
        self.scene.sync_from_device(self.state)
        return self.scene
