"""Engine module facades + the canonical DefaultModules bundle (counterpart of
`oxylus_tpu/core/modules.py`).

Mirrors the reference's module roster and registration order
(`Oxylus/include/Core/DefaultModules.hpp:17-27`): LuaManager(→Script), AssetManager,
AudioEngine, Physics, Input, NetworkManager, Renderer, DebugRenderer. Order matters —
dependency checks run at add() time like the reference registry. The `Renderer`
module's material table and atlas live on its device: the card unless `"cpu"` is
given (`device.resolve_device`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..assets.manager import AssetManager, AssetType
from ..assets.material import empty_gpu_materials, pack_materials
from ..assets.texture import TextureAtlas
from ..audio.engine import AudioEngine
from ..core.input import Input
from ..device import resolve_device
from ..network.manager import NetworkManager
from ..physics.state import PhysicsParams
from ..render.debugdraw import DebugRenderer
from ..scripting.system import ScriptManager


class Physics:
    """Global physics module (reference `Physics`): owns default solver params and
    capacity limits; scenes create their own body arrays at runtime_start."""

    MODULE_NAME = "Physics"
    MAX_BODIES = 1024  # Physics.hpp:20-22
    MAX_BODY_PAIRS = 1024
    MAX_CONTACT_CONSTRAINTS = 1024

    def __init__(self) -> None:
        self.params = PhysicsParams()

    def init(self, app=None) -> None: ...
    def deinit(self, app=None) -> None: ...

    def new_params(self, **overrides):
        return dataclasses.replace(PhysicsParams(), **overrides) if overrides else self.params


class Renderer:
    """Global renderer module (reference `Renderer`): owns the material table, the
    texture atlas (bindless table analog), and shared GPU resources; syncs dirty
    materials from the AssetManager each frame (`src/Render/Renderer.cpp:18-166`).
    Both tables live on `device` (the card unless "cpu")."""

    MODULE_NAME = "Renderer"
    module_dependencies = (AssetManager,)

    def __init__(self, max_materials: int = 1024, atlas_size: int = 2048, device=None) -> None:
        self.max_materials = max_materials
        self.atlas_size = atlas_size
        self.device = resolve_device(device)
        self.materials_gpu = None
        self.atlas_gpu = None
        self.material_slots: dict[str, int] = {}  # material uuid → slot
        self._dirty = True

    def init(self, app=None) -> None:
        self.materials_gpu = empty_gpu_materials(self.max_materials, device=self.device)
        self.atlas_gpu = torch.zeros((self.atlas_size, self.atlas_size, 4), dtype=torch.uint8, device=self.device)

    def deinit(self, app=None) -> None:
        self.materials_gpu = None
        self.atlas_gpu = None

    def mark_dirty(self) -> None:
        self._dirty = True

    def update(self, app=None, ts=None) -> None:
        if not self._dirty or app is None:
            return
        self.sync_materials(app.registry.get(AssetManager))

    def sync_materials(self, asset_manager: AssetManager) -> None:
        """Rebuild the material table + atlas from loaded assets (the reference's
        dirty-material delta upload, done as one repack — see assets/material.py)."""
        atlas = TextureAtlas(size=self.atlas_size)
        for uuid, tex in asset_manager.loaded_of_type(AssetType.TEXTURE):
            atlas.add(uuid, tex)
        pixels, rects = atlas.build()

        materials = []
        self.material_slots = {}
        for uuid, mat in asset_manager.loaded_of_type(AssetType.MATERIAL):
            self.material_slots[uuid] = len(materials)
            materials.append(mat)
        self.materials_gpu = pack_materials(materials, rects, self.max_materials, device=self.device)
        self.atlas_gpu = torch.from_numpy(pixels).to(self.device)
        self._dirty = False


def default_modules(device=None) -> list:
    """The canonical bundle, in the reference's registration order; `device` is
    the `Renderer` module's (the card unless "cpu")."""
    return [
        ScriptManager(),
        AssetManager(),
        AudioEngine(),
        Physics(),
        Input(),
        NetworkManager(),
        Renderer(device=device),
        DebugRenderer(),
    ]
