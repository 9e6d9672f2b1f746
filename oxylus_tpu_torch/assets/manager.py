"""AssetManager: UUID registry, refcounted load/unload, `.oxasset` meta sidecars
(a copy of `oxylus_tpu/assets/manager.py`).

Mirrors the reference AssetManager's model (`Oxylus/include/Asset/AssetManager.hpp:18-157`):
an `Asset` record is {uuid, type, path, ref_count, typed id}; every importable file gets a
JSON sidecar `<file>.oxasset` with at least {uuid, type} (materials embed their
parameter block — `src/Asset/AssetManager.cpp:15-77`); scenes reference assets by UUID
only, resolved through this registry. Thread-safe via slot maps and a registry lock.
Payloads load through the port's `texture.py`, `material.py`, `gltf.py` and
`audio/engine.py`; all of them are host data (NumPy), so the manager touches no device.
A payload that fails to load is logged and skipped ("asset load errors are
recoverable", as in the reference).
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import threading
from pathlib import Path
from typing import Any

from ..core import uuid as uuidlib
from ..utils.slotmap import SlotMap
from .material import Material
from .texture import Texture

log = logging.getLogger("oxylus.assets")


class AssetType(enum.Enum):
    NONE = "None"
    MODEL = "Model"
    TEXTURE = "Texture"
    MATERIAL = "Material"
    SCENE = "Scene"
    AUDIO = "Audio"
    SCRIPT = "Script"


@dataclasses.dataclass
class Asset:
    uuid: str
    type: AssetType
    path: str = ""
    ref_count: int = 0
    slot_id: int | None = None  # id into the typed slot map when loaded

    @property
    def is_loaded(self) -> bool:
        return self.slot_id is not None


_EXT_TYPES = {
    ".png": AssetType.TEXTURE,
    ".jpg": AssetType.TEXTURE,
    ".jpeg": AssetType.TEXTURE,
    ".bmp": AssetType.TEXTURE,
    ".tga": AssetType.TEXTURE,
    ".npy": AssetType.TEXTURE,
    ".gltf": AssetType.MODEL,
    ".glb": AssetType.MODEL,
    ".oxmat": AssetType.MATERIAL,
    ".json": AssetType.SCENE,
    ".oxscene": AssetType.SCENE,
    ".wav": AssetType.AUDIO,
    ".mp3": AssetType.AUDIO,
    ".flac": AssetType.AUDIO,
    ".py": AssetType.SCRIPT,
    ".lua": AssetType.SCRIPT,
}


class AssetManager:
    MODULE_NAME = "AssetManager"

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._registry: dict[str, Asset] = {}
        self.textures: SlotMap[Texture] = SlotMap()
        self.materials: SlotMap[Material] = SlotMap()
        self.models: SlotMap[Any] = SlotMap()
        self.scenes: SlotMap[Any] = SlotMap()
        self.audios: SlotMap[Any] = SlotMap()
        self.scripts: SlotMap[Any] = SlotMap()

    # ------------------------------------------------------------- module hooks
    def init(self, app=None) -> None:
        pass

    def deinit(self, app=None) -> None:
        with self._lock:
            self._registry.clear()

    # ------------------------------------------------------------- sidecars
    @staticmethod
    def meta_path(path) -> Path:
        return Path(str(path) + ".oxasset")

    def import_asset(self, path) -> str | None:
        """Import a file: read or create its `.oxasset` sidecar, register it, return
        its UUID (reference `import_asset`)."""
        path = Path(path)
        if not path.exists():
            log.error("import_asset: %s does not exist", path)
            return None
        meta = self.meta_path(path)
        if meta.exists():
            data = json.loads(meta.read_text())
            asset_uuid = data.get("uuid")
            asset_type = AssetType(data.get("type", "None"))
        else:
            asset_uuid = uuidlib.generate_random()
            asset_type = _EXT_TYPES.get(path.suffix.lower(), AssetType.NONE)
            data = {"uuid": asset_uuid, "type": asset_type.value}
            if asset_type == AssetType.MATERIAL:
                data["material"] = Material().to_json()
            meta.write_text(json.dumps(data, indent=2))
        self.register_asset(asset_uuid, asset_type, str(path))
        return asset_uuid

    def register_asset(self, asset_uuid: str, asset_type: AssetType, path: str = "") -> Asset:
        """Populate the registry without loading (reference `register_asset`)."""
        with self._lock:
            existing = self._registry.get(asset_uuid)
            if existing is not None:
                if path:
                    existing.path = path
                return existing
            asset = Asset(uuid=asset_uuid, type=asset_type, path=path)
            self._registry[asset_uuid] = asset
            return asset

    def scan_directory(self, root) -> list[str]:
        """Import every recognized asset under `root` (sidecar scan, Appendix B.1)."""
        found = []
        for p in sorted(Path(root).rglob("*")):
            if p.suffix.lower() in _EXT_TYPES and p.is_file():
                u = self.import_asset(p)
                if u:
                    found.append(u)
        return found

    # ------------------------------------------------------------- registry
    def get_asset(self, asset_uuid: str) -> Asset | None:
        with self._lock:
            return self._registry.get(asset_uuid)

    def registry_snapshot(self) -> list[Asset]:
        with self._lock:
            return list(self._registry.values())

    # ------------------------------------------------------------- load/unload
    def load_asset(self, asset_uuid: str) -> Any:
        """Refcounted load (reference `load_asset`/`acquire_ref`). Returns the loaded
        payload (Texture/Material/Model/...) or None."""
        with self._lock:
            asset = self._registry.get(asset_uuid)
            if asset is None:
                log.warning("load_asset: unknown asset %s", asset_uuid)
                return None
            asset.ref_count += 1
            if asset.is_loaded:
                return self._payload(asset)
            payload = self._load_payload(asset)
            if payload is None:
                asset.ref_count -= 1
                return None
            asset.slot_id = self._slotmap_for(asset.type).create_slot(payload)
            return payload

    def unload_asset(self, asset_uuid: str) -> bool:
        """Refcounted unload (reference `release_ref`): frees at refcount zero."""
        with self._lock:
            asset = self._registry.get(asset_uuid)
            if asset is None or asset.ref_count == 0:
                return False
            asset.ref_count -= 1
            if asset.ref_count == 0 and asset.is_loaded:
                self._slotmap_for(asset.type).destroy_slot(asset.slot_id)
                asset.slot_id = None
            return True

    def _slotmap_for(self, t: AssetType) -> SlotMap:
        return {
            AssetType.TEXTURE: self.textures,
            AssetType.MATERIAL: self.materials,
            AssetType.MODEL: self.models,
            AssetType.SCENE: self.scenes,
            AssetType.AUDIO: self.audios,
            AssetType.SCRIPT: self.scripts,
        }[t]

    def _payload(self, asset: Asset) -> Any:
        return self._slotmap_for(asset.type).slot(asset.slot_id)

    def _load_payload(self, asset: Asset) -> Any:
        try:
            if asset.type == AssetType.TEXTURE:
                return Texture.load(asset.path)
            if asset.type == AssetType.MATERIAL:
                meta = self.meta_path(asset.path)
                src = meta if meta.exists() else Path(asset.path)
                data = json.loads(Path(src).read_text())
                mat = data.get("material", data if "albedo_color" in data else {})
                return Material.from_json(mat)
            if asset.type == AssetType.MODEL:
                from .gltf import load_gltf

                return load_gltf(asset.path, asset_manager=self)
            if asset.type == AssetType.SCENE:
                return json.loads(Path(asset.path).read_text())
            if asset.type == AssetType.SCRIPT:
                return Path(asset.path).read_text()
            if asset.type == AssetType.AUDIO:
                from ..audio.engine import AudioClip

                return AudioClip.load(asset.path)
        except Exception as exc:  # noqa: BLE001 — asset load errors are recoverable
            log.error("failed to load %s (%s): %s", asset.uuid, asset.path, exc)
            return None
        log.warning("no loader for asset type %s", asset.type)
        return None

    # ------------------------------------------------------------- typed getters
    def get_texture(self, asset_uuid: str) -> Texture | None:
        a = self.get_asset(asset_uuid)
        return self._payload(a) if a and a.is_loaded else None

    def get_material(self, asset_uuid: str) -> Material | None:
        a = self.get_asset(asset_uuid)
        return self._payload(a) if a and a.is_loaded else None

    def get_model(self, asset_uuid: str):
        a = self.get_asset(asset_uuid)
        return self._payload(a) if a and a.is_loaded else None

    def loaded_of_type(self, t: AssetType) -> list[tuple[str, Any]]:
        with self._lock:
            return [
                (a.uuid, self._payload(a))
                for a in self._registry.values()
                if a.type == t and a.is_loaded
            ]
