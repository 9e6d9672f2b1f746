"""Texture asset and atlas packing (counterpart of `oxylus_tpu/assets/texture.py`).

Every texture is packed into one RGBA8 atlas (the engine's bindless table:
one gather source, no descriptors), and each resolves to a normalised atlas
rect. Shelf packing; `TextureAtlas.pack_tight` sizes the atlas to its content.
NumPy only, as in the JAX package.

Formats: PNG/JPEG/BMP/TGA through PIL, `.npy` raw arrays, procedural solid
colours. The KTX2 and DDS containers (their BC block decoder) are not ported
yet: `Texture.load` raises NotImplementedError for them.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Texture:
    name: str
    pixels: np.ndarray  # (H, W, 4) uint8
    srgb: bool = True

    @property
    def height(self) -> int:
        return self.pixels.shape[0]

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @classmethod
    def load(cls, path, name: str | None = None, srgb: bool = True) -> "Texture":
        path = Path(path)
        if path.suffix == ".npy":
            arr = np.load(path)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        elif path.suffix in (".ktx2", ".dds"):
            raise NotImplementedError(
                f"{path.suffix} textures (the KTX2/DDS containers and their BC decoder) are not ported to "
                "oxylus_tpu_torch yet; convert to png"
            )
        else:
            from PIL import Image

            arr = np.asarray(Image.open(path).convert("RGBA"))
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 4, axis=-1)
        if arr.shape[-1] == 3:
            arr = np.concatenate([arr, np.full(arr.shape[:2] + (1,), 255, np.uint8)], axis=-1)
        return cls(name=name or path.stem, pixels=arr, srgb=srgb)

    @classmethod
    def solid(cls, name: str, rgba, size: int = 4) -> "Texture":
        px = np.zeros((size, size, 4), np.uint8)
        px[...] = np.asarray(rgba, np.uint8)
        return cls(name=name, pixels=px, srgb=False)

    def generate_mips(self) -> list[np.ndarray]:
        """Box-filter mip chain down to 1×1."""
        mips = [self.pixels]
        cur = self.pixels.astype(np.float32)
        while cur.shape[0] > 1 or cur.shape[1] > 1:
            h = max(1, cur.shape[0] // 2)
            w = max(1, cur.shape[1] // 2)
            cur = cur[: h * 2, : w * 2].reshape(h, 2, w, 2, 4).mean(axis=(1, 3))
            mips.append(cur.astype(np.uint8))
        return mips


@dataclasses.dataclass
class AtlasRegion:
    x: int
    y: int
    w: int
    h: int

    def rect_uv(self, atlas_size: int) -> tuple[float, float, float, float]:
        s = float(atlas_size)
        return (self.x / s, self.y / s, (self.x + self.w) / s, (self.y + self.h) / s)


class TextureAtlas:
    """Shelf-packed RGBA8 atlas. Call `add` per texture, then `build()` → (array, rects)."""

    def __init__(self, size: int = 2048, padding: int = 1):
        self.size = size
        self.padding = padding
        self._pixels = np.zeros((size, size, 4), np.uint8)
        self._regions: dict[str, AtlasRegion] = {}
        self._shelf_y = 0
        self._shelf_h = 0
        self._cursor_x = 0

    def add(self, key: str, tex: Texture) -> AtlasRegion:
        if key in self._regions:
            return self._regions[key]
        h, w = tex.height, tex.width
        if w > self.size or h > self.size:
            raise ValueError(f"texture {key} ({w}x{h}) exceeds atlas size {self.size}")
        if self._cursor_x + w + self.padding > self.size:
            self._shelf_y += self._shelf_h + self.padding
            self._cursor_x = 0
            self._shelf_h = 0
        if self._shelf_y + h + self.padding > self.size:
            raise ValueError(f"texture atlas full packing {key}")
        region = AtlasRegion(self._cursor_x, self._shelf_y, w, h)
        self._pixels[region.y : region.y + h, region.x : region.x + w] = tex.pixels
        self._cursor_x += w + self.padding
        self._shelf_h = max(self._shelf_h, h)
        self._regions[key] = region
        return region

    def build(self):
        rects = {k: r.rect_uv(self.size) for k, r in self._regions.items()}
        return self._pixels, rects

    @classmethod
    def pack_tight(cls, textures: dict[str, "Texture"], padding: int = 1, max_size: int = 4096):
        """Pack at the smallest multiple-of-128 square that fits, growing by
        128 on failure (tallest first). Returns (pixels, rects)."""
        area = sum((t.width + padding) * (t.height + padding) for t in textures.values())
        side = max(128, -(-int(np.ceil(np.sqrt(area * 1.1))) // 128) * 128)
        while side <= max_size:
            atlas = cls(size=side, padding=padding)
            try:
                for k in sorted(textures, key=lambda k: -textures[k].height):
                    atlas.add(k, textures[k])
                return atlas.build()
            except ValueError:
                side += 128
        raise ValueError(f"textures exceed max atlas size {max_size}")

    @property
    def regions(self) -> dict[str, AtlasRegion]:
        return dict(self._regions)
