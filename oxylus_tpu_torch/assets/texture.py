"""Texture asset and atlas packing (counterpart of `oxylus_tpu/assets/texture.py`).

Every texture is packed into one RGBA8 atlas (the engine's bindless table:
one gather source, no descriptors), and each resolves to a normalised atlas
rect. Shelf packing; `TextureAtlas.pack_tight` sizes the atlas to its content.
NumPy only, as in the JAX package.

Formats: PNG/JPEG/BMP/TGA through PIL, `.npy` raw arrays, procedural solid
colours, and the KTX2 (uncompressed RGBA8/RGB8, zstd-supercompressed, or
BC1/BC3/BC4/BC5/BC7 decoded at import by `bcdec.py`) and DDS (uncompressed
32-bit) containers, read as the JAX package reads them.
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
        elif path.suffix == ".ktx2":
            arr, srgb_fmt = _load_ktx2(path)
            srgb = srgb and srgb_fmt
        elif path.suffix == ".dds":
            arr = _load_dds(path)
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


# ---------------------------------------------------------------------------
# KTX2 / DDS containers (reference `Asset/Texture.hpp:77-140` loads both via
# libktx / dds parsing; here: direct container parsing for the uncompressed
# RGBA formats the engine uses, plus KTX2 zstd supercompression and BC blocks;
# the same bytes in, the same pixels and errors out as the JAX package)
# ---------------------------------------------------------------------------

_KTX2_MAGIC = b"\xabKTX 20\xbb\r\n\x1a\n"
# VkFormat codes for the 8-bit RGBA family
_VK_R8G8B8A8_UNORM = 37
_VK_R8G8B8A8_SRGB = 43
_VK_R8G8B8_UNORM = 23
_VK_R8G8B8_SRGB = 29


def _load_ktx2(path):
    """Minimal KTX2 reader: level-0 image of an uncompressed, zstd-
    supercompressed, or BC1/BC3/BC4/BC5/BC7 block-compressed texture →
    (H, W, 4) u8, srgb flag. BC data is decoded host-side at import
    (assets/bcdec.py) — the analog of the reference's libktx transcode on
    load (`Texture.cpp:177-205`)."""
    import struct

    from .bcdec import decode_bc_vkformat

    data = Path(path).read_bytes()
    if data[:12] != _KTX2_MAGIC:
        raise ValueError(f"{path}: not a KTX2 file")
    (vk_format, type_size, w, h, depth, layers, faces, levels, scheme) = struct.unpack_from(
        "<9I", data, 12
    )
    is_rgba = vk_format in (
        _VK_R8G8B8A8_UNORM, _VK_R8G8B8A8_SRGB, _VK_R8G8B8_UNORM, _VK_R8G8B8_SRGB
    )
    is_bc = 131 <= vk_format <= 146
    if not (is_rgba or is_bc):
        raise ValueError(
            f"{path}: unsupported vkFormat {vk_format} — this loader handles "
            f"uncompressed RGBA8/RGB8 (VkFormat 23/29/37/43) and the BC1/BC3/"
            f"BC4/BC5/BC7 block-compressed family (131-146); re-export the "
            f"texture in one of those (or as png) before packing"
        )
    if scheme == 1:
        raise ValueError(
            f"{path}: BasisLZ/ETC1S supercompression is not supported — "
            f"re-export uncompressed, zstd-supercompressed, or BC"
        )
    if scheme not in (0, 2):  # none | zstd
        raise ValueError(f"{path}: unsupported supercompression scheme {scheme}")
    # level index starts at byte 80 (after the two dfd/kvd/sgd offset blocks)
    lvl_off = 80
    byte_off, byte_len, uncomp_len = struct.unpack_from("<3Q", data, lvl_off)
    blob = data[byte_off : byte_off + byte_len]
    if scheme == 2:
        import zstandard

        blob = zstandard.ZstdDecompressor().decompress(blob, max_output_size=uncomp_len)
    if is_bc:
        out = decode_bc_vkformat(vk_format, bytes(blob), w, h)
        if out is None:
            raise ValueError(
                f"{path}: BC vkFormat {vk_format} (BC2/BC6H/signed variants) "
                f"is not supported — re-export as BC1/BC3/BC4/BC5/BC7"
            )
        return out
    ch = 4 if vk_format in (_VK_R8G8B8A8_UNORM, _VK_R8G8B8A8_SRGB) else 3
    arr = np.frombuffer(blob, np.uint8, count=h * w * ch).reshape(h, w, ch).copy()
    if ch == 3:
        arr = np.concatenate([arr, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    return arr, vk_format in (_VK_R8G8B8A8_SRGB, _VK_R8G8B8_SRGB)


def write_ktx2(path, pixels: np.ndarray, srgb: bool = True, zstd: bool = False) -> None:
    """Write a single-level RGBA8 KTX2 (the pack-side counterpart of _load_ktx2)."""
    import struct

    h, w = pixels.shape[:2]
    if pixels.shape[-1] == 3:
        pixels = np.concatenate([pixels, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    blob = pixels.astype(np.uint8).tobytes()
    uncomp = len(blob)
    scheme = 0
    if zstd:
        import zstandard

        blob = zstandard.ZstdCompressor().compress(blob)
        scheme = 2
    vk = _VK_R8G8B8A8_SRGB if srgb else _VK_R8G8B8A8_UNORM
    header = _KTX2_MAGIC + struct.pack("<9I", vk, 1, w, h, 0, 0, 1, 1, scheme)
    # dfd off/len + kvd off/len (4×u32) and sgd off/len (2×u64) all empty →
    # header is 80 bytes, the 1-entry level index 24, image data at 104
    header += struct.pack("<4I2Q", 0, 0, 0, 0, 0, 0)
    level_index = struct.pack("<3Q", 104, len(blob), uncomp)
    Path(path).write_bytes(header + level_index + blob)


def _load_dds(path):
    """Minimal DDS reader: uncompressed 32-bit RGBA/BGRA top mip → (H, W, 4) u8."""
    import struct

    data = Path(path).read_bytes()
    if data[:4] != b"DDS ":
        raise ValueError(f"{path}: not a DDS file")
    (size, flags, h, w) = struct.unpack_from("<4I", data, 4)
    # DDS_PIXELFORMAT sits at absolute offset 76: size, flags, fourCC, bits, masks
    _pf_size, pf_flags, fourcc, rgb_bits, r_mask, g_mask, b_mask, a_mask = struct.unpack_from(
        "<8I", data, 76
    )
    if fourcc != 0:
        raise ValueError(f"{path}: compressed DDS (fourcc) not supported; use ktx2/png")
    if rgb_bits != 32:
        raise ValueError(f"{path}: only 32-bit uncompressed DDS supported")
    raw = np.frombuffer(data, np.uint8, count=h * w * 4, offset=4 + 124).reshape(h, w, 4).copy()
    order = []
    for mask in (r_mask, g_mask, b_mask):
        order.append({0xFF: 0, 0xFF00: 1, 0xFF0000: 2, 0xFF000000: 3}[mask])
    a_idx = {0: None, 0xFF: 0, 0xFF00: 1, 0xFF0000: 2, 0xFF000000: 3}[a_mask]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = raw[..., order[0]]
    out[..., 1] = raw[..., order[1]]
    out[..., 2] = raw[..., order[2]]
    out[..., 3] = raw[..., a_idx] if a_idx is not None else 255
    return out
