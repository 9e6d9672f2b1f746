"""Host-side BC (block-compression) texture decode: BC1/BC3/BC4/BC5/BC7 (a copy of
`oxylus_tpu/assets/bcdec.py`, NumPy only; every decoder gives the JAX package's bytes).

The reference transcodes compressed KTX2 via libktx on load
(`Oxylus/src/Asset/Texture.cpp:177-205`); real glTF asset sets ship BC-compressed
textures, so the importer must accept them. Textures live in the engine's RGBA8 atlas
(the bindless table that feeds the sampler), so BC data is decoded ONCE at import on
the host — vectorized numpy over 4×4 blocks, grouped by mode for BC7. BC7's index
reads walk per-block Python-int cursors (variable-width anchors), as in the reference:
import-time work, bit-exact.

Formats follow the D3D/Khronos data-format specs:
- BC1: 2×RGB565 endpoints + 2-bit palette indices (3-color+punch-through mode
  when c0 <= c1).
- BC4: 2×u8 endpoints + 3-bit indices, 8-entry palette (6-entry + 0/255 mode).
- BC3: BC4 alpha block + BC1 color block (always 4-color).
- BC5: two BC4 blocks (R, G); Z is reconstructed at decode time (BC5 sources
  are tangent-space normal maps — the reference's two-component variants,
  `visbuffer_decode.slang:160-170`).
- BC7: all 8 modes with partition/anchor tables, p-bits, per-block rotation
  and index-selection bits.
"""

from __future__ import annotations

import numpy as np


def _u16le(b0, b1):
    return b0.astype(np.uint32) | (b1.astype(np.uint32) << 8)


def _expand565(c):
    """Shift-replicate expansion (the D3D convention; matches HW decoders)."""
    r5 = (c >> 11) & 31
    g6 = (c >> 5) & 63
    b5 = c & 31
    return (r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)


def _bc1_palette(c0, c1, always_4color: bool):
    """(N,) u32 endpoint pairs → palette (N, 4, 4) u8 rgba."""
    n = c0.shape[0]
    pal = np.zeros((n, 4, 4), np.uint16)
    r0, g0, b0 = _expand565(c0)
    r1, g1, b1 = _expand565(c1)
    pal[:, 0] = np.stack([r0, g0, b0, np.full(n, 255)], -1)
    pal[:, 1] = np.stack([r1, g1, b1, np.full(n, 255)], -1)
    four = (c0 > c1) | always_4color
    # 4-color: 2/3 and 1/3 interpolants; 3-color: midpoint + transparent black
    p2_4 = (2 * pal[:, 0].astype(np.uint32) + pal[:, 1]) // 3
    p3_4 = (pal[:, 0].astype(np.uint32) + 2 * pal[:, 1]) // 3
    p2_3 = (pal[:, 0].astype(np.uint32) + pal[:, 1]) // 2
    p3_3 = np.zeros((n, 4), np.uint32)
    pal[:, 2] = np.where(four[:, None], p2_4, p2_3)
    pal[:, 3] = np.where(four[:, None], p3_4, p3_3)
    pal[:, 2, 3] = 255
    pal[:, 3, 3] = np.where(four, 255, 0)
    return pal.astype(np.uint8)


def _decode_bc1_blocks(blk: np.ndarray, always_4color=False) -> np.ndarray:
    """(N, 8) u8 → (N, 16, 4) u8 (texels row-major within the 4×4 block)."""
    c0 = _u16le(blk[:, 0], blk[:, 1])
    c1 = _u16le(blk[:, 2], blk[:, 3])
    pal = _bc1_palette(c0, c1, always_4color)
    bits = (
        blk[:, 4].astype(np.uint32)
        | (blk[:, 5].astype(np.uint32) << 8)
        | (blk[:, 6].astype(np.uint32) << 16)
        | (blk[:, 7].astype(np.uint32) << 24)
    )
    idx = (bits[:, None] >> (2 * np.arange(16, dtype=np.uint32))[None, :]) & 3
    return np.take_along_axis(pal, idx[..., None].astype(np.int64), axis=1)


def _decode_bc4_blocks(blk: np.ndarray) -> np.ndarray:
    """(N, 8) u8 → (N, 16) u8 single-channel."""
    a0 = blk[:, 0].astype(np.int32)
    a1 = blk[:, 1].astype(np.int32)
    pal = np.zeros((blk.shape[0], 8), np.int32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    six = a0 > a1
    for i in range(2, 8):
        pal[:, i] = np.where(
            six,
            ((8 - i) * a0 + (i - 1) * a1) // 7,
            0,
        )
    for i in range(2, 6):
        alt = ((6 - i) * a0 + (i - 1) * a1) // 5
        pal[:, i] = np.where(six, pal[:, i], alt)
    pal[:, 6] = np.where(six, pal[:, 6], 0)
    pal[:, 7] = np.where(six, pal[:, 7], 255)
    bits = np.zeros(blk.shape[0], np.uint64)
    for i in range(6):
        bits |= blk[:, 2 + i].astype(np.uint64) << np.uint64(8 * i)
    idx = (bits[:, None] >> (3 * np.arange(16, dtype=np.uint64))[None, :]) & np.uint64(7)
    return np.take_along_axis(pal, idx.astype(np.int64), axis=1).astype(np.uint8)


def _blocks_to_image(tex: np.ndarray, w: int, h: int) -> np.ndarray:
    """(N, 16, C) block texels → (h, w, C) image (blocks row-major)."""
    bw, bh = (w + 3) // 4, (h + 3) // 4
    c = tex.shape[-1]
    img = tex.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, c)
    return img[:h, :w]


def decode_bc1(data: bytes, w: int, h: int) -> np.ndarray:
    blk = np.frombuffer(data, np.uint8).reshape(-1, 8)
    return _blocks_to_image(_decode_bc1_blocks(blk), w, h)


def decode_bc3(data: bytes, w: int, h: int) -> np.ndarray:
    blk = np.frombuffer(data, np.uint8).reshape(-1, 16)
    rgba = _decode_bc1_blocks(blk[:, 8:16], always_4color=True)
    rgba[..., 3] = _decode_bc4_blocks(blk[:, 0:8])
    return _blocks_to_image(rgba, w, h)


def decode_bc4(data: bytes, w: int, h: int) -> np.ndarray:
    blk = np.frombuffer(data, np.uint8).reshape(-1, 8)
    r = _decode_bc4_blocks(blk)
    n = blk.shape[0]
    tex = np.zeros((n, 16, 4), np.uint8)
    tex[..., 0] = r
    tex[..., 3] = 255
    return _blocks_to_image(tex, w, h)


def decode_bc5(data: bytes, w: int, h: int) -> np.ndarray:
    """BC5 RG → RGBA with Z reconstructed (tangent-space normal convention)."""
    blk = np.frombuffer(data, np.uint8).reshape(-1, 16)
    r = _decode_bc4_blocks(blk[:, 0:8]).astype(np.float32) / 255.0
    g = _decode_bc4_blocks(blk[:, 8:16]).astype(np.float32) / 255.0
    x = r * 2.0 - 1.0
    y = g * 2.0 - 1.0
    z = np.sqrt(np.clip(1.0 - x * x - y * y, 0.0, 1.0))
    n = blk.shape[0]
    tex = np.zeros((n, 16, 4), np.uint8)
    tex[..., 0] = np.round(r * 255).astype(np.uint8)
    tex[..., 1] = np.round(g * 255).astype(np.uint8)
    tex[..., 2] = np.round((z * 0.5 + 0.5) * 255).astype(np.uint8)
    tex[..., 3] = 255
    return _blocks_to_image(tex, w, h)


# ---------------------------------------------------------------------------
# BC7
# ---------------------------------------------------------------------------

# mode table: (subsets, partition_bits, rotation_bits, index_sel_bits,
#              color_bits, alpha_bits, endpoint_pbits, shared_pbits,
#              index_bits, index2_bits)
_BC7_MODES = [
    (3, 4, 0, 0, 4, 0, 1, 0, 3, 0),
    (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
    (3, 6, 0, 0, 5, 0, 0, 0, 2, 0),
    (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
    (1, 0, 2, 1, 5, 6, 0, 0, 2, 3),
    (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
    (1, 0, 0, 0, 7, 7, 1, 0, 4, 0),
    (2, 6, 0, 0, 5, 5, 1, 0, 2, 0),
]

_BC7_PART2 = np.array([  # 64 partitions x 16 texels, subset 0/1
    [0,0,1,1,0,0,1,1,0,0,1,1,0,0,1,1],[0,0,0,1,0,0,0,1,0,0,0,1,0,0,0,1],
    [0,1,1,1,0,1,1,1,0,1,1,1,0,1,1,1],[0,0,0,1,0,0,1,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,1,0,0,0,1,0,0,1,1],[0,0,1,1,0,1,1,1,0,1,1,1,1,1,1,1],
    [0,0,0,1,0,0,1,1,0,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,1,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,0,0,0,0,1,0,0,1,1],[0,0,1,1,0,1,1,1,1,1,1,1,1,1,1,1],
    [0,0,0,0,0,0,0,1,0,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,0,0,0,0,1,0,1,1,1],
    [0,0,0,1,0,1,1,1,1,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,0,1,1,1,1,1,1,1,1],
    [0,0,0,0,1,1,1,1,1,1,1,1,1,1,1,1],[0,0,0,0,0,0,0,0,0,0,0,0,1,1,1,1],
    [0,0,0,0,1,0,0,0,1,1,1,0,1,1,1,1],[0,1,1,1,0,0,0,1,0,0,0,0,0,0,0,0],
    [0,0,0,0,0,0,0,0,1,0,0,0,1,1,1,0],[0,1,1,1,0,0,1,1,0,0,0,1,0,0,0,0],
    [0,0,1,1,0,0,0,1,0,0,0,0,0,0,0,0],[0,0,0,0,1,0,0,0,1,1,0,0,1,1,1,0],
    [0,0,0,0,0,0,0,0,1,0,0,0,1,1,0,0],[0,1,1,1,0,0,1,1,0,0,1,1,0,0,0,1],
    [0,0,1,1,0,0,0,1,0,0,0,1,0,0,0,0],[0,0,0,0,1,0,0,0,1,0,0,0,1,1,0,0],
    [0,1,1,0,0,1,1,0,0,1,1,0,0,1,1,0],[0,0,1,1,0,1,1,0,0,1,1,0,1,1,0,0],
    [0,0,0,1,0,1,1,1,1,1,1,0,1,0,0,0],[0,0,0,0,1,1,1,1,1,1,1,1,0,0,0,0],
    [0,1,1,1,0,0,0,1,1,0,0,0,1,1,1,0],[0,0,1,1,1,0,0,1,1,0,0,1,1,1,0,0],
    [0,1,0,1,0,1,0,1,0,1,0,1,0,1,0,1],[0,0,0,0,1,1,1,1,0,0,0,0,1,1,1,1],
    [0,1,0,1,1,0,1,0,0,1,0,1,1,0,1,0],[0,0,1,1,0,0,1,1,1,1,0,0,1,1,0,0],
    [0,0,1,1,1,1,0,0,0,0,1,1,1,1,0,0],[0,1,0,1,0,1,0,1,1,0,1,0,1,0,1,0],
    [0,1,1,0,1,0,0,1,0,1,1,0,1,0,0,1],[0,1,0,1,1,0,1,0,1,0,1,0,0,1,0,1],
    [0,1,1,1,0,0,1,1,1,1,0,0,1,1,1,0],[0,0,0,1,0,0,1,1,1,1,0,0,1,0,0,0],
    [0,0,1,1,0,0,1,0,0,1,0,0,1,1,0,0],[0,0,1,1,1,0,1,1,1,1,0,1,1,1,0,0],
    [0,1,1,0,1,0,0,1,1,0,0,1,0,1,1,0],[0,0,1,1,1,1,0,0,1,1,0,0,0,0,1,1],
    [0,1,1,0,0,1,1,0,1,0,0,1,1,0,0,1],[0,0,0,0,0,1,1,0,0,1,1,0,0,0,0,0],
    [0,1,0,0,1,1,1,0,0,1,0,0,0,0,0,0],[0,0,1,0,0,1,1,1,0,0,1,0,0,0,0,0],
    [0,0,0,0,0,0,1,0,0,1,1,1,0,0,1,0],[0,0,0,0,0,1,0,0,1,1,1,0,0,1,0,0],
    [0,1,1,0,1,1,0,0,1,0,0,1,0,0,1,1],[0,0,1,1,0,1,1,0,1,1,0,0,1,0,0,1],
    [0,1,1,0,0,0,1,1,1,0,0,1,1,1,0,0],[0,0,1,1,1,0,0,1,1,1,0,0,0,1,1,0],
    [0,1,1,0,1,1,0,0,1,1,0,0,1,0,0,1],[0,1,1,0,0,0,1,1,0,0,1,1,1,0,0,1],
    [0,1,1,1,1,1,1,0,1,0,0,0,0,0,0,1],[0,0,0,1,1,0,0,0,1,1,1,0,0,1,1,1],
    [0,0,0,0,1,1,1,1,0,0,1,1,0,0,1,1],[0,0,1,1,0,0,1,1,1,1,1,1,0,0,0,0],
    [0,0,1,0,0,0,1,0,1,1,1,0,1,1,1,0],[0,1,0,0,0,1,0,0,0,1,1,1,0,1,1,1],
], np.int64)

_BC7_PART3 = np.array([
    [0,0,1,1,0,0,1,1,0,2,2,1,2,2,2,2],[0,0,0,1,0,0,1,1,2,2,1,1,2,2,2,1],
    [0,0,0,0,2,0,0,1,2,2,1,1,2,2,1,1],[0,2,2,2,0,0,2,2,0,0,1,1,0,1,1,1],
    [0,0,0,0,0,0,0,0,1,1,2,2,1,1,2,2],[0,0,1,1,0,0,1,1,0,0,2,2,0,0,2,2],
    [0,0,2,2,0,0,2,2,1,1,1,1,1,1,1,1],[0,0,1,1,0,0,1,1,2,2,1,1,2,2,1,1],
    [0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2],[0,0,0,0,1,1,1,1,1,1,1,1,2,2,2,2],
    [0,0,0,0,1,1,1,1,2,2,2,2,2,2,2,2],[0,0,1,2,0,0,1,2,0,0,1,2,0,0,1,2],
    [0,1,1,2,0,1,1,2,0,1,1,2,0,1,1,2],[0,1,2,2,0,1,2,2,0,1,2,2,0,1,2,2],
    [0,0,1,1,0,1,1,2,1,1,2,2,1,2,2,2],[0,0,1,1,2,0,0,1,2,2,0,0,2,2,2,0],
    [0,0,0,1,0,0,1,1,0,1,1,2,1,1,2,2],[0,1,1,1,0,0,1,1,2,0,0,1,2,2,0,0],
    [0,0,0,0,1,1,2,2,1,1,2,2,1,1,2,2],[0,0,2,2,0,0,2,2,0,0,2,2,1,1,1,1],
    [0,1,1,1,0,1,1,1,0,2,2,2,0,2,2,2],[0,0,0,1,0,0,0,1,2,2,2,1,2,2,2,1],
    [0,0,0,0,0,0,1,1,0,1,2,2,0,1,2,2],[0,0,0,0,1,1,0,0,2,2,1,0,2,2,1,0],
    [0,1,2,2,0,1,2,2,0,0,1,1,0,0,0,0],[0,0,1,2,0,0,1,2,1,1,2,2,2,2,2,2],
    [0,1,1,0,1,2,2,1,1,2,2,1,0,1,1,0],[0,0,0,0,0,1,1,0,1,2,2,1,1,2,2,1],
    [0,0,2,2,1,1,0,2,1,1,0,2,0,0,2,2],[0,1,1,0,0,1,1,0,2,0,0,2,2,2,2,2],
    [0,0,1,1,0,1,2,2,0,1,2,2,0,0,1,1],[0,0,0,0,2,0,0,0,2,2,1,1,2,2,2,1],
    [0,0,0,0,0,0,0,2,1,1,2,2,1,2,2,2],[0,2,2,2,0,0,2,2,0,0,1,2,0,0,1,1],
    [0,0,1,1,0,0,1,2,0,0,2,2,0,2,2,2],[0,1,2,0,0,1,2,0,0,1,2,0,0,1,2,0],
    [0,0,0,0,1,1,1,1,2,2,2,2,0,0,0,0],[0,1,2,0,1,2,0,1,2,0,1,2,0,1,2,0],
    [0,1,2,0,2,0,1,2,1,2,0,1,0,1,2,0],[0,0,1,1,2,2,0,0,1,1,2,2,0,0,1,1],
    [0,0,1,1,1,1,2,2,2,2,0,0,0,0,1,1],[0,1,0,1,0,1,0,1,2,2,2,2,2,2,2,2],
    [0,0,0,0,0,0,0,0,2,1,2,1,2,1,2,1],[0,0,2,2,1,1,2,2,0,0,2,2,1,1,2,2],
    [0,0,2,2,0,0,1,1,0,0,2,2,0,0,1,1],[0,2,2,0,1,2,2,1,0,2,2,0,1,2,2,1],
    [0,1,0,1,2,2,2,2,2,2,2,2,0,1,0,1],[0,0,0,0,2,1,2,1,2,1,2,1,2,1,2,1],
    [0,1,0,1,0,1,0,1,0,1,0,1,2,2,2,2],[0,2,2,2,0,1,1,1,0,2,2,2,0,1,1,1],
    [0,0,0,2,1,1,1,2,0,0,0,2,1,1,1,2],[0,0,0,0,2,1,1,2,2,1,1,2,2,1,1,2],
    [0,2,2,2,0,1,1,1,0,1,1,1,0,2,2,2],[0,0,0,2,1,1,1,2,1,1,1,2,0,0,0,2],
    [0,1,1,0,0,1,1,0,0,1,1,0,2,2,2,2],[0,0,0,0,0,0,0,0,2,1,1,2,2,1,1,2],
    [0,1,1,0,0,1,1,0,2,2,2,2,2,2,2,2],[0,0,2,2,0,0,1,1,0,0,1,1,0,0,2,2],
    [0,0,2,2,1,1,2,2,1,1,2,2,0,0,2,2],[0,0,0,0,0,0,0,0,0,0,0,0,2,1,1,2],
    [0,0,0,2,0,0,0,1,0,0,0,2,0,0,0,1],[0,2,2,2,1,2,2,2,0,2,2,2,1,2,2,2],
    [0,1,0,1,2,2,2,2,2,2,2,2,2,2,2,2],[0,1,1,1,2,0,1,1,2,2,0,1,2,2,2,0],
], np.int64)

_BC7_ANCHOR2 = np.array([
    15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,15,
    15,2,8,2,2,8,8,15,2,8,2,2,8,8,2,2,
    15,15,6,8,2,8,15,15,2,8,2,2,2,15,15,6,
    6,2,6,8,15,15,2,2,15,15,15,15,15,2,2,15,
], np.int64)
_BC7_ANCHOR3_2 = np.array([
    3,3,15,15,8,3,15,15,8,8,6,6,6,5,3,3,
    3,3,8,15,3,3,6,10,5,8,8,6,8,5,15,15,
    8,15,3,5,6,10,8,15,15,3,15,5,15,15,15,15,
    3,15,5,5,5,8,5,10,5,10,8,13,15,12,3,3,
], np.int64)
_BC7_ANCHOR3_3 = np.array([
    15,8,8,3,15,15,3,8,15,15,15,15,15,15,15,8,
    15,8,15,3,15,8,15,8,3,15,6,10,15,15,10,8,
    15,3,15,10,10,8,9,10,6,15,8,15,3,6,6,8,
    15,3,15,15,15,15,15,15,15,15,15,15,3,15,15,8,
], np.int64)

_BC7_WEIGHTS = {
    2: np.array([0, 21, 43, 64], np.int64),
    3: np.array([0, 9, 18, 27, 37, 46, 55, 64], np.int64),
    4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64], np.int64),
}


class _BitReader:
    """Vectorized LSB-first bit reader over (N, 16) u8 blocks."""

    def __init__(self, blk: np.ndarray):
        self.bits = np.zeros(blk.shape[0], object)
        for i in range(16):
            self.bits |= blk[:, i].astype(object) << (8 * i)
        self.pos = 0

    def read(self, n: int) -> np.ndarray:
        if n == 0:
            return np.zeros(len(self.bits), np.int64)
        out = np.array([int((b >> self.pos) & ((1 << n) - 1)) for b in self.bits],
                       np.int64)
        self.pos += n
        return out


def _decode_bc7_mode(blk: np.ndarray, mode: int) -> np.ndarray:
    """(N, 16) u8 blocks known to be `mode` → (N, 16, 4) u8 texels."""
    n = blk.shape[0]
    (ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2) = _BC7_MODES[mode]
    rd = _BitReader(blk)
    rd.read(mode + 1)  # mode prefix (mode zeros then a one)
    part = rd.read(pb)
    rot = rd.read(rb)
    idx_sel = rd.read(isb)

    # endpoints: color channels then alpha, subset-major per channel pair
    n_ep = ns * 2
    eps = np.zeros((n, n_ep, 4), np.int64)
    for c in range(3):
        for e in range(n_ep):
            eps[:, e, c] = rd.read(cb)
    if ab:
        for e in range(n_ep):
            eps[:, e, 3] = rd.read(ab)
    # p-bits: per-endpoint or shared per-subset
    total_cb = cb + (1 if (epb or spb) else 0)
    total_ab = (ab + (1 if (epb or spb) else 0)) if ab else 0
    if epb:
        for e in range(n_ep):
            p = rd.read(1)
            eps[:, e, :3] = (eps[:, e, :3] << 1) | p[:, None]
            if ab:
                eps[:, e, 3] = (eps[:, e, 3] << 1) | p
    elif spb:
        for s in range(ns):
            p = rd.read(1)
            for e in (2 * s, 2 * s + 1):
                eps[:, e, :3] = (eps[:, e, :3] << 1) | p[:, None]
                if ab:
                    eps[:, e, 3] = (eps[:, e, 3] << 1) | p
    # expand endpoints to 8 bits
    eps[..., :3] = (eps[..., :3] << (8 - total_cb)) | (
        eps[..., :3] >> (2 * total_cb - 8)
    )
    if ab:
        eps[..., 3] = (eps[..., 3] << (8 - total_ab)) | (
            eps[..., 3] >> (2 * total_ab - 8)
        )
    else:
        eps[..., 3] = 255

    # subset assignment + anchors
    if ns == 1:
        subset = np.zeros((n, 16), np.int64)
        anchors = [np.zeros(n, np.int64)]
    elif ns == 2:
        subset = _BC7_PART2[part]
        anchors = [np.zeros(n, np.int64), _BC7_ANCHOR2[part]]
    else:
        subset = _BC7_PART3[part]
        anchors = [np.zeros(n, np.int64), _BC7_ANCHOR3_2[part], _BC7_ANCHOR3_3[part]]

    # variable-width anchor reads break pure vectorization — decode indices +
    # interpolation with per-block Python-int cursors (import-time only; a few
    # thousand blocks per mode per texture)
    vals = [int(b) for b in rd.bits]
    pos0 = rd.pos

    texel = np.zeros((n, 16, 4), np.uint8)
    w1 = _BC7_WEIGHTS[ib]
    w2 = _BC7_WEIGHTS[ib2] if ib2 else None
    for bi in range(n):
        b = vals[bi]
        pos = pos0
        idx1 = np.zeros(16, np.int64)
        for t in range(16):
            s = subset[bi, t]
            is_anchor = any(anchors[k][bi] == t and s == k for k in range(len(anchors)))
            nb = ib - 1 if is_anchor else ib
            idx1[t] = (b >> pos) & ((1 << nb) - 1)
            pos += nb
        idx2 = np.zeros(16, np.int64)
        if ib2:
            for t in range(16):
                nb = ib2 - 1 if t == 0 else ib2
                idx2[t] = (b >> pos) & ((1 << nb) - 1)
                pos += nb
        for t in range(16):
            s = subset[bi, t]
            e0 = eps[bi, 2 * s]
            e1 = eps[bi, 2 * s + 1]
            if ib2:
                # two index sets: set 1 drives color + set 2 alpha, swapped by
                # the index-selection bit (modes 4/5)
                wc = w1[idx1[t]] if not idx_sel[bi] else w2[idx2[t]]
                wa = w2[idx2[t]] if not idx_sel[bi] else w1[idx1[t]]
            else:
                wc = wa = w1[idx1[t]]
            col = (e0 * (64 - wc) + e1 * wc + 32) >> 6
            col[3] = (e0[3] * (64 - wa) + e1[3] * wa + 32) >> 6
            r = int(rot[bi])
            if r:  # rotation swaps alpha with a color channel
                col[[r - 1, 3]] = col[[3, r - 1]]
            texel[bi, t] = col.astype(np.uint8)
    return texel


def decode_bc7(data: bytes, w: int, h: int) -> np.ndarray:
    blk = np.frombuffer(data, np.uint8).reshape(-1, 16)
    n = blk.shape[0]
    # mode = index of lowest set bit of byte 0
    b0 = blk[:, 0]
    mode = np.full(n, 8, np.int64)
    for m in range(7, -1, -1):
        mode[(b0 & ((1 << (m + 1)) - 1)) == (1 << m)] = m
    tex = np.zeros((n, 16, 4), np.uint8)
    for m in range(8):
        sel = mode == m
        if sel.any():
            tex[sel] = _decode_bc7_mode(blk[sel], m)
    # reserved mode 8: decode as transparent black (spec behavior)
    return _blocks_to_image(tex, w, h)


# VkFormat → decoder dispatch (KTX2 loader)
_VK_BC = {
    131: (decode_bc1, False), 132: (decode_bc1, True),
    133: (decode_bc1, False), 134: (decode_bc1, True),
    137: (decode_bc3, False), 138: (decode_bc3, True),
    139: (decode_bc4, False), 141: (decode_bc5, False),
    145: (decode_bc7, False), 146: (decode_bc7, True),
}


def decode_bc_vkformat(vk_format: int, data: bytes, w: int, h: int):
    """(rgba u8 image, srgb flag) for a supported BC VkFormat, else None."""
    entry = _VK_BC.get(vk_format)
    if entry is None:
        return None
    fn, srgb = entry
    return fn(data, w, h), srgb
