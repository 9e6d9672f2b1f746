"""Game-UI text & panel rendering (counterpart of `oxylus_tpu/ui/text.py`).

A bitmap font atlas is baked once (PIL's font rasterizer), and `UIDocument`
lays out text runs and coloured panels into the sprite-record batch of the 2D
path. `composite_over` blends that batch over a frame on the frame's own
device: a tensor on the card stays there, and a NumPy frame gives a NumPy
result, as the JAX package's host composite does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FONT_CHARS = "".join(chr(c) for c in range(32, 127))
GLYPH_W, GLYPH_H = 8, 14
TEXEL_SCALE = 15.99  # the nearest-texel index of a quad pixel: (offset / size * 15.99), truncated


def bake_font_atlas() -> tuple[np.ndarray, dict[str, tuple[float, float, float, float]]]:
    """Render the builtin monospace font into an atlas. Returns (RGBA8 atlas, rects)."""
    from PIL import Image, ImageDraw, ImageFont

    cols = 16
    rows = (len(FONT_CHARS) + cols - 1) // cols
    w, h = cols * GLYPH_W, rows * GLYPH_H
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    font = ImageFont.load_default()
    rects = {}
    for i, ch in enumerate(FONT_CHARS):
        x = (i % cols) * GLYPH_W
        y = (i // cols) * GLYPH_H
        draw.text((x, y), ch, fill=255, font=font)
        rects[ch] = (x / w, y / h, (x + GLYPH_W) / w, (y + GLYPH_H) / h)
    lum = np.asarray(img)
    rgba = np.stack([np.full_like(lum, 255)] * 3 + [lum], axis=-1)
    return rgba, rects


@dataclasses.dataclass
class UIElement:
    kind: str                  # "text" | "panel"
    x: float                   # pixels from top-left
    y: float
    text: str = ""
    color: tuple = (1.0, 1.0, 1.0, 1.0)
    w: float = 0.0             # panel size
    h: float = 0.0
    scale: float = 1.0


def _broadcast(a: tuple, b: tuple) -> tuple:
    """NumPy's broadcast of two shapes of one rank, with its `ValueError`."""
    if any(x != y and 1 not in (x, y) for x, y in zip(a, b)):
        raise ValueError(f"operands could not be broadcast together with shapes {a} {b}")
    return tuple(y if x == 1 else x for x, y in zip(a, b))


def _check_quad_shapes(frame_hw: tuple[int, int], y0: int, y1: int, x0: int, x1: int) -> None:
    """Raise where the JAX composite's NumPy blend of this quad raises. Its
    slice `out[y0:y1, x0:x1]` wraps a negative origin (Python slicing), so a
    quad that starts left of or above the frame meets a region of another
    shape; the blend then fails to broadcast, as in NumPy."""
    h, w = frame_hw
    region = (len(range(h)[y0:y1]), len(range(w)[x0:x1]), 3)
    quad = (y1 - y0, x1 - x0)
    blended = _broadcast(_broadcast(region, quad + (1,)), quad + (3,))
    if any(v not in (t, 1) for v, t in zip(blended, region)):
        raise ValueError(f"could not broadcast input array from shape {blended} into shape {region}")


class UIDocument:
    """A HUD document: retained list of elements → sprite batch (RmlView analog)."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.elements: list[UIElement] = []
        self._atlas, self._rects = bake_font_atlas()
        self.visible = True

    # ------------------------------------------------------------- authoring
    def clear(self) -> None:
        self.elements.clear()

    def add_text(self, x: float, y: float, text: str, color=(1, 1, 1, 1), scale=1.0) -> None:
        self.elements.append(UIElement("text", x, y, text=text, color=color, scale=scale))

    def add_panel(self, x: float, y: float, w: float, h: float, color=(0, 0, 0, 0.6)) -> None:
        self.elements.append(UIElement("panel", x, y, w=w, h=h, color=color))

    # ------------------------------------------------------------- batching
    def build_batch(self):
        """Returns (records (N, 16) f32, tex_tiles (N, 16, 16, 4) f32) in draw
        order, on the host."""
        quads = []  # (x, y, w, h, color, rect | None)
        for el in self.elements:
            if el.kind == "panel":
                quads.append((el.x, el.y, el.w, el.h, el.color, None))
            else:
                cx = el.x
                for ch in el.text:
                    rect = self._rects.get(ch)
                    if rect is not None and ch != " ":
                        quads.append(
                            (cx, el.y, GLYPH_W * el.scale, GLYPH_H * el.scale, el.color, rect)
                        )
                    cx += GLYPH_W * el.scale
        n = max(len(quads), 1)
        records = np.zeros((n, 16), np.float32)
        tex = np.ones((n, 16, 16, 4), np.float32)
        a = self._atlas
        ah, aw = a.shape[:2]
        for i, (x, y, w, h, color, rect) in enumerate(quads):
            records[i, 0] = x
            records[i, 1] = y
            records[i, 2] = w      # e0 = +x edge
            records[i, 3] = 0.0
            records[i, 4] = 0.0    # e1 = +y edge
            records[i, 5] = h
            records[i, 6] = 1.0 / max(w * h, 1e-6)
            records[i, 7:11] = color
            records[i, 11] = 0.0   # cutoff
            records[i, 12] = 0.0   # not masked
            records[i, 13] = 1.0 if rect is not None else 0.0
            records[i, 14] = -1.0  # no entity id
            records[i, 15] = 0.0
            if rect is not None:
                x0, y0, x1, y1 = rect
                ys = np.clip((y0 + (np.arange(16) + 0.5) / 16 * (y1 - y0)) * ah, 0, ah - 1).astype(int)
                xs = np.clip((x0 + (np.arange(16) + 0.5) / 16 * (x1 - x0)) * aw, 0, aw - 1).astype(int)
                tex[i] = a[np.ix_(ys, xs)].astype(np.float32) / 255.0
        return records, tex

    # ------------------------------------------------------------- compositing
    def composite_over(self, frame):
        """Composite the document over an (H, W, 3|4) frame; returns (H, W, 4)
        float32. A tensor frame is blended on its device and the result stays
        there; any other array gives a NumPy result."""
        if isinstance(frame, torch.Tensor):
            return self._composite(frame.to(torch.float32, copy=True))
        return self._composite(torch.from_numpy(np.array(np.asarray(frame), np.float32))).numpy()

    def _composite(self, out: torch.Tensor) -> torch.Tensor:
        """Blend the quads one by one in draw order into `out` (float32, owned):
        nearest texels at the JAX composite's indices, its float32 blend."""
        dev = out.device
        if out.shape[-1] == 3:
            out = torch.cat([out, torch.ones(out.shape[:2] + (1,), dtype=torch.float32, device=dev)], -1)
        records, tex = self.build_batch()
        h, w = out.shape[:2]
        # the quads that draw, with the JAX composite's texel indices computed on the
        # host as it computes them (float64, truncated), in one list
        quads, idx, at = [], [], 0
        for i, r in enumerate(records):
            x0, y0 = int(r[0]), int(r[1])
            qw, qh = int(r[2]), int(r[5])
            if qw <= 0 or qh <= 0:
                continue
            x1, y1 = min(x0 + qw, w), min(y0 + qh, h)
            if x1 <= x0 or y1 <= y0:
                continue
            _check_quad_shapes((h, w), y0, y1, x0, x1)
            if r[13] > 0.5:
                idx.append(((np.arange(y0, y1) - y0) / max(qh, 1) * TEXEL_SCALE).astype(int))
                idx.append(((np.arange(x0, x1) - x0) / max(qw, 1) * TEXEL_SCALE).astype(int))
                quads.append((i, y0, y1, x0, x1, at))
                at += (y1 - y0) + (x1 - x0)
            else:
                quads.append((i, y0, y1, x0, x1, -1))
        # the batch in one upload: records, texel tiles, indices (small integers, exact in float32)
        n = len(records)
        flat = [records.ravel(), tex.ravel()] + [a.astype(np.float32) for a in idx]
        batch = torch.from_numpy(np.concatenate(flat)).to(dev)
        rec = batch[: n * 16].view(n, 16)
        tiles = batch[n * 16: n * 16 + tex.size].view(tex.shape)
        index = batch[n * 16 + tex.size:].long()
        for i, y0, y1, x0, x1, at in quads:
            ny, nx = y1 - y0, x1 - x0
            if at >= 0:
                texel = tiles[i][index[at: at + ny, None], index[None, at + ny: at + ny + nx]]
            else:
                texel = torch.ones((ny, nx, 4), dtype=torch.float32, device=dev)
            rgba = texel * rec[i, 7:11]
            alpha = rgba[..., 3:4]
            out[y0:y1, x0:x1, :3] = out[y0:y1, x0:x1, :3] * (1 - alpha) + rgba[..., :3] * alpha
        return out
