"""Window / surface abstraction — headless-first (counterpart of
`oxylus_tpu/core/window.py`).

The reference wraps SDL3 + a Vulkan swapchain (`Oxylus/include/Render/Window.hpp`,
swapchain in RenderContext). Headless, a `Window` is a present target that receives
final frames, keeps the latest one on the host as uint8, and can encode it to PNG.
Resize events flow through the app event system like the reference's SDL events.

`present` converts a float frame to uint8 on the frame's own device (clip to [0, 1],
multiply by 255, truncate: the JAX window's `np.clip(...) * 255` then
`astype(np.uint8)`), then copies the uint8 frame to the host once: 6.2 MB at 1080p
instead of 24.9 MB of float32.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch


@dataclasses.dataclass
class WindowResizeEvent:
    width: int
    height: int


def frame_to_uint8(frame) -> torch.Tensor:
    """(H, W, 3|4) float in [0, 1] or uint8 → uint8 on the frame's device."""
    frame = torch.as_tensor(frame)
    if frame.dtype == torch.uint8:
        return frame
    return (frame.clamp(0.0, 1.0) * 255).to(torch.uint8)


class Window:
    def __init__(self, width: int = 1920, height: int = 1080, title: str = "oxylus_tpu"):
        self.width = width
        self.height = height
        self.title = title
        self.latest_frame: np.ndarray | None = None
        self.presented_frames = 0

    @property
    def extent(self) -> tuple[int, int]:
        return self.width, self.height

    def resize(self, width: int, height: int, event_system=None) -> None:
        self.width = width
        self.height = height
        if event_system is not None:
            event_system.emit(WindowResizeEvent(width, height))

    def present(self, frame) -> None:
        """Accept a (H, W, 3|4) float [0,1] or uint8 frame (a tensor on any device,
        or a host array)."""
        self.latest_frame = frame_to_uint8(frame).cpu().numpy()
        self.presented_frames += 1

    def save_png(self, path) -> Path:
        if self.latest_frame is None:
            raise RuntimeError("no frame presented yet")
        from PIL import Image

        path = Path(path)
        arr = self.latest_frame
        if arr.shape[-1] == 3:
            img = Image.fromarray(arr, "RGB")
        else:
            img = Image.fromarray(arr, "RGBA")
        img.save(path)
        return path
