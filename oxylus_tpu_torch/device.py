"""Explicit device resolution.

The port runs on the card unless the caller asks for the CPU, and never falls
back: asking for a card (explicitly, or by passing no device) on a machine
without a usable one raises, so a run that was meant for the GPU cannot quietly
measure the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` or `"cuda"` → the first card, `"cuda:N"` → that card, each
    `RuntimeError` when PyTorch sees no card (or fewer than N+1); `"cpu"` → the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but torch.cuda.is_available() is false")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"cuda:{index} requested but only {torch.cuda.device_count()} device(s) exist"
            )
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} (cpu or cuda)")
    return dev
