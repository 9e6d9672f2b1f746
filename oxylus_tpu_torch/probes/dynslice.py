"""The windowed banded gather of `scripts/probe_dynslice.py::kernel` (the TPU
probe of dynamic 128-aligned lane slices that made the 10k-body compact kernel
possible), as a Hopper probe.

The TPU kernel walks 8 chunks of 128 lanes; chunk c reads the 256-lane window
at `ws = clamp(128c, 0, 768)` and multiplies it, cast to bf16, by a one-hot
matrix built from `d`. The one-hot product has one term, so with
`i = 128c + j`:

    out[r, i] = bf16(x[r, i + d[i]])   when 0 <= i + d[i] - ws < 256, else 0

and the scratch echo at its end adds chunk 0's row 0 once more, so
`out[0, 0:128]` is doubled. `dynslice` computes that: on a CUDA tensor by the
kernel `csrc/dynslice.cu` (one block, one thread per output lane), on a CPU
tensor by `dynslice_reference`. Both are exact: they equal the JAX kernel bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import dispatch, expect_equal, launch, require, result, time_us

B, BCHUNK, BAND, SLAB = 1024, 128, 128, 256

LAUNCHES = 0


def script_inputs(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's inputs: x (2, 1024) normal from seed 0, d (1, 1024) in [1, 128) from seed 1."""
    dev = resolve_device(device)
    x = np.random.default_rng(0).normal(size=(2, B)).astype(np.float32)
    d = np.random.default_rng(1).integers(1, BAND, size=(1, B)).astype(np.int32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev)


def seeded_inputs(seed: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Offsets in [-40, 300), so targets fall before, inside and past each window."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, B)) * 10.0).astype(np.float32)
    d = rng.integers(-40, 300, size=(1, B)).astype(np.int32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev)


def dynslice_reference(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version."""
    i = torch.arange(B, device=x.device)
    ws = torch.clamp((i // BCHUNK) * BCHUNK, 0, B - SLAB)
    src = i + d[0].long()
    inside = (src - ws >= 0) & (src - ws < SLAB)
    vals = x[:, torch.clamp(src, 0, B - 1)].to(torch.bfloat16).float()
    out = torch.where(inside[None, :], vals, torch.zeros_like(vals))
    out[0, :BCHUNK] = out[0, :BCHUNK] + out[0, :BCHUNK]
    return out


def _dynslice_cuda(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    out = torch.empty_like(x)
    launch("probe_dynslice", x.device, x.data_ptr(), d.data_ptr(), out.data_ptr())
    LAUNCHES += 1
    return out


def dynslice(x: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """x (2, 1024) float32, d (1, 1024) int32 → (2, 1024) float32."""
    require(x, torch.float32, (2, B), "x")
    require(d, torch.int32, (1, B), "d")
    return dispatch(lambda: _dynslice_cuda(x, d), lambda: dynslice_reference(x, d), x, d)


def run_probes(device=None, reps: int = 20) -> list[dict]:
    """The script's probe on its inputs: checked against the plain version on
    CPU copies, timed over `reps` calls."""
    dev = resolve_device(device)
    x, d = script_inputs(dev)
    out = dynslice(x, d)
    expect_equal("dynslice", out, dynslice_reference(x.cpu(), d.cpu()))
    return [result("dynslice (2,1024) window gather", time_us(lambda: dynslice(x, d), dev, reps), 1, out, dev)]
