"""The bf16 hi/lo split with a transposed-RHS product of
`scripts/probe_dot_rhs_t.py::kernel` (the TPU probe of the compact kernel's
partner gather), as a Hopper probe.

The TPU kernel concatenates `v[r, 0:128]` over the 8 rows into one 1024-lane
row `vcat`, splits it into `hi = bf16(vcat)` and `lo = bf16(vcat - hi)`, stacks
the pair 6 times into 12 rows (even rows hi, odd rows lo) and multiplies them
by `m`ᵀ with float32 accumulation: (12, 1024)·(384, 1024)ᵀ → (12, 384). So
`out[0] + out[1]` is `vcat·m`ᵀ to about 16 bits. `dot_rhs_t` computes that: on
a CUDA tensor by the kernel `csrc/dot_rhs_t.cu`, on a CPU tensor by
`dot_rhs_t_reference`. The kernel splits K into 8 slices of 128, one warp
each, sums each slice in 16-wide `mma.sync` steps and adds the slices in order.
The products are exact in float32; the sums are taken in another order on each
side, so the two agree within `sum_order_bound`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import dispatch, launch, require, result, time_us

R, BCHUNK, SLAB, N2 = 8, 128, 384, 12
K = R * BCHUNK
SCRIPT_TOL = 2e-3  # the script's own bound on out[0] + out[1] against vcat·mᵀ, relative

LAUNCHES = 0


def script_inputs(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's inputs: v (8, 1024) normal from seed 0; m (384, 1024) bf16,
    1 % ones from seed 1."""
    dev = resolve_device(device)
    v = np.random.default_rng(0).normal(size=(R, 1024)).astype(np.float32)
    m = (np.random.default_rng(1).random((SLAB, K)) < 0.01).astype(np.float32)
    return torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev, torch.bfloat16)


def seeded_inputs(seed: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense normal bf16 `m`: the script's sparse 0/1 matrix hides index faults."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(R, 1024)) * 4.0).astype(np.float32)
    m = rng.normal(size=(SLAB, K)).astype(np.float32)
    return torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev, torch.bfloat16)


def split_rows(v: torch.Tensor) -> torch.Tensor:
    """The 12 bf16 rows the TPU kernel multiplies: hi, lo, hi, lo, …"""
    vcat = v[:, :BCHUNK].reshape(-1)
    hi = vcat.to(torch.bfloat16)
    lo = (vcat - hi.float()).to(torch.bfloat16)
    return torch.stack([hi, lo]).repeat(N2 // 2, 1)


def dot_rhs_t_reference(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: every product, then the sum over K."""
    vals = split_rows(v).float()
    return (vals[:, None, :] * m.float()[None, :, :]).sum(-1)


def sum_order_bound(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Per-element bound on the difference of two float32 sums of the same exact
    products in different orders: 2·K·2⁻²⁴·Σ|product| (twice the recursive-sum
    bound, for the tensor cores' truncating accumulation)."""
    vals = split_rows(v).double().abs()
    return 2.0 * K * 2.0**-24 * (vals @ m.double().abs().T) + 1e-30


def _dot_rhs_t_cuda(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    out = torch.empty(N2, m.shape[0], dtype=torch.float32, device=v.device)
    launch("probe_dot_rhs_t", v.device, v.data_ptr(), v.shape[1], m.data_ptr(), m.shape[0], out.data_ptr())
    LAUNCHES += 1
    return out


def dot_rhs_t(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v (8, ≥128) float32, m (N, 1024) bf16 with N a multiple of 8 → (12, N) float32."""
    require(v, torch.float32, name="v")
    require(m, torch.bfloat16, name="m")
    if v.dim() != 2 or v.shape[0] != R or v.shape[1] < BCHUNK or m.dim() != 2 or m.shape[1] != K \
            or m.shape[0] % 8 != 0:
        raise ValueError(f"dot_rhs_t takes v (8, >=128) and m (8n, 1024), got {tuple(v.shape)}, {tuple(m.shape)}")
    return dispatch(lambda: _dot_rhs_t_cuda(v, m), lambda: dot_rhs_t_reference(v, m), v, m)


def script_error(v: torch.Tensor, m: torch.Tensor, out: torch.Tensor) -> float:
    """The script's check: max relative error of out[0] + out[1] against vcat·mᵀ."""
    vcat = v[:, :BCHUNK].reshape(1, -1).double().cpu()
    want = (vcat @ m.double().cpu().T)[0]
    got = (out[0] + out[1]).double().cpu()
    return float(((got - want).abs() / (want.abs() + 1e-6)).max())


def run_probes(device=None, reps: int = 20) -> list[dict]:
    """The script's probe on its inputs, held to the script's bound, timed over `reps` calls."""
    dev = resolve_device(device)
    v, m = script_inputs(dev)
    out = dot_rhs_t(v, m)
    err = script_error(v, m, out)
    if not err < SCRIPT_TOL:
        raise RuntimeError(f"dot_rhs_t: out[0] + out[1] differs from vcat·mᵀ by {err} (relative), not < {SCRIPT_TOL}")
    times = time_us(lambda: dot_rhs_t(v, m), dev, reps)
    flops = 2 * N2 * m.shape[0] * K
    return [result("dot_rhs_t (12,1024)x(384,1024)^T hi/lo bf16", times, 1, out, dev, rel_err=err,
                   tflops=flops / times[0] * 1e-6, peak_tflops=989)]
