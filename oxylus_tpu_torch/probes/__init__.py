"""Hopper probes: the counterparts of the JAX package's TPU compiler probes
(`scripts/probe_dynslice.py`, `probe_dot_rhs_t.py`, `probe_mosaic_ops.py`,
`probe_roll.py`).

Each script ran a few Pallas kernels on the TPU to learn whether Mosaic lowers
a pattern and how fast it runs: the windowed one-hot gather, the bf16 hi/lo
split with a transposed-RHS product, in-block gathers, scans, sorts, argmax and
rotates, the vector and matrix units' rates, argmax extraction and loops with
a trip count read at run time. Here each pattern is a kernel written by hand
for Hopper (`csrc/*.cu`), beside its plain PyTorch version in the same module:

- `dynslice`: the windowed gather of `probe_dynslice.kernel`;
- `dot_rhs_t`: the hi/lo split and the (12, 1024)·(384, 1024)ᵀ product by
  `mma.sync`;
- `mosaic_ops`: the ten in-block ops of `probe_mosaic_ops`;
- `roll`: the rotates, vector chains, matrix-product rates, argmax extraction
  and dynamic trip count of `probe_roll`.

Every op takes tensors and dispatches on their device: a CUDA tensor launches
the op's kernel (counted in its module's `LAUNCHES`) or raises, a CPU tensor
takes the plain version. The input makers and `run_probes` take
`device=None`, the card unless the caller asks for `"cpu"`.

    python -m oxylus_tpu_torch.probes     # every probe on the card, one line each
"""

from __future__ import annotations

import importlib
import time

import torch

PROBE_MODULES = ("dynslice", "dot_rhs_t", "mosaic_ops", "roll")


def modules() -> list:
    """The four probe modules, imported."""
    return [importlib.import_module(f"{__name__}.{name}") for name in PROBE_MODULES]


def launch(name: str, device: torch.device, *args) -> None:
    """Call the kernel library's C entry `name` with `args` on PyTorch's current
    stream of `device`; raise if the launch was refused."""
    from .._build import load_kernel_library

    lib = load_kernel_library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.kernel_error_string(err).decode()}")


def require(t: torch.Tensor, dtype: torch.dtype, shape: tuple | None = None, name: str = "input") -> None:
    """Raise unless `t` is contiguous, of `dtype` and (where given) of `shape`."""
    if t.dtype != dtype or not t.is_contiguous() or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor"
                         f"{'' if shape is None else f' of shape {tuple(shape)}'}, got {t.dtype} {tuple(t.shape)}")


def dispatch(kernel, plain, *tensors):
    """`kernel()` when the inputs lie on a card, `plain()` when they lie on the
    CPU; anything else raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cuda":
        return kernel()
    if dev.type == "cpu":
        return plain()
    raise ValueError(f"no implementation for device {dev}")


def time_us(fn, device: torch.device, reps: int) -> tuple[float, float]:
    """(device µs, host µs) per call of `fn()`, after one warm-up. On a card:
    `reps` calls captured in one CUDA graph and replayed, timed by CUDA events
    (the device's time per call, the gaps between launches included), and
    `reps` calls issued one by one from the host (what a Python caller waits,
    the wrappers' host work included). On the CPU both are the host clock."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) / reps * 1e6
        return host, host
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    host = start.elapsed_time(end) / reps * 1e3
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps * 1e3, host


def result(name: str, times: tuple[float, float], inner: int, out: torch.Tensor, device: torch.device,
           **extra) -> dict:
    """One probe's line: device and host µs per call (`time_us`), ns per inner
    iteration of the device time, the first values."""
    us, host_us = times
    return {"name": name, "device": str(device), "us": us, "host_us": host_us, "ns_inner": us * 1e3 / inner,
            "val": out.detach().reshape(-1)[:3].float().cpu().tolist(), **extra}


def expect_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    """Raise unless `got` equals `want` exactly (NaN where `want` has NaN)."""
    got = got.cpu()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if got.shape != want.shape or got.dtype != want.dtype or not bool(same.all()):
        bad = int((~same).sum()) if got.shape == want.shape else "shape"
        raise RuntimeError(f"{name}: kernel result differs from the plain version ({bad} elements)")


def run_all(device=None, reps: int = 20, **scale) -> list[dict]:
    """Every probe of the four modules on `device` (the card by default), each
    checked, timed over `reps` calls; `scale` passes `n_inner` and `reps_m` to
    `roll.run_probes` (the scripts' 2000 and 500 by default)."""
    out = []
    for mod in modules():
        out += mod.run_probes(device, reps=reps, **(scale if mod.__name__.endswith(".roll") else {}))
    return out


def format_line(r: dict) -> str:
    """A result as the scripts printed it."""
    line = f"OK   {r['name']}: {r['us']:9.2f} us  ({r['ns_inner']:8.2f} ns/inner)  val={r['val']}"
    if r["device"].startswith("cuda"):
        if "tflops" in r:
            line += f"  -> {r['tflops']:.3f} TFLOP/s of {r['peak_tflops']:g}"
        line += f"  [graph replay; {r['host_us']:.2f} us a call from the host]"
    return f"{line}  ({r['device']})"
