"""The rotate, vector-rate, matrix-rate, argmax-extraction and dynamic-trip
probes of `scripts/probe_roll.py`, as Hopper probes.

The script's kernels, on x = (arange(8·128) % 13) + 1 as (8, 128) float32:

- `k_dynroll`: one roll by a shift read at run time (5);
- `k_rollrate`: `acc += roll(x, 1)` 2000 times; `k_dynrollrate`: the same with
  the shift `3 + i % 4`, 3 read at run time;
- `k_vpu`: 8 dependent float32 operations per element and iteration, 2000
  iterations on (8, 128); `k_vpu_big`: 200 on (128, 384). From x in [1, 13]
  the chain overflows to inf from its third iteration on;
- `k_mxu`: `acc += a·b` 500 times for all-ones (128, 384)·(384, 16) and
  (384, 128) float32, (128, 384)·(384, 16) bf16, (1024, 1024)·(1024, 128) bf16
  and float32, so every output is 500·k;
- `k_extract`: 16 rounds of argmax, one-hot, mask on (8, 128);
- `k_dyntrip`: `acc += x` for a trip count read at run time (37).

Each op takes tensors (the run-time scalars as int32 tensors of one element,
the counterpart of the TPU kernels' SMEM scalars): on a CUDA tensor it launches
its kernel in `csrc/roll.cu`, with the repetition loop inside the kernel, on a
CPU tensor its plain version. Rotates, argmax extraction and the dynamic trip
are exact; the vector chain repeats the kernel's operations one by one (the
kernels are built with `-fmad=false`), so it is exact too. The products sum in
another order on each side: exact on integer sums below 2²⁴, else within
`product_bound`.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..device import resolve_device
from . import dispatch, expect_equal, launch, require, result, time_us

S, L = 8, 128
N_INNER = 2000
VPU_BIG_ITERS = 200
REPS_M = 500
EXTRACT_ROUNDS = 16
DYN_SHIFT, DYN_BASE, DYN_STEP, DYN_TRIP = 5, 3, 4, 37
# the script's (m, k, n, type) products
MATMULS = ((128, 384, 16, torch.float32), (128, 384, 128, torch.float32), (128, 384, 16, torch.bfloat16),
           (1024, 1024, 128, torch.bfloat16), (1024, 1024, 128, torch.float32))
PEAK_TFLOPS = {torch.float32: 67, torch.bfloat16: 989}  # H100 SXM data sheet: CUDA-core f32, dense bf16 tensor cores

LAUNCHES = 0
KERNEL_LAUNCHES: collections.Counter = collections.Counter()  # launches by kernel


def _count(kernel: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    KERNEL_LAUNCHES[kernel] += 1


def script_x(device=None) -> torch.Tensor:
    """(arange(8·128) % 13) + 1 as (8, 128) float32."""
    x = (np.arange(S * L, dtype=np.float32).reshape(S, L) % np.float32(13.0)) + np.float32(1.0)
    return torch.from_numpy(x).to(resolve_device(device))


def script_xb(device=None) -> torch.Tensor:
    """(arange(128·384) % 13) + 1 as (128, 384) float32."""
    x = (np.arange(128 * 384, dtype=np.float32).reshape(128, 384) % np.float32(13.0)) + np.float32(1.0)
    return torch.from_numpy(x).to(resolve_device(device))


def scalar(value: int, device=None) -> torch.Tensor:
    """A run-time scalar: an int32 tensor of one element."""
    return torch.tensor([value], dtype=torch.int32, device=resolve_device(device))


def seeded_x(seed: int, shape=(S, L), device=None) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * 4.0).astype(np.float32)).to(resolve_device(device))


def seeded_matrices(seed: int, m: int, k: int, n: int, dtype: torch.dtype, device=None):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=(m, k)).astype(np.float32), rng.normal(size=(k, n)).astype(np.float32)
    dev = resolve_device(device)
    return torch.from_numpy(a).to(dev, dtype), torch.from_numpy(b).to(dev, dtype)


# ---- plain versions ----------------------------------------------------------


def roll_chain_reference(x, n_iter, shift, step_mod=0, accumulate=True):
    acc = torch.zeros_like(x)
    for i in range(n_iter):
        rolled = torch.roll(x, shift + (i % step_mod if step_mod else 0), 1)
        acc = acc + rolled if accumulate else rolled
    return acc


def vector_chain_reference(x, n_iter):
    acc = x
    for _ in range(n_iter):
        a = acc * 1.000001 + x
        b = a * a - x
        c = b * 0.5 + a
        acc = c * c + b
    return acc


def matmul_reference(a, b, reps):
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    prod = a.float() @ b.float()
    for _ in range(reps):
        acc = acc + prod
    return acc


def product_bound(a, b, reps) -> torch.Tensor:
    """Per-element bound on the difference of two float32 sums of the same
    reps·k exact products in different orders: 2·n·2⁻²⁴·Σ|product| with
    n = reps·k terms (twice the recursive-sum bound, for the tensor cores'
    truncating accumulation)."""
    n_terms = reps * a.shape[1]
    return 2.0 * n_terms * 2.0**-24 * reps * (a.double().abs() @ b.double().abs()) + 1e-30


def floor_mod3(x):
    """`x % 3.0` as jnp.remainder (and Python) define it for floats."""
    r = torch.fmod(x, 3.0)
    return torch.where((r != 0) & (r < 0), r + 3.0, r)


def argmax_extract_reference(x, rounds):
    score = torch.where(floor_mod3(x) < 1.0, x, torch.full_like(x, -1.0))
    lane = torch.arange(x.shape[1], device=x.device)[None, :]
    out = torch.zeros_like(x)
    for k in range(rounds):
        idx = torch.argmax(score, dim=1, keepdim=True)
        onehot = (lane == idx).float()
        out = out + onehot * (1.0 + k)
        score = torch.where(onehot > 0, torch.full_like(score, -1.0), score)
    return out


def dynamic_trip_reference(x, trip):
    acc = torch.zeros_like(x)
    for _ in range(trip):
        acc = acc + x
    return acc


# ---- ops -----------------------------------------------------------------------


def _rows128(x, name="x"):
    require(x, torch.float32, name=name)
    if x.dim() != 2 or x.shape[1] != L:
        raise ValueError(f"{name}: expected (rows, 128), got {tuple(x.shape)}")


ROTATES = ("shuffle", "smem")  # how the kernel rotates a 128-lane row: shuffles, or shared memory


def _roll_chain(x, n_iter, shift, shift_t, step_mod, accumulate, via):
    _rows128(x)
    if n_iter < 1 or via not in ROTATES or step_mod < 0 or step_mod & (step_mod - 1):
        raise ValueError(f"n_iter must be at least 1 (got {n_iter}), via one of {ROTATES} (got {via!r}) and "
                         f"step_mod 0 or a power of two (got {step_mod})")

    def kernel():
        out = torch.empty_like(x)
        launch("probe_roll_chain", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], shift,
               None if shift_t is None else shift_t.data_ptr(), n_iter, step_mod, int(accumulate), int(via == "smem"))
        _count("roll_chain" if via == "shuffle" else "roll_chain_smem")
        return out

    tensors = (x,) if shift_t is None else (x, shift_t)
    plain = lambda: roll_chain_reference(x, n_iter, shift if shift_t is None else int(shift_t[0]), step_mod,
                                         accumulate)
    return dispatch(kernel, plain, *tensors)


def dynamic_roll(x: torch.Tensor, shift_t: torch.Tensor, via: str = "shuffle") -> torch.Tensor:
    """roll(x, shift_t[0], axis=1) on (rows, 128), the shift read at run time."""
    require(shift_t, torch.int32, (1,), "shift_t")
    return _roll_chain(x, 1, 0, shift_t, 0, False, via)


def roll_chain(x: torch.Tensor, n_iter: int, shift: int = 1, via: str = "shuffle") -> torch.Tensor:
    """Σ over n_iter iterations of roll(x, shift, axis=1) on (rows, 128); `via`
    says how the kernel rotates (`ROTATES`)."""
    return _roll_chain(x, n_iter, shift, None, 0, True, via)


def dynamic_roll_chain(x: torch.Tensor, n_iter: int, base_t: torch.Tensor, step_mod: int = DYN_STEP,
                       via: str = "shuffle") -> torch.Tensor:
    """Σ over i < n_iter of roll(x, base_t[0] + i % step_mod, axis=1), base read at
    run time, step_mod a power of two (the script's 4)."""
    require(base_t, torch.int32, (1,), "base_t")
    return _roll_chain(x, n_iter, 0, base_t, step_mod, True, via)


def vector_chain(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """n_iter iterations of the script's 8-operation chain, elementwise."""
    require(x, torch.float32, name="x")

    def kernel():
        out = torch.empty_like(x)
        launch("probe_vector_chain", x.device, x.data_ptr(), out.data_ptr(), x.numel(), n_iter)
        _count("vector_chain")
        return out

    return dispatch(kernel, lambda: vector_chain_reference(x, n_iter), x)


def matmul_acc(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Σ over reps of a·b in float32: a (m, k), b (k, n), both float32 (FFMA on
    the CUDA cores) or both bf16 (mma.sync on the tensor cores)."""
    if a.dtype not in PEAK_TFLOPS or b.dtype != a.dtype:
        raise ValueError(f"matmul_acc takes two float32 or two bf16 matrices, got {a.dtype}, {b.dtype}")
    require(a, a.dtype, name="a")
    require(b, a.dtype, name="b")
    m, k = a.shape
    n = b.shape[1]
    rows = 32 if a.dtype == torch.float32 else 16
    if b.shape[0] != k or m % rows or n % 16 or k % (4 if a.dtype == torch.float32 else 16) or reps < 1:
        raise ValueError(f"matmul_acc: shapes {tuple(a.shape)}, {tuple(b.shape)}, reps {reps}")
    name = "matmul_f32" if a.dtype == torch.float32 else "matmul_bf16"

    def kernel():
        out = torch.empty(m, n, dtype=torch.float32, device=a.device)
        launch(f"probe_{name}", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n, reps)
        _count(name)
        return out

    return dispatch(kernel, lambda: matmul_reference(a, b, reps), a, b)


def argmax_extract(x: torch.Tensor, rounds: int = EXTRACT_ROUNDS) -> torch.Tensor:
    """The script's argmax extraction on (rows, 128)."""
    _rows128(x)

    def kernel():
        out = torch.empty_like(x)
        launch("probe_argmax_extract", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], rounds)
        _count("argmax_extract")
        return out

    return dispatch(kernel, lambda: argmax_extract_reference(x, rounds), x)


def dynamic_trip(x: torch.Tensor, trip_t: torch.Tensor) -> torch.Tensor:
    """Σ of x over trip_t[0] iterations, the trip count read at run time."""
    require(x, torch.float32, name="x")
    require(trip_t, torch.int32, (1,), "trip_t")

    def kernel():
        out = torch.empty_like(x)
        launch("probe_dynamic_trip", x.device, x.data_ptr(), out.data_ptr(), x.numel(), trip_t.data_ptr())
        _count("dynamic_trip")
        return out

    return dispatch(kernel, lambda: dynamic_trip_reference(x, int(trip_t[0])), x, trip_t)


# ---- the script's probes -----------------------------------------------------------


def run_probes(device=None, reps: int = 20, n_inner: int = N_INNER, reps_m: int = REPS_M) -> list[dict]:
    """The script's probes on its inputs, each checked (against the plain
    version on CPU copies; the all-ones products against reps_m·k exactly) and
    timed over `reps` calls. `n_inner` and `reps_m` are the script's 2000 and 500."""
    dev = resolve_device(device)
    x, xb = script_x(dev), script_xb(dev)
    xc = x.cpu()
    out = []

    def probe(name, fn, want, inner=1, **extra):
        got = fn()
        expect_equal(name, got, want)
        out.append(result(name, time_us(fn, dev, reps), inner, got, dev, **extra))
        return out[-1]

    shift5, base3, trip37 = scalar(DYN_SHIFT, dev), scalar(DYN_BASE, dev), scalar(DYN_TRIP, dev)
    probe("dynamic roll (shift read at run time)", lambda: dynamic_roll(x, shift5),
          roll_chain_reference(xc, 1, DYN_SHIFT, accumulate=False))
    static_want = roll_chain_reference(xc, n_inner, 1)
    dynamic_want = roll_chain_reference(xc, n_inner, DYN_BASE, DYN_STEP)
    for via, label in (("shuffle", ""), ("smem", " via shared memory")):
        probe(f"static roll x{n_inner} (8,128){label}", lambda: roll_chain(x, n_inner, via=via), static_want, n_inner)
        probe(f"dynamic roll x{n_inner} (8,128){label}", lambda: dynamic_roll_chain(x, n_inner, base3, via=via),
              dynamic_want, n_inner)
    for xv, iters, inner, label in ((x, n_inner, n_inner * 8, "(8,128)"),
                                    (xb, VPU_BIG_ITERS, VPU_BIG_ITERS * 8 * 48, "(128,384)")):
        r = probe(f"vector chain x{iters}x8flop {label}", lambda: vector_chain(xv, iters),
                  vector_chain_reference(xv.cpu(), iters), inner)
        r.update(tflops=8 * xv.numel() * iters / r["us"] * 1e-6, peak_tflops=PEAK_TFLOPS[torch.float32])
    for m, k, n, dtype in MATMULS:
        a = torch.ones(m, k, dtype=dtype, device=dev)
        b = torch.ones(k, n, dtype=dtype, device=dev)
        r = probe(f"matmul {m}x{k}x{n} {str(dtype).split('.')[-1]} x{reps_m}", lambda: matmul_acc(a, b, reps_m),
                  torch.full((m, n), float(reps_m * k)), reps_m)
        r.update(tflops=2 * m * k * n * reps_m / r["us"] * 1e-6, peak_tflops=PEAK_TFLOPS[dtype])
    probe(f"argmax-extract {EXTRACT_ROUNDS} rounds (8,128)", lambda: argmax_extract(x),
          argmax_extract_reference(xc, EXTRACT_ROUNDS))
    probe(f"dynamic trip ({DYN_TRIP} iters)", lambda: dynamic_trip(x, trip37), dynamic_trip_reference(xc, DYN_TRIP))
    return out
