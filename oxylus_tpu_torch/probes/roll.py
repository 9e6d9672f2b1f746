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
kernels are built with `-fmad=false`), so it is exact too. The roll chain's
kernel (`roll_chain`) is a thread per element, 128 a block: a chain's shifts
take at most min(step_mod, 128) values, so each element loads those rotated
values once and adds them in iteration order, one add an iteration from 0, as
the plain version sums. The single roll has a kernel of its own
(`roll_last`), a block a row. The products sum in another order
on each side: exact on integer sums below 2²⁴, else within `product_bound`.
Their kernels keep both operands in shared memory for all repetitions on a grid
that `product_plan` lays out (m-tiles × n-tiles × k-slices × repetition
groups, `product_blocks` says which CTA does what) and add the per-CTA
partials in a fixed order.
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
SMS = 132  # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232448  # shared memory a CTA may use (227 KB)
PROD_TILE_M = 128  # a product CTA's output rows
F32_KSLICE, F32_UNROLL = 64, 8  # the FFMA product's largest k-slice; k steps per loop trip

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


def _roll_chain(x, n_iter, shift, shift_t, step_mod, accumulate):
    _rows128(x)
    if n_iter < 1 or step_mod < 0 or step_mod & (step_mod - 1):
        raise ValueError(f"n_iter must be at least 1 (got {n_iter}) and step_mod 0 or a power of two (got {step_mod})")

    def kernel():
        out = torch.empty_like(x)
        launch("probe_roll_chain", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], shift,
               None if shift_t is None else shift_t.data_ptr(), n_iter, step_mod, int(accumulate))
        _count("roll_chain" if accumulate else "roll_last")
        return out

    tensors = (x,) if shift_t is None else (x, shift_t)
    plain = lambda: roll_chain_reference(x, n_iter, shift if shift_t is None else int(shift_t[0]), step_mod,
                                         accumulate)
    return dispatch(kernel, plain, *tensors)


def dynamic_roll(x: torch.Tensor, shift_t: torch.Tensor) -> torch.Tensor:
    """roll(x, shift_t[0], axis=1) on (rows, 128), the shift read at run time."""
    require(shift_t, torch.int32, (1,), "shift_t")
    return _roll_chain(x, 1, 0, shift_t, 0, False)


def roll_chain(x: torch.Tensor, n_iter: int, shift: int = 1) -> torch.Tensor:
    """Σ over n_iter iterations of roll(x, shift, axis=1) on (rows, 128)."""
    return _roll_chain(x, n_iter, shift, None, 0, True)


def dynamic_roll_chain(x: torch.Tensor, n_iter: int, base_t: torch.Tensor, step_mod: int = DYN_STEP) -> torch.Tensor:
    """Σ over i < n_iter of roll(x, base_t[0] + i % step_mod, axis=1), base read at
    run time, step_mod a power of two (the script's 4)."""
    require(base_t, torch.int32, (1,), "base_t")
    return _roll_chain(x, n_iter, 0, base_t, step_mod, True)


def vector_chain(x: torch.Tensor, n_iter: int) -> torch.Tensor:
    """n_iter iterations of the script's 8-operation chain, elementwise."""
    require(x, torch.float32, name="x")

    def kernel():
        out = torch.empty_like(x)
        launch("probe_vector_chain", x.device, x.data_ptr(), out.data_ptr(), x.numel(), n_iter)
        _count("vector_chain")
        return out

    return dispatch(kernel, lambda: vector_chain_reference(x, n_iter), x)


def _product_shapes(m: int, k: int, n: int, reps: int, dtype: torch.dtype) -> None:
    """Raise ValueError unless `matmul_acc` takes these shapes: float32 m % 32,
    n % 16, k % 4; bf16 m, k, n % 16; reps ≥ 1."""
    rows = 32 if dtype == torch.float32 else 16
    if m % rows or n % 16 or k % (4 if dtype == torch.float32 else 16) or reps < 1:
        raise ValueError(f"matmul_acc: shapes ({m}, {k}), ({k}, {n}), reps {reps}")


def product_plan(m: int, k: int, n: int, reps: int, dtype: torch.dtype) -> dict:
    """The launch of Σ over reps of (m, k)·(k, n): a grid of m-tiles × n-tiles
    × k-slices × repetition groups, about one wave of the card's SMS. Each CTA
    keeps its 128 × k_slice block of a and k_slice × tile_n block of b in
    shared memory for its group's repetitions and writes one float32 partial;
    `parts` = k_slices × rep_groups partials are added in a fixed order.

    float32 (`design` "ffma": 8 × 8 outputs a thread): tile_n 128 and one CTA
    an SM, or for n < 64 tile_n 16 with `warps_k` 4 warps splitting the
    k-slice and two CTAs an SM; k_slice up to 64. bf16 ("wgmma"): tile_n 128
    with a k-slice of 256, or 16 with 128, one CTA of two warpgroups an SM.
    Raises ValueError on shapes the kernels do not take, empty ones included."""
    _product_shapes(m, k, n, reps, dtype)
    if min(m, k, n) <= 0 or dtype not in PEAK_TFLOPS:
        raise ValueError(f"no product kernel for ({m}, {k}), ({k}, {n}) {dtype}")
    if dtype == torch.float32:
        design = "ffma"
        wide = n >= 64
        tile_n, warps_k, threads, ctas_per_sm = (128, 1, 256, 1) if wide else (16, 4, 128, 2)
        step = F32_UNROLL * warps_k
        k_slice = min(F32_KSLICE, -(-k // step) * step)
        smem = 4 * max(k_slice * (PROD_TILE_M + tile_n), (warps_k - 1) * PROD_TILE_M * tile_n)
    else:
        design = "wgmma"
        tile_n = 128 if n >= 64 else 16
        k_slice = 256 if tile_n == 128 else 128
        warps_k, threads, ctas_per_sm = 1, 256, 1
        smem = 2 * k_slice * tile_n
    tiles_m, tiles_n, k_slices = -(-m // PROD_TILE_M), -(-n // tile_n), -(-k // k_slice)
    base = tiles_m * tiles_n * k_slices
    rep_groups = max(1, min(reps, SMS * ctas_per_sm // base))
    return {"m": m, "k": k, "n": n, "reps": reps, "dtype": dtype, "design": design, "tile_m": PROD_TILE_M,
            "tile_n": tile_n, "k_slice": k_slice, "rep_groups": rep_groups, "tiles_m": tiles_m, "tiles_n": tiles_n,
            "k_slices": k_slices, "parts": k_slices * rep_groups, "grid": base * rep_groups, "threads": threads,
            "warps_k": warps_k, "smem_bytes": smem}


def product_blocks(plan: dict) -> list[dict]:
    """What each CTA of `plan` computes, in block order, as the kernels decode
    it (the m-tile fastest, then the n-tile, the k-slice, the repetition
    group): its partial's index (group × k_slices + k-slice), its output rows
    and columns, its k-slice's k runs (one a k-warp, in the order their sums
    are added) and its repetitions, each a [start, end) range clipped to the
    shapes (the kernels zero what lies past them)."""
    m, k, n, reps = plan["m"], plan["k"], plan["n"], plan["reps"]
    ks, groups, wk = plan["k_slice"], plan["rep_groups"], plan["warps_k"]
    out = []
    for blk in range(plan["grid"]):
        tm, rest = blk % plan["tiles_m"], blk // plan["tiles_m"]
        tn, rest = rest % plan["tiles_n"], rest // plan["tiles_n"]
        s, g = rest % plan["k_slices"], rest // plan["k_slices"]
        r0 = g * (reps // groups) + min(g, reps % groups)
        k0 = s * ks
        out.append({"part": g * plan["k_slices"] + s,
                    "rows": (tm * PROD_TILE_M, min(m, (tm + 1) * PROD_TILE_M)),
                    "cols": (tn * plan["tile_n"], min(n, (tn + 1) * plan["tile_n"])),
                    "k_runs": [(min(k, k0 + w * ks // wk), min(k, k0 + (w + 1) * ks // wk)) for w in range(wk)],
                    "reps": (r0, r0 + reps // groups + (g < reps % groups))})
    return out


def matmul_acc(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Σ over reps of a·b in float32: a (m, k), b (k, n), both float32 (FFMA on
    the CUDA cores) or both bf16 (`wgmma` on the tensor cores), launched as
    `product_plan` says."""
    if a.dtype not in PEAK_TFLOPS or b.dtype != a.dtype:
        raise ValueError(f"matmul_acc takes two float32 or two bf16 matrices, got {a.dtype}, {b.dtype}")
    require(a, a.dtype, name="a")
    require(b, a.dtype, name="b")
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k:
        raise ValueError(f"matmul_acc: shapes {tuple(a.shape)}, {tuple(b.shape)}, reps {reps}")
    _product_shapes(m, k, n, reps, a.dtype)
    name = "matmul_f32" if a.dtype == torch.float32 else "matmul_bf16"

    def kernel():
        plan = product_plan(m, k, n, reps, a.dtype)
        out = torch.empty(m, n, dtype=torch.float32, device=a.device)
        parts = torch.empty(plan["parts"], m, n, dtype=torch.float32, device=a.device) if plan["parts"] > 1 else None
        launch(f"probe_{name}", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
               None if parts is None else parts.data_ptr(), m, k, n, reps,
               *(plan[key] for key in ("tile_m", "tile_n", "k_slice", "rep_groups", "grid", "smem_bytes")))
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
    probe(f"static roll x{n_inner} (8,128)", lambda: roll_chain(x, n_inner), roll_chain_reference(xc, n_inner, 1),
          n_inner)
    probe(f"dynamic roll x{n_inner} (8,128)", lambda: dynamic_roll_chain(x, n_inner, base3),
          roll_chain_reference(xc, n_inner, DYN_BASE, DYN_STEP), n_inner)
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
