"""The ten in-block ops of `scripts/probe_mosaic_ops.py` (the TPU probe of which
ops Mosaic lowers inside a kernel), as Hopper probes.

The script's cases, on x = arange(128·384) % 7 as (128, 384) float32:

1. `take_along_axis` on lanes, 384 → 384, reversed lane indices;
2. the same, 384 → 128, indices 3j;
3. `cumsum` on axis 1; 4. `cumsum` on axis 0;
5. `sort` on axis 1;
6. `argmax` on axis 1 with keepdims, the first index on ties, as float32;
7. `pltpu.roll(shift=5, axis=1)`, which equals `jnp.roll`: out[:, 5] = x[:, 0];
8. `take_along_axis` on axis 0, reversed row indices;
9. bf16 `x·x + x`, each operation rounded to bf16;
10. the (1, 1024) → (1, 128) gather with indices 7j % 1024.

Each op here takes tensors: on a CUDA tensor it launches its kernel in
`csrc/mosaic_ops.cu` (one kernel per op, one block per row, or per column for
the axis-0 scan, or for the sort one warp per row with the keys in registers;
cases 1, 2 and 10 share the lane gather), on a CPU tensor its plain version.
Gathers follow `jnp.take_along_axis`: an index in [-n, 0) counts from the end,
one outside [-n, n) gives NaN. The scan adds in the order of the
kernel's warp scan (a Hillis-Steele scan in each warp of 32, then of the warp
totals), which `cumsum_reference` repeats, so kernel and plain agree exactly;
every other op is exact by nature.
"""

from __future__ import annotations

import collections

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from . import dispatch, expect_equal, launch, require, result, time_us

B, C = 128, 384
MAX_LINE = 1024  # the scan and argmax take lines of at most one block of threads
MAX_SORT = 2048  # the sort's bitonic network holds at most this many keys (64 a lane of one warp)

LAUNCHES = 0
KERNEL_LAUNCHES: collections.Counter = collections.Counter()  # launches by kernel


def _count(kernel: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    KERNEL_LAUNCHES[kernel] += 1


# ---- plain versions ----------------------------------------------------------


def _wrap_index(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    return torch.where(inside, idx, torch.zeros_like(idx)), inside


def take_lanes_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    safe, inside = _wrap_index(idx, x.shape[1])
    got = torch.gather(x, 1, safe)
    return torch.where(inside, got, torch.full_like(got, float("nan")))


def take_rows_reference(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    safe, inside = _wrap_index(idx, x.shape[0])
    got = torch.gather(x, 0, safe)
    return torch.where(inside, got, torch.full_like(got, float("nan")))


def _hillis_steele(v: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over the last axis of 32 lanes, as `shfl_up` by 1, 2, 4, 8, 16."""
    for d in (1, 2, 4, 8, 16):
        v = torch.cat([v[..., :d], v[..., d:] + v[..., :-d]], -1)
    return v


def _scan_last(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    w = -(-n // 32)
    v = _hillis_steele(F.pad(x, (0, 32 * w - n)).reshape(*x.shape[:-1], w, 32))
    carry = _hillis_steele(F.pad(v[..., 31], (0, 32 - w)))  # scan of the warp totals
    v = torch.cat([v[..., :1, :], v[..., 1:, :] + carry[..., : w - 1, None]], -2)
    return v.reshape(*x.shape[:-1], 32 * w)[..., :n]


def cumsum_reference(x: torch.Tensor, axis: int) -> torch.Tensor:
    return _scan_last(x) if axis == 1 else _scan_last(x.T).T.contiguous()


def sort_lanes_reference(x: torch.Tensor) -> torch.Tensor:
    """Each row sorted by the kernel's order-preserving keys: -0 before +0, NaN
    last as 0x7fc00000 (the total order of `lax.sort`), so the kernel's bits."""
    b = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    key = torch.where(b >= 0x80000000, 0xFFFFFFFF - b, b | 0x80000000)
    key = torch.where(torch.isnan(x), torch.full_like(key, 0xFFFFFFFE), key).sort(1).values
    back = torch.where(key >= 0x80000000, key & 0x7FFFFFFF, 0xFFFFFFFF - key)
    back = torch.where(key == 0xFFFFFFFE, torch.full_like(key, 0x7FC00000), back)
    return (back - (back >= 0x80000000).long() * (1 << 32)).to(torch.int32).view(torch.float32)


def argmax_lanes_reference(x: torch.Tensor) -> torch.Tensor:
    return torch.argmax(x, dim=1, keepdim=True).float()


def roll_lanes_reference(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(x, shift, 1)


def bf16_mul_add_reference(x: torch.Tensor) -> torch.Tensor:
    return x * x + x


# ---- ops -----------------------------------------------------------------------


def _take_lanes_cuda(x, idx):
    out = torch.empty(idx.shape, dtype=torch.float32, device=x.device)
    launch("probe_take_lanes", x.device, x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
           idx.shape[1])
    _count("take_lanes")
    return out


def take_lanes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`take_along_axis(x, idx, axis=1)`: x (R, n) float32, idx (R, m) int32 → (R, m)."""
    require(x, torch.float32, name="x")
    require(idx, torch.int32, name="idx")
    if x.dim() != 2 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"take_lanes: x {tuple(x.shape)}, idx {tuple(idx.shape)}")
    return dispatch(lambda: _take_lanes_cuda(x, idx), lambda: take_lanes_reference(x, idx), x, idx)


def _take_rows_cuda(x, idx):
    out = torch.empty(idx.shape, dtype=torch.float32, device=x.device)
    launch("probe_take_rows", x.device, x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], idx.shape[0],
           x.shape[1])
    _count("take_rows")
    return out


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`take_along_axis(x, idx, axis=0)`: x (n, C) float32, idx (m, C) int32 → (m, C)."""
    require(x, torch.float32, name="x")
    require(idx, torch.int32, name="idx")
    if x.dim() != 2 or idx.dim() != 2 or idx.shape[1] != x.shape[1]:
        raise ValueError(f"take_rows: x {tuple(x.shape)}, idx {tuple(idx.shape)}")
    return dispatch(lambda: _take_rows_cuda(x, idx), lambda: take_rows_reference(x, idx), x, idx)


def _cumsum_cuda(x, axis):
    out = torch.empty_like(x)
    rows, cols = x.shape
    lines, n, s_elem, s_line = (rows, cols, 1, cols) if axis == 1 else (cols, rows, cols, 1)
    launch("probe_scan", x.device, x.data_ptr(), out.data_ptr(), lines, n, s_elem, s_line)
    _count("scan")
    return out


def cumsum(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Inclusive sum along `axis` (0 or 1) of a 2-D float32 tensor, lines of at most 1024."""
    require(x, torch.float32, name="x")
    if x.dim() != 2 or axis not in (0, 1) or not 0 < x.shape[axis] <= MAX_LINE:
        raise ValueError(f"cumsum: x {tuple(x.shape)}, axis {axis}")
    return dispatch(lambda: _cumsum_cuda(x, axis), lambda: cumsum_reference(x, axis), x)


def _sort_cuda(x):
    out = torch.empty_like(x)
    launch("probe_sort_rows", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1])
    _count("sort")
    return out


def sort_lanes(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of each row of a 2-D float32 tensor (NaN last), rows of at most 2048."""
    require(x, torch.float32, name="x")
    if x.dim() != 2 or not 0 < x.shape[1] <= MAX_SORT:
        raise ValueError(f"sort_lanes: x {tuple(x.shape)}")
    return dispatch(lambda: _sort_cuda(x), lambda: sort_lanes_reference(x), x)


def _argmax_cuda(x):
    out = torch.empty(x.shape[0], 1, dtype=torch.float32, device=x.device)
    launch("probe_argmax_rows", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1])
    _count("argmax")
    return out


def argmax_lanes(x: torch.Tensor) -> torch.Tensor:
    """Index of each row's maximum (the first on ties, NaN above all) as float32, (R, 1)."""
    require(x, torch.float32, name="x")
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"argmax_lanes: x {tuple(x.shape)}")
    return dispatch(lambda: _argmax_cuda(x), lambda: argmax_lanes_reference(x), x)


def _roll_cuda(x, shift):
    out = torch.empty_like(x)
    launch("probe_roll_lanes", x.device, x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], shift % x.shape[1])
    _count("roll_lanes")
    return out


def roll_lanes(x: torch.Tensor, shift: int) -> torch.Tensor:
    """`roll(x, shift, axis=1)`: out[:, (j + shift) % n] = x[:, j]."""
    require(x, torch.float32, name="x")
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"roll_lanes: x {tuple(x.shape)}")
    return dispatch(lambda: _roll_cuda(x, int(shift)), lambda: roll_lanes_reference(x, int(shift)), x)


def _bf16_cuda(x):
    out = torch.empty_like(x)
    launch("probe_bf16_mul_add", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    _count("bf16_mul_add")
    return out


def bf16_mul_add(x: torch.Tensor) -> torch.Tensor:
    """x·x + x in bf16, each operation rounded to bf16."""
    require(x, torch.bfloat16, name="x")
    return dispatch(lambda: _bf16_cuda(x), lambda: bf16_mul_add_reference(x), x)


# ---- the script's cases ------------------------------------------------------------

# kernel → (op, its plain version)
OPS = {
    "take_lanes": (take_lanes, take_lanes_reference),
    "take_rows": (take_rows, take_rows_reference),
    "scan": (cumsum, cumsum_reference),
    "sort": (sort_lanes, sort_lanes_reference),
    "argmax": (argmax_lanes, argmax_lanes_reference),
    "roll_lanes": (roll_lanes, roll_lanes_reference),
    "bf16_mul_add": (bf16_mul_add, bf16_mul_add_reference),
}


def _script_x():
    return np.arange(B * C, dtype=np.float32).reshape(B, C) % np.float32(7.0)


def _lane_idx(values) -> np.ndarray:
    return np.ascontiguousarray(np.broadcast_to(np.asarray(values, np.int32), (B, len(values))))


def script_cases(device=None) -> list[tuple[str, str, tuple]]:
    """The script's ten cases: (name, kernel, arguments) on `device`."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    x = _script_x()
    idx_r = np.ascontiguousarray(np.broadcast_to(np.arange(B, dtype=np.int32)[::-1, None], (B, C)))
    x1 = np.arange(1024, dtype=np.float32).reshape(1, 1024)
    ii = ((np.arange(128, dtype=np.int32) * 7) % 1024).reshape(1, 128)
    return [
        ("take_along_axis axis=1 (384->384)", "take_lanes", (t(x), t(_lane_idx(np.arange(C)[::-1])))),
        ("take_along_axis axis=1 (384->128)", "take_lanes", (t(x), t(_lane_idx(np.arange(128) * 3)))),
        ("cumsum axis=1", "scan", (t(x), 1)),
        ("cumsum axis=0", "scan", (t(x), 0)),
        ("sort axis=1", "sort", (t(x),)),
        ("argmax axis=1 keepdims", "argmax", (t(x),)),
        ("pltpu.roll axis=1", "roll_lanes", (t(x), 5)),
        ("take_along_axis axis=0", "take_rows", (t(x), t(idx_r))),
        ("bf16 mul+add", "bf16_mul_add", (t(x).to(torch.bfloat16),)),
        ("gather (1,1024)->(1,128) take_along_axis", "take_lanes", (t(x1), t(ii))),
    ]


def seeded_cases(seed: int, device=None) -> list[tuple[str, str, tuple]]:
    """The ten cases on seeded normal data at the script's shapes, in its order
    (indices in [-n - 16, n + 16), so wrapped and out-of-range ones too; rows
    with ties, and NaN in two entries for the sort and argmax), then the scan,
    sort and roll at an odd width and other shifts, rolls of rows whose width
    is not a multiple of 4, and sorts of rows at every count of keys a lane of
    the sort's warp holds (1 to 64: widths 1, 37, 100, 127, 200, 203, 383,
    2045 and 2048), each by float4 (a width that is a multiple of 4) or by
    single floats, ties and ±0 in the rounded rows."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, C)) * 8.0).astype(np.float32)
    xt = x.copy()
    xt[::3] = np.round(xt[::3])  # ties
    xt[5, [17, 200]] = np.nan
    odd = (rng.normal(size=(37, 1000)) * 3.0).astype(np.float32)
    idx = lambda rows, cols, n: rng.integers(-n - 16, n + 16, size=(rows, cols)).astype(np.int32)
    return [
        ("seeded take lanes 384->384", "take_lanes", (t(x), t(idx(B, C, C)))),
        ("seeded take lanes 384->128", "take_lanes", (t(x), t(idx(B, 128, C)))),
        ("seeded cumsum axis=1", "scan", (t(x), 1)),
        ("seeded cumsum axis=0", "scan", (t(x), 0)),
        ("seeded sort axis=1, ties and NaN", "sort", (t(xt),)),
        ("seeded argmax, ties and NaN", "argmax", (t(xt),)),
        ("seeded roll shift=5", "roll_lanes", (t(x), 5)),
        ("seeded take rows", "take_rows", (t(x), t(idx(B, C, B)))),
        ("seeded bf16 mul+add", "bf16_mul_add", (t(x).to(torch.bfloat16),)),
        ("seeded gather (1,1024)->(1,128)", "take_lanes", (t(x.reshape(1, -1)[:, :1024]), t(idx(1, 128, 1024)))),
        ("seeded cumsum axis=1 (37,1000)", "scan", (t(odd), 1)),
        ("seeded cumsum axis=0 (37,1000)", "scan", (t(odd), 0)),
        ("seeded sort axis=1 (37,1000)", "sort", (t(odd),)),
        ("seeded roll shift=-133", "roll_lanes", (t(x), -133)),
        ("seeded roll (37,1000) shift=517", "roll_lanes", (t(odd), 517)),
        # widths that are not a multiple of 4: the roll kernel's element path
        ("seeded roll (5,383) shift=0", "roll_lanes", (t(odd[:5, :383]), 0)),
        ("seeded roll (5,383) shift=382", "roll_lanes", (t(odd[:5, :383]), 382)),
        ("seeded roll (1,7) shift=3", "roll_lanes", (t((rng.normal(size=(1, 7)) * 3.0).astype(np.float32)), 3)),
        ("seeded sort axis=1 (6,1)", "sort", (t(odd[:6, :1]),)),
        ("seeded sort axis=1 (5,383)", "sort", (t(odd[:5, :383]),)),
        ("seeded sort axis=1 (8,2048), ties and ±0", "sort",
         (t(np.round(rng.normal(size=(8, 2048)) * 3.0).astype(np.float32)),)),
    ] + [(f"seeded sort axis=1 ({rows},{n}), ties and ±0", "sort",
          (t(np.round(rng.normal(size=(rows, n)) * 3.0).astype(np.float32)),))
         for rows, n in ((5, 37), (5, 100), (5, 127), (5, 200), (5, 203), (3, 2045))]


def run_case(kernel: str, args: tuple) -> torch.Tensor:
    return OPS[kernel][0](*args)


def plain_case(kernel: str, args: tuple) -> torch.Tensor:
    return OPS[kernel][1](*args)


def run_probes(device=None, reps: int = 20) -> list[dict]:
    """The script's ten cases: each checked against the plain version on CPU
    copies, timed over `reps` calls."""
    dev = resolve_device(device)
    out = []
    for name, kernel, args in script_cases(dev):
        got = run_case(kernel, args)
        expect_equal(name, got, plain_case(kernel, tuple(a.cpu() if torch.is_tensor(a) else a for a in args)))
        out.append(result(name, time_us(lambda: run_case(kernel, args), dev, reps), 1, got, dev))
    return out
