"""The probe 9d's product kernels, on the CPU (no JAX): what of them the card's
checks rest on.

The kernels (`oxylus_tpu_torch/probes/csrc/roll.cu`) run the grid that
`roll.product_plan` lays out and decode it as `roll.product_blocks` does:
m-tiles × n-tiles × k-slices × repetition groups, each CTA writing one float32
partial, the partials then added in a fixed order.

- The blocks cover every (row, column, k, repetition) of a product exactly
  once, at the script's five shapes, the two ragged ones `chip_smoke.py`
  checks and seeded shapes inside the wrapper's contract.
- Each plan's shared memory fits a CTA (227 KB).
- A numpy emulation of the kernels' grouping (each k step's exact products
  added to a float32 running sum and rounded once, the k-warps' sums added in
  order, then the partials in the reduction's order) stays within
  `product_bound` of `matmul_reference` at 1, 7 and 500 repetitions, and is
  exact on all-ones.
- The wrapper accepts and refuses the same shapes as before the plan.
"""

import itertools

import numpy as np
import pytest
import torch

from oxylus_tpu_torch.probes import roll

torch.set_num_threads(1)

RAGGED = ((96, 80, 48, torch.float32), (48, 64, 80, torch.bfloat16))
RED_WARPS = 32  # the reduction's warps: warp w adds partials w, w + 32, ... in order, then the warps in order


def seeded_shapes(seed: int, count: int) -> list:
    """Shapes inside the wrapper's contract: float32 m % 32, n % 16, k % 4; bf16 m, k, n % 16."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        if i % 2 == 0:
            shape = (32 * int(rng.integers(1, 40)), 4 * int(rng.integers(1, 300)), 16 * int(rng.integers(1, 12)),
                     torch.float32)
        else:
            shape = (16 * int(rng.integers(1, 80)), 16 * int(rng.integers(1, 80)), 16 * int(rng.integers(1, 12)),
                     torch.bfloat16)
        out.append(shape + (int(rng.integers(1, 600)),))
    return out


PLAN_CASES = ([s + (r,) for s in roll.MATMULS + RAGGED for r in (1, 7, roll.REPS_M)] + seeded_shapes(15, 12))


def case_id(case):
    m, k, n, dtype, reps = case
    return f"{m}x{k}x{n}-{str(dtype).split('.')[-1]}-x{reps}"


def partition(ranges, extent) -> bool:
    """Whether the [start, end) ranges, sorted, tile [0, extent) without gap or overlap."""
    at = 0
    for lo, hi in sorted(ranges):
        if lo != at or hi <= lo:
            return False
        at = hi
    return at == extent


@pytest.mark.parametrize("case", PLAN_CASES, ids=case_id)
def test_plan_covers_every_term_once_and_fits_shared_memory(case):
    m, k, n, dtype, reps = case
    plan = roll.product_plan(m, k, n, reps, dtype)
    assert plan["smem_bytes"] <= roll.SMEM_MAX
    blocks = roll.product_blocks(plan)
    assert len(blocks) == plan["grid"] == plan["tiles_m"] * plan["tiles_n"] * plan["parts"]
    rows, cols = {b["rows"] for b in blocks}, {b["cols"] for b in blocks}
    slices = {(b["k_runs"][0][0], b["k_runs"][-1][1]) for b in blocks}
    rep_ranges = {b["reps"] for b in blocks}
    assert partition(rows, m) and partition(cols, n) and partition(slices, k) and partition(rep_ranges, reps)
    # each block's k runs tile its k-slice in order (empty runs only past k)
    for b in blocks:
        runs = b["k_runs"]
        assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))
        assert all(hi > lo or lo == k for lo, hi in runs)
    # the blocks are the product of the four partitions, each combination once
    combos = {(b["rows"], b["cols"], (b["k_runs"][0][0], b["k_runs"][-1][1]), b["reps"]) for b in blocks}
    assert len(combos) == len(blocks) == len(rows) * len(cols) * len(slices) * len(rep_ranges)
    # every output tile gets each partial once, and a partial is one (k-slice, repetition group)
    for tile in itertools.product(rows, cols):
        assert sorted(b["part"] for b in blocks if (b["rows"], b["cols"]) == tile) == list(range(plan["parts"]))
    part_of = {}
    for b in blocks:
        key = ((b["k_runs"][0][0], b["k_runs"][-1][1]), b["reps"])
        assert part_of.setdefault(b["part"], key) == key


def test_plan_covers_small_products_term_by_term():
    """At small shapes, count each (row, column, k, repetition) directly."""
    for m, k, n, dtype, reps in [(32, 20, 16, torch.float32, 9), (64, 12, 80, torch.float32, 5),
                                 (48, 32, 16, torch.bfloat16, 11), (16, 48, 64, torch.bfloat16, 3)]:
        seen = np.zeros((m, n, k, reps), np.int32)
        for b in roll.product_blocks(roll.product_plan(m, k, n, reps, dtype)):
            (r0, r1), (c0, c1), (g0, g1) = b["rows"], b["cols"], b["reps"]
            for k0, k1 in b["k_runs"]:
                seen[r0:r1, c0:c1, k0:k1, g0:g1] += 1
        assert (seen == 1).all(), (m, k, n, dtype)


def emulate(a: np.ndarray, b: np.ndarray, reps: int, dtype: torch.dtype) -> np.ndarray:
    """Σ over reps of a·b summed as the kernels group it: per CTA and k-warp a
    float32 running sum over the repetitions and k steps (FFMA: one product a
    step; the tensor cores: a 16-wide step's exact products), each step
    rounded once; the k-warps' sums added in order; then the partials in the
    reduction's order (none when there is one)."""
    m, n = a.shape[0], b.shape[1]
    plan = roll.product_plan(m, a.shape[1], n, reps, dtype)
    width = 1 if dtype == torch.float32 else 16
    parts = np.zeros((plan["parts"], m, n), np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for blk in roll.product_blocks(plan):
        (r0, r1), (c0, c1) = blk["rows"], blk["cols"]
        total = None
        for k0, k1 in blk["k_runs"]:
            steps = [a64[r0:r1, j:min(j + width, k1)] @ b64[j:min(j + width, k1), c0:c1] for j in range(k0, k1, width)]
            acc = np.zeros((r1 - r0, c1 - c0), np.float32)
            for _ in range(blk["reps"][1] - blk["reps"][0]):
                for step in steps:
                    acc = (acc + step).astype(np.float32)
            total = acc if total is None else total + acc
        parts[blk["part"], r0:r1, c0:c1] = total
    if plan["parts"] == 1:
        return parts[0]
    warp_sums = []
    for w in range(RED_WARPS):
        s = np.zeros((m, n), np.float32)
        for p in range(w, plan["parts"], RED_WARPS):
            s = s + parts[p]
        warp_sums.append(s)
    out = warp_sums[0]
    for s in warp_sums[1:]:
        out = out + s
    return out


EMULATED = ((32, 24, 16, torch.float32), (64, 40, 64, torch.float32), (96, 80, 48, torch.float32),
            (32, 48, 16, torch.bfloat16), (48, 64, 80, torch.bfloat16))


@pytest.mark.parametrize("reps", [1, 7, roll.REPS_M])
@pytest.mark.parametrize("shape", EMULATED, ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}-{str(s[3]).split('.')[-1]}")
def test_kernel_grouping_stays_within_the_bound(shape, reps):
    m, k, n, dtype = shape
    a, b = roll.seeded_matrices(m + k + n, m, k, n, dtype, "cpu")
    want = roll.matmul_reference(a, b, reps).double().numpy()
    tol = roll.product_bound(a, b, reps).numpy()
    got = emulate(a.float().numpy(), b.float().numpy(), reps, dtype)
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()


@pytest.mark.parametrize("shape", EMULATED + RAGGED[:1], ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}-{str(s[3]).split('.')[-1]}")
def test_kernel_grouping_is_exact_on_all_ones(shape):
    m, k, n, dtype = shape
    got = emulate(np.ones((m, k), np.float32), np.ones((k, n), np.float32), roll.REPS_M, dtype)
    assert (got == roll.REPS_M * k).all()


def old_rule(m: int, k: int, n: int, dtype: torch.dtype, reps: int) -> bool:
    """The shapes the wrapper took before the plan (its refusal, word for word)."""
    rows = 32 if dtype == torch.float32 else 16
    return not (m % rows or n % 16 or k % (4 if dtype == torch.float32 else 16) or reps < 1)


def test_wrapper_accepts_and_refuses_the_same_shapes():
    for m, k, n, dtype, reps in itertools.product((0, 16, 32, 48, 64), (4, 16, 20, 32), (8, 16, 32),
                                                  (torch.float32, torch.bfloat16), (0, 1, 3)):
        a, b = torch.ones(m, k, dtype=dtype), torch.ones(k, n, dtype=dtype)
        if old_rule(m, k, n, dtype, reps):
            got = roll.matmul_acc(a, b, reps)
            assert got.dtype == torch.float32 and tuple(got.shape) == (m, n) and (got == reps * k).all()
            if m:
                assert roll.product_plan(m, k, n, reps, dtype)["grid"] >= 1
        else:
            with pytest.raises(ValueError):
                roll.matmul_acc(a, b, reps)
            with pytest.raises(ValueError):
                roll.product_plan(m, k, n, reps, dtype)
    for a, b in ((torch.ones(32, 16), torch.ones(16, 16, dtype=torch.bfloat16)),  # mixed types
                 (torch.ones(32, 16), torch.ones(8, 16)),  # inner sizes differ
                 (torch.ones(32, 16, dtype=torch.float64), torch.ones(16, 16, dtype=torch.float64)),
                 (torch.ones(16, 32).t(), torch.ones(16, 16))):  # not contiguous
        with pytest.raises(ValueError):
            roll.matmul_acc(a, b, 1)
