"""The probes' redesigned kernels, on the CPU (no JAX): what of them the card's
checks rest on.

- 9a, `dot_rhs_t`: the kernel splits K into 8 slices of 128, one warp each,
  sums each slice in 16-wide `mma.sync` steps, taking the two steps of each
  32-wide block of K in a permuted order, then adds the slices in order. Its
  float32 sums, emulated here (each step's 16 exact products rounded once),
  stay within `sum_order_bound` of the plain version on the script's and the
  dense seeded inputs: the bound `chip_smoke.py` holds the kernel to. The
  wrapper's shapes are unchanged.
- 9c's roll: the kernel's vector path (16-byte chunks, each the tail of one
  source chunk and the head of the next) modelled in numpy equals `np.roll`
  for every chunk offset; the seeded cases hold rows whose width is not a
  multiple of 4, which take the kernel's element path.
"""

import numpy as np
import pytest
import torch

from oxylus_tpu_torch.probes import dot_rhs_t, mosaic_ops

torch.set_num_threads(1)


def step_order() -> torch.Tensor:
    """(8 slices, 8 steps, 16) indices into K: the products each `mma.sync`
    step sums. Lane (g, t) holds values 8t..8t+7 of each 32-wide block, 4 of
    them per step."""
    return torch.tensor([[[s * dot_rhs_t.BCHUNK + 32 * q + 8 * t + 4 * h + e for t in range(4) for e in range(4)]
                          for q in range(4) for h in range(2)] for s in range(8)])


def emulated(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(12, N) float32 summed in the kernel's order."""
    prods = dot_rhs_t.split_rows(v).double()[:, None, :] * m.double()[None]  # exact
    steps = prods[..., step_order()].sum(-1).float()  # (12, N, 8 slices, 8 steps), each rounded once
    slices = []
    for s in range(8):
        acc = steps[..., s, 0]
        for q in range(1, 8):
            acc = acc + steps[..., s, q]
        slices.append(acc)
    total = slices[0]
    for s in range(1, 8):
        total = total + slices[s]
    return total


def test_step_order_is_a_permutation_of_k():
    assert sorted(step_order().flatten().tolist()) == list(range(dot_rhs_t.K))


@pytest.mark.parametrize("inputs", ["script", "seed 7", "seed 8, n = 72"])
def test_kernel_sum_order_stays_within_the_bound(inputs):
    if inputs == "script":
        v, m = dot_rhs_t.script_inputs("cpu")
    elif inputs == "seed 7":
        v, m = dot_rhs_t.seeded_inputs(7, "cpu")
    else:
        v, m = dot_rhs_t.seeded_inputs(8, "cpu")
        m = m[:72].contiguous()
    got = emulated(v, m)
    want = dot_rhs_t.dot_rhs_t_reference(v, m)
    bound = dot_rhs_t.sum_order_bound(v, m)
    assert bool(((got.double() - want.double()).abs() <= bound).all())
    assert dot_rhs_t.script_error(v, m, got) < dot_rhs_t.SCRIPT_TOL


@pytest.mark.parametrize("n", [8, 72])
def test_wrapper_takes_widths_of_eight(n):
    """The shape contract only: on the CPU the wrapper is the plain version
    (`chip_smoke.py` phase 14 holds the kernel at n = 72)."""
    v, m = dot_rhs_t.seeded_inputs(8, "cpu")
    assert dot_rhs_t.dot_rhs_t(v, m[:n].contiguous()).shape == (dot_rhs_t.N2, n)


def test_wrapper_refuses_what_it_refused():
    v, m = dot_rhs_t.seeded_inputs(8, "cpu")
    bad = [
        (v[:7].contiguous(), m),  # not 8 rows of v
        (v[:, :127].contiguous(), m),  # rows shorter than 128
        (v, m[:, :1000].contiguous()),  # K not 1024
        (v, m[:12].contiguous()),  # N not a multiple of 8
        (v.to(torch.bfloat16), m),
        (v, m.float()),
        (v.reshape(-1), m),
        (v, m.t()),  # not contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError):
            dot_rhs_t.dot_rhs_t(*args)


def roll_by_chunks(x: np.ndarray, shift: int) -> np.ndarray:
    """The roll kernel's vector path: output chunk q is elements o.. of source
    chunk c0 + q and ..o-1 of the next, with s = (n - shift) mod n = 4·c0 + o."""
    rows, n = x.shape
    nc = n // 4
    s = 0 if shift == 0 else n - shift
    o, c0 = s & 3, s >> 2
    x4 = x.reshape(rows, nc, 4)
    y = np.empty_like(x4)
    for q in range(nc):
        c = c0 + q - (nc if c0 + q >= nc else 0)
        a = x4[:, c]
        b = x4[:, 0 if c + 1 == nc else c + 1]
        y[:, q] = a if o == 0 else np.concatenate([a[:, o:], b[:, :o]], 1)
    return y.reshape(rows, n)


@pytest.mark.parametrize("n", [4, 8, 384, 1000])
def test_roll_vector_path_equals_np_roll(n):
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    for shift in sorted({0, 1, 2, 3, 5, n // 2, n - 3, n - 1} & set(range(n))):
        assert np.array_equal(roll_by_chunks(x, shift), np.roll(x, shift, 1)), shift


def test_seeded_rolls_take_both_paths():
    """The seeded cases past the script's shapes hold rolls of rows whose width
    is not a multiple of 4 (the kernel's element path), at shift 0 too, and the
    cases before them are the ones the JAX comparisons index."""
    cases = mosaic_ops.seeded_cases(22, "cpu")
    rolls = [args for _, kernel, args in cases[10:] if kernel == "roll_lanes"]
    widths = {(args[0].shape[1], args[1] % args[0].shape[1]) for args in rolls}
    assert any(n % 4 for n, _ in widths) and any(n % 4 == 0 for n, _ in widths)
    assert any(n % 4 and s == 0 for n, s in widths)
    assert [kernel for _, kernel, _ in cases[:10]] == [kernel for _, kernel, _ in mosaic_ops.script_cases("cpu")]
