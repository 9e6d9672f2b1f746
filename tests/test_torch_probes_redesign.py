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
- 9c's sort: the kernel's schedule (one warp a row, K keys a lane, the bitonic
  stages in its order: a stride below K inside a lane, a wider one between
  lanes l and l ^ (stride / K)) modelled in numpy sorts the keys as NumPy
  does, at every width class the wrapper takes.
- 9d's roll chain: the kernel's loads (each distinct rotated value once) and
  its add order (trips of max(D, 8) adds, then the rest) modelled in numpy
  equal `roll_chain_reference` bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from oxylus_tpu_torch.probes import dot_rhs_t, mosaic_ops, roll

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


# ---- 9c's sort ---------------------------------------------------------------------

PAD_KEY, NAN_KEY = np.uint32(0xFFFFFFFF), np.uint32(0xFFFFFFFE)


def float_keys(x: np.ndarray) -> np.ndarray:
    """The kernel's `float_key`: order-preserving uint32 keys, NaN above +inf,
    -0 below +0."""
    b = x.view(np.uint32)
    key = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(np.isnan(x), NAN_KEY, key)


def warp_sort_model(x: np.ndarray) -> np.ndarray:
    """`sort_kernel`'s keys out for (rows, n) float32: the row padded to
    P = 32·K keys (K a power of two), lane l holding keys l·K .. l·K + K - 1;
    phases of merge width k = 2 .. P, in each the strides k/2 .. 1. From k = K
    on, a lane whose k-block descends complements its keys for the phase and
    every stage sorts ascending; below K the slot's block sets the direction.
    A stride below K pairs slots q and q ^ j of a lane, a wider one lanes l
    and l ^ (j / K); the lower index keeps the smaller key where ascending."""
    rows, n = x.shape
    k_lane = 1
    while 32 * k_lane < n:
        k_lane *= 2
    p = 32 * k_lane
    keys = np.full((rows, p), PAD_KEY, np.uint32)
    keys[:, :n] = float_keys(x)
    key = keys.reshape(rows, 32, k_lane)
    lane, slot = np.arange(32)[:, None], np.arange(k_lane)[None, :]
    k = 2
    while k <= p:
        descends = (k >= k_lane) & (k < p) & (((lane * k_lane) & k) != 0)
        flip = np.where(descends, np.uint32(0xFFFFFFFF), np.uint32(0))
        key = key ^ flip
        j = k // 2
        while j:
            if j < k_lane:  # inside a lane: slots q and q ^ j
                partner = key[:, :, slot[0] ^ j]
                keep_min = ((slot & j) == 0) == ((k >= k_lane) | ((slot & k) == 0))
            else:  # between lanes l and l ^ (j / K), by shfl.xor
                partner = key[:, lane[:, 0] ^ (j // k_lane), :]
                keep_min = (lane & (j // k_lane)) == 0
            key = np.where(keep_min, np.minimum(key, partner), np.maximum(key, partner))
            j //= 2
        key = key ^ flip
        k *= 2
    return key.reshape(rows, p)[:, :n]


@pytest.mark.parametrize("n", [1, 37, 384, 1000, 2048])
def test_sort_schedule_sorts_the_keys(n):
    """Seeded rows with ties, NaN and ±0: the schedule gives NumPy's order of
    the keys, and the plain version's bits (-0 before +0, NaN last as
    0x7fc00000)."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(5, n)) * 4.0).astype(np.float32)
    x[::2] = np.round(x[::2])  # ties, and -0 beside +0
    x[1, :: max(1, n // 4)] = np.nan
    x[3, : min(n, 4)] = np.array([-0.0, 0.0, -0.0, 0.0], np.float32)[: min(n, 4)]
    got = warp_sort_model(x)
    assert np.array_equal(got, np.sort(float_keys(x), 1))
    want = mosaic_ops.sort_lanes_reference(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, float_keys(want))  # float_keys is one to one but for NaN's payload
    assert (want[np.isnan(want)].view(np.uint32) == 0x7FC00000).all()


# ---- 9d's roll chain ---------------------------------------------------------------


def roll_chain_model(x: np.ndarray, n_iter: int, shift: int, step_mod: int = 0, accumulate: bool = True):
    """`roll_chain_kernel` on (rows, 128) float32: element (r, j) loads
    v[k] = x[r, (j - base - k) mod 128] for k < D = min(step_mod or 1, 128)
    once, then from 0.0 adds v[k % D] in trips of C = max(D, 8), then the last
    n_iter % C; without `accumulate`, `roll_last_kernel`'s last roll alone."""
    base = (int(math.fmod(shift, 128)) + 128) % 128  # C's truncating %, then into [0, 128)
    lanes = np.arange(128)
    if not accumulate:
        return x[:, (lanes - base - ((n_iter - 1) & (step_mod - 1) if step_mod else 0)) & 127]
    d = min(step_mod or 1, 128)
    v = [x[:, (lanes - base - k) & 127] for k in range(min(d, n_iter))]
    c = max(d, 8)
    acc, i = np.zeros_like(x), 0
    while i + c <= n_iter:
        for k in range(c):
            acc = acc + v[k % d]
        i += c
    for k in range(c):
        if i + k < n_iter:
            acc = acc + v[k % d]
    return acc


@pytest.mark.parametrize("step_mod", [0, 1, 2, 4, 8, 256])
def test_roll_chain_model_equals_the_plain_version(step_mod):
    """Static (0) and dynamic chains and the last roll alone, shifts -3, 0, 127
    and 130, 1 and 37 rows, chains shorter than, equal to and longer than a
    trip; bit for bit."""
    for rows in (1, 37):
        x = roll.seeded_x(rows, (rows, 128), "cpu")
        xn = x.numpy()
        for shift in (-3, 0, 127, 130):
            for n_iter in (1, 3, 8, 21, 300):
                for accumulate in (True, False):
                    want = roll.roll_chain_reference(x, n_iter, shift, step_mod, accumulate).numpy()
                    got = roll_chain_model(xn, n_iter, shift, step_mod, accumulate)
                    assert np.array_equal(got.view(np.int32), want.view(np.int32)), (rows, shift, n_iter, accumulate)


def test_roll_chain_model_at_the_scripts_chains():
    x = roll.script_x("cpu")
    for base, step_mod in ((1, 0), (roll.DYN_BASE, roll.DYN_STEP)):
        want = roll.roll_chain_reference(x, roll.N_INNER, base, step_mod).numpy()
        assert np.array_equal(roll_chain_model(x.numpy(), roll.N_INNER, base, step_mod).view(np.int32),
                              want.view(np.int32))
