"""The Hopper probes' plain versions (`oxylus_tpu_torch/probes/`) against the
TPU probe scripts' own Pallas kernels, run with `pl.pallas_call(...,
interpret=True)` on the CPU.

`scripts/probe_dynslice.py` guards its `main`, so its `kernel` is imported.
The other three scripts call `pallas_call` at import, so only their imports,
constants and `def`s are executed here (their `fori_loop` trip counts
`N_INNER` and `REPS_M` are set small in that namespace), and
`probe_mosaic_ops`' ten kernels are the lambdas of its `try_kernel` calls.
Inputs are the scripts' own and seeded ones at the same shapes.

Tolerances: exact everywhere but in three places, each for its reason:
- cumsum on float inputs: the two sides add in another order, within
  2·n·2⁻²⁴·Σ|x| of the prefix (exact on the script's integer inputs);
- bf16 x·x + x: 1 bf16 ulp, since XLA on the CPU may keep float32 between the
  two operations where the port rounds each to bf16;
- the products (`dot_rhs_t`, `matmul_acc` on seeded matrices): the same exact
  products summed in another order, within `sum_order_bound` /
  `product_bound` (2·n·2⁻²⁴·Σ|product|).
The vector chain is held exactly, each side against its own rounding: XLA on
the CPU fuses the chain's multiply-adds, the port does not (see its test).
"""

import ast
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from oxylus_tpu_torch import probes
from oxylus_tpu_torch.probes import dot_rhs_t, dynslice, mosaic_ops, roll

torch.set_num_threads(1)

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def script_namespace(name: str, **overrides):
    """Execute a probe script's imports, constants and function definitions
    (also those inside loops), up to its first top-level `pallas_call`; return
    the namespace with `overrides` applied and the `try_kernel` call nodes."""
    path = os.path.join(SCRIPTS, name)
    tree = ast.parse(open(path).read())
    keep, calls = [], []

    def walk(body, top):
        for node in body:
            if isinstance(node, ast.FunctionDef) or (top and isinstance(node, (ast.Import, ast.ImportFrom))):
                keep.append(node)
            elif top and isinstance(node, ast.Assign):
                if "pallas_call" in ast.unparse(node.value):
                    return
                keep.append(node)
            elif isinstance(node, ast.For):
                walk(node.body, False)
            elif top and isinstance(node, ast.Expr) and isinstance(node.value, ast.Call) \
                    and getattr(node.value.func, "id", None) == "try_kernel":
                calls.append(node.value)

    walk(tree.body, True)
    ns = {"__name__": f"probe_script_{name}"}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    ns.update(overrides)
    return ns, calls


def interpret(kern, inputs, out_shape, scratch=()):
    """The scripts' pallas_call, in interpret mode; numpy in, numpy out."""
    return np.asarray(pl.pallas_call(kern, in_specs=[VMEM] * len(inputs), out_specs=VMEM, out_shape=out_shape,
                                     scratch_shapes=list(scratch), interpret=True)(*inputs))


def to_jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy())


def assert_exact(got: torch.Tensor, want: np.ndarray):
    """Equal values, NaN where `want` has NaN (-0 and +0 count as equal, as in a sort)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert same.all(), f"{int((~same).sum())} of {same.size} differ, e.g. {got[~same][:4]} vs {want[~same][:4]}"


# ---- dynslice ------------------------------------------------------------------


@pytest.fixture(scope="module")
def dynslice_script():
    spec = importlib.util.spec_from_file_location("probe_dynslice_script", os.path.join(SCRIPTS, "probe_dynslice.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [None, 3, 4], ids=["script", "seed3", "seed4"])
def test_dynslice_matches_jax_kernel_exactly(dynslice_script, seed):
    x, d = dynslice.script_inputs("cpu") if seed is None else dynslice.seeded_inputs(seed, "cpu")
    want = interpret(dynslice_script.kernel, [jnp.asarray(x.numpy()), jnp.asarray(d.numpy())],
                     jax.ShapeDtypeStruct((2, dynslice.B), jnp.float32), [pltpu.VMEM((2, 4, dynslice.B), jnp.float32)])
    got = dynslice.dynslice(x, d)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
    if seed is not None:  # the seeded offsets reach before, inside and past the windows
        src = np.arange(dynslice.B) + d.numpy()[0]
        ws = np.clip(np.arange(dynslice.B) // 128 * 128, 0, dynslice.B - dynslice.SLAB)
        assert (src < ws).any() and (src >= ws + dynslice.SLAB).any() and (got.numpy() == 0).any()


# ---- dot_rhs_t -------------------------------------------------------------------


@pytest.fixture(scope="module")
def dot_script():
    return script_namespace("probe_dot_rhs_t.py")[0]


@pytest.mark.parametrize("seed", [None, 7], ids=["script", "dense_seed7"])
def test_dot_rhs_t_matches_jax_kernel(dot_script, seed):
    ns = dot_script
    v, m = dot_rhs_t.script_inputs("cpu") if seed is None else dot_rhs_t.seeded_inputs(seed, "cpu")
    want = interpret(ns["kernel"], [jnp.asarray(v.numpy()), to_jax(m)],
                     jax.ShapeDtypeStruct((ns["N2"], ns["SLAB"]), jnp.float32),
                     [pltpu.VMEM((ns["N2"], ns["R"] * ns["b"]), jnp.bfloat16)])
    got = dot_rhs_t.dot_rhs_t(v, m)
    bound = dot_rhs_t.sum_order_bound(v, m).numpy()
    assert got.shape == want.shape == (12, 384)
    assert (np.abs(got.numpy().astype(np.float64) - want) <= bound).all()
    assert dot_rhs_t.script_error(v, m, got) < dot_rhs_t.SCRIPT_TOL
    if seed is None:  # the script's own inputs: its m is the port's, bit for bit
        assert np.array_equal(m.float().numpy(), np.asarray(ns["m"]))


def test_dot_rhs_t_rows_are_the_hi_lo_split():
    v, m = dot_rhs_t.seeded_inputs(11, "cpu")
    rows = dot_rhs_t.split_rows(v).float()
    vcat = v[:, :128].reshape(-1)
    assert (rows[0::2] == rows[0]).all() and (rows[1::2] == rows[1]).all()
    assert ((rows[0] + rows[1]) - vcat).abs().max() <= vcat.abs().max() * 2.0**-16
    with pytest.raises(ValueError):
        dot_rhs_t.dot_rhs_t(v, m[:100])


# ---- mosaic ops ------------------------------------------------------------------


@pytest.fixture(scope="module")
def mosaic_script():
    ns, calls = script_namespace("probe_mosaic_ops.py")
    ev = lambda node: eval(compile(ast.Expression(node), "probe_mosaic_ops.py", "eval"), ns)
    return [(ast.literal_eval(c.args[0]), ev(c.args[1]), ev(c.args[2]), ev(c.args[3])) for c in calls]


def _close_to_jax(kernel, args, got, want):
    if kernel == "bf16_mul_add":
        w = np.asarray(want, np.float32)
        assert (np.abs(got.float().numpy() - w) <= np.abs(w) * 2.0**-7).all()
    elif kernel == "scan" and not (args[0] == torch.round(args[0])).all():
        x = args[0].double().abs()
        prefix = torch.cumsum(x, args[1]).numpy()
        n = x.shape[args[1]]
        assert (np.abs(got.numpy().astype(np.float64) - want) <= 2 * n * 2.0**-24 * prefix).all()
    else:
        assert_exact(got, want)


@pytest.mark.parametrize("case", range(10))
def test_mosaic_ops_match_jax_on_script_inputs(mosaic_script, case):
    name, kern, inputs, out_shape = mosaic_script[case]
    port_name, kernel, args = mosaic_ops.script_cases("cpu")[case]
    assert port_name == name
    tensors = [a for a in args if torch.is_tensor(a)]
    for t, j in zip(tensors, inputs):  # the port's inputs are the script's
        assert np.array_equal(t.float().numpy(), np.asarray(j, np.float32))
    want = interpret(kern, inputs, out_shape)
    _close_to_jax(kernel, args, mosaic_ops.run_case(kernel, args), want)


@pytest.mark.parametrize("case", range(10))
def test_mosaic_ops_match_jax_on_seeded_inputs(mosaic_script, case):
    _, kern, _, out_shape = mosaic_script[case]
    _, kernel, args = mosaic_ops.seeded_cases(21, "cpu")[case]
    want = interpret(kern, [to_jax(a) for a in args if torch.is_tensor(a)], out_shape)
    _close_to_jax(kernel, args, mosaic_ops.run_case(kernel, args), want)


def test_mosaic_ops_plain_versions_on_odd_shapes():
    """The cases past the script's shapes against numpy: the scan within the
    sum-order bound of a float64 cumsum, sort and roll exactly; gathers' wrapped
    and out-of-range indices."""
    for name, kernel, args in mosaic_ops.seeded_cases(22, "cpu")[10:]:
        got = mosaic_ops.run_case(kernel, args).numpy()
        x = args[0].numpy()
        if kernel == "scan":
            want = np.cumsum(x.astype(np.float64), args[1])
            bound = 2 * x.shape[args[1]] * 2.0**-24 * np.cumsum(np.abs(x).astype(np.float64), args[1])
            assert (np.abs(got - want) <= bound).all(), name
        elif kernel == "sort":
            assert np.array_equal(got, np.sort(x, 1)), name
        else:
            assert np.array_equal(got, np.roll(x, args[1], 1)), name
    x = torch.arange(8, dtype=torch.float32).reshape(1, 8)
    got = mosaic_ops.take_lanes(x, torch.tensor([[-1, 8, 9, -9, 3, -8]], dtype=torch.int32))
    assert_exact(got, np.array([[7, np.nan, np.nan, np.nan, 3, 0]], np.float32))


# ---- roll ------------------------------------------------------------------------

N_INNER_CPU = 6
S, L = roll.S, roll.L
SDS = jax.ShapeDtypeStruct


@pytest.fixture(scope="module")
def roll_script():
    return script_namespace("probe_roll.py", N_INNER=N_INNER_CPU, REPS_M=2)[0]


def _smem():
    return [pltpu.SMEM((4,), jnp.int32)]


@pytest.mark.parametrize("seed", [None, 31], ids=["script", "seed31"])
def test_rolls_match_jax_exactly(roll_script, seed):
    ns = roll_script
    x = roll.script_x("cpu") if seed is None else roll.seeded_x(seed, device="cpu")
    xj = [jnp.asarray(x.numpy())]
    out = SDS((S, L), jnp.float32)
    assert_exact(roll.dynamic_roll(x, roll.scalar(roll.DYN_SHIFT, "cpu")),
                 interpret(ns["k_dynroll"], xj, out, _smem()))
    assert_exact(roll.roll_chain(x, N_INNER_CPU), interpret(ns["k_rollrate"], xj, out))
    assert_exact(roll.dynamic_roll_chain(x, N_INNER_CPU, roll.scalar(roll.DYN_BASE, "cpu")),
                 interpret(ns["k_dynrollrate"], xj, out, _smem()))
    if seed is None:
        assert np.array_equal(x.numpy(), np.asarray(ns["x"]))


def _vector_chain_numpy(x: np.ndarray, n_iter: int, fused: bool) -> np.ndarray:
    """The script's chain in numpy float32; with `fused`, each a·b + c rounded
    once (a fused multiply-add, emulated in float64, exact for float32 inputs)."""
    f32, f64 = np.float32, np.float64
    mad = (lambda a, b, c: f32(f64(a) * f64(b) + f64(c))) if fused else (lambda a, b, c: f32(a * b) + c)
    acc = x
    for _ in range(n_iter):
        a = mad(acc, f32(1.000001), x)
        b = mad(a, a, -x)
        c = mad(b, f32(0.5), a)
        acc = mad(c, c, b)
    return acc


@pytest.mark.parametrize("n_iter", [1, 2])
@pytest.mark.parametrize("seed", [None, 32], ids=["script", "seed32"])
def test_vector_chain_matches_jax_while_finite(roll_script, n_iter, seed):
    """From its third iteration on the chain is inf; at 1 and 2 it is finite.
    XLA on the CPU contracts each a·b + c of the chain into a fused
    multiply-add: the JAX kernel equals that chain rounded once per pair, bit
    for bit. The port rounds the product and the sum apart (its kernel is built
    with -fmad=false), and equals the unfused chain bit for bit."""
    x = roll.script_x("cpu") if seed is None else roll.seeded_x(seed, device="cpu")
    roll_script["N_INNER"] = n_iter  # the kernels read it from their namespace
    try:
        want = interpret(roll_script["k_vpu"], [jnp.asarray(x.numpy())], SDS((S, L), jnp.float32))
    finally:
        roll_script["N_INNER"] = N_INNER_CPU
    got = roll.vector_chain(x, n_iter)
    assert np.isfinite(want).all()
    assert_exact(torch.from_numpy(_vector_chain_numpy(x.numpy(), n_iter, fused=True)), want)
    assert_exact(got, _vector_chain_numpy(x.numpy(), n_iter, fused=False))


def test_vector_chain_big_matches_jax_at_its_200_iterations(roll_script):
    xb = roll.script_xb("cpu")
    want = interpret(roll_script["k_vpu_big"], [jnp.asarray(xb.numpy())], SDS((128, 384), jnp.float32))
    got = roll.vector_chain(xb, roll.VPU_BIG_ITERS)
    assert np.isinf(want).all()
    assert_exact(got, want)


@pytest.mark.parametrize("shape", roll.MATMULS, ids=lambda s: f"{s[0]}x{s[1]}x{s[2]}-{str(s[3]).split('.')[-1]}")
def test_products_match_jax(roll_script, shape):
    """All ones at the script's shapes (exactly REPS_M·k), then seeded matrices
    with one repetition (within the sum-order bound)."""
    m, k, n, dtype = shape
    roll_script.update(m=m, k=k, n=n)  # k_mxu reads them from its namespace
    for reps, (a, b) in ((2, (torch.ones(m, k, dtype=dtype), torch.ones(k, n, dtype=dtype))),
                         (1, roll.seeded_matrices(m + n, m, k, n, dtype, "cpu"))):
        roll_script["REPS_M"] = reps
        want = interpret(roll_script["k_mxu"], [to_jax(a), to_jax(b)], SDS((m, n), jnp.float32))
        got = roll.matmul_acc(a, b, reps)
        if reps == 2:
            assert (want == 2 * k).all()
            assert_exact(got, want)
        else:
            assert (np.abs(got.numpy().astype(np.float64) - want) <= roll.product_bound(a, b, reps).numpy()).all()
    roll_script["REPS_M"] = 2


@pytest.mark.parametrize("seed", [None, 33, 34], ids=["script", "seed33", "seed34"])
def test_argmax_extract_matches_jax_exactly(roll_script, seed):
    x = roll.script_x("cpu") if seed is None else roll.seeded_x(seed, device="cpu")
    if seed == 34:
        x = torch.round(x)  # ties, and rows that run out of candidates
    want = interpret(roll_script["k_extract"], [jnp.asarray(x.numpy())], SDS((S, L), jnp.float32))
    assert_exact(roll.argmax_extract(x), want)


def test_dynamic_trip_matches_jax_exactly(roll_script):
    x = roll.script_x("cpu")
    want = interpret(roll_script["k_dyntrip"], [jnp.asarray(x.numpy())], SDS((S, L), jnp.float32), _smem())
    assert_exact(roll.dynamic_trip(x, roll.scalar(roll.DYN_TRIP, "cpu")), want)


# ---- the package -------------------------------------------------------------------


def test_run_all_on_the_cpu_launches_no_kernel():
    """`run_all("cpu")` at a small scale: every probe of the four scripts runs,
    is checked against its plain version and counts no launch."""
    mods = probes.modules()
    before = [m.LAUNCHES for m in mods]
    lines = probes.run_all("cpu", reps=1, n_inner=4, reps_m=2)
    assert [m.LAUNCHES for m in mods] == before
    assert len(lines) == 1 + 1 + 10 + 12
    assert all(r["device"] == "cpu" and np.isfinite(r["us"]) for r in lines)
    assert all(probes.format_line(r).startswith("OK   ") for r in lines)


def test_probes_default_to_the_card(monkeypatch):
    """`device=None` means the card: without one the probes raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in probes.modules():
        with pytest.raises(RuntimeError):
            mod.run_probes(reps=1)


def test_ops_refuse_unsupported_devices_and_shapes():
    x = torch.zeros(2, 128, device="meta")
    with pytest.raises(ValueError):
        roll.roll_chain(x, 2)
    with pytest.raises(ValueError):
        roll.roll_chain(torch.zeros(2, 64), 2)
    with pytest.raises(ValueError):
        roll.roll_chain(torch.zeros(2, 128), 0)
    with pytest.raises(ValueError):
        roll.dynamic_roll_chain(torch.zeros(2, 128), 2, roll.scalar(3, "cpu"), step_mod=3)
    with pytest.raises(ValueError):
        roll.matmul_acc(torch.ones(8, 16), torch.ones(16, 16), 1)
    with pytest.raises(ValueError):
        mosaic_ops.cumsum(torch.zeros(4, 2000), 1)
    with pytest.raises(ValueError):
        dynslice.dynslice(torch.zeros(2, 1024), torch.zeros(1, 1024, dtype=torch.int64))
