"""The port's HiZ pyramid and occlusion test against the JAX package's device
path, `build_hiz_pallas`, run in interpret mode (its `pallas_call` is wrapped
to pass `interpret=True`, for this module only).

The port builds the device path's pyramid on every device, so shapes and values
must be exactly equal (min is exact; a missing partner at an odd size reads 0
on both sides). The occlusion test reads the same pyramid and must agree
exactly too."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from oxylus_tpu.ops import hiz as jhiz
from oxylus_tpu_torch.ops import hiz as thiz

torch.set_num_threads(1)


@contextlib.contextmanager
def pallas_interpret():
    """Route every `pl.pallas_call` to interpret mode while the block runs."""
    orig = pl.pallas_call

    def interp(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pl.pallas_call = interp
    try:
        yield
    finally:
        pl.pallas_call = orig


def _depth(h, w, seed):
    """Reverse-Z depth with empty (0) regions, like a raster output."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.3, 1.0, (h, w)).astype(np.float32)
    d[: h // 3, : w // 4] = 0.0
    return d


@pytest.fixture(scope="module", params=[(144, 256), (300, 700)], ids=["144x256", "300x700"])
def pyramids(request):
    h, w = request.param
    d = _depth(h, w, seed=h + w)
    with pallas_interpret():
        want = [np.asarray(m) for m in jhiz.build_hiz_pallas(jnp.asarray(d))]
    got = [m.numpy() for m in thiz.build_hiz(torch.from_numpy(d))]
    return d, want, got


def test_hiz_levels_match_exactly(pyramids):
    _, want, got = pyramids
    assert [m.shape for m in got] == [m.shape for m in want]
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"level {lvl}")


def test_hiz_cpu_runs_the_plain_version(pyramids):
    d, _, got = pyramids
    launches = thiz.LAUNCHES
    ref = thiz.hiz_reference(torch.from_numpy(d))
    assert thiz.LAUNCHES == launches
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r.numpy())
    # the 300×700 pyramid has odd levels, whose missing partners read 0 (far)
    odd = [m for m in got if any(n % 2 == 1 and n > 1 for n in m.shape)]
    assert bool(odd) == (d.shape[0] == 300)


def test_occlusion_test_matches_exactly(pyramids):
    d, want, _ = pyramids
    h, w = d.shape
    rng = np.random.default_rng(7)
    n = 400
    x0 = rng.uniform(-20, w + 10, n).astype(np.float32)
    y0 = rng.uniform(-20, h + 10, n).astype(np.float32)
    size = np.exp2(rng.uniform(0, 8, n)).astype(np.float32)
    x1, y1 = x0 + size * rng.uniform(0.2, 1.0, n).astype(np.float32), y0 + size
    near = rng.uniform(0.0, 1.0, n).astype(np.float32)
    ref = np.asarray(jhiz.occlusion_test([jnp.asarray(m) for m in want], *map(jnp.asarray, (x0, x1, y0, y1, near)), w, h))
    got = thiz.occlusion_test([torch.from_numpy(m) for m in want], *map(torch.from_numpy, (x0, x1, y0, y1, near)), w, h)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < ref.sum() < n  # both outcomes exercised


def test_counters_are_kept_per_card_and_stream():
    """ROADMAP C4: the kernel's finished-block counter is keyed by (card,
    stream), so launches on two streams never count into one counter; a key
    seen again gets its own counter back, zeroed."""
    cpu = torch.device("cpu")
    saved = dict(thiz._COUNTERS)
    try:
        a, b = thiz._counter(cpu, 11), thiz._counter(cpu, 12)
        assert a is not b and a.data_ptr() != b.data_ptr()
        assert thiz._counter(cpu, 11) is a and thiz._counter(torch.device("cpu"), 12) is b
        assert a.dtype == torch.int32 and a.shape == (1,) and int(a) == 0 and int(b) == 0
        assert {(cpu, 11), (cpu, 12)} <= set(thiz._COUNTERS)
    finally:
        thiz._COUNTERS.clear()
        thiz._COUNTERS.update(saved)
