"""The port's physics bench (`oxylus_tpu_torch/bench.py`) on the CPU, small.

- `bench_physics` through each of its four routes (the compact, banded and
  dense kernels' plain versions, and `physics_substep` with `mega=False`) on
  a 60-box flagship at capacity 384: the rate is positive, the start state's
  coverage gate holds at the adaptive band, the compact route counts its
  dropped pairs over every launch, the kernel routes check the end state's
  coverage, and the end state is finite.
- The compact route's drop gate fails when one neighbour slot per body drops
  most pairs (`OX_BENCH_RSLOTS=1`), as `bench.py`'s assert does.
- `worlds=2` steps two copies (each equal to the one-world run) and
  `OX_BENCH_WORLDS` reaches the cell; `worlds=0` is refused.
- `run_physics` and `run_physics10k` call `bench_physics` with the JAX
  cells' configurations and turn a rate into the JAX cells' dicts: the JAX
  bench runs in a subprocess with its `bench_physics` replaced by a stub (so
  that its persistent compilation cache setting stays out of this process)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from oxylus_tpu_torch import bench

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_boxes=60, steps_per_call=4, calls=1, warmup=1, device="cpu",
             spec_kw=dict(max_entities=128, max_bodies=384, max_particles=16))
ROUTES = {
    "compact": dict(kernel="compact"),
    "banded": dict(kernel="banded"),
    "dense": dict(kernel="dense"),
    "substep": dict(mega=False),
}


@pytest.fixture(autouse=True)
def _no_bench_env(monkeypatch):
    for k in ("OX_BENCH_KERNEL", "OX_BENCH_MEGA", "OX_BENCH_GE", "OX_BENCH_SLEEP", "OX_BENCH_RSLOTS",
              "OX_BENCH_WORLDS"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("route", list(ROUTES))
def test_bench_physics_routes_and_gates(route):
    r = bench.bench_physics(**SMALL, **ROUTES[route])
    assert r["rate"] > 0 and r["worlds"] == 1 and r["elapsed"] > 0
    assert r["n_bodies"] == 61  # the boxes and the floor
    assert r["band"] == 128 and r["coverage_start"]["outside_band"] == 0 and r["coverage_start"]["pairs"] > 0
    assert ("dropped" in r) == (route == "compact")
    if route == "compact":
        assert r["pair_events"] == r["coverage_start"]["pairs"] * ((1 + 3) * 4 // 2)
        assert 0 <= r["dropped_max"] <= r["dropped"]
    assert ("coverage_end" in r) == (route != "substep")
    ps = r["state"]
    assert bool(torch.isfinite(ps.pos).all()) and bool(torch.isfinite(ps.linvel).all())
    # 16 substeps of free fall (the boxes start above the floor); the XLA-style
    # substep also applies the bodies' linear drag
    dyn = ps.active & (ps.body_type == 2)
    vy = ps.linvel[dyn, 1].numpy()
    if route == "substep":
        assert (vy < -2.5).all() and (vy > -9.81 * 16 / 60.0).all()
    else:
        np.testing.assert_allclose(vy, -9.81 * 16 / 60.0, rtol=0, atol=1e-4)


def test_compact_drop_gate_fails_with_one_slot(monkeypatch):
    monkeypatch.setenv("OX_BENCH_RSLOTS", "1")
    kw = dict(SMALL, n_boxes=200, spec_kw=dict(max_entities=512, max_bodies=384, max_particles=16))
    with pytest.raises(RuntimeError, match="drop rate too high"):
        bench.bench_physics(**kw)


def test_worlds_above_one_are_refused(monkeypatch):
    """Worlds above one run side by side (`worlds=2` reports 2 worlds, each
    equal to the one-world run, the rate over both) and `OX_BENCH_WORLDS`
    reaches the cell; fewer than one world is refused."""
    one = bench.bench_physics(**SMALL, **ROUTES["compact"])
    two = bench.bench_physics(**SMALL, **ROUTES["compact"], worlds=2)
    assert two["worlds"] == 2 and two["rate"] > 0 and "dropped" not in two and "coverage_end" not in two
    assert two["state"].pos.shape == (2,) + tuple(one["state"].pos.shape)
    for w in range(2):
        np.testing.assert_array_equal(two["state"].pos[w].numpy(), one["state"].pos.numpy())
        np.testing.assert_array_equal(two["state"].linvel[w].numpy(), one["state"].linvel.numpy())
    with pytest.raises(ValueError):
        bench.bench_physics(worlds=0, device="cpu")
    seen = []
    monkeypatch.setattr(bench, "bench_physics", lambda **kw: seen.append(kw) or {"rate": 1.0, "worlds": kw["worlds"],
                                                                                 "n_bodies": 1023})
    monkeypatch.setenv("OX_BENCH_WORLDS", "4")
    assert "4x1023 bodies" in bench.run_physics(device="cpu")["metric"] and seen[0]["worlds"] == 4


JAX_CELLS = """
import json, bench
calls = []
def stub(**kw):
    calls.append(kw)
    return 12345678.9, 1023 if kw.get("n_boxes", 1022) == 1022 else 10001, kw.get("worlds", 64), 1.0
bench.bench_physics = stub
print(json.dumps({"physics": bench._run_physics(), "physics10k": bench._run_physics10k(), "calls": calls}))
"""


def test_cells_match_the_jax_bench(monkeypatch):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
    for k in ("OX_BENCH_KERNEL", "OX_BENCH_MEGA", "OX_BENCH_WORLDS"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-c", JAX_CELLS], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])

    calls = []

    def stub(**kw):
        calls.append(kw)
        n = 1023 if kw.get("n_boxes", 1022) == 1022 else 10001
        return {"rate": 12345678.9, "n_bodies": n, "worlds": 1}

    monkeypatch.setattr(bench, "bench_physics", stub)
    assert bench.run_physics() == want["physics"]
    assert bench.run_physics10k() == want["physics10k"]
    jax_phys, jax_10k = want["calls"]
    assert calls[0]["worlds"] == jax_phys["worlds"] == 1 and calls[0]["mega"] == jax_phys["mega"] is True
    assert calls[0]["kernel"] == "compact"
    for k in ("n_boxes", "n_piles", "mega", "calls", "spec_kw"):
        assert calls[1][k] == jax_10k[k], k
