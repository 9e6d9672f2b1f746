"""The port's bench (`oxylus_tpu_torch/bench.py`) reads the environment that
the repo's `bench.py` reads, on the CPU.

- `OX_BENCH` names the one cell to run and print, as `bench.py:707-718`: the
  JAX bench's `main` runs in a subprocess with its cells stubbed, and the
  cells each package runs for `OX_BENCH` unset, `all`, `physics`, `frame5`
  and an unknown name must agree; a cell named on the command line still
  wins over the variable.
- `OX_BENCH_BANDED=0` selects the dense kernel over `OX_BENCH_KERNEL`
  (`bench.py:72-74`) for both physics cells; unset, the kernel is
  `OX_BENCH_KERNEL`'s.
- The frame cells' raster knobs: with each variable set, the `RenderSpec` the
  port's `frame3d` and `frame5` cells build equals the one `bench.py`'s
  builders pass to the JAX `SceneRunner` (recorded in the subprocess by a
  stub runner, the scenes cut to a few objects); with none set, the port's
  defaults (the builders' own `RASTER`) equal the JAX bench's. The atrium's
  knobs are held by a table that cites `bench.py:594-610` (building the JAX
  atrium takes minutes and writes a cache beside `bench.py`): the lines are
  read from its source, and the port's atrium built small with the same
  variables carries them, its capacities from the prepass counts by the
  formula of `bench.py:595-596`.
- What the port cannot run is refused with the variable's name: `OX_TILE`
  other than 16, 32 or 64, `OX_K2` not a multiple of 64 or above 256, a count
  of 0, a value that is not a number."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from oxylus_tpu_torch import bench, frame3d, frame5, sponza

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("OX_BENCH", "OX_BENCH_KERNEL", "OX_BENCH_BANDED", "OX_BENCH_MEGA", "OX_BENCH_WORLDS", "OX_COMPACT",
            "OX_TILE", "OX_K2", "OX_BG", "OX_MPT", "OX_CAP_MULT", "OX_RASTER_GROUP")
SPEC_FIELDS = ("compact_raster", "tile", "tris_per_tile", "bin_groups_per_tile", "meshlets_per_tile", "raster_group")
# each knob set of the frame cells, as a user would set them
KNOB_SETS = {
    "none": {},
    "all": {"OX_COMPACT": "1", "OX_TILE": "64", "OX_K2": "128", "OX_BG": "16", "OX_MPT": "32"},
    "k2-256": {"OX_K2": "256", "OX_BG": "48", "OX_COMPACT": "0"},
    "tile-32": {"OX_TILE": "32"},
}

JAX_SIDE = """
import json, os, sys, bench
import oxylus_tpu.runtime as rt
from oxylus_tpu.core.config import RendererConfig

ran, specs = [], {}
for name in ("physics", "physics10k", "frame2d", "frame3d", "frame5", "sponza"):
    setattr(bench, "_run_" + name, lambda _n=name: (ran.append(_n), {"metric": _n, "value": 1.0, "unit": "-",
                                                                     "vs_baseline": 1.0})[1])
for which in json.loads(sys.argv[1]):
    if which is None:
        os.environ.pop("OX_BENCH", None)
    else:
        os.environ["OX_BENCH"] = which
    ran.clear()
    bench.main()
    specs["cells:" + str(which)] = list(ran)
os.environ.pop("OX_BENCH", None)

class Recorder:
    def __init__(self, scene, **kw):
        s = kw["render_spec"]
        self.spec = {f: getattr(s, f) for f in %r}
        self.config = RendererConfig()

for label, env in json.loads(sys.argv[2]).items():
    for k in ("OX_COMPACT", "OX_TILE", "OX_K2", "OX_BG", "OX_MPT"):
        os.environ.pop(k, None)
    os.environ.update(env)
    rt.SceneRunner = Recorder
    specs["frame3d:" + label] = bench._build_frame3d_runner(64, 36, n_objects=2).spec
    specs["frame5:" + label] = bench._build_frame5_runner(64, 36, n_objects=2, n_boxes=2).spec
print(json.dumps(specs))
""" % (SPEC_FIELDS,)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX bench's choices, recorded in a subprocess: the cells its `main`
    runs for each `OX_BENCH`, and the `RenderSpec` fields its config-3 and
    config-5 builders pass for each knob set."""
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    which = [None, "all", "physics", "frame5", "nope"]
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(which), json.dumps(KNOB_SETS)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _stub_cells(monkeypatch) -> list:
    ran = []
    cells = {name: (lambda _n=name: (ran.append(_n), {"metric": _n, "value": 1.0, "unit": "-", "vs_baseline": 1.0})[1])
             for name in bench.CELLS}
    monkeypatch.setattr(bench, "CELLS", cells)
    return ran


@pytest.mark.parametrize("which", [None, "all", "physics", "frame5", "nope"])
def test_ox_bench_picks_the_cells_bench_py_runs(jax_bench, monkeypatch, capsys, which):
    ran = _stub_cells(monkeypatch)
    if which is not None:
        monkeypatch.setenv("OX_BENCH", which)
    assert bench.main([]) == 0
    want = jax_bench[f"cells:{which}"]
    assert sorted(ran) == sorted(want) and len(ran) == len(want)
    out = capsys.readouterr()[0].strip().splitlines()
    assert len(out) == 1
    if len(want) == 1:  # a single cell prints its own line, without the suite
        assert json.loads(out[0]) == {"metric": which, "value": 1.0, "unit": "-", "vs_baseline": 1.0}
    # a cell named on the command line wins over the variable
    ran.clear()
    assert bench.main(["frame3d"]) == 0 and ran == ["frame3d"]


def test_ox_bench_physics_runs_the_physics_cell_alone(monkeypatch, capsys):
    """`OX_BENCH=physics python -m oxylus_tpu_torch.bench`, the cell itself
    stubbed at `bench_physics`: one line, the physics cell's."""
    monkeypatch.setenv("OX_BENCH", "physics")
    calls = []
    monkeypatch.setattr(bench, "bench_physics", lambda **kw: (calls.append(kw), {"rate": 2e7, "n_bodies": 1023,
                                                                                "worlds": 1})[1])
    assert bench.main([]) == 0
    line = json.loads(capsys.readouterr()[0].strip())
    assert line["unit"] == "body-steps/s" and line["value"] == 20000000 and "falling boxes" in line["metric"]
    assert len(calls) == 1 and calls[0]["kernel"] == "compact"


@pytest.mark.parametrize("env, kernel", [({}, "compact"), ({"OX_BENCH_KERNEL": "banded"}, "banded"),
                                         ({"OX_BENCH_BANDED": "0"}, "dense"),
                                         ({"OX_BENCH_KERNEL": "banded", "OX_BENCH_BANDED": "0"}, "dense"),
                                         ({"OX_BENCH_BANDED": "1"}, "compact")])
def test_legacy_banded_switch_selects_the_dense_kernel(monkeypatch, env, kernel):
    """`bench.py:72-74`: `OX_BENCH_BANDED=0` overrides `OX_BENCH_KERNEL`
    with the dense kernel, in `physics` and `physics10k`."""
    src = open(os.path.join(ROOT, "bench.py")).read()
    assert ('kern = os.environ.get("OX_BENCH_KERNEL", "compact")\n        if os.environ.get("OX_BENCH_BANDED") == "0":'
            in src and 'kern = "dense"' in src)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(bench, "bench_physics", lambda **kw: (calls.append(kw), {"rate": 1e7, "n_bodies": 1,
                                                                                "worlds": 1})[1])
    bench.run_physics()
    bench.run_physics10k()
    assert [c["kernel"] for c in calls] == [kernel, kernel]


def _port_spec(monkeypatch, cell: str) -> dict:
    """The `RenderSpec` fields the port's cell builds under the current
    environment: its builder runs (small) and the runner is stubbed."""
    import oxylus_tpu_torch.runtime as rt

    seen = {}

    class Recorder:
        def __init__(self, scene, **kw):
            seen.update({f: getattr(kw["render_spec"], f) for f in SPEC_FIELDS})
            self.device = torch.device("cpu")

    monkeypatch.setattr(rt, "SceneRunner", Recorder)
    monkeypatch.setattr(bench, "_frame_windows", lambda runner, frames, warmup: (1.0, [], []))
    monkeypatch.setattr(bench, "_read_stats", lambda stats, keys: [dict.fromkeys(keys, 0)])
    if cell == "frame3d":
        bench.bench_frame_3d(64, 36, device="cpu", n_objects=2)
    else:
        bench.bench_frame_5(64, 36, device="cpu", n_objects=2, n_boxes=2)
    return seen


@pytest.mark.parametrize("cell", ["frame3d", "frame5"])
@pytest.mark.parametrize("knobs", list(KNOB_SETS))
def test_frame_cell_knobs_match_bench_py(jax_bench, monkeypatch, cell, knobs):
    for k, v in KNOB_SETS[knobs].items():
        monkeypatch.setenv(k, v)
    got = _port_spec(monkeypatch, cell)
    assert got == jax_bench[f"{cell}:{knobs}"]
    if knobs == "none":  # the builders' own defaults are the bench's
        builder = frame3d if cell == "frame3d" else frame5
        assert all(got[k] == v for k, v in builder.RASTER.items())


def test_sponza_knobs_match_bench_py(monkeypatch):
    """The atrium's knobs, by table: `bench.py:594-610` reads these lines, and
    the port's atrium (built small: 8 meshes, 4 materials, 96×64) carries the
    same values, its capacities from the prepass counts by `bench.py`'s
    formula."""
    src = open(os.path.join(ROOT, "bench.py")).read()
    table = {  # bench.py line: (variable, value set, RenderSpec field or cap_mult)
        '_cm = float(os.environ.get("OX_CAP_MULT", "4"))': ("OX_CAP_MULT", "2.5", "cap_mult"),
        '_rg = int(os.environ.get("OX_RASTER_GROUP", "64"))': ("OX_RASTER_GROUP", "32", "raster_group"),
        '_tl = int(os.environ.get("OX_TILE", "64"))': ("OX_TILE", "64", "tile"),
        '_mpt = int(os.environ.get("OX_MPT", "64"))': ("OX_MPT", "48", "meshlets_per_tile"),
        'tris_per_tile=int(os.environ.get("OX_K2", "256"))': ("OX_K2", "192", "tris_per_tile"),
        'bin_groups_per_tile=int(os.environ.get("OX_BG", "32"))': ("OX_BG", "24", "bin_groups_per_tile"),
    }
    for line in table:
        assert line in src, line
    assert "cap = 1 << max(12, int(np.ceil(np.log2(max(_cm * n_exp, 1)))))" in src
    assert "vm_cap = 1 << max(10, int(np.ceil(np.log2(max(_cm * n_vis, 1)))))" in src
    assert bench.raster_env("sponza") == {"cap_mult": 4.0, **sponza.RASTER}
    for var, value, _field in table.values():
        monkeypatch.setenv(var, value)
    raster = bench.raster_env("sponza")
    for var, value, field in table.values():
        assert raster[field] == (float(value) if field == "cap_mult" else int(value)), var
    cap_mult = raster.pop("cap_mult")
    _scene, kw, info = sponza.build_sponza_scene(96, 64, n_meshes=8, n_materials=4, device="cpu", cap_mult=cap_mult,
                                                 raster=raster)
    spec, pre = kw["render_spec"], info["prepass"]
    assert all(getattr(spec, f) == v for f, v in raster.items())
    assert spec.max_meshlet_instances == 1 << max(12, int(math.ceil(math.log2(max(cap_mult * pre["expanded"], 1)))))
    assert spec.max_visible_meshlets == 1 << max(10, int(math.ceil(math.log2(max(cap_mult * pre["visible"], 1)))))


@pytest.mark.parametrize("cell, env, error", [
    ("frame3d", {"OX_TILE": "48"}, ValueError),
    ("sponza", {"OX_TILE": "128"}, ValueError),
    ("frame5", {"OX_K2": "320"}, ValueError),
    ("frame3d", {"OX_K2": "100"}, ValueError),
    ("sponza", {"OX_BG": "0"}, ValueError),
    ("frame5", {"OX_BG": "many"}, ValueError),
    ("sponza", {"OX_CAP_MULT": "x"}, ValueError),
    ("frame3d", {"OX_MPT": "-1"}, ValueError),
])
def test_unrunnable_values_are_refused_by_name(monkeypatch, cell, env, error):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(error, match=next(iter(env))):
        bench.raster_env(cell)
