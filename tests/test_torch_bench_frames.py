"""The frame cells of the port's bench (`oxylus_tpu_torch/bench.py`) on the CPU.

- `run_frame2d`, `run_frame3d`, `run_frame5` and `run_sponza` turn a frame
  rate into the JAX cells' dicts (metric strings, rounding, `vs_baseline`
  against 60 frames/s): the JAX bench runs in a subprocess with its
  `bench_frame_*` replaced by stubs, as `tests/test_torch_bench_physics.py`
  does for the physics cells;
- the cells' window lengths and the builders' scene arguments equal the JAX
  bench's (read from `bench.py`'s source);
- the default run prints the weakest cell with `suite` as its one stdout
  line and returns 0; a failed cell reports value 0 and makes `main` return
  nonzero; an unknown cell is refused;
- `bench_frame_2d` runs on the CPU at 64×36, one frame a window, and reports
  its binning drops;
- the frame5 gate: the worst frame's binning drop share, read from
  `runner.frame_stats`; the pairs are counted only with
  `SceneRunner(binning_stats=True)`."""

import ast
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

from oxylus_tpu_torch import bench, frame2d, frame3d, frame5

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX_CELLS = """
import json, bench
bench.bench_frame_2d = lambda **kw: 61.23456
bench.bench_frame_3d = lambda **kw: 12.3456789
bench.bench_frame_5 = lambda **kw: 8.76543
bench.bench_frame_sponza = lambda **kw: 45.6789
print(json.dumps({k: getattr(bench, "_run_" + k)() for k in ("frame2d", "frame3d", "frame5", "sponza")}))
"""
RATES = {"frame2d": 61.23456, "frame3d": 12.3456789, "frame5": 8.76543, "sponza": 45.6789}


def test_frame_cells_match_the_jax_bench(monkeypatch):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", JAX_CELLS], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, fn in (("frame2d", "bench_frame_2d"), ("frame3d", "bench_frame_3d"), ("frame5", "bench_frame_5"),
                     ("sponza", "bench_frame_sponza")):
        monkeypatch.setattr(bench, fn, lambda device=None, _r=RATES[name]: {"rate": _r})
        assert bench.CELLS[name]() == want[name], name


def _jax_defaults(name: str) -> dict:
    src = open(os.path.join(ROOT, "bench.py")).read()
    fn = next(n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef) and n.name == name)
    args = fn.args.args[len(fn.args.args) - len(fn.args.defaults):]
    return {a.arg: ast.literal_eval(d) for a, d in zip(args, fn.args.defaults)}


def _defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items() if p.default is not inspect._empty}


def test_window_lengths_and_scene_arguments_match_the_jax_bench():
    for port, jax_name in ((bench.bench_frame_2d, "bench_frame_2d"), (bench.bench_frame_3d, "bench_frame_3d"),
                           (bench.bench_frame_5, "bench_frame_5"), (bench.bench_frame_sponza, "bench_frame_sponza")):
        got, want = _defaults(port), _jax_defaults(jax_name)
        for k in ("width", "height", "frames", "n_objects", "n_boxes"):
            if k in want:
                assert got[k] == want[k], (jax_name, k)
    sprite = _jax_defaults("_make_sprite_scene")
    f2 = _defaults(frame2d.build_frame2d_scene)
    assert (f2["n_sprites"], f2["n_emitters"]) == (sprite["n_sprites"], sprite["n_particles"])
    assert _defaults(frame3d.build_frame3d_scene)["n_objects"] == _jax_defaults("_build_frame3d_runner")["n_objects"]
    f5, j5 = _defaults(frame5.build_frame5_scene), _jax_defaults("_build_frame5_runner")
    assert (f5["n_objects"], f5["n_boxes"]) == (j5["n_objects"], j5["n_boxes"])
    src = open(os.path.join(ROOT, "bench.py")).read()
    assert '"physics", "physics10k", "frame2d", "frame3d", "sponza", "frame5"' in src
    assert list(bench.CELLS) == ["physics", "physics10k", "frame2d", "frame3d", "sponza", "frame5"]


def _stub_cells(monkeypatch, fail=None):
    cells = {}
    for i, name in enumerate(bench.CELLS):
        def cell(_n=name, _v=0.5 + i):
            if _n == fail:
                raise RuntimeError("bench gate failed: stub")
            return {"metric": _n, "value": _v, "unit": "-", "vs_baseline": _v}
        cells[name] = cell
    monkeypatch.setattr(bench, "CELLS", cells)


def test_default_run_prints_the_weakest_cell_with_the_suite(monkeypatch, capsys):
    _stub_cells(monkeypatch)
    assert bench.main([]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    last = json.loads(lines[0])
    assert last["metric"] == "physics" and last["value"] == 0.5
    assert list(last["suite"]) == list(bench.CELLS)
    assert [json.loads(ln)["metric"] for ln in err.strip().splitlines()] == list(bench.CELLS)
    assert bench.main(["frame3d"]) == 0
    assert json.loads(capsys.readouterr()[0])["metric"] == "frame3d"
    assert bench.main(["nope"]) == 2


def test_a_failed_cell_makes_main_return_nonzero(monkeypatch, capsys):
    _stub_cells(monkeypatch, fail="sponza")
    assert bench.main([]) == 1
    last = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert last["value"] == 0.0 and "FAILED" in last["metric"] and last["suite"]["sponza"]["value"] == 0.0
    with pytest.raises(RuntimeError, match="stub"):
        bench.main(["sponza"])


def test_frame2d_cell_runs_on_the_cpu(capsys):
    r = bench.bench_frame_2d(64, 36, frames=1, device="cpu")
    assert r["rate"] > 0 and r["tile_pairs"] > 0 and 0 <= r["tile_dropped"] <= r["tile_pairs"]
    assert "frame2d binning at K=64" in capsys.readouterr()[1]


def test_frame5_drop_share():
    t = lambda v: torch.tensor(v)
    st = bench._read_stats([{"bin_overflow": t(3), "bin_pairs": t(97), "expand_overflow": t(0)},
                            {"bin_overflow": t(0), "bin_pairs": t(50), "expand_overflow": t(0)}],
                           ("bin_overflow", "bin_pairs", "expand_overflow"))
    assert st[0] == {"bin_overflow": 3, "bin_pairs": 97, "expand_overflow": 0}
    assert bench._drop_share(st[0]) == 0.03 and bench._drop_share(st[1]) == 0.0
    assert bench.BIN_DROP_GATE == 0.05


def test_binning_stats_only_on_request():
    """A runner counts its binned pairs only with `binning_stats`, as the
    bench's frame2d and frame5 cells ask; other frames skip the sums."""
    from oxylus_tpu_torch.runtime import SceneRunner

    scene, kw = frame2d.build_frame2d_scene(64, 36, device="cpu")
    plain, counted = SceneRunner(scene, **kw), SceneRunner(scene, binning_stats=True, **kw)
    plain.step()
    counted.step()
    assert plain.frame_stats == {}
    assert set(counted.frame_stats) == {"tile_dropped", "tile_pairs"} and int(counted.frame_stats["tile_pairs"]) > 0
