"""The last public helpers of the JAX package against their port, on seeded
inputs (one case each):

- `render/sky.py::aerial_perspective` on a 16×16 image of seeded positions
  and hits with seeded transmittance and multiple-scattering LUTs, the JAX
  function op by op (`jax.disable_jit()`, the repo's rule for the port):
  within 1e-6 relative;
- `utils/math3d.py`: `mat4_decompose` of seeded rotation-scale-translation
  matrices (within 1e-6), `aabb_union` (exact), `srgb_to_linear` and
  `linear_to_srgb` over [-0.1, 1.1] with the thresholds' neighbours (within
  1e-6 relative: `pow` may round an ulp apart);
- `utils/imgops.py::max_downsample` of float depth, a (H, W, C) image and a
  bool mask at k = 2 and 3 with ragged edges: exact;
- `physics/step.py::make_segment_reducer` on seeded segment ids (empty
  segments included) and values: within 1e-5 (the cumulative sums' order);
- `physics/megakernel_banded.py::morton_rank_key` with inactive and excluded
  bodies: exact;
- `assets/procgen.py::atrium_summary` of one generated GLB: equal;
- `assets/native.py::available`: equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu_torch import bridge

torch.set_num_threads(1)


def _aerial():
    from oxylus_tpu.render import sky as js
    from oxylus_tpu_torch.render import sky as ts

    rng = np.random.default_rng(11)
    trans = rng.uniform(0.2, 1.0, (64, 256, 3)).astype(np.float32)
    ms = rng.uniform(0.0, 0.05, (32, 32, 3)).astype(np.float32)
    pos = rng.uniform(-3000, 3000, (16, 16, 3)).astype(np.float32)
    hit = rng.random((16, 16)) < 0.8
    cam = np.array([10.0, 200.0, -30.0], np.float32)
    sun = np.array([0.3, 0.8, 0.2], np.float32)
    sun /= np.linalg.norm(sun)
    with jax.disable_jit():
        want = js.aerial_perspective(js.AtmosphereParams(), *(jnp.asarray(a) for a in (trans, ms, pos, hit, cam, sun)),
                                     start_km=0.5)
    got = ts.aerial_perspective(bridge.atmosphere_from_jax(js.AtmosphereParams()),
                                *(torch.from_numpy(a) for a in (trans, ms, pos, hit, cam, sun)), start_km=0.5)
    return got, want, 1e-6


def _decompose():
    from oxylus_tpu.utils import math3d as jm
    from oxylus_tpu_torch.utils import math3d as tm

    rng = np.random.default_rng(12)
    q = rng.normal(size=(8, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    m = np.array(jm.trs_to_mat4(jnp.asarray(rng.uniform(-5, 5, (8, 3)), jnp.float32), jnp.asarray(q),
                                  jnp.asarray(rng.uniform(0.2, 3.0, (8, 3)), jnp.float32)))
    return tm.mat4_decompose(torch.from_numpy(m)), jm.mat4_decompose(jnp.asarray(m)), 1e-6


def _aabb_union():
    from oxylus_tpu.utils import math3d as jm
    from oxylus_tpu_torch.utils import math3d as tm

    a = np.random.default_rng(13).normal(size=(4, 6, 3)).astype(np.float32)
    return tm.aabb_union(*map(torch.from_numpy, a)), jm.aabb_union(*map(jnp.asarray, a)), 0.0


def _srgb(name):
    from oxylus_tpu.utils import math3d as jm
    from oxylus_tpu_torch.utils import math3d as tm

    c = np.concatenate([np.linspace(-0.1, 1.1, 997), np.nextafter(np.float32([0.04045, 0.0031308]), 1),
                        np.float32([0.04045, 0.0031308])]).astype(np.float32)
    return getattr(tm, name)(torch.from_numpy(c)), getattr(jm, name)(jnp.asarray(c)), 1e-6


def _max_downsample():
    from oxylus_tpu.utils import imgops as ji
    from oxylus_tpu_torch.utils import imgops as ti

    rng = np.random.default_rng(14)
    imgs = [rng.random((31, 45)).astype(np.float32), rng.random((30, 20, 3)).astype(np.float32),
            rng.random((17, 22)) < 0.2]
    got = [ti.max_downsample(torch.from_numpy(x), k) for x in imgs for k in (1, 2, 3)]
    want = [ji.max_downsample(jnp.asarray(x), k) for x in imgs for k in (1, 2, 3)]
    return got, want, 0.0


def _segment_reducer():
    from oxylus_tpu.physics import step as jstep
    from oxylus_tpu_torch.physics import step as tstep

    rng = np.random.default_rng(15)
    idx = rng.integers(0, 12, 300).astype(np.int32)
    idx[idx == 5] = 6  # an empty segment
    vals = rng.normal(size=(300, 3)).astype(np.float32)
    got = tstep.make_segment_reducer(torch.from_numpy(idx), 14)(torch.from_numpy(vals))
    want = jstep.make_segment_reducer(jnp.asarray(idx), 14)(jnp.asarray(vals))
    return got, want, 1e-5


def _morton():
    from oxylus_tpu.physics import megakernel_banded as jb
    from oxylus_tpu_torch.physics import megakernel_banded as tb

    rng = np.random.default_rng(16)
    pos = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
    active = rng.random(64) < 0.8
    exclude = rng.random(64) < 0.1
    out = []
    for lib, arr in ((tb, torch.from_numpy), (jb, jnp.asarray)):
        ps = types.SimpleNamespace(pos=arr(pos), active=arr(active))
        out.append((lib.morton_rank_key(ps), lib.morton_rank_key(ps, arr(exclude))))
    return out[0], out[1], 0.0


def _atrium_summary(tmp_path):
    from oxylus_tpu.assets import procgen as jp
    from oxylus_tpu_torch.assets import procgen as tp

    path = tmp_path / "atrium.glb"
    tp.generate_atrium_glb(path, n_meshes=5, n_materials=4, seed=3)
    return tp.atrium_summary(path), jp.atrium_summary(path), None


def _native_available():
    from oxylus_tpu.assets import native as jn
    from oxylus_tpu_torch.assets import native as tn

    return tn.available(), jn.available(), None


CASES = {
    "aerial_perspective": lambda tmp: _aerial(),
    "mat4_decompose": lambda tmp: _decompose(),
    "aabb_union": lambda tmp: _aabb_union(),
    "srgb_to_linear": lambda tmp: _srgb("srgb_to_linear"),
    "linear_to_srgb": lambda tmp: _srgb("linear_to_srgb"),
    "max_downsample": lambda tmp: _max_downsample(),
    "make_segment_reducer": lambda tmp: _segment_reducer(),
    "morton_rank_key": lambda tmp: _morton(),
    "atrium_summary": _atrium_summary,
    "native_available": lambda tmp: _native_available(),
}


def _leaves(x) -> list:
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


@pytest.mark.parametrize("name", list(CASES))
def test_helper_matches_jax(name, tmp_path):
    got, want, tol = CASES[name](tmp_path)
    if tol is None:
        assert got == want
        return
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if tol == 0.0:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
