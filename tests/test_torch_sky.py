"""The port's sky (`render/sky.py`) against the JAX package's, with the LUT
step counts reduced as `tests/test_sky_shadows_ao.py` reduces them.

Each function takes the same inputs in both packages (the downstream ones
the JAX package's LUTs, carried across as NumPy), so a difference is that
function's own. XLA's exp and sqrt round differently from PyTorch's, the
marches accumulate a few dozen steps of them, and a LUT texel whose
nearest-texel lookup of another LUT lands on a cell boundary can take the
neighbour. The sky-view LUT is held against the JAX function run op by op
(`jax.disable_jit()`): its jitted run sits up to 1.8e-3 relative from its
own op-by-op run (99th percentile 7.8e-4), further than the port is. The
bounds: relative error ≤ 1e-4 on 99 % of the texels of a LUT and ≤ 5e-3 on
all of them; ≤ 1e-5 relative on the samplers, the SH terms and the aerial
apply; exact on the nearest-texel sky sampler.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.render import sky as js
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.render import sky as ts

torch.set_num_threads(1)

P99_LUT, WORST_LUT = 1e-4, 5e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _close_lut(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-12)
    assert np.quantile(rel, 0.99) <= P99_LUT and rel.max() <= WORST_LUT, (np.quantile(rel, 0.99), rel.max())


@pytest.fixture(scope="module")
def luts():
    p = js.AtmosphereParams()
    t = js.transmittance_lut(p, steps=20)
    ms = js.multiscatter_lut(p, t, steps=8)
    sun = jnp.array([0.2, 0.6, -0.75])
    sun = sun / jnp.linalg.norm(sun)
    # op by op: under jit XLA's fused exp/sqrt move this LUT by up to 1.8e-3
    # relative from its own op-by-op run (q99 7.8e-4), more than from the port's
    with jax.disable_jit():
        view = js.sky_view_lut(p, t, ms, sun, steps=16)
    return p, t, ms, sun, view


def test_atmosphere_params_carry_over():
    comp = dict(rayleigh_scattering=[5.0, 13.0, 33.0], rayleigh_density=7.5, mie_scattering=[4.0, 4.0, 4.0],
                mie_density=1.1, mie_extinction=4.2, mie_asymmetry=3.6, ozone_absorption=[0.6, 1.8, 0.08],
                ozone_height=24.0, ozone_thickness=14.0)
    for jp in (js.AtmosphereParams(), js.AtmosphereParams.from_component(comp)):
        tp = bridge.atmosphere_from_jax(jp)
        assert dataclasses.asdict(tp) == pytest.approx(dataclasses.asdict(jp))
        assert tp == bridge.atmosphere_from_jax(dataclasses.asdict(jp))
    assert ts.AtmosphereParams.from_component(comp) == bridge.atmosphere_from_jax(js.AtmosphereParams.from_component(comp))
    assert hash(ts.AtmosphereParams()) == hash(ts.AtmosphereParams())  # keys the renderer's LUT cache
    with pytest.raises(dataclasses.FrozenInstanceError):
        ts.AtmosphereParams().mie_density = 1.0


def test_transmittance_and_multiscatter_luts_match_jax(luts):
    p, t, ms, _, _ = luts
    tp = bridge.atmosphere_from_jax(p)
    t_port = ts.transmittance_lut(tp, steps=20)
    assert t_port.shape == (64, 256, 3)
    _close_lut(t_port, t)
    _close_lut(ts.multiscatter_lut(tp, _t(t), steps=8), ms)


def test_sky_view_lut_and_samplers_match_jax(luts):
    p, t, ms, sun, view = luts
    tp = bridge.atmosphere_from_jax(p)
    got = ts.sky_view_lut(tp, _t(t), _t(ms), _t(sun), steps=16)
    assert got.shape == (192, 312, 3)
    _close_lut(got, view)
    dirs = np.random.default_rng(0).normal(size=(20, 30, 3)).astype(np.float32)
    np.testing.assert_array_equal(ts.sample_sky_view(_t(view), _t(dirs)).numpy(),
                                  np.asarray(js.sample_sky_view(view, jnp.asarray(dirs))))
    _close(ts.sky_ambient(_t(view)), js.sky_ambient(view), rtol=1e-5)
    sh = js.sky_sh_ambient(view)
    _close(ts.sky_sh_ambient(_t(view)), sh, rtol=1e-5, atol=1e-7)
    nrm = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    _close(ts.eval_sh_ambient(_t(sh), _t(nrm)), js.eval_sh_ambient(sh, jnp.asarray(nrm)), rtol=1e-5, atol=1e-7)


def test_aerial_lut_and_apply_match_jax(luts):
    p, t, ms, sun, _ = luts
    tp = bridge.atmosphere_from_jax(p)
    cam_h = jnp.float32(0.16)
    want = js.aerial_lut(p, t, ms, cam_h, sun, sun_intensity=jnp.float32(10.0))
    got = ts.aerial_lut(tp, _t(t), _t(ms), _t(cam_h), _t(sun), sun_intensity=torch.tensor([10.0]))
    assert got.shape == (16, 32, 16, 6)
    _close_lut(got, want)
    rng = np.random.default_rng(1)
    wp = rng.uniform(-150, 150, (24, 40, 3)).astype(np.float32)
    hit = rng.uniform(size=(24, 40)) < 0.8
    cam = np.array([0.0, 8.0, 30.0], np.float32)
    for g, w in zip(ts.apply_aerial_lut(_t(want), _t(wp), _t(hit), _t(cam), meters_per_km=50.0),
                    js.apply_aerial_lut(want, jnp.asarray(wp), jnp.asarray(hit), jnp.asarray(cam), meters_per_km=50.0)):
        _close(g, w, rtol=1e-5, atol=1e-7)
