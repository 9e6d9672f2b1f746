"""The golden scene (`tests/test_golden_images.py::_world`) with the `sky`,
`shadows` and `full` settings, rendered by the port against the JAX renderer
on the same tile path (its G-buffer kernel, HiZ and shadow raster in
interpret mode, both packages' shadow maps at 256², as in
`tests/test_torch_render3d.py`) and against the stored goldens (made by the
JAX decode path, `use_pallas=False`, at 1024² shadow maps). Bound: PSNR ≥ 40
dB, the goldens' bound (`test_golden_images.py:96`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.render.sky import AtmosphereParams as JAtmosphere
from oxylus_tpu_torch import bridge, frame5
from oxylus_tpu_torch.render.renderer3d import RendererInstance
from tests.test_torch_render3d import (  # noqa: F401 (the module-scoped shadow-map fixture)
    H, PSNR_MIN, W, _camera, _jax_sky_luts, _port_spec, _small_shadow_maps, jax_device_paths,
)
from tests.test_torch_shadows import host_branches

torch.set_num_threads(1)


GOLDEN_SETTINGS = {
    "sky": dict(atmosphere=True),
    "shadows": dict(atmosphere=True, enable_shadows=True),
    "full": dict(atmosphere=True, enable_shadows=True, config=dict(ssr_enable=True)),
}


def _to_u8(img) -> np.ndarray:
    """`tests/test_golden_images.py::_render`'s quantisation."""
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def golden_renders():
    """The golden scene rendered by the JAX renderer on the tile path (the G-buffer
    kernel in interpret mode) and by the port, with each golden's settings."""
    from oxylus_tpu.assets.material import empty_gpu_materials
    from oxylus_tpu.core.config import RendererConfig as JConfig
    from oxylus_tpu.render.renderer3d import RendererInstance as JRenderer
    from oxylus_tpu.render.renderer3d import RenderSpec as JSpec
    from tests.test_golden_images import DATA, _world

    state, gscene, cam = _world()
    jspec = JSpec(width=W, height=H, max_visible_meshlets=64, gbuffer_interpret=True)
    mats = empty_gpu_materials(8)
    st_t, gs_t = bridge.scene_state_from_numpy(jax.device_get(state)), bridge.gpu_scene_from_numpy(jax.device_get(gscene))
    mats_t, cam_t = bridge.gpu_materials_from_numpy(jax.device_get(mats)), _camera(cam)
    out = {}
    with jax_device_paths(), host_branches():
        for name, kw in GOLDEN_SETTINGS.items():
            cfg_kw = kw.get("config", {})
            jkw = dict(atmosphere=JAtmosphere() if kw.get("atmosphere") else None,
                       enable_shadows=kw.get("enable_shadows", False))
            jrenderer = JRenderer(jspec)
            _jax_sky_luts(jrenderer)
            jimg = jrenderer.render(state, gscene, cam, mats, jnp.zeros((8, 8, 4), jnp.uint8),
                                           dataclasses.replace(JConfig(), **cfg_kw), **jkw)["final"]
            tkw = dict(jkw, atmosphere=bridge.atmosphere_from_jax(JAtmosphere()) if kw.get("atmosphere") else None)
            timg = RendererInstance(_port_spec(jspec)).render(
                st_t, gs_t, cam_t, mats_t, torch.zeros((8, 8, 4), dtype=torch.uint8),
                dataclasses.replace(frame5.RendererConfig(), **cfg_kw), **tkw)["final"]
            out[name] = dict(jax=_to_u8(jimg), port=_to_u8(timg.numpy()), golden=np.load(DATA / f"golden_{name}.npy"))
    return out


def _psnr_u8(a, b) -> float:
    """`tests/test_golden_images.py::psnr`."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 20.0 * np.log10(255.0) - 10.0 * np.log10(mse)


@pytest.mark.parametrize("name", list(GOLDEN_SETTINGS))
def test_golden_scene_matches_jax_tile_path(golden_renders, name):
    """The port against the JAX renderer on the same (tile) path: ≥ 40 dB.
    Against the stored golden, made by the JAX decode path with 1024² shadow
    maps: ≥ 40 dB (the goldens' bound), and as close as the JAX tile path at
    this module's 256² maps is (within 0.5 dB). All three PSNRs are in the
    failure message."""
    r = golden_renders[name]
    p_jax, p_port_golden, p_jax_golden = (_psnr_u8(r["port"], r["jax"]), _psnr_u8(r["port"], r["golden"]),
                                          _psnr_u8(r["jax"], r["golden"]))
    msg = f"{name}: port vs JAX tile path {p_jax:.2f} dB, port vs golden {p_port_golden:.2f}, JAX tile vs golden {p_jax_golden:.2f}"
    assert p_jax >= PSNR_MIN, msg
    assert p_port_golden >= PSNR_MIN and p_port_golden >= p_jax_golden - 0.5, msg
