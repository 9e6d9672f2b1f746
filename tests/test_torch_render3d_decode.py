"""The port's decode path (`RenderSpec(use_pallas=False)`) on the golden scene
(`tests/test_golden_images.py::_world`), the path the stored goldens were made
on.

- All five goldens (`flat`, `sky`, `shadows`, `full`, `sky65`), rendered by
  the port at the goldens' own size, settings and 1024² shadow maps: PSNR ≥
  40 dB against each (`test_golden_images.py:96`'s bound). On `sky`,
  `shadows` and `full` the decode path also comes closer to the golden than
  the port's tile route does on the same frame (both figures in the failure
  message; `tests/test_torch_render3d_golden.py` holds the tile route at
  42.71 dB there, at 256² maps).
- `flat` and `full` against the JAX decode path, with the JAX package's
  device branches as `tests/test_torch_render3d.py` runs them (HiZ through
  `build_hiz_pallas` in interpret mode, the shadow raster through
  `rasterize_pallas` in interpret mode, the port's sky LUTs in the JAX
  cache, `lax.cond` / `lax.switch` as Python branches), both packages'
  shadow maps at 256² with 4 pages a side (`_small_shadow_maps` of that
  module, here held for that one comparison only, since the golden renders
  above need the goldens' 1024² maps): PSNR ≥ 60 dB. The JAX frame runs
  under one `jax.jit`, as the JAX runner runs its frames (op by op it takes
  twice as long here and gives the same to 60 dB).
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oxylus_tpu.render.shadows as jshadows
from oxylus_tpu.ops.raster3d import rasterize_pallas
from oxylus_tpu.render.sky import AtmosphereParams as JAtmosphere
from oxylus_tpu_torch import bridge, frame5
from oxylus_tpu_torch.render import shadows as tshadows
from oxylus_tpu_torch.render.renderer3d import RenderSpec, RendererInstance
from tests.test_golden_images import DATA, H, W, _world
from tests.test_torch_render3d import SHADOW_MAP, SHADOW_PAGES, _camera, _jax_sky_luts, jax_device_paths
from tests.test_torch_render3d_golden import _psnr_u8, _to_u8
from tests.test_torch_shadows import host_branches

torch.set_num_threads(1)

GOLDEN_MIN, JAX_MIN = 40.0, 60.0
SETTINGS = {
    "flat": dict(),
    "sky": dict(atmosphere=True),
    "shadows": dict(atmosphere=True, enable_shadows=True),
    "full": dict(atmosphere=True, enable_shadows=True, config=dict(ssr_enable=True)),
    "sky65": dict(atmosphere=True, fov_deg=65.0),
}
CLOSER_THAN_TILE = ("sky", "shadows", "full")


@contextlib.contextmanager
def small_shadow_maps():
    """`tests/test_torch_render3d.py::_small_shadow_maps` as a block: both
    packages' shadow maps at 256² with 4 pages a side, and the JAX module's
    CPU raster through the interpret-mode kernel."""
    saved = [(m, k, getattr(m, k)) for m in (jshadows, tshadows) for k in ("SHADOW_MAP_SIZE", "PAGES")]
    saved.append((jshadows, "rasterize_reference", jshadows.rasterize_reference))
    for m in (jshadows, tshadows):
        m.SHADOW_MAP_SIZE, m.PAGES = SHADOW_MAP, SHADOW_PAGES
    jshadows.rasterize_reference = functools.partial(rasterize_pallas, interpret=True)
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


def _port_inputs(fov_deg: float = 60.0):
    state, gscene, cam = _world(fov_deg)
    from oxylus_tpu.assets.material import empty_gpu_materials

    return (bridge.scene_state_from_numpy(jax.device_get(state)), bridge.gpu_scene_from_numpy(jax.device_get(gscene)),
            _camera(jax.device_get(cam)), bridge.gpu_materials_from_numpy(jax.device_get(empty_gpu_materials(8))))


@functools.lru_cache(maxsize=None)
def _renderer(use_pallas: bool) -> RendererInstance:
    """One renderer per path, so the sky LUTs are built once."""
    return RendererInstance(RenderSpec(width=W, height=H, max_visible_meshlets=64, use_pallas=use_pallas))


def _port_render(name: str, use_pallas: bool) -> np.ndarray:
    kw = dict(SETTINGS[name])
    st, gs, cam, mats = _port_inputs(kw.pop("fov_deg", 60.0))
    cfg = dataclasses.replace(frame5.RendererConfig(), **kw.pop("config", {}))
    atm = bridge.atmosphere_from_jax(JAtmosphere()) if kw.pop("atmosphere", False) else None
    img = _renderer(use_pallas).render(st, gs, cam, mats, torch.zeros((8, 8, 4), dtype=torch.uint8), cfg,
                                       atmosphere=atm, **kw)["final"]
    return _to_u8(img.numpy())


@pytest.fixture(scope="module")
def golden_renders():
    """Each golden's frame by the port's decode path and its tile route, at
    the goldens' 1024² shadow maps."""
    assert tshadows.SHADOW_MAP_SIZE == 1024
    return {name: dict(decode=_port_render(name, False), tile=_port_render(name, True) if name in CLOSER_THAN_TILE
                       else None, golden=np.load(DATA / f"golden_{name}.npy")) for name in SETTINGS}


def test_decode_path_meets_the_goldens(golden_renders):
    """Every golden is checked and every figure is in the failure message,
    so one failing golden hides none of the others. One test for the five:
    xdist's `loadfile` queue takes the files with the most tests first, and
    this file's minute of renders runs best after the suite's long JAX files
    have started, not before them."""
    failures, figures = [], []
    for name, r in golden_renders.items():
        p_decode = _psnr_u8(r["decode"], r["golden"])
        figures.append(f"{name}: decode path {p_decode:.2f} dB")
        if p_decode < GOLDEN_MIN:
            failures.append(f"{name} below {GOLDEN_MIN} dB")
        if r["tile"] is not None:
            p_tile = _psnr_u8(r["tile"], r["golden"])
            figures[-1] += f", tile route {p_tile:.2f} dB"
            if p_decode <= p_tile:
                failures.append(f"{name} not closer than the tile route")
    assert not failures, f"{failures}; {'; '.join(figures)}"


@pytest.fixture(scope="module")
def jax_decode_renders():
    """`flat` and `full` by the JAX decode path with its device branches and by
    the port's, both at 256² shadow maps."""
    from oxylus_tpu.assets.material import empty_gpu_materials
    from oxylus_tpu.core.config import RendererConfig as JConfig
    from oxylus_tpu.render.renderer3d import RendererInstance as JRenderer
    from oxylus_tpu.render.renderer3d import RenderSpec as JSpec

    state, gscene, cam = _world()
    out = {}
    with small_shadow_maps(), jax_device_paths(), host_branches():
        for name in ("flat", "full"):
            kw = dict(SETTINGS[name])
            cfg_kw = kw.pop("config", {})
            jkw = dict(atmosphere=JAtmosphere() if kw.pop("atmosphere", False) else None, **kw)
            jr = JRenderer(JSpec(width=W, height=H, max_visible_meshlets=64, use_pallas=False))
            _jax_sky_luts(jr)
            cfg = dataclasses.replace(JConfig(), **cfg_kw)
            frame = jax.jit(lambda st, gs, c, m, a, jr=jr, cfg=cfg, jkw=jkw: jr.render(st, gs, c, m, a, cfg, **jkw)["final"])
            jimg = frame(state, gscene, cam, empty_gpu_materials(8), jnp.zeros((8, 8, 4), jnp.uint8))
            out[name] = dict(jax=_to_u8(jax.device_get(jimg)), port=_port_render(name, False))
    return out


def test_decode_path_matches_the_jax_decode_path(jax_decode_renders):
    """`flat` and `full`, both figures in the failure message."""
    psnrs = {name: round(_psnr_u8(r["port"], r["jax"]), 2) for name, r in jax_decode_renders.items()}
    assert set(psnrs) == {"flat", "full"} and min(psnrs.values()) >= JAX_MIN, f"port vs JAX decode path: {psnrs}"
