"""The port's shadows (`render/shadows.py`) against the JAX package's.

Both modules run with their shadow map shrunk to 256² (`SHADOW_MAP_SIZE = 256`,
`PAGES = 4`, set on both modules for this file only), and the JAX module's
CPU raster `rasterize_reference` is replaced, for this file only, by the TPU
kernel `rasterize_pallas` in interpret mode: the port's depth raster mirrors
the kernel. The JAX module's `lax.switch` over each level's branch runs as a
Python branch on the concrete index (`host_branches`), as the port takes it
on the host; the branch taken is the same.

Bounds: clipmap matrices within 1e-6 (4×4 products in another order); page
marks, the resolved shadow factor, contact shadows and the cached maps of the
three cases of `tests/test_shadow_pages.py` (first frame, static second frame,
moved instance) exactly equal.

The small tier's known defect (ROADMAP C) is reproduced and named:
`test_small_tier_drops_casters_past_768_meshlets`.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oxylus_tpu.render.shadows as js
from oxylus_tpu.assets.bake import bake_mesh
from oxylus_tpu.ops.raster3d import rasterize_pallas
from oxylus_tpu.render.camera import camera_matrices
from oxylus_tpu.render.scene3d import upload_meshes
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.render import shadows as ts
from tests.test_render3d import cube_mesh

torch.set_num_threads(1)

MAP, PAGES = 256, 4


@contextlib.contextmanager
def host_branches():
    """`jax.lax.cond` / `jax.lax.switch` on a concrete predicate or index run
    the chosen branch in Python (inside a trace they stay as they are)."""
    orig_cond, orig_switch = jax.lax.cond, jax.lax.switch

    def cond(pred, true_fun, false_fun, *ops):
        if isinstance(pred, jax.core.Tracer):
            return orig_cond(pred, true_fun, false_fun, *ops)
        return true_fun(*ops) if bool(pred) else false_fun(*ops)

    def switch(index, branches, *ops):
        if isinstance(index, jax.core.Tracer):
            return orig_switch(index, branches, *ops)
        return branches[int(index)](*ops)

    jax.lax.cond, jax.lax.switch = cond, switch
    try:
        yield
    finally:
        jax.lax.cond, jax.lax.switch = orig_cond, orig_switch


def kernel_jitted(fn):
    """Run `fn` with jit enabled (the interpret-mode kernels stay compiled)."""
    @functools.wraps(fn)
    def run(*a, **k):
        with jax.disable_jit(False):
            return fn(*a, **k)
    return run


@contextlib.contextmanager
def small_shadow_maps():
    """Both packages' maps at MAP² with PAGES pages a side, and the JAX
    module's raster through the interpret-mode kernel."""
    saved = [(m, k, getattr(m, k)) for m in (js, ts) for k in ("SHADOW_MAP_SIZE", "PAGES")]
    saved.append((js, "rasterize_reference", js.rasterize_reference))
    for m in (js, ts):
        m.SHADOW_MAP_SIZE, m.PAGES = MAP, PAGES
    js.rasterize_reference = kernel_jitted(functools.partial(rasterize_pallas, interpret=True))
    try:
        yield
    finally:
        for m, k, v in saved:
            setattr(m, k, v)


@pytest.fixture(scope="module", autouse=True)
def _maps():
    with small_shadow_maps():
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _sun():
    sun = jnp.array([0.3, -0.8, 0.2])
    return sun / jnp.linalg.norm(sun)


def _pages_scene():
    """`tests/test_shadow_pages.py::_scene`."""
    gscene = upload_meshes([bake_mesh(*cube_mesh())], [(0, 0, 0), (0, 1, 0)], max_instances=2)
    world = jnp.stack([jnp.eye(4), jnp.eye(4).at[0, 3].set(3.0)])
    return gscene, world, js.clipmap_matrices(_sun(), jnp.zeros(3), first_width=10.0)


def test_clipmap_matrices_match_jax():
    for sun, focus in ((_sun(), jnp.zeros(3)), (jnp.array([0.0, -1.0, 0.0]), jnp.array([1.3, 0.2, -7.9]))):
        want = np.asarray(js.clipmap_matrices(sun, focus, first_width=10.0))
        got = ts.clipmap_matrices(_t(sun), _t(focus), first_width=10.0).numpy()
        assert got.shape == (ts.NUM_CLIPMAPS, 4, 4)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _screen(seed=0, h=36, w=64):
    rng = np.random.default_rng(seed)
    wp = np.concatenate([rng.uniform(-40, 40, (h, w, 1)), rng.uniform(-1, 2, (h, w, 1)),
                         rng.uniform(-40, 40, (h, w, 1))], -1).astype(np.float32)
    wp[: h // 2, : w // 2] *= 0.05  # a dense patch near the focus
    return wp, rng.uniform(size=(h, w)) < 0.85


def test_mark_visible_pages_matches_jax():
    _, _, vps = _pages_scene()
    rng = np.random.default_rng(3)
    wp = rng.uniform((1.0, -1.0, 2.0), (4.0, 1.0, 4.0), (36, 64, 3)).astype(np.float32)
    wp[:4] += np.array([26.0, 0.0, 0.0], np.float32)  # a few rows far out, seen by the coarse levels only
    hit = rng.uniform(size=(36, 64)) < 0.85
    want = np.asarray(js.mark_visible_pages(jnp.asarray(wp), jnp.asarray(hit), vps))
    got = ts.mark_visible_pages(_t(wp), _t(hit), _t(vps)).numpy()
    assert got.shape == (ts.NUM_CLIPMAPS, PAGES * PAGES)
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


def _cached_runs(gscene, world, vps, worlds):
    """Both packages' cached clipmaps over `worlds` (a frame each, carry fed
    back). Returns [(jax maps, port maps, jax carry, port carry)]."""
    gs_t = bridge.gpu_scene_from_numpy(jax.device_get(gscene))
    out, jc, tc = [], None, None
    for wd in worlds:
        with host_branches():
            jm, jc = js.render_shadow_clipmaps_cached(gscene, jnp.asarray(wd), vps, jc)
        tm, tc = ts.render_shadow_clipmaps_cached(gs_t, _t(wd), _t(vps), tc)
        out.append((np.asarray(jm), tm.numpy(), jax.device_get(jc), tc))
    return out


@pytest.fixture(scope="module")
def pages_runs():
    """The three cases of `tests/test_shadow_pages.py` in one run: a first
    frame, two static frames, then the second cube moved."""
    gscene, world, vps = _pages_scene()
    moved = world.at[1, 0, 3].set(-3.0)
    return gscene, moved, vps, _cached_runs(gscene, world, vps, [world, world, world, moved])


def test_cached_first_and_static_frames_match_jax(pages_runs):
    runs = pages_runs[3][:3]
    for jm, tm, jc, tc in runs:
        np.testing.assert_array_equal(tm, jm)
        for k in ("dyn_pages", "resident"):
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    assert runs[0][0].max() > 0  # the cubes wrote depth
    assert not runs[1][3]["dyn_pages"].any()  # nothing moved: no dynamic page after the second frame


def test_cached_moved_instance_matches_jax(pages_runs):
    gscene, moved, vps, runs = pages_runs
    jm, tm, _, tc = runs[-1]
    np.testing.assert_array_equal(tm, jm)
    assert tc["dyn_pages"].any()
    oracle = ts.render_shadow_clipmaps(bridge.gpu_scene_from_numpy(jax.device_get(gscene)), _t(moved), _t(vps))
    assert (np.abs(tm - oracle.numpy()) > 1e-4).mean() <= 1e-4  # the moved cube's old shadow is gone


def test_resolve_shadows_matches_jax():
    gscene, world, vps = _pages_scene()
    maps = js.render_shadow_clipmaps(gscene, world, vps)
    wp, hit = _screen(1)
    wp[..., 1] = np.where(np.arange(wp.shape[1]) % 2 == 0, -0.5, wp[..., 1])  # ground points under the cubes
    want = np.asarray(js.resolve_shadows(jnp.asarray(wp), jnp.asarray(hit), vps, maps))
    got = ts.resolve_shadows(_t(wp), _t(hit), _t(vps), _t(maps)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.min() < 1.0 and want.max() == 1.0


def test_contact_shadows_matches_jax():
    h, w = 30, 48
    cam = camera_matrices(
        position=jnp.array([0.0, 2.0, 6.0]), yaw=jnp.float32(-np.pi / 2), pitch=jnp.float32(-0.3),
        tilt=jnp.float32(0.0), fov_deg=jnp.float32(60.0), near=jnp.float32(0.1), far=jnp.float32(100.0),
        zoom=jnp.float32(1.0), projection_kind=jnp.int32(0), aspect=jnp.float32(w / h),
    )
    rng = np.random.default_rng(2)
    xs, zs = np.meshgrid(np.linspace(-3, 3, w), np.linspace(-4, 2, h))
    wp = np.stack([xs, rng.uniform(0, 0.3, (h, w)), zs], -1).astype(np.float32)
    vp = np.asarray(cam.view_projection)
    clip = wp @ vp[:3, :3].T + vp[:3, 3]
    wc = wp @ vp[3, :3] + vp[3, 3]
    depth = (clip[..., 2] / wc + rng.uniform(0, 0.02, (h, w))).astype(np.float32)
    hit = rng.uniform(size=(h, w)) < 0.9
    sun = np.array([0.2, -0.5, -0.8], np.float32)
    sun /= np.linalg.norm(sun)
    kw = dict(steps=8, thickness=0.1, length=0.5)
    want = np.asarray(js.contact_shadows(jnp.asarray(depth), jnp.asarray(wp), jnp.asarray(hit), jnp.asarray(sun),
                                         jnp.asarray(vp), **kw))
    got = ts.contact_shadows(_t(depth), _t(wp), _t(hit), _t(sun), _t(vp), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.0 < want.mean() < 1.0


def test_small_tier_drops_casters_past_768_meshlets():
    """ROADMAP C, high: the small tier expands every valid instance at
    `dyn_capacity = 768` before its crop cull. With 800 one-meshlet cubes, a
    move of the last cube alone takes the small tier, whose expansion stops at
    the 768th meshlet: the moved cube casts no shadow in its dirty pages. The
    port reproduces this (equal to the JAX package) and does not fix it."""
    n = 800
    rng = np.random.default_rng(4)
    gscene = upload_meshes([bake_mesh(*cube_mesh())], [(0, i, 0) for i in range(n)], max_instances=n)
    world = np.broadcast_to(np.eye(4, dtype=np.float32), (n, 4, 4)).copy()
    world[:, 0, 3] = rng.uniform(-60, 60, n)
    world[:, 2, 3] = rng.uniform(-60, 60, n)
    world[:, 1, 3] = -5.0
    world[n - 1, :3, 3] = (0.5, 0.0, 0.5)  # the last cube, near the focus
    sun = jnp.array([0.0, -1.0, 0.0])
    vps = js.clipmap_matrices(sun, jnp.zeros(3), first_width=10.0, num_clipmaps=2)  # the defect shows at level 0
    moved = world.copy()
    moved[n - 1, 0, 3] += 1.0
    runs = _cached_runs(gscene, world, vps, [world, world, moved])
    jm, tm, _, _ = runs[-1]
    np.testing.assert_array_equal(tm, jm)
    full = ts.render_shadow_clipmaps(bridge.gpu_scene_from_numpy(jax.device_get(gscene)), _t(moved), _t(vps)).numpy()
    # level 0 (10 m wide): the moved cube's footprint is in the full render and missing from the small tier's
    missing = (full[0] > 0) & (tm[0] == 0)
    assert missing.sum() > 100
