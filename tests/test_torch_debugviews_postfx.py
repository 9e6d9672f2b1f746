"""The port's debug views and last post effects against the JAX package's: every
debug-view mode exactly on a seeded renderer ctx (with and without the slot tables),
one small port frame on the CPU with `debug_view=8`, chromatic aberration and vignette
within 1e-6 under each tonemapper, and the film grain within 1e-6 given the JAX
package's noise field, with its own draw's range and period."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oxylus_tpu.render import debugviews as jdv
from oxylus_tpu.render import postfx as jpfx
from oxylus_tpu_torch.render import debugviews as tdv
from oxylus_tpu_torch.render import postfx as tpfx

torch.set_num_threads(1)

H, W = 40, 56
MODES = list(range(0, 15))


def _ctx(seed, with_slots, with_ao):
    rng = np.random.default_rng(seed)
    n_slots, group, n_inst = 10, 64, 7
    vid = ((rng.integers(0, n_slots, (H, W)) << 8) | rng.integers(0, group, (H, W))).astype(np.int32)
    vid[rng.uniform(size=(H, W)) < 0.25] = -1
    gb = {
        "hit": vid >= 0,
        "albedo": rng.uniform(0, 1, (H, W, 4)).astype(np.float32),
        "normal": rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
        "emissive": rng.uniform(0, 2, (H, W, 3)).astype(np.float32),
        "metallic": rng.uniform(0, 1, (H, W)).astype(np.float32),
        "roughness": rng.uniform(0, 1, (H, W)).astype(np.float32),
    }
    ctx = {
        "visbuffer": vid, "gbuffer": gb,
        "vm_instance": rng.integers(-1, n_inst, n_slots).astype(np.int32),
        "vm_meshlet": rng.integers(-1, 500, n_slots).astype(np.int32),
        "inst_material": rng.integers(0, 2**31 - 1, n_inst).astype(np.int32),
    }
    if with_slots:
        ctx["slot_instance"] = rng.integers(0, n_inst, n_slots * 32 - 3).astype(np.int32)
        ctx["slot_group"] = 32
    if with_ao:
        ctx["ao"] = rng.uniform(0, 1, (H, W)).astype(np.float32)
    return ctx


def _lift(ctx, conv):
    out = {}
    for k, v in ctx.items():
        if k == "gbuffer":
            out[k] = {g: conv(a) for g, a in v.items()}
        elif k == "inst_material":
            out["gscene"] = SimpleNamespace(inst_material=conv(v))
        elif isinstance(v, np.ndarray):
            out[k] = conv(v)
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("with_slots,with_ao", [(False, True), (True, False)])
def test_every_debug_view_matches_jax_exactly(with_slots, with_ao):
    ctx = _ctx(4, with_slots, with_ao)
    jctx, tctx = _lift(ctx, jnp.asarray), _lift(ctx, torch.from_numpy)
    n_images = 0
    for mode in MODES:
        want = jdv.apply_debug_view(mode, jctx)
        got = tdv.apply_debug_view(mode, tctx)
        assert (got is None) == (want is None), mode
        if want is None:
            continue
        want = np.asarray(want)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (H, W, 3), mode
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32), err_msg=f"mode {mode}")
        n_images += 1
    assert n_images == (11 if with_ao else 10)


def test_hash_color_equals_the_uint32_hash():
    ids = np.concatenate([np.arange(-3, 300), np.array([2**31 - 1, 2**24 + 7, 0x7FFF0000])]).astype(np.int32)
    want = np.asarray(jdv._hash_color(jnp.asarray(ids)))
    got = tdv._hash_color(torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_small_cpu_frame_with_debug_view_8_is_its_ctx_view():
    from oxylus_tpu_torch.frame5 import build_frame5_scene
    from oxylus_tpu_torch.render.renderer3d import RenderStage
    from oxylus_tpu_torch.runtime import SceneRunner

    scene, kw = build_frame5_scene(96, 64, n_objects=6, n_boxes=6, max_bodies=32, device="cpu")
    scene.renderer_config = dataclasses.replace(scene.renderer_config, debug_view=8, ssr_enable=False,
                                                vbgtao_enable=False)
    runner = SceneRunner(scene, **dict(kw, atmosphere=None, enable_shadows=False))
    seen = {}
    runner.renderer3d.add_stage_callback(RenderStage.FINAL_OUTPUT, "after", lambda c: seen.setdefault("ctx", c))
    image = runner.step()
    ctx = seen["ctx"]
    want = tdv.apply_debug_view(8, ctx)
    assert torch.equal(image, want) and torch.equal(ctx["final"], want)
    hit = ctx["gbuffer"]["hit"]
    assert 0 < int(hit.sum()) < hit.numel()
    assert torch.equal(image[~hit], torch.zeros_like(image[~hit]))


def _hdr(seed, h=H, w=W):
    return (np.random.default_rng(seed).uniform(0, 1, (h, w, 3)) ** 3 * 4).astype(np.float32)


@pytest.fixture
def jax_curves(monkeypatch):
    """The port's tonemap curves replaced by the JAX package's, so a comparison
    sees only exposure, the effects and gamma (the curves themselves are held
    apart, at 1e-5, by `test_torch_render3d.py::test_postfx_matches_jax`)."""
    curves = (lambda x: jnp.clip(x, 0.0, 1.0), jpfx.tonemap_aces, jpfx.tonemap_agx, jpfx.tonemap_gt7)
    # jitted, as `lax.switch` compiles its branches
    wrap = lambda f: (lambda c, f=jax.jit(f): torch.from_numpy(np.array(f(jnp.asarray(c.numpy())))))
    monkeypatch.setattr(tpfx, "_TONEMAPPERS", tuple(wrap(f) for f in curves))


@pytest.mark.parametrize("tonemapper", [0, 1, 2, 3])
@pytest.mark.parametrize("fx", [dict(chromatic_aberration=0.5), dict(vignette=0.4),
                                dict(chromatic_aberration=0.9, vignette=0.7)])
def test_aberration_and_vignette_within_1e6(jax_curves, tonemapper, fx):
    for h, w in ((H, W), (37, 53)):
        hdr = _hdr(tonemapper, h, w)
        want = np.asarray(jpfx.apply_tonemap(jnp.asarray(hdr), tonemapper=tonemapper, exposure=1.3, **fx))
        got = tpfx.apply_tonemap(torch.from_numpy(hdr), tonemapper=tonemapper, exposure=1.3, **fx).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        plain = tpfx.apply_tonemap(torch.from_numpy(hdr), tonemapper=tonemapper, exposure=1.3).numpy()
        assert np.abs(got - plain).max() > 1e-3  # the effect shows


def test_aberration_shift_is_exact():
    """Tonemapper 0 at gamma 1: the shifted channels are the JAX package's bits."""
    hdr = np.random.default_rng(2).uniform(0, 1, (H, W, 3)).astype(np.float32)
    want = np.asarray(jpfx.apply_tonemap(jnp.asarray(hdr), gamma=1.0, chromatic_aberration=0.9))
    got = tpfx.apply_tonemap(torch.from_numpy(hdr), gamma=1.0, chromatic_aberration=0.9).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("frame", [0, 5, 21])
@pytest.mark.parametrize("scale", [0.7, 0.33])
def test_film_grain_within_1e6_given_the_jax_field(jax_curves, monkeypatch, frame, scale):
    """The JAX package's noise field fed to the port's resize and blend: `jnp.resize`
    repeats the flattened (gh, gw, 1) draw cyclically, not as a 2-D tile."""
    hdr = _hdr(7)
    key = jax.random.fold_in(jax.random.PRNGKey(0x617), jnp.asarray(frame) % 16)
    gh, gw = max(int(H * scale), 1), max(int(W * scale), 1)
    raw = np.array(jax.random.uniform(key, (gh, gw, 1)) - 0.5)
    monkeypatch.setattr(tpfx, "_GRAIN_CACHE", {})
    monkeypatch.setattr(tpfx, "_grain_field", lambda a, b, k: torch.from_numpy(raw) if (a, b) == (gh, gw) else None)
    kw = dict(tonemapper=1, film_grain=0.3, film_grain_scale=scale, vignette=0.4, frame=frame)
    want = np.asarray(jpfx.apply_tonemap(jnp.asarray(hdr), **kw))
    got = tpfx.apply_tonemap(torch.from_numpy(hdr), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    tiled = np.tile(raw, (-(-H // gh), -(-W // gw), 1))[:H, :W]
    assert not np.array_equal(tpfx.grain_noise(H, W, frame, scale).numpy(), tiled)


def test_grain_draw_range_and_period(monkeypatch):
    monkeypatch.setattr(tpfx, "_GRAIN_CACHE", {})
    fields = {f: tpfx.grain_noise(H, W, f).numpy() for f in (0, 3, 4, 19, 35)}
    for f, n in fields.items():
        assert n.shape == (H, W, 1) and n.min() >= -0.5 and n.max() < 0.5 and abs(float(n.mean())) < 0.05, f
    assert np.array_equal(fields[3], fields[19]) and np.array_equal(fields[3], fields[35])
    assert not np.array_equal(fields[3], fields[4]) and not np.array_equal(fields[0], fields[4])
    # a tensor frame works as an int; the field is cached per (shape, frame % 16, device)
    assert tpfx.grain_noise(H, W, torch.tensor(19)) is tpfx.grain_noise(H, W, 3)
    assert len(tpfx._GRAIN_CACHE) == 3  # frames 0, 3 (and 19, 35), 4
    # the cycle: the (28, 39) draw's flat order continues across rows of the (40, 56) field
    raw = tpfx._grain_field(int(H * 0.7), int(W * 0.7), 3).reshape(-1)
    np.testing.assert_array_equal(fields[3].reshape(-1), np.resize(raw.numpy(), H * W))
    out = tpfx.apply_tonemap(torch.from_numpy(_hdr(1)), film_grain=1.0, frame=3).numpy()
    assert np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0
