"""The port's `core/modules.py` against the JAX package's: the default roster's order
and names, `Physics.new_params`, the `Renderer` module's material slots, table and
atlas bytes after `sync_materials` on a PNG and a KTX2 texture, and an `App` with the
default modules stepping a 64-entity scene bit for bit as the runner alone."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from oxylus_tpu.assets import manager as jman
from oxylus_tpu.core import modules as jmods
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.assets import manager as tman
from oxylus_tpu_torch.assets.texture import write_ktx2
from oxylus_tpu_torch.core import modules as tmods
from oxylus_tpu_torch.core.app import App

torch.set_num_threads(1)


def test_default_roster_order_and_names():
    want = [(type(m).__name__, m.MODULE_NAME) for m in jmods.default_modules()]
    got = [(type(m).__name__, m.MODULE_NAME) for m in tmods.default_modules(device="cpu")]
    assert got == want
    assert [n for n, _ in got] == ["ScriptManager", "AssetManager", "AudioEngine", "Physics", "Input",
                                   "NetworkManager", "Renderer", "DebugRenderer"]
    app = App().with_modules(*tmods.default_modules(device="cpu"))
    assert [type(m).__name__ for m in app.registry] == [n for n, _ in got]
    # the renderer needs the asset manager first, as in the reference registry
    with pytest.raises(RuntimeError, match="AssetManager"):
        App().with_modules(tmods.Renderer(device="cpu"))


def test_renderer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tmods.Renderer()
    with pytest.raises(RuntimeError):
        tmods.default_modules()


def test_physics_new_params_match_jax():
    jp, tp = jmods.Physics(), tmods.Physics()
    assert tp.MAX_BODIES == jp.MAX_BODIES and tp.MAX_BODY_PAIRS == jp.MAX_BODY_PAIRS
    assert tp.MAX_CONTACT_CONSTRAINTS == jp.MAX_CONTACT_CONSTRAINTS
    assert tp.new_params() is tp.params
    f32 = lambda p: {k: (np.float32(v).tolist() if isinstance(v, float) else
                         [np.float32(x).tolist() for x in v] if k == "gravity" else v)
                     for k, v in dataclasses.asdict(p).items()}
    for kw in ({}, {"gravity": (0.0, -3.0, 1.0), "max_pairs": 64}, {"baumgarte": 0.5}):
        want = bridge.physics_params_from_numpy(jax.device_get(jp.new_params(**kw)))
        assert f32(tp.new_params(**kw)) == f32(want), kw  # the JAX package keeps float32 scalars


def _assets(root, mod):
    """Import a PNG, a KTX2 texture (typed by its sidecar) and a material using
    both through `mod`'s AssetManager; load all three."""
    am = mod.AssetManager()
    uuids = {name: am.import_asset(root / name) for name in ("albedo.png", "normal.ktx2", "brick.oxmat")}
    for u in uuids.values():
        assert am.load_asset(u) is not None
    return am, uuids


def test_renderer_sync_materials_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    Image.fromarray(rng.integers(0, 256, (24, 40, 4), dtype=np.uint8)).save(tmp_path / "albedo.png")
    write_ktx2(tmp_path / "normal.ktx2", rng.integers(0, 256, (16, 16, 4), dtype=np.uint8), srgb=False)
    tex_uuid = "0000000a-0000-0000-0000-00000000000b"
    tman.AssetManager.meta_path(tmp_path / "normal.ktx2").write_text(json.dumps({"uuid": tex_uuid, "type": "Texture"}))
    png_uuid = tman.AssetManager().import_asset(tmp_path / "albedo.png")  # writes the sidecar both read
    from oxylus_tpu_torch.assets.material import Material

    mat = dict(Material().to_json(), albedo_color=[0.5, 0.25, 1.0, 1.0], roughness_factor=0.7,
               albedo_texture=png_uuid, normal_texture=tex_uuid, emissive_texture="missing")
    (tmp_path / "brick.oxmat").write_text("{}")
    tman.AssetManager.meta_path(tmp_path / "brick.oxmat").write_text(
        json.dumps({"uuid": "0000000c-0000-0000-0000-00000000000d", "type": "Material", "material": mat}))

    jam, juu = _assets(tmp_path, jman)
    tam, tuu = _assets(tmp_path, tman)
    assert juu == tuu
    jr, tr = jmods.Renderer(max_materials=8, atlas_size=128), tmods.Renderer(max_materials=8, atlas_size=128,
                                                                            device="cpu")
    jr.init()
    tr.init()
    assert tr.atlas_gpu.dtype == torch.uint8 and tuple(tr.atlas_gpu.shape) == (128, 128, 4)
    assert tr.materials_gpu.capacity == 8
    jr.sync_materials(jam)
    tr.sync_materials(tam)
    assert tr.material_slots == jr.material_slots == {tuu["brick.oxmat"]: 0}
    np.testing.assert_array_equal(tr.atlas_gpu.numpy(), np.asarray(jr.atlas_gpu))
    assert tr.atlas_gpu.numpy().any()
    want = bridge.gpu_materials_from_numpy(jax.device_get(jr.materials_gpu))
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(tr.materials_gpu, f.name).numpy(), getattr(want, f.name).numpy(),
                                      err_msg=f.name)
    assert tr._dirty is False
    # the module syncs from the App's asset manager when marked dirty
    app = App().with_modules(tam, tmods.Renderer(max_materials=8, atlas_size=128, device="cpu"))
    app.init()
    rmod = app.registry.get(tmods.Renderer)
    rmod.update(app)
    assert torch.equal(rmod.atlas_gpu, tr.atlas_gpu) and rmod._dirty is False


def _scene_and_kw():
    from oxylus_tpu_torch.frame5 import build_frame5_scene

    scene, kw = build_frame5_scene(64, 48, n_objects=21, n_boxes=40, max_bodies=64, device="cpu")
    assert int(scene._alive.sum()) == 64
    scene.renderer_config = dataclasses.replace(scene.renderer_config, ssr_enable=False, vbgtao_enable=False)
    return scene, dict(kw, atmosphere=None, enable_shadows=False)


def test_app_with_default_modules_steps_as_the_runner_alone():
    from oxylus_tpu_torch.runtime import SceneRunner

    frames = 10
    scene, kw = _scene_and_kw()
    alone = SceneRunner(scene, **kw)
    want = [alone.step().clone() for _ in range(frames)]

    scene, kw = _scene_and_kw()
    mods = tmods.default_modules(device="cpu")
    app = App().with_name("roster").with_modules(*mods)
    got, seen = [], {}

    def frame(app_, ts):
        if "runner" not in seen:
            seen["runner"] = SceneRunner(scene, **kw, physics_params=app_.registry.get(tmods.Physics).params,
                                         asset_manager=app_.registry.get(tman.AssetManager))
        got.append(seen["runner"].step().clone())
        return True

    app.run(frames=frames, frame_callback=frame)
    assert not app.is_running and len(got) == frames
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), f"frame {i}"
    runner = seen["runner"]
    for k in ("pos", "quat", "linvel", "angvel"):
        assert torch.equal(getattr(runner.ps, k), getattr(alone.ps, k)), k
    assert torch.equal(runner.state.world, alone.state.world)
    assert not torch.equal(want[0], want[-1])  # the boxes fell
    rmod = app.registry.get(tmods.Renderer)
    assert rmod.materials_gpu is None and rmod.atlas_gpu is None  # deinit ran
