"""The port's audio engine and the runner's audio hook against the JAX package's.

`render_block` is held within 1e-6 of the JAX engine for seeded sources (pan,
attenuation, cone, doppler, looping and not); a `render_mode="none"` runner on a
16-entity scene like `tests/test_audio_frame.py::_audio_scene` mixes the same
blocks (within 1e-5) over 30 frames of uneven dt, reads the same positions and
drives a counting script through the same lifecycle as the JAX runner. A named
test shows the reference's UUID quirk leaving a source unbound in both packages."""

import functools
import json
import wave

import numpy as np
import pytest
import torch

from oxylus_tpu.assets import manager as jman
from oxylus_tpu.audio import engine as jeng
from oxylus_tpu.core import uuid as juuid
from oxylus_tpu.runtime import SceneRunner as JRunner
from oxylus_tpu.scene import serialize as jser
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu.scene.state import SceneSpec as JSpec
from oxylus_tpu.scripting import system as jscript
from oxylus_tpu_torch.assets import manager as tman
from oxylus_tpu_torch.audio import engine as teng
from oxylus_tpu_torch.runtime import SceneRunner as _TRunner
from oxylus_tpu_torch.scene import serialize as tser
from oxylus_tpu_torch.scene.scene import Scene as _TScene
from oxylus_tpu_torch.scene.state import SceneSpec as TSpec
from oxylus_tpu_torch.scripting import system as tscript

torch.set_num_threads(1)
TScene = functools.partial(_TScene, device="cpu")  # the port defaults to the card
TRunner = functools.partial(_TRunner, device="cpu")
FRAMES = 30
COUNTER = """
def on_scene_start(scene, env):
    env["start"] = env.get("start", 0) + 1

def on_scene_update(scene, dt, env):
    env["update"] = env.get("update", 0) + 1

def on_fixed_update(scene, dt, env):
    env["fixed"] = env.get("fixed", 0) + 1
"""


# ---------------------------------------------------------------- the engine


def _seeded_engine(eng, model, looping, seed=5):
    """Five sources placed by a seed around a listener that faces a seeded
    direction: some coned, with velocities for doppler, pitches and volumes."""
    rng = np.random.default_rng(seed)
    e = eng.AudioEngine()
    lst = e.listener(0)
    lst.position = rng.uniform(-1, 1, 3).astype(np.float32)
    lst.velocity = rng.uniform(-5, 5, 3).astype(np.float32)
    fwd = rng.standard_normal(3)
    lst.forward = (fwd / np.linalg.norm(fwd)).astype(np.float32)
    for k in range(5):
        clip = eng.AudioClip.tone(220.0 * (k + 1), seconds=0.02 + 0.01 * k, name=f"t{k}")
        d = rng.standard_normal(3)
        src = e.create_source(
            clip, volume=float(rng.uniform(0.2, 1.0)), pitch=float(rng.uniform(0.5, 2.0)), looping=looping,
            spatialization=k != 4, attenuation_model=model, roll_off=float(rng.uniform(0.5, 2.0)),
            min_distance=float(rng.uniform(0.2, 1.0)), max_distance=float(rng.uniform(5.0, 50.0)),
            min_gain=0.01, max_gain=1.0, doppler_factor=float(k % 2),
            position=rng.uniform(-10, 10, 3).astype(np.float32), velocity=rng.uniform(-40, 40, 3).astype(np.float32),
            direction=(d / np.linalg.norm(d)).astype(np.float32),
        )
        if k in (1, 3):  # directional: a cone with a soft edge
            src.cone_inner_angle, src.cone_outer_angle, src.cone_outer_gain = 0.8, 2.4, 0.2
        src.play()
    e.master_volume = 0.9
    return e


@pytest.mark.parametrize("looping", [True, False], ids=["looping", "one_shot"])
@pytest.mark.parametrize("model", [0, 1, 2, 3], ids=["none", "linear", "inverse", "exponential"])
def test_render_block_matches_jax(model, looping):
    j, t = _seeded_engine(jeng, model, looping), _seeded_engine(teng, model, looping)
    for frames in (800, 801, 799, 1600, 800):  # past the one-shot clips' ends
        a, b = j.render_block(frames), t.render_block(frames)
        assert b.dtype == np.float32 and b.shape == (frames, 2)
        assert float(np.abs(a - b).max()) <= 1e-6
        assert [s.playing for s in t.sources] == [s.playing for s in j.sources]
        assert [s.cursor for s in t.sources] == [s.cursor for s in j.sources]
    lst = t.listeners[0]
    gains = [t._gain_and_pan(s, lst) for s in t.sources]
    assert gains == [j._gain_and_pan(s, j.listeners[0]) for s in j.sources]
    if not looping:
        assert not any(s.playing for s in t.sources)


@pytest.mark.parametrize("fmt", [(1, 1, 48000), (2, 1, 22050), (2, 2, 44100), (4, 3, 48000)],
                         ids=["u8_mono", "s16_mono_22k", "s16_stereo_44k", "s32_3ch"])
def test_wav_clips_load_as_jax(tmp_path, fmt):
    width, channels, rate = fmt
    rng = np.random.default_rng(width * 10 + channels)
    n = rate // 50
    if width == 1:
        data = rng.integers(0, 256, (n, channels), dtype=np.uint8)
    else:
        dt = {2: np.int16, 4: np.int32}[width]
        data = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, (n, channels), dtype=dt)
    path = tmp_path / "c.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(data.tobytes())
    a, b = jeng.AudioClip.load(path), teng.AudioClip.load(path)
    assert b.name == a.name == "c" and b.samples.dtype == np.float32 and b.samples.shape[1] == 2
    np.testing.assert_array_equal(b.samples, a.samples)


# ---------------------------------------------------------------- the runner's hook


def audio_scene(Scene, Spec):
    """A listener, a rotated rig carrying one source as a child (its world
    translation is not its local position), and four more sources: looping and
    spatial, one-shot, coned, and plain stereo; 16 entity slots."""
    s = Scene("audio", spec=Spec(max_entities=16))
    ears = s.create_entity("ears")
    ears.add("TransformComponent", position=(0.0, 0.0, 0.0))
    ears.add("AudioListenerComponent", active=True)
    rig = s.create_entity("rig")
    rig.add("TransformComponent", position=(0.0, 1.0, -2.0), rotation=(0.0, 0.383, 0.0, 0.924))
    emitters = []
    for k, kw in enumerate([
        dict(looping=True, spatialization=True, min_distance=1.0, max_distance=100.0),
        dict(looping=False, spatialization=True, attenuation_model=1, roll_off=0.5),
        dict(looping=True, spatialization=True, cone_inner_angle=1.0, cone_outer_angle=2.5, cone_outer_gain=0.1),
        dict(looping=True, spatialization=False, volume=0.3),
        dict(looping=True, spatialization=True, attenuation_model=3, doppler_factor=2.0),
    ]):
        em = s.create_entity(f"emitter{k}")
        em.add("TransformComponent", position=(-4.0 + 2.0 * k, 0.5 * k, 1.0))
        em.add("AudioSourceComponent", **kw)
        if k == 2:
            em.child_of(rig)
        emitters.append(em.index)
    return s, emitters


def _drive(Scene, Spec, Runner, eng, script):
    s, emitters = audio_scene(Scene, Spec)
    s.lua_systems["counter"] = script.ScriptSystem(script.Script.compile("counter", COUNTER), s)
    runner = Runner(s, render_mode="none")
    assert runner.audio_engine is not None  # made for a scene with audio components
    for k, i in enumerate(emitters):
        runner.attach_audio_clip(i, eng.AudioClip.tone(330.0 + 110.0 * k, seconds=0.1 + 0.15 * k))
    rng = np.random.default_rng(9)
    dts = rng.choice([1 / 60, 1 / 30, 1 / 144, 1 / 50], FRAMES)
    blocks, positions = [], []
    for f, dt in enumerate(dts):
        x = float(-6.0 + 0.4 * f)
        s.defer(lambda sc, x=x: sc.set_field(emitters[0], "TransformComponent", "position", (x, 0.0, 0.5)))
        runner.step(float(dt), render=False)
        blocks.append(runner.last_audio_block.copy())
        positions.append(np.stack([runner._audio_sources[i].position for i in emitters]))
    env = s.lua_systems["counter"].env
    world = np.asarray(runner.state.world)[emitters, :3, 3]
    return blocks, positions, dict(env), world, [src.velocity.copy() for src in runner.audio_engine.sources]


@pytest.fixture(scope="module")
def driven():
    return (_drive(JScene, JSpec, JRunner, jeng, jscript), _drive(TScene, TSpec, TRunner, teng, tscript))


def test_runner_mixes_the_jax_blocks(driven):
    (jb, *_), (tb, *_) = driven
    assert [b.shape for b in tb] == [b.shape for b in jb]
    assert sum(b.shape[0] for b in tb) == sum(b.shape[0] for b in jb) > 0
    err = max(float(np.abs(a - b).max()) for a, b in zip(jb, tb))
    assert err <= 1e-5, err
    assert float(np.abs(tb[-1]).max()) > 0.01  # still sounding


def test_runner_reads_the_world_positions_as_jax(driven):
    (_, jp, _, jworld, jvel), (_, tp, _, tworld, tvel) = driven
    np.testing.assert_allclose(np.stack(tp), np.stack(jp), atol=1e-5)
    # the positions the hook read are the world translations, the child's included
    np.testing.assert_allclose(tp[-1], tworld, atol=1e-6)
    assert float(np.abs(tworld[2] - np.array([0.0, 1.0, 1.0])).max()) > 0.1
    np.testing.assert_allclose(np.stack(tvel), np.stack(jvel), atol=1e-3)


def test_script_lifecycle_matches_the_jax_runner(driven):
    (*_, jenv, _, _), (*_, tenv, _, _) = driven
    assert tenv == jenv
    assert tenv["start"] == 1 and tenv["update"] == FRAMES and tenv["fixed"] > FRAMES


def test_profiler_marks_every_step():
    from oxylus_tpu_torch.utils.profiler import PROFILER

    s, _ = audio_scene(TScene, TSpec)
    runner = TRunner(s, render_mode="none")
    frames0 = PROFILER.frame_count
    zones0 = {k: z.calls for k, z in PROFILER.zones.items()}
    runner.run(3)
    assert PROFILER.frame_count - frames0 == 3
    for name in ("frame_step", "audio_frame"):
        assert PROFILER.zones[name].calls - zones0.get(name, 0) == 3


# ---------------------------------------------------------------- the UUID quirk


def _clip_asset(tmp_path, man, asset_uuid):
    path = tmp_path / "clip.wav"
    if not path.exists():
        tone = (jeng.AudioClip.tone(440.0, 0.05).samples[:, 0] * 32767).astype(np.int16)
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(48000)
            w.writeframes(tone.tobytes())
    man.AssetManager.meta_path(path).write_text(json.dumps({"uuid": asset_uuid, "type": "Audio"}))
    mgr = man.AssetManager()
    assert mgr.import_asset(path) == asset_uuid
    return mgr


@pytest.mark.parametrize("high_word", [2**63 + 12345, 2**62 + 12345], ids=["ge_2_63", "lt_2_63"])
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_clip_uuid_at_or_above_2_63_leaves_the_source_unbound(tmp_path, pkg, high_word):
    """Reference quirk (ROADMAP C): `Scene.set_field` stores UUID words through
    float64, so a word ≥ 2^63 comes back changed. A scene loaded from JSON asks for
    the exact UUID (the clip loads), but `sync_sources_from_scene` looks up the
    stored one and binds nothing, in both packages. Below 2^63 the source binds."""
    man, eng, ser, Scene, Spec, kw = ((jman, jeng, jser, JScene, JSpec, {}) if pkg == "jax"
                                      else (tman, teng, tser, TScene, TSpec, {"device": "cpu"}))
    asset_uuid = juuid.u64_pair_to_uuid(high_word, 777)
    mgr = _clip_asset(tmp_path, man, asset_uuid)
    obj = {"name": "quirk", "entities": [{"name": "src", "components": [
        {"Core.TransformComponent": {}}, {"Core.AudioSourceComponent": {"audio_source": asset_uuid}}]}]}
    scene = ser.scene_from_json(obj, spec=Spec(max_entities=16), asset_manager=mgr, **kw)
    assert mgr.get_asset(asset_uuid).is_loaded
    stored = juuid.u64_pair_to_uuid(*scene._comp_data["AudioSourceComponent"]["audio_source"][0])
    engine, sources = eng.AudioEngine(), {}
    eng.sync_sources_from_scene(engine, scene, sources, mgr)
    if high_word >= 2**63:
        assert stored != asset_uuid and sources == {} and engine.sources == []
    else:
        assert stored == asset_uuid and list(sources) == [0] and sources[0].playing


def test_host_edits_reach_the_cpu_state_only_through_a_merge():
    """C7 (repaired with the audio hook): on the CPU the port's `Scene` built its
    device state on the host mirror's own memory, so the audio hook's write of
    world translations into `TransformComponent.position` moved a child entity
    before any merge. Host edits now reach the state only through
    `to_device_state` / `merge_host_edits`, as in the JAX package."""
    s = TScene("alias", spec=TSpec(max_entities=16))
    e = s.create_entity("e")
    e.add("TransformComponent", position=(1.0, 2.0, 3.0))
    for state in (s.to_device_state(), s.merge_host_edits(s.to_device_state())):
        s._comp_data["TransformComponent"]["position"][e.index] = (9.0, 9.0, 9.0)
        s._alive[e.index + 1] = True
        assert state.comp["TransformComponent"]["position"][e.index].tolist() == [1.0, 2.0, 3.0]
        assert not bool(state.alive[e.index + 1])
        s._comp_data["TransformComponent"]["position"][e.index] = (1.0, 2.0, 3.0)
        s._alive[e.index + 1] = False
