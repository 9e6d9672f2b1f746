"""The port's scene JSON serializer and snapshot library against the JAX package's.

A scene holding every non-tag component of the registry with seeded field values,
a parent/child chain and tags is built in both packages: both write the same JSON
text, each reads the other's, the loaded device states are equal through
`bridge.py`, and `Scene.copy()` matches. Snapshots give the same payload bytes and
hashes, the same deltas, and `apply_delta` builds the same replica in both."""

import dataclasses
import functools
import json
import logging

import jax
import numpy as np
import pytest
import torch

from oxylus_tpu.core import uuid as juuid
from oxylus_tpu.scene import serialize as jser
from oxylus_tpu.scene import snapshot as jsnap
from oxylus_tpu.scene.scene import Scene as JScene
from oxylus_tpu.scene.state import SceneSpec as JSpec
from oxylus_tpu_torch import bridge
from oxylus_tpu_torch.scene import components as C
from oxylus_tpu_torch.scene import serialize as tser
from oxylus_tpu_torch.scene import snapshot as tsnap
from oxylus_tpu_torch.scene.scene import Scene as _TScene
from oxylus_tpu_torch.scene.state import SceneSpec as TSpec

from tests.test_torch_state import _assert_tree_equal

torch.set_num_threads(1)
TScene = functools.partial(_TScene, device="cpu")  # the port defaults to the card
SPEC = dict(max_entities=32)
JAX = (JScene, JSpec, jser, jsnap)
PORT = (TScene, TSpec, tser, tsnap)


def _small_uuid(rng) -> str:
    """Both words below 2^63, so `Scene.set_field` keeps them exact (ROADMAP C)."""
    return juuid.u64_pair_to_uuid(int(rng.integers(1, 2**62)), int(rng.integers(1, 2**62)))


def _value(f, rng):
    k = C.FieldKind
    if f.kind == k.BOOL:
        return bool(rng.integers(0, 2))
    if f.kind == k.I32:
        return int(rng.integers(-1000, 1000))
    if f.kind == k.U16:
        return int(rng.integers(0, 2**16))
    if f.kind == k.U32:
        return int(rng.integers(0, 2**32))
    if f.kind == k.F32:
        return float(np.float32(rng.standard_normal() * 10))
    if f.kind == k.ENUM:
        return int(rng.integers(0, len(f.enum_values)))
    if f.kind == k.UUID:
        return _small_uuid(rng)
    n = f.shape[0]
    return tuple(float(v) for v in (rng.standard_normal(n) * 10).astype(np.float32))


def _fill(scene, e, comp, rng):
    cdef = C.BY_NAME[comp]
    e.add(comp)
    for f in cdef.fields:
        scene.set_field(e.index, comp, f.name, _value(f, rng))


def build_scene(Scene, Spec):
    """Every non-tag component on one root, a three-deep chain with tags, a
    networked sprite, then two roots the writer skips (hidden; no transform)."""
    rng = np.random.default_rng(11)
    s = Scene("every_component", spec=Spec(**SPEC))
    s.renderer_config.exposure = 1.75
    s.renderer_config.vbgtao_quality_level = 2
    s.renderer_config.fxaa_enable = False
    s.script_uuids.append(_small_uuid(rng))
    root = s.create_entity("root")
    for cdef in C.COMPONENTS:
        if not cdef.tag:
            _fill(s, root, cdef.name, rng)
    root.add_tag("Networked")
    parent = root
    for depth in range(3):
        e = s.create_entity(f"child{depth}")
        _fill(s, e, "TransformComponent", rng)
        _fill(s, e, ("LightComponent", "SpriteComponent", "BoxColliderComponent")[depth], rng)
        e.child_of(parent)
        if depth == 1:
            e.add_tag("Networked")
            e.add_tag("Game.CustomTag")
        parent = e
    sprite = s.create_entity("sprite")
    _fill(s, sprite, "TransformComponent", rng)
    _fill(s, sprite, "SpriteComponent", rng)
    sprite.add_tag("Networked")
    hidden = s.create_entity("hidden")
    _fill(s, hidden, "TransformComponent", rng)
    hidden.add_tag("Hidden")
    s.create_entity("no_transform").add("CameraComponent")
    return s


def _text(ser, scene, sort_keys=True):
    return json.dumps(ser.scene_to_json(scene), sort_keys=sort_keys)


def _host_model(scene):
    """The host arrays a loaded scene is made of."""
    return {"alive": scene._alive, "parent": scene._parent, "names": scene._names,
            "tags": [sorted(t) for t in scene._tags], "mask": scene._comp_mask, "data": scene._comp_data,
            "config": dataclasses.asdict(scene.renderer_config), "scripts": scene.script_uuids}


def _assert_host_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_host_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _assert_states_equal(jscene, tscene):
    """The JAX scene's device state, carried through the bridge, equals the port's."""
    jst = jax.device_get(jscene.to_device_state())
    got = bridge.scene_state_to_numpy(tscene.to_device_state())
    carried = bridge.scene_state_to_numpy(bridge.scene_state_from_numpy(jst, "cpu"))
    for name in ("alive", "parent", "level", "world", "previous_world", "time", "frame", "comp", "mask"):
        _assert_tree_equal(carried[name], got[name], name)


@pytest.fixture(scope="module")
def scenes():
    return build_scene(JScene, JSpec), build_scene(TScene, TSpec)


@pytest.mark.parametrize("sort_keys", [True, False])
def test_json_text_matches_jax(scenes, sort_keys):
    js, ts = scenes
    assert _text(tser, ts, sort_keys) == _text(jser, js, sort_keys)


def test_json_covers_every_component_and_skips_what_the_reference_skips(scenes):
    _, ts = scenes
    obj = tser.scene_to_json(ts)
    root = obj["entities"][0]
    written = {next(iter(c)) for c in root["components"]}
    assert written == {c.path for c in C.COMPONENTS if not c.tag}
    assert [e["name"] for e in obj["entities"]] == ["root", "sprite"]
    assert root["children"][0]["children"][0]["tags"] == ["Core.Networked", "Game.CustomTag"]


def test_files_are_equal_bytes(scenes, tmp_path):
    js, ts = scenes
    jser.save_to_file(js, tmp_path / "j.json")
    tser.save_to_file(ts, tmp_path / "t.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def test_jax_json_loads_in_the_port(scenes):
    """The JAX package's JSON read by both packages: equal host models, and the
    port's device state equals the JAX package's through the bridge."""
    js, _ = scenes
    obj = jser.scene_to_json(js)
    jl = jser.scene_from_json(json.loads(json.dumps(obj)), spec=JSpec(**SPEC))
    tl = tser.scene_from_json(json.loads(json.dumps(obj)), spec=TSpec(**SPEC), device="cpu")
    assert tl.device == torch.device("cpu")
    _assert_host_equal(_host_model(jl), _host_model(tl))
    _assert_states_equal(jl, tl)


def test_port_json_loads_in_jax(scenes, tmp_path):
    _, ts = scenes
    tser.save_to_file(ts, tmp_path / "t.json")
    jl = jser.load_from_file(tmp_path / "t.json", spec=JSpec(**SPEC))
    tl = tser.load_from_file(tmp_path / "t.json", spec=TSpec(**SPEC), device="cpu")
    assert _text(jser, jl) == _text(tser, ts) == _text(tser, tl)
    _assert_host_equal(_host_model(jl), _host_model(tl))


def test_round_trip_keeps_indices_and_exact_floats(scenes):
    """Entities written in index order keep their indices, and every written
    component array comes back exactly (float32 → JSON → float32 is exact)."""
    _, ts = scenes
    back = tser.scene_from_json(tser.scene_to_json(ts), spec=TSpec(**SPEC), device="cpu")
    kept = [i for i in np.nonzero(ts._alive)[0] if ts._names[i] not in ("hidden", "no_transform")]
    assert [back._names[i] for i in kept] == [ts._names[i] for i in kept]
    assert int(back._alive.sum()) == len(kept)
    for name, fields in ts._comp_data.items():
        np.testing.assert_array_equal(back._comp_mask[name][kept], ts._comp_mask[name][kept], err_msg=name)
        for k, arr in fields.items():
            np.testing.assert_array_equal(back._comp_data[name][k][kept], arr[kept], err_msg=f"{name}.{k}")
    np.testing.assert_array_equal(back._parent[kept], ts._parent[kept])


def test_scene_copy_matches_jax(scenes):
    js, ts = scenes
    jc, tc = js.copy(), ts.copy()
    assert tc.scene_name == jc.scene_name == "every_component_copy"
    assert tc.device == ts.device and tc.spec == ts.spec
    assert _text(tser, tc) == _text(jser, jc)
    _assert_host_equal(_host_model(jc), _host_model(tc))


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_children_created_before_their_parent_move(pkg):
    """The writer walks roots, each followed by its children, so a child made
    before its parent comes back after it: the indices move, alike in both packages."""
    Scene, Spec, ser, _ = pkg
    s = Scene("order", spec=Spec(**SPEC))
    child = s.create_entity("child")
    child.add("TransformComponent", position=(0.0, 1.0, 0.0))
    root = s.create_entity("root")
    root.add("TransformComponent", position=(2.0, 0.0, 0.0))
    child.child_of(root)
    back = ser.scene_from_json(ser.scene_to_json(s), spec=Spec(**SPEC), **({} if ser is jser else {"device": "cpu"}))
    assert (s.entity("child").index, s.entity("root").index) == (0, 1)
    assert (back.entity("root").index, back.entity("child").index) == (0, 1)


def test_tolerant_reader_matches_jax(caplog):
    """Unknown components and fields are skipped with a warning, enums read by
    scoped name, vectors in array form: alike in both packages."""
    obj = {
        "name": "tolerant",
        "config": {"color": {"exposure": 2.0}, "future_section": {"x": 1}},
        "entities": [{
            "name": "e", "tags": ["Core.Hidden", "User.Tag"],
            "components": [
                {"Core.TransformComponent": {"position": [1.0, 2.0, 3.0], "rotation": {"x": 0.0, "w": 1.0},
                                             "not_a_field": 5}},
                {"Core.LightComponent": {"type": "Core.LightComponent.Spot"}},
                {"Game.Unknown": {"a": 1}},
            ],
            "children": [],
        }],
    }
    with caplog.at_level(logging.WARNING, logger="oxylus.scene"):
        jl = jser.scene_from_json(json.loads(json.dumps(obj)), spec=JSpec(**SPEC))
        n_jax = len(caplog.records)
        tl = tser.scene_from_json(json.loads(json.dumps(obj)), spec=TSpec(**SPEC), device="cpu")
    assert n_jax == 2 and len(caplog.records) == 4
    _assert_host_equal(_host_model(jl), _host_model(tl))
    for bad in ({"entities": []}, {"name": "no entities"}):
        with pytest.raises(ValueError):
            tser.scene_from_json(bad, device="cpu")
        with pytest.raises(ValueError):
            jser.scene_from_json(bad)


# ---------------------------------------------------------------- snapshots


def _snap_view(snap):
    return {i: (e.name, e.tags, e.components, e.hashes) for i, e in snap.entities.items()}


def _delta_view(d):
    return dataclasses.astuple(d)


def _edit(s):
    """Move a networked transform, add a networked entity, destroy one."""
    s.set_field(s.entity("sprite").index, "TransformComponent", "position", (4.0, 5.0, 6.0))
    e = s.create_entity("late")
    e.add("TransformComponent", position=(1.0, 1.0, 1.0))
    e.add_tag("Networked")
    s.destroy_entity(s.entity("child1").index)


@pytest.fixture(scope="module")
def snapshots():
    out = []
    for Scene, Spec, _, snap in (JAX, PORT):
        s = build_scene(Scene, Spec)
        b = snap.SceneSnapshotBuilder()
        first = b.take_snapshot(s)
        full = b.delta(first)
        b.ack(first.sequence)
        _edit(s)
        second = b.take_snapshot(s)
        inc = b.delta(second)
        out.append((b, first, full, second, inc))
    return out


def test_snapshot_payloads_and_hashes_match_jax(snapshots):
    (_, jf, _, js, _), (_, tf, _, ts, _) = snapshots
    assert _snap_view(tf) == _snap_view(jf)
    assert _snap_view(ts) == _snap_view(js)
    assert sorted(tf.entities) == [0, 2, 4]  # the networked ones
    assert tsnap.NETWORKED_COMPONENTS == jsnap.NETWORKED_COMPONENTS


def test_deltas_match_jax(snapshots):
    (_, _, jfull, _, jinc), (_, _, tfull, _, tinc) = snapshots
    assert _delta_view(tfull) == _delta_view(jfull) and tfull.base_sequence == -1
    assert _delta_view(tinc) == _delta_view(jinc)
    assert set(tinc.changed) == {4} and tinc.removed == (2,) and len(tinc.created) == 1


@pytest.mark.parametrize("source", ["jax", "port"])
def test_apply_delta_builds_the_same_replica(snapshots, source):
    """Either package's deltas, applied to a fresh scene of each package, give
    replicas whose snapshots (payload bytes and hashes) are equal."""
    _, _, full, _, inc = snapshots[0 if source == "jax" else 1]
    views = []
    for Scene, Spec, _, snap in (JAX, PORT):
        replica = Scene("replica", spec=Spec(**SPEC))
        emap = snap.apply_delta(replica, full)
        emap = snap.apply_delta(replica, inc, emap)
        views.append((emap, _snap_view(snap.SceneSnapshotBuilder().take_snapshot(replica))))
    assert views[1] == views[0]
    # the replica's payloads are the source's current ones
    src_now = _snap_view(snapshots[1][3])
    emap, rep = views[1]
    assert {src: rep[dst][2:] for src, dst in emap.items()} == {i: v[2:] for i, v in src_now.items()}


def test_ring_fallback_matches_jax():
    out = []
    for Scene, Spec, _, snap in (JAX, PORT):
        s = build_scene(Scene, Spec)
        b = snap.SceneSnapshotBuilder()
        first = b.take_snapshot(s)
        for _ in range(snap.SNAPSHOT_RING):
            last = b.take_snapshot(s)
        d = b.delta(last, base_sequence=first.sequence)
        out.append((d.base_sequence, sorted(d.created), b.get(first.sequence), b.get(last.sequence).sequence))
    assert out[1] == out[0] and out[1][0] == -1 and out[1][2] is None
