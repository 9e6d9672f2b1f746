"""The port's editor (`editor/{context,gizmo,panels}.py`) against the JAX package's:
undo/redo and play/stop over both packages' `Scene` built the same way (equal fields;
the port's device state follows through `merge_host_edits`; play leaves the edit scene
untouched), gizmo picks and drags from `camera_matrices` of the same arguments (the
axis equal, the updates within 1e-6), the hierarchy, inspector and content panels with
thumbnails (equal), and `ViewportPanel.pick` on a tensor id image (the JAX answer,
NumPy's index rules included)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import DispatchLog
from oxylus_tpu.assets import manager as jman
from oxylus_tpu.editor import context as jctx
from oxylus_tpu.editor import gizmo as jgiz
from oxylus_tpu.editor import panels as jpan
from oxylus_tpu.render import camera as jcam
from oxylus_tpu.render import picking as jpick
from oxylus_tpu.scene import scene as jscene
from oxylus_tpu.scene import state as jstate
from oxylus_tpu_torch.assets import manager as tman
from oxylus_tpu_torch.assets.texture import write_ktx2
from oxylus_tpu_torch.editor import context as tctx
from oxylus_tpu_torch.editor import gizmo as tgiz
from oxylus_tpu_torch.editor import panels as tpan
from oxylus_tpu_torch.render import camera as tcam
from oxylus_tpu_torch.render import picking as tpick
from oxylus_tpu_torch.scene import scene as tscene
from oxylus_tpu_torch.scene import state as tstate

torch.set_num_threads(1)

GIZMO_TOL = 1e-6  # the same NumPy math on camera vectors that may differ by float32 rounding
W, H = 1920, 1080
JAX = dict(scene=jscene, state=jstate, ctx=jctx, pan=jpan, kw={})
PORT = dict(scene=tscene, state=tstate, ctx=tctx, pan=tpan, kw={"device": "cpu"})


def _scene(pkg):
    s = pkg["scene"].Scene("edit", spec=pkg["state"].SceneSpec(max_entities=16), **pkg["kw"])
    root = s.create_entity("root")
    root.add("TransformComponent", position=(0.0, 0.0, 0.0))
    child = s.create_entity("child")
    child.add("TransformComponent", position=(1.0, 0.0, 0.0), rotation=(0.0, 0.38268343, 0.0, 0.92387953))
    child.child_of(root)
    box = s.create_entity("box")
    box.add("TransformComponent", position=(0.0, 2.0, 0.0))
    box.add("BoxColliderComponent", size=(0.5, 0.5, 0.5))
    box.add("RigidBodyComponent", mass=2.0)
    floor = s.create_entity("floor")
    floor.add("TransformComponent", position=(0.0, -1.0, 0.0), scale=(10.0, 1.0, 10.0))
    floor.add("BoxColliderComponent", size=(5.0, 0.5, 5.0))
    floor.add("RigidBodyComponent", type="Static")
    floor.child_of(root)
    return s


def _fields(s) -> dict:
    return {(c, k): np.array(v) for c, fs in s._comp_data.items() for k, v in fs.items() if v.dtype != object}


def _assert_same_fields(got, want):
    g, w = _fields(got), _fields(want)
    assert g.keys() == w.keys()
    for key in w:
        assert g[key].dtype == w[key].dtype and np.array_equal(g[key], w[key]), key
    for c in want._comp_mask:
        assert np.array_equal(got._comp_mask[c], want._comp_mask[c]), c


def test_undo_redo_play_stop_match_jax():
    jc, tc = jctx.EditorContext(_scene(JAX)), tctx.EditorContext(_scene(PORT))
    state = tc.edit_scene.to_device_state()
    steps = [
        ("set", 2, "TransformComponent", "position", (0.5, 3.0, -1.0)),
        ("set", 2, "RigidBodyComponent", "mass", 3.5),
        ("set", 2, "RigidBodyComponent", "type", "Kinematic"),
        ("undo",), ("undo",), ("redo",),
        ("set", 1, "TransformComponent", "scale", (2.0, 2.0, 2.0)),  # clears the redo stack
        ("redo",), ("undo",), ("undo",), ("undo",), ("undo",),
    ]
    for step in steps:
        res = [getattr(c, step[0])(*step[1:]) if step[0] != "set" else c.set_field(*step[1:]) for c in (jc, tc)]
        assert res[0] == res[1], step
        assert (tc.undo_count, tc.redo_count) == (jc.undo_count, jc.redo_count), step
        _assert_same_fields(tc.scene, jc.scene)
        state = tc.scene.merge_host_edits(state)  # the host edit reaches the device state
        for k, v in state.comp["TransformComponent"].items():
            assert np.array_equal(v.numpy(), tc.scene._comp_data["TransformComponent"][k][: v.shape[0]]), (step, k)
    tc.set_field(2, "TransformComponent", "position", (0.0, 4.0, 0.0))
    jc.set_field(2, "TransformComponent", "position", (0.0, 4.0, 0.0))
    before = _fields(tc.edit_scene)
    for c in (jc, tc):
        play = c.on_scene_simulate()
        assert c.state.name == "SIMULATE" and play is c.scene and play is not c.edit_scene
        assert play.running and play.physics_state is not None
        c.on_scene_pause()
        assert c.state.name == "PAUSED"
        c.on_scene_resume()
        assert c.state.name == "PLAY"
        c.select(2)
        c.set_field(2, "TransformComponent", "position", (9.0, 9.0, 9.0))  # edits the runtime scene
    assert tc.scene.scene_name == jc.scene.scene_name == "edit_copy"
    _assert_same_fields(tc.scene, jc.scene)
    assert int(tc.scene.physics_state.active.sum()) == int(np.asarray(jc.scene.physics_state.active).sum()) == 2
    for c in (jc, tc):
        assert c.on_scene_stop() is c.edit_scene and c.state.name == "EDIT"
    after = _fields(tc.edit_scene)
    assert all(np.array_equal(after[k], before[k]) for k in before)  # play left the edit scene untouched
    _assert_same_fields(tc.edit_scene, jc.edit_scene)


def _cams(fov=60.0, yaw=-np.pi / 2, pitch=-0.2, pos=(0.3, 1.0, 5.0), aspect=W / H):
    args = dict(position=pos, yaw=yaw, pitch=pitch, tilt=0.0, fov_deg=fov, near=0.1, far=100.0, zoom=1.0)
    j = jcam.camera_matrices(**{k: jnp.asarray(v, jnp.float32) for k, v in args.items()},
                             projection_kind=jnp.int32(0), aspect=jnp.float32(aspect))
    t = tcam.camera_matrices(**{k: torch.tensor(v, dtype=torch.float32) for k, v in args.items()},
                             projection_kind=torch.tensor(0, dtype=torch.int32),
                             aspect=torch.tensor(aspect, dtype=torch.float32))
    return j, t


QUAT = (0.0, 0.38268343, 0.0, 0.92387953)


def _handle_pixels(cam, mode) -> list[tuple[float, float]]:
    """The pixel 70 % along each axis handle of a gizmo at the origin."""
    vp, ro = cam.view_projection.numpy(), cam.position.numpy()
    scale = max(float(np.linalg.norm(ro)) * 0.2, 1e-3)
    out = []
    for axis in tgiz._axis_dirs(QUAT, mode):
        c = vp @ np.append(axis * scale * 0.7, 1.0)
        out.append(((c[0] / c[3] + 1) / 2 * W - 0.5, (c[1] / c[3] + 1) / 2 * H - 0.5))
    return out


def test_gizmo_pick_and_drag_match_jax():
    jc, tc = _cams()
    rng = np.random.default_rng(11)
    picked = []
    for mode in (tgiz.GizmoMode.WORLD, tgiz.GizmoMode.LOCAL):
        jmode = jgiz.GizmoMode[mode.name]
        for px, py in _handle_pixels(tc, mode) + [tuple(rng.uniform(0, 1, 2) * (W, H)) for _ in range(6)]:
            want = jgiz.pick_gizmo_axis(jc, px, py, W, H, (0.0, 0.0, 0.0), QUAT, jmode)
            got = tgiz.pick_gizmo_axis(tc, px, py, W, H, (0.0, 0.0, 0.0), QUAT, mode)
            assert got == want, (mode, px, py)
            picked.append(got)
        for op, axis, snap in ((tgiz.GizmoOp.TRANSLATE, 0, 0.0), (tgiz.GizmoOp.TRANSLATE, 2, 0.25),
                               (tgiz.GizmoOp.SCALE, 1, 0.0), (tgiz.GizmoOp.SCALE, 0, 0.5),
                               (tgiz.GizmoOp.ROTATE, 1, 0.0), (tgiz.GizmoOp.ROTATE, 2, 15.0)):
            p0, p1 = (W * 0.5, H * 0.5), (W * 0.61, H * 0.47)
            kw = dict(position=(0.5, 0.0, -0.5), rotation_quat=QUAT, scale=(1.0, 2.0, 0.5), snap=snap)
            want = jgiz.gizmo_drag(jc, jgiz.GizmoOp[op.name], axis, p0, p1, W, H, mode=jmode, **kw)
            got = tgiz.gizmo_drag(tc, op, axis, p0, p1, W, H, mode=mode, **kw)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GIZMO_TOL, err_msg=f"{op} {axis} {snap}")
    assert picked[:3] == picked[9:12] == [0, 1, 2] and -1 in picked


def test_viewport_gizmo_through_both_contexts():
    jc, tc = _cams()
    out = []
    for pkg, cam in ((JAX, jc), (PORT, tc)):
        ctx = pkg["ctx"].EditorContext(_scene(pkg))
        vp = pkg["pan"].ViewportPanel(ctx, W, H)
        ctx.select(1)
        axis = vp.pick_axis(cam, W * 0.6, H * 0.56)
        upd = vp.drag(cam, max(axis, 0), (W * 0.5, H * 0.5), (W * 0.58, H * 0.52))
        vp.gizmo_op = type(vp.gizmo_op).ROTATE
        upd2 = vp.drag(cam, 1, (W * 0.5, H * 0.5), (W * 0.52, H * 0.5))
        out.append((axis, upd, upd2, ctx.undo_count, ctx.scene.get_field(1, "TransformComponent", "rotation")))
    (ja, ju, ju2, jn, jr), (ta, tu, tu2, tn, tr) = out
    assert ta == ja and tn == jn == 2
    for w, g in ((ju, tu), (ju2, tu2)):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=GIZMO_TOL)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=GIZMO_TOL)


def test_gizmo_ray_ignores_the_cameras_fov_in_both():
    """Reference quirk: `camera_ray` reads `camera.fov_deg` (`oxylus_tpu/editor/gizmo.py:40`),
    which neither package's `CameraMatrices` carries, so every gizmo ray is cast at 60°.
    At a 60° camera it follows `picking.screen_ray`; at a 90° camera it leaves it."""
    px, py = W * 0.8, H * 0.25
    for fov, agree in ((60.0, True), (90.0, False)):
        jc, tc = _cams(fov=fov)
        for giz, pick, cam in ((jgiz, jpick, jc), (tgiz, tpick, tc)):
            assert not hasattr(cam, "fov_deg")
            _, d = giz.camera_ray(cam, px, py, W, H)
            _, want = pick.screen_ray(cam, px, py, W, H)
            err = float(np.abs(d - np.asarray(want)).max())
            assert (err < 1e-4) if agree else (err > 0.05), (giz.__name__, fov, err)
    # the port's tensor camera is read once: its ray equals the one from host copies of its vectors
    _, tc = _cams(fov=90.0)
    host = tgiz.host_camera(tc)
    assert not hasattr(host, "fov_deg")
    for a, b in zip(tgiz.camera_ray(tc, px, py, W, H), tgiz.camera_ray(host, px, py, W, H)):
        assert np.array_equal(a, b)


def _tree(nodes):
    return [dataclasses.asdict(n) for n in nodes]


def test_hierarchy_and_inspector_panels_match_jax():
    out = []
    for pkg in (JAX, PORT):
        ctx = pkg["ctx"].EditorContext(_scene(pkg))
        hier, insp = pkg["pan"].SceneHierarchyPanel(ctx), pkg["pan"].InspectorPanel(ctx)
        ctx.select(3)
        steps = [_tree(hier.build()), [_tree(insp.build(e)) for e in range(4)], _tree(insp.build())]
        hier.reparent(3, None)
        hier.rename(1, "renamed")
        insp.edit(2, "RigidBodyComponent", "friction", 0.25)
        insp.add_component(1, "SphereColliderComponent", radius=0.75)
        insp.remove_component(2, "BoxColliderComponent")
        ctx.clear_selection()
        steps += [_tree(hier.build()), [_tree(insp.build(e)) for e in range(4)], insp.build(), ctx.undo_count]
        out.append(steps)
    assert out[1] == out[0]
    assert out[1][0][0]["children"][1]["selected"] is True
    names = [c["name"] for c in out[1][1][2]]
    assert names == ["TransformComponent", "RigidBodyComponent", "BoxColliderComponent"]


def _content(pkg_man, pkg, root):
    mgr = pkg_man.AssetManager()
    mgr.init()
    ctx = pkg["ctx"].EditorContext(_scene(pkg))
    panel = pkg["pan"].ContentPanel(ctx, str(root), asset_manager=mgr)
    out = [[dataclasses.asdict(e) for e in panel.build()], panel.breadcrumbs()]
    panel.navigate(str(root / "textures"))
    entries = panel.build()
    out += [[dataclasses.asdict(e) for e in entries], panel.breadcrumbs()]
    thumbs = {e.name: panel.thumbnail(e.path) for e in entries} | {
        n: panel.thumbnail(str(root / n)) for n in ("player.py", "level.oxscene", "notes.txt", "missing.png")}
    assert panel.thumbnail(entries[0].path) is thumbs[entries[0].name]  # cached
    panel.go_up()
    out.append(panel.current == str(root))
    with pytest.raises(ValueError):
        panel.navigate(str(root.parent))
    return out, thumbs


def test_content_panel_and_thumbnails_match_jax(tmp_path):
    """A PNG's thumbnail downsamples the image. The seeded KTX2 gets the flat tile of an
    untyped file in both packages: their importer types `.ktx2` as `NONE` (ROADMAP C)."""
    root = tmp_path / "proj"
    (root / "textures").mkdir(parents=True)
    (root / "scenes").mkdir()
    rng = np.random.default_rng(19)
    Image.fromarray(rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)).save(root / "textures" / "noise.png")
    write_ktx2(root / "textures" / "seeded.ktx2", rng.integers(0, 256, (20, 24, 4), dtype=np.uint8))
    (root / "textures" / "broken.png").write_bytes(b"not a png")
    (root / "textures" / "noise.png.oxasset").write_text(json.dumps({"uuid": "00000000-0000-0000-0000-0000000000aa"}))
    (root / "level.oxscene").write_text("{}")
    (root / "player.py").write_text("def on_scene_update(*a): pass\n")
    (root / "notes.txt").write_text("x")
    want, jthumbs = _content(jman, JAX, root)
    got, tthumbs = _content(tman, PORT, root)
    assert got == want
    assert tthumbs.keys() == jthumbs.keys()
    for k in jthumbs:
        assert tthumbs[k].dtype == jthumbs[k].dtype == np.uint8 and np.array_equal(tthumbs[k], jthumbs[k]), k
    assert [e["asset_type"] for e in got[2]] == ["TEXTURE", "TEXTURE", "NONE"]
    assert got[2][1]["uuid"] == "00000000-0000-0000-0000-0000000000aa"
    assert np.unique(tthumbs["seeded.ktx2"].reshape(-1, 4), axis=0).tolist() == [[128, 128, 128, 255]]
    assert np.unique(tthumbs["broken.png"].reshape(-1, 4), axis=0).tolist() == [[128, 128, 128, 255]]
    assert len(np.unique(tthumbs["noise.png"].reshape(-1, 4), axis=0)) > 1000


def test_viewport_pick_on_a_tensor_id_image():
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 4, (12, 20)).astype(np.int32)
    jv = jpan.ViewportPanel(jctx.EditorContext(_scene(JAX)), 20, 12)
    tv = tpan.ViewportPanel(tctx.EditorContext(_scene(PORT)), 20, 12)
    image = torch.from_numpy(ids.copy())
    for x, y in ((3, 4), (19, 11), (0, 0), (-1, -1), (-20, -12), (7, 2), (12, 9)):
        assert tv.pick(image, x, y) == jv.pick(ids, x, y) == ids[y, x]
        assert tv.ctx.selection == jv.ctx.selection
    for x, y in ((20, 0), (0, 12), (-21, 0), (0, -13)):
        with pytest.raises(IndexError):
            jv.pick(ids, x, y)
        with pytest.raises(IndexError):
            tv.pick(image, x, y)
    assert tv.pick(ids, 3, 4) == ids[4, 3]  # a NumPy image too
    with DispatchLog() as log:  # one pixel read: two views and one element, nothing copied whole
        tv.pick(image, 7, 2)
    assert log.ops == [("select", [(12, 20)]), ("select", [(20,)]), ("_local_scalar_dense", [()])]
