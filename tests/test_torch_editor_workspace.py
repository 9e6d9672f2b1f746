"""The port's editor workspace (`editor/workspace.py`) against the JAX package's: the
text editor's documents, cursor and close queue, the settings panel's rebinding, the
project panel's new/load/recents with a start scene (loaded on the CPU for the port),
and the panel registry, each driven through the same steps in both packages."""

import numpy as np
import torch

from oxylus_tpu.editor import workspace as jws
from oxylus_tpu.scene import scene as jscene
from oxylus_tpu.scene import serialize as jser
from oxylus_tpu.scene import state as jstate
from oxylus_tpu_torch.editor import workspace as tws
from oxylus_tpu_torch.scene import state as tstate

torch.set_num_threads(1)


def _text_editor(ws, root):
    (root / "a.txt").write_text("hello\nworld")
    saved = []
    ed = ws.TextEditorPanel(save_file_callback=saved.append)
    log = [ed.build()]
    doc = ed.open_file(root / "a.txt")
    doc.cursor = 5
    doc.insert("!")
    doc.delete(3)
    log += [(doc.content, doc.cursor, doc.dirty, doc.lines()), ed.build(), ed.request_close("a.txt"), ed.build()]
    ed.cancel_close()
    scratch = ed.open_scratch("s", "abcdef")
    scratch.cursor = 3
    scratch.set_content("xy")
    log += [(scratch.cursor, scratch.dirty), ed.build(), ed.open_file(root / "a.txt") is doc]
    ed.request_close("a.txt")
    ed.request_close("s")
    ed.request_close("ghost")
    ed.confirm_close(save=True)
    log += [ed.build(), saved, (root / "a.txt").read_text(), ed.open_file(root / "new.txt").content, ed.visible]
    ed.save("new.txt")
    log += [ed.request_close("new.txt"), ed.build(), (root / "new.txt").read_text()]
    return log


def test_text_editor_matches_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert _text_editor(tws, tmp_path / "t") == _text_editor(jws, tmp_path / "j")


def _settings(ws):
    class Ctx:
        pass

    st = ws.EditorSettingsPanel(Ctx())
    log = [st.build(), st.feed_key(ord("Q"))]
    st.set_general("undo_history_size", "64")
    st.set_general("ui_scale", 1.5)
    st.begin_rebind("editor.play")
    log.append(st.build())
    log += [st.feed_key(ord("G")), st.feed_key(ord("H")), st.build(), st.ctx.max_history]
    st.begin_rebind("editor.custom")
    st.feed_key(300)
    st.tab = "Keybinds"
    return log + [st.build(), ws.EditorSettingsPanel().build() == ws.EditorSettingsPanel(None).build()]


def test_settings_rebinding_matches_jax():
    assert _settings(tws) == _settings(jws)


def _projects(ws, state, root, load_kw):
    pp = ws.ProjectPanel()
    proj = pp.new_project(root / "game", "Game")
    log = [pp.build(), proj.config.__dict__, sorted(p.name for p in (root / "game").iterdir())]
    # a start scene saved by the JAX package, named in the project file
    s = jscene.Scene("level1", spec=jstate.SceneSpec(max_entities=16))
    s.create_entity("hero").add("TransformComponent", position=(1.0, 2.0, 3.0))
    s.create_entity("crate").add("TransformComponent", scale=(0.5, 0.5, 0.5)).add("BoxColliderComponent")
    jser.save_to_file(s, proj.asset_path / "level1.oxscene")
    proj.config.start_scene = "level1.oxscene"
    proj.save(root / "game" / "Game.oxproj")
    other = ws.ProjectPanel().new_project(root / "other", "Other")  # no start scene
    for k in range(9):
        pp.add_recent(root / f"r{k}.oxproj")
    got, scene = pp.load_project_for_editor(root / "game" / "Game.oxproj", spec=state.SceneSpec(max_entities=16),
                                            **load_kw)
    fields = {(c, k): v.tolist() for c, fs in scene._comp_data.items() for k, v in fs.items() if v.dtype != object}
    log += [got.config.__dict__, scene.scene_name, scene._names[:2], fields, pp.build()]
    pp.visible = True
    got2, scene2 = pp.load_project_for_editor(root / "other" / "Other.oxproj", **load_kw)
    log += [got2.config.name, scene2, pp.build()]
    pp.add_recent(root / "gone.oxproj")
    log += [pp.load_project_for_editor(root / "gone.oxproj"), pp.build()]
    (root / "game" / "Game.oxproj").write_text('[project]\nname = "Missing"\nstart_scene = "nope.oxscene"\n')
    got3, scene3 = pp.load_project_for_editor(root / "game" / "Game.oxproj", **load_kw)
    log += [got3.config.name, scene3, pp.build(), other.config.name]
    return [str(x).replace(str(root), "<root>") for x in log]


def test_project_panel_matches_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _projects(jws, jstate, tmp_path / "j", {})
    got = _projects(tws, tstate, tmp_path / "t", {"device": "cpu"})
    assert got == want
    assert got[4] == "level1" and "hero" in got[5] and "<root>/gone.oxproj" not in got[-4]


def test_project_start_scene_loads_on_the_requested_device(tmp_path):
    pp = tws.ProjectPanel()
    proj = pp.new_project(tmp_path / "g", "G")
    s = jscene.Scene("lvl", spec=jstate.SceneSpec(max_entities=16))
    s.create_entity("hero").add("TransformComponent", position=(1.0, 2.0, 3.0))
    jser.save_to_file(s, proj.asset_path / "lvl.oxscene")
    proj.config.start_scene = "lvl.oxscene"
    proj.save(tmp_path / "g" / "G.oxproj")
    _, scene = pp.load_project_for_editor(tmp_path / "g" / "G.oxproj", spec=tstate.SceneSpec(max_entities=16),
                                          device="cpu")
    assert scene.device == torch.device("cpu")
    pos = scene.to_device_state().comp["TransformComponent"]["position"]
    assert pos.device == torch.device("cpu") and np.array_equal(pos[0].numpy(), [1.0, 2.0, 3.0])


def _registry(ws):
    reg = ws.EditorPanelRegistry()
    ed = reg.add(ws.TextEditorPanel)
    log = [reg.add(ws.TextEditorPanel) is ed]
    reg.add(ws.EditorSettingsPanel)
    reg.add(ws.ProjectPanel)

    class Counter:
        PANEL_NAME = "Counter"
        visible = True

        def __init__(self, start):
            self.n = start

        def update(self):
            self.n += 1

        def build(self):
            return {"n": self.n}

    reg.add(Counter, 5)
    reg.update_all()
    reg.update_all()
    log += [ws.TextEditorPanel in reg, Counter in reg, dict in reg, reg.get(ws.ProjectPanel).PANEL_NAME,
            reg.window_menu(), reg.render_all()]
    reg.toggle("Text Editor")
    reg.toggle("Projects")
    reg.toggle("nothing")
    return log + [reg.window_menu(), reg.render_all()]


def test_panel_registry_matches_jax():
    assert _registry(tws) == _registry(jws)
