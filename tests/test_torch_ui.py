"""The port's UI (`ui/{text,imgui,rml,widgets}.py`) against the JAX package's: the font
atlas and sprite batches bit for bit, the composite over 3- and 4-channel frames within
1e-6 (exact expected) on NumPy and tensor frames, the ImGui layer over the same injected
input, RML parsing, cascade, layout, hover, click, data binding and view routing, and
the debug widgets' texts."""

import dataclasses
import json
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from oxylus_tpu.assets import manager as jman
from oxylus_tpu.core import config as jconfig
from oxylus_tpu.core import input as jinput
from oxylus_tpu.scene import scene as jscene
from oxylus_tpu.scene import state as jstate
from oxylus_tpu.ui import imgui as jimgui
from oxylus_tpu.ui import rml as jrml
from oxylus_tpu.ui import text as jtext
from oxylus_tpu.ui import widgets as jwidgets
from oxylus_tpu_torch.assets import manager as tman
from oxylus_tpu_torch.core import config as tconfig
from oxylus_tpu_torch.core import input as tinput
from oxylus_tpu_torch.scene import scene as tscene
from oxylus_tpu_torch.scene import state as tstate
from oxylus_tpu_torch.ui import imgui as timgui
from oxylus_tpu_torch.ui import rml as trml
from oxylus_tpu_torch.ui import text as ttext
from oxylus_tpu_torch.ui import widgets as twidgets

torch.set_num_threads(1)

COMPOSITE_TOL = 1e-6  # the same float32 blend in draw order on both sides: exact expected


def _hud(mod, w=96, h=64):
    """The same document in either package: panels (one fractional, one clipped
    at the frame's edge), text at two scales, a space and a character outside
    the font."""
    doc = mod.UIDocument(w, h)
    doc.add_panel(4, 3, 80, 20, color=(0.1, 0.2, 0.6, 0.8))
    doc.add_text(6, 6, "HP 100 é", color=(1.0, 0.9, 0.2, 1.0))
    doc.add_panel(70.5, 40.25, 40.75, 30.5, color=(0.9, 0.3, 0.1, 0.45))
    doc.add_text(10, 30, "Ox!", color=(0.2, 1.0, 0.4, 0.7), scale=1.5)
    return doc


def test_font_atlas_bit_equal():
    ja, jr = jtext.bake_font_atlas()
    ta, tr = ttext.bake_font_atlas()
    assert ta.dtype == ja.dtype and np.array_equal(ta, ja)
    assert tr == jr


def test_build_batch_bit_equal():
    jr, jt = _hud(jtext).build_batch()
    tr, tt = _hud(ttext).build_batch()
    assert tr.dtype == jr.dtype == np.float32 and tt.dtype == jt.dtype == np.float32
    assert np.array_equal(tr, jr) and np.array_equal(tt, jt)
    assert len(tr) == 2 + len("HP100") + len("Ox!")  # the space and "é" make no quad
    er, et = ttext.UIDocument(8, 8).build_batch()  # empty: one blank record, as in JAX
    assert np.array_equal(er, jtext.UIDocument(8, 8).build_batch()[0]) and et.shape == (1, 16, 16, 4)


@pytest.mark.parametrize("channels", [3, 4])
def test_composite_over_matches_jax(channels):
    rng = np.random.default_rng(7 + channels)
    frame = rng.uniform(0.0, 1.0, (64, 96, channels)).astype(np.float32)
    want = _hud(jtext).composite_over(frame)
    doc = _hud(ttext)
    got_np = doc.composite_over(frame)
    got_t = doc.composite_over(torch.from_numpy(frame))
    assert isinstance(got_np, np.ndarray) and isinstance(got_t, torch.Tensor)
    assert got_np.shape == got_t.shape == want.shape == (64, 96, 4)
    np.testing.assert_allclose(got_np, want, rtol=0, atol=COMPOSITE_TOL)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=COMPOSITE_TOL)
    assert not np.array_equal(want[..., :3], frame[..., :3])  # it drew
    src = torch.from_numpy(frame.copy())
    doc.composite_over(src)
    assert torch.equal(src, torch.from_numpy(frame))


def test_composite_over_float64_frame_and_untouched_input():
    frame = np.linspace(0.0, 1.0, 32 * 48 * 3).reshape(32, 48, 3)
    want = _hud(jtext, 48, 32).composite_over(frame)
    got = _hud(ttext, 48, 32).composite_over(torch.from_numpy(frame))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=COMPOSITE_TOL)


def test_composite_raises_on_an_element_left_of_the_frame_in_both():
    """Reference quirk: `composite_over`'s slice `out[y0:y1, x0:x1]` wraps a negative
    origin, so an element that starts left of (or above) the frame meets a region of
    another shape and the blend raises `ValueError` (NumPy's broadcast error) in the
    JAX package; the port raises `ValueError` there too, on a NumPy and a tensor frame."""
    frame = np.zeros((32, 64, 3), np.float32)
    for x, y in ((-10, 4), (4, -6)):
        jd, td = jtext.UIDocument(64, 32), ttext.UIDocument(64, 32)
        for d in (jd, td):
            d.add_panel(x, y, 40, 12, color=(1, 0, 0, 1))
        with pytest.raises(ValueError, match="broadcast"):
            jd.composite_over(frame)
        with pytest.raises(ValueError, match="broadcast"):
            td.composite_over(frame)
        with pytest.raises(ValueError, match="broadcast"):
            td.composite_over(torch.from_numpy(frame))
    # a one-pixel-wide panel at x = -1 broadcasts into the empty wrapped slice: no error, no ink
    jd, td = jtext.UIDocument(64, 32), ttext.UIDocument(64, 32)
    for d in (jd, td):
        d.add_panel(-1, 2, 1, 5, color=(1, 0, 0, 1))
    np.testing.assert_array_equal(td.composite_over(frame), jd.composite_over(frame))


def _gui_frames(gmod, imod, frame=None):
    """Seven frames of one window (text, button, checkbox, slider) over injected
    mouse events; returns per frame the widgets' values, the document's elements
    and its batch, and the composite of the last frame over `frame`."""
    inp = imod.Input()
    gui = gmod.ImGuiRenderer(320, 200)
    row = lambda k: 10 + gmod.ROW_H + gmod.PAD + k * (gmod.ROW_H + 2) + 5  # the k-th row's middle
    events = [
        [("move", 60, row(1)), ("down",)],  # press the button
        [("up",)],                          # release it over the button: one click
        [("move", 60, row(2)), ("down",)],  # press the checkbox
        [("up",)],                          # release: toggled
        [("move", 30, row(3)), ("down",)],  # press the slider at x = 30
        [("move", 150, row(3))],            # drag it to x = 150
        [("up",)],
    ]
    out = []
    image = None
    for k, evs in enumerate(events):
        for ev in evs:
            if ev[0] == "move":
                inp.inject_mouse_move(ev[1], ev[2])
            elif ev[0] == "down":
                inp.inject_mouse_down(0)
            else:
                inp.inject_mouse_up(0)
        gui.new_frame(input_module=inp)
        opened = gui.begin("tools", x=10, y=10, w=220, h=140)
        gui.text(f"frame {k}")
        vals = (opened, gui.button("Fire"), gui.checkbox("vsync"), gui.slider_float("gain", 0.0, 10.0, 2.5))
        gui.end()
        elements = [dataclasses.astuple(e) for e in gui.doc.elements]
        if k == len(events) - 1 and frame is not None:
            image = gui.render(frame=frame)
            batch = gui.doc.build_batch()
        else:
            batch = gui.render()
        out.append((vals, elements, batch))
        inp.update()
        inp.reset_pressed()
    return out, image, gui


def test_imgui_same_values_elements_and_batch():
    frame = np.random.default_rng(5).uniform(0, 1, (200, 320, 3)).astype(np.float32)
    want, want_img, jgui = _gui_frames(jimgui, jinput, frame)
    got, got_img, tgui = _gui_frames(timgui, tinput, torch.from_numpy(frame))
    for k, ((wv, we, wb), (gv, ge, gb)) in enumerate(zip(want, got)):
        assert gv == wv and ge == we, k
        assert np.array_equal(gb[0], wb[0]) and np.array_equal(gb[1], wb[1]), k
    # the button clicked once, the checkbox toggled, the slider set by the drag
    assert [v[1] for v, _, _ in got] == [False, True, False, False, False, False, False]
    assert [v[2] for v, _, _ in got][-1] is True
    assert got[-1][0][3] != 2.5 and tgui.get_value("tools", "gain") == jgui.get_value("tools", "gain")
    assert isinstance(got_img, torch.Tensor)
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=0, atol=COMPOSITE_TOL)


def test_imgui_module_hooks():
    gui = timgui.ImGuiRenderer()
    assert gui.module_dependencies == jimgui.ImGuiRenderer.module_dependencies == ("Input",)
    assert gui.MODULE_NAME == jimgui.ImGuiRenderer.MODULE_NAME
    inp = tinput.Input()
    gui.init(app=SimpleNamespace(get_module=lambda name: inp if name == "Input" else None))
    assert gui._input is inp
    gui.update(0.016)
    gui.begin("w")
    gui.end()
    gui.deinit()
    assert gui._windows == {}


RML = """
<rml>
<head>
<style>
/* the menu */
body { background-color: #202030; padding: 4; }
div { padding: 6; }
.menu { background-color: #334; width: 60%; }
.menu p { color: yellow; }
#title { font-size: 2; text-align: center; color: white; }
#hint { text-align: right; }
button { background-color: blue; height: 24; }
button:hover { background-color: orange; }
button:active { background-color: rgba(255, 40, 0, 0.75); }
.hidden { display: none; }
</style>
</head>
<body>
  <div id="title">{{ game.title }}</div>
  <div class="menu">
    <p>Score: {{ score }} of {{ game.best }} points, a line long enough to wrap</p>
    <button id="play" onclick="start_game">Play</button>
    tail text
  </div>
  <div id="hint" style="color: #0f0; margin: 2">{{ missing }}hint</div>
  <div class="hidden"><p>never</p></div>
</body>
</rml>
"""


def _tree(el):
    return (el.tag, el.id, sorted(el.classes), {k: v for k, v in el.attrs.items()}, el.text, el.box,
            dict(el.style), [_tree(c) for c in el.children])


def _rml_steps(mod, text_mod):
    """Parse, lay out, hover, press and release the button, rebind data; the
    trees, fired handlers and emitted batches along the way."""
    d = mod.RmlDocument(RML, rcss="p { font-size: 1; }", width=240, height=160)
    d.set_data(game={"title": "OXYLUS", "best": 99}, score=42)
    fired = []
    d.bind("start_game", lambda el: fired.append(el.id))
    d.layout()
    steps = [_tree(d.root)]
    bx, by, bw, bh = d.root.find("play").box
    cx, cy = bx + bw / 2, by + bh / 2
    for mx, my, down in ((cx, cy, False), (cx, cy, True), (cx, cy, False), (cx, cy, True), (-5, -5, False)):
        clicked = d.process_mouse(mx, my, down)
        d.layout()
        steps.append((None if clicked is None else clicked.id, list(fired), _tree(d.root)))
    d.set_data(score=1337)
    ui = text_mod.UIDocument(240, 160)
    d.emit(ui)
    steps.append(_tree(d.root))
    return steps, ui.build_batch(), [r.__dict__ for r in d.rules], fired


def test_rml_parse_cascade_layout_input_and_binding():
    want, (wr, wt), wrules, wfired = _rml_steps(jrml, jtext)
    got, (gr, gt), grules, gfired = _rml_steps(trml, ttext)
    assert grules == wrules
    assert got == want
    assert gfired == wfired == ["play"]
    assert np.array_equal(gr, wr) and np.array_equal(gt, wt)
    assert [trml.parse_color(c) for c in ("#f00", "#11223344", "rgba(255, 128, 0, 0.5)", "grey", "bogus")] == \
        [jrml.parse_color(c) for c in ("#f00", "#11223344", "rgba(255, 128, 0, 0.5)", "grey", "bogus")]
    p = trml.parse_rml(RML)
    jp = jrml.parse_rml(RML)
    assert _tree(p) == _tree(jp)
    for sel in (".menu p", "div", "button:hover", "#title", "body div p", "* p"):
        for el in (p.find("play"), p.children[1].children[0], p.find("title")):
            jel = jp.find(el.id) if el.id else jp.children[1].children[0]
            assert trml.selector_matches(sel, el, {"hover"}) == jrml.selector_matches(sel, jel, {"hover"})
    assert trml._specificity("div.menu#x:hover p") == jrml._specificity("div.menu#x:hover p")


def _routing(mod):
    ui = mod.RmlUIModule()
    docs = [mod.RmlDocument(RML, width=200, height=150) for _ in range(2)]
    v1, v2 = mod.RmlView("hud", docs[0], ui), mod.RmlView("menu", docs[1], ui)
    v1.set_viewport((0, 0), (200, 150))
    v2.set_viewport((200, 0), (100, 75), keyboard_focused=True)
    log = [ui.keyboard_view().name]
    docs[1].layout()
    bx, by, bw, bh = docs[1].root.find("play").box
    # into v1, press, drag into v2 (v1 keeps the capture), release, then v2's button at half scale
    for x, y in ((50, 50), (250, 40)):
        ui.process_mouse_move(x, y)
        log.append(ui.hovered_view.name)
    ui.process_mouse_move(50, 50)
    ui.process_mouse_button(True)
    ui.process_mouse_move(250, 40)
    log.append((ui.hovered_view.name, ui.capture_view.name))
    log.append(ui.process_mouse_button(False))
    ui.process_mouse_move(200 + (bx + bw / 2) / 2, (by + bh / 2) / 2)
    ui.process_mouse_button(True)
    clicked = ui.process_mouse_button(False)
    log.append((ui.hovered_view.name, clicked.id, v2.to_local(250, 25)))
    log.append(v2.update(surface_size=(160, 120)).build_batch()[0].tolist())
    v1.close()
    log.append([v.name for v in ui.views])
    ui.deinit()
    log.append((ui.views, ui.hovered_view, ui.capture_view))
    return log


def test_rml_module_view_routing():
    assert _routing(trml) == _routing(jrml)


def _widget_texts(cfg_mod, man_mod, scene_mod, state_mod, widgets_mod, root, scene_kw):
    cvars = cfg_mod.CVarSystem()
    cvars.bind_dataclass("r", cfg_mod.RendererConfig())
    console = widgets_mod.RuntimeConsole(cvars, capacity=8)
    console.register_command("echo", lambda *a: " ".join(a))
    logger = logging.getLogger(f"ox.test.{widgets_mod.__name__}")
    logger.propagate = False
    logger.setLevel(logging.DEBUG)
    console.attach(logger)
    for lvl, msg in ((logging.DEBUG, "d"), (logging.INFO, "i"), (logging.WARNING, "w"), (logging.ERROR, "e"),
                     (logging.CRITICAL, "c")):
        logger.log(lvl, msg)
    results = [console.execute(c) for c in ("help", "echo a b", "r.exposure", "r.exposure 2.5", "nope", "")]
    console_text = (results, console.render_text(), console.render_text(last=3))
    logger.removeHandler(console)

    s = scene_mod.Scene("hier", spec=state_mod.SceneSpec(max_entities=16), **scene_kw)
    root_e = s.create_entity("root")
    root_e.add("TransformComponent")
    child = s.create_entity("child")
    child.add("TransformComponent").add("BoxColliderComponent", size=(1.0, 1.0, 1.0)).add("RigidBodyComponent")
    child.child_of(root_e)
    s.create_entity("leaf").child_of(child)
    s.create_entity("lonely").add_tag("Networked")
    hier = widgets_mod.SceneHierarchyViewer(s).render_text()

    assets = man_mod.AssetManager()
    for k, name in enumerate(("a.png", "b.wav", "c.py")):
        (root / name).write_bytes(b"x")
        man_mod.AssetManager.meta_path(root / name).write_text(
            json.dumps({"uuid": f"00000000-0000-0000-0000-00000000000{k}"}))
        assets.import_asset(root / name)
    asset_text = widgets_mod.AssetManagerViewer(assets).render_text()

    peer = lambda name, k: SimpleNamespace(name=name, bytes_sent=10 * k, packets_sent=k, bytes_received=7 * k,
                                           packets_received=k + 1)
    net = SimpleNamespace(servers=[SimpleNamespace(peers={1: peer("a-very-long-peer-name-past-twenty", 3),
                                                          2: peer("p", 0)})],
                          clients=[SimpleNamespace(server=peer("server", 5))])
    net_text = widgets_mod.NetStatsViewer(net).render_text()
    return console_text, hier, asset_text.replace(str(root), "<root>"), net_text


def test_widget_texts(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _widget_texts(jconfig, jman, jscene, jstate, jwidgets, tmp_path / "j", {})
    got = _widget_texts(tconfig, tman, tscene, tstate, twidgets, tmp_path / "t", {"device": "cpu"})
    assert got == want
    assert "    - child [Transform, RigidBody, BoxCollider]\n      - leaf []" in got[1]
    assert got[0][0][3] == "r.exposure = 2.5"


def test_net_stats_on_a_loopback_pair():
    """The viewer over the port's own NetworkManager, after a loopback handshake."""
    import time

    from oxylus_tpu_torch.network.manager import NetworkManager

    net = NetworkManager()
    server = net.create_server()
    client = net.create_client("127.0.0.1", server.port, name="viewer")
    end = time.monotonic() + 2.0
    while not (client.connected and server.peers):
        assert time.monotonic() < end, "no loopback handshake within 2 s"
        net.update()
        time.sleep(0.0005)
    rows = twidgets.NetStatsViewer(net).render_text().splitlines()
    net.deinit()
    assert len(rows) == 3 and rows[1].startswith("server[0]  viewer") and rows[2].startswith("client[0]")
    assert all(int(c.split("/")[0]) > 0 for c in rows[2].split()[-2:])
