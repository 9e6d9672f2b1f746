"""The port's app core against the JAX package's: events, jobs, VFS, slot map, the
`App` lifecycle and its module registry, deferred tasks, input, projects, the
window's uint8 conversion, the CVar view and the profiler. Each case runs the same
calls through both packages' modules and compares what they record."""

import importlib
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

PKGS = ("oxylus_tpu", "oxylus_tpu_torch")


def loader(pkg):
    """`path` → the module at `path` in package `pkg`."""
    return lambda path: importlib.import_module(f"{pkg}.{path}")


def mods(path):
    """The module at `path` in each package: (JAX, port)."""
    return tuple(loader(pkg)(path) for pkg in PKGS)


# ---------------------------------------------------------------- scenarios
# Each takes one package's modules (through `m(path)`) and returns what it saw.


class Ping:
    def __init__(self, v):
        self.v = v


class Pong:
    pass


def events_case(m):
    es = m("core.events").EventSystem()
    log = []
    h1 = es.subscribe(Ping, lambda e: log.append(("a", e.v)))
    es.subscribe(Ping, lambda e: log.append(("b", e.v)))
    es.subscribe(Pong, lambda e: log.append(("pong",)))
    out = [es.emit(Ping(1)), es.emit(Pong()), es.emit(3.0)]
    out.append(es.unsubscribe(Ping, h1))
    out.append(es.unsubscribe(Ping, h1))
    out.append(es.emit(Ping(2)))
    counter = []
    lock = threading.Lock()

    def bump(e):
        with lock:
            counter.append(e.v)

    es.subscribe(Ping, bump)
    threads = [threading.Thread(target=lambda k=k: [es.emit(Ping(k)) for _ in range(50)]) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out.append(sorted(counter))
    es.clear()
    out.append(es.emit(Ping(9)))
    return out, log[:4]


def jobs_case(m):
    J = m("core.jobs")
    jm = J.JobManager(workers=3)
    jm.init()
    try:
        out = [jm.num_workers, jm.submit(lambda: 6 * 7, name="answer").result()]
        barrier = J.Barrier()
        hits = []
        for i in range(5):
            jm.submit(lambda i=i: hits.append(i), barrier=barrier)
        barrier.wait()
        out += [sorted(hits), barrier.pending]
        out.append(jm.for_each(list(range(37)), lambda x: x * x))
        seen = []
        lock = threading.Lock()

        def add(x):
            with lock:
                seen.append(x)

        jm.for_each_async(list(range(13)), add).wait()
        out.append(sorted(seen))
        gate, started = threading.Event(), threading.Event()

        def blocked():
            started.set()
            gate.wait(10)

        fut = jm.submit(blocked, name="blocked-job")
        started.wait(10)
        out.append(jm.tracker.active_jobs())
        gate.set()
        fut.result()
        out.append(jm.tracker.active_jobs())
        jm.wait()
        out.append(jm.submit(lambda: "after wait").result())
    finally:
        jm.deinit()
    return out


def slotmap_case(m):
    S = m("utils.slotmap")
    sm = S.SlotMap()
    a, b, c = sm.create_slot("a"), sm.create_slot("b"), sm.create_slot("c")
    out = [a, b, c, len(sm), sm.slot(b), sm.destroy_slot(b), sm.destroy_slot(b), sm.is_valid(b), sm.slot(b)]
    d = sm.create_slot("d")  # reuses b's index with a new version
    out += [d, S.id_index(d) == S.id_index(b), S.id_version(d), sm.set_slot(d, "D"), sm.set_slot(b, "x")]
    out += [list(sm.items()), len(sm), S.pack_id(7, 9), S.INVALID_ID]
    return out


def vfs_case(m, tmp):
    V = m("core.vfs")
    vfs = V.VFS()
    vfs.mount_dir(V.APP_DIR, tmp)
    out = [V.APP_DIR, V.PROJECT_DIR, vfs.is_mounted(V.APP_DIR), vfs.is_mounted(V.PROJECT_DIR)]
    out += [vfs.resolve_physical_dir(V.APP_DIR), vfs.resolve_physical_dir(V.APP_DIR, "a/b.txt")]
    out += [vfs.resolve(f"{V.APP_DIR}://x/y"), vfs.resolve("/abs/path"), vfs.resolve("nope://z")]
    out += [vfs.unmount_dir(V.APP_DIR), vfs.unmount_dir(V.APP_DIR), vfs.resolve_physical_dir(V.APP_DIR)]
    return out


def app_case(m):
    A = m("core.app")
    log = []

    class Counter:
        def __init__(self):
            self.frames = 0

        def init(self, app):
            log.append("counter.init")

        def update(self, app, ts):
            self.frames += 1
            log.append(("counter.update", self.frames, ts.dt >= 0.0))

        def render(self, app):
            log.append("counter.render")

        def deinit(self, app):
            log.append("counter.deinit")

    class NeedsCounter:
        module_dependencies = (Counter,)

        def init(self, app):
            log.append(("needs.init", app.registry.get(Counter).frames))

        def deinit(self, app):
            log.append("needs.deinit")

    out = []
    app = A.App(["--x"])
    try:
        app.with_module(NeedsCounter())
    except RuntimeError as exc:
        out.append(("refused", "requires Counter" in str(exc)))
    counter = Counter()
    app.with_name("parity").with_workers(2).with_modules(counter, NeedsCounter())
    out += [app.name, app.args, app.job_manager.num_workers, A.App.get() is app]
    out += [A.App.mod(Counter) is counter, A.App.has_mod(NeedsCounter), A.App.has_mod(int)]
    app.defer_to_next_frame(lambda a: log.append(("deferred", counter.frames)))

    def callback(a, ts):
        log.append(("callback", counter.frames))
        if counter.frames == 1:
            a.defer_to_next_frame(lambda a: log.append(("deferred2", counter.frames)))
        return counter.frames < 3

    app.run(frames=10, frame_callback=callback)
    out += [counter.frames, app.is_running, app.cvars.names(), app.cvars.get("ctx.frame_limit")]
    app2 = A.App().with_module(Counter())
    app2.run(frames=2)
    out.append(app2.registry.get(Counter).frames)
    ts = A.Timestep()
    out.append(0.0 <= ts.on_update() <= ts.max_dt)
    return out, log


def input_case(m):
    I = m("core.input")
    inp = I.Input()
    inp.init()
    K, B = I.KeyCode, I.MouseButton
    out = []
    inp.inject_key_down(K.W)
    inp.inject_key_down(K.W)
    inp.inject_key_down(K.SPACE)
    inp.inject_mouse_down(B.LEFT)
    inp.inject_mouse_move(10.0, 4.0)
    inp.inject_mouse_move(13.0, 2.0)
    inp.inject_scroll(0.5, -1.0)
    inp.inject_gamepad(0, buttons={1: True}, axes={0: 0.25})
    inp.inject_gamepad(0, axes={1: -0.5})

    def snap():
        return [inp.get_key_held(K.W), inp.get_key_pressed(K.W), inp.get_key_released(K.W),
                inp.get_key_held(K.SPACE), inp.get_mouse_held(B.LEFT), inp.get_mouse_pressed(B.LEFT),
                inp.get_mouse_released(B.LEFT), inp.get_mouse_position(), inp.get_mouse_delta(),
                (inp.scroll_x, inp.scroll_y)]

    out.append(snap())
    inp.reset_pressed()
    out.append(snap())
    inp.inject_key_up(K.W)
    inp.inject_key_up(K.A)
    inp.inject_mouse_up(B.LEFT)
    out.append(snap())
    inp.set_cursor_state(I.CursorState.DISABLED)
    pad = inp.gamepads[0]
    out += [inp.cursor_state.value, pad.connected, pad.buttons, pad.axes, int(K.ESCAPE), int(K.LEFT)]
    return out


def cvars_case(m):
    cfg_mod = m("core.config")
    cfg = cfg_mod.RendererConfig()
    cv = cfg_mod.CVarSystem()
    cv.bind_dataclass("r", cfg)
    cv.bind_dataclass("ctx", cfg_mod.ContextConfig())
    cv.set("r.exposure", "1.5")
    cv.set("r.vbgtao_quality_level", 2.9)
    cv.set("r.fxaa_enable", 0)
    cv.set("ctx.frame_limit", 30)
    return [cv.names(), cv.get("r.exposure"), cfg.vbgtao_quality_level, cfg.fxaa_enable, cv.get("ctx.frame_limit"),
            cfg.to_json()]


def profiler_case(m):
    P = m("utils.profiler")
    prof = P.Profiler()
    for _ in range(3):
        with prof.zone("outer"):
            with prof.zone("inner"):
                pass
        prof.frame_mark()
    f = prof.zoned(lambda x: x + 1)
    out = [f(1), f(2)]
    prof.enabled = False
    with prof.zone("off"):
        pass
    out += [prof.frame_count, {k: z.calls for k, z in prof.zones.items()}, len(prof.frame_times), prof.fps > 0]
    out.append([row.split()[0] for row in prof.report().splitlines()[1:]].count("outer"))
    return out


CASES = {
    "events": events_case, "jobs": jobs_case, "slotmap": slotmap_case, "app": app_case,
    "input": input_case, "cvars": cvars_case, "profiler": profiler_case,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_behaviour_as_jax(name):
    jax_out, port_out = (CASES[name](loader(pkg)) for pkg in PKGS)
    assert port_out == jax_out


def test_vfs_matches_jax(tmp_path):
    jax_out, port_out = (vfs_case(loader(pkg), tmp_path) for pkg in PKGS)
    assert port_out == jax_out


def test_app_rejects_a_module_before_its_dependency():
    for A in mods("core.app"):
        class Dep:
            pass

        class Needs:
            module_dependencies = (Dep,)

        with pytest.raises(RuntimeError, match="register it first"):
            A.App().with_module(Needs())


@pytest.mark.parametrize("writer", PKGS)
def test_project_files_read_in_both_packages(tmp_path, writer):
    """A project written by either package loads in both with the same config, and
    mounting it scans its assets through each package's asset manager."""
    (jproj, tproj), (jvfs, tvfs), (jman, tman) = mods("core.project"), mods("core.vfs"), mods("assets.manager")
    P = jproj if writer == "oxylus_tpu" else tproj
    cfg = P.ProjectConfig(name="Demo", start_scene="main.oxscene", asset_directory="Assets", module_name="game")
    path = P.Project(cfg, directory=tmp_path).save(tmp_path / "demo.oxproj")
    assets = tmp_path / "Assets"
    assets.mkdir()
    (assets / "hello.py").write_text("x = 1\n")
    (assets / "notes.txt").write_text("not an asset")
    got = []
    for proj, V, M in ((jproj, jvfs, jman), (tproj, tvfs, tman)):
        loaded = proj.Project.load(path)
        vfs = V.VFS()
        uuids = loaded.mount(vfs, M.AssetManager())
        got.append((vars(loaded.config), loaded.directory, loaded.asset_path,
                    vfs.resolve_physical_dir(V.PROJECT_DIR), len(uuids)))
    assert got[0] == got[1]
    assert got[1][0]["name"] == "Demo" and got[1][4] == 1


def test_project_start_scene_loads_on_the_named_device(tmp_path):
    from oxylus_tpu_torch.core.project import Project, ProjectConfig
    from oxylus_tpu_torch.scene.scene import Scene
    from oxylus_tpu_torch.scene.serialize import save_to_file

    (tmp_path / "Assets").mkdir()
    s = Scene("start", device="cpu")
    s.create_entity("e").add("TransformComponent", position=(1.0, 2.0, 3.0))
    save_to_file(s, tmp_path / "Assets" / "main.oxscene")
    proj = Project(ProjectConfig(start_scene="main.oxscene"), directory=tmp_path)
    loaded = proj.load_start_scene(device="cpu")
    assert loaded.scene_name == "start" and loaded.device == torch.device("cpu")
    assert loaded.entity("e").get("TransformComponent")["position"].tolist() == [1.0, 2.0, 3.0]


def _frames():
    rng = np.random.default_rng(17)
    f = rng.uniform(-0.25, 1.25, (6, 7, 3)).astype(np.float32)
    # the conversion's edges: exact multiples of 1/255 and their neighbours
    k = np.arange(256, dtype=np.float32) / np.float32(255)
    edges = np.stack([k, np.nextafter(k, np.float32(-1)), np.nextafter(k, np.float32(2))], -1)
    return {
        "rgb": f,
        "rgba": rng.uniform(0.0, 1.0, (5, 4, 4)).astype(np.float32),
        "edges": edges.reshape(16, 16, 3),
        "f64": rng.uniform(-0.1, 1.1, (3, 5, 3)),
        "u8": rng.integers(0, 256, (4, 4, 4), dtype=np.uint8),
    }


@pytest.mark.parametrize("kind", sorted(_frames()))
def test_window_present_matches_jax(kind):
    """The port converts on the frame's device, the JAX window on the host: the
    uint8 frames are equal."""
    frame = _frames()[kind]
    jwin_mod, twin_mod = mods("core.window")
    jw, tw = jwin_mod.Window(4, 4), twin_mod.Window(4, 4)
    jw.present(frame)
    tw.present(torch.from_numpy(frame))
    assert tw.latest_frame.dtype == np.uint8 and tw.latest_frame.shape == frame.shape
    np.testing.assert_array_equal(tw.latest_frame, jw.latest_frame)
    assert tw.presented_frames == jw.presented_frames == 1


def test_window_resize_event_and_png(tmp_path):
    from PIL import Image

    from oxylus_tpu_torch.core.events import EventSystem
    from oxylus_tpu_torch.core.window import Window, WindowResizeEvent

    es, seen = EventSystem(), []
    es.subscribe(WindowResizeEvent, lambda e: seen.append((e.width, e.height)))
    w = Window(8, 6)
    w.resize(16, 9, event_system=es)
    assert seen == [(16, 9)] and w.extent == (16, 9)
    with pytest.raises(RuntimeError):
        w.save_png(tmp_path / "none.png")
    frame = _frames()["rgb"]
    w.present(frame)  # a host array is accepted too
    back = np.asarray(Image.open(w.save_png(tmp_path / "f.png")))
    np.testing.assert_array_equal(back, w.latest_frame)


def test_profiler_trace_capture_writes_a_trace(tmp_path):
    from oxylus_tpu_torch.utils.profiler import Profiler

    prof = Profiler()
    prof.start_trace(str(tmp_path / "trace"))
    with prof.zone("traced_zone"):
        torch.ones(4).sum()
    path = prof.stop_trace()
    assert path.exists() and "traced_zone" in path.read_text()
