"""App runtime: module registry, main loop, timestep, deferred tasks (a copy of
`oxylus_tpu/core/app.py`).

Analogs of the reference L1 runtime:
- `ModuleRegistry` (`Oxylus/include/Core/ModuleRegistry.hpp:15-121`): type-keyed
  module store with declared dependencies checked fatally at add() time, and
  init/update/render/deinit callback lists run in registration order.
- `ox::App` (`Core/App.hpp:23-125`, `src/Core/App.cpp:40-204`): fluent set-up
  (`App().with_name(...).with_modules(...).run()`), init → step loop → stop,
  `defer_to_next_frame`, frame limiter, core services (VFS, JobManager, EventSystem).

The loop is headless — there is no swapchain; "render" modules produce frames
(tensors on the card) that callers present to a `Window` or encode. The loop, its
modules and its frame callback all run on the calling thread.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Type

from .config import ContextConfig, CVarSystem
from .events import EventSystem
from .jobs import JobManager
from .vfs import VFS, APP_DIR

log = logging.getLogger("oxylus.app")


class Timestep:
    """Frame clock with optional frame limiting (`App.cpp:82-89`)."""

    def __init__(self) -> None:
        self._last = time.perf_counter()
        self.dt = 0.0
        self.elapsed = 0.0
        self.max_dt = 0.25  # clamp huge stalls

    def on_update(self, frame_limit_hz: float = 0.0) -> float:
        now = time.perf_counter()
        if frame_limit_hz > 0.0:
            min_dt = 1.0 / frame_limit_hz
            while now - self._last < min_dt:
                time.sleep(max(0.0, min_dt - (now - self._last)) * 0.5)
                now = time.perf_counter()
        self.dt = min(now - self._last, self.max_dt)
        self._last = now
        self.elapsed += self.dt
        return self.dt


class ModuleRegistry:
    def __init__(self, app: "App") -> None:
        self.app = app
        self._modules: dict[type, Any] = {}
        self._order: list[Any] = []

    def add(self, module: Any) -> Any:
        deps = getattr(type(module), "module_dependencies", ())
        for dep in deps:
            if dep not in self._modules:
                raise RuntimeError(
                    f"Module {type(module).__name__} requires {dep.__name__}; "
                    f"register it first (registration order matters)"
                )
        self._modules[type(module)] = module
        self._order.append(module)
        return module

    def get(self, mod_type: Type) -> Any:
        return self._modules[mod_type]

    def has(self, mod_type: Type) -> bool:
        return mod_type in self._modules

    def init_all(self) -> None:
        for m in self._order:
            if hasattr(m, "init"):
                m.init(self.app)

    def update_all(self, ts: Timestep) -> None:
        for m in self._order:
            if hasattr(m, "update"):
                m.update(self.app, ts)

    def render_all(self) -> None:
        for m in self._order:
            if hasattr(m, "render"):
                m.render(self.app)

    def deinit_all(self) -> None:
        for m in reversed(self._order):
            if hasattr(m, "deinit"):
                m.deinit(self.app)

    def __iter__(self):
        return iter(self._order)


class App:
    _instance: "App | None" = None

    def __init__(self, args: list[str] | None = None) -> None:
        self.name = "oxylus_tpu app"
        self.args = args or []
        self.vfs = VFS()
        self.job_manager = JobManager()
        self.event_system = EventSystem()
        self.cvars = CVarSystem()
        self.context_config = ContextConfig()
        self.timestep = Timestep()
        self.registry = ModuleRegistry(self)
        self.is_running = False
        self._deferred: list[Callable[["App"], None]] = []
        self._frame_cb: Callable[["App", Timestep], bool] | None = None
        App._instance = self

    # ----------------------------------------------------------------- fluent set-up
    def with_name(self, name: str) -> "App":
        self.name = name
        return self

    def with_workers(self, n: int) -> "App":
        self.job_manager = JobManager(workers=n)
        return self

    def with_working_directory(self, path) -> "App":
        self.vfs.mount_dir(APP_DIR, path)
        return self

    def with_module(self, module: Any) -> "App":
        self.registry.add(module)
        return self

    def with_modules(self, *modules: Any) -> "App":
        for m in modules:
            self.registry.add(m)
        return self

    # aliases matching the reference's fluent spelling
    with_ = with_module

    # ----------------------------------------------------------------- accessors
    @classmethod
    def get(cls) -> "App":
        assert cls._instance is not None, "No App constructed"
        return cls._instance

    @classmethod
    def mod(cls, mod_type: Type) -> Any:
        return cls.get().registry.get(mod_type)

    @classmethod
    def has_mod(cls, mod_type: Type) -> bool:
        return cls._instance is not None and cls.get().registry.has(mod_type)

    def defer_to_next_frame(self, fn: Callable[["App"], None]) -> None:
        self._deferred.append(fn)

    # ----------------------------------------------------------------- lifecycle
    def init(self) -> "App":
        self.job_manager.init()
        self.cvars.bind_dataclass("ctx", self.context_config)
        self.registry.init_all()
        return self

    def step(self) -> None:
        self.timestep.on_update(self.context_config.frame_limit)
        deferred, self._deferred = self._deferred, []
        for fn in deferred:
            fn(self)
        self.registry.update_all(self.timestep)
        self.registry.render_all()

    def run(self, frames: int | None = None, frame_callback=None) -> None:
        """Main loop. `frames` bounds the loop (None = until stop()); `frame_callback`
        (app, ts) -> bool runs each frame, returning False stops."""
        self.init()
        self.is_running = True
        count = 0
        try:
            while self.is_running:
                self.step()
                count += 1
                if frame_callback is not None and frame_callback(self, self.timestep) is False:
                    break
                if frames is not None and count >= frames:
                    break
        finally:
            self.stop()

    def stop(self) -> None:
        if not self.is_running:
            return
        self.is_running = False
        deferred, self._deferred = self._deferred, []
        for fn in deferred:
            fn(self)
        self.registry.deinit_all()
        self.job_manager.deinit()
