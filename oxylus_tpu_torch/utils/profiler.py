"""Profiling: named zones + per-frame timing + torch.profiler trace capture
(counterpart of `oxylus_tpu/utils/profiler.py`).

The Tracy replacement: the reference force-includes `ZoneScoped` macros into every
function and wires GPU pass timing through vuk's profiling callbacks. Here:
- `zone(name)` / `@zoned` wrap host code in both a wall-clock accumulator and a
  `torch.profiler.record_function` range, so zones show up in PyTorch traces (where
  the JAX package opens a `jax.profiler.TraceAnnotation`);
- `frame_mark()` closes a frame (the `FrameMark` analog) and rolls per-zone stats;
- `start_trace/stop_trace` capture a device trace with `torch.profiler.profile`
  (Chrome trace format, written on stop).

A zone times the host with `perf_counter` and never synchronizes the card: on the
card a zone's time is the time to enqueue its work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class ZoneStats:
    calls: int = 0
    total_s: float = 0.0
    last_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.calls * 1e3 if self.calls else 0.0


@dataclass
class Profiler:
    enabled: bool = True
    frame_count: int = 0
    zones: dict[str, ZoneStats] = field(default_factory=lambda: defaultdict(ZoneStats))
    _frame_start: float = field(default_factory=time.perf_counter)
    frame_times: list[float] = field(default_factory=list)
    _trace: Any = None
    _trace_dir: Path | None = None

    @contextlib.contextmanager
    def zone(self, name: str):
        if not self.enabled:
            yield
            return
        import torch.profiler

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        dt = time.perf_counter() - t0
        z = self.zones[name]
        z.calls += 1
        z.total_s += dt
        z.last_s = dt

    def zoned(self, fn):
        name = getattr(fn, "__qualname__", getattr(fn, "__name__", "zone"))

        def wrapper(*a, **kw):
            with self.zone(name):
                return fn(*a, **kw)

        return wrapper

    def frame_mark(self) -> float:
        """Close the current frame; returns its wall time (FrameMark analog)."""
        now = time.perf_counter()
        dt = now - self._frame_start
        self._frame_start = now
        self.frame_count += 1
        self.frame_times.append(dt)
        if len(self.frame_times) > 240:
            self.frame_times = self.frame_times[-240:]
        return dt

    @property
    def fps(self) -> float:
        recent = self.frame_times[-60:]
        return len(recent) / sum(recent) if recent else 0.0

    def report(self) -> str:
        rows = [f"frames: {self.frame_count}  fps: {self.fps:.1f}"]
        for name, z in sorted(self.zones.items(), key=lambda kv: -kv[1].total_s):
            rows.append(f"{name:<40.40} {z.calls:>6}  {z.mean_ms:8.3f} ms avg  {z.last_s * 1e3:8.3f} ms last")
        return "\n".join(rows)

    # device trace capture (Chrome trace format, loadable in Perfetto or TensorBoard)
    def start_trace(self, log_dir: str) -> None:
        import torch
        import torch.profiler

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._trace_dir = Path(log_dir)
        self._trace = torch.profiler.profile(activities=activities)
        self._trace.__enter__()

    def stop_trace(self) -> Path:
        """End the capture and write `<log_dir>/trace.json`; returns its path."""
        if self._trace is None:
            raise RuntimeError("no trace started")
        trace, self._trace = self._trace, None
        trace.__exit__(None, None, None)
        self._trace_dir.mkdir(parents=True, exist_ok=True)
        path = self._trace_dir / "trace.json"
        trace.export_chrome_trace(str(path))
        return path


PROFILER = Profiler()
zone = PROFILER.zone
zoned = PROFILER.zoned
frame_mark = PROFILER.frame_mark
