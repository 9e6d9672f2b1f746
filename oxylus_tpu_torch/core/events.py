"""Typed publish/subscribe event system (a copy of `oxylus_tpu/core/events.py`).

Analog of the reference's `EventSystem` (`Oxylus/include/Core/EventSystem.hpp:36-313`):
handlers keyed on the event *type*, thread-safe, subscription ids for targeted
unsubscribe. Event types are plain Python classes (usually dataclasses). Handlers run
on the emitting thread; one that touches a CUDA tensor from a worker thread must set
the device itself.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable, Type


class EventSystem:
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._handlers: dict[type, dict[int, Callable[[Any], None]]] = defaultdict(dict)
        self._next_id = 1

    def subscribe(self, event_type: Type, handler: Callable[[Any], None]) -> int:
        with self._lock:
            hid = self._next_id
            self._next_id += 1
            self._handlers[event_type][hid] = handler
            return hid

    def unsubscribe(self, event_type: Type, handler_id: int) -> bool:
        with self._lock:
            return self._handlers.get(event_type, {}).pop(handler_id, None) is not None

    def emit(self, event: Any) -> int:
        """Invoke all handlers registered for type(event). Returns handler count."""
        with self._lock:
            handlers = list(self._handlers.get(type(event), {}).values())
        for h in handlers:
            h(event)
        return len(handlers)

    def clear(self) -> None:
        with self._lock:
            self._handlers.clear()
