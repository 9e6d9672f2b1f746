"""Versioned slot map: u64 ids packing a 32-bit version and 32-bit index
(a copy of `oxylus_tpu/utils/slotmap.py`).

Analog of the reference's `SlotMap<T, ID>` (`Oxylus/include/Memory/SlotMap.hpp:22-41`):
stale handles are detected by version mismatch; slots are reused from a free list.
Thread-safe. Used by the asset registry.
"""

from __future__ import annotations

import threading
from typing import Any, Generic, Iterator, TypeVar

T = TypeVar("T")

INVALID_ID = 0xFFFFFFFF_FFFFFFFF


def pack_id(version: int, index: int) -> int:
    return ((version & 0xFFFFFFFF) << 32) | (index & 0xFFFFFFFF)


def id_version(sid: int) -> int:
    return (sid >> 32) & 0xFFFFFFFF


def id_index(sid: int) -> int:
    return sid & 0xFFFFFFFF


class SlotMap(Generic[T]):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._values: list[Any] = []
        self._versions: list[int] = []
        self._free: list[int] = []

    def create_slot(self, value: T) -> int:
        with self._lock:
            if self._free:
                idx = self._free.pop()
                self._values[idx] = value
            else:
                idx = len(self._values)
                self._values.append(value)
                self._versions.append(1)
            return pack_id(self._versions[idx], idx)

    def destroy_slot(self, sid: int) -> bool:
        with self._lock:
            idx = id_index(sid)
            if not self._is_valid_locked(sid, idx):
                return False
            self._values[idx] = None
            self._versions[idx] = (self._versions[idx] + 1) & 0xFFFFFFFF
            self._free.append(idx)
            return True

    def _is_valid_locked(self, sid: int, idx: int) -> bool:
        return 0 <= idx < len(self._values) and self._versions[idx] == id_version(sid) and idx not in self._free

    def is_valid(self, sid: int) -> bool:
        with self._lock:
            return self._is_valid_locked(sid, id_index(sid))

    def slot(self, sid: int) -> T | None:
        with self._lock:
            idx = id_index(sid)
            if not self._is_valid_locked(sid, idx):
                return None
            return self._values[idx]

    def set_slot(self, sid: int, value: T) -> bool:
        with self._lock:
            idx = id_index(sid)
            if not self._is_valid_locked(sid, idx):
                return False
            self._values[idx] = value
            return True

    def __len__(self) -> int:
        with self._lock:
            return len(self._values) - len(self._free)

    def items(self) -> Iterator[tuple[int, T]]:
        with self._lock:
            snapshot = [
                (pack_id(self._versions[i], i), v)
                for i, v in enumerate(self._values)
                if v is not None and i not in self._free
            ]
        return iter(snapshot)
