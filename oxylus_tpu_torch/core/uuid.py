"""128-bit asset UUIDs with string round-trip (a copy of `oxylus_tpu/core/uuid.py`,
which cannot be imported without JAX).

Mirrors `Oxylus/include/Core/UUID.hpp` (random 128-bit ids serialized as
canonical hyphenated hex strings via the flecs opaque-string binding at
`Oxylus/src/Scene/Components.cpp:40-47`). Stored SoA as two u64 words.
"""

from __future__ import annotations

import secrets
import uuid as _pyuuid

NIL = "00000000-0000-0000-0000-000000000000"


def generate_random() -> str:
    return str(_pyuuid.UUID(bytes=secrets.token_bytes(16)))


def is_valid(s: str) -> bool:
    try:
        _pyuuid.UUID(s)
        return True
    except (ValueError, AttributeError, TypeError):
        return False


def uuid_to_u64_pair(s: str | None) -> tuple[int, int]:
    """Canonical string → (hi, lo) u64 words. Empty/None → (0, 0)."""
    if not s:
        return (0, 0)
    v = _pyuuid.UUID(s).int
    return ((v >> 64) & 0xFFFFFFFFFFFFFFFF, v & 0xFFFFFFFFFFFFFFFF)


def u64_pair_to_uuid(hi: int, lo: int) -> str:
    v = (int(hi) << 64) | int(lo)
    return str(_pyuuid.UUID(int=v))


def is_nil_pair(hi: int, lo: int) -> bool:
    return int(hi) == 0 and int(lo) == 0
