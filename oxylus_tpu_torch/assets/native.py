"""ctypes bindings for the native C++ geometry kernels (counterpart of
`oxylus_tpu/assets/native.py`).

The library is built at first use from the repo's `native/geometry.cpp` with the
JAX package's `g++` line, into the port's git-ignored `oxylus_tpu_torch/build/`
(named by a hash of the source, so an edited source is rebuilt); nothing is
written into `native/`. This is host asset code, not a device kernel: as in the
JAX package, when the build fails the bake falls back to its NumPy paths, and
`bake_path()` says which one ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

log = logging.getLogger("oxylus_torch.native")

_SRC = Path(__file__).resolve().parent.parent.parent / "native" / "geometry.cpp"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
_GXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        digest = hashlib.sha256(" ".join(_GXX).encode() + _SRC.read_bytes()).hexdigest()[:16]
        so = _BUILD_DIR / f"liboxgeom_{digest}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run([*_GXX, str(_SRC), "-o", str(tmp)], check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ox_build_meshlets.restype = ctypes.c_int
        lib.ox_build_meshlets.argtypes = [
            f32p, ctypes.c_int, u32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            u32p, u32p, u32p, u32p, u32p, u8p,
        ]
        lib.ox_simplify.restype = ctypes.c_int
        lib.ox_simplify.argtypes = [
            f32p, ctypes.c_int, u32p, ctypes.c_int, ctypes.c_int, ctypes.c_float, u32p, f32p,
        ]
        _LIB = lib
        log.info("native geometry library loaded from %s", so)
    except (OSError, subprocess.SubprocessError) as exc:
        log.warning("native geometry library unavailable (%s); using the NumPy bake", exc)
        _LIB = None
    return _LIB


def available() -> bool:
    """Whether the C++ geometry library builds and loads here."""
    return _load() is not None


def bake_path() -> str:
    """`"native"` when the C++ kernels bake, `"numpy"` when the fallbacks do."""
    return "native" if _load() is not None else "numpy"


def _u32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _f32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def build_meshlets_native(positions: np.ndarray, indices: np.ndarray, max_verts=64, max_tris=64):
    """Returns the raw meshlet tables or None if native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32)
    nt = len(indices) // 3
    cap = max(nt, 1)
    mvo = np.zeros(cap, np.uint32)
    mvc = np.zeros(cap, np.uint32)
    mto = np.zeros(cap, np.uint32)
    mtc = np.zeros(cap, np.uint32)
    indirect = np.zeros(max(len(indices), 1), np.uint32)
    local = np.zeros((max(len(indices), 1),), np.uint8)
    n = lib.ox_build_meshlets(
        _f32(positions), len(positions), _u32(indices), len(indices),
        max_verts, max_tris,
        _u32(mvo), _u32(mvc), _u32(mto), _u32(mtc), _u32(indirect),
        local.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    total_v = int(mvo[n - 1] + mvc[n - 1]) if n else 0
    total_t = int(mto[n - 1] + mtc[n - 1]) if n else 0
    return mvo[:n], mvc[:n], mto[:n], mtc[:n], indirect[:total_v], local[: total_t * 3].reshape(-1, 3)


def simplify_native(positions: np.ndarray, indices: np.ndarray, target_index_count: int, max_error: float = 1e30):
    """QEM simplify. Returns (new_indices, error) or None if native is unavailable."""
    lib = _load()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.uint32)
    out = np.zeros(max(len(indices), 3), np.uint32)
    err = np.zeros(1, np.float32)
    n = lib.ox_simplify(
        _f32(positions), len(positions), _u32(indices), len(indices),
        int(target_index_count), ctypes.c_float(max_error), _u32(out), _f32(err),
    )
    return out[:n].copy(), float(err[0])
