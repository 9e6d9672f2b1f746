"""Build and load the port's CUDA kernels.

The sources under `physics/csrc/` are compiled at first use with `nvcc` into a
shared library with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`),
placed in `oxylus_tpu_torch/build/` (ignored by git), and loaded with ctypes.
The library file is named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing here runs at import:
the CPU tests import every module on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "physics" / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add contraction: products and sums round separately,
    # as the plain PyTorch version's separate tensor ops do
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is installed")


def build_kernel_library(verbose: bool = False) -> Path:
    """Compile `physics/csrc/*.cu` (once per source hash) and return the .so path.
    With `verbose`, also print ptxas' register and spill report."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    lib_path = BUILD_DIR / f"liboxylus_kernels_{h.hexdigest()[:16]}.so"
    if lib_path.exists() and not verbose:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def load_kernel_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every C signature declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_kernel_library()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.compact_workspace_bytes.argtypes = [ci, ci, ci, ci]
        lib.compact_workspace_bytes.restype = ctypes.c_size_t
        lib.compact_error_string.argtypes = [ci]
        lib.compact_error_string.restype = ctypes.c_char_p
        lib.compact_substeps.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, ci, ci, vp]
        lib.compact_substeps.restype = ci
        _LIB = lib
    return _LIB
