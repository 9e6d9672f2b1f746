"""Build and load the port's CUDA kernels.

The sources under `physics/csrc/`, `ops/csrc/` and `probes/csrc/` are compiled at first use
with `nvcc` (`-gencode arch=compute_90a,code=sm_90a`), one `nvcc` process per
source, all started together, then linked into one shared library with a plain
C interface in `oxylus_tpu_torch/build/` (ignored by git) and loaded with
ctypes. The library file is named by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing here runs at
import: the CPU tests import every module on machines without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIRS = (PKG_DIR / "physics" / "csrc", PKG_DIR / "ops" / "csrc", PKG_DIR / "probes" / "csrc")
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add contraction: products and sums round separately,
    # as the plain PyTorch versions' separate tensor ops do
    "-fmad=false",
    "-Xcompiler", "-fPIC",
]

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is installed")


def _run(procs: list[tuple[list[str], subprocess.Popen]], verbose: bool) -> None:
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
        elif verbose:
            print(out + err)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_kernel_library(verbose: bool = False) -> Path:
    """Compile every `csrc/*.cu` (once per source hash) and return the .so path.
    With `verbose`, also print ptxas' register and spill report."""
    sources = sorted(p for d in CSRC_DIRS for p in d.glob("*.cu"))
    headers = sorted(p for d in CSRC_DIRS for p in d.glob("*.cuh"))
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    digest = h.hexdigest()[:16]
    lib_path = BUILD_DIR / f"liboxylus_kernels_{digest}.so"
    if lib_path.exists() and not verbose:
        return lib_path
    obj_dir = BUILD_DIR / f"obj_{digest}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs, procs = [], []
    for src in sources:
        obj = obj_dir / f"{src.parent.parent.name}_{src.stem}.o"
        cmd = [nvcc, *flags, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    _run(procs, verbose)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp), *map(str, objs)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))], False)
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
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
        lib.dense_workspace_bytes.argtypes = [ci]
        lib.dense_workspace_bytes.restype = ctypes.c_size_t
        lib.dense_substeps.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        lib.dense_substeps.restype = ci
        lib.banded_workspace_bytes.argtypes = [ci]
        lib.banded_workspace_bytes.restype = ctypes.c_size_t
        lib.banded_substeps.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, ci, ci, vp]
        lib.banded_substeps.restype = ci
        lib.kernel_error_string.argtypes = [ci]
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.raster_tiles.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp]
        lib.raster_tiles.restype = ci
        lib.hiz_build.argtypes = [vp, ci, ci, ci, ci, ci, vp, vp, vp, vp]
        lib.hiz_build.restype = ci
        lib.raster_depth.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp]
        lib.raster_depth.restype = ci
        lib.blend2d.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp]
        lib.blend2d.restype = ci
        lib.raster_groups.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp, vp, vp, vp]
        lib.raster_groups.restype = ci
        lib.raster_groups_info.argtypes = [ci, ci, vp]
        lib.raster_groups_info.restype = ci
        lib.blend2d_info.argtypes = [ci, ci, ci, vp]
        lib.blend2d_info.restype = ci
        # the Hopper probes (probes/csrc)
        for name, args in (
            ("probe_dynslice", [vp, vp, vp]),
            ("probe_dot_rhs_t", [vp, ci, vp, ci, vp]),
            ("probe_take_lanes", [vp, vp, vp, ci, ci, ci]),
            ("probe_take_rows", [vp, vp, vp, ci, ci, ci]),
            ("probe_scan", [vp, vp, ci, ci, ci, ci]),
            ("probe_sort_rows", [vp, vp, ci, ci]),
            ("probe_argmax_rows", [vp, vp, ci, ci]),
            ("probe_roll_lanes", [vp, vp, ci, ci, ci]),
            ("probe_bf16_mul_add", [vp, vp, ctypes.c_longlong]),
            ("probe_roll_chain", [vp, vp, ci, ci, vp, ci, ci, ci]),
            ("probe_vector_chain", [vp, vp, ci, ci]),
            ("probe_matmul_f32", [vp, vp, vp, vp] + [ci] * 10),
            ("probe_matmul_bf16", [vp, vp, vp, vp] + [ci] * 10),
            ("probe_argmax_extract", [vp, vp, ci, ci]),
            ("probe_dynamic_trip", [vp, vp, ci, vp]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = args + [vp]  # the stream last
            fn.restype = ci
        _LIB = lib
    return _LIB
