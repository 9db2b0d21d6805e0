"""ctypes binding for the native (C++) host-side voxel downsample (the
JAX package's ``native.py``, with its one routine the port calls; host
code, no framework).

The library is compiled from ``native/pointcloud.cpp`` by ``g++`` at first
use into ``build/`` at the repository root, as ``nn/cuda_build.py`` builds
the CUDA kernels: into a temporary file, then renamed (``os.replace``) to
a name keyed on the hash of the source, the flags and the host's CPU (the
flags hold ``-march=native``).  Processes that build at the same time each
rename a whole library; none loads a file another is still writing.
``voxel_downsample`` returns None when no ``g++`` is present, and the
caller then runs the numpy path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["voxel_downsample", "build_library"]

_ROOT = Path(__file__).resolve().parents[1]
_SOURCE = _ROOT / "native" / "pointcloud.cpp"
_BUILD_DIR = _ROOT / "build"
_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]  # native/Makefile's

_LIB = None
_TRIED = False


def _cpu_tag() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"".join(line for line in f if line.startswith((b"model name", b"flags")))
    except OSError:
        return b""


def build_library() -> Path:
    """The path of the built library in ``build/``, compiled first if it is
    missing; raises if ``g++`` fails."""
    build_dir = _BUILD_DIR
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    h.update(_cpu_tag())
    so = build_dir / f"edf_native_{h.hexdigest()[:12]}.so"
    if so.exists():
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *_FLAGS, "-o", tmp, str(_SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if shutil.which(os.environ.get("CXX", "g++")) is None:
        return None
    lib = ctypes.CDLL(str(build_library()))
    lib.voxel_downsample.restype = ctypes.c_int
    lib.voxel_downsample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
    ]
    _LIB = lib
    return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def voxel_downsample(
    points: np.ndarray, colors: np.ndarray, voxel_size: float, coord_reduction: str = "average"
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native voxel downsample; returns None if there is no compiler
    (caller falls back to numpy).  Output order matches the numpy path
    (lexicographic voxel order)."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    cols = np.ascontiguousarray(colors, dtype=np.float32)
    n = len(pts)
    out_p = np.empty((n, 3), dtype=np.float32)
    out_c = np.empty((n, 3), dtype=np.float32)
    m = lib.voxel_downsample(
        _fptr(pts), _fptr(cols), n, float(voxel_size),
        1 if coord_reduction == "center" else 0, _fptr(out_p), _fptr(out_c), n,
    )
    if m < 0:
        return None
    return out_p[:m].copy(), out_c[:m].copy()
