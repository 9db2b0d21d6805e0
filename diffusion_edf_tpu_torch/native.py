"""ctypes binding for the native (C++) host-side voxel downsample (the
JAX package's ``native.py``, with its one routine the port calls; host
code, no framework).

Loads ``native/libedf_native.so`` at the repository root (built by ``make -C
native`` the first time it is missing, when a toolchain is present);
``voxel_downsample`` returns None when the library is unavailable, and the
caller falls back to numpy.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["voxel_downsample"]

_LIB = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_native_dir(), "libedf_native.so")
    if not os.path.exists(so):
        try:
            subprocess.run(
                ["make", "-C", _native_dir()], check=True, capture_output=True, timeout=120
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
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
    """Native voxel downsample; returns None if the library is unavailable
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

