"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` source has a plain C interface and becomes one shared library,
compiled with ``nvcc`` for sm_90a at first use into ``build/`` at the
repository root (one file per hash of the source and the headers it may
include) and loaded with ``ctypes``.  :func:`build_all` starts one ``nvcc``
per source at the same time.  There is no fallback: a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

__all__ = ["SOURCES", "build_all", "load_library", "load_variants", "build_logs", "sass_count", "count_in_functions"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("edge_kernel", "fused_attention")

_LIBS: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output (ptxas -v) per source built by this process


def _target(name: str, defines: Sequence[str] = ()) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(defines).encode())
    return _BUILD_DIR / f"{name}_{h.hexdigest()[:12]}.so"


def _start(name: str, so: Path, defines: Sequence[str] = ()) -> Tuple[subprocess.Popen, str]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(_CSRC / f"{name}.cu")] + [f"-D{d}" for d in defines]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def build_all(names: Sequence[str] = SOURCES) -> float:
    """Compile every source of ``names`` that has no library yet, all at the
    same time, and load them; returns the seconds spent."""
    t0 = time.perf_counter()
    todo: List[Tuple[str, Path]] = [(n, _target(n)) for n in names if n not in _LIBS]
    running = [(n, so, *_start(n, so)) for n, so in todo if not so.exists()]
    failed = []
    for name, so, proc, tmp in running:
        out, _ = proc.communicate()
        build_logs[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, so in todo:
        _LIBS[name] = ctypes.CDLL(str(so))
    return time.perf_counter() - t0


def load_variants(name: str, variants: Sequence[Sequence[str]]) -> List[ctypes.CDLL]:
    """``csrc/<name>.cu`` built once per set of preprocessor defines in
    ``variants`` (all at the same time) and loaded: for measurements that
    compare a kernel with and without a phase.  The libraries do not replace
    the one :func:`load_library` returns."""
    targets = [_target(name, d) for d in variants]
    running = [(so, *_start(name, so, d)) for so, d in zip(targets, variants) if not so.exists()]
    for so, proc, tmp in running:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n{out}")
        os.replace(tmp, so)
    return [ctypes.CDLL(str(so)) for so in targets]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    if name not in _LIBS:
        build_all([name])
    return _LIBS[name]


def sass_count(name: str, mnemonic: str, function: str = "") -> int:
    """How many instructions of the built library of ``csrc/<name>.cu`` carry
    ``mnemonic`` in their SASS, by the toolkit's ``cuobjdump`` (raises where
    the toolkit has none); only in the functions whose (mangled) name holds
    ``function``, where given.  ``HGMMA`` is the tensor cores' warpgroup
    product."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(_target(name))], capture_output=True, text=True, check=True).stdout
    return count_in_functions(out, mnemonic, function)


def count_in_functions(sass: str, mnemonic: str, function: str = "") -> int:
    """The count of :func:`sass_count` in the text ``cuobjdump -sass`` printed:
    each function's code follows a line ``Function : <mangled name>``."""
    n, inside = 0, not function
    for line in sass.splitlines():
        head = line.strip()
        if head.startswith("Function :"):
            inside = function in head
        elif inside and mnemonic in line:
            n += 1
    return n
