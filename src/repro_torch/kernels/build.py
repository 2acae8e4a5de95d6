"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded through ``ctypes``.  Libraries go to
``build/repro_torch/`` at the repository root, named by a hash of the
source, every ``csrc/*.cuh`` header and the flags, so an edited source or
header never loads a stale library and an unchanged one is compiled once.
Nothing is built at import time: :func:`load` builds on first use, and
:func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

__all__ = ["SOURCES", "BUILD_DIR", "nvcc_path", "build_all", "load"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
SOURCES = ("binary_qmm", "fused_qmm", "popcount_qmm", "bitserial_qmm", "binary_attn")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``name -> (seconds, ptxas report)`` of the builds this process ran.
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    ``(target, tmp, process, t0)`` or ``(target, None, None, None)``."""
    target = _target(name)
    if target.exists():
        return target, None, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc, time.perf_counter()


def _finish(name: str, job) -> Path:
    target, tmp, proc, t0 = job
    if proc is None:
        return target
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    BUILD_LOG[name] = (time.perf_counter() - t0, out)
    return target


def build_all() -> Dict[str, Path]:
    """Compile every kernel source in parallel; returns ``name -> library``."""
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, job) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_finish(name, _start(name))))
            _LIBS[name] = lib
        return lib
