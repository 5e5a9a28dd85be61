"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled by ``nvcc`` into its own shared library for Hopper
(``sm_90a``), loaded with `ctypes`.  No PyTorch header is included, so
a build takes seconds, not minutes.  Libraries land in ``build/`` beside
this file (listed in ``.gitignore``), named by a hash of their source so
that an edited source is never served by a stale library.  The first use
builds; a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build_all", "load"]

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: "dict[str, ctypes.CDLL]" = {}
# The compiler's report (registers, shared memory, spills) per kernel
# source, from the build this process ran or found.
build_logs: "dict[str, str]" = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        f"nvcc not found on PATH or at {fallback}: the CUDA kernels are "
        "built from source at first use"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(process, tmp, target)`` or None."""
    target = _target(name)
    if target.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    build_logs[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file


def build_all() -> "list[str]":
    """Build every kernel source at once, one ``nvcc`` per source, all
    started together; returns the names built or found."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib
