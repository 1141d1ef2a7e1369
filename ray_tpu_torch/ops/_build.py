"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface, under ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``).  The library's file name carries a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and a stale library is never loaded.  Nothing
here runs at import: the CPU-only test machine imports this module and has
no nvcc.
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
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.RLock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds its nvcc ran, or 0.0 when a built library was found;
#          the compiler's output, where -Xptxas=-v reports each kernel's
#          registers, shared memory and spills)
build_info: Dict[str, Tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source on the machine with the card"
    )


def _library(name: str) -> Path:
    # the source, the shared headers it may include, and the flags
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    parts.append(" ".join(NVCC_FLAGS).encode())
    digest = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _build_missing(names: Iterable[str]) -> None:
    """Start one nvcc per source whose library is missing, all at once,
    and wait for every one of them."""
    started = {}
    for name in names:
        out = _library(name)
        if name in _loaded or name in started:
            continue
        if out.exists():
            build_info[name] = (0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        started[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        build_info[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """The shared libraries built from ``csrc/<name>.cu`` for each name,
    building the missing ones in parallel."""
    names = list(names)
    with _lock:
        _build_missing(names)
        for name in names:
            if name not in _loaded:
                _loaded[name] = ctypes.CDLL(str(_library(name)))
        return {name: _loaded[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``."""
    lib = _loaded.get(name)
    return lib if lib is not None else load_all([name])[name]
