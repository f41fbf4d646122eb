"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Both sources
include the shared Hopper mainloop ``csrc/hopper_int8.cuh`` (TMA, mbarriers,
``wgmma``); ``cuTensorMapEncodeTiled`` is fetched through the runtime's
driver entry point, so no link flag is needed. The library lands in the
package's ``_build/`` directory (listed in ``.gitignore``) under a name that
carries a hash of the source, every ``csrc`` header it includes and the
flags, so an edited source or header never loads a stale build. Building
happens at first use; ``build_all`` starts one ``nvcc`` per source at once,
for a caller that wants every kernel ready up front.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Tuple

from ..resilience.errors import BackendError

__all__ = ["SOURCES", "build_all", "load_library", "BUILD_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
#: every kernel source of the port, by library name
SOURCES = {
    name: os.path.join(CSRC, f"{name}.cu")
    for name in ("packed_dir_allow", "fused_ports_reach")
}
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    """``nvcc`` from PATH, else from the CUDA toolkit (``CUDA_HOME``, by
    default ``/usr/local/cuda``, where torch.utils.cpp_extension looks too)."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise BackendError("nvcc not found: the CUDA kernels cannot be built",
                       backend="torch")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(path: str) -> List[str]:
    """``path`` and every ``csrc`` file it includes with ``#include "..."``,
    transitively, in the order first reached."""
    seen, todo = [], [path]
    while todo:
        p = todo.pop(0)
        if p in seen:
            continue
        seen.append(p)
        with open(p, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                q = os.path.join(CSRC, inc.decode())
                if os.path.exists(q):
                    todo.append(q)
    return seen


def _target(name: str) -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in _sources(SOURCES[name]):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _start(name: str, verbose: bool) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start ``nvcc`` for ``name`` unless its library is already built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, SOURCES[name]]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish(name: str, job) -> str:
    proc, tmp, target = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise BackendError(
            f"nvcc failed for {name} (exit {proc.returncode}):\n{log}",
            backend="torch",
        )
    os.replace(tmp, target)
    return log


def build_all(verbose: bool = False) -> Dict[str, Tuple[float, str]]:
    """Build every kernel not built yet, one ``nvcc`` per source, all at
    once. Returns ``{name: (seconds, compiler output)}`` for those built."""
    t0 = time.perf_counter()
    jobs: List[Tuple[str, object]] = []
    for name in SOURCES:
        job = _start(name, verbose)
        if job is not None:
            jobs.append((name, job))
    out = {}
    for name, job in jobs:
        log = _finish(name, job)
        out[name] = (time.perf_counter() - t0, log)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The library of kernel ``name``, built first if needed. Loading an
    already-loaded library returns the process's existing handle, so a call
    per launch costs microseconds and keeps no module state."""
    job = _start(name, verbose=False)
    if job is not None:
        _finish(name, job)
    return ctypes.CDLL(_target(name))
