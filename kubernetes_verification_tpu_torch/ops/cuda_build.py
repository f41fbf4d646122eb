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

The built libraries are the port's warm state: ``observe/aot.py`` ships
them in a checkpoint's kernel pack and installs them into ``_build/`` under
their target names (``target_name``) in a process that recovers it, so that
``load_library`` finds them and runs no compiler. Every library lookup is
counted in ``kvtpu_aot_cache_hits_total`` / ``_misses_total{engine="cuda",
fn=<name>}``: a library a process loads without running the compiler is a
hit (once per process), every ``nvcc`` run a miss (``reason="cold"``);
``counts()`` returns the same per process.
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

from ..observe.metrics import AOT_CACHE_HITS_TOTAL, AOT_CACHE_MISSES_TOTAL
from ..resilience.errors import BackendError

__all__ = [
    "SOURCES",
    "BUILD_DIR",
    "build_all",
    "built_libraries",
    "counts",
    "forget_loaded",
    "load_library",
    "nvcc_version",
    "target_name",
]

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


def target_name(name: str) -> str:
    """The file name kernel ``name``'s library has in ``_build/``: it
    carries the hash of its sources, their headers and the flags."""
    return os.path.basename(_target(name))


def built_libraries() -> Dict[str, str]:
    """``{name: path}`` of every kernel whose library for the current
    sources is in ``_build/``."""
    out = {}
    for name in SOURCES:
        path = _target(name)
        if os.path.exists(path):
            out[name] = path
    return out


def nvcc_version() -> Optional[str]:
    """The last line of ``nvcc --version`` (its release and build), or
    ``None`` when no ``nvcc`` is reachable."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (BackendError, OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[-1] if lines else None


#: per process: libraries loaded (by target path), those this process
#: compiled, and the counts behind ``counts()``
_HANDLES: Dict[str, ctypes.CDLL] = {}
_COMPILED: set = set()
_COUNTS = {"nvcc_runs": 0, "hits": 0}


def counts() -> Dict[str, int]:
    """This process's ``nvcc`` runs and library hits (loads with no
    compiler run)."""
    return dict(_COUNTS)


def forget_loaded() -> None:
    """Forget the process's library handles and which libraries it
    compiled, so that the next ``load_library`` looks ``_build/`` up again
    (the libraries stay mapped; a test's stand-in for a fresh process)."""
    _HANDLES.clear()
    _COMPILED.clear()


def _run_compiler(name: str, out_path: str, verbose: bool) -> subprocess.Popen:
    """Start ``nvcc`` on kernel ``name``'s source, writing ``out_path`` —
    the one place the port runs the CUDA compiler."""
    cmd = [_nvcc(), *_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", out_path, SOURCES[name]]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _start(name: str, verbose: bool) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start ``nvcc`` for ``name`` unless its library is already built."""
    target = _target(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = _run_compiler(name, tmp, verbose)
    _COUNTS["nvcc_runs"] += 1
    AOT_CACHE_MISSES_TOTAL.labels(engine="cuda", fn=name, reason="cold").inc()
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
    _COMPILED.add(target)
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
    """The library of kernel ``name``, built first if needed. The first
    load in a process opens the file (a hit when this process did not
    compile it); later calls return the process's handle."""
    target = _target(name)
    lib = _HANDLES.get(target)
    if lib is not None:
        return lib
    job = _start(name, verbose=False)
    if job is not None:
        _finish(name, job)
    lib = ctypes.CDLL(target)
    _HANDLES[target] = lib
    if target not in _COMPILED:
        _COUNTS["hits"] += 1
        AOT_CACHE_HITS_TOTAL.labels(engine="cuda", fn=name).inc()
    return lib
