"""Warm kernel pack: warm start as a production SLO.

The port's counterpart of ``kubernetes_verification_tpu.observe.aot``. In
the JAX package the warm state is a set of compiled XLA executables; in the
port nothing is compiled per call except the two hand-written CUDA kernels,
which ``ops/cuda_build.py`` builds with ``nvcc`` at first use in every new
process (seconds; and impossible on a host without ``nvcc``). So the warm
pack is a pack of **built kernel libraries**:

* **Kernel manifest** — every torch dispatch site the JAX package registers
  is registered here too (``register_kernel``; per-call functions such as
  the sharded closure's square step use ``transient_kernel``) and rebound to
  a thin wrapper. The wrapper records each call's dispatch key — (engine,
  kernel, static arguments, per-leaf shape / dtype / device type, and the
  environment below) — once per new signature, then calls the function. A
  torch function has nothing to compile, so its call is never a hit: the
  recorded keys go into the pack's manifest and ``pack_status``'s
  ``matching`` count. Recording costs microseconds per call.

* **Environment key** — ``current_env()``: torch's version and CUDA
  version, the card's name and compute capability, the driver version, the
  ``nvcc`` release line and the build flags. A library built by one
  ``nvcc`` for ``sm_90a`` never loads under another driver, toolkit, torch
  or card: a mismatch of any component is a counted miss
  (``kvtpu_aot_cache_misses_total{reason="key-mismatch"}``), and the
  library is then built from the repo's sources. A host with no ``nvcc``
  (the point of the pack) cannot disagree about the toolkit, so an absent
  local ``nvcc`` matches any; every other key must be equal. Each library
  entry also names its target (``cuda_build.target_name``: a hash of the
  sources, headers and flags), so a pack built from other sources is a
  mismatch too.

* **The pack** — ``save_pack`` copies every built library into the
  directory beside a checksummed ``PACK_MANIFEST.json`` (each library's
  name, target hash and sha256, the environment, the recorded dispatch
  keys). ``load_pack`` checks the environment and each entry's digest
  *before* it hands a file to ``ctypes``, installs the matching libraries
  into ``_build/`` under their target names and loads them (one hit each,
  ``kvtpu_aot_cache_hits_total{engine="cuda"}``), so that
  ``cuda_build.load_library`` finds them and runs no ``nvcc``. On the CPU,
  where nothing is built, the pack holds the manifest and no library.

``CheckpointManager`` ships the pack beside its ``gen-N/`` snapshots
(``serve/durability.py``), so ``recover()``, follower bootstrap and
promotion restore *built* kernels.

A corrupt, truncated or foreign pack is a warning and a counted miss, and
the library is built from the repo's sources with ``nvcc`` — still the
hand-written kernel — or, with no ``nvcc`` either, its launch raises
``BackendError``. Nothing here ever falls back to a kernel's plain version,
and nothing raises into a checkpoint or a recovery.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import shutil
import threading
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from .events import log_event
from .metrics import (
    AOT_CACHE_HITS_TOTAL,
    AOT_CACHE_MISSES_TOTAL,
    AOT_PACK_BYTES,
)

__all__ = [
    "PACK_DIRNAME",
    "PACK_MANIFEST_NAME",
    "WarmKernel",
    "aot_enabled",
    "set_aot",
    "register_kernel",
    "transient_kernel",
    "manifest",
    "current_env",
    "save_pack",
    "load_pack",
    "pack_status",
    "pack_dir",
    "drop_executables",
    "hit_total",
    "miss_total",
]

#: the port's pack format (a JAX package's pack is foreign here)
PACK_FORMAT = "torch-cuda-1"
PACK_DIRNAME = "aot-pack"
PACK_MANIFEST_NAME = "PACK_MANIFEST.json"

_ENV_FLAG = "KVTPU_AOT"
#: the engine label of the built kernel libraries
LIBRARY_ENGINE = "cuda"

_lock = threading.RLock()
_enabled: Optional[bool] = None  # None = defer to the env var
#: every registered dispatch site, keyed by (engine, fn) — the manifest
_MANIFEST: Dict[Tuple[str, str], "_KernelBase"] = {}
#: the process's environment fingerprint, computed once
_ENV: Optional[Dict[str, Any]] = None


# ---------------------------------------------------------------- gating
def aot_enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return os.environ.get(_ENV_FLAG, "").lower() not in ("0", "false")


def set_aot(on: Optional[bool]) -> None:
    """Force the warm path on/off for this process (None = defer to the
    KVTPU_AOT env var again)."""
    global _enabled
    with _lock:
        _enabled = on if on is None else bool(on)


# ------------------------------------------------------- environment key
def _driver_version() -> Optional[int]:
    """``cuDriverGetVersion`` from the driver library, without creating a
    context; ``None`` on a host with no NVIDIA driver."""
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
        ver = ctypes.c_int(0)
        if libcuda.cuDriverGetVersion(ctypes.byref(ver)) != 0:
            return None
        return int(ver.value)
    except OSError:
        return None


def _compute_env() -> Dict[str, Any]:
    import torch

    from ..ops import cuda_build

    name = capability = None
    if torch.cuda.is_available():
        name = torch.cuda.get_device_name(0)
        capability = "%d.%d" % torch.cuda.get_device_capability(0)
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "device_name": name,
        "capability": capability,
        "driver": _driver_version(),
        "nvcc": cuda_build.nvcc_version(),
        "flags": " ".join(cuda_build._FLAGS),
    }


def current_env() -> Dict[str, Any]:
    """The environment fingerprint baked into every key and every pack:
    anything that can invalidate a built library. Computed once per process
    (it runs ``nvcc --version``); tests monkeypatch this to exercise the
    key-mismatch paths."""
    global _ENV
    if _ENV is None:
        env = _compute_env()
        with _lock:
            if _ENV is None:
                _ENV = env
    return dict(_ENV)


def _env_match(pack_env: Dict[str, Any], env: Dict[str, Any]) -> bool:
    """Every key equal, except that a host with no ``nvcc`` matches any
    toolkit (it has nothing to disagree with; the driver key still holds)."""
    if not isinstance(pack_env, dict) or set(pack_env) != set(env):
        return False
    for key, value in env.items():
        if key == "nvcc" and value is None:
            continue
        if pack_env[key] != value:
            return False
    return True


def _env_tuple() -> Tuple:
    return tuple(sorted((k, str(v)) for k, v in current_env().items()))


def _key_id(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()


def _leaf_sig(x) -> Any:
    """Hashable description of one operand: tensors and arrays by shape,
    dtype and device type; Python scalars by type (dynamic values must not
    make a key per value); containers and dataclasses recurse; anything
    else by its type name."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        device = getattr(x, "device", None)
        return ("a", tuple(shape), str(dtype), getattr(device, "type", None))
    if isinstance(x, (bool, int, float, complex)):
        return ("s", type(x).__name__)
    if x is None or isinstance(x, str):
        return ("o", x)
    if isinstance(x, (list, tuple)):
        return tuple(_leaf_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _leaf_sig(x[k])) for k in sorted(x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            _leaf_sig(getattr(x, f.name)) for f in dataclasses.fields(x)
        )
    return ("o", type(x).__name__)


class _KernelBase:
    """Shared state of one manifest entry: the dispatch keys recorded."""

    def __init__(self, engine: str, name: str) -> None:
        self.engine = engine
        self.name = name
        self._seen: set = set()  # call signatures already recorded
        self._recorded: Dict[str, None] = {}  # full keys, in order

    def _record(self, sig: Tuple) -> None:
        if sig in self._seen:
            return
        with _lock:
            self._seen.add(sig)
            key = repr((self.engine, self.name, sig, _env_tuple()))
            self._recorded[key] = None

    def recorded_keys(self) -> List[str]:
        return list(self._recorded)


class WarmKernel(_KernelBase):
    """Wrapper around one module-level dispatch function: records the
    call's dispatch key (while the warm path is enabled), then calls it.
    ``static_argnames`` are the keyword arguments keyed by value (the JAX
    registration's static arguments); every other argument is keyed by its
    abstract signature."""

    def __init__(
        self,
        engine: str,
        name: str,
        fn: Callable,
        static_argnames: Iterable[str] = (),
    ) -> None:
        super().__init__(engine, name)
        self.fn = fn
        self.static_argnames = frozenset(static_argnames)
        self.__wrapped__ = fn
        self.__doc__ = getattr(fn, "__doc__", None)

    def __call__(self, *args, **kwargs):
        if aot_enabled():
            try:
                statics = tuple(
                    (k, kwargs[k]) for k in sorted(kwargs)
                    if k in self.static_argnames
                )
                dyn = tuple(
                    (k, _leaf_sig(kwargs[k])) for k in sorted(kwargs)
                    if k not in self.static_argnames
                )
                self._record((statics, _leaf_sig(args), dyn))
            except Exception:  # an unkeyable operand never blocks the call
                pass
        return self.fn(*args, **kwargs)


class TransientKernel(_KernelBase):
    """Manifest entry for functions built per call (the sharded closure's
    square step binds its geometry per call). ``bind`` wraps one such
    function; the key carries the construction parameters (``key_extras``)
    the closure baked in."""

    def bind(self, fn: Callable, key_extras: Tuple = ()) -> Callable:
        extras = repr(tuple(key_extras))

        def call(*args, **kwargs):
            if aot_enabled():
                try:
                    self._record((extras, _leaf_sig(args), _leaf_sig(kwargs)))
                except Exception:
                    pass
            return fn(*args, **kwargs)

        call.fn = fn
        return call


# ---------------------------------------------------------- registration
def register_kernel(
    engine: str,
    name: str,
    fn: Callable,
    *,
    static_argnames: Iterable[str] = (),
) -> WarmKernel:
    """Register a module-level dispatch function with the kernel manifest
    and return its :class:`WarmKernel` (rebind the module name to it:
    ``_f = register_kernel("eng", "_f", _f)``)."""
    kernel = WarmKernel(engine, name, fn, static_argnames)
    with _lock:
        _MANIFEST[(engine, name)] = kernel
    return kernel


def transient_kernel(
    engine: str, name: str, fn: Callable, *, key_extras: Tuple = ()
) -> Callable:
    """Register (or reuse) a manifest entry for a per-call function and
    return the recording wrapper for this particular function object."""
    with _lock:
        entry = _MANIFEST.get((engine, name))
        if not isinstance(entry, TransientKernel):
            entry = TransientKernel(engine, name)
            _MANIFEST[(engine, name)] = entry
    return entry.bind(fn, key_extras)


def manifest() -> Dict[Tuple[str, str], _KernelBase]:
    """The live kernel manifest (read-only view)."""
    with _lock:
        return dict(_MANIFEST)


def drop_executables() -> None:
    """Forget which kernel libraries this process has loaded and built, so
    the next launch looks ``_build/`` (and a freshly loaded pack) up again —
    the test hook that simulates a fresh process in front of an on-disk
    pack. Recorded dispatch keys survive (a torch function keeps no
    executable to drop)."""
    from ..ops import cuda_build

    cuda_build.forget_loaded()


def hit_total() -> float:
    return sum(c.value for c in AOT_CACHE_HITS_TOTAL.children().values())


def miss_total() -> float:
    return sum(c.value for c in AOT_CACHE_MISSES_TOTAL.children().values())


# ------------------------------------------------------------- the pack
def pack_dir(checkpoint_dir: str) -> str:
    """Where the warm pack lives relative to a checkpoint directory."""
    return os.path.join(checkpoint_dir, PACK_DIRNAME)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _read_manifest(directory: str) -> Optional[dict]:
    path = os.path.join(directory, PACK_MANIFEST_NAME)
    try:
        with open(path) as fh:
            man = json.load(fh)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        warnings.warn(
            f"aot: unreadable pack manifest {path} ({e}); ignoring pack",
            RuntimeWarning,
        )
        return None
    if not isinstance(man, dict) or not isinstance(man.get("entries"), list):
        warnings.warn(
            f"aot: malformed pack manifest {path}; ignoring pack",
            RuntimeWarning,
        )
        return None
    return man


def _library_file(ent: dict) -> str:
    return f"{ent['id']}.so"


def _sha256_file(path: str) -> Tuple[str, int]:
    with open(path, "rb") as fh:
        blob = fh.read()
    return hashlib.sha256(blob).hexdigest(), len(blob)


def save_pack(directory: str) -> dict:
    """Copy every built kernel library into ``directory`` beside a
    checksummed manifest that also lists every recorded dispatch key
    (incremental: a library entry already packed is not copied again, and
    the dispatch keys of an earlier manifest under the same environment are
    kept). Per-entry failures are warnings, never raises. Returns a summary
    dict."""
    from ..ops import cuda_build

    os.makedirs(directory, exist_ok=True)
    env = current_env()
    env_t = tuple(sorted((k, str(v)) for k, v in env.items()))
    entries: Dict[str, dict] = {}
    existing = _read_manifest(directory)
    if (
        existing is not None
        and existing.get("format") == PACK_FORMAT
        and _env_match(existing.get("env") or {}, env)
    ):
        for ent in existing["entries"]:
            if isinstance(ent, dict) and ent.get("kind") == "dispatch" and "id" in ent:
                entries[ent["id"]] = ent
    new_n = skipped_n = 0
    for name, path in sorted(cuda_build.built_libraries().items()):
        target = os.path.basename(path)
        key = repr((LIBRARY_ENGINE, name, target, env_t))
        kid = _key_id(key)
        dest = os.path.join(directory, f"{kid}.so")
        try:
            digest, nbytes = _sha256_file(path)
            if not (os.path.exists(dest) and _sha256_file(dest)[0] == digest):
                tmp = f"{dest}.{os.getpid()}.tmp"
                shutil.copyfile(path, tmp)
                os.replace(tmp, dest)
                new_n += 1
        except OSError as e:
            skipped_n += 1
            warnings.warn(
                f"aot: could not pack the {name} library: {e}", RuntimeWarning
            )
            continue
        entries[kid] = {
            "id": kid,
            "kind": "library",
            "engine": LIBRARY_ENGINE,
            "fn": name,
            "key": key,
            "target": target,
            "target_hash": target.rsplit("-", 1)[-1].split(".")[0],
            "payload_sha256": digest,
            "bytes": nbytes,
        }
    with _lock:
        kernels = list(_MANIFEST.values())
    for kernel in kernels:
        for key in kernel.recorded_keys():
            kid = _key_id(key)
            if kid not in entries:
                entries[kid] = {
                    "id": kid,
                    "kind": "dispatch",
                    "engine": kernel.engine,
                    "fn": kernel.name,
                    "key": key,
                }
                new_n += 1
    manifest_obj = {
        "format": PACK_FORMAT,
        "env": env,
        "entries": sorted(entries.values(), key=lambda e: e["id"]),
    }
    _atomic_write(
        os.path.join(directory, PACK_MANIFEST_NAME),
        (json.dumps(manifest_obj, sort_keys=True, indent=2) + "\n").encode(),
    )
    libs = [e for e in entries.values() if e["kind"] == "library"]
    total_bytes = sum(int(e["bytes"]) for e in libs)
    AOT_PACK_BYTES.set(total_bytes)
    summary = {
        "directory": directory,
        "entries": len(entries),
        "libraries": sorted(e["fn"] for e in libs),
        "dispatch": len(entries) - len(libs),
        "new": new_n,
        "skipped": skipped_n,
        "bytes": total_bytes,
    }
    log_event("aot_pack_save", **summary)
    return summary


def _miss(engine: str, fn: str, reason: str) -> None:
    AOT_CACHE_MISSES_TOTAL.labels(engine=engine, fn=fn, reason=reason).inc()


def _install(name: str, src: str) -> None:
    """Copy a verified library to its target name in ``_build/``, unless a
    build for the same sources is already there, and load it."""
    from ..ops import cuda_build

    target = os.path.join(cuda_build.BUILD_DIR, cuda_build.target_name(name))
    if not os.path.exists(target):
        os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        shutil.copyfile(src, tmp)
        os.replace(tmp, target)
    try:
        cuda_build.load_library(name)
    except OSError:
        # a library that does not load must not stay where the next
        # launch would find it: that launch builds it from the sources
        os.remove(target)
        raise


def load_pack(directory: str) -> dict:
    """Verify and install a warm pack: library entries whose environment
    matches the current fingerprint, whose target is this checkout's and
    whose digest checks out are installed into ``_build/`` and loaded (a
    hit each); anything else is a counted miss — a foreign pack or
    environment drift under ``key-mismatch``, damage under ``corrupt`` (with
    a warning) — and is never loaded. Dispatch entries are counted. Never
    raises. Returns a summary dict."""
    from ..ops import cuda_build

    summary = {
        "directory": directory,
        "present": False,
        "loaded": 0,
        "dispatch": 0,
        "mismatched": 0,
        "corrupt": 0,
        "bytes": 0,
    }
    man = _read_manifest(directory)
    if man is None:
        return summary
    summary["present"] = True
    foreign = man.get("format") != PACK_FORMAT
    env_ok = not foreign and _env_match(man.get("env") or {}, current_env())
    if foreign:
        warnings.warn(
            f"aot: {directory} is not a torch kernel pack (format "
            f"{man.get('format')!r}); ignoring it",
            RuntimeWarning,
        )
    for ent in man["entries"]:
        if not isinstance(ent, dict) or "id" not in ent or "key" not in ent:
            summary["corrupt"] += 1
            continue
        engine, fn = str(ent.get("engine", "?")), str(ent.get("fn", "?"))
        if not env_ok:
            # built for a different world: counted, never loaded
            summary["mismatched"] += 1
            _miss(engine, fn, "key-mismatch")
            continue
        if ent.get("kind") == "dispatch":
            summary["dispatch"] += 1
            continue
        if fn not in cuda_build.SOURCES or ent.get("target") != cuda_build.target_name(fn):
            summary["mismatched"] += 1  # built from other sources
            _miss(engine, fn, "key-mismatch")
            continue
        path = os.path.join(directory, _library_file(ent))
        try:
            digest, nbytes = _sha256_file(path)
            if digest != ent.get("payload_sha256"):
                raise PersistenceDamage("payload digest mismatch")
            _install(fn, path)
        except Exception as e:
            summary["corrupt"] += 1
            _miss(engine, fn, "corrupt")
            warnings.warn(
                f"aot: pack entry {ent['id'][:12]}… ({engine}/{fn}) is "
                f"unusable ({type(e).__name__}: {e}); it will be built from "
                "the sources",
                RuntimeWarning,
            )
            log_event(
                "aot_pack_corrupt",
                entry=ent["id"],
                engine=engine,
                fn=fn,
                error=f"{type(e).__name__}: {e}",
            )
            continue
        summary["loaded"] += 1
        summary["bytes"] += nbytes
    if summary["bytes"]:
        AOT_PACK_BYTES.set(summary["bytes"])
    log_event("aot_pack_load", **summary)
    return summary


class PersistenceDamage(Exception):
    """Internal marker for a pack entry that failed its digest check."""


def pack_status(directory: str) -> dict:
    """Read-only validity report for ``inspect`` and ``/healthz``: entry
    count, how many entries match the current environment (dispatch keys
    and intact libraries for this checkout), and per-entry damage —
    nothing is loaded and no metrics move."""
    from ..ops import cuda_build

    status: Dict[str, Any] = {
        "directory": directory,
        "present": False,
        "entries": 0,
        "libraries": [],
        "env_match": False,
        "matching": 0,
        "mismatched": 0,
        "corrupt": 0,
        "bytes": 0,
    }
    man = _read_manifest(directory)
    if man is None:
        return status
    status["present"] = True
    pack_env = man.get("env") or {}
    status["env_match"] = man.get("format") == PACK_FORMAT and _env_match(
        pack_env, current_env()
    )
    status["pack_env"] = pack_env
    for ent in man["entries"]:
        if not isinstance(ent, dict) or "id" not in ent:
            status["corrupt"] += 1
            continue
        status["entries"] += 1
        ok = True
        if ent.get("kind") == "library":
            status["libraries"].append(str(ent.get("fn")))
            try:
                digest, nbytes = _sha256_file(
                    os.path.join(directory, _library_file(ent))
                )
            except OSError:
                status["corrupt"] += 1
                continue
            if digest != ent.get("payload_sha256"):
                status["corrupt"] += 1
                continue
            status["bytes"] += nbytes
            fn = ent.get("fn")
            ok = fn in cuda_build.SOURCES and ent.get("target") == cuda_build.target_name(fn)
        if status["env_match"] and ok:
            status["matching"] += 1
        else:
            status["mismatched"] += 1
    status["libraries"].sort()
    return status
