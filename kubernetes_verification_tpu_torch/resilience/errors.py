"""The typed error taxonomy of the PyTorch port, rooted at :class:`KvTpuError`.

The port's own copy of the classes it raises from
``kubernetes_verification_tpu.resilience.errors``, with the same builtin bases,
so an ``except ValueError`` / ``except KeyError`` written against the JAX
package catches the same failures here:

* :class:`EncodeError`   — model objects the tensorizer cannot encode;
* :class:`ConfigError`   — invalid flag / option combinations, and the parts
  of the system the port does not cover yet;
* :class:`ServeError`    — a serving engine rejected an input (a query on a
  state it cannot answer);
* :class:`IngestError`   — malformed manifests (``ingest/``);
* :class:`PersistError`  — a checkpoint failed to load or verify
  (``utils/persist.py``);
* :class:`BackendError`  — a solve attempt failed (no CUDA device, a kernel
  that did not build or launch), with its ``kind`` subclasses
  :class:`BackendOOM`, :class:`BackendTimeout` and :class:`DeviceLost`.

``classify_exception`` maps a raw runtime error onto the taxonomy by message
markers: the JAX package's XLA status names, and what PyTorch raises on a
CUDA device (``torch.OutOfMemoryError``'s "CUDA out of memory", "CUDA
error").
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "KvTpuError",
    "EncodeError",
    "ConfigError",
    "ServeError",
    "IngestError",
    "PersistError",
    "BackendError",
    "BackendOOM",
    "BackendTimeout",
    "DeviceLost",
    "UnknownBackendError",
    "classify_exception",
]


class KvTpuError(Exception):
    """Root of the kubernetes-verification error taxonomy."""


class EncodeError(KvTpuError, ValueError):
    """The tensorizer cannot encode the model objects (e.g. a named-port
    restriction outside a frozen bank)."""


class ConfigError(KvTpuError, ValueError):
    """Invalid configuration: flag combinations, backend options, or a path
    the port does not implement yet — errors the caller fixes by changing
    inputs, not by retrying."""


class ServeError(KvTpuError, ValueError):
    """A serving engine rejected an input: a query naming state the engine
    does not hold, or a surface its mode cannot answer (e.g. reach words of
    a matrix-free engine). ``event_index`` (when set) names the offending
    event's position in its stream."""

    def __init__(
        self, message: str, *, event_index: Optional[int] = None
    ) -> None:
        super().__init__(message)
        self.event_index = event_index


class IngestError(KvTpuError, ValueError):
    """Malformed manifests: the parse layer raises typed instead of printing
    and continuing."""


class PersistError(KvTpuError, ValueError):
    """A checkpoint/artifact failed to load or verify: truncated file,
    corrupt array, sha256 mismatch, or semantic-config mismatch. ``path``
    names the offending artifact."""

    def __init__(self, message: str, *, path: Optional[str] = None) -> None:
        super().__init__(message)
        self.path = path


class BackendError(KvTpuError, RuntimeError):
    """A solve attempt failed on ``backend``. ``transient=True`` means the
    same backend may succeed on retry; ``transient=False`` does not."""

    kind: str = "error"

    def __init__(
        self,
        message: str,
        *,
        backend: Optional[str] = None,
        kind: Optional[str] = None,
        transient: bool = False,
    ) -> None:
        super().__init__(message)
        self.backend = backend
        if kind is not None:
            self.kind = kind
        self.transient = transient


class UnknownBackendError(BackendError, KeyError):
    """Requested backend is not registered (also a ``KeyError`` — the
    registry's historical type)."""

    kind = "unknown_backend"
    # KeyError.__str__ reprs its argument, which would quote the message
    __str__ = Exception.__str__

    def __init__(self, message: str, *, backend: Optional[str] = None) -> None:
        super().__init__(message, backend=backend, transient=False)


class BackendOOM(BackendError):
    """Device memory exhausted (XLA ``RESOURCE_EXHAUSTED``, PyTorch's
    ``torch.OutOfMemoryError``). Transient in the adaptive sense: a caller
    may shrink its tiles and retry."""

    kind = "oom"

    def __init__(self, message: str, *, backend: Optional[str] = None) -> None:
        super().__init__(message, backend=backend, transient=True)


class BackendTimeout(BackendError):
    """A watchdog fired (or XLA reported ``DEADLINE_EXCEEDED``): the solve
    is presumed hung, not wrong."""

    kind = "timeout"

    def __init__(self, message: str, *, backend: Optional[str] = None) -> None:
        super().__init__(message, backend=backend, transient=True)


class DeviceLost(BackendError):
    """The accelerator went away (preemption, reset). Non-transient for this
    backend: retrying the same dead device wastes the error budget."""

    kind = "device_loss"

    def __init__(self, message: str, *, backend: Optional[str] = None) -> None:
        super().__init__(message, backend=backend, transient=False)


#: substring → taxonomy class, checked in order: the JAX package's table
#: (XLA surfaces gRPC status names inside its runtime errors); PyTorch's
#: exceptions carry no status code, and its ``torch.OutOfMemoryError`` says
#: "CUDA out of memory", which "out of memory" matches
_MESSAGE_MARKERS = (
    ("RESOURCE_EXHAUSTED", BackendOOM),
    ("out of memory", BackendOOM),
    ("Out of memory", BackendOOM),
    ("DEADLINE_EXCEEDED", BackendTimeout),
    ("deadline exceeded", BackendTimeout),
    ("DATA_LOSS", DeviceLost),
    ("device is lost", DeviceLost),
    ("Device lost", DeviceLost),
    ("device halted", DeviceLost),
)

#: markers for generically transient conditions (retry same backend); a
#: "CUDA error" is PyTorch's counterpart of XLA's UNAVAILABLE / ABORTED
_TRANSIENT_MARKERS = (
    "UNAVAILABLE", "ABORTED", "CANCELLED", "try again", "CUDA error",
)


def classify_exception(
    exc: BaseException, backend: Optional[str] = None
) -> BackendError:
    """Map an arbitrary solve-time exception onto the taxonomy.

    Already-typed :class:`BackendError`\\ s pass through (with ``backend``
    filled in when missing); raw runtime errors classify by message marker;
    anything else becomes a non-transient :class:`BackendError`.
    """
    if isinstance(exc, BackendError):
        if exc.backend is None:
            exc.backend = backend
        return exc
    msg = str(exc)
    for marker, cls in _MESSAGE_MARKERS:
        if marker in msg:
            err = cls(msg, backend=backend)
            err.__cause__ = exc
            return err
    transient = any(m in msg for m in _TRANSIENT_MARKERS)
    err = BackendError(
        f"{type(exc).__name__}: {msg}", backend=backend, transient=transient
    )
    err.__cause__ = exc
    return err
