"""The typed error taxonomy of the PyTorch port, rooted at :class:`KvTpuError`.

The port's own copy of the classes it raises from
``kubernetes_verification_tpu.resilience.errors``, with the same builtin bases,
so an ``except ValueError`` / ``except KeyError`` written against the JAX
package catches the same failures here:

* :class:`EncodeError`   — model objects the tensorizer cannot encode;
* :class:`ConfigError`   — invalid flag / option combinations, and the parts
  of the system the port does not cover yet;
* :class:`ServeError`    — the serving plane or a serving engine rejected an
  input (an event naming an unknown pod, a query on a state it cannot
  answer), with the serve subclasses :class:`StaleReadError`,
  :class:`FencedError`, :class:`ReplicationError`,
  :class:`AdmissionRejectedError`, :class:`StripeRouteError` and
  :class:`StripeCoverageError`;
* :class:`IngestError`   — malformed manifests (``ingest/``);
* :class:`PersistError`  — a checkpoint failed to load or verify
  (``utils/persist.py``);
* :class:`BackendError`  — a solve attempt failed (no CUDA device, a kernel
  that did not build or launch), with its ``kind`` subclasses
  :class:`BackendOOM`, :class:`BackendTimeout` and :class:`DeviceLost`, and
  :class:`BackendChainExhausted` when every backend of a chain failed.

``classify_exception`` maps a raw runtime error onto the taxonomy by message
markers: the JAX package's XLA status names, and what PyTorch raises on a
CUDA device (``torch.OutOfMemoryError``'s "CUDA out of memory", "CUDA
error").
"""
from __future__ import annotations

from typing import List, Optional, Tuple

__all__ = [
    "KvTpuError",
    "EncodeError",
    "ConfigError",
    "ServeError",
    "StaleReadError",
    "FencedError",
    "ReplicationError",
    "AdmissionRejectedError",
    "StripeRouteError",
    "StripeCoverageError",
    "IngestError",
    "PersistError",
    "BackendError",
    "BackendOOM",
    "BackendTimeout",
    "DeviceLost",
    "UnknownBackendError",
    "BackendChainExhausted",
    "classify_exception",
    "exit_code_for",
    "EXIT_OK",
    "EXIT_VIOLATIONS",
    "EXIT_INPUT_ERROR",
    "EXIT_BACKEND_FAILED",
]

EXIT_OK = 0  #: verified, no requested invariant violated
EXIT_VIOLATIONS = 1  #: verified, but a check found violations
EXIT_INPUT_ERROR = 2  #: bad manifests / checkpoint / flags (IngestError, ...)
EXIT_BACKEND_FAILED = 3  #: every backend in the fallback chain failed


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


class StaleReadError(ServeError):
    """A follower read exceeded its staleness bound: the replica's applied
    state lags the leader's WAL by more than ``max_lag_seconds`` /
    ``max_lag_seq``, and the caller asked for a bounded read rather than a
    possibly-stale verdict. Carries the *measured* lag alongside the bound
    that was violated, so callers can retry, widen the bound, or route to
    the leader. Exit-code contract: input error (2), like every
    :class:`ServeError` — the replica is healthy, the bound is just unmet.
    """

    def __init__(
        self,
        message: str,
        *,
        lag_seconds: Optional[float] = None,
        lag_seq: Optional[int] = None,
        bound_seconds: Optional[float] = None,
        bound_seq: Optional[int] = None,
    ) -> None:
        super().__init__(message)
        self.lag_seconds = lag_seconds
        self.lag_seq = lag_seq
        self.bound_seconds = bound_seconds
        self.bound_seq = bound_seq


class FencedError(ServeError):
    """A writer holding a superseded epoch tried to append to the WAL (or
    renew the lease) after a follower promoted past it. ``epoch`` is the
    writer's stale reign, ``lease_epoch`` the current one in
    ``leader.lease``. The only correct reaction is to stop writing — the
    cluster has moved on."""

    def __init__(
        self,
        message: str,
        *,
        epoch: Optional[int] = None,
        lease_epoch: Optional[int] = None,
    ) -> None:
        super().__init__(message)
        self.epoch = epoch
        self.lease_epoch = lease_epoch


class ReplicationError(ServeError):
    """A replication-transport operation failed: the connection was refused
    or reset, a request timed out, a chunk arrived checksum-mismatched, or
    an injected network fault (``net-drop`` / ``net-partition``) fired at
    the transport seam. ``op`` names the wire operation (``tip`` / ``wal``
    / ``manifest`` / ``file``) and ``url`` the endpoint. Transient by
    construction — callers retry with capped jittered backoff and feed
    per-replica breakers; a follower that cannot reach its leader keeps
    serving (increasingly stale) reads from its local mirror."""

    def __init__(
        self,
        message: str,
        *,
        op: Optional[str] = None,
        url: Optional[str] = None,
    ) -> None:
        super().__init__(message)
        self.op = op
        self.url = url


class AdmissionRejectedError(ServeError):
    """The ingress admission controller refused a request at the front
    door. ``reason`` is one of the stable rejection classes —
    ``over-quota`` (the tenant's token bucket is empty; HTTP 429),
    ``concurrency`` (the global in-flight limit is reached; HTTP 503),
    ``queue-full`` (the bounded continuous-batching queue has no slot;
    HTTP 503), ``brownout`` (the overload ladder is shedding this
    tenant's priority class or the whole door; HTTP 503), ``deadline``
    (the request's budget cannot survive the current queue + service
    estimate, so admitting it would only manufacture a deadline
    violation; HTTP 503). ``retry_after_s`` is always finite and
    computed, never a guess: for ``over-quota`` it is the bucket's
    refill horizon, for the capacity reasons an escalating backoff hint
    — the HTTP seam renders it as a ``Retry-After`` header so clients
    back off instead of hammering. ``tenant`` names who was refused."""

    def __init__(
        self,
        message: str,
        *,
        retry_after_s: float = 1.0,
        tenant: Optional[str] = None,
        reason: str = "over-quota",
    ) -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)
        self.tenant = tenant
        self.reason = reason


class StripeRouteError(ServeError):
    """A query landed on a stripe owner that does not own the source rows
    it needs: the routing layer (or a direct caller) asked stripe ``k``
    for a row outside its ``[lo, hi)`` range. ``pod`` is the offending
    global row index, ``stripe`` the ``(index, count)`` pair that refused
    it. Always a routing bug or a direct misuse, never data loss — the
    row exists on its owning stripe."""

    def __init__(
        self,
        message: str,
        *,
        pod: Optional[int] = None,
        stripe: Optional[tuple] = None,
    ) -> None:
        super().__init__(message)
        self.pod = pod
        self.stripe = stripe


class StripeCoverageError(ServeError):
    """A scatter-gather query needed a stripe that has **no live owner**:
    every registered owner for that pod range failed or none was ever
    registered. The coordinator raises this instead of returning a
    silently-truncated answer — a coverage gap is an outage, not a
    smaller result set. ``stripe`` is the dead ``(index, count)`` pair,
    ``rows`` its ``(lo, hi)`` pod range."""

    def __init__(
        self,
        message: str,
        *,
        stripe: Optional[tuple] = None,
        rows: Optional[tuple] = None,
    ) -> None:
        super().__init__(message)
        self.stripe = stripe
        self.rows = rows


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


class BackendChainExhausted(BackendError):
    """Every backend in the fallback chain failed. ``failures`` lists
    ``(backend, BackendError)`` in attempt order — the post-mortem."""

    kind = "chain_exhausted"

    def __init__(
        self, chain: Tuple[str, ...], failures: List[Tuple[str, "BackendError"]]
    ) -> None:
        detail = "; ".join(
            f"{b}: [{e.kind}] {e}" for b, e in failures
        )
        super().__init__(
            f"all backends in chain {list(chain)} failed: {detail}",
            transient=False,
        )
        self.chain = tuple(chain)
        self.failures = list(failures)


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


def exit_code_for(exc: BaseException) -> int:
    """The exit-code contract for an exception that escaped a command."""
    if isinstance(exc, BackendError):
        return EXIT_BACKEND_FAILED
    if isinstance(exc, KvTpuError):
        return EXIT_INPUT_ERROR
    # kvtpu: ignore[error-taxonomy] API-misuse guard on the taxonomy's own entry point — a foreign exception here is a caller bug, not an input error
    raise TypeError(f"not a KvTpuError: {type(exc).__name__}")
