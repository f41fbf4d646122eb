"""Per-backend circuit breaker: closed / open / half-open with cooldown.

The PyTorch port's copy of ``kubernetes_verification_tpu.resilience.breaker``.

A flapping backend (a TPU pod slice mid-preemption, a device wedged until
restart) fails *every* solve for a while. Without a breaker the fallback
chain pays the full retry schedule and watchdog timeout on that backend
for every request before falling through — latency the healthy tail of
the chain never sees. The breaker remembers: after ``failure_threshold``
consecutive exhausted attempts the circuit **opens** and the backend is
skipped outright; after ``cooldown`` seconds one probe is let through
(**half-open**); a probe success re-**closes** the circuit, a probe
failure re-opens it for another cooldown.

State transitions increment
``kvtpu_breaker_transitions_total{backend,to}`` so a flapping backend is
visible as open/half_open churn on the dashboard.

Two consumers:

* :func:`~.wrapper._resilient_call` consults a process-wide registry
  (:func:`breaker_for`) when ``ResilienceConfig.breaker_threshold`` > 0,
  skipping open backends in the chain;
* :class:`~..serve.service.VerificationService` owns a private instance
  guarding the incremental derivation, so a persistently failing engine
  stops paying a doomed solve before every from-scratch fallback.

``clock`` is injectable (``time.monotonic`` signature) so tests drive the
cooldown without sleeping.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Tuple

from ..observe import log_event
from ..observe.flight import trigger_dump
from ..observe.metrics import BREAKER_TRANSITIONS_TOTAL

__all__ = [
    "CLOSED",
    "OPEN",
    "HALF_OPEN",
    "CircuitBreaker",
    "breaker_for",
    "reset_breakers",
    "breaker_states",
]

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One backend's breaker. Thread-safe; all methods are O(1)."""

    def __init__(
        self,
        backend: str,
        *,
        failure_threshold: int = 3,
        cooldown: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.backend = backend
        self.failure_threshold = max(1, int(failure_threshold))
        self.cooldown = float(cooldown)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._opened_at: float = 0.0
        self._probe_inflight = False
        #: transition history (new state names, oldest first) — cheap to
        #: keep and makes test assertions direct
        self.transitions: List[str] = []

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, to: str) -> None:
        # lock held by the caller
        if to == self._state:
            return
        self._state = to
        self.transitions.append(to)
        BREAKER_TRANSITIONS_TOTAL.labels(backend=self.backend, to=to).inc()
        log_event("breaker", backend=self.backend, state=to)
        if to == OPEN:
            # a circuit opening is exactly the moment whose prior context
            # matters for post-mortem: flush the flight-recorder ring (a
            # no-op unless one is installed; rare, so the dump cost under
            # this lock is acceptable)
            trigger_dump("breaker-open", backend=self.backend)

    def allow(self) -> bool:
        """May the caller attempt this backend now? An open circuit whose
        cooldown has elapsed admits exactly one half-open probe."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self._clock() - self._opened_at >= self.cooldown:
                    self._transition(HALF_OPEN)
                    self._probe_inflight = True
                    return True
                return False
            # HALF_OPEN: one outstanding probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            self._transition(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._probe_inflight = False
            if self._state == HALF_OPEN:
                # the probe failed: back to a full cooldown
                self._opened_at = self._clock()
                self._transition(OPEN)
                return
            self._failures += 1
            if self._state == CLOSED and (
                self._failures >= self.failure_threshold
            ):
                self._opened_at = self._clock()
                self._transition(OPEN)


_BREAKERS: Dict[str, CircuitBreaker] = {}
_REGISTRY_LOCK = threading.Lock()


def breaker_for(
    backend: str,
    *,
    failure_threshold: int = 3,
    cooldown: float = 30.0,
    clock: Callable[[], float] = time.monotonic,
) -> CircuitBreaker:
    """The process-wide breaker for ``backend`` (created on first use —
    breaker state must survive across ``resilient_verify`` calls, which is
    the whole point). The first caller's knobs win."""
    with _REGISTRY_LOCK:
        br = _BREAKERS.get(backend)
        if br is None:
            br = CircuitBreaker(
                backend,
                failure_threshold=failure_threshold,
                cooldown=cooldown,
                clock=clock,
            )
            _BREAKERS[backend] = br
        return br


def reset_breakers() -> None:
    """Drop every registered breaker (test isolation)."""
    with _REGISTRY_LOCK:
        _BREAKERS.clear()


def breaker_states() -> List[Tuple[str, str]]:
    """(backend, state) for every registered breaker, sorted by backend."""
    with _REGISTRY_LOCK:
        return sorted((name, br.state) for name, br in _BREAKERS.items())
