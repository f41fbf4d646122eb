"""Continuous-batching front door for the serving plane.

The PyTorch port's copy of ``kubernetes_verification_tpu.serve.ingress``.

The packed query kernels hit peak FLOP/s only when handed
full device-shaped batches — but real traffic is thousands of concurrent
clients each carrying a handful of probes. :class:`Ingress` sits between
them: concurrent :meth:`Ingress.submit` calls park their probes in a
**bounded** queue (an explicit list + condition variable, so overflow is
a typed ``queue-full`` rejection rather than silent growth), and batcher
worker threads coalesce whatever is waiting into one
``can_reach_batch`` call per flush.

Flushes fire on a dual trigger extended with deadline awareness:

* **size** — queued probes reached ``batch_size`` (a full device shape);
* **time** — the oldest request waited ``max_wait_s`` (bounded latency
  for trickle traffic);
* **deadline** — the nearest per-request deadline is within one
  estimated service time of expiring (a tight-budget probe never waits
  for a batch to fill that it could not survive);
* **drain** — shutdown flushes what remains.

Every submission first passes the :class:`~.admission.AdmissionController`
(token-bucket quotas, concurrency, brown-out ladder) *plus* a deadline
feasibility check: if the estimated queue+service time already exceeds
the request's remaining budget, the request is refused up front with a
typed ``deadline`` rejection — which is how the tier keeps its headline
guarantee, **zero deadline violations among admitted requests**, even
under the ``slow-client`` fault (the stall eats the client's budget
before admission, and an infeasible budget converts to a typed refusal).

Batcher workers can be added/retired at runtime (:meth:`add_worker` /
:meth:`remove_worker`) — the local fleet-size knob
:class:`~.autoscale.FleetAutoscaler` turns.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..observe.metrics import (
    INGRESS_BATCHES_TOTAL,
    INGRESS_BATCH_FILL,
    INGRESS_QUEUE_DEPTH,
    INGRESS_REQUESTS_TOTAL,
    INGRESS_WAIT_SECONDS,
)
from ..observe.spans import trace
from ..resilience.errors import (
    AdmissionRejectedError,
    ConfigError,
    KvTpuError,
    ServeError,
)
from ..resilience.faults import ingress_fault
from .admission import AdmissionController

__all__ = ["IngressConfig", "Ingress"]


@dataclass
class IngressConfig:
    """Front-door knobs. ``queue_depth`` is measured in *probes* (the
    unit the device batch is shaped in), not requests."""

    #: device-shaped flush target: a batch dispatches as soon as this
    #: many probes are queued
    batch_size: int = 256
    #: longest the oldest queued request may wait before a partial batch
    #: flushes anyway
    max_wait_s: float = 0.005
    #: bound on queued (admitted, undispatched) probes; overflow is a
    #: typed ``queue-full`` rejection
    queue_depth: int = 4096
    #: budget assumed for submissions that do not carry their own
    default_deadline_s: float = 1.0
    #: safety margin the deadline trigger and feasibility check keep
    #: between "dispatch now" and "too late"
    deadline_margin_s: float = 0.01
    #: EMA weight folding each observed batch service time into the
    #: estimate the feasibility check and deadline trigger use
    service_time_alpha: float = 0.2
    #: batch service time assumed before the first observation
    initial_service_est_s: float = 0.005
    #: batcher worker threads at start()
    workers: int = 1
    #: fence for add_worker(): the autoscaler can never push past this
    max_workers: int = 8


class _PendingRequest:
    __slots__ = (
        "tenant", "probes", "n", "deadline", "enqueue_ts",
        "done", "answers", "error",
    )

    def __init__(self, tenant, probes, deadline, enqueue_ts):
        self.tenant = tenant
        self.probes = probes
        self.n = len(probes)
        self.deadline = deadline
        self.enqueue_ts = enqueue_ts
        self.done = threading.Event()
        self.answers: Optional[List[bool]] = None
        self.error: Optional[Exception] = None


class Ingress:
    """The front door: admission-checked, deadline-aware continuous
    batching over any backend exposing ``can_reach_batch(probes)`` — a
    :class:`~.queries.QueryEngine`, a :class:`~.lb.LoadBalancer` (whose
    ``(answers, who)`` tuple is unwrapped) or a replication proxy."""

    def __init__(
        self,
        backend,
        *,
        config: Optional[IngressConfig] = None,
        admission: Optional[AdmissionController] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if not hasattr(backend, "can_reach_batch"):
            raise ConfigError(
                "ingress backend must expose can_reach_batch(probes) "
                f"(got {type(backend).__name__})"
            )
        self.config = config or IngressConfig()
        if self.config.batch_size < 1 or self.config.queue_depth < 1:
            raise ConfigError(
                "ingress needs batch_size >= 1 and queue_depth >= 1, got "
                f"batch_size={self.config.batch_size} "
                f"queue_depth={self.config.queue_depth}"
            )
        self._backend = backend
        self.admission = admission or AdmissionController(clock=clock)
        self._clock = clock
        self._cond = threading.Condition()
        self._pending: List[_PendingRequest] = []
        self._queued_probes = 0
        self._service_est = self.config.initial_service_est_s
        self._stopping = False
        self._retire = 0
        self._threads: List[threading.Thread] = []
        self.batches = 0
        self.answered = 0

    # ------------------------------------------------------------ workers
    def start(self) -> "Ingress":
        """Spawn the configured batcher workers; idempotent."""
        with self._cond:
            if self._stopping:
                raise ServeError("ingress is closed; build a fresh one")
            missing = self.config.workers - len(self._threads)
        for _ in range(max(0, missing)):
            self.add_worker()
        return self

    def add_worker(self) -> int:
        """Spawn one batcher thread (clamped at ``max_workers``); returns
        the worker count."""
        with self._cond:
            if self._stopping:
                raise ServeError("ingress is closed; cannot add workers")
            if self._retire > 0:
                # net out a pending retirement instead of churning threads
                self._retire -= 1
                return self.workers
            if len(self._threads) >= self.config.max_workers:
                return self.workers
            t = threading.Thread(
                target=self._worker_loop,
                name=f"kvtpu-ingress-{len(self._threads)}",
                daemon=True,
            )
            self._threads.append(t)
        t.start()
        return self.workers

    def remove_worker(self) -> int:
        """Ask one batcher thread to retire (clamped at 1 worker);
        returns the resulting worker count."""
        with self._cond:
            if len(self._threads) - self._retire > 1:
                self._retire += 1
                self._cond.notify_all()
            return len(self._threads) - self._retire

    @property
    def workers(self) -> int:
        with self._cond:
            return len(self._threads) - self._retire

    def close(self) -> None:
        """Drain the queue (one last ``drain`` flush per worker) and join
        every batcher thread."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
            threads = list(self._threads)
        for t in threads:
            t.join(timeout=10.0)
        with self._cond:
            self._threads = [t for t in self._threads if t.is_alive()]

    def __enter__(self) -> "Ingress":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- submit
    def _eta(self, n: int) -> float:
        """Estimated seconds until a request of ``n`` probes submitted now
        would be answered: the flush wait plus one service time per
        batch-size worth of work already queued ahead of it."""
        with self._cond:
            depth = self._queued_probes
            est = self._service_est
        batches_ahead = 1 + (depth + n) // max(1, self.config.batch_size)
        return self.config.max_wait_s + est * batches_ahead

    @property
    def service_estimate(self) -> float:
        with self._cond:
            return self._service_est

    def submit(
        self,
        probes: Sequence[Tuple],
        *,
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        priority: Optional[int] = None,
    ) -> List[bool]:
        """Answer ``probes`` (``(src, dst, port, protocol)`` tuples) for
        ``tenant`` within ``deadline_s``, riding whatever batch the
        front door coalesces; raises
        :class:`~..resilience.errors.AdmissionRejectedError` when the
        door refuses (over-quota / concurrency / brownout / queue-full /
        deadline — always with a finite ``retry_after_s``)."""
        probes = [tuple(p) for p in probes]
        if not probes:
            raise ServeError("ingress submit() needs at least one probe")
        arrival = self._clock()
        budget = (
            self.config.default_deadline_s
            if deadline_s is None
            else float(deadline_s)
        )
        if budget <= 0:
            raise ServeError(
                f"deadline_s must be positive, got {deadline_s!r}"
            )
        # the fault seam: client-burst amplifies the effective probe load
        # (the duplicates answer identically and are sliced back off),
        # slow-client stalls here — eating the budget *before* admission
        factor = ingress_fault()
        effective = probes if factor <= 1 else probes * factor
        n = len(effective)
        now = self._clock()
        deadline = arrival + budget
        remaining = deadline - now
        try:
            eta = self._eta(n)
            if eta + self.config.deadline_margin_s > remaining:
                self.admission.reject(
                    tenant, "deadline",
                    f"cannot answer {n} probes within the remaining "
                    f"{max(0.0, remaining) * 1e3:.1f} ms budget "
                    f"(estimated {eta * 1e3:.1f} ms)",
                    retry_after_s=eta,
                )
            ticket = self.admission.admit(tenant, n, priority=priority)
        except AdmissionRejectedError:
            INGRESS_REQUESTS_TOTAL.labels(
                tenant=tenant, outcome="rejected"
            ).inc()
            raise
        outcome = "failed"
        try:
            req = _PendingRequest(tenant, effective, deadline, now)
            with self._cond:
                full = self._queued_probes + n > self.config.queue_depth
                if not full:
                    self._pending.append(req)
                    self._queued_probes += n
                    INGRESS_QUEUE_DEPTH.set(float(self._queued_probes))
                    self._cond.notify_all()
                occupancy = min(
                    1.0,
                    (self._queued_probes + (n if full else 0))
                    / self.config.queue_depth,
                )
            self.admission.observe_pressure(occupancy)
            if full:
                self.admission.reject(
                    tenant, "queue-full",
                    f"ingress queue is full ({self.config.queue_depth} "
                    f"probes); cannot take {n} more",
                    retry_after_s=self._eta(n),
                )
            if not req.done.wait(timeout=budget + 4 * self._service_est + 1.0):
                raise ServeError(
                    f"ingress request for tenant {tenant!r} did not resolve "
                    f"within its {budget:.3f}s budget plus grace — a batcher "
                    "worker is wedged or none are running (call start())"
                )
            if req.error is not None:
                raise req.error
            outcome = "answered"
            self.answered += 1
            return list(req.answers[: len(probes)])
        except AdmissionRejectedError:
            outcome = "rejected"
            raise
        finally:
            ticket.release()
            INGRESS_REQUESTS_TOTAL.labels(tenant=tenant, outcome=outcome).inc()

    def submit_what_if(
        self,
        events,
        assertions=None,
        *,
        tenant: str = "default",
        priority: Optional[int] = None,
    ):
        """Admission-gated what-if overlay: the first rung of the
        brown-out ladder sheds exactly this (typed ``brownout``
        rejection at level >= 1) so probe traffic keeps its capacity."""
        if not self.admission.brownout.whatif_enabled:
            self.admission.reject(
                tenant, "brownout",
                f"what-if overlays are disabled at brown-out level "
                f"{self.admission.brownout.level} (level >= 1 sheds "
                "optional overlay work first)",
                retry_after_s=self.admission._capacity_retry_after(),
            )
        fn = getattr(self._backend, "what_if", None)
        if fn is None:
            raise ServeError(
                f"ingress backend {type(self._backend).__name__} does not "
                "support what-if overlays"
            )
        with self.admission.admit(tenant, max(1, len(events)),
                                  priority=priority):
            with trace("ingress_what_if", tenant=tenant,
                       events=len(events)):
                return fn(events, assertions)

    # ------------------------------------------------------------ batcher
    def _flush_trigger_locked(self) -> Optional[str]:
        if not self._pending:
            return None
        if self._queued_probes >= self.config.batch_size:
            return "size"
        now = self._clock()
        if now - self._pending[0].enqueue_ts >= self.config.max_wait_s:
            return "time"
        nearest = min(r.deadline for r in self._pending)
        if nearest - now <= self._service_est + self.config.deadline_margin_s:
            return "deadline"
        return None

    def _wait_timeout_locked(self) -> Optional[float]:
        if not self._pending:
            return None
        now = self._clock()
        by_age = self._pending[0].enqueue_ts + self.config.max_wait_s - now
        nearest = min(r.deadline for r in self._pending)
        by_deadline = (
            nearest - now - self._service_est - self.config.deadline_margin_s
        )
        return max(0.0005, min(by_age, by_deadline))

    def _take_batch_locked(self) -> List[_PendingRequest]:
        batch: List[_PendingRequest] = []
        taken = 0
        while self._pending:
            nxt = self._pending[0]
            if batch and taken + nxt.n > self.config.batch_size:
                break
            batch.append(self._pending.pop(0))
            taken += nxt.n
        self._queued_probes -= taken
        INGRESS_QUEUE_DEPTH.set(float(self._queued_probes))
        return batch

    def _worker_loop(self) -> None:
        while True:
            with self._cond:
                batch: List[_PendingRequest] = []
                trigger = "drain"
                while True:
                    if self._retire > 0:
                        self._retire -= 1
                        try:
                            self._threads.remove(threading.current_thread())
                        except ValueError:
                            pass
                        return
                    if self._stopping:
                        if not self._pending:
                            return
                        batch = self._take_batch_locked()
                        break
                    due = self._flush_trigger_locked()
                    if due is not None:
                        trigger = due
                        batch = self._take_batch_locked()
                        break
                    self._cond.wait(self._wait_timeout_locked())
            if batch:
                self._dispatch(batch, trigger)

    def _call_backend(self, probes: List[Tuple]) -> List[bool]:
        res = self._backend.can_reach_batch(probes)
        if (
            isinstance(res, tuple)
            and len(res) == 2
            and isinstance(res[1], str)
        ):
            res = res[0]  # LoadBalancer returns (answers, who_answered)
        return [bool(v) for v in res]

    def _dispatch(self, batch: List[_PendingRequest], trigger: str) -> None:
        probes: List[Tuple] = []
        for r in batch:
            probes.extend(r.probes)
        t0 = self._clock()
        try:
            with trace(
                "ingress_batch",
                trigger=trigger,
                requests=len(batch),
                probes=len(probes),
            ):
                answers = self._call_backend(probes)
        except (KvTpuError, OSError, ValueError, KeyError) as e:
            for r in batch:
                r.error = e
                r.done.set()
            return
        dt = self._clock() - t0
        alpha = self.config.service_time_alpha
        with self._cond:
            self._service_est = alpha * dt + (1.0 - alpha) * self._service_est
        self.batches += 1
        INGRESS_BATCHES_TOTAL.labels(trigger=trigger).inc()
        INGRESS_BATCH_FILL.observe(
            min(1.0, len(probes) / self.config.batch_size)
        )
        now = self._clock()
        offset = 0
        for r in batch:
            r.answers = answers[offset: offset + r.n]
            offset += r.n
            INGRESS_WAIT_SECONDS.observe(max(0.0, now - r.enqueue_ts))
            r.done.set()

    # ------------------------------------------------------------- status
    def describe(self) -> dict:
        """Front-door health fragment: queue + batcher state plus the
        admission controller's per-tenant accounting."""
        with self._cond:
            queued = self._queued_probes
            pending = len(self._pending)
            workers = len(self._threads) - self._retire
            est = self._service_est
        return {
            "queued_probes": queued,
            "pending_requests": pending,
            "queue_depth": self.config.queue_depth,
            "batch_size": self.config.batch_size,
            "workers": workers,
            "batches": self.batches,
            "answered": self.answered,
            "service_est_s": round(est, 6),
            "admission": self.admission.describe(),
        }
