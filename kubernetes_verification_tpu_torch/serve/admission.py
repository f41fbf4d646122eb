"""Admission control for the front-door ingress tier.

The PyTorch port's copy of ``kubernetes_verification_tpu.serve.admission``.

The serving plane behind this module (lb → replicas → packed query
kernels) answers millions of probes per second — but only for callers it
*admits*. This module is the door policy:

* :class:`TokenBucket` — the classic refill-rate / burst-capacity meter,
  thread-safe, with an injectable clock so tests drive time;
* :class:`TenantQuota` — one tenant's contract: sustained probes/s,
  burst headroom, and a priority class the brown-out ladder sheds by;
* :class:`AdmissionController` — the decision point. Every submission
  passes (in order) the brown-out ladder, the tenant's token bucket and
  the global in-flight concurrency limit; every refusal is a typed
  :class:`~..resilience.errors.AdmissionRejectedError` carrying a
  *computed, finite* retry-after (the bucket's refill horizon for
  over-quota, an escalating backoff hint for capacity sheds) that the
  HTTP seam renders as ``429``/``503`` + ``Retry-After``. Refusals count
  per tenant/reason in ``kvtpu_admission_rejections_total``; bucket
  pressure is published per tenant in
  ``kvtpu_admission_quota_utilization``.
* :class:`BrownoutController` — graceful degradation under sustained
  overload. Pressure observations (the ingress queue's occupancy) drive
  a ladder with hysteresis: level 1 disables what-if overlays (the
  costliest optional work), level 2 sheds the lowest-priority tenants,
  level 3 rejects at the door. Every transition is traced,
  flight-recorded and counted — an operator reconstructing an incident
  sees exactly when the door started refusing whom.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional

from ..observe import log_event
from ..observe.flight import trigger_dump
from ..observe.metrics import (
    ADMISSION_BROWNOUT_LEVEL,
    ADMISSION_BROWNOUT_TRANSITIONS_TOTAL,
    ADMISSION_QUOTA_UTILIZATION,
    ADMISSION_REJECTIONS_TOTAL,
)
from ..observe.spans import trace
from ..resilience.errors import AdmissionRejectedError, ConfigError

__all__ = [
    "TokenBucket",
    "TenantQuota",
    "AdmissionConfig",
    "AdmissionTicket",
    "AdmissionController",
    "BrownoutController",
    "BROWNOUT_LADDER",
]

#: the ladder, documented once: what each level turns off. Level N implies
#: every lower level's degradation too.
BROWNOUT_LADDER = (
    (0, "normal service"),
    (1, "what-if overlays disabled"),
    (2, "lowest-priority tenants shed"),
    (3, "rejecting at the door"),
)


class TokenBucket:
    """``rate`` tokens/s refill up to ``burst`` capacity; ``take(n)``
    spends, :meth:`retry_after` answers "when would ``n`` tokens exist"
    — the finite Retry-After every over-quota rejection carries."""

    def __init__(
        self,
        rate: float,
        burst: float,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if rate <= 0 or burst <= 0:
            raise ConfigError(
                f"token bucket needs rate > 0 and burst > 0, got "
                f"rate={rate} burst={burst}"
            )
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def _refill(self) -> None:
        now = self._clock()
        elapsed = max(0.0, now - self._stamp)
        self._stamp = now
        self._tokens = min(self.burst, self._tokens + elapsed * self.rate)

    def take(self, n: float = 1.0) -> bool:
        """Spend ``n`` tokens if available; False (nothing spent) when the
        bucket cannot cover them."""
        with self._lock:
            self._refill()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will exist (0.0 when they already
        do). Always finite: ``n`` above the burst capacity is clamped to
        a full-bucket wait — the request can never succeed as-is, but the
        hint must still terminate."""
        with self._lock:
            self._refill()
            want = min(float(n), self.burst)
            missing = want - self._tokens
            if missing <= 0:
                return 0.0
            return missing / self.rate

    @property
    def utilization(self) -> float:
        """Fraction of burst capacity currently spent (0 idle, 1 empty)."""
        with self._lock:
            self._refill()
            return 1.0 - self._tokens / self.burst


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's admission contract. ``rate``/``burst`` are measured in
    *probes* (a 100-probe submission spends 100 tokens); ``priority`` is
    the class the brown-out ladder sheds by — higher survives longer."""

    tenant: str
    rate: float = 1000.0
    burst: float = 2000.0
    priority: int = 1


@dataclass
class AdmissionConfig:
    """Door policy knobs. ``max_concurrency`` bounds globally in-flight
    (admitted, unanswered) probes; ``retry_base_s`` seeds the escalating
    backoff hint capacity rejections carry (doubled per brown-out level,
    still always finite)."""

    max_concurrency: int = 4096
    default_rate: float = 1000.0
    default_burst: float = 2000.0
    default_priority: int = 1
    retry_base_s: float = 0.05
    #: brown-out ladder tuning (see BrownoutController)
    high_water: float = 0.85
    low_water: float = 0.5
    escalate_ticks: int = 3
    recover_ticks: int = 6
    shed_priority_below: int = 1


class BrownoutController:
    """The graceful-degradation ladder, driven by pressure observations
    (the ingress queue's occupancy fraction, 0..1) with hysteresis:
    ``escalate_ticks`` consecutive observations at or above ``high_water``
    climb one level, ``recover_ticks`` consecutive observations at or
    below ``low_water`` step one down — a single spike or dip never flaps
    the door. Every transition is traced, flight-recorded
    (``trigger_dump("brownout", ...)``) and counted."""

    def __init__(
        self,
        *,
        high_water: float = 0.85,
        low_water: float = 0.5,
        escalate_ticks: int = 3,
        recover_ticks: int = 6,
        shed_priority_below: int = 1,
    ) -> None:
        if not 0.0 <= low_water < high_water <= 1.0:
            raise ConfigError(
                f"brown-out waters must satisfy 0 <= low < high <= 1, got "
                f"low={low_water} high={high_water}"
            )
        self.high_water = high_water
        self.low_water = low_water
        self.escalate_ticks = max(1, int(escalate_ticks))
        self.recover_ticks = max(1, int(recover_ticks))
        self.shed_priority_below = int(shed_priority_below)
        self.level = 0
        self.transitions = 0
        self._hot = 0
        self._cool = 0
        self._lock = threading.Lock()
        ADMISSION_BROWNOUT_LEVEL.set(0.0)

    def observe(self, pressure: float) -> int:
        """Fold one pressure sample into the ladder; returns the (possibly
        new) level."""
        with self._lock:
            if pressure >= self.high_water:
                self._hot += 1
                self._cool = 0
            elif pressure <= self.low_water:
                self._cool += 1
                self._hot = 0
            else:
                self._hot = 0
                self._cool = 0
            if self._hot >= self.escalate_ticks and self.level < 3:
                self._transition(self.level + 1, pressure)
                self._hot = 0
            elif self._cool >= self.recover_ticks and self.level > 0:
                self._transition(self.level - 1, pressure)
                self._cool = 0
            return self.level

    def _transition(self, to: int, pressure: float) -> None:
        frm = self.level
        self.level = to
        self.transitions += 1
        ADMISSION_BROWNOUT_LEVEL.set(float(to))
        ADMISSION_BROWNOUT_TRANSITIONS_TOTAL.labels(to=str(to)).inc()
        rung = dict(BROWNOUT_LADDER)[to]
        with trace(
            "brownout_transition", frm=frm, to=to, pressure=round(pressure, 4)
        ):
            log_event(
                "brownout_transition",
                frm=frm, to=to, pressure=round(pressure, 4), rung=rung,
            )
        trigger_dump("brownout", frm=frm, to=to, pressure=pressure, rung=rung)

    @property
    def whatif_enabled(self) -> bool:
        """Level 1 is the first rung: shed the optional overlay work."""
        with self._lock:
            return self.level < 1

    def sheds(self, priority: int) -> bool:
        """Does the current level shed a request of this priority class?
        Level 2 sheds classes below ``shed_priority_below``; level 3
        sheds everyone — the door is closed."""
        with self._lock:
            if self.level >= 3:
                return True
            return self.level >= 2 and priority < self.shed_priority_below

    def describe(self) -> dict:
        with self._lock:
            return {
                "level": self.level,
                "rung": dict(BROWNOUT_LADDER)[self.level],
                "transitions": self.transitions,
            }


class AdmissionTicket:
    """Proof of admission for ``n`` probes: releasing it returns the
    concurrency slots. Idempotent; usable as a context manager."""

    def __init__(self, controller: "AdmissionController", tenant: str, n: int) -> None:
        self._controller = controller
        self.tenant = tenant
        self.n = n
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._controller._release(self.n)

    def __enter__(self) -> "AdmissionTicket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


@dataclass
class _TenantStats:
    admitted: int = 0
    probes: int = 0
    rejected: Dict[str, int] = field(default_factory=dict)


class AdmissionController:
    """The decision point every front-door submission passes. Checks run
    cheapest-rejection-first: the brown-out ladder (no state consumed),
    then the tenant's token bucket (the only check that spends anything),
    then the global concurrency limit (refunds the bucket on refusal so a
    capacity shed never double-charges the tenant)."""

    def __init__(
        self,
        quotas: Optional[Iterable[TenantQuota]] = None,
        *,
        config: Optional[AdmissionConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config or AdmissionConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._quotas: Dict[str, TenantQuota] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._stats: Dict[str, _TenantStats] = {}
        self._in_flight = 0
        cfg = self.config
        self.brownout = BrownoutController(
            high_water=cfg.high_water,
            low_water=cfg.low_water,
            escalate_ticks=cfg.escalate_ticks,
            recover_ticks=cfg.recover_ticks,
            shed_priority_below=cfg.shed_priority_below,
        )
        for q in quotas or ():
            self.set_quota(q)

    # ------------------------------------------------------------- quotas
    def set_quota(self, quota: TenantQuota) -> None:
        """Install (or replace) one tenant's contract; the bucket restarts
        full at the new capacity."""
        with self._lock:
            self._quotas[quota.tenant] = quota
            self._buckets[quota.tenant] = TokenBucket(
                quota.rate, quota.burst, clock=self._clock
            )

    def quota_for(self, tenant: str) -> TenantQuota:
        """The tenant's contract, or the config default for strangers."""
        with self._lock:
            q = self._quotas.get(tenant)
        if q is not None:
            return q
        cfg = self.config
        return TenantQuota(
            tenant=tenant,
            rate=cfg.default_rate,
            burst=cfg.default_burst,
            priority=cfg.default_priority,
        )

    def _bucket_for(self, tenant: str) -> TokenBucket:
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                cfg = self.config
                bucket = TokenBucket(
                    cfg.default_rate, cfg.default_burst, clock=self._clock
                )
                self._buckets[tenant] = bucket
            return bucket

    def _stats_for(self, tenant: str) -> _TenantStats:
        with self._lock:
            st = self._stats.get(tenant)
            if st is None:
                st = self._stats[tenant] = _TenantStats()
            return st

    # ---------------------------------------------------------- decisions
    def reject(
        self,
        tenant: str,
        reason: str,
        message: str,
        *,
        retry_after_s: float,
    ) -> None:
        """Count and raise one typed refusal (the single funnel every
        rejection — the controller's own and the ingress tier's
        queue-full / deadline refusals — goes through, so the per-tenant
        shed accounting can never drift from what callers saw)."""
        st = self._stats_for(tenant)
        with self._lock:
            st.rejected[reason] = st.rejected.get(reason, 0) + 1
        ADMISSION_REJECTIONS_TOTAL.labels(tenant=tenant, reason=reason).inc()
        raise AdmissionRejectedError(
            message,
            retry_after_s=max(0.001, float(retry_after_s)),
            tenant=tenant,
            reason=reason,
        )

    def _capacity_retry_after(self) -> float:
        """Backoff hint for capacity (non-quota) sheds: the base doubled
        per brown-out level — deeper overload tells clients to stay away
        longer, and the hint is finite at every rung."""
        return self.config.retry_base_s * (2.0 ** self.brownout.level)

    def admit(
        self,
        tenant: str,
        n: int = 1,
        *,
        priority: Optional[int] = None,
    ) -> AdmissionTicket:
        """Admit ``n`` probes for ``tenant`` or raise the typed refusal;
        the returned ticket must be released when the request resolves."""
        quota = self.quota_for(tenant)
        prio = quota.priority if priority is None else priority
        if self.brownout.sheds(prio):
            self.reject(
                tenant, "brownout",
                f"brown-out level {self.brownout.level} is shedding "
                f"priority-{prio} traffic for tenant {tenant!r}",
                retry_after_s=self._capacity_retry_after(),
            )
        bucket = self._bucket_for(tenant)
        if not bucket.take(n):
            ADMISSION_QUOTA_UTILIZATION.labels(tenant=tenant).set(
                bucket.utilization
            )
            self.reject(
                tenant, "over-quota",
                f"tenant {tenant!r} is over quota ({quota.rate:g} probes/s, "
                f"burst {quota.burst:g}; asked for {n})",
                retry_after_s=bucket.retry_after(n),
            )
        ADMISSION_QUOTA_UTILIZATION.labels(tenant=tenant).set(
            bucket.utilization
        )
        with self._lock:
            if self._in_flight + n > self.config.max_concurrency:
                in_flight = self._in_flight
            else:
                self._in_flight += n
                in_flight = -1
        if in_flight >= 0:
            # refund the bucket: a capacity shed must not also charge quota
            with bucket._lock:
                bucket._tokens = min(bucket.burst, bucket._tokens + n)
            self.reject(
                tenant, "concurrency",
                f"global concurrency limit reached ({in_flight} probes in "
                f"flight, limit {self.config.max_concurrency})",
                retry_after_s=self._capacity_retry_after(),
            )
        st = self._stats_for(tenant)
        with self._lock:
            st.admitted += 1
            st.probes += n
        return AdmissionTicket(self, tenant, n)

    def _release(self, n: int) -> None:
        with self._lock:
            self._in_flight = max(0, self._in_flight - n)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def observe_pressure(self, pressure: float) -> int:
        """Feed one queue-pressure sample to the brown-out ladder."""
        return self.brownout.observe(pressure)

    def describe(self) -> dict:
        """Per-tenant admission accounting + ladder state — the fragment
        the ingress tier nests into ``/healthz``."""
        with self._lock:
            tenants = {
                name: {
                    "admitted": st.admitted,
                    "probes": st.probes,
                    "rejected": dict(st.rejected),
                }
                for name, st in sorted(self._stats.items())
            }
            in_flight = self._in_flight
        return {
            "in_flight": in_flight,
            "max_concurrency": self.config.max_concurrency,
            "brownout": self.brownout.describe(),
            "tenants": tenants,
        }
