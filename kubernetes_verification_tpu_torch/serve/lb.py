"""Staleness-weighted query load balancing across replicas.

The PyTorch port's copy of ``kubernetes_verification_tpu.serve.lb``.

The read plane's front door: :class:`QueryLoadBalancer` spreads query
batches across a fleet of :class:`~.replication.FollowerService` replicas
(local or networked — anything with the query methods, a ``replica``
name, and a ``lag()``), routing each batch by **staleness-weighted
random choice**: a replica's weight is ``1 / (eps + lag_seconds)``, so a
caught-up follower absorbs most traffic, a lagging one tapers off
smoothly instead of cliff-dropping, and ``eps`` keeps a perfectly fresh
fleet from dividing by zero. The draw is seeded — a given fleet state
routes identically on every run, the same determinism contract as the
retry/fault stack.

Failure handling reuses the resilience stack unchanged:

* a replica that answers with :class:`~..resilience.errors.
  StaleReadError` (its staleness bound tripped) is *not* a failure — the
  batch retries against the leader when one is wired
  (``kvtpu_lb_stale_retries_total``), else the typed error propagates;
* a replica that fails at the transport layer
  (:class:`~..resilience.errors.ReplicationError`, connection errors)
  feeds its per-replica :class:`~..resilience.breaker.CircuitBreaker`;
  the breaker opening ejects it from rotation
  (``kvtpu_lb_ejections_total``) until its half-open probe readmits it,
  and the batch moves to the next candidate;
* every candidate exhausted falls back to the leader, and with no leader
  raises :class:`ReplicationError` — the caller's retry policy decides
  from there.

``kv-tpu lb`` (cli.py) fronts this with the same ``--batch`` JSONL
contract as ``kv-tpu query``.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..observe import log_event
from ..observe.metrics import (
    LB_EJECTIONS_TOTAL,
    LB_REQUESTS_TOTAL,
    LB_RETRIES_TOTAL,
    LB_STALE_RETRIES_TOTAL,
)
from ..observe.spans import trace
from ..resilience.breaker import OPEN, CircuitBreaker
from ..resilience.errors import ReplicationError, StaleReadError

__all__ = ["QueryLoadBalancer"]

#: transport-layer failures that eject a replica (typed first; raw
#: connection errors cover a replica dying mid-request)
_EJECTABLE = (ReplicationError, ConnectionError, OSError)


class QueryLoadBalancer:
    """Route query batches across ``replicas`` by staleness weight.

    ``leader`` (optional) is the stale-read and last-resort fallback —
    any object with the same query methods (a
    :class:`~.queries.QueryEngine`, or a FollowerService wired straight
    at the leader's directory). ``clock`` only feeds the breakers, so
    tests drive cooldowns without sleeping.

    Replicas are duck-typed, so a fleet may mix dense and packed
    (device-resident word-row) followers freely — the answers are
    bit-identical by construction and :meth:`describe` reports each
    replica's engine kind so a skewed mix is visible to operators."""

    def __init__(
        self,
        replicas: Sequence,
        *,
        leader=None,
        seed: int = 0,
        eps: float = 0.05,
        breaker_threshold: int = 3,
        breaker_cooldown: float = 30.0,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if not replicas and leader is None:
            raise ReplicationError(
                "a load balancer needs at least one replica or a leader",
                op="lb",
            )
        self.replicas = list(replicas)
        self.leader = leader
        self.eps = eps
        self._rng = random.Random(seed)
        self.breakers: Dict[str, CircuitBreaker] = {
            r.replica: CircuitBreaker(
                f"lb:{r.replica}",
                failure_threshold=breaker_threshold,
                cooldown=breaker_cooldown,
                clock=clock,
            )
            for r in self.replicas
        }
        #: routing stats: replica name (or 'leader') → batches answered
        self.routed: Dict[str, int] = {}
        self.stale_retries = 0
        self.ejections = 0

    # ------------------------------------------------------------- routing
    def _weight(self, replica) -> float:
        try:
            seconds = float(replica.lag().seconds)
        except _EJECTABLE:
            # a lag probe that can't even run demotes the replica to
            # minimum weight; the dispatch path ejects it properly
            seconds = float("inf")
        return 1.0 / (self.eps + max(0.0, seconds))

    def pick_order(self) -> List:
        """Candidates whose breaker admits traffic, in staleness-weighted
        random order (weighted sampling without replacement), so the
        first pick carries the routing policy and the rest are the
        fallback order."""
        cands = [
            r for r in self.replicas if self.breakers[r.replica].allow()
        ]
        order: List = []
        weights = [self._weight(r) for r in cands]
        while cands:
            total = sum(weights)
            if total <= 0:
                order.extend(cands)
                break
            pick = self._rng.random() * total
            acc = 0.0
            for i, w in enumerate(weights):
                acc += w
                if pick <= acc:
                    break
            order.append(cands.pop(i))
            weights.pop(i)
        return order

    def _answer_with_leader(self, method: str, args, kwargs, hops=None):
        LB_REQUESTS_TOTAL.labels(replica="leader").inc()
        self.routed["leader"] = self.routed.get("leader", 0) + 1
        if hops is not None:
            hops.append(
                {"hop": len(hops), "replica": "leader", "outcome": "served"}
            )
        return getattr(self.leader, method)(*args, **kwargs), "leader"

    def dispatch_batch(self, method: str, *args, **kwargs) -> Tuple[object, str]:
        """Route one call of ``method`` (e.g. ``can_reach_batch``);
        returns ``(result, who_answered)``.

        The whole routing decision is recorded on an ``lb_dispatch`` span:
        every hop's replica, staleness weight and outcome (``served`` /
        ``stale`` / ``transport``), so a stale-read retry that settles at
        the leader still names the replica that originally served — the
        trace answers "why did this batch land there" without correlating
        counters after the fact."""
        last_error: Optional[Exception] = None
        with trace("lb_dispatch", method=method) as span:
            hops: List[Dict[str, object]] = []
            span.attrs["route"] = hops
            for hop, replica in enumerate(self.pick_order()):
                name = replica.replica
                breaker = self.breakers[name]
                rec: Dict[str, object] = {
                    "hop": hop,
                    "replica": name,
                    "weight": round(self._weight(replica), 6),
                }
                hops.append(rec)
                LB_REQUESTS_TOTAL.labels(replica=name).inc()
                try:
                    result = getattr(replica, method)(*args, **kwargs)
                except StaleReadError as e:
                    # a healthy replica past its bound: not a failure —
                    # retry against leader-fresh state when we have it
                    breaker.record_success()
                    LB_STALE_RETRIES_TOTAL.inc()
                    LB_RETRIES_TOTAL.labels(reason="stale").inc()
                    self.stale_retries += 1
                    rec["outcome"] = "stale"
                    rec["lag_seconds"] = getattr(e, "lag_seconds", None)
                    if self.leader is not None:
                        return self._answer_with_leader(
                            method, args, kwargs, hops
                        )
                    raise
                except _EJECTABLE as e:
                    was_open = breaker.state == OPEN
                    breaker.record_failure()
                    if breaker.state == OPEN and not was_open:
                        LB_EJECTIONS_TOTAL.labels(replica=name).inc()
                        self.ejections += 1
                        log_event(
                            "lb_eject", replica=name, error=str(e)[:200]
                        )
                    LB_RETRIES_TOTAL.labels(reason="transport").inc()
                    rec["outcome"] = "transport"
                    last_error = e
                    continue
                breaker.record_success()
                rec["outcome"] = "served"
                self.routed[name] = self.routed.get(name, 0) + 1
                return result, name
            if self.leader is not None:
                return self._answer_with_leader(method, args, kwargs, hops)
            LB_RETRIES_TOTAL.labels(reason="exhausted").inc()
            raise ReplicationError(
                "every replica is ejected or failing and no leader fallback "
                f"is wired (last error: {last_error})",
                op="lb",
            )

    def can_reach_batch(self, probes):
        return self.dispatch_batch("can_reach_batch", probes)

    def dispatch(self, batches: Sequence) -> List[Tuple[object, str]]:
        """Spread ``batches`` (each a probe list for ``can_reach_batch``)
        across the fleet; returns ``[(result, who_answered), ...]`` in
        input order."""
        return [self.can_reach_batch(batch) for batch in batches]

    # ------------------------------------------------------------- status
    @staticmethod
    def _engine_kind(replica) -> str:
        svc = getattr(replica, "service", replica)
        return "packed" if getattr(svc, "packed", False) else "dense"

    def describe(self) -> dict:
        return {
            "replicas": [
                {
                    "replica": r.replica,
                    "engine": self._engine_kind(r),
                    "breaker": self.breakers[r.replica].state,
                    "weight": self._weight(r),
                    "routed": self.routed.get(r.replica, 0),
                }
                for r in self.replicas
            ],
            "leader": self.leader is not None,
            "routed_leader": self.routed.get("leader", 0),
            "stale_retries": self.stale_retries,
            "ejections": self.ejections,
        }
