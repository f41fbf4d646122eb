"""Deterministic fault injection: ``faulty:<name>`` backends.

The PyTorch port's copy of ``kubernetes_verification_tpu.resilience.faults``.

``register_faulty("torch", parse_fault_spec("device_loss"))`` registers a
``faulty:torch`` backend that delegates to the port's ``torch`` backend (or
``cpu``, the host oracle) but raises (or hangs) on a seeded, reproducible
schedule — so the resilience stack (retries, breakers, fallbacks) is
exercisable on the CPU, no broken hardware required. The injector object lives in the registry closure, so its call
counter survives across ``get_backend`` instantiations: ``flaky@0`` means
"the first verify call through this registration fails", not "every fresh
instance fails once".

Fault spec grammar (comma list; also the CLI's ``--inject-faults`` value):

* ``KIND``      — inject on every call (``device_loss`` → dead backend);
* ``KIND@N``    — inject on call index ``N`` only (``flaky@0`` → fails
  once, the retry succeeds);
* ``oom>T``     — inject OOM while the attempt's ``tile`` option (default
  2048) is above ``T`` — exercises adaptive degradation: the wrapper
  halves the tile until the injector relents;
* ``KIND%P``    — inject with probability ``P`` per call, drawn from a
  ``seed``-initialised PRNG (deterministic across runs).

Kinds: ``oom``, ``timeout`` (a simulated hang of ``hang_seconds`` — pair
with a watchdog), ``device_loss``, ``flaky`` (generic transient).

Every injection increments ``kvtpu_faults_injected_total{backend,kind}``.

Crash kill-points: the spec grammar also accepts the named points in the
durability write path (``after-tmp-write``, ``before-rename``,
``mid-log-append``, ``after-manifest``) and the replication control plane
(``before-lease-renew``, ``after-promote-epoch``). These are not backend
faults —
:func:`install_kill_points` arms them process-wide and the durability code
calls :func:`kill_point` at each site; a firing point hard-kills the
process with ``os._exit`` (no cleanup, no atexit — the closest userspace
stand-in for SIGKILL), which is what the recovery fuzz harness drives
through a subprocess.
"""
from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..observe.metrics import (
    FAULTS_INJECTED_TOTAL,
    INGRESS_FAULTS_INJECTED_TOTAL,
    NET_FAULTS_INJECTED_TOTAL,
)
from .errors import (
    BackendError,
    BackendOOM,
    ConfigError,
    DeviceLost,
    ReplicationError,
)

__all__ = [
    "FAULT_KINDS",
    "KILL_POINTS",
    "NET_FAULT_KINDS",
    "INGRESS_FAULT_KINDS",
    "FaultRule",
    "FaultInjector",
    "FaultyBackend",
    "KillPointInjector",
    "NetFaultInjector",
    "IngressFaultInjector",
    "parse_fault_spec",
    "register_faulty",
    "install_kill_points",
    "clear_kill_points",
    "kill_point",
    "install_net_faults",
    "clear_net_faults",
    "heal_net_partition",
    "net_fault",
    "install_ingress_faults",
    "clear_ingress_faults",
    "ingress_fault",
]

#: named crash points in the durability write path (serve/durability.py,
#: the WAL append path) and the replication control plane
#: (serve/replication.py lease renewal / promotion) — process-killing,
#: not backend faults
KILL_POINTS = (
    "after-tmp-write",
    "before-rename",
    "mid-log-append",
    "after-manifest",
    "before-lease-renew",
    "after-promote-epoch",
)

#: network fault kinds injected at the replication-transport seam
#: (serve/transport.py calls :func:`net_fault` before every wire request):
#: ``net-drop`` fails one request, ``net-delay`` adds latency to one,
#: ``net-partition`` latches — every request fails until
#: :func:`heal_net_partition` (or :func:`clear_net_faults`)
NET_FAULT_KINDS = ("net-drop", "net-delay", "net-partition")

#: client-behaviour faults injected at the ingress seam (serve/ingress.py
#: calls :func:`ingress_fault` once per client submission): ``client-burst``
#: amplifies one submission into an N-times arrival spike, ``slow-client``
#: stalls the request body before it reaches admission — both exercisable
#: under ``JAX_PLATFORMS=cpu``
INGRESS_FAULT_KINDS = ("client-burst", "slow-client")

FAULT_KINDS = (
    ("oom", "timeout", "device_loss", "flaky")
    + KILL_POINTS
    + NET_FAULT_KINDS
    + INGRESS_FAULT_KINDS
)

#: tile assumed when an ``oom>T`` rule fires against a config carrying no
#: explicit ``tile`` option — matches ResilienceConfig.initial_tile
_DEFAULT_TILE = 2048


@dataclass(frozen=True)
class FaultRule:
    """One injection rule; exactly one trigger dimension is set (or none,
    meaning "every call")."""

    kind: str
    at_call: Optional[int] = None
    while_tile_above: Optional[int] = None
    prob: Optional[float] = None

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ConfigError(
                f"unknown fault kind {self.kind!r}; have {FAULT_KINDS}"
            )
        if self.while_tile_above is not None and self.kind != "oom":
            raise ConfigError("'>' (tile relief) only applies to oom faults")


def parse_fault_spec(spec: str) -> List[FaultRule]:
    """Parse the ``KIND[@N|>T|%P]`` comma grammar (module docstring)."""
    rules = []
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        for sep, field in (("@", "at_call"), (">", "while_tile_above"), ("%", "prob")):
            if sep in token:
                kind, _, raw = token.partition(sep)
                try:
                    val = float(raw) if sep == "%" else int(raw)
                except ValueError:
                    raise ConfigError(
                        f"fault spec {token!r}: {raw!r} is not a number"
                    ) from None
                rules.append(FaultRule(kind=kind, **{field: val}))
                break
        else:
            rules.append(FaultRule(kind=token))
    if not rules:
        raise ConfigError(f"empty fault spec {spec!r}")
    return rules


class FaultInjector:
    """Seeded, thread-safe fault schedule shared by every instance of one
    ``faulty:*`` registration."""

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0) -> None:
        self.rules = list(rules)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.calls = 0

    def next_fault(self, config) -> Optional[str]:
        """Advance the call counter and return the fault kind to inject on
        this call, or None."""
        with self._lock:
            idx = self.calls
            self.calls += 1
            for rule in self.rules:
                if rule.at_call is not None:
                    if rule.at_call == idx:
                        return rule.kind
                elif rule.while_tile_above is not None:
                    tile = dict(config.backend_options).get(
                        "tile", _DEFAULT_TILE
                    )
                    if isinstance(tile, int) and tile > rule.while_tile_above:
                        return rule.kind
                elif rule.prob is not None:
                    if self._rng.random() < rule.prob:
                        return rule.kind
                else:
                    return rule.kind
        return None


class FaultyBackend:
    """A :class:`~..backends.base.VerifierBackend` decorator that injects
    the schedule's fault before delegating to the wrapped backend."""

    def __init__(
        self,
        inner,
        injector: FaultInjector,
        *,
        hang_seconds: float = 0.25,
        sleep=time.sleep,
    ) -> None:
        self.inner = inner
        self.injector = injector
        self.hang_seconds = hang_seconds
        self._sleep = sleep
        self.name = f"faulty:{inner.name}"
        self.supports_label_relation = inner.supports_label_relation

    def _inject(self, config) -> None:
        kind = self.injector.next_fault(config)
        if kind is None:
            return
        FAULTS_INJECTED_TOTAL.labels(backend=self.name, kind=kind).inc()
        if kind == "oom":
            raise BackendOOM(
                "injected RESOURCE_EXHAUSTED: out of memory while "
                "allocating reach tiles",
                backend=self.name,
            )
        if kind == "device_loss":
            raise DeviceLost("injected device loss", backend=self.name)
        if kind == "flaky":
            raise BackendError(
                "injected flaky dispatch", backend=self.name,
                kind="flaky", transient=True,
            )
        # kind == "timeout": a simulated hang, not an exception — the
        # caller's watchdog is what should notice. Without a watchdog this
        # is just added latency.
        self._sleep(self.hang_seconds)

    def verify(self, cluster, config):
        self._inject(config)
        return self.inner.verify(cluster, config)

    def verify_kano(self, containers, policies, config):
        self._inject(config)
        return self.inner.verify_kano(containers, policies, config)


def register_faulty(
    inner_name: str,
    rules: Sequence[FaultRule],
    *,
    seed: int = 0,
    hang_seconds: float = 0.25,
) -> str:
    """Register ``faulty:<inner_name>`` wrapping the already-registered
    ``inner_name`` backend with a fresh :class:`FaultInjector`; returns the
    new backend name. Re-registering replaces the previous schedule."""
    from ..backends.base import get_backend, register_backend

    get_backend(inner_name)  # fail fast on unknown inner backends
    for rule in rules:
        if rule.kind in KILL_POINTS:
            raise ConfigError(
                f"kill-point {rule.kind!r} is a process crash, not a "
                "backend fault — arm it with install_kill_points()"
            )
        if rule.kind in NET_FAULT_KINDS:
            raise ConfigError(
                f"network fault {rule.kind!r} fires at the replication-"
                "transport seam, not in a backend — arm it with "
                "install_net_faults()"
            )
        if rule.kind in INGRESS_FAULT_KINDS:
            raise ConfigError(
                f"ingress fault {rule.kind!r} fires at the front-door "
                "ingress seam, not in a backend — arm it with "
                "install_ingress_faults()"
            )
    injector = FaultInjector(rules, seed=seed)
    name = f"faulty:{inner_name}"
    register_backend(
        name,
        lambda: FaultyBackend(
            get_backend(inner_name), injector, hang_seconds=hang_seconds
        ),
    )
    return name


# ------------------------------------------------------------ kill points
class KillPointInjector:
    """Seeded, per-point-counting crash schedule: ``should_kill(name)``
    advances that point's hit counter and answers whether this hit is the
    one that dies (``KIND@N`` = hit index N, ``KIND%P`` = probability P
    per hit, bare ``KIND`` = every hit)."""

    def __init__(
        self,
        rules: Sequence[FaultRule],
        *,
        seed: int = 0,
        exit_code: int = 137,  # what a shell reports for SIGKILL
    ) -> None:
        self.rules = [r for r in rules if r.kind in KILL_POINTS]
        if not self.rules:
            raise ConfigError(
                f"no kill-point rules in {list(rules)!r}; known points: "
                f"{KILL_POINTS}"
            )
        self.exit_code = exit_code
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.hits: Dict[str, int] = {}

    def should_kill(self, point: str) -> bool:
        with self._lock:
            idx = self.hits.get(point, 0)
            self.hits[point] = idx + 1
            for rule in self.rules:
                if rule.kind != point:
                    continue
                if rule.at_call is not None:
                    if rule.at_call == idx:
                        return True
                elif rule.prob is not None:
                    if self._rng.random() < rule.prob:
                        return True
                else:
                    return True
        return False


#: the process-wide armed schedule (None = every kill_point() is a no-op)
_KILL_INJECTOR: Optional[KillPointInjector] = None


def install_kill_points(
    rules: Sequence[FaultRule], *, seed: int = 0, exit_code: int = 137
) -> KillPointInjector:
    """Arm the durability kill-points process-wide (rules typically come
    from ``parse_fault_spec("mid-log-append@7")``); returns the injector
    so a harness can inspect hit counters before the crash."""
    global _KILL_INJECTOR
    # kvtpu: ignore[concurrency-hygiene] armed by the fuzz harness before any worker thread starts; arm/disarm is single-threaded
    _KILL_INJECTOR = KillPointInjector(rules, seed=seed, exit_code=exit_code)
    return _KILL_INJECTOR


def clear_kill_points() -> None:
    """Disarm every kill-point (tests; the child process never needs to)."""
    global _KILL_INJECTOR
    _KILL_INJECTOR = None  # kvtpu: ignore[concurrency-hygiene] disarm happens on the harness thread after workers join


def kill_point(name: str, flush=None) -> None:
    """A named crash site. No-op unless armed via
    :func:`install_kill_points`; when the armed schedule fires, ``flush``
    (a file object, if given) is flushed so partially written bytes reach
    the OS — a torn tail, not an empty one — and the process dies with
    ``os._exit`` (bypassing ``finally``/``atexit``, like SIGKILL would).
    """
    inj = _KILL_INJECTOR
    if inj is None:
        return
    if inj.should_kill(name):
        FAULTS_INJECTED_TOTAL.labels(backend="durability", kind=name).inc()
        if flush is not None:
            flush.flush()
        try:
            # last act before the un-catchable exit: flush the flight
            # recorder ring so the post-mortem survives the "SIGKILL"
            from ..observe.flight import trigger_dump

            trigger_dump("kill-point", point=name)
        except Exception:
            pass  # dying is the contract; a failed dump must not block it
        os._exit(inj.exit_code)


# ---------------------------------------------------------- network faults
class NetFaultInjector:
    """Seeded, request-counting network fault schedule for the transport
    seam. One counter spans every wire operation (``tip``/``wal``/
    ``manifest``/``file``) so ``net-drop@3`` means "the 4th request this
    process makes fails", whatever it was for. ``net-partition`` *latches*:
    once its rule fires, every subsequent request fails until
    :meth:`heal` — the two-sided silence of a real partition, not a
    one-shot error."""

    def __init__(
        self,
        rules: Sequence[FaultRule],
        *,
        seed: int = 0,
        delay_seconds: float = 0.05,
        sleep=time.sleep,
    ) -> None:
        self.rules = [r for r in rules if r.kind in NET_FAULT_KINDS]
        if not self.rules:
            raise ConfigError(
                f"no network fault rules in {list(rules)!r}; known kinds: "
                f"{NET_FAULT_KINDS}"
            )
        self.delay_seconds = delay_seconds
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.calls = 0
        self.partitioned = False
        self.injected: Dict[str, int] = {}

    def next_fault(self) -> Optional[str]:
        """Advance the request counter and return the fault kind to inject
        on this request, or None."""
        with self._lock:
            idx = self.calls
            self.calls += 1
            if self.partitioned:
                self.injected["net-partition"] = (
                    self.injected.get("net-partition", 0) + 1
                )
                return "net-partition"
            for rule in self.rules:
                if rule.at_call is not None:
                    fired = rule.at_call == idx
                elif rule.prob is not None:
                    fired = self._rng.random() < rule.prob
                else:
                    fired = True
                if fired:
                    if rule.kind == "net-partition":
                        self.partitioned = True
                    self.injected[rule.kind] = (
                        self.injected.get(rule.kind, 0) + 1
                    )
                    return rule.kind
        return None

    def heal(self) -> None:
        """End a latched partition; other rules keep their schedule."""
        with self._lock:
            self.partitioned = False


#: the process-wide armed schedule (None = every net_fault() is a no-op)
_NET_INJECTOR: Optional[NetFaultInjector] = None


def install_net_faults(
    rules: Sequence[FaultRule],
    *,
    seed: int = 0,
    delay_seconds: float = 0.05,
    sleep=time.sleep,
) -> NetFaultInjector:
    """Arm the transport-seam network faults process-wide (rules typically
    come from ``parse_fault_spec("net-drop@2,net-delay%0.1")``); returns
    the injector so a harness can inspect counters and heal partitions."""
    global _NET_INJECTOR
    # kvtpu: ignore[concurrency-hygiene] armed by the chaos harness before any transport client issues requests; arm/disarm is single-threaded
    _NET_INJECTOR = NetFaultInjector(
        rules, seed=seed, delay_seconds=delay_seconds, sleep=sleep
    )
    return _NET_INJECTOR


def clear_net_faults() -> None:
    """Disarm every network fault (tests; also ends a latched partition)."""
    global _NET_INJECTOR
    _NET_INJECTOR = None  # kvtpu: ignore[concurrency-hygiene] disarm happens on the harness thread after the scenario finishes


def heal_net_partition() -> None:
    """Heal the armed injector's latched partition, keeping its other
    rules scheduled — the partition-then-heal chaos move."""
    inj = _NET_INJECTOR
    if inj is not None:
        inj.heal()


def net_fault(op: str) -> None:
    """The transport seam. :class:`~.serve.transport.ReplicationClient`
    calls this before every wire request; a firing ``net-delay`` sleeps
    ``delay_seconds`` and lets the request proceed, ``net-drop`` and
    ``net-partition`` raise :class:`ReplicationError` as if the connection
    died. No-op unless armed via :func:`install_net_faults`."""
    inj = _NET_INJECTOR
    if inj is None:
        return
    kind = inj.next_fault()
    if kind is None:
        return
    NET_FAULTS_INJECTED_TOTAL.labels(kind=kind, op=op).inc()
    if kind == "net-delay":
        inj._sleep(inj.delay_seconds)
        return
    raise ReplicationError(f"injected {kind} on {op!r} request", op=op)


# ---------------------------------------------------------- ingress faults
class IngressFaultInjector:
    """Seeded, submission-counting client-behaviour fault schedule for the
    front-door seam. One counter spans every client submission, so
    ``client-burst@3`` means "the 4th submission this process sees arrives
    as a burst". ``client-burst`` amplifies one submission into
    ``burst_factor`` arrivals (an arrival-rate spike the admission
    controller and bounded queue must absorb or shed); ``slow-client``
    stalls the submission ``stall_seconds`` before it reaches admission —
    a request body trickling in, which eats the request's own deadline
    budget, not the batcher's."""

    def __init__(
        self,
        rules: Sequence[FaultRule],
        *,
        seed: int = 0,
        burst_factor: int = 8,
        stall_seconds: float = 0.05,
        sleep=time.sleep,
    ) -> None:
        self.rules = [r for r in rules if r.kind in INGRESS_FAULT_KINDS]
        if not self.rules:
            raise ConfigError(
                f"no ingress fault rules in {list(rules)!r}; known kinds: "
                f"{INGRESS_FAULT_KINDS}"
            )
        if burst_factor < 1:
            raise ConfigError(
                f"burst_factor must be >= 1, got {burst_factor}"
            )
        self.burst_factor = int(burst_factor)
        self.stall_seconds = float(stall_seconds)
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.calls = 0
        self.injected: Dict[str, int] = {}

    def next_fault(self) -> Optional[str]:
        """Advance the submission counter and return the fault kind to
        inject on this submission, or None."""
        with self._lock:
            idx = self.calls
            self.calls += 1
            for rule in self.rules:
                if rule.at_call is not None:
                    fired = rule.at_call == idx
                elif rule.prob is not None:
                    fired = self._rng.random() < rule.prob
                else:
                    fired = True
                if fired:
                    self.injected[rule.kind] = (
                        self.injected.get(rule.kind, 0) + 1
                    )
                    return rule.kind
        return None


#: the process-wide armed schedule (None = every ingress_fault() is a no-op)
_INGRESS_INJECTOR: Optional[IngressFaultInjector] = None


def install_ingress_faults(
    rules: Sequence[FaultRule],
    *,
    seed: int = 0,
    burst_factor: int = 8,
    stall_seconds: float = 0.05,
    sleep=time.sleep,
) -> IngressFaultInjector:
    """Arm the front-door client faults process-wide (rules typically come
    from ``parse_fault_spec("client-burst@2,slow-client%0.1")``); returns
    the injector so a harness can inspect counters."""
    global _INGRESS_INJECTOR
    # kvtpu: ignore[concurrency-hygiene] armed by the chaos harness before any client submits; arm/disarm is single-threaded
    _INGRESS_INJECTOR = IngressFaultInjector(
        rules, seed=seed, burst_factor=burst_factor,
        stall_seconds=stall_seconds, sleep=sleep,
    )
    return _INGRESS_INJECTOR


def clear_ingress_faults() -> None:
    """Disarm every ingress fault (tests)."""
    global _INGRESS_INJECTOR
    _INGRESS_INJECTOR = None  # kvtpu: ignore[concurrency-hygiene] disarm happens on the harness thread after the scenario finishes


def ingress_fault() -> int:
    """The front-door seam. The ingress tier calls this once per client
    submission, *before* admission; returns the arrival amplification
    factor (1 = no fault). A firing ``client-burst`` returns
    ``burst_factor`` — the submission counts as that many arrivals, so
    quota, queue slots and batch pressure all see the spike. A firing
    ``slow-client`` sleeps ``stall_seconds`` (the stalled request body)
    and returns 1 — the stall burns the request's own deadline budget
    while the batcher keeps serving everyone else. No-op unless armed via
    :func:`install_ingress_faults`."""
    inj = _INGRESS_INJECTOR
    if inj is None:
        return 1
    kind = inj.next_fault()
    if kind is None:
        return 1
    INGRESS_FAULTS_INJECTED_TOTAL.labels(kind=kind).inc()
    if kind == "slow-client":
        inj._sleep(inj.stall_seconds)
        return 1
    return inj.burst_factor
