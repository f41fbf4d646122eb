"""The continuous-verification service core.

The PyTorch port of ``kubernetes_verification_tpu.serve.service``. One
:class:`VerificationService` owns one serving engine — the dense
:class:`~..incremental.IncrementalVerifier` or the packed
:class:`~..packed_incremental.PackedIncrementalVerifier` — and feeds it
mutation batches from a stream, with three serving-loop behaviours the
one-shot verbs don't have:

* **write-coalescing** — each drained batch is reduced to its net effect
  (:func:`~.events.coalesce`) before touching the engine, so a relabel
  storm on one pod costs one row/col patch and an add+remove pair costs
  nothing;
* **lazy solving** — applying a batch only marks the engine's reach
  derivation dirty; the actual solve runs when a query arrives, when
  declarative assertions must be re-checked, or when the configured
  staleness bound expires. Solves are therefore counted per *batch* (at
  most), not per event — the serving analogue of the paper's
  incremental-vs-rebuild argument;
* **warm restart** — the engine state snapshots through
  ``utils/persist.save_incremental`` so a crashed service resumes without
  re-solving from manifests.

Ingestion can be synchronous (:meth:`VerificationService.apply`) or run
behind the single worker thread (:meth:`start` / :meth:`submit` /
:meth:`flush`): the worker is the only thread that touches the engine once
started, and queries synchronise with it by draining the queue first.

The port's engines update their tensors in place, so every mutation and
every query dispatch runs under ``self._lock``: a device query state
aliases the live engine tensors and is valid only for its own generation.
The worker thread pins the engine's CUDA device (CUDA's current device is
per thread) and uses the one default stream every thread shares.

Time comes from the injectable clock of ``observe.events``
(``get_clock().perf()``): the staleness bound and the breaker cooldown
read it, so tests drive both with ``set_clock`` instead of sleeping.

Resilience: the engine's ``reach`` already retries transients
(``retry_transient``). When the incremental derivation still fails with a
:class:`~..resilience.errors.BackendError` (a kernel that did not build
is one), a private circuit breaker (``ServeConfig.breaker_threshold``)
records the failure, and while it is open queries skip the doomed
incremental solve until the cooldown admits a half-open probe. What
answers instead depends on where the engine lives:

* on the card, nothing: the error is re-raised, and an open breaker
  fails fast with a ``BackendError`` of kind ``"breaker_open"``. The work
  never moves to the host behind the caller's back;
* on the CPU (``device="cpu"``), the JAX package's semantics: a
  from-scratch verify of ``as_cluster()`` by the host NumPy oracle
  (``backend="cpu"``) answers, counted on ``kvtpu_fallbacks_total``.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..backends.base import VerifyConfig, verify
from ..incremental import IncrementalVerifier
from ..models.core import Cluster, Namespace
from ..observe import get_clock, trace
from ..ops.device_state import (
    DeviceStateCache,
    dense_query_state,
    packed_query_state,
)
from ..observe.metrics import (
    FALLBACKS_TOTAL,
    SERVE_BATCHES_TOTAL,
    SERVE_COALESCED_TOTAL,
    SERVE_EVENTS_TOTAL,
    SERVE_QUEUE_DEPTH,
    SERVE_SOLVES_TOTAL,
    SERVE_STALENESS_SECONDS,
)
from ..resilience.breaker import CircuitBreaker
from ..resilience.errors import BackendError, KvTpuError, PersistError, ServeError
from .events import (
    AddPolicy,
    Event,
    FullResync,
    RemoveNamespace,
    RemovePolicy,
    UpdateNamespaceLabels,
    UpdatePodLabels,
    UpdatePolicy,
    coalesce,
)

__all__ = ["ServeConfig", "ServeStats", "VerificationService"]


def _now() -> float:
    """Monotonic seconds from the shared injectable clock."""
    return get_clock().perf()


@dataclass
class ServeConfig:
    """Serving-loop knobs (the verification semantics live in
    :class:`~..backends.base.VerifyConfig`)."""

    #: seconds an applied-but-unsolved mutation may age before the worker
    #: re-derives on its own; None = fully lazy (solve only on query /
    #: assertion check)
    staleness_bound: Optional[float] = None
    #: max events the worker drains into one coalesced batch
    batch_size: int = 256
    #: directory to snapshot the warm engine into (None = no snapshots)
    snapshot_dir: Optional[str] = None
    #: snapshot every N applied batches (0 = only on close())
    snapshot_every: int = 0
    #: consecutive incremental-solve failures before the service's circuit
    #: breaker opens and queries skip the engine for the cooldown (a card
    #: engine fails fast, a CPU engine answers from the from-scratch CPU
    #: fallback); 0 disables the breaker
    breaker_threshold: int = 3
    #: seconds an open serving breaker waits before probing the
    #: incremental engine again
    breaker_cooldown: float = 30.0
    #: bound on the pending event queue; a full queue back-pressures
    #: submitters (blocking put) instead of growing without limit
    max_queue_events: int = 65536


@dataclass
class ServeStats:
    """Serving counters, mirrored onto the ``kvtpu_serve_*`` metric
    families; the CLI prints ``to_dict()`` as its summary line."""

    events_seen: int = 0
    events_applied: int = 0
    events_coalesced: int = 0
    batches: int = 0
    solves: Dict[str, int] = field(default_factory=dict)
    queries: Dict[str, int] = field(default_factory=dict)
    assertion_checks: int = 0
    assertion_failures: int = 0
    snapshots: int = 0

    @property
    def total_solves(self) -> int:
        return sum(self.solves.values())

    def to_dict(self) -> dict:
        return {
            "events_seen": self.events_seen,
            "events_applied": self.events_applied,
            "events_coalesced": self.events_coalesced,
            "batches": self.batches,
            "solves": dict(self.solves),
            "total_solves": self.total_solves,
            "queries": dict(self.queries),
            "assertion_checks": self.assertion_checks,
            "assertion_failures": self.assertion_failures,
            "snapshots": self.snapshots,
        }


class VerificationService:
    """A long-lived verifier: event batches in, always-current answers out.

    Construct from a :class:`Cluster` (cold start) or
    :meth:`from_snapshot` (warm restart). Synchronous use::

        svc = VerificationService(cluster)
        svc.apply(events)          # coalesce + incremental engine ops
        svc.reach()                # solves lazily, here

    Threaded use: :meth:`start` spawns the single worker; :meth:`submit`
    enqueues; :meth:`flush` blocks until the queue is drained (queries do
    this implicitly so answers reflect every submitted event).

    ``device=None`` means ``"cuda"`` (``BackendError`` without a GPU); the
    CPU runs only when the caller passes ``device="cpu"``.
    """

    def __init__(
        self,
        cluster: Optional[Cluster] = None,
        config: Optional[VerifyConfig] = None,
        serve_config: Optional[ServeConfig] = None,
        *,
        engine: Optional[IncrementalVerifier] = None,
        device=None,
        read_only: bool = False,
    ) -> None:
        if (cluster is None) == (engine is None):
            raise ServeError(
                "VerificationService needs exactly one of cluster= or "
                "engine="
            )
        if engine is None:
            cfg = config or VerifyConfig(compute_ports=False)
            engine = IncrementalVerifier(cluster, cfg, device=device)
        self._engine = engine
        #: the CUDA device index the worker thread pins (None off CUDA)
        self._cuda_index = self._device_index(engine.device)
        #: may a failed derivation be answered by the host oracle? Only for
        #: an engine the caller put on the CPU: a card engine's failure
        #: reaches the caller instead (a resync keeps the engine's device)
        self._host_fallback = torch.device(engine.device).type == "cpu"
        #: True when the engine serves from packed uint32 bitmap state
        #: (``PackedIncrementalVerifier``): queries ride the packed word
        #: kernels and never materialise a dense [N, N] operand
        self.packed = getattr(engine, "metrics_engine", "dense") == "packed"
        self.config = engine.config
        self.serve_config = serve_config or ServeConfig()
        #: follower mode (serve/replication.py): this replica applies the
        #: leader's WAL but must never produce durable artifacts of its own
        #: — snapshot() and the ingest worker refuse, keeping one write
        #: path per directory
        self.read_only = read_only
        self._pod_idx: Dict[Tuple[str, str], int] = {
            (p.namespace, p.name): i for i, p in enumerate(engine.pods)
        }
        self.stats = ServeStats()
        #: declarative allow/deny assertions (see ``serve.queries``),
        #: re-checked after every applied batch; violations accumulate here
        self.assertions: list = []
        self.violations: list = []
        self._lock = threading.RLock()
        self._queue: "queue.Queue[Event]" = queue.Queue(
            maxsize=self.serve_config.max_queue_events
        )
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._worker_error: Optional[KvTpuError] = None
        self._dirty_since: Optional[float] = None
        #: monotone engine-state generation: bumped whenever an applied
        #: batch mutates the engine (including full_resync). The query
        #: cache in ``serve.queries`` keys its memoized reach rows and
        #: port refinements on this — see :attr:`generation`.
        self._generation = 0
        #: reach matrix from a from-scratch fallback solve; valid until the
        #: next mutation (the incremental counts may be what broke)
        self._fallback_reach: Optional[np.ndarray] = None
        #: double-buffered device operands for the batched query plane,
        #: keyed on :attr:`generation` — see ``ops/device_state.py``
        self._device_states = DeviceStateCache()
        #: private breaker guarding the incremental derivation: while open,
        #: queries skip the doomed engine solve until the cooldown admits a
        #: probe (see the module docstring for what answers meanwhile)
        sc = self.serve_config
        self._breaker: Optional[CircuitBreaker] = (
            CircuitBreaker(
                "serve-dense",
                failure_threshold=sc.breaker_threshold,
                cooldown=sc.breaker_cooldown,
                clock=_now,
            )
            if sc.breaker_threshold > 0
            else None
        )
        #: posture observability plane (serve/posture.py), None until
        #: :meth:`enable_posture` — when set, every applied batch's
        #: device-state flip is followed by an exact reach-delta record
        self._posture = None

    @staticmethod
    def _device_index(device) -> Optional[int]:
        dev = torch.device(device)
        if dev.type != "cuda":
            return None
        return dev.index if dev.index is not None else torch.cuda.current_device()

    # ------------------------------------------------------------ snapshots
    @classmethod
    def from_snapshot(
        cls,
        directory: str,
        serve_config: Optional[ServeConfig] = None,
        *,
        config: Optional[VerifyConfig] = None,
        device=None,
    ) -> "VerificationService":
        """Warm restart: rebuild the engine from a ``save_incremental`` or
        ``save_packed_incremental`` checkpoint (crash recovery — no
        re-solve). The engine kind is probed from the checkpoint itself: a
        packed state file carries its slot layout (``pod_active``), a
        dense one its count matrices."""
        import os
        import zipfile

        from ..utils.persist import load_incremental, load_packed_incremental

        # the archive's member list is enough to tell the kinds apart; the
        # loader verifies every member's checksum once, after
        state_path = os.path.join(directory, "state.npz")
        try:
            with zipfile.ZipFile(state_path) as zf:
                is_packed = "pod_active.npy" in zf.namelist()
        except (zipfile.BadZipFile, OSError) as e:
            raise PersistError(
                f"{state_path}: unreadable or truncated checkpoint: {e}",
                path=state_path,
            ) from e
        if is_packed:
            engine = load_packed_incremental(
                directory, config=config, device=device
            )
        else:
            engine = load_incremental(directory, config=config, device=device)
        return cls(engine=engine, serve_config=serve_config)

    def snapshot(self, directory: Optional[str] = None) -> str:
        """Checkpoint the warm engine state for crash-recovery restart."""
        if self.read_only:
            raise ServeError(
                "read-only (follower) service cannot snapshot — the "
                "leader owns every durable artifact in the directory"
            )
        target = directory or self.serve_config.snapshot_dir
        if not target:
            raise ServeError(
                "no snapshot directory configured (ServeConfig.snapshot_dir)"
            )
        from ..utils.persist import save_incremental, save_packed_incremental

        with self._lock:
            if self.packed:
                save_packed_incremental(self._engine, target)
            else:
                save_incremental(self._engine, target)
            self.stats.snapshots += 1
        return target

    # -------------------------------------------------------------- applying
    @property
    def engine(self) -> IncrementalVerifier:
        return self._engine

    @property
    def generation(self) -> int:
        """Event-sequence generation of the engine state: bumped once per
        applied batch that actually mutated the engine. Memoized query
        answers (packed reach rows, port refinements) are valid exactly as
        long as this does not change."""
        with self._lock:
            return self._generation

    @property
    def n_pods(self) -> int:
        return len(self._engine.pods)

    def health(self) -> dict:
        """The serving core's fragment of the ``/healthz`` document:
        engine shape, generation, queue depth and the solve breaker —
        the process-local truth a replica overlay nests under
        ``service``."""
        br = self._breaker
        out = {
            "generation": self.generation,
            "n_pods": self.n_pods,
            "packed": bool(getattr(self, "packed", False)),
            "read_only": self.read_only,
            "events_applied": self.stats.events_applied,
            "queue_depth": (
                self._queue.qsize() if self._worker is not None else 0
            ),
        }
        if br is not None:
            out["breaker"] = {br.backend: br.state}
        if self._posture is not None:
            out["posture"] = self._posture.health()
        return out

    # --------------------------------------------------------------- posture
    @property
    def posture(self):
        """The :class:`~.posture.PostureTracker` when posture observability
        is enabled, else None."""
        return self._posture

    def enable_posture(
        self,
        journal_path=None,
        rules=(),
        top_k: Optional[int] = None,
    ):
        """Enable the posture observability plane: from the next applied
        batch on, every generation gets an exact reach-delta record
        (journaled when ``journal_path`` is set) with the alert ``rules``
        evaluated against it. The current generation is recorded
        immediately as the baseline.

        Refused on a matrix-free packed engine: with ``keep_matrix=False``
        there are no reach words to diff — posture needs the packed word
        state resident (still no dense [N, N] anywhere)."""
        from .posture import TOP_K_ROWS, PostureTracker

        with self._lock:
            if self._posture is not None:
                raise ServeError("posture observability already enabled")
            if self.packed and self._engine._packed is None:
                raise ServeError(
                    "matrix-free packed engine (keep_matrix=False) has no "
                    "reach words to diff — build the engine with "
                    "keep_matrix=True to enable posture observability"
                )
            self._posture = PostureTracker(
                self,
                journal_path=journal_path,
                rules=rules,
                top_k=top_k if top_k is not None else TOP_K_ROWS,
            )
            # force a posture-bearing front state NOW: the next flip
            # retires it, making it the previous generation every
            # subsequent diff runs against
            self._device_states.publish(self._build_device_state())
            self._posture.record()
            return self._posture

    def pod_index(self, namespace: str, name: str) -> int:
        """Engine row index for pod ``namespace/name`` (ServeError when the
        service holds no such pod)."""
        idx = self._pod_idx.get((namespace, name))
        if idx is None:
            raise ServeError(
                f"unknown pod {namespace}/{name} (service holds "
                f"{len(self._pod_idx)} pods)"
            )
        return idx

    def apply(self, events: Sequence[Event]) -> int:
        """Coalesce ``events`` into their net effect and apply them to the
        engine as one batch; returns the number of engine mutations.

        The solve stays lazy: this only dirties the derivation (unless
        assertions are configured, which force a post-batch check)."""
        events = list(events)
        if not events:
            return 0
        with self._lock:
            kept, dropped = coalesce(events)
            with trace(
                "serve_batch", events=len(events), applied=len(kept)
            ):
                for ev in dropped:
                    SERVE_COALESCED_TOTAL.labels(kind=ev.kind).inc()
                self.stats.events_seen += len(events)
                self.stats.events_coalesced += len(dropped)
                for i, ev in enumerate(kept):
                    try:
                        self._apply_one(ev)
                    except (KeyError, ValueError) as e:
                        if isinstance(e, KvTpuError):
                            raise
                        raise ServeError(
                            f"event {i} ({ev.kind}) rejected by the "
                            f"engine: {e}",
                            event_index=i,
                        ) from e
                    SERVE_EVENTS_TOTAL.labels(kind=ev.kind).inc()
                    self.stats.events_applied += 1
                self.stats.batches += 1
                SERVE_BATCHES_TOTAL.inc()
                if kept:
                    self._generation += 1
                    self._fallback_reach = None
                    self._refresh_device_state()
                    if self._posture is not None:
                        # the flip just retired the outgoing generation's
                        # words: diff them against the new front, exactly
                        self._posture.record()
                    if self._dirty_since is None:
                        self._dirty_since = _now()
            if self.assertions:
                self.check_assertions()
            sc = self.serve_config
            if sc.snapshot_dir and sc.snapshot_every and (
                self.stats.batches % sc.snapshot_every == 0
            ):
                self.snapshot()
        return len(kept)

    def _apply_one(self, ev: Event) -> None:
        eng = self._engine
        if isinstance(ev, AddPolicy):
            # idempotent, kubectl-apply style: adding a resident key is an
            # update (watch replays re-deliver adds after reconnects)
            key = f"{ev.policy.namespace}/{ev.policy.name}"
            if key in eng.policies:
                eng.update_policy(ev.policy)
            else:
                eng.add_policy(ev.policy)
        elif isinstance(ev, UpdatePolicy):
            key = f"{ev.policy.namespace}/{ev.policy.name}"
            if key in eng.policies:
                eng.update_policy(ev.policy)
            else:  # update of an unseen key (e.g. coalesced remove+add)
                eng.add_policy(ev.policy)
        elif isinstance(ev, RemovePolicy):
            eng.remove_policy(ev.namespace, ev.name)
        elif isinstance(ev, UpdatePodLabels):
            eng.update_pod_labels(
                self.pod_index(ev.namespace, ev.pod), dict(ev.labels)
            )
        elif isinstance(ev, UpdateNamespaceLabels):
            # add_namespace registers unknown namespaces and delegates
            # label changes on known ones to update_namespace_labels
            eng.add_namespace(Namespace(ev.namespace, dict(ev.labels)))
        elif isinstance(ev, RemoveNamespace):
            eng.remove_namespace(ev.namespace)
        elif isinstance(ev, FullResync):
            if self.packed:
                # rebuild with the SAME engine kind (and matrix mode): a
                # resync must not silently swap the query plane back to
                # dense state the deployment may not have memory for
                from ..packed_incremental import PackedIncrementalVerifier

                self._engine = PackedIncrementalVerifier(
                    ev.cluster,
                    self.config,
                    device=eng.device,
                    keep_matrix=eng._packed is not None,
                )
            else:
                self._engine = IncrementalVerifier(
                    ev.cluster, self.config, device=eng.device
                )
            self._pod_idx = {
                (p.namespace, p.name): i
                for i, p in enumerate(self._engine.pods)
            }
        else:
            raise ServeError(f"unhandled event kind {ev.kind!r}")

    # ------------------------------------------------------- device residency
    def _build_device_state(self):
        with_words = self._posture is not None
        return (
            packed_query_state(
                self._engine,
                self._generation,
                with_reach_words=with_words,
            )
            if self.packed
            else dense_query_state(
                self._engine,
                self._generation,
                with_reach_words=with_words,
            )
        )

    def _query_state(self):
        """Device operands for the current generation (lock held). Builds
        and flips in the front state on first use of a generation; warm
        batches reuse it with zero host→device transfers."""
        state = self._device_states.get(self._generation)
        if state is None:
            state = self._device_states.publish(self._build_device_state())
        return state

    def _refresh_device_state(self) -> None:
        """Write-path half of the double buffer (lock held, called once
        per applied batch): if the query plane has device state resident,
        commit the new generation's shadow state and flip it in — the old
        front retires intact, so a reader that picked it up just before
        the flip finishes its batch on stable buffers."""
        if self._device_states.peek() is not None:
            self._device_states.publish(self._build_device_state())

    # --------------------------------------------------------------- solving
    def reach(self, trigger: str = "query") -> np.ndarray:
        """The current reachability matrix, solving first if stale. With a
        worker running, submitted-but-unapplied events are drained first so
        the answer reflects the whole stream."""
        self.flush()
        return self._solve(trigger)

    def _solve(self, trigger: str) -> np.ndarray:
        with self._lock:
            eng = self._engine
            if self._fallback_reach is not None:
                return self._fallback_reach
            if self.packed:
                return self._solve_packed(trigger)
            if not eng._reach_dirty and eng._reach is not None:
                return np.asarray(eng.reach)
            # a clean reach still in the adopted posture words: unpacking
            # them is device work, so it runs behind the breaker, but it
            # counts no solve (the JAX service derived it while publishing)
            adopted = eng.reach_clean
            staleness = (
                _now() - self._dirty_since
                if self._dirty_since is not None
                else 0.0
            )
            br = self._breaker
            if br is not None and not br.allow():
                # circuit open: the engine has failed repeatedly and the
                # cooldown hasn't elapsed — don't pay a doomed solve
                if not self._host_fallback:
                    raise BackendError(
                        "the serving engine's reach failed "
                        f"{br.failure_threshold} times in a row; its "
                        "breaker is open until the cooldown admits a probe",
                        backend="serve-dense",
                        kind="breaker_open",
                        transient=True,
                    )
                reach = self._solve_fallback()
                trigger = "fallback"
            else:
                try:
                    reach = np.asarray(eng.reach)
                except BackendError:
                    if br is not None:
                        br.record_failure()
                    if not self._host_fallback:
                        raise
                    reach = self._solve_fallback()
                    trigger = "fallback"
                else:
                    if br is not None:
                        br.record_success()
                    if adopted:
                        return reach
            SERVE_SOLVES_TOTAL.labels(trigger=trigger).inc()
            self.stats.solves[trigger] = (
                self.stats.solves.get(trigger, 0) + 1
            )
            SERVE_STALENESS_SECONDS.set(staleness)
            self._dirty_since = None
            return reach

    def _solve_packed(self, trigger: str) -> np.ndarray:
        """Full-matrix answers on a packed engine (lock held). Only legal
        when the engine keeps its packed matrix — in matrix-free mode a
        dense [N, N] must never exist, so anything that genuinely needs
        the whole matrix is refused with guidance to the batched plane.
        Transients retry inside the engine; there is no from-scratch CPU
        fallback at packed scale."""
        eng = self._engine
        if eng._packed is None:
            raise ServeError(
                "matrix-free packed engine cannot materialise the dense "
                "reach matrix — use the batched query plane "
                "(can_reach_batch / who_can_reach / blast_radius) or "
                "build the engine with keep_matrix=True"
            )
        staleness = (
            _now() - self._dirty_since
            if self._dirty_since is not None
            else 0.0
        )
        reach = np.asarray(eng.reach)
        SERVE_SOLVES_TOTAL.labels(trigger=trigger).inc()
        self.stats.solves[trigger] = self.stats.solves.get(trigger, 0) + 1
        SERVE_STALENESS_SECONDS.set(staleness)
        self._dirty_since = None
        return reach

    def _solve_fallback(self) -> np.ndarray:
        """Incremental derivation of a CPU engine failed hard: answer from
        a from-scratch verify of the engine's current cluster snapshot by
        the host NumPy oracle. Never called for an engine on the card."""
        cfg = self.config
        res = verify(
            self._engine.as_cluster(),
            VerifyConfig(
                backend="cpu",
                compute_ports=False,
                self_traffic=cfg.self_traffic,
                default_allow_unselected=cfg.default_allow_unselected,
                direction_aware_isolation=cfg.direction_aware_isolation,
            ),
        )
        FALLBACKS_TOTAL.labels(
            from_backend="serve-dense", to_backend="cpu"
        ).inc()
        self._fallback_reach = np.asarray(res.reach)
        return self._fallback_reach

    def check_assertions(self) -> list:
        """Re-check the configured declarative assertions against the
        current state; new violations append to ``self.violations``."""
        from .queries import check_assertions

        with self._lock:
            found = check_assertions(self, self.assertions)
            self.stats.assertion_checks += 1
            self.stats.assertion_failures += len(found)
            self.violations.extend(found)
            return found

    # ------------------------------------------------------------- threading
    def start(self) -> None:
        """Spawn the single worker thread that owns engine writes."""
        with self._lock:
            if self.read_only:
                raise ServeError(
                    "read-only (follower) service takes no submissions — "
                    "events arrive only by tailing the leader's WAL"
                )
            if self._worker is not None and self._worker.is_alive():
                raise ServeError("service worker already running")
            self._stop.clear()
            self._worker = threading.Thread(
                target=self._run, name="kvtpu-serve-worker", daemon=True
            )
            self._worker.start()

    def submit(self, events: Sequence[Event]) -> None:
        """Enqueue events for the worker (start() must have been called)."""
        if self._worker is None:
            raise ServeError("submit() before start(); use apply() instead")
        for ev in events:
            self._queue.put(ev)

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted event has been applied; re-raise a
        worker-side error into the caller."""
        if self._worker is not None:
            deadline = (
                time.monotonic() + timeout if timeout is not None else None
            )
            while not self._queue.empty() or self._queue.unfinished_tasks:
                if self._worker_error is not None:
                    break
                if not self._worker.is_alive():
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise ServeError(
                        f"flush timed out after {timeout}s with "
                        f"{self._queue.qsize()} events pending"
                    )
                time.sleep(0.002)
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def close(self, snapshot: bool = False) -> None:
        """Stop the worker (draining first) and optionally snapshot."""
        if self._worker is not None:
            try:
                self.flush()
            finally:
                self._stop.set()
                self._worker.join(timeout=5.0)
                self._worker = None
        if snapshot and self.serve_config.snapshot_dir:
            self.snapshot()
        if self._posture is not None:
            self._posture.close()

    def _run(self) -> None:
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        sc = self.serve_config
        poll = 0.02 if sc.staleness_bound is None else min(
            0.02, sc.staleness_bound / 4
        )
        while not self._stop.is_set():
            batch: List[Event] = []
            try:
                batch.append(self._queue.get(timeout=poll))
            except queue.Empty:
                self._maybe_staleness_solve()
                continue
            while len(batch) < sc.batch_size:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            SERVE_QUEUE_DEPTH.set(float(self._queue.qsize()))
            try:
                self.apply(batch)
            except KvTpuError as e:
                # surface on the next flush()/reach(); keep draining so the
                # stream after a poison event still applies
                self._worker_error = e
            finally:
                for _ in batch:
                    self._queue.task_done()
        self._maybe_staleness_solve()

    def _maybe_staleness_solve(self) -> None:
        bound = self.serve_config.staleness_bound
        if bound is None:
            return
        with self._lock:
            if (
                self._dirty_since is not None
                and _now() - self._dirty_since >= bound
            ):
                self._solve("staleness")
