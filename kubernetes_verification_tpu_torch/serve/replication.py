"""Replicated serving: follower bootstrap, WAL tailing, lease failover.

The PyTorch port's copy of ``kubernetes_verification_tpu.serve.replication``.
A follower's engine lives where ``device`` says (``None`` means
``"cuda"``; the CPU only when the caller passes ``device="cpu"``), and it
answers from that engine alone: a failed derivation on the card reaches
the caller. The lease file's JSON is byte for byte the JAX package's.

The single-process :class:`~.service.VerificationService` is the
availability bottleneck of the serving story — one SIGKILL takes the
query plane down until the recovery ladder finishes. This module fans the
*read* path out while keeping exactly one write path, the same shape the
papers of PAPERS.md use for read-mostly replicated state:

* the **leader** owns the directory: it appends WAL records
  (:class:`~.events.WalWriter`), commits checkpoint generations
  (:class:`~.durability.CheckpointManager`) and renews ``leader.lease``;
* each **follower** (:class:`FollowerService`) bootstraps from the newest
  valid ``gen-N/`` checkpoint via the recovery ladder — a torn WAL
  tail or corrupt generation degrades down the ladder instead of
  crashing — then tails the leader's WAL with
  ``EventSource.start_after_seq`` exactly-once resume, applying batches
  to its *own* engine and answering queries from its own
  generation-keyed :class:`~.queries.QueryEngine`. It never writes.

**Staleness bounds.** Every follower read is bounded: ``max_lag_seconds``
/ ``max_lag_seq`` (CLI ``--staleness``) cap how far behind the leader's
WAL tip an answer may be. An over-bound read either raises a typed
:class:`~..resilience.errors.StaleReadError` carrying the measured lag
(outcome ``rejected`` on ``kvtpu_stale_reads_total``) or — under
``--proxy-stale`` — transparently answers with leader-fresh state
(outcome ``proxied``): through an injected leader-side query engine when
one is wired, else by forcing a full catch-up to the WAL tip, which on
the shared-filesystem substrate *is* the leader's committed state.

**Failover.** The lease file is a heartbeat: the leader re-writes
``leader.lease`` (atomically, tmp + fsync + ``os.replace``) every
``ttl/2`` or so; each record carries a monotonic ``epoch`` — the reign
counter. A follower promotes only when BOTH hold: the lease has expired
*and* its leader-probe circuit breaker has opened (several consecutive
failed probes — one missed renewal is jitter, not death). Promotion is
arbitrated in two layers: an ``O_CREAT|O_EXCL`` claim file per target
epoch thins the field, and the lease itself is the final word —
:meth:`LeaseFile.renew` runs its read-check-write under an exclusive
``flock`` and refuses an equal-epoch renewal by a different holder, so
even two claimants racing through a swept stale claim cannot both hold
one epoch. The winner bumps the lease epoch and stamps it into every WAL
record it subsequently writes. The deposed leader is *fenced* twice:
write-side (its :class:`WalWriter` re-reads the lease per append and
raises :class:`~..resilience.errors.FencedError` on a newer epoch) and
read-side (``scan_wal`` rejects epoch regressions at open;
:class:`~.events.EventSource` drops the same regressions while tailing,
and a follower raises its ``min_epoch`` floor only after its applied
stream has reached the new reign — never ahead of records it still owes
itself). Kill-points ``before-lease-renew`` and ``after-promote-epoch``
let the fault harness SIGKILL either side of the handover.
"""
from __future__ import annotations

import fcntl
import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..observe import log_event
from ..observe.progress import ProgressTicker
from ..observe.metrics import (
    PROMOTIONS_TOTAL,
    REPLICA_LAG_SECONDS,
    REPLICA_LAG_SEQ,
    STALE_READS_TOTAL,
)
from ..resilience.breaker import OPEN, CircuitBreaker
from ..resilience.errors import (
    FencedError,
    PersistError,
    ReplicationError,
    ServeError,
    StaleReadError,
)
from ..resilience.faults import kill_point
from .durability import RecoveryManager, _fsync_dir
from .events import EventSource, WalWriter
from .queries import QueryEngine

__all__ = [
    "LEASE_FILENAME",
    "Lease",
    "LeaseFile",
    "ReplicaLag",
    "FollowerService",
    "lease_path",
]

#: the lease lives next to the checkpoint generations it governs
LEASE_FILENAME = "leader.lease"


def lease_path(directory: str) -> str:
    """Canonical ``leader.lease`` path for a serving directory."""
    return os.path.join(directory, LEASE_FILENAME)


@dataclass(frozen=True)
class Lease:
    """One parsed ``leader.lease``: who reigns, since when, for how long.

    ``renewed_at`` is wall-clock (``time.time``) because leader and
    followers are different processes — monotonic clocks don't compare
    across them."""

    epoch: int
    holder: str
    renewed_at: float
    ttl: float

    def expired(self, now: Optional[float] = None) -> bool:
        if now is None:
            now = time.time()
        return now - self.renewed_at >= self.ttl

    def to_dict(self) -> dict:
        return {
            "epoch": int(self.epoch),
            "holder": self.holder,
            "renewed_at": float(self.renewed_at),
            "ttl": float(self.ttl),
        }


class LeaseFile:
    """The atomic heartbeat file behind the failover protocol.

    Writes go tmp + fsync + ``os.replace`` (the same discipline every
    durable artifact in ``serve/`` uses), so a reader sees either the old
    lease or the new one, never a prefix — and :meth:`renew` refuses to
    move the epoch backwards (:class:`FencedError`): a deposed leader's
    heartbeat cannot overwrite its successor's reign. ``clock`` is
    injectable (wall-clock semantics) so tests expire leases without
    sleeping.
    """

    def __init__(
        self, path: str, *, clock: Callable[[], float] = time.time
    ) -> None:
        if os.path.isdir(path):
            path = lease_path(path)
        self.path = path
        self._clock = clock

    def read(self) -> Optional[Lease]:
        """The current lease, or None when none was ever written. A
        damaged lease file raises :class:`PersistError` — it is written
        atomically, so damage is bit rot, not a torn write."""
        try:
            with open(self.path) as fh:
                obj = json.load(fh)
            return Lease(
                epoch=int(obj["epoch"]),
                holder=str(obj["holder"]),
                renewed_at=float(obj["renewed_at"]),
                ttl=float(obj["ttl"]),
            )
        except FileNotFoundError:
            return None
        except (OSError, ValueError, TypeError, KeyError) as e:
            raise PersistError(
                f"{self.path}: unreadable leader lease: {e}", path=self.path
            ) from e

    def renew(self, holder: str, epoch: int, ttl: float) -> Lease:
        """Atomically (re-)write the lease for ``holder`` at ``epoch``.

        Fencing lives here too: renewing below the on-disk epoch — or at
        the on-disk epoch as a *different* holder — raises
        :class:`FencedError`. The read-check-write runs under an
        exclusive ``flock`` on a sibling ``.lock`` file, making it a
        compare-and-swap: two promoters racing one target epoch
        serialise, the first wins the reign and the second is refused
        instead of silently clobbering it. A bit-rotted (unreadable)
        lease cannot fence anyone — its epoch is gone — so it is
        rewritten whole."""
        kill_point("before-lease-renew")
        lock_fd = os.open(self.path + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
            try:
                cur = self.read()
            except PersistError:
                cur = None
            if cur is not None and (
                cur.epoch > epoch
                or (cur.epoch == epoch and cur.holder != holder)
            ):
                raise FencedError(
                    f"{self.path}: lease epoch {cur.epoch} (held by "
                    f"{cur.holder!r}) supersedes {epoch} held by "
                    f"{holder!r} — renewal refused",
                    epoch=epoch, lease_epoch=cur.epoch,
                )
            lease = Lease(
                epoch=int(epoch), holder=holder,
                renewed_at=float(self._clock()), ttl=float(ttl),
            )
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(lease.to_dict(), fh, sort_keys=True)
                fh.write("\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
            _fsync_dir(os.path.dirname(self.path) or ".")
            return lease
        finally:
            os.close(lock_fd)  # closing the fd releases the flock

    def acquire(self, holder: str, ttl: float) -> Lease:
        """Take the lease for a *new* reign: epoch = on-disk epoch + 1
        (1 for a fresh directory). The leader calls this once at startup;
        promotion goes through :meth:`FollowerService.promote`."""
        cur = self.read()
        return self.renew(holder, (cur.epoch if cur else 0) + 1, ttl)

    def expired(self, now: Optional[float] = None) -> bool:
        """True when the lease is missing, unreadable (bit rot — a reign
        nobody can prove is no reign) or past its ttl: all three mean "no
        live leader" to a follower, matching ``heartbeat`` semantics."""
        try:
            cur = self.read()
        except PersistError:
            return True
        if cur is None:
            return True
        return cur.expired(self._clock() if now is None else now)

    def describe(self) -> dict:
        """Machine-readable lease status for ``kv-tpu recover --json``."""
        try:
            cur = self.read()
        except PersistError as e:
            return {"path": self.path, "present": True, "error": str(e)}
        if cur is None:
            return {"path": self.path, "present": False}
        now = self._clock()
        return {
            "path": self.path,
            "present": True,
            "epoch": cur.epoch,
            "holder": cur.holder,
            "ttl": cur.ttl,
            "renewed_at": cur.renewed_at,
            "age_seconds": max(0.0, now - cur.renewed_at),
            "expired": cur.expired(now),
        }


@dataclass(frozen=True)
class ReplicaLag:
    """One lag measurement: how far this follower trails the WAL tip."""

    #: seconds since this follower was last fully caught up (0.0 = at tip)
    seconds: float
    #: complete WAL records appended past our replay position
    seq: int

    @property
    def caught_up(self) -> bool:
        return self.seq == 0


class FollowerService:
    """A read-only replica: checkpoint bootstrap + WAL tail + bounded reads.

    Bootstraps through :class:`~.durability.RecoveryManager` (so every
    corruption mode a crashed leader can leave behind walks the recovery
    ladder instead of crashing the follower), then owns a positioned
    :class:`~.events.EventSource` whose ``start_after_seq`` resume
    guarantees zero duplicate applications. Queries go through the
    follower's own generation-keyed :class:`~.queries.QueryEngine`; the
    underlying service is marked ``read_only`` so nothing on this side
    can ever produce a durable artifact.

    ``engine_factory`` (``(cluster, config, device) -> engine``) makes a
    rebuilt follower serve from a packed matrix-free engine — combined
    with a packed leader checkpoint (auto-detected by the recovery
    ladder) a follower at 100k–1M pods answers batches from on-chip
    uint32 word rows without ever materialising a dense [N, N] matrix.

    ``auto_catch_up`` (default True) drains the WAL before every guarded
    read; tests and the bench turn it off to control lag explicitly.
    ``clock`` must be wall-clock compatible with the leader's lease clock
    (both default to ``time.time``); tests inject fakes to run the whole
    failover protocol in microseconds.
    """

    def __init__(
        self,
        directory: str,
        *,
        log_path: Optional[str] = None,
        replica: str = "follower-0",
        serve_config=None,
        config=None,
        device=None,
        initial_cluster=None,
        max_lag_seconds: Optional[float] = None,
        max_lag_seq: Optional[int] = None,
        proxy_stale: bool = False,
        leader_proxy: Optional[QueryEngine] = None,
        auto_catch_up: bool = True,
        lease_ttl: float = 5.0,
        breaker_threshold: int = 3,
        breaker_cooldown: float = 30.0,
        batch_size: int = 256,
        clock: Callable[[], float] = time.time,
        leader_url: Optional[str] = None,
        transport_timeout: float = 2.0,
        engine_factory=None,
    ) -> None:
        self.directory = directory
        self.replica = replica
        self.max_lag_seconds = max_lag_seconds
        self.max_lag_seq = max_lag_seq
        self.proxy_stale = proxy_stale
        self.leader_proxy = leader_proxy
        self.auto_catch_up = auto_catch_up
        self.lease_ttl = lease_ttl
        self.batch_size = batch_size
        self._clock = clock
        self.lease = LeaseFile(lease_path(directory), clock=clock)
        self.promoted = False
        self.epoch: Optional[int] = None
        #: the fenced WalWriter a successful :meth:`promote` leaves behind
        self.writer: Optional[WalWriter] = None
        self.applied = 0
        #: networked mode (``leader_url``): the leader is on another host,
        #: reached over serve.transport; the local ``directory`` holds the
        #: shipped checkpoint mirror, the WAL byte-mirror, and the standby
        #: lease/claim files this replica arbitrates promotion with
        self.leader_url = leader_url
        self.client = None
        self._last_remote_lease: Optional[dict] = None
        if leader_url is not None:
            # deferred import: transport imports this module at top level
            from .transport import ReplicationClient, bootstrap_from_leader

            os.makedirs(directory, exist_ok=True)
            self.client = ReplicationClient(
                leader_url, timeout=transport_timeout
            )
            bootstrap_from_leader(self.client, directory)
            if log_path is None:
                log_path = os.path.join(directory, "wal-mirror.jsonl")

        recovery = RecoveryManager(directory).recover(
            log_path=log_path,
            initial_cluster=initial_cluster,
            config=config,
            serve_config=serve_config,
            device=device,
            batch_size=batch_size,
            engine_factory=engine_factory,
        )
        self.recovery = recovery
        self.service = recovery.service
        self.service.read_only = True
        self.applied += recovery.replayed
        if recovery.source is not None:
            self.source = recovery.source
            self.log_path = recovery.source.path
        else:
            if log_path is None:
                raise ServeError(
                    f"{directory}: recovered checkpoint names no event log "
                    "and no log_path= was given — a follower without a WAL "
                    "to tail can never catch up"
                )
            self.log_path = log_path
            self.source = EventSource(
                log_path, start_after_seq=recovery.last_seq
            )
        if self.client is not None:
            from .transport import RemoteEventSource

            # wrap the positioned source: the mirror file grows by
            # fetching the leader's raw WAL bytes, every read-side
            # guarantee stays with the inner EventSource
            self.source = RemoteEventSource(
                self.client, self.log_path, inner=self.source, clock=clock
            )
        #: leader-probe breaker: consecutive expired-lease observations
        #: must exceed the threshold before failover even becomes
        #: *possible* — one missed renewal is scheduler jitter, not death
        self.probe = CircuitBreaker(
            f"leader-probe:{replica}",
            failure_threshold=breaker_threshold,
            cooldown=breaker_cooldown,
            clock=clock,
        )
        self._caught_up_at = self._clock()
        self.query = QueryEngine(self.service)
        self._set_lag_gauges(self.lag())
        log_event(
            "follower_bootstrap", replica=replica, directory=directory,
            outcome=recovery.outcome, generation=recovery.generation,
            replayed=recovery.replayed, last_seq=recovery.last_seq,
        )

    # ------------------------------------------------------------ replication
    def _pending_records(self) -> int:
        """Complete WAL records appended past our replay position — the
        sequence-space lag, measured without decoding."""
        try:
            size = os.path.getsize(self.log_path)
        except OSError:
            return 0
        if size <= self.source.offset:
            return 0
        with open(self.log_path, "rb") as fh:
            fh.seek(self.source.offset)
            chunk = fh.read()
        return chunk.count(b"\n")

    def lag(self) -> ReplicaLag:
        """Measure (don't repair) how far we trail the leader's tip.

        A networked follower's mirror stops growing the moment the wire
        does, so "nothing pending locally" is only freshness while the
        leader is in contact: past a grace of ``lease_ttl`` since the
        last successful fetch, staleness accrues from the last moment we
        were both caught up *and* in contact — a partitioned replica's
        lag grows instead of lying at zero."""
        pending = self._pending_records()
        now = self._clock()
        if pending == 0:
            if self._remote_contact_fresh(now):
                self._caught_up_at = now
                return ReplicaLag(seconds=0.0, seq=0)
            return ReplicaLag(
                seconds=max(0.0, now - self._caught_up_at), seq=0
            )
        return ReplicaLag(
            seconds=max(0.0, now - self._caught_up_at), seq=pending
        )

    def _remote_contact_fresh(self, now: float) -> bool:
        """Shared-filesystem followers read the leader's WAL directly —
        always "in contact". A networked one is fresh only within
        ``lease_ttl`` of its last successful fetch (or while it *is* the
        leader, having promoted)."""
        if self.client is None or self.promoted:
            return True
        last = getattr(self.source, "last_contact", None)
        if last is None:
            return False
        return now - last <= self.lease_ttl

    def _set_lag_gauges(self, lag: ReplicaLag) -> None:
        REPLICA_LAG_SECONDS.labels(replica=self.replica).set(lag.seconds)
        REPLICA_LAG_SEQ.labels(replica=self.replica).set(float(lag.seq))

    def poll(self) -> int:
        """Drain whatever the WAL has and apply it; returns events applied.
        One call is one replication step — the follower's heartbeat."""
        applied = 0
        for batch in self.source.batches(self.batch_size):
            self.service.apply(batch)
            applied += len(batch)
        self.applied += applied
        self._set_lag_gauges(self.lag())
        return applied

    def catch_up(self) -> int:
        """Drain to the current WAL tip (poll until nothing is pending).

        Bounded: an undecodable newline-terminated tail (a dead leader's
        torn buffered write) is left unconsumed by the source's
        last-line retry but still counts as a pending newline, so a poll
        that applies nothing without advancing the offset means the
        remainder is not consumable right now — return instead of
        spinning; a later catch-up (or the recovery ladder) retries it.

        A genuinely long replay (more than one batch pending — a follower
        restarted hours behind, not the per-read freshness poll) drives
        the progress plane: one ``wal_replay`` tick per poll round, total
        = the records pending at entry (an estimate — the leader may keep
        appending — so the fraction is against the tip as first seen)."""
        pending = self._pending_records()
        applied = self.poll()
        if pending <= self.batch_size:
            # the common per-read freshness poll: at most one batch —
            # not worth a progress job per query
            while self._pending_records() > 0:
                before = self.source.offset
                got = self.poll()
                applied += got
                if got == 0 and self.source.offset == before:
                    break
            return applied
        with ProgressTicker(
            "wal_replay", total=pending, unit="record", initial=applied
        ) as ticker:
            while self._pending_records() > 0:
                before = self.source.offset
                got = self.poll()
                applied += got
                ticker.tick(applied)
                if got == 0 and self.source.offset == before:
                    break
        return applied

    # ----------------------------------------------------------- bounded reads
    def _guard(self) -> QueryEngine:
        """The staleness gate every read goes through: catch up (unless
        ``auto_catch_up`` is off), measure lag, and either answer from our
        own engine, proxy to leader-fresh state, or raise
        :class:`StaleReadError` with the measurement."""
        if self.auto_catch_up:
            self.catch_up()
        lag = self.lag()
        self._set_lag_gauges(lag)
        over = (
            self.max_lag_seconds is not None
            and lag.seconds > self.max_lag_seconds
        ) or (self.max_lag_seq is not None and lag.seq > self.max_lag_seq)
        if not over:
            return self.query
        if self.proxy_stale:
            if self.leader_proxy is not None:
                STALE_READS_TOTAL.labels(outcome="proxied").inc()
                return self.leader_proxy
            # the WAL tip *is* the leader's committed state — on the
            # shared filesystem directly, over the network only when the
            # fetch actually reached the leader — so a full catch-up is
            # the proxy; a partitioned networked follower falls through
            # to the typed rejection instead of serving stale as fresh
            self.catch_up()
            if self._remote_contact_fresh(self._clock()):
                STALE_READS_TOTAL.labels(outcome="proxied").inc()
                return self.query
        STALE_READS_TOTAL.labels(outcome="rejected").inc()
        raise StaleReadError(
            f"replica {self.replica!r} is {lag.seconds:.3f}s / {lag.seq} "
            f"records behind the leader (bounds: "
            f"{self.max_lag_seconds}s / {self.max_lag_seq} records)",
            lag_seconds=lag.seconds, lag_seq=lag.seq,
            bound_seconds=self.max_lag_seconds, bound_seq=self.max_lag_seq,
        )

    def can_reach(self, *args, **kwargs):
        return self._guard().can_reach(*args, **kwargs)

    def can_reach_batch(self, *args, **kwargs):
        return self._guard().can_reach_batch(*args, **kwargs)

    def who_can_reach(self, *args, **kwargs):
        return self._guard().who_can_reach(*args, **kwargs)

    def who_can_reach_batch(self, *args, **kwargs):
        return self._guard().who_can_reach_batch(*args, **kwargs)

    def blast_radius(self, *args, **kwargs):
        return self._guard().blast_radius(*args, **kwargs)

    def blast_radius_batch(self, *args, **kwargs):
        return self._guard().blast_radius_batch(*args, **kwargs)

    def path_exists(self, *args, **kwargs):
        return self._guard().path_exists(*args, **kwargs)

    def hops(self, *args, **kwargs):
        return self._guard().hops(*args, **kwargs)

    def what_if(self, *args, **kwargs):
        return self._guard().what_if(*args, **kwargs)

    # --------------------------------------------------------------- failover
    def heartbeat(self) -> bool:
        """One leader-liveness probe: feed the breaker, raise our fencing
        floor where that is safe, and return True when the leader looked
        alive.

        A shared-filesystem follower reads ``leader.lease`` directly. A
        networked one probes the leader's ``/v1/tip`` — liveness is
        "reachable AND its served lease is unexpired by its own clock"
        (wall clocks don't compare across hosts, so the leader judges its
        own expiry) — and *also* honours the local standby lease: a
        co-located peer that promoted is a live leader too, so the
        breaker must not open against a healthy new reign."""
        if self.client is not None:
            return self._heartbeat_remote()
        try:
            cur = self.lease.read()
        except PersistError:
            cur = None
        now = self._clock()
        alive = cur is not None and not cur.expired(now)
        if cur is not None:
            self._raise_epoch_floor(cur.epoch)
        if alive:
            self.probe.record_success()
        else:
            self.probe.record_failure()
        return alive

    def _raise_epoch_floor(self, epoch: int) -> None:
        """Raise the read-side floor to the lease epoch ONLY once our
        applied stream has reached that reign: a follower still behind
        the promotion point owes itself the previous reign's committed
        records, and a floor above them would silently fence-drop
        committed state. Until then the EventSource's epoch-regression
        fencing alone drops a deposed writer's strays (an old epoch after
        a newer one)."""
        if (
            (self.source.min_epoch is None or epoch > self.source.min_epoch)
            and self.source.last_epoch is not None
            and self.source.last_epoch >= epoch
        ):
            self.source.min_epoch = epoch

    def _heartbeat_remote(self) -> bool:
        lease_d = None
        try:
            tip = self.client.tip()
        except ReplicationError:
            reachable = False
        else:
            reachable = True
            lease_d = tip.get("lease")
            self._last_remote_lease = lease_d
        alive = bool(
            reachable
            and lease_d
            and lease_d.get("present")
            and not lease_d.get("expired")
        )
        epoch: Optional[int] = None
        if lease_d and lease_d.get("present") and "epoch" in lease_d:
            epoch = int(lease_d["epoch"])
        # the local standby lease: a promoted peer's reign counts too
        try:
            local = self.lease.read()
        except PersistError:
            local = None
        if local is not None:
            if not local.expired(self._clock()):
                alive = True
            epoch = local.epoch if epoch is None else max(epoch, local.epoch)
        if epoch is not None:
            self._raise_epoch_floor(epoch)
        if alive:
            self.probe.record_success()
        else:
            self.probe.record_failure()
        return alive

    def maybe_promote(self) -> bool:
        """Breaker-gated failover step: promote only when the lease has
        expired AND the leader-probe breaker is open (enough consecutive
        failed heartbeats). Returns True when *this* replica won."""
        if self.promoted:
            return True
        if not self.lease.expired():
            return False
        if self.probe.state != OPEN:
            return False
        return self.promote() is not None

    def _claim_age(self, claim: str) -> Optional[float]:
        """A claim's age in the *injected* clock's time base: prefer the
        ``claimed_at`` its creator stamped inside (written with the same
        clock family), falling back to file mtime — comparable to the
        clock only when the clock is real wall time — for a claimant that
        died between creating the file and landing the stamp. None = the
        claim vanished underneath us (someone else swept it)."""
        try:
            with open(claim) as fh:
                stamped = json.load(fh)["claimed_at"]
            return self._clock() - float(stamped)
        except (OSError, ValueError, TypeError, KeyError):
            pass
        try:
            return self._clock() - os.path.getmtime(claim)
        except OSError:
            return None

    def _claim(self, target_epoch: int) -> bool:
        """First-layer arbitration: an ``O_CREAT|O_EXCL`` claim file per
        target epoch. A stale claim (older than the lease ttl with the
        epoch still unbumped — its creator died mid-promotion) is swept
        so the reign isn't deadlocked. The sweep's remove/recreate is
        racy by construction (two sweepers can both end up holding a
        claim); that is acceptable because the lease renewal, not the
        claim, is the final arbiter — ``renew`` is a locked
        compare-and-swap that refuses the second claimant."""
        claim = os.path.join(
            self.directory, f"promote-{target_epoch:08d}.claim"
        )
        for attempt in (0, 1):
            try:
                fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                if attempt:
                    return False
                age = self._claim_age(claim)
                if age is None:
                    return False
                try:
                    cur = self.lease.read()
                except PersistError:
                    cur = None
                stale = age > self.lease_ttl and (
                    cur is None or cur.epoch < target_epoch
                )
                if not stale:
                    return False
                try:
                    os.remove(claim)
                except OSError:
                    return False
                continue
            # O_EXCL creation decides this layer's race; the content
            # carries the holder and a claimed_at in the injected clock's
            # time base so later sweepers judge staleness with the same
            # clock that drives the rest of the protocol
            with os.fdopen(fd, "w") as fh:
                json.dump(
                    {"holder": self.replica, "claimed_at": self._clock()},
                    fh, sort_keys=True,
                )
                fh.write("\n")
            return True
        return False

    def promote(self) -> Optional[WalWriter]:
        """Take over as leader: catch up to the tip, win the epoch claim,
        bump the lease, and return a fenced :class:`WalWriter` stamping
        the new epoch (None = another follower won the claim).

        Callers that only need read-side promotion can drop the writer —
        holding the lease is what fences the old leader."""
        self.catch_up()
        try:
            cur = self.lease.read()
        except PersistError:
            cur = None  # bit rot: fall back to the highest applied epoch
        prior = cur.epoch if cur is not None else (self.source.last_epoch or 0)
        if self.client is not None:
            # a networked follower's local standby lease starts empty: the
            # reign to supersede is whatever the remote leader last served
            # us (or stamped into records we applied), never below it
            prior = max(prior, self.source.last_epoch or 0)
            remote = self._last_remote_lease
            if remote and remote.get("present") and "epoch" in remote:
                prior = max(prior, int(remote["epoch"]))
        target_epoch = prior + 1
        if not self._claim(target_epoch):
            log_event(
                "promotion_lost", replica=self.replica, epoch=target_epoch
            )
            return None
        try:
            self.lease.renew(self.replica, target_epoch, self.lease_ttl)
        except FencedError:
            # another promoter reached this epoch between our claim and
            # our renewal (a swept-claim race): the lease CAS says it
            # holds the reign, so we don't
            log_event(
                "promotion_lost", replica=self.replica, epoch=target_epoch
            )
            return None
        kill_point("after-promote-epoch")
        self.promoted = True
        self.epoch = target_epoch
        self.source.min_epoch = target_epoch
        if self.client is not None and hasattr(self.source, "detach"):
            # our mirror is the WAL of record now: appending a deposed
            # leader's bytes after our own higher-epoch records would
            # hand scan_wal an epoch regression on the next open
            self.source.detach()
        self.service.read_only = False
        PROMOTIONS_TOTAL.labels(replica=self.replica).inc()
        log_event(
            "promotion", replica=self.replica, epoch=target_epoch,
            applied=self.applied, last_seq=self.source.last_seq,
        )
        self.writer = WalWriter(
            self.log_path, epoch=target_epoch, lease=self.lease
        )
        return self.writer

    def repoint(self, leader_url: str, *, timeout: Optional[float] = None):
        """Follow a *new* leader after a failover: drop mirror bytes past
        our consumed prefix (unapplied bytes fetched from the old leader
        may not exist on the new one) and resume fetching from there.

        Only sound when our applied prefix is a prefix of the new
        leader's log — a replica that applied records the new leader
        never saw must re-bootstrap instead (the transport raises
        :class:`ReplicationError` on the shrunken-log shape it can
        detect; the README failure matrix covers the rest)."""
        if self.client is None:
            raise ServeError(
                f"replica {self.replica!r} is not networked — repoint() "
                "needs a follower constructed with leader_url="
            )
        from .transport import ReplicationClient

        client = ReplicationClient(
            leader_url,
            timeout=timeout if timeout is not None else self.client.timeout,
        )
        self.source.truncate_unconsumed()
        self.source.set_client(client)
        self.client = client
        self.leader_url = leader_url
        self._last_remote_lease = None
        log_event(
            "follower_repoint", replica=self.replica, leader_url=leader_url
        )

    # ------------------------------------------------------------------ misc
    @property
    def generation(self) -> int:
        return self.service.generation

    def describe(self) -> dict:
        """One status dict (CLI summaries, tests)."""
        lag = self.lag()
        out = {
            "replica": self.replica,
            "directory": self.directory,
            "log_path": self.log_path,
            "applied": self.applied,
            "last_seq": self.source.last_seq,
            "lag_seconds": lag.seconds,
            "lag_seq": lag.seq,
            "promoted": self.promoted,
            "epoch": self.epoch,
            "breaker": self.probe.state,
            "outcome": self.recovery.outcome,
        }
        if self.client is not None:
            err = getattr(self.source, "last_error", None)
            out.update(
                leader_url=self.leader_url,
                last_contact=getattr(self.source, "last_contact", None),
                transport_error=str(err) if err is not None else None,
            )
        return out

    def health(self) -> dict:
        """The replica-specific half of the ``/healthz`` document — the
        overlay a :class:`~.transport.ReplicationServer` started by
        :meth:`serve_http` applies over its base (leader-shaped) fields."""
        lag = self.lag()
        self._set_lag_gauges(lag)
        epoch = self.epoch
        if epoch is None:
            epoch = self.source.last_epoch
        out = {
            "role": "leader" if self.promoted else "follower",
            "replica": self.replica,
            "epoch": epoch,
            "last_seq": self.source.last_seq,
            "applied": self.applied,
            "lag": {"seconds": lag.seconds, "seq": lag.seq},
            "breakers": {self.probe.backend: self.probe.state},
            "outcome": self.recovery.outcome,
            "service": self.service.health(),
        }
        out["breakers"].update(out["service"].pop("breaker", {}))
        if self.client is not None:
            err = getattr(self.source, "last_error", None)
            out["leader_url"] = self.leader_url
            out["transport_error"] = str(err) if err is not None else None
        return out

    def serve_http(self, *, host: str = "127.0.0.1", port: int = 0):
        """Expose this replica on the wire: a
        :class:`~.transport.ReplicationServer` over the follower's own
        directory and WAL mirror (downstream replicas can chain off it)
        whose ``/healthz`` carries this replica's role, lag and breaker
        truth. Returns the started server; the caller owns its
        lifecycle."""
        from .transport import ReplicationServer

        server = ReplicationServer(
            self.directory,
            self.log_path,
            host=host,
            port=port,
            clock=self._clock,
            health_source=self.health,
        )
        server.start()
        return server
