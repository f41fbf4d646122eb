"""Typed cluster-mutation events + the JSONL wire codec + ``EventSource``.

The PyTorch port's copy of ``kubernetes_verification_tpu.serve.events``:
the same events, the same canonical JSON and the same WAL framing, so a log
written by either package is read by the other byte for byte.

The paper's verifiers are one-shot batch checkers; a serving loop instead
absorbs a *stream* of cluster mutations (the watch-API shape: one typed
delta per object change, Kano/HOTI'20 frames the same re-verification
problem as policy churn). This module is the ingest half of ``serve/``:

* one frozen dataclass per mutation kind, mirroring exactly the delta ops
  the incremental engines expose (``add_policy`` … ``remove_namespace``)
  plus :class:`FullResync` (the watch-API "relist" — drop all pending
  deltas and rebuild);
* a JSONL codec: one JSON object per line, ``{"event": <kind>, ...}``,
  with model objects carried as the same manifest-shaped dicts the YAML
  ingest layer parses (``parse_network_policy`` etc.), so a stream is
  greppable and hand-editable;
* :class:`EventSource` — replay a file in batches, or *tail* it while a
  producer appends (the file-backed stand-in for a watch connection).

Malformed lines raise :class:`~..resilience.errors.IngestError` with the
line number — a stream problem is an input error (exit 2), not a solver
failure.

WAL semantics (crash-safe durability, optional and backward-compatible):
a *sequenced* record additionally carries a monotonic ``seq`` number and a
``crc`` checksum over its canonical JSON body. :func:`scan_wal` validates a
log on open — a torn tail (a crash mid-append) is truncated-and-warned by
default (``kvtpu_wal_truncations_total``) or raises
:class:`~..resilience.errors.ServeError` in ``strict`` mode, while
corruption *followed by* valid records always raises (that is bit rot, not
a tear). :class:`WalWriter` appends sequenced records, resuming the
sequence from the existing log, and hosts the ``mid-log-append`` kill
point for the crash-fault harness. Unsequenced (legacy) logs keep working
everywhere: records without ``seq``/``crc`` decode as before and simply
don't participate in duplicate-application skipping.

Replication adds a third framing field: ``epoch``, the writer's monotonic
reign counter from ``leader.lease`` (serve/replication.py). The epoch is
covered by the record crc, so a fenced stray writer cannot forge a newer
reign; :func:`scan_wal` rejects epoch *regressions* mid-log (a lower epoch
after a higher one is a stale leader that kept writing past its fencing),
and :class:`EventSource` drops the same regressions while live-tailing —
plus anything below an explicit ``min_epoch`` floor — on the read side
(counted in ``fenced``) as defence in depth. Records without an ``epoch``
stay valid — pre-replication logs keep replaying.
"""
from __future__ import annotations

import json
import os
import random
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..ingest.yaml_io import (
    namespace_to_dict,
    network_policy_to_dict,
    parse_namespace,
    parse_network_policy,
    parse_pod,
    pod_to_dict,
)
from ..models.core import Cluster, NetworkPolicy
from ..resilience.errors import IngestError, ServeError

__all__ = [
    "Event",
    "AddPolicy",
    "RemovePolicy",
    "UpdatePolicy",
    "UpdatePodLabels",
    "UpdateNamespaceLabels",
    "RemoveNamespace",
    "FullResync",
    "EVENT_KINDS",
    "encode_event",
    "decode_event",
    "decode_record",
    "decode_wal",
    "write_events",
    "read_events",
    "EventSource",
    "coalesce",
    "WalInfo",
    "WalWriter",
    "scan_wal",
]

#: reserved record keys for WAL framing; no event body uses any of them
WAL_SEQ_KEY = "seq"
WAL_CRC_KEY = "crc"
WAL_EPOCH_KEY = "epoch"


@dataclass(frozen=True)
class Event:
    """Base of the mutation-event model. ``kind`` is the wire tag and the
    label value on the ``kvtpu_serve_*`` metric families."""

    kind = "event"

    @property
    def key(self) -> Optional[str]:
        """Coalescing identity: events with equal non-None keys mutate the
        same object, so the service may fold them. None = never coalesced."""
        return None


@dataclass(frozen=True)
class AddPolicy(Event):
    kind = "add_policy"
    policy: NetworkPolicy = None  # type: ignore[assignment]

    @property
    def key(self) -> str:
        return f"policy/{self.policy.namespace}/{self.policy.name}"


@dataclass(frozen=True)
class RemovePolicy(Event):
    kind = "remove_policy"
    namespace: str = "default"
    name: str = ""

    @property
    def key(self) -> str:
        return f"policy/{self.namespace}/{self.name}"


@dataclass(frozen=True)
class UpdatePolicy(Event):
    kind = "update_policy"
    policy: NetworkPolicy = None  # type: ignore[assignment]

    @property
    def key(self) -> str:
        return f"policy/{self.policy.namespace}/{self.policy.name}"


@dataclass(frozen=True)
class UpdatePodLabels(Event):
    kind = "update_pod_labels"
    namespace: str = "default"
    pod: str = ""
    labels: Dict[str, str] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"pod/{self.namespace}/{self.pod}"


@dataclass(frozen=True)
class UpdateNamespaceLabels(Event):
    kind = "update_namespace_labels"
    namespace: str = ""
    labels: Dict[str, str] = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"namespace/{self.namespace}"


@dataclass(frozen=True)
class RemoveNamespace(Event):
    """Never coalesced (``key`` stays None): a preceding relabel may be
    what *registers* the namespace, so folding the pair to a bare removal
    would make a valid stream invalid. Both ops are cheap host
    bookkeeping anyway — there is nothing to save."""

    kind = "remove_namespace"
    namespace: str = ""


@dataclass(frozen=True)
class FullResync(Event):
    """The relist: replace the engine's entire state with ``cluster``.
    Pending (uncommitted) deltas before a resync are dead weight — the
    coalescer discards them, exactly like a watch client dropping its
    buffered deltas on a relist."""

    kind = "full_resync"
    cluster: Cluster = None  # type: ignore[assignment]


#: kind tag → event class (the codec's dispatch table)
EVENT_KINDS: Dict[str, type] = {
    cls.kind: cls
    for cls in (
        AddPolicy,
        RemovePolicy,
        UpdatePolicy,
        UpdatePodLabels,
        UpdateNamespaceLabels,
        RemoveNamespace,
        FullResync,
    )
}


# ----------------------------------------------------------------- codec
def _cluster_to_dict(cluster: Cluster) -> dict:
    return {
        "namespaces": [namespace_to_dict(ns) for ns in cluster.namespaces],
        "pods": [pod_to_dict(p) for p in cluster.pods],
        "policies": [network_policy_to_dict(p) for p in cluster.policies],
    }


def _cluster_from_dict(obj: dict) -> Cluster:
    return Cluster(
        pods=[parse_pod(d) for d in obj.get("pods", [])],
        namespaces=[parse_namespace(d) for d in obj.get("namespaces", [])],
        policies=[parse_network_policy(d) for d in obj.get("policies", [])],
    )


def _wal_crc(canonical: str) -> str:
    """crc32 (hex) over a record's canonical JSON — cheap per-record
    integrity for torn-tail detection; sha256 guards the snapshots."""
    return format(zlib.crc32(canonical.encode("utf-8")) & 0xFFFFFFFF, "08x")


def encode_event(
    ev: Event, seq: Optional[int] = None, epoch: Optional[int] = None
) -> str:
    """One JSON line (no trailing newline) for one event. With ``seq`` the
    record is WAL-framed: it carries the sequence number plus a crc over
    the canonical body, so a torn or bit-rotted tail is detectable.
    ``epoch`` (only meaningful on framed records) stamps the writer's
    lease reign and is covered by the crc — a fenced writer cannot be
    edited into a newer one."""
    if isinstance(ev, (AddPolicy, UpdatePolicy)):
        body = {"policy": network_policy_to_dict(ev.policy)}
    elif isinstance(ev, RemovePolicy):
        body = {"namespace": ev.namespace, "name": ev.name}
    elif isinstance(ev, UpdatePodLabels):
        body = {
            "namespace": ev.namespace, "pod": ev.pod,
            "labels": dict(ev.labels),
        }
    elif isinstance(ev, UpdateNamespaceLabels):
        body = {"namespace": ev.namespace, "labels": dict(ev.labels)}
    elif isinstance(ev, RemoveNamespace):
        body = {"namespace": ev.namespace}
    elif isinstance(ev, FullResync):
        body = {"cluster": _cluster_to_dict(ev.cluster)}
    else:
        raise IngestError(f"cannot encode event of type {type(ev).__name__}")
    obj = {"event": ev.kind, **body}
    if seq is None:
        return json.dumps(obj, sort_keys=True)
    obj[WAL_SEQ_KEY] = int(seq)
    if epoch is not None:
        obj[WAL_EPOCH_KEY] = int(epoch)
    obj[WAL_CRC_KEY] = _wal_crc(json.dumps(obj, sort_keys=True))
    return json.dumps(obj, sort_keys=True)


def decode_event(line: str, *, where: str = "<event>") -> Event:
    """Parse one JSONL line into an :class:`Event`; ``where`` names the
    source (file:lineno) in diagnostics."""
    return decode_record(line, where=where)[0]


def decode_record(
    line: str, *, where: str = "<event>"
) -> Tuple[Event, Optional[int]]:
    """Parse one JSONL line into ``(event, seq)``; ``seq`` is None on
    unsequenced (legacy) records. A present ``crc`` is verified against
    the canonical body and a mismatch raises :class:`IngestError`. The
    epoch-aware callers (scan/tail/replication) use :func:`decode_wal`."""
    ev, seq, _ = decode_wal(line, where=where)
    return ev, seq


def decode_wal(
    line: str, *, where: str = "<event>"
) -> Tuple[Event, Optional[int], Optional[int]]:
    """Parse one JSONL line into ``(event, seq, epoch)``; ``seq`` and
    ``epoch`` are None on records written without WAL framing / before
    replication. A present ``crc`` is verified against the canonical body
    (seq *and* epoch re-inserted) and a mismatch raises
    :class:`IngestError`."""
    try:
        obj = json.loads(line)
    except json.JSONDecodeError as e:
        raise IngestError(f"{where}: not valid JSON: {e}") from e
    if not isinstance(obj, dict) or "event" not in obj:
        raise IngestError(f"{where}: event line lacks an 'event' tag")
    seq = obj.pop(WAL_SEQ_KEY, None)
    epoch = obj.pop(WAL_EPOCH_KEY, None)
    crc = obj.pop(WAL_CRC_KEY, None)
    if seq is not None and not isinstance(seq, int):
        raise IngestError(f"{where}: WAL seq {seq!r} is not an integer")
    if epoch is not None and not isinstance(epoch, int):
        raise IngestError(f"{where}: WAL epoch {epoch!r} is not an integer")
    if crc is not None:
        body = dict(obj)
        if seq is not None:
            body[WAL_SEQ_KEY] = seq
        if epoch is not None:
            body[WAL_EPOCH_KEY] = epoch
        want = _wal_crc(json.dumps(body, sort_keys=True))
        if crc != want:
            raise IngestError(
                f"{where}: WAL record checksum mismatch (stored {crc!r}, "
                f"computed {want!r}) — torn or corrupted record"
            )
    kind = obj["event"]
    cls = EVENT_KINDS.get(kind)
    if cls is None:
        raise IngestError(
            f"{where}: unknown event kind {kind!r} (known: "
            f"{sorted(EVENT_KINDS)})"
        )
    try:
        if cls in (AddPolicy, UpdatePolicy):
            return cls(policy=parse_network_policy(obj["policy"])), seq, epoch
        if cls is RemovePolicy:
            return RemovePolicy(
                namespace=obj["namespace"], name=obj["name"]
            ), seq, epoch
        if cls is UpdatePodLabels:
            return UpdatePodLabels(
                namespace=obj["namespace"], pod=obj["pod"],
                labels=dict(obj.get("labels") or {}),
            ), seq, epoch
        if cls is UpdateNamespaceLabels:
            return UpdateNamespaceLabels(
                namespace=obj["namespace"],
                labels=dict(obj.get("labels") or {}),
            ), seq, epoch
        if cls is RemoveNamespace:
            return RemoveNamespace(namespace=obj["namespace"]), seq, epoch
        return (
            FullResync(cluster=_cluster_from_dict(obj["cluster"])), seq, epoch
        )
    except IngestError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise IngestError(
            f"{where}: malformed {kind!r} event: {e!r}"
        ) from e


def write_events(
    events: Sequence[Event],
    path: str,
    *,
    start_seq: Optional[int] = None,
    fsync: bool = False,
) -> int:
    """Append ``events`` to ``path`` as JSONL; returns the count written.
    With ``start_seq`` the records are WAL-framed (``seq``/``crc``),
    numbered consecutively from it; ``fsync`` makes the append durable
    before returning."""
    with open(path, "a") as fh:  # kvtpu: ignore[atomic-write] WAL append: scan_wal truncates a torn tail on recovery
        for i, ev in enumerate(events):
            seq = None if start_seq is None else start_seq + i
            fh.write(encode_event(ev, seq=seq) + "\n")
        if fsync:
            fh.flush()
            os.fsync(fh.fileno())
    return len(events)


def read_events(path: str) -> List[Event]:
    """Decode a whole JSONL stream (blank lines skipped)."""
    return list(EventSource(path).replay())


class EventSource:
    """A replayable, tail-able JSONL event stream.

    * :meth:`replay` — decode from the current offset to EOF (one pass);
    * :meth:`batches` — the same, grouped into ≤``batch_size`` chunks;
    * :meth:`tail` — keep polling the file for appended lines, yielding a
      batch per drain, until ``idle_timeout`` seconds pass with no growth
      (None = forever). A partial final line (a writer mid-append) is left
      unconsumed until its newline arrives.

    Racing a live writer: the *final* line of a drain may be mid-flush
    even when its newline already landed (a torn buffered write), so a
    decode failure there leaves the line unconsumed (offset not advanced)
    to be retried on the next drain instead of raising; ``strict=True``
    restores the raise. A bad line *followed by* complete lines is real
    corruption and always raises.

    The byte ``offset`` is resumable state: a service checkpoint can store
    it and a restart continues the stream where the crash left it. On WAL
    (sequenced) streams, ``start_after_seq`` skips records whose ``seq``
    is already applied — the zero-duplicate-application half of recovery —
    counting them in ``skipped``; ``last_seq`` tracks the highest applied
    sequence number (-1 until one is seen). Read-side fencing drops (and
    counts in ``fenced``) any record whose lease epoch *regresses* — an
    older reign's record appearing after a newer reign's is a superseded
    leader that kept writing (:func:`scan_wal` raises on the same shape at
    open; a live tail drops it and moves on) — as well as anything below
    an explicit ``min_epoch`` floor; ``last_epoch`` tracks the highest
    epoch seen. Raising ``min_epoch`` is only safe once every committed
    record below it has already been consumed (see
    ``FollowerService.heartbeat``), which is why regression fencing, not
    the floor, is the primary guard.
    """

    def __init__(
        self,
        path: str,
        offset: int = 0,
        *,
        start_after_seq: Optional[int] = None,
        min_epoch: Optional[int] = None,
        strict: bool = False,
    ) -> None:
        self.path = path
        self.offset = offset
        self.lineno = 0
        self.strict = strict
        self.last_seq = -1 if start_after_seq is None else int(start_after_seq)
        self.min_epoch = min_epoch
        self.last_epoch: Optional[int] = None
        self.skipped = 0
        self.fenced = 0

    def _drain(self) -> List[Event]:
        with open(self.path, "rb") as fh:
            fh.seek(self.offset)
            chunk = fh.read()
        out: List[Event] = []
        lines = chunk.splitlines(keepends=True)
        for n, raw in enumerate(lines):
            if not raw.endswith(b"\n"):
                break  # partial trailing line: a writer is mid-append
            line = raw.decode("utf-8", errors="replace").strip()
            if not line:
                self.offset += len(raw)
                self.lineno += 1
                continue
            try:
                ev, seq, epoch = decode_wal(
                    line, where=f"{self.path}:{self.lineno + 1}"
                )
            except IngestError:
                if n == len(lines) - 1 and not self.strict:
                    # the writer's final append may have landed its newline
                    # before the rest of the record (torn buffered write):
                    # leave it unconsumed and retry on the next drain
                    break
                raise
            self.offset += len(raw)
            self.lineno += 1
            if epoch is not None:
                if (self.min_epoch is not None and epoch < self.min_epoch) or (
                    self.last_epoch is not None and epoch < self.last_epoch
                ):
                    # below the explicit floor, or an epoch regression — a
                    # fenced leader's stray append landing after its
                    # successor's records
                    self.fenced += 1
                    continue
                if self.last_epoch is None or epoch > self.last_epoch:
                    self.last_epoch = epoch
            if seq is not None:
                if seq <= self.last_seq:
                    self.skipped += 1
                    continue
                self.last_seq = seq
            out.append(ev)
        return out

    def replay(self) -> Iterator[Event]:
        yield from self._drain()

    def batches(self, batch_size: int = 64) -> Iterator[List[Event]]:
        buf: List[Event] = []
        for ev in self._drain():
            buf.append(ev)
            if len(buf) >= batch_size:
                yield buf
                buf = []
        if buf:
            yield buf

    def tail(
        self,
        poll_interval: float = 0.05,
        idle_timeout: Optional[float] = 1.0,
        batch_size: int = 256,
        sleep: Callable[[float], None] = time.sleep,
        max_poll_interval: Optional[float] = None,
        jitter: float = 0.1,
        seed: Optional[int] = None,
    ) -> Iterator[List[Event]]:
        """Yield batches of newly appended events until the stream goes
        quiet for ``idle_timeout`` seconds (None = tail forever).

        The poll interval backs off exponentially while the stream is idle
        — each empty drain doubles the sleep up to ``max_poll_interval``
        (default ``32 × poll_interval``, capped at 1s and never below
        ``poll_interval``) — and snaps back to ``poll_interval`` the
        moment a drain yields events, so a quiet cluster stops burning CPU
        without slowing catch-up on a busy one. Each sleep is stretched by
        ``U[0, jitter)`` (same law as ``RetryPolicy``): co-started
        followers tailing one leader would otherwise double in lockstep
        and poll it in synchronized bursts. The draw comes from a PRNG
        seeded by ``seed`` when given (tests), else decorrelated per
        process and path. ``idle_timeout`` (when set) also caps a single
        sleep, so the timeout is still honoured promptly."""
        if max_poll_interval is None:
            max_poll_interval = max(poll_interval, min(1.0, poll_interval * 32))
        max_poll_interval = max(max_poll_interval, poll_interval)
        rng = random.Random(
            seed if seed is not None
            else (os.getpid() << 16) ^ zlib.crc32(self.path.encode())
        )
        interval = poll_interval
        last_growth = time.monotonic()
        while True:
            got = self._drain() if os.path.exists(self.path) else []
            if got:
                interval = poll_interval
            while got:
                yield got[:batch_size]
                got = got[batch_size:]
                last_growth = time.monotonic()
            if (
                idle_timeout is not None
                and time.monotonic() - last_growth >= idle_timeout
            ):
                return
            delay = interval * (1.0 + rng.random() * jitter)
            if idle_timeout is not None:
                delay = min(delay, idle_timeout)
            sleep(delay)
            interval = min(interval * 2, max_poll_interval)


# ------------------------------------------------------------------- WAL
@dataclass
class WalInfo:
    """What :func:`scan_wal` found: the valid prefix and the torn tail."""

    path: str
    #: complete, decodable records in the valid prefix
    records: int = 0
    #: how many of those were WAL-framed (carried seq/crc)
    sequenced: int = 0
    #: highest sequence number in the valid prefix (-1 = none)
    last_seq: int = -1
    #: byte offset one past the last valid record — the replay ceiling
    valid_bytes: int = 0
    #: torn-tail bytes truncated (``repair=True``) or still on disk
    truncated_bytes: int = 0
    #: True when the scan found a torn tail (regardless of repair)
    torn: bool = False
    #: highest lease epoch stamped in the valid prefix (None = no record
    #: carried one — a pre-replication log)
    last_epoch: Optional[int] = None


def scan_wal(
    path: str, *, strict: bool = False, repair: bool = True
) -> WalInfo:
    """Validate an event log on open: per-record decode + crc check + seq
    monotonicity over the whole file.

    A *torn tail* — an invalid suffix with no valid record after it, the
    signature of a crash mid-append — is truncated in place when
    ``repair`` is set (counted on ``kvtpu_wal_truncations_total``) or left
    on disk when not; ``strict`` raises :class:`ServeError` instead. An
    invalid record *followed by* a valid one is not a tear but corruption
    (or interleaved writers) and always raises, as does a sequence or
    lease-epoch regression anywhere in the valid prefix.
    """
    from ..observe import log_event
    from ..observe.metrics import WAL_TRUNCATIONS_TOTAL

    info = WalInfo(path=path)
    if not os.path.exists(path):
        return info
    with open(path, "rb") as fh:
        data = fh.read()
    lines = data.splitlines(keepends=True)
    bad_at: Optional[int] = None  # byte offset of the first invalid record
    bad_why = ""
    offset = 0
    lineno = 0
    for raw in lines:
        lineno += 1
        if not raw.endswith(b"\n"):
            bad_at, bad_why = offset, "record has no trailing newline"
            break
        line = raw.decode("utf-8", errors="replace").strip()
        if not line:
            offset += len(raw)
            info.valid_bytes = offset
            continue
        try:
            _, seq, epoch = decode_wal(line, where=f"{path}:{lineno}")
        except IngestError as e:
            bad_at, bad_why = offset, str(e)
            break
        if seq is not None:
            if seq <= info.last_seq:
                raise ServeError(
                    f"{path}:{lineno}: WAL sequence regressed "
                    f"({seq} after {info.last_seq}) — the log was "
                    "corrupted or written by interleaved writers"
                )
            info.last_seq = seq
            info.sequenced += 1
        if epoch is not None:
            if info.last_epoch is not None and epoch < info.last_epoch:
                raise ServeError(
                    f"{path}:{lineno}: WAL epoch regressed ({epoch} after "
                    f"{info.last_epoch}) — a fenced leader kept writing "
                    "past its lease; the log needs manual triage"
                )
            info.last_epoch = epoch
        info.records += 1
        offset += len(raw)
        info.valid_bytes = offset
    if bad_at is None:
        return info
    # anything decodable after the bad record means mid-stream corruption
    rest = data[bad_at:]
    for raw in rest.splitlines(keepends=True)[1:]:
        if not raw.endswith(b"\n"):
            continue
        line = raw.decode("utf-8", errors="replace").strip()
        if not line:
            continue
        try:
            decode_record(line)
        except IngestError:
            continue
        raise ServeError(
            f"{path}: invalid record at byte {bad_at} is followed by "
            f"valid records — mid-stream corruption, not a torn tail "
            f"({bad_why})"
        )
    info.torn = True
    info.truncated_bytes = len(data) - info.valid_bytes
    if strict:
        raise ServeError(
            f"{path}: torn WAL tail — {info.truncated_bytes} bytes after "
            f"offset {info.valid_bytes} do not form a valid record "
            f"({bad_why}); re-open without strict to truncate and resume"
        )
    if repair:
        with open(path, "rb+") as fh:  # kvtpu: ignore[atomic-write] the torn-tail repair itself: truncating to the last valid record is idempotent
            fh.truncate(info.valid_bytes)
        WAL_TRUNCATIONS_TOTAL.inc()
        log_event(
            "wal_truncate", path=path, valid_bytes=info.valid_bytes,
            dropped_bytes=info.truncated_bytes, reason=bad_why,
        )
    return info


class WalWriter:
    """Append-only sequenced event-log writer.

    Opening scans the existing log (torn tails repaired unless ``strict``)
    and resumes the sequence after its highest number, so every record
    ever written to one path has a unique, monotonically increasing
    ``seq``. ``fsync`` (default) makes each :meth:`append` durable before
    returning — the write-ahead half of the checkpoint protocol.

    Replication fencing: a leader passes its lease ``epoch`` (stamped into
    every record, under the crc) and the :class:`~.replication.LeaseFile`
    itself via ``lease``; each :meth:`append` first re-reads the lease and
    raises :class:`~..resilience.errors.FencedError` when a newer epoch
    holds it — a deposed leader stops writing instead of corrupting the
    log a promoted follower now owns. Opening also refuses a log whose
    records already carry a *newer* epoch than ours.
    """

    def __init__(
        self,
        path: str,
        *,
        fsync: bool = True,
        strict: bool = False,
        epoch: Optional[int] = None,
        lease=None,
    ) -> None:
        from ..resilience.errors import FencedError

        self.path = path
        self.fsync = fsync
        self.epoch = epoch
        self.lease = lease
        info = scan_wal(path, strict=strict)
        if (
            epoch is not None
            and info.last_epoch is not None
            and info.last_epoch > epoch
        ):
            raise FencedError(
                f"{path}: log already carries epoch {info.last_epoch}, "
                f"newer than this writer's {epoch} — a follower promoted "
                "past us",
                epoch=epoch, lease_epoch=info.last_epoch,
            )
        self.next_seq = info.last_seq + 1
        self._fh = open(path, "a")  # kvtpu: ignore[atomic-write] WAL append handle: torn tails are repaired by scan_wal on the next open

    def _check_fence(self) -> None:
        """Raise :class:`FencedError` when the lease moved past our epoch."""
        from ..resilience.errors import FencedError

        if self.lease is None or self.epoch is None:
            return
        cur = self.lease.read()
        if cur is not None and cur.epoch > self.epoch:
            raise FencedError(
                f"{self.path}: lease epoch {cur.epoch} (held by "
                f"{cur.holder!r}) supersedes this writer's {self.epoch} — "
                "append refused",
                epoch=self.epoch, lease_epoch=cur.epoch,
            )

    def append(self, events: Sequence[Event]) -> int:
        """Append ``events`` as WAL-framed records; returns the last
        sequence number written (``next_seq - 1`` when empty)."""
        from ..resilience.faults import kill_point

        self._check_fence()
        for ev in events:
            line = encode_event(ev, seq=self.next_seq, epoch=self.epoch) + "\n"
            half = max(1, len(line) // 2)
            self._fh.write(line[:half])
            # crash-fault hook: fires (if armed) with only the first half
            # of this record flushed — the canonical torn-tail producer
            kill_point("mid-log-append", flush=self._fh)
            self._fh.write(line[half:])
            self.next_seq += 1
        self._fh.flush()
        if self.fsync:
            os.fsync(self._fh.fileno())
        return self.next_seq - 1

    @property
    def offset(self) -> int:
        """Current end-of-log byte offset (valid after :meth:`append`)."""
        return self._fh.tell()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None  # type: ignore[assignment]

    def __enter__(self) -> "WalWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def coalesce(
    events: Sequence[Event],
) -> Tuple[List[Event], List[Event]]:
    """Collapse a batch to its net effect: ``(kept, dropped)``.

    Rules (per coalescing ``key``, order of survivors is the order of each
    key's *last* contributing event, so valid streams stay valid):

    * repeated relabels of one pod/namespace keep only the last;
    * ``AddPolicy`` then ``RemovePolicy`` in one batch cancel entirely;
    * ``AddPolicy`` then ``UpdatePolicy`` fold into one ``AddPolicy`` with
      the final spec; ``UpdatePolicy`` chains keep the last;
    * ``RemovePolicy`` then ``AddPolicy`` fold into one ``UpdatePolicy``
      (the engine's update *is* remove+add — one op instead of two);
    * ``FullResync`` discards every pending event before it.
    """
    kept: List[Optional[Event]] = []
    dropped: List[Event] = []
    slot: Dict[str, int] = {}  # key → index in kept

    def _replace(key: str, ev: Optional[Event], old: Event) -> None:
        kept[slot[key]] = None
        dropped.append(old)
        if ev is None:
            del slot[key]
        else:
            slot[key] = len(kept)
            kept.append(ev)

    for ev in events:
        if isinstance(ev, FullResync):
            dropped += [e for e in kept if e is not None]
            kept = [ev]
            slot = {}
            continue
        if isinstance(ev, RemoveNamespace):
            # barrier: a later relabel of this namespace may re-CREATE it,
            # so it must not fold into (and reorder past) this removal
            slot.pop(f"namespace/{ev.namespace}", None)
            kept.append(ev)
            continue
        key = ev.key
        if key is None or key not in slot:
            if key is not None:
                slot[key] = len(kept)
            kept.append(ev)
            continue
        prev = kept[slot[key]]
        if isinstance(ev, (UpdatePodLabels, UpdateNamespaceLabels)):
            _replace(key, ev, prev)
        elif isinstance(ev, RemovePolicy):
            if isinstance(prev, AddPolicy):
                # net no-op: the policy both appears and disappears inside
                # this batch
                kept[slot[key]] = None
                del slot[key]
                dropped += [prev, ev]
            else:  # Update/Remove before: net effect is the removal
                _replace(key, ev, prev)
        elif isinstance(ev, (AddPolicy, UpdatePolicy)):
            if isinstance(prev, AddPolicy):
                _replace(key, AddPolicy(policy=ev.policy), prev)
            elif isinstance(prev, RemovePolicy):
                # remove+add of one key = one in-place update
                _replace(key, UpdatePolicy(policy=ev.policy), prev)
            else:
                _replace(key, UpdatePolicy(policy=ev.policy), prev)
        else:  # a future keyed kind with no fold rule: keep both
            slot[key] = len(kept)
            kept.append(ev)
    return [e for e in kept if e is not None], dropped
