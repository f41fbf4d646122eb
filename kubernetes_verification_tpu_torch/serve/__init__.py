"""Continuous verification on the port's engines: event streams in,
always-current answers out.

The PyTorch port of the core of ``kubernetes_verification_tpu.serve``:

* ``events``  — the typed mutation-event model, its JSONL codec (byte for
  byte the JAX package's, so either package reads the other's logs), the
  tail-able :class:`EventSource`, the sequenced WAL (:class:`WalWriter` /
  :func:`scan_wal`) and the write-coalescing reduction;
* ``service`` — :class:`VerificationService`: one serving engine (the
  dense ``IncrementalVerifier`` or the packed ``PackedIncrementalVerifier``)
  behind one worker thread, lazy solve scheduling, staleness bounds,
  warm-restart snapshots and a circuit breaker on the engine's solve
  (a card engine's failure reaches the caller; only a CPU engine falls
  back to the CPU oracle);
* ``queries`` — :class:`QueryEngine` (``can_reach`` / ``can_reach_batch``
  / ``who_can_reach`` / ``blast_radius`` / ``path_exists`` / ``hops``),
  declarative allow/deny assertions with violating-pair witnesses, and
  admission-style ``what_if`` dry runs on a copy-on-write overlay, with a
  generation-keyed :class:`QueryCache`;
* ``posture`` — :class:`PostureTracker`: an exact reach-delta record per
  generation, a crc'd journal and declarative drift alerts;
* ``durability`` — crash-safe checkpoints: :class:`CheckpointManager`
  (atomic snapshot + manifest generations, closure pass checkpoints) and
  :class:`RecoveryManager` (ladder recovery + WAL replay with
  duplicate-application skipping).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Replication, the network transport, the load balancer, ingress, admission,
autoscaling and the stripe fleet are not ported yet.
"""
from .durability import (
    CheckpointInfo,
    CheckpointManager,
    RecoveryManager,
    RecoveryResult,
    load_closure_checkpoint,
    load_manifest,
)
from .events import (
    AddPolicy,
    Event,
    EventSource,
    FullResync,
    RemoveNamespace,
    RemovePolicy,
    UpdateNamespaceLabels,
    UpdatePodLabels,
    UpdatePolicy,
    WalInfo,
    WalWriter,
    coalesce,
    decode_event,
    decode_record,
    encode_event,
    read_events,
    scan_wal,
    write_events,
)
from .posture import (
    PostureAlertError,
    PostureRecord,
    PostureRule,
    PostureTracker,
    parse_posture_rule,
    posture_diff,
    scan_posture,
)
from .queries import (
    Assertion,
    PodSelector,
    QueryCache,
    QueryEngine,
    Violation,
    WhatIfResult,
    check_assertions,
    load_assertions,
)
from .service import ServeConfig, ServeStats, VerificationService

__all__ = [
    "Event",
    "AddPolicy",
    "RemovePolicy",
    "UpdatePolicy",
    "UpdatePodLabels",
    "UpdateNamespaceLabels",
    "RemoveNamespace",
    "FullResync",
    "EventSource",
    "encode_event",
    "decode_event",
    "decode_record",
    "read_events",
    "write_events",
    "coalesce",
    "WalInfo",
    "WalWriter",
    "scan_wal",
    "CheckpointInfo",
    "CheckpointManager",
    "RecoveryManager",
    "RecoveryResult",
    "load_closure_checkpoint",
    "load_manifest",
    "ServeConfig",
    "ServeStats",
    "VerificationService",
    "QueryCache",
    "QueryEngine",
    "PodSelector",
    "Assertion",
    "Violation",
    "WhatIfResult",
    "load_assertions",
    "check_assertions",
    "PostureAlertError",
    "PostureRecord",
    "PostureRule",
    "PostureTracker",
    "parse_posture_rule",
    "posture_diff",
    "scan_posture",
]
