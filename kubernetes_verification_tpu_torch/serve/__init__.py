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
  (atomic snapshot + manifest generations, closure pass checkpoints,
  stripe-sliced generations) and :class:`RecoveryManager` (ladder recovery
  + WAL replay with duplicate-application skipping, ``recover_stripe``);
* ``replication`` — :class:`FollowerService` (checkpoint bootstrap onto
  its own engine, exactly-once WAL tailing, staleness-bounded reads) and
  :class:`LeaseFile` (the epoch-fenced heartbeat of breaker-gated
  promotion);
* ``transport`` — the same replication over stdlib HTTP
  (:class:`ReplicationServer`, :class:`ReplicationClient`,
  :class:`RemoteEventSource`, :func:`bootstrap_from_leader`), byte for
  byte the JAX package's wire format;
* ``lb`` — :class:`QueryLoadBalancer`: staleness-weighted routing across
  replicas with per-replica breakers;
* ``ingress`` / ``admission`` / ``autoscale`` — the front door
  (:class:`Ingress`), per-tenant quotas and the brown-out ladder
  (:class:`AdmissionController`), and :class:`FleetAutoscaler`;
* ``stripes`` — the stripe fleet: :class:`StripeEngine` (the dense
  engine cut to rows ``[lo, hi)``), :class:`StripeFollower`,
  :class:`StripeCoordinator` and :class:`RemoteStripeOwner`.

Entry points that hold device state run on ``cuda`` unless the caller
passes ``device="cpu"``; no answer of an engine on the card comes from
the host.
"""
from .durability import (
    CheckpointInfo,
    CheckpointManager,
    RecoveryManager,
    RecoveryResult,
    load_closure_checkpoint,
    load_manifest,
)
from .admission import (
    AdmissionConfig,
    AdmissionController,
    BrownoutController,
    TenantQuota,
    TokenBucket,
)
from .autoscale import AutoscaleConfig, FleetAutoscaler
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
from .ingress import Ingress, IngressConfig
from .lb import QueryLoadBalancer
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
from .replication import (
    FollowerService,
    Lease,
    LeaseFile,
    ReplicaLag,
    lease_path,
)
from .service import ServeConfig, ServeStats, VerificationService
from .stripes import (
    RemoteStripeOwner,
    StripeCoordinator,
    StripeEngine,
    StripeFollower,
)
from .transport import (
    RemoteEventSource,
    ReplicationClient,
    ReplicationServer,
    bootstrap_from_leader,
)

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
    "FollowerService",
    "Lease",
    "LeaseFile",
    "ReplicaLag",
    "lease_path",
    "ReplicationServer",
    "ReplicationClient",
    "RemoteEventSource",
    "bootstrap_from_leader",
    "QueryLoadBalancer",
    "Ingress",
    "IngressConfig",
    "AdmissionConfig",
    "AdmissionController",
    "BrownoutController",
    "TenantQuota",
    "TokenBucket",
    "AutoscaleConfig",
    "FleetAutoscaler",
    "StripeEngine",
    "StripeFollower",
    "StripeCoordinator",
    "RemoteStripeOwner",
]
