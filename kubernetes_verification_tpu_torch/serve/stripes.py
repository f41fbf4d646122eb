"""Stripe-sharded serving fleet: no single process holds the whole cluster.

The PyTorch port of ``kubernetes_verification_tpu.serve.stripes``. A stripe
engine's counts are int32 ``[S, N]`` tensors on its device (``None`` means
``"cuda"``; the CPU only when the caller passes ``device="cpu"``): the
build contracts each direction in row slabs of at most 2²⁴ cells, and the
JAX package's donated jitted row and column patches become in-place
updates of the resident counts. Queries run through the stripe twins of
``ops/batched.py``. A stripe with no live owner raises; no answer is
truncated and none comes from the host.

Every serving engine before this one materialises the full count/word
state — at 10M pods even the packed bitmaps outgrow one host. This module
splits the *serving* plane the way ``parallel/sharded_closure.py`` splits
the closure: each :class:`StripeFollower` owns a contiguous pod-range
stripe ``[lo, hi)`` of the reachability count matrices (geometry from
``parallel/stripes.py``, the one shared routing table), tails the shared
WAL, and answers only the rows it owns. A :class:`StripeCoordinator`
fronts the fleet: scalar/row queries route to the source pod's stripe
owner, cross-stripe queries (columns, blast radius, bounded paths)
scatter-gather across every stripe and merge **bit-identically** to a
whole-state follower.

Three correctness anchors:

* **State bound** — a stripe engine's device state is ``[S, N]`` with
  ``S = hi - lo ≈ N / K``; the only full-``N`` residents are the O(N)
  isolation vectors and per-policy contribution vectors (the ε in the
  ``1/K + ε`` bound; never an ``[N, N]`` operand).
* **Fan-out, not filtering** — the count matrices are sums over policy
  outer products, so a label or policy event anywhere can move counts in
  every stripe. Mutations therefore apply *everywhere* (correctness
  first); applies whose originating pod lives outside the owner's range
  count in ``kvtpu_stripe_fanout_total`` so the fan-out tax is measured,
  not guessed.
* **No silent truncation** — a stripe with no live owner fails the query
  with a typed :class:`~..resilience.errors.StripeCoverageError`
  (``kvtpu_stripe_coverage_gaps_total``); a partial answer is an outage,
  never a smaller result set.
"""
from __future__ import annotations

import base64
import os
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..incremental import IncrementalVerifier, _I32, _rank1_add
from ..models.core import Cluster, Namespace, Pod
from ..observe.metrics import (
    SERVE_EVENTS_TOTAL,
    STRIPE_COVERAGE_GAPS_TOTAL,
    STRIPE_FANOUT_TOTAL,
    STRIPE_OWNED_ROWS,
    STRIPE_QUERIES_TOTAL,
)
from ..observe.spans import trace
from ..ops.batched import stripe_any_port, stripe_reach_cols, stripe_reach_rows
from ..ops.closure import bool_dot
from ..parallel.stripes import stripe_bounds, stripe_of, stripe_table
from ..resilience.errors import (
    ConfigError,
    KvTpuError,
    ReplicationError,
    ServeError,
    StripeCoverageError,
    StripeRouteError,
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
    coalesce,
)

__all__ = [
    "StripeEngine",
    "StripeFollower",
    "StripeCoordinator",
    "RemoteStripeOwner",
]

#: transport-layer failures that move a fragment to the stripe's next
#: owner (same set the load balancer ejects on)
_EJECTABLE = (ReplicationError, ConnectionError, OSError)


def _stripe_col_patch(count: torch.Tensor, idx: int, d_col_stripe: np.ndarray) -> None:
    """count[:, idx] += d_col_stripe, in place — the column slice of a
    relabel delta that lands on EVERY stripe (bounded to the owned range by
    the caller slicing ``d_col[lo:hi]`` before the call)."""
    # kvtpu: ignore[stripe-locality] column index is the global dst axis (full width on every stripe); the row operand arrives pre-sliced to [lo, hi) by _patch_row_col
    count[:, idx] += torch.as_tensor(
        np.asarray(d_col_stripe, dtype=np.int32), device=count.device
    )


def _stripe_row_patch(count: torch.Tensor, loc: int, d_row: np.ndarray) -> None:
    """count[loc, :] += d_row, in place — the row half of a relabel delta,
    applied only on the one stripe whose ``[lo, hi)`` holds the global row
    (``loc`` is already the local row)."""
    # kvtpu: ignore[stripe-locality] `loc` is already the local row (idx - lo): _patch_row_col owns()-gates and rebases before dispatch
    count[loc] += torch.as_tensor(np.asarray(d_row, dtype=np.int32), device=count.device)

#: cells of one int32 slab of the build's contraction (a [rows, N] product)
_SLAB_CELLS = 1 << 24
#: on a CUDA device a slab's rows are padded with zero rows to a multiple
#: of this: cuBLASLt's int8 GEMM refuses some narrow products
_SLAB_ROW_PAD = 256


class StripeEngine(IncrementalVerifier):
    """An :class:`IncrementalVerifier` that owns rows ``[lo, hi)`` only.

    The allocation, contraction and patch hooks of the base class are
    overridden so the count tensors are ``[S, N]`` row stripes — every
    mutation path (the build's contraction, policy rank-1 updates, pod
    relabel row/column patches) stays inside the owned range, and no
    ``[N, N]`` tensor exists in this process. The O(N) isolation counts
    stay whole (they are the ε of the state bound and every stripe needs
    the full destination axis).
    """

    metrics_engine = "stripe"

    def __init__(
        self,
        cluster: Cluster,
        config=None,
        device=None,
        *,
        stripe: Tuple[int, int],
    ) -> None:
        k, count = int(stripe[0]), int(stripe[1])
        n = len(cluster.pods)
        # bounds precede super().__init__: it calls _alloc_counts and the
        # build contraction, both of which slice by [lo, hi)
        self._lo, self._hi = stripe_bounds(n, k, count)
        self.stripe_index = k
        self.stripe_count = count
        super().__init__(cluster, config, device)
        STRIPE_OWNED_ROWS.set(self._hi - self._lo)

    # ------------------------------------------------------------ geometry
    @property
    def stripe(self) -> Tuple[int, int]:
        return (self.stripe_index, self.stripe_count)

    @property
    def stripe_rows(self) -> Tuple[int, int]:
        return (self._lo, self._hi)

    def owns(self, pod: int) -> bool:
        return self._lo <= pod < self._hi

    def local(self, pod: int) -> int:
        """Global row → stripe-local offset; typed refusal off-stripe."""
        lo, hi = self._lo, self._hi
        if not lo <= pod < hi:
            raise StripeRouteError(
                f"pod row {pod} outside stripe "
                f"{self.stripe_index + 1}/{self.stripe_count} "
                f"range [{lo}, {hi})",
                pod=pod,
                stripe=self.stripe,
            )
        return pod - lo

    def state_bytes(self) -> int:
        """Device bytes of the striped count state (the quantity the
        ``1/K + ε`` per-process bound is measured over)."""
        return sum(
            t.numel() * t.element_size() for t in (self._ing_count, self._eg_count)
        )

    # ------------------------------------------------- overridden mutation
    def _alloc_counts(self, n: int):
        s = self._hi - self._lo
        return (
            torch.zeros((s, n), dtype=_I32, device=self.device),
            torch.zeros((s, n), dtype=_I32, device=self.device),
        )

    def _stripe_dot(self, src, dst) -> torch.Tensor:
        """int32 ``[S, N]`` = ``src[:, lo:hi]ᵀ · dst`` for int8 ``[P, N]``
        maps: the SOURCE axis is sliced before contracting, and the product
        runs in row slabs of at most ``_SLAB_CELLS`` cells written into the
        result, so no ``[N, N]`` (and no whole-stripe temporary) is formed.
        Both operands are K-contiguous (the fast int8 layout on Hopper)."""
        lo, hi = self._lo, self._hi
        n = int(dst.shape[1])
        out = torch.empty((hi - lo, n), dtype=_I32, device=dst.device)
        if hi == lo:
            return out
        a = src[:, lo:hi].t().contiguous()  # [S, P]
        bt = dst.t().contiguous()  # [N, P]
        step = max(_SLAB_ROW_PAD, (_SLAB_CELLS // max(n, 1)) // _SLAB_ROW_PAD * _SLAB_ROW_PAD)
        for r0 in range(0, hi - lo, step):
            slab = a[r0 : r0 + step]
            m = slab.shape[0]
            if dst.is_cuda and m % _SLAB_ROW_PAD:
                slab = torch.nn.functional.pad(slab, (0, 0, 0, (-m) % _SLAB_ROW_PAD))
            out[r0 : r0 + m] = bool_dot(slab, bt)[:m]
        return out

    def _contract_counts(self, sel_ing, sel_eg, ing_peers, eg_peers):
        # ing_count[src, dst] = Σ ing_peers[src]·sel_ing[dst]; egress is
        # the mirror: only the owned source rows are contracted
        return (
            self._stripe_dot(ing_peers, sel_ing),
            self._stripe_dot(sel_eg, eg_peers),
        )

    def _apply(self, vecs, sign: int) -> None:
        lo, hi = self._lo, self._hi
        sel_ing, sel_eg, ing_peers, eg_peers = vecs
        # the source operand of each rank-1 product is sliced to the owned
        # rows; _rank1_add touches only the block where both are set
        _rank1_add(self._ing_count, np.asarray(ing_peers)[lo:hi], sel_ing, sign)
        _rank1_add(self._eg_count, np.asarray(sel_eg)[lo:hi], eg_peers, sign)
        # isolation counts stay full-length: every stripe needs the whole
        # destination axis, and they are O(N) host state
        self._ing_iso += sign * np.asarray(vecs[0], dtype=np.int64)
        self._eg_iso += sign * np.asarray(vecs[1], dtype=np.int64)
        self._reach_dirty = True
        self.update_count += 1

    def _patch_row_col(self, idx, d_ing_row, d_ing_col, d_eg_row, d_eg_col):
        lo, hi = self._lo, self._hi
        for count, d_row, d_col in (
            (self._ing_count, d_ing_row, d_ing_col),
            (self._eg_count, d_eg_row, d_eg_col),
        ):
            # the column slice lands on every stripe (bounded to [lo, hi))
            _stripe_col_patch(count, idx, d_col[lo:hi])
            # the row half lands only on the owning stripe, at its local
            # offset (the (idx, idx) corner rides d_row: d_col[idx] == 0)
            if lo <= idx < hi:
                _stripe_row_patch(count, idx - lo, d_row)

    # --------------------------------------------------------------- query
    @property
    def reach(self) -> np.ndarray:
        raise StripeRouteError(
            f"stripe engine {self.stripe_index + 1}/{self.stripe_count} "
            f"holds rows [{self._lo}, {self._hi}) only — use reach_rows/"
            "reach_cols_fragment/probe, or merge through StripeCoordinator",
            stripe=self.stripe,
        )

    def _kernel_args(self):
        lo, hi = self._lo, self._hi
        return (
            self._ing_count,
            self._eg_count,
            self._ing_iso,
            self._eg_iso[lo:hi],
        )

    def _flags(self) -> dict:
        return {
            "self_traffic": self.config.self_traffic,
            "default_allow_unselected": self.config.default_allow_unselected,
        }

    def reach_rows(self, srcs: Sequence[int]) -> np.ndarray:
        """Reach rows for GLOBAL source indices ``srcs`` (all owned) —
        bool ``[U, N]``, equal to the same rows of a whole-state
        follower's matrix."""
        loc = np.asarray([self.local(int(s)) for s in srcs], dtype=np.int64)
        return stripe_reach_rows(
            *self._kernel_args(), loc, row_base=self._lo, **self._flags()
        )

    def reach_cols_fragment(self, dsts: Sequence[int]) -> np.ndarray:
        """This stripe's fragment of the reach COLUMNS for global
        destinations ``dsts`` — bool ``[S, U]``; concatenating fragments
        in stripe order rebuilds the whole columns."""
        dst = np.asarray([int(d) for d in dsts], dtype=np.int64)
        return stripe_reach_cols(
            *self._kernel_args(), dst, row_base=self._lo, **self._flags()
        )

    def probe(self, srcs: Sequence[int], dsts: Sequence[int]) -> np.ndarray:
        """Any-port probe answers (bool [Q]) for global (src, dst) pairs
        whose sources all live on this stripe — one fused dispatch."""
        src = np.asarray([int(s) for s in srcs], dtype=np.int64)
        dst = np.asarray([int(d) for d in dsts], dtype=np.int64)
        if src.shape != dst.shape:
            raise ServeError(
                f"probe needs matched srcs/dsts, got {src.size} vs {dst.size}"
            )
        if src.size == 0:
            return np.zeros(0, dtype=bool)
        uniq, inv = np.unique(src, return_inverse=True)
        loc = np.asarray([self.local(int(s)) for s in uniq], dtype=np.int64)
        _rows, answers = stripe_any_port(
            *self._kernel_args(),
            loc,
            inv,
            dst,
            row_base=self._lo,
            **self._flags(),
        )
        return answers


class StripeFollower:
    """One stripe owner: a :class:`StripeEngine` + a WAL tail.

    Mirrors :class:`~.service.VerificationService`'s event dispatch
    exactly (idempotent adds, namespace registration, full resync), so a
    stripe fleet replaying the same WAL converges to the same logical
    state as a whole-state service — each member just holds its
    ``[lo, hi)`` rows of it. ``kvtpu_stripe_fanout_total`` counts the
    applies this owner only performed because count-matrix state fans
    out (the event's home pod lives on another stripe, or the event has
    no single home at all)."""

    def __init__(
        self,
        cluster: Optional[Cluster] = None,
        config=None,
        *,
        stripe: Optional[Tuple[int, int]] = None,
        engine: Optional[StripeEngine] = None,
        replica: str = "stripe",
        log_path: Optional[str] = None,
        device=None,
        offset: int = 0,
        start_after_seq: Optional[int] = None,
    ) -> None:
        if engine is None:
            if cluster is None or stripe is None:
                raise ConfigError(
                    "StripeFollower needs either engine= or cluster= + "
                    "stripe=(index, count)"
                )
            engine = StripeEngine(cluster, config, device, stripe=stripe)
        self.engine = engine
        self.replica = replica
        self.log_path = log_path
        self._lock = threading.RLock()
        self._pod_idx: Dict[Tuple[str, str], int] = {
            (p.namespace, p.name): i for i, p in enumerate(engine.pods)
        }
        self.generation = 0
        self.applied_total = 0
        self.fanout_total = 0
        self.source: Optional[EventSource] = (
            EventSource(log_path, offset, start_after_seq=start_after_seq)
            if log_path
            else None
        )

    # ------------------------------------------------------------- routing
    @property
    def stripe(self) -> Tuple[int, int]:
        return self.engine.stripe

    def pod_index(self, namespace: str, name: str) -> int:
        try:
            return self._pod_idx[(namespace, name)]
        except KeyError:
            raise ServeError(
                f"unknown pod {namespace}/{name} (stripe follower holds "
                f"{len(self._pod_idx)} pods)"
            ) from None

    def _home_stripe(self, ev: Event) -> Optional[int]:
        """The stripe the event's pod lives on, or None for events with no
        single home (policy/namespace/resync events touch selector
        membership everywhere by construction)."""
        if isinstance(ev, UpdatePodLabels):
            idx = self._pod_idx.get((ev.namespace, ev.pod))
            if idx is not None:
                return stripe_of(
                    len(self.engine.pods), self.engine.stripe_count, idx
                )
        return None

    # -------------------------------------------------------------- apply
    def apply(self, events: Sequence[Event]) -> int:
        """Apply a WAL batch to the owned stripe; returns mutations
        applied. Every event applies (fan-out, correctness first); the
        off-home ones are counted."""
        events = list(events)
        if not events:
            return 0
        with self._lock:
            kept, _dropped = coalesce(events)
            with trace(
                "stripe_apply",
                stripe=f"{self.engine.stripe_index + 1}"
                f"/{self.engine.stripe_count}",
                events=len(events),
                applied=len(kept),
            ):
                for i, ev in enumerate(kept):
                    home = self._home_stripe(ev)
                    try:
                        self._apply_one(ev)
                    except (KeyError, ValueError) as e:
                        if isinstance(e, KvTpuError):
                            raise
                        raise ServeError(
                            f"event {i} ({ev.kind}) rejected by the "
                            f"stripe engine: {e}",
                            event_index=i,
                        ) from e
                    SERVE_EVENTS_TOTAL.labels(kind=ev.kind).inc()
                    if self.engine.stripe_count > 1 and (
                        home is None or home != self.engine.stripe_index
                    ):
                        self.fanout_total += 1
                        STRIPE_FANOUT_TOTAL.labels(kind=ev.kind).inc()
                self.applied_total += len(kept)
                if kept:
                    self.generation += 1
        return len(kept)

    def _apply_one(self, ev: Event) -> None:
        eng = self.engine
        if isinstance(ev, AddPolicy):
            key = f"{ev.policy.namespace}/{ev.policy.name}"
            if key in eng.policies:
                eng.update_policy(ev.policy)
            else:
                eng.add_policy(ev.policy)
        elif isinstance(ev, UpdatePolicy):
            key = f"{ev.policy.namespace}/{ev.policy.name}"
            if key in eng.policies:
                eng.update_policy(ev.policy)
            else:
                eng.add_policy(ev.policy)
        elif isinstance(ev, RemovePolicy):
            eng.remove_policy(ev.namespace, ev.name)
        elif isinstance(ev, UpdatePodLabels):
            eng.update_pod_labels(
                self.pod_index(ev.namespace, ev.pod), dict(ev.labels)
            )
        elif isinstance(ev, UpdateNamespaceLabels):
            eng.add_namespace(Namespace(ev.namespace, dict(ev.labels)))
        elif isinstance(ev, RemoveNamespace):
            eng.remove_namespace(ev.namespace)
        elif isinstance(ev, FullResync):
            # same stripe of the NEW cluster: geometry re-derives from the
            # new pod count, ownership fraction is preserved
            self.engine = StripeEngine(
                ev.cluster,
                eng.config,
                eng.device,
                stripe=(eng.stripe_index, eng.stripe_count),
            )
            self._pod_idx = {
                (p.namespace, p.name): i
                for i, p in enumerate(self.engine.pods)
            }
        else:
            raise ServeError(f"unhandled event kind {ev.kind!r}")

    def poll(self, batch_size: int = 256) -> int:
        """Drain newly appended WAL records and apply them; returns the
        number of mutations applied."""
        if self.source is None:
            return 0
        applied = 0
        for batch in self.source.batches(batch_size):
            applied += self.apply(batch)
        return applied

    # -------------------------------------------------------------- health
    def health(self) -> dict:
        eng = self.engine
        lo, hi = eng.stripe_rows
        with self._lock:
            return {
                "replica": self.replica,
                "role": "stripe",
                "generation": self.generation,
                "applied": self.applied_total,
                "fanout": self.fanout_total,
                "last_seq": self.source.last_seq if self.source else -1,
                "offset": self.source.offset if self.source else 0,
                "stripe": {
                    "index": eng.stripe_index,
                    "count": eng.stripe_count,
                    "lo": lo,
                    "hi": hi,
                    "pods": hi - lo,
                    "n": len(eng.pods),
                    "state_bytes": eng.state_bytes(),
                },
            }

    # ------------------------------------------------------- query surface
    def rows(self, srcs: Sequence[int]) -> np.ndarray:
        with self._lock:
            return self.engine.reach_rows(srcs)

    def cols_fragment(self, dsts: Sequence[int]) -> np.ndarray:
        with self._lock:
            return self.engine.reach_cols_fragment(dsts)

    def probes(self, srcs: Sequence[int], dsts: Sequence[int]) -> np.ndarray:
        with self._lock:
            return self.engine.probe(srcs, dsts)

    # ---------------------------------------------------------- durability
    def checkpoint(self, cm) -> str:
        """Write one stripe-sliced checkpoint generation through
        ``CheckpointManager.checkpoint_stripe`` (WAL position included so
        recovery resumes the tail without duplicate application)."""
        with self._lock:
            return cm.checkpoint_stripe(
                self.engine,
                log_path=self.log_path,
                log_offset=self.source.offset if self.source else 0,
                last_seq=self.source.last_seq if self.source else -1,
            )

    def handle_stripe_op(self, doc: dict) -> dict:
        """The ``POST /v1/stripe`` wire surface: one JSON op in, one JSON
        doc out (row/column payloads packed to base64 bitmaps)."""
        op = doc.get("op")
        if op == "describe":
            return self.health()
        if op == "probes":
            ans = self.probes(doc.get("srcs", []), doc.get("dsts", []))
            return {"answers": [bool(a) for a in ans]}
        if op == "rows":
            rows = self.rows(doc.get("srcs", []))
            return {"rows": _pack_bool(rows)}
        if op == "cols":
            cols = self.cols_fragment(doc.get("dsts", []))
            return {"cols": _pack_bool(cols)}
        raise ServeError(f"unknown stripe op {op!r}")

    def serve_http(
        self,
        directory: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        """Expose this stripe owner on the wire: a
        :class:`~.transport.ReplicationServer` over ``directory`` (the
        owner's checkpoint directory) whose ``/healthz`` carries the
        stripe fragment (index/count/owned rows — what ``kv-tpu fleet``
        renders and DOWN-stripe detection keys on) and whose
        ``POST /v1/stripe`` answers describe/probes/rows/cols against the
        owned row range. Returns the started server; the caller owns its
        lifecycle."""
        from .transport import ReplicationServer

        server = ReplicationServer(
            directory,
            self.log_path or os.path.join(directory, "events.jsonl"),
            host=host,
            port=port,
            health_source=self.health,
            stripe_source=self.handle_stripe_op,
        )
        server.start()
        return server


def _pack_bool(arr: np.ndarray) -> dict:
    """Bool array → base64-packed bitmap envelope (8× smaller than JSON
    bools on the wire; shape restores exactly)."""
    arr = np.ascontiguousarray(arr, dtype=bool)
    return {
        "shape": list(arr.shape),
        "b64": base64.b64encode(np.packbits(arr)).decode("ascii"),
    }


def _unpack_bool(doc: dict) -> np.ndarray:
    shape = tuple(int(s) for s in doc["shape"])
    size = int(np.prod(shape)) if shape else 0
    raw = np.frombuffer(base64.b64decode(doc["b64"]), dtype=np.uint8)
    bits = np.unpackbits(raw)[:size]
    return bits.astype(bool).reshape(shape)


class RemoteStripeOwner:
    """A networked stripe owner: the coordinator-side handle on one
    ``kv-tpu serve --stripe K/N`` process, speaking ``POST /v1/stripe``
    through a :class:`~.transport.ReplicationClient` (so every fragment
    request rides the fault-injection seam, retry policy, and trace
    header propagation of the replication plane)."""

    def __init__(self, client, *, info: Optional[dict] = None) -> None:
        self.client = client
        self._info = info or client.stripe_op({"op": "describe"})
        st = self._info.get("stripe") or {}
        if "index" not in st or "count" not in st:
            raise ReplicationError(
                f"{client.base_url} is not a stripe owner (no stripe "
                "fragment in its describe document)",
                op="stripe",
                url=client.base_url,
            )

    @property
    def stripe(self) -> Tuple[int, int]:
        st = self._info["stripe"]
        return (int(st["index"]), int(st["count"]))

    @property
    def replica(self) -> str:
        return str(self._info.get("replica", self.client.base_url))

    def probes(self, srcs, dsts) -> np.ndarray:
        doc = self.client.stripe_op(
            {
                "op": "probes",
                "srcs": [int(s) for s in srcs],
                "dsts": [int(d) for d in dsts],
            }
        )
        return np.asarray(doc.get("answers", []), dtype=bool)

    def rows(self, srcs) -> np.ndarray:
        doc = self.client.stripe_op(
            {"op": "rows", "srcs": [int(s) for s in srcs]}
        )
        return _unpack_bool(doc["rows"])

    def cols_fragment(self, dsts) -> np.ndarray:
        doc = self.client.stripe_op(
            {"op": "cols", "dsts": [int(d) for d in dsts]}
        )
        return _unpack_bool(doc["cols"])

    def health(self) -> dict:
        return self.client.stripe_op({"op": "describe"})


class StripeCoordinator:
    """Merge a stripe fleet back into one whole-cluster query surface.

    Scalar and row queries route to the source pod's stripe owner
    (``route="local"``); column, blast-radius and bounded-path queries
    scatter to every stripe and gather fragments in stripe order
    (``route="scatter"``), producing answers **bit-identical** to a
    single whole-state follower. Each stripe may register several owners
    (primary + backups): a fragment whose owner dies mid-query moves to
    the next owner (``route="retry"``); a stripe whose owners are all
    dead — or that never had one — fails the whole query with
    :class:`StripeCoverageError`. Fan-outs nest ``stripe_fragment``
    child spans under one ``stripe_scatter`` parent, so ``kv-tpu trace``
    stitches the scatter into a single timeline.

    ``path_exists`` / ``hops`` run their bounded BFS over the gathered rows
    on the first local owner's engine device, else on ``"cuda"``."""

    def __init__(self, owners: Sequence, *, pods: Sequence[Pod]) -> None:
        self.pods = list(pods)
        self.n = len(self.pods)
        self._pod_idx: Dict[Tuple[str, str], int] = {
            (p.namespace, p.name): i for i, p in enumerate(self.pods)
        }
        self._owners: Dict[int, List] = defaultdict(list)
        counts = set()
        for owner in owners:
            k, count = owner.stripe
            counts.add(int(count))
            self._owners[int(k)].append(owner)
        if not counts:
            raise ConfigError("StripeCoordinator needs at least one owner")
        if len(counts) > 1:
            raise ConfigError(
                f"owners disagree on stripe count: {sorted(counts)}"
            )
        self.n_stripes = counts.pop()
        # the bounded BFS merges rows where the local owners' counts live;
        # a fleet of remote owners merges on the card (None means "cuda")
        local = [o.engine.device for o in owners if hasattr(o, "engine")]
        #: where the bounded path queries run their BFS over gathered rows
        self.device = local[0] if local else None

    # ------------------------------------------------------------- helpers
    def _idx(self, ref: str) -> int:
        ns, sep, name = str(ref).partition("/")
        if not sep or not ns or not name:
            raise ServeError(
                f"pod reference must be NAMESPACE/NAME, got {ref!r}"
            )
        try:
            return self._pod_idx[(ns, name)]
        except KeyError:
            raise ServeError(
                f"unknown pod {ns}/{name} (coordinator holds "
                f"{self.n} pods)"
            ) from None

    def _name(self, idx: int) -> str:
        p = self.pods[idx]
        return f"{p.namespace}/{p.name}"

    def _stripe_for(self, idx: int) -> int:
        return stripe_of(self.n, self.n_stripes, idx)

    def _call(self, k: int, method: str, *args):
        """One stripe fragment: primary first, then backups; all dead →
        typed coverage failure, never a truncated answer."""
        attempt = 0
        last: Optional[BaseException] = None
        for owner in self._owners.get(k, []):
            try:
                with trace(
                    "stripe_fragment",
                    stripe=f"{k + 1}/{self.n_stripes}",
                    op=method,
                    owner=getattr(owner, "replica", ""),
                ):
                    out = getattr(owner, method)(*args)
                if attempt:
                    STRIPE_QUERIES_TOTAL.labels(route="retry").inc()
                return out
            except _EJECTABLE as e:
                attempt += 1
                last = e
                continue
        STRIPE_COVERAGE_GAPS_TOTAL.inc()
        lo, hi = stripe_bounds(self.n, k, self.n_stripes)
        raise StripeCoverageError(
            f"stripe {k + 1}/{self.n_stripes} (pods [{lo}, {hi})) has no "
            f"live owner"
            + (f" (last failure: {type(last).__name__}: {last})" if last else ""),
            stripe=(k, self.n_stripes),
            rows=(lo, hi),
        )

    def _check_port(self, port, protocol) -> None:
        if port is not None:
            raise ServeError(
                "the stripe coordinator answers any-port probes only "
                f"(count matrices carry no port atoms); got port={port!r} "
                f"protocol={protocol!r}"
            )

    # ------------------------------------------------------------- queries
    def can_reach(
        self,
        src: str,
        dst: str,
        port: Optional[int] = None,
        protocol: str = "TCP",
    ) -> bool:
        self._check_port(port, protocol)
        si, di = self._idx(src), self._idx(dst)
        STRIPE_QUERIES_TOTAL.labels(route="local").inc()
        ans = self._call(self._stripe_for(si), "probes", [si], [di])
        return bool(ans[0])

    def can_reach_batch(self, queries: Sequence) -> np.ndarray:
        """Any-port probe batch, scattered by source-pod stripe owner and
        reassembled in query order (bool [Q])."""
        srcs: List[int] = []
        dsts: List[int] = []
        for q in queries:
            q = tuple(q)
            if len(q) > 2:
                self._check_port(
                    q[2], q[3] if len(q) > 3 else "TCP"
                )
            srcs.append(self._idx(q[0]))
            dsts.append(self._idx(q[1]))
        answers = np.zeros(len(srcs), dtype=bool)
        groups: Dict[int, List[int]] = defaultdict(list)
        for pos, si in enumerate(srcs):
            groups[self._stripe_for(si)].append(pos)
        STRIPE_QUERIES_TOTAL.labels(
            route="local" if len(groups) <= 1 else "scatter"
        ).inc()
        with trace(
            "stripe_scatter", op="probes", stripes=len(groups),
            queries=len(srcs),
        ):
            for k in sorted(groups):
                pos = groups[k]
                ans = self._call(
                    k,
                    "probes",
                    [srcs[p] for p in pos],
                    [dsts[p] for p in pos],
                )
                answers[pos] = np.asarray(ans, dtype=bool)
        return answers

    def _gather_cols(self, dsts: Sequence[int]) -> np.ndarray:
        """Whole reach columns for global ``dsts`` — every stripe's
        ``[S, U]`` fragment concatenated in stripe order → ``[N, U]``."""
        STRIPE_QUERIES_TOTAL.labels(route="scatter").inc()
        with trace(
            "stripe_scatter", op="cols", stripes=self.n_stripes,
            queries=len(dsts),
        ):
            frags = [
                np.asarray(
                    self._call(k, "cols_fragment", list(dsts)), dtype=bool
                )
                for k in range(self.n_stripes)
            ]
        return np.concatenate(frags, axis=0)

    def who_can_reach(self, dst: str) -> List[str]:
        return self.who_can_reach_batch([dst])[0]

    def who_can_reach_batch(self, dsts: Sequence[str]) -> List[List[str]]:
        idx = [self._idx(d) for d in dsts]
        cols = self._gather_cols(idx)
        return [
            [
                self._name(int(i))
                for i in np.nonzero(cols[:, q])[0]
                if int(i) != di
            ]
            for q, di in enumerate(idx)
        ]

    def blast_radius(self, src: str) -> List[str]:
        return self.blast_radius_batch([src])[0]

    def blast_radius_batch(self, srcs: Sequence[str]) -> List[List[str]]:
        idx = [self._idx(s) for s in srcs]
        rows = self._scatter_rows(np.asarray(idx, dtype=np.int64))
        return [
            [
                self._name(int(i))
                for i in np.nonzero(rows[q, :])[0]
                if int(i) != si
            ]
            for q, si in enumerate(idx)
        ]

    def _scatter_rows(self, idx: np.ndarray) -> np.ndarray:
        """Reach rows for global sources ``idx`` — each row fetched from
        its owning stripe, reassembled in request order (``[U, N]``)."""
        out = np.zeros((idx.size, self.n), dtype=bool)
        groups: Dict[int, List[int]] = defaultdict(list)
        for pos, si in enumerate(idx):
            groups[self._stripe_for(int(si))].append(pos)
        STRIPE_QUERIES_TOTAL.labels(
            route="local" if len(groups) <= 1 else "scatter"
        ).inc()
        with trace(
            "stripe_scatter", op="rows", stripes=len(groups),
            queries=int(idx.size),
        ):
            for k in sorted(groups):
                pos = groups[k]
                rows = self._call(
                    k, "rows", [int(idx[p]) for p in pos]
                )
                out[pos] = np.asarray(rows, dtype=bool)
        return out

    # --------------------------------------------------------------- paths
    def path_exists(
        self, src: str, dst: str, max_hops: Optional[int] = None
    ) -> bool:
        si, di = self._idx(src), self._idx(dst)
        acc, _ = self._bounded([si], max_hops)
        return bool(acc[0, di])

    def hops(self, src: str, dst: str, max_hops: Optional[int] = None) -> int:
        si, di = self._idx(src), self._idx(dst)
        _, hop = self._bounded([si], max_hops)
        h = int(hop[0, di])
        return h if h > 0 else -1

    def _bounded(self, seeds: Sequence[int], max_hops: Optional[int]):
        """Bounded multi-source closure over the fleet: each BFS level's
        frontier rows scatter to their owning stripes — the same
        ``bounded_closure_rows`` engine a whole-state follower uses, fed
        by the scatter-gather row oracle, so verdicts and hop counts are
        bit-identical."""
        from ..ops.closure import bounded_closure_rows

        with trace(
            "stripe_scatter", op="bounded", stripes=self.n_stripes,
        ):
            return bounded_closure_rows(
                self._scatter_rows, seeds, self.n, hops=max_hops,
                device=self.device,
            )

    # ------------------------------------------------------------ describe
    def coverage_gaps(self) -> List[int]:
        """Stripe indices with no registered owner (DOWN stripes found at
        query time raise; this is the static view fleet rendering uses)."""
        return [
            k for k in range(self.n_stripes) if not self._owners.get(k)
        ]

    def describe(self) -> dict:
        table = stripe_table(self.n, self.n_stripes)
        return {
            "n_pods": self.n,
            "n_stripes": self.n_stripes,
            "stripes": [
                {
                    "index": k,
                    "lo": lo,
                    "hi": hi,
                    "pods": hi - lo,
                    "owners": [
                        getattr(o, "replica", repr(o))
                        for o in self._owners.get(k, [])
                    ],
                    "down": not self._owners.get(k),
                }
                for k, (lo, hi) in enumerate(table)
            ],
            "coverage_gaps": self.coverage_gaps(),
        }


# Kernel-manifest registration (observe/aot.py): rebind the dispatch
# functions so their dispatch keys reach the warm pack's manifest.
from ..observe.aot import register_kernel as _register_kernel  # noqa: E402

_stripe_col_patch = _register_kernel(
    "stripe", "_stripe_col_patch", _stripe_col_patch
)
_stripe_row_patch = _register_kernel(
    "stripe", "_stripe_row_patch", _stripe_row_patch
)
