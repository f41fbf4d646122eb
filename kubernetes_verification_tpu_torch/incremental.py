"""Incremental re-verify on policy diffs (BASELINE config 5), dense form.

The port of ``kubernetes_verification_tpu.incremental``. With any-port
semantics the reachability matrix is

    reach = ((Σ_p ing_peersₚ ⊗ sel_ingₚ > 0) ∨ ¬ing_iso)
          ∧ ((Σ_p sel_egₚ ⊗ eg_peersₚ > 0) ∨ ¬eg_iso)   ∨ diag

an OR over per-policy outer products. ``IncrementalVerifier`` keeps the
*sum* (two int32 ``[N, N]`` count matrices on one device) instead of the OR,
so a policy add/remove/update is one subtract and one add of a rank-1 outer
product, and a pod relabel patches one row and one column of each matrix.
``reach`` re-derives the bool matrix from the counts on demand.

Differences from the JAX engine, none of which changes a count:

* the counts are updated IN PLACE instead of donated; a caller that aliases
  them (``ops/device_state.py::dense_query_state``) sees later diffs;
* a rank-1 update touches only the block of rows where its source vector is
  set and columns where its destination vector is set (``_rank1_add``), not
  the whole matrix: both are exact, and the untouched cells gain 0;
* the build's contraction is one int8 ``bool_dot`` per direction, and its
  per-policy maps come from the tiled solver's ``_policy_maps``.

The JAX engine's ``kvtpu_*`` metrics and dispatch tracker are kept, at the
same call sites.

Scope: any-port semantics; pod add/remove changes N and falls back to a
rebuild. At 32,768 pods one count matrix is 4.29 GB.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .backends.base import VerifyConfig
from .encode.encoder import cluster_vocab, encode_cluster
from .models.core import Cluster, NetworkPolicy, Pod
from .observe import DispatchTracker
from .observe.metrics import INCREMENTAL_OPS
from .ops.bits import unpack_words_i8
from .ops.closure import bool_dot
from .ops.padding import pad_grants
from .ops.tiled import HostArgs, _policy_maps, _put
from .packed_incremental import (
    PackedIncrementalVerifier,
    PolicyVectorizer,
    _copy_pods,
    pod_policy_flags,
)
from .resilience.errors import ServeError
from .resilience.retry import RetryPolicy, retry_transient
from .runtime import resolve_device

__all__ = ["IncrementalVerifier"]

_I8 = torch.int8
_I32 = torch.int32

#: cells of one gathered block of a rank-1 update (bounds its index and
#: value temporaries to 2²⁴ elements)
_RANK1_BLOCK = 1 << 24
#: grant rows per step of the build's peer maps (no [G, N] peer matrix is
#: ever resident), the packed engine's default
_GRANT_CHUNK = 2048


def _rank1_add(count: torch.Tensor, src, dst, sign: int) -> None:
    """count += sign · src ⊗ dst, in place, for host 0/1 vectors ``src``
    [rows] and ``dst`` [cols]: only the block of rows where ``src`` is set
    and columns where ``dst`` is set changes, by exactly ``sign``, so only
    that block is gathered and written back (a slab of rows at a time), and
    no ``[N, N]`` temporary exists."""
    rows = np.flatnonzero(np.asarray(src))
    cols = np.flatnonzero(np.asarray(dst))
    if not rows.size or not cols.size:
        return
    dev = count.device
    c = torch.as_tensor(cols, device=dev)[None, :]
    step = max(1, _RANK1_BLOCK // cols.size)
    for r0 in range(0, rows.size, step):
        r = torch.as_tensor(rows[r0 : r0 + step], device=dev)[:, None]
        count[r, c] += sign


def _row_col_patch(count: torch.Tensor, idx: int, d_row, d_col) -> None:
    """Add host deltas to row ``idx`` and column ``idx`` of a count matrix,
    in place. The (idx, idx) cell must be carried by ``d_row`` only
    (``d_col[idx] == 0``)."""
    dev = count.device
    count[idx] += torch.as_tensor(np.asarray(d_row, dtype=np.int32), device=dev)
    count[:, idx] += torch.as_tensor(np.asarray(d_col, dtype=np.int32), device=dev)


def _derive_reach(
    ing_count: torch.Tensor,
    eg_count: torch.Tensor,
    ing_iso_count: torch.Tensor,
    eg_iso_count: torch.Tensor,
    *,
    self_traffic: bool,
    default_allow_unselected: bool,
) -> torch.Tensor:
    """bool [N, N] reach from the count matrices and the int32 isolation
    counts, on their device."""
    reach = ing_count > 0
    if default_allow_unselected:
        reach |= (ing_iso_count == 0)[None, :]
    eg_ok = eg_count > 0
    if default_allow_unselected:
        eg_ok |= (eg_iso_count == 0)[:, None]
    reach &= eg_ok
    del eg_ok
    if self_traffic:
        reach.fill_diagonal_(True)
    return reach


#: first dispatches per abstract signature (kvtpu_jit_recompiles_total)
_TRACKER = DispatchTracker("dense")


class IncrementalVerifier:
    """Maintains a cluster's reachability under policy/pod-label diffs.

    ``device=None`` means ``"cuda"`` (``BackendError`` without a GPU); the
    CPU runs only when the caller passes ``device="cpu"``."""

    #: engine kind the serving plane keys on (``serve/service.py``)
    metrics_engine = "dense"

    #: transient-failure budget around the reach derivation; assign a tuned
    #: RetryPolicy on the instance to change it
    retry_policy = RetryPolicy()

    def _count_op(self, op: str) -> None:
        INCREMENTAL_OPS.labels(engine=self.metrics_engine, op=op).inc()

    def __init__(
        self,
        cluster: Cluster,
        config: Optional[VerifyConfig] = None,
        device=None,
    ) -> None:
        self.config = config or VerifyConfig()
        self.device = resolve_device(device)
        # deep-copy pods: update_pod_labels mutates labels in place, and the
        # verifier must not silently rewrite the caller's Cluster
        self.pods: List[Pod] = _copy_pods(cluster.pods)
        self.namespaces = list(cluster.namespaces)
        self.policies: Dict[str, NetworkPolicy] = {}
        n = len(self.pods)
        self._ing_count, self._eg_count = self._alloc_counts(n)
        self._ing_iso = np.zeros(n, dtype=np.int64)
        self._eg_iso = np.zeros(n, dtype=np.int64)
        #: per-policy contribution vectors (host copies, bool [N])
        self._vectors: Dict[str, Tuple[np.ndarray, ...]] = {}
        self._reach_dirty = True
        self._reach = None
        #: the current generation's reach as packed int32 words, when the
        #: posture plane packed them (``adopt_reach_words``)
        self._reach_words: Optional[torch.Tensor] = None
        self.update_count = 0
        self._batch_init(cluster)

    def _alloc_counts(self, n: int):
        """Empty count matrices for ``n`` pods on the engine's device. The
        one allocation hook subclasses with partial row ownership override
        (the stripe engine of the serving plane returns [S, N] row stripes
        here, so no [N, N] operand ever exists in its process)."""
        return (
            torch.zeros((n, n), dtype=_I32, device=self.device),
            torch.zeros((n, n), dtype=_I32, device=self.device),
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch_init(self, cluster: Cluster) -> None:
        """Initial build: one encoder pass, the per-policy maps on the
        device, one int8 contraction per direction (P rank-1 updates
        collapsed into one product each). The frozen encoding also seeds the
        ``PolicyVectorizer`` that later policy diffs re-encode through.
        ``build_timings`` holds the phases' seconds."""
        timings: Dict[str, float] = {}
        self.build_timings = timings
        t0 = time.perf_counter()
        snapshot = Cluster(
            pods=self.pods, namespaces=self.namespaces,
            policies=list(cluster.policies),
        )
        # label dicts are COPIED: an aliased caller dict mutated in place
        # would satisfy the relabel no-op guard and silently skip the
        # re-derivation (pods are deep-copied for the same reason)
        self._ns_labels = {ns.name: dict(ns.labels) for ns in self.namespaces}

        def seed_vectorizer(vocab) -> None:
            t = time.perf_counter()
            self._vectorizer = PolicyVectorizer(
                self.pods,
                self._ns_labels,
                vocab,
                {ns.name: i for i, ns in enumerate(self.namespaces)},
                self.config.direction_aware_isolation,
            )
            timings["vectorizer"] = time.perf_counter() - t

        if not cluster.policies:
            # nothing to solve: skip the full encode — the vectorizer needs
            # just the vocab
            seed_vectorizer(cluster_vocab(self.pods, self.namespaces))
            return
        enc = encode_cluster(snapshot, compute_ports=False)
        timings["encode"] = time.perf_counter() - t0
        seed_vectorizer(enc.vocab)

        t0 = time.perf_counter()
        P = enc.n_policies
        g_chunk = max(1, min(_GRANT_CHUNK, max(enc.ingress.n, enc.egress.n, 1)))
        args = _put(HostArgs(
            enc.pod_kv, enc.pod_key, enc.pod_ns, enc.ns_kv, enc.ns_key,
            enc.pol_sel, enc.pol_ns, enc.pol_affects_ingress,
            enc.pol_affects_egress,
            pad_grants(enc.ingress, (-enc.ingress.n) % g_chunk, P, 0),
            pad_grants(enc.egress, (-enc.egress.n) % g_chunk, P, 0),
            np.zeros(0, dtype=np.int32),  # col_mask: no padded columns here
        ), self.device)
        aware = self.config.direction_aware_isolation
        _, sel_ing, sel_eg, _, _, ing_peers, eg_peers = _policy_maps(
            args, chunk=g_chunk, direction_aware_isolation=aware
        )
        if aware:
            # the per-policy vector convention: the peer side is gated too
            ing_peers = ing_peers * args.aff_ing.to(_I8)[:, None]
            eg_peers = eg_peers * args.aff_eg.to(_I8)[:, None]
        del args
        # the zero matrices go first: at 32,768 pods each is 4.29 GB
        self._ing_count = self._eg_count = None
        self._ing_count, self._eg_count = self._contract_counts(
            sel_ing, sel_eg, ing_peers, eg_peers
        )
        self._sync()
        timings["contraction"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sel_ing, sel_eg, ing_peers, eg_peers = (
            m.cpu().numpy().astype(bool) for m in (sel_ing, sel_eg, ing_peers, eg_peers)
        )
        self._ing_iso = sel_ing.sum(axis=0, dtype=np.int64)
        self._eg_iso = sel_eg.sum(axis=0, dtype=np.int64)
        for i, pol in enumerate(cluster.policies):
            key = self._key(pol)
            if key in self.policies:
                raise KeyError(f"duplicate policy {key}")
            self.policies[key] = pol
            self._vectors[key] = (
                sel_ing[i].copy(), sel_eg[i].copy(),
                ing_peers[i].copy(), eg_peers[i].copy(),
            )
        timings["vectors"] = time.perf_counter() - t0

    @staticmethod
    def _count_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """The count contraction ``aᵀ · b`` of two int8 [P, N] maps over the
        policy axis, int32 [N, N]: one ``bool_dot`` on K-contiguous copies
        (it pads P to a multiple of 8 with zero columns itself)."""
        return bool_dot(a.t().contiguous(), b.t().contiguous()).contiguous()

    def _contract_counts(self, sel_ing, sel_eg, ing_peers, eg_peers):
        """Collapse P rank-1 contributions into the two count matrices. The
        stripe engine of the serving plane overrides this to slice the
        source axis BEFORE the contraction, so the [N, N] products are never
        formed in a striped process."""
        return (
            self._count_dot(ing_peers, sel_ing),
            self._count_dot(sel_eg, eg_peers),
        )

    # ---------------------------------------------------------------- diffs
    def _key(self, pol: NetworkPolicy) -> str:
        return f"{pol.namespace}/{pol.name}"

    def _policy_vectors(
        self, pol: NetworkPolicy
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(sel_ing, sel_eg, ing_peers, eg_peers) bool [N] for one policy —
        re-encoded against the frozen init-time encoding on the host, with
        label-drifted pods fixed up by object semantics (the CPU oracle's,
        ``backends/cpu.py``)."""
        return tuple(
            np.asarray(v, dtype=bool) for v in self._vectorizer.vectors(pol)
        )

    def _apply(self, vecs, sign: int) -> None:
        sel_ing, sel_eg, ing_peers, eg_peers = vecs
        _TRACKER.track("_rank1_add", self._ing_count, ing_peers, sel_ing)
        _rank1_add(self._ing_count, ing_peers, sel_ing, sign)
        _rank1_add(self._eg_count, sel_eg, eg_peers, sign)
        self._ing_iso += sign * np.asarray(vecs[0], dtype=np.int64)
        self._eg_iso += sign * np.asarray(vecs[1], dtype=np.int64)
        self._reach_dirty = True
        self.update_count += 1

    def add_policy(self, pol: NetworkPolicy) -> None:
        key = self._key(pol)
        if key in self.policies:
            raise KeyError(f"policy {key} exists; use update_policy")
        if pol.namespace not in self._ns_labels:
            self._ns_labels[pol.namespace] = {}
        vecs = self._policy_vectors(pol)
        self.policies[key] = pol
        self._vectors[key] = vecs
        self._apply(vecs, +1)
        self._count_op("policy_add")

    def remove_policy(self, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        self.policies.pop(key)  # KeyError if absent
        vecs = self._vectors.pop(key)
        self._apply(vecs, -1)
        self._count_op("policy_remove")

    def update_policy(self, pol: NetworkPolicy) -> None:
        self.remove_policy(pol.namespace, pol.name)
        self.add_policy(pol)

    def update_pod_labels(self, idx: int, labels: Dict[str, str]) -> None:
        """Relabel pod ``idx``: every policy's contribution through this pod
        is patched — one row + one column of each count matrix, O(P + N)
        host work and O(N) device writes."""
        pod = self.pods[idx]
        n = len(self.pods)

        def row_col_sums():
            """(ing_row, ing_col, eg_row, eg_col, iso_i, iso_e): Σ_p
            contributions through pod ``idx``, from the current vectors.
            ing_count[src, dst] = Σ ing_peers[src]·sel_ing[dst] so its row
            idx is Σ ing_peers[idx]·sel_ing[:], its col idx (corner zeroed)
            Σ sel_ing[idx]·ing_peers[:]; egress is the mirror."""
            ing_row = np.zeros(n, dtype=np.int64)
            ing_col = np.zeros(n, dtype=np.int64)
            eg_row = np.zeros(n, dtype=np.int64)
            eg_col = np.zeros(n, dtype=np.int64)
            iso_i = 0
            iso_e = 0
            for vec in self._vectors.values():
                sel_ing, sel_eg, ing_peers, eg_peers = vec
                if ing_peers[idx]:
                    ing_row += sel_ing
                if sel_ing[idx]:
                    ing_col += ing_peers
                    iso_i += 1
                if sel_eg[idx]:
                    eg_row += eg_peers
                    iso_e += 1
                if eg_peers[idx]:
                    eg_col += sel_eg
            ing_col[idx] = 0  # corner lives in the row sums
            eg_col[idx] = 0
            return ing_row, ing_col, eg_row, eg_col, iso_i, iso_e

        old = row_col_sums()
        pod.labels = dict(labels)
        # re-index the pod in the vectorizer (or dirty-mark it when its new
        # labels fall outside the frozen universe) so later policy
        # re-encodes see the change
        self._vectorizer.note_pod(idx)
        for key, pol in self.policies.items():
            flags = pod_policy_flags(
                pol, pod, self._ns_labels, self.config.direction_aware_isolation
            )
            for vec, f in zip(self._vectors[key], flags):
                vec[idx] = f
        new = row_col_sums()
        self._patch_row_col(
            idx,
            new[0] - old[0], new[1] - old[1],
            new[2] - old[2], new[3] - old[3],
        )
        self._ing_iso[idx] += new[4] - old[4]
        self._eg_iso[idx] += new[5] - old[5]
        self._reach_dirty = True
        self.update_count += 1
        self._count_op("pod_relabel")

    def _patch_row_col(
        self,
        idx: int,
        d_ing_row: np.ndarray,
        d_ing_col: np.ndarray,
        d_eg_row: np.ndarray,
        d_eg_col: np.ndarray,
    ) -> None:
        """Apply one relabel's count deltas on the device: row ``idx`` and
        column ``idx`` of both matrices (the (idx, idx) corner rides the
        row deltas — ``d_*_col[idx] == 0`` by construction). The stripe
        engine of the serving plane overrides this: the row patch lands only
        on the owning stripe while the column slice lands on every
        stripe."""
        _TRACKER.track("_row_col_patch", self._ing_count)
        _row_col_patch(self._ing_count, idx, d_ing_row, d_ing_col)
        _row_col_patch(self._eg_count, idx, d_eg_row, d_eg_col)

    # ----------------------------------------------------------- namespaces
    # registration bookkeeping (live _ns_labels dict + namespaces list +
    # vectorizer ns row) is identical across engines — share the packed
    # engine's implementations rather than keeping copies in sync
    add_namespace = PackedIncrementalVerifier.add_namespace
    _set_ns_labels = PackedIncrementalVerifier._set_ns_labels

    def update_namespace_labels(
        self, name: str, labels: Dict[str, str]
    ) -> None:
        """Relabel namespace ``name``: namespaceSelector peer matches can
        move for EVERY policy, so this engine re-derives each policy's
        vectors and swaps the changed ones."""
        if name not in self._ns_labels:
            raise KeyError(f"namespace {name} is not registered")
        if dict(self._ns_labels[name]) == dict(labels):
            return
        self._set_ns_labels(name, labels)
        for key, pol in self.policies.items():
            old = self._vectors[key]
            new = self._policy_vectors(pol)
            if any((a != b).any() for a, b in zip(old, new)):
                self._apply(old, -1)
                self._apply(new, +1)
                self._vectors[key] = new
        self._count_op("namespace_relabel")

    def remove_namespace(self, name: str) -> None:
        """Same contract as the packed engines' (this engine has no pod
        churn, so only resident policies and pods can block the removal)."""
        if name not in self._ns_labels:
            raise KeyError(f"namespace {name} is not registered")
        pols = [k for k in self.policies if k.split("/", 1)[0] == name]
        if pols:
            raise ServeError(
                f"namespace {name} still holds {len(pols)} polic(ies); "
                "remove them before removing the namespace"
            )
        if any(p.namespace == name for p in self.pods):
            raise ServeError(
                f"namespace {name} still holds pods; this engine cannot "
                "remove them — rebuild without the namespace"
            )
        del self._ns_labels[name]
        self.namespaces = [ns for ns in self.namespaces if ns.name != name]
        self._count_op("namespace_remove")

    # --------------------------------------------------------------- result
    def _iso_tensors(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The isolation counts as int32 tensors on the engine's device."""
        return (
            torch.as_tensor(self._ing_iso.astype(np.int32), device=self.device),
            torch.as_tensor(self._eg_iso.astype(np.int32), device=self.device),
        )

    def adopt_reach_words(self, words: torch.Tensor) -> None:
        """Take the current generation's reach as packed int32 words
        ``[N, ceil32(N)]`` (the reference's little bit order), packed from
        the counts by the posture plane (``ops/device_state.py``): ``reach``
        is then clean and unpacks them on demand instead of deriving — the
        counterpart of the JAX package deriving ``reach`` while it packs
        the posture words. The next mutation makes it dirty again."""
        self._reach_words = words
        self._reach = None
        self._reach_dirty = False

    def _unpack_reach_words(self) -> np.ndarray:
        """The adopted words unpacked where they live, then one bool copy to
        the host (the derivation's own transfer)."""
        n, w = self._reach_words.shape
        bits = unpack_words_i8(self._reach_words, 32 * int(w))[:, :n]
        return bits.to(torch.bool).cpu().numpy()

    @property
    def reach_clean(self) -> bool:
        """``reach`` needs no derivation: the host matrix, or the posture
        words of the current generation, is at hand."""
        return not self._reach_dirty and (
            self._reach is not None or self._reach_words is not None
        )

    @property
    def reach(self) -> np.ndarray:
        """Current reachability matrix, bool [N, N] on the host (derived
        from the counts on the device on demand, then copied; or unpacked
        from adopted posture words)."""
        if not self._reach_dirty and self._reach is None and self._reach_words is not None:
            # device work like the derivation's, so under the same retry and
            # classification: a fault reaches the caller as a BackendError
            self._reach = retry_transient(
                self._unpack_reach_words, policy=self.retry_policy, backend="dense"
            )
            self._reach_words = None
        if self._reach_dirty:
            t0 = time.perf_counter()
            _TRACKER.track(
                "_derive_reach",
                self._ing_count,
                static=(
                    self.config.self_traffic,
                    self.config.default_allow_unselected,
                ),
            )

            def derive() -> np.ndarray:
                ing_iso, eg_iso = self._iso_tensors()
                return _derive_reach(
                    self._ing_count, self._eg_count, ing_iso, eg_iso,
                    self_traffic=self.config.self_traffic,
                    default_allow_unselected=self.config.default_allow_unselected,
                ).cpu().numpy()

            self._reach = retry_transient(
                derive, policy=self.retry_policy, backend="dense"
            )
            self._derive_time = time.perf_counter() - t0
            self._reach_dirty = False
            self._reach_words = None
        return self._reach

    def as_cluster(self) -> Cluster:
        """Snapshot of the current state as a plain Cluster (for full-solve
        cross-checks and checkpointing)."""
        return Cluster(
            pods=[Pod(p.name, p.namespace, dict(p.labels), p.ip, dict(p.container_ports)) for p in self.pods],
            namespaces=list(self.namespaces),
            policies=list(self.policies.values()),
        )

