"""Cluster → dense tensors: the tensorised form of fact/selector compilation.

This is the host-side encode phase (one transfer to device, SURVEY.md §7.2
layer 2). It turns the object model into fixed-shape boolean/integer arrays
consumed by the tensor kernels in ``ops/``:

* label facts → ``pod_kv``/``pod_key``/``ns_kv``/``ns_key`` matrices — the
  role of ``define_pod_facts`` (``kubesv/kubesv/constraint.py:242-275``);
* each ``LabelSelector`` → one row of a ``SelectorEnc`` stack — the role of
  ``define_label_selector`` (``kubesv/kubesv/model.py:178-243``), with the
  whole matchExpressions algebra folded into five masks + an In-expression
  block (see ``SelectorEnc``);
* each (policy, rule, peer) → one *grant* row of a ``GrantBlock`` — the role
  of ``define_ingress_rules``/``define_egress_rules``/``define_peer_rule``
  (``kubesv/kubesv/model.py:432-483,350-363``).

Everything is NumPy here; the backend moves arrays to device once. This is
the PyTorch port's own copy of ``kubernetes_verification_tpu.encode.encoder``
(the k8s-level encoder; the kano encoders are not ported yet): the same
cluster gives the same arrays in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..backends.base import PortAtom
from ..resilience.errors import EncodeError
from ..models.core import Cluster, NetworkPolicy, Selector
from .ports import (
    ALL_ATOM,
    compute_port_atoms,
    named_resolution,
    rule_named_specs,
    rule_port_mask,
)
from .vocab import Vocab

__all__ = [
    "SelectorEnc",
    "GrantBlock",
    "EncodedCluster",
    "cluster_vocab",
    "encode_cluster",
]


@dataclass
class SelectorEnc:
    """A stack of S compiled selectors over a V-pair / K-key vocabulary.

    An entity with pair bitmap ``kv`` and key bitmap ``key`` matches row s iff

    * ``req_eq[s] ⊆ kv``          (matchLabels pairs, all present)
    * ``req_key[s] ⊆ key``        (Exists keys, all present)
    * ``forbid_eq[s] ∩ kv = ∅``   (union of NotIn value masks — NotIn folds
                                   across expressions because each entity has
                                   at most one value per key)
    * ``forbid_key[s] ∩ key = ∅`` (DoesNotExist keys)
    * for each valid In expression e: ``in_mask[s,e] ∩ kv ≠ ∅``
    * ``not impossible[s]``       (selector requires a pair/key no entity in
                                   the cluster has — it can match nothing)

    All five subset/disjointness tests are count comparisons after an integer
    matmul, so the whole stack evaluates as a handful of matrix products
    (``ops/match.py``).
    """

    req_eq: np.ndarray  # bool [S, V]
    req_key: np.ndarray  # bool [S, K]
    forbid_eq: np.ndarray  # bool [S, V]
    forbid_key: np.ndarray  # bool [S, K]
    in_mask: np.ndarray  # bool [S, E, V]
    in_valid: np.ndarray  # bool [S, E]
    impossible: np.ndarray  # bool [S]

    @property
    def n(self) -> int:
        return self.req_eq.shape[0]


def _encode_selector_stack(
    selectors: Sequence[Optional[Selector]], vocab: Vocab
) -> SelectorEnc:
    """Compile selectors (None → empty row that matches everything)."""
    S, V, K = len(selectors), vocab.n_pairs, vocab.n_keys
    E = max(
        (
            sum(1 for e in s.match_expressions if e.op == "In")
            for s in selectors
            if s is not None
        ),
        default=0,
    )
    enc = SelectorEnc(
        req_eq=np.zeros((S, V), dtype=bool),
        req_key=np.zeros((S, K), dtype=bool),
        forbid_eq=np.zeros((S, V), dtype=bool),
        forbid_key=np.zeros((S, K), dtype=bool),
        in_mask=np.zeros((S, E, V), dtype=bool),
        in_valid=np.zeros((S, E), dtype=bool),
        impossible=np.zeros(S, dtype=bool),
    )
    for s, sel in enumerate(selectors):
        if sel is None:
            continue
        for k, v in sel.match_labels.items():
            pid = vocab.pair(k, v)
            if pid is None:
                # no entity carries this pair → the selector matches nothing
                enc.impossible[s] = True
            else:
                enc.req_eq[s, pid] = True
        e_idx = 0
        for expr in sel.match_expressions:
            if expr.op == "Exists":
                kid = vocab.key(expr.key)
                if kid is None:
                    enc.impossible[s] = True
                else:
                    enc.req_key[s, kid] = True
            elif expr.op == "DoesNotExist":
                kid = vocab.key(expr.key)
                if kid is not None:  # unknown key: everyone satisfies
                    enc.forbid_key[s, kid] = True
            elif expr.op == "NotIn":
                for v in expr.values:
                    pid = vocab.pair(expr.key, v)
                    if pid is not None:
                        enc.forbid_eq[s, pid] = True
            else:  # In
                enc.in_valid[s, e_idx] = True
                for v in expr.values:
                    pid = vocab.pair(expr.key, v)
                    if pid is not None:
                        enc.in_mask[s, e_idx, pid] = True
                # all-unknown values leave an empty mask: matches nothing,
                # which is exactly In's semantics here.
                e_idx += 1
    return enc


@dataclass
class GrantBlock:
    """Flattened (policy, rule, peer) triples for one direction.

    Row g grants traffic between the pods selected by policy ``pol[g]`` and
    the peer-matched pods, on the port atoms in ``ports[g]``. ``match_all``
    marks rules with empty/missing ``from``/``to``; ``ns_sel_null`` switches
    the namespace scope between "policy's own namespace" (null) and the
    compiled namespace selector; ``ip_match`` carries host-precomputed
    ipBlock↔pod-IP matches when any ipBlock peer exists.

    ``dst_restrict[g]`` indexes ``EncodedCluster.restrict_bank``: the grant
    only reaches destination pods in that bank row (row 0 = no restriction).
    This is how named ports resolve per destination — a rule naming a port
    splits into one grant per (name, resolved atom) whose restriction is the
    set of dst pods resolving the name to that atom. Every kernel ANDs the
    bank row into the grant's dst-side operand (the selected pods for
    ingress, the peer set for egress)."""

    pol: np.ndarray  # int32 [G]
    match_all: np.ndarray  # bool [G]
    pod_sel: SelectorEnc  # [G] over pod labels
    ns_sel: SelectorEnc  # [G] over namespace labels
    ns_sel_null: np.ndarray  # bool [G]
    is_ipblock: np.ndarray  # bool [G]
    ports: np.ndarray  # bool [G, Q]
    ip_match: Optional[np.ndarray] = None  # bool [G, N] | None
    dst_restrict: Optional[np.ndarray] = None  # int32 [G] | None (= all 0)
    #: provenance back to the policy object: originating rule index within
    #: the policy's direction tuple, and peer index within that rule's
    #: ``peers`` (−1 = match-all rule). Survives run-splitting and padding;
    #: the incremental engines use it to re-evaluate single pods against a
    #: grant row with OBJECT semantics (frozen-vocab evaluation is unsound
    #: for labels the frozen encoding never saw).
    rule_id: Optional[np.ndarray] = None  # int32 [G] | None
    peer_id: Optional[np.ndarray] = None  # int32 [G] | None

    @property
    def n(self) -> int:
        return self.pol.shape[0]


@dataclass
class EncodedCluster:
    n_pods: int
    n_namespaces: int
    n_policies: int
    #: None for an encoding rebuilt from carried arrays (``encode/carry.py``)
    vocab: Optional[Vocab]
    atoms: List[PortAtom]
    pod_kv: np.ndarray  # bool [N, V]
    pod_key: np.ndarray  # bool [N, K]
    pod_ns: np.ndarray  # int32 [N]
    ns_kv: np.ndarray  # bool [M, V]
    ns_key: np.ndarray  # bool [M, K]
    pol_sel: SelectorEnc  # [P] podSelector stack
    pol_ns: np.ndarray  # int32 [P]
    pol_affects_ingress: np.ndarray  # bool [P] (effective policyTypes)
    pol_affects_egress: np.ndarray  # bool [P]
    ingress: GrantBlock
    egress: GrantBlock
    #: named-port dst-restriction rows (bool [B, N]; row 0 all-True); None
    #: when no named spec resolves — see GrantBlock.dst_restrict
    restrict_bank: Optional[np.ndarray] = None
    #: the (protocol, name) → [N, Q] resolution masks and the bank interner
    #: behind ``restrict_bank`` — retained so incremental re-verify can
    #: re-encode single policies against the SAME frozen universe
    resolution: Optional[Dict] = None
    restrict_bank_intern: Optional["_RestrictBank"] = None


class FrozenBankMiss(EncodeError, KeyError):
    """A frozen restriction bank was asked for a new (protocol, name,
    atom) row — the incremental caller must rebuild."""


class _RestrictBank:
    """Interns named-port dst-restriction rows. Row 0 is the all-True
    unrestricted row; one row per (protocol, name, atom) actually used.

    A *frozen* bank (incremental re-verify: the bank array is resident
    device state whose shape cannot grow per diff) resolves known keys but
    raises on new ones — the caller falls back to a rebuild."""

    def __init__(self, n_pods: int) -> None:
        self.rows: List[np.ndarray] = [np.ones(n_pods, dtype=bool)]
        self._ids: Dict[Tuple[str, str, int], int] = {}
        self.frozen = False

    def intern(self, key: Tuple[str, str, int], mask: np.ndarray) -> int:
        if key not in self._ids:
            if self.frozen:
                raise FrozenBankMiss(
                    f"named-port restriction {key} not in the frozen bank"
                )
            self._ids[key] = len(self.rows)
            self.rows.append(mask)
        return self._ids[key]

    def array(self) -> Optional[np.ndarray]:
        return np.stack(self.rows) if len(self.rows) > 1 else None


def _encode_grants(
    policies: Sequence[NetworkPolicy],
    pods: Sequence,
    direction: str,
    atoms: Sequence[PortAtom],
    vocab: Vocab,
    resolution: Optional[Dict] = None,
    bank: Optional[_RestrictBank] = None,
) -> GrantBlock:
    pols: List[int] = []
    match_all: List[bool] = []
    pod_sels: List[Optional[Selector]] = []
    ns_sels: List[Optional[Selector]] = []
    ns_null: List[bool] = []
    is_ip: List[bool] = []
    port_rows: List[np.ndarray] = []
    restricts: List[int] = []
    ip_rows: Dict[int, np.ndarray] = {}

    rule_ids: List[int] = []
    peer_ids: List[int] = []

    n = len(pods)
    Q = len(atoms)
    for pi, pol in enumerate(policies):
        rules = pol.ingress if direction == "ingress" else pol.egress
        if not rules:
            continue
        for ri, rule in enumerate(rules):
            # rule_port_mask ignores port specs when atoms == [ALL_ATOM];
            # in resolution mode it covers the numeric specs only — named
            # specs become extra single-atom variants with a dst restriction
            pmask = rule_port_mask(rule, atoms)
            # the base row is emitted even with an all-false mask (a rule
            # whose only specs are unresolvable named ports): it grants no
            # edges but its peer rows still feed the per-policy src/dst edge
            # sets and has-grant flags, matching the oracle
            variants: List[Tuple[np.ndarray, int]] = [(pmask, 0)]
            if resolution is not None:
                for proto, name in rule_named_specs(rule):
                    res = resolution.get((proto, name))
                    if res is None:
                        continue
                    for q in np.nonzero(res.any(axis=0))[0]:
                        rid = bank.intern(
                            (proto, name, int(q)), res[:, q].copy()
                        )
                        onehot = np.zeros(Q, dtype=bool)
                        onehot[q] = True
                        variants.append((onehot, rid))
            def emit_row(mask, rid, peer=None, ip_row=None, peer_i=-1, rule_i=ri):
                g = len(pols)
                pols.append(pi)
                rule_ids.append(rule_i)
                peer_ids.append(peer_i)
                if peer is None:  # match-all rule
                    match_all.append(True)
                    pod_sels.append(None)
                    ns_sels.append(None)
                    ns_null.append(True)
                    is_ip.append(False)
                elif peer.ip_block is not None:
                    match_all.append(False)
                    pod_sels.append(None)
                    ns_sels.append(None)
                    ns_null.append(True)
                    is_ip.append(True)
                    ip_rows[g] = ip_row
                else:
                    match_all.append(False)
                    pod_sels.append(peer.pod_selector)
                    ns_sels.append(peer.namespace_selector)
                    ns_null.append(peer.namespace_selector is None)
                    is_ip.append(False)
                port_rows.append(mask)
                restricts.append(rid)

            if rule.matches_all_peers:
                for mask, rid in variants:
                    emit_row(mask, rid)
            else:
                for qi, peer in enumerate(rule.peers):
                    # the ipBlock↔pod-IP row is O(N) Python — compute it
                    # once per peer and share it across the port variants
                    ip_row = (
                        np.array(
                            [peer.ip_block.matches_ip(p.ip) for p in pods],
                            dtype=bool,
                        )
                        if peer.ip_block is not None
                        else None
                    )
                    for mask, rid in variants:
                        emit_row(mask, rid, peer, ip_row, peer_i=qi)

    G = len(pols)
    ip_match = None
    if ip_rows:
        ip_match = np.zeros((G, n), dtype=bool)
        for g, row in ip_rows.items():
            ip_match[g] = row
    any_restrict = any(restricts)
    return GrantBlock(
        pol=np.asarray(pols, dtype=np.int32),
        match_all=np.asarray(match_all, dtype=bool),
        pod_sel=_encode_selector_stack(pod_sels, vocab),
        ns_sel=_encode_selector_stack(ns_sels, vocab),
        ns_sel_null=np.asarray(ns_null, dtype=bool),
        is_ipblock=np.asarray(is_ip, dtype=bool),
        ports=(
            np.stack(port_rows) if port_rows else np.zeros((0, Q), dtype=bool)
        ),
        ip_match=ip_match,
        dst_restrict=(
            np.asarray(restricts, dtype=np.int32) if any_restrict else None
        ),
        rule_id=np.asarray(rule_ids, dtype=np.int32),
        peer_id=np.asarray(peer_ids, dtype=np.int32),
    )


def cluster_vocab(pods: Sequence, namespaces: Sequence) -> Vocab:
    """The label-pair/key universe an encoding is frozen over: every pod and
    namespace label. (Policy selector pairs are deliberately excluded — a
    pair no entity carries can match nothing, and encodes as
    ``impossible``.)"""
    return Vocab.build(
        [p.labels for p in pods] + [ns.labels for ns in namespaces]
    )


def encode_cluster(
    cluster: Cluster, compute_ports: bool = True
) -> EncodedCluster:
    vocab = cluster_vocab(cluster.pods, cluster.namespaces)
    resolution = None
    bank = None
    if compute_ports:
        atoms = compute_port_atoms(cluster.policies, cluster.pods)
        resolution = named_resolution(cluster.policies, atoms, cluster.pods)
        if resolution:
            bank = _RestrictBank(cluster.n_pods)
    else:
        atoms = [ALL_ATOM]
    ns_index = cluster.namespace_index()

    pod_kv, pod_key = vocab.encode_label_matrix(p.labels for p in cluster.pods)
    ns_kv, ns_key = vocab.encode_label_matrix(ns.labels for ns in cluster.namespaces)
    pod_ns = np.asarray([ns_index[p.namespace] for p in cluster.pods], dtype=np.int32)
    pol_ns = np.asarray(
        [ns_index[pol.namespace] for pol in cluster.policies], dtype=np.int32
    )
    return EncodedCluster(
        n_pods=cluster.n_pods,
        n_namespaces=len(cluster.namespaces),
        n_policies=len(cluster.policies),
        vocab=vocab,
        atoms=list(atoms),
        pod_kv=pod_kv,
        pod_key=pod_key,
        pod_ns=pod_ns,
        ns_kv=ns_kv,
        ns_key=ns_key,
        pol_sel=_encode_selector_stack(
            [pol.pod_selector for pol in cluster.policies], vocab
        ),
        pol_ns=pol_ns,
        pol_affects_ingress=np.asarray(
            [pol.affects_ingress for pol in cluster.policies], dtype=bool
        ),
        pol_affects_egress=np.asarray(
            [pol.affects_egress for pol in cluster.policies], dtype=bool
        ),
        ingress=_encode_grants(
            cluster.policies, cluster.pods, "ingress", atoms, vocab,
            resolution, bank,
        ),
        egress=_encode_grants(
            cluster.policies, cluster.pods, "egress", atoms, vocab,
            resolution, bank,
        ),
        restrict_bank=bank.array() if bank is not None else None,
        resolution=resolution,
        restrict_bank_intern=bank,
    )
