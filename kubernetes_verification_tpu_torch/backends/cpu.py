"""Object-level NumPy reference backend — the semantics oracle.

The port's own copy of ``kubernetes_verification_tpu.backends.cpu``. It
interprets the model objects directly (per-pod/per-policy Python loops +
NumPy outer products), deliberately sharing no code with the tensorised
encoder and solves, so differential tests between the two are meaningful.
It plays the role of both reference verifiers:

* ``verify_kano`` reproduces the bit-vector matrix build
  (``kano_py/kano/model.py:124-165``) exactly, including the matcher quirk
  that a selector key appearing on *no* container is ignored (the interaction
  of the label-presence bitmap at ``kano_py/kano/model.py:142-147`` with the
  value refinement loop at ``:150-154``).
* ``verify`` implements full NetworkPolicy semantics, the role of the
  Datalog program (``kubesv/kubesv/constraint.py:136-298``), with the
  reference's two semantic flags plus correct policyTypes handling.

It runs on the host only and needs no device. Its phase timers
(``observe.Phases``), host cost estimates (``publish_host_estimate``),
metrics and closure progress ticker are the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..encode.ports import ALL_ATOM, compute_port_atoms, rule_port_mask
from ..models.core import (
    Cluster,
    Container,
    KanoPolicy,
    NetworkPolicy,
    Peer,
    Pod,
    Rule,
)
from ..observe import Phases
from ..observe.introspect import publish_host_estimate
from ..observe.metrics import BYTES_TRANSFERRED, CLOSURE_ITERATIONS
from .base import (
    VerifierBackend,
    VerifyConfig,
    VerifyResult,
    register_backend,
)

__all__ = ["CpuBackend"]


def _kano_match(
    labels: Dict[str, str],
    rule: Dict[str, str],
    cluster_keys: Set[str],
    relation=None,
) -> bool:
    """kano select/allow semantics: every rule key that exists *somewhere* in
    the cluster must be present on the container with a matching value; rule
    keys unknown to the whole cluster are ignored
    (``kano_py/kano/model.py:142-154``). ``relation`` is the pluggable value
    matcher (``LabelRelation``, ``kano_py/kano/model.py:59-68``); None =
    string equality — the reference's key-presence bitmap semantics mean the
    container must CARRY the key either way, the relation only decides
    whether the values agree."""
    for k, v in rule.items():
        if k not in cluster_keys:
            continue
        if k not in labels:
            return False
        if relation is None:
            if labels[k] != v:
                return False
        elif not relation.match(v, labels[k]):
            return False
    return True


class CpuBackend(VerifierBackend):
    name = "cpu"
    supports_label_relation = True

    # ------------------------------------------------------------------ kano
    def verify_kano(
        self,
        containers: Sequence[Container],
        policies: Sequence[KanoPolicy],
        config: VerifyConfig,
    ) -> VerifyResult:
        n = len(containers)
        ph = Phases()
        with ph("encode"):
            cluster_keys: Set[str] = set()
            for c in containers:
                cluster_keys.update(c.labels)

            reach = np.zeros((n, n), dtype=bool)
            src_sets = np.zeros((len(policies), n), dtype=bool)
            dst_sets = np.zeros((len(policies), n), dtype=bool)

            for c in containers:  # rebuild the per-container policy indices
                c.select_policies.clear()
                c.allow_policies.clear()

        with ph("solve", backend=self.name):
            relation = config.label_relation
            for pi, pol in enumerate(policies):
                for i, c in enumerate(containers):
                    src_sets[pi, i] = _kano_match(
                        c.labels, pol.src_labels, cluster_keys, relation
                    )
                    dst_sets[pi, i] = _kano_match(
                        c.labels, pol.dst_labels, cluster_keys, relation
                    )
                # matrix[src] |= dst_set for every selected src
                # (kano_py/kano/model.py:158-163)
                reach |= np.outer(src_sets[pi], dst_sets[pi])
                for i in range(n):
                    if src_sets[pi, i]:
                        containers[i].select_policies.append(pi)
                    if dst_sets[pi, i]:
                        containers[i].allow_policies.append(pi)

        BYTES_TRANSFERRED.labels(backend=self.name).set(0)  # pure host
        # analytic host estimate (no XLA program to analyse): P selector
        # sweeps over n containers plus P rank-1 outer products into [n,n]
        publish_host_estimate(
            self.name,
            "verify_kano",
            flops=len(policies) * n * (2 + n),
            bytes_accessed=len(policies) * n * n + 2 * len(policies) * n,
            output_bytes=reach.nbytes + src_sets.nbytes + dst_sets.nbytes,
            signature=(n, len(policies)),
        )
        return VerifyResult(
            n_pods=n,
            mode="kano",
            backend=self.name,
            config=config,
            reach=reach,
            src_sets=src_sets,
            dst_sets=dst_sets,
            closure=_transitive_closure(reach) if config.closure else None,
            timings=ph.timings,
        )

    # ------------------------------------------------------------------- k8s
    def verify(self, cluster: Cluster, config: VerifyConfig) -> VerifyResult:
        pods, policies, namespaces = cluster.pods, cluster.policies, cluster.namespaces
        n, P = len(pods), len(policies)
        ns_labels = {ns.name: ns.labels for ns in namespaces}
        ph = Phases()

        with ph("encode"):
            atoms = (
                compute_port_atoms(policies, pods)
                if config.compute_ports
                else [ALL_ATOM]
            )
        Q = len(atoms)

        def rule_dst_ports(rule: Rule) -> np.ndarray:
            """bool [N, Q]: which atoms this rule's ports cover *per
            destination pod* — numeric specs cover their atoms for every
            dst; a named spec covers, for dst d, exactly the atom holding
            the number d's container spec declares under that name (real
            k8s resolution; independent of the encoder's restriction-bank
            mechanism so the differential tests stay meaningful)."""
            pmask = rule_port_mask(rule, atoms)
            out = np.broadcast_to(pmask, (n, Q)).copy()
            for spec in rule.ports or ():
                if not isinstance(spec.port, str):
                    continue
                for d, pod in enumerate(pods):
                    entry = pod.container_ports.get(spec.port)
                    if entry is None or entry[0] != spec.protocol:
                        continue
                    num = int(entry[1])
                    for q, atom in enumerate(atoms):
                        if (
                            atom.name is None
                            and atom.protocol == spec.protocol
                            and atom.lo <= num <= atom.hi
                        ):
                            out[d, q] = True
            return out

        with ph("encode"):
            selected = np.zeros((P, n), dtype=bool)
            for pi, pol in enumerate(policies):
                for i, pod in enumerate(pods):
                    selected[pi, i] = (
                        pod.namespace == pol.namespace
                        and pol.pod_selector.matches(pod.labels)
                    )

        # Direction gating: with direction_aware_isolation=False (reference
        # compat, kubesv never consults policyTypes) every selecting policy
        # isolates AND its rules apply in both directions.
        with ph("compile"):
            affects_in = np.array(
                [
                    pol.affects_ingress if config.direction_aware_isolation else True
                    for pol in policies
                ],
                dtype=bool,
            )
            affects_eg = np.array(
                [
                    pol.affects_egress if config.direction_aware_isolation else True
                    for pol in policies
                ],
                dtype=bool,
            )
            ing_iso = np.zeros(n, dtype=bool)
            eg_iso = np.zeros(n, dtype=bool)
            for pi in range(P):
                if affects_in[pi]:
                    ing_iso |= selected[pi]
                if affects_eg[pi]:
                    eg_iso |= selected[pi]

        def peer_match(peer: Peer, pol: NetworkPolicy) -> np.ndarray:
            """bool[N]: pods this peer matches (see Peer docstring)."""
            out = np.zeros(n, dtype=bool)
            for i, pod in enumerate(pods):
                if peer.ip_block is not None:
                    out[i] = peer.ip_block.matches_ip(pod.ip)
                    continue
                if peer.namespace_selector is None:
                    ns_ok = pod.namespace == pol.namespace
                else:
                    ns_ok = peer.namespace_selector.matches(
                        ns_labels.get(pod.namespace, {})
                    )
                pod_ok = peer.pod_selector is None or peer.pod_selector.matches(
                    pod.labels
                )
                out[i] = ns_ok and pod_ok
            return out

        def rule_peer_set(rule: Rule, pol: NetworkPolicy) -> np.ndarray:
            if rule.matches_all_peers:
                return np.ones(n, dtype=bool)
            acc = np.zeros(n, dtype=bool)
            for peer in rule.peers:
                acc |= peer_match(peer, pol)
            return acc

        # Single pass over rules: compute each rule's peer set once and use it
        # both for the allow tensors and the per-policy src/dst edge sets.
        with ph("solve", backend=self.name):
            ingress_allow = np.zeros((n, n, Q), dtype=bool)
            egress_allow = np.zeros((n, n, Q), dtype=bool)
            src_sets = np.zeros((P, n), dtype=bool)
            dst_sets = np.zeros((P, n), dtype=bool)
            for pi, pol in enumerate(policies):
                tgt = selected[pi]
                if affects_in[pi] and pol.ingress:
                    for rule in pol.ingress:
                        srcs = rule_peer_set(rule, pol)
                        dmask = rule_dst_ports(rule)  # [N, Q], dst = selected
                        ingress_allow |= (
                            srcs[:, None, None] & (tgt[:, None] & dmask)[None, :, :]
                        )
                        src_sets[pi] |= srcs
                    dst_sets[pi] |= tgt
                if affects_eg[pi] and pol.egress:
                    for rule in pol.egress:
                        dsts = rule_peer_set(rule, pol)
                        dmask = rule_dst_ports(rule)  # [N, Q], dst = peers
                        egress_allow |= (
                            tgt[:, None, None] & (dsts[:, None] & dmask)[None, :, :]
                        )
                        dst_sets[pi] |= dsts
                    src_sets[pi] |= tgt

            # default-allow: pods unselected in a direction allow everything in
            # it iff the flag is on (real k8s True; reference's default False,
            # kubesv/kubesv/constraint.py:202-223).
            if config.default_allow_unselected:
                ingress_ok = ingress_allow | ~ing_iso[None, :, None]
                egress_ok = egress_allow | ~eg_iso[:, None, None]
            else:
                ingress_ok = ingress_allow
                egress_ok = egress_allow

            reach_pq = ingress_ok & egress_ok
            if config.self_traffic:
                di = np.arange(n)
                reach_pq[di, di, :] = True
            reach = reach_pq.any(axis=2)

        BYTES_TRANSFERRED.labels(backend=self.name).set(0)  # pure host
        # analytic host estimates, one per phase: selector/peer matching is
        # the "encode" side, rule ORs into the [n,n,Q] allow tensors (then
        # the 3-tensor combine) dominate the "solve" side
        n_rules = sum(
            (len(pol.ingress or ()) if affects_in[pi] else 0)
            + (len(pol.egress or ()) if affects_eg[pi] else 0)
            for pi, pol in enumerate(policies)
        )
        publish_host_estimate(
            self.name,
            "encode_selectors",
            flops=(P + n_rules) * n,
            bytes_accessed=2 * (P + n_rules) * n,
            output_bytes=selected.nbytes,
            signature=(n, P, Q),
        )
        publish_host_estimate(
            self.name,
            "solve_reach",
            flops=(n_rules + 3) * n * n * Q,
            bytes_accessed=2 * (n_rules + 3) * n * n * Q,
            argument_bytes=selected.nbytes,
            output_bytes=reach.nbytes + reach_pq.nbytes,
            temp_bytes=ingress_allow.nbytes + egress_allow.nbytes,
            signature=(n, P, Q),
        )
        return VerifyResult(
            n_pods=n,
            mode="k8s",
            backend=self.name,
            config=config,
            reach=reach,
            reach_ports=reach_pq if config.compute_ports else None,
            port_atoms=list(atoms) if config.compute_ports else [],
            src_sets=src_sets,
            dst_sets=dst_sets,
            selected=selected,
            ingress_isolated=ing_iso,
            egress_isolated=eg_iso,
            closure=_transitive_closure(reach) if config.closure else None,
            timings=ph.timings,
        )


def _transitive_closure(reach: np.ndarray) -> np.ndarray:
    """Boolean transitive closure by repeated squaring — the full-path
    generalisation of the reference's ≤2-hop ``path``
    (``kubesv/kubesv/constraint.py:233-237``)."""
    import math

    from ..observe.progress import ProgressTicker

    closure = reach.copy()
    bound = max(1, math.ceil(math.log2(max(closure.shape[0], 2))))
    with ProgressTicker("cpu_closure", total=bound, unit="pass") as ticker:
        while True:
            CLOSURE_ITERATIONS.inc()
            nxt = closure | (
                (closure.astype(np.int64) @ closure.astype(np.int64)) > 0
            )
            ticker.tick()
            if np.array_equal(nxt, closure):
                return closure
            closure = nxt


register_backend("cpu", CpuBackend)
