"""NetworkPolicy semantics as a Datalog program + the ``datalog`` backend.

This is the faithful re-creation of the reference's Datalog encoding
(``kubesv/kubesv/constraint.py:136-298`` and the rule emission in
``kubesv/kubesv/model.py:178-554``, templated by ``kubesv/spec.pl``), running
on the dense-tensor engine in :mod:`.engine` instead of z3:

* label facts → ``has_pair``/``has_key`` relations over an interned vocab
  (the dynamic per-key relations of ``define_pod_facts``,
  ``constraint.py:242-275``, collapsed into two indexed relations);
* each policy emits ``selected(pod, i) :- pod_ns(pod, c) ∧ <selector atoms>``
  (``define_pod_selector``, ``model.py:499-520``) and per-(rule, peer)
  OR-branches into ``ing_allow``/``eg_allow`` (``define_peer_rule``,
  ``model.py:350-363``) — In-expressions synthesize helper relations exactly
  like the reference (``model.py:211-226``);
* the core program — ``selected_by_any``/``selected_by_none`` (negation as
  failure), ``ingress_traffic``/``egress_traffic`` with the flag-gated
  default-allow and self-traffic variants, and ``edge`` — mirrors
  ``define_model`` (``constraint.py:136-239``);
* ``path`` is the TRUE transitive closure via the non-linear doubling rule
  ``path(s,d) :- path(s,x), path(x,d)`` (⌈log₂N⌉ sweeps), generalising the
  reference's ≤2-hop ``path`` (``constraint.py:233-237``).

Differences from the reference, by design: policyTypes are honored
(``direction_aware_isolation``; the reference's ``policy_types`` is dead
code), ipBlock peers match pods by IP (host-side fact emission; the reference
parses and ignores them), and ports are enforced (the reference drops them via
a missing ``return``): the allow/traffic/edge relations carry a port-atom
argument over the same equivalence classes the tensor backends use
(``encode/ports.py``), so ``reach``/``reach_ports`` match them bit-for-bit
under every ``compute_ports`` setting.

This backend is the *semantics oracle at Datalog granularity* — use the
tensor backends for scale.

The port of ``kubernetes_verification_tpu.datalog.k8s_program``: the same
program, rule for rule. The backend is an entry point, so it evaluates the
rules with PyTorch on the card by default (``use_torch=True`` on
``cuda``); the backend option ``("device", "cpu")`` runs the torch rules on
the CPU and ``("use_torch", False)`` the JAX package's NumPy host default.
The phase timers (``observe.Phases``), the host cost estimates and the
transfer metric are the JAX package's; on the card the metric counts the
relations fetched back to the host.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..backends.base import (
    VerifierBackend,
    VerifyConfig,
    VerifyResult,
    register_backend,
)
from ..encode.vocab import Vocab
from ..models.core import Cluster, Container, KanoPolicy, Selector
from ..observe import Phases
from ..observe.introspect import publish_host_estimate as _publish_host_estimate
from ..observe.metrics import BYTES_TRANSFERRED
from .engine import Atom, Program, Solution, solve

__all__ = ["build_k8s_program", "build_kano_program", "DatalogBackend"]


class _SelectorCompiler:
    """Compile a ``LabelSelector`` into body atoms over the label relations —
    the tensor-engine form of ``define_label_selector``
    (``kubesv/kubesv/model.py:178-243``)."""

    def __init__(self, prog: Program, vocab: Vocab, entity_dom, suffix: str):
        self.prog = prog
        self.vocab = vocab
        self.dom = entity_dom
        self.suffix = suffix  # "" for pods, "_ns" for namespaces
        self._helper_count = 0

    def compile(self, sel: Optional[Selector], var: str) -> Optional[List[Atom]]:
        """Atoms requiring ``var`` to match ``sel``; None ⇒ the selector can
        match nothing in this cluster (a required pair/key is absent — the
        reference's "quick fail", ``model.py:201-203``)."""
        if sel is None:
            return []  # null selector handled by the caller (scope rules)
        atoms: List[Atom] = []
        has_pair = f"has_pair{self.suffix}"
        has_key = f"has_key{self.suffix}"
        for k, v in sorted(sel.match_labels.items()):
            pid = self.vocab.pair(k, v)
            if pid is None:
                return None
            atoms.append(Atom(has_pair, (var, pid)))
        for e in sel.match_expressions:
            if e.op == "Exists":
                kid = self.vocab.key(e.key)
                if kid is None:
                    return None
                atoms.append(Atom(has_key, (var, kid)))
            elif e.op == "DoesNotExist":
                kid = self.vocab.key(e.key)
                if kid is not None:
                    atoms.append(Atom(has_key, (var, kid), negated=True))
            elif e.op == "NotIn":
                for v in e.values:
                    pid = self.vocab.pair(e.key, v)
                    if pid is not None:
                        atoms.append(Atom(has_pair, (var, pid), negated=True))
            else:  # In → helper relation with one rule per known value
                pids = [self.vocab.pair(e.key, v) for v in e.values]
                pids = [p for p in pids if p is not None]
                if not pids:
                    return None
                name = f"in_{self._helper_count}{self.suffix}"
                self._helper_count += 1
                self.prog.relation(name, self.dom)
                for pid in pids:
                    self.prog.rule(
                        Atom(name, ("x",)), Atom(has_pair, ("x", pid))
                    )
                atoms.append(Atom(name, (var,)))
        return atoms


def build_k8s_program(
    cluster: Cluster, config: VerifyConfig
) -> Tuple[Program, Vocab, list]:
    """Emit the full program for a cluster under the semantic flags."""
    prog = Program()
    pods, namespaces, policies = cluster.pods, cluster.namespaces, cluster.policies
    N, M, P = len(pods), len(namespaces), len(policies)
    vocab = Vocab.build(
        [p.labels for p in pods] + [ns.labels for ns in namespaces]
    )
    ns_index = cluster.namespace_index()

    from ..encode.ports import (
        ALL_ATOM,
        compute_port_atoms,
        named_resolution,
        rule_named_specs,
        rule_port_mask,
    )

    if config.compute_ports:
        atoms = compute_port_atoms(policies, pods)
        resolution = named_resolution(policies, atoms, pods)
    else:
        atoms = [ALL_ATOM]
        resolution = {}
    Q = len(atoms)

    pod_d = prog.domain("pod", N)
    ns_d = prog.domain("ns", M)
    pol_d = prog.domain("pol", max(P, 1))
    pair_d = prog.domain("pair", max(vocab.n_pairs, 1))
    key_d = prog.domain("key", max(vocab.n_keys, 1))
    q_d = prog.domain("q", Q)  # port atoms (encode/ports.py)

    # --- base facts (define_pod_facts, constraint.py:242-275) -------------
    prog.relation("is_pod", pod_d)
    prog.relation("pod_ns", pod_d, ns_d)
    prog.relation("has_pair", pod_d, pair_d)
    prog.relation("has_key", pod_d, key_d)
    prog.relation("has_pair_ns", ns_d, pair_d)
    prog.relation("has_key_ns", ns_d, key_d)
    pod_kv, pod_key = vocab.encode_label_matrix(p.labels for p in pods)
    ns_kv, ns_key = vocab.encode_label_matrix(ns.labels for ns in namespaces)
    prog.fact_array("is_pod", np.ones(N, dtype=bool))
    pn = np.zeros((N, M), dtype=bool)
    for i, p in enumerate(pods):
        pn[i, ns_index[p.namespace]] = True
    prog.fact_array("pod_ns", pn)
    prog.fact_array("has_pair", _pad_cols(pod_kv, pair_d.size))
    prog.fact_array("has_key", _pad_cols(pod_key, key_d.size))
    prog.fact_array("has_pair_ns", _pad_cols(ns_kv, pair_d.size))
    prog.fact_array("has_key_ns", _pad_cols(ns_key, key_d.size))

    # --- derived relations ------------------------------------------------
    for rel in ("selected", "sel_ing", "sel_eg"):
        prog.relation(rel, pod_d, pol_d)
    # allow relations carry the port atom — the dimension the reference
    # parsed but dropped (kubesv/kubesv/model.py:365-385, missing return)
    prog.relation("ing_allow", pod_d, pol_d, q_d)
    prog.relation("eg_allow", pod_d, pol_d, q_d)
    for rel in ("sel_any_ing", "sel_any_eg", "sel_none_ing", "sel_none_eg"):
        prog.relation(rel, pod_d)
    prog.relation("is_q", q_d)
    prog.fact_array("is_q", np.ones(Q, dtype=bool))
    prog.relation("ingress_traffic", pod_d, pod_d, q_d)
    prog.relation("egress_traffic", pod_d, pod_d, q_d)
    prog.relation("edge_q", pod_d, pod_d, q_d)
    prog.relation("edge", pod_d, pod_d)
    prog.relation("path", pod_d, pod_d)

    pod_c = _SelectorCompiler(prog, vocab, pod_d, "")
    ns_c = _SelectorCompiler(prog, vocab, ns_d, "_ns")

    # --- per-policy emission (define_pol_facts, constraint.py:278-282) ----
    for i, pol in enumerate(policies):
        c_ns = ns_index[pol.namespace]
        sel_atoms = pod_c.compile(pol.pod_selector, "x")
        if sel_atoms is not None:
            prog.rule(
                Atom("selected", ("x", i)),
                Atom("pod_ns", ("x", c_ns)),
                *sel_atoms,
            )
        affects_in = pol.affects_ingress if config.direction_aware_isolation else True
        affects_eg = pol.affects_egress if config.direction_aware_isolation else True
        if affects_in:
            prog.rule(Atom("sel_ing", ("x", i)), Atom("selected", ("x", i)))
        if affects_eg:
            prog.rule(Atom("sel_eg", ("x", i)), Atom("selected", ("x", i)))

        def emit_peers(rules, head_rel, direction):
            # named-port resolution couples (dst, atom): each (name, atom)
            # variant emits a DIRECT *_traffic rule with a constant atom and
            # a per-dst restriction relation — the Datalog form of the
            # encoder's GrantBlock.dst_restrict bank. Static (numeric) port
            # coverage keeps the per-rule ports relation below.
            traffic_rel = (
                "ingress_traffic" if direction == "in" else "egress_traffic"
            )
            sel_rel = "sel_ing" if direction == "in" else "sel_eg"
            peer_var = "s" if direction == "in" else "d"
            # named restrictions gate the edge's DESTINATION: the selected
            # pod for ingress ("x"), the peer for egress (peer_var "d")
            restrict_var = "x" if direction == "in" else peer_var

            def named_variants(rule, ridx):
                out = []
                for k, (proto, name) in enumerate(rule_named_specs(rule)):
                    res = resolution.get((proto, name))
                    if res is None:
                        continue
                    for q in np.nonzero(res.any(axis=0))[0]:
                        rel = f"named_{direction}_{i}_{ridx}_{k}_{int(q)}"
                        prog.relation(rel, pod_d)
                        prog.fact_array(rel, res[:, q])
                        out.append((int(q), rel))
                return out

            def emit_named(variants, src_body):
                for q, restrict_rel in variants:
                    prog.rule(
                        Atom(traffic_rel, (peer_var, "x", q)),
                        Atom(sel_rel, ("x", i)),
                        Atom(restrict_rel, (restrict_var,)),
                        *src_body,
                    )

            ip_rows = np.zeros((N, Q), dtype=bool)
            any_ip = False
            for ridx, rule in enumerate(rules or ()):
                # ignores port specs when atoms == [ALL_ATOM] (ports off)
                pmask = rule_port_mask(rule, atoms)
                variants = named_variants(rule, ridx)
                # per-rule port relation: one fact per covered atom
                ports_rel = f"ports_{direction}_{i}_{ridx}"
                prog.relation(ports_rel, q_d)
                prog.fact_array(ports_rel, pmask)
                if rule.matches_all_peers:
                    prog.rule(
                        Atom(head_rel, ("s", i, "q")),
                        Atom("is_pod", ("s",)),
                        Atom(ports_rel, ("q",)),
                    )
                    emit_named(variants, [Atom("is_pod", (peer_var,))])
                    continue
                for pidx, peer in enumerate(rule.peers):
                    if peer.ip_block is not None:
                        any_ip = True
                        ip_hits = np.array(
                            [peer.ip_block.matches_ip(p.ip) for p in pods],
                            dtype=bool,
                        )
                        ip_rows |= ip_hits[:, None] & pmask[None, :]
                        if variants:
                            ip_rel = f"ipsrc_{direction}_{i}_{ridx}_{pidx}"
                            prog.relation(ip_rel, pod_d)
                            prog.fact_array(ip_rel, ip_hits)
                            emit_named(variants, [Atom(ip_rel, (peer_var,))])
                        continue
                    p_atoms = pod_c.compile(peer.pod_selector, peer_var)
                    if p_atoms is None:
                        continue
                    if peer.namespace_selector is None:
                        scope = [Atom("pod_ns", (peer_var, c_ns))]
                    else:
                        n_atoms = ns_c.compile(peer.namespace_selector, "n")
                        if n_atoms is None:
                            continue
                        scope = [Atom("pod_ns", (peer_var, "n")), *n_atoms]
                    prog.rule(
                        Atom(head_rel, (peer_var, i, "q")),
                        *scope,
                        *p_atoms,
                        Atom(ports_rel, ("q",)),
                    )
                    emit_named(variants, [*scope, *p_atoms])
            if any_ip:
                arr = np.zeros((N, pol_d.size, Q), dtype=bool)
                arr[:, i, :] = ip_rows
                prog.fact_array(head_rel, arr)

        if affects_in:
            emit_peers(pol.ingress, "ing_allow", "in")
        if affects_eg:
            emit_peers(pol.egress, "eg_allow", "eg")

    # --- core program (define_model, constraint.py:136-239) ---------------
    prog.rule(Atom("sel_any_ing", ("x",)), Atom("sel_ing", ("x", "p")))
    prog.rule(Atom("sel_any_eg", ("x",)), Atom("sel_eg", ("x", "p")))
    prog.rule(
        Atom("sel_none_ing", ("x",)),
        Atom("is_pod", ("x",)),
        Atom("sel_any_ing", ("x",), negated=True),
    )
    prog.rule(
        Atom("sel_none_eg", ("x",)),
        Atom("is_pod", ("x",)),
        Atom("sel_any_eg", ("x",), negated=True),
    )
    # ingress_traffic(src, sel, q): sel may receive from src on atom q
    # (constraint.py:195-207, with the port dimension the reference lost)
    prog.rule(
        Atom("ingress_traffic", ("s", "x", "q")),
        Atom("sel_ing", ("x", "p")),
        Atom("ing_allow", ("s", "p", "q")),
    )
    # egress_traffic(dst, sel, q): sel may send to dst (constraint.py:209-223)
    prog.rule(
        Atom("egress_traffic", ("d", "x", "q")),
        Atom("sel_eg", ("x", "p")),
        Atom("eg_allow", ("d", "p", "q")),
    )
    if config.default_allow_unselected:
        prog.rule(
            Atom("ingress_traffic", ("s", "x", "q")),
            Atom("sel_none_ing", ("x",)),
            Atom("is_pod", ("s",)),
            Atom("is_q", ("q",)),
        )
        prog.rule(
            Atom("egress_traffic", ("d", "x", "q")),
            Atom("sel_none_eg", ("x",)),
            Atom("is_pod", ("d",)),
            Atom("is_q", ("q",)),
        )
    # traffic flows on a port atom only if BOTH directions allow that atom
    prog.rule(
        Atom("edge_q", ("s", "d", "q")),
        Atom("ingress_traffic", ("s", "d", "q")),
        Atom("egress_traffic", ("d", "s", "q")),
    )
    if config.self_traffic:
        prog.rule(
            Atom("edge_q", ("x", "x", "q")),
            Atom("is_pod", ("x",)),
            Atom("is_q", ("q",)),
        )
    prog.rule(Atom("edge", ("s", "d")), Atom("edge_q", ("s", "d", "q")))
    prog.rule(Atom("path", ("s", "d")), Atom("edge", ("s", "d")))
    prog.rule(
        Atom("path", ("s", "d")),
        Atom("path", ("s", "x")),
        Atom("path", ("x", "d")),
    )
    return prog, vocab, atoms


def build_kano_program(
    containers: Sequence[Container], policies: Sequence[KanoPolicy]
) -> Tuple[Program, Vocab]:
    """The kano bit-vector semantics (``kano_py/kano/model.py:124-165``) as a
    Datalog program, including the cluster-key matcher quirk."""
    prog = Program()
    vocab = Vocab.build(c.labels for c in containers)
    N, P = len(containers), len(policies)
    pod_d = prog.domain("pod", N)
    pol_d = prog.domain("pol", max(P, 1))
    pair_d = prog.domain("pair", max(vocab.n_pairs, 1))
    prog.relation("is_pod", pod_d)
    prog.relation("has_pair", pod_d, pair_d)
    prog.relation("src_set", pod_d, pol_d)
    prog.relation("dst_set", pod_d, pol_d)
    prog.relation("reach", pod_d, pod_d)
    pod_kv, _ = vocab.encode_label_matrix(c.labels for c in containers)
    prog.fact_array("is_pod", np.ones(N, dtype=bool))
    prog.fact_array("has_pair", _pad_cols(pod_kv, pair_d.size))

    for i, pol in enumerate(policies):
        for labels, head in ((pol.src_labels, "src_set"), (pol.dst_labels, "dst_set")):
            atoms: Optional[List[Atom]] = [Atom("is_pod", ("x",))]
            for k, v in sorted(labels.items()):
                if vocab.key(k) is None:
                    continue  # key unknown to the cluster: ignored (quirk)
                pid = vocab.pair(k, v)
                if pid is None:
                    atoms = None  # known key, unseen value: matches nothing
                    break
                atoms.append(Atom("has_pair", ("x", pid)))
            if atoms is not None:
                prog.rule(Atom(head, ("x", i)), *atoms)
    prog.rule(
        Atom("reach", ("s", "d")),
        Atom("src_set", ("s", "p")),
        Atom("dst_set", ("d", "p")),
    )
    return prog, vocab


def _pad_cols(a: np.ndarray, width: int) -> np.ndarray:
    if a.shape[1] == width:
        return a
    return np.pad(a, ((0, 0), (0, width - a.shape[1])), constant_values=False)


def _solve(prog: Program, config: VerifyConfig):
    return solve(
        prog,
        use_torch=bool(config.opt("use_torch", True)),
        device=config.opt("device"),
    )


def _fetched_bytes(sol: Solution, config: VerifyConfig) -> int:
    """Bytes of the relations fetched from the card (0 on the host)."""
    on_card = bool(config.opt("use_torch", True)) and str(
        config.opt("device") or "cuda"
    ).startswith("cuda")
    return sum(int(v.nbytes) for v in sol.relations.values()) if on_card else 0


class DatalogBackend(VerifierBackend):
    """``backend="datalog"``: solve via the dense Datalog engine.

    ``backend_options``: ``use_torch`` (default True) evaluates the rules
    with PyTorch on ``device`` (default ``"cuda"``, ``BackendError`` without
    a GPU); ``("use_torch", False)`` evaluates them with NumPy on the host.
    ``reach`` is identical to the tensor backends'.
    """

    name = "datalog"

    def verify(self, cluster: Cluster, config: VerifyConfig) -> VerifyResult:
        ph = Phases()
        with ph("encode"):
            prog, _, atoms = build_k8s_program(cluster, config)
        with ph("solve", backend=self.name):
            sol = _solve(prog, config)
        BYTES_TRANSFERRED.labels(backend=self.name).set(_fetched_bytes(sol, config))

        N, P = cluster.n_pods, len(cluster.policies)
        selected = sol["selected"][:, :P].T  # [P, N]
        sel_ing = sol["sel_ing"][:, :P].T
        sel_eg = sol["sel_eg"][:, :P].T
        # allow relations are (pod, pol, q); the per-policy edge sets use the
        # any-port projection (every port spec covers >= 1 atom, so this
        # equals the kernels' peer-based sets)
        ing_allow = sol["ing_allow"][:, :P].any(axis=2).T
        eg_allow = sol["eg_allow"][:, :P].any(axis=2).T
        has_ing = np.array([bool(p.ingress) for p in cluster.policies], dtype=bool)
        has_eg = np.array([bool(p.egress) for p in cluster.policies], dtype=bool)
        src_sets = ing_allow | (sel_eg & has_eg[:, None])
        dst_sets = eg_allow | (sel_ing & has_ing[:, None])
        # analytic host estimate: semi-naive evaluation touches each dense
        # relation tensor once per stratum; the [N, N, Q] allow/edge
        # relations dominate
        n_q = (
            sol["edge_q"].shape[2] if "edge_q" in sol.relations else 1
        )
        _publish_host_estimate(
            self.name,
            "solve_datalog",
            flops=3 * N * N * n_q + 2 * P * N,
            bytes_accessed=2 * (3 * N * N * n_q + 2 * P * N),
            output_bytes=sol["edge"].nbytes,
            signature=(N, P, n_q),
        )
        return VerifyResult(
            n_pods=N,
            mode="k8s",
            backend=self.name,
            config=config,
            reach=sol["edge"],
            reach_ports=sol["edge_q"] if config.compute_ports else None,
            port_atoms=list(atoms) if config.compute_ports else [],
            src_sets=src_sets,
            dst_sets=dst_sets,
            selected=selected,
            ingress_isolated=sel_ing.any(axis=0),
            egress_isolated=sel_eg.any(axis=0),
            closure=sol["path"] if config.closure else None,
            timings=ph.timings,
        )

    def verify_kano(
        self,
        containers: Sequence[Container],
        policies: Sequence[KanoPolicy],
        config: VerifyConfig,
    ) -> VerifyResult:
        ph = Phases()
        with ph("encode"):
            prog, _ = build_kano_program(containers, policies)
        with ph("solve", backend=self.name):
            sol = _solve(prog, config)
        BYTES_TRANSFERRED.labels(backend=self.name).set(_fetched_bytes(sol, config))
        P = len(policies)
        src_sets = sol["src_set"][:, :P].T
        dst_sets = sol["dst_set"][:, :P].T
        for i, c in enumerate(containers):
            c.select_policies.clear()
            c.allow_policies.clear()
            c.select_policies.extend(np.nonzero(src_sets[:, i])[0].tolist())
            c.allow_policies.extend(np.nonzero(dst_sets[:, i])[0].tolist())
        reach = sol["reach"]
        closure = None
        if config.closure:
            from ..backends.cpu import _transitive_closure

            closure = _transitive_closure(reach)
        n = len(containers)
        _publish_host_estimate(
            self.name,
            "solve_datalog_kano",
            flops=P * n * (2 + n),
            bytes_accessed=2 * P * n * n,
            output_bytes=reach.nbytes,
            signature=(n, P),
        )
        return VerifyResult(
            n_pods=len(containers),
            mode="kano",
            backend=self.name,
            config=config,
            reach=reach,
            src_sets=src_sets,
            dst_sets=dst_sets,
            closure=closure,
            timings=ph.timings,
        )


register_backend("datalog", DatalogBackend)
