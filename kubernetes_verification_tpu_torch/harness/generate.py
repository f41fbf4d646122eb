"""Synthetic cluster generator — the scale/differential-test harness.

Grown from the reference's random config generator
(``kano_py/tests/generate.py:5-96``): pods get labels sampled from a pool, and
each policy's selectors copy labels from randomly chosen pods so selectors
actually match things (the reference's trick at ``tests/generate.py:62-66``).
Extended with what the reference left out or commented away: namespaces with
labels (``tests/generate.py:40-50`` is commented out there), matchExpressions
of all four operators, namespaceSelector peers, multi-peer/multi-rule
policies, egress sections, explicit policyTypes, port specs with endPort
ranges, and empty/absent rule edge cases — the full semantic surface.

Deterministic per seed: the PyTorch port's copy of
``kubernetes_verification_tpu.harness.generate`` (``random_cluster`` and
``random_kano``; not ``random_event_stream``), drawing the same
``random.Random`` sequence, so one seed gives the same scenario in both
packages.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..models.core import (
    Cluster,
    Container,
    Expr,
    IpBlock,
    KanoPolicy,
    Namespace,
    NetworkPolicy,
    Peer,
    Pod,
    PortSpec,
    Rule,
    Selector,
)

__all__ = [
    "GeneratorConfig",
    "random_kano",
    "random_cluster",
]

_KEYS = ["app", "role", "tier", "env", "team", "zone", "ver", "owner"]
_VALUES = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta",
           "iota", "kappa"]


@dataclass
class GeneratorConfig:
    """Knobs mirror the reference's ``ConfigFiles`` defaults
    (100 pods / 50 policies / 5 namespaces / ≤5 labels,
    ``kano_py/tests/generate.py:6``) and add the k8s-level feature rates."""

    n_pods: int = 100
    n_policies: int = 50
    n_namespaces: int = 5
    max_labels_per_pod: int = 5
    max_rules_per_policy: int = 2
    max_peers_per_rule: int = 2
    p_match_expressions: float = 0.3
    p_namespace_selector: float = 0.3
    p_ports: float = 0.4
    p_egress_section: float = 0.4
    p_absent_rules: float = 0.1
    p_empty_rule: float = 0.1
    p_explicit_policy_types: float = 0.2
    p_ipblock_peer: float = 0.05
    p_named_port: float = 0.05
    #: probability a pod declares container ports for the well-known names
    #: (named-port resolution needs dst pods that actually expose the name;
    #: numbers vary per pod so the same name resolves to different ports)
    p_container_ports: float = 0.3
    #: size of the cluster-wide port-spec library rules draw from. Real
    #: clusters reuse a small set of service ports (80/443/5432/...) rather
    #: than minting a fresh range per rule; a bounded library keeps the number
    #: of distinct port masks — and therefore the port-atom partition — at a
    #: realistic scale. 0 restores the unbounded per-rule random ranges.
    port_library_size: int = 12
    #: minimum matchLabels entries per random selector. The default 0 lets
    #: ~1/3 of selectors be empty (match-all) — fine for semantics fuzzing,
    #: degenerate for benchmarks (the reach matrix saturates); benchmarks use
    #: 1 so selectors actually discriminate.
    min_selector_labels: int = 0
    seed: int = 0


def _rand_labels(rng: random.Random, max_labels: int) -> dict:
    n = rng.randint(1, max(1, max_labels))
    keys = rng.sample(_KEYS, min(n, len(_KEYS)))
    return {k: rng.choice(_VALUES) for k in keys}


def random_kano(
    n_containers: int = 100, n_policies: int = 50, seed: int = 0,
    max_labels: int = 5,
) -> Tuple[List[Container], List[KanoPolicy]]:
    """Random kano-level scenario: select/allow label dicts copied from two
    random containers' labels (subset), as the reference generator does."""
    rng = random.Random(seed)
    containers = [
        Container(f"c{i}", _rand_labels(rng, max_labels))
        for i in range(n_containers)
    ]
    policies = []
    for i in range(n_policies):
        sel_src = rng.choice(containers).labels
        alw_src = rng.choice(containers).labels
        select = dict(rng.sample(sorted(sel_src.items()),
                                 rng.randint(1, len(sel_src))))
        allow = dict(rng.sample(sorted(alw_src.items()),
                                rng.randint(1, len(alw_src))))
        policies.append(
            KanoPolicy(f"p{i}", select=select, allow=allow,
                       ingress=rng.random() < 0.7)
        )
    return containers, policies


def _rand_selector(rng: random.Random, pool: List[dict], cfg: GeneratorConfig) -> Selector:
    src = rng.choice(pool)
    items = sorted(src.items())
    lo = min(cfg.min_selector_labels, len(items))
    hi = max(lo, min(2, len(items)))
    match_labels = dict(rng.sample(items, rng.randint(lo, hi)))
    exprs: List[Expr] = []
    if rng.random() < cfg.p_match_expressions:
        op = rng.choice(["In", "NotIn", "Exists", "DoesNotExist"])
        key = rng.choice(_KEYS)
        if op in ("In", "NotIn"):
            exprs.append(Expr(key, op, tuple(rng.sample(_VALUES, rng.randint(1, 3)))))
        else:
            exprs.append(Expr(key, op))
    return Selector(match_labels=match_labels, match_expressions=tuple(exprs))


_PORT_NAMES = ["http", "metrics", "grpc"]


def _port_library(rng: random.Random, size: int) -> List[PortSpec]:
    """Deterministic cluster-wide pool of (protocol, port[, endPort]) specs.

    Seeded with the common service ports; beyond those, adds random single
    ports and a few ranges. Every rule's port list samples from this pool, so
    the number of distinct port masks across the cluster stays bounded by the
    library size — matching how real clusters reuse standard ports."""
    base = [
        PortSpec("TCP", 80),
        PortSpec("TCP", 443),
        PortSpec("TCP", 5432),
        PortSpec("TCP", 6379),
        PortSpec("TCP", 8080),
        PortSpec("UDP", 53),
        PortSpec("TCP", 8000, end_port=8999),  # app range
        PortSpec("TCP", 30000, end_port=32767),  # nodeport range
    ]
    lib = base[: max(1, size)]
    while len(lib) < size:
        port = rng.randint(1024, 40000)
        if rng.random() < 0.25:
            lib.append(
                PortSpec("TCP", port, end_port=port + rng.randint(10, 500))
            )
        else:
            lib.append(PortSpec(rng.choice(["TCP", "UDP"]), port))
    return lib


def _rand_ports(
    rng: random.Random,
    p_named: float = 0.0,
    library: Optional[List[PortSpec]] = None,
) -> Optional[Tuple[PortSpec, ...]]:
    specs = []
    for _ in range(rng.randint(1, 2)):
        if rng.random() < p_named:
            proto = rng.choice(["TCP", "TCP", "UDP"])
            specs.append(PortSpec(proto, rng.choice(_PORT_NAMES)))
            continue
        if library is not None:
            specs.append(rng.choice(library))
            continue
        proto = rng.choice(["TCP", "TCP", "UDP"])
        port = rng.choice([80, 443, 5432, 6379, 8080, 9000])
        if rng.random() < 0.3:
            specs.append(PortSpec(proto, port, end_port=port + rng.randint(1, 200)))
        else:
            specs.append(PortSpec(proto, port))
    return tuple(specs)


def random_cluster(cfg: Optional[GeneratorConfig] = None, **kw) -> Cluster:
    cfg = cfg or GeneratorConfig(**kw)
    rng = random.Random(cfg.seed)

    namespaces = [
        Namespace(f"ns{i}", _rand_labels(rng, 2)) for i in range(cfg.n_namespaces)
    ]
    def _rand_container_ports(i: int):
        if rng.random() >= cfg.p_container_ports:
            return {}
        # a few canonical numbers per name so resolution diverges across pods
        choices = {
            "http": [8080, 8081, 9090, 80],
            "metrics": [9100, 9101, 2112],
            "grpc": [50051, 50052],
        }
        return {
            name: ("TCP", rng.choice(nums))
            for name, nums in choices.items()
            if rng.random() < 0.6
        }

    pods = [
        Pod(
            f"pod{i}",
            rng.choice(namespaces).name,
            _rand_labels(rng, cfg.max_labels_per_pod),
            ip=f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}",
            container_ports=_rand_container_ports(i),
        )
        for i in range(cfg.n_pods)
    ]
    label_pool = [p.labels for p in pods]
    ns_pool = [ns.labels for ns in namespaces]
    port_lib = (
        _port_library(rng, cfg.port_library_size)
        if cfg.port_library_size > 0
        else None
    )

    def rand_rule() -> Rule:
        if rng.random() < cfg.p_empty_rule:
            return Rule()  # allow-all rule
        peers = []
        for _ in range(rng.randint(1, cfg.max_peers_per_rule)):
            if rng.random() < cfg.p_ipblock_peer:
                base = rng.randrange(cfg.n_pods or 1)
                cidr = f"10.{(base >> 16) & 255}.{(base >> 8) & 255}.0/24"
                excepts = (
                    (f"10.{(base >> 16) & 255}.{(base >> 8) & 255}.{base & 255}/32",)
                    if rng.random() < 0.5
                    else ()
                )
                peers.append(Peer(ip_block=IpBlock(cidr, excepts)))
                continue
            use_ns = rng.random() < cfg.p_namespace_selector
            use_pod = rng.random() < 0.8 or not use_ns
            peers.append(
                Peer(
                    pod_selector=_rand_selector(rng, label_pool, cfg) if use_pod else None,
                    namespace_selector=_rand_selector(rng, ns_pool, cfg) if use_ns else None,
                )
            )
        ports = (
            _rand_ports(rng, cfg.p_named_port, port_lib)
            if rng.random() < cfg.p_ports
            else None
        )
        return Rule(peers=tuple(peers), ports=ports)

    policies = []
    for i in range(cfg.n_policies):
        ns = rng.choice(namespaces).name
        ingress: Optional[Tuple[Rule, ...]]
        if rng.random() < cfg.p_absent_rules:
            ingress = rng.choice([None, ()])
        else:
            ingress = tuple(rand_rule() for _ in range(rng.randint(1, cfg.max_rules_per_policy)))
        egress = None
        if rng.random() < cfg.p_egress_section:
            if rng.random() < cfg.p_absent_rules:
                egress = ()  # explicit empty section: egress-isolate
            else:
                egress = tuple(
                    rand_rule() for _ in range(rng.randint(1, cfg.max_rules_per_policy))
                )
        policy_types = None
        if rng.random() < cfg.p_explicit_policy_types:
            policy_types = rng.choice([("Ingress",), ("Egress",), ("Ingress", "Egress")])
        policies.append(
            NetworkPolicy(
                name=f"pol{i}",
                namespace=ns,
                pod_selector=_rand_selector(rng, label_pool, cfg),
                policy_types=policy_types,
                ingress=ingress,
                egress=egress,
            )
        )
    return Cluster(pods=pods, namespaces=namespaces, policies=policies)
