"""The benchmark's frozen traffic generator: clusters, verify edits and churn.

A copy of the port's ``harness/generate.py`` (``random_cluster`` and the
helpers of ``random_event_stream``) that draws the same ``random.Random``
sequence but builds plain dicts, the inputs that ``adapter.py`` turns into the
port's model objects and ``reference.py`` reads as they are. Kept here so a
change to the program's generator cannot change what the benchmark offers.
Its knobs follow the reference generator (``kano_py/tests/generate.py:6`` of
qiyueyao/Kubernetes-verification).

A configuration may fix the port library (``port_library``), which the
seed otherwise draws, so that every seed verifies the same set of port
masks. Departures from ``random_event_stream``, all in ``churn_changes``:

* the kinds come from a fixed schedule, shuffled per block by the seed, so
  every seed offers the same mix of work in another order;
* with the mix's ``policy_ports`` the added and updated policies name ports
  from the deployment's library as its own policies do (never a named
  port), so that churn keeps the port layout's shape;
* there are no namespace relabels and no namespace removals: a relabel of a
  namespace that holds pods takes minutes on the engines, and one of a
  namespace that holds none changes no verdict.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional

KEYS = ["app", "role", "tier", "env", "team", "zone", "ver", "owner"]
VALUES = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta",
          "iota", "kappa"]
PORT_NAMES = ["http", "metrics", "grpc"]

#: the generator knobs and their defaults (``GeneratorConfig``)
DEFAULTS = dict(
    n_pods=100,
    n_policies=50,
    n_namespaces=5,
    max_labels_per_pod=5,
    max_rules_per_policy=2,
    max_peers_per_rule=2,
    p_match_expressions=0.3,
    p_namespace_selector=0.3,
    p_ports=0.4,
    p_egress_section=0.4,
    p_absent_rules=0.1,
    p_empty_rule=0.1,
    p_explicit_policy_types=0.2,
    p_ipblock_peer=0.05,
    p_named_port=0.05,
    p_container_ports=0.3,
    port_library_size=12,
    #: the library itself, as port dicts; None draws it from the seed
    port_library=None,
    min_selector_labels=0,
)


def knobs(deployment: Dict) -> Dict:
    """The defaults overridden by a configuration's ``deployment``."""
    unknown = set(deployment) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown generator knobs: {sorted(unknown)}")
    return {**DEFAULTS, **deployment}


def rand_labels(rng: random.Random, max_labels: int) -> Dict[str, str]:
    n = rng.randint(1, max(1, max_labels))
    keys = rng.sample(KEYS, min(n, len(KEYS)))
    return {k: rng.choice(VALUES) for k in keys}


def _rand_selector(rng: random.Random, pool: List[dict], cfg: Dict) -> Dict:
    src = rng.choice(pool)
    items = sorted(src.items())
    lo = min(cfg["min_selector_labels"], len(items))
    hi = max(lo, min(2, len(items)))
    match_labels = dict(rng.sample(items, rng.randint(lo, hi)))
    exprs = []
    if rng.random() < cfg["p_match_expressions"]:
        op = rng.choice(["In", "NotIn", "Exists", "DoesNotExist"])
        key = rng.choice(KEYS)
        if op in ("In", "NotIn"):
            exprs.append({"key": key, "op": op,
                          "values": list(rng.sample(VALUES, rng.randint(1, 3)))})
        else:
            exprs.append({"key": key, "op": op, "values": []})
    return {"match_labels": match_labels, "match_expressions": exprs}


def _port(protocol: str, port=None, end_port: Optional[int] = None) -> Dict:
    return {"protocol": protocol, "port": port, "end_port": end_port}


def _port_library(rng: random.Random, size: int) -> List[Dict]:
    base = [
        _port("TCP", 80), _port("TCP", 443), _port("TCP", 5432),
        _port("TCP", 6379), _port("TCP", 8080), _port("UDP", 53),
        _port("TCP", 8000, 8999), _port("TCP", 30000, 32767),
    ]
    lib = base[: max(1, size)]
    while len(lib) < size:
        port = rng.randint(1024, 40000)
        if rng.random() < 0.25:
            lib.append(_port("TCP", port, port + rng.randint(10, 500)))
        else:
            lib.append(_port(rng.choice(["TCP", "UDP"]), port))
    return lib


def _rand_ports(rng: random.Random, p_named: float, library) -> List[Dict]:
    specs = []
    for _ in range(rng.randint(1, 2)):
        if rng.random() < p_named:
            proto = rng.choice(["TCP", "TCP", "UDP"])
            specs.append(_port(proto, rng.choice(PORT_NAMES)))
            continue
        if library is not None:
            specs.append(dict(rng.choice(library)))
            continue
        proto = rng.choice(["TCP", "TCP", "UDP"])
        port = rng.choice([80, 443, 5432, 6379, 8080, 9000])
        if rng.random() < 0.3:
            specs.append(_port(proto, port, port + rng.randint(1, 200)))
        else:
            specs.append(_port(proto, port))
    return specs


def random_cluster(deployment: Dict, seed: int) -> Dict:
    """``{"pods", "namespaces", "policies"}`` as plain dicts: the same
    scenario ``harness/generate.py::random_cluster`` builds for these knobs
    and seed."""
    cfg = knobs(deployment)
    rng = random.Random(seed)
    namespaces = [
        {"name": f"ns{i}", "labels": rand_labels(rng, 2)}
        for i in range(cfg["n_namespaces"])
    ]

    def container_ports() -> Dict:
        if rng.random() >= cfg["p_container_ports"]:
            return {}
        choices = {
            "http": [8080, 8081, 9090, 80],
            "metrics": [9100, 9101, 2112],
            "grpc": [50051, 50052],
        }
        return {
            name: ["TCP", rng.choice(nums)]
            for name, nums in choices.items()
            if rng.random() < 0.6
        }

    pods = []
    for i in range(cfg["n_pods"]):
        ns = rng.choice(namespaces)["name"]
        labels = rand_labels(rng, cfg["max_labels_per_pod"])
        pods.append({
            "name": f"pod{i}", "namespace": ns, "labels": labels,
            "ip": f"10.{(i >> 16) & 255}.{(i >> 8) & 255}.{i & 255}",
            "container_ports": container_ports(),
        })
    label_pool = [p["labels"] for p in pods]
    ns_pool = [ns["labels"] for ns in namespaces]
    if cfg["port_library"] is not None:
        port_lib = [dict(p) for p in cfg["port_library"]]
    elif cfg["port_library_size"] > 0:
        port_lib = _port_library(rng, cfg["port_library_size"])
    else:
        port_lib = None

    def rand_rule() -> Dict:
        if rng.random() < cfg["p_empty_rule"]:
            return {"peers": None, "ports": None}
        peers = []
        for _ in range(rng.randint(1, cfg["max_peers_per_rule"])):
            if rng.random() < cfg["p_ipblock_peer"]:
                base = rng.randrange(cfg["n_pods"] or 1)
                cidr = f"10.{(base >> 16) & 255}.{(base >> 8) & 255}.0/24"
                excepts = (
                    [f"10.{(base >> 16) & 255}.{(base >> 8) & 255}.{base & 255}/32"]
                    if rng.random() < 0.5 else []
                )
                peers.append({"pod_selector": None, "namespace_selector": None,
                              "ip_block": {"cidr": cidr, "except": excepts}})
                continue
            use_ns = rng.random() < cfg["p_namespace_selector"]
            use_pod = rng.random() < 0.8 or not use_ns
            peers.append({
                "pod_selector": _rand_selector(rng, label_pool, cfg) if use_pod else None,
                "namespace_selector": _rand_selector(rng, ns_pool, cfg) if use_ns else None,
                "ip_block": None,
            })
        ports = (
            _rand_ports(rng, cfg["p_named_port"], port_lib)
            if rng.random() < cfg["p_ports"] else None
        )
        return {"peers": peers, "ports": ports}

    policies = []
    for i in range(cfg["n_policies"]):
        ns = rng.choice(namespaces)["name"]
        if rng.random() < cfg["p_absent_rules"]:
            ingress = rng.choice([None, []])
        else:
            ingress = [rand_rule()
                       for _ in range(rng.randint(1, cfg["max_rules_per_policy"]))]
        egress = None
        if rng.random() < cfg["p_egress_section"]:
            if rng.random() < cfg["p_absent_rules"]:
                egress = []
            else:
                egress = [rand_rule()
                          for _ in range(rng.randint(1, cfg["max_rules_per_policy"]))]
        policy_types = None
        if rng.random() < cfg["p_explicit_policy_types"]:
            policy_types = list(rng.choice(
                [("Ingress",), ("Egress",), ("Ingress", "Egress")]))
        policies.append({
            "name": f"pol{i}", "namespace": ns,
            "pod_selector": _rand_selector(rng, label_pool, cfg),
            "policy_types": policy_types, "ingress": ingress, "egress": egress,
        })
    return {"pods": pods, "namespaces": namespaces, "policies": policies}


def churn_policy(rng: random.Random, name: str, namespace: str,
                 label_pool: List[dict], ns_pool: List[dict], cfg: Dict,
                 library: Optional[List[Dict]] = None) -> Dict:
    """A fresh policy (``_random_churn_policy``): without ports, or with
    ``library`` its rules name ports from it as the cluster's rules do
    (``p_ports``), and never a named port."""

    def peer() -> Dict:
        use_ns = rng.random() < cfg["p_namespace_selector"]
        use_pod = rng.random() < 0.8 or not use_ns
        return {
            "pod_selector": _rand_selector(rng, label_pool, cfg) if use_pod else None,
            "namespace_selector": _rand_selector(rng, ns_pool, cfg) if use_ns else None,
            "ip_block": None,
        }

    def rule() -> Dict:
        peers = [peer() for _ in range(rng.randint(1, cfg["max_peers_per_rule"]))]
        ports = (_rand_ports(rng, 0.0, library)
                 if library is not None and rng.random() < cfg["p_ports"] else None)
        return {"peers": peers, "ports": ports}

    ingress = [rule() for _ in range(rng.randint(1, cfg["max_rules_per_policy"]))]
    egress = (
        [rule() for _ in range(rng.randint(1, cfg["max_rules_per_policy"]))]
        if rng.random() < cfg["p_egress_section"] else None
    )
    return {
        "name": name, "namespace": namespace,
        "pod_selector": _rand_selector(rng, label_pool, cfg),
        "policy_types": None, "ingress": ingress, "egress": egress,
    }


def verify_edits(cluster: Dict, deployment: Dict, seed: int, count: int) -> List[Dict]:
    """``count`` single-policy edits: each replaces the policy at ``index``
    by a fresh one of the same name and namespace, drawn as
    ``random_event_stream`` draws its updates."""
    cfg = knobs(deployment)
    rng = random.Random(seed)
    pols = cluster["policies"]
    label_pool = [p["labels"] for p in cluster["pods"]]
    ns_pool = [ns["labels"] for ns in cluster["namespaces"]]
    edits = []
    for _ in range(count):
        j = rng.randrange(len(pols))
        pol = churn_policy(rng, pols[j]["name"], pols[j]["namespace"],
                           label_pool, ns_pool, cfg)
        edits.append({"index": j, "policy": pol})
    return edits


def snapshot(cluster: Dict, edit: Dict) -> Dict:
    """The cluster with one edit applied; the base is left as it was."""
    policies = list(cluster["policies"])
    policies[edit["index"]] = edit["policy"]
    return {"pods": cluster["pods"], "namespaces": cluster["namespaces"],
            "policies": policies}


def churn_changes(cluster: Dict, deployment: Dict, seed: int, mix: Dict,
                  count: int) -> List[Dict]:
    """``count`` changes valid against ``cluster`` in order, as plain dicts
    ``{"op": kind, ...}``. Each block of ``sum(mix["shares"])`` draws holds
    every kind its share of times, shuffled by the seed; of a block's pod
    relabels ``mix["doubled"]`` are relabelled twice, and of its policy adds
    ``mix["removed_again"]`` are removed at once."""
    cfg = knobs(deployment)
    rng = random.Random(seed)
    library = cfg["port_library"] if mix.get("policy_ports") else None
    if mix.get("policy_ports") and library is None:
        raise ValueError("ported churn policies need the deployment's port_library")
    shares = mix["shares"]
    kinds = sorted(shares)
    pods = cluster["pods"]
    label_pool = [p["labels"] for p in pods]
    ns_pool = [ns["labels"] for ns in cluster["namespaces"]]
    resident = sorted(f'{p["namespace"]}/{p["name"]}' for p in cluster["policies"])
    namespaces = sorted(ns["name"] for ns in cluster["namespaces"])
    seq = 0
    out: List[Dict] = []

    def flags(total: int, marked: int) -> List[bool]:
        f = [True] * marked + [False] * (total - marked)
        rng.shuffle(f)
        return f

    while len(out) < count:
        block = [k for k in kinds for _ in range(shares[k])]
        rng.shuffle(block)
        doubled = iter(flags(shares.get("pod_relabel", 0), mix.get("doubled", 0)))
        again = iter(flags(shares.get("policy_add", 0), mix.get("removed_again", 0)))
        for kind in block:
            if kind == "pod_relabel":
                i = rng.randrange(len(pods))
                for _ in range(2 if next(doubled) else 1):
                    out.append({"op": kind, "index": i,
                                "labels": rand_labels(rng, cfg["max_labels_per_pod"])})
            elif kind == "policy_add":
                ns = rng.choice(namespaces)
                name = f"churn{seq}"
                seq += 1
                pol = churn_policy(rng, name, ns, label_pool, ns_pool, cfg, library)
                out.append({"op": kind, "policy": pol})
                if next(again):
                    out.append({"op": "policy_remove", "namespace": ns, "name": name})
                else:
                    resident.append(f"{ns}/{name}")
            elif kind in ("policy_update", "policy_remove"):
                key = rng.choice(resident)
                ns, name = key.split("/", 1)
                if kind == "policy_update":
                    out.append({"op": kind, "policy": churn_policy(
                        rng, name, ns, label_pool, ns_pool, cfg, library)})
                else:
                    resident.remove(key)
                    out.append({"op": kind, "namespace": ns, "name": name})
            else:
                raise ValueError(f"unknown change kind {kind!r}")
    return out[:count]
