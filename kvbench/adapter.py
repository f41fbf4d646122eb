"""Plain dicts → the port's model objects.

Besides the loops (``loops/``), the only module of the benchmark that
imports the program. ``reference.py`` reads the same dicts directly.
"""
from __future__ import annotations

from typing import Dict, Optional

from kubernetes_verification_tpu_torch.models.core import (
    Cluster,
    Expr,
    IpBlock,
    Namespace,
    NetworkPolicy,
    Peer,
    Pod,
    PortSpec,
    Rule,
    Selector,
)


def selector(d: Optional[Dict]) -> Optional[Selector]:
    if d is None:
        return None
    return Selector(
        match_labels=dict(d["match_labels"]),
        match_expressions=tuple(
            Expr(e["key"], e["op"], tuple(e["values"])) for e in d["match_expressions"]
        ),
    )


def _peer(d: Dict) -> Peer:
    if d.get("ip_block") is not None:
        b = d["ip_block"]
        return Peer(ip_block=IpBlock(b["cidr"], tuple(b["except"])))
    return Peer(pod_selector=selector(d["pod_selector"]),
                namespace_selector=selector(d["namespace_selector"]))


def _rule(d: Dict) -> Rule:
    peers = None if d["peers"] is None else tuple(_peer(p) for p in d["peers"])
    ports = None if d["ports"] is None else tuple(
        PortSpec(p["protocol"], p["port"], p["end_port"]) for p in d["ports"]
    )
    return Rule(peers=peers, ports=ports)


def _rules(rules):
    return None if rules is None else tuple(_rule(r) for r in rules)


def policy(d: Dict) -> NetworkPolicy:
    return NetworkPolicy(
        name=d["name"],
        namespace=d["namespace"],
        pod_selector=selector(d["pod_selector"]),
        policy_types=None if d["policy_types"] is None else tuple(d["policy_types"]),
        ingress=_rules(d["ingress"]),
        egress=_rules(d["egress"]),
    )


def pod(d: Dict) -> Pod:
    return Pod(
        d["name"], d["namespace"], dict(d["labels"]), d["ip"],
        {k: (v[0], int(v[1])) for k, v in d["container_ports"].items()},
    )


def cluster(d: Dict) -> Cluster:
    return Cluster(
        pods=[pod(p) for p in d["pods"]],
        namespaces=[Namespace(ns["name"], dict(ns["labels"])) for ns in d["namespaces"]],
        policies=[policy(p) for p in d["policies"]],
    )

