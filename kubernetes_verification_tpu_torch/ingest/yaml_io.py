"""YAML ⇄ model objects.

Plays the role of both reference parsers, self-contained and with their bugs
fixed:

* ``load_cluster`` / ``parse_*`` — the k8s-level deserializer. The reference
  abused ``kubernetes.client.ApiClient.deserialize`` behind a fake HTTP
  response and called ``config.load_kube_config()`` at import time
  (``kubesv/kubesv/parser.py:9-22``), so offline parsing required a live kube
  config. Here the exact ``V1*`` fields the verifier consumes are parsed
  directly (labels, selectors, matchExpressions, peers, ipBlock, ports incl.
  ``endPort``, ``policyTypes``, pod IP + named container ports).
* ``load_kano`` — the kano-level walk (``kano_py/kano/parser.py:11-89``):
  file-or-directory traversal, ``kind:`` dispatch, one ``KanoPolicy`` per
  ingress/egress rule, one ``Container`` per pod-spec container. Fixed
  relative to the reference: ``ports`` are read as rule siblings where
  Kubernetes puts them, not from inside ``from``/``to`` items
  (``kano/parser.py:61-62,73-74``); protocols land in
  ``KanoPolicy.protocols`` instead of a raw dict being passed where a class
  was expected (``:63,75``); parse errors raise instead of being swallowed by
  bare ``except`` + print (``:32-33,46-47``).

Null-vs-empty is preserved everywhere it is semantic
(``kubesv/kubesv/model.py:129-170``): an *absent* mapping parses to ``None``,
an explicit ``{}`` to an empty ``Selector``; absent ``ingress:`` to ``None``,
``ingress: []`` to ``()``; absent ``from:`` to ``None`` (allow-all rule).

Multi-document YAML streams and ``kind: List`` wrappers are supported; other
kinds are skipped with a warning list returned by ``load_cluster`` (strict
mode raises).

The port's own copy of ``kubernetes_verification_tpu.ingest.yaml_io``. It is
host-only. PyYAML is imported inside the functions that read or write YAML
(``_iter_docs``, ``dump_cluster``), so importing the package works on a
machine without it. ``*.json`` manifests are read with the standard
library (JSON is YAML, so the JAX package reads them too), and the
private ``_dump_cluster_json`` writes one JSON ``kind: List`` document per
object kind: the checkpoints of ``utils/persist.py`` use it, since PyYAML's
emitter takes about a minute for a 100,000-pod cluster.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

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
from ..resilience.errors import IngestError

__all__ = [
    "load_cluster",
    "load_kano",
    "dump_cluster",
    "parse_pod",
    "parse_namespace",
    "parse_network_policy",
    "pod_to_dict",
    "namespace_to_dict",
    "network_policy_to_dict",
    "IngestError",
    "SkipDiagnostic",
]


def _yaml():
    """PyYAML and its loader: libyaml's, as the reference uses
    (``kano_py/kano/parser.py:6-9``), else the pure-Python one; ``(None,
    None)`` on a machine without PyYAML."""
    try:
        import yaml
    except ImportError:
        return None, None
    loader = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
    return yaml, loader


class SkipDiagnostic(str):
    """One lenient-mode skip, structured: ``path`` / ``doc_index`` /
    ``kind`` / ``name`` / ``reason`` attributes, with the str value kept as
    the historical ``"file: kind/name"`` note so existing consumers (JSON
    dumps, substring asserts) are untouched."""

    path: str
    doc_index: int
    kind: Optional[str]
    name: Optional[str]
    reason: str

    def __new__(
        cls,
        path: str,
        doc_index: int,
        kind: Optional[str],
        name: Optional[str],
        reason: str,
    ) -> "SkipDiagnostic":
        self = super().__new__(cls, f"{path}: {kind}/{name}")
        self.path = path
        self.doc_index = doc_index
        self.kind = kind
        self.name = name
        self.reason = reason
        return self

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "doc_index": self.doc_index,
            "kind": self.kind,
            "name": self.name,
            "reason": self.reason,
        }


def _meta(obj: dict) -> dict:
    return obj.get("metadata") or {}


def _name(obj: dict, kind: str) -> str:
    name = _meta(obj).get("name")
    if not name:
        raise IngestError(f"{kind} without metadata.name: {obj!r:.120}")
    return str(name)


def _labels(obj: dict) -> Dict[str, str]:
    labels = _meta(obj).get("labels") or {}
    return {str(k): str(v) for k, v in labels.items()}


# ---------------------------------------------------------------------------
# k8s level
# ---------------------------------------------------------------------------


def _parse_selector(raw: Optional[dict]) -> Optional[Selector]:
    """``None`` stays ``None`` (null selector); ``{}`` is the match-everything
    empty selector — the distinction the whole peer semantics hangs on."""
    if raw is None:
        return None
    exprs = []
    for e in raw.get("matchExpressions") or ():
        exprs.append(
            Expr(
                key=str(e["key"]),
                op=str(e["operator"]),
                values=tuple(str(v) for v in e.get("values") or ()),
            )
        )
    match_labels = {
        str(k): str(v) for k, v in (raw.get("matchLabels") or {}).items()
    }
    return Selector(match_labels=match_labels, match_expressions=tuple(exprs))


def _parse_peer(raw: dict) -> Peer:
    ip = None
    if raw.get("ipBlock") is not None:
        b = raw["ipBlock"]
        ip = IpBlock(
            cidr=str(b["cidr"]), excepts=tuple(str(e) for e in b.get("except") or ())
        )
    return Peer(
        pod_selector=_parse_selector(raw.get("podSelector")),
        namespace_selector=_parse_selector(raw.get("namespaceSelector")),
        ip_block=ip,
    )


def _parse_ports(raw: Optional[list]) -> Optional[Tuple[PortSpec, ...]]:
    if raw is None:
        return None
    specs = []
    for p in raw:
        port = p.get("port")
        if isinstance(port, str) and port.isdigit():
            port = int(port)
        specs.append(
            PortSpec(
                protocol=str(p.get("protocol") or "TCP"),
                port=port,
                end_port=p.get("endPort"),
            )
        )
    return tuple(specs)


def _parse_rules(raw: Optional[list], peer_key: str) -> Optional[Tuple[Rule, ...]]:
    """``None`` (absent section) → None; ``[]`` → (); rule without
    ``from``/``to`` → allow-all-peers rule (the case the reference's
    ``define_peer_rule`` returned None for and crashed on,
    ``kubesv/kubesv/model.py:350-363``)."""
    if raw is None:
        return None
    rules = []
    for r in raw:
        r = r or {}
        peers_raw = r.get(peer_key)
        peers = (
            None
            if peers_raw is None
            else tuple(_parse_peer(p) for p in peers_raw)
        )
        rules.append(Rule(peers=peers, ports=_parse_ports(r.get("ports"))))
    return tuple(rules)


def parse_network_policy(obj: dict) -> NetworkPolicy:
    spec = obj.get("spec") or {}
    pt = spec.get("policyTypes")
    return NetworkPolicy(
        name=_name(obj, "NetworkPolicy"),
        namespace=str(_meta(obj).get("namespace") or "default"),
        pod_selector=_parse_selector(spec.get("podSelector")) or Selector(),
        policy_types=tuple(str(t) for t in pt) if pt is not None else None,
        ingress=_parse_rules(spec.get("ingress"), "from"),
        egress=_parse_rules(spec.get("egress"), "to"),
    )


def parse_pod(obj: dict) -> Pod:
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    cports: Dict[str, Tuple[str, int]] = {}
    for c in spec.get("containers") or ():
        for p in c.get("ports") or ():
            if p.get("name") and p.get("containerPort"):
                cports[str(p["name"])] = (
                    str(p.get("protocol") or "TCP"),
                    int(p["containerPort"]),
                )
    return Pod(
        name=_name(obj, "Pod"),
        namespace=str(_meta(obj).get("namespace") or "default"),
        labels=_labels(obj),
        ip=status.get("podIP"),
        container_ports=cports,
    )


def parse_namespace(obj: dict) -> Namespace:
    return Namespace(name=_name(obj, "Namespace"), labels=_labels(obj))


def _iter_docs(path: str) -> Iterable[Tuple[str, int, dict]]:
    """Yield (source_file, doc_index, document) over a file or a directory
    walk — the reference's traversal shape (``kano_py/kano/parser.py:17-49``).
    ``doc_index`` counts yielded documents per file (``kind: List`` items
    each get their own index)."""
    yaml, loader = _yaml()
    if os.path.isdir(path):
        for root, _dirs, files in sorted(os.walk(path)):
            for fname in sorted(files):
                if fname.endswith((".yml", ".yaml", ".json")):
                    yield from _iter_docs(os.path.join(root, fname))
        return
    try:
        fh = open(path, "r")
    except OSError as e:
        raise IngestError(f"{path}: cannot read manifests: {e}") from e
    with fh:
        if path.endswith(".json"):
            try:
                docs = [json.load(fh)]
            except ValueError as e:
                raise IngestError(f"{path}: {e}") from e
        elif yaml is not None:
            try:
                docs = list(yaml.load_all(fh, Loader=loader))
            except yaml.YAMLError as e:
                raise IngestError(f"{path}: {e}") from e
        else:
            raise IngestError(
                f"{path}: reading YAML manifests needs PyYAML, which is not "
                "installed (JSON manifests need nothing)"
            )
    idx = 0
    for doc in docs:
        if doc is None:
            continue
        if not isinstance(doc, dict):
            raise IngestError(f"{path}: top-level document is not a mapping")
        if doc.get("kind") == "List":
            for item in doc.get("items") or ():
                yield path, idx, item
                idx += 1
        else:
            yield path, idx, doc
            idx += 1


def load_cluster(
    path: Union[str, os.PathLike], strict: bool = False
) -> Tuple[Cluster, List[str]]:
    """Parse every manifest under ``path`` into a :class:`Cluster`.

    Returns ``(cluster, skipped)`` where ``skipped`` lists a
    :class:`SkipDiagnostic` (str-compatible ``"file: kind/name"``, plus
    structured ``path``/``doc_index``/``kind``/``name``/``reason``) per
    document of a kind the verifier doesn't consume. ``strict=True`` raises
    on them instead.
    """
    return _cluster_from_docs(_iter_docs(os.fspath(path)), strict)


def _load_cluster_files(paths: Sequence[str]) -> Tuple[Cluster, List[str]]:
    """``load_cluster`` over the given manifest files only (an engine
    checkpoint's directory can hold two writers' sets)."""
    return _cluster_from_docs((d for p in paths for d in _iter_docs(p)), False)


def _cluster_from_docs(docs, strict: bool) -> Tuple[Cluster, List[str]]:
    pods: List[Pod] = []
    namespaces: List[Namespace] = []
    policies: List[NetworkPolicy] = []
    skipped: List[SkipDiagnostic] = []
    for src, idx, doc in docs:
        kind = doc.get("kind")
        if kind == "Pod":
            pods.append(parse_pod(doc))
        elif kind == "Namespace":
            namespaces.append(parse_namespace(doc))
        elif kind == "NetworkPolicy":
            policies.append(parse_network_policy(doc))
        else:
            diag = SkipDiagnostic(
                path=src,
                doc_index=idx,
                kind=None if kind is None else str(kind),
                name=_meta(doc).get("name"),
                reason=(
                    "document has no kind" if kind is None
                    else f"kind {kind} is not verifiable"
                ),
            )
            if strict:
                raise IngestError(f"unsupported kind: {diag}")
            skipped.append(diag)
    return Cluster(pods=pods, namespaces=namespaces, policies=policies), skipped


# ---------------------------------------------------------------------------
# kano level
# ---------------------------------------------------------------------------


def load_kano(
    path: Union[str, os.PathLike]
) -> Tuple[List[Container], List[KanoPolicy]]:
    """The kano-level parse: flat matchLabels only, one policy object per
    ingress/egress rule (``kano_py/kano/parser.py:51-89``)."""
    containers: List[Container] = []
    policies: List[KanoPolicy] = []
    for _src, _idx, doc in _iter_docs(os.fspath(path)):
        kind = doc.get("kind")
        if kind == "Pod":
            labels = _labels(doc)
            for c in (doc.get("spec") or {}).get("containers") or ():
                containers.append(Container(str(c.get("name")), dict(labels)))
        elif kind == "NetworkPolicy":
            spec = doc.get("spec") or {}
            name = _name(doc, "NetworkPolicy")
            select = {
                str(k): str(v)
                for k, v in ((spec.get("podSelector") or {}).get("matchLabels") or {}).items()
            }
            for direction, peer_key, is_ingress in (
                ("ingress", "from", True),
                ("egress", "to", False),
            ):
                for rule in spec.get(direction) or ():
                    rule = rule or {}
                    allow: Dict[str, str] = {}
                    for peer in rule.get(peer_key) or ():
                        sel = (peer.get("podSelector") or {}).get("matchLabels") or {}
                        allow.update({str(k): str(v) for k, v in sel.items()})
                    protocols = tuple(
                        str(p.get("protocol") or "TCP")
                        for p in rule.get("ports") or ()
                    )
                    policies.append(
                        KanoPolicy(
                            name=f"{name}/{direction}",
                            select=dict(select),
                            allow=allow,
                            ingress=is_ingress,
                            protocols=protocols,
                        )
                    )
    return containers, policies


# ---------------------------------------------------------------------------
# model → YAML (round-trip support for the harness/checkpointing)
# ---------------------------------------------------------------------------


def _selector_to_yaml(sel: Optional[Selector]) -> Optional[dict]:
    if sel is None:
        return None
    out: dict = {}
    if sel.match_labels:
        out["matchLabels"] = dict(sel.match_labels)
    if sel.match_expressions:
        out["matchExpressions"] = [
            {"key": e.key, "operator": e.op, **({"values": list(e.values)} if e.values else {})}
            for e in sel.match_expressions
        ]
    return out  # {} encodes the empty selector


def _rules_to_yaml(rules: Optional[Tuple[Rule, ...]], peer_key: str) -> Optional[list]:
    if rules is None:
        return None
    out = []
    for r in rules:
        entry: dict = {}
        if r.peers is not None:
            peers = []
            for p in r.peers:
                peer: dict = {}
                if p.ip_block is not None:
                    peer["ipBlock"] = {
                        "cidr": p.ip_block.cidr,
                        **({"except": list(p.ip_block.excepts)} if p.ip_block.excepts else {}),
                    }
                if p.pod_selector is not None:
                    peer["podSelector"] = _selector_to_yaml(p.pod_selector)
                if p.namespace_selector is not None:
                    peer["namespaceSelector"] = _selector_to_yaml(p.namespace_selector)
                peers.append(peer)
            entry[peer_key] = peers
        if r.ports is not None:
            entry["ports"] = [
                {
                    "protocol": s.protocol,
                    **({"port": s.port} if s.port is not None else {}),
                    **({"endPort": s.end_port} if s.end_port is not None else {}),
                }
                for s in r.ports
            ]
        out.append(entry)
    return out


def namespace_to_dict(ns: Namespace) -> dict:
    """Manifest-shaped doc for one namespace; ``parse_namespace`` inverts."""
    return {
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {"name": ns.name, **({"labels": dict(ns.labels)} if ns.labels else {})},
    }


def pod_to_dict(p: Pod) -> dict:
    """Manifest-shaped doc for one pod; ``parse_pod`` inverts."""
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": p.name,
            "namespace": p.namespace,
            **({"labels": dict(p.labels)} if p.labels else {}),
        },
        "spec": {
            "containers": [
                {
                    "name": p.name,
                    **(
                        {
                            "ports": [
                                {"name": n, "protocol": proto, "containerPort": port}
                                for n, (proto, port) in p.container_ports.items()
                            ]
                        }
                        if p.container_ports
                        else {}
                    ),
                }
            ]
        },
        **({"status": {"podIP": p.ip}} if p.ip else {}),
    }


def network_policy_to_dict(pol: NetworkPolicy) -> dict:
    """Manifest-shaped doc for one policy; ``parse_network_policy`` inverts
    (null-vs-empty preserved: absent sections stay absent)."""
    return {
        "apiVersion": "networking.k8s.io/v1",
        "kind": "NetworkPolicy",
        "metadata": {"name": pol.name, "namespace": pol.namespace},
        "spec": {
            "podSelector": _selector_to_yaml(pol.pod_selector),
            **(
                {"policyTypes": list(pol.policy_types)}
                if pol.policy_types is not None
                else {}
            ),
            **(
                {"ingress": _rules_to_yaml(pol.ingress, "from")}
                if pol.ingress is not None
                else {}
            ),
            **(
                {"egress": _rules_to_yaml(pol.egress, "to")}
                if pol.egress is not None
                else {}
            ),
        },
    }


def _cluster_docs(cluster: Cluster) -> List[Tuple[str, List[dict]]]:
    """``(file stem, manifest dicts)`` per object kind, empty kinds left
    out, in the order ``dump_cluster`` writes them."""
    kinds = [
        ("namespaces", [namespace_to_dict(ns) for ns in cluster.namespaces]),
        ("pods", [pod_to_dict(p) for p in cluster.pods]),
        (
            "networkpolicies",
            [network_policy_to_dict(pol) for pol in cluster.policies],
        ),
    ]
    return [(stem, docs) for stem, docs in kinds if docs]


def dump_cluster(cluster: Cluster, directory: Union[str, os.PathLike]) -> List[str]:
    """Write the cluster as one multi-doc manifest per object kind under
    ``directory``; returns the written paths. ``load_cluster`` of the
    directory round-trips to an equivalent cluster (asserted in tests)."""
    yaml, _ = _yaml()
    if yaml is None:
        raise IngestError("writing YAML manifests needs PyYAML, which is not installed")
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    written = []
    for stem, docs in _cluster_docs(cluster):
        p = os.path.join(directory, f"{stem}.yaml")
        with open(p, "w") as fh:  # kvtpu: ignore[atomic-write] manifest export into a fresh directory, not durable state
            yaml.safe_dump_all(docs, fh, sort_keys=False)
        written.append(p)
    return written


def _dump_cluster_json(cluster: Cluster, directory: Union[str, os.PathLike]) -> List[str]:
    """``dump_cluster`` as one JSON ``kind: List`` document per object kind
    (``<kind>.json``), no PyYAML needed; the engine checkpoints of
    ``utils/persist.py`` write their manifests with it."""
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    written = []
    for stem, docs in _cluster_docs(cluster):
        p = os.path.join(directory, f"{stem}.json")
        with open(p, "w") as fh:  # kvtpu: ignore[atomic-write] manifest export into a fresh directory, not durable state
            # one dumps: json.dump streams through the pure-Python encoder
            fh.write(json.dumps({"apiVersion": "v1", "kind": "List", "items": docs}))
        written.append(p)
    return written
