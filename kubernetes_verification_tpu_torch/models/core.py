"""Typed cluster data model for Kubernetes NetworkPolicy verification.

This is layer L1 of the framework (see SURVEY.md §1): self-contained dataclasses
mirroring exactly the Kubernetes API fields the verification semantics consume —
labels, matchLabels, matchExpressions, namespaceSelector, podSelector, ipBlock,
ingress/egress rules, ports (incl. endPort ranges), and policyTypes.

The PyTorch port's own copy of the k8s-level model of
``kubernetes_verification_tpu.models.core`` (`Pod`/`Namespace`/
`NetworkPolicy`/`Cluster`): faithful NetworkPolicy semantics, the role played
by the kubernetes-client adapters in the reference
(``kubesv/kubesv/model.py:27-554``) — but with no dependency on the
``kubernetes`` package and no kube-config requirement (cf. the reference's
``kubesv/kubesv/parser.py:10`` which required one) — and of its kano-level
model (`Container`/`KanoPolicy`/`LabelRelation`).

Semantic subtleties encoded here (documented in the reference and in the
Kubernetes API docs):

* A *null* selector is different from an *empty* selector
  (``kubesv/kubesv/model.py:129-170``): in a policy peer, a null
  ``namespaceSelector`` means "the policy's own namespace" while an empty one
  (``{}``) matches *all* namespaces; a null ``podSelector`` in a peer means
  "all pods (of the namespaces in scope)".
* An *absent* rules list (``ingress: null``) isolates selected pods in that
  direction, and so does an *empty* one (``ingress: []`` — no rule grants
  anything); an empty *rule* (``ingress: [{}]``) allows everything
  (``kubesv/kubesv/model.py:333-341,421-427,452-459``).
* ``policyTypes`` defaults to ``["Ingress"]`` plus ``"Egress"`` iff an egress
  section is present (the reference models this in
  ``kubesv/kubesv/model.py:522-545`` but never enforces it; we do).
* Ports are first-class (the reference parses but never enforces them:
  ``kano_py/kano/model.py:54-56``, ``kubesv/kubesv/model.py:365-385`` — the
  latter is missing its ``return`` statement).
"""
from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Expr",
    "Selector",
    "IpBlock",
    "Peer",
    "PortSpec",
    "Rule",
    "NetworkPolicy",
    "Pod",
    "Namespace",
    "Cluster",
    "Container",
    "LabelRelation",
    "DefaultEqualityLabelRelation",
    "KanoPolicy",
    "INGRESS",
    "EGRESS",
    "PROTOCOLS",
]

INGRESS = "Ingress"
EGRESS = "Egress"
#: Protocols recognised by NetworkPolicy ports (k8s defaults to TCP).
PROTOCOLS = ("TCP", "UDP", "SCTP")

_OPS = ("In", "NotIn", "Exists", "DoesNotExist")


def _freeze_labels(labels: Optional[Mapping[str, str]]) -> Dict[str, str]:
    return dict(labels) if labels else {}


@dataclass(frozen=True)
class Expr:
    """One ``matchExpressions`` entry.

    Operators follow ``LabelSelectorRequirement``: ``In``/``NotIn`` test the
    value set (an object *without* the key satisfies ``NotIn``), and
    ``Exists``/``DoesNotExist`` test key presence. The reference models these
    as the ``ExistRelation``/``InRelation`` enums (``kubesv/kubesv/model.py:95-124``).
    The reference also accepts the misspelling ``DoesNotExists`` (used in its own
    sample, ``kubesv/sample/example.py:162``); we normalise it.
    """

    key: str
    op: str
    values: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        op = {"DoesNotExists": "DoesNotExist"}.get(self.op, self.op)
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "values", tuple(self.values))
        if op not in _OPS:
            raise ValueError(f"unknown matchExpressions operator: {self.op!r}")
        if op in ("Exists", "DoesNotExist") and self.values:
            raise ValueError(f"{op} takes no values")
        if op in ("In", "NotIn") and not self.values:
            raise ValueError(f"{op} requires at least one value")

    def matches(self, labels: Mapping[str, str]) -> bool:
        present = self.key in labels
        if self.op == "Exists":
            return present
        if self.op == "DoesNotExist":
            return not present
        if self.op == "In":
            return present and labels[self.key] in self.values
        # NotIn: objects without the key match.
        return (not present) or labels[self.key] not in self.values


@dataclass(frozen=True)
class Selector:
    """A ``LabelSelector``: AND of matchLabels equality and matchExpressions.

    ``Selector()`` is the *empty* selector and matches everything. Absence of a
    selector is modelled as ``None`` at the use sites (null ≠ empty,
    ``kubesv/kubesv/model.py:129-170``).
    """

    match_labels: Mapping[str, str] = field(default_factory=dict)
    match_expressions: Tuple[Expr, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "match_labels", dict(self.match_labels))
        object.__setattr__(
            self,
            "match_expressions",
            tuple(
                e if isinstance(e, Expr) else Expr(**e)
                for e in self.match_expressions
            ),
        )

    @property
    def is_empty(self) -> bool:
        return not self.match_labels and not self.match_expressions

    def matches(self, labels: Mapping[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        return all(e.matches(labels) for e in self.match_expressions)


@dataclass(frozen=True)
class IpBlock:
    """An ``ipBlock`` peer. Parsed and validated (as the reference does,
    ``kubesv/kubesv/model.py:253-269``) but — like the reference — it selects no
    *pods* unless pods are given IPs; pod-to-pod verification treats a pure
    ipBlock peer as matching no pod. Pods with an ``ip`` set are matched."""

    cidr: str
    excepts: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "excepts", tuple(self.excepts))
        ipaddress.ip_network(self.cidr)  # validate
        for e in self.excepts:
            ipaddress.ip_network(e)

    def matches_ip(self, ip: Optional[str]) -> bool:
        if ip is None:
            return False
        addr = ipaddress.ip_address(ip)
        net = ipaddress.ip_network(self.cidr)
        if addr not in net:
            return False
        return all(addr not in ipaddress.ip_network(e) for e in self.excepts)


@dataclass(frozen=True)
class Peer:
    """One ``from``/``to`` entry (``NetworkPolicyPeer``,
    ``kubesv/kubesv/model.py:247-315``).

    Combination semantics:
      * only ``pod_selector``   → pods in the *policy's* namespace matching it;
      * only ``namespace_selector`` → all pods of matching namespaces;
      * both                    → pods matching ``pod_selector`` inside
                                  namespaces matching ``namespace_selector``;
      * only ``ip_block``       → IP-based; matches pods only via their ``ip``.
    """

    pod_selector: Optional[Selector] = None
    namespace_selector: Optional[Selector] = None
    ip_block: Optional[IpBlock] = None

    def __post_init__(self) -> None:
        if (
            self.pod_selector is None
            and self.namespace_selector is None
            and self.ip_block is None
        ):
            raise ValueError(
                "NetworkPolicyPeer needs podSelector, namespaceSelector or ipBlock"
            )
        if self.ip_block is not None and (
            self.pod_selector is not None or self.namespace_selector is not None
        ):
            raise ValueError("ipBlock is exclusive with the selector fields")


@dataclass(frozen=True)
class PortSpec:
    """A ``NetworkPolicyPort``: protocol + port or [port, end_port] range.

    ``port`` may be an int, a named port (string — matched against pod
    ``container_ports`` names), or None (= all ports of the protocol).
    """

    protocol: str = "TCP"
    port: Optional[object] = None  # int | str | None
    end_port: Optional[int] = None

    def __post_init__(self) -> None:
        if self.protocol not in PROTOCOLS:
            raise ValueError(f"unknown protocol {self.protocol!r}")
        if self.end_port is not None:
            if not isinstance(self.port, int):
                raise ValueError("endPort requires a numeric port")
            if self.end_port < self.port:
                raise ValueError("endPort < port")
        if isinstance(self.port, int) and not 0 < self.port < 65536:
            raise ValueError(f"port out of range: {self.port}")


@dataclass(frozen=True)
class Rule:
    """One ingress or egress rule.

    ``peers=None`` *or* ``()`` → matches all sources/destinations (the k8s API
    treats empty-or-missing ``from``/``to`` as allow-from-anywhere; the
    reference instead returns ``None`` and crashes downstream,
    ``kubesv/kubesv/model.py:350-363``).
    ``ports=None`` → all ports.
    """

    peers: Optional[Tuple[Peer, ...]] = None
    ports: Optional[Tuple[PortSpec, ...]] = None

    def __post_init__(self) -> None:
        if self.peers is not None:
            object.__setattr__(self, "peers", tuple(self.peers))
        if self.ports is not None:
            object.__setattr__(self, "ports", tuple(self.ports))

    @property
    def matches_all_peers(self) -> bool:
        return not self.peers  # None or empty


@dataclass(frozen=True)
class NetworkPolicy:
    """A ``NetworkPolicy`` (``kubesv/kubesv/model.py:394-554``).

    ``ingress``/``egress`` are ``None`` when the section is absent. Absent
    section + the direction in ``effective_policy_types`` → selected pods are
    isolated in that direction with no grants.
    """

    name: str
    namespace: str = "default"
    pod_selector: Selector = field(default_factory=Selector)
    policy_types: Optional[Tuple[str, ...]] = None
    ingress: Optional[Tuple[Rule, ...]] = None
    egress: Optional[Tuple[Rule, ...]] = None

    def __post_init__(self) -> None:
        if self.policy_types is not None:
            pt = tuple(self.policy_types)
            for t in pt:
                if t not in (INGRESS, EGRESS):
                    raise ValueError(f"unknown policyType {t!r}")
            object.__setattr__(self, "policy_types", pt)
        if self.ingress is not None:
            object.__setattr__(self, "ingress", tuple(self.ingress))
        if self.egress is not None:
            object.__setattr__(self, "egress", tuple(self.egress))

    @property
    def effective_policy_types(self) -> Tuple[str, ...]:
        """Explicit ``policyTypes``, else the k8s default: Ingress always,
        Egress iff an egress section is present (the rule the reference
        implements in ``kubesv/kubesv/model.py:522-545`` but never calls)."""
        if self.policy_types is not None:
            return self.policy_types
        types = [INGRESS]
        if self.egress is not None:
            types.append(EGRESS)
        return tuple(types)

    @property
    def affects_ingress(self) -> bool:
        return INGRESS in self.effective_policy_types

    @property
    def affects_egress(self) -> bool:
        return EGRESS in self.effective_policy_types


@dataclass
class Pod:
    """A pod: name, namespace (default ``"default"``, as the reference's
    ``PodAdapter.namespace`` does, ``kubesv/kubesv/model.py:78-81``), labels,
    optionally an IP (for ipBlock matching) and named container ports."""

    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    ip: Optional[str] = None
    #: named container ports: name -> (protocol, port)
    container_ports: Dict[str, Tuple[str, int]] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.labels = _freeze_labels(self.labels)


@dataclass
class Namespace:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.labels = _freeze_labels(self.labels)


@dataclass
class Cluster:
    """The verification input: pods + namespaces + policies.

    Namespaces referenced by pods/policies but not listed are auto-created with
    empty labels (the reference instead KeyErrors, ``constraint.py:102-103``).
    """

    pods: List[Pod] = field(default_factory=list)
    namespaces: List[Namespace] = field(default_factory=list)
    policies: List[NetworkPolicy] = field(default_factory=list)

    def __post_init__(self) -> None:
        seen = {ns.name for ns in self.namespaces}
        for obj in (*self.pods, *self.policies):
            if obj.namespace not in seen:
                self.namespaces.append(Namespace(obj.namespace))
                seen.add(obj.namespace)

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    def namespace_index(self) -> Dict[str, int]:
        return {ns.name: i for i, ns in enumerate(self.namespaces)}

    def pod_index(self) -> Dict[Tuple[str, str], int]:
        return {(p.namespace, p.name): i for i, p in enumerate(self.pods)}


# ---------------------------------------------------------------------------
# kano level — the simplified flat-label model of the bit-vector verifier
# ---------------------------------------------------------------------------


@dataclass
class Container:
    """kano-level pod: a name and a flat label dict
    (``kano_py/kano/model.py:11-25``). ``select_policies``/``allow_policies``
    accumulate the indices of policies whose (direction-swapped) select/allow
    sets contain this container during matrix build
    (``kano_py/kano/model.py:158-163``) — the hook incremental re-verify uses.
    """

    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    select_policies: List[int] = field(default_factory=list)
    allow_policies: List[int] = field(default_factory=list)

    def get_value_or_default(self, key: str, default: str = "") -> str:
        return self.labels.get(key, default)


class LabelRelation:
    """The kano matcher plugin — the reference's only extension point
    (``kano_py/kano/model.py:59-68``). ``match(rule_value, label_value)``
    decides whether a policy's rule value accepts an entity's label value;
    the default is string equality. Supply a custom relation via
    ``VerifyConfig.label_relation`` (kano mode): the tensor backend
    re-encodes each rule label into its acceptable-value mask over the
    cluster vocabulary."""

    def match(self, rule_value: str, label_value: str) -> bool:
        raise NotImplementedError


class DefaultEqualityLabelRelation(LabelRelation):
    """String equality — the reference's default
    (``kano_py/kano/model.py:64-68``)."""

    def match(self, rule_value: str, label_value: str) -> bool:
        return rule_value == label_value


@dataclass
class KanoPolicy:
    """kano-level policy: equality-only ``select``/``allow`` label dicts, a
    direction, and a protocol list (``kano_py/kano/model.py:71-121``).

    Direction swap: an ingress policy's *sources* are its ``allow`` set and its
    *destinations* its ``select`` set; egress is the identity — so every policy
    evaluates in egress (src→dst) orientation
    (``kano_py/kano/model.py:82-93``).
    """

    name: str
    select: Dict[str, str] = field(default_factory=dict)
    allow: Dict[str, str] = field(default_factory=dict)
    ingress: bool = True
    protocols: Tuple[str, ...] = ()

    @property
    def src_labels(self) -> Dict[str, str]:
        return self.allow if self.ingress else self.select

    @property
    def dst_labels(self) -> Dict[str, str]:
        return self.select if self.ingress else self.allow
