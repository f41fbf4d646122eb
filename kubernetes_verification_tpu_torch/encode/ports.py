"""Port-space equivalence-class ("atom") computation + named-port resolution.

The reference parses NetworkPolicy ports but never enforces them
(``kano_py/kano/model.py:54-56`` stores protocols unused;
``kubesv/kubesv/model.py:365-385`` drops them via a missing return). Here ports
are first-class: instead of a 3×65535 port axis, the (protocol, port) space is
partitioned into the coarsest partition under which every policy's port specs
are constant — the *port atoms*. The reach tensor gets one boolean slot per
atom, and each atom carries its ``width`` so counting queries can weight pairs
by how many concrete ports an atom stands for.

Named ports resolve against the DESTINATION pod, as in real Kubernetes: a
spec ``(protocol, "http")`` covers, for dst pod d, the numeric port d's
container spec declares under the name "http" with that protocol — two pods
exposing "http" on different numbers are matched on *different* ports. Pass
``pods`` to :func:`compute_port_atoms` to get resolution atoms (the numeric
partition is refined with a single-port atom per referenced container port),
and use :func:`named_resolution` for the per-destination (name → atom) masks;
the encoder turns these into per-grant dst-restriction rows consumed by every
backend. Without ``pods`` the legacy approximation applies (one atom per
(protocol, name), matched by name alone).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..backends.base import PortAtom
from ..models.core import PROTOCOLS, NetworkPolicy, PortSpec, Rule

__all__ = [
    "compute_port_atoms",
    "rule_port_mask",
    "named_resolution",
    "rule_named_specs",
    "ALL_ATOM",
]

#: The degenerate single atom used when no policy mentions any port.
ALL_ATOM = PortAtom(protocol="ANY", lo=1, hi=65535)

_MAX_PORT = 65535


def _iter_rules(policies: Sequence[NetworkPolicy]) -> Iterable[Rule]:
    for pol in policies:
        for rules in (pol.ingress, pol.egress):
            if rules:
                yield from rules


def _named_specs_used(policies: Sequence[NetworkPolicy]) -> set:
    named = set()
    for rule in _iter_rules(policies):
        for spec in rule.ports or ():
            if isinstance(spec.port, str):
                named.add((spec.protocol, spec.port))
    return named


def compute_port_atoms(
    policies: Sequence[NetworkPolicy],
    pods: Optional[Sequence] = None,
) -> List[PortAtom]:
    """Partition (protocol × port) space by the boundaries of every port spec
    appearing in any rule. Returns a single ``ALL_ATOM`` when no rule
    constrains ports, so portless clusters verify with a length-1 port axis.

    With ``pods``, named specs resolve per destination pod: instead of a
    by-name atom, the numeric partition gains a single-port atom for every
    container port a pod declares under a referenced (protocol, name) — so a
    named grant's coverage is expressible as ordinary numeric atoms gated by
    a per-dst mask (``named_resolution``)."""
    numeric: dict = {}  # protocol -> set of boundaries
    named: set = set()  # (protocol, name)
    any_spec = False
    for rule in _iter_rules(policies):
        if rule.ports is None:
            continue
        for spec in rule.ports:
            any_spec = True
            if isinstance(spec.port, str):
                named.add((spec.protocol, spec.port))
            elif spec.port is None:
                numeric.setdefault(spec.protocol, set())
            else:
                hi = spec.end_port if spec.end_port is not None else spec.port
                bounds = numeric.setdefault(spec.protocol, set())
                bounds.add(spec.port)
                bounds.add(hi + 1)
    if not any_spec:
        return [ALL_ATOM]

    if pods is not None and named:
        # refine the numeric partition with the referenced container ports,
        # one exact single-port atom each ({p, p+1} boundaries)
        for pod in pods:
            for name, (proto, num) in pod.container_ports.items():
                if (proto, name) in named:
                    bounds = numeric.setdefault(proto, set())
                    bounds.add(int(num))
                    bounds.add(int(num) + 1)

    atoms: List[PortAtom] = []
    for proto in PROTOCOLS:
        bounds = sorted({1, _MAX_PORT + 1} | numeric.get(proto, set()))
        for lo, nxt in zip(bounds, bounds[1:]):
            atoms.append(PortAtom(protocol=proto, lo=lo, hi=nxt - 1))
    if pods is None:
        # legacy by-name approximation: one slot per (protocol, name)
        for proto, name in sorted(named):
            atoms.append(PortAtom(protocol=proto, lo=0, hi=0, name=name))
    return atoms


def rule_named_specs(rule: Rule) -> List[Tuple[str, str]]:
    """The (protocol, name) named specs of one rule (deduplicated, ordered)."""
    out: List[Tuple[str, str]] = []
    for spec in rule.ports or ():
        if isinstance(spec.port, str):
            key = (spec.protocol, spec.port)
            if key not in out:
                out.append(key)
    return out


def named_resolution(
    policies: Sequence[NetworkPolicy],
    atoms: Sequence[PortAtom],
    pods: Sequence,
    keys: Optional[Sequence[Tuple[str, str]]] = None,
) -> Dict[Tuple[str, str], np.ndarray]:
    """Per-destination resolution masks: for each referenced (protocol,
    name), a ``bool [N, Q]`` where ``[d, q]`` is True iff dst pod ``d``
    declares a container port with that name and protocol whose number falls
    in atom ``q``. Pods not declaring the name match nothing — the real-k8s
    behaviour the by-name approximation missed. ``keys`` overrides the
    referenced-name scan (checkpoint resume reconstructs the exact frozen
    key set, which may include names no current policy references)."""
    out: Dict[Tuple[str, str], np.ndarray] = {}
    n, Q = len(pods), len(atoms)
    key_list = (
        sorted(_named_specs_used(policies)) if keys is None else list(keys)
    )
    for key in key_list:
        proto, name = key
        mask = np.zeros((n, Q), dtype=bool)
        for d, pod in enumerate(pods):
            entry = pod.container_ports.get(name)
            if entry is None or entry[0] != proto:
                continue
            num = int(entry[1])
            for q, atom in enumerate(atoms):
                if (
                    atom.name is None
                    and atom.protocol == proto
                    and atom.lo <= num <= atom.hi
                ):
                    mask[d, q] = True
        out[key] = mask
    return out


def _spec_covers(spec: PortSpec, atom: PortAtom) -> bool:
    if atom.name is not None:
        return isinstance(spec.port, str) and (spec.protocol, spec.port) == (
            atom.protocol,
            atom.name,
        )
    if atom.protocol == "ANY":
        return spec.port is None  # only all-ports specs cover the ANY atom
    if spec.protocol != atom.protocol or isinstance(spec.port, str):
        return False
    if spec.port is None:
        return True  # all ports of this protocol
    hi = spec.end_port if spec.end_port is not None else spec.port
    return spec.port <= atom.lo and atom.hi <= hi


def rule_port_mask(rule: Rule, atoms: Sequence[PortAtom]) -> np.ndarray:
    """bool[Q]: which atoms this rule's ports cover.

    ``ports=None`` *and* ``ports=()`` both mean all ports — the k8s API says
    "if this field is empty or missing, this rule matches all traffic"
    (mirrored for peers by ``Rule.matches_all_peers``).

    When the port axis is the degenerate any-port axis (``[ALL_ATOM]``, i.e.
    ``compute_ports=False``) port specs are IGNORED, not enforced: a concrete
    spec tested against the ANY atom would yield an all-False row and silently
    drop the grant. Centralised here so every emitter gets it right."""
    if not rule.ports or (len(atoms) == 1 and atoms[0] == ALL_ATOM):
        return np.ones(len(atoms), dtype=bool)
    mask = np.zeros(len(atoms), dtype=bool)
    for q, atom in enumerate(atoms):
        mask[q] = any(_spec_covers(spec, atom) for spec in rule.ports)
    return mask
