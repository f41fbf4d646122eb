"""Carry an encoded cluster across packages as a flat dict of arrays.

An ``EncodedCluster`` is the system's whole solver input — its "weights".
``encoding_to_arrays`` flattens every array leaf of one (this package's, or
any dataclass of the same field layout, such as the JAX package's) into
``{dotted.field.path: np.ndarray}``: ``pod_kv``, ``pol_sel.req_eq``,
``ingress.pod_sel.in_mask``, ``egress.ip_match``, ``restrict_bank``, ...
Optional leaves that are ``None`` are left out. ``encoding_from_arrays``
rebuilds this package's ``EncodedCluster`` from such a dict, so both packages
can solve exactly the same operands.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable

import numpy as np

from ..backends.base import PortAtom
from ..resilience.errors import EncodeError
from .encoder import EncodedCluster, GrantBlock, SelectorEnc

__all__ = ["encoding_to_arrays", "encoding_from_arrays"]

_OPTIONAL = ("ip_match", "dst_restrict", "rule_id", "peer_id", "restrict_bank")


def encoding_to_arrays(enc) -> Dict[str, np.ndarray]:
    """Every array leaf of an encoded cluster, by dotted field path."""
    out: Dict[str, np.ndarray] = {}

    def walk(obj, prefix: str) -> None:
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, np.ndarray):
                out[prefix + f.name] = v
            elif f.name != "vocab" and dataclasses.is_dataclass(v):
                walk(v, prefix + f.name + ".")

    walk(enc, "")
    return out


def _build(cls, arrays: Dict[str, np.ndarray], prefix: str, used: set):
    vals = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if f.name in ("pod_sel", "ns_sel"):
            vals[f.name] = _build(SelectorEnc, arrays, key + ".", used)
        elif key in arrays:
            vals[f.name] = np.asarray(arrays[key])
            used.add(key)
        elif f.name in _OPTIONAL:
            vals[f.name] = None
        else:
            raise EncodeError(f"carried encoding lacks {key!r}")
    return cls(**vals)


def _atom(a) -> PortAtom:
    if isinstance(a, tuple):
        return PortAtom(*a)
    return PortAtom(a.protocol, a.lo, a.hi, a.name)


def encoding_from_arrays(
    arrays: Dict[str, np.ndarray],
    *,
    n_pods: int,
    n_namespaces: int,
    n_policies: int,
    atoms: Iterable,
) -> EncodedCluster:
    """This package's ``EncodedCluster`` from a flat dict of its array
    leaves. ``atoms`` are ``PortAtom``-like objects or ``(protocol, lo, hi,
    name)`` tuples. The vocabulary is not carried (``vocab=None``); the
    solvers never read it."""
    used: set = set()
    top = {}
    for name in (
        "pod_kv", "pod_key", "pod_ns", "ns_kv", "ns_key", "pol_ns",
        "pol_affects_ingress", "pol_affects_egress",
    ):
        if name not in arrays:
            raise EncodeError(f"carried encoding lacks {name!r}")
        top[name] = np.asarray(arrays[name])
        used.add(name)
    pol_sel = _build(SelectorEnc, arrays, "pol_sel.", used)
    ingress = _build(GrantBlock, arrays, "ingress.", used)
    egress = _build(GrantBlock, arrays, "egress.", used)
    bank = arrays.get("restrict_bank")
    if bank is not None:
        used.add("restrict_bank")
    unknown = sorted(set(arrays) - used)
    if unknown:
        raise EncodeError(f"carried encoding has unknown leaves {unknown}")
    return EncodedCluster(
        n_pods=n_pods,
        n_namespaces=n_namespaces,
        n_policies=n_policies,
        vocab=None,
        atoms=[_atom(a) for a in atoms],
        pol_sel=pol_sel,
        ingress=ingress,
        egress=egress,
        restrict_bank=None if bank is None else np.asarray(bank),
        **top,
    )
