"""Host-side padding of the encoded operands (numpy).

The port's own copy of ``kubernetes_verification_tpu.parallel.mesh.pad_rows``
and of ``parallel/sharded_ops.py``'s ``pad_selector_rows`` and
``pad_grants``. Padding is inert by construction: pad pods are label-less and
live in namespace −1 (never a policy's namespace, so never selected, never
peered label-wise); pad grant rows carry impossible selectors and belong to
the sink policy slot ``P``, which the solvers drop; whatever pad rows and
columns do pick up (match-all rules, default-allow) is masked out of every
output.
"""
from __future__ import annotations

import numpy as np

from ..encode.encoder import GrantBlock, SelectorEnc

__all__ = ["pad_rows", "pad_selector_rows", "pad_grants"]


def pad_rows(a: np.ndarray, pad: int, fill=0) -> np.ndarray:
    """Pad ``pad`` rows (leading axis) with ``fill``."""
    if pad == 0:
        return a
    widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, widths, constant_values=fill)


def pad_selector_rows(sel: SelectorEnc, pad: int) -> SelectorEnc:
    """Append ``pad`` rows that can match nothing (``impossible=True``)."""
    if pad == 0:
        return sel
    return SelectorEnc(
        req_eq=pad_rows(sel.req_eq, pad),
        req_key=pad_rows(sel.req_key, pad),
        forbid_eq=pad_rows(sel.forbid_eq, pad),
        forbid_key=pad_rows(sel.forbid_key, pad),
        in_mask=pad_rows(sel.in_mask, pad),
        in_valid=pad_rows(sel.in_valid, pad),
        impossible=pad_rows(sel.impossible, pad, fill=True),
    )


def pad_grants(
    block: GrantBlock, pad: int, sink_pol: int, n_pad_pods: int
) -> GrantBlock:
    """Append ``pad`` inert grant rows owned by the sink policy slot."""
    ip = block.ip_match
    if ip is not None:
        ip = np.pad(ip, ((0, pad), (0, n_pad_pods)), constant_values=False)
    if pad == 0 and ip is block.ip_match:
        return block
    return GrantBlock(
        pol=pad_rows(block.pol, pad, fill=sink_pol),
        match_all=pad_rows(block.match_all, pad),
        pod_sel=pad_selector_rows(block.pod_sel, pad),
        ns_sel=pad_selector_rows(block.ns_sel, pad),
        ns_sel_null=pad_rows(block.ns_sel_null, pad, fill=True),
        is_ipblock=pad_rows(block.is_ipblock, pad),
        ports=pad_rows(block.ports, pad),
        ip_match=ip,
        dst_restrict=(
            pad_rows(block.dst_restrict, pad)  # pads unrestricted (row 0)
            if block.dst_restrict is not None
            else None
        ),
        rule_id=(
            pad_rows(block.rule_id, pad, fill=-1)
            if block.rule_id is not None
            else None
        ),
        peer_id=(
            pad_rows(block.peer_id, pad, fill=-1)
            if block.peer_id is not None
            else None
        ),
    )
