"""Dense k8s-mode reachability assembly in PyTorch.

The port of ``kubernetes_verification_tpu.ops.reach.k8s_reach``: selector
matching, the per-grant peer maps, and the grant contraction over a
(pods × pods × port-atoms) tensor, each an exact float32 product (0/1
operands, counts below 2²⁴, TF32 off). This is the solve behind
``verify(cluster, VerifyConfig(backend="torch"))``; it materialises [N, N·Q]
counts, so it is for clusters of a few thousand pods — ``ops/tiled.py`` is
the 100k-pod path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..encode.encoder import GrantBlock, SelectorEnc
from .match import exact_fp32, match_selectors

__all__ = ["k8s_reach", "K8sOut"]

_F = torch.float32


class K8sOut(NamedTuple):
    reach: torch.Tensor  # bool [N, N]
    reach_ports: torch.Tensor  # bool [N, N, Q]
    selected: torch.Tensor  # bool [P, N]
    ingress_isolated: torch.Tensor  # bool [N]
    egress_isolated: torch.Tensor  # bool [N]
    src_sets: torch.Tensor  # bool [P, N]
    dst_sets: torch.Tensor  # bool [P, N]


def _grant_peers(
    block: GrantBlock, pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns
) -> torch.Tensor:
    """bool[G, N]: pods matched by each grant's peer clause."""
    pod_ok = match_selectors(block.pod_sel, pod_kv, pod_key)
    ns_sel_ok = match_selectors(block.ns_sel, ns_kv, ns_key)  # [G, M]
    same_ns = pol_ns[block.pol.long()][:, None] == pod_ns[None, :]  # [G, N]
    ns_ok = torch.where(
        block.ns_sel_null[:, None], same_ns, ns_sel_ok[:, pod_ns.long()]
    )
    ok = pod_ok & ns_ok
    if block.ip_match is not None:
        ok = torch.where(block.is_ipblock[:, None], block.ip_match, ok)
    else:
        ok &= ~block.is_ipblock[:, None]
    return ok | block.match_all[:, None]


def _grant_contract(
    side_a: torch.Tensor,  # bool [G, N] (source side)
    side_b: torch.Tensor,  # bool [G, N] (destination side)
    ports: torch.Tensor,  # bool [G, Q]
) -> torch.Tensor:
    """allow[s, d, q] = ∨_g side_a[g, s] ∧ side_b[g, d] ∧ ports[g, q], as one
    product [N, G] × [G, N·Q]."""
    G, N = side_a.shape
    Q = ports.shape[1]
    b = (side_b[:, :, None] & ports[:, None, :]).reshape(G, N * Q)
    with exact_fp32():
        counts = side_a.to(_F).T @ b.to(_F)
    return (counts > 0).reshape(N, N, Q)


def _policy_or(values: torch.Tensor, pol: torch.Tensor, n_pol: int) -> torch.Tensor:
    """OR grant rows [G, X] into per-policy rows [P, X]."""
    summed = torch.zeros(
        (n_pol, values.shape[1]), dtype=torch.int32, device=values.device
    )
    summed.index_add_(0, pol.long(), values.to(torch.int32))
    return summed > 0


def k8s_reach(
    pod_kv: torch.Tensor,
    pod_key: torch.Tensor,
    pod_ns: torch.Tensor,
    ns_kv: torch.Tensor,
    ns_key: torch.Tensor,
    pol_sel: SelectorEnc,
    pol_ns: torch.Tensor,
    pol_affects_ingress: torch.Tensor,
    pol_affects_egress: torch.Tensor,
    ingress: GrantBlock,
    egress: GrantBlock,
    restrict_bank: Optional[torch.Tensor] = None,  # bool [B, N]
    *,
    self_traffic: bool,
    default_allow_unselected: bool,
    direction_aware_isolation: bool,
) -> K8sOut:
    """Full NetworkPolicy reachability over (pods × pods × port-atoms)."""
    n_pol = pol_ns.shape[0]
    N = pod_kv.shape[0]

    # selected_by_pol(pod, pol): podSelector ∧ policy namespace
    selected = match_selectors(pol_sel, pod_kv, pod_key)
    selected &= pol_ns[:, None] == pod_ns[None, :]

    if direction_aware_isolation:
        sel_ing = selected & pol_affects_ingress[:, None]
        sel_eg = selected & pol_affects_egress[:, None]
    else:
        # reference compat: kubesv never consults policyTypes
        sel_ing = selected
        sel_eg = selected
    ing_iso = sel_ing.any(dim=0)
    eg_iso = sel_eg.any(dim=0)

    def allow(block: GrantBlock, dir_selected: torch.Tensor, is_ingress: bool):
        peers = _grant_peers(block, pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns)
        targets = dir_selected[block.pol.long()]  # [G, N]
        src, dst = (peers, targets) if is_ingress else (targets, peers)
        if block.dst_restrict is not None:
            # named-port resolution: each grant reaches only the dst pods in
            # its restriction row
            dst = dst & restrict_bank[block.dst_restrict.long()]
        return _grant_contract(src, dst, block.ports), peers

    ing_allow, ing_peers = allow(ingress, sel_ing, True)
    eg_allow, eg_peers = allow(egress, sel_eg, False)

    if default_allow_unselected:
        ing_ok = ing_allow | ~ing_iso[None, :, None]
        eg_ok = eg_allow | ~eg_iso[:, None, None]
    else:
        ing_ok = ing_allow
        eg_ok = eg_allow

    reach_pq = ing_ok & eg_ok
    if self_traffic:
        eye = torch.eye(N, dtype=torch.bool, device=pod_kv.device)[:, :, None]
        reach_pq |= eye
    reach = reach_pq.any(dim=-1)

    # per-policy direction-swapped src/dst edge sets for the policy queries
    ing_src = _policy_or(ing_peers, ingress.pol, n_pol)
    eg_dst = _policy_or(eg_peers, egress.pol, n_pol)
    has_ing_grant = _policy_or(
        torch.ones_like(ingress.pol, dtype=torch.bool)[:, None], ingress.pol, n_pol
    )
    has_eg_grant = _policy_or(
        torch.ones_like(egress.pol, dtype=torch.bool)[:, None], egress.pol, n_pol
    )
    if direction_aware_isolation:
        # rules of a direction a policy's policyTypes exclude are inert
        ing_src &= pol_affects_ingress[:, None]
        eg_dst &= pol_affects_egress[:, None]
    src_sets = ing_src | (sel_eg & has_eg_grant)
    dst_sets = eg_dst | (sel_ing & has_ing_grant)

    return K8sOut(
        reach=reach,
        reach_ports=reach_pq,
        selected=selected,
        ingress_isolated=ing_iso,
        egress_isolated=eg_iso,
        src_sets=src_sets,
        dst_sets=dst_sets,
    )
