"""Mesh-sharded dense verification (SPMD over the ``(pods, grants)`` mesh).

The port of ``kubernetes_verification_tpu.parallel.sharded_ops``: the dense
solves of ``ops/reach.py`` re-expressed over the mesh of ``parallel/mesh.py``.
Every rank runs the body of the JAX package's ``shard_map`` on its slices:

* pod-indexed arrays split on their pod axis: rank ``(p, g)`` owns source
  rows ``p·n_loc .. (p+1)·n_loc`` of the N×N matrix end to end;
* the grant stack (flattened policy×rule×peer triples) splits on the
  ``grants`` axis; each rank evaluates its grant slice against its pod
  block, destination-side blocks come from one gather over ``pods``, and
  the OR over grants is an int32 sum over ``grants`` followed by ``> 0``
  (the JAX package sums float32 counts; int32 keeps every sum exact);
* the transitive closure squares row blocks against the gathered matrix.

Padding as in the JAX package: N pads to a multiple of the pod-axis size
with label-less pods in namespace −1, G to a multiple of the grant-axis
size with inert rows of the sink policy slot P (whose selection row and
namespace here are an explicit zero row and namespace −2, where the JAX
package's gathers clamp to slot P−1: a sink grant peers and selects
nothing either way). Pad rows and columns are masked out of every output,
and every rank returns the same global NumPy outputs, trimmed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..encode.encoder import EncodedCluster, EncodedKano, GrantBlock
from ..observe.introspect import maybe_publish
from ..ops.closure import bool_dot
from ..ops.match import as_tensors, match_selectors, subset_match
from ..ops.padding import pad_grants, pad_pods, pad_rows, pad_selector_rows
from ..ops.reach import K8sOut, KanoOut, _grant_peers
from ..ops.tiled import _rows, _with_sink
from .mesh import GRANT_AXIS, POD_AXIS, Mesh, all_gather, pad_amount, psum, rank_slice

__all__ = [
    "pad_pods",
    "pad_grants",
    "pad_selector_rows",
    "sharded_k8s_reach",
    "sharded_kano_reach",
    "sharded_closure",
]

_I8 = torch.int8
_I32 = torch.int32


def local_grants(block: GrantBlock, mesh: Mesh, pods: slice) -> GrantBlock:
    """This rank's grant slice of a padded host ``GrantBlock`` (rows split
    over ``grants``), with ``ip_match`` — the one leaf with a pod axis —
    cut to the rank's pod columns too, on the rank's device."""
    rows = rank_slice(mesh, GRANT_AXIS, block.pol.shape[0])
    local = _rows(block, rows.start, rows.stop)
    if local.ip_match is not None:
        local = dataclasses.replace(local, ip_match=local.ip_match[:, pods])
    return as_tensors(local, mesh.device)


def _t(x, mesh: Mesh) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x), device=mesh.device)


def _dot_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 [X, Y] = aᵀ·b for bool [G, X] × [G, Y] (contract the leading
    axis), as one int8 ``bool_dot`` on K-contiguous copies."""
    return bool_dot(a.t().to(_I8).contiguous(), b.t().to(_I8).contiguous())


def _segment_or(mesh: Mesh, values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """bool [n, X]: OR of the rows of ``values`` [G_loc, X] per segment id,
    over the rank's grant slice, then over ``grants`` (int32 sum, ``> 0``)."""
    summed = torch.zeros((n, values.shape[1]), dtype=_I32, device=values.device)
    summed.index_add_(0, seg.long(), values.to(_I32))
    return psum(mesh, summed, GRANT_AXIS) > 0


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` [P, ...] with an all-False row for the sink policy slot P."""
    return torch.cat([x, x.new_zeros((1, *x.shape[1:]))])


def _k8s_local(
    mesh: Mesh,
    pod_kv, pod_key, pod_ns, valid,
    ns_kv, ns_key, pol_sel, pol_ns, aff_ing, aff_eg,
    ingress: GrantBlock, egress: GrantBlock,
    bank,  # bool [B, Np] — named-port dst restrictions (row 0 ones)
    *,
    self_traffic: bool,
    default_allow_unselected: bool,
    direction_aware_isolation: bool,
    n_pol: int,
) -> K8sOut:
    """SPMD body: pod arrays are the rank's row block, grant blocks its
    grant slice, everything else whole. Returns the rank's source-row block
    of every output (columns of the ``[P, N]`` ones)."""
    n_loc = pod_kv.shape[0]
    row0 = mesh.coords[POD_AXIS] * n_loc

    selected_loc = match_selectors(pol_sel, pod_kv, pod_key)
    selected_loc &= pol_ns[:, None] == pod_ns[None, :]
    if direction_aware_isolation:
        sel_ing_loc = selected_loc & aff_ing[:, None]
        sel_eg_loc = selected_loc & aff_eg[:, None]
    else:
        sel_ing_loc = selected_loc
        sel_eg_loc = selected_loc
    sel_ing_full = all_gather(mesh, sel_ing_loc, POD_AXIS, dim=1)  # [P, N]
    ing_iso_full = sel_ing_full.any(dim=0)
    eg_iso_loc = sel_eg_loc.any(dim=0)
    valid_full = all_gather(mesh, valid, POD_AXIS, dim=0)
    N = valid_full.shape[0]
    pol_ns_ext = _with_sink(pol_ns)

    def dir_allow(block: GrantBlock, is_ingress: bool):
        # peers against the rank's pod block only — [G_loc, n_loc]
        peers_loc = _grant_peers(block, pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns_ext)
        pol = block.pol.long()
        if is_ingress:
            # allow[src, dst]: src is the peer (local rows), dst the selected
            # pods (the whole row: the gathered selection)
            a = peers_loc
            b = _with_zero_row(sel_ing_full)[pol]  # [G_loc, N]
        else:
            a = _with_zero_row(sel_eg_loc)[pol]  # [G_loc, n_loc]
            b = all_gather(mesh, peers_loc, POD_AXIS, dim=1)
        if block.dst_restrict is not None:
            b = b & bank[block.dst_restrict.long()]
        gq = block.ports  # [G_loc, Q]
        G, Q = gq.shape
        b_pq = (b[:, :, None] & gq[:, None, :]).reshape(G, N * Q)
        counts = psum(mesh, _dot_t(a, b_pq), GRANT_AXIS)  # int32 [n_loc, N·Q]
        return (counts > 0).reshape(n_loc, N, Q), peers_loc

    ing_allow, ing_peers_loc = dir_allow(ingress, True)
    eg_allow, eg_peers_loc = dir_allow(egress, False)

    if default_allow_unselected:
        ing_ok = ing_allow | ~ing_iso_full[None, :, None]
        eg_ok = eg_allow | ~eg_iso_loc[:, None, None]
    else:
        ing_ok = ing_allow
        eg_ok = eg_allow
    reach_pq = ing_ok & eg_ok
    if self_traffic:
        gidx = row0 + torch.arange(n_loc, device=pod_kv.device)
        eye = gidx[:, None] == torch.arange(N, device=pod_kv.device)[None, :]
        reach_pq |= eye[:, :, None]
    reach_pq &= valid[:, None, None] & valid_full[None, :, None]
    reach = reach_pq.any(dim=-1)

    # per-policy src/dst edge sets (the sink slot n_pol holds the pad grants)
    ing_src = _segment_or(mesh, ing_peers_loc, ingress.pol, n_pol + 1)[:-1]
    eg_dst = _segment_or(mesh, eg_peers_loc, egress.pol, n_pol + 1)[:-1]
    ones_i = torch.ones((ingress.pol.shape[0], 1), dtype=torch.bool, device=pod_kv.device)
    ones_e = torch.ones((egress.pol.shape[0], 1), dtype=torch.bool, device=pod_kv.device)
    has_ing = _segment_or(mesh, ones_i, ingress.pol, n_pol + 1)[:-1, 0]
    has_eg = _segment_or(mesh, ones_e, egress.pol, n_pol + 1)[:-1, 0]
    if direction_aware_isolation:
        ing_src &= aff_ing[:, None]
        eg_dst &= aff_eg[:, None]
    src_sets = (ing_src | (sel_eg_loc & has_eg[:, None])) & valid[None, :]
    dst_sets = (eg_dst | (sel_ing_loc & has_ing[:, None])) & valid[None, :]

    return K8sOut(
        reach=reach,
        reach_ports=reach_pq,
        selected=selected_loc & valid[None, :],
        ingress_isolated=sel_ing_loc.any(dim=0) & valid,
        egress_isolated=eg_iso_loc & valid,
        src_sets=src_sets,
        dst_sets=dst_sets,
    )


def _closure_local(mesh: Mesh, rows: torch.Tensor, steps: int) -> torch.Tensor:
    """Row-block transitive closure: each squaring gathers the whole matrix
    over ``pods`` and contracts the rank's rows against it."""
    r = rows
    for _ in range(steps):
        full = all_gather(mesh, r, POD_AXIS, dim=0)
        r = r | (bool_dot(r.to(_I8), full.t().to(_I8).contiguous()) > 0)
    return r


def _closure_steps(n_total: int) -> int:
    return max(1, math.ceil(math.log2(max(n_total, 2))))


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def sharded_k8s_reach(
    mesh: Mesh,
    enc: EncodedCluster,
    *,
    self_traffic: bool,
    default_allow_unselected: bool,
    direction_aware_isolation: bool,
    with_closure: bool,
) -> Tuple[K8sOut, Optional[np.ndarray]]:
    """Pad, slice, solve, gather, unpad, on every rank of ``mesh``. The
    outputs are NumPy, exactly equal to the single-device ``k8s_reach`` on
    the same encoding (and to the JAX package's ``sharded_k8s_reach``)."""
    dp = mesh.shape[POD_AXIS]
    mp = mesh.shape[GRANT_AXIS]
    n = enc.n_pods
    n_pad = pad_amount(n, dp)
    Np = n + n_pad
    pod_kv, pod_key, pod_ns = pad_pods(enc.pod_kv, enc.pod_key, enc.pod_ns, n_pad)
    valid = np.arange(Np) < n
    ingress = pad_grants(enc.ingress, pad_amount(enc.ingress.n, mp), enc.n_policies, n_pad)
    egress = pad_grants(enc.egress, pad_amount(enc.egress.n, mp), enc.n_policies, n_pad)
    if enc.restrict_bank is not None:
        bank_full = np.zeros((enc.restrict_bank.shape[0], Np), dtype=bool)
        bank_full[:, :n] = enc.restrict_bank
    else:
        bank_full = np.ones((1, Np), dtype=bool)

    rows = rank_slice(mesh, POD_AXIS, Np)
    # the JAX package's publish site: a rank's sweep has no cost function
    # of its own (its int8 products publish their exact counts through
    # bool_dot), so no report is published for it
    maybe_publish("sharded", "k8s_reach", None, (enc, rows))
    out = _k8s_local(
        mesh,
        _t(pod_kv[rows], mesh), _t(pod_key[rows], mesh), _t(pod_ns[rows], mesh),
        _t(valid[rows], mesh),
        _t(enc.ns_kv, mesh), _t(enc.ns_key, mesh),
        as_tensors(enc.pol_sel, mesh.device), _t(enc.pol_ns, mesh),
        _t(enc.pol_affects_ingress, mesh), _t(enc.pol_affects_egress, mesh),
        local_grants(ingress, mesh, rows), local_grants(egress, mesh, rows),
        _t(bank_full, mesh),
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
        direction_aware_isolation=direction_aware_isolation,
        n_pol=enc.n_policies,
    )
    closure = None
    if with_closure:
        maybe_publish("sharded", "closure", None, (out.reach,))
        closed = _closure_local(mesh, out.reach, _closure_steps(Np))
        closure = _host(all_gather(mesh, closed, POD_AXIS, dim=0))[:n, :n]

    def rows_of(x):  # a P(POD_AXIS, ...) output
        return _host(all_gather(mesh, x, POD_AXIS, dim=0))[:n]

    def cols_of(x):  # a P(None, POD_AXIS) output
        return _host(all_gather(mesh, x, POD_AXIS, dim=1))[:, :n]

    out_np = K8sOut(
        reach=rows_of(out.reach)[:, :n],
        reach_ports=rows_of(out.reach_ports)[:, :n],
        selected=cols_of(out.selected),
        ingress_isolated=rows_of(out.ingress_isolated),
        egress_isolated=rows_of(out.egress_isolated),
        src_sets=cols_of(out.src_sets),
        dst_sets=cols_of(out.dst_sets),
    )
    return out_np, closure


def _kano_local(mesh: Mesh, pod_kv, valid, src_req, src_imp, dst_req, dst_imp) -> KanoOut:
    src_loc = subset_match(src_req, pod_kv) & ~src_imp[:, None]  # [P_loc, n_loc]
    dst_loc = subset_match(dst_req, pod_kv) & ~dst_imp[:, None]
    dst_full = all_gather(mesh, dst_loc, POD_AXIS, dim=1)  # [P_loc, N]
    counts = psum(mesh, _dot_t(src_loc, dst_full), GRANT_AXIS)  # [n_loc, N]
    valid_full = all_gather(mesh, valid, POD_AXIS, dim=0)
    reach = (counts > 0) & valid[:, None] & valid_full[None, :]
    return KanoOut(
        reach=reach,
        src_sets=src_loc & valid[None, :],
        dst_sets=dst_loc & valid[None, :],
    )


def sharded_kano_reach(
    mesh: Mesh, enc: EncodedKano, *, with_closure: bool
) -> Tuple[KanoOut, Optional[np.ndarray]]:
    """The kano matrix build over the mesh: policies split over
    ``grants``, containers over ``pods``. NumPy outputs on every rank."""
    dp = mesh.shape[POD_AXIS]
    mp = mesh.shape[GRANT_AXIS]
    n, p = enc.n_pods, enc.n_policies
    n_pad = pad_amount(n, dp)
    p_pad = pad_amount(p, mp)
    Np = n + n_pad
    pod_kv = pad_rows(enc.pod_kv, n_pad)
    valid = np.arange(Np) < n
    rows = rank_slice(mesh, POD_AXIS, Np)
    pols = rank_slice(mesh, GRANT_AXIS, p + p_pad)
    maybe_publish("sharded", "kano_reach", None, (enc, rows, pols))
    out = _kano_local(
        mesh,
        _t(pod_kv[rows], mesh), _t(valid[rows], mesh),
        _t(pad_rows(enc.src_req, p_pad)[pols], mesh),
        _t(pad_rows(enc.src_impossible, p_pad, fill=True)[pols], mesh),
        _t(pad_rows(enc.dst_req, p_pad)[pols], mesh),
        _t(pad_rows(enc.dst_impossible, p_pad, fill=True)[pols], mesh),
    )
    closure = None
    if with_closure:
        maybe_publish("sharded", "closure", None, (out.reach,))
        closed = _closure_local(mesh, out.reach, _closure_steps(Np))
        closure = _host(all_gather(mesh, closed, POD_AXIS, dim=0))[:n, :n]

    def sets(x):  # P(GRANT_AXIS, POD_AXIS)
        x = all_gather(mesh, x, POD_AXIS, dim=1)
        return _host(all_gather(mesh, x, GRANT_AXIS, dim=0))[:p, :n]

    out_np = KanoOut(
        reach=_host(all_gather(mesh, out.reach, POD_AXIS, dim=0))[:n, :n],
        src_sets=sets(out.src_sets),
        dst_sets=sets(out.dst_sets),
    )
    return out_np, closure


def sharded_closure(mesh: Mesh, reach: np.ndarray) -> np.ndarray:
    """Standalone sharded transitive closure of a bool ``[n, n]`` matrix,
    on every rank."""
    dp = mesh.shape[POD_AXIS]
    n = reach.shape[0]
    n_pad = pad_amount(n, dp)
    padded = np.pad(np.asarray(reach, dtype=bool), ((0, n_pad), (0, n_pad)))
    rows = rank_slice(mesh, POD_AXIS, n + n_pad)
    maybe_publish("sharded", "closure", None, (padded,))
    closed = _closure_local(mesh, _t(padded[rows], mesh), _closure_steps(n + n_pad))
    return _host(all_gather(mesh, closed, POD_AXIS, dim=0))[:n, :n]
