"""The port-bitmap path of the tiled solve (BASELINE config 4), in PyTorch.

The port of the port-aware half of ``kubernetes_verification_tpu/ops/
tiled.py``. A multi-atom encoding (``encode_cluster(compute_ports=True)`` with
port specs) solves through a **mask-group decomposition** instead of one pass
per port atom:

* each grant's port mask is split into maximal atom runs
  (``_split_grant_ports``), so the distinct ported masks R track the distinct
  port specs;
* grants group into *virtual policies* (VPs), distinct (policy, mask,
  named-port restriction) triples, laid out per direction as ``[ported
  segments | full block | sink row]`` (``_build_port_layout``);
* ``∃q: GI_q ∧ GE_q`` over nonnegative counts equals the OR over mask pairs
  that overlap of ``GI_m1 ∧ GE_m2``, so R segment products per direction
  replace Q atom passes (``_mask_group_conj``).

Two routes compute the same int32 [N, N/32] words:

* the **torch sweep** (``_tiled_ports_step``, the counterpart of the JAX
  package's XLA ``_tiled_ports_step``): dst tiles of exact float32 segment
  products and boolean plane ORs; the CPU route, and ``use_kernel=False``;
* the **fused kernel** (``_tiled_ports_fused_step``, the counterpart of
  ``_tiled_ports_fused_step``): the src and dst VP rows written once into two
  K-contiguous int8 ``[N, K']`` operands, then one launch of
  ``ops/kernels.py::fused_ports_reach`` over all N (the TPU's 2048-column
  stripes existed only for VMEM).

The host layout functions give the JAX package's arrays byte for byte, with
whole-array numpy on packed row keys in place of its per-grant loops and its
structured-row sort; they raise ``ConfigError`` where it raises
``ValueError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..encode.encoder import EncodedCluster, GrantBlock
from ..observe.spans import trace
from ..resilience.errors import ConfigError
from .bits import or_diagonal, pack_bool_cols
from .kernels import K_STEP, N_TILE, check_mask_count, fused_ports_reach
from .match import exact_fp32
from .tiled import HostArgs, _host_args, _peers_by_slot, _put, _select_maps, _with_sink

__all__ = [
    "FusedArgs",
    "PortLayout",
    "PortOperands",
    "VPArrays",
    "engine_fused_args",
    "ports_step",
    "port_kernel_operands",
    "port_layout_stats",
]

_I8 = torch.int8
_I32 = torch.int32
_F32 = torch.float32

#: cap on R, the distinct ported masks after run-splitting, on either route
#: (the JAX package's ``_MAX_PORT_MASKS``); the kernel route's own limit,
#: ``kernels.FUSED_MAX_MASKS``, is lower
_MAX_PORT_MASKS = 128

#: byte budget for the sweep's per-tile mask planes (R bool [N, tile]); bounds
#: the dst tile via R·N·tile ≤ budget (the JAX package's ``_PORT_SLAB_BUDGET``)
_PORT_SLAB_BUDGET = int(1.2e9)


# ---------------------------------------------------------------------------
# host layout (numpy)
# ---------------------------------------------------------------------------


def _take_rows(block, idx: np.ndarray):
    """Rows ``idx`` (a fancy index) of every leaf of a ``GrantBlock`` or its
    nested ``SelectorEnc``s: ``ports``, ``ip_match``, ``dst_restrict``,
    ``rule_id`` and ``peer_id`` come along; ``None`` leaves stay ``None``."""
    vals = {}
    for f in dataclasses.fields(block):
        v = getattr(block, f.name)
        if dataclasses.is_dataclass(v):
            v = _take_rows(v, idx)
        elif v is not None:
            v = np.asarray(v)[idx]
        vals[f.name] = v
    return type(block)(**vals)


def _unique_rows(ports: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(first, inverse)`` over the distinct rows of the bool [G, Q]
    ``ports``, in ``np.unique(axis=0)``'s order: ``ports[first]`` is its
    ``masks`` (from each row's first occurrence) and ``inverse`` its
    ``return_inverse``.

    Each row is keyed by its atoms packed MSB-first into ⌈Q/64⌉ big-endian
    uint64 words, zero-filled past atom Q − 1. Compared word by word, the
    first word first, keys order rows lexicographically (False < True), as
    ``np.unique(axis=0)``'s structured-row sort does, and two rows share a
    key exactly when they are equal; one stable sort of the keys groups
    them."""
    G, Q = ports.shape
    W = max(1, -(-Q // 64))
    packed = np.zeros((G, 8 * W), dtype=np.uint8)
    packed[:, : -(-Q // 8)] = np.packbits(ports, axis=1, bitorder="big")
    keys = packed.view(">u8").astype(np.uint64)
    order = np.lexsort(keys.T[::-1])  # the first word is the primary key
    sk = keys[order]
    new = np.ones(G, dtype=bool)
    new[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    inverse = np.empty(G, dtype=np.intp)
    inverse[order] = np.cumsum(new) - 1
    return order[new], inverse


def _split_grant_ports(block: GrantBlock) -> GrantBlock:
    """Split each grant's port mask into maximal consecutive atom runs,
    duplicating the grant row once per run (JAX ``ops/tiled.py::
    _split_grant_ports``). Exact by union semantics: ``allow = ∨_g peers_g ∧
    ports_g`` is unchanged under any partition of a grant's atom set; full
    masks are one run and stay whole.

    Row order is the JAX loop's: grants in order, a split grant's runs in
    ascending atom order, so every leaf comes out byte-identical. A block
    with no multi-run row comes back as the same object."""
    ports = np.asarray(block.ports)
    G, Q = ports.shape
    no = np.zeros((G, 1), dtype=bool)
    starts = ports & ~np.concatenate([no, ports[:, :-1]], axis=1)
    n_runs = starts.sum(axis=1)
    split = n_runs > 1
    if not split.any():
        return block
    reps = np.where(split, n_runs, 1)  # an empty mask keeps its one row
    rows = np.repeat(np.arange(G), reps)
    ends = ports & ~np.concatenate([ports[:, 1:], no], axis=1)
    # row-major: the k-th start of the split rows pairs with their k-th end
    _, lo = np.nonzero(starts[split])
    _, hi = np.nonzero(ends[split])
    atoms = np.arange(Q)
    masks = ports[rows]
    masks[np.repeat(split, reps)] = (atoms >= lo[:, None]) & (atoms <= hi[:, None])
    return dataclasses.replace(_take_rows(block, rows), ports=masks)


def _split_and_check_port_masks(
    ing_block: GrantBlock, eg_block: GrantBlock, limit: int
) -> Tuple[GrantBlock, GrantBlock, int]:
    """Run-split both directions' grant port masks and enforce the cap on R,
    the distinct ported masks (JAX ``_split_and_check_port_masks``): R
    counts the distinct split rows by their packed keys (``_unique_rows``),
    all-False and all-True rows left out, so it is the JAX set's size."""
    ing_block = _split_grant_ports(ing_block)
    eg_block = _split_grant_ports(eg_block)
    ports = np.concatenate([ing_block.ports, eg_block.ports], 0)
    ported = ports.any(axis=1) & ~ports.all(axis=1)
    R = max(1, len(_unique_rows(ports[ported])[0]))
    if R > limit:
        raise ConfigError(
            f"{R} distinct ported atom masks after run-splitting exceeds the "
            f"port path's cap of {limit}: the mask-group solve does R segment "
            "products + O(R²) combines per tile. Coarsen the cluster's port "
            "specs, or verify with compute_ports=False."
        )
    return ing_block, eg_block, R


class PortLayout(NamedTuple):
    """The virtual-policy layout of the port path (JAX ``PortLayout``).

    Per direction the VP axis is ``[ported segments | full block | sink
    row]``: ``seg_*`` holds one ``(start, length)`` per ported mask (in the
    order of ``ov_rows``), ``full_*`` the full-coverage block's.
    ``ov_rows[m1]`` lists the ported masks that overlap mask ``m1``."""

    seg_i: Tuple[Tuple[int, int], ...]
    seg_e: Tuple[Tuple[int, int], ...]
    full_i: Tuple[int, int]
    full_e: Tuple[int, int]
    ov_rows: Tuple[Tuple[int, ...], ...]

    @property
    def n_masks(self) -> int:
        return len(self.ov_rows)


class VPArrays(NamedTuple):
    """The per-direction virtual-policy arrays of ``_build_port_layout``
    (``pol_*``: each VP row's policy, ``res_*``: its restriction-bank row,
    ``slot_*``: each grant's VP row) and ``bank8``, the int8 [B, N]
    restriction bank (row 0: no restriction). numpy, or tensors after
    ``_put``."""

    pol_i: Any
    res_i: Any
    slot_i: Any
    pol_e: Any
    res_e: Any
    slot_e: Any
    bank8: Any


def _build_port_layout(
    ing_ports: np.ndarray,  # bool [Gi, Q]
    eg_ports: np.ndarray,  # bool [Ge, Q]
    ing_pol: np.ndarray,  # int32 [Gi]
    eg_pol: np.ndarray,  # int32 [Ge]
    sink_pol: int,
    ing_restrict: Optional[np.ndarray] = None,  # int32 [Gi] | None
    eg_restrict: Optional[np.ndarray] = None,  # int32 [Ge] | None
    headroom: int = 0,
) -> tuple:
    """Group grants into (policy, port mask, dst restriction) virtual
    policies (JAX ``_build_port_layout``).

    Returns ``(layout, vp_pol_i, vp_restrict_i, vp_slot_i, vp_pol_e,
    vp_restrict_e, vp_slot_e, ported_masks)``: ``vp_pol_*[row]`` is each VP
    row's policy (pad and sink rows: ``sink_pol``), ``vp_restrict_*[row]``
    its restriction-bank row (0 = none), ``vp_slot_*[g]`` the VP row of
    grant ``g``, and ``ported_masks`` the bool [R, Q] masks in segment
    order. Empty-mask grants go to the sink row; segments are padded to a
    multiple of 8 with sink rows (plus ``headroom`` free rows).

    Masks group by their packed row keys (``_unique_rows``), whose order is
    ``np.unique(axis=0)``'s lexicographic row order, and the VP rows are
    placed from offsets, so every output is byte-identical to the JAX
    package's."""
    all_ports = np.concatenate([ing_ports, eg_ports], axis=0)
    first, inverse = _unique_rows(all_ports)
    masks = all_ports[first]
    # one full and one empty row at most, as masks are distinct
    full = masks.all(axis=1)
    ported = np.nonzero(~full & masks.any(axis=1))[0]
    pm = masks[ported].astype(np.int64)  # [R, Q]
    R = len(ported)
    ov = (pm @ pm.T) > 0 if R else np.zeros((0, 0), dtype=bool)
    ov_rows = tuple(tuple(int(j) for j in np.nonzero(ov[r])[0]) for r in range(R))
    # mask id → bucket: ported rank r, then full (R), sink (R + 1)
    bucket_of_mask = np.full(masks.shape[0], R + 1, dtype=np.int64)
    bucket_of_mask[ported] = np.arange(R)
    bucket_of_mask[full] = R

    def restrict_max(x):
        return int(x.max()) if x is not None and len(x) else 0

    n_restrict = 1 + max(restrict_max(ing_restrict), restrict_max(eg_restrict))

    def one_direction(pol, mask_ids, restrict):
        if restrict is None:
            restrict = np.zeros(len(pol), dtype=np.int64)
        bucket = bucket_of_mask[mask_ids]
        keys = (bucket * (sink_pol + 1) + pol) * n_restrict + restrict
        uniq, slot_of_grant = np.unique(keys, return_inverse=True)
        slot_of_grant = slot_of_grant.reshape(-1)
        vp_restricts = uniq % n_restrict
        vp_bp = uniq // n_restrict
        vp_bucket = vp_bp // (sink_pol + 1)
        vp_pols = vp_bp % (sink_pol + 1)
        # keys sort bucket-major, so bucket b's VPs are one run of uniq; each
        # block is padded to a multiple of 8 (plus headroom) with sink rows
        count = np.bincount(vp_bucket, minlength=R + 2)
        blocks = count[: R + 1]
        pad = np.where(
            (blocks > 0) | (headroom > 0), (-(blocks + headroom)) % 8 + headroom, 0
        )
        length = blocks + pad
        start = np.concatenate([[0], np.cumsum(length)])  # start[R + 1]: sink row
        first_vp = np.concatenate([[0], np.cumsum(count)])
        # a VP's row: its rank in uniq plus the pad rows of the buckets before
        row_of_vp = np.arange(len(uniq)) - first_vp[vp_bucket] + start[vp_bucket]
        sink = vp_bucket == R + 1
        row_of_vp[sink] = start[R + 1]
        vp_pol_rows = np.full(start[R + 1] + 1, sink_pol, dtype=np.int32)
        vp_res_rows = np.zeros(start[R + 1] + 1, dtype=np.int32)
        vp_pol_rows[row_of_vp[~sink]] = vp_pols[~sink]
        vp_res_rows[row_of_vp[~sink]] = vp_restricts[~sink]
        spans = [(int(s), int(l)) for s, l in zip(start, length)]
        return (
            tuple(spans[:R]),
            spans[R],
            vp_pol_rows,
            vp_res_rows,
            row_of_vp[slot_of_grant].astype(np.int32),
        )

    gi = len(ing_pol)
    seg_i, full_i, vp_pol_i, vp_res_i, vp_slot_i = one_direction(
        ing_pol, inverse[:gi], ing_restrict
    )
    seg_e, full_e, vp_pol_e, vp_res_e, vp_slot_e = one_direction(
        eg_pol, inverse[gi:], eg_restrict
    )
    layout = PortLayout(
        seg_i=seg_i, seg_e=seg_e, full_i=full_i, full_e=full_e, ov_rows=ov_rows
    )
    return (
        layout, vp_pol_i, vp_res_i, vp_slot_i, vp_pol_e, vp_res_e, vp_slot_e,
        pm.astype(bool),
    )


def _padded_k(segs: list) -> int:
    """K' of the fused operands: each segment padded on its own to a
    ``K_STEP`` multiple; one inert step when there are none."""
    return sum(l + (-l) % K_STEP for _, _, l, _, _ in segs) or K_STEP


def _segments(layout: PortLayout) -> list:
    """The K-axis order of the fused route: ``(dirn, start, length, kind,
    slab)`` for ``[egress ported segments | egress full block | ingress
    ported segments | ingress full block]``, empty segments skipped (JAX
    ``_tiled_ports_fused_step``). Kinds: 0 egress mask, 1 egress full, 2
    ingress mask, 3 ingress full; the full blocks' slab is R."""
    R = layout.n_masks
    out = [("e", s, l, 0, m) for m, (s, l) in enumerate(layout.seg_e) if l]
    if layout.full_e[1]:
        out.append(("e", *layout.full_e, 1, R))
    out += [("i", s, l, 2, m) for m, (s, l) in enumerate(layout.seg_i) if l]
    if layout.full_i[1]:
        out.append(("i", *layout.full_i, 3, R))
    return out


# ---------------------------------------------------------------------------
# device maps
# ---------------------------------------------------------------------------


def _vp_maps(
    a: HostArgs, vp: VPArrays, *, chunk: int, direction_aware_isolation: bool
):
    """The selections with the sink policy's zero row appended, the
    isolation vectors, and the per-VP peer maps: ``(selected8, sel_ing_ext,
    sel_eg_ext, ing_iso, eg_iso, vp_peers_i, vp_peers_e)``."""
    selected8, sel_ing8, sel_eg8, ing_iso, eg_iso = _select_maps(
        a, direction_aware_isolation
    )
    zrow = sel_ing8.new_zeros((1, sel_ing8.shape[1]))  # the sink policy row P
    sel_ing_ext = torch.cat([sel_ing8, zrow])
    sel_eg_ext = torch.cat([sel_eg8, zrow])
    del sel_ing8, sel_eg8
    pol_ns_ext = _with_sink(a.pol_ns)
    vp_peers_i = _peers_by_slot(
        a.ingress, vp.slot_i, vp.pol_i.shape[0], chunk,
        a.pod_kv, a.pod_key, a.ns_kv, a.ns_key, a.pod_ns, pol_ns_ext,
    )
    vp_peers_e = _peers_by_slot(
        a.egress, vp.slot_e, vp.pol_e.shape[0], chunk,
        a.pod_kv, a.pod_key, a.ns_kv, a.ns_key, a.pod_ns, pol_ns_ext,
    )
    return selected8, sel_ing_ext, sel_eg_ext, ing_iso, eg_iso, vp_peers_i, vp_peers_e


def _mask_group_conj(layout: PortLayout, ing_dot, eg_dot, false_t):
    """The mask-group port conjunction ``∃q: GI_q ∧ GE_q`` over a dst tile
    (JAX ``_mask_group_conj``). ``ing_dot(start, length)`` /
    ``eg_dot(start, length)`` return the bool tiles of one VP row range;
    returns ``(conj, gi_any, ge_any)``."""
    fs_i, fl_i = layout.full_i
    fs_e, fl_e = layout.full_e
    gi_full = ing_dot(fs_i, fl_i) if fl_i else false_t
    ge_full = eg_dot(fs_e, fl_e) if fl_e else false_t
    ge_m = [eg_dot(s, l) if l else false_t for (s, l) in layout.seg_e]
    gi_any = gi_full
    ge_any = ge_full
    for g in ge_m:
        ge_any = ge_any | g
    conj = false_t
    for m1, (s, l) in enumerate(layout.seg_i):
        if not l:
            continue
        gi = ing_dot(s, l)
        gi_any = gi_any | gi
        comp = ge_full  # egress on any overlapping ported mask, or full
        for m2 in layout.ov_rows[m1]:
            comp = comp | ge_m[m2]
        conj = conj | (gi & comp)
    # full-mask ingress overlaps every egress mask
    conj = conj | (gi_full & ge_any) | (gi_any & ge_full)
    return conj, gi_any, ge_any


def _tiled_ports_step(
    a: HostArgs,
    vp: VPArrays,
    *,
    layout: PortLayout,
    tile: int,
    chunk: int,
    self_traffic: bool,
    default_allow_unselected: bool,
    direction_aware_isolation: bool,
):
    """The torch mask-group sweep (JAX ``_tiled_ports_step``) over the device
    operands ``a`` and ``vp``.

    ``reach = (DI∧DE) ∨ (DI∧GE_any) ∨ (DE∧GI_any) ∨ (∃q: GI_q∧GE_q)``; the
    segment counts are exact float32 products (≤ K < 2²⁴, TF32 off), the src
    operands converted once. Spans: ``solve.maps``, then ``solve.kernel``
    over the dst tiles."""
    with trace("solve.maps"):
        selected8, sel_ing_ext, sel_eg_ext, ing_iso, eg_iso, vp_peers_i, vp_peers_e = (
            _vp_maps(a, vp, chunk=chunk,
                     direction_aware_isolation=direction_aware_isolation)
        )
        vp_pol_i, vp_res_i, bank8 = vp.pol_i.long(), vp.res_i.long(), vp.bank8
        # named ports, egress: the dst operand is the peer map, gated per VP row
        vp_peers_e = vp_peers_e * bank8[vp.res_e.long()]
        src_i = vp_peers_i.to(_F32)  # [total_i, N]
        src_e = sel_eg_ext[vp.pol_e.long()].to(_F32)  # [total_e, N]
        del vp_peers_i
    N = src_i.shape[1]
    with trace("solve.kernel"):
        out = torch.empty((N, N // 32), dtype=_I32, device=src_i.device)
        for d0 in range(0, N, tile):
            d1 = d0 + tile
            sel_ing_t = sel_ing_ext[:, d0:d1]
            bank_t = bank8[:, d0:d1]
            vpe_t = vp_peers_e[:, d0:d1]
            false_t = torch.zeros((N, d1 - d0), dtype=torch.bool, device=out.device)

            def ing_dot(start: int, length: int) -> torch.Tensor:
                """GI of one VP row range; the dst operand (the policy's
                selection) gated by each VP's restriction row."""
                sl = slice(start, start + length)
                b = sel_ing_t[vp_pol_i[sl]] * bank_t[vp_res_i[sl]]
                with exact_fp32():
                    return (src_i[sl].T @ b.to(_F32)) > 0

            def eg_dot(start: int, length: int) -> torch.Tensor:
                sl = slice(start, start + length)
                with exact_fp32():
                    return (src_e[sl].T @ vpe_t[sl].to(_F32)) > 0

            r, gi_any, ge_any = _mask_group_conj(layout, ing_dot, eg_dot, false_t)
            if default_allow_unselected:
                di = ~ing_iso[None, d0:d1]
                de = ~eg_iso[:, None]
                r = r | (di & de) | (di & ge_any) | (de & gi_any)
            out[:, d0 // 32 : d1 // 32] = pack_bool_cols(r)
        if self_traffic:
            or_diagonal(out)
        out &= a.col_mask[None, :]
    return out, ing_iso, eg_iso, selected8 > 0


# ---------------------------------------------------------------------------
# the fused kernel route
# ---------------------------------------------------------------------------


def _overlap_table(layout: PortLayout, dev) -> torch.Tensor:
    """int64 [R]: bit m2 of entry m1 set where ported masks m1 and m2
    overlap, and bit R (the full egress block, which overlaps every mask)."""
    R = layout.n_masks
    check_mask_count(R)  # before the bits outgrow int64
    words = [sum(1 << m2 for m2 in row) | (1 << R) for row in layout.ov_rows]
    return torch.tensor(words, dtype=torch.int64, device=dev)


def _write_segments(
    layout: PortLayout, n: int, dev, rows
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused kernel's K-contiguous operands and its plan: ``(at, bt,
    plan)``. ``rows(dirn, start, length, slab)`` gives one segment's src-
    and dst-side rows as pod-major [n, length] tensors (views allowed),
    written straight into one preallocated int8 [n, K'] tensor per side;
    each segment starts on a ``K_STEP`` boundary and its pad columns stay
    zero. No segment at all: one inert zero step (JAX keeps one inert
    chunk)."""
    segs = _segments(layout)
    kp = _padded_k(segs)
    at = torch.zeros((n, kp), dtype=_I8, device=dev)
    bt = torch.zeros((n, kp), dtype=_I8, device=dev)
    plan, off = [], 0
    for dirn, s, l, kind, slab in segs:
        a, b = rows(dirn, s, l, slab)
        at[:, off : off + l] = a
        bt[:, off : off + l] = b
        del a, b
        off += l + (-l) % K_STEP
        plan.append((off // K_STEP, kind, slab))
    if not plan:
        plan = [(1, 0, 0)]
    return at, bt, torch.tensor(plan, dtype=_I32, device=dev)


def _fused_operands(
    layout: PortLayout, sel_ing_ext, sel_eg_ext, vp_peers_i, vp_peers_e,
    vp: VPArrays,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_write_segments`` of the one-shot solve: each segment's src rows
    (egress: ``sel_eg_ext[vp_pol_e]``; ingress: ``vp_peers_i``) and dst rows
    with the named-port gating folded in (egress: ``vp_peers_e ·
    bank8[vp_res_e]``; ingress: ``sel_ing_ext[vp_pol_i] · bank8[vp_res_i]``),
    gathered from the policy-level maps and transposed."""

    def rows(dirn, s, l, slab):
        sl = slice(s, s + l)
        if dirn == "e":
            a = sel_eg_ext[vp.pol_e[sl].long()]
            b = vp_peers_e[sl] * vp.bank8[vp.res_e[sl].long()]
        else:
            a = vp_peers_i[sl]
            b = sel_ing_ext[vp.pol_i[sl].long()] * vp.bank8[vp.res_i[sl].long()]
        return a.T, b.T

    return _write_segments(layout, sel_ing_ext.shape[1], sel_ing_ext.device, rows)


class FusedArgs(NamedTuple):
    """The operands of one ``fused_ports_reach`` call, in its order."""

    at: torch.Tensor
    bt: torch.Tensor
    plan: torch.Tensor
    ov: torch.Tensor
    niso_i: torch.Tensor
    niso_e: torch.Tensor


def _fused_inputs(
    a: HostArgs, vp: VPArrays, *, layout: PortLayout, chunk: int,
    direction_aware_isolation: bool,
):
    """From the device operands (as for ``_tiled_ports_step``) to the fused
    kernel's: ``(FusedArgs, ing_iso, eg_iso, selected8)``."""
    ov = _overlap_table(layout, vp.bank8.device)
    selected8, sel_ing_ext, sel_eg_ext, ing_iso, eg_iso, vp_peers_i, vp_peers_e = _vp_maps(
        a, vp, chunk=chunk, direction_aware_isolation=direction_aware_isolation
    )
    at, bt, plan = _fused_operands(
        layout, sel_ing_ext, sel_eg_ext, vp_peers_i, vp_peers_e, vp
    )
    niso_i = (~ing_iso).to(_I32)
    niso_e = (~eg_iso).to(_I32)
    return FusedArgs(at, bt, plan, ov, niso_i, niso_e), ing_iso, eg_iso, selected8


def engine_fused_args(
    layout: PortLayout, src: dict, dst: dict, niso_i: torch.Tensor,
    niso_e: torch.Tensor,
) -> FusedArgs:
    """The fused kernel's operands from the ports engine's resident VP maps
    (``packed_incremental_ports.py``), which are already gathered and gated:
    ``src[d][m]`` / ``dst[d][m]`` are the pod-major int8 [N, l] src- and
    dst-side rows of segment ``m`` of direction ``d`` (``"i"``, ``"e"``),
    the ported masks in ``layout`` order and then the full block (index R,
    the ``slab`` of ``_segments``). One transient copy of each side into the
    kernel's K layout."""
    n = niso_i.shape[0]
    at, bt, plan = _write_segments(
        layout, n, niso_i.device,
        lambda dirn, s, l, slab: (src[dirn][slab], dst[dirn][slab]),
    )
    return FusedArgs(at, bt, plan, _overlap_table(layout, niso_i.device), niso_i, niso_e)


def _tiled_ports_fused_step(
    a: HostArgs,
    vp: VPArrays,
    *,
    layout: PortLayout,
    chunk: int,
    self_traffic: bool,
    default_allow_unselected: bool,
    direction_aware_isolation: bool,
    k_rows=None,
):
    """The fused route (JAX ``_tiled_ports_fused_step``): one
    ``fused_ports_reach`` over all N, then the diagonal and ``col_mask`` on
    the words. ``k_rows`` goes to the kernel's cost report. Spans: ``solve.maps`` (the VP maps and the K-contiguous
    operands), then ``solve.kernel``."""
    with trace("solve.maps"):
        args, ing_iso, eg_iso, selected8 = _fused_inputs(
            a, vp, layout=layout, chunk=chunk,
            direction_aware_isolation=direction_aware_isolation,
        )
    with trace("solve.kernel"):
        out = fused_ports_reach(
            *args, default_allow=default_allow_unselected, k_rows=k_rows
        )
        del args  # the two [N, K'] operands
        if self_traffic:
            or_diagonal(out)
        out &= a.col_mask[None, :]
    return out, ing_iso, eg_iso, selected8 > 0


# ---------------------------------------------------------------------------
# host prologue and entry
# ---------------------------------------------------------------------------


def _free_bytes(dev: torch.device) -> Optional[int]:
    """Bytes a solve may still allocate on ``dev``: the driver's free memory
    plus what PyTorch's allocator holds unused; ``None`` on the CPU (no
    check there)."""
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    return free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)


def _resident_bytes(total_i: int, total_e: int, n: int, use_kernel: bool) -> int:
    """The peak of the [VP rows, N] operands. Kernel: the int32 peer-map
    accumulator and its int8 maps, then the maps and their two K-contiguous
    copies (~4 bytes a VP row a pod). Sweep: the int8 maps, the gathered
    egress selection and the float32 src copies (5 + 6)."""
    per_pod = 4 * (total_i + total_e) if use_kernel else 5 * total_i + 6 * total_e
    return per_pod * n


class _Prologue(NamedTuple):
    """What the host prologue hands the device: the VP layout, the padded
    operands, the VP arrays, the dst tile, and the grant counts per
    direction after run-splitting."""

    layout: PortLayout
    host: HostArgs
    vp: VPArrays
    tile: int
    split: Tuple[int, int]


def _prologue(enc: EncodedCluster, *, tile: int, chunk: int, use_kernel: bool) -> _Prologue:
    """Run-split and cap R, pick the dst tile and N's padding, pad, build the
    VP layout and ``bank8``."""
    ing_block, eg_block, R = _split_and_check_port_masks(
        enc.ingress, enc.egress, _MAX_PORT_MASKS
    )
    n = enc.n_pods
    if not use_kernel:
        # R bool [N, tile] planes per dst tile: shrink the tile to bound them
        cap = max(128, (_PORT_SLAB_BUDGET // max(R * max(n, 1), 1)) // 128 * 128)
        tile = min(tile, cap)
    tile = max(32, min(tile, 1 << 20))
    if tile % 32:
        raise ConfigError("tile must be a multiple of 32")
    pad_to = math.lcm(tile, N_TILE) if use_kernel else tile
    host = _host_args(enc, pad_to, chunk, ing_block, eg_block)
    ingress, egress = host.ingress, host.egress
    layout, pol_i, res_i, slot_i, pol_e, res_e, slot_e, _ = _build_port_layout(
        ingress.ports, egress.ports, ingress.pol, egress.pol,
        sink_pol=enc.n_policies,
        ing_restrict=ingress.dst_restrict, eg_restrict=egress.dst_restrict,
    )
    n_p = host.pod_kv.shape[0]
    bank8 = np.ones((1, n_p), dtype=np.int8)
    if enc.restrict_bank is not None:
        bank8 = np.zeros((enc.restrict_bank.shape[0], n_p), dtype=np.int8)
        bank8[:, :n] = enc.restrict_bank
    vp = VPArrays(pol_i, res_i, slot_i, pol_e, res_e, slot_e, bank8)
    return _Prologue(layout, host, vp, tile, (ing_block.n, eg_block.n))


def _check_resident(pro: _Prologue, dev, use_kernel: bool) -> None:
    rows_i, rows_e = len(pro.vp.pol_i), len(pro.vp.pol_e)
    n_p = pro.host.pod_kv.shape[0]
    need = _resident_bytes(rows_i, rows_e, n_p, use_kernel)
    free = _free_bytes(dev)
    if free is not None and need > free:
        raise ConfigError(
            f"the port path needs ~{need / 1e9:.1f} GB of [virtual-policies, "
            f"N] operands ({rows_i}+{rows_e} VP rows × {n_p} "
            f"pods), over the {free / 1e9:.1f} GB free on {dev}. Reduce the "
            "distinct (policy, port-mask) combinations, or verify with "
            "compute_ports=False."
        )


def ports_step(
    enc: EncodedCluster,
    *,
    tile: int,
    chunk: int,
    dev: torch.device,
    use_kernel: bool,
    self_traffic: bool,
    default_allow_unselected: bool,
    direction_aware_isolation: bool,
):
    """The multi-atom branch of ``ops/tiled.py::tiled_k8s_reach`` (JAX
    ``tiled_k8s_reach`` with ports): ``(packed, ing_iso, eg_iso, selected,
    kernel_name)`` on ``dev``, N padded. Spans: ``solve.prologue`` (the host
    prologue and the residency check) and ``solve.upload``, then the
    route's ``solve.maps`` and ``solve.kernel``."""
    with trace("solve.prologue"):
        pro = _prologue(enc, tile=tile, chunk=chunk, use_kernel=use_kernel)
        _check_resident(pro, dev, use_kernel)
    flags = dict(
        layout=pro.layout,
        chunk=chunk,
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
        direction_aware_isolation=direction_aware_isolation,
    )
    with trace("solve.upload"):
        a, vp = _put(pro.host, dev), _put(pro.vp, dev)
    if use_kernel:
        # the real VP rows, counted on the host only for a cost report
        k_rows = lambda: _stats(enc, pro)["K"]  # noqa: E731
        return (
            *_tiled_ports_fused_step(a, vp, k_rows=k_rows, **flags),
            "fused_ports_reach",
        )
    return (*_tiled_ports_step(a, vp, tile=pro.tile, **flags), "torch-ports-sweep")


class PortOperands(NamedTuple):
    """What the port path hands ``fused_ports_reach`` for one encoding
    (``args``), the ``col_mask`` it ANDs after, and the layout's sizes
    (``stats``)."""

    args: FusedArgs
    col_mask: torch.Tensor
    stats: dict


def _stats(enc: EncodedCluster, pro: _Prologue) -> dict:
    """The layout's sizes. ``K`` counts the real VP rows of the segments,
    the rows the kernel's function needs; ``K_layout`` adds the sink rows
    that pad each segment to a multiple of 8 (zero in both operands), and
    ``K_padded`` (K') each segment's zero columns up to ``K_STEP``."""
    segs = _segments(pro.layout)
    sink = enc.n_policies
    pol = {"i": pro.vp.pol_i, "e": pro.vp.pol_e}
    return dict(
        atoms=len(enc.atoms),
        grants_split=pro.split,
        R=pro.layout.n_masks,
        vp_rows_i=len(pro.vp.pol_i),
        vp_rows_e=len(pro.vp.pol_e),
        K=sum(int((pol[d][s : s + l] != sink).sum()) for d, s, l, _, _ in segs),
        K_layout=sum(l for _, _, l, _, _ in segs),
        K_padded=_padded_k(segs),
        N=pro.host.pod_kv.shape[0],
    )


def port_layout_stats(enc: EncodedCluster, *, tile: int = 4096, chunk: int = 2048) -> dict:
    """The kernel route's layout sizes for ``enc`` (``_stats``), from the
    host prologue alone: the port atoms, the grants per direction after
    run-splitting, R, the VP rows per direction (sink rows included), K, K'
    and N (padded)."""
    return _stats(enc, _prologue(enc, tile=tile, chunk=chunk, use_kernel=True))


def port_kernel_operands(
    enc: EncodedCluster,
    *,
    tile: int = 4096,
    chunk: int = 2048,
    direction_aware_isolation: bool = True,
    device=None,
) -> PortOperands:
    """The operands ``tiled_k8s_reach`` hands ``fused_ports_reach`` for
    ``enc`` on its kernel route, on ``device``, with ``port_layout_stats``;
    for measuring the kernel at the main path's shapes."""
    from ..runtime import resolve_device

    dev = resolve_device(device)
    pro = _prologue(enc, tile=tile, chunk=chunk, use_kernel=True)
    _check_resident(pro, dev, True)
    a = _put(pro.host, dev)
    args, *_ = _fused_inputs(
        a, _put(pro.vp, dev), layout=pro.layout, chunk=chunk,
        direction_aware_isolation=direction_aware_isolation,
    )
    return PortOperands(args, a.col_mask, _stats(enc, pro))
