"""Tiled large-N reachability in PyTorch: 100k-pod clusters on one GPU.

The port of the any-port path of ``kubernetes_verification_tpu.ops.tiled``:

* **policy-space contraction**: grant rows of one policy share their target
  set, so they OR-merge into per-policy peer maps first (an int32
  ``index_add_`` over the grant axis, then ``> 0``), computed a chunk of
  grants at a time so no [G, N] array is ever resident; the big product
  contracts over P policies, not G grants;
* **the hand-written kernel** ``ops/kernels.py::packed_dir_allow`` on a CUDA
  device: int8 tensor-core counts, threshold, default-allow OR and bit-pack
  fused, one launch per direction;
* otherwise a **dst-tiled torch sweep** (``_sweep_packed``) with exact
  float32 counts — the port of the JAX package's XLA sweep;
* **bit-packed output**: int32 [N, ⌈N/32⌉] words with the reference's uint32
  bit pattern (100k² pairs = 1.25 GB instead of 10 GB bool).

A multi-atom encoding (``encode_cluster(compute_ports=True)`` with port specs)
takes the port-bitmap path of ``ops/tiled_ports.py``: the mask-group sweep,
or on a CUDA device the fused kernel ``ops/kernels.py::fused_ports_reach``.

``PackedReach.closure`` closes the packed matrix (``ops/closure.py``), and
``policy_pair_masks`` answers the two pairwise policy queries at flagship
scale from [P, N] per-policy edge sets and their int8 Gram products, without
the dense [N, N] solve; ``policy_pair_masks_sharded`` and
``policy_sets_sharded`` build them over a ``parallel/mesh.py`` mesh.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..encode.encoder import EncodedCluster, GrantBlock
from ..observe.spans import trace
from ..resilience.errors import ConfigError
from ..runtime import resolve_device
from .bits import (
    or_diagonal,
    pack_bool_cols,
    to_host_words,
    unpack_cols,
    unpack_words_i8,
)
from .closure import (
    _words,
    bool_dot,
    packed_closure,
    packed_pair_total,
    packed_row_counts,
)
from .kernels import N_TILE, packed_reach
from .match import as_tensors, exact_fp32, match_selectors
from .padding import pad_grants, pad_pods

__all__ = [
    "PackedReach",
    "tiled_k8s_reach",
    "kernel_operands",
    "policy_pair_masks",
    "policy_pair_masks_sharded",
    "policy_sets_sharded",
    "pack_bool_cols",
    "unpack_cols",
    "unpack_words_i8",
]

_I8 = torch.int8
_I32 = torch.int32


class HostArgs(NamedTuple):
    """The padded operands of one solve (``_host_args``): numpy arrays, or
    tensors on a device after ``_put``. The grant blocks are ``GrantBlock``s
    of arrays; ``col_mask`` is the packed int32 mask of the real dst
    columns."""

    pod_kv: Any
    pod_key: Any
    pod_ns: Any
    ns_kv: Any
    ns_key: Any
    pol_sel: Any
    pol_ns: Any
    aff_ing: Any
    aff_eg: Any
    ingress: GrantBlock
    egress: GrantBlock
    col_mask: Any


def _grant_peers_full(
    block: GrantBlock, pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns
) -> torch.Tensor:
    """bool [G, N] peer map (same logic as ops/reach._grant_peers). ``pol_ns``
    carries one extra sentinel entry for the sink policy of pad grants."""
    pod_ok = match_selectors(block.pod_sel, pod_kv, pod_key)
    ns_sel_ok = match_selectors(block.ns_sel, ns_kv, ns_key)  # [G, M]
    same_ns = pol_ns[block.pol.long()][:, None] == pod_ns[None, :]
    # pad pods (namespace -1) gather the last namespace, as a negative index
    # does in the JAX package: whatever they pick up only reaches pad rows
    # and masked pad columns, but the incremental engine keeps the pad
    # columns of its peer maps as state, byte for byte
    ns_ok = torch.where(
        block.ns_sel_null[:, None], same_ns, ns_sel_ok[:, pod_ns.long()]
    )
    ok = pod_ok & ns_ok
    if block.ip_match is not None:
        ok = torch.where(block.is_ipblock[:, None], block.ip_match, ok)
    else:
        ok &= ~block.is_ipblock[:, None]
    return ok | block.match_all[:, None]


def _select_maps(a: HostArgs, direction_aware_isolation: bool):
    """``selected_by_pol`` as int8 [P, N], its per-direction variants, and
    the isolation vectors."""
    selected8 = (
        match_selectors(a.pol_sel, a.pod_kv, a.pod_key)
        & (a.pol_ns[:, None] == a.pod_ns[None, :])
    ).to(_I8)
    if direction_aware_isolation:
        sel_ing8 = selected8 * a.aff_ing.to(_I8)[:, None]
        sel_eg8 = selected8 * a.aff_eg.to(_I8)[:, None]
    else:
        sel_ing8 = selected8
        sel_eg8 = selected8
    # .any over the policy axis (False for every pod when P == 0)
    ing_iso = (sel_ing8 > 0).any(dim=0)
    eg_iso = (sel_eg8 > 0).any(dim=0)
    return selected8, sel_ing8, sel_eg8, ing_iso, eg_iso


def _rows(block, lo: int, hi: int):
    """Rows ``lo:hi`` of every leaf of a ``GrantBlock`` (or its nested
    ``SelectorEnc``s); every leaf's leading axis is the grant axis."""
    vals = {}
    for f in dataclasses.fields(block):
        v = getattr(block, f.name)
        if dataclasses.is_dataclass(v):
            v = _rows(v, lo, hi)
        elif v is not None:
            v = v[lo:hi]
        vals[f.name] = v
    return type(block)(**vals)


def _slot_counts(
    block: GrantBlock, slots: torch.Tensor, total: int, chunk: int,
    pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns,
) -> torch.Tensor:
    """int32 [total, N]: how many of each slot's grants peer each pod (grant
    ``g`` goes to slot ``slots[g]``), computed in G-chunks so no [G, N]
    array is ever resident (at 100k pods a full peer matrix alone would be
    several GB). The slot axis is the policy axis for the any-port solve
    and the virtual-policy axis for the port-bitmap path. An int32
    ``index_add_``: integer sums are exact whatever the order of the
    device's atomic adds."""
    N = pod_kv.shape[0]
    acc = torch.zeros((total, N), dtype=_I32, device=pod_kv.device)
    for g0 in range(0, block.pol.shape[0], chunk):
        blk = _rows(block, g0, g0 + chunk)
        peers = _grant_peers_full(blk, pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns)
        acc.index_add_(0, slots[g0 : g0 + chunk].long(), peers.to(_I32))
    return acc


def _peers_by_slot(
    block: GrantBlock, slots: torch.Tensor, total: int, chunk: int,
    pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns,
) -> torch.Tensor:
    """int8 [total, N]: OR of each slot's grant peer rows, ``_slot_counts``
    followed by ``> 0``."""
    counts = _slot_counts(
        block, slots, total, chunk, pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns
    )
    return (counts > 0).to(_I8)


def _sweep_packed(
    sel_ing8,  # int8 [P, N] — dst-side ingress selection
    sel_eg8,  # int8 [P, N] — src-side egress selection
    ing_by_pol,  # int8 [P, N] — src-side ingress peer map
    eg_by_pol,  # int8 [P, N] — dst-side egress peer map
    ing_iso,  # bool [N]
    eg_iso,  # bool [N]
    col_mask,  # int32 [W]
    *,
    tile: int,
    self_traffic: bool,
    default_allow_unselected: bool,
) -> torch.Tensor:
    """Dst-tiled any-port reachability sweep over per-policy maps → packed
    int32 [N, N/32]; the counts are exact float32 products (≤ P < 2²⁴)."""
    P, N = sel_ing8.shape
    ing_src = ing_by_pol.to(torch.float32)
    eg_src = sel_eg8.to(torch.float32)
    out = torch.empty((N, N // 32), dtype=_I32, device=sel_ing8.device)
    for d0 in range(0, N, tile):
        d1 = d0 + tile
        with exact_fp32():
            # ing_allow[src, dst_t] = ∨_p ing_by_pol[p, src] ∧ sel_ing[p, dst_t]
            ing_ok = (ing_src.T @ sel_ing8[:, d0:d1].to(torch.float32)) > 0
            # eg_allow[src, dst_t] = ∨_p sel_eg[p, src] ∧ eg_by_pol[p, dst_t]
            eg_ok = (eg_src.T @ eg_by_pol[:, d0:d1].to(torch.float32)) > 0
        if default_allow_unselected:
            ing_ok |= ~ing_iso[None, d0:d1]
            eg_ok |= ~eg_iso[:, None]
        out[:, d0 // 32 : d1 // 32] = pack_bool_cols(ing_ok & eg_ok)
    if self_traffic:
        or_diagonal(out)
    return out & col_mask[None, :]


def _with_sink(pol_ns: torch.Tensor) -> torch.Tensor:
    """``pol_ns`` with one extra entry for the sink policy slot ``P`` of pad
    grants: a namespace no pod has, so a sink grant peers nothing."""
    return torch.cat([pol_ns, pol_ns.new_full((1,), -2)])


def _policy_maps(a: HostArgs, *, chunk: int, direction_aware_isolation: bool):
    """The per-policy int8 [P, N] maps both solves contract, and the
    isolation vectors: ``(selected8, sel_ing8, sel_eg8, ing_iso, eg_iso,
    ing_by_pol, eg_by_pol)``."""
    P = a.pol_ns.shape[0]
    selected8, sel_ing8, sel_eg8, ing_iso, eg_iso = _select_maps(
        a, direction_aware_isolation
    )
    pol_ns_ext = _with_sink(a.pol_ns)

    def peers_by_policy(block: GrantBlock) -> torch.Tensor:
        """int8 [P, N]: OR of each policy's grant peer rows (the sink row P
        trimmed)."""
        return _peers_by_slot(
            block, block.pol, P + 1, chunk,
            a.pod_kv, a.pod_key, a.ns_kv, a.ns_key, a.pod_ns, pol_ns_ext,
        )[:P]

    ing_by_pol = peers_by_policy(a.ingress)  # int8 [P, N] (src side)
    eg_by_pol = peers_by_policy(a.egress)  # int8 [P, N] (dst side)
    return selected8, sel_ing8, sel_eg8, ing_iso, eg_iso, ing_by_pol, eg_by_pol


def _not_iso(iso: torch.Tensor) -> torch.Tensor:
    """int32 [8, N]: 1 where not isolated, in the JAX kernel's 8-row form
    (row 0 is read)."""
    return (~iso).to(_I32)[None, :].repeat(8, 1)


def _tiled_step(
    a: HostArgs,
    *,
    tile: int,
    chunk: int,
    self_traffic: bool,
    default_allow_unselected: bool,
    direction_aware_isolation: bool,
    use_kernel: bool,
):
    """The any-port solve over the device operands ``a`` (``_device_args``):
    the ``solve.maps`` span, then ``solve.kernel`` (two launches of
    ``packed_reach``'s kernel, or the torch sweep)."""
    col_mask = a.col_mask
    with trace("solve.maps"):
        selected8, sel_ing8, sel_eg8, ing_iso, eg_iso, ing_by_pol, eg_by_pol = (
            _policy_maps(
                a, chunk=chunk, direction_aware_isolation=direction_aware_isolation
            )
        )
    with trace("solve.kernel"):
        if use_kernel:
            out = packed_reach(
                ing_by_pol, sel_ing8, sel_eg8, eg_by_pol,
                _not_iso(ing_iso), _not_iso(eg_iso),
                self_traffic=self_traffic,
                default_allow_unselected=default_allow_unselected,
            )
            out &= col_mask[None, :]
        else:
            out = _sweep_packed(
                sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_iso, eg_iso, col_mask,
                tile=tile,
                self_traffic=self_traffic,
                default_allow_unselected=default_allow_unselected,
            )
    return out, ing_iso, eg_iso, selected8 > 0


def _host_args(
    enc: EncodedCluster, pad_to: int, chunk: int,
    ingress: Optional[GrantBlock] = None, egress: Optional[GrantBlock] = None,
) -> HostArgs:
    """The padding contract, on the host: N padded to a ``pad_to`` multiple
    (pad pods in namespace −1), the grant axis (``enc``'s blocks, or the
    run-split ones the caller passes) padded to a chunk multiple with inert
    sink-policy rows, and the packed ``col_mask`` of the real dst columns
    (the reference's uint32 words seen as int32). numpy."""
    n = enc.n_pods
    n_pad = (pad_to - n % pad_to) % pad_to
    P = enc.n_policies
    ingress = enc.ingress if ingress is None else ingress
    egress = enc.egress if egress is None else egress
    col_valid = np.zeros(n + n_pad, dtype=bool)
    col_valid[:n] = True
    return HostArgs(
        pod_kv=np.pad(enc.pod_kv, ((0, n_pad), (0, 0))),
        pod_key=np.pad(enc.pod_key, ((0, n_pad), (0, 0))),
        pod_ns=np.pad(enc.pod_ns, (0, n_pad), constant_values=-1),
        ns_kv=enc.ns_kv, ns_key=enc.ns_key, pol_sel=enc.pol_sel, pol_ns=enc.pol_ns,
        aff_ing=enc.pol_affects_ingress, aff_eg=enc.pol_affects_egress,
        ingress=pad_grants(ingress, (chunk - ingress.n % chunk) % chunk, P, n_pad),
        egress=pad_grants(egress, (chunk - egress.n % chunk) % chunk, P, n_pad),
        col_mask=np.packbits(col_valid, bitorder="little").view("<i4").copy(),
    )


def _put(host, dev):
    """One transfer to ``dev`` of every field of a NamedTuple of arrays
    (``HostArgs``, ``tiled_ports.VPArrays``), dataclasses of arrays
    included; the same NamedTuple of tensors."""
    return type(host)(*(
        as_tensors(x, dev) if dataclasses.is_dataclass(x) else torch.as_tensor(x, device=dev)
        for x in host
    ))


def _device_args(enc: EncodedCluster, tile: int, chunk: int, dev) -> HostArgs:
    """``_host_args`` with N padded to a tile multiple, on ``dev``."""
    return _put(_host_args(enc, tile, chunk), dev)


def kernel_operands(
    enc: EncodedCluster,
    *,
    tile: int = 4096,
    chunk: int = 2048,
    direction_aware_isolation: bool = True,
    device=None,
) -> tuple:
    """The six operands ``tiled_k8s_reach`` hands ``ops/kernels.py::
    packed_reach`` for ``enc`` — ``(ing_by_pol, sel_ing, sel_eg, eg_by_pol,
    not_ing_iso, not_eg_iso)`` on ``device`` — plus the ``col_mask`` the
    solve ANDs after it; for measuring the kernel at the main path's
    shapes."""
    dev = resolve_device(device)
    a = _device_args(enc, tile, chunk, dev)
    _, sel_ing8, sel_eg8, ing_iso, eg_iso, ing_by_pol, eg_by_pol = _policy_maps(
        a, chunk=chunk, direction_aware_isolation=direction_aware_isolation
    )
    return (
        ing_by_pol, sel_ing8, sel_eg8, eg_by_pol,
        _not_iso(ing_iso), _not_iso(eg_iso), a.col_mask,
    )


# ---------------------------------------------------------------------------
# whole-matrix queries on device-resident words
# ---------------------------------------------------------------------------


def _device_word_reduce(packed: torch.Tensor, op: str) -> torch.Tensor:
    """Column-wise AND/OR of int32 [R, W] words (int32 [W]), by halving."""
    if packed.shape[0] == 0:
        return packed.new_full((packed.shape[1],), -1 if op == "and" else 0)
    x = packed
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] & x[h : 2 * h] if op == "and" else x[:h] | x[h : 2 * h]
        if x.shape[0] % 2:
            y = torch.cat([y, x[2 * h :]])
        x = y
    return x[0]


def _host_group_or(packed: np.ndarray, gid: np.ndarray, n_groups: int) -> np.ndarray:
    """uint32 [U, W]: OR of the packed rows of each group (host; one stable
    sort + ``np.bitwise_or.reduceat``)."""
    out = np.zeros((n_groups, packed.shape[1]), dtype=np.uint32)
    counts = np.bincount(gid, minlength=n_groups)
    nonempty = np.nonzero(counts > 0)[0]
    if nonempty.size == 0:
        return out
    order = np.argsort(gid, kind="stable")
    starts = np.zeros(n_groups, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    out[nonempty] = np.bitwise_or.reduceat(packed[order], starts[nonempty], axis=0)
    return out


def _crosscheck_from_group_or(
    group_or: np.ndarray, gid: np.ndarray, n: int
) -> List[int]:
    """Finish a crosscheck query from the [U, W] per-group row-OR table:
    ``or_notg[g] = OR of every group's rows except g's`` via prefix/suffix
    ORs, then one gather answers bit ``j`` of ``or_notg[gid[j]]`` for all
    dsts."""
    fwd = np.bitwise_or.accumulate(group_or, axis=0)
    bwd = np.bitwise_or.accumulate(group_or[::-1], axis=0)[::-1]
    or_notg = np.zeros_like(group_or)
    or_notg[1:] |= fwd[:-1]
    or_notg[:-1] |= bwd[1:]
    j = np.arange(n)
    vals = (or_notg[gid, j // 32] >> (j % 32).astype(np.uint32)) & np.uint32(1)
    return np.nonzero(vals)[0].tolist()


@dataclass
class PackedReach:
    """Bit-packed reachability matrix + packed-domain queries.

    ``packed[src, w]`` bit ``j`` ⇔ src reaches pod ``w*32+j``. ``packed`` is
    the reference's uint32 numpy array (``fetch=True``) or stays on the device
    as int32 words of the same bit pattern (``fetch=False``); the
    whole-matrix queries then reduce on the device and ship only the small
    result."""

    packed: Union[np.ndarray, torch.Tensor]
    n_pods: int
    ingress_isolated: np.ndarray
    egress_isolated: np.ndarray
    selected: Optional[np.ndarray] = None
    #: float-valued phase timings (plus the integer ``reachable_pairs``)
    timings: Optional[dict] = None
    #: non-numeric provenance (which kernel ran)
    meta: Optional[dict] = None
    #: bool [n_pods] — live pods, when the matrix carries tombstoned slots
    #: (the incremental engine's pod-churn state; tombstone rows/cols are
    #: all-zero). None ⇔ every slot is a live pod. Whole-matrix queries
    #: neutralise tombstone rows and drop tombstone dsts from answers.
    active: Optional[np.ndarray] = None

    @property
    def _on_host(self) -> bool:
        return isinstance(self.packed, np.ndarray)

    def _host_words(self, lo: int = 0, hi: Optional[int] = None) -> np.ndarray:
        rows = self.packed[lo:hi]
        return rows if self._on_host else to_host_words(rows)

    def reachable(self, src: int, dst: int) -> bool:
        w = self._host_words(src, src + 1)[0, dst // 32]
        return bool((np.uint32(w) >> np.uint32(dst % 32)) & np.uint32(1))

    def row(self, src: int) -> np.ndarray:
        return unpack_cols(self._host_words(src, src + 1), self.n_pods)[0]

    def to_bool(self) -> np.ndarray:
        return unpack_cols(self._host_words(), self.n_pods)

    def _word_reduce(self, op: str) -> np.ndarray:
        words = self.packed[: self.n_pods]
        if self.active is not None:
            # neutralise tombstone rows: identity element for the reduction
            if self._on_host:
                fill = np.uint32(0xFFFFFFFF) if op == "and" else np.uint32(0)
                words = np.where(self.active[:, None], words, fill)
            else:
                live = torch.as_tensor(self.active, device=words.device)
                words = torch.where(live[:, None], words, -1 if op == "and" else 0)
        if self._on_host:
            ufunc = np.bitwise_and if op == "and" else np.bitwise_or
            return ufunc.reduce(words, axis=0)
        return to_host_words(_device_word_reduce(words, op))

    def _live_dsts(self, mask: np.ndarray) -> List[int]:
        if self.active is not None:
            mask = mask & self.active
        return np.nonzero(mask)[0].tolist()

    def all_reachable(self) -> List[int]:
        """Pods reachable from every pod (``kano/algorithm.py:4-9``)."""
        conj = self._word_reduce("and")
        return self._live_dsts(unpack_cols(conj[None, :], self.n_pods)[0])

    def all_isolated(self) -> List[int]:
        """Pods reachable from no pod (``kano/algorithm.py:12-17``)."""
        disj = self._word_reduce("or")
        return self._live_dsts(~unpack_cols(disj[None, :], self.n_pods)[0])

    def out_degree(self) -> np.ndarray:
        """popcount per source row; never unpacks the matrix."""
        if self._on_host:
            words = self.packed[: self.n_pods]
            if hasattr(np, "bitwise_count"):  # numpy ≥ 2.0
                return np.bitwise_count(words).sum(axis=1, dtype=np.int64)
            v = np.ascontiguousarray(words).view(np.uint8)
            return np.unpackbits(v, axis=1).sum(axis=1, dtype=np.int64)
        counts = packed_row_counts(self.packed[: self.n_pods])
        return counts.cpu().numpy().astype(np.int64)

    def system_isolation(self, idx: int) -> List[int]:
        """Pods NOT reachable from pod ``idx`` — the row complement
        (``kano/algorithm.py:45-55``); unpacks one row only. Tombstoned
        dsts are dropped; a tombstoned src is an error, not "isolated
        from everything"."""
        if self.active is not None and not self.active[idx]:
            raise ConfigError(
                f"pod slot {idx} is tombstoned (removed); "
                "system_isolation needs a live pod"
            )
        return self._live_dsts(~self.row(idx))

    def closure(
        self, tile: int = 7168, max_iter: int = 32, *, device=None, on_pass=None
    ) -> "PackedReach":
        """Transitive closure in the packed domain (``ops/closure.py``'s
        tiled squaring): the rows are padded with zero rows to ``W·32`` so
        the matrix is square in bits, closed, and trimmed. Returns a new
        ``PackedReach`` on the same side as this one: device words stay on
        their device; host words are closed on ``device`` (default
        ``"cuda"``) and come back as the reference's uint32. ``on_pass`` is
        ``packed_closure``'s per-pass callback."""
        words = _words(self.packed, device) if self._on_host else self.packed
        rows = words.shape[0]
        padded = torch.nn.functional.pad(words, (0, 0, 0, words.shape[1] * 32 - rows))
        closed = packed_closure(
            padded, tile=tile, max_iter=max_iter, on_pass=on_pass
        )[:rows]
        return dataclasses.replace(
            self, packed=to_host_words(closed) if self._on_host else closed
        )

    def user_crosscheck(self, objs, label: str) -> List[int]:
        """Pods reachable from a pod of a *different* user group
        (``kano/algorithm.py:27-42``) without unpacking: U per-group row-ORs
        + a prefix/suffix OR over the [U, W] table answer all dsts at once.
        On a churned matrix (``active`` set) ``objs`` may also be the live
        pods alone, in slot order (what ``as_cluster()`` yields)."""
        from .queries import user_groups

        gid = user_groups(objs, label)
        if self.active is not None and gid.shape[0] != self.n_pods:
            # tombstone slots land in group 0, but their all-zero rows and
            # columns can never contribute to or be flagged by the ORs
            live = np.nonzero(self.active[: self.n_pods])[0]
            if gid.shape[0] != live.shape[0]:
                raise ConfigError(
                    f"user_crosscheck: {gid.shape[0]} objects != "
                    f"{self.n_pods} pod slots or {live.shape[0]} live pods"
                )
            full = np.zeros(self.n_pods, dtype=gid.dtype)
            full[live] = gid
            gid = full
        elif gid.shape[0] != self.n_pods:
            raise ConfigError(
                f"user_crosscheck: {gid.shape[0]} objects != {self.n_pods} pods"
            )
        n_groups = int(gid.max()) + 1 if gid.size else 0
        if n_groups <= 1:
            return []
        if self._on_host:
            group_or = _host_group_or(self.packed[: self.n_pods], gid, n_groups)
        else:
            words = self.packed[: self.n_pods]
            g = torch.as_tensor(gid, device=words.device)
            group_or = np.stack(
                [
                    to_host_words(_device_word_reduce(words[g == i], "or"))
                    for i in range(n_groups)
                ]
            )
        res = _crosscheck_from_group_or(group_or, gid, self.n_pods)
        if self.active is None:
            return res
        return [i for i in res if self.active[i]]


def tiled_k8s_reach(
    enc: EncodedCluster,
    *,
    tile: int = 4096,
    chunk: int = 2048,
    self_traffic: bool = True,
    default_allow_unselected: bool = True,
    direction_aware_isolation: bool = True,
    device=None,
    fetch: bool = True,
    use_kernel: Optional[bool] = None,
) -> PackedReach:
    """Host wrapper: pad N to a tile multiple, run the tiled step on
    ``device`` (default ``"cuda"``; raises without one), trim.

    A multi-atom encoding (``encode_cluster(compute_ports=True)`` with at
    least one rule naming ports) takes the port-bitmap path
    (``ops/tiled_ports.py``); at most 128 distinct ported masks after
    run-splitting (61 on the kernel route), else ``ConfigError``. Any other
    encoding takes the any-port solve.

    ``use_kernel=None`` auto-selects: the CUDA kernel (``packed_dir_allow``
    any-port, ``fused_ports_reach`` port-bitmap) on a CUDA device, the torch
    sweep otherwise. ``use_kernel=True`` on the CPU runs the kernel's plain
    version through the same wrapper.

    ``fetch=False`` leaves the packed matrix on the device
    (``PackedReach.packed`` is an int32 tensor) and synchronises on the
    reachable-pair count instead (``timings["reachable_pairs"]``)."""
    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    n = enc.n_pods
    flags = dict(
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
        direction_aware_isolation=direction_aware_isolation,
    )
    t0 = time.perf_counter()
    with trace("solve"):
        if len(enc.atoms) > 1:
            from .tiled_ports import ports_step

            packed, ing_iso, eg_iso, selected, kernel = ports_step(
                enc, tile=tile, chunk=chunk, dev=dev, use_kernel=use_kernel, **flags
            )
        else:
            with trace("solve.prologue"):
                tile = max(32, min(tile, 1 << 20))
                if tile % 32:
                    raise ConfigError("tile must be a multiple of 32")
                if use_kernel and tile % N_TILE:
                    raise ConfigError(
                        f"use_kernel requires tile % {N_TILE} == 0 (kernel tile)"
                    )
                host = _host_args(enc, tile, chunk)
            with trace("solve.upload"):
                a = _put(host, dev)
            del host
            packed, ing_iso, eg_iso, selected = _tiled_step(
                a, tile=tile, chunk=chunk, use_kernel=use_kernel, **flags,
            )
            del a
            kernel = "packed_dir_allow" if use_kernel else "torch-sweep"
        # where the host waits for the card
        with trace("solve.sync"):
            if fetch:
                packed_out = to_host_words(packed[:n])
                label = "solve+fetch"
            else:
                # synchronise on the pair count, not on the 1.25 GB matrix
                total = packed_pair_total(packed[:n])
                packed_out = packed[:n]
                label = "solve"
            t1 = time.perf_counter()
            ing_out = ing_iso[:n].cpu().numpy()
            eg_out = eg_iso[:n].cpu().numpy()
            selected_out = selected[:, :n].cpu().numpy() if fetch else None
    out = PackedReach(
        packed=packed_out,
        n_pods=n,
        ingress_isolated=ing_out,
        egress_isolated=eg_out,
        selected=selected_out,
        timings={label: t1 - t0},
        meta={"kernel": kernel},
    )
    if not fetch:
        out.timings["reachable_pairs"] = total
    return out


# ---------------------------------------------------------------------------
# pairwise policy queries at flagship scale
# ---------------------------------------------------------------------------


class PairArgs(NamedTuple):
    """The operands of the pair-mask step (``_pair_mask_args``): numpy
    arrays, or tensors on a device after ``_put``."""

    pod_kv: Any
    pod_key: Any
    pod_ns: Any
    ns_kv: Any
    ns_key: Any
    pol_sel: Any
    pol_ns: Any
    gate_i: Any  # bool [P]: policy has ingress rules AND affects ingress
    gate_e: Any  # bool [P]
    ingress: GrantBlock
    egress: GrantBlock
    valid: Any  # int8 [N]: 1 = real pod, 0 = pod-axis padding


def _policy_sets(a: PairArgs, *, chunk: int):
    """The int8 [P, N] per-policy src/dst edge sets, following the CPU
    oracle: an ingress-affecting policy with rules contributes its peer
    union to src and its selection to dst; egress mirrors."""
    P = a.pol_ns.shape[0]
    selected8 = (
        match_selectors(a.pol_sel, a.pod_kv, a.pod_key)
        & (a.pol_ns[:, None] == a.pod_ns[None, :])
    ).to(_I8)
    pol_ns_ext = _with_sink(a.pol_ns)

    def peers(block: GrantBlock) -> torch.Tensor:
        return _peers_by_slot(
            block, block.pol, P + 1, chunk,
            a.pod_kv, a.pod_key, a.ns_kv, a.ns_key, a.pod_ns, pol_ns_ext,
        )[:P]

    ing_peers = peers(a.ingress)
    eg_peers = peers(a.egress)
    gi = a.gate_i.to(_I8)[:, None]
    ge = a.gate_e.to(_I8)[:, None]
    valid = a.valid[None, :]
    src8 = torch.maximum(ing_peers * gi, selected8 * ge) * valid
    dst8 = torch.maximum(selected8 * gi, eg_peers * ge) * valid
    return src8, dst8


def _pair_masks_from_sets(src8: torch.Tensor, dst8: torch.Tensor):
    """``(shadow, conflict)`` bool [P, P] from the [P, N] sets: two int8
    Grams (``share`` co-selection, ``dd`` dst overlap; both operands
    K-contiguous) and the dst popcounts ``dsize``."""
    return _pair_masks_from_grams(*_grams(src8, dst8))


def _grams(src8: torch.Tensor, dst8: torch.Tensor):
    """``(share, dd, dsize)``: the two int32 [P, P] Grams of the sets and
    the int32 [P] dst popcounts; sums over the pod axis, so the sharded
    masks add the ranks' partials."""
    return bool_dot(src8, src8), bool_dot(dst8, dst8), dst8.sum(dim=1, dtype=_I32)


def _pair_masks_from_grams(share: torch.Tensor, dd: torch.Tensor, dsize: torch.Tensor):
    P = share.shape[0]
    eye = torch.eye(P, dtype=torch.bool, device=share.device)
    shadow = (share > 0) & (dd == dsize[None, :]) & ~eye
    conflict = (
        (share > 0)
        & (dd == 0)
        & (dsize[:, None] > 0)
        & (dsize[None, :] > 0)
        & ~eye
    )
    return shadow, conflict


def _policy_sets_step(a: PairArgs, *, chunk: int):
    """Per-policy src/dst edge sets + their Gram masks, on ``a``'s device:
    the [P, N] sets never leave it."""
    return _pair_masks_from_sets(*_policy_sets(a, chunk=chunk))


def _pair_mask_args(
    enc: EncodedCluster, direction_aware_isolation: bool, chunk: int,
    n_pad: int,
) -> PairArgs:
    """Host prologue shared by the one-device and sharded pair-mask
    entries: grant gates, chunk-aligned grant padding, optional pod-axis
    padding (+ its validity vector; the sharded masks pad N to the mesh)."""
    P = enc.n_policies
    has_ing = np.bincount(enc.ingress.pol, minlength=P + 1)[:P] > 0
    has_eg = np.bincount(enc.egress.pol, minlength=P + 1)[:P] > 0
    if direction_aware_isolation:
        gate_i = has_ing & enc.pol_affects_ingress
        gate_e = has_eg & enc.pol_affects_egress
    else:
        gate_i = has_ing
        gate_e = has_eg
    ingress = pad_grants(
        enc.ingress, (chunk - enc.ingress.n % chunk) % chunk, P, n_pad
    )
    egress = pad_grants(
        enc.egress, (chunk - enc.egress.n % chunk) % chunk, P, n_pad
    )
    pod_kv, pod_key, pod_ns = pad_pods(enc.pod_kv, enc.pod_key, enc.pod_ns, n_pad)
    valid = np.zeros(enc.n_pods + n_pad, dtype=np.int8)
    valid[: enc.n_pods] = 1
    return PairArgs(
        pod_kv, pod_key, pod_ns, enc.ns_kv, enc.ns_key, enc.pol_sel,
        enc.pol_ns, gate_i, gate_e, ingress, egress, valid,
    )


def policy_pair_masks(
    enc: EncodedCluster,
    *,
    direction_aware_isolation: bool = True,
    chunk: int = 2048,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(shadow_mask, conflict_mask)`` bool [P, P] for the two pairwise
    policy queries at flagship scale, on ``device`` (default ``"cuda"``;
    raises without one). The [P, N] src/dst edge sets and their two
    O(P²·N) int8 Grams stay on the device (at 10k policies × 100k pods each
    Gram is 10¹³ multiply-adds); only the [P, P] masks come back. Harvest
    pairs with ``np.argwhere``, or compare with
    ``VerifyResult.policy_shadow()`` at small N."""
    dev = resolve_device(device)
    args = _put(_pair_mask_args(enc, direction_aware_isolation, chunk, n_pad=0), dev)
    shadow, conflict = _policy_sets_step(args, chunk=chunk)
    return shadow.cpu().numpy(), conflict.cpu().numpy()


def _sharded_set_args(mesh, enc: EncodedCluster, direction_aware_isolation: bool, chunk: int):
    """The rank's ``PairArgs`` of the sharded Gram-mask and set entries, on
    its device: N padded to the pod-axis size, the pod-axis leaves cut to
    the rank's block of ``pods`` (``ip_match``, the one grant leaf with a
    pod axis, included); the grant stacks whole on every rank."""
    from ..parallel.mesh import POD_AXIS, pad_amount, rank_slice

    n_pad = pad_amount(enc.n_pods, mesh.shape[POD_AXIS])
    a = _pair_mask_args(enc, direction_aware_isolation, chunk, n_pad)
    rows = rank_slice(mesh, POD_AXIS, enc.n_pods + n_pad)

    def cut(block: GrantBlock) -> GrantBlock:
        if block.ip_match is None:
            return block
        return dataclasses.replace(block, ip_match=block.ip_match[:, rows])

    return _put(a._replace(
        pod_kv=a.pod_kv[rows], pod_key=a.pod_key[rows], pod_ns=a.pod_ns[rows],
        ingress=cut(a.ingress), egress=cut(a.egress), valid=a.valid[rows],
    ), mesh.device)


def policy_pair_masks_sharded(
    mesh,
    enc: EncodedCluster,
    *,
    direction_aware_isolation: bool = True,
    chunk: int = 2048,
) -> Tuple[np.ndarray, np.ndarray]:
    """``policy_pair_masks`` over a ``(pods, grants)`` mesh, on every rank:
    each rank builds the [P, n_loc] src/dst sets of its block of ``pods``
    and their Gram partials; an int32 sum over ``pods`` gives the whole
    Grams (the JAX package leaves this split to GSPMD: per-device dots plus
    a ``psum``). The grant stacks are whole on every rank, and the ranks of
    one ``grants`` column repeat the same work, as the replicated leaves do
    there. Only the [P, P] masks come back to the host."""
    from ..parallel.mesh import POD_AXIS, psum

    src8, dst8 = _policy_sets(
        _sharded_set_args(mesh, enc, direction_aware_isolation, chunk), chunk=chunk
    )
    grams = [psum(mesh, g, POD_AXIS) for g in _grams(src8, dst8)]
    shadow, conflict = _pair_masks_from_grams(*grams)
    return shadow.cpu().numpy(), conflict.cpu().numpy()


def policy_sets_sharded(
    mesh,
    enc: EncodedCluster,
    *,
    direction_aware_isolation: bool = True,
    chunk: int = 2048,
) -> Tuple[np.ndarray, np.ndarray]:
    """Materialise the per-policy ``(src_sets, dst_sets)`` bool [P, N] from
    a sharded build (the kano ``working_select`` / ``working_allow`` sets),
    on every rank: the rank's [P, n_loc] blocks gathered over ``pods``. The
    result ships to the host, so the caller bounds P·N (the sharded-packed
    result's ``materialize_policy_sets`` enforces a byte budget)."""
    from ..parallel.mesh import POD_AXIS, all_gather

    src8, dst8 = _policy_sets(
        _sharded_set_args(mesh, enc, direction_aware_isolation, chunk), chunk=chunk
    )
    n = enc.n_pods
    return tuple(
        (all_gather(mesh, x, POD_AXIS, dim=1)[:, :n] > 0).cpu().numpy()
        for x in (src8, dst8)
    )


# Kernel-manifest registration (observe/aot.py): rebind the dispatch
# functions so their dispatch keys reach the warm pack's manifest; call
# sites above are unchanged (late binding).
from ..observe.aot import register_kernel as _register_kernel  # noqa: E402

_tiled_step = _register_kernel(
    "tiled", "_tiled_step", _tiled_step,
    static_argnames=(
        "tile", "chunk", "self_traffic", "default_allow_unselected",
        "direction_aware_isolation", "use_kernel",
    ),
)
_device_word_reduce = _register_kernel(
    "tiled", "_device_word_reduce", _device_word_reduce,
    static_argnames=("op",),
)
_policy_sets_step = _register_kernel(
    "tiled", "_policy_sets_step", _policy_sets_step,
    static_argnames=("chunk",),
)
_policy_sets = _register_kernel(
    "tiled", "_policy_sets", _policy_sets, static_argnames=("chunk",)
)
