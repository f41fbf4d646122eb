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

The port-bitmap path (multi-atom encodings) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from ..encode.encoder import EncodedCluster, GrantBlock
from ..resilience.errors import ConfigError
from ..runtime import resolve_device
from .bits import (
    or_diagonal,
    pack_bool_cols,
    to_host_words,
    unpack_cols,
    unpack_words_i8,
)
from .closure import packed_pair_total, packed_row_counts
from .kernels import N_TILE, packed_reach
from .match import as_tensors, exact_fp32, match_selectors
from .padding import pad_grants

__all__ = [
    "PackedReach",
    "tiled_k8s_reach",
    "kernel_operands",
    "pack_bool_cols",
    "unpack_cols",
    "unpack_words_i8",
]

_I8 = torch.int8
_I32 = torch.int32

#: where a multi-atom (port-bitmap) solve is queued
_PORTS_TODO = (
    "the port-bitmap path (a multi-atom encoding, encode_cluster("
    "compute_ports=True) with port specs) is not ported yet: ROADMAP.md, "
    "'Modules to port', the port-bitmap path with fused_ports_stripe. Encode "
    "with compute_ports=False for the any-port solve."
)


def _grant_peers_full(
    block: GrantBlock, pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns
) -> torch.Tensor:
    """bool [G, N] peer map (same logic as ops/reach._grant_peers). ``pol_ns``
    carries one extra sentinel entry for the sink policy of pad grants."""
    pod_ok = match_selectors(block.pod_sel, pod_kv, pod_key)
    ns_sel_ok = match_selectors(block.ns_sel, ns_kv, ns_key)  # [G, M]
    same_ns = pol_ns[block.pol.long()][:, None] == pod_ns[None, :]
    # pad pods (namespace -1) gather namespace 0: whatever they pick up only
    # reaches pad rows and masked pad columns
    ns_ok = torch.where(
        block.ns_sel_null[:, None], same_ns, ns_sel_ok[:, pod_ns.clamp(min=0).long()]
    )
    ok = pod_ok & ns_ok
    if block.ip_match is not None:
        ok = torch.where(block.is_ipblock[:, None], block.ip_match, ok)
    else:
        ok &= ~block.is_ipblock[:, None]
    return ok | block.match_all[:, None]


def _select_maps(
    pod_kv, pod_key, pod_ns, pol_sel, pol_ns, aff_ing, aff_eg,
    direction_aware_isolation: bool,
):
    """``selected_by_pol`` as int8 [P, N], its per-direction variants, and
    the isolation vectors."""
    selected8 = (
        match_selectors(pol_sel, pod_kv, pod_key)
        & (pol_ns[:, None] == pod_ns[None, :])
    ).to(_I8)
    if direction_aware_isolation:
        sel_ing8 = selected8 * aff_ing.to(_I8)[:, None]
        sel_eg8 = selected8 * aff_eg.to(_I8)[:, None]
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


def _peers_by_slot(
    block: GrantBlock, total: int, chunk: int,
    pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns,
) -> torch.Tensor:
    """int8 [total, N]: OR of each policy's grant peer rows, computed in
    G-chunks so no [G, N] array is ever resident (at 100k pods a full peer
    matrix alone would be several GB). The OR is an int32 ``index_add_``
    followed by ``> 0``: integer sums are exact whatever the order of the
    device's atomic adds."""
    N = pod_kv.shape[0]
    acc = torch.zeros((total, N), dtype=_I32, device=pod_kv.device)
    for g0 in range(0, block.pol.shape[0], chunk):
        blk = _rows(block, g0, g0 + chunk)
        peers = _grant_peers_full(blk, pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns)
        acc.index_add_(0, blk.pol.long(), peers.to(_I32))
    return (acc > 0).to(_I8)


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


def _policy_maps(
    pod_kv, pod_key, pod_ns, ns_kv, ns_key, pol_sel, pol_ns, aff_ing, aff_eg,
    ingress: GrantBlock, egress: GrantBlock,
    *,
    chunk: int,
    direction_aware_isolation: bool,
):
    """The per-policy int8 [P, N] maps both solves contract, and the
    isolation vectors: ``(selected8, sel_ing8, sel_eg8, ing_iso, eg_iso,
    ing_by_pol, eg_by_pol)``."""
    P = pol_ns.shape[0]
    selected8, sel_ing8, sel_eg8, ing_iso, eg_iso = _select_maps(
        pod_kv, pod_key, pod_ns, pol_sel, pol_ns, aff_ing, aff_eg,
        direction_aware_isolation,
    )
    # the sink slot P of pad grants gets a namespace no pod has
    pol_ns_ext = torch.cat([pol_ns, pol_ns.new_full((1,), -2)])

    def peers_by_policy(block: GrantBlock) -> torch.Tensor:
        """int8 [P, N]: OR of each policy's grant peer rows (the sink row P
        trimmed)."""
        return _peers_by_slot(
            block, P + 1, chunk, pod_kv, pod_key, ns_kv, ns_key, pod_ns, pol_ns_ext
        )[:P]

    ing_by_pol = peers_by_policy(ingress)  # int8 [P, N] (src side)
    eg_by_pol = peers_by_policy(egress)  # int8 [P, N] (dst side)
    return selected8, sel_ing8, sel_eg8, ing_iso, eg_iso, ing_by_pol, eg_by_pol


def _not_iso(iso: torch.Tensor) -> torch.Tensor:
    """int32 [8, N]: 1 where not isolated, in the JAX kernel's 8-row form
    (row 0 is read)."""
    return (~iso).to(_I32)[None, :].repeat(8, 1)


def _tiled_step(
    *args,
    tile: int,
    chunk: int,
    self_traffic: bool,
    default_allow_unselected: bool,
    direction_aware_isolation: bool,
    use_kernel: bool,
):
    """``args``: the device operands of ``_device_args`` (col_mask last)."""
    *inputs, col_mask = args
    selected8, sel_ing8, sel_eg8, ing_iso, eg_iso, ing_by_pol, eg_by_pol = (
        _policy_maps(
            *inputs, chunk=chunk,
            direction_aware_isolation=direction_aware_isolation,
        )
    )
    if use_kernel:
        out = packed_reach(
            ing_by_pol, sel_ing8, sel_eg8, eg_by_pol,
            _not_iso(ing_iso), _not_iso(eg_iso),
            self_traffic=self_traffic,
            default_allow_unselected=default_allow_unselected,
        )
        out &= col_mask[None, :]
        return out, ing_iso, eg_iso, selected8 > 0

    out = _sweep_packed(
        sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_iso, eg_iso, col_mask,
        tile=tile,
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
    )
    return out, ing_iso, eg_iso, selected8 > 0


def _device_args(enc: EncodedCluster, tile: int, chunk: int, dev) -> tuple:
    """The padding contract, then one transfer: N padded to a tile multiple
    (pad pods in namespace −1), the grant axis padded to a chunk multiple
    with inert sink-policy rows, and the packed ``col_mask`` of the real dst
    columns (the reference's uint32 words seen as int32)."""
    n = enc.n_pods
    n_pad = (tile - n % tile) % tile
    pod_kv = np.pad(enc.pod_kv, ((0, n_pad), (0, 0)))
    pod_key = np.pad(enc.pod_key, ((0, n_pad), (0, 0)))
    pod_ns = np.pad(enc.pod_ns, (0, n_pad), constant_values=-1)
    P = enc.n_policies
    ingress = pad_grants(enc.ingress, (chunk - enc.ingress.n % chunk) % chunk, P, n_pad)
    egress = pad_grants(enc.egress, (chunk - enc.egress.n % chunk) % chunk, P, n_pad)
    col_valid = np.zeros(n + n_pad, dtype=bool)
    col_valid[:n] = True
    col_mask = np.packbits(col_valid, bitorder="little").view("<i4").copy()

    def put(x):
        return torch.as_tensor(x, device=dev)

    return (
        put(pod_kv), put(pod_key), put(pod_ns), put(enc.ns_kv), put(enc.ns_key),
        as_tensors(enc.pol_sel, dev), put(enc.pol_ns),
        put(enc.pol_affects_ingress), put(enc.pol_affects_egress),
        as_tensors(ingress, dev), as_tensors(egress, dev), put(col_mask),
    )


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
    *inputs, col_mask = _device_args(enc, tile, chunk, dev)
    _, sel_ing8, sel_eg8, ing_iso, eg_iso, ing_by_pol, eg_by_pol = _policy_maps(
        *inputs, chunk=chunk, direction_aware_isolation=direction_aware_isolation
    )
    return (
        ing_by_pol, sel_ing8, sel_eg8, eg_by_pol,
        _not_iso(ing_iso), _not_iso(eg_iso), col_mask,
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
        if self._on_host:
            ufunc = np.bitwise_and if op == "and" else np.bitwise_or
            return ufunc.reduce(words, axis=0)
        return to_host_words(_device_word_reduce(words, op))

    def all_reachable(self) -> List[int]:
        """Pods reachable from every pod (``kano/algorithm.py:4-9``)."""
        conj = self._word_reduce("and")
        return np.nonzero(unpack_cols(conj[None, :], self.n_pods)[0])[0].tolist()

    def all_isolated(self) -> List[int]:
        """Pods reachable from no pod (``kano/algorithm.py:12-17``)."""
        disj = self._word_reduce("or")
        return np.nonzero(~unpack_cols(disj[None, :], self.n_pods)[0])[0].tolist()

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
        (``kano/algorithm.py:45-55``); unpacks one row only."""
        return np.nonzero(~self.row(idx))[0].tolist()

    def closure(self, *_, **__) -> "PackedReach":
        raise ConfigError(
            "the packed closure is not ported yet: ROADMAP.md, 'Modules to "
            "port', the packed closure (ops/closure.py)"
        )

    def user_crosscheck(self, objs, label: str) -> List[int]:
        """Pods reachable from a pod of a *different* user group
        (``kano/algorithm.py:27-42``) without unpacking: U per-group row-ORs
        + a prefix/suffix OR over the [U, W] table answer all dsts at once."""
        from .queries import user_groups

        gid = user_groups(objs, label)
        if gid.shape[0] != self.n_pods:
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
        return _crosscheck_from_group_or(group_or, gid, self.n_pods)


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

    ``use_kernel=None`` auto-selects: the CUDA kernel ``packed_dir_allow``
    on a CUDA device, the torch sweep otherwise. ``use_kernel=True`` on the
    CPU runs the kernel's plain version through the same wrapper.

    ``fetch=False`` leaves the packed matrix on the device
    (``PackedReach.packed`` is an int32 tensor) and synchronises on the
    reachable-pair count instead (``timings["reachable_pairs"]``)."""
    dev = resolve_device(device)
    if len(enc.atoms) > 1:
        raise ConfigError(_PORTS_TODO)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    n = enc.n_pods
    tile = max(32, min(tile, 1 << 20))
    if tile % 32:
        raise ConfigError("tile must be a multiple of 32")
    if use_kernel and tile % N_TILE:
        raise ConfigError(f"use_kernel requires tile % {N_TILE} == 0 (kernel tile)")
    t0 = time.perf_counter()
    packed, ing_iso, eg_iso, selected = _tiled_step(
        *_device_args(enc, tile, chunk, dev),
        tile=tile,
        chunk=chunk,
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
        direction_aware_isolation=direction_aware_isolation,
        use_kernel=use_kernel,
    )
    if fetch:
        packed_out = to_host_words(packed[:n])
        label = "solve+fetch"
    else:
        # synchronise on the pair count, not on the 1.25 GB matrix
        total = packed_pair_total(packed[:n])
        packed_out = packed[:n]
        label = "solve"
    t1 = time.perf_counter()
    out = PackedReach(
        packed=packed_out,
        n_pods=n,
        ingress_isolated=ing_iso[:n].cpu().numpy(),
        egress_isolated=eg_iso[:n].cpu().numpy(),
        selected=None,
        timings={label: t1 - t0},
        meta={"kernel": "packed_dir_allow" if use_kernel else "torch-sweep"},
    )
    if not fetch:
        out.timings["reachable_pairs"] = total
    else:
        out.selected = selected[:, :n].cpu().numpy()
    return out
