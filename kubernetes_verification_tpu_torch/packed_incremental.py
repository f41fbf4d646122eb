"""Packed incremental re-verify — BASELINE config 5's diff path at scale.

The port of ``kubernetes_verification_tpu.packed_incremental``. The engine
keeps the *policy-space* decomposition the tiled solver builds transiently
(``ops/tiled.py``) as device-resident state:

* four int8 per-policy maps (``sel_ing``/``sel_eg`` selection,
  ``ing_by_pol``/``eg_by_pol`` peer maps), held **pod-major**, ``[Np, C]``:
  C is the slot capacity (policies + headroom), Np the padded pod count. The
  JAX package holds them ``[C, Np]``; the transpose makes every product of
  this engine K-contiguous with no copy (int8 tensor cores multiply only
  K-contiguous operands on Hopper), including the build, which launches the
  hand-written ``packed_dir_allow`` kernel straight on the maps;
* two int32 ``[Np]`` isolation *count* vectors (how many policies select each
  pod per direction — exact add/remove);
* the bit-packed reachability matrix, int32 words ``[Np, Np/32]`` with the
  reference's uint32 bit pattern.

At the flagship 100k-pod / 10k-policy config this is 4 × 1.0 GB of maps and
1.25 GB of words on one GPU.

A policy diff re-encodes one policy against the frozen vocab on the host
(``PolicyVectorizer``), writes its slot (a strided column of each map),
patches the isolation counts, and recomputes exactly the touched source rows
and the touched destination columns from the maps: two int8 products each
(``ops/closure.py::bool_dot``), packed and merged into the words. A pod
relabel patches one pod row of each map plus the pod's own row and column
of the words. Pods churn through the same slot mechanism on the pod axis:
the padded rows ``[n, Np)`` (plus ``pod_headroom``) are free pod slots, and
removed pods return their slot to a free list.

Differences from the JAX engine, none of which changes a bit of state:

* the state is updated in place instead of donated, so ``closure_packed``
  stores its base as a copy and a caller that aliases the maps or words
  (``ops/device_state.py``) sees later diffs;
* a diff is a short sequence of eager calls instead of one fused jitted
  dispatch, so nothing is prewarmed and no index group is padded to a fixed
  size; the engine still grows its slot axis where the JAX prewarm does
  (no free slot left after a build, a resume or a pod-axis growth);
* the single-device form only: the mesh-sharded state is ROADMAP §1 item 12,
  the ``kvtpu_*`` metrics and the dispatch tracker item 14.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .backends.base import VerifyConfig
from .encode.encoder import (
    GrantBlock,
    SelectorEnc,
    cluster_vocab,
    encode_cluster,
    encode_policy_delta,
)
from .encode.ports import ALL_ATOM
from .models.core import Cluster, Namespace, NetworkPolicy, Pod
from .ops.bits import or_diagonal, pack_bool_cols, to_host_words
from .ops.closure import _words, bool_dot
from .ops.kernels import packed_dir_allow_pod_major
from .ops.padding import pad_grants, pad_pods
from .ops.tiled import HostArgs, PackedReach, _not_iso, _policy_maps
from .ops.tiled import _put as _put_args
from .resilience.errors import ConfigError, ServeError
from .resilience.retry import RetryPolicy, retry_transient
from .runtime import resolve_device

__all__ = ["PackedIncrementalVerifier", "PolicyVectorizer", "pod_policy_flags"]

_I8 = torch.int8
_I32 = torch.int32

#: max rows recomputed per row patch (bounds the [rows, Np] int32 counts)
_ROW_GROUP = 512
#: max dst columns recomputed per column patch (bounds the [Np, cols] counts)
_COL_GROUP = 256


def _groups(idx: np.ndarray, cap: int) -> Iterable[np.ndarray]:
    """Split an index list into buckets of at most ``cap`` entries. The JAX
    package pads every bucket to ``cap`` (one compile per patch kernel);
    eager torch compiles nothing, so the buckets stay unpadded."""
    for i in range(0, len(idx), cap):
        yield np.asarray(idx[i : i + cap], dtype=np.int64)


def _copy_pods(pods) -> List[Pod]:
    """Deep-enough copies of the caller's pods: an aliased label or port
    dict mutated in place would otherwise change the engine's state."""
    return [
        dataclasses.replace(
            p, labels=dict(p.labels), container_ports=dict(p.container_ports)
        )
        for p in pods
    ]


def _bit(j: int) -> int:
    """The int32 value of bit ``j`` of a word (bit 31 is the sign bit)."""
    return -(1 << 31) if j == 31 else 1 << j


# ---------------------------------------------------------------------------
# single-policy contribution vectors (host)
# ---------------------------------------------------------------------------


def pod_policy_flags(
    pol: NetworkPolicy,
    pod: Pod,
    ns_labels: Dict[str, Dict[str, str]],
    direction_aware: bool,
) -> Tuple[bool, bool, bool, bool]:
    """(sel_ing, sel_eg, ing_peer, eg_peer) for one (policy, pod) pair —
    object-level semantics (the CPU oracle's), used to fix up the vectors of
    pods whose labels diverged from the frozen encoding."""
    aff_i = pol.affects_ingress if direction_aware else True
    aff_e = pol.affects_egress if direction_aware else True
    selected = pod.namespace == pol.namespace and pol.pod_selector.matches(
        pod.labels
    )

    def peer_one(rules) -> bool:
        for rule in rules or ():
            if rule.matches_all_peers:
                return True
            for peer in rule.peers:
                if peer.ip_block is not None:
                    if peer.ip_block.matches_ip(pod.ip):
                        return True
                    continue
                if peer.namespace_selector is None:
                    ns_ok = pod.namespace == pol.namespace
                else:
                    ns_ok = peer.namespace_selector.matches(
                        ns_labels.get(pod.namespace, {})
                    )
                if ns_ok and (
                    peer.pod_selector is None
                    or peer.pod_selector.matches(pod.labels)
                ):
                    return True
        return False

    return (
        selected and aff_i,
        selected and aff_e,
        aff_i and peer_one(pol.ingress),
        aff_e and peer_one(pol.egress),
    )


class PolicyVectorizer:
    """Computes one policy's four contribution vectors on the HOST against a
    frozen cluster encoding, via inverted label-index posting lists, with
    object-semantics fixups for label-drifted pods. The engine derives its
    patch row/column sets from these vectors without fetching device state.
    (A copy of the JAX package's class: numpy only.)"""

    def __init__(
        self,
        pods: Sequence[Pod],
        ns_labels: Dict[str, Dict[str, str]],
        vocab,
        ns_index: Dict[str, int],
        direction_aware: bool,
    ) -> None:
        self.pods = pods  # live reference — callers mutate labels in place
        self.ns_labels = ns_labels
        self.vocab = vocab
        self.ns_index = dict(ns_index)
        self.direction_aware = direction_aware
        self.n = len(pods)
        #: pods whose labels/namespace fall outside the frozen universe —
        #: these re-evaluate object-level on every later policy (re-)encode
        self.dirty: set = set()
        #: removed pod slots — their vectors are forced to 0 so a later
        #: policy re-encode can never resurrect a tombstoned pod
        self.inactive: set = set()
        #: namespaces known at freeze time: pods churned into them can be
        #: re-indexed in place; later-created namespaces have no row in the
        #: frozen namespace matrices, so their pods stay dirty
        self._n_frozen_ns = len(self.ns_index)
        # inverted indices over the (frozen, then churn-patched) pod labels:
        # pair/key/ns → pod ids, plus the per-pod reverse entries that make
        # single-pod re-indexing O(labels)
        pair_pods: Dict[int, List[int]] = {}
        key_pods: Dict[int, List[int]] = {}
        ns_pods: Dict[int, List[int]] = {}
        self._pod_entries: Dict[int, Tuple[List[int], List[int], int]] = {}
        for i, pod in enumerate(pods):
            ns_idx = self.ns_index.get(pod.namespace, -3)
            ns_pods.setdefault(ns_idx, []).append(i)
            pairs: List[int] = []
            keyids: List[int] = []
            for k, v in pod.labels.items():
                pid = vocab.pair(k, v)
                if pid is not None:
                    pair_pods.setdefault(pid, []).append(i)
                    pairs.append(pid)
                kid = vocab.key(k)
                if kid is not None:
                    key_pods.setdefault(kid, []).append(i)
                    keyids.append(kid)
            self._pod_entries[i] = (pairs, keyids, ns_idx)
        as_arr = lambda d: {
            k: np.asarray(v, dtype=np.int64) for k, v in d.items()
        }
        self._pair_pods = as_arr(pair_pods)
        self._key_pods = as_arr(key_pods)
        self._ns_pods = as_arr(ns_pods)
        self._empty = np.asarray([], dtype=np.int64)

    def _mask_of(self, idx: np.ndarray) -> np.ndarray:
        m = np.zeros(self.n, dtype=bool)
        m[idx] = True
        return m

    def _sel_mask(self, enc: SelectorEnc, row: int) -> np.ndarray:
        """bool [n]: which (frozen-label) pods match selector ``row``."""
        if enc.impossible[row]:
            return np.zeros(self.n, dtype=bool)
        acc = np.ones(self.n, dtype=bool)
        for pid in np.nonzero(enc.req_eq[row])[0]:
            acc &= self._mask_of(self._pair_pods.get(int(pid), self._empty))
        for kid in np.nonzero(enc.req_key[row])[0]:
            acc &= self._mask_of(self._key_pods.get(int(kid), self._empty))
        forb = np.nonzero(enc.forbid_eq[row])[0]
        for pid in forb:
            acc &= ~self._mask_of(self._pair_pods.get(int(pid), self._empty))
        for kid in np.nonzero(enc.forbid_key[row])[0]:
            acc &= ~self._mask_of(self._key_pods.get(int(kid), self._empty))
        E = enc.in_mask.shape[1]
        for e in range(E):
            if not enc.in_valid[row, e]:
                continue
            hit = np.zeros(self.n, dtype=bool)
            for pid in np.nonzero(enc.in_mask[row, e])[0]:
                hit |= self._mask_of(self._pair_pods.get(int(pid), self._empty))
            acc &= hit
        return acc

    def _ns_mask(self, ns_idx: int) -> np.ndarray:
        return self._mask_of(self._ns_pods.get(ns_idx, self._empty))

    def _ns_selector_mask(self, pol: NetworkPolicy, peer) -> np.ndarray:
        """Pods whose namespace matches the peer's namespaceSelector (object
        semantics over the handful of namespaces)."""
        acc = np.zeros(self.n, dtype=bool)
        for ns_name, idx in self.ns_index.items():
            if peer.namespace_selector.matches(self.ns_labels.get(ns_name, {})):
                acc |= self._ns_mask(idx)
        return acc

    def _peer_union(
        self, pol: NetworkPolicy, block: GrantBlock, rules
    ) -> np.ndarray:
        """bool [n]: union of a direction's peer grants. ``block`` carries the
        compiled pod selectors + precomputed ipBlock↔pod-IP rows; the peer
        objects (same flattening order as ``_encode_grants``) supply the
        namespace scope."""
        acc = np.zeros(self.n, dtype=bool)
        peers_flat: List = []
        for rule in rules or ():
            if rule.matches_all_peers:
                peers_flat.append(None)  # match-all grant row
            else:
                peers_flat.extend(rule.peers)
        pol_ns = self.ns_index.get(pol.namespace, -2)
        for g in range(block.n):
            peer = peers_flat[g]
            if peer is None or bool(block.match_all[g]):
                return np.ones(self.n, dtype=bool)
            if bool(block.is_ipblock[g]):
                acc |= block.ip_match[g]
                continue
            m = self._sel_mask(block.pod_sel, g)
            if peer.namespace_selector is None:
                m &= self._ns_mask(pol_ns)
            else:
                m &= self._ns_selector_mask(pol, peer)
            acc |= m
        return acc

    def vectors(self, pol: NetworkPolicy) -> Tuple[np.ndarray, ...]:
        """(sel_ing, sel_eg, ing_peers, eg_peers) int8 [n], host arrays."""
        delta = encode_policy_delta(
            pol, self.vocab, [ALL_ATOM], self.ns_index, self.pods
        )
        selected = self._sel_mask(delta.pod_sel, 0) & self._ns_mask(delta.pol_ns)
        aff_i = delta.affects_ingress if self.direction_aware else True
        aff_e = delta.affects_egress if self.direction_aware else True
        sel_ing = selected if aff_i else np.zeros(self.n, dtype=bool)
        sel_eg = selected if aff_e else np.zeros(self.n, dtype=bool)
        ing_peers = (
            self._peer_union(pol, delta.ingress, pol.ingress)
            if aff_i
            else np.zeros(self.n, dtype=bool)
        )
        eg_peers = (
            self._peer_union(pol, delta.egress, pol.egress)
            if aff_e
            else np.zeros(self.n, dtype=bool)
        )
        out = [sel_ing, sel_eg, ing_peers, eg_peers]
        for i in sorted(self.dirty):
            flags = pod_policy_flags(
                pol, self.pods[i], self.ns_labels, self.direction_aware
            )
            for v, f in zip(out, flags):
                v[i] = f
        for i in self.inactive:
            for v in out:
                v[i] = False
        return tuple(v.astype(np.int8) for v in out)

    def _strip(self, idx: int) -> None:
        """Remove pod ``idx`` from every inverted index (O(labels) via the
        reverse entry)."""
        e = self._pod_entries.pop(idx, None)
        if e is None:
            return
        pairs, keyids, ns_idx = e
        for pid in pairs:
            a = self._pair_pods.get(pid)
            if a is not None:
                self._pair_pods[pid] = a[a != idx]
        for kid in keyids:
            a = self._key_pods.get(kid)
            if a is not None:
                self._key_pods[kid] = a[a != idx]
        a = self._ns_pods.get(ns_idx)
        if a is not None:
            self._ns_pods[ns_idx] = a[a != idx]

    def note_pod(self, idx: int) -> None:
        """Register pod slot ``idx`` as (re)occupied or relabeled: the live
        ``self.pods`` list already holds the new Pod. When its namespace and
        every label pair/key lie inside the frozen universe, the inverted
        indices are patched in place; otherwise it joins the permanent
        object-semantics dirty set (a frozen-vocab evaluation would be
        unsound for a pair the vocab never saw)."""
        self.n = len(self.pods)
        self.inactive.discard(idx)
        self._strip(idx)
        pod = self.pods[idx]
        ns_idx = self.ns_index.get(pod.namespace, -3)
        clean = 0 <= ns_idx < self._n_frozen_ns
        pairs: List[int] = []
        keyids: List[int] = []
        for k, v in pod.labels.items():
            pid = self.vocab.pair(k, v)
            kid = self.vocab.key(k)
            if pid is None or kid is None:
                clean = False
                break
            pairs.append(pid)
            keyids.append(kid)
        if not clean:
            self.dirty.add(idx)
            return
        self.dirty.discard(idx)
        add = lambda d, key: d.__setitem__(
            key, np.append(d.get(key, self._empty), np.int64(idx))
        )
        for pid in pairs:
            add(self._pair_pods, pid)
        for kid in keyids:
            add(self._key_pods, kid)
        add(self._ns_pods, ns_idx)
        self._pod_entries[idx] = (pairs, keyids, ns_idx)

    def note_removed(self, idx: int) -> None:
        self._strip(idx)
        self.inactive.add(idx)
        self.dirty.discard(idx)


# ---------------------------------------------------------------------------
# device steps: plain functions on the pod-major state, updated in place
# ---------------------------------------------------------------------------
#
# ``maps`` is the tuple (sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt,
# eg_cnt): four int8 [Np, C] maps and two int32 [Np] counts. ``col_mask`` is
# int32 [Np/32] (the packed validity of the dst columns), ``row_valid`` int8
# [Np], ``packed`` int32 [Np, Np/32].


def _reach_block(
    ing_by_pol_s,  # int8 [S, C] — src-side ingress peer operand
    sel_ing_d,  # int8 [D, C] — dst-side ingress selection operand
    sel_eg_s,  # int8 [S, C] — src-side egress selection operand
    eg_by_pol_d,  # int8 [D, C] — dst-side egress peer operand
    ing_cnt_d,  # int32 [D]
    eg_cnt_s,  # int32 [S]
    src_ids,  # int [S] — global pod ids of the block's rows
    dst_ids,  # int [D] — global pod ids of the block's columns
    self_traffic: bool,
    default_allow: bool,
) -> torch.Tensor:
    """THE reach formula for an arbitrary (src rows × dst cols) block, bool
    [S, D] — the single copy shared by the row patch, the column patch, the
    pod step, the stripe and row re-solves and the packed query twins. Both
    products contract the slot axis of K-contiguous pod-major rows."""
    r = bool_dot(ing_by_pol_s, sel_ing_d) > 0
    eg_ok = bool_dot(sel_eg_s, eg_by_pol_d) > 0
    if default_allow:
        r |= ~(ing_cnt_d > 0)[None, :]
        eg_ok |= ~(eg_cnt_s > 0)[:, None]
    r &= eg_ok
    if self_traffic:
        r |= src_ids[:, None] == dst_ids[None, :]
    return r


def _slot_write(maps, slot: int, new4: torch.Tensor) -> None:
    """Write one policy slot's four vectors (int8 [4, Np]) — a strided
    column of each pod-major map — and patch the isolation counts by the
    selection deltas."""
    sel_ing8, sel_eg8, _, _, ing_cnt, eg_cnt = maps
    ing_cnt += new4[0].to(_I32) - sel_ing8[:, slot].to(_I32)
    eg_cnt += new4[1].to(_I32) - sel_eg8[:, slot].to(_I32)
    for m, v in zip(maps[:4], new4):
        m[:, slot] = v


def _stripe_step(
    maps, col_mask, row_valid, d0: int, *, width: int,
    self_traffic: bool, default_allow: bool,
) -> torch.Tensor:
    """Re-solve dst stripe ``[d0, d0 + width)`` of the packed matrix straight
    from the maps — the re-verify primitive of the matrix-free mode. Returns
    int32 [Np, width/32]."""
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt = maps
    Np = sel_ing8.shape[0]
    d1 = d0 + width
    dev = sel_ing8.device
    r = _reach_block(
        ing_by_pol, sel_ing8[d0:d1], sel_eg8, eg_by_pol[d0:d1],
        ing_cnt[d0:d1], eg_cnt,
        torch.arange(Np, device=dev), torch.arange(d0, d1, device=dev),
        self_traffic, default_allow,
    )
    r &= (row_valid > 0)[:, None]
    return pack_bool_cols(r) & col_mask[None, d0 // 32 : d1 // 32]


def _rows_step(
    maps, col_mask, row_valid, rows: torch.Tensor, *,
    self_traffic: bool, default_allow: bool,
) -> torch.Tensor:
    """Re-solve the packed reach ROWS of ``rows`` (int64 [K]) straight from
    the maps — the transpose of ``_stripe_step``, a skinny [K, Np] block;
    the row oracle of the bounded closure at matrix-free scale. Returns
    int32 [K, Np/32]."""
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt = maps
    Np = sel_ing8.shape[0]
    r = _reach_block(
        ing_by_pol[rows], sel_ing8, sel_eg8[rows], eg_by_pol,
        ing_cnt, eg_cnt[rows],
        rows, torch.arange(Np, device=rows.device),
        self_traffic, default_allow,
    )
    r &= (row_valid[rows] > 0)[:, None]
    return pack_bool_cols(r) & col_mask[None, :]


def _apply_pod_col(maps, idx: int, cols4: torch.Tensor) -> None:
    """Write one pod's row of every pod-major map (int8 [4, C]: its flag
    against every policy slot) and its isolation counts."""
    for m, c in zip(maps[:4], cols4):
        m[idx] = c
    maps[4][idx] = cols4[0].sum(dtype=_I32)
    maps[5][idx] = cols4[1].sum(dtype=_I32)


def _apply_pod_cols_group(maps, idxs: torch.Tensor, cols4: torch.Tensor) -> None:
    """Write a GROUP of pods' rows (``idxs`` int64 [G], unique; ``cols4``
    int8 [4, G, C]) across every map, and their isolation counts — the
    batched ``_apply_pod_col`` a namespace relabel needs."""
    for m, c in zip(maps[:4], cols4):
        m[idxs] = c
    maps[4][idxs] = cols4[0].sum(dim=1, dtype=_I32)
    maps[5][idxs] = cols4[1].sum(dim=1, dtype=_I32)


def _pod_step_mf(
    maps, col_mask, row_valid, idx: int, cols4: torch.Tensor, active: bool
) -> None:
    """Pod add (``active``) or remove: the pod's rows of the maps, its
    isolation counts, its validity bit in the column mask and its row
    validity — the matrix-free half of ``_pod_step``."""
    _apply_pod_col(maps, idx, cols4)
    w, bit = idx // 32, _bit(idx % 32)
    col_mask[w : w + 1] &= ~bit
    if active:
        col_mask[w : w + 1] |= bit
    row_valid[idx] = int(active)


def _pod_step(
    packed, maps, col_mask, row_valid, idx: int, cols4: torch.Tensor,
    active: bool, *, self_traffic: bool, default_allow: bool,
) -> None:
    """One pod add/remove: ``_pod_step_mf``, then exactly the pod's own
    packed row and its own bit-column recomputed against the NEW maps — a
    pod only contributes its own row and column to the matrix."""
    _pod_step_mf(maps, col_mask, row_valid, idx, cols4, active)
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt = maps
    Np = sel_ing8.shape[0]
    dev = sel_ing8.device
    one = torch.tensor([idx], device=dev)
    ar = torch.arange(Np, device=dev)
    if active:
        r_row = _reach_block(
            ing_by_pol[one], sel_ing8, sel_eg8[one], eg_by_pol,
            ing_cnt, eg_cnt[one], one, ar, self_traffic, default_allow,
        )  # [1, Np]
        packed[idx] = pack_bool_cols(r_row)[0] & col_mask
    else:
        packed[idx] = 0
    w, bit = idx // 32, _bit(idx % 32)
    col = packed[:, w] & ~bit
    if active:
        r_col = _reach_block(
            ing_by_pol, sel_ing8[one], sel_eg8, eg_by_pol[one],
            ing_cnt[one], eg_cnt, ar, one, self_traffic, default_allow,
        )[:, 0]  # [Np]
        col |= (r_col & (row_valid > 0)).to(_I32) * bit
    packed[:, w] = col


def _patch_rows(
    packed, maps, col_mask, rows: torch.Tensor, *,
    self_traffic: bool, default_allow: bool,
) -> None:
    """Recompute the full packed rows of the touched sources ``rows``
    (int64 [K], unique) and write them."""
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt = maps
    Np = sel_ing8.shape[0]
    r = _reach_block(
        ing_by_pol[rows], sel_ing8, sel_eg8[rows], eg_by_pol,
        ing_cnt, eg_cnt[rows], rows, torch.arange(Np, device=rows.device),
        self_traffic, default_allow,
    )
    packed[rows] = pack_bool_cols(r) & col_mask[None, :]


def _patch_cols(
    packed, maps, row_valid, cols: torch.Tensor, seg: torch.Tensor,
    words: torch.Tensor, clear: torch.Tensor, *,
    self_traffic: bool, default_allow: bool,
) -> None:
    """Recompute exactly the touched dst columns (not their whole 32-column
    words), fold each column's bit into its word with an int32 ``index_add_``
    over ``seg`` (the bits of one word are distinct powers of two, the sign
    bit included, so every partial sum is exact and equals the OR), and
    write back only the real words.

    cols:  int64 [Dc] — unique, sorted; seg: int64 [Dc] — each col's slot
    in ``words``; words: int64 [Dw] — unique word indices; clear: int32
    [Dw] — per word, the OR of its cols' bits."""
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt = maps
    Np = sel_ing8.shape[0]
    r = _reach_block(
        ing_by_pol, sel_ing8[cols], sel_eg8, eg_by_pol[cols],
        ing_cnt[cols], eg_cnt, torch.arange(Np, device=cols.device), cols,
        self_traffic, default_allow,
    )
    # tombstoned/padded source rows must stay zero — without this mask a
    # later policy diff would resurrect reach bits in a removed pod's row
    # (its eg_cnt is 0, so default-allow marks it egress-open)
    r &= (row_valid > 0)[:, None]
    one = torch.ones((), dtype=_I32, device=cols.device)
    bits = r.to(_I32) * (one << (cols % 32).to(_I32))[None, :]  # [Np, Dc]
    set_words = torch.zeros((Np, words.shape[0]), dtype=_I32, device=cols.device)
    set_words.index_add_(1, seg, bits)
    packed[:, words] = (packed[:, words] & ~clear[None, :]) | set_words


def _diff_step(
    packed, maps, col_mask, row_valid, slot: int, new4: torch.Tensor,
    row_groups, col_groups, *, self_traffic: bool, default_allow: bool,
) -> None:
    """One policy diff: the slot write with its isolation counts, then the
    touched row groups and column groups (``_col_meta`` tensors) re-derived
    from the updated maps."""
    _slot_write(maps, slot, new4)
    flags = dict(self_traffic=self_traffic, default_allow=default_allow)
    for rows in row_groups:
        _patch_rows(packed, maps, col_mask, rows, **flags)
    for cols, seg, words, clear in col_groups:
        _patch_cols(packed, maps, row_valid, cols, seg, words, clear, **flags)


def _build_maps(a: HostArgs, capacity: int, *, chunk: int, direction_aware: bool):
    """Batched init: the tiled solver's prologue (``_policy_maps``), kept as
    state — the four maps pod-major with ``capacity`` slots (the slots past
    the policies zero), and the two isolation counts."""
    P = a.pol_ns.shape[0]
    _, sel_ing8, sel_eg8, _, _, ing_by_pol, eg_by_pol = _policy_maps(
        a, chunk=chunk, direction_aware_isolation=direction_aware
    )
    if direction_aware:
        # match the per-policy vector convention (peer side gated too);
        # redundant for reach — sel gating covers it — but keeps slots
        # byte-identical with PolicyVectorizer outputs
        ing_by_pol = ing_by_pol * a.aff_ing.to(_I8)[:, None]
        eg_by_pol = eg_by_pol * a.aff_eg.to(_I8)[:, None]
    ing_cnt = sel_ing8.sum(dim=0, dtype=_I32)
    eg_cnt = sel_eg8.sum(dim=0, dtype=_I32)

    def pod_major(m: torch.Tensor) -> torch.Tensor:
        out = m.new_zeros((m.shape[1], capacity))
        out[:, :P] = m.t()
        return out

    return (
        pod_major(sel_ing8), pod_major(sel_eg8), pod_major(ing_by_pol),
        pod_major(eg_by_pol), ing_cnt, eg_cnt,
    )


def _build_packed(
    maps, col_mask, row_valid, *, self_traffic: bool, default_allow: bool
) -> torch.Tensor:
    """The packed matrix of the maps: one ``packed_dir_allow`` per direction
    on the pod-major maps (the hand-written kernel on a CUDA device, its
    plain version on the CPU), the word-wise AND, the self-traffic diagonal,
    the column mask, and the invalid rows zeroed (``_mask_rows``)."""
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt = maps
    out = packed_dir_allow_pod_major(
        ing_by_pol, sel_ing8, _not_iso(ing_cnt > 0),
        default_allow_axis=1 if default_allow else -1,
    )
    out &= packed_dir_allow_pod_major(
        sel_eg8, eg_by_pol, _not_iso(eg_cnt > 0),
        default_allow_axis=0 if default_allow else -1,
    )
    if self_traffic:
        or_diagonal(out)
    out &= col_mask[None, :]
    _mask_rows(out, row_valid)
    return out


def _mask_rows(packed, row_valid) -> None:
    """Zero the padded/invalid ROWS in place (the build masks columns only):
    their junk default-allow bits never reach queries, but later exact
    column patches clear them, which the delta closure's base comparison
    would misread as removed pairs."""
    packed[row_valid == 0] = 0


def _pack_pod_axis(m: torch.Tensor) -> torch.Tensor:
    """int8 [Np, C] pod-major map → uint8 [C, Np/8]: the JAX layout's
    ``np.packbits(map, axis=1, bitorder="little")``, packed on the map's
    device: byte ``b`` of slot ``c`` ORs rows ``8b .. 8b+7``, read as eight
    strided [Np/8, C] views; only the packed bytes are transposed."""
    Np, C = m.shape
    v = m.view(torch.uint8).reshape(Np // 8, 8, C)
    out = v[:, 0].clone()
    for k in range(1, 8):
        out |= v[:, k] << k
    return out.t().contiguous()


def _unpack_pod_axis(packed: np.ndarray, Np: int, device) -> torch.Tensor:
    """The inverse of ``_pack_pod_axis``: uint8 [C, Np/8] → int8 [Np, C].
    The packed bytes are transposed first (an eighth of the output), then
    each byte row unpacks into eight pod rows, already pod-major."""
    p = torch.as_tensor(np.ascontiguousarray(packed), device=device)
    pt = p.t().contiguous()  # [Np/8, C]
    shifts = torch.arange(8, dtype=torch.uint8, device=device)[:, None]
    bits = (pt[:, None, :] >> shifts) & 1  # [Np/8, 8, C]
    return bits.reshape(Np, p.shape[0]).view(_I8)


def _host_words(t: torch.Tensor) -> np.ndarray:
    """``to_host_words`` that never aliases the engine's state: on the CPU
    the numpy view would follow later in-place diffs, so it is copied."""
    return to_host_words(t).copy() if t.device.type == "cpu" else to_host_words(t)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class PackedIncrementalVerifier:
    """Maintains a packed reachability matrix under policy / pod / namespace
    diffs, with every piece of state device-resident, at the 100k-pod
    flagship scale a dense count matrix cannot reach.

    ``device=None`` means ``"cuda"`` (``BackendError`` without a GPU); the
    CPU runs only when the caller passes ``device="cpu"``.
    """

    #: engine kind the serving plane keys on (``serve/service.py``: a
    #: ``"packed"`` engine answers queries from its word state)
    metrics_engine = "packed"

    #: transient-failure budget around the stripe and row re-solves; assign
    #: a tuned RetryPolicy on the instance to change it
    retry_policy = RetryPolicy()

    def __init__(
        self,
        cluster: Cluster,
        config: Optional[VerifyConfig] = None,
        device=None,
        slot_round: int = 256,
        chunk: int = 2048,
        keep_matrix: Optional[bool] = None,
        pod_headroom: int = 0,
    ) -> None:
        """``pod_headroom``: extra pod slots padded in at build time so
        ``add_pod`` never has to grow (a grow copies every device buffer).
        ``keep_matrix=False`` skips materialising the packed matrix: diffs
        update the maps and counts only, touched rows/columns accumulate in
        ``dirty_rows``/``dirty_cols``, and ``solve_stripe`` re-verifies any
        dst range straight from the maps."""
        self.config = config or VerifyConfig()
        self.device = resolve_device(device)
        if pod_headroom < 0:
            raise ConfigError("pod_headroom must be >= 0")
        self.pods: List[Pod] = _copy_pods(cluster.pods)
        self.namespaces = list(cluster.namespaces)
        self.policies: Dict[str, NetworkPolicy] = {}
        self._slot: Dict[str, int] = {}
        self.update_count = 0
        #: cached transitive closure + nodes touched since (closure_packed)
        self._closure = None
        self._closure_base = None
        self._closure_dirty: Optional[np.ndarray] = None
        cfg = self.config
        timings: Dict[str, float] = {}

        t0 = time.perf_counter()
        snapshot = Cluster(
            pods=self.pods,
            namespaces=self.namespaces,  # __post_init__ appends missing ns
            policies=list(cluster.policies),
        )
        # label dicts are COPIED: an aliased caller dict mutated in place
        # would satisfy the relabel no-op guard and silently skip the
        # re-derivation (pods are deep-copied for the same reason)
        self._ns_labels = {ns.name: dict(ns.labels) for ns in self.namespaces}
        enc = encode_cluster(snapshot, compute_ports=False)
        n = enc.n_pods
        self.n_pods = n
        align = 128
        self._pod_align = align
        Np = max(align, -(-(n + pod_headroom) // align) * align)
        self._n_padded = Np
        n_pad = Np - n
        pod_kv, pod_key, pod_ns = pad_pods(enc.pod_kv, enc.pod_key, enc.pod_ns, n_pad)
        # pod-slot bookkeeping: [0, n_pods) is the high-water mark of ever-
        # occupied slots; [n_pods, Np) is headroom; removed slots recycle
        self.pod_active = np.ones(n, dtype=bool)
        self._pod_free: List[int] = []
        self._pod_idx: Dict[str, int] = {}
        for i, p in enumerate(self.pods):
            self._pod_idx.setdefault(self._pod_key(p), i)
        self._col_valid = np.zeros(Np, dtype=bool)
        self._col_valid[:n] = True
        col_mask = self._col_mask_host()
        self._col_mask = self._put(col_mask)
        rv = np.zeros(Np, dtype=np.int8)
        rv[:n] = 1
        self._row_valid = self._put(rv)
        timings["encode"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        P = enc.n_policies
        self._slot_round = slot_round
        g_chunk = max(1, min(chunk, max(enc.ingress.n, enc.egress.n, 1)))
        args = _put_args(HostArgs(
            pod_kv, pod_key, pod_ns, enc.ns_kv, enc.ns_key, enc.pol_sel,
            enc.pol_ns, enc.pol_affects_ingress, enc.pol_affects_egress,
            pad_grants(enc.ingress, (-enc.ingress.n) % g_chunk, P, n_pad),
            pad_grants(enc.egress, (-enc.egress.n) % g_chunk, P, n_pad),
            col_mask,
        ), self.device)
        self._capacity = max(slot_round, -(-(P + 8) // slot_round) * slot_round)
        (
            self._sel_ing8, self._sel_eg8, self._ing_by_pol, self._eg_by_pol,
            self._ing_cnt, self._eg_cnt,
        ) = _build_maps(
            args, self._capacity, chunk=g_chunk,
            direction_aware=cfg.direction_aware_isolation,
        )
        del args
        self._free = list(range(P, self._capacity))
        for i, pol in enumerate(cluster.policies):
            key = self._key(pol)
            if key in self.policies:
                raise KeyError(f"duplicate policy {key}")
            self.policies[key] = pol
            self._slot[key] = i
        self._sync()
        timings["maps"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self.keep_matrix = True if keep_matrix is None else bool(keep_matrix)
        #: matrix-free mode: touched rows/cols since the last full re-solve
        self.dirty_rows = np.zeros(n, dtype=bool)
        self.dirty_cols = np.zeros(n, dtype=bool)
        self._packed = (
            _build_packed(self._maps, self._col_mask, self._row_valid, **self._flags)
            if self.keep_matrix
            else None
        )
        self._sync()
        timings["kernel"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self._vectorizer = PolicyVectorizer(
            self.pods,
            self._ns_labels,
            enc.vocab,
            {ns.name: i for i, ns in enumerate(self.namespaces)},
            cfg.direction_aware_isolation,
        )
        # host mirrors of the isolation counts (real pods only) — these plus
        # the vectorizer make every diff's row/word derivation host-local
        self._h_ing_cnt = self._ing_cnt[:n].cpu().numpy().astype(np.int64)
        self._h_eg_cnt = self._eg_cnt[:n].cpu().numpy().astype(np.int64)
        self._prewarm()
        timings["vectorizer"] = time.perf_counter() - t0
        #: seconds of the build's phases: host encode, the maps on the
        #: device, the packed matrix (the two kernel launches), the host
        #: vectorizer
        self.build_timings = timings
        self.init_time = sum(timings.values())

    def _put(self, x) -> torch.Tensor:
        """A host array as a tensor of its own on the engine's device."""
        return torch.tensor(np.asarray(x), device=self.device)

    def _sync(self) -> None:
        """Wait for the device (phase timings read the host clock)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _col_mask_host(self) -> np.ndarray:
        """int32 [Np/32]: the packed validity of the pod columns."""
        return np.packbits(self._col_valid, bitorder="little").view("<i4").copy()

    def _prewarm(self) -> None:
        """What remains of the JAX engine's prewarm, which compiles its diff
        kernels through no-op steps after a build, a resume and a pod-axis
        growth. Nothing compiles here; its two effects on the state are
        kept, so the state stays byte-identical to the JAX engine's: the
        slot axis grows when no slot is free (a checkpoint may be saved with
        zero free slots), and the last invalid pod slot is tombstoned again,
        which zeroes the junk its pad column picked up in the peer maps
        (match-all grants)."""
        if not self._free:
            self._grow()
        invalid = np.nonzero(~self._col_valid)[0]
        if len(invalid):
            zeros = self._put(np.zeros((4, self._capacity), dtype=np.int8))
            idx = int(invalid[-1])
            if self._packed is None:
                _pod_step_mf(self._maps, self._col_mask, self._row_valid, idx,
                             zeros, False)
            else:
                _pod_step(self._packed, self._maps, self._col_mask,
                          self._row_valid, idx, zeros, False, **self._flags)

    # ------------------------------------------------------------- plumbing
    def _key(self, pol: NetworkPolicy) -> str:
        return f"{pol.namespace}/{pol.name}"

    @staticmethod
    def _pod_key(pod: Pod) -> str:
        return f"{pod.namespace}/{pod.name}"

    @property
    def _maps(self):
        return (
            self._sel_ing8,
            self._sel_eg8,
            self._ing_by_pol,
            self._eg_by_pol,
            self._ing_cnt,
            self._eg_cnt,
        )

    def _grow(self) -> None:
        slot_round = self._slot_round
        self._free.extend(range(self._capacity, self._capacity + slot_round))
        self._capacity += slot_round
        pad = lambda m: torch.nn.functional.pad(m, (0, slot_round))
        self._sel_ing8 = pad(self._sel_ing8)
        self._sel_eg8 = pad(self._sel_eg8)
        self._ing_by_pol = pad(self._ing_by_pol)
        self._eg_by_pol = pad(self._eg_by_pol)

    def _grow_pods(self, min_extra: int = 1) -> None:
        """Grow the pod axis by at least ``min_extra`` slots (rounded to the
        pod alignment, with a floor of four alignments — a grow copies every
        device buffer, so it must be rare; prefer ``pod_headroom``)."""
        a = self._pod_align
        grow = max(-(-min_extra // a) * a, 4 * a)
        Np2 = self._n_padded + grow
        pad = torch.nn.functional.pad
        self._sel_ing8 = pad(self._sel_ing8, (0, 0, 0, grow))
        self._sel_eg8 = pad(self._sel_eg8, (0, 0, 0, grow))
        self._ing_by_pol = pad(self._ing_by_pol, (0, 0, 0, grow))
        self._eg_by_pol = pad(self._eg_by_pol, (0, 0, 0, grow))
        self._ing_cnt = pad(self._ing_cnt, (0, grow))
        self._eg_cnt = pad(self._eg_cnt, (0, grow))
        self._col_valid = np.concatenate([self._col_valid, np.zeros(grow, dtype=bool)])
        self._col_mask = self._put(self._col_mask_host())
        rv = np.zeros(Np2, dtype=np.int8)
        rv[: self.n_pods] = self.pod_active
        self._row_valid = self._put(rv)
        if self._packed is not None:
            self._packed = pad(self._packed, (0, grow // 32, 0, grow))
        self._n_padded = Np2
        self._closure = None  # shape changed; next closure_packed is full
        self._closure_base = None
        self._prewarm()

    @property
    def _flags(self) -> dict:
        return dict(
            self_traffic=self.config.self_traffic,
            default_allow=self.config.default_allow_unselected,
        )

    def _col_meta(self, idx: np.ndarray):
        """(cols, seg, words, clear) device tensors of one column group
        ``idx`` (unique, sorted): each column's slot among its group's
        unique words, the words, and per word the OR of its columns'
        bits."""
        uw, inv = np.unique(idx // 32, return_inverse=True)
        clear = np.zeros(len(uw), dtype=np.uint32)
        np.bitwise_or.at(clear, inv, np.uint32(1) << (idx % 32).astype(np.uint32))
        return (
            self._put(idx.astype(np.int64)),
            self._put(inv.astype(np.int64)),
            self._put(uw.astype(np.int64)),
            self._put(clear.view(np.int32)),
        )

    def _mark_closure_dirty(self, rows, cols) -> None:
        """Accumulate touched nodes since the last ``closure_packed`` — the
        delta closure's suspect-row seed (``ops/closure.py``)."""
        if self._closure is None:
            return
        self._closure_dirty[rows] = True
        self._closure_dirty[cols] = True

    def closure_packed(self, tile: int = 7168) -> torch.Tensor:
        """Transitive closure of the current packed matrix (int32 [Np, W] on
        the engine's device), incremental across diffs: the first call runs
        the full ``packed_closure``; later calls seed from the previous
        closure and re-derive only rows whose paths could route through a
        node a diff touched (``packed_closure_delta``) — bit-for-bit equal
        to a full re-closure. Pod-axis growth invalidates the cache."""
        if self._packed is None:
            raise ServeError(
                "closure needs the packed matrix; this verifier runs "
                "matrix-free (keep_matrix=False)"
            )
        from .ops.closure import packed_closure, packed_closure_delta

        # _closure_base is a COPY: later diffs update self._packed in place,
        # and an alias would silently follow them. It unlocks the
        # additions-only route (+1 packed matrix of device memory).
        if self._closure is None:
            self._closure = packed_closure(self._packed, tile=tile)
            self._closure_dirty = np.zeros(self._n_padded, dtype=bool)
            self._closure_base = self._packed.clone()
        elif self._closure_dirty.any():
            self._closure = packed_closure_delta(
                self._packed, self._closure, self._closure_dirty,
                prev_base=self._closure_base, tile=tile,
            )
            self._closure_dirty[:] = False
            self._closure_base = self._packed.clone()
        return self._closure

    def _dispatch_diff(
        self, slot: int, new4_padded: np.ndarray, rows: np.ndarray, cols: np.ndarray
    ) -> None:
        """The slot write, then (matrix kept) the touched rows and columns
        re-derived, or (matrix-free) the dirty sets grown."""
        self._mark_closure_dirty(rows, cols)
        new4 = self._put(new4_padded)
        if self._packed is None:
            _slot_write(self._maps, slot, new4)
            self.dirty_rows[rows] = True
            self.dirty_cols[cols] = True
            return
        _diff_step(
            self._packed, self._maps, self._col_mask, self._row_valid, slot, new4,
            [self._put(g) for g in _groups(rows, _ROW_GROUP)],
            [self._col_meta(g) for g in _groups(cols, _COL_GROUP)],
            **self._flags,
        )

    def _patch(self, rows: np.ndarray, cols: np.ndarray) -> None:
        """``rows``/``cols``: unique sorted touched src rows / dst columns."""
        self._mark_closure_dirty(rows, cols)
        for g in _groups(rows, _ROW_GROUP):
            _patch_rows(self._packed, self._maps, self._col_mask, self._put(g),
                        **self._flags)
        for g in _groups(cols, _COL_GROUP):
            _patch_cols(self._packed, self._maps, self._row_valid, *self._col_meta(g),
                        **self._flags)

    def _set_slot(self, slot: int, old4, new4) -> None:
        """old4/new4: host int8 [n] vector quadruples (old may be None for a
        fresh slot). Host math + device calls only: no device→host fetch
        sits on the diff's path."""
        n = self.n_pods
        zeros = np.zeros(n, dtype=np.int8)
        if old4 is None:
            old4 = (zeros,) * 4
        old_si, old_se = old4[0] != 0, old4[1] != 0
        new_si, new_se = new4[0] != 0, new4[1] != 0
        ing2 = self._h_ing_cnt + (new4[0].astype(np.int64) - old4[0])
        eg2 = self._h_eg_cnt + (new4[1].astype(np.int64) - old4[1])
        iso_chg_i = (self._h_ing_cnt > 0) != (ing2 > 0)
        iso_chg_e = (self._h_eg_cnt > 0) != (eg2 > 0)
        # rows (sources): egress selection or egress isolation changed;
        # dst columns: ingress selection or ingress isolation changed.
        # Peer-map changes need no extra rows/columns: an ing_by_pol change
        # only matters on dst columns the policy selects (⊆ the column set)
        # and an eg_by_pol change only on src rows it selects (⊆ the rows).
        rows = np.nonzero((old_se | new_se) | iso_chg_e)[0]
        cols = np.nonzero((old_si | new_si) | iso_chg_i)[0]
        self._h_ing_cnt = ing2
        self._h_eg_cnt = eg2
        stacked = np.zeros((4, self._n_padded), dtype=np.int8)
        stacked[:, :n] = new4
        self._dispatch_diff(slot, stacked, rows, cols)
        self.update_count += 1

    # ---------------------------------------------------------------- diffs
    def add_policy(self, pol: NetworkPolicy) -> None:
        key = self._key(pol)
        if key in self.policies:
            raise KeyError(f"policy {key} exists; use update_policy")
        if pol.namespace not in self._ns_labels:
            self._ns_labels[pol.namespace] = {}
        if not self._free:
            self._grow()
        vecs = self._vectorizer.vectors(pol)
        slot = self._free.pop()
        self.policies[key] = pol
        self._slot[key] = slot
        self._set_slot(slot, None, vecs)

    def remove_policy(self, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        pol = self.policies.pop(key)  # KeyError if absent
        slot = self._slot.pop(key)
        old = self._vectorizer.vectors(pol)
        zero = np.zeros(self.n_pods, dtype=np.int8)
        self._set_slot(slot, old, (zero, zero, zero, zero))
        self._free.append(slot)

    def update_policy(self, pol: NetworkPolicy) -> None:
        key = self._key(pol)
        slot = self._slot[key]  # KeyError if absent
        old = self._vectorizer.vectors(self.policies[key])
        vecs = self._vectorizer.vectors(pol)
        self.policies[key] = pol
        self._set_slot(slot, old, vecs)

    def _pod_cols(self, pod: Pod) -> np.ndarray:
        """int8 [4, C]: one pod's (sel_ing, sel_eg, ing_peer, eg_peer) flag
        against every resident policy, slot-indexed — O(P) host evaluation
        with object semantics (the pod may carry pairs the frozen vocab has
        never seen)."""
        cols = np.zeros((4, self._capacity), dtype=np.int8)
        for key, pol in self.policies.items():
            cols[:, self._slot[key]] = pod_policy_flags(
                pol, pod, self._ns_labels, self.config.direction_aware_isolation,
            )
        return cols

    def update_pod_labels(self, idx: int, labels: Dict[str, str]) -> None:
        """Relabel pod ``idx``: one row of each map + the pod's own packed
        row and column are patched; O(P) host evaluation of this pod."""
        if not 0 <= idx < self.n_pods or not self.pod_active[idx]:
            raise KeyError(f"pod slot {idx} is not an active pod")
        pod = self.pods[idx]
        pod.labels = dict(labels)
        self._vectorizer.note_pod(idx)
        cols = self._pod_cols(pod)
        _apply_pod_col(self._maps, idx, self._put(cols))
        self._h_ing_cnt[idx] = int(cols[0].sum())
        self._h_eg_cnt[idx] = int(cols[1].sum())
        if self._packed is None:
            self.dirty_rows[idx] = True
            self.dirty_cols[idx] = True
        else:
            self._patch(np.asarray([idx]), np.asarray([idx]))
        self.update_count += 1

    # ------------------------------------------------------------ pod churn
    def _dispatch_pod(self, idx: int, cols4: np.ndarray, active: bool) -> None:
        """One pod-slot step (occupy or tombstone)."""
        self._mark_closure_dirty([idx], [idx])
        cols = self._put(cols4)
        if self._packed is None:
            _pod_step_mf(self._maps, self._col_mask, self._row_valid, idx, cols, active)
            self.dirty_rows[idx] = True
            self.dirty_cols[idx] = True
        else:
            _pod_step(self._packed, self._maps, self._col_mask, self._row_valid,
                      idx, cols, active, **self._flags)
        self.update_count += 1

    def add_namespace(self, ns: Namespace) -> bool:
        """Register a namespace created after the freeze (WITH its labels)
        before adding pods into it. Returns True when newly registered; a
        no-op for a known namespace with identical labels; a label CHANGE
        on a known namespace delegates to :meth:`update_namespace_labels`."""
        existing = self._ns_labels.get(ns.name)
        if existing is not None:
            if dict(existing) != dict(ns.labels):
                self.update_namespace_labels(ns.name, ns.labels)
            return False
        self._ns_labels[ns.name] = dict(ns.labels)
        self.namespaces.append(Namespace(ns.name, dict(ns.labels)))
        vz = self._vectorizer
        vz.ns_index.setdefault(ns.name, len(vz.ns_index))
        return True

    def _ns_pod_slots(self, name: str) -> np.ndarray:
        """Active pod slots living in namespace ``name``, ascending."""
        return np.asarray(
            [
                i
                for i in range(self.n_pods)
                if self.pod_active[i] and self.pods[i].namespace == name
            ],
            dtype=np.int64,
        )

    def _set_ns_labels(self, name: str, labels: Dict[str, str]) -> None:
        """Swap the namespace's label set in the live ``_ns_labels`` dict
        (shared by reference with the vectorizer, so FUTURE policy diffs see
        the new labels) and in the ``namespaces`` list."""
        self._ns_labels[name] = dict(labels)
        for i, ns in enumerate(self.namespaces):
            if ns.name == name:
                self.namespaces[i] = Namespace(name, dict(labels))
                return
        self.namespaces.append(Namespace(name, dict(labels)))

    def update_namespace_labels(self, name: str, labels: Dict[str, str]) -> None:
        """Relabel namespace ``name`` incrementally — a namespace label
        change moves ``namespaceSelector`` peer matches for EVERY pod in the
        namespace, so it is the batched form of a pod relabel: each resident
        policy re-evaluates against the namespace's pods on the host (object
        semantics), their map rows land ``_COL_GROUP`` pods at a time, then
        the packed matrix re-derives just those rows and columns (or the
        dirty sets grow, matrix-free)."""
        if name not in self._ns_labels:
            raise KeyError(f"namespace {name} is not registered")
        if dict(self._ns_labels[name]) == dict(labels):
            return
        self._set_ns_labels(name, labels)
        idx_arr = self._ns_pod_slots(name)
        if not len(idx_arr):
            return
        for g in _groups(idx_arr, _COL_GROUP):
            cols = np.stack([self._pod_cols(self.pods[int(i)]) for i in g], axis=1)
            self._h_ing_cnt[g] = cols[0].sum(axis=1)
            self._h_eg_cnt[g] = cols[1].sum(axis=1)
            _apply_pod_cols_group(self._maps, self._put(g), self._put(cols))
        if self._packed is None:
            self._mark_closure_dirty(idx_arr, idx_arr)
            self.dirty_rows[idx_arr] = True
            self.dirty_cols[idx_arr] = True
        else:
            self._patch(idx_arr, idx_arr)
        self.update_count += 1

    def remove_namespace(self, name: str) -> None:
        """Unregister namespace ``name``. Refuses while the namespace still
        holds active pods or policies (remove those first); otherwise drops
        it from the label dict and the ``namespaces`` list. The vectorizer
        keeps its frozen namespace row — a same-named namespace created
        later simply re-registers over it."""
        if name not in self._ns_labels:
            raise KeyError(f"namespace {name} is not registered")
        live = self._ns_pod_slots(name)
        if len(live):
            raise ServeError(
                f"namespace {name} still holds {len(live)} active pod(s); "
                "remove them before removing the namespace"
            )
        pols = [k for k in self.policies if k.split("/", 1)[0] == name]
        if pols:
            raise ServeError(
                f"namespace {name} still holds {len(pols)} polic(ies); "
                "remove them before removing the namespace"
            )
        del self._ns_labels[name]
        self.namespaces = [ns for ns in self.namespaces if ns.name != name]

    def add_pod(self, pod: Pod) -> int:
        """Add a pod in O(P + N). Returns the pod's slot index (its row and
        column in the reach matrix). Reuses a tombstoned slot when one
        exists, then the headroom, and only then grows the pod axis."""
        key = self._pod_key(pod)
        if key in self._pod_idx:
            raise KeyError(f"pod {key} exists; remove it first")
        if pod.namespace not in self._ns_labels:
            # auto-created namespace (empty labels) — mirrors
            # Cluster.__post_init__; fresh ns index, no frozen pods carry it
            self._ns_labels[pod.namespace] = {}
            vz = self._vectorizer
            vz.ns_index.setdefault(pod.namespace, len(vz.ns_index))
        pod = dataclasses.replace(
            pod, labels=dict(pod.labels), container_ports=dict(pod.container_ports)
        )
        # the host evaluation can raise (e.g. a malformed pod IP against an
        # ipBlock peer) — run it BEFORE any bookkeeping mutation so a failed
        # add leaves no phantom half-registered pod
        cols4 = self._pod_cols(pod)
        if self._pod_free:
            idx = self._pod_free.pop()
            self.pods[idx] = pod
            self.pod_active[idx] = True
        else:
            if self.n_pods >= self._n_padded:
                self._grow_pods()
            idx = self.n_pods
            self.n_pods += 1
            self.pods.append(pod)
            self.pod_active = np.append(self.pod_active, True)
            self._h_ing_cnt = np.append(self._h_ing_cnt, 0)
            self._h_eg_cnt = np.append(self._h_eg_cnt, 0)
            self.dirty_rows = np.append(self.dirty_rows, False)
            self.dirty_cols = np.append(self.dirty_cols, False)
        self._pod_idx[key] = idx
        self._col_valid[idx] = True
        self._vectorizer.note_pod(idx)
        self._h_ing_cnt[idx] = int(cols4[0].sum())
        self._h_eg_cnt[idx] = int(cols4[1].sum())
        self._dispatch_pod(idx, cols4, active=True)
        return idx

    def remove_pod(self, namespace: str, name: str) -> int:
        """Remove a pod: tombstone its slot (zero row in every map, zero
        isolation counts, clear validity, zero its packed row + bit-column).
        Returns the freed slot index."""
        key = f"{namespace}/{name}"
        idx = self._pod_idx.pop(key)  # KeyError if absent
        self.pod_active[idx] = False
        self._col_valid[idx] = False
        self._pod_free.append(idx)
        self._vectorizer.note_removed(idx)
        self._h_ing_cnt[idx] = 0
        self._h_eg_cnt[idx] = 0
        self._dispatch_pod(idx, np.zeros((4, self._capacity), dtype=np.int8),
                           active=False)
        return idx

    @property
    def n_active(self) -> int:
        return int(self.pod_active.sum())

    def active_indices(self) -> np.ndarray:
        """Slot indices of live pods, ascending — the row/col order of
        :meth:`reach_active` and of ``as_cluster()``'s pod list."""
        return np.nonzero(self.pod_active)[0]

    def reach_active(self) -> np.ndarray:
        """Dense bool reach over live pods only (host) — tombstoned slots
        dropped; aligned with ``as_cluster()`` for oracle comparison."""
        act = self.active_indices()
        return self.reach[np.ix_(act, act)]

    # --------------------------------------------------------------- result
    def dirty_stripes(self, width: int) -> List[int]:
        """Stripe starts whose values may differ from the last sweep: the
        stripes containing a dirty column — or every stripe, when a dirty
        row exists (a row change spans all columns)."""
        if width % 32 or width <= 0:
            raise ConfigError("width must be a positive multiple of 32")
        if self.dirty_rows.any():
            return list(range(0, self._n_padded, width))
        cols = np.nonzero(self.dirty_cols)[0]
        return sorted({int(c) // width * width for c in cols})

    def sweep_dirty(self, width: int):
        """Yield ``(d0, packed_words)`` for every stripe needing re-verify
        (``dirty_stripes``); when the iteration COMPLETES, both dirty sets
        are cleared — an abandoned sweep leaves them marked."""
        for d0 in self.dirty_stripes(width):
            yield d0, self.solve_stripe(d0, width)
        self.dirty_rows[:] = False
        self.dirty_cols[:] = False

    def solve_stripe(self, d0: int, width: int) -> np.ndarray:
        """Re-solve dst columns ``[d0, d0+width)`` straight from the current
        maps → host uint32 [n, width/32] (the JAX engine's type). This is
        matrix-free mode's re-verify primitive; drive a post-diff re-verify
        through ``sweep_dirty``, which also retires the dirty marks. A
        stripe may run past the padded pods only where ``d0 + width`` stays
        inside them."""
        if d0 < 0 or d0 % 32 or width % 32 or width <= 0:
            raise ConfigError(
                "d0 must be a non-negative multiple of 32 and width a "
                "positive multiple of 32"
            )
        if d0 + width > self._n_padded:
            raise ConfigError(
                f"stripe [{d0}, {d0 + width}) outside the padded pod range "
                f"{self._n_padded}"
            )
        out = retry_transient(
            lambda: _stripe_step(
                self._maps, self._col_mask, self._row_valid, d0, width=width,
                **self._flags,
            ),
            policy=self.retry_policy,
            backend="packed",
        )
        return to_host_words(out[: self.n_pods])

    def solve_rows(self, rows) -> np.ndarray:
        """Re-solve the packed reach ROWS of the given source pod indices
        straight from the current maps → host uint32 [K, n_padded/32] (word
        columns cover the full padded dst range; padded/tombstoned columns
        are masked off). The transpose of :meth:`solve_stripe` and the row
        oracle for ``ops/closure.py::bounded_closure_rows`` at matrix-free
        scale."""
        rows = np.asarray(rows, dtype=np.int64)
        if rows.ndim != 1:
            raise ConfigError("rows must be a 1-D index array")
        if rows.size == 0:
            return np.zeros((0, self._n_padded // 32), dtype=np.uint32)
        if rows.min() < 0 or rows.max() >= self.n_pods:
            raise ConfigError(f"row index out of range [0, {self.n_pods})")
        idx = self._put(rows)
        out = retry_transient(
            lambda: _rows_step(
                self._maps, self._col_mask, self._row_valid, idx, **self._flags
            ),
            policy=self.retry_policy,
            backend="packed",
        )
        return to_host_words(out)

    def packed_reach(self) -> PackedReach:
        """Current state as a ``PackedReach``: the words stay on the device
        (int32, a view of the engine's state — valid until the next diff),
        and the whole-matrix queries reduce there."""
        if self._packed is None:
            raise ServeError(
                "keep_matrix=False: the packed matrix is not materialised — "
                "use solve_stripe(d0, width) to re-verify dst ranges from the "
                "maps"
            )
        n = self.n_pods
        return PackedReach(
            packed=self._packed[:n],
            n_pods=n,
            ingress_isolated=(self._ing_cnt[:n] > 0).cpu().numpy(),
            egress_isolated=(self._eg_cnt[:n] > 0).cpu().numpy(),
            active=None if self.pod_active.all() else self.pod_active.copy(),
        )

    @property
    def reach(self) -> np.ndarray:
        """Dense bool [N, N] view (host) — for tests and small clusters."""
        return self.packed_reach().to_bool()

    def as_cluster(self, include_inactive: bool = False) -> Cluster:
        """The live cluster (pods in slot order, tombstones dropped).
        ``include_inactive=True`` keeps tombstoned pods in place — the
        checkpoint manifest form, where list position equals slot index
        (paired with ``state_dict()["pod_active"]``)."""
        return Cluster(
            pods=[
                Pod(p.name, p.namespace, dict(p.labels), p.ip, dict(p.container_ports))
                for i, p in enumerate(self.pods)
                if include_inactive or self.pod_active[i]
            ],
            namespaces=list(self.namespaces),
            policies=list(self.policies.values()),
        )

    # ---------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, np.ndarray]:
        """Device state as host arrays, in the JAX engine's exchange format
        (every key, shape and dtype equal, so a checkpoint written by one
        package loads in the other): the maps bit-packed along the pod axis
        of the JAX layout [C, Np], the words as uint32, slot assignment and
        the ``dirty_rows``/``dirty_cols`` re-verify bookkeeping. The cluster
        manifest (pods with their CURRENT labels + policies) travels
        separately; the resume re-freezes the encoding on it."""
        keys = list(self.policies)
        pack = lambda m: _pack_pod_axis(m).cpu().numpy()
        state = {
            "sel_ing": pack(self._sel_ing8),
            "sel_eg": pack(self._sel_eg8),
            "ing_by_pol": pack(self._ing_by_pol),
            "eg_by_pol": pack(self._eg_by_pol),
            "ing_cnt": self._ing_cnt.cpu().numpy().astype(np.int32),
            "eg_cnt": self._eg_cnt.cpu().numpy().astype(np.int32),
            "slots": np.asarray([self._slot[k] for k in keys], dtype=np.int32),
            "keys": np.array(keys),
            "n_padded": np.int64(self._n_padded),
            "capacity": np.int64(self._capacity),
            "slot_round": np.int64(self._slot_round),
            "update_count": np.int64(self.update_count),
            "dirty_rows": self.dirty_rows,
            "dirty_cols": self.dirty_cols,
            "pod_active": self.pod_active,
            # authoritative namespace list: tombstoned pods still sitting in
            # a REMOVED namespace make the manifest's auto-create resurrect
            # it on load — from_state prunes back to this list
            "ns_names": np.array([ns.name for ns in self.namespaces]),
        }
        if self._packed is not None:
            state["packed"] = _host_words(self._packed)
        if self._closure is not None:
            state["closure"] = _host_words(self._closure)
            state["closure_dirty"] = self._closure_dirty
            if self._closure_base is not None:
                state["closure_base"] = _host_words(self._closure_base)
        return state

    @classmethod
    def from_state(
        cls,
        cluster: Cluster,
        state: Dict[str, np.ndarray],
        config: Optional[VerifyConfig] = None,
        device=None,
        keep_matrix: Optional[bool] = None,
    ) -> "PackedIncrementalVerifier":
        """Resume from :meth:`state_dict` output — this package's or the JAX
        engine's — WITHOUT re-solving: the maps, counts and matrix upload
        straight to the device, only the host-side vectorizer re-freezes on
        the manifest's labels. ``keep_matrix=False`` drops a checkpointed
        matrix and resumes matrix-free; ``True`` requires the checkpoint to
        contain one."""
        self = cls.__new__(cls)
        self.config = config or VerifyConfig()
        self.device = resolve_device(device)
        self.pods = _copy_pods(cluster.pods)
        # the manifest already lists every auto-created namespace; the
        # state's authoritative ns list prunes namespaces a tombstone pod
        # resurrected through auto-create (see state_dict)
        self.namespaces = list(cluster.namespaces)
        if "ns_names" in state:
            live_ns = {str(x) for x in state["ns_names"]}
            self.namespaces = [ns for ns in self.namespaces if ns.name in live_ns]
        self._ns_labels = {ns.name: dict(ns.labels) for ns in self.namespaces}
        self.n_pods = len(self.pods)
        Np = int(state["n_padded"])
        self._n_padded = Np
        self._capacity = int(state["capacity"])
        self._slot_round = int(state["slot_round"])
        self.update_count = int(state["update_count"])
        self._closure = None
        self._closure_base = None
        self._closure_dirty = None
        t0 = time.perf_counter()
        self._sel_ing8 = _unpack_pod_axis(state["sel_ing"], Np, self.device)
        self._sel_eg8 = _unpack_pod_axis(state["sel_eg"], Np, self.device)
        self._ing_by_pol = _unpack_pod_axis(state["ing_by_pol"], Np, self.device)
        self._eg_by_pol = _unpack_pod_axis(state["eg_by_pol"], Np, self.device)
        self._ing_cnt = self._put(np.asarray(state["ing_cnt"], dtype=np.int32))
        self._eg_cnt = self._put(np.asarray(state["eg_cnt"], dtype=np.int32))
        self._pod_align = 128
        self.pod_active = np.asarray(
            state.get("pod_active", np.ones(self.n_pods, dtype=bool))
        ).copy()
        self._pod_free = [i for i in range(self.n_pods) if not self.pod_active[i]]
        self._pod_idx = {}
        for i, p in enumerate(self.pods):
            if self.pod_active[i]:
                self._pod_idx.setdefault(self._pod_key(p), i)
        self._col_valid = np.zeros(Np, dtype=bool)
        self._col_valid[: self.n_pods] = self.pod_active
        self._col_mask = self._put(self._col_mask_host())
        rv = np.zeros(Np, dtype=np.int8)
        rv[: self.n_pods] = self.pod_active
        self._row_valid = self._put(rv)
        keys = [str(k) for k in state["keys"]]
        slots = [int(s) for s in state["slots"]]
        by_key = {f"{p.namespace}/{p.name}": p for p in cluster.policies}
        self.policies = {}
        self._slot = {}
        for key, slot in zip(keys, slots):
            self.policies[key] = by_key[key]
            self._slot[key] = slot
        used = set(slots)
        self._free = [s for s in range(self._capacity) if s not in used]
        if keep_matrix is None:
            keep_matrix = "packed" in state
        elif keep_matrix and "packed" not in state:
            raise ConfigError(
                "keep_matrix=True but the checkpoint was saved matrix-free; "
                "re-solve (or resume matrix-free and use solve_stripe)"
            )
        self.keep_matrix = bool(keep_matrix)
        self._packed = _words(state["packed"], self.device) if keep_matrix else None
        self.dirty_rows = np.asarray(state["dirty_rows"]).copy()
        self.dirty_cols = np.asarray(state["dirty_cols"]).copy()
        if "closure" in state and self._packed is not None:
            self._closure = _words(state["closure"], self.device)
            self._closure_dirty = np.asarray(state["closure_dirty"], dtype=bool).copy()
            if "closure_base" in state:
                self._closure_base = _words(state["closure_base"], self.device)
        self._sync()
        upload_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._vectorizer = PolicyVectorizer(
            self.pods,
            self._ns_labels,
            cluster_vocab(self.pods, self.namespaces),
            {ns.name: i for i, ns in enumerate(self.namespaces)},
            self.config.direction_aware_isolation,
        )
        self._vectorizer.inactive = {
            i for i in range(self.n_pods) if not self.pod_active[i]
        }
        self._h_ing_cnt = np.asarray(state["ing_cnt"], dtype=np.int64)[: self.n_pods]
        self._h_eg_cnt = np.asarray(state["eg_cnt"], dtype=np.int64)[: self.n_pods]
        self._prewarm()
        #: seconds of the resume's phases: the state's upload and unpacking
        #: on the device, the host vectorizer over the manifest
        self.build_timings = {
            "upload": upload_s, "vectorizer": time.perf_counter() - t0,
        }
        self.init_time = 0.0
        return self
