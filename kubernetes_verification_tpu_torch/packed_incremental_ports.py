"""Packed incremental re-verify WITH port bitmaps (BASELINE config 4 ∧ 5).

The port of ``kubernetes_verification_tpu.packed_incremental_ports``.
:class:`~.packed_incremental.PackedIncrementalVerifier` keeps any-port
semantics; this engine keeps the full port-bitmap semantics of the tiled
mask-group solve (``ops/tiled_ports.py``) under policy, pod and namespace
diffs. Its state is the solve's own *virtual-policy* (VP) operands, resident
and row-addressable:

* ``vp_peers_i`` — the src-side ingress peer map of each VP row;
* ``sel_ing_vp`` — the dst-side ingress selection of each VP row, with the
  policy's selection, direction gating and named-port restriction baked in;
* ``sel_eg_vp`` — the src-side egress selection of each VP row;
* ``vp_peers_e`` — the dst-side egress peer map, restriction baked in;

plus the policy-level isolation counts and the packed reachability matrix
(int32 words ``[Np, Np/32]`` with the reference's uint32 bit pattern). The
``PortLayout`` is frozen at the build with ``headroom`` free rows per
segment: each (mask, restriction) group of a policy owns one VP row in its
mask's segment.

**Layout.** The JAX engine holds each map as one int8 ``[T, Np]`` array in
its VP row numbering (``[ported segments | full block | sink row]``, each
segment a multiple of 8 rows). Here each (map, segment) is its own
pod-major int8 ``[Np, l]`` tensor, in the same row order; the sink row is
not held (it is always zero). So every product of ``_ports_reach_block`` is
a ``bool_dot`` of K-contiguous operands with no copy, a policy diff's VP-row
write is a strided column write, and a pod step writes one row per segment.
The build copies the segments once into the kernel's 64-aligned K layout
(``ops/tiled_ports.py::engine_fused_args``) and launches the hand-written
``fused_ports_reach`` once, where the JAX engine sweeps with XLA
(``_ports_sweep``); ``state_dict`` packs the segments back into JAX's rows.

A diff costs one single-policy re-encode against the frozen atoms, vocab and
restriction bank (``encode_policy_delta``), host peer-union vectors per
(mask, restriction) group, a VP-row write and port-aware row and column
patches. A pod churn is an O(total VP rows + P) host evaluation of the pod
object against every VP row (``_pod_vp_cols``), then one pod step.

Frozen-universe boundaries raise :class:`PortUniverseChanged` before any
mutation: a diff needing a new atom boundary, a new run-split mask, a new
named-port restriction or more rows than a segment's headroom, and a pod
whose named ports resolve outside the frozen bank.

Differences from the JAX engine, none of which changes a byte of state:

* the state is updated in place instead of donated;
* a diff is a short sequence of eager calls: nothing is prewarmed or
  compiled, index groups are padded only where cuBLASLt needs it (on the
  card, ``_GATHER_PAD``), and the per-diff VP-row values travel unpacked
  (the JAX ``_vals_cap`` ladder and its bit-packed transfer only avoid XLA
  recompiles);
* the number of ported masks is capped by ``fused_ports_reach``
  (``ops/kernels.py::FUSED_MAX_MASKS``), where JAX has a ``max_port_masks``
  option (default 32).

The JAX engine's ``kvtpu_*`` metrics, dispatch tracker and kernel-manifest
registrations (``observe/aot.py``) are kept, at the same call sites.

``mesh=`` shards the state over a ``(pods, grants)`` mesh as the JAX engine
does: each direction's VP axis over ``grants`` (padded to a multiple of the
grant axis with inert rows after the sink row, outside every segment), the
pod axis over ``pods``; every op runs SPMD with explicit collectives
(``parallel/engine_mesh.py::PortsShards``), its segment products summed
over ``grants`` before the mask-group combine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .backends.base import PortAtom, VerifyConfig
from .encode.encoder import (
    FrozenBankMiss,
    GrantBlock,
    SelectorEnc,
    _encode_selector_stack,
    _RestrictBank,
    cluster_vocab,
    encode_cluster,
    encode_policy_delta,
)
from .encode.ports import named_resolution
from .models.core import Cluster, NetworkPolicy, Pod
from .observe import DispatchTracker
from .observe.metrics import INCREMENTAL_OPS
from .observe.spans import Phases, trace_if_read
from .ops.bits import or_diagonal, pack_bool_cols
from .ops.closure import _words, bool_dot
from .ops.kernels import FUSED_MAX_MASKS, fused_ports_reach
from .ops.padding import pad_grants, pad_pods
from .ops.tiled import HostArgs
from .ops.tiled import _put as _put_args
from .ops.tiled_ports import (
    PortLayout,
    VPArrays,
    _build_port_layout,
    _mask_group_conj,
    _split_and_check_port_masks,
    _split_grant_ports,
    _vp_maps,
    engine_fused_args,
)
from .packed_incremental import (
    PackedIncrementalVerifier,
    PolicyVectorizer,
    _bit,
    _change,
    _copy_pods,
    _groups,
    _host_words,
    _mask_rows,
    _pack_pod_axis,
    _unpack_pod_axis,
)
from .resilience.errors import ConfigError, ServeError
from .resilience.retry import RetryPolicy, retry_transient
from .runtime import resolve_device

__all__ = ["PackedPortsIncrementalVerifier", "PortUniverseChanged"]

#: first dispatches per abstract signature (kvtpu_jit_recompiles_total)
_TRACKER = DispatchTracker("packed-ports")

_I8 = torch.int8
_I32 = torch.int32

#: max rows recomputed per row patch, and dst columns per column patch (the
#: JAX engine's group sizes; here the groups are not padded)
_ROW_GROUP = 256
_COL_GROUP = 256

#: on a CUDA device ``_ports_reach_block`` pads its gathered rows or
#: columns to a multiple of this, repeating the last index (the JAX engine's
#: fixed group size): cuBLASLt's int8 GEMM refuses some narrower products
#: over a short segment (``CUBLAS_STATUS_NOT_SUPPORTED`` at m = 168, k = 96,
#: n = 100,096 on an H100, where m = 256 runs)
_GATHER_PAD = 256

#: the four VP maps in the JAX state's order, as (direction, side): the src
#: side is index 0 of a pod's column values, the dst side index 1
_MAP_KEYS = (
    ("vp_peers_i", "i", 0),
    ("sel_ing_vp", "i", 1),
    ("sel_eg_vp", "e", 0),
    ("vp_peers_e", "e", 1),
)


class PortUniverseChanged(ServeError):
    """The diff needs port atoms / masks / restrictions / capacity outside
    the frozen layout — rebuild the verifier from the current cluster."""


def _eval_selector_rows(sel: SelectorEnc, kv: np.ndarray, key: np.ndarray) -> np.ndarray:
    """Host NumPy mirror of ``ops.match.match_selectors`` for SMALL entity
    sets (namespaces): bool [S, M]."""
    kv = kv.astype(np.int64)
    key = key.astype(np.int64)
    need_eq = sel.req_eq.sum(axis=1)[:, None]
    ok = sel.req_eq.astype(np.int64) @ kv.T >= need_eq
    need_key = sel.req_key.sum(axis=1)[:, None]
    ok &= sel.req_key.astype(np.int64) @ key.T >= need_key
    forbidden = (
        sel.forbid_eq.astype(np.int64) @ kv.T
        + sel.forbid_key.astype(np.int64) @ key.T
    )
    ok &= forbidden == 0
    S, E, V = sel.in_mask.shape
    for e in range(E):
        hits = sel.in_mask[:, e, :].astype(np.int64) @ kv.T > 0
        ok &= hits | ~sel.in_valid[:, e][:, None]
    return ok & ~sel.impossible[:, None]


def _spans(layout: PortLayout, d: str) -> list:
    """Direction ``d``'s segments as ``(start, length)`` in JAX's VP rows:
    the ported masks, then the full block (index R)."""
    if d == "i":
        return list(layout.seg_i) + [layout.full_i]
    return list(layout.seg_e) + [layout.full_e]


# ---------------------------------------------------------------------------
# device steps: plain functions on the segment tensors, updated in place
# ---------------------------------------------------------------------------
#
# ``src[d][m]`` / ``dst[d][m]`` are the pod-major int8 [Np, l] src- and
# dst-side maps of segment m of direction d (``_spans``): ingress src =
# ``vp_peers_i``, dst = ``sel_ing_vp``; egress src = ``sel_eg_vp``, dst =
# ``vp_peers_e``. ``ing_cnt``/``eg_cnt`` are int32 [Np], ``col_mask`` int32
# [Np/32], ``row_valid`` int8 [Np], ``packed`` int32 [Np, Np/32].


def _ports_reach_block(
    src, dst, layout: PortLayout, ing_cnt_d, eg_cnt_s, src_ids, dst_ids,
    rows=None, cols=None, *, self_traffic: bool, default_allow: bool,
) -> torch.Tensor:
    """Reach of a (src × dst) block under port semantics, bool — the
    incremental counterpart of the sweep. Exactly one of ``rows`` (gather
    srcs, full dst axis) or ``cols`` (full src axis, gather dsts) is
    given; on a CUDA device the gathered rows are padded to a multiple of
    ``_GATHER_PAD`` and the counts trimmed back."""
    idx = rows if rows is not None else cols
    k = idx.shape[0]
    if idx.is_cuda and k % _GATHER_PAD:
        idx = torch.cat([idx, idx[-1:].repeat(_GATHER_PAD - k % _GATHER_PAD)])
    gathered = lambda side: {d: [t[idx] for t in side[d]] for d in side}
    if rows is not None:
        src, trim = gathered(src), lambda c: c[:k]
    else:
        dst, trim = gathered(dst), lambda c: c[:, :k]
    return _ports_block(
        src, dst, layout, ing_cnt_d, eg_cnt_s, src_ids, dst_ids, trim=trim,
        self_traffic=self_traffic, default_allow=default_allow,
    )


def _ports_block(
    src, dst, layout: PortLayout, ing_cnt_d, eg_cnt_s, src_ids, dst_ids, *,
    self_traffic: bool, default_allow: bool, trim=None, reduce=None,
) -> torch.Tensor:
    """The port reach of the block whose src-side operands are ``src[d][m]``
    [S, l] and dst-side ``dst[d][m]`` [D, l] (segment ``m`` of direction
    ``d``, ``_spans`` order), bool [S, D], on the shared
    ``_mask_group_conj``: every segment product is a ``bool_dot`` of
    K-contiguous pod-major rows, its counts ``trim``-med (gather padding)
    and completed by ``reduce`` (the mesh's sum over ``grants``) before the
    threshold."""
    seg = {d: {s: m for m, (s, l) in enumerate(_spans(layout, d)) if l} for d in "ie"}

    def dot(d, s):
        m = seg[d][s]
        counts = bool_dot(src[d][m], dst[d][m])
        if trim is not None:
            counts = trim(counts)
        if reduce is not None:
            reduce(counts)
        return counts > 0

    shape = (src_ids.shape[0], dst_ids.shape[0])
    false_t = torch.zeros(shape, dtype=torch.bool, device=ing_cnt_d.device)
    conj, gi_any, ge_any = _mask_group_conj(
        layout, lambda s, l: dot("i", s), lambda s, l: dot("e", s), false_t
    )
    r = conj
    if default_allow:
        # the default-allow terms cover every port atom, so they expand the
        # conjunction exactly as in the sweep
        di = ~(ing_cnt_d > 0)[None, :]  # dst side
        de = ~(eg_cnt_s > 0)[:, None]  # src side
        r = r | (di & de) | (di & ge_any) | (de & gi_any)
    if self_traffic:
        r = r | (src_ids[:, None] == dst_ids[None, :])
    return r


def _ports_patch_rows(
    packed, src, dst, ing_cnt, eg_cnt, col_mask, row_valid, rows, *,
    layout: PortLayout, self_traffic: bool, default_allow: bool,
) -> None:
    """Recompute the full packed rows ``rows`` (int64 [K], unique); invalid
    rows come out zero."""
    Np = packed.shape[0]
    r = _ports_reach_block(
        src, dst, layout, ing_cnt, eg_cnt[rows], rows,
        torch.arange(Np, device=rows.device), rows=rows,
        self_traffic=self_traffic, default_allow=default_allow,
    )
    r &= (row_valid[rows] > 0)[:, None]
    packed[rows] = pack_bool_cols(r) & col_mask[None, :]


def _ports_patch_cols(
    packed, src, dst, ing_cnt, eg_cnt, row_valid, cols, seg, words, clear, *,
    layout: PortLayout, self_traffic: bool, default_allow: bool,
) -> None:
    """Recompute exactly the dst columns ``cols`` and merge their bits into
    their words: the any-port engine's ``_patch_cols`` word fold
    (``_col_meta`` gives ``seg``, ``words``, ``clear``)."""
    Np = packed.shape[0]
    r = _ports_reach_block(
        src, dst, layout, ing_cnt[cols], eg_cnt,
        torch.arange(Np, device=cols.device), cols, cols=cols,
        self_traffic=self_traffic, default_allow=default_allow,
    )
    # tombstoned/padded source rows stay zero — without this a diff would
    # resurrect bits in a removed pod's row (its eg_cnt is 0, so
    # default-allow marks it egress-open)
    r &= (row_valid > 0)[:, None]
    one = torch.ones((), dtype=_I32, device=cols.device)
    bits = r.to(_I32) * (one << (cols % 32).to(_I32))[None, :]  # [Np, Dc]
    set_words = torch.zeros((Np, words.shape[0]), dtype=_I32, device=cols.device)
    set_words.index_add_(1, seg, bits)
    packed[:, words] = (packed[:, words] & ~clear[None, :]) | set_words


def _vp_write(
    src, dst, ing_cnt, eg_cnt, locs: dict, vals: dict, d_ing, d_eg
) -> None:
    """Write a diff's touched VP rows — ``locs[d]`` lists each row's
    (segment, offset), ``vals[d]`` is int8 [2, K, Np], (src, dst) values
    per row — as strided columns of the segment tensors, and add the
    policy-level isolation count deltas (int32 [Np])."""
    for d, loc in locs.items():
        for j, (m, off) in enumerate(loc):
            src[d][m][:, off] = vals[d][0, j]
            dst[d][m][:, off] = vals[d][1, j]
    ing_cnt += d_ing
    eg_cnt += d_eg


def _ports_apply_pod_cols_group(
    src, dst, ing_cnt, eg_cnt, layout: PortLayout, idxs, ci, ce, cnt_i, cnt_e
) -> None:
    """Write a group of pods' columns across the four VP maps and their
    isolation counts: ``idxs`` int64 [G] unique pod slots, ``ci``/``ce``
    int8 [2, T, G] their (src, dst) values over JAX's VP rows of each
    direction (the sink row last, unused), ``cnt_i``/``cnt_e`` int32 [G]."""
    for d, c in (("i", ci), ("e", ce)):
        for m, (s, l) in enumerate(_spans(layout, d)):
            src[d][m][idxs] = c[0, s : s + l].t()
            dst[d][m][idxs] = c[1, s : s + l].t()
    ing_cnt[idxs] = cnt_i
    eg_cnt[idxs] = cnt_e


def _ports_pod_step(
    packed, src, dst, ing_cnt, eg_cnt, col_mask, row_valid, idx: int, ci, ce,
    cnt_i: int, cnt_e: int, active: bool, *, layout: PortLayout,
    self_traffic: bool, default_allow: bool,
) -> None:
    """One pod add/remove/relabel under port semantics: the pod's column of
    every VP map (``ci``/``ce`` int8 [2, T]), its isolation counts, its
    validity bits, then exactly its own packed row and its own bit-column
    recomputed against the NEW state (a pod only contributes its own row and
    column to the matrix)."""
    dev = packed.device
    one = torch.tensor([idx], device=dev)
    _ports_apply_pod_cols_group(
        src, dst, ing_cnt, eg_cnt, layout, one, ci[..., None], ce[..., None],
        torch.tensor([cnt_i], dtype=_I32, device=dev),
        torch.tensor([cnt_e], dtype=_I32, device=dev),
    )
    w, bit = idx // 32, _bit(idx % 32)
    col_mask[w : w + 1] &= ~bit
    if active:
        col_mask[w : w + 1] |= bit
    row_valid[idx] = int(active)
    Np = packed.shape[0]
    ar = torch.arange(Np, device=dev)
    flags = dict(self_traffic=self_traffic, default_allow=default_allow)
    if active:
        r_row = _ports_reach_block(
            src, dst, layout, ing_cnt, eg_cnt[one], one, ar, rows=one, **flags
        )  # [1, Np]
        packed[idx] = pack_bool_cols(r_row)[0] & col_mask
    else:
        packed[idx] = 0
    col = packed[:, w] & ~bit
    if active:
        r_col = _ports_reach_block(
            src, dst, layout, ing_cnt[one], eg_cnt, ar, one, cols=one, **flags
        )[:, 0]  # [Np]
        col |= (r_col & (row_valid > 0)).to(_I32) * bit
    packed[:, w] = col


def _build_packed(
    src, dst, layout: PortLayout, ing_cnt, eg_cnt, col_mask, row_valid, *,
    self_traffic: bool, default_allow: bool,
) -> torch.Tensor:
    """The packed matrix of the resident maps: ONE ``fused_ports_reach``
    launch (the hand-written kernel on a CUDA device, its plain version on
    the CPU) on the maps copied into its K layout, then the self-traffic
    diagonal, the column mask and the invalid rows zeroed — the end of the
    JAX engine's ``_ports_sweep``."""
    args = engine_fused_args(
        layout, src, dst, (~(ing_cnt > 0)).to(_I32), (~(eg_cnt > 0)).to(_I32)
    )
    out = fused_ports_reach(*args, default_allow=default_allow)
    del args  # the two [Np, K'] operands
    if self_traffic:
        or_diagonal(out)
    out &= col_mask[None, :]
    _mask_rows(out, row_valid)
    return out


def _make_shards(mesh, n_padded: int, layout: PortLayout, total_rows: Dict[str, int]):
    if mesh is None:
        return None
    from .parallel.engine_mesh import PortsShards

    return PortsShards(
        mesh, n_padded, {d: _spans(layout, d) for d in "ie"}, total_rows)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class PackedPortsIncrementalVerifier:
    """Port-bitmap reachability under policy add/remove/update, pod churn
    and namespace relabels, on one device or on a mesh.

    ``device=None`` means ``"cuda"`` (``BackendError`` without a GPU); the
    CPU runs only when the caller passes ``device="cpu"``. With ``mesh=``
    the state lives on the mesh's devices (``parallel/engine_mesh.py``).
    """

    #: engine kind the serving plane keys on (``serve/service.py``)
    metrics_engine = "packed-ports"

    #: transient-failure budget around the pod steps; assign a tuned
    #: RetryPolicy on the instance to change it
    retry_policy = RetryPolicy()

    def _count_op(self, op: str) -> None:
        INCREMENTAL_OPS.labels(engine=self.metrics_engine, op=op).inc()

    def __init__(
        self,
        cluster: Cluster,
        config: Optional[VerifyConfig] = None,
        device=None,
        headroom: int = 8,
        tile: int = 512,
        chunk: int = 2048,
        mesh=None,
        pod_headroom: int = 0,
    ) -> None:
        """``headroom``: free VP rows per segment, for policy diffs to
        allocate from. ``tile``: the pod-axis alignment unit of growth (the
        JAX engine's sweep tile). ``mesh``: shard the VP operands (VP axis
        over ``grants``, pod axis over ``pods``), the counts and the packed
        matrix over a ``(pods, grants)`` mesh, every rank calling every op
        with the same arguments. ``pod_headroom``: extra free pod slots
        padded in at build time, so pod churn beyond the pad-to-alignment
        slack avoids growing the pod axis (a grow copies every buffer)."""
        self.config = config or VerifyConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        if pod_headroom < 0:
            raise ConfigError("pod_headroom must be >= 0")
        self.pods: List[Pod] = _copy_pods(cluster.pods)
        self.namespaces = list(cluster.namespaces)
        self.policies: Dict[str, NetworkPolicy] = {}
        self.update_count = 0
        self._closure = None
        self._closure_base = None
        self._closure_dirty: Optional[np.ndarray] = None
        cfg = self.config
        phase = Phases(prefix="engine.build.")

        with phase("encode"):
            snapshot = Cluster(
                pods=self.pods, namespaces=self.namespaces,  # appends missing ns
                policies=list(cluster.policies),
            )
            # label dicts are COPIED: an aliased caller dict mutated in place
            # would satisfy the relabel no-op guard and silently skip the
            # re-derivation (pods are deep-copied for the same reason)
            self._ns_labels = {ns.name: dict(ns.labels) for ns in self.namespaces}
            enc = encode_cluster(snapshot, compute_ports=True)
            self._atoms = list(enc.atoms)
            self._resolution = enc.resolution
            self._bank_intern = enc.restrict_bank_intern
            if self._bank_intern is not None:
                self._bank_intern.frozen = True
            n = enc.n_pods
            self.n_pods = n
            Np = max(128, -(-(n + pod_headroom) // 128) * 128)
            self._n_padded = Np
            self._tile = next(t for t in (tile, 512, 256, 128) if t <= Np and Np % t == 0)
            n_pad = Np - n
            pod_kv, pod_key, pod_ns = pad_pods(enc.pod_kv, enc.pod_key, enc.pod_ns, n_pad)
            self._ns_kv = enc.ns_kv
            self._ns_key = enc.ns_key
            self.pod_active = np.ones(n, dtype=bool)
            self._pod_free: List[int] = []
            self._pod_idx = {self._pod_key(p): i for i, p in enumerate(self.pods)}
            self._col_valid = np.zeros(Np, dtype=bool)
            self._col_valid[:n] = True
            col_mask = self._col_mask_host()
            self._col_mask = self._put(col_mask)
            rv = np.zeros(Np, dtype=np.int8)
            rv[:n] = 1
            if enc.restrict_bank is not None:
                bank8 = np.zeros((enc.restrict_bank.shape[0], Np), dtype=np.int8)
                bank8[:, :n] = enc.restrict_bank
            else:
                bank8 = np.ones((1, Np), dtype=np.int8)
            self._bank8_host = bank8

            P = enc.n_policies
            ing_block, eg_block, _ = _split_and_check_port_masks(
                enc.ingress, enc.egress, FUSED_MAX_MASKS
            )
            g_chunk = max(1, min(chunk, max(ing_block.n, eg_block.n, 1)))
            ingress = pad_grants(ing_block, (-ing_block.n) % g_chunk, P, n_pad)
            egress = pad_grants(eg_block, (-eg_block.n) % g_chunk, P, n_pad)
            (
                layout, vp_pol_i, vp_res_i, vp_slot_i,
                vp_pol_e, vp_res_e, vp_slot_e, ported_masks,
            ) = _build_port_layout(
                ingress.ports, egress.ports, ingress.pol, egress.pol,
                sink_pol=P,
                ing_restrict=ingress.dst_restrict, eg_restrict=egress.dst_restrict,
                headroom=headroom,
            )
            self._layout = layout
            self._total_rows = {"i": len(vp_pol_i), "e": len(vp_pol_e)}
            self._shards = _make_shards(mesh, Np, layout, self._total_rows)
            self._row_valid = self._put_rows(rv)
            self._mask_rank = {
                tuple(bool(b) for b in row): r for r, row in enumerate(ported_masks)
            }
            self._sink_pol = P

        with phase("maps"):
            a = _put_args(HostArgs(
                pod_kv, pod_key, pod_ns, enc.ns_kv, enc.ns_key, enc.pol_sel,
                enc.pol_ns, enc.pol_affects_ingress, enc.pol_affects_egress,
                ingress, egress, col_mask,
            ), self.device)
            vp = _put_args(VPArrays(
                vp_pol_i, vp_res_i, vp_slot_i, vp_pol_e, vp_res_e, vp_slot_e, bank8
            ), self.device)
            _, sel_ing_ext, sel_eg_ext, _, _, vp_peers_i, vp_peers_e = _vp_maps(
                a, vp, chunk=g_chunk,
                direction_aware_isolation=cfg.direction_aware_isolation,
            )
            del a
            # the sink policy's row of the selections is zero
            ing_cnt = sel_ing_ext.sum(dim=0, dtype=_I32)
            eg_cnt = sel_eg_ext.sum(dim=0, dtype=_I32)
            self._h_ing_cnt = ing_cnt[:n].cpu().numpy().astype(np.int64)
            self._h_eg_cnt = eg_cnt[:n].cpu().numpy().astype(np.int64)
            rows = self._rows()
            self._ing_cnt = ing_cnt[rows].clone()
            self._eg_cnt = eg_cnt[rows].clone()
            del ing_cnt, eg_cnt
            bank = vp.bank8
            full = {
                "vp_peers_i": vp_peers_i,
                "sel_ing_vp": sel_ing_ext[vp.pol_i.long()] * bank[vp.res_i.long()],
                "sel_eg_vp": sel_eg_ext[vp.pol_e.long()],
                "vp_peers_e": vp_peers_e * bank[vp.res_e.long()],
            }
            del vp_peers_i, vp_peers_e, sel_ing_ext, sel_eg_ext, vp, bank
            self._src: Dict[str, List[torch.Tensor]] = {}
            self._dst: Dict[str, List[torch.Tensor]] = {}
            for key, d, side in _MAP_KEYS:
                m = full.pop(key)
                segs = [m[s : s + l, rows].t().contiguous() for s, l in _spans(layout, d)]
                if self._shards is not None:
                    # the maps were built whole; this rank keeps its block
                    segs = self._shards.slice_segments(d, segs)
                (self._dst if side else self._src)[d] = segs
                del m, segs
            self._sync()

        with phase("kernel"):
            if self._shards is not None:
                self._packed = self._shards.build_packed(self, self._flags)
            else:
                self._packed = _build_packed(
                    self._src, self._dst, layout, self._ing_cnt, self._eg_cnt,
                    self._col_mask, self._row_valid, **self._flags,
                )
            self._sync()

        # ---- host bookkeeping: segment free lists + per-policy row maps
        with phase("vectorizer"):
            self._seg_spans = {"i": _spans(layout, "i"), "e": _spans(layout, "e")}
            self._free_rows: Dict[str, Dict[int, List[int]]] = {"i": {}, "e": {}}
            self._row_owner: Dict[str, Dict[int, str]] = {"i": {}, "e": {}}
            self._pol_rows: Dict[str, Dict[str, List[int]]] = {}
            keys = [self._key(p) for p in cluster.policies]
            for d, vp_pol in (("i", vp_pol_i), ("e", vp_pol_e)):
                for s_idx, (start, length) in enumerate(self._seg_spans[d]):
                    free = []
                    for row in range(start, start + length):
                        pol_id = int(vp_pol[row])
                        if pol_id == P:
                            free.append(row)
                        else:
                            key = keys[pol_id]
                            self._row_owner[d][row] = key
                            self._pol_rows.setdefault(key, {"i": [], "e": []})[d].append(row)
                    self._free_rows[d][s_idx] = free
            # per-row churn caches: the named-port restriction each row bakes in
            # plus the (rule, peer) provenance of its peer union — a single-pod
            # churn evaluates the pod object against exactly these (object
            # semantics; the frozen vocab may never have seen the pod's labels)
            self._row_res: Dict[str, Dict[int, int]] = {"i": {}, "e": {}}
            self._row_peers: Dict[str, Dict[int, set]] = {"i": {}, "e": {}}
            for d, vp_res, block, vp_slot in (
                ("i", vp_res_i, ingress, vp_slot_i),
                ("e", vp_res_e, egress, vp_slot_e),
            ):
                for row in self._row_owner[d]:
                    self._row_res[d][row] = int(vp_res[row])
                for g in range(len(block.pol)):
                    if block.pol[g] >= P:
                        continue  # pad / sink-owned rows
                    row = int(vp_slot[g])
                    if row in self._row_owner[d]:
                        self._row_peers[d].setdefault(row, set()).add(
                            (int(block.rule_id[g]), int(block.peer_id[g]))
                        )
            for i, pol in enumerate(cluster.policies):
                key = keys[i]
                if key in self.policies:
                    raise KeyError(f"duplicate policy {key}")
                self.policies[key] = pol
                self._pol_rows.setdefault(key, {"i": [], "e": []})

            self._vectorizer = PolicyVectorizer(
                self.pods,
                self._ns_labels,
                enc.vocab,
                {ns.name: i for i, ns in enumerate(self.namespaces)},
                cfg.direction_aware_isolation,
            )
            self._prewarm()
            self._sync()
        #: seconds of the build's phases: host encode and VP layout, the
        #: VP maps on the device, the packed matrix (one kernel launch), the
        #: host bookkeeping and vectorizer
        self.build_timings = phase.timings
        self.init_time = sum(phase.timings.values())

    def _prewarm(self) -> None:
        """What remains of the JAX engine's prewarm, which compiles its diff
        kernels through no-op calls after a build, a resume and a pod-axis
        growth. Nothing compiles here; its effects on the state are kept, so
        the state stays byte-identical to the JAX engine's: its no-op VP
        writes land on the sink rows, which are not held and read as zero;
        its row-0 patch leaves the row as it was (the patch masks row
        validity) but marks row 0 dirty for a held closure; and it
        tombstones the last invalid pod slot again, which zeroes the junk
        that slot's pad column picked up in the peer maps."""
        self._mark_closure_dirty(np.zeros(1, dtype=np.int64), np.zeros(0, dtype=np.int64))
        invalid = np.nonzero(~self._col_valid)[0]
        if len(invalid):
            self._dispatch_pod(
                int(invalid[-1]),
                np.zeros((2, self._total_rows["i"]), dtype=np.int8),
                np.zeros((2, self._total_rows["e"]), dtype=np.int8),
                0, 0, active=False, bookkeep=False,
            )

    # ------------------------------------------------------------- plumbing
    # the any-port engine's: same state names and semantics
    _put = PackedIncrementalVerifier._put
    _put_rows = PackedIncrementalVerifier._put_rows
    _rows = PackedIncrementalVerifier._rows
    _whole_words = PackedIncrementalVerifier._whole_words
    _whole_counts = PackedIncrementalVerifier._whole_counts
    _sync = PackedIncrementalVerifier._sync
    _col_mask_host = PackedIncrementalVerifier._col_mask_host
    _col_meta = PackedIncrementalVerifier._col_meta
    _key = PackedIncrementalVerifier._key
    _pod_key = staticmethod(PackedIncrementalVerifier._pod_key)

    @property
    def _flags(self) -> dict:
        return dict(
            self_traffic=self.config.self_traffic,
            default_allow=self.config.default_allow_unselected,
        )

    def _grant_row_peers(self, block: GrantBlock, g: int, pol_ns_idx: int) -> np.ndarray:
        """bool [n]: pods one encoded grant row's peer clause matches —
        host evaluation via the posting-list vectorizer (pods) and the
        NumPy selector mirror (namespaces)."""
        vz = self._vectorizer
        if bool(block.match_all[g]):
            return np.ones(self.n_pods, dtype=bool)
        if bool(block.is_ipblock[g]):
            return np.asarray(block.ip_match[g], dtype=bool)
        m = vz._sel_mask(block.pod_sel, g)
        if bool(block.ns_sel_null[g]):
            m = m & vz._ns_mask(pol_ns_idx)
        else:
            ns_ok = _eval_selector_rows(block.ns_sel, self._ns_kv, self._ns_key)[g]
            acc = np.zeros(self.n_pods, dtype=bool)
            for ns_idx in np.nonzero(ns_ok)[0]:
                acc |= vz._ns_mask(int(ns_idx))
            m = m & acc
        return m

    def _check_ports_representable(self, pol: NetworkPolicy) -> None:
        """A diff's port specs must be expressible in the frozen atom
        partition EXACTLY — ``rule_port_mask`` silently narrows a spec to
        the whole atoms it covers, which would silently verify the wrong
        policy. Numeric specs must cover whole atoms end to end; named specs
        must have been referenced (hence resolved) at the build."""
        for rules in (pol.ingress, pol.egress):
            for rule in rules or ():
                for spec in rule.ports or ():
                    if isinstance(spec.port, str):
                        key = (spec.protocol, spec.port)
                        if not self._resolution or key not in self._resolution:
                            raise PortUniverseChanged(
                                f"policy {self._key(pol)} names port {key} "
                                "never referenced in the frozen encoding; "
                                "rebuild the verifier"
                            )
                    elif spec.port is not None:
                        hi = spec.end_port if spec.end_port is not None else spec.port
                        covered = sum(
                            a.width
                            for a in self._atoms
                            if a.name is None
                            and a.protocol == spec.protocol
                            and spec.port <= a.lo
                            and a.hi <= hi
                        )
                        if covered != hi - spec.port + 1:
                            raise PortUniverseChanged(
                                f"policy {self._key(pol)} port spec "
                                f"{spec.protocol} {spec.port}-{hi} does not "
                                "align with the frozen atom partition; "
                                "rebuild the verifier"
                            )

    def _object_selected(self, pol: NetworkPolicy, pod: Pod) -> bool:
        return pod.namespace == pol.namespace and pol.pod_selector.matches(pod.labels)

    def _peer_matches(
        self, pol: NetworkPolicy, rules, rid: int, pid: int, pod: Pod
    ) -> bool:
        """Object-semantics evaluation of ONE flattened (rule, peer) against
        ONE pod, addressed through grant-row provenance."""
        if pid < 0:  # match-all rule
            return True
        peer = rules[rid].peers[pid]
        if peer.ip_block is not None:
            return peer.ip_block.matches_ip(pod.ip)
        if peer.namespace_selector is None:
            ns_ok = pod.namespace == pol.namespace
        else:
            ns_ok = peer.namespace_selector.matches(self._ns_labels.get(pod.namespace, {}))
        return ns_ok and (
            peer.pod_selector is None or peer.pod_selector.matches(pod.labels)
        )

    def _fix_sel(self, pol: NetworkPolicy, sel: np.ndarray) -> np.ndarray:
        """Object-semantics fixups for churned pods: the vectorizer's
        posting lists are frozen, so dirty (relabeled/added) pods re-evaluate
        object-level and tombstoned pods force to False."""
        vz = self._vectorizer
        for i in vz.dirty:
            sel[i] = self._object_selected(pol, self.pods[i])
        for i in vz.inactive:
            sel[i] = False
        return sel

    def _policy_groups(
        self, pol: NetworkPolicy
    ) -> Tuple[np.ndarray, np.ndarray, Dict, Dict]:
        """Host evaluation of one policy under the frozen port universe:
        (sel_ing, sel_eg) policy-level vectors + per-direction
        {(segment, restrict): (peer-union vector, (rule, peer) provenance)}
        group dicts."""
        self._check_ports_representable(pol)
        vz = self._vectorizer
        try:
            delta = encode_policy_delta(
                pol, vz.vocab, self._atoms, vz.ns_index, self.pods,
                self._resolution, self._bank_intern,
            )
        except FrozenBankMiss as e:
            raise PortUniverseChanged(
                f"policy {self._key(pol)} needs a named-port restriction "
                f"outside the frozen bank ({e}); rebuild the verifier"
            )
        sel = self._fix_sel(pol, vz._sel_mask(delta.pod_sel, 0) & vz._ns_mask(delta.pol_ns))
        da = self.config.direction_aware_isolation
        aff_i = delta.affects_ingress if da else True
        aff_e = delta.affects_egress if da else True
        sel_ing = sel & aff_i
        sel_eg = sel & aff_e

        def direction_groups(block: GrantBlock, aff: bool, rules) -> Dict:
            out: Dict[Tuple[int, int], Tuple[np.ndarray, frozenset]] = {}
            # dirty-pod fixups cache per (rule, peer, pod): a rule whose
            # port specs split into v variants emits v grant rows sharing
            # one (rid, pid) — evaluate each dirty pod once, not v times
            pm_cache: Dict[Tuple[int, int, int], bool] = {}
            if not aff or block.n == 0:
                return out
            block = _split_grant_ports(block)
            ports = np.asarray(block.ports)
            restricts = (
                np.asarray(block.dst_restrict)
                if block.dst_restrict is not None
                else np.zeros(block.n, dtype=np.int32)
            )
            for g in range(block.n):
                mask = tuple(bool(b) for b in ports[g])
                if not any(mask):
                    continue  # inert row (e.g. unresolvable named-only rule)
                if all(mask):
                    seg = len(self._mask_rank)  # full block
                else:
                    seg = self._mask_rank.get(mask)
                    if seg is None:
                        raise PortUniverseChanged(
                            f"policy {self._key(pol)} uses a port mask "
                            "outside the frozen layout (new atom boundaries "
                            "or a new run mask); rebuild the verifier"
                        )
                key = (seg, int(restricts[g]))
                peers = self._grant_row_peers(block, g, delta.pol_ns)
                rid = int(block.rule_id[g])
                pid = int(block.peer_id[g])
                if vz.dirty or vz.inactive:
                    # frozen posting lists: out-of-universe pods re-evaluate
                    # with object semantics
                    for i in vz.dirty:
                        ck = (rid, pid, i)
                        hit = pm_cache.get(ck)
                        if hit is None:
                            hit = self._peer_matches(pol, rules, rid, pid, self.pods[i])
                            pm_cache[ck] = hit
                        peers[i] = hit
                    for i in vz.inactive:
                        peers[i] = False
                prov = frozenset({(rid, pid)})
                if key in out:
                    ovec, oprov = out[key]
                    out[key] = (ovec | peers, oprov | prov)
                else:
                    out[key] = (peers, prov)
            return out

        groups_i = direction_groups(delta.ingress, aff_i, pol.ingress)
        groups_e = direction_groups(delta.egress, aff_e, pol.egress)
        return sel_ing, sel_eg, groups_i, groups_e

    # ---------------------------------------------------------------- diffs
    def _seg_of_row(self, d: str, row: int) -> int:
        for s_idx, (start, length) in enumerate(self._seg_spans[d]):
            if start <= row < start + length:
                return s_idx
        raise AssertionError(f"row {row} outside every {d} segment")

    def _plan_alloc(self, d: str, groups: Dict, recycled: List[int]) -> Dict:
        """Assign one VP row per (segment, restrict) group WITHOUT mutating
        any bookkeeping — the caller commits only after every direction's
        plan succeeds, so a failed diff leaves the state intact. ``recycled``
        rows (the policy's own rows about to be freed) are preferred."""
        by_seg: Dict[int, List[int]] = {}
        for row in recycled:
            by_seg.setdefault(self._seg_of_row(d, row), []).append(row)
        taken: Dict[int, int] = {}
        assigned = {}
        for (seg, res), (vec, prov) in groups.items():
            pool = by_seg.get(seg, [])
            free = self._free_rows[d][seg]
            used = taken.get(seg, 0)
            if pool:
                row = pool.pop()
            elif used < len(free):
                row = free[-1 - used]
                taken[seg] = used + 1
            else:
                raise PortUniverseChanged(
                    f"segment {seg} ({'ingress' if d == 'i' else 'egress'}) "
                    "has no free virtual-policy rows left; rebuild the "
                    "verifier (or construct it with more headroom)"
                )
            assigned[row] = (res, vec, prov)
        return assigned

    def _commit_rows(
        self, d: str, key: str, assigned: Dict, old_rows: List[int]
    ) -> List[int]:
        """Apply a planned allocation: release the policy's old rows, claim
        the assigned ones (recording their restriction + peer provenance for
        pod churn); returns the freed-but-not-reused rows."""
        for row in old_rows:
            del self._row_owner[d][row]
            self._free_rows[d][self._seg_of_row(d, row)].append(row)
            self._row_res[d].pop(row, None)
            self._row_peers[d].pop(row, None)
        self._pol_rows[key][d] = []
        for row, (res, _vec, prov) in assigned.items():
            free = self._free_rows[d][self._seg_of_row(d, row)]
            free.remove(row)
            self._row_owner[d][row] = key
            self._pol_rows[key][d].append(row)
            self._row_res[d][row] = int(res)
            self._row_peers[d][row] = set(prov)
        return [r for r in old_rows if r not in assigned]

    def _diff_lines(
        self, old_sel, new_sel, assigned_i, assigned_e, freed_i, freed_e, span
    ) -> tuple:
        """Host math for one policy diff: ``(rows, cols, locs, vals, d_ing,
        d_eg)``, the touched rows and columns (counted on ``span``), the
        new VP-row values and where they go, and the count deltas."""
        n, Np = self.n_pods, self._n_padded
        old_si, old_se = old_sel
        new_si, new_se = new_sel
        ing2 = self._h_ing_cnt + (new_si.astype(np.int64) - old_si)
        eg2 = self._h_eg_cnt + (new_se.astype(np.int64) - old_se)
        iso_chg_i = (self._h_ing_cnt > 0) != (ing2 > 0)
        iso_chg_e = (self._h_eg_cnt > 0) != (eg2 > 0)
        rows = np.nonzero((old_se | new_se) | iso_chg_e)[0]
        cols = np.nonzero((old_si | new_si) | iso_chg_i)[0]
        d_ing = np.zeros(Np, dtype=np.int32)
        d_eg = np.zeros(Np, dtype=np.int32)
        d_ing[:n] = new_si.astype(np.int32) - old_si
        d_eg[:n] = new_se.astype(np.int32) - old_se
        self._h_ing_cnt = ing2
        self._h_eg_cnt = eg2

        locs, vals = {}, {}
        for d, assigned, freed, sel_vec in (
            ("i", assigned_i, freed_i, new_si), ("e", assigned_e, freed_e, new_se)
        ):
            touched = sorted(set(freed) | set(assigned))
            if not touched:
                continue  # the JAX engine's no-op write to the sink row
            # (src, dst) values of each touched row over the padded pod axis;
            # freed rows and the pad columns are zero
            v = np.zeros((2, len(touched), Np), dtype=np.int8)
            for j, row in enumerate(touched):
                if row in assigned:
                    res, peer_vec, _ = assigned[row]
                    bank_row = self._bank8_host[res][:n] > 0
                    if d == "i":
                        v[0, j, :n] = peer_vec
                        v[1, j, :n] = sel_vec & bank_row
                    else:
                        v[0, j, :n] = sel_vec
                        v[1, j, :n] = peer_vec & bank_row
            locs[d] = [
                (m, row - self._seg_spans[d][m][0])
                for m, row in ((self._seg_of_row(d, r), r) for r in touched)
            ]
            vals[d] = v
        span.attrs.update(rows=len(rows), cols=len(cols))
        return rows, cols, locs, vals, d_ing, d_eg

    def _apply(self, rows, cols, locs, vals, d_ing, d_eg) -> None:
        """``_diff_lines``' VP-row write and patches: ``engine.dispatch``."""
        with trace_if_read("engine.dispatch"):
            if self._shards is not None:
                self._shards.vp_write(self, locs, vals, d_ing, d_eg)
            else:
                _TRACKER.track("_vp_write", self._src, self._dst, vals)
                _vp_write(
                    self._src, self._dst, self._ing_cnt, self._eg_cnt, locs,
                    {d: self._put(v) for d, v in vals.items()},
                    self._put(d_ing), self._put(d_eg),
                )
            self._patch(rows, cols)
        self.update_count += 1

    def _patch(self, rows: np.ndarray, cols: np.ndarray) -> None:
        """``rows``/``cols``: unique sorted touched src rows / dst columns."""
        self._mark_closure_dirty(rows, cols)
        if self._shards is not None:
            for g in _groups(rows, _ROW_GROUP):
                self._shards.patch_rows(self, g, self._flags)
            for g in _groups(cols, _COL_GROUP):
                self._shards.patch_cols(self, g, self._flags)
            return
        args = (self._packed, self._src, self._dst, self._ing_cnt, self._eg_cnt)
        flags = dict(layout=self._layout, **self._flags)
        for g in _groups(rows, _ROW_GROUP):
            _ports_patch_rows(*args, self._col_mask, self._row_valid, self._put(g), **flags)
        for g in _groups(cols, _COL_GROUP):
            _ports_patch_cols(*args, self._row_valid, *self._col_meta(g), **flags)

    def _policy_sel(self, pol: NetworkPolicy) -> Tuple[np.ndarray, np.ndarray]:
        """(sel_ing, sel_eg) only — the cheap evaluation for the OUTGOING
        side of a diff (its VP rows are freed wholesale; only the selection
        vectors feed the patch masks and isolation counts)."""
        vz = self._vectorizer
        stack = _encode_selector_stack([pol.pod_selector], vz.vocab)
        sel = self._fix_sel(
            pol,
            vz._sel_mask(stack, 0) & vz._ns_mask(vz.ns_index.get(pol.namespace, -2)),
        )
        da = self.config.direction_aware_isolation
        aff_i = pol.affects_ingress if da else True
        aff_e = pol.affects_egress if da else True
        return sel & aff_i, sel & aff_e

    @_change("policy_add")
    def add_policy(self, pol: NetworkPolicy) -> None:
        key = self._key(pol)
        if key in self.policies:
            raise KeyError(f"policy {key} exists; use update_policy")
        with trace_if_read("engine.evaluate") as ev:
            # every step that can raise happens BEFORE any mutation
            new_si, new_se, gi, ge = self._policy_groups(pol)
            assigned_i = self._plan_alloc("i", gi, [])
            assigned_e = self._plan_alloc("e", ge, [])
            if pol.namespace not in self._ns_labels:
                self._ns_labels[pol.namespace] = {}
            self._pol_rows.setdefault(key, {"i": [], "e": []})
            self._commit_rows("i", key, assigned_i, [])
            self._commit_rows("e", key, assigned_e, [])
            self.policies[key] = pol
            zeros = np.zeros(self.n_pods, dtype=bool)
            diff = self._diff_lines((zeros, zeros), (new_si, new_se), assigned_i,
                                    assigned_e, [], [], ev)
        self._apply(*diff)
        self._count_op("policy_add")

    @_change("policy_remove")
    def remove_policy(self, namespace: str, name: str) -> None:
        key = f"{namespace}/{name}"
        with trace_if_read("engine.evaluate") as ev:
            pol = self.policies[key]  # KeyError if absent
            old_si, old_se = self._policy_sel(pol)
            del self.policies[key]
            freed_i = self._commit_rows("i", key, {}, list(self._pol_rows[key]["i"]))
            freed_e = self._commit_rows("e", key, {}, list(self._pol_rows[key]["e"]))
            del self._pol_rows[key]  # no leak under add/remove churn
            zeros = np.zeros(self.n_pods, dtype=bool)
            diff = self._diff_lines((old_si, old_se), (zeros, zeros), {}, {}, freed_i,
                                    freed_e, ev)
        self._apply(*diff)
        self._count_op("policy_remove")

    @_change("policy_update")
    def update_policy(self, pol: NetworkPolicy) -> None:
        key = self._key(pol)
        with trace_if_read("engine.evaluate") as ev:
            old = self.policies[key]  # KeyError if absent
            old_si, old_se = self._policy_sel(old)
            new_si, new_se, gi, ge = self._policy_groups(pol)
            old_rows_i = list(self._pol_rows[key]["i"])
            old_rows_e = list(self._pol_rows[key]["e"])
            # plan both directions (may raise) before mutating anything; the
            # policy's own outgoing rows are offered back to the planner
            assigned_i = self._plan_alloc("i", gi, list(old_rows_i))
            assigned_e = self._plan_alloc("e", ge, list(old_rows_e))
            freed_i = self._commit_rows("i", key, assigned_i, old_rows_i)
            freed_e = self._commit_rows("e", key, assigned_e, old_rows_e)
            self.policies[key] = pol
            diff = self._diff_lines((old_si, old_se), (new_si, new_se), assigned_i,
                                    assigned_e, freed_i, freed_e, ev)
        self._apply(*diff)
        self._count_op("policy_update")

    # ------------------------------------------------------------ pod churn
    def _pod_bank_col(self, pod: Pod, strict: bool = False) -> np.ndarray:
        """bool [B]: which restriction-bank rows this pod belongs to — its
        single-pod named-port resolution. Row 0 is the unrestricted row,
        always True. ``strict`` (the add-time check) raises
        ``PortUniverseChanged`` when a referenced (protocol, name) resolves
        outside the frozen bank — the bank is baked into the resident VP
        rows and cannot grow, so rules naming that port would otherwise
        silently miss this destination. Relabels never hit that case:
        labels cannot move resolution."""
        col = np.zeros(self._bank8_host.shape[0], dtype=bool)
        col[0] = True
        ids = self._bank_intern._ids if self._bank_intern is not None else {}
        for proto, name in self._resolution or {}:
            entry = pod.container_ports.get(name)
            if entry is None or entry[0] != proto:
                continue
            num = int(entry[1])
            rid = None
            for q, atom in enumerate(self._atoms):
                if atom.name is None and atom.protocol == proto and atom.lo <= num <= atom.hi:
                    rid = ids.get((proto, name, q))
                    break
            if rid is None:
                if strict:
                    raise PortUniverseChanged(
                        f"pod {self._pod_key(pod)} resolves named port "
                        f"({proto}, {name}) -> {num} outside the frozen "
                        "restriction bank; rebuild the verifier"
                    )
            else:
                col[rid] = True
        return col

    def _pod_vp_cols(self, pod: Pod, strict_bank: bool = False):
        """One pod's column across the four VP maps (int8 [2, T] per
        direction, (src, dst) values) + its policy-level isolation counts —
        O(total VP rows + P) host evaluation with object semantics. Peer
        results are cached per (policy, direction, rule, peer) since one peer
        typically feeds several port-variant rows."""
        ci = np.zeros((2, self._total_rows["i"]), dtype=np.int8)  # (peer, sel·bank)
        ce = np.zeros((2, self._total_rows["e"]), dtype=np.int8)  # (sel, peer·bank)
        bank_col = self._pod_bank_col(pod, strict=strict_bank)
        da = self.config.direction_aware_isolation
        cnt_i = cnt_e = 0
        sel_flags: Dict[str, Tuple[bool, bool, bool, bool]] = {}
        for key, pol in self.policies.items():
            aff_i = pol.affects_ingress if da else True
            aff_e = pol.affects_egress if da else True
            selected = self._object_selected(pol, pod)
            si = selected and aff_i
            se = selected and aff_e
            cnt_i += si
            cnt_e += se
            sel_flags[key] = (si, se, aff_i, aff_e)
        pm_cache: Dict[Tuple[str, str, int, int], bool] = {}
        for d in ("i", "e"):
            for row, key in self._row_owner[d].items():
                pol = self.policies[key]
                si, se, aff_i, aff_e = sel_flags[key]
                res = self._row_res[d][row]
                rules = pol.ingress if d == "i" else pol.egress
                aff = aff_i if d == "i" else aff_e
                pm = False
                if aff:
                    for rid, pid in self._row_peers[d].get(row, ()):
                        ck = (key, d, rid, pid)
                        hit = pm_cache.get(ck)
                        if hit is None:
                            hit = self._peer_matches(pol, rules, rid, pid, pod)
                            pm_cache[ck] = hit
                        if hit:
                            pm = True
                            break
                b = bool(bank_col[res])
                if d == "i":
                    ci[0, row] = pm
                    ci[1, row] = si and b
                else:
                    ce[0, row] = se
                    ce[1, row] = pm and b
        return ci, ce, int(cnt_i), int(cnt_e), bank_col

    def _dispatch_pod(
        self, idx: int, ci: np.ndarray, ce: np.ndarray, cnt_i: int, cnt_e: int,
        active: bool, *, bookkeep: bool = True,
    ) -> None:
        """One pod-slot step (occupy, relabel or tombstone):
        ``engine.dispatch``. ``bookkeep`` is False only for the prewarm's
        tombstone."""
        with trace_if_read("engine.dispatch"):
            if bookkeep:
                self._mark_closure_dirty([idx], [idx])
            if self._shards is not None:
                # SPMD: not retried (a retry on one rank alone would strand
                # the others in a collective)
                self._shards.pod_step(self, idx, ci, ce, cnt_i, cnt_e, active,
                                      self._flags)
            else:
                self._pod_step_one_device(idx, ci, ce, cnt_i, cnt_e, active)
        if bookkeep:
            self.update_count += 1

    def _pod_step_one_device(self, idx, ci, ce, cnt_i, cnt_e, active) -> None:
        ci_t, ce_t = self._put(ci), self._put(ce)
        _TRACKER.track(
            "_ports_pod_step", self._packed, self._src, self._dst,
            static=tuple(sorted(self._flags.items())),
        )
        retry_transient(
            lambda: _ports_pod_step(
                self._packed, self._src, self._dst, self._ing_cnt, self._eg_cnt,
                self._col_mask, self._row_valid, idx, ci_t, ce_t, cnt_i, cnt_e,
                active, layout=self._layout, **self._flags,
            ),
            policy=self.retry_policy,
            backend="packed-ports",
        )

    # identical state surface (_ns_labels / namespaces / _vectorizer /
    # _packed / _closure / pods) — the any-port engine's implementations
    add_namespace = PackedIncrementalVerifier.add_namespace
    closure_packed = PackedIncrementalVerifier.closure_packed
    _mark_closure_dirty = PackedIncrementalVerifier._mark_closure_dirty
    _ns_pod_slots = PackedIncrementalVerifier._ns_pod_slots
    _set_ns_labels = PackedIncrementalVerifier._set_ns_labels
    remove_namespace = PackedIncrementalVerifier.remove_namespace

    @_change("namespace_relabel")
    def update_namespace_labels(self, name: str, labels: Dict[str, str]) -> None:
        """Relabel namespace ``name`` under full port semantics — the
        batched pod relabel. Each pod in the namespace re-evaluates
        object-level against every VP row (``_pod_vp_cols``; named-port
        resolution depends on container ports, not namespace labels, so the
        restriction bank cannot move); the columns land ``_COL_GROUP`` pods
        at a time, then one ``_patch`` re-derives the pods' rows and
        columns."""
        if name not in self._ns_labels:
            raise KeyError(f"namespace {name} is not registered")
        if dict(self._ns_labels[name]) == dict(labels):
            return
        self._set_ns_labels(name, labels)
        self._count_op("namespace_relabel")
        # the column writes stream behind the host evaluation, one group of
        # pods at a time, inside ``engine.evaluate``: the group's write is
        # small next to its evaluation
        with trace_if_read("engine.evaluate") as ev:
            idx_arr = self._ns_pod_slots(name)
            ev.attrs.update(rows=len(idx_arr), cols=len(idx_arr))
            for g in _groups(idx_arr, _COL_GROUP):
                cols = [self._pod_vp_cols(self.pods[int(i)]) for i in g]
                cnt_i = np.asarray([c[2] for c in cols], dtype=np.int32)
                cnt_e = np.asarray([c[3] for c in cols], dtype=np.int32)
                self._h_ing_cnt[g] = cnt_i
                self._h_eg_cnt[g] = cnt_e
                if self._shards is not None:
                    self._shards.write_pod_rows(
                        self, g, np.stack([c[0] for c in cols], axis=-1),
                        np.stack([c[1] for c in cols], axis=-1), cnt_i, cnt_e)
                    continue
                _ports_apply_pod_cols_group(
                    self._src, self._dst, self._ing_cnt, self._eg_cnt, self._layout,
                    self._put(g),
                    self._put(np.stack([c[0] for c in cols], axis=-1)),
                    self._put(np.stack([c[1] for c in cols], axis=-1)),
                    self._put(cnt_i), self._put(cnt_e),
                )
        if not len(idx_arr):
            return
        with trace_if_read("engine.dispatch"):
            self._patch(idx_arr, idx_arr)
        self.update_count += 1

    @_change("pod_add")
    def add_pod(self, pod: Pod) -> int:
        """Add a pod in O(total VP rows + P) host work + one pod step.
        Returns the pod's slot index. Reuses a tombstoned slot when one
        exists, then the built-in headroom (``pod_headroom`` +
        pad-to-alignment), and only then grows the pod axis."""
        key = self._pod_key(pod)
        if key in self._pod_idx:
            raise KeyError(f"pod {key} exists; remove it first")
        pod = dataclasses.replace(
            pod, labels=dict(pod.labels), container_ports=dict(pod.container_ports)
        )
        # everything that can raise — the strict bank check, and peer
        # evaluation (e.g. a malformed pod IP against an ipBlock peer) —
        # runs BEFORE any bookkeeping mutation, so a failed add leaves no
        # phantom half-registered pod
        with trace_if_read("engine.evaluate", rows=1, cols=1):
            ci, ce, cnt_i, cnt_e, bank_col = self._pod_vp_cols(pod, strict_bank=True)
        if pod.namespace not in self._ns_labels:
            # auto-created namespace (empty labels), mirroring
            # Cluster.__post_init__; fresh index, no frozen pods carry it
            self._ns_labels[pod.namespace] = {}
            vz = self._vectorizer
            vz.ns_index.setdefault(pod.namespace, len(vz.ns_index))
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
        self._pod_idx[key] = idx
        self._col_valid[idx] = True
        self._vectorizer.note_pod(idx)
        self._bank8_host[:, idx] = bank_col
        self._h_ing_cnt[idx] = cnt_i
        self._h_eg_cnt[idx] = cnt_e
        self._dispatch_pod(idx, ci, ce, cnt_i, cnt_e, active=True)
        self._count_op("pod_add")
        return idx

    @_change("pod_remove")
    def remove_pod(self, namespace: str, name: str) -> int:
        """Remove a pod: tombstone its slot (zero column in every VP map,
        zero isolation counts, clear validity, zero its packed row +
        bit-column) in one pod step. Returns the freed slot index."""
        key = f"{namespace}/{name}"
        with trace_if_read("engine.evaluate", rows=1, cols=1):
            idx = self._pod_idx.pop(key)  # KeyError if absent
            self.pod_active[idx] = False
            self._col_valid[idx] = False
            self._pod_free.append(idx)
            self._vectorizer.note_removed(idx)
            self._h_ing_cnt[idx] = 0
            self._h_eg_cnt[idx] = 0
        self._dispatch_pod(
            idx,
            np.zeros((2, self._total_rows["i"]), dtype=np.int8),
            np.zeros((2, self._total_rows["e"]), dtype=np.int8),
            0, 0, active=False,
        )
        self._count_op("pod_remove")
        return idx

    @_change("pod_relabel")
    def update_pod_labels(self, idx: int, labels: Dict[str, str]) -> None:
        """Relabel pod ``idx`` in place: selector matches and peer
        membership move (object-semantics re-evaluation of this one pod
        against every VP row through the grant provenance); named-port
        resolution depends on ``container_ports``, not labels, so the
        restriction bank is unchanged. One pod step."""
        if not 0 <= idx < self.n_pods or not self.pod_active[idx]:
            raise KeyError(f"pod slot {idx} is not an active pod")
        with trace_if_read("engine.evaluate", rows=1, cols=1):
            pod = self.pods[idx]
            pod.labels = dict(labels)
            self._vectorizer.note_pod(idx)
            ci, ce, cnt_i, cnt_e, bank_col = self._pod_vp_cols(pod)
            self._bank8_host[:, idx] = bank_col
            self._h_ing_cnt[idx] = cnt_i
            self._h_eg_cnt[idx] = cnt_e
        self._dispatch_pod(idx, ci, ce, cnt_i, cnt_e, active=True)
        self._count_op("pod_relabel")

    def _grow_pods(self, min_extra: int = 1) -> None:
        """Grow the pod axis by at least ``min_extra`` slots, keeping the
        tile and word alignments (the JAX engine's rule: at least two
        alignment units). A grow copies every device buffer — prefer
        ``pod_headroom`` at build time."""
        dp = 1 if self._shards is None else self._shards.dp
        a = int(np.lcm(np.lcm(self._tile, 128), 128 * dp))
        grow = max(-(-min_extra // a) * a, 2 * a)
        Np2 = self._n_padded + grow
        if self._shards is not None:
            self._shards.grow_pods(self, Np2)
        else:
            pad = torch.nn.functional.pad
            for maps in (self._src, self._dst):
                for d in maps:
                    maps[d] = [pad(t, (0, 0, 0, grow)) for t in maps[d]]
            self._ing_cnt = pad(self._ing_cnt, (0, grow))
            self._eg_cnt = pad(self._eg_cnt, (0, grow))
            self._packed = pad(self._packed, (0, grow // 32, 0, grow))
        self._bank8_host = np.pad(self._bank8_host, ((0, 0), (0, grow)))
        self._col_valid = np.concatenate([self._col_valid, np.zeros(grow, dtype=bool)])
        self._col_mask = self._put(self._col_mask_host())
        rv = np.zeros(Np2, dtype=np.int8)
        rv[: self.n_pods] = self.pod_active
        self._row_valid = self._put_rows(rv)
        self._n_padded = Np2
        self._closure = None  # shape changed; next closure_packed is full
        self._closure_base = None
        self._prewarm()

    # --------------------------------------------------------------- result
    # the any-port engine's (the ports engine always keeps its matrix)
    n_active = PackedIncrementalVerifier.n_active
    active_indices = PackedIncrementalVerifier.active_indices
    reach_active = PackedIncrementalVerifier.reach_active
    packed_reach = PackedIncrementalVerifier.packed_reach
    reach = PackedIncrementalVerifier.reach
    as_cluster = PackedIncrementalVerifier.as_cluster

    # ---------------------------------------------------------- persistence
    def state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        """``(arrays, meta)`` in the JAX engine's exchange format (every key,
        shape, dtype and byte equal, so a state written by one package loads
        in the other). Arrays: the four VP maps bit-packed along the pod axis
        in JAX's VP rows (sink row included), the counts, the words, the
        per-direction row ownership / restriction / (rule, peer) provenance
        and the pod-slot activity map. Meta (JSON-serialisable): the frozen
        layout, atoms, the named-resolution key set and the bank's interned
        key order. The cluster manifest (``as_cluster(include_inactive=
        True)``) travels separately."""
        keys = list(self.policies)
        key_id = {k: i for i, k in enumerate(keys)}

        def owners(d: str) -> np.ndarray:
            out = np.full(self._total_rows[d], -1, dtype=np.int32)
            for row, key in self._row_owner[d].items():
                out[row] = key_id[key]
            return out

        def row_res(d: str) -> np.ndarray:
            out = np.zeros(self._total_rows[d], dtype=np.int32)
            for row, res in self._row_res[d].items():
                out[row] = res
            return out

        def row_prov(d: str) -> np.ndarray:
            flat = [
                (row, rid, pid)
                for row, prov in self._row_peers[d].items()
                for rid, pid in sorted(prov)
            ]
            return np.asarray(flat, dtype=np.int32).reshape(-1, 3)

        def pack(d: str, segs: List[torch.Tensor]) -> np.ndarray:
            """The segments' rows then the zero sink row, uint8 [T, Np/8]."""
            if self._shards is not None:
                return self._shards.gather_segments(
                    d, segs, self._seg_spans[d], self._total_rows[d])
            rows = [_pack_pod_axis(t) for t in segs]
            rows.append(rows[0].new_zeros((1, self._n_padded // 8)))
            return torch.cat(rows).cpu().numpy()

        arrays = {
            key: pack(d, (self._dst if side else self._src)[d]) for key, d, side in _MAP_KEYS
        }
        ing_cnt, eg_cnt = self._whole_counts()
        arrays.update({
            "ing_cnt": ing_cnt.cpu().numpy().astype(np.int32),
            "eg_cnt": eg_cnt.cpu().numpy().astype(np.int32),
            "packed": _host_words(self._whole_words()),
            "owners_i": owners("i"),
            "owners_e": owners("e"),
            "res_i": row_res("i"),
            "res_e": row_res("e"),
            "prov_i": row_prov("i"),
            "prov_e": row_prov("e"),
            "pod_active": self.pod_active,
            "keys": np.array(keys),
            # authoritative namespace list — see the any-port engine's
            # state_dict: tombstones resurrect removed namespaces otherwise
            "ns_names": np.array([ns.name for ns in self.namespaces]),
        })
        if self._closure is not None:
            arrays["closure"] = _host_words(self._closure)
            arrays["closure_dirty"] = self._closure_dirty
            if self._closure_base is not None:
                arrays["closure_base"] = _host_words(self._closure_base)
        bank_keys = list(self._bank_intern._ids) if self._bank_intern is not None else []
        lay = self._layout
        meta = {
            "n_padded": self._n_padded,
            "tile": self._tile,
            "total_rows": dict(self._total_rows),
            "layout": {
                "seg_i": [list(s) for s in lay.seg_i],
                "seg_e": [list(s) for s in lay.seg_e],
                "full_i": list(lay.full_i),
                "full_e": list(lay.full_e),
                "ov_rows": [list(r) for r in lay.ov_rows],
            },
            "mask_rank": [[list(mask), rank] for mask, rank in self._mask_rank.items()],
            "atoms": [[a.protocol, a.lo, a.hi, a.name] for a in self._atoms],
            "resolution_keys": sorted(self._resolution or {}),
            "bank_keys": [list(k) for k in bank_keys],
            "sink_pol": self._sink_pol,
            "update_count": self.update_count,
        }
        return arrays, meta

    @classmethod
    def from_state(
        cls,
        cluster: Cluster,
        arrays: Dict[str, np.ndarray],
        meta: Dict,
        config: Optional[VerifyConfig] = None,
        device=None,
        mesh=None,
    ) -> "PackedPortsIncrementalVerifier":
        """Resume from :meth:`state_dict` output — this package's or the JAX
        engine's, saved on one device or on any mesh — WITHOUT re-solving:
        the VP maps, counts and words upload straight to the device (or
        this rank's block of them onto ``mesh``, the VP axis split for its
        grant axis); the vocab, namespace matrices, posting lists,
        resolution masks and restriction bank re-derive deterministically
        from the manifest."""
        self = cls.__new__(cls)
        self.config = config or VerifyConfig()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.pods = _copy_pods(cluster.pods)
        self.namespaces = list(cluster.namespaces)
        if "ns_names" in arrays:
            live_ns = {str(x) for x in arrays["ns_names"]}
            self.namespaces = [ns for ns in self.namespaces if ns.name in live_ns]
        self._ns_labels = {ns.name: dict(ns.labels) for ns in self.namespaces}
        n = len(self.pods)
        self.n_pods = n
        Np = int(meta["n_padded"])
        self._n_padded = Np
        self._tile = int(meta["tile"])
        self.update_count = int(meta["update_count"])
        self._closure = None
        self._closure_base = None
        self._closure_dirty = None
        self._sink_pol = int(meta["sink_pol"])
        self._total_rows = {k: int(v) for k, v in meta["total_rows"].items()}
        lay = meta["layout"]
        self._layout = PortLayout(
            seg_i=tuple(tuple(s) for s in lay["seg_i"]),
            seg_e=tuple(tuple(s) for s in lay["seg_e"]),
            full_i=tuple(lay["full_i"]),
            full_e=tuple(lay["full_e"]),
            ov_rows=tuple(tuple(r) for r in lay["ov_rows"]),
        )
        self._shards = _make_shards(mesh, Np, self._layout, self._total_rows)
        self._mask_rank = {
            tuple(bool(b) for b in mask): int(rank) for mask, rank in meta["mask_rank"]
        }
        self._atoms = [
            PortAtom(protocol=p, lo=lo, hi=hi, name=name) for p, lo, hi, name in meta["atoms"]
        ]
        phase = Phases(prefix="engine.resume.")
        with phase("host"):
            # re-derive the frozen universe from the manifest
            vocab = cluster_vocab(self.pods, self.namespaces)
            ns_index = {ns.name: i for i, ns in enumerate(self.namespaces)}
            self._ns_kv, self._ns_key = vocab.encode_label_matrix(
                ns.labels for ns in self.namespaces
            )
            res_keys = [tuple(k) for k in meta["resolution_keys"]]
            self._resolution = named_resolution([], self._atoms, self.pods, keys=res_keys)
            bank = None
            bank_rows = [np.ones(n, dtype=bool)]
            if meta["bank_keys"]:
                bank = _RestrictBank(n)
                for proto, name, q in (tuple(k) for k in meta["bank_keys"]):
                    bank.intern(
                        (proto, name, int(q)),
                        self._resolution[(proto, name)][:, int(q)].copy,
                    )
                bank.frozen = True
                bank_rows = bank.rows
            self._bank_intern = bank
            bank8 = np.zeros((len(bank_rows), Np), dtype=np.int8)
            for i, row in enumerate(bank_rows):
                bank8[i, :n] = row
            self._bank8_host = bank8
            if "res_i" not in arrays or "prov_i" not in arrays:
                raise ConfigError(
                    "checkpoint predates pod-churn support (missing VP row "
                    "restriction/provenance vectors); re-save from a fresh build"
                )
            self.pod_active = np.asarray(arrays.get("pod_active", np.ones(n, dtype=bool))).copy()
            self._pod_free = [i for i in range(n) if not self.pod_active[i]]
            self._pod_idx = {}
            for i, p in enumerate(self.pods):
                if self.pod_active[i]:
                    self._pod_idx.setdefault(self._pod_key(p), i)
            self._col_valid = np.zeros(Np, dtype=bool)
            self._col_valid[:n] = self.pod_active
            self._col_mask = self._put(self._col_mask_host())
            rv = np.zeros(Np, dtype=np.int8)
            rv[:n] = self.pod_active
            self._row_valid = self._put_rows(rv)

            # ownership + free lists from the saved owner vectors
            keys = [str(k) for k in arrays["keys"]]
            by_key = {f"{p.namespace}/{p.name}": p for p in cluster.policies}
            self.policies = {k: by_key[k] for k in keys}
            self._seg_spans = {"i": _spans(self._layout, "i"), "e": _spans(self._layout, "e")}
            self._free_rows = {"i": {}, "e": {}}
            self._row_owner = {"i": {}, "e": {}}
            self._pol_rows = {k: {"i": [], "e": []} for k in keys}
            self._row_res = {"i": {}, "e": {}}
            self._row_peers = {"i": {}, "e": {}}
            for d in ("i", "e"):
                owners = np.asarray(arrays[f"owners_{d}"])
                res = np.asarray(arrays[f"res_{d}"])
                for s_idx, (start, length) in enumerate(self._seg_spans[d]):
                    free = []
                    for row in range(start, start + length):
                        oid = int(owners[row])
                        if oid < 0:
                            free.append(row)
                        else:
                            key = keys[oid]
                            self._row_owner[d][row] = key
                            self._pol_rows[key][d].append(row)
                            self._row_res[d][row] = int(res[row])
                    self._free_rows[d][s_idx] = free
                for row, rid, pid in np.asarray(arrays[f"prov_{d}"]).reshape(-1, 3):
                    self._row_peers[d].setdefault(int(row), set()).add((int(rid), int(pid)))

        # device state: each segment's rows unpacked pod-major
        with phase("upload"):
            self._src, self._dst = {}, {}
            for key, d, side in _MAP_KEYS:
                packed = np.asarray(arrays[key])
                if self._shards is not None:
                    segs = self._shards.load_segments(d, packed, self._seg_spans[d])
                else:
                    segs = [_unpack_pod_axis(packed[s : s + l], Np, self.device)
                            for s, l in self._seg_spans[d]]
                (self._dst if side else self._src)[d] = segs
            self._ing_cnt = self._put_rows(np.asarray(arrays["ing_cnt"], dtype=np.int32))
            self._eg_cnt = self._put_rows(np.asarray(arrays["eg_cnt"], dtype=np.int32))
            self._packed = _words(np.asarray(arrays["packed"])[self._rows()], self.device)
            if "closure" in arrays:
                self._closure = _words(arrays["closure"], self.device)
                self._closure_dirty = np.asarray(arrays["closure_dirty"], dtype=bool).copy()
                if "closure_base" in arrays:
                    self._closure_base = _words(arrays["closure_base"], self.device)
            self._sync()
        with phase("vectorizer"):
            self._vectorizer = PolicyVectorizer(
                self.pods, self._ns_labels, vocab, ns_index,
                self.config.direction_aware_isolation,
            )
            self._vectorizer.inactive = {i for i in range(n) if not self.pod_active[i]}
            self._h_ing_cnt = np.asarray(arrays["ing_cnt"], dtype=np.int64)[:n]
            self._h_eg_cnt = np.asarray(arrays["eg_cnt"], dtype=np.int64)[:n]
            self._prewarm()
            self._sync()
        #: seconds of the resume's phases: the host universe and
        #: bookkeeping, the state's upload and unpacking on the device, the
        #: host vectorizer (and the prewarm's tombstone)
        self.build_timings = phase.timings
        self.init_time = 0.0
        return self


# Kernel-manifest registration (observe/aot.py): rebind the dispatch
# functions so their dispatch keys reach the warm pack's manifest; call
# sites above are unchanged (late binding).
from .observe.aot import register_kernel as _register_kernel  # noqa: E402

_ports_patch_rows = _register_kernel(
    "packed-ports", "_ports_patch_rows", _ports_patch_rows,
    static_argnames=("layout", "self_traffic", "default_allow"),
)
_ports_patch_cols = _register_kernel(
    "packed-ports", "_ports_patch_cols", _ports_patch_cols,
    static_argnames=("layout", "self_traffic", "default_allow"),
)
_build_packed = _register_kernel("packed-ports", "_build_packed", _build_packed)
_vp_write = _register_kernel("packed-ports", "_vp_write", _vp_write)
_ports_pod_step = _register_kernel(
    "packed-ports", "_ports_pod_step", _ports_pod_step,
    static_argnames=("layout", "self_traffic", "default_allow"),
)
_ports_apply_pod_cols_group = _register_kernel(
    "packed-ports", "_ports_apply_pod_cols_group", _ports_apply_pod_cols_group
)
