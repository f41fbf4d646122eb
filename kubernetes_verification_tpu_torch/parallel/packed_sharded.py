"""Sharded *packed* reachability: the scale-out solve core (BASELINE config 5).

The port of ``kubernetes_verification_tpu.parallel.packed_sharded``. The
dense sharded solve (``sharded_ops.py``) holds ``[n_loc, N·Q]`` counts and
an ``[N, N]`` bool output; this one composes the packed tiled design
(``ops/tiled.py``) with the ``(pods, grants)`` mesh (``parallel/mesh.py``),
SPMD on ``torch.distributed``:

* each rank owns a block of ``n_loc = N/dp`` **source rows** end to end;
* per-policy peer maps are built from the rank's **grant slice** against
  its pod block and OR-combined by an int32 sum over ``grants``;
* the destination axis is swept in tiles: the tile's owner on ``pods``
  broadcasts its ``[T, P]`` selection and peer rows (bit-packed: 32 policies
  a word), every rank contracts its resident source operands against them
  (int8 ``bool_dot``), packs the ``[n_loc, T]`` block to words and folds
  the aggregates;
* ranks on ``grants`` take dst tiles round-robin; their words and
  aggregate partials cover disjoint tiles, so an int32 sum over ``grants``
  is the bitwise OR.

Differences of layout from the JAX package, none of semantics: the source
operands are held pod-major (``[n_loc, P]``, K-contiguous, the only fast
int8 layout on Hopper) and the destination operands pod-major bit-packed
along the policy axis, so a tile's rows are contiguous and unpack straight
into ``bool_dot``'s ``[T, P]`` operand; the owner broadcasts its tile where
the JAX package sums a masked contribution over ``pods``; the operands are
built once per solve, and a ``sweep_chunk_tiles`` sweep reuses them for
every chunk (the JAX package re-runs its compiled body per chunk).

A multi-atom encoding runs the port-bitmap sweep: grants group into
(policy, port-mask) virtual policies on the host (``ops/tiled_ports.py``),
each rank builds the VP peer maps from its grant slice, and the per-tile
conjunction is ``_mask_group_conj`` over segment products whose source
operands are held one contiguous ``[n_loc, l]`` tensor per segment.
"""
from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..encode.encoder import EncodedCluster, GrantBlock
from ..observe.introspect import maybe_publish
from ..ops.bits import pack_bool_cols, unpack_cols, unpack_words_i8
from ..ops.closure import bool_dot
from ..ops.match import as_tensors, match_selectors
from ..ops.padding import pad_grants, pad_pods
from ..ops.tiled import _slot_counts, _with_sink
from ..resilience.errors import ConfigError
from .mesh import (
    BOTH,
    GRANT_AXIS,
    POD_AXIS,
    Mesh,
    all_gather,
    broadcast,
    pad_amount,
    psum,
    rank_slice,
)
from .sharded_ops import _t, local_grants

__all__ = ["PackedShardedResult", "sharded_packed_reach"]

_I8 = torch.int8
_I32 = torch.int32


@dataclass
class PackedShardedResult:
    """Aggregate outputs of a sharded packed solve (+ the packed matrix when
    ``keep_matrix``), identical on every rank.

    ``full_sweep`` records whether the solve covered every dst tile. Partial
    (striped) results expose their aggregate *partials* — a checkpointed
    sweep sums them across stripes — but the whole-matrix queries refuse to
    answer from partial coverage rather than return plausible wrong lists."""

    n_pods: int
    total_pairs: int
    out_degree: np.ndarray  # int64 [N] — reachable dsts per src (swept tiles)
    in_degree: np.ndarray  # int64 [N] — reaching srcs per dst (swept tiles)
    ingress_isolated: np.ndarray  # bool [N]
    egress_isolated: np.ndarray  # bool [N]
    full_sweep: bool = True
    packed: Optional[np.ndarray] = None  # uint32 [N, W] when keep_matrix
    #: solve-time user groups (``groups=`` arg) and the per-group in-degree
    #: table [U, N] — lets ``user_crosscheck`` answer from aggregates alone
    #: at scales where the matrix is never materialised
    groups: Optional[np.ndarray] = None
    group_in_degree: Optional[np.ndarray] = None
    timings: Optional[dict] = None

    def _require_full(self, what: str) -> None:
        if not self.full_sweep:
            raise ConfigError(
                f"{what} needs the full dst sweep; this result covers only "
                f"stripe {self.timings.get('stripe') if self.timings else '?'}"
                " — sum aggregate partials across stripes instead"
            )

    def all_reachable(self) -> List[int]:
        """Pods reachable from every pod (``kano/algorithm.py:4-9``)."""
        self._require_full("all_reachable")
        return np.nonzero(self.in_degree == self.n_pods)[0].tolist()

    def all_isolated(self) -> List[int]:
        """Pods reachable from no pod (``kano/algorithm.py:12-17``)."""
        self._require_full("all_isolated")
        return np.nonzero(self.in_degree == 0)[0].tolist()

    def system_isolation(self, idx: int) -> List[int]:
        """Pods NOT reachable from pod ``idx`` (row complement,
        ``kano/algorithm.py:45-55``); needs the packed matrix — at
        matrix-free scale re-solve a one-src stripe instead."""
        if self.packed is None:
            raise ConfigError(
                "system_isolation needs keep_matrix=True (a single row of a "
                "matrix-free solve does not exist); re-run with keep_matrix "
                "or restrict the cluster"
            )
        self._require_full("system_isolation")
        row = unpack_cols(self.packed[idx : idx + 1], self.n_pods)[0]
        return np.nonzero(~row)[0].tolist()

    def user_crosscheck(self, objs, label: str) -> List[int]:
        """Pods reachable from a pod of a different user group
        (``kano/algorithm.py:27-42``). Prefers the packed matrix (the
        word-OR algorithm of ``ops.tiled.PackedReach``); falls back to the
        per-group in-degree aggregates when the solve ran with ``groups=``
        — dst j is flagged iff srcs outside its group reach it, i.e.
        ``in_degree[j] > group_in_degree[gid[j], j]``."""
        from ..ops.queries import user_groups

        self._require_full("user_crosscheck")
        gid = user_groups(objs, label)
        if gid.shape[0] != self.n_pods:
            raise ConfigError(
                f"user_crosscheck: {gid.shape[0]} objects != {self.n_pods} pods"
            )
        if self.packed is not None:
            from ..ops.tiled import _crosscheck_from_group_or, _host_group_or

            n_groups = int(gid.max()) + 1
            if n_groups <= 1:
                return []
            group_or = _host_group_or(self.packed[: self.n_pods], gid, n_groups)
            return _crosscheck_from_group_or(group_or, gid, self.n_pods)
        if self.group_in_degree is None or self.groups is None:
            raise ConfigError(
                "user_crosscheck on a matrix-free solve needs the solve to "
                "have run with groups=<per-pod group ids>"
            )
        if not np.array_equal(gid, self.groups):
            raise ConfigError(
                "user_crosscheck: requested grouping differs from the "
                "groups= the solve aggregated over; re-solve with this "
                "grouping"
            )
        own = self.group_in_degree[gid, np.arange(self.n_pods)]
        return np.nonzero(self.in_degree > own)[0].tolist()

    def to_bool(self) -> np.ndarray:
        if self.packed is None:
            raise ConfigError(
                "solve ran matrix-free (keep_matrix=False): the dense matrix "
                "is unavailable; re-run with keep_matrix=True or query the "
                "aggregates"
            )
        self._require_full("to_bool")
        return unpack_cols(self.packed, self.n_pods)

    def closure(
        self,
        tile: int = 7168,
        max_iter: int = 32,
        mesh: Optional[Mesh] = None,
        hbm_limit: Optional[int] = None,
        *,
        device=None,
    ) -> np.ndarray:
        """Packed-domain transitive closure of the kept matrix → uint32
        [N, W]. Needs ``keep_matrix=True`` and a full sweep.

        With ``mesh`` (any rank count, including 1) the squaring runs
        mesh-sharded (``sharded_closure.sharded_packed_closure``): each rank
        owns a row stripe, and the pre-flight memory guard refuses
        dispatches that would not fit (``hbm_limit`` overrides the detected
        budget). Without a mesh it is the one-device ``packed_closure`` on
        ``device`` (default ``"cuda"``) — the two are bit-identical by the
        fixpoint argument."""
        if self.packed is None:
            raise ConfigError(
                "closure needs keep_matrix=True (the packed matrix is the "
                "closure's operand); re-run with keep_matrix"
            )
        self._require_full("closure")
        if mesh is not None:
            from .sharded_closure import sharded_packed_closure

            return sharded_packed_closure(
                mesh, self.packed[: self.n_pods], tile=tile, max_iter=max_iter,
                hbm_limit=hbm_limit,
            )
        from ..ops.bits import to_host_words
        from ..ops.closure import _words, packed_closure

        words = _words(self.packed, device)
        padded = F.pad(words, (0, 0, 0, words.shape[1] * 32 - words.shape[0]))
        closed = packed_closure(padded, tile=tile, max_iter=max_iter)
        return to_host_words(closed[: self.n_pods])


class _Local:
    """The SPMD body of one solve on this rank (the JAX package's
    ``_packed_local``): the resident operands, built once, and the dst-tile
    sweep over them (``sweep``), which can run stripe by stripe."""

    def __init__(
        self,
        mesh: Mesh,
        host: dict,
        *,
        self_traffic: bool,
        default_allow_unselected: bool,
        direction_aware_isolation: bool,
        chunk: int,
        tile: int,
        n_total: int,
        keep_matrix: bool,
        layout,
        want_groups: bool,
    ):
        self.mesh = mesh
        self.self_traffic = self_traffic
        self.default_allow = default_allow_unselected
        self.tile = tile
        self.n_total = n_total
        self.keep_matrix = keep_matrix
        self.layout = layout
        dev = mesh.device
        rows = rank_slice(mesh, POD_AXIS, n_total)
        self.row0 = rows.start
        t = functools.partial(_t, mesh=mesh)
        pod_kv, pod_key, pod_ns = (t(host[k][rows]) for k in ("pod_kv", "pod_key", "pod_ns"))
        self.valid = t(host["valid"][rows])
        self.n_loc = n_loc = pod_kv.shape[0]
        self.grp8 = t(host["grp8"][:, rows]) if want_groups else None
        ns_kv, ns_key = t(host["ns_kv"]), t(host["ns_key"])
        pol_sel = as_tensors(host["pol_sel"], dev)
        pol_ns = t(host["pol_ns"])
        ingress = local_grants(host["ingress"], mesh, rows)
        egress = local_grants(host["egress"], mesh, rows)
        n_pol = pol_ns.shape[0]
        pol_ns_ext = _with_sink(pol_ns)

        selected = match_selectors(pol_sel, pod_kv, pod_key)
        selected &= pol_ns[:, None] == pod_ns[None, :]
        if direction_aware_isolation:
            sel_ing = selected & t(host["aff_ing"])[:, None]
            sel_eg = selected & t(host["aff_eg"])[:, None]
        else:
            sel_ing = sel_eg = selected
        del selected
        self.ing_iso_loc = sel_ing.any(dim=0)
        self.eg_iso_loc = sel_eg.any(dim=0)

        def peers_by_slot(block: GrantBlock, slots, total: int) -> torch.Tensor:
            """int8 [total, n_loc]: OR of each slot's grant peer rows over
            the rank's grant slice, then over ``grants`` (an int32 sum of
            the counts, exact)."""
            counts = _slot_counts(
                block, slots, total, chunk, pod_kv, pod_key, ns_kv, ns_key,
                pod_ns, pol_ns_ext,
            )
            return (psum(mesh, counts, GRANT_AXIS) > 0).to(_I8)

        if layout is None:
            # src side: resident int8, pod-major; dst side: bit-packed along
            # the policy axis, unpacked per broadcast tile
            ing_by_pol = peers_by_slot(ingress, ingress.pol, n_pol + 1)[:n_pol]
            eg_by_pol = peers_by_slot(egress, egress.pol, n_pol + 1)[:n_pol]
            self.src = (_pod_major(ing_by_pol), _pod_major(sel_eg.to(_I8)))
            del ing_by_pol
            dst = (sel_ing, eg_by_pol)
        else:
            zrow = sel_ing.new_zeros((1, n_loc))
            sel_ing_ext = torch.cat([sel_ing, zrow])  # the sink row P selects nothing
            sel_eg_ext = torch.cat([sel_eg, zrow]).to(_I8)
            vp = host["vp"]
            self.vp_pol_i = t(vp.pol_i).long()
            self.vp_res_i = t(vp.res_i).long()
            self.bank8 = t(vp.bank8)
            slots_i = t(vp.slot_i[rank_slice(mesh, GRANT_AXIS, len(vp.slot_i))])
            slots_e = t(vp.slot_e[rank_slice(mesh, GRANT_AXIS, len(vp.slot_e))])
            bank_loc = self.bank8[:, rows]
            vp_peers_i = peers_by_slot(ingress, slots_i, len(vp.pol_i))  # src side
            vp_peers_e = (
                peers_by_slot(egress, slots_e, len(vp.pol_e)) * bank_loc[t(vp.res_e).long()]
            ) > 0  # dst side, restriction-gated
            sel_eg_vp = sel_eg_ext[t(vp.pol_e).long()]  # src side: row v = sel(pol(v))
            # one contiguous [n_loc, l] source operand per segment, by start
            self.src_i = {
                s: vp_peers_i[s : s + l].t().contiguous()
                for s, l in (*layout.seg_i, layout.full_i) if l
            }
            self.src_e = {
                s: sel_eg_vp[s : s + l].t().contiguous()
                for s, l in (*layout.seg_e, layout.full_e) if l
            }
            del vp_peers_i, sel_eg_vp
            dst = (sel_ing_ext, vp_peers_e)
        # one broadcast a tile: both dst operands' words side by side
        self.dst_words = (dst[0].shape[0] + 31) // 32
        self.dst_bits = torch.cat([_pack_pod_major(x) for x in dst], dim=1)
        del dst, sel_ing, sel_eg
        # dst-side default-allow needs the global isolation vector: [N] — tiny
        self.ing_iso_full = all_gather(mesh, self.ing_iso_loc, POD_AXIS, dim=0)
        self.valid_full = all_gather(mesh, self.valid, POD_AXIS, dim=0)

    def _fetch(self, d0: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dst tile's two int8 ``[T, R']`` operands (R' the operand's
        rows rounded up to 32, zero beyond them), broadcast over ``pods``
        from the rank that owns the tile."""
        mesh = self.mesh
        owner = d0 // self.n_loc
        local0 = d0 - owner * self.n_loc
        if mesh.coords[POD_AXIS] == owner:
            buf = self.dst_bits[local0 : local0 + self.tile].clone()
        else:
            buf = torch.empty((self.tile, self.dst_bits.shape[1]), dtype=_I32, device=mesh.device)
        broadcast(mesh, buf, POD_AXIS, owner)
        w0 = self.dst_words
        return (
            unpack_words_i8(buf[:, :w0], 32 * w0),
            unpack_words_i8(buf[:, w0:], 32 * (buf.shape[1] - w0)),
        )

    def _tile_any_port(self, d0: int) -> torch.Tensor:
        sel_ing_t, eg_by_pol_t = self._fetch(d0)
        # ing_allow[s, d_t] = ∨_p ing_by_pol[p, s] ∧ sel_ing[p, d_t]
        # eg_allow[s, d_t] = ∨_p sel_eg[p, s] ∧ eg_by_pol[p, d_t]
        ing_ok = bool_dot(self.src[0], sel_ing_t) > 0
        eg_ok = bool_dot(self.src[1], eg_by_pol_t) > 0
        if self.default_allow:
            ing_ok |= ~self.ing_iso_full[None, d0 : d0 + self.tile]
            eg_ok |= ~self.eg_iso_loc[:, None]
        return ing_ok & eg_ok

    def _tile_ports(self, d0: int) -> torch.Tensor:
        """The mask-group port conjunction over one dst tile (the sharded
        form of ``_tiled_ports_step``'s tile body)."""
        from ..ops.tiled_ports import _mask_group_conj

        sel_ing_t, vpe_t = self._fetch(d0)
        bank_t = self.bank8[:, d0 : d0 + self.tile].t()  # [T, B]

        def ing_dot(start: int, length: int) -> torch.Tensor:
            sl = slice(start, start + length)
            b = sel_ing_t[:, self.vp_pol_i[sl]] * bank_t[:, self.vp_res_i[sl]]
            return bool_dot(self.src_i[start], b) > 0

        def eg_dot(start: int, length: int) -> torch.Tensor:
            return bool_dot(self.src_e[start], vpe_t[:, start : start + length]) > 0

        false_t = torch.zeros((self.n_loc, self.tile), dtype=torch.bool, device=bank_t.device)
        conj, gi_any, ge_any = _mask_group_conj(self.layout, ing_dot, eg_dot, false_t)
        r = conj
        if self.default_allow:
            # reach = (DI∧DE) ∨ (DI∧GE_any) ∨ (DE∧GI_any) ∨ (∃q: GI_q∧GE_q)
            di = ~self.ing_iso_full[None, d0 : d0 + self.tile]
            de = ~self.eg_iso_loc[:, None]
            r = r | (di & de) | (di & ge_any) | (de & gi_any)
        return r

    def sweep(self, t0: int, tiles_per_dev: int):
        """Tiles ``t0 + k·mp + g`` for ``k < tiles_per_dev`` on grant
        member ``g``; returns the rank's packed block (or ``None``) and its
        aggregate partials, each summed over the ranks that hold parts of it."""
        mesh = self.mesh
        mp = mesh.shape[GRANT_AXIS]
        my_grant = mesh.coords[GRANT_AXIS]
        dev = mesh.device
        T, n_loc = self.tile, self.n_loc
        out = (
            torch.zeros((n_loc, self.n_total // 32), dtype=_I32, device=dev)
            if self.keep_matrix else None
        )
        row_deg = torch.zeros(n_loc, dtype=_I32, device=dev)
        col_deg = torch.zeros(self.n_total, dtype=_I32, device=dev)
        grp_deg = (
            torch.zeros((self.grp8.shape[0], self.n_total), dtype=_I32, device=dev)
            if self.grp8 is not None else None
        )
        tile_reach = self._tile_any_port if self.layout is None else self._tile_ports
        for k in range(tiles_per_dev):
            d0 = (t0 + k * mp + my_grant) * T
            r = tile_reach(d0)
            if self.self_traffic and self.row0 < d0 + T and d0 < self.row0 + n_loc:
                # global src i == dst j: the block's diagonal at offset
                # row0 - d0 (a view; no host sync, unlike an index write)
                r.diagonal(self.row0 - d0).fill_(True)
            r &= self.valid[:, None] & self.valid_full[None, d0 : d0 + T]
            row_deg += r.sum(dim=1, dtype=_I32)
            col_deg[d0 : d0 + T] += r.sum(dim=0, dtype=_I32)
            if grp_deg is not None:
                # per-group column counts: a [U, n_loc] × [n_loc, T] int8
                # product, so user_crosscheck answers without the matrix
                grp_deg[:, d0 : d0 + T] += bool_dot(self.grp8, r.t().to(_I8).contiguous())
            if out is not None:
                out[:, d0 // 32 : (d0 + T) // 32] = pack_bool_cols(r)
        # grant members covered disjoint tiles: the sum is the bitwise OR
        # for the words and a plain add for the aggregates
        if out is not None:
            psum(mesh, out, GRANT_AXIS)
        psum(mesh, row_deg, GRANT_AXIS)
        psum(mesh, col_deg, BOTH)
        if grp_deg is not None:
            psum(mesh, grp_deg, BOTH)
        return out, row_deg, col_deg, grp_deg


def _pod_major(x: torch.Tensor) -> torch.Tensor:
    """int8 [R, n_loc] → [n_loc, R'] contiguous, R' = R rounded up to 32 with
    zero columns (a K-contiguous ``bool_dot`` operand matching the
    broadcast tiles' width)."""
    return F.pad(x.t(), (0, (-x.shape[0]) % 32)).contiguous()


def _pack_pod_major(x: torch.Tensor) -> torch.Tensor:
    """bool/int8 [R, n_loc] → int32 [n_loc, ⌈R/32⌉]: each pod's row of ``x``
    packed along ``R`` (bit j of word w is row 32·w + j)."""
    return pack_bool_cols(F.pad((x > 0).t(), (0, (-x.shape[0]) % 32)))


def _host_global(mesh: Mesh, x: torch.Tensor) -> np.ndarray:
    """A ``P(POD_AXIS)``-sharded result gathered over ``pods``, on the host."""
    return all_gather(mesh, x, POD_AXIS, dim=0).cpu().numpy()


def _sync(mesh: Mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def sharded_packed_reach(
    mesh: Mesh,
    enc: EncodedCluster,
    *,
    self_traffic: bool = True,
    default_allow_unselected: bool = True,
    direction_aware_isolation: bool = True,
    tile: int = 512,
    chunk: int = 1024,
    stripe: Optional[Tuple[int, int]] = None,
    keep_matrix: Optional[bool] = None,
    groups: Optional[np.ndarray] = None,
    max_port_masks: Optional[int] = None,
    sweep_chunk_tiles: Optional[int] = None,
) -> PackedShardedResult:
    """Pad, slice, sweep, on every rank of ``mesh`` (each calls it with the
    same encoding and gets the same result). ``stripe=(t0, t1)`` limits the
    sweep to a dst tile range (default: all tiles); aggregates then cover
    only the swept dsts. ``keep_matrix=None`` keeps the packed matrix when
    it is ≤ 1 GiB per rank. ``groups`` (int [N] user-group ids) additionally
    aggregates per-group in-degrees so ``user_crosscheck`` works without the
    matrix.

    ``sweep_chunk_tiles=k`` runs the FULL dst sweep as a sequence of k-tile
    stripes (aggregate-only — the matrix is never kept), over operands
    built once, with per-chunk times in ``timings``.

    A multi-atom encoding (``compute_ports=True`` with port-bearing rules)
    runs the port-bitmap sweep (the mask-group decomposition of
    ``ops/tiled_ports.py`` composed with the dst-tile broadcast);
    ``max_port_masks`` caps its distinct ported masks (default 128).

    ``timings`` splits the call's seconds (``solve``) into the host
    ``prologue`` (padding, port layout), the rank's ``maps``, the ``sweep``
    and the ``fetch`` of the results to the host, each ended by a device
    sync."""
    from ..ops.tiled_ports import (
        _MAX_PORT_MASKS,
        _PORT_SLAB_BUDGET,
        VPArrays,
        _build_port_layout,
        _split_and_check_port_masks,
    )

    dp = mesh.shape[POD_AXIS]
    mp = mesh.shape[GRANT_AXIS]
    n = enc.n_pods
    if tile < 32 or tile % 32:
        # never silently change the caller's tile/stripe geometry
        raise ConfigError(f"tile must be a positive multiple of 32, got {tile}")
    t_start = time.perf_counter()
    with_ports = len(enc.atoms) > 1
    ing_block, eg_block = enc.ingress, enc.egress
    if with_ports:
        ing_block, eg_block, R = _split_and_check_port_masks(
            ing_block, eg_block,
            _MAX_PORT_MASKS if max_port_masks is None else max_port_masks,
        )
        # per-tile memory: the sweep holds ~R ported egress planes of
        # [n_loc, tile] bools at once; an over-budget geometry is an error
        n_loc_est = -(-max(n, 1) // dp)
        if R * n_loc_est * tile > _PORT_SLAB_BUDGET:
            cap = max(32, (_PORT_SLAB_BUDGET // max(R * n_loc_est, 1)) // 32 * 32)
            raise ConfigError(
                f"port path holds ~{R} bool slabs of [{n_loc_est}, {tile}] "
                f"per tile step (~{R * n_loc_est * tile / 1e9:.1f} GB), over "
                f"the {_PORT_SLAB_BUDGET / 1e9:.1f} GB budget — pass "
                f"tile<={cap}, or verify with compute_ports=False."
            )
    # n_loc must be a multiple of the dst tile so every tile has one owner,
    # and the total tile count a multiple of mp for the round-robin sweep
    block = tile * max(1, math.ceil(max(n, 1) / (dp * tile)))
    while (block * dp // tile) % mp:
        block += tile
    Np = block * dp
    n_pad = Np - n
    pod_kv, pod_key, pod_ns = pad_pods(enc.pod_kv, enc.pod_key, enc.pod_ns, n_pad)
    valid = np.arange(Np) < n
    if groups is not None:
        groups = np.asarray(groups)
        if groups.shape != (n,):
            raise ConfigError(f"groups must be int [{n}], got {groups.shape}")
        n_groups = int(groups.max()) + 1 if n else 1
        # one-hot over src rows; pad pods stay all-zero (no group)
        grp8 = np.zeros((n_groups, Np), dtype=np.int8)
        grp8[groups, np.arange(n)] = 1
    else:
        grp8 = None
    # grant axis padded to an (mp · chunk) multiple: each rank's slice is an
    # exact number of peer-sweep chunks
    P_pol = enc.n_policies
    ingress = pad_grants(ing_block, pad_amount(ing_block.n, mp * chunk), P_pol, n_pad)
    egress = pad_grants(eg_block, pad_amount(eg_block.n, mp * chunk), P_pol, n_pad)
    layout = vp = None
    if with_ports:
        # virtual policies built AFTER grant padding (pad rows carry empty
        # masks → the sink VP row), so the slot arrays align with the grants
        layout, pol_i, res_i, slot_i, pol_e, res_e, slot_e, _ = _build_port_layout(
            ingress.ports, egress.ports, ingress.pol, egress.pol, sink_pol=P_pol,
            ing_restrict=ingress.dst_restrict, eg_restrict=egress.dst_restrict,
        )
        if enc.restrict_bank is not None:
            bank8 = np.zeros((enc.restrict_bank.shape[0], Np), dtype=np.int8)
            bank8[:, :n] = enc.restrict_bank
        else:
            bank8 = np.ones((1, Np), dtype=np.int8)
        vp = VPArrays(pol_i, res_i, slot_i, pol_e, res_e, slot_e, bank8)
        # per-rank resident VP operands: fail fast instead of a device OOM
        resident = (len(pol_i) + 2 * len(pol_e)) * (Np // dp)
        if resident > int(12e9):
            raise ConfigError(
                f"port path needs ~{resident / 1e9:.1f} GB/rank of resident "
                f"virtual-policy operands ({len(pol_i)}+{len(pol_e)} VP rows × "
                f"{Np // dp} local pods); shrink the distinct (policy, "
                "port-mask) combinations or verify with compute_ports=False."
            )

    n_tiles_total = Np // tile
    if sweep_chunk_tiles is not None and stripe is not None:
        raise ConfigError("sweep_chunk_tiles sweeps ALL tiles; drop stripe")
    if stripe is None:
        stripe = (0, n_tiles_total)
    t0, t1 = stripe
    if not (0 <= t0 < t1 <= n_tiles_total):
        raise ConfigError(f"stripe {stripe} outside [0, {n_tiles_total})")
    if (t1 - t0) % mp:
        raise ConfigError(f"stripe width {t1 - t0} not a multiple of mp={mp}")
    full_sweep = (t0, t1) == (0, n_tiles_total)
    if sweep_chunk_tiles is not None:
        if keep_matrix:
            raise ConfigError("sweep_chunk_tiles is aggregate-only; it cannot keep the matrix")
        if sweep_chunk_tiles % mp:
            raise ConfigError(f"sweep_chunk_tiles must be a multiple of mp={mp}")
        keep_matrix = False
    elif keep_matrix is None:
        # a partial stripe would leave unswept words zero — only aggregates
        # are meaningful there, so never auto-keep a partial matrix
        keep_matrix = full_sweep and Np * (Np // 32) * 4 // dp <= (1 << 30)

    t_host = time.perf_counter()
    local = _Local(
        mesh,
        dict(
            pod_kv=pod_kv, pod_key=pod_key, pod_ns=pod_ns, valid=valid, grp8=grp8,
            ns_kv=enc.ns_kv, ns_key=enc.ns_key, pol_sel=enc.pol_sel, pol_ns=enc.pol_ns,
            aff_ing=enc.pol_affects_ingress, aff_eg=enc.pol_affects_egress,
            ingress=ingress, egress=egress, vp=vp,
        ),
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
        direction_aware_isolation=direction_aware_isolation,
        chunk=chunk,
        tile=tile,
        n_total=Np,
        keep_matrix=keep_matrix,
        layout=layout,
        want_groups=groups is not None,
    )
    ing_iso = _host_global(mesh, local.ing_iso_loc & local.valid)[:n]
    eg_iso = _host_global(mesh, local.eg_iso_loc & local.valid)[:n]
    t_maps = time.perf_counter()  # the isolation fetch waited for the maps
    # seconds of the host prologue (padding, port layout) and the rank's maps
    split = {"prologue": t_host - t_start, "maps": t_maps - t_host}

    if sweep_chunk_tiles is not None:
        # the full sweep in equal-width stripes (+ a remainder) over the
        # operands built once; aggregates accumulate on the host in int64
        acc_row = np.zeros(Np, dtype=np.int64)
        acc_col = np.zeros(Np, dtype=np.int64)
        acc_grp = np.zeros((grp8.shape[0], Np), dtype=np.int64) if grp8 is not None else None
        chunk_times: List[float] = []
        # the JAX package's publish site: the sweep has no cost function of
        # its own (its int8 products publish theirs through bool_dot)
        maybe_publish("sharded-packed", "packed_sweep", None, (enc, sweep_chunk_tiles))
        for s0 in range(0, n_tiles_total, sweep_chunk_tiles):
            c0 = time.perf_counter()
            width = min(sweep_chunk_tiles, n_tiles_total - s0)
            _, row_deg, col_deg, grp_deg = local.sweep(s0, width // mp)
            acc_row += _host_global(mesh, row_deg)
            acc_col += col_deg.cpu().numpy()
            if acc_grp is not None:
                acc_grp += grp_deg.cpu().numpy()
            chunk_times.append(time.perf_counter() - c0)
        ct = sorted(chunk_times)
        return PackedShardedResult(
            n_pods=n,
            total_pairs=int(acc_row[:n].sum()),
            out_degree=acc_row[:n],
            in_degree=acc_col[:n],
            ingress_isolated=ing_iso,
            egress_isolated=eg_iso,
            full_sweep=True,
            packed=None,
            groups=groups,
            group_in_degree=acc_grp[:, :n] if acc_grp is not None else None,
            timings={
                "solve": time.perf_counter() - t_start,
                **split,
                "sweep": time.perf_counter() - t_maps,
                "tiles": n_tiles_total,
                "n_chunks": len(chunk_times),
                "chunk_s_min": ct[0],
                "chunk_s_median": ct[len(ct) // 2],
                "chunk_s_max": ct[-1],
            },
        )
    maybe_publish("sharded-packed", "packed_stripe", None, (enc, t1 - t0))
    packed, row_deg, col_deg, grp_deg = local.sweep(t0, (t1 - t0) // mp)
    del local
    _sync(mesh)
    t_sweep = time.perf_counter()
    row_deg = _host_global(mesh, row_deg)[:n].astype(np.int64)
    col_deg = col_deg.cpu().numpy()[:n].astype(np.int64)
    words = None
    if keep_matrix:
        words = _host_global(mesh, packed)[:n].view(np.uint32)
    t_end = time.perf_counter()
    return PackedShardedResult(
        n_pods=n,
        total_pairs=int(row_deg.sum()),
        out_degree=row_deg,
        in_degree=col_deg,
        ingress_isolated=ing_iso,
        egress_isolated=eg_iso,
        full_sweep=full_sweep,
        packed=words,
        groups=groups,
        group_in_degree=(
            grp_deg.cpu().numpy()[:, :n].astype(np.int64) if grp_deg is not None else None
        ),
        timings={
            "solve": t_end - t_start, **split, "sweep": t_sweep - t_maps,
            "fetch": t_end - t_sweep, "stripe": (t0, t1), "tiles": n_tiles_total,
        },
    )
