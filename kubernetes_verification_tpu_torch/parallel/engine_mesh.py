"""The serving engines' state on a ``(pods, grants)`` mesh: the SPMD half of
``PackedIncrementalVerifier(mesh=)`` and ``PackedPortsIncrementalVerifier(
mesh=)``.

The JAX engines place their state with ``NamedSharding`` and leave the
collectives to GSPMD (``packed_incremental.py:973-995``,
``packed_incremental_ports.py:116-131``). Here every rank holds only its
shard, in the JAX layout, and every op runs SPMD with explicit collectives
(``parallel/mesh.py``): every rank calls it with the same arguments and
keeps the host bookkeeping replicated.

* the maps: pod-major blocks, their pods over ``pods`` (``pb = Np/dp`` rows
  from ``p0``) and their slots (any-port) or virtual-policy rows (port
  bitmaps) over ``grants``;
* the isolation counts and the row validity: over ``pods``;
* the packed words ``[Np, W]``: their rows over ``pods``;
* the column mask: replicated (the host's ``_col_valid``).

One rule keeps the result equal to GSPMD's: a block is contracted on the
local slot shard with ``bool_dot``, the int32 partial counts are summed over
``grants`` (``psum_counts``), and only then thresholded, OR-ed with
default-allow and packed. Packed words are never OR-ed across ranks (no
collective has a bitwise OR). A block's source or destination rows that
live on other pod ranks arrive by ``gather_rows``; a row block's columns,
computed on each pod rank's own pods, by an ``all_gather`` over ``pods``.
A dst range is swept in sub-stripes of at most ``_BLOCK_CELLS`` int32 counts
on the local rows, so a stripe or the build never allocates ``[pb, Np]``.

The build computes the maps whole on each rank (the one-device build) and
keeps its block; the closure of a mesh engine runs on each rank over the
gathered words (``ops/closure.py``), replicated.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.bits import pack_bool_cols
from ..resilience.errors import ConfigError
from .mesh import GRANT_AXIS, POD_AXIS, Mesh, all_gather, gather_rows, psum_counts

__all__ = ["AnyPortShards", "PortsShards"]

_I32 = torch.int32

#: the most int32 partial counts one block holds on a rank's rows (1 GiB):
#: a dst range is swept in sub-stripes of at most this many cells
_BLOCK_CELLS = 1 << 28


class _Shards:
    """Geometry and collectives of one engine's state on a mesh: this
    rank's pod block ``[p0, p0 + pb)`` and the named collectives over it."""

    def __init__(self, mesh: Mesh, n_padded: int):
        self.mesh = mesh
        self.dp = mesh.shape[POD_AXIS]
        self.mp = mesh.shape[GRANT_AXIS]
        self.device = mesh.device
        self.set_pods(n_padded)

    def set_pods(self, n_padded: int) -> None:
        if n_padded % (8 * self.dp):
            raise ConfigError(
                f"{n_padded} padded pods do not split into byte-aligned blocks "
                f"over a {self.dp}-way pod axis"
            )
        self.n_padded = n_padded
        self.pb = n_padded // self.dp
        self.p0 = self.mesh.coords[POD_AXIS] * self.pb
        self.pod_ids = torch.arange(self.p0, self.p0 + self.pb, device=self.device)

    @property
    def rows(self) -> slice:
        """This rank's block of a pod-indexed host array."""
        return slice(self.p0, self.p0 + self.pb)

    def own(self, ids):
        """``(pos, local)``: the positions in ``ids`` of the pods this rank
        holds, and their rows in its block (device index tensors)."""
        ids = np.asarray(ids, dtype=np.int64)
        pos = np.nonzero((ids >= self.p0) & (ids < self.p0 + self.pb))[0]
        dev = self.device
        return (torch.as_tensor(pos, device=dev),
                torch.as_tensor(ids[pos] - self.p0, device=dev))

    def gather(self, x: torch.Tensor, ids) -> torch.Tensor:
        """Rows ``ids`` (global pods) of a pod-sharded tensor, on every rank."""
        return gather_rows(self.mesh, x, ids, self.pb, POD_AXIS)

    def full(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """A pod-sharded tensor whole, on every rank."""
        return all_gather(self.mesh, x, POD_AXIS, dim=dim)

    def psum(self, *counts: torch.Tensor) -> None:
        psum_counts(self.mesh, *counts)

    def step(self) -> int:
        """Sub-stripe width of a dst sweep: a multiple of 32 that keeps a
        block's counts within ``_BLOCK_CELLS`` on this rank's rows."""
        return max(32, _BLOCK_CELLS // max(self.pb, 1) // 32 * 32)

    def regrid_pods(self, x: torch.Tensor, n_padded2: int, extra_cols: int = 0) -> torch.Tensor:
        """A pod-sharded tensor re-split over a grown pod axis (the shard
        layout JAX re-places a padded array onto): gathered, zero-padded to
        ``n_padded2`` rows (and ``extra_cols`` columns), and this rank's
        new block kept. Call ``set_pods(n_padded2)`` after every tensor."""
        whole = self.full(x)
        rows = n_padded2 - whole.shape[0]
        whole = F.pad(whole, (0, extra_cols, 0, rows) if x.dim() > 1 else (0, rows))
        pb2 = n_padded2 // self.dp
        p0 = self.mesh.coords[POD_AXIS] * pb2
        return whole[p0 : p0 + pb2].clone()

    def put_rows(self, x) -> torch.Tensor:
        """This rank's block of a pod-indexed host array, on the device."""
        return torch.tensor(np.asarray(x)[self.rows], device=self.device)

    def pack_rows(self, r: torch.Tensor) -> torch.Tensor:
        """bool [K, pb] blocks of a row block on every pod rank → int32
        [K, W]: the columns gathered over ``pods`` (as uint8), then packed."""
        return pack_bool_cols(self.full(r, dim=1))

    # the engine-specific halves: ``row_block(eng, ids, flags)`` (bool [K,
    # pb]: rows ``ids`` against this rank's pods) and ``col_block`` (bool
    # [pb, D]: this rank's pods against dst columns ``ids``)

    def patch_cols(self, eng, cols: np.ndarray, flags) -> None:
        """Dst columns ``cols`` re-derived on this rank's rows and folded
        into its words (``_patch_cols``)."""
        from ..packed_incremental import _fold_cols

        r = self.col_block(eng, cols, flags) & (eng._row_valid > 0)[:, None]
        _fold_cols(eng._packed, r, *eng._col_meta(cols))

    def pod_words(self, eng, idx: int, active: bool, flags) -> None:
        """The end of a pod step, once the pod's map rows are written: its
        validity bits, then (matrix kept) exactly its own packed row and its
        own bit-column against the new maps (``_pod_step``)."""
        from ..packed_incremental import _bit

        w, bit = idx // 32, _bit(idx % 32)
        eng._col_mask[w : w + 1] &= ~bit
        if active:
            eng._col_mask[w : w + 1] |= bit
        _, loc = self.own([idx])
        eng._row_valid[loc] = int(active)
        if eng._packed is None:
            return
        if active:
            eng._packed[loc] = self.pack_rows(self.row_block(eng, [idx], flags))[0] & eng._col_mask
        else:
            eng._packed[loc] = 0
        col = eng._packed[:, w] & ~bit
        if active:
            r_col = self.col_block(eng, [idx], flags)[:, 0]
            col |= (r_col & (eng._row_valid > 0)).to(_I32) * bit
        eng._packed[:, w] = col

    def stripe_local(self, eng, d0: int, width: int, flags, out=None) -> torch.Tensor:
        """This rank's rows of dst columns ``[d0, d0 + width)``, int32 [pb,
        width/32] (or written into ``out``'s words), in sub-stripes."""
        if out is None:
            out = torch.empty((self.pb, width // 32), dtype=_I32, device=self.device)
            w0 = d0 // 32
        else:
            w0 = 0
        valid = (eng._row_valid > 0)[:, None]
        step = self.step()
        for a in range(d0, d0 + width, step):
            b = min(a + step, d0 + width)
            r = self.col_block(eng, np.arange(a, b), flags) & valid
            out[:, a // 32 - w0 : b // 32 - w0] = (
                pack_bool_cols(r) & eng._col_mask[None, a // 32 : b // 32])
        return out

    def build_packed(self, eng, flags) -> torch.Tensor:
        """The words of the maps, this rank's rows: the dst axis swept in
        sub-stripes of ``bool_dot`` products (no kernel launch on a
        mesh)."""
        out = torch.zeros((self.pb, self.n_padded // 32), dtype=_I32, device=self.device)
        return self.stripe_local(eng, 0, self.n_padded, flags, out=out)


class AnyPortShards(_Shards):
    """The any-port engine's shard: maps int8 ``[pb, cb]`` (slots ``[c0, c0 +
    cb)`` of ``C``), counts int32 ``[pb]``, row validity int8 ``[pb]``,
    words int32 ``[pb, W]``."""

    def __init__(self, mesh: Mesh, n_padded: int, capacity: int):
        super().__init__(mesh, n_padded)
        self.set_slots(capacity)

    def set_slots(self, capacity: int) -> None:
        if capacity % self.mp:
            raise ConfigError(
                f"{capacity} slots do not split over a {self.mp}-way grant axis"
            )
        self.cb = capacity // self.mp
        self.c0 = self.mesh.coords[GRANT_AXIS] * self.cb

    def local_slot(self, slot: int):
        """The slot's column in this rank's maps, or None."""
        lc = slot - self.c0
        return lc if 0 <= lc < self.cb else None

    # ------------------------------------------------------------ blocks
    def _block(self, src, dst, src_ids, dst_ids, flags) -> torch.Tensor:
        from ..packed_incremental import _reach_block

        (ing_by_pol_s, sel_eg_s, eg_cnt_s), (sel_ing_d, eg_by_pol_d, ing_cnt_d) = src, dst
        return _reach_block(
            ing_by_pol_s, sel_ing_d, sel_eg_s, eg_by_pol_d, ing_cnt_d, eg_cnt_s,
            src_ids, dst_ids, reduce=self.psum, **flags,
        )

    def row_block(self, eng, ids, flags) -> torch.Tensor:
        """bool [K, pb]: rows ``ids`` against this rank's pods."""
        src = tuple(self.gather(t, ids) for t in (eng._ing_by_pol, eng._sel_eg8, eng._eg_cnt))
        dst = (eng._sel_ing8, eng._eg_by_pol, eng._ing_cnt)
        ids_t = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)
        return self._block(src, dst, ids_t, self.pod_ids, flags)

    def col_block(self, eng, ids, flags) -> torch.Tensor:
        """bool [pb, D]: this rank's pods against dst columns ``ids``."""
        src = (eng._ing_by_pol, eng._sel_eg8, eng._eg_cnt)
        dst = tuple(self.gather(t, ids) for t in (eng._sel_ing8, eng._eg_by_pol, eng._ing_cnt))
        ids_t = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)
        return self._block(src, dst, self.pod_ids, ids_t, flags)

    # ------------------------------------------------------------ diffs
    def slot_write(self, eng, slot: int, new4: np.ndarray) -> None:
        """``_slot_write`` on the shard: the slot's owner writes its column
        of the four maps; the count deltas (new minus the device's old
        column) are summed over ``grants`` so every rank applies them."""
        loc = torch.as_tensor(np.ascontiguousarray(new4[:, self.rows]), device=self.device)
        delta = torch.zeros((2, self.pb), dtype=_I32, device=self.device)
        lc = self.local_slot(slot)
        if lc is not None:
            delta[0] = loc[0].to(_I32) - eng._sel_ing8[:, lc].to(_I32)
            delta[1] = loc[1].to(_I32) - eng._sel_eg8[:, lc].to(_I32)
        self.psum(delta)
        eng._ing_cnt += delta[0]
        eng._eg_cnt += delta[1]
        if lc is not None:
            for m, v in zip(eng._maps[:4], loc):
                m[:, lc] = v

    def patch_rows(self, eng, rows: np.ndarray, flags) -> None:
        words = self.pack_rows(self.row_block(eng, rows, flags)) & eng._col_mask[None, :]
        pos, loc = self.own(rows)
        eng._packed[loc] = words[pos]

    def write_pod_rows(self, eng, idxs, cols4: np.ndarray) -> None:
        """Pods ``idxs``' rows of every map (``cols4`` int8 [4, G, C]) and
        their isolation counts, on the ranks that hold them."""
        pos, loc = self.own(idxs)
        if not loc.numel():
            return
        p = pos.cpu().numpy()
        vals = torch.as_tensor(
            np.ascontiguousarray(cols4[:, p, self.c0 : self.c0 + self.cb]), device=self.device)
        for m, v in zip(eng._maps[:4], vals):
            m[loc] = v
        cnt = torch.as_tensor(cols4[:2, p].sum(axis=2, dtype=np.int32), device=self.device)
        eng._ing_cnt[loc] = cnt[0]
        eng._eg_cnt[loc] = cnt[1]

    def pod_step(self, eng, idx: int, cols4: np.ndarray, active: bool, flags) -> None:
        """``_pod_step`` (or ``_pod_step_mf`` matrix-free) on the shard."""
        self.write_pod_rows(eng, [idx], cols4[:, None, :])
        self.pod_words(eng, idx, active, flags)

    # ------------------------------------------------------------ solves
    def stripe(self, eng, d0: int, width: int, flags) -> torch.Tensor:
        """int32 [Np, width/32] on every rank."""
        return self.full(self.stripe_local(eng, d0, width, flags))

    def solve_rows(self, eng, rows: np.ndarray, flags) -> torch.Tensor:
        """int32 [K, W] on every rank: ``_rows_step``."""
        rv = self.gather(eng._row_valid, rows)
        r = self.row_block(eng, rows, flags) & (rv > 0)[:, None]
        return self.pack_rows(r) & eng._col_mask[None, :]

    # ------------------------------------------------------------ growth
    def grow_slots(self, eng, extra: int) -> None:
        """The slot axis grown by ``extra`` zero slots and re-split over
        ``grants`` (a grown slot lands on the rank JAX re-places it on)."""
        maps = []
        for m in eng._maps[:4]:
            whole = F.pad(all_gather(self.mesh, m, GRANT_AXIS, dim=1), (0, extra))
            maps.append(whole)
        self.set_slots(maps[0].shape[1])
        sl = slice(self.c0, self.c0 + self.cb)
        (eng._sel_ing8, eng._sel_eg8, eng._ing_by_pol, eng._eg_by_pol) = (
            m[:, sl].contiguous() for m in maps)

    def grow_pods(self, eng, n_padded2: int) -> None:
        """Every pod-sharded tensor re-split over the grown pod axis."""
        grow_w = (n_padded2 - self.n_padded) // 32
        eng._sel_ing8, eng._sel_eg8, eng._ing_by_pol, eng._eg_by_pol = (
            self.regrid_pods(m, n_padded2) for m in eng._maps[:4])
        eng._ing_cnt = self.regrid_pods(eng._ing_cnt, n_padded2)
        eng._eg_cnt = self.regrid_pods(eng._eg_cnt, n_padded2)
        if eng._packed is not None:
            eng._packed = self.regrid_pods(eng._packed, n_padded2, extra_cols=grow_w)
        self.set_pods(n_padded2)

    # ------------------------------------------------------------ state
    def gather_map(self, m: torch.Tensor) -> np.ndarray:
        """A map shard → the JAX state's uint8 [C, Np/8] (pods bit-packed)."""
        from ..packed_incremental import _pack_pod_axis

        packed = all_gather(self.mesh, _pack_pod_axis(m), POD_AXIS, dim=1)
        return all_gather(self.mesh, packed, GRANT_AXIS, dim=0).cpu().numpy()

    def load_map(self, packed: np.ndarray) -> torch.Tensor:
        """The JAX state's uint8 [C, Np/8] → this rank's int8 [pb, cb]."""
        from ..packed_incremental import _unpack_pod_axis

        block = packed[self.c0 : self.c0 + self.cb, self.p0 // 8 : (self.p0 + self.pb) // 8]
        return _unpack_pod_axis(block, self.pb, self.device)


class PortsShards(_Shards):
    """The port-bitmap engine's shard. Each direction's VP axis (JAX's rows,
    padded to a multiple of ``mp`` with inert rows after the sink row) is
    split over ``grants`` in contiguous blocks of ``tb[d]`` rows; this rank
    holds, per segment, the part of the segment inside its block
    (``part[d][m] = (offset in the segment, length)``, possibly empty) as
    pod-major int8 ``[pb, length]`` tensors."""

    def __init__(self, mesh: Mesh, n_padded: int, segments: Dict[str, list],
                 total_rows: Dict[str, int]):
        super().__init__(mesh, n_padded)
        g = mesh.coords[GRANT_AXIS]
        self.part: Dict[str, List[tuple]] = {}
        self.tb: Dict[str, int] = {}
        for d, spans in segments.items():
            tb = -(-total_rows[d] // self.mp)  # the padded axis over mp
            lo_g, hi_g = g * tb, (g + 1) * tb
            self.tb[d] = tb
            self.part[d] = [
                (max(s, lo_g) - s, max(0, min(s + l, hi_g) - max(s, lo_g)))
                for s, l in spans
            ]

    def local_row(self, d: str, m: int, off: int):
        """Offset ``off`` of segment ``m`` in this rank's part of it, or None."""
        lo, ln = self.part[d][m]
        return off - lo if lo <= off < lo + ln else None

    def slice_segments(self, d: str, segs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Full-segment pod-major tensors (this rank's pods) → its parts."""
        return [t[:, lo : lo + ln].contiguous() for t, (lo, ln) in zip(segs, self.part[d])]

    def _block(self, eng, src, dst, src_ids, dst_ids, flags) -> torch.Tensor:
        """Port reach of a (src × dst) block from ``(segments, counts)``
        operands: ``segments[d][m]`` [S, l] / [D, l] local segment parts.
        Each segment's counts are summed over ``grants`` before the
        mask-group combine (a grant boundary may cut a segment in two)."""
        from ..packed_incremental_ports import _ports_block

        (src_segs, eg_cnt_s), (dst_segs, ing_cnt_d) = src, dst
        return _ports_block(
            src_segs, dst_segs, eng._layout, ing_cnt_d, eg_cnt_s, src_ids, dst_ids,
            reduce=self.psum, **flags,
        )

    def _rows(self, side: Dict[str, List[torch.Tensor]], cnt, ids):
        return {d: [self.gather(t, ids) for t in side[d]] for d in side}, self.gather(cnt, ids)

    def row_block(self, eng, ids, flags) -> torch.Tensor:
        """bool [K, pb]: rows ``ids`` against this rank's pods."""
        src = self._rows(eng._src, eng._eg_cnt, ids)
        ids_t = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)
        return self._block(eng, src, (eng._dst, eng._ing_cnt), ids_t, self.pod_ids, flags)

    def col_block(self, eng, ids, flags) -> torch.Tensor:
        """bool [pb, D]: this rank's pods against dst columns ``ids``."""
        dst = self._rows(eng._dst, eng._ing_cnt, ids)
        ids_t = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=self.device)
        return self._block(eng, (eng._src, eng._eg_cnt), dst, self.pod_ids, ids_t, flags)

    def patch_rows(self, eng, rows: np.ndarray, flags) -> None:
        rv = self.gather(eng._row_valid, rows)
        r = self.row_block(eng, rows, flags) & (rv > 0)[:, None]
        words = self.pack_rows(r) & eng._col_mask[None, :]
        pos, loc = self.own(rows)
        eng._packed[loc] = words[pos]

    def vp_write(self, eng, locs: dict, vals: Dict[str, np.ndarray], d_ing, d_eg) -> None:
        """``_vp_write`` on the shard: each touched VP row is written by the
        grant rank that holds it, on its pods; the count deltas (host,
        replicated) land on every rank."""
        for d, loc in locs.items():
            v = None
            for j, (m, off) in enumerate(loc):
                lo = self.local_row(d, m, off)
                if lo is None:
                    continue
                if v is None:
                    v = torch.as_tensor(
                        np.ascontiguousarray(vals[d][:, :, self.rows]), device=self.device)
                eng._src[d][m][:, lo] = v[0, j]
                eng._dst[d][m][:, lo] = v[1, j]
        eng._ing_cnt += torch.as_tensor(d_ing[self.rows], device=self.device)
        eng._eg_cnt += torch.as_tensor(d_eg[self.rows], device=self.device)

    def write_pod_rows(self, eng, idxs, ci: np.ndarray, ce: np.ndarray, cnt_i, cnt_e) -> None:
        """Pods ``idxs``' columns of the four VP maps (``ci``/``ce`` int8 [2,
        T, G], JAX's rows) and their counts, on the ranks that hold them."""
        pos, loc = self.own(idxs)
        if not loc.numel():
            return
        p = pos.cpu().numpy()
        spans = eng._seg_spans
        for d, c in (("i", ci), ("e", ce)):
            for m, (s, _l) in enumerate(spans[d]):
                lo, ln = self.part[d][m]
                if not ln:
                    continue
                v = torch.as_tensor(
                    np.ascontiguousarray(c[:, s + lo : s + lo + ln][:, :, p].transpose(0, 2, 1)),
                    device=self.device)
                eng._src[d][m][loc] = v[0]
                eng._dst[d][m][loc] = v[1]
        eng._ing_cnt[loc] = torch.as_tensor(np.asarray(cnt_i, dtype=np.int32)[p], device=self.device)
        eng._eg_cnt[loc] = torch.as_tensor(np.asarray(cnt_e, dtype=np.int32)[p], device=self.device)

    def pod_step(self, eng, idx: int, ci, ce, cnt_i: int, cnt_e: int, active: bool, flags) -> None:
        """``_ports_pod_step`` on the shard."""
        self.write_pod_rows(eng, [idx], ci[..., None], ce[..., None], [cnt_i], [cnt_e])
        self.pod_words(eng, idx, active, flags)

    def grow_pods(self, eng, n_padded2: int) -> None:
        grow_w = (n_padded2 - self.n_padded) // 32
        for side in (eng._src, eng._dst):
            for d in side:
                side[d] = [self.regrid_pods(t, n_padded2) for t in side[d]]
        eng._ing_cnt = self.regrid_pods(eng._ing_cnt, n_padded2)
        eng._eg_cnt = self.regrid_pods(eng._eg_cnt, n_padded2)
        eng._packed = self.regrid_pods(eng._packed, n_padded2, extra_cols=grow_w)
        self.set_pods(n_padded2)

    def gather_segments(self, d: str, segs: List[torch.Tensor], spans, total: int) -> np.ndarray:
        """A direction's segment parts → the JAX state's uint8 [T, Np/8]:
        each rank's parts packed along pods, gathered over ``pods``, then
        over ``grants`` as its block of the padded VP axis (zero rows where
        it holds none: the sink and pad rows), trimmed to ``total`` rows."""
        from ..packed_incremental import _pack_pod_axis

        tb = self.tb[d]
        g = self.mesh.coords[GRANT_AXIS]
        block = torch.zeros((tb, self.pb // 8), dtype=torch.uint8, device=self.device)
        for t, (s, _l), (lo, ln) in zip(segs, spans, self.part[d]):
            if ln:
                r0 = s + lo - g * tb
                block[r0 : r0 + ln] = _pack_pod_axis(t)
        block = all_gather(self.mesh, block, POD_AXIS, dim=1)
        return all_gather(self.mesh, block, GRANT_AXIS, dim=0)[:total].cpu().numpy()

    def load_segments(self, d: str, packed: np.ndarray, spans) -> List[torch.Tensor]:
        """The JAX state's uint8 [T, Np/8] → this rank's segment parts."""
        from ..packed_incremental import _unpack_pod_axis

        cols = slice(self.p0 // 8, (self.p0 + self.pb) // 8)
        return [
            _unpack_pod_axis(packed[s + lo : s + lo + ln, cols], self.pb, self.device)
            for (s, _l), (lo, ln) in zip(spans, self.part[d])
        ]
