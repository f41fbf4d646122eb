"""Batched reachability probes: one call for a whole query batch.

The port of ``kubernetes_verification_tpu.ops.batched``, in three families:

* the **dense** twins (``batched_reach_rows`` / ``batched_reach_cols`` /
  ``batched_any_port``) gather the reach rows (or columns) of a batch's
  distinct sources (or destinations) straight from the dense
  ``IncrementalVerifier``'s count matrices, and answer every any-port probe
  with one gather on the result. The formula is ``incremental._derive_reach``
  restricted to the gathered indices, so the answers equal the matching rows
  of ``reach``::

      ing_ok[s, j] = ing_count[s, j] > 0   (| ing_iso[j] == 0   under default-allow)
      eg_ok [s, j] = eg_count [s, j] > 0   (| eg_iso [s] == 0   under default-allow)
      row   [s, j] = ing_ok & eg_ok        (| s == j            under self-traffic)

* the **stripe** twins (``stripe_*``) apply the same formulas to a [S, N]
  row stripe of the count matrices whose first global row is ``row_base``,
  with the stripe's local [S] slice of the egress isolation vector (the
  stripe engine of the serving plane holds no [N, N] matrix);
* the **packed** twins (``packed_*``) re-solve packed reach rows (or bool
  columns) straight from the ``PackedIncrementalVerifier``'s per-policy maps,
  through the engine's own ``_rows_step`` / ``_reach_block``, so no [N, N]
  operand of any dtype appears and the path works on a matrix-free engine.
  Their map arguments are the engine's state in its ``_maps`` order
  (``sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt``) followed by
  ``col_mask`` and ``row_valid``: this package's engine holds the maps
  pod-major, int8 [Np, C] (the JAX engine's are [C, Np]).

Isolation vectors may be host arrays or int32 tensors already on the counts'
device (``ops/device_state.py``), which pass through without a copy. Index
batches are not padded to a power of two as in the JAX package (``_pow2``,
``_pad_idx``): eager torch compiles nothing per shape, and the results are
the same. Every function returns host numpy arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..packed_incremental import _reach_block, _rows_step
from ..observe.metrics import QUERY_PACKED_DISPATCHES_TOTAL
from .bits import to_host_words

__all__ = [
    "batched_reach_rows",
    "batched_reach_cols",
    "batched_any_port",
    "packed_reach_rows",
    "packed_reach_cols",
    "packed_any_port",
    "stripe_reach_rows",
    "stripe_reach_cols",
    "stripe_any_port",
]


def _idx(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


def _as_iso(vec, device) -> torch.Tensor:
    """Isolation vector → int32 tensor on ``device``. An int32 tensor there
    (the generation-keyed state of ``ops/device_state.py``) passes through
    untouched; a host array is copied once."""
    if isinstance(vec, torch.Tensor) and vec.dtype == torch.int32 and vec.device == device:
        return vec
    return torch.as_tensor(np.asarray(vec, dtype=np.int32), device=device)


# ---------------------------------------------------------------- dense


def _reach_rows_kernel(
    ing_count, eg_count, ing_iso, eg_iso, src_idx, *,
    self_traffic: bool, default_allow_unselected: bool,
) -> torch.Tensor:
    """Reach rows for the sources in ``src_idx`` — ``_derive_reach`` sliced
    to bool [U, N] without materialising the full matrix."""
    ing_ok = ing_count[src_idx] > 0
    eg_ok = eg_count[src_idx] > 0
    if default_allow_unselected:
        ing_ok |= (ing_iso == 0)[None, :]
        eg_ok |= (eg_iso[src_idx] == 0)[:, None]
    rows = ing_ok & eg_ok
    if self_traffic:
        n = ing_count.shape[1]
        rows |= src_idx[:, None] == torch.arange(n, device=src_idx.device)[None, :]
    return rows


def _probe_rows_kernel(
    ing_count, eg_count, ing_iso, eg_iso, src_idx, q_row, q_dst, *,
    self_traffic: bool, default_allow_unselected: bool,
):
    """Rows for ``src_idx`` plus per-probe answers: probe ``k`` asks row
    ``q_row[k]`` (a position into ``src_idx``) against destination
    ``q_dst[k]``."""
    rows = _reach_rows_kernel(
        ing_count, eg_count, ing_iso, eg_iso, src_idx,
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
    )
    return rows, rows[q_row, q_dst]


def _reach_cols_kernel(
    ing_count, eg_count, ing_iso, eg_iso, dst_idx, *,
    self_traffic: bool, default_allow_unselected: bool,
) -> torch.Tensor:
    """Reach COLUMNS for the destinations in ``dst_idx`` — the transpose
    twin of ``_reach_rows_kernel`` (fix dst, vary every source) as a bool
    [N, U] gather, never the full matrix::

        ing_ok[i, d] = ing_count[i, d] > 0   (| ing_iso[d] == 0)
        eg_ok [i, d] = eg_count [i, d] > 0   (| eg_iso [i] == 0)
        col   [i, d] = ing_ok & eg_ok        (| i == d)
    """
    ing_ok = ing_count[:, dst_idx] > 0
    eg_ok = eg_count[:, dst_idx] > 0
    if default_allow_unselected:
        ing_ok |= (ing_iso[dst_idx] == 0)[None, :]
        eg_ok |= (eg_iso == 0)[:, None]
    cols = ing_ok & eg_ok
    if self_traffic:
        n = ing_count.shape[0]
        cols |= torch.arange(n, device=dst_idx.device)[:, None] == dst_idx[None, :]
    return cols


def batched_reach_rows(
    ing_count, eg_count, ing_iso, eg_iso, src_idx, *,
    self_traffic: bool, default_allow_unselected: bool,
) -> np.ndarray:
    """Gather the reach rows of ``src_idx`` (host ints, [U]) from the dense
    engine's state; returns bool [U, N]. ``ing_count``/``eg_count`` are the
    engine's count matrices, ``ing_iso``/``eg_iso`` its isolation counts. An
    empty ``src_idx`` short-circuits to a (0, N) result."""
    n = int(ing_count.shape[0])
    if len(src_idx) == 0:
        return np.zeros((0, n), dtype=bool)
    dev = ing_count.device
    rows = _reach_rows_kernel(
        ing_count, eg_count, _as_iso(ing_iso, dev), _as_iso(eg_iso, dev),
        _idx(src_idx, dev),
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
    )
    return rows.cpu().numpy()


def batched_reach_cols(
    ing_count, eg_count, ing_iso, eg_iso, dst_idx, *,
    self_traffic: bool, default_allow_unselected: bool,
) -> np.ndarray:
    """Gather the reach columns of ``dst_idx`` (host ints, [U]); returns bool
    [N, U] — column ``k`` lists every source that reaches ``dst_idx[k]``."""
    n = int(ing_count.shape[0])
    if len(dst_idx) == 0:
        return np.zeros((n, 0), dtype=bool)
    dev = ing_count.device
    cols = _reach_cols_kernel(
        ing_count, eg_count, _as_iso(ing_iso, dev), _as_iso(eg_iso, dev),
        _idx(dst_idx, dev),
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
    )
    return cols.cpu().numpy()


def batched_any_port(
    ing_count, eg_count, ing_iso, eg_iso, src_idx, q_row, q_dst, *,
    self_traffic: bool, default_allow_unselected: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Answer a whole any-port probe batch in one call: ``src_idx`` [U] are
    the distinct source pods, ``q_row`` [Q] maps each probe to its position
    in ``src_idx``, ``q_dst`` [Q] the destination pod. Returns ``(rows
    [U, N], answers [Q])`` — the rows so the caller can memoize them."""
    n = int(ing_count.shape[0])
    if len(q_row) == 0:
        return np.zeros((0, n), dtype=bool), np.zeros(0, dtype=bool)
    dev = ing_count.device
    rows, ans = _probe_rows_kernel(
        ing_count, eg_count, _as_iso(ing_iso, dev), _as_iso(eg_iso, dev),
        _idx(src_idx, dev), _idx(q_row, dev), _idx(q_dst, dev),
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
    )
    return rows.cpu().numpy(), ans.cpu().numpy()


# ---------------------------------------------------------------- packed


def _packed_probe_kernel(
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt, col_mask,
    row_valid, src_idx, q_row, q_dst, *, self_traffic: bool, default_allow: bool,
):
    """Packed word-rows for ``src_idx`` plus per-probe verdict bits: probe
    ``k`` asks row ``q_row[k]`` (a position into ``src_idx``) for dst
    ``q_dst[k]``, one bit read per probe (``& 1``: an int32 word's shift
    sign-extends)."""
    words = _rows_step(
        (sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt),
        col_mask, row_valid, src_idx,
        self_traffic=self_traffic, default_allow=default_allow,
    )  # int32 [K, Np/32]
    bits = (words[q_row, q_dst // 32] >> (q_dst % 32)) & 1
    return words, bits > 0


def _packed_cols_kernel(
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt, col_mask,
    row_valid, dst_idx, *, self_traffic: bool, default_allow: bool,
):
    """Reach COLUMNS from the per-policy maps: ``_reach_block`` over (every
    source × the gathered destinations), masked by row validity on the
    source axis and the packed column mask on the destination axis — the
    transpose twin of ``_rows_step`` as a skinny bool [Np, U] block."""
    Np = sel_ing8.shape[0]
    r = _reach_block(
        ing_by_pol, sel_ing8[dst_idx], sel_eg8, eg_by_pol[dst_idx],
        ing_cnt[dst_idx], eg_cnt,
        torch.arange(Np, device=dst_idx.device), dst_idx,
        self_traffic, default_allow,
    )
    r &= (row_valid > 0)[:, None]
    dst_ok = (col_mask[dst_idx // 32] >> (dst_idx % 32)) & 1
    return r & (dst_ok > 0)[None, :]


def packed_reach_rows(
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt, col_mask,
    row_valid, src_idx, *, self_traffic: bool, default_allow: bool,
) -> np.ndarray:
    """Word-rows for ``src_idx`` (host ints, [U]) re-solved from the resident
    maps; returns host uint32 [U, Np/32] (bits past the real pod count are
    masked off by ``col_mask``, so ``unpack_cols(words, Np)[:, :n]`` equals
    the dense rows at every N, ragged tails included)."""
    n_padded = int(row_valid.shape[0])
    if len(src_idx) == 0:
        return np.zeros((0, n_padded // 32), dtype=np.uint32)
    words = _rows_step(
        (sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt),
        col_mask, row_valid, _idx(src_idx, row_valid.device),
        self_traffic=self_traffic, default_allow=default_allow,
    )
    QUERY_PACKED_DISPATCHES_TOTAL.labels(kind="rows").inc()
    return to_host_words(words)


def packed_reach_cols(
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt, col_mask,
    row_valid, dst_idx, *, n: int, self_traffic: bool, default_allow: bool,
) -> np.ndarray:
    """Reach columns of ``dst_idx`` (host ints, [U]); returns bool [n, U] —
    column ``k`` lists every source that reaches ``dst_idx[k]``, computed
    from the per-policy maps without any [N, N] operand."""
    if len(dst_idx) == 0:
        return np.zeros((n, 0), dtype=bool)
    cols = _packed_cols_kernel(
        sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt, col_mask,
        row_valid, _idx(dst_idx, row_valid.device),
        self_traffic=self_traffic, default_allow=default_allow,
    )
    QUERY_PACKED_DISPATCHES_TOTAL.labels(kind="cols").inc()
    return cols[:n].cpu().numpy()


def packed_any_port(
    sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt, col_mask,
    row_valid, src_idx, q_row, q_dst, *, self_traffic: bool, default_allow: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """A whole any-port probe batch in one call: ``src_idx`` [U] are the
    distinct source pods, ``q_row`` [Q] maps each probe to its position in
    ``src_idx``, ``q_dst`` [Q] the destination pod. Returns ``(word rows
    [U, Np/32] host uint32, answers [Q] bool)`` — the rows for the caller's
    generation-keyed memo, the answers as one extracted bit per probe."""
    n_padded = int(row_valid.shape[0])
    if len(q_row) == 0:
        return (
            np.zeros((0, n_padded // 32), dtype=np.uint32),
            np.zeros(0, dtype=bool),
        )
    dev = row_valid.device
    words, ans = _packed_probe_kernel(
        sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt, col_mask,
        row_valid, _idx(src_idx, dev), _idx(q_row, dev), _idx(q_dst, dev),
        self_traffic=self_traffic, default_allow=default_allow,
    )
    QUERY_PACKED_DISPATCHES_TOTAL.labels(kind="probe").inc()
    return to_host_words(words), ans.cpu().numpy()


# --------------------------------------------------------------- stripes
# The same row/column formulas against a [S, N] row stripe of the count
# matrices. ``row_base`` is the stripe's first global row; the egress
# isolation vector arrives as the stripe's local [S] slice, while the
# ingress vector stays full [N] (destinations span the whole cluster).


def _stripe_rows_kernel(
    ing_stripe, eg_stripe, ing_iso, eg_iso_local, row_base: int, src_loc, *,
    self_traffic: bool, default_allow_unselected: bool,
) -> torch.Tensor:
    """Reach rows for stripe-LOCAL sources ``src_loc`` — ``_reach_rows_kernel``
    with the self-traffic diagonal shifted by ``row_base`` and egress
    isolation read from the local slice."""
    ing_ok = ing_stripe[src_loc] > 0
    eg_ok = eg_stripe[src_loc] > 0
    if default_allow_unselected:
        ing_ok |= (ing_iso == 0)[None, :]
        eg_ok |= (eg_iso_local[src_loc] == 0)[:, None]
    rows = ing_ok & eg_ok
    if self_traffic:
        n = ing_stripe.shape[1]
        ar = torch.arange(n, device=src_loc.device)
        rows |= (src_loc + row_base)[:, None] == ar[None, :]
    return rows


def _stripe_probe_kernel(
    ing_stripe, eg_stripe, ing_iso, eg_iso_local, row_base: int, src_loc,
    q_row, q_dst, *, self_traffic: bool, default_allow_unselected: bool,
):
    """Stripe rows plus per-probe answers (the stripe twin of
    ``_probe_rows_kernel``). ``q_dst`` stays a GLOBAL pod index: the row
    axis is striped, the column axis never is."""
    rows = _stripe_rows_kernel(
        ing_stripe, eg_stripe, ing_iso, eg_iso_local, row_base, src_loc,
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
    )
    return rows, rows[q_row, q_dst]


def _stripe_cols_kernel(
    ing_stripe, eg_stripe, ing_iso, eg_iso_local, row_base: int, dst_idx, *,
    self_traffic: bool, default_allow_unselected: bool,
) -> torch.Tensor:
    """This stripe's bool [S, U] FRAGMENT of the reach columns for global
    destinations ``dst_idx``; the fragments of every stripe, concatenated
    in stripe order, are ``_reach_cols_kernel``'s [N, U] answer."""
    ing_ok = ing_stripe[:, dst_idx] > 0
    eg_ok = eg_stripe[:, dst_idx] > 0
    if default_allow_unselected:
        ing_ok |= (ing_iso[dst_idx] == 0)[None, :]
        eg_ok |= (eg_iso_local == 0)[:, None]
    cols = ing_ok & eg_ok
    if self_traffic:
        s = ing_stripe.shape[0]
        ar = torch.arange(s, device=dst_idx.device)
        cols |= (ar + row_base)[:, None] == dst_idx[None, :]
    return cols


def stripe_reach_rows(
    ing_stripe, eg_stripe, ing_iso, eg_iso_local, src_loc, *,
    row_base: int, self_traffic: bool, default_allow_unselected: bool,
) -> np.ndarray:
    """Reach rows for stripe-local sources ``src_loc`` (host ints in
    [0, S)) from a [S, N] stripe; returns bool [U, N], equal to
    :func:`batched_reach_rows` on the whole matrix at global indices
    ``src_loc + row_base``."""
    n = int(ing_stripe.shape[1])
    if len(src_loc) == 0:
        return np.zeros((0, n), dtype=bool)
    dev = ing_stripe.device
    rows = _stripe_rows_kernel(
        ing_stripe, eg_stripe, _as_iso(ing_iso, dev), _as_iso(eg_iso_local, dev),
        int(row_base), _idx(src_loc, dev),
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
    )
    return rows.cpu().numpy()


def stripe_reach_cols(
    ing_stripe, eg_stripe, ing_iso, eg_iso_local, dst_idx, *,
    row_base: int, self_traffic: bool, default_allow_unselected: bool,
) -> np.ndarray:
    """This stripe's column fragment for global destinations ``dst_idx``;
    returns bool [S, U]. Concatenating every stripe's fragment along axis 0
    in stripe order equals :func:`batched_reach_cols`."""
    s = int(ing_stripe.shape[0])
    if len(dst_idx) == 0:
        return np.zeros((s, 0), dtype=bool)
    dev = ing_stripe.device
    cols = _stripe_cols_kernel(
        ing_stripe, eg_stripe, _as_iso(ing_iso, dev), _as_iso(eg_iso_local, dev),
        int(row_base), _idx(dst_idx, dev),
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
    )
    return cols.cpu().numpy()


def stripe_any_port(
    ing_stripe, eg_stripe, ing_iso, eg_iso_local, src_loc, q_row, q_dst, *,
    row_base: int, self_traffic: bool, default_allow_unselected: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """Answer an any-port probe batch whose sources all live on this stripe:
    ``src_loc`` [U] stripe-local source positions, ``q_row`` [Q] positions
    into ``src_loc``, ``q_dst`` [Q] GLOBAL destinations. Returns ``(rows
    [U, N], answers [Q])``."""
    n = int(ing_stripe.shape[1])
    if len(q_row) == 0:
        return np.zeros((0, n), dtype=bool), np.zeros(0, dtype=bool)
    dev = ing_stripe.device
    rows, ans = _stripe_probe_kernel(
        ing_stripe, eg_stripe, _as_iso(ing_iso, dev), _as_iso(eg_iso_local, dev),
        int(row_base), _idx(src_loc, dev), _idx(q_row, dev), _idx(q_dst, dev),
        self_traffic=self_traffic,
        default_allow_unselected=default_allow_unselected,
    )
    return rows.cpu().numpy(), ans.cpu().numpy()


# Kernel-manifest registration (observe/aot.py): rebind the dispatch
# functions so their dispatch keys reach the warm pack's manifest; call
# sites above are unchanged (late binding).
from ..observe.aot import register_kernel as _register_kernel  # noqa: E402

_reach_rows_kernel = _register_kernel(
    "query", "_reach_rows_kernel", _reach_rows_kernel,
    static_argnames=("self_traffic", "default_allow_unselected"),
)
_probe_rows_kernel = _register_kernel(
    "query", "_probe_rows_kernel", _probe_rows_kernel,
    static_argnames=("self_traffic", "default_allow_unselected"),
)
_reach_cols_kernel = _register_kernel(
    "query", "_reach_cols_kernel", _reach_cols_kernel,
    static_argnames=("self_traffic", "default_allow_unselected"),
)
_packed_probe_kernel = _register_kernel(
    "query", "_packed_probe_kernel", _packed_probe_kernel,
    static_argnames=("self_traffic", "default_allow"),
)
_packed_cols_kernel = _register_kernel(
    "query", "_packed_cols_kernel", _packed_cols_kernel,
    static_argnames=("self_traffic", "default_allow"),
)
_stripe_rows_kernel = _register_kernel(
    "query", "_stripe_rows_kernel", _stripe_rows_kernel,
    static_argnames=("self_traffic", "default_allow_unselected"),
)
_stripe_probe_kernel = _register_kernel(
    "query", "_stripe_probe_kernel", _stripe_probe_kernel,
    static_argnames=("self_traffic", "default_allow_unselected"),
)
_stripe_cols_kernel = _register_kernel(
    "query", "_stripe_cols_kernel", _stripe_cols_kernel,
    static_argnames=("self_traffic", "default_allow_unselected"),
)
