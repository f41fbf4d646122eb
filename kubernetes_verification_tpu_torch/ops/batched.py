"""Batched reachability probes on the packed engine's resident state.

The port of the packed twins of ``kubernetes_verification_tpu.ops.batched``:
given the distinct source (or destination) pods of a query batch, re-solve
their packed reach rows (or bool columns) straight from the
``PackedIncrementalVerifier``'s per-policy maps in one call, and answer every
any-port probe by extracting its verdict bit. The row formula is the engine's
own ``_rows_step`` / ``_reach_block``, so the answers are bit-identical to the
mutation path's words by construction, and no [N, N] operand of any dtype
appears — the path works unchanged on a matrix-free engine.

The map arguments are the engine's state in its ``_maps`` order
(``sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, ing_cnt, eg_cnt``) followed by
``col_mask`` and ``row_valid``: this package's engine holds the maps
pod-major, int8 [Np, C] (the JAX engine's are [C, Np]). Index batches are
not padded to a power of two as in the JAX package (``_pow2``,
``_pad_idx``): eager torch compiles nothing per shape. The dense-engine and
stripe twins wait for the dense engine (ROADMAP §1 item 7).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..packed_incremental import _reach_block, _rows_step
from .bits import to_host_words

__all__ = ["packed_reach_rows", "packed_reach_cols", "packed_any_port"]


def _idx(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device)


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
    return to_host_words(words), ans.cpu().numpy()
