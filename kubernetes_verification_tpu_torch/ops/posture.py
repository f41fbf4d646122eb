"""On-device posture-delta ops: packed generation-over-generation diffs.

The port of ``kubernetes_verification_tpu.ops.posture``. The posture plane
of the serving layer asks, after every applied mutation batch, which
(src, dst) pairs changed reachability and how many per namespace pair. On
packed words the answer is a bitwise diff of two word states, so the whole
derivation runs on the words' device over ``[rows, words]`` operands and
never materialises a dense ``[N, N]`` array:

* :func:`packed_xor_popcount` — widened (``cur & ~prev``) and narrowed
  (``prev & ~cur``) word planes plus their per-row popcounts;
* :func:`topk_changed_rows` — the ``k`` most-changed source rows, ties to
  the lower row index as ``jax.lax.top_k`` breaks them (a stable descending
  sort: ``torch.topk`` promises no tie order on CUDA);
* :func:`ns_pair_counts` — per-namespace blast radius: popcounts under
  per-namespace packed column masks, summed by source namespace into a
  ``[G, G]`` matrix (G = namespace count);
* :func:`packed_row_popcount` — per-row reachable-pair counts of one word
  state (the posture gauge; summed on the host in int64).

Words are int32 tensors with the reference's uint32 bit pattern
(``ops/bits.py``); host uint32 words are copied to ``cuda`` first, and
every op computes on its words' device. torch has no popcount: every count
gathers the 256-entry byte table over the words' bytes
(``ops/closure.py::packed_row_counts``), far from the byte bound of the
diff (``PERF.md``). Host helpers build the per-namespace column masks
(:func:`ns_word_masks`) and decode a changed row into witness columns
(:func:`changed_columns`, capped by the caller).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..resilience.errors import ConfigError
from .closure import _words, packed_row_counts

__all__ = [
    "packed_xor_popcount",
    "packed_row_popcount",
    "topk_changed_rows",
    "ns_pair_counts",
    "ns_word_masks",
    "changed_columns",
]


def packed_xor_popcount(prev, cur):
    """Diff two packed word states of identical shape ``[R, W]``.

    Returns ``(widened_words, narrowed_words, row_widened, row_narrowed)``:
    the widened plane holds bits set in ``cur`` but not ``prev`` (new
    reachable pairs), the narrowed plane the converse; the ``[R]`` int32
    vectors are their per-source-row popcounts. Exact: the planes ARE the
    delta."""
    prev, cur = _words(prev), _words(cur)
    if prev.shape != cur.shape:
        raise ConfigError(f"word states differ in shape: {tuple(prev.shape)} vs {tuple(cur.shape)}")
    widened = prev.bitwise_not().bitwise_and_(cur)
    narrowed = cur.bitwise_not().bitwise_and_(prev)
    return widened, narrowed, packed_row_counts(widened), packed_row_counts(narrowed)


def packed_row_popcount(words) -> torch.Tensor:
    """Per-row set-bit counts of one packed word state (``[R, W]`` → int32
    ``[R]``); the host sums in int64 so a 250k-pod state cannot overflow the
    total."""
    return packed_row_counts(_words(words))


def topk_changed_rows(row_changed: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounded top-k most-changed source rows: ``(counts, row_indices)``,
    both ``[k]`` (indices int32, as ``jax.lax.top_k`` gives them). Among
    equal counts the lower row index comes first; ``k`` may not exceed the
    row count."""
    n = int(row_changed.shape[0])
    if not 0 <= k <= n:
        raise ConfigError(f"k={k} outside [0, {n}] rows")
    counts, rows = torch.sort(row_changed, descending=True, stable=True)
    return counts[:k], rows[:k].to(torch.int32)


def ns_pair_counts(delta_words, masks, row_ns, num_groups: int) -> torch.Tensor:
    """Aggregate a delta word plane into per-namespace-pair counts.

    ``delta_words`` int32 ``[R, W]``; ``masks`` ``[G, W]`` packed column
    masks (bit j of word w set when column ``w*32+j`` belongs to namespace
    g; host uint32 from :func:`ns_word_masks`, or int32 on the device);
    ``row_ns`` ``[R]`` source-namespace index per row (``num_groups`` for
    padding/unknown rows, which are dropped). Returns int32 ``[G, G]`` where
    ``out[s, d]`` counts delta bits from namespace s to namespace d.

    One masked popcount of the plane per namespace (each reads the plane
    once), then an ``index_add_`` of its [R] row counts by source
    namespace."""
    delta = _words(delta_words)
    dev = delta.device
    masks = _words(masks, dev)
    seg = torch.as_tensor(row_ns, device=dev).long()
    seg = torch.where((seg < 0) | (seg > num_groups), num_groups, seg)
    by_dst = torch.zeros((num_groups, num_groups + 1), dtype=torch.int32, device=dev)
    for g in range(num_groups):
        by_dst[g].index_add_(0, seg, packed_row_counts(delta, masks[g]))
    return by_dst[:, :num_groups].t().contiguous()


def ns_word_masks(
    col_ns: np.ndarray, num_groups: int, n_words: int
) -> np.ndarray:
    """Host-built packed column masks: ``col_ns`` int ``[C]`` maps each
    real column to its namespace index (negative = none); returns uint32
    ``[G, W]`` with ``W = n_words`` (columns beyond ``C`` are padding and
    stay zero). Rebuilt only when the pod→namespace assignment changes."""
    c = int(col_ns.shape[0])
    bits = np.zeros((num_groups, n_words * 32), dtype=bool)
    for g in range(num_groups):
        bits[g, :c] = col_ns == g
    words = np.packbits(
        bits.reshape(num_groups, n_words, 32), axis=2, bitorder="little"
    )
    return words.reshape(num_groups, n_words, 4).view("<u4")[..., 0]


def changed_columns(word_row, cap: int) -> np.ndarray:
    """Set-bit column indices of one word row (host uint32, or an int32
    tensor), capped at ``cap`` (ascending). The cap is the bounded-journal
    contract: a single row can legally flip every column, and the witness
    list must not."""
    if isinstance(word_row, torch.Tensor):
        word_row = word_row.cpu().numpy()
    row = np.ascontiguousarray(np.asarray(word_row), dtype="<u4")
    bits = np.unpackbits(row.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits)[:cap]


# Kernel-manifest registration (observe/aot.py): rebind the dispatch
# functions so their dispatch keys reach the warm pack's manifest; call
# sites above are unchanged (late binding).
from ..observe.aot import register_kernel as _register_kernel  # noqa: E402

packed_xor_popcount = _register_kernel(
    "posture", "packed_xor_popcount", packed_xor_popcount
)
packed_row_popcount = _register_kernel(
    "posture", "packed_row_popcount", packed_row_popcount
)
topk_changed_rows = _register_kernel(
    "posture", "topk_changed_rows", topk_changed_rows,
    static_argnames=("k",),
)
ns_pair_counts = _register_kernel(
    "posture", "ns_pair_counts", ns_pair_counts,
    static_argnames=("num_groups",),
)
