"""Population counts over packed reachability words.

The port of ``kubernetes_verification_tpu.ops.closure``'s
``_packed_row_counts`` / ``_packed_pair_total``. torch has no popcount, so a
256-entry byte table is gathered over a ``uint8`` view of the int32 words, a
block of rows at a time so the gathered bytes stay small at 100k pods. Per-row
counts are int32 (a row holds < 2³¹ bits); the total is summed in int64,
exact at 100k² pairs. The packed closure itself is not ported yet.
"""
from __future__ import annotations

import torch

__all__ = ["packed_row_counts", "packed_pair_total"]

#: rows per gather block: 4096 rows × 12,800 bytes ≈ 52 MB of indices at
#: 100k pods
_ROWS_PER_BLOCK = 4096


def _byte_popcounts(device) -> torch.Tensor:
    """uint8 [256]: set bits of each byte value."""
    v = torch.arange(256, dtype=torch.int32, device=device)
    bits = (v[:, None] >> torch.arange(8, dtype=torch.int32, device=device)) & 1
    return bits.sum(dim=1).to(torch.uint8)


def packed_row_counts(packed: torch.Tensor) -> torch.Tensor:
    """int32 [R]: set bits per row of an int32 [R, W] packed matrix."""
    table = _byte_popcounts(packed.device)
    out = torch.empty(packed.shape[0], dtype=torch.int32, device=packed.device)
    for r0 in range(0, packed.shape[0], _ROWS_PER_BLOCK):
        block = packed[r0 : r0 + _ROWS_PER_BLOCK].contiguous()
        idx = block.view(torch.uint8).to(torch.int32)
        out[r0 : r0 + _ROWS_PER_BLOCK] = table[idx].sum(dim=1, dtype=torch.int32)
    return out


def packed_pair_total(packed: torch.Tensor) -> int:
    """Set bits of the whole matrix, summed in int64 (synchronises)."""
    return int(packed_row_counts(packed).sum(dtype=torch.int64).item())
