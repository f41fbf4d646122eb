"""Packed-word helpers.

A packed reachability row holds bit ``j`` of word ``w`` for column
``32·w + j`` (little bit order, as ``kubernetes_verification_tpu.ops.tiled``
packs). On the device the words are int32 tensors with exactly the bit pattern
of the JAX package's uint32 words: this torch build implements no ``<<`` on
``uint32``, and the host view ``.numpy().view('<u4')`` turns them back into
the reference's uint32 without a copy. Shifts of an int32 word sign-extend,
so every unpack masks with ``& 1``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pack_bool_cols",
    "unpack_words_i8",
    "unpack_cols",
    "or_diagonal",
    "to_host_words",
]


def _bit_weights(device) -> torch.Tensor:
    """int32 [32]: 1 << j; j = 31 is the sign bit, -2³¹."""
    return torch.ones(32, dtype=torch.int32, device=device) << torch.arange(
        32, dtype=torch.int32, device=device
    )


def pack_bool_cols(tile: torch.Tensor) -> torch.Tensor:
    """bool [R, C] (C % 32 == 0) → int32 [R, C/32], bit j of word w = column
    w*32+j. The sum of distinct powers of two never carries, so it is the OR,
    and the int32 sum with -2³¹ for bit 31 is the word's two's complement."""
    r, c = tile.shape
    w = tile.reshape(r, c // 32, 32).to(torch.int32)
    return (w * _bit_weights(tile.device)).sum(dim=-1, dtype=torch.int32)


def unpack_words_i8(words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """int32 [..., W] → int8 [..., n_cols] (n_cols == 32·W, little bit
    order — the inverse of ``pack_bool_cols`` on the last axis)."""
    bits = torch.arange(32, dtype=torch.int32, device=words.device)
    out = (words[..., None] >> bits) & 1
    return out.reshape(*words.shape[:-1], n_cols).to(torch.int8)


def unpack_cols(packed: np.ndarray, n_cols: int) -> np.ndarray:
    """uint32 [R, W] → bool [R, n_cols] (host-side, for tests/small slices)."""
    words = np.ascontiguousarray(np.asarray(packed), dtype="<u4")
    b = np.unpackbits(
        words.view(np.uint8).reshape(words.shape[0], -1),
        axis=1,
        bitorder="little",
    )
    return b[:, :n_cols].astype(bool)


def or_diagonal(packed: torch.Tensor) -> torch.Tensor:
    """Set bit (i, i) of every row of an int32 [N, N/32] packed matrix, in
    place (the self-traffic diagonal); each row touches one word."""
    n = packed.shape[0]
    rows = torch.arange(n, device=packed.device)
    cols = rows // 32
    bits = torch.ones(n, dtype=torch.int32, device=packed.device) << (
        rows % 32
    ).to(torch.int32)
    packed[rows, cols] = packed[rows, cols] | bits
    return packed


def to_host_words(packed: torch.Tensor) -> np.ndarray:
    """int32 packed words (any device) → the reference's uint32 numpy."""
    return packed.cpu().numpy().view(np.uint32)
