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
    "unpack_words_t_i8",
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


def _byte_shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def unpack_words_i8(words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """int32 [..., W] → int8 [..., n_cols] (n_cols == 32·W, little bit
    order — the inverse of ``pack_bool_cols`` on the last axis).

    The words are read as their little-endian bytes: byte ``c`` of a row
    holds columns ``8c .. 8c+7``, so one uint8 shift per output element
    unpacks them, and the only transient is the output itself (an int32
    shift would make one four times its size)."""
    b = words.contiguous().view(torch.uint8)  # [..., 4W]
    out = torch.bitwise_right_shift(b[..., None], _byte_shifts(words.device))
    return out.bitwise_and_(1).reshape(*words.shape[:-1], n_cols).view(torch.int8)


def unpack_words_t_i8(words: torch.Tensor, n_cols: int) -> torch.Tensor:
    """int32 [R, W] → int8 [n_cols, R], contiguous: the transpose of
    ``unpack_words_i8(words, n_cols)``, made by transposing the bytes (an
    eighth of the output) and unpacking each byte row into 8 output rows,
    so the unpacked matrix is written once, already K-contiguous for a
    product that contracts over R."""
    bt = words.contiguous().view(torch.uint8).t().contiguous()  # [4W, R]
    out = torch.bitwise_right_shift(bt[:, None, :], _byte_shifts(words.device)[:, None])
    return out.bitwise_and_(1).reshape(n_cols, words.shape[0]).view(torch.int8)


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
