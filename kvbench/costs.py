"""Frozen yardsticks: the kernels' work counts and the card's published peaks.

Copied from the port's ``ops/kernels.py`` (``packed_dir_allow_cost``,
``fused_ports_reach_cost``) and ``observe/introspect.py`` (the peak table), so
that a change to the program cannot move the bounds it is measured against.
The counts are of what the inputs need: the real pods and policies (or real
virtual-policy rows), not the padding a kernel adds.
"""
from __future__ import annotations

from typing import Optional

#: published dense peaks by ``torch.cuda.get_device_name()`` prefix (longest
#: prefix wins): int8 tensor-core operations/s and memory bytes/s. NVIDIA's
#: H100 data sheet: SXM 1,979 TOP/s int8 and 3.35 TB/s; PCIe 1,513 TOP/s and
#: 2.0 TB/s. The rates assume the full power limit (700 W on the SXM part).
PEAKS = {
    "NVIDIA H100 80GB HBM3": (1979e12, 3.35e12),
    "NVIDIA H100 SXM": (1979e12, 3.35e12),
    "NVIDIA H100 PCIe": (1513e12, 2.0e12),
}


def peak(device_kind: Optional[str]):
    """``(int8 ops/s, bytes/s)`` of the card, or None for a card not listed."""
    best = None
    for prefix, value in PEAKS.items():
        if device_kind and device_kind.startswith(prefix):
            if best is None or len(prefix) > len(best[0]):
                best = (prefix, value)
    return best[1] if best else None


def packed_dir_allow_cost(p: int, n: int) -> tuple:
    """``(ops, bytes)`` of one ``packed_dir_allow`` over ``p`` policies and
    ``n`` pods: ``2·p·n²`` int8 operations; bytes ``2·p·n`` (each map read
    once), ``4·8·n`` (the int32 [8, n] isolation rows) and ``n²/8`` (the
    packed words written once)."""
    return 2 * p * n * n, 2 * p * n + 32 * n + n * n // 8


def fused_ports_reach_cost(n: int, k: int, k_padded: int) -> tuple:
    """``(ops, bytes)`` of one ``fused_ports_reach`` over ``n`` pods and ``k``
    real virtual-policy rows in a layout of ``k_padded`` columns: ``2·k·n²``
    operations; bytes ``2·n·k_padded`` (both operands read once), ``8·n``
    (the two isolation vectors) and ``n²/8``. The plan and overlap tables (a
    few KiB) are left out."""
    return 2 * k * n * n, 2 * n * k_padded + 8 * n + n * n // 8


def least_seconds(ops: float, nbytes: float, device_kind: Optional[str]) -> Optional[float]:
    """The least time the card could take: operations over the peak rate or
    bytes over the memory rate, whichever is larger."""
    pk = peak(device_kind)
    if pk is None:
        return None
    return max(ops / pk[0], nbytes / pk[1])
