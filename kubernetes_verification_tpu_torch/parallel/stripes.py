"""Contiguous pod-range stripe geometry, shared by every stripe owner.

The PyTorch port's copy of ``kubernetes_verification_tpu.parallel.stripes``.

One function pair defines how the pod axis splits across a stripe fleet —
the serving fleet (``serve/stripes.py``) and the distributed closure
(``sharded_closure.py``) must agree on it bit-for-bit, or a checkpoint
written by one geometry resumes into another and every row lands off by
one. The split is the **balanced contiguous partition**: stripe ``k`` of
``K`` owns ``base + 1`` rows when ``k < n % K`` else ``base`` rows
(``base = n // K``), so stripe sizes differ by at most one and the ragged
remainder rides the *first* stripes (matching ``np.array_split``).

Being pure integer arithmetic with no device state, this module is the
one place the routing table lives: ``stripe_of`` inverts ``stripe_bounds``
in O(1) without materialising any per-pod owner map.
"""
from __future__ import annotations

from typing import List, Tuple

from ..resilience.errors import ConfigError

__all__ = ["stripe_bounds", "stripe_of", "stripe_table", "parse_stripe"]


def _check_geometry(n: int, n_stripes: int) -> Tuple[int, int]:
    n = int(n)
    n_stripes = int(n_stripes)
    if n < 0:
        raise ConfigError(f"stripe geometry needs n >= 0, got n={n}")
    if n_stripes < 1:
        raise ConfigError(
            f"stripe geometry needs at least one stripe, got {n_stripes}"
        )
    return n, n_stripes


def stripe_bounds(n: int, k: int, n_stripes: int) -> Tuple[int, int]:
    """Half-open row range ``[lo, hi)`` owned by stripe ``k`` of
    ``n_stripes`` over ``n`` pods. Balanced contiguous split: the first
    ``n % n_stripes`` stripes carry one extra row."""
    n, n_stripes = _check_geometry(n, n_stripes)
    k = int(k)
    if not 0 <= k < n_stripes:
        raise ConfigError(
            f"stripe index {k} outside [0, {n_stripes})"
        )
    base, rem = divmod(n, n_stripes)
    lo = k * base + min(k, rem)
    hi = lo + base + (1 if k < rem else 0)
    return lo, hi


def stripe_of(n: int, n_stripes: int, pod: int) -> int:
    """The stripe index owning row ``pod`` — the O(1) inverse of
    :func:`stripe_bounds` (no per-pod owner table)."""
    n, n_stripes = _check_geometry(n, n_stripes)
    pod = int(pod)
    if not 0 <= pod < n:
        raise ConfigError(f"pod index {pod} outside [0, {n})")
    base, rem = divmod(n, n_stripes)
    # the first `rem` stripes are (base+1) wide and cover rows
    # [0, rem*(base+1)); the rest are `base` wide
    fat = rem * (base + 1)
    if pod < fat:
        return pod // (base + 1)
    return rem + (pod - fat) // base if base else n_stripes - 1


def stripe_table(n: int, n_stripes: int) -> List[Tuple[int, int]]:
    """Every stripe's ``(lo, hi)`` in index order — the routing table the
    coordinator renders and `kv-tpu fleet` prints."""
    return [stripe_bounds(n, k, n_stripes) for k in range(n_stripes)]


def parse_stripe(spec: str) -> Tuple[int, int]:
    """Parse a ``K/N`` CLI stripe spec (1-based K, as operators count)
    into the 0-based ``(index, count)`` pair the geometry uses. Raises
    :class:`ConfigError` on malformed or out-of-range specs."""
    text = str(spec).strip()
    k_s, sep, n_s = text.partition("/")
    try:
        if not sep:
            # kvtpu: ignore[error-taxonomy] raised-and-caught two lines down to share the int() parse failure path
            raise ValueError("missing '/'")
        k, count = int(k_s), int(n_s)
    except ValueError:
        raise ConfigError(
            f"stripe spec must be K/N (e.g. 3/8), got {spec!r}"
        ) from None
    if count < 1 or not 1 <= k <= count:
        raise ConfigError(
            f"stripe spec {spec!r} out of range: need 1 <= K <= N"
        )
    return k - 1, count
