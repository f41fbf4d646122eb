"""Verification queries over the reachability matrix and per-policy bitmaps.

NumPy implementations of the reference's six analyses
(``kano_py/kano/algorithm.py:4-100``), vectorised: the reference's
O(N²) Python-level column gathers (``kano_py/kano/model.py:180-184``) become
axis reductions; the pairwise policy scans become boolean matmuls.

All functions take the matrix in the reference's orientation:
``reach[src, dst]``. The PyTorch port's own copy of
``kubernetes_verification_tpu.ops.queries``, on the host.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "all_reachable",
    "all_isolated",
    "user_groups",
    "user_crosscheck",
    "system_isolation",
    "policy_shadow",
    "policy_conflict",
]


def _np(a) -> np.ndarray:
    return np.asarray(a)


def all_reachable(reach) -> List[int]:
    """Pods reachable from *every* pod (column all-true incl. self;
    ``kano_py/kano/algorithm.py:4-9``)."""
    reach = _np(reach)
    return np.nonzero(reach.all(axis=0))[0].tolist()


def all_isolated(reach) -> List[int]:
    """Pods reachable from *no* pod (``kano_py/kano/algorithm.py:12-17``)."""
    reach = _np(reach)
    return np.nonzero(~reach.any(axis=0))[0].tolist()


def _label_value(obj, label: str) -> str:
    # Works for both kano Containers and k8s Pods.
    labels = getattr(obj, "labels", {})
    return labels.get(label, "")


def user_groups(objs: Sequence, label: str) -> np.ndarray:
    """int[N] group id per pod by the value of ``label`` (missing → group of
    ``""``) — the dense form of ``user_hashmap``
    (``kano_py/kano/algorithm.py:20-24``)."""
    values = [_label_value(o, label) for o in objs]
    uniq = {v: i for i, v in enumerate(dict.fromkeys(values))}
    return np.array([uniq[v] for v in values], dtype=np.int32)


def user_crosscheck(reach, objs: Sequence, label: str) -> List[int]:
    """Pods reachable from a pod of a *different* user group
    (``kano_py/kano/algorithm.py:27-42``)."""
    reach = _np(reach)
    gid = user_groups(objs, label)
    diff = gid[:, None] != gid[None, :]  # [src, dst]
    return np.nonzero((reach & diff).any(axis=0))[0].tolist()


def system_isolation(reach, idx: int) -> List[int]:
    """Pods NOT reachable *from* pod ``idx`` (row complement;
    ``kano_py/kano/algorithm.py:45-55``)."""
    reach = _np(reach)
    return np.nonzero(~reach[idx])[0].tolist()


def _gram(a: np.ndarray) -> np.ndarray:
    """int64 [P, P] Gram matrix ``a @ a.T`` of a bool [P, N] set stack
    (counts of co-members; exact)."""
    a64 = _np(a).astype(np.int64)
    return a64 @ a64.T


def _pairs(mask: np.ndarray) -> List[Tuple[int, int]]:
    """bool [P, P] → (j, k) index pairs in row-major (j-then-k) scan order —
    the reference's iteration order."""
    return [(int(j), int(k)) for j, k in np.argwhere(mask)]


def policy_shadow(src_sets, dst_sets) -> List[Tuple[int, int]]:
    """Pairs (j, k) of policies co-selecting a pod where k's allow set is
    contained in j's — k adds no edge j doesn't already grant on those pods
    (``kano_py/kano/algorithm.py:58-80``). Vectorised: ``share = S·Sᵀ > 0``
    and ``k⊆j ⟺ |D_k| - (D·Dᵀ)[k,j] == 0`` — two Gram matmuls (host BLAS) plus an
    ``np.argwhere`` harvest; no Python-level P² loop.
    Unlike the reference (which appends one pair per co-selected container)
    the result is deduplicated; ordering matches the reference's (j, k) scan
    order."""
    S = _np(src_sets)
    D = _np(dst_sets)
    share = _gram(S) > 0
    dd = _gram(D)
    dsize = _np(dst_sets).sum(axis=1, dtype=np.int64)  # |D_k|
    # k ⊆ j ⟺ |D_k \ D_j| = |D_k| - |D_k ∩ D_j| = 0
    mask = share & (dd == dsize[None, :])
    np.fill_diagonal(mask, False)
    return _pairs(mask)


def policy_conflict(src_sets, dst_sets) -> List[Tuple[int, int]]:
    """Pairs (j, k) of policies co-selecting a pod whose allow sets are
    *disjoint* (and both non-empty) — together they grant contradictory
    intents for the same pods. This is the repaired form of
    ``kano_py/kano/algorithm.py:83-100``, whose published version crashes
    (it iterates ``enumerate(i_select)`` so ``pj``/``pk`` are ints and
    ``pj.working_allow_set`` raises AttributeError); the subset test
    ``k_allow ⊆ ¬j_allow`` it intends is exactly disjointness, computed here
    as ``D·Dᵀ == 0`` with an ``np.argwhere`` harvest. The non-empty guard
    avoids reporting policies that grant nothing."""
    S = _np(src_sets)
    D = _np(dst_sets)
    share = _gram(S) > 0
    overlap = _gram(D)  # [j, k] |dst_j ∩ dst_k|
    nonempty = D.sum(axis=1, dtype=np.int64) > 0
    mask = share & (overlap == 0) & nonempty[:, None] & nonempty[None, :]
    np.fill_diagonal(mask, False)
    return _pairs(mask)
