"""Batched label-selector matching as matrix products, in PyTorch.

The port of ``kubernetes_verification_tpu.ops.match``: every subset /
disjointness / non-empty-intersection test of a ``SelectorEnc`` stack is a
count comparison after one matrix product

    have[s, n] = Σ_v req[s, v] · kv[n, v]

The counts are taken in float32, which is exact below 2²⁴, far above any
label vocabulary. TF32 is switched off for these products
(``torch.backends.cuda.matmul.allow_tf32 = False`` for the duration of the
call, then restored), and no count ever passes through a 16-bit type.

The selector stack arrives as a ``SelectorEnc`` of tensors on the solve's
device (``as_tensors``); ``kv``/``key`` are bool tensors on the same device.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..encode.encoder import GrantBlock, SelectorEnc

__all__ = [
    "match_selectors",
    "subset_match",
    "SelectorEnc",
    "GrantBlock",
    "as_tensors",
    "exact_fp32",
]

_F = torch.float32


@contextlib.contextmanager
def exact_fp32():
    """Full-precision float32 matrix products for the enclosed calls: counts
    of 0/1 operands must come out exact."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def as_tensors(obj, device):
    """A dataclass of numpy arrays (``SelectorEnc``, ``GrantBlock``) as the
    same dataclass of tensors on ``device``; ``None`` leaves stay ``None``."""
    vals = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = as_tensors(v, device)
        elif v is not None:
            v = torch.as_tensor(v, device=device)
        vals[f.name] = v
    return type(obj)(**vals)


def _count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int-exact boolean matmul: [S, V] × [N, V] → float32 counts [S, N]."""
    with exact_fp32():
        return a.to(_F) @ b.to(_F).T


def subset_match(req: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """bool[S, N]: req[s] ⊆ kv[n] (all required bits present)."""
    need = req.to(_F).sum(dim=-1, keepdim=True)
    return _count(req, kv) >= need


def match_selectors(
    sel: SelectorEnc, kv: torch.Tensor, key: torch.Tensor
) -> torch.Tensor:
    """Evaluate a compiled selector stack against entity label matrices.

    kv: bool[N, V], key: bool[N, K] → bool[S, N].
    """
    ok = subset_match(sel.req_eq, kv)
    ok &= subset_match(sel.req_key, key)
    forbidden = _count(sel.forbid_eq, kv) + _count(sel.forbid_key, key)
    ok &= forbidden == 0
    S, E, V = sel.in_mask.shape
    if E:
        hits = _count(sel.in_mask.reshape(S * E, V), kv)  # [S·E, N]
        in_ok = (hits > 0).reshape(S, E, -1) | ~sel.in_valid[:, :, None]
        ok &= in_ok.all(dim=1)
    return ok & ~sel.impossible[:, None]
