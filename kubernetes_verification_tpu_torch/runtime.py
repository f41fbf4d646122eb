"""Device selection for the port's entry points.

Every public entry point runs on the CUDA device unless its caller names
another (the tests pass ``"cpu"``). Without a CUDA device the default is an
error, never a silent run on the CPU.
"""
from __future__ import annotations

import torch

from .resilience.errors import BackendError

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``. Raises
    ``BackendError`` when a CUDA device is asked for and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise BackendError(
            "no CUDA device is available; pass device='cpu' to run the "
            "solve on the CPU",
            backend="torch",
            kind="device_loss",
        )
    return dev
