"""The typed error taxonomy of the PyTorch port, rooted at :class:`KvTpuError`.

The port's own copy of the classes it raises from
``kubernetes_verification_tpu.resilience.errors``, with the same builtin bases,
so an ``except ValueError`` / ``except KeyError`` written against the JAX
package catches the same failures here:

* :class:`EncodeError`   — model objects the tensorizer cannot encode;
* :class:`ConfigError`   — invalid flag / option combinations, and the parts
  of the system the port does not cover yet;
* :class:`BackendError`  — a solve attempt failed (no CUDA device, a kernel
  that did not build or launch).
"""
from __future__ import annotations

from typing import Optional

__all__ = [
    "KvTpuError",
    "EncodeError",
    "ConfigError",
    "BackendError",
    "UnknownBackendError",
]


class KvTpuError(Exception):
    """Root of the kubernetes-verification error taxonomy."""


class EncodeError(KvTpuError, ValueError):
    """The tensorizer cannot encode the model objects (e.g. a named-port
    restriction outside a frozen bank)."""


class ConfigError(KvTpuError, ValueError):
    """Invalid configuration: flag combinations, backend options, or a path
    the port does not implement yet — errors the caller fixes by changing
    inputs, not by retrying."""


class BackendError(KvTpuError, RuntimeError):
    """A solve attempt failed on ``backend``. ``transient=True`` means the
    same backend may succeed on retry; ``transient=False`` does not."""

    kind: str = "error"

    def __init__(
        self,
        message: str,
        *,
        backend: Optional[str] = None,
        kind: Optional[str] = None,
        transient: bool = False,
    ) -> None:
        super().__init__(message)
        self.backend = backend
        if kind is not None:
            self.kind = kind
        self.transient = transient


class UnknownBackendError(BackendError, KeyError):
    """Requested backend is not registered (also a ``KeyError`` — the
    registry's historical type)."""

    kind = "unknown_backend"
    # KeyError.__str__ reprs its argument, which would quote the message
    __str__ = Exception.__str__

    def __init__(self, message: str, *, backend: Optional[str] = None) -> None:
        super().__init__(message, backend=backend, transient=False)
