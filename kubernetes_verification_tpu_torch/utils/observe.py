"""DEPRECATED shim: the observability layer grew into the
``kubernetes_verification_tpu_torch.observe`` package (metrics registry,
spans, exporters, introspection). Import from there instead; this module
only re-exports the seed-era names, as the JAX package's
``utils.observe`` does.
"""
from __future__ import annotations

import warnings

warnings.warn(
    "kubernetes_verification_tpu_torch.utils.observe is deprecated; import "
    "from kubernetes_verification_tpu_torch.observe instead",
    DeprecationWarning,
    stacklevel=2,
)

from ..observe import (  # noqa: F401,E402
    Phases,
    configure_logging,
    log_event,
    logger,
    profile_to,
    trace,
)

__all__ = [
    "logger",
    "configure_logging",
    "log_event",
    "Phases",
    "profile_to",
    "trace",
]
