"""Resilience of the PyTorch port: typed errors, retries, fallback chains,
watchdogs, OOM degradation, circuit breakers and fault injection.

The port's copy of ``kubernetes_verification_tpu.resilience``:

* ``errors``  — the :class:`KvTpuError` taxonomy and the exit-code contract;
* ``retry``   — :class:`RetryPolicy` / :func:`retry_transient`;
* ``wrapper`` — :func:`resilient_verify` / :func:`resilient_verify_kano`,
  the fallback-chain / watchdog / OOM-degradation loop (a chain from a
  card backend to the host oracle is refused);
* ``breaker`` — per-backend circuit breakers;
* ``faults``  — the deterministic ``faulty:<backend>`` injection harness
  and the named kill-points of the crash-fault harness.

Only ``errors`` is imported eagerly; the rest load on first attribute
access (the lazy hook below), as in the JAX package.
"""
from __future__ import annotations

from .errors import (  # noqa: F401  (re-exported)
    EXIT_BACKEND_FAILED,
    EXIT_INPUT_ERROR,
    EXIT_OK,
    EXIT_VIOLATIONS,
    BackendChainExhausted,
    BackendError,
    BackendOOM,
    BackendTimeout,
    ConfigError,
    DeviceLost,
    EncodeError,
    FencedError,
    IngestError,
    KvTpuError,
    PersistError,
    ServeError,
    StaleReadError,
    UnknownBackendError,
    classify_exception,
    exit_code_for,
)

__all__ = [
    "KvTpuError",
    "IngestError",
    "PersistError",
    "EncodeError",
    "ConfigError",
    "ServeError",
    "StaleReadError",
    "FencedError",
    "BackendError",
    "BackendOOM",
    "BackendTimeout",
    "DeviceLost",
    "UnknownBackendError",
    "BackendChainExhausted",
    "classify_exception",
    "exit_code_for",
    "EXIT_OK",
    "EXIT_VIOLATIONS",
    "EXIT_INPUT_ERROR",
    "EXIT_BACKEND_FAILED",
    # lazy (see __getattr__):
    "RetryPolicy",
    "retry_transient",
    "ResilienceConfig",
    "resilient_verify",
    "resilient_verify_kano",
    "FaultRule",
    "FaultInjector",
    "FaultyBackend",
    "parse_fault_spec",
    "register_faulty",
    "FAULT_KINDS",
    "KILL_POINTS",
    "KillPointInjector",
    "install_kill_points",
    "clear_kill_points",
    "kill_point",
    "CircuitBreaker",
    "breaker_for",
    "reset_breakers",
    "breaker_states",
]

_LAZY = {
    "RetryPolicy": "retry",
    "retry_transient": "retry",
    "ResilienceConfig": "wrapper",
    "resilient_verify": "wrapper",
    "resilient_verify_kano": "wrapper",
    "FaultRule": "faults",
    "FaultInjector": "faults",
    "FaultyBackend": "faults",
    "parse_fault_spec": "faults",
    "register_faulty": "faults",
    "FAULT_KINDS": "faults",
    "KILL_POINTS": "faults",
    "KillPointInjector": "faults",
    "install_kill_points": "faults",
    "clear_kill_points": "faults",
    "kill_point": "faults",
    "CircuitBreaker": "breaker",
    "breaker_for": "breaker",
    "reset_breakers": "breaker",
    "breaker_states": "breaker",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{mod}", __name__), name)
