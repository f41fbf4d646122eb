"""Bounded retry with exponential backoff + deterministic jitter.

The port's copy of ``kubernetes_verification_tpu.resilience.retry``: the
packed incremental engine wraps its stripe and row re-solves in
:func:`retry_transient`, so a transient device failure does not kill a
long-lived serving verifier mid-query. Each retry increments
``kvtpu_retries_total``, as in the JAX package.

Jitter is seeded (``random.Random(seed)`` per call), so a given failure
sequence produces the same delay schedule on every run.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, TypeVar

from ..observe.metrics import RETRIES_TOTAL
from .errors import BackendError, classify_exception

__all__ = ["RetryPolicy", "retry_transient"]

T = TypeVar("T")


@dataclass(frozen=True)
class RetryPolicy:
    """How many times to retry a transient failure and how long to wait.

    Delay for retry ``i`` (0-based) is
    ``min(backoff_base * 2**i, backoff_max) * (1 + U[0, jitter))`` with the
    uniform draw from a ``seed``-initialised PRNG — exponential backoff,
    capped, with deterministic decorrelation jitter.
    """

    max_retries: int = 2
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    jitter: float = 0.1
    seed: int = 0

    def delays(self) -> Iterator[float]:
        rng = random.Random(self.seed)
        for i in range(self.max_retries):
            base = min(self.backoff_base * (2.0 ** i), self.backoff_max)
            yield base * (1.0 + rng.random() * self.jitter)


#: a no-retry policy for hot paths that opt out (still classifies errors)
NO_RETRY = RetryPolicy(max_retries=0)


def retry_transient(
    fn: Callable[[], T],
    *,
    policy: RetryPolicy = RetryPolicy(),
    backend: str = "unknown",
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[BackendError, int], None]] = None,
) -> T:
    """Call ``fn``; on a *transient* :class:`BackendError` (after
    :func:`classify_exception`), back off and retry up to
    ``policy.max_retries`` times. Non-transient errors and exhausted
    budgets raise the classified error (original exception chained as
    ``__cause__``). Each retry increments ``kvtpu_retries_total``.
    """
    delays = policy.delays()
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — classify-and-dispatch point
            err = classify_exception(e, backend)
            try:
                delay = next(delays)
            except StopIteration:
                delay = None
            if not err.transient or delay is None:
                raise err from e
            RETRIES_TOTAL.labels(backend=backend, kind=err.kind).inc()
            if on_retry is not None:
                on_retry(err, attempt)
            sleep(delay)
            attempt += 1
