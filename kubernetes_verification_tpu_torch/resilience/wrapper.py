"""``resilient_verify`` — the fault-tolerant front door to the backend
registry.

The PyTorch port's copy of ``kubernetes_verification_tpu.resilience.wrapper``,
with two differences for work on the card:

* a chain that moves from a card backend to the host oracle (``cpu``) is
  refused with :class:`~.errors.ConfigError` before any attempt: work moved
  to the host because the card failed would be a hidden fallback. A config
  whose ``("device", ...)`` option is ``"cpu"`` runs every backend on the
  host, so its chains are the JAX package's;
* after a watchdog timeout on the card, the next attempt first waits for
  the card's queued work (a CUDA launch cannot be cancelled, as an XLA
  dispatch cannot), so the orphaned attempt does not share the card with
  the next one.

The OOM classification is :func:`~.errors.classify_exception`, which maps
``torch.OutOfMemoryError`` onto :class:`~.errors.BackendOOM`.

Production accelerator serving treats OOM, preemption and device loss as routine
(PAPERS.md: the distributed-linear-algebra pods only scale because chip
faults are tolerated; the CFD framework degrades tile sizes under memory
pressure). This wrapper gives the verifier the same posture around
``backends.base.verify``:

* **fallback chain** — an ordered backend list (on the host, ``torch → cpu``);
  when one backend fails non-transiently, the next is tried. The chain
  exhausting raises :class:`~.errors.BackendChainExhausted` (CLI exit 3).
* **bounded retry** — transient :class:`~.errors.BackendError`\\ s retry the
  *same* backend with exponential backoff + deterministic jitter
  (:class:`~.retry.RetryPolicy`).
* **watchdog** — each solve attempt runs under a wall-clock timeout; a hung
  attempt is abandoned (the worker thread is orphaned — XLA dispatches are
  not cancellable) and surfaces as a transient
  :class:`~.errors.BackendTimeout`.
* **adaptive OOM degradation** — ``RESOURCE_EXHAUSTED`` halves the ``tile``
  backend option and re-attempts, down to ``min_tile``, before the chain
  falls back. Halvings don't consume the retry budget: a smaller tile is
  progress, not repetition.
* **circuit breaker** (opt-in: ``breaker_threshold`` > 0) — a backend
  whose attempts keep exhausting their retries trips its per-backend
  breaker (:mod:`~.breaker`) and is skipped outright until the cooldown
  admits a half-open probe, so a flapping backend stops charging every
  request the full retry + watchdog toll.

Every decision is visible through the metrics registry:
``kvtpu_retries_total``, ``kvtpu_fallbacks_total``,
``kvtpu_degradations_total`` (and ``kvtpu_faults_injected_total`` from the
injection harness in ``resilience.faults``).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, List, Optional, Sequence, Tuple

from ..observe import log_event
from ..observe.metrics import DEGRADATIONS_TOTAL, FALLBACKS_TOTAL, RETRIES_TOTAL
from .errors import (
    BackendChainExhausted,
    BackendError,
    BackendOOM,
    BackendTimeout,
    ConfigError,
    KvTpuError,
    classify_exception,
)
from .retry import RetryPolicy

__all__ = ["ResilienceConfig", "resilient_verify", "resilient_verify_kano"]


@dataclass(frozen=True)
class ResilienceConfig:
    """The resilient wrapper's knobs (CLI: ``--fallback-chain``,
    ``--max-retries``, ``--solve-timeout``)."""

    #: ordered backends to try; () means "just the VerifyConfig's backend"
    fallback_chain: Tuple[str, ...] = ()
    max_retries: int = 2
    backoff_base: float = 0.05
    backoff_max: float = 2.0
    jitter: float = 0.1
    seed: int = 0
    #: wall-clock seconds per solve attempt; None disables the watchdog
    solve_timeout: Optional[float] = None
    #: halve the ``tile`` backend option on RESOURCE_EXHAUSTED
    degrade_on_oom: bool = True
    #: starting tile when the config carries none and an OOM asks for a halving
    initial_tile: int = 2048
    min_tile: int = 128
    #: consecutive exhausted attempts before a backend's circuit breaker
    #: opens and the chain skips it outright; 0 disables the breaker
    breaker_threshold: int = 0
    #: seconds an open circuit waits before admitting a half-open probe
    breaker_cooldown: float = 30.0

    def retry_policy(self) -> RetryPolicy:
        return RetryPolicy(
            max_retries=self.max_retries,
            backoff_base=self.backoff_base,
            backoff_max=self.backoff_max,
            jitter=self.jitter,
            seed=self.seed,
        )


def _with_opt(config, key: str, value) -> "object":
    """A copy of ``config`` with backend option ``key`` set to ``value``."""
    opts = [(k, v) for k, v in config.backend_options if k != key]
    opts.append((key, value))
    return replace(config, backend_options=tuple(opts))


def _run_with_watchdog(
    fn: Callable[[], object], timeout: Optional[float], backend: str
):
    """Run one solve attempt, bounded by ``timeout`` seconds.

    The attempt runs on a single-use **daemon** thread; on timeout it is
    abandoned (never joined — a hung XLA dispatch cannot be cancelled from
    Python) and :class:`BackendTimeout` is raised so the caller can retry
    or fall back. Daemon status is what keeps the contract honest: a
    non-daemon worker (e.g. ``ThreadPoolExecutor``'s) would be joined at
    interpreter exit, so the very hang the watchdog detected would block
    the CLI from ever delivering its exit code.
    """
    if timeout is None:
        return fn()
    outcome: List[Tuple[bool, object]] = []
    done = threading.Event()

    def _attempt() -> None:
        try:
            outcome.append((True, fn()))
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            outcome.append((False, e))
        finally:
            done.set()

    t = threading.Thread(
        target=_attempt, name=f"kvtpu-{backend}-watchdog", daemon=True
    )
    t.start()
    if not done.wait(timeout):
        raise BackendTimeout(
            f"watchdog: solve on {backend!r} exceeded {timeout}s",
            backend=backend,
        ) from None
    ok, payload = outcome[0]
    if ok:
        return payload
    raise payload  # type: ignore[misc]


def _is_host_backend(backend: str) -> bool:
    """The host oracle, directly or behind a fault injector."""
    return backend.split(":")[-1] == "cpu"


def _card_device(config):
    """The CUDA device a config's card backends run on, or None when its
    ``("device", ...)`` option names the host."""
    import torch

    dev = torch.device(config.opt("device") or "cuda")
    return dev if dev.type == "cuda" else None


def _check_chain(chain: Tuple[str, ...], config) -> None:
    """Refuse a chain that falls from a card backend to the host oracle."""
    if _card_device(config) is None:
        return
    for pos, backend in enumerate(chain):
        if _is_host_backend(backend):
            continue
        later = [b for b in chain[pos + 1:] if _is_host_backend(b)]
        if later:
            raise ConfigError(
                f"fallback chain {list(chain)} moves from the card backend "
                f"{backend!r} to the host oracle {later[0]!r}: work the card "
                "failed would be answered on the host. Run on the host "
                "explicitly (backend option ('device', 'cpu') or a chain "
                "of only 'cpu') or drop the host backend from the chain"
            )


def _drain_card(config) -> None:
    """Wait for the card's queued work (an abandoned attempt's launches)."""
    import torch

    dev = _card_device(config)
    if dev is not None and torch.cuda.is_available():
        torch.cuda.synchronize(dev)


def _resilient_call(
    run_one: Callable[[object], object],
    config,
    res: ResilienceConfig,
    sleep: Callable[[float], None],
):
    """The shared chain/retry/degrade loop behind both public wrappers.

    ``run_one(cfg)`` performs a single dispatch with ``cfg.backend`` /
    ``cfg.backend_options`` already set for the attempt.
    """
    chain: Tuple[str, ...] = res.fallback_chain or (config.backend,)
    if not chain:
        raise ConfigError("fallback chain is empty")
    _check_chain(chain, config)
    failures: List[Tuple[str, BackendError]] = []
    for pos, backend in enumerate(chain):
        breaker = None
        if res.breaker_threshold > 0:
            from .breaker import breaker_for

            breaker = breaker_for(
                backend,
                failure_threshold=res.breaker_threshold,
                cooldown=res.breaker_cooldown,
            )
            if not breaker.allow():
                # circuit open: skip the doomed backend without burning
                # its retry schedule or watchdog budget
                err = BackendError(
                    f"circuit breaker open for {backend!r} "
                    f"(cooldown {res.breaker_cooldown}s)",
                    backend=backend, kind="breaker_open", transient=True,
                )
                failures.append((backend, err))
                if pos + 1 < len(chain):
                    FALLBACKS_TOTAL.labels(
                        from_backend=backend, to_backend=chain[pos + 1]
                    ).inc()
                    log_event(
                        "fallback", from_backend=backend,
                        to_backend=chain[pos + 1], kind="breaker_open",
                    )
                continue
        cfg = replace(config, backend=backend)
        delays = res.retry_policy().delays()
        err: Optional[BackendError] = None
        while True:
            try:
                result = _run_with_watchdog(
                    lambda: run_one(cfg), res.solve_timeout, backend
                )
                if breaker is not None:
                    breaker.record_success()
                return result
            except BackendError as e:
                err = classify_exception(e, backend)
            except KvTpuError:
                # IngestError / ConfigError / EncodeError ... are the
                # caller's input bug, not infrastructure: retrying or
                # falling back cannot fix them, and wrapping them would
                # misreport exit 2 (input error) as exit 3 (backend failed).
                raise
            except Exception as e:  # noqa: BLE001 — the classification point
                err = classify_exception(e, backend)
            if isinstance(err, BackendTimeout) and not _is_host_backend(backend):
                _drain_card(cfg)
            # -- adaptive OOM degradation: halve the tile, try again -------
            if (
                isinstance(err, BackendOOM)
                and res.degrade_on_oom
            ):
                tile = dict(cfg.backend_options).get("tile", res.initial_tile)
                if isinstance(tile, int) and tile // 2 >= res.min_tile:
                    cfg = _with_opt(cfg, "tile", tile // 2)
                    DEGRADATIONS_TOTAL.labels(backend=backend).inc()
                    log_event(
                        "degrade", backend=backend, tile=tile // 2,
                        reason="oom",
                    )
                    continue
            # -- bounded transient retry on the same backend ---------------
            if err.transient:
                try:
                    delay = next(delays)
                except StopIteration:
                    delay = None
                if delay is not None:
                    RETRIES_TOTAL.labels(backend=backend, kind=err.kind).inc()
                    log_event(
                        "retry", backend=backend, kind=err.kind,
                        delay_seconds=round(delay, 4),
                    )
                    sleep(delay)
                    continue
            # -- give up on this backend: fall through the chain -----------
            if breaker is not None:
                breaker.record_failure()
            failures.append((backend, err))
            if pos + 1 < len(chain):
                FALLBACKS_TOTAL.labels(
                    from_backend=backend, to_backend=chain[pos + 1]
                ).inc()
                log_event(
                    "fallback", from_backend=backend,
                    to_backend=chain[pos + 1], kind=err.kind,
                )
            break
    raise BackendChainExhausted(chain, failures)


def resilient_verify(
    cluster,
    config=None,
    resilience: Optional[ResilienceConfig] = None,
    *,
    sleep: Callable[[float], None] = time.sleep,
):
    """:func:`backends.base.verify` behind the fallback chain / retry /
    watchdog / degradation loop. ``sleep`` is injectable so tests run the
    full backoff schedule in zero wall-clock time."""
    from ..backends import base

    config = config or base.VerifyConfig()
    res = resilience or ResilienceConfig()
    return _resilient_call(
        lambda cfg: base.verify(cluster, cfg), config, res, sleep
    )


def resilient_verify_kano(
    containers: Sequence,
    policies: Sequence,
    config=None,
    resilience: Optional[ResilienceConfig] = None,
    *,
    sleep: Callable[[float], None] = time.sleep,
):
    """:func:`backends.base.verify_kano` behind the same loop."""
    from ..backends import base

    config = config or base.VerifyConfig()
    res = resilience or ResilienceConfig()
    return _resilient_call(
        lambda cfg: base.verify_kano(containers, policies, cfg),
        config,
        res,
        sleep,
    )
