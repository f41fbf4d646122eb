"""Overload-safe fleet autoscaling off SLO burn rates and replica lag.

The PyTorch port's copy of ``kubernetes_verification_tpu.serve.autoscale``.

:class:`FleetAutoscaler` closes the loop the fleet observability plane
opened: the :class:`~..observe.fleet.SloMonitor` turns scrapes into
error-budget burn rates, and this controller turns burn rates (plus
replica lag and front-door queue pressure) into spawn/retire decisions.

It deliberately does NOT know how to spawn anything itself —
``spawn_fn`` / ``retire_fn`` are injected, so the same controller drives
batcher workers on a local :class:`~.ingress.Ingress`
(``spawn_fn=ingress.add_worker``), follower replicas in a deployment, or
a recording stub in tests.

Safety properties, in the order they bit previous systems:

* **fenced bounds** — the fleet can never leave ``[min_fleet,
  max_fleet]``; a decision the fence blocks is counted as ``clamped``
  (visible in ``kvtpu_autoscale_decisions_total``) instead of silently
  retried forever;
* **hysteresis** — one hot sample never scales; ``hysteresis_ticks``
  consecutive votes in the same direction are required, and any
  contradicting sample resets the streak;
* **cooldown** — after acting, the controller holds for ``cooldown_s``
  regardless of votes, so a scale-up gets to *work* before being judged.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from ..observe import log_event
from ..observe.fleet import ReplicaScrape, SloMonitor
from ..observe.metrics import (
    AUTOSCALE_DECISIONS_TOTAL,
    AUTOSCALE_FLEET_SIZE,
)
from ..resilience.errors import ConfigError

__all__ = ["AutoscaleConfig", "FleetAutoscaler"]


@dataclass
class AutoscaleConfig:
    """Controller tuning. Burn thresholds are in burn-rate units (1.0 =
    budget consumed exactly at the sustainable rate)."""

    #: fenced fleet bounds — the controller can never leave this range
    min_fleet: int = 1
    max_fleet: int = 4
    #: scale up when any signal crosses these
    scale_up_burn: float = 2.0
    max_lag_s: float = 2.0
    max_pressure: float = 0.8
    #: scale down only when every signal is comfortably below these
    scale_down_burn: float = 0.25
    idle_lag_s: float = 0.5
    idle_pressure: float = 0.25
    #: consecutive same-direction votes before acting
    hysteresis_ticks: int = 3
    #: seconds to hold after any spawn/retire
    cooldown_s: float = 30.0

    def validate(self) -> "AutoscaleConfig":
        if not 1 <= self.min_fleet <= self.max_fleet:
            raise ConfigError(
                f"autoscale fence must satisfy 1 <= min_fleet <= max_fleet, "
                f"got min={self.min_fleet} max={self.max_fleet}"
            )
        return self


class FleetAutoscaler:
    """Hysteresis + cooldown + fence around injected spawn/retire hooks.

    ``spawn_fn()`` grows the fleet by one, ``retire_fn()`` shrinks it by
    one; both may return the resulting size (used when they do, tracked
    locally when they return None)."""

    def __init__(
        self,
        spawn_fn: Callable[[], Optional[int]],
        retire_fn: Callable[[], Optional[int]],
        *,
        config: Optional[AutoscaleConfig] = None,
        initial_fleet: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = (config or AutoscaleConfig()).validate()
        self._spawn = spawn_fn
        self._retire = retire_fn
        self._clock = clock
        self._lock = threading.Lock()
        self.fleet_size = max(self.config.min_fleet, int(initial_fleet))
        self._up_votes = 0
        self._down_votes = 0
        self._last_action_ts: Optional[float] = None
        self.decisions = {
            "scale-up": 0, "scale-down": 0, "hold": 0, "clamped": 0
        }
        AUTOSCALE_FLEET_SIZE.set(float(self.fleet_size))

    # ----------------------------------------------------------- voting
    def _count(self, action: str) -> str:
        self.decisions[action] = self.decisions.get(action, 0) + 1
        AUTOSCALE_DECISIONS_TOTAL.labels(action=action).inc()
        return action

    def observe(
        self,
        *,
        burn: float = 0.0,
        lag_s: float = 0.0,
        pressure: float = 0.0,
    ) -> str:
        """Fold one sample of the three signals into the controller;
        returns the decision: ``scale-up`` / ``scale-down`` / ``hold`` /
        ``clamped``."""
        cfg = self.config
        want_up = (
            burn >= cfg.scale_up_burn
            or lag_s >= cfg.max_lag_s
            or pressure >= cfg.max_pressure
        )
        want_down = (
            burn <= cfg.scale_down_burn
            and lag_s <= cfg.idle_lag_s
            and pressure <= cfg.idle_pressure
        )
        with self._lock:
            if want_up:
                self._up_votes += 1
                self._down_votes = 0
            elif want_down:
                self._down_votes += 1
                self._up_votes = 0
            else:
                self._up_votes = 0
                self._down_votes = 0
            now = self._clock()
            cooling = (
                self._last_action_ts is not None
                and now - self._last_action_ts < cfg.cooldown_s
            )
            if cooling:
                return self._count("hold")
            if self._up_votes >= cfg.hysteresis_ticks:
                self._up_votes = 0
                if self.fleet_size >= cfg.max_fleet:
                    log_event(
                        "autoscale_clamped", direction="up",
                        fleet=self.fleet_size, max_fleet=cfg.max_fleet,
                        burn=round(burn, 3), lag_s=round(lag_s, 3),
                        pressure=round(pressure, 3),
                    )
                    return self._count("clamped")
                return self._act("scale-up", burn, lag_s, pressure)
            if self._down_votes >= cfg.hysteresis_ticks:
                self._down_votes = 0
                if self.fleet_size <= cfg.min_fleet:
                    return self._count("clamped")
                return self._act("scale-down", burn, lag_s, pressure)
            return self._count("hold")

    def _act(
        self, action: str, burn: float, lag_s: float, pressure: float
    ) -> str:
        # called with self._lock held
        fn = self._spawn if action == "scale-up" else self._retire
        delta = 1 if action == "scale-up" else -1
        reported = fn()
        self.fleet_size = (
            int(reported) if reported is not None else self.fleet_size + delta
        )
        self._last_action_ts = self._clock()
        AUTOSCALE_FLEET_SIZE.set(float(self.fleet_size))
        log_event(
            "autoscale_" + action.replace("scale-", ""),
            fleet=self.fleet_size, burn=round(burn, 3),
            lag_s=round(lag_s, 3), pressure=round(pressure, 3),
        )
        return self._count(action)

    # ------------------------------------------------------- convenience
    def observe_fleet(
        self,
        monitor: SloMonitor,
        scrapes: Sequence[ReplicaScrape],
        *,
        window_s: float = 300.0,
        pressure: float = 0.0,
    ) -> str:
        """One tick from live signals: the worst burn rate across the
        monitor's objectives over ``window_s``, the worst reported
        replica lag (a down replica counts as ``max_lag_s`` — it is at
        least that far behind), and the caller's queue pressure."""
        burn = 0.0
        for o in monitor.objectives:
            burn = max(burn, monitor.burn_rate(o.name, window_s))
        lag = 0.0
        for s in scrapes:
            if not s.ok:
                lag = max(lag, self.config.max_lag_s)
            elif s.lag_seconds is not None:
                lag = max(lag, s.lag_seconds)
        return self.observe(burn=burn, lag_s=lag, pressure=pressure)

    def describe(self) -> dict:
        with self._lock:
            return {
                "fleet_size": self.fleet_size,
                "fence": [self.config.min_fleet, self.config.max_fleet],
                "decisions": dict(self.decisions),
                "up_votes": self._up_votes,
                "down_votes": self._down_votes,
            }
