"""Progress plane: pass-boundary instrumentation for long-running host
loops.

The PyTorch port's copy of ``kubernetes_verification_tpu.observe.progress``.

The system's longest work — packed/sharded closure squaring passes,
bounded-closure BFS levels, follower bootstrap chunk shipping, WAL replay,
checkpoint saves — runs as host-side multi-pass loops that used to be
black boxes between "started" and "done". Each such loop drives a
:class:`ProgressTicker` at every pass boundary; the ticker

* emits one structured ``progress`` event line per pass (job id, pass,
  fraction, rate, smoothed ETA) on the ``kvtpu`` logger,
* keeps the ``kvtpu_progress_*`` metric families current, and
* registers the job in a process-global table that ``kv-tpu jobs`` /
  ``kv-tpu top`` and every replica's ``/healthz`` read live.

ETA smoothing is an exponential moving average of the per-pass rate, so a
single slow stripe does not whipsaw the estimate. The ``on_pass`` callback
is the generic pass-boundary hook — pass-boundary closure checkpointing
(``ops/closure.py``) hangs off it.

Time comes from the shared injectable clock (``observe.events.set_clock``)
so tests drive rates and ETAs deterministically.
"""
from __future__ import annotations

import itertools
import math
import os
import threading
from typing import Callable, Dict, List, Optional

from .events import get_clock, log_event
from .metrics import (
    PROGRESS_ACTIVE_JOBS,
    PROGRESS_ETA_SECONDS,
    PROGRESS_FRACTION,
    PROGRESS_PASSES_TOTAL,
)

__all__ = [
    "ProgressTicker",
    "RATE_ALPHA",
    "active_jobs",
    "render_jobs",
    "eta_bar",
]

#: EMA weight of the newest per-pass rate sample: heavy enough that the
#: estimate tracks a genuine slowdown within ~3 passes, light enough that
#: one GC pause does not dominate the ETA
RATE_ALPHA = 0.4

#: in-flight jobs, job_id -> snapshot dict (what /healthz and kv-tpu jobs
#: render); finished jobs are removed, their final event line remains
_JOBS: Dict[str, dict] = {}
_JOBS_LOCK = threading.Lock()
_JOB_IDS = itertools.count(1)


def active_jobs() -> List[dict]:
    """Snapshot of every in-flight job in this process, oldest first —
    JSON-safe (the ``/healthz`` overlay embeds it verbatim)."""
    with _JOBS_LOCK:
        return [dict(snap) for snap in _JOBS.values()]


class ProgressTicker:
    """One long-running job's progress: drive :meth:`tick` at every pass
    boundary, :meth:`finish` (or use as a context manager) when done.

    ``total`` is the expected pass count when one exists (an upper bound is
    fine — closure fixpoints finish early and report ``converged``); with
    ``total=None`` the job still ticks rate and pass counts but carries no
    fraction/ETA. ``unit`` names what a pass is (``pass``, ``level``,
    ``file``, ``batch``, ``phase``) for humans reading the event stream.
    """

    def __init__(
        self,
        job: str,
        total: Optional[int] = None,
        *,
        unit: str = "pass",
        initial: int = 0,
        on_pass: Optional[Callable[[int], None]] = None,
        min_interval: float = 0.0,
    ) -> None:
        self.job = job
        # a job reporting total_passes=0 (or any non-positive total) has an
        # *unknown* extent, not a zero-length one: normalise to None so the
        # fraction/ETA math never divides by it and renderers draw the
        # indeterminate bar
        self.total = int(total) if total and int(total) > 0 else None
        self.unit = unit
        self.done = int(initial)
        self.on_pass = on_pass
        self.min_interval = float(min_interval)
        self.outcome: Optional[str] = None
        clock = get_clock()
        self._clock = clock
        self._started_ts = clock.wall()
        self._start_perf = clock.perf()
        self._last_perf = self._start_perf
        self._last_emit_perf: Optional[float] = None
        self._initial = self.done
        self.rate: Optional[float] = None  # units/second, EMA-smoothed
        self.job_id = f"{job}-{os.getpid()}-{next(_JOB_IDS)}"
        self._publish()
        log_event(
            "progress_start",
            job=self.job,
            job_id=self.job_id,
            unit=self.unit,
            done=self.done,
            total=self.total,
        )

    # ------------------------------------------------------------- core
    def tick(self, done: Optional[int] = None, **fields) -> None:
        """One pass boundary: ``done`` is the absolute completed count
        (monotone — a lower value is clamped to the current one); omitted,
        it increments by one. Extra keyword fields land on the event line.
        """
        if done is None:
            done = self.done + 1
        done = max(int(done), self.done)
        delta = done - self.done
        self.done = done
        now = self._clock.perf()
        dt = now - self._last_perf
        self._last_perf = now
        if delta > 0 and dt > 0:
            inst = delta / dt
            self.rate = (
                inst
                if self.rate is None
                else RATE_ALPHA * inst + (1.0 - RATE_ALPHA) * self.rate
            )
        PROGRESS_PASSES_TOTAL.labels(job=self.job).inc(max(delta, 0))
        self._publish()
        emit = (
            self._last_emit_perf is None
            or now - self._last_emit_perf >= self.min_interval
        )
        if emit:
            self._last_emit_perf = now
            log_event(
                "progress",
                job=self.job,
                job_id=self.job_id,
                unit=self.unit,
                done=self.done,
                total=self.total,
                fraction=self.fraction,
                rate=None if self.rate is None else round(self.rate, 6),
                eta_s=None if self.eta_s is None else round(self.eta_s, 6),
                elapsed_s=round(now - self._start_perf, 6),
                **fields,
            )
        if self.on_pass is not None:
            self.on_pass(self.done)

    def finish(self, outcome: str = "done", **fields) -> None:
        """Close the job (idempotent): final event line, gauges parked at
        complete, table entry removed."""
        if self.outcome is not None:
            return
        self.outcome = outcome
        now = self._clock.perf()
        if outcome != "error":
            PROGRESS_FRACTION.labels(job=self.job).set(1.0)
            PROGRESS_ETA_SECONDS.labels(job=self.job).set(0.0)
        with _JOBS_LOCK:
            _JOBS.pop(self.job_id, None)
            PROGRESS_ACTIVE_JOBS.set(float(len(_JOBS)))
        log_event(
            "progress_end",
            job=self.job,
            job_id=self.job_id,
            unit=self.unit,
            done=self.done,
            total=self.total,
            outcome=outcome,
            elapsed_s=round(now - self._start_perf, 6),
            **fields,
        )

    # ------------------------------------------------------- derived views
    @property
    def fraction(self) -> Optional[float]:
        if not self.total:
            return None
        return min(1.0, self.done / self.total)

    @property
    def eta_s(self) -> Optional[float]:
        """Smoothed remaining seconds: remaining passes over the EMA rate;
        None until a rate exists or when the total is unknown."""
        if not self.total or self.rate is None or self.rate <= 0:
            return None
        return max(0, self.total - self.done) / self.rate

    def _publish(self) -> None:
        fraction = self.fraction
        eta = self.eta_s
        PROGRESS_FRACTION.labels(job=self.job).set(
            -1.0 if fraction is None else fraction
        )
        PROGRESS_ETA_SECONDS.labels(job=self.job).set(
            -1.0 if eta is None else eta
        )
        snap = {
            "job": self.job,
            "job_id": self.job_id,
            "pid": os.getpid(),
            "unit": self.unit,
            "done": self.done,
            "total": self.total,
            "fraction": fraction,
            "rate": None if self.rate is None else round(self.rate, 6),
            "eta_s": None if eta is None else round(eta, 6),
            "started_ts": self._started_ts,
            "updated_ts": self._clock.wall(),
        }
        with _JOBS_LOCK:
            _JOBS[self.job_id] = snap
            PROGRESS_ACTIVE_JOBS.set(float(len(_JOBS)))

    # ------------------------------------------------------ context manager
    def __enter__(self) -> "ProgressTicker":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish("error" if exc_type is not None else "done")


# ------------------------------------------------------------- rendering
def eta_bar(fraction: Optional[float], width: int = 20) -> str:
    """``[########------------]`` for a known fraction, an indeterminate
    ``[????]`` bar otherwise — shared by ``kv-tpu jobs`` and ``kv-tpu
    top``. Anything unrenderable (None, negative, NaN/inf from a job that
    reported a zero or garbage total) is "unknown", never a raise: this
    runs inside the operator's status loop."""
    if fraction is None:
        return "[" + "?" * width + "]"
    fraction = float(fraction)
    if not math.isfinite(fraction) or fraction < 0:
        return "[" + "?" * width + "]"
    fraction = max(0.0, min(1.0, fraction))
    fill = int(round(fraction * width))
    return "[" + "#" * fill + "-" * (width - fill) + "]"


def _fmt_eta(eta: Optional[float]) -> str:
    if eta is None:
        return "-"
    eta = max(0.0, float(eta))
    if eta >= 3600:
        return f"{eta / 3600:.1f}h"
    if eta >= 60:
        return f"{eta / 60:.1f}m"
    return f"{eta:.1f}s"


def render_jobs(jobs: List[dict], bar_width: int = 20) -> List[str]:
    """One aligned row per in-flight job: id, pass counter, ETA bar, rate,
    ETA. Jobs with unknown totals render pass counts and rate only."""
    header = ("job", "unit", "done", "progress", "rate/s", "eta")
    rows = [header]
    for j in jobs:
        total = j.get("total")
        done = j.get("done", 0)
        # non-positive totals come from jobs that reported total_passes=0:
        # unknown extent — render the bare counter + indeterminate bar
        known_total = isinstance(total, (int, float)) and total > 0
        counter = f"{done}/{total}" if known_total else str(done)
        rate = j.get("rate")
        rows.append(
            (
                str(j.get("job_id", j.get("job", "-"))),
                str(j.get("unit", "pass")),
                counter,
                eta_bar(j.get("fraction"), bar_width),
                "-" if rate is None else f"{rate:.2f}",
                _fmt_eta(j.get("eta_s")),
            )
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    return [
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)).rstrip()
        for row in rows
    ]
