"""Flight recorder: a bounded in-memory ring of recent spans and event
lines plus a metric-delta baseline, dumped to ``flight-<ts>.json`` when the
process hits trouble — a ``KvTpuError`` escalating out of a CLI command, a
circuit breaker opening, a fault-injection kill-point firing (the dump
lands before ``os._exit``), or an operator ``SIGUSR2``.

The point is post-mortem without prearranged logging: a SIGKILLed leader's
last ~512 observability records survive on disk even when nobody pointed
``--log-json`` anywhere. The recorder is passive until :func:`install` is
called (``kv-tpu --flight DIR``, or ``KVTPU_FLIGHT_DIR`` in subprocess
harnesses); every trigger seam in the codebase calls
:func:`trigger_dump`, which is a no-op while nothing is installed.

Capture taps:

* a span sink (``observe.spans.add_span_sink``) records every closed span
  with its trace identity, so a dump is also a partial trace;
* a ``logging.Handler`` on the ``kvtpu`` logger records every JSON event
  line (the recorder parses them back so the dump holds structured data);
* the registry is snapshotted at install and diffed at dump time — the
  ``metric_deltas`` section shows what this process *did*, not its
  lifetime totals.
"""
from __future__ import annotations

import collections
import json
import logging
import os
import signal
import threading
from typing import Dict, List, Optional

from .events import get_clock, log_event, logger
from .metrics import FLIGHT_DUMPS_TOTAL
from .registry import REGISTRY
from .spans import Span, add_span_sink, remove_span_sink

__all__ = [
    "FlightRecorder",
    "install",
    "uninstall",
    "installed",
    "trigger_dump",
    "recent_dumps",
    "load_dump",
    "render_dump",
    "FLIGHT_SCHEMA",
    "FLIGHT_DIR_ENV",
]

FLIGHT_SCHEMA = "kvtpu-flight-v1"

#: environment variable subprocess harnesses (bench workers, chaos
#: children) use to arm the recorder without plumbing a CLI flag through
FLIGHT_DIR_ENV = "KVTPU_FLIGHT_DIR"

DEFAULT_CAPACITY = 512


def _json_safe(value):
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        return repr(value)


class _RingHandler(logging.Handler):
    """Captures every ``kvtpu`` event line into the recorder's ring."""

    def __init__(self, recorder: "FlightRecorder") -> None:
        super().__init__(level=logging.INFO)
        self._recorder = recorder

    def emit(self, record) -> None:  # pragma: no cover - trivial dispatch
        try:
            self._recorder._record_event(record.getMessage())
        except Exception:
            pass  # the recorder must never fail the code it observes


class FlightRecorder:
    """Bounded ring of recent observability records for one process."""

    def __init__(
        self, directory: str, capacity: int = DEFAULT_CAPACITY
    ) -> None:
        self.directory = directory
        self.capacity = int(capacity)
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._handler: Optional[_RingHandler] = None
        self._baseline = self._scalar_snapshot()
        self._dumps = 0

    # -- capture taps ----------------------------------------------------

    def _record_span(self, span: Span) -> None:
        entry = {
            "kind": "span",
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "start_ts": span.start_wall,
            "seconds": span.seconds,
            "ok": span.ok,
            "attrs": {k: _json_safe(v) for k, v in span.attrs.items()},
        }
        with self._lock:
            self._ring.append(entry)

    def _record_event(self, line: str) -> None:
        try:
            payload = json.loads(line)
        except (ValueError, TypeError):
            payload = {"raw": line}
        # span/phase closes already arrive via the span sink with richer
        # identity; recording their event line too would halve capacity
        if payload.get("event") in ("span", "phase"):
            return
        with self._lock:
            self._ring.append({"kind": "event", "data": payload})

    @staticmethod
    def _scalar_snapshot() -> Dict[str, Dict[str, float]]:
        d = REGISTRY.dump(include_buckets=False)
        return {
            "counters": {
                name: dict(children)
                for name, children in d.get("counters", {}).items()
            },
            "gauges": {
                name: dict(children)
                for name, children in d.get("gauges", {}).items()
            },
        }

    def _metric_deltas(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        now = self._scalar_snapshot()
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for section in ("counters", "gauges"):
            deltas: Dict[str, Dict[str, float]] = {}
            base = self._baseline.get(section, {})
            for name, children in now[section].items():
                fam_base = base.get(name, {})
                changed = {
                    key: round(value - fam_base.get(key, 0.0), 9)
                    for key, value in children.items()
                    if value != fam_base.get(key, 0.0)
                }
                if changed:
                    deltas[name] = changed
            out[section] = deltas
        return out

    # -- lifecycle -------------------------------------------------------

    def attach(self) -> None:
        add_span_sink(self._record_span)
        self._handler = _RingHandler(self)
        logger.addHandler(self._handler)
        # log_event() gates on isEnabledFor(INFO); an unconfigured process
        # would record nothing — exactly the process the recorder exists
        # for. Opening the logger level is safe: Python's last-resort
        # handler only prints WARNING+, so nothing leaks to stderr.
        self._prev_level = logger.level
        if not logger.isEnabledFor(logging.INFO):
            logger.setLevel(logging.INFO)

    def detach(self) -> None:
        remove_span_sink(self._record_span)
        if self._handler is not None:
            logger.removeHandler(self._handler)
            self._handler = None
        prev = getattr(self, "_prev_level", None)
        if prev is not None:
            logger.setLevel(prev)
            self._prev_level = None

    # -- dumping ---------------------------------------------------------

    def dump(self, trigger: str, info: Optional[dict] = None) -> str:
        """Write the ring to ``flight-<ts>.json`` in the recorder's
        directory (atomically — a reaper reading mid-crash never sees a
        torn file) and return the path."""
        clock = get_clock()
        ts = clock.wall()
        with self._lock:
            entries = list(self._ring)
            self._dumps += 1
            seq = self._dumps
        payload = {
            "schema": FLIGHT_SCHEMA,
            "trigger": trigger,
            "info": {k: _json_safe(v) for k, v in (info or {}).items()},
            "ts": ts,
            "pid": os.getpid(),
            "capacity": self.capacity,
            "entries": entries,
            "metric_deltas": self._metric_deltas(),
        }
        os.makedirs(self.directory, exist_ok=True)
        name = f"flight-{int(ts * 1000)}-{os.getpid()}-{seq}.json"
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        FLIGHT_DUMPS_TOTAL.labels(trigger=trigger).inc()
        log_event("flight_dump", trigger=trigger, path=path, entries=len(entries))
        return path


_RECORDER: Optional[FlightRecorder] = None
_prev_sigusr2 = None


def installed() -> Optional[FlightRecorder]:
    return _RECORDER


def install(
    directory: str,
    capacity: int = DEFAULT_CAPACITY,
    with_signal: bool = True,
) -> FlightRecorder:
    """Arm the process-global flight recorder writing into ``directory``.

    Idempotent per directory: re-installing replaces the previous
    recorder (its taps are detached first). ``SIGUSR2`` is bound to an
    on-demand dump when possible (main thread, platform with the signal);
    elsewhere the recorder still dumps on the programmatic triggers."""
    global _RECORDER, _prev_sigusr2
    uninstall()
    rec = FlightRecorder(directory, capacity=capacity)
    rec.attach()
    _RECORDER = rec  # kvtpu: ignore[concurrency-hygiene] single atomic reference rebind; trigger_dump tolerates either value
    if with_signal and hasattr(signal, "SIGUSR2"):

        def _handler(signum, frame):
            trigger_dump("sigusr2")
            # chain any pre-existing Python handler: arming the recorder
            # must not silently disable another subsystem's SIGUSR2
            prev = _prev_sigusr2
            if callable(prev):
                prev(signum, frame)

        try:
            _prev_sigusr2 = signal.signal(signal.SIGUSR2, _handler)  # kvtpu: ignore[concurrency-hygiene] install/uninstall run on the main thread only
        except ValueError:  # not the main thread — programmatic triggers only
            _prev_sigusr2 = None  # kvtpu: ignore[concurrency-hygiene] install/uninstall run on the main thread only
    return rec


def uninstall() -> None:
    """Disarm the recorder (tests; also the first half of re-install)."""
    global _RECORDER, _prev_sigusr2
    if _RECORDER is not None:
        _RECORDER.detach()
        _RECORDER = None  # kvtpu: ignore[concurrency-hygiene] single atomic reference rebind; trigger_dump tolerates either value
    if _prev_sigusr2 is not None and hasattr(signal, "SIGUSR2"):
        try:
            signal.signal(signal.SIGUSR2, _prev_sigusr2)
        except ValueError:
            pass
        _prev_sigusr2 = None  # kvtpu: ignore[concurrency-hygiene] install/uninstall run on the main thread only


def install_from_env() -> Optional[FlightRecorder]:
    """Arm the recorder from ``KVTPU_FLIGHT_DIR`` when set — the hook
    subprocess harnesses (bench workers, chaos children) call at startup."""
    directory = os.environ.get(FLIGHT_DIR_ENV)
    if not directory:
        return None
    return install(directory)


def trigger_dump(trigger: str, **info) -> Optional[str]:
    """Dump the ring if a recorder is installed; returns the dump path or
    None. Never raises — every caller sits on an error path already."""
    rec = _RECORDER
    if rec is None:
        return None
    try:
        return rec.dump(trigger, info)
    except Exception:  # pragma: no cover - disk-full etc. on a crash path
        return None


# -- reading dumps back (kv-tpu recover / tests) -------------------------


def recent_dumps(
    directory: Optional[str] = None, limit: int = 5
) -> List[str]:
    """Newest-first ``flight-*.json`` paths under ``directory`` (default:
    the installed recorder's directory, else ``KVTPU_FLIGHT_DIR``); [] when
    nothing is armed or nothing was dumped — the list ``/healthz`` and
    ``kv-tpu top`` surface."""
    if directory is None:
        rec = _RECORDER
        directory = rec.directory if rec is not None else os.environ.get(
            FLIGHT_DIR_ENV
        )
    if not directory:
        return []
    try:
        names = [
            n
            for n in os.listdir(directory)
            if n.startswith("flight-") and n.endswith(".json")
        ]
    except OSError:
        return []
    names.sort(reverse=True)
    return [os.path.join(directory, n) for n in names[: max(limit, 0)]]


def load_dump(path: str) -> dict:
    """Parse a flight dump; raises ValueError on schema mismatch."""
    with open(path) as fh:
        payload = json.load(fh)
    if payload.get("schema") != FLIGHT_SCHEMA:
        # kvtpu: ignore[error-taxonomy] documented parse contract: callers (kv-tpu recover) map it to a per-file error entry
        raise ValueError(
            f"{path}: not a flight dump (schema={payload.get('schema')!r})"
        )
    return payload


def render_dump(payload: dict) -> List[str]:
    """Human-readable lines for one dump — trigger header, the recent
    entries oldest-first, then the metric deltas."""
    lines = [
        f"flight dump: trigger={payload.get('trigger')} "
        f"pid={payload.get('pid')} ts={payload.get('ts'):.3f} "
        f"entries={len(payload.get('entries', []))}"
    ]
    info = payload.get("info") or {}
    if info:
        detail = " ".join(f"{k}={v}" for k, v in sorted(info.items()))
        lines.append(f"  {detail}")
    for entry in payload.get("entries", []):
        if entry.get("kind") == "span":
            ok = "" if entry.get("ok", True) else " FAILED"
            lines.append(
                f"  span  {entry.get('name')} "
                f"{(entry.get('seconds') or 0.0) * 1000:.3f}ms "
                f"trace={entry.get('trace_id')}{ok}"
            )
        else:
            data = entry.get("data", {})
            rest = {
                k: v for k, v in data.items() if k not in ("event", "ts", "perf")
            }
            detail = " ".join(f"{k}={v}" for k, v in sorted(rest.items()))
            lines.append(f"  event {data.get('event')} {detail}".rstrip())
    deltas = payload.get("metric_deltas", {})
    for section in ("counters", "gauges"):
        for name, children in sorted(deltas.get(section, {}).items()):
            for key, value in sorted(children.items()):
                label = f"{{{key}}}" if key else ""
                lines.append(f"  delta {name}{label} {value:+g}")
    return lines
