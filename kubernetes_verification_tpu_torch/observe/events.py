"""Structured JSON event lines on the ``kvtpu`` logger.

One event per line, ``{"event": ..., "ts": ..., **fields}`` — grep-able from
a pod log, parse-able by anything. The logger stays silent until either the
host configures logging itself or ``configure_logging()`` attaches the
stderr handler (idempotently: calling it twice must not double-print, which
the seed version did).

Every line is stamped from ONE clock source (:class:`Clock`, injectable via
``set_clock`` for tests): ``ts`` is wall time (comparable across processes,
the ordering key ``kv-tpu trace`` uses) and ``perf`` is the monotonic
counter (meaningful only within a process, immune to wall-clock steps).
A context provider — installed by ``observe.spans`` — can add trace-context
fields (``trace_id``/``span_id``) to every line without this module
importing spans (which imports us).
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Callable, Dict, Optional

__all__ = [
    "logger",
    "configure_logging",
    "log_event",
    "Clock",
    "get_clock",
    "set_clock",
    "set_context_provider",
]

logger = logging.getLogger("kvtpu")

#: marker attribute stamped on handlers we own, so repeat calls (and tests)
#: can find and skip/remove them
_HANDLER_MARK = "_kvtpu_handler"


class Clock:
    """The one time source observability stamps from: ``wall()`` for
    cross-process ordering, ``perf()`` for intra-process durations. Tests
    subclass and ``set_clock`` a deterministic pair."""

    def wall(self) -> float:
        return time.time()

    def perf(self) -> float:
        return time.perf_counter()


_clock = Clock()

#: optional () -> dict callable merged under every event line; spans.py
#: installs one that contributes trace_id/span_id so the wire-level trace
#: context reaches logs this module never knew about
_context_provider: Optional[Callable[[], Dict[str, object]]] = None


def get_clock() -> Clock:
    return _clock


def set_clock(clock: Optional[Clock]) -> Clock:
    """Install (or with None, reset) the shared clock; returns the active
    one so tests can restore it."""
    global _clock
    _clock = clock if clock is not None else Clock()  # kvtpu: ignore[concurrency-hygiene] single atomic reference rebind; readers tolerate either value
    return _clock


def set_context_provider(provider) -> None:
    """Install (or clear, with None) the trace-context field provider."""
    global _context_provider
    _context_provider = provider  # kvtpu: ignore[concurrency-hygiene] single atomic reference rebind; readers tolerate either value


def configure_logging(level: int = logging.INFO, stream=None) -> logging.Handler:
    """Attach a line-per-event stream handler to the ``kvtpu`` logger.

    Idempotent: a handler this function attached earlier is reused (its
    level/stream updated) instead of stacking a duplicate that would print
    every event twice. Returns the handler so callers can detach it.
    """
    handler: Optional[logging.Handler] = None
    for h in logger.handlers:
        if getattr(h, _HANDLER_MARK, False):
            handler = h
            break
    if handler is None:
        handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
        setattr(handler, _HANDLER_MARK, True)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
    elif stream is not None:
        handler.setStream(stream)
    handler.setLevel(level)
    logger.setLevel(level)
    return handler


def log_event(event: str, **fields) -> None:
    """Emit one JSON event line (INFO) on the ``kvtpu`` logger."""
    if not logger.isEnabledFor(logging.INFO):
        return
    line = {"event": event, "ts": _clock.wall(), "perf": _clock.perf()}
    if _context_provider is not None:
        try:
            line.update(_context_provider())
        except Exception:  # context must never fail the event it decorates
            pass
    line.update(fields)
    logger.info(json.dumps(line))
