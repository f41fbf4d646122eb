"""The program's own spans in a traced window, on the device trace's clock.

While a ``torch.profiler`` records, the port's ``observe.spans`` keeps every
span it closes (``profiled_spans``: name, ids, ``time.time_ns()`` at open
and close, attrs), and ``time.time_ns()`` is the clock of the profiler's own
events. This module keeps the spans that lie inside a run's traced window
(``run.trace.window``) and reads two things from them: the self time of a
span name a step, and the device's idle time inside a span name's intervals
a step (``run.trace.busy()``, the card's busy intervals).

With the loops (``loops/``) and ``adapter.py``, one of the modules of the
benchmark that import the program. A program that keeps no span log gives
no spans, and every helper here then gives ``None``.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional

try:
    from kubernetes_verification_tpu_torch.observe.spans import (
        profiled_spans,
        profiled_spans_dropped,
    )
except ImportError:  # a program without the span log
    profiled_spans = profiled_spans_dropped = None


def window_spans(run) -> Optional[List]:
    """The program's spans that opened and closed inside the run's traced
    window; ``None`` without a trace or a span log, and where the log
    dropped spans past its bound (every reading would come out short)."""
    if run.trace is None or profiled_spans is None or not run.steps:
        return None
    if profiled_spans_dropped():
        return None
    lo, hi = (int(t * 1e9) for t in run.trace.window)
    return [s for s in profiled_spans() if lo <= s.start_ns and s.end_ns <= hi]


def _named(spans: Optional[List], name: str) -> List:
    return [s for s in spans or () if s.name == name]


def self_ms(run, name: str) -> Optional[float]:
    """Milliseconds a step (a verification or a change) that spans named
    ``name`` took, less the time of their direct children."""
    spans = window_spans(run)
    named = _named(spans, name)
    if not named:
        return None
    child_ns: Dict[str, int] = {}
    for s in spans:
        if s.parent_id is not None:
            child_ns[s.parent_id] = child_ns.get(s.parent_id, 0) + s.end_ns - s.start_ns
    own = sum(s.end_ns - s.start_ns - child_ns.get(s.span_id, 0) for s in named)
    return own / 1e6 / len(run.steps)


def attr_per_step(run, name: str, *attrs: str) -> Optional[float]:
    """The sum of ``attrs`` over the spans named ``name``, a step."""
    named = _named(window_spans(run), name)
    if not named:
        return None
    return sum(sum(s.attrs.get(a, 0) for a in attrs) for s in named) / len(run.steps)


def idle_ms(run, name: str) -> Optional[float]:
    """Milliseconds a step in which the card ran nothing while the host was
    inside a span named ``name``; ``None`` where the trace saw no device
    (the CPU)."""
    named = _named(window_spans(run), name)
    if not named or not run.trace.device:
        return None
    busy = run.trace.busy()  # merged, in order
    ends = [e for _, e in busy]
    idle = 0.0
    for s in named:
        a, b = s.start_ns / 1e9, s.end_ns / 1e9
        idle += b - a
        i = bisect.bisect_right(ends, a)
        while i < len(busy) and busy[i][0] < b:
            idle -= min(b, busy[i][1]) - max(a, busy[i][0])
            i += 1
    return 1e3 * idle / len(run.steps)
