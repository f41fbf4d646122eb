"""The traced window: ``torch.profiler`` over the measured window, reduced to
device intervals, busy time, idle gaps and the benchmark's own host spans.

The benchmark marks its calls into the program with ``record_function``
spans named ``kvbench.<what>`` (``span``); spans inside the program are the
program's own business. Device time is the union of the intervals of every
kernel, copy and fill the profiler saw on the card.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

#: the span that covers the whole measured window
WINDOW = "kvbench.window"


def span(name: str):
    """A host span around one call into the program, on the trace's clock."""
    return torch.profiler.record_function(f"kvbench.{name}")


@dataclass
class Trace:
    """What a traced window left: device intervals ``(name, start, end)``
    and host spans ``(name, start, end)``, in seconds on one clock, and the
    window ``(start, end)`` itself."""

    device: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        """The device's busy intervals inside the window, merged."""
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        out: List[List[float]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def kernels(self, needle: str) -> List[Tuple[str, float, float]]:
        """Device intervals inside the window whose name holds ``needle``."""
        lo, hi = self.window
        return [d for d in self.device if needle in d[0] and d[1] >= lo and d[2] <= hi]

    def label_at(self, t: float) -> str:
        """The innermost benchmark span running at ``t`` on the host."""
        best: Optional[Tuple[str, float, float]] = None
        for name, s, e in self.spans:
            if name != WINDOW and s <= t <= e and (best is None or s >= best[1]):
                best = (name, s, e)
        return best[0].split(".", 1)[1] if best else "between calls"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the longest idle
        gaps of the window by what the host was doing in them."""
        lo, hi = self.window
        by_op: Dict[str, float] = {}
        for name, s, e in self.device:
            if e > lo and s < hi:
                by_op[name] = by_op.get(name, 0.0) + (min(e, hi) - max(s, lo))
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], lo
        for s, e in self.busy() + [(hi, hi)]:
            if s > prev:
                gaps.append((self.label_at((prev + s) / 2), s - prev))
            prev = max(prev, e)
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps[:top]]}


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the block when ``enabled``; yields a ``Trace`` that is filled
    when the block ends (empty when tracing is off)."""
    out = Trace()
    if not enabled:
        yield out
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield out
    # the profiler's raw events: ``prof.events()`` builds a tree of every
    # host op first, minutes for a window of churn
    for e in prof.profiler.kineto_results.events():
        name, on_card = e.name(), e.device_type() == DeviceType.CUDA
        s, t = e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9
        if name.startswith("kvbench."):
            # a span shows on the host and, as an annotation, on the device
            if not on_card:
                out.spans.append((name, s, t))
        elif on_card:
            out.device.append((name, s, t))
    win = [(s, t) for n, s, t in out.spans if n == WINDOW]
    if win:
        out.window = win[0]
