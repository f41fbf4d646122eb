"""The metrics core: a process-global registry of counters, gauges and
fixed-bucket histograms.

Design rules (enforced here, linted by ``scripts/check_metrics_names.py``):

* every metric name matches ``^kvtpu_[a-z0-9_]+$`` so the Prometheus text
  exposition stays stable across exporters;
* metric *families* are registered at module import time (one line at the
  top of the owning module), children (label combinations) materialise on
  first use — so a registry dump always names every instrument the build
  carries, even ones a particular run never touched;
* everything is plain stdlib (no jax, no numpy): the registry must be
  importable from CPU-only contexts (docs builds, the pure-NumPy oracle).

All mutation goes through a per-registry lock — the packed engines dispatch
from worker threads in serving setups, and a torn histogram bucket is the
kind of bug no differential test catches.
"""
from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "METRIC_NAME_RE",
    "DEFAULT_BUCKETS",
    "EXEMPLAR_WINDOW_SECONDS",
    "MetricsRegistry",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "set_exemplar_provider",
    "set_exemplar_counter",
]

METRIC_NAME_RE = re.compile(r"^kvtpu_[a-z0-9_]+$")
_LABEL_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")

#: Latency-shaped buckets (seconds): sub-ms dispatches through the ~5-minute
#: flagship full sweeps. Fixed at family construction — exporters rely on
#: bucket stability across a process's lifetime.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


#: Exemplar retention window (seconds): within it a bucket keeps the
#: trace_id of its *slowest* observation; once the retained exemplar ages
#: past the window any newer observation replaces it, so a scrape always
#: joins to a recent trace instead of an hours-old outlier.
EXEMPLAR_WINDOW_SECONDS = 300.0

#: () -> Optional[str] returning the active trace_id, installed by
#: ``observe.spans`` — the registry stays stdlib-only and import-cycle-free
#: (spans imports metrics imports this module) by receiving the provider
#: instead of importing it.
_exemplar_provider = None

#: .inc()-able counter (``kvtpu_trace_exemplars_total``), installed by
#: ``observe.metrics`` for the same cycle reason.
_exemplar_counter = None


def set_exemplar_provider(provider) -> None:
    """Install (or clear, with None) the trace-id source histograms consult
    when retaining bucket exemplars."""
    global _exemplar_provider
    _exemplar_provider = provider  # kvtpu: ignore[concurrency-hygiene] single atomic reference rebind; observers tolerate either value


def set_exemplar_counter(counter) -> None:
    """Install the counter bumped whenever a bucket exemplar is retained."""
    global _exemplar_counter
    _exemplar_counter = counter  # kvtpu: ignore[concurrency-hygiene] single atomic reference rebind; observers tolerate either value


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> str:
    """Canonical child key: ``k1=v1,k2=v2`` in declared label order (the
    JSON-dump form; the Prometheus exporter quotes/escapes on top)."""
    return ",".join(f"{k}={labels[k]}" for k in labelnames)


class _Child:
    """One (metric family, label combination) instrument."""

    __slots__ = ("_lock",)

    def __init__(self, lock: threading.RLock) -> None:
        self._lock = lock


class _CounterChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, lock) -> None:
        super().__init__(lock)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class _GaugeChild(_Child):
    __slots__ = ("_value",)

    def __init__(self, lock) -> None:
        super().__init__(lock)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class _HistogramChild(_Child):
    __slots__ = ("_uppers", "_counts", "_sum", "_count", "_last", "_exemplars")

    def __init__(self, lock, uppers: Tuple[float, ...]) -> None:
        super().__init__(lock)
        self._uppers = uppers  # ascending, +inf last
        self._counts = [0] * len(uppers)
        self._sum = 0.0
        self._count = 0
        self._last: Optional[float] = None
        # per-bucket (value, trace_id, wall_ts) of the slowest observation
        # inside the retention window, None where no traced observation
        # landed yet — aligned with _uppers
        self._exemplars: List[Optional[Tuple[float, str, float]]] = (
            [None] * len(uppers)
        )

    def observe(self, value: float) -> None:
        value = float(value)
        trace_id = None
        provider = _exemplar_provider
        if provider is not None:
            try:
                trace_id = provider()
            except Exception:  # the exemplar tap must never fail an observe
                trace_id = None
        retained = False
        with self._lock:
            idx = None
            for i, ub in enumerate(self._uppers):
                if value <= ub:
                    self._counts[i] += 1
                    idx = i
                    break
            self._sum += value
            self._count += 1
            self._last = value
            if trace_id is not None and idx is not None:
                ex = self._exemplars[idx]
                now = time.time()
                if (
                    ex is None
                    or value >= ex[0]
                    or now - ex[2] > EXEMPLAR_WINDOW_SECONDS
                ):
                    self._exemplars[idx] = (value, trace_id, now)
                    retained = True
        if retained and _exemplar_counter is not None:
            _exemplar_counter.inc()

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def last(self) -> Optional[float]:
        """Most recent observation — the "what did the last run measure"
        view the registry dump's ``spans`` section surfaces."""
        return self._last

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        out = []
        acc = 0
        for ub, c in zip(self._uppers, self._counts):
            acc += c
            out.append((ub, acc))
        return out

    def exemplars(self) -> List[Optional[Tuple[float, str, float]]]:
        """Per-bucket retained (value, trace_id, wall_ts), aligned with the
        bucket upper bounds; None where no traced observation landed."""
        with self._lock:
            return list(self._exemplars)


class _Metric:
    """A metric family: name + help + label schema; children per label set."""

    kind = "untyped"
    _child_cls = _CounterChild

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        *,
        registry: Optional["MetricsRegistry"] = None,
    ) -> None:
        if not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} must match {METRIC_NAME_RE.pattern}"
            )
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(f"bad label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.RLock()
        self._children: Dict[str, _Child] = {}
        if not self.labelnames:
            # unlabeled: the default child exists from birth so the family
            # shows a value (0) in every dump, used or not
            self._children[""] = self._new_child()
        reg = REGISTRY if registry is None else registry
        reg.register(self)

    def _new_child(self) -> _Child:
        return self._child_cls(self._lock)

    def labels(self, **labels: str):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}, got "
                f"{tuple(sorted(labels))}"
            )
        key = _label_key(self.labelnames, {k: str(v) for k, v in labels.items()})
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labeled {self.labelnames}; use .labels()"
            )
        return self._children[""]

    def children(self) -> Dict[str, _Child]:
        with self._lock:
            return dict(self._children)

    def reset(self) -> None:
        """Drop all children (recreating the default one when unlabeled)."""
        with self._lock:
            self._children.clear()
            if not self.labelnames:
                self._children[""] = self._new_child()


class Counter(_Metric):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_Metric):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str = "",
        labelnames: Sequence[str] = (),
        *,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        registry: Optional["MetricsRegistry"] = None,
    ) -> None:
        ubs = tuple(sorted(float(b) for b in buckets))
        if not ubs:
            raise ValueError("histogram needs at least one bucket bound")
        if ubs[-1] != float("inf"):
            ubs = ubs + (float("inf"),)
        self.buckets = ubs
        super().__init__(name, help, labelnames, registry=registry)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)


class MetricsRegistry:
    """Holds metric families; one process-global instance (``REGISTRY``)
    plus throwaway instances for tests."""

    #: the span histogram the dump's ``spans`` convenience section reads
    SPAN_METRIC = "kvtpu_span_seconds"

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def register(self, metric: _Metric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"metric {metric.name!r} already registered")
            self._metrics[metric.name] = metric

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> _Metric:
        return self._metrics[name]

    def collect(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def reset(self) -> None:
        """Zero every family (drop all labeled children). Families stay
        registered — only observations are discarded."""
        for m in self.collect():
            m.reset()

    # ------------------------------------------------------------ dumping
    def dump(self, include_buckets: bool = True) -> dict:
        """JSON-ready snapshot: every registered family, grouped by kind,
        plus a ``spans`` section derived from the span histogram (per-name
        count / total / last seconds — the "where did the solve go" view).
        """
        counters: Dict[str, dict] = {}
        gauges: Dict[str, dict] = {}
        histograms: Dict[str, dict] = {}
        for m in self.collect():
            if m.kind == "counter":
                counters[m.name] = {
                    k: c.value for k, c in m.children().items()
                }
            elif m.kind == "gauge":
                gauges[m.name] = {k: c.value for k, c in m.children().items()}
            elif m.kind == "histogram":
                fam = {}
                for k, c in m.children().items():
                    entry = {
                        "count": c.count,
                        "sum": round(c.sum, 9),
                        "last": None if c.last is None else round(c.last, 9),
                    }
                    if include_buckets:
                        entry["buckets"] = {
                            _format_le(ub): n
                            for ub, n in c.cumulative_buckets()
                        }
                    fam[k] = entry
                histograms[m.name] = fam
        out = {
            "counters": counters,
            "gauges": gauges,
            "histograms": histograms,
        }
        spans = {}
        span_fam = histograms.get(self.SPAN_METRIC, {})
        for key, entry in span_fam.items():
            # key is `name=<span name>` (single label)
            name = key.partition("=")[2] or key
            spans[name] = {
                "count": entry["count"],
                "total_seconds": entry["sum"],
                "last_seconds": entry["last"],
            }
        out["spans"] = spans
        return out


def _format_le(ub: float) -> str:
    if ub == float("inf"):
        return "+Inf"
    return repr(ub) if ub != int(ub) else str(int(ub)) + ".0"


#: The process-global registry every module-level metric family joins.
REGISTRY = MetricsRegistry()
