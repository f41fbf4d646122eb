"""Observability core of the PyTorch port.

The port's copy of the framework-free core of
``kubernetes_verification_tpu.observe``, which every serving module imports:

* ``REGISTRY`` / ``MetricsRegistry`` — process-global counters, gauges,
  fixed-bucket histograms (``registry``); the shared families live in
  ``metrics`` (all of the JAX package's families, under the same names).
* ``trace`` / ``Span`` / ``Phases`` — nested wall-clock spans that feed the
  registry, emit JSON event lines, and annotate ``torch.profiler`` traces
  (``spans``); ``profile_to`` / ``capture_profile`` write Chrome traces.
* ``log_event`` / ``configure_logging`` and the injectable ``Clock`` — the
  JSON event stream (``events``).
* ``TRACE_HEADER`` / ``trace_headers`` / ``parse_trace_header`` /
  ``trace_context`` — distributed-trace context over the wire (``spans``).
* ``FlightRecorder`` / ``trigger_dump`` — the crash flight recorder
  (``flight``).
* ``ProgressTicker`` / ``active_jobs`` / ``render_jobs`` — pass-boundary
  progress of long host loops (``progress``).
* ``to_prometheus`` / ``parse_prometheus`` / ``dump_registry`` — the
  exporters (``export``).
* ``scrape_replica`` / ``SloMonitor`` / ``render_fleet`` — fleet scraping
  and SLO burn rates (``fleet``).

This package's registry is its own: a process that imports both packages
holds two registries, and each package's counters count only its own work.
The rest of the JAX package's ``observe`` (AOT packs, sentinels, cost
introspection, dispatch tracking, bench history and telemetry) is not part
of the port yet.
"""
from __future__ import annotations

from . import fleet, flight, metrics, progress
from .events import (
    Clock,
    configure_logging,
    get_clock,
    log_event,
    logger,
    set_clock,
)
from .export import (
    dump_registry,
    parse_exemplars,
    parse_prometheus,
    to_prometheus,
    write_metrics,
)
from .fleet import (
    ReplicaScrape,
    SloMonitor,
    SloObjective,
    parse_slo_spec,
    render_fleet,
    scrape_replica,
)
from .flight import (
    FlightRecorder,
    load_dump,
    render_dump,
    trigger_dump,
)
from .flight import install_from_env as install_flight_recorder_from_env
from .progress import ProgressTicker, active_jobs, eta_bar, render_jobs
from .registry import (
    DEFAULT_BUCKETS,
    METRIC_NAME_RE,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from .spans import (
    PROFILE_DIR_ENV,
    TRACE_HEADER,
    Phases,
    Span,
    add_span_sink,
    capture_profile,
    current_span,
    current_trace_id,
    install_profile_from_env,
    install_profile_signal,
    load_capture_manifest,
    parse_trace_header,
    profile_to,
    remove_span_sink,
    set_memory_hook,
    trace,
    trace_context,
    trace_headers,
    trace_to_dir,
    uninstall_profile_signal,
)

__all__ = [
    "metrics",
    "flight",
    "configure_logging",
    "log_event",
    "logger",
    "Clock",
    "get_clock",
    "set_clock",
    "DEFAULT_BUCKETS",
    "METRIC_NAME_RE",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Phases",
    "Span",
    "current_span",
    "current_trace_id",
    "profile_to",
    "trace_to_dir",
    "trace",
    "set_memory_hook",
    "TRACE_HEADER",
    "trace_headers",
    "trace_context",
    "parse_trace_header",
    "add_span_sink",
    "remove_span_sink",
    "FlightRecorder",
    "install_flight_recorder_from_env",
    "trigger_dump",
    "load_dump",
    "render_dump",
    "PROFILE_DIR_ENV",
    "capture_profile",
    "load_capture_manifest",
    "install_profile_signal",
    "uninstall_profile_signal",
    "install_profile_from_env",
    "fleet",
    "progress",
    "dump_registry",
    "to_prometheus",
    "write_metrics",
    "parse_prometheus",
    "parse_exemplars",
    "ReplicaScrape",
    "scrape_replica",
    "render_fleet",
    "SloObjective",
    "SloMonitor",
    "parse_slo_spec",
    "ProgressTicker",
    "active_jobs",
    "render_jobs",
    "eta_bar",
]
