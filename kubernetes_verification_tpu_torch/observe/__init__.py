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
* ``DispatchTracker`` — first-dispatch detection by abstract-shape hashing
  (``jit``).
* ``KernelCostReport`` / ``set_introspection`` / ``maybe_publish`` —
  analytic cost accounting of dispatch sites and of the two hand kernels,
  with the card's published peaks (``introspect``).
* ``memory_snapshot`` / ``start_sampler`` — live CUDA-allocator telemetry
  with host-RSS fallback (``telemetry``).
* ``append_run`` / ``check_regression`` / ``expand_derived`` — the
  bench-history store and (dispatch-deflation-aware) regression gate
  (``history``).
* ``run_calibration`` / ``SentinelSuite`` — fixed-shape compute-bound
  calibration chains timed with CUDA events, and the dispatch probe
  (``sentinel``).
* ``aot`` — the warm kernel pack: built CUDA libraries shipped with every
  checkpoint (imported from its module, as in the JAX package).

This package's registry is its own: a process that imports both packages
holds two registries, and each package's counters count only its own work.
``utils.observe`` re-exports the seed-era names from here for backward
compatibility. ``observe.__all__`` holds every name of the JAX package's.
"""
from __future__ import annotations

from . import (
    fleet,
    flight,
    history,
    introspect,
    metrics,
    progress,
    sentinel,
    telemetry,
)
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
from .history import (
    append_run,
    check_regression,
    deflate_record,
    expand_derived,
    load_runs,
)
from .introspect import (
    KernelCostReport,
    device_peak_macs_per_s,
    format_cost_table,
    format_roofline_table,
    maybe_publish,
    publish_host_estimate,
    roofline_rows,
    set_introspection,
)
from .jit import DispatchTracker, abstract_signature, tree_nbytes
from .sentinel import (
    SentinelCalibrationError,
    SentinelSuite,
    run_calibration,
    slim_context,
)
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
from .telemetry import (
    TelemetrySampler,
    format_memory_table,
    install_span_memory_hook,
    memory_snapshot,
    sample_once,
    start_sampler,
    stop_sampler,
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
    "introspect",
    "telemetry",
    "history",
    "sentinel",
    "KernelCostReport",
    "format_cost_table",
    "maybe_publish",
    "publish_host_estimate",
    "set_introspection",
    "device_peak_macs_per_s",
    "format_roofline_table",
    "roofline_rows",
    "TelemetrySampler",
    "format_memory_table",
    "install_span_memory_hook",
    "memory_snapshot",
    "sample_once",
    "start_sampler",
    "stop_sampler",
    "append_run",
    "check_regression",
    "deflate_record",
    "expand_derived",
    "load_runs",
    "SentinelCalibrationError",
    "SentinelSuite",
    "run_calibration",
    "slim_context",
    "DispatchTracker",
    "abstract_signature",
    "tree_nbytes",
]
