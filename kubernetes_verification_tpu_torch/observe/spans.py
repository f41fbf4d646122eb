"""Spans: nested wall-clock regions that feed the registry, the JSON event
stream, and — while a ``torch.profiler`` capture runs — the profiler trace.

The PyTorch port's copy of ``kubernetes_verification_tpu.observe.spans``.
Only the profiler hooks differ: the annotation is a torch record function
(``_device_annotation``), ``profile_to`` / ``capture_profile``
run ``torch.profiler.profile`` and write a Chrome trace
(``<host>.pt.trace.json``) where the JAX package's profiler writes its
TensorBoard trace, and spans closed while a profiler records are kept in
``profiled_spans``.

``trace("solve", backend="tpu")`` is the one instrumentation primitive the
rest of the codebase uses. Each span:

* times the region and observes ``kvtpu_span_seconds{name=...}``;
* emits one JSON event line (with ``ok: false`` added when the body raised,
  instead of pretending the phase completed);
* nests via a thread-local stack, so events carry ``parent`` and depth;
* carries distributed-trace identity: a ``trace_id`` shared by every span
  of one logical operation (across processes, via the ``X-Kvtpu-Trace``
  header), its own ``span_id``, and ``parent_id`` linking it to its caller
  — the caller may live in another process (``trace_context`` adopts the
  parsed wire context so server-side spans parent under the client span);
* records itself in the profiler's trace while a profiler is enabled (a
  host-side record function: ``_device_annotation`` says why not a
  user-scope ``record_function``), so the same names line up in a trace
  captured via ``profile_to``. torch is looked up in ``sys.modules`` and
  the annotation is skipped when no profiler runs, so an untraced span
  pays no profiler call;
* while a profiler records, is also kept in a bounded in-process log
  (``profiled_spans``), stamped with ``time.time_ns()`` at open and close —
  the clock of the profiler's own events — so a reader of the same profile
  can put each device interval down to the program stage the host was in.

``trace_if_read`` is ``trace`` for hot paths (an engine's change): it opens
a full span only where something reads closed spans — a profiler, a span
sink or the event log — and an unrecorded one otherwise.

Timestamps come from the one injectable clock in ``observe.events``: event
lines carry wall ``ts`` (cross-process orderable) and monotonic ``perf``
(duration-stable within a process), so ``kv-tpu trace`` reassembles
timelines without guessing which clock a line was stamped from.

``Phases`` keeps the seed's accumulate-into-a-dict API (backends still hand
``VerifyResult.timings`` to callers) but is now a thin layer over spans.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

from .events import get_clock, log_event, set_context_provider
from .events import logger as _event_logger
from .metrics import PROFILE_CAPTURES_TOTAL, SPAN_SECONDS
from .registry import set_exemplar_provider

__all__ = [
    "Span",
    "trace",
    "trace_if_read",
    "current_span",
    "current_trace_id",
    "trace_context",
    "TRACE_HEADER",
    "trace_headers",
    "format_trace_header",
    "parse_trace_header",
    "add_span_sink",
    "remove_span_sink",
    "LoggedSpan",
    "PROFILED_SPANS_MAX",
    "profiled_spans",
    "profiled_spans_dropped",
    "clear_profiled_spans",
    "Phases",
    "profile_to",
    "trace_to_dir",
    "set_memory_hook",
    "PROFILE_DIR_ENV",
    "capture_profile",
    "load_capture_manifest",
    "install_profile_signal",
    "uninstall_profile_signal",
    "install_profile_from_env",
    "reset_profile_rate_limit",
]

#: HTTP header carrying trace context over the wire: ``<trace_id>-<span_id>``
#: (two lowercase-hex tokens). The receiver's spans adopt the trace id and
#: parent under the sender's span id.
TRACE_HEADER = "X-Kvtpu-Trace"

_state = threading.local()

#: optional () -> int callable returning live memory bytes; when installed
#: (``telemetry.install_span_memory_hook``) every span records
#: ``mem_enter_bytes``/``mem_exit_bytes`` in its event line
_memory_hook = None

#: callables handed every closed Span — the flight recorder's ring and the
#: bench stage collector subscribe here instead of parsing event lines
_span_sinks: list = []


#: the bound of the profile-bound span log; spans closed past it are counted
#: in ``profiled_spans_dropped()`` instead
PROFILED_SPANS_MAX = 1 << 18


class LoggedSpan(NamedTuple):
    """One span closed while a torch profiler recorded, stamped with
    ``time.time_ns()`` at open and at close: the clock of the profiler's
    events, so a reader can put each device interval of the same profile
    down to the program stage the host was in."""

    name: str
    start_ns: int
    end_ns: int
    attrs: Dict[str, object]
    span_id: str
    parent_id: Optional[str]


_profiled_lock = threading.Lock()
_profiled_log: List[LoggedSpan] = []
_profiled_dropped = 0


def profiled_spans() -> List[LoggedSpan]:
    """The spans closed while a profiler recorded, in closing order."""
    with _profiled_lock:
        return list(_profiled_log)


def profiled_spans_dropped() -> int:
    """Spans closed while a profiler recorded, past the log's bound."""
    return _profiled_dropped


def clear_profiled_spans() -> None:
    """Empty the profile-bound span log and its dropped count."""
    global _profiled_dropped
    with _profiled_lock:
        _profiled_log.clear()
        _profiled_dropped = 0


def _log_profiled(entry: LoggedSpan) -> None:
    global _profiled_dropped
    with _profiled_lock:
        if len(_profiled_log) < PROFILED_SPANS_MAX:
            _profiled_log.append(entry)
        else:
            _profiled_dropped += 1


def set_memory_hook(hook) -> None:
    """Install (or clear, with None) the span memory snapshot hook."""
    global _memory_hook
    _memory_hook = hook  # kvtpu: ignore[concurrency-hygiene] single atomic reference rebind; span readers tolerate either value


def add_span_sink(sink) -> None:
    """Subscribe ``sink(span)`` to every span close (append-only list —
    registration is rare; iteration tolerates concurrent appends)."""
    _span_sinks.append(sink)


def remove_span_sink(sink) -> None:
    """Unsubscribe a sink previously added; missing sinks are ignored."""
    try:
        _span_sinks.remove(sink)
    except ValueError:
        pass


def _memory_bytes():
    if _memory_hook is None:
        return None
    try:
        return int(_memory_hook())
    except Exception:  # telemetry must never fail a traced region
        return None


def _stack() -> list:
    st = getattr(_state, "spans", None)
    if st is None:
        st = _state.spans = []
    return st


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


@dataclass
class Span:
    """One timed region. ``seconds``/``ok`` are filled when it closes."""

    name: str
    attrs: Dict[str, object] = field(default_factory=dict)
    parent: Optional["Span"] = None
    seconds: Optional[float] = None
    ok: bool = True
    trace_id: str = ""
    span_id: str = ""
    parent_id: Optional[str] = None
    start_wall: Optional[float] = None

    @property
    def depth(self) -> int:
        return 0 if self.parent is None else self.parent.depth + 1


def current_span() -> Optional[Span]:
    st = _stack()
    return st[-1] if st else None


def current_trace_id() -> Optional[str]:
    """The trace id spans opened *now* would join: the active span's, else
    an adopted remote context's, else None (a fresh root would mint one)."""
    span = current_span()
    if span is not None:
        return span.trace_id
    remote = getattr(_state, "remote", None)
    return remote[0] if remote else None


@contextlib.contextmanager
def trace_context(
    trace_id: Optional[str], parent_span_id: Optional[str] = None
) -> Iterator[None]:
    """Adopt a remote trace context for the duration of the block: root
    spans opened inside join ``trace_id`` and parent under
    ``parent_span_id`` instead of minting a fresh trace. A None
    ``trace_id`` is a no-op block, so callers can pass the (possibly
    absent) parsed header straight through."""
    if not trace_id:
        yield
        return
    prev = getattr(_state, "remote", None)
    _state.remote = (trace_id, parent_span_id)
    try:
        yield
    finally:
        _state.remote = prev


def format_trace_header(trace_id: str, span_id: str) -> str:
    return f"{trace_id}-{span_id}"


def parse_trace_header(value: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """``(trace_id, parent_span_id)`` from an ``X-Kvtpu-Trace`` value;
    ``(None, None)`` for absent or malformed headers (never raises — a bad
    header must not fail the request it rode in on)."""
    if not value:
        return None, None
    head, sep, tail = value.strip().partition("-")
    if not sep or not head or not tail:
        return None, None
    try:
        int(head, 16), int(tail, 16)
    except ValueError:
        return None, None
    return head, tail


def trace_headers() -> Dict[str, str]:
    """Headers to stamp on an outgoing request: ``{TRACE_HEADER: ...}``
    when a trace is active on this thread, ``{}`` otherwise. Always pass
    this to ``conn.request(..., headers=trace_headers())`` — the
    trace-context lint counts un-headered requests as findings."""
    span = current_span()
    if span is not None:
        return {TRACE_HEADER: format_trace_header(span.trace_id, span.span_id)}
    remote = getattr(_state, "remote", None)
    if remote and remote[0]:
        return {TRACE_HEADER: format_trace_header(remote[0], remote[1] or "0")}
    return {}


def _trace_fields() -> Dict[str, object]:
    """Context-provider body for ``log_event``: every event line emitted
    inside a traced region carries the trace/span ids, even when the
    emitting module has never heard of spans."""
    span = current_span()
    if span is not None:
        return {"trace_id": span.trace_id, "span_id": span.span_id}
    remote = getattr(_state, "remote", None)
    if remote and remote[0]:
        return {"trace_id": remote[0]}
    return {}


set_context_provider(_trace_fields)
# histograms retain the slowest-in-window trace id per bucket; the registry
# cannot import us (cycle), so it receives the trace-id source here
set_exemplar_provider(current_trace_id)


def _profiling() -> bool:
    """Whether a torch profiler records now; torch is looked up, never
    imported here."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return bool(torch.autograd._profiler_enabled())
    except Exception:
        return False


def _device_annotation(name: str, profiling: Optional[bool] = None):
    """The span's record in the profiler's trace while a profiler records,
    else a null context. A function-scope record (``_RecordFunctionFast``;
    a torch without it gets no record, and the span log still keeps the
    span), never ``record_function``'s user scope: the profiler mirrors a
    user-scope range onto the card as one interval from its first kernel to
    its last, idle gaps included, which a reader of the device trace would
    count as busy time."""
    if not (_profiling() if profiling is None else profiling):
        return contextlib.nullcontext()
    try:
        torch = sys.modules["torch"]
        fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
        return fast(name) if fast is not None else contextlib.nullcontext()
    except Exception:
        return contextlib.nullcontext()


def _profiler_activities(tprof) -> list:
    """CPU activity always, CUDA activity when a device is present."""
    import torch

    acts = [tprof.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(tprof.ProfilerActivity.CUDA)
    return acts


def _trace_file(run_dir: str) -> str:
    """``<run_dir>/<host>.pt.trace.json`` — one Chrome trace per capture."""
    import socket

    os.makedirs(run_dir, exist_ok=True)
    return os.path.join(run_dir, f"{socket.gethostname()}.pt.trace.json")


@contextlib.contextmanager
def trace(name: str, _event: str = "span", **attrs) -> Iterator[Span]:
    """Open a nested span; yields the live ``Span`` so callers can attach
    attrs mid-flight (``span.attrs["rounds"] = r``)."""
    parent = current_span()
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        remote = getattr(_state, "remote", None)
        if remote and remote[0]:
            trace_id, parent_id = remote
        else:
            trace_id, parent_id = _new_id(8), None
    clock = get_clock()
    span = Span(
        name=name,
        attrs=dict(attrs),
        parent=parent,
        trace_id=trace_id,
        span_id=_new_id(4),
        parent_id=parent_id,
        start_wall=clock.wall(),
    )
    mem0 = _memory_bytes()
    if mem0 is not None:
        span.attrs["mem_enter_bytes"] = mem0
    _stack().append(span)
    profiling = _profiling()
    start_ns = time.time_ns() if profiling else 0
    t0 = clock.perf()
    try:
        with _device_annotation(name, profiling):
            yield span
    except BaseException:
        span.ok = False
        raise
    finally:
        span.seconds = clock.perf() - t0
        if profiling:
            _log_profiled(LoggedSpan(
                name, start_ns, time.time_ns(), span.attrs, span.span_id,
                span.parent_id,
            ))
        _stack().pop()
        SPAN_SECONDS.labels(name=name).observe(span.seconds)
        mem1 = _memory_bytes()
        if mem1 is not None:
            span.attrs["mem_exit_bytes"] = mem1
        if _event_logger.isEnabledFor(logging.INFO):  # else log_event drops it
            fields = dict(span.attrs)
            fields.update(
                name=name,
                seconds=span.seconds,
                trace_id=span.trace_id,
                span_id=span.span_id,
                start_ts=span.start_wall,
            )
            if span.parent_id is not None:
                fields["parent_id"] = span.parent_id
            if span.parent is not None:
                fields["parent"] = span.parent.name
                fields["depth"] = span.depth
            if not span.ok:
                fields["ok"] = False
            log_event(_event, **fields)
        for sink in list(_span_sinks):
            try:
                sink(span)
            except Exception:  # a broken sink must not fail traced work
                pass


class _Unrecorded:
    """The span ``trace_if_read`` opens where nothing reads spans: its
    attrs go nowhere."""

    __slots__ = ("attrs",)

    def __init__(self, attrs: Dict[str, object]) -> None:
        self.attrs = attrs

    def __enter__(self) -> "_Unrecorded":
        return self

    def __exit__(self, *exc) -> bool:
        return False


def trace_if_read(name: str, **attrs):
    """``trace(name, **attrs)`` where something reads closed spans (a torch
    profiler records, a span sink is installed, or the ``kvtpu`` event log
    is on), else an unrecorded span: no ids, no nesting, no histogram. For
    spans on a hot path, an engine's change of a few ms: there a full span
    costs about 0.1 ms with the host's caches cold, three a change."""
    if _span_sinks or _event_logger.isEnabledFor(logging.INFO) or _profiling():
        return trace(name, **attrs)
    return _Unrecorded(attrs)


class Phases:
    """Accumulate named phase timings (``encode``/``compile``/``solve``)
    into a dict — the shape ``VerifyResult.timings`` has always carried —
    while each phase also runs as a full span (registry + events + device
    annotation). Timings accumulate even when the body raises, and the
    emitted ``phase`` event then carries ``ok: false``. Uses the same
    injectable clock the spans themselves stamp from.
    """

    def __init__(self, prefix: str = "") -> None:
        """``prefix`` goes before each phase's name in its span's name (an
        engine's build: ``engine.build.``), not in ``timings``."""
        self.timings: Dict[str, float] = {}
        self.prefix = prefix

    @contextlib.contextmanager
    def __call__(self, name: str, **attrs) -> Iterator[Span]:
        clock = get_clock()
        t0 = clock.perf()
        try:
            with trace(self.prefix + name, _event="phase", **attrs) as span:
                yield span
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (
                clock.perf() - t0
            )


@contextlib.contextmanager
def profile_to(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``log_dir``: one Chrome trace
    at ``<log_dir>/plugins/profile/<run>/<host>.pt.trace.json`` (the run
    layout of a TensorBoard profile directory), with CPU activity and, when
    a device is present, CUDA activity.

    Degrades to a no-op — one hint line on stderr plus a
    ``profile_skipped`` event — when torch's profiler is unavailable or
    cannot start, instead of failing the whole command. Creates
    ``log_dir``."""
    try:
        import torch.profiler as tprof
    except Exception:  # pragma: no cover - exercised only without torch
        log_event("profile_skipped", reason="torch unavailable", log_dir=log_dir)
        yield
        return

    os.makedirs(log_dir, exist_ok=True)
    try:
        prof = tprof.profile(activities=_profiler_activities(tprof))
        prof.__enter__()
    except Exception as e:
        print(
            f"kv-tpu: --profile unsupported on this platform "
            f"({type(e).__name__}: {e}); continuing without a device trace",
            file=sys.stderr,
        )
        log_event(
            "profile_skipped",
            reason=f"{type(e).__name__}: {e}",
            log_dir=log_dir,
        )
        yield
        return
    log_event("profile_start", log_dir=log_dir)
    ok = True
    path = None
    try:
        yield
    finally:
        try:
            prof.__exit__(None, None, None)
            run = time.strftime("%Y_%m_%d_%H_%M_%S", time.gmtime())
            path = _trace_file(
                os.path.join(log_dir, "plugins", "profile", run)
            )
            prof.export_chrome_trace(path)
        except Exception as e:
            ok = False
            print(
                f"kv-tpu: --profile capture failed "
                f"({type(e).__name__}: {e}); no trace written to {log_dir}",
                file=sys.stderr,
            )
            log_event(
                "profile_skipped",
                reason=f"{type(e).__name__}: {e}",
                log_dir=log_dir,
            )
        if ok:
            log_event("profile_done", log_dir=log_dir, trace=path)


#: the older name of the same facility
trace_to_dir = profile_to


# ---------------------------------------------------- on-demand deep capture
#: environment variable arming the SIGUSR1 capture handler in subprocess
#: harnesses (same regime as the flight recorder's KVTPU_FLIGHT_DIR)
PROFILE_DIR_ENV = "KVTPU_PROFILE_DIR"

#: minimum seconds between completed captures (override with
#: KVTPU_PROFILE_MIN_INTERVAL or a ``min_interval`` argument): a scrape
#: loop hammering /profile must not keep the device profiler permanently
#: on
DEFAULT_CAPTURE_MIN_INTERVAL = 30.0

#: bound on one capture window — /profile?seconds=N is operator-facing and
#: a typo must not profile for an hour
MAX_CAPTURE_SECONDS = 60.0

CAPTURE_MANIFEST = "manifest.json"

_capture_lock = threading.Lock()
_last_capture_perf: Optional[float] = None


def reset_profile_rate_limit() -> None:
    """Forget the last capture time (tests; also after reconfiguring the
    interval)."""
    global _last_capture_perf
    with _capture_lock:
        _last_capture_perf = None


def _capture_min_interval(min_interval: Optional[float]) -> float:
    if min_interval is not None:
        return float(min_interval)
    raw = os.environ.get("KVTPU_PROFILE_MIN_INTERVAL")
    try:
        return float(raw) if raw else DEFAULT_CAPTURE_MIN_INTERVAL
    except ValueError:
        return DEFAULT_CAPTURE_MIN_INTERVAL


def _capture_file_count(path: str) -> int:
    total = 0
    for _dir, _sub, files in os.walk(path):
        total += len(files)
    return total


def load_capture_manifest(capture_dir: str) -> list:
    """The capture dir's manifest entries (newest last); [] when no capture
    has completed there."""
    try:
        with open(os.path.join(capture_dir, CAPTURE_MANIFEST)) as fh:
            entries = json.load(fh)
    except (OSError, ValueError):
        return []
    return entries if isinstance(entries, list) else []


def _append_manifest(capture_dir: str, entry: dict) -> None:
    # caller holds _capture_lock; atomic replace so a reader mid-capture
    # never sees a torn manifest
    entries = load_capture_manifest(capture_dir)
    entries.append(entry)
    path = os.path.join(capture_dir, CAPTURE_MANIFEST)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(entries, fh, indent=2, sort_keys=True)
        fh.write("\n")
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def capture_profile(
    seconds: float,
    *,
    trigger: str = "api",
    capture_dir: Optional[str] = None,
    min_interval: Optional[float] = None,
) -> dict:
    """One bounded ``torch.profiler`` capture: start a profiler, wait
    ``seconds`` (clamped to :data:`MAX_CAPTURE_SECONDS`), stop it, write its
    Chrome trace into ``<capture_dir>/capture-<ms>-<trigger>/`` and record
    the capture in ``<capture_dir>/manifest.json``. CUDA activity is
    device-wide; CPU operators are those of the profiled process.

    Returns a JSON-safe outcome dict and never raises: ``ok`` (path,
    seconds, file count), ``rate-limited`` (a capture completed less than
    ``min_interval`` ago — the device is not re-profiled), or ``skipped``
    (torch's profiler unavailable or failing; the triggering surface stays
    up).
    Completed captures count into
    ``kvtpu_profile_captures_total{trigger}``."""
    global _last_capture_perf
    seconds = min(max(float(seconds), 0.01), MAX_CAPTURE_SECONDS)
    capture_dir = (
        capture_dir
        or os.environ.get(PROFILE_DIR_ENV)
        or os.path.join(os.getcwd(), "kvtpu-profiles")
    )
    interval = _capture_min_interval(min_interval)
    with _capture_lock:
        now = get_clock().perf()
        if (
            _last_capture_perf is not None
            and now - _last_capture_perf < interval
        ):
            retry = interval - (now - _last_capture_perf)
            log_event(
                "profile_rate_limited",
                trigger=trigger,
                retry_after_s=round(retry, 3),
            )
            return {
                "outcome": "rate-limited",
                "trigger": trigger,
                "retry_after_s": round(retry, 3),
            }
        try:
            import torch.profiler as tprof
        except Exception as e:  # pragma: no cover - exercised without torch
            log_event(
                "profile_skipped", trigger=trigger,
                reason=f"{type(e).__name__}: {e}",
            )
            return {"outcome": "skipped", "trigger": trigger,
                    "reason": "torch unavailable"}
        wall = get_clock().wall()
        path = os.path.join(
            capture_dir, f"capture-{int(wall * 1000)}-{trigger}"
        )
        os.makedirs(path, exist_ok=True)
        try:
            prof = tprof.profile(activities=_profiler_activities(tprof))
            prof.start()
        except Exception as e:
            log_event(
                "profile_skipped", trigger=trigger,
                reason=f"{type(e).__name__}: {e}", path=path,
            )
            return {"outcome": "skipped", "trigger": trigger,
                    "reason": f"{type(e).__name__}: {e}"}
        time.sleep(seconds)
        try:
            prof.stop()
            prof.export_chrome_trace(_trace_file(path))
        except Exception as e:
            log_event(
                "profile_skipped", trigger=trigger,
                reason=f"{type(e).__name__}: {e}", path=path,
            )
            return {"outcome": "skipped", "trigger": trigger,
                    "reason": f"{type(e).__name__}: {e}"}
        _last_capture_perf = get_clock().perf()
        entry = {
            "path": path,
            "trigger": trigger,
            "seconds": seconds,
            "ts": wall,
            "files": _capture_file_count(path),
        }
        _append_manifest(capture_dir, entry)
    PROFILE_CAPTURES_TOTAL.labels(trigger=trigger).inc()
    log_event("profile_capture", **entry)
    return {"outcome": "ok", **entry}


_prev_sigusr1 = None
_sigusr1_config: Optional[tuple] = None
_last_sigusr1_thread: Optional[threading.Thread] = None


def install_profile_signal(
    capture_dir: Optional[str] = None,
    seconds: float = 2.0,
    min_interval: Optional[float] = None,
) -> bool:
    """Bind SIGUSR1 to a bounded profiler capture (in a worker thread — a
    signal handler must not block the main thread for the whole window).

    Chains any pre-existing Python handler: the profile capture fires AND
    the previous handler still runs, so arming deep profiling never
    disables another subsystem's signal (the flight recorder does the same
    on SIGUSR2). Returns False where signals cannot be bound (no SIGUSR1 on
    the platform, or not the main thread)."""
    global _prev_sigusr1, _sigusr1_config
    uninstall_profile_signal()
    _sigusr1_config = (capture_dir, float(seconds), min_interval)  # kvtpu: ignore[concurrency-hygiene] install/uninstall run on the main thread only
    if not hasattr(signal, "SIGUSR1"):
        return False

    def _handler(signum, frame):
        global _last_sigusr1_thread
        cfg = _sigusr1_config
        if cfg is not None:
            t = threading.Thread(
                target=capture_profile,
                args=(cfg[1],),
                kwargs={
                    "trigger": "sigusr1",
                    "capture_dir": cfg[0],
                    "min_interval": cfg[2],
                },
                daemon=True,
                name="kvtpu-profile-capture",
            )
            _last_sigusr1_thread = t  # kvtpu: ignore[concurrency-hygiene] signal handlers run on the main thread only
            t.start()
        prev = _prev_sigusr1
        if callable(prev):
            prev(signum, frame)

    try:
        _prev_sigusr1 = signal.signal(signal.SIGUSR1, _handler)  # kvtpu: ignore[concurrency-hygiene] install/uninstall run on the main thread only
    except ValueError:  # not the main thread — HTTP/CLI triggers still work
        _prev_sigusr1 = None  # kvtpu: ignore[concurrency-hygiene] install/uninstall run on the main thread only
        _sigusr1_config = None  # kvtpu: ignore[concurrency-hygiene] install/uninstall run on the main thread only
        return False
    return True


def uninstall_profile_signal() -> None:
    """Restore the previous SIGUSR1 disposition (tests; also the first half
    of re-install)."""
    global _prev_sigusr1, _sigusr1_config
    _sigusr1_config = None  # kvtpu: ignore[concurrency-hygiene] install/uninstall run on the main thread only
    if _prev_sigusr1 is not None and hasattr(signal, "SIGUSR1"):
        try:
            signal.signal(signal.SIGUSR1, _prev_sigusr1)
        except ValueError:
            pass
        _prev_sigusr1 = None  # kvtpu: ignore[concurrency-hygiene] install/uninstall run on the main thread only


def install_profile_from_env() -> bool:
    """Arm the SIGUSR1 capture handler from ``KVTPU_PROFILE_DIR`` — the
    zero-flag hook subprocess harnesses call at startup."""
    directory = os.environ.get(PROFILE_DIR_ENV)
    if not directory:
        return False
    return install_profile_signal(directory)
