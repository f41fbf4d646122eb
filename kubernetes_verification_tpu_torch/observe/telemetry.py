"""Live device-memory telemetry.

The port's copy of ``kubernetes_verification_tpu.observe.telemetry``. It
samples the CUDA caching allocator of every visible card
(``torch.cuda.memory_stats(i)``: ``allocated_bytes.all.current`` /
``.peak``; ``torch.cuda.mem_get_info(i)`` for the card's total) into the
``kvtpu_hbm_bytes_in_use`` / ``kvtpu_hbm_peak_bytes`` gauges, labelled
``cuda:<i>``. A process with no CUDA device, one that has not initialised
CUDA yet, or one that never imported torch degrades to one ``device=host``
sample backed by process RSS — current from ``/proc/self/statm``, peak from
``getrusage(RUSAGE_SELF)`` — so the memory column never comes back empty.

A sample never initialises CUDA: ``torch.cuda.is_initialized()`` gates it
(a sampler thread that touched CUDA first could initialise it in a process
that later forks). Like ``spans``, this module never *imports* torch
itself: it looks the module up in ``sys.modules``. Two consumers:

* ``TelemetrySampler`` — a daemon thread sampling at a fixed interval for
  long solves (start with ``start_sampler()``);
* ``install_span_memory_hook()`` — after this, every span records
  ``mem_enter_bytes`` / ``mem_exit_bytes`` in its event line, turning the
  span stream into a coarse per-phase memory profile.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional

from .metrics import HBM_BYTES_IN_USE, HBM_PEAK_BYTES

__all__ = [
    "memory_snapshot",
    "sample_once",
    "total_bytes_in_use",
    "TelemetrySampler",
    "start_sampler",
    "stop_sampler",
    "install_span_memory_hook",
    "format_memory_table",
]


def _host_memory() -> Dict[str, int]:
    """(current, peak) RSS of this process, best effort."""
    cur = peak = 0
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        peak = int(ru) * (1 if sys.platform == "darwin" else 1024)
    except Exception:  # pragma: no cover - resource is POSIX-only
        pass
    try:
        with open("/proc/self/statm") as fh:
            cur = int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except Exception:  # pragma: no cover - non-Linux
        cur = peak
    return {"bytes_in_use": cur, "peak_bytes_in_use": max(peak, cur)}


def _cuda_entries() -> List[dict]:
    """One entry per card the process has allocated on, or none when torch
    is not loaded or CUDA is not initialised (checked before any call that
    could initialise it)."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_initialized():
            return []
        count = torch.cuda.device_count()
    except Exception:
        return []
    out: List[dict] = []
    for i in range(count):
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            stats = None
        # a card this process never allocated on has no context to read;
        # mem_get_info would create one
        if not stats or not stats.get("allocated_bytes.all.peak", 0):
            continue
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        try:
            _, total = torch.cuda.mem_get_info(i)
        except Exception:
            total = 0
        out.append(
            {
                "device": f"cuda:{i}",
                "platform": "gpu",
                "bytes_in_use": in_use,
                "peak_bytes_in_use": int(
                    stats.get("allocated_bytes.all.peak", in_use)
                ),
                "limit_bytes": int(total),
                "source": "device",
            }
        )
    return out


def memory_snapshot() -> List[dict]:
    """One entry per CUDA device with allocator stats; falls back to a
    single ``device=host`` RSS entry when no device reports any (no card,
    CUDA not initialised, or torch never imported)."""
    out = _cuda_entries()
    if not out:
        host = _host_memory()
        out.append(
            {
                "device": "host",
                "platform": "host",
                "bytes_in_use": host["bytes_in_use"],
                "peak_bytes_in_use": host["peak_bytes_in_use"],
                "limit_bytes": 0,
                "source": "host-rss",
            }
        )
    return out


def sample_once() -> List[dict]:
    """Take a snapshot and publish it to the HBM gauges."""
    snap = memory_snapshot()
    for entry in snap:
        HBM_BYTES_IN_USE.labels(device=entry["device"]).set(
            entry["bytes_in_use"]
        )
        HBM_PEAK_BYTES.labels(device=entry["device"]).set(
            entry["peak_bytes_in_use"]
        )
    return snap


def total_bytes_in_use() -> int:
    return sum(e["bytes_in_use"] for e in memory_snapshot())


class TelemetrySampler(threading.Thread):
    """Background gauge refresher for long solves. Daemonized so a hung
    solve (or an exiting process) never blocks on it."""

    def __init__(self, interval_s: float = 0.5) -> None:
        super().__init__(name="kvtpu-telemetry", daemon=True)
        self.interval_s = float(interval_s)
        # NOT named _stop: threading.Thread owns a private _stop() method
        # that join() calls on exit — shadowing it with an Event breaks join
        self._halt = threading.Event()
        self.samples = 0

    def run(self) -> None:
        while not self._halt.is_set():
            sample_once()
            self.samples += 1
            self._halt.wait(self.interval_s)

    def stop(self, join_timeout: float = 2.0) -> None:
        self._halt.set()
        self.join(timeout=join_timeout)


_sampler: Optional[TelemetrySampler] = None
_sampler_lock = threading.Lock()


def start_sampler(interval_s: float = 0.5) -> TelemetrySampler:
    """Start (or return) the process-global background sampler."""
    global _sampler
    with _sampler_lock:
        if _sampler is None or not _sampler.is_alive():
            _sampler = TelemetrySampler(interval_s)
            _sampler.start()
        return _sampler


def stop_sampler() -> None:
    global _sampler
    with _sampler_lock:
        if _sampler is not None:
            _sampler.stop()
            _sampler = None


def install_span_memory_hook() -> None:
    """Make every span snapshot memory at enter/exit (adds
    ``mem_enter_bytes`` / ``mem_exit_bytes`` to span event lines and keeps
    the HBM gauges fresh as a side effect)."""
    from .spans import set_memory_hook

    set_memory_hook(lambda: sum(e["bytes_in_use"] for e in sample_once()))


def _fmt_bytes(v: float) -> str:
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024 or unit == "TiB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024
    return f"{v:.1f}TiB"  # pragma: no cover - unreachable


def format_memory_table(snapshot: Optional[List[dict]] = None) -> str:
    """Fixed-width device-memory table (the memory half of an ``explain``
    report)."""
    snap = memory_snapshot() if snapshot is None else snapshot
    header = ("device", "platform", "in_use", "peak", "limit", "source")
    rows = [header]
    for e in snap:
        rows.append(
            (
                e["device"],
                e["platform"],
                _fmt_bytes(e["bytes_in_use"]),
                _fmt_bytes(e["peak_bytes_in_use"]),
                _fmt_bytes(e["limit_bytes"]) if e.get("limit_bytes") else "-",
                e["source"],
            )
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    lines = []
    for ri, row in enumerate(rows):
        lines.append(
            "  ".join(c.ljust(widths[i]) for i, c in enumerate(row)).rstrip()
        )
        if ri == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
