"""Per-kernel cost/memory introspection by analytic accounting.

The port's copy of ``kubernetes_verification_tpu.observe.introspect``. The
JAX package reads what a compiled XLA program costs from
``compiled.cost_analysis()`` / ``memory_analysis()``; torch compiles no
program whose cost could be read back, so here every dispatch site that
publishes hands over a **cost function** that returns its exact operation
and byte counts (``publish_compiled``; ``source="analytic"`` where the JAX
package writes ``"xla"``). The two hand kernels count theirs next to their
wrappers (``ops/kernels.py::packed_dir_allow_cost`` /
``fused_ports_reach_cost``) and every other int8 product of the port
through ``ops/closure.py::bool_dot`` (``2·M·K·N``). A dispatch site without
a cost function publishes no report: never a guessed one, never a zero.
The reports are folded into a structured ``KernelCostReport`` with an
arithmetic-intensity figure positioned against a per-platform roofline
ridge, and ``analytic_bound`` turns one into the least time the card could
take (the bound ``chip_smoke.py`` prints beside every kernel's time).

Publishing is **off by default** and explicitly enabled
(``set_introspection(True)`` or ``KVTPU_INTROSPECT=1``), as in the JAX
package; while it is off every publisher is a no-op, and a cost function
that raises logs an event and never reaches the solve.

Pure-host backends (cpu, datalog, native) publish analytic
order-of-magnitude estimates through ``publish_host_estimate``
(``source=host-estimate`` marks those rows), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from .events import log_event
from .metrics import (
    COST_REPORTS_TOTAL,
    KERNEL_BYTES_ACCESSED,
    KERNEL_FLOPS,
    KERNEL_PEAK_BYTES,
    ROOFLINE_ACHIEVED_MACS_PER_SECOND,
    ROOFLINE_PCT_OF_PEAK,
)

__all__ = [
    "KernelCostReport",
    "introspection_enabled",
    "set_introspection",
    "publish_compiled",
    "publish_host_estimate",
    "maybe_publish",
    "reports",
    "reports_dict",
    "clear_reports",
    "format_cost_table",
    "roofline_ridge",
    "device_peak_macs_per_s",
    "roofline_rows",
    "format_roofline_table",
    "device_bytes_per_s",
    "analytic_bound",
    "H100_SXM",
]

#: Machine-balance ridge points (operations per byte at which a kernel flips
#: from memory- to compute-bound), per platform. GPU: the H100 SXM's dense
#: int8 tensor-core peak (1,979 TOPS) over its HBM3 rate (3.35 TB/s), from
#: NVIDIA's H100 data sheet. CPU: order of a server core's FMA throughput
#: over DRAM bandwidth. Coarse by design — the table labels a kernel
#: "memory"- or "compute"-bound, not a percent. The port never runs on a
#: TPU, so it keeps no TPU ridge.
_RIDGE_FLOPS_PER_BYTE = {"gpu": 1979e12 / 3.35e12, "cpu": 10.0, "host": 10.0}

_ENV_FLAG = "KVTPU_INTROSPECT"

_lock = threading.RLock()
_enabled: Optional[bool] = None  # None = defer to the env var
_reports: Dict[Tuple[str, str, object], "KernelCostReport"] = {}


@dataclasses.dataclass(frozen=True)
class KernelCostReport:
    """Structured cost/memory summary of one compiled dispatch site."""

    engine: str
    fn: str
    platform: str
    source: str  # "analytic" (a dispatch site's cost function) | "host-estimate"
    flops: int
    bytes_accessed: int
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    peak_bytes: int
    generated_code_bytes: int = 0

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per byte of memory traffic — the roofline x-axis."""
        return self.flops / self.bytes_accessed if self.bytes_accessed else 0.0

    @property
    def ridge_flops_per_byte(self) -> float:
        return roofline_ridge(self.platform)

    @property
    def roofline_bound(self) -> str:
        """Which roofline the kernel sits under on its platform."""
        ridge = self.ridge_flops_per_byte
        if not self.flops or not self.bytes_accessed:
            return "n/a"
        return "compute" if self.arithmetic_intensity >= ridge else "memory"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["arithmetic_intensity"] = round(self.arithmetic_intensity, 4)
        d["ridge_flops_per_byte"] = self.ridge_flops_per_byte
        d["roofline_bound"] = self.roofline_bound
        return d


def roofline_ridge(platform: str) -> float:
    return _RIDGE_FLOPS_PER_BYTE.get(platform, _RIDGE_FLOPS_PER_BYTE["host"])


#: the device name ``torch.cuda.get_device_name()`` reports for an H100 SXM5
H100_SXM = "NVIDIA H100 80GB HBM3"

#: Published dense tensor-core peaks, in MACs/s (= published TOPS / 2: one
#: MAC is a multiply + an add), keyed by ``torch.cuda.get_device_name()``
#: prefix (longest prefix wins). Source: NVIDIA's H100 Tensor Core GPU data
#: sheet, dense (not sparse) figures — H100 SXM: int8 1,979 TOPS, bf16
#: 989.4 TFLOP/s; H100 PCIe: int8 1,513 TOPS, bf16 756 TFLOP/s. The port
#: never runs on a TPU, so the table holds no TPU row.
_PEAK_MACS_PER_S = {
    H100_SXM: {"int8": 1979e12 / 2, "bf16": 989.4e12 / 2},
    "NVIDIA H100 SXM": {"int8": 1979e12 / 2, "bf16": 989.4e12 / 2},
    "NVIDIA H100 PCIe": {"int8": 1513e12 / 2, "bf16": 756e12 / 2},
}

#: Published memory rates, bytes/s, by the same prefixes (same data sheet:
#: SXM 3.35 TB/s HBM3, PCIe 2 TB/s HBM2e).
_PEAK_BYTES_PER_S = {
    H100_SXM: 3.35e12,
    "NVIDIA H100 SXM": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def _longest_prefix(table: dict, device_kind: Optional[str]):
    if not device_kind:
        return None
    best = None
    for prefix, value in table.items():
        if device_kind.startswith(prefix):
            if best is None or len(prefix) > len(best[0]):
                best = (prefix, value)
    return best[1] if best else None


def device_peak_macs_per_s(
    device_kind: Optional[str], dtype: str = "int8"
) -> Optional[float]:
    """Published tensor-core peak for a device name (longest-prefix match
    over the table above), or ``None`` for unknown devices — callers fall
    back to the sentinel-calibrated or analytic host peak."""
    peaks = _longest_prefix(_PEAK_MACS_PER_S, device_kind)
    return None if peaks is None else peaks.get(dtype)


def device_bytes_per_s(device_kind: Optional[str]) -> Optional[float]:
    """Published memory rate for a device name (longest-prefix match), or
    ``None`` for unknown devices."""
    return _longest_prefix(_PEAK_BYTES_PER_S, device_kind)


def analytic_bound(
    flops: float, bytes_accessed: float, device_kind: str, dtype: str = "int8"
) -> Tuple[float, str]:
    """``(seconds, bound_by)``: the least time ``device_kind`` could take
    for ``flops`` operations and ``bytes_accessed`` bytes — the larger of
    the operations over the published peak and the bytes over the published
    memory rate — and which of the two (``"operations"`` / ``"bytes"``)
    sets it. Raises ``KeyError`` for a device with no published peak."""
    macs = device_peak_macs_per_s(device_kind, dtype)
    rate = device_bytes_per_s(device_kind)
    if macs is None or rate is None:
        # kvtpu: ignore[error-taxonomy] a lookup miss in the published-peak table, documented as KeyError like a dict's; callers (chip_smoke, the tests) key on it
        raise KeyError(f"no published peak for {device_kind!r} ({dtype})")
    t_ops, t_bytes = float(flops) / (2.0 * macs), float(bytes_accessed) / rate
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _analytic_host_peak() -> float:
    """Order-of-magnitude host MAC peak: cores × ~2.5 GHz × 16 int8
    MACs/cycle (one 128-bit FMA pipe's worth). Deliberately coarse — it
    exists so a ``pct_of_peak`` on an unknown host is a bounded estimate
    instead of a division by zero."""
    cores = os.cpu_count() or 1
    return float(cores) * 2.5e9 * 16.0


def _roofline_peak(rec: dict) -> Tuple[float, str]:
    """(peak MACs/s, source) for one history record: the published device
    table when the model is known, else the record's own
    sentinel-calibrated matmul peak, else the analytic host estimate."""
    peak = device_peak_macs_per_s(rec.get("device"))
    if peak:
        return peak, f"peak-table[{rec.get('device')}]"
    sentinel = rec.get("sentinel")
    if isinstance(sentinel, dict):
        try:
            cal = float(sentinel.get("calibrated_peak_macs_per_s", 0.0))
        except (TypeError, ValueError):
            cal = 0.0
        if cal > 0.0:
            return cal, "sentinel-calibrated"
    return _analytic_host_peak(), "analytic-host"


def roofline_rows(runs: List[dict]) -> List[dict]:
    """Achieved-vs-peak accounting over a bench history: for the newest
    record of every mode that carries a MAC count (``macs``, stamped by
    the bench driver) and a steady-state seconds figure, convert measured
    throughput into achieved MACs/s and position it against the device
    peak (published table → sentinel-calibrated → analytic host). Updates
    the ``kvtpu_roofline_*`` gauges as a side effect."""
    newest: Dict[str, dict] = {}
    for rec in runs:
        try:
            macs = float(rec["macs"])
            steady = float(rec["steady_s"])
        except (KeyError, TypeError, ValueError):
            continue
        if macs <= 0.0 or steady <= 0.0:
            continue
        mode = rec.get("mode") or str(rec.get("metric", "?"))
        newest[mode] = rec  # later records win: history order is oldest-first
    rows = []
    for mode, rec in sorted(newest.items()):
        macs = float(rec["macs"])
        steady = float(rec["steady_s"])
        achieved = macs / steady
        peak, source = _roofline_peak(rec)
        pct = 100.0 * achieved / peak if peak else 0.0
        ROOFLINE_ACHIEVED_MACS_PER_SECOND.labels(mode=mode).set(achieved)
        ROOFLINE_PCT_OF_PEAK.labels(mode=mode).set(pct)
        rows.append(
            {
                "mode": mode,
                "metric": rec.get("metric"),
                "device": rec.get("device"),
                "platform": rec.get("platform"),
                "macs": macs,
                "steady_s": steady,
                "achieved_macs_per_s": achieved,
                "peak_macs_per_s": peak,
                "peak_source": source,
                "pct_of_peak": round(pct, 2),
                "macs_basis": rec.get("macs_basis"),
            }
        )
    return rows


def format_roofline_table(rows: List[dict]) -> str:
    """Fixed-width roofline table (the roofline body of an ``explain``
    report). Empty string when no record carries MAC accounting."""
    if not rows:
        return ""
    header = (
        "mode", "device", "achieved MACs/s", "peak MACs/s", "% peak",
        "peak source", "basis",
    )
    out = [header]
    for r in rows:
        out.append(
            (
                str(r["mode"]),
                str(r.get("device") or "?"),
                _fmt_count(r["achieved_macs_per_s"]),
                _fmt_count(r["peak_macs_per_s"]),
                f"{r['pct_of_peak']:.1f}%",
                str(r["peak_source"]),
                str(r.get("macs_basis") or ""),
            )
        )
    widths = [max(len(row[i]) for row in out) for i in range(len(header))]
    lines = []
    for ri, row in enumerate(out):
        lines.append(
            "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)).rstrip()
        )
        if ri == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


# ------------------------------------------------------------------ gating
def introspection_enabled() -> bool:
    if _enabled is not None:
        return _enabled
    return os.environ.get(_ENV_FLAG, "").lower() not in ("", "0", "false")


def set_introspection(on: bool) -> None:
    """Force introspection on/off for this process (overrides the
    KVTPU_INTROSPECT env var)."""
    global _enabled
    with _lock:
        _enabled = bool(on)


# ------------------------------------------------------------- publishing
def _store(key: Tuple[str, str, object], rep: KernelCostReport) -> None:
    with _lock:
        _reports[key] = rep
    KERNEL_FLOPS.labels(engine=rep.engine, fn=rep.fn).set(rep.flops)
    KERNEL_BYTES_ACCESSED.labels(engine=rep.engine, fn=rep.fn).set(
        rep.bytes_accessed
    )
    KERNEL_PEAK_BYTES.labels(engine=rep.engine, fn=rep.fn).set(rep.peak_bytes)
    COST_REPORTS_TOTAL.labels(
        engine=rep.engine, fn=rep.fn, source=rep.source
    ).inc()
    log_event(
        "kernel_cost_report",
        engine=rep.engine,
        fn=rep.fn,
        source=rep.source,
        flops=rep.flops,
        bytes_accessed=rep.bytes_accessed,
        peak_bytes=rep.peak_bytes,
        bound=rep.roofline_bound,
    )


def _counts(cost) -> dict:
    """A cost function's result as a dict: ``{"flops", "bytes_accessed",
    ...}`` as given, or a ``(flops, bytes_accessed)`` pair."""
    if isinstance(cost, dict):
        return cost
    flops, nbytes = cost
    return {"flops": flops, "bytes_accessed": nbytes}


def _platform() -> str:
    torch = sys.modules.get("torch")
    try:
        if torch is not None and torch.cuda.is_initialized():
            return "gpu"
    except Exception:
        pass
    return "cpu"


def publish_compiled(
    engine: str,
    fn: str,
    cost: Callable[[], object],
    signature: object = None,
) -> Optional[KernelCostReport]:
    """Evaluate a zero-arg ``cost`` function (returning the dispatch's exact
    ``(flops, bytes_accessed)``, or a dict with those keys and optionally
    ``argument_bytes`` / ``output_bytes`` / ``temp_bytes`` /
    ``platform``), and cache the report per (engine, fn, signature). No-op
    when introspection is disabled; never raises — a cost function that
    fails logs an event and returns None."""
    if not introspection_enabled():
        return None
    key = (engine, fn, signature)
    with _lock:
        if key in _reports:
            return _reports[key]
    try:
        c = _counts(cost())
        arg_b = int(c.get("argument_bytes", 0) or 0)
        out_b = int(c.get("output_bytes", 0) or 0)
        tmp_b = int(c.get("temp_bytes", 0) or 0)
        rep = KernelCostReport(
            engine=engine,
            fn=fn,
            platform=str(c.get("platform") or _platform()),
            source="analytic",
            flops=int(c["flops"]),
            bytes_accessed=int(c["bytes_accessed"]),
            argument_bytes=arg_b,
            output_bytes=out_b,
            temp_bytes=tmp_b,
            peak_bytes=arg_b + out_b + tmp_b,
        )
    except Exception as e:  # accounting must never break the solve path
        log_event(
            "introspect_error", engine=engine, fn=fn, error=f"{type(e).__name__}: {e}"
        )
        return None
    _store(key, rep)
    return rep


def maybe_publish(
    engine: str,
    fn: str,
    cost: Optional[Callable[[], object]],
    args: Tuple = (),
    kwargs: Optional[dict] = None,
) -> Optional[KernelCostReport]:
    """Publish a cost report for one dispatch of ``fn`` on ``args`` /
    ``kwargs``, keyed by the operands' abstract signature, with the counts
    ``cost()`` returns. For dispatch sites without a ``DispatchTracker``
    (the sharded ops' per-call sweeps); cheap no-op when introspection is
    off, and no report at all when the site has no cost function."""
    if cost is None or not introspection_enabled():
        return None
    from .jit import abstract_signature

    kwargs = kwargs or {}
    sig = (
        abstract_signature(args),
        tuple(sorted((k, abstract_signature(v)) for k, v in kwargs.items())),
    )
    return publish_compiled(engine, fn, cost, signature=sig)


def _host_peak_bytes() -> int:
    """Peak RSS of this process — the host analogue of peak HBM."""
    try:
        import resource
        import sys

        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return int(ru) * (1 if sys.platform == "darwin" else 1024)
    except Exception:  # pragma: no cover - resource is POSIX-only
        return 0


def publish_host_estimate(
    engine: str,
    fn: str,
    *,
    flops: int,
    bytes_accessed: int,
    argument_bytes: int = 0,
    output_bytes: int = 0,
    temp_bytes: int = 0,
    signature: object = None,
) -> Optional[KernelCostReport]:
    """Analytic cost report for a pure-host kernel (no device program): the
    caller supplies order-of-magnitude FLOP/byte counts from
    its problem shape; peak memory falls back to process peak RSS."""
    if not introspection_enabled():
        return None
    key = (engine, fn, signature)
    with _lock:
        if key in _reports:
            return _reports[key]
    rep = KernelCostReport(
        engine=engine,
        fn=fn,
        platform="host",
        source="host-estimate",
        flops=int(flops),
        bytes_accessed=int(bytes_accessed),
        argument_bytes=int(argument_bytes),
        output_bytes=int(output_bytes),
        temp_bytes=int(temp_bytes),
        peak_bytes=_host_peak_bytes(),
    )
    _store(key, rep)
    return rep


# -------------------------------------------------------------- reporting
def reports() -> List[KernelCostReport]:
    """All published reports, in publication order."""
    with _lock:
        return list(_reports.values())


def reports_dict() -> List[dict]:
    """JSON-ready report list (what a bench driver attaches to its result line)."""
    return [r.to_dict() for r in reports()]


def clear_reports() -> None:
    with _lock:
        _reports.clear()


def _fmt_count(v: float) -> str:
    """Engineering-style count: 0, 999, 1.2e6."""
    v = float(v)
    if v == 0:
        return "0"
    if abs(v) < 1e4:
        return str(int(v)) if v == int(v) else f"{v:.1f}"
    return f"{v:.2e}"


def _fmt_bytes(v: float) -> str:
    v = float(v)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(v) < 1024 or unit == "TiB":
            return f"{v:.0f}{unit}" if unit == "B" else f"{v:.1f}{unit}"
        v /= 1024
    return f"{v:.1f}TiB"  # pragma: no cover - unreachable


def format_cost_table(reps: Optional[List[KernelCostReport]] = None) -> str:
    """Fixed-width per-kernel cost/memory table (the body of an ``explain``
    report). Empty string when nothing was published."""
    reps = reports() if reps is None else list(reps)
    if not reps:
        return ""
    header = (
        "engine", "kernel", "src", "flops", "bytes", "flops/B",
        "bound", "peak", "args", "out", "temp",
    )
    rows = [header]
    for r in reps:
        rows.append(
            (
                r.engine,
                r.fn,
                r.source if r.source == "analytic" else "host",
                _fmt_count(r.flops),
                _fmt_bytes(r.bytes_accessed),
                _fmt_count(round(r.arithmetic_intensity, 2)),
                r.roofline_bound,
                _fmt_bytes(r.peak_bytes),
                _fmt_bytes(r.argument_bytes),
                _fmt_bytes(r.output_bytes),
                _fmt_bytes(r.temp_bytes),
            )
        )
    widths = [max(len(row[i]) for row in rows) for i in range(len(header))]
    lines = []
    for ri, row in enumerate(rows):
        lines.append(
            "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)).rstrip()
        )
        if ri == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)
