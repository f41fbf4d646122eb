"""Exporters: JSON registry dumps and Prometheus text exposition.

The PyTorch port's copy of ``kubernetes_verification_tpu.observe.export``.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from .registry import REGISTRY, MetricsRegistry, _format_le

__all__ = [
    "dump_registry",
    "write_metrics",
    "to_prometheus",
    "parse_prometheus",
    "parse_exemplars",
]


def dump_registry(
    registry: Optional[MetricsRegistry] = None, include_buckets: bool = True
) -> dict:
    """JSON-ready snapshot of a registry (the process-global one by
    default)."""
    reg = REGISTRY if registry is None else registry
    return reg.dump(include_buckets=include_buckets)


def write_metrics(
    path: str, registry: Optional[MetricsRegistry] = None
) -> None:
    """Write the registry to ``path`` — Prometheus text when the suffix is
    ``.prom``/``.txt``, a JSON dump otherwise."""
    reg = REGISTRY if registry is None else registry
    if path.endswith((".prom", ".txt")):
        body = to_prometheus(reg)
    else:
        body = json.dumps(reg.dump(), indent=2, sort_keys=True) + "\n"
    # scrape targets read this file concurrently: promote atomically so a
    # reader never sees a half-written exposition
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(body)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _escape(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _labels_text(child_key: str, extra: str = "") -> str:
    """``backend=cpu,mode=k8s`` (registry child key) -> ``{backend="cpu",mode="k8s"}``."""
    parts = []
    if child_key:
        for pair in child_key.split(","):
            k, _, v = pair.partition("=")
            parts.append(f'{k}="{_escape(v)}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def to_prometheus(
    registry: Optional[MetricsRegistry] = None, *, exemplars: bool = False
) -> str:
    """Render the registry in the Prometheus text exposition format
    (version 0.0.4): HELP/TYPE headers, one sample per line, histograms as
    cumulative ``_bucket{le=...}`` plus ``_sum``/``_count``.

    With ``exemplars=True``, bucket lines that retained a slowest-in-window
    exemplar grow an OpenMetrics annotation (`` # {trace_id="..."} value
    ts``) — opt-in, so the default output stays byte-identical for parsers
    that predate exemplar support."""
    reg = REGISTRY if registry is None else registry
    lines = []
    for m in reg.collect():
        lines.append(f"# HELP {m.name} {_escape(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        children = m.children()
        for key in sorted(children):
            child = children[key]
            if m.kind == "histogram":
                per_bucket = child.exemplars() if exemplars else None
                for i, (ub, n) in enumerate(child.cumulative_buckets()):
                    le = f'le="{_format_le(ub)}"'
                    line = f"{m.name}_bucket{_labels_text(key, le)} {n}"
                    ex = per_bucket[i] if per_bucket else None
                    if ex is not None:
                        value, trace_id, ts = ex
                        line += (
                            f' # {{trace_id="{_escape(trace_id)}"}} '
                            f"{_num(value)} {ts:.3f}"
                        )
                    lines.append(line)
                lines.append(
                    f"{m.name}_sum{_labels_text(key)} {_num(child.sum)}"
                )
                lines.append(
                    f"{m.name}_count{_labels_text(key)} {child.count}"
                )
            else:
                lines.append(
                    f"{m.name}{_labels_text(key)} {_num(child.value)}"
                )
    return "\n".join(lines) + "\n"


def _parse_labels(text: str) -> dict:
    """``backend="cpu",mode="k8s"`` -> dict, honoring the exposition
    escapes ``\\\\``, ``\\"`` and ``\\n``."""
    labels: dict = {}
    i, n = 0, len(text)
    while i < n:
        eq = text.index("=", i)
        name = text[i:eq].strip().lstrip(",").strip()
        assert text[eq + 1] == '"', f"unquoted label value near {text[eq:]!r}"
        j = eq + 2
        out = []
        while j < n:
            c = text[j]
            if c == "\\" and j + 1 < n:
                nxt = text[j + 1]
                out.append({"n": "\n"}.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                break
            out.append(c)
            j += 1
        labels[name] = "".join(out)
        i = j + 1
    return labels


def parse_prometheus(text: str) -> dict:
    """Inverse of :func:`to_prometheus`, for the fleet scraper: parse a
    text-exposition body into ``{sample_name: [(labels, value), ...]}``.

    Histogram series keep their expanded names (``*_bucket``/``_sum``/
    ``_count``) — the fleet table reads plain gauges and counters, so no
    re-bucketing is attempted. Unparseable lines are skipped rather than
    failing the whole scrape (a replica mid-restart may truncate)."""
    samples: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # drop any OpenMetrics exemplar annotation — the sample value is
        # everything before it, and pre-exemplar parsers must keep working
        cut = line.rfind(" # {")
        if cut != -1:
            line = line[:cut].rstrip()
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                label_text, _, value_text = rest.rpartition("}")
                labels = _parse_labels(label_text)
            else:
                name, _, value_text = line.partition(" ")
                labels = {}
            value = float(value_text.strip().replace("+Inf", "inf"))
        except Exception:
            continue
        samples.setdefault(name.strip(), []).append((labels, value))
    return samples


def parse_exemplars(text: str) -> list:
    """Extract the OpenMetrics exemplar annotations from a text exposition
    (the ``to_prometheus(..., exemplars=True)`` / ``/metrics?exemplars=1``
    form): one dict per annotated sample line with the sample ``name``, its
    ``labels``, the ``exemplar`` labels (``trace_id``), the exemplar
    ``value`` (the observation, not the cumulative bucket count) and its
    wall ``ts``. Unparseable lines are skipped — same contract as
    :func:`parse_prometheus`."""
    out: list = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        cut = line.rfind(" # {")
        if cut == -1:
            continue
        sample, annotation = line[:cut].rstrip(), line[cut + len(" # ") :]
        try:
            if "{" in sample:
                name, rest = sample.split("{", 1)
                label_text, _, _ = rest.rpartition("}")
                labels = _parse_labels(label_text)
            else:
                name, _, _ = sample.partition(" ")
                labels = {}
            ex_text, _, tail = annotation.lstrip("{").partition("}")
            ex_labels = _parse_labels(ex_text) if ex_text else {}
            parts = tail.split()
            value = float(parts[0].replace("+Inf", "inf"))
            ts = float(parts[1]) if len(parts) > 1 else None
        except Exception:
            continue
        out.append(
            {
                "name": name.strip(),
                "labels": labels,
                "exemplar": ex_labels,
                "value": value,
                "ts": ts,
            }
        )
    return out
