"""Fleet scraping and SLO burn-rate monitoring.

The PyTorch port's copy of ``kubernetes_verification_tpu.observe.fleet``.

``kv-tpu fleet`` points this module at every replica the load balancer
knows: each one is scraped over its replication port (``GET /healthz`` for
the JSON health document, ``GET /metrics`` for the Prometheus text the
exporter already renders), the results are rendered as one fleet table,
and an :class:`SloMonitor` turns the per-replica observations into
multi-window error-budget burn rates (``kvtpu_slo_burn_rate{objective,
window}``) — the Google-SRE-shaped signal that replaces "lag looked fine
in the bench footnote".

Objectives come from a tiny spec grammar (CLI ``--slo`` flags):

* ``availability=0.999`` — target fraction of scrapes/queries that must
  succeed; the error budget is ``1 - target``.
* ``staleness=0.995@2.0`` — target fraction of observations whose replica
  lag is within the ``@``-bound (seconds).

Burn rate over a window is ``bad_fraction / (1 - target)``: 1.0 means the
fleet is burning budget exactly at the sustainable rate, above 1 it
exhausts the budget early (the classic 5m/1h multi-window pair tells fast
burns from slow leaks).

This module deliberately does NOT import ``serve`` — the serving layer
imports ``observe`` everywhere, and the scraper only needs a URL and
stdlib HTTP.
"""
from __future__ import annotations

import collections
import http.client
import json
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import urlsplit

from .events import get_clock
from .export import parse_prometheus
from .metrics import SLO_BURN_RATE
from .spans import trace, trace_headers

__all__ = [
    "ReplicaScrape",
    "scrape_replica",
    "render_fleet",
    "fleet_row",
    "stripe_coverage",
    "SloObjective",
    "parse_slo_spec",
    "SloMonitor",
    "DEFAULT_WINDOWS",
]

#: the classic multi-window pair: a fast window that catches sharp burns
#: and a slow one that catches leaks (seconds)
DEFAULT_WINDOWS: Tuple[float, ...] = (300.0, 3600.0)


@dataclass
class ReplicaScrape:
    """One replica's scrape result: health JSON + parsed metric samples
    (both None when the scrape failed; ``error`` says why)."""

    url: str
    ok: bool = False
    error: Optional[str] = None
    health: Optional[dict] = None
    metrics: Optional[dict] = None

    @property
    def lag_seconds(self) -> Optional[float]:
        if not self.health:
            return None
        lag = self.health.get("lag") or {}
        return lag.get("seconds")


def _get(url: str, path: str, timeout: float) -> Tuple[int, bytes]:
    parts = urlsplit(url)
    conn = http.client.HTTPConnection(
        parts.hostname, parts.port, timeout=timeout
    )
    try:
        conn.request("GET", path, headers=trace_headers())
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def scrape_replica(url: str, timeout: float = 5.0) -> ReplicaScrape:
    """Scrape one replica's ``/healthz`` + ``/metrics``; never raises —
    an unreachable replica is itself an availability observation."""
    out = ReplicaScrape(url=url)
    with trace("fleet_scrape", url=url) as span:
        try:
            status, body = _get(url, "/healthz", timeout)
            if status != 200:
                # kvtpu: ignore[error-taxonomy] raised-and-caught two lines down: a failed scrape is an availability datum, not an error path
                raise OSError(f"/healthz -> HTTP {status}")
            out.health = json.loads(body.decode("utf-8"))
            status, body = _get(url, "/metrics", timeout)
            if status != 200:
                # kvtpu: ignore[error-taxonomy] raised-and-caught below: a failed scrape is an availability datum, not an error path
                raise OSError(f"/metrics -> HTTP {status}")
            out.metrics = parse_prometheus(body.decode("utf-8"))
            out.ok = True
        except Exception as e:  # noqa: BLE001 - scrape failure is data
            out.error = f"{type(e).__name__}: {e}"
            span.attrs["error"] = out.error
    return out


def _fmt(value, digits: int = 3) -> str:
    if value is None:
        return "-"
    if isinstance(value, bool):
        return "yes" if value else "no"
    if isinstance(value, float):
        return f"{value:.{digits}f}"
    return str(value)


def _tenant_totals(samples) -> Dict[str, float]:
    """Per-tenant sums from parsed metric samples ``[(labels, value), ...]``
    (labels without a ``tenant`` key are skipped)."""
    per: Dict[str, float] = {}
    for labels, value in samples or []:
        tenant = labels.get("tenant")
        if tenant is None:
            continue
        per[tenant] = per.get(tenant, 0.0) + value
    return per


def _tenant_summary(samples, *, digits: Optional[int] = None, top: int = 2) -> str:
    """Compact per-tenant column text from parsed metric samples
    (``[(labels, value), ...]``): the ``top`` largest as ``tenant=value``,
    a ``+N`` tail for the rest, ``-`` when the family is absent."""
    per = _tenant_totals(samples)
    if not per:
        return "-"
    items = sorted(per.items(), key=lambda kv: (-kv[1], kv[0]))
    cells = [
        f"{t}={v:.{digits}f}" if digits is not None else f"{t}={int(v)}"
        for t, v in items[:top]
    ]
    if len(items) > top:
        cells.append(f"+{len(items) - top}")
    return ",".join(cells)


def _posture_summary(health: Optional[dict]) -> str:
    """Compact posture column text from a ``/healthz`` document: current
    reachable-pair count, last generation's movement (``+widened/-narrowed``)
    and a ``!N`` suffix for accumulated alert violations; ``-`` when the
    replica has no posture plane enabled."""
    p = (health or {}).get("service") or {}
    p = p.get("posture")
    if not p or p.get("reachable_pairs") is None:
        return "-"
    txt = (
        f"{p['reachable_pairs']}p "
        f"+{p.get('widened_last', 0)}/-{p.get('narrowed_last', 0)}"
    )
    violations = p.get("violations") or 0
    if violations:
        txt += f" !{violations}"
    return txt


def _human_pods(n) -> str:
    """``1250000 -> "1.25M"`` — the stripe column's pod-count rendering."""
    n = float(n)
    for div, suffix in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if n >= div:
            txt = f"{n / div:.2f}".rstrip("0").rstrip(".")
            return f"{txt}{suffix}"
    return str(int(n))


def _stripe_summary(health: Optional[dict]) -> str:
    """Compact stripe-ownership column text from a ``/healthz`` document:
    ``3/8 · 1.25M pods`` (1-based stripe index / stripe count, owned pod
    rows); ``-`` when the replica serves whole state."""
    frag = (health or {}).get("stripe")
    if not frag or frag.get("count") is None:
        return "-"
    return (
        f"{int(frag.get('index', 0)) + 1}/{int(frag['count'])} · "
        f"{_human_pods(frag.get('pods', 0))} pods"
    )


def stripe_coverage(scrapes: Sequence[ReplicaScrape]) -> Optional[dict]:
    """Fleet-wide stripe coverage from the scrapes' ``/healthz`` stripe
    fragments: which stripe indices have at least one LIVE owner. Returns
    None when no replica reports a stripe (a whole-state fleet has no
    coverage concept). A stripe with no live owner is an outage for every
    query touching its rows — the coordinator fails it typed
    (:class:`~..resilience.errors.StripeCoverageError`), never silently
    answers from the surviving stripes — so the fleet view must shout the
    gap, not average it away. Disagreeing stripe counts across replicas
    (a mid-resharding scrape) report ``consistent: False``."""
    by_count: Dict[int, set] = {}
    for s in scrapes:
        frag = (s.health or {}).get("stripe") if s.ok else None
        if frag and frag.get("count"):
            by_count.setdefault(int(frag["count"]), set()).add(
                int(frag.get("index", 0))
            )
    if not by_count:
        return None
    if len(by_count) > 1:
        return {"consistent": False, "counts": sorted(by_count)}
    count, owned = next(iter(by_count.items()))
    missing = sorted(set(range(count)) - owned)
    return {
        "consistent": True,
        "count": count,
        "owned": sorted(owned),
        "missing": missing,
    }


def render_fleet(scrapes: Sequence[ReplicaScrape]) -> List[str]:
    """The fleet table: one aligned row per replica, down replicas
    included (their row says why). ``shed`` / ``quota`` summarise the
    front-door admission metrics per tenant (total typed rejections and
    token-bucket utilisation) so an operator sees who is being refused
    where without correlating counters by hand; ``posture`` is the
    reach-drift plane (reachable pairs, last movement, alert count)."""
    header = (
        "replica", "role", "epoch", "last_seq", "lag_s", "breaker", "aot",
        "shed", "quota", "posture", "stripe",
    )
    rows = [header]
    for s in scrapes:
        if not s.ok:
            rows.append(
                (
                    s.url, "DOWN", "-", "-", "-", s.error or "-", "-",
                    "-", "-", "-", "-",
                )
            )
            continue
        h = s.health or {}
        breakers = h.get("breakers") or {}
        btxt = (
            ",".join(f"{k}={v}" for k, v in sorted(breakers.items()))
            if breakers
            else "-"
        )
        aot = h.get("aot") or {}
        if not aot.get("present"):
            atxt = "-"
        elif aot.get("env_match") and not aot.get("corrupt"):
            atxt = f"ok/{aot.get('matching', 0)}"
        else:
            atxt = "stale"
        metrics = s.metrics or {}
        rows.append(
            (
                s.url,
                str(h.get("role", "-")),
                _fmt(h.get("epoch")),
                _fmt(h.get("last_seq")),
                _fmt(s.lag_seconds),
                btxt,
                atxt,
                _tenant_summary(
                    metrics.get("kvtpu_admission_rejections_total")
                ),
                _tenant_summary(
                    metrics.get("kvtpu_admission_quota_utilization"),
                    digits=2,
                ),
                _posture_summary(h),
                _stripe_summary(h),
            )
        )
    widths = [max(len(r[i]) for r in rows) for i in range(len(header))]
    out = [
        "  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)).rstrip()
        for row in rows
    ]
    cov = stripe_coverage(scrapes)
    if cov is not None:
        if not cov["consistent"]:
            out.append(
                "stripe coverage: INCONSISTENT stripe counts "
                f"{cov['counts']} across the fleet"
            )
        elif cov["missing"]:
            gaps = ", ".join(
                f"{i + 1}/{cov['count']}" for i in cov["missing"]
            )
            out.append(
                f"stripe coverage: GAP — stripe(s) {gaps} have no live "
                "owner (queries touching those rows fail typed, not "
                "truncated)"
            )
        else:
            out.append(
                f"stripe coverage: {cov['count']}/{cov['count']} stripes "
                "owned"
            )
    return out


def fleet_row(s: ReplicaScrape) -> dict:
    """The machine-readable mirror of one :func:`render_fleet` row —
    ``kv-tpu fleet --json`` emits these so CI consumes fleet state without
    screen-scraping the aligned table. Raw values, not column text: lag is
    a float, shed/quota are per-tenant maps, ``posture`` is the replica's
    posture health fragment (None when the plane is disabled)."""
    h = s.health or {}
    metrics = s.metrics or {}
    svc = h.get("service") or {}
    return {
        "url": s.url,
        "ok": s.ok,
        "error": s.error,
        "role": h.get("role"),
        "epoch": h.get("epoch"),
        "last_seq": h.get("last_seq"),
        "lag_s": s.lag_seconds,
        "breakers": h.get("breakers") or {},
        "aot": h.get("aot"),
        "shed": _tenant_totals(
            metrics.get("kvtpu_admission_rejections_total")
        ),
        "quota": _tenant_totals(
            metrics.get("kvtpu_admission_quota_utilization")
        ),
        "posture": svc.get("posture"),
        "stripe": h.get("stripe"),
    }


@dataclass(frozen=True)
class SloObjective:
    """One objective: ``target`` fraction of good events; ``bound`` is the
    staleness threshold (seconds) for lag-shaped objectives, None for
    plain availability."""

    name: str
    target: float
    bound: Optional[float] = None

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def parse_slo_spec(spec: str) -> SloObjective:
    """``availability=0.999`` / ``staleness=0.995@2.0`` -> SloObjective.

    Raises ValueError with the offending spec on malformed input (the CLI
    surfaces it as an input error, exit code 2)."""
    name, sep, rest = spec.partition("=")
    name = name.strip()
    if not sep or not name:
        # kvtpu: ignore[error-taxonomy] documented parse contract: the CLI maps ValueError to an input error (exit 2)
        raise ValueError(f"bad SLO spec {spec!r}: want name=target[@bound]")
    target_text, at, bound_text = rest.partition("@")
    try:
        target = float(target_text)
        bound = float(bound_text) if at else None
    except ValueError:
        # kvtpu: ignore[error-taxonomy] documented parse contract: the CLI maps ValueError to an input error (exit 2)
        raise ValueError(
            f"bad SLO spec {spec!r}: target/bound must be numbers"
        ) from None
    if not 0.0 < target < 1.0:
        # kvtpu: ignore[error-taxonomy] documented parse contract: the CLI maps ValueError to an input error (exit 2)
        raise ValueError(
            f"bad SLO spec {spec!r}: target must be in (0, 1), got {target}"
        )
    return SloObjective(name=name, target=target, bound=bound)


def _window_label(seconds: float) -> str:
    if seconds % 3600 == 0:
        return f"{int(seconds // 3600)}h"
    if seconds % 60 == 0:
        return f"{int(seconds // 60)}m"
    return f"{int(seconds)}s"


@dataclass
class SloMonitor:
    """Rolling good/bad observations per objective with multi-window
    burn-rate evaluation. Timestamps come from the shared injectable clock
    (``observe.events.set_clock``) so tests drive the windows."""

    objectives: Sequence[SloObjective]
    max_observations: int = 4096
    #: seconds a known source (replica URL) stays on the books after its
    #: last observation; a source silent for longer is treated as
    #: decommissioned rather than unscrapeable
    source_ttl: float = 7200.0
    _events: Dict[str, collections.deque] = field(default_factory=dict)
    _sources: Dict[str, Dict[str, float]] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def __post_init__(self) -> None:
        for o in self.objectives:
            self._events[o.name] = collections.deque(
                maxlen=self.max_observations
            )
            self._sources[o.name] = {}

    def objective(self, name: str) -> SloObjective:
        for o in self.objectives:
            if o.name == name:
                return o
        raise KeyError(name)  # kvtpu: ignore[error-taxonomy] mapping-lookup contract on a programmer-facing accessor

    def record(
        self,
        name: str,
        ok: bool,
        ts: Optional[float] = None,
        source: Optional[str] = None,
    ) -> None:
        """One observation for ``name``: ``ok`` consumed no budget.
        ``source`` (a replica URL) registers where it came from, so a
        source that later falls silent is charged against the objective
        instead of vanishing from it; sourceless observations keep the
        pre-source semantics (no data, no violation)."""
        if ts is None:
            ts = get_clock().wall()
        with self._lock:
            self._events[name].append((ts, bool(ok)))
            if source is not None:
                self._sources[name][source] = ts

    def observe_scrape(self, scrape: ReplicaScrape) -> None:
        """Fold one replica scrape into every objective: availability-
        shaped objectives count scrape success, staleness-shaped ones
        count the reported lag against their bound (a down replica is
        bad for those too — its staleness is unbounded)."""
        for o in self.objectives:
            if o.bound is None:
                self.record(o.name, scrape.ok, source=scrape.url)
            else:
                lag = scrape.lag_seconds
                self.record(
                    o.name,
                    scrape.ok and lag is not None and lag <= o.bound,
                    source=scrape.url,
                )

    def _silent_sources(
        self, name: str, cutoff: float, now: float
    ) -> List[str]:
        """Known sources (seen within ``source_ttl``) with zero
        observations inside the window — each is one synthetic bad
        availability event: a replica nobody managed to scrape is not
        healthy, it is invisible (lock held)."""
        horizon = now - self.source_ttl
        sources = self._sources[name]
        for src in [s for s, ts in sources.items() if ts < horizon]:
            del sources[src]  # decommissioned, not unscrapeable
        return [s for s, ts in sources.items() if ts < cutoff]

    def burn_rate(
        self, name: str, window_seconds: float, now: Optional[float] = None
    ) -> float:
        """``bad_fraction / budget`` over the trailing window; 0.0 with no
        observations (no data is not a violation), ``inf`` when a
        zero-budget objective saw a bad event.

        A *known* source with zero in-window observations counts as one
        bad event (availability-shaped objectives only): before this, a
        replica that stopped answering scrapes entirely aged out of the
        window and silently contributed zero burn — the least available
        replica was the one the monitor ignored."""
        if now is None:
            now = get_clock().wall()
        o = self.objective(name)
        cutoff = now - window_seconds
        with self._lock:
            events = [e for e in self._events[name] if e[0] >= cutoff]
            silent = (
                self._silent_sources(name, cutoff, now)
                if o.bound is None
                else []
            )
        total = len(events) + len(silent)
        if not total:
            return 0.0
        bad = sum(1 for _, ok in events if not ok) + len(silent)
        bad_fraction = bad / total
        if o.budget <= 0.0:
            return float("inf") if bad else 0.0
        return bad_fraction / o.budget

    def evaluate(
        self,
        windows: Sequence[float] = DEFAULT_WINDOWS,
        now: Optional[float] = None,
    ) -> Dict[str, Dict[str, float]]:
        """Burn rates for every objective × window, published to
        ``kvtpu_slo_burn_rate{objective,window}`` and returned as
        ``{objective: {window_label: burn}}``."""
        out: Dict[str, Dict[str, float]] = {}
        for o in self.objectives:
            per: Dict[str, float] = {}
            for w in windows:
                label = _window_label(w)
                burn = self.burn_rate(o.name, w, now=now)
                SLO_BURN_RATE.labels(objective=o.name, window=label).set(burn)
                per[label] = burn
            out[o.name] = per
        return out
