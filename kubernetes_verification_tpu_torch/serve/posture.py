"""The posture observability plane: generation-over-generation reach deltas.

The PyTorch port of ``kubernetes_verification_tpu.serve.posture``, on the
port's ``ops/posture.py``. The device states diffed here own their
``reach_words`` copies (``ops/device_state.py``); the live engine words are
never diffed, since the engine updates them in place.

Every applied mutation batch moves the cluster's *reachability posture* —
the set of (src, dst) pod pairs the policy state allows. The tracker here
records that movement exactly, for every generation, without ever
materialising a dense [N, N] matrix on the packed path:

* the :class:`~..ops.device_state.DeviceStateCache` double buffer already
  keeps the outgoing generation's state alive one flip past retirement, so
  the *retired* slot IS the previous generation — posture snapshots ride
  the query plane's residency for free (the states just carry an owned
  packed ``reach_words`` copy when posture is enabled);
* the diff runs on device (:mod:`~..ops.posture`): packed XOR/popcount for
  the widened/narrowed planes, masked popcounts per namespace for the
  per-namespace blast-radius split, a stable top-k for the witness rows —
  bit-identical to a dense recompute-and-compare by construction;
* each delta becomes one structured :class:`PostureTracker` record —
  widened/narrowed pair counts, per-namespace movement, capped (src, dst,
  port-atom) witnesses — appended to a crc'd JSONL journal beside the WAL
  (same ``crc`` convention as the WAL itself, so `scan_posture` detects
  torn tails the same way `scan_wal` does) and exported on the
  ``kvtpu_posture_*`` metric families.

Drift alerting is declarative: :func:`parse_posture_rule` accepts
``"deny ns:dev -> ns:prod"`` (no pair between those namespaces may be
reachable), ``"max-widening 500 pairs/batch"`` and ``"max-narrowing N
pairs/batch"`` (per-generation movement bounds). A violated rule raises
nothing inline — serving continues — but produces a typed
:class:`PostureAlertError` on ``service.violations`` (exit-code contract),
a ``kvtpu_posture_alert_violations_total`` increment, a traced event and a
flight-recorder dump of the offending delta record.

Everything the journal emits is bounded by module-level caps
(``TOP_K_ROWS`` / ``WITNESS_CAP`` / ``NS_PAIR_CAP``): the ``bounded-journal``
lint rule fails any witness extraction in this file that is not visibly
capped, because a single generation can legally flip every pair in the
cluster and the journal must not.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..observe import trace
from ..observe.flight import trigger_dump
from ..observe.metrics import (
    POSTURE_ALERT_VIOLATIONS_TOTAL,
    POSTURE_DELTA_SECONDS,
    POSTURE_NARROWED_TOTAL,
    POSTURE_REACHABLE_PAIRS,
    POSTURE_WIDENED_TOTAL,
)
from ..ops.posture import (
    changed_columns,
    ns_pair_counts,
    ns_word_masks,
    packed_row_popcount,
    packed_xor_popcount,
    topk_changed_rows,
)
from ..resilience.errors import ServeError
from .events import WAL_CRC_KEY, _wal_crc

__all__ = [
    "TOP_K_ROWS",
    "WITNESS_CAP",
    "NS_PAIR_CAP",
    "POSTURE_JOURNAL",
    "PostureAlertError",
    "PostureRule",
    "parse_posture_rule",
    "PostureRecord",
    "PostureScan",
    "scan_posture",
    "posture_diff",
    "render_posture_timeline",
    "PostureTracker",
]

#: bounded-journal contract: every per-record extraction below is capped by
#: one of these module constants, never by a data-dependent shape
TOP_K_ROWS = 8  #: most-changed source rows per record (static top-k k)
WITNESS_CAP = 4  #: decoded (src, dst) witnesses per changed row per plane
NS_PAIR_CAP = 32  #: namespace-pair entries per record, largest-first
RECORD_RING = 512  #: in-memory posture records retained per tracker

#: journal filename beside the WAL / snapshot directory
POSTURE_JOURNAL = "posture.jsonl"


class PostureAlertError(ServeError):
    """A posture alert rule was violated by an applied generation.

    Not raised inline — serving continues — but appended to
    ``service.violations`` so the CLI's exit-code contract
    (``EXIT_VIOLATIONS``) and ``describe()`` rendering both see it.
    Carries the rule, the generation and the measured value so a reader
    can reconstruct the verdict without the journal."""

    def __init__(
        self,
        message: str,
        *,
        rule: str,
        kind: str,
        generation: int,
        measured: int,
    ) -> None:
        super().__init__(message)
        self.rule = rule
        self.kind = kind
        self.generation = generation
        self.measured = measured

    def describe(self) -> str:
        return (
            f"posture-alert [{self.kind}] gen {self.generation}: "
            f"{self} (rule: {self.rule!r}, measured {self.measured})"
        )


@dataclass(frozen=True)
class PostureRule:
    """One parsed posture alert rule.

    ``kind`` is ``deny`` (``src_ns``/``dst_ns`` set, ``bound`` unused — any
    reachable pair between the namespaces violates), ``max-widening`` or
    ``max-narrowing`` (``bound`` set — per-generation movement above it
    violates)."""

    kind: str
    spec: str
    src_ns: Optional[str] = None
    dst_ns: Optional[str] = None
    bound: int = 0


_DENY_RE = re.compile(
    r"^deny\s+ns:(?P<src>[A-Za-z0-9_.-]+)\s*->\s*ns:(?P<dst>[A-Za-z0-9_.-]+)$"
)
_BOUND_RE = re.compile(
    r"^(?P<kind>max-widening|max-narrowing)\s+(?P<n>\d+)"
    r"(?:\s+pairs/batch)?$"
)


def parse_posture_rule(spec: str) -> PostureRule:
    """Parse one alert-rule string; ValueError on anything malformed (the
    CLI maps it to the input-error exit code, like --assert specs)."""
    text = " ".join(spec.split())
    m = _DENY_RE.match(text)
    if m:
        return PostureRule(
            kind="deny",
            spec=text,
            src_ns=m.group("src"),
            dst_ns=m.group("dst"),
        )
    m = _BOUND_RE.match(text)
    if m:
        return PostureRule(
            kind=m.group("kind"), spec=text, bound=int(m.group("n"))
        )
    raise ValueError(  # kvtpu: ignore[error-taxonomy] — parse layer mirrors parse_slo_spec
        f"unparseable posture rule {spec!r}: expected "
        "'deny ns:SRC -> ns:DST', 'max-widening N pairs/batch' or "
        "'max-narrowing N pairs/batch'"
    )


# --------------------------------------------------------------- journal
@dataclass
class PostureRecord:
    """One decoded journal record (``to_dict`` is the journal schema)."""

    seq: int
    ts: float
    n_pods: int
    reachable_pairs: int
    widened: int
    narrowed: int
    delta_s: float
    baseline: bool = False
    ns_widened: Dict[str, int] = field(default_factory=dict)
    ns_narrowed: Dict[str, int] = field(default_factory=dict)
    witnesses: List[dict] = field(default_factory=list)
    alerts: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        out = {
            "v": 1,
            "seq": self.seq,
            "ts": self.ts,
            "n_pods": self.n_pods,
            "reachable_pairs": self.reachable_pairs,
            "widened": self.widened,
            "narrowed": self.narrowed,
            "delta_s": self.delta_s,
            "ns_widened": dict(self.ns_widened),
            "ns_narrowed": dict(self.ns_narrowed),
            "witnesses": list(self.witnesses),
            "alerts": list(self.alerts),
        }
        if self.baseline:
            out["baseline"] = True
        return out

    @classmethod
    def from_dict(cls, obj: dict) -> "PostureRecord":
        return cls(
            seq=int(obj["seq"]),
            ts=float(obj["ts"]),
            n_pods=int(obj["n_pods"]),
            reachable_pairs=int(obj["reachable_pairs"]),
            widened=int(obj["widened"]),
            narrowed=int(obj["narrowed"]),
            delta_s=float(obj["delta_s"]),
            baseline=bool(obj.get("baseline", False)),
            ns_widened={
                str(k): int(v)
                for k, v in (obj.get("ns_widened") or {}).items()
            },
            ns_narrowed={
                str(k): int(v)
                for k, v in (obj.get("ns_narrowed") or {}).items()
            },
            witnesses=list(obj.get("witnesses") or []),
            alerts=list(obj.get("alerts") or []),
        )


def _encode_record(record: PostureRecord) -> str:
    """Journal line: the record dict plus the WAL's crc convention — crc32
    over the sort_keys canonical form without the crc key itself."""
    obj = record.to_dict()
    obj[WAL_CRC_KEY] = _wal_crc(json.dumps(obj, sort_keys=True))
    return json.dumps(obj, sort_keys=True)


@dataclass
class PostureScan:
    """Result of :func:`scan_posture`: the valid record prefix plus where
    (if anywhere) the journal tears — same contract as ``scan_wal``."""

    records: List[PostureRecord]
    torn_lineno: Optional[int] = None
    torn_error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.torn_lineno is None


def scan_posture(path: str) -> PostureScan:
    """Read a posture journal, verifying every record's crc; stops at the
    first torn/corrupt line and reports it (a crash mid-append legally
    leaves a torn tail — everything before it is trusted)."""
    records: List[PostureRecord] = []
    if not os.path.exists(path):
        return PostureScan(records)
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                crc = obj.pop(WAL_CRC_KEY, None)
                want = _wal_crc(json.dumps(obj, sort_keys=True))
                if crc != want:
                    raise ValueError(  # kvtpu: ignore[error-taxonomy]
                        f"crc mismatch (got {crc!r}, want {want!r})"
                    )
                records.append(PostureRecord.from_dict(obj))
            except (ValueError, KeyError, TypeError) as e:
                return PostureScan(
                    records, torn_lineno=lineno, torn_error=str(e)
                )
    return PostureScan(records)


def posture_diff(
    records: Sequence[PostureRecord], gen_a: int, gen_b: int
) -> dict:
    """Aggregate posture movement between two generations from journal
    records: the net over every record with ``gen_a < seq <= gen_b``.
    Exact because each record is exact — the sum telescopes."""
    if gen_b < gen_a:
        gen_a, gen_b = gen_b, gen_a
    span = [r for r in records if gen_a < r.seq <= gen_b]
    ns_w: Dict[str, int] = {}
    ns_n: Dict[str, int] = {}
    witnesses: List[dict] = []
    for r in span:
        for k, v in r.ns_widened.items():
            ns_w[k] = ns_w.get(k, 0) + v
        for k, v in r.ns_narrowed.items():
            ns_n[k] = ns_n.get(k, 0) + v
        witnesses.extend(r.witnesses)
    at_a = max(
        (r for r in records if r.seq <= gen_a),
        key=lambda r: r.seq,
        default=None,
    )
    at_b = max((r for r in span), key=lambda r: r.seq, default=None)
    return {
        "gen_a": gen_a,
        "gen_b": gen_b,
        "generations": len(span),
        "widened": sum(r.widened for r in span),
        "narrowed": sum(r.narrowed for r in span),
        "reachable_at_a": at_a.reachable_pairs if at_a else None,
        "reachable_at_b": at_b.reachable_pairs if at_b else None,
        "ns_widened": dict(
            sorted(ns_w.items(), key=lambda kv: -kv[1])[:NS_PAIR_CAP]
        ),
        "ns_narrowed": dict(
            sorted(ns_n.items(), key=lambda kv: -kv[1])[:NS_PAIR_CAP]
        ),
        "witnesses": witnesses[: TOP_K_ROWS * WITNESS_CAP],
        "alerts": sum(len(r.alerts) for r in span),
    }


def _ns_movement_cell(record: PostureRecord, top: int = 2) -> str:
    """Compact namespace-movement column: the ``top`` largest widened and
    narrowed pairs as ``src->dst+n`` / ``src->dst-n``."""
    cells = [
        f"{k}+{v}"
        for k, v in sorted(
            record.ns_widened.items(), key=lambda kv: -kv[1]
        )[:top]
    ]
    cells += [
        f"{k}-{v}"
        for k, v in sorted(
            record.ns_narrowed.items(), key=lambda kv: -kv[1]
        )[:top]
    ]
    return ",".join(cells) if cells else "-"


def render_posture_timeline(
    records: Sequence[PostureRecord], limit: int = 20
) -> List[str]:
    """The ``kv-tpu posture`` timeline: one aligned row per generation,
    newest last — reachable-pair level, per-generation movement, the
    loudest namespace pairs and any alert verdicts."""
    header = (
        "gen", "pods", "reachable", "widened", "narrowed", "delta_ms",
        "ns-movement", "alerts",
    )
    rows: List[tuple] = [header]
    for r in list(records)[-limit:]:
        label = str(r.seq) + ("*" if r.baseline else "")
        rows.append(
            (
                label,
                str(r.n_pods),
                str(r.reachable_pairs),
                f"+{r.widened}",
                f"-{r.narrowed}",
                f"{r.delta_s * 1000:.2f}",
                _ns_movement_cell(r),
                (
                    ",".join(a.get("kind", "?") for a in r.alerts)
                    if r.alerts
                    else "-"
                ),
            )
        )
    widths = [max(len(row[i]) for row in rows) for i in range(len(header))]
    return [
        "  ".join(
            cell.ljust(widths[i]) for i, cell in enumerate(row)
        ).rstrip()
        for row in rows
    ]


# --------------------------------------------------------------- tracker
class PostureTracker:
    """Turns each applied generation's device-side diff into one journal
    record, metric updates and alert verdicts.

    Owned by a :class:`~.service.VerificationService` (see
    ``enable_posture``); :meth:`record` runs under the service lock right
    after the device-state flip, so ``cache.retired()`` is exactly the
    outgoing generation and ``cache.peek()`` the incoming one."""

    def __init__(
        self,
        service,
        journal_path: Optional[str] = None,
        rules: Sequence[PostureRule] = (),
        top_k: int = TOP_K_ROWS,
    ) -> None:
        self.service = service
        self.journal_path = journal_path
        self.rules = list(rules)
        self.top_k = int(top_k)
        #: bounded in-memory ring of recent records (journal is the full
        #: history); bounded-queue contract for serve/
        self.records: "deque[PostureRecord]" = deque(maxlen=RECORD_RING)
        self.violations: List[PostureAlertError] = []
        self._lock = threading.Lock()
        self._journal_fh = None
        #: running exact totals, maintained arithmetically from the exact
        #: per-batch planes (reachable = prev + widened - narrowed)
        self._reachable: Optional[int] = None
        self._ns_pairs: Dict[Tuple[str, str], int] = {}
        self._last: Optional[PostureRecord] = None
        #: namespace-mask cache, keyed on the slot→namespace assignment
        self._groups: List[str] = []
        self._masks = None
        self._row_ns = None
        self._mask_sig: Optional[tuple] = None
        self._ns_baseline_stale = True

    # ------------------------------------------------------------ plumbing
    def close(self) -> None:
        with self._lock:
            if self._journal_fh is not None:
                try:
                    self._journal_fh.close()
                finally:
                    self._journal_fh = None

    def _append_journal(self, record: PostureRecord) -> None:
        if not self.journal_path:
            return
        with self._lock:
            if self._journal_fh is None:
                parent = os.path.dirname(self.journal_path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                self._journal_fh = open(  # kvtpu: ignore[atomic-write] journal append: scan_posture trusts the valid prefix and reports the torn tail
                    self.journal_path, "a", encoding="utf-8"
                )
            self._journal_fh.write(_encode_record(record) + "\n")
            self._journal_fh.flush()

    def _slot_namespaces(self) -> List[Optional[str]]:
        """Namespace per engine slot (None for padding beyond the pods
        list); the packed engine's ``pods`` list indexes slots directly,
        inactive slots have all-zero rows/cols so attributing them to
        their last namespace is harmless."""
        eng = self.service.engine
        return [p.namespace for p in eng.pods]

    def _refresh_masks(self, n_rows: int, n_words: int) -> None:
        """Rebuild the packed per-namespace column masks and the per-row
        namespace index iff the slot→namespace assignment changed."""
        slot_ns = self._slot_namespaces()
        sig = (tuple(slot_ns), n_rows, n_words)
        if sig == self._mask_sig:
            return
        groups = sorted({ns for ns in slot_ns if ns is not None})
        idx = {ns: i for i, ns in enumerate(groups)}
        g = len(groups)
        col_ns = np.full(min(len(slot_ns), n_words * 32), g, dtype=np.int64)
        for i, ns in enumerate(slot_ns[: col_ns.shape[0]]):
            if ns is not None:
                col_ns[i] = idx[ns]
        row_ns = np.full(n_rows, g, dtype=np.int32)
        for i, ns in enumerate(slot_ns[:n_rows]):
            if ns is not None:
                row_ns[i] = idx[ns]
        self._groups = groups
        # uploaded once per assignment, to the engine's device
        self._masks = (
            torch.as_tensor(
                ns_word_masks(col_ns, g, n_words).view(np.int32),
                device=self.service.engine.device,
            )
            if g
            else None
        )
        self._row_ns = row_ns
        self._mask_sig = sig
        # the assignment moved under the running ns-pair totals: force a
        # full re-baseline on the next record
        self._ns_pairs = {}
        self._ns_baseline_stale = True

    def _ns_matrix_to_pairs(self, mat: np.ndarray) -> Dict[str, int]:
        """[G, G] count matrix → bounded {'src->dst': n} map, largest
        movement first (NS_PAIR_CAP is the journal bound)."""
        mat = np.asarray(mat)
        src, dst = np.nonzero(mat)
        order = np.argsort(-mat[src, dst], kind="stable")[:NS_PAIR_CAP]
        return {
            f"{self._groups[src[i]]}->{self._groups[dst[i]]}": int(
                mat[src[i], dst[i]]
            )
            for i in order
        }

    @staticmethod
    def _pad_to(words, rows: int, cols: int):
        """Zero-pad a [R, W] int32 device plane up to [rows, cols]: slots
        that did not exist in one generation were unreachable in it, so zero
        words are exactly their posture."""
        r, w = words.shape
        if r == rows and w == cols:
            return words
        return F.pad(words, (0, cols - w, 0, rows - r))

    def _pod_label(self, slot: int) -> str:
        pods = self.service.engine.pods
        if 0 <= slot < len(pods):
            p = pods[slot]
            return f"{p.namespace}/{p.name}"
        return f"slot:{slot}"

    # -------------------------------------------------------------- record
    def record(self) -> Optional[PostureRecord]:
        """Derive and journal the posture record for the service's current
        generation (called under the service lock, right after the
        device-state flip). Returns the record, or None when the query
        cache holds no posture-bearing state yet."""
        svc = self.service
        cache = svc._device_states
        cur_state = cache.peek()
        if cur_state is None:
            return None
        cur_words = cur_state.arrays.get("reach_words")
        if cur_words is None:
            return None
        t0 = time.perf_counter()
        prev_state = cache.retired()
        prev_words = (
            prev_state.arrays.get("reach_words")
            if prev_state is not None
            else None
        )
        record = self._derive(cur_state, cur_words, prev_words)
        record.delta_s = time.perf_counter() - t0
        POSTURE_DELTA_SECONDS.observe(record.delta_s)
        self._evaluate_rules(record)
        self._append_journal(record)
        self.records.append(record)
        self._last = record
        POSTURE_REACHABLE_PAIRS.set(float(record.reachable_pairs))
        if record.widened:
            POSTURE_WIDENED_TOTAL.inc(record.widened)
        if record.narrowed:
            POSTURE_NARROWED_TOTAL.inc(record.narrowed)
        return record

    def _derive(self, cur_state, cur_words, prev_words) -> PostureRecord:
        svc = self.service
        seq = svc._generation
        n_pods = int(cur_state.n)
        if prev_words is None:
            return self._baseline(seq, n_pods, cur_words)
        rows = max(int(cur_words.shape[0]), int(prev_words.shape[0]))
        cols = max(int(cur_words.shape[1]), int(prev_words.shape[1]))
        cur_p = self._pad_to(cur_words, rows, cols)
        prev_p = self._pad_to(prev_words, rows, cols)
        widened_w, narrowed_w, row_w, row_n = packed_xor_popcount(
            prev_p, cur_p
        )
        row_w = row_w.cpu().numpy()
        row_n = row_n.cpu().numpy()
        widened = int(row_w.sum(dtype=np.int64))
        narrowed = int(row_n.sum(dtype=np.int64))
        self._refresh_masks(rows, cols)
        if self._ns_baseline_stale:
            # the running totals were rebuilt from the *current* plane, so
            # this generation's movement must not be folded in again
            self._rebaseline_ns(cur_p)
            reachable = self._full_popcount(cur_p)
            ns_w_pairs, ns_n_pairs = self._ns_delta(
                widened_w, narrowed_w, widened, narrowed, fold=False
            )
        else:
            reachable = (self._reachable or 0) + widened - narrowed
            ns_w_pairs, ns_n_pairs = self._ns_delta(
                widened_w, narrowed_w, widened, narrowed
            )
        self._reachable = reachable
        witnesses = (
            self._witnesses(widened_w, narrowed_w, row_w, row_n)
            if (widened or narrowed)
            else []
        )
        return PostureRecord(
            seq=seq,
            ts=time.time(),
            n_pods=n_pods,
            reachable_pairs=reachable,
            widened=widened,
            narrowed=narrowed,
            delta_s=0.0,
            ns_widened=ns_w_pairs,
            ns_narrowed=ns_n_pairs,
            witnesses=witnesses,
        )

    def _baseline(self, seq: int, n_pods: int, cur_words) -> PostureRecord:
        """First observable generation (nothing retired to diff against):
        record the absolute posture level with zero movement."""
        rows = int(cur_words.shape[0])
        cols = int(cur_words.shape[1])
        self._refresh_masks(rows, cols)
        self._rebaseline_ns(cur_words)
        reachable = self._full_popcount(cur_words)
        self._reachable = reachable
        return PostureRecord(
            seq=seq,
            ts=time.time(),
            n_pods=n_pods,
            reachable_pairs=reachable,
            widened=0,
            narrowed=0,
            delta_s=0.0,
            baseline=True,
        )

    @staticmethod
    def _full_popcount(words) -> int:
        return int(
            packed_row_popcount(words).cpu().numpy().sum(dtype=np.int64)
        )

    def _rebaseline_ns(self, cur_words) -> None:
        """Recompute the running per-namespace-pair reachable totals from
        the full current plane (enable time, or after the slot→namespace
        assignment changed under us)."""
        self._ns_pairs = {}
        g = len(self._groups)
        if g == 0 or self._masks is None:
            self._ns_baseline_stale = False
            return
        mat = (
            ns_pair_counts(cur_words, self._masks, self._row_ns, g)
            .cpu().numpy().astype(np.int64)
        )
        for s in range(g):
            for d in range(g):
                if mat[s, d]:
                    self._ns_pairs[
                        (self._groups[s], self._groups[d])
                    ] = int(mat[s, d])
        self._ns_baseline_stale = False

    def _ns_delta(
        self,
        widened_w,
        narrowed_w,
        widened: int,
        narrowed: int,
        fold: bool = True,
    ) -> Tuple[Dict[str, int], Dict[str, int]]:
        """Per-namespace-pair split of this generation's movement; with
        ``fold`` it also updates the running reachable-pair totals the
        deny rules read (exact: the per-batch planes are exact). ``fold``
        is False right after a re-baseline, whose totals already reflect
        the current plane."""
        g = len(self._groups)
        if g == 0 or self._masks is None:
            return {}, {}
        ns_w = ns_n = None
        if widened:
            ns_w = (
                ns_pair_counts(widened_w, self._masks, self._row_ns, g)
                .cpu().numpy().astype(np.int64)
            )
        if narrowed:
            ns_n = (
                ns_pair_counts(narrowed_w, self._masks, self._row_ns, g)
                .cpu().numpy().astype(np.int64)
            )
        for mat, sign in ((ns_w, 1), (ns_n, -1)) if fold else ():
            if mat is None:
                continue
            # bounded by construction: mat is the [G, G] namespace-pair
            # matrix, G = live namespace count, never delta-proportional
            for s, d in zip(*np.nonzero(mat)):  # kvtpu: ignore[bounded-journal]
                key = (self._groups[s], self._groups[d])
                nxt = self._ns_pairs.get(key, 0) + sign * int(mat[s, d])
                if nxt:
                    self._ns_pairs[key] = nxt
                else:
                    self._ns_pairs.pop(key, None)
        return (
            self._ns_matrix_to_pairs(ns_w) if ns_w is not None else {},
            self._ns_matrix_to_pairs(ns_n) if ns_n is not None else {},
        )

    def _witnesses(
        self, widened_w, narrowed_w, row_w: np.ndarray, row_n: np.ndarray
    ) -> List[dict]:
        """Decode the top-k most-changed source rows into concrete
        (src, dst, port-atom) witnesses — both extractions capped
        (``self.top_k`` rows, ``WITNESS_CAP`` columns per plane)."""
        changed = row_w + row_n
        k = min(self.top_k, changed.shape[0])
        if k <= 0:
            return []
        counts, rows = topk_changed_rows(torch.from_numpy(changed), k)
        counts = counts.numpy()
        rows = rows.numpy()
        out: List[dict] = []
        for count, row in zip(counts, rows):
            if int(count) <= 0:
                break
            src = self._pod_label(int(row))
            for plane, direction in (
                (widened_w, "widened"),
                (narrowed_w, "narrowed"),
            ):
                cols = changed_columns(plane[int(row)], WITNESS_CAP)
                for col in cols[:WITNESS_CAP]:
                    out.append(
                        {
                            "src": src,
                            "dst": self._pod_label(int(col)),
                            "port": "*",
                            "dir": direction,
                        }
                    )
        return out

    # --------------------------------------------------------------- alerts
    def _evaluate_rules(self, record: PostureRecord) -> None:
        for rule in self.rules:
            verdict = self._check_rule(rule, record)
            if verdict is None:
                continue
            measured, detail = verdict
            err = PostureAlertError(
                detail,
                rule=rule.spec,
                kind=rule.kind,
                generation=record.seq,
                measured=measured,
            )
            record.alerts.append(
                {"rule": rule.spec, "kind": rule.kind, "detail": detail}
            )
            self.violations.append(err)
            self.service.violations.append(err)
            POSTURE_ALERT_VIOLATIONS_TOTAL.labels(rule=rule.kind).inc()
            with trace(
                "posture_alert",
                _event="posture-alert",
                rule=rule.spec,
                kind=rule.kind,
                generation=record.seq,
                measured=measured,
            ):
                pass
            trigger_dump(
                "posture-alert",
                rule=rule.spec,
                kind=rule.kind,
                generation=record.seq,
                measured=measured,
                record=record.to_dict(),
            )

    def _check_rule(
        self, rule: PostureRule, record: PostureRecord
    ) -> Optional[Tuple[int, str]]:
        """None when the rule holds; (measured, detail) when violated."""
        if rule.kind == "max-widening":
            if record.widened > rule.bound:
                return (
                    record.widened,
                    f"generation widened {record.widened} pairs "
                    f"(> {rule.bound}/batch)",
                )
            return None
        if rule.kind == "max-narrowing":
            if record.narrowed > rule.bound:
                return (
                    record.narrowed,
                    f"generation narrowed {record.narrowed} pairs "
                    f"(> {rule.bound}/batch)",
                )
            return None
        if rule.kind == "deny":
            count = self._ns_pairs.get((rule.src_ns, rule.dst_ns), 0)
            if count > 0:
                return (
                    count,
                    f"{count} reachable pair(s) ns:{rule.src_ns} -> "
                    f"ns:{rule.dst_ns}",
                )
            return None
        raise ServeError(f"unhandled posture rule kind {rule.kind!r}")

    # --------------------------------------------------------------- health
    def health(self) -> dict:
        """The posture fragment of ``/healthz`` — rendered as columns by
        ``kv-tpu fleet`` / ``top``."""
        last = self._last
        return {
            "generation": last.seq if last else None,
            "reachable_pairs": last.reachable_pairs if last else None,
            "widened_last": last.widened if last else 0,
            "narrowed_last": last.narrowed if last else 0,
            "rules": len(self.rules),
            "violations": len(self.violations),
            "journal": self.journal_path,
        }
