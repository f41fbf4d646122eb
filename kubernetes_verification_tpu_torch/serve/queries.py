"""Queries, declarative assertions and what-if admission checks.

The PyTorch port of ``kubernetes_verification_tpu.serve.queries``. The
serving counterpart of the one-shot result API
(:class:`~..backends.base.VerifyResult`): a :class:`QueryEngine` answers
against a live :class:`~.service.VerificationService`, solving lazily —

* :meth:`QueryEngine.can_reach` — one pod pair, optionally refined to a
  concrete ``(protocol, port)``. The dense serving engine is any-port, so
  the port-precise form re-runs the CPU oracle on a 2-pod sub-cluster
  (pair reachability depends only on the policies plus the two pods'
  labels/namespaces, so the sub-problem is exact and tiny);
* :meth:`QueryEngine.can_reach_batch` — the vectorized form: a whole batch
  of probes answered through ONE batched device call
  (:mod:`~..ops.batched` gathers the reach rows of every distinct source
  straight from the engine's count matrices), with all missed ported
  probes refined by ONE oracle solve over the sub-cluster they jointly
  induce. Packed rows and per-pair port tables memoize in a
  :class:`QueryCache` keyed on the service's engine generation —
  invalidated by ``apply()``/``full_resync``, never populated by what-if
  overlays;
* :meth:`QueryEngine.who_can_reach` / :meth:`QueryEngine.blast_radius` —
  one column / one row of the reach matrix, as pod names;
* :meth:`QueryEngine.what_if` — admission-style dry run: candidate policy
  events are applied to a copy-on-write overlay of the engine's count
  matrices (each cloned once, on the first shift; the engine's own
  ``_rank1_add`` writes in place and must never see a live engine tensor
  from here), the overlay's reach is derived with the engine's own
  ``_derive_reach``, and the diff plus assertion verdicts come back
  WITHOUT committing anything. A shift writes only its rows × columns
  block of the clones, so no ``src ⊗ dst`` outer product is formed.

Assertions are declarative allow/deny invariants over pod selectors,
re-checked after every applied batch; a violated assertion carries a
concrete witnessing pod pair (the serving form of the reference's
``assert_reachable`` test idiom).
"""
from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Cycle-safe: the package's __init__ does not import serve. The
# ported-probe refinement goes through the public ``verify`` with the host
# NumPy oracle (``backend="cpu"``), the same entry point as the tests.
from ..backends.base import VerifyConfig, VerifyResult, verify
from ..incremental import _derive_reach, _rank1_add
from ..models.core import Cluster, Pod
from ..observe.metrics import (
    QUERY_BATCH_SIZE,
    QUERY_CACHE_HITS_TOTAL,
    QUERY_CACHE_MISSES_TOTAL,
    QUERY_LATENCY_SECONDS,
    SERVE_ASSERTION_FAILURES_TOTAL,
    SERVE_QUERIES_TOTAL,
    SERVE_SOLVES_TOTAL,
)
from ..observe.spans import trace
from ..ops.batched import (
    batched_any_port,
    batched_reach_cols,
    batched_reach_rows,
    packed_any_port,
    packed_reach_cols,
    packed_reach_rows,
)
from ..ops.bits import unpack_cols
from ..resilience.breaker import CLOSED
from ..resilience.errors import BackendError, IngestError, ServeError
from .events import AddPolicy, Event, RemovePolicy, UpdatePolicy

__all__ = [
    "PodSelector",
    "Assertion",
    "Violation",
    "WhatIfResult",
    "QueryCache",
    "QueryEngine",
    "load_assertions",
    "check_assertions",
]

def _packed_operands(state):
    """Kernel operand tuple from a packed :class:`DeviceQueryState` —
    positional order matches the ``packed_*`` twins in ``ops/batched.py``."""
    a = state.arrays
    return (
        a["sel_ing8"], a["sel_eg8"], a["ing_by_pol"], a["eg_by_pol"],
        a["ing_cnt"], a["eg_cnt"], a["col_mask"], a["row_valid"],
    )


def _word_bits(words: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Per-probe verdict bits from host uint32 word rows: ``words`` is
    [Q, W] (row ``k`` already gathered for probe ``k``), ``dst`` [Q]."""
    w = words[np.arange(dst.size), dst // 32]
    return ((w >> (dst % 32).astype(np.uint32)) & np.uint32(1)).astype(bool)


# ------------------------------------------------------------ pod selection
@dataclass(frozen=True)
class PodSelector:
    """Selects pods by exact namespace, exact name and/or a label subset
    (all given fields must match; an empty selector matches every pod)."""

    namespace: Optional[str] = None
    name: Optional[str] = None
    labels: Tuple[Tuple[str, str], ...] = ()

    @classmethod
    def from_dict(cls, obj: dict, *, where: str = "<selector>") -> "PodSelector":
        if not isinstance(obj, dict):
            raise IngestError(f"{where}: selector must be an object")
        unknown = set(obj) - {"namespace", "name", "labels", "pod"}
        if unknown:
            raise IngestError(
                f"{where}: unknown selector field(s) {sorted(unknown)}"
            )
        name = obj.get("name", obj.get("pod"))
        labels = obj.get("labels") or {}
        if not isinstance(labels, dict):
            raise IngestError(f"{where}: labels must be an object")
        return cls(
            namespace=obj.get("namespace"),
            name=name,
            labels=tuple(sorted((str(k), str(v)) for k, v in labels.items())),
        )

    def matches(self, pod: Pod) -> bool:
        if self.namespace is not None and pod.namespace != self.namespace:
            return False
        if self.name is not None and pod.name != self.name:
            return False
        return all(pod.labels.get(k) == v for k, v in self.labels)

    def indices(self, pods: Sequence[Pod]) -> np.ndarray:
        return np.asarray(
            [i for i, p in enumerate(pods) if self.matches(p)], dtype=np.int64
        )

    def describe(self) -> str:
        parts = []
        if self.namespace is not None:
            parts.append(f"namespace={self.namespace}")
        if self.name is not None:
            parts.append(f"name={self.name}")
        parts += [f"{k}={v}" for k, v in self.labels]
        return "{" + ", ".join(parts) + "}" if parts else "{*}"


@dataclass(frozen=True)
class Assertion:
    """``allow``: every (src, dst) pair matched by the selectors must be
    reachable. ``deny``: none may be. Checked after every applied batch."""

    name: str
    kind: str  # "allow" | "deny"
    src: PodSelector
    dst: PodSelector
    #: skip src==dst pairs (self-traffic is usually policy-independent)
    ignore_self: bool = True


@dataclass(frozen=True)
class Violation:
    """One violated assertion with a concrete witnessing pod pair."""

    assertion: str
    kind: str
    witness_src: str  # "namespace/name"
    witness_dst: str
    pairs: int  # total violating pairs, not just the witness

    def describe(self) -> str:
        verb = "cannot reach" if self.kind == "allow" else "can reach"
        extra = f" (+{self.pairs - 1} more pairs)" if self.pairs > 1 else ""
        return (
            f"assertion {self.assertion!r} violated: {self.witness_src} "
            f"{verb} {self.witness_dst}{extra}"
        )


def load_assertions(path: str) -> List[Assertion]:
    """Parse an assertion file: a JSON list (or ``{"assertions": [...]}``)
    of ``{"name", "kind": "allow"|"deny", "from": SEL, "to": SEL}``."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except OSError as e:
        raise IngestError(f"cannot read assertion file {path}: {e}") from e
    except json.JSONDecodeError as e:
        raise IngestError(f"{path}: not valid JSON: {e}") from e
    if isinstance(doc, dict):
        doc = doc.get("assertions")
    if not isinstance(doc, list):
        raise IngestError(
            f"{path}: expected a JSON list of assertions (or an object "
            "with an 'assertions' list)"
        )
    out: List[Assertion] = []
    for i, obj in enumerate(doc):
        where = f"{path}[{i}]"
        if not isinstance(obj, dict):
            raise IngestError(f"{where}: assertion must be an object")
        kind = obj.get("kind")
        if kind not in ("allow", "deny"):
            raise IngestError(
                f"{where}: kind must be 'allow' or 'deny', got {kind!r}"
            )
        if "from" not in obj or "to" not in obj:
            raise IngestError(f"{where}: assertion needs 'from' and 'to'")
        out.append(
            Assertion(
                name=str(obj.get("name", f"assertion-{i}")),
                kind=kind,
                src=PodSelector.from_dict(obj["from"], where=f"{where}.from"),
                dst=PodSelector.from_dict(obj["to"], where=f"{where}.to"),
                ignore_self=bool(obj.get("ignore_self", True)),
            )
        )
    return out


def _pod_name(pod: Pod) -> str:
    return f"{pod.namespace}/{pod.name}"


def _violation_from(
    a: Assertion,
    sub: np.ndarray,
    src_idx: np.ndarray,
    dst_idx: np.ndarray,
    pods: Sequence[Pod],
) -> Optional[Violation]:
    """Verdict for one assertion given its (src × dst) reach submatrix."""
    bad = ~sub if a.kind == "allow" else sub.copy()
    if a.ignore_self:
        bad &= src_idx[:, None] != dst_idx[None, :]
    si, di = np.nonzero(bad)
    if si.size == 0:
        return None
    return Violation(
        assertion=a.name,
        kind=a.kind,
        witness_src=_pod_name(pods[int(src_idx[si[0]])]),
        witness_dst=_pod_name(pods[int(dst_idx[di[0]])]),
        pairs=int(si.size),
    )


def _first_cells(mask: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(rows, cols)`` of the first ``k`` set cells of a bool ``[N, N]``
    tensor in row-major order (``np.nonzero``'s), listing no more of them
    than the rows that hold those ``k`` need."""
    counts = torch.cumsum(mask.sum(dim=1), 0)
    if k <= 0 or counts.numel() == 0 or int(counts[-1]) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    last = int(torch.searchsorted(counts, min(k, int(counts[-1]))))
    cells = torch.nonzero(mask[: last + 1])[:k].cpu().numpy()
    return cells[:, 0], cells[:, 1]


def _violations_on(
    assertions: Sequence[Assertion],
    reach: torch.Tensor,
    pods: Sequence[Pod],
) -> List[Violation]:
    """Verdicts of ``assertions`` on a bool ``[N, N]`` reach tensor; only
    each assertion's (src × dst) submatrix crosses to the host."""
    found: List[Violation] = []
    for a in assertions:
        src_idx = a.src.indices(pods)
        dst_idx = a.dst.indices(pods)
        if src_idx.size == 0 or dst_idx.size == 0:
            continue
        dev = reach.device
        sub = reach[torch.as_tensor(src_idx, device=dev)][
            :, torch.as_tensor(dst_idx, device=dev)
        ].cpu().numpy()
        v = _violation_from(a, sub, src_idx, dst_idx, pods)
        if v is not None:
            found.append(v)
    return found


def check_assertions(service, assertions: Sequence[Assertion]) -> List[Violation]:
    """Check ``assertions`` against the service's current state; counts
    each violated assertion on ``kvtpu_serve_assertion_failures_total``.

    When the engine's reach derivation is already clean (or a fallback
    matrix is standing in) the check reads the full matrix for free. On a
    DIRTY engine the check rides the batched row-gather kernel instead:
    only the rows of the assertions' source pods are derived, in one device
    dispatch, counted under the ``assertion_rows`` solve trigger — the
    full-matrix derivation stays lazy for the next query."""
    if not assertions:
        return []
    with service._lock:
        pods = service.engine.pods
        plan = []
        for a in assertions:
            src_idx = a.src.indices(pods)
            dst_idx = a.dst.indices(pods)
            if src_idx.size and dst_idx.size:
                plan.append((a, src_idx, dst_idx))
        if not plan:
            return []
        sub_of = _assertion_submatrices(service, plan)
        found: List[Violation] = []
        for a, src_idx, dst_idx in plan:
            v = _violation_from(
                a, sub_of(src_idx, dst_idx), src_idx, dst_idx, pods
            )
            if v is not None:
                found.append(v)
    for v in found:
        SERVE_ASSERTION_FAILURES_TOTAL.labels(assertion=v.assertion).inc()
    return found


def _assertion_submatrices(service, plan):
    """A ``(src_idx, dst_idx) -> reach submatrix`` provider for assertion
    checks: full matrix when it is free (clean dense engine, standing
    fallback) or forced (breaker not closed); batched source-row gather
    otherwise. On a packed engine the row gather is always the cheap path
    — the word kernels recompute from the resident maps, so there is no
    'clean matrix for free' rung."""
    eng = service.engine
    br = service._breaker
    packed = getattr(service, "packed", False)
    clean_dense = (
        not packed and eng._reach is not None and not eng._reach_dirty
    )
    rows_path = (
        service._fallback_reach is None
        and not clean_dense
        and (br is None or br.state == CLOSED)
    )
    if rows_path:
        uniq = np.unique(np.concatenate([p[1] for p in plan]))
        cfg = eng.config
        try:
            state = service._query_state()
            if packed:
                words = packed_reach_rows(
                    *_packed_operands(state), uniq, **state.meta["flags"]
                )
                rows = unpack_cols(
                    words, state.meta["n_padded"]
                )[:, : state.n]
            else:
                a = state.arrays
                rows = batched_reach_rows(
                    a["ing_count"],
                    a["eg_count"],
                    a["ing_iso"],
                    a["eg_iso"],
                    uniq,
                    self_traffic=cfg.self_traffic,
                    default_allow_unselected=cfg.default_allow_unselected,
                )
        except BackendError:
            rows = None  # engine state unusable: the solve ladder owns it
        if rows is not None:
            SERVE_SOLVES_TOTAL.labels(trigger="assertion_rows").inc()
            service.stats.solves["assertion_rows"] = (
                service.stats.solves.get("assertion_rows", 0) + 1
            )
            pos = {int(u): j for j, u in enumerate(uniq)}

            def sub_of(src_idx, dst_idx):
                r = np.fromiter(
                    (pos[int(x)] for x in src_idx), np.int64, src_idx.size
                )
                return rows[np.ix_(r, dst_idx)]

            return sub_of
    reach = service._solve("assertions")
    return lambda src_idx, dst_idx: reach[np.ix_(src_idx, dst_idx)]


# ----------------------------------------------------------------- what-if
@dataclass
class WhatIfResult:
    """Admission verdict for a candidate policy change (nothing committed).
    ``ok`` means no configured assertion would be violated."""

    ok: bool
    n_added: int
    n_removed: int
    added: List[Tuple[str, str]] = field(default_factory=list)
    removed: List[Tuple[str, str]] = field(default_factory=list)
    violations: List[Violation] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "pairs_added": self.n_added,
            "pairs_removed": self.n_removed,
            "added": [list(p) for p in self.added],
            "removed": [list(p) for p in self.removed],
            "violations": [v.describe() for v in self.violations],
        }


def _port_answer(
    res: VerifyResult, s: int, d: int, port: int, protocol: str
) -> bool:
    """Port-refined verdict from a ``compute_ports`` result: the numeric
    atom covering ``(protocol, port)`` decides; when no numbered atom
    covers it (degenerate universe — no relevant rule mentions ports) the
    any-port answer IS the exact refinement."""
    if res.reach_ports is not None:
        for q, atom in enumerate(res.port_atoms):
            if (
                atom.name is None
                and atom.protocol == protocol
                and atom.lo <= port <= atom.hi
            ):
                return bool(res.reach_ports[s, d, q])
    return bool(res.reach[s, d])


def _atom_table(
    res: VerifyResult, s: int, d: int
) -> Tuple[tuple, bool]:
    """The whole-pair port table :class:`QueryCache` memoizes: every
    numeric atom's verdict in atom order plus the any-port fallback.
    ``_table_answer`` over this table is ``_port_answer`` by construction
    — same atoms, same order, same fallback."""
    atoms = ()
    if res.reach_ports is not None:
        atoms = tuple(
            (a.protocol, a.lo, a.hi, bool(res.reach_ports[s, d, q]))
            for q, a in enumerate(res.port_atoms)
            if a.name is None
        )
    return atoms, bool(res.reach[s, d])


def _table_answer(
    entry: Tuple[tuple, bool], port: int, protocol: str
) -> bool:
    atoms, fallback = entry
    for proto, lo, hi, ok in atoms:
        if proto == protocol and lo <= port <= hi:
            return ok
    return fallback


@dataclass
class QueryCache:
    """Generation-keyed memo for the batched query path.

    Valid exactly while ``VerificationService.generation`` is unchanged —
    ``sync`` drops everything on a bump (any applied batch, including a
    ``full_resync``). What-if overlays never touch this: they derive on
    copy-on-write buffers and answer from their own matrices.

    * ``row_pos``/``row_mat`` — any-port reach rows by source pod index
      (bool [*, N] on a dense engine; uint32 word rows [*, Np/32] on a
      packed engine), stored as one [capacity, ·] matrix (geometric
      growth, so a
      long probe stream costs amortized O(1) copies per cached row — a
      per-batch concatenate would re-copy the whole cache every miss
      batch and dominate steady-state latency) answered with a single
      two-array fancy gather;
    * ``ports`` — per-(src, dst) port tables: every numeric port-atom
      verdict plus the any-port fallback, so ONE group solve answers
      every later port probe on the pair, not just the port that missed;
    * ``ref_idx`` — "namespace/name" → engine row, rebuilt per generation
      (a resync renumbers pods).
    """

    generation: int = -1
    row_pos: Dict[int, int] = field(default_factory=dict)
    row_mat: Optional[np.ndarray] = None  # bool or uint32 [cached, ·]
    ports: Dict[Tuple[int, int], Tuple[tuple, bool]] = field(
        default_factory=dict
    )
    ref_idx: Dict[str, int] = field(default_factory=dict)

    def sync(self, service) -> None:
        gen = service.generation
        if gen == self.generation:
            return
        self.row_pos.clear()
        self.row_mat = None
        self.ports.clear()
        self.ref_idx = {
            f"{ns}/{name}": i
            for (ns, name), i in service._pod_idx.items()
        }
        self.generation = gen

    def add_rows(self, src_idx: np.ndarray, rows: np.ndarray) -> None:
        base = len(self.row_pos)
        need = base + rows.shape[0]
        if self.row_mat is None or self.row_mat.shape[0] < need:
            cap = max(need, 2 * base, 64)
            grown = np.empty((cap, rows.shape[1]), dtype=rows.dtype)
            if base:
                grown[:base] = self.row_mat[:base]
            self.row_mat = grown
        self.row_mat[base:need] = rows
        for k, s in enumerate(src_idx):
            self.row_pos[int(s)] = base + k


class QueryEngine:
    """Query front end over a :class:`~.service.VerificationService`."""

    def __init__(self, service) -> None:
        self.service = service
        self._cache = QueryCache()

    # ------------------------------------------------------------- helpers
    def _count(self, kind: str) -> None:
        SERVE_QUERIES_TOTAL.labels(kind=kind).inc()
        st = self.service.stats
        st.queries[kind] = st.queries.get(kind, 0) + 1

    def _ref(self, ref: str) -> Tuple[str, str]:
        ns, sep, name = ref.partition("/")
        if not sep or not ns or not name:
            raise ServeError(
                f"pod reference must be NAMESPACE/NAME, got {ref!r}"
            )
        return ns, name

    def _idx(self, ref: str) -> int:
        ns, name = self._ref(ref)
        return self.service.pod_index(ns, name)

    # ------------------------------------------------------------- queries
    def can_reach(
        self,
        src: str,
        dst: str,
        port: Optional[int] = None,
        protocol: str = "TCP",
    ) -> bool:
        """Is ``src`` → ``dst`` allowed — on any port (``port=None``) or on
        a concrete ``(protocol, port)`` via the 2-pod oracle refinement."""
        self._count("can_reach")
        si, di = self._idx(src), self._idx(dst)
        if port is None:
            svc = self.service
            if getattr(svc, "packed", False):
                # matrix-free scalar answer: one word-row probe through
                # the packed batch path instead of a full [N,N] solve
                svc.flush()
                with svc._lock:
                    self._cache.sync(svc)
                    return bool(
                        self._any_port_batch(
                            np.asarray([si], dtype=np.int64),
                            np.asarray([di], dtype=np.int64),
                        )[0]
                    )
            return bool(svc.reach()[si, di])
        return self._can_reach_port(si, di, port, protocol)

    def _can_reach_port(
        self, si: int, di: int, port: int, protocol: str
    ) -> bool:
        self.service.flush()
        eng = self.service.engine
        # engine row indices, NOT as_cluster() positions — the packed
        # engine's as_cluster() compacts tombstoned rows away, so the two
        # numberings disagree after any pod removal
        pods = eng.pods
        pair = [pods[si]] + ([pods[di]] if di != si else [])
        # a NetworkPolicy only ever selects pods in its own namespace, so
        # only the pair's namespaces can contribute grants or isolation —
        # the rest of the policy list is dead weight for the 2-pod oracle
        pair_ns = {p.namespace for p in pair}
        cfg = eng.config
        res = verify(
            Cluster(
                pods=pair,
                namespaces=list(eng.namespaces),
                policies=[
                    p
                    for p in eng.policies.values()
                    if p.namespace in pair_ns
                ],
            ),
            VerifyConfig(
                backend="cpu",
                compute_ports=True,
                self_traffic=cfg.self_traffic,
                default_allow_unselected=cfg.default_allow_unselected,
                direction_aware_isolation=cfg.direction_aware_isolation,
            ),
        )
        s, d = (0, 0) if di == si else (0, 1)
        return _port_answer(res, s, d, port, protocol)

    # ------------------------------------------------------------- batched
    @staticmethod
    @contextlib.contextmanager
    def _stage(name: str):
        """One query-pipeline stage: a child span named ``query_<stage>``
        (so a reassembled trace shows where the batch's latency went) that
        also feeds ``kvtpu_query_latency_seconds{stage=...}``."""
        with trace(f"query_{name}", stage=name) as span:
            yield span
        QUERY_LATENCY_SECONDS.labels(stage=name).observe(span.seconds or 0.0)

    def can_reach_batch(
        self,
        queries: Optional[Sequence] = None,
        *,
        srcs: Optional[Sequence[str]] = None,
        dsts: Optional[Sequence[str]] = None,
        ports: Optional[Sequence[Optional[int]]] = None,
        protocols: Optional[Sequence[str]] = None,
    ) -> np.ndarray:
        """Answer a whole probe batch; returns bool [Q], bit-identical to
        calling :meth:`can_reach` per query.

        Accepts either ``queries`` — a sequence of ``(src, dst)``,
        ``(src, dst, port)`` or ``(src, dst, port, protocol)`` tuples
        (``port=None`` = any port; protocol defaults to TCP) — or the
        columnar keyword form. Any-port probes are answered from packed
        reach rows gathered for all distinct sources in ONE jitted device
        dispatch; missed ported probes are refined together by one oracle
        solve over the sub-cluster they jointly induce. Rows and per-pair
        port tables memoize in the generation-keyed :class:`QueryCache`."""
        if queries is not None:
            if srcs is not None or dsts is not None:
                raise ServeError(
                    "can_reach_batch takes queries= OR srcs=/dsts=, not both"
                )
            srcs, dsts, ports, protocols = [], [], [], []
            for i, q in enumerate(queries):
                q = tuple(q)
                if not 2 <= len(q) <= 4:
                    raise ServeError(
                        f"query {i}: expected (src, dst[, port[, protocol]])"
                        f", got {len(q)} fields"
                    )
                srcs.append(q[0])
                dsts.append(q[1])
                ports.append(q[2] if len(q) > 2 else None)
                protocols.append(q[3] if len(q) > 3 else "TCP")
        else:
            if srcs is None or dsts is None:
                raise ServeError(
                    "can_reach_batch needs queries= or both srcs= and dsts="
                )
            srcs, dsts = list(srcs), list(dsts)
            ports = list(ports) if ports is not None else [None] * len(srcs)
            protocols = (
                list(protocols)
                if protocols is not None
                else ["TCP"] * len(srcs)
            )
            if not len(srcs) == len(dsts) == len(ports) == len(protocols):
                raise ServeError(
                    "can_reach_batch columnar inputs must have equal length"
                )
        n_q = len(srcs)
        ans = np.zeros(n_q, dtype=bool)
        if n_q == 0:
            return ans
        QUERY_BATCH_SIZE.observe(float(n_q))
        SERVE_QUERIES_TOTAL.labels(kind="can_reach_batch").inc(n_q)
        st = self.service.stats
        st.queries["can_reach_batch"] = (
            st.queries.get("can_reach_batch", 0) + n_q
        )
        svc = self.service
        # the four pipeline stages every batched query pays, each a child
        # span feeding kvtpu_query_latency_seconds{stage}: queue (coalesced
        # writes flushed ahead of the read), dispatch (cache sync + index
        # gather), solve (device/oracle answers), d2h (host readback and
        # answer assembly)
        with trace("query_batch", n=n_q):
            with self._stage("queue"):
                svc.flush()
            with svc._lock:
                with self._stage("dispatch"):
                    cache = self._cache
                    cache.sync(svc)
                    ref_idx = cache.ref_idx
                    try:
                        si = np.fromiter(
                            (ref_idx[r] for r in srcs), np.int64, n_q
                        )
                        di = np.fromiter(
                            (ref_idx[r] for r in dsts), np.int64, n_q
                        )
                    except KeyError:
                        for r in list(srcs) + list(dsts):
                            self._idx(r)  # raises ServeError naming the bad ref
                        raise
                    ported = np.fromiter(
                        (p is not None for p in ports), bool, n_q
                    )
                any_res = ported_res = None
                with self._stage("solve"):
                    if not ported.all():
                        idx = np.nonzero(~ported)[0]
                        any_res = self._any_port_batch(si[idx], di[idx])
                    if ported.any():
                        items = [
                            (
                                int(k),
                                int(si[k]),
                                int(di[k]),
                                int(ports[k]),
                                str(protocols[k]),
                            )
                            for k in np.nonzero(ported)[0]
                        ]
                        ported_res = list(self._ported_batch(items))
                with self._stage("d2h"):
                    if any_res is not None:
                        ans[idx] = np.asarray(any_res)
                    if ported_res is not None:
                        for k, ok in ported_res:
                            ans[k] = ok
        return ans

    def _any_port_batch(self, s: np.ndarray, d: np.ndarray) -> np.ndarray:
        """Any-port answers for index pairs (lock held). The cache ladder
        mirrors the service's solve ladder: standing fallback matrix →
        clean engine → breaker not closed (delegate to the service) →
        batched row gather with generation-keyed memoization."""
        svc = self.service
        if svc._fallback_reach is not None:
            return svc._fallback_reach[s, d]
        if getattr(svc, "packed", False):
            return self._any_port_batch_packed(s, d)
        eng = svc.engine
        if eng._reach is not None and not eng._reach_dirty:
            return np.asarray(eng.reach)[s, d]
        br = svc._breaker
        if br is not None and br.state != CLOSED:
            # open/half-open: let the service ladder decide whether this
            # is a fast failure (card engine), a fallback answer (CPU
            # engine) or the one half-open probe
            return svc._solve("query")[s, d]
        cache = self._cache
        uniq, inv = np.unique(s, return_inverse=True)
        row_pos = cache.row_pos
        hit = np.fromiter(
            (int(u) in row_pos for u in uniq), bool, uniq.size
        )
        missing = uniq[~hit]
        if hit.any():
            QUERY_CACHE_HITS_TOTAL.labels(kind="rows").inc(
                int(hit.sum())
            )
        if missing.size:
            QUERY_CACHE_MISSES_TOTAL.labels(kind="rows").inc(
                int(missing.size)
            )
        cfg = eng.config
        try:
            state = svc._query_state()
            a = state.arrays
            if not row_pos:
                # cold cache: rows + per-probe answers in one dispatch
                rows, out = batched_any_port(
                    a["ing_count"],
                    a["eg_count"],
                    a["ing_iso"],
                    a["eg_iso"],
                    uniq,
                    inv,
                    d,
                    self_traffic=cfg.self_traffic,
                    default_allow_unselected=cfg.default_allow_unselected,
                )
                cache.add_rows(uniq, rows)
                return out
            if missing.size:
                rows = batched_reach_rows(
                    a["ing_count"],
                    a["eg_count"],
                    a["ing_iso"],
                    a["eg_iso"],
                    missing,
                    self_traffic=cfg.self_traffic,
                    default_allow_unselected=cfg.default_allow_unselected,
                )
                cache.add_rows(missing, rows)
        except BackendError:
            # engine state unusable even for the row gather: the service
            # ladder (breaker bookkeeping, then a raise on the card or the
            # from-scratch fallback on the CPU) owns it
            return svc._solve("query")[s, d]
        pos = np.fromiter(
            (row_pos[int(u)] for u in uniq), np.int64, uniq.size
        )
        return cache.row_mat[pos[inv], d]

    def _any_port_batch_packed(
        self, s: np.ndarray, d: np.ndarray
    ) -> np.ndarray:
        """Packed-engine any-port answers (lock held): word rows gathered
        straight from the resident per-policy maps, verdict bits extracted
        on device, unpacked never. The maps are always current (mutations
        rewrite them in place before ``apply`` returns), so there is no
        clean-engine rung and no breaker rung — the only fallbacks are the
        standing fallback matrix (checked by the caller) and the service
        solve ladder on a backend fault."""
        svc = self.service
        cache = self._cache
        uniq, inv = np.unique(s, return_inverse=True)
        row_pos = cache.row_pos
        hit = np.fromiter(
            (int(u) in row_pos for u in uniq), bool, uniq.size
        )
        missing = uniq[~hit]
        if hit.any():
            QUERY_CACHE_HITS_TOTAL.labels(kind="rows").inc(int(hit.sum()))
        if missing.size:
            QUERY_CACHE_MISSES_TOTAL.labels(kind="rows").inc(
                int(missing.size)
            )
        try:
            state = svc._query_state()
            fl = state.meta["flags"]
            ops_ = _packed_operands(state)
            if not row_pos:
                # cold cache: word rows + per-probe bits in one dispatch
                words, out = packed_any_port(*ops_, uniq, inv, d, **fl)
                cache.add_rows(uniq, words)
                return out
            if missing.size:
                cache.add_rows(
                    missing, packed_reach_rows(*ops_, missing, **fl)
                )
        except BackendError:
            return svc._solve("query")[s, d]
        pos = np.fromiter(
            (row_pos[int(u)] for u in uniq), np.int64, uniq.size
        )
        return _word_bits(cache.row_mat[pos[inv]], d)

    def _ported_batch(self, items) -> List[Tuple[int, bool]]:
        """Port-refined answers for ``(k, si, di, port, protocol)`` items
        (lock held). ALL cache misses of the batch induce one sub-cluster
        — their distinct pods plus the policies of their namespaces — and
        are settled by ONE oracle solve instead of a verify per probe.
        Exact: pair reachability is pair-local (no closure) and a policy
        only selects pods in its own namespace, so policies outside the
        involved namespaces cannot touch any probed pair, and policies of
        *other* involved namespaces only refine the port-atom partition,
        never a per-port verdict."""
        svc = self.service
        eng = svc.engine
        cache = self._cache
        out: List[Tuple[int, bool]] = []
        misses = []
        n_hits = 0
        for k, si, di, port, proto in items:
            entry = cache.ports.get((si, di))
            if entry is not None:
                n_hits += 1
                out.append((k, _table_answer(entry, port, proto)))
            else:
                misses.append((k, si, di, port, proto))
        if n_hits:
            QUERY_CACHE_HITS_TOTAL.labels(kind="ports").inc(n_hits)
        if not misses:
            return out
        QUERY_CACHE_MISSES_TOTAL.labels(kind="ports").inc(len(misses))
        pods = eng.pods
        involved = sorted({i for it in misses for i in (it[1], it[2])})
        loc = {p: j for j, p in enumerate(involved)}
        ns_set = {pods[i].namespace for i in involved}
        cfg = eng.config
        res = verify(
            Cluster(
                pods=[pods[i] for i in involved],
                namespaces=list(eng.namespaces),
                policies=[
                    p
                    for p in eng.policies.values()
                    if p.namespace in ns_set
                ],
            ),
            VerifyConfig(
                backend="cpu",
                compute_ports=True,
                self_traffic=cfg.self_traffic,
                default_allow_unselected=cfg.default_allow_unselected,
                direction_aware_isolation=cfg.direction_aware_isolation,
            ),
        )
        for k, si, di, port, proto in misses:
            entry = cache.ports.get((si, di))
            if entry is None:
                entry = _atom_table(res, loc[si], loc[di])
                cache.ports[(si, di)] = entry
            out.append((k, _table_answer(entry, port, proto)))
        return out

    def _reach_rows(self, src_idx: np.ndarray) -> np.ndarray:
        """Reach ROWS bool [U, N] for index array ``src_idx`` (lock held).
        Same ladder as :meth:`_any_port_batch` — standing fallback matrix →
        clean engine → breaker not closed (service ladder) → cached batched
        row gather — but returning whole rows instead of probe answers."""
        svc = self.service
        src_idx = np.asarray(src_idx, dtype=np.int64)
        if svc._fallback_reach is not None:
            return np.asarray(svc._fallback_reach)[src_idx, :]
        packed = getattr(svc, "packed", False)
        eng = svc.engine
        if not packed:
            if eng._reach is not None and not eng._reach_dirty:
                return np.asarray(eng.reach)[src_idx, :]
            br = svc._breaker
            if br is not None and br.state != CLOSED:
                return svc._solve("query")[src_idx, :]
        cache = self._cache
        row_pos = cache.row_pos
        uniq, inv = np.unique(src_idx, return_inverse=True)
        hit = np.fromiter(
            (int(u) in row_pos for u in uniq), bool, uniq.size
        )
        missing = uniq[~hit]
        if hit.any():
            QUERY_CACHE_HITS_TOTAL.labels(kind="rows").inc(int(hit.sum()))
        if missing.size:
            QUERY_CACHE_MISSES_TOTAL.labels(kind="rows").inc(
                int(missing.size)
            )
        cfg = eng.config
        try:
            state = svc._query_state()
            if missing.size:
                if packed:
                    rows = packed_reach_rows(
                        *_packed_operands(state),
                        missing,
                        **state.meta["flags"],
                    )
                else:
                    a = state.arrays
                    rows = batched_reach_rows(
                        a["ing_count"],
                        a["eg_count"],
                        a["ing_iso"],
                        a["eg_iso"],
                        missing,
                        self_traffic=cfg.self_traffic,
                        default_allow_unselected=(
                            cfg.default_allow_unselected
                        ),
                    )
                cache.add_rows(missing, rows)
        except BackendError:
            return svc._solve("query")[src_idx, :]
        pos = np.fromiter(
            (row_pos[int(u)] for u in uniq), np.int64, uniq.size
        )
        gathered = cache.row_mat[pos[inv], :]
        if packed:
            return unpack_cols(gathered, state.meta["n_padded"])[
                :, : state.n
            ]
        return gathered

    def _reach_cols(self, dst_idx: np.ndarray) -> np.ndarray:
        """Reach COLUMNS bool [N, U] for index array ``dst_idx`` (lock
        held) — the ``who_can_reach`` ladder over the batched column
        gather; columns are not memoized (sources repeat across probe
        streams, destinations rarely do)."""
        svc = self.service
        dst_idx = np.asarray(dst_idx, dtype=np.int64)
        if svc._fallback_reach is not None:
            return np.asarray(svc._fallback_reach)[:, dst_idx]
        eng = svc.engine
        if getattr(svc, "packed", False):
            try:
                state = svc._query_state()
                return packed_reach_cols(
                    *_packed_operands(state),
                    dst_idx,
                    n=state.n,
                    **state.meta["flags"],
                )
            except BackendError:
                return svc._solve("query")[:, dst_idx]
        if eng._reach is not None and not eng._reach_dirty:
            return np.asarray(eng.reach)[:, dst_idx]
        br = svc._breaker
        if br is not None and br.state != CLOSED:
            return svc._solve("query")[:, dst_idx]
        cfg = eng.config
        try:
            state = svc._query_state()
            a = state.arrays
            return batched_reach_cols(
                a["ing_count"],
                a["eg_count"],
                a["ing_iso"],
                a["eg_iso"],
                dst_idx,
                self_traffic=cfg.self_traffic,
                default_allow_unselected=cfg.default_allow_unselected,
            )
        except BackendError:
            return svc._solve("query")[:, dst_idx]

    def who_can_reach(self, dst: str) -> List[str]:
        """Every pod that can reach ``dst`` (one column of the matrix) —
        one batched column gather, never a full solve on a clean ladder."""
        self._count("who_can_reach")
        return self._who_can_reach_idx([self._idx(dst)])[0]

    def who_can_reach_batch(self, dsts: Sequence[str]) -> List[List[str]]:
        """``who_can_reach`` for many destinations in ONE device dispatch
        (the column-gather twin of ``can_reach_batch``'s row path)."""
        n_q = len(dsts)
        SERVE_QUERIES_TOTAL.labels(kind="who_can_reach_batch").inc(n_q)
        st = self.service.stats
        st.queries["who_can_reach_batch"] = (
            st.queries.get("who_can_reach_batch", 0) + n_q
        )
        return self._who_can_reach_idx([self._idx(d) for d in dsts])

    def _who_can_reach_idx(self, idx: List[int]) -> List[List[str]]:
        svc = self.service
        svc.flush()
        with svc._lock:
            self._cache.sync(svc)
            cols = self._reach_cols(np.asarray(idx, dtype=np.int64))
            pods = svc.engine.pods
            return [
                [
                    _pod_name(pods[i])
                    for i in np.nonzero(cols[:, k])[0]
                    if i != di
                ]
                for k, di in enumerate(idx)
            ]

    def blast_radius(self, src: str) -> List[str]:
        """Every pod that ``src`` can reach (one row of the matrix) — the
        exposure set if ``src`` is compromised. Rides the same cached
        batched row gather as ``can_reach_batch``."""
        self._count("blast_radius")
        return self._blast_radius_idx([self._idx(src)])[0]

    def blast_radius_batch(self, srcs: Sequence[str]) -> List[List[str]]:
        """``blast_radius`` for many sources in one dispatch, rows memoized
        in the generation-keyed cache."""
        n_q = len(srcs)
        SERVE_QUERIES_TOTAL.labels(kind="blast_radius_batch").inc(n_q)
        st = self.service.stats
        st.queries["blast_radius_batch"] = (
            st.queries.get("blast_radius_batch", 0) + n_q
        )
        return self._blast_radius_idx([self._idx(s) for s in srcs])

    def _blast_radius_idx(self, idx: List[int]) -> List[List[str]]:
        svc = self.service
        svc.flush()
        with svc._lock:
            self._cache.sync(svc)
            rows = self._reach_rows(np.asarray(idx, dtype=np.int64))
            pods = svc.engine.pods
            return [
                [
                    _pod_name(pods[i])
                    for i in np.nonzero(rows[k, :])[0]
                    if i != si
                ]
                for k, si in enumerate(idx)
            ]

    # ------------------------------------------------------------- paths
    def path_exists(
        self, src: str, dst: str, max_hops: Optional[int] = None
    ) -> bool:
        """Is there a multi-hop path ``src`` → ... → ``dst`` of at most
        ``max_hops`` edges (``None`` = any length)? Rides the bounded
        multi-source closure (``ops.closure.bounded_closure_rows``) seeded
        at ``src`` over the engine's batched row gather — per level the
        state is one ``[1, N]`` frontier, never an N×N closure."""
        self._count("path_exists")
        si, di = self._idx(src), self._idx(dst)
        acc, _ = self._bounded([si], max_hops)
        return bool(acc[0, di])

    def hops(
        self, src: str, dst: str, max_hops: Optional[int] = None
    ) -> int:
        """Shortest hop count of an allowed path ``src`` → ``dst`` (1 = a
        direct edge; with self-traffic ``src == dst`` is 1 via its own
        edge). Returns -1 when unreachable (within ``max_hops`` if
        given)."""
        self._count("hops")
        si, di = self._idx(src), self._idx(dst)
        _, hop = self._bounded([si], max_hops)
        h = int(hop[0, di])
        return h if h > 0 else -1

    def _bounded(self, seeds: Sequence[int], max_hops: Optional[int]):
        """Bounded closure from ``seeds`` over the serving ladder's row
        oracle (lock held for the whole BFS so every level answers from one
        generation)."""
        from ..ops.closure import bounded_closure_rows

        svc = self.service
        svc.flush()
        with svc._lock:
            self._cache.sync(svc)
            n = len(svc.engine.pods)
            return bounded_closure_rows(
                self._reach_rows, seeds, n, hops=max_hops,
                device=svc.engine.device,
            )

    # ------------------------------------------------------------- what-if
    def what_if(
        self,
        events: Sequence[Event],
        assertions: Optional[Sequence[Assertion]] = None,
        max_witnesses: int = 20,
    ) -> WhatIfResult:
        """Dry-run candidate policy events against a copy-on-write overlay
        of the engine's count matrices; the engine itself is untouched (its
        counts stay byte-equal). The first shift clones both count
        matrices; each shift then adds ``±1`` to its rows × columns block
        of the clones only.

        Only policy-shaped events admit (``AddPolicy`` / ``UpdatePolicy`` /
        ``RemovePolicy``) — label churn is not an admission decision."""
        self._count("what_if")
        svc = self.service
        if getattr(svc, "packed", False):
            raise ServeError(
                "what-if admission requires the dense serving engine: the "
                "copy-on-write overlay rides the dense count matrices "
                "(serve on an IncrementalVerifier to dry-run policy events)"
            )
        svc.flush()
        with svc._lock:
            before = svc._solve("query")
            eng = svc.engine
            ing = egc = None  # the clones, made on the first shift
            ing_iso = eng._ing_iso.copy()
            eg_iso = eng._eg_iso.copy()
            resident: Dict[str, tuple] = dict(eng._vectors)

            def shift(vecs, sign: int) -> None:
                nonlocal ing, egc, ing_iso, eg_iso
                if ing is None:
                    ing = eng._ing_count.clone()
                    egc = eng._eg_count.clone()
                sel_ing, sel_eg, ing_peers, eg_peers = vecs
                _rank1_add(ing, ing_peers, sel_ing, sign)
                _rank1_add(egc, sel_eg, eg_peers, sign)
                ing_iso += sign * np.asarray(sel_ing, dtype=np.int64)
                eg_iso += sign * np.asarray(sel_eg, dtype=np.int64)

            for ev in events:
                if isinstance(ev, (AddPolicy, UpdatePolicy)):
                    key = f"{ev.policy.namespace}/{ev.policy.name}"
                    if key in resident:
                        shift(resident.pop(key), -1)
                    vecs = eng._policy_vectors(ev.policy)
                    resident[key] = vecs
                    shift(vecs, +1)
                elif isinstance(ev, RemovePolicy):
                    key = f"{ev.namespace}/{ev.name}"
                    if key not in resident:
                        raise ServeError(
                            f"what-if removes unknown policy {key}"
                        )
                    shift(resident.pop(key), -1)
                else:
                    raise ServeError(
                        f"what-if admits policy events only, got {ev.kind}"
                    )
            cfg = eng.config
            dev = eng.device
            after = _derive_reach(
                ing if ing is not None else eng._ing_count,
                egc if egc is not None else eng._eg_count,
                torch.as_tensor(ing_iso.astype(np.int32), device=dev),
                torch.as_tensor(eg_iso.astype(np.int32), device=dev),
                self_traffic=cfg.self_traffic,
                default_allow_unselected=cfg.default_allow_unselected,
            )
            del ing, egc
            pods = eng.pods
            # the diff stays on the engine's device: only its counts, its
            # first witnesses and the assertions' submatrices cross to the
            # host (the JAX package diffs two host [N, N] matrices)
            before = torch.as_tensor(before, device=dev)  # read only: may alias
            added = after & ~before
            removed = before & ~after
            n_added, n_removed = int(added.sum()), int(removed.sum())
            added = _first_cells(added, max_witnesses)
            removed = _first_cells(removed, max_witnesses)
            checks = list(
                assertions if assertions is not None else svc.assertions
            )
            violations = _violations_on(checks, after, pods)
            del after, before
        name_pairs = lambda idx: [
            (_pod_name(pods[int(s)]), _pod_name(pods[int(d)]))
            for s, d in zip(*idx)
        ]
        return WhatIfResult(
            ok=not violations,
            n_added=n_added,
            n_removed=n_removed,
            added=name_pairs(added),
            removed=name_pairs(removed),
            violations=violations,
        )
