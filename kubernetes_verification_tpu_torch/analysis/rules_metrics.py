"""Metric-discipline rules, copied from the JAX package unchanged: the
static twins of the live-registry checks (``observe/metrics.py``'s
``REQUIRED_FAMILIES``). They catch the registry's bug classes at the AST
layer, so they also run on fixture strings and on modules nothing imports.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import FileContext, Finding, Rule, register
from .rules_hygiene import _last_name

METRIC_NAME_RE = re.compile(r"^kvtpu_[a-z0-9_]+$")

#: registry constructor names (observe/registry.py)
_FAMILY_CLASSES = frozenset({"Counter", "Gauge", "Histogram"})

#: labels per family above which the exposition cardinality explodes:
#: every label multiplies the child count, and the dashboards key on
#: stable low-dimensional families
MAX_LABELS = 3


def _registrations(ctx: FileContext) -> List[Tuple[ast.Call, str, Sequence[str]]]:
    """(call, family-name, labelnames) for every static Counter/Gauge/
    Histogram construction with a literal name."""
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if _last_name(node.func) not in _FAMILY_CLASSES:
            continue
        if not (
            node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            continue
        name = node.args[0].value
        if not name.startswith("kvtpu"):
            continue  # not ours (fixture helpers, third-party shims)
        labels: Sequence[str] = ()
        label_node: Optional[ast.expr] = (
            node.args[2] if len(node.args) >= 3 else None
        )
        for kw in node.keywords:
            if kw.arg == "labelnames":
                label_node = kw.value
        if isinstance(label_node, (ast.Tuple, ast.List)):
            labels = [
                e.value
                for e in label_node.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            ]
        out.append((node, name, labels))
    return out


def _required_families(ctx: FileContext) -> Optional[Tuple[int, Set[str]]]:
    """(lineno, names) of a ``REQUIRED_FAMILIES = frozenset({...})`` /
    set-literal assignment, when this file declares one."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Assign):
            continue
        if not any(
            isinstance(t, ast.Name) and t.id == "REQUIRED_FAMILIES"
            for t in node.targets
        ):
            continue
        value = node.value
        if (
            isinstance(value, ast.Call)
            and _last_name(value.func) == "frozenset"
            and value.args
        ):
            value = value.args[0]
        if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            names = {
                e.value
                for e in value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
            return node.lineno, names
    return None


@register
class MetricsNamesRule(Rule):
    id = "metrics-names"
    rationale = (
        "Every family registered in the package must match "
        "`^kvtpu_[a-z0-9_]+$`: the Prometheus/JSON exporter output is a "
        "frozen contract (dashboards and scrape configs key on these "
        "names), and one camelCase or un-prefixed family silently forks "
        "the namespace."
    )
    example = 'BAD = Counter("kvtpuBadName", "help")'

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for call, name, _labels in _registrations(ctx):
            if not METRIC_NAME_RE.match(name):
                yield Finding(
                    self.id, ctx.rel, call.lineno,
                    f"metric family {name!r} does not match "
                    "^kvtpu_[a-z0-9_]+$ — the exporter namespace is a "
                    "frozen dashboard contract",
                )


@register
class MetricDisciplineRule(Rule):
    id = "metric-discipline"
    rationale = (
        "Two failure modes the registry cannot catch at runtime: a family "
        "emitted somewhere but never added to `REQUIRED_FAMILIES` (the "
        "dashboard contract) disappears without a failing lint when its "
        "registration site is later deleted; and a family with too many "
        "labels multiplies exposition cardinality until scrapes fall over. "
        f"Bound: at most {MAX_LABELS} labels per family."
    )
    example = (
        'WIDE = Counter("kvtpu_wide_total", "help",\n'
        '               ("a", "b", "c", "d"))  # 4 labels'
    )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for call, name, labels in _registrations(ctx):
            if len(labels) > MAX_LABELS:
                yield Finding(
                    self.id, ctx.rel, call.lineno,
                    f"family {name!r} declares {len(labels)} labels "
                    f"({', '.join(labels)}) — exposition cardinality is "
                    "multiplicative; bound is "
                    f"{MAX_LABELS}",
                )

    def check_project(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        required: Optional[Set[str]] = None
        req_ctx: Optional[FileContext] = None
        req_line = 0
        registered: Dict[str, Tuple[FileContext, int]] = {}
        for ctx in ctxs:
            found = _required_families(ctx)
            if found is not None:
                req_line, required = found
                req_ctx = ctx
            for call, name, _labels in _registrations(ctx):
                if METRIC_NAME_RE.match(name):
                    registered.setdefault(name, (ctx, call.lineno))
        if required is None:
            return  # nothing to cross-check against (fixture snippets)
        for name, (ctx, line) in sorted(registered.items()):
            if name not in required:
                yield Finding(
                    self.id, ctx.rel, line,
                    f"family {name!r} is emitted but never registered in "
                    "REQUIRED_FAMILIES — it can vanish from the dashboard "
                    "contract without a failing lint",
                )
        for name in sorted(required - set(registered)):
            yield Finding(
                self.id, req_ctx.rel, req_line,
                f"REQUIRED_FAMILIES names {name!r} but no registration "
                "site declares it — dead contract entry or a renamed "
                "family",
            )


#: names whose appearance inside a ``do_GET``/``do_POST`` body proves the
#: handler adopts the incoming trace context (observe/spans.py wire
#: contract)
_TRACE_PARSE_NAMES = frozenset({"parse_trace_header", "TRACE_HEADER"})

#: BaseHTTPRequestHandler entry points the adoption requirement covers
_HTTP_HANDLER_NAMES = frozenset({"do_GET", "do_POST"})


@register
class TraceContextRule(Rule):
    id = "trace-context"
    rationale = (
        "Distributed traces only join up when every HTTP hop carries the "
        "`X-Kvtpu-Trace` header: an outgoing `conn.request(...)` that "
        "passes no `headers` drops the caller's trace context on the "
        "floor, and a `do_GET`/`do_POST` handler that never parses the "
        "header (`parse_trace_header` / `TRACE_HEADER`) orphans every "
        "server-side span into a fresh trace. Either break silently turns "
        "`kv-tpu trace <id>` into a single-process view — the cross-"
        "process timeline still renders, it just lies by omission."
    )
    example = 'conn.request("GET", "/v1/tip")  # headers= missing'

    @staticmethod
    def _has_headers(call: ast.Call) -> bool:
        # http.client's signature is request(method, url, body, headers):
        # a 4th positional, an explicit headers=, or an opaque ** splat
        # (can't see inside statically) all count as propagating
        if len(call.args) >= 4:
            return True
        return any(kw.arg in ("headers", None) for kw in call.keywords)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "request"
                and not self._has_headers(node)
            ):
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    "outgoing HTTP request without headers= — pass "
                    "headers=trace_headers() so the X-Kvtpu-Trace context "
                    "survives the hop",
                )
            if (
                isinstance(node, ast.FunctionDef)
                and node.name in _HTTP_HANDLER_NAMES
            ):
                refs = {
                    n.id
                    for n in ast.walk(node)
                    if isinstance(n, ast.Name)
                } | {
                    n.attr
                    for n in ast.walk(node)
                    if isinstance(n, ast.Attribute)
                }
                if not (refs & _TRACE_PARSE_NAMES):
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f"{node.name} never parses the incoming trace "
                        "header (parse_trace_header/TRACE_HEADER) — "
                        "server-side spans orphan into fresh traces "
                        "instead of parenting under the caller's span",
                    )


#: uppercase module-level counters whose `.inc()` inside a loop marks that
#: loop as a multi-pass host iteration (squaring passes, BFS levels, delta
#: rounds — the package's pass-counter naming convention)
_PASS_COUNTER_RE = re.compile(r"^[A-Z0-9_]*(ITERATIONS|LEVELS|ROUNDS)[A-Z0-9_]*$")


@register
class LongLoopProgressRule(Rule):
    id = "long-loop-progress"
    rationale = (
        "A multi-pass host loop (one that bumps a pass counter like "
        "CLOSURE_ITERATIONS / *_LEVELS / *_ROUNDS per trip) can run for "
        "minutes at flagship scale with nothing but a frozen terminal to "
        "show for it. Every such loop must drive a ProgressTicker "
        "(`ticker.tick(...)` in the loop body) so operators get pass "
        "counts, smoothed rates and ETAs on /healthz, `kv-tpu jobs` and "
        "`kv-tpu top` — a silent long loop is indistinguishable from a "
        "hung one."
    )
    example = (
        "while True:\n"
        "    CLOSURE_ITERATIONS.inc()  # pass counter, no ticker.tick()\n"
        "    cur = step(cur)"
    )

    @staticmethod
    def _body_calls(loop: ast.AST) -> Iterable[ast.Call]:
        # the loop's own body/orelse only — a nested loop's calls belong
        # to the nested loop's finding (its ticks cannot discharge the
        # OUTER loop's obligation), and a nested def's calls to neither
        stack = list(ast.iter_child_nodes(loop))
        while stack:
            node = stack.pop()
            if isinstance(
                node,
                (ast.For, ast.While, ast.FunctionDef, ast.AsyncFunctionDef),
            ):
                continue
            if isinstance(node, ast.Call):
                yield node
            stack.extend(ast.iter_child_nodes(node))

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            counter = None
            ticked = False
            for call in self._body_calls(loop):
                if not isinstance(call.func, ast.Attribute):
                    continue
                if call.func.attr == "tick":
                    ticked = True
                elif (
                    call.func.attr == "inc"
                    and isinstance(call.func.value, ast.Name)
                    and _PASS_COUNTER_RE.match(call.func.value.id)
                ):
                    counter = call.func.value.id
            if counter and not ticked:
                yield Finding(
                    self.id, ctx.rel, loop.lineno,
                    f"multi-pass loop bumps {counter} but never calls "
                    "ticker.tick() — drive a ProgressTicker so the pass "
                    "count, rate and ETA reach /healthz and kv-tpu "
                    "jobs/top",
                )
