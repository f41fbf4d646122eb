"""Per-function summaries and their bottom-up interprocedural propagation.

Each indexed function (:mod:`.callgraph`) gets a **local summary** — facts
computed from its own AST with a parameter-label dataflow pass (which
parameters reach a stream-sync sink / a return, which parameters it writes
in place, whether it stalls the stream unconditionally, which
``torch.distributed`` collectives it calls over which mesh axes, which
exception types its ``raise`` statements can leak) — and a **propagated
summary** folding in its callees, computed over Tarjan SCCs in callee-first
order with a fixpoint inside each SCC so mutual recursion terminates at the
least solution.

The label pass generalises :class:`~.rules_torch._TaintPass` from one
boolean ("device tensor?") to *which parameter(s)* a value derives from:
the same kill set (``.shape``/``.dtype``/``.numel()``/``len()`` return host
metadata), the same assignment fixpoint, but an environment of
parameter-index sets. A helper's summary is therefore caller-agnostic —
``jit-host-sync`` decides at each call inside a registered dispatch
function whether the argument feeding a syncing parameter is a tensor
*there*.

The JAX package's donation map becomes an **in-place-write map**: this
package's engines mutate buffers in place where JAX donates them, so a
parameter is *written* when the function calls a ``*_()`` method on it,
assigns through a subscript of it, passes it as ``out=``, or hands it to a
``dist.all_reduce``-style collective — directly, or by passing it on to a
callee that writes it.

Local summaries are pure functions of one file's bytes, so they cache:
``.kvtpu_lint_cache.json`` (in the package directory, gitignored) maps each
file's sha256 to its serialised local summaries. A warm ``kv-tpu lint`` run re-parses
(every per-file rule needs the tree anyway) but skips the dataflow, the
dominant analysis cost; propagation is a cheap graph pass and always runs,
so cross-file facts are never stale. Cache health and graph size are
observables: ``kvtpu_lint_cache_hits_total`` and
``kvtpu_lint_callgraph_{nodes,edges}``.
"""
from __future__ import annotations

import ast
import hashlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .callgraph import CallGraph, FunctionInfo, build_callgraph
from .core import FileContext
from .rules_hygiene import _dotted, _last_name
from .rules_torch import (
    CONCRETIZING_BUILTINS,
    HOST_FETCH_CALLS,
    KILL_CALLS,
    SHAPE_KILL_ATTRS,
    STALL_CALLS,
    SYNC_METHODS,
    bind_pairs,
    value_parts,
)

__all__ = [
    "CACHE_NAME",
    "SyncSite",
    "LocalSummary",
    "Summary",
    "Program",
    "build_program",
    "default_cache_path",
]

CACHE_NAME = ".kvtpu_lint_cache.json"
_CACHE_VERSION = 1

#: ``parallel/mesh.py``'s named collectives → the position of their axis
#: argument, with its keyword name (None: the axis is fixed —
#: ``psum_counts`` always sums over grants)
MESH_COLLECTIVES: Dict[str, Optional[Tuple[int, str]]] = {
    "psum": (2, "axis"),
    "all_gather": (2, "axis"),
    "broadcast": (2, "axis"),
    "gather_rows": (4, "axis"),
    "psum_counts": None,
}

#: ``torch.distributed`` collectives (``dist.<name>(..., group=...)``); the
#: axis is the subscript of a ``group=<mesh>.groups[<axis>]`` argument
DIST_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
    "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "barrier", "gather", "scatter",
    "all_gather_object", "broadcast_object_list",
})

#: ``torch.distributed`` calls that write their first operand in place
DIST_WRITES_FIRST = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
    "reduce", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all_single", "recv", "irecv",
})

_DIST_HEADS = ("dist", "torch.distributed")


def default_cache_path() -> str:
    from .core import package_root

    return os.path.join(package_root(), CACHE_NAME)


# ------------------------------------------------------------- summaries
@dataclass
class SyncSite:
    """One host-sync (or concretisation) sink, with the helper chain that
    leads to it — ``via`` is empty for a direct sink."""

    kind: str
    rel: str
    line: int
    via: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        return {"kind": self.kind, "rel": self.rel, "line": self.line,
                "via": list(self.via)}

    @classmethod
    def from_dict(cls, d: dict) -> "SyncSite":
        return cls(d["kind"], d["rel"], int(d["line"]), tuple(d["via"]))

    def described(self) -> str:
        chain = " -> ".join(self.via)
        where = f"{self.rel}:{self.line}"
        if chain:
            return f"{self.kind} at {where} (via {chain})"
        return f"{self.kind} at {where}"


@dataclass
class LocalSummary:
    """Cacheable per-function facts (see module docstring)."""

    params: List[str] = field(default_factory=list)
    #: param indices whose value can reach a ``return``
    returns_params: List[int] = field(default_factory=list)
    #: param index → direct host-sync sinks on values derived from it
    syncs: Dict[int, List[SyncSite]] = field(default_factory=dict)
    #: direct collective calls: {kind, line, axes: [axis-expr dicts]}
    collectives: List[dict] = field(default_factory=list)
    #: direct raises escaping local handlers: {name, guards: [...]}
    raises: List[dict] = field(default_factory=list)
    #: param index → line of the first in-place write of that parameter
    mutates: Dict[int, int] = field(default_factory=dict)
    #: direct unconditional stream stalls (``synchronize()``)
    stalls: List[SyncSite] = field(default_factory=list)
    #: resolved-shape call sites: {shape, line, args: [[labels]],
    #: kwargs: {name: [labels]}, bare: [param index or -1], guards: [...]}
    calls: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "params": self.params,
            "returns_params": self.returns_params,
            "syncs": {str(i): [s.to_dict() for s in v]
                      for i, v in self.syncs.items()},
            "collectives": self.collectives,
            "raises": self.raises,
            "mutates": {str(i): ln for i, ln in self.mutates.items()},
            "stalls": [s.to_dict() for s in self.stalls],
            "calls": self.calls,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LocalSummary":
        return cls(
            params=list(d.get("params", [])),
            returns_params=[int(i) for i in d.get("returns_params", [])],
            syncs={int(i): [SyncSite.from_dict(s) for s in v]
                   for i, v in d.get("syncs", {}).items()},
            collectives=list(d.get("collectives", [])),
            raises=list(d.get("raises", [])),
            mutates={int(i): int(ln) for i, ln in d.get("mutates", {}).items()},
            stalls=[SyncSite.from_dict(s) for s in d.get("stalls", [])],
            calls=list(d.get("calls", [])),
        )


@dataclass
class Summary:
    """A function's propagated (callee-folded) summary."""

    info: FunctionInfo
    local: LocalSummary
    #: param index → every sync sink reachable from it, any call depth
    param_syncs: Dict[int, List[SyncSite]] = field(default_factory=dict)
    #: exception type names that can escape this function
    raises: Set[str] = field(default_factory=set)
    #: param index → (line, via-chain) of a reachable in-place write
    mutates: Dict[int, Tuple[int, Tuple[str, ...]]] = field(default_factory=dict)
    #: unconditional stream stalls reachable at any call depth
    stalls: List[SyncSite] = field(default_factory=list)


@dataclass
class Program:
    """The interprocedural view rules consume: graph + summaries."""

    graph: CallGraph
    summaries: Dict[str, Summary]
    cache_hits: int = 0
    cache_misses: int = 0

    def summary_for_node(self, node: ast.AST) -> Optional[Summary]:
        qn = self.graph.qname_of(node)
        return self.summaries.get(qn) if qn else None

    def resolve_axis(self, module: str, axis: dict) -> Optional[str]:
        """A serialised axis expression → its string value, when static."""
        if "s" in axis:
            return axis["s"]
        if "n" in axis:
            return self.graph.str_constants.get(module, {}).get(axis["n"])
        if "a" in axis:
            base, attr = axis["a"]
            target = self.graph.module_aliases.get(module, {}).get(base)
            if target is not None:
                return self.graph.str_constants.get(target, {}).get(attr)
        return None


# ------------------------------------------------------- label dataflow
class _LabelFlow:
    """Forward dataflow mapping each local name to the set of parameter
    indices its value may derive from."""

    def __init__(self, fn: ast.AST, params: List[str]):
        self.fn = fn
        self.env: Dict[str, Set[int]] = {p: {i} for i, p in enumerate(params)}

    def labels(self, node: ast.AST) -> Set[int]:
        if isinstance(node, ast.Name):
            return self.env.get(node.id, set())
        if isinstance(node, ast.Constant):
            return set()
        if isinstance(node, ast.Attribute):
            if node.attr in SHAPE_KILL_ATTRS:
                return set()
            return self.labels(node.value)
        if isinstance(node, ast.Call):
            if _last_name(node.func) in KILL_CALLS:
                return set()
            out = self.labels(node.func)
            for a in node.args:
                out |= self.labels(a)
            for kw in node.keywords:
                out |= self.labels(kw.value)
            return out
        if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            return set()
        out: Set[int] = set()
        for child in value_parts(node):
            out |= self.labels(child)
        return out

    def _bind(self, target: ast.expr, labels: Set[int]) -> bool:
        changed = False
        if isinstance(target, ast.Name):
            cur = self.env.get(target.id)
            if cur != labels:
                self.env[target.id] = set(labels)
                changed = True
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                changed |= self._bind(elt, labels)
        elif isinstance(target, ast.Starred):
            changed |= self._bind(target.value, labels)
        return changed

    def _bind_from(self, target: ast.expr, value: ast.expr,
                   loop: bool = False) -> bool:
        changed = False
        for tgt, srcs in bind_pairs(target, value, loop):
            lab: Set[int] = set()
            for v in srcs:
                lab |= self.labels(v)
            changed |= self._bind(tgt, lab)
        return changed

    def run(self) -> None:
        for _ in range(10):
            changed = False
            for node in ast.walk(self.fn):
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        changed |= self._bind_from(tgt, node.value)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    changed |= self._bind(node.target, self.labels(node.value))
                elif isinstance(node, ast.AugAssign):
                    if isinstance(node.target, ast.Name):
                        lab = self.labels(node.target) | self.labels(node.value)
                        changed |= self._bind(node.target, lab)
                elif isinstance(node, ast.NamedExpr):
                    changed |= self._bind(node.target, self.labels(node.value))
                elif isinstance(node, (ast.For, ast.comprehension)):
                    changed |= self._bind_from(node.target, node.iter, loop=True)
                elif isinstance(node, ast.With):
                    for item in node.items:
                        if item.optional_vars is not None:
                            changed |= self._bind(
                                item.optional_vars,
                                self.labels(item.context_expr),
                            )
            if not changed:
                break


def _branch_labels(flow: _LabelFlow, test: ast.expr) -> Set[int]:
    """Labels of a branch condition, minus ``is``/``is not`` comparisons —
    identity tests (``if x is not None:``) read no device data."""
    if isinstance(test, ast.Compare) and all(
        isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops
    ):
        return set()
    if isinstance(test, ast.BoolOp):
        out: Set[int] = set()
        for v in test.values:
            out |= _branch_labels(flow, v)
        return out
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _branch_labels(flow, test.operand)
    return flow.labels(test)


def _param_names(fn) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _call_shape(call: ast.Call) -> Optional[dict]:
    """Serialise how a call names its callee, for later resolution."""
    func = call.func
    if isinstance(func, ast.Name):
        return {"name": func.id}
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        if func.value.id in ("self", "cls"):
            return {"method": func.attr}
        return {"attr": [func.value.id, func.attr]}
    return None


def _resolve_shape(
    graph: CallGraph, module: str, class_name: Optional[str], shape: dict
) -> Optional[str]:
    if "name" in shape:
        return graph.module_scopes.get(module, {}).get(shape["name"])
    if "method" in shape and class_name:
        qn = f"{module}:{class_name}.{shape['method']}"
        return qn if qn in graph.functions else None
    if "attr" in shape:
        base, attr = shape["attr"]
        target = graph.module_aliases.get(module, {}).get(base)
        if target is not None:
            qn = f"{target}:{attr}"
            if qn in graph.functions:
                return qn
    return None


def _axis_exprs(node: ast.expr) -> List[dict]:
    """Serialise an ``axis_name`` argument: literal strings, names, and
    module-attribute reads survive; anything else is dynamic."""
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[dict] = []
        for elt in node.elts:
            out.extend(_axis_exprs(elt))
        return out
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [{"s": node.value}]
    if isinstance(node, ast.Name):
        return [{"n": node.id}]
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return [{"a": [node.value.id, node.attr]}]
    return [{"dyn": True}]


def _is_collective(call: ast.Call) -> Optional[Tuple[str, Optional[ast.expr]]]:
    """(kind, axis expression or None) when ``call`` is one of
    ``parallel/mesh.py``'s named collectives or a ``torch.distributed``
    collective, else None. A ``dist.*`` call's axis is the subscript of its
    ``group=<mesh>.groups[<axis>]`` argument (None: another group form)."""
    name = _last_name(call.func)
    dotted = _dotted(call.func)
    head = dotted.rsplit(".", 1)[0] if dotted and "." in dotted else None
    if head in _DIST_HEADS:
        if name not in DIST_COLLECTIVES:
            return None
        axis: Optional[ast.expr] = None
        for kw in call.keywords:
            if (
                kw.arg == "group"
                and isinstance(kw.value, ast.Subscript)
                and _last_name(kw.value.value) == "groups"
            ):
                axis = kw.value.slice
        return f"dist.{name}", axis
    if name not in MESH_COLLECTIVES:
        return None
    spec = MESH_COLLECTIVES[name]
    if spec is None:
        return name, None
    pos, kwname = spec
    axis = call.args[pos] if len(call.args) > pos else None
    for kw in call.keywords:
        if kw.arg == kwname:
            axis = kw.value
    return name, axis


def _subscript_base(node: ast.expr) -> Optional[str]:
    """The Name a (possibly subscripted) expression is rooted at:
    ``x`` → x, ``x[i]`` / ``x[i][j]`` → x; attribute chains → None."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _in_place_writes(fn: ast.AST) -> List[Tuple[str, int]]:
    """(name, line) of every in-place write in ``fn``: a ``*_()`` method on
    a name or a subscript of one, an assignment through a subscript, an
    ``out=`` operand, or the first operand of a ``dist.*`` collective that
    writes it."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            func = node.func
            if (
                isinstance(func, ast.Attribute)
                and func.attr.endswith("_")
                and not func.attr.startswith("_")
            ):
                base = _subscript_base(func.value)
                if base is not None:
                    out.append((base, node.lineno))
            for kw in node.keywords:
                if kw.arg == "out":
                    base = _subscript_base(kw.value)
                    if base is not None:
                        out.append((base, node.lineno))
            dotted = _dotted(func)
            if (
                dotted
                and "." in dotted
                and dotted.rsplit(".", 1)[0] in _DIST_HEADS
                and _last_name(func) in DIST_WRITES_FIRST
                and node.args
            ):
                base = _subscript_base(node.args[0])
                if base is not None:
                    out.append((base, node.lineno))
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Subscript):
                    base = _subscript_base(tgt)
                    if base is not None:
                        out.append((base, node.lineno))
    return out


def _exc_name(node: Optional[ast.expr]) -> Optional[str]:
    if node is None:
        return None
    if isinstance(node, ast.Call):
        return _last_name(node.func)
    return _last_name(node)


def _handler_names(handler: ast.ExceptHandler) -> List[str]:
    if handler.type is None:
        return ["BaseException"]
    if isinstance(handler.type, ast.Tuple):
        return [n for n in (_last_name(e) for e in handler.type.elts) if n]
    n = _last_name(handler.type)
    return [n] if n else []


def _compute_local(info: FunctionInfo) -> LocalSummary:
    """One function's local summary: label dataflow + sink/collective/
    raise/in-place-write extraction."""
    fn = info.node
    params = _param_names(fn)
    flow = _LabelFlow(fn, params)
    flow.run()
    out = LocalSummary(params=params)

    # a parameter the function never rebinds still names the caller's
    # tensor wherever it appears, so its writes and bare hand-offs are the
    # caller's
    rebound = {
        n.id for n in ast.walk(fn)
        if isinstance(n, ast.Name) and not isinstance(n.ctx, ast.Load)
    }
    own_param = {p: i for i, p in enumerate(params) if p not in rebound}
    for name, line in _in_place_writes(fn):
        i = own_param.get(name)
        if i is not None:
            out.mutates.setdefault(i, line)

    returns: Set[int] = set()
    syncs: Dict[int, List[SyncSite]] = {}

    def add_sync(labels: Set[int], kind: str, line: int) -> None:
        for i in labels:
            syncs.setdefault(i, []).append(SyncSite(kind, info.rel, line))

    # guards: exception type names caught by try blocks enclosing a node
    guard_of: Dict[int, Tuple[str, ...]] = {}

    def walk_guarded(node: ast.AST, guards: Tuple[str, ...]) -> None:
        if isinstance(node, ast.Try):
            inner = guards + tuple(
                n for h in node.handlers for n in _handler_names(h)
            )
            for child in node.body:
                guard_of[id(child)] = inner
                walk_guarded(child, inner)
            for part in (node.orelse, node.finalbody):
                for child in part:
                    walk_guarded(child, guards)
            for h in node.handlers:
                for child in h.body:
                    walk_guarded(child, guards)
            return
        for child in ast.iter_child_nodes(node):
            walk_guarded(child, guards)
            guard_of.setdefault(id(child), guards)

    walk_guarded(fn, ())

    for node in ast.walk(fn):
        guards = list(guard_of.get(id(node), ()))
        if isinstance(node, ast.Return) and node.value is not None:
            returns |= flow.labels(node.value)
        elif isinstance(node, ast.Raise):
            name = _exc_name(node.exc)
            if name:
                out.raises.append(
                    {"name": name, "guards": guards, "line": node.lineno}
                )
        elif isinstance(node, (ast.If, ast.While)):
            add_sync(_branch_labels(flow, node.test), "Python branch",
                     node.lineno)
        elif isinstance(node, ast.Assert):
            add_sync(_branch_labels(flow, node.test), "assert", node.lineno)
        elif isinstance(node, ast.Call):
            coll = _is_collective(node)
            if coll is not None:
                kind, axis_node = coll
                out.collectives.append({
                    "kind": kind,
                    "line": node.lineno,
                    "axes": _axis_exprs(axis_node) if axis_node is not None
                    else [],
                })
            if _last_name(node.func) in STALL_CALLS:
                out.stalls.append(SyncSite(
                    f"{_dotted(node.func) or 'synchronize'}()", info.rel,
                    node.lineno,
                ))
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr in SYNC_METHODS
            ):
                add_sync(
                    flow.labels(node.func.value),
                    f".{node.func.attr}()", node.lineno,
                )
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in CONCRETIZING_BUILTINS
                and node.args
            ):
                add_sync(
                    flow.labels(node.args[0]),
                    f"{node.func.id}()", node.lineno,
                )
            elif _dotted(node.func) in HOST_FETCH_CALLS:
                lab: Set[int] = set()
                for a in node.args:
                    lab |= flow.labels(a)
                add_sync(lab, f"{_dotted(node.func)}()", node.lineno)

            shape = _call_shape(node)
            if shape is not None:
                # a host-metadata call (KILL_CALLS) reads no device data:
                # whatever its body does, no tensor of ours reaches it
                host_only = _last_name(node.func) in KILL_CALLS
                out.calls.append({
                    "shape": shape,
                    "line": node.lineno,
                    "args": [
                        [] if host_only else sorted(flow.labels(a))
                        for a in node.args
                    ],
                    # a bare own parameter handed on: the callee's in-place
                    # writes of that slot are this function's writes
                    "bare": [
                        own_param.get(a.id, -1) if isinstance(a, ast.Name)
                        else -1
                        for a in node.args
                    ],
                    "kwargs": {
                        kw.arg: sorted(flow.labels(kw.value))
                        for kw in node.keywords
                        if kw.arg is not None and not host_only
                    },
                    "guards": guards,
                })

    out.returns_params = sorted(returns)
    out.syncs = syncs
    return out


# ----------------------------------------------------------- propagation
#: builtin exception hierarchy the guard filter understands (the package's
#: own taxonomy is read from class defs at propagation time)
_BUILTIN_BASES: Dict[str, Tuple[str, ...]] = {
    "ValueError": ("Exception",),
    "TypeError": ("Exception",),
    "KeyError": ("LookupError",),
    "IndexError": ("LookupError",),
    "LookupError": ("Exception",),
    "RuntimeError": ("Exception",),
    "NotImplementedError": ("RuntimeError",),
    "OSError": ("Exception",),
    "IOError": ("OSError",),
    "ArithmeticError": ("Exception",),
    "ZeroDivisionError": ("ArithmeticError",),
    "AttributeError": ("Exception",),
    "StopIteration": ("Exception",),
    "ImportError": ("Exception",),
    "ModuleNotFoundError": ("ImportError",),
    "AssertionError": ("Exception",),
    "Exception": ("BaseException",),
    "KeyboardInterrupt": ("BaseException",),
    "SystemExit": ("BaseException",),
}


def exception_ancestors(
    name: str, class_bases: Dict[str, Tuple[str, ...]]
) -> Set[str]:
    """All (known) ancestors of an exception type, itself included."""
    seen: Set[str] = set()
    todo = [name]
    while todo:
        cur = todo.pop()
        if cur in seen:
            continue
        seen.add(cur)
        todo.extend(class_bases.get(cur, ()))
        todo.extend(_BUILTIN_BASES.get(cur, ()))
    return seen


def _caught_by(
    name: str, guards: Sequence[str], class_bases: Dict[str, Tuple[str, ...]]
) -> bool:
    if not guards:
        return False
    ancestors = exception_ancestors(name, class_bases)
    return any(g in ancestors for g in guards)


def _map_call_labels(call: dict, callee: Summary) -> Dict[int, Set[int]]:
    """Callee param index → caller labels flowing into it at this site."""
    offset = 1 if "method" in call["shape"] and callee.info.class_name else 0
    out: Dict[int, Set[int]] = {}
    for k, labels in enumerate(call["args"]):
        if labels:
            out.setdefault(k + offset, set()).update(labels)
    if call["kwargs"]:
        index_of = {p: i for i, p in enumerate(callee.local.params)}
        for pname, labels in call["kwargs"].items():
            if labels and pname in index_of:
                out.setdefault(index_of[pname], set()).update(labels)
    return out


_MAX_SYNCS_PER_PARAM = 4  # keep summaries (and messages) bounded


def _propagate(graph: CallGraph, summaries: Dict[str, Summary]) -> None:
    for scc in graph.sccs_bottom_up():
        for _ in range(len(scc) + 1):
            changed = False
            for qn in scc:
                s = summaries[qn]
                info = s.info
                for call in s.local.calls:
                    callee_qn = _resolve_shape(
                        graph, info.module, info.class_name, call["shape"]
                    )
                    if callee_qn is None or callee_qn not in summaries:
                        continue
                    callee = summaries[callee_qn]
                    label_map = _map_call_labels(call, callee)
                    step = callee.info.node.name
                    # syncs: callee param j syncs + our labels reach j
                    for j, sites in callee.param_syncs.items():
                        for i in label_map.get(j, ()):
                            mine = s.param_syncs.setdefault(i, [])
                            for site in sites:
                                if len(site.via) >= 6:
                                    continue
                                lifted = SyncSite(
                                    site.kind, site.rel, site.line,
                                    (step,) + site.via,
                                )
                                if lifted not in mine and len(mine) < _MAX_SYNCS_PER_PARAM:
                                    mine.append(lifted)
                                    changed = True
                    # in-place writes lift through bare parameter
                    # hand-offs only (a derived value is a new tensor)
                    offset = (
                        1 if "method" in call["shape"] and callee.info.class_name
                        else 0
                    )
                    for j, (line, via) in callee.mutates.items():
                        pos = j - offset
                        bare = call.get("bare", [])
                        i = bare[pos] if 0 <= pos < len(bare) else -1
                        if i >= 0 and i not in s.mutates and len(via) < 6:
                            s.mutates[i] = (call["line"], (step,) + via)
                            changed = True
                    # unconditional stalls lift whatever the arguments
                    for site in callee.stalls:
                        if len(site.via) >= 6 or len(s.stalls) >= _MAX_SYNCS_PER_PARAM:
                            continue
                        lifted = SyncSite(
                            site.kind, site.rel, site.line, (step,) + site.via
                        )
                        if lifted not in s.stalls:
                            s.stalls.append(lifted)
                            changed = True
                    # raises: callee escapes filtered by this site's guards
                    for r in callee.raises:
                        if r in s.raises:
                            continue
                        if _caught_by(r, call["guards"], graph.class_bases):
                            continue
                        s.raises.add(r)
                        changed = True
            if not changed:
                break


# ------------------------------------------------------------------ cache
def _load_cache(path: str) -> dict:
    try:
        with open(path, "r") as fh:
            data = json.load(fh)
    except (OSError, json.JSONDecodeError):
        return {}
    if data.get("version") != _CACHE_VERSION:
        return {}
    files = data.get("files")
    return files if isinstance(files, dict) else {}


def _save_cache(path: str, files: dict) -> None:
    body = json.dumps({"version": _CACHE_VERSION, "files": files})
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(body)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def build_program(
    ctxs: Sequence[FileContext],
    cache_path: Optional[str] = None,
) -> Program:
    """Callgraph + summaries for a set of parsed files. ``cache_path``
    enables the content-hash local-summary cache (propagation always runs
    fresh, so cross-file facts cannot go stale)."""
    graph = build_callgraph(ctxs)
    by_rel: Dict[str, List[FunctionInfo]] = {}
    for info in graph.functions.values():
        by_rel.setdefault(info.rel, []).append(info)

    cache = _load_cache(cache_path) if cache_path else {}
    new_cache: dict = {}
    hits = misses = 0
    locals_by_qname: Dict[str, LocalSummary] = {}

    for ctx in ctxs:
        if ctx.tree is None:
            continue
        infos = by_rel.get(ctx.rel, [])
        digest = hashlib.sha256(ctx.source.encode("utf-8")).hexdigest()
        entry = cache.get(ctx.rel)
        cached_fns = (
            entry.get("functions", {})
            if entry and entry.get("hash") == digest
            else None
        )
        if cached_fns is not None and set(cached_fns) == {
            i.qname for i in infos
        }:
            hits += 1
            for info in infos:
                locals_by_qname[info.qname] = LocalSummary.from_dict(
                    cached_fns[info.qname]
                )
            new_cache[ctx.rel] = entry
            continue
        misses += 1
        fresh: Dict[str, dict] = {}
        for info in infos:
            local = _compute_local(info)
            locals_by_qname[info.qname] = local
            fresh[info.qname] = local.to_dict()
        new_cache[ctx.rel] = {"hash": digest, "functions": fresh}

    summaries: Dict[str, Summary] = {}
    for qn, info in graph.functions.items():
        local = locals_by_qname.get(qn, LocalSummary())
        summaries[qn] = Summary(
            info=info,
            local=local,
            param_syncs={i: list(v) for i, v in local.syncs.items()},
            raises={
                r["name"]
                for r in local.raises
                if not _caught_by(r["name"], r["guards"], graph.class_bases)
            },
            mutates={i: (ln, ()) for i, ln in local.mutates.items()},
            stalls=list(local.stalls),
        )
    _propagate(graph, summaries)

    if cache_path and misses:
        try:
            _save_cache(cache_path, new_cache)
        except OSError:
            pass  # read-only checkout: the cache is an optimisation only

    program = Program(graph, summaries, cache_hits=hits, cache_misses=misses)
    try:
        from ..observe.metrics import (
            LINT_CACHE_HITS_TOTAL,
            LINT_CALLGRAPH_EDGES,
            LINT_CALLGRAPH_NODES,
        )

        LINT_CALLGRAPH_NODES.set(len(graph.functions))
        LINT_CALLGRAPH_EDGES.set(graph.n_edges)
        if hits:
            LINT_CACHE_HITS_TOTAL.inc(hits)
    except ImportError:  # linting outside an installed package tree
        pass
    return program
