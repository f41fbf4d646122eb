"""Flow-aware torch rules: stream syncs inside registered dispatch functions,
dispatch keys that lie, and dispatch functions the warm pack misses.

The counterparts of the JAX package's ``rules_jax.py``, under the same rule
ids. The JAX rules need to know which functions are *traced*; the port
traces nothing — torch runs eagerly — so the functions that play that part
are the **registered dispatch functions**: the module-level functions a
``observe.aot.register_kernel`` or ``transient_kernel`` call names. They are
the port's hot device path (every engine op and query kernel goes through
one), their dispatch keys are what the warm pack records, and a host
round-trip inside one serialises the stream exactly where JAX would have
raised a ``ConcretizationTypeError``.

``jit-host-sync`` runs the JAX rule's within-function dataflow pass over
each registered function: its tensor parameters (not named in
``static_argnames``, annotated ``Tensor`` or not annotated at all) seed a
taint set, assignments propagate it to a fixpoint, and reads of host-side
metadata (``.shape``/``.dtype``/``.device``/``.ndim``, ``.numel()``,
``.size()``, ``len()``) kill it. A ``.item()``/``.tolist()``/``.cpu()``/
``.numpy()``/``bool()``/``int()``/``float()``/``np.asarray`` on a tainted
value, a Python branch on one, or any ``synchronize()`` stalls the stream
until the device catches up.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple, Union

from .core import FileContext, Finding, Rule, register
from .rules_hygiene import _dotted, _last_name

FunctionNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

#: attribute reads that return host-side metadata, not device data — taint
#: stops here (`x.shape[0]` is a Python int, no sync)
SHAPE_KILL_ATTRS = frozenset(
    {"shape", "dtype", "device", "ndim", "is_cuda", "layout", "itemsize",
     "requires_grad"}
)

#: calls that return host-side values without reading device data (the
#: last two build dispatch keys from shapes and dtypes: ``observe/jit.py``,
#: ``observe/aot.py``)
KILL_CALLS = frozenset(
    {"len", "isinstance", "type", "id", "repr", "numel", "size", "dim",
     "element_size", "is_contiguous", "data_ptr", "stride", "hasattr",
     "callable", "abstract_signature", "_leaf_sig"}
)

_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)

#: tensor methods that copy device data to the host (and so wait for the
#: stream to reach them)
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: calls that wait for the stream whatever their operands: `torch.cuda.
#: synchronize()`, `stream.synchronize()`, `event.synchronize()`
STALL_CALLS = frozenset({"synchronize"})

#: `bool(x)`/`float(x)`/`int(x)` of a tensor: an implicit `.item()`
CONCRETIZING_BUILTINS = frozenset({"bool", "float", "int", "complex"})

#: host-materialising calls by dotted name
HOST_FETCH_CALLS = frozenset({
    "np.asarray", "np.array", "numpy.asarray", "numpy.array",
})

#: registrar call names from ``observe.aot`` (leading underscores of
#: import aliases like ``_register_kernel`` are stripped before matching)
_AOT_REGISTRARS = frozenset({"register_kernel", "transient_kernel"})

#: the loaders of built libraries: ``ops/cuda_build.py::load_library`` (its
#: libraries are the ones ``save_pack`` ships) and a bare ``ctypes.CDLL``
#: (``native/binding.py``'s bitset library, which no pack ships)
_PACKED_LOADERS = frozenset({"load_library"})
_UNPACKED_LOADERS = frozenset({"CDLL"})

#: what the summaries' label pass shares with this module's taint pass
__all__ = [
    "SHAPE_KILL_ATTRS",
    "KILL_CALLS",
    "SYNC_METHODS",
    "STALL_CALLS",
    "CONCRETIZING_BUILTINS",
    "HOST_FETCH_CALLS",
    "value_parts",
    "bind_pairs",
]


def value_parts(node: ast.AST) -> List[ast.AST]:
    """The sub-expressions a value derives from, for the dataflow passes:
    a comprehension's value is its element (its iterables reach the element
    through the bound targets, which the passes bind separately); anything
    else is its children."""
    if isinstance(node, ast.DictComp):
        return [node.key, node.value]
    if isinstance(node, _COMPREHENSIONS):
        return [node.elt]
    return list(ast.iter_child_nodes(node))


def bind_pairs(
    target: ast.expr, value: ast.expr, loop: bool = False
) -> List[Tuple[ast.expr, List[ast.expr]]]:
    """(target, sources) pairs of an assignment (``loop``: of a ``for``
    over ``value``), matched element by element where the shapes show it:
    ``a, b = x, 1`` binds ``a`` to ``x`` and ``b`` to ``1``; ``for i, v in
    enumerate(xs)`` binds ``i`` to nothing (a host int) and ``v`` to ``xs``;
    ``for a, b in zip(xs, ys)`` binds each to its own sequence; ``for d, c
    in (("i", x), ("e", y))`` binds ``d`` to the strings and ``c`` to ``x``
    and ``y``. Otherwise the whole target takes the whole value."""
    if isinstance(target, (ast.Tuple, ast.List)) and not any(
        isinstance(e, ast.Starred) for e in target.elts
    ):
        n = len(target.elts)
        seq = (ast.Tuple, ast.List)
        if not loop and isinstance(value, seq) and len(value.elts) == n:
            return [(t, [v]) for t, v in zip(target.elts, value.elts)]
        if loop and isinstance(value, seq) and value.elts and all(
            isinstance(row, seq) and len(row.elts) == n for row in value.elts
        ):
            return [
                (t, [row.elts[k] for row in value.elts])
                for k, t in enumerate(target.elts)
            ]
        if loop and isinstance(value, ast.Call) and not value.keywords:
            name = _last_name(value.func)
            if name == "zip" and len(value.args) == n:
                out: List[Tuple[ast.expr, List[ast.expr]]] = []
                for elt, part in zip(target.elts, value.args):
                    out += bind_pairs(elt, part, loop=True)
                return out
            if name == "enumerate" and n == 2 and value.args:
                return [(target.elts[0], [])] + bind_pairs(
                    target.elts[1], value.args[0], loop=True
                )
    return [(target, [value])]


def _const_str_set(node: ast.expr) -> Set[str]:
    """A ``static_argnames`` value → the set of names it pins."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out: Set[str] = set()
        for elt in node.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                out.add(elt.value)
        return out
    return set()


def _param_names(fn: FunctionNode) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _all_args(fn: FunctionNode) -> List[ast.arg]:
    a = fn.args
    out = list(a.posonlyargs + a.args + a.kwonlyargs)
    if a.vararg:
        out.append(a.vararg)
    if a.kwarg:
        out.append(a.kwarg)
    return out


def tensor_params(fn: FunctionNode, static: Set[str] = frozenset()) -> Set[str]:
    """The parameters of ``fn`` that may hold a tensor: not pinned static,
    and either annotated with a type that mentions ``Tensor`` or not
    annotated at all (an ``int``/``bool``/``np.ndarray`` annotation says the
    value lives on the host)."""
    out: Set[str] = set()
    for arg in _all_args(fn):
        if arg.arg in static or arg.arg in ("self", "cls"):
            continue
        ann = arg.annotation
        if ann is None or "Tensor" in ast.dump(ann):
            out.add(arg.arg)
    return out


class _KernelSite:
    """One registered dispatch function: the def, the registrar's
    ``static_argnames`` and the registrar call."""

    def __init__(self, fn: FunctionNode, static: Set[str], call: ast.Call):
        self.fn = fn
        self.static = set(static)
        self.call = call


def _registrar(call: ast.Call) -> Optional[str]:
    name = (_last_name(call.func) or "").lstrip("_")
    return name if name in _AOT_REGISTRARS else None


def _registered_fn_arg(call: ast.Call) -> Optional[ast.expr]:
    """The function operand of ``register_kernel(engine, name, fn, ...)`` /
    ``transient_kernel(engine, name, fn, ...)``."""
    if len(call.args) >= 3:
        return call.args[2]
    for kw in call.keywords:
        if kw.arg == "fn":
            return kw.value
    return None


def collect_kernel_sites(
    tree: ast.AST,
) -> Tuple[List[_KernelSite], Dict[str, _KernelSite]]:
    """Every registered dispatch function of a module (the defs the
    module's ``register_kernel``/``transient_kernel`` calls name), plus a
    name → site map for call-site rules: the def's own name and every name
    the registrar's result is bound to (``_f = register_kernel(..., _f)``,
    ``square = transient_kernel(...)``)."""
    defs_by_name: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)

    sites: List[_KernelSite] = []
    by_name: Dict[str, _KernelSite] = {}
    site_of_call: Dict[int, _KernelSite] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _registrar(node) is None:
            continue
        target = _registered_fn_arg(node)
        if not isinstance(target, ast.Name):
            continue
        static: Set[str] = set()
        for kw in node.keywords:
            if kw.arg == "static_argnames":
                static |= _const_str_set(kw.value)
        for fn in defs_by_name.get(target.id, ()):
            site = _KernelSite(fn, static, node)
            sites.append(site)
            by_name.setdefault(target.id, site)
            site_of_call.setdefault(id(node), site)

    # bind `_f = register_kernel(...)` / `square = transient_kernel(...)`
    # result names so call-site rules see through the rebinding
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
            continue
        site = site_of_call.get(id(node.value))
        if site is None:
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                by_name.setdefault(tgt.id, site)
    return sites, by_name


class _TaintPass:
    """Within-function forward dataflow over device-tensor values."""

    def __init__(self, site: _KernelSite):
        self.fn = site.fn
        self.tainted: Set[str] = tensor_params(site.fn, site.static)

    # ---------------------------------------------------------- expression
    def is_tainted(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in SHAPE_KILL_ATTRS:
                return False
            return self.is_tainted(node.value)
        if isinstance(node, ast.Call):
            fname = _last_name(node.func)
            if fname in KILL_CALLS:
                return False
            if self.is_tainted(node.func):
                return True
            return any(self.is_tainted(a) for a in node.args) or any(
                self.is_tainted(kw.value) for kw in node.keywords
            )
        if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops
        ):
            return False  # identity tests read no device data
        if isinstance(node, (ast.Lambda, ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        return any(self.is_tainted(c) for c in value_parts(node))

    # ----------------------------------------------------------- statements
    def _bind(self, target: ast.expr, value_tainted: bool) -> bool:
        changed = False
        if isinstance(target, ast.Name):
            if value_tainted and target.id not in self.tainted:
                self.tainted.add(target.id)
                changed = True
            elif not value_tainted and target.id in self.tainted:
                # a host-origin rebind (e.g. `x = int(n)`) kills taint
                self.tainted.discard(target.id)
                changed = True
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                changed |= self._bind(elt, value_tainted)
        elif isinstance(target, ast.Starred):
            changed |= self._bind(target.value, value_tainted)
        return changed

    def _bind_from(self, target: ast.expr, value: ast.expr,
                   loop: bool = False) -> bool:
        changed = False
        for tgt, srcs in bind_pairs(target, value, loop):
            changed |= self._bind(tgt, any(self.is_tainted(v) for v in srcs))
        return changed

    def run(self) -> None:
        for _ in range(10):  # fixpoint; loops re-taint in later passes
            changed = False
            for node in ast.walk(self.fn):
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        changed |= self._bind_from(tgt, node.value)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    changed |= self._bind(node.target, self.is_tainted(node.value))
                elif isinstance(node, ast.AugAssign):
                    t = self.is_tainted(node.target) or self.is_tainted(node.value)
                    if t and isinstance(node.target, ast.Name):
                        if node.target.id not in self.tainted:
                            self.tainted.add(node.target.id)
                            changed = True
                elif isinstance(node, ast.NamedExpr):
                    changed |= self._bind(node.target, self.is_tainted(node.value))
                elif isinstance(node, (ast.For, ast.comprehension)):
                    changed |= self._bind_from(node.target, node.iter, loop=True)
                elif isinstance(node, ast.With):
                    for item in node.items:
                        if item.optional_vars is not None:
                            changed |= self._bind(
                                item.optional_vars,
                                self.is_tainted(item.context_expr),
                            )
            if not changed:
                break


@register
class JitHostSyncRule(Rule):
    id = "jit-host-sync"
    rationale = (
        "Inside a registered dispatch function (one an "
        "`observe.aot.register_kernel`/`transient_kernel` call names — the "
        "port's hot device path), a `.item()`/`.tolist()`/`.cpu()`/"
        "`.numpy()`/`bool()`/`int()`/`float()`/`np.asarray` on a device "
        "tensor, a Python branch on one, or a `synchronize()` stalls the "
        "host until the stream drains: the dispatch stops overlapping the "
        "device, every caller pays the round trip, and a batched query "
        "loop turns into one sync per call. The rule runs a within-function "
        "dataflow pass: the tensor parameters (not static, annotated "
        "`Tensor` or not annotated) seed the taint set, assignments "
        "propagate it, and host-metadata reads (`.shape`, `.dtype`, "
        "`.device`, `.numel()`, `.size()`, `len()`) kill it — so "
        "`int(x.shape[0])` passes while `int(x[0])` two assignments later "
        "is still caught. Interprocedural summaries carry a sink across "
        "helpers: a helper that syncs one of its parameters is flagged at "
        "the dispatch function's call feeding it a tensor. Return the "
        "tensor and read it back in the host driver instead."
    )
    example = (
        "def _step(x: torch.Tensor) -> torch.Tensor:\n"
        "    y = x * 2\n"
        "    z = y.sum()\n"
        "    return z.item()  # stream sync inside a dispatch function\n"
        "_step = register_kernel(\"engine\", \"_step\", _step)"
    )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        sites, _ = collect_kernel_sites(ctx.tree)
        seen: Set[Tuple[int, str]] = set()
        program = getattr(ctx, "program", None)
        for site in sites:
            taint = _TaintPass(site)
            taint.run()
            found = list(self._scan_sinks(ctx, site, taint))
            if program is not None:
                found += list(self._scan_helper_calls(ctx, site, taint, program))
            for f in found:
                key = (f.line, f.message)
                if key not in seen:
                    seen.add(key)
                    yield f

    def _scan_helper_calls(self, ctx: FileContext, site: _KernelSite,
                           taint: _TaintPass, program):
        """Cross-function sinks: a call inside a dispatch function whose
        argument feeds a callee parameter that (transitively) syncs, or a
        callee that stalls the stream whatever it is given."""
        from .callgraph import module_name

        module = module_name(ctx.rel)
        qn = program.graph.qname_of(site.fn)
        own = program.summaries.get(qn) if qn else None
        class_name = own.info.class_name if own else None
        for node in ast.walk(site.fn):
            if not isinstance(node, ast.Call):
                continue
            callee_qn = program.graph.resolve_call(module, node, class_name)
            callee = program.summaries.get(callee_qn) if callee_qn else None
            if callee is None:
                continue
            helper = callee.info.node.name
            if helper in KILL_CALLS:
                continue  # reads host metadata only
            if callee.stalls:
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    f"{helper}() performs {callee.stalls[0].described()} — "
                    "a stream stall reached from a dispatch function "
                    "through a helper call; synchronize in the host driver, "
                    "outside the dispatch path",
                )
            if not callee.param_syncs:
                continue
            offset = (
                1
                if callee.info.class_name
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in ("self", "cls")
                else 0
            )
            params = callee.local.params
            for j, sinks in sorted(callee.param_syncs.items()):
                expr: Optional[ast.expr] = None
                pos = j - offset
                if 0 <= pos < len(node.args):
                    expr = node.args[pos]
                elif j < len(params):
                    for kw in node.keywords:
                        if kw.arg == params[j]:
                            expr = kw.value
                if expr is None or not taint.is_tainted(expr):
                    continue
                pname = params[j] if j < len(params) else f"#{j}"
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    f"tensor passed to {helper}() parameter {pname!r}, "
                    f"which performs {sinks[0].described()} — stream sync "
                    "reached from a dispatch function through a helper "
                    "call; keep the value a tensor through the chain or "
                    "read it back in the host driver",
                )

    def _scan_sinks(self, ctx: FileContext, site: _KernelSite, taint: _TaintPass):
        for node in ast.walk(site.fn):
            if isinstance(node, ast.Call):
                fname = _last_name(node.func)
                dotted = _dotted(node.func)
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in SYNC_METHODS
                    and taint.is_tainted(node.func.value)
                ):
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f".{node.func.attr}() on a device tensor inside a "
                        "registered dispatch function — device→host copy "
                        "that stalls the stream on the hot path; return the "
                        "tensor and read it back in the host driver",
                    )
                elif fname in STALL_CALLS:
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f"{dotted or fname}() inside a registered dispatch "
                        "function — the host waits for the whole stream on "
                        "the hot path; synchronize in the host driver",
                    )
                elif (
                    isinstance(node.func, ast.Name)
                    and fname in CONCRETIZING_BUILTINS
                    and node.args
                    and taint.is_tainted(node.args[0])
                ):
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f"{fname}() of a device tensor inside a registered "
                        "dispatch function — an implicit .item() that stalls "
                        "the stream; keep it a tensor (torch.where) or "
                        "convert in the host driver",
                    )
                elif dotted in HOST_FETCH_CALLS and (
                    any(taint.is_tainted(a) for a in node.args)
                ):
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f"{dotted}() materialises a device tensor on the "
                        "host inside a registered dispatch function — use "
                        "torch ops or move the fetch to the host driver",
                    )
            elif isinstance(node, (ast.If, ast.While)) and taint.is_tainted(
                node.test
            ):
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    "Python branch on a device tensor inside a registered "
                    "dispatch function — an implicit bool() that stalls the "
                    "stream; use torch.where or branch in the host driver",
                )
            elif isinstance(node, ast.Assert) and taint.is_tainted(node.test):
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    "assert on a device tensor inside a registered dispatch "
                    "function — an implicit bool() that stalls the stream; "
                    "assert on host metadata only",
                )


def _tracker_names(tree: ast.AST) -> Set[str]:
    """Module-level names bound to a ``DispatchTracker(...)``."""
    out: Set[str] = set()
    for stmt in getattr(tree, "body", ()):
        if (
            isinstance(stmt, ast.Assign)
            and isinstance(stmt.value, ast.Call)
            and _last_name(stmt.value.func) == "DispatchTracker"
        ):
            out |= {t.id for t in stmt.targets if isinstance(t, ast.Name)}
    return out


@register
class AotUnregisteredKernelRule(Rule):
    id = "aot-unregistered-kernel"
    rationale = (
        "Warm start is a production SLO: every module-level dispatch "
        "function must be in the kernel manifest "
        "(`observe.aot.register_kernel` / `transient_kernel`) so its "
        "dispatch keys land in the checkpoint-shipped warm pack and "
        "`kvtpu_aot_cache_{hits,misses}_total` can account for it. A "
        "function is a dispatch function when the module's "
        "`DispatchTracker` tracks it by name (`_TRACKER.track(\"_f\", "
        "...)`) or when it loads a built library itself. One that loads "
        "through `ops/cuda_build.py::load_library` is covered by the pack, "
        "which ships every library `cuda_build` builds; one that loads a "
        "library with a bare `ctypes.CDLL` (the `native/binding.py` form) "
        "rebuilds it on every cold start, with nothing in the metrics to "
        "say why. Registration is one line at module end: "
        "`_f = register_kernel(\"engine\", \"_f\", _f, "
        "static_argnames=(...))`. Legacy modules predating the manifest "
        "are grandfathered in the port's `LINT_BASELINE.json`."
    )
    example = (
        "_TRACKER = DispatchTracker(\"engine\")\n"
        "def _my_step(x, *, tile):  # tracked, never passed to register_kernel\n"
        "    ...\n"
        "def apply(x):\n"
        "    _TRACKER.track(\"_my_step\", x)\n"
        "    return _my_step(x, tile=128)\n"
    )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        registered: Set[str] = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or _registrar(node) is None:
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name):
                    registered.add(arg.id)
                elif isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    registered.add(arg.value)
        trackers = _tracker_names(ctx.tree)
        tracked: Set[str] = set()
        if trackers:
            for node in ast.walk(ctx.tree):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "track"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in trackers
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    tracked.add(node.args[0].value)
        for stmt in ctx.tree.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name in registered:
                continue
            if stmt.name in tracked:
                yield Finding(
                    self.id, ctx.rel, stmt.lineno,
                    f"module-level dispatch function {stmt.name}() is "
                    "tracked by the module's DispatchTracker but not in the "
                    "kernel manifest — register it via observe.aot."
                    "register_kernel so the warm pack covers it",
                )
                continue
            if stmt.name in _PACKED_LOADERS:
                continue  # the pack's own loader: its libraries ship
            for node in ast.walk(stmt):
                if (
                    isinstance(node, ast.Call)
                    and _last_name(node.func) in _UNPACKED_LOADERS
                    # a library named by soname is the system's, not built
                    and not (
                        node.args
                        and isinstance(node.args[0], ast.Constant)
                    )
                ):
                    yield Finding(
                        self.id, ctx.rel, stmt.lineno,
                        f"module-level function {stmt.name}() loads a "
                        "built library the warm pack does not ship "
                        f"({_dotted(node.func) or 'CDLL'}) — build it "
                        "through ops/cuda_build.load_library or register "
                        "the dispatch via observe.aot.register_kernel",
                    )
                    break


_KEYISH = ("key", "sig", "cache", "memo")


def _contains_shape_attr(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Attribute) and n.attr == "shape"
        for n in ast.walk(node)
    )


@register
class RecompileHazardRule(Rule):
    id = "recompile-hazard"
    rationale = (
        "The port's dispatch keys — the warm pack's per-kernel keys "
        "(`register_kernel(static_argnames=...)`, `transient_kernel("
        "key_extras=...)`) and `observe.jit.abstract_signature`, which "
        "`kvtpu_jit_recompiles_total` counts — must say exactly what "
        "changed between two calls, or the pack's manifest and the "
        "first-dispatch counter lie. Flagged: (1) f-string/`str()` of "
        "`.shape` used as a cache key — string keys collide across dtypes "
        "and devices (key on the `abstract_signature` tuple instead); "
        "(2) `static_argnames` naming a parameter the registered function "
        "does not have — the typo'd name is silently keyed as a tensor "
        "operand; (3) a Python `float` or an unhashable list/dict/set "
        "literal passed for a static parameter of a registered function — "
        "every distinct float is a fresh manifest key (and NaN never "
        "matches), unhashables fail the key; (4) `tuple(d.values()/items()/"
        "keys())` fed straight into a registered call — the key then "
        "depends on dict iteration order (`sorted(...)` first)."
    )
    example = 'key = f"{x.shape}-{backend}"\n_cache[key] = built'

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        sites, by_name = collect_kernel_sites(ctx.tree)
        yield from self._check_shape_keys(ctx)
        yield from self._check_static_argnames(ctx, sites)
        yield from self._check_call_sites(ctx, by_name)

    # -------------------------------------------------- str(shape) keys
    def _check_shape_keys(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            is_shape_str = (
                isinstance(node, ast.JoinedStr) and _contains_shape_attr(node)
            ) or (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "str"
                and node.args
                and _contains_shape_attr(node.args[0])
            )
            if not is_shape_str:
                continue
            if self._used_as_key(ctx, node):
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    "stringified .shape used as a cache key — collides "
                    "across dtypes and devices, so the dispatch key lies "
                    "about what changed; key on the abstract-signature "
                    "tuple (observe.jit.abstract_signature) instead",
                )

    @staticmethod
    def _used_as_key(ctx: FileContext, node: ast.AST) -> bool:
        prev: ast.AST = node
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.Subscript) and prev is anc.slice:
                return True
            if isinstance(anc, ast.Assign):
                for tgt in anc.targets:
                    name = _last_name(tgt) or ""
                    if any(k in name.lower() for k in _KEYISH):
                        return True
            if isinstance(anc, ast.Call) and prev is not anc.func:
                name = _last_name(anc.func) or ""
                if any(k in name.lower() for k in _KEYISH):
                    return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return False
            prev = anc
        return False

    # --------------------------------------- static_argnames typo check
    def _check_static_argnames(self, ctx: FileContext,
                               sites: Sequence[_KernelSite]):
        for site in sites:
            params = set(_param_names(site.fn))
            unknown = sorted(site.static - params)
            if unknown:
                yield Finding(
                    self.id, ctx.rel, site.call.lineno,
                    f"static_argnames {unknown} name no parameter of "
                    f"{site.fn.name}() — the typo'd arg is keyed as a "
                    "tensor operand, so the warm pack never records its "
                    "value",
                )

    # ------------------------------------------ registered call sites
    def _check_call_sites(self, ctx: FileContext,
                          by_name: Dict[str, _KernelSite]):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = _last_name(node.func)
            site = by_name.get(callee or "")
            if site is None:
                continue
            for kw in node.keywords:
                if kw.arg not in site.static:
                    continue
                if isinstance(kw.value, ast.Constant) and isinstance(
                    kw.value.value, float
                ):
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f"Python float for static arg {kw.arg!r} of "
                        f"{callee}() — every distinct value is a fresh "
                        "dispatch key (and NaN never matches); pass it as "
                        "a tensor operand or quantise to int",
                    )
                elif isinstance(kw.value, (ast.List, ast.Dict, ast.Set)):
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f"unhashable literal for static arg {kw.arg!r} of "
                        f"{callee}() — a dispatch key's static args must "
                        "be hashable (use a tuple)",
                    )
            for arg in node.args:
                if (
                    isinstance(arg, ast.Call)
                    and isinstance(arg.func, ast.Name)
                    and arg.func.id == "tuple"
                    and arg.args
                    and isinstance(arg.args[0], ast.Call)
                    and isinstance(arg.args[0].func, ast.Attribute)
                    and arg.args[0].func.attr in ("values", "items", "keys")
                ):
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f"tuple(dict.{arg.args[0].func.attr}()) passed to "
                        f"registered {callee}() — the dispatch key then "
                        "depends on dict iteration order; sorted(...) it "
                        "first",
                    )
