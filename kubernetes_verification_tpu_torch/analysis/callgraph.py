"""Package-wide module resolver and call graph — the substrate every
interprocedural rule stands on.

The per-file rules see one :class:`~.core.FileContext` at a time; the bug
classes that matter here (a stream sync two helper calls below a registered
dispatch function, a collective under a rank-dependent branch, a taxonomy
error no CLI handler maps to an exit code) all span function and file
boundaries. This module turns a set of parsed contexts into:

* a **module table** — package-relative path → dotted module name, with the
  import graph resolved (absolute, package-absolute, and relative forms);
* a **function index** — every top-level def and every method, keyed by a
  stable qualified name ``module:Class.method`` / ``module:func``;
* **call edges** — for each function, the call sites whose callee resolves
  to another indexed function (through ``from x import y [as z]`` aliases,
  module-attribute calls ``mod.func(...)``, and ``self.method()`` /
  ``cls.method()`` within a class);
* **Tarjan SCCs** in bottom-up (callee-first) order, so summary computation
  (:mod:`.summaries`) visits every callee before its callers and iterates
  only inside genuine recursion cycles.

Everything here is pure AST (no imports of linted code) and total: an
unresolvable callee is simply absent from the edge set — interprocedural
rules degrade to their within-function behaviour instead of guessing.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import FileContext
from .rules_hygiene import _last_name

__all__ = [
    "FunctionInfo",
    "CallSite",
    "CallGraph",
    "module_name",
    "build_callgraph",
]

#: the real package prefix — absolute internal imports are normalised by
#: stripping it, so ``from kubernetes_verification_tpu_torch.ops import
#: closure`` and ``from ..ops import closure`` resolve identically
PACKAGE_NAME = "kubernetes_verification_tpu_torch"

FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)


def module_name(rel: str) -> str:
    """Package-relative posix path → dotted module name.

    ``ops/closure.py`` → ``ops.closure``; a package ``__init__.py`` maps to
    the package itself (``parallel/__init__.py`` → ``parallel``, the root
    ``__init__.py`` → ``""``)."""
    parts = rel[:-3].split("/") if rel.endswith(".py") else rel.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclass
class CallSite:
    """One call whose callee resolved to an indexed function."""

    callee: str  #: qualified name (``module:qualname``)
    node: ast.Call
    line: int


@dataclass
class FunctionInfo:
    """One indexed function: where it lives and what it calls."""

    qname: str  #: ``module:qualname`` (methods: ``module:Class.method``)
    rel: str  #: package-relative path of the defining file
    module: str
    node: ast.AST  #: the FunctionDef / AsyncFunctionDef
    class_name: Optional[str] = None
    calls: List[CallSite] = field(default_factory=list)


@dataclass
class CallGraph:
    """The resolved program: functions, edges, and bottom-up SCC order."""

    functions: Dict[str, FunctionInfo]
    #: id(def node) → qname, for rules that start from an AST node
    by_node: Dict[int, str]
    #: module → {local name → qname} (defs + from-imports of indexed defs)
    module_scopes: Dict[str, Dict[str, str]]
    #: module → {alias → dotted module} for module-object imports
    module_aliases: Dict[str, Dict[str, str]]
    #: module → {NAME → string value} for module-level str constants
    str_constants: Dict[str, Dict[str, str]]
    #: class name → base-class names, program-wide (exception taxonomy)
    class_bases: Dict[str, Tuple[str, ...]]

    @property
    def n_edges(self) -> int:
        return sum(len(f.calls) for f in self.functions.values())

    def qname_of(self, node: ast.AST) -> Optional[str]:
        return self.by_node.get(id(node))

    def resolve_call(self, module: str, call: ast.Call,
                     class_name: Optional[str] = None) -> Optional[str]:
        """The qname a call expression dispatches to, when statically
        resolvable inside ``module`` (optionally within ``class_name`` for
        ``self.``/``cls.`` receivers)."""
        func = call.func
        if isinstance(func, ast.Name):
            return self.module_scopes.get(module, {}).get(func.id)
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name):
                if base.id in ("self", "cls") and class_name:
                    qn = f"{module}:{class_name}.{func.attr}"
                    if qn in self.functions:
                        return qn
                    return None
                target_mod = self.module_aliases.get(module, {}).get(base.id)
                if target_mod is not None:
                    qn = f"{target_mod}:{func.attr}"
                    if qn in self.functions:
                        return qn
        return None

    def resolve_str(self, module: str, node: ast.expr) -> Optional[str]:
        """A string-valued expression → its value: literals directly, bare
        names through module-level constants (following from-imports), and
        module-attribute reads (``mesh.POD_AXIS``)."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        consts = self.str_constants.get(module, {})
        if isinstance(node, ast.Name):
            return consts.get(node.id)
        if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
            target_mod = self.module_aliases.get(module, {}).get(node.value.id)
            if target_mod is not None:
                return self.str_constants.get(target_mod, {}).get(node.attr)
        return None

    # ------------------------------------------------------------- SCCs
    def sccs_bottom_up(self) -> List[List[str]]:
        """Tarjan's SCCs of the call graph, emitted callee-first — iterative
        (the package's call chains outrun the default recursion limit)."""
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        sccs: List[List[str]] = []
        counter = [0]
        succ = {
            q: sorted({c.callee for c in f.calls if c.callee in self.functions})
            for q, f in self.functions.items()
        }

        for root in sorted(self.functions):
            if root in index:
                continue
            work: List[Tuple[str, int]] = [(root, 0)]
            while work:
                node, i = work.pop()
                if i == 0:
                    index[node] = low[node] = counter[0]
                    counter[0] += 1
                    stack.append(node)
                    on_stack.add(node)
                recurse = False
                for j in range(i, len(succ[node])):
                    w = succ[node][j]
                    if w not in index:
                        work.append((node, j + 1))
                        work.append((w, 0))
                        recurse = True
                        break
                    if w in on_stack:
                        low[node] = min(low[node], index[w])
                if recurse:
                    continue
                if low[node] == index[node]:
                    comp: List[str] = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == node:
                            break
                    sccs.append(sorted(comp))
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[node])
        return sccs


def _resolve_import_from(
    module: str, node: ast.ImportFrom, known: Iterable[str] = (),
    is_package: bool = False,
) -> Optional[str]:
    """The dotted package-relative module an ``ImportFrom`` names, or None
    for imports that leave the package. ``known`` (the linted module set)
    also resolves plain absolute names, so fixture files importing each
    other (``from helpers import g``) build edges too. In a package's
    ``__init__.py`` (``is_package``) a relative import starts from the
    package itself, not from its parent."""
    if node.level == 0:
        mod = node.module or ""
        if mod == PACKAGE_NAME:
            return ""
        if mod.startswith(PACKAGE_NAME + "."):
            return mod[len(PACKAGE_NAME) + 1:]
        if mod in known:
            return mod
        return None
    # relative: level=1 is the current package, each extra level climbs one
    parts = module.split(".") if module else []
    # a module's package is its parent (a package's own __init__ is its
    # package); climbing starts there
    base = parts if is_package else parts[:-1]
    up = node.level - 1
    if up > len(base):
        return None
    if up:
        base = base[:-up]
    if node.module:
        base = base + node.module.split(".")
    return ".".join(base)


def build_callgraph(ctxs: Sequence[FileContext]) -> CallGraph:
    """Resolve a set of parsed files into a :class:`CallGraph`."""
    functions: Dict[str, FunctionInfo] = {}
    by_node: Dict[int, str] = {}
    module_scopes: Dict[str, Dict[str, str]] = {}
    module_aliases: Dict[str, Dict[str, str]] = {}
    str_constants: Dict[str, Dict[str, str]] = {}
    class_bases: Dict[str, Tuple[str, ...]] = {}
    modules = {module_name(ctx.rel): ctx for ctx in ctxs if ctx.tree is not None}

    # pass 1: index defs, module-level constants, class bases
    for mod, ctx in modules.items():
        scope: Dict[str, str] = {}
        consts: Dict[str, str] = {}
        for stmt in ctx.tree.body:
            if isinstance(stmt, FunctionNode):
                qn = f"{mod}:{stmt.name}"
                functions[qn] = FunctionInfo(qn, ctx.rel, mod, stmt)
                by_node[id(stmt)] = qn
                scope[stmt.name] = qn
            elif isinstance(stmt, ast.ClassDef):
                bases = tuple(
                    b for b in (_last_name(e) for e in stmt.bases) if b
                )
                class_bases.setdefault(stmt.name, bases)
                for item in stmt.body:
                    if isinstance(item, FunctionNode):
                        qn = f"{mod}:{stmt.name}.{item.name}"
                        functions[qn] = FunctionInfo(
                            qn, ctx.rel, mod, item, class_name=stmt.name
                        )
                        by_node[id(item)] = qn
            elif isinstance(stmt, ast.Assign):
                if (
                    isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)
                ):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name):
                            consts[tgt.id] = stmt.value.value
        module_scopes[mod] = scope
        str_constants[mod] = consts
        module_aliases[mod] = {}

    # pass 2: resolve imports into scopes / aliases / constants
    for mod, ctx in modules.items():
        scope = module_scopes[mod]
        aliases = module_aliases[mod]
        consts = str_constants[mod]
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.name
                    target = None
                    if name == PACKAGE_NAME:
                        target = ""
                    elif name.startswith(PACKAGE_NAME + "."):
                        target = name[len(PACKAGE_NAME) + 1:]
                    elif name.split(".")[0] in modules or name in modules:
                        target = name
                    if target is not None and target in modules:
                        aliases[alias.asname or name.split(".")[-1]] = target
            elif isinstance(node, ast.ImportFrom):
                src = _resolve_import_from(
                    mod, node, modules, ctx.rel.endswith("__init__.py")
                )
                if src is None:
                    continue
                for alias in node.names:
                    local = alias.asname or alias.name
                    qn = f"{src}:{alias.name}"
                    if qn in functions:
                        scope.setdefault(local, qn)
                    sub = f"{src}.{alias.name}" if src else alias.name
                    if sub in modules:
                        aliases.setdefault(local, sub)
                    value = str_constants.get(src, {}).get(alias.name)
                    if value is not None:
                        consts.setdefault(local, value)

    graph = CallGraph(
        functions=functions,
        by_node=by_node,
        module_scopes=module_scopes,
        module_aliases=module_aliases,
        str_constants=str_constants,
        class_bases=class_bases,
    )

    # pass 3: call edges (each call attributed to its innermost indexed
    # function — nested defs/lambdas charge the enclosing indexed def, so
    # closures handed to helpers (`_in_place(x, lambda t: ...)`) count as
    # their owner's calls)
    for mod, ctx in modules.items():
        owner_of: Dict[int, FunctionInfo] = {}

        def assign_owner(node: ast.AST, owner: Optional[FunctionInfo]):
            qn = by_node.get(id(node))
            if qn is not None:
                owner = functions[qn]
            for child in ast.iter_child_nodes(node):
                if owner is not None:
                    owner_of[id(child)] = owner
                assign_owner(child, owner)

        assign_owner(ctx.tree, None)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            owner = owner_of.get(id(node))
            if owner is None:
                continue
            callee = graph.resolve_call(mod, node, owner.class_name)
            if callee is not None:
                owner.calls.append(CallSite(callee, node, node.lineno))
    return graph
