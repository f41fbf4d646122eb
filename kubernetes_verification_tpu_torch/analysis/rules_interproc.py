"""Interprocedural rules: collective consistency across ranks,
read-after-in-place-write, and the CLI exit-code contract.

All three stand on the :mod:`.callgraph` + :mod:`.summaries` program view
attached to every :class:`~.core.FileContext` by the runner. The ids are the
JAX package's; two of the rules ask their question of the port's execution
model:

* ``collective-axis`` — the port's collectives are eager
  ``torch.distributed`` calls over the mesh's named process groups
  (``parallel/mesh.py``), not ``lax`` primitives under a ``shard_map``. The
  axis of every ``psum``/``psum_counts``/``all_gather``/``gather_rows``/
  ``broadcast`` and every ``dist.*(..., group=mesh.groups[<axis>])`` must
  name a mesh axis; and since every rank must enter every collective in
  the same order, a collective reached under a rank-dependent branch, or a
  ``raise`` after the first collective of a function that takes a mesh,
  leaves the other ranks blocked until the process group's timeout.
  Reachability runs over the call graph, so a collective two helpers down
  counts.
* ``donation-hazard`` — where JAX donates a buffer, this package's engines
  write it in place. Reading a name after handing it to a callee whose
  summary writes that parameter in place sees the new value where the old
  one was meant; ``x = f(x)`` is the sanctioned pattern.
* ``exit-contract`` — every CLI subcommand handler registered with
  ``set_defaults(fn=...)`` must keep its reachable ``KvTpuError`` raises
  inside the documented 0/1/2/3 exit-code mapping; a taxonomy error that
  can escape a handler uncaught is a lint failure, not a field bug.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .core import FileContext, Finding, Rule, register
from .rules_hygiene import _last_name, walk_own
from .summaries import _is_collective

_DefNode = (ast.FunctionDef, ast.AsyncFunctionDef)

#: attribute reads and calls whose value differs from rank to rank
_RANK_ATTRS = frozenset({"coords", "rank", "global_rank"})
_RANK_CALLS = frozenset({"get_rank", "get_node_local_rank", "_local_rank",
                         "get_coordinate", "global_rank"})
_RANK_NAMES = frozenset({"rank", "local_rank", "my_rank"})


def _program(ctxs: Sequence[FileContext]):
    for ctx in ctxs:
        if ctx.program is not None:
            return ctx.program
    return None


# ------------------------------------------------------------ mesh axes
def _axis_universe(ctxs: Sequence[FileContext], graph) -> Set[str]:
    """Every mesh axis name the program defines: ``*_AXIS`` string
    constants and the literal ``mesh_dim_names=`` of a ``DeviceMesh``
    construction. An axis name outside this set names no process group of
    any mesh in the program."""
    from .callgraph import module_name

    out: Set[str] = set()
    for consts in graph.str_constants.values():
        for name, val in consts.items():
            if name.endswith("_AXIS"):
                out.add(val)
    for ctx in ctxs:
        if ctx.tree is None:
            continue
        mod = module_name(ctx.rel)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if kw.arg != "mesh_dim_names":
                    continue
                elts = (
                    kw.value.elts
                    if isinstance(kw.value, (ast.Tuple, ast.List))
                    else [kw.value]
                )
                for elt in elts:
                    s = graph.resolve_str(mod, elt)
                    if s is not None:
                        out.add(s)
    return out


def _collective_runners(program) -> Set[str]:
    """qnames of every function that runs a collective, directly or
    through any chain of callees."""
    graph = program.graph
    runs = {
        qn for qn, s in program.summaries.items() if s.local.collectives
    }
    callers: Dict[str, Set[str]] = {}
    for qn, info in graph.functions.items():
        for call in info.calls:
            callers.setdefault(call.callee, set()).add(qn)
    work = list(runs)
    while work:
        qn = work.pop()
        for caller in callers.get(qn, ()):
            if caller not in runs:
                runs.add(caller)
                work.append(caller)
    return runs


def _rank_names(fn: ast.AST) -> Set[str]:
    """Local names whose value derives from this rank's identity
    (``me = mesh.coords[axis]``), to a small fixpoint."""
    names: Set[str] = set()
    for _ in range(4):
        grew = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            if not _rank_dependent(node.value, names):
                continue
            for tgt in node.targets:
                for n in _bound_names(tgt):
                    if n not in names:
                        names.add(n)
                        grew = True
        if not grew:
            break
    return names


def _bound_names(target: ast.expr) -> List[str]:
    """Names an assignment target rebinds (a subscript or attribute store
    rebinds none)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        return [n for elt in target.elts for n in _bound_names(elt)]
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    return []


def _rank_dependent(expr: ast.AST, names: Set[str]) -> bool:
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and n.attr in _RANK_ATTRS:
            return True
        if isinstance(n, ast.Call) and _last_name(n.func) in _RANK_CALLS:
            return True
        if isinstance(n, ast.Name) and (n.id in names or n.id in _RANK_NAMES):
            return True
    return False


def _takes_mesh(fn: ast.AST) -> bool:
    a = fn.args
    for arg in a.posonlyargs + a.args + a.kwonlyargs:
        if arg.arg == "mesh":
            return True
        if arg.annotation is not None and _last_name(arg.annotation) == "Mesh":
            return True
    return False


@register
class CollectiveAxisRule(Rule):
    id = "collective-axis"
    rationale = (
        "Every rank of a `torch.distributed` job must enter the same "
        "collectives in the same order, over process groups the mesh "
        "defines. Three ways to break that, each a hang or a wrong sum on "
        "the card: (1) a `psum`/`all_gather`/`gather_rows`/`broadcast` of "
        "`parallel/mesh.py`, or a `dist.*(..., group=mesh.groups[<axis>])`, "
        "whose axis is not one of the mesh's (`POD_AXIS`, `GRANT_AXIS`, "
        "their tuple) — a `KeyError` on one path, the wrong group's sum on "
        "another; (2) a collective reached under a branch on this rank's "
        "identity (`mesh.coords[...]`, `mesh.rank`, `dist.get_rank()`) — "
        "the ranks that skip it leave the others blocked in it until the "
        "gloo/NCCL timeout; (3) a `raise` after the first collective of a "
        "function that takes a mesh — a rank that raises there strands its "
        "peers in the next collective the same way (raise before the first "
        "collective, or on every rank alike). Collectives reached through "
        "helpers count: the rule walks the call graph."
    )
    example = (
        "def body(mesh, x):\n"
        "    if mesh.coords[POD_AXIS] == 0:\n"
        "        psum(mesh, x, GRANT_AXIS)  # other pod ranks never enter it\n"
        "    return all_gather(mesh, x, \"nodes\")  # no such mesh axis"
    )

    def check_project(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        from .callgraph import module_name

        program = _program(ctxs)
        if program is None:
            return
        graph = program.graph
        universe = _axis_universe(ctxs, graph)
        runners = _collective_runners(program)
        by_rel = {c.rel: c for c in ctxs}

        # 1. every collective's axis against the mesh's axes
        for qn, summary in sorted(program.summaries.items()):
            for coll in summary.local.collectives:
                for axis in coll["axes"]:
                    name = program.resolve_axis(summary.info.module, axis)
                    if name is not None and name not in universe:
                        have = ", ".join(sorted(universe)) or "(none)"
                        yield Finding(
                            self.id, summary.info.rel, coll["line"],
                            f"{coll['kind']}(axis={name!r}) — the mesh "
                            f"defines axes [{have}]; a collective over an "
                            "undefined axis has no process group (KeyError "
                            "on mesh.groups) or sums over the wrong one",
                        )

        # 2./3. rank-dependent branches and raises after a collective
        for qn, info in sorted(graph.functions.items()):
            if qn not in runners:
                continue
            ctx = by_rel.get(info.rel)
            if ctx is None:
                continue
            mod = module_name(info.rel)

            def collective_calls(nodes):
                for node in nodes:
                    if not isinstance(node, ast.Call):
                        continue
                    if _is_collective(node) is not None:
                        yield node, _last_name(node.func)
                        continue
                    callee = graph.resolve_call(mod, node, info.class_name)
                    if callee in runners:
                        yield node, graph.functions[callee].node.name

            ranky = _rank_names(info.node)
            seen: Set[int] = set()
            for node in ast.walk(info.node):
                if not isinstance(node, (ast.If, ast.While, ast.IfExp)):
                    continue
                if not _rank_dependent(node.test, ranky):
                    continue
                body = [node.body] if isinstance(node, ast.IfExp) else node.body
                orelse = (
                    [node.orelse] if isinstance(node, ast.IfExp)
                    else node.orelse
                )
                inner = [n for part in (body, orelse) for stmt in part
                         for n in ast.walk(stmt)]
                for call, what in collective_calls(inner):
                    if call.lineno in seen:
                        continue
                    seen.add(call.lineno)
                    yield Finding(
                        self.id, info.rel, call.lineno,
                        f"collective {what}() under a branch on this rank's "
                        f"identity (line {node.lineno}) in "
                        f"{info.node.name}() — the ranks that skip it leave "
                        "the others blocked in it until the process group's "
                        "timeout; run the collective on every rank and "
                        "select the result instead",
                    )

            if not _takes_mesh(info.node):
                continue
            lines = sorted(
                c.lineno for c, _ in collective_calls(ast.walk(info.node))
            )
            if not lines:
                continue
            first = lines[0]
            for node in ast.walk(info.node):
                # a bare `raise` re-raises a fault that already diverged
                # the ranks where it was raised; the origin is flagged
                if (
                    isinstance(node, ast.Raise)
                    and node.exc is not None
                    and node.lineno > first
                ):
                    yield Finding(
                        self.id, info.rel, node.lineno,
                        f"raise after the first collective (line {first}) of "
                        f"{info.node.name}(), which takes a mesh — a rank "
                        "that raises here strands its peers in their next "
                        "collective until the process group's timeout; "
                        "check before the first collective, or on every "
                        "rank alike",
                    )


# ------------------------------------------------ read after in-place write
@register
class DonationHazardRule(Rule):
    id = "donation-hazard"
    rationale = (
        "Where the JAX package donates a buffer, this package writes it in "
        "place (`ops/device_state.py`, `incremental.py`, "
        "`packed_incremental.py`): a callee that runs a `*_()` method on a "
        "parameter, assigns through a subscript of it, passes it as "
        "`out=` or hands it to `dist.all_reduce`-style collectives "
        "changes the caller's tensor. A caller that takes such a call's "
        "*result* and then reads the argument again sees the new value "
        "where the old one was meant — a silent wrong answer, not a crash. "
        "The rule finds every call whose result is used and whose callee "
        "(through summaries, any helper depth) writes a bare-name argument "
        "in place, then scans the enclosing scope for reads of that name "
        "after the call: a straight-line read before any rebind, or any "
        "read in an enclosing loop whose body never rebinds the name (the "
        "next iteration reads the overwritten buffer). `cur = step(cur)` "
        "is the sanctioned pattern, and a call made for its effect alone "
        "(an expression statement) reads as intended."
    )
    example = (
        "def step(buf):\n"
        "    buf.add_(1)  # writes the caller's tensor\n"
        "    return buf.sum()\n"
        "total = step(buf)\n"
        "print(buf.max())  # reads the written buffer"
    )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        from .callgraph import module_name

        program = ctx.program
        if program is None:
            return
        mod = module_name(ctx.rel)
        scopes: List[ast.AST] = [ctx.tree]
        for node in ast.walk(ctx.tree):
            if isinstance(node, _DefNode):
                scopes.append(node)
        for scope in scopes:
            yield from self._scan_scope(ctx, scope, program, mod)

    def _written_args(
        self, call: ast.Call, program, mod: str, class_name: Optional[str],
    ) -> List[Tuple[str, str, Tuple[str, ...]]]:
        """(name, callee-name, via-chain) for each bare-Name argument this
        call's callee writes in place, directly or through a helper."""
        out: List[Tuple[str, str, Tuple[str, ...]]] = []
        qn = program.graph.resolve_call(mod, call, class_name)
        summary = program.summaries.get(qn) if qn else None
        if summary is None or not summary.mutates:
            return out
        offset = (
            1
            if summary.info.class_name
            and isinstance(call.func, ast.Attribute)
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id in ("self", "cls")
            else 0
        )
        for j, (_line, via) in sorted(summary.mutates.items()):
            pos = j - offset
            if 0 <= pos < len(call.args) and isinstance(
                call.args[pos], ast.Name
            ):
                out.append((call.args[pos].id, summary.info.node.name, via))
        return out

    def _scan_scope(
        self, ctx: FileContext, scope: ast.AST, program, mod: str,
    ) -> Iterable[Finding]:
        class_name = None
        if isinstance(scope, _DefNode):
            parent = ctx.parent(scope)
            if isinstance(parent, ast.ClassDef):
                class_name = parent.name

        nodes = list(walk_own(scope))
        loads: Dict[str, List[int]] = {}
        stores: Dict[str, List[int]] = {}
        for node in nodes:
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loads.setdefault(node.id, []).append(node.lineno)
                else:
                    stores.setdefault(node.id, []).append(node.lineno)

        # loop extents in this scope (own walk: nested defs excluded)
        loops: List[Tuple[int, int]] = []
        for node in nodes:
            if isinstance(node, (ast.For, ast.While)):
                end = max(
                    (n.lineno for n in ast.walk(node)
                     if hasattr(n, "lineno")),
                    default=node.lineno,
                )
                loops.append((node.lineno, end))

        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            if isinstance(ctx.parent(node), ast.Expr):
                continue  # called for its effect: later reads want it
            for name, callee, via in self._written_args(
                node, program, mod, class_name
            ):
                chain = f" (via {' -> '.join(via)})" if via else ""
                line = node.lineno
                # loop case: the call re-executes; a read anywhere in the
                # loop without a rebind in the loop is a hazard
                in_loop = next(
                    ((s, e) for s, e in loops if s <= line <= e), None
                )
                if in_loop is not None:
                    s, e = in_loop
                    rebinds = [
                        ln for ln in stores.get(name, []) if s <= ln <= e
                    ]
                    if not rebinds:
                        reads = [
                            ln for ln in loads.get(name, []) if s <= ln <= e
                        ]
                        if reads:
                            yield Finding(
                                self.id, ctx.rel, line,
                                f"{name!r} is written in place by "
                                f"{callee}(){chain} inside a loop and never "
                                "rebound there — the next iteration reads "
                                "the overwritten buffer; rebind it "
                                f"(`{name} = {callee}(...)`) or pass a copy",
                            )
                            continue
                first_rebind = min(
                    (ln for ln in stores.get(name, []) if ln >= line),
                    default=None,
                )
                late_reads = [
                    ln for ln in loads.get(name, [])
                    if ln > line
                    and (first_rebind is None or ln < first_rebind)
                ]
                if late_reads:
                    yield Finding(
                        self.id, ctx.rel, late_reads[0],
                        f"{name!r} read after {callee}(){chain} wrote it in "
                        f"place at line {line} — the read sees the new "
                        "value where the old one was meant; read the "
                        "call's result instead, rebind the name, or pass a "
                        "copy",
                    )


# --------------------------------------------------------- exit contract
@register
class ExitContractRule(Rule):
    id = "exit-contract"
    rationale = (
        "The CLI documents a 0/1/2/3 exit-code contract (ok / violations "
        "found / input error / backend failure) and `resilience.errors."
        "exit_code_for` implements it — but only for `KvTpuError`s a "
        "handler actually catches. This rule discovers every subcommand "
        "handler registered via `set_defaults(fn=...)`, takes its "
        "summary's transitive escaped-raise set (guards are "
        "hierarchy-aware: `except KvTpuError` catches every subclass), "
        "and flags any `KvTpuError`-family type that can escape — a new "
        "taxonomy subclass nobody routes through `exit_code_for` would "
        "otherwise surface as a raw traceback in the field instead of a "
        "diagnosable exit code."
    )
    example = (
        "def cmd_new(args):\n"
        "    run()  # can raise ConfigError — no except KvTpuError\n"
        "p.set_defaults(fn=cmd_new)"
    )

    def check_project(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        from .callgraph import module_name
        from .summaries import exception_ancestors

        program = _program(ctxs)
        if program is None:
            return
        graph = program.graph
        for ctx in ctxs:
            if ctx.tree is None:
                continue
            mod = module_name(ctx.rel)
            handlers: Dict[str, int] = {}
            for node in ast.walk(ctx.tree):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "set_defaults"
                ):
                    continue
                for kw in node.keywords:
                    if kw.arg == "fn" and isinstance(kw.value, ast.Name):
                        handlers.setdefault(kw.value.id, node.lineno)
            for name in sorted(handlers):
                qn = graph.module_scopes.get(mod, {}).get(name)
                summary = program.summaries.get(qn) if qn else None
                if summary is None:
                    continue
                escaped = sorted(
                    r for r in summary.raises
                    if "KvTpuError" in exception_ancestors(
                        r, graph.class_bases
                    )
                )
                for exc in escaped:
                    yield Finding(
                        self.id, ctx.rel, summary.info.node.lineno,
                        f"subcommand handler {name}() can raise {exc} "
                        "uncaught — it escapes the documented 0/1/2/3 "
                        "exit-code contract as a raw traceback; wrap the "
                        "body in `except KvTpuError` and exit via "
                        "`exit_code_for`",
                    )
