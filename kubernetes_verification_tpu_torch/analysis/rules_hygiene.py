"""Hygiene rules: the error-taxonomy / bare-except / atomic-write checks,
the concurrency rules the serve watchdog's hung-thread bug motivated, and
the serve-path bounds — the JAX package's rules, copied unchanged (the same
ids, findings and messages on the same source).

``atomic-write`` is the generalisation the durability work earned: the old
script only watched ``serve/durability.py``, but a torn half-written file is
a torn half-written file wherever it happens — any function that opens a
path for writing without promoting via ``os.replace`` re-opens the window
the recovery kill-point fuzz exists to close. Appends (WAL/JSONL logs) are
flagged too: an append CAN be the right design when the reader tolerates a
torn tail (``scan_wal`` truncates), but that is a per-site judgement call,
recorded as an inline ``# kvtpu: ignore[atomic-write]`` with the reason.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Tuple

from .core import FileContext, Finding, Rule, register

__all__ = [
    "DISALLOWED_RAISES",
    "ALWAYS_ALLOWED_RAISES",
    "WRITE_MODE_CHARS",
]

#: builtins whose raise sites the KvTpuError taxonomy replaces
DISALLOWED_RAISES = frozenset({
    "ValueError",
    "RuntimeError",
    "KeyError",
    "TypeError",
    "Exception",
    "BaseException",
    "OSError",
    "IOError",
    "IndexError",
    "LookupError",
    "ArithmeticError",
})

#: idioms the taxonomy does not absorb (always fine to raise)
ALWAYS_ALLOWED_RAISES = frozenset({
    "SystemExit",
    "NotImplementedError",
    "AssertionError",
    "ImportError",
    "ModuleNotFoundError",
    "StopIteration",
    "AttributeError",
})

#: open() modes that create or mutate bytes on disk
WRITE_MODE_CHARS = frozenset("wax+")


def walk_own(fn: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` that does not descend into nested function/class
    bodies — per-function rules (atomic-write) must not attribute a nested
    def's statements to its enclosing function as well."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _last_name(node: ast.expr) -> Optional[str]:
    """Terminal identifier of a Name/Attribute chain (``a.b.c`` → ``c``)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _dotted(node: ast.expr) -> Optional[str]:
    """``a.b.c`` → ``"a.b.c"`` when the chain is pure Name/Attribute."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@register
class ErrorTaxonomyRule(Rule):
    id = "error-taxonomy"
    rationale = (
        "Package code must raise `KvTpuError` subclasses "
        "(`resilience/errors.py`), not bare builtins: a bare `ValueError` "
        "three layers deep cannot be mapped to the CLI exit-code contract "
        "(0 ok / 1 violations / 2 input error / 3 backend failure) and "
        "never carries `transient`/`kind` for the retry/fallback driver. "
        "Engine/model layers that expose `KeyError`/`ValueError` as their "
        "documented API contract are grandfathered in `LINT_BASELINE.json` "
        "(budgets shrink, never grow)."
    )
    example = 'raise ValueError("bad tile size")'

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Raise) and node.exc is not None):
                continue
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in DISALLOWED_RAISES and name not in ALWAYS_ALLOWED_RAISES:
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    f"raise {name}(...) — raise a KvTpuError subclass from "
                    "resilience/errors.py instead",
                )


@register
class BareExceptRule(Rule):
    id = "bare-except"
    rationale = (
        "A bare `except:` swallows `KeyboardInterrupt`/`SystemExit` and "
        "hides taxonomy errors from the exit-code contract; catch a named "
        "type (`Exception` at the broadest) instead. Zero budget: the "
        "package has none and must stay at none."
    )
    example = "try:\n    solve()\nexcept:\n    pass"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    "bare `except:` — catch a named type (Exception at the "
                    "broadest) so KeyboardInterrupt and taxonomy errors are "
                    "not swallowed",
                )


def _open_write_mode(call: ast.Call) -> Optional[str]:
    """The mode string of an ``open()`` call when it writes, else None."""
    if not (isinstance(call.func, ast.Name) and call.func.id == "open"):
        return None
    mode = "r"
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    if isinstance(mode, str) and set(mode) & WRITE_MODE_CHARS:
        return mode
    return None


@register
class AtomicWriteRule(Rule):
    id = "atomic-write"
    rationale = (
        "Durable state must be promoted atomically: write a tmp file, "
        "fsync, `os.replace` — a bare `open(path, 'w')` is a torn-state "
        "window, which is exactly what the recovery fuzz's kill points "
        "SIGKILL into. Any function that opens for writing without calling "
        "`os.replace` is flagged; genuinely torn-tolerant sites (WAL/JSONL "
        "appends whose reader truncates torn tails, throwaway exports) "
        "carry an inline ignore with the reason."
    )
    example = 'def save(path, body):\n    with open(path, "w") as fh:\n        fh.write(body)'

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            opens: List[Tuple[int, str]] = []
            has_replace = False
            for node in walk_own(fn):
                if not isinstance(node, ast.Call):
                    continue
                mode = _open_write_mode(node)
                if mode is not None:
                    opens.append((node.lineno, mode))
                if _dotted(node.func) in ("os.replace", "os.rename"):
                    has_replace = True
            if has_replace:
                continue
            for line, mode in opens:
                yield Finding(
                    self.id, ctx.rel, line,
                    f"open(..., {mode!r}) in a function without os.replace "
                    "— durable writes must use the tmp-file + fsync + "
                    "os.replace promotion (or justify with an inline "
                    "ignore: torn-tolerant append, throwaway export)",
                )


@register
class LeaseAtomicRule(Rule):
    id = "lease-atomic"
    rationale = (
        "The leader lease is the failover protocol's ground truth: a torn "
        "or unsynced `leader.lease` can elect two leaders (a reader sees "
        "the old epoch while the new one is only in the page cache). "
        "Stricter than `atomic-write`: any lease-scoped function that "
        "opens a file for writing must BOTH promote via `os.replace`/"
        "`os.rename` AND `os.fsync` before promoting — replace without "
        "fsync survives a process crash but not a power cut, which is "
        "precisely the window the `before-lease-renew` kill point fuzzes. "
        "A function is lease-scoped when its name, its class's name, or "
        "the opened path expression mentions `lease`."
    )
    example = (
        'def write_lease(path, body):\n'
        '    with open(path + ".tmp", "w") as fh:\n'
        '        fh.write(body)\n'
        '    os.replace(path + ".tmp", path)  # no fsync before promote'
    )

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            scoped = "lease" in fn.name.lower() or any(
                isinstance(a, ast.ClassDef) and "lease" in a.name.lower()
                for a in ctx.ancestors(fn)
            )
            opens: List[Tuple[int, str]] = []
            has_replace = False
            has_fsync = False
            for node in walk_own(fn):
                if not isinstance(node, ast.Call):
                    continue
                mode = _open_write_mode(node)
                if mode is not None:
                    target = node.args[0] if node.args else None
                    if scoped or (
                        target is not None
                        and "lease" in ast.dump(target).lower()
                    ):
                        opens.append((node.lineno, mode))
                dotted = _dotted(node.func)
                if dotted in ("os.replace", "os.rename"):
                    has_replace = True
                if dotted == "os.fsync":
                    has_fsync = True
            if not opens or (has_replace and has_fsync):
                continue
            missing = []
            if not has_replace:
                missing.append("os.replace")
            if not has_fsync:
                missing.append("os.fsync")
            for line, mode in opens:
                yield Finding(
                    self.id, ctx.rel, line,
                    f"lease write open(..., {mode!r}) without "
                    f"{' + '.join(missing)} — leader leases must be "
                    "promoted tmp + fsync + os.replace, or a reader can "
                    "see a torn/unsynced epoch and elect two leaders",
                )


@register
class BoundedQueueRule(Rule):
    id = "bounded-queue"
    rationale = (
        "The serve path stands between unbounded client demand and a "
        "fixed-capacity device: any `queue.Queue`/`collections.deque` "
        "constructed there without an explicit positive `maxsize`/`maxlen` "
        "is an overload liability — memory grows with offered load until "
        "the process dies, which is exactly the failure the ingress tier's "
        "typed `queue-full` rejection exists to replace. `SimpleQueue` has "
        "no bound at all and is flagged unconditionally; `maxsize=0` is "
        "the unbounded spelling and counts as missing. Genuinely "
        "drain-bounded sites (a queue whose producer is itself bounded) "
        "carry an inline `# kvtpu: ignore[bounded-queue]` with the reason."
    )
    example = "self._queue = queue.Queue()  # in serve/"

    #: package-relative prefixes on the serve path (between clients and
    #: the device); queues elsewhere are tooling and may buffer freely
    SERVE_PREFIXES = ("serve/",)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if not ctx.rel.startswith(self.SERVE_PREFIXES):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _last_name(node.func)
            if name == "SimpleQueue":
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    "SimpleQueue on the serve path — it cannot be bounded; "
                    "use queue.Queue(maxsize=N) so overload becomes "
                    "back-pressure instead of memory growth",
                )
            elif name in ("Queue", "LifoQueue", "PriorityQueue"):
                if not self._has_bound(node, "maxsize", positional=0):
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f"{name}() without a positive maxsize on the serve "
                        "path — unbounded queues turn overload into memory "
                        "growth; pass maxsize=N (or justify with an inline "
                        "ignore)",
                    )
            elif name == "deque":
                if not self._has_bound(node, "maxlen", positional=1):
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        "deque() without maxlen on the serve path — "
                        "unbounded buffers turn overload into memory "
                        "growth; pass maxlen=N (or justify with an inline "
                        "ignore)",
                    )

    @staticmethod
    def _has_bound(call: ast.Call, kwarg: str, *, positional: int) -> bool:
        """An explicit bound argument that is not the unbounded literal
        (0/None). Computed values are trusted — the author bounded it."""
        value: Optional[ast.expr] = None
        for kw in call.keywords:
            if kw.arg == kwarg:
                value = kw.value
        if value is None and len(call.args) > positional:
            value = call.args[positional]
        if value is None:
            return False
        if isinstance(value, ast.Constant):
            return bool(value.value)
        return True


def _is_thread_class(node: ast.ClassDef) -> bool:
    return any(_last_name(b) == "Thread" for b in node.bases)


def _daemon_true(call: ast.Call) -> Optional[bool]:
    """True/False when ``daemon=`` is a literal, None when absent."""
    for kw in call.keywords:
        if kw.arg == "daemon":
            if isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
            return True  # computed value: trust the author
    return None


@register
class ConcurrencyHygieneRule(Rule):
    id = "concurrency-hygiene"
    rationale = (
        "The serve watchdog's hung-thread bug, made structural: a non-daemon "
        "`threading.Thread` is joined at interpreter exit, so one hung "
        "solve blocks the process and swallows the exit-code contract — "
        "every thread here must pass `daemon=True` (subclasses: in the "
        "`super().__init__` call). Also flagged: `Lock.acquire()` outside "
        "a `with` block (an exception between acquire and release deadlocks "
        "every later caller), and module-global writes (`global X` + "
        "assignment) outside a `with <lock>:` guard — the serve worker "
        "shares the interpreter with the submitting thread."
    )
    example = "t = threading.Thread(target=run)\nt.start()"

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                yield from self._check_thread_call(ctx, node)
                yield from self._check_acquire(ctx, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._check_global_writes(ctx, node)

    def _check_thread_call(self, ctx: FileContext, node: ast.Call):
        name = _last_name(node.func)
        if name == "Thread":
            daemon = _daemon_true(node)
            if daemon is not True:
                why = "daemon=False" if daemon is False else "no daemon="
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    f"threading.Thread with {why} — a non-daemon thread is "
                    "joined at interpreter exit and a hung target blocks "
                    "the process; pass daemon=True",
                )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "__init__"
            and isinstance(node.func.value, ast.Call)
            and _last_name(node.func.value.func) == "super"
        ):
            cls = next(
                (a for a in ctx.ancestors(node) if isinstance(a, ast.ClassDef)),
                None,
            )
            if cls is not None and _is_thread_class(cls):
                if _daemon_true(node) is not True:
                    yield Finding(
                        self.id, ctx.rel, node.lineno,
                        f"Thread subclass {cls.name} never passes "
                        "daemon=True to super().__init__ — a hung run() "
                        "blocks interpreter exit",
                    )

    def _check_acquire(self, ctx: FileContext, node: ast.Call):
        if not (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "acquire"
        ):
            return
        owner = _last_name(node.func.value)
        if owner is None or "lock" not in owner.lower():
            return
        yield Finding(
            self.id, ctx.rel, node.lineno,
            f"{owner}.acquire() outside `with` — an exception between "
            "acquire and release deadlocks every later caller; use "
            f"`with {owner}:`",
        )

    def _check_global_writes(self, ctx: FileContext, fn):
        declared = set()
        for node in walk_own(fn):
            if isinstance(node, ast.Global):
                declared.update(node.names)
        if not declared:
            return
        for node in walk_own(fn):
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for tgt in targets:
                if not (isinstance(tgt, ast.Name) and tgt.id in declared):
                    continue
                if self._under_lock(ctx, node):
                    continue
                yield Finding(
                    self.id, ctx.rel, node.lineno,
                    f"module global {tgt.id!r} written outside a "
                    "`with <lock>:` guard — shared mutable state raced by "
                    "the serve worker / watchdog threads",
                )

    @staticmethod
    def _under_lock(ctx: FileContext, node: ast.AST) -> bool:
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.With):
                for item in anc.items:
                    name = _last_name(item.context_expr)
                    if name is None and isinstance(item.context_expr, ast.Call):
                        name = _last_name(item.context_expr.func)
                    if name and "lock" in name.lower():
                        return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
        return False


@register
class BoundedJournalRule(Rule):
    id = "bounded-journal"
    rationale = (
        "The posture plane journals *witnesses* extracted from per-batch "
        "delta planes, and the extraction index sets (`np.nonzero` / "
        "`flatnonzero` / `argwhere`) scale with the delta — a pathological "
        "batch (FullResync flipping half the matrix) would otherwise "
        "balloon one journal record to O(N²) witness entries and stall the "
        "apply path serialising them. Any function on the posture modules "
        "that extracts indices must also cap what it keeps: at least one "
        "slice with an explicit upper bound (`[:TOP_K]`, `[:cap]`) in the "
        "same function body. Extractions bounded some other way (a loop "
        "over an already-small [G, G] namespace matrix) carry an inline "
        "`# kvtpu: ignore[bounded-journal]` with the reason."
    )
    example = "witnesses = np.flatnonzero(changed)  # no [:cap] in scope"

    #: the modules whose extraction feeds the posture journal; index
    #: extraction elsewhere is not a journal-size liability
    POSTURE_FILES = ("serve/posture.py", "ops/posture.py")

    #: calls that materialise an index set proportional to the delta
    #: (`where` only in its single-argument extractor form — the
    #: three-argument select returns a same-shaped array, not indices)
    EXTRACTORS = frozenset({"nonzero", "flatnonzero", "argwhere", "where"})

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.rel not in self.POSTURE_FILES:
            return
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            extractions = []
            capped = False
            for node in walk_own(fn):
                if isinstance(node, ast.Call):
                    name = _last_name(node.func)
                    if name in self.EXTRACTORS and (
                        name != "where" or len(node.args) == 1
                    ):
                        extractions.append((node.lineno, name))
                elif isinstance(node, ast.Slice) and node.upper is not None:
                    capped = True
            if extractions and not capped:
                for lineno, name in extractions:
                    yield Finding(
                        self.id, ctx.rel, lineno,
                        f"{name}() extracts delta-proportional indices but "
                        f"{fn.name}() has no bounding slice — a "
                        "pathological batch makes the journal record "
                        "O(N^2); keep a top-k cap ([:TOP_K]) next to every "
                        "extraction (or justify with an inline ignore)",
                    )


@register
class StripeLocalityRule(Rule):
    id = "stripe-locality"
    rationale = (
        "A stripe engine's count matrices are `[S, N]` row stripes — row "
        "index 0 is GLOBAL pod `lo`, not pod 0. Any function in "
        "`serve/stripes.py` that subscripts the striped count state "
        "(`_ing_count` / `_eg_count`) with an unbounded global index "
        "silently reads or patches the WRONG pod's row: the answer is "
        "well-shaped, plausible, and incorrect for every pod outside "
        "`[lo, hi)` — the worst failure mode a sharded serving plane "
        "has. Every such function must reference the owned stripe range "
        "in the same body (the `_lo`/`_hi` bounds, `stripe_rows`, "
        "`local()`/`owns()` translation, or a `row_base` rebase) so the "
        "global→local mapping is visible at the indexing site. Helpers "
        "whose operands arrive pre-bounded by the caller carry an inline "
        "`# kvtpu: ignore[stripe-locality]` with the reason."
    )
    example = "self._ing_count.at[idx, :]  # idx is GLOBAL; no lo/hi in scope"

    #: the stripe serving plane; count-state subscripts elsewhere are a
    #: different engine's (whole-state) indexing and globally addressed
    STRIPE_FILES = ("serve/stripes.py",)

    #: terminal names of the striped count state ("count" covers the
    #: registered patch helpers' parameter spelling)
    COUNT_NAMES = frozenset({"_ing_count", "_eg_count", "count"})

    #: in-scope references that make the stripe range visible: the owned
    #: bounds themselves, the range property, the geometry helpers, the
    #: global→local translators, and the kernel rebase scalar
    BOUND_NAMES = frozenset({
        "_lo", "_hi", "lo", "hi", "stripe_rows", "stripe_bounds",
        "local", "owns", "row_base",
    })

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        if ctx.rel not in self.STRIPE_FILES:
            return
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            subscripts = []
            bounded = False
            for node in walk_own(fn):
                if isinstance(node, ast.Subscript):
                    chain = _dotted(node.value) or ""
                    parts = set(chain.split("."))
                    if parts & self.COUNT_NAMES:
                        subscripts.append(node.lineno)
                elif isinstance(node, (ast.Name, ast.Attribute)):
                    if _last_name(node) in self.BOUND_NAMES:
                        bounded = True
                elif isinstance(node, ast.keyword):
                    if node.arg in self.BOUND_NAMES:
                        bounded = True
            if subscripts and not bounded:
                for lineno in sorted(set(subscripts)):
                    yield Finding(
                        self.id, ctx.rel, lineno,
                        "striped count state subscripted but "
                        f"{fn.name}() never references the owned stripe "
                        "range — row 0 here is global pod `lo`, so an "
                        "unbounded index answers for the wrong pod; keep "
                        "the lo/hi bound (or the local()/owns() "
                        "translation) in the same function, or justify "
                        "with an inline ignore",
                    )
