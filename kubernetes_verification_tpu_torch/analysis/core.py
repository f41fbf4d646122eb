"""The lint core: rules, findings, per-file contexts, and the runner.

The port of ``kubernetes_verification_tpu.analysis.core``: every rule walks
the SAME parse of each file, reports through the same :class:`Finding`
shape, honours the same inline suppressions, and is budgeted by the same
``LINT_BASELINE.json`` (:mod:`.baseline`, the port's own file inside this
package).

Design points:

* **Pure AST.** Nothing under lint is imported, so the whole framework runs
  without torch or a card and can lint arbitrary source strings (the test
  fixtures do).
* **Shared parse.** Each file is parsed once into a :class:`FileContext`
  (tree + parent links + suppression table); rules never re-parse.
* **Inline suppressions.** ``# kvtpu: ignore[rule-id]`` on a line (or on
  its own line, covering the next) silences that rule there; a reason
  string after the bracket is encouraged. Stale suppressions are themselves
  findings (``unused-suppression``) so ignores rot loudly.
* **Two rule scopes.** ``check(ctx)`` sees one file; ``check_project(ctxs)``
  runs once over every context for cross-file contracts (e.g. a metric
  family registered in one module but missing from ``REQUIRED_FAMILIES``).
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "FileContext",
    "Rule",
    "RULES",
    "register",
    "rule_ids",
    "build_context",
    "iter_package_files",
    "package_root",
    "repo_root",
    "LintResult",
    "run_lint",
    "lint_source",
    "UNUSED_SUPPRESSION",
]

#: the synthetic rule id findings about stale ignores are reported under —
#: not suppressible (an ignore of the ignore-checker defeats the point)
UNUSED_SUPPRESSION = "unused-suppression"

_SUPPRESS_RE = re.compile(r"#\s*kvtpu:\s*ignore\[([^\]]+)\]")
_RULE_ID_RE = re.compile(r"^[a-z][a-z0-9-]*$")


@dataclass(frozen=True)
class Finding:
    """One lint hit: rule id, package-relative path, 1-based line, message."""

    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
        }


@dataclass
class FileContext:
    """One file's shared lint state: source, parse tree, parent links, and
    the suppression table (line → rule ids, with per-entry use tracking)."""

    rel: str
    source: str
    tree: Optional[ast.AST]
    #: parse failure, when ``tree`` is None
    syntax_error: Optional[str] = None
    #: line → rule ids suppressed there
    suppressions: Dict[int, List[str]] = field(default_factory=dict)
    #: (line, rule) pairs that actually silenced a finding
    used_suppressions: set = field(default_factory=set)
    #: child AST node (by id) → parent node, for context-sensitive rules
    parents: Dict[int, ast.AST] = field(default_factory=dict)
    #: the interprocedural :class:`~.summaries.Program` for the run this
    #: context belongs to (attached by :func:`run_lint`; None in isolation)
    program: Optional[object] = None

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(id(node))
        while cur is not None:
            yield cur
            cur = self.parents.get(id(cur))

    def is_suppressed(self, finding: Finding) -> bool:
        rules = self.suppressions.get(finding.line, ())
        if finding.rule in rules:
            self.used_suppressions.add((finding.line, finding.rule))
            return True
        return False


class Rule:
    """Base class: subclass, set the metadata, implement ``check`` and/or
    ``check_project``, and decorate with :func:`register`. The metadata is
    load-bearing — ``LINTS.md`` is generated from it (``report.catalog``)."""

    #: stable kebab-case id — the suppression / --rules / baseline key
    id: str = ""
    #: one-paragraph why (rendered into LINTS.md)
    rationale: str = ""
    #: a minimal flagged snippet (rendered into LINTS.md)
    example: str = ""

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        return ()

    def check_project(self, ctxs: Sequence[FileContext]) -> Iterable[Finding]:
        return ()


#: id → rule instance, in registration order (catalog order)
RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and index a :class:`Rule` by id."""
    rule = cls()
    if not _RULE_ID_RE.match(rule.id or ""):
        raise AssertionError(f"bad rule id: {rule.id!r}")
    if rule.id in RULES:
        raise AssertionError(f"duplicate rule id: {rule.id}")
    RULES[rule.id] = rule
    return cls


def rule_ids() -> List[str]:
    return list(RULES)


# --------------------------------------------------------------- contexts
def _parse_suppressions(source: str) -> Dict[int, List[str]]:
    """``# kvtpu: ignore[a, b] reason`` → {target_line: [a, b]}. A comment
    sharing a line with code covers that line; a comment-only line covers
    the next line (so a suppression can sit above a long statement).
    Tokenized, not regexed, so the pattern inside a string literal (a
    docstring showing the syntax, this very function) is never a
    suppression."""
    table: Dict[int, List[str]] = {}
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return table  # unparsable files already report parse-error
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS_RE.search(tok.string)
        if not m:
            continue
        ids = [t.strip() for t in m.group(1).split(",") if t.strip()]
        lineno = tok.start[0]
        own_line = tok.line.lstrip().startswith("#")
        target = lineno + 1 if own_line else lineno
        table.setdefault(target, []).extend(ids)
    return table


def build_context(rel: str, source: str) -> FileContext:
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return FileContext(
            rel=rel, source=source, tree=None,
            syntax_error=f"line {e.lineno}: {e.msg}",
            suppressions=_parse_suppressions(source),
        )
    ctx = FileContext(
        rel=rel, source=source, tree=tree,
        suppressions=_parse_suppressions(source),
    )
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            ctx.parents[id(child)] = parent
    return ctx


# ------------------------------------------------------------- file walks
def package_root() -> str:
    """The installed ``kubernetes_verification_tpu_torch`` directory — where
    the port's ``LINT_BASELINE.json`` and ``LINTS.md`` live."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    """One level above the package — where the bench history lives."""
    return os.path.dirname(package_root())


def iter_package_files(root: Optional[str] = None) -> List[Tuple[str, str]]:
    """(relative-posix-path, absolute-path) for every ``.py`` under
    ``root`` (default: the package), sorted, skipping ``__pycache__``."""
    base = root or package_root()
    if os.path.isfile(base):
        return [(os.path.basename(base), os.path.abspath(base))]
    out: List[Tuple[str, str]] = []
    for dirpath, dirs, files in os.walk(base):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for fname in sorted(files):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, base).replace(os.sep, "/")
            out.append((rel, path))
    return out


# ----------------------------------------------------------------- runner
@dataclass
class LintResult:
    """The runner's verdict. ``findings`` are actionable (exit 1 when
    non-empty); ``grandfathered``/``suppressed`` are kept for reporting and
    for the baseline-shrink machinery; ``counts`` is the post-suppression,
    pre-baseline tally the monotonicity test and ``--update-baseline``
    read."""

    findings: List[Finding]
    grandfathered: List[Finding]
    suppressed: List[Finding]
    #: rule → path → count (after inline suppression, before baseline)
    counts: Dict[str, Dict[str, int]]

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.to_dict() for f in self.findings],
            "grandfathered": len(self.grandfathered),
            "suppressed": len(self.suppressed),
            "counts": self.counts,
        }


def _select_rules(rules: Optional[Sequence[str]]) -> List[Rule]:
    # rule modules register on import; pull them in exactly once here so
    # `from analysis.core import run_lint` alone is enough (in the JAX
    # package's catalog order: the torch counterparts of its rules_jax.py
    # register before the interprocedural rules)
    from . import (  # noqa: F401
        rules_hygiene,
        rules_torch,
        rules_interproc,
        rules_metrics,
    )

    if rules is None:
        return list(RULES.values())
    unknown = [r for r in rules if r not in RULES]
    if unknown:
        from ..resilience.errors import ConfigError

        raise ConfigError(
            f"unknown rule id(s): {', '.join(unknown)} "
            f"(known: {', '.join(RULES)})"
        )
    return [RULES[r] for r in rules]


def run_lint(
    sources: Mapping[str, str],
    rules: Optional[Sequence[str]] = None,
    baseline: Optional[Mapping[str, Mapping[str, int]]] = None,
    cache_path: Optional[str] = None,
) -> LintResult:
    """Lint ``{relative-path: source}`` with the selected rules.

    Pipeline: parse each file once → build the interprocedural program
    (callgraph + summaries, attached to every context) → per-file rules →
    project rules → inline suppressions (marking each one used) →
    stale-suppression findings → baseline budgets (a file's per-rule count
    at or under its budget is grandfathered wholesale; over budget, every
    site reports). ``cache_path`` enables the local-summary cache."""
    selected = _select_rules(rules)
    ctxs = [build_context(rel, src) for rel, src in sources.items()]
    by_rel = {c.rel: c for c in ctxs}
    parsed = [c for c in ctxs if c.tree is not None]

    from .summaries import build_program

    program = build_program(parsed, cache_path=cache_path)
    for ctx in parsed:
        ctx.program = program

    raw: List[Finding] = []
    for ctx in ctxs:
        if ctx.tree is None:
            raw.append(
                Finding(
                    "parse-error", ctx.rel, 1,
                    f"file does not parse: {ctx.syntax_error}",
                )
            )
            continue
        for rule in selected:
            raw.extend(rule.check(ctx))
    for rule in selected:
        raw.extend(rule.check_project(parsed))

    suppressed: List[Finding] = []
    kept: List[Finding] = []
    for f in raw:
        ctx = by_rel.get(f.path)
        if ctx is not None and f.rule != UNUSED_SUPPRESSION and ctx.is_suppressed(f):
            suppressed.append(f)
        else:
            kept.append(f)

    checking_stale = rules is None or UNUSED_SUPPRESSION in rules
    if checking_stale:
        for ctx in ctxs:
            for line, ids in sorted(ctx.suppressions.items()):
                for rid in ids:
                    if (line, rid) in ctx.used_suppressions:
                        continue
                    kept.append(
                        Finding(
                            UNUSED_SUPPRESSION, ctx.rel, line,
                            f"suppression `kvtpu: ignore[{rid}]` silenced "
                            "nothing — the finding moved or was fixed; "
                            "delete the comment",
                        )
                    )

    counts: Dict[str, Dict[str, int]] = {}
    for f in kept:
        counts.setdefault(f.rule, {}).setdefault(f.path, 0)
        counts[f.rule][f.path] += 1

    findings: List[Finding] = []
    grandfathered: List[Finding] = []
    baseline = baseline or {}
    for f in sorted(kept, key=lambda x: (x.path, x.line, x.rule)):
        budget = baseline.get(f.rule, {}).get(f.path)
        n = counts[f.rule][f.path]
        if budget is not None and n <= budget:
            grandfathered.append(f)
        elif budget is not None:
            findings.append(
                Finding(
                    f.rule, f.path, f.line,
                    f.message + f" [{n} sites exceed the grandfathered "
                    f"budget of {budget}]",
                )
            )
        else:
            findings.append(f)
    return LintResult(findings, grandfathered, suppressed, counts)


def lint_source(
    source: str,
    path: str = "<string>.py",
    rules: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Lint one source string (no baseline) — the fixture-test entry point."""
    return run_lint({path: source}, rules=rules).findings


def run_package(
    rules: Optional[Sequence[str]] = None,
    baseline: Optional[Mapping[str, Mapping[str, int]]] = None,
    root: Optional[str] = None,
    cache_path: Optional[str] = None,
    only: Optional[Sequence[str]] = None,
) -> LintResult:
    """Lint every ``.py`` file in the package (or under ``root``).

    ``only`` restricts *reporting* to the given relative paths while the
    whole package is still parsed and summarised — interprocedural rules
    need the full program even when only a few files changed."""
    sources = {}
    for rel, path in iter_package_files(root):
        with open(path, "r") as fh:
            sources[rel] = fh.read()
    result = run_lint(
        sources, rules=rules, baseline=baseline, cache_path=cache_path
    )
    if only is None:
        return result
    keep = set(only)
    return LintResult(
        findings=[f for f in result.findings if f.path in keep],
        grandfathered=[f for f in result.grandfathered if f.path in keep],
        suppressed=[f for f in result.suppressed if f.path in keep],
        counts={
            rule: {p: n for p, n in by_path.items() if p in keep}
            for rule, by_path in result.counts.items()
        },
    )
