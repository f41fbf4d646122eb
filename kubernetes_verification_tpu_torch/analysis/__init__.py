"""``analysis/`` — the rule-based static-analysis framework behind
``kv-tpu-torch lint``.

The port of the JAX package's ``analysis/``: one framework, one finding
shape, one baseline, and the same rule ids. The hygiene, metric and
exit-contract rules are copies; the five rules whose JAX form asks a
question of tracing and ``shard_map`` ask the same question of the port's
eager torch execution (``rules_torch.py``, ``rules_interproc.py``): a
stream sync inside a registered dispatch function (``jit-host-sync``),
a dispatch key that lies (``recompile-hazard``), a dispatch function the
warm pack does not cover (``aot-unregistered-kernel``), a
``torch.distributed`` collective over an axis the mesh lacks or that not
every rank reaches (``collective-axis``), and a read of a tensor after a
callee wrote it in place (``donation-hazard``). Pure AST throughout —
linting imports nothing it lints and runs on source strings.

Entry points:

* ``kv-tpu-torch lint [PATHS] [--rules ...] [--format json|sarif]
  [--changed] [--no-cache] [--update-baseline]`` (also ``kv-tpu-torch-lint``)
* ``python -m kubernetes_verification_tpu_torch.analysis`` (same flags,
  headless)
* :func:`lint_source` / :func:`run_package` for tests and tooling

See ``kubernetes_verification_tpu_torch/LINTS.md`` (generated via
``--write-docs``) for the rule catalog and the suppression / baseline
contract; the budgets are ``kubernetes_verification_tpu_torch/
LINT_BASELINE.json``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .baseline import (
    default_baseline_path,
    load_baseline,
    over_budget,
    save_baseline,
    shrink,
)
from .core import (
    RULES,
    Finding,
    LintResult,
    Rule,
    lint_source,
    register,
    rule_ids,
    run_lint,
    run_package,
)
from .report import (
    catalog_markdown,
    check_docs,
    render_json,
    render_sarif,
    render_text,
)

__all__ = [
    "Finding",
    "LintResult",
    "Rule",
    "RULES",
    "register",
    "rule_ids",
    "lint_source",
    "run_lint",
    "run_package",
    "load_baseline",
    "save_baseline",
    "default_baseline_path",
    "shrink",
    "over_budget",
    "catalog_markdown",
    "render_text",
    "render_json",
    "render_sarif",
    "main",
    "add_lint_arguments",
]


def add_lint_arguments(ap: argparse.ArgumentParser) -> None:
    """The shared flag surface (``kv-tpu-torch lint`` and ``python -m
    ...analysis``)."""
    ap.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the installed package)",
    )
    ap.add_argument(
        "--rules", metavar="ID[,ID...]",
        help="comma-separated rule ids to run (default: all; see --list)",
    )
    ap.add_argument(
        "--format", choices=("text", "json", "sarif"), default="text",
        help="finding output format (sarif: 2.1.0, for CI PR annotation)",
    )
    ap.add_argument(
        "--changed", action="store_true",
        help="report findings only for files changed vs "
        "`git merge-base HEAD origin/main` (the whole package is still "
        "parsed, so interprocedural rules stay sound); falls back to a "
        "full run outside a git repo",
    )
    ap.add_argument(
        "--no-cache", action="store_true",
        help="skip the warm-run summary cache (.kvtpu_lint_cache.json in "
        "the package directory, keyed by file content hash)",
    )
    ap.add_argument(
        "--baseline", metavar="PATH", default=None,
        help="grandfather budgets (default: LINT_BASELINE.json in the "
        "package directory; missing file = zero budgets everywhere)",
    )
    ap.add_argument(
        "--update-baseline", action="store_true",
        help="shrink baseline budgets down to the current counts and drop "
        "cleaned-up entries (budgets may never grow — new findings must "
        "be fixed or inline-suppressed)",
    )
    ap.add_argument(
        "--list", action="store_true", dest="list_rules",
        help="print the registered rule ids and exit",
    )
    ap.add_argument(
        "--write-docs", metavar="PATH",
        help="write the auto-generated LINTS.md rule catalog to PATH",
    )
    ap.add_argument(
        "--check-docs", metavar="PATH",
        help="exit 1 when PATH drifted from the generated rule catalog",
    )
    ap.add_argument(
        "-v", "--verbose", action="store_true",
        help="also list grandfathered findings in text output",
    )


def changed_package_rels(base_ref: str = "origin/main"):
    """Package-relative paths of ``.py`` files modified vs
    ``git merge-base HEAD origin/main``. None means "cannot tell" (not a
    git checkout, no such ref, git missing) and the caller falls back to a
    full run — `--changed` must never silently lint nothing."""
    import os
    import subprocess

    from .core import package_root

    root = package_root()

    def _git(*argv):
        try:
            proc = subprocess.run(
                ["git", *argv], capture_output=True, text=True,
                cwd=root, timeout=30,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        return proc.stdout.strip() if proc.returncode == 0 else None

    toplevel = _git("rev-parse", "--show-toplevel")
    merge_base = _git("merge-base", "HEAD", base_ref)
    if toplevel is None or merge_base is None:
        return None
    diff = _git("diff", "--name-only", merge_base)
    if diff is None:
        return None
    rels = []
    for line in diff.splitlines():
        if not line.endswith(".py"):
            continue
        abs_path = os.path.join(toplevel, line)
        rel = os.path.relpath(abs_path, root).replace(os.sep, "/")
        if not rel.startswith(".."):
            rels.append(rel)
    return sorted(rels)


def run_from_args(args) -> int:
    """Drive a lint run from parsed :func:`add_lint_arguments` flags."""
    if args.list_rules:
        from .core import _select_rules

        for rule in _select_rules(None):
            first = rule.rationale.split(". ")[0].rstrip(".").strip()
            print(f"{rule.id}: {first}.")
        return 0
    if args.write_docs:
        with open(args.write_docs, "w") as fh:  # kvtpu: ignore[atomic-write] regenerated doc, not durable state
            fh.write(catalog_markdown())
        print(f"wrote {args.write_docs}")
        return 0
    if args.check_docs:
        problem = check_docs(args.check_docs)
        if problem:
            print(problem, file=sys.stderr)
            return 1
        print(f"{args.check_docs} is in sync")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    baseline_path = args.baseline or default_baseline_path()
    budgets = load_baseline(baseline_path)

    if args.paths:
        import os

        sources = {}
        from .core import iter_package_files

        for p in args.paths:
            base = os.path.abspath(p)
            for rel, path in iter_package_files(base):
                with open(path, "r") as fh:
                    sources[rel] = fh.read()
        result = run_lint(sources, rules=rules, baseline=budgets)
    else:
        # the summary cache only keys package-relative paths, so it is
        # scoped to full-package runs (explicit paths rel differently)
        cache_path = (
            None
            if getattr(args, "no_cache", False)
            else _default_cache_path()
        )
        only = None
        if getattr(args, "changed", False):
            only = changed_package_rels()
            if only is None:
                print(
                    "lint --changed: not a git checkout (or origin/main "
                    "unknown) — running the full package",
                    file=sys.stderr,
                )
        result = run_package(
            rules=rules, baseline=budgets, cache_path=cache_path, only=only
        )

    # lint health is an observable: the findings surface on the same
    # dashboards as every other kvtpu_* family
    try:
        from ..observe.metrics import LINT_FINDINGS_TOTAL

        for f in result.findings:
            LINT_FINDINGS_TOTAL.labels(rule=f.rule).inc()
    except ImportError:  # linting outside an installed package tree
        pass

    if args.update_baseline:
        new_budgets = shrink(budgets, result)
        if new_budgets != budgets:
            save_baseline(new_budgets, baseline_path)
            print(f"baseline shrunk: {baseline_path}")
        else:
            print("baseline already minimal")
        grew = over_budget(budgets, result)
        if grew:
            print(
                "counts grew past budget (fix or suppress, the baseline "
                f"never grows): {grew}",
                file=sys.stderr,
            )
            return 1
        return 0

    if args.format == "json":
        print(render_json(result))
    elif args.format == "sarif":
        print(render_sarif(result))
    else:
        print(render_text(result, verbose=args.verbose))
    return 0 if result.ok else 1


def _default_cache_path():
    from .summaries import default_cache_path

    return default_cache_path()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="kv-tpu-torch lint",
        description="flow-aware static analysis for the package "
        "(see LINTS.md for the rule catalog)",
    )
    add_lint_arguments(ap)
    return run_from_args(ap.parse_args(argv))
