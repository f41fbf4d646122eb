"""The unified grandfather baseline: one ``LINT_BASELINE.json`` inside the
package directory, shared by every rule.

Shape::

    {"rule-id": {"package/relative/path.py": budget, ...}, ...}

A budget is the finding count a file was carrying when the rule was
adopted. The contract is monotone: a budget **may shrink but never grow** —
new findings anywhere must be fixed or carry an inline
``# kvtpu: ignore[rule-id]`` with a reason, never a bigger number here.
``shrink()`` (the ``--update-baseline`` path) enforces that direction: it
lowers budgets to the current counts and drops cleaned-up entries, and it
refuses to add entries or raise numbers.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from .core import LintResult, package_root

__all__ = [
    "BASELINE_NAME",
    "default_baseline_path",
    "load_baseline",
    "save_baseline",
    "shrink",
    "over_budget",
]

BASELINE_NAME = "LINT_BASELINE.json"

Budgets = Dict[str, Dict[str, int]]


def default_baseline_path() -> str:
    return os.path.join(package_root(), BASELINE_NAME)


def load_baseline(path: Optional[str] = None) -> Budgets:
    """Parse the baseline; a missing file is an empty baseline (zero budget
    everywhere), a malformed one raises — silence here would un-gate every
    grandfathered rule at once."""
    target = path or default_baseline_path()
    if not os.path.exists(target):
        return {}
    with open(target, "r") as fh:
        data = json.load(fh)
    out: Budgets = {}
    for rule, files in data.items():
        if not isinstance(files, dict):
            raise json.JSONDecodeError(
                f"baseline entry for rule {rule!r} must be an object",
                target, 0,
            )
        out[rule] = {str(rel): int(n) for rel, n in files.items()}
    return out


def save_baseline(budgets: Budgets, path: Optional[str] = None) -> str:
    """Atomic write (the lint of the linter: rule ``atomic-write`` watches
    this module too)."""
    target = path or default_baseline_path()
    body = json.dumps(
        {r: dict(sorted(files.items())) for r, files in sorted(budgets.items())},
        indent=2,
        sort_keys=True,
    ) + "\n"
    tmp = target + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(body)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, target)
    return target


def shrink(budgets: Budgets, result: LintResult) -> Budgets:
    """The only legal baseline update: clamp every existing budget down to
    the current count and drop entries that reached zero. Counts above
    budget (or findings with no entry at all) are NOT absorbed — they stay
    red until fixed or inline-suppressed."""
    out: Budgets = {}
    for rule, files in budgets.items():
        for rel, budget in files.items():
            current = result.counts.get(rule, {}).get(rel, 0)
            new = min(budget, current)
            if new > 0:
                out.setdefault(rule, {})[rel] = new
    return out


def over_budget(budgets: Budgets, result: LintResult) -> Dict[str, Dict[str, int]]:
    """{rule: {path: count}} for every grandfathered entry whose current
    count GREW past its budget — the monotonicity test's assertion body."""
    bad: Dict[str, Dict[str, int]] = {}
    for rule, files in budgets.items():
        for rel, budget in files.items():
            current = result.counts.get(rule, {}).get(rel, 0)
            if current > budget:
                bad.setdefault(rule, {})[rel] = current
    return bad
