"""Error-taxonomy / bare-except / atomic-write lint of the port — thin shim
over the port's ``analysis/`` rules (``error-taxonomy``, ``bare-except``,
``atomic-write``), the counterpart of the root
``scripts/check_error_taxonomy.py`` with its entry points and exit codes::

    python -m kubernetes_verification_tpu_torch.scripts.check_error_taxonomy

The per-file raise budgets are the ``error-taxonomy`` section of the port's
``kubernetes_verification_tpu_torch/LINT_BASELINE.json`` (shrink-only). Run
``kv-tpu-torch lint`` for the full rule set.
"""
from __future__ import annotations

import sys

from ..analysis import load_baseline, run_package
from ..analysis.baseline import default_baseline_path
from ..analysis.rules_hygiene import (
    ALWAYS_ALLOWED_RAISES as ALWAYS_ALLOWED,
    DISALLOWED_RAISES as DISALLOWED,
)

__all__ = ["ALWAYS_ALLOWED", "DISALLOWED", "GRANDFATHERED", "RULES", "check", "main"]

#: the per-file raise budgets: the ``error-taxonomy`` section of the port's
#: LINT_BASELINE.json (shrink-only; see ``kv-tpu-torch lint --help``)
GRANDFATHERED = dict(
    load_baseline(default_baseline_path()).get("error-taxonomy", {})
)

RULES = ("error-taxonomy", "bare-except", "atomic-write")


def check() -> list:
    """Findings over the budgets, as rendered strings (none when clean)."""
    result = run_package(
        rules=list(RULES), baseline=load_baseline(default_baseline_path())
    )
    return [f.render() for f in result.findings]


def main() -> int:
    problems = check()
    for p in problems:
        print(p, file=sys.stderr)
    if problems:
        print(f"{len(problems)} problem(s)", file=sys.stderr)
        return 1
    print("error taxonomy lint OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
