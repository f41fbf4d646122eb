"""Reporters: text / JSON output for lint runs, plus the auto-generated
``LINTS.md`` rule catalog (same regime as ``METRICS.md``: the committed
file is generated, and a drift check fails when the two diverge)."""
from __future__ import annotations

import json
from typing import Optional

from .core import RULES, LintResult, UNUSED_SUPPRESSION

__all__ = [
    "render_text",
    "render_json",
    "render_sarif",
    "catalog_markdown",
    "CATALOG_HEADER",
]


def render_text(result: LintResult, verbose: bool = False) -> str:
    lines = [f.render() for f in result.findings]
    if verbose and result.grandfathered:
        lines.append("grandfathered (baseline budget, shrink to clear):")
        lines += [f"  {f.render()}" for f in result.grandfathered]
    lines.append(
        f"{len(result.findings)} finding(s), "
        f"{len(result.grandfathered)} grandfathered, "
        f"{len(result.suppressed)} suppressed inline"
    )
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    return json.dumps(result.to_dict(), sort_keys=True)


#: pinned schema pointer — CI annotators key on the exact 2.1.0 shape
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)


def render_sarif(result: LintResult) -> str:
    """SARIF 2.1.0 for CI PR annotation: one run, one `result` per
    actionable finding (grandfathered/suppressed stay out — SARIF is the
    merge gate's view), rule metadata inlined so viewers can render the
    rationale without the repo checked out."""
    from . import core  # ensure rule modules are imported

    core._select_rules(None)
    used = sorted({f.rule for f in result.findings})
    rules = []
    for rid in used:
        rule = RULES.get(rid)
        desc = (
            rule.rationale.split(". ")[0].rstrip(".") + "."
            if rule is not None and rule.rationale
            else rid
        )
        rules.append({
            "id": rid,
            "shortDescription": {"text": desc},
        })
    index = {rid: i for i, rid in enumerate(used)}
    results = [
        {
            "ruleId": f.rule,
            "ruleIndex": index[f.rule],
            "level": "error",
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {
                            "uri": f.path,
                            "uriBaseId": "SRCROOT",
                        },
                        "region": {"startLine": f.line},
                    }
                }
            ],
        }
        for f in result.findings
    ]
    doc = {
        "$schema": SARIF_SCHEMA,
        "version": "2.1.0",
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "kv-tpu-torch-lint",
                        "informationUri": "kubernetes_verification_tpu_torch/LINTS.md",
                        "rules": rules,
                    }
                },
                "columnKind": "utf16CodeUnits",
                "results": results,
            }
        ],
    }
    return json.dumps(doc, indent=2, sort_keys=True)


CATALOG_HEADER = """# Lint rule catalog (PyTorch/CUDA port)

One section per `kv-tpu-torch lint` rule. Auto-generated from the rule
metadata by `python -m kubernetes_verification_tpu_torch.analysis
--write-docs kubernetes_verification_tpu_torch/LINTS.md` — edit the
`rationale`/`example` strings on the rule classes under
`kubernetes_verification_tpu_torch/analysis/`, not this file
(`--check-docs` fails when the two drift). The rule ids are the JAX
package's (`LINTS.md` at the repo root); `jit-host-sync`,
`recompile-hazard`, `aot-unregistered-kernel`, `collective-axis` and
`donation-hazard` ask their question of the port's eager torch execution.

Suppress a finding inline with a trailing comment on the flagged line (or
a comment-only line directly above it), always with a reason:

```python
self._fh = open(path, "a")  # kvtpu: ignore[atomic-write] WAL appends are torn-tail tolerant
```

Stale suppressions are themselves findings (`unused-suppression`).
Grandfathered legacy counts live in
`kubernetes_verification_tpu_torch/LINT_BASELINE.json` — budgets may
shrink (`kv-tpu-torch lint --update-baseline`) but never grow.
"""


def catalog_markdown() -> str:
    """The LINTS.md body, one section per registered rule."""
    from . import core  # ensure rule modules are imported

    core._select_rules(None)
    sections = [CATALOG_HEADER]
    for rule in RULES.values():
        sections.append(f"## `{rule.id}`\n")
        sections.append(rule.rationale.strip() + "\n")
        if rule.example:
            sections.append("Flagged:\n")
            sections.append("```python\n" + rule.example.rstrip() + "\n```\n")
        sections.append(
            f"Suppress with `# kvtpu: ignore[{rule.id}] <reason>`.\n"
        )
    sections.append(f"## `{UNUSED_SUPPRESSION}`\n")
    sections.append(
        "A `# kvtpu: ignore[...]` comment that silenced nothing — the "
        "finding it covered moved or was fixed. Delete the comment; this "
        "rule is not itself suppressible, so stale ignores rot loudly.\n"
    )
    return "\n".join(sections)


def check_docs(path: str) -> Optional[str]:
    """None when ``path`` matches the generated catalog, else a one-line
    diagnosis."""
    try:
        with open(path) as fh:
            on_disk = fh.read()
    except OSError:
        on_disk = ""
    if on_disk != catalog_markdown():
        return (
            f"{path} is stale — regenerate with `python -m "
            f"kubernetes_verification_tpu_torch.analysis --write-docs {path}`"
        )
    return None
