"""Metric-namespace lint and METRICS.md maintenance of the port — thin shim,
the counterpart of the root ``scripts/check_metrics_names.py`` with its
entry points, flags and exit codes::

    python -m kubernetes_verification_tpu_torch.scripts.check_metrics_names \\
        [--write PATH] [--check-docs PATH]

``REQUIRED_FAMILIES`` (the frozen dashboard contract) lives in the port's
``observe/metrics.py``; the live registry is the ground truth for what
registered:

* every family registered at import time must match ``^kvtpu_[a-z0-9_]+$``;
* every family in ``REQUIRED_FAMILIES`` must exist;
* ``--write PATH`` writes the reference table; ``--check-docs PATH`` fails
  when the file drifted from the code.

The port registers the same families as the JAX package (``families``
against the root ``METRICS.md``), but one help string differs
(``kvtpu_profile_captures_total`` counts ``torch.profiler`` captures), so
the port's table is its own file, ``kubernetes_verification_tpu_torch/
METRICS.md`` (``DOCS_PATH``).
"""
from __future__ import annotations

import argparse
import importlib
import os
import re
import sys

from ..observe.metrics import REQUIRED_FAMILIES

__all__ = [
    "DOCS_PATH",
    "MODULES",
    "check",
    "check_required",
    "docs_markdown",
    "families",
    "main",
]

#: modules that register metric families at import time (observe.metrics is
#: pulled in transitively, listed anyway so the lint stays explicit)
MODULES = (
    "kubernetes_verification_tpu_torch.observe",
    "kubernetes_verification_tpu_torch.observe.metrics",
)

#: the port's metrics reference, beside its LINTS.md
DOCS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "METRICS.md"
)

DOCS_HEADER = """# Metrics reference (PyTorch/CUDA port)

One row per `kvtpu_*` metric family of `kubernetes_verification_tpu_torch`.
Auto-generated from the live registry by `python -m
kubernetes_verification_tpu_torch.scripts.check_metrics_names --write
kubernetes_verification_tpu_torch/METRICS.md` — edit the help strings in
`kubernetes_verification_tpu_torch/observe/metrics.py`, not this file
(`--check-docs` fails when the two drift).
"""

_ROW = re.compile(r"^\| `(kvtpu_[a-z0-9_]+)` \|", re.M)


def _registry():
    from ..observe import REGISTRY

    for mod in MODULES:
        importlib.import_module(mod)
    return REGISTRY


def check() -> list:
    """Bad names (pattern violations); none when clean."""
    from ..observe import METRIC_NAME_RE

    reg = _registry()
    return [n for n in reg.names() if not METRIC_NAME_RE.match(n)]


def check_required() -> list:
    """Required families missing from the registry."""
    return sorted(REQUIRED_FAMILIES - set(_registry().names()))


def families(path: str) -> tuple:
    """``(only_in_registry, only_in_file)``: the families the registry and
    a METRICS.md table (the port's or the JAX package's) do not share."""
    with open(path) as fh:
        documented = set(_ROW.findall(fh.read()))
    names = set(_registry().names())
    return sorted(names - documented), sorted(documented - names)


def docs_markdown() -> str:
    """The METRICS.md body: a table with one row per family."""
    reg = _registry()
    lines = [DOCS_HEADER, "| name | kind | labels | help |", "|---|---|---|---|"]
    for m in reg.collect():
        labels = ", ".join(f"`{ln}`" for ln in m.labelnames) or "—"
        help_text = " ".join(m.help.split()).replace("|", "\\|")
        lines.append(f"| `{m.name}` | {m.kind} | {labels} | {help_text} |")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--write", metavar="PATH",
        help="write the auto-generated metrics reference table to PATH",
    )
    ap.add_argument(
        "--check-docs", metavar="PATH",
        help="exit 1 when PATH differs from the generated reference",
    )
    args = ap.parse_args(argv)

    bad = check()
    if bad:
        print(
            "metric names must match ^kvtpu_[a-z0-9_]+$ — offending: "
            + ", ".join(sorted(bad)),
            file=sys.stderr,
        )
        return 1
    missing = check_required()
    if missing:
        print(
            "required metric families missing from the registry: "
            + ", ".join(missing),
            file=sys.stderr,
        )
        return 1
    if args.write:
        with open(args.write, "w") as fh:  # kvtpu: ignore[atomic-write] a regenerated doc
            fh.write(docs_markdown())
        print(f"wrote {args.write}")
    if args.check_docs:
        try:
            with open(args.check_docs) as fh:
                on_disk = fh.read()
        except OSError:
            on_disk = ""
        if on_disk != docs_markdown():
            print(
                f"{args.check_docs} is stale — regenerate with `python -m "
                f"kubernetes_verification_tpu_torch.scripts.check_metrics_names "
                f"--write {args.check_docs}`",
                file=sys.stderr,
            )
            return 1
    reg = _registry()
    print(f"{len(reg.names())} metric families OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
