"""The bench-history regression gate over the port's ``observe/history.py``
(the counterpart of the JAX package's ``analysis/bench_gate.py``; run it as
``python -m kubernetes_verification_tpu_torch.analysis.bench_gate``).

Compares the newest run of every metric series against the trailing median
of the previous runs (``observe/history.py``) and exits 1 when a series
slipped more than ``--tolerance`` (relative). Reads ``bench_history.jsonl``
when present, else the committed ``BENCH_r*.json`` trajectory snapshots —
so the gate runs out of the box on a fresh checkout. Throughput series are
gated higher-is-better: names with an explicit direction
(``closure_pairs_per_second`` and ``aggregate_queries_per_second``, the
``bench.py --mode closure`` / ``--mode replicate`` headlines) plus
rate-shaped ones recognised structurally — a ``*_per_second`` metric name
or a ``.../s`` unit (the ``queries_per_second`` series ``bench.py --mode
query`` emits rides the gate with no further configuration). Latency-like
series gate lower-is-better, by unit or by explicit name
(``replica_lag_seconds``).

By default (``--deflated``) the gate expands each record into its derived
series first: a ``"<metric> compile_s"`` series (lower-is-better — the
14.3s→59.8s compile walk slipped through ungated) and, for records carrying
a perf-sentinel calibration block, the dispatch-deflated ``<metric>_deflated``
twin. Wherever a twin has ≥ 2 entries it carries the verdict and the raw
headline is reported as an ungated context row — the gate stops failing on
tunnel dispatch noise while raw numbers stay visible side by side.
``--raw`` restores the pre-sentinel behaviour (no expansion, raw gates).

``--dry-run`` exercises the full parse-and-compare path but always exits 0:
tier-1 runs it on every PR so a malformed history entry (or a gate-logic
regression) fails fast, without making perf noise a test failure.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from .core import repo_root

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "paths", nargs="*",
        help="history files: JSONL (bench_history.jsonl) and/or whole-file "
        "JSON snapshots (BENCH_r*.json); default: bench_history.jsonl when "
        "present, else BENCH_r*.json next to the repo root",
    )
    ap.add_argument(
        "--tolerance", type=float, default=0.25,
        help="relative slip vs. the trailing median before flagging "
        "(default 0.25 — the recorded trajectory's ~10%% drift passes, a "
        "2x slowdown fails)",
    )
    ap.add_argument(
        "--window", type=int, default=5,
        help="trailing runs the median is taken over (default 5)",
    )
    ap.add_argument(
        "--dry-run", action="store_true",
        help="parse and report but always exit 0 (the tier-1 CI mode)",
    )
    ap.add_argument("--json", action="store_true")
    deflation = ap.add_mutually_exclusive_group()
    deflation.add_argument(
        "--deflated", dest="deflated", action="store_true", default=True,
        help="expand derived series (compile_s, dispatch-deflated twins) "
        "and let a twin with enough history carry the verdict (default)",
    )
    deflation.add_argument(
        "--raw", dest="deflated", action="store_false",
        help="gate raw series only; no derived-series expansion",
    )
    args = ap.parse_args(argv)

    from ..observe.history import (
        check_regression,
        default_paths,
        expand_derived,
        format_findings,
        load_runs,
    )

    paths = args.paths or default_paths(repo_root())
    runs = load_runs(paths)
    if args.deflated:
        runs = expand_derived(runs)
    ok, findings = check_regression(
        runs, tolerance=args.tolerance, window=args.window,
        prefer_deflated=args.deflated,
    )
    if args.json:
        print(json.dumps({"ok": ok, "findings": findings}, sort_keys=True))
    else:
        print(
            f"{len(runs)} runs from {len(paths)} file(s), "
            f"tolerance {args.tolerance:g}, window {args.window}"
        )
        print(format_findings(findings))
    if args.dry_run:
        if not ok:
            print("(dry run: regression found but exit forced to 0)")
        return 0
    return 0 if ok else 1
