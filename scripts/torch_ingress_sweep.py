#!/usr/bin/env python3
"""Run the port's ``bench --mode ingress`` several times, each alone in a
child process, and read back each fleet's open-loop sweep: did the load
generator offer each multiple of the capacity probe's rate, and where
goodput fell, was the door shedding (typed rejections) or was it offered
less?

    python3 scripts/torch_ingress_sweep.py [--runs 10] [--out FILE] [-- BENCH_ARGS...]

Each child is ``python -m kubernetes_verification_tpu_torch.bench --mode
ingress`` (the card by default; pass ``-- --device cpu --pods 256
--policies 32`` for a CPU dry run) with ``KVTPU_BENCH_HISTORY`` in a
temporary directory. Per run and fleet it prints the capacity probe's
probes/s, the 2.5× row's offered rate over that capacity, the knee's and
the 2.5× row's goodput, the post-knee hold (the gate reads it: ≥ 0.8), and
the row with the lowest offered/asked ratio; the child's exit and its
gate's message when it failed. Reads the ``ingress-sweep`` JSON lines the
mode logs before its gate's asserts. ``--out`` keeps every row as JSON
(with the card's name and power limit from ``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def one_run(bench_args) -> dict:
    with tempfile.TemporaryDirectory(prefix="kvt-ingress-") as tmp:
        env = dict(os.environ, KVTPU_BENCH_HISTORY=os.path.join(tmp, "history.jsonl"),
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "kubernetes_verification_tpu_torch.bench",
             "--mode", "ingress", *bench_args],
            cwd=ROOT, env=env, capture_output=True, text=True)
    sweeps = [json.loads(ln.split(" ", 1)[1]) for ln in proc.stderr.splitlines()
              if ln.startswith("ingress-sweep ")]
    return {
        "rc": proc.returncode,
        "wall_s": time.perf_counter() - t0,
        "sweeps": sweeps,
        "gate": [ln for ln in proc.stderr.splitlines() if "AssertionError" in ln],
        "tail": proc.stderr[-2000:] if proc.returncode else "",
    }


def describe(run: dict) -> list:
    lines = []
    for sw in run["sweeps"]:
        rows = sw["rows"]
        knee = max(rows, key=lambda r: r["goodput_probes_s"])
        post = rows[-1]
        held = post["goodput_probes_s"] / max(1.0, knee["goodput_probes_s"])
        short = min(rows, key=lambda r: r["offered_over_capacity"] / r["mult"])
        lines.append(
            f"  fleet {sw['fleet']}: capacity {sw['capacity_probes_s']:.1f} probes/s; "
            f"x{post['mult']} offered {post['offered_over_capacity']:.4f}x capacity, "
            f"goodput {post['goodput_probes_s']:.1f} (knee {knee['goodput_probes_s']:.1f} "
            f"at x{knee['mult']}), held {held:.3f}; rejected "
            f"{sum(r['rejected_probes'] for r in rows)} probes; lowest offer x{short['mult']} "
            f"at {short['offered_over_capacity'] / short['mult']:.3f} of its multiple")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--out", help="write every run's sweep rows here as JSON")
    ap.add_argument("bench_args", nargs=argparse.REMAINDER,
                    help="after --: extra arguments of the bench")
    args = ap.parse_args(argv)
    bench_args = [a for a in args.bench_args if a != "--"]
    card = smi()
    print(f"card: {card}", flush=True)
    runs = []
    for i in range(args.runs):
        run = one_run(bench_args)
        runs.append(run)
        print(f"run {i}: exit {run['rc']}, {run['wall_s']:.1f} s"
              + (f"; gate: {run['gate'][-1]}" if run["gate"] else ""), flush=True)
        for line in describe(run):
            print(line, flush=True)
        if args.out:
            with open(args.out + ".tmp", "w") as fh:
                json.dump({"card": card, "bench_args": bench_args, "runs": runs}, fh)
            os.replace(args.out + ".tmp", args.out)
    failed = sum(1 for r in runs if r["rc"] != 0)
    met = sum(1 for r in runs for sw in r["sweeps"]
              if sw["rows"][-1]["offered_over_capacity"] >= 0.98 * sw["rows"][-1]["mult"])
    fleets = sum(len(r["sweeps"]) for r in runs)
    print(f"{args.runs} runs, {failed} failed their gate; the x2.5 row offered >= 0.98 of its "
          f"multiple in {met} of {fleets} fleet sweeps; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
