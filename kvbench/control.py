"""The control of each cell: a whole run in which the configuration's
control, the reference with one guarantee broken, takes the program's place
where its answers are produced, judged by the run's own comparison. It has
to come out as not correct, or the comparison proves nothing.

    python3 -m kvbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

runs the cell once per seed with a short window at the cell's own load and
prints, per seed, ``correct`` and each number compared beside its limit.
Benchmark runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .run import ROOT, load_json, run_cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    bench = load_json(ROOT, "BENCHMARK.json")
    for seed in args.seeds:
        out = run_cell(bench, args.workload, seed, args.seconds, False,
                       t0=time.perf_counter(), fault="control")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"], "control": out["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
