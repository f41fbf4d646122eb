"""One run of one benchmark cell of the PyTorch/CUDA port on the card.

    python3 -m kvbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json``, its configuration in
``kvbench/configs/<config>.json`` and its mix in ``kvbench/traffic/<mix>.json``,
runs the loop the mix names (``kvbench/loops/<loop>.py``), reads each metric with its reader in
``kvbench/metrics/<metric>.py``, and prints one JSON line last. Exits with a
code other than 0, printing no result, without enough CUDA devices, or when
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

#: the process environment of a run, set before the interpreter and the
#: numerical libraries start: a fixed string-hash seed (the layout of every
#: dict and set of the program's host work, which otherwise moves its speed
#: from process to process) and few host threads
RUN_ENV = {"PYTHONHASHSEED": "0", "OMP_NUM_THREADS": "4", "MKL_NUM_THREADS": "4",
           "OPENBLAS_NUM_THREADS": "4"}

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "kubernetes_verification_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def by_name(folder: str, name: str):
    """The module ``kvbench/<folder>/<name>.py``, loaded from its path."""
    path = os.path.join(HERE, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"kvbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The ``read(run)`` function of ``kvbench/metrics/<name>.py``, or,
    where there is none, of the reader of the name's first part
    (``device_idle.verify`` → ``device_idle.py``): one quantity, read alike,
    split by the end-to-end metric it moves."""
    if not os.path.exists(os.path.join(HERE, "metrics", f"{name}.py")):
        name = name.split(".", 1)[0]
    return by_name("metrics", name).read


def loop(name: str):
    """The ``run(ctx)`` function of ``kvbench/loops/<name>.py``."""
    return by_name("loops", name).run


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a cell reports: its end-to-end ones, or with ``trace``
    its per-layer ones; a metric with ``workloads`` only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None, overrides: Optional[Dict] = None,
             fault: Optional[str] = None) -> Dict:
    """Run one cell and return the result line as a dict. ``overrides``
    (a test's small sizes: ``deployment`` knobs and mix parameters) and
    ``fault`` (a planted fault, or ``"control"``: see ``mixes.Context``)
    serve the tests and the control; a benchmark run passes neither."""
    import torch

    from . import mixes

    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    config = load_json(HERE, "configs", f"{cell['config']}.json")
    mix = load_json(HERE, "traffic", f"{cell['traffic']}.json")
    if overrides:
        config = {**config, "deployment": {**config["deployment"],
                                           **overrides.get("deployment", {})}}
        config["engine"] = {**config["engine"], **overrides.get("engine", {})}
        mix = {**mix, **overrides.get("mix", {})}
    dev = torch.device(device)
    ctx = mixes.Context(config, mix, seed, seconds, trace, dev,
                        T0 if t0 is None else t0, fault)
    run = loop(mix["loop"])(ctx)

    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (run.attempted > 0 and run.failed == 0
               and all(v <= lim for v, lim in run.checks.values()))
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": run.device_kind,
        "count": 1,
        "memory_peak_bytes": run.peak_bytes,
    }
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["counters"] = run.counters
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if any(os.environ.get(k) != v for k, v in RUN_ENV.items()):
        # start again: the same command in the run's environment
        os.execve(sys.executable, [sys.executable, "-m", "kvbench.run", *sys.argv[1:]],
                  {**os.environ, **RUN_ENV})
    sys.exit(main())
