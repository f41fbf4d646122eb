"""Time a posture-attached dense service's query plane on one GPU.

    PYTHONPATH=. python kubernetes_verification_tpu_torch/harness/posture_queries.py \
        [--tag NAME] [--batches 3] [--device cuda] [--pods N]

Builds a dense ``VerificationService`` on ``cuda`` at the dense engine's
limit (``random_cluster(32,768 pods, 3,277 policies, 20 namespaces,
seed 0)``, the service size ``chip_smoke.py`` phase 23 drives), turns posture
on, and applies batches of 64 events of ``random_event_stream(seed=2)``
(relabels of namespaces that hold pods left out: each re-evaluates every pod
of its namespace on the host). After each batch's publish it times, in this
order, the query paths that read whether the engine's reach is clean:
``check_assertions`` (4 assertions), ``can_reach_batch`` (4,096 any-port
probes), ``blast_radius_batch`` and ``who_can_reach_batch`` (64 pods each),
then ``reach()``, then the same probes again. Each time is wall time after a
``torch.cuda.synchronize()``. The answers are held against ``reach()``, and
a sha256 of every answer is printed, so two trees can be compared answer for
answer.

The script imports the package it finds on ``PYTHONPATH``: given another
checkout's root, it times that checkout's package. Prints one
JSON object as its last line; exits 2 without
a CUDA device unless ``--device cpu`` asks for the CPU (``--pods`` then cuts
the cluster for a dry run: times on the CPU are no device times).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

DENSE = dict(n_pods=32_768, n_policies=3_277, n_namespaces=20,
             p_ipblock_peer=0.0, min_selector_labels=1, seed=0)
BATCH = 64


def _timed(fn, sync):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pods", type=int, default=DENSE["n_pods"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("posture_queries: no CUDA device", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    timed = lambda fn: _timed(fn, sync)
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.serve import (
        Assertion,
        PodSelector,
        QueryEngine,
        UpdateNamespaceLabels,
        VerificationService,
        check_assertions,
    )

    gen = dict(DENSE, n_pods=args.pods,
               n_policies=max(1, DENSE["n_policies"] * args.pods // DENSE["n_pods"]))
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**gen))
    populated = {p.namespace for p in cluster.pods}
    stream = [e for e in random_event_stream(cluster, n_events=2 * BATCH * args.batches, seed=2)
              if not (isinstance(e, UpdateNamespaceLabels) and e.namespace in populated)]
    svc, build_s = timed(lambda: VerificationService(cluster, device=args.device))
    rng = np.random.default_rng(23)
    names = [ns.name for ns in cluster.namespaces]
    svc.assertions = [
        Assertion(f"q-{j}", "deny" if j % 2 else "allow",
                  PodSelector(namespace=cluster.pods[int(i)].namespace,
                              labels=tuple(sorted(cluster.pods[int(i)].labels.items()))[:2]),
                  PodSelector(namespace=names[(7 * j + 3) % len(names)]))
        for j, i in enumerate(rng.choice(len(cluster.pods), 4, replace=False))
    ]
    _, posture_s = timed(svc.enable_posture)
    q = QueryEngine(svc)
    pods = svc.engine.pods
    ref = lambda k: f"{pods[k].namespace}/{pods[k].name}"
    digest = hashlib.sha256()
    batches = []
    for b in range(args.batches):
        _, apply_s = timed(lambda: svc.apply(stream[b * BATCH : (b + 1) * BATCH]))
        n = len(svc.engine.pods)
        pods = svc.engine.pods
        rs = np.random.default_rng(1000 + b)
        src, dst = rs.integers(0, n, 4096), rs.integers(0, n, 4096)
        probes = [(ref(s), ref(d)) for s, d in zip(src, dst)]
        few = [ref(k) for k in rs.integers(0, n, 64)]
        row = {"batch": b, "apply_s": apply_s}
        found, row["check_assertions_s"] = timed(lambda: check_assertions(svc, svc.assertions))
        ans, row["can_reach_batch_s"] = timed(lambda: q.can_reach_batch(probes))
        blast, row["blast_radius_batch_s"] = timed(lambda: q.blast_radius_batch(few))
        who, row["who_can_reach_batch_s"] = timed(lambda: q.who_can_reach_batch(few))
        reach, row["reach_s"] = timed(svc.reach)
        again, row["can_reach_batch_after_reach_s"] = timed(lambda: q.can_reach_batch(probes))
        if not (np.array_equal(np.asarray(ans), reach[src, dst])
                and np.array_equal(np.asarray(again), reach[src, dst])):
            print(f"posture_queries: batch {b} answers differ from reach()", file=sys.stderr)
            return 1
        row["solves"] = dict(svc.stats.solves)
        row["violations"] = len(found)
        for part in (np.asarray(ans), np.packbits(reach, axis=1), [sorted(x) for x in blast],
                     [sorted(x) for x in who], [v.assertion for v in found]):
            digest.update(repr(part if isinstance(part, list) else part.tobytes()).encode())
        batches.append(row)
        print(json.dumps(row), flush=True)
    svc.close()
    result = {
        "tag": args.tag,
        "package": kvt.__file__,
        "card": _card(),
        "torch": torch.__version__,
        "device": args.device,
        "pods": args.pods,
        "build_s": build_s,
        "enable_posture_s": posture_s,
        "batches": batches,
        "total_solves": sum(svc.stats.solves.values()),
        "peak_device_gib": torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
        "answers_sha256": digest.hexdigest(),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
