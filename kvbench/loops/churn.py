"""The ``churn`` loop: a closed loop with one change in flight.

Each change is one call to the configuration's serving engine, built
beforehand from the mix's plain change dicts (``generate.churn_changes``),
then a device synchronisation; its latency runs from the call to the end of
the sync. A change the engine refuses counts as failed. After the window
the engine's live words of the sampled rows and both isolation vectors are
held against the reference's own evolution of the cluster.
"""
from __future__ import annotations

import importlib
import time
from typing import Callable, Dict, List

import torch

from kvbench import adapter, generate, reference
from kvbench.mixes import (Context, Run, control_answer, device_kind, free, judge, peak,
                           sample_rows, setup_done, sync)
from kvbench.trace import span, traced


def change_call(change: Dict) -> Callable:
    """A call ``f(engine)`` that applies one churn change to a serving
    engine (``PackedIncrementalVerifier`` or
    ``PackedPortsIncrementalVerifier``), its objects built beforehand so the
    call holds only the engine's work."""
    op = change["op"]
    if op == "pod_relabel":
        idx, labels = change["index"], dict(change["labels"])
        return lambda eng: eng.update_pod_labels(idx, labels)
    if op == "policy_add":
        pol = adapter.policy(change["policy"])
        return lambda eng: eng.add_policy(pol)
    if op == "policy_update":
        pol = adapter.policy(change["policy"])
        return lambda eng: eng.update_policy(pol)
    if op == "policy_remove":
        ns, name = change["namespace"], change["name"]
        return lambda eng: eng.remove_policy(ns, name)
    raise ValueError(f"unknown change {op!r}")


def engine(cfg: Dict, cluster, dev):
    """The configuration's serving engine, named by its dotted class path."""
    from kubernetes_verification_tpu_torch.backends.base import VerifyConfig

    eng = cfg["engine"]
    mod, name = eng["class"].rsplit(".", 1)
    return getattr(importlib.import_module(mod), name)(
        cluster, VerifyConfig(compute_ports=cfg["compute_ports"]), device=dev,
        **eng.get("kwargs", {}))


def run(ctx: Context) -> Run:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    dep = cfg["deployment"]
    rec = Run("churn", device_kind(dev))
    cluster = generate.random_cluster(dep, ctx.seed)
    rec.counters["generated_s"] = time.perf_counter() - ctx.t0
    changes = generate.churn_changes(cluster, dep, f"{ctx.seed}:churn", mix,
                                     mix["max_changes"])
    n = len(cluster["pods"])
    rows = sample_rows(n, mix["row_stride"], ctx.seed)
    rec.counters.update(n_pods=n, n_policies=len(cluster["policies"]))
    eng = engine(cfg, adapter.cluster(cluster), dev)
    rec.counters["built_s"] = time.perf_counter() - ctx.t0
    calls: List[Callable] = [change_call(ch) for ch in changes]
    if ctx.fault == "unchanged":  # relabels leave the engine as it was
        calls = [(lambda e: None) if ch["op"] == "pod_relabel" else c
                 for ch, c in zip(changes, calls)]
    if ctx.fault == "half":  # every second pod relabel is left out
        relabels = [j for j, ch in enumerate(changes) if ch["op"] == "pod_relabel"]
        for j in relabels[1::2]:
            calls[j] = lambda e: None

    # warm-up: changes until every kind of the mix has run once
    kinds, done = set(mix["shares"]), 0
    while done < len(changes) and not kinds <= {ch["op"] for ch in changes[:done]}:
        calls[done](eng)
        done += 1
    sync(dev)
    free(dev)
    setup_done(ctx, rec)

    with traced(ctx.trace) as tr, span("window"):
        w0 = time.perf_counter()
        for j in range(done, len(changes)):
            if time.perf_counter() - w0 >= ctx.seconds:
                break
            rec.attempted += 1
            t_a = time.perf_counter()
            try:
                with span("change"):
                    calls[j](eng)
                t_b = time.perf_counter()
                sync(dev)
            except Exception as e:  # a refused change is a failed one
                rec.failed += 1
                print(f"change {j} ({changes[j]['op']}) failed: {e!r}", flush=True)
                t_b = time.perf_counter()
            t_c = time.perf_counter()
            rec.steps.append({"op": changes[j]["op"], "host_s": t_b - t_a,
                              "latency_s": t_c - t_a})
            done = j + 1
        rec.window_s = time.perf_counter() - w0
    rec.trace = tr if ctx.trace else None
    rec.peak_bytes = peak(dev)

    t_check = time.perf_counter()
    pr = eng.packed_reach()
    words = pr.packed[torch.as_tensor(rows, device=dev)].cpu()
    iso_in, iso_eg = pr.ingress_isolated.copy(), pr.egress_isolated.copy()
    pr = eng = calls = None
    free(dev)
    want_cluster = reference.evolve(cluster, changes[:done])
    if ctx.fault == "control":
        words, iso_in, iso_eg = control_answer(ctx, want_cluster, rows, words.shape[1])
    if ctx.fault == "altered":
        words[0, 0] ^= 1
    ii, ie, want = reference.solve_rows(want_cluster, rows,
                                        compute_ports=cfg["compute_ports"], device=dev)
    rows_differ = reference.compare_rows(words, want, n)[0]
    iso_differ = int((ii != iso_in).sum() + (ie != iso_eg).sum())
    by_op: Dict[str, list] = {}
    for st in rec.steps:
        by_op.setdefault(st["op"], []).append(st["latency_s"])
    rec.counters.update(changes_applied=done, check_s=time.perf_counter() - t_check,
                        median_ms={op: 1e3 * sorted(v)[len(v) // 2] for op, v in by_op.items()})
    judge(rec, mix["limits"], dict(rows_differ=rows_differ, iso_differ=iso_differ))
    return rec
