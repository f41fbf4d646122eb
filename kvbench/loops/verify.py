"""The ``verify`` loop: a closed loop with one client.

Step ``i`` encodes and solves a snapshot of its own, the base cluster with
the ``i``-th single-policy edit (``encode_cluster`` then
``tiled_k8s_reach(fetch=False)``, ending on its pair-count sync). After the
window, the sampled rows and both isolation vectors of some steps are held
against the reference, the last step's pair count against a popcount of its
words, and the sampled rows' pair count against the reference's.
"""
from __future__ import annotations

import random
import time
from typing import Dict

import torch

from kvbench import adapter, generate, reference
from kvbench.mixes import (Context, Run, control_answer, device_kind, free, judge, peak,
                           sample_rows, setup_done)
from kvbench.trace import span, traced


def run(ctx: Context) -> Run:
    from kubernetes_verification_tpu_torch.encode.encoder import encode_cluster
    from kubernetes_verification_tpu_torch.models.core import Cluster
    from kubernetes_verification_tpu_torch.ops.tiled import tiled_k8s_reach

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    dep, ports = cfg["deployment"], cfg["compute_ports"]
    rec = Run("verify", device_kind(dev))
    cluster = generate.random_cluster(dep, ctx.seed)
    rec.counters["generated_s"] = time.perf_counter() - ctx.t0
    edits = generate.verify_edits(cluster, dep, f"{ctx.seed}:edits", mix["max_steps"] + 1)
    base = adapter.cluster(cluster)
    namespaces = base.namespaces
    edit_pols = [adapter.policy(e["policy"]) for e in edits]
    n = len(cluster["pods"])
    rows = sample_rows(n, mix["row_stride"], ctx.seed)
    rows_t = torch.as_tensor(rows, device=dev)
    rec.counters.update(n_pods=n, n_policies=len(cluster["policies"]))

    def step(i: int):
        pols = list(base.policies)
        pols[edits[i]["index"]] = edit_pols[i]
        snap = Cluster(pods=base.pods, namespaces=list(namespaces), policies=pols)
        t_a = time.perf_counter()
        with span("encode"):
            enc = encode_cluster(snap, compute_ports=ports)
        t_b = time.perf_counter()
        with span("solve"):
            res = tiled_k8s_reach(enc, device=dev, fetch=False)
            pairs = res.timings["reachable_pairs"]
        t_c = time.perf_counter()
        if ctx.fault == "unchanged" and keep:
            res, pairs = keep["res"], keep["pairs"]
        words = res.packed[rows_t]
        iso_in, iso_eg = res.ingress_isolated.copy(), res.egress_isolated.copy()
        if ctx.fault == "control":
            words, iso_in, iso_eg = control_answer(
                ctx, generate.snapshot(cluster, edits[i]), rows, words.shape[1])
        if ctx.fault == "half":
            words = torch.where((rows_t < n // 2)[:, None], words, torch.zeros_like(words))
        if ctx.fault == "altered":
            words = words.clone()
            words[0, 0] ^= 1
        out = {"edit": i, "words": words.cpu(), "pairs": pairs, "iso_in": iso_in,
               "iso_eg": iso_eg}
        return enc, res, out, {"encode_s": t_b - t_a, "solve_s": t_c - t_b}

    keep: Dict = {}
    _, res, _, _ = step(0)  # warm-up on a snapshot of its own
    if ctx.fault == "unchanged":  # every step answers for the warm-up's snapshot
        keep.update(res=res, pairs=res.timings["reachable_pairs"])
    res = None
    free(dev)
    setup_done(ctx, rec)

    outs, enc = [], None
    with traced(ctx.trace) as tr, span("window"):
        w0 = time.perf_counter()
        for i in range(1, len(edits)):
            if time.perf_counter() - w0 >= ctx.seconds:
                break
            res = enc = None  # the last step's state goes before the next
            rec.attempted += 1
            enc, res, out, times = step(i)
            outs.append(out)
            rec.steps.append(times)
        rec.window_s = time.perf_counter() - w0
    rec.trace = tr if ctx.trace else None
    rec.peak_bytes = peak(dev)
    if ctx.trace and enc is not None and len(enc.atoms) > 1:
        from kubernetes_verification_tpu_torch.ops.tiled_ports import port_layout_stats

        st = port_layout_stats(enc)
        rec.counters.update(vp_rows=st["K"], k_padded=st["K_padded"])

    # judge: the popcount of the last step on its own words, then sampled
    # steps' rows, isolation and pair counts against the reference
    t_check = time.perf_counter()
    total = reference.popcount(res.packed) if res is not None else 0
    pairs_gap = abs(total - outs[-1]["pairs"]) if outs else 0
    res = enc = keep = None
    free(dev)
    rng = random.Random(f"{ctx.seed}:check")
    chosen = sorted(set(rng.sample(range(len(outs) - 1), min(mix["check_steps"] - 1,
                                                             max(0, len(outs) - 1))))
                    | ({len(outs) - 1} if outs else set()))
    rows_differ = iso_differ = sampled_pairs_gap = 0
    for k in chosen:
        out = outs[k]
        snap = generate.snapshot(cluster, edits[out["edit"]])
        ii, ie, want = reference.solve_rows(snap, rows, compute_ports=ports, device=dev)
        rows_differ += reference.compare_rows(out["words"], want, n)[0]
        iso_differ += int((ii != out["iso_in"]).sum() + (ie != out["iso_eg"]).sum())
        sampled_pairs_gap += abs(reference.popcount(out["words"]) - int(want[:, :n].sum()))
    rec.counters.update(checked_steps=len(chosen), check_s=time.perf_counter() - t_check,
                        step_s=[st["encode_s"] + st["solve_s"] for st in rec.steps])
    judge(rec, mix["limits"], dict(rows_differ=rows_differ, iso_differ=iso_differ,
                                   pairs_gap=pairs_gap, sampled_pairs_gap=sampled_pairs_gap))
    return rec
