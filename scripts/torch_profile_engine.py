#!/usr/bin/env python3
"""Where the port's serving engines spend their time on one NVIDIA GPU: host
against device per op, and the state round trip's parts.

    python3 scripts/torch_profile_engine.py [--pods 100000 --policies 10000] [--ports | --dense]

Builds the any-port engine (``PackedIncrementalVerifier``), or with
``--ports`` the port-bitmap engine (``PackedPortsIncrementalVerifier``, on
the cluster encoded with port bitmaps), on ``chip_smoke.py``'s main-path
cluster, then:

1. per op kind (8 of each): the whole op on the host clock after a device
   sync, beside its host part alone (any-port: ``PolicyVectorizer.vectors``
   for a policy op, ``_pod_cols`` for a pod op; ports: ``_policy_groups``
   and ``_plan_alloc`` for an add, ``_policy_sel`` and ``_policy_groups``
   for an update, ``_pod_vp_cols`` for a pod op) — the rest is the device
   work;
2. the device steps alone by CUDA events: one row patch group (any-port 512
   rows, ports 256), one 256-column patch group, one pod step (occupy +
   tombstone); with ``--ports`` also the build's operand copy
   (``engine_fused_args``) and its ``fused_ports_reach`` launch;
3. ``state_dict``: the maps packed to the JAX layout, the words fetched;
4. ``from_state``: the manifest copy, each map's upload and unpack, the
   words' upload, then the whole resume with its split.

With ``--dense`` it builds the dense engine (``IncrementalVerifier``, on
``chip_smoke.py``'s phase-18 cluster: 32,768 pods / 3,277 policies unless
``--pods``/``--policies`` say otherwise) and splits its build phases, each
op kind into the whole op and its host part (``_policy_vectors`` for a
policy op; for a pod relabel, the device patch alone by CUDA events), the
device steps alone (a policy's two rank-1 block updates, one row + column
patch, the reach derivation) and the reach's device-to-host copy. The
dense engine's checkpoints go through PyYAML (host-only), so the state
round trip is not timed here.

Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuda_ms(fn, reps: int = 1) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def med(xs) -> str:
    return f"median {statistics.median(xs) * 1e3:.1f} ms (of {len(xs)})"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=100_000)
    ap.add_argument("--policies", type=int, default=10_000)
    ap.add_argument("--ports", action="store_true",
                    help="profile the port-bitmap engine instead")
    ap.add_argument("--dense", action="store_true",
                    help="profile the dense engine instead (default size 32,768 / 3,277)")
    args = ap.parse_args()
    if args.dense and (args.pods, args.policies) == (100_000, 10_000):
        args.pods, args.policies = 32_768, 3_277
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import kubernetes_verification_tpu_torch as kvt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gen = dict(n_pods=args.pods, n_policies=args.policies, n_namespaces=20,
               p_ipblock_peer=0.0, min_selector_labels=1)
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=0, **gen))
    if args.ports:
        return profile_ports(cluster, smi)
    donor = kvt.random_cluster(kvt.GeneratorConfig(**{**gen, "n_pods": 2_000,
                                                      "n_policies": 64, "seed": 1}))
    if args.dense:
        return profile_dense(cluster, donor, smi)
    return profile_any_port(cluster, donor, smi)


def profile_dense(cluster, donor, smi: str) -> int:
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch import incremental as inc

    t = host_s(lambda: kvt.IncrementalVerifier(cluster))
    eng = kvt.IncrementalVerifier(cluster)
    n = len(eng.pods)
    print(f"build: {t:.2f} s, second build " + ", ".join(
        f"{k} {v:.3f} s" for k, v in eng.build_timings.items())
        + f"; {n} pods, {len(eng.policies)} policies", flush=True)
    rng = np.random.default_rng(5)

    # 1. host against device, per op kind
    parts = {}
    for i, p in enumerate(donor.policies[:8]):
        p = dataclasses.replace(p, name=f"prof-{i}")
        parts.setdefault("add_policy host", []).append(host_s(lambda: eng._policy_vectors(p)))
        parts.setdefault("add_policy", []).append(host_s(lambda: eng.add_policy(p)))
    pols = list(eng.policies.values())
    for j in rng.choice(len(pols) - 8, 8, replace=False):
        q = dataclasses.replace(pols[j], ingress=pols[j + 1].ingress)
        parts.setdefault("update_policy host", []).append(host_s(lambda: eng._policy_vectors(q)))
        parts.setdefault("update_policy", []).append(host_s(lambda: eng.update_policy(q)))
    for i in rng.choice(n, 8, replace=False):
        parts.setdefault("update_pod_labels", []).append(
            host_s(lambda: eng.update_pod_labels(int(i), {"prof": "x"})))
    for name, xs in parts.items():
        print(f"op {name}: {med(xs)}", flush=True)

    # 2. the device steps alone; a patch is applied and undone in each run,
    # so the state stays as it was, and each time is per application
    vecs = list(eng._vectors.values())
    cells = [int(v[2].sum()) * int(v[0].sum()) + int(v[1].sum()) * int(v[3].sum())
             for v in vecs]
    order = np.argsort(cells, kind="stable")

    def policy_op(v):
        for sign in (1, -1):
            inc._rank1_add(eng._ing_count, v[2], v[0], sign)
            inc._rank1_add(eng._eg_count, v[1], v[3], sign)

    d_row = rng.integers(-1, 2, n)
    d_col = d_row.copy()
    d_col[7] = 0  # the corner rides the row

    def relabel():
        for sign in (1, -1):
            for c in (eng._ing_count, eng._eg_count):
                inc._row_col_patch(c, 7, sign * d_row, sign * d_col)

    ing_iso, eg_iso = eng._iso_tensors()
    flags = dict(self_traffic=eng.config.self_traffic,
                 default_allow_unselected=eng.config.default_allow_unselected)
    mid, top = int(order[len(order) // 2]), int(order[-1])
    for name, fn, per in (
        (f"policy op, median policy ({cells[mid]} cells)", lambda: policy_op(vecs[mid]), 2),
        (f"policy op, largest policy ({cells[top]} cells)", lambda: policy_op(vecs[top]), 2),
        ("pod relabel (row + column of both matrices)", relabel, 2),
        ("_derive_reach", lambda: inc._derive_reach(
            eng._ing_count, eng._eg_count, ing_iso, eg_iso, **flags), 1),
    ):
        fn()
        print(f"device {name}: {cuda_ms(fn, reps=3) / per:.3f} ms; {smi}", flush=True)
    reach = inc._derive_reach(eng._ing_count, eng._eg_count, ing_iso, eg_iso, **flags)
    print(f"reach D2H copy ({reach.numel() / 1e9:.2f} GB): "
          f"{host_s(lambda: reach.cpu()) * 1e3:.1f} ms; {smi}", flush=True)
    return 0

def profile_any_port(cluster, donor, smi: str) -> int:
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch import packed_incremental as pi

    eng = kvt.PackedIncrementalVerifier(cluster)
    print("build: " + ", ".join(f"{k} {v:.2f} s" for k, v in eng.build_timings.items()),
          flush=True)
    rng = np.random.default_rng(5)

    # 1. host against device, per op kind
    parts = {}
    for i, p in enumerate(donor.policies[:8]):
        p = dataclasses.replace(p, name=f"prof-{i}")
        parts.setdefault("add_policy host", []).append(
            host_s(lambda: eng._vectorizer.vectors(p)))
        parts.setdefault("add_policy", []).append(host_s(lambda: eng.add_policy(p)))
    pols = list(eng.policies.values())
    for j in rng.choice(len(pols) - 8, 8, replace=False):
        q = dataclasses.replace(pols[j], ingress=pols[j + 1].ingress)
        parts.setdefault("update_policy host", []).append(host_s(
            lambda: (eng._vectorizer.vectors(pols[j]), eng._vectorizer.vectors(q))))
        parts.setdefault("update_policy", []).append(host_s(lambda: eng.update_policy(q)))
    for i in rng.choice(eng.active_indices(), 8, replace=False):
        pod = dataclasses.replace(eng.pods[int(i)], labels={"prof": "x"})
        parts.setdefault("update_pod_labels host", []).append(
            host_s(lambda: eng._pod_cols(pod)))
        parts.setdefault("update_pod_labels", []).append(
            host_s(lambda: eng.update_pod_labels(int(i), {"prof": "x"})))
    for name, xs in parts.items():
        print(f"op {name}: {med(xs)}", flush=True)

    # 2. the device steps alone
    flags = eng._flags
    rows = eng._put(np.sort(rng.choice(eng.n_pods, 512, replace=False)))
    cols = np.sort(rng.choice(eng.n_pods, 256, replace=False))
    meta = eng._col_meta(cols)
    zeros = eng._put(np.zeros((4, eng._capacity), dtype=np.int8))
    idx = int(eng.n_pods)  # a pad slot: occupied by an empty pod, then freed
    for name, fn in (
        ("_patch_rows 512 rows", lambda: pi._patch_rows(
            eng._packed, eng._maps, eng._col_mask, rows, **flags)),
        ("_patch_cols 256 cols", lambda: pi._patch_cols(
            eng._packed, eng._maps, eng._row_valid, *meta, **flags)),
        ("_pod_step occupy + tombstone", lambda: [pi._pod_step(
            eng._packed, eng._maps, eng._col_mask, eng._row_valid, idx, zeros,
            active, **flags) for active in (True, False)]),
        ("_rows_step 1024 rows", lambda: pi._rows_step(
            eng._maps, eng._col_mask, eng._row_valid, rows.repeat(2), **flags)),
    ):
        fn()
        print(f"device {name}: {cuda_ms(fn, reps=5):.2f} ms; {smi}", flush=True)

    # 3. state_dict
    for name, m in zip(("sel_ing", "sel_eg", "ing_by_pol", "eg_by_pol"), eng._maps):
        print(f"state_dict pack {name}: "
              f"{host_s(lambda: pi._pack_pod_axis(m).cpu()) * 1e3:.1f} ms", flush=True)
    print(f"state_dict words fetch: "
          f"{host_s(lambda: pi._host_words(eng._packed)) * 1e3:.1f} ms", flush=True)
    state = eng.state_dict()
    manifest = eng.as_cluster(include_inactive=True)

    # 4. from_state
    dev = eng.device
    copy_s = host_s(lambda: [
        dataclasses.replace(p, labels=dict(p.labels), container_ports=dict(p.container_ports))
        for p in manifest.pods
    ])
    print(f"from_state manifest copy: {copy_s * 1e3:.1f} ms", flush=True)
    for name in ("sel_ing", "sel_eg", "ing_by_pol", "eg_by_pol"):
        print(f"from_state unpack {name}: "
              f"{host_s(lambda: pi._unpack_pod_axis(state[name], eng._n_padded, dev)) * 1e3:.1f} ms",
              flush=True)
    print(f"from_state words upload: "
          f"{host_s(lambda: pi._words(state['packed'], dev)) * 1e3:.1f} ms", flush=True)
    t = host_s(lambda: kvt.PackedIncrementalVerifier.from_state(manifest, state))
    back = kvt.PackedIncrementalVerifier.from_state(manifest, state)
    print(f"from_state whole: {t:.2f} s (" + ", ".join(
        f"{k} {v:.2f} s" for k, v in back.build_timings.items()) + f"); {smi}", flush=True)
    return 0


def profile_ports(cluster, smi: str) -> int:
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch import packed_incremental as pi
    from kubernetes_verification_tpu_torch import packed_incremental_ports as pip
    from kubernetes_verification_tpu_torch.ops.kernels import fused_ports_reach
    from kubernetes_verification_tpu_torch.ops.tiled_ports import engine_fused_args

    t = host_s(lambda: kvt.PackedPortsIncrementalVerifier(cluster))
    eng = kvt.PackedPortsIncrementalVerifier(cluster)
    print(f"build: {t:.2f} s, second build " + ", ".join(
        f"{k} {v:.2f} s" for k, v in eng.build_timings.items())
        + f"; Np {eng._n_padded}, R {eng._layout.n_masks}, VP rows "
        f"{eng._total_rows}", flush=True)
    rng = np.random.default_rng(5)
    pols = list(eng.policies.values())

    # 1. host against device, per op kind; the adds and updates draw
    # policies whose rows fit the frozen universe and the free rows
    def fits(pol, recycled):
        try:
            _, _, gi, ge = eng._policy_groups(pol)
            eng._plan_alloc("i", gi, list(recycled.get("i", ())))
            eng._plan_alloc("e", ge, list(recycled.get("e", ())))
            return True
        except kvt.PortUniverseChanged:
            return False

    parts = {}
    order = iter(rng.permutation(len(pols)))
    while len(parts.get("add_policy", [])) < 8:
        p = dataclasses.replace(pols[next(order)], name=f"prof-{len(parts.get('add_policy', []))}")
        if not fits(p, {}):
            continue
        parts.setdefault("add_policy host", []).append(host_s(lambda: [
            eng._plan_alloc(d, g, []) for d, g in zip("ie", eng._policy_groups(p)[2:])]))
        parts.setdefault("add_policy", []).append(host_s(lambda: eng.add_policy(p)))
    while len(parts.get("update_policy", [])) < 8:
        old, src = pols[next(order)], pols[next(order)]
        q = dataclasses.replace(old, ingress=src.ingress)
        if not fits(q, eng._pol_rows[eng._key(old)]):
            continue
        parts.setdefault("update_policy host", []).append(host_s(
            lambda: (eng._policy_sel(old), eng._policy_groups(q))))
        parts.setdefault("update_policy", []).append(host_s(lambda: eng.update_policy(q)))
    for i in rng.choice(eng.active_indices(), 8, replace=False):
        pod = dataclasses.replace(eng.pods[int(i)], labels={"prof": "x"})
        parts.setdefault("update_pod_labels host", []).append(
            host_s(lambda: eng._pod_vp_cols(pod)))
        parts.setdefault("update_pod_labels", []).append(
            host_s(lambda: eng.update_pod_labels(int(i), {"prof": "x"})))
    for name, xs in parts.items():
        print(f"op {name}: {med(xs)}", flush=True)

    # 2. the device steps alone
    flags = dict(layout=eng._layout, **eng._flags)
    maps = (eng._src, eng._dst, eng._ing_cnt, eng._eg_cnt)
    rows = eng._put(np.sort(rng.choice(eng.n_pods, 256, replace=False)))
    meta = eng._col_meta(np.sort(rng.choice(eng.n_pods, 256, replace=False)))
    zi = eng._put(np.zeros((2, eng._total_rows["i"]), dtype=np.int8))
    ze = eng._put(np.zeros((2, eng._total_rows["e"]), dtype=np.int8))
    idx = int(eng.n_pods)  # a pad slot: occupied by an empty pod, then freed
    niso = [(~(c > 0)).to(torch.int32) for c in (eng._ing_cnt, eng._eg_cnt)]
    fargs = engine_fused_args(eng._layout, eng._src, eng._dst, *niso)
    for name, fn in (
        ("_ports_patch_rows 256 rows", lambda: pip._ports_patch_rows(
            eng._packed, *maps, eng._col_mask, eng._row_valid, rows, **flags)),
        ("_ports_patch_cols 256 cols", lambda: pip._ports_patch_cols(
            eng._packed, *maps, eng._row_valid, *meta, **flags)),
        ("_ports_pod_step occupy + tombstone", lambda: [pip._ports_pod_step(
            eng._packed, *maps, eng._col_mask, eng._row_valid, idx, zi, ze, 0, 0,
            active, **flags) for active in (True, False)]),
        ("engine_fused_args (the build's operand copy)", lambda: engine_fused_args(
            eng._layout, eng._src, eng._dst, *niso)),
        ("fused_ports_reach (the build's launch)", lambda: fused_ports_reach(
            *fargs, default_allow=eng.config.default_allow_unselected)),
    ):
        fn()
        print(f"device {name}: {cuda_ms(fn, reps=3):.2f} ms; {smi}", flush=True)
    del fargs

    # 3. state_dict
    for key, d, side in pip._MAP_KEYS:
        segs = (eng._dst if side else eng._src)[d]
        print(f"state_dict pack {key}: {host_s(lambda: [pi._pack_pod_axis(t).cpu() for t in segs]) * 1e3:.1f} ms",
              flush=True)
    print(f"state_dict words fetch: "
          f"{host_s(lambda: pi._host_words(eng._packed)) * 1e3:.1f} ms", flush=True)
    print(f"state_dict whole: {host_s(eng.state_dict):.2f} s", flush=True)
    arrays, meta = eng.state_dict()
    manifest = eng.as_cluster(include_inactive=True)

    # 4. from_state
    dev = eng.device
    for key, d, _ in pip._MAP_KEYS:
        packed = arrays[key]
        print(f"from_state unpack {key}: {host_s(lambda: [pi._unpack_pod_axis(packed[s:s + l], eng._n_padded, dev) for s, l in eng._seg_spans[d]]) * 1e3:.1f} ms",
              flush=True)
    print(f"from_state words upload: "
          f"{host_s(lambda: pi._words(arrays['packed'], dev)) * 1e3:.1f} ms", flush=True)
    t = host_s(lambda: kvt.PackedPortsIncrementalVerifier.from_state(manifest, arrays, meta))
    back = kvt.PackedPortsIncrementalVerifier.from_state(manifest, arrays, meta)
    print(f"from_state whole: {t:.2f} s (" + ", ".join(
        f"{k} {v:.2f} s" for k, v in back.build_timings.items()) + f"); {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
