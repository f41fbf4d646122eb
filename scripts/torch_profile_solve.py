#!/usr/bin/env python3
"""Where one steady any-port solve of the PyTorch port spends its time, on
one NVIDIA GPU.

    python3 scripts/torch_profile_solve.py [--pods 100000 --policies 10000]

Generates and encodes the main-path cluster of ``chip_smoke.py``, warms the
solve once, then:

1. runs the layers of ``tiled_k8s_reach`` one by one, each ended by a
   synchronise, on the host clock: padding + transfer, selector match,
   peer maps, the two ``packed_dir_allow`` launches with their AND and
   diagonal, ``col_mask``, and the pair count;
2. traces one whole ``tiled_k8s_reach(fetch=False)`` with ``torch.profiler``
   and prints the device kernels by total device time, and the device's busy
   and idle share of the call's wall time.

Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pods", type=int, default=100_000)
    ap.add_argument("--policies", type=int, default=10_000)
    ap.add_argument("--namespaces", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops import tiled
    from kubernetes_verification_tpu_torch.ops.closure import packed_pair_total
    from kubernetes_verification_tpu_torch.ops.kernels import packed_reach

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    dev = torch.device("cuda")
    enc = kvt.encode_cluster(kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=args.pods, n_policies=args.policies, n_namespaces=args.namespaces,
        p_ipblock_peer=0.0, min_selector_labels=1, seed=args.seed,
    )), compute_ports=False)
    kvt.tiled_k8s_reach(enc, fetch=False)  # warm: build, allocator growth

    def stamp(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    t = time.perf_counter()
    *inputs, col_mask = tiled._device_args(enc, 4096, 2048, dev)
    d_args = stamp(t)
    t = time.perf_counter()
    maps = tiled._select_maps(*inputs[:3], *inputs[5:9], True)
    d_select = stamp(t)
    t = time.perf_counter()
    _, sel_ing8, sel_eg8, ing_iso, eg_iso, ing_by_pol, eg_by_pol = tiled._policy_maps(
        *inputs, chunk=2048, direction_aware_isolation=True
    )
    d_maps = stamp(t) - d_select  # _policy_maps re-runs the selection
    del maps
    t = time.perf_counter()
    out = packed_reach(
        ing_by_pol, sel_ing8, sel_eg8, eg_by_pol,
        tiled._not_iso(ing_iso), tiled._not_iso(eg_iso),
    )
    out &= col_mask[None, :]
    d_kernels = stamp(t)
    t = time.perf_counter()
    total = packed_pair_total(out[: enc.n_pods])
    d_count = stamp(t)
    whole = d_args + d_select + d_maps + d_kernels + d_count
    for name, secs in (
        ("padding + transfer", d_args), ("selector match", d_select),
        ("peer maps", d_maps), ("2 kernels + AND + diagonal + col_mask", d_kernels),
        ("pair count (popcount)", d_count),
    ):
        print(f"layer {name}: {secs * 1e3:.1f} ms ({100 * secs / whole:.1f} %)")
    print(f"layers summed: {whole * 1e3:.1f} ms, reachable_pairs {total}")
    del out, sel_ing8, sel_eg8, ing_by_pol, eg_by_pol, inputs
    torch.cuda.empty_cache()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        kvt.tiled_k8s_reach(enc, fetch=False)
        wall = stamp(t)
    # device-side events only: kernels and copies (CPU ops would count
    # their kernels' time a second time)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"traced solve: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share {100 * (1 - busy_us / 1e3 / (wall * 1e3)):.1f} %")
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.1f} ms  x{e.count:<5d} {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
