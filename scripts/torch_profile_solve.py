#!/usr/bin/env python3
"""Where one steady solve of the PyTorch port spends its time, on one
NVIDIA GPU.

    python3 scripts/torch_profile_solve.py [--pods 100000 --policies 10000] [--ports]

Generates and encodes the main-path cluster of ``chip_smoke.py`` (with
``--ports``: ``compute_ports=True``, the port-bitmap path), warms the solve
once, then:

1. runs the layers of ``tiled_k8s_reach`` one by one, each ended by a
   synchronise, on the host clock. Any-port: padding + transfer, selector
   match, peer maps, the two ``packed_dir_allow`` launches with their AND
   and diagonal, ``col_mask``, and the pair count. ``--ports``: the host
   prologue (run-split, VP layout, padding) + transfer, selector match, the
   VP peer maps, the gathers + bank gating + K-contiguous operand build, the
   ``fused_ports_reach`` launch, diagonal + ``col_mask``, and the pair count;
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
    ap.add_argument("--ports", action="store_true",
                    help="the port-bitmap path (compute_ports=True)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import kubernetes_verification_tpu_torch as kvt

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    dev = torch.device("cuda")
    enc = kvt.encode_cluster(kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=args.pods, n_policies=args.policies, n_namespaces=args.namespaces,
        p_ipblock_peer=0.0, min_selector_labels=1, seed=args.seed,
    )), compute_ports=args.ports)
    kvt.tiled_k8s_reach(enc, fetch=False)  # warm: build, allocator growth

    def stamp(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    if args.ports:
        layers = port_layers(enc, dev, stamp)
    else:
        layers = any_port_layers(enc, dev, stamp)
    whole = sum(secs for _, secs in layers[:-1])
    for name, secs in layers[:-1]:
        print(f"layer {name}: {secs * 1e3:.1f} ms ({100 * secs / whole:.1f} %)")
    print(f"layers summed: {whole * 1e3:.1f} ms, reachable_pairs {layers[-1][1]}")
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


def port_layers(enc, dev, stamp) -> list:
    """``(name, seconds)`` per layer of one port-bitmap solve, the pair count
    last."""
    from kubernetes_verification_tpu_torch.ops import tiled, tiled_ports
    from kubernetes_verification_tpu_torch.ops.bits import or_diagonal
    from kubernetes_verification_tpu_torch.ops.closure import packed_pair_total
    from kubernetes_verification_tpu_torch.ops.kernels import fused_ports_reach

    t = time.perf_counter()
    pro = tiled_ports._prologue(enc, tile=4096, chunk=2048, use_kernel=True)
    d_host = stamp(t)
    t = time.perf_counter()
    a, vp = tiled._put(pro.host, dev), tiled._put(pro.vp, dev)
    d_put = stamp(t)
    t = time.perf_counter()
    tiled._select_maps(a, True)
    d_select = stamp(t)
    t = time.perf_counter()
    maps = tiled_ports._vp_maps(a, vp, chunk=2048, direction_aware_isolation=True)
    d_maps = stamp(t) - d_select  # _vp_maps re-runs the selection
    _, sel_ing_ext, sel_eg_ext, ing_iso, eg_iso, vp_peers_i, vp_peers_e = maps
    del maps
    t = time.perf_counter()
    at, bt, plan = tiled_ports._fused_operands(
        pro.layout, sel_ing_ext, sel_eg_ext, vp_peers_i, vp_peers_e, vp
    )
    ov = tiled_ports._overlap_table(pro.layout, dev)
    niso_i, niso_e = (~ing_iso).to(torch.int32), (~eg_iso).to(torch.int32)
    d_operands = stamp(t)
    del sel_ing_ext, sel_eg_ext, vp_peers_i, vp_peers_e
    t = time.perf_counter()
    out = fused_ports_reach(at, bt, plan, ov, niso_i, niso_e, default_allow=True)
    d_kernel = stamp(t)
    t = time.perf_counter()
    or_diagonal(out)
    out &= a.col_mask[None, :]
    d_mask = stamp(t)
    t = time.perf_counter()
    total = packed_pair_total(out[: enc.n_pods])
    d_count = stamp(t)
    return [
        ("host prologue (run-split, VP layout, padding)", d_host),
        ("transfer", d_put), ("selector match", d_select),
        ("VP peer maps", d_maps),
        ("gathers + bank gating + K-contiguous operands", d_operands),
        ("fused_ports_reach", d_kernel), ("diagonal + col_mask", d_mask),
        ("pair count (popcount)", d_count), ("reachable_pairs", total),
    ]


def any_port_layers(enc, dev, stamp) -> list:
    """``(name, seconds)`` per layer of one any-port solve, the pair count
    last."""
    from kubernetes_verification_tpu_torch.ops import tiled
    from kubernetes_verification_tpu_torch.ops.closure import packed_pair_total
    from kubernetes_verification_tpu_torch.ops.kernels import packed_reach

    t = time.perf_counter()
    a = tiled._device_args(enc, 4096, 2048, dev)
    d_args = stamp(t)
    t = time.perf_counter()
    maps = tiled._select_maps(a, True)
    d_select = stamp(t)
    t = time.perf_counter()
    _, sel_ing8, sel_eg8, ing_iso, eg_iso, ing_by_pol, eg_by_pol = tiled._policy_maps(
        a, chunk=2048, direction_aware_isolation=True
    )
    d_maps = stamp(t) - d_select  # _policy_maps re-runs the selection
    del maps
    t = time.perf_counter()
    out = packed_reach(
        ing_by_pol, sel_ing8, sel_eg8, eg_by_pol,
        tiled._not_iso(ing_iso), tiled._not_iso(eg_iso),
    )
    out &= a.col_mask[None, :]
    d_kernels = stamp(t)
    t = time.perf_counter()
    total = packed_pair_total(out[: enc.n_pods])
    d_count = stamp(t)
    return [
        ("padding + transfer", d_args), ("selector match", d_select),
        ("peer maps", d_maps), ("2 kernels + AND + diagonal + col_mask", d_kernels),
        ("pair count (popcount)", d_count), ("reachable_pairs", total),
    ]


if __name__ == "__main__":
    sys.exit(main())
