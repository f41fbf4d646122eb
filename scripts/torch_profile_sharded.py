#!/usr/bin/env python3
"""Where one sharded packed solve of the PyTorch port spends its time, at
world size 1 over NCCL on one NVIDIA GPU.

    python3 scripts/torch_profile_sharded.py [--pods 100000 --policies 10000] [--ports]

Generates and encodes the main-path cluster of ``chip_smoke.py`` (with
``--ports``: ``compute_ports=True``, the port-bitmap sweep), joins a 1-rank
job (``mesh_for()``), warms the solve once, then:

1. runs ``sharded_packed_reach(keep_matrix=True)`` at each dst tile of
   ``--tiles`` and prints its split (``timings``: host prologue, the
   rank's maps, the dst-tile sweep, the fetch of the results to the host,
   each ended by a synchronise);
2. traces one solve at the first tile with ``torch.profiler`` and prints the
   device kernels by total device time, and the device's busy and idle
   share of the call's wall time.

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
    ap.add_argument("--ports", action="store_true")
    ap.add_argument("--tiles", default=None,
                    help="comma-separated dst tiles (default 1024,512,2048; ports 512,256)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_sharded: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip(), flush=True)

    import torch.distributed as dist

    import kubernetes_verification_tpu_torch as kvt

    tiles = [int(t) for t in (args.tiles or ("512,256" if args.ports else "1024,512,2048"))
             .split(",")]
    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=args.pods, n_policies=args.policies, n_namespaces=20,
        p_ipblock_peer=0.0, min_selector_labels=1, seed=0,
    ))
    enc = kvt.encode_cluster(cluster, compute_ports=args.ports)
    mesh = kvt.mesh_for()
    print(f"{mesh}; ports={args.ports}", flush=True)

    def solve(tile):
        return kvt.sharded_packed_reach(mesh, enc, tile=tile, keep_matrix=True)

    solve(tiles[0])  # warm: cuBLAS, NCCL and the allocator
    for tile in tiles:
        torch.cuda.synchronize()
        t = time.perf_counter()
        pk = solve(tile)
        wall = time.perf_counter() - t
        split = ", ".join(f"{k} {pk.timings[k]:.3f}" for k in ("prologue", "maps", "sweep", "fetch"))
        print(f"tile {tile}: {wall:.3f} s ({pk.timings['tiles']} tiles; {split} s), "
              f"{pk.total_pairs} pairs", flush=True)
        del pk
        torch.cuda.empty_cache()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        solve(tiles[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # device-side events only: kernels and copies (CPU ops would count
    # their kernels' time a second time)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"traced solve (tile {tiles[0]}): wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share {100 * (1 - busy_us / 1e3 / (wall * 1e3)):.1f} %")
    for e in events[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.1f} ms  x{e.count:<5d} {e.key[:90]}")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
