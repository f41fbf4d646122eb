#!/usr/bin/env python3
"""Where one squaring pass of the port's packed closure, and the pair masks'
set build, spend their time on one NVIDIA GPU.

    python3 scripts/torch_profile_closure.py [--pods 100000 --policies 10000]

Builds the any-port main path of ``chip_smoke.py`` (``tiled_k8s_reach(
fetch=False)``), pads its words to the square ``[Np, Np/32]`` that
``PackedReach.closure`` closes, then:

1. times one whole ``_packed_square_step`` at the tiles ``packed_closure``
   snaps to (CUDA events), and each of its parts over the pass's full
   schedule: the dst-stripe unpacks, the row-tile unpacks, the int8
   products (``bool_dot`` = ``torch._int_mm``) and the pack of their counts;
   each part beside its bound (bytes or operations, whichever is larger);
2. traces one pass with ``torch.profiler``: device kernels by total device
   time, and the device's busy and idle share of the pass's wall time;
3. traces the pair masks' set build (``ops/tiled.py::_policy_sets``) and
   their two Grams the same way.

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

#: one H100 SXM at its 700 W limit (NVIDIA's data sheet)
INT8_OPS = 1979e12
BYTES_PER_S = 3.35e12


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


def bound_ms(ops: float = 0.0, nbytes: float = 0.0) -> str:
    t_ops, t_bytes = ops / INT8_OPS, nbytes / BYTES_PER_S
    return (f"{1e3 * max(t_ops, t_bytes):.2f} ms "
            f"({'operations' if t_ops >= t_bytes else 'bytes'})")


def trace(label: str, fn) -> None:
    """Device kernels of one ``fn()`` by total device time, and the idle
    share of its wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"{label} traced: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, "
          f"idle share {100 * (1 - busy_ms / wall_ms):.1f} %")
    for e in events[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.1f} ms  x{e.count:<5d} {e.key[:90]}")


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
    from kubernetes_verification_tpu_torch.ops.bits import (
        pack_bool_cols,
        unpack_words_i8,
        unpack_words_t_i8,
    )
    from kubernetes_verification_tpu_torch.ops.closure import (
        _fit_tile,
        _packed_square_step,
        bool_dot,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    enc = kvt.encode_cluster(kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=args.pods, n_policies=args.policies, n_namespaces=args.namespaces,
        p_ipblock_peer=0.0, min_selector_labels=1, seed=args.seed,
    )), compute_ports=False)
    reach = kvt.tiled_k8s_reach(enc, fetch=False)
    n, W = reach.packed.shape
    Np = W * 32
    packed = torch.nn.functional.pad(reach.packed, (0, 0, 0, Np - n))
    del reach
    t, dt = _fit_tile(Np, 7168), _fit_tile(Np, 14336)
    n_rt, n_st = Np // t, Np // dt
    print(f"Np {Np}, row tile {t}, dst stripe {dt}: {n_st} stripes x {n_rt} row "
          f"tiles = {n_st * n_rt} products per pass")

    step = lambda: _packed_square_step(packed, row_tile=t, dst_tile=dt)  # noqa: E731
    step()  # warm
    pass_ms = cuda_ms(step)
    print(f"pass: {pass_ms:.1f} ms; bound of its products "
          f"{bound_ms(ops=2.0 * n_st * n_rt * t * Np * dt)}")

    stripe = packed[:, : dt // 32]
    stripe_ms = cuda_ms(lambda: unpack_words_t_i8(stripe, dt), reps=3)
    print(f"  stripe unpack x{n_st}: {stripe_ms:.2f} ms each, {n_st * stripe_ms:.1f} "
          f"ms per pass; bound {bound_ms(nbytes=Np * dt / 8 + Np * dt)} each")
    rows = packed[:t]
    row_ms = cuda_ms(lambda: unpack_words_i8(rows, Np), reps=3)
    print(f"  row-tile unpack x{n_st * n_rt}: {row_ms:.2f} ms each, "
          f"{n_st * n_rt * row_ms:.1f} ms per pass; bound "
          f"{bound_ms(nbytes=t * Np / 8 + t * Np)} each")
    a, bt = unpack_words_i8(rows, Np), unpack_words_t_i8(stripe, dt)
    bool_dot(a, bt)  # warm
    dot_ms = cuda_ms(lambda: bool_dot(a, bt), reps=5)
    print(f"  product bool_dot [{t}, {Np}] x [{dt}, {Np}]^T x{n_st * n_rt}: "
          f"{dot_ms:.2f} ms each ({2 * t * Np * dt / dot_ms / 1e9:.0f} TOP/s), "
          f"{n_st * n_rt * dot_ms:.1f} ms per pass; bound "
          f"{bound_ms(ops=2.0 * t * Np * dt, nbytes=t * Np + dt * Np + 4 * t * dt)} each")
    counts = bool_dot(a, bt)
    out = torch.empty((t, dt // 32), dtype=torch.int32, device=packed.device)

    def pack():
        out.copy_(pack_bool_cols(counts > 0))

    pack_ms = cuda_ms(pack, reps=3)
    print(f"  pack of the counts x{n_st * n_rt}: {pack_ms:.2f} ms each, "
          f"{n_st * n_rt * pack_ms:.1f} ms per pass; bound "
          f"{bound_ms(nbytes=4 * t * dt + t * dt / 8)} each")
    parts = n_st * stripe_ms + n_st * n_rt * (row_ms + dot_ms + pack_ms)
    print(f"  parts summed {parts:.1f} ms of the {pass_ms:.1f} ms pass")
    del a, bt, counts, out
    torch.cuda.empty_cache()
    trace("pass", step)
    del packed
    torch.cuda.empty_cache()

    dev = torch.device("cuda")
    pa = tiled._put(tiled._pair_mask_args(enc, True, 2048, n_pad=0), dev)
    sets = tiled._policy_sets(pa, chunk=2048)  # warm
    del sets
    trace("pair-mask set build", lambda: tiled._policy_sets(pa, chunk=2048))
    src8, dst8 = tiled._policy_sets(pa, chunk=2048)
    trace("pair-mask Grams + masks", lambda: tiled._pair_masks_from_sets(src8, dst8))
    return 0


if __name__ == "__main__":
    sys.exit(main())
