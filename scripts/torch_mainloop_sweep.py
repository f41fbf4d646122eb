#!/usr/bin/env python3
"""The tile order and ring depth of the port's Hopper mainloop
(``csrc/hopper_int8.cuh``), swept on one NVIDIA GPU.

    python3 scripts/torch_mainloop_sweep.py [--n 102400 --p 10048 --kp 21376]
        [--variants 8x4,1x4,8x3,8x5]

Builds ``packed_dir_allow`` and ``fused_ports_reach`` once per variant
``GxS`` (``-DHOPPER_INT8_GROUP_M=G -DHOPPER_INT8_STAGES=S``; G = 1 is
row-major with the column tile fastest, the order without grouping) into the
gitignored ``_build/``, then times each build's kernels at the main paths'
shapes (CUDA events, mean of 3 after a warm-up) on random 0/1 operands, the
builds in turns (first to last, then back). The kernels' work does not depend
on the data. ``fused_ports_reach`` runs at R = 19 (one state word, the
192-column tile) and R = 30 (two words, 128 columns), with 2R + 2 segments
as on the main path (40 at R = 19) and with one segment over all of K' (one
flush per tile: the mainloop alone at that tile width). A variant whose ring does not fit in shared
memory is reported as refused. Beside
each time it prints the device-memory bytes the order reads under the L2
model of ``csrc/hopper_int8.cuh``: without grouping the ~132 tiles in flight
share one A row tile and read every B column tile of their row, so all of B
is read once per row tile, ``N/128 * N * K'`` bytes; with groups of G row
tiles, once per group, ``(N/128/G + 1) * N * K'`` bytes. The card's name and
power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H100_INT8_OPS = 1979e12
H100_BYTES_PER_S = 3.35e12


def build(variants):
    """``{(name, variant): CDLL}``: every kernel for every ``(G, S)``
    variant, one ``nvcc`` each, all at once."""
    from kubernetes_verification_tpu_torch.ops import cuda_build as cb

    os.makedirs(cb.BUILD_DIR, exist_ok=True)
    jobs = {}
    for name, src in cb.SOURCES.items():
        for g, st in variants:
            lib = os.path.join(cb.BUILD_DIR, f"lib{name}-g{g}s{st}.so")
            cmd = [cb._nvcc(), *cb._FLAGS, f"-DHOPPER_INT8_GROUP_M={g}",
                   f"-DHOPPER_INT8_STAGES={st}", "-o", lib, src]
            jobs[(name, (g, st))] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(lib)
    return libs


def cuda_ms(fn, reps=3):
    fn()  # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=102_400)
    ap.add_argument("--p", type=int, default=10_048, help="packed_dir_allow's P'")
    ap.add_argument("--kp", type=int, default=21_376, help="fused_ports_reach's K'")
    ap.add_argument("--variants", default="8x4,1x4,8x3,8x5",
                    help="GROUP_MxSTAGES builds, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    variants = [tuple(int(x) for x in v.split("x")) for v in args.variants.split(",")]
    libs = build(variants)
    dev = torch.device("cuda")
    n = args.n
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)

    def operands(k):
        return [(torch.rand((n, k), generator=gen, device=dev) < 0.05).to(torch.int8)
                for _ in range(2)]

    out = torch.empty((n, n // 32), dtype=torch.int32, device=dev)
    niso = (torch.rand(n, generator=gen, device=dev) < 0.5).to(torch.int32)

    # packed_dir_allow (axis 1: default-allow along columns)
    at, bt = operands(args.p)

    def dir_call(lib):
        fn = lib.packed_dir_allow_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        rc = fn(at.data_ptr(), bt.data_ptr(), niso.data_ptr(), out.data_ptr(),
                n, args.p, 1, stream)
        if rc:
            raise RuntimeError(f"launch refused: cudaError {rc}")

    rows = report("packed_dir_allow", libs, variants, dir_call, n, args.p,
                  2 * args.p * n * n)
    del at, bt
    torch.cuda.empty_cache()

    # fused_ports_reach: R ported masks
    at, bt = operands(args.kp)
    steps = args.kp // 64
    for r in (19, 30):
        kinds = [(0, m) for m in range(r)] + [(1, r)] + [(2, m) for m in range(r)] + [(3, r)]
        ends = [round((i + 1) * steps / len(kinds)) for i in range(len(kinds))]
        ov = torch.tensor([(1 << m) | (1 << r) for m in range(r)], dtype=torch.int64,
                          device=dev)
        # the main path's 2R + 2 segments, and one segment over all of K'
        # (one flush per tile: the mainloop at the kernel's tile width)
        for plan_rows in ([(e, k, s) for e, (k, s) in zip(ends, kinds)], [(steps, 3, r)]):
            plan = torch.tensor(plan_rows, dtype=torch.int32, device=dev)

            def fused_call(lib, plan=plan, ov=ov, r=r):
                fn = lib.fused_ports_reach_launch
                fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                rc = fn(at.data_ptr(), bt.data_ptr(), plan.data_ptr(), ov.data_ptr(),
                        niso.data_ptr(), niso.data_ptr(), out.data_ptr(),
                        n, args.kp, len(plan), r, 1, stream)
                if rc:
                    raise RuntimeError(f"launch refused: cudaError {rc}")

            rows += report(f"fused_ports_reach R={r} segments={len(plan_rows)}", libs,
                           variants, fused_call, n, args.kp, 2 * args.kp * n * n)
    for line in rows:
        print(line)
    return 0


def report(name, libs, variants, call, n, kp, ops):
    key = name.split()[0]
    times = {v: [] for v in variants}
    refused = {}
    for v in variants + variants[::-1]:
        if v in refused:
            continue
        try:
            times[v].append(cuda_ms(lambda: call(libs[(key, v)])))
        except RuntimeError as e:  # the ring does not fit in shared memory
            refused[v] = str(e)
    lines = []
    tiles_m = n // 128
    for g, st in variants:
        if (g, st) in refused:
            lines.append(f"{name} GROUP_M={g} STAGES={st}: {refused[(g, st)]}")
            continue
        t = times[(g, st)]
        ms = sum(t) / len(t)
        hbm = (tiles_m * n * kp) if g == 1 else (-(-tiles_m // g) + 1) * n * kp
        lines.append(
            f"{name} N={n} K'={kp} GROUP_M={g} STAGES={st}: {ms:.2f} ms "
            f"({', '.join(f'{x:.2f}' for x in t)}), {ops / ms / 1e9:.1f} TOP/s on K'; "
            f"L2 model: {hbm / 1e9:.1f} GB from device memory, "
            f"{1e3 * hbm / H100_BYTES_PER_S:.1f} ms at 3.35 TB/s; "
            f"compute bound on K' {1e3 * ops / H100_INT8_OPS:.1f} ms")
    return lines


if __name__ == "__main__":
    sys.exit(main())
