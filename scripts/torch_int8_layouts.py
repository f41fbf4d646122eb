#!/usr/bin/env python3
"""Time ``torch._int_mm`` (cuBLASLt's int8 GEMM) at the four operand layouts
of the PyTorch port's main-path product, on one NVIDIA GPU.

    python3 scripts/torch_int8_layouts.py [--n 102400] [--p 10048]

The port's kernel ``packed_dir_allow`` contracts two int8 [P, N] per-policy
maps over P. This script times the same [N, P] × [P, N] product through the
library with A row- or column-major and B row- or column-major, to show
which layout the int8 tensor cores take natively (the kernel reads its
operands in that layout). Prints milliseconds and TOP/s per layout, with the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import torch


def cuda_ms(fn, reps: int) -> float:
    fn()  # warm: allocates the int32 output
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=102_400)
    ap.add_argument("--p", type=int, default=10_048)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    n, p = args.n, args.p
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = (torch.rand((p, n), device="cuda", generator=gen) < 0.05).to(torch.int8)
    b = (torch.rand((p, n), device="cuda", generator=gen) < 0.05).to(torch.int8)
    at, bt = a.t().contiguous(), b.t().contiguous()  # K-contiguous copies
    ops = 2 * p * n * n
    layouts = (
        ("A row-major, B row-major", at, b),
        ("A row-major, B col-major", at, bt.t()),
        ("A col-major, B row-major", a.t(), b),
        ("A col-major, B col-major", a.t(), bt.t()),
    )
    for name, x, y in layouts:
        ms = cuda_ms(lambda: torch._int_mm(x, y), args.reps)
        print(f"N={n} P={p} {name}: {ms:.2f} ms, {ops / ms / 1e9:.0f} TOP/s",
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
