#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its hand-written
kernel against its plain PyTorch version.

    python3 chip_smoke.py

Phases; any failure exits non-zero before a result line is printed:

1. device probe: the card's name, and its name and power limit as
   ``nvidia-smi`` reports them (no CUDA device: exit 2);
2. build every kernel of ``kubernetes_verification_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) into the gitignored
   ``_build/``;
3. ``packed_dir_allow`` against ``packed_dir_allow_reference`` on the card,
   bit for bit, at small odd shapes and all three ``default_allow_axis``;
4. the main path at full width: ``random_cluster(100,000 pods, 10,000
   policies, 20 namespaces, seed 0)`` → ``encode_cluster(compute_ports=
   False)`` → ``tiled_k8s_reach(fetch=False)``. The launch counter is set to
   0 just before the first solve and read just after: the kernel must have
   run exactly twice. The packed words must equal the port's torch sweep
   (``use_kernel=False``) bit for bit;
5. the kernel at the main path's full shape, both directions, on the
   operands the solve hands it: bit for bit against the plain version, and
   its time (CUDA events) beside the plain version's, the bound, and one
   ``torch._int_mm`` call over the same int8 product as a yardstick (the port
   never calls it);
6. ``verify(backend="torch")`` on the card against the same call on the CPU
   (2,000 pods / 200 policies, ``compute_ports`` on and off), and the tiled
   kernel path against the dense solve on that cluster.

The second-to-last line is the kernel table as JSON; the last is
``{"ok": true, "device": {...}}``. Tolerance everywhere: exact (every output
is boolean or integer words).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

#: the published dense int8 tensor-core peak and memory rate of one H100 SXM
#: (NVIDIA's data sheet; at the full 700 W power limit)
H100_INT8_OPS = 1979e12
H100_BYTES_PER_S = 3.35e12

MAIN = dict(n_pods=100_000, n_policies=10_000, n_namespaces=20,
            p_ipblock_peer=0.0, min_selector_labels=1, seed=0)
VERIFY = dict(n_pods=2_000, n_policies=200, n_namespaces=10, seed=1)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bit_errors(got: torch.Tensor, want: torch.Tensor) -> int:
    """0 when the packed words agree bit for bit, else 1 (the largest
    absolute error of the boolean outputs)."""
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int(bool((got != want).any()))


def probe() -> tuple:
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind} (torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} visible)")
    log(smi)
    return kind, smi


def build() -> None:
    from kubernetes_verification_tpu_torch.ops.cuda_build import build_all

    t0 = time.perf_counter()
    built = build_all(verbose=True)
    for name, (secs, out) in built.items():
        log(f"build {name}: {secs:.1f} s")
        for line in out.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s ({len(built)} built)")


def kernel_small(dev) -> int:
    from kubernetes_verification_tpu_torch.ops.kernels import (
        packed_dir_allow,
        packed_dir_allow_reference,
    )

    gen = torch.Generator(device="cpu").manual_seed(0)
    worst = 0
    for p, n in ((77, 4096), (77, 8192), (1, 4096)):
        a = (torch.rand((p, n), generator=gen) < 0.05).to(torch.int8).to(dev)
        b = (torch.rand((p, n), generator=gen) < 0.05).to(torch.int8).to(dev)
        niso = (torch.rand(n, generator=gen) < 0.5).to(torch.int32)
        niso = niso[None, :].repeat(8, 1).to(dev)
        for axis in (1, 0, -1):
            got = packed_dir_allow(a, b, niso, default_allow_axis=axis)
            want = packed_dir_allow_reference(a, b, niso, default_allow_axis=axis)
            torch.cuda.synchronize()
            err = bit_errors(got, want)
            log(f"kernel vs plain P={p} N={n} axis={axis}: "
                f"{'equal' if not err else 'DIFFERENT'}")
            if err:
                fail(f"packed_dir_allow differs from its plain version at "
                     f"P={p} N={n} axis={axis}")
            worst = max(worst, err)
    return worst


def main_path(dev) -> tuple:
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.kernels import packed_dir_allow

    t0 = time.perf_counter()
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**MAIN))
    t1 = time.perf_counter()
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    t2 = time.perf_counter()
    del cluster
    log(f"main: generate {t1 - t0:.2f} s, encode {t2 - t1:.2f} s "
        f"({enc.n_pods} pods, {enc.n_policies} policies, "
        f"{enc.ingress.n}+{enc.egress.n} grants)")

    packed_dir_allow.launches = 0
    t3 = time.perf_counter()
    res = kvt.tiled_k8s_reach(enc, fetch=False, device=dev)
    first = time.perf_counter() - t3
    launches = packed_dir_allow.launches
    log(f"main: first solve {first:.3f} s, kernel {res.meta['kernel']}, "
        f"packed_dir_allow launches {launches}, "
        f"reachable_pairs {res.timings['reachable_pairs']}")
    if launches != 2:
        fail(f"the main path launched packed_dir_allow {launches} times, not 2")
    words = -(-enc.n_pods // 4096) * 4096 // 32  # N padded to the 4096 tile
    if tuple(res.packed.shape) != (enc.n_pods, words):
        fail(f"packed shape {tuple(res.packed.shape)}")

    steady = [
        cuda_ms(lambda: kvt.tiled_k8s_reach(enc, fetch=False, device=dev))
        for _ in range(3)
    ]
    log(f"main: steady solve median of 3 {statistics.median(steady):.1f} ms "
        f"({', '.join(f'{s:.1f}' for s in steady)})")

    t4 = time.perf_counter()
    sweep = kvt.tiled_k8s_reach(enc, fetch=False, device=dev, use_kernel=False)
    log(f"main: torch sweep (use_kernel=False) {time.perf_counter() - t4:.3f} s, "
        f"reachable_pairs {sweep.timings['reachable_pairs']}")
    if bit_errors(res.packed, sweep.packed):
        fail("the kernel path's packed words differ from the torch sweep's")
    if res.timings["reachable_pairs"] != sweep.timings["reachable_pairs"]:
        fail("reachable_pairs differ between the kernel path and the sweep")
    if not (res.ingress_isolated == sweep.ingress_isolated).all():
        fail("ingress isolation differs")
    log("main: kernel path == torch sweep, bit for bit")
    return enc, launches


def kernel_full(enc, dev, smi: str) -> list:
    """Both directions of the main path's kernel calls, timed."""
    from kubernetes_verification_tpu_torch.ops.kernels import (
        k_major,
        launch,
        packed_dir_allow,
        packed_dir_allow_reference,
    )
    from kubernetes_verification_tpu_torch.ops.tiled import kernel_operands

    ing_by_pol, sel_ing, sel_eg, eg_by_pol, niso_i, niso_e, _ = kernel_operands(
        enc, device=dev
    )
    rows = []
    for name, a, b, niso, axis in (
        ("ingress", ing_by_pol, sel_ing, niso_i, 1),
        ("egress", sel_eg, eg_by_pol, niso_e, 0),
    ):
        P, N = a.shape
        got = packed_dir_allow(a, b, niso, default_allow_axis=axis)
        want = None

        def plain():
            nonlocal want
            want = packed_dir_allow_reference(a, b, niso, default_allow_axis=axis)

        plain_ms = cuda_ms(plain)
        err = bit_errors(got, want)
        if err:
            fail(f"packed_dir_allow differs from its plain version at the full "
                 f"shape ({name}, P={P}, N={N})")
        del got, want
        # the wrapper as the solve calls it (its two K-contiguous copies
        # included), then the kernel alone on copies made beforehand
        wrapper_ms = cuda_ms(
            lambda: packed_dir_allow(a, b, niso, default_allow_axis=axis), reps=2
        )
        at, bt = k_major(a), k_major(b)
        ms = cuda_ms(lambda: launch(at, bt, niso, axis), reps=3)
        ops = 2 * P * N * N
        nbytes = 2 * P * N + niso.numel() * 4 + N * N // 8
        bound_ms = 1e3 * max(ops / H100_INT8_OPS, nbytes / H100_BYTES_PER_S)
        bound_by = "operations" if ops / H100_INT8_OPS >= nbytes / H100_BYTES_PER_S else "bytes"
        library_ms = None
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        if free > N * N * 4 + (4 << 30):
            # cuBLASLt's int8 GEMM at its fastest layout: A row-major, B
            # column-major, both K-contiguous (the kernel's own operands)
            torch._int_mm(at, bt.t())  # warm (allocates the [N, N] int32 counts)
            library_ms = cuda_ms(lambda: torch._int_mm(at, bt.t()))
        else:
            log(f"kernel {name}: library yardstick skipped, {free / 2**30:.1f} GiB free")
        del at, bt
        torch.cuda.empty_cache()
        log(f"kernel packed_dir_allow {name} P={P} N={N}: {ms:.2f} ms "
            f"(wrapper with its copies {wrapper_ms:.2f} ms), "
            f"plain {plain_ms:.1f} ms, bound {bound_ms:.2f} ms ({bound_by}), "
            f"torch._int_mm {library_ms if library_ms is None else f'{library_ms:.2f} ms'}, "
            f"{ops / ms / 1e9:.1f} TOP/s; {smi}")
        rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms, err=err))
    return rows


def verify_phase(dev) -> None:
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt

    cluster = kvt.random_cluster(kvt.GeneratorConfig(**VERIFY))
    fields = ("reach", "reach_ports", "src_sets", "dst_sets", "selected",
              "ingress_isolated", "egress_isolated")
    for compute_ports in (True, False):
        runs = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            runs[device] = kvt.verify(cluster, kvt.VerifyConfig(
                backend="torch", compute_ports=compute_ports,
                backend_options=(("device", device),),
            ))
            log(f"verify compute_ports={compute_ports} on {device}: "
                f"{time.perf_counter() - t0:.2f} s")
        for f in fields:
            g, w = getattr(runs["cuda"], f), getattr(runs["cpu"], f)
            if (g is None) != (w is None) or (g is not None and not np.array_equal(g, w)):
                fail(f"verify: {f} differs between cuda and cpu "
                     f"(compute_ports={compute_ports})")
        log(f"verify compute_ports={compute_ports}: cuda == cpu on every array, "
            f"{int(runs['cuda'].reach.sum())} reachable pairs")
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    tiled = kvt.tiled_k8s_reach(enc, device=dev)
    if tiled.meta["kernel"] != "packed_dir_allow":
        fail("the tiled solve on the card did not take the kernel")
    if not np.array_equal(tiled.to_bool(), runs["cuda"].reach):
        fail("tiled kernel path differs from the dense solve")
    log("verify: tiled kernel path == dense solve on the card")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    kind, smi = probe()
    build()
    worst = kernel_small(dev)
    enc, launches = main_path(dev)
    torch.cuda.empty_cache()
    rows = kernel_full(enc, dev, smi)
    del enc
    torch.cuda.empty_cache()
    verify_phase(dev)
    worst = max([worst] + [r["err"] for r in rows])

    def mean(key):
        vals = [r[key] for r in rows]
        return None if any(v is None for v in vals) else sum(vals) / len(vals)

    table = {"kernels": [{
        "name": "packed_dir_allow",
        "route": "cuda",
        "source": "kubernetes_verification_tpu_torch/csrc/packed_dir_allow.cu",
        "replaces": "kubernetes_verification_tpu/ops/pallas_kernels.py:151",
        "launches": launches,
        "max_abs_err": worst,
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": rows[0]["bound_by"],
        "library_ms": mean("library_ms"),
    }]}
    log(f"total: {time.perf_counter() - t0:.1f} s; per-launch means of the "
        f"two directions below; {smi}")
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
