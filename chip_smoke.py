#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its hand-written
kernels against their plain PyTorch versions.

    python3 chip_smoke.py

Phases; any failure exits non-zero before a result line is printed:

1. device probe: the card's name, and its name and power limit as
   ``nvidia-smi`` reports them (no CUDA device: exit 2);
2. build every kernel of ``kubernetes_verification_tpu_torch/csrc`` with
   ``nvcc`` (one process per source, all at once) into the gitignored
   ``_build/``, printing each instantiation's registers and spills as
   ``ptxas`` reports them and each launch's dynamic shared memory;
3. each kernel against its plain version on the card, bit for bit, at small
   odd shapes and at the edges of the Hopper mainloop (one tile smaller than
   a raster group, N not a multiple of the wide tile, more row tiles than a
   group, K' = 64 and other K' ending half-way through a 128-byte stage):
   ``packed_dir_allow`` at all three ``default_allow_axis``;
   ``fused_ports_reach`` at R = 0, 1, 19, 29, 30 and its limit 61,
   ``default_allow`` on and off, a direction with no grants, none at all,
   segment lengths that are not multiples of the K step, and segments that
   end half-way through a stage;
4. the any-port main path at full width: ``random_cluster(100,000 pods,
   10,000 policies, 20 namespaces, seed 0)`` → ``encode_cluster(
   compute_ports=False)`` → ``tiled_k8s_reach(fetch=False)``. Both launch
   counters are set to 0 just before the first solve and read just after:
   ``packed_dir_allow`` must have run exactly twice, ``fused_ports_reach``
   never. The packed words must equal the port's torch sweep
   (``use_kernel=False``) bit for bit;
5. ``packed_dir_allow`` at that path's full shape, both directions, on the
   operands the solve hands it: bit for bit against the plain version, and
   its time (CUDA events) beside the plain version's, the bound, and one
   ``torch._int_mm`` call over the same int8 product as a yardstick (the port
   never calls it);
6. the port-bitmap main path at full width: the same cluster →
   ``encode_cluster(compute_ports=True)`` → ``tiled_k8s_reach(fetch=
   False)``; counters as in 4: ``fused_ports_reach`` exactly once,
   ``packed_dir_allow`` never. The words must equal the torch mask-group
   sweep's bit for bit, with the same ``reachable_pairs``;
7. ``fused_ports_reach`` at that path's full shape on the operands the solve
   hands it: bit for bit against the plain version, its time beside the
   plain version's, the bound and ``torch._int_mm`` over the same
   K-contiguous product (GEMM only: no PyTorch call computes the fused
   function);
8. ``verify(backend="torch")`` on the card against the same call on the CPU
   (2,000 pods / 200 policies, ``compute_ports`` on and off), and both tiled
   kernel paths against the dense solve on that cluster.

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
    """Build both kernels at once and print, per kernel instantiation, what
    ``ptxas`` reports (registers, spills, static shared memory) and the
    dynamic shared memory each launch asks for."""
    from kubernetes_verification_tpu_torch.ops.cuda_build import build_all, load_library

    t0 = time.perf_counter()
    built = build_all(verbose=True)
    for name, (secs, out) in built.items():
        log(f"build {name}: {secs:.1f} s")
        for line in out.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "smem", "spill")):
                log(f"  ptxas: {line.strip()}")
    log(f"build: {time.perf_counter() - t0:.1f} s ({len(built)} built)")
    smem = load_library("packed_dir_allow").packed_dir_allow_smem_bytes()
    log(f"  packed_dir_allow: {smem} bytes of dynamic shared memory per block")
    for w in (1, 2):
        smem = load_library("fused_ports_reach").fused_ports_reach_smem_bytes(w)
        log(f"  fused_ports_reach W={w}: {smem} bytes of dynamic shared memory per block")


def kernel_small(dev) -> int:
    from kubernetes_verification_tpu_torch.ops.kernels import (
        packed_dir_allow,
        packed_dir_allow_reference,
    )

    gen = torch.Generator(device="cpu").manual_seed(0)
    worst = 0
    # the redesign's edges: one tile smaller than a raster group (N = 128,
    # K' = 64: half a 128-byte stage), N not a multiple of the 256-column
    # tile (384), more row tiles than a group with a ragged last column tile
    # (1,152), a K' ending half-way through a stage (77 -> 128 is whole;
    # 200 -> 256 whole; 130 -> 192 half)
    for p, n in ((77, 4096), (77, 8192), (1, 4096), (64, 128), (77, 384),
                 (130, 1152), (200, 1152)):
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


def fused_operands(rng, n: int, r: int, lengths: dict, dev) -> tuple:
    """K-contiguous operands of ``fused_ports_reach`` over the segments
    ``lengths`` maps ``(kind, slab)`` to, in the solve's K order (egress
    masks, egress full, ingress masks, ingress full), each padded to the K
    step with zero columns; each segment's density keeps its ``count > 0``
    near 3 % of the elements. No segments: one inert zero step."""
    from kubernetes_verification_tpu_torch.ops.kernels import K_STEP

    segs = sorted(lengths.items(), key=lambda kv: (kv[0][0], kv[0][1]))
    kp = sum(l + (-l) % K_STEP for _, l in segs) or K_STEP
    at = torch.zeros((n, kp), dtype=torch.int8)
    bt = torch.zeros((n, kp), dtype=torch.int8)
    plan, off = [], 0
    for (kind, slab), l in segs:
        p = (0.03 / l) ** 0.5
        at[:, off:off + l] = torch.as_tensor(rng.random((n, l)) < p)
        bt[:, off:off + l] = torch.as_tensor(rng.random((n, l)) < p)
        off += l + (-l) % K_STEP
        plan.append((off // K_STEP, kind, slab))
    masks = rng.random((r, 8)) < 0.25
    ov = [sum(1 << int(j) for j in (masks[m] & masks).any(1).nonzero()[0]) | (1 << r)
          for m in range(r)]
    niso = [torch.as_tensor((rng.random(n) < 0.5).astype("int32")) for _ in range(2)]
    return tuple(x.to(dev) for x in (
        at, bt, torch.tensor(plan or [(1, 1, r)], dtype=torch.int32),
        torch.tensor(ov, dtype=torch.int64), *niso,
    ))


def fused_small(dev) -> int:
    import numpy as np

    from kubernetes_verification_tpu_torch.ops.kernels import (
        FUSED_MAX_MASKS,
        fused_ports_reach,
        fused_ports_reach_reference,
    )

    rng = np.random.default_rng(0)
    cases = []
    for n, r in ((384, 0), (256, 1), (512, 19), (256, FUSED_MAX_MASKS)):
        lengths = {(0, m): int(rng.integers(1, 200)) for m in range(r)}
        lengths[(1, r)] = int(rng.integers(1, 200))
        lengths.update({(2, m): int(rng.integers(1, 200)) for m in range(r)})
        lengths[(3, r)] = int(rng.integers(1, 200))
        cases.append((f"R={r}", n, r, lengths))
    # the W switch (R = 29: one state word, R = 30: two), segments that
    # all end on 64-column steps, so every other flush falls half-way
    # through a 128-byte stage, more row tiles than a raster group, and a
    # single segment inside half a stage (K' = 64)
    for n, r in ((256, 29), (384, 30)):
        lengths = {(0, m): int(rng.integers(1, 120)) for m in range(r)}
        lengths[(1, r)] = int(rng.integers(1, 120))
        lengths.update({(2, m): int(rng.integers(1, 120)) for m in range(r)})
        lengths[(3, r)] = int(rng.integers(1, 120))
        cases.append((f"R={r}", n, r, lengths))
    short = {(0, m): int(rng.integers(1, 65)) for m in range(5)}
    short[(1, 5)] = 64
    short.update({(2, m): int(rng.integers(1, 65)) for m in range(5)})
    short[(3, 5)] = 33
    cases.append(("mid-stage flushes", 384, 5, short))
    cases.append(("9 row tiles", 1152, 3,
                  {(0, 0): 100, (0, 2): 64, (1, 3): 7, (2, 1): 65, (3, 3): 90}))
    cases.append(("one segment, K'=64", 128, 2, {(3, 2): 40}))
    cases.append(("no egress grants", 256, 3,
                  {(2, 0): 70, (2, 2): 129, (3, 3): 5}))
    cases.append(("no ingress grants", 256, 2, {(0, 0): 64, (0, 1): 1, (1, 2): 300}))
    cases.append(("no grants", 128, 0, {}))
    worst = 0
    for name, n, r, lengths in cases:
        ops = fused_operands(rng, n, r, lengths, dev)
        for da in (True, False):
            got = fused_ports_reach(*ops, default_allow=da)
            want = fused_ports_reach_reference(*ops, default_allow=da)
            torch.cuda.synchronize()
            err = bit_errors(got, want)
            log(f"fused_ports_reach vs plain {name} N={n} K'={ops[0].shape[1]} "
                f"default_allow={da}: {'equal' if not err else 'DIFFERENT'}")
            if err:
                fail(f"fused_ports_reach differs from its plain version ({name}, "
                     f"default_allow={da})")
            worst = max(worst, err)
    # a plan the kernel cannot walk (here: one that ends short of K') is
    # refused on the card before any launch
    from kubernetes_verification_tpu_torch.resilience.errors import ConfigError

    at, bt, plan, *rest = fused_operands(rng, 256, 2, {(1, 2): 70, (3, 2): 90}, dev)
    before = fused_ports_reach.launches
    try:
        fused_ports_reach(at, bt, plan[:1].contiguous(), *rest, default_allow=True)
        fail("fused_ports_reach launched on a plan that ends short of K'")
    except ConfigError as e:
        log(f"fused_ports_reach refuses a short plan on the card: {e}")
    if fused_ports_reach.launches != before:
        fail("fused_ports_reach counted a launch for a refused plan")
    return worst


def launch_counts() -> tuple:
    from kubernetes_verification_tpu_torch.ops.kernels import (
        fused_ports_reach,
        packed_dir_allow,
    )

    return packed_dir_allow.launches, fused_ports_reach.launches


def reset_counts() -> None:
    from kubernetes_verification_tpu_torch.ops.kernels import (
        fused_ports_reach,
        packed_dir_allow,
    )

    packed_dir_allow.launches = 0
    fused_ports_reach.launches = 0


def encode_main(cluster, compute_ports: bool):
    import kubernetes_verification_tpu_torch as kvt

    t0 = time.perf_counter()
    enc = kvt.encode_cluster(cluster, compute_ports=compute_ports)
    log(f"encode compute_ports={compute_ports}: {time.perf_counter() - t0:.2f} s "
        f"({enc.n_pods} pods, {enc.n_policies} policies, {len(enc.atoms)} port "
        f"atoms, {enc.ingress.n}+{enc.egress.n} grants)")
    return enc


def main_path(enc, dev) -> int:
    import kubernetes_verification_tpu_torch as kvt

    reset_counts()
    t3 = time.perf_counter()
    res = kvt.tiled_k8s_reach(enc, fetch=False, device=dev)
    first = time.perf_counter() - t3
    launches, fused = launch_counts()
    log(f"main: first solve {first:.3f} s, kernel {res.meta['kernel']}, "
        f"packed_dir_allow launches {launches}, fused_ports_reach launches "
        f"{fused}, reachable_pairs {res.timings['reachable_pairs']}")
    if launches != 2 or fused != 0:
        fail(f"the any-port path launched packed_dir_allow {launches} times "
             f"and fused_ports_reach {fused} times, not 2 and 0")
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
    return launches


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


def ports_path(enc, dev) -> int:
    """The port-bitmap path at full width: one launch of fused_ports_reach,
    and the same words as the torch mask-group sweep."""
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.tiled_ports import port_layout_stats

    t0 = time.perf_counter()
    stats = port_layout_stats(enc)
    log(f"ports: layout {time.perf_counter() - t0:.2f} s on the host: "
        + ", ".join(f"{k} {v}" for k, v in stats.items()))
    torch.cuda.empty_cache()
    reset_counts()
    t1 = time.perf_counter()
    res = kvt.tiled_k8s_reach(enc, fetch=False, device=dev)
    first = time.perf_counter() - t1
    launches, fused = launch_counts()
    log(f"ports: first solve {first:.3f} s, kernel {res.meta['kernel']}, "
        f"fused_ports_reach launches {fused}, packed_dir_allow launches "
        f"{launches}, reachable_pairs {res.timings['reachable_pairs']}, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if fused != 1 or launches != 0:
        fail(f"the port path launched fused_ports_reach {fused} times and "
             f"packed_dir_allow {launches} times, not 1 and 0")
    steady = [
        cuda_ms(lambda: kvt.tiled_k8s_reach(enc, fetch=False, device=dev))
        for _ in range(3)
    ]
    log(f"ports: steady solve median of 3 {statistics.median(steady):.1f} ms "
        f"({', '.join(f'{s:.1f}' for s in steady)})")

    t2 = time.perf_counter()
    sweep = kvt.tiled_k8s_reach(enc, fetch=False, device=dev, use_kernel=False)
    log(f"ports: torch mask-group sweep (use_kernel=False) "
        f"{time.perf_counter() - t2:.3f} s, reachable_pairs "
        f"{sweep.timings['reachable_pairs']}, words {tuple(sweep.packed.shape)} "
        f"(kernel route {tuple(res.packed.shape)})")
    w = -(-enc.n_pods // 32)  # the routes pad N differently: the real words
    if bit_errors(res.packed[:, :w], sweep.packed[:, :w]):
        fail("the port path's kernel words differ from the torch sweep's")
    if res.packed[:, w:].any() or sweep.packed[:, w:].any():
        fail("a pad word of the port path is not zero")
    if res.timings["reachable_pairs"] != sweep.timings["reachable_pairs"]:
        fail("reachable_pairs differ between the port kernel path and the sweep")
    if not ((res.ingress_isolated == sweep.ingress_isolated).all()
            and (res.egress_isolated == sweep.egress_isolated).all()):
        fail("isolation differs between the port routes")
    log("ports: kernel path == torch mask-group sweep, bit for bit")
    return fused


def fused_full(enc, dev, smi: str) -> dict:
    """fused_ports_reach on the operands the port path hands it, timed."""
    from kubernetes_verification_tpu_torch.ops.kernels import (
        fused_ports_reach,
        fused_ports_reach_reference,
    )
    from kubernetes_verification_tpu_torch.ops.tiled_ports import port_kernel_operands

    ops = port_kernel_operands(enc, device=dev)
    at, bt, plan, ov, niso_i, niso_e = ops.args
    N, kp = at.shape
    K = ops.stats["K"]  # the real VP rows: the segments' sink pad rows are zero

    def kernel():
        return fused_ports_reach(at, bt, plan, ov, niso_i, niso_e, default_allow=True)

    got = kernel()
    want = None

    def plain():
        nonlocal want
        want = fused_ports_reach_reference(
            at, bt, plan, ov, niso_i, niso_e, default_allow=True
        )

    plain_ms = cuda_ms(plain)
    err = bit_errors(got, want)
    if err:
        fail(f"fused_ports_reach differs from its plain version at the full "
             f"shape (N={N}, K'={kp}, R={ov.shape[0]})")
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_ms(kernel, reps=3)
    ops_n = 2 * K * N * N
    nbytes = 2 * N * kp + plan.numel() * 4 + ov.numel() * 8 + 2 * N * 4 + N * N // 8
    t_ops, t_bytes = ops_n / H100_INT8_OPS, nbytes / H100_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    library_ms = None
    free, _ = torch.cuda.mem_get_info()
    if free > N * N * 4 + (4 << 30):
        # cuBLASLt's int8 GEMM over the same K-contiguous product: GEMM only,
        # no PyTorch call computes the fused segment flushes
        torch._int_mm(at, bt.t())
        library_ms = cuda_ms(lambda: torch._int_mm(at, bt.t()))
    else:
        log(f"fused_ports_reach: library yardstick skipped, {free / 2**30:.1f} GiB free")
    log(f"kernel fused_ports_reach N={N} K={K} (with the sink pad rows "
        f"{ops.stats['K_layout']}) K'={kp} R={ov.shape[0]} "
        f"segments={plan.shape[0]}: {ms:.2f} ms, plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.2f} ms ({bound_by}), torch._int_mm (GEMM only) "
        f"{library_ms if library_ms is None else f'{library_ms:.2f} ms'}, "
        f"{ops_n / ms / 1e9:.1f} TOP/s; {smi}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, err=err)


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
    dense = {False: runs["cuda"].reach}
    dense[True] = kvt.verify(cluster, kvt.VerifyConfig(
        backend="torch", compute_ports=True, backend_options=(("device", "cuda"),),
    )).reach
    for compute_ports, kernel in ((False, "packed_dir_allow"), (True, "fused_ports_reach")):
        enc = kvt.encode_cluster(cluster, compute_ports=compute_ports)
        tiled = kvt.tiled_k8s_reach(enc, device=dev)
        if tiled.meta["kernel"] != kernel:
            fail(f"the tiled solve on the card took {tiled.meta['kernel']}, not {kernel}")
        if not np.array_equal(tiled.to_bool(), dense[compute_ports]):
            fail(f"tiled {kernel} path differs from the dense solve")
        log(f"verify: tiled {kernel} path (compute_ports={compute_ports}, "
            f"{len(enc.atoms)} atoms) == dense solve on the card")


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
    worst_fused = fused_small(dev)

    import kubernetes_verification_tpu_torch as kvt

    t1 = time.perf_counter()
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**MAIN))
    log(f"main: generate {time.perf_counter() - t1:.2f} s")
    enc = encode_main(cluster, compute_ports=False)
    launches = main_path(enc, dev)
    torch.cuda.empty_cache()
    rows = kernel_full(enc, dev, smi)
    del enc
    torch.cuda.empty_cache()
    enc = encode_main(cluster, compute_ports=True)
    del cluster
    torch.cuda.reset_peak_memory_stats()
    fused_launches = ports_path(enc, dev)
    torch.cuda.empty_cache()
    fused_row = fused_full(enc, dev, smi)
    del enc
    torch.cuda.empty_cache()
    verify_phase(dev)
    worst = max([worst] + [r["err"] for r in rows])
    worst_fused = max(worst_fused, fused_row["err"])

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
    }, {
        "name": "fused_ports_reach",
        "route": "cuda",
        "source": "kubernetes_verification_tpu_torch/csrc/fused_ports_reach.cu",
        "replaces": "kubernetes_verification_tpu/ops/pallas_kernels.py:348",
        "launches": fused_launches,
        "max_abs_err": worst_fused,
        **{k: fused_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
    }]}
    log(f"total: {time.perf_counter() - t0:.1f} s; packed_dir_allow: per-launch "
        f"means of the two directions; {smi}")
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
