"""The port's benchmark entry point: the counterpart of the repo's ``bench.py``,
mode for mode, on the PyTorch/CUDA port.

    python -m kubernetes_verification_tpu_torch.bench --mode tiled
    kv-tpu-torch-bench --mode query --device cpu --pods 256 --policies 32

Each mode runs the port's entry points on ``--device`` (default ``cuda``:
without a GPU it exits 3 with the device's ``BackendError`` before it
generates anything; ``--device cpu`` runs every mode on the kernels' plain
versions) and prints the same JSON result lines as the JAX bench's mode,
with the same ``metric`` strings, units, keys and ``band`` shape, so that
``observe/history.py``, ``analysis/bench_gate.py`` and ``kv-tpu-torch
history`` / ``roofline`` read them unchanged:

    {"metric": ..., "value": ..., "unit": "pairs/s", "vs_baseline": ...}

``vs_baseline`` is measured against the repo's north-star rate from
``BASELINE.json`` (100k pods all-pairs in under 5 s, 2e9 pairs/s). The
flags are the JAX bench's, with ``--pallas`` / ``--no-pallas`` renamed
``--kernel`` / ``--no-kernel`` (``tiled_k8s_reach(use_kernel=...)``);
``headtohead`` names its variants ``torch`` (the torch sweep) and ``kernel``
(the hand-written CUDA kernel), with the unit ``kernel_vs_torch_median_pct``.
Every record of a mode with a cold first call carries ``kernel_builds``:
the ``nvcc`` runs inside that call, so ``compile_cold_s`` says whether it
timed a kernel build or a library load.

Every mode first runs the perf-sentinel calibration block
(``observe/sentinel.py``: compute-bound chains + a dispatch probe) so each
emitted record carries its own noise context; ``--mode sentinel`` runs ONLY
that block and records it. ``KVTPU_BENCH_NO_SENTINEL=1`` skips the prepend.
Each mode ends with one ``bench-summary`` line on stderr (JSON: the mode's
seconds, its peak device memory and the hand-written kernels' launches and
``nvcc`` runs inside it).

On a card, nothing on a timed path is wrapped in a ``try``: the device, the
kernel route, the kernel build and each launch raise to the caller. Only
bookkeeping is: the history append and the ``cost`` / ``metrics`` dumps.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time

#: North-star target rate: 100k² pairs in 5 s (BASELINE.json).
BASELINE_PAIRS_PER_SEC = (100_000**2) / 5.0

#: set by main() / bench_sentinel: structured context every emitted record
#: carries (mode + device model + platform + the sentinel calibration
#: block) so history grouping and roofline peak lookup key on fields, not
#: log-tail text
_BENCH_MODE = None
_SENTINEL_CTX = None
#: the run's ``torch.device``, set by main()
_DEVICE = None
#: guards the three globals above
_STATE_LOCK = threading.Lock()

#: the history file's default home: the repo root, beside the JAX bench's
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX bench's ``--mode`` choices (``bench.py:2750-2754``)
MODES = (
    "tiled", "k8s", "kano", "incremental", "closure", "stripe",
    "stripes", "headtohead", "serve", "query", "replicate",
    "ingress", "posture", "sentinel",
)

#: the hand-written kernels' names as ``tiled_k8s_reach`` reports them
HAND_KERNELS = ("packed_dir_allow", "fused_ports_reach")

#: the inline gates of the posture and ingress modes (the JAX bench's
#: literals): the posture tracker's apply-path budget, the post-knee
#: goodput the door must hold and the admitted requests allowed past their
#: deadline
GATES = {
    "posture_overhead_pct": 5.0,
    "ingress_post_knee_held": 0.8,
    "ingress_deadline_violations": 0,
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _dev(args):
    """``--device`` as a ``torch.device`` (``BackendError`` without a card)."""
    from .runtime import resolve_device

    return resolve_device(args.device)


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _log_device(dev) -> None:
    from .observe.introspect import _platform

    log(f"device: {_device_name(dev)} ({_platform()})")


def _sync(dev) -> None:
    """Wait for the card's queued work (every timing reads the host clock)."""
    if dev is not None and dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def _nvcc_runs() -> int:
    from .ops import cuda_build

    return cuda_build.counts()["nvcc_runs"]


def _launches() -> tuple:
    from .ops.kernels import fused_ports_reach, packed_dir_allow

    return packed_dir_allow.launches, fused_ports_reach.launches


@contextlib.contextmanager
def _world_one(dev):
    """A ``(1, 1)`` mesh over a world-1 ``torch.distributed`` group on
    ``dev`` (NCCL on a card, gloo on the CPU), left on exit."""
    from .parallel.mesh import leave_distributed, mesh_for

    try:
        yield mesh_for((1, 1), device=dev)
    finally:
        leave_distributed()


def _calibrate():
    """Run the perf-sentinel calibration block (three compute-bound chains
    + the dispatch probe, ``observe/sentinel.py``) on the run's device and
    stash its slim context so every record this process emits carries its
    own noise figure. ``KVTPU_BENCH_NO_SENTINEL=1`` skips (fast smoke
    runs). A calibration failure raises: a record must not silently lose
    its noise context."""
    global _SENTINEL_CTX
    if os.environ.get("KVTPU_BENCH_NO_SENTINEL"):
        log("sentinel calibration skipped (KVTPU_BENCH_NO_SENTINEL)")
        return None
    from .observe.sentinel import run_calibration, slim_context

    s = time.perf_counter()
    ctx = run_calibration(_DEVICE)
    wall = time.perf_counter() - s
    with _STATE_LOCK:
        _SENTINEL_CTX = slim_context(ctx)
    log(
        f"sentinel: spread {ctx['spread_pct']:.2f}% "
        f"(bound {ctx['max_spread_pct_bound']:g}%), dispatch "
        f"{ctx['dispatch_s'] * 1e3:.2f}ms, calibrated={ctx['calibrated']} "
        f"({wall:.1f}s)"
    )
    return ctx


def _context_fields() -> dict:
    """The structured context block merged under every emitted record:
    ``mode``, the card's name (``torch.cuda.get_device_name``; the roofline
    peak lookup keys on it) and ``observe/introspect.py``'s platform, and
    the slim sentinel calibration block (``sentinel.dispatch_s`` is what
    the history layer's deflation reads)."""
    from .observe.introspect import _platform

    out = {}
    if _BENCH_MODE:
        out["mode"] = _BENCH_MODE
    if _DEVICE is not None:
        out["device"] = _device_name(_DEVICE)
        out["platform"] = _platform()
    if _SENTINEL_CTX is not None:
        out["sentinel"] = _SENTINEL_CTX
    return out


def _emit(obj: dict) -> None:
    """Print ONE benchmark result line and append the run to the history.

    Every record is merged over the structured context block
    (:func:`_context_fields`). The printed line attaches the observability
    registry dump under ``metrics`` and, when introspection is on
    (``--introspect``), the per-kernel cost reports under ``cost``. A copy
    WITHOUT the bulky ``metrics`` dump is appended to
    ``bench_history.jsonl`` at the repo root (override with
    ``KVTPU_BENCH_HISTORY``; empty disables) so
    ``analysis/bench_gate.py`` can gate the trajectory. These three are
    bookkeeping: a failure in them is logged, never fatal."""
    obj = {**_context_fields(), **obj}
    line = dict(obj)
    try:
        from .observe.introspect import reports_dict

        cost = reports_dict()
        if cost:
            line["cost"] = cost
            obj = {**obj, "cost": cost}
    except Exception:
        pass  # introspection must never cost a benchmark result line
    try:
        from .observe import dump_registry

        line["metrics"] = dump_registry(include_buckets=False)
    except Exception:
        pass  # a broken registry must never cost a benchmark result line
    hist = os.environ.get(
        "KVTPU_BENCH_HISTORY", os.path.join(_REPO_ROOT, "bench_history.jsonl")
    )
    if hist:
        try:
            from .observe.history import append_run

            append_run(obj, hist)
        except Exception as exc:
            log(f"bench history append failed ({exc!r}) — result printed anyway")
    print(json.dumps(line), flush=True)


def _band(times) -> dict:
    """min/median/max + spread over repeated timings: a single scalar
    cannot tell a real regression from a noisy run, so every mode reports
    its band and the emitted JSON carries it for the run-over-run record."""
    ts = sorted(float(t) for t in times)
    med = ts[len(ts) // 2]
    return {
        "n": len(ts),
        "min_s": round(ts[0], 4),
        "median_s": round(med, 4),
        "max_s": round(ts[-1], 4),
        "spread_pct": round(100.0 * (ts[-1] - ts[0]) / med, 1) if med else 0.0,
    }


def _warm_compile_split(
    cold_s: float, rerun, parity=None, kernel_builds: int = 0
) -> dict:
    """``compile_s``/``compile_cold_s``/``compile_warm_s`` fields for one
    mode's emit. The port has no trace cache: its cold cost is the ``nvcc``
    build of the hand-written kernels into ``_build/`` (``ops/
    cuda_build.py``), or their load when they are built already
    (``kernel_builds`` — the ``nvcc`` runs inside the cold first call —
    says which). Pack the built libraries and the recorded dispatch keys
    into a throwaway warm pack (``observe/aot.py``), forget every loaded
    library (a fresh process in front of an on-disk pack), install the
    pack and re-time the mode's first-call phase.

    ``cold_s`` is the mode's first-call time — build or load plus one run.
    ``rerun`` is timed twice after the pack install: the first call pays
    the warm load (+ the run), the second is the steady run, and the
    steady time is subtracted from both the warm first call and
    ``cold_s``. ``parity(out)`` — optional result check of the warm rerun
    against the cold run. A failure here raises."""
    import shutil
    import tempfile

    from .observe import aot

    fields = {
        "compile_s": round(cold_s, 2),
        "compile_cold_s": round(cold_s, 2),
        "kernel_builds": int(kernel_builds),
    }
    if not aot.aot_enabled():
        return fields
    d = tempfile.mkdtemp(prefix="kvtpu-aot-bench-")
    try:
        aot.save_pack(d)
        aot.drop_executables()
        loaded = aot.load_pack(d)
        s = time.perf_counter()
        out = rerun()
        _sync(_DEVICE)
        warm_total = time.perf_counter() - s
        s = time.perf_counter()
        rerun()
        _sync(_DEVICE)
        steady = time.perf_counter() - s
        warm_s = max(0.0, warm_total - steady)
        cold_compile = max(0.0, cold_s - steady)
        fields["compile_cold_s"] = round(cold_compile, 2)
        fields["compile_warm_s"] = round(warm_s, 2)
        fields["aot_pack_entries"] = int(loaded.get("loaded", 0))
        fields["aot_pack_bytes"] = int(loaded.get("bytes", 0))
        if parity is not None:
            ok = bool(parity(out))
            fields["warm_parity"] = ok
            if not ok:
                log("WARM-PATH PARITY MISMATCH — inspect observe/aot.py")
        log(
            f"compile cold {cold_compile:.2f}s ({kernel_builds} nvcc runs) -> "
            f"warm {warm_s:.2f}s (first call {cold_s:.2f}s -> "
            f"{warm_total:.2f}s, steady {steady:.2f}s; "
            f"{loaded.get('loaded', 0)} packed libraries, "
            f"{loaded.get('bytes', 0)} bytes)"
        )
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return fields


def _generate(args, seed: int = 0, n_pods=None):
    """The modes' cluster: ``random_cluster`` with discriminating selectors
    (a non-saturated matrix) and no ipBlock peers."""
    from .harness.generate import GeneratorConfig, random_cluster

    return random_cluster(
        GeneratorConfig(
            n_pods=args.pods if n_pods is None else n_pods,
            n_policies=args.policies,
            n_namespaces=args.namespaces,
            p_ipblock_peer=0.0,
            min_selector_labels=1,
            seed=seed,
        )
    )


def bench_sentinel(args) -> None:
    """The perf-sentinel round: measure the fixed-shape compute-bound
    calibration chains (int8 ``torch._int_mm`` / f32 matmul / rotate-xor
    bit ops — spread verified against the per-platform bound at
    registration) and the dispatch-latency probe, and record every series
    into the history. The per-kernel ``sentinel_<k>_s`` series GATE
    lower-is-better; the ``sentinel_dispatch_s``/``sentinel_spread_pct``
    context series are ungated (they ARE the noise measurement — see
    ``observe/history.py``)."""
    global _SENTINEL_CTX
    from .observe.sentinel import run_calibration, slim_context

    dev = _dev(args)
    _log_device(dev)
    t0 = time.perf_counter()
    ctx = run_calibration(dev, reps=max(5, min(args.repeats, 9)))
    t1 = time.perf_counter()
    with _STATE_LOCK:
        _SENTINEL_CTX = slim_context(ctx)
    for name, k in ctx["kernels"].items():
        log(
            f"{name} ({k['kind']}/{k['dtype']}): median "
            f"{k['median_s'] * 1e3:.2f}ms spread {k['spread_pct']:.2f}% "
            f"= {k['macs_per_s'] / 1e9:.2f}e9 MACs/s"
            + ("" if k["calibrated"] else "  ** NOT CALIBRATED **")
        )
    log(
        f"dispatch probe: median {ctx['dispatch_s'] * 1e3:.2f}ms "
        f"(min {ctx['dispatch_min_s'] * 1e3:.2f}ms); worst kernel spread "
        f"{ctx['spread_pct']:.2f}% vs bound "
        f"{ctx['max_spread_pct_bound']:g}%; calibration {t1 - t0:.1f}s"
    )
    for name, k in ctx["kernels"].items():
        _emit(
            {
                "metric": f"sentinel_{name}_s",
                "value": round(k["median_s"], 6),
                "unit": "s",
                "spread_pct": round(k["spread_pct"], 3),
                "calibrated": k["calibrated"],
                "macs_per_run": k["macs_per_run"],
                "macs_per_s": round(k["macs_per_s"], 1),
            }
        )
    _emit(
        {
            "metric": "sentinel_dispatch_s",
            "value": round(ctx["dispatch_s"], 6),
            "unit": "s",
            "dispatch_band": ctx["dispatch_band"],
        }
    )
    _emit(
        {
            "metric": "sentinel_spread_pct",
            "value": round(ctx["spread_pct"], 3),
            "unit": "pct",
            "bound_pct": ctx["max_spread_pct_bound"],
            "calibrated": ctx["calibrated"],
            "calibrated_peak_macs_per_s": round(
                ctx["calibrated_peak_macs_per_s"], 1
            ),
            "calibration_wall_s": round(t1 - t0, 2),
        }
    )


def _check_kernel(res, want_kernel: bool) -> None:
    """The solve took the hand-written kernel's route when one was asked
    for (``ops/tiled.py`` names it in ``meta["kernel"]``)."""
    kernel = (res.meta or {}).get("kernel")
    if want_kernel and kernel not in HAND_KERNELS:
        raise AssertionError(
            f"the solve ran {kernel!r}, not a hand-written kernel {HAND_KERNELS}"
        )


def bench_tiled(args) -> None:
    """The BASELINE config-4 run: 100k pods / 10k policies, ingress+egress
    **with port-range bitmaps**, one card, packed-bitmap output kept on the
    device (``ops/tiled.py``). ``--no-ports`` runs any-port semantics. On a
    card the solve launches ``fused_ports_reach`` once (port bitmaps) or
    ``packed_dir_allow`` twice (any-port)."""
    from .encode.encoder import encode_cluster
    from .ops.tiled import tiled_k8s_reach

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    compute_ports = not args.no_ports
    t0 = time.perf_counter()
    cluster = _generate(args)
    t1 = time.perf_counter()
    enc = encode_cluster(cluster, compute_ports=compute_ports)
    t2 = time.perf_counter()
    log(
        f"generate {t1 - t0:.1f}s  encode {t2 - t1:.1f}s  "
        f"grants in/eg {enc.ingress.n}/{enc.egress.n}  "
        f"port atoms {len(enc.atoms)}"
    )
    # --kernel / --no-kernel force the route; otherwise tiled_k8s_reach
    # takes the hand-written kernel on a card and the torch sweep on the CPU
    force = True if args.kernel else (False if args.no_kernel else None)
    want_kernel = force if force is not None else dev.type == "cuda"
    run = lambda: tiled_k8s_reach(  # noqa: E731
        enc, device=dev, fetch=False, use_kernel=force
    )
    b0 = _nvcc_runs()
    res = run()  # kernel build or load + first solve
    t3 = time.perf_counter()
    builds = _nvcc_runs() - b0
    log(f"compile+first solve {t3 - t2:.1f}s  "
        f"kernel={(res.meta or {}).get('kernel', '?')}")
    _check_kernel(res, want_kernel)
    times = []
    for _ in range(max(2, min(args.repeats, 5))):
        r = run()
        times.append(r.timings["solve"])
    band = _band(times)
    solve = band["median_s"]
    value = float(n) * float(n) / solve
    log(
        f"solve median {solve:.2f}s (min {band['min_s']:.2f} max "
        f"{band['max_s']:.2f}, spread {band['spread_pct']}%); "
        f"{value / 1e9:.2f}e9 pairs/s; "
        f"{r.timings['reachable_pairs']} reachable pairs"
    )
    ports_tag = "port bitmaps" if compute_ports else "any-port"
    cold_pairs = r.timings["reachable_pairs"]
    warm_fields = _warm_compile_split(
        t3 - t2,
        rerun=run,
        parity=lambda out: out.timings["reachable_pairs"] == cold_pairs,
        kernel_builds=builds,
    )
    _emit(
        {
            "metric": (
                f"all-pairs reachability, {n} pods / {args.policies} "
                f"policies, {ports_tag} (north-star config), 1 chip"
            ),
            "value": round(value, 1),
            "unit": "pairs/s",
            "vs_baseline": round(value / BASELINE_PAIRS_PER_SEC, 4),
            "band": band,
            **warm_fields,
            "steady_s": round(solve, 4),
            # roofline accounting: the solve's int8 product work is N²
            # pairs × one MAC per grant row
            "macs": float(n) * float(n) * (enc.ingress.n + enc.egress.n),
            "macs_basis": "n_pods^2 * (ingress_grants + egress_grants)",
        }
    )


def bench_incremental(args) -> None:
    """BASELINE config 5's diff half at flagship scale: policy add / update /
    remove latency on a 100k-pod / 10k-policy cluster via the packed
    incremental verifier (device-resident per-policy maps + packed matrix,
    ``packed_incremental.py``; with port bitmaps
    ``packed_incremental_ports.py``). Target: ≤100 ms per diff. The
    engines' builds launch ``packed_dir_allow`` twice (any-port) or
    ``fused_ports_reach`` once (port bitmaps)."""
    import dataclasses
    import statistics

    from .backends.base import VerifyConfig
    from .packed_incremental import PackedIncrementalVerifier
    from .packed_incremental_ports import PackedPortsIncrementalVerifier

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    with_ports = not args.no_ports
    t0 = time.perf_counter()
    cluster = _generate(args)
    t1 = time.perf_counter()
    b0 = _nvcc_runs()
    if with_ports:
        cfg = VerifyConfig(compute_ports=True)
        inc = PackedPortsIncrementalVerifier(cluster, cfg, device=dev, headroom=16)
    else:
        cfg = VerifyConfig(compute_ports=False)
        inc = PackedIncrementalVerifier(cluster, cfg, device=dev)
    _sync(dev)
    t2 = time.perf_counter()
    builds = _nvcc_runs() - b0
    log(f"generate {t1 - t0:.1f}s  init (encode+maps+solve) {t2 - t1:.1f}s  "
        f"ports={with_ports}")

    pols = list(cluster.policies)
    diffs = []
    for i in range(max(6, args.repeats * 3)):
        donor = pols[(7 * i + 3) % len(pols)]
        kind = ("update", "add", "remove")[i % 3]
        if kind == "update":
            victim = pols[(11 * i) % len(pols)]
            diffs.append(
                ("update", dataclasses.replace(victim, ingress=donor.ingress))
            )
        elif kind == "add":
            added = dataclasses.replace(donor, name=f"bench-add-{i}")
            diffs.append(("add", added))
        else:  # remove the policy added on the previous iteration, by key
            diffs.append(("remove", (added.namespace, added.name)))
    # warmup: run the first 3 (one of each kind) to take first calls out
    warm, timed = diffs[:3], diffs[3:]
    samples = {"add": [], "update": [], "remove": []}

    def apply(kind, payload, record: bool):
        s = time.perf_counter()
        if kind == "update":
            inc.update_policy(payload)
        elif kind == "add":
            inc.add_policy(payload)
        else:  # payloads for remove are (namespace, name) keys
            inc.remove_policy(*payload)
        _sync(dev)
        if record:
            samples[kind].append(time.perf_counter() - s)

    for kind, payload in warm:
        apply(kind, payload, record=False)
    for kind, payload in timed:
        apply(kind, payload, record=True)
    med = {k: statistics.median(v) for k, v in samples.items() if v}
    overall = statistics.median([t for v in samples.values() for t in v])
    log(
        "sync latency medians (1 synchronisation per diff): "
        + "  ".join(f"{k} {v * 1e3:.1f}ms" for k, v in med.items())
        + f"  overall {overall * 1e3:.1f}ms over {sum(len(v) for v in samples.values())} diffs"
    )
    # pipelined throughput per kind: dispatch a burst of diffs, sync once —
    # the serving/re-verify pattern
    k = 10
    piped = {}
    pipe_adds = [
        dataclasses.replace(pols[(17 * i + 5) % len(pols)], name=f"pipe-{i}")
        for i in range(k)
    ]
    s = time.perf_counter()
    for p in pipe_adds:
        inc.add_policy(p)
    _sync(dev)
    piped["add"] = (time.perf_counter() - s) / k
    s = time.perf_counter()
    for i in range(k):
        inc.update_policy(
            dataclasses.replace(
                pols[(13 * i + 5) % len(pols)],
                ingress=pols[(3 * i + 1) % len(pols)].ingress,
            )
        )
    _sync(dev)
    piped["update"] = (time.perf_counter() - s) / k
    s = time.perf_counter()
    for p in pipe_adds:
        inc.remove_policy(p.namespace, p.name)
    _sync(dev)
    piped["remove"] = (time.perf_counter() - s) / k
    # pod churn (cluster evolution): same pipelined-burst pattern — pods
    # churn far more than policies in real clusters
    from .models.core import Pod

    ns0 = cluster.pods[0].namespace
    kp = 8
    pipe_pods = [
        Pod(f"bench-pod-{i}", ns0, {"app": f"bench{i % 3}", "env": "prod"})
        for i in range(kp)
    ]
    s = time.perf_counter()
    idxs = [inc.add_pod(p) for p in pipe_pods]
    _sync(dev)
    piped["pod_add"] = (time.perf_counter() - s) / kp
    s = time.perf_counter()
    for i, idx in enumerate(idxs):
        inc.update_pod_labels(idx, {"app": "relab", "env": f"e{i}"})
    _sync(dev)
    piped["pod_relabel"] = (time.perf_counter() - s) / kp
    s = time.perf_counter()
    for p in pipe_pods:
        inc.remove_pod(ns0, p.name)
    _sync(dev)
    piped["pod_remove"] = (time.perf_counter() - s) / kp
    overall_piped = statistics.median(sorted(piped.values()))
    log(
        "pipelined (bursts, one sync each): "
        + "  ".join(f"{kk} {v * 1e3:.1f}ms" for kk, v in piped.items())
    )
    sync_band = _band([t for v in samples.values() for t in v])

    def _warm_init():
        if with_ports:
            return PackedPortsIncrementalVerifier(
                cluster, cfg, device=dev, headroom=16
            )
        return PackedIncrementalVerifier(cluster, cfg, device=dev)

    warm_fields = _warm_compile_split(t2 - t1, rerun=_warm_init, kernel_builds=builds)
    _emit(
        {
            "metric": (
                f"incremental diff (policy add/update/remove + pod "
                f"add/relabel/remove, pipelined), "
                f"{n} pods / {args.policies} policies, "
                f"{'port bitmaps' if with_ports else 'any-port'}, "
                "packed state, 1 chip"
            ),
            "value": round(overall_piped * 1e3, 2),
            "unit": "ms",
            # target: ≤100 ms per diff → >1.0 means better than target
            "vs_baseline": round(0.1 / overall_piped, 4),
            "sync_band": sync_band,
            "piped_ms": {
                k: round(v * 1e3, 2) for k, v in piped.items()
            },
            # init = encode+maps+first solve (the kernel build or load);
            # the warm diffs above take each kind's first call out of the
            # steady figure
            **warm_fields,
            "steady_s": round(overall_piped, 4),
        }
    )


def bench_closure(args) -> None:
    """Packed transitive closure at flagship scale, full AND after-a-diff:
    the incremental engine's ``closure_packed`` primes the full closure,
    then one policy diff + a delta re-closure (``packed_closure_delta`` —
    bit-for-bit a full re-closure). The headline value is the after-diff
    latency; the full number rides along as ``full_s``. The engine's build
    launches ``packed_dir_allow`` twice; the squaring passes are
    ``bool_dot`` products."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch

    from .backends.base import VerifyConfig
    from .models.core import Peer, Rule, Selector
    from .observe.metrics import CLOSURE_ITERATIONS
    from .ops.closure import packed_closure
    from .packed_incremental import PackedIncrementalVerifier
    from .parallel.mesh import GRANT_AXIS, POD_AXIS
    from .parallel.sharded_closure import sharded_packed_closure

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    t0 = time.perf_counter()
    cluster = _generate(args)
    t1 = time.perf_counter()
    inc = PackedIncrementalVerifier(
        cluster, VerifyConfig(compute_ports=False), device=dev
    )
    _sync(dev)
    t2 = time.perf_counter()
    log(f"generate {t1 - t0:.1f}s  init {t2 - t1:.1f}s")

    sync = lambda c: int(c[0, 0])  # noqa: E731 — one word read back: a sync
    b0 = _nvcc_runs()
    s = time.perf_counter()
    sync(inc.closure_packed(tile=args.closure_tile))
    full_first = time.perf_counter() - s
    builds = _nvcc_runs() - b0
    log(f"full packed closure (first call): {full_first:.1f}s")
    # band: re-run the full closure on the same matrix (the engine caches
    # its closure, so repeats go straight at the passes). The first call
    # stays OUT of the band.
    full_times = []
    iter_counts = []
    for _ in range(3):
        it0 = CLOSURE_ITERATIONS.value
        s = time.perf_counter()
        sync(packed_closure(inc._packed, tile=args.closure_tile))
        full_times.append(time.perf_counter() - s)
        iter_counts.append(CLOSURE_ITERATIONS.value - it0)
    full_band = _band(full_times)
    full_s = full_band["median_s"]
    iter_band = {
        "min": int(min(iter_counts)),
        "median": int(sorted(iter_counts)[len(iter_counts) // 2]),
        "max": int(max(iter_counts)),
    }
    log(f"full packed closure: median {full_s:.1f}s "
        f"(min {full_band['min_s']:.1f} max {full_band['max_s']:.1f}), "
        f"{iter_band['median']} squaring passes")
    pols = list(cluster.policies)
    # adds-only diff: append a NARROW rule to an existing policy — its
    # selection (so every isolation count) is unchanged and grants only
    # grow, from the few pods matching one donor pod's exact labels; the
    # delta closure takes the additions-only fast path with a diff-local
    # changed set. Try donors until the diff actually adds reach.
    if len(pols) < 3:
        sys.exit("--mode closure needs at least 3 policies")
    # the target must actually SELECT pods, and donors must be egress-open
    # srcs (their eg_ok side is already true via default-allow, so a fresh
    # ingress grant is sufficient to add reach)
    target = next(
        (
            p for p in pols
            if int(inc._vectorizer.vectors(p)[0].sum()) > 0
        ),
        pols[3 % len(pols)],
    )
    open_srcs = [
        int(k)
        for k in np.nonzero(np.asarray(inc._h_eg_cnt) == 0)[0][:64]
    ]
    donor_ks = list(
        dict.fromkeys(
            (open_srcs or [0]) + sorted({0, n // 97, n // 7, n // 3, n - 1})
        )
    )
    for k in donor_ks:
        narrow = Rule(
            peers=(Peer(pod_selector=Selector(dict(cluster.pods[k].labels))),)
        )
        inc.update_policy(
            dataclasses.replace(
                target, ingress=tuple(target.ingress or ()) + (narrow,)
            )
        )
        base = torch.as_tensor(inc._closure_base, device=inc._packed.device)
        if bool((inc._packed & ~base).any()):
            adds_real = True
            break
    else:
        adds_real = False
        log("WARNING: no donor diff added reach — the adds-only figure "
            "times a no-op delta closure")
    s = time.perf_counter()
    sync(inc.closure_packed(tile=args.closure_tile))
    adds_s = time.perf_counter() - s
    log(f"closure after an adds-only policy diff: {adds_s:.2f}s "
        f"({full_s / adds_s:.1f}x faster than full)")
    # mixed diff (adds AND removes reach): the hard decremental case
    inc.update_policy(
        dataclasses.replace(pols[1], ingress=pols[2].ingress)
    )
    s = time.perf_counter()
    sync(inc.closure_packed(tile=args.closure_tile))
    mixed_s = time.perf_counter() - s
    log(f"closure after a mixed policy diff: {mixed_s:.2f}s "
        f"({full_s / mixed_s:.1f}x faster than full)")
    ref_word = sync(packed_closure(inc._packed, tile=args.closure_tile))
    warm_fields = _warm_compile_split(
        full_first,
        rerun=lambda: sync(
            packed_closure(inc._packed, tile=args.closure_tile)
        ),
        parity=lambda out: out == ref_word,
        kernel_builds=builds,
    )
    _emit(
        {
            "metric": (
                f"packed closure after an adds-only policy diff, "
                f"{n} pods / {args.policies} policies (full and "
                "mixed-diff numbers ride along), 1 chip"
            ),
            "value": round(adds_s, 3),
            "unit": "s",
            "vs_baseline": round(full_s / adds_s, 2),
            "full_s": round(full_s, 2),
            "full_band": full_band,
            "mixed_diff_s": round(mixed_s, 2),
            "adds_diff_real": adds_real,
            "iterations": iter_band,
            # the first full closure is the cold call; full_s its steady median
            **warm_fields,
            "steady_s": round(full_s, 4),
        }
    )
    # second record: the closure THROUGHPUT series — all-pairs transitive
    # reachability per steady-state second (gated higher-is-better by name)
    _emit(
        {
            "metric": "closure_pairs_per_second",
            "value": round(float(n) * float(n) / full_s, 1) if full_s else 0.0,
            "unit": "pairs/s",
            "pods": n,
            "policies": args.policies,
            "full_band": full_band,
            "iterations": iter_band,
            "steady_s": round(full_s, 4),
            # each squaring pass is an n×n×n boolean product (packed words,
            # counted as MAC-equivalents for the roofline)
            "macs": float(iter_band["median"]) * float(n) ** 3,
            "macs_basis": "squaring_passes_median * n_pods^3",
        }
    )
    # third record: pass-boundary checkpoint/resume proof. Checkpoint the
    # full closure every squaring pass, then resume from the newest
    # generation: the resumed run re-executes only the passes after the
    # checkpoint (one confirming pass on a converged matrix).
    ckpt_dir = tempfile.mkdtemp(prefix="kvtpu-closure-ckpt-")
    try:
        it0 = CLOSURE_ITERATIONS.value
        s = time.perf_counter()
        sync(packed_closure(inc._packed, tile=args.closure_tile,
                            checkpoint_dir=ckpt_dir, checkpoint_every=1))
        ckpt_full_s = time.perf_counter() - s
        full_passes = CLOSURE_ITERATIONS.value - it0
        it0 = CLOSURE_ITERATIONS.value
        s = time.perf_counter()
        sync(packed_closure(inc._packed, tile=args.closure_tile,
                            checkpoint_dir=ckpt_dir, checkpoint_every=1,
                            resume=True))
        resume_s = time.perf_counter() - s
        resumed_passes = CLOSURE_ITERATIONS.value - it0
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(
        f"closure checkpoint/resume: checkpointed full run "
        f"{full_passes} passes {ckpt_full_s:.2f}s; resume re-ran "
        f"{resumed_passes} pass(es) in {resume_s:.2f}s"
    )
    _emit(
        {
            "metric": "closure_resume_passes_skipped",
            "value": int(full_passes - resumed_passes),
            "unit": "passes",
            "loop": "single",
            "full_passes": int(full_passes),
            "resumed_passes": int(resumed_passes),
            "checkpointed_full_s": round(ckpt_full_s, 3),
            "resume_s": round(resume_s, 3),
        }
    )
    # fourth record: the SAME checkpoint/resume proof for the mesh-sharded
    # loop on a world-1 torch.distributed group over the run's device (NCCL
    # on a card, gloo on the CPU): per-shard state is gathered into one
    # checkpoint generation at each pass boundary, and the resumed run
    # re-executes only the passes after the newest generation.
    with tempfile.TemporaryDirectory(
        prefix="kvtpu-closure-ckpt-sharded-"
    ) as ckpt_dir, _world_one(dev) as mesh:
        it0 = CLOSURE_ITERATIONS.value
        s = time.perf_counter()
        full_out = sharded_packed_closure(
            mesh, inc._packed, tile=args.closure_tile,
            checkpoint_dir=ckpt_dir, checkpoint_every=1,
        )
        sh_full_s = time.perf_counter() - s
        sh_full_passes = CLOSURE_ITERATIONS.value - it0
        it0 = CLOSURE_ITERATIONS.value
        s = time.perf_counter()
        resume_out = sharded_packed_closure(
            mesh, inc._packed, tile=args.closure_tile,
            checkpoint_dir=ckpt_dir, checkpoint_every=1, resume=True,
        )
        sh_resume_s = time.perf_counter() - s
        sh_resumed_passes = CLOSURE_ITERATIONS.value - it0
    if not np.array_equal(full_out, resume_out):
        sys.exit("sharded closure resume diverged from the full run")
    mesh_shape = [int(mesh.shape[POD_AXIS]), int(mesh.shape[GRANT_AXIS])]
    log(
        f"sharded closure checkpoint/resume (mesh {tuple(mesh_shape)}): full "
        f"run {sh_full_passes} passes {sh_full_s:.2f}s; resume re-ran "
        f"{sh_resumed_passes} pass(es) in {sh_resume_s:.2f}s"
    )
    _emit(
        {
            "metric": "closure_resume_passes_skipped",
            "value": int(sh_full_passes - sh_resumed_passes),
            "unit": "passes",
            "loop": "sharded",
            "mesh": mesh_shape,
            "full_passes": int(sh_full_passes),
            "resumed_passes": int(sh_resumed_passes),
            "checkpointed_full_s": round(sh_full_s, 3),
            "resume_s": round(sh_resume_s, 3),
        }
    )


def bench_stripe(args) -> None:
    """The 1M-pod (BASELINE config 5) regime on one card: tile a base
    cluster's pod encoding out to 1M pods, sweep one dst-tile stripe of the
    packed solver (pairs/s) on a world-1 mesh, then run a matrix-free
    incremental policy diff + stripe re-verify at 250k pods (diff latency).
    Matrix-free by design: the full words at 1M pods would be 125 GB, and
    no step here holds ``[N, N/32]`` (the stripe keeps its ``[N, width/32]``
    words only). ``--full-sweep`` additionally sweeps every dst tile and
    checks the aggregates against the CPU oracle."""
    dev = _dev(args)
    _log_device(dev)
    base_n = 2000
    if args.pods < base_n or args.pods % base_n:
        sys.exit(
            f"--mode stripe tiles a {base_n}-pod base cluster; --pods must "
            f"be a positive multiple of {base_n}"
        )
    with _world_one(dev) as mesh:
        _stripe_body(args, dev, mesh, base_n)


def _stripe_body(args, dev, mesh, base_n: int) -> None:
    """``bench_stripe`` on its world-1 mesh."""
    import dataclasses

    import numpy as np

    from . import Cluster
    from .backends.base import VerifyConfig, verify
    from .encode.encoder import encode_cluster
    from .packed_incremental import PackedIncrementalVerifier
    from .parallel.packed_sharded import sharded_packed_reach

    reps = args.pods // base_n  # default 1M = 2000 × 500
    t0 = time.perf_counter()
    base = _generate(args, seed=44, n_pods=base_n)
    enc_base = encode_cluster(base, compute_ports=False)
    enc_big = dataclasses.replace(
        enc_base,
        n_pods=enc_base.n_pods * reps,
        pod_kv=np.tile(enc_base.pod_kv, (reps, 1)),
        pod_key=np.tile(enc_base.pod_key, (reps, 1)),
        pod_ns=np.tile(enc_base.pod_ns, reps),
    )
    t1 = time.perf_counter()
    n_big = enc_big.n_pods
    tile = 512
    k_tiles = max(1, args.stripe_width // tile)
    run = lambda: sharded_packed_reach(  # noqa: E731
        mesh, enc_big, tile=tile, chunk=1024,
        stripe=(0, k_tiles), keep_matrix=False,
    )
    b0 = _nvcc_runs()
    res = run()  # first sweep
    t2 = time.perf_counter()
    builds = _nvcc_runs() - b0
    log(f"generate+tile-encode {t1 - t0:.1f}s  "
        f"first stripe {t2 - t1:.1f}s")
    times = []
    for _ in range(max(2, min(args.repeats, 4))):
        r = run()
        times.append(r.timings["solve"])
    stripe_band = _band(times)
    stripe_s = stripe_band["median_s"]
    width = k_tiles * tile
    stripe_rate = float(n_big) * width / stripe_s
    log(f"{n_big}-pod stripe: {n_big} srcs x {width} dsts in {stripe_s:.2f}s "
        f"median (min {stripe_band['min_s']:.2f} max "
        f"{stripe_band['max_s']:.2f}) = {stripe_rate / 1e9:.2f}e9 pairs/s; "
        f"{res.total_pairs} pairs in the stripe")

    sweep_extra = {}
    if args.full_sweep:
        # config 5's single-card share END-TO-END: every dst tile of the
        # n_big-pod matrix-free solve, aggregates accumulated across
        # stripes, then cross-checked against the CPU oracle via the
        # replication periodicity:
        # reach(i, j) = P_base(i % B, j % B) ∨ (i == j), so
        # total = reps² · |P_base| + reps · #{a : ¬P_base(a, a)}.
        t5 = time.perf_counter()
        full = sharded_packed_reach(
            mesh, enc_big, tile=tile, chunk=1024,
            sweep_chunk_tiles=k_tiles,
        )
        sweep_s = time.perf_counter() - t5
        rate = float(n_big) * float(n_big) / sweep_s
        log(f"FULL sweep: {n_big}² pairs in {sweep_s:.1f}s = "
            f"{rate / 1e9:.2f}e9 pairs/s over "
            f"{full.timings['n_chunks']} stripes (chunk median "
            f"{full.timings['chunk_s_median']:.2f}s, max "
            f"{full.timings['chunk_s_max']:.2f}s)")
        p_base = verify(
            base,
            VerifyConfig(backend="cpu", compute_ports=False, self_traffic=False),
        ).reach
        diag_missing = int((~np.diag(p_base)).sum())
        expected_total = (
            reps * reps * int(p_base.sum()) + reps * diag_missing
        )
        row_base = p_base.sum(axis=1).astype(np.int64)
        ok_total = full.total_pairs == expected_total
        # spot-check out-degrees on a sample of rows
        rows = np.arange(0, n_big, max(1, n_big // 97))
        exp_rows = reps * row_base[rows % base_n] + (
            ~np.diag(p_base)[rows % base_n]
        ).astype(np.int64)
        ok_rows = bool((full.out_degree[rows] == exp_rows).all())
        log(f"oracle cross-check: total {full.total_pairs} "
            f"{'==' if ok_total else '!='} expected {expected_total}; "
            f"out-degree sample {'ok' if ok_rows else 'MISMATCH'}")
        if not (ok_total and ok_rows):
            sys.exit("full-sweep aggregates disagree with the CPU oracle")
        sweep_extra = {
            "full_sweep_s": round(sweep_s, 2),
            "full_sweep_pairs_per_s": round(rate, 1),
            "full_sweep_total_pairs": full.total_pairs,
            "full_sweep_chunks": full.timings["n_chunks"],
            "full_sweep_chunk_band": {
                "min_s": round(full.timings["chunk_s_min"], 3),
                "median_s": round(full.timings["chunk_s_median"], 3),
                "max_s": round(full.timings["chunk_s_max"], 3),
            },
            "oracle_checked": True,
        }

    # matrix-free incremental diff at 250k pods (pod OBJECTS needed here,
    # so a smaller tiling keeps host construction sane)
    reps_inc = 125
    big_pods = [
        dataclasses.replace(p, name=f"{p.name}-r{r}")
        for r in range(reps_inc)
        for p in base.pods
    ]
    big = Cluster(
        pods=big_pods, namespaces=list(base.namespaces),
        policies=list(base.policies),
    )
    t3 = time.perf_counter()
    inc = PackedIncrementalVerifier(
        big, VerifyConfig(compute_ports=False), device=dev, keep_matrix=False
    )
    _sync(dev)
    t4 = time.perf_counter()
    log(f"{len(big_pods)}-pod matrix-free engine init {t4 - t3:.1f}s")
    diff_pol = dataclasses.replace(
        base.policies[1], ingress=base.policies[2].ingress
    )
    s = time.perf_counter()
    inc.update_policy(diff_pol)
    _sync(dev)
    diff_s = time.perf_counter() - s
    s = time.perf_counter()
    stripe_words = inc.solve_stripe(0, tile)
    _ = int(stripe_words[0, 0])
    restripe_s = time.perf_counter() - s
    log(f"matrix-free diff {diff_s * 1e3:.1f}ms; "
        f"stripe re-verify ({tile} dsts) {restripe_s:.2f}s")
    del inc, big, big_pods
    warm_fields = _warm_compile_split(
        t2 - t1, rerun=run,
        parity=lambda out: out.total_pairs == res.total_pairs,
        kernel_builds=builds,
    )
    _emit(
        {
            "metric": (
                f"config-5 single-chip share: {n_big}-pod packed stripe "
                f"({width} dsts) + 250k matrix-free diff, "
                f"{args.policies} policies, 1 chip"
            ),
            "value": round(stripe_rate, 1),
            "unit": "pairs/s",
            "vs_baseline": round(stripe_rate / BASELINE_PAIRS_PER_SEC, 4),
            "stripe_s": round(stripe_s, 3),
            "stripe_band": stripe_band,
            "mf_diff_ms": round(diff_s * 1e3, 2),
            "mf_restripe_s": round(restripe_s, 3),
            **warm_fields,
            "steady_s": round(stripe_s, 4),
            "macs": float(n_big) * float(width)
            * (enc_big.ingress.n + enc_big.egress.n),
            "macs_basis": "n_src * stripe_width * (ingress_grants + egress_grants)",
            **sweep_extra,
        }
    )


def bench_stripes(args) -> None:
    """Stripe-sharded serving fleet vs one whole-state follower: K stripe
    owners (each holding only its ``[lo, hi)`` rows — per-process state
    asserted ≤ 1/K + ε of the whole-state engine) behind a
    ``StripeCoordinator``, replaying the same churn WAL batches as a
    single-stripe (1/1) baseline. Every answer the coordinator merges is
    cross-checked bit-for-bit against the baseline before any timing is
    trusted. Emits the gated higher-is-better
    ``stripe_aggregate_queries_per_second`` (threaded mixed probe
    workload through the coordinator) and the gated lower-is-better
    ``stripe_cross_stripe_p99_s`` (full-scatter ``who_can_reach``
    latency tail). Every owner's engine lives on ``--device``."""
    import numpy as np

    from .backends.base import VerifyConfig
    from .harness.generate import random_event_stream
    from .serve.stripes import StripeCoordinator, StripeFollower

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    k_stripes = max(2, args.stripes)
    t0 = time.perf_counter()
    cluster = _generate(args)
    events = random_event_stream(cluster, n_events=args.n_events, seed=1)
    t1 = time.perf_counter()
    log(f"generate+stream {t1 - t0:.1f}s ({len(events)} events)")
    cfg = VerifyConfig(compute_ports=False)

    baseline = StripeFollower(
        cluster, cfg, stripe=(0, 1), replica="whole", device=dev,
    )
    owners = [
        StripeFollower(
            cluster, cfg, stripe=(k, k_stripes),
            replica=f"stripe-{k + 1}-of-{k_stripes}", device=dev,
        )
        for k in range(k_stripes)
    ]
    _sync(dev)
    t2 = time.perf_counter()
    log(f"bootstrap 1 whole + {k_stripes} stripe owners {t2 - t1:.1f}s")

    # the 1/K + ε state bound is the whole point — assert it before any
    # throughput number is allowed to look good
    base_bytes = baseline.engine.state_bytes()
    worst = max(o.engine.state_bytes() for o in owners)
    bound = base_bytes / k_stripes + 64 * n  # ε: the O(N) iso/aux vectors
    assert worst <= bound, (
        f"stripe state {worst}B breaches the 1/K+eps bound "
        f"({base_bytes}B whole / {k_stripes} + O(N) = {bound:.0f}B)"
    )

    batch = 64
    batches = [events[i:i + batch] for i in range(0, len(events), batch)]
    s = time.perf_counter()
    for b in batches:
        baseline.apply(b)
        for o in owners:
            o.apply(b)
    _sync(dev)
    apply_s = time.perf_counter() - s
    fanout = sum(o.fanout_total for o in owners)
    log(
        f"replayed {len(events)} events into all engines {apply_s:.1f}s "
        f"({fanout} cross-stripe fan-out applies)"
    )

    coord = StripeCoordinator(owners, pods=cluster.pods)
    oracle = StripeCoordinator([baseline], pods=cluster.pods)
    names = [f"{p.namespace}/{p.name}" for p in cluster.pods]
    rng = np.random.default_rng(7)

    # ---- correctness first: merged answers must be bit-identical -------
    q_pairs = rng.integers(0, n, size=(1024, 2))
    probe_q = [(names[a], names[b]) for a, b in q_pairs]
    got = coord.can_reach_batch(probe_q)
    want = oracle.can_reach_batch(probe_q)
    assert np.array_equal(got, want), "stripe probe answers diverged"
    dsts = [names[i] for i in rng.integers(0, n, size=32)]
    assert coord.who_can_reach_batch(dsts) == oracle.who_can_reach_batch(
        dsts
    ), "stripe column scatter-gather diverged"
    srcs = [names[i] for i in rng.integers(0, n, size=32)]
    assert coord.blast_radius_batch(srcs) == oracle.blast_radius_batch(
        srcs
    ), "stripe blast radius diverged"
    for a, b in q_pairs[:8]:
        assert coord.path_exists(names[a], names[b], 3) == oracle.path_exists(
            names[a], names[b], 3
        )
        assert coord.hops(names[a], names[b], 4) == oracle.hops(
            names[a], names[b], 4
        )
    log("parity: probes/cols/blast/paths bit-identical to whole-state")

    # ---- aggregate QPS: threaded mixed probe workload ------------------
    n_q = args.n_queries
    work = rng.integers(0, n, size=(n_q, 2))
    work_q = [(names[a], names[b]) for a, b in work]
    sub = 256
    chunks = [work_q[i:i + sub] for i in range(0, len(work_q), sub)]
    coord.can_reach_batch(chunks[0])  # first probe-path calls
    n_threads = min(4, k_stripes)

    def drive(parts):
        for c in parts:
            coord.can_reach_batch(c)

    qps_runs = []
    for _ in range(max(2, args.repeats)):
        threads = [
            threading.Thread(
                target=drive, args=(chunks[t::n_threads],), daemon=True
            )
            for t in range(n_threads)
        ]
        s = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        qps_runs.append(len(work_q) / (time.perf_counter() - s))
    qps_band = _band([len(work_q) / q for q in qps_runs])
    qps = max(qps_runs)
    log(
        f"aggregate: {len(work_q)} probes x {n_threads} threads over "
        f"{k_stripes} stripes = {qps:.0f} queries/s best "
        f"(median window {qps_band['median_s']:.3f}s)"
    )

    # ---- cross-stripe latency tail: full scatter per call --------------
    lat = []
    tail_dsts = [names[i] for i in rng.integers(0, n, size=256)]
    coord.who_can_reach(tail_dsts[0])
    for d in tail_dsts:
        s = time.perf_counter()
        coord.who_can_reach(d)
        lat.append(time.perf_counter() - s)
    lat_sorted = sorted(lat)
    p99 = lat_sorted[min(len(lat_sorted) - 1, int(0.99 * len(lat_sorted)))]
    log(
        f"cross-stripe who_can_reach: median "
        f"{lat_sorted[len(lat_sorted) // 2] * 1e3:.2f}ms p99 "
        f"{p99 * 1e3:.2f}ms over {len(lat)} full scatters"
    )

    common = {
        "pods": n,
        "policies": args.policies,
        "stripes": k_stripes,
        "events": len(events),
        "fanout_applies": fanout,
        "whole_state_bytes": base_bytes,
        "stripe_state_bytes_max": worst,
        "state_fraction": round(worst / base_bytes, 4),
    }
    _emit(
        {
            "metric": "stripe_aggregate_queries_per_second",
            "value": round(qps, 1),
            "unit": "queries/s",
            "threads": n_threads,
            "window_band": qps_band,
            "steady_s": round(qps_band["median_s"], 4),
            **common,
        }
    )
    _emit(
        {
            "metric": "stripe_cross_stripe_p99_s",
            "value": round(p99, 5),
            "unit": "s",
            "median_s": round(lat_sorted[len(lat_sorted) // 2], 5),
            "samples": len(lat),
            "steady_s": round(p99, 5),
            **common,
        }
    )


def bench_headtohead(args) -> None:
    """Interleaved kernel A/B at the north-star config (same process,
    alternating variants, bands not scalars). Variants: the torch sweep
    (``use_kernel=False``) vs the hand-written CUDA kernel
    (``use_kernel=True``: ``fused_ports_reach`` with port bitmaps,
    ``packed_dir_allow`` any-port). The unit is
    ``kernel_vs_torch_median_pct``: the kernel's median over the sweep's,
    less one, in percent."""
    from .encode.encoder import encode_cluster
    from .ops.tiled import tiled_k8s_reach

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    t0 = time.perf_counter()
    cluster = _generate(args)
    enc = encode_cluster(cluster, compute_ports=not args.no_ports)
    t1 = time.perf_counter()
    log(f"generate+encode {t1 - t0:.1f}s")
    variants = {
        "torch": lambda: tiled_k8s_reach(
            enc, device=dev, fetch=False, use_kernel=False
        ),
        "kernel": lambda: tiled_k8s_reach(
            enc, device=dev, fetch=False, use_kernel=True
        ),
    }
    kernels = {}
    compile_s = {}
    for name, fn in variants.items():
        s = time.perf_counter()
        r = fn()  # first call: the kernel's build or load
        compile_s[name] = round(time.perf_counter() - s, 2)
        kernels[name] = (r.meta or {}).get("kernel", "?")
        log(f"{name}: first call {compile_s[name]}s "
            f"(kernel={kernels[name]})")
        if name == "kernel":
            _check_kernel(r, True)
    reps = max(3, min(args.repeats, 7))
    times = {k: [] for k in variants}
    for i in range(reps):
        for name, fn in variants.items():
            times[name].append(fn().timings["solve"])
        log(f"rep {i + 1}/{reps} done")
    bands = {k: _band(v) for k, v in times.items()}
    for name, b in bands.items():
        log(f"{name} ({kernels[name]}): median {b['median_s']:.2f}s "
            f"min {b['min_s']:.2f} max {b['max_s']:.2f} "
            f"spread {b['spread_pct']}%")
    delta_pct = 100.0 * (
        bands["kernel"]["median_s"] / bands["torch"]["median_s"] - 1.0
    )
    log(f"kernel vs torch: {delta_pct:+.1f}% median "
        f"({'kernel slower' if delta_pct > 0 else 'kernel faster'})")
    _emit(
        {
            "metric": (
                f"interleaved kernel A/B (torch vs kernel), {n} pods / "
                f"{args.policies} policies, "
                f"{'any-port' if args.no_ports else 'port bitmaps'}, "
                "1 chip"
            ),
            "value": round(delta_pct, 1),
            "unit": "kernel_vs_torch_median_pct",
            "vs_baseline": round(
                (float(n) * n / bands["torch"]["median_s"])
                / BASELINE_PAIRS_PER_SEC,
                4,
            ),
            "bands": bands,
            "kernels": kernels,
            "compile_s": compile_s,
            "steady_s": round(bands["torch"]["median_s"], 4),
        }
    )


def bench_serve(args) -> None:
    """Continuous-verification serving loop: apply a churn event stream
    through the coalescing :class:`VerificationService` with interleaved
    queries. Headline value is steady-state events/s; the query-latency
    band (each timed query pays its lazy solve) and the coalescing/solve
    amplification ride along. A durability rider times three atomic
    checkpoints of the warm engine and reports the overhead an
    every-8-batches cadence would add to the loop. The service's engine is
    the dense one (no hand-written kernel on its path)."""
    import tempfile

    from .harness.generate import random_event_stream
    from .serve import CheckpointManager, QueryEngine, VerificationService

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    t0 = time.perf_counter()
    cluster = _generate(args)
    events = random_event_stream(cluster, n_events=args.n_events, seed=1)
    t1 = time.perf_counter()
    b0 = _nvcc_runs()
    svc = VerificationService(cluster, device=dev)
    svc.reach()  # init + first derive: first calls out of the steady figures
    q = QueryEngine(svc)
    pods = svc.engine.pods
    ref = lambda i: f"{pods[i % n].namespace}/{pods[i % n].name}"  # noqa: E731
    t2 = time.perf_counter()
    builds = _nvcc_runs() - b0
    log(f"generate+stream {t1 - t0:.1f}s  service init+first solve "
        f"{t2 - t1:.1f}s")

    batch = 64
    batches = [events[i:i + batch] for i in range(0, len(events), batch)]
    warm, timed = batches[:1], batches[1:]
    for b in warm:  # each op kind's first call out of the band
        svc.apply(b)
        svc.reach()
    base_events = svc.stats.events_seen
    base_solves = svc.stats.total_solves
    apply_times, query_times = [], []
    s_all = time.perf_counter()
    for i, b in enumerate(timed):
        s = time.perf_counter()
        svc.apply(b)
        _sync(dev)
        apply_times.append(time.perf_counter() - s)
        if i % 4 == 3:  # interleaved query: pays the lazy solve
            s = time.perf_counter()
            q.can_reach(ref(i), ref(3 * i + 1))
            query_times.append(time.perf_counter() - s)
    if not query_times:  # short streams: still report a query figure
        s = time.perf_counter()
        q.can_reach(ref(0), ref(1))
        query_times.append(time.perf_counter() - s)
    wall = time.perf_counter() - s_all
    n_timed = svc.stats.events_seen - base_events
    n_solves = svc.stats.total_solves - base_solves
    value = n_timed / wall
    apply_band = _band(apply_times)
    query_band = _band(query_times)
    assert n_solves < n_timed, (
        f"lazy scheduling broken: {n_solves} solves for {n_timed} events"
    )
    # durability rider: what one atomic checkpoint costs, and what share
    # of the serving loop it would claim at an every-8-batches cadence
    ck_times = []
    with tempfile.TemporaryDirectory() as ckdir:
        cm = CheckpointManager(ckdir, retain=2)
        for _ in range(3):
            s = time.perf_counter()
            cm.checkpoint(svc.engine, log_offset=0, last_seq=-1)
            ck_times.append(time.perf_counter() - s)
    ck_band = _band(ck_times)
    ck_pct = 100.0 * ck_band["median_s"] / (
        8 * apply_band["median_s"] + ck_band["median_s"]
    )
    log(
        f"{n_timed} events in {wall:.2f}s = {value:.0f} events/s; "
        f"{n_solves} solves ({n_timed / max(1, n_solves):.1f} events/solve); "
        f"{svc.stats.events_coalesced} coalesced away; query median "
        f"{query_band['median_s'] * 1e3:.1f}ms; checkpoint median "
        f"{ck_band['median_s'] * 1e3:.1f}ms "
        f"({ck_pct:.1f}% overhead at every-8-batches)"
    )
    # the dense service engine runs no hand-written kernel, so this split
    # reports warm ~= cold for the serve cold path
    warm_fields = _warm_compile_split(
        t2 - t1, rerun=lambda: VerificationService(cluster, device=dev).reach(),
        kernel_builds=builds,
    )
    _emit(
        {
            "metric": (
                f"continuous serve: churn events through the coalescing "
                f"service, {n} pods / {args.policies} policies, "
                f"{args.n_events} events, 1 chip"
            ),
            "value": round(value, 1),
            "unit": "events/s",
            # target: ≥1k events/s sustained on the serving path
            "vs_baseline": round(value / 1000.0, 4),
            "apply_batch_band": apply_band,
            "query_band": query_band,
            "events_applied": svc.stats.events_applied,
            "events_coalesced": svc.stats.events_coalesced,
            "solves": svc.stats.solves,
            "events_per_solve": round(n_timed / max(1, n_solves), 2),
            "checkpoint_band": ck_band,
            "checkpoint_overhead_pct": round(ck_pct, 2),
            **warm_fields,
            "steady_s": round(apply_band["median_s"], 4),
        }
    )


def bench_posture(args) -> None:
    """Posture-plane overhead on the serving apply path: the same churn
    stream runs through two identical packed services — one bare, one
    with the posture tracker recording an exact reach delta per applied
    batch — and the gap is the observability tax. The two services take
    each batch in turn, the first of the two alternating from batch to
    batch, and the overhead is the ratio of their summed applies over an
    even number of batches, so the host's drift over the run falls on both
    sides alike and each goes first as often as second (the JAX bench runs
    one service after the other and compares the two runs' medians, where
    a host that slows between them reads as overhead).
    Emits the gated
    lower-is-better ``posture_overhead_pct`` (budget
    ``GATES["posture_overhead_pct"]``, 5% of the apply path) plus the
    ``posture_deltas_per_second`` throughput series, and asserts the budget
    inline so a run fails loudly rather than just recording the
    regression. Each packed build launches ``packed_dir_allow`` twice."""
    from .backends.base import VerifyConfig
    from .harness.generate import random_event_stream
    from .packed_incremental import PackedIncrementalVerifier
    from .serve import VerificationService

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    t0 = time.perf_counter()
    cluster = _generate(args)
    events = random_event_stream(cluster, n_events=args.n_events, seed=1)
    t1 = time.perf_counter()
    log(f"generate+stream {t1 - t0:.1f}s ({len(events)} events)")
    batch = 64
    batches = [events[i:i + batch] for i in range(0, len(events), batch)]

    def service(with_posture: bool):
        eng = PackedIncrementalVerifier(
            cluster, VerifyConfig(compute_ports=False), device=dev,
            keep_matrix=True,
        )
        svc = VerificationService(engine=eng)
        if with_posture:
            svc.enable_posture()
        # first batch absorbs each engine op's (and the delta's) first call
        # so the timed band is steady-state
        svc.apply(batches[0])
        return svc

    bare_svc, posture_svc = service(False), service(True)
    bare_times, posture_times = [], []
    for i, b in enumerate(batches[1:]):
        turns = [(bare_svc, bare_times), (posture_svc, posture_times)]
        for svc, times in turns[::-1] if i % 2 else turns:
            s = time.perf_counter()
            svc.apply(b)
            _sync(dev)
            times.append(time.perf_counter() - s)
    bare_band = _band(bare_times)
    posture_band = _band(posture_times)
    records = list(posture_svc.posture.records)
    deltas = [r for r in records if not r.baseline]
    # cross-check the incremental accounting against the bare service's
    # final matrix before trusting the timing comparison
    oracle = int(bare_svc.reach().sum())
    tracked = records[-1].reachable_pairs
    assert tracked == oracle, (
        f"posture accounting drifted: tracked {tracked} != oracle {oracle}"
    )
    bare_svc.close()
    posture_svc.close()
    # the two services' summed applies over an even number of batches, so
    # each went first as often as second (batches differ several-fold in
    # cost, so the two lists' medians may fall on different batches)
    even = len(bare_times) // 2 * 2
    overhead_pct = max(
        0.0, 100.0 * (sum(posture_times[:even]) / sum(bare_times[:even]) - 1.0))
    delta_s = [r.delta_s for r in deltas]
    delta_band = _band(delta_s)
    deltas_per_s = (
        len(deltas) / sum(delta_s) if sum(delta_s) > 0 else 0.0
    )
    log("apply batches, bare / posture ms in turn: " + ", ".join(
        f"{b * 1e3:.1f}/{p * 1e3:.1f}" for b, p in zip(bare_times, posture_times)))
    log(
        f"apply batch median {bare_band['median_s'] * 1e3:.2f}ms bare -> "
        f"{posture_band['median_s'] * 1e3:.2f}ms with posture; over {even} "
        f"batches each {overhead_pct:+.2f}%; delta median "
        f"{delta_band['median_s'] * 1e3:.2f}ms over {len(deltas)} "
        f"generations = {deltas_per_s:.0f} deltas/s"
    )
    # the budget from the posture plane's contract: the exact per-batch
    # reach delta must stay under 5% of the apply path at churn scale
    budget = GATES["posture_overhead_pct"]
    assert overhead_pct < budget, (
        f"posture delta overhead {overhead_pct:.2f}% breaches the "
        f"{budget:g}% apply-path budget"
    )
    _emit(
        {
            "metric": "posture_overhead_pct",
            "value": round(overhead_pct, 3),
            "unit": "pct",
            "pods": n,
            "policies": args.policies,
            "events": len(events),
            "generations": len(deltas),
            "apply_bare_band": bare_band,
            "apply_posture_band": posture_band,
            "delta_band": delta_band,
            "steady_s": round(posture_band["median_s"], 4),
        }
    )
    _emit(
        {
            "metric": "posture_deltas_per_second",
            "value": round(deltas_per_s, 1),
            "unit": "deltas/s",
            "pods": n,
            "policies": args.policies,
            "generations": len(deltas),
            "delta_band": delta_band,
            "steady_s": round(delta_band["median_s"], 6),
        }
    )


def _ingress_open_loop(
    ing, requests, rate_probes_s, duration_s, deadline_s
):
    """Drive one open-loop window: issue pre-built probe requests at
    ``rate_probes_s`` for ``duration_s`` regardless of completions (a
    thread pool absorbs in-flight requests so arrivals do not wait on
    answers), and account every outcome. Returns ``(offered_probes_s,
    stats)`` where stats carries goodput counts, typed-rejection
    accounting, client-observed latencies of answered requests and any
    deadline violations among them."""
    import concurrent.futures
    import math

    from .resilience.errors import AdmissionRejectedError

    per_request = len(requests[0])
    interval = per_request / rate_probes_s
    lock = threading.Lock()
    stats = {
        "answered_probes": 0,
        "rejected_probes": 0,
        "failed": 0,
        "reasons": {},
        "bad_retry_after": 0,
        "deadline_violations": 0,
        "latencies": [],
        "max_queued_probes": 0,
    }

    def one(probes):
        t0 = time.perf_counter()
        try:
            ing.submit(probes, deadline_s=deadline_s)
            lat = time.perf_counter() - t0
            with lock:
                stats["answered_probes"] += len(probes)
                stats["latencies"].append(lat)
                # grace for client-side thread wakeup: the guarantee is
                # about the server's dispatch, measured from submit entry
                if lat > deadline_s + 0.05:
                    stats["deadline_violations"] += 1
        except AdmissionRejectedError as e:
            typed = (
                math.isfinite(e.retry_after_s) and e.retry_after_s > 0.0
            )
            with lock:
                stats["rejected_probes"] += len(probes)
                stats["reasons"][e.reason] = (
                    stats["reasons"].get(e.reason, 0) + 1
                )
                if not typed:
                    stats["bad_retry_after"] += 1
        except Exception:  # an untyped failure is counted and gated below
            with lock:
                stats["failed"] += 1

    with concurrent.futures.ThreadPoolExecutor(max_workers=128) as ex:
        futs = []
        start = time.perf_counter()
        i = 0
        while True:
            now = time.perf_counter()
            if now - start >= duration_s:
                break
            target = start + i * interval
            if now < target:
                time.sleep(min(interval, target - now))
                continue
            futs.append(ex.submit(one, requests[i % len(requests)]))
            i += 1
            if i % 32 == 0:
                with lock:
                    stats["max_queued_probes"] = max(
                        stats["max_queued_probes"],
                        ing.describe()["queued_probes"],
                    )
        concurrent.futures.wait(futs, timeout=duration_s + deadline_s + 10.0)
        wall = time.perf_counter() - start
    offered = i * per_request / duration_s
    stats["goodput_probes_s"] = stats["answered_probes"] / wall
    return offered, stats


def bench_ingress(args) -> None:
    """Front-door ingress tier: open-loop arrival-rate sweep per fleet
    size. Thousands of few-probe client requests hit ``Ingress.submit``
    concurrently; the continuous batcher coalesces them into device-shaped
    ``can_reach_batch`` dispatches across a fleet of per-worker replica
    engines. Per fleet size the sweep records the latency/throughput
    curve, identifies the saturation knee (max goodput), and then pushes
    past it to verify the overload contract: goodput holds within 20% of
    the knee (``GATES``) while every excess request gets a typed rejection
    with a finite retry-after — no unbounded queue growth, no deadline
    violations among admitted requests. The service's engine is the dense
    one on ``--device``."""
    import itertools
    import random as _random

    from .serve import (
        AdmissionConfig,
        AdmissionController,
        Ingress,
        IngressConfig,
        QueryEngine,
        VerificationService,
    )

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    t0 = time.perf_counter()
    cluster = _generate(args)
    svc = VerificationService(cluster, device=dev)
    svc.reach()  # first derive: first calls out of the sweep figures
    pods = svc.engine.pods
    ref = lambda i: f"{pods[i % n].namespace}/{pods[i % n].name}"  # noqa: E731
    log(f"cluster + first solve {time.perf_counter() - t0:.1f}s")

    # pre-built client requests: 4 probes each, seeded hot-pair mix
    rng = _random.Random(7)
    per_request = 4
    requests = [
        [
            (ref(rng.randrange(n)), ref(rng.randrange(n)))
            for _ in range(per_request)
        ]
        for _ in range(512)
    ]
    deadline_s = 0.3

    class _FleetBackend:
        """One replica engine per batcher worker thread (the bench's
        stand-in for a follower fleet): each worker pins itself to its
        own QueryEngine on first dispatch, so fleet size N means N
        independently-cached replicas over the shared service."""

        def __init__(self, size):
            self._engines = [QueryEngine(svc) for _ in range(size)]
            self._local = threading.local()
            self._next = itertools.count()

        def can_reach_batch(self, probes):
            eng = getattr(self._local, "engine", None)
            if eng is None:
                eng = self._engines[
                    next(self._next) % len(self._engines)
                ]
                self._local.engine = eng
            return eng.can_reach_batch(probes)

    fleet_results = {}
    for fleet in (1, 2, 4):
        backend = _FleetBackend(fleet)
        # quotas wide open: this sweep measures the *door under load*
        # (deadline feasibility + bounded queue), not tenant pacing
        admission = AdmissionController(
            config=AdmissionConfig(
                max_concurrency=1 << 20,
                default_rate=1e12,
                default_burst=1e12,
            )
        )
        ing = Ingress(
            backend,
            config=IngressConfig(
                batch_size=256,
                max_wait_s=0.002,
                queue_depth=4096,
                default_deadline_s=deadline_s,
                workers=fleet,
                max_workers=max(8, fleet),
            ),
            admission=admission,
        ).start()
        try:
            # closed-loop warm + capacity probe: 8 clients back-to-back
            probe_stats = {"probes": 0}
            stop_at = time.perf_counter() + 0.35

            def pound():
                k = 0
                while time.perf_counter() < stop_at:
                    ing.submit(requests[k % len(requests)], deadline_s=2.0)
                    probe_stats["probes"] += per_request
                    k += 1

            s = time.perf_counter()
            clients = [
                threading.Thread(target=pound, daemon=True)
                for _ in range(8)
            ]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            capacity = probe_stats["probes"] / (time.perf_counter() - s)
            # open-loop sweep: fractions of capacity up past saturation
            sweep = []
            mults = (0.4, 0.7, 1.0, 1.5, 2.5)
            for mult in mults:
                offered, st = _ingress_open_loop(
                    ing, requests, capacity * mult, 0.3, deadline_s
                )
                band = _band(st["latencies"]) if st["latencies"] else {}
                sweep.append(
                    {
                        "offered_probes_s": round(offered, 1),
                        "goodput_probes_s": round(
                            st["goodput_probes_s"], 1
                        ),
                        "p50_ms": round(
                            band.get("median_s", 0.0) * 1e3, 2
                        ),
                        "max_ms": round(band.get("max_s", 0.0) * 1e3, 2),
                        "rejected_probes": st["rejected_probes"],
                        "reasons": st["reasons"],
                        "deadline_violations": st["deadline_violations"],
                        "bad_retry_after": st["bad_retry_after"],
                        "max_queued_probes": st["max_queued_probes"],
                        "failed": st["failed"],
                    }
                )
        finally:
            ing.close()
        knee = max(sweep, key=lambda row: row["goodput_probes_s"])
        post = sweep[-1]
        held = post["goodput_probes_s"] / max(1.0, knee["goodput_probes_s"])
        viol = sum(row["deadline_violations"] for row in sweep)
        bad_retry = sum(row["bad_retry_after"] for row in sweep)
        failed = sum(row["failed"] for row in sweep)
        max_depth = max(row["max_queued_probes"] for row in sweep)
        # the sweep rows go out before the gate's asserts, so a run that
        # fails the gate still shows whether the generator offered its
        # multiple of capacity (one JSON line per fleet)
        log("ingress-sweep " + json.dumps({
            "fleet": fleet,
            "capacity_probes_s": round(capacity, 1),
            "rows": [
                {"mult": mult,
                 "offered_over_capacity": round(
                     row["offered_probes_s"] / max(capacity, 1e-9), 4),
                 **row}
                for mult, row in zip(mults, sweep)
            ],
        }, sort_keys=True))
        assert viol <= GATES["ingress_deadline_violations"], (
            f"fleet {fleet}: {viol} admitted request(s) blew their deadline"
        )
        assert bad_retry == 0, (
            f"fleet {fleet}: {bad_retry} rejection(s) without a finite "
            "positive retry-after"
        )
        assert failed == 0, (
            f"fleet {fleet}: {failed} request(s) failed untyped"
        )
        assert max_depth <= 4096, (
            f"fleet {fleet}: queue grew to {max_depth} probes past its bound"
        )
        assert held >= GATES["ingress_post_knee_held"], (
            f"fleet {fleet}: post-knee goodput fell to {held:.2f}x of the "
            f"knee ({post['goodput_probes_s']:.0f} vs "
            f"{knee['goodput_probes_s']:.0f} probes/s) — overload is "
            "collapsing throughput instead of shedding at the door"
        )
        log(
            f"fleet {fleet}: capacity ~{capacity:,.0f} probes/s, knee "
            f"{knee['goodput_probes_s']:,.0f} at offered "
            f"{knee['offered_probes_s']:,.0f}, post-knee holds {held:.2f}x "
            f"({post['reasons']} sheds)"
        )
        fleet_results[fleet] = {
            "capacity_probes_s": round(capacity, 1),
            "knee_probes_s": knee["goodput_probes_s"],
            "knee_offered_probes_s": knee["offered_probes_s"],
            "post_knee_held": round(held, 3),
            "sweep": sweep,
        }
    top = fleet_results[4]
    _emit(
        {
            "metric": (
                f"ingress front door: open-loop arrival sweep through the "
                f"continuous batcher, {n} pods / {args.policies} policies, "
                f"4-probe requests, fleet 1/2/4, cpu-ok"
            ),
            "value": top["knee_probes_s"],
            "unit": "probes/s",
            # target: ≥10k probes/s through the door at the 4-worker knee
            "vs_baseline": round(top["knee_probes_s"] / 10_000.0, 4),
            "post_knee_held": top["post_knee_held"],
            "deadline_s": deadline_s,
            "fleets": {str(k): v for k, v in fleet_results.items()},
        }
    )
    # explicit-direction series for the history gate: the knee gates
    # higher-is-better per fleet size (unit ".../s"), the held ratio
    # rides ungated as context
    for fleet, res in fleet_results.items():
        _emit(
            {
                "metric": f"ingress_knee_fleet{fleet}_probes_per_second",
                "value": res["knee_probes_s"],
                "unit": "probes/s",
                "post_knee_held": res["post_knee_held"],
                "capacity_probes_s": res["capacity_probes_s"],
            }
        )


#: above this the dense [N,N] int32 count matrices stop being a sane
#: single-card comparator (2 × 4 GB at 32k pods); --mode query drops to
#: packed-only with a log line instead of running out of memory
_DENSE_QUERY_LIMIT = 32_768


def bench_query(args) -> None:
    """Batched query engine throughput: answer a mixed probe workload (95%%
    any-port with an 80/20 hot-source skew, 5%% port-refined on a
    hot-pair set) through ``QueryEngine.can_reach_batch`` — one device
    dispatch per batch, generation-keyed row/port caching — against a loop
    of scalar ``can_reach`` calls over the same distribution. Runs the
    workload on the requested engines (``--engine dense|packed|both``): the
    packed run serves straight from device-resident int32 word rows
    (matrix-free — the regime that scales to the 100k-pod config
    ``--pods 100000 --engine packed``; its build launches
    ``packed_dir_allow`` twice) and the two blended figures are compared
    head to head. Headline value per engine is steady-state queries/s on a
    dirty engine; per-batch p50/p99 latency, cold-cache and post-churn
    figures, the measured scalar comparison, and the steady-window
    host-to-device byte delta (``query_h2d_bytes`` — flat at 0 when engine
    state is device-resident) ride along."""
    import numpy as np

    from .backends.base import VerifyConfig
    from .harness.generate import random_event_stream
    from .observe.metrics import QUERY_CACHE_MISSES_TOTAL, QUERY_H2D_BYTES_TOTAL
    from .packed_incremental import PackedIncrementalVerifier
    from .serve import QueryEngine, VerificationService

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    engines = (
        ["dense", "packed"] if args.engine == "both" else [args.engine]
    )
    if "dense" in engines and n > _DENSE_QUERY_LIMIT:
        gb = 2 * n * n * 4 / 1e9
        log(
            f"dense engine skipped at {n} pods (the two [N,N] int32 count "
            f"matrices alone are {gb:.0f} GB); running packed only"
        )
        engines = [e for e in engines if e != "dense"]
        if not engines:
            engines = ["packed"]
    t0 = time.perf_counter()
    cluster = _generate(args)
    events = random_event_stream(cluster, n_events=128, seed=5)
    t1 = time.perf_counter()
    pods = cluster.pods
    ref = lambda i: f"{pods[i % n].namespace}/{pods[i % n].name}"  # noqa: E731
    log(f"generate {t1 - t0:.1f}s")

    # mixed workload, the admission-control shape: 95% any-port probes
    # whose sources follow an 80/20 hot-set skew, plus 5% port-refined
    # probes drawn from 16 hot (src, dst) pairs x 3 ports
    rng = np.random.default_rng(7)
    hot = [(int(a), int(b)) for a, b in rng.integers(0, n, (16, 2))]
    hot_ports = (80, 443, 5432)
    hot_src = rng.integers(0, n, min(512, n))
    sub = 512
    n_batches = max(2, args.n_queries // sub)

    def make_batch(seed: int):
        rs = np.random.default_rng(1000 + seed)
        out = []
        for _ in range(sub):
            if rs.random() < 0.05:
                s, d = hot[int(rs.integers(len(hot)))]
                out.append(
                    (ref(s), ref(d), int(rs.choice(hot_ports)), "TCP")
                )
            else:
                if rs.random() < 0.8:
                    s = int(hot_src[int(rs.integers(hot_src.size))])
                else:
                    s = int(rs.integers(n))
                out.append((ref(s), ref(int(rs.integers(n)))))
        return out

    def make_service(kind):
        if kind == "packed":
            return VerificationService(
                engine=PackedIncrementalVerifier(
                    cluster,
                    VerifyConfig(compute_ports=False),
                    device=dev,
                    keep_matrix=False,
                )
            )
        svc = VerificationService(cluster, device=dev)
        svc.reach()  # first derive: first calls out of the steady figures
        return svc

    batches = [make_batch(k) for k in range(n_batches)]
    blended: dict = {}
    for kind in engines:
        t2 = time.perf_counter()
        b0 = _nvcc_runs()
        svc = make_service(kind)
        q = QueryEngine(svc)
        _sync(dev)
        t3 = time.perf_counter()
        builds = _nvcc_runs() - b0
        log(f"[{kind}] service init+first solve {t3 - t2:.1f}s")
        svc.apply(events[:64])  # dirty the engine: the serving regime
        q.can_reach_batch(batches[0])  # first calls + cache fill
        # cold figure: a fresh engine's first batch — all rows miss, one
        # dispatch, port groups solved once
        qc = QueryEngine(svc)
        s = time.perf_counter()
        qc.can_reach_batch(batches[0])
        cold_s = time.perf_counter() - s
        # steady state: warm generation-keyed cache, engine still dirty;
        # the H2D counter delta across this window is the residency
        # claim — engine state already lives on the device, so warm
        # batches must transfer nothing
        h2d_before = QUERY_H2D_BYTES_TOTAL.labels(kind=kind).value
        miss_before = QUERY_CACHE_MISSES_TOTAL.labels(kind="rows").value
        lat = []
        s_all = time.perf_counter()
        for b in batches:
            s = time.perf_counter()
            q.can_reach_batch(b)
            lat.append(time.perf_counter() - s)
        wall = time.perf_counter() - s_all
        h2d_steady = (
            QUERY_H2D_BYTES_TOTAL.labels(kind=kind).value - h2d_before
        )
        rows_steady = (
            QUERY_CACHE_MISSES_TOTAL.labels(kind="rows").value
            - miss_before
        )
        n_timed = n_batches * sub
        value = n_timed / wall
        lat_sorted = sorted(lat)
        p50 = lat_sorted[len(lat_sorted) // 2]
        p99 = lat_sorted[
            min(len(lat_sorted) - 1, int(len(lat_sorted) * 0.99))
        ]
        batch_band = _band(lat)
        log(
            f"[{kind}] {n_timed} mixed queries in {wall * 1e3:.1f}ms = "
            f"{value:,.0f} queries/s (batch={sub}: p50 {p50 * 1e3:.2f}ms "
            f"p99 {p99 * 1e3:.2f}ms; cold batch {cold_s * 1e3:.1f}ms; "
            f"steady-window H2D {h2d_steady:,.0f} bytes)"
        )

        # scalar comparator on the SAME distribution, measured per call.
        # The scalar loop is given its best case: the first can_reach pays
        # the full lazy solve / row gather (excluded), later any-port
        # calls read the clean matrix (dense) or cached word rows
        # (packed). Blend per the 95/5 workload mix.
        q.can_reach(ref(0), ref(1))  # pays the solve; now warm
        sc_any = []
        rs = np.random.default_rng(2)
        for _ in range(512):
            a, b = rs.integers(0, n, 2)
            s = time.perf_counter()
            q.can_reach(ref(int(a)), ref(int(b)))
            sc_any.append(time.perf_counter() - s)
        sc_port = []
        for k in range(4):
            hs, hd = hot[k]
            s = time.perf_counter()
            q.can_reach(ref(hs), ref(hd), port=hot_ports[k % 3])
            sc_port.append(time.perf_counter() - s)
        any_med = sorted(sc_any)[len(sc_any) // 2]
        port_med = sorted(sc_port)[len(sc_port) // 2]
        scalar_per_query = 0.95 * any_med + 0.05 * port_med
        scalar_qps = 1.0 / scalar_per_query
        speedup = value / scalar_qps
        speedup_any = value * any_med
        log(
            f"[{kind}] scalar loop: any-port {any_med * 1e6:.1f}us/query, "
            f"ported {port_med * 1e3:.1f}ms/query -> blended "
            f"{scalar_qps:,.0f} queries/s; batched speedup {speedup:.0f}x "
            f"(vs pure any-port loop {speedup_any:.0f}x)"
        )

        # post-churn rider: another applied batch bumps the generation,
        # the cache drops, and the next batch re-gathers rows
        svc.apply(events[64:])
        s = time.perf_counter()
        q.can_reach_batch(batches[0])
        churn_s = time.perf_counter() - s
        log(
            f"[{kind}] first batch after churn (cache invalidated): "
            f"{churn_s * 1e3:.1f}ms"
        )
        warm_fields = _warm_compile_split(
            t3 - t2, rerun=lambda kind=kind: make_service(kind),
            kernel_builds=builds,
        )
        tag = "packed batched" if kind == "packed" else "batched"
        record = {
            "metric": (
                f"{tag} queries_per_second: mixed 95/5 any-port/ported "
                f"can_reach_batch, {n} pods / {args.policies} policies, "
                f"batch {sub}, 1 chip"
            ),
            "value": round(value, 1),
            "unit": "queries/s",
            # target: >=100k queries/s on one card
            "vs_baseline": round(value / 100_000.0, 4),
            "batch_band": batch_band,
            "p50_ms": round(p50 * 1e3, 3),
            "p99_ms": round(p99 * 1e3, 3),
            "cold_batch_ms": round(cold_s * 1e3, 2),
            "post_churn_batch_ms": round(churn_s * 1e3, 2),
            "scalar_any_us": round(any_med * 1e6, 2),
            "scalar_ported_ms": round(port_med * 1e3, 2),
            "scalar_queries_per_s": round(scalar_qps, 1),
            "speedup_vs_scalar": round(speedup, 1),
            "speedup_vs_scalar_any_port": round(speedup_any, 1),
            "query_h2d_bytes": float(h2d_steady),
            **warm_fields,
            "steady_s": round(batch_band["median_s"], 4),
        }
        if kind == "packed":
            # roofline accounting: a packed row gather contracts every
            # missed source row against the per-policy int8 maps (ingress
            # + egress blocks) over the padded pod axis; a near-zero MAC
            # count is the point — warm batches answer from cached rows
            npad = int(svc.engine._n_padded)
            record["macs"] = rows_steady * float(npad) * 2.0 * float(
                args.policies
            )
            record["macs_basis"] = (
                "rows_missed_steady * n_padded * 2 * n_policies "
                "(packed per-policy int8 contractions)"
            )
        _emit(record)
        blended[kind] = (value, scalar_qps)
        svc.close()
        del svc, q, qc
    if len(blended) == 2:
        dv, pv = blended["dense"][0], blended["packed"][0]
        log(
            f"packed vs dense blended QPS: {pv:,.0f} vs {dv:,.0f} "
            f"({pv / dv:.2f}x) at {n} pods"
        )


def _replicate_worker(ck_dir, log_path, idx, n_batches, barrier, out_q, device):
    """Subprocess body for ``--mode replicate`` (module-level for spawn).

    Bootstraps a :class:`FollowerService` from the leader's checkpoint
    directory on ``device`` (the bench's ``--device``: processes share a
    card), catches up to the WAL tip, warms the batched-query path, then
    waits at the barrier so every replica's timed window overlaps.
    """
    import numpy as np

    from .serve import FollowerService

    f = FollowerService(
        ck_dir, log_path=log_path, replica=f"replica-{idx}",
        auto_catch_up=False, device=device,
    )
    f.catch_up()
    f.service.reach(trigger="query")  # solve once; reads come from the matrix
    n = f.service.n_pods
    pods = f.service.engine.pods
    ref = lambda i: f"{pods[i % n].namespace}/{pods[i % n].name}"  # noqa: E731
    rs = np.random.default_rng(9000 + idx)
    sub = 512
    batches = [
        [
            (ref(int(a)), ref(int(b)))
            for a, b in rs.integers(0, n, (sub, 2))
        ]
        for _ in range(n_batches)
    ]
    f.can_reach_batch(batches[0])  # first call + generation-keyed cache fill
    lag = f.lag()
    barrier.wait(timeout=300)
    s = time.perf_counter()
    for b in batches:
        f.can_reach_batch(b)
    elapsed = time.perf_counter() - s
    out_q.put(
        {
            "replica": f.replica,
            "queries": n_batches * sub,
            "elapsed_s": elapsed,
            "qps": (n_batches * sub) / elapsed,
            "bootstrap_lag_seconds": lag.seconds,
            "outcome": f.recovery.outcome,
        }
    )


def _replicate_net_worker(url, base_dir, idx, n_batches, barrier, out_q, device):
    """Subprocess body for ``--mode replicate --net`` (module-level for
    spawn): a networked follower on ``device`` — checkpoint shipped over
    HTTP, WAL tailed into a local byte mirror — answering batched queries
    while the leader keeps appending churn through the timed window. Each
    batch is preceded by a poll(), so the measured queries/s pays for
    tailing, and the lag reported is the end-of-window lag *under* churn,
    not after a final quiesced catch-up."""
    import numpy as np

    from .observe.spans import add_span_sink
    from .serve import FollowerService

    f = FollowerService(
        os.path.join(base_dir, f"net-replica-{idx}"),
        replica=f"net-replica-{idx}",
        leader_url=url,
        auto_catch_up=False,
        device=device,
    )
    f.catch_up()
    f.service.reach(trigger="query")
    n = f.service.n_pods
    pods = f.service.engine.pods
    ref = lambda i: f"{pods[i % n].namespace}/{pods[i % n].name}"  # noqa: E731
    rs = np.random.default_rng(9500 + idx)
    sub = 512
    half = max(1, n_batches // 2)
    batches = [
        [
            (ref(int(a)), ref(int(b)))
            for a, b in rs.integers(0, n, (sub, 2))
        ]
        for _ in range(2 * half)
    ]
    f.can_reach_batch(batches[0])  # first call + generation-keyed cache fill

    # per-stage latency collection: the query pipeline's queue/dispatch/
    # solve/d2h spans carry a `stage` attr; a span sink is cheaper and
    # exacter than re-parsing the registry's histogram buckets
    stage_seconds = {}

    def _stage_sink(span):
        stage = span.attrs.get("stage")
        if stage and span.seconds is not None:
            stage_seconds.setdefault(stage, []).append(span.seconds)

    add_span_sink(_stage_sink)

    def _window(window_batches):
        s = time.perf_counter()
        for b in window_batches:
            f.poll()  # keep tailing the churn the leader is appending
            f.can_reach_batch(b)
        return time.perf_counter() - s

    barrier.wait(timeout=300)
    elapsed = _window(batches[:half])  # window A: unpolled
    barrier.wait(timeout=300)  # parent arms the 1 Hz /metrics poller here
    elapsed_polled = _window(batches[half:])  # window B: scraped at 1 Hz
    lag = f.lag()
    out_q.put(
        {
            "replica": f.replica,
            "queries": half * sub,
            "elapsed_s": elapsed,
            "qps": (half * sub) / elapsed,
            "qps_polled": (half * sub) / elapsed_polled,
            "lag_seconds": lag.seconds,
            "lag_seq": lag.seq,
            "applied": f.applied,
            "outcome": f.recovery.outcome,
            "stage_seconds": stage_seconds,
        }
    )


def _join_all(procs) -> None:
    """Wait for the follower processes, and end any that outlive the wait."""
    for p in procs:
        p.join(timeout=60)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)


def _bench_replicate_net(args, svc, writer, workdir, ck_dir, log_path, n_batches):
    """The ``--net`` leg of replicate mode: one in-process
    :class:`ReplicationServer` over the leader's checkpoint directory and
    WAL, four spawn-process followers bootstrapping over HTTP, and the
    leader appending relabel churn from a thread for as long as the
    followers' timed windows run."""
    import multiprocessing as mp

    import numpy as np

    from .serve import ReplicationClient, ReplicationServer, UpdatePodLabels

    replicas = 4
    ctx = mp.get_context("spawn")
    pods = svc.engine.pods
    n_now = svc.n_pods

    def _relabel(k):
        p = pods[k % n_now]
        labels = dict(p.labels)
        labels["bench-net-churn"] = str(k)
        return UpdatePodLabels(
            namespace=p.namespace, pod=p.name, labels=labels
        )

    with ReplicationServer(ck_dir, log_path) as server:
        log(f"replication server: {server.url}; {replicas} networked followers")
        barrier = ctx.Barrier(replicas + 1)
        out_q = ctx.Queue()
        procs = [
            ctx.Process(
                target=_replicate_net_worker,
                args=(server.url, workdir, idx, n_batches, barrier, out_q,
                      args.device),
            )
            for idx in range(replicas)
        ]
        for p in procs:
            p.start()
        try:
            barrier.wait(timeout=300)  # every follower bootstrapped and warm
            stop = threading.Event()

            def _churn():
                k = 0
                while not stop.is_set():
                    writer.append([_relabel(k)])
                    k += 1
                    time.sleep(0.005)

            churner = threading.Thread(target=_churn, daemon=True)
            churner.start()

            # window B's observability tax: a 1 Hz /metrics poller against
            # the leader's scrape surface, armed between the followers' two
            # timed windows (the second barrier), so qps vs qps_polled
            # isolates the scrape-path overhead under otherwise identical
            # load
            scrape_stop = threading.Event()
            scrapes = [0]

            def _scrape():
                client = ReplicationClient(server.url)
                while not scrape_stop.is_set():
                    try:
                        # exemplar-annotated rendering is the expensive
                        # path; polling it keeps exemplars inside the same
                        # budget
                        client.metrics_text(exemplars=True)
                        scrapes[0] += 1
                    except Exception:
                        pass  # an overloaded scrape is itself the datum
                    scrape_stop.wait(1.0)

            scraper = threading.Thread(target=_scrape, daemon=True)
            barrier.wait(timeout=300)  # release the followers into window B
            scraper.start()
            results = [out_q.get(timeout=300) for _ in procs]
            stop.set()
            scrape_stop.set()
            churner.join(timeout=30)
            scraper.join(timeout=30)
        finally:
            _join_all(procs)
    writer.close()
    agg = sum(r["qps"] for r in results)
    lags = [r["lag_seconds"] for r in results]
    spread = max(lags) - min(lags)
    per = ", ".join(f"{r['qps']:,.0f}" for r in results)
    log(
        f"{replicas} networked follower(s) under sustained churn: aggregate "
        f"{agg:,.0f} queries/s ({per}); lag max {max(lags):.3f}s "
        f"spread {spread:.3f}s"
    )
    _emit(
        {
            "metric": (
                f"networked replicated serving: {replicas} HTTP followers "
                f"under sustained leader churn, {args.pods} pods / "
                f"{args.policies} policies, batch 512, cpu"
            ),
            "value": round(agg, 1),
            "unit": "queries/s",
            "replicas": results,
        }
    )
    # explicit-direction series for the history gate: throughput gates
    # higher by its rate-shaped name/unit, the lag series lower by unit,
    # the spread lower by NAME (observe/history.py)
    _emit(
        {
            "metric": "net_aggregate_queries_per_second",
            "value": round(agg, 1),
            "unit": "queries/s",
            "replicas": replicas,
        }
    )
    _emit(
        {
            "metric": "net_replica_lag_seconds",
            "value": round(max(lags), 4),
            "unit": "s",
            "replicas": replicas,
        }
    )
    _emit(
        {
            "metric": "replica_lag_spread_seconds",
            "value": round(spread, 4),
            "unit": "s",
            "replicas": replicas,
            "net": True,
        }
    )
    # per-stage latency percentiles: the queue/dispatch/solve/d2h spans
    # inside every batched query, pooled across followers and windows
    stages = {}
    for r in results:
        for stage, samples in r.pop("stage_seconds", {}).items():
            stages.setdefault(stage, []).extend(samples)
    for stage in sorted(stages):
        samples = np.asarray(stages[stage])
        p50, p99 = np.percentile(samples, [50, 99])
        log(
            f"stage {stage}: p50 {p50 * 1e3:.3f}ms p99 {p99 * 1e3:.3f}ms "
            f"({samples.size} samples)"
        )
        for q, v in (("p50", p50), ("p99", p99)):
            _emit(
                {
                    "metric": f"net_stage_latency_{stage}_{q}_s",
                    "value": round(float(v), 6),
                    "unit": "s",
                    "samples": int(samples.size),
                    "replicas": replicas,
                }
            )
    # the observability tax: same load, window B scraped at 1 Hz — gated
    # lower-is-better by name (observe/history.py)
    agg_polled = sum(r["qps_polled"] for r in results)
    overhead_pct = max(0.0, (agg - agg_polled) / agg * 100.0)
    log(
        f"scrape overhead: {overhead_pct:.2f}% "
        f"({agg:,.0f} -> {agg_polled:,.0f} queries/s with {scrapes[0]} "
        f"/metrics scrapes at 1 Hz)"
    )
    _emit(
        {
            "metric": "net_scrape_overhead_pct",
            "value": round(overhead_pct, 3),
            "unit": "pct",
            "scrapes": scrapes[0],
            "qps_unpolled": round(agg, 1),
            "qps_polled": round(agg_polled, 1),
            "replicas": replicas,
        }
    )


def bench_replicate(args) -> None:
    """Replicated-serving read scaling: one leader writes the WAL (epoch-
    stamped, lease-renewed, checkpointed mid-stream), then 1 -> 2 -> 4
    follower processes bootstrap from the checkpoint, tail to the tip and
    answer independent batched-query workloads concurrently. The baseline
    is the honest alternative architecture — ONE read/write service
    interleaving churn with queries, where every write bumps the
    generation and invalidates the query cache, so every batch re-gathers
    rows. Headline is the 4-replica aggregate queries/s (gated
    higher-is-better as ``aggregate_queries_per_second``); the
    single-service figure, per-group aggregates and the max bootstrap
    replica lag ride along (``replica_lag_seconds`` gates
    lower-is-better). The followers are spawned processes on the bench's
    ``--device`` (CUDA lets several processes share one card; ``--device
    cpu`` gives every replica the host), so none inherits the parent's
    CUDA state."""
    import multiprocessing as mp
    import tempfile

    import numpy as np

    from .harness.generate import random_event_stream
    from .serve import (
        CheckpointManager,
        LeaseFile,
        QueryEngine,
        UpdatePodLabels,
        VerificationService,
        WalWriter,
    )

    dev = _dev(args)
    _log_device(dev)
    log(f"replicas run on {args.device}")
    n = args.pods
    t0 = time.perf_counter()
    cluster = _generate(args)
    events = random_event_stream(cluster, n_events=args.n_events, seed=5)
    workdir = tempfile.mkdtemp(prefix="kvtpu-replicate-")
    log_path = os.path.join(workdir, "events.jsonl")
    ck_dir = os.path.join(workdir, "ck")
    svc = VerificationService(cluster, device=dev)
    os.makedirs(ck_dir, exist_ok=True)
    lease = LeaseFile(ck_dir)
    lease.acquire("bench-leader", ttl=60.0)
    writer = WalWriter(log_path, epoch=1, lease=lease)
    cm = CheckpointManager(ck_dir)
    mid = len(events) // 2
    for i, ev in enumerate(events):
        writer.append([ev])
        svc.apply([ev])
        if i == mid:
            cm.checkpoint(
                svc.engine, log_path=log_path,
                log_offset=writer.offset, last_seq=writer.next_seq - 1,
            )
    t1 = time.perf_counter()
    log(
        f"leader: {len(events)} events appended at epoch 1, checkpoint at "
        f"seq {mid} in {t1 - t0:.1f}s -> {workdir}"
    )
    if getattr(args, "net", False):
        # networked leg: the writer stays open — the leader keeps churning
        # through the followers' timed windows
        n_batches = max(2, args.n_queries // 512)
        return _bench_replicate_net(
            args, svc, writer, workdir, ck_dir, log_path, n_batches
        )
    tip_offset, tip_seq = writer.offset, writer.next_seq - 1
    writer.close()

    ctx = mp.get_context("spawn")
    n_batches = max(2, args.n_queries // 512)

    # baseline: the single read/write service. Churn keeps flowing (one
    # relabel per query batch — the gentlest possible write load), and
    # every write bumps the generation, so every batch re-gathers its rows
    # on a dirty engine. This is what serving looks like WITHOUT replicas.
    pods = svc.engine.pods
    n_now = svc.n_pods
    ref = lambda i: f"{pods[i % n_now].namespace}/{pods[i % n_now].name}"  # noqa: E731
    rs = np.random.default_rng(77)
    base_batches = [
        [(ref(int(a)), ref(int(b))) for a, b in rs.integers(0, n_now, (512, 2))]
        for _ in range(n_batches)
    ]

    def _relabel(k):
        p = pods[k % n_now]
        labels = dict(p.labels)
        labels["bench-churn"] = str(k)
        return UpdatePodLabels(namespace=p.namespace, pod=p.name, labels=labels)

    svc.reach(trigger="query")
    q = QueryEngine(svc)
    q.can_reach_batch(base_batches[0])  # first call
    s = time.perf_counter()
    for k, b in enumerate(base_batches):
        svc.apply([_relabel(k)])
        q.can_reach_batch(b)
    base_elapsed = time.perf_counter() - s
    single = (n_batches * 512) / base_elapsed
    log(
        f"single read/write service (churn interleaved, cache invalidated "
        f"per batch): {single:,.0f} queries/s"
    )
    groups = {}
    for replicas in (1, 2, 4):
        barrier = ctx.Barrier(replicas + 1)
        out_q = ctx.Queue()
        procs = [
            ctx.Process(
                target=_replicate_worker,
                args=(ck_dir, log_path, idx, n_batches, barrier, out_q,
                      args.device),
            )
            for idx in range(replicas)
        ]
        for p in procs:
            p.start()
        try:
            barrier.wait(timeout=300)  # every replica warm before any timing
            results = [out_q.get(timeout=300) for _ in procs]
        finally:
            _join_all(procs)
        agg = sum(r["qps"] for r in results)
        groups[replicas] = {
            "aggregate_qps": round(agg, 1),
            "replicas": results,
        }
        per = ", ".join(f"{r['qps']:,.0f}" for r in results)
        log(f"{replicas} replica(s): aggregate {agg:,.0f} queries/s ({per})")
    quad = groups[4]["aggregate_qps"]
    scaling = quad / single if single else 0.0
    max_lag = max(
        r["bootstrap_lag_seconds"]
        for g in groups.values()
        for r in g["replicas"]
    )
    # per-follower lag spread over the 4-replica group: a fleet whose
    # slowest member lags its fastest signals skewed bootstrap/tailing
    # even when the max lag alone looks fine
    quad_lags = [
        r["bootstrap_lag_seconds"] for r in groups[4]["replicas"]
    ]
    lag_spread = max(quad_lags) - min(quad_lags)
    log(
        f"4-replica aggregate vs single read/write service: {scaling:.2f}x "
        f"(max bootstrap lag {max_lag:.3f}s, spread {lag_spread:.3f}s)"
    )
    _emit(
        {
            "metric": (
                f"replicated serving aggregate throughput: 4 follower "
                f"processes vs one churn-interleaved service, {n} pods / "
                f"{args.policies} policies, batch 512, cpu"
            ),
            "value": round(quad, 1),
            "unit": "queries/s",
            "vs_baseline": round(scaling, 3),
            "single_service_qps": round(single, 1),
            "scaling_vs_single_service": round(scaling, 3),
            "groups": {str(k): v for k, v in groups.items()},
        }
    )
    # explicit-direction series for the history gate (observe/history.py):
    # the 4-replica aggregate gates higher-is-better by NAME, the replica
    # lag lower-is-better
    _emit(
        {
            "metric": "aggregate_queries_per_second",
            "value": round(quad, 1),
            "unit": "queries/s",
            "replicas": 4,
            "scaling_vs_single_service": round(scaling, 3),
        }
    )
    _emit(
        {
            "metric": "replica_lag_seconds",
            "value": round(max_lag, 4),
            "unit": "s",
            "replicas": 4,
        }
    )
    _emit(
        {
            "metric": "replica_lag_spread_seconds",
            "value": round(lag_spread, 4),
            "unit": "s",
            "replicas": 4,
        }
    )

    # warm-start SLO riders: a tip checkpoint ships the warm kernel pack
    # (the built libraries), then a FRESH follower — every loaded library
    # forgotten, an empty build directory — resumes from it and answers
    # its first batch, promotes, and answers again. Both series gate
    # lower-is-better by NAME (observe/history.py).
    from .observe import aot
    from .ops import cuda_build
    from .serve import FollowerService

    # rehearse the follower's exact sequence on the leader first: a fresh
    # QueryEngine's first batch and a second one of the same generation
    q2 = QueryEngine(svc)
    q2.can_reach_batch(base_batches[0])
    q2.can_reach_batch(base_batches[1 % len(base_batches)])
    cm.checkpoint(
        svc.engine, log_path=log_path, log_offset=tip_offset,
        last_seq=tip_seq,
    )
    build_dir = cuda_build.BUILD_DIR
    empty = tempfile.mkdtemp(prefix="kvtpu-replicate-build-")
    if aot.aot_enabled():
        # the resumed follower starts from the pack alone
        cuda_build.BUILD_DIR = empty
        aot.drop_executables()
    try:
        miss0 = aot.miss_total()
        s = time.perf_counter()
        f = FollowerService(
            ck_dir, log_path=log_path, replica="slo-follower",
            auto_catch_up=False, device=dev,
        )
        f.catch_up()
        f.can_reach_batch(base_batches[0])
        _sync(dev)
        resume_s = time.perf_counter() - s
        resume_miss = int(aot.miss_total() - miss0)
        miss0 = aot.miss_total()
        s = time.perf_counter()
        w2 = f.promote()
        f.can_reach_batch(base_batches[1 % len(base_batches)])
        _sync(dev)
        promote_s = time.perf_counter() - s
        promote_miss = int(aot.miss_total() - miss0)
        if w2 is not None:
            w2.close()
    finally:
        cuda_build.BUILD_DIR = build_dir
        aot.drop_executables()
        import shutil

        shutil.rmtree(empty, ignore_errors=True)
        shutil.rmtree(workdir, ignore_errors=True)
    log(
        f"warm-start SLO: resume->first answer {resume_s:.2f}s "
        f"({resume_miss} aot misses), promote->first answer "
        f"{promote_s:.2f}s ({promote_miss} aot misses)"
    )
    if aot.aot_enabled() and (resume_miss or promote_miss):
        log(
            "WARM-PATH AOT MISSES on resume/promote — the pack did not "
            "cover the follower's kernels; inspect observe/aot.py"
        )
    _emit(
        {
            "metric": "resume_to_first_answer_s",
            "value": round(resume_s, 3),
            "unit": "s",
            "aot_misses": resume_miss,
            "aot_warm": bool(aot.aot_enabled()),
        }
    )
    _emit(
        {
            "metric": "promote_to_first_answer_s",
            "value": round(promote_s, 3),
            "unit": "s",
            "aot_misses": promote_miss,
            "aot_warm": bool(aot.aot_enabled()),
        }
    )


def bench_dense(args) -> None:
    """``--mode k8s`` / ``--mode kano``: the dense research solves at 10k
    pods, ``ops/reach.py``'s ``k8s_reach`` / ``kano_reach`` as the ``torch``
    backend (``backends/device.py``) calls them, under its dispatch
    tracker's ``_k8s_step`` / ``_kano_step`` keys. No hand-written kernel
    is on their path. Steady-state throughput: K solves queued, one
    synchronisation at the end."""
    from .backends.device import _TRACKER
    from .encode.encoder import encode_cluster, encode_kano
    from .harness.generate import GeneratorConfig, random_cluster, random_kano
    from .observe import tree_nbytes
    from .observe.introspect import maybe_publish
    from .ops.match import as_tensors
    from .ops.reach import k8s_reach, kano_reach

    import torch

    dev = _dev(args)
    _log_device(dev)
    n = args.pods
    t0 = time.perf_counter()
    if args.mode == "k8s":
        cluster = random_cluster(
            GeneratorConfig(
                n_pods=n,
                n_policies=args.policies,
                n_namespaces=args.namespaces,
                p_ipblock_peer=0.0,  # host-side ip matching isn't the kernel
                seed=0,
            )
        )
        t1 = time.perf_counter()
        # port atoms off for the headline run: the (N, N·Q) count tile
        # would not fit at 10k pods × hundreds of atoms
        enc = encode_cluster(cluster, compute_ports=False)
        t2 = time.perf_counter()
        put = lambda x: None if x is None else torch.as_tensor(x, device=dev)  # noqa: E731
        dev_args = (
            put(enc.pod_kv), put(enc.pod_key), put(enc.pod_ns),
            put(enc.ns_kv), put(enc.ns_key),
            as_tensors(enc.pol_sel, dev), put(enc.pol_ns),
            put(enc.pol_affects_ingress), put(enc.pol_affects_egress),
            as_tensors(enc.ingress, dev), as_tensors(enc.egress, dev),
            put(enc.restrict_bank),
        )
        kwargs = dict(
            self_traffic=True,
            default_allow_unselected=True,
            direction_aware_isolation=True,
        )
        key = "_k8s_step"
        static = (True, True, True, False)

        def step(a):
            return k8s_reach(*a, **kwargs)
    else:
        containers, policies = random_kano(n, args.policies, seed=0)
        t1 = time.perf_counter()
        enc = encode_kano(containers, policies)
        t2 = time.perf_counter()
        put = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        dev_args = (
            put(enc.pod_kv), put(enc.src_req), put(enc.src_impossible),
            put(enc.dst_req), put(enc.dst_impossible),
        )
        kwargs = {}
        key = "_kano_step"
        static = (False,)

        def step(a):
            return kano_reach(*a)

    _sync(dev)
    t3 = time.perf_counter()
    log(f"generate {t1 - t0:.2f}s  encode {t2 - t1:.2f}s  transfer {t3 - t2:.2f}s")

    b0 = _nvcc_runs()
    _TRACKER.track(key, enc, static=static)
    out = step(dev_args)  # first run
    _sync(dev)
    t4 = time.perf_counter()
    builds = _nvcc_runs() - b0
    log(f"first run {t4 - t3:.2f}s")
    pairs = float(n) * float(n)
    macs_extra = {}
    if args.mode == "k8s":
        macs_extra = {
            "macs": pairs * (enc.ingress.n + enc.egress.n),
            "macs_basis": "n_pods^2 * (ingress_grants + egress_grants)",
        }
    # --introspect: this mode calls the solve directly (no tracker cost),
    # so publish its analytic report here: the contraction's operations
    # (one MAC per pair and grant row, k8s, or per pair and policy, kano),
    # the operands read and the [N, N] bool matrix written
    rows = enc.ingress.n + enc.egress.n if args.mode == "k8s" else len(policies)
    cost = (2 * n * n * rows, tree_nbytes(dev_args) + n * n)
    maybe_publish(
        "bench", "k8s_step" if args.mode == "k8s" else "kano_step",
        lambda: cost, dev_args, kwargs,
    )
    del out

    # amortized steady-state throughput: queue K solves (the device runs
    # them in order), one synchronisation at the end
    k = max(args.repeats, 10)
    s = time.perf_counter()
    for _ in range(k):
        step(dev_args)
    _sync(dev)
    solve = (time.perf_counter() - s) / k
    value = pairs / solve
    log(f"solve amortized {solve * 1e3:.1f}ms over {k} queued runs; "
        f"{value / 1e9:.2f}e9 pairs/s")

    def rerun():
        step(dev_args)
        _sync(dev)

    # the dense solves run no hand-written kernel, so this split reports
    # warm ~= cold for the k8s/kano modes
    warm_fields = _warm_compile_split(t4 - t3, rerun=rerun, kernel_builds=builds)
    _emit(
        {
            "metric": (
                f"all-pairs reachability throughput "
                f"({args.mode}, {n} pods, {args.policies} policies)"
            ),
            "value": round(value, 1),
            "unit": "pairs/s",
            "vs_baseline": round(value / BASELINE_PAIRS_PER_SEC, 4),
            **warm_fields,
            "steady_s": round(solve, 4),
            **macs_extra,
        }
    )


_MODE_FNS = {
    "sentinel": bench_sentinel,
    "tiled": bench_tiled,
    "incremental": bench_incremental,
    "closure": bench_closure,
    "stripe": bench_stripe,
    "stripes": bench_stripes,
    "headtohead": bench_headtohead,
    "serve": bench_serve,
    "query": bench_query,
    "replicate": bench_replicate,
    "ingress": bench_ingress,
    "posture": bench_posture,
    "k8s": bench_dense,
    "kano": bench_dense,
}

#: each mode's default cluster size (pods, policies), as in the JAX bench
_DEFAULT_PODS = {
    "tiled": 100_000, "incremental": 100_000, "closure": 100_000,
    "stripe": 1_000_000, "stripes": 4_096, "headtohead": 100_000,
    "serve": 1_024, "query": 10_000, "replicate": 1_024,
    "ingress": 1_024, "posture": 10_000,
}
_DEFAULT_POLICIES = {
    "tiled": 10_000, "incremental": 10_000, "closure": 10_000,
    "stripe": 512, "stripes": 256, "headtohead": 10_000,
    "serve": 256, "query": 1_000, "replicate": 256,
    "ingress": 256, "posture": 1_000,
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kv-tpu-torch-bench",
        description="The port's benchmark entry point (one JSON result line per "
        "record on stdout, progress on stderr).",
    )
    ap.add_argument("--pods", type=int, default=None)
    ap.add_argument("--policies", type=int, default=None)
    ap.add_argument("--namespaces", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument(
        "--device", default="cuda",
        help="where the tensors live (default cuda: without a GPU the "
        "exits 3 instead of running on the CPU; cpu runs every mode "
        "on the kernels' plain versions)",
    )
    ap.add_argument(
        "--mode",
        choices=MODES,
        default="tiled",
        help="tiled = the BASELINE north-star config (100k pods / 10k "
        "policies, packed-bitmap output); k8s/kano = dense solves at 10k; "
        "incremental = policy+pod diff latency on the packed state at 100k; "
        "closure = full + after-diff packed closure at 100k; stripe = the "
        "1M-pod dst stripe + 250k matrix-free diff (config 5's single-card "
        "share; --full-sweep runs ALL dst tiles with an oracle cross-check); "
        "stripes = the stripe-sharded serving fleet: K stripe owners "
        "(--stripes) replay the same churn WAL as one whole-state "
        "follower, merged answers are cross-checked bit-identical, and "
        "the gated stripe_aggregate_queries_per_second + "
        "stripe_cross_stripe_p99_s pair is recorded; "
        "headtohead = interleaved torch-sweep-vs-kernel A/B with bands; "
        "serve = churn event stream through the coalescing verification "
        "service with interleaved queries (events/s + query latency); "
        "query = mixed any-port/ported probe batches through "
        "QueryEngine.can_reach_batch vs a scalar can_reach loop, on the "
        "dense and/or packed device-resident engine (--engine; queries/s "
        "+ per-batch p50/p99 + steady-window H2D bytes); "
        "replicate = leader writes the WAL, 1/2/4 follower processes "
        "bootstrap + tail + answer batched queries concurrently "
        "(aggregate queries/s read scaling); "
        "ingress = open-loop arrival-rate sweep through the front-door "
        "continuous batcher per fleet size (saturation knee, post-knee "
        "goodput hold, typed-rejection accounting); "
        "posture = same churn stream through identical packed services "
        "bare vs posture-tracked (per-batch exact reach delta) — gated "
        "posture_overhead_pct (<5%% apply-path budget) + "
        "posture_deltas_per_second; "
        "sentinel = ONLY the perf-sentinel calibration round (fixed-shape "
        "compute-bound chains + dispatch probe, recorded as gated "
        "sentinel_<k>_s series + ungated noise context)",
    )
    ap.add_argument(
        "--full-sweep", action="store_true",
        help="stripe mode: additionally sweep EVERY dst tile of the 1M "
        "matrix-free solve and cross-check aggregates against the CPU "
        "oracle via replication periodicity",
    )
    ap.add_argument(
        "--closure-tile", type=int, default=7168,
        help="closure mode: squaring row tile (dst stripe auto-picks ~14336)",
    )
    ap.add_argument(
        "--stripes", type=int, default=4,
        help="stripes mode: stripe owner count K (fleet width; the "
        "per-process state bound asserted is 1/K + eps)",
    )
    ap.add_argument(
        "--stripe-width", type=int, default=32_768,
        help="stripe mode: dst columns swept (wide enough to amortize the "
        "per-call peer-map prologue)",
    )
    ap.add_argument(
        "--kernel",
        action="store_true",
        help="tiled mode: force the hand-written CUDA kernels "
        "(packed_dir_allow any-port / fused_ports_reach with port bitmaps; "
        "on the CPU their plain versions)",
    )
    ap.add_argument(
        "--no-kernel",
        action="store_true",
        help="tiled mode: force the torch sweep",
    )
    ap.add_argument(
        "--no-ports",
        action="store_true",
        help="tiled mode: drop port bitmaps (any-port semantics)",
    )
    ap.add_argument(
        "--n-events", type=int, default=2_000,
        help="serve mode: length of the generated churn event stream",
    )
    ap.add_argument(
        "--n-queries", type=int, default=8_192,
        help="query mode: total probes in the timed steady-state workload "
        "(answered in sub-batches of 512)",
    )
    ap.add_argument(
        "--engine", choices=("dense", "packed", "both"), default="both",
        help="query mode: which serving engine(s) run the workload — "
        "packed answers from device-resident int32 word rows without a "
        "dense [N,N] matrix (the only choice above 32k pods; the 100k-pod "
        "config is --pods 100000 --engine packed); both adds the "
        "packed-vs-dense blended-QPS comparison line",
    )
    ap.add_argument(
        "--net", action="store_true",
        help="replicate mode: networked fleet — 4 followers bootstrap over "
        "HTTP from a ReplicationServer and tail its WAL into local byte "
        "mirrors while the leader keeps appending churn through the timed "
        "window (aggregate queries/s + lag under sustained churn)",
    )
    ap.add_argument(
        "--introspect",
        action="store_true",
        help="publish an analytic FLOP/byte cost report per dispatched "
        "kernel signature and attach the reports to the emitted JSON line "
        "(``cost``; see kv-tpu-torch explain for the interactive view)",
    )
    return ap


def main(argv=None) -> int:
    global _BENCH_MODE, _DEVICE
    args = build_parser().parse_args(argv)
    if args.kernel and args.no_kernel:
        raise SystemExit("--kernel and --no-kernel exclude each other")
    from .resilience.errors import KvTpuError, exit_code_for

    try:
        # the device first: without a card, exit 3 before anything is made
        dev = _dev(args)
    except KvTpuError as e:
        print(f"kv-tpu-torch-bench: {type(e).__name__}: {e}", file=sys.stderr)
        return exit_code_for(e)
    if args.introspect:
        from .observe.introspect import set_introspection

        set_introspection(True)
    if args.pods is None:
        args.pods = _DEFAULT_PODS.get(args.mode, 10_000)
    if args.policies is None:
        args.policies = _DEFAULT_POLICIES.get(args.mode, 1_000)

    with _STATE_LOCK:
        _BENCH_MODE, _DEVICE = args.mode, dev
    if args.mode != "sentinel":
        # every other mode prepends the calibration block so its records
        # carry their own noise context (dispatch_s feeds the deflated
        # gate series)
        _calibrate()
    import torch

    if _DEVICE.type == "cuda":
        torch.cuda.reset_peak_memory_stats(_DEVICE)
    launches0, nvcc0 = _launches(), _nvcc_runs()
    t0 = time.perf_counter()
    _MODE_FNS[args.mode](args)
    _sync(_DEVICE)
    secs = time.perf_counter() - t0
    launches = [b - a for a, b in zip(launches0, _launches())]
    peak = (
        torch.cuda.max_memory_allocated(_DEVICE) if _DEVICE.type == "cuda" else None
    )
    log("bench-summary " + json.dumps({
        "mode": args.mode,
        "device": _device_name(_DEVICE),
        "seconds": round(secs, 3),
        "peak_device_bytes": peak,
        "launches": dict(zip(HAND_KERNELS, launches)),
        "nvcc_runs": _nvcc_runs() - nvcc0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
