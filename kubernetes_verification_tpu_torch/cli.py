"""``kv-tpu-torch`` — command-line front end of the PyTorch/CUDA port.

The port's counterpart of the JAX package's ``kv-tpu``: the same
subcommands, flags, JSON output and exit codes (``resilience/errors.py``
``EXIT_*``), on this package's engines and kernels. Run it as
``kv-tpu-torch`` or ``python -m kubernetes_verification_tpu_torch.cli``.

Every subcommand that builds tensors takes ``--device`` (default ``cuda``):
without a GPU it exits through the error contract instead of running on the
CPU; ``--device cpu`` runs it on the host (the kernels' plain versions).
Deliberate differences from ``kv-tpu`` (ROADMAP §3): ``verify --backend``
defaults to ``torch``; ``--profile`` and ``profile`` capture
``torch.profiler`` traces; ``explain --pods`` prints the analytic cost
reports the backend's path publishes; ``warmup`` packs the built kernel
libraries; above ``_DENSE_SERVE_LIMIT`` pods a service built from manifests
serves from the packed engine; ``lint`` lints this package against its own
baseline (``LINT_BASELINE.json`` inside the package).

* ``kv-tpu-torch verify PATH``   — load manifests, verify, print queries/summary;
* ``kv-tpu-torch snapshot PATH DIR`` — build a packed incremental verifier from
  manifests and checkpoint it (the serving loop's "cold start");
* ``kv-tpu-torch diff DIR``      — load a checkpoint, apply pod/policy diffs from
  YAML manifests (and ``--remove`` forms), print the changed aggregates,
  save — the checkpoint → diff → patch → save serving cycle the
  incremental engines implement (BASELINE config 5's operational story);
* ``kv-tpu-torch explain PATH``  — export the encoded tensors + the Datalog
  program text (the ``get_datalog`` facility, ``kubesv/kubesv/
  constraint.py:127-128``, for both representations);
* ``kv-tpu-torch generate DIR``  — write a synthetic cluster as YAML manifests
  (``--events-out`` adds a churn event stream);
* ``kv-tpu-torch serve``         — continuous verification: apply a mutation-event
  stream through the coalescing service loop, check declarative
  assertions (violations exit 1 with pod-pair witnesses);
* ``kv-tpu-torch query``         — can-reach / who-can-reach / blast-radius /
  what-if admission checks against manifests or a serve snapshot;
* ``kv-tpu-torch lb``            — spread query batches across follower replicas
  by staleness-weighted routing (stale reads retry on the leader,
  unreachable replicas are breaker-ejected);
* ``kv-tpu-torch recover``       — read-only triage of a serve checkpoint
  directory (generation health, WAL valid prefix, flight-recorder dumps);
* ``kv-tpu-torch trace ID``      — reassemble one trace's cross-process timeline
  from per-replica JSON event logs (span tree + query stage breakdown);
  ``--slowest --metrics URL`` picks the id from the worst latency exemplar;
* ``kv-tpu-torch fleet``         — scrape every replica's ``/healthz`` +
  ``/metrics``, render the fleet table, evaluate SLO burn rates;
* ``kv-tpu-torch jobs``          — merge every replica's in-flight long-job
  progress (pass counters, rates, ETAs) into one table;
* ``kv-tpu-torch profile``       — trigger a bounded on-demand ``torch.profiler``
  capture on a running replica (or locally), rate-limited;
* ``kv-tpu-torch top``           — live fleet dashboard: replica table, job ETA
  bars, qps/lag/burn sparklines, recent flight dumps;
* ``kv-tpu-torch backends``      — list available execution backends.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Optional


def _add_obs_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--metrics-out", metavar="FILE",
        help="write the metrics registry dump on exit (.json; .prom/.txt "
        "for Prometheus text exposition)",
    )
    p.add_argument(
        "--profile", metavar="DIR",
        help="capture a torch.profiler trace (CPU and CUDA activity) into "
        "DIR (a Chrome trace in TensorBoard's profile layout)",
    )
    p.add_argument(
        "--log-json", action="store_true",
        help="emit one JSON event line per span/phase on stderr",
    )
    p.add_argument(
        "--flight", metavar="DIR",
        help="arm the flight recorder: keep a bounded in-memory ring of "
        "recent spans/events/metric deltas and dump it to "
        "DIR/flight-<ts>.json on error escalation, breaker-open, "
        "kill-points and SIGUSR2 (render dumps with `kv-tpu-torch recover DIR`)",
    )


#: the command-line name in diagnostics and guidance
_PROG = "kv-tpu-torch"


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="where the tensors live (default cuda: without a GPU the "
        "command exits 3 instead of running on the CPU; cpu runs the "
        "kernels' plain versions on the host)",
    )


def _device(args):
    """``--device`` as a ``torch.device``, resolved before anything is
    loaded or built: ``BackendError`` (exit 3) when it names a card and
    none is present."""
    from .runtime import resolve_device

    return resolve_device(args.device)


def _sync(device) -> None:
    """Wait for the card's queued work (a timing reads the host clock)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _own_process_group():
    """A command that joined a ``torch.distributed`` group (``--opt mesh=``,
    the sharded backends in a 1-rank job) leaves it on exit, as the process
    that ran it would."""
    import torch.distributed as dist

    had = dist.is_available() and dist.is_initialized()
    try:
        yield
    finally:
        if not had and dist.is_available() and dist.is_initialized():
            from .parallel.mesh import leave_distributed

            leave_distributed()


@contextlib.contextmanager
def _observed(args):
    """Honour the shared observability flags around a command body."""
    from .observe import configure_logging, profile_to, write_metrics
    from .observe import flight as _flight

    if getattr(args, "log_json", False):
        configure_logging()
    flight_dir = getattr(args, "flight", None)
    if flight_dir:
        _flight.install(flight_dir)
    else:
        _flight.install_from_env()
    profile_dir = getattr(args, "profile", None)
    ctx = profile_to(profile_dir) if profile_dir else contextlib.nullcontext()
    try:
        with ctx:
            yield
    finally:
        # written even when the command raises: a failed solve's partial
        # spans/counters are exactly what a post-mortem wants
        out = getattr(args, "metrics_out", None)
        if out:
            write_metrics(out)


def _add_verify_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--backend", default="torch",
        help="execution backend (default torch, the port's VerifyConfig "
        "default); see kv-tpu-torch backends",
    )
    p.add_argument("--closure", action="store_true")
    p.add_argument("--no-ports", dest="ports", action="store_false")
    p.add_argument("--no-self-traffic", dest="self_traffic", action="store_false")
    p.add_argument(
        "--no-default-allow", dest="default_allow", action="store_false",
        help="reproduce the reference's unselected-pods-unreachable behaviour",
    )
    p.add_argument("--kano", action="store_true", help="kano-level semantics")
    p.add_argument("--output", help="save the VerifyResult as .npz")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument(
        "--opt", action="append", default=[], metavar="KEY=VALUE",
        help="backend option (repeatable), e.g. --opt mesh=4,2 "
        "--opt tile=512 --opt keep_matrix=true for sharded-packed",
    )
    p.add_argument(
        "--fallback-chain", metavar="B1,B2,...",
        help="ordered backends to try (e.g. torch,sharded,cpu); supersedes "
        "--backend — exit 3 when the whole chain fails",
    )
    p.add_argument(
        "--max-retries", type=int, default=None, metavar="N",
        help="transient-failure retries per backend before falling back "
        "(default 2 when the resilient path is active)",
    )
    p.add_argument(
        "--solve-timeout", type=float, default=None, metavar="SECONDS",
        help="watchdog wall-clock bound per solve attempt",
    )
    p.add_argument(
        "--inject-faults", action="append", default=[],
        metavar="BACKEND=SPEC",
        help="register a fault-injecting wrapper backend 'faulty:BACKEND' "
        "(repeatable); SPEC e.g. oom@0, timeout, device_loss, flaky@0, "
        "oom>256 — see resilience.faults.parse_fault_spec",
    )
    p.add_argument(
        "--check", action="store_true",
        help="exit 1 when policy shadow/conflict pairs are found",
    )


#: options whose values must be integers (string fallthrough would surface
#: as a confusing type error deep in the backend, after the solve)
_INT_OPTS = frozenset(
    {"tile", "chunk", "dense_reach_limit", "max_port_masks", "closure_tile"}
)


def _backend_options(opts, device) -> tuple:
    """``--opt`` pairs, then ``("device", ...)`` from ``--device`` (the
    last pair of a key wins, ``VerifyConfig.opt``)."""
    return tuple(_parse_opt(o) for o in opts) + (("device", str(device)),)


def _parse_opt(kv_str: str):
    key, sep, raw = kv_str.partition("=")
    if not sep or not key:
        raise SystemExit(f"--opt expects KEY=VALUE, got {kv_str!r}")
    low = raw.lower()
    if low in ("true", "false"):
        return key, low == "true"
    if "," in raw:
        try:
            return key, tuple(int(x) for x in raw.split(","))
        except ValueError:
            raise SystemExit(
                f"--opt {key}: comma lists must be integers, got {raw!r}"
            )
    try:
        return key, int(raw)
    except ValueError:
        if key in _INT_OPTS:
            # numeric option but not an int (2e4, 1.5) — fail at parse time
            # instead of as a type error deep in the backend post-solve
            raise SystemExit(
                f"--opt {key}: expected an integer, got {raw!r}"
            )
        return key, raw  # string-valued options (e.g. groups_label=3tier)


def _diagnose(args, e: Exception) -> int:
    """The ``KvTpuError`` → exit-code contract: one line on stderr (the
    operator path) unless ``--log-json`` asked for the debugging traceback."""
    from .observe.flight import trigger_dump
    from .resilience.errors import exit_code_for

    # a typed error escalating out of a command is a flight-recorder
    # trigger: the ring holds the spans/events that led here
    path = trigger_dump("error", error=f"{type(e).__name__}: {e}")
    if path:
        print(f"{_PROG}: flight recorder dumped to {path}", file=sys.stderr)
    if getattr(args, "log_json", False):
        raise e
    print(f"{_PROG}: {type(e).__name__}: {e}", file=sys.stderr)
    return exit_code_for(e)


def cmd_verify(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_verify(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _resilience_from_args(args):
    """``--fallback-chain``/``--max-retries``/``--solve-timeout`` →
    :class:`~.resilience.ResilienceConfig`, or None when none were given
    (the plain dispatcher path — identical behaviour to pre-resilience)."""
    chain = tuple(
        b.strip()
        for b in (args.fallback_chain or "").split(",")
        if b.strip()
    )
    if not chain and args.solve_timeout is None and args.max_retries is None:
        return None
    from .resilience import ResilienceConfig

    return ResilienceConfig(
        fallback_chain=chain,
        max_retries=2 if args.max_retries is None else args.max_retries,
        solve_timeout=args.solve_timeout,
    )


def _register_faults(args) -> None:
    for spec in getattr(args, "inject_faults", []):
        backend, sep, fault_spec = spec.partition("=")
        if not sep or not backend or not fault_spec:
            raise SystemExit(
                f"--inject-faults expects BACKEND=SPEC, got {spec!r}"
            )
        from .resilience.faults import parse_fault_spec, register_faulty

        register_faulty(backend, parse_fault_spec(fault_spec))


def _run_verify(args) -> int:
    import kubernetes_verification_tpu_torch as kv

    from .resilience.errors import EXIT_OK, EXIT_VIOLATIONS

    device = _device(args)
    _register_faults(args)
    resilience = _resilience_from_args(args)
    cfg = kv.VerifyConfig(
        backend=args.backend,
        closure=args.closure,
        compute_ports=args.ports,
        self_traffic=args.self_traffic,
        default_allow_unselected=args.default_allow,
        backend_options=_backend_options(args.opt, device),
    )
    if args.kano:
        containers, policies = kv.load_kano(args.path)
        if resilience is not None:
            from .resilience import resilient_verify_kano

            res = resilient_verify_kano(containers, policies, cfg, resilience)
        else:
            res = kv.verify_kano(containers, policies, cfg)
        pods = containers
        skipped = []
    else:
        cluster, skipped = kv.load_cluster(args.path)
        if (
            args.output
            and cfg.backend == "sharded-packed"
            and cluster.n_pods > cfg.opt("dense_reach_limit", 20_000)
        ):
            # fail BEFORE the (potentially hours-long) solve: --output saves
            # a dense VerifyResult, which this scale never materialises
            raise SystemExit(
                f"--output saves a dense VerifyResult but {cluster.n_pods} "
                "pods exceeds dense_reach_limit "
                f"({cfg.opt('dense_reach_limit', 20_000)}); raise --opt "
                "dense_reach_limit=N or drop --output"
            )
        if resilience is not None:
            from .resilience import resilient_verify

            res = resilient_verify(cluster, cfg, resilience)
        else:
            res = kv.verify(cluster, cfg)
        pods = cluster.pods
    iso = res.all_isolated()
    hubs = res.all_reachable()
    if res.reach is not None:
        pairs = int(res.reach.sum())
    else:  # sharded-packed above the dense-reach limit: use the aggregates
        pairs = int(res.packed_result.total_pairs)
    out = {
        "pods": res.n_pods,
        "backend": res.backend,
        "mode": res.mode,
        "reachable_pairs": pairs,
        "all_isolated": iso,
        "all_reachable": hubs,
        "policy_shadow": (
            res.policy_shadow() if res.src_sets is not None else None
        ),
        "policy_conflict": (
            res.policy_conflict() if res.src_sets is not None else None
        ),
        "timings": res.timings,
        "skipped_documents": skipped,
    }
    if args.output:
        if res.reach is None:  # safety net; print the summary before exiting
            print(json.dumps(out))
            raise SystemExit(
                "--output saves a dense VerifyResult; this solve kept only "
                "the packed matrix/aggregates (raise --opt "
                "dense_reach_limit=N or use save_packed on packed_result)"
            )
        from .utils.persist import save_result

        save_result(res, args.output)
        out["saved"] = args.output
    violations = bool(out["policy_shadow"]) or bool(out["policy_conflict"])
    if args.check:
        out["check"] = "failed" if violations else "passed"
    if args.json:
        print(json.dumps(out))
    else:
        name = lambda i: getattr(pods[i], "name", str(i))
        print(f"{res.n_pods} pods verified on backend={res.backend} "
              f"({res.mode} mode): {out['reachable_pairs']} reachable pairs")
        print(f"  fully isolated pods: {[name(i) for i in iso] or 'none'}")
        print(f"  reachable-from-everywhere pods: {[name(i) for i in hubs] or 'none'}")
        if out["policy_shadow"]:
            print(f"  shadowed policy pairs: {out['policy_shadow']}")
        if out["policy_conflict"]:
            print(f"  conflicting policy pairs: {out['policy_conflict']}")
        for k, v in res.timings.items():
            print(f"  {k}: {v * 1e3:.1f} ms")
        if skipped:
            print(f"  skipped {len(skipped)} non-verifiable documents")
        if args.check and violations:
            print("  check: FAILED (shadowed/conflicting policies present)")
    if args.check and violations:
        return EXIT_VIOLATIONS
    return EXIT_OK


def _mesh_from_opts(opts: dict, device=None):
    if "mesh" not in opts:
        return None
    from .parallel.mesh import mesh_for

    return mesh_for(opts["mesh"], device=device)


def _load_incremental(directory: str, mesh=None, device=None):
    """Open either packed-engine checkpoint; the ports checkpoint is the one
    carrying a frozen-universe ``__meta__`` blob."""
    import os

    from .utils.persist import (
        _load_npz,
        load_packed_incremental,
        load_ports_incremental,
    )

    with _load_npz(os.path.join(directory, "state.npz")) as z:
        is_ports = "__meta__" in z.files
    if is_ports:
        return load_ports_incremental(directory, device=device, mesh=mesh)
    return load_packed_incremental(directory, device=device, mesh=mesh)


def _inc_aggregates(inc) -> dict:
    import numpy as np

    out = {
        "pods": int(inc.n_active),
        "policies": len(inc.policies),
        "update_count": int(inc.update_count),
    }
    try:
        pr = inc.packed_reach()
    except ValueError:  # matrix-free checkpoint: aggregates need a sweep
        out["reachable_pairs"] = None
        return out
    out["reachable_pairs"] = int(pr.out_degree().sum())
    act = inc.pod_active
    out["ingress_isolated"] = int(np.count_nonzero(pr.ingress_isolated[act]))
    out["egress_isolated"] = int(np.count_nonzero(pr.egress_isolated[act]))
    return out


def cmd_snapshot(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        return _run_snapshot(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_snapshot(args) -> int:
    import kubernetes_verification_tpu_torch as kv

    from .packed_incremental import PackedIncrementalVerifier
    from .packed_incremental_ports import PackedPortsIncrementalVerifier
    from .utils.persist import (
        save_packed_incremental,
        save_ports_incremental,
    )

    device = _device(args)
    opts = dict(_parse_opt(o) for o in args.opt)
    mesh = _mesh_from_opts(opts, device)
    cluster, skipped = kv.load_cluster(args.path)
    cfg = kv.VerifyConfig(
        compute_ports=args.ports,
        self_traffic=args.self_traffic,
        default_allow_unselected=args.default_allow,
    )
    if args.ports:
        inc = PackedPortsIncrementalVerifier(
            cluster, cfg, mesh=mesh, device=device,
            headroom=args.headroom, pod_headroom=args.pod_headroom,
        )
    else:
        inc = PackedIncrementalVerifier(
            cluster, cfg, mesh=mesh, device=device,
            pod_headroom=args.pod_headroom,
        )
    closure_s = None
    if args.closure:
        import time as _time

        s = _time.perf_counter()
        inc.closure_packed(tile=int(opts.get("closure_tile", 7168)))
        _sync(inc.device)
        closure_s = round(_time.perf_counter() - s, 3)
    if args.ports:
        save_ports_incremental(inc, args.dir)
    else:
        save_packed_incremental(inc, args.dir)
    agg = _inc_aggregates(inc)
    agg["engine"] = "ports" if args.ports else "any-port"
    agg["init_s"] = round(inc.init_time, 3)
    if closure_s is not None:
        agg["closure_s"] = closure_s
    agg["saved"] = args.dir
    if skipped:
        agg["skipped_documents"] = skipped
    print(json.dumps(agg) if args.json else (
        f"{agg['pods']} pods / {agg['policies']} policies → "
        f"{agg['engine']} incremental state in {agg['init_s']}s "
        f"({agg['reachable_pairs']} reachable pairs); saved to {args.dir}"
    ))
    return 0


def cmd_diff(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_diff(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_diff(args) -> int:
    import time

    import kubernetes_verification_tpu_torch as kv

    device = _device(args)
    opts = dict(_parse_opt(o) for o in args.opt)
    t0 = time.perf_counter()
    inc = _load_incremental(
        args.dir, mesh=_mesh_from_opts(opts, device), device=device
    )
    _sync(inc.device)
    t1 = time.perf_counter()
    from .packed_incremental_ports import PortUniverseChanged

    before = _inc_aggregates(inc)
    # closure presence is decided at LOAD time: a pod-axis grow during the
    # diffs invalidates the cached closure (shape change), and the
    # maintenance below must then recompute it in full rather than silently
    # dropping it from the checkpoint
    had_closure = getattr(inc, "_closure", None) is not None
    ops = []
    skipped_docs = []
    try:
        _apply_diffs(args, inc, ops, skipped_docs)
    except PortUniverseChanged as e:
        # engine diffs are atomic and nothing is saved on this path, so the
        # on-disk checkpoint is untouched
        raise SystemExit(
            f"diff outside the checkpoint's frozen port universe after "
            f"{len(ops)} applied ops (not saved): {e}\n"
            f"rebuild with: {_PROG} snapshot MANIFESTS {args.dir}"
        )
    except KeyError as e:
        raise SystemExit(
            f"diff references an unknown pod/policy/namespace after "
            f"{len(ops)} applied ops (not saved): {e}"
        )
    # any other ValueError is an internal invariant violation — let it
    # propagate with its traceback instead of masquerading as an operator
    # "rebuild required" message (advisor, round 4)
    closure_s = None
    if had_closure and not args.no_save:
        # the snapshot carries a maintained closure: bring it current via
        # the delta re-closure (diff-local; the engines marked the dirty
        # nodes as the diffs applied) so the saved state stays
        # query-ready for path questions across restarts. --no-save is a
        # dry run: don't pay for a closure that would be discarded.
        s = time.perf_counter()
        inc.closure_packed(tile=int(opts.get("closure_tile", 7168)))
        _sync(inc.device)
        closure_s = round(time.perf_counter() - s, 3)
    _sync(inc.device)
    t2 = time.perf_counter()
    after = _inc_aggregates(inc)
    out_dir = args.out or args.dir
    if not args.no_save:
        from .packed_incremental_ports import PackedPortsIncrementalVerifier
        from .utils.persist import (
            save_packed_incremental,
            save_ports_incremental,
        )

        if isinstance(inc, PackedPortsIncrementalVerifier):
            save_ports_incremental(inc, out_dir)
        else:
            save_packed_incremental(inc, out_dir)
    summary = {
        "ops": ops,
        "before": before,
        "after": after,
        "pairs_delta": (
            after["reachable_pairs"] - before["reachable_pairs"]
            if before.get("reachable_pairs") is not None
            and after.get("reachable_pairs") is not None
            else None
        ),
        "load_s": round(t1 - t0, 3),
        "diff_s": round(t2 - t1, 3),
        "saved": None if args.no_save else out_dir,
    }
    if closure_s is not None:
        summary["closure_s"] = closure_s
    if skipped_docs:
        summary["skipped_documents"] = skipped_docs
    if args.json:
        print(json.dumps(summary))
    else:
        for kind, key in ops:
            print(f"  {kind} {key}")
        print(
            f"{len(ops)} diffs in {summary['diff_s']}s: "
            f"{before['reachable_pairs']} → {after['reachable_pairs']} "
            f"reachable pairs ({summary['pairs_delta']:+d})"
            if summary["pairs_delta"] is not None
            else f"{len(ops)} diffs in {summary['diff_s']}s (matrix-free)"
        )
        if summary["saved"]:
            print(f"saved to {summary['saved']}")
    return 0


def _apply_diffs(args, inc, ops, skipped_docs) -> None:
    import kubernetes_verification_tpu_torch as kv

    for path in args.apply:
        delta, skipped = kv.load_cluster(path)
        skipped_docs += skipped
        for ns in delta.namespaces:
            # labeled Namespace docs must register BEFORE their pods so
            # namespaceSelector peers see the labels; label-less entries are
            # indistinguishable from the loader's auto-created ones and are
            # left to add_pod's auto-create (which also means a relabel TO
            # empty labels cannot be expressed through a manifest — only a
            # LABELED row is treated as authoritative)
            if not ns.labels:
                continue
            existing = inc._ns_labels.get(ns.name)
            if existing is None:
                if inc.add_namespace(ns):
                    ops.append(["add-namespace", ns.name])
            elif dict(existing) != dict(ns.labels):
                inc.update_namespace_labels(ns.name, dict(ns.labels))
                ops.append(["relabel-namespace", ns.name])
        for pod in delta.pods:
            key = f"{pod.namespace}/{pod.name}"
            if key in inc._pod_idx:
                old = inc.pods[inc._pod_idx[key]]
                if (
                    dict(pod.container_ports) != dict(old.container_ports)
                    or pod.ip != old.ip
                ):
                    # ports/ip moved: full slot recycle (labels-only diffs
                    # patch in place)
                    inc.remove_pod(pod.namespace, pod.name)
                    inc.add_pod(pod)
                    ops.append(["replace-pod", key])
                elif dict(pod.labels) != dict(old.labels):
                    inc.update_pod_labels(
                        inc._pod_idx[key], dict(pod.labels)
                    )
                    ops.append(["relabel-pod", key])
                # unchanged manifest: no dispatch — apply-style full-manifest
                # reconciles must cost only the comparison
            else:
                inc.add_pod(pod)
                ops.append(["add-pod", key])
        for pol in delta.policies:
            key = f"{pol.namespace}/{pol.name}"
            if key in inc.policies:
                if pol != inc.policies[key]:
                    inc.update_policy(pol)
                    ops.append(["update-policy", key])
            else:
                inc.add_policy(pol)
                ops.append(["add-policy", key])
    for spec in args.remove:
        kind, _, rest = spec.partition("/")
        if kind == "namespace":
            if not rest or "/" in rest:
                raise SystemExit(
                    f"--remove expects namespace/NAME, got {spec!r}"
                )
            try:
                inc.remove_namespace(rest)
            except ValueError as e:
                # op-ordering error (pods/policies still inside) — a clean
                # operator message, not a traceback; list removals for the
                # namespace's contents FIRST
                raise SystemExit(f"cannot remove namespace {rest}: {e}")
            ops.append(["remove-namespace", rest])
            continue
        ns, sep, name = rest.partition("/")
        if kind not in ("pod", "policy") or not sep:
            raise SystemExit(
                f"--remove expects pod/NAMESPACE/NAME, "
                f"policy/NAMESPACE/NAME or namespace/NAME, got {spec!r}"
            )
        if kind == "pod":
            inc.remove_pod(ns, name)
        else:
            inc.remove_policy(ns, name)
        ops.append([f"remove-{kind}", f"{ns}/{name}"])


def cmd_explain(args) -> int:
    # three modes share the verb: the roofline report over the recorded
    # bench history (--roofline), per-kernel cost/memory introspection
    # when a cluster size or backend is given, and the legacy
    # encoding+Datalog export when only a manifest PATH is
    if getattr(args, "roofline", False):
        return _explain_roofline(args)
    if args.pods is not None or args.backend is not None:
        from .resilience.errors import KvTpuError

        try:
            return _explain_cost(args)
        except KvTpuError as e:
            return _diagnose(args, e)
    if not args.path:
        raise SystemExit(
            "explain: give a manifest PATH (tensor/Datalog export) or "
            "--pods N [--backend B] (per-kernel cost/memory table)"
        )
    import kubernetes_verification_tpu_torch as kv
    from .datalog import build_k8s_program
    from .encode.encoder import encode_cluster
    from .utils.persist import export_encoding

    cluster, _ = kv.load_cluster(args.path)
    txt = export_encoding(
        encode_cluster(cluster, compute_ports=args.ports), args.out
    )
    prog, _, _atoms = build_k8s_program(cluster, kv.VerifyConfig())
    dl = args.out + ".datalog"
    with open(dl, "w") as fh:  # kvtpu: ignore[atomic-write] program-text export next to the .npz, regenerated on demand
        fh.write(prog.dump() + "\n")
    print(open(txt).read().rstrip())
    print(f"wrote {args.out}.npz, {txt}, {dl}")
    return 0


def _explain_cost(args) -> int:
    """``kv-tpu-torch explain --pods N --backend B``: run one verification with
    introspection enabled and print the per-kernel cost/memory table plus a
    device-memory snapshot. The reports are analytic: the hand-written
    kernels and ``bool_dot`` publish their exact operation and byte counts
    (``observe/introspect.py``), the host backends their estimates, so the
    table answers "which kernel dominates and is it memory-bound" on the
    card or, with ``--device cpu``, on the host."""
    import kubernetes_verification_tpu_torch as kv
    from .observe import introspect, telemetry

    device = _device(args)
    backend = args.backend or "torch"
    introspect.set_introspection(True)
    telemetry.install_span_memory_hook()
    if args.path:
        cluster, _ = kv.load_cluster(args.path)
    else:
        from .harness.generate import GeneratorConfig, random_cluster

        cluster = random_cluster(
            GeneratorConfig(
                n_pods=args.pods or 64,
                n_policies=args.policies,
                n_namespaces=args.namespaces,
                seed=args.seed,
            )
        )
    config = kv.VerifyConfig(
        backend=backend,
        compute_ports=args.ports,
        backend_options=(("device", str(device)),),
    )
    result = kv.verify(cluster, config)
    mem = telemetry.sample_once()
    reports = introspect.reports()
    if args.json:
        print(
            json.dumps(
                {
                    "backend": backend,
                    "n_pods": result.n_pods,
                    "n_policies": len(cluster.policies),
                    # a sweep's timings carry its stripe and tile count
                    "timings": {
                        k: round(v, 6) if isinstance(v, float) else v
                        for k, v in result.timings.items()
                    },
                    "reports": [r.to_dict() for r in reports],
                    "memory": mem,
                },
                sort_keys=True,
            )
        )
        return 0
    print(
        f"# {backend} backend · {result.n_pods} pods / "
        f"{len(cluster.policies)} policies"
    )
    table = introspect.format_cost_table(reports)
    print(table if table else "(no kernels published cost reports)")
    print()
    print(telemetry.format_memory_table(mem))
    print()
    print(
        "timings: "
        + "  ".join(
            f"{k}={v:.4f}s" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(result.timings.items())
        )
    )
    return 0


def _explain_roofline(args) -> int:
    """``kv-tpu-torch explain --roofline``: achieved MACs/s as %% of device peak
    per recorded bench mode — published v5e/v5p/v4/v6e table when the
    record names a known device model, the record's own
    sentinel-calibrated matmul peak otherwise, analytic host estimate as
    the last resort."""
    from .observe.history import default_paths, load_runs
    from .observe.introspect import format_roofline_table, roofline_rows

    paths = [args.path] if args.path else default_paths()
    runs = load_runs(paths)
    rows = roofline_rows(runs)
    if args.json:
        print(json.dumps({"rows": rows}, sort_keys=True))
        return 0
    if not rows:
        print(
            "no history record carries MAC accounting yet — run bench.py "
            "(modes tiled/k8s/closure/stripe stamp `macs` + `steady_s`)"
        )
        return 0
    print(format_roofline_table(rows))
    return 0


def cmd_history(args) -> int:
    """``kv-tpu-torch history``: show the bench-history trajectory — raw and
    dispatch-deflated values side by side, with each round's sentinel
    noise figure — and the regression gate's verdict over the expanded
    (deflation-aware) series."""
    from .observe.history import (
        check_regression,
        deflate_record,
        default_paths,
        expand_derived,
        format_findings,
        load_runs,
    )

    paths = args.paths or default_paths()
    runs = load_runs(paths)
    if args.json:
        ok, findings = check_regression(
            expand_derived(runs), tolerance=args.tolerance,
            window=args.window, prefer_deflated=True,
        )
        print(
            json.dumps(
                {"ok": ok, "runs": runs, "findings": findings}, sort_keys=True
            )
        )
        return 0 if ok else 1
    if not runs:
        print(
            "no bench history found (run bench.py to append to "
            "bench_history.jsonl)"
        )
        return 0
    for r in runs:
        extras = "".join(
            f"  {k}={r[k]}"
            for k in ("compile_s", "steady_s", "round")
            if r.get(k) is not None
        )
        twin = deflate_record(r)
        deflated = f"  deflated={twin['value']:.6g}" if twin else ""
        sentinel = r.get("sentinel")
        noise = (
            f"  sentinel_spread={sentinel['spread_pct']:g}%"
            if isinstance(sentinel, dict)
            and sentinel.get("spread_pct") is not None
            else ""
        )
        print(
            f"{r['metric']}: {r['value']:.6g} {r.get('unit', '')}"
            f"{deflated}{noise}{extras}"
        )
    ok, findings = check_regression(
        expand_derived(runs), tolerance=args.tolerance, window=args.window,
        prefer_deflated=True,
    )
    print()
    print(format_findings(findings))
    return 0 if ok else 1


def cmd_generate(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        return _run_generate(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_generate(args) -> int:
    from .harness.generate import GeneratorConfig, random_cluster
    from .ingest import dump_cluster

    cluster = random_cluster(
        GeneratorConfig(
            n_pods=args.pods,
            n_policies=args.policies,
            n_namespaces=args.namespaces,
            seed=args.seed,
        )
    )
    paths = dump_cluster(cluster, args.dir)
    print(f"wrote {len(cluster.pods)} pods / {len(cluster.policies)} policies "
          f"to {', '.join(paths)}")
    if args.events_out:
        from .harness.generate import random_event_stream
        from .serve.events import write_events

        events = random_event_stream(
            cluster,
            n_events=args.n_events,
            seed=args.seed,
            p_resync=args.resync_rate,
        )
        write_events(events, args.events_out)
        print(
            f"wrote a {len(events)}-event churn stream to {args.events_out} "
            f"(replay with: kv-tpu-torch serve {args.dir} "
            f"--events {args.events_out})"
        )
    return 0


def cmd_serve(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_serve(args)
    except KvTpuError as e:
        return _diagnose(args, e)


#: above this many pods a service built from manifests serves from the
#: packed engine: the dense engine's two int32 [N, N] count matrices take
#: 8·N² bytes (8.6 GB at 32,768 pods, bench's dense query ceiling; 80 GB at
#: the 100,000-pod flagship, a whole card)
_DENSE_SERVE_LIMIT = 32_768


def _serve_engine(cluster, cfg, device):
    """The engine of a service built from manifests (or rebuilt by the
    recovery ladder): the dense engine, as the JAX CLI builds, up to
    ``_DENSE_SERVE_LIMIT`` pods; above it the packed engine with its words
    kept (``packed_dir_allow`` builds them)."""
    if cluster.n_pods <= _DENSE_SERVE_LIMIT:
        from .incremental import IncrementalVerifier

        return IncrementalVerifier(cluster, cfg, device=device)
    from .packed_incremental import PackedIncrementalVerifier

    return PackedIncrementalVerifier(cluster, cfg, device=device, keep_matrix=True)


def _reachable_pairs(svc) -> int:
    """The reachable pairs of the stream's end state, solving first as a
    query would (so assertion-free runs still verify it). A packed service
    counts its device words instead: its dense [N, N] matrix is 10 GB at
    the flagship."""
    trigger = "query" if not svc.assertions else "assertions"
    if not svc.packed:
        return int(svc.reach(trigger=trigger).sum())
    svc.flush()
    return int(svc.engine.packed_reach().out_degree().sum())


def _maybe_ride_warm_pack(args) -> None:
    """Install a warm executable pack before any engine is built: an
    explicit ``--warm-pack``, else the ``aot-pack`` auto-detected next to
    ``--from-snapshot`` (a checkpoint directory ships one beside its
    ``gen-N/`` snapshots). Fail-open — a bad pack is counted misses and
    warnings, never an error."""
    import os

    from .observe import aot

    if not aot.aot_enabled():
        return
    candidates = []
    if getattr(args, "warm_pack", None):
        candidates.append(args.warm_pack)
    snap = getattr(args, "from_snapshot", None)
    if snap:
        snap = os.path.abspath(snap)
        candidates.append(aot.pack_dir(snap))
        candidates.append(aot.pack_dir(os.path.dirname(snap)))
    for cand in candidates:
        if os.path.isdir(cand):
            aot.load_pack(cand)
            return


def _load_serve_service(args, serve_config):
    """Build the service from manifests (``path``) or a warm-restart
    snapshot (``--from-snapshot``)."""
    from .serve import VerificationService

    device = _device(args)
    _maybe_ride_warm_pack(args)
    if getattr(args, "from_snapshot", None):
        return VerificationService.from_snapshot(
            args.from_snapshot, serve_config=serve_config, device=device
        ), []
    if not args.path:
        raise SystemExit("serve: give a manifest PATH or --from-snapshot DIR")
    import kubernetes_verification_tpu_torch as kv

    cluster, skipped = kv.load_cluster(args.path)
    cfg = kv.VerifyConfig(
        backend="cpu",
        compute_ports=False,
        self_traffic=args.self_traffic,
        default_allow_unselected=args.default_allow,
    )
    engine = _serve_engine(cluster, cfg, device)
    return VerificationService(engine=engine, serve_config=serve_config), skipped


def _resume_serve_service(args, serve_config):
    """Crash recovery: rebuild the service from the checkpoint ladder in
    ``--checkpoint-dir`` (replaying the event log past the recorded
    offset), degrading to a from-scratch build of ``path`` when every
    generation is damaged."""
    from .serve import RecoveryManager

    device = _device(args)
    initial_cluster, cfg, skipped = None, None, []
    if args.path:
        import kubernetes_verification_tpu_torch as kv

        initial_cluster, skipped = kv.load_cluster(args.path)
        cfg = kv.VerifyConfig(
            backend="cpu",
            compute_ports=False,
            self_traffic=args.self_traffic,
            default_allow_unselected=args.default_allow,
        )
    result = RecoveryManager(args.checkpoint_dir).recover(
        log_path=args.events,
        initial_cluster=initial_cluster,
        config=cfg,
        serve_config=serve_config,
        device=device,
        batch_size=args.batch_size,
        engine_factory=_serve_engine,
    )
    return result.service, skipped, result.source, result


def _maybe_enable_posture(svc, args):
    """Enable the posture plane when any --posture* flag asked for it;
    returns the tracker (or None). Malformed alert rules are input
    errors, like malformed --slo specs."""
    journal = getattr(args, "posture_journal", None)
    alerts = getattr(args, "posture_alert", None) or []
    if not (getattr(args, "posture", False) or journal or alerts):
        return None
    from .serve import parse_posture_rule

    try:
        rules = [parse_posture_rule(s) for s in alerts]
    except ValueError as e:
        raise SystemExit(f"serve: {e}")
    return svc.enable_posture(
        journal_path=journal,
        rules=rules,
        top_k=getattr(args, "posture_top_k", None),
    )


def _run_serve(args) -> int:
    from .resilience.errors import (
        EXIT_OK,
        EXIT_VIOLATIONS,
        EXIT_INPUT_ERROR,
    )
    from .serve import EventSource, ServeConfig, load_assertions

    if getattr(args, "stripe", None):
        if getattr(args, "follow", None):
            raise SystemExit("serve: --stripe and --follow are exclusive")
        return _run_stripe(args)
    if getattr(args, "follow", None):
        return _run_follow(args)
    serve_config = ServeConfig(
        staleness_bound=args.staleness,
        batch_size=args.batch_size,
        snapshot_dir=args.snapshot_out,
        snapshot_every=args.snapshot_every,
    )
    recovery = None
    source = None
    if getattr(args, "resume", False):
        if not args.checkpoint_dir:
            raise SystemExit("serve: --resume requires --checkpoint-dir")
        svc, skipped, source, recovery = _resume_serve_service(
            args, serve_config
        )
    else:
        svc, skipped = _load_serve_service(args, serve_config)
    if source is None and args.events:
        source = EventSource(args.events)
    cm = None
    if getattr(args, "checkpoint_dir", None):
        from .serve import CheckpointManager

        cm = CheckpointManager(args.checkpoint_dir)
    if getattr(args, "assert_file", None):
        svc.assertions.extend(load_assertions(args.assert_file))
    posture = _maybe_enable_posture(svc, args)
    checkpoints = 0

    def _checkpoint() -> None:
        nonlocal checkpoints
        cm.checkpoint(
            svc.engine,
            log_path=args.events,
            log_offset=source.offset if source else 0,
            last_seq=source.last_seq if source else -1,
        )
        checkpoints += 1

    if cm is not None:
        # checkpointing drives the loop synchronously: the recorded
        # log offset must describe a quiesced engine, so the worker
        # thread (which applies at its own pace) stays off
        try:
            if source is not None and args.events:
                batch_iter = (
                    source.tail(
                        poll_interval=args.tail_poll,
                        idle_timeout=args.idle_timeout,
                        batch_size=args.batch_size,
                    )
                    if args.tail
                    else source.batches(args.batch_size)
                )
                batches_since = 0
                for batch in batch_iter:
                    svc.apply(batch)
                    batches_since += 1
                    if (
                        args.checkpoint_every
                        and batches_since >= args.checkpoint_every
                    ):
                        _checkpoint()
                        batches_since = 0
            pairs = _reachable_pairs(svc)
            _checkpoint()  # the exit checkpoint: resume loses nothing
        finally:
            svc.close(snapshot=bool(args.snapshot_out))
    else:
        svc.start()
        try:
            if source is not None and args.events:
                if args.tail:
                    for batch in source.tail(
                        poll_interval=args.tail_poll,
                        idle_timeout=args.idle_timeout,
                        batch_size=args.batch_size,
                    ):
                        svc.submit(batch)
                else:
                    for batch in source.batches(args.batch_size):
                        svc.submit(batch)
            svc.flush()
            # force a final solve so assertion-free runs still verify the
            # stream end-state, and print the answer-bearing summary
            pairs = _reachable_pairs(svc)
        finally:
            svc.close(snapshot=bool(args.snapshot_out))
    out = {
        "pods": svc.n_pods,
        "policies": len(svc.engine.policies),
        "reachable_pairs": pairs,
        "assertions": len(svc.assertions),
        "violations": [v.describe() for v in svc.violations],
        **svc.stats.to_dict(),
    }
    if skipped:
        out["skipped_documents"] = skipped
    if posture is not None:
        out["posture"] = posture.health()
    if args.snapshot_out:
        out["snapshot"] = args.snapshot_out
    if cm is not None:
        out["checkpoints"] = checkpoints
        out["checkpoint_dir"] = args.checkpoint_dir
    if recovery is not None:
        out["recovery"] = {
            "outcome": recovery.outcome,
            "generation": recovery.generation,
            "replayed": recovery.replayed,
            "duplicates_skipped": recovery.duplicates_skipped,
            "rejected_generations": len(recovery.errors),
        }
    if args.json:
        print(json.dumps(out, sort_keys=True))
    else:
        print(
            f"{out['pods']} pods / {out['policies']} policies after "
            f"{out['events_seen']} events ({out['events_applied']} applied, "
            f"{out['events_coalesced']} coalesced away) in "
            f"{out['batches']} batches / {out['total_solves']} solves: "
            f"{pairs} reachable pairs"
        )
        for v in svc.violations:
            print(f"  VIOLATION: {v.describe()}")
        if posture is not None:
            ph = posture.health()
            print(
                f"  posture: {ph['reachable_pairs']} reachable pairs @ "
                f"gen {ph['generation']} "
                f"(+{ph['widened_last']}/-{ph['narrowed_last']} last, "
                f"{ph['violations']} alert violations)"
            )
        if args.snapshot_out:
            print(f"  snapshot: {args.snapshot_out}")
        if recovery is not None:
            print(
                f"  recovered: {recovery.outcome} (gen "
                f"{recovery.generation}, {recovery.replayed} events "
                f"replayed, {recovery.duplicates_skipped} duplicates "
                "skipped)"
            )
        if cm is not None:
            print(
                f"  checkpoints: {checkpoints} -> {args.checkpoint_dir}"
            )
    return EXIT_VIOLATIONS if svc.violations else EXIT_OK


def _run_stripe(args) -> int:
    """Stripe owner: own pod rows ``[lo, hi)`` of the count state only
    (``--stripe K/N``, 1-based), bootstrap from manifests or — with
    ``--resume`` — a stripe-sliced checkpoint ladder, then tail
    ``--events`` applying EVERY mutation (cross-stripe effects fan out by
    design; the ``fanout`` counter in the summary is the measured tax).
    ``--checkpoint-dir`` writes stripe-sliced generations the same way
    whole-state serve writes whole ones."""
    import random as _random
    import time as _time
    import zlib as _zlib

    from .parallel.stripes import parse_stripe
    from .resilience.errors import EXIT_OK
    from .serve import CheckpointManager, RecoveryManager
    from .serve.stripes import StripeFollower

    device = _device(args)
    stripe = parse_stripe(args.stripe)
    replica = (
        args.replica
        if args.replica != "follower"
        else f"stripe-{stripe[0] + 1}-of-{stripe[1]}"
    )
    cm = (
        CheckpointManager(args.checkpoint_dir)
        if getattr(args, "checkpoint_dir", None)
        else None
    )
    recovery = None
    skipped: list = []
    initial_cluster, cfg = None, None
    if args.path:
        import kubernetes_verification_tpu_torch as kv

        initial_cluster, skipped = kv.load_cluster(args.path)
        cfg = kv.VerifyConfig(
            backend="cpu",
            compute_ports=False,
            self_traffic=args.self_traffic,
            default_allow_unselected=args.default_allow,
        )
    if getattr(args, "resume", False):
        if not args.checkpoint_dir:
            raise SystemExit("serve: --resume requires --checkpoint-dir")
        recovery = RecoveryManager(args.checkpoint_dir).recover_stripe(
            stripe,
            log_path=args.events,
            initial_cluster=initial_cluster,
            config=cfg,
            device=device,
            batch_size=args.batch_size,
            replica=replica,
        )
        follower = recovery.service
    else:
        if initial_cluster is None:
            raise SystemExit(
                "serve: --stripe needs a manifest PATH (or --resume "
                "with --checkpoint-dir)"
            )
        follower = StripeFollower(
            initial_cluster,
            cfg,
            stripe=stripe,
            replica=replica,
            log_path=args.events,
            device=device,
        )
    # tail loop: same capped exponential backoff + per-replica jitter as
    # _run_follow — a fleet of stripe owners started together must not
    # poll the shared WAL in phase
    interval = args.tail_poll
    max_interval = max(args.tail_poll, min(1.0, args.tail_poll * 32))
    rng = _random.Random(_zlib.crc32(replica.encode()))
    idle_since = _time.monotonic()
    checkpoints = 0
    batches_since = 0
    while args.events:
        applied = follower.poll(args.batch_size)
        now = _time.monotonic()
        if applied:
            batches_since += 1
            if (
                cm is not None
                and args.checkpoint_every
                and batches_since >= args.checkpoint_every
            ):
                follower.checkpoint(cm)
                checkpoints += 1
                batches_since = 0
            interval = args.tail_poll
            idle_since = now
            continue
        if not args.tail:
            break
        if now - idle_since >= args.idle_timeout:
            break
        _time.sleep(
            min(interval, args.idle_timeout) * (1.0 + rng.random() * 0.1)
        )
        interval = min(interval * 2, max_interval)
    if cm is not None:
        follower.checkpoint(cm)  # the exit checkpoint: resume loses nothing
        checkpoints += 1
    out = dict(follower.health())
    if skipped:
        out["skipped_documents"] = skipped
    if cm is not None:
        out["checkpoints"] = checkpoints
        out["checkpoint_dir"] = args.checkpoint_dir
    if recovery is not None:
        out["recovery"] = {
            "outcome": recovery.outcome,
            "generation": recovery.generation,
            "replayed": recovery.replayed,
            "duplicates_skipped": recovery.duplicates_skipped,
            "rejected_generations": len(recovery.errors),
        }
    if args.json:
        print(json.dumps(out, sort_keys=True))
    else:
        frag = out["stripe"]
        print(
            f"stripe {frag['index'] + 1}/{frag['count']} ({out['replica']}): "
            f"rows [{frag['lo']}, {frag['hi']}) of {frag['n']} pods, "
            f"{out['applied']} events applied "
            f"({out['fanout']} cross-stripe fan-out) at gen "
            f"{out['generation']}"
        )
        if recovery is not None:
            print(
                f"  recovered: {recovery.outcome} (gen "
                f"{recovery.generation}, {recovery.replayed} events "
                f"replayed, {recovery.duplicates_skipped} duplicates "
                "skipped)"
            )
        if cm is not None:
            print(f"  checkpoints: {checkpoints} -> {args.checkpoint_dir}")
    return EXIT_OK


def _run_follow(args) -> int:
    """Follower replica: bootstrap from the newest checkpoint generation
    in ``--follow DIR``, tail the leader's WAL under the ``--staleness``
    bound, and (with ``--promote-on-lease-expiry``) take over when the
    lease expires and the leader-probe breaker opens."""
    import random as _random
    import time as _time
    import zlib as _zlib

    from .resilience.errors import EXIT_OK, EXIT_VIOLATIONS
    from .serve import FollowerService, load_assertions

    follower = FollowerService(
        args.follow,
        device=_device(args),
        log_path=args.events,
        replica=args.replica,
        max_lag_seconds=args.staleness,
        proxy_stale=args.proxy_stale,
        lease_ttl=args.lease_ttl,
        batch_size=args.batch_size,
        leader_url=getattr(args, "leader", None),
    )
    svc = follower.service
    if getattr(args, "assert_file", None):
        svc.assertions.extend(load_assertions(args.assert_file))
    posture = _maybe_enable_posture(svc, args)
    # tail loop: the same capped exponential backoff EventSource.tail
    # uses, with a leader heartbeat (and, opted in, a promotion check)
    # between drains
    interval = args.tail_poll
    max_interval = max(args.tail_poll, min(1.0, args.tail_poll * 32))
    # per-replica jitter stream (same law as EventSource.tail): a fleet
    # of followers started together must not probe the leader in phase
    rng = _random.Random(_zlib.crc32(args.replica.encode()))
    idle_since = _time.monotonic()
    while True:
        applied = follower.poll()
        follower.heartbeat()
        if args.promote_on_lease_expiry and follower.maybe_promote():
            break
        now = _time.monotonic()
        if applied:
            interval = args.tail_poll
            idle_since = now
            continue
        if now - idle_since >= args.idle_timeout:
            break
        _time.sleep(
            min(interval, args.idle_timeout) * (1.0 + rng.random() * 0.1)
        )
        interval = min(interval * 2, max_interval)
    # the final answer rides the same staleness gate as any client read:
    # over-bound exits 2 with the measured lag (or proxies under
    # --proxy-stale)
    follower._guard()
    pairs = _reachable_pairs(svc)
    out = {
        **follower.describe(),
        "pods": svc.n_pods,
        "policies": len(svc.engine.policies),
        "reachable_pairs": pairs,
        "assertions": len(svc.assertions),
        "violations": [v.describe() for v in svc.violations],
        **svc.stats.to_dict(),
    }
    if posture is not None:
        out["posture"] = posture.health()
    if args.json:
        print(json.dumps(out, sort_keys=True))
    else:
        print(
            f"replica {out['replica']} ({out['outcome']} bootstrap): "
            f"{out['pods']} pods after {out['applied']} applied events "
            f"(last_seq {out['last_seq']}, lag {out['lag_seq']} records): "
            f"{pairs} reachable pairs"
        )
        if follower.promoted:
            print(f"  PROMOTED to leader at epoch {follower.epoch}")
        for v in svc.violations:
            print(f"  VIOLATION: {v.describe()}")
    return EXIT_VIOLATIONS if svc.violations else EXIT_OK


def cmd_recover(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_recover(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_recover(args) -> int:
    """Read-only durability triage: report every checkpoint generation's
    health and (with ``--events``) the WAL's valid prefix; nothing is
    loaded, repaired or truncated. Exit 2 when the directory is missing
    or every generation is damaged."""
    import os

    from .resilience.errors import EXIT_INPUT_ERROR, EXIT_OK
    from .serve import RecoveryManager

    if not os.path.isdir(args.dir):
        print(f"recover: {args.dir} is not a directory", file=sys.stderr)
        return EXIT_INPUT_ERROR
    report = RecoveryManager(args.dir).inspect(log_path=args.events)
    report["flight_dumps"] = _flight_dumps(args.dir)
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        gens = report["generations"]
        if not gens:
            print(f"{args.dir}: no checkpoint generations")
        for g in gens:
            if g["valid"]:
                kind = g.get("kind", "serve")
                if kind == "stripe":
                    st = g.get("stripe") or {}
                    tag = (
                        f"stripe {st.get('index', 0) + 1}"
                        f"/{st.get('count', '?')}  "
                    )
                elif kind != "serve":
                    tag = f"{kind}  "
                else:
                    tag = ""
                print(
                    f"gen {g['generation']:>3}  OK   {tag}"
                    f"offset={g['log_offset']} last_seq={g['last_seq']} "
                    f"log={g['event_log']}"
                )
            else:
                print(f"gen {g['generation']:>3}  BAD  {g['error']}")
        wal = report.get("wal")
        if wal:
            if "error" in wal:
                print(f"wal {wal['path']}: ERROR {wal['error']}")
            else:
                tail = (
                    f"  TORN tail: {wal['torn_bytes']} bytes after "
                    f"offset {wal['valid_bytes']} (serve --resume "
                    "truncates)"
                    if wal["torn"]
                    else ""
                )
                print(
                    f"wal {wal['path']}: {wal['records']} records "
                    f"({wal['sequenced']} sequenced, "
                    f"last_seq={wal['last_seq']}){tail}"
                )
        lease = report.get("lease")
        if lease:
            if "error" in lease:
                print(f"lease {lease['path']}: ERROR {lease['error']}")
            else:
                state = "EXPIRED" if lease["expired"] else "live"
                print(
                    f"lease {lease['path']}: epoch {lease['epoch']} held "
                    f"by {lease['holder']} ({state}, "
                    f"age {lease['age_seconds']:.1f}s / "
                    f"ttl {lease['ttl']:.1f}s)"
                )
        pack = report.get("aot_pack")
        if pack and pack.get("present"):
            env = "env-match" if pack.get("env_match") else "ENV MISMATCH"
            print(
                f"aot-pack {pack['directory']}: {pack['entries']} entries "
                f"({pack['matching']} usable, {pack['mismatched']} "
                f"mismatched, {pack['corrupt']} corrupt; {env}, "
                f"{pack['bytes']} bytes)"
            )
        elif pack is not None:
            print("aot-pack: none (cold start will recompile every kernel)")
        for f in report["flight_dumps"]:
            if "error" in f:
                print(f"flight {f['path']}: ERROR {f['error']}")
                continue
            print(
                f"flight {f['path']}: trigger={f['trigger']} "
                f"pid={f['pid']} entries={f['entries']}"
            )
            for line in f["tail"]:
                print(line)
    if report["generations"] and not report["usable"]:
        return EXIT_INPUT_ERROR
    return EXIT_OK


def _flight_dumps(directory: str, tail: int = 8) -> list:
    """Flight-recorder dumps found in a serve directory, each summarized
    for the recover report: trigger, pid, entry count, and the rendered
    tail (the newest ``tail`` ring entries — the moments before the
    trigger)."""
    import glob
    import os

    from .observe.flight import load_dump, render_dump

    out = []
    for path in sorted(glob.glob(os.path.join(directory, "flight-*.json"))):
        name = os.path.basename(path)
        try:
            payload = load_dump(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            out.append({"path": name, "error": f"{type(e).__name__}: {e}"})
            continue
        lines = render_dump(payload)
        out.append(
            {
                "path": name,
                "trigger": payload.get("trigger"),
                "info": payload.get("info"),
                "pid": payload.get("pid"),
                "ts": payload.get("ts"),
                "entries": len(payload.get("entries", [])),
                "tail": lines[-tail:] if len(lines) > 1 else [],
            }
        )
    return out


def cmd_warmup(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_warmup(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_warmup(args) -> int:
    """Pre-populate a warm kernel pack for a config: build the engine (its
    build launches, and so builds, the hand-written kernels), drive the
    batched query plane, then copy every built kernel library and the
    recorded dispatch keys into the pack (``observe/aot.py``).
    ``kv-tpu-torch serve``/``query --from-snapshot`` and checkpoint recovery
    ride the resulting pack: a host without ``nvcc`` loads the libraries
    instead of building them."""
    from .observe import aot
    from .resilience.errors import EXIT_OK
    from .serve import QueryEngine, ServeConfig

    svc, _skipped = _load_serve_service(args, ServeConfig())
    q = QueryEngine(svc)
    pods = svc.engine.pods
    if len(pods) >= 2:
        names = [f"{p.namespace}/{p.name}" for p in pods[:8]]
        probes = [
            (names[i], names[(i + 1) % len(names)], None, "TCP")
            for i in range(len(names))
        ]
        q.can_reach_batch(probes)
        q.who_can_reach(names[0])
        q.blast_radius(names[0])
    summary = aot.save_pack(args.out)
    if args.json:
        print(json.dumps(summary, sort_keys=True))
    else:
        print(
            f"warmup: {summary['entries']} entries "
            f"({', '.join(summary['libraries']) or 'no kernel library'}; "
            f"{summary['new']} new, {summary['skipped']} "
            f"skipped) in {summary['directory']} "
            f"[{summary['bytes']} bytes]"
        )
    return EXIT_OK


def _parse_probe_batch(path: str):
    """Parse a ``--batch`` JSONL probe file into ``(src, dst, port,
    protocol)`` tuples — shared by ``kv-tpu-torch query`` and ``kv-tpu-torch lb``."""
    from .resilience.errors import IngestError

    probes = []
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except OSError as e:
        raise IngestError(f"cannot read query batch {path}: {e}") from e
    for ln_no, line in enumerate(lines, 1):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except ValueError as e:
            raise IngestError(
                f"{path}:{ln_no}: not valid JSON: {e}"
            ) from e
        if not isinstance(obj, dict) or "src" not in obj or "dst" not in obj:
            raise IngestError(
                f"{path}:{ln_no}: each probe needs 'src' and "
                "'dst' (optional: 'port', 'protocol')"
            )
        unknown = set(obj) - {"src", "dst", "port", "protocol"}
        if unknown:
            raise IngestError(
                f"{path}:{ln_no}: unknown field(s) {sorted(unknown)}"
            )
        port = obj.get("port")
        if port is not None:
            try:
                port = int(port)
            except (TypeError, ValueError):
                raise IngestError(
                    f"{path}:{ln_no}: port must be an integer, "
                    f"got {obj['port']!r}"
                ) from None
        probes.append(
            (
                str(obj["src"]),
                str(obj["dst"]),
                port,
                str(obj.get("protocol", "TCP")),
            )
        )
    return probes


def cmd_query(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_query(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_query(args) -> int:
    from .resilience.errors import EXIT_OK, EXIT_VIOLATIONS
    from .serve import (
        AddPolicy,
        QueryEngine,
        ServeConfig,
        load_assertions,
    )

    svc, _skipped = _load_serve_service(args, ServeConfig())
    assertions = (
        load_assertions(args.assert_file)
        if getattr(args, "assert_file", None)
        else []
    )
    q = QueryEngine(svc)
    out = {}
    exit_code = EXIT_OK
    if args.can_reach:
        src, dst = args.can_reach
        ok = q.can_reach(src, dst, port=args.port, protocol=args.protocol)
        out["can_reach"] = {
            "src": src, "dst": dst, "port": args.port,
            "protocol": args.protocol if args.port is not None else None,
            "allowed": ok,
        }
    if getattr(args, "batch", None):
        probes = _parse_probe_batch(args.batch)
        answers = q.can_reach_batch(probes)
        out["batch"] = {
            "file": args.batch,
            "n": len(probes),
            "allowed": int(answers.sum()),
            "results": [
                {
                    "src": s,
                    "dst": d,
                    "port": p,
                    "protocol": proto if p is not None else None,
                    "allowed": bool(a),
                }
                for (s, d, p, proto), a in zip(probes, answers)
            ],
        }
    if args.who_can_reach:
        out["who_can_reach"] = {
            "dst": args.who_can_reach,
            "sources": q.who_can_reach(args.who_can_reach),
        }
    if args.blast_radius:
        out["blast_radius"] = {
            "src": args.blast_radius,
            "targets": q.blast_radius(args.blast_radius),
        }
    if getattr(args, "path_exists", None):
        src, dst = args.path_exists
        out["path_exists"] = {
            "src": src, "dst": dst, "max_hops": args.max_hops,
            "exists": q.path_exists(src, dst, max_hops=args.max_hops),
        }
    if getattr(args, "hops", None):
        src, dst = args.hops
        out["hops"] = {
            "src": src, "dst": dst, "max_hops": args.max_hops,
            "hops": q.hops(src, dst, max_hops=args.max_hops),
        }
    if args.what_if:
        import kubernetes_verification_tpu_torch as kv

        delta, _ = kv.load_cluster(args.what_if)
        if not delta.policies:
            raise SystemExit(
                f"--what-if {args.what_if}: no NetworkPolicy documents found"
            )
        res = q.what_if(
            [AddPolicy(policy=p) for p in delta.policies],
            assertions=assertions or None,
        )
        out["what_if"] = res.to_dict()
        if not res.ok:
            exit_code = EXIT_VIOLATIONS
    elif assertions:
        svc.assertions.extend(assertions)
        found = svc.check_assertions()
        out["assertions"] = {
            "checked": len(assertions),
            "violations": [v.describe() for v in found],
        }
        if found:
            exit_code = EXIT_VIOLATIONS
    if not out:
        raise SystemExit(
            "query: nothing to answer — give --can-reach SRC DST, "
            "--batch FILE.jsonl, --who-can-reach DST, --blast-radius SRC, "
            "--path-exists SRC DST, --hops SRC DST, "
            "--what-if MANIFESTS and/or --assert FILE"
        )
    if args.json:
        print(json.dumps(out, sort_keys=True))
    else:
        if "can_reach" in out:
            c = out["can_reach"]
            via = (
                f" on {c['protocol']}/{c['port']}"
                if c["port"] is not None
                else ""
            )
            print(
                f"{c['src']} -> {c['dst']}{via}: "
                f"{'ALLOWED' if c['allowed'] else 'DENIED'}"
            )
        if "batch" in out:
            b = out["batch"]
            for r in b["results"]:
                via = (
                    f" on {r['protocol']}/{r['port']}"
                    if r["port"] is not None
                    else ""
                )
                print(
                    f"{r['src']} -> {r['dst']}{via}: "
                    f"{'ALLOWED' if r['allowed'] else 'DENIED'}"
                )
            print(f"batch {b['file']}: {b['allowed']}/{b['n']} allowed")
        if "who_can_reach" in out:
            w = out["who_can_reach"]
            print(f"{len(w['sources'])} pods can reach {w['dst']}: "
                  f"{w['sources']}")
        if "blast_radius" in out:
            b = out["blast_radius"]
            print(f"{b['src']} can reach {len(b['targets'])} pods: "
                  f"{b['targets']}")
        if "path_exists" in out:
            pe = out["path_exists"]
            bound = (
                f" within {pe['max_hops']} hops"
                if pe["max_hops"] is not None
                else ""
            )
            print(
                f"path {pe['src']} ->* {pe['dst']}{bound}: "
                f"{'EXISTS' if pe['exists'] else 'NONE'}"
            )
        if "hops" in out:
            h = out["hops"]
            bound = (
                f" within {h['max_hops']} hops"
                if h["max_hops"] is not None
                else ""
            )
            print(
                f"hops {h['src']} ->* {h['dst']}{bound}: "
                + (str(h["hops"]) if h["hops"] > 0 else "UNREACHABLE")
            )
        if "what_if" in out:
            w = out["what_if"]
            print(
                f"what-if: {'OK' if w['ok'] else 'REJECTED'} "
                f"(+{w['pairs_added']} / -{w['pairs_removed']} pairs)"
            )
            for line in w["violations"]:
                print(f"  VIOLATION: {line}")
        if "assertions" in out:
            a = out["assertions"]
            print(f"{a['checked']} assertions checked, "
                  f"{len(a['violations'])} violated")
            for line in a["violations"]:
                print(f"  VIOLATION: {line}")
    return exit_code


def cmd_lb(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_lb(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_lb(args) -> int:
    """``kv-tpu-torch lb``: answer ``--batch`` probe files through a
    staleness-weighted load balancer over follower replicas. Each
    ``--replica`` is a checkpoint directory (shared-fs follower) or
    ``DIR=URL`` (networked follower bootstrapped over HTTP from the
    replication server at URL into DIR). ``--leader DIR`` wires the
    stale-read retry / last-resort fallback."""
    from .resilience.errors import EXIT_OK, EXIT_VIOLATIONS
    from .serve import FollowerService, QueryLoadBalancer

    device = _device(args)
    replicas = []
    for i, spec in enumerate(args.replica):
        directory, sep, url = spec.partition("=")
        replicas.append(
            FollowerService(
                directory,
                log_path=args.events,
                replica=f"replica-{i}",
                max_lag_seconds=args.staleness,
                leader_url=url if sep else None,
                device=device,
            )
        )
    leader = None
    if args.leader:
        # no staleness bound: the leader's directory IS the fresh state
        leader = FollowerService(
            args.leader, log_path=args.events, replica="leader",
            device=device,
        )
    lb = QueryLoadBalancer(replicas, leader=leader, seed=args.seed)
    batches = []
    denied = 0
    for path in args.batch:
        probes = _parse_probe_batch(path)
        answers, who = lb.can_reach_batch(probes)
        allowed = int(answers.sum())
        denied += len(probes) - allowed
        batches.append(
            {
                "file": path,
                "n": len(probes),
                "allowed": allowed,
                "replica": who,
            }
        )
    out = {"batches": batches, "lb": lb.describe()}
    if args.json:
        print(json.dumps(out, sort_keys=True))
    else:
        for b in batches:
            print(
                f"{b['file']}: {b['allowed']}/{b['n']} allowed "
                f"(answered by {b['replica']})"
            )
        routed = ", ".join(
            f"{who}={n}" for who, n in sorted(lb.routed.items())
        )
        print(
            f"routed: {routed or 'nothing'}  "
            f"stale_retries: {lb.stale_retries}  ejections: {lb.ejections}"
        )
    if args.check_denied and denied:
        return EXIT_VIOLATIONS
    return EXIT_OK


def _metrics_source_text(source: str, timeout: float = 5.0) -> str:
    """Exemplar-annotated metrics text from a replica URL or a saved file."""
    if source.startswith(("http://", "https://")):
        from .serve.transport import ReplicationClient

        return ReplicationClient(source, timeout=timeout).metrics_text(
            exemplars=True
        )
    try:
        with open(source) as fh:
            return fh.read()
    except OSError as e:
        raise SystemExit(f"trace: cannot read metrics source {source}: {e}")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def cmd_trace(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_trace(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_trace(args) -> int:
    """``kv-tpu-torch trace``: reassemble one trace's cross-process timeline.

    Every span close and event line carries ``trace_id`` (propagated over
    HTTP via the ``X-Kvtpu-Trace`` header), a wall-clock ``ts``/``start_ts``
    and span/parent ids — so scanning each replica's JSON event log for one
    trace id and sorting by wall time rebuilds the span tree across
    processes, plus the query stage breakdown (queue/dispatch/solve/d2h).

    ``--slowest`` closes the metric→trace loop: instead of a trace id,
    read ``/metrics?exemplars=1`` output (``--metrics`` URL or file),
    take the highest-valued latency exemplar (optionally pinned to one
    ``--stage``), and reassemble *that* trace — from "the histogram says
    something was slow" to the full cross-process timeline of the slow
    request, no log spelunking for the id."""
    from .resilience.errors import EXIT_OK, EXIT_VIOLATIONS

    if args.slowest:
        from .observe.export import parse_exemplars

        if not args.metrics:
            raise SystemExit(
                "trace: --slowest needs --metrics URL|FILE "
                "(an exemplar-annotated /metrics source)"
            )
        exemplars = []
        for source in args.metrics:
            exemplars.extend(
                parse_exemplars(_metrics_source_text(source))
            )
        if args.stage:
            exemplars = [
                e
                for e in exemplars
                if e["labels"].get("stage") == args.stage
            ]
        exemplars = [e for e in exemplars if e["exemplar"].get("trace_id")]
        if not exemplars:
            stage = f" for stage {args.stage!r}" if args.stage else ""
            print(f"trace: no exemplars{stage} in the metrics source(s)",
                  file=sys.stderr)
            return EXIT_VIOLATIONS
        best = max(exemplars, key=lambda e: e["value"])
        args.trace_id = best["exemplar"]["trace_id"]
        print(
            f"slowest exemplar: {best['name']}"
            f"{_fmt_labels(best['labels'])} = {best['value']:.6g}s "
            f"-> trace {args.trace_id}"
        )
    elif not args.trace_id:
        raise SystemExit("trace: give a TRACE_ID or use --slowest")

    spans: dict = {}  # span_id -> span-close line (+ source log)
    events = []  # non-span lines in the trace
    for path in args.log:
        try:
            fh = open(path)
        except OSError as e:
            raise SystemExit(f"trace: cannot read {path}: {e}")
        with fh:
            for raw in fh:
                raw = raw.strip()
                if not raw or not raw.startswith("{"):
                    continue
                try:
                    line = json.loads(raw)
                except ValueError:
                    continue
                if (
                    not isinstance(line, dict)
                    or line.get("trace_id") != args.trace_id
                ):
                    continue
                line["_log"] = os.path.basename(path)
                if (
                    line.get("event") in ("span", "phase")
                    and line.get("span_id")
                    and line.get("seconds") is not None
                ):
                    # first writer wins: the same span duplicated across
                    # logs (shared event file) renders once
                    spans.setdefault(line["span_id"], line)
                else:
                    events.append(line)
    if not spans and not events:
        print(
            f"trace {args.trace_id}: no matching lines in "
            f"{len(args.log)} log(s)",
            file=sys.stderr,
        )
        return EXIT_VIOLATIONS

    children: dict = {}
    roots = []
    for sid, sp in spans.items():
        pid = sp.get("parent_id")
        if pid in spans:
            children.setdefault(pid, []).append(sid)
        else:
            roots.append(sid)
    start_key = lambda sid: spans[sid].get("start_ts") or 0.0  # noqa: E731

    ordered = []  # (depth, span line) in timeline order

    def _walk(sid: str, depth: int) -> None:
        ordered.append((depth, spans[sid]))
        for kid in sorted(children.get(sid, []), key=start_key):
            _walk(kid, depth + 1)

    for sid in sorted(roots, key=start_key):
        _walk(sid, 0)

    # query stage breakdown: stage-attributed spans vs. the batch span
    stages: dict = {}
    e2e = 0.0
    for _, sp in ordered:
        if sp.get("stage"):
            stages[sp["stage"]] = (
                stages.get(sp["stage"], 0.0) + float(sp["seconds"])
            )
        if sp.get("name") == "query_batch":
            e2e += float(sp["seconds"])

    if args.json:
        print(
            json.dumps(
                {
                    "trace_id": args.trace_id,
                    "logs": args.log,
                    "spans": [
                        dict(sp, depth=depth) for depth, sp in ordered
                    ],
                    "events": events,
                    "stages": stages,
                    "e2e_seconds": e2e or None,
                },
                sort_keys=True,
            )
        )
        return EXIT_OK

    t0 = min(
        (sp.get("start_ts") for _, sp in ordered if sp.get("start_ts")),
        default=None,
    )
    n_logs = len({sp["_log"] for _, sp in ordered})
    print(
        f"trace {args.trace_id}: {len(ordered)} spans, "
        f"{len(events)} events across {n_logs} process log(s)"
    )
    for depth, sp in ordered:
        off = (
            f"+{(sp['start_ts'] - t0) * 1000.0:9.3f}ms"
            if t0 is not None and sp.get("start_ts")
            else " " * 11
        )
        dur = f"{float(sp['seconds']) * 1000.0:.3f}ms"
        flag = "" if sp.get("ok", True) else "  FAILED"
        print(
            f"{off}  {'  ' * depth}{sp.get('name', '?')} {dur} "
            f"[{sp['_log']}]{flag}"
        )
    if stages:
        parts = "  ".join(
            f"{k}={v * 1000.0:.3f}ms"
            for k, v in sorted(stages.items())
        )
        total = sum(stages.values())
        tail = (
            f"  (sum {total * 1000.0:.3f}ms, e2e {e2e * 1000.0:.3f}ms)"
            if e2e
            else f"  (sum {total * 1000.0:.3f}ms)"
        )
        print(f"stages: {parts}{tail}")
    return EXIT_OK


def cmd_fleet(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_fleet(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_fleet(args) -> int:
    """``kv-tpu-torch fleet``: scrape every ``--replica`` URL's ``/healthz`` +
    ``/metrics``, render the fleet table, and evaluate the ``--slo``
    objectives' multi-window burn rates (exit 1 past ``--burn-threshold``)."""
    from .observe.fleet import (
        SloMonitor,
        fleet_row,
        parse_slo_spec,
        render_fleet,
        scrape_replica,
        stripe_coverage,
    )
    from .resilience.errors import EXIT_OK, EXIT_VIOLATIONS

    try:
        objectives = [
            parse_slo_spec(s) for s in (args.slo or ["availability=0.999"])
        ]
    except ValueError as e:
        raise SystemExit(f"fleet: {e}")
    monitor = SloMonitor(objectives)
    scrapes = [
        scrape_replica(url, timeout=args.timeout) for url in args.replica
    ]
    for s in scrapes:
        monitor.observe_scrape(s)
    burns = monitor.evaluate()
    worst = max(
        (b for per in burns.values() for b in per.values()), default=0.0
    )
    if args.json:
        inf = float("inf")
        print(
            json.dumps(
                {
                    # each replica object mirrors the table row
                    # (fleet_row) plus the raw health document
                    "replicas": [
                        dict(fleet_row(s), health=s.health)
                        for s in scrapes
                    ],
                    "slo": {
                        name: {
                            label: ("inf" if b == inf else b)
                            for label, b in per.items()
                        }
                        for name, per in burns.items()
                    },
                    "burn_threshold": args.burn_threshold,
                    # fleet-wide stripe coverage (None for a whole-state
                    # fleet): a stripe with no live owner is an outage,
                    # surfaced here and as the table's GAP line
                    "stripe_coverage": stripe_coverage(scrapes),
                },
                sort_keys=True,
            )
        )
    else:
        for line in render_fleet(scrapes):
            print(line)
        for name, per in sorted(burns.items()):
            txt = "  ".join(
                f"{label}={burn:.3g}"
                for label, burn in sorted(per.items())
            )
            verdict = (
                "BURNING"
                if max(per.values(), default=0.0) > args.burn_threshold
                else "ok"
            )
            print(f"slo {name}: {txt}  [{verdict}]")
    if worst > args.burn_threshold:
        return EXIT_VIOLATIONS
    return EXIT_OK


def cmd_posture(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_posture(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _posture_journal_path(arg: str) -> str:
    import os

    from .serve.posture import POSTURE_JOURNAL

    path = arg
    if os.path.isdir(path):
        path = os.path.join(path, POSTURE_JOURNAL)
    if not os.path.exists(path):
        raise SystemExit(f"posture: no journal at {path}")
    return path


def _run_posture(args) -> int:
    """``kv-tpu-torch posture``: read a crc'd posture journal — timeline of
    per-generation reach deltas, ``--watch`` tailing, ``--diff A B``
    aggregation. Exit 1 when any rendered record carries an alert
    violation (the CI-gate contract); a torn journal tail is reported on
    stderr, everything before it is trusted."""
    import time as _time

    from .resilience.errors import EXIT_OK, EXIT_VIOLATIONS
    from .serve.posture import (
        posture_diff,
        render_posture_timeline,
        scan_posture,
    )

    path = _posture_journal_path(args.journal)
    scan = scan_posture(path)
    if not scan.ok:
        print(
            f"posture: journal torn at line {scan.torn_lineno} "
            f"({scan.torn_error}); rendering the valid prefix",
            file=sys.stderr,
        )
    records = scan.records

    if args.diff:
        gen_a, gen_b = args.diff
        diff = posture_diff(records, gen_a, gen_b)
        if args.json:
            print(json.dumps(diff, sort_keys=True))
        else:
            print(
                f"gen {diff['gen_a']} -> {diff['gen_b']} "
                f"({diff['generations']} generations): "
                f"+{diff['widened']}/-{diff['narrowed']} pairs, "
                f"reachable {diff['reachable_at_a']} -> "
                f"{diff['reachable_at_b']}"
            )
            for label, moved in (
                ("widened", diff["ns_widened"]),
                ("narrowed", diff["ns_narrowed"]),
            ):
                for pair, count in moved.items():
                    print(f"  {label} {pair}: {count}")
            if diff["alerts"]:
                print(f"  alert violations in range: {diff['alerts']}")
        return EXIT_VIOLATIONS if diff["alerts"] else EXIT_OK

    if args.watch:
        seen = 0
        idle_since = _time.monotonic()
        violations = 0
        try:
            while True:
                scan = scan_posture(path)
                fresh = scan.records[seen:]
                for r in fresh:
                    violations += len(r.alerts)
                    if args.json:
                        print(json.dumps(r.to_dict(), sort_keys=True))
                    else:
                        for line in render_posture_timeline(
                            [r], limit=1
                        )[1:]:
                            print(line)
                if fresh:
                    seen = len(scan.records)
                    idle_since = _time.monotonic()
                elif (
                    args.idle_timeout is not None
                    and _time.monotonic() - idle_since >= args.idle_timeout
                ):
                    break
                _time.sleep(args.poll)
        except KeyboardInterrupt:
            pass
        return EXIT_VIOLATIONS if violations else EXIT_OK

    shown = list(records)[-args.limit:]
    if args.json:
        print(
            json.dumps(
                {
                    "journal": path,
                    "records": [r.to_dict() for r in shown],
                    "torn_lineno": scan.torn_lineno,
                },
                sort_keys=True,
            )
        )
    else:
        for line in render_posture_timeline(records, limit=args.limit):
            print(line)
    return (
        EXIT_VIOLATIONS if any(r.alerts for r in shown) else EXIT_OK
    )


def cmd_jobs(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_jobs(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_jobs(args) -> int:
    """``kv-tpu-torch jobs``: the fleet's in-flight long jobs. Every replica's
    ``/healthz`` carries its process's live progress table (pass counters,
    smoothed rates, ETAs — the :class:`~.observe.progress.ProgressTicker`
    plane); this merges them into one table. A dead replica degrades to a
    stderr note — the rest still render."""
    from .observe.fleet import scrape_replica
    from .observe.progress import render_jobs
    from .resilience.errors import EXIT_OK

    scrapes = [
        scrape_replica(url, timeout=args.timeout) for url in args.replica
    ]
    jobs, down = [], []
    for s in scrapes:
        if not s.ok:
            down.append({"url": s.url, "error": s.error})
            continue
        for j in (s.health or {}).get("jobs") or []:
            jobs.append(dict(j, replica=s.url))
    if args.json:
        print(json.dumps({"jobs": jobs, "down": down}, sort_keys=True))
        return EXIT_OK
    if jobs:
        for line in render_jobs(jobs):
            print(line)
    else:
        print("no jobs in flight")
    for d in down:
        print(f"{d['url']}: DOWN ({d['error']})", file=sys.stderr)
    return EXIT_OK


def cmd_profile(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_profile(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_profile(args) -> int:
    """``kv-tpu-torch profile``: on-demand bounded deep profiling. With
    ``--replica`` it triggers a capture on a *running* replica
    (``/profile?seconds=N`` — no restart); without, it captures in this
    process into ``--dir``. Either way the capture is a bounded
    ``torch.profiler`` trace, rate-limited so a scrape loop cannot DoS the
    device, and recorded in the capture directory's manifest."""
    from .resilience.errors import EXIT_OK, EXIT_VIOLATIONS

    if args.replica:
        from .serve.transport import ReplicationClient

        client = ReplicationClient(
            args.replica, timeout=max(args.timeout, args.seconds + 10.0)
        )
        result = client.profile(args.seconds)
    else:
        from .observe.spans import capture_profile

        result = capture_profile(
            args.seconds, trigger="cli", capture_dir=args.dir
        )
    if args.json:
        print(json.dumps(result, sort_keys=True))
        return (
            EXIT_OK if result.get("outcome") == "ok" else EXIT_VIOLATIONS
        )
    outcome = result.get("outcome")
    if outcome == "ok":
        print(
            f"captured {result.get('seconds')}s -> {result.get('path')} "
            f"({result.get('files')} files)"
        )
        return EXIT_OK
    if outcome == "rate-limited":
        print(
            f"profile: rate-limited, retry in "
            f"{result.get('retry_after_s', 0.0):.1f}s",
            file=sys.stderr,
        )
    else:
        print(
            f"profile: {outcome}: {result.get('reason', '-')}",
            file=sys.stderr,
        )
    return EXIT_VIOLATIONS


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def _spark(values, width: int = 16) -> str:
    """Unicode sparkline over the last ``width`` samples; None samples
    (scrape misses) render as gaps, a flat series as its floor block."""
    vals = list(values)[-width:]
    finite = [v for v in vals if v is not None]
    if not finite:
        return "-" * min(len(vals) or 1, width)
    lo, hi = min(finite), max(finite)
    span = hi - lo
    out = []
    for v in vals:
        if v is None:
            out.append(" ")
        elif span <= 0:
            out.append(_SPARK_BLOCKS[0])
        else:
            idx = int((v - lo) / span * (len(_SPARK_BLOCKS) - 1) + 0.5)
            out.append(_SPARK_BLOCKS[min(len(_SPARK_BLOCKS) - 1, idx)])
    return "".join(out)


def cmd_top(args) -> int:
    from .resilience.errors import KvTpuError

    try:
        with _observed(args):
            return _run_top(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def _run_top(args) -> int:
    """``kv-tpu-torch top``: a live terminal dashboard over the scrape surface —
    the fleet table, every in-flight job with its ETA bar, QPS / lag /
    burn-rate sparklines per poll, and recent crash flight dumps. A dead
    replica renders as a DOWN row and a gap in its sparklines; the rest of
    the fleet keeps updating. ``--once`` renders a single frame (no screen
    clearing) for scripts and tests."""
    import collections
    import time as _time

    from .observe.fleet import (
        SloMonitor,
        parse_slo_spec,
        render_fleet,
        scrape_replica,
    )
    from .observe.progress import render_jobs
    from .resilience.errors import EXIT_OK

    try:
        objectives = [
            parse_slo_spec(s) for s in (args.slo or ["availability=0.999"])
        ]
    except ValueError as e:
        raise SystemExit(f"top: {e}")
    monitor = SloMonitor(objectives)
    depth = 24
    hist = {
        url: {
            "qps": collections.deque(maxlen=depth),
            "lag": collections.deque(maxlen=depth),
        }
        for url in args.replica
    }
    burn_hist: collections.deque = collections.deque(maxlen=depth)
    prev: dict = {}  # url -> (queries_total, monotonic ts)
    prev_shed: dict = {}  # url -> ({tenant: rejections_total}, monotonic ts)
    shed_rates: dict = {}  # url -> {tenant: sheds/s}
    quota_util: dict = {}  # url -> {tenant: bucket utilization 0..1}
    frames = 0
    try:
        while True:
            scrapes = [
                scrape_replica(url, timeout=args.timeout)
                for url in args.replica
            ]
            now = _time.monotonic()
            for s in scrapes:
                monitor.observe_scrape(s)
                qps = None
                if s.ok and s.metrics is not None:
                    total = sum(
                        v
                        for _, v in s.metrics.get(
                            "kvtpu_serve_queries_total", []
                        )
                    )
                    p = prev.get(s.url)
                    if p is not None and now > p[1]:
                        qps = max(0.0, (total - p[0]) / (now - p[1]))
                    prev[s.url] = (total, now)
                    # per-tenant admission telemetry: shed-rate from the
                    # rejection counter deltas, quota utilisation straight
                    # off the gauge
                    shed: dict = {}
                    for labels, v in s.metrics.get(
                        "kvtpu_admission_rejections_total", []
                    ):
                        t = labels.get("tenant")
                        if t is not None:
                            shed[t] = shed.get(t, 0.0) + v
                    ps = prev_shed.get(s.url)
                    if ps is not None and now > ps[1]:
                        dt = now - ps[1]
                        shed_rates[s.url] = {
                            t: max(0.0, (v - ps[0].get(t, 0.0)) / dt)
                            for t, v in shed.items()
                        }
                    prev_shed[s.url] = (shed, now)
                    quota_util[s.url] = {
                        labels["tenant"]: v
                        for labels, v in s.metrics.get(
                            "kvtpu_admission_quota_utilization", []
                        )
                        if "tenant" in labels
                    }
                hist[s.url]["qps"].append(qps)
                hist[s.url]["lag"].append(s.lag_seconds)
            burns = monitor.evaluate()
            inf = float("inf")
            burn_hist.append(
                max(
                    (
                        b
                        for per in burns.values()
                        for b in per.values()
                        if b != inf
                    ),
                    default=0.0,
                )
            )
            lines = list(render_fleet(scrapes))
            jobs, dumps = [], []
            for s in scrapes:
                if s.ok and s.health:
                    jobs.extend(s.health.get("jobs") or [])
                    dumps.extend(s.health.get("flight_dumps") or [])
            lines.append("")
            if jobs:
                lines.append(f"jobs ({len(jobs)} in flight):")
                lines.extend("  " + row for row in render_jobs(jobs))
            else:
                lines.append("jobs: none in flight")
            lines.append("")
            for s in scrapes:
                h = hist[s.url]
                last_qps = next(
                    (v for v in reversed(h["qps"]) if v is not None), None
                )
                last_lag = next(
                    (v for v in reversed(h["lag"]) if v is not None), None
                )
                qtxt = "-" if last_qps is None else f"{last_qps:.1f}"
                ltxt = "-" if last_lag is None else f"{last_lag:.3f}"
                lines.append(
                    f"{s.url}  qps {_spark(h['qps'])} {qtxt}  "
                    f"lag_s {_spark(h['lag'])} {ltxt}"
                )
                tenants = sorted(
                    set(shed_rates.get(s.url, {}))
                    | set(quota_util.get(s.url, {}))
                )
                if tenants:
                    cells = []
                    for t in tenants:
                        rate = shed_rates.get(s.url, {}).get(t)
                        util = quota_util.get(s.url, {}).get(t)
                        rtxt = "-" if rate is None else f"{rate:.1f}"
                        utxt = "-" if util is None else f"{util:.2f}"
                        cells.append(f"{t} shed/s {rtxt} quota {utxt}")
                    lines.append("  tenants: " + "; ".join(cells))
            lines.append(
                f"burn (worst finite)  {_spark(burn_hist)} "
                f"{burn_hist[-1]:.3g}"
            )
            if dumps:
                uniq = sorted(set(dumps), reverse=True)[:5]
                lines.append("flight dumps: " + ", ".join(uniq))
            frames += 1
            if args.once:
                print("\n".join(lines))
                return EXIT_OK
            sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(lines) + "\n")
            sys.stdout.flush()
            if args.frames and frames >= args.frames:
                return EXIT_OK
            _time.sleep(args.interval)
    except KeyboardInterrupt:
        return EXIT_OK


def cmd_backends(_args) -> int:
    import kubernetes_verification_tpu_torch as kv

    for name in kv.available_backends():
        print(name)
    return 0


def cmd_metrics(args) -> int:
    from .observe import dump_registry, to_prometheus

    if args.file:
        if args.format == "prom":
            raise SystemExit(
                "--format prom renders the live registry; saved dumps are "
                "JSON — point --metrics-out at a .prom path to get "
                "Prometheus text directly"
            )
        with open(args.file) as fh:
            print(json.dumps(json.load(fh), indent=2, sort_keys=True))
        return 0
    # live registry: freshly-started process, so values are zero — this is
    # the metric-name/label schema reference (all families register at
    # import time)
    if args.format == "prom":
        print(to_prometheus(), end="")
    else:
        print(
            json.dumps(
                dump_registry(include_buckets=False), indent=2, sort_keys=True
            )
        )
    return 0


def cmd_lint(args) -> int:
    """``kv-tpu-torch lint``: the analysis framework's driver behind the
    shared KvTpuError → exit-code contract (a bad --rules id is exit 2,
    like any other input error). Linting reads source on the host: no
    ``--device``."""
    from .analysis import run_from_args
    from .resilience.errors import KvTpuError

    try:
        return run_from_args(args)
    except KvTpuError as e:
        return _diagnose(args, e)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="kv-tpu-torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("verify", help="verify manifests under PATH")
    p.add_argument("path")
    _add_verify_flags(p)
    _add_obs_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser(
        "snapshot",
        help="build a packed incremental verifier from manifests and "
        "checkpoint it",
    )
    p.add_argument("path", help="manifest file/dir")
    p.add_argument("dir", help="checkpoint directory to write")
    p.add_argument(
        "--no-ports", dest="ports", action="store_false",
        help="any-port engine (default: port-bitmap engine)",
    )
    p.add_argument("--no-self-traffic", dest="self_traffic", action="store_false")
    p.add_argument("--no-default-allow", dest="default_allow", action="store_false")
    p.add_argument(
        "--headroom", type=int, default=8,
        help="free VP rows per port segment (ports engine)",
    )
    p.add_argument(
        "--pod-headroom", type=int, default=0,
        help="extra pod slots for add_pod without a grow",
    )
    p.add_argument(
        "--closure", action="store_true",
        help="also compute the packed transitive closure and persist it; "
        "later `kv-tpu-torch diff` runs maintain it incrementally "
        "(packed_closure_delta) instead of re-closing from scratch",
    )
    p.add_argument("--json", action="store_true")
    p.add_argument("--opt", action="append", default=[], metavar="KEY=VALUE")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_snapshot)

    p = sub.add_parser(
        "diff",
        help="apply pod/policy diffs to a checkpointed verifier and save",
    )
    p.add_argument("dir", help="checkpoint directory (from kv-tpu-torch snapshot)")
    p.add_argument(
        "--apply", action="append", default=[], metavar="PATH",
        help="YAML manifests to add/update (repeatable); existing pods "
        "relabel in place, existing policies update",
    )
    p.add_argument(
        "--remove", action="append", default=[], metavar="KIND/NS/NAME",
        help="remove a pod, policy or (emptied) namespace, e.g. --remove "
        "pod/prod/web-1 --remove policy/prod/allow-http --remove "
        "namespace/prod (repeatable, applied in order)",
    )
    p.add_argument("--out", help="save to a different directory")
    p.add_argument(
        "--no-save", action="store_true",
        help="apply + report only; leave the checkpoint untouched",
    )
    p.add_argument("--json", action="store_true")
    p.add_argument("--opt", action="append", default=[], metavar="KEY=VALUE")
    _add_obs_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser(
        "explain",
        help="export encoded model + Datalog program (PATH), or print a "
        "per-kernel cost/memory table (--pods/--backend)",
    )
    p.add_argument("path", nargs="?")
    p.add_argument("--out", default="model")
    p.add_argument("--no-ports", dest="ports", action="store_false")
    p.add_argument(
        "--pods", type=int, default=None,
        help="cost mode: synthesize a cluster of this many pods and report "
        "per-kernel operations/bytes/peak memory (with --device cpu on "
        "a host without a GPU)",
    )
    p.add_argument("--policies", type=int, default=8)
    p.add_argument("--namespaces", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--backend", default=None,
        help="cost mode: backend to introspect (default torch)",
    )
    p.add_argument(
        "--roofline", action="store_true",
        help="print achieved MACs/s as %% of device peak per recorded "
        "bench mode (published peak table of the record's device; "
        "sentinel-calibrated or analytic fallback otherwise); reads the "
        "bench history (PATH overrides the default file)",
    )
    p.add_argument("--json", action="store_true")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser(
        "history",
        help="show the bench-history trajectory and the regression gate "
        "verdict (exit 1 on a regression)",
    )
    p.add_argument(
        "paths", nargs="*",
        help="history files (default: bench_history.jsonl, else the "
        "committed BENCH_r*.json snapshots)",
    )
    p.add_argument(
        "--tolerance", type=float, default=0.25,
        help="relative slip vs. the trailing median before flagging "
        "(default 0.25)",
    )
    p.add_argument(
        "--window", type=int, default=5,
        help="trailing runs the median is taken over (default 5)",
    )
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_history)

    p = sub.add_parser("generate", help="write a synthetic cluster as YAML")
    p.add_argument("dir")
    p.add_argument("--pods", type=int, default=100)
    p.add_argument("--policies", type=int, default=50)
    p.add_argument("--namespaces", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--events-out", metavar="FILE",
        help="also write a churn event stream (JSONL) valid against the "
        "generated cluster, for kv-tpu-torch serve / bench.py --mode serve",
    )
    p.add_argument(
        "--n-events", type=int, default=500,
        help="events in the churn stream (with --events-out)",
    )
    p.add_argument(
        "--resync-rate", type=float, default=0.0,
        help="per-event probability of a full_resync relist in the stream",
    )
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser(
        "serve",
        help="continuous verification: apply a mutation-event stream to an "
        "incremental engine, check assertions, answer with exit codes",
    )
    p.add_argument("path", nargs="?", help="manifest file/dir (cold start)")
    p.add_argument(
        "--from-snapshot", metavar="DIR",
        help="warm restart from a serve snapshot instead of manifests "
        "(dense or packed — detected from the snapshot contents)",
    )
    p.add_argument(
        "--warm-pack", metavar="DIR",
        help="AOT executable pack to install before the engine is built "
        "(default: the aot-pack directory auto-detected next to "
        "--from-snapshot); see kv-tpu-torch warmup",
    )
    p.add_argument(
        "--events", metavar="FILE",
        help="JSONL mutation-event stream to apply (see kv-tpu-torch generate "
        "--events-out for the schema)",
    )
    p.add_argument(
        "--tail", action="store_true",
        help="keep polling --events for appended lines instead of one "
        "replay pass",
    )
    p.add_argument(
        "--idle-timeout", type=float, default=1.0, metavar="SECONDS",
        help="with --tail / --follow: stop after this long with no "
        "stream growth",
    )
    p.add_argument(
        "--tail-poll", type=float, default=0.05, metavar="SECONDS",
        help="base WAL poll interval while tailing; backs off "
        "exponentially (up to ~32x, capped at 1s) while the stream is "
        "idle and snaps back on growth",
    )
    p.add_argument(
        "--follow", metavar="DIR",
        help="run as a read-only follower replica of the leader whose "
        "checkpoints live in DIR: bootstrap from the newest valid "
        "generation, tail its WAL (--events overrides the manifest's "
        "log path), answer queries under the --staleness bound",
    )
    p.add_argument(
        "--stripe", metavar="K/N",
        help="run as stripe owner K of N (1-based): own only this "
        "contiguous pod-row stripe of the count state, bootstrap from "
        "manifests or a stripe-sliced checkpoint (--resume), and tail "
        "--events applying every mutation (cross-stripe effects fan "
        "out by design and are counted, never filtered)",
    )
    p.add_argument(
        "--replica", default="follower", metavar="NAME",
        help="with --follow / --stripe: this replica's name (lag "
        "gauges, lease holder on promotion; default for --stripe: "
        "stripe-K-of-N)",
    )
    p.add_argument(
        "--leader", metavar="URL",
        help="with --follow: the leader lives on another host — "
        "bootstrap its checkpoint over HTTP from the replication "
        "server at URL into the --follow directory and tail its WAL "
        "into a local byte mirror (--events then names the mirror "
        "file; default wal-mirror.jsonl inside the directory)",
    )
    p.add_argument(
        "--proxy-stale", action="store_true",
        help="with --follow: answer over-bound reads with leader-fresh "
        "state instead of raising StaleReadError",
    )
    p.add_argument(
        "--promote-on-lease-expiry", action="store_true",
        help="with --follow: promote to leader when the leader.lease "
        "expires AND the leader-probe breaker opens (fencing the old "
        "leader via the lease epoch)",
    )
    p.add_argument(
        "--lease-ttl", type=float, default=5.0, metavar="SECONDS",
        help="with --follow: lease time-to-live used when judging "
        "leader liveness and when renewing after a promotion",
    )
    p.add_argument(
        "--assert", dest="assert_file", metavar="FILE",
        help="declarative allow/deny assertion file (JSON), re-checked "
        "after every applied batch; violations exit 1 with a pod-pair "
        "witness",
    )
    p.add_argument(
        "--staleness", type=float, default=None, metavar="SECONDS",
        help="solve when applied-but-unsolved mutations age past this "
        "bound (default: fully lazy — solve on query/assertions only)",
    )
    p.add_argument(
        "--batch-size", type=int, default=256,
        help="max events coalesced into one engine batch",
    )
    p.add_argument(
        "--snapshot-out", metavar="DIR",
        help="snapshot the warm engine state here on exit (and every "
        "--snapshot-every batches)",
    )
    p.add_argument(
        "--snapshot-every", type=int, default=0, metavar="N",
        help="with --snapshot-out: also snapshot every N applied batches",
    )
    p.add_argument(
        "--checkpoint-dir", metavar="DIR",
        help="write atomic crash-safe checkpoints (engine snapshot + "
        "manifest binding the event-log offset) here; one is always "
        "taken on exit",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="N",
        help="with --checkpoint-dir: also checkpoint every N applied "
        "batches (0 = exit only)",
    )
    p.add_argument(
        "--resume", action="store_true",
        help="recover from the newest valid checkpoint in "
        "--checkpoint-dir (falling back to older generations on "
        "corruption) and replay --events past the recorded offset; "
        "PATH, if given, enables a from-scratch rebuild when every "
        "generation is damaged",
    )
    p.add_argument(
        "--posture", action="store_true",
        help="enable the posture observability plane: record the exact "
        "reachability delta (widened/narrowed pairs, per-namespace "
        "movement, top-k witnesses) for every applied batch",
    )
    p.add_argument(
        "--posture-journal", metavar="FILE",
        help="append each posture record to this crc'd JSONL journal "
        "(read back with kv-tpu-torch posture); implies --posture",
    )
    p.add_argument(
        "--posture-alert", action="append", default=[], metavar="RULE",
        help="posture drift alert rule, repeatable — 'deny ns:SRC -> "
        "ns:DST', 'max-widening N pairs/batch' or 'max-narrowing N "
        "pairs/batch'; violations exit 1, increment "
        "kvtpu_posture_alert_violations_total and flight-record the "
        "offending delta; implies --posture",
    )
    p.add_argument(
        "--posture-top-k", type=int, default=None, metavar="K",
        help="most-changed source rows decoded into witnesses per "
        "record (default 8; every extraction stays capped)",
    )
    p.add_argument("--no-self-traffic", dest="self_traffic", action="store_false")
    p.add_argument("--no-default-allow", dest="default_allow", action="store_false")
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "recover",
        help="inspect a serve checkpoint directory: per-generation "
        "manifest/snapshot health and the event log's valid prefix "
        "(read-only; exit 2 when nothing is recoverable)",
    )
    p.add_argument("dir", help="a kv-tpu-torch serve --checkpoint-dir directory")
    p.add_argument(
        "--events", metavar="FILE",
        help="also scan this event log (WAL) without repairing it",
    )
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    p.set_defaults(fn=cmd_recover)

    p = sub.add_parser(
        "warmup",
        help="pre-populate a warm executable pack (AOT kernel cache) for "
        "a config: build the engine, drive the representative kernels, "
        "and persist serialized executables for serve/query "
        "--from-snapshot and checkpoint recovery to ride",
    )
    p.add_argument("path", nargs="?", help="manifest file/dir")
    p.add_argument(
        "--from-snapshot", metavar="DIR",
        help="warm up against a serve snapshot instead of manifests "
        "(records the exact shapes that snapshot serves)",
    )
    p.add_argument(
        "--out", required=True, metavar="DIR",
        help="pack directory to write — point it at "
        "CHECKPOINT_DIR/aot-pack to pre-warm a checkpoint directory",
    )
    p.add_argument(
        "--warm-pack", metavar="DIR",
        help="existing pack to install first (the written pack then "
        "extends it incrementally)",
    )
    p.add_argument("--no-self-traffic", dest="self_traffic", action="store_false")
    p.add_argument("--no-default-allow", dest="default_allow", action="store_false")
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser(
        "query",
        help="one-shot queries against a cluster or serve snapshot: "
        "can-reach (scalar or --batch JSONL) / who-can-reach / "
        "blast-radius / path-exists & hops (bounded closure) / "
        "what-if admission",
    )
    p.add_argument("path", nargs="?", help="manifest file/dir")
    p.add_argument(
        "--from-snapshot", metavar="DIR",
        help="query a serve snapshot instead of manifests; the engine "
        "kind is auto-detected, and a packed (bitmap-state) snapshot "
        "answers --batch from device-resident uint32 word rows without "
        "materialising the dense reach matrix",
    )
    p.add_argument(
        "--warm-pack", metavar="DIR",
        help="AOT executable pack to install before the engine is built "
        "(default: the aot-pack directory auto-detected next to "
        "--from-snapshot); see kv-tpu-torch warmup",
    )
    p.add_argument(
        "--can-reach", nargs=2, metavar=("SRC", "DST"),
        help="pod pair as NAMESPACE/NAME NAMESPACE/NAME",
    )
    p.add_argument(
        "--port", type=int, default=None,
        help="with --can-reach: refine to a concrete port (CPU-oracle "
        "exact answer)",
    )
    p.add_argument("--protocol", default="TCP", help="with --port")
    p.add_argument(
        "--batch", metavar="FILE.jsonl",
        help="answer a whole probe batch through one device dispatch: one "
        'JSON object per line, {"src": "NS/POD", "dst": "NS/POD"} with '
        'optional "port" (integer; omitted = any port) and "protocol" '
        "(default TCP)",
    )
    p.add_argument("--who-can-reach", metavar="DST")
    p.add_argument("--blast-radius", metavar="SRC")
    p.add_argument(
        "--path-exists", nargs=2, metavar=("SRC", "DST"),
        help="is there a multi-hop path SRC -> ... -> DST? Rides the "
        "bounded multi-source closure — per level one [1, N] frontier, "
        "never an N x N closure, so it answers at matrix-free scale",
    )
    p.add_argument(
        "--hops", nargs=2, metavar=("SRC", "DST"),
        help="shortest allowed-path hop count SRC -> DST (1 = direct "
        "edge; exit text says UNREACHABLE when there is none)",
    )
    p.add_argument(
        "--max-hops", type=int, default=None, metavar="H",
        help="with --path-exists/--hops: bound the search to paths of at "
        "most H edges (default: unbounded)",
    )
    p.add_argument(
        "--what-if", metavar="MANIFESTS",
        help="admission dry run: would adding these NetworkPolicy "
        "manifests violate the --assert file? (exit 1 if so; nothing "
        "is committed)",
    )
    p.add_argument(
        "--assert", dest="assert_file", metavar="FILE",
        help="assertion file checked against the current state (or the "
        "what-if overlay)",
    )
    p.add_argument("--no-self-traffic", dest="self_traffic", action="store_false")
    p.add_argument("--no-default-allow", dest="default_allow", action="store_false")
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser(
        "lb",
        help="spread --batch probe files across follower replicas by "
        "staleness-weighted routing: stale reads retry on the leader, "
        "unreachable replicas are breaker-ejected",
    )
    p.add_argument(
        "--replica", action="append", default=[], metavar="DIR[=URL]",
        help="a follower's checkpoint directory (repeatable); DIR=URL "
        "bootstraps a networked follower over HTTP from the replication "
        "server at URL into DIR",
    )
    p.add_argument(
        "--leader", metavar="DIR",
        help="the leader's checkpoint directory — stale-read retry and "
        "last-resort fallback (without it, an over-bound replica's "
        "StaleReadError propagates and a fully-ejected fleet exits 4)",
    )
    p.add_argument(
        "--batch", action="append", default=[], required=True,
        metavar="FILE.jsonl",
        help="probe batch to route (repeatable; one batch = one routing "
        "decision); same JSONL schema as kv-tpu-torch query --batch",
    )
    p.add_argument(
        "--events", metavar="FILE",
        help="override the WAL the replicas tail (default: the path the "
        "checkpoint manifest records)",
    )
    p.add_argument(
        "--staleness", type=float, default=None, metavar="SECONDS",
        help="per-replica staleness bound (default: unbounded)",
    )
    p.add_argument("--seed", type=int, default=0, help="routing-draw seed")
    p.add_argument(
        "--check-denied", action="store_true",
        help="exit 1 when any probe is denied",
    )
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_lb)

    p = sub.add_parser(
        "trace",
        help="reassemble one trace id's cross-process timeline from "
        "per-replica JSON event logs: span tree, per-log attribution, "
        "query stage breakdown (queue/dispatch/solve/d2h)",
    )
    p.add_argument(
        "trace_id", nargs="?", default=None,
        help="the trace id to reassemble (16-hex, from any event line or "
        "an X-Kvtpu-Trace header); omit with --slowest",
    )
    p.add_argument(
        "--log", action="append", default=[], required=True, metavar="FILE",
        help="a JSON event log to scan (repeatable — one per "
        "process/replica; duplicated spans from shared logs render once)",
    )
    p.add_argument(
        "--slowest", action="store_true",
        help="pick the trace id from the highest-valued latency exemplar "
        "in --metrics instead of naming one",
    )
    p.add_argument(
        "--stage", metavar="STAGE",
        help="with --slowest: only consider exemplars whose stage label "
        "matches (queue/dispatch/solve/d2h/total)",
    )
    p.add_argument(
        "--metrics", action="append", default=[], metavar="URL|FILE",
        help="exemplar source for --slowest: a replica base URL (fetches "
        "/metrics?exemplars=1) or a saved metrics text file (repeatable)",
    )
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "fleet",
        help="scrape every replica's /healthz + /metrics, render the "
        "fleet table, and evaluate SLO error-budget burn rates "
        "(exit 1 past --burn-threshold)",
    )
    p.add_argument(
        "--replica", action="append", default=[], required=True,
        metavar="URL",
        help="a replication server base URL, e.g. http://127.0.0.1:8700 "
        "(repeatable)",
    )
    p.add_argument(
        "--slo", action="append", default=[], metavar="SPEC",
        help="objective spec: availability=0.999 or staleness=0.995@2.0 "
        "(repeatable; default availability=0.999)",
    )
    p.add_argument(
        "--burn-threshold", type=float, default=1.0,
        help="exit 1 when any objective x window burn rate exceeds this "
        "(1.0 = consuming error budget exactly at the sustainable rate)",
    )
    p.add_argument(
        "--timeout", type=float, default=5.0,
        help="per-replica scrape timeout (seconds)",
    )
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    p.set_defaults(fn=cmd_fleet)

    p = sub.add_parser(
        "posture",
        help="read a posture journal: reachability-drift timeline per "
        "generation, --watch tailing, --diff between two generations "
        "(exit 1 when rendered records carry alert violations)",
    )
    p.add_argument(
        "journal",
        help="posture journal file (posture.jsonl) or a directory "
        "containing one (e.g. the serve --posture-journal target)",
    )
    p.add_argument(
        "--limit", type=int, default=20, metavar="N",
        help="timeline: render the last N records (default 20)",
    )
    p.add_argument(
        "--diff", nargs=2, type=int, metavar=("GEN_A", "GEN_B"),
        help="aggregate the exact posture movement between two "
        "generations (net widened/narrowed, namespace movement, "
        "witnesses)",
    )
    p.add_argument(
        "--watch", action="store_true",
        help="tail the journal, rendering each new record as it lands",
    )
    p.add_argument(
        "--poll", type=float, default=0.5, metavar="SECONDS",
        help="with --watch: journal poll interval",
    )
    p.add_argument(
        "--idle-timeout", type=float, default=None, metavar="SECONDS",
        help="with --watch: stop after this long with no new records "
        "(default: run until interrupted)",
    )
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    p.set_defaults(fn=cmd_posture)

    p = sub.add_parser(
        "jobs",
        help="merge every replica's in-flight long-job progress table "
        "(pass counters, rates, ETAs) from /healthz into one view",
    )
    p.add_argument(
        "--replica", action="append", default=[], required=True,
        metavar="URL",
        help="a replication server base URL (repeatable)",
    )
    p.add_argument(
        "--timeout", type=float, default=5.0,
        help="per-replica scrape timeout (seconds)",
    )
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    p.set_defaults(fn=cmd_jobs)

    p = sub.add_parser(
        "profile",
        help="trigger a bounded on-demand torch.profiler capture — on a "
        "running replica (--replica, no restart) or in this process",
    )
    p.add_argument(
        "--replica", metavar="URL",
        help="capture on this replication server via /profile?seconds=N "
        "(default: capture locally)",
    )
    p.add_argument(
        "--seconds", type=float, default=2.0,
        help="capture duration (clamped to 0.01..60)",
    )
    p.add_argument(
        "--dir", metavar="DIR",
        help="local capture directory (default: $KVTPU_PROFILE_DIR or "
        "kvtpu-profiles/)",
    )
    p.add_argument(
        "--timeout", type=float, default=5.0,
        help="HTTP timeout floor for --replica (raised to cover --seconds)",
    )
    p.add_argument("--json", action="store_true")
    _add_obs_flags(p)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser(
        "top",
        help="live fleet dashboard: replica table, in-flight jobs with "
        "ETA bars, qps/lag/burn sparklines, recent flight dumps",
    )
    p.add_argument(
        "--replica", action="append", default=[], required=True,
        metavar="URL",
        help="a replication server base URL (repeatable)",
    )
    p.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh period in live mode (seconds)",
    )
    p.add_argument(
        "--once", action="store_true",
        help="render one frame to stdout (no screen clearing) and exit",
    )
    p.add_argument(
        "--frames", type=int, default=0, metavar="N",
        help="stop after N live frames (0 = run until interrupted)",
    )
    p.add_argument(
        "--slo", action="append", default=[], metavar="SPEC",
        help="objective spec for the burn sparkline (as in kv-tpu-torch fleet; "
        "default availability=0.999)",
    )
    p.add_argument(
        "--timeout", type=float, default=5.0,
        help="per-replica scrape timeout (seconds)",
    )
    _add_obs_flags(p)
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("backends", help="list available backends")
    p.set_defaults(fn=cmd_backends)

    p = sub.add_parser(
        "metrics",
        help="print the metric schema (live registry) or a saved "
        "--metrics-out dump",
    )
    p.add_argument("file", nargs="?", help="a saved --metrics-out JSON dump")
    p.add_argument(
        "--format", choices=("json", "prom"), default="json",
        help="live-registry output format",
    )
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "lint",
        help="run the flow-aware static analysis over the package "
        "(rule catalog: kubernetes_verification_tpu_torch/LINTS.md; "
        "budgets: kubernetes_verification_tpu_torch/LINT_BASELINE.json)",
    )
    from .analysis import add_lint_arguments

    add_lint_arguments(p)
    p.set_defaults(fn=cmd_lint)

    args = ap.parse_args(argv)
    with _own_process_group():
        return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
