"""Subprocess body of the port's kill-point recovery test
(``tests/test_torch_durability.py``).

Runs the port's durable serving write path on the CPU — WAL appends,
service applies, periodic atomic checkpoints — over the port's
deterministic churn stream, with one armed kill-point from ``--kill``. The
armed point hard-kills the process with ``os._exit(137)`` mid-write; the
parent recovers from whatever survived on disk and compares bit for bit
against a from-scratch CPU-oracle solve of the surviving log prefix. The
child imports only the port (no JAX) and never solves reach.
"""
import argparse
import os
import sys

#: the cluster of the child and of the parent's oracle (both must agree)
CLUSTER = dict(n_policies=24, n_namespaces=6, seed=7, p_ipblock_peer=0.0,
               min_selector_labels=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--kill", default="",
                    help="fault spec armed via install_kill_points, e.g. "
                    "'mid-log-append@37' (empty = run to completion)")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--n-events", type=int, default=120)
    ap.add_argument("--pods", type=int, default=32)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--kind", choices=("dense", "packed"), default="dense")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.resilience.faults import (
        install_kill_points,
        parse_fault_spec,
    )
    from kubernetes_verification_tpu_torch.serve import (
        CheckpointManager,
        EventSource,
        VerificationService,
        WalWriter,
    )

    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=args.pods, **CLUSTER))
    events = random_event_stream(cluster, n_events=args.n_events, seed=args.seed)
    if args.kill:
        install_kill_points(parse_fault_spec(args.kill), seed=args.seed)
    cfg = kvt.VerifyConfig(compute_ports=False)
    if args.kind == "packed":
        svc = VerificationService(engine=kvt.PackedIncrementalVerifier(
            cluster, cfg, device="cpu", keep_matrix=True))
    else:
        svc = VerificationService(cluster, cfg, device="cpu")
    log = os.path.join(args.workdir, "events.jsonl")
    cm = CheckpointManager(os.path.join(args.workdir, "ck"), retain=3)
    writer = WalWriter(log)
    source = EventSource(log)
    since = 0
    for i in range(0, len(events), args.batch):
        writer.append(events[i:i + args.batch])
        for batch in source.batches(args.batch):
            svc.apply(batch)
        since += 1
        if since >= args.checkpoint_every:
            cm.checkpoint(svc.engine, log_path=log, log_offset=source.offset,
                          last_seq=source.last_seq)
            since = 0
    cm.checkpoint(svc.engine, log_path=log, log_offset=source.offset,
                  last_seq=source.last_seq)
    writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
