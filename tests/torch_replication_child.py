"""Subprocess body of the port's replication kill test
(``tests/test_torch_replication.py``).

Two roles, both on the CPU and importing only the port (no JAX):

* ``leader`` (default) — the durable write path with a lease: acquires
  ``leader.lease`` at epoch 1, then appends epoch-stamped WAL batches,
  applies them, renews the lease every batch and checkpoints periodically;
  ``--kill`` arms one kill-point, which hard-kills the process with
  ``os._exit(137)`` mid-write.
* ``follower --promote`` — bootstraps a ``FollowerService`` from the
  leader's checkpoints and promotes as soon as the breaker gate allows.
  Its wall clock runs ``--clock-skew`` seconds ahead, so the leader's lease
  has expired without waiting for it. ``after-promote-epoch`` kills it
  after the lease epoch is bumped and before anything is written at it.

The child never solves reach. Its whole run is bounded by ``--deadline``.
"""
import argparse
import os
import sys
import time

#: MUST mirror ``_GEN`` of tests/test_torch_replication.py (32 pods)
CLUSTER = dict(n_policies=10, n_namespaces=3, seed=7, p_ipblock_peer=0.0,
               min_selector_labels=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--kill", default="",
                    help="fault spec armed via install_kill_points, e.g. "
                    "'after-promote-epoch@0' (empty = run to completion)")
    ap.add_argument("--role", choices=("leader", "follower"), default="leader")
    ap.add_argument("--promote", action="store_true")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--n-events", type=int, default=60)
    ap.add_argument("--pods", type=int, default=32)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--checkpoint-every", type=int, default=2)
    ap.add_argument("--lease-ttl", type=float, default=5.0)
    ap.add_argument("--clock-skew", type=float, default=0.0)
    ap.add_argument("--deadline", type=float, default=60.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import torch

    torch.set_num_threads(1)
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.resilience.faults import (
        install_kill_points,
        parse_fault_spec,
    )
    from kubernetes_verification_tpu_torch.serve import (
        CheckpointManager,
        EventSource,
        FollowerService,
        LeaseFile,
        VerificationService,
        WalWriter,
    )

    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=args.pods, **CLUSTER))
    cfg = kvt.VerifyConfig(compute_ports=False)
    log = os.path.join(args.workdir, "events.jsonl")
    ck = os.path.join(args.workdir, "ck")

    if args.role == "follower":
        if args.kill:
            install_kill_points(parse_fault_spec(args.kill), seed=args.seed)
        clock = lambda: time.time() + args.clock_skew  # noqa: E731
        f = FollowerService(
            ck, log_path=log, replica="child-follower", initial_cluster=cluster,
            config=cfg, device="cpu", lease_ttl=args.lease_ttl,
            breaker_threshold=3, clock=clock,
        )
        if args.promote:
            deadline = time.time() + args.deadline
            while time.time() < deadline:
                f.poll()
                f.heartbeat()
                if f.maybe_promote():
                    print(f"promoted epoch={f.epoch}")
                    return 0
                time.sleep(0.01)
            print("never promoted", file=sys.stderr)
            return 1
        return 0

    events = random_event_stream(cluster, n_events=args.n_events, seed=args.seed)
    if args.kill:
        install_kill_points(parse_fault_spec(args.kill), seed=args.seed)
    svc = VerificationService(cluster, cfg, device="cpu")
    cm = CheckpointManager(ck, retain=3)
    os.makedirs(ck, exist_ok=True)
    lease = LeaseFile(ck)
    lease.acquire("leader-0", ttl=args.lease_ttl)  # epoch 1
    writer = WalWriter(log, epoch=1, lease=lease)
    source = EventSource(log)
    since = 0
    for i in range(0, len(events), args.batch):
        lease.renew("leader-0", 1, args.lease_ttl)
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
