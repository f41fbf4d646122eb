"""Subprocess body of the port's stripe-owner SIGKILL test
(``tests/test_torch_stripes.py``).

One stripe owner on its own simulated host: it rebuilds the test's seeded
cluster on the CPU, applies the same seeded event stream to its
``StripeFollower`` and serves ``POST /v1/stripe`` and ``/healthz`` over HTTP
(``StripeFollower.serve_http``). The parent kills it with SIGKILL. The URL
is published to ``--url-file`` through tmp + ``os.replace``; the child then
idles until ``--ack-file`` appears or its own deadline passes. It imports
only the port (no JAX).
"""
import argparse
import os
import sys
import time

#: MUST mirror ``_GEN`` of tests/test_torch_stripes.py
CLUSTER = dict(n_policies=10, n_namespaces=4, seed=11, p_ipblock_peer=0.0,
               min_selector_labels=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--url-file", required=True)
    ap.add_argument("--ack-file", required=True)
    ap.add_argument("--stripe-index", type=int, required=True)
    ap.add_argument("--stripe-count", type=int, required=True)
    ap.add_argument("--pods", type=int, default=30)
    ap.add_argument("--n-events", type=int, default=24)
    ap.add_argument("--deadline", type=float, default=120.0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import torch

    torch.set_num_threads(1)
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.serve.stripes import StripeFollower

    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=args.pods, **CLUSTER))
    events = random_event_stream(cluster, n_events=args.n_events, seed=13)
    follower = StripeFollower(
        cluster, kvt.VerifyConfig(compute_ports=False),
        stripe=(args.stripe_index, args.stripe_count), device="cpu",
        replica=f"child-{args.stripe_index + 1}-of-{args.stripe_count}",
    )
    follower.apply(events)
    server = follower.serve_http(args.workdir)
    tmp = args.url_file + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(server.url)
    os.replace(tmp, args.url_file)
    deadline = time.time() + args.deadline
    while not os.path.exists(args.ack_file):
        if time.time() > deadline:
            print("the parent never acked", file=sys.stderr)
            server.close()
            return 1
        time.sleep(0.05)
    server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
