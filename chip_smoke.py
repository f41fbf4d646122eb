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
   kernel paths against the dense solve on that cluster;
9. flagship policy-pair masks: ``policy_pair_masks`` on phase 4's any-port
   encoding (P = 10,000, N = 100,000), then its set build and its two int8
   Grams timed apart beside their bound; 64 sampled policies' src/dst set
   rows recomputed on the host from the cluster's model objects (label
   columns, not the port's encoder or matcher), and their mask rows in
   float64 from the fetched sets;
10. flagship packed closure: ``PackedReach.closure()`` of phase 4's words
    (``fetch=False``), each pass's time (CUDA events), pairs and bound; the
    closure contains the reach, one more squaring leaves it unchanged,
    ``bounded_packed_closure`` (BFS, an independent algorithm) from 1,024
    random seeds gives the same rows, and ``hops=2`` there and ``path_upto``
    at 2 give the first pass's rows; the hop histogram of 64 seeds;
11. ``packed_closure_delta`` at N = 8,192 (a cut for time) through its
    suspect route (bits removed) and its additions-only route (bits added,
    ``prev_base`` given): each equals ``packed_closure(new_base)``;
12. kano mode at BASELINE config 3's scale: ``random_kano(10,000
    containers, 1,000 policies, seed 0)`` through ``verify_kano(closure=
    True)`` with the default and a prefix ``LabelRelation``, and the same
    10,000 containers under 20 policies (a closure that is not all pairs);
    the src/dst sets and every ``Container``'s lists against the host's
    evaluation of the model objects, 256 sampled (20 policies: all) reach
    rows in float64 and closure rows through the host's policy-graph
    closure, and the dense closure against ``packed_closure`` of the
    packed reach;
13. the card against the CPU at phase 8's size: ``verify(closure=True)``,
    ``PackedReach.closure()`` of both tiled kernel paths against the dense
    closure, ``policy_pair_masks`` against the dense queries, and
    ``verify_kano`` (2,000 containers / 200 policies) on every field.

14. the serving engine at full width: ``PackedIncrementalVerifier`` built
    on phase 4's cluster (its build split printed; the counts set to 0 just
    before it: ``packed_dir_allow`` exactly twice, ``fused_ports_reach``
    never; its words equal phase 4's bit for bit), then a diff stream of
    policy adds, updates and removes, pod relabels (in and out of the
    vocabulary), pod removes and adds (tombstones reused), a new namespace
    and its relabel, with per-kind latencies; the live rows × live columns
    against a one-shot ``tiled_k8s_reach`` of ``as_cluster()``;
    ``solve_rows``, ``solve_stripe`` and ``packed_any_port`` against the
    words; ``state_dict`` → ``from_state`` round trips, and a matrix-free
    resume whose ``sweep_dirty`` equals the kept engine after 8 more diffs;
15. the engine on the card against the engine on the CPU at phase 8's
    size: ``state_dict`` equal after the build and after every op of a
    policy, pod, label and namespace stream that grows the pod axis;
    ``closure_packed`` equal to ``packed_closure`` of the words;
16. the port-bitmap serving engine at full width:
    ``PackedPortsIncrementalVerifier`` built on phase 6's cluster (the
    counts set to 0 just before it: ``fused_ports_reach`` exactly once,
    ``packed_dir_allow`` never; its build split and the layout's R, VP rows
    and K' printed; its words equal phase 6's bit for bit), 512 sampled
    rows and 256 sampled columns through the engine's ``_ports_reach_block``
    against those words, then a diff stream of policy adds, updates and
    removes, a policy outside the frozen port universe (refused, words
    unchanged), pod relabels, removes and adds, a new namespace and its
    relabel, with per-kind latencies and the host share of a pod op; the
    live rows × live columns against a one-shot port-bitmap
    ``tiled_k8s_reach`` of ``as_cluster()``; a ``state_dict`` →
    ``from_state`` round trip, and one more diff on both engines;
17. the ports engine on the card against the ports engine on the CPU at
    phase 8's size: ``state_dict`` equal after the build and after every op
    of a stream that grows the pod axis;
18. the dense engine (``IncrementalVerifier``) at the JAX bench's dense
    ceiling, ``random_cluster(32,768 pods, 3,277 policies, 20 namespaces,
    seed 0)``: its build split printed, no hand-written kernel launched
    (its contraction is one ``bool_dot`` per direction, re-run from the
    engine's vectors and timed beside its bound), ``reach`` == the unpacked
    words of ``tiled_k8s_reach`` (2 ``packed_dir_allow`` launches); a stream
    of 8 policy adds, updates and removes, 8 pod relabels, a namespace
    relabel, a namespace added and removed, and one refused op of each kind
    (the state unchanged); ``reach`` == a one-shot solve of
    ``as_cluster()``; ``dense_query_state``'s words == a host pack;
    ``batched_reach_rows/cols/any_port`` (1,024 sources, 1,024
    destinations, 4,096 probes) == ``reach``, and the stripe twins over 8
    stripes of 4,096 rows, concatenated, == the batched ones;
19. the dense engine on the card against the dense engine on the CPU at
    phase 8's size: counts and isolation counts byte-equal after the build
    and after every op, refused ops included;
20. (run right after phase 14, on its engine) the posture ops at the
    flagship: the words before and after one policy op and one pod relabel
    diffed by ``packed_xor_popcount`` == the host's planes, the row counts,
    ``ns_pair_counts`` and ``topk_changed_rows(k=8)`` == the host's exact
    counts, ``packed_row_popcount`` == the host on 1,024 sampled rows; each
    op's time beside its byte bound;
21. the CPU oracle (``verify(backend="cpu")``, host NumPy) against
    ``verify(backend="torch")`` on the card at phase 8's size (any-port)
    and at 500 pods with port semantics, and the paper fixtures'
    documented answers on both backends;
22. (run right after phase 20) the serving plane at the flagship: a
    ``VerificationService`` on ``PackedIncrementalVerifier(keep_matrix=
    True)`` built on phase 4's cluster (counts set to 0 first:
    ``packed_dir_allow`` exactly twice, its words == phase 4's), posture on,
    4 allow/deny assertions; ``random_event_stream(n_events=256, seed=1)``
    less the relabels of namespaces that hold pods (each costs ~265 s of
    host evaluation at this size), written ahead to a ``WalWriter`` log and
    fed in batches of 64 through ``start()`` / ``submit()`` / ``flush()``,
    each under ``torch.profiler`` for the device busy time. After the first
    and the last batch (a cut for time; the batches between are applied
    and timed unchecked): the posture record == the host's diff of the
    words before and after; ``can_reach_batch`` on 4,096 probes of ``bench.py --mode
    query``'s mix, its any-port answers == the words unpacked on the host,
    its first 64 == scalar ``can_reach``; ``who_can_reach`` /
    ``blast_radius`` of 16 pods == a column / row of the words. After the
    stream: the live words == a one-shot ``tiled_k8s_reach`` of
    ``as_cluster()``; a ``CheckpointManager.checkpoint``, 64 more events,
    and ``RecoveryManager.recover`` == the live words (no duplicates).
    ``svc.reach()`` is never asked for (a 10 GB host matrix here);
23. the dense ``VerificationService`` at phase 18's size: no hand-written
    launch in its build; 128 events (the same cut) in batches of 64 through
    the worker; after each, ``reach`` == a one-shot solve of
    ``as_cluster()``, the assertions' verdicts (the batched row gather) ==
    the host's on that solve, 4,096 probes == it; ``what_if`` with an add,
    an update, a remove and a deny-all: its diff == a one-shot solve of the
    cluster with the candidates applied, the assertion it breaks reported,
    the engine's count matrices byte-equal before and after;
24. the dense and packed services on the card against the same two on the
    CPU at phase 8's size (posture and assertions on), over
    ``random_event_stream(n_events=500, p_resync=0.01, seed=24)`` (every
    event kind): after each batch of 50, ``reach``, the packed words,
    ``can_reach_batch`` (512 probes), the posture records, the violations
    and ``ServeStats`` equal; then three ``BackendError``s forced into the
    card's dense engine where a posture service's ``reach`` does its device
    work (its engine adopts the words each publish packs and unpacks them
    on demand): each reaches the caller (a service on the card
    never answers from the host), the breaker opens and fails fast with
    kind ``"breaker_open"`` without running the engine, and past the
    cooldown one probe on the card closes it with ``reach`` == the CPU
    engine's. In phases 22–24 ``kvtpu_fallbacks_total`` reads 0, no
    ``"fallback"`` solve is counted and, outside the forced errors, the
    breaker stays closed;
25. (run right after phase 22, on its kept checkpoint directory, WAL and
    live service as the leader) replication at the flagship: a
    ``LeaseFile`` on the leader, a ``FollowerService`` on the card
    bootstrapped through the recovery ladder (the 64 post-checkpoint
    events replayed), 32 more events the leader writes under its lease
    tailed; the follower's words and ``pod_active`` == the leader's at the
    same ``last_seq``, caught up, and a 4,096-probe batch of phase 22's mix
    == the leader's answers. The lease expires through an injected clock:
    the follower promotes to epoch 2 after two failed heartbeats, the
    deposed leader's ``WalWriter.append`` raises ``FencedError``, and one
    event written by the new leader is applied (words == the old leader's
    after it);
26. (run right after phase 23, on its service and stream) the stripe fleet
    at phase 18's size, K = 4 on the card: the stream written to a WAL and
    tailed by four ``StripeFollower``s, each owner's ``state_bytes()`` <=
    the dense service's counts / K + 64 N; ``can_reach_batch`` (4,096
    any-port probes of the mix), ``who_can_reach_batch`` and
    ``blast_radius_batch`` of 64 pods and ``hops`` (at most 2) of 8 pairs
    through a ``StripeCoordinator`` == phase 23's dense service; every event
    applied on every owner (fan-out counted); stripe 2 round-tripped through
    ``checkpoint_stripe`` / ``recover_stripe`` (counts byte-equal); build
    per stripe, apply per batch, the full-scatter ``who_can_reach`` p50 and
    p99 and 4-thread queries/s printed;
27. (run last) the card against the CPU at phase 8's size: a packed leader
    service on the card (2 ``packed_dir_allow`` launches) behind a
    ``ReplicationServer`` on ``127.0.0.1:0``; followers on the card and on
    the CPU bootstrap through ``bootstrap_from_leader`` and tail through
    ``RemoteEventSource``: words and 512 answers == the leader's after each
    batch; K = 3 stripes (667/667/666 rows) on the card == on the CPU; a
    ``QueryLoadBalancer`` over both followers behind their own servers and
    ingress, the CPU one's server stopped: every answer == the leader's and
    its breaker opens; an ``Ingress`` past its quota sheds with a typed
    ``AdmissionRejectedError``; ``resilient_verify`` on the card == the CPU
    oracle, a forced device loss with chain ``("faulty:torch",)`` reaches
    the caller as ``BackendChainExhausted``, the chain ``("torch", "cpu")``
    is refused with ``ConfigError``, and ``kvtpu_fallbacks_total`` reads 0.
28. (run right after phase 10, while phases 4, 6, 9 and 10's results are
    alive) the mesh-sharded paths at world size 1 over NCCL, in this
    process (``mesh_for()``): ``verify(backend="sharded-packed")`` on the
    flagship cluster any-port (dst tile 1,024) and with port bitmaps (512):
    its words == phase 4's and phase 6's over the real columns, its out-
    and in-degrees and pair count == theirs, bit for bit;
    ``sharded_packed_closure`` of phase 4's words (tiles 20,000) == phase
    10's closure;
    ``policy_pair_masks_sharded`` == phase 9's masks; the dense ``sharded``
    backend at phase 18's 32,768 pods / 3,277 policies == ``verify(backend=
    "torch")`` on every field (any-port: ``reach_ports`` with port atoms
    would be 40 GB there);
29. four ranks on the one card over gloo with CUDA tensors (NCCL refuses
    two ranks on one GPU), spawned by the script: on the meshes (4, 1),
    (2, 2) and (1, 4), the dense and packed backends (any-port and with
    port bitmaps), the sharded kano reach, ``sharded_packed_closure`` and
    ``policy_pair_masks_sharded`` on ``random_cluster(8,192 pods, 820
    policies)`` and ``random_kano(2,000, 200)`` == the world-1 result of
    the same code, computed first in this process on the card; each rank's
    times and peak memory are printed (gloo takes the CUDA tensors in
    every collective: none is staged through the host). A rank that fails
    or disagrees fails the script, and none outlives the phase.
30. (right after phase 29, on phase 28's world-1 NCCL group) both serving
    engines with ``mesh=`` on the ``(1, 1)`` mesh at the flagship, uncut:
    ``PackedIncrementalVerifier(keep_matrix=True)`` and
    ``PackedPortsIncrementalVerifier`` built beside their one-device
    engines, a scripted stream with one op of each kind (policy add /
    update / remove, pod relabels, removes and adds, a new namespace, its
    relabel and removal) applied to both, the words equal after every op;
    the any-port engine built again matrix-free, the same stream,
    ``sweep_dirty`` and ``solve_stripe(0, Np)`` == the one-device words;
    each mesh engine checkpointed and resumed on one device, its state ==
    the mesh engine's, bit for bit. Build seconds split, each op's latency
    (host clock after a sync), the stripe seconds and peak memory printed;
31. four gloo ranks on the one card (as phase 29) at phase 29's 8,192 pods
    / 820 policies, meshes (4, 1), (2, 2) and (1, 4): both engines'
    gathered state after the build and every op of the stream == the
    world-1 engines' (computed first in this process), and the (2, 2)
    checkpoints resumed at (4, 1);
32. ``verify(backend="datalog")`` on the card (``torch.einsum`` rules,
    fp32) at BASELINE config 3 (``random_cluster(10,000, 1,000, 20
    namespaces, seed 0)``, any-port) == ``verify(backend="torch")`` on
    every field, and the kano program at ``random_kano(10,000, 1,000)`` ==
    ``verify_kano(backend="torch")``, with their ``timings``.
33.–35. the ``native`` backend, the observe tooling and the warm start
    (``native_phase``, ``observe_phase``, ``warm_start_phase``).
36. (run last) the command line at full width on the card, through
    ``kubernetes_verification_tpu_torch.cli.main`` on phase 4's cluster
    written as JSON manifests: ``snapshot`` (one ``fused_ports_reach``
    launch) and ``snapshot --no-ports`` (two ``packed_dir_allow``) print
    phases 6 and 4's aggregates and checkpoint their words (sha256);
    ``diff`` (a policy added, a pod removed) launches no kernel and its
    pairs equal ``verify --backend sharded-packed`` of the changed
    manifests; ``serve`` of phase 22's first 32 events builds the packed
    service (two launches) and its snapshot answers ``query --batch`` of
    4,096 probes as its words do; ``warmup`` packs both libraries; in a
    child process without ``--device``, ``verify`` at phase 8's size equals
    the in-process ``--device cpu`` answer with ``"backend": "torch"`` and
    ``backends`` prints ``available_backends()``. Each step prints its
    seconds and peak device memory.
37. the static analysis on the card's host: ``python -m
    kubernetes_verification_tpu_torch.analysis --format json --no-cache``
    (every rule over the port's package, against its own
    ``LINT_BASELINE.json``) and ``--check-docs
    kubernetes_verification_tpu_torch/LINTS.md`` in child processes; both
    must exit 0. Prints the finding, grandfathered and suppressed counts and
    each child's wall time (a host time on that machine; the lint runs no
    device code and launches neither kernel: the counts are set to 0 before
    it and must read 0 after).
38. the port's benchmark entry point: ``python -m
    kubernetes_verification_tpu_torch.bench`` in child processes on the
    card, without ``--device`` (``BENCH_STAGES``: its first stage starts
    before phase 36 and runs beside phases 36–37, three lanes at once;
    then ``posture`` alone), with ``KVTPU_BENCH_HISTORY`` in a temporary
    directory: ``sentinel``; ``tiled`` at the flagship,
    any-port and with port bitmaps (their reachable pairs == phases 4 and
    6's, their solves on ``packed_dir_allow`` / ``fused_ports_reach``);
    ``headtohead`` with port bitmaps (``--repeats 3``); ``incremental`` and
    ``closure`` at the flagship; ``k8s``, ``kano``, ``stripe``,
    ``stripes``, ``serve``, ``query``, ``replicate`` and ``posture`` at
    the JAX bench's default sizes with ``--repeats 2`` (``serve``,
    ``replicate``, ``stripes`` and ``posture`` cut for the time limit;
    ``ingress`` not run: its overload gate is sensitive to the host's
    speed). Every child must exit 0, every record name the card and carry
    ``sentinel``, every cold first call a ``compile_warm_s`` and a true
    ``warm_parity``, and the history must read back through
    ``observe/history.py::load_runs``. Prints each run's seconds, peak
    device memory and launches.
39. the entry points of ``kubernetes_verification_tpu_torch/
    graft_entry.py`` (the root ``__graft_entry__.py``'s counterpart):
    ``entry()`` on the card == ``entry(device="cpu")`` in every argument and
    every ``K8sOut`` field; ``python -m kubernetes_verification_tpu_torch.
    graft_entry 4`` in a child process started with phase 38's first stage
    (beside phases 36–37; waited for after phase 37, before phase 38's
    rest): ``dryrun_multichip(4)``, four gloo ranks on the one card on a
    2×2 mesh, the reference's eleven stages at its sizes (the sharded
    verify, the packed solves, the 1M-pod stripe, the mesh engines, the
    250,000-pod matrix-free engine, its bounded path query and its
    follower), each held against the ``cpu`` oracle or the one-device path
    by the ranks themselves. All eleven OK lines must be printed and the
    child exit 0; each stage's seconds and each rank's peak device memory
    are printed.

Phases 9–13 launch neither hand-written kernel (their int8 products are
``torch._int_mm`` calls, as the JAX package leaves them to XLA): the counts
are set to 0 before each and must read 0 after; phases 14–15 launch
``packed_dir_allow`` only in their engine builds, phases 16–17
``fused_ports_reach`` only in theirs (the diff steps' products are
``torch._int_mm`` calls, as the JAX engines' are XLA dots). Phases 18–21
launch neither in the dense engine, the posture ops or the oracle (no TPU
kernel is on their path); phase 18's two one-shot checks launch
``packed_dir_allow`` twice each. Phase 22 launches ``packed_dir_allow`` in
its service's build (exactly twice) and its one-shot check; phases 23–24
launch ``fused_ports_reach`` never (the dense service's contraction is a
``bool_dot``). Phases 25–27 launch ``packed_dir_allow`` in phase 27's
leader build (exactly twice; a follower bootstrapped from a checkpoint
launches none, a stripe's contraction is a ``bool_dot``) and
``fused_ports_reach`` never. Phases 28–29 launch neither (the sharded
paths' products are ``bool_dot`` calls, as the JAX package's are XLA dots
in ``shard_map`` bodies): the counts are set to 0 before each of their
steps and must read 0 after, the ranks' included. Phases 30–32 launch
neither in their mesh engines' and datalog's calls (the mesh engines'
products are ``bool_dot`` calls, as the JAX engines' are XLA dots under
GSPMD; the datalog rules are ``torch.einsum``); phase 30's one-device
engine builds beside them launch the kernels and are not counted. Each
phase prints its seconds and its peak device memory.

The second-to-last line is the kernel table as JSON (each kernel's row
carries its engine build's launches, phase 14's and phase 16's, as
``engine_build_launches``, and ``packed_dir_allow``'s its launches in phase
18's checks as ``dense_check_launches`` and in phase 22's service build as
``serve_build_launches``, and its launches in phases 25–27, counted from
0 at their start, as ``replica_launches``, and each kernel's launches in
phases 28–29, the ranks' included, as ``sharded_launches``, in
phases 30–32 as ``mesh_engine_launches``, in phase 35's child as
``warm_start_launches``, in phase 36's in-process steps as
``cli_launches``, in phase 37 as ``lint_launches``, in phase 38's
children, summed, as ``bench_launches`` and in phase 39 (``entry()`` and
the dryrun's ranks, which launch neither: the mesh paths' products are
``bool_dot`` calls, the forward step the dense torch path) as
``graft_launches``); the last is
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

from kubernetes_verification_tpu_torch.observe.introspect import (
    H100_SXM,
    device_bytes_per_s,
    device_peak_macs_per_s,
)

#: the published dense int8 tensor-core peak and memory rate of one H100 SXM
#: (NVIDIA's data sheet; at the full 700 W power limit), from the port's one
#: table of published peaks (``observe/introspect.py``)
H100_INT8_OPS = 2 * device_peak_macs_per_s(H100_SXM, "int8")
H100_BYTES_PER_S = device_bytes_per_s(H100_SXM)

MAIN = dict(n_pods=100_000, n_policies=10_000, n_namespaces=20,
            p_ipblock_peer=0.0, min_selector_labels=1, seed=0)
VERIFY = dict(n_pods=2_000, n_policies=200, n_namespaces=10, seed=1)
#: BASELINE config 3's scale: 10k pods / 1k policies
KANO = dict(n_containers=10_000, n_policies=1_000, seed=0)
#: the same containers' scale under 20 policies: a closure with structure
#: (its pairs are not every row with an edge times every column with one)
KANO_SPARSE = dict(n_containers=10_000, n_policies=20, seed=0)
DELTA_N = 8_192
#: the dense engine at the JAX bench's dense ceiling (``bench.py``'s
#: ``_DENSE_QUERY_LIMIT``, 32,768 pods) with the flagship's 10 pods per
#: policy; its count matrices are 2 x 4.29 GB
DENSE = dict(n_pods=32_768, n_policies=3_277, n_namespaces=20,
             p_ipblock_peer=0.0, min_selector_labels=1, seed=0)
DENSE_STRIPES = 8
#: the CPU oracle with port semantics, cut from phase 8's size for the
#: host's time (its [N, N, Q] allow tensors are built per rule)
ORACLE_PORTS = dict(n_pods=500, n_policies=50, n_namespaces=10, seed=1)


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


def build() -> float:
    """Build both kernels at once and print, per kernel instantiation, what
    ``ptxas`` reports (registers, spills, static shared memory) and the
    dynamic shared memory each launch asks for. Returns the build's
    seconds."""
    from kubernetes_verification_tpu_torch.ops.cuda_build import build_all, load_library

    t0 = time.perf_counter()
    built = build_all(verbose=True)
    for name, (secs, out) in built.items():
        log(f"build {name}: {secs:.1f} s")
        for line in out.splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "smem", "spill")):
                log(f"  ptxas: {line.strip()}")
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.1f} s ({len(built)} built)")
    smem = load_library("packed_dir_allow").packed_dir_allow_smem_bytes()
    log(f"  packed_dir_allow: {smem} bytes of dynamic shared memory per block")
    for w in (1, 2):
        smem = load_library("fused_ports_reach").fused_ports_reach_smem_bytes(w)
        log(f"  fused_ports_reach W={w}: {smem} bytes of dynamic shared memory per block")
    return build_s


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


def main_path(enc, dev) -> tuple:
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
    return launches, res


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


def ports_path(enc, dev) -> tuple:
    """The port-bitmap path at full width: one launch of fused_ports_reach,
    and the same words as the torch mask-group sweep. Returns the launches
    and the words over the real pods, on the host (phase 16 holds the ports
    engine's build against them), and their ``words_reference`` (phase
    36's)."""
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
    ref = words_reference(res.packed, enc.n_pods, res.timings["reachable_pairs"],
                          res.ingress_isolated, res.egress_isolated)
    return fused, res.packed[:, :w].cpu(), ref


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


class Phase:
    """One of phases 9–13: both launch counts set to 0 on entry and required
    to read 0 on exit (no hand-written kernel is on these paths), the peak
    device memory reset on entry; seconds and peak printed on exit."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, kind, *_):
        if kind is not None:
            return False
        torch.cuda.synchronize()
        launches = launch_counts()
        log(f"{self.name}: {time.perf_counter() - self.t0:.2f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
            f"packed_dir_allow {launches[0]}, fused_ports_reach {launches[1]}")
        if launches != (0, 0):
            fail(f"{self.name} launched a hand-written kernel: {launches}")
        return False


class LabelColumns:
    """The labels of many objects as numpy columns, to evaluate the model's
    selectors on the host without the port's encoder, vocabulary or
    matcher: for each key, whether each object carries it and its value
    (``""`` where it does not)."""

    def __init__(self, label_dicts):
        import numpy as np

        self.n = len(label_dicts)
        keys = sorted({k for d in label_dicts for k in d})
        self.has = {k: np.array([k in d for d in label_dicts], dtype=bool) for k in keys}
        self.val = {k: np.array([d.get(k, "") for d in label_dicts]) for k in keys}

    def column(self, key: str):
        """``(has, val)`` of ``key``; a key no object carries is absent
        everywhere."""
        import numpy as np

        if key not in self.has:
            return np.zeros(self.n, dtype=bool), np.full(self.n, "")
        return self.has[key], self.val[key]

    def match(self, sel):
        """bool [n]: which objects a ``Selector`` matches, as
        ``Selector.matches`` defines it (an object without the key
        satisfies ``NotIn`` and ``DoesNotExist``)."""
        import numpy as np

        ok = np.ones(self.n, dtype=bool)
        for k, v in sel.match_labels.items():
            has, val = self.column(k)
            ok &= has & (val == v)
        for e in sel.match_expressions:
            has, val = self.column(e.key)
            if e.op == "Exists":
                ok &= has
            elif e.op == "DoesNotExist":
                ok &= ~has
            elif e.op == "In":
                ok &= has & np.isin(val, list(e.values))
            else:  # NotIn
                ok &= ~(has & np.isin(val, list(e.values)))
        return ok


def host_policy_sets(cluster, rows):
    """The src/dst edge-set rows ``rows`` of ``policy_pair_masks``' sets
    (direction-aware isolation), bool [len(rows), N], from the cluster's
    model objects: the definition the CPU oracle of the JAX package uses
    (a policy that affects ingress and has ingress rules adds its rules'
    peers to src and its selected pods to dst; egress mirrors), evaluated
    on label columns."""
    import numpy as np

    pods = LabelColumns([p.labels for p in cluster.pods])
    ns_index = cluster.namespace_index()
    nss = LabelColumns([ns.labels for ns in cluster.namespaces])
    pod_ns_name = np.array([p.namespace for p in cluster.pods])
    pod_ns = np.array([ns_index[p.namespace] for p in cluster.pods])
    n = len(cluster.pods)

    def peer_set(peer, pol):
        if peer.ip_block is not None:
            return np.array([peer.ip_block.matches_ip(p.ip) for p in cluster.pods])
        if peer.namespace_selector is None:
            ns_ok = pod_ns_name == pol.namespace
        else:
            ns_ok = nss.match(peer.namespace_selector)[pod_ns]
        if peer.pod_selector is None:
            return ns_ok
        return ns_ok & pods.match(peer.pod_selector)

    def rule_set(rule, pol):
        if rule.matches_all_peers:
            return np.ones(n, dtype=bool)
        out = np.zeros(n, dtype=bool)
        for peer in rule.peers:
            out |= peer_set(peer, pol)
        return out

    src = np.zeros((len(rows), n), dtype=bool)
    dst = np.zeros((len(rows), n), dtype=bool)
    for r, pi in enumerate(rows):
        pol = cluster.policies[pi]
        selected = (pod_ns_name == pol.namespace) & pods.match(pol.pod_selector)
        if pol.affects_ingress and pol.ingress:
            for rule in pol.ingress:
                src[r] |= rule_set(rule, pol)
            dst[r] |= selected
        if pol.affects_egress and pol.egress:
            for rule in pol.egress:
                dst[r] |= rule_set(rule, pol)
            src[r] |= selected
    return src, dst


def host_kano_sets(containers, policies, relation=None):
    """bool [P, n] src and dst sets of kano mode from the model objects, as
    the JAX package's CPU oracle defines them: a rule key no container
    carries is dropped; otherwise a container must carry the key with a
    value the relation accepts (string equality by default)."""
    import numpy as np

    cols = LabelColumns([c.labels for c in containers])
    accepted = {}

    def match(rule):
        ok = np.ones(cols.n, dtype=bool)
        for k, v in rule.items():
            if k not in cols.has:
                continue
            has, val = cols.column(k)
            if relation is None:
                ok &= has & (val == v)
                continue
            if (k, v) not in accepted:
                seen = np.unique(val[has])
                accepted[k, v] = [u for u in seen.tolist() if relation.match(v, u)]
            ok &= has & np.isin(val, accepted[k, v])
        return ok

    src = np.stack([match(p.src_labels) for p in policies]) if policies else (
        np.zeros((0, cols.n), dtype=bool))
    dst = np.stack([match(p.dst_labels) for p in policies]) if policies else (
        np.zeros((0, cols.n), dtype=bool))
    return src, dst


def host_kano_closure_rows(src, dst, rows):
    """bool [len(rows), n]: rows of the transitive closure of the kano reach
    ``∨_p src[p]ᵀ dst[p]``, through the policy graph instead of the n × n
    matrix. A path ``i → … → j`` is a chain of policies ``p₁ … p_k`` with
    ``i ∈ src(p₁)``, ``dst(p_t) ∩ src(p_{t+1}) ≠ ∅`` and ``j ∈ dst(p_k)``,
    so with ``M`` the reflexive-transitive closure of that [P, P] graph,
    ``closure[i] = ∨_{p ∋ i, M[p, q]} dst[q]``. float64 counts are exact
    (each at most max(P, n) < 2⁵³)."""
    import numpy as np

    P = src.shape[0]
    s, d = src.astype(np.float64), dst.astype(np.float64)
    g = (d @ s.T) > 0  # [P, P]: dst(p) meets src(q)
    m = g | np.eye(P, dtype=bool)
    while True:
        grown = m | ((m.astype(np.float64) @ m.astype(np.float64)) > 0)
        if np.array_equal(grown, m):
            break
        m = grown
    first = (s[:, rows].T @ m.astype(np.float64)) > 0  # [rows, P]
    return (first.astype(np.float64) @ d) > 0


def host_mask_rows(src8, dst8, rows):
    """The ``rows`` of ``(shadow, conflict)`` from host int8 [P, N] sets, in
    float64 (exact: every count is at most N < 2⁵³), a block of policies at
    a time so no [P, N] float64 copy is ever whole."""
    import numpy as np

    P = src8.shape[0]
    a_s = src8[rows].astype(np.float64)
    a_d = dst8[rows].astype(np.float64)
    share = np.zeros((len(rows), P))
    dd = np.zeros((len(rows), P))
    for p0 in range(0, P, 1024):
        share[:, p0:p0 + 1024] = a_s @ src8[p0:p0 + 1024].astype(np.float64).T
        dd[:, p0:p0 + 1024] = a_d @ dst8[p0:p0 + 1024].astype(np.float64).T
    dsize = dst8.sum(axis=1, dtype=np.int64).astype(np.float64)
    off = np.arange(P)[None, :] != np.asarray(rows)[:, None]
    shadow = (share > 0) & (dd == dsize[None, :]) & off
    conflict = ((share > 0) & (dd == 0) & (dsize[rows][:, None] > 0)
                & (dsize[None, :] > 0) & off)
    return shadow, conflict


def pair_masks_phase(cluster, enc, dev, smi: str) -> tuple:
    """Phase 9: the flagship policy-pair masks. ``enc`` is ``cluster``'s
    any-port encoding; the sampled set rows are recomputed from
    ``cluster``'s model objects. Returns the masks (phase 28 holds the
    sharded ones against them)."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.closure import bool_dot
    from kubernetes_verification_tpu_torch.ops.tiled import (
        _pair_mask_args,
        _pair_masks_from_sets,
        _policy_sets,
        _put,
    )

    with Phase("pairs: policy_pair_masks"):
        shadow, conflict = kvt.policy_pair_masks(enc, device=dev)
    P, N = enc.n_policies, enc.n_pods
    log(f"pairs: P={P} N={N}: {int(shadow.sum())} shadow pairs, "
        f"{int(conflict.sum())} conflict pairs")
    with Phase("pairs: breakdown"):
        t0 = time.perf_counter()
        args = _put(_pair_mask_args(enc, True, 2048, n_pad=0), dev)
        torch.cuda.synchronize()
        prologue_s = time.perf_counter() - t0
        sets = []
        set_ms = cuda_ms(lambda: sets.append(_policy_sets(args, chunk=2048)))
        src8, dst8 = sets[0]
        del args, sets
        masks = []
        mask_ms = cuda_ms(lambda: masks.append(_pair_masks_from_sets(src8, dst8)))
        gram_ms = [cuda_ms(lambda x=x: bool_dot(x, x), reps=3) for x in (src8, dst8)]
    ops = 2 * 2 * P * P * N
    nbytes = 2 * P * N + 2 * P * P
    t_ops, t_bytes = ops / H100_INT8_OPS, nbytes / H100_BYTES_PER_S
    log(f"pairs: host prologue + transfer {prologue_s * 1e3:.1f} ms, set build "
        f"{set_ms:.1f} ms, Grams + masks {mask_ms:.2f} ms (Gram src {gram_ms[0]:.2f} ms, "
        f"Gram dst {gram_ms[1]:.2f} ms: {2 * P * P * N / gram_ms[0] / 1e9:.1f} TOP/s); "
        f"bound of the two Grams {1e3 * max(t_ops, t_bytes):.2f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}: {ops:.3g} ops); {smi}")
    for got, want in zip(masks[0], (shadow, conflict)):
        if not np.array_equal(got.cpu().numpy(), want):
            fail("pairs: the breakdown's masks differ from policy_pair_masks'")
    t1 = time.perf_counter()
    rows = np.sort(np.random.default_rng(9).choice(P, 64, replace=False))
    src_h, dst_h = src8.cpu().numpy(), dst8.cpu().numpy()
    del src8, dst8, masks
    want_src, want_dst = host_policy_sets(cluster, rows)
    if not (np.array_equal(src_h[rows] > 0, want_src)
            and np.array_equal(dst_h[rows] > 0, want_dst)):
        fail("pairs: sampled src/dst set rows differ from the host's evaluation of "
             "the policies")
    log(f"pairs: 64 sampled policies' src and dst set rows == the host's evaluation "
        f"of their selectors, namespaces and peers ({int(want_src.sum())} + "
        f"{int(want_dst.sum())} pods; {time.perf_counter() - t1:.1f} s on the host)")
    t1 = time.perf_counter()
    want_s, want_c = host_mask_rows(src_h, dst_h, rows)
    if not (np.array_equal(shadow[rows], want_s) and np.array_equal(conflict[rows], want_c)):
        fail("pairs: sampled mask rows differ from the host's float64 recomputation")
    log(f"pairs: 64 sampled policies' shadow and conflict rows == host float64 "
        f"recomputation ({int(want_s.sum())} + {int(want_c.sum())} pairs in those "
        f"rows; {time.perf_counter() - t1:.1f} s on the host)")
    return shadow, conflict


def closure_phase(reach, smi: str) -> torch.Tensor:
    """Phase 10: the flagship packed closure and the path queries. Returns
    the closure's words (phase 28 holds the sharded closure against them)."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.closure import (
        _fit_tile,
        _packed_square_step,
    )

    n, W = reach.packed.shape
    Np = W * 32
    t, dt = _fit_tile(Np, 7168), _fit_tile(Np, 14336)
    bound_s = 2 * n ** 3 / H100_INT8_OPS
    log(f"closure: {n} rows x {W} words (Np = {Np}), row tile {t}, dst stripe {dt}, "
        f"{(Np // t) * (Np // dt)} products per pass; pass bound 2*N^3/peak = "
        f"{bound_s:.3f} s on the real N ({2 * Np ** 3 / H100_INT8_OPS:.3f} s on Np); "
        f"reach {reach.timings['reachable_pairs']} pairs")
    passes, keep = [], {}
    start = torch.cuda.Event(enable_timing=True)

    def on_pass(i, packed, pairs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        passes.append((i, ev, pairs))
        if i == 1:
            keep["first"] = packed[:n].clone()  # R ∨ R², for the hop-2 checks

    with Phase("closure: PackedReach.closure()"):
        start.record()
        closed = reach.closure(on_pass=on_pass)
    prev = start
    for i, ev, pairs in passes:
        ms = prev.elapsed_time(ev)
        log(f"closure: pass {i}: {ms:.1f} ms ({ms / 1e3 / bound_s:.2f}x the bound), "
            f"{pairs} reachable pairs; {smi}")
        prev = ev
    with Phase("closure: checks"):
        if bool((reach.packed & ~closed.packed).any()):
            fail("closure: the closure does not contain the reach")
        pad = torch.nn.functional.pad
        square = pad(closed.packed, (0, 0, 0, Np - n))
        again_ms = cuda_ms(lambda: keep.update(
            again=_packed_square_step(square, row_tile=t, dst_tile=dt)))
        if not torch.equal(keep.pop("again")[:n], closed.packed):
            fail("closure: one more squaring changes the closure (no fixpoint)")
        log(f"closure: contains the reach; one more squaring ({again_ms:.1f} ms) "
            f"leaves it unchanged")
        del square
        words = pad(reach.packed, (0, 0, 0, Np - n))
        seeds = np.sort(np.random.default_rng(10).choice(n, 1024, replace=False))
        tb = time.perf_counter()
        acc, _ = kvt.bounded_packed_closure(words, seeds, want_hops=False)
        bfs_s = time.perf_counter() - tb
        if not torch.equal(acc, closed.packed[torch.as_tensor(seeds, device=acc.device)]):
            fail("closure: the bounded BFS rows differ from the closure's")
        tb = time.perf_counter()
        acc2, _ = kvt.bounded_packed_closure(words, seeds, hops=2, want_hops=False)
        bfs2_s = time.perf_counter() - tb
        first = keep.pop("first")
        if not torch.equal(acc2, first[torch.as_tensor(seeds, device=acc2.device)]):
            fail("closure: hops=2 rows differ from the first squaring pass's")
        log(f"closure: bounded_packed_closure of 1,024 seeds == their closure rows "
            f"({bfs_s:.2f} s); hops=2 == the first pass's rows ({bfs2_s:.2f} s)")
        del acc, acc2
        tb = time.perf_counter()
        path2 = kvt.path_upto(words, 2)
        path_s = time.perf_counter() - tb
        if not torch.equal(path2[:n], first):
            fail("closure: path_upto(hops=2) differs from the first squaring pass")
        log(f"closure: path_upto(hops=2) over all {Np} rows == the first pass "
            f"({path_s:.2f} s)")
        del path2, first
        tb = time.perf_counter()
        _, hop = kvt.bounded_packed_closure(words, seeds[:64])
        hist = np.bincount(hop[:, :n].ravel())
        log(f"closure: hop histogram of 64 seeds over the {n} real columns "
            f"(level: pairs, 0 = unreachable): "
            + ", ".join(f"{lv}: {c}" for lv, c in enumerate(hist))
            + f" ({time.perf_counter() - tb:.2f} s)")
    return closed.packed


def _block_graph(n: int, block: int, degree: float, rng):
    """bool [n, n] of disjoint ``block``-node random components."""
    import numpy as np

    g = np.zeros((n, n), dtype=bool)
    for b0 in range(0, n, block):
        g[b0:b0 + block, b0:b0 + block] = rng.random((block, block)) < degree / block
    return g


def delta_phase(dev) -> None:
    """Phase 11: ``packed_closure_delta`` through both of its routes."""
    from kubernetes_verification_tpu_torch.ops import closure

    # count the calls of each route's step, to show which route ran
    calls = {"_closure_rows_step": 0, "_add_edges_round": 0}
    real = {name: getattr(closure, name) for name in calls}
    for name in calls:

        def counted(*a, _name=name, **k):
            calls[_name] += 1
            return real[_name](*a, **k)

        setattr(closure, name, counted)
    try:
        _delta_routes(dev, calls)
    finally:
        for name, fn in real.items():
            setattr(closure, name, fn)


def _delta_routes(dev, calls: dict) -> None:
    """The two routes from one base closure; ``calls`` counts their steps."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.bits import pack_bool_cols
    from kubernetes_verification_tpu_torch.ops.closure import packed_pair_total

    def words(b):
        return pack_bool_cols(torch.as_tensor(b, device=dev))

    rng = np.random.default_rng(11)
    n = DELTA_N
    log(f"delta: N = {n} (cut from the flagship's 100,000 for time), 32 random "
        f"components of 256 nodes, ~1.3 edges per row")
    base = _block_graph(n, 256, 1.3, rng)
    with Phase("delta: base closure"):
        prev = kvt.packed_closure(words(base))
    removed = base.copy()
    rows, cols = np.nonzero(base[512:768, 512:768])
    removed[rows[:5] + 512, cols[:5] + 512] = False
    dirty = (removed != base).any(axis=0) | (removed != base).any(axis=1)
    added = base.copy()
    for s, d in rng.integers(0, n, (16, 2)):
        added[s, d] = True
    for name, new, kw, step in (
        ("suspect route (5 bits removed)", removed, {}, "_closure_rows_step"),
        ("additions-only route (16 bits added, prev_base)", added,
         {"prev_base": words(base)}, "_add_edges_round"),
    ):
        before = calls[step]
        with Phase(f"delta: {name}"):
            t0 = time.perf_counter()
            got = kvt.packed_closure_delta(words(new), prev, dirty, **kw)
            torch.cuda.synchronize()
            delta_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = kvt.packed_closure(words(new))
            full_s = time.perf_counter() - t0
        if calls[step] == before:
            fail(f"delta: the {name} did not run {step}")
        if not torch.equal(got, want):
            fail(f"delta: the {name} differs from packed_closure(new_base)")
        log(f"delta: {name}: {delta_s * 1e3:.1f} ms ({calls[step] - before} {step} "
            f"calls) == packed_closure(new_base) ({full_s * 1e3:.1f} ms), "
            f"{packed_pair_total(got)} pairs")


class FirstLetterPrefix:
    """A prefix label relation (the ``LabelRelation`` protocol): a rule
    value accepts every label value that starts with the rule value's first
    letter."""

    def match(self, rule_value: str, label_value: str) -> bool:
        return label_value.startswith(rule_value[:1])


def kano_phase(dev, smi: str) -> None:
    """Phase 12: kano mode at 10k containers / 1k policies, and the same
    containers under 20 policies."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.bits import (
        pack_bool_cols,
        to_host_words,
        unpack_cols,
    )

    scenarios = (
        (KANO, "default", None, 256),
        (KANO, "prefix relation", FirstLetterPrefix(), 256),
        # a sparse policy set: its closure is neither all pairs nor the
        # product of its margins, so it is checked on every row
        (KANO_SPARSE, "default", None, None),
    )
    drawn = {}
    for cfg, label, rel, n_rows in scenarios:
        key = tuple(sorted(cfg.items()))
        if key not in drawn:
            t0 = time.perf_counter()
            drawn[key] = kvt.random_kano(**cfg)
            log(f"kano: random_kano {cfg}: {time.perf_counter() - t0:.2f} s")
        containers, policies = drawn[key]
        name = f"{len(containers)} x {len(policies)}, {label}"
        with Phase(f"kano: verify_kano ({name})"):
            res = kvt.verify_kano(containers, policies, kvt.VerifyConfig(
                backend="torch", closure=True, label_relation=rel))
        n = len(containers)
        t0 = time.perf_counter()
        src, dst = host_kano_sets(containers, policies, rel)
        if not (np.array_equal(res.src_sets, src) and np.array_equal(res.dst_sets, dst)):
            fail(f"kano ({name}): src/dst sets differ from the host's evaluation of "
                 f"the policies")
        if [(c.select_policies, c.allow_policies) for c in containers] != [
            (np.nonzero(src[:, i])[0].tolist(), np.nonzero(dst[:, i])[0].tolist())
            for i in range(n)
        ]:
            fail(f"kano ({name}): the Container policy lists were not refilled")
        rows = (np.arange(n) if n_rows is None else
                np.sort(np.random.default_rng(12).choice(n, n_rows, replace=False)))
        want = (src[:, rows].T.astype(np.float64) @ dst.astype(np.float64)) > 0
        if not np.array_equal(res.reach[rows], want):
            fail(f"kano ({name}): reach rows differ from the host's float64 "
                 f"recomputation")
        if not np.array_equal(res.closure[rows], host_kano_closure_rows(src, dst, rows)):
            fail(f"kano ({name}): closure rows differ from the host's policy-graph "
                 f"closure")
        host_s = time.perf_counter() - t0
        margins = int(res.reach.any(axis=1).sum()) * int(res.reach.any(axis=0).sum())
        log(f"kano ({name}): encode {res.timings['encode']:.2f} s, solve + dense "
            f"closure {res.timings['solve'] * 1e3:.1f} ms, {int(res.reach.sum())} "
            f"reachable pairs, {int(res.closure.sum())} in the closure of {n * n} "
            f"(rows with an edge x columns with an edge: {margins}); {smi}")
        log(f"kano ({name}): src/dst sets and the Container lists == the host's "
            f"evaluation; {len(rows)} reach rows == host float64 and closure rows == "
            f"the host's policy-graph closure ({host_s:.2f} s on the host)")
        with Phase(f"kano: packed_closure of the packed reach ({name})"):
            pad = (-n) % 32
            r = torch.nn.functional.pad(torch.as_tensor(res.reach, device=dev),
                                        (0, pad, 0, pad))
            w = pack_bool_cols(r)
            t0 = time.perf_counter()
            closed = kvt.packed_closure(w)
            packed_s = time.perf_counter() - t0
        if not np.array_equal(unpack_cols(to_host_words(closed[:n]), n), res.closure):
            fail(f"kano ({name}): the dense closure differs from packed_closure's")
        log(f"kano ({name}): dense closure == packed_closure of the packed reach "
            f"({packed_s * 1e3:.1f} ms)")


def card_vs_cpu_phase(dev) -> None:
    """Phase 13: the new entry points on the card against the CPU."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.queries import _pairs

    cluster = kvt.random_cluster(kvt.GeneratorConfig(**VERIFY))
    closures = {}
    for compute_ports in (True, False):
        runs = {}
        for device in ("cuda", "cpu"):
            with Phase(f"card vs cpu: verify(closure=True, compute_ports="
                       f"{compute_ports}) on {device}"):
                runs[device] = kvt.verify(cluster, kvt.VerifyConfig(
                    backend="torch", compute_ports=compute_ports, closure=True,
                    backend_options=(("device", device),),
                ))
        for f in ("reach", "closure", "src_sets", "dst_sets"):
            if not np.array_equal(getattr(runs["cuda"], f), getattr(runs["cpu"], f)):
                fail(f"card vs cpu: verify(closure=True) {f} differs "
                     f"(compute_ports={compute_ports})")
        closures[compute_ports] = runs["cuda"].closure
        log(f"card vs cpu: verify(closure=True, compute_ports={compute_ports}) "
            f"cuda == cpu, {int(closures[compute_ports].sum())} pairs in the closure")
    for compute_ports, launches in ((False, (2, 0)), (True, (0, 1))):
        enc = kvt.encode_cluster(cluster, compute_ports=compute_ports)
        reset_counts()
        tiled = kvt.tiled_k8s_reach(enc, device=dev, fetch=False)
        if launch_counts() != launches:
            fail(f"card vs cpu: the tiled solve launched {launch_counts()}, not {launches}")
        closed = tiled.closure()
        if not np.array_equal(closed.to_bool(), closures[compute_ports]):
            fail(f"card vs cpu: PackedReach.closure() of the {tiled.meta['kernel']} "
                 f"path differs from the dense closure")
        log(f"card vs cpu: PackedReach.closure() of the {tiled.meta['kernel']} path "
            f"== the dense closure")
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    with Phase("card vs cpu: policy_pair_masks"):
        shadow, conflict = kvt.policy_pair_masks(enc, device=dev)
    if _pairs(shadow) != runs["cpu"].policy_shadow() or (
        _pairs(conflict) != runs["cpu"].policy_conflict()
    ):
        fail("card vs cpu: policy_pair_masks differ from the dense CPU queries")
    log(f"card vs cpu: policy_pair_masks == the dense CPU policy_shadow / "
        f"policy_conflict ({len(_pairs(shadow))} + {len(_pairs(conflict))} pairs)")
    for rel in (None, FirstLetterPrefix()):
        runs = {}
        for device in ("cuda", "cpu"):
            containers, policies = kvt.random_kano(2_000, 200, seed=1)
            with Phase(f"card vs cpu: verify_kano on {device}"):
                res = kvt.verify_kano(containers, policies, kvt.VerifyConfig(
                    backend="torch", closure=True, label_relation=rel,
                    backend_options=(("device", device),)))
            runs[device] = (res, [(c.select_policies, c.allow_policies)
                                  for c in containers])
        for f in ("reach", "src_sets", "dst_sets", "closure"):
            if not np.array_equal(getattr(runs["cuda"][0], f), getattr(runs["cpu"][0], f)):
                fail(f"card vs cpu: verify_kano {f} differs (relation {rel})")
        if runs["cuda"][1] != runs["cpu"][1]:
            fail("card vs cpu: verify_kano Container policy lists differ")
        log(f"card vs cpu: verify_kano ({'prefix relation' if rel else 'default'}) "
            f"cuda == cpu on every field and every Container's lists")


def _timed(lat: dict, kind: str, fn):
    """Run one engine op, wait for the card, and file its host-clock
    latency under ``kind``."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    lat.setdefault(kind, []).append(time.perf_counter() - t0)
    return out


def _engine_words_equal(eng, words, d0: int = 0) -> bool:
    """``words`` (host uint32 [n, k]) == the engine's words over its slots,
    word columns ``d0/32 .. d0/32 + k``."""
    import numpy as np

    from kubernetes_verification_tpu_torch.ops.bits import to_host_words

    w0 = d0 // 32
    want = to_host_words(eng._packed[: eng.n_pods, w0 : w0 + words.shape[1]])
    return np.array_equal(words, want)


def _diff_stream(eng, cluster, donor, rng, lat: dict) -> None:
    """Phase 14's diff stream: 16 policy adds (from ``donor``), 16 updates,
    16 removes, 32 pod relabels (half to label sets other pods carry, half
    to pairs the frozen vocabulary never saw), 32 pod removes and adds
    (tombstones reused first), a new namespace and one relabel of it."""
    import dataclasses

    import kubernetes_verification_tpu_torch as kvt

    pols = list(cluster.policies)
    picks = rng.choice(len(pols), 32, replace=False)
    for i, p in enumerate(donor.policies[:16]):
        _timed(lat, "add_policy", lambda: eng.add_policy(
            dataclasses.replace(p, name=f"smoke-add-{i}")))
    for j in picks[:16]:
        src = pols[(j + 1) % len(pols)]
        _timed(lat, "update_policy", lambda: eng.update_policy(dataclasses.replace(
            pols[j], ingress=src.ingress, egress=src.egress,
            policy_types=src.policy_types)))
    for j in picks[16:]:
        _timed(lat, "remove_policy", lambda: eng.remove_policy(
            pols[j].namespace, pols[j].name))
    live = eng.active_indices()
    for k, i in enumerate(rng.choice(live, 32, replace=False)):
        labels = (dict(eng.pods[int(rng.choice(live))].labels) if k < 16
                  else {"smoke": f"unseen-{k}", "app": "alpha"})
        _timed(lat, "update_pod_labels", lambda: eng.update_pod_labels(int(i), labels))
    ns_new = kvt.Namespace("smoke-ns", dict(cluster.namespaces[3].labels))
    _timed(lat, "add_namespace", lambda: eng.add_namespace(ns_new))
    victims = rng.choice(eng.active_indices(), 16, replace=False)
    for i in victims[:8]:
        p = eng.pods[int(i)]
        _timed(lat, "remove_pod", lambda: eng.remove_pod(p.namespace, p.name))
    for k in range(16):  # 8 reuse the tombstones, 8 take headroom slots
        ns = "smoke-ns" if k % 2 else cluster.namespaces[k % 20].name
        donor_pod = donor.pods[k]
        _timed(lat, "add_pod", lambda: eng.add_pod(kvt.Pod(
            f"smoke-pod-{k}", ns, dict(donor_pod.labels), ip=donor_pod.ip)))
    for i in victims[8:]:
        p = eng.pods[int(i)]
        _timed(lat, "remove_pod", lambda: eng.remove_pod(p.namespace, p.name))
    _timed(lat, "update_namespace_labels", lambda: eng.update_namespace_labels(
        "smoke-ns", dict(cluster.namespaces[7].labels)))


def live_vs_one_shot(eng, dev, tag: str) -> None:
    """A packed engine's live rows x live columns against a one-shot
    ``tiled_k8s_reach`` of its ``as_cluster()`` (2 ``packed_dir_allow``
    launches), bit for bit, 4,096 rows at a time."""
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.bits import unpack_words_i8

    t0 = time.perf_counter()
    live = eng.as_cluster()
    enc = kvt.encode_cluster(live, compute_ports=False)
    one = kvt.tiled_k8s_reach(enc, fetch=False, device=dev)
    log(f"{tag}: one-shot re-solve of the mutated cluster ({enc.n_pods} pods, "
        f"{enc.n_policies} policies) {time.perf_counter() - t0:.2f} s")
    act = torch.as_tensor(eng.active_indices(), device=dev)
    n_live = act.shape[0]
    for r0 in range(0, n_live, 4096):
        rows = act[r0 : r0 + 4096]
        mine = unpack_words_i8(eng._packed[rows], eng._n_padded)[:, act]
        theirs = unpack_words_i8(one.packed[r0 : r0 + 4096], one.packed.shape[1] * 32)
        if not (torch.equal(mine, theirs[:, :n_live]) and not theirs[:, n_live:].any()):
            fail(f"{tag}: live rows {r0}.. differ from the one-shot solve of as_cluster()")
    log(f"{tag}: live rows x live columns ({n_live} x {n_live}) == the one-shot "
        f"solve of as_cluster(), bit for bit")


def engine_phase(cluster, main_words, dev, smi: str) -> tuple:
    """Phase 14: the serving engine at full width on phase 4's cluster.
    Returns the build's ``packed_dir_allow`` launches and the engine (phase
    20 diffs its words)."""
    import dataclasses

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.batched import packed_any_port
    from kubernetes_verification_tpu_torch.ops.bits import to_host_words

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng = kvt.PackedIncrementalVerifier(cluster, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = launch_counts()
    n, Np = eng.n_pods, eng._n_padded
    log(f"engine: build {build_s:.2f} s (" + ", ".join(
        f"{k} {v:.2f} s" for k, v in eng.build_timings.items())
        + f"), Np {Np}, capacity {eng._capacity}, packed_dir_allow launches "
        f"{launches[0]}, fused_ports_reach launches {launches[1]}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    if launches != (2, 0):
        fail(f"the engine build launched {launches}, not (2, 0)")
    w = -(-n // 32)
    if not torch.equal(eng._packed[:n, :w], main_words[:, :w]):
        fail("engine: the build's words differ from phase 4's tiled_k8s_reach words")
    if eng._packed[:, w:].any() or eng._packed[n:].any():
        fail("engine: a pad word or pad row of the build is not zero")
    log(f"engine: build words [:{n}, :{w}] == phase 4's tiled_k8s_reach words, bit for bit")

    # the diff stream; no hand-written kernel runs in it
    rng = np.random.default_rng(14)
    donor = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=2_000, n_policies=64, n_namespaces=20, p_ipblock_peer=0.0,
        min_selector_labels=1, seed=1))
    lat: dict = {}
    _diff_stream(eng, cluster, donor, rng, lat)
    if launch_counts() != launches:
        fail(f"engine: the diff stream launched a hand-written kernel: {launch_counts()}")
    for kind, ts in lat.items():
        log(f"engine: {kind} x{len(ts)}: median {statistics.median(ts) * 1e3:.1f} ms, "
            f"max {max(ts) * 1e3:.1f} ms (host clock after a device sync)")
    log(f"engine: after the stream {eng.n_active} live pods in {eng.n_pods} slots, "
        f"{len(eng.policies)} policies, capacity {eng._capacity}, "
        f"{len(eng._vectorizer.dirty)} label-drifted pods")

    # an independent one-shot solve of the mutated cluster
    live_vs_one_shot(eng, dev, "engine")
    sample = np.sort(rng.choice(eng.active_indices(), 1024, replace=False))
    t0 = time.perf_counter()
    got = eng.solve_rows(sample)
    rows_s = time.perf_counter() - t0
    if not np.array_equal(got, to_host_words(eng._packed[torch.as_tensor(sample, device=dev)])):
        fail("engine: solve_rows differs from the engine's words")
    t0 = time.perf_counter()
    stripe = eng.solve_stripe(0, 4096)
    stripe_s = time.perf_counter() - t0
    if not _engine_words_equal(eng, stripe):
        fail("engine: solve_stripe(0, 4096) differs from the engine's words")
    src = np.unique(rng.choice(eng.active_indices(), 512))
    q_row = rng.integers(0, len(src), 4096)
    q_dst = rng.choice(eng.active_indices(), 4096)
    t0 = time.perf_counter()
    rows_w, ans = packed_any_port(*eng._maps, eng._col_mask, eng._row_valid, src,
                                  q_row, q_dst, self_traffic=True, default_allow=True)
    probe_s = time.perf_counter() - t0
    host = to_host_words(eng._packed[torch.as_tensor(src, device=dev)])
    want = (host[q_row, q_dst // 32] >> (q_dst % 32).astype(np.uint32)) & 1
    if not (np.array_equal(rows_w, host) and np.array_equal(ans, want > 0)):
        fail("engine: packed_any_port differs from the engine's words")
    log(f"engine: solve_rows(1,024 rows) {rows_s * 1e3:.1f} ms, solve_stripe(0, 4096) "
        f"{stripe_s * 1e3:.1f} ms, packed_any_port(4,096 probes, {len(src)} sources) "
        f"{probe_s * 1e3:.1f} ms: each == the engine's words")

    # round trips; from here on no hand-written kernel runs
    reset_counts()
    t0 = time.perf_counter()
    state = eng.state_dict()
    save_s = time.perf_counter() - t0
    manifest = eng.as_cluster(include_inactive=True)
    t0 = time.perf_counter()
    back = kvt.PackedIncrementalVerifier.from_state(manifest, state, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_split = back.build_timings
    if not torch.equal(back._packed, eng._packed):
        fail("engine: from_state(state_dict()) words differ")
    again = back.state_dict()
    for k, v in state.items():
        if np.asarray(v).tobytes() != np.asarray(again[k]).tobytes():
            fail(f"engine: from_state(state_dict()) changes {k}")
    del back, again
    torch.cuda.empty_cache()
    log(f"engine: state_dict {save_s:.2f} s ({sum(np.asarray(v).nbytes for v in state.values()) / 2**30:.2f} "
        f"GiB on the host), from_state {load_s:.2f} s (" + ", ".join(
            f"{k} {v:.2f} s" for k, v in load_split.items())
        + "); the resumed engine's words and state arrays == the saved ones")
    mf = kvt.PackedIncrementalVerifier.from_state(manifest, state, device=dev,
                                                  keep_matrix=False)
    del state
    # the same 8 diffs to both; the pod add reuses the slot the remove just
    # freed, the last tombstone of both engines' free lists
    held = list(eng.policies.values())
    act = eng.active_indices()
    gone = eng.pods[int(act[123])]
    more = [
        ("update_pod_labels", int(act[7]), {"mf": "one"}),
        ("update_pod_labels", int(act[len(act) * 7 // 10]),
         dict(eng.pods[int(act[3])].labels)),
        ("remove_policy", held[11].namespace, held[11].name),
        ("add_policy", dataclasses.replace(donor.policies[40], name="mf-add")),
        ("remove_pod", gone.namespace, gone.name),
        ("add_pod", kvt.Pod("mf-pod", "smoke-ns", {"app": "mf"})),
        ("update_namespace_labels", "smoke-ns", dict(cluster.namespaces[2].labels)),
        ("update_policy", dataclasses.replace(held[5], ingress=())),
    ]
    for op, *args in more:
        for e in (eng, mf):
            getattr(e, op)(*args)
    # sweep_dirty's stripes must tile Np (as in the JAX engine, a stripe
    # past it is refused): 4,352 divides the flagship's Np = 100,096
    from kubernetes_verification_tpu_torch.ops.closure import _fit_tile

    width = _fit_tile(mf._n_padded, 4352)
    t0 = time.perf_counter()
    swept = 0
    for d0, words in mf.sweep_dirty(width):
        if not _engine_words_equal(eng, words, d0):
            fail(f"engine: matrix-free sweep_dirty stripe {d0} differs from the kept "
                 f"engine's words")
        swept += 1
    sweep_s = time.perf_counter() - t0
    if mf.dirty_rows.any() or mf.dirty_cols.any():
        fail("engine: sweep_dirty left dirty marks")
    torch.cuda.synchronize()
    log(f"engine: matrix-free from_state + 8 diffs: sweep_dirty({width}) re-solved "
        f"{swept} stripes in {sweep_s:.2f} s, each == the kept engine's words")
    if launch_counts() != (0, 0):
        fail(f"engine: the round trips or the matrix-free sweep launched a "
             f"hand-written kernel: {launch_counts()}")
    log(f"engine: {time.perf_counter() - t_phase:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    del mf
    return launches[0], eng


def engine_card_vs_cpu_phase(dev) -> None:
    """Phase 15: the engine on the card against the engine on the CPU, at
    phase 8's size, state_dict after every op."""
    import dataclasses

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt

    cluster = kvt.random_cluster(kvt.GeneratorConfig(**VERIFY))
    donor = kvt.random_cluster(kvt.GeneratorConfig(**{**VERIFY, "seed": 2}))
    pols = list(cluster.policies)
    rng = np.random.default_rng(15)
    ops = [("add_policy", dataclasses.replace(p, name=f"cv-{i}"))
           for i, p in enumerate(donor.policies[:6])]
    ops += [("update_policy", dataclasses.replace(pols[i], ingress=pols[i + 1].ingress))
            for i in (3, 30, 60)]
    ops += [("remove_policy", pols[i].namespace, pols[i].name) for i in (10, 90, 150)]
    ops += [("update_pod_labels", int(i), dict(cluster.pods[int(i) + 1].labels))
            for i in rng.choice(1_999, 4, replace=False)]
    ops += [("update_pod_labels", int(i), {"cv": "unseen"})
            for i in rng.choice(2_000, 4, replace=False)]
    victims = rng.choice(2_000, 6, replace=False)
    ops += [("remove_pod", cluster.pods[int(i)].namespace, cluster.pods[int(i)].name)
            for i in victims]
    ops += [("add_namespace", kvt.Namespace("cv-ns", {"team": "cv"}))]
    ops += [("add_pod", kvt.Pod(f"cv-pod-{k}", "cv-ns" if k % 3 else "ns1",
                                dict(cluster.pods[k].labels))) for k in range(60)]
    ops += [("update_namespace_labels", "ns2", dict(cluster.namespaces[4].labels)),
            ("update_namespace_labels", "cv-ns", {"team": "other"})]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    engines = {d: kvt.PackedIncrementalVerifier(cluster, device=d)
               for d in ("cuda", "cpu")}
    if launch_counts() != (2, 0):
        fail(f"engine card vs cpu: the card's build launched {launch_counts()}, not (2, 0)")
    Np0 = engines["cuda"]._n_padded
    for op, *args in [("build",)] + ops:
        for e in engines.values():
            if op != "build":
                getattr(e, op)(*args)
        want, got = engines["cpu"].state_dict(), engines["cuda"].state_dict()
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            if w.dtype != g.dtype or w.shape != g.shape or w.tobytes() != g.tobytes():
                fail(f"engine card vs cpu: {k} differs after {op}")
    if engines["cuda"]._n_padded <= Np0:
        fail("engine card vs cpu: the pod axis did not grow")
    closures = {d: e.closure_packed() for d, e in engines.items()}
    eng = engines["cuda"]
    if not (torch.equal(closures["cuda"], kvt.packed_closure(eng._packed.clone()))
            and torch.equal(closures["cuda"].cpu(), closures["cpu"])):
        fail("engine card vs cpu: closure_packed differs from packed_closure of the words")
    if launch_counts() != (2, 0):
        fail(f"engine card vs cpu: the stream launched a hand-written kernel: "
             f"{launch_counts()}")
    torch.cuda.synchronize()
    log(f"engine card vs cpu: {len(ops)} ops, state_dict cuda == cpu after the build "
        f"and after each op (Np {Np0} -> {eng._n_padded}, capacity {eng._capacity}); "
        f"closure_packed == packed_closure of the words on the card and the CPU "
        f"engine's; {time.perf_counter() - t0:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _fits(eng, pol, recycled: dict, margin: int = 2) -> bool:
    """True when ``pol``'s VP row groups lie inside the ports engine's
    frozen universe and leave every segment they use at least ``margin``
    free rows: the engine's own host planner, which mutates nothing."""
    import kubernetes_verification_tpu_torch as kvt

    try:
        _, _, gi, ge = eng._policy_groups(pol)
        for d, groups in (("i", gi), ("e", ge)):
            eng._plan_alloc(d, groups, list(recycled.get(d, ())))
            used: dict = {}
            for seg, _ in groups:
                used[seg] = used.get(seg, 0) + 1
            for seg, k in used.items():
                back = sum(eng._seg_of_row(d, r) == seg for r in recycled.get(d, ()))
                if len(eng._free_rows[d][seg]) + back - k < margin:
                    return False
    except kvt.PortUniverseChanged:
        return False
    return True


def _ports_stream(eng, cluster, rng, lat: dict) -> None:
    """Phase 16's diff stream: 8 policy adds (copies of existing policies
    under new names, each leaving its segments free rows), 8 updates, 8
    removes, one policy outside the frozen universe (refused, words
    unchanged), 8 pod relabels (half to unseen pairs), 4 pod removes, a new
    namespace, 8 pod adds into it (4 reuse the tombstones, 4 take headroom
    slots), 4 more removes, and one relabel of the new namespace."""
    import dataclasses

    import kubernetes_verification_tpu_torch as kvt

    pols = list(cluster.policies)
    order = iter(rng.permutation(len(pols)))
    k = 0
    while k < 8:
        p = dataclasses.replace(pols[next(order)], name=f"smoke-add-{k}")
        if _fits(eng, p, {}):
            _timed(lat, "add_policy", lambda: eng.add_policy(p))
            k += 1
    k = 0
    while k < 8:
        tgt, src = pols[next(order)], pols[next(order)]
        p = dataclasses.replace(tgt, ingress=src.ingress, egress=src.egress,
                                policy_types=src.policy_types)
        if _fits(eng, p, eng._pol_rows[eng._key(tgt)]):
            _timed(lat, "update_policy", lambda: eng.update_policy(p))
            k += 1
    for _ in range(8):
        p = pols[next(order)]
        _timed(lat, "remove_policy", lambda: eng.remove_policy(p.namespace, p.name))
    # a port number inside a wide atom splits it: refused before any mutation
    atom = next(a for a in eng._atoms if a.name is None and a.hi - a.lo >= 2)
    alien = kvt.NetworkPolicy(
        "smoke-alien", namespace=cluster.namespaces[0].name, pod_selector=kvt.Selector(),
        ingress=(kvt.Rule(peers=(), ports=(kvt.PortSpec(atom.protocol, atom.lo + 1),)),))
    before, count = eng._packed.clone(), eng.update_count
    try:
        eng.add_policy(alien)
        fail("ports engine: a policy splitting a port atom was accepted")
    except kvt.PortUniverseChanged as e:
        log(f"ports engine: refused {atom.protocol} {atom.lo + 1} inside atom "
            f"[{atom.lo}, {atom.hi}]: {e}")
    if not torch.equal(before, eng._packed) or eng.update_count != count:
        fail("ports engine: the refused policy changed the words")
    del before
    live = eng.active_indices()
    for k, i in enumerate(rng.choice(live, 8, replace=False)):
        labels = (dict(eng.pods[int(rng.choice(live))].labels) if k < 4
                  else {"smoke": f"unseen-{k}", "app": "alpha"})
        _timed(lat, "update_pod_labels", lambda: eng.update_pod_labels(int(i), labels))
    victims = rng.choice(eng.active_indices(), 8, replace=False)
    for i in victims[:4]:
        p = eng.pods[int(i)]
        _timed(lat, "remove_pod", lambda: eng.remove_pod(p.namespace, p.name))
    _timed(lat, "add_namespace", lambda: eng.add_namespace(
        kvt.Namespace("smoke-ns", dict(cluster.namespaces[3].labels))))
    ported = [p for p in cluster.pods if p.container_ports]
    for k in range(8):
        donor = cluster.pods[int(rng.integers(len(cluster.pods)))]
        ports = dict(ported[int(rng.integers(len(ported)))].container_ports)
        _timed(lat, "add_pod", lambda: eng.add_pod(kvt.Pod(
            f"smoke-pod-{k}", "smoke-ns", dict(donor.labels), ip=donor.ip,
            container_ports=ports)))
    for i in victims[4:]:
        p = eng.pods[int(i)]
        _timed(lat, "remove_pod", lambda: eng.remove_pod(p.namespace, p.name))
    _timed(lat, "update_namespace_labels", lambda: eng.update_namespace_labels(
        "smoke-ns", dict(cluster.namespaces[7].labels)))


def ports_engine_phase(cluster, ports_words, dev, smi: str) -> int:
    """Phase 16: the port-bitmap serving engine at full width on phase 6's
    cluster. Returns the build's ``fused_ports_reach`` launches."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch import packed_incremental_ports as pip
    from kubernetes_verification_tpu_torch.ops.bits import pack_bool_cols, unpack_words_i8
    from kubernetes_verification_tpu_torch.ops.tiled_ports import _padded_k, _segments

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng = kvt.PackedPortsIncrementalVerifier(cluster, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = launch_counts()
    n, Np, lay = eng.n_pods, eng._n_padded, eng._layout
    log(f"ports engine: build {build_s:.2f} s (" + ", ".join(
        f"{k} {v:.2f} s" for k, v in eng.build_timings.items())
        + f"), Np {Np}, R {lay.n_masks}, VP rows {eng._total_rows['i']} ingress + "
        f"{eng._total_rows['e']} egress (sink rows included), K' "
        f"{_padded_k(_segments(lay))}, fused_ports_reach launches {launches[1]}, "
        f"packed_dir_allow launches {launches[0]}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    if launches != (0, 1):
        fail(f"the ports engine build launched {launches}, not (0, 1)")
    w = ports_words.shape[1]
    if not torch.equal(eng._packed[:n, :w].cpu(), ports_words):
        fail("ports engine: the build's words differ from phase 6's tiled_k8s_reach words")
    if eng._packed[:, w:].any() or eng._packed[n:].any():
        fail("ports engine: a pad word or pad row of the build is not zero")
    log(f"ports engine: build words [:{n}, :{w}] == phase 6's words, bit for bit")

    # the diff path's formula against the kernel, before any diff
    rng = np.random.default_rng(16)
    flags = dict(self_traffic=True, default_allow=True)
    args = (eng._src, eng._dst, lay)
    ar = torch.arange(Np, device=dev)
    rows = torch.as_tensor(np.sort(rng.choice(n, 512, replace=False)), device=dev)
    t0 = time.perf_counter()
    r = pip._ports_reach_block(*args, eng._ing_cnt, eng._eg_cnt[rows], rows, ar,
                               rows=rows, **flags)
    r &= (eng._row_valid[rows] > 0)[:, None]
    if not torch.equal(pack_bool_cols(r) & eng._col_mask[None, :], eng._packed[rows]):
        fail("ports engine: _ports_reach_block rows differ from the kernel's words")
    cols = torch.as_tensor(np.sort(rng.choice(n, 256, replace=False)), device=dev)
    c = pip._ports_reach_block(*args, eng._ing_cnt[cols], eng._eg_cnt, ar, cols,
                               cols=cols, **flags)
    c &= (eng._row_valid > 0)[:, None]
    bits = (eng._packed[:, cols // 32] >> (cols % 32).to(torch.int32)) & 1
    if not torch.equal(c, bits > 0):
        fail("ports engine: _ports_reach_block columns differ from the kernel's words")
    torch.cuda.synchronize()
    log(f"ports engine: 512 sampled rows and 256 sampled columns through "
        f"_ports_reach_block == the kernel's words ({time.perf_counter() - t0:.2f} s)")
    del r, c, bits

    lat: dict = {}
    _ports_stream(eng, cluster, rng, lat)
    if launch_counts() != launches:
        fail(f"ports engine: the diff stream launched a hand-written kernel: {launch_counts()}")
    for kind, ts in lat.items():
        log(f"ports engine: {kind} x{len(ts)}: median {statistics.median(ts) * 1e3:.1f} ms, "
            f"max {max(ts) * 1e3:.1f} ms (host clock after a device sync)")
    host = []
    for i in rng.choice(eng.active_indices(), 4, replace=False):
        t0 = time.perf_counter()
        eng._pod_vp_cols(eng.pods[int(i)])
        host.append(time.perf_counter() - t0)
    log(f"ports engine: a pod op's host evaluation (_pod_vp_cols) x4: median "
        f"{statistics.median(host) * 1e3:.1f} ms, max {max(host) * 1e3:.1f} ms; after "
        f"the stream {eng.n_active} live pods in {eng.n_pods} slots, "
        f"{len(eng.policies)} policies, {len(eng._vectorizer.dirty)} label-drifted pods")

    # an independent one-shot solve of the mutated cluster
    t0 = time.perf_counter()
    enc = kvt.encode_cluster(eng.as_cluster(), compute_ports=True)
    one = kvt.tiled_k8s_reach(enc, fetch=False, device=dev)
    log(f"ports engine: one-shot re-solve of the mutated cluster ({enc.n_pods} pods, "
        f"{enc.n_policies} policies) {time.perf_counter() - t0:.2f} s")
    act = torch.as_tensor(eng.active_indices(), device=dev)
    n_live = act.shape[0]
    for r0 in range(0, n_live, 4096):
        mine = unpack_words_i8(eng._packed[act[r0 : r0 + 4096]], Np)[:, act]
        theirs = unpack_words_i8(one.packed[r0 : r0 + 4096], one.packed.shape[1] * 32)
        if not (torch.equal(mine, theirs[:, :n_live]) and not theirs[:, n_live:].any()):
            fail(f"ports engine: live rows {r0}.. differ from the one-shot solve of as_cluster()")
    log(f"ports engine: live rows x live columns ({n_live} x {n_live}) == the one-shot "
        f"port-bitmap solve of as_cluster(), bit for bit")
    del one, enc

    # the round trip; no hand-written kernel runs in it
    reset_counts()
    t0 = time.perf_counter()
    arrays, meta = eng.state_dict()
    save_s = time.perf_counter() - t0
    manifest = eng.as_cluster(include_inactive=True)
    t0 = time.perf_counter()
    back = kvt.PackedPortsIncrementalVerifier.from_state(manifest, arrays, meta, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not torch.equal(back._packed, eng._packed):
        fail("ports engine: from_state(state_dict()) words differ")
    again, meta2 = back.state_dict()
    if meta2 != meta or any(np.asarray(v).tobytes() != np.asarray(again[k]).tobytes()
                            for k, v in arrays.items()):
        fail("ports engine: from_state(state_dict()) changes the state")
    i = int(eng.active_indices()[77])
    for e in (eng, back):
        e.update_pod_labels(i, {"after": "resume"})
    if not torch.equal(back._packed, eng._packed):
        fail("ports engine: one diff after the resume differs between the engines")
    if launch_counts() != (0, 0):
        fail(f"ports engine: the round trip launched a hand-written kernel: {launch_counts()}")
    host_gib = sum(np.asarray(v).nbytes for v in arrays.values()) / 2**30
    log(f"ports engine: state_dict {save_s:.2f} s ({host_gib:.2f} GiB on the host), "
        f"from_state {load_s:.2f} s (" + ", ".join(
            f"{k} {v:.2f} s" for k, v in back.build_timings.items())
        + "); the resumed words and state == the saved ones, and one more relabel "
        "keeps both engines equal")
    del back, again, arrays
    torch.cuda.synchronize()
    log(f"ports engine: {time.perf_counter() - t_phase:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    return launches[1]


def ports_engine_card_vs_cpu_phase(dev) -> None:
    """Phase 17: the ports engine on the card against the ports engine on
    the CPU, at phase 8's size with port bitmaps, ``state_dict`` equal after
    the build and after every op of a stream that grows the pod axis."""
    import dataclasses

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt

    cluster = kvt.random_cluster(kvt.GeneratorConfig(**VERIFY))
    donor = kvt.random_cluster(kvt.GeneratorConfig(**{**VERIFY, "seed": 2}))
    pols = list(cluster.policies)
    rng = np.random.default_rng(17)
    ops = [("add_policy", dataclasses.replace(p, name=f"cv-{i}"))
           for i, p in enumerate(donor.policies[:6])]
    ops += [("update_policy", dataclasses.replace(pols[i], ingress=pols[i + 1].ingress))
            for i in (3, 30, 60)]
    ops += [("remove_policy", pols[i].namespace, pols[i].name) for i in (10, 90, 150)]
    ops += [("update_pod_labels", int(i), dict(cluster.pods[int(i) + 1].labels))
            for i in rng.choice(1_999, 4, replace=False)]
    ops += [("update_pod_labels", int(i), {"cv": "unseen"})
            for i in rng.choice(2_000, 4, replace=False)]
    ops += [("remove_pod", cluster.pods[int(i)].namespace, cluster.pods[int(i)].name)
            for i in rng.choice(2_000, 6, replace=False)]
    ops += [("add_namespace", kvt.Namespace("cv-ns", {"team": "cv"}))]
    ops += [("add_pod", kvt.Pod(f"cv-pod-{k}", "cv-ns" if k % 3 else "ns1",
                                dict(cluster.pods[k].labels),
                                container_ports=dict(cluster.pods[k].container_ports)))
            for k in range(60)]
    ops += [("update_namespace_labels", "ns2", dict(cluster.namespaces[4].labels)),
            ("update_namespace_labels", "cv-ns", {"team": "other"})]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    engines = {d: kvt.PackedPortsIncrementalVerifier(cluster, device=d)
               for d in ("cuda", "cpu")}
    if launch_counts() != (0, 1):
        fail(f"ports engine card vs cpu: the card's build launched {launch_counts()}, not (0, 1)")
    Np0 = engines["cuda"]._n_padded
    refused = 0
    for op, *args in [("build",)] + ops:
        if op != "build":
            outcomes = []
            for e in engines.values():
                try:
                    getattr(e, op)(*args)
                    outcomes.append("applied")
                except kvt.PortUniverseChanged:
                    outcomes.append("refused")
            if outcomes[0] != outcomes[1]:
                fail(f"ports engine card vs cpu: {op} {outcomes} on (cuda, cpu)")
            refused += outcomes[0] == "refused"
        (want, wmeta), (got, gmeta) = engines["cpu"].state_dict(), engines["cuda"].state_dict()
        if wmeta != gmeta:
            fail(f"ports engine card vs cpu: meta differs after {op}")
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            if w.dtype != g.dtype or w.shape != g.shape or w.tobytes() != g.tobytes():
                fail(f"ports engine card vs cpu: {k} differs after {op}")
    eng = engines["cuda"]
    if eng._n_padded <= Np0:
        fail("ports engine card vs cpu: the pod axis did not grow")
    if launch_counts() != (0, 1):
        fail(f"ports engine card vs cpu: the stream launched a hand-written kernel: "
             f"{launch_counts()}")
    torch.cuda.synchronize()
    log(f"ports engine card vs cpu: {len(ops)} ops ({refused} refused by both as "
        f"outside the frozen universe), state_dict cuda == cpu after the build and "
        f"after each op (Np {Np0} -> {eng._n_padded}, R {eng._layout.n_masks}); "
        f"{time.perf_counter() - t0:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def posture_phase(eng, dev, smi: str) -> None:
    """Phase 20: the posture ops on phase 14's engine at the flagship: its
    words before and after one policy op and one pod relabel, diffed on the
    card and on the host. The planes are held whole; the row counts, the
    namespace-pair counts and the top 8 rows exactly, from the host's
    nonzero words; the gauge (``packed_row_popcount``) on 1,024 sampled
    rows. Each op's time (CUDA events) beside its byte bound."""
    import numpy as np

    from kubernetes_verification_tpu_torch.ops import posture
    from kubernetes_verification_tpu_torch.ops.bits import to_host_words, unpack_cols

    with Phase("posture"):
        import kubernetes_verification_tpu_torch as kvt

        rng = np.random.default_rng(20)
        prev = eng._packed.clone()
        # the policy op: deny all ingress into the namespace with the fewest
        # live pods (phase 14's new one at the flagship), so the diff is
        # sure to narrow and stays small enough to check on the host
        live = [eng.pods[k].namespace for k in eng.active_indices()]
        small = min(set(live), key=lambda name: (live.count(name), name))
        eng.add_policy(kvt.NetworkPolicy(
            "posture-deny", namespace=small, pod_selector=kvt.Selector(), ingress=(),
            policy_types=("Ingress",)))
        i = int(rng.choice(eng.active_indices()))
        eng.update_pod_labels(i, {"posture": "moved", "app": "alpha"})
        cur = eng._packed
        R, W = cur.shape
        names = [ns.name for ns in eng.namespaces]
        G = len(names)
        index = {name: g for g, name in enumerate(names)}
        col_ns = np.array([index[p.namespace] if eng.pod_active[k] else -1
                           for k, p in enumerate(eng.pods)])
        row_ns = np.full(R, G, dtype=np.int32)
        row_ns[: eng.n_pods] = np.where(col_ns >= 0, col_ns, G)
        masks = posture.ns_word_masks(col_ns, G, W)
        masks_dev = torch.as_tensor(masks.view(np.int32), device=dev)
        row_ns_dev = torch.as_tensor(row_ns, device=dev)
        out = {}

        def xor():
            out["xor"] = posture.packed_xor_popcount(prev, cur)

        plane = R * W * 4
        timed = {"packed_xor_popcount": (cuda_ms(xor, reps=3), 4 * plane + 2 * R * 4)}
        wid, nar, rw, rn = out["xor"]
        delta = wid | nar
        timed["packed_row_popcount"] = (
            cuda_ms(lambda: out.__setitem__("rows", posture.packed_row_popcount(cur)), reps=3),
            plane + R * 4)
        timed["ns_pair_counts"] = (
            cuda_ms(lambda: out.__setitem__("ns", posture.ns_pair_counts(
                delta, masks_dev, row_ns_dev, G))),
            plane + G * W * 4 + R * 4 + G * G * 4)
        changed = rw + rn
        timed["topk_changed_rows(k=8)"] = (
            cuda_ms(lambda: out.__setitem__("top", posture.topk_changed_rows(changed, 8)),
                    reps=3),
            R * 4 + 8 * 8)
        for name, (ms, nbytes) in timed.items():
            log(f"posture: {name} {ms:.3f} ms, byte bound {1e3 * nbytes / H100_BYTES_PER_S:.3f} "
                f"ms ({nbytes / 1e9:.2f} GB; {smi})")
        log(f"posture: ns_pair_counts reads the plane once per namespace: {G} passes, "
            f"{1e3 * G * plane / H100_BYTES_PER_S:.2f} ms at the memory rate")

        # the host's diff of the same words
        hp, hc = to_host_words(prev), to_host_words(cur)
        host_w, host_n = hc & ~hp, hp & ~hc
        if not (np.array_equal(to_host_words(wid), host_w)
                and np.array_equal(to_host_words(nar), host_n)):
            fail("posture: a packed_xor_popcount plane differs from the host's")
        counts = {}
        pairs = np.zeros((G, G), dtype=np.int64)
        for name, h in (("widened", host_w), ("narrowed", host_n)):
            r, w = np.nonzero(h)
            bits = np.unpackbits(h[r, w].view(np.uint8).reshape(-1, 4), axis=1,
                                 bitorder="little").astype(bool)
            counts[name] = np.bincount(r, weights=bits.sum(1), minlength=R).astype(np.int64)
            rr, bb = np.nonzero(bits)
            rows, cols = r[rr], w[rr] * 32 + bb
            keep = (row_ns[rows] < G) & (cols < len(col_ns))
            keep[keep] &= col_ns[cols[keep]] >= 0
            np.add.at(pairs, (row_ns[rows[keep]], col_ns[cols[keep]]), 1)
        if not (np.array_equal(rw.cpu().numpy(), counts["widened"])
                and np.array_equal(rn.cpu().numpy(), counts["narrowed"])):
            fail("posture: the planes' row popcounts differ from the host's")
        if counts["widened"].sum() + counts["narrowed"].sum() == 0:
            fail("posture: the policy op and the relabel changed no pair")
        if not np.array_equal(out["ns"].cpu().numpy(), pairs):
            fail("posture: ns_pair_counts differs from the host's count")
        host_changed = counts["widened"] + counts["narrowed"]
        order = np.argsort(-host_changed, kind="stable")[:8]
        top_v, top_i = (t.cpu().numpy() for t in out["top"])
        if not (np.array_equal(top_i, order) and np.array_equal(top_v, host_changed[order])):
            fail("posture: topk_changed_rows differs from the host's stable order")
        sample = np.sort(rng.choice(eng.n_pods, 1024, replace=False))
        want = unpack_cols(hc[sample], R).sum(1)
        if not np.array_equal(out["rows"].cpu().numpy()[sample], want):
            fail("posture: packed_row_popcount differs from the host on sampled rows")
        log(f"posture: diff of words [{R}, {W}] ({R * W * 4 / 2**30:.2f} GiB) over "
            f"add_policy (deny ingress into {small}, {live.count(small)} live pods) + "
            f"update_pod_labels: {int(counts['widened'].sum())} pairs widened, "
            f"{int(counts['narrowed'].sum())} narrowed in {int((host_changed > 0).sum())} rows, "
            f"{G} namespaces; planes == host (whole), row counts, ns_pair_counts and "
            f"top-8 rows == host (exact, from the nonzero words), packed_row_popcount == host "
            f"on 1,024 sampled rows")
        del prev, out, wid, nar, delta


def _dense_stream(eng, cluster, donor, rng, lat: dict) -> None:
    """Phase 18's diff stream: 8 policy adds (from ``donor``), 8 updates, 8
    removes, 8 pod relabels (half to label sets other pods carry, half to
    pairs the frozen vocabulary never saw), one namespace relabel, and a
    namespace added then removed."""
    import dataclasses

    import kubernetes_verification_tpu_torch as kvt

    pols = list(cluster.policies)
    picks = rng.choice(len(pols), 16, replace=False)
    for i, p in enumerate(donor.policies[:8]):
        _timed(lat, "add_policy", lambda: eng.add_policy(
            dataclasses.replace(p, name=f"dense-add-{i}")))
    for j in picks[:8]:
        src = pols[(j + 1) % len(pols)]
        _timed(lat, "update_policy", lambda: eng.update_policy(dataclasses.replace(
            pols[j], ingress=src.ingress, egress=src.egress,
            policy_types=src.policy_types)))
    for j in picks[8:]:
        _timed(lat, "remove_policy", lambda: eng.remove_policy(
            pols[j].namespace, pols[j].name))
    n = len(eng.pods)
    for k, i in enumerate(rng.choice(n, 8, replace=False)):
        labels = (dict(eng.pods[int(rng.integers(n))].labels) if k < 4
                  else {"smoke": f"unseen-{k}", "app": "alpha"})
        _timed(lat, "update_pod_labels", lambda: eng.update_pod_labels(int(i), labels))
    _timed(lat, "update_namespace_labels", lambda: eng.update_namespace_labels(
        cluster.namespaces[3].name, dict(cluster.namespaces[7].labels)))
    _timed(lat, "add_namespace", lambda: eng.add_namespace(
        kvt.Namespace("dense-ns", dict(cluster.namespaces[5].labels))))
    _timed(lat, "remove_namespace", lambda: eng.remove_namespace("dense-ns"))


def _dense_refusals(eng) -> int:
    """One refused op of each kind; the counts, isolation counts, vectors
    and ``update_count`` must not move. Returns the refusals."""
    import dataclasses

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt

    held = next(iter(eng.policies.values()))
    counts = (eng._ing_count.clone(), eng._eg_count.clone())
    iso = (eng._ing_iso.copy(), eng._eg_iso.copy())
    keys, updates = list(eng._vectors), eng.update_count
    cases = [
        ("add_policy", (held,), KeyError),
        ("update_policy", (dataclasses.replace(held, name="dense-absent"),), KeyError),
        ("remove_policy", (held.namespace, "dense-absent"), KeyError),
        ("update_pod_labels", (len(eng.pods) + 1, {}), IndexError),
        ("update_namespace_labels", ("dense-absent-ns", {}), KeyError),
        ("remove_namespace", (held.namespace,), ValueError),
    ]
    for op, args, kind in cases:
        try:
            getattr(eng, op)(*args)
            fail(f"dense engine: {op} was not refused")
        except kind:
            pass
    ns = eng.namespaces[0]
    if eng.add_namespace(kvt.Namespace(ns.name, dict(ns.labels))) is not False:
        fail("dense engine: add_namespace of a known namespace was not a no-op")
    if not (torch.equal(counts[0], eng._ing_count) and torch.equal(counts[1], eng._eg_count)
            and np.array_equal(iso[0], eng._ing_iso) and np.array_equal(iso[1], eng._eg_iso)
            and keys == list(eng._vectors) and updates == eng.update_count):
        fail("dense engine: a refused op changed the state")
    return len(cases) + 1


def _dense_one_shot(cluster, dev):
    """bool [n, n] host reach of a one-shot any-port ``tiled_k8s_reach`` of
    ``cluster`` (2 ``packed_dir_allow`` launches), and its seconds."""
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.bits import to_host_words, unpack_cols

    t0 = time.perf_counter()
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    res = kvt.tiled_k8s_reach(enc, fetch=False, device=dev)
    return unpack_cols(to_host_words(res.packed), enc.n_pods), time.perf_counter() - t0


def dense_engine_phase(dev, smi: str) -> int:
    """Phase 18: the dense engine at the JAX bench's dense ceiling. Returns
    the ``packed_dir_allow`` launches of its two one-shot checks."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.incremental import _derive_reach
    from kubernetes_verification_tpu_torch.ops import batched
    from kubernetes_verification_tpu_torch.ops.bits import to_host_words
    from kubernetes_verification_tpu_torch.ops.device_state import dense_query_state

    t_phase = time.perf_counter()
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**DENSE))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    eng = kvt.IncrementalVerifier(cluster, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n, P = len(eng.pods), len(eng.policies)
    log(f"dense: build {build_s:.2f} s (" + ", ".join(
        f"{k} {v:.3f} s" for k, v in eng.build_timings.items())
        + f"), {n} pods, {P} policies, counts 2 x {n * n * 4 / 1e9:.2f} GB, launches "
        f"{launch_counts()}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    if launch_counts() != (0, 0):
        fail(f"dense: the build launched a hand-written kernel: {launch_counts()}")

    # the contraction alone, re-run from the engine's own vectors: the same
    # counts, and its time beside the bound
    vec = [torch.as_tensor(np.stack([v[k] for v in eng._vectors.values()]), device=dev)
           .to(torch.int8) for k in range(4)]
    sel_ing, sel_eg, ing_peers, eg_peers = vec
    got = {}
    ms = cuda_ms(lambda: got.update(zip(("ing", "eg"), eng._contract_counts(
        sel_ing, sel_eg, ing_peers, eg_peers))))
    if not (torch.equal(got["ing"], eng._ing_count) and torch.equal(got["eg"], eng._eg_count)):
        fail("dense: the counts re-contracted from the vectors differ from the build's")
    ops = 2 * 2 * n * n * P
    nbytes = 4 * P * n + 2 * n * n * 4
    log(f"dense: contraction (2 bool_dot [{n} x {P}] . [{n} x {P}]^T with their "
        f"K-contiguous copies) {ms:.2f} ms, {ops / ms / 1e9:.1f} TOP/s, bound "
        f"{1e3 * max(ops / H100_INT8_OPS, nbytes / H100_BYTES_PER_S):.2f} ms "
        f"(operations); == the build's counts; {smi}")
    del vec, sel_ing, sel_eg, ing_peers, eg_peers, got

    t0 = time.perf_counter()
    reach = eng.reach
    derive_s = time.perf_counter() - t0
    ing_iso, eg_iso = eng._iso_tensors()
    flags = dict(self_traffic=True, default_allow_unselected=True)
    ms = cuda_ms(lambda: _derive_reach(eng._ing_count, eng._eg_count, ing_iso, eg_iso,
                                       **flags), reps=3)
    nbytes = 2 * n * n * 4 + n * n + 2 * n * 4
    log(f"dense: reach {derive_s * 1e3:.1f} ms with its {n * n / 1e9:.2f} GB D2H copy; "
        f"derivation on the card {ms:.2f} ms, byte bound "
        f"{1e3 * nbytes / H100_BYTES_PER_S:.2f} ms ({smi})")
    reset_counts()
    one, one_s = _dense_one_shot(cluster, dev)
    launches = launch_counts()[0]
    if launch_counts() != (2, 0):
        fail(f"dense: the one-shot solve launched {launch_counts()}, not (2, 0)")
    if not np.array_equal(reach, one):
        fail("dense: the build's reach differs from tiled_k8s_reach's unpacked words")
    log(f"dense: build reach == the unpacked words of tiled_k8s_reach ({one_s:.2f} s, "
        f"{int(reach.sum())} pairs)")
    del one

    rng = np.random.default_rng(18)
    donor = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=2_000, n_policies=64, n_namespaces=20, p_ipblock_peer=0.0,
        min_selector_labels=1, seed=3))
    lat: dict = {}
    reset_counts()
    _dense_stream(eng, cluster, donor, rng, lat)
    refused = _dense_refusals(eng)
    if launch_counts() != (0, 0):
        fail(f"dense: the stream launched a hand-written kernel: {launch_counts()}")
    for kind, ts in lat.items():
        log(f"dense: {kind} x{len(ts)}: median {statistics.median(ts) * 1e3:.2f} ms, "
            f"max {max(ts) * 1e3:.2f} ms (host clock after a device sync)")
    log(f"dense: {refused} refused ops (one of each kind) left the state unchanged; "
        f"a rank-1 update over the whole matrix would read and write "
        f"{n * n * 4 * 2 / 1e9:.1f} GB ({1e3 * n * n * 8 / H100_BYTES_PER_S:.2f} ms at the "
        f"memory rate, x2 per policy op)")
    t0 = time.perf_counter()
    reach = eng.reach
    derive_s = time.perf_counter() - t0
    reset_counts()
    one, one_s = _dense_one_shot(eng.as_cluster(), dev)
    launches += launch_counts()[0]
    if not np.array_equal(reach, one):
        fail("dense: reach after the stream differs from a one-shot solve of as_cluster()")
    log(f"dense: after the stream reach ({derive_s * 1e3:.1f} ms with D2H) == a one-shot "
        f"tiled_k8s_reach of as_cluster() ({one_s:.2f} s), {int(reach.sum())} pairs")
    del one

    # the query twins against reach, dense and in 8 stripes of 4,096 rows
    t0 = time.perf_counter()
    state = dense_query_state(eng, 1, with_reach_words=True)
    torch.cuda.synchronize()
    state_s = time.perf_counter() - t0
    a = state.arrays
    words = to_host_words(a["reach_words"])
    host = np.packbits(reach, axis=1, bitorder="little")
    if words.tobytes() != host.tobytes():
        fail("dense: dense_query_state's reach words differ from a host pack of reach")
    ops4 = (a["ing_count"], a["eg_count"], a["ing_iso"], a["eg_iso"])
    src = np.sort(rng.choice(n, 1024, replace=False))
    dst = np.sort(rng.choice(n, 1024, replace=False))
    q_row = rng.integers(0, len(src), 4096)
    q_dst = rng.integers(0, n, 4096)
    q = {}
    for name, fn in (
        ("rows", lambda: batched.batched_reach_rows(*ops4, src, **flags)),
        ("cols", lambda: batched.batched_reach_cols(*ops4, dst, **flags)),
        ("probe", lambda: batched.batched_any_port(*ops4, src, q_row, q_dst, **flags)),
    ):
        t0 = time.perf_counter()
        q[name] = fn()
        q[name + "_s"] = time.perf_counter() - t0
    if not (np.array_equal(q["rows"], reach[src]) and np.array_equal(q["cols"], reach[:, dst])
            and np.array_equal(q["probe"][0], reach[src])
            and np.array_equal(q["probe"][1], reach[src[q_row], q_dst])):
        fail("dense: a batched query twin differs from reach")
    S = n // DENSE_STRIPES
    rows, frags, ans = [], [], np.zeros(len(q_row), dtype=bool)
    t0 = time.perf_counter()
    for k in range(DENSE_STRIPES):
        lo, hi = k * S, (k + 1) * S
        stripe = (a["ing_count"][lo:hi], a["eg_count"][lo:hi], a["ing_iso"], a["eg_iso"][lo:hi])
        kw = dict(row_base=lo, **flags)
        loc = src[(src >= lo) & (src < hi)] - lo
        rows.append(batched.stripe_reach_rows(*stripe, loc, **kw))
        frags.append(batched.stripe_reach_cols(*stripe, dst, **kw))
        sel = (src[q_row] >= lo) & (src[q_row] < hi)
        _, got_ans = batched.stripe_any_port(
            *stripe, loc, np.searchsorted(loc, src[q_row[sel]] - lo), q_dst[sel], **kw)
        ans[sel] = got_ans
    stripes_s = time.perf_counter() - t0
    if not (np.array_equal(np.concatenate(rows), q["rows"])
            and np.array_equal(np.concatenate(frags), q["cols"])
            and np.array_equal(ans, q["probe"][1])):
        fail("dense: the stripe twins, concatenated, differ from the batched ones")
    log(f"dense: dense_query_state(with_reach_words) {state_s * 1e3:.1f} ms, words == a host "
        f"pack of reach; batched_reach_rows(1,024) {q['rows_s'] * 1e3:.1f} ms, "
        f"batched_reach_cols(1,024) {q['cols_s'] * 1e3:.1f} ms, batched_any_port(4,096 "
        f"probes) {q['probe_s'] * 1e3:.1f} ms (host clock, D2H included) == reach; "
        f"{DENSE_STRIPES} stripes of {S}: rows, column fragments and probes, concatenated, "
        f"== the batched twins ({stripes_s * 1e3:.1f} ms)")
    del state, a, ops4, reach, host, words
    log(f"dense: {time.perf_counter() - t_phase:.2f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    return launches


def dense_card_vs_cpu_phase(dev) -> None:
    """Phase 19: the dense engine on the card against the dense engine on
    the CPU at phase 8's size: the count matrices and the isolation counts
    byte-equal after the build and after every op, refused ops included."""
    import dataclasses

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt

    cluster = kvt.random_cluster(kvt.GeneratorConfig(**VERIFY))
    donor = kvt.random_cluster(kvt.GeneratorConfig(**{**VERIFY, "seed": 2}))
    pols = list(cluster.policies)
    rng = np.random.default_rng(19)
    ops = [("add_policy", dataclasses.replace(p, name=f"cv-{i}"))
           for i, p in enumerate(donor.policies[:6])]
    ops += [("add_policy", pols[0])]  # refused: exists
    ops += [("update_policy", dataclasses.replace(pols[i], ingress=pols[i + 1].ingress))
            for i in (3, 30, 60)]
    ops += [("remove_policy", pols[i].namespace, pols[i].name) for i in (10, 90, 150)]
    ops += [("remove_policy", pols[10].namespace, pols[10].name)]  # refused: gone
    ops += [("update_pod_labels", int(i), dict(cluster.pods[int(i) + 1].labels))
            for i in rng.choice(1_999, 4, replace=False)]
    ops += [("update_pod_labels", int(i), {"cv": "unseen"})
            for i in rng.choice(2_000, 4, replace=False)]
    ops += [("update_pod_labels", 2_000, {})]  # refused: no such pod
    ops += [("add_namespace", kvt.Namespace("cv-ns", {"team": "cv"})),
            ("update_namespace_labels", "ns2", dict(cluster.namespaces[4].labels)),
            ("update_namespace_labels", "cv-ns", {"team": "other"}),
            ("remove_namespace", "cv-ns"),
            ("remove_namespace", "ns3")]  # refused: holds policies and pods
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    engines = {d: kvt.IncrementalVerifier(cluster, device=d) for d in (dev, "cpu")}
    refused = 0
    for op, *args in [("build",)] + ops:
        if op != "build":
            outcomes = []
            for e in engines.values():
                try:
                    getattr(e, op)(*args)
                    outcomes.append("applied")
                except (KeyError, ValueError, IndexError) as err:
                    outcomes.append(type(err).__name__)
            if outcomes[0] != outcomes[1]:
                fail(f"dense card vs cpu: {op} {outcomes} on (cuda, cpu)")
            refused += outcomes[0] != "applied"
        g, w = engines[dev], engines["cpu"]
        for a, b, name in ((g._ing_count.cpu().numpy(), w._ing_count.numpy(), "ing_count"),
                           (g._eg_count.cpu().numpy(), w._eg_count.numpy(), "eg_count"),
                           (g._ing_iso, w._ing_iso, "ing_iso"), (g._eg_iso, w._eg_iso, "eg_iso")):
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                fail(f"dense card vs cpu: {name} differs after {op}")
        if g.update_count != w.update_count or list(g._vectors) != list(w._vectors):
            fail(f"dense card vs cpu: the bookkeeping differs after {op}")
    if not np.array_equal(engines[dev].reach, engines["cpu"].reach):
        fail("dense card vs cpu: reach differs")
    if launch_counts() != (0, 0):
        fail(f"dense card vs cpu: a hand-written kernel ran: {launch_counts()}")
    log(f"dense card vs cpu: {len(ops)} ops ({refused} refused by both), counts and "
        f"isolation counts byte-equal cuda == cpu after the build and after each op, "
        f"reach equal; {time.perf_counter() - t0:.2f} s")


def cpu_oracle_phase(dev) -> None:
    """Phase 21: the CPU oracle (``backend="cpu"``, host NumPy) on the card's
    host against ``backend="torch"`` on the card, and the paper fixtures'
    documented answers on both."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.models.fixtures import (
        kano_paper_example,
        kubesv_paper_example,
    )

    fields = ("reach", "reach_ports", "src_sets", "dst_sets", "selected",
              "ingress_isolated", "egress_isolated")
    card = (("device", str(dev)),)
    for gen, compute_ports in ((VERIFY, False), (ORACLE_PORTS, True)):
        cluster = kvt.random_cluster(kvt.GeneratorConfig(**gen))
        t0 = time.perf_counter()
        oracle = kvt.verify(cluster, kvt.VerifyConfig(backend="cpu", compute_ports=compute_ports))
        oracle_s = time.perf_counter() - t0
        with Phase(f"oracle: verify(backend='torch', compute_ports={compute_ports}) on the card"):
            solve = kvt.verify(cluster, kvt.VerifyConfig(
                compute_ports=compute_ports, backend_options=card))
        for f in fields:
            g, w = getattr(oracle, f), getattr(solve, f)
            if (g is None) != (w is None) or (g is not None and not np.array_equal(g, w)):
                fail(f"oracle: {f} of the cpu backend differs from the card's "
                     f"(compute_ports={compute_ports})")
        log(f"oracle: verify(backend='cpu') on the host ({gen['n_pods']} pods, "
            f"{gen['n_policies']} policies, compute_ports={compute_ports}, "
            f"{len(oracle.port_atoms)} atoms) {oracle_s:.2f} s == verify(backend='torch') "
            f"on the card on every field, {int(oracle.reach.sum())} pairs")
    expected = np.zeros((5, 5), dtype=bool)
    expected[[0, 3], 1] = True
    expected[4, 2] = True
    expected[2, [0, 3]] = True
    expected[np.ix_([0, 1, 2], [0, 3])] = True
    for backend, opts in (("cpu", ()), ("torch", card)):
        containers, policies = kano_paper_example()
        res = kvt.verify_kano(containers, policies, kvt.VerifyConfig(
            backend=backend, backend_options=opts))
        if not (np.array_equal(res.reach, expected) and res.all_reachable() == []
                and res.all_isolated() == [4]
                and res.user_crosscheck(containers, "app") == [1, 2, 3]
                and res.policy_shadow() == [(2, 3), (3, 2)]
                and containers[2].select_policies == [2, 3]):
            fail(f"oracle: kano_paper_example's documented answers differ ({backend})")
        cluster = kubesv_paper_example()
        pods = cluster.pods
        role = {r: [i for i, p in enumerate(pods)
                    if p.labels["role"] == r and p.namespace == "default"]
                for r in ("db", "tomcat", "nginx")}
        strict = kvt.verify(cluster, kvt.VerifyConfig(
            backend=backend, default_allow_unselected=False, backend_options=opts))
        real = kvt.verify(cluster, kvt.VerifyConfig(backend=backend, backend_options=opts))
        if not (strict.ingress_isolated[role["db"]].all()
                and not strict.reach[np.ix_(role["tomcat"], role["db"])].any()
                and real.reach[np.ix_(role["tomcat"], role["db"])].all()
                and not real.reach[np.ix_(role["nginx"], role["db"])].any()):
            fail(f"oracle: kubesv_paper_example's documented answers differ ({backend})")
    log("oracle: kano_paper_example (reach, all_reachable [], all_isolated [4], "
        "user_crosscheck [1, 2, 3], policy_shadow [(2, 3), (3, 2)]) and "
        "kubesv_paper_example (db isolated; tomcat -> db only under default-allow; "
        "nginx -> db never) as documented, on the cpu backend and on the card")


# ---------------------------------------------------------------------------
# phases 22-24: the serving plane
# ---------------------------------------------------------------------------

#: events per batch of the served streams of phases 22 and 23
SERVE_BATCH = 64
#: events appended after phase 22's checkpoint, replayed by its recovery
SERVE_TAIL = 64
#: phases 22-24's key numbers, repeated on one line near the end of the
#: output so that they stand in its last lines beside the kernel table
SERVE_SUMMARY: list = []


def fallbacks() -> float:
    """The port's ``kvtpu_fallbacks_total``, summed over its labels: every
    answer its serving plane took from the CPU fallback in this process."""
    from kubernetes_verification_tpu_torch.observe.metrics import FALLBACKS_TOTAL

    return sum(c.value for c in FALLBACKS_TOTAL.children().values())


def no_fallback(svc, tag: str) -> None:
    """Every answer came from the card: ``kvtpu_fallbacks_total`` reads 0,
    no ``"fallback"`` solve was counted, the serving breaker is closed."""
    if fallbacks() != 0 or "fallback" in svc.stats.solves:
        fail(f"{tag}: an answer came from the CPU fallback (kvtpu_fallbacks_total "
             f"{fallbacks()}, solves {svc.stats.solves})")
    if svc._breaker is not None and svc._breaker.state != "closed":
        fail(f"{tag}: the serving breaker is {svc._breaker.state}")


def cut_populated_relabels(events, cluster) -> tuple:
    """``events`` without the relabels of namespaces that hold pods (each
    re-evaluates every pod of the namespace on the host, ~265 s at the
    flagship); returns ``(kept, number cut)``. The stream's other events
    stay valid: a namespace's labels name no pod or policy."""
    from kubernetes_verification_tpu_torch.serve import UpdateNamespaceLabels

    populated = {p.namespace for p in cluster.pods}
    kept = [e for e in events
            if not (isinstance(e, UpdateNamespaceLabels) and e.namespace in populated)]
    return kept, len(events) - len(kept)


def serve_assertions(cluster, rng, k: int = 4) -> list:
    """``k`` allow/deny assertions over existing selectors: the namespace
    and two labels of a sampled pod (tens of pods at the flagship) to every
    pod of one namespace."""
    from kubernetes_verification_tpu_torch.serve import Assertion, PodSelector

    names = [ns.name for ns in cluster.namespaces]
    out = []
    for j, i in enumerate(rng.choice(len(cluster.pods), k, replace=False)):
        p = cluster.pods[int(i)]
        labels = tuple(sorted(p.labels.items()))[:2]
        out.append(Assertion(f"smoke-{j}", "deny" if j % 2 else "allow",
                             PodSelector(namespace=p.namespace, labels=labels),
                             PodSelector(namespace=names[(7 * j + 3) % len(names)])))
    return out


def host_violations(assertions, reach, pods) -> list:
    """The assertions' verdicts on a host reach matrix, evaluated here from
    the model objects: ``(name, kind, pairs, witness src, witness dst)`` per
    violated assertion, the witness the first violating pair in row-major
    order, self pairs ignored."""
    import numpy as np

    def picks(sel):
        return np.array([i for i, p in enumerate(pods)
                         if (sel.namespace is None or p.namespace == sel.namespace)
                         and (sel.name is None or p.name == sel.name)
                         and all(p.labels.get(k) == v for k, v in sel.labels)], dtype=np.int64)

    out = []
    for a in assertions:
        src, dst = picks(a.src), picks(a.dst)
        if not (src.size and dst.size):
            continue
        sub = reach[np.ix_(src, dst)]
        bad = ~sub if a.kind == "allow" else sub.copy()
        if a.ignore_self:
            bad &= src[:, None] != dst[None, :]
        si, di = np.nonzero(bad)
        if si.size:
            ps, pd = pods[int(src[si[0]])], pods[int(dst[di[0]])]
            out.append((a.name, a.kind, int(si.size), f"{ps.namespace}/{ps.name}",
                        f"{pd.namespace}/{pd.name}"))
    return out


def violation_rows(violations) -> list:
    return [(v.assertion, v.kind, v.pairs, v.witness_src, v.witness_dst) for v in violations]


def query_mix(pods, batch: int, count: int = 4096) -> tuple:
    """``bench.py --mode query``'s probe mix over ``pods``: 95 % any-port
    probes whose sources follow an 80/20 hot-set skew (512 hot sources),
    5 % port-refined probes on 16 hot (src, dst) pairs x 3 ports. Returns
    ``(probes, src, dst, ported)``."""
    import numpy as np

    n = len(pods)
    rng = np.random.default_rng(7)
    hot = rng.integers(0, n, (16, 2))
    hot_ports = (80, 443, 5432)
    hot_src = rng.integers(0, n, min(512, n))
    rs = np.random.default_rng(1000 + batch)
    src = np.empty(count, np.int64)
    dst = np.empty(count, np.int64)
    ported = np.zeros(count, bool)
    probes = []
    ref = lambda i: f"{pods[i].namespace}/{pods[i].name}"
    for k in range(count):
        if rs.random() < 0.05:
            s, d = (int(x) for x in hot[int(rs.integers(len(hot)))])
            probes.append((ref(s), ref(d), int(rs.choice(hot_ports)), "TCP"))
            ported[k] = True
        else:
            s = int(hot_src[int(rs.integers(hot_src.size))]) if rs.random() < 0.8 \
                else int(rs.integers(n))
            d = int(rs.integers(n))
            probes.append((ref(s), ref(d)))
        src[k], dst[k] = s, d
    return probes, src, dst, ported


def host_diff_counts(prev, cur) -> tuple:
    """``(widened, narrowed, set)``: the bits set in ``cur`` and not in
    ``prev``, the converse, and the bits set in ``cur``, of two host uint32
    word planes, counted on the host 4,096 rows at a time by 8 threads
    (numpy's ufuncs release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    table = None if hasattr(np, "bitwise_count") else np.array(
        [bin(i).count("1") for i in range(256)], dtype=np.uint8)

    def count(x) -> int:
        return int((np.bitwise_count(x) if table is None
                    else table[x.view(np.uint8)]).sum(dtype=np.int64))

    def block(r0: int) -> tuple:
        p, c = prev[r0 : r0 + 4096], cur[r0 : r0 + 4096]
        x = p ^ c
        return count(x & c), count(x & p), count(c)

    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(block, range(0, cur.shape[0], 4096)))
    return tuple(sum(col) for col in zip(*parts))


def host_first_cells(mask, k: int) -> list:
    """The first ``k`` set ``(row, col)`` cells of a host bool matrix in
    row-major order, and their count: ``(cells, count)``."""
    import numpy as np

    cells = []
    for r in np.flatnonzero(mask.any(axis=1)):
        cells += [(int(r), int(c)) for c in np.flatnonzero(mask[r])[: k - len(cells)]]
        if len(cells) >= k:
            break
    return cells, int(np.count_nonzero(mask))


def device_profiler():
    """A ``torch.profiler`` session that records device activity only."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def device_busy_ms(prof):
    """Milliseconds of device activity (kernels and copies; one stream, so
    they do not overlap) a session recorded; None when it recorded none."""
    from torch.autograd import DeviceType

    try:
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
    except Exception as e:  # noqa: BLE001 — the profiler is untried on this card
        log(f"  device profiler: no events ({type(e).__name__}: {e})")
        return None
    return sum(spans) / 1e3 if spans else None


def idle_share(busy_ms, wall_s) -> str:
    if any(b is None for b in busy_ms):
        return "not measured (the profiler recorded no device activity)"
    busy = sum(busy_ms) / 1e3
    return f"{1 - busy / sum(wall_s):.3f} ({busy:.2f} s device-busy of {sum(wall_s):.2f} s)"


def serve_packed_phase(cluster, main_words, dev, smi: str) -> tuple:
    """Phase 22: the packed service on the flagship cluster. Its own checks
    (posture record against the host's diff, the query mix, rows and
    columns) run after the first and the last batch. Returns the build's
    ``packed_dir_allow`` launches and what phase 25 replicates: the
    checkpoint directory (kept), its WAL, the live service and the stream's
    unused events."""
    import os
    import tempfile

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.ops.bits import unpack_cols
    from kubernetes_verification_tpu_torch.packed_incremental import _host_words
    from kubernetes_verification_tpu_torch.serve import (
        CheckpointManager,
        QueryEngine,
        RecoveryManager,
        VerificationService,
        WalWriter,
    )

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    svc = VerificationService(
        engine=kvt.PackedIncrementalVerifier(cluster, device=dev, keep_matrix=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = launch_counts()
    eng = svc.engine
    n = eng.n_pods
    log(f"serve packed: build {build_s:.2f} s (" + ", ".join(
        f"{k} {v:.2f} s" for k, v in eng.build_timings.items())
        + f"), packed_dir_allow launches {launches[0]}, fused_ports_reach launches "
        f"{launches[1]}; {smi}")
    if launches != (2, 0):
        fail(f"serve packed: the build launched {launches}, not (2, 0)")
    w = -(-n // 32)
    if not torch.equal(eng._packed[:n, :w], main_words[:, :w]):
        fail("serve packed: the build's words differ from phase 4's")
    t0 = time.perf_counter()
    svc.enable_posture()
    torch.cuda.synchronize()
    posture_s = time.perf_counter() - t0
    rng = np.random.default_rng(22)
    svc.assertions = serve_assertions(cluster, rng)
    q = QueryEngine(svc)
    events = random_event_stream(cluster, n_events=256 + 2 * SERVE_TAIL, seed=1)
    stream, cut = cut_populated_relabels(events[:256], cluster)
    after = cut_populated_relabels(events[256:], cluster)[0]
    tail, more = after[:SERVE_TAIL], after[SERVE_TAIL:]
    refs = [f"{p.namespace}/{p.name}" for p in eng.pods]
    host_prev = _host_words(eng._packed)
    if svc.posture.records[-1].reachable_pairs != host_diff_counts(host_prev, host_prev)[2]:
        fail("serve packed: the posture baseline differs from the host's popcount")
    log(f"serve packed: enable_posture {posture_s:.2f} s (baseline "
        f"{svc.posture.records[-1].reachable_pairs} pairs); {len(svc.assertions)} "
        f"assertions; stream of {len(stream)} events ({cut} relabels of populated "
        f"namespaces cut from random_event_stream(n_events=256, seed=1))")

    tmp = tempfile.TemporaryDirectory(prefix="kvt-serve-")
    log_path = os.path.join(tmp.name, "events.jsonl")
    writer = WalWriter(log_path)
    apply_s, busy, q_s, rec_s, check_s, split_s = [], [], [], [], [], []
    n_batches = -(-len(stream) // SERVE_BATCH)
    checked = {0, n_batches - 1}
    prev_fresh = True
    svc.start()
    try:
        for b, i in enumerate(range(0, len(stream), SERVE_BATCH)):
            batch = stream[i : i + SERVE_BATCH]
            if b in checked and not prev_fresh:
                host_prev = _host_words(eng._packed)
            writer.append(batch)
            r0 = len(svc.posture.records)
            with device_profiler() as prof:
                t0 = time.perf_counter()
                svc.submit(batch)
                svc.flush()
                torch.cuda.synchronize()
                apply_s.append(time.perf_counter() - t0)
            busy.append(device_busy_ms(prof))
            recs = list(svc.posture.records)[r0:]
            rec = recs[-1]
            rec_s.append(sum(r.delta_s for r in recs))
            if b not in checked:
                prev_fresh = False
                log(f"serve packed: batch {b}: apply {apply_s[-1]:.2f} s in {len(recs)} "
                    f"worker batch(es) (device busy "
                    + ("not measured" if busy[-1] is None else f"{busy[-1]:.1f} ms")
                    + f", posture record {rec_s[-1] * 1e3:.1f} ms); checks skipped "
                    f"(they run after the first and the last batch)")
                continue
            t0 = time.perf_counter()
            host = _host_words(eng._packed)
            widened, narrowed, total = host_diff_counts(host_prev, host)
            if len(recs) == 1:  # the worker applied the submission as one batch
                got = (rec.seq, rec.widened, rec.narrowed, rec.reachable_pairs)
                want = (svc.generation, widened, narrowed, total)
            else:  # drained in parts: the records' movement telescopes
                got = (rec.seq, sum(r.widened - r.narrowed for r in recs), rec.reachable_pairs)
                want = (svc.generation, widened - narrowed, total)
            if got != want:
                fail(f"serve packed: batch {b} posture records {got} != the host's diff {want}")
            t_diff = time.perf_counter()
            probes, s_idx, d_idx, ported = query_mix(eng.pods, b)
            t1 = time.perf_counter()
            ans = q.can_reach_batch(probes)
            q_s.append(time.perf_counter() - t1)
            bits = ((host[s_idx, d_idx // 32] >> (d_idx % 32).astype(np.uint32)) & 1) > 0
            if not np.array_equal(ans[~ported], bits[~ported]):
                fail(f"serve packed: batch {b} any-port answers differ from the words")
            # 16 port-refined answers a batch (64 in the stream), and 16
            # any-port ones, against scalar can_reach
            picks = list(np.flatnonzero(ported)[:16]) + list(np.flatnonzero(~ported)[:16])
            if [q.can_reach(*probes[k]) for k in picks] != [bool(ans[k]) for k in picks]:
                fail(f"serve packed: batch {b} scalar can_reach differs from the batch")
            t_probes = time.perf_counter()
            for k in rng.choice(n, 16, replace=False):
                k = int(k)
                row = unpack_cols(host[k : k + 1], n)[0]
                col = ((host[:n, k // 32] >> np.uint32(k % 32)) & 1) > 0
                row[k] = col[k] = False
                if q.blast_radius(refs[k]) != [refs[j] for j in np.flatnonzero(row)]:
                    fail(f"serve packed: blast_radius({refs[k]}) differs from its word row")
                if q.who_can_reach(refs[k]) != [refs[j] for j in np.flatnonzero(col)]:
                    fail(f"serve packed: who_can_reach({refs[k]}) differs from its column")
            check_s.append(time.perf_counter() - t0)
            split_s.append((t_diff - t0, t_probes - t_diff - q_s[-1],
                            t0 + check_s[-1] - t_probes))
            log(f"serve packed: batch {b}: apply {apply_s[-1]:.2f} s in {len(recs)} "
                f"worker batch(es) (device busy "
                + ("not measured" if busy[-1] is None else f"{busy[-1]:.1f} ms")
                + f", posture record {rec_s[-1] * 1e3:.1f} ms: "
                f"+{sum(r.widened for r in recs)} -{sum(r.narrowed for r in recs)} of "
                f"{rec.reachable_pairs} pairs), checks {check_s[-1]:.2f} s (host words and "
                f"diff {split_s[-1][0]:.2f} s, probe mix, answer checks and scalar can_reach "
                f"{split_s[-1][1]:.2f} s, "
                f"16 rows and columns {split_s[-1][2]:.2f} s), can_reach_batch "
                f"4,096 probes ({int(ported.sum())} ported) {q_s[-1] * 1e3:.1f} ms; the "
                f"record, the any-port answers and 16 rows and columns == the words, "
                f"16 ported and 16 any-port answers == scalar can_reach")
            host_prev, prev_fresh = host, True
    finally:
        svc.close()
    del host_prev, host
    st = svc.stats
    n_ev = st.events_seen
    split = ("device not measured" if None in busy else
             "host " + ", ".join(f"{a - d / 1e3:.2f}" for a, d in zip(apply_s, busy))
             + " s, device " + ", ".join(f"{d / 1e3:.3f}" for d in busy) + " s")
    log(f"serve packed: {n_ev} events in {st.batches} batches ({st.events_applied} applied, "
        f"{st.events_coalesced} coalesced), {sum(apply_s):.2f} s of apply = "
        f"{n_ev / sum(apply_s):.1f} events/s; apply per batch "
        + ", ".join(f"{a:.2f}" for a in apply_s) + f" s ({split}); "
        f"solves {st.solves} ({n_ev / max(st.total_solves, 1):.1f} events per solve), "
        f"query batch median {statistics.median(q_s) * 1e3:.1f} ms, posture record median "
        f"{statistics.median(rec_s) * 1e3:.1f} ms; device idle share of the stream "
        f"{idle_share(busy, apply_s)}; {smi}")
    no_fallback(svc, "serve packed")

    reset_counts()
    live_vs_one_shot(eng, dev, "serve packed")
    cm = CheckpointManager(os.path.join(tmp.name, "ck"))
    t0 = time.perf_counter()
    info = cm.checkpoint(eng, log_path=log_path, log_offset=writer.offset,
                         last_seq=writer.next_seq - 1)
    ck_s = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(info.snapshot_dir) for f in fs)
    writer.append(tail)
    writer.close()
    svc.apply(tail)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = RecoveryManager(os.path.join(tmp.name, "ck")).recover(log_path=log_path, device=dev)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t0
    if (res.outcome, res.replayed, res.duplicates_skipped) != ("newest", len(tail), 0):
        fail(f"serve packed: recovery {res.outcome}, replayed {res.replayed}, "
             f"{res.duplicates_skipped} duplicates")
    if not (torch.equal(res.service.engine._packed, eng._packed)
            and np.array_equal(res.service.engine.pod_active, eng.pod_active)):
        fail("serve packed: the recovered words differ from the live service's")
    no_fallback(res.service, "serve packed recovery")
    log(f"serve packed: checkpoint {ck_s:.2f} s ({size / 2**30:.2f} GiB on disk), "
        f"{len(tail)} more events, recover {recover_s:.2f} s (outcome newest, "
        f"{res.replayed} replayed, 0 duplicates): words == the live service's; "
        f"the one-shot check launched packed_dir_allow {launch_counts()[0]} times")
    del res
    phase_s = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve packed: {phase_s:.2f} s, peak device memory {peak:.2f} GiB; {smi}")
    SERVE_SUMMARY.append(
        f"phase 22 packed service at {n} pods: build {build_s:.2f} s ({launches[0]} "
        f"packed_dir_allow launches), {n_ev / sum(apply_s):.1f} events/s, apply per batch "
        + ", ".join(f"{a:.2f}" for a in apply_s) + f" s, idle share {idle_share(busy, apply_s)}, "
        f"query batch median {statistics.median(q_s) * 1e3:.1f} ms, posture record median "
        f"{statistics.median(rec_s) * 1e3:.1f} ms, checks per batch "
        + ", ".join(f"{c:.2f}" for c in check_s) + f" s (batches {sorted(checked)}), "
        f"checkpoint {ck_s:.2f} s ({size / 2**30:.2f} GiB), recover {recover_s:.2f} s, "
        f"{phase_s:.2f} s, peak {peak:.2f} GiB")
    return launches[0], dict(tmp=tmp, ck=os.path.join(tmp.name, "ck"), log=log_path,
                             svc=svc, more=more)


def serve_dense_phase(dev, smi: str) -> tuple:
    """Phase 23: the dense service at phase 18's size. Returns the service
    and its stream: phase 26's stripe fleet is held against them."""
    import dataclasses

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.serve import (
        AddPolicy,
        Assertion,
        PodSelector,
        QueryEngine,
        RemovePolicy,
        UpdatePolicy,
        VerificationService,
        check_assertions,
    )

    t_phase = time.perf_counter()
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**DENSE))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    svc = VerificationService(cluster, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if launch_counts() != (0, 0):
        fail(f"serve dense: the build launched a hand-written kernel: {launch_counts()}")
    eng = svc.engine
    pods = eng.pods
    rng = np.random.default_rng(23)
    svc.assertions = serve_assertions(cluster, rng)
    q = QueryEngine(svc)
    stream, cut = cut_populated_relabels(random_event_stream(cluster, n_events=128, seed=2),
                                         cluster)
    log(f"serve dense: build {build_s:.2f} s, no hand-written kernel launched; stream of "
        f"{len(stream)} events ({cut} relabels of populated namespaces cut)")
    lat = {"apply": [], "reach": [], "query": []}
    svc.start()
    try:
        for b, i in enumerate(range(0, len(stream), SERVE_BATCH)):
            t0 = time.perf_counter()
            svc.submit(stream[i : i + SERVE_BATCH])
            svc.flush()
            torch.cuda.synchronize()
            lat["apply"].append(time.perf_counter() - t0)
            found = check_assertions(svc, svc.assertions)  # the batched row gather
            t0 = time.perf_counter()
            reach = svc.reach()
            lat["reach"].append(time.perf_counter() - t0)
            one, one_s = _dense_one_shot(eng.as_cluster(), dev)
            if not np.array_equal(reach, one):
                fail(f"serve dense: batch {b} reach differs from a one-shot solve")
            if violation_rows(found) != host_violations(svc.assertions, one, pods):
                fail(f"serve dense: batch {b} assertion verdicts differ from the host's")
            probes, s_idx, d_idx, ported = query_mix(pods, b)
            t0 = time.perf_counter()
            ans = q.can_reach_batch(probes)
            lat["query"].append(time.perf_counter() - t0)
            if not np.array_equal(ans[~ported], one[s_idx, d_idx][~ported]):
                fail(f"serve dense: batch {b} any-port answers differ from the one-shot solve")
            log(f"serve dense: batch {b}: apply {lat['apply'][-1]:.2f} s, reach "
                f"{lat['reach'][-1]:.2f} s, can_reach_batch 4,096 probes "
                f"{lat['query'][-1] * 1e3:.1f} ms; reach == one-shot ({one_s:.2f} s), "
                f"{len(found)} violated assertions == the host's verdicts")
    finally:
        svc.close()
    no_fallback(svc, "serve dense")

    # what-if: an add, an update, a remove, and a deny-all that breaks an
    # assertion which holds now
    pols = list(eng.policies.values())
    donor = kvt.random_cluster(kvt.GeneratorConfig(**{**DENSE, "n_pods": 2_000,
                                                      "n_policies": 64, "seed": 3}))
    victim = pods[int(rng.integers(len(pods)))].namespace
    cands = [
        AddPolicy(policy=dataclasses.replace(donor.policies[0], name="wi-add",
                                             namespace=pols[5].namespace)),
        UpdatePolicy(policy=dataclasses.replace(pols[1], ingress=pols[2].ingress,
                                                egress=pols[2].egress)),
        RemovePolicy(namespace=pols[0].namespace, name=pols[0].name),
        AddPolicy(policy=kvt.NetworkPolicy("wi-deny-all", namespace=victim,
                                           pod_selector=kvt.Selector(), ingress=(),
                                           policy_types=("Ingress",))),
    ]
    by_key = {f"{p.namespace}/{p.name}": p for p in eng.as_cluster().policies}
    for ev in cands:
        if isinstance(ev, RemovePolicy):
            del by_key[f"{ev.namespace}/{ev.name}"]
        else:
            by_key[f"{ev.policy.namespace}/{ev.policy.name}"] = ev.policy
    after, _ = _dense_one_shot(dataclasses.replace(eng.as_cluster(),
                                                   policies=list(by_key.values())), dev)
    before = svc.reach()
    lost = before & ~after
    np.fill_diagonal(lost, False)
    first = host_first_cells(lost, 1)[0]
    if not first:
        fail("serve dense: the what-if candidates remove no pair")
    del lost
    s, d = (pods[x] for x in first[0])
    keep = Assertion("keep", "allow", PodSelector(namespace=s.namespace, name=s.name),
                     PodSelector(namespace=d.namespace, name=d.name))
    counts = (eng._ing_count.clone(), eng._eg_count.clone())
    iso = (eng._ing_iso.copy(), eng._eg_iso.copy(), eng.update_count, svc.generation)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = q.what_if(cands, assertions=[keep])
    torch.cuda.synchronize()
    wi_s = time.perf_counter() - t0
    wi_peak = torch.cuda.max_memory_allocated() / 2**30
    if not (torch.equal(counts[0], eng._ing_count) and torch.equal(counts[1], eng._eg_count)):
        fail("serve dense: what_if changed the engine's count matrices")
    if not (np.array_equal(iso[0], eng._ing_iso) and np.array_equal(iso[1], eng._eg_iso)
            and iso[2:] == (eng.update_count, svc.generation)):
        fail("serve dense: what_if changed the engine's state")
    del counts
    name = lambda i: f"{pods[i].namespace}/{pods[i].name}"
    added, n_added = host_first_cells(after & ~before, 20)
    removed, n_removed = host_first_cells(before & ~after, 20)
    want = (n_added, n_removed, [(name(a), name(b)) for a, b in added],
            [(name(a), name(b)) for a, b in removed])
    if (res.n_added, res.n_removed, res.added, res.removed) != want:
        fail("serve dense: what_if's diff differs from the one-shot solve of the "
             "cluster with the candidates applied")
    if res.ok or [v.assertion for v in res.violations] != ["keep"]:
        fail("serve dense: what_if did not report the broken assertion")
    log(f"serve dense: what_if (add, update, remove, deny-all into {victim}) "
        f"{wi_s:.2f} s, peak device memory {wi_peak:.2f} GiB: +{res.n_added} "
        f"-{res.n_removed} pairs == the one-shot solve of the candidates applied, the "
        f"broken assertion reported, the engine's counts byte-equal before and after")
    phase_s = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve dense: apply median {statistics.median(lat['apply']):.2f} s, reach "
        f"median {statistics.median(lat['reach']):.2f} s, query median "
        f"{statistics.median(lat['query']) * 1e3:.1f} ms; {phase_s:.2f} s, "
        f"peak device memory {peak:.2f} GiB; {smi}")
    SERVE_SUMMARY.append(
        f"phase 23 dense service: apply median {statistics.median(lat['apply']):.2f} s, reach "
        f"median {statistics.median(lat['reach']):.2f} s, query median "
        f"{statistics.median(lat['query']) * 1e3:.1f} ms, what_if {wi_s:.2f} s, {phase_s:.2f} s, "
        f"peak {peak:.2f} GiB")
    if launch_counts()[1] != 0:
        fail(f"serve dense: fused_ports_reach ran: {launch_counts()}")
    return cluster, svc, stream


def serve_card_vs_cpu_phase(dev) -> None:
    """Phase 24: the dense and packed services on the card against the same
    services on the CPU at phase 8's size, then three forced
    ``BackendError``s in the card's dense engine."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.observe.events import Clock, get_clock, set_clock
    from kubernetes_verification_tpu_torch.resilience.errors import BackendError, DeviceLost
    from kubernetes_verification_tpu_torch.serve import QueryEngine, VerificationService

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**VERIFY))
    events = random_event_stream(cluster, n_events=560, seed=24, p_resync=0.01)
    stream, extra = events[:500], events[500:]
    kinds = {e.kind for e in stream}

    def build(kind, d):
        if kind == "dense":
            svc = VerificationService(cluster, device=d)
        else:
            svc = VerificationService(engine=kvt.PackedIncrementalVerifier(
                cluster, device=d, keep_matrix=True))
        svc.assertions = serve_assertions(cluster, np.random.default_rng(24))
        svc.enable_posture()
        return svc, QueryEngine(svc)

    svcs = {(k, d): build(k, dev if d == "card" else d)
            for k in ("dense", "packed") for d in ("card", "cpu")}

    def record(svc):
        r = svc.posture.records[-1].to_dict()
        r.pop("ts"), r.pop("delta_s")
        return r

    for b, i in enumerate(range(0, len(stream), 50)):
        for svc, _ in svcs.values():
            svc.apply(stream[i : i + 50])
        probes = query_mix(cluster.pods, b, count=512)[0]
        reach = {}
        for kind in ("dense", "packed"):
            (g, gq), (c, cq) = svcs[(kind, "card")], svcs[(kind, "cpu")]
            reach[kind] = g.reach()
            if not np.array_equal(reach[kind], c.reach()):
                fail(f"serve card vs cpu: {kind} reach differs after batch {b}")
            if kind == "packed" and not torch.equal(g.engine._packed.cpu(), c.engine._packed):
                fail(f"serve card vs cpu: packed words differ after batch {b}")
            if not np.array_equal(gq.can_reach_batch(probes), cq.can_reach_batch(probes)):
                fail(f"serve card vs cpu: {kind} can_reach_batch differs after batch {b}")
            if record(g) != record(c):
                fail(f"serve card vs cpu: {kind} posture record differs after batch {b}")
            if violation_rows(g.violations) != violation_rows(c.violations):
                fail(f"serve card vs cpu: {kind} violations differ after batch {b}")
            if g.stats.to_dict() != c.stats.to_dict():
                fail(f"serve card vs cpu: {kind} ServeStats differ after batch {b}: "
                     f"{g.stats.to_dict()} != {c.stats.to_dict()}")
        if not np.array_equal(reach["dense"], reach["packed"]):
            fail(f"serve card vs cpu: the dense and packed services differ after batch {b}")
    for (kind, d), (svc, _) in svcs.items():
        no_fallback(svc, f"serve card vs cpu ({kind}, {d})")
    log(f"serve card vs cpu: {len(stream)} events ({', '.join(sorted(kinds))}) in 10 "
        f"batches: reach, packed words, 512 probes, posture records, violations and "
        f"ServeStats equal cuda == cpu for both engines after every batch, and dense == "
        f"packed; {time.perf_counter() - t_phase:.2f} s")

    # three forced BackendErrors in the card's dense engine: each reaches the
    # caller, the breaker opens, an open breaker fails fast without touching
    # the engine, and past the cooldown one probe on the card closes it; no
    # answer is ever taken from the host. Posture stays attached, so each
    # apply's publish hands the engine its packed words and ``reach`` unpacks
    # them on the card instead of deriving: the faults sit on that unpack
    (g, _), (c, _) = svcs[("dense", "card")], svcs[("dense", "cpu")]
    engine_calls = [0]

    def lost():
        engine_calls[0] += 1
        raise DeviceLost("forced device loss", backend="dense")

    for k in range(3):
        batch = extra[20 * k : 20 * (k + 1)]
        g.apply(batch)
        c.apply(batch)
        if not (g.engine.reach_clean and g.engine._reach is None):
            fail(f"serve card vs cpu: batch {k}'s publish left no posture words to unpack")
        g.engine._unpack_reach_words = lost  # after the apply: a resync replaces the engine
        try:
            g.reach()
        except BackendError as e:
            if e.kind != "device_loss":
                fail(f"serve card vs cpu: forced BackendError {k} came back as {e.kind}")
        else:
            fail(f"serve card vs cpu: forced BackendError {k} did not reach the caller")
    if g._breaker.state != "open" or g._breaker.transitions != ["open"]:
        fail(f"serve card vs cpu: the breaker went {g._breaker.transitions}, not to open")
    try:
        g.reach()
    except BackendError as e:
        if e.kind != "breaker_open":
            fail(f"serve card vs cpu: the open breaker raised {e.kind}, not breaker_open")
    else:
        fail("serve card vs cpu: the open breaker answered")
    if engine_calls[0] != 3:
        fail(f"serve card vs cpu: the engine ran {engine_calls[0]} times, not 3")
    del g.engine._unpack_reach_words
    prev_clock = get_clock()

    class AfterCooldown(Clock):
        def perf(self) -> float:
            return super().perf() + g.serve_config.breaker_cooldown

    set_clock(AfterCooldown())
    try:
        probe_reach = g.reach()
    finally:
        set_clock(prev_clock)
    if not np.array_equal(probe_reach, c.reach()):
        fail("serve card vs cpu: the half-open probe's reach differs from the CPU engine's")
    if g._breaker.transitions != ["open", "half_open", "closed"]:
        fail(f"serve card vs cpu: the breaker went {g._breaker.transitions} after the probe")
    if fallbacks() != 0 or "fallback" in g.stats.solves:
        fail(f"serve card vs cpu: an answer came from the host ({fallbacks()} fallbacks, "
             f"solves {g.stats.solves})")
    phase_s = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve card vs cpu: 3 forced BackendErrors in the card's dense engine each reached "
        f"the caller, the breaker opened and then failed fast (kind breaker_open) without "
        f"running the engine, a probe after the cooldown closed it with reach == the CPU "
        f"engine's, kvtpu_fallbacks_total 0; {phase_s:.2f} s, peak device memory {peak:.2f} GiB")
    SERVE_SUMMARY.append(
        f"phase 24 card vs cpu: equal after every batch, 3 forced BackendErrors raised, "
        f"breaker open then closed by a probe, 0 fallbacks, {phase_s:.2f} s, peak {peak:.2f} GiB")
    if launch_counts()[1] != 0:
        fail(f"serve card vs cpu: fused_ports_reach ran: {launch_counts()}")


# ---------------------------------------------------------------------------
# phases 25-27: replication, the stripe fleet, the transport and the front door
# ---------------------------------------------------------------------------

#: events the phase-25 leader appends while its follower tails
REPLICA_TAIL = 32
#: stripes of phase 26's fleet
STRIPES = 4
#: pods of phase 26 whose full-scatter columns and rows are asked for
STRIPE_SCATTER = 64


class WallClock:
    """A wall clock that starts at the real time and moves only when told
    to: the leases of phases 25 and 27 expire through it, not by sleeping."""

    def __init__(self) -> None:
        self.t = time.time()

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def replicated_phase(ctx: dict, dev, smi: str) -> None:
    """Phase 25 (run right after phase 22, on its checkpoint directory, WAL
    and live service, the leader): a lease on the leader; a
    ``FollowerService`` on the card bootstraps from the checkpoint through
    the recovery ladder (replaying the 64 post-checkpoint events) and tails
    ``REPLICA_TAIL`` more events the leader writes under its lease; its
    words and ``pod_active`` equal the leader's at the same ``last_seq``,
    it is caught up, and a 4,096-probe query batch equals the leader's
    answers. The lease expires through the clock: the follower promotes to
    epoch 2 once its probe breaker opens, the deposed leader's
    ``WalWriter.append`` raises ``FencedError``, and one event the new
    leader writes is applied (its words equal the old leader's after the
    same event)."""
    import numpy as np

    from kubernetes_verification_tpu_torch.resilience.errors import FencedError
    from kubernetes_verification_tpu_torch.serve import (
        FollowerService,
        LeaseFile,
        QueryEngine,
        WalWriter,
        scan_wal,
    )

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    leader, ck, log_path, more = ctx["svc"], ctx["ck"], ctx["log"], ctx["more"]
    if len(more) < REPLICA_TAIL + 1:
        fail(f"replicated: only {len(more)} unused events for the tail")
    clock = WallClock()
    lease = LeaseFile(ck, clock=clock)
    lease.acquire("leader-0", ttl=5.0)
    writer = WalWriter(log_path, epoch=1, lease=lease)
    t0 = time.perf_counter()
    f = FollowerService(ck, log_path=log_path, replica="card-follower", device=dev,
                        lease_ttl=5.0, breaker_threshold=2, clock=clock)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    rec = f.recovery
    if (rec.outcome, rec.replayed, rec.duplicates_skipped) != ("newest", SERVE_TAIL, 0):
        fail(f"replicated: bootstrap {rec.outcome}, replayed {rec.replayed}, "
             f"{rec.duplicates_skipped} duplicates")
    if not (f.service.packed and f.service.engine._packed.device.type == dev.type):
        fail("replicated: the follower's engine is not the packed engine on the card")
    log(f"replicated: follower bootstrap {boot_s:.2f} s through the recovery ladder "
        f"(outcome newest, {rec.replayed} post-checkpoint events replayed, 0 "
        f"duplicates); {smi}")

    tail = more[:REPLICA_TAIL]
    writer.append(tail)
    leader.apply(tail)
    if f.lag().seq != REPLICA_TAIL:
        fail(f"replicated: the follower's lag is {f.lag()}, not {REPLICA_TAIL} records")
    t0 = time.perf_counter()
    got = f.poll()
    torch.cuda.synchronize()
    tail_s = time.perf_counter() - t0
    if got != REPLICA_TAIL or not f.lag().caught_up:
        fail(f"replicated: the tail applied {got} events, lag {f.lag()}")

    def same_state(tag: str) -> None:
        if not (torch.equal(f.service.engine._packed, leader.engine._packed)
                and np.array_equal(f.service.engine.pod_active, leader.engine.pod_active)):
            fail(f"replicated: {tag}: the follower's words differ from the leader's")

    same_state("after the tail")
    if f.source.last_seq != writer.next_seq - 1:
        fail(f"replicated: follower at seq {f.source.last_seq}, leader at "
             f"{writer.next_seq - 1}")
    probes = query_mix(leader.engine.pods, 25)[0]
    t0 = time.perf_counter()
    ans = f.can_reach_batch(probes)
    q_s = time.perf_counter() - t0
    if not np.array_equal(ans, QueryEngine(leader).can_reach_batch(probes)):
        fail("replicated: the follower's 4,096 answers differ from the leader's")
    log(f"replicated: tail of {got} events {tail_s:.2f} s = {got / tail_s:.1f} events/s; "
        f"words and pod_active == the leader's at seq {f.source.last_seq}, caught up; "
        f"can_reach_batch 4,096 probes {q_s * 1e3:.1f} ms == the leader's answers")

    if not f.heartbeat() or f.maybe_promote():
        fail("replicated: a follower promoted under a live lease")
    clock.advance(6.0)
    for _ in range(2):
        f.heartbeat()
    t0 = time.perf_counter()
    won = f.maybe_promote()
    promote_s = time.perf_counter() - t0
    if not (won and f.epoch == 2 and lease.read().holder == "card-follower"):
        fail(f"replicated: promotion failed (won {won}, epoch {f.epoch})")
    ev = more[REPLICA_TAIL : REPLICA_TAIL + 1]
    try:
        writer.append(ev)
    except FencedError:
        pass
    else:
        fail("replicated: the deposed leader's WalWriter appended after the promotion")
    f.writer.append(ev)
    if f.catch_up() != 1:
        fail("replicated: the new leader's event was not applied")
    leader.apply(ev)
    same_state("after the new leader's event")
    if scan_wal(log_path).last_epoch != 2:
        fail("replicated: the WAL's last epoch is not the new reign's")
    no_fallback(f.service, "replicated")
    phase_s = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"replicated: promote {promote_s * 1e3:.1f} ms (epoch 2, after 2 failed "
        f"heartbeats), the deposed leader fenced, the new leader's event applied; "
        f"{phase_s:.2f} s, peak device memory {peak:.2f} GiB; {smi}")
    SERVE_SUMMARY.append(
        f"phase 25 replicated flagship: bootstrap {boot_s:.2f} s, tail "
        f"{got / tail_s:.1f} events/s, follower query batch {q_s * 1e3:.1f} ms, promote "
        f"{promote_s * 1e3:.1f} ms, {phase_s:.2f} s, peak {peak:.2f} GiB")
    f.writer.close()
    writer.close()


def stripe_phase(cluster, dense_svc, stream, dev, smi: str) -> None:
    """Phase 26: a striped dense fleet at phase 23's size (K = 4, on the
    card): phase 23's event stream written to a WAL, four
    ``StripeFollower``s tailing it behind a ``StripeCoordinator``, each
    owner under the 1/K + ε state bound; ``can_reach_batch`` of 4,096
    probes, ``who_can_reach_batch`` and ``blast_radius_batch`` of 64 pods
    and ``hops`` (at most 2) of 8 pairs == phase 23's dense service after the same
    events; one stripe round-tripped through ``checkpoint_stripe`` /
    ``recover_stripe``."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from kubernetes_verification_tpu_torch.serve import (
        CheckpointManager,
        QueryEngine,
        RecoveryManager,
        StripeCoordinator,
        StripeFollower,
        WalWriter,
    )

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.TemporaryDirectory(prefix="kvt-stripes-")
    log_path = os.path.join(tmp.name, "events.jsonl")
    with WalWriter(log_path) as w:
        w.append(stream)
    owners, build_s = [], []
    for k in range(STRIPES):
        t0 = time.perf_counter()
        owners.append(StripeFollower(cluster, dense_svc.engine.config, stripe=(k, STRIPES),
                                     device=dev, replica=f"stripe-{k + 1}",
                                     log_path=log_path))
        torch.cuda.synchronize()
        build_s.append(time.perf_counter() - t0)
    n = len(cluster.pods)
    whole = sum(t.numel() * t.element_size()
                for t in (dense_svc.engine._ing_count, dense_svc.engine._eg_count))
    bound = whole / STRIPES + 64 * n
    for o in owners:
        if o.engine.state_bytes() > bound:
            fail(f"stripes: owner {o.replica} holds {o.engine.state_bytes()} bytes, over "
                 f"the 1/K + eps bound {bound:.0f}")
    log(f"stripes: {STRIPES} stripes of {n} pods built in "
        + ", ".join(f"{b:.2f}" for b in build_s) + " s; state per owner "
        + ", ".join(f"{o.engine.state_bytes() / 2**30:.2f}" for o in owners)
        + f" GiB <= whole/K + 64 N = {bound / 2**30:.2f} GiB (whole {whole / 2**30:.2f} GiB)")
    apply_s = []
    batches = list(owners[0].source.batches(SERVE_BATCH))
    for o in owners[1:]:
        if [len(b) for b in o.source.batches(SERVE_BATCH)] != [len(b) for b in batches]:
            fail("stripes: the owners read different batches from the WAL")
    for b, batch in enumerate(batches):
        t0 = time.perf_counter()
        for o in owners:
            o.apply(batch)
        torch.cuda.synchronize()
        apply_s.append(time.perf_counter() - t0)
    applied = {o.applied_total for o in owners}
    fanout = [o.fanout_total for o in owners]
    if len(applied) != 1 or min(fanout) == 0:
        fail(f"stripes: applied {applied}, fan-out {fanout}")
    coord = StripeCoordinator(owners, pods=cluster.pods)
    q = QueryEngine(dense_svc)
    names = [f"{p.namespace}/{p.name}" for p in cluster.pods]
    probes, _, _, ported = query_mix(cluster.pods, 26, count=4608)
    anyport = [p for p, x in zip(probes, ported) if not x][:4096]
    if len(anyport) != 4096:
        fail(f"stripes: the probe mix gave {len(anyport)} any-port probes")
    t0 = time.perf_counter()
    got = coord.can_reach_batch(anyport)
    probe_s = time.perf_counter() - t0
    if not np.array_equal(got, q.can_reach_batch(anyport)):
        fail("stripes: the coordinator's probes differ from the dense service's")
    rng = np.random.default_rng(26)
    some = [names[int(i)] for i in rng.choice(n, STRIPE_SCATTER, replace=False)]
    if coord.who_can_reach_batch(some) != q.who_can_reach_batch(some):
        fail("stripes: who_can_reach_batch differs from the dense service's")
    if coord.blast_radius_batch(some) != q.blast_radius_batch(some):
        fail("stripes: blast_radius_batch differs from the dense service's")
    # two levels: the second gathers its frontier's rows from every stripe
    # (up to all N rows a pair), which is what a deeper bound repeats
    pairs = [(some[i], some[-1 - i]) for i in range(8)]
    t0 = time.perf_counter()
    hops = [coord.hops(a, b, 2) for a, b in pairs]
    hops_s = time.perf_counter() - t0
    if hops != [q.hops(a, b, 2) for a, b in pairs]:
        fail("stripes: hops differ from the dense service's")
    scatter = []
    for name in some:
        t0 = time.perf_counter()
        coord.who_can_reach(name)
        scatter.append(time.perf_counter() - t0)
    scatter.sort()
    p50 = scatter[len(scatter) // 2]
    p99 = scatter[min(len(scatter) - 1, int(0.99 * len(scatter)))]
    chunks = [anyport[i::16] for i in range(16)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        outs = list(pool.map(coord.can_reach_batch, chunks))
    threaded_s = time.perf_counter() - t0
    if not all(np.array_equal(a, got[i::16]) for i, a in enumerate(outs)):
        fail("stripes: threaded answers differ from the single batch")
    qps = len(anyport) / threaded_s
    log(f"stripes: apply per batch (all {STRIPES} owners) "
        + ", ".join(f"{a:.2f}" for a in apply_s) + f" s, fan-out {fanout}; "
        f"can_reach_batch {len(anyport)} any-port probes {probe_s * 1e3:.1f} ms, "
        f"who_can_reach_batch / blast_radius_batch of {STRIPE_SCATTER} pods and hops "
        f"(<= 2) of 8 pairs {hops} ({hops_s:.2f} s) == the dense service's; full-scatter "
        f"who_can_reach p50 "
        f"{p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms; 4 threads {qps:.0f} queries/s")

    k = 1
    cm = CheckpointManager(os.path.join(tmp.name, "ck"))
    t0 = time.perf_counter()
    owners[k].checkpoint(cm)
    ck_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = RecoveryManager(os.path.join(tmp.name, "ck")).recover_stripe(
        (k, STRIPES), device=dev)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    eng, back = owners[k].engine, res.service.engine
    if (res.outcome, res.replayed) != ("newest", 0) or not (
            torch.equal(eng._ing_count, back._ing_count)
            and torch.equal(eng._eg_count, back._eg_count)
            and np.array_equal(eng._ing_iso, back._ing_iso)
            and np.array_equal(eng._eg_iso, back._eg_iso)):
        fail(f"stripes: stripe {k + 1} did not round-trip ({res.outcome}, {res.replayed})")
    del res, back
    phase_s = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"stripes: stripe {k + 1}/{STRIPES} checkpoint_stripe {ck_s:.2f} s, "
        f"recover_stripe {rec_s:.2f} s, counts byte-equal; {phase_s:.2f} s, peak device "
        f"memory {peak:.2f} GiB; {smi}")
    SERVE_SUMMARY.append(
        f"phase 26 {STRIPES} stripes at {n} pods: builds "
        + ", ".join(f"{b:.2f}" for b in build_s) + " s, apply per batch "
        + ", ".join(f"{a:.2f}" for a in apply_s) + f" s, probes {probe_s * 1e3:.1f} ms, "
        f"who_can_reach p50 {p50 * 1e3:.1f} ms p99 {p99 * 1e3:.1f} ms, 4 threads {qps:.0f} "
        f"queries/s, checkpoint/recover stripe {ck_s:.2f}/{rec_s:.2f} s, {phase_s:.2f} s, "
        f"peak {peak:.2f} GiB")
    tmp.cleanup()


class RemoteReplica:
    """A follower behind its ``ReplicationServer`` and front-door
    ``Ingress``, as a load balancer sees it: ``can_reach_batch`` over
    ``POST /v1/query``; ``lag()`` is the follower's own measurement."""

    def __init__(self, client, follower) -> None:
        self.client = client
        self.replica = follower.replica
        self.lag = follower.lag

    def can_reach_batch(self, probes):
        import numpy as np

        return np.asarray(self.client.query(probes), dtype=bool)


def transport_phase(dev, smi: str) -> int:
    """Phase 27: the card against the CPU at phase 8's size. A packed leader
    service on the card (2 ``packed_dir_allow`` launches) serves its
    checkpoint and WAL over HTTP on ``127.0.0.1:0``; a follower on the card
    and one on the CPU bootstrap through ``bootstrap_from_leader`` and tail
    through ``RemoteEventSource``: equal words and answers after every
    batch. K = 3 stripes (ragged bounds) on the card == on the CPU. A
    ``QueryLoadBalancer`` over both followers behind their own servers, the
    CPU one stopped: the answers stay the leader's and its breaker opens.
    An ``Ingress`` sheds with a typed ``AdmissionRejectedError``.
    ``resilient_verify`` on the card == the CPU oracle with no fallback; a
    forced device loss with chain ``("faulty:torch",)`` reaches the caller
    as ``BackendChainExhausted``; ``("torch", "cpu")`` is refused with
    ``ConfigError``. Returns the leader build's ``packed_dir_allow``
    launches."""
    import os
    import tempfile

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.resilience import faults
    from kubernetes_verification_tpu_torch.resilience.errors import (
        AdmissionRejectedError,
        BackendChainExhausted,
        ConfigError,
        DeviceLost,
    )
    from kubernetes_verification_tpu_torch.resilience.retry import RetryPolicy
    from kubernetes_verification_tpu_torch.resilience.wrapper import (
        ResilienceConfig,
        resilient_verify,
    )
    from kubernetes_verification_tpu_torch.serve import (
        AdmissionController,
        CheckpointManager,
        EventSource,
        FollowerService,
        Ingress,
        LeaseFile,
        QueryEngine,
        QueryLoadBalancer,
        ReplicationClient,
        ReplicationServer,
        StripeCoordinator,
        StripeFollower,
        TenantQuota,
        VerificationService,
        WalWriter,
    )

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.TemporaryDirectory(prefix="kvt-transport-")
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**VERIFY))
    cfg = kvt.VerifyConfig(compute_ports=False)
    events = random_event_stream(cluster, n_events=160, seed=27)
    reset_counts()
    leader = VerificationService(engine=kvt.PackedIncrementalVerifier(
        cluster, cfg, device=dev, keep_matrix=True))
    build = launch_counts()
    if build != (2, 0):
        fail(f"transport: the leader's build launched {build}, not (2, 0)")
    ck, log_path = os.path.join(tmp.name, "ck"), os.path.join(tmp.name, "events.jsonl")
    os.makedirs(ck)
    lease = LeaseFile(ck)
    lease.acquire("leader-0", ttl=60.0)
    writer = WalWriter(log_path, epoch=1, lease=lease)
    src = EventSource(log_path)
    writer.append(events[:80])
    for b in src.batches(64):
        leader.apply(b)
    CheckpointManager(ck).checkpoint(leader.engine, log_path=log_path,
                                     log_offset=src.offset, last_seq=src.last_seq)
    fast = RetryPolicy(max_retries=0, backoff_base=0.001)
    servers = []
    try:
        server = ReplicationServer(ck, log_path, port=0)
        servers.append(server)
        server.start()
        t0 = time.perf_counter()
        card = FollowerService(os.path.join(tmp.name, "card"), leader_url=server.url,
                               replica="card", device=dev, transport_timeout=10.0)
        boot_s = time.perf_counter() - t0
        host = FollowerService(os.path.join(tmp.name, "host"), leader_url=server.url,
                               replica="host", device="cpu", transport_timeout=10.0)
        lq = QueryEngine(leader)
        stripes = {d: [StripeFollower(cluster, cfg, stripe=(k, 3), device=d,
                                      replica=f"{d}-{k}") for k in range(3)]
                   for d in (dev, "cpu")}
        bounds = [o.engine.stripe_rows for o in stripes[dev]]
        for o in stripes[dev] + stripes["cpu"]:
            o.apply(events[:80])
        for b, i in enumerate(range(80, len(events), 40)):
            batch = events[i : i + 40]
            writer.append(batch)
            leader.apply(batch)
            for o in stripes[dev] + stripes["cpu"]:
                o.apply(batch)
            if card.catch_up() != host.catch_up():
                fail(f"transport: the followers applied different tails at batch {b}")
            probes = query_mix(cluster.pods, b, count=512)[0]
            want = lq.can_reach_batch(probes)
            for f in (card, host):
                if not (torch.equal(f.service.engine._packed.cpu(),
                                    leader.engine._packed.cpu())
                        and f.lag().caught_up and f.generation == card.generation):
                    fail(f"transport: follower {f.replica} differs from the leader at batch {b}")
                if not np.array_equal(f.can_reach_batch(probes), want):
                    fail(f"transport: follower {f.replica}'s answers differ at batch {b}")
            for a, c in zip(stripes[dev], stripes["cpu"]):
                if not (torch.equal(a.engine._ing_count.cpu(), c.engine._ing_count)
                        and torch.equal(a.engine._eg_count.cpu(), c.engine._eg_count)):
                    fail(f"transport: stripe {a.replica} differs from the CPU's at batch {b}")
        names = [f"{p.namespace}/{p.name}" for p in cluster.pods]
        anyport = [(names[a], names[c]) for a, c in
                   np.random.default_rng(27).integers(0, len(names), (512, 2))]
        cc = StripeCoordinator(stripes[dev], pods=cluster.pods)
        hc = StripeCoordinator(stripes["cpu"], pods=cluster.pods)
        if not (np.array_equal(cc.can_reach_batch(anyport), hc.can_reach_batch(anyport))
                and np.array_equal(cc.can_reach_batch(anyport), lq.can_reach_batch(anyport))
                and cc.who_can_reach_batch(names[:16]) == hc.who_can_reach_batch(names[:16])):
            fail("transport: the stripes on the card answer differently from the CPU's")
        log(f"transport: leader on the card behind {server.url}; followers on the card "
            f"(bootstrap {boot_s:.2f} s) and the CPU tailed {card.applied} events over "
            f"HTTP: words and 512 answers == the leader's after every batch; 3 stripes "
            f"{bounds} on the card == on the CPU")

        fronts = {}
        for f in (card, host):
            ing = Ingress(f).start()
            srv = ReplicationServer(f.directory, f.log_path, port=0, ingress=ing,
                                    health_source=f.health)
            servers.append(srv)
            srv.start()
            fronts[f.replica] = (srv, ing, RemoteReplica(
                ReplicationClient(srv.url, timeout=10.0, policy=fast), f))
        lb = QueryLoadBalancer([r for _, _, r in fronts.values()], seed=27,
                               breaker_threshold=2)
        probes = [(names[a], names[c]) for a, c in
                  np.random.default_rng(100).integers(0, len(names), (64, 2))]
        want = lq.can_reach_batch(probes)
        for _ in range(4):  # both serve while both run
            ans, who = lb.can_reach_batch(probes)
            if not np.array_equal(ans, want):
                fail(f"transport: the load balancer's answer from {who} differs")
        fronts["host"][0].close()  # the CPU follower's server stops
        for b in range(24):
            ans, who = lb.can_reach_batch(probes)
            if who != "card" or not np.array_equal(ans, want):
                fail(f"transport: the load balancer answered from {who} or differently")
            if lb.breakers["host"].state == "open":
                break
        if lb.breakers["host"].state != "open" or lb.breakers["card"].state != "closed":
            fail(f"transport: breakers {({k: b.state for k, b in lb.breakers.items()})}")
        clock = WallClock()
        gate = AdmissionController([TenantQuota("t", rate=1.0, burst=64.0)], clock=clock)
        with Ingress(card, admission=gate) as ing:
            ing.submit(anyport[:64], tenant="t")
            try:
                ing.submit(anyport[:8], tenant="t")
            except AdmissionRejectedError as e:
                shed = (e.reason, e.retry_after_s)
            else:
                fail("transport: the ingress admitted past its quota")
        if shed[0] != "over-quota":
            fail(f"transport: the ingress shed with {shed}")
        log(f"transport: load balancer over both followers, host stopped: {lb.routed}, "
            f"the host's breaker open, answers == the leader's; ingress shed "
            f"over-quota (retry after {shed[1]:.1f} s)")
    finally:
        for srv in servers:
            srv.close()
        for front in locals().get("fronts", {}).values():
            front[1].close()
        writer.close()

    card_cfg = kvt.VerifyConfig(compute_ports=False, backend_options=(("device", str(dev)),))
    res = resilient_verify(cluster, card_cfg)
    oracle = kvt.verify(cluster, kvt.VerifyConfig(backend="cpu", compute_ports=False))
    if res.backend != "torch" or not np.array_equal(res.reach, oracle.reach):
        fail(f"transport: resilient_verify on the card ({res.backend}) != the CPU oracle")
    name = faults.register_faulty("torch", faults.parse_fault_spec("device_loss"))
    try:
        resilient_verify(cluster, card_cfg, ResilienceConfig(fallback_chain=(name,)))
    except BackendChainExhausted as e:
        if not isinstance(e.failures[0][1], DeviceLost):
            fail(f"transport: the forced fault reached the caller as {e.failures}")
    else:
        fail("transport: a forced device loss did not reach the caller")
    try:  # the default device is the card
        resilient_verify(cluster, cfg, ResilienceConfig(fallback_chain=("torch", "cpu")))
    except ConfigError:
        pass
    else:
        fail("transport: a chain from the card to the host was not refused")
    if fallbacks() != 0:
        fail(f"transport: kvtpu_fallbacks_total reads {fallbacks()}")
    tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"transport: resilient_verify on the card == the CPU oracle, a forced device loss "
        f"typed (BackendChainExhausted), the card-to-cpu chain refused (ConfigError), "
        f"kvtpu_fallbacks_total 0; {phase_s:.2f} s, peak device memory {peak:.2f} GiB; {smi}")
    SERVE_SUMMARY.append(
        f"phase 27 transport at {VERIFY['n_pods']} pods: card follower bootstrap over HTTP "
        f"{boot_s:.2f} s, card == cpu (followers, 3 stripes), lb ejects the stopped "
        f"follower, ingress sheds typed, wrapper 0 fallbacks, {phase_s:.2f} s")
    return build[0]


#: phase 29: four ranks on the one card over gloo — a reduced cluster (the
#: flagship's 10 pods per policy) and kano scenario, over every mesh of 4
SHARD_SMALL = dict(n_pods=8_192, n_policies=820, n_namespaces=20,
                   p_ipblock_peer=0.0, min_selector_labels=1, seed=0)
SHARD_KANO = dict(n_containers=2_000, n_policies=200, seed=0)
SHARD_MESHES = [(4, 1), (2, 2), (1, 4)]
SHARD_RANKS = 4
SHARD_TIMEOUT_S = 300


def col_counts(words: torch.Tensor) -> "np.ndarray":
    """int64 [32·W]: set bits per column of int32 [R, W] words, a block of
    rows unpacked at a time."""
    from kubernetes_verification_tpu_torch.ops.bits import unpack_words_i8

    cols = words.shape[1] * 32
    out = torch.zeros(cols, dtype=torch.int64, device=words.device)
    for r0 in range(0, words.shape[0], 4096):
        out += unpack_words_i8(words[r0:r0 + 4096], cols).sum(dim=0, dtype=torch.int64)
    return out.cpu().numpy()


def sharded_words_equal(got, want: torch.Tensor, n: int) -> bool:
    """Host uint32 sharded words [n, W'] == int32 words [n, W] (any
    device) over the real columns, every pad word of both zero."""
    import numpy as np

    w = -(-n // 32)
    got = np.asarray(got)
    want = want.cpu().numpy().view(np.uint32)
    return (got.shape[0] == want.shape[0] == n
            and np.array_equal(got[:, :w], want[:, :w])
            and not got[:, w:].any() and not want[:, w:].any())


def sharded_phase(cluster, enc, main_words, ports_words, closed_words, masks, dev,
                  smi: str) -> None:
    """Phase 28: the sharded paths at world size 1 over NCCL, in this
    process, at full width: ``verify(backend="sharded-packed")`` any-port
    and with port bitmaps == phases 4 and 6 (words and aggregates, bit for
    bit), ``sharded_packed_closure`` == phase 10, the dense ``sharded``
    backend at 32,768 pods == ``verify(backend="torch")``, and
    ``policy_pair_masks_sharded`` == phase 9. No hand-written kernel."""
    import numpy as np
    import torch.distributed as dist

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.closure import packed_row_counts

    t_phase = time.perf_counter()
    mesh = kvt.mesh_for()
    log(f"sharded: {mesh}, process group {dist.get_backend()}, world size "
        f"{dist.get_world_size()}")
    n = cluster.n_pods
    # dst tiles: 1,024 any-port; 512 with port bitmaps, the most the port
    # path's per-tile plane budget allows at R = 19 on 100,000 rows
    for compute_ports, want, tile in ((False, main_words, 1024), (True, ports_words, 512)):
        tag = "port bitmaps" if compute_ports else "any-port"
        with Phase(f"sharded: verify(backend='sharded-packed', {tag})"):
            t0 = time.perf_counter()
            res = kvt.verify(cluster, kvt.VerifyConfig(
                backend="sharded-packed", compute_ports=compute_ports,
                backend_options=(("keep_matrix", True), ("tile", tile)),
            ))
            wall = time.perf_counter() - t0
        pk = res.packed_result
        want = want.to(dev)
        if not sharded_words_equal(pk.packed, want, n):
            fail(f"sharded: the sharded-packed words ({tag}) differ from the one-shot solve's")
        rows = packed_row_counts(want).cpu().numpy()
        if not (np.array_equal(pk.out_degree, rows) and pk.total_pairs == int(rows.sum())
                and np.array_equal(pk.in_degree, col_counts(want)[:n])):
            fail(f"sharded: the sharded-packed aggregates ({tag}) differ from the words'")
        del want
        log(f"sharded: sharded-packed {tag}: verify {wall:.2f} s (encode "
            f"{res.timings['encode']:.2f} s, solve {res.timings['solve']:.2f} s: "
            f"prologue {pk.timings['prologue']:.2f}, maps {pk.timings['maps']:.2f}, sweep "
            f"of {pk.timings['tiles']} tiles of {tile} {pk.timings['sweep']:.2f}, fetch "
            f"{pk.timings['fetch']:.2f} s), "
            f"{pk.total_pairs} pairs; words, out/in-degrees and pairs == the one-shot "
            f"solve's, bit for bit; {smi}")
        del res, pk
        torch.cuda.empty_cache()
    # N = 100,000 pads to itself, whose 32-multiple divisors are 32·5^k: the
    # default caps (7,168 / 14,336) snap both tiles to 4,000 (625 products a
    # pass); 20,000 gives 25 (~8 GB of transients)
    with Phase("sharded: sharded_packed_closure"):
        t0 = time.perf_counter()
        closed = kvt.sharded_packed_closure(mesh, main_words, tile=20_000, dst_tile=20_000)
        closure_s = time.perf_counter() - t0
    if not sharded_words_equal(closed, closed_words, n):
        fail("sharded: sharded_packed_closure differs from phase 10's closure")
    log(f"sharded: sharded_packed_closure (tiles 20,000) {closure_s:.2f} s == phase 10's "
        f"closure, bit for bit; {smi}")
    del closed
    with Phase("sharded: policy_pair_masks_sharded"):
        t0 = time.perf_counter()
        got = kvt.policy_pair_masks_sharded(mesh, enc)
        pairs_s = time.perf_counter() - t0
    if not all(np.array_equal(g, w) for g, w in zip(got, masks)):
        fail("sharded: policy_pair_masks_sharded differs from policy_pair_masks")
    log(f"sharded: policy_pair_masks_sharded {pairs_s:.2f} s == phase 9's masks; {smi}")
    dense = kvt.random_cluster(kvt.GeneratorConfig(**DENSE))
    runs = {}
    for backend in ("sharded", "torch"):
        with Phase(f"sharded: verify(backend={backend!r}) at {DENSE['n_pods']} pods"):
            t0 = time.perf_counter()
            runs[backend] = kvt.verify(dense, kvt.VerifyConfig(
                backend=backend, compute_ports=False))
            runs[backend + "_s"] = time.perf_counter() - t0
    for f in ("reach", "reach_ports", "selected", "src_sets", "dst_sets",
              "ingress_isolated", "egress_isolated"):
        if not np.array_equal(getattr(runs["sharded"], f), getattr(runs["torch"], f)):
            fail(f"sharded: the dense sharded backend's {f} differs from the torch backend's")
    log(f"sharded: dense sharded {runs['sharded_s']:.2f} s (solve "
        f"{runs['sharded'].timings['solve']:.2f} s) == torch {runs['torch_s']:.2f} s "
        f"(solve {runs['torch'].timings['solve']:.2f} s) on every field at "
        f"{DENSE['n_pods']} pods / {DENSE['n_policies']} policies; {smi}")
    del runs, dense
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    SERVE_SUMMARY.append(f"sharded world 1 {phase_s:.1f} s")
    log(f"sharded: {phase_s:.2f} s; {smi}")


def sharded_small(mesh, cluster, encs, kenc) -> tuple:
    """Phase 29's solves on ``mesh``: ``(arrays, seconds)``. The dense and
    packed backends (packed any-port and with port bitmaps), the kano
    reach, the packed closure of the any-port words and the pair masks."""
    from kubernetes_verification_tpu_torch.backends.base import VerifyConfig
    from kubernetes_verification_tpu_torch.backends.sharded import ShardedBackend
    from kubernetes_verification_tpu_torch.backends.sharded_packed import (
        ShardedPackedBackend,
    )
    from kubernetes_verification_tpu_torch.ops.tiled import policy_pair_masks_sharded
    from kubernetes_verification_tpu_torch.parallel.sharded_closure import (
        sharded_packed_closure,
    )
    from kubernetes_verification_tpu_torch.parallel.sharded_ops import sharded_kano_reach

    out, secs = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        secs[name] = time.perf_counter() - t0
        return r

    d = timed("sharded", lambda: ShardedBackend(mesh).verify(
        cluster, VerifyConfig(backend="sharded", compute_ports=False)))
    for f in ("reach", "selected", "src_sets", "dst_sets", "ingress_isolated",
              "egress_isolated"):
        out[f"dense_{f}"] = getattr(d, f)
    for ports in (False, True):
        tag = "ports" if ports else "any"
        r = timed(f"packed_{tag}", lambda: ShardedPackedBackend(mesh).verify(
            cluster, VerifyConfig(backend="sharded-packed", compute_ports=ports,
                                  backend_options=(("keep_matrix", True),))))
        pk = r.packed_result
        out[f"packed_{tag}"] = pk.packed
        out[f"out_degree_{tag}"], out[f"in_degree_{tag}"] = pk.out_degree, pk.in_degree
        out[f"ingress_isolated_{tag}"] = pk.ingress_isolated
    k, _ = timed("kano", lambda: sharded_kano_reach(mesh, kenc, with_closure=False))
    out["kano_reach"], out["kano_src"], out["kano_dst"] = k
    out["closure"] = timed("closure", lambda: sharded_packed_closure(mesh, out["packed_any"]))
    out["shadow"], out["conflict"] = timed(
        "pair_masks", lambda: policy_pair_masks_sharded(mesh, encs[False]))
    return out, secs


def _sharded_inputs():
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.encode.encoder import encode_kano

    cluster = kvt.random_cluster(kvt.GeneratorConfig(**SHARD_SMALL))
    encs = {p: kvt.encode_cluster(cluster, compute_ports=p) for p in (False, True)}
    return cluster, encs, encode_kano(*kvt.random_kano(**SHARD_KANO))


def _sharded_rank(rank: int, port: int, workdir: str) -> None:
    """One of phase 29's ranks (spawned): join the gloo group over CUDA
    tensors on card 0, solve on each mesh, hold every array against the
    world-1 result the parent wrote, and report."""
    import numpy as np
    import torch.distributed as dist

    from kubernetes_verification_tpu_torch.parallel.mesh import init_distributed, mesh_for

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_distributed(f"tcp://127.0.0.1:{port}", SHARD_RANKS, rank, backend="gloo",
                     device=dev)
    ref = dict(np.load(f"{workdir}/world1.npz"))
    inputs = _sharded_inputs()
    report = {}
    for shape in SHARD_MESHES:
        arrays, secs = sharded_small(mesh_for(shape, device=dev, backend="gloo"), *inputs)
        report[str(shape)] = dict(
            differ=sorted(k for k, v in arrays.items() if not np.array_equal(v, ref[k])),
            seconds=secs,
        )
    report["launches"] = list(launch_counts())
    report["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(f"{workdir}/rank{rank}.json", "w") as fh:
        json.dump(report, fh)
    dist.destroy_process_group()


def sharded_ranks_phase(smi: str) -> tuple:
    """Phase 29: four ranks on the one card over gloo, CUDA tensors (NCCL
    refuses two ranks on one GPU), spawned by this script; every rank's
    arrays on the meshes (4, 1), (2, 2) and (1, 4) == the world-1 NCCL
    result of the same code on the same inputs, computed here first. A
    rank that fails or disagrees fails the script. Returns the children's
    launches of the two kernels."""
    import os
    import socket
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    import kubernetes_verification_tpu_torch as kvt

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="kvt-sharded-")
    with Phase("sharded ranks: world-1 reference"):
        inputs = _sharded_inputs()
        ref, secs = sharded_small(kvt.mesh_for(), *inputs)
        np.savez(os.path.join(tmp.name, "world1.npz"), **ref)
    log(f"sharded ranks: world-1 reference on {SHARD_SMALL['n_pods']} pods / "
        f"{SHARD_SMALL['n_policies']} policies and kano {SHARD_KANO['n_containers']} x "
        f"{SHARD_KANO['n_policies']}: " + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items()))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.start_processes(_sharded_rank, args=(port, tmp.name), nprocs=SHARD_RANKS,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                fail(f"sharded ranks: the {SHARD_RANKS} ranks did not finish in "
                     f"{SHARD_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    ranks_s = time.perf_counter() - t0
    launches = [0, 0]
    for rank in range(SHARD_RANKS):
        with open(os.path.join(tmp.name, f"rank{rank}.json")) as fh:
            report = json.load(fh)
        launches = [a + b for a, b in zip(launches, report.pop("launches"))]
        peak = report.pop("peak_gib")
        for shape, r in report.items():
            if r["differ"]:
                fail(f"sharded ranks: rank {rank} on mesh {shape} differs from world 1 "
                     f"on {r['differ']}")
            log(f"sharded ranks: rank {rank} mesh {shape}: == world 1 on every array; "
                + ", ".join(f"{k} {v:.2f} s" for k, v in r["seconds"].items()))
        log(f"sharded ranks: rank {rank} peak device memory {peak:.2f} GiB")
    tmp.cleanup()
    if launches != [0, 0]:
        fail(f"sharded ranks: the ranks launched a hand-written kernel: {launches}")
    phase_s = time.perf_counter() - t_phase
    SERVE_SUMMARY.append(f"sharded 4 ranks {phase_s:.1f} s")
    log(f"sharded ranks: {SHARD_RANKS} gloo ranks on one card, meshes {SHARD_MESHES}, "
        f"gloo collectives on CUDA tensors (nothing staged through the host): "
        f"spawn to join {ranks_s:.2f} s; launches packed_dir_allow {launches[0]}, "
        f"fused_ports_reach {launches[1]}; {phase_s:.2f} s; {smi}")
    return tuple(launches)


# ---------------------------------------------------------------------------
# phases 30-32: the serving engines on a mesh, and the datalog backend
# ---------------------------------------------------------------------------

#: phase 31: phase 29's cluster and ranks (4 processes share the card)
MESH_ENGINE_MESHES = [(4, 1), (2, 2), (1, 4)]
MESH_ENGINE_TIMEOUT_S = 300
#: BASELINE config 3: 10k pods / 1k policies, multi-namespace +
#: namespaceSelector (any-port: port bitmaps are config 4's)
CONFIG3 = dict(n_pods=10_000, n_policies=1_000, n_namespaces=20, seed=0)


def _mesh_stream(cluster, ref_eng, ports: bool, rng) -> list:
    """Phases 30-31's scripted diff stream, one op of each kind at least,
    as ``(method, args)`` pairs chosen on ``ref_eng`` (every engine of the
    phase holds the same host state, so the same pairs apply to each): a
    policy add, update and remove (for the ports engine copies that leave
    their segments free rows), pod relabels to another pod's labels and to
    unseen pairs, three pod removes, a new namespace with two pods added
    into it and one more elsewhere (the tombstones reused: no pod-axis
    grow), its relabel, its pods' removal and the namespace's."""
    import dataclasses

    import kubernetes_verification_tpu_torch as kvt

    pols = list(cluster.policies)
    order = iter(rng.permutation(len(pols)))
    ops = []
    while True:
        p = dataclasses.replace(pols[next(order)], name="mesh-add-0")
        if not ports or _fits(ref_eng, p, {}):
            ops.append(("add_policy", (p,)))
            break
    while True:
        tgt, src = pols[next(order)], pols[next(order)]
        p = dataclasses.replace(tgt, ingress=src.ingress, egress=src.egress,
                                policy_types=src.policy_types)
        if not ports or _fits(ref_eng, p, ref_eng._pol_rows[ref_eng._key(tgt)]):
            ops.append(("update_policy", (p,)))
            break
    gone = pols[next(order)]
    ops.append(("remove_policy", (gone.namespace, gone.name)))
    live = ref_eng.active_indices()
    a, b, c = (int(i) for i in rng.choice(live, 3, replace=False))
    ops.append(("update_pod_labels", (a, dict(ref_eng.pods[c].labels))))
    ops.append(("update_pod_labels", (b, {"mesh": "unseen", "app": "alpha"})))
    victims = [ref_eng.pods[int(i)] for i in rng.choice(live, 3, replace=False)]
    ops += [("remove_pod", (p.namespace, p.name)) for p in victims]
    ns = cluster.namespaces
    ops.append(("add_namespace", (kvt.Namespace("mesh-ns", dict(ns[3].labels)),)))
    ported = [p for p in cluster.pods if p.container_ports] if ports else []
    for k, space in enumerate(("mesh-ns", "mesh-ns", ns[5].name)):
        donor = cluster.pods[int(rng.integers(len(cluster.pods)))]
        cports = dict(ported[int(rng.integers(len(ported)))].container_ports) if ported else {}
        ops.append(("add_pod", (kvt.Pod(f"mesh-pod-{k}", space, dict(donor.labels),
                                        ip=donor.ip, container_ports=cports),)))
    ops.append(("update_namespace_labels", ("mesh-ns", dict(ns[7].labels))))
    ops += [("remove_pod", ("mesh-ns", f"mesh-pod-{k}")) for k in range(2)]
    ops.append(("remove_namespace", ("mesh-ns",)))
    return ops


def _state_digests(state) -> dict:
    """sha256 of each array of a ``state_dict()`` (the ports engine's
    ``(arrays, meta)``: the meta as sorted JSON)."""
    import hashlib

    import numpy as np

    meta = None
    if isinstance(state, tuple):
        state, meta = state
    out = {k: hashlib.sha256(np.ascontiguousarray(np.asarray(v)).tobytes()).hexdigest()
           for k, v in state.items()}
    if meta is not None:
        out["__meta__"] = hashlib.sha256(json.dumps(meta, sort_keys=True).encode()).hexdigest()
    return out


def _same_states(a, b) -> list:
    """The keys on which two ``state_dict()``s differ (digests compared)."""
    da, db = _state_digests(a), _state_digests(b)
    return sorted(k for k in set(da) | set(db) if da.get(k) != db.get(k))


def mesh_engine_phase(cluster, mesh, dev, smi: str) -> tuple:
    """Phase 30: both serving engines on a ``(1, 1)`` NCCL mesh at the
    flagship, uncut, against the one-device engines after every op of the
    same stream; the any-port engine matrix-free too; a mesh checkpoint
    resumed on one device. Returns the launches of the mesh engines'
    calls (the one-device builds, which launch the kernels, excluded)."""
    import os
    import tempfile

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.ops.bits import to_host_words
    from kubernetes_verification_tpu_torch.ops.closure import _fit_tile
    from kubernetes_verification_tpu_torch.utils import persist

    t_phase = time.perf_counter()
    launches = [0, 0]
    tmp = tempfile.TemporaryDirectory(prefix="kvt-mesh-engine-")
    for ports in (False, True):
        tag = "ports mesh engine" if ports else "mesh engine"
        cls = kvt.PackedPortsIncrementalVerifier if ports else kvt.PackedIncrementalVerifier
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        one = cls(cluster, device=dev)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        reset_counts()
        kw = {} if ports else {"keep_matrix": True}
        t0 = time.perf_counter()
        eng = cls(cluster, mesh=mesh, **kw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        log(f"{tag}: one-device build {one_s:.2f} s; mesh {mesh.shape} build {build_s:.2f} s ("
            + ", ".join(f"{k} {v:.2f} s" for k, v in eng.build_timings.items())
            + f"; the packed words by dst sub-stripes of {eng._shards.step()} columns), Np "
            f"{eng._n_padded}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
        if not torch.equal(eng._packed, one._packed):
            fail(f"{tag}: the mesh build's words differ from the one-device build's")
        ops = _mesh_stream(cluster, one, ports, np.random.default_rng(30))
        mf = None
        if not ports:
            t0 = time.perf_counter()
            mf = cls(cluster, mesh=mesh, keep_matrix=False)
            torch.cuda.synchronize()
            log(f"{tag}: matrix-free mesh build {time.perf_counter() - t0:.2f} s")
        lat: dict = {}
        for method, args in ops:
            _timed(lat, method, lambda: getattr(eng, method)(*args))
            getattr(one, method)(*args)
            if mf is not None:
                getattr(mf, method)(*args)
            if not torch.equal(eng._packed, one._packed):
                fail(f"{tag}: the words differ from the one-device engine's after {method}")
        log(f"{tag}: {len(ops)} ops, the words == the one-device engine's after every op; "
            + ", ".join(f"{k} {statistics.median(v) * 1e3:.1f} ms"
                        + (f" (x{len(v)})" if len(v) > 1 else "") for k, v in lat.items())
            + " (host clock after a device sync)")
        if mf is not None:
            width = _fit_tile(mf._n_padded, 4352)
            t0 = time.perf_counter()
            swept = 0
            for d0, words in mf.sweep_dirty(width):
                if not _engine_words_equal(one, words, d0):
                    fail(f"{tag}: matrix-free sweep_dirty stripe {d0} differs")
                swept += 1
            sweep_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            whole = mf.solve_stripe(0, mf._n_padded)
            stripe_s = time.perf_counter() - t0
            if not np.array_equal(whole, to_host_words(one._packed[: one.n_pods])):
                fail(f"{tag}: matrix-free solve_stripe(0, Np) differs from the one-device words")
            log(f"{tag}: matrix-free: sweep_dirty({width}) {swept} stripes {sweep_s:.2f} s, "
                f"solve_stripe(0, {mf._n_padded}) {stripe_s:.2f} s == the one-device words")
            del mf, whole
        path = os.path.join(tmp.name, "ports" if ports else "any")
        save = persist.save_ports_incremental if ports else persist.save_packed_incremental
        load = persist.load_ports_incremental if ports else persist.load_packed_incremental
        t0 = time.perf_counter()
        save(eng, path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load(path, device=dev)
        load_s = time.perf_counter() - t0
        differ = _same_states(eng.state_dict(), back.state_dict())
        differ += _same_states(one.state_dict(), back.state_dict())
        if differ:
            fail(f"{tag}: the mesh checkpoint resumed on one device differs on {differ}")
        launches = [a + b for a, b in zip(launches, launch_counts())]
        log(f"{tag}: mesh checkpoint {save_s:.2f} s, resumed on one device {load_s:.2f} s: "
            f"its state == the mesh engine's == the one-device engine's, bit for bit; "
            f"launches of the mesh calls packed_dir_allow {launch_counts()[0]}, "
            f"fused_ports_reach {launch_counts()[1]}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
        del one, eng, back
        torch.cuda.empty_cache()
    tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    SERVE_SUMMARY.append(f"mesh engines world 1 {phase_s:.1f} s")
    log(f"mesh engines: {phase_s:.2f} s; {smi}")
    return tuple(launches)


def _mesh_engine_run(mesh, ports: bool, cluster, ops_fn, save=None, resume=None) -> tuple:
    """Phase 31's work on one mesh: an engine built (or resumed from
    ``resume``) on ``mesh``, the stream applied; the state digests after
    the build and each op, and the seconds."""
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.utils import persist

    cls = kvt.PackedPortsIncrementalVerifier if ports else kvt.PackedIncrementalVerifier
    t0 = time.perf_counter()
    if resume is not None:
        load = persist.load_ports_incremental if ports else persist.load_packed_incremental
        eng = load(resume, mesh=mesh)
        return [_state_digests(eng.state_dict())], {"resume": time.perf_counter() - t0}
    kw = {} if ports else {"keep_matrix": True}
    eng = cls(cluster, mesh=mesh, **kw)
    secs = {"build": time.perf_counter() - t0}
    digests = [_state_digests(eng.state_dict())]
    t0 = time.perf_counter()
    for method, args in ops_fn(eng):
        getattr(eng, method)(*args)
        digests.append(_state_digests(eng.state_dict()))
    secs["ops"] = time.perf_counter() - t0
    if save is not None:
        (persist.save_ports_incremental if ports else persist.save_packed_incremental)(eng, save)
    return digests, secs


def _mesh_engine_inputs():
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt

    cluster = kvt.random_cluster(kvt.GeneratorConfig(**SHARD_SMALL))
    return cluster, lambda ports: (lambda eng: _mesh_stream(
        cluster, eng, ports, np.random.default_rng(31)))


def _mesh_engine_rank(rank: int, port: int, workdir: str, device: str = "cuda:0") -> None:
    """One of phase 31's ranks (spawned): both engines on each mesh, their
    gathered state after every op held against the world-1 digests the
    parent wrote; the (2, 2) checkpoint resumed at (4, 1)."""
    import torch.distributed as dist

    from kubernetes_verification_tpu_torch.parallel.mesh import init_distributed, mesh_for

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_distributed(f"tcp://127.0.0.1:{port}", SHARD_RANKS, rank, backend="gloo",
                     device=dev)
    with open(f"{workdir}/world1.json") as fh:
        ref = json.load(fh)
    cluster, ops_fn = _mesh_engine_inputs()
    report = {}
    for ports in (False, True):
        kind = "ports" if ports else "any"
        for shape in MESH_ENGINE_MESHES:
            mesh = mesh_for(shape, device=dev, backend="gloo")
            ck = f"{workdir}/ck-{kind}" if shape == (2, 2) else None
            digests, secs = _mesh_engine_run(mesh, ports, cluster, ops_fn(ports), save=ck)
            differ = [i for i, (a, b) in enumerate(zip(digests, ref[kind])) if a != b]
            report[f"{kind} {shape}"] = dict(differ=differ, n=len(digests), seconds=secs)
        digests, secs = _mesh_engine_run(mesh_for((4, 1), device=dev, backend="gloo"), ports,
                                         cluster, None, resume=f"{workdir}/ck-{kind}")
        report[f"{kind} (2, 2) -> (4, 1)"] = dict(
            differ=[0] if digests[0] != ref[kind][-1] else [], n=1, seconds=secs)
    report["launches"] = list(launch_counts())
    report["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                          if dev.type == "cuda" else 0.0)
    with open(f"{workdir}/rank{rank}.json", "w") as fh:
        json.dump(report, fh)
    dist.destroy_process_group()


def mesh_engine_ranks_phase(smi: str, device: str = "cuda:0") -> tuple:
    """Phase 31: four gloo ranks on the one card (as phase 29), both
    engines on the meshes (4, 1), (2, 2) and (1, 4) at phase 29's 8,192
    pods / 820 policies: every rank's gathered state after the build and
    every op == the world-1 NCCL engines' (digests of every array), and the
    (2, 2) checkpoints resumed at (4, 1) == their final state. Returns the
    ranks' launches."""
    import os
    import socket
    import tempfile

    import torch.multiprocessing as mp

    import kubernetes_verification_tpu_torch as kvt

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="kvt-mesh-ranks-")
    cluster, ops_fn = _mesh_engine_inputs()
    ref, secs = {}, {}
    reset_counts()
    for ports in (False, True):
        kind = "ports" if ports else "any"
        ref[kind], secs[kind] = _mesh_engine_run(kvt.mesh_for(), ports, cluster, ops_fn(ports))
    parent = launch_counts()
    with open(os.path.join(tmp.name, "world1.json"), "w") as fh:
        json.dump(ref, fh)
    log(f"mesh engine ranks: world-1 reference at {SHARD_SMALL['n_pods']} pods / "
        f"{SHARD_SMALL['n_policies']} policies, {len(ref['any']) - 1} ops: "
        + ", ".join(f"{k} " + ", ".join(f"{a} {b:.2f} s" for a, b in v.items())
                    for k, v in secs.items()))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    ctx = mp.start_processes(_mesh_engine_rank, args=(port, tmp.name, device),
                             nprocs=SHARD_RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_ENGINE_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                fail(f"mesh engine ranks: the {SHARD_RANKS} ranks did not finish in "
                     f"{MESH_ENGINE_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    ranks_s = time.perf_counter() - t0
    launches = list(parent)
    for rank in range(SHARD_RANKS):
        with open(os.path.join(tmp.name, f"rank{rank}.json")) as fh:
            report = json.load(fh)
        launches = [a + b for a, b in zip(launches, report.pop("launches"))]
        peak = report.pop("peak_gib")
        for what, r in report.items():
            if r["differ"]:
                fail(f"mesh engine ranks: rank {rank} {what} differs from world 1 after "
                     f"ops {r['differ']}")
            if rank == 0:
                log(f"mesh engine ranks: {what}: {r['n']} states == world 1; "
                    + ", ".join(f"{k} {v:.2f} s" for k, v in r["seconds"].items()))
        log(f"mesh engine ranks: rank {rank} peak device memory {peak:.2f} GiB")
    tmp.cleanup()
    phase_s = time.perf_counter() - t_phase
    SERVE_SUMMARY.append(f"mesh engines 4 ranks {phase_s:.1f} s")
    log(f"mesh engine ranks: {SHARD_RANKS} gloo ranks on one card, meshes "
        f"{MESH_ENGINE_MESHES}, every rank's state == world 1 after every op, the (2, 2) "
        f"checkpoints resumed at (4, 1); spawn to join {ranks_s:.2f} s; launches "
        f"packed_dir_allow {launches[0]}, fused_ports_reach {launches[1]}; "
        f"{phase_s:.2f} s; {smi}")
    return tuple(launches)


def datalog_phase(dev, smi: str) -> tuple:
    """Phase 32: ``verify(backend="datalog")`` on the card (torch einsum
    rules in fp32) at BASELINE config 3 == ``verify(backend="torch")`` on
    every field, and the kano program at ``random_kano(10,000, 1,000)`` ==
    ``verify_kano(backend="torch")``. Returns the datalog calls'
    launches."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**CONFIG3))
    cfg = dict(compute_ports=False, backend_options=(("device", str(dev)),))
    reset_counts()
    t0 = time.perf_counter()
    got = kvt.verify(cluster, kvt.VerifyConfig(backend="datalog", **cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = kvt.verify(cluster, kvt.VerifyConfig(backend="torch", **cfg))
    for f in ("reach", "selected", "src_sets", "dst_sets", "ingress_isolated",
              "egress_isolated"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            fail(f"datalog: {f} differs from the torch backend's")
    log(f"datalog: verify(backend='datalog') at {CONFIG3['n_pods']} pods / "
        f"{CONFIG3['n_policies']} policies, {CONFIG3['n_namespaces']} namespaces: {wall:.2f} s "
        f"(program build {got.timings['encode']:.2f} s, solve {got.timings['solve']:.2f} s), "
        f"{int(got.reach.sum())} pairs, peak device memory {peak:.2f} GiB: reach, selected, "
        f"src/dst sets and isolation == the torch backend's; {smi}")
    containers, policies = kvt.random_kano(10_000, 1_000, seed=0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    kgot = kvt.verify_kano(containers, policies, kvt.VerifyConfig(
        backend="datalog", backend_options=cfg["backend_options"]))
    torch.cuda.synchronize()
    kwall = time.perf_counter() - t0
    launches = tuple(a + b for a, b in zip(launches, launch_counts()))
    kwant = kvt.verify_kano(*kvt.random_kano(10_000, 1_000, seed=0), kvt.VerifyConfig(
        backend="torch", backend_options=cfg["backend_options"]))
    for f in ("reach", "src_sets", "dst_sets"):
        if not np.array_equal(getattr(kgot, f), getattr(kwant, f)):
            fail(f"datalog: the kano program's {f} differs from verify_kano's")
    log(f"datalog: kano program at 10,000 containers / 1,000 policies {kwall:.2f} s "
        f"(program build {kgot.timings['encode']:.2f} s, solve {kgot.timings['solve']:.2f} s), "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB: reach and "
        f"src/dst sets == verify_kano(backend='torch'); launches packed_dir_allow "
        f"{launches[0]}, fused_ports_reach {launches[1]}; {time.perf_counter() - t_phase:.2f} s; {smi}")
    return launches


def native_phase(dev, smi: str) -> None:
    """Phase 33: the ``native`` backend (host C++, OpenMP) at BASELINE
    config 3 any-port with ``closure=True``, at phase 8's cluster with port
    semantics, and on ``random_kano(10,000, 1,000)``: every field equals
    ``verify(backend="torch")`` on the card. No hand-written kernel launches
    in the native calls."""
    import numpy as np

    import kubernetes_verification_tpu_torch as kvt

    if "native" not in kvt.available_backends():
        fail("native: the backend is not registered (no C++ compiler?)")
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    card = (("device", str(dev)),)
    fields = ("reach", "reach_ports", "closure", "selected", "src_sets", "dst_sets",
              "ingress_isolated", "egress_isolated")
    runs = []
    for tag, gen, flags in (
        ("config 3", CONFIG3, dict(compute_ports=False, closure=True)),
        ("phase 8's cluster with ports", VERIFY, dict(compute_ports=True)),
    ):
        cluster = kvt.random_cluster(kvt.GeneratorConfig(**gen))
        reset_counts()
        t0 = time.perf_counter()
        got = kvt.verify(cluster, kvt.VerifyConfig(backend="native", **flags))
        native_s = time.perf_counter() - t0
        if launch_counts() != (0, 0):
            fail(f"native: {tag}: the native call launched {launch_counts()}")
        t0 = time.perf_counter()
        want = kvt.verify(cluster, kvt.VerifyConfig(backend="torch", backend_options=card,
                                                    **flags))
        torch_s = time.perf_counter() - t0
        for f in fields:
            g, w = getattr(got, f), getattr(want, f)
            if (g is None) != (w is None) or (g is not None and not np.array_equal(g, w)):
                fail(f"native: {tag}: {f} differs from the torch backend's")
        runs.append(f"{tag} ({gen['n_pods']} pods / {gen['n_policies']} policies): native "
                    f"{native_s:.2f} s, torch {torch_s:.2f} s, {int(got.reach.sum())} pairs")
    containers, policies = kvt.random_kano(KANO["n_containers"], KANO["n_policies"],
                                           seed=KANO["seed"])
    reset_counts()
    t0 = time.perf_counter()
    got = kvt.verify_kano(containers, policies, kvt.VerifyConfig(backend="native"))
    native_s = time.perf_counter() - t0
    if launch_counts() != (0, 0):
        fail(f"native: kano: the native call launched {launch_counts()}")
    t0 = time.perf_counter()
    want = kvt.verify_kano(containers, policies,
                           kvt.VerifyConfig(backend="torch", backend_options=card))
    torch_s = time.perf_counter() - t0
    for f in ("reach", "src_sets", "dst_sets"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            fail(f"native: kano: {f} differs from verify_kano(backend='torch')")
    runs.append(f"kano ({KANO['n_containers']} containers / {KANO['n_policies']} policies): "
                f"native {native_s:.2f} s, torch {torch_s:.2f} s")
    log("native: " + "; ".join(runs) + "; every field == the torch backend's on the card, "
        f"0 hand-kernel launches in the native calls; {time.perf_counter() - t_phase:.2f} s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")


def observe_phase(any_enc, ports_enc, bound_rows, fused_row, dev, smi: str) -> None:
    """Phase 34 (right after phase 7, on phases 4 and 6's encodings): the
    sentinel suite on the card (``run_calibration``: each chain's median,
    spread, MACs/s and ``calibrated``, the dispatch probe); introspection on
    for one any-port and one port-bitmap flagship solve, whose published
    ``packed_dir_allow`` / ``fused_ports_reach`` reports give, through
    ``introspect.analytic_bound``, phase 5 and 7's bounds to 0.1 ms; the
    cost table; ``memory_snapshot`` lists ``cuda:0`` at
    ``torch.cuda.memory_allocated(0)``; a span under
    ``install_span_memory_hook`` carries the memory fields."""
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.observe import (
        introspect,
        sentinel,
        spans,
        telemetry,
        trace,
    )

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ctx = sentinel.run_calibration(dev)
    if ctx["platform"] != "gpu" or ctx["device"] != torch.cuda.get_device_name(0):
        fail(f"observe: the calibration ran on {ctx['platform']} / {ctx['device']}")
    for name, k in ctx["kernels"].items():
        log(f"observe: sentinel {name} {k['config']}: median {k['median_s'] * 1e3:.3f} ms, "
            f"spread {k['spread_pct']:.2f} % (bound {ctx['max_spread_pct_bound']:g} %), "
            + (f"{k['macs_per_s'] / 1e12:.1f} T MACs/s, " if k["macs_per_run"] else "")
            + f"calibrated {k['calibrated']}; {smi}")
    log(f"observe: dispatch probe (a launch and .item()) median "
        f"{ctx['dispatch_s'] * 1e6:.1f} us, min {ctx['dispatch_min_s'] * 1e6:.1f} us; "
        f"calibrated peak {ctx['calibrated_peak_macs_per_s'] / 1e12:.1f} T MACs/s; {smi}")

    introspect.clear_reports()
    introspect.set_introspection(True)
    try:
        for enc in (any_enc, ports_enc):
            kvt.tiled_k8s_reach(enc, device=dev, fetch=False)
        torch.cuda.synchronize()
    finally:
        introspect.set_introspection(False)
    reps = {r.fn: r for r in introspect.reports() if r.engine == "cuda"}
    for name, phase, want in (("packed_dir_allow", 5, bound_rows[0]["bound_ms"]),
                              ("fused_ports_reach", 7, fused_row["bound_ms"])):
        rep = reps.get(name)
        if rep is None or rep.source != "analytic" or rep.platform != "gpu":
            fail(f"observe: no analytic card report of {name}: {rep}")
        secs, by = introspect.analytic_bound(rep.flops, rep.bytes_accessed,
                                             torch.cuda.get_device_name(0))
        if abs(1e3 * secs - want) > 0.1:
            fail(f"observe: {name}'s report gives a {1e3 * secs:.2f} ms bound, phase "
                 f"{phase} printed {want:.2f} ms")
        log(f"observe: {name} report: {rep.flops:.4e} operations, {rep.bytes_accessed:.4e} "
            f"bytes, bound {1e3 * secs:.2f} ms ({by}) == phase {phase}'s {want:.2f} ms")
    log("observe: cost table of the two solves:\n" + introspect.format_cost_table())
    introspect.clear_reports()

    snap = telemetry.memory_snapshot()
    allocated = torch.cuda.memory_allocated(0)
    card = [e for e in snap if e["device"] == "cuda:0"]
    if not card or card[0]["bytes_in_use"] != allocated:
        fail(f"observe: memory_snapshot {snap} does not list cuda:0 at {allocated} bytes")
    log("observe: memory_snapshot:\n" + telemetry.format_memory_table(snap))
    telemetry.install_span_memory_hook()
    try:
        with trace("chip_smoke_memory_probe") as sp:
            probe_t = torch.empty(1 << 20, dtype=torch.int32, device=dev)
        del probe_t
    finally:
        spans.set_memory_hook(None)
    if not ("mem_enter_bytes" in sp.attrs and "mem_exit_bytes" in sp.attrs):
        fail(f"observe: the span carries no memory fields: {sp.attrs}")
    log(f"observe: a traced span carries mem_enter_bytes {sp.attrs['mem_enter_bytes']} and "
        f"mem_exit_bytes {sp.attrs['mem_exit_bytes']}; {time.perf_counter() - t_phase:.2f} s, "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")


def _words_digest(eng) -> str:
    import hashlib

    words = eng._packed[: eng.n_pods].cpu().numpy()
    return f"{tuple(words.shape)}:{hashlib.sha256(words.tobytes()).hexdigest()}"


def warm_child(ck: str, log_path: str, build_dir: str, out: str) -> int:
    """Phase 35's child: with an empty kernel build directory and no
    ``nvcc``, recover phase 22's checkpoint directory (installing its warm
    pack), answer a full resync and a probe batch, and write what it
    counted to ``out``."""
    import os

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from kubernetes_verification_tpu_torch.observe import aot
    from kubernetes_verification_tpu_torch.ops import cuda_build
    from kubernetes_verification_tpu_torch.serve import QueryEngine, RecoveryManager
    from kubernetes_verification_tpu_torch.serve.events import FullResync

    cuda_build.BUILD_DIR = build_dir  # empty: nothing built in this process
    if os.listdir(build_dir) or cuda_build.nvcc_version() is not None:
        fail("warm child: the build directory is not empty or nvcc is reachable")
    reset_counts()
    res = RecoveryManager(ck).recover(log_path=log_path, device=dev)
    torch.cuda.synchronize()
    recover_s = time.perf_counter() - t_start
    svc = res.service
    t0 = time.perf_counter()
    svc.apply([FullResync(cluster=svc.engine.as_cluster())])
    probes = query_mix(svc.engine.pods, 35)[0]
    answers = QueryEngine(svc).can_reach_batch(probes)
    torch.cuda.synchronize()
    first_answer_s = time.perf_counter() - t_start
    with open(out, "w") as fh:
        json.dump({
            "hits": aot.hit_total(), "misses": aot.miss_total(),
            "nvcc_runs": cuda_build.counts()["nvcc_runs"],
            "launches": list(launch_counts()),
            "digest": _words_digest(svc.engine),
            "answers": int(answers.sum()), "recover_s": recover_s,
            "resync_s": time.perf_counter() - t0, "first_answer_s": first_answer_s,
            "built": sorted(os.listdir(build_dir)),
        }, fh)
    return 0


def warm_start_phase(ctx: dict, build_s: float, dev, smi: str) -> int:
    """Phase 35 (right after phase 25, on phase 22's checkpoint directory
    and WAL): the pack phase 22's ``CheckpointManager`` shipped lists both
    libraries under this environment; a child process with an empty build
    directory, no ``nvcc`` on its ``PATH`` and ``CUDA_HOME`` at an empty
    directory recovers the directory (hits 2, misses 0, ``nvcc`` runs 0),
    answers a full resync whose words equal the leader's (exactly 2
    ``packed_dir_allow`` launches) and a probe batch; ``inspect`` and a
    replica's ``/healthz`` report the pack present with ``env_match``.
    Returns the child's ``packed_dir_allow`` launches."""
    import os
    import tempfile

    from kubernetes_verification_tpu_torch.observe import aot
    from kubernetes_verification_tpu_torch.serve import (
        RecoveryManager,
        ReplicationClient,
        ReplicationServer,
    )

    t_phase = time.perf_counter()
    ck, log_path, leader = ctx["ck"], ctx["log"], ctx["svc"]
    status = aot.pack_status(aot.pack_dir(ck))
    if not (status["present"] and status["env_match"] and status["corrupt"] == 0
            and status["libraries"] == ["fused_ports_reach", "packed_dir_allow"]):
        fail(f"warm start: phase 22's pack is not both libraries of this environment: "
             f"{status}")
    inspected = RecoveryManager(ck).inspect(log_path=log_path)["aot_pack"]
    with ReplicationServer(ck, log_path, port=0) as server:
        health = ReplicationClient(server.url, timeout=30.0).healthz()["aot"]
    for tag, report in (("inspect", inspected), ("/healthz", health)):
        if not (report["present"] and report["env_match"]):
            fail(f"warm start: {tag} reports the pack {report}")
    want = _words_digest(leader.engine)
    scratch = tempfile.TemporaryDirectory(prefix="kvt-warm-")
    build_dir = os.path.join(scratch.name, "build")
    empty_cuda = os.path.join(scratch.name, "no-cuda")
    os.makedirs(build_dir)
    os.makedirs(empty_cuda)
    env = dict(os.environ, CUDA_HOME=empty_cuda, PATH=os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc"))))
    out = os.path.join(scratch.name, "child.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--warm-child", ck, log_path,
         build_dir, out],
        env=env, capture_output=True, text=True, timeout=600,
    )
    child_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"warm start: the child exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
             f"{proc.stderr[-4000:]}")
    with open(out) as fh:
        got = json.load(fh)
    scratch.cleanup()
    if (got["hits"], got["misses"], got["nvcc_runs"]) != (2, 0, 0):
        fail(f"warm start: the child counted hits {got['hits']}, misses {got['misses']}, "
             f"nvcc runs {got['nvcc_runs']}")
    if got["launches"] != [2, 0]:
        fail(f"warm start: the child launched {got['launches']}, not packed_dir_allow twice")
    if got["digest"] != want:
        fail(f"warm start: the child's resync words {got['digest']} != the leader's {want}")
    log(f"warm start: child (no nvcc, empty build directory) loaded both libraries from "
        f"the pack (hits {got['hits']:.0f}, misses {got['misses']:.0f}, nvcc runs "
        f"{got['nvcc_runs']}), recovered in {got['recover_s']:.2f} s from its start, "
        f"answered a full resync ({got['launches'][0]} packed_dir_allow launches, words == "
        f"the leader's) and 4,096 probes in {got['resync_s']:.2f} s: first answer "
        f"{got['first_answer_s']:.2f} s after its start ({child_wall:.2f} s of process "
        f"wall) beside phase 2's nvcc build of {build_s:.1f} s; inspect and /healthz: pack "
        f"present, env_match; {time.perf_counter() - t_phase:.2f} s; {smi}")
    SERVE_SUMMARY.append(
        f"phase 35 warm start: first answer {got['first_answer_s']:.2f} s after the "
        f"child's start with 0 nvcc runs (phase 2's build {build_s:.1f} s)")
    return got["launches"][0]


#: phase 36: the served stream's length (phase 22's first events; cut from
#: 64 for the phase's time) and the query batch (phase 22's mix)
CLI_EVENTS = 32
CLI_PROBES = 4096


def words_reference(words, n: int, pairs: int, ing_iso, eg_iso) -> dict:
    """A flagship solve as phase 36 holds the CLI's checkpoints against it:
    the sha256 of its host words over the real pods and columns (no words
    stay on the card), its reachable pairs and isolation counts."""
    import hashlib

    import numpy as np

    host = words[:n, : -(-n // 32)].contiguous().cpu().numpy()
    return {
        "digest": hashlib.sha256(host.tobytes()).hexdigest(),
        "reachable_pairs": int(pairs),
        "ingress_isolated": int(np.count_nonzero(np.asarray(ing_iso)[:n])),
        "egress_isolated": int(np.count_nonzero(np.asarray(eg_iso)[:n])),
    }


def _cli(argv) -> tuple:
    """One in-process ``kv-tpu-torch`` run: (exit code, standard output)."""
    import contextlib
    import io

    from kubernetes_verification_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(argv))
    return rc, buf.getvalue()


def cli_phase(refs: dict, dev, smi: str) -> tuple:
    """Phase 36: the command line at full width on the card, through
    ``kubernetes_verification_tpu_torch.cli.main``. Phase 4's cluster goes to
    JSON manifests (``generate`` cannot set ``p_ipblock_peer`` or
    ``min_selector_labels``); both launch counters are set to 0 just before
    each step and read just after. ``snapshot`` with port bitmaps (one
    ``fused_ports_reach`` launch) and ``--no-ports`` (two ``packed_dir_allow``)
    print phase 6's and phase 4's aggregates, and their checkpoints load on
    the card with those words (sha256); ``diff`` (a new policy, a pod
    removed) launches no kernel, its ``before`` is the any-port snapshot's
    and its ``after`` pairs are ``verify --backend sharded-packed`` of the
    changed manifests; ``serve`` (phase 22's first 32 events, its populated
    relabels cut) builds the packed service (two launches) and snapshots it,
    and ``query --from-snapshot --batch`` of 4,096 probes of phase 22's mix
    answers the snapshot's words; ``warmup`` packs both built libraries.
    Then the console entry in a child process, without ``--device``, at
    phase 8's size: ``verify`` (with and without port bitmaps) prints the
    in-process ``--device cpu`` answer with ``"backend": "torch"``, and
    ``backends`` prints ``available_backends()``. Returns the launches of
    the in-process steps."""
    import dataclasses
    import hashlib
    import os
    import tempfile

    import numpy as np

    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.ingest.yaml_io import _dump_cluster_json
    from kubernetes_verification_tpu_torch.serve.events import write_events
    from kubernetes_verification_tpu_torch.utils.persist import (
        load_packed_incremental,
        load_ports_incremental,
    )

    t_phase = time.perf_counter()
    scratch = tempfile.TemporaryDirectory(prefix="kvt-cli-")
    path = lambda *p: os.path.join(scratch.name, *p)  # noqa: E731
    t0 = time.perf_counter()
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**MAIN))
    _dump_cluster_json(cluster, path("main"))
    log(f"cli: phase 4's cluster written as JSON manifests in "
        f"{time.perf_counter() - t0:.2f} s")
    total = [0, 0]
    times = {}

    def step(name: str, argv: list, want: tuple) -> dict:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        rc, out = _cli(argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"cli {name}: {secs:.2f} s, peak memory {peak:.1f} GiB, packed_dir_allow "
            f"launches {launches[0]}, fused_ports_reach launches {launches[1]}")
        if rc != 0:
            fail(f"cli {name}: exit {rc}: {out[-2000:]}")
        if launches != want:
            fail(f"cli {name}: launched {launches}, not {want}")
        total[0] += launches[0]
        total[1] += launches[1]
        times[name] = secs
        return json.loads(out.strip().splitlines()[-1])

    def digest(eng) -> str:
        n = eng.n_pods
        host = eng._packed[:n, : -(-n // 32)].contiguous().cpu().numpy()
        return hashlib.sha256(host.tobytes()).hexdigest()

    aggregates = ("reachable_pairs", "ingress_isolated", "egress_isolated")
    # a. snapshot, port bitmaps (the default engine): one fused_ports_reach
    snap = step("snapshot", ["snapshot", path("main"), path("ck-ports"), "--json"], (0, 1))
    for key in aggregates:
        if snap[key] != refs["ports"][key]:
            fail(f"cli snapshot: {key} {snap[key]} != phase 6's {refs['ports'][key]}")
    eng = load_ports_incremental(path("ck-ports"), device=dev)
    if digest(eng) != refs["ports"]["digest"]:
        fail("cli snapshot: the checkpoint's words differ from phase 6's")
    del eng
    # b. snapshot --no-ports: packed_dir_allow twice
    snap = step("snapshot --no-ports",
                ["snapshot", path("main"), path("ck-any"), "--no-ports", "--json"], (2, 0))
    for key in aggregates:
        if snap[key] != refs["any"][key]:
            fail(f"cli snapshot --no-ports: {key} {snap[key]} != phase 4's {refs['any'][key]}")
    eng = load_packed_incremental(path("ck-any"), device=dev)
    if digest(eng) != refs["any"]["digest"]:
        fail("cli snapshot --no-ports: the checkpoint's words differ from phase 4's")
    del eng
    log("cli: both checkpoints' words == phases 6 and 4 (sha256), aggregates equal")
    # c. diff: one new policy, one pod removed; no hand-written kernel
    added = dataclasses.replace(cluster.policies[0], name="cli-added",
                                ingress=cluster.policies[1].ingress)
    victim = cluster.pods[5]
    _dump_cluster_json(kvt.Cluster(policies=[added]), path("delta"))
    diff = step("diff", ["diff", path("ck-any"), "--apply", path("delta"), "--remove",
                         f"pod/{victim.namespace}/{victim.name}", "--json"], (0, 0))
    want_before = {k: snap[k] for k in diff["before"]}
    if diff["before"] != want_before:
        fail(f"cli diff: before {diff['before']} != the snapshot's {want_before}")
    if [op for op, _ in diff["ops"]] != ["add-policy", "remove-pod"]:
        fail(f"cli diff: ops {diff['ops']}")
    changed = kvt.Cluster(
        pods=[p for p in cluster.pods if p is not victim],
        namespaces=list(cluster.namespaces),
        policies=list(cluster.policies) + [added],
    )
    _dump_cluster_json(changed, path("changed"))
    del changed
    one_shot = step("verify --backend sharded-packed",
                    ["verify", path("changed"), "--backend", "sharded-packed", "--no-ports",
                     "--json"], (0, 0))
    if diff["after"]["reachable_pairs"] != one_shot["reachable_pairs"]:
        fail(f"cli diff: after {diff['after']['reachable_pairs']} pairs != the sharded "
             f"verify's {one_shot['reachable_pairs']}")
    log(f"cli diff: {diff['before']['reachable_pairs']} -> "
        f"{diff['after']['reachable_pairs']} pairs == verify --backend sharded-packed of "
        f"the changed manifests")
    # d. serve phase 22's first events, then query its snapshot
    events = random_event_stream(cluster, n_events=256 + 2 * SERVE_TAIL, seed=1)
    stream, cut = cut_populated_relabels(events[:256], cluster)
    write_events(stream[:CLI_EVENTS], path("events.jsonl"))
    served = step("serve", ["serve", path("main"), "--events", path("events.jsonl"),
                            "--snapshot-out", path("snap"), "--json"], (2, 0))
    if served["events_seen"] != CLI_EVENTS or served["pods"] != MAIN["n_pods"]:
        fail(f"cli serve: {served['events_seen']} events seen, {served['pods']} pods")
    # the snapshot's words read on the host; its slots are the manifests'
    # pods in order (the stream adds and removes none)
    with np.load(path("snap", "state.npz")) as z:
        host, active = z["packed"], z["pod_active"]
    if not (active.shape == (len(cluster.pods),) and active.all()):
        fail("cli serve: the snapshot's slots are not the manifests' pods")
    probes, s_idx, d_idx, ported = query_mix(cluster.pods, 0, CLI_PROBES)
    bits = ((host[s_idx, d_idx // 32] >> (d_idx % 32).astype(np.uint32)) & 1) > 0
    del host
    with open(path("probes.jsonl"), "w") as fh:
        for pr in probes:
            obj = {"src": pr[0], "dst": pr[1]}
            if len(pr) > 2:
                obj.update(port=pr[2], protocol=pr[3])
            fh.write(json.dumps(obj) + "\n")
    answered = step("query", ["query", "--from-snapshot", path("snap"), "--batch",
                              path("probes.jsonl"), "--json"], (0, 0))
    ans = np.array([r["allowed"] for r in answered["batch"]["results"]])
    if ans.shape != bits.shape or not np.array_equal(ans[~ported], bits[~ported]):
        fail("cli query: the any-port answers differ from the snapshot's words")
    if (ans[ported] & ~bits[ported]).any():
        fail("cli query: a port-refined probe is allowed where the words deny it")
    log(f"cli serve: {served['reachable_pairs']} pairs after {CLI_EVENTS} events ({cut} "
        f"populated relabels cut from phase 22's stream); query: {int(ans.sum())} of "
        f"{CLI_PROBES} allowed, the any-port answers == the snapshot's words")
    # e. warmup packs both built libraries
    packed = step("warmup", ["warmup", path("main"), "--out", path("pack"), "--json"], (2, 0))
    if packed["libraries"] != ["fused_ports_reach", "packed_dir_allow"]:
        fail(f"cli warmup: the pack holds {packed['libraries']}")
    scratch.cleanup()
    del cluster, events, stream

    # the console entry in a child process: no JAX, the card by default
    scratch = tempfile.TemporaryDirectory(prefix="kvt-cli8-")
    v8 = os.path.join(scratch.name, "v8")
    root = os.path.dirname(os.path.abspath(__file__))
    rc, _ = _cli(["generate", v8, "--pods", str(VERIFY["n_pods"]), "--policies",
                  str(VERIFY["n_policies"]), "--namespaces", str(VERIFY["n_namespaces"]),
                  "--seed", str(VERIFY["seed"])])
    if rc != 0:
        fail(f"cli generate: exit {rc}")
    # the three children run at once, beside the in-process --device cpu runs
    entry = [sys.executable, "-m", "kubernetes_verification_tpu_torch.cli"]
    variants = ((), ("--no-ports",))
    t0 = time.perf_counter()
    children = [subprocess.Popen(entry + argv, cwd=root, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for argv in [["verify", v8, "--json", *f] for f in variants] + [["backends"]]]
    try:
        wants = []
        for flags in variants:
            rc, out = _cli(["verify", v8, "--json", "--device", "cpu", *flags])
            if rc != 0:
                fail(f"cli verify {flags} --device cpu: exit {rc}")
            wants.append(json.loads(out))
        done = [child.communicate(timeout=300) for child in children]
    finally:
        for child in children:
            if child.poll() is None:
                child.kill()
    secs = time.perf_counter() - t0
    for flags, want, child, (out, err) in zip(variants, wants, children, done):
        if child.returncode != 0:
            fail(f"cli verify {flags}: the child exited {child.returncode}: {err[-2000:]}")
        got = json.loads(out.strip().splitlines()[-1])
        if got["backend"] != "torch":
            fail(f"cli verify {flags}: the child ran backend {got['backend']}")
        got.pop("timings"), want.pop("timings")
        if got != want:
            fail(f"cli verify {flags}: the child's answer differs from --device cpu")
    # this process also holds the fault wrappers phase 27 registered
    registered = [b for b in kvt.available_backends() if not b.startswith("faulty:")]
    if children[-1].returncode != 0 or done[-1][0].split() != registered:
        fail(f"cli backends: exit {children[-1].returncode}, {done[-1][0].split()} != "
             f"{registered}")
    log(f"cli: verify with and without port bitmaps and backends in child processes "
        f"without --device: {secs:.2f} s of process wall for the three, backend torch, "
        f"== --device cpu ({wants[0]['reachable_pairs']} / {wants[1]['reachable_pairs']} "
        f"pairs); backends == available_backends()")
    scratch.cleanup()
    log(f"cli: phase 36 {time.perf_counter() - t_phase:.2f} s (snapshot "
        f"{times['snapshot']:.2f} / {times['snapshot --no-ports']:.2f} s, diff "
        f"{times['diff']:.2f} s, serve {times['serve']:.2f} s, query "
        f"{times['query']:.2f} s, warmup {times['warmup']:.2f} s); {smi}")
    SERVE_SUMMARY.append(
        f"phase 36 cli: snapshot {times['snapshot']:.2f} / "
        f"{times['snapshot --no-ports']:.2f} s, diff {times['diff']:.2f} s, serve "
        f"{times['serve']:.2f} s, query {times['query']:.2f} s")
    return tuple(total)


def lint_phase(smi: str) -> tuple:
    """Phase 37: ``kv-tpu-torch lint``'s headless driver over the port's
    package, and its catalog check, each in a child process on the card's
    host. Both must exit 0; the lint's JSON must report no finding. Host
    wall times only: linting reads source and runs no device code."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    mod = "kubernetes_verification_tpu_torch.analysis"
    reset_counts()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", mod, "--format", "json", "--no-cache"],
        capture_output=True, text=True, cwd=root, timeout=600,
    )
    lint_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"lint: exit {proc.returncode}\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    try:
        result = json.loads(proc.stdout)
    except ValueError:
        fail(f"lint: no JSON result: {proc.stdout[-2000:]!r}")
    if not result.get("ok") or result.get("findings"):
        fail(f"lint: findings {result.get('findings')}")
    t0 = time.perf_counter()
    docs = subprocess.run(
        [sys.executable, "-m", mod, "--check-docs",
         os.path.join("kubernetes_verification_tpu_torch", "LINTS.md")],
        capture_output=True, text=True, cwd=root, timeout=120,
    )
    docs_s = time.perf_counter() - t0
    if docs.returncode != 0:
        fail(f"lint --check-docs: exit {docs.returncode}: {docs.stdout} {docs.stderr}")
    launches = launch_counts()
    if launches != (0, 0):
        fail(f"lint: a hand-written kernel ran: {launches}")
    log(f"lint: {len(result['findings'])} findings, {result['grandfathered']} "
        f"grandfathered, {result['suppressed']} suppressed inline over "
        f"{sum(sum(v.values()) for v in result['counts'].values())} counted sites; "
        f"the lint child {lint_s:.2f} s and the catalog check {docs_s:.2f} s of "
        f"host wall time on this machine (no device code); launches "
        f"packed_dir_allow 0, fused_ports_reach 0; {smi}")
    SERVE_SUMMARY.append(f"phase 37 lint: {lint_s:.2f} s host wall, "
                         f"{result['grandfathered']} grandfathered")
    return launches


#: phase 38: the port's benchmark entry point, one child process per run, in
#: stages run one after another; a stage's lanes run at once, a lane's
#: children one after another. The first stage runs beside phases 36-37
#: (the script's 1,200 s limit leaves no room for it after them): the
#: flagship runs (100,000 pods / 10,000 policies, uncut) in two lanes, so
#: that at most two of them (13-22 GiB each) share the card beside phase
#: 36, and the other modes at the JAX bench's default sizes with
#: --repeats 2 in the third. posture, whose 5 % budget is a timing gate,
#: runs alone after it. The serving modes are cut for the time limit:
#: serve and replicate to 512 events, stripes to 256, posture to 4,096
#: pods / 512 policies / 1,024 events (at 2,048 / 256 / 512 an apply was
#: ~0.5 s and one apply of a batch differed from its pair's by up to 45 %
#: on the host's jitter, which a 5 % budget over 6 batch pairs cannot
#: resolve; at 4,096 / 512 a ~2 s apply's pairs differ by ~10 %, over 15
#: pairs). ingress is not run here: its open-loop generator sometimes
#: offers less than its multiple of capacity (ROADMAP §3 F7).
BENCH_STAGES = [
    [
        [["--mode", "closure"], ["--mode", "tiled"]],
        [["--mode", "headtohead", "--repeats", "3"], ["--mode", "tiled", "--no-ports"],
         ["--mode", "incremental"], ["--mode", "stripe", "--repeats", "2"],
         ["--mode", "sentinel"]],
        [["--mode", "k8s", "--repeats", "2"], ["--mode", "kano", "--repeats", "2"],
         ["--mode", "serve", "--repeats", "2", "--n-events", "512"],
         ["--mode", "query", "--repeats", "2"],
         ["--mode", "stripes", "--repeats", "2", "--n-events", "256"],
         ["--mode", "replicate", "--repeats", "2", "--n-events", "512"]],
    ],
    [
        [["--mode", "posture", "--repeats", "2", "--pods", "4096", "--policies", "512",
          "--n-events", "1024"]],
    ],
]
BENCH_TIMEOUT_S = 600
#: the launches a run of a flagship mode must show, at least: (packed_dir_allow,
#: fused_ports_reach); the other modes' are counted, not required
BENCH_MIN_LAUNCHES = {
    ("tiled", True): (2, 0), ("tiled", False): (0, 1),
    ("headtohead", False): (0, 1), ("incremental", False): (0, 1),
    ("closure", False): (2, 0),
}


def _bench_lane(runs, env, root: str, device_args, results: list, procs: list) -> None:
    """One lane of phase 38: its children one after another (a thread)."""
    for argv in runs:
        cmd = [sys.executable, "-m", "kubernetes_verification_tpu_torch.bench",
               *argv, *device_args]
        t0 = time.perf_counter()
        child = subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        procs.append(child)
        try:
            out, err = child.communicate(timeout=BENCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            child.kill()
            out, err = child.communicate()
        results.append((argv, child.returncode, out, err, time.perf_counter() - t0))


def _bench_stage(ctx: dict, stage) -> list:
    """Start one stage's lanes (threads); returns them."""
    import threading

    threads = [threading.Thread(target=_bench_lane, daemon=True, args=(
        lane, ctx["env"], ctx["root"], ctx["device_args"], ctx["results"], ctx["procs"]))
        for lane in stage]
    for t in threads:
        t.start()
    return threads


def bench_start(stages=None, device_args=()) -> dict:
    """Phase 38's first stage, started in the background (it runs beside
    phases 36-37); ``bench_phase`` waits for it and runs the rest."""
    import os
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="kvt-bench-")
    hist = os.path.join(tmp.name, "history.jsonl")
    env = dict(os.environ, KVTPU_BENCH_HISTORY=hist)
    env.pop("KVTPU_BENCH_NO_SENTINEL", None)
    ctx = {"tmp": tmp, "hist": hist, "env": env, "results": [], "procs": [],
           "root": os.path.dirname(os.path.abspath(__file__)),
           "device_args": list(device_args), "t0": time.perf_counter(),
           "stages": BENCH_STAGES if stages is None else stages}
    ctx["threads"] = _bench_stage(ctx, ctx["stages"][0])
    return ctx


def bench_stop(ctx: dict) -> None:
    """End every child phase 38 started that still runs."""
    for child in ctx["procs"]:
        if child.poll() is None:
            child.kill()


def bench_phase(ctx: dict, refs: dict, kind: str, smi: str) -> tuple:
    """Phase 38: ``python -m kubernetes_verification_tpu_torch.bench`` in
    child processes on the card (``BENCH_STAGES``: stages one after
    another, a stage's lanes at once, a lane's children one after
    another; ``bench_start`` started the first), with
    ``KVTPU_BENCH_HISTORY`` in a temporary directory. Fails on a child's
    non-zero exit, a record whose ``device`` is not the card's name or
    without ``sentinel``, a record with a cold first call but no
    ``compile_warm_s``, a ``warm_parity`` false, a ``tiled`` run whose
    reachable pairs differ from phase 4's / 6's or whose solve did not run
    the hand-written kernel (``kernel=`` in its log), a ``headtohead``
    whose ``kernels`` do not name ``fused_ports_reach`` and the torch
    sweep, a flagship run with fewer launches than ``BENCH_MIN_LAUNCHES``,
    or a history that ``observe/history.py::load_runs`` cannot read.
    Prints each run's seconds, peak device memory and launches (each
    child's ``bench-summary``). Returns the children's launches, summed."""
    import re

    from kubernetes_verification_tpu_torch.observe.history import load_runs

    t_wait = time.perf_counter()
    try:
        for t in ctx["threads"]:
            t.join()
        log(f"bench: the first stage ended {time.perf_counter() - ctx['t0']:.2f} s after "
            f"its start beside phases 36-37, {time.perf_counter() - t_wait:.2f} s after "
            f"phase 37")
        for stage in ctx["stages"][1:]:
            for t in _bench_stage(ctx, stage):
                t.join()
    finally:
        bench_stop(ctx)
    results, stages, hist, tmp = ctx["results"], ctx["stages"], ctx["hist"], ctx["tmp"]
    total = [0, 0]
    n_records = 0
    for argv, rc, out, err, wall in sorted(results, key=lambda r: r[0]):
        name = " ".join(argv)
        if rc != 0:
            fail(f"bench {name}: exit {rc}\n{out[-2000:]}\n{err[-4000:]}")
        summary = [ln for ln in err.splitlines() if ln.startswith("bench-summary ")]
        if not summary:
            fail(f"bench {name}: no bench-summary line")
        summ = json.loads(summary[-1].split(" ", 1)[1])
        launches = (summ["launches"]["packed_dir_allow"], summ["launches"]["fused_ports_reach"])
        total[0] += launches[0]
        total[1] += launches[1]
        records = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
        if not records:
            fail(f"bench {name}: no record")
        n_records += len(records)
        mode, any_port = argv[1], "--no-ports" in argv
        for rec in records:
            if rec.get("device") != kind or "sentinel" not in rec:
                fail(f"bench {name}: device {rec.get('device')!r}, sentinel "
                     f"{'sentinel' in rec} in {rec['metric']!r}")
            if "compile_cold_s" in rec and "compile_warm_s" not in rec:
                fail(f"bench {name}: {rec['metric']!r} has no compile_warm_s")
            if rec.get("warm_parity", True) is not True:
                fail(f"bench {name}: warm_parity false in {rec['metric']!r}")
        want = BENCH_MIN_LAUNCHES.get((mode, any_port))
        if want is not None and (launches[0] < want[0] or launches[1] < want[1]):
            fail(f"bench {name}: launched {launches}, fewer than {want}")
        if mode == "tiled":
            ref = refs["any" if any_port else "ports"]["reachable_pairs"]
            pairs = {int(m) for m in re.findall(r"(\d+) reachable pairs", err)}
            route = set(re.findall(r"kernel=(\S+)", err))
            if pairs != {ref}:
                fail(f"bench {name}: reachable pairs {pairs} != phase {4 if any_port else 6}'s {ref}")
            if route != {"packed_dir_allow" if any_port else "fused_ports_reach"}:
                fail(f"bench {name}: the solve ran {route}")
            if records[0].get("warm_parity") is not True:
                fail(f"bench {name}: no warm_parity")
        if mode == "headtohead" and records[0]["kernels"] != {
                "torch": "torch-sweep" if any_port else "torch-ports-sweep",
                "kernel": "packed_dir_allow" if any_port else "fused_ports_reach"}:
            fail(f"bench {name}: kernels {records[0]['kernels']}")
        peak = summ["peak_device_bytes"]
        head = records[0]
        band = head.get("band") or head.get("batch_band") or head.get("sync_band") or {}
        log(f"bench {name}: {wall:.2f} s of process wall ({summ['seconds']:.2f} s in the "
            f"mode), peak device memory "
            f"{'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}, launches "
            f"packed_dir_allow {launches[0]}, fused_ports_reach {launches[1]}, nvcc runs "
            f"{summ['nvcc_runs']}; {len(records)} records, first {head['metric']!r} = "
            f"{head['value']} {head['unit']}"
            + (f" (median {band['median_s']} s, {band['min_s']}-{band['max_s']} s, n "
               f"{band['n']})" if band else ""))
    runs = load_runs([hist])
    if len(runs) != n_records:
        fail(f"bench: the history holds {len(runs)} runs, the children printed {n_records}")
    tmp.cleanup()
    secs = time.perf_counter() - ctx["t0"]
    log(f"bench: {len(results)} runs in {sum(map(len, stages))} lanes over {len(stages)} "
        f"stages, {n_records} records, history "
        f"read back by load_runs; launches packed_dir_allow {total[0]}, fused_ports_reach "
        f"{total[1]}; phase 38 {secs:.2f} s from the first stage's start, "
        f"{time.perf_counter() - t_wait:.2f} s after phase 37; {smi}")
    SERVE_SUMMARY.append(f"phase 38 bench: {len(results)} runs, {secs:.2f} s")
    return tuple(total)


# ---------------------------------------------------------------------------
# phase 39: graft_entry's entry points
# ---------------------------------------------------------------------------

#: phase 39: dryrun_multichip's ranks, all on the one card (gloo over CUDA
#: tensors, as phase 29), at the reference's stage sizes
GRAFT_RANKS = 4
GRAFT_TIMEOUT_S = 600


def graft_start() -> dict:
    """Phase 39's child, started in the background beside phases 36-37:
    ``python -m kubernetes_verification_tpu_torch.graft_entry 4`` (its four
    ranks are its own children); ``graft_phase`` waits for it."""
    import os
    import tempfile

    tmp = tempfile.TemporaryDirectory(prefix="kvt-graft-")
    out = open(os.path.join(tmp.name, "out.log"), "w")
    err = open(os.path.join(tmp.name, "err.log"), "w")
    cmd = [sys.executable, "-m", "kubernetes_verification_tpu_torch.graft_entry",
           str(GRAFT_RANKS)]
    root = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.Popen(cmd, cwd=root, stdout=out, stderr=err, text=True,
                             start_new_session=True)
    return {"tmp": tmp, "files": (out, err), "child": child, "t0": time.perf_counter()}


def graft_stop(ctx: dict) -> None:
    """End phase 39's child and its ranks if they still run."""
    import os
    import signal

    if ctx["child"].poll() is None:
        os.killpg(ctx["child"].pid, signal.SIGKILL)
        ctx["child"].wait()


def graft_entry_check(dev) -> None:
    """``entry()`` on the card (its default) against ``entry(device="cpu")``:
    every argument and every ``K8sOut`` field equal, bit for bit."""
    import dataclasses

    from kubernetes_verification_tpu_torch.graft_entry import entry

    t0 = time.perf_counter()
    fn, args = entry()
    fn_c, args_c = entry(device="cpu")

    def leaves(x):
        if dataclasses.is_dataclass(x):
            return [v for f in dataclasses.fields(x) for v in leaves(getattr(x, f.name))]
        return [] if x is None else [x]

    for a, c in zip(args, args_c):
        for x, y in zip(leaves(a), leaves(c)):
            if x.device.type != "cuda" or not torch.equal(x.cpu(), y):
                fail("graft: entry()'s arguments are not the CPU's on the card")
    out, ref = fn(*args), fn_c(*args_c)
    torch.cuda.synchronize(dev)
    differ = [f for f in out._fields if not torch.equal(getattr(out, f).cpu(), getattr(ref, f))]
    if differ:
        fail(f"graft: entry() on the card differs from the CPU's in {differ}")
    log(f"graft: entry() on {dev} == entry(device='cpu') in all {len(out._fields)} K8sOut "
        f"fields (reach {tuple(out.reach.shape)}, reach_ports {tuple(out.reach_ports.shape)}), "
        f"{time.perf_counter() - t0:.2f} s")


def graft_phase(ctx: dict, dev, smi: str) -> tuple:
    """Phase 39: ``entry()`` on the card against ``entry(device="cpu")``
    (counted), then the child ``graft_start`` started: every one of the
    eleven ``dryrun_multichip OK`` lines, the ranks' reports (each stage's
    seconds, each rank's peak device memory, launches), a zero exit within
    ``GRAFT_TIMEOUT_S``. Returns the launches of both kernels, the child's
    ranks' included (0 / 0: the mesh paths' products are ``bool_dot``, the
    forward step the dense torch path)."""
    t_wait = time.perf_counter()
    try:
        reset_counts()
        graft_entry_check(dev)
        launches = list(launch_counts())
        child = ctx["child"]
        try:
            child.wait(timeout=max(1.0, GRAFT_TIMEOUT_S - (time.perf_counter() - ctx["t0"])))
        except subprocess.TimeoutExpired:
            graft_stop(ctx)
            fail(f"graft: dryrun_multichip({GRAFT_RANKS}) did not end in {GRAFT_TIMEOUT_S} s")
    finally:
        graft_stop(ctx)
        for fh in ctx["files"]:
            fh.close()
    wall = time.perf_counter() - ctx["t0"]
    with open(ctx["files"][0].name) as fh:
        out = fh.read()
    with open(ctx["files"][1].name) as fh:
        err = fh.read()
    ctx["tmp"].cleanup()
    if child.returncode != 0:
        fail(f"graft: dryrun_multichip({GRAFT_RANKS}) exit {child.returncode}\n"
             f"{out[-3000:]}\n{err[-6000:]}")
    ok = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip OK: ")]
    summ = [ln for ln in out.splitlines() if ln.startswith("dryrun_multichip summary ")]
    if len(ok) != 11 or not summ:
        fail(f"graft: {len(ok)} of 11 OK lines, {len(summ)} summary\n{out[-3000:]}")
    for ln in ok:
        log(f"graft: {ln}")
    summary = json.loads(summ[-1].split(" ", 2)[2])
    if len(summary["ranks"]) != GRAFT_RANKS:
        fail(f"graft: {len(summary['ranks'])} rank reports")
    for r in summary["ranks"]:
        launches = [a + b for a, b in zip(launches, r["launches"])]
        live = r["live"]
        log(f"graft: rank {r['rank']} on {r['device']}: stage seconds "
            + ", ".join(f"{k} {v:.2f}" for k, v in r["seconds"].items())
            + f"; peak device {r['peak_device_gib']:.2f} GiB, peak host "
            f"{r['peak_host_gib']:.2f} GiB; live {live['live_bytes'] / 2**20:.1f} MiB "
            f"at the end (dense [N, N] int32 {live['dense_bytes'] / 2**30:.0f} GiB)")
    log(f"graft: dryrun_multichip({GRAFT_RANKS}) on mesh {summary['mesh']}: "
        f"{summary['seconds']:.2f} s inside the child, ended within {wall:.2f} s of its "
        f"start, {time.perf_counter() - t_wait:.2f} s waited; launches packed_dir_allow "
        f"{launches[0]}, fused_ports_reach {launches[1]}; {smi}")
    SERVE_SUMMARY.append(f"phase 39 graft: {wall:.2f} s")
    return tuple(launches)


def main() -> int:
    if sys.argv[1:2] == ["--warm-child"]:
        return warm_child(*sys.argv[2:6])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    kind, smi = probe()
    build_s = build()
    worst = kernel_small(dev)
    worst_fused = fused_small(dev)

    import kubernetes_verification_tpu_torch as kvt

    t1 = time.perf_counter()
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**MAIN))
    log(f"main: generate {time.perf_counter() - t1:.2f} s")
    any_enc = encode_main(cluster, compute_ports=False)
    launches, reach = main_path(any_enc, dev)
    cli_refs = {"any": words_reference(
        reach.packed, any_enc.n_pods, reach.timings["reachable_pairs"],
        reach.ingress_isolated, reach.egress_isolated)}
    torch.cuda.empty_cache()
    rows = kernel_full(any_enc, dev, smi)
    torch.cuda.empty_cache()
    enc = encode_main(cluster, compute_ports=True)
    torch.cuda.reset_peak_memory_stats()
    fused_launches, ports_words, cli_refs["ports"] = ports_path(enc, dev)
    torch.cuda.empty_cache()
    fused_row = fused_full(enc, dev, smi)
    torch.cuda.empty_cache()
    observe_phase(any_enc, enc, rows, fused_row, dev, smi)
    del enc
    torch.cuda.empty_cache()
    verify_phase(dev)
    masks = pair_masks_phase(cluster, any_enc, dev, smi)
    closed_words = closure_phase(reach, smi)
    main_words = reach.packed  # phase 14's build is held against them
    del reach
    # phases 28-29 (the sharded paths) count their launches from here
    reset_counts()
    sharded_phase(cluster, any_enc, main_words, ports_words, closed_words, masks, dev, smi)
    del any_enc, closed_words, masks
    torch.cuda.empty_cache()
    sharded_launches = tuple(
        a + b for a, b in zip(launch_counts(), sharded_ranks_phase(smi)))
    torch.cuda.empty_cache()
    # phases 30-32 (this slice) count the mesh engines' and datalog's calls
    mesh_engine_launches = mesh_engine_phase(cluster, kvt.mesh_for(), dev, smi)
    torch.cuda.empty_cache()
    mesh_engine_launches = tuple(
        a + b for a, b in zip(mesh_engine_launches, mesh_engine_ranks_phase(smi)))
    torch.cuda.empty_cache()
    mesh_engine_launches = tuple(
        a + b for a, b in zip(mesh_engine_launches, datalog_phase(dev, smi)))
    torch.cuda.empty_cache()
    native_phase(dev, smi)
    torch.cuda.empty_cache()
    delta_phase(dev)
    kano_phase(dev, smi)
    card_vs_cpu_phase(dev)
    engine_launches, eng = engine_phase(cluster, main_words, dev, smi)
    posture_phase(eng, dev, smi)
    del eng
    torch.cuda.empty_cache()
    serve_launches, replica_ctx = serve_packed_phase(cluster, main_words, dev, smi)
    del main_words
    # phases 25-27 (this slice's path) count their launches from here
    reset_counts()
    replicated_phase(replica_ctx, dev, smi)
    replica_launches = launch_counts()
    warm_launches = warm_start_phase(replica_ctx, build_s, dev, smi)
    replica_ctx["tmp"].cleanup()
    del replica_ctx
    torch.cuda.empty_cache()
    engine_card_vs_cpu_phase(dev)
    torch.cuda.empty_cache()
    ports_engine_launches = ports_engine_phase(cluster, ports_words, dev, smi)
    del cluster, ports_words
    torch.cuda.empty_cache()
    ports_engine_card_vs_cpu_phase(dev)
    torch.cuda.empty_cache()
    dense_launches = dense_engine_phase(dev, smi)
    torch.cuda.empty_cache()
    dense_card_vs_cpu_phase(dev)
    cpu_oracle_phase(dev)
    torch.cuda.empty_cache()
    dense_cluster, dense_svc, dense_stream = serve_dense_phase(dev, smi)
    reset_counts()
    stripe_phase(dense_cluster, dense_svc, dense_stream, dev, smi)
    replica_launches = tuple(a + b for a, b in zip(replica_launches, launch_counts()))
    del dense_cluster, dense_svc, dense_stream
    torch.cuda.empty_cache()
    serve_card_vs_cpu_phase(dev)
    torch.cuda.empty_cache()
    reset_counts()
    transport_build = transport_phase(dev, smi)
    replica_launches = tuple(a + b for a, b in zip(replica_launches, launch_counts()))
    if replica_launches[0] < transport_build or replica_launches[1] != 0:
        fail(f"phases 25-27 launched {replica_launches}: packed_dir_allow fewer than the "
             f"transport leader's {transport_build} build launches, or fused_ports_reach")
    torch.cuda.empty_cache()
    # phase 38's first stage and phase 39's child (its own ranks, counted
    # from 0) run in child processes beside phases 36-37; phase 39 ends
    # before phase 38's rest, whose posture budget is a timing gate
    bench = bench_start()
    graft = graft_start()
    try:
        cli_launches = cli_phase(cli_refs, dev, smi)
        lint_launches = lint_phase(smi)
        graft_launches = graft_phase(graft, dev, smi)
    except BaseException:
        bench_stop(bench)
        graft_stop(graft)
        raise
    torch.cuda.empty_cache()
    bench_launches = bench_phase(bench, cli_refs, kind, smi)
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
        "engine_build_launches": engine_launches,
        "dense_check_launches": dense_launches,
        "serve_build_launches": serve_launches,
        "replica_launches": replica_launches[0],
        "sharded_launches": sharded_launches[0],
        "mesh_engine_launches": mesh_engine_launches[0],
        "warm_start_launches": warm_launches,
        "cli_launches": cli_launches[0],
        "lint_launches": lint_launches[0],
        "bench_launches": bench_launches[0],
        "graft_launches": graft_launches[0],
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
        "engine_build_launches": ports_engine_launches,
        "replica_launches": replica_launches[1],
        "sharded_launches": sharded_launches[1],
        "mesh_engine_launches": mesh_engine_launches[1],
        "cli_launches": cli_launches[1],
        "lint_launches": lint_launches[1],
        "bench_launches": bench_launches[1],
        "graft_launches": graft_launches[1],
        "max_abs_err": worst_fused,
        **{k: fused_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
    }]}
    log("serve summary: " + "; ".join(SERVE_SUMMARY) + f"; {smi}")
    log(f"total: {time.perf_counter() - t0:.1f} s; packed_dir_allow: per-launch "
        f"means of the two directions; {smi}")
    if sharded_launches != (0, 0):
        fail(f"phases 28-29 launched a hand-written kernel: {sharded_launches}")
    if mesh_engine_launches != (0, 0):
        fail(f"phases 30-32 launched a hand-written kernel: {mesh_engine_launches}")
    if graft_launches != (0, 0):
        fail(f"phase 39 launched a hand-written kernel: {graft_launches}")
    import torch.distributed as dist

    dist.destroy_process_group()  # phase 28's world-1 group
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
