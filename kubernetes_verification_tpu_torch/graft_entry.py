"""Entry points of the port — the counterpart of the root
``__graft_entry__.py``.

``entry(device=None)``          — the single-card forward step over the
                                  flagship semantics (full-k8s reachability,
                                  ``ops/reach.py::k8s_reach``) plus example
                                  arguments (the encoded kubesv paper
                                  scenario, ``models/fixtures.py``).
``dryrun_multichip(n_devices)`` — ``n_devices`` gloo ranks on a ``(pods,
                                  grants)`` mesh run the reference's eleven
                                  sharded stages (verify, packed solves, the
                                  1M-pod stripe, the mesh engines, pair
                                  masks, closures, a 250,000-pod follower),
                                  each held against the ``cpu`` oracle or the
                                  one-device path.

Run it as ``python -m kubernetes_verification_tpu_torch.graft_entry [n
[device]]`` (``n`` defaults to 8, as in the reference, and ``device`` to
the card); on the CPU, ``... graft_entry 2 cpu`` or
``dryrun_multichip(n, device="cpu")``.

The JAX function is one process with ``n`` virtual XLA CPU devices under
one controller. Here it is SPMD: the caller spawns ``n`` rank processes
(start method ``spawn``), each joins one gloo group and calls every stage
with the same arguments; rank ``r`` sits on ``cuda:(r % device_count)`` (gloo
over CUDA tensors when ranks share a card, as a one-card host must) or on
the CPU. Each stage's checks come after its last collective, and any
failing rank fails the whole run: the caller kills the other ranks and
raises.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import os
import socket
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .runtime import resolve_device

__all__ = ["entry", "dryrun_multichip"]

#: the gloo collectives' timeout of a rank. The JAX function raises XLA's CPU
#: collective terminate timeout to 900 s for the 1M-pod stage's long
#: collective-free stretch (its XLA-flag probe has no counterpart here):
#: the same slack, given to the process group instead.
GLOO_TIMEOUT_S = 900.0
#: how long the caller waits for every rank before it kills them
RANK_DEADLINE_S = 1500.0

_OK = "dryrun_multichip OK: "


def entry(device=None):
    """Return ``(fn, example_args)`` with ``fn(*example_args)`` the
    single-card forward verification step (a ``K8sOut``). The arguments are
    the eleven ``EncodedCluster`` fields of the kubesv paper example
    (``compute_ports=True``) as tensors on ``device`` (default ``cuda``;
    ``BackendError`` without a GPU, no CPU fallback). The JAX ``fn`` is meant
    for ``jax.jit``; this one runs eagerly, as every torch op here does."""
    from .backends.device import _put
    from .encode.encoder import encode_cluster
    from .models.fixtures import kubesv_paper_example
    from .ops.match import as_tensors
    from .ops.reach import k8s_reach

    dev = resolve_device(device)
    put = _put(dev)
    enc = encode_cluster(kubesv_paper_example(), compute_ports=True)
    fn = functools.partial(
        k8s_reach,
        self_traffic=True,
        default_allow_unselected=True,
        direction_aware_isolation=True,
    )
    example_args = (
        put(enc.pod_kv),
        put(enc.pod_key),
        put(enc.pod_ns),
        put(enc.ns_kv),
        put(enc.ns_key),
        as_tensors(enc.pol_sel, dev),
        put(enc.pol_ns),
        put(enc.pol_affects_ingress),
        put(enc.pol_affects_egress),
        as_tensors(enc.ingress, dev),
        as_tensors(enc.egress, dev),
    )
    return fn, example_args


# ---------------------------------------------------------------------------
# the stages' sizes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every stage's sizes; the defaults are the reference's."""

    #: stage 1: the sharded dense verify with closure
    verify_gen: tuple = (("n_pods", 19), ("n_policies", 7), ("n_namespaces", 2), ("seed", 42))
    #: stages 2, 3, 5, 8: the packed sharded cluster and its sweep
    packed_gen: tuple = (("n_pods", 61), ("n_policies", 11), ("n_namespaces", 3), ("seed", 43))
    packed_tile: int = 32
    packed_chunk: int = 8
    #: stages 4 and 6: the base cluster tiled out
    base_gen: tuple = (("n_pods", 2000), ("n_policies", 24), ("n_namespaces", 4),
                       ("p_ipblock_peer", 0.0), ("min_selector_labels", 1), ("seed", 44))
    stripe_reps: int = 500  # 2,000 × 500 = 1M pods
    stripe_tile: int = 256
    stripe_chunk: int = 128
    engine_reps: int = 125  # 2,000 × 125 = 250k pods
    engine_width: int = 256
    #: stage 7: the port-bitmap engine's cluster
    ports_gen: tuple = (("n_pods", 47), ("n_policies", 8), ("n_namespaces", 3),
                        ("p_ports", 0.8), ("p_named_port", 0.3),
                        ("p_container_ports", 0.5), ("seed", 46))
    ports_closure_tile: int = 64
    #: stage 9: the closures
    closure_n: int = 4096
    closure_degree: float = 24.0
    closure_seed: int = 45
    closure_tile: int = 1024
    odd_n: int = 1000
    odd_tile: int = 256
    #: stage 10: the bounded path query
    hops: int = 2
    bfs_chunk: int = 256
    #: stage 11: the follower's probes, and the live bytes' bound as a
    #: share of one dense [N, N] int32 (a claim of scale: the engine's
    #: O(N·slots) state is under 1 % of N² only at the reference's N)
    probes: int = 512
    probe_seed: int = 47
    live_fraction: float = 0.01


def _gen(items):
    from .harness.generate import GeneratorConfig, random_cluster

    return random_cluster(GeneratorConfig(**dict(items)))


def _shape(mesh) -> Tuple[int, int]:
    from .parallel.mesh import GRANT_AXIS, POD_AXIS

    return mesh.shape[POD_AXIS], mesh.shape[GRANT_AXIS]


def _eq(got, want, what: str) -> None:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def _dev_opt(mesh) -> tuple:
    return (("device", str(mesh.device)),)


def _words_u32(words) -> np.ndarray:
    """Packed words (an int32 tensor or host uint32) as host uint32."""
    if isinstance(words, torch.Tensor):
        return words.cpu().numpy().view(np.uint32)
    return np.asarray(words)


def _pod_rows(cluster) -> np.ndarray:
    """A cluster's pods in order as JSON rows ``[namespace, name, labels]``."""
    return np.array([json.dumps([p.namespace, p.name, p.labels], sort_keys=True)
                     for p in cluster.pods])


class Context(dict):
    """What the stages share: the inputs built once (the packed cluster,
    the base cluster) and what an earlier stage leaves for a later one (stage
    6's engine and pattern for stages 10 and 11)."""

    def __init__(self, sizes: Sizes, workdir: str) -> None:
        super().__init__()
        self.sizes = sizes
        self.workdir = workdir

    def cluster(self, key: str):
        if key not in self:
            self[key] = _gen(getattr(self.sizes, key + "_gen"))
        return self[key]


# ---------------------------------------------------------------------------
# the eleven stages: ``stage(mesh, ctx) -> (ok line, arrays)``. Every rank
# calls each with the same arguments; its checks come after its last
# collective, so a failing check never leaves another rank waiting in one.
# ---------------------------------------------------------------------------


def stage_sharded_verify(mesh, ctx: Context):
    """1: the dense ``sharded`` backend with closure == the cpu oracle."""
    from .backends.base import VerifyConfig, verify
    from .backends.sharded import ShardedBackend

    cluster = _gen(ctx.sizes.verify_gen)
    dp, mp = _shape(mesh)
    cfg = VerifyConfig(backend="sharded", closure=True,
                       backend_options=(("mesh", (dp, mp)),) + _dev_opt(mesh))
    res = ShardedBackend(mesh).verify(cluster, cfg)
    ref = verify(cluster, VerifyConfig(backend="cpu", closure=True))
    _eq(res.reach, ref.reach, "sharded reach")
    _eq(res.closure, ref.closure, "sharded closure")
    return (f"mesh {dp}x{mp} (pods×grants), {cluster.n_pods} pods, "
            f"{len(cluster.policies)} policies, reach+closure == cpu oracle",
            {"reach": res.reach, "closure": res.closure})


def _packed_solve(mesh, ctx: Context, ports: bool):
    from .backends.base import VerifyConfig, verify
    from .encode.encoder import encode_cluster
    from .parallel.packed_sharded import sharded_packed_reach

    cluster = ctx.cluster("packed")
    enc = encode_cluster(cluster, compute_ports=ports)
    got = sharded_packed_reach(mesh, enc, tile=ctx.sizes.packed_tile,
                               chunk=ctx.sizes.packed_chunk, keep_matrix=True)
    ref = verify(cluster, VerifyConfig(backend="cpu", compute_ports=ports))
    reach = got.to_bool()
    _eq(reach, ref.reach, "packed sharded reach")
    return enc, got, reach, ref


def stage_packed_solve(mesh, ctx: Context):
    """2: the packed sharded solve, words and both degrees == the oracle."""
    _, got, reach, ref = _packed_solve(mesh, ctx, ports=False)
    _eq(got.out_degree, ref.reach.sum(axis=1), "out_degree")
    _eq(got.in_degree, ref.reach.sum(axis=0), "in_degree")
    return (f"packed sharded solve == cpu oracle ({got.n_pods} pods, matrix + aggregates)",
            {"reach": reach, "out_degree": got.out_degree, "in_degree": got.in_degree})


def stage_packed_ports(mesh, ctx: Context):
    """3: the same engine with port bitmaps == the oracle."""
    enc, _, reach, _ = _packed_solve(mesh, ctx, ports=True)
    return (f"packed sharded PORT solve == cpu oracle ({len(enc.atoms)} port atoms)",
            {"reach": reach})


def stage_million_stripe(mesh, ctx: Context):
    """4: the base cluster's pod encoding tiled out to 1M pods, ONE dst
    stripe of the packed sharded sweep, matrix-free."""
    from .encode.encoder import encode_cluster
    from .parallel.packed_sharded import sharded_packed_reach

    s = ctx.sizes
    enc_base = encode_cluster(ctx.cluster("base"), compute_ports=False)
    reps = s.stripe_reps
    enc_big = dataclasses.replace(
        enc_base,
        n_pods=enc_base.n_pods * reps,
        pod_kv=np.tile(enc_base.pod_kv, (reps, 1)),
        pod_key=np.tile(enc_base.pod_key, (reps, 1)),
        pod_ns=np.tile(enc_base.pod_ns, reps),
    )
    mp = _shape(mesh)[1]
    res = sharded_packed_reach(mesh, enc_big, tile=s.stripe_tile, chunk=s.stripe_chunk,
                               stripe=(0, mp), keep_matrix=False)
    del enc_big
    n_tiles = res.timings["tiles"]
    n = enc_base.n_pods * reps
    assert res.out_degree.shape == (n,), res.out_degree.shape
    assert int(res.total_pairs) > 0
    ctx["stripe"] = res  # its aggregates stay live, as in the reference
    label = "1M" if n == 1_000_000 else str(n)
    return (f"{label}-pod packed sharded stripe ({mp}/{n_tiles} dst tiles, "
            f"{res.total_pairs} pairs in stripe, solve {res.timings['solve']:.1f}s)",
            {"out_degree": res.out_degree, "in_degree": res.in_degree,
             "total_pairs": np.int64(res.total_pairs), "tiles": np.int64(n_tiles)})


def stage_incremental(mesh, ctx: Context):
    """5: the mesh ``PackedIncrementalVerifier`` on stage 2's cluster:
    remove, re-add and update, == the oracle of ``as_cluster()``."""
    from .backends.base import VerifyConfig, verify
    from .packed_incremental import PackedIncrementalVerifier

    cluster = ctx.cluster("packed")
    cfg = VerifyConfig(compute_ports=False)
    inc = PackedIncrementalVerifier(cluster, cfg, mesh=mesh)
    pols = list(cluster.policies)
    inc.remove_policy(pols[0].namespace, pols[0].name)
    inc.add_policy(dataclasses.replace(pols[0], name="dryrun-readd"))
    inc.update_policy(dataclasses.replace(pols[1], ingress=pols[2].ingress))
    reach = inc.reach
    mutated = inc.as_cluster()
    ref = verify(mutated, dataclasses.replace(cfg, backend="cpu"))
    assert inc.keep_matrix
    _eq(reach, ref.reach, "sharded packed incremental reach")
    return (f"sharded packed incremental ({inc.update_count} policy diffs patched in "
            f"place) == cpu oracle", {"reach": reach, "pods": _pod_rows(mutated)})


def stage_matrix_free(mesh, ctx: Context):
    """6: the base cluster's PODS tiled out (250k at the reference's size)
    into a matrix-free mesh engine; a policy diff, then a re-solved dst
    stripe == the tiled cpu-oracle pattern (reach depends only on the (src,
    dst) base classes, plus the exact self-traffic diagonal)."""
    from .backends.base import VerifyConfig, verify
    from .models.core import Cluster
    from .ops.bits import unpack_cols
    from .packed_incremental import PackedIncrementalVerifier

    s = ctx.sizes
    base = ctx.cluster("base")
    cfg = VerifyConfig(compute_ports=False)
    big_pods = [dataclasses.replace(p, name=f"{p.name}-r{r}")
                for r in range(s.engine_reps) for p in base.pods]
    big = Cluster(pods=big_pods, namespaces=list(base.namespaces),
                  policies=list(base.policies))
    inc = PackedIncrementalVerifier(big, cfg, mesh=mesh, keep_matrix=False)
    del big
    diff_pol = dataclasses.replace(base.policies[1], ingress=base.policies[2].ingress)
    inc.update_policy(diff_pol)
    width = s.engine_width
    stripe_words = inc.solve_stripe(0, width)
    dirty = int(inc.dirty_cols.sum())
    base_diffed = Cluster(
        pods=list(base.pods), namespaces=list(base.namespaces),
        policies=[diff_pol if (p.namespace, p.name) == (diff_pol.namespace, diff_pol.name)
                  else p for p in base.policies],
    )
    pattern = verify(base_diffed, VerifyConfig(backend="cpu", compute_ports=False,
                                               self_traffic=False)).reach
    B = len(base.pods)
    n_big = len(big_pods)
    got = unpack_cols(stripe_words, width)
    expected = pattern[:, np.arange(width) % B][np.arange(n_big) % B]
    if cfg.self_traffic:
        diag = np.arange(width)
        expected[diag, diag] = True
    assert not inc.keep_matrix
    _eq(got, expected, "matrix-free stripe")
    assert dirty > 0
    ctx.update(engine=inc, pattern=pattern, big_pods=big_pods, diff_pol=diff_pol,
               self_traffic=cfg.self_traffic)
    return (f"{n_big}-pod matrix-free sharded incremental — policy diff applied to "
            f"sharded maps, re-solved stripe == tiled cpu-oracle pattern ({dirty} dirty "
            f"cols tracked)", {"stripe": got, "dirty_cols": np.int64(dirty)})


def stage_ports_churn(mesh, ctx: Context):
    """7: pod churn on the mesh ``PackedPortsIncrementalVerifier``: add,
    remove and relabel a pod == the oracle; the delta closure == a full
    re-closure bit for bit."""
    from .backends.base import VerifyConfig, verify
    from .models.core import Pod
    from .ops.closure import packed_closure
    from .packed_incremental_ports import PackedPortsIncrementalVerifier

    tile = ctx.sizes.ports_closure_tile
    cluster = _gen(ctx.sizes.ports_gen)
    inc = PackedPortsIncrementalVerifier(cluster, VerifyConfig(compute_ports=True), mesh=mesh)
    inc.closure_packed(tile=tile)  # prime the delta-closure cache
    inc.add_pod(Pod("dryrun-new", inc.pods[0].namespace, {"d": "1"}))
    victim = inc.pods[5]
    inc.remove_pod(victim.namespace, victim.name)
    inc.update_pod_labels(3, dict(inc.pods[9].labels))
    reach = inc.reach_active()
    delta = _words_u32(inc.closure_packed(tile=tile))
    full = _words_u32(packed_closure(inc._whole_words(), tile=tile))
    mutated = inc.as_cluster()
    ref = verify(mutated, VerifyConfig(backend="cpu"))
    _eq(reach, ref.reach, "ports engine reach_active")
    _eq(delta, full, "delta closure")
    return ("mesh-sharded port-bitmap pod churn (add/remove/relabel) == cpu oracle; "
            "delta closure == full re-closure bit-for-bit",
            {"reach": reach, "closure": delta, "pods": _pod_rows(mutated),
             "active": np.asarray(inc.active_indices(), dtype=np.int64)})


def stage_pair_masks(mesh, ctx: Context):
    """8: ``policy_shadow`` / ``policy_conflict`` through the
    ``sharded-packed`` backend == the oracle."""
    from .backends.base import VerifyConfig, verify

    cluster = ctx.cluster("packed")
    s = ctx.sizes
    res = verify(cluster, VerifyConfig(
        backend="sharded-packed",
        backend_options=(("mesh", _shape(mesh)), ("tile", s.packed_tile),
                         ("chunk", s.packed_chunk)) + _dev_opt(mesh)))
    shadow, conflict = res.policy_shadow(), res.policy_conflict()
    ref = verify(cluster, VerifyConfig(backend="cpu"))
    assert shadow == ref.policy_shadow(), (shadow, ref.policy_shadow())
    assert conflict == ref.policy_conflict(), (conflict, ref.policy_conflict())
    return ("policy_shadow/policy_conflict via sharded Gram masks == cpu oracle (all six "
            "queries through the backend)",
            {"shadow": np.array(shadow, dtype=np.int64).reshape(-1, 2),
             "conflict": np.array(conflict, dtype=np.int64).reshape(-1, 2)})


def stage_sharded_closure(mesh, ctx: Context):
    """9: ``sharded_packed_closure`` == the one-device ``packed_closure``
    bit for bit, and the padded-stripe case (N = 1,000)."""
    from .ops.bits import pack_bool_cols
    from .ops.closure import packed_closure
    from .parallel.sharded_closure import sharded_packed_closure

    s = ctx.sizes
    n = s.closure_n
    rng = np.random.default_rng(s.closure_seed)
    adj = rng.random((n, n)) < (s.closure_degree / n)
    packed_adj = _words_u32(pack_bool_cols(torch.from_numpy(adj)))
    dev = mesh.device
    sharded = sharded_packed_closure(mesh, packed_adj, tile=s.closure_tile)
    oracle = _words_u32(packed_closure(packed_adj, tile=s.closure_tile, device=dev))
    n_odd = s.odd_n
    w_odd = -(-n_odd // 32)
    packed_odd = np.zeros((n_odd, w_odd), dtype=np.uint32)
    packed_odd[:] = packed_adj[:n_odd, :w_odd]
    if n_odd % 32:
        packed_odd[:, -1] &= np.uint32((1 << (n_odd % 32)) - 1)
    sharded_odd = sharded_packed_closure(mesh, packed_odd, tile=s.odd_tile)
    pad_rows = np.zeros((32 * w_odd - n_odd, w_odd), dtype=np.uint32)
    oracle_odd = _words_u32(packed_closure(np.vstack([packed_odd, pad_rows]),
                                           tile=s.odd_tile, device=dev))[:n_odd]
    _eq(sharded, oracle, "sharded closure")
    _eq(sharded_odd, oracle_odd, "padded-stripe sharded closure")
    dp, mp = _shape(mesh)
    return (f"mesh-sharded closure == single-device packed closure bit-for-bit ({n} pods "
            f"on {dp}x{mp}, and N={n_odd} padded-stripe case)",
            {"closure": sharded, "closure_odd": sharded_odd, "adj": packed_adj})


def stage_bounded_closure(mesh, ctx: Context):
    """10: the bounded multi-source closure answers a PATH query over stage
    6's matrix-free engine (one ``solve_rows`` gather a level; the N × N
    matrix never exists) == BFS over the base pattern graph."""
    from .ops.bits import unpack_cols
    from .ops.closure import bounded_closure_rows

    inc, pattern = ctx["engine"], ctx["pattern"]
    n_big = len(ctx["big_pods"])
    B = pattern.shape[0]
    row_sums = pattern.sum(axis=1)
    p32 = pattern.astype(np.float32)
    seed_class = None
    for cand in np.argsort(row_sums, kind="stable"):
        if not 0 < row_sums[cand] <= 8:
            continue
        if (((p32[cand] @ p32) > 0) & ~pattern[cand]).any():
            seed_class = int(cand)
            break
    assert seed_class is not None, "no sparse 2-hop seed class in pattern"
    seed = seed_class  # replica r0 of that class

    def big_rows(idx):
        words = inc.solve_rows(np.asarray(idx, dtype=np.int64))
        return unpack_cols(words, inc._n_padded)[:, :n_big]

    acc, hop = bounded_closure_rows(big_rows, [seed], n_big, hops=ctx.sizes.hops,
                                    chunk=ctx.sizes.bfs_chunk, device=mesh.device)
    one_hop = pattern[seed_class]
    two_hop = (p32[seed_class] @ p32) > 0
    hop_class = np.where(one_hop, 1, np.where(two_hop, 2, 0)).astype(np.int32)
    expected_hop = hop_class[np.arange(n_big) % B]
    expected_hop[seed] = 1  # the self-traffic edge: seed -> seed is 1 hop
    _eq(hop[0], expected_hop, "bounded closure hops")
    _eq(acc[0], expected_hop > 0, "bounded closure reach")
    return (f"bounded closure path query on the {n_big}-pod matrix-free engine — seed "
            f"class {seed_class}, {int(acc.sum())} pods within {ctx.sizes.hops} hops, hop "
            f"counts == pattern-BFS oracle, no N x N materialised",
            {"hop": hop, "acc": acc, "seed": np.int64(seed)})


def live_tensors(dev: torch.device, n_big: int) -> Tuple[List[tuple], int]:
    """The dense ``[N, N]`` check's two readings in this process: the
    shapes of live 2-D tensors with both sides ≥ ``n_big`` (a ``gc`` scan,
    every device), and the live bytes — ``torch.cuda.memory_allocated`` on
    a card, the distinct CPU storages' bytes otherwise."""
    gc.collect()
    dense, storages = [], {}
    for obj in gc.get_objects():
        try:
            if not issubclass(type(obj), torch.Tensor):
                continue
            if obj.dim() == 2 and obj.shape[0] >= n_big and obj.shape[1] >= n_big:
                dense.append(tuple(obj.shape))
            if obj.device.type == "cpu":
                st = obj.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        except (RuntimeError, ReferenceError):  # a tensor without storage
            continue
    if dev.type == "cuda":
        return dense, int(torch.cuda.memory_allocated(dev))
    return dense, int(sum(storages.values()))


def stage_follower(mesh, ctx: Context):
    """11: checkpoint stage 6's engine, bootstrap a read-only
    ``FollowerService`` from it (matrix-free), tail one WAL event and
    answer a probe batch == the pattern; no dense ``[N, N]`` tensor live.

    The checkpoint is collective (``state_dict`` gathers the shards): every
    rank gathers and rank 0 alone writes, behind the save's barrier — rank
    0 through ``CheckpointManager.checkpoint``, the others through the same
    ``save_packed_incremental``, which on them writes nothing. That barrier
    is the last collective; the follower is a one-device service on rank
    0, built after it."""
    from .serve.durability import CheckpointManager
    from .serve.events import UpdatePolicy, WalWriter
    from .serve.replication import FollowerService
    from .utils.persist import save_packed_incremental

    inc, pattern, big_pods = ctx["engine"], ctx["pattern"], ctx["big_pods"]
    n_big, B = len(big_pods), pattern.shape[0]
    rep_dir = os.path.join(ctx.workdir, "follower")
    if mesh.rank == 0:
        os.makedirs(rep_dir, exist_ok=True)
        wal = os.path.join(rep_dir, "wal.jsonl")
        w = WalWriter(wal)
        offset0, seq0 = w.offset, w.next_seq - 1
        w.append([UpdatePolicy(policy=ctx["diff_pol"])])
        w.close()
        CheckpointManager(rep_dir).checkpoint(inc, log_path=wal, log_offset=offset0,
                                              last_seq=seq0)
    else:
        # kvtpu: ignore[collective-axis] rank 0's checkpoint() runs this same save (the state_dict gathers, then the barrier)
        save_packed_incremental(inc, rep_dir)
    arrays: Dict[str, np.ndarray] = {}
    line = None
    if mesh.rank == 0:
        fol = FollowerService(rep_dir, replica="dryrun-follower", device=mesh.device)
        assert fol.recovery.outcome == "newest", fol.recovery.outcome
        assert fol.applied == 1, fol.applied
        fsvc = fol.service
        assert fsvc.packed, "follower must serve from the packed engine"
        assert fsvc.engine._packed is None and not fsvc.engine.keep_matrix
        names = [f"{p.namespace}/{p.name}" for p in big_pods]
        rng = np.random.default_rng(ctx.sizes.probe_seed)
        qs = rng.integers(0, n_big, size=ctx.sizes.probes)
        qd = rng.integers(0, n_big, size=ctx.sizes.probes)
        qs[0] = qd[0] = 7  # the exact self-traffic diagonal (does not tile)
        qs[1], qd[1] = 7 + B, 7  # distinct replicas of one class: pattern only
        got = np.asarray(fol.query.can_reach_batch(
            [(names[a], names[b]) for a, b in zip(qs, qd)]))
        exp = pattern[qs % B, qd % B]
        if ctx["self_traffic"]:
            exp = np.where(qs == qd, True, exp)
        _eq(got, exp, "follower probe answers")
        arrays = {"probes": got, "qs": qs, "qd": qd}
    dense, live_bytes = live_tensors(mesh.device, n_big)
    dense_bytes = 4 * n_big * n_big
    ctx["live"] = {"dense_shapes": dense, "live_bytes": live_bytes, "dense_bytes": dense_bytes}
    assert not dense, f"dense [N, N] tensors materialised: {dense}"
    bound = int(dense_bytes * ctx.sizes.live_fraction)
    assert live_bytes < bound, (
        f"{live_bytes} live device bytes vs {dense_bytes} for one dense [N, N] int32 "
        f"(bound {bound})")
    if mesh.rank == 0:
        line = (f"{n_big}-pod packed-state follower (checkpoint bootstrap + WAL tail) "
                f"answered a {ctx.sizes.probes}-probe batch from device-resident word "
                f"rows == tiled cpu-oracle pattern; no [N, N] dense array live "
                f"({live_bytes / 1e6:.0f} MB device vs {dense_bytes / 1e9:.0f} GB dense)")
    return line, arrays


#: the stages in the reference's order
STAGES: Tuple[Callable, ...] = (
    stage_sharded_verify,
    stage_packed_solve,
    stage_packed_ports,
    stage_million_stripe,
    stage_incremental,
    stage_matrix_free,
    stage_ports_churn,
    stage_pair_masks,
    stage_sharded_closure,
    stage_bounded_closure,
    stage_follower,
)


def run_stages(mesh, ctx: Context, stages=None, emit: Optional[Callable] = None) -> dict:
    """Run the numbered ``stages`` (1-based, default all eleven) in order on
    every rank of ``mesh``; ``emit(line)`` gets each OK line with its
    seconds on rank 0. Returns ``{stage: (seconds, arrays)}``."""
    out = {}
    for k in stages or range(1, len(STAGES) + 1):
        t0 = time.perf_counter()
        line, arrays = STAGES[k - 1](mesh, ctx)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        secs = time.perf_counter() - t0
        if emit is not None and mesh.rank == 0:
            emit(f"{_OK}{line} [stage {k}: {secs:.2f} s]")
        out[k] = (secs, arrays)
    return out


def mesh_shape(n_devices: int) -> Tuple[int, int]:
    """The largest 2-D factorisation, pods × grants (dp × mp): 8 → 4×2,
    4 → 2×2, 2 → 2×1."""
    mp = 1
    for cand in range(int(n_devices ** 0.5), 0, -1):
        if n_devices % cand == 0:
            mp = cand
            break
    return n_devices // mp, mp


def _rank_device(rank: int, device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _rank_main(rank: int, n: int, port: int, device: str, workdir: str, sizes: Sizes,
               stages, save_arrays: bool) -> None:
    """One rank (spawned): join the gloo group, run the stages, write its
    report (and, with ``save_arrays``, each stage's arrays)."""
    import resource

    from .ops.kernels import fused_ports_reach, packed_dir_allow
    from .parallel.mesh import init_distributed, leave_distributed, mesh_for

    dev = _rank_device(rank, device)
    # the host's cores shared by the ranks, within this process's own cap
    # (OMP_NUM_THREADS, when set)
    torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // n)))
    init_distributed(f"tcp://127.0.0.1:{port}", n, rank, backend="gloo", device=dev,
                     timeout_s=GLOO_TIMEOUT_S)
    mesh = mesh_for(mesh_shape(n), device=dev, backend="gloo")
    ctx = Context(sizes, os.path.join(workdir, "work"))
    os.makedirs(ctx.workdir, exist_ok=True)
    done = run_stages(mesh, ctx, stages, emit=lambda line: print(line, flush=True))
    if save_arrays:
        for k, (_, arrays) in done.items():
            np.savez(os.path.join(workdir, f"stage{k}.r{rank}.npz"),
                     **{key: np.asarray(v) for key, v in arrays.items()})
    report = {
        "rank": rank,
        "device": str(dev),
        "seconds": {str(k): v[0] for k, v in done.items()},
        "launches": [packed_dir_allow.launches, fused_ports_reach.launches],
        "peak_device_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if dev.type == "cuda" else None),
        "peak_host_gib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        "live": {k: v for k, v in ctx.get("live", {}).items() if k != "dense_shapes"},
    }
    path = os.path.join(workdir, f"rank{rank}.json")
    with open(path + ".tmp", "w") as fh:
        json.dump(report, fh)
    os.replace(path + ".tmp", path)
    leave_distributed()


def _launch(n: int, device: str, sizes: Sizes, stages, workdir: str,
            save_arrays: bool = False) -> List[dict]:
    """Spawn ``n`` ranks on the stages and wait for them; returns their
    reports. A rank that raises ends the run (the others are killed and its
    traceback raised), as does one still running after ``RANK_DEADLINE_S``
    or one that wrote no report."""
    import torch.multiprocessing as mp

    from .resilience.errors import BackendError, BackendTimeout

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.start_processes(
        _rank_main, args=(n, port, device, workdir, sizes, stages, save_arrays),
        nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + RANK_DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise BackendTimeout(
                    f"dryrun_multichip: the {n} ranks did not end within "
                    f"{RANK_DEADLINE_S:.0f} s", backend="sharded")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join()
    reports = []
    for rank in range(n):
        path = os.path.join(workdir, f"rank{rank}.json")
        if not os.path.exists(path):
            raise BackendError(f"dryrun_multichip: rank {rank} wrote no report",
                               backend="sharded", kind="rank_failed")
        with open(path) as fh:
            reports.append(json.load(fh))
    return reports


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the reference's eleven-stage multi-chip dryrun, at its sizes, on
    ``n_devices`` gloo ranks (a ``mesh_shape(n_devices)`` mesh), on the card
    (default; ``BackendError`` without a GPU, before any rank starts) or on
    the CPU (``device="cpu"``). Rank 0 prints the eleven ``dryrun_multichip
    OK`` lines with each stage's seconds; this process prints one line per
    rank (stage seconds, peak memory, kernel launches), then ``dryrun_multichip
    summary`` and the returned dict as JSON (the mesh, the wall seconds and
    the ranks' reports). Any rank that raises, or that has not ended within
    ``RANK_DEADLINE_S``, ends the run: the others are killed and this
    raises."""
    from .resilience.errors import ConfigError

    n = int(n_devices)
    if n < 1:
        raise ConfigError(f"dryrun_multichip needs at least one rank, got {n_devices}")
    dev = resolve_device(device)
    dp, mpar = mesh_shape(n)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kvt-dryrun-") as workdir:
        reports = _launch(n, dev.type, Sizes(), None, workdir)
    wall = time.perf_counter() - t0
    for r in reports:
        peak = r["peak_device_gib"]
        print(f"dryrun_multichip rank {r['rank']} ({r['device']}): stage seconds "
              + ", ".join(f"{k} {v:.2f}" for k, v in r["seconds"].items())
              + (f"; peak device {peak:.2f} GiB" if peak is not None else "")
              + f"; peak host {r['peak_host_gib']:.2f} GiB; launches packed_dir_allow "
              f"{r['launches'][0]}, fused_ports_reach {r['launches'][1]}", flush=True)
    summary = {"mesh": [dp, mpar], "device": dev.type, "seconds": wall, "ranks": reports}
    print(f"dryrun_multichip: {n} gloo ranks, mesh {dp}x{mpar}, on {dev.type}, "
          f"{wall:.2f} s", flush=True)
    print("dryrun_multichip summary " + json.dumps(summary, sort_keys=True), flush=True)
    return summary


def main(argv=None) -> int:
    """``python -m kubernetes_verification_tpu_torch.graft_entry [n [device]]``:
    ``dryrun_multichip(n, device)``, ``n`` 8 and the card by default."""
    argv = sys.argv[1:] if argv is None else argv
    dryrun_multichip(int(argv[0]) if argv else 8, device=argv[1] if len(argv) > 1 else None)
    return 0


if __name__ == "__main__":
    from kubernetes_verification_tpu_torch.graft_entry import main as _main

    sys.exit(_main())
