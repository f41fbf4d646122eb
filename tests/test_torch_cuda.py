"""The port on an NVIDIA GPU: the hand-written CUDA kernels against their
plain PyTorch versions, and the solves on the card against the same solves on the
CPU (exact: every output is boolean or integer words).

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; there, from the repository root::

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError
from kubernetes_verification_tpu_torch.ops.kernels import (
    K_STEP,
    fused_ports_reach,
    fused_ports_reach_reference,
    packed_dir_allow,
    packed_dir_allow_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: skip without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# (64, 128): one tile, smaller than a raster group, K' = 64 (half a stage);
# (77, 384): N not a multiple of the 256-column tile; (130, 1152): more row
# tiles than a group, a ragged last column tile, K' = 192 (1.5 stages)
@pytest.mark.parametrize("p,n", [(77, 512), (1, 128), (300, 1024), (64, 128),
                                 (77, 384), (130, 1152)])
def test_kernel_matches_plain_version(cuda_device, p, n):
    rng = np.random.default_rng(p)
    a, b = ((rng.random((p, n)) < 0.05).astype(np.int8) for _ in range(2))
    niso = np.broadcast_to((rng.random(n) < 0.5).astype(np.int32), (8, n)).copy()
    ta, tb, tn = (torch.as_tensor(x, device=cuda_device) for x in (a, b, niso))
    for axis in (1, 0, -1):
        before = packed_dir_allow.launches
        got = packed_dir_allow(ta, tb, tn, default_allow_axis=axis)
        torch.cuda.synchronize()
        assert packed_dir_allow.launches == before + 1
        want = packed_dir_allow_reference(ta, tb, tn, default_allow_axis=axis)
        assert torch.equal(got, want), axis
        # and the plain version on the card equals the one on the CPU
        cpu = packed_dir_allow(
            torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(niso),
            default_allow_axis=axis,
        )
        assert torch.equal(want.cpu(), cpu), axis


def test_tiled_kernel_path_matches_sweep_and_cpu(cuda_device):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=700, n_policies=60, n_namespaces=4, p_ipblock_peer=0.1, seed=3,
    ))
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    before = packed_dir_allow.launches
    got = kvt.tiled_k8s_reach(enc, chunk=64, fetch=False)
    assert packed_dir_allow.launches == before + 2
    assert got.meta == {"kernel": "packed_dir_allow"}
    sweep = kvt.tiled_k8s_reach(enc, chunk=64, fetch=False, use_kernel=False)
    assert torch.equal(got.packed, sweep.packed)
    cpu = kvt.tiled_k8s_reach(enc, chunk=64, device="cpu")
    np.testing.assert_array_equal(got.packed.cpu().numpy().view("<u4"), cpu.packed)
    assert got.timings["reachable_pairs"] == int(cpu.out_degree().sum())
    assert got.all_isolated() == cpu.all_isolated()


@pytest.mark.parametrize("compute_ports", [True, False])
def test_verify_on_card_matches_cpu(cuda_device, compute_ports):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=300, n_policies=40, seed=4))
    runs = [
        kvt.verify(cluster, kvt.VerifyConfig(
            compute_ports=compute_ports, backend_options=(("device", d),),
        ))
        for d in ("cuda", "cpu")
    ]
    for name in ("reach", "reach_ports", "src_sets", "dst_sets", "selected",
                 "ingress_isolated", "egress_isolated"):
        g, w = (getattr(r, name) for r in runs)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=name)


def _fused_case(rng, n, r, lengths):
    """Random K-contiguous operands over egress planes 0..r (the last one
    the full block) then ingress segments, each padded to ``K_STEP``; each
    segment's density keeps its ``count > 0`` near 3 % of the elements. A
    segment of length 0 is left out of the plan."""
    segs = [(0, m) for m in range(r)] + [(1, r)]
    segs += [(2, m) for m in range(r)] + [(3, r)]
    kp = sum(l + (-l) % K_STEP for l in lengths[: len(segs)])
    at = np.zeros((n, kp), np.int8)
    bt = np.zeros((n, kp), np.int8)
    plan, off = [], 0
    for (kind, slab), l in zip(segs, lengths):
        if not l:
            continue
        p = np.sqrt(0.03 / l)
        at[:, off : off + l] = rng.random((n, l)) < p
        bt[:, off : off + l] = rng.random((n, l)) < p
        off += l + (-l) % K_STEP
        plan.append((off // K_STEP, kind, slab))
    masks = rng.random((r, 6)) < 0.3
    ov = [int(sum(1 << int(j) for j in np.nonzero((masks[m] & masks).any(1))[0]) | (1 << r))
          for m in range(r)]
    niso = [(rng.random(n) < 0.5).astype(np.int32) for _ in range(2)]
    return at, bt, np.asarray(plan, np.int32), np.asarray(ov, np.int64), *niso


# beyond the first four: the W switch (R = 29 one state word, R = 30 two)
# with every segment one 64-column step, so every other flush falls half-way
# through a 128-byte stage; R = 61 over more row tiles than a raster group;
# one segment inside half a stage (K' = 64)
@pytest.mark.parametrize("n,r,lengths", [
    (256, 0, 150), (384, 1, 150), (256, 19, 150), (128, 36, 150),
    (128, 29, 65), (384, 30, 65), (1152, 61, 100), (128, 0, (0, 40)),
])
def test_fused_kernel_matches_plain_version(cuda_device, n, r, lengths):
    rng = np.random.default_rng(n + r)
    if isinstance(lengths, int):  # the most columns a segment may have, + 1
        lengths = rng.integers(1, lengths, size=2 * r + 2)
    ops = _fused_case(rng, n, r, lengths)
    dev_ops = [torch.as_tensor(x, device=cuda_device) for x in ops]
    for da in (True, False):
        before = fused_ports_reach.launches
        got = fused_ports_reach(*dev_ops, default_allow=da)
        torch.cuda.synchronize()
        assert fused_ports_reach.launches == before + 1
        want = fused_ports_reach_reference(*dev_ops, default_allow=da)
        assert torch.equal(got, want), da
        cpu = fused_ports_reach(*(torch.as_tensor(x) for x in ops), default_allow=da)
        assert torch.equal(want.cpu(), cpu), da


def test_fused_kernel_refuses_a_plan_it_cannot_walk(cuda_device):
    """The kernel flushes only where a K step ends a plan row: a plan that
    ends short of K', or has an empty or backward row, is refused on the
    card before any launch."""
    rng = np.random.default_rng(5)
    ops = _fused_case(rng, 128, 2, rng.integers(1, 150, size=6))
    at, bt, plan, ov, ni, ne = (torch.as_tensor(x, device=cuda_device) for x in ops)
    empty = plan.clone()
    empty[1, 0] = empty[0, 0]
    before = fused_ports_reach.launches
    for bad in (plan[:-1].contiguous(), empty, plan.flip(0).contiguous()):
        with pytest.raises(ConfigError, match="plan"):
            fused_ports_reach(at, bt, bad, ov, ni, ne, default_allow=True)
    assert fused_ports_reach.launches == before


def test_tiled_ports_kernel_path_matches_sweep_and_cpu(cuda_device):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=700, n_policies=60, n_namespaces=4, p_ports=0.8, p_named_port=0.3,
        p_container_ports=0.5, seed=3,
    ))
    enc = kvt.encode_cluster(cluster, compute_ports=True)
    assert len(enc.atoms) > 1
    before = (fused_ports_reach.launches, packed_dir_allow.launches)
    got = kvt.tiled_k8s_reach(enc, chunk=64, fetch=False)
    assert (fused_ports_reach.launches, packed_dir_allow.launches) == (
        before[0] + 1, before[1]
    )
    assert got.meta == {"kernel": "fused_ports_reach"}
    w = -(-700 // 32)
    sweep = kvt.tiled_k8s_reach(enc, chunk=64, fetch=False, use_kernel=False)
    assert torch.equal(got.packed[:, :w], sweep.packed[:, :w])
    assert not got.packed[:, w:].any()
    cpu = kvt.tiled_k8s_reach(enc, chunk=64, device="cpu")
    np.testing.assert_array_equal(got.packed.cpu().numpy().view("<u4")[:, :w], cpu.packed[:, :w])
    assert got.timings["reachable_pairs"] == sweep.timings["reachable_pairs"]
    assert got.timings["reachable_pairs"] == int(cpu.out_degree().sum())
    dense = kvt.verify(cluster, kvt.VerifyConfig(compute_ports=True))
    np.testing.assert_array_equal(cpu.to_bool(), dense.reach)


# ---------------------------------------------------------------------------
# closures, path queries, pair masks and kano mode on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,d", [(1, 64, 40), (16, 33, 5), (17, 8, 8), (3, 1, 1),
                                   (0, 0, 0), (300, 1024, 96)])
def test_bool_dot_meets_the_int_mm_shape_rules_on_the_card(cuda_device, m, k, d):
    """``torch._int_mm`` on CUDA takes M > 16 and K, D multiples of 8:
    ``bool_dot`` pads every other shape and trims, with exact counts."""
    from kubernetes_verification_tpu_torch.ops.closure import bool_dot

    rng = np.random.default_rng(m * 7 + k + d)
    a = (rng.random((m, k)) < 0.5).astype(np.int8)
    bt = (rng.random((d, k)) < 0.5).astype(np.int8)
    got = bool_dot(torch.as_tensor(a, device=cuda_device), torch.as_tensor(bt, device=cuda_device))
    assert tuple(got.shape) == (m, d)
    np.testing.assert_array_equal(got.cpu().numpy(), a.astype(np.int64) @ bt.T.astype(np.int64))


def _words_on(dense, dev):
    return torch.as_tensor(
        np.packbits(dense, axis=1, bitorder="little").view("<i4").copy(), device=dev
    )


@pytest.mark.parametrize("n_seeds", [1, 16, 17, 256])
def test_bounded_closure_on_card_matches_cpu(cuda_device, n_seeds):
    """1 and 16 seeds are below ``_int_mm``'s 17 rows: padded on the card."""
    rng = np.random.default_rng(n_seeds)
    g = rng.random((256, 256)) < 1.5 / 256
    seeds = rng.integers(0, 256, n_seeds)
    for hops in (None, 2):
        got = kvt.bounded_packed_closure(_words_on(g, cuda_device), seeds, hops=hops, tile=64)
        want = kvt.bounded_packed_closure(_words_on(g, "cpu"), seeds, hops=hops, tile=64)
        assert torch.equal(got[0].cpu(), want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n_seeds,chunk", [(1, 5), (16, 2048), (40, 13)])
def test_bounded_closure_rows_on_card_matches_cpu(cuda_device, n_seeds, chunk):
    """The row-oracle BFS on the card: fewer than 17 seeds and chunks that
    are not multiples of 8 are padded by ``bool_dot``."""
    rng = np.random.default_rng(n_seeds + chunk)
    g = rng.random((150, 150)) < 1.4 / 150
    seeds = rng.integers(0, 150, n_seeds)
    for hops in (None, 2):
        got = kvt.bounded_closure_rows(lambda i: g[i], seeds, 150, hops=hops,
                                       chunk=chunk)
        want = kvt.bounded_closure_rows(lambda i: g[i], seeds, 150, hops=hops,
                                        chunk=chunk, device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_closures_on_card_match_cpu(cuda_device):
    from kubernetes_verification_tpu_torch.ops.closure import _add_edges_round

    rng = np.random.default_rng(5)
    g = rng.random((512, 512)) < 1.3 / 512
    w_dev, w_cpu = _words_on(g, cuda_device), _words_on(g, "cpu")
    c_dev = kvt.packed_closure(w_dev, tile=128, dst_tile=256)
    c_cpu = kvt.packed_closure(w_cpu, tile=128, dst_tile=256)
    assert torch.equal(c_dev.cpu(), c_cpu)
    for hops in (1, 2, 3):
        assert torch.equal(kvt.path_upto(w_dev, hops).cpu(), kvt.path_upto(w_cpu, hops))
    dense = kvt.transitive_closure(torch.as_tensor(g[:100, :100], device=cuda_device))
    assert torch.equal(dense.cpu(), kvt.transitive_closure(torch.as_tensor(g[:100, :100])))
    # an added-edge round over d = 5 < 17 rows: both products are padded
    added = _words_on(rng.random((512, 512)) < 0.002, "cpu")
    rows = torch.tensor([3, 9, 9, 200, 511])
    want = _add_edges_round(c_cpu.clone(), added, rows, tile=128)
    got = _add_edges_round(c_dev.clone(), added.to(cuda_device), rows.to(cuda_device), tile=128)
    assert torch.equal(got.cpu(), want)
    # both delta routes
    new = g.copy()
    new[np.nonzero(g)[0][:3], np.nonzero(g)[1][:3]] = False
    dirty = (g != new).any(axis=0) | (g != new).any(axis=1)
    for with_base in (False, True):  # removals: the suspect route either way
        d_dev = kvt.packed_closure_delta(_words_on(new, cuda_device), c_dev, dirty,
                                         prev_base=w_dev if with_base else None)
        d_cpu = kvt.packed_closure_delta(_words_on(new, "cpu"), c_cpu, dirty,
                                         prev_base=w_cpu if with_base else None)
        assert torch.equal(d_dev.cpu(), d_cpu)
        assert torch.equal(d_cpu, kvt.packed_closure(_words_on(new, "cpu")))
    grown = g | (rng.random((512, 512)) < 0.001)
    a_dev = kvt.packed_closure_delta(_words_on(grown, cuda_device), c_dev,
                                     np.zeros(512, bool), prev_base=w_dev)
    assert torch.equal(a_dev.cpu(), kvt.packed_closure(_words_on(grown, "cpu")))


def test_pair_masks_closure_and_kano_on_card_match_cpu(cuda_device):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=300, n_policies=40, seed=6))
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    for got, want in zip(kvt.policy_pair_masks(enc, chunk=64),
                         kvt.policy_pair_masks(enc, chunk=64, device="cpu")):
        np.testing.assert_array_equal(got, want)
    reach = kvt.tiled_k8s_reach(enc, chunk=64, fetch=False)
    closed = reach.closure()
    assert closed.packed.device.type == "cuda"
    host = kvt.tiled_k8s_reach(enc, chunk=64, device="cpu").closure(device="cpu")
    np.testing.assert_array_equal(closed.to_bool(), host.to_bool())
    dense = kvt.verify(cluster, kvt.VerifyConfig(compute_ports=False, closure=True))
    np.testing.assert_array_equal(closed.to_bool(), dense.closure)
    for relation in (None, kvt.DefaultEqualityLabelRelation()):
        runs = []
        for d in ("cuda", "cpu"):
            cont, pols = kvt.random_kano(300, 30, seed=6)
            res = kvt.verify_kano(cont, pols, kvt.VerifyConfig(
                closure=True, label_relation=relation, backend_options=(("device", d),)))
            runs.append((res, [(c.select_policies, c.allow_policies) for c in cont]))
        for name in ("reach", "src_sets", "dst_sets", "closure"):
            np.testing.assert_array_equal(getattr(runs[0][0], name), getattr(runs[1][0], name))
        assert runs[0][1] == runs[1][1]


# ---------------------------------------------------------------------------
# the packed incremental engine on the card
# ---------------------------------------------------------------------------


def _same_state(want, got, label):
    assert sorted(want) == sorted(got), label
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert (w.dtype, w.shape) == (g.dtype, g.shape), (label, k)
        assert w.tobytes() == g.tobytes(), (label, k)


@pytest.mark.parametrize("slot_round", [256, 4])
def test_engine_build_launches_the_kernel_twice(cuda_device, slot_round):
    """slot_round=4 leaves the slot axis off the kernel's K step: the maps
    are padded for the launch, and the words do not change."""
    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=700, n_policies=60, n_namespaces=4, p_ipblock_peer=0.1, seed=8))
    before = (packed_dir_allow.launches, fused_ports_reach.launches)
    eng = kvt.PackedIncrementalVerifier(cluster, slot_round=slot_round)
    assert (packed_dir_allow.launches, fused_ports_reach.launches) == (
        before[0] + 2, before[1])
    assert eng._packed.device.type == "cuda"
    one_shot = kvt.tiled_k8s_reach(kvt.encode_cluster(cluster, compute_ports=False),
                                   fetch=False)
    w = -(-700 // 32)
    assert torch.equal(eng._packed[:700, :w], one_shot.packed[:, :w])
    cpu = kvt.PackedIncrementalVerifier(cluster, device="cpu", slot_round=slot_round)
    _same_state(cpu.state_dict(), eng.state_dict(), "build")


def test_engine_stream_on_card_matches_cpu(cuda_device):
    import dataclasses

    from kubernetes_verification_tpu_torch.ops import batched

    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=300, n_policies=40, n_namespaces=4, seed=9))
    donor = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=300, n_policies=8, n_namespaces=4, seed=10))
    engines = {d: kvt.PackedIncrementalVerifier(cluster, device=d) for d in ("cuda", "cpu")}
    mf = {d: kvt.PackedIncrementalVerifier(cluster, device=d, keep_matrix=False)
          for d in ("cuda", "cpu")}
    pols = list(cluster.policies)
    ops = [
        ("add_policy", dataclasses.replace(donor.policies[0], name="d0")),
        ("update_policy", dataclasses.replace(pols[1], ingress=pols[2].ingress)),
        ("remove_policy", pols[3].namespace, pols[3].name),
        ("update_pod_labels", 7, {"fresh": "pair"}),
        ("update_pod_labels", 8, dict(cluster.pods[9].labels)),
        ("remove_pod", cluster.pods[11].namespace, cluster.pods[11].name),
        ("add_pod", kvt.Pod("new-a", cluster.pods[0].namespace, {"app": "a"})),
        ("add_pod", kvt.Pod("new-b", cluster.pods[0].namespace, {"app": "b"})),
        ("update_namespace_labels", cluster.namespaces[1].name, {"relabel": "x"}),
    ] + [("add_pod", kvt.Pod(f"grow-{i}", "ns-0", {"app": "g"})) for i in range(90)]
    for op, *args in ops:
        for group in (engines, mf):
            for e in group.values():
                getattr(e, op)(*args)
            _same_state(group["cpu"].state_dict(), group["cuda"].state_dict(), op)
    assert engines["cuda"]._n_padded > 384  # the pod axis grew
    for e in engines.values():
        e.closure_packed()
    _same_state(engines["cpu"].state_dict(), engines["cuda"].state_dict(), "closure")
    rows = [0, 7, 299, 300]
    np.testing.assert_array_equal(engines["cuda"].solve_rows(rows),
                                  engines["cpu"].solve_rows(rows))
    np.testing.assert_array_equal(mf["cuda"].solve_stripe(0, 256),
                                  mf["cpu"].solve_stripe(0, 256))
    for group in (engines, mf):
        got = batched.packed_any_port(*group["cuda"]._maps, group["cuda"]._col_mask,
                                      group["cuda"]._row_valid, [0, 5, 299], [0, 1, 2, 2],
                                      [4, 5, 6, 299], self_traffic=True, default_allow=True)
        want = batched.packed_any_port(*group["cpu"]._maps, group["cpu"]._col_mask,
                                       group["cpu"]._row_valid, [0, 5, 299], [0, 1, 2, 2],
                                       [4, 5, 6, 299], self_traffic=True, default_allow=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    state = engines["cuda"].state_dict()
    back = kvt.PackedIncrementalVerifier.from_state(
        engines["cuda"].as_cluster(include_inactive=True), state)
    _same_state(state, back.state_dict(), "from_state on the card")


# ---------------------------------------------------------------------------
# the port-bitmap engine on the card
# ---------------------------------------------------------------------------


def _same_ports_state(want, got, label):
    _same_state(want[0], got[0], label)
    assert want[1] == got[1], label


def test_ports_engine_on_card_matches_cpu(cuda_device):
    """The build launches ``fused_ports_reach`` exactly once (and
    ``packed_dir_allow`` never); over a short stream that grows the pod
    axis, the card's ``state_dict`` equals the CPU engine's after every op."""
    import dataclasses

    gen = dict(n_pods=250, n_policies=30, n_namespaces=4, p_ports=0.8,
               p_named_port=0.3, p_container_ports=0.5)
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=12, **gen))
    donor = kvt.random_cluster(kvt.GeneratorConfig(seed=13, **gen))
    before = (packed_dir_allow.launches, fused_ports_reach.launches)
    card = kvt.PackedPortsIncrementalVerifier(cluster, pod_headroom=6)
    assert (packed_dir_allow.launches, fused_ports_reach.launches) == (
        before[0], before[1] + 1)
    assert card._packed.device.type == "cuda"
    engines = {"cuda": card, "cpu": kvt.PackedPortsIncrementalVerifier(
        cluster, device="cpu", pod_headroom=6)}
    _same_ports_state(engines["cpu"].state_dict(), card.state_dict(), "build")
    one_shot = kvt.tiled_k8s_reach(kvt.encode_cluster(cluster, compute_ports=True),
                                   fetch=False)
    w = -(-250 // 32)
    assert torch.equal(card._packed[:250, :w], one_shot.packed[:, :w])
    launched = fused_ports_reach.launches  # the build's and the one-shot's
    pols = list(cluster.policies)
    ops = [
        ("update_policy", dataclasses.replace(pols[1], ingress=pols[2].ingress)),
        ("remove_policy", pols[3].namespace, pols[3].name),
        ("update_pod_labels", 7, {"fresh": "pair"}),
        ("update_pod_labels", 8, dict(cluster.pods[9].labels)),
        ("remove_pod", cluster.pods[11].namespace, cluster.pods[11].name),
        ("update_namespace_labels", cluster.namespaces[1].name, {"relabel": "x"}),
    ] + [("add_pod", kvt.Pod(f"grow-{i}", "ns-0", {"app": "g"},
                             container_ports=dict(cluster.pods[i].container_ports)))
         for i in range(12)]
    for i, p in enumerate(donor.policies[:4]):
        ops.insert(i, ("add_policy", dataclasses.replace(p, name=f"d{i}")))
    applied = 0
    for op, *args in ops:
        try:
            getattr(engines["cpu"], op)(*args)
        except kvt.PortUniverseChanged:
            continue  # a donor mask outside the frozen universe
        getattr(card, op)(*args)
        applied += 1
        _same_ports_state(engines["cpu"].state_dict(), card.state_dict(), op)
    assert applied >= len(ops) - 2 and card._n_padded > 256  # the pod axis grew
    assert fused_ports_reach.launches == launched  # the diffs launch no kernel
    state = card.state_dict()
    back = kvt.PackedPortsIncrementalVerifier.from_state(
        card.as_cluster(include_inactive=True), *state)
    _same_ports_state(state, back.state_dict(), "from_state on the card")
    for e in engines.values():
        e.closure_packed()
    _same_ports_state(engines["cpu"].state_dict(), card.state_dict(), "closure")


def test_dense_engine_on_card_matches_cpu(cuda_device):
    """The dense engine on the card against the dense engine on the CPU:
    the count matrices, isolation counts and reach equal after the build
    and after every op; the query twins and the posture ops on the card
    equal the CPU's on the same state."""
    import dataclasses

    from kubernetes_verification_tpu_torch.ops import batched, posture
    from kubernetes_verification_tpu_torch.ops.device_state import dense_query_state

    c = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=300, n_policies=30, n_namespaces=4, seed=12, p_ipblock_peer=0.0))
    donor = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=300, n_policies=30, n_namespaces=4, seed=13, p_ipblock_peer=0.0))
    cfg = kvt.VerifyConfig(compute_ports=False)
    engines = {d: kvt.IncrementalVerifier(c, cfg, device=d) for d in ("cuda", "cpu")}
    ops = [("add_policy", dataclasses.replace(donor.policies[i], name=f"x{i}")) for i in range(4)]
    ops += [("update_policy", dataclasses.replace(c.policies[3], ingress=())),
            ("remove_policy", c.policies[7].namespace, c.policies[7].name),
            ("update_pod_labels", 17, {"app": "unseen"}),
            ("update_pod_labels", 200, dict(c.pods[4].labels)),
            ("update_namespace_labels", "ns1", dict(c.namespaces[2].labels))]
    for op, *args in [("build",)] + ops:
        for e in engines.values():
            if op != "build":
                getattr(e, op)(*args)
        g, w = engines["cuda"], engines["cpu"]
        assert torch.equal(g._ing_count.cpu(), w._ing_count), op
        assert torch.equal(g._eg_count.cpu(), w._eg_count), op
        assert np.array_equal(g._ing_iso, w._ing_iso) and np.array_equal(g._eg_iso, w._eg_iso)
        assert np.array_equal(g.reach, w.reach), op
    flags = dict(self_traffic=True, default_allow_unselected=True)
    src, dst = [0, 5, 299, 17], [3, 3, 150]
    states = {d: dense_query_state(e, 1, with_reach_words=True) for d, e in engines.items()}
    for d, s in states.items():
        a = s.arrays
        rows = batched.batched_reach_rows(a["ing_count"], a["eg_count"], a["ing_iso"],
                                          a["eg_iso"], src, **flags)
        cols = batched.batched_reach_cols(a["ing_count"], a["eg_count"], a["ing_iso"],
                                          a["eg_iso"], dst, **flags)
        assert np.array_equal(rows, engines["cpu"].reach[src]), d
        assert np.array_equal(cols, engines["cpu"].reach[:, dst]), d
    g, w = (states[d].arrays["reach_words"] for d in ("cuda", "cpu"))
    assert torch.equal(g.cpu(), w)
    for got, want in zip(posture.packed_xor_popcount(g, g.flip(0)),
                         posture.packed_xor_popcount(w, w.flip(0))):
        assert torch.equal(got.cpu(), want)
    counts = posture.packed_row_popcount(g)
    assert torch.equal(posture.topk_changed_rows(counts, 8)[1].cpu(),
                       posture.topk_changed_rows(counts.cpu(), 8)[1])


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_service_on_card_matches_cpu(cuda_device, kind):
    """The serving plane on the card against the same service on the CPU:
    after every batch of a stream with resyncs, ``reach``, the packed
    words, ``can_reach_batch``, the posture record, the violations and
    ``ServeStats`` are equal, and no answer came from the CPU fallback."""
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.serve import (
        PodSelector,
        QueryEngine,
        VerificationService,
    )
    from kubernetes_verification_tpu_torch.serve.queries import Assertion

    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=300, n_policies=30, n_namespaces=5, seed=8))
    events = random_event_stream(cluster, n_events=300, seed=3, p_resync=0.01)
    cfg = kvt.VerifyConfig(compute_ports=False)

    def build(dev):
        if kind == "dense":
            svc = VerificationService(cluster, cfg, device=dev)
        else:
            svc = VerificationService(engine=kvt.PackedIncrementalVerifier(
                cluster, cfg, device=dev, keep_matrix=True))
        svc.assertions = [
            Assertion("a", "allow", PodSelector(namespace="ns0"), PodSelector(namespace="ns0")),
            Assertion("d", "deny", PodSelector(namespace="ns1"), PodSelector(namespace="ns2")),
        ]
        svc.enable_posture()
        return svc, QueryEngine(svc)

    (card, q_card), (host, q_host) = build(cuda_device), build("cpu")
    refs = [f"{p.namespace}/{p.name}" for p in cluster.pods]
    rng = np.random.default_rng(1)
    for i in range(0, len(events), 50):
        for svc in (card, host):
            svc.apply(events[i:i + 50])
        assert np.array_equal(card.reach(), host.reach()), i
        if kind == "packed":
            assert torch.equal(card.engine._packed.cpu(), host.engine._packed), i
        probes = [(refs[a], refs[b]) for a, b in rng.integers(0, len(refs), (256, 2))]
        assert np.array_equal(q_card.can_reach_batch(probes), q_host.can_reach_batch(probes))
        rc, rh = card.posture.records[-1].to_dict(), host.posture.records[-1].to_dict()
        for d in (rc, rh):
            d.pop("ts"), d.pop("delta_s")
        assert rc == rh, i
        assert [v.describe() for v in card.violations] == [v.describe() for v in host.violations]
        assert card.stats.to_dict() == host.stats.to_dict(), i
    assert "fallback" not in card.stats.solves
    assert card._breaker.state == "closed"
    # the threaded worker on the card gives the same reach
    (card, _), (host, _) = build(cuda_device), build("cpu")
    card.start()
    try:
        card.submit(events[:100])
        card.flush(timeout=300)
    finally:
        card.close()
    host.apply(events[:100])
    assert np.array_equal(card.reach(), host.reach())


def test_card_service_failure_reaches_the_caller(cuda_device):
    """A failed derivation of a dense service on the card reaches the
    caller: no answer is taken from the host, the breaker opens after three
    failures and fails fast, and past the cooldown a probe on the card
    closes it with ``reach`` equal to the same service on the CPU."""
    from kubernetes_verification_tpu_torch.observe.events import Clock, get_clock, set_clock
    from kubernetes_verification_tpu_torch.resilience.errors import BackendError, DeviceLost
    from kubernetes_verification_tpu_torch.serve import VerificationService

    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=200, n_policies=20, n_namespaces=4, seed=5))
    card = VerificationService(cluster, device=cuda_device)
    host = VerificationService(cluster, device="cpu")
    assert not card._host_fallback and host._host_fallback
    calls = [0]

    def lost():
        calls[0] += 1
        raise DeviceLost("forced device loss", backend="dense")

    for k in range(3):
        card.engine._reach_dirty = True
        card.engine._iso_tensors = lost
        with pytest.raises(DeviceLost):
            card.reach()
    with pytest.raises(BackendError) as e:
        card.reach()
    assert e.value.kind == "breaker_open" and calls[0] == 3
    assert card._fallback_reach is None and "fallback" not in card.stats.solves
    del card.engine._iso_tensors
    prev = get_clock()

    class AfterCooldown(Clock):
        def perf(self) -> float:
            return super().perf() + card.serve_config.breaker_cooldown

    set_clock(AfterCooldown())
    try:
        got = card.reach()
    finally:
        set_clock(prev)
    assert np.array_equal(got, host.reach())
    assert card._breaker.transitions == ["open", "half_open", "closed"]


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_follower_on_card_matches_cpu(cuda_device, kind, tmp_path):
    """A follower on the card and one on the CPU bootstrap from the same
    leader checkpoint and tail the same WAL: equal engine state (packed
    words, or the dense counts) and answers after every batch; the card's
    answers come from the card (its engine's tensors live there)."""
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.serve import (
        CheckpointManager,
        EventSource,
        FollowerService,
        VerificationService,
        WalWriter,
    )

    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=300, n_policies=30, n_namespaces=4, seed=3, p_ipblock_peer=0.0))
    cfg = kvt.VerifyConfig(compute_ports=False)
    events = random_event_stream(cluster, n_events=120, seed=4)
    if kind == "packed":
        leader = VerificationService(engine=kvt.PackedIncrementalVerifier(
            cluster, cfg, device="cpu", keep_matrix=True))
    else:
        leader = VerificationService(cluster, cfg, device="cpu")
    log, ck = str(tmp_path / "events.jsonl"), str(tmp_path / "ck")
    writer = WalWriter(log, epoch=1, fsync=False)
    src = EventSource(log)
    writer.append(events[:40])
    for b in src.batches(64):
        leader.apply(b)
    CheckpointManager(ck, fsync=False).checkpoint(
        leader.engine, log_path=log, log_offset=src.offset, last_seq=src.last_seq)
    card = FollowerService(ck, log_path=log, replica="card", device=cuda_device,
                           auto_catch_up=False)
    host = FollowerService(ck, log_path=log, replica="host", device="cpu",
                           auto_catch_up=False)
    assert card.service.packed == (kind == "packed")
    names = [f"{p.namespace}/{p.name}" for p in cluster.pods]
    rng = np.random.default_rng(1)
    probes = [(names[a], names[b]) for a, b in rng.integers(0, 300, (256, 2))]
    for i in range(40, 120, 20):
        writer.append(events[i:i + 20])
        assert card.poll() == host.poll() == 20
        if kind == "packed":
            assert card.service.engine._packed.is_cuda
            assert torch.equal(card.service.engine._packed.cpu(), host.service.engine._packed)
        else:
            assert card.service.engine._ing_count.is_cuda
            assert torch.equal(card.service.engine._ing_count.cpu(),
                               host.service.engine._ing_count)
        assert np.array_equal(card.can_reach_batch(probes), host.can_reach_batch(probes))
        assert card.who_can_reach_batch(names[:4]) == host.who_can_reach_batch(names[:4])
        assert card.generation == host.generation
    writer.close()


@pytest.mark.parametrize("n,k", [(301, 3), (64, 4)])
def test_stripes_on_card_match_cpu(cuda_device, n, k, tmp_path):
    """Stripe followers on the card and on the CPU over the same events:
    every stripe's counts equal, the coordinators' answers equal, the
    1/K + ε state bound held, and a stripe checkpoint written on the card
    recovered on the CPU."""
    from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
    from kubernetes_verification_tpu_torch.serve import (
        CheckpointManager,
        RecoveryManager,
        StripeCoordinator,
        StripeFollower,
    )

    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=n, n_policies=24, n_namespaces=4, seed=7, p_ipblock_peer=0.0))
    cfg = kvt.VerifyConfig(compute_ports=False)
    events = random_event_stream(cluster, n_events=60, seed=2)
    card = [StripeFollower(cluster, cfg, stripe=(s, k), device=cuda_device) for s in range(k)]
    host = [StripeFollower(cluster, cfg, stripe=(s, k), device="cpu") for s in range(k)]
    for i in range(0, 60, 15):
        for a, b in zip(card, host):
            a.apply(events[i:i + 15])
            b.apply(events[i:i + 15])
            assert a.engine._ing_count.is_cuda
            assert torch.equal(a.engine._ing_count.cpu(), b.engine._ing_count)
            assert torch.equal(a.engine._eg_count.cpu(), b.engine._eg_count)
            assert a.engine.state_bytes() <= 2 * n * n * 4 / k + 64 * n
    cc = StripeCoordinator(card, pods=cluster.pods)
    hc = StripeCoordinator(host, pods=cluster.pods)
    assert cc.device.type == "cuda" and hc.device.type == "cpu"
    names = [f"{p.namespace}/{p.name}" for p in cluster.pods]
    rng = np.random.default_rng(3)
    q = [(names[a], names[b]) for a, b in rng.integers(0, n, (512, 2))]
    assert np.array_equal(cc.can_reach_batch(q), hc.can_reach_batch(q))
    assert cc.who_can_reach_batch(names[:8]) == hc.who_can_reach_batch(names[:8])
    assert cc.blast_radius_batch(names[:8]) == hc.blast_radius_batch(names[:8])
    assert cc.hops(names[0], names[-1], 4) == hc.hops(names[0], names[-1], 4)
    card[1].checkpoint(CheckpointManager(str(tmp_path), fsync=False))
    res = RecoveryManager(str(tmp_path)).recover_stripe((1, k), config=cfg, device="cpu")
    assert torch.equal(res.service.engine._ing_count, host[1].engine._ing_count)


def test_sharded_packed_world_one_nccl_matches_tiled(cuda_device):
    """A world-1 NCCL ``sharded-packed`` solve equals ``tiled_k8s_reach`` on
    the card, any-port and with port bitmaps, and its packed closure equals
    ``PackedReach.closure``; run in a child process, so this one joins no
    process group."""
    import os
    import subprocess
    import sys

    code = (
        "import numpy as np, torch.distributed as dist, kubernetes_verification_tpu_torch as k\n"
        "c = k.random_cluster(k.GeneratorConfig(n_pods=700, n_policies=60, n_namespaces=4,"
        " p_ports=0.7, seed=3))\n"
        "m = k.mesh_for()\n"
        "assert dist.get_backend() == 'nccl' and m.device.type == 'cuda'\n"
        "for ports in (False, True):\n"
        "    enc = k.encode_cluster(c, compute_ports=ports)\n"
        "    pk = k.sharded_packed_reach(m, enc, tile=64, chunk=32, keep_matrix=True)\n"
        "    ref = k.tiled_k8s_reach(enc)\n"
        "    w = -(-enc.n_pods // 32)\n"
        "    assert np.array_equal(pk.packed[:, :w], ref.packed[:, :w]), ports\n"
        "    assert pk.total_pairs == int(ref.out_degree().sum()), ports\n"
        "    assert np.array_equal(pk.ingress_isolated, ref.ingress_isolated), ports\n"
        "closed = k.sharded_packed_closure(m, pk.packed)\n"
        "assert np.array_equal(closed[:, :w], ref.closure().packed[:, :w])\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout + proc.stderr


def test_mesh_engines_world_one_nccl_match_one_device(cuda_device):
    """Both serving engines on a ``(1, 1)`` NCCL mesh equal the one-device
    engines on the card after every op of a stream (the words, and the
    whole state at the end), the any-port one matrix-free too (its stripes
    == the one-device words); run in a child process, so this one joins no
    process group."""
    import os
    import subprocess
    import sys

    code = (
        "import dataclasses, numpy as np, torch, torch.distributed as dist\n"
        "import kubernetes_verification_tpu_torch as k\n"
        "c = k.random_cluster(k.GeneratorConfig(n_pods=700, n_policies=60, n_namespaces=4,"
        " p_ports=0.7, seed=3))\n"
        "m = k.mesh_for()\n"
        "assert dist.get_backend() == 'nccl' and m.device.type == 'cuda'\n"
        "pols = list(c.policies)\n"
        "ops = [('remove_policy', (pols[0].namespace, pols[0].name)),\n"
        "       ('add_policy', (dataclasses.replace(pols[0], name='readd'),)),\n"
        "       ('update_pod_labels', (5, {'zz': 'qq'})),\n"
        "       ('remove_pod', (c.pods[9].namespace, c.pods[9].name)),\n"
        "       ('add_pod', (k.Pod('new', c.pods[1].namespace, {'app': 'n'}),)),\n"
        "       ('update_namespace_labels', (c.namespaces[1].name, {'fresh': 'x'}))]\n"
        "def same(a, b):\n"
        "    a, b = (x[0] if isinstance(x, tuple) else x for x in (a, b))\n"
        "    return sorted(a) == sorted(b) and all(\n"
        "        np.asarray(a[key]).tobytes() == np.asarray(b[key]).tobytes() for key in a)\n"
        "for cls, kw in ((k.PackedIncrementalVerifier, {'keep_matrix': True}),\n"
        "                (k.PackedPortsIncrementalVerifier, {})):\n"
        "    ports = cls is k.PackedPortsIncrementalVerifier\n"
        "    cfg = k.VerifyConfig(compute_ports=ports)\n"
        "    one = cls(c, cfg)\n"
        "    eng = cls(c, cfg, mesh=m, **kw)\n"
        "    mf = None if ports else cls(c, cfg, mesh=m, keep_matrix=False)\n"
        "    assert same(eng.state_dict(), one.state_dict())\n"
        "    for op, args in ops:\n"
        "        for e in (one, eng, mf):\n"
        "            if e is not None:\n"
        "                getattr(e, op)(*args)\n"
        "        assert torch.equal(eng._packed, one._packed), op\n"
        "    assert same(eng.state_dict(), one.state_dict())\n"
        "    if mf is not None:\n"
        "        for d0, words in mf.sweep_dirty(128):\n"
        "            want = one._packed[:one.n_pods, d0 // 32:(d0 + 128) // 32]\n"
        "            assert np.array_equal(words, want.cpu().numpy().view(np.uint32)), d0\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout + proc.stderr


@pytest.mark.parametrize("compute_ports", [False, True])
def test_datalog_backend_on_card_matches_torch(cuda_device, compute_ports):
    """``verify(backend="datalog")`` on the card (its default: torch einsum
    rules) equals its own NumPy route on every field and the ``torch``
    backend on the reach, selection and isolation (and on the policy sets
    any-port: with port atoms the Datalog sets drop the peers of a rule
    whose named ports resolve on no pod, as the JAX package's do —
    ``ROADMAP.md`` §3); the kano program equals ``verify_kano``'s."""
    c = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=300, n_policies=40, n_namespaces=4, p_ports=0.6, seed=5))
    got = kvt.verify(c, kvt.VerifyConfig(backend="datalog", compute_ports=compute_ports,
                                         closure=True))
    want = kvt.verify(c, kvt.VerifyConfig(backend="torch", compute_ports=compute_ports,
                                          closure=True))
    host = kvt.verify(c, kvt.VerifyConfig(backend="datalog", compute_ports=compute_ports,
                                          backend_options=(("use_torch", False),)))
    for f in ("reach", "reach_ports", "selected", "src_sets", "dst_sets",
              "ingress_isolated", "egress_isolated", "closure"):
        w, g = getattr(want, f), getattr(got, f)
        assert (w is None) == (g is None), f
        if w is None:
            continue
        if f != "closure":
            np.testing.assert_array_equal(g, getattr(host, f), err_msg=f)
        if not (compute_ports and f in ("src_sets", "dst_sets")):
            np.testing.assert_array_equal(g, w, err_msg=f)
    cs, ps = kvt.random_kano(400, 40, seed=2)
    kg = kvt.verify_kano(cs, ps, kvt.VerifyConfig(backend="datalog"))
    kw = kvt.verify_kano(*kvt.random_kano(400, 40, seed=2), kvt.VerifyConfig(backend="torch"))
    np.testing.assert_array_equal(kg.reach, kw.reach)
    np.testing.assert_array_equal(kg.src_sets, kw.src_sets)


def test_sentinel_suite_runs_on_the_card(cuda_device):
    """``run_calibration`` on ``cuda:0``: the three chains at the card's
    size, timed with CUDA events, and the dispatch probe."""
    from kubernetes_verification_tpu_torch.observe.sentinel import run_calibration

    ctx = run_calibration(cuda_device, reps=3)
    assert ctx["platform"] == "gpu" and ctx["device"] == torch.cuda.get_device_name(0)
    assert set(ctx["kernels"]) == {"mxu_int8", "mxu_f32", "vpu_bitops"}
    assert ctx["kernels"]["mxu_int8"]["config"] == {"n": 8192, "loops": 64}
    assert all(k["median_s"] > 0 for k in ctx["kernels"].values())
    assert ctx["dispatch_s"] > 0 and ctx["calibrated_peak_macs_per_s"] > 0


_WARM_CHILD = r"""
import json, os, sys
import numpy as np, torch
from kubernetes_verification_tpu_torch.observe import aot
from kubernetes_verification_tpu_torch.ops import cuda_build
from kubernetes_verification_tpu_torch.ops.kernels import (
    packed_dir_allow, packed_dir_allow_reference)

cuda_build.BUILD_DIR = sys.argv[2]
assert not os.listdir(sys.argv[2]) and cuda_build.nvcc_version() is None
summary = aot.load_pack(sys.argv[1])
rng = np.random.default_rng(7)
a, b = ((rng.random((77, 384)) < 0.05).astype(np.int8) for _ in range(2))
niso = np.broadcast_to((rng.random(384) < 0.5).astype(np.int32), (8, 384)).copy()
ta, tb, tn = (torch.as_tensor(x, device="cuda") for x in (a, b, niso))
got = packed_dir_allow(ta, tb, tn, default_allow_axis=1)
want = packed_dir_allow_reference(ta, tb, tn, default_allow_axis=1)
print(json.dumps({"loaded": summary["loaded"], "hits": aot.hit_total(),
                  "misses": aot.miss_total(), "nvcc": cuda_build.counts()["nvcc_runs"],
                  "launches": packed_dir_allow.launches,
                  "equal": bool(torch.equal(got, want))}))
"""


def test_pack_loads_in_a_process_without_nvcc(cuda_device, tmp_path):
    """A pack saved here, loaded in a process with an empty build directory,
    no ``nvcc`` on its ``PATH`` and ``CUDA_HOME`` at an empty directory:
    both libraries load from the pack (no compiler run) and
    ``packed_dir_allow`` equals its plain version."""
    import json
    import os
    import subprocess
    import sys

    from kubernetes_verification_tpu_torch.observe import aot
    from kubernetes_verification_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    saved = aot.save_pack(str(tmp_path / "pack"))
    assert saved["libraries"] == ["fused_ports_reach", "packed_dir_allow"]
    (tmp_path / "build").mkdir()
    (tmp_path / "no-cuda").mkdir()
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "no-cuda"), PATH=os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc"))))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join([root, env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-c", _WARM_CHILD, str(tmp_path / "pack"), str(tmp_path / "build")],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"loaded": 2, "hits": 2, "misses": 0, "nvcc": 0, "launches": 1,
                   "equal": True}


def test_native_backend_matches_torch_on_card(cuda_device):
    """``verify(backend="native")`` (host C++) equals ``torch`` on the card
    at 2,000 pods, any-port with closure and with port bitmaps."""
    if "native" not in kvt.available_backends():
        pytest.skip("the native backend needs a C++ compiler")
    c = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=2_000, n_policies=200, n_namespaces=10, seed=1))
    for flags in (dict(closure=True), dict(compute_ports=True)):
        got = kvt.verify(c, kvt.VerifyConfig(backend="native", **flags))
        want = kvt.verify(c, kvt.VerifyConfig(backend="torch", **flags))
        for f in ("reach", "reach_ports", "closure", "selected", "src_sets", "dst_sets",
                  "ingress_isolated", "egress_isolated"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f
            if g is not None:
                np.testing.assert_array_equal(g, w, err_msg=f)


def test_cli_runs_on_the_card_by_default(cuda_device, tmp_path, capsys):
    """``kv-tpu-torch verify`` without ``--device`` runs on the card and
    prints what ``--device cpu`` prints (up to timings), the sharded
    backend on a 1-rank NCCL group included; ``snapshot
    --no-ports`` launches ``packed_dir_allow`` exactly twice, with port
    bitmaps ``fused_ports_reach`` once, and its checkpoint loads back on
    the card with the host run's words."""
    import json

    from kubernetes_verification_tpu_torch.cli import _load_incremental, main

    d = str(tmp_path / "c")
    assert main(["generate", d, "--pods", "300", "--policies", "30"]) == 0
    outs = {}
    for dev in ((), ("--device", "cpu")):
        for flags in ((), ("--no-ports", "--closure")):
            capsys.readouterr()
            assert main(["verify", d, "--json", *flags, *dev]) == 0
            out = json.loads(capsys.readouterr().out)
            out.pop("timings")
            outs[(dev, flags)] = out
    for flags in ((), ("--no-ports", "--closure")):
        assert outs[((), flags)] == outs[(("--device", "cpu"), flags)]
        assert outs[((), flags)]["backend"] == "torch"
    # a bare "cuda" names this rank's card to the sharded backends' mesh
    for dev in ((), ("--device", "cpu")):
        capsys.readouterr()
        assert main(["verify", d, "--json", "--backend", "sharded-packed", "--no-ports",
                     *dev]) == 0
        out = json.loads(capsys.readouterr().out)
        out.pop("timings")
        outs[dev] = out
    assert outs[()] == outs[("--device", "cpu")]
    assert not torch.distributed.is_initialized()  # the command left its group
    for flags, launches in ((("--no-ports",), (2, 0)), ((), (0, 1))):
        before = (packed_dir_allow.launches, fused_ports_reach.launches)
        ck = str(tmp_path / f"ck{len(flags)}")
        assert main(["snapshot", d, ck, "--json", *flags]) == 0
        after = (packed_dir_allow.launches, fused_ports_reach.launches)
        assert (after[0] - before[0], after[1] - before[1]) == launches
        cpu_ck = ck + "-cpu"
        assert main(["snapshot", d, cpu_ck, "--json", "--device", "cpu", *flags]) == 0
        card, host = _load_incremental(ck), _load_incremental(cpu_ck, device="cpu")
        assert card._packed.device.type == "cuda"
        w = -(-300 // 32)
        assert torch.equal(card._packed[:300, :w].cpu(), host._packed[:300, :w])


def test_bench_runs_on_the_card_by_default(cuda_device, tmp_path, capsys, monkeypatch):
    """The port's bench entry point without ``--device`` solves on the card
    through the hand-written kernels (any-port and port bitmaps), its
    records name the card, and the solve's pairs equal ``--device cpu``'s."""
    import json
    import re

    from kubernetes_verification_tpu_torch import bench

    monkeypatch.setenv("KVTPU_BENCH_NO_SENTINEL", "1")
    monkeypatch.setenv("KVTPU_BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    small = ["--mode", "tiled", "--pods", "2048", "--policies", "128", "--repeats", "2"]

    def run(argv):
        capsys.readouterr()
        try:
            assert bench.main(argv) == 0
        finally:
            bench._BENCH_MODE = bench._SENTINEL_CTX = bench._DEVICE = None
        out, err = capsys.readouterr()
        rec = json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])
        summary = json.loads(err.splitlines()[-1].split(" ", 1)[1])
        return rec, err, summary

    for ports, kernel in ((("--no-ports",), "packed_dir_allow"), ((), "fused_ports_reach")):
        rec, err, summary = run([*small, *ports])
        assert rec["device"] == torch.cuda.get_device_name(cuda_device)
        assert rec["platform"] == "gpu" and rec["warm_parity"] is True
        assert f"kernel={kernel}" in err and summary["launches"][kernel] > 0
        _, cpu_err, _ = run([*small, *ports, "--device", "cpu"])
        pairs = lambda e: re.findall(r"(\d+) reachable pairs", e)  # noqa: E731
        assert pairs(err) == pairs(cpu_err) != []
