"""The port's entry points (``kubernetes_verification_tpu_torch/
graft_entry.py``) against the root ``__graft_entry__.py``.

``entry()``: the port's step on the CPU equals ``jax.jit(fn)(*args)`` of the
root file's, field for field, exactly. ``dryrun_multichip``: its eleven
stages run on 2 and 4 gloo CPU ranks through the module's own launcher
(``_launch``, which ``dryrun_multichip`` calls at the reference's sizes);
stages 1–3, 5 and 7–9 at the reference's own sizes, stages 4, 6, 10 and 11
at a cut base (200 pods, tiled 8×). Every rank's arrays equal rank 0's, and
rank 0's are held here against the JAX package's ``cpu`` oracle on the same
seeds. The full-size run is ``slow``."""
import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import kubernetes_verification_tpu as jkv
from kubernetes_verification_tpu.harness.generate import GeneratorConfig as JGen
from kubernetes_verification_tpu.harness.generate import random_cluster as jrandom_cluster
from kubernetes_verification_tpu.ops.tiled import unpack_cols as junpack_cols
from kubernetes_verification_tpu_torch import graft_entry
from kubernetes_verification_tpu_torch.resilience.errors import BackendError, ConfigError

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
#: stages 4, 6, 10 and 11 cut: a 200-pod base tiled 8× (1,600 pods). Seed
#: 55: at 200 pods the reference's seed 44 gives a policy 1 that selects no
#: pod, so its diff would mark no column dirty. The live bytes are held
#: under one dense [N, N] int32 here; under 1 % of it is the reference's
#: claim at 250,000 pods (the slow test and the card's phase 39 hold it).
CUT = dataclasses.replace(
    graft_entry.Sizes(),
    base_gen=(("n_pods", 200), ("n_policies", 24), ("n_namespaces", 4),
              ("p_ipblock_peer", 0.0), ("min_selector_labels", 1), ("seed", 55)),
    stripe_reps=8, engine_reps=8, live_fraction=1.0,
)
STAGES = tuple(range(1, 12))


def _load_root_entry():
    spec = importlib.util.spec_from_file_location("graft_root", REPO / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jcluster(items):
    return jrandom_cluster(JGen(**dict(items)))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if dataclasses.is_dataclass(x):
        return {f.name: _host(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return np.asarray(x)


def _same(a, b, path="arg"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
        return
    np.testing.assert_array_equal(a, b, err_msg=path)
    assert a.dtype == b.dtype, path


# ------------------------------------------------------------------ entry()
def test_entry_equals_the_jax_entry_exactly():
    import jax

    jfn, jargs = _load_root_entry().entry()
    want = jax.jit(jfn)(*jargs)
    fn, args = graft_entry.entry(device="cpu")
    assert len(args) == len(jargs) == 11
    for a, ja in zip(args, jargs):
        _same(_host(a), _host(ja))
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cpu"
    got = fn(*args)
    assert type(got).__name__ == "K8sOut" and got._fields == want._fields
    for name in got._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert fn.keywords == jfn.keywords


def test_entry_and_the_dryrun_refuse_the_cpu_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(BackendError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(BackendError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)  # before any rank starts
    with pytest.raises(ConfigError):
        graft_entry.dryrun_multichip(0, device="cpu")


@pytest.mark.parametrize("n,shape", [(8, (4, 2)), (4, (2, 2)), (2, (2, 1)), (1, (1, 1)),
                                     (6, (3, 2)), (9, (3, 3))])
def test_mesh_shape_is_the_references_factorisation(n, shape):
    assert graft_entry.mesh_shape(n) == shape


# ----------------------------------------------------------- the stages
@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def run(request, tmp_path_factory):
    """Every stage on ``world`` gloo CPU ranks, once per module: the ranks'
    reports and each stage's arrays, every rank's equal to rank 0's."""
    world = request.param
    workdir = str(tmp_path_factory.mktemp(f"graft{world}"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # one core a rank beside the other workers
        reports = graft_entry._launch(world, "cpu", CUT, STAGES, workdir, save_arrays=True)
    arrays = {}
    for k in STAGES:
        per_rank = []
        for r in range(world):
            with np.load(f"{workdir}/stage{k}.r{r}.npz") as z:
                per_rank.append({key: z[key] for key in z.files})
        arrays[k] = per_rank
    return {"world": world, "reports": reports, "arrays": arrays}


def _rank0(run, k):
    return run["arrays"][k][0]


@pytest.mark.parametrize("k", [k for k in STAGES if k != 11])
def test_every_rank_returns_the_same_arrays(run, k):
    ranks = run["arrays"][k]
    for r, res in enumerate(ranks[1:], 1):
        assert res.keys() == ranks[0].keys(), (k, r)
        for key in res:
            np.testing.assert_array_equal(res[key], ranks[0][key], err_msg=f"rank {r} {key}")


def test_the_reports(run):
    world = run["world"]
    assert [r["rank"] for r in run["reports"]] == list(range(world))
    for r in run["reports"]:
        assert sorted(r["seconds"], key=int) == [str(k) for k in STAGES]
        assert r["launches"] == [0, 0]  # the mesh paths' products are bool_dot
        assert r["peak_device_gib"] is None and r["peak_host_gib"] > 0
        assert 0 < r["live"]["live_bytes"] < r["live"]["dense_bytes"]


def test_stage1_sharded_verify(run):
    got = _rank0(run, 1)
    ref = jkv.verify(_jcluster(CUT.verify_gen), jkv.VerifyConfig(backend="cpu", closure=True))
    np.testing.assert_array_equal(got["reach"], ref.reach)
    np.testing.assert_array_equal(got["closure"], ref.closure)


@pytest.mark.parametrize("k,ports", [(2, False), (3, True)])
def test_stage2_3_packed_solves(run, k, ports):
    got = _rank0(run, k)
    ref = jkv.verify(_jcluster(CUT.packed_gen),
                     jkv.VerifyConfig(backend="cpu", compute_ports=ports))
    np.testing.assert_array_equal(got["reach"], ref.reach)
    if not ports:
        np.testing.assert_array_equal(got["out_degree"], ref.reach.sum(axis=1))
        np.testing.assert_array_equal(got["in_degree"], ref.reach.sum(axis=0))


@functools.lru_cache(maxsize=None)
def _pattern(diffed: bool):
    base = _jcluster(CUT.base_gen)
    if diffed:
        diff = dataclasses.replace(base.policies[1], ingress=base.policies[2].ingress)
        base = jkv.Cluster(
            pods=list(base.pods), namespaces=list(base.namespaces),
            policies=[diff if (p.namespace, p.name) == (diff.namespace, diff.name) else p
                      for p in base.policies])
    return jkv.verify(base, jkv.VerifyConfig(backend="cpu", compute_ports=False,
                                             self_traffic=False)).reach


def test_stage4_tiled_stripe_equals_the_pattern(run):
    got = _rank0(run, 4)
    P = _pattern(diffed=False)
    B = P.shape[0]
    n = B * CUT.stripe_reps
    mp = graft_entry.mesh_shape(run["world"])[1]
    cols = np.arange(min(n, mp * CUT.stripe_tile))
    reach = P[np.arange(n)[:, None] % B, cols[None, :] % B]
    reach[cols, cols] = True  # self-traffic: the exact diagonal
    np.testing.assert_array_equal(got["out_degree"], reach.sum(axis=1))
    np.testing.assert_array_equal(got["in_degree"][cols], reach.sum(axis=0))
    assert int(got["total_pairs"]) == int(reach.sum()) > 0


def test_stage5_incremental_equals_the_oracle(run):
    got = _rank0(run, 5)
    cluster = _jcluster(CUT.packed_gen)
    pols = list(cluster.policies)
    mutated = jkv.Cluster(
        pods=list(cluster.pods), namespaces=list(cluster.namespaces),
        policies=[dataclasses.replace(pols[1], ingress=pols[2].ingress), *pols[2:],
                  dataclasses.replace(pols[0], name="dryrun-readd")])
    ref = jkv.verify(mutated, jkv.VerifyConfig(backend="cpu", compute_ports=False))
    np.testing.assert_array_equal(got["reach"], ref.reach)
    rows = [json.loads(r) for r in got["pods"]]
    assert rows == [[p.namespace, p.name, dict(p.labels)] for p in cluster.pods]


def test_stage6_matrix_free_stripe_equals_the_pattern(run):
    got = _rank0(run, 6)
    P = _pattern(diffed=True)
    B = P.shape[0]
    n, width = B * CUT.engine_reps, CUT.engine_width
    expected = P[:, np.arange(width) % B][np.arange(n) % B]
    expected[np.arange(width), np.arange(width)] = True
    np.testing.assert_array_equal(got["stripe"], expected)
    assert int(got["dirty_cols"]) > 0
    assert not np.array_equal(P, _pattern(diffed=False))  # the diff moved the pattern


def test_stage7_ports_churn_equals_the_oracle(run):
    got = _rank0(run, 7)
    cluster = _jcluster(CUT.ports_gen)
    by_name = {(p.namespace, p.name): p for p in cluster.pods}
    pods = []
    for ns, name, labels in (json.loads(r) for r in got["pods"]):
        pod = by_name.get((ns, name))
        pods.append(jkv.Pod(name, ns, labels) if pod is None
                    else dataclasses.replace(pod, labels=labels))
    assert len(pods) == len(cluster.pods) and pods[-1].name == "dryrun-new"
    assert cluster.pods[5].name not in {p.name for p in pods}
    assert pods[3].labels == dict(cluster.pods[9].labels)
    mutated = jkv.Cluster(pods=pods, namespaces=list(cluster.namespaces),
                          policies=list(cluster.policies))
    ref = jkv.verify(mutated, jkv.VerifyConfig(backend="cpu", closure=True))
    np.testing.assert_array_equal(got["reach"], ref.reach)
    act = got["active"]
    closure = junpack_cols(got["closure"], got["closure"].shape[1] * 32)
    np.testing.assert_array_equal(closure[np.ix_(act, act)], ref.closure)


def test_stage8_pair_masks_equal_the_oracle(run):
    got = _rank0(run, 8)
    ref = jkv.verify(_jcluster(CUT.packed_gen), jkv.VerifyConfig(backend="cpu"))
    assert [tuple(x) for x in got["shadow"]] == list(ref.policy_shadow())
    assert [tuple(x) for x in got["conflict"]] == list(ref.policy_conflict())


@functools.lru_cache(maxsize=None)
def _jax_closures():
    """The JAX package's one-device packed closures of stage 9's inputs:
    the whole graph, and the padded N = 1,000 case."""
    import jax.numpy as jnp

    from kubernetes_verification_tpu.ops.closure import packed_closure
    from kubernetes_verification_tpu.ops.tiled import pack_bool_cols

    n, n_odd = CUT.closure_n, CUT.odd_n
    adj = np.random.default_rng(CUT.closure_seed).random((n, n)) < (CUT.closure_degree / n)
    packed = np.asarray(pack_bool_cols(jnp.asarray(adj)))
    whole = np.asarray(packed_closure(jnp.asarray(packed), tile=CUT.closure_tile))
    odd = packed[:n_odd, :32].copy()
    odd[:, -1] &= np.uint32((1 << (n_odd % 32)) - 1)
    pad = np.zeros((32 * 32 - n_odd, 32), dtype=np.uint32)
    odd_closure = np.asarray(packed_closure(jnp.asarray(np.vstack([odd, pad])),
                                            tile=CUT.odd_tile))[:n_odd]
    return packed, whole, odd_closure


def test_stage9_sharded_closure_equals_the_one_device_closure(run):
    got = _rank0(run, 9)
    packed, whole, odd = _jax_closures()
    np.testing.assert_array_equal(got["adj"], packed)
    np.testing.assert_array_equal(got["closure"], whole)
    np.testing.assert_array_equal(got["closure_odd"], odd)
    assert not np.array_equal(whole, packed)  # the closure added paths


def test_stage10_bounded_closure_equals_the_pattern_bfs(run):
    got = _rank0(run, 10)
    P = _pattern(diffed=True)
    B = P.shape[0]
    n = B * CUT.engine_reps
    seed = int(got["seed"])
    p32 = P.astype(np.float32)
    hop_class = np.where(P[seed], 1, np.where((p32[seed] @ p32) > 0, 2, 0))
    expected = hop_class[np.arange(n) % B].astype(np.int32)
    expected[seed] = 1
    np.testing.assert_array_equal(got["hop"][0], expected)
    np.testing.assert_array_equal(got["acc"][0], expected > 0)
    assert (expected == 2).any()


def test_stage11_follower_answers_equal_the_pattern(run):
    got = _rank0(run, 11)
    P = _pattern(diffed=True)
    B = P.shape[0]
    qs, qd = got["qs"], got["qd"]
    assert len(qs) == CUT.probes and qs[0] == qd[0] == 7 and qs[1] == 7 + B
    np.testing.assert_array_equal(got["probes"], np.where(qs == qd, True, P[qs % B, qd % B]))
    for r in range(1, run["world"]):
        assert run["arrays"][11][r] == {}  # the follower lives on rank 0 only


def test_a_failing_stage_fails_the_run(tmp_path):
    """Stage 10 without stage 6's engine raises on every rank: the launcher
    raises that traceback and no rank is left running."""
    import torch.multiprocessing as mp

    with pytest.raises(mp.ProcessRaisedException, match="KeyError"):
        graft_entry._launch(2, "cpu", CUT, [10], str(tmp_path))
    assert not list(tmp_path.glob("rank*.json"))


@pytest.mark.slow
def test_dryrun_multichip_on_two_cpu_ranks_at_full_size(capfd):
    out = graft_entry.dryrun_multichip(2, device="cpu")
    lines = [x for x in capfd.readouterr().out.splitlines()
             if x.startswith("dryrun_multichip OK: ")]
    assert len(lines) == 11 and "1M-pod" in lines[3] and "250000-pod" in lines[5]
    assert out["mesh"] == [2, 1] and len(out["ranks"]) == 2
