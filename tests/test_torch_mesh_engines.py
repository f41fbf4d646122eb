"""The port's any-port serving engine on a ``(pods, grants)`` mesh against
the JAX package's, byte for byte: ``PackedIncrementalVerifier(mesh=)`` with
the matrix kept and matrix-free, through policy, pod and namespace diffs,
pod-axis and slot-axis growth, stripe and row re-solves, the closure, and
checkpoints that resume on another factorisation or on one device.

The JAX side runs on the 8 virtual CPU devices (``tests/conftest.py``),
the port's on one module-wide group of 8 gloo CPU ranks
(``tests/torch_mesh_child.py``'s ``engine`` kind) over the ``(8, 1)``,
``(4, 2)``, ``(2, 4)`` and ``(1, 8)`` meshes. After the build and after
every op the port's ``state_dict()`` (gathered from the shards) must equal
the JAX engine's key for key, in dtype, shape and bytes, on every rank.
The cases mirror ``tests/test_packed_incremental.py``'s mesh tests at their
sizes (61 pods / 9–11 policies); pod 0 is never tombstoned (the JAX
engine's ``_prewarm`` re-solves that row unmasked, a fault of the reference
the port does not copy: ROADMAP §3)."""
import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
from kubernetes_verification_tpu.harness import generate as jgen
from kubernetes_verification_tpu.packed_incremental import (
    PackedIncrementalVerifier as JaxEngine,
)
from kubernetes_verification_tpu.parallel.mesh import mesh_for as jax_mesh_for
from kubernetes_verification_tpu.utils import persist as jpersist
from kubernetes_verification_tpu_torch.utils import persist
from torch_mesh_child import MeshJob
from torch_parity import replay_ops, same_state

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
DIFFS = dict(n_pods=61, n_policies=11, n_namespaces=3, seed=43)
CKPT = dict(n_pods=61, n_policies=11, n_namespaces=3, seed=72)
CHURN = dict(n_pods=61, n_policies=9, n_namespaces=3, seed=62)
MF_CHURN = dict(n_pods=61, n_policies=9, n_namespaces=3, seed=63)
RELABEL = dict(n_pods=61, n_policies=9, n_namespaces=3, seed=66)
GROW = dict(n_pods=250, n_policies=9, n_namespaces=3, seed=64)
DONOR = dict(n_pods=61, n_policies=18, n_namespaces=3, seed=65)

DIFF_OPS = [
    ["remove_policy", {"pol": 0}],
    ["add_policy", {"pol": 0, "name": "readd"}],
    ["update_policy", {"pol": 1, "ingress_of": 2}],
    ["update_pod_labels", 5, {"zz": "qq"}],
    ["rows", [0, 5, 60]],
]
STRIPE_OPS = [
    ["update_policy", {"pol": 1, "ingress_of": 2}],
    ["remove_policy", {"pol": 3}],
    ["stripe", 0, 512],
    ["stripe", 32, 32],
    ["stripe", -32, 32],
    ["stripe", 480, 64],
    ["sweep", 32],
    ["stripe", 0, 512],
]
CHURN_OPS = [
    ["add_pod", "mesh-new", {"ns_of": 0}, {"m": "1"}],
    ["remove_pod", {"pod": 7}],
    ["update_pod_labels", 3, {"labels_of": 12}],
    *(["add_pod", f"mesh-g{i}", "ns-0", {"app": "mg"}] for i in range(6)),
    ["remove_pod", {"pod": 9}],
    ["add_pod", "mesh-back", "ns-1", {"app": "back"}],
]
MF_CHURN_OPS = [
    ["add_pod", "mf-new", {"ns_of": 0}, {"m": "1"}],
    ["remove_pod", {"pod": 9}],
    ["stripe", 0, 512],
    ["update_namespace_labels", {"ns": 0}, {"mf": "relabel"}],
    ["sweep", 64],
]
RELABEL_OPS = [
    ["update_namespace_labels", {"ns": 0}, {"ns_labels_of": 2}],
    ["add_namespace", "fresh-ns", {"team": "new"}],
    ["add_pod", "in-fresh", "fresh-ns", {"app": "f"}],
    ["update_namespace_labels", {"ns": 1}, {"completely": "fresh"}],
    ["remove_pod", {"pod": 61}],
    ["remove_namespace", "fresh-ns"],
]
#: ten pods past the padded axis (a pod-axis grow) and sixteen policies past
#: the slot capacity (a slot-axis grow, ``slot_round=8``)
GROW_OPS = [
    *(["add_pod", f"g{i}", "ns-1", {"app": f"g{i % 3}"}] for i in range(10)),
    *(["add_policy", {"donor": DONOR, "pol": j, "name": f"d{j}"}] for j in range(16)),
    ["remove_pod", {"pod": 252}],
    ["update_policy", {"pol": 1, "ingress_of": 2}],
]
CKPT_OPS = [["update_policy", {"pol": 1, "ingress_of": 2}], ["save", "ck_any"]]
RESUMED_OPS = [["remove_policy", {"pol": 0}], ["stripe", 0, 512],
               ["add_pod", "post", "ns-2", {"app": "p"}], ["sweep", 128]]

CASES = {
    **{f"diffs{s}": (s, DIFFS, DIFF_OPS, {}) for s in MESHES},
    "closure(4, 2)": ((4, 2), DIFFS, DIFF_OPS[:3], {}),
    "stripes(4, 2)": ((4, 2), DIFFS, STRIPE_OPS, {"keep_matrix": False}),
    **{f"churn{s}": (s, CHURN, CHURN_OPS, {}) for s in [(4, 2), (2, 4)]},
    "mf_churn(4, 2)": ((4, 2), MF_CHURN, MF_CHURN_OPS, {"keep_matrix": False}),
    "relabel(4, 2)": ((4, 2), RELABEL, RELABEL_OPS, {}),
    **{f"grow{s}": (s, GROW, GROW_OPS, {"slot_round": 8}) for s in [(2, 4), (1, 8)]},
    "ckpt(4, 2)": ((4, 2), CKPT, CKPT_OPS, {"keep_matrix": False}),
}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    job = MeshJob(tmp_path_factory.mktemp("mesh_engines"))
    for cid, (shape, gen, ops, build) in CASES.items():
        job.case(cid, "engine", shape, gen=gen, ops=ops, build=build,
                 closure=cid.startswith("closure"))
    # the (4, 2) checkpoint resumes at (2, 4); refused matrix-kept, and at
    # (8, 1), whose pod blocks its padding does not fill
    job.case("resumed(2, 4)", "engine", (2, 4), gen=CKPT, resume="ck_any", ops=RESUMED_OPS)
    job.case("refused(2, 4)", "engine", (2, 4), gen=CKPT, resume="ck_any",
             build={"keep_matrix": True})
    job.case("refused(8, 1)", "engine", (8, 1), gen=CKPT, resume="ck_any")
    job.case("refused_round(1, 8)", "engine", (1, 8), gen=DIFFS, build={"slot_round": 12})
    job.start()
    yield job
    job.close()


def _jax(shape, gen, build):
    cluster = jgen.random_cluster(jgen.GeneratorConfig(**gen))
    cfg = jkv.VerifyConfig(compute_ports=False)
    return cluster, JaxEngine(cluster, cfg, mesh=jax_mesh_for(shape), **build)


def _save(workdir):
    return lambda eng, name: jpersist.save_packed_incremental(eng, str(workdir / name))


def _run(job, cid):
    shape, gen, ops, build = CASES[cid]
    cluster, eng = _jax(shape, gen, build)  # compiles while the ranks work
    res = job.result(cid)
    replay_ops(res, eng, cluster, ops, label=cid)
    return res, eng


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_mesh_sharded_state_diffs(job, shape):
    res, eng = _run(job, f"diffs{shape}")
    assert eng.keep_matrix and "reach" in res
    np.testing.assert_array_equal(res["reach"], eng.reach)


def test_mesh_closure_is_the_jax_closure(job):
    res, eng = _run(job, "closure(4, 2)")
    np.testing.assert_array_equal(
        np.asarray(res["closure"]).view(np.uint32), np.asarray(eng.closure_packed(tile=64)))


def test_mesh_matrix_free_stripes(job):
    res, eng = _run(job, "stripes(4, 2)")
    assert not eng.keep_matrix and not eng.dirty_rows.any() and not eng.dirty_cols.any()
    assert "keep_matrix" in str(res["packed_reach"])


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=str)
def test_mesh_sharded_pod_churn(job, shape):
    res, eng = _run(job, f"churn{shape}")
    np.testing.assert_array_equal(res["reach_active"], eng.reach_active())


def test_mesh_matrix_free_pod_churn(job):
    _run(job, "mf_churn(4, 2)")


def test_mesh_sharded_namespace_relabel(job):
    res, eng = _run(job, "relabel(4, 2)")
    np.testing.assert_array_equal(res["reach_active"], eng.reach_active())


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=str)
def test_mesh_growth_re_splits_both_axes(job, shape):
    res, eng = _run(job, f"grow{shape}")
    assert eng._n_padded > 256 and eng._capacity > 24  # both axes grew
    np.testing.assert_array_equal(res["reach"], eng.reach)


def test_checkpoint_resume_matrix_free_on_mesh(job, tmp_path):
    """(4, 2) → (2, 4), onto one device, and a matrix-kept resume of a
    matrix-free checkpoint refused on every rank."""
    shape, gen, ops, build = CASES["ckpt(4, 2)"]
    res = job.result("ckpt(4, 2)")
    cluster, eng = _jax(shape, gen, build)
    replay_ops(res, eng, cluster, ops, save=_save(tmp_path), label="ckpt")
    resumed = job.result("resumed(2, 4)")
    jres = jpersist.load_packed_incremental(str(tmp_path / "ck_any"), mesh=jax_mesh_for((2, 4)))
    assert not jres.keep_matrix
    replay_ops(resumed, jres, jgen.random_cluster(jgen.GeneratorConfig(**CKPT)), RESUMED_OPS,
               label="resumed")
    # the port's mesh checkpoint, resumed on one device by the port
    port_dir = f"{job.dir}/ck_any"
    one = persist.load_packed_incremental(port_dir, device="cpu")
    want = jpersist.load_packed_incremental(str(tmp_path / "ck_any"))
    same_state(want.state_dict(), one.state_dict(), "one device")
    with open(f"{port_dir}/state.npz", "rb") as fh:
        assert fh.read(2) == b"PK"
    err = str(job.result("refused(2, 4)")["error"])
    assert err.startswith("ConfigError|True|keep_matrix=True but the checkpoint was saved matrix-free")
    err = str(job.result("refused(8, 1)")["error"])
    with pytest.raises(ValueError) as want:
        jpersist.load_packed_incremental(str(tmp_path / "ck_any"), mesh=jax_mesh_for((8, 1)))
    assert err == f"ConfigError|True|{want.value}"


def test_slot_round_must_split_over_grants(job):
    err = str(job.result("refused_round(1, 8)")["error"])
    assert err == "ConfigError|True|slot_round=12 not divisible by the grant axis size 8"
    cluster = jgen.random_cluster(jgen.GeneratorConfig(**DIFFS))
    with pytest.raises(ValueError, match="slot_round=12 not divisible by the grant axis size 8"):
        JaxEngine(cluster, jkv.VerifyConfig(compute_ports=False),
                  mesh=jax_mesh_for((1, 8)), slot_round=12)
