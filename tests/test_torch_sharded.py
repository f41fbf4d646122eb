"""The port's dense mesh-sharded solves against the JAX package's, bit for
bit: ``sharded_k8s_reach``, ``sharded_kano_reach``, ``sharded_closure`` and
the ``sharded`` backend through ``verify`` / ``verify_kano``.

The JAX side runs here, on ``tests/conftest.py``'s 8 virtual CPU devices;
the port's side runs once per module on 8 gloo CPU ranks
(``tests/torch_mesh_child.py``), which build the ``(8, 1)``, ``(4, 2)``,
``(2, 4)`` and ``(1, 8)`` meshes over one world and run every case; each
test holds rank 0's arrays against the JAX result, and every rank's against
rank 0's. The encodings travel to the ranks as arrays (``.npz``)."""
import numpy as np
import pytest

import kubernetes_verification_tpu as kv
from kubernetes_verification_tpu.encode.encoder import encode_kano as jax_encode_kano
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import random_cluster as jax_random_cluster
from kubernetes_verification_tpu.harness.generate import random_kano as jax_random_kano
from kubernetes_verification_tpu.models.fixtures import (
    kano_paper_example,
    kubesv_paper_example,
)
from kubernetes_verification_tpu.parallel.mesh import mesh_for as jax_mesh_for
from kubernetes_verification_tpu.parallel.sharded_ops import (
    sharded_closure,
    sharded_k8s_reach,
    sharded_kano_reach,
)
from torch_mesh_child import MeshJob
from torch_parity import carried

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
K8S = dict(n_pods=37, n_policies=13, n_namespaces=3, seed=7)
FLAG_GEN = dict(n_pods=29, n_policies=11, n_namespaces=2, seed=11)
FLAGS = {
    "no-self": dict(self_traffic=False),
    "no-default-allow": dict(default_allow_unselected=False),
    "no-direction": dict(direction_aware_isolation=False),
    "any-port": dict(compute_ports=False),
}
ODD = dict(n_pods=13, n_policies=5, n_namespaces=2, seed=5)
KANO = (41, 17, 3)
K8S_FIELDS = ("reach", "reach_ports", "selected", "ingress_isolated",
              "egress_isolated", "src_sets", "dst_sets")
ALL = dict(self_traffic=True, default_allow_unselected=True, direction_aware_isolation=True)


def _matrix(seed=0, n=23, density=0.08):
    return np.random.default_rng(seed).random((n, n)) < density


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    job = MeshJob(tmp_path_factory.mktemp("sharded"))
    enc = job.encoding("k8s", carried(**K8S, compute_ports=True)[0])
    for shape in MESHES:
        job.case(f"k8s{shape}", "k8s", shape, enc, with_closure=True)
    for name, flags in FLAGS.items():
        ports = flags.get("compute_ports", True)
        fenc = job.encoding(f"flags-{name}", carried(**FLAG_GEN, compute_ports=ports)[0])
        job.case(f"flags-{name}", "k8s", (4, 2), fenc,
                 **{k: v for k, v in flags.items() if k != "compute_ports"})
    job.case("odd", "k8s", (8, 1), job.encoding("odd", carried(**ODD, compute_ports=True)[0]))
    kenc = job.kano("kano", jax_encode_kano(*jax_random_kano(*KANO[:2], seed=KANO[2])))
    matrix = job.array("matrix", _matrix())
    for shape in MESHES:
        job.case(f"kano{shape}", "kano", shape, kenc, with_closure=True)
        job.case(f"closure{shape}", "closure", shape, matrix)
    job.case("verify", "verify", (4, 2), gen=K8S, backend="sharded", closure=True,
             queries=True)
    job.case("verify-paper", "verify", (4, 2), gen="kubesv_paper_example",
             backend="sharded")
    job.case("verify-kano", "verify_kano", (2, 4), gen=[*KANO[:2], KANO[2]], closure=True)
    job.case("verify-kano-paper", "verify_kano", (8, 1), gen=[0, 0, 0])
    job.start()
    yield job
    job.close()


def _assert_k8s(got, out, closure=None):
    for f in K8S_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(out, f)), err_msg=f)
    if closure is not None:
        np.testing.assert_array_equal(got["closure"], closure)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_k8s_reach_matches_jax(job, shape):
    jenc, _ = carried(**K8S, compute_ports=True)
    out, closure = sharded_k8s_reach(jax_mesh_for(shape), jenc, with_closure=True, **ALL)
    assert out.reach_ports.shape[-1] > 1, "the cluster must exercise port atoms"
    _assert_k8s(job.result(f"k8s{shape}"), out, closure)


@pytest.mark.parametrize("name", list(FLAGS))
def test_k8s_semantic_flags_match_jax(job, name):
    flags = FLAGS[name]
    jenc, _ = carried(**FLAG_GEN, compute_ports=flags.get("compute_ports", True))
    kw = {**ALL, **{k: v for k, v in flags.items() if k != "compute_ports"}}
    out, _ = sharded_k8s_reach(jax_mesh_for((4, 2)), jenc, with_closure=False, **kw)
    _assert_k8s(job.result(f"flags-{name}"), out)


def test_pod_count_not_divisible_by_mesh(job):
    jenc, _ = carried(**ODD, compute_ports=True)
    out, _ = sharded_k8s_reach(jax_mesh_for((8, 1)), jenc, with_closure=False, **ALL)
    _assert_k8s(job.result("odd"), out)
    ref = kv.verify(jax_random_cluster(JaxGeneratorConfig(**ODD)), kv.VerifyConfig(backend="cpu"))
    np.testing.assert_array_equal(job.result("odd")["reach"], ref.reach)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_kano_reach_matches_jax(job, shape):
    enc = jax_encode_kano(*jax_random_kano(*KANO[:2], seed=KANO[2]))
    out, closure = sharded_kano_reach(jax_mesh_for(shape), enc, with_closure=True)
    got = job.result(f"kano{shape}")
    for f in ("reach", "src_sets", "dst_sets"):
        np.testing.assert_array_equal(got[f], np.asarray(getattr(out, f)), err_msg=f)
    np.testing.assert_array_equal(got["closure"], closure)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_standalone_closure_matches_jax(job, shape):
    want = sharded_closure(jax_mesh_for(shape), _matrix())
    np.testing.assert_array_equal(job.result(f"closure{shape}")["closure"], want)


def test_backend_verify_matches_jax(job):
    cluster = jax_random_cluster(JaxGeneratorConfig(**K8S))
    want = kv.verify(cluster, kv.VerifyConfig(
        backend="sharded", closure=True, backend_options=(("mesh", (4, 2)),)))
    got = job.result("verify")
    for f in K8S_FIELDS + ("closure",):
        np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f)
    assert got["all_isolated"].tolist() == want.all_isolated()
    assert got["all_reachable"].tolist() == want.all_reachable()
    assert got["system_isolation_3"].tolist() == want.system_isolation(3)
    for label in ("team", "app"):
        assert got[f"crosscheck_{label}"].tolist() == want.user_crosscheck(cluster.pods, label)
    assert bool(got["reachable_0_1"]) == want.reachable(0, 1)
    assert [tuple(p) for p in got["policy_shadow"].tolist()] == want.policy_shadow()
    assert [tuple(p) for p in got["policy_conflict"].tolist()] == want.policy_conflict()
    paper = kv.verify(kubesv_paper_example(), kv.VerifyConfig(
        backend="sharded", backend_options=(("mesh", (4, 2)),)))
    np.testing.assert_array_equal(job.result("verify-paper")["reach"], paper.reach)


def _kano_lists(got, kind):
    lengths, values = got[f"{kind}_len"], got[f"{kind}_val"]
    return np.split(values, np.cumsum(lengths)[:-1]) if len(lengths) else []


@pytest.mark.parametrize("case,gen,shape", [
    ("verify-kano", KANO, (2, 4)), ("verify-kano-paper", None, (8, 1))])
def test_backend_verify_kano_matches_jax(job, case, gen, shape):
    containers, policies = (
        jax_random_kano(*gen[:2], seed=gen[2]) if gen else kano_paper_example()
    )
    want = kv.verify_kano(containers, policies, kv.VerifyConfig(
        backend="sharded", closure=gen is not None, backend_options=(("mesh", shape),)))
    got = job.result(case)
    for f in ("reach", "src_sets", "dst_sets") + (("closure",) if gen else ()):
        np.testing.assert_array_equal(got[f], getattr(want, f), err_msg=f)
    # the per-container policy index lists, maintained as the reference does
    assert [x.tolist() for x in _kano_lists(got, "select")] == [
        list(c.select_policies) for c in containers]
    assert [x.tolist() for x in _kano_lists(got, "allow")] == [
        list(c.allow_policies) for c in containers]
    assert got["all_isolated"].tolist() == want.all_isolated()
    assert got["crosscheck_app"].tolist() == want.user_crosscheck(containers, "app")
    if gen is None:
        assert got["all_isolated"].tolist() == [4]
        assert got["crosscheck_app"].tolist() == [1, 2, 3]
