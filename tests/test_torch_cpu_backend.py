"""The port's CPU oracle (``backend="cpu"``) against the JAX package's, on
random clusters with and without port semantics under every flag, on kano
scenarios with and without a label relation, and on the paper fixtures'
documented answers (exact: every output is boolean)."""
import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.models.fixtures import (
    kano_paper_example,
    kano_paper_example_as_cluster,
    kubesv_paper_example,
)
from torch_parity import to_jax

_FIELDS = ("reach", "reach_ports", "src_sets", "dst_sets", "selected",
           "ingress_isolated", "egress_isolated", "closure")
_PORTS = dict(p_ports=0.8, p_named_port=0.3, p_container_ports=0.5)


def _same(got, want):
    for f in _FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert [(a.protocol, a.lo, a.hi, a.name) for a in got.port_atoms] == [
        (a.protocol, a.lo, a.hi, a.name) for a in want.port_atoms]
    assert (got.n_pods, got.mode, got.backend) == (want.n_pods, want.mode, want.backend)


@pytest.mark.parametrize("flags", [
    {},
    dict(self_traffic=False),
    dict(default_allow_unselected=False),
    dict(direction_aware_isolation=False),
], ids=lambda f: ",".join(f) or "default")
@pytest.mark.parametrize("compute_ports", [False, True])
def test_k8s_verify_matches_jax(flags, compute_ports):
    for seed in (3, 4):
        c = kvt.random_cluster(kvt.GeneratorConfig(
            n_pods=70, n_policies=10, n_namespaces=4, seed=seed, **_PORTS))
        cfg = dict(backend="cpu", compute_ports=compute_ports, closure=True, **flags)
        got = kvt.verify(c, kvt.VerifyConfig(**cfg))
        want = jkv.verify(to_jax(c), jkv.VerifyConfig(**cfg))
        _same(got, want)


def test_cpu_oracle_equals_the_torch_backend_on_the_cpu():
    c = kvt.random_cluster(kvt.GeneratorConfig(n_pods=90, n_policies=14, seed=8, **_PORTS))
    for compute_ports in (False, True):
        oracle = kvt.verify(c, kvt.VerifyConfig(backend="cpu", compute_ports=compute_ports))
        solve = kvt.verify(c, kvt.VerifyConfig(
            compute_ports=compute_ports, backend_options=(("device", "cpu"),)))
        for f in ("reach", "reach_ports", "src_sets", "dst_sets", "selected",
                  "ingress_isolated", "egress_isolated"):
            g, w = getattr(oracle, f), getattr(solve, f)
            assert (g is None) == (w is None), f
            if g is not None:
                np.testing.assert_array_equal(g, w, err_msg=f)


class _Prefix(kvt.LabelRelation):
    def match(self, rule_value, label_value):
        return label_value.startswith(rule_value[:1])


class _JaxPrefix(jkv.LabelRelation):
    def match(self, rule_value, label_value):
        return label_value.startswith(rule_value[:1])


@pytest.mark.parametrize("relation", [None, "prefix"])
def test_kano_verify_matches_jax(relation):
    containers, policies = kvt.random_kano(60, 12, seed=5)
    jc, jp = to_jax(containers), to_jax(policies)
    got = kvt.verify_kano(containers, policies, kvt.VerifyConfig(
        backend="cpu", closure=True, label_relation=_Prefix() if relation else None))
    want = jkv.verify_kano(jc, jp, jkv.VerifyConfig(
        backend="cpu", closure=True, label_relation=_JaxPrefix() if relation else None))
    _same(got, want)
    assert [(c.select_policies, c.allow_policies) for c in containers] == [
        (c.select_policies, c.allow_policies) for c in jc]


def test_kano_paper_example_gives_its_documented_answers():
    containers, policies = kano_paper_example()
    res = kvt.verify_kano(containers, policies, kvt.VerifyConfig(backend="cpu"))
    assert res.reachable(0, 1) and res.reachable(2, 0) and res.reachable(4, 2)
    expected = np.zeros((5, 5), dtype=bool)
    expected[0, 1] = expected[3, 1] = True
    expected[4, 2] = True
    expected[2, 0] = expected[2, 3] = True
    for s in (0, 1, 2):
        expected[s, 0] = expected[s, 3] = True
    np.testing.assert_array_equal(res.reach, expected)
    assert res.all_reachable() == []
    assert res.all_isolated() == [4]
    assert res.user_crosscheck(containers, "app") == [1, 2, 3]
    assert res.policy_shadow() == [(2, 3), (3, 2)]
    assert containers[2].select_policies == [2, 3]
    # the torch backend on the CPU gives the same matrix
    again = kvt.verify_kano(*kano_paper_example(), kvt.VerifyConfig(
        backend_options=(("device", "cpu"),)))
    np.testing.assert_array_equal(again.reach, expected)
    # the k8s form agrees on the policy-granted edges
    k8s = kvt.verify(kano_paper_example_as_cluster(), kvt.VerifyConfig(backend="cpu"))
    assert all(k8s.reach[s, d] for s, d in zip(*np.nonzero(expected)) if d in (0, 1, 2, 3))


def test_kubesv_paper_example_gives_its_documented_answers():
    cluster = kubesv_paper_example()
    pods = cluster.pods
    db = [i for i, p in enumerate(pods) if p.labels["role"] == "db" and p.namespace == "default"]
    tomcat = [i for i, p in enumerate(pods) if p.labels["role"] == "tomcat" and p.namespace == "default"]
    nginx = [i for i, p in enumerate(pods) if p.labels["role"] == "nginx" and p.namespace == "default"]
    strict = kvt.verify(cluster, kvt.VerifyConfig(backend="cpu", default_allow_unselected=False))
    assert all(strict.ingress_isolated[i] for i in db)
    assert not strict.reach[np.ix_(tomcat, db)].any()
    res = kvt.verify(cluster, kvt.VerifyConfig(backend="cpu"))
    assert res.reach[np.ix_(tomcat, db)].all()
    assert not res.reach[np.ix_(nginx, db)].any()
    _same(res, jkv.verify(to_jax(cluster), jkv.VerifyConfig(backend="cpu")))
