"""kano mode in the port — ``random_kano``, the kano encoders and
``verify_kano(backend="torch")`` — and ``verify(closure=True)``, against the
JAX package on the same seeded scenarios (exact: every output is boolean or
an index list). Mirrors ``tests/test_label_relation.py`` for the pluggable
matcher."""
import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.encode.encoder import encode_kano as jax_encode_kano
from kubernetes_verification_tpu.encode.encoder import (
    encode_kano_relation as jax_encode_kano_relation,
)
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import random_cluster as jax_random_cluster
from kubernetes_verification_tpu.harness.generate import random_kano as jax_random_kano
from kubernetes_verification_tpu_torch.encode.encoder import encode_kano, encode_kano_relation
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError
from torch_parity import words  # noqa: F401  (also caps torch's threads)

_CPU = (("device", "cpu"),)


class PortPrefix(kvt.LabelRelation):
    """rule value accepts any label value it prefixes: 'web' ~ 'web-1'."""

    def match(self, rule_value: str, label_value: str) -> bool:
        return label_value.startswith(rule_value)


class JaxPrefix(jkv.LabelRelation):
    def match(self, rule_value: str, label_value: str) -> bool:
        return label_value.startswith(rule_value)


def _pair(pkg, containers, policies):
    """The same hand-written scenario in one package's model classes."""
    return (
        [pkg.Container(n, dict(l)) for n, l in containers],
        [pkg.KanoPolicy(n, select=dict(s), allow=dict(a), ingress=i) for n, s, a, i in policies],
    )


#: the matcher quirks: a key no container has ("ghost") is dropped; a known
#: key with an unseen value ("app": "nope") poisons the row; under a relation
#: a known key whose acceptable set is empty ("tier": "zz") matches nothing
_QUIRKS = (
    [("w1", {"app": "web-1", "tier": "fe"}), ("w2", {"app": "web-2", "tier": "fe"}),
     ("db", {"app": "db-main", "tier": "be"}), ("x", {"tier": "fe"})],
    [("a", {"tier": "f"}, {"app": "web"}, True),
     ("b", {"ghost": "z"}, {"tier": "be"}, True),
     ("c", {"app": "db-main"}, {}, False),
     ("d", {"app": "nope"}, {"tier": "fe"}, True),
     ("e", {"tier": "zz"}, {"app": "db"}, False)],
)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_kano_matches_jax(seed):
    got = kvt.random_kano(40, 12, seed=seed, max_labels=4)
    want = jax_random_kano(40, 12, seed=seed, max_labels=4)
    assert [(c.name, c.labels) for c in got[0]] == [(c.name, c.labels) for c in want[0]]
    assert [(p.name, p.select, p.allow, p.ingress, p.protocols) for p in got[1]] == [
        (p.name, p.select, p.allow, p.ingress, p.protocols) for p in want[1]
    ]


def test_encode_kano_matches_jax_quirks_included():
    got = encode_kano(*_pair(kvt, *_QUIRKS))
    want = jax_encode_kano(*_pair(jkv, *_QUIRKS))
    for f in ("pod_kv", "src_req", "src_impossible", "dst_req", "dst_impossible"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.vocab.pair_ids == want.vocab.pair_ids
    # "web" and "f" (a), "nope" (d), "zz" and "db" (e) are unseen values of
    # known keys
    assert got.src_impossible.tolist() == [True, False, False, False, True]
    assert got.dst_impossible.tolist() == [True, False, False, True, True]
    assert not got.dst_req[1].any()  # the unknown key "ghost" is dropped


def test_encode_kano_relation_matches_jax_quirks_included():
    got = encode_kano_relation(*_pair(kvt, *_QUIRKS), PortPrefix())
    want = jax_encode_kano_relation(*_pair(jkv, *_QUIRKS), JaxPrefix())
    for f in ("pod_kv", "pod_key"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for side in ("src_sel", "dst_sel"):
        g, w = getattr(got, side), getattr(want, side)
        for f in ("req_eq", "req_key", "forbid_eq", "forbid_key", "in_mask",
                  "in_valid", "impossible"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f), err_msg=f"{side}.{f}")
    # "tier": "zz" (e's select: its sources) under the prefix relation: a
    # valid In-row with no pair
    assert got.src_sel.in_valid[4, 0] and not got.src_sel.in_mask[4, 0].any()


def _assert_kano_equal(got, want, got_c, want_c):
    assert got.mode == "kano" and got.backend == "torch" and got.n_pods == want.n_pods
    for f in ("reach", "src_sets", "dst_sets", "closure"):
        g, w = getattr(got, f), getattr(want, f)
        if w is None:
            assert g is None, f
            continue
        assert g.dtype == np.bool_, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in ("reach_ports", "selected", "ingress_isolated", "egress_isolated"):
        assert getattr(got, f) is None and getattr(want, f) is None, f
    assert [(c.select_policies, c.allow_policies) for c in got_c] == [
        (c.select_policies, c.allow_policies) for c in want_c
    ]
    assert got.all_reachable() == want.all_reachable()
    assert got.all_isolated() == want.all_isolated()
    assert got.user_crosscheck(got_c, "app") == want.user_crosscheck(want_c, "app")
    assert got.policy_shadow() == want.policy_shadow()
    assert got.policy_conflict() == want.policy_conflict()


@pytest.mark.parametrize("closure", [False, True])
@pytest.mark.parametrize("relation", [False, True])
@pytest.mark.parametrize("seed", [3, 4])
def test_verify_kano_matches_jax(seed, relation, closure):
    cont, pols = kvt.random_kano(60, 15, seed=seed)
    jcont, jpols = jax_random_kano(60, 15, seed=seed)
    got = kvt.verify_kano(cont, pols, kvt.VerifyConfig(
        backend="torch", closure=closure, backend_options=_CPU,
        label_relation=PortPrefix() if relation else None,
    ))
    want = jkv.verify_kano(jcont, jpols, jkv.VerifyConfig(
        backend="tpu", closure=closure,
        label_relation=JaxPrefix() if relation else None,
    ))
    _assert_kano_equal(got, want, cont, jcont)


@pytest.mark.parametrize("relation", [None, "prefix", "equality"])
def test_verify_kano_quirks_match_jax(relation):
    rel = {None: (None, None), "prefix": (PortPrefix(), JaxPrefix()),
           "equality": (kvt.DefaultEqualityLabelRelation(),
                        jkv.DefaultEqualityLabelRelation())}[relation]
    cont, pols = _pair(kvt, *_QUIRKS)
    jcont, jpols = _pair(jkv, *_QUIRKS)
    got = kvt.verify_kano(cont, pols, kvt.VerifyConfig(
        closure=True, backend_options=_CPU, label_relation=rel[0]))
    want = jkv.verify_kano(jcont, jpols, jkv.VerifyConfig(
        backend="tpu", closure=True, label_relation=rel[1]))
    _assert_kano_equal(got, want, cont, jcont)


def test_verify_kano_refills_container_lists_and_checks_relations():
    cont, pols = kvt.random_kano(20, 6, seed=2)
    cont[0].select_policies.extend([99, 98])  # stale entries are replaced
    res = kvt.verify_kano(cont, pols, kvt.VerifyConfig(backend_options=_CPU))
    for i, c in enumerate(cont):
        assert c.select_policies == np.nonzero(res.src_sets[:, i])[0].tolist()
        assert c.allow_policies == np.nonzero(res.dst_sets[:, i])[0].tolist()
    assert kvt.get_backend("torch").supports_label_relation
    with pytest.raises(ConfigError, match="verify_kano"):
        kvt.verify(kvt.random_cluster(kvt.GeneratorConfig(n_pods=4, n_policies=1)),
                   kvt.VerifyConfig(label_relation=PortPrefix(), backend_options=_CPU))
    empty = kvt.verify_kano([], [], kvt.VerifyConfig(closure=True, backend_options=_CPU))
    assert empty.reach.shape == (0, 0) and empty.closure.shape == (0, 0)


_GEN = dict(n_pods=40, n_policies=12, n_namespaces=3, p_ports=0.5, p_named_port=0.2)


@pytest.mark.parametrize("compute_ports", [True, False])
@pytest.mark.parametrize("seed", [31, 32])
def test_verify_closure_matches_jax(compute_ports, seed):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=seed, **_GEN))
    jcluster = jax_random_cluster(JaxGeneratorConfig(seed=seed, **_GEN))
    got = kvt.verify(cluster, kvt.VerifyConfig(
        closure=True, compute_ports=compute_ports, backend_options=_CPU))
    want = jkv.verify(jcluster, jkv.VerifyConfig(
        backend="tpu", closure=True, compute_ports=compute_ports))
    assert got.closure.dtype == np.bool_
    np.testing.assert_array_equal(got.closure, want.closure)
    np.testing.assert_array_equal(got.reach, want.reach)
