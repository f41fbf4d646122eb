"""The host-side checkers of ``chip_smoke.py``, which hold the port's sets
and closures at full size on the card against the model objects, are
themselves held here against the JAX package's CPU oracle and the port on
small seeded scenarios. Exact: every output is boolean."""
import numpy as np
import pytest
import torch

import chip_smoke
import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import random_cluster as jax_random_cluster
from kubernetes_verification_tpu.harness.generate import random_kano as jax_random_kano
from kubernetes_verification_tpu_torch.ops.tiled import _pair_mask_args, _policy_sets, _put


def _cluster_cfg(seed):
    return dict(n_pods=90, n_policies=23, n_namespaces=4, p_ipblock_peer=0.1,
                p_namespace_selector=0.4, p_match_expressions=0.5, seed=seed)


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_host_policy_sets_match_the_oracle_and_the_port(seed):
    cfg = _cluster_cfg(seed)
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**cfg))
    rows = np.arange(cfg["n_policies"])
    src, dst = chip_smoke.host_policy_sets(cluster, rows)
    oracle = jkv.verify(
        jax_random_cluster(JaxGeneratorConfig(**cfg)),
        jkv.VerifyConfig(backend="cpu", compute_ports=False),
    )
    np.testing.assert_array_equal(src, oracle.src_sets)
    np.testing.assert_array_equal(dst, oracle.dst_sets)
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    args = _put(_pair_mask_args(enc, True, 8, n_pad=0), torch.device("cpu"))
    src8, dst8 = _policy_sets(args, chunk=8)
    np.testing.assert_array_equal(src8.numpy() > 0, src)
    np.testing.assert_array_equal(dst8.numpy() > 0, dst)
    # a sample of rows, in any order, is those rows
    some = np.array([5, 0, 22])
    got = chip_smoke.host_policy_sets(cluster, some)
    np.testing.assert_array_equal(got[0], src[some])
    np.testing.assert_array_equal(got[1], dst[some])


@pytest.mark.parametrize("seed", [4, 5])
@pytest.mark.parametrize("relation", [None, "prefix"])
def test_host_kano_sets_and_closure_match_the_oracle(seed, relation):
    rel = chip_smoke.FirstLetterPrefix() if relation else None
    containers, policies = kvt.random_kano(120, 14, seed=seed)
    # a rule key no container carries is dropped; an unseen value matches nothing
    policies[0].select["nokey"] = "x"
    policies[1].allow["app"] = "never-seen"
    src, dst = chip_smoke.host_kano_sets(containers, policies, rel)
    jc, jp = jax_random_kano(120, 14, seed=seed)
    jp[0].select["nokey"] = "x"
    jp[1].allow["app"] = "never-seen"
    oracle = jkv.verify_kano(jc, jp, jkv.VerifyConfig(
        backend="cpu", closure=True, label_relation=rel))
    np.testing.assert_array_equal(src, oracle.src_sets)
    np.testing.assert_array_equal(dst, oracle.dst_sets)
    rows = np.arange(120)
    np.testing.assert_array_equal(
        chip_smoke.host_kano_closure_rows(src, dst, rows), oracle.closure
    )
    some = np.array([7, 3, 119])
    np.testing.assert_array_equal(
        chip_smoke.host_kano_closure_rows(src, dst, some), oracle.closure[some]
    )
    res = kvt.verify_kano(containers, policies, kvt.VerifyConfig(
        closure=True, label_relation=rel, backend_options=(("device", "cpu"),)))
    np.testing.assert_array_equal(res.closure, oracle.closure)


def test_label_columns_follow_selector_semantics():
    from kubernetes_verification_tpu_torch.models.core import Expr, Selector

    labels = [{"app": "a", "tier": "x"}, {"app": "b"}, {}, {"tier": "y"}]
    cols = chip_smoke.LabelColumns(labels)
    sels = [
        Selector(),
        Selector({"app": "a"}),
        Selector({"nokey": "v"}),
        Selector(match_expressions=(Expr("tier", "Exists"),)),
        Selector(match_expressions=(Expr("tier", "DoesNotExist"),)),
        Selector(match_expressions=(Expr("app", "In", ("a", "b")),)),
        Selector(match_expressions=(Expr("app", "NotIn", ("a",)),)),
        Selector(match_expressions=(Expr("nokey", "NotIn", ("a",)),)),
        Selector({"app": "b"}, (Expr("tier", "DoesNotExist"),)),
    ]
    for sel in sels:
        want = [sel.matches(d) for d in labels]
        assert cols.match(sel).tolist() == want, sel
