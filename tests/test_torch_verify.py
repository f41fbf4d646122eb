"""``verify(backend="torch")`` on the CPU against the JAX package's
``verify(backend="tpu")``, every ``VerifyResult`` array (exact: boolean)."""
import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import (
    random_cluster as jax_random_cluster,
)
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError
from torch_parity import words  # noqa: F401  (also caps torch's threads)

_ARRAYS = (
    "reach", "reach_ports", "src_sets", "dst_sets", "selected",
    "ingress_isolated", "egress_isolated",
)
_GEN = dict(
    n_pods=48, n_policies=14, n_namespaces=3, p_ports=0.6, p_named_port=0.2,
    p_ipblock_peer=0.1,
)


@pytest.mark.parametrize("compute_ports", [True, False])
@pytest.mark.parametrize("seed", [21, 22])
def test_verify_matches_jax_tpu_backend(compute_ports, seed):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=seed, **_GEN))
    jcluster = jax_random_cluster(JaxGeneratorConfig(seed=seed, **_GEN))
    got = kvt.verify(cluster, kvt.VerifyConfig(
        backend="torch", compute_ports=compute_ports,
        backend_options=(("device", "cpu"),),
    ))
    want = jkv.verify(jcluster, jkv.VerifyConfig(
        backend="tpu", compute_ports=compute_ports,
    ))
    assert got.backend == "torch" and got.mode == "k8s"
    for name in _ARRAYS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == np.bool_, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert [(a.protocol, a.lo, a.hi, a.name) for a in got.port_atoms] == [
        (a.protocol, a.lo, a.hi, a.name) for a in want.port_atoms
    ]
    assert got.policy_shadow() == want.policy_shadow()
    assert got.policy_conflict() == want.policy_conflict()
    assert got.all_isolated() == want.all_isolated()
    assert got.user_crosscheck(cluster.pods, "app") == want.user_crosscheck(
        jcluster.pods, "app"
    )


@pytest.mark.parametrize("flags", [
    dict(self_traffic=False),
    dict(default_allow_unselected=False),
    dict(direction_aware_isolation=False),
])
def test_verify_flags_match_jax(flags):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=23, **_GEN))
    jcluster = jax_random_cluster(JaxGeneratorConfig(seed=23, **_GEN))
    got = kvt.verify(cluster, kvt.VerifyConfig(
        backend_options=(("device", "cpu"),), **flags,
    ))
    want = jkv.verify(jcluster, jkv.VerifyConfig(backend="tpu", **flags))
    for name in _ARRAYS:
        np.testing.assert_array_equal(
            getattr(got, name), getattr(want, name), err_msg=name
        )


def test_unported_paths_name_the_roadmap():
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=1, n_pods=10, n_policies=3))
    cpu = (("device", "cpu"),)
    with pytest.raises(ConfigError, match="ROADMAP"):
        kvt.verify(cluster, kvt.VerifyConfig(closure=True, backend_options=cpu))
    with pytest.raises(ConfigError, match="ROADMAP"):
        kvt.get_backend("torch").verify_kano([], [], kvt.VerifyConfig())
    with pytest.raises(KeyError):
        kvt.verify(cluster, kvt.VerifyConfig(backend="tpu"))
    assert kvt.available_backends() == ["torch"]
