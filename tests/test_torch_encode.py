"""The port's generator and encoder against the JAX package's, leaf by leaf
(exact: every leaf is boolean or integer), and the carry round trip."""
import numpy as np
import pytest

from kubernetes_verification_tpu.encode.encoder import encode_cluster as jax_encode
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import (
    random_cluster as jax_random_cluster,
)
from kubernetes_verification_tpu_torch.encode.carry import (
    encoding_from_arrays,
    encoding_to_arrays,
)
from kubernetes_verification_tpu_torch.encode.encoder import encode_cluster
from kubernetes_verification_tpu_torch.harness.generate import (
    GeneratorConfig,
    random_cluster,
)
from kubernetes_verification_tpu_torch.resilience.errors import EncodeError

#: ports, named ports, ipBlocks and every selector operator all present
_GEN = dict(
    n_pods=90, n_policies=24, n_namespaces=4, p_ports=0.6, p_named_port=0.3,
    p_ipblock_peer=0.1, p_match_expressions=0.5,
)


def _assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("compute_ports", [True, False])
def test_encoding_matches_jax_leaf_by_leaf(seed, compute_ports):
    cluster = random_cluster(GeneratorConfig(seed=seed, **_GEN))
    jcluster = jax_random_cluster(JaxGeneratorConfig(seed=seed, **_GEN))
    enc = encode_cluster(cluster, compute_ports=compute_ports)
    jenc = jax_encode(jcluster, compute_ports=compute_ports)
    arrays = encoding_to_arrays(enc)
    _assert_same_arrays(arrays, encoding_to_arrays(jenc))
    if compute_ports:
        # the cluster exercises the port machinery the arrays must carry
        assert len(enc.atoms) > 1
        assert "restrict_bank" in arrays and "ingress.dst_restrict" in arrays
    assert "ingress.ip_match" in arrays or "egress.ip_match" in arrays
    assert [(a.protocol, a.lo, a.hi, a.name) for a in enc.atoms] == [
        (a.protocol, a.lo, a.hi, a.name) for a in jenc.atoms
    ]
    assert (enc.n_pods, enc.n_namespaces, enc.n_policies) == (
        jenc.n_pods, jenc.n_namespaces, jenc.n_policies,
    )
    assert enc.vocab.pair_ids == jenc.vocab.pair_ids


#: rules drawn from the generator's first four fixed port specs, and many
#: named ones: spec sets and named keys repeat across hundreds of rules
_REUSED = dict(
    n_pods=2000, n_policies=400, n_namespaces=6, p_ports=0.8, p_named_port=0.3,
    p_container_ports=0.5, port_library_size=4,
)


@pytest.mark.parametrize("seed", [3, 4])
def test_encoding_matches_jax_where_the_port_tables_are_reused(seed):
    cluster = random_cluster(GeneratorConfig(seed=seed, **_REUSED))
    enc = encode_cluster(cluster)
    jenc = jax_encode(jax_random_cluster(JaxGeneratorConfig(seed=seed, **_REUSED)))
    arrays = encoding_to_arrays(enc)
    _assert_same_arrays(arrays, encoding_to_arrays(jenc))
    for leaf in ("restrict_bank", "ingress.dst_restrict", "egress.dst_restrict"):
        assert leaf in arrays, leaf
    assert [(a.protocol, a.lo, a.hi, a.name) for a in enc.atoms] == [
        (a.protocol, a.lo, a.hi, a.name) for a in jenc.atoms]
    assert sorted(enc.resolution) == sorted(jenc.resolution)
    for key, mask in jenc.resolution.items():
        np.testing.assert_array_equal(enc.resolution[key], mask, err_msg=str(key))
    rules = [r for p in cluster.policies for r in (p.ingress or ()) + (p.egress or ())]
    ported = [frozenset(r.ports) for r in rules if r.ports]
    assert len(ported) > 4 * len(set(ported))  # the tables were reused


@pytest.mark.parametrize("compute_ports", [True, False])
def test_carry_round_trip(compute_ports):
    enc = encode_cluster(
        random_cluster(GeneratorConfig(seed=5, **_GEN)), compute_ports=compute_ports
    )
    arrays = encoding_to_arrays(enc)
    back = encoding_from_arrays(
        arrays,
        n_pods=enc.n_pods,
        n_namespaces=enc.n_namespaces,
        n_policies=enc.n_policies,
        atoms=enc.atoms,
    )
    _assert_same_arrays(encoding_to_arrays(back), arrays)
    assert back.atoms == enc.atoms
    assert back.vocab is None


def test_carry_rejects_missing_and_unknown_leaves():
    enc = encode_cluster(random_cluster(GeneratorConfig(seed=6, **_GEN)))
    arrays = encoding_to_arrays(enc)
    meta = dict(n_pods=enc.n_pods, n_namespaces=enc.n_namespaces,
                n_policies=enc.n_policies, atoms=enc.atoms)
    with pytest.raises(EncodeError, match="lacks"):
        encoding_from_arrays(
            {k: v for k, v in arrays.items() if k != "ingress.pod_sel.req_eq"},
            **meta,
        )
    with pytest.raises(EncodeError, match="unknown"):
        encoding_from_arrays({**arrays, "ingress.bogus": np.zeros(1)}, **meta)
