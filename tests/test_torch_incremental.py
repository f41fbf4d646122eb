"""The dense serving engine of the port (``IncrementalVerifier``) on the CPU,
against the JAX package's on the same op streams: the count matrices, the
isolation counts, the per-policy vectors and ``reach`` equal after every op,
refused ops included (exact: every piece of state is integer or boolean)."""
import dataclasses

import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.incremental import IncrementalVerifier as JaxDense
from kubernetes_verification_tpu_torch import incremental as port_incremental
from kubernetes_verification_tpu_torch.resilience.errors import BackendError
from torch_parity import to_jax

_GEN = dict(n_pods=120, n_policies=12, n_namespaces=4, p_ipblock_peer=0.1)

_FLAGS = [
    {},
    dict(direction_aware_isolation=False),
    dict(default_allow_unselected=False),
    dict(self_traffic=False),
]


def _pair(cluster, **flags):
    cfg = dict(compute_ports=False, **flags)
    port = kvt.IncrementalVerifier(cluster, kvt.VerifyConfig(**cfg), device="cpu")
    jax_ = JaxDense(to_jax(cluster), jkv.VerifyConfig(**cfg))
    return port, jax_


def _assert_equal(port, jax_, where=""):
    np.testing.assert_array_equal(
        port._ing_count.numpy(), np.asarray(jax_._ing_count), err_msg=where)
    np.testing.assert_array_equal(
        port._eg_count.numpy(), np.asarray(jax_._eg_count), err_msg=where)
    assert port._ing_count.dtype == port._eg_count.dtype and str(port._ing_count.dtype) == "torch.int32"
    for a, b in ((port._ing_iso, jax_._ing_iso), (port._eg_iso, jax_._eg_iso)):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    assert list(port._vectors) == list(jax_._vectors), where
    for key, vecs in port._vectors.items():
        for a, b in zip(vecs, jax_._vectors[key]):
            assert a.dtype == b.dtype == bool, where
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {key}")
    assert list(port.policies) == list(jax_.policies), where
    assert port.update_count == jax_.update_count, where
    assert [(ns.name, ns.labels) for ns in port.namespaces] == [
        (ns.name, ns.labels) for ns in jax_.namespaces], where
    assert port._ns_labels == jax_._ns_labels, where
    reach = port.reach
    assert reach.dtype == bool
    np.testing.assert_array_equal(reach, jax_.reach, err_msg=where)


def _stream(cluster, donor):
    """(op, args, refused) triples over the port's model objects; the JAX
    side receives ``to_jax`` of the same arguments."""
    pols = list(cluster.policies)
    ns = [n.name for n in cluster.namespaces]
    ops = [
        ("add_policy", (dataclasses.replace(donor.policies[0], name="d0"),), False),
        ("add_policy", (dataclasses.replace(donor.policies[1], name="d1"),), False),
        ("add_policy", (pols[0],), True),  # exists
        ("add_policy", (dataclasses.replace(donor.policies[2], name="d2",
                                            namespace="fresh-by-policy"),), False),
        ("update_policy", (dataclasses.replace(pols[2], ingress=pols[5].ingress,
                                               egress=pols[5].egress),), False),
        ("update_policy", (dataclasses.replace(pols[4], ingress=()),), False),
        ("update_policy", (dataclasses.replace(pols[1], name="absent"),), True),
        ("remove_policy", (pols[3].namespace, pols[3].name), False),
        ("remove_policy", (pols[3].namespace, pols[3].name), True),  # gone
        ("update_pod_labels", (7, dict(cluster.pods[40].labels)), False),
        ("update_pod_labels", (11, {"app": "unseen", "zone": "nowhere"}), False),
        ("update_pod_labels", (0, {}), False),
        ("update_pod_labels", (119, dict(cluster.pods[3].labels)), False),
        ("update_pod_labels", (len(cluster.pods) + 5, {}), True),  # no such pod
        ("update_namespace_labels", (ns[1], dict(cluster.namespaces[2].labels)), False),
        ("update_namespace_labels", (ns[0], {"fresh": "x"}), False),
        ("update_namespace_labels", (ns[0], {"fresh": "x"}), False),  # no-op
        ("update_namespace_labels", ("no-such-ns", {}), True),
        ("add_namespace", (kvt.Namespace("late-ns", {"team": "late"}),), False),
        ("add_namespace", (kvt.Namespace(ns[2], {"via": "add"}),), False),  # relabel
        ("add_namespace", (kvt.Namespace(ns[2], {"via": "add"}),), False),  # no-op
        ("add_policy", (dataclasses.replace(donor.policies[3], name="d3",
                                            namespace="late-ns"),), False),
        ("remove_namespace", ("late-ns",), True),  # holds a policy
        ("remove_policy", ("late-ns", "d3"), False),
        ("remove_namespace", ("late-ns",), False),
        ("remove_namespace", ("late-ns",), True),  # gone
        ("remove_namespace", (ns[3],), True),  # holds pods
        ("update_pod_labels", (60, {"app": "alpha"}), False),
        ("update_policy", (dataclasses.replace(pols[6], pod_selector=kvt.Selector()),), False),
    ]
    return ops


def _apply(engine, op, args, jax_side):
    args = tuple(to_jax(a) for a in args) if jax_side else args
    return getattr(engine, op)(*args)


@pytest.mark.parametrize("flags", _FLAGS, ids=lambda f: ",".join(f) or "default")
def test_stream_state_equals_jax_after_every_op(flags):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=21, **_GEN))
    donor = kvt.random_cluster(kvt.GeneratorConfig(seed=22, **_GEN))
    port, jax_ = _pair(cluster, **flags)
    _assert_equal(port, jax_, "build")
    for i, (op, args, refused) in enumerate(_stream(cluster, donor)):
        where = f"op {i} {op}"
        results = []
        for engine, jax_side in ((jax_, True), (port, False)):
            try:
                results.append(("ok", _apply(engine, op, args, jax_side)))
            except (KeyError, ValueError, IndexError) as e:
                results.append(("refused", e))
        (jkind, jval), (pkind, pval) = results
        assert jkind == pkind == ("refused" if refused else "ok"), where
        if refused:
            assert isinstance(pval, type(jval)), (where, pval, jval)
        else:
            assert pval == jval, where  # add_namespace's bool
        _assert_equal(port, jax_, where)
    # the port's reach equals its own CPU oracle on the mutated cluster
    cfg = kvt.VerifyConfig(backend="cpu", compute_ports=False, **flags)
    np.testing.assert_array_equal(port.reach, kvt.verify(port.as_cluster(), cfg).reach)


def test_build_without_policies_and_as_cluster():
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=23, **_GEN))
    bare = kvt.Cluster(pods=cluster.pods, namespaces=cluster.namespaces, policies=[])
    port, jax_ = _pair(bare)
    _assert_equal(port, jax_, "empty build")
    assert port.build_timings.keys() == {"vectorizer"}
    for pol in cluster.policies[:4]:
        port.add_policy(pol)
        jax_.add_policy(to_jax(pol))
        _assert_equal(port, jax_, pol.name)
    # the engine deep-copies pods: relabels never touch the caller's cluster
    before = dict(cluster.pods[5].labels)
    port.update_pod_labels(5, {"x": "y"})
    assert cluster.pods[5].labels == before
    snap = port.as_cluster()
    assert snap.pods[5].labels == {"x": "y"} and snap.pods[5] is not port.pods[5]
    assert [p.name for p in snap.policies] == [p.name for p in cluster.policies[:4]]


def test_full_build_times_its_phases():
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=24, **_GEN))
    port, _ = _pair(cluster)
    assert port.build_timings.keys() == {"encode", "vectorizer", "contraction", "vectors"}
    assert all(v >= 0 for v in port.build_timings.values())


@pytest.mark.parametrize("block", [1, 7, 1 << 24])
def test_rank1_add_in_place_equals_the_outer_product(monkeypatch, block):
    """The block update gathers and writes back only the rows × columns the
    vectors set, a slab of rows at a time; the counts equal a dense outer
    product, and the tensor is updated in place."""
    import torch

    monkeypatch.setattr(port_incremental, "_RANK1_BLOCK", block)
    rng = np.random.default_rng(block)
    count = torch.as_tensor(rng.integers(-3, 4, (37, 41)).astype(np.int32))
    want = count.numpy().copy()
    ptr = count.data_ptr()
    for sign in (+1, -1, +1):
        src = rng.random(37) < 0.4
        dst = rng.random(41) < 0.3
        port_incremental._rank1_add(count, src, dst, sign)
        want += sign * np.outer(src, dst).astype(np.int32)
        np.testing.assert_array_equal(count.numpy(), want)
    port_incremental._rank1_add(count, np.zeros(37, bool), dst, 1)  # empty block
    np.testing.assert_array_equal(count.numpy(), want)
    assert count.data_ptr() == ptr


def test_reach_is_cached_until_a_diff():
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=25, **_GEN))
    port, _ = _pair(cluster)
    first = port.reach
    assert port.reach is first  # no re-derivation without a diff
    port.remove_policy(cluster.policies[0].namespace, cluster.policies[0].name)
    assert port.reach is not first


def test_engine_refuses_the_cpu_without_a_gpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=26, n_pods=20, n_policies=4))
    with pytest.raises(BackendError, match="no CUDA device"):
        kvt.IncrementalVerifier(cluster)
    assert kvt.IncrementalVerifier(cluster, device="cpu").reach.shape == (20, 20)
