"""The port's ``native`` backend (host C++ packed bitsets) against the JAX
package's ``native`` and the port's ``cpu`` oracle on the same inputs: the
kernels at odd widths, k8s under every semantic flag, with closure, on the
paper example, and kano with the paper queries (exact: every output is
boolean or an integer count)."""
import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt

pytest.importorskip("kubernetes_verification_tpu_torch.native.binding")
pytest.importorskip("kubernetes_verification_tpu.native.binding")

from kubernetes_verification_tpu.native import binding as jbin  # noqa: E402
from kubernetes_verification_tpu_torch.models.fixtures import (  # noqa: E402
    kano_paper_example,
    kubesv_paper_example,
)
from kubernetes_verification_tpu_torch.native import binding as pbin  # noqa: E402
from torch_parity import to_jax  # noqa: E402

_FIELDS = ("reach", "reach_ports", "closure", "selected", "src_sets", "dst_sets",
           "ingress_isolated", "egress_isolated")


def _same(got, want, fields=_FIELDS):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def test_library_is_built_in_the_ports_own_build_directory():
    """The port never loads the JAX tree's ``_kvbitset.so``."""
    path = pbin._so_path()
    assert "kubernetes_verification_tpu_torch" in path and "_build" in path
    assert pbin.lib._name == path


@pytest.mark.parametrize("cols", [1, 63, 64, 65, 200])
def test_pack_roundtrip_odd_widths(cols):
    rng = np.random.default_rng(1)
    a = rng.random((7, cols)) < 0.4
    np.testing.assert_array_equal(pbin.pack(a), jbin.pack(a))
    np.testing.assert_array_equal(pbin.unpack(pbin.pack(a), cols), a)


def test_subset_disjoint_intersect():
    rng = np.random.default_rng(2)
    a = rng.random((13, 150)) < 0.3
    b = rng.random((17, 150)) < 0.5
    A, B = pbin.BitMatrix.from_bool(a), pbin.BitMatrix.from_bool(b)
    JA, JB = jbin.BitMatrix.from_bool(a), jbin.BitMatrix.from_bool(b)
    ref_sub = (a[:, None, :] & ~b[None, :, :]).sum(-1) == 0
    ref_dis = (a[:, None, :] & b[None, :, :]).sum(-1) == 0
    np.testing.assert_array_equal(A.subset_of(B), ref_sub)
    np.testing.assert_array_equal(A.disjoint_from(B), ref_dis)
    np.testing.assert_array_equal(A.intersects(B), ~ref_dis)
    np.testing.assert_array_equal(A.subset_of(B), JA.subset_of(JB))
    np.testing.assert_array_equal(A.intersects(B), JA.intersects(JB))


def test_or_scatter_matches_outer_or():
    rng = np.random.default_rng(3)
    P, N = 9, 70
    sel = rng.random((P, N)) < 0.3
    val = rng.random((P, N)) < 0.3
    out = pbin.BitMatrix.zeros(N, N)
    out.or_scatter_into(pbin.BitMatrix.from_bool(sel), pbin.BitMatrix.from_bool(val))
    jout = jbin.BitMatrix.zeros(N, N)
    jout.or_scatter_into(jbin.BitMatrix.from_bool(sel), jbin.BitMatrix.from_bool(val))
    ref = np.zeros((N, N), dtype=bool)
    for p in range(P):
        ref |= np.outer(sel[p], val[p])
    np.testing.assert_array_equal(out.to_bool(), ref)
    np.testing.assert_array_equal(out.data, jout.data)


def test_closure_popcount_transpose():
    rng = np.random.default_rng(4)
    m = rng.random((41, 41)) < 0.06
    M, J = pbin.BitMatrix.from_bool(m), jbin.BitMatrix.from_bool(m)
    M.closure_inplace()
    J.closure_inplace()
    ref = m.copy()
    while True:
        nxt = ref | ((ref.astype(np.int64) @ ref.astype(np.int64)) > 0)
        if np.array_equal(nxt, ref):
            break
        ref = nxt
    np.testing.assert_array_equal(M.to_bool(), ref)
    np.testing.assert_array_equal(M.data, J.data)
    np.testing.assert_array_equal(M.popcount_rows(), ref.sum(1))
    np.testing.assert_array_equal(M.transpose().to_bool(), ref.T)


# ---------------------------------------------------------------------------
# backend differential: the port's native == the JAX package's native ==
# the port's cpu oracle
# ---------------------------------------------------------------------------


def _diff(cluster, **flags):
    got = kvt.verify(cluster, kvt.VerifyConfig(backend="native", **flags))
    jax = jkv.verify(to_jax(cluster), jkv.VerifyConfig(backend="native", **flags))
    cpu = kvt.verify(cluster, kvt.VerifyConfig(backend="cpu", **flags))
    _same(got, jax)
    _same(got, cpu)
    assert got.backend == jax.backend == "native"


def test_k8s_matches_jax_native_and_cpu():
    _diff(kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=43, n_policies=17, n_namespaces=3, seed=37)))


@pytest.mark.parametrize("flags", [
    dict(self_traffic=False),
    dict(default_allow_unselected=False),
    dict(direction_aware_isolation=False),
    dict(compute_ports=False),
    dict(compute_ports=True),
], ids=lambda f: ",".join(f"{k}={v}" for k, v in f.items()))
def test_k8s_flags(flags):
    _diff(kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=31, n_policies=11, n_namespaces=2, seed=41,
        p_ports=0.8, p_named_port=0.3, p_container_ports=0.5)), **flags)


def test_k8s_closure():
    _diff(kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=21, n_policies=9, n_namespaces=2, seed=43)), closure=True)


def test_k8s_paper_example():
    _diff(kubesv_paper_example())


def test_kano_matches_jax_native_and_cpu():
    containers, policies = kvt.random_kano(51, 19, seed=47)
    got = kvt.verify_kano(containers, policies, kvt.VerifyConfig(backend="native",
                                                                 closure=True))
    cpu = kvt.verify_kano(*kvt.random_kano(51, 19, seed=47),
                          kvt.VerifyConfig(backend="cpu", closure=True))
    jc, jp = jkv.harness.generate.random_kano(51, 19, seed=47)
    jax = jkv.verify_kano(jc, jp, jkv.VerifyConfig(backend="native", closure=True))
    fields = ("reach", "src_sets", "dst_sets", "closure")
    _same(got, cpu, fields)
    _same(got, jax, fields)
    assert [c.select_policies for c in containers] == [c.select_policies for c in jc]
    assert [c.allow_policies for c in containers] == [c.allow_policies for c in jc]


def test_kano_paper_queries():
    containers, policies = kano_paper_example()
    res = kvt.verify_kano(containers, policies, kvt.VerifyConfig(backend="native"))
    assert res.all_isolated() == [4]
    assert res.user_crosscheck(containers, "app") == [1, 2, 3]
