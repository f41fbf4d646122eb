"""The port's Datalog engine and ``datalog`` backend against the JAX
package's, case for case of ``tests/test_datalog.py``: the same programs
solve to the same relations (exact: every relation is boolean) in the same
number of sweeps, on the NumPy route and on the torch route (``device=
"cpu"``); ``Program.dump()`` text is byte-equal; the backend's
``VerifyResult`` equals the JAX backend's under every ``compute_ports``
setting and semantic flag; the torch rule cache holds one entry per einsum
spec."""
import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu.datalog as jdl
import kubernetes_verification_tpu_torch as kvt
import kubernetes_verification_tpu_torch.datalog as tdl
from kubernetes_verification_tpu.harness.generate import GeneratorConfig as JaxGen
from kubernetes_verification_tpu.harness.generate import random_cluster as jax_random_cluster
from kubernetes_verification_tpu.harness.generate import random_kano as jax_random_kano
from kubernetes_verification_tpu.models.fixtures import (
    kano_paper_example as jax_kano_paper_example,
)
from kubernetes_verification_tpu.models.fixtures import (
    kubesv_paper_example as jax_kubesv_paper_example,
)
from kubernetes_verification_tpu_torch.datalog import engine as tengine
from kubernetes_verification_tpu_torch.models.fixtures import (
    kano_paper_example,
    kubesv_paper_example,
)
from kubernetes_verification_tpu_torch.resilience.errors import BackendError

CPU = (("device", "cpu"),)
#: the port's backend on its two routes: torch rules on the CPU, NumPy
ROUTES = {"torch": CPU, "numpy": (("use_torch", False),)}


def _solutions(build):
    """``build(dl)`` makes a program with one package's ``datalog``; the
    JAX package's NumPy solve, the port's NumPy solve and the port's torch
    solve on the CPU."""
    return (
        jdl.solve(build(jdl)),
        tdl.solve(build(tdl)),
        tdl.solve(build(tdl), use_torch=True, device="cpu"),
    )


def _same(build):
    want, *got = _solutions(build)
    for sol in got:
        assert sol.relations.keys() == want.relations.keys()
        for k, w in want.relations.items():
            assert sol[k].dtype == w.dtype and sol[k].shape == w.shape, k
            np.testing.assert_array_equal(sol[k], w, err_msg=k)
        assert sol.iterations == want.iterations
    return got


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def _chain(dl):
    prog = dl.Program()
    n = prog.domain("n", 6)
    prog.relation("edge", n, n)
    prog.relation("path", n, n)
    for i in range(5):
        prog.fact("edge", i, i + 1)
    prog.rule(dl.Atom("path", ("s", "d")), dl.Atom("edge", ("s", "d")))
    prog.rule(dl.Atom("path", ("s", "d")), dl.Atom("path", ("s", "x")),
              dl.Atom("path", ("x", "d")))
    return prog


def test_transitive_closure_chain():
    for sol in _same(_chain):
        assert sol["path"][0, 5] and sol["path"][2, 4] and not sol["path"][3, 1]
        assert sol.query("path", (0, None)) == [(0, i) for i in range(1, 6)]


def _negation(dl):
    prog = dl.Program()
    v = prog.domain("v", 4)
    prog.relation("is_vec", v)
    prog.relation("label", v)
    prog.relation("not_labeled", v)
    prog.fact_array("is_vec", np.ones(4, dtype=bool))
    prog.fact("label", 1)
    prog.fact("label", 3)
    prog.rule(dl.Atom("not_labeled", ("a",)), dl.Atom("is_vec", ("a",)),
              dl.Atom("label", ("a",), negated=True))
    return prog


def test_negation_stratified():
    for sol in _same(_negation):
        np.testing.assert_array_equal(sol["not_labeled"], [True, False, True, False])


def test_negation_cycle_and_unsafe_rules_rejected():
    for dl in (jdl, tdl):
        prog = dl.Program()
        v = prog.domain("v", 2)
        prog.relation("a", v)
        prog.relation("b", v)
        prog.fact("a", 0)
        with pytest.raises(ValueError, match="unsafe"):
            prog.rule(dl.Atom("b", ("y",)), dl.Atom("a", ("x",)))
        with pytest.raises(ValueError, match="unsafe"):
            prog.rule(dl.Atom("b", ("x",)), dl.Atom("a", ("x",)),
                      dl.Atom("a", ("z",), negated=True))
        prog.rule(dl.Atom("b", ("x",)), dl.Atom("a", ("x",)),
                  dl.Atom("b", ("x",), negated=True))
        with pytest.raises(ValueError, match="not stratifiable"):
            prog.strata()


def _constants(dl):
    prog = dl.Program()
    n = prog.domain("n", 3)
    m = prog.domain("m", 2)
    prog.relation("r", n, m)
    prog.relation("diag", n, n)
    prog.relation("hit", n)
    prog.relation("ground", m)
    prog.fact("r", 1, 0)
    prog.fact("r", 2, 1)
    prog.rule(dl.Atom("hit", ("x",)), dl.Atom("r", ("x", 0)))  # constant in body
    prog.rule(dl.Atom("diag", ("x", "x")), dl.Atom("hit", ("x",)))  # repeated head var
    prog.rule(dl.Atom("ground", (1,)), dl.Atom("hit", ("x",)))  # ground head
    return prog


def test_constants_and_repeated_head_vars():
    for sol in _same(_constants):
        np.testing.assert_array_equal(sol["hit"], [False, True, False])
        assert sol.query("diag") == [(1, 1)]
        assert sol.query("ground") == [(1,)]


def _random_closure(dl):
    prog = dl.Program()
    n = prog.domain("n", 7)
    prog.relation("e", n, n)
    prog.relation("p", n, n)
    prog.relation("t", n, n)
    prog.fact_array("e", np.random.default_rng(0).random((7, 7)) < 0.3)
    prog.rule(dl.Atom("p", ("s", "d")), dl.Atom("e", ("s", "d")))
    prog.rule(dl.Atom("p", ("s", "d")), dl.Atom("p", ("s", "x")), dl.Atom("p", ("x", "d")))
    # a transposed head and a projection
    prog.rule(dl.Atom("t", ("d", "s")), dl.Atom("p", ("s", "d")), dl.Atom("e", ("d", "x")))
    return prog


def test_torch_evaluation_matches_numpy():
    _same(_random_closure)


def _negated_diagonal(dl):
    prog = dl.Program()
    n = prog.domain("n", 4)
    prog.relation("r", n, n)
    prog.relation("is_n", n)
    prog.relation("no_self", n)
    prog.fact_array("is_n", np.ones(4, dtype=bool))
    prog.fact("r", 1, 1)  # self-loop at 1
    prog.fact("r", 2, 3)  # off-diagonal edge must NOT mask node 2
    prog.rule(dl.Atom("no_self", ("x",)), dl.Atom("is_n", ("x",)),
              dl.Atom("r", ("x", "x"), negated=True))
    return prog


def test_negated_atom_with_repeated_variable():
    for sol in _same(_negated_diagonal):
        np.testing.assert_array_equal(sol["no_self"], [True, False, True, True])


def test_dump_renders_program_byte_equal():
    def build(dl):
        prog = dl.Program()
        n = prog.domain("n", 3)
        prog.relation("e", n, n)
        prog.relation("p", n, n)
        prog.fact("e", 0, 1)
        prog.fact_array("e", np.eye(3, dtype=bool))
        prog.rule(dl.Atom("p", ("s", "d")), dl.Atom("e", ("s", "d")))
        prog.rule(dl.Atom("p", ("s", "s")), dl.Atom("e", ("s", 2), negated=False))
        return prog

    text = build(tdl).dump()
    assert text == build(jdl).dump()
    assert "p(s, d) :- e(s, d)." in text
    assert "% relation e(n, n)  [4 facts]" in text


def test_torch_mode_caches_rule_kernels():
    """One rule kernel per einsum spec, reused across sweeps and solves."""
    tengine._RULE_EINSUM_CACHE.clear()

    def build(dl):
        prog = dl.Program()
        d = prog.domain("n", 6)
        prog.relation("e", d, d)
        prog.relation("p", d, d)
        for s_, t in [(0, 1), (1, 2), (2, 3), (3, 4)]:
            prog.fact("e", s_, t)
        prog.rule(dl.Atom("p", ("x", "y")), dl.Atom("e", ("x", "y")))
        prog.rule(dl.Atom("p", ("x", "z")), dl.Atom("p", ("x", "y")), dl.Atom("p", ("y", "z")))
        return prog

    a = tdl.solve(build(tdl), use_torch=True, device="cpu")
    assert sorted(tengine._RULE_EINSUM_CACHE) == ["ab,bc->ac", "ab->ab"]
    b = tdl.solve(build(tdl), use_torch=True, device="cpu")
    assert len(tengine._RULE_EINSUM_CACHE) == 2  # reused across solves
    np.testing.assert_array_equal(a["p"], b["p"])
    np.testing.assert_array_equal(a["p"], jdl.solve(build(jdl))["p"])


def test_rule_cache_is_lru_bounded():
    tengine._RULE_EINSUM_CACHE.clear()
    for i in range(tengine._RULE_EINSUM_CACHE_MAX + 5):
        tengine._torch_rule_einsum(f"spec-{i}")  # cached, never run
    assert len(tengine._RULE_EINSUM_CACHE) == tengine._RULE_EINSUM_CACHE_MAX
    assert "spec-4" not in tengine._RULE_EINSUM_CACHE
    assert "spec-5" in tengine._RULE_EINSUM_CACHE
    tengine._RULE_EINSUM_CACHE.clear()


def test_torch_route_defaults_to_the_card():
    with pytest.raises(BackendError, match="no CUDA device"):
        tdl.solve(_chain(tdl), use_torch=True)
    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=5, n_policies=2, seed=1))
    with pytest.raises(BackendError, match="no CUDA device"):
        kvt.verify(cluster, kvt.VerifyConfig(backend="datalog"))


# ---------------------------------------------------------------------------
# the datalog backend against the JAX package's
# ---------------------------------------------------------------------------

_FIELDS = ("reach", "reach_ports", "selected", "src_sets", "dst_sets",
           "ingress_isolated", "egress_isolated", "closure")


def _diff(jcluster, cluster, route="torch", **flags):
    want = jkv.verify(jcluster, jkv.VerifyConfig(backend="datalog", **flags))
    got = kvt.verify(cluster, kvt.VerifyConfig(
        backend="datalog", backend_options=ROUTES[route], **flags))
    for name in _FIELDS:
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert [tuple(vars(a).values()) for a in got.port_atoms] == [
        tuple(vars(a).values()) for a in want.port_atoms]
    assert got.backend == "datalog" and set(got.timings) == {"encode", "solve"}
    return got


def _pair(**gen):
    return (jax_random_cluster(JaxGen(**gen)),
            kvt.random_cluster(kvt.GeneratorConfig(**gen)))


_K8S = dict(n_pods=23, n_policies=9, n_namespaces=3, seed=17)
_PORTS = dict(n_pods=21, n_policies=7, n_namespaces=3, p_ports=0.8,
              p_named_port=0.3, p_container_ports=0.5, seed=19)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("compute_ports", [True, False])
def test_k8s_backend_matches_jax(route, compute_ports):
    _diff(*_pair(**_K8S), route=route, compute_ports=compute_ports)


@pytest.mark.parametrize("compute_ports", [True, False])
def test_k8s_backend_with_port_specs_matches_jax(compute_ports):
    got = _diff(*_pair(**_PORTS), compute_ports=compute_ports)
    if compute_ports:
        assert got.reach_ports.shape[2] > 1  # the port atoms were exercised


@pytest.mark.parametrize("flags", [
    dict(self_traffic=False),
    dict(default_allow_unselected=False),
    dict(direction_aware_isolation=False),
])
def test_k8s_backend_flags(flags):
    _diff(*_pair(n_pods=19, n_policies=7, n_namespaces=2, seed=23), **flags)


def test_k8s_paper_example():
    assert _diff(jax_kubesv_paper_example(), kubesv_paper_example()).backend == "datalog"


def test_closure_is_true_transitive_closure():
    got = _diff(*_pair(n_pods=13, n_policies=5, n_namespaces=2, seed=29), closure=True)
    ref = kvt.verify(kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=13, n_policies=5, n_namespaces=2, seed=29)),
        kvt.VerifyConfig(backend="cpu", closure=True))
    np.testing.assert_array_equal(got.closure, ref.closure)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_kano_backend_matches_jax(route):
    jc, jp = jax_random_kano(29, 11, seed=31)
    c, p = kvt.random_kano(29, 11, seed=31)
    want = jkv.verify_kano(jc, jp, jkv.VerifyConfig(backend="datalog", closure=True))
    got = kvt.verify_kano(c, p, kvt.VerifyConfig(
        backend="datalog", closure=True, backend_options=ROUTES[route]))
    for name in ("reach", "src_sets", "dst_sets", "closure"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert [x.select_policies for x in c] == [x.select_policies for x in jc]
    assert [x.allow_policies for x in c] == [x.allow_policies for x in jc]


def test_kano_paper_example_queries():
    containers, policies = kano_paper_example()
    res = kvt.verify_kano(containers, policies, kvt.VerifyConfig(
        backend="datalog", backend_options=CPU))
    assert res.all_isolated() == [4]
    assert res.user_crosscheck(containers, "app") == [1, 2, 3]
    jc, jp = jax_kano_paper_example()
    want = jkv.verify_kano(jc, jp, jkv.VerifyConfig(backend="datalog"))
    np.testing.assert_array_equal(res.reach, want.reach)


@pytest.mark.parametrize("compute_ports", [True, False])
def test_program_dump_is_byte_equal(compute_ports):
    for jcluster, cluster in ((jax_kubesv_paper_example(), kubesv_paper_example()),
                              _pair(**_PORTS)):
        want, _, jatoms = jdl.build_k8s_program(
            jcluster, jkv.VerifyConfig(compute_ports=compute_ports))
        got, _, atoms = tdl.build_k8s_program(
            cluster, kvt.VerifyConfig(compute_ports=compute_ports))
        text = got.dump()
        assert text == want.dump()
        assert len(atoms) == len(jatoms)
        for rel in ("selected", "ing_allow", "ingress_traffic", "edge", "path"):
            assert rel in text
    cs, ps = kvt.random_kano(12, 5, seed=3)
    jcs, jps = jax_random_kano(12, 5, seed=3)
    assert tdl.build_kano_program(cs, ps)[0].dump() == jdl.build_kano_program(jcs, jps)[0].dump()
