"""The port's sharded *packed* solve against the JAX package's, bit for bit:
``sharded_packed_reach`` any-port and with port bitmaps (words, aggregates,
isolation and every query), the semantic flags, stripes, ``groups=``,
``sweep_chunk_tiles``, the port-mask cap and the refusals, the sharded pair
masks and policy sets, and the ``sharded-packed`` backend through
``verify``.

As in ``test_torch_sharded.py``: the JAX side on the 8 virtual CPU
devices, the port's on one module-wide group of 8 gloo CPU ranks
(``tests/torch_mesh_child.py``) over the ``(8, 1)``, ``(4, 2)``,
``(2, 4)`` and ``(1, 8)`` meshes; every rank's arrays must equal rank 0's."""
import dataclasses
import functools

import numpy as np
import pytest

import kubernetes_verification_tpu as kv
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import random_cluster as jax_random_cluster
from kubernetes_verification_tpu.ops.queries import user_groups
from kubernetes_verification_tpu.ops.tiled import (
    policy_pair_masks_sharded,
    policy_sets_sharded,
)
from kubernetes_verification_tpu.parallel.mesh import mesh_for as jax_mesh_for
from kubernetes_verification_tpu.parallel.packed_sharded import sharded_packed_reach
from torch_mesh_child import MeshJob
from torch_parity import carried

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
GEOM = dict(tile=32, chunk=8)
ANY = dict(n_pods=53, n_policies=13, n_namespaces=3, seed=3)
PORTS = dict(n_pods=61, n_policies=11, n_namespaces=3, p_ports=0.8, seed=43)
FLAG = dict(n_pods=41, n_policies=9, n_namespaces=2, seed=5)
FLAG_PORTS = dict(n_pods=41, n_policies=9, n_namespaces=2, p_ports=0.8, seed=5)
STRIPE = dict(n_pods=70, n_policies=9, n_namespaces=2, seed=11)
STRIPE_PORTS = dict(n_pods=47, n_policies=9, n_namespaces=3, p_ports=0.9, seed=11)
CROSS = dict(n_pods=57, n_policies=11, n_namespaces=3, seed=15)
CAP = dict(n_pods=21, n_policies=7, n_namespaces=2, p_ports=0.9, seed=5)
PAIRS = dict(n_pods=60, n_policies=12, n_namespaces=2, p_ports=0.5, seed=19)
BACKEND = dict(n_pods=53, n_policies=13, n_namespaces=3, p_ports=0.7, seed=3)
FLAGS = {
    "no-self": dict(self_traffic=False),
    "no-default-allow": dict(default_allow_unselected=False),
    "no-direction": dict(direction_aware_isolation=False),
}
#: every flag any-port; with port bitmaps the one that reaches their own
#: default-allow terms (DI∧DE, DI∧GE_any, DE∧GI_any)
FLAG_CASES = [*(("flag", name) for name in FLAGS), ("flag_ports", "no-default-allow")]
QUERIES = dict(isolation_of=[0, 29], crosscheck=["team"])


@functools.lru_cache(maxsize=None)
def _enc(name):
    gen = dict(GENS[name])
    return carried(**gen, compute_ports=gen.get("p_ports", 0) > 0)[0]


GENS = dict(any=ANY, ports=PORTS, flag=FLAG, flag_ports=FLAG_PORTS, stripe=STRIPE,
            stripe_ports=STRIPE_PORTS, cross=CROSS, cap=CAP, pairs=PAIRS)


def _cluster(gen):
    return jax_random_cluster(JaxGeneratorConfig(**gen))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    job = MeshJob(tmp_path_factory.mktemp("packed_sharded"))
    enc = {name: job.encoding(name, _enc(name)) for name in GENS}
    for shape in MESHES:
        job.case(f"any{shape}", "packed", shape, enc["any"], gen=ANY, keep_matrix=True,
                 **GEOM, **QUERIES)
        job.case(f"ports{shape}", "packed", shape, enc["ports"], gen=PORTS, keep_matrix=True,
                 **GEOM, **QUERIES)
        job.case(f"pairs{shape}", "pair_masks", shape, enc["pairs"], chunk=8)
    job.case("pairs-no-direction", "pair_masks", (4, 2), enc["pairs"], chunk=8,
             direction_aware_isolation=False)
    for kind, name in FLAG_CASES:
        job.case(f"{kind}-{name}", "packed", (4, 2), enc[kind], keep_matrix=True,
                 **GEOM, **FLAGS[name])
    job.case("aggregates", "packed", (4, 2), enc["stripe"], keep_matrix=False, **GEOM)
    for kind in ("stripe", "stripe_ports"):
        gen = GENS[kind]
        job.case(f"{kind}-full", "packed", (4, 2), enc[kind], gen=gen, keep_matrix=False,
                 groups_label="team", crosscheck=["team"], **GEOM)
        for part, stripe in _halves(kind).items():
            job.case(f"{kind}-{part}", "packed", (4, 2), enc[kind], stripe=stripe,
                     keep_matrix=False, **GEOM)
    job.case("chunked", "packed", (8, 1), enc["stripe"], sweep_chunk_tiles=3, **GEOM)
    job.case("chunked-stripe", "packed", (8, 1), enc["stripe"], sweep_chunk_tiles=3,
             stripe=(0, 2), **GEOM)
    job.case("partial", "packed", (4, 2), enc["stripe"], stripe=(0, 2), **GEOM)
    job.case("cross-matrix", "packed", (4, 2), enc["cross"], gen=CROSS, keep_matrix=True,
             **GEOM, **QUERIES)
    job.case("cross-groups", "packed", (4, 2), enc["cross"], gen=CROSS, keep_matrix=False,
             groups_label="team", isolation_of=[0], crosscheck=["team", "app"], **GEOM)
    job.case("cross-bare", "packed", (4, 2), enc["cross"], gen=CROSS, keep_matrix=False,
             crosscheck=["team"], **GEOM)
    job.case("cap", "packed", (8, 1), enc["cap"], max_port_masks=0, **GEOM)
    opts = dict(mesh=[4, 2], tile=32, chunk=8, keep_matrix=True)
    for ports in (False, True):
        job.case(f"verify-{ports}", "verify", (4, 2), gen=BACKEND, backend="sharded-packed",
                 compute_ports=ports, options=opts, queries=True)
    job.case("verify-limit", "verify", (4, 2), gen=BACKEND, backend="sharded-packed",
             compute_ports=False, options={**opts, "dense_reach_limit": 10}, queries=True)
    job.case("verify-no-direction", "verify", (8, 1), gen=PAIRS, backend="sharded-packed",
             direction_aware_isolation=False, options=dict(tile=32, chunk=8), queries=True)
    job.start()
    yield job
    job.close()


@functools.lru_cache(maxsize=None)
def _jax_solve(name, shape, **kw):
    if "groups_label" in kw:
        kw["groups"] = user_groups(_cluster(GENS[name]).pods, kw.pop("groups_label"))
    return sharded_packed_reach(jax_mesh_for(shape), _enc(name), **GEOM, **kw)


def _halves(kind):
    n_tiles = _jax_solve(kind, (4, 2), keep_matrix=False).timings["tiles"]
    mid = (n_tiles // 2 // 2) * 2  # stripe widths must divide mp = 2
    return {"a": (0, mid), "b": (mid, n_tiles)}


def _error(got):
    """(is a ValueError, message) of a refusal the ranks recorded."""
    assert got.ndim == 0 and got.dtype.kind == "U", f"expected a refusal, got {got!r}"
    _, is_value_error, msg = str(got).split("|", 2)
    return is_value_error == "True", msg


def _assert_result(got, want, *, queries=True):
    np.testing.assert_array_equal(got["out_degree"], want.out_degree)
    np.testing.assert_array_equal(got["in_degree"], want.in_degree)
    assert int(got["total_pairs"]) == want.total_pairs
    np.testing.assert_array_equal(got["ingress_isolated"], np.asarray(want.ingress_isolated))
    np.testing.assert_array_equal(got["egress_isolated"], np.asarray(want.egress_isolated))
    assert bool(got["full_sweep"]) == want.full_sweep
    assert int(got["tiles"]) == want.timings["tiles"]
    if want.packed is None:
        assert "packed" not in got
    else:
        np.testing.assert_array_equal(got["packed"], np.asarray(want.packed).view(np.uint32))
    if want.group_in_degree is None:
        assert "group_in_degree" not in got
    else:
        np.testing.assert_array_equal(got["group_in_degree"], want.group_in_degree)
    if queries and want.full_sweep:
        assert got["all_reachable"].tolist() == want.all_reachable()
        assert got["all_isolated"].tolist() == want.all_isolated()


def _assert_queries(got, want, cluster):
    for key in got:
        if key.startswith("system_isolation_"):
            idx = int(key.rsplit("_", 1)[1])
            if want.packed is None:
                assert "keep_matrix" in _error(got[key])[1]
            else:
                assert got[key].tolist() == want.system_isolation(idx)
        elif key.startswith("crosscheck_"):
            label = key.split("_", 1)[1]
            try:
                expect = want.user_crosscheck(cluster.pods, label)
            except ValueError as e:
                is_value_error, msg = _error(got[key])
                assert is_value_error and msg == str(e)
            else:
                assert got[key].tolist() == expect


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("kind", ["any", "ports"])
def test_packed_reach_matches_jax(job, kind, shape):
    want = _jax_solve(kind, shape, keep_matrix=True)
    got = job.result(f"{kind}{shape}")
    _assert_result(got, want)
    np.testing.assert_array_equal(got["to_bool"], want.to_bool())
    _assert_queries(got, want, _cluster(GENS[kind]))
    # and the CPU oracle: the sharded words are the reach
    ref = kv.verify(_cluster(GENS[kind]), kv.VerifyConfig(
        backend="cpu", compute_ports=kind == "ports"))
    np.testing.assert_array_equal(got["to_bool"], ref.reach)


@pytest.mark.parametrize("kind,name", FLAG_CASES)
def test_semantic_flags_match_jax(job, kind, name):
    want = _jax_solve(kind, (4, 2), keep_matrix=True, **FLAGS[name])
    _assert_result(job.result(f"{kind}-{name}"), want)


def test_aggregates_only_mode(job):
    want = _jax_solve("stripe", (4, 2), keep_matrix=False)
    got = job.result("aggregates")
    _assert_result(got, want)
    assert "keep_matrix" in _error(got["to_bool"])[1]


@pytest.mark.parametrize("kind", ["stripe", "stripe_ports"])
def test_stripes_and_groups_compose(job, kind):
    """Disjoint stripes' aggregate partials sum to the full sweep, each
    equal to the JAX package's; the per-group in-degrees answer the
    crosscheck matrix-free."""
    full = _jax_solve(kind, (4, 2), keep_matrix=False, groups_label="team")
    got = job.result(f"{kind}-full")
    _assert_result(got, full)
    _assert_queries(got, full, _cluster(GENS[kind]))
    parts = []
    for part, stripe in _halves(kind).items():
        want = _jax_solve(kind, (4, 2), keep_matrix=False, stripe=stripe)
        parts.append(job.result(f"{kind}-{part}"))
        _assert_result(parts[-1], want)
    for key in ("out_degree", "in_degree"):
        np.testing.assert_array_equal(parts[0][key] + parts[1][key], got[key])


def test_full_aggregate_sweep_chunked(job):
    want = sharded_packed_reach(jax_mesh_for((8, 1)), _enc("stripe"), **GEOM,
                                sweep_chunk_tiles=3)
    got = job.result("chunked")
    _assert_result(got, want)
    assert int(got["n_chunks"]) == want.timings["n_chunks"] == 3
    is_value_error, msg = _error(job.result("chunked-stripe")["error"])
    assert is_value_error and "drop stripe" in msg


def test_partial_stripe_refuses_whole_matrix_queries(job):
    want = _jax_solve("stripe", (4, 2), stripe=(0, 2))
    got = job.result("partial")
    _assert_result(got, want, queries=False)
    assert "packed" not in got  # a partial matrix is never kept
    for q in ("all_reachable", "all_isolated"):
        assert "full dst sweep" in _error(got[q])[1]


@pytest.mark.parametrize("case,keep,groups", [
    ("cross-matrix", True, False), ("cross-groups", False, True), ("cross-bare", False, False)])
def test_crosscheck_and_system_isolation(job, case, keep, groups):
    kw = dict(keep_matrix=keep)
    if groups:
        kw["groups_label"] = "team"
    want = _jax_solve("cross", (4, 2), **kw)
    got = job.result(case)
    _assert_result(got, want)
    _assert_queries(got, want, _cluster(CROSS))


def test_port_mask_cap_enforced(job):
    assert len(_enc("cap").atoms) > 1
    with pytest.raises(ValueError):
        sharded_packed_reach(jax_mesh_for((8, 1)), _enc("cap"), **GEOM, max_port_masks=0)
    is_value_error, msg = _error(job.result("cap")["error"])
    assert is_value_error and "cap of 0" in msg


@pytest.mark.parametrize("case,shape,dai", [
    *((f"pairs{s}", s, True) for s in MESHES), ("pairs-no-direction", (4, 2), False)])
def test_pair_masks_and_sets_match_jax(job, case, shape, dai):
    got = job.result(case)
    shadow, conflict, src, dst = _jax_pairs(dai)
    for key, want in (("shadow", shadow), ("conflict", conflict), ("src_sets", src),
                      ("dst_sets", dst)):
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    assert shadow.any() or conflict.any(), "the fixture must exercise the masks"


@functools.lru_cache(maxsize=None)
def _jax_pairs(dai):
    """The JAX package's sharded masks and sets, on the (4, 2) mesh: its
    GSPMD split leaves them the same on every mesh, so every one of the
    port's meshes is held against these."""
    mesh, enc = jax_mesh_for((4, 2)), _enc("pairs")
    kw = dict(direction_aware_isolation=dai, chunk=8)
    return (*policy_pair_masks_sharded(mesh, enc, **kw), *policy_sets_sharded(mesh, enc, **kw))


def _assert_backend(got, want, cluster, ports, **flags):
    assert bool(got["reach_is_none"]) == (want.reach is None)
    if want.reach is not None:
        np.testing.assert_array_equal(got["reach"], want.reach)
    pk = want.packed_result
    np.testing.assert_array_equal(got["packed"], pk.packed)
    np.testing.assert_array_equal(got["out_degree"], pk.out_degree)
    np.testing.assert_array_equal(got["ingress_isolated"], want.ingress_isolated)
    assert got["all_isolated"].tolist() == want.all_isolated()
    assert got["all_reachable"].tolist() == want.all_reachable()
    assert got["system_isolation_3"].tolist() == want.system_isolation(3)
    for label in ("team", "app"):
        assert got[f"crosscheck_{label}"].tolist() == want.user_crosscheck(cluster.pods, label)
    assert bool(got["reachable_0_1"]) == want.reachable(0, 1)
    # the pairwise queries through the sharded Gram masks, lazily
    assert [tuple(p) for p in got["policy_shadow"].tolist()] == want.policy_shadow()
    assert [tuple(p) for p in got["policy_conflict"].tolist()] == want.policy_conflict()
    assert "budget" in _error(got["sets_over_budget"])[1]
    src, dst = want.materialize_policy_sets()
    np.testing.assert_array_equal(got["materialized_src"], src)
    np.testing.assert_array_equal(got["materialized_dst"], dst)
    ref = kv.verify(cluster, kv.VerifyConfig(backend="cpu", compute_ports=ports, **flags))
    np.testing.assert_array_equal(got["materialized_src"], ref.src_sets)


@pytest.mark.parametrize("case,ports,limit", [
    ("verify-False", False, None), ("verify-True", True, None), ("verify-limit", False, 10)])
def test_backend_verify_matches_jax(job, case, ports, limit):
    cluster = _cluster(BACKEND)
    want = _jax_backend(ports)
    if limit is not None:
        # above the dense-reach limit: no dense reach, the same packed answers
        want = dataclasses.replace(want, reach=None)
    _assert_backend(job.result(case), want, cluster, ports)


@functools.lru_cache(maxsize=None)
def _jax_backend(ports):
    opts = (("mesh", (4, 2)), ("tile", 32), ("chunk", 8), ("keep_matrix", True))
    return kv.verify(_cluster(BACKEND), kv.VerifyConfig(
        backend="sharded-packed", compute_ports=ports, backend_options=opts))


def test_backend_pair_masks_respect_direction_flag(job):
    cluster = _cluster(PAIRS)
    cfg = dict(direction_aware_isolation=False)
    want = kv.verify(cluster, kv.VerifyConfig(
        backend="sharded-packed", backend_options=(("mesh", (8, 1)), ("tile", 32),
                                                   ("chunk", 8)), **cfg))
    _assert_backend(job.result("verify-no-direction"), want, cluster, True, **cfg)
    ref = kv.verify(cluster, kv.VerifyConfig(backend="cpu", **cfg))
    got = job.result("verify-no-direction")
    assert [tuple(p) for p in got["policy_shadow"].tolist()] == ref.policy_shadow()
    assert [tuple(p) for p in got["policy_conflict"].tolist()] == ref.policy_conflict()
