"""The port's ``QueryEngine`` against the JAX package's, on the CPU, on both
serving engines after the same stream: ``can_reach`` (any-port and
port-refined), ``can_reach_batch`` (cold and warm cache), ``who_can_reach``,
``blast_radius`` (and their batch forms), ``path_exists``, ``hops`` and
``what_if`` give equal answers, and ``what_if`` leaves the port engine's
count matrices byte-equal. Exact: every answer is boolean, integer or a
pod name."""
import dataclasses

import numpy as np
import pytest

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.resilience.errors import ServeError as JaxServeError
from kubernetes_verification_tpu.serve import events as jev
from kubernetes_verification_tpu.serve import queries as jax_queries
from kubernetes_verification_tpu_torch.models.core import NetworkPolicy, Selector
from kubernetes_verification_tpu_torch.resilience.errors import ServeError
from kubernetes_verification_tpu_torch.serve import events as pev
from kubernetes_verification_tpu_torch.serve import queries as port_queries
from torch_serve_parity import clusters, dense_services, packed_services, streams

#: port specs in the cluster, so port-refined probes differ from any-port
_GEN = dict(p_ports=0.6, p_named_port=0.2, p_container_ports=0.5, seed=21)
_PORTS = [(80, "TCP"), (443, "TCP"), (8080, "TCP"), (9100, "TCP"), (53, "UDP")]


def _serve(kind):
    pcluster, jcluster = clusters(**_GEN)
    pevents, jevents = streams(jcluster, 200, seed=4)
    build = dense_services if kind == "dense" else packed_services
    psvc, jsvc = build(pcluster, jcluster)
    for i in range(0, 200, 50):
        psvc.apply(pevents[i:i + 50])
        jsvc.apply(jevents[i:i + 50])
    pq, jq = port_queries.QueryEngine(psvc), jax_queries.QueryEngine(jsvc)
    return psvc, jsvc, pq, jq, np.random.default_rng(7)


@pytest.fixture(scope="module", params=["dense", "packed"])
def served(request):
    return _serve(request.param)


def _refs(svc):
    return [f"{p.namespace}/{p.name}" for p in svc.engine.pods]


def test_can_reach_scalar(served):
    psvc, jsvc, pq, jq, rng = served
    refs = _refs(psvc)
    assert refs == _refs(jsvc)
    for _ in range(40):
        s, d = (refs[int(i)] for i in rng.integers(0, len(refs), 2))
        assert pq.can_reach(s, d) == jq.can_reach(s, d)
        port, proto = _PORTS[int(rng.integers(len(_PORTS)))]
        assert pq.can_reach(s, d, port, proto) == jq.can_reach(s, d, port, proto)
    assert psvc.stats.queries == jsvc.stats.queries


def test_can_reach_batch_cold_and_warm(served):
    psvc, jsvc, pq, jq, rng = served
    refs = _refs(psvc)
    hot = [refs[int(i)] for i in rng.integers(0, len(refs), 6)]
    probes = []
    for k in range(300):
        src = hot[k % len(hot)] if k % 5 else refs[int(rng.integers(len(refs)))]
        dst = refs[int(rng.integers(len(refs)))]
        if k % 7 == 0:
            port, proto = _PORTS[k % len(_PORTS)]
            probes.append((src, dst, port, proto))
        else:
            probes.append((src, dst))
    for _ in range(2):  # the second pass answers from the warm QueryCache
        got = pq.can_reach_batch(probes)
        np.testing.assert_array_equal(got, jq.can_reach_batch(probes))
    # the columnar form, and the scalar path, agree
    srcs, dsts = [p[0] for p in probes[:50]], [p[1] for p in probes[:50]]
    np.testing.assert_array_equal(pq.can_reach_batch(srcs=srcs, dsts=dsts),
                                  jq.can_reach_batch(srcs=srcs, dsts=dsts))
    assert [pq.can_reach(*p) for p in probes[:30]] == list(got[:30])
    assert [jq.can_reach(*p) for p in probes[:30]] == list(got[:30])
    assert psvc.stats.to_dict() == jsvc.stats.to_dict()
    assert pq._cache.generation == jq._cache.generation == psvc.generation


def test_who_can_reach_and_blast_radius(served):
    psvc, jsvc, pq, jq, rng = served
    refs = _refs(psvc)
    picks = [refs[int(i)] for i in rng.choice(len(refs), 8, replace=False)]
    for ref in picks:
        assert pq.who_can_reach(ref) == jq.who_can_reach(ref)
        assert pq.blast_radius(ref) == jq.blast_radius(ref)
    assert pq.who_can_reach_batch(picks) == jq.who_can_reach_batch(picks)
    assert pq.blast_radius_batch(picks) == jq.blast_radius_batch(picks)
    # a row and a column of the reach matrix, as names
    reach = psvc.reach()
    np.testing.assert_array_equal(reach, jsvc.reach())
    i = psvc.pod_index(*picks[0].split("/"))
    row = [refs[j] for j in np.nonzero(reach[i])[0] if j != i]
    col = [refs[j] for j in np.nonzero(reach[:, i])[0] if j != i]
    assert pq.blast_radius(picks[0]) == jq.blast_radius(picks[0]) == row
    assert pq.who_can_reach(picks[0]) == jq.who_can_reach(picks[0]) == col
    assert psvc.stats.to_dict() == jsvc.stats.to_dict()


def test_path_exists_and_hops(served):
    psvc, jsvc, pq, jq, rng = served
    refs = _refs(psvc)
    for _ in range(12):
        s, d = (refs[int(i)] for i in rng.integers(0, len(refs), 2))
        for h in (None, 1, 2):
            assert pq.path_exists(s, d, max_hops=h) == jq.path_exists(s, d, max_hops=h)
            assert pq.hops(s, d, max_hops=h) == jq.hops(s, d, max_hops=h)


def _candidates(svc):
    """An add, an update, a remove, and a deny-all-ingress policy."""
    pols = list(svc.engine.policies.values())
    donor = kvt.random_cluster(kvt.GeneratorConfig(n_pods=40, n_policies=6,
                                                   n_namespaces=4, seed=99))
    ns = svc.engine.pods[0].namespace
    return [
        pev.AddPolicy(policy=dataclasses.replace(donor.policies[0], name="wi-add",
                                                 namespace=ns)),
        pev.UpdatePolicy(policy=dataclasses.replace(pols[1], ingress=pols[2].ingress,
                                                    egress=pols[2].egress)),
        pev.RemovePolicy(namespace=pols[0].namespace, name=pols[0].name),
        pev.AddPolicy(policy=NetworkPolicy(
            name="wi-deny-all", namespace=ns, pod_selector=Selector(), ingress=())),
    ]


def test_what_if_equals_jax_and_commits_nothing(served):
    psvc, jsvc, pq, jq, _ = served
    cands = _candidates(psvc)
    jcands = [jev.decode_event(pev.encode_event(e)) for e in cands]
    if not psvc.packed:
        eng = psvc.engine
        before = (eng._ing_count.numpy().tobytes(), eng._eg_count.numpy().tobytes(),
                  eng._ing_iso.tobytes(), eng._eg_iso.tobytes())
        updates, gen = eng.update_count, psvc.generation
        res = pq.what_if(cands)
        assert res.to_dict() == jq.what_if(jcands).to_dict()
        assert (eng._ing_count.numpy().tobytes(), eng._eg_count.numpy().tobytes(),
                eng._ing_iso.tobytes(), eng._eg_iso.tobytes()) == before
        assert (eng.update_count, psvc.generation) == (updates, gen)
        assert res.n_removed > 0
        # an assertion that holds now and that the candidates break
        src, dst = res.removed[0]
        doc = [{"name": "keep", "kind": "allow",
                "from": {"namespace": src.split("/")[0], "name": src.split("/")[1]},
                "to": {"namespace": dst.split("/")[0], "name": dst.split("/")[1]}}]
        keep_p = [port_queries.Assertion(
            "keep", "allow", port_queries.PodSelector.from_dict(doc[0]["from"]),
            port_queries.PodSelector.from_dict(doc[0]["to"]))]
        keep_j = [jax_queries.Assertion(
            "keep", "allow", jax_queries.PodSelector.from_dict(doc[0]["from"]),
            jax_queries.PodSelector.from_dict(doc[0]["to"]))]
        assert port_queries.check_assertions(psvc, keep_p) == []
        assert jax_queries.check_assertions(jsvc, keep_j) == []
        broken = pq.what_if(cands, assertions=keep_p)
        assert not broken.ok and broken.to_dict() == jq.what_if(jcands, assertions=keep_j).to_dict()
        assert (eng._ing_count.numpy().tobytes(), eng._eg_count.numpy().tobytes()) == before[:2]
        assert psvc.stats.to_dict() == jsvc.stats.to_dict()
    else:
        with pytest.raises(ServeError, match="dense serving engine"):
            pq.what_if(cands)
        with pytest.raises(JaxServeError, match="dense serving engine"):
            jq.what_if(jcands)


def test_what_if_after_equals_a_one_shot_solve():
    """The overlay's ``after`` (dense engine) is the reach of the cluster
    with the candidates applied, solved from scratch by the CPU oracle."""
    psvc, _, pq, _, _ = _serve("dense")
    cands = _candidates(psvc)
    res = pq.what_if(cands, max_witnesses=10**6)
    cluster = psvc.engine.as_cluster()
    pols = {f"{p.namespace}/{p.name}": p for p in cluster.policies}
    for ev in cands:
        if isinstance(ev, pev.RemovePolicy):
            del pols[f"{ev.namespace}/{ev.name}"]
        else:
            pols[f"{ev.policy.namespace}/{ev.policy.name}"] = ev.policy
    after = kvt.verify(dataclasses.replace(cluster, policies=list(pols.values())),
                       kvt.VerifyConfig(backend="cpu", compute_ports=False)).reach
    before = psvc.reach()
    refs = _refs(psvc)
    name = lambda idx: [(refs[s], refs[d]) for s, d in zip(*idx)]
    assert res.added == name(np.nonzero(after & ~before))
    assert res.removed == name(np.nonzero(before & ~after))
