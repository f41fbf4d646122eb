"""The plain reference against hand-worked clusters, any-port and with
ports, and against the port's object-level oracle on random ones."""
import numpy as np
import pytest
import torch

from kvbench import generate, reference


def sel(**labels):
    return {"match_labels": labels, "match_expressions": []}


def pod(name, ns, ports=None, **labels):
    return {"name": name, "namespace": ns, "labels": labels, "ip": None,
            "container_ports": ports or {}}


def pol(name, ns, selector, ingress=None, egress=None, types=None):
    return {"name": name, "namespace": ns, "pod_selector": selector,
            "policy_types": types, "ingress": ingress, "egress": egress}


def rule(peers=None, ports=None):
    return {"peers": peers, "ports": ports}


def peer(pod_sel=None, ns_sel=None):
    return {"pod_selector": pod_sel, "namespace_selector": ns_sel, "ip_block": None}


def port(proto, p, end=None):
    return {"protocol": proto, "port": p, "end_port": end}


def solve(cluster, ports=False, **kw):
    n = len(cluster["pods"])
    ii, ie, r = reference.solve_rows(cluster, list(range(n)), compute_ports=ports, **kw)
    return ii, ie, r.numpy()


NS = [{"name": "a", "labels": {"team": "x"}}, {"name": "b", "labels": {"team": "y"}}]
PODS = [pod("web", "a", app="web"), pod("db", "a", app="db"), pod("ext", "b", app="web")]


def test_no_policy_everything_reaches_everything():
    _, _, r = solve({"pods": PODS, "namespaces": NS, "policies": []})
    assert r.all()


def test_ingress_isolation_allows_only_granted_sources():
    # db accepts only from pods of namespace a labelled app=web
    p = pol("p", "a", sel(app="db"), ingress=[rule([peer(sel(app="web"))])])
    ii, ie, r = solve({"pods": PODS, "namespaces": NS, "policies": [p]})
    assert ii.tolist() == [False, True, False] and not ie.any()
    want = np.ones((3, 3), dtype=bool)
    want[2, 1] = False  # ext is in namespace b: the peer means namespace a only
    assert (r == want).all()


def test_namespace_selector_and_egress_isolation():
    # web may send only to namespace b, and (policy types default to
    # Ingress as well) accepts nothing; db accepts from team=y namespaces
    p1 = pol("e", "a", sel(app="web"), egress=[rule([peer(None, sel(team="y"))])])
    p2 = pol("i", "a", sel(app="db"), ingress=[rule([peer(None, sel(team="y"))])])
    ii, ie, r = solve({"pods": PODS, "namespaces": NS, "policies": [p1, p2]})
    want = np.array([[1, 0, 1], [0, 1, 1], [0, 1, 1]], dtype=bool)
    assert (r == want).all()
    assert ii.tolist() == [True, True, False] and ie.tolist() == [True, False, False]


def test_policy_types_gate_a_direction():
    # an egress section under policy types Ingress only grants nothing and
    # isolates nothing in egress
    p = pol("p", "a", sel(app="web"), ingress=[rule()], egress=[], types=["Ingress"])
    ii, ie, r = solve({"pods": PODS, "namespaces": NS, "policies": [p]})
    assert not ie.any() and r.all()


def test_match_expressions():
    e = {"match_labels": {}, "match_expressions": [
        {"key": "app", "op": "NotIn", "values": ["web"]}]}
    p = pol("p", "a", e, ingress=[])
    ii, _, r = solve({"pods": PODS, "namespaces": NS, "policies": [p]})
    assert ii.tolist() == [False, True, False]
    assert r[:, 1].tolist() == [False, True, False]  # only itself


def test_ports_need_one_port_granted_both_ways():
    # web sends only TCP 80; db accepts only TCP 443: no common port
    p1 = pol("e", "a", sel(app="web"), egress=[rule(None, [port("TCP", 80)])])
    p2 = pol("i", "a", sel(app="db"), ingress=[rule(None, [port("TCP", 400, 500)])])
    cl = {"pods": PODS, "namespaces": NS, "policies": [p1, p2]}
    _, _, r = solve(cl, ports=True)
    assert not r[0, 1] and r[2, 1] and r[0, 2]
    _, _, r_any = solve(cl, ports=False)
    assert r_any[0, 1]
    p2["ingress"] = [rule(None, [port("TCP", 50, 90)])]
    _, _, r = solve(cl, ports=True)
    assert r[0, 1]


def test_named_ports_resolve_on_the_destination():
    pods = [pod("c", "a", app="c"), pod("s1", "a", {"http": ["TCP", 8080]}, app="s"),
            pod("s2", "a", {"http": ["TCP", 9090]}, app="s")]
    p1 = pol("e", "a", sel(app="c"), egress=[rule(None, [port("TCP", 8080)])])
    p2 = pol("i", "a", sel(app="s"), ingress=[rule(None, [port("TCP", "http")])])
    _, _, r = solve({"pods": pods, "namespaces": NS, "policies": [p1, p2]}, ports=True)
    assert r[0].tolist() == [True, True, False]


def test_controls_break_their_guarantee():
    p1 = pol("e", "a", sel(app="web"), egress=[rule([peer(sel(app="db"))], [port("TCP", 80)])])
    p2 = pol("i", "a", sel(app="db"), ingress=[rule(None, [port("TCP", 443)])])
    cl = {"pods": PODS, "namespaces": NS, "policies": [p1, p2]}
    _, _, r = solve(cl, ports=True)
    _, _, c = solve(cl, ports=True, control="ignore_ports")
    assert (c != r).any()
    _, _, r = solve(cl)
    _, _, c = solve(cl, control="no_egress")
    assert (c != r).any()


def test_rows_blocks_and_unpacking_agree():
    cl = generate.random_cluster({"n_pods": 90, "n_policies": 12, "n_namespaces": 3,
                                  "p_ipblock_peer": 0.0}, 3)
    _, _, full = reference.solve_rows(cl, list(range(90)), compute_ports=True)
    _, _, some = reference.solve_rows(cl, [5, 80], compute_ports=True, col_block=7)
    assert torch.equal(some, full[[5, 80]])
    words = torch.zeros((2, 3), dtype=torch.int32)
    words[0, 0] = 1 << 3
    words[1, 2] = torch.tensor(-(1 << 31), dtype=torch.int32)
    bits = reference.unpack_words(words)
    assert bits[0, 3] and bits[1, 95] and int(bits.sum()) == 2
    assert reference.popcount(words) == 2
    want = torch.zeros((2, 90), dtype=torch.bool)
    want[0, 3] = True
    assert reference.compare_rows(words, want, 90) == (1, 1)  # bit 95 is past the pods
    assert torch.equal(reference.pack_rows(want, 3), torch.where(words < 0, 0, words))
    assert torch.equal(reference.pack_rows(reference.unpack_words(words), 3), words)
    assert reference.compare_rows(reference.pack_rows(full[[5, 80]], 3), full[[5, 80]], 90) == (0, 0)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("ports", [False, True])
def test_reference_agrees_with_the_ports_object_oracle(seed, ports):
    from kubernetes_verification_tpu_torch.backends.base import VerifyConfig
    from kubernetes_verification_tpu_torch.backends.cpu import CpuBackend

    from kvbench import adapter

    dep = {"n_pods": 60, "n_policies": 14, "n_namespaces": 3, "p_ipblock_peer": 0.0,
           "p_named_port": 0.3, "p_container_ports": 0.6, "min_selector_labels": seed % 2}
    cl = generate.random_cluster(dep, seed)
    want = CpuBackend().verify(adapter.cluster(cl), VerifyConfig(backend="cpu",
                                                                 compute_ports=ports))
    ii, ie, r = solve(cl, ports=ports, col_block=16)
    assert (r == want.reach).all()
    assert (ii == want.ingress_isolated).all() and (ie == want.egress_isolated).all()
