"""The port's ``PackedIncrementalVerifier`` (on the CPU) against the JAX
package's, on the same cluster and the same op sequence: after every op the
two ``state_dict()``s are equal key for key, dtype and bytes, and so is the
reach (exact: every array is boolean or integer). State dicts load across
the two packages in both directions."""
import dataclasses
import random

import numpy as np
import pytest
import torch

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.packed_incremental import (
    PackedIncrementalVerifier as JaxEngine,
)
from kubernetes_verification_tpu_torch.ops.bits import unpack_cols
from kubernetes_verification_tpu_torch.resilience.errors import ServeError
from torch_parity import to_jax, words

_FLAGS = ("self_traffic", "default_allow_unselected", "direction_aware_isolation")


def cluster(**gen):
    return kvt.random_cluster(kvt.GeneratorConfig(**gen))


def assert_same_state(want, got, label=""):
    """Two ``state_dict()``s: the same keys, and per key the same dtype,
    shape and bytes."""
    assert sorted(want) == sorted(got), label
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert (w.dtype, w.shape) == (g.dtype, g.shape), (label, k, w.dtype, g.dtype)
        assert w.tobytes() == g.tobytes(), (label, k)


class Twin:
    """The JAX engine and the port's engine (``device="cpu"``) built on one
    cluster; calling an op applies it to both and holds the states equal."""

    def __init__(self, c, flags=None, **kw):
        flags = dict(flags or {})
        self.cfg = kvt.VerifyConfig(compute_ports=False, **flags)
        self.j = JaxEngine(to_jax(c), jkv.VerifyConfig(compute_ports=False, **flags), **kw)
        self.p = kvt.PackedIncrementalVerifier(c, self.cfg, device="cpu", **kw)
        self.check("build")

    def __call__(self, op, *args):
        want = getattr(self.j, op)(*to_jax(args))
        got = getattr(self.p, op)(*args)
        assert got == want, op
        self.check(op)
        return got

    def check(self, label=""):
        assert_same_state(self.j.state_dict(), self.p.state_dict(), label)
        if self.p.keep_matrix:
            np.testing.assert_array_equal(self.p.reach, self.j.reach, err_msg=label)

    def oracle(self):
        """The port's reach over live pods == a one-shot dense solve of the
        live cluster (the JAX tests hold the JAX engine so)."""
        res = kvt.verify(self.p.as_cluster(), dataclasses.replace(
            self.cfg, backend_options=(("device", "cpu"),)))
        if self.p.keep_matrix:
            np.testing.assert_array_equal(self.p.reach_active(), res.reach)
            return
        act = self.p.active_indices()
        full = unpack_cols(self.p.solve_stripe(0, self.p._n_padded), self.p.n_pods)
        np.testing.assert_array_equal(full[np.ix_(act, act)], res.reach)


_SIZES = [
    dict(n_pods=57, n_policies=9, n_namespaces=3, seed=7),
    dict(n_pods=41, n_policies=7, n_namespaces=3, seed=21),
    dict(n_pods=33, n_policies=7, n_namespaces=2, seed=11),
    dict(n_pods=19, n_policies=0, n_namespaces=2, seed=41),
]


@pytest.mark.parametrize("gen", _SIZES, ids=lambda g: f"{g['n_pods']}x{g['n_policies']}")
def test_initial_build_matches_jax(gen):
    t = Twin(cluster(**gen))
    t.oracle()
    assert t.p.build_timings.keys() == {"encode", "maps", "kernel", "vectorizer"}


def test_remove_add_update_sequence():
    c = cluster(**_SIZES[0])
    t = Twin(c)
    pols = list(c.policies)
    t("remove_policy", pols[0].namespace, pols[0].name)
    t("add_policy", dataclasses.replace(pols[0], name="brand-new"))
    t("update_policy", dataclasses.replace(
        pols[1], ingress=list(pols[2].ingress or []), egress=list(pols[1].egress or [])))
    t.oracle()


def test_relabel_to_unseen_pairs_then_policy_uses_dirty_fixup():
    t = Twin(cluster(**_SIZES[0]))
    t("update_pod_labels", 3, {"totally": "unseen", "fresh": "pair"})
    assert 3 in t.p._vectorizer.dirty
    t("add_policy", kvt.NetworkPolicy(
        name="sel-unseen", namespace=t.p.pods[3].namespace,
        pod_selector=kvt.Selector({"totally": "unseen"}),
        ingress=(kvt.Rule(peers=(kvt.Peer(pod_selector=kvt.Selector({"fresh": "pair"})),)),),
    ))
    assert t.p.packed_reach().ingress_isolated[3]
    # in-vocab relabels re-index instead of dirtying
    t("update_pod_labels", 2, dict(t.p.pods[9].labels))
    assert 2 not in t.p._vectorizer.dirty
    t.oracle()


def test_fuzzed_policy_and_label_stream():
    c = cluster(**_SIZES[1])
    t = Twin(c)
    donor = cluster(n_pods=41, n_policies=24, n_namespaces=3, seed=22)
    rng = random.Random(0)
    for i, p in enumerate(donor.policies[:10]):
        t("add_policy", dataclasses.replace(p, name=f"fuzz-{i}"))
        if i % 3 == 0:
            ns, name = rng.choice(sorted(t.p.policies)).split("/", 1)
            t("remove_policy", ns, name)
        if i % 4 == 1:
            t("update_pod_labels", rng.randrange(41), {"app": f"x{i}", "env": "prod"})
    t.oracle()


@pytest.mark.parametrize("values", [(False, True, True), (True, False, True),
                                    (True, True, False), (False, False, False)])
def test_flag_variants(values):
    c = cluster(**_SIZES[2])
    t = Twin(c, dict(zip(_FLAGS, values)))
    t("update_policy", dataclasses.replace(c.policies[0], ingress=[]))
    t("remove_policy", c.policies[1].namespace, c.policies[1].name)
    t("update_pod_labels", 4, {"flag": "variant"})
    t.oracle()


def test_empty_policy_cluster_then_policies():
    t = Twin(cluster(**_SIZES[3]))
    for p in cluster(n_pods=19, n_policies=2, n_namespaces=2, seed=42).policies:
        t("add_policy", p)
    t.oracle()


def test_pod_add_remove_and_slot_reuse():
    c = cluster(**_SIZES[0])
    t = Twin(c)
    ns = c.pods[0].namespace
    assert t("add_pod", kvt.Pod("churn-a", ns, dict(c.pods[0].labels), ip="10.9.9.9")) == 57
    t("add_pod", kvt.Pod("churn-b", ns, {"never": "seen-pair"}))
    victim = t.p.pods[5]
    assert t("remove_pod", victim.namespace, victim.name) == 5
    raw = t.p.reach
    assert not raw[5].any() and not raw[:, 5].any()
    assert t("add_pod", kvt.Pod("recycled", victim.namespace, {"role": "fresh"})) == 5
    t("add_policy", kvt.NetworkPolicy(
        name="sel-fresh", namespace=victim.namespace,
        pod_selector=kvt.Selector({"role": "fresh"}), ingress=()))
    assert t.p.packed_reach().ingress_isolated[5]
    # a tombstone stays zero under a broad policy diff and a relabel
    victim = t.p.pods[4]
    t("remove_pod", victim.namespace, victim.name)
    t("add_policy", kvt.NetworkPolicy(
        name="broad", namespace=victim.namespace, pod_selector=kvt.Selector({}),
        ingress=(kvt.Rule(peers=()),)))
    t("update_pod_labels", 6, {"re": "label"})
    raw = t.p.reach
    assert not raw[4].any() and not raw[:, 4].any()
    with pytest.raises(KeyError):
        t.p.remove_pod(victim.namespace, victim.name)
    with pytest.raises(KeyError):
        t.p.update_pod_labels(4, {"a": "b"})
    t.oracle()


def test_failed_add_pod_leaves_no_state():
    c = cluster(**_SIZES[0])
    t = Twin(c)
    ns = c.pods[0].namespace
    t("add_policy", kvt.NetworkPolicy(
        "ip-pol", namespace=ns, pod_selector=kvt.Selector(),
        ingress=(kvt.Rule(peers=(kvt.Peer(ip_block=kvt.IpBlock("10.0.0.0/8")),)),)))
    with pytest.raises(ValueError):
        t.p.add_pod(kvt.Pod("badip", ns, {"a": "b"}, ip="not-an-ip"))
    assert t.p.n_pods == 57 and f"{ns}/badip" not in t.p._pod_idx
    t("add_pod", kvt.Pod("goodip", ns, {"a": "b"}, ip="10.1.2.3"))
    t.oracle()


@pytest.mark.parametrize("growth", ["slots", "pods"])
def test_growth(growth):
    if growth == "slots":  # capacity 12 at slot_round 4, grown by 4 once
        c = cluster(n_pods=23, n_policies=2, n_namespaces=2, seed=81)
        t = Twin(c, slot_round=4)
        for i, p in enumerate(cluster(n_pods=23, n_policies=14, n_namespaces=2,
                                      seed=82).policies):
            t("add_policy", dataclasses.replace(p, name=f"grow-{i}"))
        assert t.p._capacity == 16 and len(t.p.policies) == 16
    else:  # 120 pods pad to 128: the ninth add grows the pod axis
        c = cluster(n_pods=120, n_policies=5, n_namespaces=2, seed=55)
        t = Twin(c)
        for i in range(12):
            t("add_pod", kvt.Pod(f"grow-{i}", "ns-0", {"app": f"g{i}"}))
        assert t.p._n_padded == 640 and t.p.n_active == 132
    t.oracle()


def test_namespace_add_relabel_remove():
    c = cluster(**_SIZES[0])
    t = Twin(c)
    ns = c.namespaces[0]
    for new in (dict(c.namespaces[1].labels), {"completely": "fresh", "tier": "x"}, {}):
        t("update_namespace_labels", ns.name, new)
    assert t("add_namespace", kvt.Namespace(ns.name, {"via": "add"})) is False
    assert t.p._ns_labels[ns.name] == {"via": "add"}
    t("add_policy", kvt.NetworkPolicy(
        name="ns-sel-new", namespace=c.namespaces[1].name, pod_selector=kvt.Selector({}),
        ingress=(kvt.Rule(peers=(kvt.Peer(namespace_selector=kvt.Selector({"via": "add"})),)),)))
    t("update_namespace_labels", ns.name, {"team": "other"})
    with pytest.raises(KeyError):
        t.p.update_namespace_labels("no-such-ns", {"a": "b"})
    gone = c.namespaces[2].name
    with pytest.raises(ServeError, match="active pod"):
        t.p.remove_namespace(gone)
    for i in list(t.p.active_indices()):
        if t.p.pods[i].namespace == gone:
            t("remove_pod", gone, t.p.pods[i].name)
    keys = [k for k in t.p.policies if k.split("/", 1)[0] == gone]
    if keys:
        with pytest.raises(ValueError, match="polic"):
            t.p.remove_namespace(gone)
        for key in keys:
            t("remove_policy", *key.split("/", 1))
    t("remove_namespace", gone)
    assert gone not in t.p._ns_labels
    with pytest.raises(KeyError):
        t.p.remove_namespace(gone)
    assert t("add_namespace", kvt.Namespace(gone, {"re": "born"})) is True
    t("add_pod", kvt.Pod("reborn", gone, {"app": "rb"}))
    t("add_namespace", kvt.Namespace("brand-new-ns", {"tier": "new"}))
    t("add_pod", kvt.Pod("newcomer", "brand-new-ns", {"app": "nc"}))
    t("update_namespace_labels", "brand-new-ns", {"tier": "newer"})
    t.oracle()


def test_closure_packed_before_and_after_diffs():
    c = cluster(**_SIZES[0])
    t = Twin(c)
    np.testing.assert_array_equal(words(t.p.closure_packed(tile=64)),
                                  words(t.j.closure_packed(tile=64)))
    t("update_pod_labels", 8, {"moved": "away"})  # removals: the suspect route
    victim = t.p.pods[11]
    t("remove_pod", victim.namespace, victim.name)
    closed = t.p.closure_packed(tile=64)
    np.testing.assert_array_equal(words(closed), words(t.j.closure_packed(tile=64)))
    assert torch.equal(closed, kvt.packed_closure(t.p._packed.clone(), tile=64))
    t.check("closure")  # closure, closure_dirty and closure_base travel too
    t("add_policy", kvt.NetworkPolicy(  # additions only: prev_base's route
        name="open", namespace=c.pods[0].namespace, pod_selector=kvt.Selector({}),
        ingress=(kvt.Rule(peers=()),), egress=(kvt.Rule(peers=()),),
        policy_types=("Ingress", "Egress")))
    np.testing.assert_array_equal(words(t.p.closure_packed(tile=64)),
                                  words(t.j.closure_packed(tile=64)))
    t.check("closure after additions")


def test_matrix_free_stripes_and_rows():
    c = cluster(n_pods=61, n_policies=9, n_namespaces=3, seed=63)
    t = Twin(c, keep_matrix=False)
    with pytest.raises(ServeError, match="keep_matrix"):
        t.p.packed_reach()
    pols = list(c.policies)
    t("update_policy", dataclasses.replace(pols[1], ingress=pols[2].ingress))
    t("remove_policy", pols[3].namespace, pols[3].name)
    t("add_pod", kvt.Pod("mf-new", c.pods[0].namespace, {"m": "1"}))
    t("remove_pod", c.pods[9].namespace, c.pods[9].name)
    t("update_namespace_labels", c.namespaces[0].name, {"mf": "relabel"})
    assert t.p.dirty_rows.any() and t.p.dirty_cols.any()
    full = t.p.solve_stripe(0, t.p._n_padded)
    np.testing.assert_array_equal(full, t.j.solve_stripe(0, t.j._n_padded))
    assert full.dtype == np.uint32
    bits = unpack_cols(full, t.p.n_pods)
    assert not bits[9].any() and not bits[:, 9].any()
    act = t.p.active_indices()
    res = kvt.verify(t.p.as_cluster(), kvt.VerifyConfig(
        compute_ports=False, backend_options=(("device", "cpu"),)))
    np.testing.assert_array_equal(bits[np.ix_(act, act)], res.reach)
    np.testing.assert_array_equal(t.p.solve_stripe(32, 32), t.j.solve_stripe(32, 32))
    rows = [0, 9, 60, 61, 5, 5]
    np.testing.assert_array_equal(t.p.solve_rows(rows), t.j.solve_rows(rows))
    assert t.p.solve_rows([]).shape == (0, 4)
    for bad in ((-32, 32), (0, 48), (96, 64)):
        with pytest.raises(ValueError):
            t.p.solve_stripe(*bad)
    with pytest.raises(ValueError):
        t.p.solve_rows([62])
    stripes = t.p.dirty_stripes(32)
    assert stripes == t.j.dirty_stripes(32) and stripes
    got = list(t.p.sweep_dirty(32))
    want = list(t.j.sweep_dirty(32))
    assert [d for d, _ in got] == [d for d, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert t.p.dirty_stripes(32) == []
    t.check("swept")


@pytest.mark.parametrize("keep_matrix", [True, False])
def test_state_dicts_load_across_packages(keep_matrix):
    c = cluster(n_pods=47, n_policies=9, n_namespaces=3, seed=71)
    t = Twin(c, keep_matrix=keep_matrix)
    pols = list(c.policies)
    t("update_pod_labels", 5, {"totally": "new"})
    t("update_policy", dataclasses.replace(pols[1], ingress=pols[2].ingress))
    t("add_pod", kvt.Pod("ck-new", c.pods[0].namespace, {"ck": "v"}))
    t("remove_pod", c.pods[11].namespace, c.pods[11].name)
    if keep_matrix:
        t.p.closure_packed(tile=64)
        t.j.closure_packed(tile=64)
        t("update_pod_labels", 7, {"after": "closure"})
    manifest = t.p.as_cluster(include_inactive=True)
    jstate, pstate = t.j.state_dict(), t.p.state_dict()
    # JAX's state into the port, the port's into JAX
    p2 = kvt.PackedIncrementalVerifier.from_state(manifest, jstate, t.cfg, device="cpu")
    j2 = JaxEngine.from_state(to_jax(manifest), pstate,
                              jkv.VerifyConfig(compute_ports=False))
    assert_same_state(jstate, p2.state_dict(), "jax -> port")
    assert_same_state(pstate, j2.state_dict(), "port -> jax")
    # both resumed engines keep going in step
    t.j, t.p = j2, p2
    t("add_policy", kvt.NetworkPolicy(
        "post-resume", namespace=c.pods[5].namespace,
        pod_selector=kvt.Selector({"totally": "new"}), ingress=()))
    t("remove_policy", pols[0].namespace, pols[0].name)
    assert t("add_pod", kvt.Pod("post-ck", "ns-0", {"p": "c"})) == 11
    if keep_matrix:
        np.testing.assert_array_equal(words(t.p.closure_packed(tile=64)),
                                      words(t.j.closure_packed(tile=64)))
        # a matrix-full state resumes matrix-free and re-verifies by stripes
        mf = kvt.PackedIncrementalVerifier.from_state(
            manifest, pstate, t.cfg, device="cpu", keep_matrix=False)
        assert mf._packed is None
        n = mf.n_pods
        np.testing.assert_array_equal(
            unpack_cols(mf.solve_stripe(0, mf._n_padded), n),
            unpack_cols(pstate["packed"][:n], n))
    else:
        with pytest.raises(ValueError, match="matrix-free"):
            kvt.PackedIncrementalVerifier.from_state(
                manifest, pstate, t.cfg, device="cpu", keep_matrix=True)
    t.oracle()


def test_state_dicts_load_across_packages_with_zero_free_slots():
    """A checkpoint saved with every slot taken (growth happens on the next
    allocation) resumes in either package with the slot axis grown, as the
    JAX engine's prewarm grows it."""
    c = cluster(n_pods=23, n_policies=2, n_namespaces=2, seed=81)
    t = Twin(c, slot_round=4)
    donor = cluster(n_pods=23, n_policies=12, n_namespaces=2, seed=82)
    for i, p in enumerate(donor.policies[:10]):
        t("add_policy", dataclasses.replace(p, name=f"fill-{i}"))
    assert not t.p._free and t.p._capacity == 12
    manifest = t.p.as_cluster(include_inactive=True)
    p2 = kvt.PackedIncrementalVerifier.from_state(manifest, t.j.state_dict(), t.cfg,
                                                  device="cpu")
    j2 = JaxEngine.from_state(to_jax(manifest), t.p.state_dict(),
                              jkv.VerifyConfig(compute_ports=False))
    assert p2._capacity == j2._capacity == 16
    assert_same_state(j2.state_dict(), p2.state_dict(), "resumed")
    t.j, t.p = j2, p2
    t("add_policy", dataclasses.replace(donor.policies[0], name="after"))
    t.oracle()


def test_tombstoned_pod_zero_stays_zero_across_a_resume():
    """The port keeps a tombstoned row zero through ``from_state``. (The JAX
    engine's prewarm re-solves row 0 on every resume and pod-axis growth,
    so a tombstoned pod 0 gains default-allow bits there — ROADMAP §3.)"""
    c = cluster(n_pods=120, n_policies=5, n_namespaces=2, seed=55)
    inc = kvt.PackedIncrementalVerifier(c, kvt.VerifyConfig(compute_ports=False),
                                        device="cpu")
    inc.remove_pod(c.pods[0].namespace, c.pods[0].name)
    res = kvt.PackedIncrementalVerifier.from_state(
        inc.as_cluster(include_inactive=True), inc.state_dict(),
        kvt.VerifyConfig(compute_ports=False), device="cpu")
    raw = res.reach
    assert not raw[0].any() and not raw[:, 0].any()
    assert_same_state(inc.state_dict(), res.state_dict())


@pytest.mark.parametrize("keep_matrix", [True, False])
def test_fuzzed_mixed_stream_with_resumes(keep_matrix):
    """A seeded stream of policy ops, pod adds, removes and relabels,
    namespace relabels, ``closure_packed`` and resumes across the packages
    (both directions at once), held byte for byte against the JAX engine
    after every op. Pod 0 is never removed: the JAX engine's resume
    re-solves row 0 without the row-validity mask (ROADMAP §3), so a
    tombstoned pod 0 would differ there by design."""
    c = cluster(**_SIZES[0])
    t = Twin(c, keep_matrix=keep_matrix)
    donor = cluster(n_pods=57, n_policies=24, n_namespaces=3, seed=8)
    rng = random.Random(keep_matrix)
    kinds = ["add_pol", "upd_pol", "rm_pol", "add_pod", "rm_pod", "relabel",
             "relabel_ns", "resume"] + ["closure"] * keep_matrix
    resumes = 0
    for step in range(30):
        op = rng.choice(kinds)
        pols = sorted(t.p.policies)
        if op == "add_pol":
            t("add_policy", dataclasses.replace(donor.policies[step % 24], name=f"mx-{step}"))
        elif op == "upd_pol" and pols:
            ns, name = rng.choice(pols).split("/", 1)
            src = donor.policies[rng.randrange(24)]
            t("update_policy", dataclasses.replace(
                t.p.policies[f"{ns}/{name}"], ingress=src.ingress, egress=src.egress))
        elif op == "rm_pol" and pols:
            t("remove_policy", *rng.choice(pols).split("/", 1))
        elif op == "add_pod":
            t("add_pod", kvt.Pod(f"mx-pod-{step}", rng.choice(t.p.namespaces).name,
                                 dict(rng.choice(c.pods).labels)))
        elif op == "rm_pod" and t.p.n_active > 8:
            i = rng.choice([int(i) for i in t.p.active_indices() if i])
            t("remove_pod", t.p.pods[i].namespace, t.p.pods[i].name)
        elif op == "relabel":
            i = int(rng.choice(list(t.p.active_indices())))
            labels = dict(rng.choice(c.pods).labels) if step % 2 else {"mx": f"v{step}"}
            t("update_pod_labels", i, labels)
        elif op == "relabel_ns":
            ns = rng.choice(t.p.namespaces).name
            t("update_namespace_labels", ns, {**dict(rng.choice(c.namespaces).labels),
                                             "mx": f"s{step}"})
        elif op == "closure":
            np.testing.assert_array_equal(words(t.p.closure_packed(tile=64)),
                                          words(t.j.closure_packed(tile=64)))
            t.check("closure")
        elif op == "resume":  # each package from the other's state
            assert t.p.pod_active[0]
            manifest = t.p.as_cluster(include_inactive=True)
            jstate, pstate = t.j.state_dict(), t.p.state_dict()
            t.p = kvt.PackedIncrementalVerifier.from_state(
                manifest, jstate, t.cfg, device="cpu")
            t.j = JaxEngine.from_state(to_jax(manifest), pstate,
                                       jkv.VerifyConfig(compute_ports=False))
            resumes += 1
            t.check("resume")
    assert resumes >= 2
    t.oracle()
