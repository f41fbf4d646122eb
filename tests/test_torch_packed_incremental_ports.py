"""The port's ``PackedPortsIncrementalVerifier`` (on the CPU) against the JAX
package's, on the same cluster and the same op sequence: after the build and
after every op the two ``state_dict()``s are equal — every array key for
key, dtype, shape and bytes, and the meta — and so is the reach (exact:
every array is boolean or integer). A failed diff leaves both states as they
were. States load across the two packages in both directions. The ops
mirror ``tests/test_packed_incremental_ports.py`` (its non-mesh tests), on
fewer distinct clusters: each new layout costs the JAX engine its compiles."""
import dataclasses
import random
import re

import numpy as np
import pytest
import torch

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.packed_incremental_ports import (
    PackedPortsIncrementalVerifier as JaxEngine,
)
from kubernetes_verification_tpu.packed_incremental_ports import (
    PortUniverseChanged as JaxUniverseChanged,
)
from kubernetes_verification_tpu_torch import packed_incremental_ports as pip
from kubernetes_verification_tpu_torch.ops.bits import pack_bool_cols
from kubernetes_verification_tpu_torch.resilience.errors import ServeError
from test_torch_packed_incremental import assert_same_state
from torch_parity import to_jax, words

_FLAGS = ("self_traffic", "default_allow_unselected", "direction_aware_isolation")


def _mk(seed=7, **kw):
    """The JAX test's generator settings: port specs, named ports and
    container ports on."""
    gen = dict(n_pods=57, n_policies=9, n_namespaces=3, p_ports=0.8,
               p_named_port=0.3, p_container_ports=0.5, seed=seed)
    return kvt.random_cluster(kvt.GeneratorConfig(**{**gen, **kw}))


class Twin:
    """The JAX engine and the port's engine (``device="cpu"``) built on one
    cluster; calling an op applies it to both and holds the states equal."""

    def __init__(self, c, flags=None, **kw):
        flags = dict(flags or {})
        self.cfg = kvt.VerifyConfig(compute_ports=True, **flags)
        self.j = JaxEngine(to_jax(c), jkv.VerifyConfig(compute_ports=True, **flags), **kw)
        self.p = kvt.PackedPortsIncrementalVerifier(c, self.cfg, device="cpu", **kw)
        self.check("build")

    def __call__(self, op, *args):
        want = getattr(self.j, op)(*to_jax(args))
        got = getattr(self.p, op)(*args)
        assert got == want, op
        self.check(op)
        return got

    def attempt(self, op, *args, match=None):
        """``op`` on both engines: both apply it, or both refuse it with
        ``PortUniverseChanged`` (matching ``match``) and leave the port's
        state byte-identical to before (and to JAX's). True if applied."""
        before = self.p.state_dict()
        try:
            want = getattr(self.j, op)(*to_jax(args))
        except JaxUniverseChanged as e:
            assert match is None or re.search(match, str(e)), e
            with pytest.raises(kvt.PortUniverseChanged, match=match):
                getattr(self.p, op)(*args)
            assert_states(before, self.p.state_dict(), f"failed {op}")
            self.check(f"failed {op}")
            return False
        assert getattr(self.p, op)(*args) == want, op
        self.check(op)
        return True

    def fails(self, match, op, *args):
        """``op`` must be refused by both engines (``attempt``)."""
        assert not self.attempt(op, *args, match=match), f"{op} did not raise"

    def check(self, label=""):
        assert_states(self.j.state_dict(), self.p.state_dict(), label)
        np.testing.assert_array_equal(self.p.reach, self.j.reach, err_msg=label)

    def oracle(self):
        """The port's reach over live pods == a one-shot dense solve of the
        live cluster with port bitmaps, on the CPU."""
        res = kvt.verify(self.p.as_cluster(), dataclasses.replace(
            self.cfg, backend_options=(("device", "cpu"),)))
        np.testing.assert_array_equal(self.p.reach_active(), res.reach)


def assert_states(want, got, label=""):
    """Two ``(arrays, meta)`` states: the arrays equal key for key, dtype,
    shape and bytes, and the meta equal."""
    assert_same_state(want[0], got[0], label)
    assert want[1] == got[1], label


def test_build_matches_jax_and_the_one_shot_solve():
    t = Twin(_mk())
    t.oracle()
    assert t.p.build_timings.keys() == {"encode", "maps", "kernel", "vectorizer"}
    assert t.p._layout.n_masks > 0  # a real port layout, not the full block alone


def test_kernel_route_equals_a_reach_block_sweep():
    """The build's one ``fused_ports_reach`` call (its plain version on the
    CPU) == ``_ports_reach_block`` over every column, the formula every diff
    patches with."""
    p = kvt.PackedPortsIncrementalVerifier(_mk(), kvt.VerifyConfig(), device="cpu")
    Np = p._n_padded
    ar = torch.arange(Np)
    r = pip._ports_reach_block(
        p._src, p._dst, p._layout, p._ing_cnt, p._eg_cnt, ar, ar, cols=ar,
        self_traffic=True, default_allow=True,
    )
    r &= (p._row_valid > 0)[:, None]
    want = pack_bool_cols(r) & p._col_mask[None, :]
    assert torch.equal(p._packed, want)
    assert p._packed.any()


def test_remove_add_update_sequence():
    c = _mk()
    t = Twin(c)
    pols = list(c.policies)
    t("remove_policy", pols[0].namespace, pols[0].name)
    t("add_policy", dataclasses.replace(pols[0], name="readd"))
    t("update_policy", dataclasses.replace(pols[1], ingress=pols[2].ingress))
    # a policy swapping to different KNOWN port specs stays in-universe
    donor = next(p for p in pols[3:] if any(r.ports for r in (p.ingress or ())))
    t("update_policy", dataclasses.replace(pols[2], ingress=donor.ingress))
    t.oracle()


def test_fuzzed_diff_sequence():
    t = Twin(_mk(), headroom=16)
    donor = _mk(seed=22, n_policies=18)
    added = []
    for i, p in enumerate(donor.policies[:8]):
        # donor policies reuse the generator's port library, so most masks
        # stay inside the frozen layout; a mask outside it is refused by both
        p2 = dataclasses.replace(p, name=f"fuzz-{i}")
        if not t.attempt("add_policy", p2):
            continue
        added.append(p2)
        if i % 3 == 1 and added:
            victim = added.pop(0)
            t("remove_policy", victim.namespace, victim.name)
    assert len(t.p.policies) > 9
    t.oracle()


@pytest.mark.parametrize("values", [(False, True, True), (True, False, True),
                                    (True, True, False)])
def test_flag_variants(values):
    c = _mk()
    t = Twin(c, dict(zip(_FLAGS, values)))
    t("update_policy", dataclasses.replace(c.policies[0], ingress=[]))
    t("remove_policy", c.policies[1].namespace, c.policies[1].name)
    t("update_pod_labels", 4, {"flag": "variant"})
    t.oracle()


def _named_cluster():
    pods = [
        kvt.Pod("web-a", "prod", {"app": "web"}, container_ports={"http": ("TCP", 8080)}),
        kvt.Pod("web-b", "prod", {"app": "web"}, container_ports={"http": ("TCP", 9090)}),
        kvt.Pod("client", "prod", {"app": "client"}),
    ]
    base = kvt.NetworkPolicy(
        "allow-http", namespace="prod", pod_selector=kvt.Selector({"app": "web"}),
        ingress=(kvt.Rule(
            peers=(kvt.Peer(pod_selector=kvt.Selector({"app": "client"})),),
            ports=(kvt.PortSpec("TCP", "http"),),
        ),),
    )
    return kvt.Cluster(pods=pods, policies=[base]), base


def test_named_port_diff_in_universe():
    """Diffs reusing (name, resolved-atom) restrictions already in the
    frozen bank patch exactly; a name never referenced is refused."""
    c, base = _named_cluster()
    t = Twin(c)
    assert t.p.reach[2, 0] and t.p.reach[2, 1]
    t("update_policy", dataclasses.replace(base, ingress=(kvt.Rule(
        peers=(kvt.Peer(pod_selector=kvt.Selector({"app": "nobody"})),),
        ports=(kvt.PortSpec("TCP", "http"),),
    ),)))
    assert not t.p.reach[2, 0] and not t.p.reach[2, 1]
    t.fails("never referenced", "update_policy", dataclasses.replace(base, ingress=(
        kvt.Rule(peers=(), ports=(kvt.PortSpec("TCP", "grpc"),)),)))
    t.oracle()


def test_pod_named_port_resolution_enforced():
    """An added pod whose container ports resolve a referenced name outside
    the frozen bank raises before any bookkeeping; one resolving inside the
    bank is gated per destination; one not declaring the name is
    unreachable through the rule."""
    c, _ = _named_cluster()
    t = Twin(c)
    assert t("add_pod", kvt.Pod("web-c", "prod", {"app": "web"},
                                container_ports={"http": ("TCP", 8080)})) == 3
    assert t.p.reach[2, 3]
    t.fails("restriction bank", "add_pod", kvt.Pod(
        "web-x", "prod", {"app": "web"}, container_ports={"http": ("TCP", 9999)}))
    assert "prod/web-x" not in t.p._pod_idx and t.p.n_pods == 4
    t("add_pod", kvt.Pod("web-d", "prod", {"app": "web"}))
    assert not t.p.reach[2, 4]
    t.oracle()


def test_new_port_mask_rejected():
    c = _mk()
    t = Twin(c)
    alien = kvt.NetworkPolicy(
        "alien-port", namespace=c.pods[0].namespace, pod_selector=kvt.Selector(),
        ingress=(kvt.Rule(peers=(), ports=(kvt.PortSpec("TCP", 12_345),)),),
    )
    t.fails("mask|atom", "add_policy", alien)
    t.oracle()


def _fill(t, c, rule):
    """Add filler policies carrying ``rule`` until a segment runs out of
    free rows (both engines refuse the same add); returns how many went."""
    for i in range(40):
        pol = kvt.NetworkPolicy(f"filler-{i}", namespace=c.pods[0].namespace,
                                pod_selector=kvt.Selector(), ingress=(rule,))
        if not t.attempt("add_policy", pol, match="free|headroom"):
            return i
    raise AssertionError("the fixture must exhaust a segment")


def test_headroom_exhaustion_raises():
    c = _mk(seed=31, n_policies=5)
    t = Twin(c, headroom=1)
    rule = next(r for p in c.policies for r in (p.ingress or ()) if r.ports)
    assert _fill(t, c, rule) < 40


def test_failed_update_leaves_state_intact():
    """A diff that raises mid-allocation (segment exhausted) must not free
    the policy's live rows."""
    c = _mk(seed=31, n_policies=5)
    t = Twin(c, headroom=1)
    rule = next(r for p in c.policies for r in (p.ingress or ()) if r.ports)
    added = _fill(t, c, rule)
    victim = next(p for p in c.policies
                  if not any(r.ports == rule.ports for r in (p.ingress or ())))
    t.fails("free|headroom", "update_policy", dataclasses.replace(victim, ingress=(rule,)))
    t("remove_policy", c.pods[0].namespace, f"filler-{added - 1}")
    t("remove_policy", victim.namespace, victim.name)
    t.oracle()


def test_relabel():
    t = Twin(_mk())
    t("update_pod_labels", 0, {"x": "y"})
    t("update_pod_labels", 5, dict(t.p.pods[11].labels))
    t.oracle()


def test_relabel_then_policy_diff_uses_dirty_fixup():
    t = Twin(_mk())
    t("update_pod_labels", 3, {"totally": "unseen", "fresh": "pair"})
    assert 3 in t.p._vectorizer.dirty
    t("add_policy", kvt.NetworkPolicy(
        name="sel-unseen", namespace=t.p.pods[3].namespace,
        pod_selector=kvt.Selector({"totally": "unseen"}),
        ingress=(kvt.Rule(peers=(kvt.Peer(pod_selector=kvt.Selector({"fresh": "pair"})),)),),
    ))
    assert t.p.packed_reach().ingress_isolated[3]
    t.oracle()


def test_pod_add_remove_and_slot_reuse():
    t = Twin(_mk())
    ns = t.p.pods[0].namespace
    assert t("add_pod", kvt.Pod("fresh", ns, {"app": "fresh"})) == 57
    victim = t.p.pods[9]
    assert t("remove_pod", victim.namespace, victim.name) == 9
    # container ports copied from a frozen pod: resolutions stay in the bank
    donor_ports = next(dict(p.container_ports) for p in t.p.pods if p.container_ports)
    assert t("add_pod", kvt.Pod("recycled", ns, {"app": "web"},
                                container_ports=donor_ports)) == 9
    with pytest.raises(KeyError):
        t.p.update_pod_labels(60, {"a": "b"})
    t.oracle()


def test_fuzzed_pod_and_policy_churn():
    """The JAX test's churn fuzz (``mesh_shape=None``), state held equal
    after every step and the port held against the one-shot solve, with its
    vacuity floor: enough steps must change the reach."""
    c = _mk(seed=41, n_pods=43)
    t = Twin(c, headroom=16, pod_headroom=8)
    donor = _mk(seed=42, n_policies=18)
    rng = random.Random(3)
    port_lib = [dict(p.container_ports) for p in c.pods] + [{}]
    changed_steps = 0
    prev = t.p.reach_active().copy()
    for step in range(18):
        op = rng.choice(["add", "rm", "relabel", "add_pol", "rm_pol", "relabel_ns"])
        if op == "add":
            t("add_pod", kvt.Pod(
                f"fz-{step}", rng.choice(t.p.namespaces).name,
                {"app": f"fz{step % 4}", "env": "prod"},
                container_ports=rng.choice(port_lib)))
        elif op == "rm" and t.p.n_active > 4:
            p = t.p.pods[rng.choice(list(t.p.active_indices()))]
            t("remove_pod", p.namespace, p.name)
        elif op == "relabel":
            t("update_pod_labels", int(rng.choice(list(t.p.active_indices()))),
              {"fz": f"v{step}", "env": "x"})
        elif op == "add_pol":
            # a donor mask outside this cluster's universe is refused: fine
            t.attempt("add_policy", dataclasses.replace(
                donor.policies[step % len(donor.policies)], name=f"fzp-{step}"))
        elif op == "rm_pol" and t.p.policies:
            t("remove_policy", *rng.choice(sorted(t.p.policies)).split("/", 1))
        elif op == "relabel_ns":
            tgt = rng.choice(t.p.namespaces)
            donor_ns = rng.choice(c.namespaces)
            t("update_namespace_labels", tgt.name,
              {**dict(donor_ns.labels), "fzns": f"s{step}"})
        t.oracle()
        cur = t.p.reach_active()
        if cur.shape != prev.shape or not np.array_equal(cur, prev):
            changed_steps += 1
        prev = cur.copy()
    assert changed_steps >= 5, f"fuzz went vacuous: {changed_steps}/18 steps changed reach"


def test_pod_headroom_growth():
    """Exhausting the pod headroom grows the pod axis in place, to JAX's Np."""
    c = _mk(seed=51, n_pods=120)
    t = Twin(c)
    assert t.p._n_padded == 128
    for i in range(12):  # 8 pad slots, then growth
        t("add_pod", kvt.Pod(f"grow-{i}", "ns-0", {"app": f"g{i}"}))
    assert t.p._n_padded == t.j._n_padded == 384 and t.p.n_active == 132
    t("update_policy", dataclasses.replace(c.policies[0], ingress=c.policies[1].ingress))
    t.oracle()


def test_namespace_relabel():
    c = _mk()
    t = Twin(c)
    ns = c.namespaces[0]
    for new in (dict(c.namespaces[1].labels), {"completely": "fresh"}, {}):
        t("update_namespace_labels", ns.name, new)
    # add_namespace with changed labels delegates to the relabel
    assert t("add_namespace", kvt.Namespace(ns.name, {"via": "add"})) is False
    with pytest.raises(KeyError):
        t.p.update_namespace_labels("no-such-ns", {"a": "b"})
    t.oracle()


def test_namespace_remove():
    c = _mk()
    t = Twin(c)
    ns = c.namespaces[2]
    with pytest.raises(ServeError, match="active pod"):
        t.p.remove_namespace(ns.name)
    for i in list(t.p.active_indices()):
        if t.p.pods[i].namespace == ns.name:
            t("remove_pod", ns.name, t.p.pods[i].name)
    for key in [k for k in list(t.p.policies) if k.split("/", 1)[0] == ns.name]:
        t("remove_policy", *key.split("/", 1))
    t("remove_namespace", ns.name)
    assert ns.name not in t.p._ns_labels
    t("add_namespace", kvt.Namespace("brand-new", {"tier": "new"}))
    t("add_pod", kvt.Pod("newcomer", "brand-new", {"app": "nc"}))
    t("update_namespace_labels", "brand-new", {"tier": "newer"})
    t.oracle()


def test_resume_after_pod_churn_across_packages():
    """A state written after pod churn (and with a held closure) loads in
    both packages; the resumed engines keep going in step, slot reuse and a
    policy diff against a relabeled pod included."""
    c = _mk()
    t = Twin(c)
    t("add_pod", kvt.Pod("ck-new", c.pods[0].namespace, {"ck": "v"}))
    victim = t.p.pods[11]
    t("remove_pod", victim.namespace, victim.name)
    t("update_pod_labels", 4, {"ck": "relabeled"})
    np.testing.assert_array_equal(words(t.p.closure_packed(tile=64)),
                                  words(t.j.closure_packed(tile=64)))
    t("update_pod_labels", 6, {"after": "closure"})
    manifest = t.p.as_cluster(include_inactive=True)
    jstate, pstate = t.j.state_dict(), t.p.state_dict()
    p2 = kvt.PackedPortsIncrementalVerifier.from_state(manifest, *jstate, t.cfg, device="cpu")
    j2 = JaxEngine.from_state(to_jax(manifest), *pstate, jkv.VerifyConfig(compute_ports=True))
    assert p2.n_active == t.p.n_active and not p2.pod_active[11]
    assert p2.build_timings.keys() == {"host", "upload", "vectorizer"}
    t.j, t.p = j2, p2
    t.check("resumed")
    # the resume marked the held closure's row 0 dirty, as JAX's prewarm does
    assert t.p._closure_dirty[0] and "closure_base" in pstate[0]
    assert t("add_pod", kvt.Pod("post-resume", c.pods[0].namespace, {"ck": "v2"})) == 11
    t("update_policy", dataclasses.replace(
        c.policies[0], pod_selector=kvt.Selector({"ck": "relabeled"})))
    np.testing.assert_array_equal(words(t.p.closure_packed(tile=64)),
                                  words(t.j.closure_packed(tile=64)))
    t.check("closure after resume")
    t.oracle()


def test_tombstone_row_stays_zero_after_a_policy_diff():
    c = _mk()
    t = Twin(c)
    victim = t.p.pods[2]
    t("remove_pod", victim.namespace, victim.name)
    t("update_policy", dataclasses.replace(c.policies[0], pod_selector=kvt.Selector()))
    full = t.p.reach
    assert not full[2].any() and not full[:, 2].any()
    t.oracle()


def test_tombstoned_pod_zero_stays_zero_across_a_resume():
    """Unlike the any-port engine's, the JAX ports engine's prewarm patches
    row 0 under the row-validity mask: both packages keep a tombstoned pod
    0 zero through a resume."""
    c = _mk()
    t = Twin(c)
    t("remove_pod", c.pods[0].namespace, c.pods[0].name)
    manifest = t.p.as_cluster(include_inactive=True)
    jstate, pstate = t.j.state_dict(), t.p.state_dict()
    t.p = kvt.PackedPortsIncrementalVerifier.from_state(manifest, *jstate, t.cfg, device="cpu")
    t.j = JaxEngine.from_state(to_jax(manifest), *pstate, jkv.VerifyConfig(compute_ports=True))
    t.check("resumed")
    assert_states(pstate, t.p.state_dict(), "round trip")
    raw = t.p.reach
    assert not raw[0].any() and not raw[:, 0].any()
