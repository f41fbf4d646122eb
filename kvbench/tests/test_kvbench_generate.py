"""The frozen generator: deterministic per seed, the same scenario as the
port's own generator, and churn that stays valid with the same mix of work
for every seed."""
import pytest

from kvbench import adapter, generate, reference

DEP = {"n_pods": 150, "n_policies": 25, "n_namespaces": 4, "p_ipblock_peer": 0.0,
       "min_selector_labels": 1}
MIX = {"shares": {"pod_relabel": 40, "policy_add": 15, "policy_update": 15,
                  "policy_remove": 10},
       "doubled": 10, "removed_again": 3}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_same_seed_same_inputs(seed):
    assert generate.random_cluster(DEP, seed) == generate.random_cluster(DEP, seed)
    c = generate.random_cluster(DEP, seed)
    assert generate.verify_edits(c, DEP, f"{seed}:e", 5) == generate.verify_edits(c, DEP, f"{seed}:e", 5)
    assert generate.churn_changes(c, DEP, seed, MIX, 50) == generate.churn_changes(c, DEP, seed, MIX, 50)
    assert generate.random_cluster(DEP, seed) != generate.random_cluster(DEP, seed + 1)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_frozen_copy_draws_the_ports_generator_scenario(seed):
    from kubernetes_verification_tpu_torch.harness.generate import (
        GeneratorConfig,
        random_cluster,
    )

    dep = {**DEP, "p_ipblock_peer": 0.2, "p_named_port": 0.3}
    ours = adapter.cluster(generate.random_cluster(dep, seed))
    theirs = random_cluster(GeneratorConfig(**dep, seed=seed))
    assert ours.pods == theirs.pods
    assert ours.namespaces == theirs.namespaces
    assert ours.policies == theirs.policies


def test_fixed_port_library_is_what_rules_draw_from():
    lib = [{"protocol": "TCP", "port": 80, "end_port": None},
           {"protocol": "UDP", "port": 53, "end_port": None}]
    c = generate.random_cluster({**DEP, "p_named_port": 0.0, "port_library": lib}, 1)
    used = [s for p in c["policies"] for d in ("ingress", "egress")
            for r in p[d] or () for s in r["ports"] or ()]
    assert used and all(s in lib for s in used)


@pytest.mark.parametrize("seed", [1, 2])
def test_churn_blocks_hold_every_kind_its_share(seed):
    c = generate.random_cluster(DEP, 2)
    # a block of 80 draws: 40 relabels (10 of them twice), 15 adds (3 removed
    # at once), 15 updates, 10 removes
    ch = generate.churn_changes(c, DEP, seed, MIX, 3 * 93)
    for b in range(3):
        block = ch[93 * b : 93 * (b + 1)]
        counts = {}
        for x in block:
            counts[x["op"]] = counts.get(x["op"], 0) + 1
        assert counts == {"pod_relabel": 50, "policy_add": 15, "policy_update": 15,
                          "policy_remove": 13}


def test_churn_is_valid_in_order_and_touches_no_namespace():
    c = generate.random_cluster(DEP, 4)
    ch = generate.churn_changes(c, DEP, 9, MIX, 600)
    assert {x["op"] for x in ch} == set(MIX["shares"])
    assert reference.evolve(c, ch)["namespaces"] == c["namespaces"]  # raises if invalid
    with pytest.raises(ValueError):
        generate.churn_changes(c, DEP, 9, {**MIX, "shares": {"namespace_relabel": 12}}, 10)


def test_ported_churn_policies_draw_from_the_library_only():
    lib = [{"protocol": "TCP", "port": 80, "end_port": None},
           {"protocol": "TCP", "port": 8000, "end_port": 8999}]
    dep = {**DEP, "port_library": lib}
    c = generate.random_cluster(dep, 3)
    ch = generate.churn_changes(c, dep, 3, {**MIX, "policy_ports": True}, 300)
    specs = [s for x in ch if "policy" in x for d in ("ingress", "egress")
             for r in x["policy"][d] or () for s in r["ports"] or ()]
    assert specs and all(s in lib for s in specs)
    with pytest.raises(ValueError):
        generate.churn_changes(c, DEP, 3, {**MIX, "policy_ports": True}, 10)


def test_snapshot_replaces_one_policy_and_keeps_the_base():
    c = generate.random_cluster(DEP, 5)
    e = generate.verify_edits(c, DEP, "5:e", 1)[0]
    s = generate.snapshot(c, e)
    assert s["policies"][e["index"]] is e["policy"]
    assert c["policies"][e["index"]] is not e["policy"]
    assert sum(a is not b for a, b in zip(s["policies"], c["policies"])) == 1


def test_churn_loop_builds_engine_calls_for_every_kind():
    from kvbench.run import by_name

    change_call = by_name("loops", "churn").change_call
    c = generate.random_cluster(DEP, 6)
    calls = []

    class Engine:
        def __getattr__(self, name):
            return lambda *a: calls.append(name)

    for x in generate.churn_changes(c, DEP, 6, MIX, 200):
        change_call(x)(Engine())
    assert set(calls) == {"update_pod_labels", "add_policy", "update_policy",
                          "remove_policy"}
