"""The query twins (``ops/batched.py``: packed, dense and stripe), the device
query state (``ops/device_state.py``: packed and dense) and the
tombstone-aware ``PackedReach`` of the port, on the CPU, against the JAX
package's on the same engines' states (exact: every output is boolean or
integer words)."""
import dataclasses

import numpy as np
import pytest
import torch

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.ops import batched as jax_batched
from kubernetes_verification_tpu.ops.tiled import PackedReach as JaxPackedReach
from kubernetes_verification_tpu.packed_incremental import (
    PackedIncrementalVerifier as JaxEngine,
)
from kubernetes_verification_tpu_torch.ops import batched
from kubernetes_verification_tpu_torch.ops.bits import to_host_words, unpack_cols
from kubernetes_verification_tpu_torch.ops.device_state import (
    DeviceQueryState,
    DeviceStateCache,
    dense_query_state,
    packed_query_state,
)
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError, ServeError
from torch_parity import to_jax

_CFG = dict(compute_ports=False)


def _engines(n_pods, seed, **kw):
    c = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=n_pods, n_policies=16 if n_pods <= 64 else 24, n_namespaces=5,
        seed=seed, p_ipblock_peer=0.0, min_selector_labels=1))
    port = kvt.PackedIncrementalVerifier(c, kvt.VerifyConfig(**_CFG), device="cpu", **kw)
    jax_ = JaxEngine(to_jax(c), jkv.VerifyConfig(**_CFG), **kw)
    return c, port, jax_


def _state(engine):
    return (*engine._maps, engine._col_mask, engine._row_valid)


@pytest.mark.parametrize("n_pods", [33, 1000])
def test_packed_twins_match_jax_at_ragged_n(n_pods):
    c, port, jax_ = _engines(n_pods, n_pods)
    rng = np.random.default_rng(n_pods)
    for step in range(2):
        src = np.unique(rng.integers(0, n_pods, 9))
        q_row = rng.integers(0, len(src), 64)
        q_dst = rng.integers(0, n_pods, 64)
        dst = np.array([0, n_pods // 2, n_pods - 1, 5, 5])
        flags = dict(self_traffic=True, default_allow=True)
        got = batched.packed_reach_rows(*_state(port), src, **flags)
        want = jax_batched.packed_reach_rows(*_state(jax_), src, **flags)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        got = batched.packed_reach_cols(*_state(port), dst, n=port.n_pods, **flags)
        want = jax_batched.packed_reach_cols(*_state(jax_), dst, n=jax_.n_pods, **flags)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, port.reach[:, dst])
        gw, ga = batched.packed_any_port(*_state(port), src, q_row, q_dst, **flags)
        ww, wa = jax_batched.packed_any_port(*_state(jax_), src, q_row, q_dst, **flags)
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(ga, port.reach[src[q_row], q_dst])
        # the empty batches short-circuit to the JAX shapes
        for g, w in ((batched.packed_reach_rows(*_state(port), [], **flags),
                      jax_batched.packed_reach_rows(*_state(jax_), [], **flags)),
                     (batched.packed_reach_cols(*_state(port), [], n=port.n_pods, **flags),
                      jax_batched.packed_reach_cols(*_state(jax_), [], n=jax_.n_pods, **flags))):
            assert (g.shape, g.dtype) == (w.shape, w.dtype)
        # churn both engines: a new generation of the same state
        for e, mk in ((port, kvt.Pod), (jax_, jkv.Pod)):
            victim = e.pods[3 + step]
            e.remove_pod(victim.namespace, victim.name)
            e.add_pod(mk(f"new-{step}", victim.namespace, {"app": "new"}))
            e.update_policy(dataclasses.replace(
                e.policies[sorted(e.policies)[step]], ingress=()))


def test_device_state_cache_publish_get_retire_clear():
    _, port, _ = _engines(33, 5)
    cache = DeviceStateCache()
    assert cache.get(0) is None and cache.peek() is None and cache.retired() is None
    s0 = cache.publish(packed_query_state(port, 0, with_reach_words=True))
    assert cache.get(0) is s0 and cache.get(1) is None and cache.retired() is None
    s1 = cache.publish(packed_query_state(port, 1, with_reach_words=True))
    assert cache.get(1) is s1 and cache.retired() is s0
    assert "reach_words" in s0.arrays  # parked in the retired slot, alive
    s2 = cache.publish(packed_query_state(port, 2))
    assert cache.retired() is s1 and "reach_words" not in s0.arrays  # aged out
    assert s0.arrays["sel_ing8"] is port._sel_ing8  # aliases are never dropped
    s0.release()  # a second release is harmless
    cache.clear()
    assert cache.peek() is None and cache.retired() is None
    assert "reach_words" not in s1.arrays and s2.owned == ()


def test_packed_query_state_aliases_maps_and_owns_a_words_copy():
    _, port, _ = _engines(33, 6)
    plain = packed_query_state(port, 7)
    assert isinstance(plain, DeviceQueryState) and plain.kind == "packed"
    assert plain.owned == () and "reach_words" not in plain.arrays
    assert plain.n == 33 and plain.meta["n_padded"] == 128
    assert plain.meta["flags"] == dict(self_traffic=True, default_allow=True)
    for name, t in zip(("sel_ing8", "sel_eg8", "ing_by_pol", "eg_by_pol",
                        "ing_cnt", "eg_cnt"), port._maps):
        assert plain.arrays[name] is t
    snap = packed_query_state(port, 7, with_reach_words=True)
    before = port._packed.clone()
    assert torch.equal(snap.arrays["reach_words"], before)
    assert snap.arrays["reach_words"].data_ptr() != port._packed.data_ptr()
    victim = port.pods[2]
    port.remove_pod(victim.namespace, victim.name)  # an in-place diff
    assert not torch.equal(port._packed, before)
    assert torch.equal(snap.arrays["reach_words"], before)  # the copy survives
    # the aliased operands follow the engine: valid for their generation only
    assert plain.arrays["row_valid"][2] == 0
    _, mf, _ = _engines(33, 6, keep_matrix=False)
    with pytest.raises(ServeError, match="matrix-free"):
        packed_query_state(mf, 0, with_reach_words=True)
    assert packed_query_state(mf, 0).owned == ()


@pytest.mark.parametrize("on_device", [False, True])
def test_packed_reach_active_matches_jax(on_device):
    c, port, jax_ = _engines(24, 71)
    for e in (port, jax_):
        e.remove_pod(e.pods[5].namespace, e.pods[5].name)
        e.remove_pod(e.pods[17].namespace, e.pods[17].name)
    got, want = port.packed_reach(), jax_.packed_reach()
    if not on_device:  # the port's host form: the reference's uint32 words
        got = dataclasses.replace(got, packed=to_host_words(got.packed))
    assert isinstance(got.packed, torch.Tensor) == on_device
    np.testing.assert_array_equal(got.active, want.active)
    assert got.all_reachable() == want.all_reachable()
    assert got.all_isolated() == want.all_isolated()
    assert 5 not in got.all_isolated() and 17 not in got.all_isolated()
    for idx in (0, 6, 23):
        assert got.system_isolation(idx) == want.system_isolation(idx)
    with pytest.raises(ConfigError, match="tombstoned"):
        got.system_isolation(5)
    live = port.as_cluster().pods
    jlive = jax_.as_cluster().pods
    slots = [p if a else dataclasses.replace(p, labels={})
             for p, a in zip(port.pods, port.pod_active)]
    for label in ("app", "team", "no-such-label"):
        assert got.user_crosscheck(live, label) == want.user_crosscheck(jlive, label)
        assert got.user_crosscheck(slots, label) == got.user_crosscheck(live, label)
    with pytest.raises(ConfigError, match="pods"):
        got.user_crosscheck(live[:-1], "app")
    # a churn-free matrix: active is None, as in the JAX package
    _, port2, jax2 = _engines(24, 72)
    assert port2.packed_reach().active is None and jax2.packed_reach().active is None
    # a JAX PackedReach built by hand with active= answers the same
    hand = JaxPackedReach(packed=np.asarray(jax_.packed_reach().packed), n_pods=24,
                          ingress_isolated=want.ingress_isolated,
                          egress_isolated=want.egress_isolated, active=want.active)
    assert got.all_reachable() == hand.all_reachable()


# ------------------------------------------------------- dense and stripe twins

_DENSE_FLAGS = [
    dict(self_traffic=True, default_allow_unselected=True),
    dict(self_traffic=False, default_allow_unselected=True),
    dict(self_traffic=True, default_allow_unselected=False),
]


def _dense_engines(n_pods, seed):
    from kubernetes_verification_tpu.incremental import IncrementalVerifier as JaxDense

    c = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=n_pods, n_policies=12, n_namespaces=4, seed=seed,
        p_ipblock_peer=0.0, min_selector_labels=1))
    port = kvt.IncrementalVerifier(c, kvt.VerifyConfig(**_CFG), device="cpu")
    jax_ = JaxDense(to_jax(c), jkv.VerifyConfig(**_CFG))
    return port, jax_


def _dense_state(engine):
    return engine._ing_count, engine._eg_count, engine._ing_iso, engine._eg_iso


@pytest.mark.parametrize("flags", _DENSE_FLAGS, ids=lambda f: "-".join(
    k for k, v in f.items() if v))
def test_dense_twins_match_jax(flags):
    port, jax_ = _dense_engines(53, 41)
    rng = np.random.default_rng(41)
    n = 53
    # a ragged batch (not a power of two), with repeats in the probes
    src = np.unique(rng.integers(0, n, 11))
    dst = np.array([0, n // 2, n - 1, 5, 5, 17, 33])
    q_row = rng.integers(0, len(src), 37)
    q_dst = rng.integers(0, n, 37)
    calls = (
        ("batched_reach_rows", (src,)),
        ("batched_reach_cols", (dst,)),
        ("batched_any_port", (src, q_row, q_dst)),
        ("batched_reach_rows", ([],)),
        ("batched_reach_cols", ([],)),
        ("batched_any_port", ([], [], [])),
    )
    for name, args in calls:
        got = getattr(batched, name)(*_dense_state(port), *args, **flags)
        want = getattr(jax_batched, name)(*_dense_state(jax_), *args, **flags)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for g, w in zip(got, want):
            assert (g.shape, g.dtype) == (w.shape, w.dtype), name
            np.testing.assert_array_equal(g, w, err_msg=name)
    if flags["self_traffic"] and flags["default_allow_unselected"]:  # the engine's flags
        rows = batched.batched_reach_rows(*_dense_state(port), src, **flags)
        np.testing.assert_array_equal(rows, port.reach[src])
        cols = batched.batched_reach_cols(*_dense_state(port), dst, **flags)
        np.testing.assert_array_equal(cols, port.reach[:, dst])


@pytest.mark.parametrize("flags", _DENSE_FLAGS, ids=lambda f: "-".join(
    k for k, v in f.items() if v))
def test_stripe_twins_match_jax_and_reassemble_the_dense_answers(flags):
    port, jax_ = _dense_engines(53, 43)
    rng = np.random.default_rng(43)
    n = 53
    bounds = [(0, 16), (16, 32), (32, 48), (48, 53)]  # the last stripe ragged
    dst = np.array([0, 7, 52, 16, 16, 31])
    ing, eg, ing_iso, eg_iso = _dense_state(port)
    jing, jeg, jing_iso, jeg_iso = _dense_state(jax_)
    frags = []
    for lo, hi in bounds:
        loc = np.unique(rng.integers(0, hi - lo, 5))
        q_row = rng.integers(0, len(loc), 9)
        q_dst = rng.integers(0, n, 9)
        kw = dict(row_base=lo, **flags)
        for name, args in (("stripe_reach_rows", (loc,)),
                           ("stripe_reach_cols", (dst,)),
                           ("stripe_any_port", (loc, q_row, q_dst)),
                           ("stripe_reach_rows", ([],)),
                           ("stripe_reach_cols", ([],)),
                           ("stripe_any_port", ([], [], []))):
            got = getattr(batched, name)(ing[lo:hi], eg[lo:hi], ing_iso, eg_iso[lo:hi],
                                         *args, **kw)
            want = getattr(jax_batched, name)(jing[lo:hi], jeg[lo:hi], jing_iso,
                                              jeg_iso[lo:hi], *args, **kw)
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            for g, w in zip(got, want):
                assert (g.shape, g.dtype) == (w.shape, w.dtype), (name, lo)
                np.testing.assert_array_equal(g, w, err_msg=f"{name} stripe {lo}")
        # each stripe's rows equal the dense twin's at the global rows
        rows = batched.stripe_reach_rows(ing[lo:hi], eg[lo:hi], ing_iso, eg_iso[lo:hi],
                                         loc, **kw)
        np.testing.assert_array_equal(
            rows, batched.batched_reach_rows(ing, eg, ing_iso, eg_iso, loc + lo, **flags))
        frags.append(batched.stripe_reach_cols(ing[lo:hi], eg[lo:hi], ing_iso,
                                               eg_iso[lo:hi], dst, **kw))
    np.testing.assert_array_equal(
        np.concatenate(frags),
        batched.batched_reach_cols(ing, eg, ing_iso, eg_iso, dst, **flags))


def test_dense_twins_take_device_iso_vectors_without_a_copy():
    port, _ = _dense_engines(40, 45)
    state = dense_query_state(port, 3)
    ing_iso = state.arrays["ing_iso"]
    assert batched._as_iso(ing_iso, ing_iso.device) is ing_iso
    flags = dict(self_traffic=True, default_allow_unselected=True)
    src = [0, 39, 12]
    np.testing.assert_array_equal(
        batched.batched_reach_rows(state.arrays["ing_count"], state.arrays["eg_count"],
                                   ing_iso, state.arrays["eg_iso"], src, **flags),
        port.reach[src])


def test_dense_query_state_aliases_counts_and_owns_iso_and_words():
    from kubernetes_verification_tpu.ops.device_state import (
        _dense_reach_words as jax_dense_words,
    )

    for n_pods in (40, 64, 97):  # ragged and whole word widths
        port, jax_ = _dense_engines(n_pods, n_pods)
        state = dense_query_state(port, 5, with_reach_words=True)
        assert state.kind == "dense" and state.n == n_pods and state.generation == 5
        assert state.owned == ("ing_iso", "eg_iso", "reach_words")
        assert state.arrays["ing_count"] is port._ing_count
        assert state.arrays["eg_count"] is port._eg_count
        assert state.arrays["ing_iso"].dtype == torch.int32
        np.testing.assert_array_equal(state.arrays["eg_iso"].numpy(), port._eg_iso)
        assert state.meta["h2d_bytes"] == 2 * 4 * n_pods
        want, _ = jax_dense_words(jax_)
        got = to_host_words(state.arrays["reach_words"])
        assert got.shape == np.asarray(want).shape
        assert got.tobytes() == np.asarray(want).tobytes()
        # the words stay this generation's; the aliased counts follow the engine
        before = got.copy()
        pol = next(iter(port.policies.values()))
        port.remove_policy(pol.namespace, pol.name)
        assert to_host_words(state.arrays["reach_words"]).tobytes() == before.tobytes()
        assert state.arrays["ing_count"] is port._ing_count
        fresh = dense_query_state(port, 6, with_reach_words=True)
        np.testing.assert_array_equal(
            unpack_cols(to_host_words(fresh.arrays["reach_words"]), n_pods),
            port.reach)
        assert dense_query_state(port, 7).owned == ("ing_iso", "eg_iso")
