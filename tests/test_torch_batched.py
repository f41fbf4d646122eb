"""The packed query twins (``ops/batched.py``), the device query state
(``ops/device_state.py``) and the tombstone-aware ``PackedReach`` of the
port, on the CPU, against the JAX package's on the same engines' states
(exact: every output is boolean or integer words)."""
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
from kubernetes_verification_tpu_torch.ops.bits import to_host_words
from kubernetes_verification_tpu_torch.ops.device_state import (
    DeviceQueryState,
    DeviceStateCache,
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
