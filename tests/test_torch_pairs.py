"""The port's flagship-scale policy-pair masks (``ops/tiled.py::
policy_pair_masks``) against the JAX package's on carried encodings, and
against the dense ``verify``'s ``policy_shadow`` / ``policy_conflict``
(exact: boolean masks). Mirrors ``tests/test_tiled.py``'s pair-mask test."""
import numpy as np
import pytest
import torch

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.ops import queries as jax_queries
from kubernetes_verification_tpu.ops.tiled import _pair_mask_args as jax_pair_mask_args
from kubernetes_verification_tpu.ops.tiled import _policy_sets as jax_policy_sets
from kubernetes_verification_tpu.ops.tiled import policy_pair_masks as jax_pair_masks
from kubernetes_verification_tpu_torch.ops import queries
from kubernetes_verification_tpu_torch.ops.padding import pad_pods
from kubernetes_verification_tpu_torch.ops.tiled import (
    _pair_mask_args,
    _policy_sets,
    _put,
    policy_pair_masks,
)
from torch_parity import carried


def _gen(seed, **kw):
    return dict(n_pods=59, n_policies=17, n_namespaces=3, p_ipblock_peer=0.1,
                seed=seed, **kw)


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("dai", [True, False])
@pytest.mark.parametrize("chunk", [8, 2048])
def test_pair_masks_match_jax(seed, dai, chunk):
    jenc, penc = carried(**_gen(seed))
    want = jax_pair_masks(jenc, direction_aware_isolation=dai, chunk=chunk)
    got = policy_pair_masks(penc, direction_aware_isolation=dai, chunk=chunk, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == np.bool_ and g.shape == (17, 17)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [21, 22])
@pytest.mark.parametrize("dai", [True, False])
def test_pair_masks_match_the_dense_queries(seed, dai):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**_gen(seed)))
    ref = kvt.verify(cluster, kvt.VerifyConfig(
        compute_ports=False, direction_aware_isolation=dai,
        backend_options=(("device", "cpu"),),
    ))
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    shadow, conflict = kvt.policy_pair_masks(
        enc, direction_aware_isolation=dai, chunk=8, device="cpu"
    )
    assert queries._pairs(shadow) == ref.policy_shadow()
    assert queries._pairs(conflict) == ref.policy_conflict()


def test_policy_sets_match_jax_and_the_dense_sets():
    """The [P, N] src/dst sets the Grams contract: JAX's on the same
    operands, and the dense solve's ``src_sets`` / ``dst_sets``."""
    jenc, penc = carried(**_gen(24))
    jargs = jax_pair_mask_args(jenc, True, 8, n_pad=0)
    want = [np.asarray(x) for x in jax_policy_sets(*jargs, chunk=8)]
    args = _put(_pair_mask_args(penc, True, 8, n_pad=0), torch.device("cpu"))
    got = [x.numpy() for x in _policy_sets(args, chunk=8)]
    for g, w in zip(got, want):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, w)
    # the pair lists from these sets agree with JAX's dense queries
    assert queries.policy_shadow(got[0] > 0, got[1] > 0) == jax_queries.policy_shadow(
        want[0] > 0, want[1] > 0
    )


def test_pair_mask_args_pad_pods_as_jax_does():
    """Pod-axis padding (the sharded forms' input): label-less pods in
    namespace −1 with validity 0; the sets are then zero on the pad pods."""
    jenc, penc = carried(**_gen(25))
    jargs = jax_pair_mask_args(jenc, False, 8, n_pad=5)
    args = _pair_mask_args(penc, False, 8, n_pad=5)
    for name, g, w in zip(args._fields, args, jargs):
        if hasattr(w, "shape"):
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    assert args.valid.tolist() == [1] * 59 + [0] * 5
    src8, dst8 = _policy_sets(_put(args, torch.device("cpu")), chunk=8)
    assert not src8[:, 59:].any() and not dst8[:, 59:].any()
    kv, key, ns = pad_pods(penc.pod_kv, penc.pod_key, penc.pod_ns, 3)
    assert ns[-3:].tolist() == [-1] * 3 and not kv[-3:].any() and not key[-3:].any()


def test_pair_masks_with_no_policies_and_no_grants():
    _, penc = carried(**_gen(26, p_absent_rules=1.0))
    shadow, conflict = policy_pair_masks(penc, device="cpu")
    assert shadow.shape == (17, 17) and not conflict.any()
    _, empty = carried(n_pods=20, n_policies=0, seed=1)
    shadow, conflict = policy_pair_masks(empty, device="cpu")
    assert shadow.shape == (0, 0) and conflict.shape == (0, 0)
