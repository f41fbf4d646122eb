"""The port's selector matching against the JAX package's, on carried
operands (exact: boolean outputs of exact integer counts)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_verification_tpu.ops.match import match_selectors as jax_match
from kubernetes_verification_tpu.ops.match import subset_match as jax_subset
from kubernetes_verification_tpu_torch.ops.match import (
    as_tensors,
    match_selectors,
    subset_match,
)
from torch_parity import carried


def _stacks(enc):
    """(name, selector stack, entity kv, entity key) of every stack."""
    return [
        ("pol_sel", enc.pol_sel, enc.pod_kv, enc.pod_key),
        ("ingress.pod_sel", enc.ingress.pod_sel, enc.pod_kv, enc.pod_key),
        ("ingress.ns_sel", enc.ingress.ns_sel, enc.ns_kv, enc.ns_key),
        ("egress.pod_sel", enc.egress.pod_sel, enc.pod_kv, enc.pod_key),
        ("egress.ns_sel", enc.egress.ns_sel, enc.ns_kv, enc.ns_key),
    ]


@pytest.mark.parametrize("seed", [3, 4])
def test_match_selectors_matches_jax(seed):
    jenc, penc = carried(
        n_pods=70, n_policies=30, n_namespaces=4, p_match_expressions=0.9,
        p_namespace_selector=0.5, seed=seed,
    )
    # every matchExpressions operator is in play
    all_sel = [jenc.pol_sel, jenc.ingress.pod_sel, jenc.ingress.ns_sel,
               jenc.egress.pod_sel, jenc.egress.ns_sel]
    assert any(s.in_valid.any() for s in all_sel)  # In
    assert any(s.forbid_eq.any() for s in all_sel)  # NotIn
    assert any(s.req_key.any() for s in all_sel)  # Exists
    assert any(s.forbid_key.any() for s in all_sel)  # DoesNotExist
    cpu = torch.device("cpu")
    for (name, jsel, jkv, jkey), (_, psel, pkv, pkey) in zip(
        _stacks(jenc), _stacks(penc)
    ):
        want = np.asarray(jax_match(jsel, jnp.asarray(jkv), jnp.asarray(jkey)))
        got = match_selectors(
            as_tensors(psel, cpu), torch.as_tensor(pkv), torch.as_tensor(pkey)
        ).numpy()
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_subset_match_matches_jax():
    rng = np.random.default_rng(0)
    req = rng.random((20, 40)) < 0.1
    kv = rng.random((50, 40)) < 0.5
    want = np.asarray(jax_subset(jnp.asarray(req), jnp.asarray(kv)))
    got = subset_match(torch.as_tensor(req), torch.as_tensor(kv)).numpy()
    np.testing.assert_array_equal(got, want)


def test_counts_do_not_leave_tf32_on():
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        req = torch.ones((2, 3), dtype=torch.bool)
        subset_match(req, torch.ones((4, 3), dtype=torch.bool))
        # the exact-count context restores the caller's setting
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
