"""The port's any-port tiled solve against the JAX package's, on carried
encodings: packed words, isolation vectors, selection and the pair count
(exact: every output is boolean or integer)."""
import numpy as np
import pytest
import torch

from kubernetes_verification_tpu.ops import queries as jax_queries
from kubernetes_verification_tpu.ops.tiled import tiled_k8s_reach as jax_tiled
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import (
    random_cluster as jax_random_cluster,
)
from kubernetes_verification_tpu_torch.ops.kernels import packed_dir_allow, packed_reach
from kubernetes_verification_tpu_torch.ops.tiled import kernel_operands, tiled_k8s_reach
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError
from torch_parity import carried, words

_FLAGS = [
    {},
    dict(self_traffic=False),
    dict(default_allow_unselected=False),
    dict(direction_aware_isolation=False),
]


def _gen(n_pods, seed):
    return dict(
        n_pods=n_pods, n_policies=13, n_namespaces=3, p_ipblock_peer=0.1,
        seed=seed,
    )


def _assert_same(got, want):
    np.testing.assert_array_equal(words(got.packed), words(want.packed))
    np.testing.assert_array_equal(got.ingress_isolated, np.asarray(want.ingress_isolated))
    np.testing.assert_array_equal(got.egress_isolated, np.asarray(want.egress_isolated))


@pytest.mark.parametrize("n_pods,seed", [(61, 11), (300, 12)])
@pytest.mark.parametrize("flags", _FLAGS, ids=["default", "no-self", "no-default-allow", "no-direction"])
def test_tiled_matches_jax_sweep(n_pods, seed, flags):
    jenc, penc = carried(**_gen(n_pods, seed))
    kw = dict(tile=128, chunk=16, **flags)
    want = jax_tiled(jenc, use_pallas=False, **kw)
    got = tiled_k8s_reach(penc, device="cpu", **kw)
    assert got.meta == {"kernel": "torch-sweep"}
    _assert_same(got, want)
    np.testing.assert_array_equal(got.selected, np.asarray(want.selected))
    # the kernel route (its plain version, on the CPU) gives the same words
    via_kernel = tiled_k8s_reach(penc, device="cpu", use_kernel=True, **kw)
    assert via_kernel.meta == {"kernel": "packed_dir_allow"}
    _assert_same(via_kernel, want)


@pytest.mark.parametrize("flags", _FLAGS[:3], ids=["default", "no-self", "no-default-allow"])
def test_tiled_matches_jax_pallas_interpret(flags):
    jenc, penc = carried(**_gen(150, 13))
    want = jax_tiled(jenc, tile=4096, chunk=16, use_pallas=True, fetch=False, **flags)
    before = packed_dir_allow.launches
    got = tiled_k8s_reach(
        penc, tile=4096, chunk=16, device="cpu", use_kernel=True, fetch=False,
        **flags,
    )
    assert packed_dir_allow.launches == before  # CPU: the plain version ran
    _assert_same(got, want)
    assert got.timings["reachable_pairs"] == want.timings["reachable_pairs"]


def test_packed_queries_match_jax_host_and_device():
    cluster = jax_random_cluster(JaxGeneratorConfig(**_gen(67, 17)))
    jenc, penc = carried(**_gen(67, 17))
    want = jax_tiled(jenc, tile=32, chunk=8)
    for fetch in (True, False):
        got = tiled_k8s_reach(penc, tile=32, chunk=8, device="cpu", fetch=fetch)
        assert isinstance(got.packed, np.ndarray) == fetch
        assert got.all_reachable() == want.all_reachable()
        assert got.all_isolated() == want.all_isolated()
        np.testing.assert_array_equal(got.out_degree(), want.out_degree())
        np.testing.assert_array_equal(got.to_bool(), want.to_bool())
        for label in ("team", "app", "no-such-label"):
            assert got.user_crosscheck(cluster.pods, label) == want.user_crosscheck(
                cluster.pods, label
            )
        for idx in (0, 13, 66):
            assert got.system_isolation(idx) == jax_queries.system_isolation(
                want.to_bool(), idx
            )
            assert got.reachable(idx, 5) == want.reachable(idx, 5)
            np.testing.assert_array_equal(got.row(idx), want.row(idx))
        # the packed closure, on the same side as the words it closes
        closed = got.closure(tile=32, device="cpu")
        want_closed = want.closure(tile=32)
        assert isinstance(closed.packed, np.ndarray) == fetch
        assert closed.n_pods == got.n_pods and closed.meta == got.meta
        np.testing.assert_array_equal(words(closed.packed), words(want_closed.packed))
        assert closed.all_isolated() == want_closed.all_isolated()
        np.testing.assert_array_equal(closed.out_degree(), want_closed.out_degree())


def test_multi_atom_encoding_is_refused(monkeypatch):
    """A multi-atom encoding takes the port-bitmap path; what is refused now
    is one whose distinct ported masks exceed the port path's cap, on both
    routes (``tests/test_torch_ports.py`` holds the path against JAX)."""
    from kubernetes_verification_tpu_torch.ops import tiled_ports

    _, penc = carried(**_gen(40, 3), p_ports=0.9, compute_ports=True)
    assert len(penc.atoms) > 1
    with monkeypatch.context() as m:
        m.setattr(tiled_ports, "_MAX_PORT_MASKS", 1)
        for use_kernel in (False, True):
            with pytest.raises(ConfigError, match="cap of 1"):
                tiled_k8s_reach(penc, device="cpu", use_kernel=use_kernel)
    assert tiled_k8s_reach(penc, device="cpu").meta == {"kernel": "torch-ports-sweep"}


def test_kernel_operands_are_what_the_solve_contracts():
    _, penc = carried(**_gen(100, 19))
    *ops, col_mask = kernel_operands(penc, tile=128, chunk=16, device="cpu")
    assert [tuple(x.shape) for x in ops] == [(13, 128)] * 4 + [(8, 128)] * 2
    words_ = packed_reach(*ops) & col_mask[None, :]
    got = tiled_k8s_reach(penc, tile=128, chunk=16, device="cpu", fetch=False)
    assert torch.equal(words_[:100], got.packed)
