"""The port on an NVIDIA GPU: the hand-written CUDA kernel against its plain
PyTorch version, and the solves on the card against the same solves on the
CPU (exact: every output is boolean or integer words).

Every test here is marked ``cuda`` and skips without a GPU. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; there, from the repository root::

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.ops.kernels import (
    packed_dir_allow,
    packed_dir_allow_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: skip without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("p,n", [(77, 512), (1, 128), (300, 1024)])
def test_kernel_matches_plain_version(cuda_device, p, n):
    rng = np.random.default_rng(p)
    a, b = ((rng.random((p, n)) < 0.05).astype(np.int8) for _ in range(2))
    niso = np.broadcast_to((rng.random(n) < 0.5).astype(np.int32), (8, n)).copy()
    ta, tb, tn = (torch.as_tensor(x, device=cuda_device) for x in (a, b, niso))
    for axis in (1, 0, -1):
        before = packed_dir_allow.launches
        got = packed_dir_allow(ta, tb, tn, default_allow_axis=axis)
        torch.cuda.synchronize()
        assert packed_dir_allow.launches == before + 1
        want = packed_dir_allow_reference(ta, tb, tn, default_allow_axis=axis)
        assert torch.equal(got, want), axis
        # and the plain version on the card equals the one on the CPU
        cpu = packed_dir_allow(
            torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(niso),
            default_allow_axis=axis,
        )
        assert torch.equal(want.cpu(), cpu), axis


def test_tiled_kernel_path_matches_sweep_and_cpu(cuda_device):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=700, n_policies=60, n_namespaces=4, p_ipblock_peer=0.1, seed=3,
    ))
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    before = packed_dir_allow.launches
    got = kvt.tiled_k8s_reach(enc, chunk=64, fetch=False)
    assert packed_dir_allow.launches == before + 2
    assert got.meta == {"kernel": "packed_dir_allow"}
    sweep = kvt.tiled_k8s_reach(enc, chunk=64, fetch=False, use_kernel=False)
    assert torch.equal(got.packed, sweep.packed)
    cpu = kvt.tiled_k8s_reach(enc, chunk=64, device="cpu")
    np.testing.assert_array_equal(got.packed.cpu().numpy().view("<u4"), cpu.packed)
    assert got.timings["reachable_pairs"] == int(cpu.out_degree().sum())
    assert got.all_isolated() == cpu.all_isolated()


@pytest.mark.parametrize("compute_ports", [True, False])
def test_verify_on_card_matches_cpu(cuda_device, compute_ports):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=300, n_policies=40, seed=4))
    runs = [
        kvt.verify(cluster, kvt.VerifyConfig(
            compute_ports=compute_ports, backend_options=(("device", d),),
        ))
        for d in ("cuda", "cpu")
    ]
    for name in ("reach", "reach_ports", "src_sets", "dst_sets", "selected",
                 "ingress_isolated", "egress_isolated"):
        g, w = (getattr(r, name) for r in runs)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(g, w, err_msg=name)
