"""kubernetes_verification_tpu_torch — the PyTorch/CUDA port of
``kubernetes_verification_tpu``.

All-pairs pod reachability under Kubernetes NetworkPolicies, on one NVIDIA
H100. The host layers (model, encoder, generator) are this package's own
copies of the JAX package's framework-free modules; the solves are PyTorch,
and the Pallas TPU kernels become hand-written CUDA kernels (``csrc/``),
each with a plain PyTorch version beside it. The package never imports JAX
nor the JAX package.

Entry points run on ``cuda`` unless the caller passes a CPU device::

    import kubernetes_verification_tpu_torch as kvt
    cluster = kvt.random_cluster(n_pods=1000, n_policies=100, seed=0)
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    reach = kvt.tiled_k8s_reach(enc)            # packed words, on the GPU
    res = kvt.verify(cluster, kvt.VerifyConfig(backend="torch"))
"""
from .backends.base import (
    PortAtom,
    VerifyConfig,
    VerifyResult,
    available_backends,
    get_backend,
    register_backend,
    verify,
)
from .encode.carry import encoding_from_arrays, encoding_to_arrays
from .encode.encoder import EncodedCluster, encode_cluster
from .harness.generate import GeneratorConfig, random_cluster
from .models.core import (
    Cluster,
    Expr,
    IpBlock,
    Namespace,
    NetworkPolicy,
    Peer,
    Pod,
    PortSpec,
    Rule,
    Selector,
)
from .ops.tiled import PackedReach, tiled_k8s_reach

__all__ = [
    "Cluster",
    "EncodedCluster",
    "Expr",
    "GeneratorConfig",
    "IpBlock",
    "Namespace",
    "NetworkPolicy",
    "PackedReach",
    "Peer",
    "Pod",
    "PortAtom",
    "PortSpec",
    "Rule",
    "Selector",
    "VerifyConfig",
    "VerifyResult",
    "available_backends",
    "encode_cluster",
    "encoding_from_arrays",
    "encoding_to_arrays",
    "get_backend",
    "random_cluster",
    "register_backend",
    "tiled_k8s_reach",
    "verify",
]
