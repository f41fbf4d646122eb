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
    closed = reach.closure()                    # packed transitive closure
    shadow, conflict = kvt.policy_pair_masks(enc)
    res = kvt.verify(cluster, kvt.VerifyConfig(backend="torch", closure=True))
    dense = kvt.IncrementalVerifier(cluster)   # the dense engine (≤ ~32k pods)
    engine = kvt.PackedIncrementalVerifier(cluster)  # the serving engine
    engine.remove_policy(cluster.policies[0].namespace, cluster.policies[0].name)
    ports = kvt.PackedPortsIncrementalVerifier(cluster)  # ... with port bitmaps
    containers, policies = kvt.random_kano(1000, 100, seed=0)
    kano = kvt.verify_kano(containers, policies, kvt.VerifyConfig(backend="torch"))
    oracle = kvt.verify(cluster, kvt.VerifyConfig(backend="cpu"))  # host NumPy
    mesh = kvt.mesh_for()  # every rank of the torch.distributed job (1 here)
    pk = kvt.sharded_packed_reach(mesh, enc)  # SPMD; or backend="sharded-packed"

The query twins (``ops/batched.py``), the device query state
(``ops/device_state.py``) and the posture ops (``ops/posture.py``) are
imported from their modules. ``ingest`` and ``utils.persist`` are host-only
(PyYAML for YAML manifests) and are not imported here; neither is the
serving plane, ``serve`` (``VerificationService``, ``QueryEngine``,
``CheckpointManager``, ``RecoveryManager``, ``PostureTracker``), which
imports this package's ``verify``.
"""
from .backends.base import (
    PortAtom,
    VerifyConfig,
    VerifyResult,
    available_backends,
    get_backend,
    register_backend,
    verify,
    verify_kano,
)
from .encode.carry import encoding_from_arrays, encoding_to_arrays
from .encode.encoder import EncodedCluster, encode_cluster
from .harness.generate import GeneratorConfig, random_cluster, random_kano
from .incremental import IncrementalVerifier
from .models.core import (
    Cluster,
    Container,
    DefaultEqualityLabelRelation,
    Expr,
    IpBlock,
    KanoPolicy,
    LabelRelation,
    Namespace,
    NetworkPolicy,
    Peer,
    Pod,
    PortSpec,
    Rule,
    Selector,
)
from .ops.closure import (
    bounded_closure_rows,
    bounded_packed_closure,
    packed_closure,
    packed_closure_delta,
    path_upto,
    transitive_closure,
)
from .ops.tiled import (
    PackedReach,
    policy_pair_masks,
    policy_pair_masks_sharded,
    policy_sets_sharded,
    tiled_k8s_reach,
)
from .packed_incremental import PackedIncrementalVerifier, PolicyVectorizer
from .packed_incremental_ports import PackedPortsIncrementalVerifier, PortUniverseChanged
from .parallel.mesh import distributed_mesh, init_distributed, mesh_for
from .parallel.packed_sharded import PackedShardedResult, sharded_packed_reach
from .parallel.sharded_closure import sharded_packed_closure
from .backends import sharded as _sharded  # noqa: F401  registers "sharded"
from .backends import sharded_packed as _sharded_packed  # noqa: F401  registers "sharded-packed"

__all__ = [
    "Cluster",
    "Container",
    "DefaultEqualityLabelRelation",
    "EncodedCluster",
    "Expr",
    "GeneratorConfig",
    "IncrementalVerifier",
    "IpBlock",
    "KanoPolicy",
    "LabelRelation",
    "Namespace",
    "NetworkPolicy",
    "PackedIncrementalVerifier",
    "PackedPortsIncrementalVerifier",
    "PackedReach",
    "PackedShardedResult",
    "Peer",
    "Pod",
    "PortAtom",
    "PolicyVectorizer",
    "PortSpec",
    "PortUniverseChanged",
    "Rule",
    "Selector",
    "VerifyConfig",
    "VerifyResult",
    "available_backends",
    "bounded_closure_rows",
    "bounded_packed_closure",
    "distributed_mesh",
    "encode_cluster",
    "encoding_from_arrays",
    "encoding_to_arrays",
    "get_backend",
    "init_distributed",
    "mesh_for",
    "packed_closure",
    "packed_closure_delta",
    "path_upto",
    "policy_pair_masks",
    "policy_pair_masks_sharded",
    "policy_sets_sharded",
    "random_cluster",
    "random_kano",
    "register_backend",
    "sharded_packed_closure",
    "sharded_packed_reach",
    "tiled_k8s_reach",
    "transitive_closure",
    "verify",
    "verify_kano",
]
