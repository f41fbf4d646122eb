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

The serving engines take ``mesh=`` to shard their state over a
``(pods, grants)`` mesh, SPMD on ``torch.distributed`` (every rank applies
the same diffs)::

    sharded = kvt.PackedIncrementalVerifier(cluster, mesh=kvt.mesh_for())

The ``native`` backend (``backends/native.py``) runs the packed-bitset C++
engine on the host (registered where a C++ compiler exists). The
``datalog`` backend (``datalog/``) evaluates the kubesv Datalog program
with ``torch.einsum`` rules on the card. The query twins
(``ops/batched.py``), the device query state (``ops/device_state.py``) and
the posture ops (``ops/posture.py``) are imported from their modules. The
cluster loaders (``load_cluster``, ``dump_cluster``, ``load_kano``) read
JSON without PyYAML and import it only for YAML manifests;
``utils.persist`` is imported from its module, and so is the serving
plane, ``serve`` (``VerificationService``, ``QueryEngine``,
``CheckpointManager``, ``RecoveryManager``, ``PostureTracker``), which
imports this package's ``verify``. The resilience drivers
(``resilient_verify``, ``register_faulty``, ...) load on first access.
"""
from .backends.base import (
    PortAtom,
    VerifierBackend,
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
from .ingest import dump_cluster, load_cluster, load_kano
from .models.core import (
    EGRESS,
    INGRESS,
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
from .resilience.errors import (
    BackendChainExhausted,
    BackendError,
    BackendOOM,
    BackendTimeout,
    ConfigError,
    DeviceLost,
    EncodeError,
    IngestError,
    KvTpuError,
    PersistError,
    UnknownBackendError,
)
from .backends import sharded as _sharded  # noqa: F401  registers "sharded"
from .backends import sharded_packed as _sharded_packed  # noqa: F401  registers "sharded-packed"
from .datalog import k8s_program as _datalog  # noqa: F401  registers "datalog"

try:  # needs a C++ compiler (or a previously built library)
    from .backends import native as _native  # noqa: F401  registers "native"
except Exception:  # pragma: no cover - NativeUnavailable or loader errors
    pass

__version__ = "0.1.0"

__all__ = [
    "BackendChainExhausted",
    "BackendError",
    "BackendOOM",
    "BackendTimeout",
    "Cluster",
    "ConfigError",
    "Container",
    "DefaultEqualityLabelRelation",
    "DeviceLost",
    "EGRESS",
    "EncodeError",
    "EncodedCluster",
    "Expr",
    "GeneratorConfig",
    "INGRESS",
    "IncrementalVerifier",
    "IngestError",
    "IpBlock",
    "KanoPolicy",
    "KvTpuError",
    "LabelRelation",
    "Namespace",
    "NetworkPolicy",
    "PackedIncrementalVerifier",
    "PackedPortsIncrementalVerifier",
    "PackedReach",
    "PackedShardedResult",
    "Peer",
    "PersistError",
    "Pod",
    "PortAtom",
    "PolicyVectorizer",
    "PortSpec",
    "PortUniverseChanged",
    "ResilienceConfig",
    "Rule",
    "Selector",
    "UnknownBackendError",
    "VerifierBackend",
    "VerifyConfig",
    "VerifyResult",
    "available_backends",
    "bounded_closure_rows",
    "bounded_packed_closure",
    "__version__",
    "distributed_mesh",
    "dump_cluster",
    "encode_cluster",
    "encoding_from_arrays",
    "encoding_to_arrays",
    "get_backend",
    "init_distributed",
    "load_cluster",
    "load_kano",
    "mesh_for",
    "packed_closure",
    "packed_closure_delta",
    "parse_fault_spec",
    "path_upto",
    "policy_pair_masks",
    "policy_pair_masks_sharded",
    "policy_sets_sharded",
    "random_cluster",
    "random_kano",
    "register_backend",
    "register_faulty",
    "resilient_verify",
    "resilient_verify_kano",
    "sharded_packed_closure",
    "sharded_packed_reach",
    "tiled_k8s_reach",
    "transitive_closure",
    "verify",
    "verify_kano",
]

#: the resilience drivers, loaded on first access: the wrapper and the fault
#: harness import backend modules, which the error taxonomy above must not
_LAZY = {"ResilienceConfig", "resilient_verify", "resilient_verify_kano",
         "register_faulty", "parse_fault_spec"}


def __getattr__(name):
    if name in _LAZY:
        from . import resilience

        return getattr(resilience, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
