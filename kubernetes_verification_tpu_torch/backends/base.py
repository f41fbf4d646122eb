"""The ``VerifierBackend`` plugin boundary of the PyTorch port.

The port's own copy of ``kubernetes_verification_tpu.backends.base``: the same
``VerifyConfig``, ``PortAtom`` and ``VerifyResult`` (so results of the two
packages compare field by field), and a registry of its own — registering a
backend here never touches the JAX package's registry. The built-in backends
are ``torch``, the dense single-device solve (``backends/device.py``),
``cpu``, the object-level NumPy oracle (``backends/cpu.py``), and the
mesh-sharded ``sharded`` and ``sharded-packed`` (``backends/sharded*.py``,
SPMD on ``torch.distributed``); importing the package registers them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..models.core import Cluster, Container, KanoPolicy
from ..observe import trace
from ..observe.metrics import PAIRS_PER_SECOND, VERIFY_TOTAL
from ..resilience.errors import ConfigError, UnknownBackendError

__all__ = [
    "VerifyConfig",
    "PortAtom",
    "VerifyResult",
    "VerifierBackend",
    "register_backend",
    "get_backend",
    "available_backends",
    "verify",
    "verify_kano",
]


@dataclass(frozen=True)
class VerifyConfig:
    """Typed verification config — the single flag surface.

    Semantic flags (k8s mode):

    * ``self_traffic`` — treat every pod as reachable from itself regardless of
      policy (the reference's ``check_self_ingress_traffic``,
      ``kubesv/kubesv/constraint.py:12,193-194``; default True there and here).
    * ``default_allow_unselected`` — pods selected by no policy in a direction
      default to allow-all in that direction (real Kubernetes semantics); set
      it False to reproduce the reference's "unselected pods are unreachable".
    * ``direction_aware_isolation`` — only policies whose
      ``effective_policy_types`` include a direction isolate pods in that
      direction (real k8s); set False to reproduce the reference, which never
      consults policyTypes.

    ``backend`` selects the execution engine (``torch``: the dense solve on a
    CUDA device, or on the CPU with the backend option ``("device", "cpu")``;
    ``cpu``: the object-level NumPy oracle on the host).
    ``closure`` adds the transitive closure of ``reach`` (``closure`` field of
    the result).
    """

    backend: str = "torch"
    self_traffic: bool = True
    default_allow_unselected: bool = True
    direction_aware_isolation: bool = True
    compute_ports: bool = True
    closure: bool = False
    #: kano-mode label matcher plugin; k8s-mode ``verify`` rejects it
    label_relation: Optional[object] = field(default=None, kw_only=True)
    #: extra, backend-specific options (e.g. ``("device", "cpu")``)
    backend_options: Tuple[Tuple[str, object], ...] = ()

    def opt(self, key: str, default=None):
        return dict(self.backend_options).get(key, default)


@dataclass(frozen=True)
class PortAtom:
    """One equivalence class of (protocol, port) space: all ports in
    ``[lo, hi]`` of ``protocol`` behave identically under every policy in the
    cluster, so the port dimension of the reach tensor needs one slot per atom
    instead of 65536×3. ``name`` is set for named-port atoms."""

    protocol: str
    lo: int
    hi: int
    name: Optional[str] = None

    @property
    def width(self) -> int:
        return 1 if self.name is not None else self.hi - self.lo + 1


@dataclass
class VerifyResult:
    """Backend-independent verification output.

    ``reach[src, dst]`` — src can reach dst on *some* port (row = source).
    ``reach_ports[src, dst, q]`` — per port-atom reachability (with
    ``compute_ports``). ``src_sets``/``dst_sets`` are the per-policy
    direction-swapped select/allow bitmaps the policy queries consume.
    """

    n_pods: int
    mode: str  # "k8s" | "kano"
    backend: str
    config: VerifyConfig
    reach: np.ndarray  # bool [N, N]
    reach_ports: Optional[np.ndarray] = None  # bool [N, N, Q]
    port_atoms: List[PortAtom] = field(default_factory=list)
    #: per policy: which pods are sources of its edges
    src_sets: Optional[np.ndarray] = None  # bool [P, N]
    #: per policy: which pods are destinations of its edges
    dst_sets: Optional[np.ndarray] = None  # bool [P, N]
    #: pod selected by policy (podSelector ∧ namespace) [P, N]
    selected: Optional[np.ndarray] = None
    ingress_isolated: Optional[np.ndarray] = None  # bool [N]
    egress_isolated: Optional[np.ndarray] = None  # bool [N]
    closure: Optional[np.ndarray] = None  # bool [N, N] transitive closure
    timings: Dict[str, float] = field(default_factory=dict)

    # -- convenience views -------------------------------------------------
    def reachable(self, src: int, dst: int) -> bool:
        return bool(self.reach[src, dst])

    def edges(self) -> List[Tuple[int, int]]:
        """Reachable (src, dst) index pairs."""
        s, d = np.nonzero(self.reach)
        return list(zip(s.tolist(), d.tolist()))

    # -- the six kano verification queries (kano_py/kano/algorithm.py) -----
    def all_reachable(self) -> List[int]:
        from ..ops.queries import all_reachable

        return all_reachable(self.reach)

    def all_isolated(self) -> List[int]:
        from ..ops.queries import all_isolated

        return all_isolated(self.reach)

    def user_crosscheck(self, containers_or_pods, label: str) -> List[int]:
        from ..ops.queries import user_crosscheck

        return user_crosscheck(self.reach, containers_or_pods, label)

    def system_isolation(self, idx: int) -> List[int]:
        from ..ops.queries import system_isolation

        return system_isolation(self.reach, idx)

    def policy_shadow(self) -> List[Tuple[int, int]]:
        from ..ops.queries import policy_shadow

        return policy_shadow(self.src_sets, self.dst_sets)

    def policy_conflict(self) -> List[Tuple[int, int]]:
        from ..ops.queries import policy_conflict

        return policy_conflict(self.src_sets, self.dst_sets)


class VerifierBackend:
    """Backend interface. Implementations provide one or both modes."""

    name: str = "abstract"
    #: whether verify_kano honors VerifyConfig.label_relation (the kano
    #: matcher plugin); the dispatcher rejects a custom relation otherwise
    #: rather than silently computing equality-only results
    supports_label_relation: bool = False

    def verify(self, cluster: Cluster, config: VerifyConfig) -> VerifyResult:
        raise NotImplementedError

    def verify_kano(
        self,
        containers: Sequence[Container],
        policies: Sequence[KanoPolicy],
        config: VerifyConfig,
    ) -> VerifyResult:
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[[], VerifierBackend]] = {}


def register_backend(name: str, factory: Callable[[], VerifierBackend]) -> None:
    _REGISTRY[name] = factory


def _register_builtins() -> None:
    # register "cpu", "torch", "sharded", "sharded-packed" and "datalog",
    # and "native" where a C++ compiler exists
    from ..datalog import k8s_program  # noqa: F401
    from . import cpu, device, sharded, sharded_packed  # noqa: F401

    try:
        from . import native  # noqa: F401
    except Exception:  # NativeUnavailable or loader errors
        pass


def available_backends() -> List[str]:
    _register_builtins()
    return sorted(_REGISTRY)


def get_backend(name: str) -> VerifierBackend:
    _register_builtins()

    if name not in _REGISTRY:
        raise UnknownBackendError(
            f"unknown backend {name!r}; have {available_backends()}",
            backend=name,
        )
    return _REGISTRY[name]()


def _record_run(res: VerifyResult) -> None:
    """Registry bookkeeping shared by both dispatchers: run counter plus the
    roofline-style throughput gauge (decided pod pairs per solve second)."""
    VERIFY_TOTAL.labels(backend=res.backend, mode=res.mode).inc()
    solve = res.timings.get("solve", 0.0)
    if solve > 0:
        PAIRS_PER_SECOND.labels(backend=res.backend).set(
            res.n_pods * res.n_pods / solve
        )


def verify(cluster: Cluster, config: Optional[VerifyConfig] = None) -> VerifyResult:
    """Verify a k8s-level cluster with the configured backend."""
    config = config or VerifyConfig()
    if config.label_relation is not None:
        raise ConfigError(
            "label_relation is the kano-mode matcher plugin; k8s-mode "
            "selectors follow the Kubernetes LabelSelector spec (use "
            "verify_kano)"
        )
    backend = get_backend(config.backend)
    with trace("verify", backend=config.backend, mode="k8s"):
        res = backend.verify(cluster, config)
    _record_run(res)
    return res


def verify_kano(
    containers: Sequence[Container],
    policies: Sequence[KanoPolicy],
    config: Optional[VerifyConfig] = None,
) -> VerifyResult:
    """Verify a kano-level scenario with the configured backend."""
    config = config or VerifyConfig()
    backend = get_backend(config.backend)
    if config.label_relation is not None and not backend.supports_label_relation:
        raise ConfigError(
            f"backend {config.backend!r} does not honor label_relation; "
            "use the torch backend for a custom kano matcher"
        )
    with trace("verify", backend=config.backend, mode="kano"):
        res = backend.verify_kano(containers, policies, config)
    _record_run(res)
    return res
