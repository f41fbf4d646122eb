"""The ``VerifierBackend`` plugin boundary of the PyTorch port.

The port's own copy of ``kubernetes_verification_tpu.backends.base``: the same
``VerifyConfig``, ``PortAtom`` and ``VerifyResult`` (so results of the two
packages compare field by field), and a registry of its own — registering a
backend here never touches the JAX package's registry. The built-in backend
is ``torch``, the dense single-device solve (``backends/device.py``); it
registers itself the first time a backend is looked up.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..models.core import Cluster
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
    CUDA device, or on the CPU with the backend option ``("device", "cpu")``).
    ``closure`` asks for the transitive closure, which the port does not
    compute yet.
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
    mode: str  # "k8s"
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

    def user_crosscheck(self, pods, label: str) -> List[int]:
        from ..ops.queries import user_crosscheck

        return user_crosscheck(self.reach, pods, label)

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
    """Backend interface."""

    name: str = "abstract"

    def verify(self, cluster: Cluster, config: VerifyConfig) -> VerifyResult:
        raise NotImplementedError


_REGISTRY: Dict[str, Callable[[], VerifierBackend]] = {}


def register_backend(name: str, factory: Callable[[], VerifierBackend]) -> None:
    _REGISTRY[name] = factory


def available_backends() -> List[str]:
    from . import device  # noqa: F401  registers the built-in "torch"

    return sorted(_REGISTRY)


def get_backend(name: str) -> VerifierBackend:
    from . import device  # noqa: F401  registers the built-in "torch"

    if name not in _REGISTRY:
        raise UnknownBackendError(
            f"unknown backend {name!r}; have {available_backends()}",
            backend=name,
        )
    return _REGISTRY[name]()


def verify(cluster: Cluster, config: Optional[VerifyConfig] = None) -> VerifyResult:
    """Verify a k8s-level cluster with the configured backend."""
    config = config or VerifyConfig()
    if config.label_relation is not None:
        raise ConfigError(
            "label_relation is the kano-mode matcher plugin; k8s-mode "
            "selectors follow the Kubernetes LabelSelector spec"
        )
    return get_backend(config.backend).verify(cluster, config)
