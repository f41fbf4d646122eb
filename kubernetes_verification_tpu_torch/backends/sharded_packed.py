"""The scale-out engine behind the plugin boundary: ``backend="sharded-packed"``.

The port of ``kubernetes_verification_tpu.backends.sharded_packed``: routes
``verify()`` through ``parallel/packed_sharded.py::sharded_packed_reach``
(bit-packed, dst-tile streaming, SPMD over a ``(pods, grants)`` mesh;
any-port and port-bitmap semantics). All six verification queries answer
here: four on the packed / aggregate forms, ``policy_shadow`` /
``policy_conflict`` through lazily computed sharded Gram masks
(``ops/tiled.py::policy_pair_masks_sharded``). The dense ``sharded``
backend remains for sizes where a full ``[N, N]`` bool result (with
per-atom ``reach_ports`` and the per-policy sets) is wanted.

The result is a :class:`ShardedPackedVerifyResult`: ``reach`` is dense only
up to ``dense_reach_limit`` pods (default 20k); the packed matrix and
aggregates stay on ``packed_result`` and answer the whole-matrix queries
either way. Every rank gets the same result; a lazy query (the pair masks,
``materialize_policy_sets``) runs collectives, so every rank asks it.

Backend options (``VerifyConfig.backend_options``): ``mesh`` (``(dp, mp)``),
``device``, ``tile`` / ``chunk`` (sweep geometry), ``keep_matrix``,
``groups_label`` (per-group in-degrees at solve time, so ``user_crosscheck``
works matrix-free), ``dense_reach_limit``, ``max_port_masks``, and for
``VerifyConfig.closure`` ``closure_tile`` and ``hbm_limit``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..encode.carry import encoding_to_arrays
from ..encode.encoder import encode_cluster
from ..models.core import Cluster, Container, KanoPolicy
from ..observe.metrics import BYTES_TRANSFERRED
from ..parallel.mesh import Mesh
from ..parallel.packed_sharded import PackedShardedResult, sharded_packed_reach
from ..resilience.errors import ConfigError
from .base import VerifierBackend, VerifyConfig, VerifyResult, register_backend
from .sharded import nbytes, resolve_mesh

__all__ = ["ShardedPackedBackend", "ShardedPackedVerifyResult"]


@dataclass
class ShardedPackedVerifyResult(VerifyResult):
    """``VerifyResult`` whose queries run on the packed / aggregate forms.

    ``reach`` is a dense bool matrix only below the dense-reach limit;
    above it ``reach`` is ``None`` and the packed-domain queries (and
    ``packed_result``) are the API, as ``ops.tiled.PackedReach`` is at
    flagship scale."""

    packed_result: Optional[PackedShardedResult] = None
    #: packed transitive closure (uint32 [N, W]) when config.closure ran —
    #: present even above the dense-reach limit where ``closure`` stays None
    closure_packed: Optional[np.ndarray] = None
    #: lazy thunk installed by the backend: () -> (shadow, conflict) bool
    #: [P, P] masks via the sharded Grams — computed on the first pairwise
    #: policy query, cached thereafter
    pair_masks_fn: Optional[Callable] = None
    _pair_masks: Optional[Tuple[np.ndarray, np.ndarray]] = None
    #: lazy thunk: () -> (src_sets, dst_sets) bool [P, N] via the sharded
    #: set build (``policy_sets_sharded``) — see materialize_policy_sets
    policy_sets_fn: Optional[Callable] = None
    #: host bytes the materialised sets would occupy (2·P·N), set by the
    #: backend so the budget check runs BEFORE any device work
    policy_sets_bytes: Optional[int] = None

    def materialize_policy_sets(
        self, max_bytes: int = 2_000_000_000
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch the per-policy src/dst edge sets (kano ``working_select`` /
        ``working_allow``) from a sharded build into ``self.src_sets`` /
        ``dst_sets`` — two host bool [P, N] arrays (2 GB at 100k pods × 10k
        policies, hence the explicit byte budget). The pairwise policy
        queries do NOT need this — they run on device Gram masks."""
        if self.src_sets is None:
            if self.policy_sets_fn is None:
                raise ConfigError("no policy-sets thunk attached to this result")
            need = self.policy_sets_bytes or 0
            if need > max_bytes:
                raise ConfigError(
                    f"policy sets need {need / 1e9:.1f} GB on host, over "
                    f"the {max_bytes / 1e9:.1f} GB budget; raise max_bytes "
                    "explicitly to fetch them anyway"
                )
            self.src_sets, self.dst_sets = self.policy_sets_fn()
            self.policy_sets_fn = None  # result cached — release the thunk
        return self.src_sets, self.dst_sets

    def release_policy_queries(self) -> None:
        """Drop the lazy pairwise / policy-set thunks. Each closes over the
        whole host ``EncodedCluster``, pinning it for the result's lifetime;
        they release themselves once their result is cached, but a caller
        that will never ask the pairwise queries can call this to let a
        large encoding go now. Materialised masks / sets stay;
        un-materialised ones raise "no thunk attached" afterwards."""
        self.pair_masks_fn = None
        self.policy_sets_fn = None

    def _pk(self) -> PackedShardedResult:
        if self.packed_result is None:
            raise ConfigError("no packed result attached")
        return self.packed_result

    def reachable(self, src: int, dst: int) -> bool:
        if self.reach is not None:
            return bool(self.reach[src, dst])
        pk = self._pk()
        if pk.packed is None:
            raise ConfigError(
                "solve ran matrix-free (keep_matrix=False): per-pair lookup "
                "needs the packed matrix; re-run with keep_matrix=True or "
                "query the aggregates"
            )
        w = pk.packed[src, dst // 32]
        return bool((np.uint32(w) >> np.uint32(dst % 32)) & np.uint32(1))

    def edges(self) -> List[Tuple[int, int]]:
        if self.reach is not None:
            return super().edges()
        s, d = np.nonzero(self._pk().to_bool())
        return list(zip(s.tolist(), d.tolist()))

    def all_reachable(self) -> List[int]:
        return self._pk().all_reachable()

    def all_isolated(self) -> List[int]:
        return self._pk().all_isolated()

    def user_crosscheck(self, containers_or_pods, label: str) -> List[int]:
        return self._pk().user_crosscheck(containers_or_pods, label)

    def system_isolation(self, idx: int) -> List[int]:
        return self._pk().system_isolation(idx)

    def _masks(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._pair_masks is None:
            if self.pair_masks_fn is None:
                raise ConfigError("no pair-mask thunk attached to this result")
            self._pair_masks = self.pair_masks_fn()
            self.pair_masks_fn = None  # result cached — release the thunk
        return self._pair_masks

    def policy_shadow(self) -> List[Tuple[int, int]]:
        """Pairwise shadow query via the sharded Gram masks: the [P, N]
        sets and their O(P²·N) products stay on the ranks' devices; only
        [P, P] masks reach the host. Lazy: the Grams run on the first
        call."""
        from ..ops.queries import _pairs

        return _pairs(self._masks()[0])

    def policy_conflict(self) -> List[Tuple[int, int]]:
        from ..ops.queries import _pairs

        return _pairs(self._masks()[1])


class ShardedPackedBackend(VerifierBackend):
    name = "sharded-packed"

    def __init__(self, mesh: Optional[Mesh] = None) -> None:
        self._mesh = mesh

    def verify(self, cluster: Cluster, config: VerifyConfig) -> VerifyResult:
        keep_matrix = config.opt("keep_matrix")
        if config.closure:
            if keep_matrix is False:
                raise ConfigError(
                    "closure needs the packed matrix; drop keep_matrix=False "
                    "or use the sharded/torch backends"
                )
            # force the matrix BEFORE the solve — the auto heuristic
            # declining it after a full sweep would discard all that work
            keep_matrix = True
        mesh = resolve_mesh(self._mesh, config)
        t0 = time.perf_counter()
        enc = encode_cluster(cluster, compute_ports=config.compute_ports)
        t1 = time.perf_counter()
        groups = None
        glabel = config.opt("groups_label")
        if glabel is not None:
            from ..ops.queries import user_groups

            groups = user_groups(cluster.pods, glabel)
        chunk = config.opt("chunk", 1024)
        pk = sharded_packed_reach(
            mesh,
            enc,
            self_traffic=config.self_traffic,
            default_allow_unselected=config.default_allow_unselected,
            direction_aware_isolation=config.direction_aware_isolation,
            tile=config.opt("tile", 512),
            chunk=chunk,
            keep_matrix=keep_matrix,
            groups=groups,
            max_port_masks=config.opt("max_port_masks"),
        )
        t2 = time.perf_counter()
        BYTES_TRANSFERRED.labels(backend=self.name).set(
            nbytes(*encoding_to_arrays(enc).values(), pk.packed)
        )
        dense_ok = pk.packed is not None and cluster.n_pods <= config.opt(
            "dense_reach_limit", 20_000
        )
        reach = pk.to_bool() if dense_ok else None
        closure = closure_packed = None
        if config.closure:
            from ..ops.bits import unpack_cols

            # closure_tile is its own knob: the sweep's "tile" shapes the
            # broadcast geometry; the squaring wants its larger default. The
            # closure rides the SAME mesh (row stripes over pods), and the
            # pre-flight guard (ClosureBudgetError) refuses what would not fit
            closure_packed = pk.closure(
                tile=config.opt("closure_tile", 7168),
                mesh=mesh,
                hbm_limit=config.opt("hbm_limit"),
            )
            if dense_ok:
                closure = unpack_cols(closure_packed, cluster.n_pods)
        t3 = time.perf_counter()
        from ..ops.tiled import policy_pair_masks_sharded, policy_sets_sharded

        dai = config.direction_aware_isolation
        return ShardedPackedVerifyResult(
            n_pods=cluster.n_pods,
            mode="k8s",
            backend=self.name,
            config=config,
            reach=reach,
            port_atoms=list(enc.atoms) if config.compute_ports else [],
            ingress_isolated=pk.ingress_isolated,
            egress_isolated=pk.egress_isolated,
            closure=closure,
            timings={
                # "solve" is the whole engine call (host prologue and sweep);
                # the sweep's own figures keep their own keys
                "encode": t1 - t0,
                "solve": t3 - t1,
                **{f"sweep_{k}": v for k, v in (pk.timings or {}).items()},
            },
            packed_result=pk,
            closure_packed=closure_packed,
            # lazy: the O(P²·N) pairwise-policy Grams run sharded on the
            # first policy_shadow / policy_conflict call, not on every verify
            pair_masks_fn=lambda: policy_pair_masks_sharded(
                mesh, enc, direction_aware_isolation=dai, chunk=chunk
            ),
            policy_sets_fn=lambda: policy_sets_sharded(
                mesh, enc, direction_aware_isolation=dai, chunk=chunk
            ),
            policy_sets_bytes=2 * enc.n_policies * cluster.n_pods,
        )

    def verify_kano(
        self,
        containers: Sequence[Container],
        policies: Sequence[KanoPolicy],
        config: VerifyConfig,
    ) -> VerifyResult:
        raise ConfigError(
            "sharded-packed is a k8s-mode engine; use the sharded backend "
            "for kano-mode scale-out"
        )


register_backend("sharded-packed", ShardedPackedBackend)
