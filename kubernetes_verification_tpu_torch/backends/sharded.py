"""The ``sharded`` backend: the dense solve over a ``(pods, grants)`` mesh.

The port of ``kubernetes_verification_tpu.backends.sharded``: the pod axis
splits across the ranks of a ``torch.distributed`` job, the grant stack
across the mesh's second dim, and the gathers over ``pods`` and sums over
``grants`` are NCCL collectives on the card (gloo on the CPU). Every rank
calls ``verify`` with the same cluster and gets the same result, equal to
the ``torch`` and ``cpu`` backends'.

Backend options: ``("mesh", (dp, mp))`` (default: every rank on the pod
axis; a bare int ``n`` is ``(n, 1)``) and ``("device", ...)`` (default
``cuda:<local rank>``; raises without a GPU). A job with no process group
gets a 1-rank one (``parallel/mesh.py::init_distributed``).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from ..encode.carry import encoding_to_arrays
from ..encode.encoder import encode_cluster, encode_kano
from ..models.core import Cluster, Container, KanoPolicy
from ..observe.metrics import BYTES_TRANSFERRED
from ..parallel.mesh import Mesh, mesh_for
from ..parallel.sharded_ops import sharded_k8s_reach, sharded_kano_reach
from .base import VerifierBackend, VerifyConfig, VerifyResult, register_backend

__all__ = ["ShardedBackend", "resolve_mesh"]


def resolve_mesh(mesh: Optional[Mesh], config: VerifyConfig) -> Mesh:
    """The backend's mesh, else one from the ``mesh`` and ``device``
    options (``mesh_for`` normalises None, a bare int or ``(dp, mp)``)."""
    if mesh is not None:
        return mesh
    return mesh_for(config.opt("mesh"), device=config.opt("device"))


def nbytes(*arrays) -> int:
    """Host bytes of the arrays given (``None`` counts 0)."""
    return sum(int(a.nbytes) for a in arrays if a is not None)


class ShardedBackend(VerifierBackend):
    name = "sharded"

    def __init__(self, mesh: Optional[Mesh] = None) -> None:
        self._mesh = mesh

    def verify(self, cluster: Cluster, config: VerifyConfig) -> VerifyResult:
        mesh = resolve_mesh(self._mesh, config)
        t0 = time.perf_counter()
        enc = encode_cluster(cluster, compute_ports=config.compute_ports)
        t1 = time.perf_counter()
        out, closure = sharded_k8s_reach(
            mesh,
            enc,
            self_traffic=config.self_traffic,
            default_allow_unselected=config.default_allow_unselected,
            direction_aware_isolation=config.direction_aware_isolation,
            with_closure=config.closure,
        )
        t2 = time.perf_counter()
        BYTES_TRANSFERRED.labels(backend=self.name).set(
            nbytes(*encoding_to_arrays(enc).values(), *out, closure)
        )
        return VerifyResult(
            n_pods=cluster.n_pods,
            mode="k8s",
            backend=self.name,
            config=config,
            reach=out.reach,
            reach_ports=out.reach_ports if config.compute_ports else None,
            port_atoms=list(enc.atoms) if config.compute_ports else [],
            src_sets=out.src_sets,
            dst_sets=out.dst_sets,
            selected=out.selected,
            ingress_isolated=out.ingress_isolated,
            egress_isolated=out.egress_isolated,
            closure=closure,
            timings={"encode": t1 - t0, "solve": t2 - t1},
        )

    def verify_kano(
        self,
        containers: Sequence[Container],
        policies: Sequence[KanoPolicy],
        config: VerifyConfig,
    ) -> VerifyResult:
        mesh = resolve_mesh(self._mesh, config)
        t0 = time.perf_counter()
        enc = encode_kano(containers, policies)
        t1 = time.perf_counter()
        out, closure = sharded_kano_reach(mesh, enc, with_closure=config.closure)
        t2 = time.perf_counter()
        BYTES_TRANSFERRED.labels(backend=self.name).set(
            nbytes(enc.pod_kv, enc.src_req, enc.dst_req, *out, closure)
        )
        # maintain the reference's per-container policy index lists
        # (kano_py/kano/model.py:158-163)
        for i, c in enumerate(containers):
            c.select_policies.clear()
            c.allow_policies.clear()
            c.select_policies.extend(np.nonzero(out.src_sets[:, i])[0].tolist())
            c.allow_policies.extend(np.nonzero(out.dst_sets[:, i])[0].tolist())
        return VerifyResult(
            n_pods=len(containers),
            mode="kano",
            backend=self.name,
            config=config,
            reach=out.reach,
            src_sets=out.src_sets,
            dst_sets=out.dst_sets,
            closure=closure,
            timings={"encode": t1 - t0, "solve": t2 - t1},
        )


register_backend("sharded", ShardedBackend)
