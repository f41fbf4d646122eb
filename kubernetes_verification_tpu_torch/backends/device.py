"""The ``torch`` backend: the dense single-device solve.

The port of ``kubernetes_verification_tpu.backends.tpu.TpuBackend.verify``:
encode on the host, move the arrays to the device once, run
``ops/reach.py::k8s_reach``, and return numpy arrays. The device is the
backend option ``("device", ...)``, default ``"cuda"``; without a CUDA device
the default raises rather than running on the CPU.
"""
from __future__ import annotations

import time

import torch

from ..encode.encoder import encode_cluster
from ..models.core import Cluster
from ..ops.match import as_tensors
from ..ops.reach import k8s_reach
from ..resilience.errors import ConfigError
from ..runtime import resolve_device
from .base import VerifierBackend, VerifyConfig, VerifyResult, register_backend

__all__ = ["TorchBackend"]


class TorchBackend(VerifierBackend):
    name = "torch"

    def verify(self, cluster: Cluster, config: VerifyConfig) -> VerifyResult:
        if config.closure:
            raise ConfigError(
                "closure=True: the transitive closure is not ported yet "
                "(ROADMAP.md, 'Modules to port': the packed closure, then the "
                "dense closure)"
            )
        dev = resolve_device(config.opt("device"))
        t0 = time.perf_counter()
        enc = encode_cluster(cluster, compute_ports=config.compute_ports)
        t1 = time.perf_counter()

        def put(x):
            return None if x is None else torch.as_tensor(x, device=dev)

        out = k8s_reach(
            put(enc.pod_kv), put(enc.pod_key), put(enc.pod_ns),
            put(enc.ns_kv), put(enc.ns_key),
            as_tensors(enc.pol_sel, dev), put(enc.pol_ns),
            put(enc.pol_affects_ingress), put(enc.pol_affects_egress),
            as_tensors(enc.ingress, dev), as_tensors(enc.egress, dev),
            put(enc.restrict_bank),
            self_traffic=config.self_traffic,
            default_allow_unselected=config.default_allow_unselected,
            direction_aware_isolation=config.direction_aware_isolation,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()

        def host(x):
            return x.cpu().numpy()

        return VerifyResult(
            n_pods=cluster.n_pods,
            mode="k8s",
            backend=self.name,
            config=config,
            reach=host(out.reach),
            reach_ports=host(out.reach_ports) if config.compute_ports else None,
            port_atoms=list(enc.atoms) if config.compute_ports else [],
            src_sets=host(out.src_sets),
            dst_sets=host(out.dst_sets),
            selected=host(out.selected),
            ingress_isolated=host(out.ingress_isolated),
            egress_isolated=host(out.egress_isolated),
            closure=None,
            timings={"encode": t1 - t0, "solve": t2 - t1},
        )

    def verify_kano(self, containers, policies, config: VerifyConfig):
        raise ConfigError(
            "kano mode is not ported yet (ROADMAP.md, 'Modules to port': "
            "verify_kano)"
        )


register_backend("torch", TorchBackend)
