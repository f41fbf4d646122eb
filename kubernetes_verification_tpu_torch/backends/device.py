"""The ``torch`` backend: the dense single-device solve.

The port of ``kubernetes_verification_tpu.backends.tpu.TpuBackend``: encode
on the host, move the arrays to the device once, run ``ops/reach.py``'s
``k8s_reach`` (``verify``) or the kano matrix build (``verify_kano``), close
the matrix with ``ops/closure.py::transitive_closure`` when
``VerifyConfig.closure`` asks for it, and return numpy arrays. The device is
the backend option ``("device", ...)``, default ``"cuda"``; without a CUDA
device the default raises rather than running on the CPU. The JAX backend's
dispatch tracker (under this backend's label, ``torch``) and transfer metric
are kept.
"""
from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from ..encode.encoder import encode_cluster, encode_kano, encode_kano_relation
from ..models.core import Cluster, Container, KanoPolicy
from ..observe import DispatchTracker, tree_nbytes
from ..observe.metrics import BYTES_TRANSFERRED
from ..ops.closure import transitive_closure
from ..ops.match import as_tensors, match_selectors
from ..ops.reach import KanoOut, _bool_or_matmul, k8s_reach, kano_reach
from ..runtime import resolve_device
from .base import VerifierBackend, VerifyConfig, VerifyResult, register_backend

__all__ = ["TorchBackend"]

#: first dispatches per abstract signature (kvtpu_jit_recompiles_total)
_TRACKER = DispatchTracker("torch")


def _put(dev):
    def put(x):
        return None if x is None else torch.as_tensor(x, device=dev)

    return put


def _host(x):
    return None if x is None else x.cpu().numpy()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TorchBackend(VerifierBackend):
    name = "torch"
    supports_label_relation = True

    def verify(self, cluster: Cluster, config: VerifyConfig) -> VerifyResult:
        dev = resolve_device(config.opt("device"))
        put = _put(dev)
        t0 = time.perf_counter()
        enc = encode_cluster(cluster, compute_ports=config.compute_ports)
        t1 = time.perf_counter()
        _TRACKER.track(
            "_k8s_step",
            enc,
            static=(
                config.self_traffic,
                config.default_allow_unselected,
                config.direction_aware_isolation,
                config.closure,
            ),
        )
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
        closure = transitive_closure(out.reach) if config.closure else None
        _sync(dev)
        t2 = time.perf_counter()
        BYTES_TRANSFERRED.labels(backend=self.name).set(
            tree_nbytes(enc) + tree_nbytes(out) + tree_nbytes(closure)
        )
        return VerifyResult(
            n_pods=cluster.n_pods,
            mode="k8s",
            backend=self.name,
            config=config,
            reach=_host(out.reach),
            reach_ports=_host(out.reach_ports) if config.compute_ports else None,
            port_atoms=list(enc.atoms) if config.compute_ports else [],
            src_sets=_host(out.src_sets),
            dst_sets=_host(out.dst_sets),
            selected=_host(out.selected),
            ingress_isolated=_host(out.ingress_isolated),
            egress_isolated=_host(out.egress_isolated),
            closure=_host(closure),
            timings={"encode": t1 - t0, "solve": t2 - t1},
        )

    def verify_kano(
        self,
        containers: Sequence[Container],
        policies: Sequence[KanoPolicy],
        config: VerifyConfig,
    ) -> VerifyResult:
        dev = resolve_device(config.opt("device"))
        put = _put(dev)
        t0 = time.perf_counter()
        if config.label_relation is not None:
            # each rule label became the In-mask of the vocabulary pairs the
            # relation accepts, so the plugin runs as selector matching
            enc_r = encode_kano_relation(containers, policies, config.label_relation)
            t1 = time.perf_counter()
            _TRACKER.track("_kano_relation_step", enc_r, static=(config.closure,))
            enc_bytes = tree_nbytes(enc_r)
            pod_kv, pod_key = put(enc_r.pod_kv), put(enc_r.pod_key)
            src_sets = match_selectors(as_tensors(enc_r.src_sel, dev), pod_kv, pod_key)
            dst_sets = match_selectors(as_tensors(enc_r.dst_sel, dev), pod_kv, pod_key)
            out = KanoOut(
                reach=_bool_or_matmul(src_sets, dst_sets),
                src_sets=src_sets,
                dst_sets=dst_sets,
            )
        else:
            enc = encode_kano(containers, policies)
            t1 = time.perf_counter()
            _TRACKER.track("_kano_step", enc, static=(config.closure,))
            enc_bytes = tree_nbytes(enc)
            out = kano_reach(
                put(enc.pod_kv), put(enc.src_req), put(enc.src_impossible),
                put(enc.dst_req), put(enc.dst_impossible),
            )
        closure = transitive_closure(out.reach) if config.closure else None
        _sync(dev)
        t2 = time.perf_counter()
        BYTES_TRANSFERRED.labels(backend=self.name).set(
            enc_bytes + tree_nbytes(out) + tree_nbytes(closure)
        )
        src_sets = _host(out.src_sets)
        dst_sets = _host(out.dst_sets)
        # maintain the reference's per-container policy index lists
        # (kano_py/kano/model.py:158-163)
        for i, c in enumerate(containers):
            c.select_policies.clear()
            c.allow_policies.clear()
            c.select_policies.extend(np.nonzero(src_sets[:, i])[0].tolist())
            c.allow_policies.extend(np.nonzero(dst_sets[:, i])[0].tolist())
        return VerifyResult(
            n_pods=len(containers),
            mode="kano",
            backend=self.name,
            config=config,
            reach=_host(out.reach),
            src_sets=src_sets,
            dst_sets=dst_sets,
            closure=_host(closure),
            timings={"encode": t1 - t0, "solve": t2 - t1},
        )


register_backend("torch", TorchBackend)
