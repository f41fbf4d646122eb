"""Native packed-bitset backend (``backend="native"``).

The port's copy of ``kubernetes_verification_tpu.backends.native``: the
host-side production engine over the port's own encoder and model objects,
with the hot loops in the port's copy of the C++ kernels
(``native/bitset.cpp``) over 64-bit packed words — the role the third-party
``bitarray`` extension plays in the reference
(``kano_py/kano/model.py:128-163``), owned and OpenMP-threaded. Per-word bit
ops replace the count-matmuls:

* selector matching → packed subset / disjoint / any-intersect scans;
* the reach contraction → ``or_scatter`` (for each grant, OR the destination
  set into every source row);
* closure → packed Warshall;
* default-allow / self-traffic → row-mask ORs and diagonal sets.

It runs on the host where it is called and needs no device. Differentially
identical to ``cpu``, ``torch`` and the JAX package's ``native``
(``tests/test_torch_native.py``). Unavailable (and unregistered) when no C++
compiler exists.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..encode.encoder import (
    EncodedCluster,
    GrantBlock,
    SelectorEnc,
    encode_cluster,
    encode_kano,
)
from ..models.core import Cluster, Container, KanoPolicy
from ..native.binding import BitMatrix, pack, words
from ..observe import Phases
from ..observe.introspect import publish_host_estimate
from ..observe.metrics import BYTES_TRANSFERRED
from .base import (
    VerifierBackend,
    VerifyConfig,
    VerifyResult,
    register_backend,
)

__all__ = ["NativeBackend"]


def _match_selectors(sel: SelectorEnc, kv_bm: BitMatrix, key_bm: BitMatrix) -> np.ndarray:
    """Packed-scan evaluation of a compiled selector stack — semantics of
    ``ops/match.py:match_selectors`` word-by-word instead of by matmul."""
    ok = BitMatrix.from_bool(sel.req_eq).subset_of(kv_bm)
    ok &= BitMatrix.from_bool(sel.req_key).subset_of(key_bm)
    ok &= BitMatrix.from_bool(sel.forbid_eq).disjoint_from(kv_bm)
    ok &= BitMatrix.from_bool(sel.forbid_key).disjoint_from(key_bm)
    S, E, V = sel.in_mask.shape
    for e in range(E):
        hits = BitMatrix.from_bool(sel.in_mask[:, e, :]).intersects(kv_bm)
        ok &= hits | ~sel.in_valid[:, e][:, None]
    return ok & ~sel.impossible[:, None]


def _grant_peers(
    block: GrantBlock,
    kv_bm: BitMatrix,
    key_bm: BitMatrix,
    ns_kv_bm: BitMatrix,
    ns_key_bm: BitMatrix,
    pod_ns: np.ndarray,
    pol_ns: np.ndarray,
) -> np.ndarray:
    pod_ok = _match_selectors(block.pod_sel, kv_bm, key_bm)
    ns_sel_ok = _match_selectors(block.ns_sel, ns_kv_bm, ns_key_bm)  # [G, M]
    same_ns = pol_ns[block.pol][:, None] == pod_ns[None, :]
    if ns_sel_ok.shape[1]:
        ns_by_pod = ns_sel_ok[:, pod_ns]
    else:  # no namespaces: only same-ns scope can hold
        ns_by_pod = np.zeros_like(same_ns)
    ns_ok = np.where(block.ns_sel_null[:, None], same_ns, ns_by_pod)
    ok = pod_ok & ns_ok
    if block.ip_match is not None:
        ok = np.where(block.is_ipblock[:, None], block.ip_match, ok)
    else:
        ok &= ~block.is_ipblock[:, None]
    return ok | block.match_all[:, None]


def _segment_or_packed(rows: np.ndarray, seg: np.ndarray, n_seg: int) -> np.ndarray:
    """OR packed rows [G, W] into [n_seg, W] by segment id."""
    out = np.zeros((n_seg, rows.shape[1]), dtype=np.uint64)
    np.bitwise_or.at(out, seg, rows)
    return out


class NativeBackend(VerifierBackend):
    name = "native"

    # ------------------------------------------------------------------ kano
    def verify_kano(
        self,
        containers: Sequence[Container],
        policies: Sequence[KanoPolicy],
        config: VerifyConfig,
    ) -> VerifyResult:
        ph = Phases()
        with ph("encode"):
            enc = encode_kano(containers, policies)
        with ph("compile", backend=self.name):
            kv_bm = BitMatrix.from_bool(enc.pod_kv)
        with ph("solve", backend=self.name):
            src_sets = (
                BitMatrix.from_bool(enc.src_req).subset_of(kv_bm)
                & ~enc.src_impossible[:, None]
            )
            dst_sets = (
                BitMatrix.from_bool(enc.dst_req).subset_of(kv_bm)
                & ~enc.dst_impossible[:, None]
            )
            n = len(containers)
            reach_bm = BitMatrix.zeros(n, n)
            reach_bm.or_scatter_into(
                BitMatrix.from_bool(src_sets), BitMatrix.from_bool(dst_sets)
            )
            closure = None
            if config.closure:
                cbm = BitMatrix(reach_bm.data.copy(), n)
                cbm.closure_inplace()
                closure = cbm.to_bool()
            reach = reach_bm.to_bool()
        BYTES_TRANSFERRED.labels(backend=self.name).set(0)  # host C++ engine
        # analytic host estimate: subset-match over packed words plus the
        # rank-1 OR-scatter into the packed n x n matrix (64 pods per word)
        publish_host_estimate(
            self.name,
            "verify_kano",
            flops=2 * len(policies) * n * words(n) + n * words(n),
            bytes_accessed=8 * (2 * len(policies) + n) * words(n),
            output_bytes=reach.nbytes,
            signature=(n, len(policies)),
        )
        for i, c in enumerate(containers):
            c.select_policies.clear()
            c.allow_policies.clear()
            c.select_policies.extend(np.nonzero(src_sets[:, i])[0].tolist())
            c.allow_policies.extend(np.nonzero(dst_sets[:, i])[0].tolist())
        return VerifyResult(
            n_pods=n,
            mode="kano",
            backend=self.name,
            config=config,
            reach=reach,
            src_sets=src_sets,
            dst_sets=dst_sets,
            closure=closure,
            timings=ph.timings,
        )

    # ------------------------------------------------------------------- k8s
    def verify(self, cluster: Cluster, config: VerifyConfig) -> VerifyResult:
        ph = Phases()
        with ph("encode"):
            enc = encode_cluster(cluster, compute_ports=config.compute_ports)
        n, P = enc.n_pods, enc.n_policies
        Q = len(enc.atoms)
        W = words(n)

        with ph("compile", backend=self.name):
            kv_bm = BitMatrix.from_bool(enc.pod_kv)
            key_bm = BitMatrix.from_bool(enc.pod_key)
            ns_kv_bm = BitMatrix.from_bool(enc.ns_kv)
            ns_key_bm = BitMatrix.from_bool(enc.ns_key)

        with ph("solve", backend=self.name):
            selected = _match_selectors(enc.pol_sel, kv_bm, key_bm)
            selected &= enc.pol_ns[:, None] == enc.pod_ns[None, :]
            if config.direction_aware_isolation:
                sel_ing = selected & enc.pol_affects_ingress[:, None]
                sel_eg = selected & enc.pol_affects_egress[:, None]
            else:
                sel_ing = selected
                sel_eg = selected
            ing_iso = sel_ing.any(axis=0)
            eg_iso = sel_eg.any(axis=0)

            ing_peers = _grant_peers(
                enc.ingress, kv_bm, key_bm, ns_kv_bm, ns_key_bm, enc.pod_ns, enc.pol_ns
            )
            eg_peers = _grant_peers(
                enc.egress, kv_bm, key_bm, ns_kv_bm, ns_key_bm, enc.pod_ns, enc.pol_ns
            )
            ing_targets = sel_ing[enc.ingress.pol]  # [G, N]
            eg_targets = sel_eg[enc.egress.pol]
            # named-port resolution: AND each grant's dst-restriction bank row
            # into its dst-side operand (ingress dst = targets, egress dst =
            # peers); the unrestricted eg_peers still feed the edge sets below
            eg_peers_dst = eg_peers
            if enc.ingress.dst_restrict is not None:
                ing_targets = ing_targets & enc.restrict_bank[enc.ingress.dst_restrict]
            if enc.egress.dst_restrict is not None:
                eg_peers_dst = eg_peers & enc.restrict_bank[enc.egress.dst_restrict]

            ing_peers_p = pack(ing_peers) if ing_peers.size else np.zeros((0, W), np.uint64)
            ing_targets_p = pack(ing_targets) if ing_targets.size else np.zeros((0, W), np.uint64)
            eg_peers_p = pack(eg_peers) if eg_peers.size else np.zeros((0, W), np.uint64)
            eg_peers_dst_p = (
                pack(eg_peers_dst) if eg_peers_dst.size else np.zeros((0, W), np.uint64)
            )
            eg_targets_p = pack(eg_targets) if eg_targets.size else np.zeros((0, W), np.uint64)

            not_ing_iso_row = pack(~ing_iso[None, :])[0]
            ones_row = pack(np.ones((1, n), dtype=bool))[0]
            all_pods = np.ones(n, dtype=np.uint8)

            reach_bm = BitMatrix.zeros(n, n)
            reach_pq = (
                np.zeros((n, n, Q), dtype=bool) if config.compute_ports else None
            )
            for q in range(Q):
                gi = np.nonzero(enc.ingress.ports[:, q])[0]
                ge = np.nonzero(enc.egress.ports[:, q])[0]
                ing_q = BitMatrix.zeros(n, n)  # rows: src over dst
                ing_q.or_scatter_into(
                    BitMatrix(np.ascontiguousarray(ing_peers_p[gi]), n),
                    BitMatrix(np.ascontiguousarray(ing_targets_p[gi]), n),
                )
                eg_q = BitMatrix.zeros(n, n)
                eg_q.or_scatter_into(
                    BitMatrix(np.ascontiguousarray(eg_targets_p[ge]), n),
                    BitMatrix(np.ascontiguousarray(eg_peers_dst_p[ge]), n),
                )
                if config.default_allow_unselected:
                    # unselected dst accept from anyone; unselected src send anywhere
                    ing_q.row_or_mask(all_pods, not_ing_iso_row)
                    eg_q.row_or_mask((~eg_iso).astype(np.uint8), ones_row)
                rq = ing_q.and_with(eg_q)
                if config.self_traffic:
                    rq.set_diagonal()
                reach_bm.or_into(rq)
                if reach_pq is not None:
                    reach_pq[:, :, q] = rq.to_bool()
            reach = reach_bm.to_bool()

            closure = None
            if config.closure:
                cbm = BitMatrix(reach_bm.data.copy(), n)
                cbm.closure_inplace()
                closure = cbm.to_bool()

            # per-policy src/dst edge sets (kernel formulas, ops/reach.py:186-202)
            n_seg = P + 1
            seg_i = enc.ingress.pol.astype(np.int64)
            seg_e = enc.egress.pol.astype(np.int64)
            ing_src = _segment_or_packed(ing_peers_p, seg_i, n_seg)[:P]
            eg_dst = _segment_or_packed(eg_peers_p, seg_e, n_seg)[:P]
            ing_src = (
                BitMatrix(ing_src, n).to_bool() if P else np.zeros((0, n), bool)
            )
            eg_dst = BitMatrix(eg_dst, n).to_bool() if P else np.zeros((0, n), bool)
            has_ing = np.zeros(P, dtype=bool)
            has_eg = np.zeros(P, dtype=bool)
            np.logical_or.at(has_ing, seg_i[seg_i < P], True)
            np.logical_or.at(has_eg, seg_e[seg_e < P], True)
            if config.direction_aware_isolation:
                ing_src &= enc.pol_affects_ingress[:, None]
                eg_dst &= enc.pol_affects_egress[:, None]
            src_sets = ing_src | (sel_eg & has_eg[:, None])
            dst_sets = eg_dst | (sel_ing & has_ing[:, None])

        BYTES_TRANSFERRED.labels(backend=self.name).set(0)  # host C++ engine
        # analytic host estimate: grant evaluation + packed [n, n, Q]
        # combine, word-parallel over 64-pod lanes
        n_grants = len(enc.ingress.pol) + len(enc.egress.pol)
        n_q = len(enc.atoms) if config.compute_ports else 1
        publish_host_estimate(
            self.name,
            "verify_k8s",
            flops=(n_grants + 3 * n) * n_q * words(n),
            bytes_accessed=8 * (n_grants + 3 * n) * n_q * words(n),
            output_bytes=reach.nbytes
            + (reach_pq.nbytes if reach_pq is not None else 0),
            signature=(n, P, n_q),
        )

        return VerifyResult(
            n_pods=n,
            mode="k8s",
            backend=self.name,
            config=config,
            reach=reach,
            reach_ports=reach_pq,
            port_atoms=list(enc.atoms) if config.compute_ports else [],
            src_sets=src_sets,
            dst_sets=dst_sets,
            selected=selected,
            ingress_isolated=ing_iso,
            egress_isolated=eg_iso,
            closure=closure,
            timings=ph.timings,
        )


register_backend("native", NativeBackend)
