"""Shared helpers of the serving-plane parity tests: one seeded cluster in
both packages, the JAX package's events carried into the port through the
JSONL codec (encoded by one package, decoded by the other), both packages'
services on the CPU, and the comparisons the tests hold them to."""
import types

import numpy as np

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.harness.generate import (
    random_event_stream as jax_random_event_stream,
)
from kubernetes_verification_tpu.packed_incremental import (
    PackedIncrementalVerifier as JaxPacked,
)
from kubernetes_verification_tpu.serve import events as jev
from kubernetes_verification_tpu.serve import service as jax_service
from kubernetes_verification_tpu_torch.observe import events as port_observe_events
from kubernetes_verification_tpu_torch.serve import VerificationService as PortService
from kubernetes_verification_tpu_torch.serve import events as pev
from torch_parity import to_jax, words

#: the toy cluster of the serving tests (96 pods, 14 policies, 4 namespaces)
GEN = dict(n_pods=96, n_policies=14, n_namespaces=4, seed=5)
ANY_PORT = dict(compute_ports=False)


def clusters(**gen):
    """``(port_cluster, jax_cluster)``: one generated cluster, the JAX side
    ``to_jax`` of the port's."""
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**dict(GEN, **gen)))
    return cluster, to_jax(cluster)


def to_port_events(jax_events):
    """The JAX package's events as the port's, through the JSONL codec."""
    return [pev.decode_event(jev.encode_event(e)) for e in jax_events]


def streams(jax_cluster, n_events, seed, p_resync=0.0):
    """``(port_events, jax_events)`` of one JAX ``random_event_stream``."""
    jevents = jax_random_event_stream(
        jax_cluster, n_events=n_events, seed=seed, p_resync=p_resync
    )
    return to_port_events(jevents), jevents


def dense_services(pcluster, jcluster, pserve=None, jserve=None):
    """The dense service of each package on the same cluster (CPU)."""
    psvc = PortService(pcluster, kvt.VerifyConfig(**ANY_PORT),
                       serve_config=pserve, device="cpu")
    jsvc = jax_service.VerificationService(
        jcluster, jkv.VerifyConfig(**ANY_PORT), serve_config=jserve
    )
    return psvc, jsvc


def packed_services(pcluster, jcluster, pserve=None, jserve=None):
    """The packed service (``keep_matrix=True``) of each package (CPU)."""
    peng = kvt.PackedIncrementalVerifier(
        pcluster, kvt.VerifyConfig(**ANY_PORT), device="cpu", keep_matrix=True
    )
    jeng = JaxPacked(jcluster, jkv.VerifyConfig(**ANY_PORT), keep_matrix=True)
    return (PortService(engine=peng, serve_config=pserve),
            jax_service.VerificationService(engine=jeng, serve_config=jserve))


def violation_lines(vs):
    return [v.describe() for v in vs]


def assert_services_equal(psvc, jsvc, where=""):
    """``reach`` (and the packed words), ``generation``, ``ServeStats`` and
    the violations of the two services are equal. ``reach()`` is asked of
    both, so it counts as one solve on each side."""
    np.testing.assert_array_equal(psvc.reach(), jsvc.reach(), err_msg=where)
    if psvc.packed:
        assert jsvc.packed, where
        np.testing.assert_array_equal(
            words(psvc.engine._packed), np.asarray(jsvc.engine._packed),
            err_msg=where)
    assert psvc.generation == jsvc.generation, where
    assert psvc.stats.to_dict() == jsvc.stats.to_dict(), where
    assert violation_lines(psvc.violations) == violation_lines(jsvc.violations), where


class FakeClock(port_observe_events.Clock):
    """A deterministic clock for the port (``observe.events.set_clock``) and,
    through :meth:`time_module`, for the JAX service's ``time.monotonic``."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def perf(self) -> float:
        return self.t

    def wall(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

    def time_module(self):
        import time

        return types.SimpleNamespace(
            monotonic=lambda: self.t, sleep=time.sleep,
            perf_counter=time.perf_counter, time=time.time,
        )


def install_clock(monkeypatch, jsvc=None) -> FakeClock:
    """One fake clock for both packages' staleness and breaker reads: the
    port's shared clock, the JAX service module's ``time`` and, given a JAX
    service, its breaker's clock."""
    clock = FakeClock()
    monkeypatch.setattr(port_observe_events, "_clock", clock)
    monkeypatch.setattr(jax_service, "time", clock.time_module())
    if jsvc is not None and jsvc._breaker is not None:
        monkeypatch.setattr(jsvc._breaker, "_clock", lambda: clock.t)
    return clock
