"""The port's ``VerificationService`` against the JAX package's, on the CPU,
over the same event stream (the JAX generator's, carried into the port
through the JSONL codec): after every batch ``reach`` and the packed words,
``generation``, ``ServeStats`` and the assertion violations are equal, on
the dense and the packed engine, ``FullResync`` rebuilds included. Also the
threaded worker, staleness solves driven by an injected clock, and the
circuit breaker under an injected ``BackendError``: a CPU service answers
from the CPU oracle as the JAX service does, a card service raises.
Exact: every compared value is boolean or integer."""
import json
import threading

import numpy as np
import pytest

import kubernetes_verification_tpu.incremental as jax_incremental
import kubernetes_verification_tpu_torch as kvt
import kubernetes_verification_tpu_torch.incremental as port_incremental
from kubernetes_verification_tpu.observe import metrics as jax_metrics
from kubernetes_verification_tpu.resilience.errors import DeviceLost as JaxDeviceLost
from kubernetes_verification_tpu.resilience.errors import ServeError as JaxServeError
from kubernetes_verification_tpu.serve import queries as jax_queries
from kubernetes_verification_tpu.serve import service as jax_service
from kubernetes_verification_tpu_torch.observe import metrics as port_metrics
from kubernetes_verification_tpu_torch.resilience.errors import BackendError, DeviceLost, ServeError
from kubernetes_verification_tpu_torch.serve import events as pev
from kubernetes_verification_tpu_torch.serve import queries as port_queries
from kubernetes_verification_tpu_torch.serve import service as port_service
from torch_serve_parity import (
    assert_services_equal,
    clusters,
    dense_services,
    install_clock,
    packed_services,
    streams,
)

_BATCH = 40


@pytest.fixture(scope="module")
def setup():
    pcluster, jcluster = clusters()
    pevents, jevents = streams(jcluster, 240, seed=9, p_resync=0.02)
    assert any(e.kind == "full_resync" for e in jevents)
    return pcluster, jcluster, pevents, jevents


def _assertion_file(tmp_path):
    doc = [
        {"name": "ns0-internal", "kind": "allow",
         "from": {"namespace": "ns0"}, "to": {"namespace": "ns0"}},
        {"name": "no-ns1-to-ns2", "kind": "deny",
         "from": {"namespace": "ns1"}, "to": {"namespace": "ns2"}},
        {"name": "pod3-alone", "kind": "deny",
         "from": {"namespace": "ns3", "name": "pod3"}, "to": {"labels": {"zone": "theta"}}},
    ]
    path = tmp_path / "assert.json"
    path.write_text(json.dumps(doc))
    return str(path)


def _run_stream(psvc, jsvc, pevents, jevents, where):
    for i in range(0, len(pevents), _BATCH):
        n_p = psvc.apply(pevents[i:i + _BATCH])
        n_j = jsvc.apply(jevents[i:i + _BATCH])
        assert n_p == n_j
        assert_services_equal(psvc, jsvc, f"{where} batch {i // _BATCH}")


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_service_equals_jax_after_every_batch(setup, tmp_path, kind):
    pcluster, jcluster, pevents, jevents = setup
    build = dense_services if kind == "dense" else packed_services
    psvc, jsvc = build(pcluster, jcluster)
    path = _assertion_file(tmp_path)
    psvc.assertions = port_queries.load_assertions(path)
    jsvc.assertions = jax_queries.load_assertions(path)
    assert_services_equal(psvc, jsvc, f"{kind} build")
    _run_stream(psvc, jsvc, pevents, jevents, kind)
    assert psvc.stats.total_solves < psvc.stats.events_seen
    assert psvc.stats.solves.get("assertion_rows", 0) > 0
    assert type(psvc.engine).__name__ == type(jsvc.engine).__name__
    if kind == "packed":  # a resync rebuilt the same engine kind and mode
        assert psvc.engine._packed is not None
    assert psvc.health() == jsvc.health()


def test_rejected_event_names_its_index_alike(setup):
    pcluster, jcluster, pevents, jevents = setup
    psvc, jsvc = dense_services(pcluster, jcluster)
    bad = '{"event": "update_pod_labels", "namespace": "ns0", "pod": "ghost", "labels": {}}'
    from kubernetes_verification_tpu.serve import events as jev

    batch_p = pevents[:5] + [pev.decode_event(bad)]
    batch_j = jevents[:5] + [jev.decode_event(bad)]
    with pytest.raises(ServeError) as ep:
        psvc.apply(batch_p)
    with pytest.raises(JaxServeError) as ej:
        jsvc.apply(batch_j)
    assert ep.value.event_index == ej.value.event_index
    assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_threaded_worker_equals_jax(setup, kind):
    """Behind the worker thread the batches a flush drains depend on timing,
    so the per-flush comparison is of what does not: the reach after every
    flush and the events seen."""
    pcluster, jcluster, pevents, jevents = setup
    build = dense_services if kind == "dense" else packed_services
    psvc, jsvc = build(pcluster, jcluster)
    psvc.start()
    jsvc.start()
    worker = psvc._worker
    try:
        for i in range(0, len(pevents), 60):
            psvc.submit(pevents[i:i + 60])
            jsvc.submit(jevents[i:i + 60])
            psvc.flush(timeout=120)
            jsvc.flush(timeout=120)
            np.testing.assert_array_equal(psvc.reach(), jsvc.reach())
            assert psvc.stats.events_seen == jsvc.stats.events_seen == min(i + 60, len(pevents))
            s = psvc.stats
            assert s.events_applied + s.events_coalesced == s.events_seen
    finally:
        psvc.close()
        jsvc.close()
    assert not worker.is_alive()
    assert isinstance(worker, threading.Thread)


def test_staleness_solves_by_injected_clock(setup, monkeypatch):
    pcluster, jcluster, pevents, jevents = setup
    psvc, jsvc = dense_services(
        pcluster, jcluster,
        port_service.ServeConfig(staleness_bound=5.0),
        jax_service.ServeConfig(staleness_bound=5.0),
    )
    clock = install_clock(monkeypatch, jsvc)
    for k, i in enumerate(range(0, 120, _BATCH)):
        psvc.apply(pevents[i:i + _BATCH])
        jsvc.apply(jevents[i:i + _BATCH])
        clock.advance(4.0)
        for svc in (psvc, jsvc):
            svc._maybe_staleness_solve()  # 4 s old: under the bound
        assert psvc.stats.solves.get("staleness", 0) == k
        clock.advance(1.5)
        for svc in (psvc, jsvc):
            svc._maybe_staleness_solve()  # 5.5 s old: solved
        assert psvc.stats.solves.get("staleness", 0) == k + 1
        assert psvc.stats.to_dict() == jsvc.stats.to_dict()
        assert port_metrics.SERVE_STALENESS_SECONDS.value == \
            jax_metrics.SERVE_STALENESS_SECONDS.value == 5.5
        for svc in (psvc, jsvc):
            svc._maybe_staleness_solve()  # clean now: nothing to do
        assert psvc.stats.to_dict() == jsvc.stats.to_dict()
    np.testing.assert_array_equal(psvc.engine._reach, jsvc.engine._reach)


def test_worker_runs_the_staleness_solve(setup, monkeypatch):
    """The worker thread's idle poll solves a stale state once the injected
    clock passes the bound (the wait below is for the thread, not for
    time to pass)."""
    pcluster, jcluster, pevents, _ = setup
    psvc = port_service.VerificationService(
        pcluster, kvt.VerifyConfig(compute_ports=False),
        serve_config=port_service.ServeConfig(staleness_bound=60.0), device="cpu")
    clock = install_clock(monkeypatch)
    psvc.start()
    try:
        psvc.submit(pevents[:_BATCH])
        psvc.flush(timeout=120)
        assert "staleness" not in psvc.stats.solves
        clock.advance(61.0)
        done = threading.Event()
        for _ in range(2000):
            if psvc.stats.solves.get("staleness"):
                done.set()
                break
            done.wait(0.005)
        assert done.is_set()
    finally:
        psvc.close()
    assert psvc.stats.solves == {"staleness": 1}


class _Injected:
    """Wraps an engine's ``_derive_reach``: raises ``err`` while ``on``."""

    def __init__(self, real, err):
        self.real, self.err, self.on, self.calls = real, err, False, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        if self.on:
            raise self.err("injected device loss")
        return self.real(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.real, name)


def test_breaker_and_fallback_under_injected_backend_errors(setup, monkeypatch):
    pcluster, jcluster, pevents, jevents = setup
    psvc, jsvc = dense_services(
        pcluster, jcluster,
        port_service.ServeConfig(breaker_threshold=3, breaker_cooldown=30.0),
        jax_service.ServeConfig(breaker_threshold=3, breaker_cooldown=30.0),
    )
    clock = install_clock(monkeypatch, jsvc)
    p_inj = _Injected(port_incremental._derive_reach, DeviceLost)
    j_inj = _Injected(jax_incremental._derive_reach, JaxDeviceLost)
    monkeypatch.setattr(port_incremental, "_derive_reach", p_inj)
    monkeypatch.setattr(jax_incremental, "_derive_reach", j_inj)
    fb = dict(from_backend="serve-dense", to_backend="cpu")
    p0 = port_metrics.FALLBACKS_TOTAL.labels(**fb).value
    j0 = jax_metrics.FALLBACKS_TOTAL.labels(**fb).value
    batches = [(pevents[i:i + 30], jevents[i:i + 30]) for i in range(0, 240, 30)]
    # three failing solves open the breaker; the fourth never tries the engine
    p_inj.on = j_inj.on = True
    for k, (bp, bj) in enumerate(batches[:4]):
        psvc.apply(bp)
        jsvc.apply(bj)
        oracle = kvt.verify(psvc.engine.as_cluster(),
                            kvt.VerifyConfig(backend="cpu", compute_ports=False)).reach
        assert_services_equal(psvc, jsvc, f"failing batch {k}")
        np.testing.assert_array_equal(psvc.reach(), oracle)
        assert p_inj.calls == j_inj.calls == min(k + 1, 3)
    assert psvc._breaker.state == jsvc._breaker.state == "open"
    assert psvc.stats.solves["fallback"] == 4
    # the breaker stays open inside the cooldown, even with a healthy engine
    p_inj.on = j_inj.on = False
    clock.advance(29.0)
    psvc.apply(batches[4][0])
    jsvc.apply(batches[4][1])
    assert_services_equal(psvc, jsvc, "open, inside the cooldown")
    assert p_inj.calls == j_inj.calls == 3
    # past the cooldown one half-open probe succeeds and closes it
    clock.advance(2.0)
    for k, (bp, bj) in enumerate(batches[5:]):
        psvc.apply(bp)
        jsvc.apply(bj)
        assert_services_equal(psvc, jsvc, f"recovered batch {k}")
    assert psvc._breaker.transitions == jsvc._breaker.transitions == [
        "open", "half_open", "closed"]
    assert psvc.stats.solves["fallback"] == 5
    assert port_metrics.FALLBACKS_TOTAL.labels(**fb).value - p0 == 5
    assert jax_metrics.FALLBACKS_TOTAL.labels(**fb).value - j0 == 5
    np.testing.assert_array_equal(
        psvc.reach(),
        kvt.verify(psvc.engine.as_cluster(),
                   kvt.VerifyConfig(backend="cpu", compute_ports=False)).reach)


def test_card_service_raises_instead_of_falling_back(setup, monkeypatch):
    """A service whose engine lives on the card never answers from the
    host: each failed derivation reaches the caller, the breaker opens and
    then fails fast without running the engine, and past the cooldown one
    probe closes it. Here the engine is on the CPU and the service is told
    it is not, which is all the service reads of where its engine lives."""
    pcluster, _, pevents, _ = setup
    psvc = port_service.VerificationService(
        pcluster, kvt.VerifyConfig(compute_ports=False),
        serve_config=port_service.ServeConfig(breaker_threshold=3, breaker_cooldown=30.0),
        device="cpu")
    assert psvc._host_fallback
    psvc._host_fallback = False
    clock = install_clock(monkeypatch)
    inj = _Injected(port_incremental._derive_reach, DeviceLost)
    monkeypatch.setattr(port_incremental, "_derive_reach", inj)
    fb = dict(from_backend="serve-dense", to_backend="cpu")
    f0 = port_metrics.FALLBACKS_TOTAL.labels(**fb).value
    inj.on = True
    for k in range(3):
        psvc.apply(pevents[30 * k:30 * (k + 1)])
        with pytest.raises(DeviceLost):
            psvc.reach()
        assert inj.calls == k + 1
    assert psvc._breaker.state == "open"
    with pytest.raises(BackendError) as e:
        psvc.reach()
    assert e.value.kind == "breaker_open" and e.value.transient
    with pytest.raises(BackendError):  # the query plane takes the same ladder
        port_queries.QueryEngine(psvc).can_reach_batch(
            [(f"{p.namespace}/{p.name}", f"{p.namespace}/{p.name}") for p in pcluster.pods[:4]])
    assert inj.calls == 3
    inj.on = False
    clock.advance(31.0)
    np.testing.assert_array_equal(
        psvc.reach(),
        kvt.verify(psvc.engine.as_cluster(),
                   kvt.VerifyConfig(backend="cpu", compute_ports=False)).reach)
    assert psvc._breaker.transitions == ["open", "half_open", "closed"]
    assert "fallback" not in psvc.stats.solves
    assert psvc._fallback_reach is None
    assert port_metrics.FALLBACKS_TOTAL.labels(**fb).value == f0


def test_posture_service_reach_counts_no_solve_like_the_jax_service(setup):
    """With posture on, each publish packs the generation's reach words; the
    port's dense engine adopts them where the JAX engine derives ``reach``,
    so ``reach`` counts no solve in either package and the answers agree."""
    pcluster, jcluster, pevents, jevents = setup
    psvc, jsvc = dense_services(pcluster, jcluster)
    psvc.enable_posture()
    jsvc.enable_posture()
    for i in range(0, 120, 30):
        psvc.apply(pevents[i:i + 30])
        jsvc.apply(jevents[i:i + 30])
        assert psvc.engine.reach_clean and psvc.engine._reach is None, i
        np.testing.assert_array_equal(psvc.reach(), jsvc.reach())
        assert psvc.stats.solves == jsvc.stats.solves == {}, i
    psvc.close()
    jsvc.close()


def test_card_posture_service_raises_from_the_words_unpack(setup, monkeypatch):
    """A posture service's ``reach`` unpacks the adopted words on its
    engine's device: a fault there reaches the caller as a ``BackendError``
    through the breaker, which opens after three and then fails fast
    without touching the engine; past the cooldown a probe closes it, and
    no solve is counted. The service is told its CPU engine is on the card,
    as in ``test_card_service_raises_instead_of_falling_back``."""
    pcluster, _, pevents, _ = setup
    psvc = port_service.VerificationService(
        pcluster, kvt.VerifyConfig(compute_ports=False),
        serve_config=port_service.ServeConfig(breaker_threshold=3, breaker_cooldown=30.0),
        device="cpu")
    psvc._host_fallback = False
    psvc.enable_posture()
    clock = install_clock(monkeypatch)
    calls = [0]

    def lost():
        calls[0] += 1
        raise DeviceLost("forced device loss", backend="dense")

    for k in range(3):
        psvc.apply(pevents[30 * k:30 * (k + 1)])
        assert psvc.engine.reach_clean and psvc.engine._reach is None
        psvc.engine._unpack_reach_words = lost  # after the apply: a resync replaces the engine
        with pytest.raises(DeviceLost):
            psvc.reach()
        assert calls[0] == k + 1
    assert psvc._breaker.state == "open"
    with pytest.raises(BackendError) as e:
        psvc.reach()
    assert e.value.kind == "breaker_open" and calls[0] == 3
    del psvc.engine._unpack_reach_words
    clock.advance(31.0)
    np.testing.assert_array_equal(
        psvc.reach(),
        kvt.verify(psvc.engine.as_cluster(),
                   kvt.VerifyConfig(backend="cpu", compute_ports=False)).reach)
    assert psvc._breaker.transitions == ["open", "half_open", "closed"]
    assert psvc.stats.solves == {} and psvc._fallback_reach is None
    psvc.close()


def test_posture_words_faults_are_classified_and_transients_retried(setup, monkeypatch):
    """The words' device work runs under the engine's retry policy, as the
    JAX engine's derivation does: a transient fault in the unpack is retried
    and answers, and a fault packing the words at publish reaches the caller
    of ``apply`` classified."""
    import kubernetes_verification_tpu_torch.ops.device_state as port_device_state

    pcluster, _, pevents, _ = setup
    psvc = port_service.VerificationService(
        pcluster, kvt.VerifyConfig(compute_ports=False), device="cpu")
    psvc.enable_posture()
    psvc.apply(pevents[:30])
    real, calls = psvc.engine._unpack_reach_words, [0]

    def flaky():
        calls[0] += 1
        if calls[0] == 1:
            raise RuntimeError("CUDA error: unspecified launch failure")
        return real()

    psvc.engine._unpack_reach_words = flaky
    r0 = port_metrics.RETRIES_TOTAL.labels(backend="dense", kind="error").value
    np.testing.assert_array_equal(
        psvc.reach(),
        kvt.verify(psvc.engine.as_cluster(),
                   kvt.VerifyConfig(backend="cpu", compute_ports=False)).reach)
    assert calls[0] == 2 and psvc.stats.solves == {}
    assert port_metrics.RETRIES_TOTAL.labels(backend="dense", kind="error").value == r0 + 1

    def gone(*_a, **_k):
        raise RuntimeError("device is lost")

    monkeypatch.setattr(port_device_state, "_dense_reach_words", gone)
    with pytest.raises(DeviceLost):
        psvc.apply(pevents[30:60])
    psvc.close()


def test_snapshot_restarts_warm_in_either_package(setup, tmp_path):
    """``snapshot`` of one package restarts with ``from_snapshot`` in the
    other, dense and packed, and both go on equal."""
    pcluster, jcluster, pevents, jevents = setup
    for kind, build in (("dense", dense_services), ("packed", packed_services)):
        psvc, jsvc = build(pcluster, jcluster)
        psvc.apply(pevents[:80])
        jsvc.apply(jevents[:80])
        psvc.snapshot(str(tmp_path / f"{kind}-port"))
        jsvc.snapshot(str(tmp_path / f"{kind}-jax"))
        p_back = port_service.VerificationService.from_snapshot(
            str(tmp_path / f"{kind}-jax"), device="cpu")
        j_back = jax_service.VerificationService.from_snapshot(
            str(tmp_path / f"{kind}-port"))
        assert p_back.packed == j_back.packed == (kind == "packed")
        p_back.apply(pevents[80:160])
        j_back.apply(jevents[80:160])
        np.testing.assert_array_equal(p_back.reach(), j_back.reach())
        assert p_back.stats.to_dict() == j_back.stats.to_dict()
