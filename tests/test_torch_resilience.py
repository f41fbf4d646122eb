"""The port's ``classify_exception``, ``retry_transient`` and the resilient
wrapper (``resilience/wrapper.py``: retries, watchdog, OOM halving of
``tile``, fallback chain, breaker) against the JAX package's, and what
PyTorch raises on a CUDA device; the serving engine's re-solves retry a
transient failure; a chain from a card backend to the host oracle is
refused before any attempt."""
import numpy as np
import pytest
import torch

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.resilience import errors as jax_errors
from kubernetes_verification_tpu.resilience.retry import RetryPolicy as JaxRetryPolicy
from kubernetes_verification_tpu_torch.resilience import errors
from kubernetes_verification_tpu_torch.resilience.retry import (
    NO_RETRY,
    RetryPolicy,
    retry_transient,
)

_MESSAGES = [
    "RESOURCE_EXHAUSTED: out of HBM",
    "Out of memory while trying to allocate",
    "DEADLINE_EXCEEDED: rpc",
    "DATA_LOSS: device is lost",
    "device halted",
    "UNAVAILABLE: socket closed",
    "ABORTED: preempted",
    "please try again",
    "something else entirely",
]


@pytest.mark.parametrize("msg", _MESSAGES)
def test_classify_exception_matches_jax(msg):
    got = errors.classify_exception(RuntimeError(msg), backend="packed")
    want = jax_errors.classify_exception(RuntimeError(msg), backend="packed")
    assert type(got).__name__ == type(want).__name__
    assert (got.kind, got.transient, got.backend, str(got)) == (
        want.kind, want.transient, want.backend, str(want))
    assert isinstance(got.__cause__, RuntimeError)


def test_classify_exception_maps_what_torch_raises():
    oom = errors.classify_exception(
        torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert isinstance(oom, errors.BackendOOM) and oom.transient
    err = errors.classify_exception(
        RuntimeError("CUDA error: unspecified launch failure"), backend="torch")
    assert type(err) is errors.BackendError and err.transient
    assert err.kind == "error" and err.backend == "torch"
    typed = errors.ConfigError("bad width")
    out = errors.classify_exception(typed, backend="packed")
    assert type(out) is errors.BackendError and not out.transient
    passed = errors.DeviceLost("gone")
    assert errors.classify_exception(passed, backend="x") is passed
    assert passed.backend == "x"


def test_retry_transient_backs_off_then_succeeds_or_raises():
    assert list(RetryPolicy(max_retries=3, seed=4).delays()) == list(
        JaxRetryPolicy(max_retries=3, seed=4).delays())
    calls, slept, seen = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("UNAVAILABLE: try later")
        return "ok"

    assert retry_transient(flaky, sleep=slept.append,
                           on_retry=lambda e, i: seen.append((e.kind, i))) == "ok"
    assert len(calls) == 3 and slept == list(RetryPolicy().delays())
    assert seen == [("error", 0), ("error", 1)]
    with pytest.raises(errors.BackendOOM):
        retry_transient(lambda: (_ for _ in ()).throw(RuntimeError("out of memory")),
                        policy=NO_RETRY, sleep=slept.append)
    calls.clear()

    def broken():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(errors.BackendError, match="ValueError"):
        retry_transient(broken, sleep=slept.append)
    assert len(calls) == 1


def test_engine_re_solves_retry_a_transient_failure(monkeypatch):
    from kubernetes_verification_tpu_torch import packed_incremental as pi

    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=40, n_policies=6, seed=3))
    eng = kvt.PackedIncrementalVerifier(cluster, device="cpu", keep_matrix=False)
    want_stripe, want_rows = eng.solve_stripe(0, 128), eng.solve_rows([1, 2])
    for name in ("_stripe_step", "_rows_step"):
        real = getattr(pi, name)
        fails = [RuntimeError("CUDA error: transient")]

        def once(*a, _real=real, _fails=fails, **k):
            if _fails:
                raise _fails.pop()
            return _real(*a, **k)

        monkeypatch.setattr(pi, name, once)
    eng.retry_policy = RetryPolicy(backoff_base=0.0, jitter=0.0)
    np.testing.assert_array_equal(eng.solve_stripe(0, 128), want_stripe)
    np.testing.assert_array_equal(eng.solve_rows([1, 2]), want_rows)
    eng.retry_policy = NO_RETRY
    monkeypatch.setattr(pi, "_rows_step", lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("CUDA error: again")))
    with pytest.raises(errors.BackendError, match="CUDA error"):
        eng.solve_rows([1])


# ------------------------------------------------------- the resilient wrapper
import kubernetes_verification_tpu as jkv  # noqa: E402
from kubernetes_verification_tpu.observe import REGISTRY as JAX_REGISTRY  # noqa: E402
from kubernetes_verification_tpu.resilience import faults as jax_faults  # noqa: E402
from kubernetes_verification_tpu.resilience import wrapper as jax_wrapper  # noqa: E402
from kubernetes_verification_tpu_torch.observe import REGISTRY  # noqa: E402
from kubernetes_verification_tpu_torch.resilience import faults, wrapper  # noqa: E402
from torch_parity import to_jax  # noqa: E402

_HOST = (("device", "cpu"),)


def _counters(registry, names=("kvtpu_retries_total", "kvtpu_fallbacks_total",
                               "kvtpu_degradations_total", "kvtpu_faults_injected_total")):
    dump = registry.dump()["counters"]
    return {n: dict(dump.get(n, {})) for n in names}


def _delta(before, after):
    return {n: {k: v - before[n].get(k, 0.0) for k, v in after[n].items()
                if v != before[n].get(k, 0.0)} for n in after}


def _both(spec, *, inner=("cpu", "cpu"), chain=None, options=(), res=None,
          hang_seconds=0.25, seed=5, pods=14, policies=5):
    """One faulted resilient solve in each package on the same cluster:
    ``inner`` names the wrapped backend in (port, JAX); ``chain`` lists
    backends with ``"F"`` for the faulty one. Returns each side's
    ``(result or exception, counter deltas)``."""
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=seed, n_pods=pods,
                                                     n_policies=policies))
    out = []
    for side, (mod_f, mod_w, cfg_cls, reg, cl, opts) in enumerate((
        (faults, wrapper, kvt.VerifyConfig, REGISTRY, cluster, _HOST + tuple(options)),
        (jax_faults, jax_wrapper, jkv.VerifyConfig, JAX_REGISTRY, to_jax(cluster),
         tuple(options)),
    )):
        name = mod_f.register_faulty(inner[side], mod_f.parse_fault_spec(spec),
                                     hang_seconds=hang_seconds)
        rcfg = mod_w.ResilienceConfig(
            fallback_chain=tuple(name if b == "F" else b for b in (chain or ("F",))),
            **(res or {}))
        before = _counters(reg)
        try:
            got = mod_w.resilient_verify(
                cl, cfg_cls(backend=name, compute_ports=False, backend_options=opts),
                rcfg, sleep=lambda _s: None)
        except Exception as e:  # noqa: BLE001 — compared across the packages
            got = e
        delta = _delta(before, _counters(reg))
        out.append((got, {n: {k.replace(name, "F"): v for k, v in d.items()}
                          for n, d in delta.items()}))
    return out


def _same_outcome(pair):
    (p, pd), (j, jd) = pair
    assert pd == jd
    if isinstance(j, Exception):
        assert type(p).__name__ == type(j).__name__, (p, j)
        if hasattr(j, "failures"):
            assert [type(e).__name__ for _, e in p.failures] == \
                [type(e).__name__ for _, e in j.failures]
        return p
    assert p.backend == {"tpu": "torch"}.get(j.backend, j.backend)
    np.testing.assert_array_equal(p.reach, j.reach)
    return p


@pytest.mark.parametrize("inner", [("cpu", "cpu"), ("torch", "tpu")])
def test_wrapper_retries_a_flaky_backend_alike(inner):
    p = _same_outcome(_both("flaky@0", inner=inner, res=dict(max_retries=2)))
    assert p.n_pods == 14


def test_wrapper_falls_back_on_device_loss_alike():
    p = _same_outcome(_both("device_loss", chain=("F", "cpu")))
    assert p.backend == "cpu"


@pytest.mark.parametrize("spec,chain,res", [
    ("oom>256", ("F",), dict(min_tile=128)),
    ("oom", ("F", "cpu"), dict(min_tile=256, max_retries=0)),
])
def test_wrapper_halves_the_tile_on_oom_alike(spec, chain, res):
    _same_outcome(_both(spec, chain=chain, options=(("tile", 1024),), res=res))


def test_wrapper_watchdog_times_out_and_falls_back_alike():
    p = _same_outcome(_both("timeout", chain=("F", "cpu"), hang_seconds=1.0,
                            res=dict(solve_timeout=0.2, max_retries=0),
                            pods=8, policies=2))
    assert p.backend == "cpu"


def test_wrapper_chain_exhaustion_and_breaker_alike():
    p = _same_outcome(_both("device_loss", inner=("torch", "tpu")))
    assert isinstance(p, errors.BackendChainExhausted)
    assert isinstance(p.failures[0][1], errors.DeviceLost)
    assert errors.exit_code_for(p) == errors.EXIT_BACKEND_FAILED
    # an open breaker skips the backend without an attempt, in both
    from kubernetes_verification_tpu.resilience.breaker import reset_breakers as jreset
    from kubernetes_verification_tpu_torch.resilience.breaker import reset_breakers

    reset_breakers()
    jreset()
    res = dict(breaker_threshold=1, breaker_cooldown=1e6, max_retries=0)
    first = _both("device_loss", chain=("F", "cpu"), res=res)
    second = _both("device_loss", chain=("F", "cpu"), res=res)
    _same_outcome(first)
    _same_outcome(second)
    assert second[0][1]["kvtpu_faults_injected_total"] == {}
    reset_breakers()
    jreset()


def test_wrapper_refuses_a_chain_from_the_card_to_the_host():
    """On the card (no ``("device", "cpu")`` option) a chain that would
    move to the host oracle is a ``ConfigError`` before any attempt; a
    host config, and a chain of the oracle alone, behave as the JAX
    package's."""
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=5, n_pods=10, n_policies=3))
    name = faults.register_faulty("torch", faults.parse_fault_spec("device_loss"))
    before = _counters(REGISTRY)
    for chain in (("torch", "cpu"), (name, "cpu"), ("torch", name, "faulty:cpu")):
        with pytest.raises(errors.ConfigError, match="host oracle"):
            wrapper.resilient_verify(
                cluster, kvt.VerifyConfig(compute_ports=False),
                wrapper.ResilienceConfig(fallback_chain=chain), sleep=lambda _s: None)
    assert _counters(REGISTRY) == before  # nothing was attempted
    host = kvt.VerifyConfig(compute_ports=False, backend_options=_HOST)
    res = wrapper.resilient_verify(
        cluster, host, wrapper.ResilienceConfig(fallback_chain=(name, "cpu")),
        sleep=lambda _s: None)
    assert res.backend == "cpu"
    oracle = wrapper.resilient_verify(
        cluster, kvt.VerifyConfig(compute_ports=False),
        wrapper.ResilienceConfig(fallback_chain=("cpu",)))
    np.testing.assert_array_equal(oracle.reach, res.reach)
    # the default chain is the config's backend alone: no fallback
    with pytest.raises(errors.BackendChainExhausted):
        wrapper.resilient_verify(
            cluster, kvt.VerifyConfig(backend=name, compute_ports=False,
                                      backend_options=_HOST))


def test_wrapper_waits_for_the_card_after_a_watchdog_timeout(monkeypatch):
    """A timed-out card attempt cannot be cancelled: the next attempt first
    synchronizes the card, once per timeout, and never for the host."""
    synced = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(str(dev)))
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=5, n_pods=8, n_policies=2))
    name = faults.register_faulty("torch", faults.parse_fault_spec("timeout"),
                                  hang_seconds=0.3)
    with pytest.raises(errors.BackendChainExhausted) as ei:
        wrapper.resilient_verify(
            cluster, kvt.VerifyConfig(backend=name, compute_ports=False),
            wrapper.ResilienceConfig(solve_timeout=0.02, max_retries=1),
            sleep=lambda _s: None)
    assert isinstance(ei.value.failures[0][1], errors.BackendTimeout)
    assert synced == ["cuda", "cuda"]
    synced.clear()
    host = faults.register_faulty("cpu", faults.parse_fault_spec("timeout"), hang_seconds=0.3)
    with pytest.raises(errors.BackendChainExhausted):
        wrapper.resilient_verify(
            cluster, kvt.VerifyConfig(backend=host, compute_ports=False),
            wrapper.ResilienceConfig(solve_timeout=0.02, max_retries=0),
            sleep=lambda _s: None)
    assert synced == []
