"""The port's ``classify_exception`` and ``retry_transient`` against the JAX
package's, and what PyTorch raises on a CUDA device; the serving engine's
re-solves retry a transient failure."""
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
