"""Tails, rates and times per step are taken over every sample of the
window."""
import pytest

from kvbench import run
from kvbench.mixes import Run
from kvbench.stats import percentile


def test_percentile_interpolates_over_all_samples():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == pytest.approx(95.05)
    assert percentile([5.0], 95) == 5.0
    assert percentile([3, 1, 2], 50) == 2


def _churn(lat):
    r = Run("churn", "cpu", window_s=10.0)
    r.steps = [{"op": "pod_relabel", "host_s": x / 2, "latency_s": x} for x in lat]
    return r


def test_churn_metrics_read_every_change_of_the_window():
    lat = [0.01] * 95 + [1.0] * 5
    r = _churn(lat)
    assert run.metric_reader("diff_p95_ms")(r) == pytest.approx(1e3 * percentile(lat, 95))
    assert run.metric_reader("changes_per_s")(r) == pytest.approx(10.0)
    assert run.metric_reader("change_host_ms.rate")(r) == pytest.approx(1e3 * sum(lat) / 200)


def test_verify_time_is_the_window_over_its_steps():
    r = Run("verify", "cpu", window_s=9.0)
    r.steps = [{"encode_s": 1.0, "solve_s": 2.0}] * 3
    assert run.metric_reader("verify_s")(r) == pytest.approx(3.0)
    assert run.metric_reader("encode_ms.verify")(r) == pytest.approx(1000.0)
    assert run.metric_reader("solve_ms.verify")(r) == pytest.approx(2000.0)
    assert run.metric_reader("diff_p95_ms")(r) is None


def test_readers_with_nothing_to_read_return_nothing():
    r = Run("verify", "cpu")
    for name in ("verify_s", "peak_device_gib", "device_idle.verify",
                 "packed_dir_allow_roofline", "fused_ports_reach_roofline"):
        assert run.metric_reader(name)(r) is None


def test_trace_busy_idle_and_roofline():
    from kvbench import costs
    from kvbench.trace import Trace

    t = Trace(device=[("int8_kernel<DirEpi>", 1.0, 1.5), ("copy", 1.4, 2.0),
                      ("int8_kernel<DirEpi>", 3.0, 3.5)],
              spans=[("kvbench.window", 0.0, 4.0), ("kvbench.solve", 0.5, 3.8)],
              window=(0.0, 4.0))
    assert t.busy() == [(1.0, 2.0), (3.0, 3.5)]
    assert t.busy_s() == pytest.approx(1.5)
    b = t.breakdown()
    assert b["idle_gaps"][0] == ["solve", pytest.approx(1.0)]
    r = Run("verify", "NVIDIA H100 80GB HBM3", trace=t,
            counters={"n_pods": 1000, "n_policies": 100})
    r.steps = [{}]
    assert run.metric_reader("device_idle.verify")(r) == pytest.approx(62.5)
    ops, nbytes = costs.packed_dir_allow_cost(100, 1000)
    assert ops == 2 * 100 * 1000 * 1000
    least = max(ops / 1979e12, nbytes / 3.35e12)
    assert run.metric_reader("packed_dir_allow_roofline")(r) == pytest.approx(100 * 2 * least / 1.0)
    r.device_kind = "some other card"
    assert run.metric_reader("packed_dir_allow_roofline")(r) is None
