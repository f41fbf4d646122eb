"""The port's perf-sentinel layer against the JAX package's: the
calibration chains and the dispatch probe (``observe/sentinel.py``), the
dispatch-deflated twin series and derived-series gating
(``observe/history.py``), and the roofline accounting with the card's
published peaks (``observe/introspect.py``). On the CPU at the host size;
every comparison with the JAX package is on the same inputs and seeds and
exact, except the f32 chain's, whose two BLAS libraries may sum in another
order (relative tolerance 1e-5)."""
import json

import jax
import numpy as np
import pytest
import torch

from kubernetes_verification_tpu.observe import history as jhist
from kubernetes_verification_tpu.observe import introspect as jintro
from kubernetes_verification_tpu.observe import sentinel as jsent
from kubernetes_verification_tpu_torch.observe import REGISTRY, sentinel
from kubernetes_verification_tpu_torch.observe.history import (
    _direction,
    check_regression,
    deflate_record,
    expand_derived,
    format_findings,
)
from kubernetes_verification_tpu_torch.observe.introspect import (
    device_bytes_per_s,
    device_peak_macs_per_s,
    format_roofline_table,
    roofline_rows,
)
from kubernetes_verification_tpu_torch.observe.sentinel import (
    SentinelCalibrationError,
    SentinelKernel,
    SentinelSuite,
    run_calibration,
    slim_context,
)
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError

_CPU = torch.device("cpu")


# -------------------------------------------------------- _direction rules
@pytest.mark.parametrize("unit,metric,want", [
    ("pct", "sentinel_spread_pct", "unknown"),
    ("s", "sentinel_dispatch_s", "unknown"),
    ("s", "sentinel_mxu_int8_s", "lower"),
    ("s", "compile_s", "lower"),
    ("s", "queries_per_second compile_s", "lower"),
    ("weird", "precompile_s_thing", "unknown"),
    ("pct", "pct_of_peak", "higher"),
    ("pct", "tiled_pct_of_peak", "higher"),
    ("pairs/s", "m_deflated", "higher"),
    ("queries/s", "aggregate_queries_per_second_deflated", "higher"),
    ("ms", "latency_deflated", "lower"),
    ("weird_pct", "mystery_deflated", "unknown"),
    ("bytes", "query_h2d_bytes", "lower"),
])
def test_directions_equal_the_jax_packages(unit, metric, want):
    assert _direction(unit, metric) == want == jhist._direction(unit, metric)


# ----------------------------------------------------------- deflation math
def _sentinel_runs(computes, dispatches, work=1e6, metric="m"):
    """Fake throughput history where wall = compute + dispatch per solve."""
    runs = []
    for c, d in zip(computes, dispatches):
        steady = c + d
        runs.append({"metric": metric, "unit": "pairs/s", "value": work / steady,
                     "steady_s": steady, "sentinel": {"dispatch_s": d}})
    return runs


@pytest.mark.parametrize("rec", [
    _sentinel_runs([0.010], [0.001], work=1000.0)[0],
    {"metric": "lat", "unit": "ms", "value": 11.0, "sentinel": {"dispatch_s": 0.001}},
    _sentinel_runs([0.001], [0.020], work=1000.0)[0],
    {"metric": "m", "unit": "pairs/s", "value": 1.0},
    {"metric": "m_deflated", "unit": "pairs/s", "value": 1.0, "steady_s": 1.0,
     "sentinel": {"dispatch_s": 0.1}},
    {"metric": "m", "unit": "bytes", "value": 10.0, "sentinel": {"dispatch_s": 0.1}},
    {"metric": "m", "unit": "pairs/s", "value": 10.0, "sentinel": {"dispatch_s": 0.1}},
], ids=["throughput", "latency", "clamped", "no-sentinel", "twin", "bytes", "no-steady"])
def test_deflate_record_equals_the_jax_packages(rec):
    assert deflate_record(rec) == jhist.deflate_record(rec)


def test_deflate_record_throughput_and_clamp():
    (rec,) = _sentinel_runs([0.010], [0.001], work=1000.0)
    twin = deflate_record(rec)
    assert twin["metric"] == "m_deflated" and twin["unit"] == "pairs/s"
    assert twin["value"] == pytest.approx(1000.0 / 0.010)
    assert twin["derived_from"] == "m" and not twin["deflation_clamped"]
    rec = _sentinel_runs([0.001], [0.020], work=1000.0)[0]
    twin = deflate_record(rec)
    assert twin["deflation_clamped"]
    assert twin["value"] == pytest.approx(rec["value"] * 10.0)


def test_expand_derived_compile_s_and_twins():
    runs = _sentinel_runs([0.01, 0.01], [0.001, 0.001])
    runs[0]["compile_s"] = 14.3
    expanded = expand_derived(runs)
    assert [r["metric"] for r in expanded] == [
        "m", "m compile_s", "m_deflated", "m", "m_deflated"]
    assert expanded == jhist.expand_derived(runs)
    only = [{"metric": "ab", "unit": "pct", "value": 1.0, "compile_s": {"xla": 3.0}}]
    assert expand_derived(only) == jhist.expand_derived(only) and len(expand_derived(only)) == 1
    assert expand_derived(runs, deflate=False) == jhist.expand_derived(runs, deflate=False)


# ------------------------------------------------- the gate fixtures
@pytest.mark.parametrize("computes,dispatches,ok", [
    ([0.010] * 6, [0.001] * 5 + [0.011], True),   # dispatch noise only
    ([0.010] * 5 + [0.020], [0.001] * 6, False),  # device compute doubles
])
def test_deflated_gate_equals_the_jax_packages(computes, dispatches, ok):
    runs = _sentinel_runs(computes, dispatches)
    mine = check_regression(expand_derived(runs), prefer_deflated=True)
    assert mine == jhist.check_regression(jhist.expand_derived(runs), prefer_deflated=True)
    assert mine[0] is ok, format_findings(mine[1])
    if ok:
        raw = next(f for f in mine[1] if f["metric"] == "m")
        assert raw["gated_via"] == "m_deflated" and not raw["regressed"]
        assert not check_regression(runs)[0]  # the raw gate fails on noise
    else:
        defl = next(f for f in mine[1] if f["metric"] == "m_deflated")
        assert defl["regressed"] and defl["ratio"] == pytest.approx(0.5, abs=0.03)


def test_gate_compile_time_walk_is_gated():
    runs = [{"metric": "m", "unit": "pairs/s", "value": 100.0, "compile_s": c}
            for c in [14.3, 15.0, 14.8, 20.4, 59.8]]
    ok, findings = check_regression(expand_derived(runs))
    assert not ok
    f = next(x for x in findings if x["metric"] == "m compile_s")
    assert f["regressed"] and f["direction"] == "lower"


# ------------------------------------------------------ the sentinel suite
def _scripted_timer(durations, repeats=40):
    """Deterministic clock: each timed run reads the next duration."""
    seq, t = [], 0.0
    for d in list(durations) * repeats:
        seq.append(t)
        t += d
        seq.append(t)
    it = iter(seq)
    return lambda: next(it)


def _dummy_kernel():
    return SentinelKernel(name="dummy", build=lambda dev, cfg: (lambda: 0.0),
                          macs_per_run=1000, kind="mxu", dtype="int8", config={"n": 1})


def test_register_verifies_spread_and_records_macs():
    suite = SentinelSuite(_CPU, reps=3, max_spread_pct=5.0,
                          timer=_scripted_timer([0.100, 0.101, 0.100]))
    res = suite.register(_dummy_kernel())
    assert res["calibrated"] and res["spread_pct"] <= 5.0
    assert res["macs_per_s"] == pytest.approx(1000 / 0.100, rel=0.05)
    assert suite.results["dummy"]["median_s"] == pytest.approx(0.100, rel=0.05)


def test_register_strict_raises_on_noisy_instrument():
    suite = SentinelSuite(_CPU, reps=3, max_spread_pct=1.0,
                          timer=_scripted_timer([0.10, 0.20, 0.10]))
    with pytest.raises(SentinelCalibrationError):
        suite.register(_dummy_kernel(), strict=True)
    assert issubclass(SentinelCalibrationError, ConfigError)


def test_register_non_strict_marks_uncalibrated_and_counts():
    def failures():
        return (REGISTRY.dump()["counters"]
                .get("kvtpu_sentinel_calibration_failures_total", {})
                .get("kernel=dummy", 0.0))

    before = failures()
    suite = SentinelSuite(_CPU, reps=3, max_spread_pct=1.0,
                          timer=_scripted_timer([0.10, 0.20, 0.10]))
    assert not suite.register(_dummy_kernel())["calibrated"]
    assert failures() >= before + 1


def test_run_calibration_cpu_end_to_end():
    """Real chains on the host; the spread bound is opened wide so a noisy
    neighbour never flakes this test — it asserts the context's shape."""
    ctx = run_calibration("cpu", reps=3, max_spread_pct=1e9)
    assert set(ctx["kernels"]) == {"mxu_int8", "mxu_f32", "vpu_bitops"}
    assert ctx["platform"] == "cpu" and ctx["device"] == "cpu"
    assert ctx["kernels"]["mxu_int8"]["config"] == {"n": 256, "loops": 4}
    assert ctx["dispatch_s"] > 0 and ctx["calibrated"]
    assert ctx["calibrated_peak_macs_per_s"] > 0
    slim = slim_context(ctx)
    assert slim == jsent.slim_context(ctx)
    assert slim["dispatch_s"] == pytest.approx(ctx["dispatch_s"], abs=1e-6)
    json.dumps(slim)


def test_no_device_argument_means_the_card():
    """Without a device the suite asks for CUDA and never calibrates on the
    CPU in its place."""
    from kubernetes_verification_tpu_torch.resilience.errors import BackendError

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(BackendError, match="no CUDA device"):
        run_calibration()
    with pytest.raises(BackendError, match="no CUDA device"):
        SentinelSuite()


@pytest.mark.parametrize("name", ["_build_matmul_int8", "_build_matmul_f32",
                                  "_build_vpu_bitops"])
def test_each_chain_equals_the_jax_chain_at_the_host_size(name):
    """The first element after the chain's rounds: the port's runner against
    the JAX package's on the same seed and host-size config; and the port's
    whole output against a NumPy evaluation of the same rounds."""
    cfg = next(k.config for k in sentinel._default_kernels("cpu")
               if k.build.__name__ == name)
    assert cfg == next(k.config for k in jsent._default_kernels("cpu")
                       if k.build.__name__ == name)
    mine = getattr(sentinel, name)(_CPU, dict(cfg))()
    theirs = getattr(jsent, name)(jax.devices("cpu")[0], dict(cfg))()
    if name == "_build_matmul_f32":
        assert mine == pytest.approx(theirs, rel=1e-5)
    else:
        assert mine == theirs


def test_whole_chains_equal_numpy_rounds():
    rng = np.random.default_rng(0)
    x = rng.integers(-64, 64, (32, 32), dtype=np.int8)
    w = rng.integers(-64, 64, (32, 32), dtype=np.int8)
    want = x
    for _ in range(3):
        want = ((want.astype(np.int32) @ w.astype(np.int32)) & 0x3F).astype(np.int8)
    got = sentinel._int8_chain(torch.from_numpy(x), torch.from_numpy(w.T.copy()), 3)
    np.testing.assert_array_equal(got.numpy(), want)
    words = np.random.default_rng(2).integers(0, 2**32, 1000, dtype=np.uint32)
    want = words.copy()
    for _ in range(16):
        want = ((want << np.uint32(1)) | (want >> np.uint32(31))) ^ np.uint32(0x9E3779B9)
    got = sentinel._bitops_chain(torch.from_numpy(words.view(np.int32)), 16)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


# ------------------------------------------------------------- roofline
def test_device_peak_longest_prefix_match():
    sxm, pcie = "NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe"
    assert device_peak_macs_per_s(sxm) == pytest.approx(1979e12 / 2)
    assert device_peak_macs_per_s(sxm, dtype="bf16") == pytest.approx(989.4e12 / 2)
    # the PCIe part's name must not read the SXM part's peaks
    assert device_peak_macs_per_s(pcie) == pytest.approx(1513e12 / 2)
    assert device_peak_macs_per_s(pcie + " 80GB", dtype="bf16") == pytest.approx(756e12 / 2)
    assert device_bytes_per_s(sxm) == 3.35e12 and device_bytes_per_s(pcie) == 2.0e12
    for unknown in ("Quantum9000", None, "TPU v5 lite"):
        assert device_peak_macs_per_s(unknown) is None


def _roofline_fixture():
    return [
        {"metric": "all-pairs", "unit": "pairs/s", "value": 2.4e9, "mode": "tiled",
         "device": "NVIDIA H100 80GB HBM3", "platform": "gpu",
         "macs": 2.9e14, "steady_s": 4.14,
         "macs_basis": "n_pods^2 * (ingress_grants + egress_grants)"},
        {"metric": "closure_pairs_per_second", "unit": "pairs/s", "value": 1e9,
         "mode": "closure", "device": "cpu", "platform": "cpu",
         "sentinel": {"dispatch_s": 1e-4, "calibrated_peak_macs_per_s": 6.0e10},
         "macs": 1.0e12, "steady_s": 10.0},
        {"metric": "x", "unit": "pairs/s", "value": 1.0, "mode": "k8s",
         "device": "Quantum9000", "platform": "cpu", "macs": 5.0e11, "steady_s": 2.0},
    ]


def test_roofline_rows_sources_and_pct():
    rows = roofline_rows(_roofline_fixture())
    by = {r["mode"]: r for r in rows}
    assert by["tiled"]["peak_source"] == "peak-table[NVIDIA H100 80GB HBM3]"
    assert by["tiled"]["pct_of_peak"] == pytest.approx(100 * 2.9e14 / 4.14 / 989.5e12,
                                                       abs=0.01)
    assert by["closure"]["peak_source"] == "sentinel-calibrated"
    assert by["closure"]["pct_of_peak"] == pytest.approx(166.7, abs=1.0)
    assert by["k8s"]["peak_source"] == "analytic-host"
    # the records without a published peak fall back as in the JAX package
    jrows = {r["mode"]: r for r in jintro.roofline_rows(_roofline_fixture())}
    for mode in ("closure", "k8s"):
        assert by[mode] == jrows[mode]
    gauges = REGISTRY.dump()["gauges"]
    assert gauges["kvtpu_roofline_achieved_macs_per_second"]["mode=tiled"] == \
        pytest.approx(2.9e14 / 4.14, rel=1e-6)


def test_roofline_rows_newest_record_wins_and_skips_unusable():
    recs = _roofline_fixture()[:1] + [
        dict(_roofline_fixture()[0], steady_s=2.07),
        {"metric": "y", "unit": "s", "value": 1.0, "mode": "bad", "macs": 0, "steady_s": 1},
    ]
    rows = roofline_rows(recs)
    assert [r["mode"] for r in rows] == ["tiled"]
    assert rows[0]["steady_s"] == 2.07


def test_format_roofline_table():
    rows = roofline_rows(_roofline_fixture())
    table = format_roofline_table(rows)
    assert "% peak" in table.splitlines()[0] and "peak-table" in table
    assert table == jintro.format_roofline_table(rows)
    assert format_roofline_table([]) == ""
