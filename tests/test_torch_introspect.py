"""The port's introspection layer against the JAX package's: analytic cost
reports (``observe/introspect.py``), device/host memory telemetry
(``observe/telemetry.py``), the bench-history store and regression gate
(``observe/history.py``), the dispatch tracker (``observe/jit.py``), the
legacy ``utils.observe`` shim, and the new metric families in the
Prometheus text. Every comparison with the JAX package is on the same
inputs and exact."""
import importlib
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import kubernetes_verification_tpu.observe.history as jhist
import kubernetes_verification_tpu.observe.jit as jjit
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.observe import (
    REGISTRY,
    history,
    introspect,
    jit,
    telemetry,
)
from kubernetes_verification_tpu_torch.observe.history import (
    append_run,
    check_regression,
    default_paths,
    format_findings,
    load_runs,
)
from kubernetes_verification_tpu_torch.ops.kernels import (
    fused_ports_reach_cost,
    packed_dir_allow_cost,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def intro():
    """Introspection ON with a clean report store; restored afterwards so
    the default-off contract holds for every other test."""
    introspect.clear_reports()
    introspect.set_introspection(True)
    yield introspect
    introspect.set_introspection(False)
    introspect.clear_reports()


# ------------------------------------------------------------ cost analysis
def test_cost_report_from_a_dispatch_with_a_cost_function(intro):
    a = torch.ones((64, 64), dtype=torch.int8)

    def cost():
        return 2 * 64 ** 3, 3 * 64 * 64

    rep = intro.maybe_publish("test", "matmul", cost, (a, a))
    assert rep is not None and rep.source == "analytic" and rep.platform == "cpu"
    assert (rep.flops, rep.bytes_accessed) == (2 * 64 ** 3, 3 * 64 * 64)
    assert rep.arithmetic_intensity > 0
    assert rep.roofline_bound in ("compute", "memory")
    # same abstract signature -> cached, no second report
    intro.maybe_publish("test", "matmul", cost, (a + 1, a))
    assert len(intro.reports()) == 1
    # a new shape is a new signature -> second report
    b = torch.ones((32, 32), dtype=torch.int8)
    intro.maybe_publish("test", "matmul", cost, (b, b))
    assert len(intro.reports()) == 2
    d = REGISTRY.dump()
    assert d["gauges"]["kvtpu_kernel_flops"]["engine=test,fn=matmul"] > 0
    assert d["counters"]["kvtpu_cost_reports_total"][
        "engine=test,fn=matmul,source=analytic"
    ] >= 2


def test_a_site_without_a_cost_function_publishes_nothing(intro):
    """Never a guessed report, never a zero: no cost function, no report;
    a cost function that raises is logged and never reaches the caller."""
    assert intro.maybe_publish("test", "blind", None, (torch.ones(3),)) is None

    def broken():
        raise RuntimeError("no counts")

    assert intro.maybe_publish("test", "broken", broken, (torch.ones(3),)) is None
    assert intro.reports() == []


def test_introspection_off_is_a_noop():
    introspect.clear_reports()
    assert not introspect.introspection_enabled()
    out = introspect.maybe_publish("test", "noop", lambda: (1, 1), (torch.ones(8),))
    assert out is None and introspect.reports() == []
    kvt.tiled_k8s_reach(kvt.encode_cluster(kvt.random_cluster(
        kvt.GeneratorConfig(n_pods=40, n_policies=5, seed=1))), device="cpu",
        use_kernel=True)
    assert introspect.reports() == []


def test_host_estimate_and_roofline(intro):
    rep = intro.publish_host_estimate(
        "native", "sweep", flops=1000.0, bytes_accessed=50.0,
        argument_bytes=40, output_bytes=10,
    )
    assert rep.source == "host-estimate" and rep.platform == "host"
    assert rep.arithmetic_intensity == pytest.approx(20.0)
    assert rep.roofline_bound == "compute"  # 20 >= the host ridge (10)
    low = intro.publish_host_estimate(
        "native", "copy", flops=1.0, bytes_accessed=100.0, signature=(1,)
    )
    assert low.roofline_bound == "memory"
    assert low.peak_bytes >= 0  # host RSS peak rides along


def test_format_cost_table(intro):
    intro.publish_host_estimate(
        "e", "k", flops=2e9, bytes_accessed=1e6, signature=("s",)
    )
    table = intro.format_cost_table()
    lines = table.splitlines()
    assert len(lines) >= 3  # header, rule, one row
    assert "flops/B" in lines[0] and "bound" in lines[0]
    assert any("host" in ln and "2.00e+09" in ln for ln in lines[2:])
    assert intro.format_cost_table([]) == ""


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_backend_verify_publishes_the_jax_packages_reports(intro, backend):
    """The host backends publish the JAX package's host estimates, with the
    JAX package's numbers (``verify(backend="cpu")``: ``encode_selectors``
    and ``solve_reach``)."""
    import kubernetes_verification_tpu as jkv
    from kubernetes_verification_tpu.observe import introspect as jintro
    from torch_parity import to_jax

    if backend not in kvt.available_backends():
        pytest.skip("the native backend needs a C++ compiler")
    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=16, n_policies=4,
                                                     n_namespaces=2, seed=0))
    kvt.verify(cluster, kvt.VerifyConfig(backend=backend))
    mine = {r.fn: (r.flops, r.bytes_accessed, r.output_bytes) for r in intro.reports()}
    jintro.clear_reports()
    jintro.set_introspection(True)
    try:
        jkv.verify(to_jax(cluster), jkv.VerifyConfig(backend=backend))
        theirs = {r.fn: (r.flops, r.bytes_accessed, r.output_bytes)
                  for r in jintro.reports()}
    finally:
        jintro.set_introspection(False)
        jintro.clear_reports()
    assert mine == theirs
    if backend == "cpu":
        assert {"encode_selectors", "solve_reach"} <= set(mine)


def test_the_two_kernels_and_bool_dot_publish_exact_counts(intro):
    """The hand kernels' wrappers (here through their plain versions) and
    ``bool_dot`` publish their exact operation and byte counts."""
    from kubernetes_verification_tpu_torch.ops.closure import bool_dot
    from kubernetes_verification_tpu_torch.ops.tiled_ports import port_layout_stats

    cluster = kvt.random_cluster(kvt.GeneratorConfig(
        n_pods=200, n_policies=20, seed=3, p_ports=0.8, p_named_port=0.3,
        p_container_ports=0.5))
    for compute_ports in (False, True):
        kvt.tiled_k8s_reach(kvt.encode_cluster(cluster, compute_ports=compute_ports),
                            device="cpu", use_kernel=True, tile=256)
    reps = {r.fn: r for r in intro.reports() if r.engine == "cuda"}
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    n = 256  # 200 pods padded to the tile
    assert reps["packed_dir_allow"].output_bytes == n * n // 8
    p = reps["packed_dir_allow"].flops // (2 * n * n)
    assert p >= enc.n_policies
    assert (reps["packed_dir_allow"].flops, reps["packed_dir_allow"].bytes_accessed) == (
        2 * p * n * n, 2 * p * n + 4 * 8 * n + n * n // 8)
    stats = port_layout_stats(kvt.encode_cluster(cluster, compute_ports=True), tile=256)
    fused = reps["fused_ports_reach"]
    assert fused.flops == 2 * stats["K"] * stats["N"] ** 2
    intro.clear_reports()
    a = torch.ones((20, 24), dtype=torch.int8)
    bt = torch.ones((40, 24), dtype=torch.int8)
    assert torch.equal(bool_dot(a, bt), torch.full((20, 40), 24, dtype=torch.int32))
    (rep,) = intro.reports()
    assert (rep.engine, rep.fn, rep.flops) == ("closure", "bool_dot", 2 * 20 * 24 * 40)


def test_flagship_kernel_bounds_without_running_them():
    """The published H100 peaks turn the two kernels' counts at the
    flagship shapes into the bounds ``chip_smoke.py`` prints (phases 5
    and 7): N = 102,400, P = 10,000; K = 20,103 real VP rows of K' =
    21,376, R = 19."""
    card = "NVIDIA H100 80GB HBM3"
    n = 102_400
    c = packed_dir_allow_cost(10_000, n, 8 * n)
    secs, by = introspect.analytic_bound(c["flops"], c["bytes_accessed"], card)
    assert (round(1e3 * secs, 1), by) == (106.0, "operations")
    c = fused_ports_reach_cost(n, 20_103, 21_376, 3 * 40, 19)
    secs, by = introspect.analytic_bound(c["flops"], c["bytes_accessed"], card)
    assert (round(1e3 * secs, 1), by) == (213.0, "operations")
    with pytest.raises(KeyError):
        introspect.analytic_bound(1, 1, "Quantum9000")


# ---------------------------------------------------------------- telemetry
def test_memory_snapshot_never_empty():
    snap = telemetry.memory_snapshot()
    assert snap, "snapshot must fall back to host RSS when devices hide stats"
    for e in snap:
        assert {"device", "platform", "bytes_in_use", "source"} <= set(e)
        assert e["bytes_in_use"] > 0
    assert telemetry.total_bytes_in_use() > 0


def test_memory_snapshot_never_initialises_cuda(monkeypatch):
    """No CUDA device, or CUDA not initialised: one ``device=host`` sample,
    and the snapshot calls nothing that could initialise CUDA."""
    touched = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    for name in ("device_count", "memory_stats", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, _n=name, **k: touched.append(_n))
    (entry,) = telemetry.memory_snapshot()
    assert entry["device"] == "host" and entry["source"] == "host-rss"
    assert touched == []


def test_memory_snapshot_reads_the_cuda_allocator(monkeypatch):
    """With CUDA initialised, one ``cuda:<i>`` entry per card the process
    allocated on, from the caching allocator's counters."""
    stats = {0: {"allocated_bytes.all.current": 1234, "allocated_bytes.all.peak": 5678},
             1: {"allocated_bytes.all.current": 0, "allocated_bytes.all.peak": 0}}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats[i])
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda i: (10, 80 << 30))
    (entry,) = telemetry.memory_snapshot()
    assert entry == {"device": "cuda:0", "platform": "gpu", "bytes_in_use": 1234,
                     "peak_bytes_in_use": 5678, "limit_bytes": 80 << 30,
                     "source": "device"}
    telemetry.sample_once()
    g = REGISTRY.dump()["gauges"]
    assert g["kvtpu_hbm_bytes_in_use"]["device=cuda:0"] == 1234
    assert g["kvtpu_hbm_peak_bytes"]["device=cuda:0"] == 5678


def test_sample_once_feeds_hbm_gauges():
    telemetry.sample_once()
    g = REGISTRY.dump()["gauges"]
    assert any(v > 0 for v in g["kvtpu_hbm_bytes_in_use"].values())
    assert any(v > 0 for v in g["kvtpu_hbm_peak_bytes"].values())


def test_sampler_thread_starts_and_stops():
    s = telemetry.start_sampler(interval_s=0.01)
    assert s.is_alive()
    assert telemetry.start_sampler() is s  # singleton while running
    telemetry.stop_sampler()
    s.join(timeout=5)
    assert not s.is_alive()


def test_span_memory_hook_annotates_spans():
    from kubernetes_verification_tpu_torch.observe import spans, trace

    spans.set_memory_hook(lambda: 12345)
    try:
        with trace("mem_probe_t") as sp:
            pass
        assert sp.attrs["mem_enter_bytes"] == 12345
        assert sp.attrs["mem_exit_bytes"] == 12345
    finally:
        spans.set_memory_hook(None)
    with trace("mem_probe_off_t") as sp:
        pass
    assert "mem_enter_bytes" not in sp.attrs


def test_install_span_memory_hook_uses_live_snapshot():
    from kubernetes_verification_tpu_torch.observe import spans, trace

    telemetry.install_span_memory_hook()
    try:
        with trace("mem_live_t") as sp:
            pass
        assert sp.attrs["mem_enter_bytes"] > 0
    finally:
        spans.set_memory_hook(None)


def test_format_memory_table_equals_the_jax_packages():
    from kubernetes_verification_tpu.observe import telemetry as jtel

    snap = [{"device": "cuda:0", "platform": "gpu", "bytes_in_use": 3 << 30,
             "peak_bytes_in_use": 5 << 30, "limit_bytes": 80 << 30, "source": "device"},
            {"device": "host", "platform": "host", "bytes_in_use": 123,
             "peak_bytes_in_use": 456, "limit_bytes": 0, "source": "host-rss"}]
    assert telemetry.format_memory_table(snap) == jtel.format_memory_table(snap)
    table = telemetry.format_memory_table()
    lines = table.splitlines()
    assert "in_use" in lines[0] and len(lines) >= 3


def test_new_families_render_in_prometheus_exposition():
    """Sampled memory and cost gauges come out as valid text exposition
    (HELP/TYPE headers, escaped label values)."""
    from kubernetes_verification_tpu_torch.observe import to_prometheus

    telemetry.sample_once()
    introspect.set_introspection(True)
    try:
        introspect.publish_host_estimate(
            "exp", "probe", flops=10.0, bytes_accessed=5.0, signature=("x",)
        )
    finally:
        introspect.set_introspection(False)
        introspect.clear_reports()
    text = to_prometheus()
    for fam, kind in (
        ("kvtpu_hbm_bytes_in_use", "gauge"),
        ("kvtpu_hbm_peak_bytes", "gauge"),
        ("kvtpu_kernel_flops", "gauge"),
        ("kvtpu_cost_reports_total", "counter"),
        ("kvtpu_jit_recompiles_total", "counter"),
        ("kvtpu_aot_cache_hits_total", "counter"),
    ):
        assert f"# TYPE {fam} {kind}" in text
        assert f"# HELP {fam} " in text
    assert 'kvtpu_kernel_flops{engine="exp",fn="probe"} 10' in text


# -------------------------------------------------------- dispatch tracking
def test_jit_helpers_equal_the_jax_packages():
    """``abstract_signature`` and ``tree_nbytes`` give the JAX package's
    results on the same (numpy) values."""
    from kubernetes_verification_tpu_torch.encode.encoder import encode_cluster

    enc = encode_cluster(kvt.random_cluster(kvt.GeneratorConfig(n_pods=30, n_policies=6,
                                                                seed=2)))
    tree = {"a": np.zeros((3, 4), np.int8), "b": [np.ones(5, np.int32), 1.5, None],
            "c": ("x", True)}
    for value in (tree, enc.pol_sel, enc.ingress):
        assert jit.abstract_signature(value) == jjit.abstract_signature(value)
        assert jit.tree_nbytes(value) == jjit.tree_nbytes(value)
    t = torch.zeros((3, 4), dtype=torch.int32)
    assert jit.tree_nbytes([t, t]) == 96


def test_dispatch_tracker_counts_first_signatures_as_the_jax_one():
    mine, theirs = jit.DispatchTracker("test-port"), jjit.DispatchTracker("test-port")
    calls = [("f", (np.zeros(3),), ()), ("f", (np.zeros(3),), ()),
             ("f", (np.zeros(4),), ()), ("f", (np.zeros(4),), (True,)),
             ("g", (np.zeros(4),), ())]
    for fn, ops, static in calls:
        assert mine.track(fn, *ops, static=static) == theirs.track(fn, *ops, static=static)
    assert (mine.signatures("f"), mine.signatures("g")) == (3, 1)
    counters = REGISTRY.dump()["counters"]["kvtpu_jit_recompiles_total"]
    assert counters["engine=test-port,fn=f"] >= 3


def test_engines_count_ops_and_first_dispatches():
    """The engines' ``kvtpu_incremental_ops_total`` and tracker counters
    move at the JAX engines' call sites."""
    c = kvt.random_cluster(kvt.GeneratorConfig(n_pods=60, n_policies=8, seed=4))
    eng = kvt.PackedIncrementalVerifier(c, device="cpu", keep_matrix=True)
    before = REGISTRY.dump()["counters"].get("kvtpu_incremental_ops_total", {})
    pol = c.policies[0]
    eng.remove_policy(pol.namespace, pol.name)
    eng.add_policy(pol)
    eng.solve_stripe(0, 32)
    d = REGISTRY.dump()
    after = d["counters"]["kvtpu_incremental_ops_total"]
    for op in ("policy_add", "policy_remove"):
        key = f"engine=packed,op={op}"
        assert after[key] == before.get(key, 0) + 1
    assert d["counters"]["kvtpu_jit_recompiles_total"]["engine=packed,fn=_diff_step"] >= 1
    assert d["gauges"]["kvtpu_stripe_width"]["engine=packed"] == 32


# -------------------------------------------------------- history + gate
def _runs(values, unit="pairs/s", metric="m"):
    return [{"metric": metric, "value": v, "unit": unit} for v in values]


def test_history_append_load_round_trip_equals_the_jax_packages(tmp_path):
    p, q = str(tmp_path / "h.jsonl"), str(tmp_path / "j.jsonl")
    for v in (1.5, 1.6):
        append_run({"metric": "m", "value": v, "unit": "s", "ts": 1.0}, p)
        jhist.append_run({"metric": "m", "value": v, "unit": "s", "ts": 1.0}, q)
    assert open(p).read() == open(q).read()
    runs = load_runs([p])
    assert [r["value"] for r in runs] == [1.5, 1.6]
    assert [dict(r, origin=None) for r in runs] == [
        dict(r, origin=None) for r in jhist.load_runs([q])]
    assert history.DEFAULT_HISTORY == jhist.DEFAULT_HISTORY


def test_history_loads_whole_file_bench_snapshots(tmp_path):
    p = tmp_path / "BENCH_r01.json"
    p.write_text(json.dumps(
        {"n": 1, "parsed": {"metric": "m", "value": 2.0, "unit": "pairs/s"}}
    ))
    runs = load_runs([str(p)])
    assert len(runs) == 1 and runs[0]["value"] == 2.0
    assert runs == jhist.load_runs([str(p)])


@pytest.mark.parametrize("values,unit", [
    ([10.0, 10.5, 9.8, 10.2, 10.1, 5.0], "pairs/s"),
    ([10.0, 10.5, 9.8, 10.2, 9.9], "pairs/s"),
    ([1.0, 1.1, 0.9, 1.0, 2.2], "s"),
    ([2.2, 1.1, 0.9, 1.0, 1.0], "s"),
    ([10.0, 1.0], "weird_pct"),
    ([10.0], "pairs/s"),
])
def test_regression_gate_equals_the_jax_packages(values, unit):
    mine = check_regression(_runs(values, unit=unit))
    assert mine == jhist.check_regression(_runs(values, unit=unit))
    assert format_findings(mine[1]) == jhist.format_findings(mine[1])


def test_regression_gate_flags_2x_slowdown():
    ok, f = check_regression(_runs([10.0, 10.5, 9.8, 10.2, 10.1, 5.0]))
    assert not ok
    (finding,) = [x for x in f if x["regressed"]]
    assert finding["ratio"] == pytest.approx(0.5, abs=0.02)
    assert finding["direction"] == "higher"
    assert "REGRESSED" in format_findings(f)


def test_regression_gate_lower_is_better_units():
    ok, f = check_regression(_runs([1.0, 1.1, 0.9, 1.0, 2.2], unit="s"))
    assert not ok and f[0]["direction"] == "lower"
    ok, _ = check_regression(_runs([2.2, 1.1, 0.9, 1.0, 1.0], unit="s"))
    assert ok  # getting faster never trips the gate


def test_regression_gate_passes_the_committed_trajectory():
    """The committed ``BENCH_r*.json`` (read only) parse and pass the gate,
    exactly as in the JAX package."""
    paths = default_paths(str(REPO))
    assert paths == jhist.default_paths(str(REPO))
    if not paths:
        pytest.skip("no committed BENCH_r*.json trajectory")
    runs = load_runs(paths)
    assert runs, "committed snapshots must parse"
    ok, findings = check_regression(runs)
    assert ok, format_findings(findings)
    assert (ok, findings) == jhist.check_regression(jhist.load_runs(paths))


# ------------------------------------------------------------- the shim
def test_legacy_utils_observe_shim_warns():
    import kubernetes_verification_tpu_torch.utils.observe as shim

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        shim = importlib.reload(shim)
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert shim.logger is not None and shim.Phases is not None
    import kubernetes_verification_tpu.utils.observe as jshim

    assert shim.__all__ == jshim.__all__
