"""The spans and counts at the layer boundaries of the port's main paths:
``encode_cluster``, ``tiled_k8s_reach`` and the packed engines' changes, and
the profile-bound span log that keeps them on the profiler's clock.

Every test but the last runs on the CPU under a CPU ``torch.profiler``; the
last is marked ``cuda`` and checks the clock on the card. The file imports
neither JAX nor the JAX package.
"""
import dataclasses
import logging

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.encode.ports import rule_named_specs
from kubernetes_verification_tpu_torch.observe import spans
from kubernetes_verification_tpu_torch.observe.metrics import SPAN_SECONDS


@pytest.fixture(autouse=True)
def _no_memory_hook(monkeypatch):
    """Attrs as the spans set them: no memory snapshot hook that another
    test in the process left installed."""
    monkeypatch.setattr(spans, "_memory_hook", None)


def _cluster(seed=5, **kw):
    gen = dict(n_pods=64, n_policies=12, n_namespaces=3, p_ports=0.8,
               p_named_port=0.3, p_container_ports=0.5, seed=seed)
    return kvt.random_cluster(kvt.GeneratorConfig(**{**gen, **kw}))


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    """``fn()`` under a profiler: its result, the span log it left and the
    profiler's raw events."""
    spans.clear_profiled_spans()
    with profile(activities=list(activities)) as prof:
        out = fn()
    log = spans.profiled_spans()
    spans.clear_profiled_spans()
    return out, log, list(prof.profiler.kineto_results.events())


def _children(log, parent):
    return [s for s in log if s.parent_id == parent.span_id]


def _root(log):
    return [s for s in log if s.parent_id is None]


@pytest.mark.parametrize("ports,use_kernel", [(False, None), (False, True),
                                              (True, None), (True, True)])
def test_encode_and_solve_spans_nest_as_in_the_table(ports, use_kernel):
    cluster = _cluster()

    def run():
        enc = kvt.encode_cluster(cluster, compute_ports=ports)
        return enc, kvt.tiled_k8s_reach(enc, device="cpu", fetch=False,
                                        use_kernel=use_kernel)

    (enc, res), log, _ = _profiled(run)
    assert len(enc.atoms) > 1 if ports else len(enc.atoms) == 1
    roots = _root(log)
    assert [s.name for s in roots] == ["encode", "solve"]
    encode, solve = roots
    assert len(log) <= 11
    kids = _children(log, encode)
    want = ["encode.labels"] + (["encode.ports"] if ports else []) + ["encode.grants"] * 2
    assert [s.name for s in kids] == want
    grants = [dict(s.attrs) for s in kids[-2:]]
    assert [g.pop("direction") for g in grants] == ["ingress", "egress"]
    # port lookups are counted only where the port axis has atoms
    assert all(set(g) <= ({"port_lookups", "port_builds"} if ports else set())
               for g in grants)
    assert [s.name for s in _children(log, solve)] == [
        "solve.prologue", "solve.upload", "solve.maps", "solve.kernel", "solve.sync"]
    # only what a reader reads is counted: these spans carry no attrs
    assert all(not s.attrs for s in log if s.name != "encode.grants")
    for s in log:
        assert s.start_ns <= s.end_ns
        kids = _children(log, s)
        assert all(s.start_ns <= k.start_ns and k.end_ns <= s.end_ns for k in kids)


def _port_lookups(cluster, direction):
    """The port lookups an encode's rules ask for in one direction, and the
    distinct keys among them: port-spec sets, then named specs."""
    rules = [r for p in cluster.policies
             for r in (p.ingress if direction == "ingress" else p.egress) or ()]
    specs = [frozenset(r.ports) for r in rules if r.ports]
    named = [k for r in rules for k in rule_named_specs(r)]
    return len(specs) + len(named), len(set(specs)) + len(set(named))


def test_encode_grants_counts_its_port_lookups_and_the_ones_it_built():
    cluster = _cluster(seed=5, n_pods=300, n_policies=80, port_library_size=4)
    _, log, _ = _profiled(lambda: kvt.encode_cluster(cluster, compute_ports=True))
    grants = [s for s in log if s.name == "encode.grants"]
    assert [s.attrs["direction"] for s in grants] == ["ingress", "egress"]
    for s in grants:
        lookups, builds = _port_lookups(cluster, s.attrs["direction"])
        assert (s.attrs["port_lookups"], s.attrs["port_builds"]) == (lookups, builds)
        assert lookups > builds > 0  # repeated keys were served, not rebuilt
    _, log, _ = _profiled(lambda: kvt.encode_cluster(cluster, compute_ports=False))
    # the any-port axis ignores port specs: nothing looked up, nothing counted
    assert [s.attrs for s in log if s.name == "encode.grants"] == [
        {"direction": "ingress"}, {"direction": "egress"}]


def _engines():
    return [
        (kvt.PackedIncrementalVerifier, dict(compute_ports=False)),
        (kvt.PackedPortsIncrementalVerifier, dict(compute_ports=True)),
    ]


def _changes(cluster):
    """One call a change kind, each ``f(engine)``."""
    pols = cluster.policies
    ns = cluster.pods[0].namespace
    added = dataclasses.replace(pols[0], name="added-policy")
    updated = dataclasses.replace(pols[1], pod_selector=pols[2].pod_selector)
    pod = kvt.Pod("added-pod", ns, {"fresh": "yes"})
    return [
        ("pod_relabel", lambda e: e.update_pod_labels(3, {"relabelled": "yes"})),
        ("policy_add", lambda e: e.add_policy(added)),
        ("policy_update", lambda e: e.update_policy(updated)),
        ("policy_remove", lambda e: e.remove_policy(pols[3].namespace, pols[3].name)),
        ("pod_add", lambda e: e.add_pod(pod)),
        ("pod_remove", lambda e: e.remove_pod(pod.namespace, pod.name)),
        ("namespace_relabel", lambda e: e.update_namespace_labels(ns, {"team": "new"})),
    ]


@pytest.mark.parametrize("cls,cfg", _engines(), ids=["packed", "packed-ports"])
def test_each_change_is_an_engine_span_over_evaluate_and_dispatch(cls, cfg):
    cluster = _cluster(seed=9)
    eng = cls(cluster, kvt.VerifyConfig(**cfg), device="cpu")
    for op, call in _changes(cluster):
        _, log, _ = _profiled(lambda: call(eng))
        roots = _root(log)
        assert [s.name for s in roots] == [f"engine.{op}"], op
        assert roots[0].attrs == {}
        kids = _children(log, roots[0])
        assert [s.name for s in kids] == ["engine.evaluate", "engine.dispatch"], op
        assert len(log) == 3, op
        evaluate, dispatch = kids
        assert min(evaluate.attrs["rows"], evaluate.attrs["cols"]) >= 0, op
        assert dispatch.attrs == {}, op
    # the namespace's own bookkeeping: no evaluation, no device work
    for op, call in (("namespace_add", lambda e: e.add_namespace(kvt.Namespace("fresh-ns"))),
                     ("namespace_remove", lambda e: e.remove_namespace("fresh-ns"))):
        _, log, _ = _profiled(lambda: call(eng))
        assert [s.name for s in log] == [f"engine.{op}"]


@pytest.mark.parametrize("cls,cfg", _engines(), ids=["packed", "packed-ports"])
def test_a_policy_change_counts_the_lines_it_re_derives(cls, cfg, monkeypatch):
    cluster = _cluster(seed=11)
    eng = cls(cluster, kvt.VerifyConfig(**cfg), device="cpu")
    # the call that takes the diff's rows and columns to the device
    name, at = (("_dispatch_diff", 2) if cls is kvt.PackedIncrementalVerifier
                else ("_apply", 0))
    patched = []
    write = getattr(eng, name)
    monkeypatch.setattr(eng, name, lambda *a: patched.append(
        (len(a[at]), len(a[at + 1]))) or write(*a))
    pol = cluster.policies[0]
    _, log, _ = _profiled(lambda: eng.remove_policy(pol.namespace, pol.name))
    evaluate = next(s for s in log if s.name == "engine.evaluate")
    # the rows and columns counted are those the device re-derives
    assert patched == [(evaluate.attrs["rows"], evaluate.attrs["cols"])]
    assert evaluate.attrs["rows"] + evaluate.attrs["cols"] > 0


@pytest.mark.parametrize("cls,cfg", _engines(), ids=["packed", "packed-ports"])
def test_a_change_records_its_spans_only_where_something_reads_them(cls, cfg, monkeypatch):
    cluster = _cluster(seed=17)
    eng = cls(cluster, kvt.VerifyConfig(**cfg), device="cpu")
    first, second = cluster.policies[:2]
    events = logging.getLogger("kvtpu")
    level = events.level
    monkeypatch.setattr(spans, "_span_sinks", [])
    events.setLevel(logging.WARNING)
    try:
        count = SPAN_SECONDS.labels(name="engine.policy_remove").count
        eng.remove_policy(first.namespace, first.name)
        assert SPAN_SECONDS.labels(name="engine.policy_remove").count == count
        seen = []
        spans.add_span_sink(seen.append)
        eng.remove_policy(second.namespace, second.name)
    finally:
        events.setLevel(level)
    assert [s.name for s in seen] == [
        "engine.evaluate", "engine.dispatch", "engine.policy_remove"]
    assert SPAN_SECONDS.labels(name="engine.policy_remove").count == count + 1


@pytest.mark.parametrize("cls,cfg", _engines(), ids=["packed", "packed-ports"])
def test_an_engine_build_runs_in_phases_and_keeps_its_timings(cls, cfg):
    cluster = _cluster(seed=13)
    eng, log, _ = _profiled(lambda: cls(cluster, kvt.VerifyConfig(**cfg), device="cpu"))
    assert eng.build_timings.keys() == {"encode", "maps", "kernel", "vectorizer"}
    assert eng.init_time == sum(eng.build_timings.values())
    build = [s for s in log if s.name.startswith("engine.build.")]
    assert [s.name for s in build] == [
        "engine.build.encode", "engine.build.maps", "engine.build.kernel",
        "engine.build.vectorizer"]
    assert all(s.parent_id is None for s in build)
    assert [s.name for s in _children(log, build[0])] == ["encode"]


def test_without_a_profiler_nothing_is_logged_and_nothing_annotated(monkeypatch):
    made = []
    fast = torch._C._profiler._RecordFunctionFast
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: made.append(name) or fast(name))
    spans.clear_profiled_spans()
    enc = kvt.encode_cluster(_cluster(), compute_ports=True)
    kvt.tiled_k8s_reach(enc, device="cpu", fetch=False)
    assert spans.profiled_spans() == [] and made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.trace("annotated"):
            pass
    assert made == ["annotated"]
    spans.clear_profiled_spans()


def test_a_torch_without_the_host_side_record_gets_no_annotation(monkeypatch):
    # a user-scope record_function would be mirrored onto the card as busy
    # time, so the span is only logged
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast")

    def run():
        with spans.trace("unannotated"):
            pass

    _, log, events = _profiled(run)
    assert [s.name for s in log] == ["unannotated"]
    assert "unannotated" not in {e.name() for e in events}


def _starts_agree(log, events, name, tol_ns=200_000):
    entry = next(s for s in log if s.name == name)
    host = [e for e in events if e.name() == name]
    assert host, f"no profiler event named {name}"
    assert min(abs(e.start_ns() - entry.start_ns) for e in host) < tol_ns
    return host


def test_a_logged_start_lies_within_a_fifth_of_a_millisecond_of_its_event():
    def run():
        with spans.trace("clock.outer"):
            with spans.trace("clock.inner"):
                torch.ones(128, 128).matmul(torch.ones(128, 128))

    _, log, events = _profiled(run)
    for name in ("clock.outer", "clock.inner"):
        _starts_agree(log, events, name)


def test_the_log_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "PROFILED_SPANS_MAX", 3)

    def run():
        for i in range(5):
            with spans.trace(f"bounded.{i}"):
                pass
        return spans.profiled_spans_dropped()

    dropped, log, _ = _profiled(run)
    assert [s.name for s in log] == ["bounded.0", "bounded.1", "bounded.2"]
    assert dropped == 2 and spans.profiled_spans_dropped() == 0


@pytest.mark.cuda
def test_on_the_card_the_log_shares_the_profilers_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.autograd import DeviceType

    a = torch.ones(1024, 1024, device="cuda")

    def run():
        # the first record of a fresh profile pays its setup between the
        # two stamps (0.33 ms seen on an H100); the spans after it are held
        with spans.trace("card.first"):
            pass
        for _ in range(3):
            with spans.trace("card.span"):
                (a @ a).sum().item()

    _, log, events = _profiled(run, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    host = [e for e in events if e.name() == "card.span"]
    assert len(host) == 3 and all(e.device_type() == DeviceType.CPU for e in host)
    entries = [s for s in log if s.name == "card.span"]
    for entry, event in zip(entries, sorted(host, key=lambda e: e.start_ns())):
        assert abs(event.start_ns() - entry.start_ns) < 200_000
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA]
    for entry in entries:
        assert any(entry.start_ns <= k.start_ns() <= entry.end_ns for k in kernels)
