"""The port's observability core (``observe/``) against the JAX package's:
the same metric families under the same names, kinds and labels, in a
registry of its own; spans that nest and feed the registry; and the
``torch.profiler`` hooks — ``profile_to`` writes a Chrome trace on the CPU,
``capture_profile`` keeps the JAX function's rate limit and return shapes,
and the span annotations land in the trace."""
import json
import os

import pytest
import torch

from kubernetes_verification_tpu import observe as jax_observe
from kubernetes_verification_tpu_torch import observe
from kubernetes_verification_tpu_torch.observe import flight, metrics, spans
from kubernetes_verification_tpu_torch.observe.events import Clock


def _families(reg):
    return {m.name: (type(m).__name__, tuple(m.labelnames)) for m in reg.collect()}


def test_metric_families_equal_the_jax_package_and_are_separate():
    assert _families(observe.REGISTRY) == _families(jax_observe.REGISTRY)
    assert observe.REGISTRY is not jax_observe.REGISTRY
    before = jax_observe.metrics.SERVE_BATCHES_TOTAL.value
    metrics.SERVE_BATCHES_TOTAL.inc()
    assert jax_observe.metrics.SERVE_BATCHES_TOTAL.value == before
    assert "kvtpu_serve_batches_total" in observe.REGISTRY.dump()["counters"]


def test_spans_nest_and_feed_the_registry():
    seen = []
    observe.add_span_sink(seen.append)
    try:
        with observe.trace("outer", k=1) as outer:
            with observe.trace("inner") as inner:
                assert observe.current_span() is inner
            assert observe.current_span() is outer
        with pytest.raises(RuntimeError):
            with observe.trace("broken"):
                raise RuntimeError("boom")
    finally:
        observe.remove_span_sink(seen.append)
    assert [s.name for s in seen] == ["inner", "outer", "broken"]
    inner_s, outer_s, broken = seen
    assert inner_s.parent is outer_s and inner_s.depth == outer_s.depth + 1
    assert inner_s.trace_id == outer_s.trace_id and inner_s.parent_id == outer_s.span_id
    assert broken.ok is False and outer_s.ok is True
    assert metrics.SPAN_SECONDS.labels(name="inner").count >= 1
    # the trace context crosses a wire header and back
    with observe.trace("client") as client:
        header = observe.trace_headers()[observe.TRACE_HEADER]
    assert observe.parse_trace_header(header) == (client.trace_id, client.span_id)


def test_phases_accumulate_like_the_jax_package():
    ph, jph = spans.Phases(), jax_observe.Phases()
    for p in (ph, jph):
        with p("encode"):
            pass
        with p("encode"):
            pass
    assert set(ph.timings) == set(jph.timings) == {"encode"}


def _trace_files(root):
    out = []
    for d, _, files in os.walk(root):
        out += [os.path.join(d, f) for f in files if f.endswith(".pt.trace.json")]
    return out


def test_profile_to_writes_a_chrome_trace_with_the_span_names(tmp_path):
    log_dir = str(tmp_path / "prof")
    with observe.profile_to(log_dir):
        with observe.trace("profiled_region"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = _trace_files(log_dir)
    assert len(files) == 1
    assert os.path.relpath(files[0], log_dir).split(os.sep)[:2] == ["plugins", "profile"]
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "profiled_region" in names and "aten::matmul" in names
    # outside a capture the span adds no profiler annotation
    assert not torch.autograd._profiler_enabled()
    assert spans._device_annotation("x").__class__.__name__ == "nullcontext"


class _Clock(Clock):
    def __init__(self):
        self.t = 50.0

    def perf(self):
        return self.t

    def wall(self):
        return 1.0e9 + self.t


def test_capture_profile_is_rate_limited_by_the_injected_clock(tmp_path, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(observe.events, "_clock", clock)
    spans.reset_profile_rate_limit()
    cap = str(tmp_path / "captures")
    first = observe.capture_profile(0.01, trigger="api", capture_dir=cap, min_interval=30.0)
    assert first["outcome"] == "ok" and first["files"] == 1
    assert len(_trace_files(first["path"])) == 1
    clock.t += 10.0
    second = observe.capture_profile(0.01, trigger="api", capture_dir=cap, min_interval=30.0)
    assert second == {"outcome": "rate-limited", "trigger": "api", "retry_after_s": 20.0}
    clock.t += 25.0
    third = observe.capture_profile(0.01, trigger="sigusr1", capture_dir=cap, min_interval=30.0)
    assert third["outcome"] == "ok"
    entries = observe.load_capture_manifest(cap)
    assert [e["trigger"] for e in entries] == ["api", "sigusr1"]
    assert set(first) == {"outcome", "path", "trigger", "seconds", "ts", "files"}
    spans.reset_profile_rate_limit()


def test_flight_recorder_dumps_recent_spans(tmp_path):
    rec = flight.install(str(tmp_path / "flight"))
    try:
        with observe.trace("before_trouble"):
            pass
        path = observe.trigger_dump("breaker-open", backend="serve-dense")
    finally:
        flight.uninstall()
    dump = observe.load_dump(path)
    assert dump["trigger"] == "breaker-open" and dump["info"] == {"backend": "serve-dense"}
    assert any(e.get("name") == "before_trouble" for e in dump["entries"])
    assert rec is not None
