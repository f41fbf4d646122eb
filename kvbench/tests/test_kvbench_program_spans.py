"""The readers of the program's span log: self time a step, the card's idle
time inside a span, the traced window's bounds, and nothing to read without
a trace or a log. The runs and their logs are built by hand."""
import pytest

from kvbench import program_spans, run
from kvbench.mixes import Run
from kvbench.trace import Trace
from kubernetes_verification_tpu_torch.observe.spans import LoggedSpan

S = 1_000_000_000  # ns a second


def _span(name, a, b, sid, pid=None, **attrs):
    return LoggedSpan(name, int(a * S), int(b * S), attrs, sid, pid)


#: two verification steps in a window [10, 20] s, and spans outside it
VERIFY_LOG = [
    _span("encode.labels", 10.6, 10.8, "l1", "e1"),
    _span("encode.grants", 10.9, 11.0, "g1", "e1", direction="ingress"),
    _span("encode.grants", 11.0, 11.2, "g2", "e1", direction="egress"),
    _span("encode", 10.5, 11.5, "e1"),
    _span("solve.sync", 12.9, 13.0, "y1", "s1"),
    _span("solve", 12.0, 13.0, "s1"),
    _span("encode.labels", 14.0, 14.4, "l2", "e2"),
    _span("encode", 14.0, 14.5, "e2"),
    _span("solve", 15.0, 15.5, "s2"),
    # before and after the window: the warm-up and the check
    _span("encode.labels", 5.0, 9.0, "l0", "e0"),
    _span("encode", 4.0, 9.5, "e0"),
    _span("solve", 19.9, 21.0, "s3"),
]

CHURN_LOG = [
    _span("engine.evaluate", 10.1, 10.13, "v1", "c1", rows=1, cols=1),
    _span("engine.dispatch", 10.13, 10.14, "d1", "c1"),
    _span("engine.pod_relabel", 10.1, 10.15, "c1"),
    _span("engine.evaluate", 11.0, 11.01, "v2", "c2", rows=40, cols=18),
    _span("engine.dispatch", 11.01, 11.03, "d2", "c2"),
    _span("engine.policy_add", 11.0, 11.04, "c2"),
]


def _run(kind, steps, device=(), window=(10.0, 20.0)):
    rec = Run(kind, "cpu", steps=[{}] * steps)
    rec.trace = Trace(device=list(device), window=window)
    return rec


@pytest.fixture
def log(monkeypatch):
    entries = []
    monkeypatch.setattr(program_spans, "profiled_spans", lambda: list(entries))
    monkeypatch.setattr(program_spans, "profiled_spans_dropped", lambda: 0)
    return entries


def read(name, rec):
    return run.metric_reader(name)(rec)


def test_self_time_a_step_subtracts_the_direct_children(log):
    log += VERIFY_LOG
    rec = _run("verify", 2)
    # encode: 1.0 s less its three children (0.5 s), and 0.5 s less 0.4 s
    assert program_spans.self_ms(rec, "encode") == pytest.approx((500 + 100) / 2)
    assert read("encode_labels_ms.verify", rec) == pytest.approx((200 + 400) / 2)
    assert read("encode_grants_ms.verify", rec) == pytest.approx((100 + 200) / 2)
    assert read("solve_sync_ms.verify", rec) == pytest.approx(100 / 2)
    # no span of the name in the window: nothing to read
    assert read("encode_ports_ms.verify", rec) is None
    assert read("solve_prologue_ms.verify", rec) is None


def test_only_spans_inside_the_traced_window_count(log):
    log += VERIFY_LOG
    names = [(s.name, s.span_id) for s in program_spans.window_spans(_run("verify", 2))]
    assert ("encode", "e0") not in names and ("solve", "s3") not in names
    assert ("encode", "e1") in names and len(names) == 9
    # a window that holds the warm-up's spans alone
    early = _run("verify", 1, window=(3.0, 9.9))
    assert read("encode_labels_ms.verify", early) == pytest.approx(4000)


def test_idle_inside_a_span_is_its_time_less_the_cards_busy_time(log):
    log += VERIFY_LOG
    device = [("k", 12.2, 12.5), ("k", 12.4, 12.8), ("k", 13.5, 14.0), ("k", 15.1, 15.2)]
    rec = _run("verify", 2, device=device)
    # solve s1: 1.0 s, busy 12.2-12.8; solve s2: 0.5 s, busy 0.1 s
    assert read("solve_idle_ms.verify", rec) == pytest.approx((400 + 400) / 2)
    assert program_spans.idle_ms(rec, "encode") == pytest.approx((1000 + 500) / 2)


def test_nothing_to_read_without_a_trace_a_log_or_a_device(log, monkeypatch):
    log += VERIFY_LOG
    assert read("solve_idle_ms.verify", _run("verify", 2)) is None  # the CPU
    untraced = _run("verify", 2)
    untraced.trace = None
    assert read("encode_labels_ms.verify", untraced) is None
    assert read("encode_labels_ms.verify", _run("churn", 2)) is None
    monkeypatch.setattr(program_spans, "profiled_spans_dropped", lambda: 1)
    for name in ("encode_labels_ms.verify", "solve_sync_ms.verify"):
        # a log that dropped spans past its bound would read short
        assert read(name, _run("verify", 2)) is None
    monkeypatch.setattr(program_spans, "profiled_spans", None)  # an older program
    for name in ("encode_labels_ms.verify", "solve_idle_ms.verify", "change_lines.p95"):
        assert read(name, _run("verify", 2, device=[("k", 12.0, 13.0)])) is None


def test_a_changes_evaluation_dispatch_and_lines(log):
    log += CHURN_LOG
    rec = _run("churn", 2)
    for split in ("p95", "rate"):
        assert read(f"change_evaluate_ms.{split}", rec) == pytest.approx((30 + 10) / 2)
        assert read(f"change_dispatch_ms.{split}", rec) == pytest.approx((10 + 20) / 2)
        assert read(f"change_lines.{split}", rec) == pytest.approx((2 + 58) / 2)
    assert read("change_lines.p95", _run("verify", 2)) is None
