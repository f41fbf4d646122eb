"""The reader of ``encode_port_reuse``: the share of the port lookups of the
``encode.grants`` spans that were served rather than computed, and nothing
where the spans count no lookup. The runs and their logs are built by hand."""
import pytest

from kvbench import program_spans, run
from kvbench.mixes import Run
from kvbench.trace import Trace
from kubernetes_verification_tpu_torch.observe.spans import LoggedSpan

S = 1_000_000_000  # ns a second


def _grants(a, sid, **attrs):
    return LoggedSpan("encode.grants", int(a * S), int((a + 0.1) * S), attrs, sid, None)


def _run(kind="verify", steps=2):
    rec = Run(kind, "cpu", steps=[{}] * steps)
    rec.trace = Trace(device=[], window=(10.0, 20.0))
    return rec


@pytest.fixture
def log(monkeypatch):
    entries = []
    monkeypatch.setattr(program_spans, "profiled_spans", lambda: list(entries))
    monkeypatch.setattr(program_spans, "profiled_spans_dropped", lambda: 0)
    return entries


def read(rec):
    return run.metric_reader("encode_port_reuse.verify")(rec)


def test_the_share_served_is_summed_over_both_directions_and_every_step(log):
    log += [
        _grants(11.0, "g1", direction="ingress", port_lookups=300, port_builds=20),
        _grants(11.2, "g2", direction="egress", port_lookups=100, port_builds=10),
        _grants(13.0, "g3", direction="ingress", port_lookups=300, port_builds=20),
        _grants(13.2, "g4", direction="egress"),  # no port lookups
        _grants(5.0, "g0", direction="ingress", port_lookups=1, port_builds=1),  # warm-up
    ]
    assert read(_run()) == pytest.approx(100 * (1 - 50 / 700))


def test_nothing_to_read_where_no_lookup_was_counted(log, monkeypatch):
    # an any-port encode, or a program whose spans carry no such counts
    log += [_grants(11.0, "g1", direction="ingress"), _grants(11.2, "g2", direction="egress")]
    assert read(_run()) is None
    assert read(_run("churn")) is None
    log.clear()
    assert read(_run()) is None  # no span at all
    monkeypatch.setattr(program_spans, "profiled_spans", None)  # no span log
    assert read(_run()) is None
