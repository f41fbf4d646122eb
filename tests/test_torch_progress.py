"""The port's progress plane (``observe/progress.py``) and exporters
(``observe/export.py``) against the JAX package's, on the CPU: under one
fake clock a ``ProgressTicker`` publishes the same job snapshots, rates,
ETAs and metrics, and renders the same table; the closures drive their
tickers and count ``kvtpu_closure_iterations_total``,
``kvtpu_delta_closure_rounds_total`` and
``kvtpu_closure_bounded_levels_total`` as the JAX closures do, the packed
closure through its one pass-boundary hook (``on_pass``); the Prometheus
text of a registry and its parse are the same bytes. Exact throughout."""
import math

import numpy as np
import pytest

from kubernetes_verification_tpu.observe import REGISTRY as JAX_REGISTRY
from kubernetes_verification_tpu.observe import events as jevents
from kubernetes_verification_tpu.observe import export as jexport
from kubernetes_verification_tpu.observe import progress as jprogress
from kubernetes_verification_tpu.observe import registry as jregistry
from kubernetes_verification_tpu.ops import closure as jclosure
from kubernetes_verification_tpu.serve.durability import load_closure_checkpoint
from kubernetes_verification_tpu_torch.observe import REGISTRY
from kubernetes_verification_tpu_torch.observe import events as pevents
from kubernetes_verification_tpu_torch.observe import export as pexport
from kubernetes_verification_tpu_torch.observe import progress as pprogress
from kubernetes_verification_tpu_torch.observe import registry as pregistry
from kubernetes_verification_tpu_torch.ops import closure as pclosure
from torch_parity import words

_METRICS = ("kvtpu_closure_iterations_total", "kvtpu_delta_closure_rounds_total",
            "kvtpu_closure_bounded_levels_total", "kvtpu_progress_passes_total")


class _Clock(pevents.Clock):
    def __init__(self):
        self.t = 5000.0

    def wall(self):
        return self.t

    def perf(self):
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(pevents, "_clock", c)
    monkeypatch.setattr(jevents, "_clock", c)
    return c


def _strip(snap):
    return {k: v for k, v in snap.items() if k not in ("job_id", "pid")}


def _ticker_trace(mod, clock):
    out = []
    with mod.ProgressTicker("parity-job", total=10, unit="level", initial=1) as t:
        for step, dt in ((2, 0.5), (None, 0.25), (5, 1.0), (4, 0.5), (9, 2.0)):
            clock.t += dt
            t.tick(step, extra="x")
            out.append((t.done, t.fraction, t.rate, t.eta_s,
                        [_strip(j) for j in mod.active_jobs() if j["job"] == "parity-job"]))
    out.append([j for j in mod.active_jobs() if j["job"] == "parity-job"])
    unknown = mod.ProgressTicker("parity-open", total=0)
    clock.t += 1.0
    unknown.tick()
    out.append((unknown.total, unknown.fraction, unknown.eta_s, unknown.rate))
    unknown.finish("error")
    unknown.finish("done")
    out.append(unknown.outcome)
    return out


def test_ticker_snapshots_rates_and_etas_equal_jax(clock):
    mine = _ticker_trace(pprogress, clock)
    clock.t = 5000.0
    assert mine == _ticker_trace(jprogress, clock)
    assert mine[-3] == [] and mine[-1] == "error"


@pytest.mark.parametrize("frac", [None, 0.0, 0.37, 1.0, 1.7, -0.5, float("nan"), float("inf")])
def test_eta_bar_and_job_table_equal_jax(frac):
    assert pprogress.eta_bar(frac) == jprogress.eta_bar(frac)
    jobs = [{"job_id": "a-1", "unit": "pass", "done": 3, "total": 17, "fraction": frac,
             "rate": 1.25, "eta_s": 4000.0},
            {"job": "b", "done": 2, "total": 0, "fraction": None, "rate": None,
             "eta_s": None},
            {"job_id": "c-9", "unit": "file", "done": 7, "total": None, "rate": 0.5,
             "eta_s": 75.0}]
    assert pprogress.render_jobs(jobs) == jprogress.render_jobs(jobs)


def _counts(registry):
    dump = registry.dump()["counters"]
    return {n: dict(dump.get(n, {})) for n in _METRICS}


def _delta(before, after):
    return {n: {k: v - before[n].get(k, 0.0) for k, v in after[n].items()
                if v != before[n].get(k, 0.0)} for n in after}


def _chain(n):
    bits = np.zeros((n, n), bool)
    bits[np.arange(n - 1), np.arange(1, n)] = True
    return np.packbits(bits, axis=1, bitorder="little").view("<u4")


def test_closure_tickers_and_metrics_equal_jax(clock, tmp_path):
    """Every closure loop counts its passes, rounds and levels as the JAX
    package's does; ``packed_closure``'s ticker is what calls ``on_pass``
    (and commits the pass checkpoints), with the job live in
    ``active_jobs`` at every pass."""
    w = _chain(128)
    rng = np.random.default_rng(1)
    extra = _chain(128)
    extra[rng.integers(0, 128, 6), rng.integers(0, 4, 6)] |= np.uint32(1 << 7)
    prev = np.asarray(jclosure.packed_closure(w))
    dirty = np.zeros(128, bool)
    dirty[:4] = True

    def run_jax():
        jclosure.packed_closure(w)
        jclosure.packed_closure_delta(extra, prev, dirty, prev_base=w)
        jclosure.packed_closure_delta(w, np.asarray(jclosure.packed_closure(extra)), dirty)
        jclosure.bounded_packed_closure(w, [0, 5], hops=6)
        jclosure.bounded_closure_rows(lambda i: np.eye(128, dtype=bool)[(i + 1) % 128],
                                      [0, 3], 128, hops=5)

    seen = []

    def on_pass(k, packed, pairs):
        jobs = [j for j in pprogress.active_jobs() if j["job"] == "packed_closure"]
        seen.append((k, pairs, jobs[0]["done"], jobs[0]["total"]))

    def run_port():
        pclosure.packed_closure(w, device="cpu", on_pass=on_pass)
        pclosure.packed_closure_delta(extra, prev, dirty, prev_base=w, device="cpu")
        pclosure.packed_closure_delta(
            w, pclosure.packed_closure(extra, device="cpu"), dirty, device="cpu")
        pclosure.bounded_packed_closure(w, [0, 5], hops=6, device="cpu")
        pclosure.bounded_closure_rows(lambda i: np.eye(128, dtype=bool)[(i + 1) % 128],
                                      [0, 3], 128, hops=5, device="cpu")

    jb, pb = _counts(JAX_REGISTRY), _counts(REGISTRY)
    run_jax()
    run_port()
    jd, pd = _delta(jb, _counts(JAX_REGISTRY)), _delta(pb, _counts(REGISTRY))
    assert pd == jd
    assert all(pd[n] for n in _METRICS)
    bound = math.ceil(math.log2(128))
    assert [s[0] for s in seen] == list(range(1, len(seen) + 1))
    assert all(done == k and total == bound for k, _, done, total in seen)
    assert not [j for j in pprogress.active_jobs() if j["job"] == "packed_closure"]
    # the checkpoint commit rides the same pass boundary
    mine, theirs = str(tmp_path / "p"), str(tmp_path / "j")
    out = pclosure.packed_closure(w, device="cpu", checkpoint_dir=mine, checkpoint_every=2)
    jclosure.packed_closure(w, checkpoint_dir=theirs, checkpoint_every=2)
    (arr, passes, _), (jarr, jpasses, _) = (load_closure_checkpoint(d) for d in (mine, theirs))
    assert passes == jpasses == len(seen)
    np.testing.assert_array_equal(arr, jarr)
    np.testing.assert_array_equal(words(out), jarr)


def test_prometheus_text_and_parse_equal_jax():
    regs = []
    for mod in (pregistry, jregistry):
        reg = mod.MetricsRegistry()
        c = mod.Counter("kvtpu_demo_total", "demo counter", ("kind",), registry=reg)
        c.labels(kind="a").inc(3)
        c.labels(kind='b"q').inc(0.5)
        g = mod.Gauge("kvtpu_demo_gauge", "demo gauge", registry=reg)
        g.set(-2.25)
        h = mod.Histogram("kvtpu_demo_seconds", "demo histogram", buckets=(0.1, 1.0),
                          registry=reg)
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        regs.append(reg)
    ptext, jtext = pexport.to_prometheus(regs[0]), jexport.to_prometheus(regs[1])
    assert ptext == jtext
    assert pexport.parse_prometheus(ptext) == jexport.parse_prometheus(jtext)
    assert pexport.dump_registry(regs[0]) == jexport.dump_registry(regs[1])
