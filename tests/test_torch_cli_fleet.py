"""The port's command line against the JAX package's: the fleet commands
(lb, trace, fleet, jobs, profile, top) and metrics, over the port's
``serve/transport.py``.

Each case runs the same argv through both packages' ``main`` (the port's
with ``--device cpu`` where it builds tensors) and compares exit codes and
outputs, exactly, after the recorded differences
(``tests/torch_cli_parity.py``). Both CLIs scrape the same running
replication server and read the same logs and checkpoint directories, so
what is compared is each CLI's own work. The invocations mirror the CLI
cases of the JAX package's ``test_transport.py``, ``test_progress.py``,
``test_observe.py`` and ``test_resilience.py``."""
import json
import os
import socket

import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
from kubernetes_verification_tpu.harness.generate import GeneratorConfig, random_cluster
from kubernetes_verification_tpu.harness.generate import random_event_stream
from kubernetes_verification_tpu.serve import CheckpointManager, EventSource, LeaseFile
from kubernetes_verification_tpu.serve import VerificationService as JaxService
from kubernetes_verification_tpu.serve.events import WalWriter
from kubernetes_verification_tpu_torch.cli import main as port_main
from kubernetes_verification_tpu_torch.observe import ProgressTicker
from kubernetes_verification_tpu_torch.resilience.errors import (
    EXIT_INPUT_ERROR,
    EXIT_OK,
    EXIT_VIOLATIONS,
)
from kubernetes_verification_tpu_torch.serve.transport import ReplicationServer
from torch_cli_parity import Pair, run


@pytest.fixture
def pair(tmp_path, capsys):
    return Pair(tmp_path, capsys)


@pytest.fixture(scope="module")
def leader_dir(tmp_path_factory):
    """A leader's footprint written by the JAX package (epoch-1 WAL of 120
    events, one checkpoint after 60, a renewed lease); both packages'
    followers bootstrap from it. Returns ``(log, ckdir, reach)``."""
    tmp = tmp_path_factory.mktemp("leader")
    cluster = random_cluster(GeneratorConfig(
        n_pods=24, n_policies=10, n_namespaces=3, seed=7,
        p_ipblock_peer=0.0, min_selector_labels=1))
    events = random_event_stream(cluster, n_events=120, seed=3)
    log = str(tmp / "events.jsonl")
    ckdir = str(tmp / "ck")
    os.makedirs(ckdir)
    lease = LeaseFile(ckdir)
    lease.acquire("leader-0", ttl=3600.0)
    svc = JaxService(cluster, jkv.VerifyConfig(backend="cpu", compute_ports=False))
    writer = WalWriter(log, epoch=1, lease=lease)
    src = EventSource(log)
    writer.append(events[:60])
    for b in src.batches(64):
        svc.apply(b)
    CheckpointManager(ckdir).checkpoint(
        svc.engine, log_path=log, log_offset=src.offset, last_seq=src.last_seq)
    writer.append(events[60:])
    for b in src.batches(64):
        svc.apply(b)
    writer.close()
    return log, ckdir, np.asarray(svc.reach(), dtype=bool), svc.engine.pods


def _dead_url():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


def _server(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    log = str(d / "wal.jsonl")
    open(log, "w").close()
    return ReplicationServer(str(d), log, port=0)


def test_lb_routes_batches_and_gates_denials(pair, leader_dir, tmp_path):
    log, ckdir, reach, pods = leader_dir
    probes = [{"src": f"{pods[i].namespace}/{pods[i].name}",
               "dst": f"{pods[j].namespace}/{pods[j].name}"}
              for i in range(4) for j in range(4)]
    batch = str(tmp_path / "probes.jsonl")
    with open(batch, "w") as fh:
        fh.writelines(json.dumps(p) + "\n" for p in probes)
    with ReplicationServer(ckdir, log, port=0) as server:
        out = pair.same(["lb", "--replica", ckdir, "--replica",
                         f"{{root}}/net={server.url}", "--leader", ckdir,
                         "--batch", batch, "--seed", "0", "--json"])
    (b,) = out["batches"]
    assert b["n"] == 16 and b["allowed"] == int(reach[:4, :4].sum())
    assert [r["replica"] for r in out["lb"]["replicas"]] == ["replica-0", "replica-1"]
    runs = pair.run(["lb", "--replica", ckdir, "--batch", batch, "--check-denied",
                     "--json"])
    denied = 16 - int(reach[:4, :4].sum())
    assert runs["jax"].rc == runs["port"].rc == (EXIT_VIOLATIONS if denied else EXIT_OK)
    text = pair.same_text(["lb", "--replica", ckdir, "--batch", batch])
    assert "answered by replica-0" in text


def _trace_log(tmp_path):
    """An event log of one cross-process trace (two logs, a shared span)."""
    tid = "feedbeadfeedbead"
    lines = [
        {"event": "span", "trace_id": tid, "span_id": "a1", "name": "fleet_query",
         "seconds": 0.5, "start_ts": 10.0, "ts": 10.5},
        {"event": "span", "trace_id": tid, "span_id": "b1", "parent_id": "a1",
         "name": "query_batch", "seconds": 0.4, "start_ts": 10.05, "ts": 10.45},
        {"event": "span", "trace_id": tid, "span_id": "c1", "parent_id": "b1",
         "name": "query_solve", "stage": "solve", "seconds": 0.3, "start_ts": 10.1,
         "ts": 10.4},
        {"event": "span", "trace_id": tid, "span_id": "c2", "parent_id": "b1",
         "name": "query_d2h", "stage": "d2h", "seconds": 0.05, "start_ts": 10.4,
         "ts": 10.45, "ok": False},
        {"event": "retry", "trace_id": tid, "ts": 10.2},
        {"event": "span", "trace_id": "0" * 16, "span_id": "zz", "name": "other",
         "seconds": 1.0},
    ]
    a = tmp_path / "a.jsonl"
    b = tmp_path / "b.jsonl"
    a.write_text("".join(json.dumps(x) + "\n" for x in lines[:3]) + "not json\n")
    b.write_text("".join(json.dumps(x) + "\n" for x in lines[1:]))
    return tid, str(a), str(b)


def test_trace_reassembles_timeline(pair, tmp_path):
    tid, a, b = _trace_log(tmp_path)
    out = pair.same(["trace", tid, "--log", a, "--log", b, "--json"])
    assert [s["name"] for s in out["spans"]] == [
        "fleet_query", "query_batch", "query_solve", "query_d2h"]
    assert set(out["stages"]) == {"solve", "d2h"} and len(out["events"]) == 1
    txt = pair.same_text(["trace", tid, "--log", a, "--log", b])
    assert txt.startswith(f"trace {tid}:") and "FAILED" in txt and "stages:" in txt
    runs = pair.run(["trace", "feedfeedfeedfeed", "--log", a])
    assert runs["jax"].rc == runs["port"].rc == EXIT_VIOLATIONS
    for argv in (["trace", "--log", a], ["trace", "--slowest", "--log", a]):
        runs = pair.run(argv)
        assert runs["jax"].rc == runs["port"].rc and isinstance(runs["port"].rc, str)


def test_trace_slowest_resolves_exemplar(pair, tmp_path):
    """The metric → trace loop: the highest latency exemplar of a saved
    metrics text names the trace both CLIs reassemble."""
    from kubernetes_verification_tpu_torch.observe.export import to_prometheus
    from kubernetes_verification_tpu_torch.observe.metrics import QUERY_LATENCY_SECONDS
    from kubernetes_verification_tpu_torch.observe.spans import trace_context

    trace_id = "feedbead" * 2
    with trace_context(trace_id):
        QUERY_LATENCY_SECONDS.labels(stage="total").observe(43210.5)
    metrics_file = tmp_path / "metrics.prom"
    metrics_file.write_text(to_prometheus(exemplars=True))
    log = tmp_path / "events.jsonl"
    log.write_text(json.dumps({"event": "span", "trace_id": trace_id, "span_id": "s1",
                               "name": "solve", "seconds": 43210.5, "start_ts": 10.0,
                               "ts": 43220.5}) + "\n")
    out = pair.same_text(["trace", "--slowest", "--stage", "total",
                          "--metrics", str(metrics_file), "--log", str(log)])
    assert trace_id in out and "solve" in out
    runs = pair.run(["trace", "--slowest", "--stage", "nope", "--metrics",
                     str(metrics_file), "--log", str(log)])
    assert runs["jax"].rc == runs["port"].rc == EXIT_VIOLATIONS


def test_fleet_renders_table_and_gates_on_burn(pair, leader_dir):
    log, ckdir, _, _ = leader_dir
    with ReplicationServer(ckdir, log, port=0) as server:
        runs = pair.run(["fleet", "--replica", server.url, "--json"])
        assert runs["jax"].rc == runs["port"].rc == EXIT_OK
        j, p = runs["jax"].json(), runs["port"].json()
        (rep,) = p["replicas"]
        assert rep["ok"] and rep["health"]["role"] == "leader"
        assert set(p["slo"]["availability"]) == {"5m", "1h"}
        # the scrape's own latency and the live health's clocks move
        # between the two scrapes
        for doc in (j, p):
            for r in doc["replicas"]:
                r.pop("health")
                r.pop("scrape_seconds", None)
        assert p == j
        runs = pair.run(["fleet", "--replica", server.url, "--replica", _dead_url(),
                         "--slo", "availability=0.999", "--timeout", "0.5"])
        assert runs["jax"].rc == runs["port"].rc == EXIT_VIOLATIONS
        assert "DOWN" in runs["port"].out and "[BURNING]" in runs["port"].out
        assert "slo availability:" in runs["port"].out
    runs = pair.run(["fleet", "--replica", "http://x", "--slo", "nope"])
    assert runs["jax"].rc == runs["port"].rc and "bad SLO spec" in runs["port"].rc


def test_jobs_and_top_over_live_replicas(pair, tmp_path):
    a = _server(tmp_path, "top-a")
    b = _server(tmp_path, "top-b")
    dead = _dead_url()
    with a, b:
        t = ProgressTicker("cli_fleet_demo", total=8, unit="pass")
        t.tick(3)
        try:
            runs = pair.run(["jobs", "--replica", a.url, "--replica", dead])
            assert runs["jax"].rc == runs["port"].rc == EXIT_OK
            assert "cli_fleet_demo" in runs["port"].out and "3/8" in runs["port"].out
            assert "DOWN" in runs["port"].err
            out = pair.same(["jobs", "--json", "--replica", a.url, "--replica", dead],
                            drop=["jobs"])
            assert out["down"][0]["url"] == dead
            runs = pair.run(["jobs", "--json", "--replica", a.url])
            mine = [j for j in runs["port"].json()["jobs"] if j["job"] == "cli_fleet_demo"]
            assert mine and mine[0]["replica"] == a.url
            runs = pair.run(["top", "--once", "--replica", a.url, "--replica", b.url,
                             "--replica", dead])
        finally:
            t.finish()
    assert runs["jax"].rc == runs["port"].rc == EXIT_OK
    out = runs["port"].out
    assert a.url in out and b.url in out and "cli_fleet_demo" in out
    assert "DOWN" in out and "qps" in out and "lag_s" in out and "burn" in out
    # the frame's layout alike: same lines, line for line, up to the live
    # columns (ages, lags, rates) of the replica rows
    jl, pl = runs["jax"].out.splitlines(), out.splitlines()
    assert len(pl) == len(jl)
    assert [ln.split()[:1] for ln in pl] == [ln.split()[:1] for ln in jl]
    runs = pair.run(["top", "--once", "--replica", dead, "--slo", "nope"])
    assert runs["jax"].rc == runs["port"].rc and "bad SLO spec" in runs["port"].rc


def test_profile_local_capture_and_rate_limit(pair, tmp_path, capsys):
    """A local capture is the port's ``torch.profiler`` trace (the JAX
    package's a ``jax.profiler`` one); outcomes and exit codes alike, the
    back-to-back capture rate-limited."""
    from kubernetes_verification_tpu.observe.spans import (
        reset_profile_rate_limit as jax_reset,
    )
    from kubernetes_verification_tpu_torch.observe.spans import reset_profile_rate_limit

    jax_reset(), reset_profile_rate_limit()
    try:
        runs = pair.run(["profile", "--seconds", "0.05", "--dir", "{root}/prof", "--json"])
        j, p = runs["jax"].json(), runs["port"].json()
        assert runs["jax"].rc == runs["port"].rc == EXIT_OK
        assert p["outcome"] == j["outcome"] == "ok" and p["files"] >= 1
        assert p["path"].startswith("<root>/prof/")
        runs = pair.run(["profile", "--seconds", "0.05", "--dir", "{root}/prof"])
        assert runs["jax"].rc == runs["port"].rc == EXIT_VIOLATIONS
        assert "rate-limited" in runs["port"].err
    finally:
        jax_reset(), reset_profile_rate_limit()
    r = run(port_main, ["profile", "--seconds", "0.05", "--dir", str(tmp_path / "p2")], capsys)
    reset_profile_rate_limit()
    assert r.rc == EXIT_OK and "captured" in r.out


def test_profile_on_a_running_replica(pair, tmp_path):
    from kubernetes_verification_tpu_torch.observe.spans import reset_profile_rate_limit

    reset_profile_rate_limit()
    with _server(tmp_path, "prof") as server:
        r = run(port_main, ["profile", "--replica", server.url, "--seconds", "0.05",
                            "--json"], pair.capsys)
        assert r.rc == EXIT_OK and json.loads(r.out)["outcome"] == "ok"
        # the server's rate limit answers both CLIs' next request with HTTP
        # 429, which each client raises as a ReplicationError (exit 2)
        runs = pair.run(["profile", "--replica", server.url, "--seconds", "0.05",
                         "--json"])
        assert runs["jax"].rc == runs["port"].rc == EXIT_INPUT_ERROR
        assert "rate-limited" in runs["jax"].err and "rate-limited" in runs["port"].err
    reset_profile_rate_limit()


def test_metrics_schema_and_metrics_out(pair, tmp_path):
    """The live registry's metric families alike (names per kind: the
    values are this process's), ``--format prom`` and a saved dump."""
    runs = pair.run(["metrics"])
    assert runs["jax"].rc == runs["port"].rc == 0
    j, p = runs["jax"].json(), runs["port"].json()
    for kind in ("counters", "gauges", "histograms"):
        assert set(p[kind]) >= set(j[kind]) - {"kvtpu_jit_compile_seconds"}, kind
    for family in ("kvtpu_verify_total", "kvtpu_retries_total", "kvtpu_fallbacks_total",
                   "kvtpu_faults_injected_total", "kvtpu_degradations_total"):
        assert family in p["counters"], family
    runs = pair.run(["metrics", "--format", "prom"])
    assert "# TYPE kvtpu_span_seconds histogram" in runs["port"].out
    pair.same_text(["generate", "{root}/m", "--pods", "24", "--policies", "4"])
    d = os.path.join(pair.roots["jax"], "m")
    runs = pair.run(["verify", d, "--backend", "cpu", "--json",
                     "--metrics-out", "{root}/mx.json", "--log-json"])
    assert runs["jax"].rc == runs["port"].rc == 0
    dump = json.loads(open(os.path.join(pair.roots["port"], "mx.json")).read())
    assert {"encode", "compile", "solve", "verify"} <= set(dump["spans"])
    assert "backend=cpu" in dump["gauges"]["kvtpu_pairs_per_second"]
    events = [json.loads(ln) for ln in runs["port"].err.splitlines() if ln.startswith("{")]
    assert [e.get("name") for e in events].count("verify") == 1
    r = run(port_main, ["metrics", os.path.join(pair.roots["port"], "mx.json")], pair.capsys)
    assert r.rc == 0 and json.loads(r.out) == dump
    runs = pair.run(["metrics", "{root}/mx.json", "--format", "prom"])
    assert runs["jax"].rc == runs["port"].rc and "--format prom" in runs["port"].rc
