"""The port's network transport (``serve/transport.py``) and load balancer
(``serve/lb.py``) against the JAX package's, on the CPU. Both servers serve
the same bytes for the same directory (WAL ranges with their crc32, the
checkpoint listing, file chunks with their sha256, the tip); a port follower
bootstraps from a JAX ``ReplicationServer`` and a JAX follower from the
port's, and each ends equal to its leader; ``RemoteEventSource`` resumes
after a sequence number alike; ``/healthz`` reports the AOT pack absent; a
networked follower whose leader went away promotes on its standby lease;
the load balancer routes, retries and ejects alike. Every server binds an
ephemeral port and every client carries its own timeout. Exact throughout."""
import json
import os

import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
from kubernetes_verification_tpu.serve import durability as jdur
from kubernetes_verification_tpu.serve import events as jev
from kubernetes_verification_tpu.serve import lb as jlb
from kubernetes_verification_tpu.serve import replication as jrep
from kubernetes_verification_tpu.serve import service as jax_service
from kubernetes_verification_tpu.serve import transport as jtr
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.observe import spans as pspans
from kubernetes_verification_tpu_torch.resilience.breaker import CLOSED, OPEN
from kubernetes_verification_tpu_torch.resilience.errors import (
    ReplicationError,
    StaleReadError,
)
from kubernetes_verification_tpu_torch.resilience.retry import RetryPolicy
from kubernetes_verification_tpu_torch.serve import VerificationService
from kubernetes_verification_tpu_torch.serve import durability as pdur
from kubernetes_verification_tpu_torch.serve import events as pev
from kubernetes_verification_tpu_torch.serve import lb as plb
from kubernetes_verification_tpu_torch.serve import replication as prep
from kubernetes_verification_tpu_torch.serve import transport as ptr
from torch_serve_parity import clusters, install_clock, streams

_GEN = dict(n_pods=24, n_policies=10, n_namespaces=3, seed=7,
            p_ipblock_peer=0.0, min_selector_labels=1)
_CK_AT = 40
#: per-request timeout of every client here (seconds)
_TIMEOUT = 5.0
_PFAST = RetryPolicy(max_retries=0, backoff_base=0.001)


@pytest.fixture(scope="module")
def churn():
    pcluster, jcluster = clusters(**_GEN)
    pevents, jevents = streams(jcluster, 80, seed=3)
    return pcluster, jcluster, pevents, jevents


def _leader(directory, pkg, cluster, events):
    """One package's leader footprint (lease at epoch 1, epoch-1 WAL of
    ``_CK_AT`` events, one checkpoint); returns ``(log, ck, svc, writer,
    source)`` with the writer open. ``pkg`` is ``"port"`` or ``"jax"``."""
    ev, dur, rep = (pev, pdur, prep) if pkg == "port" else (jev, jdur, jrep)
    log = os.path.join(directory, "events.jsonl")
    ck = os.path.join(directory, "ck")
    os.makedirs(ck, exist_ok=True)
    lease = rep.LeaseFile(ck)
    lease.acquire("leader-0", ttl=60.0)
    if pkg == "port":
        svc = VerificationService(cluster, kvt.VerifyConfig(compute_ports=False),
                                  device="cpu")
    else:
        svc = jax_service.VerificationService(cluster, jkv.VerifyConfig(compute_ports=False))
    writer = ev.WalWriter(log, epoch=1, lease=lease, fsync=False)
    src = ev.EventSource(log)
    writer.append(events[:_CK_AT])
    for b in src.batches(64):
        svc.apply(b)
    dur.CheckpointManager(ck, fsync=False).checkpoint(
        svc.engine, log_path=log, log_offset=src.offset, last_seq=src.last_seq)
    return log, ck, svc, writer, src


def _tree(root):
    """``{relative path: bytes}`` of every file under ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


def _raw(client, path):
    body, headers = client._request("raw", path)
    return body, {k: v for k, v in headers.items() if k.startswith("X-KVTPU")}


def test_both_servers_serve_the_same_bytes(churn, tmp_path, monkeypatch):
    _, jcluster, _, jevents = churn
    log, ck, _, writer, _ = _leader(str(tmp_path), "jax", jcluster, jevents)
    writer.append(jevents[_CK_AT:60])
    writer.close()
    with ptr.ReplicationServer(ck, log, port=0) as ps, \
            jtr.ReplicationServer(ck, log, port=0) as js:
        assert ps.port != 0 and js.port != 0
        pc = ptr.ReplicationClient(ps.url, timeout=_TIMEOUT, policy=_PFAST)
        jc = ptr.ReplicationClient(js.url, timeout=_TIMEOUT, policy=_PFAST)
        for path in ("/v1/wal?offset=0&limit=1000", "/v1/wal?offset=777&limit=4096",
                     "/v1/wal?start_after_seq=44&limit=100000",
                     "/v1/checkpoint/manifest"):
            assert _raw(pc, path) == _raw(jc, path), path
        manifest = pc.manifest()
        gen = manifest["generation"]
        for entry in manifest["files"]:
            path = f"/v1/checkpoint/file?generation={gen}&path={entry['path']}&offset=0&limit=65536"
            assert _raw(pc, path) == _raw(jc, path), entry["path"]
        ptip, jtip = pc.tip(), jc.tip()
        for tip in (ptip, jtip):
            tip.pop("server_time")
            tip["lease"].pop("age_seconds")
        assert ptip == jtip and ptip["last_seq"] == 59 and ptip["last_epoch"] == 1
        # a traversal and a bad range are refused alike (HTTP 404)
        for path in (f"/v1/checkpoint/file?generation={gen}&path=../manifest&offset=0",
                     "/v1/wal?offset=-1"):
            errs = []
            for c in (pc, jc):
                with pytest.raises(ReplicationError) as ei:
                    c._request("raw", path)
                errs.append(str(ei.value).replace(c.base_url, "URL"))
            assert errs[0] == errs[1]
        # the AOT pack is reported absent, with the reason; no JAX tooling
        health = pc.healthz()
        assert health["aot"]["present"] is False and "build cache" in health["aot"]["reason"]
        assert health["role"] == "leader" and health["last_seq"] == 59
        assert "kvtpu_" in pc.metrics_text()
        # /profile is the port's torch.profiler capture into the server's
        # profile directory (a rate-limited second request is HTTP 429)
        monkeypatch.setattr(pspans, "_last_capture_perf", None)
        prof = pc.profile(seconds=0.05)
        assert prof["outcome"] == "ok" and prof["path"].startswith(ps.profile_dir)
        with pytest.raises(ReplicationError, match="429"):
            pc.profile(seconds=0.05)
    assert ptr.wal_offset_after_seq(log, 44) == jtr.wal_offset_after_seq(log, 44)
    assert ptr.wal_offset_after_seq(log, -1) == 0


@pytest.mark.parametrize("leader_pkg", ["jax", "port"])
def test_followers_bootstrap_across_the_packages(leader_pkg, churn, tmp_path, monkeypatch):
    """A follower of each package bootstraps over HTTP from one leader (of
    either package), mirrors its checkpoint file for file, tails its WAL
    and ends equal to it after every batch."""
    install_clock(monkeypatch)
    pcluster, jcluster, pevents, jevents = churn
    events = jevents if leader_pkg == "jax" else pevents
    cluster = jcluster if leader_pkg == "jax" else pcluster
    log, ck, leader, writer, lsrc = _leader(str(tmp_path / "leader"), leader_pkg,
                                            cluster, events)
    server_mod = jtr if leader_pkg == "jax" else ptr
    with server_mod.ReplicationServer(ck, log, port=0) as server:
        pf = prep.FollowerService(str(tmp_path / "pf"), leader_url=server.url,
                                  replica="pf", device="cpu", auto_catch_up=False,
                                  transport_timeout=_TIMEOUT)
        jf = jrep.FollowerService(str(tmp_path / "jf"), leader_url=server.url,
                                  replica="jf", auto_catch_up=False,
                                  transport_timeout=_TIMEOUT)
        assert pf.recovery.outcome == jf.recovery.outcome == "newest"
        gen = pf.recovery.generation
        want = _tree(os.path.join(ck, f"gen-{gen:08d}"))
        for root in ("pf", "jf"):
            assert _tree(os.path.join(str(tmp_path / root), f"gen-{gen:08d}")) == want
        for i in range(_CK_AT, len(events), 20):
            writer.append(events[i:i + 20])
            for b in lsrc.batches(64):
                leader.apply(b)
            assert pf.catch_up() == jf.catch_up() == len(events[i:i + 20])
            assert pf.lag().caught_up and jf.lag().caught_up
            assert pf.generation == jf.generation
            np.testing.assert_array_equal(pf.service.reach(), np.asarray(leader.reach()))
            np.testing.assert_array_equal(jf.service.reach(), np.asarray(leader.reach()))
        assert open(os.path.join(str(tmp_path / "pf"), "wal-mirror.jsonl"), "rb").read() == \
            open(log, "rb").read()
        d = pf.describe()
        assert d["leader_url"] == server.url and d["transport_error"] is None
        assert pf.health()["leader_url"] == server.url
    writer.close()


def test_remote_event_source_resumes_after_a_seq(churn, tmp_path):
    _, jcluster, pevents, jevents = churn
    log, ck, _, writer, _ = _leader(str(tmp_path / "leader"), "jax", jcluster, jevents)
    writer.close()
    with jtr.ReplicationServer(ck, log, port=0) as server:
        src = ptr.RemoteEventSource(
            ptr.ReplicationClient(server.url, timeout=_TIMEOUT, policy=_PFAST),
            str(tmp_path / "p-mirror.jsonl"), start_after_seq=29)
        jsrc = jtr.RemoteEventSource(
            jtr.ReplicationClient(server.url, timeout=_TIMEOUT),
            str(tmp_path / "j-mirror.jsonl"), start_after_seq=29)
        got = list(src.replay())
        want = list(jsrc.replay())
        assert [pev.encode_event(e) for e in got] == [jev.encode_event(e) for e in want]
        assert [pev.encode_event(e) for e in got] == \
            [pev.encode_event(e) for e in pevents[30:_CK_AT]]
        assert (src.last_seq, src.skipped, src.offset) == (jsrc.last_seq, jsrc.skipped,
                                                          jsrc.offset)
        assert src.last_seq == _CK_AT - 1 and src.last_contact is not None
        assert open(tmp_path / "p-mirror.jsonl", "rb").read() == open(log, "rb").read()
    # the leader went away: the failure is kept, not raised
    assert list(src.replay()) == [] and isinstance(src.last_error, ReplicationError)


def test_networked_follower_promotes_on_its_standby_lease(churn, tmp_path, monkeypatch):
    install_clock(monkeypatch)
    _, jcluster, _, jevents = churn
    log, ck, _, writer, _ = _leader(str(tmp_path / "leader"), "jax", jcluster, jevents)
    writer.close()
    server = jtr.ReplicationServer(ck, log, port=0)
    server.start()
    try:
        f = prep.FollowerService(str(tmp_path / "pf"), leader_url=server.url, replica="pf",
                                 device="cpu", breaker_threshold=2, lease_ttl=5.0,
                                 transport_timeout=_TIMEOUT)
        assert f.heartbeat() and f.probe.state == CLOSED
        f.catch_up()
    finally:
        server.close()
    f.client.policy = _PFAST
    assert not f.heartbeat() and not f.heartbeat()
    assert f.probe.state == OPEN
    assert f.maybe_promote() and f.epoch == 2
    assert f.source.detached and f.lease.read().holder == "pf"
    assert pev.scan_wal(f.log_path).last_epoch == 1


class _StubLag:
    def __init__(self, seconds):
        self.seconds = seconds
        self.seq = 0


class _StubReplica:
    def __init__(self, name, lag_seconds=0.0, raises=None):
        self.replica = name
        self.lag_seconds = lag_seconds
        self.raises = raises
        self.calls = 0

    def lag(self):
        return _StubLag(self.lag_seconds)

    def can_reach_batch(self, probes):
        self.calls += 1
        if self.raises is not None:
            raise self.raises
        return np.ones(len(probes), dtype=bool)


def _fleet(mod, errors):
    fresh = _StubReplica("fresh", 0.0)
    laggy = _StubReplica("laggy", 60.0)
    dead = _StubReplica("dead", 0.0, raises=errors.ReplicationError("refused", op="wal"))
    stale = _StubReplica("stale", 0.1, raises=errors.StaleReadError("past the bound"))
    leader = _StubReplica("leader-proxy")
    return mod.QueryLoadBalancer([fresh, laggy, dead, stale], leader=leader, seed=11,
                                 breaker_threshold=2), (fresh, laggy, dead, stale, leader)


def test_load_balancer_routes_retries_and_ejects_alike():
    plbal, pstubs = _fleet(plb, kvt.resilience.errors)
    jlbal, jstubs = _fleet(jlb, jkv.resilience.errors)
    for lbal in (plbal, jlbal):
        for _ in range(40):
            lbal.can_reach_batch([("a", "b")])
    assert plbal.routed == jlbal.routed
    assert (plbal.stale_retries, plbal.ejections) == (jlbal.stale_retries, jlbal.ejections)
    assert [s.calls for s in pstubs] == [s.calls for s in jstubs]
    assert {k: b.state for k, b in plbal.breakers.items()} == \
        {k: b.state for k, b in jlbal.breakers.items()}
    assert plbal.breakers["dead"].state == OPEN and plbal.breakers["stale"].state == CLOSED
    assert json.dumps(plbal.describe(), sort_keys=True, default=str) == \
        json.dumps(jlbal.describe(), sort_keys=True, default=str)
    lone = plb.QueryLoadBalancer([_StubReplica("stale", raises=StaleReadError("x"))], seed=0)
    with pytest.raises(StaleReadError):
        lone.can_reach_batch([("a", "b")])
    with pytest.raises(ReplicationError, match="at least one replica"):
        plb.QueryLoadBalancer([])
