"""The port's replication (``serve/replication.py``) against the JAX
package's, on the CPU. A JAX leader writes its lease, its epoch-stamped WAL
and a checkpoint; a port follower and a JAX follower bootstrap from them and
tail the same stream, and after every batch their engines' state, their
``generation``, their ``lag()`` and their query answers are equal (dense
and packed engines). Lease files are byte-equal and each package reads the
other's; promotion and fencing run under one fake wall clock in both
packages and leave the same bytes on disk; ``inspect``'s lease triage is
the JAX package's. A promoting port follower SIGKILLed right after bumping
the epoch (``tests/torch_replication_child.py``) leaves a state the next
follower takes over from. Exact throughout."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.packed_incremental import (
    PackedIncrementalVerifier as JaxPacked,
)
from kubernetes_verification_tpu.serve import durability as jdur
from kubernetes_verification_tpu.serve import events as jev
from kubernetes_verification_tpu.serve import replication as jrep
from kubernetes_verification_tpu.serve import service as jax_service
from kubernetes_verification_tpu_torch.resilience.breaker import CLOSED, OPEN
from kubernetes_verification_tpu_torch.resilience.errors import (
    FencedError,
    PersistError,
    ServeError,
    StaleReadError,
)
from kubernetes_verification_tpu_torch.serve import VerificationService
from kubernetes_verification_tpu_torch.serve import durability as pdur
from kubernetes_verification_tpu_torch.serve import events as pev
from kubernetes_verification_tpu_torch.serve import replication as prep
from torch_parity import words
from torch_serve_parity import clusters, install_clock, streams

_HERE = os.path.dirname(os.path.abspath(__file__))
_CHILD = os.path.join(_HERE, "torch_replication_child.py")
#: the replication tests' cluster (the child mirrors it)
_GEN = dict(n_pods=24, n_policies=10, n_namespaces=3, seed=7,
            p_ipblock_peer=0.0, min_selector_labels=1)
_CK_AT = 40
_BATCH = 10


class WallClock:
    """An injectable wall clock that starts at the real time (lease stamps
    are wall-clock) and moves only when told to."""

    def __init__(self):
        self.t = time.time()

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


@pytest.fixture(scope="module")
def churn():
    pcluster, jcluster = clusters(**_GEN)
    pevents, jevents = streams(jcluster, 100, seed=3)
    return pcluster, jcluster, pevents, jevents


def _jax_leader(directory, jcluster, jevents, kind, clock, *, ttl=60.0):
    """A JAX leader's footprint: the lease at epoch 1, the epoch-1 WAL of
    the first ``_CK_AT`` events and one checkpoint bound to it. Returns
    ``(log, ck, service, writer, source)``; the writer stays open."""
    log = os.path.join(directory, "events.jsonl")
    ck = os.path.join(directory, "ck")
    os.makedirs(ck, exist_ok=True)
    lease = jrep.LeaseFile(ck, clock=clock)
    lease.acquire("leader-0", ttl=ttl)
    cfg = jkv.VerifyConfig(compute_ports=False)
    if kind == "packed":
        svc = jax_service.VerificationService(
            engine=JaxPacked(jcluster, cfg, keep_matrix=True))
    else:
        svc = jax_service.VerificationService(jcluster, cfg)
    writer = jev.WalWriter(log, epoch=1, lease=lease, fsync=False)
    src = jev.EventSource(log)
    writer.append(jevents[:_CK_AT])
    for b in src.batches(64):
        svc.apply(b)
    jdur.CheckpointManager(ck, fsync=False).checkpoint(
        svc.engine, log_path=log, log_offset=src.offset, last_seq=src.last_seq)
    return log, ck, svc, writer, src


def _engines_equal(pf, jf, where):
    peng, jeng = pf.service.engine, jf.service.engine
    if pf.service.packed:
        want, got = jeng.state_dict(), peng.state_dict()
        assert sorted(want) == sorted(got), where
        for k in want:
            w, g = np.asarray(want[k]), np.asarray(got[k])
            assert (w.dtype, w.shape, w.tobytes()) == (g.dtype, g.shape, g.tobytes()), (
                where, k)
    else:
        for name in ("_ing_count", "_eg_count"):
            assert getattr(peng, name).cpu().numpy().tobytes() == \
                np.asarray(getattr(jeng, name)).tobytes(), (where, name)
        np.testing.assert_array_equal(peng._ing_iso, jeng._ing_iso, err_msg=where)
        np.testing.assert_array_equal(peng._eg_iso, jeng._eg_iso, err_msg=where)


def _lag(f):
    lag = f.lag()
    return lag.seconds, lag.seq


def _followers(log, ck, clock, **kw):
    pf = prep.FollowerService(ck, log_path=log, replica="r1", device="cpu",
                              clock=clock, **kw)
    jf = jrep.FollowerService(ck, log_path=log, replica="r1", clock=clock, **kw)
    return pf, jf


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_followers_of_both_packages_tail_a_jax_leader_alike(
    kind, churn, tmp_path, monkeypatch
):
    install_clock(monkeypatch)
    pcluster, jcluster, pevents, jevents = churn
    clock = WallClock()
    log, ck, leader, writer, lsrc = _jax_leader(str(tmp_path), jcluster, jevents,
                                                kind, clock)
    pf, jf = _followers(log, ck, clock, auto_catch_up=False)
    assert pf.recovery.outcome == jf.recovery.outcome == "newest"
    assert pf.service.packed == (kind == "packed") and pf.service.engine.device.type == "cpu"
    assert pf.service.read_only and pf.describe()["outcome"] == "newest"
    names = [f"{p.namespace}/{p.name}" for p in pcluster.pods]
    rng = np.random.default_rng(4)
    probes = [(names[a], names[b]) for a, b in rng.integers(0, len(names), (48, 2))]
    for i in range(_CK_AT, len(jevents), _BATCH):
        writer.append(jevents[i:i + _BATCH])
        for b in lsrc.batches(64):
            leader.apply(b)
        clock.advance(1.5)
        assert _lag(pf) == _lag(jf) == (1.5, len(jevents[i:i + _BATCH]))
        assert pf.poll() == jf.poll()
        where = f"{kind} batch at {i}"
        assert _lag(pf) == _lag(jf) == (0.0, 0), where
        assert pf.generation == jf.generation, where
        assert pf.applied == jf.applied and pf.source.last_seq == jf.source.last_seq
        _engines_equal(pf, jf, where)
        got = pf.can_reach_batch(probes)
        np.testing.assert_array_equal(got, jf.can_reach_batch(probes), err_msg=where)
        assert pf.who_can_reach_batch(names[:3]) == jf.who_can_reach_batch(names[:3])
        assert pf.blast_radius_batch(names[:3]) == jf.blast_radius_batch(names[:3])
    np.testing.assert_array_equal(pf.service.reach(), leader.reach())
    if kind == "packed":
        np.testing.assert_array_equal(words(pf.service.engine._packed),
                                      np.asarray(leader.engine._packed))
    assert pf.health()["role"] == jf.health()["role"] == "follower"
    writer.close()


def test_staleness_bounds_reject_alike(churn, tmp_path, monkeypatch):
    install_clock(monkeypatch)
    _, jcluster, _, jevents = churn
    clock = WallClock()
    log, ck, _, writer, _ = _jax_leader(str(tmp_path), jcluster, jevents, "dense", clock)
    pf, jf = _followers(log, ck, clock, auto_catch_up=False, max_lag_seq=2)
    writer.append(jevents[_CK_AT:_CK_AT + 5])
    name = f"{jcluster.pods[0].namespace}/{jcluster.pods[0].name}"
    errs = []
    for f, cls in ((pf, StaleReadError), (jf, jkv.resilience.errors.StaleReadError)):
        with pytest.raises(cls) as ei:
            f.can_reach(name, name)
        errs.append((ei.value.lag_seq, ei.value.bound_seq))
    assert errs[0] == errs[1] == (5, 2)
    assert pf.catch_up() == jf.catch_up() == 5
    assert pf.can_reach(name, name) == jf.can_reach(name, name)
    writer.close()


@pytest.mark.parametrize("holder,epoch,ttl", [("leader-0", 1, 5.0), ("r-2", 7, 0.25)])
def test_lease_files_are_byte_equal_and_cross_read(tmp_path, holder, epoch, ttl):
    clock = WallClock()
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "j")
    pl = prep.LeaseFile(str(tmp_path / "p"), clock=clock)
    jl = jrep.LeaseFile(str(tmp_path / "j"), clock=clock)
    assert pl.renew(holder, epoch, ttl).to_dict() == jl.renew(holder, epoch, ttl).to_dict()
    pbytes = open(pl.path, "rb").read()
    assert pbytes == open(jl.path, "rb").read()
    assert json.loads(pbytes)["epoch"] == epoch
    # each package reads, fences and describes the other's lease
    cross_p, cross_j = prep.LeaseFile(jl.path, clock=clock), jrep.LeaseFile(pl.path, clock=clock)
    assert cross_p.read().to_dict() == jl.read().to_dict()
    assert cross_j.read().to_dict() == pl.read().to_dict()
    assert cross_p.describe() == {**jl.describe(), "path": jl.path}
    with pytest.raises(FencedError):
        cross_p.renew("someone-else", epoch, ttl)
    with pytest.raises(jkv.resilience.errors.FencedError):
        cross_j.renew(holder, epoch - 1, ttl)
    clock.advance(ttl)
    assert cross_p.expired() and cross_j.expired()
    assert pl.acquire("next", ttl).epoch == jl.acquire("next", ttl).epoch == epoch + 1
    assert open(pl.path, "rb").read() == open(jl.path, "rb").read()
    with open(pl.path, "w") as fh:
        fh.write("{bit rot")
    with pytest.raises(PersistError):
        pl.read()
    assert pl.expired() and pl.describe()["present"]


def test_promotion_and_fencing_alike_under_one_fake_clock(churn, tmp_path, monkeypatch):
    """The same failover in two copies of one JAX leader's directory, one
    promoted by a port follower, one by a JAX follower: the breaker gate,
    the epoch, the claim and lease files, the fencing of the deposed
    leader and the new reign's WAL bytes are the same."""
    install_clock(monkeypatch)
    _, jcluster, pevents, jevents = churn
    clock = WallClock()
    base = str(tmp_path / "leader")
    log, ck, _, writer, _ = _jax_leader(base, jcluster, jevents, "dense", clock, ttl=5.0)
    writer.append(jevents[_CK_AT:60])
    writer.close()
    pdir, jdir = str(tmp_path / "p"), str(tmp_path / "j")
    shutil.copytree(base, pdir)
    shutil.copytree(base, jdir)
    out = {}
    for d, mod in ((pdir, prep), (jdir, jrep)):
        kw = {"device": "cpu"} if mod is prep else {}
        f = mod.FollowerService(os.path.join(d, "ck"), log_path=os.path.join(d, "events.jsonl"),
                                replica="r2", breaker_threshold=2, lease_ttl=5.0,
                                clock=clock, **kw)
        assert f.heartbeat() and f.probe.state == CLOSED and not f.maybe_promote()
        clock.advance(6.0)
        assert not f.heartbeat() and not f.maybe_promote()
        assert not f.heartbeat() and f.probe.state == OPEN
        assert f.maybe_promote() and f.promoted and f.epoch == 2
        assert f.health()["role"] == "leader"
        out[mod] = f
        clock.advance(-6.0)
    pf, jf = out[prep], out[jrep]
    for name in ("leader.lease", "promote-00000002.claim"):
        assert open(os.path.join(pdir, "ck", name), "rb").read() == \
            open(os.path.join(jdir, "ck", name), "rb").read(), name
    # the deposed leader is fenced: its writer and its renewal are refused
    with pytest.raises(FencedError):
        pev.WalWriter(os.path.join(pdir, "stray.jsonl"), epoch=1,
                      lease=pf.lease).append(pevents[:1])
    with pytest.raises(FencedError):
        pf.lease.renew("leader-0", 1, 5.0)
    with pytest.raises(jkv.resilience.errors.FencedError):
        jev.WalWriter(os.path.join(jdir, "events.jsonl"), epoch=1,
                      lease=jf.lease).append(jevents[:1])
    # the new reign writes one event; a follower of the other package applies it
    pf.writer.append(pevents[60:61])
    jf.writer.append(jevents[60:61])
    assert open(os.path.join(pdir, "events.jsonl"), "rb").read() == \
        open(os.path.join(jdir, "events.jsonl"), "rb").read()
    assert pev.scan_wal(os.path.join(pdir, "events.jsonl")).last_epoch == 2
    reader = jrep.FollowerService(os.path.join(pdir, "ck"),
                                  log_path=os.path.join(pdir, "events.jsonl"),
                                  replica="r3", clock=clock)
    reader.catch_up()
    assert reader.source.last_seq == 60 and reader.source.last_epoch == 2
    assert pf.catch_up() == 1  # the new leader tails its own record too
    np.testing.assert_array_equal(pf.service.reach(), reader.service.reach())


def test_inspect_lease_triage_equals_jax(churn, tmp_path, monkeypatch):
    install_clock(monkeypatch)
    _, jcluster, _, jevents = churn
    log, ck, _, writer, _ = _jax_leader(str(tmp_path), jcluster, jevents, "dense",
                                        time.time, ttl=1e6)
    writer.close()
    drop = lambda d: {k: v for k, v in d.items() if k != "age_seconds"}
    mine = pdur.RecoveryManager(ck).inspect(log_path=log)
    theirs = jdur.RecoveryManager(ck).inspect(log_path=log)
    assert drop(mine["lease"]) == drop(theirs["lease"])
    assert mine["lease"]["epoch"] == 1 and mine["lease"]["holder"] == "leader-0"
    # the JAX leader shipped its pack: the port reads it as foreign
    assert mine["aot_pack"]["present"] and not mine["aot_pack"]["env_match"]
    assert mine["aot_pack"]["matching"] == 0
    with open(prep.lease_path(ck), "w") as fh:
        fh.write("[]")
    assert pdur.RecoveryManager(ck).inspect()["lease"] == \
        jdur.RecoveryManager(ck).inspect()["lease"]


def test_follower_without_a_wal_is_refused(churn, tmp_path):
    pcluster, _, _, _ = churn
    cfg = kvt.VerifyConfig(compute_ports=False)
    ck = str(tmp_path / "ck")
    svc = VerificationService(pcluster, cfg, device="cpu")
    pdur.CheckpointManager(ck, fsync=False).checkpoint(svc.engine)
    with pytest.raises(ServeError, match="no event log"):
        prep.FollowerService(ck, device="cpu")
    with pytest.raises(ServeError, match="not networked"):
        prep.FollowerService(ck, log_path=str(tmp_path / "wal.jsonl"),
                             device="cpu").repoint("http://127.0.0.1:9")


def _run_child(workdir, *args, timeout=120):
    return subprocess.run(
        [sys.executable, _CHILD, "--workdir", str(workdir), *args],
        capture_output=True, text=True, timeout=timeout,
    )


def test_follower_killed_after_promote_epoch_is_taken_over(tmp_path):
    """A port leader runs to its end; a promoting port follower (its wall
    clock skewed past the lease) dies at ``after-promote-epoch``: the lease
    names epoch 2 and nothing was written at it. The next follower promotes
    to epoch 3, fences the dead reigns, writes, and a second follower
    converges on a from-scratch CPU service of the surviving log."""
    proc = _run_child(tmp_path)
    assert proc.returncode == 0, proc.stderr
    proc = _run_child(tmp_path, "--role", "follower", "--promote",
                      "--clock-skew", "3600", "--kill", "after-promote-epoch@0")
    assert proc.returncode == 137, proc.stderr
    ck = str(tmp_path / "ck")
    log = str(tmp_path / "events.jsonl")
    dead = prep.LeaseFile(ck).read()
    assert (dead.epoch, dead.holder) == (2, "child-follower")
    assert pev.scan_wal(log).last_epoch == 1
    assert os.path.exists(os.path.join(ck, "promote-00000002.claim"))

    clock = WallClock()
    clock.advance(7200.0)  # past the dead reign's lease, whatever the skew
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**dict(_GEN, n_pods=32)))
    mk = lambda name: prep.FollowerService(ck, log_path=log, replica=name, device="cpu",
                                           breaker_threshold=2, lease_ttl=5.0, clock=clock)
    winner, other = mk("ra"), mk("rb")
    for _ in range(2):
        winner.heartbeat()
    assert winner.maybe_promote() and winner.epoch == 3
    with pytest.raises(FencedError):
        pev.WalWriter(str(tmp_path / "stray.jsonl"), epoch=2,
                      lease=winner.lease).append([])
    pods = winner.service.engine.pods
    relabel = [pev.UpdatePodLabels(pods[k].namespace, pods[k].name,
                                   {**pods[k].labels, "churn": str(k)}) for k in range(3)]
    winner.writer.append(relabel)
    assert pev.scan_wal(log).last_epoch == 3
    oracle = VerificationService(cluster, kvt.VerifyConfig(compute_ports=False), device="cpu")
    for b in pev.EventSource(log).batches(256):
        oracle.apply(b)
    for f in (winner, other):
        f.catch_up()
        np.testing.assert_array_equal(f.service.reach(), oracle.reach())
