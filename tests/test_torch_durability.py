"""Checkpoints and recovery of the port (``serve/durability.py``) against
the JAX package's, on the CPU: a checkpoint written by either package is
recovered by the other with the same manifests, the same ladder rung and
the same replayed WAL tail, on the dense and the packed engine; a corrupted
newest generation falls back alike; a closure pass checkpoint of either
package resumes ``packed_closure`` in the other; and a SIGKILLed port
service (a kill-point in a child process) recovers bit for bit against a
CPU-oracle solve of the surviving log prefix. Exact throughout."""
import os
import subprocess
import sys

import numpy as np
import pytest

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.ops.closure import packed_closure as jax_packed_closure
from kubernetes_verification_tpu.serve import durability as jdur
from kubernetes_verification_tpu.serve import events as jev
from kubernetes_verification_tpu.serve import replication as jrep
from kubernetes_verification_tpu_torch.resilience.errors import PersistError
from kubernetes_verification_tpu_torch.serve import VerificationService
from kubernetes_verification_tpu_torch.serve import durability as pdur
from kubernetes_verification_tpu_torch.serve import events as pev
from torch_parity import words
from torch_serve_parity import clusters, dense_services, packed_services, streams

_HERE = os.path.dirname(os.path.abspath(__file__))
_CHILD = os.path.join(_HERE, "torch_durability_child.py")
_BATCH = 20
_VOLATILE = ("snapshot_digest", "checksum", "event_log")


def _serve_durably(ev_mod, dur_mod, svc, events, workdir, every=2):
    """The write path of one package: WAL append, apply, checkpoint every
    ``every`` batches; returns the log path."""
    os.makedirs(workdir, exist_ok=True)
    log = os.path.join(workdir, "events.jsonl")
    cm = dur_mod.CheckpointManager(os.path.join(workdir, "ck"), retain=3, fsync=False)
    source = ev_mod.EventSource(log)
    with ev_mod.WalWriter(log, fsync=False) as writer:
        for k, i in enumerate(range(0, len(events), _BATCH)):
            writer.append(events[i:i + _BATCH])
            for batch in source.batches(_BATCH):
                svc.apply(batch)
            if (k + 1) % every == 0:
                cm.checkpoint(svc.engine, log_path=log,
                              log_offset=source.offset, last_seq=source.last_seq)
    return log


def _manifests(directory, load):
    out = []
    for name in sorted(os.listdir(directory)):
        if name.startswith("manifest-"):
            m = load(os.path.join(directory, name))
            out.append({k: v for k, v in m.items() if k not in _VOLATILE})
    return out


def _result(res):
    wal = res.wal
    return dict(outcome=res.outcome, generation=res.generation,
                replayed=res.replayed, duplicates_skipped=res.duplicates_skipped,
                last_seq=res.last_seq, errors=len(res.errors),
                wal=None if wal is None else (wal.records, wal.last_seq,
                                              wal.valid_bytes, wal.torn))


@pytest.fixture(scope="module")
def churn():
    pcluster, jcluster = clusters(n_pods=72, n_policies=12, seed=31)
    pevents, jevents = streams(jcluster, 200, seed=6)
    return pcluster, jcluster, pevents, jevents


@pytest.fixture(params=["dense", "packed"])
def served(request, churn, tmp_path):
    """Both packages serve 160 events durably (checkpoints every 2 batches),
    then 40 more events land in each WAL without being applied."""
    pcluster, jcluster, pevents, jevents = churn
    build = dense_services if request.param == "dense" else packed_services
    psvc, jsvc = build(pcluster, jcluster)
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    plog = _serve_durably(pev, pdur, psvc, pevents[:160], pdir)
    jlog = _serve_durably(jev, jdur, jsvc, jevents[:160], jdir)
    with pev.WalWriter(plog, fsync=False) as w:
        w.append(pevents[160:])
    with jev.WalWriter(jlog, fsync=False) as w:
        w.append(jevents[160:])
    psvc.apply(pevents[160:])  # the live state after every logged event
    return request.param, psvc, pdir, plog, jdir, jlog


def _recovered_equal(pres, jres, live, where):
    assert _result(pres) == _result(jres), where
    np.testing.assert_array_equal(pres.service.reach(), jres.service.reach(), err_msg=where)
    np.testing.assert_array_equal(pres.service.reach(), live.reach(), err_msg=where)
    if live.packed:
        np.testing.assert_array_equal(words(pres.service.engine._packed),
                                      words(live.engine._packed), err_msg=where)


def test_checkpoints_recover_across_packages(served):
    kind, live, pdir, plog, jdir, jlog = served
    assert open(plog, "rb").read() == open(jlog, "rb").read()
    assert _manifests(os.path.join(pdir, "ck"), pdur.load_manifest) == \
        _manifests(os.path.join(jdir, "ck"), jdur.load_manifest)
    # the port recovers the JAX package's checkpoint, and the JAX package
    # the port's; each also recovers its own
    p_of_j = pdur.RecoveryManager(os.path.join(jdir, "ck")).recover(log_path=jlog, device="cpu")
    j_of_p = jdur.RecoveryManager(os.path.join(pdir, "ck")).recover(log_path=plog)
    p_of_p = pdur.RecoveryManager(os.path.join(pdir, "ck")).recover(log_path=plog, device="cpu")
    assert p_of_j.outcome == "newest" and p_of_j.duplicates_skipped == 0
    assert p_of_j.replayed == 40 and p_of_j.service.packed == (kind == "packed")
    _recovered_equal(p_of_j, j_of_p, live, f"{kind} cross")
    _recovered_equal(p_of_p, j_of_p, live, f"{kind} own")
    # the recovered service keeps tailing its positioned source
    assert list(p_of_j.source.replay()) == []
    assert p_of_j.last_seq == 199


def test_inspect_reports_alike_with_the_two_gaps(served):
    kind, _, pdir, plog, jdir, jlog = served
    mine = pdur.RecoveryManager(os.path.join(pdir, "ck")).inspect(log_path=plog)
    theirs = jdur.RecoveryManager(os.path.join(jdir, "ck")).inspect(log_path=jlog)
    strip = lambda r: {k: v for k, v in r.items() if k not in ("directory", "aot_pack")}
    mine_g = [{k: v for k, v in g.items() if k != "event_log"} for g in mine["generations"]]
    theirs_g = [{k: v for k, v in g.items() if k != "event_log"} for g in theirs["generations"]]
    assert mine_g == theirs_g and mine["usable"] and theirs["usable"]
    assert {k: v for k, v in strip(mine)["wal"].items() if k != "path"} == \
        {k: v for k, v in strip(theirs)["wal"].items() if k != "path"}
    assert mine["aot_pack"]["present"] is False and "build cache" in mine["aot_pack"]["reason"]
    # the lease triage is the JAX package's: a damaged lease and a live
    # one are described alike, and inspect goes on
    ck = os.path.join(pdir, "ck")
    open(os.path.join(ck, "leader.lease"), "w").write("{}")
    report = pdur.RecoveryManager(ck).inspect()
    assert report["usable"] and report["lease"]["present"] and "error" in report["lease"]
    assert report["lease"] == jdur.RecoveryManager(ck).inspect()["lease"]
    os.remove(os.path.join(ck, "leader.lease"))
    jrep.LeaseFile(ck).acquire("leader-0", ttl=1e9)
    mine, theirs = pdur.RecoveryManager(ck).inspect(), jdur.RecoveryManager(ck).inspect()
    assert mine["lease"]["epoch"] == 1 and not mine["lease"]["expired"]
    drop = lambda d: {k: v for k, v in d.items() if k != "age_seconds"}
    assert drop(mine["lease"]) == drop(theirs["lease"])


def test_fallback_rung_after_a_corrupted_newest_generation(served):
    kind, live, pdir, plog, jdir, jlog = served
    for d in (pdir, jdir):
        ck = os.path.join(d, "ck")
        newest = max(n for n in os.listdir(ck) if n.startswith("manifest-"))
        with open(os.path.join(ck, newest), "r+") as fh:
            body = fh.read()
            fh.seek(0)
            fh.write(body.replace('"log_offset"', '"log_offsex"'))
    pres = pdur.RecoveryManager(os.path.join(jdir, "ck")).recover(log_path=jlog, device="cpu")
    jres = jdur.RecoveryManager(os.path.join(pdir, "ck")).recover(log_path=plog)
    assert pres.outcome == jres.outcome == "fallback"
    assert pres.replayed == 80 and pres.duplicates_skipped == 0
    _recovered_equal(pres, jres, live, f"{kind} fallback")
    # nothing usable and no initial cluster: a typed refusal
    for d in (pdir,):
        ck = os.path.join(d, "ck")
        for n in os.listdir(ck):
            if n.startswith("manifest-"):
                os.remove(os.path.join(ck, n))
        with pytest.raises(PersistError, match="no usable checkpoint"):
            pdur.RecoveryManager(ck).recover(log_path=plog, device="cpu")


def _chain_words(n):
    """A path graph 0 → 1 → … → n-1 as host uint32 words: its closure
    needs ⌈log₂ n⌉ squaring passes."""
    bits = np.zeros((n, n), bool)
    bits[np.arange(n - 1), np.arange(1, n)] = True
    return np.packbits(bits.reshape(n, n // 32, 32), axis=2,
                       bitorder="little").reshape(n, n // 32, 4).view("<u4")[..., 0]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_packed_closure_resumes_across_packages(tmp_path, writer):
    w = _chain_words(128)
    want = np.asarray(jax_packed_closure(w))
    ck = str(tmp_path / "closure")
    if writer == "port":
        part = kvt.packed_closure(w, max_iter=3, checkpoint_dir=ck, checkpoint_every=1,
                                  device="cpu")
        done = np.asarray(jax_packed_closure(w, checkpoint_dir=ck, resume=True))
    else:
        part = jax_packed_closure(w, max_iter=3, checkpoint_dir=ck, checkpoint_every=1)
        done = words(kvt.packed_closure(w, checkpoint_dir=ck, resume=True, device="cpu"))
    np.testing.assert_array_equal(done, want)
    arr, passes, manifest = pdur.load_closure_checkpoint(ck)
    j_arr, j_passes, _ = jdur.load_closure_checkpoint(ck)
    assert passes == j_passes == 3 and manifest["kind"] == "closure"
    assert arr.dtype == j_arr.dtype == np.uint32
    np.testing.assert_array_equal(arr, words(part))
    # a resume from the checkpoint runs only the passes after it
    seen = []
    kvt.packed_closure(w, checkpoint_dir=ck, resume=True, device="cpu",
                       on_pass=lambda k, _w, _n: seen.append(k))
    assert seen[0] == 4
    # the serving ladder refuses a closure generation
    with pytest.raises(PersistError, match="no usable checkpoint"):
        pdur.RecoveryManager(ck).recover(device="cpu")


def _oracle_reach(pods, log, cluster_kw):
    cluster = kvt.random_cluster(kvt.GeneratorConfig(n_pods=pods, **cluster_kw))
    svc = VerificationService(cluster, kvt.VerifyConfig(compute_ports=False), device="cpu")
    for i, ev in enumerate(pev.read_events(log)):
        svc.apply([ev])
    return cluster, kvt.verify(svc.engine.as_cluster(),
                               kvt.VerifyConfig(backend="cpu", compute_ports=False)).reach


@pytest.mark.parametrize("kind, kill", [("dense", "mid-log-append@37"),
                                        ("packed", "before-rename@2")])
def test_sigkilled_port_service_recovers_bit_exact(tmp_path, kind, kill):
    sys.path.insert(0, _HERE)
    from torch_durability_child import CLUSTER

    proc = subprocess.run(
        [sys.executable, _CHILD, "--workdir", str(tmp_path), "--kill", kill,
         "--kind", kind, "--pods", "32", "--n-events", "120"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 137, proc.stdout + proc.stderr
    log = str(tmp_path / "events.jsonl")
    info = pev.scan_wal(log)  # repairs a torn tail
    if kill.startswith("mid-log-append"):
        assert info.torn and info.records == 37
    cluster, want = _oracle_reach(32, log, CLUSTER)
    res = pdur.RecoveryManager(str(tmp_path / "ck")).recover(
        log_path=log, initial_cluster=cluster, device="cpu")
    assert res.duplicates_skipped == 0
    assert res.last_seq == info.last_seq
    got = res.service.reach()
    if res.service.packed:
        act = res.service.engine.active_indices()
        got = got[np.ix_(act, act)]
    np.testing.assert_array_equal(got, want)


def test_checkpoint_without_pyyaml_recovers_in_both_packages(churn, tmp_path, monkeypatch):
    """The port's checkpoints write their cluster manifests as JSON ``kind:
    List`` documents and need no PyYAML: the port without PyYAML and the JAX
    package both recover them."""
    from kubernetes_verification_tpu_torch.ingest import yaml_io

    pcluster, jcluster, pevents, jevents = churn
    for build in (dense_services, packed_services):
        psvc, _ = build(pcluster, jcluster)
        psvc.apply(pevents[:60])
        ck = str(tmp_path / build.__name__)
        with monkeypatch.context() as m:
            m.setattr(yaml_io, "_yaml", lambda: (None, None))
            info = pdur.CheckpointManager(ck, fsync=False).checkpoint(psvc.engine)
            assert sorted(os.listdir(os.path.join(info.snapshot_dir, "cluster"))) == [
                "namespaces.json", "networkpolicies.json", "pods.json"]
            mine = pdur.RecoveryManager(ck).recover(device="cpu")
        theirs = jdur.RecoveryManager(ck).recover()
        np.testing.assert_array_equal(mine.service.reach(), psvc.reach())
        np.testing.assert_array_equal(theirs.service.reach(), psvc.reach())
