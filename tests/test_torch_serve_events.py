"""The serving plane's event layer of the port (``serve/events.py``) against
the JAX package's: the JSONL codec, ``coalesce``, ``EventSource`` and the
sequenced WAL, byte for byte in both directions (torn tails and mid-stream
corruption included), and the port's ``random_event_stream`` equal to the
JAX generator's. Exact: every comparison is of bytes, strings or ints."""
import os

import pytest

from kubernetes_verification_tpu.harness.generate import (
    random_event_stream as jax_random_event_stream,
)
from kubernetes_verification_tpu.resilience.errors import ServeError as JaxServeError
from kubernetes_verification_tpu.serve import events as jev
from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
from kubernetes_verification_tpu_torch.resilience.errors import IngestError, ServeError
from kubernetes_verification_tpu_torch.serve import events as pev
from torch_serve_parity import clusters, streams


@pytest.fixture(scope="module")
def setup():
    pcluster, jcluster = clusters(n_pods=72, n_policies=12, n_namespaces=3)
    pevents, jevents = streams(jcluster, 260, seed=11, p_resync=0.02)
    return pcluster, jcluster, pevents, jevents


def _lines(mod, events, **kw):
    return [mod.encode_event(e, **kw) for e in events]


@pytest.mark.parametrize("seed, p_resync", [(0, 0.0), (3, 0.02), (8, 0.05)])
def test_random_event_stream_equals_the_jax_generator(seed, p_resync):
    pcluster, jcluster = clusters(n_pods=60, n_policies=10, n_namespaces=3, seed=seed)
    mine = random_event_stream(pcluster, n_events=240, seed=seed, p_resync=p_resync)
    theirs = jax_random_event_stream(jcluster, n_events=240, seed=seed, p_resync=p_resync)
    assert _lines(pev, mine) == _lines(jev, theirs)
    assert {e.kind for e in mine} >= {"update_pod_labels", "add_policy",
                                      "remove_policy", "update_namespace_labels"}


@pytest.mark.parametrize("framing", [{}, {"seq": 7}, {"seq": 41, "epoch": 3}])
def test_codec_equal_in_both_directions(setup, framing):
    _, _, pevents, jevents = setup
    assert {e.kind for e in jevents} == set(jev.EVENT_KINDS)
    for i, (pe, je) in enumerate(zip(pevents, jevents)):
        kw = dict(framing)
        if "seq" in kw:
            kw["seq"] += i
        line = jev.encode_event(je, **kw)
        assert pev.encode_event(pe, **kw) == line
        # port → JAX → port: the decoded records re-encode to the same line
        assert jev.encode_event(jev.decode_event(pev.encode_event(pe, **kw)), **kw) == line
        assert pev.decode_record(line) == (pe, kw.get("seq"))
        assert pev.decode_wal(line)[2] == kw.get("epoch")


def test_codec_rejects_what_the_jax_codec_rejects(setup):
    _, _, pevents, _ = setup
    good = pev.encode_event(pevents[0], seq=5)
    bad = [
        "not json", "[]", '{"no_event": 1}', '{"event": "nope"}',
        good.replace('"seq": 5', '"seq": 6'),  # crc mismatch
        good.replace('"seq": 5', '"seq": "5"'),
        '{"event": "remove_policy"}',
    ]
    for line in bad:
        with pytest.raises(Exception) as jerr:
            jev.decode_event(line)
        with pytest.raises(IngestError):
            pev.decode_event(line)
        assert type(jerr.value).__name__ == "IngestError"


@pytest.mark.parametrize("lo, hi", [(0, 64), (64, 200), (0, 260), (100, 101)])
def test_coalesce_equal(setup, lo, hi):
    _, _, pevents, jevents = setup
    pk, pd = pev.coalesce(pevents[lo:hi])
    jk, jd = jev.coalesce(jevents[lo:hi])
    assert _lines(pev, pk) == _lines(jev, jk)
    assert _lines(pev, pd) == _lines(jev, jd)


def _write(mod, path, events, batches=4):
    with mod.WalWriter(path, fsync=False) as w:
        step = -(-len(events) // batches)
        for i in range(0, len(events), step):
            w.append(events[i:i + step])
        return w.offset


def _info(info):
    return {k: getattr(info, k) for k in ("records", "sequenced", "last_seq",
                                          "valid_bytes", "truncated_bytes",
                                          "torn", "last_epoch")}


def test_wal_bytes_equal_and_each_package_reads_the_other(setup, tmp_path):
    _, _, pevents, jevents = setup
    mine, theirs = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    assert _write(pev, mine, pevents) == _write(jev, theirs, jevents)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    # a second writer resumes the sequence after the existing records
    with pev.WalWriter(mine, fsync=False) as w:
        assert w.next_seq == len(pevents)
        w.append(pevents[:3])
    with jev.WalWriter(theirs, fsync=False) as w:
        w.append(jevents[:3])
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    assert _info(pev.scan_wal(theirs)) == _info(jev.scan_wal(mine))
    # replay with an offset and a sequence floor, in batches
    src_p = pev.EventSource(theirs, offset=0, start_after_seq=99)
    src_j = jev.EventSource(mine, offset=0, start_after_seq=99)
    got_p = [_lines(pev, b) for b in src_p.batches(37)]
    got_j = [_lines(jev, b) for b in src_j.batches(37)]
    assert got_p == got_j
    assert (src_p.offset, src_p.last_seq, src_p.skipped) == (
        src_j.offset, src_j.last_seq, src_j.skipped)
    assert src_p.skipped == 100
    assert [_lines(pev, pev.read_events(mine))] == [_lines(jev, jev.read_events(theirs))]


@pytest.mark.parametrize("cut", [1, 17, 113, 402])
def test_torn_tail_repaired_alike(setup, tmp_path, cut):
    """A log cut mid-record: both scans report the same torn tail, with and
    without repair, and truncate to the same bytes."""
    _, _, pevents, jevents = setup
    ref = str(tmp_path / "ref.jsonl")
    _write(jev, ref, jevents[:40])
    data = open(ref, "rb").read()
    torn = data[: len(data) - cut]
    mine, theirs = str(tmp_path / "p.jsonl"), str(tmp_path / "j.jsonl")
    for path in (mine, theirs):
        open(path, "wb").write(torn)
    assert _info(pev.scan_wal(mine, repair=False)) == _info(jev.scan_wal(theirs, repair=False))
    with pytest.raises(ServeError):
        pev.scan_wal(mine, strict=True)
    with pytest.raises(JaxServeError):
        jev.scan_wal(theirs, strict=True)
    info = pev.scan_wal(mine)
    assert _info(info) == _info(jev.scan_wal(theirs))
    assert info.torn and info.truncated_bytes > 0
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    # the repaired log takes appends again, numbered after the valid prefix
    _write(pev, mine, pevents[50:53], batches=1)
    _write(jev, theirs, jevents[50:53], batches=1)
    assert open(mine, "rb").read() == open(theirs, "rb").read()


def test_mid_stream_corruption_raises_alike(setup, tmp_path):
    _, _, _, jevents = setup
    ref = str(tmp_path / "ref.jsonl")
    _write(jev, ref, jevents[:20])
    lines = open(ref, "rb").read().splitlines(keepends=True)
    lines[7] = lines[7].replace(b'"seq": 7', b'"seq": 8')  # crc no longer holds
    bad = str(tmp_path / "bad.jsonl")
    open(bad, "wb").write(b"".join(lines))
    with pytest.raises(ServeError, match="mid-stream corruption"):
        pev.scan_wal(bad)
    with pytest.raises(JaxServeError, match="mid-stream corruption"):
        jev.scan_wal(bad)
    # a sequence regression is refused by both
    regress = str(tmp_path / "regress.jsonl")
    open(regress, "w").write(
        jev.encode_event(jevents[0], seq=5) + "\n" + jev.encode_event(jevents[1], seq=4) + "\n")
    with pytest.raises(ServeError, match="regressed"):
        pev.scan_wal(regress)
    with pytest.raises(JaxServeError, match="regressed"):
        jev.scan_wal(regress)
    assert os.path.getsize(bad) == sum(len(x) for x in lines)


def test_epoch_regression_fenced_alike(setup, tmp_path):
    """A record of an older lease epoch after a newer one: ``scan_wal``
    refuses it and a tailing ``EventSource`` drops it, in both packages."""
    _, _, _, jevents = setup
    path = str(tmp_path / "epochs.jsonl")
    open(path, "w").write("".join(
        jev.encode_event(e, seq=i, epoch=ep) + "\n"
        for i, (e, ep) in enumerate(zip(jevents[:4], (1, 2, 1, 2)))))
    with pytest.raises(ServeError, match="epoch regressed"):
        pev.scan_wal(path)
    src_p, src_j = pev.EventSource(path), jev.EventSource(path)
    assert _lines(pev, list(src_p.replay())) == _lines(jev, list(src_j.replay()))
    assert (src_p.fenced, src_p.last_epoch) == (src_j.fenced, src_j.last_epoch) == (1, 2)
