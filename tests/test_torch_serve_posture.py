"""The port's ``PostureTracker`` against the JAX package's, on the CPU, over
one stream on both serving engines: every generation's record (pair counts,
per-namespace movement, witnesses, alerts), the crc'd journal lines (each
package scans the other's journal) and the rule alerts on
``service.violations`` are equal. Exact: the records are integer counts and
names; the two fields that are clock readings (``ts``, ``delta_s``) are left
out of the comparison."""
import json

import numpy as np
import pytest

from kubernetes_verification_tpu.serve import posture as jax_posture
from kubernetes_verification_tpu_torch.resilience.errors import ServeError
from kubernetes_verification_tpu_torch.serve import posture as port_posture
from torch_parity import words
from torch_serve_parity import (
    clusters,
    dense_services,
    packed_services,
    streams,
    violation_lines,
)

_RULES = ["deny ns:ns1 -> ns:ns2", "max-widening 40 pairs/batch",
          "max-narrowing 40 pairs/batch"]
_CLOCK_FIELDS = ("ts", "delta_s", "crc")


def _record(r):
    d = r.to_dict()
    for k in _CLOCK_FIELDS:
        d.pop(k, None)
    return d


def _journal(path):
    out = []
    for line in open(path, encoding="utf-8"):
        d = json.loads(line)
        for k in _CLOCK_FIELDS:
            d.pop(k)
        out.append(d)
    return out


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_posture_records_journal_and_alerts_equal(tmp_path, kind):
    pcluster, jcluster = clusters(n_pods=80, n_policies=12, seed=13)
    pevents, jevents = streams(jcluster, 240, seed=17, p_resync=0.02)
    build = dense_services if kind == "dense" else packed_services
    psvc, jsvc = build(pcluster, jcluster)
    pj, jj = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    ptrk = psvc.enable_posture(
        journal_path=pj, rules=[port_posture.parse_posture_rule(r) for r in _RULES])
    jtrk = jsvc.enable_posture(
        journal_path=jj, rules=[jax_posture.parse_posture_rule(r) for r in _RULES])
    assert ptrk.records[-1].baseline
    assert _record(ptrk.records[-1]) == _record(jtrk.records[-1])
    for i in range(0, 240, 30):
        psvc.apply(pevents[i:i + 30])
        jsvc.apply(jevents[i:i + 30])
        assert len(ptrk.records) == len(jtrk.records), i
        assert _record(ptrk.records[-1]) == _record(jtrk.records[-1]), i
        assert violation_lines(psvc.violations) == violation_lines(jsvc.violations), i
        # the owned words of the retired and front states are the two
        # generations the record diffed
        front = psvc._device_states.peek().arrays["reach_words"]
        jfront = jsvc._device_states.peek().arrays["reach_words"]
        np.testing.assert_array_equal(words(front), np.asarray(jfront))
    assert ptrk.health()["violations"] == jtrk.health()["violations"] > 0
    assert {a["kind"] for r in ptrk.records for a in r.alerts} >= {"deny"}
    assert sum(r.widened for r in ptrk.records) > 0
    assert sum(r.narrowed for r in ptrk.records) > 0
    psvc.close()
    jsvc.close()
    assert _journal(pj) == _journal(jj)
    # each package scans the other's journal, crc and all
    p_scan, j_scan = port_posture.scan_posture(jj), jax_posture.scan_posture(pj)
    assert p_scan.ok and j_scan.ok
    assert [_record(r) for r in p_scan.records] == [_record(r) for r in j_scan.records]
    last = ptrk.records[-1].seq
    assert {k: v for k, v in port_posture.posture_diff(p_scan.records, 0, last).items()} == \
        jax_posture.posture_diff(j_scan.records, 0, last)


def test_posture_running_totals_match_the_reach(tmp_path):
    """The running reachable-pair level of the dense tracker is the
    popcount of the current reach after every batch."""
    pcluster, jcluster = clusters(n_pods=64, n_policies=10, seed=14)
    pevents, _ = streams(jcluster, 120, seed=2)
    psvc, _ = dense_services(pcluster, jcluster)
    trk = psvc.enable_posture()
    for i in range(0, 120, 20):
        psvc.apply(pevents[i:i + 20])
        assert trk.records[-1].reachable_pairs == int(psvc.reach().sum())


def test_posture_refuses_alike():
    pcluster, jcluster = clusters(n_pods=40, n_policies=6, seed=15)
    psvc, _ = dense_services(pcluster, jcluster)
    psvc.enable_posture()
    with pytest.raises(ServeError, match="already enabled"):
        psvc.enable_posture()
    for bad in ("allow ns:a -> ns:b", "max-widening many"):
        with pytest.raises(ValueError):
            port_posture.parse_posture_rule(bad)
        with pytest.raises(ValueError):
            jax_posture.parse_posture_rule(bad)
    assert port_posture.parse_posture_rule(" deny  ns:a ->  ns:b ") == \
        port_posture.PostureRule(kind="deny", spec="deny ns:a -> ns:b",
                                 src_ns="a", dst_ns="b")
