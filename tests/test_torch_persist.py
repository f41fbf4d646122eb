"""Checkpoints and manifests across the two packages: the port's
``utils/persist.py`` and ``ingest/`` write the JAX package's files and read
them back, so a dense, packed or ports engine saved by either package resumes
in the other with equal state (exact: every array compared byte for byte); a
resume under other semantic flags, a corrupt array and a truncated file are
refused; results, packed words and manifests round-trip both ways."""
import dataclasses
import json
import os

import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu import ingest as jax_ingest
from kubernetes_verification_tpu.encode.encoder import encode_cluster as jax_encode
from kubernetes_verification_tpu.incremental import IncrementalVerifier as JaxDense
from kubernetes_verification_tpu.ops.tiled import tiled_k8s_reach as jax_tiled
from kubernetes_verification_tpu.packed_incremental import (
    PackedIncrementalVerifier as JaxPacked,
)
from kubernetes_verification_tpu.packed_incremental_ports import (
    PackedPortsIncrementalVerifier as JaxPorts,
)
from kubernetes_verification_tpu.utils import persist as jax_persist
from kubernetes_verification_tpu_torch import ingest
from kubernetes_verification_tpu_torch.resilience.errors import IngestError, PersistError
from kubernetes_verification_tpu_torch.utils import persist
from test_torch_incremental import _assert_equal as assert_dense_equal
from test_torch_packed_incremental import assert_same_state
from torch_parity import to_jax

_ANY = dict(compute_ports=False)


def _cluster(seed=71, **kw):
    gen = dict(n_pods=45, n_policies=9, n_namespaces=3, seed=seed)
    return kvt.random_cluster(kvt.GeneratorConfig(**{**gen, **kw}))


# ------------------------------------------------------------- dense engine


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dense_checkpoint_loads_in_the_other_package(tmp_path, writer):
    c = _cluster()
    port = kvt.IncrementalVerifier(c, kvt.VerifyConfig(**_ANY), device="cpu")
    jax_ = JaxDense(to_jax(c), jkv.VerifyConfig(**_ANY))
    for e, pol in ((port, c.policies[0]), (jax_, to_jax(c.policies[0]))):
        e.remove_policy(pol.namespace, pol.name)
        e.update_pod_labels(4, {"app": "moved"})
    d = str(tmp_path / "ckpt")
    if writer == "jax":
        jax_persist.save_incremental(jax_, d)
        back = persist.load_incremental(d, device="cpu")
        assert_dense_equal(back, jax_, "port resumed from JAX")
        assert back.config.self_traffic and back.config.backend == "cpu"
    else:
        persist.save_incremental(port, d)
        back = jax_persist.load_incremental(d)
        assert_dense_equal(port, back, "JAX resumed from the port")
    # the resumed engine keeps mutating in step with the engine it came from
    pol = c.policies[0]
    if writer == "jax":
        back.add_policy(pol)
        jax_.add_policy(to_jax(pol))
        assert_dense_equal(back, jax_, "after a diff")
    else:
        port.add_policy(pol)
        back.add_policy(to_jax(pol))
        assert_dense_equal(port, back, "after a diff")


def test_dense_checkpoint_refuses_other_flags_and_corruption(tmp_path):
    c = _cluster(seed=72)
    port = kvt.IncrementalVerifier(c, kvt.VerifyConfig(**_ANY), device="cpu")
    d = str(tmp_path / "ckpt")
    persist.save_incremental(port, d)
    with pytest.raises(PersistError, match="self_traffic"):
        persist.load_incremental(d, kvt.VerifyConfig(self_traffic=False, **_ANY), device="cpu")
    with pytest.raises(jax_persist.PersistError, match="self_traffic"):
        jax_persist.load_incremental(d, jkv.VerifyConfig(self_traffic=False, **_ANY))
    # only the backend may differ on a resume
    back = persist.load_incremental(d, kvt.VerifyConfig(backend="cpu", **_ANY), device="cpu")
    np.testing.assert_array_equal(back.reach, port.reach)
    # a corrupt array fails its checksum; a truncated file is unreadable
    state = os.path.join(d, "state.npz")
    with np.load(state) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["ing_iso"] = arrays["ing_iso"] + 1
    np.savez_compressed(state, **arrays)
    with pytest.raises(PersistError, match="sha256 mismatch on array 'ing_iso'"):
        persist.load_incremental(d, device="cpu")
    with open(state, "r+b") as fh:
        fh.truncate(100)
    with pytest.raises(PersistError, match="unreadable or truncated"):
        persist.load_incremental(d, device="cpu")


# ------------------------------------------------------------ packed engines


def _packed_pair(c):
    port = kvt.PackedIncrementalVerifier(c, kvt.VerifyConfig(**_ANY), device="cpu")
    jax_ = JaxPacked(to_jax(c), jkv.VerifyConfig(**_ANY))
    victim = c.pods[6]
    for e, mk in ((port, kvt.Pod), (jax_, jkv.Pod)):
        e.remove_pod(victim.namespace, victim.name)
        e.add_pod(mk("late", victim.namespace, {"app": "late"}))
        e.update_pod_labels(9, {"tier": "moved"})
    assert_same_state(jax_.state_dict(), port.state_dict(), "before the save")
    return port, jax_


@pytest.mark.parametrize("keep_matrix", [None, False])
def test_packed_checkpoint_loads_in_the_other_package(tmp_path, keep_matrix):
    c = _cluster(seed=73)
    port, jax_ = _packed_pair(c)
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_persist.save_packed_incremental(jax_, dj)
    persist.save_packed_incremental(port, dp)
    into_port = persist.load_packed_incremental(dj, device="cpu", keep_matrix=keep_matrix)
    into_jax = jax_persist.load_packed_incremental(dp, keep_matrix=keep_matrix)
    assert_same_state(into_jax.state_dict(), into_port.state_dict(), "cross resumes")
    want = jax_.state_dict()
    if keep_matrix is None:
        assert_same_state(want, into_port.state_dict(), "port resumed from JAX")
    # the same file members, byte for byte, whichever package wrote them;
    # the config envelopes differ only in the backend name (each package's
    # default), so they and the checksums that cover them are read apart
    with np.load(os.path.join(dj, "state.npz")) as a, np.load(os.path.join(dp, "state.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in set(a.files) - {"__config__", "__checksums__"}:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
        ca, cb = (json.loads(bytes(z["__config__"])) for z in (a, b))
        assert (ca.pop("backend"), cb.pop("backend")) == ("cpu", "torch") and ca == cb
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dp))
    with pytest.raises(PersistError, match="default_allow_unselected"):
        persist.load_packed_incremental(
            dj, kvt.VerifyConfig(default_allow_unselected=False, **_ANY), device="cpu")


def test_ports_checkpoint_loads_in_the_other_package(tmp_path):
    c = _cluster(seed=7, n_pods=57, p_ports=0.8, p_named_port=0.3, p_container_ports=0.5)
    cfg = dict(compute_ports=True)
    port = kvt.PackedPortsIncrementalVerifier(c, kvt.VerifyConfig(**cfg), device="cpu")
    jax_ = JaxPorts(to_jax(c), jkv.VerifyConfig(**cfg))
    for e in (port, jax_):
        e.update_pod_labels(3, {"app": "moved"})
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_persist.save_ports_incremental(jax_, dj)
    persist.save_ports_incremental(port, dp)
    into_port = persist.load_ports_incremental(dj, device="cpu")
    into_jax = jax_persist.load_ports_incremental(dp)
    for (wa, wm), (ga, gm), label in (
        (jax_.state_dict(), into_port.state_dict(), "port resumed from JAX"),
        (into_jax.state_dict(), port.state_dict(), "JAX resumed from the port"),
    ):
        assert_same_state(wa, ga, label)
        assert wm == gm, label
    np.testing.assert_array_equal(into_port.reach, jax_.reach)
    with pytest.raises(PersistError, match="direction_aware_isolation"):
        persist.load_ports_incremental(dj, kvt.VerifyConfig(
            direction_aware_isolation=False, **cfg), device="cpu")


# ---------------------------------------------------- results, words, encodings


def test_result_and_packed_words_round_trip_both_ways(tmp_path):
    c = _cluster(seed=74)
    res = kvt.verify(c, kvt.VerifyConfig(backend="cpu", closure=True))
    jres = jkv.verify(to_jax(c), jkv.VerifyConfig(backend="cpu", closure=True))
    persist.save_result(res, str(tmp_path / "p.npz"))
    jax_persist.save_result(jres, str(tmp_path / "j.npz"))
    for back, want in ((jax_persist.load_result(str(tmp_path / "p.npz")), res),
                       (persist.load_result(str(tmp_path / "j.npz")), jres)):
        for f in ("reach", "reach_ports", "src_sets", "dst_sets", "closure"):
            np.testing.assert_array_equal(getattr(back, f), getattr(want, f), err_msg=f)
        assert [(a.protocol, a.lo, a.hi, a.name) for a in back.port_atoms] == [
            (a.protocol, a.lo, a.hi, a.name) for a in want.port_atoms]
        assert back.config.closure and back.n_pods == 45
    enc = kvt.encode_cluster(c, compute_ports=False)
    words = kvt.tiled_k8s_reach(enc, device="cpu", fetch=False)  # int32 tensor words
    jwords = jax_tiled(jax_encode(to_jax(c), compute_ports=False), tile=32, chunk=8)
    persist.save_packed(words, str(tmp_path / "pw.npz"))
    jax_persist.save_packed(jwords, str(tmp_path / "jw.npz"))
    a = jax_persist.load_packed(str(tmp_path / "pw.npz"))
    b = persist.load_packed(str(tmp_path / "jw.npz"))
    assert b.packed.dtype == np.uint32
    np.testing.assert_array_equal(a.to_bool(), b.to_bool())
    assert a.all_isolated() == b.all_isolated() == words.all_isolated()


def test_export_encoding_matches_jax(tmp_path):
    c = _cluster(seed=75, p_ports=0.8, p_named_port=0.3, p_container_ports=0.5)
    txt = persist.export_encoding(kvt.encode_cluster(c, compute_ports=True),
                                  str(tmp_path / "port"))
    jtxt = jax_persist.export_encoding(jax_encode(to_jax(c), compute_ports=True),
                                       str(tmp_path / "jax"))
    assert open(txt).read() == open(jtxt).read()
    with np.load(str(tmp_path / "port.npz")) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


# ------------------------------------------------------------------- ingest


def test_ingest_round_trips_across_the_packages(tmp_path):
    c = _cluster(seed=76, p_ports=0.8, p_named_port=0.3, p_container_ports=0.5,
                 p_ipblock_peer=0.2)
    c.policies[0] = dataclasses.replace(c.policies[0], ingress=None, egress=())
    ingest.dump_cluster(c, str(tmp_path / "port"))
    jax_ingest.dump_cluster(to_jax(c), str(tmp_path / "jax"))
    for name in sorted(os.listdir(tmp_path / "port")):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    back, skipped = ingest.load_cluster(str(tmp_path / "jax"))
    jback, jskipped = jax_ingest.load_cluster(str(tmp_path / "port"))
    assert skipped == jskipped == []
    assert to_jax(back) == jback == to_jax(c)
    res = kvt.verify(back, kvt.VerifyConfig(backend="cpu"))
    np.testing.assert_array_equal(res.reach, kvt.verify(c, kvt.VerifyConfig(backend="cpu")).reach)


def test_ingest_kano_walk_strict_mode_and_malformed_yaml(tmp_path):
    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "a.yaml").write_text(
        "kind: Pod\nmetadata: {name: p, labels: {app: web}}\n"
        "spec: {containers: [{name: c1}, {name: c2}]}\n---\n"
        "kind: NetworkPolicy\nmetadata: {name: np}\n"
        "spec:\n  podSelector: {matchLabels: {app: web}}\n"
        "  ingress: [{from: [{podSelector: {matchLabels: {app: db}}}], ports: [{port: 80}]}]\n"
        "---\nkind: ConfigMap\nmetadata: {name: cm}\n")
    got = ingest.load_kano(str(tmp_path / "m"))
    want = jax_ingest.load_kano(str(tmp_path / "m"))
    assert to_jax(got) == want
    cluster, skipped = ingest.load_cluster(str(tmp_path / "m"))
    assert [str(s) for s in skipped] == [str(s) for s in jax_ingest.load_cluster(
        str(tmp_path / "m"))[1]]
    assert skipped[0].kind == "ConfigMap" and skipped[0].doc_index == 2
    with pytest.raises(IngestError, match="unsupported kind"):
        ingest.load_cluster(str(tmp_path / "m"), strict=True)
    (tmp_path / "bad.yaml").write_text("kind: Pod\nmetadata: [unclosed\n")
    with pytest.raises(IngestError):
        ingest.load_cluster(str(tmp_path / "bad.yaml"))


def test_json_manifests_round_trip_across_the_packages(tmp_path, monkeypatch):
    """``yaml_io._dump_cluster_json`` (what the port's checkpoints write)
    needs no PyYAML; the port reads it back without PyYAML and the JAX
    package reads it with its YAML loader, to the same cluster."""
    from kubernetes_verification_tpu_torch.ingest import yaml_io

    c = _cluster(seed=77, p_ports=0.8, p_named_port=0.3, p_container_ports=0.5,
                 p_ipblock_peer=0.2)
    monkeypatch.setattr(yaml_io, "_yaml", lambda: (None, None))
    paths = yaml_io._dump_cluster_json(c, str(tmp_path / "m"))
    assert [os.path.basename(p) for p in paths] == [
        "namespaces.json", "pods.json", "networkpolicies.json"]
    back, skipped = ingest.load_cluster(str(tmp_path / "m"))
    with pytest.raises(IngestError, match="needs PyYAML"):
        ingest.dump_cluster(c, str(tmp_path / "y"))
    monkeypatch.undo()
    jback, jskipped = jax_ingest.load_cluster(str(tmp_path / "m"))
    assert skipped == jskipped == []
    assert to_jax(back) == jback == to_jax(c)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_checkpoint_saved_over_the_other_packages_loads_in_both(tmp_path, first):
    """Each package saves into the directory the other saved: the port's
    save replaces the JAX package's YAML manifests with its JSON ones (both
    packages resume it), and where the JAX package's save leaves the port's
    JSON set beside its YAML one, the port reads the newer set (the JAX
    package reads both sets there, a fault of the reference: ROADMAP §3).
    The resumed state is the last save's (the engines after one more op)."""
    c = _cluster(seed=74)
    port, jax_ = _packed_pair(c)
    pol = c.policies[0]
    d = str(tmp_path / "ck")
    saves = {"jax": lambda: jax_persist.save_packed_incremental(jax_, d),
             "port": lambda: persist.save_packed_incremental(port, d)}
    second = "port" if first == "jax" else "jax"
    saves[first]()
    for eng in (port, jax_):
        eng.remove_policy(pol.namespace, pol.name)
    saves[second]()
    want = jax_.state_dict()
    assert_same_state(want, persist.load_packed_incremental(d, device="cpu").state_dict(),
                      "port resumed")
    names = sorted(os.listdir(os.path.join(d, "cluster")))
    if second == "port":
        assert names == ["namespaces.json", "networkpolicies.json", "pods.json"]
        assert_same_state(want, jax_persist.load_packed_incremental(d).state_dict(),
                          "JAX resumed")
    else:
        assert len(names) == 6  # the JAX package's writer left the port's set
