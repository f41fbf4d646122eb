"""The port's command line against the JAX package's: the serving commands
(serve and its checkpoint, resume, posture, stripe and follower forms,
recover, warmup, query, posture).

Each case runs the same argv through both packages' ``main`` (the port's
with ``--device cpu``) and compares exit codes and outputs as parsed JSON,
exactly, after the recorded differences (``tests/torch_cli_parity.py``).
The invocations mirror the CLI cases of the JAX package's ``test_serve.py``,
``test_durability.py``, ``test_posture.py``, ``test_batched_queries.py``,
``test_closure_scale.py`` and ``test_transport.py``, at ≤ 30 pods."""
import json
import os
import shutil

import pytest

import kubernetes_verification_tpu as jkv
from kubernetes_verification_tpu.harness.generate import GeneratorConfig, random_cluster
from kubernetes_verification_tpu.harness.generate import random_event_stream
from kubernetes_verification_tpu.ingest import dump_cluster as jax_dump
from kubernetes_verification_tpu.packed_incremental import (
    PackedIncrementalVerifier as JaxPacked,
)
from kubernetes_verification_tpu.serve import VerificationService as JaxService
from kubernetes_verification_tpu.serve.events import write_events
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.cli import main as port_main
from kubernetes_verification_tpu_torch.resilience.errors import (
    EXIT_INPUT_ERROR,
    EXIT_OK,
    EXIT_VIOLATIONS,
)
from kubernetes_verification_tpu_torch.serve import VerificationService as PortService
from torch_cli_parity import Pair, run


@pytest.fixture
def pair(tmp_path, capsys):
    return Pair(tmp_path, capsys)


@pytest.fixture
def generated(pair):
    """24 pods / 6 policies and an 80-event churn stream, written by both
    packages' ``generate`` (byte-equal); the JAX package's copy is read."""
    pair.same_text(["generate", "{root}/cluster", "--pods", "24", "--policies", "6",
                    "--events-out", "{root}/events.jsonl", "--n-events", "80"])
    for name in ("cluster/pods.yaml", "cluster/networkpolicies.yaml", "events.jsonl"):
        with open(os.path.join(pair.roots["jax"], name), "rb") as a, \
                open(os.path.join(pair.roots["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    root = pair.roots["jax"]
    return os.path.join(root, "cluster"), os.path.join(root, "events.jsonl")


@pytest.fixture
def churn(tmp_path):
    """The durability tests' cluster (24 pods, 10 policies, seed 7) as
    manifests and a 120-event WAL."""
    cluster = random_cluster(GeneratorConfig(
        n_pods=24, n_policies=10, n_namespaces=3, seed=7,
        p_ipblock_peer=0.0, min_selector_labels=1))
    events = random_event_stream(cluster, n_events=120, seed=3)
    mdir = str(tmp_path / "manifests")
    jax_dump(cluster, mdir)
    log = str(tmp_path / "events.jsonl")
    write_events(events, log, start_seq=0)
    return cluster, mdir, log


def _ref(d, i=0):
    cluster, _ = jkv.load_cluster(d)
    return f"{cluster.pods[i].namespace}/{cluster.pods[i].name}"


def test_serve_and_query_exit_contract(pair, generated, tmp_path):
    d, ev = generated
    summary = pair.same(["serve", d, "--events", ev, "--snapshot-out", "{root}/snap",
                         "--json"])
    assert summary["events_seen"] == 80 and summary["snapshot"] == "<root>/snap"
    af = str(tmp_path / "assert.json")
    with open(af, "w") as fh:
        json.dump([{"name": "nothing-talks", "kind": "deny", "from": {}, "to": {}}], fh)
    runs = pair.run(["serve", d, "--events", ev, "--assert", af])
    assert runs["jax"].rc == runs["port"].rc == EXIT_VIOLATIONS
    viol = [ln for ln in runs["port"].out.splitlines() if "VIOLATION" in ln]
    assert viol and viol == [ln for ln in runs["jax"].out.splitlines() if "VIOLATION" in ln]
    assert "nothing-talks" in viol[0] and "can reach" in viol[0]
    out = pair.same(["serve", d, "--events", ev, "--assert", af, "--json"])
    assert out["violations"]
    ref = _ref(d)
    pair.same(["query", "--from-snapshot", "{root}/snap", "--who-can-reach", ref,
               "--blast-radius", ref, "--json"])
    runs = pair.run(["query", "--from-snapshot", "{root}/snap", "--can-reach",
                     "nowhere/ghost", ref])
    assert runs["jax"].rc == runs["port"].rc == EXIT_INPUT_ERROR
    runs = pair.run(["query", "--from-snapshot", "{root}/snap"])
    assert runs["jax"].rc == runs["port"].rc and "nothing to answer" in runs["port"].rc


def test_query_what_if_admission(pair, tmp_path):
    pair.same_text(["generate", "{root}/c", "--pods", "16", "--policies", "4"])
    d = os.path.join(pair.roots["jax"], "c")
    af = str(tmp_path / "assert.json")
    with open(af, "w") as fh:
        json.dump([{"name": "ns0-open", "kind": "allow",
                    "from": {"namespace": "ns0"}, "to": {"namespace": "ns0"}}], fh)
    pol = str(tmp_path / "isolate.yaml")
    with open(pol, "w") as fh:
        fh.write("apiVersion: networking.k8s.io/v1\nkind: NetworkPolicy\n"
                 "metadata:\n  name: isolate-all\n  namespace: ns0\n"
                 "spec:\n  podSelector: {}\n  policyTypes: [Ingress]\n")
    verdict = pair.same(["query", d, "--what-if", pol, "--assert", af, "--json"])
    assert verdict["what_if"]["ok"] is False and verdict["what_if"]["violations"]
    runs = pair.run(["query", d, "--what-if", pol, "--assert", af])
    assert runs["jax"].rc == runs["port"].rc == EXIT_VIOLATIONS
    checked = pair.same(["query", d, "--assert", af, "--json"])
    assert checked["assertions"]["checked"] == 1
    runs = pair.run(["query", d, "--what-if", af])  # not manifests
    assert runs["jax"].rc == runs["port"].rc == EXIT_INPUT_ERROR


def test_serve_checkpoint_then_resume(pair, churn):
    _, mdir, log = churn
    out = pair.same(["serve", mdir, "--events", log, "--checkpoint-dir", "{root}/ck",
                     "--checkpoint-every", "1", "--batch-size", "40", "--json"])
    assert out["checkpoints"] >= 2
    out2 = pair.same(["serve", mdir, "--events", log, "--checkpoint-dir", "{root}/ck",
                      "--resume", "--json"])
    assert out2["recovery"]["outcome"] == "newest"
    assert out2["recovery"]["duplicates_skipped"] == 0
    assert out2["reachable_pairs"] == out["reachable_pairs"]
    runs = pair.run(["serve", mdir, "--resume"])
    assert runs["jax"].rc == runs["port"].rc and "--checkpoint-dir" in runs["port"].rc


def test_recover_triage_of_the_same_directory(pair, churn, tmp_path):
    """``recover`` reports alike over each package's serve directory (the
    warm packs differ by design: executables against kernel libraries)."""
    _, mdir, log = churn
    pair.same(["serve", mdir, "--events", log, "--checkpoint-dir", "{root}/ck", "--json"])
    report = pair.same(["recover", "{root}/ck", "--events", log, "--json"],
                       drop=["aot_pack"])
    assert report["usable"] and report["generations"][0]["valid"]
    assert report["wal"]["records"] == 120 and not report["wal"]["torn"]
    with open(log, "a") as fh:
        fh.write('{"half')
    size = os.path.getsize(log)
    report = pair.same(["recover", "{root}/ck", "--events", log, "--json"],
                       drop=["aot_pack"])
    assert report["wal"]["torn"] and os.path.getsize(log) == size
    # the same directory through both packages: the JAX package's serve dir
    jck = str(tmp_path / "shared-ck")
    shutil.copytree(os.path.join(pair.roots["jax"], "ck"), jck)
    runs = pair.run(["recover", jck, "--events", log, "--json"])
    j, p = runs["jax"].json(), runs["port"].json()
    assert p["aot_pack"]["present"] and not p["aot_pack"]["env_match"]  # foreign
    for doc in (j, p):
        doc.pop("aot_pack")
    assert p == j
    for root in pair.roots.values():
        for name in os.listdir(os.path.join(root, "ck")):
            if name.startswith("manifest"):
                with open(os.path.join(root, "ck", name), "w") as fh:
                    fh.write("junk")
    runs = pair.run(["recover", "{root}/ck", "--json"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_INPUT_ERROR
    runs = pair.run(["recover", "{root}/nope"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_INPUT_ERROR


def test_recover_renders_flight_dumps(pair, tmp_path):
    """A flight dump (written by the port's recorder) renders alike in both
    packages' ``recover``, text and JSON, with no checkpoint generation."""
    from kubernetes_verification_tpu_torch.observe import flight
    from kubernetes_verification_tpu_torch.observe.spans import trace

    fdir = str(tmp_path / "flight")
    flight.install(fdir)
    try:
        with trace("doomed_op"):
            pass
        assert flight.trigger_dump("manual", error="boom")
    finally:
        flight.uninstall()
    out = pair.same_text(["recover", fdir])
    assert "trigger=manual" in out
    report = pair.same(["recover", fdir, "--json"], drop=["aot_pack"])
    assert report["flight_dumps"][0]["trigger"] == "manual"


def _probe_file(path, probes):
    with open(path, "w") as fh:
        for p in probes:
            fh.write(json.dumps(p) + "\n")
            fh.write("\n")  # blank lines are skipped
    return path


def test_query_batch(pair, tmp_path):
    pair.same_text(["generate", "{root}/c", "--pods", "16", "--policies", "4",
                    "--namespaces", "3"])
    d = os.path.join(pair.roots["jax"], "c")
    r0, r1 = _ref(d, 0), _ref(d, 1)
    bf = _probe_file(str(tmp_path / "probes.jsonl"), [
        {"src": r0, "dst": r1}, {"src": r0, "dst": r1, "port": 443},
        {"src": r1, "dst": r0, "port": 53, "protocol": "UDP"}])
    out = pair.same(["query", d, "--batch", bf, "--json"])
    assert out["batch"]["n"] == 3 and [r["port"] for r in out["batch"]["results"]] == [
        None, 443, 53]
    pair.same_text(["query", d, "--batch", bf, "--can-reach", r0, r1, "--port", "443"])
    bad = _probe_file(str(tmp_path / "bad.jsonl"), [{"src": r0}])
    for path in (bad, str(tmp_path / "missing.jsonl")):
        runs = pair.run(["query", d, "--batch", path])
        assert runs["jax"].rc == runs["port"].rc == EXIT_INPUT_ERROR


def test_query_batch_from_a_packed_snapshot(pair, tmp_path):
    """A packed (bitmap-state) snapshot answers ``--batch`` alike, written by
    each package's own packed service."""
    cluster = random_cluster(GeneratorConfig(n_pods=26, n_policies=5, n_namespaces=3, seed=4))
    d = str(tmp_path / "m")
    jax_dump(cluster, d)
    jsnap = os.path.join(pair.roots["jax"], "snap")
    psnap = os.path.join(pair.roots["port"], "snap")
    cfg = dict(compute_ports=False)
    JaxService(engine=JaxPacked(cluster, jkv.VerifyConfig(**cfg))).snapshot(jsnap)
    pcluster, _ = kvt.load_cluster(d)
    PortService(engine=kvt.PackedIncrementalVerifier(
        pcluster, kvt.VerifyConfig(**cfg), device="cpu")).snapshot(psnap)
    refs = [f"{p.namespace}/{p.name}" for p in cluster.pods]
    bf = _probe_file(str(tmp_path / "p.jsonl"), [
        {"src": refs[s], "dst": refs[t]} for s, t in [(0, 1), (2, 25), (13, 13)]])
    out = pair.same(["query", "--from-snapshot", "{root}/snap", "--batch", bf, "--json"])
    assert out["batch"]["n"] == 3


def test_query_path_exists_and_hops(pair):
    pair.same_text(["generate", "{root}/c", "--pods", "24", "--policies", "6"])
    d = os.path.join(pair.roots["jax"], "c")
    s, t = _ref(d, 0), _ref(d, 23)
    pair.same(["query", d, "--path-exists", s, t, "--json"])
    pair.same(["query", d, "--hops", s, t, "--json"])
    pair.same(["query", d, "--hops", t, s, "--max-hops", "1", "--json"])
    pair.same_text(["query", d, "--path-exists", s, t, "--max-hops", "1"])


def test_serve_posture_journal_then_timeline(pair, tmp_path):
    pair.same_text(["generate", "{root}/c", "--pods", "24", "--policies", "8",
                    "--namespaces", "3", "--events-out", "{root}/ev.jsonl",
                    "--n-events", "60"])
    d = os.path.join(pair.roots["jax"], "c")
    ev = os.path.join(pair.roots["jax"], "ev.jsonl")
    # the dense engine adopts the posture words it packs as its clean reach,
    # so the final answer is no query solve, as in the JAX package
    argv = ["serve", d, "--events", ev, "--batch-size", "16",
            "--posture-journal", "{root}/posture.jsonl", "--json"]
    runs = pair.run(argv[:-2] + ["{root}/first.jsonl", "--json"])
    assert runs["jax"].json()["solves"] == runs["port"].json()["solves"] == {}
    summary = pair.same(argv)
    assert summary["solves"] == {} and summary["total_solves"] == 0
    assert summary["posture"]["journal"] == "<root>/posture.jsonl"
    runs = pair.run(["posture", "{root}/posture.jsonl"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_OK
    # the timeline's columns alike but its delta_ms (each record's time)
    rows = {k: [ln.split()[:5] + ln.split()[6:] for ln in r.out.splitlines()]
            for k, r in runs.items()}
    assert rows["port"] == rows["jax"] and rows["port"][0][0] == "gen"
    assert "0*" in runs["port"].out
    payload = pair.same(["posture", "{root}", "--json"])
    assert payload["torn_lineno"] is None and payload["records"][0]["baseline"] is True
    last = payload["records"][-1]["seq"]
    diff = pair.same(["posture", "{root}/posture.jsonl", "--diff", "0", str(last), "--json"])
    assert diff["generations"] == len(payload["records"]) - 1
    runs = pair.run(["posture", "{root}/nope.jsonl"])
    assert runs["jax"].rc == runs["port"].rc and "no journal" in runs["port"].rc
    # an impossible bound: any widening across 60 churn events violates
    runs = pair.run(["serve", d, "--events", ev, "--batch-size", "16", "--posture",
                     "--posture-alert", "max-widening 0 pairs/batch"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_VIOLATIONS
    assert "posture-alert [max-widening]" in runs["port"].out
    runs = pair.run(["serve", d, "--events", ev, "--posture-alert", "garbage"])
    assert runs["jax"].rc == runs["port"].rc and isinstance(runs["port"].rc, str)


def test_serve_stripe_owner(pair, churn):
    """``serve --stripe K/N``: each owner's health alike, through a
    stripe-sliced checkpoint and its resume."""
    _, mdir, log = churn
    for k in (1, 2):
        out = pair.same(["serve", mdir, "--stripe", f"{k}/2", "--events", log,
                         "--checkpoint-dir", f"{{root}}/sck{k}", "--json"])
        assert out["stripe"]["index"] == k - 1 and out["checkpoints"] == 1
    out = pair.same(["serve", mdir, "--stripe", "1/2", "--events", log, "--resume",
                     "--checkpoint-dir", "{root}/sck1", "--json"])
    assert out["recovery"]["outcome"] == "newest"
    runs = pair.run(["serve", "--stripe", "1/2"])
    assert runs["jax"].rc == runs["port"].rc and "--stripe needs" in runs["port"].rc


def test_serve_follow_a_checkpoint_directory(pair, churn, tmp_path):
    """``serve --follow``: a follower of the JAX package's serve directory
    (each package's follower bootstraps from it) answers alike."""
    _, mdir, log = churn
    runs = pair.run(["serve", mdir, "--events", log, "--checkpoint-dir", "{root}/ck",
                     "--batch-size", "40", "--json"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_OK
    ck = str(tmp_path / "shared-ck")
    shutil.copytree(os.path.join(pair.roots["jax"], "ck"), ck)
    out = pair.same(["serve", "--follow", ck, "--events", log, "--replica", "f-0",
                     "--idle-timeout", "0.05", "--tail-poll", "0.01", "--json"])
    assert out["reachable_pairs"] == runs["jax"].json()["reachable_pairs"]
    runs = pair.run(["serve", mdir, "--follow", ck, "--stripe", "1/2"])
    assert runs["jax"].rc == runs["port"].rc and "exclusive" in runs["port"].rc


def test_warmup_writes_a_pack(pair, capsys, tmp_path):
    """``warmup`` builds the service, drives the query plane and writes the
    pack: the JAX package's holds executables, the port's the built kernel
    libraries (none on the CPU) and the dispatch keys; both ride it back."""
    pair.same_text(["generate", "{root}/c", "--pods", "16", "--policies", "4"])
    d = os.path.join(pair.roots["jax"], "c")
    runs = pair.run(["warmup", d, "--out", "{root}/pack", "--json"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_OK
    out = runs["port"].json()
    assert out["directory"] == "<root>/pack" and out["libraries"] == []
    assert out["entries"] == out["dispatch"] > 0
    assert os.path.exists(os.path.join(pair.roots["port"], "pack", "PACK_MANIFEST.json"))
    r = run(port_main, ["warmup", d, "--out", os.path.join(pair.roots["port"], "pack"),
                        "--device", "cpu"], capsys)
    assert r.rc == EXIT_OK and "warmup:" in r.out and "no kernel library" in r.out
    ref = _ref(d)
    pair.same(["query", d, "--warm-pack", "{root}/pack", "--who-can-reach", ref, "--json"])
