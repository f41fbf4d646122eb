"""The port's command line (``kv-tpu-torch``) against the JAX package's
``kv-tpu``: the one-shot and engine commands (generate, verify, explain,
history, backends, snapshot, diff) and the exit-code contract.

Every case runs the same argv through both packages' ``main`` (the port's
with ``--device cpu``) and compares the exit codes and the outputs as parsed
JSON, exactly, after the recorded differences (``tests/torch_cli_parity.py``:
timing keys dropped, output roots and the prog name normalised, backend
labels mapped). The invocations mirror ``tests/test_cli.py`` and the CLI
cases of the JAX package's other test files, at ≤ 30 pods."""
import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.ingest import dump_cluster as jax_dump
from kubernetes_verification_tpu_torch.cli import _load_incremental
from kubernetes_verification_tpu_torch.cli import main as port_main
from kubernetes_verification_tpu_torch.ops.closure import packed_closure
from kubernetes_verification_tpu_torch.resilience.errors import (
    EXIT_BACKEND_FAILED,
    EXIT_INPUT_ERROR,
    EXIT_OK,
    EXIT_VIOLATIONS,
)
from kubernetes_verification_tpu.cli import main as jax_main
from torch_cli_parity import Pair, run, strip_timings

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def pair(tmp_path, capsys):
    return Pair(tmp_path, capsys)


@pytest.fixture(autouse=True)
def _restore_backend_registries():
    """``--inject-faults`` registers ``faulty:<inner>`` in each package's
    backend registry for the rest of the process; put both back."""
    from kubernetes_verification_tpu.backends import base as jbase
    from kubernetes_verification_tpu_torch.backends import base

    saved = []
    for mod in (jbase, base):
        mod.available_backends()
        saved.append((mod, dict(mod._REGISTRY)))
    yield
    for mod, reg in saved:
        mod._REGISTRY.clear()
        mod._REGISTRY.update(reg)


def _generate(pair, name="c", pods=30, policies=8, extra=()):
    """Write one cluster through both packages' ``generate`` (equal text and
    equal files); returns the JAX package's copy, which both read."""
    pair.same_text(["generate", f"{{root}}/{name}", "--pods", str(pods),
                    "--policies", str(policies), *extra])
    jdir = os.path.join(pair.roots["jax"], name)
    pdir = os.path.join(pair.roots["port"], name)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    for f in os.listdir(jdir):
        with open(os.path.join(jdir, f), "rb") as a, open(os.path.join(pdir, f), "rb") as b:
            assert a.read() == b.read(), f
    return jdir


# ---------------------------------------------------- one-shot commands


def test_generate_verify_explain_backends(pair, tmp_path):
    d = _generate(pair)
    out = pair.same(["verify", d, "--backend", "cpu", "--json",
                     "--output", "{root}/res.npz"])
    assert out["pods"] == 30 and out["reachable_pairs"] > 0
    with np.load(os.path.join(pair.roots["jax"], "res.npz")) as a, \
            np.load(os.path.join(pair.roots["port"], "res.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k == "__meta__":  # JSON with the run's timings
                meta = [strip_timings(json.loads(bytes(z[k]).decode())) for z in (a, b)]
                assert meta[0] == meta[1]
            elif k != "__checksums__":  # the meta's timings are checksummed
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the default backend: the JAX package's cpu, the port's torch
    out = pair.same(["verify", d, "--json"], backend_map={"cpu": "torch"})
    assert out["backend"] == "torch"
    pair.same(["verify", d, "--backend", "tpu", "--json"],
              extra_port=["--backend", "torch"], backend_map={"tpu": "torch"})
    pair.same(["verify", d, "--kano", "--json"], backend_map={"cpu": "torch"})
    pair.same(["verify", d, "--closure", "--no-ports", "--json"],
              backend_map={"cpu": "torch"})
    runs = pair.run(["verify", d, "--kano", "--backend", "cpu"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_OK
    assert "kano mode" in runs["port"].out
    assert runs["port"].out.splitlines()[0] == runs["jax"].out.splitlines()[0]

    text = pair.same_text(["explain", d, "--out", "{root}/model"])
    assert "wrote" in text
    for suffix in (".datalog", ".txt"):
        with open(os.path.join(pair.roots["jax"], "model" + suffix)) as a, \
                open(os.path.join(pair.roots["port"], "model" + suffix)) as b:
            assert a.read() == b.read()
    assert "edge(s, d)" in open(os.path.join(pair.roots["port"], "model.datalog")).read()
    with np.load(os.path.join(pair.roots["jax"], "model.npz")) as a, \
            np.load(os.path.join(pair.roots["port"], "model.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    runs = pair.run(["backends"])
    assert runs["jax"].rc == runs["port"].rc == 0
    jax_names = ["torch" if n == "tpu" else n for n in runs["jax"].out.split()]
    assert runs["port"].out.split() == sorted(jax_names) == kvt.available_backends()


#: the port's in-process mesh: one rank
_ONE_RANK = {"mesh=4,2": "mesh=1,1", "mesh=2,4": "mesh=1,1"}


def test_verify_sharded_packed_opts_on_a_one_rank_mesh(pair):
    """``--backend sharded-packed`` with ``--opt`` passthrough at mesh
    (1, 1), in the dense-reach and aggregates-only regimes, against the JAX
    CLI at mesh (4, 2) of its 8 virtual devices (the answer does not depend
    on the mesh); the command leaves the process group it joined."""
    d = _generate(pair, pods=24, policies=6)
    base = ["verify", d, "--backend", "sharded-packed", "--json",
            "--opt", "mesh=4,2", "--opt", "tile=32", "--opt", "chunk=8",
            "--opt", "keep_matrix=true"]
    out = pair.same(base, port_subst=_ONE_RANK)
    assert out["backend"] == "sharded-packed"
    assert not dist.is_initialized()
    out2 = pair.same(base + ["--opt", "dense_reach_limit=4"], port_subst=_ONE_RANK)
    assert out2["reachable_pairs"] == out["reachable_pairs"]
    assert not dist.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_verify_sharded_packed_on_two_gloo_ranks(pair, tmp_path):
    """``--opt mesh=2,1`` on a 2-rank job (two processes of the console
    entry, joined through the launcher environment): every rank prints the
    JAX CLI's answer (at mesh (4, 2): its test process has 8 virtual
    devices, and the answer does not depend on the mesh)."""
    d = _generate(pair, pods=24, policies=6)
    opts = ["--backend", "sharded-packed", "--json", "--opt", "mesh=2,1",
            "--opt", "tile=32", "--opt", "keep_matrix=true"]
    jopts = [("mesh=4,2" if o == "mesh=2,1" else o) for o in opts]
    want = json.loads(run(jax_main, ["verify", d, *jopts], pair.capsys).out)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubernetes_verification_tpu_torch.cli",
             "verify", d, *opts, "--device", "cpu"],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for got in outs:
        got.pop("timings"), want.pop("timings", None)
        assert got == want


# ----------------------------------------------------------- engine commands


def _delta_dirs(tmp_path, d, tag):
    """One new pod, one policy update, one new policy (the JAX CLI test's
    diff manifest), and a relabel of the new pod."""
    cluster, _ = jkv.load_cluster(d)
    pol = cluster.policies[0]
    delta = jkv.Cluster(
        pods=[jkv.Pod("cli-new", cluster.pods[0].namespace, {"app": "cli"})],
        policies=[
            dataclasses.replace(pol, ingress=cluster.policies[1].ingress),
            dataclasses.replace(pol, name="cli-added"),
        ],
    )
    dd = str(tmp_path / f"delta-{tag}")
    jax_dump(delta, dd)
    delta2 = jkv.Cluster(
        pods=[jkv.Pod("cli-new", cluster.pods[0].namespace, {"app": "relab"})]
    )
    dd2 = str(tmp_path / f"delta2-{tag}")
    jax_dump(delta2, dd2)
    return cluster, dd, dd2


@pytest.mark.parametrize("engine", [[], ["--no-ports"]], ids=["ports", "any-port"])
def test_snapshot_diff_round_trip(pair, tmp_path, engine):
    d = _generate(pair)
    snap = pair.same(["snapshot", d, "{root}/ck", "--json", *engine])
    assert snap["pods"] == 30 and snap["saved"] == "<root>/ck"
    cluster, dd, dd2 = _delta_dirs(tmp_path, d, "rt")
    victim = cluster.pods[3]
    rep = pair.same([
        "diff", "{root}/ck", "--apply", dd,
        "--remove", f"pod/{victim.namespace}/{victim.name}",
        "--remove", f"policy/{cluster.policies[2].namespace}/{cluster.policies[2].name}",
        "--json",
    ])
    assert {k for k, _ in rep["ops"]} == {
        "add-pod", "update-policy", "add-policy", "remove-pod", "remove-policy"}
    assert rep["after"]["pods"] == 30 and rep["after"]["policies"] == 8
    rep2 = pair.same(["diff", "{root}/ck", "--apply", dd2, "--json"])
    assert ["relabel-pod", f"{cluster.pods[0].namespace}/cli-new"] in rep2["ops"]
    # the saved checkpoint equals a from-scratch verify of its live cluster
    inc = _load_incremental(os.path.join(pair.roots["port"], "ck"), device="cpu")
    ref = kvt.verify(inc.as_cluster(), kvt.VerifyConfig(
        backend="cpu", compute_ports=inc.config.compute_ports))
    np.testing.assert_array_equal(inc.reach_active(), ref.reach)
    assert rep2["after"]["reachable_pairs"] == int(ref.reach.sum())


def test_diff_no_save_and_bad_remove(pair):
    d = _generate(pair, pods=12, policies=3)
    runs = pair.run(["snapshot", d, "{root}/k", "--no-ports"])
    assert runs["jax"].rc == runs["port"].rc == 0
    rep = pair.same(["diff", "{root}/k", "--no-save", "--json"])
    assert rep["ops"] == [] and rep["saved"] is None
    runs = pair.run(["diff", "{root}/k", "--remove", "garbage"])
    assert runs["jax"].rc == runs["port"].rc
    assert "--remove expects" in runs["port"].rc


def test_diff_out_of_universe_aborts_cleanly(pair, tmp_path):
    """A ports-engine diff outside the frozen universe exits with rebuild
    guidance, and the checkpoint on disk is intact."""
    d = _generate(pair, pods=15, policies=4)
    pair.same(["snapshot", d, "{root}/k", "--json"])
    ck = os.path.join(pair.roots["port"], "k")
    before = _load_incremental(ck, device="cpu").update_count
    cluster, _ = jkv.load_cluster(d)
    alien = jkv.Cluster(policies=[
        jkv.NetworkPolicy(
            "alien", namespace=cluster.pods[0].namespace,
            pod_selector=jkv.Selector(),
            ingress=(jkv.Rule(peers=(), ports=(jkv.PortSpec("TCP", 29_999),)),),
        )
    ])
    dd = str(tmp_path / "alien")
    jax_dump(alien, dd)
    runs = pair.run(["diff", "{root}/k", "--apply", dd])
    assert runs["jax"].rc == runs["port"].rc
    assert "frozen port universe" in runs["port"].rc
    assert _load_incremental(ck, device="cpu").update_count == before


def test_diff_namespace_labels_respected(pair, tmp_path):
    base = jkv.Cluster(
        pods=[jkv.Pod("web", "prod", {"app": "web"})],
        namespaces=[jkv.Namespace("prod", {"tier": "frontend"})],
        policies=[jkv.NetworkPolicy(
            "from-backend", namespace="prod",
            pod_selector=jkv.Selector({"app": "web"}),
            ingress=(jkv.Rule(peers=(
                jkv.Peer(namespace_selector=jkv.Selector({"tier": "backend"})),)),),
        )],
    )
    d = str(tmp_path / "base")
    jax_dump(base, d)
    pair.same(["snapshot", d, "{root}/ck", "--no-ports", "--json"])
    delta = jkv.Cluster(
        pods=[jkv.Pod("worker", "team-a", {"app": "worker"})],
        namespaces=[jkv.Namespace("team-a", {"tier": "backend"})],
    )
    dd = str(tmp_path / "delta")
    jax_dump(delta, dd)
    rep = pair.same(["diff", "{root}/ck", "--apply", dd, "--json"])
    assert ["add-namespace", "team-a"] in rep["ops"]
    assert rep["after"]["reachable_pairs"] > rep["before"]["reachable_pairs"]
    delta2 = jkv.Cluster(namespaces=[jkv.Namespace("team-a", {"tier": "other"})],
                         pods=[jkv.Pod("x", "team-a", {})])
    dd2 = str(tmp_path / "delta2")
    jax_dump(delta2, dd2)
    rep2 = pair.same(["diff", "{root}/ck", "--apply", dd2, "--json"])
    assert ["relabel-namespace", "team-a"] in rep2["ops"]
    runs = pair.run(["diff", "{root}/ck", "--remove", "namespace/team-a", "--no-save"])
    assert runs["jax"].rc == runs["port"].rc
    assert "cannot remove namespace" in runs["port"].rc
    rep3 = pair.same(["diff", "{root}/ck", "--remove", "pod/team-a/worker",
                      "--remove", "pod/team-a/x", "--remove", "namespace/team-a",
                      "--json"])
    assert ["remove-namespace", "team-a"] in rep3["ops"]
    inc = _load_incremental(os.path.join(pair.roots["port"], "ck"), device="cpu")
    assert all(ns.name != "team-a" for ns in inc.namespaces)


@pytest.mark.parametrize("ports", [False, True], ids=["any-port", "ports"])
def test_snapshot_closure_maintained_across_diffs(pair, tmp_path, ports):
    """``snapshot --closure`` persists the packed closure and ``diff``
    maintains it: the port's maintained closure equals a from-scratch
    ``packed_closure`` of its words and the JAX package's closure."""
    from kubernetes_verification_tpu.cli import _load_incremental as jax_load

    d = _generate(pair, pods=24, policies=6)
    pair.same(["snapshot", d, "{root}/k", "--closure", "--json"]
              + ([] if ports else ["--no-ports"]))
    cluster, _ = jkv.load_cluster(d)
    delta = jkv.Cluster(
        pods=[jkv.Pod("cz-new", cluster.pods[0].namespace, {"cz": "x"})],
        policies=[dataclasses.replace(cluster.policies[0],
                                      ingress=cluster.policies[1].ingress)],
    )
    dd = str(tmp_path / "delta")
    jax_dump(delta, dd)
    victim = cluster.pods[3]
    rep = pair.same(["diff", "{root}/k", "--apply", dd, "--remove",
                     f"pod/{victim.namespace}/{victim.name}", "--json"])
    assert len(rep["ops"]) >= 2
    runs = pair.run(["diff", "{root}/k", "--no-save", "--json"])
    assert "closure_s" not in runs["port"].json()  # a dry run closes nothing
    inc = _load_incremental(os.path.join(pair.roots["port"], "k"), device="cpu")
    assert inc._closure is not None
    got = inc._closure.cpu().numpy()
    np.testing.assert_array_equal(got, packed_closure(inc._packed, device="cpu").cpu().numpy())
    jinc = jax_load(os.path.join(pair.roots["jax"], "k"))
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(jinc._closure).view(np.uint32))


def test_diff_unchanged_manifests_are_noops(pair):
    d = _generate(pair, pods=14, policies=4)
    pair.same(["snapshot", d, "{root}/k", "--no-ports", "--json"])
    rep = pair.same(["diff", "{root}/k", "--apply", d, "--json"])
    assert rep["ops"] == []
    assert rep["after"]["update_count"] == rep["before"]["update_count"]


def test_snapshot_diff_with_mesh_opt(pair):
    """The serving loop on a mesh: the port's snapshot builds the engine on
    (1, 1) and diff resumes onto it again (the JAX CLI on (4, 2), then
    (2, 4)); each command leaves its process group."""
    d = _generate(pair, pods=26, policies=5)
    snap = pair.same(["snapshot", d, "{root}/k", "--opt", "mesh=4,2", "--json"],
                     port_subst=_ONE_RANK)
    assert snap["pods"] == 26 and not dist.is_initialized()
    rep = pair.same(["diff", "{root}/k", "--opt", "mesh=2,4", "--json"],
                    port_subst=_ONE_RANK)
    assert rep["ops"] == [] and not dist.is_initialized()


@pytest.mark.parametrize("first", ["jax", "port"])
def test_checkpoints_cross_packages(pair, tmp_path, capsys, first):
    """One package's ``snapshot`` → the other's ``diff`` → the first's
    ``diff --no-save``: every aggregate equals a one-package run's."""
    d = _generate(pair, pods=20, policies=5)
    cluster, dd, _ = _delta_dirs(tmp_path, d, "x")
    mains = {"jax": jax_main, "port": port_main}
    other = "port" if first == "jax" else "jax"

    def argv(name, args):
        return args + (["--device", "cpu"] if name == "port" else [])

    ck = str(tmp_path / "shared-ck")
    ref = str(tmp_path / "ref-ck")
    for c in (ck, ref):
        r = run(mains[first], argv(first, ["snapshot", d, c, "--no-ports", "--json"]), capsys)
        assert r.rc == 0
    diff = ["--apply", dd, "--remove", f"pod/{cluster.pods[3].namespace}/{cluster.pods[3].name}",
            "--json"]
    crossed = run(mains[other], argv(other, ["diff", ck, *diff]), capsys).json()
    alone = run(mains[first], argv(first, ["diff", ref, *diff]), capsys).json()
    back = run(mains[first], argv(first, ["diff", ck, "--no-save", "--json"]), capsys).json()
    for key in ("ops",):
        assert crossed[key] == alone[key]
    assert crossed["before"] == alone["before"]
    assert crossed["after"] == alone["after"] == back["before"] == back["after"]


# ----------------------------------------------------------- the parsers


def _parser(main):
    """The ``argparse`` parser ``main`` builds (captured when it parses)."""
    class Captured(Exception):
        pass

    seen = {}
    orig = argparse.ArgumentParser.parse_known_args

    def capture(self, *a, **k):
        seen["parser"] = self
        raise Captured

    argparse.ArgumentParser.parse_known_args = capture
    try:
        main(["backends"])
    except Captured:
        pass
    finally:
        argparse.ArgumentParser.parse_known_args = orig
    return seen["parser"]


def _subparsers(parser):
    action = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return action.choices


def _options(sub):
    return {
        (tuple(a.option_strings) or a.dest): (a.dest, a.nargs, repr(a.default), a.required,
                                               repr(a.choices), type(a).__name__)
        for a in sub._actions if not isinstance(a, argparse._HelpAction)
    }


_JAX_SUBS = _subparsers(_parser(jax_main))
_PORT_SUBS = _subparsers(_parser(port_main))
_DEVICE_CMDS = {"verify", "snapshot", "diff", "explain", "serve", "warmup", "query", "lb"}


def test_the_parsers_have_the_same_subcommands():
    assert list(_PORT_SUBS) == list(_JAX_SUBS)
    assert len(_PORT_SUBS) == 20
    assert _parser(port_main).prog == "kv-tpu-torch"


@pytest.mark.parametrize("cmd", sorted(_JAX_SUBS))
def test_the_parsers_take_the_same_options(cmd):
    """Equal option sets, up to the recorded differences: ``--device`` on
    the commands that build tensors and ``verify --backend`` defaulting to
    ``torch``."""
    want, got = _options(_JAX_SUBS[cmd]), _options(_PORT_SUBS[cmd])
    if cmd in _DEVICE_CMDS:
        assert got.pop(("--device",))[:3] == ("device", None, "'cuda'")
    if cmd == "verify":
        assert got[("--backend",)][2] == "'torch'" and want[("--backend",)][2] == "'cpu'"
        got.pop(("--backend",)), want.pop(("--backend",))
    assert got == want


# ------------------------------------------------------- exit-code contract


def _shadow_manifests(tmp_path):
    d = tmp_path / "shadow"
    d.mkdir()
    pol = (
        "apiVersion: networking.k8s.io/v1\nkind: NetworkPolicy\n"
        "metadata:\n  name: {name}\n  namespace: default\n"
        "spec:\n  podSelector: {{}}\n  policyTypes: [Ingress]\n"
        "  ingress:\n  - from:\n    - podSelector: {{}}\n"
    )
    (d / "cluster.yaml").write_text(
        "apiVersion: v1\nkind: Namespace\nmetadata:\n  name: default\n---\n"
        "apiVersion: v1\nkind: Pod\nmetadata:\n  name: a\n"
        "  namespace: default\n  labels: {app: a}\nspec: {}\n---\n"
        "apiVersion: v1\nkind: Pod\nmetadata:\n  name: b\n"
        "  namespace: default\n  labels: {app: b}\nspec: {}\n"
        "---\n" + pol.format(name="allow-all-one") + "---\n" + pol.format(name="allow-all-two")
    )
    return str(d)


def test_exit_codes_match(pair, tmp_path):
    d = _generate(pair, pods=10, policies=3, extra=["--seed", "3"])
    # bad input: exit 2 with a one-line diagnostic
    runs = pair.run(["verify", str(tmp_path / "missing"), "--json"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_INPUT_ERROR
    assert "kv-tpu: IngestError:" in runs["port"].err and "Traceback" not in runs["port"].err
    # a bad --opt: a parse-time refusal
    for bad in ("tile=2e4", "mesh=a,b", "novalue"):
        runs = pair.run(["verify", d, "--json", "--opt", bad])
        assert runs["jax"].rc == runs["port"].rc and isinstance(runs["port"].rc, str)
    # an exhausted fallback chain: exit 3
    runs = pair.run(["verify", d, "--json", "--inject-faults", "cpu=device_loss",
                     "--fallback-chain", "faulty:cpu", "--max-retries", "0"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_BACKEND_FAILED
    assert "BackendChainExhausted" in runs["port"].err
    # the chain recovers on the next backend
    out = pair.same(["verify", d, "--json", "--inject-faults", "cpu=device_loss",
                     "--fallback-chain", "faulty:cpu,cpu"])
    assert out["backend"] == "cpu"
    # --max-retries 2 activates the resilient path: a flaky backend recovers
    pair.same(["verify", d, "--json", "--inject-faults", "cpu=flaky@0",
               "--backend", "faulty:cpu", "--max-retries", "2"])
    # --check: exit 1 on shadowed/conflicting policies
    sd = _shadow_manifests(tmp_path)
    out = pair.same(["verify", sd, "--json"], backend_map={"cpu": "torch"})
    assert out["policy_shadow"]
    out = pair.same(["verify", sd, "--json", "--check"], backend_map={"cpu": "torch"})
    assert out["check"] == "failed"
    runs = pair.run(["verify", sd, "--json", "--check"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_VIOLATIONS


def test_diff_of_a_corrupt_checkpoint_exits_2(pair):
    d = _generate(pair, pods=8, policies=3)
    runs = pair.run(["snapshot", d, "{root}/ckpt", "--no-ports"])
    assert runs["jax"].rc == runs["port"].rc == 0
    for root in pair.roots.values():
        state = os.path.join(root, "ckpt", "state.npz")
        data = open(state, "rb").read()
        open(state, "wb").write(data[: len(data) // 2])
    runs = pair.run(["diff", "{root}/ckpt"])
    assert runs["jax"].rc == runs["port"].rc == EXIT_INPUT_ERROR
    assert "PersistError" in runs["port"].err


# ------------------------------------------------------- explain, history


def test_explain_cost_mode(pair):
    """Cost mode on the host backend: the same host-estimate reports (their
    peak memory is this process's, dropped) and a memory table."""
    from kubernetes_verification_tpu.observe import introspect as jintro
    from kubernetes_verification_tpu_torch.observe import introspect

    argv = ["explain", "--pods", "24", "--policies", "4", "--backend", "cpu", "--json"]
    try:
        runs = pair.run(argv)
    finally:
        for mod in (jintro, introspect):
            mod.set_introspection(False)
            mod.clear_reports()
    assert runs["jax"].rc == runs["port"].rc == 0
    j, p = runs["jax"].json(), runs["port"].json()
    assert p["memory"] and p["memory"][0]["bytes_in_use"] > 0
    for doc in (j, p):
        doc.pop("memory"), doc.pop("timings")
        for rep in doc["reports"]:
            rep.pop("peak_bytes")
    assert p == j and p["reports"]
    try:
        r = run(port_main, ["explain", "--pods", "24", "--policies", "4", "--backend", "cpu",
                            "--device", "cpu"], pair.capsys)
    finally:
        introspect.set_introspection(False)
        introspect.clear_reports()
    assert r.rc == 0 and "encode_selectors" in r.out and "in_use" in r.out
    runs = pair.run(["explain"])
    assert runs["jax"].rc == runs["port"].rc and "explain: give" in runs["port"].rc


def test_explain_cost_mode_reads_the_analytic_reports(capsys):
    """The port's reports are analytic: the sharded sweep's ``bool_dot``
    products publish their exact counts (a sweep's timings carry its stripe
    and tile count, which the table prints as they are). The default
    backend, ``torch``, is the dense solve: it publishes no report."""
    from kubernetes_verification_tpu_torch.observe import introspect

    def explain(*extra):
        try:
            r = run(port_main, ["explain", "--pods", "40", "--policies", "6", "--json",
                                "--device", "cpu", *extra], capsys)
        finally:
            introspect.set_introspection(False)
            introspect.clear_reports()
        assert r.rc == 0, r.err
        return json.loads(r.out)

    out = explain("--backend", "sharded-packed")
    assert out["timings"]["sweep_stripe"] == [0, 1]
    dots = [rep for rep in out["reports"] if rep["fn"] == "bool_dot"]
    assert dots and all(rep["source"] == "analytic" and rep["flops"] > 0 for rep in dots)
    out = explain()
    assert out["backend"] == "torch" and out["n_pods"] == 40 and out["reports"] == []


def test_explain_roofline_and_history(pair, tmp_path):
    from kubernetes_verification_tpu.observe.history import append_run

    p = tmp_path / "h.jsonl"
    records = [
        {"metric": "closure_pairs_per_second", "unit": "pairs/s", "value": 1e9,
         "mode": "closure", "device": "cpu", "platform": "cpu",
         "sentinel": {"dispatch_s": 1e-4, "calibrated_peak_macs_per_s": 6.0e10},
         "macs": 1.0e12, "steady_s": 10.0},
        {"metric": "x", "unit": "pairs/s", "value": 1.0, "mode": "k8s",
         "device": "Quantum9000", "platform": "cpu", "macs": 5.0e11, "steady_s": 2.0},
    ]
    p.write_text("".join(json.dumps(r) + "\n" for r in records))
    rows = pair.same(["explain", "--roofline", "--json", str(p)])["rows"]
    assert {r["peak_source"] for r in rows} == {"sentinel-calibrated", "analytic-host"}
    pair.same_text(["explain", "--roofline", str(p)])
    # the card's published peak table: the port's own rows
    h100 = tmp_path / "h100.jsonl"
    h100.write_text(json.dumps({
        "metric": "all-pairs", "unit": "pairs/s", "value": 2.4e9, "mode": "tiled",
        "device": "NVIDIA H100 80GB HBM3", "platform": "gpu", "macs": 2.9e14,
        "steady_s": 4.14}) + "\n")
    r = run(port_main, ["explain", "--roofline", str(h100)], pair.capsys)
    assert r.rc == 0 and "peak-table[NVIDIA H100 80GB HBM3]" in r.out
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    # the same exit and message, which names the port's bench, not the JAX
    # package's bench.py (F8)
    runs = pair.run(["explain", "--roofline", str(empty)])
    assert runs["port"].rc == runs["jax"].rc == 0
    assert "no history record" in runs["jax"].out and "bench.py" in runs["jax"].out
    assert "no history record" in runs["port"].out
    assert "kubernetes_verification_tpu_torch.bench" in runs["port"].out
    assert "bench.py" not in runs["port"].out

    h = str(tmp_path / "hist.jsonl")
    for v in [10.0, 10.5, 9.8, 10.2, 10.1]:
        append_run({"metric": "m", "value": v, "unit": "pairs/s"}, h)
    assert "ok" in pair.same_text(["history", h])
    append_run({"metric": "m", "value": 5.0, "unit": "pairs/s"}, h)
    assert "REGRESSED" in pair.same_text(["history", h])
    out = pair.same(["history", h, "--json"])
    assert out["ok"] is False
