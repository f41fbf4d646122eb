"""The port's port-bitmap serving engine on a ``(pods, grants)`` mesh
against the JAX package's, byte for byte: ``PackedPortsIncrementalVerifier(
mesh=)`` through policy, pod and namespace diffs and a checkpoint resumed
on another factorisation and on one device; and its pod-axis growth against
the port's one-device engine (which ``test_torch_packed_incremental_ports``
holds against the JAX engine's growth: the JAX engine recompiles every
kernel at each new pod a grow makes room for, ~25 s here).

As ``test_torch_mesh_engines.py``: the JAX side on the 8 virtual CPU
devices, the port's on one module-wide group of 8 gloo CPU ranks over the
``(8, 1)``, ``(4, 2)``, ``(2, 4)`` and ``(1, 8)`` meshes, its state (the VP
axis split over ``grants``, gathered) equal to the JAX engine's after the
build and every op on every rank. The op stream joins
``tests/test_packed_incremental_ports.py``'s mesh tests (port diffs, pod
churn, namespace relabel) at their size (57 pods / 9 policies); every cut
of the VP axis over 2, 4 and 8 grant ranks crosses a segment somewhere."""
import json

import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.harness import generate as jgen
from kubernetes_verification_tpu.packed_incremental_ports import (
    PackedPortsIncrementalVerifier as JaxEngine,
)
from kubernetes_verification_tpu.parallel.mesh import mesh_for as jax_mesh_for
from kubernetes_verification_tpu.utils import persist as jpersist
from kubernetes_verification_tpu_torch.utils import persist
from torch_mesh_child import MeshJob, _state, resolve_op
from torch_parity import replay_ops, same_state

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
PORTS = dict(n_pods=57, n_policies=9, n_namespaces=3, p_ports=0.8,
             p_named_port=0.3, p_container_ports=0.5, seed=7)
GROW = dict(PORTS, n_pods=120, seed=51)

OPS = [
    ["remove_policy", {"pol": 0}],
    ["add_policy", {"pol": 0, "name": "readd"}],
    ["update_policy", {"pol": 1, "ingress_of": 2}],
    ["add_pod", "mesh-new", {"ns_of": 0}, {"m": "1"}],
    ["remove_pod", {"pod": 7}],
    ["update_pod_labels", 3, {"labels_of": 12}],
    ["update_namespace_labels", {"ns": 0}, {"ns_labels_of": 2}],
    ["add_namespace", "fresh-ns", {"team": "new"}],
    ["add_pod", "in-fresh", "fresh-ns", {"app": "f"}],
    ["update_namespace_labels", {"ns": 1}, {"completely": "fresh"}],
]
#: twelve adds: eight pad slots, then a pod-axis grow
GROW_OPS = [*(["add_pod", f"grow-{i}", "ns-0", {"app": f"g{i}"}] for i in range(12)),
            ["update_policy", {"pol": 0, "ingress_of": 1}]]
CKPT_OPS = [["update_policy", {"pol": 1, "ingress_of": 2}], ["remove_policy", {"pol": 3}],
            ["save", "ck_ports"]]
RESUMED_OPS = [["add_policy", {"pol": 3, "name": "post-resume"}],
               ["remove_policy", {"pol": 1}], ["add_pod", "post", "ns-2", {"app": "p"}]]

CASES = {
    # the whole stream where the JAX tests relabel, diffs and churn elsewhere
    **{f"ports{s}": (s, PORTS, OPS if s in ((4, 2), (2, 4)) else OPS[:6]) for s in MESHES},
    **{f"grow{s}": (s, GROW, GROW_OPS) for s in [(1, 8), (4, 2)]},
    "ckpt(2, 4)": ((2, 4), PORTS, CKPT_OPS),
}


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    job = MeshJob(tmp_path_factory.mktemp("mesh_engines_ports"))
    for cid, (shape, gen, ops) in CASES.items():
        job.case(cid, "engine", shape, gen=gen, ops=ops, ports=True)
    job.case("resumed(4, 2)", "engine", (4, 2), gen=PORTS, ports=True,
             resume="ck_ports", ops=RESUMED_OPS)
    job.start()
    yield job
    job.close()


def _jax(shape, gen):
    cluster = jgen.random_cluster(jgen.GeneratorConfig(**gen))
    return cluster, JaxEngine(cluster, jkv.VerifyConfig(compute_ports=True),
                              mesh=jax_mesh_for(shape))


def _run(job, cid, **kw):
    shape, gen, ops = CASES[cid]
    cluster, eng = _jax(shape, gen)  # compiles while the ranks work
    res = job.result(cid)
    replay_ops(res, eng, cluster, ops, label=cid, **kw)
    np.testing.assert_array_equal(res["reach"], eng.reach)
    np.testing.assert_array_equal(res["reach_active"], eng.reach_active())
    return res, eng


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_mesh_sharded_port_diffs_churn_and_relabel(job, shape):
    _, eng = _run(job, f"ports{shape}")
    assert eng.n_active == (58 if shape in ((4, 2), (2, 4)) else 57)


def _live(state, n):
    """A recorded ports state over the first ``n`` pods only: the maps'
    and words' pad columns and the padding in the meta dropped (a grow on a
    ``dp``-way pod axis pads to ``128·dp``)."""
    out = {}
    for k, v in state.items():
        if k in ("vp_peers_i", "sel_ing_vp", "sel_eg_vp", "vp_peers_e"):
            v = np.unpackbits(v, axis=1, bitorder="little")[:, :n]
        elif k in ("ing_cnt", "eg_cnt"):
            v = v[:n]
        elif k == "packed":
            v = np.unpackbits(v.view(np.uint8), axis=1, bitorder="little")[:n, :n]
        elif k == "__meta__":
            meta = json.loads(str(v))
            meta.pop("n_padded")
            v = np.array(json.dumps(meta, sort_keys=True))
        out[k] = v
    return out


@pytest.mark.parametrize("shape", [(1, 8), (4, 2)], ids=str)
def test_mesh_pod_axis_growth_ports(job, shape):
    """A mesh engine's grow re-splits every shard over the grown pod axis:
    its state equals the one-device engine's after every add (whole at
    ``dp = 1``, over the live pods where ``128·dp`` pads further)."""
    _, gen, ops = CASES[f"grow{shape}"]
    res = job.result(f"grow{shape}")
    cluster = kvt.random_cluster(kvt.GeneratorConfig(**gen))
    eng = kvt.PackedPortsIncrementalVerifier(
        cluster, kvt.VerifyConfig(compute_ports=True), device="cpu")
    view = (lambda st: st) if shape[0] == 1 else (lambda st: _live(st, eng.n_pods))
    for i, op in enumerate(ops, 1):
        method, args = resolve_op(op, eng, cluster, kvt)
        getattr(eng, method)(*args)
        got = {k[len(f"{i}."):]: v for k, v in res.items()
               if k.startswith(f"{i}.") and k != f"{i}.ret"}
        same_state(view(_state(eng)), view(got), f"op {i}")
    assert eng._n_padded > 128 and eng.n_active == 132
    assert json.loads(str(res["13.__meta__"]))["n_padded"] > 128
    np.testing.assert_array_equal(res["reach"], eng.reach)


def test_checkpoint_resume_on_another_factorisation_ports(job, tmp_path):
    save = lambda eng, name: jpersist.save_ports_incremental(eng, str(tmp_path / name))
    _run(job, "ckpt(2, 4)", save=save)
    jres = jpersist.load_ports_incremental(str(tmp_path / "ck_ports"), mesh=jax_mesh_for((4, 2)))
    replay_ops(job.result("resumed(4, 2)"), jres, jgen.random_cluster(jgen.GeneratorConfig(**PORTS)),
               RESUMED_OPS, label="resumed")
    one = persist.load_ports_incremental(f"{job.dir}/ck_ports", device="cpu")
    want = jpersist.load_ports_incremental(str(tmp_path / "ck_ports"))
    same_state(want.state_dict()[0], one.state_dict()[0], "one device")
    assert want.state_dict()[1] == one.state_dict()[1]
