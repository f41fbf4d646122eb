"""Rank launcher of the port's mesh tests: runs a job of sharded cases on a
group of gloo CPU ranks and writes each rank's results.

    python tests/torch_mesh_child.py JOB.json

``JOB.json`` holds ``world`` (ranks), ``port`` (a free localhost port),
``out`` (the results directory) and ``cases``: each a dict with ``id``,
``kind`` (a key of ``RUNNERS``), ``shape`` (the ``(pods, grants)`` mesh),
``enc`` (an ``.npz`` of carried arrays, or null), ``gen`` (the
``GeneratorConfig`` fields of the cluster, or ``[n, p, seed]`` of a kano
scenario, or null) and ``kw``. Every rank joins one process group, builds
each case's mesh over it (all four factorisations over the same world) and
writes ``<out>/<id>.r<rank>.npz``: the case's arrays, or ``error`` (the
exception's class and message) when the call raised. Imports the PyTorch
port only; the tests hold the files against the JAX package.

The ``engine`` kind builds a serving engine on the mesh (or resumes one
from a checkpoint a previous case saved) and applies a scripted op list
(``resolve_op``: JSON ops, which the tests resolve against the JAX
package's objects the same way), writing the state after the build and
after every op.
"""
import dataclasses
import json
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_encoding(path):
    from kubernetes_verification_tpu_torch.encode.carry import encoding_from_arrays
    from kubernetes_verification_tpu_torch.encode.encoder import EncodedKano

    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(str(z["__meta__"]))
    if meta["kind"] == "kano":
        return EncodedKano(
            n_pods=meta["n_pods"], n_policies=meta["n_policies"], vocab=None, **arrays
        )
    if meta["kind"] == "array":
        return arrays["x"]
    return encoding_from_arrays(
        arrays, n_pods=meta["n_pods"], n_namespaces=meta["n_namespaces"],
        n_policies=meta["n_policies"], atoms=[tuple(a) for a in meta["atoms"]],
    )


def cluster_of(gen):
    import kubernetes_verification_tpu_torch as kvt

    if gen == "kubesv_paper_example":
        from kubernetes_verification_tpu_torch.models.fixtures import kubesv_paper_example

        return kubesv_paper_example()
    return kvt.random_cluster(kvt.GeneratorConfig(**gen))


def _flags(kw):
    return {k: kw[k] for k in ("self_traffic", "default_allow_unselected",
                               "direction_aware_isolation") if k in kw}


def _error(e):
    return np.array(f"{type(e).__name__}|{isinstance(e, ValueError)}|{e}")


def _try(fn):
    try:
        return np.asarray(fn())
    except Exception as e:  # noqa: BLE001 — the test compares the refusal
        return _error(e)


def _lists(lists):
    """Ragged int lists as (lengths, values)."""
    return (np.array([len(x) for x in lists], dtype=np.int64),
            np.array([v for x in lists for v in x], dtype=np.int64))


def run_k8s(mesh, case, enc):
    from kubernetes_verification_tpu_torch.parallel.sharded_ops import sharded_k8s_reach

    out, closure = sharded_k8s_reach(
        mesh, enc, with_closure=case["kw"].get("with_closure", False),
        **{"self_traffic": True, "default_allow_unselected": True,
           "direction_aware_isolation": True, **_flags(case["kw"])},
    )
    res = dict(out._asdict())
    if closure is not None:
        res["closure"] = closure
    return res


def run_kano(mesh, case, enc):
    from kubernetes_verification_tpu_torch.parallel.sharded_ops import sharded_kano_reach

    out, closure = sharded_kano_reach(mesh, enc, with_closure=case["kw"].get("with_closure", False))
    res = dict(out._asdict())
    if closure is not None:
        res["closure"] = closure
    return res


def run_closure(mesh, case, matrix):
    from kubernetes_verification_tpu_torch.parallel.sharded_ops import sharded_closure

    return {"closure": sharded_closure(mesh, matrix)}


def _packed_queries(pk, case, res):
    kw = case["kw"]
    res["all_reachable"] = _try(pk.all_reachable)
    res["all_isolated"] = _try(pk.all_isolated)
    res["to_bool"] = _try(pk.to_bool)
    for idx in kw.get("isolation_of", []):
        res[f"system_isolation_{idx}"] = _try(lambda: pk.system_isolation(idx))
    for label in kw.get("crosscheck", []):
        pods = cluster_of(case["gen"]).pods
        res[f"crosscheck_{label}"] = _try(lambda: pk.user_crosscheck(pods, label))
    return res


def run_packed(mesh, case, enc):
    from kubernetes_verification_tpu_torch.ops.queries import user_groups
    from kubernetes_verification_tpu_torch.parallel.packed_sharded import sharded_packed_reach

    kw = dict(case["kw"])
    for k in ("isolation_of", "crosscheck"):
        kw.pop(k, None)
    label = kw.pop("groups_label", None)
    if label is not None:
        kw["groups"] = user_groups(cluster_of(case["gen"]).pods, label)
    if "stripe" in kw:
        kw["stripe"] = tuple(kw["stripe"])
    closure_tile = kw.pop("closure_tile", None)
    pk = sharded_packed_reach(mesh, enc, **kw)
    res = {
        "out_degree": pk.out_degree, "in_degree": pk.in_degree,
        "total_pairs": np.int64(pk.total_pairs),
        "ingress_isolated": pk.ingress_isolated, "egress_isolated": pk.egress_isolated,
        "full_sweep": np.bool_(pk.full_sweep), "tiles": np.int64(pk.timings["tiles"]),
    }
    if pk.packed is not None:
        res["packed"] = pk.packed
    if pk.group_in_degree is not None:
        res["group_in_degree"] = pk.group_in_degree
    if "n_chunks" in pk.timings:
        res["n_chunks"] = np.int64(pk.timings["n_chunks"])
    if closure_tile is not None:
        res["closure"] = _try(lambda: pk.closure(tile=closure_tile, mesh=mesh))
        res["closure_one_device"] = _try(lambda: pk.closure(tile=closure_tile, device="cpu"))
    return _packed_queries(pk, case, res)


def run_pair_masks(mesh, case, enc):
    from kubernetes_verification_tpu_torch.ops.tiled import (
        policy_pair_masks_sharded,
        policy_sets_sharded,
    )

    kw = case["kw"]
    shadow, conflict = policy_pair_masks_sharded(mesh, enc, **kw)
    src, dst = policy_sets_sharded(mesh, enc, **kw)
    return {"shadow": shadow, "conflict": conflict, "src_sets": src, "dst_sets": dst}


def run_packed_closure(mesh, case, packed):
    from kubernetes_verification_tpu_torch.parallel.sharded_closure import (
        sharded_packed_closure,
    )

    kw = dict(case["kw"])
    if kw.get("checkpoint_dir"):
        kw["checkpoint_dir"] = os.path.join(case["out"], kw["checkpoint_dir"])
    res = {}
    if kw.pop("first_pass_only", False):
        # one pass with a checkpoint, then a fresh call resumes from it
        res["first"] = sharded_packed_closure(
            mesh, packed, **{**kw, "max_iter": 1, "resume": False, "checkpoint_every": 1})
        kw["resume"] = True
    res["closure"] = sharded_packed_closure(mesh, packed, **kw)
    return res


def run_verify(mesh, case, _):
    import kubernetes_verification_tpu_torch as kvt

    kw = dict(case["kw"])
    opts = tuple((k, tuple(v) if isinstance(v, list) else v)
                 for k, v in kw.pop("options", {}).items())
    queries = kw.pop("queries", False)
    cluster = cluster_of(case["gen"])
    cfg = kvt.VerifyConfig(
        backend_options=(("mesh", tuple(case["shape"])), ("device", "cpu")) + opts, **kw)
    try:
        res = kvt.verify(cluster, cfg)
    except Exception as e:  # noqa: BLE001
        return {"error": _error(e)}
    out = {}
    for f in ("reach", "reach_ports", "selected", "src_sets", "dst_sets",
              "ingress_isolated", "egress_isolated", "closure"):
        v = getattr(res, f)
        if v is not None:
            out[f] = v
    if cfg.backend == "sharded-packed":
        pk = res.packed_result
        out["out_degree"], out["in_degree"] = pk.out_degree, pk.in_degree
        if pk.packed is not None:
            out["packed"] = pk.packed
        if res.closure_packed is not None:
            out["closure_packed"] = res.closure_packed
        out["reach_is_none"] = np.bool_(res.reach is None)
    if queries:
        out["all_isolated"] = _try(res.all_isolated)
        out["all_reachable"] = _try(res.all_reachable)
        out["system_isolation_3"] = _try(lambda: res.system_isolation(3))
        for label in ("team", "app"):
            out[f"crosscheck_{label}"] = _try(lambda: res.user_crosscheck(cluster.pods, label))
        out["reachable_0_1"] = _try(lambda: res.reachable(0, 1))
        out["policy_shadow"] = _try(lambda: np.array(res.policy_shadow(), dtype=np.int64).reshape(-1, 2))
        out["policy_conflict"] = _try(
            lambda: np.array(res.policy_conflict(), dtype=np.int64).reshape(-1, 2))
        if cfg.backend == "sharded-packed":
            out["sets_over_budget"] = _try(lambda: res.materialize_policy_sets(max_bytes=10))
            src, dst = res.materialize_policy_sets()
            out["materialized_src"], out["materialized_dst"] = src, dst
    return out


def run_verify_kano(mesh, case, _):
    import kubernetes_verification_tpu_torch as kvt

    n, p, seed = case["gen"]
    if n == 0:
        from kubernetes_verification_tpu_torch.models.fixtures import kano_paper_example

        containers, policies = kano_paper_example()
    else:
        containers, policies = kvt.random_kano(n, p, seed=seed)
    cfg = kvt.VerifyConfig(
        backend="sharded", closure=case["kw"].get("closure", False),
        backend_options=(("mesh", tuple(case["shape"])), ("device", "cpu")))
    res = kvt.verify_kano(containers, policies, cfg)
    out = {"reach": res.reach, "src_sets": res.src_sets, "dst_sets": res.dst_sets}
    if res.closure is not None:
        out["closure"] = res.closure
    out["select_len"], out["select_val"] = _lists([c.select_policies for c in containers])
    out["allow_len"], out["allow_val"] = _lists([c.allow_policies for c in containers])
    out["all_isolated"] = np.asarray(res.all_isolated())
    out["crosscheck_app"] = np.asarray(res.user_crosscheck(containers, "app"))
    return out


def resolve_op(op, eng, cluster, pkg):
    """``(method, args)`` of one scripted engine op (a JSON list) on ``eng``
    built from ``cluster``; ``pkg`` is the package whose model classes the
    args use (the port here, the JAX package in the tests):

    * ``["remove_policy", {"pol": i}]``, ``["add_policy", {"pol": i,
      "name": n}]`` (or ``{"donor": gen, ...}``: policy ``i`` of another
      generated cluster), ``["update_policy", {"pol": i, "ingress_of": j}]``
      — ``i``/``j`` index the built cluster's policies;
    * ``["update_pod_labels", idx, labels | {"labels_of": k}]``;
    * ``["add_pod", name, ns | {"ns_of": k}, labels]``, ``["remove_pod",
      {"pod": k}]`` — ``k`` is a pod slot of the engine at that moment;
    * ``["update_namespace_labels", {"ns": i}, labels | {"ns_labels_of":
      j}]``, ``["add_namespace", name, labels]``,
      ``["remove_namespace", name]``."""
    name, *args = op
    pols = list(cluster.policies)

    def policy(spec):
        src = pols
        if "donor" in spec:
            src = list(pkg.random_cluster(pkg.GeneratorConfig(**spec["donor"])).policies)
        pol = src[spec["pol"]]
        if "ingress_of" in spec:
            pol = dataclasses.replace(pol, ingress=pols[spec["ingress_of"]].ingress)
        if "name" in spec:
            pol = dataclasses.replace(pol, name=spec["name"])
        return pol

    if name == "remove_policy":
        p = pols[args[0]["pol"]]
        return name, (p.namespace, p.name)
    if name in ("add_policy", "update_policy"):
        return name, (policy(args[0]),)
    if name == "update_pod_labels":
        idx, labels = args
        if isinstance(labels, dict) and "labels_of" in labels:
            labels = dict(eng.pods[labels["labels_of"]].labels)
        return name, (idx, labels)
    if name == "add_pod":
        pod_name, ns, labels = args
        if isinstance(ns, dict):
            ns = eng.pods[ns["ns_of"]].namespace
        return name, (pkg.Pod(pod_name, ns, labels),)
    if name == "remove_pod":
        victim = eng.pods[args[0]["pod"]]
        return name, (victim.namespace, victim.name)
    if name == "update_namespace_labels":
        ns, labels = args
        if isinstance(labels, dict) and "ns_labels_of" in labels:
            labels = dict(cluster.namespaces[labels["ns_labels_of"]].labels)
        return name, (cluster.namespaces[ns["ns"]].name, labels)
    if name == "add_namespace":
        return name, (pkg.Namespace(args[0], args[1]),)
    return name, tuple(args)


def _state(eng):
    """The engine's state, copied (``dirty_rows`` and the like are the live
    arrays, which later ops change in place)."""
    st = eng.state_dict()
    meta = None
    if isinstance(st, tuple):  # the ports engine: (arrays, meta)
        st, meta = st
    out = {k: np.array(v) for k, v in st.items()}
    if meta is not None:
        out["__meta__"] = np.array(json.dumps(meta, sort_keys=True))
    return out


def run_engine(mesh, case, _):
    import kubernetes_verification_tpu_torch as kvt
    from kubernetes_verification_tpu_torch.utils import persist

    kw = case["kw"]
    ports = kw.get("ports", False)
    cfg = kvt.VerifyConfig(compute_ports=ports)
    cluster = cluster_of(case["gen"])
    if kw.get("resume"):
        load = persist.load_ports_incremental if ports else persist.load_packed_incremental
        eng = load(os.path.join(case["out"], kw["resume"]), mesh=mesh, **kw.get("build", {}))
    else:
        cls = kvt.PackedPortsIncrementalVerifier if ports else kvt.PackedIncrementalVerifier
        eng = cls(cluster, cfg, mesh=mesh, **kw.get("build", {}))
    res = {f"0.{k}": v for k, v in _state(eng).items()}
    for i, op in enumerate(kw.get("ops", []), 1):
        if op[0] == "save":
            save = persist.save_ports_incremental if ports else persist.save_packed_incremental
            save(eng, os.path.join(case["out"], op[1]))
            continue
        if op[0] == "sweep":
            for d0, words in eng.sweep_dirty(op[1]):
                res[f"{i}.sweep.{d0}"] = words
            continue
        if op[0] == "stripe":
            res[f"{i}.stripe"] = _try(lambda: eng.solve_stripe(op[1], op[2]))
            continue
        if op[0] == "rows":
            res[f"{i}.rows"] = _try(lambda: eng.solve_rows(op[1]))
            continue
        method, args = resolve_op(op, eng, cluster, kvt)
        ret = getattr(eng, method)(*args)
        if ret is not None:
            res[f"{i}.ret"] = np.asarray(ret)
        res.update({f"{i}.{k}": v for k, v in _state(eng).items()})
    if getattr(eng, "keep_matrix", True):  # the ports engine always keeps it
        res["reach"] = eng.reach
        res["reach_active"] = eng.reach_active()
    else:
        res["packed_reach"] = _try(eng.packed_reach)
    if kw.get("closure"):
        res["closure"] = eng.closure_packed(tile=64)
    return res


RUNNERS = {
    "engine": run_engine,
    "k8s": run_k8s,
    "kano": run_kano,
    "closure": run_closure,
    "packed": run_packed,
    "pair_masks": run_pair_masks,
    "packed_closure": run_packed_closure,
    "verify": run_verify,
    "verify_kano": run_verify_kano,
}


def rank_main(rank, job):
    import torch

    from kubernetes_verification_tpu_torch.parallel.mesh import init_distributed, mesh_for

    torch.set_num_threads(1)
    init_distributed(
        f"tcp://127.0.0.1:{job['port']}", job["world"], rank, device="cpu",
        timeout_s=job.get("timeout_s", 300),
    )
    for case in job["cases"]:
        case = {**case, "out": job["out"]}
        arg = load_encoding(case["enc"]) if case.get("enc") else None
        try:
            mesh = mesh_for(tuple(case["shape"]), device="cpu")
            res = RUNNERS[case["kind"]](mesh, case, arg)
        except Exception as e:  # noqa: BLE001 — recorded, compared by the test
            if os.environ.get("KVT_MESH_CHILD_TRACE"):
                traceback.print_exc()
            res = {"error": _error(e)}
        path = os.path.join(job["out"], f"{case['id']}.r{rank}.npz")
        np.savez(path + ".tmp.npz", **{k: np.asarray(v) for k, v in res.items()})
        os.replace(path + ".tmp.npz", path)
    import torch.distributed as dist

    dist.destroy_process_group()


class MeshJob:
    """The test side: collect cases, start one ``world``-rank group on them
    (``start``), and read each case's result (``result``) once the group
    has ended — within ``timeout`` seconds of the start, else the group is
    killed and the test fails."""

    def __init__(self, workdir, *, world=8, timeout=300.0):
        self.dir = str(workdir)
        self.world = world
        self.timeout = timeout
        self.cases = []
        self.proc = None
        self.rc = None

    def _npz(self, name, arrays, meta):
        path = os.path.join(self.dir, f"{name}.npz")
        np.savez(path, __meta__=np.array(json.dumps(meta)), **arrays)
        return path

    def encoding(self, name, jenc):
        """Carry a JAX ``EncodedCluster`` to the ranks as arrays."""
        from kubernetes_verification_tpu_torch.encode.carry import encoding_to_arrays

        atoms = [[a.protocol, int(a.lo), int(a.hi), a.name] for a in jenc.atoms]
        return self._npz(name, encoding_to_arrays(jenc), dict(
            kind="k8s", n_pods=jenc.n_pods, n_namespaces=jenc.n_namespaces,
            n_policies=jenc.n_policies, atoms=atoms))

    def kano(self, name, jkenc):
        keys = ("pod_kv", "src_req", "src_impossible", "dst_req", "dst_impossible")
        return self._npz(name, {k: getattr(jkenc, k) for k in keys}, dict(
            kind="kano", n_pods=jkenc.n_pods, n_policies=jkenc.n_policies))

    def array(self, name, x):
        return self._npz(name, {"x": np.asarray(x)}, dict(kind="array"))

    def case(self, case_id, kind, shape, enc=None, gen=None, **kw):
        self.cases.append(dict(id=case_id, kind=kind, shape=list(shape), enc=enc,
                               gen=gen, kw=kw))

    def start(self):
        import socket
        import subprocess

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        job = dict(world=self.world, port=port, out=self.dir, cases=self.cases,
                   timeout_s=self.timeout)
        path = os.path.join(self.dir, "job.json")
        with open(path, "w") as fh:
            json.dump(job, fh)
        self._log = open(os.path.join(self.dir, "child.log"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path],
            stdout=self._log, stderr=subprocess.STDOUT, start_new_session=True,
        )
        import time

        self._deadline = time.monotonic() + self.timeout
        return self

    def close(self):
        import signal

        if self.proc is not None and self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        if self.proc is not None:
            self._log.close()

    def _wait(self):
        import subprocess
        import time

        if self.rc is None:
            try:
                self.rc = self.proc.wait(timeout=max(1.0, self._deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.close()
                self.rc = "timeout"
        return self.rc

    def result(self, case_id):
        """Rank 0's arrays of the case, after checking that every rank
        wrote the same ones."""
        rc = self._wait()
        ranks = []
        for r in range(self.world):
            path = os.path.join(self.dir, f"{case_id}.r{r}.npz")
            if not os.path.exists(path):
                with open(os.path.join(self.dir, "child.log")) as fh:
                    log = fh.read()[-4000:]
                raise AssertionError(f"rank {r} wrote no result for {case_id} (rc {rc}):\n{log}")
            with np.load(path) as z:
                ranks.append({k: z[k] for k in z.files})
        for r, res in enumerate(ranks[1:], 1):
            assert res.keys() == ranks[0].keys(), (case_id, r)
            for k in res:
                assert np.array_equal(res[k], ranks[0][k]), f"{case_id}: rank {r} differs on {k}"
        return ranks[0]


def main(argv):
    import torch.multiprocessing as mp

    with open(argv[1]) as fh:
        job = json.load(fh)
    mp.start_processes(rank_main, args=(job,), nprocs=job["world"], start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
