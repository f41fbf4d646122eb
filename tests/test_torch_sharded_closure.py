"""The port's mesh-sharded packed closure against the JAX package's, bit for
bit: ``sharded_packed_closure`` on every mesh factorisation and at an N no
mesh divides, its refusals, its checkpoint and resume (each package resumes
the other's checkpoint), the closure through ``PackedShardedResult`` and
the ``sharded-packed`` backend, and the pre-flight memory guard's estimate
and refusal.

The port's side runs once per module on 8 gloo CPU ranks
(``tests/torch_mesh_child.py``); the JAX side on the 8 virtual CPU
devices; every rank's arrays must equal rank 0's."""
import os

import numpy as np
import pytest

import kubernetes_verification_tpu as kv
from kubernetes_verification_tpu.harness.generate import (
    GeneratorConfig as JaxGeneratorConfig,
)
from kubernetes_verification_tpu.harness.generate import random_cluster as jax_random_cluster
from kubernetes_verification_tpu.ops.closure import packed_closure as jax_packed_closure
from kubernetes_verification_tpu.ops.tiled import pack_bool_cols
from kubernetes_verification_tpu.parallel import sharded_closure as jax_sc
from kubernetes_verification_tpu.parallel.mesh import mesh_for as jax_mesh_for
from kubernetes_verification_tpu.parallel.packed_sharded import sharded_packed_reach
from kubernetes_verification_tpu_torch.parallel import sharded_closure as port_sc
from kubernetes_verification_tpu_torch.resilience.errors import ConfigError
from torch_mesh_child import MeshJob
from torch_parity import carried

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
CLUSTER = dict(n_pods=40, n_policies=10, n_namespaces=3, seed=31)


def _random_packed(n, seed, density=None):
    """Random packed adjacency uint32 [n, ceil(n/32)], pad bits zero."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < (density if density else 6.0 / n)
    pad = (-n) % 32
    return np.asarray(pack_bool_cols(np.pad(adj, ((0, pad), (0, pad)))))[:n]


SQUARE = _random_packed(96, seed=5)
ODD = _random_packed(37, seed=9, density=0.15)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    job = MeshJob(tmp_path_factory.mktemp("sharded_closure"))
    square = job.array("square", SQUARE)
    for shape in MESHES:
        job.case(f"square{shape}", "packed_closure", shape, square, tile=32)
    job.case("odd", "packed_closure", (8, 1), job.array("odd", ODD), tile=32)
    job.case("float", "packed_closure", (8, 1), job.array("float", np.zeros((4, 4), np.float32)))
    job.case("rows", "packed_closure", (8, 1), job.array("rows", np.zeros((64, 1), np.uint32)))
    # a checkpoint after the first pass, then a resume on the same mesh
    job.case("resume", "packed_closure", (4, 2), square, tile=32, checkpoint_dir="port_ck",
             checkpoint_every=1, first_pass_only=True)
    # the JAX package's first-pass checkpoint, resumed by the port; and on
    # a mesh that pads differently, refused
    jax_ck = os.path.join(job.dir, "jax_ck")
    jax_sc.sharded_packed_closure(jax_mesh_for((4, 2)), SQUARE, tile=32, max_iter=1,
                                  checkpoint_dir=jax_ck, checkpoint_every=1)
    job.case("resume-jax", "packed_closure", (4, 2), square, tile=32, checkpoint_dir="jax_ck",
             resume=True)
    job.case("resume-other-mesh", "packed_closure", (8, 1), square, tile=32,
             checkpoint_dir="jax_ck", resume=True)
    enc = job.encoding("cluster", carried(**CLUSTER)[0])
    job.case("result", "packed", (4, 2), enc, tile=32, chunk=8, keep_matrix=True,
             closure_tile=32)
    opts = dict(tile=32, chunk=8, keep_matrix=True, closure_tile=32)
    job.case("verify", "verify", (8, 1), gen=CLUSTER, backend="sharded-packed",
             compute_ports=False, closure=True, self_traffic=False, options=opts)
    job.case("verify-guard", "verify", (8, 1), gen=CLUSTER, backend="sharded-packed",
             compute_ports=False, closure=True, options={**opts, "hbm_limit": 1024})
    job.start()
    yield job
    job.close()


def _error(got):
    _, is_value_error, msg = str(got).split("|", 2)
    return is_value_error == "True", msg


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_sharded_closure_matches_jax(job, shape):
    want = jax_sc.sharded_packed_closure(jax_mesh_for(shape), SQUARE, tile=32)
    got = job.result(f"square{shape}")["closure"]
    assert got.dtype == np.uint32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_packed_closure(SQUARE, tile=32)))


def test_odd_n_matches_jax(job):
    want = jax_sc.sharded_packed_closure(jax_mesh_for((8, 1)), ODD, tile=32)
    np.testing.assert_array_equal(job.result("odd")["closure"], want)


@pytest.mark.parametrize("case,what", [("float", "uint32"), ("rows", "bit columns")])
def test_rejects_malformed(job, case, what):
    with pytest.raises(ValueError):
        jax_sc.sharded_packed_closure(jax_mesh_for((8, 1)), np.load(
            os.path.join(job.dir, f"{case}.npz"))["x"])
    is_value_error, msg = _error(job.result(case)["error"])
    assert is_value_error and what in msg


def test_checkpoint_and_resume(job):
    """One pass with a checkpoint, then a resume to the fixpoint, equals
    the JAX package's first pass and closure; the JAX package resumes the
    port's checkpoint to the same closure, and the port the JAX package's;
    a mesh that pads differently refuses the checkpoint."""
    mesh = jax_mesh_for((4, 2))
    first = jax_sc.sharded_packed_closure(mesh, SQUARE, tile=32, max_iter=1)
    full = jax_sc.sharded_packed_closure(mesh, SQUARE, tile=32)
    assert not np.array_equal(first, full), "the closure must take more than one pass"
    got = job.result("resume")
    np.testing.assert_array_equal(got["first"], first)
    np.testing.assert_array_equal(got["closure"], full)
    np.testing.assert_array_equal(job.result("resume-jax")["closure"], full)
    resumed = jax_sc.sharded_packed_closure(
        mesh, SQUARE, tile=32, checkpoint_dir=os.path.join(job.dir, "port_ck"), resume=True)
    np.testing.assert_array_equal(resumed, full)
    is_value_error, msg = _error(job.result("resume-other-mesh")["error"])
    assert is_value_error and "padded shape" in msg


def test_closure_through_result_and_backend(job):
    jenc, _ = carried(**CLUSTER)
    pk = sharded_packed_reach(jax_mesh_for((4, 2)), jenc, tile=32, chunk=8, keep_matrix=True)
    want = pk.closure(tile=32, mesh=jax_mesh_for((4, 2)))
    np.testing.assert_array_equal(job.result("result")["closure"], want)
    # without a mesh: the one-device packed closure, equal to the JAX
    # package's one-device closure of the same result
    np.testing.assert_array_equal(job.result("result")["closure_one_device"], pk.closure(tile=32))
    cluster = jax_random_cluster(JaxGeneratorConfig(**CLUSTER))
    ref = kv.verify(cluster, kv.VerifyConfig(
        backend="cpu", compute_ports=False, closure=True, self_traffic=False))
    got = job.result("verify")
    np.testing.assert_array_equal(got["closure"], ref.closure)
    jax_res = kv.verify(cluster, kv.VerifyConfig(
        backend="sharded-packed", compute_ports=False, closure=True, self_traffic=False,
        backend_options=(("mesh", 8), ("tile", 32), ("chunk", 8), ("keep_matrix", True),
                         ("closure_tile", 32))))
    np.testing.assert_array_equal(got["closure_packed"], jax_res.closure_packed)
    # a budget too small refuses before any device work
    name, _, msg = str(job.result("verify-guard")["error"]).split("|", 2)
    assert name == "ClosureBudgetError" and "shard wider" in msg


@pytest.mark.parametrize("n,row_tile,dst_tile,dp,mp", [
    (1 << 20, 7168, 14336, 8, 1), (100_096, 7168, 14336, 1, 1), (8192, 2048, 4096, 2, 2),
    (96, 32, 32, 4, 2)])
def test_budget_estimate_matches_jax(n, row_tile, dst_tile, dp, mp):
    kw = dict(row_tile=row_tile, dst_tile=dst_tile, n_devices=dp, grant_devices=mp)
    assert port_sc.estimate_closure_hbm(n, **kw) == jax_sc.estimate_closure_hbm(n, **kw)
    limit = port_sc.estimate_closure_hbm(n, **kw)["total_bytes"] - 1
    errors = []
    for sc in (port_sc, jax_sc):
        with pytest.raises(sc.ClosureBudgetError) as exc:
            sc.check_closure_budget(n, limit_bytes=limit, **kw)
        errors.append(exc.value)
    assert str(errors[0]) == str(errors[1])
    assert errors[0].estimate == errors[1].estimate
    assert isinstance(errors[0], ConfigError)
    ok = port_sc.check_closure_budget(n, limit_bytes=limit + 1, **kw)
    assert ok == jax_sc.check_closure_budget(n, limit_bytes=limit + 1, **kw)


def test_device_budget_is_none_on_the_cpu(monkeypatch):
    monkeypatch.delenv("KVTPU_HBM_LIMIT_BYTES", raising=False)
    assert port_sc._device_budget("cpu") is None
    assert port_sc._device_budget(None) is None
    monkeypatch.setenv("KVTPU_HBM_LIMIT_BYTES", "2e9")
    assert port_sc._device_budget("cpu") == 2_000_000_000
    assert port_sc.check_closure_budget(96, row_tile=32, dst_tile=32)["limit_bytes"] == 2e9
