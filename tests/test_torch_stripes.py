"""The port's stripe fleet (``serve/stripes.py``, ``parallel/stripes.py``,
the stripe checkpoints of ``utils/persist.py`` and ``serve/durability.py``)
against the JAX package's, on the CPU. Over (n, K) cases with a ragged one
and one with more stripes than pods: every stripe's counts, isolation
counts and bookkeeping equal the JAX ``StripeEngine``'s byte for byte after
every event of one seeded stream, the coordinator's answers equal the JAX
coordinator's and the whole dense engine's, the wire bitmaps are the same
bytes, and a stripe checkpoint of either package loads in the other. A
SIGKILLed remote stripe owner (``tests/torch_stripe_child.py``) moves its
fragments to a backup or fails typed. Exact throughout."""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import kubernetes_verification_tpu as jkv
import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu.parallel import stripes as jgeo
from kubernetes_verification_tpu.serve import durability as jdur
from kubernetes_verification_tpu.serve import stripes as jstripes
from kubernetes_verification_tpu.utils import persist as jpersist
from kubernetes_verification_tpu_torch.harness.generate import random_event_stream
from kubernetes_verification_tpu_torch.observe.metrics import STRIPE_QUERIES_TOTAL
from kubernetes_verification_tpu_torch.parallel import stripes as pgeo
from kubernetes_verification_tpu_torch.resilience.errors import (
    ConfigError,
    PersistError,
    ServeError,
    StripeCoverageError,
    StripeRouteError,
)
from kubernetes_verification_tpu_torch.resilience.retry import RetryPolicy
from kubernetes_verification_tpu_torch.serve import VerificationService
from kubernetes_verification_tpu_torch.serve import durability as pdur
from kubernetes_verification_tpu_torch.serve import stripes as pstripes
from kubernetes_verification_tpu_torch.serve.transport import ReplicationClient
from kubernetes_verification_tpu_torch.utils import persist as ppersist
from torch_serve_parity import clusters, streams

_HERE = os.path.dirname(os.path.abspath(__file__))
_CHILD = os.path.join(_HERE, "torch_stripe_child.py")
_FAST = RetryPolicy(max_retries=0, backoff_base=0.001)
#: the stripe tests' generator knobs (the child mirrors them)
_GEN = dict(n_policies=10, n_namespaces=4, seed=11, p_ipblock_peer=0.0,
            min_selector_labels=1)
#: (pods, stripes): whole, ragged, even, and more stripes than pods
CASES = [(24, 1), (37, 3), (40, 4), (5, 8)]


def _cfgs():
    return (kvt.VerifyConfig(compute_ports=False),
            jkv.VerifyConfig(compute_ports=False))


def _names(cluster):
    return [f"{p.namespace}/{p.name}" for p in cluster.pods]


def _assert_stripe_equal(peng, jeng, where):
    assert peng.stripe_rows == jeng.stripe_rows, where
    for name in ("_ing_count", "_eg_count"):
        got = getattr(peng, name).cpu().numpy()
        want = np.asarray(getattr(jeng, name))
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), (where, name)
    np.testing.assert_array_equal(peng._ing_iso, jeng._ing_iso, err_msg=where)
    np.testing.assert_array_equal(peng._eg_iso, jeng._eg_iso, err_msg=where)
    assert list(peng.policies) == list(jeng.policies), where
    for key in peng.policies:
        for a, b in zip(peng._vectors[key], jeng._vectors[key]):
            np.testing.assert_array_equal(a, b, err_msg=where)
    assert peng.update_count == jeng.update_count, where
    assert peng.state_bytes() == jeng.state_bytes(), where


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"n{c[0]}-k{c[1]}")
def fleets(request):
    """Both packages' K stripe followers on one cluster, driven through the
    same 24-event stream one event at a time, compared after every event;
    returns the clusters, both fleets and the port's whole dense engine
    after the same events."""
    n, k = request.param
    pcluster, jcluster = clusters(n_pods=n, **_GEN)
    pevents, jevents = streams(jcluster, 24, seed=13)
    pcfg, jcfg = _cfgs()
    pf = [pstripes.StripeFollower(pcluster, pcfg, stripe=(s, k), device="cpu",
                                  replica=f"s{s}") for s in range(k)]
    jf = [jstripes.StripeFollower(jcluster, jcfg, stripe=(s, k), replica=f"s{s}")
          for s in range(k)]
    for a, b in zip(pf, jf):
        _assert_stripe_equal(a.engine, b.engine, "build")
    whole = kvt.IncrementalVerifier(pcluster, pcfg, device="cpu")
    whole_svc = VerificationService(engine=whole)
    for i, (pe, je) in enumerate(zip(pevents, jevents)):
        for a, b in zip(pf, jf):
            assert a.apply([pe]) == b.apply([je])
            _assert_stripe_equal(a.engine, b.engine, f"event {i} ({je.kind})")
            assert (a.generation, a.applied_total, a.fanout_total) == (
                b.generation, b.applied_total, b.fanout_total)
        whole_svc.apply([pe])
    return pcluster, jcluster, pf, jf, whole_svc.engine


def test_every_stripe_equals_jax_after_every_event(fleets):
    """The fixture compares after every event; here the end state, the
    fan-out counts (no event is filtered) and the 1/K + ε state bound."""
    pcluster, _, pf, jf, whole = fleets
    n, k = len(pcluster.pods), len(pf)
    bound = 2 * n * n * 4 / k + 64 * n
    for a, b in zip(pf, jf):
        _assert_stripe_equal(a.engine, b.engine, "end")
        assert a.health() == b.health()
        assert a.engine.state_bytes() <= bound
        assert a.applied_total == pf[0].applied_total
    if k == 1:
        assert pf[0].fanout_total == 0


def test_coordinator_answers_equal_jax_and_the_whole_engine(fleets):
    pcluster, jcluster, pf, jf, whole = fleets
    pc = pstripes.StripeCoordinator(pf, pods=pcluster.pods)
    jc = jstripes.StripeCoordinator(jf, pods=jcluster.pods)
    assert pc.device.type == "cpu"
    names = _names(pcluster)
    n = len(names)
    reach = whole.reach
    rng = np.random.default_rng(3)
    pairs = rng.integers(0, n, size=(64, 2))
    q = [(names[a], names[b]) for a, b in pairs]
    got = pc.can_reach_batch(q)
    np.testing.assert_array_equal(got, jc.can_reach_batch(q))
    np.testing.assert_array_equal(got, reach[pairs[:, 0], pairs[:, 1]])
    some = [names[i] for i in rng.integers(0, n, size=6)]
    assert pc.who_can_reach_batch(some) == jc.who_can_reach_batch(some)
    assert pc.blast_radius_batch(some) == jc.blast_radius_batch(some)
    rows = pc._scatter_rows(np.arange(n))
    np.testing.assert_array_equal(rows, reach)
    for a, b in pairs[:4]:
        assert pc.path_exists(names[a], names[b], 3) == jc.path_exists(
            names[a], names[b], 3)
        assert pc.hops(names[a], names[b], 4) == jc.hops(names[a], names[b], 4)
    assert pc.can_reach(*q[0]) == jc.can_reach(*q[0])
    assert pc.describe() == jc.describe()


def test_stripe_checkpoints_load_across_the_packages(fleets, tmp_path):
    """``save_stripe_incremental`` writes the JAX package's files: each
    package loads the other's snapshot, and each ladder recovers the
    other's stripe generation to equal counts."""
    pcluster, jcluster, pf, jf, _ = fleets
    pcfg, jcfg = _cfgs()
    k = len(pf)
    s = k // 2
    ppersist.save_stripe_incremental(pf[s].engine, str(tmp_path / "p"))
    jpersist.save_stripe_incremental(jf[s].engine, str(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    from_p = jpersist.load_stripe_incremental(str(tmp_path / "p"), (s, k), jcfg)
    from_j = ppersist.load_stripe_incremental(str(tmp_path / "j"), (s, k), pcfg,
                                              device="cpu")
    _assert_stripe_equal(pf[s].engine, from_p, "port snapshot in JAX")
    _assert_stripe_equal(from_j, jf[s].engine, "JAX snapshot in the port")
    with pytest.raises(PersistError):
        ppersist.load_stripe_incremental(str(tmp_path / "j"), (s, k + 1), pcfg,
                                         device="cpu")

    pf[s].checkpoint(pdur.CheckpointManager(str(tmp_path / "pck"), fsync=False))
    jf[s].checkpoint(jdur.CheckpointManager(str(tmp_path / "jck"), fsync=False))
    jres = jdur.RecoveryManager(str(tmp_path / "pck")).recover_stripe((s, k), config=jcfg)
    pres = pdur.RecoveryManager(str(tmp_path / "jck")).recover_stripe(
        (s, k), config=pcfg, device="cpu")
    assert jres.outcome == pres.outcome == "newest"
    _assert_stripe_equal(pf[s].engine, jres.service.engine, "port ladder in JAX")
    _assert_stripe_equal(pres.service.engine, jf[s].engine, "JAX ladder in the port")
    with pytest.raises(PersistError):
        pdur.RecoveryManager(str(tmp_path / "jck")).recover_stripe(
            ((s + 1) % (k + 1), k + 1), config=pcfg, device="cpu")


@pytest.mark.parametrize("shape", [(3, 7), (1, 1), (4, 32), (0, 5), (9, 13)])
def test_pack_bool_bytes_equal_jax(shape):
    arr = np.random.default_rng(sum(shape)).random(shape) < 0.4
    doc = pstripes._pack_bool(arr)
    assert doc == jstripes._pack_bool(arr)
    np.testing.assert_array_equal(pstripes._unpack_bool(doc), arr)
    np.testing.assert_array_equal(jstripes._unpack_bool(doc), arr)


@pytest.mark.parametrize("n,k", [(0, 1), (1, 1), (7, 3), (13, 4), (5, 8), (523, 4)])
def test_stripe_geometry_equals_jax(n, k):
    assert pgeo.stripe_table(n, k) == jgeo.stripe_table(n, k)
    for pod in range(n):
        assert pgeo.stripe_of(n, k, pod) == jgeo.stripe_of(n, k, pod)
    assert pgeo.parse_stripe(f"{k}/{k}") == jgeo.parse_stripe(f"{k}/{k}")
    with pytest.raises(ConfigError):
        pgeo.stripe_bounds(n, k, k)
    with pytest.raises(ConfigError):
        pgeo.parse_stripe(f"{k + 1}/{k}")


def test_routing_refusals_and_down_stripes_are_typed():
    """An off-stripe row, a ported probe, a stripe with no owner: each
    raises, and no answer comes back shorter."""
    pcluster, _ = clusters(n_pods=24, **_GEN)
    pcfg, _ = _cfgs()
    owners = [pstripes.StripeFollower(pcluster, pcfg, stripe=(s, 3), device="cpu")
              for s in range(3)]
    with pytest.raises(StripeRouteError):
        owners[1].engine.reach_rows([0])
    with pytest.raises(StripeRouteError):
        owners[1].engine.reach
    coord = pstripes.StripeCoordinator([owners[0], owners[2]], pods=pcluster.pods)
    assert coord.coverage_gaps() == [1]
    names = _names(pcluster)
    lo, hi = pgeo.stripe_bounds(24, 1, 3)
    with pytest.raises(StripeCoverageError) as ei:
        coord.can_reach(names[lo], names[0])
    assert ei.value.stripe == (1, 3) and ei.value.rows == (lo, hi)
    with pytest.raises(StripeCoverageError):
        coord.who_can_reach(names[0])
    with pytest.raises(ServeError):
        coord.can_reach(names[0], names[1], 8080)
    with pytest.raises(ConfigError):
        pstripes.StripeCoordinator([], pods=pcluster.pods)
    with pytest.raises(ServeError):
        owners[0].handle_stripe_op({"op": "nonsense"})


def test_stripe_engine_slabs_its_build(monkeypatch):
    """A slab smaller than the stripe gives the same counts as one
    product: the build's row slabs change no count."""
    pcluster, _ = clusters(n_pods=40, **_GEN)
    pcfg, _ = _cfgs()
    whole = pstripes.StripeEngine(pcluster, pcfg, "cpu", stripe=(1, 2))
    monkeypatch.setattr(pstripes, "_SLAB_CELLS", 40 * 3)
    monkeypatch.setattr(pstripes, "_SLAB_ROW_PAD", 1)
    slabbed = pstripes.StripeEngine(pcluster, pcfg, "cpu", stripe=(1, 2))
    assert whole._ing_count.equal(slabbed._ing_count)
    assert whole._eg_count.equal(slabbed._eg_count)


def _spawn_owner(workdir, index, count):
    os.makedirs(workdir, exist_ok=True)
    url_file = os.path.join(workdir, "url.txt")
    ack_file = os.path.join(workdir, "ack")
    proc = subprocess.Popen(
        [sys.executable, _CHILD, "--workdir", workdir, "--url-file", url_file,
         "--ack-file", ack_file, "--stripe-index", str(index),
         "--stripe-count", str(count)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    deadline = time.time() + 90
    while not os.path.exists(url_file):
        assert proc.poll() is None, proc.communicate()[1]
        assert time.time() < deadline, "the stripe owner never published its URL"
        time.sleep(0.02)
    with open(url_file) as fh:
        return proc, fh.read().strip(), ack_file


def test_sigkilled_stripe_owner_moves_to_its_backup_or_fails_typed(tmp_path):
    """A remote stripe owner (a child process on the port) answers like the
    in-process follower; SIGKILLed, its fragments move to the backup of the
    same stripe with the answers unchanged; with the backup gone too, every
    query touching the stripe raises ``StripeCoverageError``."""
    pcluster, _ = clusters(n_pods=30, **_GEN)
    pevents = random_event_stream(pcluster, n_events=24, seed=13)
    pcfg, _ = _cfgs()
    local = [pstripes.StripeFollower(pcluster, pcfg, stripe=(s, 3), device="cpu",
                                     replica=f"local-{s}") for s in range(3)]
    for f in local:
        f.apply(pevents)
    proc, url, ack = _spawn_owner(str(tmp_path / "a"), 1, 3)
    try:
        remote = pstripes.RemoteStripeOwner(ReplicationClient(url, policy=_FAST,
                                                               timeout=10.0))
        assert remote.stripe == (1, 3)
        lo, hi = pgeo.stripe_bounds(30, 1, 3)
        np.testing.assert_array_equal(remote.rows(range(lo, hi)),
                                      local[1].rows(range(lo, hi)))
        np.testing.assert_array_equal(remote.cols_fragment([0, 7, 29]),
                                      local[1].cols_fragment([0, 7, 29]))
        oracle = pstripes.StripeCoordinator(local, pods=pcluster.pods)
        coord = pstripes.StripeCoordinator([local[0], remote, local[1], local[2]],
                                           pods=pcluster.pods)
        names = _names(pcluster)
        rng = np.random.default_rng(9)
        q = [(names[a], names[b]) for a, b in rng.integers(0, 30, size=(48, 2))]
        np.testing.assert_array_equal(coord.can_reach_batch(q), oracle.can_reach_batch(q))
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        retries = STRIPE_QUERIES_TOTAL.labels(route="retry").value
        np.testing.assert_array_equal(coord.can_reach_batch(q), oracle.can_reach_batch(q))
        assert coord.who_can_reach_batch(names[:4]) == oracle.who_can_reach_batch(names[:4])
        assert STRIPE_QUERIES_TOTAL.labels(route="retry").value > retries
        alone = pstripes.StripeCoordinator([local[0], remote, local[2]],
                                           pods=pcluster.pods)
        with pytest.raises(StripeCoverageError):
            alone.can_reach(names[lo], names[0])
        with pytest.raises(StripeCoverageError):
            alone.who_can_reach(names[0])
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.communicate(timeout=30)
        with open(ack, "w") as fh:
            fh.write("done")
