"""Guards of the PyTorch port: it never imports JAX nor the JAX package, and
its entry points refuse to fall back to the CPU when no GPU is present."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.resilience.errors import BackendError

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.join(_ROOT, "kubernetes_verification_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "kubernetes_verification_tpu")


def _port_files():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for dirpath, dirnames, names in os.walk(_PKG):
        dirnames[:] = [d for d in dirnames if d != "_build"]  # build output
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, _ROOT)
)
def test_port_file_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(_FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, _ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, kubernetes_verification_tpu_torch as k; "
        "import kubernetes_verification_tpu_torch.backends.device; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kubernetes_verification_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_the_cpu_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=2, n_pods=20, n_policies=4))
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    with pytest.raises(BackendError, match="no CUDA device"):
        kvt.tiled_k8s_reach(enc)
    with pytest.raises(BackendError, match="no CUDA device"):
        kvt.verify(cluster, kvt.VerifyConfig(compute_ports=False))
    # the CPU runs only when asked for
    assert kvt.tiled_k8s_reach(enc, device="cpu").n_pods == 20


def test_new_entry_points_refuse_the_cpu_without_a_gpu(monkeypatch):
    """The closures, the pair masks, kano mode and both serving engines
    default to ``cuda`` too: host inputs raise without a GPU, and run on the CPU when
    asked."""
    import numpy as np

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=3, n_pods=20, n_policies=4))
    enc = kvt.encode_cluster(cluster, compute_ports=False)
    words = np.zeros((32, 1), np.uint32)
    containers, policies = kvt.random_kano(8, 3, seed=1)
    host = kvt.tiled_k8s_reach(enc, device="cpu")
    state = kvt.PackedIncrementalVerifier(cluster, device="cpu").state_dict()
    ports_state = kvt.PackedPortsIncrementalVerifier(cluster, device="cpu").state_dict()
    calls = [
        lambda **d: kvt.PackedIncrementalVerifier(cluster, **d),
        lambda **d: kvt.PackedIncrementalVerifier.from_state(cluster, state, **d),
        lambda **d: kvt.PackedPortsIncrementalVerifier(cluster, **d),
        lambda **d: kvt.PackedPortsIncrementalVerifier.from_state(
            cluster, *ports_state, **d),
        lambda **d: kvt.packed_closure(words, **d),
        lambda **d: kvt.bounded_packed_closure(words, [0], **d),
        lambda **d: kvt.path_upto(words, 2, **d),
        lambda **d: kvt.bounded_closure_rows(
            lambda i: np.zeros((len(i), 4), bool), [0], 4, **d
        ),
        lambda **d: kvt.packed_closure_delta(words, words, np.zeros(32, bool), **d),
        lambda **d: kvt.transitive_closure(np.zeros((3, 3), bool), **d),
        lambda **d: kvt.policy_pair_masks(enc, **d),
        lambda **d: host.closure(**d),
    ]
    for call in calls:
        with pytest.raises(BackendError, match="no CUDA device"):
            call()
        call(device="cpu")
    with pytest.raises(BackendError, match="no CUDA device"):
        kvt.verify_kano(containers, policies)
    with pytest.raises(BackendError, match="no CUDA device"):
        kvt.verify(cluster, kvt.VerifyConfig(compute_ports=False, closure=True))
    cpu = kvt.VerifyConfig(backend_options=(("device", "cpu"),), closure=True)
    assert kvt.verify_kano(containers, policies, cpu).closure.shape == (8, 8)


def test_importing_the_port_loads_no_yaml():
    """The card's machine has no PyYAML: importing the package and every
    module of this slice (ingest and persist included, which import PyYAML
    only inside the functions that read or write YAML) loads neither JAX
    nor ``yaml``."""
    code = (
        "import sys, kubernetes_verification_tpu_torch as k; "
        "import kubernetes_verification_tpu_torch.backends.cpu, "
        "kubernetes_verification_tpu_torch.backends.device, "
        "kubernetes_verification_tpu_torch.incremental, "
        "kubernetes_verification_tpu_torch.ops.batched, "
        "kubernetes_verification_tpu_torch.ops.device_state, "
        "kubernetes_verification_tpu_torch.ops.posture, "
        "kubernetes_verification_tpu_torch.models.fixtures, "
        "kubernetes_verification_tpu_torch.ingest, "
        "kubernetes_verification_tpu_torch.utils.persist; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('yaml', '_yaml', 'jax', 'jaxlib', 'kubernetes_verification_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dense_engine_posture_and_checkpoints_refuse_the_cpu_without_a_gpu(
    monkeypatch, tmp_path
):
    """The dense engine, the checkpoint loaders and the posture ops on host
    words default to ``cuda`` too: they raise without a GPU and run on the
    CPU when asked (a ``device="cpu"`` or CPU tensors). The CPU oracle is
    host NumPy and needs no device."""
    import numpy as np

    from kubernetes_verification_tpu_torch.ops import posture
    from kubernetes_verification_tpu_torch.utils import persist

    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=4, n_pods=20, n_policies=4))
    any_port = kvt.VerifyConfig(compute_ports=False)
    persist.save_incremental(
        kvt.IncrementalVerifier(cluster, any_port, device="cpu"), str(tmp_path / "d"))
    persist.save_packed_incremental(
        kvt.PackedIncrementalVerifier(cluster, any_port, device="cpu"), str(tmp_path / "p"))
    persist.save_ports_incremental(
        kvt.PackedPortsIncrementalVerifier(cluster, device="cpu"), str(tmp_path / "q"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    words = np.zeros((32, 1), np.uint32)
    calls = [
        lambda **d: kvt.IncrementalVerifier(cluster, **d),
        lambda **d: persist.load_incremental(str(tmp_path / "d"), **d),
        lambda **d: persist.load_packed_incremental(str(tmp_path / "p"), **d),
        lambda **d: persist.load_ports_incremental(str(tmp_path / "q"), **d),
    ]
    for call in calls:
        with pytest.raises(BackendError, match="no CUDA device"):
            call()
        call(device="cpu")
    for op in (lambda w: posture.packed_xor_popcount(w, w),
               posture.packed_row_popcount,
               lambda w: posture.ns_pair_counts(w, words[:1, :1].T, np.zeros(32, int), 1)):
        with pytest.raises(BackendError, match="no CUDA device"):
            op(words)
        op(torch.zeros((32, 1), dtype=torch.int32))
    assert kvt.verify(cluster, kvt.VerifyConfig(backend="cpu")).reach.shape == (20, 20)


def test_serving_plane_refuses_the_cpu_without_a_gpu(monkeypatch, tmp_path):
    """``VerificationService(cluster)``, ``VerificationService.from_snapshot``
    and ``RecoveryManager.recover`` default to ``cuda`` too: they raise
    without a GPU and run on the CPU when asked."""
    from kubernetes_verification_tpu_torch.serve import (
        CheckpointManager,
        RecoveryManager,
        VerificationService,
    )

    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=5, n_pods=20, n_policies=4))
    svc = VerificationService(cluster, device="cpu")
    svc.snapshot(str(tmp_path / "snap"))
    CheckpointManager(str(tmp_path / "ck"), fsync=False).checkpoint(svc.engine)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda **d: VerificationService(cluster, **d),
        lambda **d: VerificationService.from_snapshot(str(tmp_path / "snap"), **d),
        lambda **d: RecoveryManager(str(tmp_path / "ck")).recover(**d),
        lambda **d: RecoveryManager(str(tmp_path / "empty")).recover(
            initial_cluster=cluster, **d),
    ]
    for call in calls:
        with pytest.raises(BackendError, match="no CUDA device"):
            call()
        call(device="cpu")


def test_replicas_stripes_and_the_wrapper_refuse_the_cpu_without_a_gpu(
    monkeypatch, tmp_path
):
    """``FollowerService`` (on a shared directory and bootstrapped over HTTP
    through ``bootstrap_from_leader``), ``StripeEngine``, ``StripeFollower``,
    the stripe loaders and ``resilient_verify`` default to ``cuda`` too: they
    raise without a GPU and run on the CPU when asked."""
    from kubernetes_verification_tpu_torch.resilience.errors import BackendChainExhausted
    from kubernetes_verification_tpu_torch.resilience.wrapper import resilient_verify
    from kubernetes_verification_tpu_torch.serve import (
        CheckpointManager,
        FollowerService,
        RecoveryManager,
        ReplicationServer,
        StripeEngine,
        StripeFollower,
        VerificationService,
        WalWriter,
    )
    from kubernetes_verification_tpu_torch.utils import persist

    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=6, n_pods=20, n_policies=4))
    any_port = kvt.VerifyConfig(compute_ports=False)
    svc = VerificationService(cluster, any_port, device="cpu")
    log = str(tmp_path / "events.jsonl")
    WalWriter(log, fsync=False).close()
    CheckpointManager(str(tmp_path / "ck"), fsync=False).checkpoint(svc.engine, log_path=log)
    stripe = StripeFollower(cluster, any_port, stripe=(1, 2), device="cpu")
    stripe.checkpoint(CheckpointManager(str(tmp_path / "sck"), fsync=False))
    persist.save_stripe_incremental(stripe.engine, str(tmp_path / "s"))
    server = ReplicationServer(str(tmp_path / "ck"), log, port=0)
    server.start()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    n = iter(range(100))
    calls = [
        lambda **d: FollowerService(str(tmp_path / "ck"), log_path=log, **d),
        lambda **d: FollowerService(str(tmp_path / f"net{next(n)}"), leader_url=server.url,
                                    transport_timeout=5.0, **d),
        lambda **d: StripeEngine(cluster, any_port, stripe=(0, 2), **d),
        lambda **d: StripeFollower(cluster, any_port, stripe=(0, 2), **d),
        lambda **d: persist.load_stripe_incremental(str(tmp_path / "s"), (1, 2), **d),
        lambda **d: RecoveryManager(str(tmp_path / "sck")).recover_stripe((1, 2), **d),
    ]
    try:
        for call in calls:
            with pytest.raises(BackendError, match="no CUDA device"):
                call()
            call(device="cpu")
    finally:
        server.close()
    with pytest.raises(BackendChainExhausted, match="no CUDA device"):
        resilient_verify(cluster, any_port)
    host = kvt.VerifyConfig(compute_ports=False, backend_options=(("device", "cpu"),))
    assert resilient_verify(cluster, host).reach.shape == (20, 20)


def test_importing_the_serving_plane_loads_no_yaml_and_no_jax():
    code = (
        "import sys, kubernetes_verification_tpu_torch.serve, "
        "kubernetes_verification_tpu_torch.serve.stripes, "
        "kubernetes_verification_tpu_torch.serve.transport, "
        "kubernetes_verification_tpu_torch.serve.ingress, "
        "kubernetes_verification_tpu_torch.serve.autoscale, "
        "kubernetes_verification_tpu_torch.parallel, "
        "kubernetes_verification_tpu_torch.resilience.wrapper, "
        "kubernetes_verification_tpu_torch.observe.fleet, "
        "kubernetes_verification_tpu_torch.observe.progress, "
        "kubernetes_verification_tpu_torch.observe, "
        "kubernetes_verification_tpu_torch.resilience.faults, "
        "kubernetes_verification_tpu_torch.resilience.breaker; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('yaml', '_yaml', 'jax', 'jaxlib', 'kubernetes_verification_tpu')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
