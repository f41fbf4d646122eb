"""Guards of the PyTorch port: it never imports JAX nor the JAX package, and
its entry points refuse to fall back to the CPU when no GPU is present."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import kubernetes_verification_tpu_torch as kvt
from kubernetes_verification_tpu_torch.resilience.errors import BackendError, ConfigError

#: the port's backends: the JAX package's with ``torch`` for ``tpu``, and
#: ``native`` only where a C++ compiler can build the bitset engine
_BACKENDS = sorted(["cpu", "datalog", "sharded", "sharded-packed", "torch"]
                   + (["native"] if shutil.which("g++") else []))

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


def test_sharded_paths_refuse_the_cpu_without_a_gpu(monkeypatch):
    """Both sharded backends, ``mesh_for`` and ``init_distributed`` default
    to ``cuda:<local rank>``: without a GPU they raise before joining any
    process group."""
    import torch.distributed as dist

    from kubernetes_verification_tpu_torch.parallel.mesh import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cluster = kvt.random_cluster(kvt.GeneratorConfig(seed=7, n_pods=20, n_policies=4))
    for backend in ("sharded", "sharded-packed"):
        with pytest.raises(BackendError, match="no CUDA device"):
            kvt.verify(cluster, kvt.VerifyConfig(backend=backend))
    containers, policies = kvt.random_kano(8, 3, seed=1)
    with pytest.raises(BackendError, match="no CUDA device"):
        kvt.verify_kano(containers, policies, kvt.VerifyConfig(backend="sharded"))
    for call in (kvt.mesh_for, lambda: kvt.mesh_for((1, 1)), init_distributed,
                 lambda: kvt.mesh_for(device="cuda")):
        with pytest.raises(BackendError, match="no CUDA device"):
            call()
    assert not dist.is_initialized()
    assert {"sharded", "sharded-packed"} <= set(kvt.available_backends())
    assert kvt.available_backends() == _BACKENDS


def test_a_mesh_that_is_not_the_world_raises():
    """``mesh_for`` never shrinks a mesh to the world: (4, 2) in a 1-rank
    job is a ``ConfigError``, refused before joining any process group. In
    a fresh process (process groups are per process), a 1-rank gloo job
    runs both sharded backends on the CPU and equals the ``torch``
    backend."""
    import torch.distributed as dist

    with pytest.raises(ConfigError, match=r"mesh shape \(4, 2\) != 1 ranks"):
        kvt.mesh_for((4, 2), device="cpu")
    with pytest.raises(ConfigError, match=r"mesh shape \(2, 1\) != 1 ranks"):
        kvt.mesh_for(2, device="cpu")
    assert not dist.is_initialized()
    code = (
        "import numpy as np, torch.distributed as dist, kubernetes_verification_tpu_torch as k\n"
        "from kubernetes_verification_tpu_torch.resilience.errors import ConfigError\n"
        "c = k.random_cluster(k.GeneratorConfig(seed=8, n_pods=30, n_policies=6))\n"
        "cpu = (('device', 'cpu'),)\n"
        "want = k.verify(c, k.VerifyConfig(backend_options=cpu)).reach\n"
        "for b in ('sharded', 'sharded-packed'):\n"
        "    got = k.verify(c, k.VerifyConfig(backend=b, backend_options=cpu)).reach\n"
        "    assert np.array_equal(got, want), b\n"
        "m = k.mesh_for(device='cpu')\n"
        "assert dist.get_world_size() == 1 and dict(m.shape) == {'pods': 1, 'grants': 1}\n"
        "assert m is k.mesh_for((1, 1), device='cpu') is k.distributed_mesh(device='cpu')\n"
        "try:\n"
        "    k.mesh_for((4, 2), device='cpu')\n"
        "    raise SystemExit('no refusal')\n"
        "except ConfigError:\n"
        "    pass\n"
        "dist.destroy_process_group()\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout + proc.stderr


def test_top_level_namespace_covers_the_jax_package():
    """The port's ``__all__`` holds every name of the JAX package's (no
    module behind one of them is still queued in ROADMAP §1), and each
    resolves: the resilience drivers through the lazy module hook."""
    import kubernetes_verification_tpu as jkv

    assert set(jkv.__all__) - set(kvt.__all__) == set()
    for name in kvt.__all__:
        assert getattr(kvt, name) is not None, name
    assert kvt.__version__ == jkv.__version__
    assert kvt.ConfigError is ConfigError and kvt.BackendError is BackendError
    from kubernetes_verification_tpu_torch.resilience import wrapper

    assert kvt.resilient_verify is wrapper.resilient_verify
    with pytest.raises(AttributeError):
        kvt.no_such_name  # noqa: B018
    # and the observe layer's: every name of the JAX package's observe.__all__
    import kubernetes_verification_tpu.observe as jobs

    from kubernetes_verification_tpu_torch import observe

    assert set(jobs.__all__) - set(observe.__all__) == set()
    for name in observe.__all__:
        assert getattr(observe, name) is not None, name


def test_scan_covers_the_native_and_observe_modules():
    """The AST scan reaches every new module of the port, the C++ engine's
    binding included; the engine's source is the JAX package's byte for
    byte, read here and never imported by the port."""
    rel = {os.path.relpath(p, _PKG) for p in _port_files()}
    for name in ("native/__init__.py", "native/binding.py", "backends/native.py",
                 "observe/aot.py", "observe/jit.py", "observe/sentinel.py",
                 "observe/introspect.py", "observe/telemetry.py", "observe/history.py",
                 "utils/observe.py"):
        assert name in rel, name
    jax_src = os.path.join(_ROOT, "kubernetes_verification_tpu", "native", "bitset.cpp")
    with open(jax_src, "rb") as a, open(os.path.join(_PKG, "native", "bitset.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_observe_tooling_refuses_the_cpu_without_a_gpu(monkeypatch):
    """The sentinel suite runs on the card unless the caller passes
    ``device="cpu"``: without a GPU it raises and never calibrates on the
    CPU in its place; a sample of the memory telemetry never initialises
    CUDA."""
    from kubernetes_verification_tpu_torch.observe import sentinel, telemetry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (sentinel.run_calibration, sentinel.SentinelSuite,
                 sentinel.default_suite, lambda: sentinel.run_calibration("cuda")):
        with pytest.raises(BackendError, match="no CUDA device"):
            call()
    was = torch.cuda.is_initialized()
    telemetry.sample_once()
    assert torch.cuda.is_initialized() == was


# ------------------------------------------------------------ namespaces

#: names of a JAX module's ``__all__`` that its port counterpart does not
#: export, each with its reason
_JAX_ONLY = {
    "kubernetes_verification_tpu.parallel.mesh": {
        "shard_map": "a JAX primitive; the port's sharded bodies are per-rank "
        "torch code over the named collectives of parallel/mesh.py",
    },
}
#: JAX modules whose counterpart has another name, with the renamed exports
_REPLACED = {
    "kubernetes_verification_tpu.ops.pallas_kernels": (
        "kubernetes_verification_tpu_torch.ops.kernels",
        {"fused_ports_stripe": "fused_ports_reach"},
    ),
    "kubernetes_verification_tpu.backends.tpu": (
        "kubernetes_verification_tpu_torch.backends.device",
        {"TpuBackend": "TorchBackend"},
    ),
}
_JAX_PKG = os.path.join(_ROOT, "kubernetes_verification_tpu")


def _jax_modules_with_all():
    """Every JAX module whose top level assigns ``__all__`` (read from its
    source, not imported)."""
    out = []
    for dirpath, dirnames, names in os.walk(_JAX_PKG):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith(("_", ".")))
        for n in sorted(names):
            if not n.endswith(".py"):
                continue
            path = os.path.join(dirpath, n)
            tree = ast.parse(open(path, encoding="utf-8").read())
            if any(isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "__all__" for t in node.targets)
                   for node in tree.body):
                rel = os.path.relpath(path, _ROOT)[:-3].split(os.sep)
                if rel[-1] == "__init__":
                    rel = rel[:-1]
                out.append(".".join(rel))
    return sorted(out)


def _counterpart(jax_name):
    if jax_name in _REPLACED:
        return _REPLACED[jax_name][0]
    port = "kubernetes_verification_tpu_torch" + jax_name[len("kubernetes_verification_tpu"):]
    rel = port.split(".")[1:]
    base = os.path.join(_PKG, *rel)
    return port if (os.path.isdir(base) or os.path.exists(base + ".py")) else None


_WITH_PORT = [m for m in _jax_modules_with_all() if _counterpart(m)]


def test_every_jax_namespace_has_a_counterpart_or_is_queued():
    """Every JAX module with an ``__all__`` has a port counterpart (the
    last ones, under ``analysis/``, are ported too): nothing is queued."""
    missing = [m for m in _jax_modules_with_all() if not _counterpart(m)]
    assert missing == []
    assert len(_WITH_PORT) >= 78


@pytest.mark.parametrize("jax_name", _WITH_PORT)
def test_module_namespace_covers_the_jax_module(jax_name):
    """The port module's ``__all__`` holds every name of the JAX module's,
    less the named JAX-only ones (and under the names of a replaced
    module), and each resolves."""
    import importlib

    jmod = importlib.import_module(jax_name)
    pmod = importlib.import_module(_counterpart(jax_name))
    renames = _REPLACED.get(jax_name, (None, {}))[1]
    want = {renames.get(n, n) for n in jmod.__all__} - set(_JAX_ONLY.get(jax_name, {}))
    assert want - set(pmod.__all__) == set()
    for name in pmod.__all__:
        assert getattr(pmod, name) is not None, name
    for name in _JAX_ONLY.get(jax_name, {}):
        assert name in jmod.__all__ and not hasattr(pmod, name)


# ---------------------------------------------------------------- the CLI


def test_scan_covers_the_cli():
    """The no-JAX scan reaches ``cli.py`` and sees its nested imports: the
    eleven in-function imports of the package resolve to the port."""
    path = os.path.join(_PKG, "cli.py")
    assert path in _port_files()
    roots = list(_imported_roots(path))
    assert roots.count("kubernetes_verification_tpu_torch") == 11
    assert not set(roots) & set(_FORBIDDEN)
    src = open(path, encoding="utf-8").read()
    assert "import jax" not in src and "jax." not in src.replace("jax.profiler", "")


def test_cli_refuses_the_cpu_without_a_gpu(monkeypatch, tmp_path, capsys):
    """Without a GPU and without ``--device cpu`` every subcommand that
    builds tensors exits 3 with the device error, before it loads or builds
    anything; with ``--device cpu`` it runs."""
    from kubernetes_verification_tpu_torch import cli
    from kubernetes_verification_tpu_torch.resilience.errors import EXIT_BACKEND_FAILED
    from kubernetes_verification_tpu_torch.serve import VerificationService

    d = str(tmp_path / "c")
    ck = str(tmp_path / "ck")
    assert cli.main(["generate", d, "--pods", "12", "--policies", "3"]) == 0
    assert cli.main(["snapshot", d, ck, "--no-ports", "--device", "cpu"]) == 0
    snap = str(tmp_path / "snap")
    assert cli.main(["serve", d, "--snapshot-out", snap, "--device", "cpu"]) == 0
    refs = kvt.load_cluster(d)[0].pods
    a = f"{refs[0].namespace}/{refs[0].name}"
    argvs = [
        ["verify", d, "--json"],
        ["verify", d, "--backend", "cpu"],
        ["snapshot", d, str(tmp_path / "new-ck")],
        ["diff", ck, "--json"],
        ["explain", "--pods", "12"],
        ["serve", d],
        ["serve", "--from-snapshot", snap],
        ["serve", d, "--resume", "--checkpoint-dir", str(tmp_path / "sv")],
        ["serve", d, "--stripe", "1/2"],
        ["serve", "--follow", ck],
        ["warmup", d, "--out", str(tmp_path / "pack")],
        ["query", d, "--who-can-reach", a],
        ["query", "--from-snapshot", snap, "--who-can-reach", a],
        ["lb", "--replica", ck, "--batch", str(tmp_path / "b.jsonl")],
    ]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def built(*a, **k):
        raise AssertionError("built on the CPU")

    monkeypatch.setattr(kvt, "load_cluster", built)
    monkeypatch.setattr(kvt, "PackedIncrementalVerifier", built)
    monkeypatch.setattr(VerificationService, "from_snapshot", built)
    before = sorted(os.listdir(tmp_path))
    for argv in argvs:
        capsys.readouterr()
        assert cli.main(argv) == EXIT_BACKEND_FAILED, argv
        err = capsys.readouterr().err
        assert "BackendError: no CUDA device" in err, (argv, err)
    assert sorted(os.listdir(tmp_path)) == before
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["verify", d, "--json", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["backend"] == "torch"


# ------------------------------------------------------ the bench entry point


def test_scan_covers_the_bench():
    """The no-JAX scan reaches the port's ``bench.py``: it reaches the port
    through relative imports only, and imports nothing of JAX, of the JAX
    package or of the repo's JAX bench ``bench.py``."""
    path = os.path.join(_PKG, "bench.py")
    assert path in _port_files()
    roots = list(_imported_roots(path))
    assert not set(roots) & set(_FORBIDDEN)
    assert "bench" not in roots and "importlib" not in roots
    tree = ast.parse(open(path, encoding="utf-8").read())
    relative = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.level]
    assert len(relative) >= 40
    src = open(path, encoding="utf-8").read()
    assert "import jax" not in src and "jax." not in src


def _jax_bench_modes():
    tree = ast.parse(open(os.path.join(_ROOT, "bench.py"), encoding="utf-8").read())
    call = next(
        n for n in ast.walk(tree)
        if isinstance(n, ast.Call) and getattr(n.func, "attr", None) == "add_argument"
        and n.args and getattr(n.args[0], "value", None) == "--mode"
    )
    choices = next(k.value for k in call.keywords if k.arg == "choices")
    return {e.value for e in choices.elts}


def test_bench_modes_match_the_jax_bench():
    """The port's ``--mode`` choices are ``bench.py``'s, each with a mode
    function, and the console script is registered."""
    from kubernetes_verification_tpu_torch import bench

    want = _jax_bench_modes()
    assert len(want) == 14
    assert set(bench.MODES) == want == set(bench._MODE_FNS)
    action = next(a for a in bench.build_parser()._actions if "--mode" in a.option_strings)
    assert set(action.choices) == want
    toml = open(os.path.join(_ROOT, "pyproject.toml"), encoding="utf-8").read()
    assert 'kv-tpu-torch-bench = "kubernetes_verification_tpu_torch.bench:main"' in toml


def test_bench_refuses_the_cpu_without_a_gpu(monkeypatch, capsys):
    """Without a GPU and without ``--device cpu`` every mode exits 3 with
    the device error before it calibrates or generates anything."""
    from kubernetes_verification_tpu_torch import bench
    from kubernetes_verification_tpu_torch.harness import generate
    from kubernetes_verification_tpu_torch.resilience.errors import EXIT_BACKEND_FAILED

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def made(*a, **k):
        raise AssertionError("made something on the CPU")

    for name in ("random_cluster", "random_kano", "random_event_stream"):
        monkeypatch.setattr(generate, name, made)
    monkeypatch.setattr(bench, "_calibrate", made)
    monkeypatch.setattr(bench, "_DEVICE", None)
    for mode in bench.MODES:
        assert bench.main(["--mode", mode]) == EXIT_BACKEND_FAILED, mode
        captured = capsys.readouterr()
        assert "BackendError: no CUDA device" in captured.err, mode
        assert captured.out == ""
    assert bench._DEVICE is None and bench._BENCH_MODE is None


def test_bench_console_entry_refuses_the_cpu_without_a_gpu(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               KVTPU_BENCH_HISTORY=str(tmp_path / "h.jsonl"))
    proc = subprocess.run(
        [sys.executable, "-m", "kubernetes_verification_tpu_torch.bench", "--mode", "tiled"],
        cwd=_ROOT, capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 3, proc.stderr
    assert proc.stdout == "" and "BackendError: no CUDA device" in proc.stderr
    assert not (tmp_path / "h.jsonl").exists()
