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
