"""The port's check scripts (``kubernetes_verification_tpu_torch/scripts/``)
against the root ``scripts/check_*.py`` shims: the same entry points, flags
and exit codes, over the port's gate, lint rules, baseline and metric
registry. Mirrors ``tests/test_introspect.py``'s script tests,
``tests/test_lint.py``'s shim test, ``tests/test_resilience.py``'s lint hook
and ``tests/test_observe.py``'s metric-name hook."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from kubernetes_verification_tpu_torch.analysis import load_baseline
from kubernetes_verification_tpu_torch.analysis.baseline import default_baseline_path
from kubernetes_verification_tpu_torch.observe import METRIC_NAME_RE, REGISTRY
from kubernetes_verification_tpu_torch.observe.history import append_run
from kubernetes_verification_tpu_torch.scripts import (
    check_bench_regression,
    check_error_taxonomy,
    check_metrics_names,
)

REPO = Path(__file__).resolve().parent.parent
SHIMS = ("check_bench_regression", "check_error_taxonomy", "check_metrics_names")


def _load_root_script(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def taxonomy_findings():
    """One lint of the port's package under the three hygiene rules."""
    return check_error_taxonomy.check()


# ------------------------------------------------------- bench regression
def test_check_bench_regression_script_dry_run(capsys):
    """The TPU snapshots named explicitly (the port's default reads none of
    them), as the JAX shim's dry run reads them by default."""
    paths = sorted(str(p) for p in REPO.glob("BENCH_r*.json"))
    assert check_bench_regression.main(paths + ["--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "tolerance" in out
    jax_shim = _load_root_script("check_bench_regression")
    assert jax_shim.main(paths + ["--dry-run"]) == 0
    assert capsys.readouterr().out == out


def test_check_bench_regression_script_flags_synthetic(tmp_path, capsys):
    p = str(tmp_path / "h.jsonl")
    for v in [10.0, 10.5, 9.8, 10.2, 10.1, 5.0]:
        append_run({"metric": "m", "value": v, "unit": "pairs/s"}, p)
    assert check_bench_regression.main([p]) == 1
    assert check_bench_regression.main([p, "--dry-run"]) == 0
    capsys.readouterr()


def test_check_bench_regression_default_reads_the_ports_history(tmp_path, monkeypatch, capsys):
    """With ``KVTPU_BENCH_HISTORY`` naming the port's history the shim
    gates it with no arguments; a regression there exits 1."""
    p = tmp_path / "bench_history.jsonl"
    for v in [10.0, 10.5, 9.8, 10.2, 10.1, 5.0]:
        append_run({"metric": "m", "value": v, "unit": "pairs/s",
                    "device": "NVIDIA H100 80GB HBM3"}, str(p))
    monkeypatch.setenv("KVTPU_BENCH_HISTORY", str(p))
    assert check_bench_regression.main([]) == 1
    out = capsys.readouterr().out
    assert "6 runs from 1 file(s)" in out and "on NVIDIA H100 80GB HBM3" in out


# ------------------------------------------------------------ docs contract
def test_metrics_docs_in_sync():
    assert check_metrics_names.check() == []
    assert check_metrics_names.check_required() == []
    docs = Path(check_metrics_names.DOCS_PATH)
    assert docs == REPO / "kubernetes_verification_tpu_torch" / "METRICS.md"
    assert docs.read_text() == check_metrics_names.docs_markdown(), (
        "kubernetes_verification_tpu_torch/METRICS.md is stale — regenerate with "
        "`python -m kubernetes_verification_tpu_torch.scripts.check_metrics_names "
        "--write kubernetes_verification_tpu_torch/METRICS.md`"
    )
    assert check_metrics_names.main(["--check-docs", str(docs)]) == 0


def test_the_port_registers_the_jax_packages_families(tmp_path, capsys):
    """The families equal the root METRICS.md's; the tables differ only in
    their header and one help string, so ``--check-docs`` of the root file
    fails and names the regenerating command."""
    assert check_metrics_names.families(str(REPO / "METRICS.md")) == ([], [])
    port_rows = check_metrics_names.docs_markdown().split("|---|---|---|---|\n")[1]
    jax_rows = (REPO / "METRICS.md").read_text().split("|---|---|---|---|\n")[1]
    differ = [(a, b) for a, b in zip(port_rows.splitlines(), jax_rows.splitlines()) if a != b]
    assert [a.split("`")[1] for a, _ in differ] == ["kvtpu_profile_captures_total"]
    assert differ[0][0] == differ[0][1].replace("jax.profiler", "torch.profiler")
    assert check_metrics_names.main(["--check-docs", str(REPO / "METRICS.md")]) == 1
    assert "check_metrics_names --write" in capsys.readouterr().err
    out = tmp_path / "METRICS.md"
    assert check_metrics_names.main(["--write", str(out)]) == 0
    assert out.read_text() == check_metrics_names.docs_markdown()
    assert check_metrics_names.main(["--check-docs", str(out)]) == 0


def test_all_registered_names_pass_the_lint():
    assert check_metrics_names.check() == []
    assert all(METRIC_NAME_RE.match(n) for n in REGISTRY.names())


# ------------------------------------------------------------ the lint shim
def test_error_taxonomy_shim_matches_framework(taxonomy_findings):
    assert taxonomy_findings == []
    jax_shim = _load_root_script("check_error_taxonomy")
    assert check_error_taxonomy.DISALLOWED == jax_shim.DISALLOWED
    assert check_error_taxonomy.ALWAYS_ALLOWED == jax_shim.ALWAYS_ALLOWED
    assert check_error_taxonomy.RULES == jax_shim.RULES
    assert "ValueError" in check_error_taxonomy.DISALLOWED
    assert "NotImplementedError" in check_error_taxonomy.ALWAYS_ALLOWED
    assert check_error_taxonomy.GRANDFATHERED  # the port's LINT_BASELINE.json
    baseline = load_baseline(default_baseline_path())
    assert check_error_taxonomy.GRANDFATHERED == baseline["error-taxonomy"]


def test_error_taxonomy_lint_passes(taxonomy_findings, monkeypatch, capsys):
    monkeypatch.setattr(check_error_taxonomy, "check", lambda: taxonomy_findings)
    assert check_error_taxonomy.main() == 0
    assert "error taxonomy lint OK" in capsys.readouterr().out


# --------------------------------------------------------------- python -m
@pytest.mark.parametrize("name,argv,rc", [
    ("check_bench_regression", ["--dry-run"], 0),
    ("check_metrics_names", [], 0),
])
def test_the_shims_run_with_python_m(name, argv, rc, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "KVTPU_BENCH_HISTORY"}
    proc = subprocess.run(
        [sys.executable, "-m", f"kubernetes_verification_tpu_torch.scripts.{name}", *argv],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=120,
        env={**env, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == rc, proc.stdout + proc.stderr
    assert "jax" not in proc.stdout.lower()


def test_every_root_shim_has_a_port_counterpart():
    for name in SHIMS:
        assert (REPO / "scripts" / f"{name}.py").exists()
        assert (REPO / "kubernetes_verification_tpu_torch" / "scripts" / f"{name}.py").exists()
