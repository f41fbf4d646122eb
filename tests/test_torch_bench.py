"""The port's benchmark entry point (``kubernetes_verification_tpu_torch/bench.py``)
against the repo's JAX bench (``bench.py``), modes 0–5: the shared core,
``sentinel``, ``tiled``, ``headtohead``, ``k8s`` / ``kano``, ``incremental``
and ``closure``. Each case runs the JAX mode in process on the CPU and the
port's with ``--device cpu`` at the same tiny size, and holds the records
equal in metric names, units, keys and exact fields (``tests/
torch_bench_parity.py``); the port's history then parses and its gate runs.
The serving modes are in ``tests/test_torch_bench_serving.py``."""
import contextlib
import io
import json

import pytest

from kubernetes_verification_tpu_torch import bench as port_bench
from kubernetes_verification_tpu_torch.resilience.errors import BackendError

from torch_bench_parity import (  # noqa: F401  (the autouse fixture)
    TINY,
    check_history,
    compare,
    fresh_bench_state,
    jax_bench,
    reachable_pairs,
    run_jax,
    run_port,
)

#: (case id, the JAX bench's argv, the port's argv)
CASES = [
    ("sentinel", ["--mode", "sentinel", "--repeats", "2"], None),
    ("tiled", ["--mode", "tiled", *TINY], None),
    ("tiled-no-ports", ["--mode", "tiled", "--no-ports", *TINY], None),
    ("headtohead", ["--mode", "headtohead", "--no-ports", *TINY], None),
    ("k8s", ["--mode", "k8s", *TINY], None),
    ("kano", ["--mode", "kano", *TINY], None),
    ("incremental", ["--mode", "incremental", *TINY], None),
    ("incremental-no-ports", ["--mode", "incremental", "--no-ports", *TINY], None),
    ("closure", ["--mode", "closure", "--closure-tile", "128", *TINY], None),
]


@pytest.mark.parametrize(
    "jax_argv,port_argv", [c[1:] for c in CASES], ids=[c[0] for c in CASES]
)
def test_mode_matches_the_jax_bench(jax_argv, port_argv, monkeypatch, tmp_path):
    sentinel = jax_argv[1] == "sentinel"
    want, jerr = run_jax(jax_argv, monkeypatch, str(tmp_path / "jax.jsonl"), sentinel)
    hist = str(tmp_path / "port.jsonl")
    got, perr = run_port(port_argv or jax_argv, monkeypatch, hist, sentinel)
    assert want and got
    compare(want, got)
    assert reachable_pairs(perr) == reachable_pairs(jerr)
    if jax_argv[1] == "tiled":
        assert reachable_pairs(perr)  # the log carries the solve's pairs
    if sentinel:
        assert all("sentinel" in r for r in got)
    check_history(hist, len(got))


def test_kernel_route_runs_the_kernels_plain_version_on_the_cpu(monkeypatch, tmp_path):
    """``--kernel`` on the CPU takes the hand-written kernel's route through
    its plain version, and the solve's pairs equal the torch sweep's."""
    hist = str(tmp_path / "h.jsonl")
    got, err = run_port(["--mode", "tiled", "--no-ports", "--kernel", *TINY],
                        monkeypatch, hist)
    assert "kernel=packed_dir_allow" in err
    _, sweep = run_port(["--mode", "tiled", "--no-ports", "--no-kernel", *TINY],
                        monkeypatch, hist)
    assert "kernel=torch-sweep" in sweep
    assert reachable_pairs(err) == reachable_pairs(sweep)
    summary = json.loads(err.splitlines()[-1].split(" ", 1)[1])
    assert summary["launches"] == {"packed_dir_allow": 0, "fused_ports_reach": 0}
    assert summary["peak_device_bytes"] is None and summary["nvcc_runs"] == 0


def test_a_solve_off_the_kernel_route_fails_the_run():
    class Res:
        meta = {"kernel": "torch-sweep"}

    with pytest.raises(AssertionError, match="not a hand-written kernel"):
        port_bench._check_kernel(Res(), True)
    port_bench._check_kernel(Res(), False)


def test_the_warm_split_and_the_calibration_raise(monkeypatch):
    """Their failures stay visible: neither sits in a ``try``."""
    def boom():
        raise BackendError("launch failed", backend="torch")

    with pytest.raises(BackendError, match="launch failed"):
        port_bench._warm_compile_split(1.0, rerun=boom)
    from kubernetes_verification_tpu_torch.observe import sentinel

    monkeypatch.delenv("KVTPU_BENCH_NO_SENTINEL", raising=False)
    monkeypatch.setattr(sentinel, "run_calibration", lambda *a, **k: boom())
    with pytest.raises(BackendError, match="launch failed"):
        port_bench._calibrate()


def test_band_matches_the_jax_bench():
    for times in ([0.5], [3.0, 1.0, 2.0], [0.0, 0.0], [1.25, 1.5, 1.0, 4.0]):
        assert port_bench._band(times) == jax_bench()._band(times)


def test_help_lists_the_jax_bench_modes(capsys):
    with pytest.raises(SystemExit):
        port_bench.main(["--help"])
    text = capsys.readouterr().out
    for mode in port_bench.MODES:
        assert mode in text
    assert "--kernel" in text and "--no-kernel" in text and "--pallas" not in text


def test_history_goes_to_the_repo_root_unless_the_variable_says(monkeypatch, tmp_path):
    """``bench_history.jsonl`` beside the repo's root by default;
    ``KVTPU_BENCH_HISTORY`` moves it, and an empty value turns it off."""
    monkeypatch.setattr(port_bench, "_REPO_ROOT", str(tmp_path))
    monkeypatch.setenv("KVTPU_BENCH_NO_SENTINEL", "1")
    argv = ["--mode", "kano", *TINY, "--device", "cpu"]

    def run():
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            assert port_bench.main(argv) == 0

    monkeypatch.setenv("KVTPU_BENCH_HISTORY", "")
    run()
    assert list(tmp_path.iterdir()) == []
    monkeypatch.delenv("KVTPU_BENCH_HISTORY")
    run()
    assert [p.name for p in tmp_path.iterdir()] == ["bench_history.jsonl"]
