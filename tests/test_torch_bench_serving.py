"""The port's benchmark entry point against the repo's JAX bench, modes 6–11:
``stripe``, ``stripes``, ``serve``, ``posture``, ``query``, ``ingress`` and
``replicate`` (with ``--net``), as ``tests/test_torch_bench.py`` does modes
0–5.

Four JAX modes do not run here, and their records are read from
``bench.py``'s source instead (``jax_emits``: the keys of each ``_emit``
call, by line): ``posture`` fails its own 5% apply-path budget on the CPU
at this size, ``ingress`` and ``replicate`` (with and without ``--net``)
hold fixed-length windows and spawn follower processes, beyond a case's
time here. The port's ``posture`` and ``ingress`` run with their timing
gates (``bench.GATES``) opened: the CPU's timings at this size say
nothing of the card's, and the records' shape is what is compared."""
import pytest

from kubernetes_verification_tpu_torch import bench as port_bench

from torch_bench_parity import (  # noqa: F401  (the autouse fixture)
    TINY,
    check_history,
    compare,
    compare_by_line,
    fresh_bench_state,
    jax_emits,
    run_jax,
    run_port,
)

EVENTS = ["--n-events", "256"]
QUERIES = ["--n-queries", "1024"]

#: (case id, argv) of the modes both benches run here
CASES = [
    ("stripe", ["--mode", "stripe", "--pods", "2000", "--policies", "32",
                "--repeats", "2", "--stripe-width", "512"]),
    ("stripes", ["--mode", "stripes", *TINY, *EVENTS, *QUERIES]),
    ("serve", ["--mode", "serve", *TINY, *EVENTS]),
    ("query", ["--mode", "query", *TINY, *QUERIES]),
]

#: (case id, argv, the JAX functions whose _emit calls it is held to)
BY_LINE = [
    ("posture", ["--mode", "posture", *TINY, *EVENTS], "bench_posture"),
    ("ingress", ["--mode", "ingress", *TINY], "bench_ingress"),
    ("replicate", ["--mode", "replicate", *TINY, "--n-events", "128", *QUERIES],
     "bench_replicate"),
    ("replicate-net", ["--mode", "replicate", "--net", *TINY, "--n-events", "128",
                       *QUERIES], "_bench_replicate_net"),
]


@pytest.mark.parametrize("argv", [c[1] for c in CASES], ids=[c[0] for c in CASES])
def test_mode_matches_the_jax_bench(argv, monkeypatch, tmp_path):
    want, _ = run_jax(argv, monkeypatch, str(tmp_path / "jax.jsonl"))
    hist = str(tmp_path / "port.jsonl")
    got, _ = run_port(argv, monkeypatch, hist)
    assert want and got
    compare(want, got)
    check_history(hist, len(got))


@pytest.mark.parametrize(
    "argv,func", [c[1:] for c in BY_LINE], ids=[c[0] for c in BY_LINE]
)
def test_mode_matches_the_jax_bench_emits(argv, func, monkeypatch, tmp_path):
    monkeypatch.setitem(port_bench.GATES, "posture_overhead_pct", float("inf"))
    monkeypatch.setitem(port_bench.GATES, "ingress_post_knee_held", 0.0)
    monkeypatch.setitem(port_bench.GATES, "ingress_deadline_violations", float("inf"))
    hist = str(tmp_path / "port.jsonl")
    got, _ = run_port(argv, monkeypatch, hist)
    compare_by_line(jax_emits(func), got)
    check_history(hist, len(got))


def test_the_gates_match_the_jax_bench():
    """The inline literals of ``bench_posture`` / ``bench_ingress``."""
    assert port_bench.GATES == {
        "posture_overhead_pct": 5.0,
        "ingress_post_knee_held": 0.8,
        "ingress_deadline_violations": 0,
    }


def test_posture_gate_fails_the_run(monkeypatch, tmp_path):
    """Over its budget, ``posture`` raises and emits nothing."""
    monkeypatch.setitem(port_bench.GATES, "posture_overhead_pct", -1.0)
    with pytest.raises(AssertionError, match="apply-path budget"):
        run_port(["--mode", "posture", *TINY, *EVENTS], monkeypatch,
                 str(tmp_path / "h.jsonl"))
    assert not (tmp_path / "h.jsonl").exists()
