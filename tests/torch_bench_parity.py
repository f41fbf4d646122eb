"""Shared helpers of the benchmark parity tests
(``tests/test_torch_bench*.py``): one mode through the repo's JAX bench
``bench.py`` (loaded with ``importlib``, run in process on the CPU that
``tests/conftest.py`` pins) and through the port's
``kubernetes_verification_tpu_torch.bench`` with ``--device cpu``, each
writing its history under the test's ``tmp_path``, and the two sets of
records compared: metric names in order, units, key sets, the exact
fields, and the timing fields' signs.

Recorded differences: the port's records carry ``kernel_builds`` beside the
warm split's fields; ``headtohead`` names its variants ``torch`` /
``kernel`` (the JAX bench's ``xla`` / ``pallas``) in its metric and its
unit is ``kernel_vs_torch_median_pct``. Where a JAX mode cannot run here
(its timing gate or its wall), ``jax_emits`` reads the keys of each of its
``_emit`` calls from ``bench.py``'s source instead.
"""
from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
import os
import re
import sys
from typing import Dict, List, Optional, Tuple

import pytest

from kubernetes_verification_tpu_torch import bench as port_bench
from kubernetes_verification_tpu_torch.observe import introspect as port_introspect

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(ROOT, "bench.py")

#: the sizes both benches run at here (stripe needs a 2,000-pod base)
TINY = ["--pods", "256", "--policies", "32", "--repeats", "2"]

#: the port's additions to a record's keys
PORT_ONLY_KEYS = frozenset({"kernel_builds"})

#: every record's exact fields, where a record carries them
EXACT = (
    "pods", "policies", "macs", "macs_basis", "events", "generations",
    "events_applied", "events_coalesced", "solves", "events_per_solve",
    "iterations", "full_passes", "resumed_passes", "adds_diff_real",
    "stripes", "fanout_applies", "whole_state_bytes", "stripe_state_bytes_max",
    "state_fraction", "samples", "loop", "warm_parity", "macs_per_run", "threads", "replicas", "deadline_s", "query_h2d_bytes",
)

_TIMING = re.compile(r"(^|_)(s|ms|us)$|_band$|^band$|^bands$")

_jax_bench = None


def jax_bench():
    """The repo's ``bench.py`` as a module (loaded once)."""
    global _jax_bench
    if _jax_bench is None:
        spec = importlib.util.spec_from_file_location("kvt_jax_bench", JAX_BENCH)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _jax_bench = mod
    return _jax_bench


def reset_state() -> None:
    """Both benches' process globals and the introspection switches, as a
    fresh process has them."""
    for mod in (port_bench, _jax_bench):
        if mod is not None:
            mod._BENCH_MODE = None
            mod._SENTINEL_CTX = None
    port_bench._DEVICE = None
    port_introspect._enabled = None
    port_introspect.clear_reports()
    if _jax_bench is not None:
        from kubernetes_verification_tpu.observe import introspect as jax_introspect

        jax_introspect._enabled = None
        jax_introspect.clear_reports()


@pytest.fixture(autouse=True)
def fresh_bench_state():
    reset_state()
    yield
    reset_state()


def _records(out: str) -> List[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def run_jax(argv, monkeypatch, hist: str, sentinel: bool = False):
    """``bench.py``'s ``main()`` in process: (records, stderr)."""
    mod = jax_bench()
    monkeypatch.setenv("KVTPU_BENCH_HISTORY", hist)
    if not sentinel:
        monkeypatch.setenv("KVTPU_BENCH_NO_SENTINEL", "1")
    monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        mod.main()
    return _records(out.getvalue()), err.getvalue()


def run_port(argv, monkeypatch, hist: str, sentinel: bool = False):
    """The port's bench with ``--device cpu``: (records, stderr)."""
    monkeypatch.setenv("KVTPU_BENCH_HISTORY", hist)
    if not sentinel:
        monkeypatch.setenv("KVTPU_BENCH_NO_SENTINEL", "1")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_bench.main([*argv, "--device", "cpu"])
    assert rc == 0, err.getvalue()[-3000:]
    return _records(out.getvalue()), err.getvalue()


def port_metric(metric: str, unit: str) -> Tuple[str, str]:
    """A JAX record's (metric, unit) under the port's names."""
    if unit == "pallas_vs_xla_median_pct":
        return metric.replace("(xla vs pallas)", "(torch vs kernel)"), (
            "kernel_vs_torch_median_pct"
        )
    return metric, unit


def keys(rec: dict) -> set:
    return set(rec) - {"metrics", "cost"}


def check_timings(rec: dict) -> None:
    """Every duration field present is a non-negative number, and every
    band is ordered."""
    for k, v in rec.items():
        if k in ("sentinel", "metrics", "cost") or not _TIMING.search(k):
            continue
        if isinstance(v, dict):
            bands = v.values() if k == "bands" else [v]
            for b in bands:
                if isinstance(b, dict) and "median_s" in b:
                    assert 0 <= b["min_s"] <= b["median_s"] <= b["max_s"], (k, b)
                elif isinstance(b, dict):
                    assert all(x >= 0 for x in b.values()), (k, b)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            assert v >= 0, (k, v)


def compare(jax_recs: List[dict], port_recs: List[dict]) -> None:
    """Metric names in order, units, key sets and exact fields equal."""
    assert [port_metric(r["metric"], r["unit"]) for r in jax_recs] == [
        (r["metric"], r["unit"]) for r in port_recs
    ]
    for j, p in zip(jax_recs, port_recs):
        assert keys(j) == keys(p) - PORT_ONLY_KEYS, (
            p["metric"], keys(j) ^ (keys(p) - PORT_ONLY_KEYS))
        for k in EXACT:
            if k in j:
                assert j[k] == p[k], (p["metric"], k, j[k], p[k])
        if "compile_cold_s" in p:
            assert p["kernel_builds"] == 0  # nothing is built on the CPU
        check_timings(j)
        check_timings(p)
        if "warm_parity" in p:
            assert p["warm_parity"] is True


def reachable_pairs(err: str) -> List[int]:
    """The ``N reachable pairs`` a bench's log reports."""
    return [int(m) for m in re.findall(r"(\d+) reachable pairs", err)]


def check_history(hist: str, n_records: int) -> None:
    """The port's history file parses (``observe/history.py``) and the
    port's regression gate runs over it (``--dry-run``)."""
    from kubernetes_verification_tpu_torch.analysis import bench_gate
    from kubernetes_verification_tpu_torch.observe.history import load_runs

    runs = load_runs([hist])
    assert len(runs) == n_records
    assert all(r["device"] == "cpu" and r["platform"] == "cpu" for r in runs)
    with contextlib.redirect_stdout(io.StringIO()):
        assert bench_gate.main([hist, "--dry-run"]) == 0


# ------------------------------------------------- the JAX bench's source
def _template(node) -> Optional[str]:
    """A metric expression as a regular expression: constants literal,
    formatted values any text."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return re.escape(node.value)
    if isinstance(node, ast.JoinedStr):
        return "".join(
            re.escape(v.value) if isinstance(v, ast.Constant) else ".+"
            for v in node.values
        )
    return None


def _dict_keys(node: ast.Dict, named: Dict[str, ast.Dict]) -> Tuple[set, dict]:
    out, consts = set(), {}
    for k, v in zip(node.keys, node.values):
        if k is None:  # ** expansion of a dict literal bound in the function
            assert isinstance(v, ast.Name) and v.id in named, ast.dump(v)
            more, _ = _dict_keys(named[v.id], named)
            out |= more
        else:
            out.add(k.value)
            consts[k.value] = v
    return out, consts


def jax_emits(func: str) -> List[dict]:
    """Each ``_emit({...})`` call of ``bench.py``'s ``func``, in source
    order: its line, metric (as a regular expression), unit and keys (with
    the context block ``_context_fields`` adds on the CPU)."""
    tree = ast.parse(open(JAX_BENCH, encoding="utf-8").read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    named = {
        t.id: node.value
        for node in ast.walk(fn) if isinstance(node, ast.Assign)
        and isinstance(node.value, ast.Dict)
        for t in node.targets if isinstance(t, ast.Name)
    }
    calls = sorted(
        (n for n in ast.walk(fn) if isinstance(n, ast.Call)
         and getattr(n.func, "id", None) == "_emit"),
        key=lambda n: n.lineno,
    )
    out = []
    for call in calls:
        keys_, consts = _dict_keys(call.args[0], named)
        out.append({
            "line": call.lineno,
            "metric": _template(consts["metric"]),
            "unit": consts["unit"].value,
            "keys": keys_ | {"mode", "device", "platform"},
        })
    return out


def compare_by_line(emits: List[dict], port_recs: List[dict]) -> None:
    """The port's records against the JAX bench's ``_emit`` calls: one
    record per call in order (a call in a loop may repeat), each metric
    matching its template with the same unit and keys."""
    i, matched = 0, set()
    for rec in port_recs:
        while i < len(emits) and not re.fullmatch(emits[i]["metric"], rec["metric"]):
            i += 1
        assert i < len(emits), f"no _emit call of bench.py matches {rec['metric']!r}"
        want = emits[i]
        matched.add(i)
        assert rec["unit"] == want["unit"], (want["line"], rec["unit"])
        assert keys(rec) - PORT_ONLY_KEYS == want["keys"], (
            want["line"], keys(rec) ^ want["keys"])
        check_timings(rec)
    assert matched == set(range(len(emits))), [
        e["line"] for k, e in enumerate(emits) if k not in matched]
