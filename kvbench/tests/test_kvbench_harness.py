"""The harness finds every piece by name, and BENCHMARK.json keeps to the
contract's names, units and shapes."""
import json
import os
import re

import pytest

from kvbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_config_mix_and_loop(bench):
    for w in bench["workloads"]:
        cfg = run.load_json(run.HERE, "configs", f"{w['config']}.json")
        mix = run.load_json(run.HERE, "traffic", f"{w['traffic']}.json")
        assert cfg["name"] == w["config"]
        assert callable(run.loop(mix["loop"]))
        assert w["chips"] == 1


def test_a_split_metric_falls_back_to_the_reader_of_its_first_part(bench):
    assert run.metric_reader("device_idle.verify").__module__ == "kvbench.metrics.device_idle"
    assert run.metric_reader("encode_ms.verify").__module__ == "kvbench.metrics.encode_ms.verify"
    with pytest.raises(FileNotFoundError):
        run.metric_reader("no_such_metric.verify")


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(run.metric_reader(m["name"]))


def test_config_entries_point_at_their_files(bench):
    for c in bench["configs"]:
        assert c["file"] == f"kvbench/configs/{c['name']}.json"
        data = run.load_json(run.ROOT, c["file"])
        assert data["reduced"] == c["reduced"]
        assert data["source"].startswith(c["source"])


def test_names_and_units_use_only_allowed_characters(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in bench["end_to_end"] + bench["per_layer"]}) == len(
        bench["end_to_end"]) + len(bench["per_layer"])
    for text in [c["why"] for c in bench["configs"] + bench["workloads"]] + [
            m["layer"] for m in bench["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(bench)) <= 64 * 1024


def test_shapes_of_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["kvbench"] and bench["command"][:3] == ["python3", "-m", "kvbench.run"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        # a per-layer metric is read only in cells that report what it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        reported = run.cell_metrics(bench, cell, trace=False)
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert run.cell_metrics(bench, cell, trace=True)


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "kubernetes_verification_tpu"])
def test_forbidden_modules_compare_whole_top_level_names(name, monkeypatch):
    import sys
    import types

    assert "kubernetes_verification_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, name + ".sub", types.ModuleType(name + ".sub"))
    assert run.forbidden_modules() == [name]


def test_a_run_without_a_card_fails_and_prints_nothing(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run.main(["--workload", "k8s-100k.verify", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_every_file_of_the_benchmark_is_named_from_name_characters():
    for base, _, files in os.walk(run.HERE):
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), run.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
