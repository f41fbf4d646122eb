"""CPU rehearsal: every cell end to end at a small size on the port's plain
paths, with the harness's look for a card skipped. A sound run is correct;
each fault the cell can have, planted under the timed path, makes it not."""
import pytest

from kvbench import run
from kvbench.tests.conftest import SMALL

CELLS = ["k8s-100k-ports.verify", "k8s-100k.verify", "k8s-100k.churn", "k8s-100k-ports.churn"]


def cell_run(bench, cell, seed=2**31 + 11, trace=False, fault=None, overrides=SMALL,
             seconds=60.0):
    # the window outlasts the mix's steps or changes: a fixed amount of work,
    # however loaded the host
    return run.run_cell(bench, cell, seed, seconds, trace, device="cpu", overrides=overrides,
                        fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(bench, cell):
    out = cell_run(bench, cell)
    assert out["correct"] and out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in run.cell_metrics(bench, cell, trace=False)}
    # the CPU has no device memory to report; every other metric is read
    assert set(out["metrics"]) == names - {"peak_device_gib"}
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_host_layers(bench, cell):
    out = cell_run(bench, cell, trace=True)
    assert out["correct"]
    host = {m["name"] for m in run.cell_metrics(bench, cell, trace=True)
            if m["source"] == "host_clock"}
    assert host and host <= set(out["metrics"])
    assert "breakdown" in out and out["device"]["window_s"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(bench, cell, fault):
    out = cell_run(bench, cell, fault=fault)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_change_the_engine_refuses_counts_as_failed(bench):
    # no free rows: the ports engine refuses the first policy change that
    # needs one, and the run says so instead of working round it
    small = {**SMALL, "engine": {"kwargs": {"headroom": 0}},
             "mix": {**SMALL["mix"], "max_changes": 400}}
    out = cell_run(bench, "k8s-100k-ports.churn", overrides=small)
    assert out["failed"] > 0 and not out["correct"]
