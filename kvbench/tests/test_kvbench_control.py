"""Each cell's control, the reference with one guarantee broken put in the
program's place where its answers are produced, makes a whole run come out
as not correct: at a small size on the CPU, and at the cell's own size on
the card (``pytest -m cuda kvbench``)."""
import time

import pytest

from kvbench.run import run_cell
from kvbench.tests.conftest import SMALL

CELLS = ["k8s-100k-ports.verify", "k8s-100k.verify", "k8s-100k.churn", "k8s-100k-ports.churn"]
SEEDS = [2**31 + 101, 2**31 + 202, 2**31 + 303]


def assert_not_correct(out):
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_a_small_size(bench, cell, seed):
    # the smallest size at which port-disjoint grants show on every seed
    small = {"deployment": {**SMALL["deployment"], "n_pods": 1000, "n_policies": 300},
             "mix": {**SMALL["mix"], "max_steps": 2, "max_changes": 100}}
    # the window outlasts the mix's steps or changes
    assert_not_correct(run_cell(bench, cell, seed, 60.0, False, device="cpu", overrides=small,
                                fault="control"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(bench, cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size")
    for seed in SEEDS:
        assert_not_correct(run_cell(bench, cell, seed, 10.0, False, t0=time.perf_counter(),
                                    fault="control"))
