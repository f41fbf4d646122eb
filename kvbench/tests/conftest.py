"""Small sizes at which the CPU tests drive the benchmark's cells."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a cell's run at a size a test holds: every row checked
SMALL = {"deployment": {"n_pods": 240, "n_policies": 60, "n_namespaces": 4},
         "mix": {"row_stride": 1, "max_changes": 160, "max_steps": 6,
                 "control_changes": 120}}


@pytest.fixture(scope="session")
def bench():
    from kvbench.run import ROOT as root, load_json

    return load_json(root, "BENCHMARK.json")
