"""Nothing of the benchmark imports JAX or the JAX package, top-level names
compared whole; the reference and its helpers import nothing of the
program either."""
import ast
import os

import pytest

from kvbench import run

JAX_SIDE = {"jax", "jaxlib", "flax", "kubernetes_verification_tpu"}
PROGRAM = "kubernetes_verification_tpu_torch"
#: the yardstick: what these import is plain Python, numpy and torch
PLAIN = ["reference.py", "generate.py", "costs.py", "stats.py"]


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.ImportFrom) and node.level > 0:
            out.add("kvbench")
    return out


def sources():
    for base, _, files in os.walk(run.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, run.HERE))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("name", PLAIN)
def test_the_yardstick_imports_nothing_of_the_program(name):
    found = top_level_imports(os.path.join(run.HERE, name))
    assert PROGRAM not in found
    assert found <= {"__future__", "copy", "math", "random", "statistics", "typing",
                     "numpy", "torch"}


def test_whole_names_tell_the_port_from_the_jax_package():
    assert PROGRAM.split(".", 1)[0] not in JAX_SIDE
    assert PROGRAM.startswith("kubernetes_verification_tpu")
