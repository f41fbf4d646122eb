"""The port's static-analysis framework (``kubernetes_verification_tpu_torch/
analysis/``) behind ``kv-tpu-torch lint``, against the JAX package's.

The copied rules must find exactly what the JAX package's find: every
fixture string of ``tests/test_lint.py`` and ``tests/test_interproc.py`` for
a copied rule goes through both packages' ``lint_source`` and the findings
are compared as (rule, path, line, message) lists. The torch counterparts of
the JAX-semantic rules (``jit-host-sync``, ``recompile-hazard``,
``aot-unregistered-kernel``) get positive and negative fixtures in torch
idiom and a planted instance in a copy of a real port module (their
interprocedural partners are in ``tests/test_torch_interproc.py``). Then the
package gates: the port lints clean against its own baseline, whose budgets
are monotone and no larger than the JAX baseline's for a copied rule, the
catalog is in sync, and both CLIs agree on fixture directories. No test
needs a GPU; pure AST throughout."""
import json
import os
import textwrap
from pathlib import Path

import pytest

from kubernetes_verification_tpu import analysis as jax_analysis
from kubernetes_verification_tpu.analysis.baseline import (
    default_baseline_path as jax_baseline_path,
)
from kubernetes_verification_tpu_torch import analysis
from kubernetes_verification_tpu_torch.analysis import (
    lint_source,
    load_baseline,
    over_budget,
    render_json,
    render_text,
    rule_ids,
    run_lint,
    run_package,
    shrink,
)
from kubernetes_verification_tpu_torch.analysis.baseline import default_baseline_path
from kubernetes_verification_tpu_torch.analysis.core import (
    UNUSED_SUPPRESSION,
    iter_package_files,
    package_root,
)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "kubernetes_verification_tpu_torch"

#: the rules whose JAX form asks a question of tracing / shard_map: the
#: port answers it for eager torch under the same id
TORCH_COUNTERPARTS = {
    "jit-host-sync", "recompile-hazard", "aot-unregistered-kernel",
    "collective-axis", "donation-hazard",
}


def _tuples(findings):
    return [(f.rule, f.path, f.line, f.message) for f in findings]


def _both(sources, rules):
    """Lint ``{rel: source}`` with both packages; the port's findings as
    tuples, asserted equal to the JAX package's."""
    srcs = {rel: textwrap.dedent(src) for rel, src in sources.items()}
    port = _tuples(run_lint(srcs, rules=rules).findings)
    jax = _tuples(jax_analysis.run_lint(srcs, rules=rules).findings)
    assert port == jax
    return port


def _lint(src, rules):
    return lint_source(textwrap.dedent(src), rules=rules)


def _lines(src, marker):
    """1-based lines of ``src`` (as linted) that carry ``marker``."""
    return [i for i, ln in enumerate(textwrap.dedent(src).splitlines(), 1)
            if marker in ln]


# ------------------------------------------- copied rules: shared fixtures

#: (case id, rules, {rel: source}, expected finding count). The sources are
#: the fixtures of tests/test_lint.py and tests/test_interproc.py for the
#: rules the port copies.
_SHARED = [
    ("error-taxonomy-bad", ["error-taxonomy"],
     {"<string>.py": 'def f():\n    raise ValueError("bad tile")\n'}, 1),
    ("error-taxonomy-ok", ["error-taxonomy"], {"<string>.py": """
        from kubernetes_verification_tpu.resilience.errors import ConfigError

        def f():
            raise ConfigError("bad tile")

        def g():
            raise NotImplementedError  # ALWAYS_ALLOWED idiom
        """}, 0),
    ("bare-except-bad", ["bare-except"], {"<string>.py": """
        def f():
            try:
                g()
            except:
                pass
        """}, 1),
    ("bare-except-ok", ["bare-except"], {"<string>.py": """
        def f():
            try:
                g()
            except Exception:
                pass
        """}, 0),
    ("atomic-write-bad", ["atomic-write"], {"<string>.py": """
        def save(path, body):
            with open(path, "w") as fh:
                fh.write(body)
        """}, 1),
    ("atomic-write-ok", ["atomic-write"], {"<string>.py": """
        import os

        def save(path, body):
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                fh.write(body)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, path)
        """}, 0),
    ("atomic-write-nested-def", ["atomic-write"], {"<string>.py": """
        def outer(path):
            def inner():
                with open(path, "w") as fh:
                    fh.write("x")
            inner()
        """}, 1),
    ("lease-atomic-no-fsync", ["lease-atomic"], {"<string>.py": """
        import os

        def write_lease(path, body):
            with open(path + ".tmp", "w") as fh:
                fh.write(body)
            os.replace(path + ".tmp", path)
        """}, 1),
    ("lease-atomic-by-path", ["lease-atomic"], {"<string>.py": """
        def refresh(lease_path, body):
            with open(lease_path, "w") as fh:
                fh.write(body)
        """}, 1),
    ("lease-atomic-ok", ["lease-atomic"], {"<string>.py": """
        import os

        class LeaseFile:
            def renew(self, path, body):
                tmp = path + ".tmp"
                with open(tmp, "w") as fh:
                    fh.write(body)
                    fh.flush()
                    os.fsync(fh.fileno())
                os.replace(tmp, path)
        """}, 0),
    ("lease-atomic-not-a-lease", ["lease-atomic"], {"<string>.py": """
        def save(path, body):
            with open(path, "w") as fh:
                fh.write(body)
        """}, 0),
    ("concurrency-thread-daemon-bad", ["concurrency-hygiene"], {"<string>.py": """
        import threading

        def start():
            t = threading.Thread(target=run)
            t.start()
        """}, 1),
    ("concurrency-thread-daemon-ok", ["concurrency-hygiene"], {"<string>.py": """
        import threading

        def start():
            t = threading.Thread(target=run, daemon=True)
            t.start()
        """}, 0),
    ("concurrency-subclass-acquire-globals-bad", ["concurrency-hygiene"], {"<string>.py": """
        import threading

        _state = None
        _lock = threading.Lock()

        class Worker(threading.Thread):
            def __init__(self):
                super().__init__(name="w")

        def set_state(v):
            global _state
            _state = v

        def risky():
            _lock.acquire()
        """}, 3),
    ("concurrency-subclass-acquire-globals-ok", ["concurrency-hygiene"], {"<string>.py": """
        import threading

        _state = None
        _lock = threading.Lock()

        class Worker(threading.Thread):
            def __init__(self):
                super().__init__(name="w", daemon=True)

        def set_state(v):
            global _state
            with _lock:
                _state = v

        def safe():
            with _lock:
                pass
        """}, 0),
    ("bounded-queue-serve", ["bounded-queue"], {"serve/q.py": """
        import collections
        import queue

        q1 = queue.Queue()
        q2 = queue.Queue(maxsize=0)
        q3 = queue.SimpleQueue()
        q4 = collections.deque()
        ok1 = queue.Queue(maxsize=64)
        ok2 = collections.deque(maxlen=8)
        """}, 4),
    ("bounded-queue-elsewhere", ["bounded-queue"], {"ops/q.py": """
        import queue

        q = queue.Queue()
        """}, 0),
    ("bounded-journal", ["bounded-journal"], {"serve/posture.py": """
        import numpy as np

        def witnesses(changed):
            return np.flatnonzero(changed)

        def capped(changed, k):
            return np.flatnonzero(changed)[:k]
        """}, 1),
    ("stripe-locality", ["stripe-locality"], {"serve/stripes.py": """
        def patch(self, idx, d):
            self._ing_count[idx] += d

        def patch_local(self, idx, d):
            self._ing_count[idx - self._lo] += d
        """}, 1),
    ("metrics-names-bad", ["metrics-names"], {"<string>.py":
        'from registry import Counter\nBAD = Counter("kvtpuBadName", "help")\n'}, 1),
    ("metrics-names-ok", ["metrics-names"], {"<string>.py":
        'from registry import Counter\nGOOD = Counter("kvtpu_good_total", "help")\n'}, 0),
    ("metric-discipline-labels-bad", ["metric-discipline"], {"<string>.py":
        'from registry import Counter\n'
        'WIDE = Counter("kvtpu_wide_total", "help", ("a", "b", "c", "d"))\n'}, 1),
    ("metric-discipline-labels-ok", ["metric-discipline"], {"<string>.py":
        'from registry import Counter\n'
        'OK = Counter("kvtpu_ok_total", "help", ("a", "b", "c"))\n'}, 0),
    ("metric-discipline-required-families", ["metric-discipline"], {"m.py": """
        from registry import Counter

        A = Counter("kvtpu_a_total", "help")
        B = Counter("kvtpu_b_total", "help")

        REQUIRED_FAMILIES = frozenset({"kvtpu_a_total", "kvtpu_gone_total"})
        """}, 2),
    ("trace-context", ["trace-context"], {"<string>.py": """
        class H:
            def do_GET(self):
                conn.request("GET", "/v1/tip")

            def do_POST(self):
                ctx = parse_trace_header(self.headers)
                conn.request("GET", "/x", headers=trace_headers())
        """}, 2),
    ("long-loop-progress-bad", ["long-loop-progress"], {"<string>.py": """
        def f(cur, step):
            while True:
                CLOSURE_ITERATIONS.inc()
                cur = step(cur)
        """}, 1),
    ("long-loop-progress-ok", ["long-loop-progress"], {"<string>.py": """
        def f(cur, step, ticker):
            while True:
                CLOSURE_ITERATIONS.inc()
                cur = step(cur)
                ticker.tick()
        """}, 0),
    ("long-loop-progress-plain-counter", ["long-loop-progress"], {"<string>.py": """
        def f(items):
            for x in items:
                SERVE_BATCHES.inc()
        """}, 0),
    ("long-loop-progress-nested", ["long-loop-progress"], {"<string>.py": """
        def f(chunks, step, ticker):
            while True:
                CLOSURE_ITERATIONS.inc()
                for c in chunks:
                    DELTA_ROUNDS.inc()
                    step(c)
                    ticker.tick()
        """}, 1),
    ("suppression-same-line", ["atomic-write"], {"m.py": """
        def save(path, body):
            with open(path, "w") as fh:  # kvtpu: ignore[atomic-write] throwaway export
                fh.write(body)
        """}, 0),
    ("suppression-own-line", ["atomic-write"], {"m.py": """
        def save(path, body):
            # kvtpu: ignore[atomic-write] throwaway export
            with open(path, "w") as fh:
                fh.write(body)
        """}, 0),
    ("unused-suppression", None,
     {"m.py": "x = 1  # kvtpu: ignore[bare-except] nothing here\n"}, 1),
    ("suppression-in-string", None,
     {"m.py": 'DOC = "# kvtpu: ignore[bare-except] example syntax"\n'}, 0),
    ("parse-error", ["bare-except"], {"m.py": "def f(:\n"}, 1),
]

_EXIT_HEAD = """
import argparse

class KvTpuError(Exception):
    pass

class BoomError(KvTpuError):
    pass

def exit_code_for(e):
    return 2
"""

_SHARED += [
    ("exit-contract-escaped", ["exit-contract"], {"cli.py": _EXIT_HEAD + """
def cmd_boom(args):
    raise BoomError("x")

def build(sub):
    p = sub.add_parser("boom")
    p.set_defaults(fn=cmd_boom)
"""}, 1),
    ("exit-contract-wrapped", ["exit-contract"], {"cli.py": _EXIT_HEAD + """
def cmd_boom(args):
    try:
        raise BoomError("x")
    except KvTpuError as e:
        return exit_code_for(e)

def build(sub):
    p = sub.add_parser("boom")
    p.set_defaults(fn=cmd_boom)
"""}, 0),
]


@pytest.mark.parametrize(
    "rules, sources, count", [c[1:] for c in _SHARED], ids=[c[0] for c in _SHARED]
)
def test_copied_rule_finds_what_the_jax_rule_finds(rules, sources, count):
    found = _both(sources, rules)
    assert len(found) == count, found
    if rules:
        assert {f[0] for f in found} <= set(rules) | {"parse-error"}


def test_unused_suppression_and_messages_name_the_rule():
    found = _both({"m.py": "x = 1  # kvtpu: ignore[bare-except] nothing here\n"}, None)
    assert [f[0] for f in found] == [UNUSED_SUPPRESSION]
    assert "kvtpu: ignore[bare-except]" in found[0][3]


def test_unknown_rule_id_raises_the_ports_config_error():
    from kubernetes_verification_tpu_torch.resilience.errors import ConfigError

    with pytest.raises(ConfigError):
        lint_source("x = 1\n", rules=["no-such-rule"])


def test_list_prints_the_same_rule_ids_in_the_same_order(capsys):
    assert analysis.main(["--list"]) == 0
    port = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()]
    assert jax_analysis.main(["--list"]) == 0
    jax = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()]
    assert port == jax == rule_ids()
    assert TORCH_COUNTERPARTS <= set(port)


def test_every_registered_rule_has_catalog_metadata():
    from kubernetes_verification_tpu_torch.analysis.core import RULES, _select_rules

    _select_rules(None)
    assert len(RULES) == 18
    for rule in RULES.values():
        assert rule.id and rule.rationale and rule.example
    # a counterpart's catalog text describes the torch hazard, not JAX's
    for rid in TORCH_COUNTERPARTS:
        text = RULES[rid].rationale + RULES[rid].example
        assert "jax.jit" not in text and "shard_map(" not in text, rid


# ----------------------------------------------------- jit-host-sync (torch)

_REG = "from kubernetes_verification_tpu_torch.observe.aot import register_kernel\n"


def test_jit_host_sync_two_assignments_from_the_dispatch_boundary():
    src = _REG + """
import torch

def _step(x: torch.Tensor) -> torch.Tensor:
    y = x * 2
    z = torch.sum(y)
    return z.item()  # SYNC

_step = register_kernel("eng", "_step", _step)
"""
    bad = _lint(src, ["jit-host-sync"])
    assert [f.rule for f in bad] == ["jit-host-sync"]
    assert [f.line for f in bad] == _lines(src, "# SYNC")
    assert ".item()" in bad[0].message
    # the same call on a host array, or in a function nothing registers
    ok = _lint("""
import numpy as np

def g():
    h = np.ones(3)
    s = h.sum()
    return s.item()
""", ["jit-host-sync"])
    assert ok == []


def test_jit_host_sync_sinks_kills_and_static_args():
    src = _REG + """
import numpy as np
import torch

def _step(x, cnt: np.ndarray, *, tile: int):
    n = int(x.shape[0])              # host metadata: fine
    m = x.numel() + len(x)           # fine
    if tile > 128:                   # static: fine
        n += 1
    if x.device.type == "cuda":      # fine
        n += 2
    h = np.asarray(cnt)              # a host operand: fine
    if x.sum() > 0:                  # SYNC implicit bool()
        n += 3
    a = float(x[0])                  # SYNC
    b = x.cpu()                      # SYNC
    c = np.asarray(x)                # SYNC
    torch.cuda.synchronize()         # SYNC a stall
    return x * n

_step = register_kernel("eng", "_step", _step, static_argnames=("tile",))
"""
    found = _lint(src, ["jit-host-sync"])
    assert sorted(f.line for f in found) == _lines(src, "# SYNC"), [f.render() for f in found]
    found.sort(key=lambda f: f.line)
    assert "branch" in found[0].message and "synchronize" in found[-1].message


def test_jit_host_sync_elementwise_bindings_keep_host_values_clean():
    """``for d, c in (("i", x), ("e", y))`` binds ``d`` to host strings, and
    a comprehension's iterable reaches only its element."""
    ok = _lint(_REG + """
def _cols(x, y):
    for d, c in (("i", x), ("e", y)):
        if d == "i":
            c.add_(1)
    for k, t in enumerate((x, y)):
        if k == 0:
            t.zero_()
    if any(t.data_ptr() % 16 for t in (x, y)):
        raise ValueError("unaligned")

_cols = register_kernel("eng", "_cols", _cols)
""", ["jit-host-sync"])
    assert ok == [], [f.render() for f in ok]


def test_jit_host_sync_through_the_transient_registrar():
    src = """
from kubernetes_verification_tpu_torch.observe.aot import transient_kernel

def _square_local(mesh, stripe, *, n_total):
    changed = (stripe != 0).any()
    return stripe, int(changed.item())  # SYNC

def driver(mesh, cur, n):
    square = transient_kernel("sharded", "_square_local", _square_local)
    for _ in range(n):
        cur, changed = square(mesh, cur, n_total=n)
        if changed == 0:
            break
    return cur
"""
    found = _lint(src, ["jit-host-sync"])
    assert {f.line for f in found} == set(_lines(src, "# SYNC")) and len(found) == 2


def test_jit_host_sync_sharded_closure_readback_belongs_in_the_driver():
    """The sanctioned shape of the sharded closure's convergence loop: the
    registered step returns the change flag as a tensor and the HOST driver
    reads it back — no finding and no suppression needed."""
    ok = _lint("""
from kubernetes_verification_tpu_torch.observe.aot import transient_kernel

def _square_local(mesh, stripe, *, n_total):
    changed = (stripe != 0).any().to(torch.int32).reshape(1)
    return stripe, changed

def driver(mesh, cur, n):
    square = transient_kernel("sharded", "_square_local", _square_local)
    for _ in range(n):
        cur, changed = square(mesh, cur, n_total=n)
        if int(changed.item()) == 0:
            break
    return cur
""", ["jit-host-sync"])
    assert ok == []


def _port_source(rel):
    return (PKG / rel).read_text()


def _plant(tmp_path, rel, old, new):
    """A copy of a real port module under ``tmp_path`` with one edit, and
    the line of the edit."""
    src = _port_source(rel)
    assert src.count(old) == 1, old
    planted = src.replace(old, new)
    dest = tmp_path / rel
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(planted)
    line = planted[: planted.index(new)].count("\n") + 1
    return planted, line


def test_jit_host_sync_flags_an_item_planted_in_the_real_closure_step(tmp_path):
    rel = "ops/closure.py"
    assert run_lint({rel: _port_source(rel)}, rules=["jit-host-sync"]).findings == []
    planted, line = _plant(
        tmp_path, rel,
        "    return out.bitwise_or_(packed)\n",
        "    print(out.sum().item())\n    return out.bitwise_or_(packed)\n",
    )
    found = run_lint({rel: planted}, rules=["jit-host-sync"]).findings
    assert [(f.rule, f.line) for f in found] == [("jit-host-sync", line)]
    assert ".item()" in found[0].message


@pytest.mark.parametrize("rel", ["ops/closure.py", "parallel/sharded_closure.py"])
def test_the_ports_eager_flag_reads_carry_a_reasoned_suppression(tmp_path, rel):
    """``ops/closure.py::_any_removed`` and the sharded closure's square step
    read one flag back inside a registered function, which the eager driver
    branches on next: the same one sync in either frame. Each carries an
    inline ``jit-host-sync`` suppression with that reason; the module lints
    clean with it, and without the comment the read is flagged on its line."""
    src = _port_source(rel)
    assert run_lint({rel: src}, rules=["jit-host-sync"]).findings == []
    marker = [ln for ln in src.splitlines(keepends=True)
              if "kvtpu: ignore[jit-host-sync]" in ln]
    assert len(marker) == 1 and "same one sync" in marker[0]
    planted, _ = _plant(tmp_path, rel, marker[0], "")
    line = src[: src.index(marker[0])].count("\n") + 1  # the read moves up into it
    found = run_lint({rel: planted}, rules=["jit-host-sync"]).findings
    assert found and {(f.rule, f.line) for f in found} == {("jit-host-sync", line)}


# --------------------------------------------------- recompile-hazard (torch)


def test_recompile_hazard_shape_string_key():
    bad = _lint("""
_cache = {}

def lookup(x, backend):
    key = f"{x.shape}-{backend}"
    return _cache[key]
""", ["recompile-hazard"])
    assert [f.rule for f in bad] == ["recompile-hazard"]
    ok = _lint("""
_cache = {}

def lookup(x, backend):
    key = (tuple(x.shape), x.dtype, backend)
    return _cache[key]
""", ["recompile-hazard"])
    assert ok == []


def test_recompile_hazard_registered_static_args():
    src = _REG + """
def _step(x, *, tile):
    return x * tile

_step = register_kernel("eng", "_step", _step, static_argnames=("tiel",))  # HIT
"""
    typo = _lint(src, ["recompile-hazard"])
    assert len(typo) == 1 and "tiel" in typo[0].message
    assert [typo[0].line] == _lines(src, "# HIT")
    src = _REG + """
def _step(x, *, tol, tiles):
    return x * tol

_step = register_kernel("eng", "_step", _step, static_argnames=("tol", "tiles"))

def caller(x):
    a = _step(x, tol=0.25, tiles=(1, 2))  # HIT
    return _step(x, tol=1, tiles=[1, 2])  # HIT
"""
    bad = _lint(src, ["recompile-hazard"])
    assert [f.line for f in bad] == _lines(src, "# HIT")
    assert "float" in bad[0].message and "unhashable" in bad[1].message
    order = _lint(_REG + """
def _step(a):
    return a

_step = register_kernel("eng", "_step", _step)

def caller(d):
    return _step(tuple(d.values())), _step(tuple(sorted(d.values())))
""", ["recompile-hazard"])
    assert len(order) == 1 and "iteration order" in order[0].message
    clean = _lint(_REG + """
def _step(x, *, tile):
    return x * tile

_step = register_kernel("eng", "_step", _step, static_argnames=("tile",))

def caller(x):
    return _step(x, tile=128)
""", ["recompile-hazard"])
    assert clean == []


def test_recompile_hazard_flags_a_typo_planted_in_the_real_closure(tmp_path):
    rel = "ops/closure.py"
    assert run_lint({rel: _port_source(rel)}, rules=["recompile-hazard"]).findings == []
    planted, line = _plant(
        tmp_path, rel,
        '    static_argnames=("row_tile", "dst_tile"),\n',
        '    static_argnames=("row_tile", "dst_tiel"),\n',
    )
    found = run_lint({rel: planted}, rules=["recompile-hazard"]).findings
    assert len(found) == 1 and "dst_tiel" in found[0].message


# ------------------------------------------- aot-unregistered-kernel (torch)


def test_aot_unregistered_kernel_tracked_dispatch_function():
    src = """
from kubernetes_verification_tpu_torch.observe import DispatchTracker

_TRACKER = DispatchTracker("eng")

def _step(x):  # HIT
    return x + 1

def _other(x):
    return x

def apply(x):
    _TRACKER.track("_step", x)
    _TRACKER.track("_not_a_def", x)
    return _other(_step(x))
"""
    bad = _lint(src, ["aot-unregistered-kernel"])
    assert [f.line for f in bad] == _lines(src, "# HIT")
    ok = _lint(_REG + """
from kubernetes_verification_tpu_torch.observe import DispatchTracker

_TRACKER = DispatchTracker("eng")

def _step(x):
    return x + 1

def apply(x):
    _TRACKER.track("_step", x)
    return _step(x)

_step = register_kernel("eng", "_step", _step)
""", ["aot-unregistered-kernel"])
    assert ok == []


def test_aot_unregistered_kernel_library_loaders():
    src = """
import ctypes

from .cuda_build import load_library

def _load():  # HIT
    return ctypes.CDLL(_build())

def _driver():
    return ctypes.CDLL("libcuda.so.1")

def launch(x):
    return load_library("packed_dir_allow").launch(x)

def load_library(name):
    return ctypes.CDLL(name)
"""
    found = _lint(src, ["aot-unregistered-kernel"])
    # a built library no pack ships is flagged; a system soname, the pack's
    # loader and a kernel it loads are not
    assert [f.line for f in found] == _lines(src, "# HIT") and "CDLL" in found[0].message


def test_aot_unregistered_kernel_flags_a_registration_removed_from_the_real_closure(tmp_path):
    rel = "ops/closure.py"
    assert run_lint({rel: _port_source(rel)}, rules=["aot-unregistered-kernel"]).findings == []
    planted, _ = _plant(
        tmp_path, rel,
        '_rows_touching = _register_kernel("closure", "_rows_touching", _rows_touching)\n',
        "_TRACKER = DispatchTracker('closure')\n"
        "_TRACKER.track('_rows_touching')\n",
    )
    found = run_lint({rel: planted}, rules=["aot-unregistered-kernel"]).findings
    assert len(found) == 1 and "_rows_touching()" in found[0].message
    want = planted[: planted.index("def _rows_touching(")].count("\n") + 1
    assert found[0].line == want


# ------------------------------------------------------- package + baseline


@pytest.fixture(scope="module")
def package_result():
    """One lint of the whole port package against its committed baseline
    (about 18 s on one core), shared by the gates below."""
    return run_package(baseline=load_baseline(default_baseline_path()))


def test_package_lints_clean_against_its_own_baseline(package_result):
    assert package_result.ok, "\n" + "\n".join(
        f.render() for f in package_result.findings
    )
    assert package_result.grandfathered


def test_the_baseline_lives_in_the_package_and_its_budgets_are_monotone(package_result):
    path = default_baseline_path()
    assert os.path.dirname(path) == package_root() == str(PKG)
    budgets = load_baseline(path)
    assert budgets, "the port's LINT_BASELINE.json must exist"
    assert over_budget(budgets, package_result) == {}
    shrunk = shrink(budgets, package_result)
    assert shrunk == budgets, "a budget is larger than its count: shrink it"
    for rule, files in shrunk.items():
        for rel, n in files.items():
            assert n <= budgets[rule][rel]


def test_copied_rule_budgets_stay_within_the_jax_baseline():
    port = load_baseline(default_baseline_path())
    jax = jax_analysis.load_baseline(jax_baseline_path())
    for rule, files in port.items():
        if rule in TORCH_COUNTERPARTS:
            continue
        for rel, n in files.items():
            assert n <= jax.get(rule, {}).get(rel, 0), (rule, rel, n)


def test_counterpart_rule_budgets_are_listed_in_the_roadmap():
    """A redesigned rule has no JAX budget to stay under: each of its
    grandfathered files is named in ROADMAP §3 with its reason."""
    roadmap = (REPO / "ROADMAP.md").read_text()
    port = load_baseline(default_baseline_path())
    listed = [(rule, rel) for rule, files in port.items()
              if rule in TORCH_COUNTERPARTS for rel in files]
    assert listed
    for rule, rel in listed:
        assert f"`{rule}` {rel}" in roadmap, (rule, rel)


def test_lints_md_docs_in_sync_and_in_the_package():
    path = PKG / "LINTS.md"
    assert analysis.main(["--check-docs", str(path)]) == 0
    text = path.read_text()
    assert "kv-tpu-torch lint" in text and "jax.jit" not in text


def test_check_docs_flags_drift(tmp_path, capsys):
    stale = tmp_path / "LINTS.md"
    stale.write_text((PKG / "LINTS.md").read_text() + "drift\n")
    assert analysis.main(["--check-docs", str(stale)]) == 1
    assert "kubernetes_verification_tpu_torch.analysis" in capsys.readouterr().err


def test_reporters_text_and_json():
    src = 'def f():\n    raise ValueError("x")\n'
    result = run_lint({"m.py": src}, rules=["error-taxonomy"])
    text = render_text(result)
    assert "m.py:2: [error-taxonomy]" in text and "1 finding(s)" in text
    payload = json.loads(render_json(result))
    assert payload["ok"] is False
    assert payload["counts"]["error-taxonomy"]["m.py"] == 1
    jresult = jax_analysis.run_lint({"m.py": src}, rules=["error-taxonomy"])
    assert render_json(result) == jax_analysis.render_json(jresult)


# --------------------------------------------------------------- the CLIs


def _fixture_dir(tmp_path, name, files):
    d = tmp_path / name
    d.mkdir()
    for rel, src in files.items():
        (d / rel).write_text(textwrap.dedent(src))
    return d


_CLEAN = {"ok.py": "def f(x):\n    return x + 1\n"}
_DIRTY = {
    "bad.py": 'def f():\n    raise ValueError("x")\n',
    "worse.py": "try:\n    pass\nexcept:\n    pass\n",
}


@pytest.mark.parametrize("files, rc", [(_CLEAN, 0), (_DIRTY, 1)], ids=["clean", "dirty"])
def test_both_clis_agree_on_a_fixture_directory(tmp_path, capsys, files, rc):
    from kubernetes_verification_tpu.cli import main as jax_cli
    from kubernetes_verification_tpu_torch.cli import main as port_cli

    d = _fixture_dir(tmp_path, "fx", files)
    argv = ["lint", str(d), "--format", "json", "--baseline", str(tmp_path / "none.json")]
    assert port_cli(argv) == rc
    port = json.loads(capsys.readouterr().out)
    assert jax_cli(argv) == rc
    jax = json.loads(capsys.readouterr().out)
    assert port == jax
    assert len(port["findings"]) == (0 if rc == 0 else 2)


def test_kv_tpu_torch_lint_subcommand_and_exit_code_contract(capsys):
    from kubernetes_verification_tpu_torch.cli import main as port_cli
    from kubernetes_verification_tpu_torch.resilience.errors import EXIT_INPUT_ERROR

    assert port_cli(["lint", "--rules", "error-taxonomy,bare-except"]) == 0
    capsys.readouterr()
    assert port_cli(["lint", "--rules", "no-such-rule"]) == EXIT_INPUT_ERROR
    err = capsys.readouterr().err
    assert "ConfigError" in err and "no-such-rule" in err


def test_lint_cli_update_baseline_only_shrinks(tmp_path, capsys):
    f = tmp_path / "m.py"
    f.write_text('def f():\n    raise ValueError("x")\n')
    base = tmp_path / "LINT_BASELINE.json"
    base.write_text(json.dumps({"error-taxonomy": {"m.py": 5}}))
    assert analysis.main([str(tmp_path), "--baseline", str(base), "--update-baseline"]) == 0
    capsys.readouterr()
    assert json.loads(base.read_text()) == {"error-taxonomy": {"m.py": 1}}
    base.write_text(json.dumps({"error-taxonomy": {"m.py": 0}}))
    assert analysis.main([str(tmp_path), "--baseline", str(base), "--update-baseline"]) == 1
    capsys.readouterr()
    assert json.loads(base.read_text()) == {}


def test_headless_module_and_script_entry_points():
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "kubernetes_verification_tpu_torch.analysis", "--list"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0 and "collective-axis:" in proc.stdout
    toml = (REPO / "pyproject.toml").read_text()
    assert 'kv-tpu-torch-lint = "kubernetes_verification_tpu_torch.analysis:main"' in toml


def test_lint_findings_metric_family_exists_in_the_ports_registry():
    from kubernetes_verification_tpu_torch.observe import REGISTRY
    from kubernetes_verification_tpu_torch.observe.metrics import (
        LINT_FINDINGS_TOTAL,
        REQUIRED_FAMILIES,
    )

    assert "kvtpu_lint_findings_total" in REQUIRED_FAMILIES
    assert REGISTRY.get("kvtpu_lint_findings_total") is LINT_FINDINGS_TOTAL


def test_cli_run_counts_findings_in_the_ports_metric(tmp_path, capsys):
    from kubernetes_verification_tpu_torch.observe.metrics import LINT_FINDINGS_TOTAL

    d = _fixture_dir(tmp_path, "fx", _DIRTY)
    before = LINT_FINDINGS_TOTAL.labels(rule="bare-except").value
    assert analysis.main([str(d)]) == 1
    capsys.readouterr()
    assert LINT_FINDINGS_TOTAL.labels(rule="bare-except").value == before + 1


# ------------------------------------------------------------ bench gate


def test_bench_gate_matches_the_jax_gate_on_the_same_history(capsys):
    from kubernetes_verification_tpu.analysis import bench_gate as jax_gate
    from kubernetes_verification_tpu_torch.analysis import bench_gate as port_gate

    paths = sorted(str(p) for p in REPO.glob("BENCH_r*.json"))
    assert paths
    for argv in (paths + ["--json"], paths + ["--json", "--raw"], paths + ["--dry-run"]):
        rc_port = port_gate.main(argv)
        out_port = capsys.readouterr().out
        rc_jax = jax_gate.main(argv)
        out_jax = capsys.readouterr().out
        assert (rc_port, out_port) == (rc_jax, out_jax)


# ------------------------------------------------------------- file walks


def test_iter_package_files_walks_the_port_package():
    rels = [rel for rel, _ in iter_package_files()]
    assert "analysis/rules_torch.py" in rels and "cli.py" in rels
    assert not any("__pycache__" in r for r in rels)
    assert all(Path(p).is_relative_to(PKG) for _, p in iter_package_files())


def test_the_summary_cache_file_is_inside_the_package_and_ignored():
    from kubernetes_verification_tpu_torch.analysis.summaries import default_cache_path

    assert default_cache_path() == str(PKG / ".kvtpu_lint_cache.json")
    ignored = (REPO / ".gitignore").read_text().splitlines()
    assert "kubernetes_verification_tpu_torch/.kvtpu_lint_cache.json" in ignored
