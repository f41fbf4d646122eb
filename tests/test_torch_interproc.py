"""The port's interprocedural engine (``analysis/callgraph.py`` +
``analysis/summaries.py``) and the rules on it: cross-function taint for
``jit-host-sync`` over registered dispatch functions, ``collective-axis``
over ``torch.distributed`` collectives, ``donation-hazard`` as reads after
an in-place write, and the copied ``exit-contract`` — plus the summary
cache, the SARIF golden in the port's shape and the ``--changed`` plumbing.
Each torch-counterpart rule flags a planted instance in a copy of a real
port module and stays silent on the module as it is."""
import json
import textwrap
from pathlib import Path

from kubernetes_verification_tpu import analysis as jax_analysis
from kubernetes_verification_tpu_torch.analysis import (
    changed_package_rels,
    render_sarif,
    run_lint,
)
from kubernetes_verification_tpu_torch.analysis.core import build_context
from kubernetes_verification_tpu_torch.analysis.summaries import build_program

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "kubernetes_verification_tpu_torch"

_REG = "from kubernetes_verification_tpu_torch.observe.aot import register_kernel\n"


def _lint(sources, rules, cache_path=None):
    """Multi-file fixture helper: {rel: dedented source} -> findings."""
    srcs = {rel: textwrap.dedent(src) for rel, src in sources.items()}
    return run_lint(srcs, rules=rules, cache_path=cache_path).findings


def _program(sources, cache_path=None):
    ctxs = [build_context(rel, textwrap.dedent(src)) for rel, src in sources.items()]
    return build_program(ctxs, cache_path=cache_path)


def _lines(src, marker):
    return [i for i, ln in enumerate(textwrap.dedent(src).splitlines(), 1)
            if marker in ln]


def _real(rel):
    return (PKG / rel).read_text()


def _plant(tmp_path, rel, old, new):
    """A copy of a real port module under ``tmp_path`` with one edit."""
    src = _real(rel)
    assert src.count(old) == 1, old
    planted = src.replace(old, new)
    dest = tmp_path / rel
    dest.parent.mkdir(parents=True, exist_ok=True)
    dest.write_text(planted)
    return dest.read_text()


# ------------------------------------------------- cross-function taint


def test_jit_host_sync_through_two_helpers():
    """A registered dispatch function reaches ``.item()`` two calls away;
    the finding lands at its call site with the via-chain."""
    found = _lint({"a.py": _REG + """
def inner(p):
    return int(p.item())

def outer(q):
    return inner(q) + 1

def _step(x):
    return outer(x)

_step = register_kernel("eng", "_step", _step)
"""}, ["jit-host-sync"])
    assert len(found) == 1
    f = found[0]
    assert f.path == "a.py" and "outer" in f.message and "via inner" in f.message
    assert "stream sync" in f.message


def test_jit_host_sync_cross_file_helper():
    found = _lint({
        "util.py": """
        def pull(v):
            return float(v)
        """,
        "main.py": _REG + """
from util import pull

def _step(x):
    return pull(x)

_step = register_kernel("eng", "_step", _step)
""",
    }, ["jit-host-sync"])
    assert [f.path for f in found] == ["main.py"] and "pull" in found[0].message


def test_jit_host_sync_clean_helper_and_host_operand_not_flagged():
    found = _lint({"a.py": _REG + """
import numpy as np
import torch

def double(p):
    return p * 2

def rows(n):
    return int(n)

def _step(x, cnt: np.ndarray):
    return double(x) + torch.sum(x) + rows(x.shape[0]) + rows(cnt[0])

_step = register_kernel("eng", "_step", _step)
"""}, ["jit-host-sync"])
    assert found == []


def test_jit_host_sync_stall_through_a_helper():
    src = _REG + """
import torch

def _wait():
    torch.cuda.synchronize()

def _step(x):
    y = x + 1
    _wait()  # HIT
    return y

_step = register_kernel("eng", "_step", _step)
"""
    found = _lint({"a.py": src}, ["jit-host-sync"])
    assert [f.line for f in found] == _lines(src, "# HIT")
    assert "stall" in found[0].message and "torch.cuda.synchronize()" in found[0].message


def test_scc_recursion_fixpoint_terminates():
    found = _lint({"a.py": _REG + """
def ping(p, n):
    if n == 0:
        return int(p.item())
    return pong(p, n - 1)

def pong(p, n):
    return ping(p, n - 1)

def _step(x):
    return ping(x, 3)

_step = register_kernel("eng", "_step", _step)
"""}, ["jit-host-sync"])
    assert len(found) == 1 and "ping" in found[0].message


def test_jit_host_sync_helper_planted_in_the_real_batched_module(tmp_path):
    """A sync added to ``ops/batched.py``'s ``_reach_rows_kernel`` is
    flagged there and at the registered ``_probe_rows_kernel`` that calls
    it."""
    rel = "ops/batched.py"
    assert run_lint({rel: _real(rel)}, rules=["jit-host-sync"]).findings == []
    planted = _plant(
        tmp_path, rel,
        "    rows = ing_ok & eg_ok\n    if self_traffic:\n        n = ing_count.shape[1]\n",
        "    rows = ing_ok & eg_ok\n    print(rows.sum().item())\n"
        "    if self_traffic:\n        n = ing_count.shape[1]\n",
    )
    found = run_lint({rel: planted}, rules=["jit-host-sync"]).findings
    line = planted[: planted.index("print(rows.sum().item())")].count("\n") + 1
    call = planted.index("rows = _reach_rows_kernel(")
    call_line = planted[:call].count("\n") + 1
    # one finding at the sink, one per tensor parameter feeding it at the
    # registered caller
    assert sorted({f.line for f in found}) == [line, call_line]
    assert sum("_reach_rows_kernel() parameter" in f.message for f in found) == 3


def test_relative_imports_in_a_package_init_resolve_to_the_package():
    """A relative import in a package's ``__init__.py`` names a module of
    that package. The JAX package's callgraph climbs one level too many
    there and drops the edge (a fault of the reference, ROADMAP §3); the
    port resolves it, so ``exit-contract`` follows ``cmd_lint`` into
    ``analysis/__init__.py::run_from_args`` and on."""
    from kubernetes_verification_tpu.analysis.core import build_context as jax_context
    from kubernetes_verification_tpu.analysis.summaries import build_program as jax_program

    sources = {
        "pkg/__init__.py": "from .core import helper\n\ndef entry(x):\n    return helper(x)\n",
        "pkg/core.py": "def helper(x):\n    return x\n",
    }
    port = _program(sources).graph.functions["pkg:entry"].calls
    assert [c.callee for c in port] == ["pkg.core:helper"]
    jax = jax_program([jax_context(r, s) for r, s in sources.items()])
    assert jax.graph.functions["pkg:entry"].calls == []


# ------------------------------------------------------- summary cache


def test_summary_cache_hit_and_invalidation_on_edit(tmp_path):
    cache = str(tmp_path / "cache.json")
    sources = {
        "a.py": """
        def helper(p):
            return p.item()

        def writes(q):
            q.add_(1)
            return q
        """,
        "b.py": """
        def other(q):
            return q * 2
        """,
    }
    cold = _program(sources, cache_path=cache)
    assert cold.cache_hits == 0 and cold.cache_misses == 2
    warm = _program(sources, cache_path=cache)
    assert warm.cache_hits == 2 and warm.cache_misses == 0
    assert set(warm.summaries) == set(cold.summaries)
    assert set(warm.summaries["a:helper"].param_syncs) == {0}
    assert set(warm.summaries["a:writes"].mutates) == {0}

    edited = dict(sources)
    edited["a.py"] = sources["a.py"].replace("p.item()", "p * 3")
    third = _program(edited, cache_path=cache)
    assert third.cache_hits == 1 and third.cache_misses == 1
    assert third.summaries["a:helper"].param_syncs == {}


def test_cache_corruption_falls_back_to_cold(tmp_path):
    cache = tmp_path / "cache.json"
    cache.write_text("{not json")
    prog = _program({"a.py": "def f(p):\n    return p\n"}, cache_path=str(cache))
    assert prog.cache_misses == 1


def test_in_place_write_summaries():
    prog = _program({"m.py": """
    import torch.distributed as dist

    def a(x, y):
        x.add_(y)

    def b(x, i, v):
        x[i] = v

    def c(x, y):
        torch.add(y, 1, out=x)

    def d(x):
        dist.all_reduce(x)

    def e(x):
        x = x.clone()
        x.add_(1)
        return x

    def f(x, y):
        a(x, y)

    def g(x):
        z = x + 1
        a(z, 1)
    """})
    got = {qn.split(":")[1]: set(s.mutates) for qn, s in prog.summaries.items()}
    assert got == {"a": {0}, "b": {0}, "c": {0}, "d": {0}, "e": set(),
                   "f": {0}, "g": set()}
    assert prog.summaries["m:f"].mutates[0][1] == ("a",)


# ----------------------------------------------------- collective-axis

_MESH_HEAD = """
import torch.distributed as dist
from kubernetes_verification_tpu_torch.parallel.mesh import (
    all_gather, broadcast, gather_rows, psum, psum_counts,
)

POD_AXIS = "pods"
GRANT_AXIS = "grants"
"""


def test_collective_axis_undefined_axis_flagged():
    src = _MESH_HEAD + """
def body(mesh, x):
    psum(mesh, x, POD_AXIS)
    all_gather(mesh, x, GRANT_AXIS, dim=1)
    psum(mesh, x, (POD_AXIS, GRANT_AXIS))
    psum(mesh, x, "nodes")  # HIT
    dist.all_reduce(x, group=mesh.groups["rows"])  # HIT
    gather_rows(mesh, x, [0], 4, axis="pod")  # HIT
    return x
"""
    found = _lint({"p.py": src}, ["collective-axis"])
    assert [f.line for f in found] == _lines(src, "# HIT")
    assert "'nodes'" in found[0].message and "grants, pods" in found[0].message
    assert "dist.all_reduce" in found[1].message


def test_collective_axis_clean_module():
    found = _lint({"p.py": _MESH_HEAD + """
def body(mesh, x, ids):
    if x.dtype is None:
        raise ValueError("checked before any collective")
    y = psum(mesh, x, GRANT_AXIS)
    z = gather_rows(mesh, y, ids, 4)
    psum_counts(mesh, y, z)
    dist.barrier(group=mesh.groups[POD_AXIS])
    return broadcast(mesh, z, POD_AXIS, 0)
"""}, ["collective-axis"])
    assert found == []


def test_collective_axis_rank_dependent_branch():
    src = _MESH_HEAD + """
def helper(mesh, x):
    return psum(mesh, x, GRANT_AXIS)

def body(mesh, x, cm):
    me = mesh.coords[POD_AXIS]
    if mesh.coords[POD_AXIS] == 0:
        psum(mesh, x, GRANT_AXIS)  # HIT
    if me == 1:
        helper(mesh, x)  # HIT
    if dist.get_rank() == 0:
        cm.save(x)  # a rank-0 write, no collective: fine
    if x.shape[0] > 4:
        psum(mesh, x, POD_AXIS)  # the same on every rank: fine
    return x
"""
    found = _lint({"p.py": src}, ["collective-axis"])
    assert [f.line for f in found] == _lines(src, "# HIT")
    assert "helper()" in found[1].message and "rank's identity" in found[1].message


def test_collective_axis_raise_after_the_first_collective():
    src = _MESH_HEAD + """
def body(mesh, x):
    if x.dim() != 2:
        raise ValueError("fine: before the first collective")
    y = psum(mesh, x, GRANT_AXIS)
    try:
        z = all_gather(mesh, y, POD_AXIS)
    except RuntimeError:
        raise  # a re-raise: the origin diverged, not this line
    if not z.any():
        raise ValueError("only some ranks may get here")  # HIT
    return z

def no_mesh(x):
    y = x + 1
    raise ValueError("no mesh, no peers to strand")
"""
    found = _lint({"p.py": src}, ["collective-axis"])
    assert [f.line for f in found] == _lines(src, "# HIT")
    assert "strands its peers" in found[0].message


def test_collective_axis_planted_in_the_real_engine_mesh(tmp_path):
    rel = "parallel/sharded_closure.py"
    assert run_lint({rel: _real(rel), "parallel/mesh.py": _real("parallel/mesh.py")},
                    rules=["collective-axis"]).findings == []
    planted = _plant(
        tmp_path, rel,
        "    psum(mesh, sq, GRANT_AXIS)\n",
        "    if mesh.coords[POD_AXIS] == 0:\n        psum(mesh, sq, GRANT_AXIS)\n"
        "    psum(mesh, sq, \"nodes\")\n",
    )
    found = run_lint({rel: planted, "parallel/mesh.py": _real("parallel/mesh.py")},
                     rules=["collective-axis"]).findings
    msgs = sorted(f.message.split(" — ")[0] for f in found)
    assert len(found) == 2, [f.render() for f in found]
    assert any("psum(axis='nodes')" in m for m in msgs)
    assert any("under a branch on this rank's identity" in m for m in msgs)


def test_the_ports_mesh_collectives_are_recognised():
    """``parallel/mesh.py`` itself: every public collective runs one, and
    ``psum`` writes its operand in place (through ``_in_place``)."""
    prog = _program({"parallel/mesh.py": _real("parallel/mesh.py")})
    kinds = {
        qn.split(":")[1]: {c["kind"] for c in s.local.collectives}
        for qn, s in prog.summaries.items() if s.local.collectives
    }
    assert kinds["all_gather"] == {"dist.all_gather"}
    assert kinds["psum_counts"] == {"psum"}
    assert kinds["gather_rows"] == {"all_gather"}
    assert kinds["barrier"] == {"dist.barrier"}
    assert set(prog.summaries["parallel.mesh:psum"].mutates) == {1}
    assert set(prog.summaries["parallel.mesh:_in_place"].mutates) == {0}


# ----------------------------------------------------- donation-hazard


def test_read_after_an_in_place_callee_flagged():
    src = """
    def step(buf):
        buf.add_(1)
        return buf.sum()

    def run(buf):
        total = step(buf)
        return total + buf.max()  # HIT
    """
    found = _lint({"d.py": src}, ["donation-hazard"])
    assert [f.line for f in found] == _lines(src, "# HIT")
    assert "wrote it in place" in found[0].message


def test_rebind_and_effect_only_calls_are_clean():
    found = _lint({"d.py": """
    def step(buf):
        buf.add_(1)
        return buf

    def fill(buf):
        buf.zero_()

    def good(buf):
        for _ in range(4):
            buf = step(buf)
        return buf

    def effect(buf):
        fill(buf)
        return buf.sum()

    def copy_first(buf):
        out = step(buf.clone())
        return out + buf
    """}, ["donation-hazard"])
    assert found == []


def test_in_place_callee_in_a_loop_without_rebind():
    src = """
    def step(buf):
        buf.mul_(2)
        return buf.sum()

    def bad(buf):
        acc = 0
        for _ in range(4):
            acc = acc + step(buf)  # HIT
        return acc
    """
    found = _lint({"d.py": src}, ["donation-hazard"])
    assert [f.line for f in found] == _lines(src, "# HIT")
    assert "inside a loop" in found[0].message


def test_in_place_write_through_a_helper_and_a_collective():
    src = """
    import torch.distributed as dist

    def _reduce(t):
        dist.all_reduce(t)

    def total(t):
        _reduce(t)
        return t.sum()

    def run(x):
        s = total(x)
        return s / x.numel() + x[0]  # HIT
    """
    found = _lint({"d.py": src}, ["donation-hazard"])
    assert [f.line for f in found] == _lines(src, "# HIT")
    assert "via _reduce" in found[0].message


def test_donation_hazard_planted_in_the_real_sharded_ops(tmp_path):
    """A read of a tensor after handing it to ``psum`` (which sums it in
    place) planted into a copy of the port's ``parallel/sharded_closure``."""
    rel = "parallel/sharded_closure.py"
    mesh = {"parallel/mesh.py": _real("parallel/mesh.py")}
    assert run_lint({rel: _real(rel), **mesh}, rules=["donation-hazard"]).findings == []
    planted = _plant(
        tmp_path, rel,
        "    psum(mesh, sq, GRANT_AXIS)\n    new = stripe | sq\n",
        "    summed = psum(mesh, sq, GRANT_AXIS)\n    new = stripe | sq | summed\n",
    )
    found = run_lint({rel: planted, **mesh}, rules=["donation-hazard"]).findings
    assert len(found) == 1 and "'sq' read after psum()" in found[0].message


# ------------------------------------------------------- exit-contract


def test_exit_contract_planted_in_the_real_cli(tmp_path):
    """The real ``cli.py`` with its ``cmd_lint`` handler stripped of its
    ``except KvTpuError`` wrapper: the ConfigError a bad ``--rules`` id
    raises escapes the handler."""
    errors = {"resilience/errors.py": _real("resilience/errors.py")}
    sources = {
        "cli.py": _real("cli.py"),
        "analysis/__init__.py": _real("analysis/__init__.py"),
        "analysis/core.py": _real("analysis/core.py"),
        **errors,
    }
    before = {f.line for f in run_lint(sources, rules=["exit-contract"]).findings}
    planted = _plant(
        tmp_path, "cli.py",
        "    try:\n        return run_from_args(args)\n    except KvTpuError as e:\n"
        "        return _diagnose(args, e)\n",
        "    return run_from_args(args)\n",
    )
    found = run_lint({**sources, "cli.py": planted}, rules=["exit-contract"]).findings
    new = [f for f in found if f.line not in before]
    assert len(new) == 1 and "cmd_lint()" in new[0].message
    assert "ConfigError" in new[0].message


def test_exit_contract_matches_the_jax_rule_on_the_ports_cli():
    """The copied rule gives the JAX package's findings on the same
    program (here: the port's command line and the modules it reaches)."""
    rels = ["cli.py", "resilience/errors.py", "analysis/__init__.py",
            "analysis/core.py"]
    sources = {rel: _real(rel) for rel in rels}
    port = run_lint(sources, rules=["exit-contract"]).findings
    jax = jax_analysis.run_lint(sources, rules=["exit-contract"]).findings
    assert [(f.rule, f.path, f.line, f.message) for f in port] == \
        [(f.rule, f.path, f.line, f.message) for f in jax]


# --------------------------------------------------------------- SARIF


def test_sarif_golden():
    """The SARIF 2.1.0 shape is a wire contract with CI annotators —
    golden-filed in the port's shape (driver ``kv-tpu-torch-lint``)."""
    result = run_lint(
        {
            "pkg/work.py": textwrap.dedent(
                """
                from kubernetes_verification_tpu_torch.observe.aot import register_kernel

                def pull(p):
                    return int(p.item())

                def _step(x):
                    raise ValueError("bad")
                    return pull(x)

                _step = register_kernel("eng", "_step", _step)
                """
            )
        },
        rules=["jit-host-sync", "error-taxonomy"],
    )
    got = render_sarif(result)
    doc = json.loads(got)
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "kv-tpu-torch-lint"
    rule_ids = [r["id"] for r in run["tool"]["driver"]["rules"]]
    assert rule_ids == sorted(rule_ids) == ["error-taxonomy", "jit-host-sync"]
    for res in run["results"]:
        assert rule_ids[res["ruleIndex"]] == res["ruleId"]
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uriBaseId"] == "SRCROOT"
        assert loc["region"]["startLine"] >= 1
    assert got + "\n" == _SARIF_GOLDEN, (
        "SARIF output drifted from _SARIF_GOLDEN — if the change is "
        "intentional, run this test body and paste `got` into it"
    )


#: ``render_sarif`` of the fixture above, a wire contract with CI annotators
_SARIF_GOLDEN = r'''{
  "$schema": "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/Schemata/sarif-schema-2.1.0.json",
  "runs": [
    {
      "columnKind": "utf16CodeUnits",
      "results": [
        {
          "level": "error",
          "locations": [
            {
              "physicalLocation": {
                "artifactLocation": {
                  "uri": "pkg/work.py",
                  "uriBaseId": "SRCROOT"
                },
                "region": {
                  "startLine": 8
                }
              }
            }
          ],
          "message": {
            "text": "raise ValueError(...) \u2014 raise a KvTpuError subclass from resilience/errors.py instead"
          },
          "ruleId": "error-taxonomy",
          "ruleIndex": 0
        },
        {
          "level": "error",
          "locations": [
            {
              "physicalLocation": {
                "artifactLocation": {
                  "uri": "pkg/work.py",
                  "uriBaseId": "SRCROOT"
                },
                "region": {
                  "startLine": 9
                }
              }
            }
          ],
          "message": {
            "text": "tensor passed to pull() parameter 'p', which performs int() at pkg/work.py:5 \u2014 stream sync reached from a dispatch function through a helper call; keep the value a tensor through the chain or read it back in the host driver"
          },
          "ruleId": "jit-host-sync",
          "ruleIndex": 1
        }
      ],
      "tool": {
        "driver": {
          "informationUri": "kubernetes_verification_tpu_torch/LINTS.md",
          "name": "kv-tpu-torch-lint",
          "rules": [
            {
              "id": "error-taxonomy",
              "shortDescription": {
                "text": "Package code must raise `KvTpuError` subclasses (`resilience/errors.py`), not bare builtins: a bare `ValueError` three layers deep cannot be mapped to the CLI exit-code contract (0 ok / 1 violations / 2 input error / 3 backend failure) and never carries `transient`/`kind` for the retry/fallback driver."
              }
            },
            {
              "id": "jit-host-sync",
              "shortDescription": {
                "text": "Inside a registered dispatch function (one an `observe.aot.register_kernel`/`transient_kernel` call names \u2014 the port's hot device path), a `.item()`/`.tolist()`/`.cpu()`/`.numpy()`/`bool()`/`int()`/`float()`/`np.asarray` on a device tensor, a Python branch on one, or a `synchronize()` stalls the host until the stream drains: the dispatch stops overlapping the device, every caller pays the round trip, and a batched query loop turns into one sync per call."
              }
            }
          ]
        }
      }
    }
  ],
  "version": "2.1.0"
}
'''


# ------------------------------------------------------------ --changed


def test_changed_package_rels_shapes():
    rels = changed_package_rels(base_ref="HEAD")
    assert rels is not None
    assert rels == sorted(rels)
    assert all(r.endswith(".py") and not r.startswith("..") for r in rels)
    assert changed_package_rels(base_ref="refs/no/such/ref") is None


# -------------------------------------------------------------- metrics


def test_callgraph_metric_families_registered():
    from kubernetes_verification_tpu_torch.observe import REGISTRY
    from kubernetes_verification_tpu_torch.observe.metrics import REQUIRED_FAMILIES

    for fam in ("kvtpu_lint_callgraph_nodes", "kvtpu_lint_callgraph_edges",
                "kvtpu_lint_cache_hits_total"):
        assert fam in REQUIRED_FAMILIES
        assert REGISTRY.get(fam) is not None


def test_build_program_sets_the_ports_callgraph_gauges(tmp_path):
    from kubernetes_verification_tpu_torch.observe.metrics import (
        LINT_CACHE_HITS_TOTAL,
        LINT_CALLGRAPH_EDGES,
        LINT_CALLGRAPH_NODES,
    )

    src = {"a.py": "def f(x):\n    return g(x)\n\ndef g(x):\n    return x\n"}
    cache = str(tmp_path / "c.json")
    _program(src, cache_path=cache)
    assert LINT_CALLGRAPH_NODES.value == 2 and LINT_CALLGRAPH_EDGES.value == 1
    hits = LINT_CACHE_HITS_TOTAL.value
    _program(src, cache_path=cache)
    assert LINT_CACHE_HITS_TOTAL.value == hits + 1
