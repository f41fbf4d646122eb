"""Shared helpers of the command-line parity tests
(``tests/test_torch_cli*.py``): one argv through the JAX package's
``kv-tpu`` (pinned to the CPU by ``tests/conftest.py``) and through the
port's ``kv-tpu-torch`` with ``--device cpu``, each writing under its own
output root, and the two outputs compared as parsed JSON.

Comparisons are exact after the recorded differences: timing keys
(``timings``, ``seconds``, ``*_s``, ``*_ms``, and the wall-clock stamps
``ts``, ``*_ts``, ``*_seconds``) are dropped, each package's
output root reads ``<root>``, the prog name ``kv-tpu-torch`` reads
``kv-tpu``, and backend labels map through ``backend_map`` (the JAX
package's ``tpu`` is the port's ``torch``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, Optional

from kubernetes_verification_tpu.cli import main as jax_main
from kubernetes_verification_tpu_torch.cli import main as port_main

#: the subcommands that build tensors: the port's take ``--device``
DEVICE_CMDS = frozenset(
    {"verify", "snapshot", "diff", "explain", "serve", "warmup", "query", "lb"}
)
TIMING_KEYS = frozenset({"timings", "seconds", "ts"})
TIMING_SUFFIXES = ("_s", "_ms", "_seconds", "_ts")


def is_timing(key: str) -> bool:
    """A duration or a wall-clock stamp: ``timings``, ``seconds``, ``ts``
    and ``*_s``, ``*_ms``, ``*_seconds``, ``*_ts``."""
    return key in TIMING_KEYS or key.endswith(TIMING_SUFFIXES)


def strip_timings(obj):
    """``obj`` without any timing key, at any depth."""
    if isinstance(obj, dict):
        return {k: strip_timings(v) for k, v in obj.items() if not is_timing(k)}
    if isinstance(obj, list):
        return [strip_timings(v) for v in obj]
    return obj


@dataclasses.dataclass
class Run:
    rc: object  # int exit code, or a SystemExit's message
    out: str
    err: str

    def json(self, line: int = -1):
        """The output's JSON document (the whole output, else one line)."""
        try:
            return json.loads(self.out)
        except ValueError:
            return json.loads(self.out.strip().splitlines()[line])


def run(main: Callable, argv, capsys) -> Run:
    capsys.readouterr()
    try:
        rc = main(list(argv))
    except SystemExit as e:
        rc = e.code if e.code is not None else 0
    cap = capsys.readouterr()
    return Run(rc, cap.out, cap.err)


def _normalise(text: str, root: str) -> str:
    return text.replace(root, "<root>").replace("kv-tpu-torch", "kv-tpu")


def port_argv(argv) -> list:
    argv = list(argv)
    if argv and argv[0] in DEVICE_CMDS:
        argv += ["--device", "cpu"]
    return argv


class Pair:
    """Run argvs through both packages, each under its own output root.

    An argv's ``{root}`` is replaced by the package's root: a
    ``<tmp>/jax`` or ``<tmp>/port`` directory, so chained commands (a
    snapshot, then a diff of it) each read what their own package wrote."""

    def __init__(self, tmp_path, capsys):
        self.capsys = capsys
        self.roots: Dict[str, str] = {}
        for name in ("jax", "port"):
            root = tmp_path / name
            root.mkdir(exist_ok=True)
            self.roots[name] = str(root)

    def argv(self, name: str, argv) -> list:
        out = [str(a).replace("{root}", self.roots[name]) for a in argv]
        return port_argv(out) if name == "port" else out

    def run(self, argv, *, extra_port=(), port_subst=None) -> Dict[str, Run]:
        """Both packages' runs of ``argv``, outputs and messages normalised;
        ``port_subst`` replaces argv tokens for the port only."""
        runs = {}
        for name, main in (("jax", jax_main), ("port", port_main)):
            a = self.argv(name, argv)
            if name == "port":
                a = [(port_subst or {}).get(x, x) for x in a] + list(extra_port)
            r = run(main, a, self.capsys)
            root = self.roots[name]
            rc = _normalise(r.rc, root) if isinstance(r.rc, str) else r.rc
            runs[name] = Run(rc, _normalise(r.out, root), _normalise(r.err, root))
        return runs

    def same(self, argv, *, line: Optional[int] = None, backend_map=None,
             drop=(), extra_port=(), port_subst=None):
        """Run ``argv`` through both packages and assert equal exit codes and
        equal JSON after the recorded differences; returns the port's
        document (or None for a run that printed none)."""
        runs = self.run(argv, extra_port=extra_port, port_subst=port_subst)
        j, p = runs["jax"], runs["port"]
        assert j.rc == p.rc, (argv, j.rc, p.rc, j.err[-2000:], p.err[-2000:])
        if not j.out.strip():
            assert not p.out.strip(), (argv, p.out)
            return None
        jd = j.json() if line is None else j.json(line)
        pd = p.json() if line is None else p.json(line)
        jd, pd = strip_timings(jd), strip_timings(pd)
        if backend_map:
            jd = map_backend(jd, backend_map)
        for key in drop:
            jd.pop(key, None)
            pd.pop(key, None)
        assert pd == jd, (argv, first_difference(jd, pd))
        return pd

    def same_text(self, argv, *, extra_port=()) -> str:
        """Run ``argv`` through both packages and assert equal exit codes and
        equal text output (normalised); returns the port's output."""
        runs = self.run(argv, extra_port=extra_port)
        j, p = runs["jax"], runs["port"]
        assert j.rc == p.rc, (argv, j.rc, p.rc, j.err[-2000:], p.err[-2000:])
        assert p.out == j.out, (argv, j.out[-2000:], p.out[-2000:])
        return p.out


def map_backend(doc, mapping: dict):
    if isinstance(doc, dict):
        return {
            k: (mapping.get(v, v) if k == "backend" and isinstance(v, str)
                else map_backend(v, mapping))
            for k, v in doc.items()
        }
    if isinstance(doc, list):
        return [map_backend(v, mapping) for v in doc]
    return doc


def first_difference(a, b, path="$"):
    """The first path at which two JSON documents differ, with both values."""
    if type(a) is not type(b):
        return path, a, b
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b), key=str):
            if k not in a or k not in b:
                return f"{path}.{k}", a.get(k, "<missing>"), b.get(k, "<missing>")
            d = first_difference(a[k], b[k], f"{path}.{k}")
            if d:
                return d
        return None
    if isinstance(a, list):
        if len(a) != len(b):
            return f"{path}[len]", len(a), len(b)
        for i, (x, y) in enumerate(zip(a, b)):
            d = first_difference(x, y, f"{path}[{i}]")
            if d:
                return d
        return None
    return None if a == b else (path, a, b)
