"""What every loop shares: a run's record, its context, and the helpers.

A mix file (``traffic/<name>.json``) names its loop and holds its
parameters; the loop is ``loops/<loop>.py``, found by that name, with a
``run(ctx) -> Run``. A configuration file (``configs/<name>.json``) holds the
deployment and the program's entry points. A loop builds the inputs from the
seed, warms up, drives the measured window, then judges what the window
produced against ``reference.py``.
"""
from __future__ import annotations

import gc
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import reference
from .trace import Trace


@dataclass
class Run:
    """One run's record: what the metric readers and the checks read."""

    kind: str
    device_kind: str
    setup_s: float = 0.0
    window_s: float = 0.0
    #: per step: ``{"encode_s", "solve_s"}`` (verify) or ``{"op", "host_s",
    #: "latency_s"}`` (churn)
    steps: List[Dict] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    counters: Dict[str, float] = field(default_factory=dict)
    trace: Optional[Trace] = None
    #: name → (value, limit) of each number compared with the reference
    checks: Dict[str, tuple] = field(default_factory=dict)


@dataclass
class Context:
    config: Dict
    mix: Dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    #: for the tests and the control, never a benchmark run: ``"control"``
    #: puts the configuration's control (the reference with one guarantee
    #: broken) in place of the program's answers where they are produced;
    #: the planted faults are ``"unchanged"`` (a step returns its state
    #: unchanged), ``"half"`` (half of the rows, or of the pod relabels,
    #: left out) and ``"altered"`` (one answer bit flipped where it is
    #: produced)
    fault: Optional[str] = None


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak(dev: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def device_kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sample_rows(n: int, stride: int, seed) -> np.ndarray:
    """One source row drawn from every block of ``stride`` pods."""
    rng = random.Random(f"{seed}:rows")
    return np.asarray([b + rng.randrange(min(stride, n - b)) for b in range(0, n, stride)],
                      dtype=np.int64)


def setup_done(ctx: Context, run: Run) -> None:
    """Close set-up: long-lived objects leave the collector's young
    generations, so collections in the window walk only what it makes."""
    gc.collect()
    gc.freeze()
    run.setup_s = time.perf_counter() - ctx.t0


def control_answer(ctx: Context, cluster: Dict, rows: np.ndarray, width: int):
    """The control's answer for ``rows`` of ``cluster``, in the program's
    form: ``(packed int32 [len(rows), width] words, ingress, egress
    isolation)``."""
    cfg = ctx.config
    ii, ie, reach = reference.solve_rows(cluster, rows, compute_ports=cfg["compute_ports"],
                                         device=ctx.device, control=cfg["control"])
    return reference.pack_rows(reach, width), ii, ie


def judge(run: Run, limits: Dict[str, float], numbers: Dict[str, int]) -> None:
    for name, value in numbers.items():
        run.checks[name] = (value, limits[name])
