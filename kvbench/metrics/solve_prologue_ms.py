"""Milliseconds a verification in the program's ``solve.prologue`` span,
less its children: padding, run-splitting and the VP layout on the host
(host clock, from the span log). Read as ``solve_prologue_ms.verify``."""
from kvbench import program_spans


def read(run):
    return program_spans.self_ms(run, "solve.prologue") if run.kind == "verify" else None
