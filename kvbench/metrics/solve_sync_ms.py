"""Milliseconds a verification in the program's ``solve.sync`` span, less its
children: the host waiting for the card on the pair count and the isolation
vectors (host clock, from the span log). Read as ``solve_sync_ms.verify``."""
from kvbench import program_spans


def read(run):
    return program_spans.self_ms(run, "solve.sync") if run.kind == "verify" else None
