"""Milliseconds a verification in the program's ``solve.upload`` span, less
its children: the host operands' transfer to the card (host clock, from the
span log). Read as ``solve_upload_ms.verify``."""
from kvbench import program_spans


def read(run):
    return program_spans.self_ms(run, "solve.upload") if run.kind == "verify" else None
