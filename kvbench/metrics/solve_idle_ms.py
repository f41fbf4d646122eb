"""Milliseconds a verification in which the card ran nothing while the host
was inside the program's ``solve`` span: the card waiting for the host within
the solve (device trace, on the span log's clock); nothing on the CPU. Read
as ``solve_idle_ms.verify``."""
from kvbench import program_spans


def read(run):
    return program_spans.idle_ms(run, "solve") if run.kind == "verify" else None
