"""Mean milliseconds a change in the engine's ``engine.dispatch`` span, less
its children: the uploads and launches of the change's patches (host clock,
from the span log). Read as ``change_dispatch_ms.<split>`` in the churn
cells its split names."""
from kvbench import program_spans


def read(run):
    return program_spans.self_ms(run, "engine.dispatch") if run.kind == "churn" else None
