"""Mean milliseconds a change in the engine's ``engine.evaluate`` span, less
its children: the host evaluation of the change (host clock, from the span
log). Read as ``change_evaluate_ms.<split>`` in the churn cells its split
names."""
from kvbench import program_spans


def read(run):
    return program_spans.self_ms(run, "engine.evaluate") if run.kind == "churn" else None
