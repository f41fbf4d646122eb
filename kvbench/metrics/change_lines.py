"""Mean pod rows plus columns a change re-derives: the ``rows`` and ``cols``
counts of the engine's ``engine.evaluate`` spans (from the span log). Read
as ``change_lines.<split>`` in the churn cells its split names."""
from kvbench import program_spans


def read(run):
    if run.kind != "churn":
        return None
    return program_spans.attr_per_step(run, "engine.evaluate", "rows", "cols")
