"""Mean milliseconds from an engine call to its return, before the device
synchronisation: the engine's host work per change (host clock). Read as
``change_host_ms.<split>`` in the churn cells its split names."""


def read(run):
    if run.kind != "churn" or not run.steps:
        return None
    return 1e3 * sum(s["host_s"] for s in run.steps) / len(run.steps)
