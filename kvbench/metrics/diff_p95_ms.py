"""The 95th percentile of every change's latency in the window, from the
call to the end of its device synchronisation, in milliseconds."""
from kvbench.stats import percentile


def read(run):
    if run.kind != "churn" or not run.steps:
        return None
    return 1e3 * percentile([s["latency_s"] for s in run.steps], 95)
