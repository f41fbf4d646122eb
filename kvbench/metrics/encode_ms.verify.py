"""Mean milliseconds of ``encode_cluster`` per verification (host clock)."""


def read(run):
    if run.kind != "verify" or not run.steps:
        return None
    return 1e3 * sum(s["encode_s"] for s in run.steps) / len(run.steps)
