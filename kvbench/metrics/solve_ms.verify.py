"""Mean milliseconds of ``tiled_k8s_reach(fetch=False)`` per verification,
through its pair-count synchronisation (host clock)."""


def read(run):
    if run.kind != "verify" or not run.steps:
        return None
    return 1e3 * sum(s["solve_s"] for s in run.steps) / len(run.steps)
