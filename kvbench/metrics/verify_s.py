"""Seconds per verification: the whole measured window over the
verifications completed in it."""


def read(run):
    if run.kind != "verify" or not run.steps:
        return None
    return run.window_s / len(run.steps)
