"""Changes completed over the window's time."""


def read(run):
    if run.kind != "churn" or not run.steps:
        return None
    return len(run.steps) / run.window_s
