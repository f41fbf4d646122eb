"""Percent of the traced window in which no kernel, copy or fill ran on
the card. Read as ``device_idle.<split>`` in the cells its split names."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100 * (1 - run.trace.busy_s() / run.trace.window_s)
