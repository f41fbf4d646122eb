"""Percent of its roofline that ``packed_dir_allow`` reaches: the least
time its launches could take on this card (``costs.py``, over the real pods
and policies) over the device time the profiler gave them. The kernel is the
``int8_kernel`` instance of the epilogue ``DirEpi``."""
from kvbench import costs


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernels("DirEpi")
    if not launches:
        return None
    ops, nbytes = costs.packed_dir_allow_cost(run.counters["n_policies"], run.counters["n_pods"])
    least = costs.least_seconds(ops, nbytes, run.device_kind)
    if least is None:
        return None
    return 100 * least * len(launches) / sum(e - s for _, s, e in launches)
