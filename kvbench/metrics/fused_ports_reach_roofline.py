"""Percent of its roofline that ``fused_ports_reach`` reaches: the least
time its launches could take on this card (``costs.py``, with ``k`` the real
virtual-policy rows the program counts for the window's last snapshot) over
the device time the profiler gave them. The kernel is the ``int8_kernel``
instance of the epilogue ``FusedEpi``."""
from kvbench import costs


def read(run):
    if run.trace is None or "vp_rows" not in run.counters:
        return None
    launches = run.trace.kernels("FusedEpi")
    if not launches:
        return None
    ops, nbytes = costs.fused_ports_reach_cost(
        run.counters["n_pods"], run.counters["vp_rows"], run.counters["k_padded"])
    least = costs.least_seconds(ops, nbytes, run.device_kind)
    if least is None:
        return None
    return 100 * least * len(launches) / sum(e - s for _, s, e in launches)
