"""% of the card's peak (``counters.PEAK_FLOPS`` of the configuration's
precision) that the FLOPs the window's jobs' models need take over the
traced window's wall time."""
from benchmark import counters


def read(run):
    flops = sum(j.get("flops", 0.0) for j in run.jobs)
    if not flops or run.trace is None:
        return None
    return 100.0 * flops / run.trace.window_s / counters.PEAK_FLOPS[run.dtype]
