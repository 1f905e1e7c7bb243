"""Kernel 2 (``csrc/distance.cu``: ``pairwise_tile``, and ``reduce_slices``
where a call splits d): % of its summed bound over its summed device time
in the trace."""
from benchmark.readings import roofline


def read(run):
    return roofline(run, "distance", ("pairwise_tile", "reduce_slices"))
