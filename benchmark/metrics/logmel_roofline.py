"""Kernel 1 (``csrc/logmel.cu``, kernel ``mel_db_cluster``): % of its
summed bound (bytes at 3.35 TB/s, or operations at the peak) over its
summed device time in the trace."""
from benchmark.readings import roofline


def read(run):
    return roofline(run, "logmel", ("mel_db_cluster",))
