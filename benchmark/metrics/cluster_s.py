"""Seconds of a job's `cluster` stage, the mean over the traced window's jobs
(each stage ends in a synchronize)."""
from benchmark.readings import stage_mean


def read(run):
    return stage_mean(run, "cluster")
