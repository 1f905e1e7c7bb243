"""Arithmetic the per-layer metric readers share."""
from __future__ import annotations

from typing import Optional

from benchmark import counters


def stage_mean(run, stage: str) -> Optional[float]:
    """Mean seconds of `stage` over the window's jobs; None where no job
    has it."""
    vals = [j["stages"][stage] for j in run.jobs if stage in j["stages"]]
    return sum(vals) / len(vals) if vals else None


def roofline(run, launches_key: str, kernel_names) -> Optional[float]:
    """% of a kernel's summed least time (``counters.bound_s`` of each
    launch the window's jobs made) over its summed device time in the
    trace.  None without a trace, without launches, or where the trace
    holds another number of the kernel's launches than the jobs made."""
    if run.trace is None:
        return None
    launches = [ln for j in run.jobs for ln in j["launches"].get(
        launches_key, [])]
    if not launches:
        return None
    first = kernel_names[0]
    if run.trace.kernel_count(first) != len(launches):
        return None
    device_s = sum(run.trace.kernel_s(k) for k in kernel_names)
    if device_s <= 0:
        return None
    bound = sum(counters.bound_s(ln["ops"], ln["bytes"], run.dtype)
                for ln in launches)
    return 100.0 * bound / device_s
