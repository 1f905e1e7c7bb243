"""Device idle seconds while ``models.train.fit``'s loop (its ``fit``
span) is open on the host, the mean over the traced window's jobs."""
from benchmark.program_spans import spans


def read(run):
    fits = spans(run, "fit")
    if not fits or not run.jobs:
        return None
    busy = run.trace.busy_intervals()
    idle = 0
    for f0, f1, _ in fits:
        idle += f1 - f0 - sum(max(0, min(e, f1) - max(s, f0))
                              for s, e in busy)
    return idle * 1e-9 / len(run.jobs)
