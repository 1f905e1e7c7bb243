"""Median device milliseconds of a step's optimizer update (Adam): the
duration of each ``fit.update`` range's device copy."""
import statistics

from benchmark.program_spans import spans


def read(run):
    updates = spans(run, "fit.update", device=True)
    if not updates:
        return None
    return 1e3 * statistics.median((e - s) * 1e-9 for s, e, _ in updates)
