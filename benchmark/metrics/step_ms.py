"""Median device milliseconds of a training step in ``models.train.fit``:
from the previous step's optimizer update (``fit.update``'s device copy)
ending to this step's, each fit's first step left out; None where the
update copies and the ``fit.step`` spans differ in number."""
import statistics

from benchmark.program_spans import step_seconds


def read(run):
    steps = step_seconds(run)
    return None if steps is None else 1e3 * statistics.median(steps)
