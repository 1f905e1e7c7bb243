"""The 99th percentile of the training steps' device milliseconds that
``step_ms`` takes the median of (``statistics.quantiles``, inclusive);
None where it reads None or holds under two steps."""
import statistics

from benchmark.program_spans import step_seconds


def read(run):
    steps = step_seconds(run)
    if steps is None or len(steps) < 2:
        return None
    return 1e3 * statistics.quantiles(steps, n=100, method="inclusive")[98]
