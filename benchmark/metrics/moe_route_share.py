"""% of the MoE LM encoder's device time (its ``lm.encode`` ranges) spent
in routing (``lm.moe.route``: gate, top-k, the permutation and its host
wait on the counts) and in the combine (``lm.moe.combine``); None where
the trace holds no ``lm.encode`` range."""
from benchmark.program_spans import spans


def _seconds(run, name):
    return sum(e - s for s, e, _ in spans(run, name, device=True)) * 1e-9


def read(run):
    total = _seconds(run, "lm.encode")
    if total <= 0:
        return None
    return 100.0 * (_seconds(run, "lm.moe.route")
                    + _seconds(run, "lm.moe.combine")) / total
