"""% of the card's bf16 peak (989 TFLOP/s) that the MoE LM encoder's
counted FLOPs (``benchmark/lm_counters.py``, real tokens) take over the
device time of the program's ``lm.encode`` ranges in the traced window;
None where the trace holds no such range."""
from benchmark import counters
from benchmark.program_spans import spans


def read(run):
    copies = spans(run, "lm.encode", device=True)
    flops = sum(j.get("lm", {}).get("flops", 0.0) for j in run.jobs)
    seconds = sum(e - s for s, e, _ in copies) * 1e-9
    if not flops or seconds <= 0:
        return None
    return 100.0 * flops / seconds / counters.PEAK_FLOPS["bfloat16"]
