"""The MoE LM's routed experts: % of their least time (``counters.bound_s``
of the window's routed work, ``lm_counters.experts_work``: ops from the
routing counters, bytes the experts' weights read and the slots'
activations in and out, at the bf16 peak) over the device time of the
program's ``lm.moe.experts`` ranges; None where the trace holds none."""
from benchmark import counters, lm_counters
from benchmark.program_spans import spans


def read(run):
    copies = spans(run, "lm.moe.experts", device=True)
    seconds = sum(e - s for s, e, _ in copies) * 1e-9
    jobs = [j["lm"] for j in run.jobs if "lm" in j]
    if not jobs or seconds <= 0:
        return None
    bound = 0.0
    for lm in jobs:
        work = lm_counters.experts_work(lm["config"], lm["expert_slots"])
        bound += counters.bound_s(work["ops"], work["bytes"], "bfloat16")
    return 100.0 * bound / seconds
