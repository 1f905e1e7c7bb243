"""% of the card's peak that the window's jobs' counted FLOPs take over the
traced window, each part at its own precision's peak
(``counters.PEAK_FLOPS``): the float32 fit (training and export,
``counters.conv_vae_forward``) at 495 TFLOP/s, the bf16 MoE LM encoder
(``lm_counters.encode_flops``) at 989."""
from benchmark import counters


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    share = 0.0
    for j in run.jobs:
        for dtype, flops in j.get("flops_by_dtype", {}).items():
            share += flops / counters.PEAK_FLOPS[dtype]
    if not share:
        return None
    return 100.0 * share / run.trace.window_s
