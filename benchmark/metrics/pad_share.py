"""% of the MoE LM encoder's token slots (rows x longest row of each
forward) that are padding, over the window's jobs (the encoder's
counters)."""


def read(run):
    jobs = [j["lm"] for j in run.jobs if "lm" in j]
    slots = sum(lm["slots"] for lm in jobs)
    if not slots:
        return None
    return 100.0 * sum(lm["padded"] for lm in jobs) / slots
