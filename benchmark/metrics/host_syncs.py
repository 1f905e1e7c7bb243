"""Times a job's host waits on the device: the program's ``sync.*`` spans
in the traced window over its jobs; None where the trace holds no span
of the program."""
from benchmark.program_spans import of_run


def read(run):
    prog = of_run(run)
    if prog is None or not prog.host or not run.jobs:
        return None
    syncs = sum(1 for _, _, n in prog.host if n.startswith("sync."))
    return syncs / len(run.jobs)
