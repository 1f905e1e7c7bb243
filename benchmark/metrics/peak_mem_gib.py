"""The device memory the window's jobs held at most
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
