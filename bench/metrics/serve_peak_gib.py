"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start: the index and the serving working set, GiB."""


def read(run):
    return run.serve_peak_bytes / 2**30 if run.serve_peak_bytes else None
