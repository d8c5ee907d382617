"""Host time blocked at the plan's reads of device values (the program's
``repro.sync.plan.*`` spans), summed over the traced run's profiled half,
over its batches.  Nothing where the program has no tracer."""

from bench import program_trace


def read(run):
    got = program_trace.per_batch(run)
    if got is None:
        return None
    summary, batches = got
    return program_trace.sync_wait_s(summary) / batches * 1e3
