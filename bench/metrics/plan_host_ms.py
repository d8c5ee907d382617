"""Host time of the program's ``repro.plan`` span less the time blocked at
its reads (``repro.sync.plan.*``), summed over the traced run's profiled
half, over its batches.  Nothing where the program has no tracer."""

from bench import program_trace


def read(run):
    got = program_trace.per_batch(run)
    if got is None:
        return None
    summary, batches = got
    plan_s = summary["spans"][program_trace.PLAN]["host_s"]
    return (plan_s - program_trace.sync_wait_s(summary)) / batches * 1e3
