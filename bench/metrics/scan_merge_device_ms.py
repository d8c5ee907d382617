"""Device time of the program's ``repro.scan`` and ``repro.merge`` spans
(CUDA events around the tiled scan and around the merge), summed over the
traced run's profiled half, over its batches.  Nothing where the program
has no tracer."""

from bench import program_trace


def read(run):
    got = program_trace.per_batch(run)
    if got is None:
        return None
    summary, batches = got
    spans = [summary["spans"].get(n) for n in ("repro.scan", "repro.merge")]
    if any(s is None or s["device_s"] is None for s in spans):
        return None
    return sum(s["device_s"] for s in spans) / batches * 1e3
