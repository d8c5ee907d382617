"""The engine's reads of device values to the host in its plan (its
``host_read`` sites ``plan.*``: the filter bounds' two reads in
``_route_partitions`` and ``_provision``'s ``n_unique.max()`` on this path),
counted over the traced run's profiled half, over its batches (the
program's ``repro.plan`` spans).  Nothing where the program has no tracer."""

from bench import program_trace


def read(run):
    got = program_trace.per_batch(run)
    if got is None:
        return None
    summary, batches = got
    reads = sum(n for site, n in summary["reads"].items()
                if site.startswith(program_trace.PLAN_SITES))
    return reads / batches
