"""The nearest-rank 95th percentile over every batch of the window of the
time from its ``submit`` to its ids and scores on the host (host clock)."""

import math


def read(run):
    if not run.latencies:
        return None
    s = sorted(run.latencies)
    return s[max(math.ceil(0.95 * len(s)) - 1, 0)] * 1e3
