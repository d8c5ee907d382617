"""The program's ``SearchResult.n_scanned``, mean over the window's
queries: the rows that the plan's probes and pruning leave to scan."""


def read(run):
    return run.scanned / run.answered if run.answered else None
