"""Queries answered in the window over the window's seconds (host clock)."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.answered / run.window_s
