"""Share of the traced run's profiled window in which no kernel, copy or
set runs on the card while the host is inside the program's ``repro.plan``
span (``bench/program_trace.py::reduce``).  Nothing where the program has
no tracer."""


def read(run):
    program = getattr(run, "program", None)
    if not program or not program.get("window_s"):
        return None
    return 100.0 * program["idle_in_plan_s"] / program["window_s"]
