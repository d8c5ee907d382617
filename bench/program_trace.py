"""The program's own spans and counters in a run: the engine's tracer
(``repro_torch/core/spans.py``) read over the two-in-flight window.

    python3 bench/program_trace.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--program 0|1]

runs a cell as ``bench/run.py`` does.  With ``--program 1`` the engine's
tracing is on around every two-in-flight window: with ``--trace 1`` that is
the profiled half alone (the spans half stays untraced by the program, so
``plan_ms`` and ``scan_merge_ms`` read as in ``bench/run.py``); with
``--trace 0`` the whole measured window, which prices the tracing against a
run with ``--program 0``.  It prints ``bench/run.py``'s result line, with
:data:`METRICS` added to ``metrics`` when ``--trace 1``.

``bench/harness.py`` does not turn the program's tracing on, so this runner
wraps the harness's window and its trace reduction for the run (see
:func:`program_tracing`).  A program without ``engine.tracer`` runs
untraced and its readers return nothing.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

if __name__ == "__main__":
    import time

    T_START = time.perf_counter()
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

PLAN = "repro.plan"
SYNC = "repro.sync."
PLAN_SITES = "plan."  # the plan's host-read sites
# the program's per-layer metrics, with their units
METRICS = {"plan_host_reads": "reads/batch", "plan_sync_wait_ms": "ms",
           "plan_host_ms": "ms", "scan_merge_device_ms": "ms",
           "idle_in_plan_pct": "%"}


def _union(intervals):
    """Merged, sorted ``[(start, end)]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_inside(window, device, spans) -> int:
    """The length of the part of ``window`` ``(start, end)`` in which no
    ``device`` interval runs and some ``spans`` interval is open (all
    ``(start, end)``, one clock)."""
    ws, we = window
    busy = _union((max(s, ws), min(e, we)) for s, e in device
                  if e > ws and s < we)
    idle, prev = [], ws
    for s, e in busy:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    if we > prev:
        idle.append((prev, we))
    total = 0
    inside = _union((max(s, ws), min(e, we)) for s, e in spans
                    if e > ws and s < we)
    j = 0
    for s, e in idle:  # both sorted and disjoint: one pass
        while j < len(inside) and inside[j][1] <= s:
            j += 1
        k = j
        while k < len(inside) and inside[k][0] < e:
            total += min(e, inside[k][1]) - max(s, inside[k][0])
            k += 1
    return total


def reduce(prof, window: str) -> dict:
    """``idle_in_plan_s`` and ``window_s`` of a finished ``torch.profiler``
    run whose measured window is the ``record_function`` span ``window``:
    the device's kernels, copies and sets as ``bench/trace.py`` takes them
    (user annotations and the host spans' copies on the device timeline
    left out), the host's ``repro.plan`` spans."""
    from torch.autograd import DeviceType

    win, plans, device, marks = None, [], [], {window}
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CPU:
            name = e.name()
            if name == window:
                win = (e.start_ns(), e.end_ns())
            elif name == PLAN:
                plans.append((e.start_ns(), e.end_ns()))
            if e.is_user_annotation():
                marks.add(name)
        elif kind == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name()))
    if win is None:
        raise RuntimeError(f"the trace holds no {window!r} span")
    device = [(s, e) for s, e, n in device if n not in marks]
    return dict(idle_in_plan_s=idle_inside(win, device, plans) * 1e-9,
                window_s=(win[1] - win[0]) * 1e-9)


@contextlib.contextmanager
def program_tracing(on: bool = True):
    """For the block, the engine's tracing on around every
    ``harness._window`` (the two-in-flight loop) and the profiler's events
    reduced by :func:`reduce` beside ``bench/trace.py``'s reduction.
    Yields a dict that gains ``summary`` (the tracer's, taken before the
    harness closes the system) and :func:`reduce`'s numbers."""
    from bench import harness, trace

    got = {}
    window, trace_reduce = harness._window, trace.reduce

    def traced_window(system, *args, **kwargs):
        tracer = getattr(system.engine, "tracer", None)
        if not on or tracer is None:
            return window(system, *args, **kwargs)
        with tracer.tracing():
            out = window(system, *args, **kwargs)
        got["summary"] = tracer.summary()
        return out

    def reduce_both(prof, name, **kwargs):
        if "summary" in got:
            got.update(reduce(prof, name))
        return trace_reduce(prof, name, **kwargs)

    harness._window, trace.reduce = traced_window, reduce_both
    try:
        yield got
    finally:
        harness._window, trace.reduce = window, trace_reduce


def per_batch(run):
    """``(summary, batches)`` of the program's window in ``run`` (batches:
    its ``repro.plan`` spans), or None where the run holds none."""
    program = getattr(run, "program", None)
    summary = program.get("summary") if program else None
    if not summary:
        return None
    batches = summary["spans"].get(PLAN, {}).get("count", 0)
    return (summary, batches) if batches else None


def sync_wait_s(summary) -> float:
    """Host seconds blocked at the plan's reads (``repro.sync.plan.*``)."""
    return sum(s["host_s"] for name, s in summary["spans"].items()
               if name.startswith(SYNC + PLAN_SITES))


def main(argv=None) -> int:
    import argparse
    import json

    import torch

    from bench import harness, spec
    from bench import run as bench_run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 1
    bench = spec.benchmark()
    cell = spec.cell(bench, args.workload)
    traced = bool(args.trace)
    with program_tracing(bool(args.program)) as got:
        run, readings = harness.run_cell(
            spec.config(bench, cell["config"]), spec.traffic(cell["traffic"]),
            args.seed, args.seconds, traced, "cuda", T_START)
    run.program = got
    bad = bench_run.loaded_forbidden()
    if bad:
        print(f"the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"]}
    out = bench_run.result_line(cell, bench, run, readings,
                                spec.limits(cell["name"]), traced, device)
    if traced:
        for name, unit in METRICS.items():
            value = spec.reader(name)(run)
            if value is not None:
                out["metrics"][name] = {"value": value, "unit": unit}
        if got.get("summary"):
            out["program"] = got["summary"]
    out["checks"] = out.pop("checks")  # last, as in bench/run.py
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
