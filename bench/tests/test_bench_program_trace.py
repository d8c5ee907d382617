"""The program's spans and counters as the benchmark reads them:
``bench/program_trace.py``'s reduction and runner hooks, and the readers of
its five per-layer metrics."""

import pytest

from bench import harness, program_trace, spec, trace
from bench.tests import tiny

# a made-up window of 4 batches
SUMMARY = {
    "spans": {
        "repro.plan": {"count": 4, "host_s": 0.012, "device_s": None},
        "repro.sync.plan.route.lo": {"count": 4, "host_s": 0.006,
                                     "device_s": None},
        "repro.sync.plan.route.hi": {"count": 4, "host_s": 0.0004,
                                     "device_s": None},
        "repro.sync.plan.provision": {"count": 4, "host_s": 0.0008,
                                      "device_s": None},
        "repro.sync.term.kth": {"count": 2, "host_s": 1.0, "device_s": None},
        "repro.scan": {"count": 4, "host_s": 0.001, "device_s": 0.02},
        "repro.merge": {"count": 4, "host_s": 0.001, "device_s": 0.004},
    },
    "reads": {"plan.route.lo": 4, "plan.route.hi": 4, "plan.provision": 4,
              "result.partition_rows": 4},
}
WANT = {"plan_host_reads": 3.0, "plan_sync_wait_ms": 1.8,
        "plan_host_ms": 1.2, "scan_merge_device_ms": 6.0,
        "idle_in_plan_pct": 25.0}


def _run(program=None):
    run = harness.Run(setup_s=1.0, window_s=1.0, batches=4, queries=128,
                      answered=128, latencies=[], spans={}, scanned=0,
                      serve_peak_bytes=0, memory_peak_bytes=0)
    if program is not None:
        run.program = program
    return run


@pytest.mark.parametrize("name", sorted(program_trace.METRICS))
def test_reader_reads_nothing_without_the_programs_summary(name):
    read = spec.reader(name)
    assert read(_run()) is None
    assert read(_run({})) is None


@pytest.mark.parametrize("name", sorted(program_trace.METRICS))
def test_reader_on_a_made_up_summary(name):
    run = _run(dict(summary=SUMMARY, idle_in_plan_s=0.5, window_s=2.0))
    assert spec.reader(name)(run) == pytest.approx(WANT[name])


def test_device_time_needs_timed_spans():
    spans = dict(SUMMARY["spans"])
    spans["repro.merge"] = dict(spans["repro.merge"], device_s=None)
    run = _run(dict(summary=dict(SUMMARY, spans=spans)))
    assert spec.reader("scan_merge_device_ms")(run) is None


@pytest.mark.parametrize("window, device, spans, want", [
    ((0, 100), [], [], 0),
    ((0, 100), [], [(10, 30)], 20),
    # the card busy over part of the plan
    ((0, 100), [(15, 25)], [(10, 30)], 10),
    # overlapping device intervals, spans out of order and overlapping
    ((0, 100), [(0, 20), (10, 40), (60, 70)], [(50, 80), (30, 55)], 30),
    # intervals clipped to the window
    ((10, 50), [(0, 15), (45, 90)], [(0, 12), (40, 60)], 5),
    # a span with the card busy throughout
    ((0, 100), [(0, 100)], [(20, 80)], 0),
])
def test_idle_inside(window, device, spans, want):
    assert program_trace.idle_inside(window, device, spans) == want


def test_program_tracing_covers_the_profiled_half_alone():
    window, reduce = harness._window, trace.reduce
    with program_trace.program_tracing() as got:
        run, readings = tiny.run(tiny.config(), tiny.traffic(), traced=True)
    assert (harness._window, trace.reduce) == (window, reduce)
    summary = got["summary"]
    plans = summary["spans"]["repro.plan"]["count"]
    # the spans half ran untraced by the program: its batches are not here
    assert 0 < plans < run.batches
    assert plans + len(run.spans["plan"]) == run.batches
    assert summary["spans"]["repro.scan"]["count"] == plans
    assert summary["reads"] == {site: plans for site in (
        "plan.route.lo", "plan.route.hi", "plan.provision")}
    assert 0 < got["idle_in_plan_s"] < got["window_s"]
    run.program = got
    for name in program_trace.METRICS:
        assert spec.reader(name)(run) is not None, name
    assert spec.reader("plan_host_reads")(run) == 3.0


def test_program_tracing_off_leaves_the_run_untraced():
    with program_trace.program_tracing(on=False) as got:
        tiny.run(tiny.config(), tiny.traffic(), traced=True)
    assert got == {}
