"""The engine's tracer (``repro_torch.core.spans``): spans and read sites on
the sync RAM executor's path, the stage histograms, and the server's queue
wait.  CPU only; the CUDA event path runs here on stand-in events."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.core import FilterSpec, HybridSpec, build_from_assignments
from repro_torch.core import spans as spans_lib
from repro_torch.core.engine import SearchEngine
from repro_torch.core.serving import SearchServer

N, D, M, KC, Q = 3000, 32, 3, 12, 48
PLAN_SITES = {"plan.route.lo", "plan.route.hi", "plan.provision"}


def _engine(**kw):
    rng = np.random.default_rng(0)
    centres = rng.standard_normal((KC, D)).astype(np.float32)
    topic = (np.arange(N) * KC) // N
    core = centres[topic] + 0.3 * rng.standard_normal((N, D)).astype(
        np.float32)
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    spec = HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32,
                      metric="dot")
    index, _ = build_from_assignments(spec, centres, core, attrs,
                                      topic.astype(np.int32), device="cpu")
    # the benchmark's engine: RAM tier, sync executor, adaptive u_cap
    kw = dict(dict(k=10, n_probes=4, q_block=16, pipeline="off",
                   prune="auto"), **kw)
    return SearchEngine(index, device="cpu", **kw)


def _batch(seed):
    rng = np.random.default_rng(seed)
    queries = torch.from_numpy(rng.standard_normal((Q, D)).astype(np.float32))
    lo = torch.full((Q, 1, M), -32768, dtype=torch.int16)
    hi = torch.full((Q, 1, M), 32767, dtype=torch.int16)
    hi[:, 0, 1] = 7  # attribute 1 below 8: the plan prunes nothing here
    return queries, FilterSpec(lo=lo, hi=hi)


def _serve(engine, n, seed=0):
    """``n`` batches, two in flight, as the benchmark's window sends them."""
    pend = engine.submit(*_batch(seed))
    for i in range(1, n + 1):
        res = engine.result(pend)
        if i < n:
            pend = engine.submit(*_batch(seed + i))
        res.ids.cpu()


def test_off_records_no_span_but_counts_the_plans_reads():
    eng = _engine()
    tr = eng.tracer
    assert not tr.enabled
    for device in (False, True):
        assert tr.span("repro.x", device=device) is spans_lib.NO_SPAN
    _serve(eng, 5)
    assert tr._spans == {}  # nothing recorded, no span opened
    assert dict(tr.reads) == {s: 5 for s in PLAN_SITES}
    assert tr.summary() == dict(spans={}, reads={s: 5 for s in PLAN_SITES})


def test_on_nests_in_the_callers_span_under_the_profiler():
    eng = _engine()
    n = 4
    _serve(eng, 2)  # before the window: not in its summary
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            with eng.tracing():
                _serve(eng, n, seed=10)
    assert not eng.tracer.enabled
    events = prof.events()
    caller = [e for e in events if e.name == "caller"]
    assert len(caller) == 1
    c0, c1 = caller[0].time_range.start, caller[0].time_range.end
    for name in ("repro.plan", "repro.plan.route", "repro.plan.tiles",
                 "repro.plan.provision", "repro.scan", "repro.merge",
                 "repro.sync.plan.route.lo"):
        got = [e for e in events if e.name == name]
        assert len(got) == n, name
        assert all(c0 <= e.time_range.start <= e.time_range.end <= c1
                   for e in got), name
    plans = [e.time_range for e in events if e.name == "repro.plan"]
    for e in events:  # the plan's steps inside a plan span
        if e.name.startswith(("repro.plan.", "repro.sync.plan.")):
            assert any(p.start <= e.time_range.start
                       and e.time_range.end <= p.end for p in plans), e.name
    s = eng.tracer.summary()
    assert s["reads"] == {site: n for site in PLAN_SITES}
    for name in ("repro.plan", "repro.plan.route", "repro.scan",
                 "repro.merge", "repro.sync.plan.provision"):
        assert s["spans"][name]["count"] == n
        assert s["spans"][name]["host_s"] > 0
    # on the CPU a device span's time is its host time
    for name in ("repro.scan", "repro.merge", "repro.plan.tiles"):
        sp = s["spans"][name]
        assert sp["device_s"] == pytest.approx(sp["host_s"])
    assert s["spans"]["repro.plan"]["device_s"] is None
    plan = s["spans"]["repro.plan"]["host_s"]
    assert plan >= sum(s["spans"][f"repro.sync.{site}"]["host_s"]
                       for site in PLAN_SITES)


def test_summary_covers_the_window_alone():
    eng = _engine()
    with eng.tracing():
        _serve(eng, 3)
    _serve(eng, 2)  # off: counted reads, no spans
    s = eng.tracer.summary()
    assert s["spans"]["repro.plan"]["count"] == 3
    assert s["reads"]["plan.provision"] == 5  # reads count always
    with eng.tracing():
        _serve(eng, 1)
    s = eng.tracer.summary()
    assert s["spans"]["repro.plan"]["count"] == 1
    assert s["reads"] == {site: 1 for site in PLAN_SITES}


@pytest.mark.parametrize("tracing", [False, True])
def test_stage_histograms_still_observed_on_the_cpu(tracing):
    eng = _engine()
    keys = None
    with eng.tracing() if tracing else spans_lib.NO_SPAN:
        _serve(eng, 3)
        keys = set(eng.metrics())
    for stage in ("plan", "scan", "merge"):
        assert eng.tracer.stages[stage].total == 3, stage
    text = eng.metrics_text()
    for stage in ("plan", "scan", "merge"):
        assert f'stage="{stage}"' in text
    for site in PLAN_SITES:
        assert f'repro_host_reads_total{{site="{site}"}} 3' in text
    assert "# TYPE repro_host_reads_total counter" in text
    assert ('repro_span_total{span="repro.plan"} 3' in text) == tracing
    # nothing of the tracer enters metrics()
    assert not any("read" in k or "span" in k for k in keys)
    with eng.tracing():
        _serve(eng, 1)
    assert set(eng.metrics()) == keys


class _Event:
    """A stand-in for ``torch.cuda.Event`` on one stream: completes when
    told to, and waiting for one completes every earlier one."""

    clock = 0.0
    done_until = 0.0

    def __init__(self, enable_timing=False):
        self.t = None
        self.done = False

    def record(self):
        _Event.clock += 1.0
        self.t = _Event.clock
        self.done = False

    def query(self):
        return self.done or self.t <= _Event.done_until

    def synchronize(self):
        _Event.done_until = max(_Event.done_until, self.t)

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3  # ms: one second a tick


def test_cuda_spans_resolve_lazily_and_off_observes_nothing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    tr = spans_lib.Tracer("cuda")
    # off: a device stage is the null context and observes nothing
    with tr.span("repro.scan", device=True, stage="scan"):
        pass
    assert "scan" not in tr.stages
    with tr.span("repro.plan", stage="plan"):  # a host stage: always
        pass
    assert tr.stages["plan"].total == 1
    tr.enable()
    for _ in range(3):
        with tr.span("repro.scan", device=True, stage="scan"):
            pass
    assert len(tr._pending) == 3  # no event has completed: none read
    assert "scan" not in tr.stages
    first = tr._pending[0][3]
    first.done = True
    with tr.span("repro.merge", device=True, stage="merge"):
        pass
    assert len(tr._pending) == 3  # the oldest resolved, the new one waits
    assert tr.stages["scan"].total == 1 and tr.stages["scan"].sum == 1.0
    tr.disable()
    s = tr.summary()  # resolves the rest with one wait
    assert not tr._pending
    assert s["spans"]["repro.scan"] == dict(
        count=3, host_s=s["spans"]["repro.scan"]["host_s"], device_s=3.0)
    assert s["spans"]["repro.merge"]["device_s"] == 1.0
    assert tr.stages["scan"].total == 3 and tr.stages["merge"].total == 1
    assert len(tr._events) == 8  # every pair back in the pool


def test_cuda_pending_spans_stay_bounded(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    tr = spans_lib.Tracer("cuda")
    with tr.tracing():
        for _ in range(spans_lib.MAX_PENDING + 5):
            with tr.span("repro.scan", device=True):
                pass
        assert len(tr._pending) == spans_lib.MAX_PENDING


def test_server_observes_the_queue_wait():
    seen = threading.Event()

    def search_fn(queries, fspec, shard_ok):
        seen.set()
        q = queries.shape[0]
        return torch.zeros((q, 3)), torch.zeros((q, 3), dtype=torch.int32)

    server = SearchServer(search_fn, batch_size=4, dim=D, n_attrs=M,
                          n_terms=1, n_shards=1, max_wait_s=0.001,
                          device="cpu")
    held = 0.05
    futs = [server.submit(np.zeros(D, np.float32)) for _ in range(2)]
    time.sleep(held)  # the batch is held back: no worker yet
    server.start()
    try:
        for f in futs:
            f.get(timeout=10)
    finally:
        server.stop()
    assert seen.is_set()
    wait = server.stages["queue_wait"]
    assert wait.total == 2
    assert wait.sum >= 2 * held
    text = server.metrics_text()
    assert ('repro_server_stage_latency_seconds_count{stage="queue_wait"} 2'
            in text)
