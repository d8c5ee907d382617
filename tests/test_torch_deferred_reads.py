"""The plan's deferred reads (``repro_torch.core.hostcopy`` and the engine's
use of it): on the card the plan copies the filter bounds and the u_cap
cut's unique count to the host without a wait, and the engine reads them
where they are first needed.  CPU only: the queue runs on stand-in
completions, and the engine's deferred path runs on the CPU with its
switch forced on (a host copy there is made at once); the card runs the
same path in ``tests/test_torch_gpu.py``."""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import FilterSpec, HybridSpec, build_from_assignments
from repro_torch.core import hostcopy
from repro_torch.core import partitions as tpart
from repro_torch.core.engine import SearchEngine

N, D, M, KC, Q, QB = 3000, 32, 3, 24, 40, 16
PLAN_SITES = {"plan.route.lo", "plan.route.hi", "plan.provision"}
DEFERRED_SITES = {"result.provision", "result.traffic"}


class _Flag:
    """A stand-in completion: done when told, or when waited for."""

    def __init__(self):
        self.done = False
        self.waits = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += not self.done
        self.done = True


class _Reads:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return contextlib.nullcontext()


def _copy(value, done=None):
    return hostcopy.HostCopy((torch.tensor(value),),
                             hostcopy.DONE if done is None else done)


def test_queue_feeds_in_order_waiting_only_for_what_is_due():
    seen, reads = [], _Reads()
    obs = hostcopy.DeferredObserver(lambda a: seen.append(int(a)), reads)
    flags = [_Flag() for _ in range(4)]
    tickets = [obs.put(_copy(i, f)) for i, f in enumerate(flags)]
    assert tickets == [0, 1, 2, 3] and len(obs) == 4 and seen == []
    flags[2].done = True  # landed, but behind one that has not
    assert obs.drain(upto=0) == 1  # the due one waited; 1 has not landed
    assert seen == [0] and flags[0].waits == 1 and flags[1].waits == 0
    flags[1].done = True
    assert obs.drain(upto=0) == 2  # nothing due; the landed ones in order
    assert seen == [0, 1, 2] and flags[2].waits == 0
    assert obs.drain(upto=3) == 1 and flags[3].waits == 1
    assert seen == [0, 1, 2, 3] and len(obs) == 0 and reads.n == 4
    assert obs.drain() == 0


def test_queue_feeds_everything_when_drained_whole_and_stays_bounded():
    seen = []
    obs = hostcopy.DeferredObserver(lambda a: seen.append(int(a)), limit=3)
    flags = [_Flag() for _ in range(5)]
    for i, f in enumerate(flags):
        obs.put(_copy(i, f))
        assert len(obs) <= 3
    assert seen == [0, 1] and flags[0].waits == flags[1].waits == 1
    assert obs.drain() == 3
    assert seen == [0, 1, 2, 3, 4] and all(f.done for f in flags)


def test_host_copies_of_host_tensors_are_made_at_once():
    src = torch.arange(6, dtype=torch.int16).reshape(2, 3)
    copy = hostcopy.host_copies((src, src.max()))
    src[0, 0] = 99  # the copy is the value at the call
    assert copy.ready() and copy.done is hostcopy.DONE
    got = copy.wait()
    np.testing.assert_array_equal(got[0], [[0, 1, 2], [3, 4, 5]])
    assert int(got[1]) == 5


def _index(attach=False):
    rng = np.random.default_rng(0)
    centres = rng.standard_normal((KC, D)).astype(np.float32)
    topic = (np.arange(N) * KC) // N
    core = centres[topic] + 0.3 * rng.standard_normal((N, D)).astype(
        np.float32)
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    # attribute 0 a timestamp banded by topic: a window prunes clusters
    attrs[:, 0] = topic * 100 + rng.integers(0, 100, N)
    spec = HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32,
                      metric="dot")
    index, _ = build_from_assignments(spec, centres, core, attrs,
                                      topic.astype(np.int32), device="cpu")
    if attach:
        index = tpart.attach(index, tpart.build_partitions(index,
                                                           attrs=[0]))
    return index


def _batch(seed, kind):
    """``kind``: "none" (no filter), "terms" (two terms on attributes 1
    and 2) or "window" (a time window on attribute 0: the plan prunes)."""
    rng = np.random.default_rng(seed)
    queries = torch.from_numpy(rng.standard_normal((Q, D)).astype(np.float32))
    lo = torch.full((Q, 2, M), -32768, dtype=torch.int16)
    hi = torch.full((Q, 2, M), 32767, dtype=torch.int16)
    if kind == "terms":
        hi[:, 0, 1] = 7
        lo[:, 1, 2] = 9
    elif kind == "window":
        start = torch.from_numpy(rng.integers(0, KC * 100 - 150, Q))
        lo[:, 0, 0], hi[:, 0, 0] = start, start + 149
        lo[:, 1], hi[:, 1] = 1, 0  # a void second term
    else:
        lo[:, 1], hi[:, 1] = 1, 0
    return queries, FilterSpec(lo=lo, hi=hi)


def _engine(index, defer, **kw):
    kw = dict(dict(k=10, n_probes=4, q_block=QB, pipeline="off",
                   prune="auto"), **kw)
    eng = SearchEngine(index, device="cpu", **kw)
    eng._defer_reads = defer  # the card's path, on the CPU
    return eng


def _two_in_flight(eng, batches):
    """The benchmark's loop: batch i+1 submitted before i's answers are
    read."""
    out = []
    pend = eng.submit(*batches[0])
    for i in range(len(batches)):
        res = eng.result(pend)
        if i + 1 < len(batches):
            pend = eng.submit(*batches[i + 1])
        out.append(res)
    return out


def _assert_same(a, b):
    for f in ("scores", "ids", "n_scanned", "n_passed", "n_pruned"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("kind", ["none", "terms", "window"])
def test_deferred_plan_reads_nothing_and_answers_as_before(kind):
    index = _index()
    batches = [_batch(s, kind) for s in range(5)]
    before = _engine(index, False)
    want = [before.search(*b) for b in batches]
    eng = _engine(index, True)
    got = _two_in_flight(eng, batches)
    for w, g in zip(want, got):
        _assert_same(w, g)
    n = len(batches)
    assert dict(eng.tracer.reads) == {s: n for s in DEFERRED_SITES}
    assert dict(before.tracer.reads) == {s: n for s in PLAN_SITES}
    assert eng.stats.sync_free_plans == n == eng.stats.batches
    assert before.stats.sync_free_plans == 0
    # the deferred cut lands on the plan-time cut's bucket
    assert eng.stats.u_cap_hist == before.stats.u_cap_hist
    assert eng.stats.last_u_cap == before.stats.last_u_cap
    full = min(QB * 4, KC)
    assert (eng.stats.last_u_cap < full) == (kind == "window")
    assert eng.traffic.stats() == before.traffic.stats()


def test_deferred_cut_waits_for_the_tables_first_use():
    index = _index()
    eng = _engine(index, True)
    plan = eng.plan(*_batch(1, "window"))
    full = min(QB * 4, KC)
    assert plan.u_max is not None and plan.u_cap == full
    assert eng.stats.u_cap_hist == {}
    operands = eng.fetch(plan)  # the first use cuts
    assert plan.u_max is None and plan.u_cap < full
    assert operands[0].shape[0] == plan.n_tiles * plan.u_cap
    eng.provision(plan)  # once only
    assert eng.stats.u_cap_hist == {plan.u_cap: 1}
    assert eng.tracer.reads["result.provision"] == 1
    res = eng.scan_merge(plan, operands)
    _assert_same(_engine(index, False).search(*_batch(1, "window")), res)


def test_traffic_observes_each_planned_batch_in_order(monkeypatch):
    seen = []
    observe = tpart.FilterTrafficRecorder.observe

    def recording(self, lo, hi):
        seen.append((np.array(lo), np.array(hi)))
        return observe(self, lo, hi)

    monkeypatch.setattr(tpart.FilterTrafficRecorder, "observe", recording)
    index = _index()
    kinds = ["terms", "window", "none", "terms", "window", "none"]
    batches = [_batch(s, k) for s, k in enumerate(kinds)]
    before = _engine(index, False)
    for b in batches:
        before.plan(*b)  # a plan-time recorder sees the batch in its plan
    want, seen[:] = list(seen), []
    eng = _engine(index, True)
    _two_in_flight(eng, batches[:4])
    eng.submit(*batches[4])  # planned, never finished
    eng.plan(*batches[5])
    assert len(seen) == 4  # fed after each batch's scan was enqueued
    rec = eng.traffic  # reading the recorder feeds the rest
    assert len(seen) == len(want) == 6
    for (wl, wh), (gl, gh) in zip(want, seen):
        np.testing.assert_array_equal(wl, gl)
        np.testing.assert_array_equal(wh, gh)
    assert rec.stats() == before.traffic.stats()
    assert eng.metrics()["filter_traffic.queries"] == 6 * Q


def test_close_feeds_the_queue_and_metrics_export_the_share():
    eng = _engine(_index(), True)
    eng.submit(*_batch(0, "terms"))
    assert len(eng._observations) == 1
    eng.close()
    assert len(eng._observations) == 0
    assert eng._traffic.stats()["queries"] == Q
    text = eng.metrics_text()
    assert "# TYPE repro_engine_sync_free_plans counter" in text
    assert "repro_engine_sync_free_plans 1" in text


def test_partitions_off_records_no_traffic():
    eng = _engine(_index(), True, partitions="off")
    res = eng.result(eng.submit(*_batch(0, "terms")))
    assert eng.traffic is None and len(eng._observations) == 0
    assert dict(eng.tracer.reads) == {"result.provision": 1}
    _assert_same(_engine(_index(), False, partitions="off").search(
        *_batch(0, "terms")), res)


@pytest.mark.parametrize("path", ["catalog", "pipeline", "auto_t_max"])
def test_plans_that_need_host_values_keep_their_reads(path):
    """A catalog routes on the bounds in the plan, ``pipeline="on"`` and
    ``t_max="auto"`` read host values there anyway: their plan-time reads
    stay, and the answers are those of the plan-time engine."""
    index = _index(attach=path == "catalog")
    kw = dict(catalog={}, pipeline=dict(pipeline="on"),
              auto_t_max=dict(t_max="auto"))[path]
    kind = "window" if path != "auto_t_max" else "terms"
    batches = [_batch(s, kind) for s in range(3)]
    before = _engine(index, False, **kw)
    want = [before.search(*b) for b in batches]
    eng = _engine(index, True, **kw)
    got = _two_in_flight(eng, batches)
    for w, g in zip(want, got):
        _assert_same(w, g)
    n = len(batches)
    reads = dict(eng.tracer.reads)
    assert eng.stats.sync_free_plans == 0
    if path == "catalog":
        assert eng.stats.partition_hits == before.stats.partition_hits > 0
        assert reads["plan.route.lo"] == reads["plan.route.hi"] == n
        assert reads["result.provision"] == n  # the cut still waits
        assert "result.traffic" not in reads
    else:
        assert reads["plan.provision"] == n
        assert reads["result.traffic"] == n
        assert "plan.route.lo" not in reads
        assert reads.get("plan.tables", 0) == (n if path == "pipeline" else 0)
        assert reads.get("plan.t_max", 0) == (n if path == "auto_t_max"
                                              else 0)
    assert eng.stats.u_cap_hist == before.stats.u_cap_hist
    assert eng.traffic.stats() == before.traffic.stats()
