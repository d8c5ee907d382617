"""One run of one cell: set-up, the measured window, then the check.

Set-up makes the rows on the device from the seed, hands them to the
program's build, frees them, makes the run's pool of batches and sends
every batch of the pool through the engine once (every shape the window
uses).  The window then cycles through the pool for ``seconds``:

- untraced, two batches in flight: batch i's ``result`` is enqueued before
  batch i+1's ``submit``, and batch i's ids and scores are read to the host
  after it.  A batch's latency runs from its ``submit`` to its answers on
  the host; the window from its start to the last answer.
- traced, in two halves: one batch at a time with no profiler, so that the
  spans partition a batch (``plan``: ``submit``, then a device sync;
  ``scan_merge``: ``result`` to the answers on the host); then the
  untraced loop under ``torch.profiler`` for at most 5 s, for the device's
  busy time and the tiled scan's kernels.

After the window, with the program's state freed, the reference checks
every repeat of a sample of the pool's batches drawn from the seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Optional

import torch

from bench import gen, judge, reference, roofline, trace
from bench.system import System

WINDOW = "bench.window"
PROFILE_S = 5.0  # the most of a traced run's window under the profiler
TILED_OP = "repro_torch::filtered_scan_tiled"


@dataclasses.dataclass
class Run:
    """What a run recorded; every metric reader reads one of these."""
    setup_s: float
    window_s: float
    batches: int
    queries: int
    answered: int
    latencies: list  # seconds a batch, untraced
    spans: dict  # name -> seconds a batch, traced
    scanned: int  # n_scanned summed over the window's queries
    serve_peak_bytes: int
    memory_peak_bytes: int
    trace: Optional[dict] = None
    need_s: Optional[float] = None  # the profiled tiled scans' least time
    setup_parts: Optional[dict] = None  # seconds of each step of set-up


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _to_host(out):
    return tuple(t.cpu() for t in out)


def _no_span(name):
    return contextlib.nullcontext()


def _window(system, pool, seconds, checked, span=_no_span):
    """Two batches in flight for ``seconds`` (and through the whole pool at
    least once): returns ``(window_s,
    latencies, answers by pool batch, queries, answered, scanned)``.
    ``span(name)``: a context around each call into the program."""
    queries, lo, hi = pool
    p = queries.shape[0]
    kept = {j: [] for j in checked}
    lat, scanned, answered = [], 0, 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    t_sub, i = t0, 0
    with span("bench.submit"):
        pend = system.submit(queries[0], lo[0], hi[0])
    while True:
        with span("bench.result"):
            out = system.result(pend)
        t_next = time.perf_counter()
        more = t_next < t_end or i + 1 < p  # at least the pool once
        if more:
            j = (i + 1) % p
            with span("bench.submit"):
                pend = system.submit(queries[j], lo[j], hi[j])
        with span("bench.to_host"):
            host = _to_host(out)
        t_done = time.perf_counter()
        lat.append(t_done - t_sub)
        answered += host[1].shape[0]
        scanned += int(host[2].sum())
        if i % p in kept:
            kept[i % p].append(host)
        if not more:
            break
        t_sub, i = t_next, i + 1
    n_q = (i + 1) * queries.shape[1]
    return t_done - t0, lat, kept, n_q, answered, scanned


def _spans(system, pool, seconds, checked, dev):
    """One batch at a time for ``seconds``, so that the spans partition a
    batch: ``plan`` (``submit``, then a device sync) and ``scan_merge``
    (``result`` to the answers on the host).  Returns ``(spans, answers by
    pool batch, queries, answered, scanned)``."""
    queries, lo, hi = pool
    p = queries.shape[0]
    kept = {j: [] for j in checked}
    spans = {"plan": [], "scan_merge": []}
    scanned = answered = i = 0
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end or i < p:  # at least the pool once
        j = i % p
        a = time.perf_counter()
        pend = system.submit(queries[j], lo[j], hi[j])
        _sync(dev)
        b = time.perf_counter()
        host = _to_host(system.result(pend))
        c = time.perf_counter()
        spans["plan"].append(b - a)
        spans["scan_merge"].append(c - b)
        answered += host[1].shape[0]
        scanned += int(host[2].sum())
        if j in kept:
            kept[j].append(host)
        i += 1
    return spans, kept, i * queries.shape[1], answered, scanned


def _traced_window(system, pool, seconds, checked, dev):
    """The traced run's window: its first half :func:`_spans` with no
    profiler, then :func:`_window` under ``torch.profiler`` for the rest,
    at most :data:`PROFILE_S` (the trace's size and reduction stay small).
    Returns ``(profiler, spans, answers by pool batch, queries, answered,
    scanned, batches profiled)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    spans, kept, n_q, answered, scanned = _spans(system, pool, seconds / 2,
                                                 checked, dev)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            _, _, kept2, n2, a2, s2 = _window(
                system, pool, min(seconds / 2, PROFILE_S), checked,
                record_function)
            _sync(dev)
    for j, reps in kept2.items():
        kept[j] += reps
    return (prof, spans, kept, n_q + n2, answered + a2, scanned + s2,
            n2 // pool[0].shape[1])


def checked_batches(traffic: dict, seed: int, n_pool: int) -> list:
    """The pool batches whose every repeat the reference checks, drawn
    from the seed."""
    n = max(1, min(n_pool, traffic["checked_queries"] // traffic["batch"]))
    g = gen.generator("cpu", seed, 5)
    return sorted(torch.randperm(n_pool, generator=g)[:n].tolist())


def check(cfg, traffic, seed, cen, pool, kept, mode):
    """The reference's candidates for the checked batches (scored in
    ``mode``) and the readings of the answers ``kept`` against them."""
    queries, lo, hi = pool
    rows_of, qs, los, his = {}, [], [], []
    q = queries.shape[1]
    for n, j in enumerate(sorted(kept)):
        rows_of[j] = torch.arange(n * q, (n + 1) * q, device=cen.device)
        qs.append(queries[j])
        los.append(lo[j])
        his.append(hi[j])
    cands = reference.candidates(cfg, seed, cen, torch.cat(qs), torch.cat(los),
                                 torch.cat(his), cfg["n_probes"], mode)
    answers = []
    for j, reps in sorted(kept.items()):
        if not reps:
            continue
        scores, ids, n_scanned, n_passed = (
            torch.stack([r[f] for r in reps]).to(cen.device) for f in range(4))
        answers.append((rows_of[j], ids, scores, n_scanned, n_passed))
    return cands, judge.judge(cands, answers, traffic["k"])


def need_seconds(cfg, traffic, seed, cen, pool, batches: int) -> float:
    """The tiled scans' least time over the window's ``batches`` batches
    (batch i is pool batch i mod P), from the reference's probe sets."""
    queries, lo, hi = pool
    p = queries.shape[0]
    sizes = torch.diff(gen.topic_starts(cfg, cen.device))
    per_pool = []
    for j in range(p):
        probes = reference.probe_sets(cfg, cen, queries[j],
                                      cfg["n_probes"]).default()
        ok = reference.probed_passing(cfg, seed, probes, lo[j], hi[j])
        per_pool.append(roofline.least_seconds(
            cfg, traffic["k"], probes, sizes, ok, lo.shape[2])["seconds"])
    full, rest = divmod(batches, p)
    return full * sum(per_pool) + sum(per_pool[:rest])


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float,
             traced: bool, device, t_start: float, control: bool = False):
    """One run.  Returns ``(run, readings)``: the :class:`Run` and the
    comparison's numbers (``bench/judge.py``).  ``control``: the readings
    of the control, the reference one precision below the configuration's,
    put in the program's place, beside the program's own (a dict of both)."""
    dev = torch.device(device)
    marks = [("start", time.perf_counter())]
    core, attrs, topic, cen = gen.dataset(cfg, seed, dev)
    _sync(dev)
    marks.append(("data", time.perf_counter()))
    system = System(cfg, traffic["k"], core, attrs, topic, cen, dev)
    del core, attrs, topic
    _sync(dev)
    marks.append(("build", time.perf_counter()))
    pool = gen.query_pool(cfg, traffic, seed, cen)
    n_pool = pool[0].shape[0]
    for j in range(n_pool):  # every shape the window uses
        _to_host(system.result(system.submit(pool[0][j], pool[1][j],
                                             pool[2][j])))
        if j == 0:
            marks.append(("first_batch", time.perf_counter()))
    _sync(dev)
    marks.append(("warm_up", time.perf_counter()))
    setup_parts = {"imports": marks[0][1] - t_start}
    setup_parts.update((b[0], b[1] - a[1]) for a, b in zip(marks, marks[1:]))
    setup_peak = _peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    checked = checked_batches(traffic, seed, n_pool)
    # the collector's full passes skip what set-up made (imports, build)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    prof, lat, spans, window_s = None, [], {}, 0.0
    if traced:
        prof, spans, kept, n_q, answered, scanned, profiled = _traced_window(
            system, pool, seconds, checked, dev)
    else:
        window_s, lat, kept, n_q, answered, scanned = _window(
            system, pool, seconds, checked)
    serve_peak = _peak(dev)
    gc.unfreeze()
    system.close()
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run = Run(setup_s=setup_s, window_s=window_s,
              batches=n_q // traffic["batch"], queries=n_q, answered=answered,
              latencies=lat, spans=spans, scanned=scanned,
              serve_peak_bytes=serve_peak,
              memory_peak_bytes=max(setup_peak, serve_peak),
              setup_parts=setup_parts)
    if traced:
        run.trace = trace.reduce(prof, WINDOW, ops=(TILED_OP,))
        run.window_s = run.trace["window_s"]
        run.need_s = need_seconds(cfg, traffic, seed, cen, pool, profiled)
    mode = reference.MODES[(cfg["store"], "reference")]
    cands, readings = check(cfg, traffic, seed, cen, pool, kept, mode)
    if not control:
        return run, readings
    ctl = reference.MODES[(cfg["store"], "control")]
    ctl_cands = reference.candidates(
        cfg, seed, cen, *(torch.cat([x[j] for j in sorted(kept)])
                          for x in pool), cfg["n_probes"], ctl)
    vals, ids, n_scanned, n_passed = reference.answer(ctl_cands, traffic["k"])
    q = traffic["batch"]
    answers = [(torch.arange(n * q, (n + 1) * q, device=dev),
                ids[None, n * q:(n + 1) * q], vals[None, n * q:(n + 1) * q],
                n_scanned[None, n * q:(n + 1) * q],
                n_passed[None, n * q:(n + 1) * q])
               for n in range(len(kept))]
    return run, dict(program=readings,
                     control=judge.judge(cands, answers, traffic["k"]))

