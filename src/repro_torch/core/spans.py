"""The engine's spans, read sites and stage histograms.

One :class:`Tracer` per :class:`~repro_torch.core.engine.SearchEngine`
(``engine.tracer``), off by default, switched by :meth:`Tracer.enable` /
:meth:`Tracer.disable` or the :meth:`Tracer.tracing` context.

- :meth:`Tracer.span` is a context around a piece of the engine's work.
  Off, it is one shared null context (a flag check).  On, it opens
  ``torch.profiler.record_function(name)``, so that under
  ``torch.profiler`` the span lands on the kernels' clock, and reads the
  host clock at both ends; a ``device=True`` span on CUDA also records a
  pair of pooled CUDA events on the current stream, resolved once the end
  event has completed (never by a new sync on the hot path) or by
  :meth:`Tracer.summary`'s one sync.
- A span given ``stage=`` feeds that stage's latency histogram
  (:class:`StageHistogram`, rendered by ``metrics_text()``).  A host stage
  observes its host time whether tracing is on or not.  A device stage
  observes the time on the device it ran on: the host clock on the CPU,
  where the work is done when the call returns; on CUDA the resolved
  event time while tracing is on, and nothing while it is off (the host
  clock there would time the enqueue).
- :meth:`Tracer.host_read` wraps each place where the engine reads a device
  value to the host.  It counts the read under its site always; while
  tracing is on it is also a span ``repro.sync.<site>``, whose host time is
  the time the host sat blocked.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional

import torch

# Fixed latency bucket upper bounds (seconds) for the per-stage histograms,
# fixed so scrapes from different processes aggregate.
_LAT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5)

# Device spans whose events have not completed, at most this many: past it
# the oldest is waited for (the host is this far ahead of the card).
MAX_PENDING = 256

SYNC_PREFIX = "repro.sync."

# what a span is with tracing off
NO_SPAN = contextlib.nullcontext()


class StageHistogram:
    """Fixed-bucket latency histogram, Prometheus-renderable (cumulative
    ``le`` buckets at render time, ``+Inf`` equal to the count)."""

    __slots__ = ("counts", "total", "sum")

    def __init__(self):
        self.counts = [0] * len(_LAT_BUCKETS)
        self.total = 0
        self.sum = 0.0

    def observe(self, seconds: float):
        self.total += 1
        self.sum += seconds
        for i, edge in enumerate(_LAT_BUCKETS):
            if seconds <= edge:
                self.counts[i] += 1
                break

    def render(self, name: str, labels: str) -> List[str]:
        lines = []
        cum = 0
        for edge, n in zip(_LAT_BUCKETS, self.counts):
            cum += n
            lines.append(f'{name}_bucket{{{labels},le="{edge}"}} {cum}')
        lines.append(f'{name}_bucket{{{labels},le="+Inf"}} {self.total}')
        lines.append(f"{name}_sum{{{labels}}} {self.sum}")
        lines.append(f"{name}_count{{{labels}}} {self.total}")
        return lines


def render_stage_histograms(hists: Dict[str, StageHistogram],
                            prefix: str = "repro") -> str:
    """``{stage: histogram}`` → Prometheus exposition text (one metric
    family, a ``stage`` label per pipeline stage)."""
    if not hists:
        return ""
    name = f"{prefix}_stage_latency_seconds"
    lines = [f"# TYPE {name} histogram"]
    for stage in sorted(hists):
        lines.extend(hists[stage].render(name, f'stage="{stage}"'))
    return "\n".join(lines) + "\n"


class _Totals:
    """A span name's running sums."""

    __slots__ = ("count", "host_ns", "device_count", "device_s")

    def __init__(self):
        self.count = 0
        self.host_ns = 0
        self.device_count = 0
        self.device_s = 0.0

    def copy(self) -> "_Totals":
        out = _Totals()
        out.count, out.host_ns = self.count, self.host_ns
        out.device_count, out.device_s = self.device_count, self.device_s
        return out


class _StageClock:
    """A host stage with tracing off: its host time into its histogram."""

    __slots__ = ("hist", "t0")

    def __init__(self, hist: StageHistogram):
        self.hist = hist

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0)
        return False


class _Span:
    """A span with tracing on."""

    __slots__ = ("tracer", "name", "device", "stage", "rf", "ev0", "t0")

    def __init__(self, tracer: "Tracer", name: str, device: bool,
                 stage: Optional[str]):
        self.tracer = tracer
        self.name = name
        self.device = device
        self.stage = stage

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.device and self.tracer.cuda:
            self.ev0 = self.tracer._event()
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        tr = self.tracer
        timed = self.device and tr.cuda  # by a pair of CUDA events
        if timed:
            ev1 = tr._event()
            ev1.record()
        self.rf.__exit__(*exc)
        tot = tr._totals(self.name)
        tot.count += 1
        tot.host_ns += dt
        if timed:
            tr._pending.append((tot, self.stage, self.ev0, ev1))
            tr._resolve(block=False)
            return False
        # the CPU's work is done when its call returns
        if self.stage is not None:
            tr.observe_stage(self.stage, dt * 1e-9)
        if self.device:
            tot.device_count += 1
            tot.device_s += dt * 1e-9
        return False


class Tracer:
    """The engine's spans, read-site counters and stage histograms (see the
    module's docstring).  ``device``: the engine's device."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.enabled = False
        self.reads: Dict[str, int] = collections.defaultdict(int)
        self.stages: Dict[str, StageHistogram] = {}
        self._spans: Dict[str, _Totals] = {}
        self._pending: collections.deque = collections.deque()
        self._events: List = []  # completed events, for reuse
        self._base = ({}, {})

    # ---- the switch ----
    def enable(self):
        """Turns tracing on and starts :meth:`summary`'s window."""
        self._resolve(block=True)
        self._base = ({n: t.copy() for n, t in self._spans.items()},
                      dict(self.reads))
        self.enabled = True

    def disable(self):
        self.enabled = False

    @contextlib.contextmanager
    def tracing(self):
        """Tracing on for the block."""
        self.enable()
        try:
            yield self
        finally:
            self.disable()

    # ---- the hot path ----
    def span(self, name: str, device: bool = False,
             stage: Optional[str] = None):
        """A context around the engine's work named ``name`` (see the
        module's docstring); ``device``: timed on the device it runs on;
        ``stage``: the latency histogram it feeds."""
        if self.enabled:
            return _Span(self, name, device, stage)
        if stage is None or (device and self.cuda):
            return NO_SPAN
        return _StageClock(self._stage(stage))

    def host_read(self, site: str):
        """A context around a read of a device value to the host: counted
        under ``site``; while tracing is on, a span ``repro.sync.<site>``."""
        self.reads[site] += 1
        if not self.enabled:
            return NO_SPAN
        return _Span(self, SYNC_PREFIX + site, False, None)

    def observe_stage(self, stage: str, seconds: float):
        """Ends a stage: its time into its histogram."""
        self._stage(stage).observe(seconds)

    # ---- reading ----
    def summary(self) -> dict:
        """The window since the last :meth:`enable`, as plain numbers:
        ``spans`` ``{name: {count, host_s, device_s}}`` (``device_s`` None
        for spans not timed on a device) and ``reads`` ``{site: count}``.
        Resolves the device spans still pending with one sync."""
        self._resolve(block=True)
        base_spans, base_reads = self._base
        spans = {}
        for name, tot in list(self._spans.items()):
            b = base_spans.get(name) or _Totals()
            if tot.count == b.count:
                continue
            timed = tot.device_count > b.device_count
            spans[name] = dict(
                count=tot.count - b.count,
                host_s=(tot.host_ns - b.host_ns) * 1e-9,
                device_s=(tot.device_s - b.device_s) if timed else None)
        reads = {site: n - base_reads.get(site, 0)
                 for site, n in list(self.reads.items())
                 if n != base_reads.get(site, 0)}
        return dict(spans=spans, reads=reads)

    def render(self, prefix: str = "repro") -> str:
        """The read-site counters and the span totals as Prometheus
        counters (cumulative since the engine was made)."""
        lines = []
        reads = sorted(list(self.reads.items()))
        if reads:
            name = f"{prefix}_host_reads_total"
            lines.append(f"# TYPE {name} counter")
            lines.extend(f'{name}{{site="{s}"}} {n}' for s, n in reads)
        spans = sorted(list(self._spans.items()))
        for field, unit in (("count", "total"),
                            ("host_ns", "host_seconds_total"),
                            ("device_s", "device_seconds_total")):
            rows = [(n, getattr(t, field)) for n, t in spans
                    if field != "device_s" or t.device_count]
            if not rows:
                continue
            name = f"{prefix}_span_{unit}"
            lines.append(f"# TYPE {name} counter")
            for n, v in rows:
                v = v * 1e-9 if field == "host_ns" else v
                lines.append(f'{name}{{span="{n}"}} {v}')
        return "\n".join(lines) + "\n" if lines else ""

    # ---- inside ----
    def _stage(self, stage: str) -> StageHistogram:
        hist = self.stages.get(stage)
        if hist is None:
            hist = self.stages[stage] = StageHistogram()
        return hist

    def _totals(self, name: str) -> _Totals:
        tot = self._spans.get(name)
        if tot is None:
            tot = self._spans[name] = _Totals()
        return tot

    def _event(self):
        if self._events:
            return self._events.pop()
        return torch.cuda.Event(enable_timing=True)

    def _resolve(self, block: bool):
        """Adds the completed device spans' event times to their sums and
        stages, oldest first; ``block``: wait for all of them (one sync).
        Without it, waits only for the oldest past :data:`MAX_PENDING`."""
        pend = self._pending
        if block and pend:
            pend[-1][3].synchronize()
        while pend:
            tot, stage, ev0, ev1 = pend[0]
            if not ev1.query():
                if len(pend) <= MAX_PENDING:
                    break
                ev1.synchronize()
            pend.popleft()
            seconds = ev0.elapsed_time(ev1) * 1e-3
            tot.device_count += 1
            tot.device_s += seconds
            if stage is not None:
                self.observe_stage(stage, seconds)
            self._events += (ev0, ev1)
