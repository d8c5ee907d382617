"""Reduces a ``torch.profiler`` trace to the benchmark's device numbers.

It reads the profiler's raw events (not the per-event Python objects, which
cost seconds to build for a window of thousands of batches): the device's
kernels, copies and sets, and the host's ops and the benchmark's own
``record_function`` spans.
"""

from __future__ import annotations

from torch.autograd import DeviceType

TOP = 10
NAME_CHARS = 160


def _union(intervals):
    """Merged, sorted ``[(start, end)]``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce(prof, window: str, ops=()) -> dict:
    """``prof``: a finished ``torch.profiler.profile``; ``window``: the name
    of the ``record_function`` span that is the measured window; ``ops``:
    op names whose kernels' device time is wanted.  Returns ``busy_s`` (the
    union of device intervals in the window), ``window_s``, ``op_s`` (device
    seconds of each op's kernels, by the profiler's op-to-kernel links),
    and ``device_ops`` and ``idle_gaps`` (the breakdown)."""
    host, device, win, marks = [], [], None, {window}
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == DeviceType.CPU:
            rec = (e.start_ns(), e.end_ns(), e.name(), e.correlation_id())
            if rec[2] == window:
                win = rec
            if e.is_user_annotation():
                marks.add(rec[2])
            host.append(rec)
        elif kind == DeviceType.CUDA and not e.is_user_annotation():
            device.append((e.start_ns(), e.end_ns(), e.name(),
                           e.linked_correlation_id()))
    # the spans' copies on the device timeline are marks, not work
    device = [d for d in device if d[2] not in marks]
    if win is None:
        raise RuntimeError(f"the trace holds no {window!r} span")
    ws, we = win[0], win[1]
    inside = [(max(s, ws), min(e, we), n, c) for s, e, n, c in device
              if e > ws and s < we]
    busy = _union((s, e) for s, e, _, _ in inside)
    by_name = {}
    for s, e, n, _ in inside:
        by_name[n] = by_name.get(n, 0) + (e - s)
    op_ids = {}
    for s, e, n, c in host:
        if n in ops:
            op_ids[c] = n
    op_ns = {n: 0 for n in ops}
    for s, e, n, c in inside:
        if c in op_ids:
            op_ns[op_ids[c]] += e - s
    gaps, prev = [], ws
    for s, e in busy:
        if s > prev:
            gaps.append((s - prev, prev, s))
        prev = max(prev, e)
    if we > prev:
        gaps.append((we - prev, prev, we))
    gaps.sort(reverse=True)
    return dict(
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        window_s=(we - ws) * 1e-9,
        op_s={n: v * 1e-9 for n, v in op_ns.items()},
        device_ops=[[n[:NAME_CHARS], v * 1e-9] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=[[_host_at(host, (a + b) // 2, window), g * 1e-9]
                   for g, a, b in gaps[:TOP]])


def _host_at(host, t, window):
    """What the host was doing at ``t``: the benchmark's span and the
    innermost op that covers it, as ``span > op``."""
    covering = [(s, n) for s, e, n, _ in host if s <= t <= e and n != window]
    if not covering:
        return "host: no op"
    covering.sort()
    spans = [n for _, n in covering if n.startswith("bench.")]
    inner = covering[-1][1]
    label = f"{spans[-1]} > {inner}" if spans and spans[-1] != inner else inner
    return label[:NAME_CHARS]
