"""The benchmark's data and traffic generator.

A frozen copy of ``chip_smoke.py::make_data`` and ``mix_batch`` (the topic
mixture of ``benchmarks/bench_search.py::build_sweep`` at full width),
changed in one way: each topic's rows come from a generator seeded by
(seed, topic), so that the reference regenerates any cluster alone, and the
queries of a run come from one generator in a few large calls.  A change to
the program cannot move this file.

The data: ``n_clusters`` unit centres; topic ``t`` holds the rows ``r`` with
``r * K // N == t`` (equal-sized topics, topic-major), each row
``normalize(centre + noise * N(0, I))`` in bf16; attribute 0 a timestamp in
``[0, ts_range)`` banded by topic, attributes 1.. uniform over
``attr_values`` values.  The queries: a topic per query (uniform, or drawn
from a few hot topics a batch), ``normalize(centre + noise * N(0, I))``
rounded to bf16 and held in f32, and a filter per query: all rows, or a
time window on attribute 0, or ``filter_terms`` terms of which a row has to
pass one (disjunctive normal form), each term holding ``filter_attrs``
attributes drawn from 1.. to an interval of ``filter_values`` values.
"""

from __future__ import annotations

import torch

ATTR_MIN, ATTR_MAX = -32768, 32767  # the int16 range: a bound that passes all
_MASK64 = (1 << 64) - 1
ROWS, ATTRS, CENTRES, QUERIES = 1, 2, 3, 4  # generator streams


def _mix64(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit generator seed from the run's seed and stream keys."""
    x = _mix64(seed & _MASK64)
    for key in keys:
        x = _mix64(x ^ _mix64(key & _MASK64))
    return x >> 1


def generator(device, seed: int, *keys: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *keys))
    return g


def topic_start(cfg: dict, t):
    """First row of topic ``t`` (an int or a tensor): ceil(t * N / K)."""
    n, kc = cfg["n_rows"], cfg["n_clusters"]
    return (t * n + kc - 1) // kc


def topic_size(cfg: dict, t):
    return topic_start(cfg, t + 1) - topic_start(cfg, t)


def topic_starts(cfg: dict, device) -> torch.Tensor:
    """[K + 1] int64: every topic's first row, then N."""
    return topic_start(cfg, torch.arange(cfg["n_clusters"] + 1,
                                         dtype=torch.int64, device=device))


def centres(cfg: dict, seed: int, device) -> torch.Tensor:
    """[K, D] f32 unit centres."""
    g = generator(device, seed, CENTRES)
    c = torch.randn((cfg["n_clusters"], cfg["dim"]), generator=g,
                    device=device)
    return c / c.norm(dim=-1, keepdim=True)


def topic_vectors(cfg: dict, seed: int, t: int, centre: torch.Tensor
                  ) -> torch.Tensor:
    """[n_t, D] bf16: topic ``t``'s rows (``centre`` is its [D] centre)."""
    dev = centre.device
    g = generator(dev, seed, ROWS, t)
    x = torch.randn((topic_size(cfg, t), cfg["dim"]), generator=g, device=dev)
    x = centre + cfg["assumed"]["noise"] * x
    return (x / x.norm(dim=-1, keepdim=True)).bfloat16()


def topic_attrs(cfg: dict, seed: int, t: int, device) -> torch.Tensor:
    """[n_t, M] int16: topic ``t``'s attributes."""
    a = cfg["assumed"]
    g = generator(device, seed, ATTRS, t)
    n_t = topic_size(cfg, t)
    out = torch.randint(0, a["attr_values"], (n_t, cfg["n_attrs"]),
                        generator=g, device=device, dtype=torch.int16)
    band = max(a["ts_range"] // cfg["n_clusters"], 1)
    ts = t * band + torch.randint(0, band, (n_t,), generator=g, device=device)
    out[:, 0] = ts.to(torch.int16)
    return out


def dataset(cfg: dict, seed: int, device):
    """The whole data set: ``(core [N, D] bf16, attrs [N, M] int16, topic
    [N] int64, centres [K, D] f32)``, topic-major."""
    n, kc = cfg["n_rows"], cfg["n_clusters"]
    cen = centres(cfg, seed, device)
    core = torch.empty((n, cfg["dim"]), dtype=torch.bfloat16, device=device)
    attrs = torch.empty((n, cfg["n_attrs"]), dtype=torch.int16, device=device)
    for t in range(kc):
        r0, r1 = topic_start(cfg, t), topic_start(cfg, t + 1)
        core[r0:r1] = topic_vectors(cfg, seed, t, cen[t])
        attrs[r0:r1] = topic_attrs(cfg, seed, t, device)
    topic = (torch.arange(n, dtype=torch.int64, device=device) * kc) // n
    return core, attrs, topic, cen


def query_pool(cfg: dict, traffic: dict, seed: int, cen: torch.Tensor):
    """The run's batches: ``(queries [P, Q, D] f32, lo [P, Q, F, M] int16,
    hi [P, Q, F, M] int16)`` with ``P = pool_queries // batch`` and ``F``
    the filter's terms (1 where it has none)."""
    dev = cen.device
    q, kc, d, m = traffic["batch"], cfg["n_clusters"], cfg["dim"], cfg["n_attrs"]
    p = traffic["pool_queries"] // q
    g = generator(dev, seed, QUERIES)
    hot = traffic["hot_topics"]
    if hot:  # a few popular topics take each whole batch
        pick = torch.randint(0, kc, (p, hot), generator=g, device=dev)
        topics = torch.gather(pick, 1, torch.randint(0, hot, (p, q),
                                                     generator=g, device=dev))
    else:
        topics = torch.randint(0, kc, (p, q), generator=g, device=dev)
    x = cen[topics] + cfg["assumed"]["noise"] * torch.randn(
        (p, q, d), generator=g, device=dev)
    queries = (x / x.norm(dim=-1, keepdim=True)).bfloat16().float()
    f = traffic.get("filter_terms", 0)
    lo = torch.full((p, q, max(f, 1), m), ATTR_MIN, dtype=torch.int16,
                    device=dev)
    hi = torch.full_like(lo, ATTR_MAX)
    share = traffic["time_window"]
    if share:  # a window of this share of the timestamps, per query
        ts = cfg["assumed"]["ts_range"]
        w = max(int(ts * share), 1)
        start = torch.randint(0, ts - w + 1, (p, q), generator=g, device=dev)
        lo[:, :, :, 0] = start.to(torch.int16)[..., None]
        hi[:, :, :, 0] = (start + w - 1).to(torch.int16)[..., None]
    if f:  # each term: a few of attributes 1.., each to an interval
        n_a, w = traffic["filter_attrs"], traffic["filter_values"]
        which = 1 + torch.rand((p, q, f, m - 1), generator=g,
                               device=dev).argsort(-1)[..., :n_a]
        start = torch.randint(0, cfg["assumed"]["attr_values"] - w + 1,
                              (p, q, f, n_a), generator=g, device=dev)
        lo.scatter_(3, which, start.to(torch.int16))
        hi.scatter_(3, which, (start + w - 1).to(torch.int16))
    return queries, lo, hi
