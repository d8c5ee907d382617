"""A cell at a size the CPU tests hold: the clip768 configurations' laws at
D = 64, N = 6,000 over K = 12 topics, batches of 32."""

import time

from bench import harness, spec

SEED = 2**31 + 977  # above 32 signed bits, as the driver's are


def config(store: str = "bf16") -> dict:
    bench = spec.benchmark()
    name = {"bf16": "clip768-bf16-10m", "sq8": "clip768-sq8-10m"}[store]
    cfg = spec.config(bench, name)
    cfg.update(n_rows=6000, n_clusters=12, dim=64)
    return cfg


def traffic(k: int = 10, hot: int = 0, window: float = 0,
            terms: bool = False) -> dict:
    """``terms``: the filter of ``bench/traffic/filtered-k100.json``."""
    out = dict(batch=32, k=k, hot_topics=hot, time_window=window,
               pool_queries=128, checked_queries=64)
    if terms:
        mix = spec.traffic("filtered-k100")
        out.update((n, mix[n]) for n in ("filter_terms", "filter_attrs",
                                          "filter_values"))
    return out


def run(cfg, tr, seed=SEED, traced=False, control=False, seconds=0.3):
    return harness.run_cell(cfg, tr, seed, seconds, traced, "cpu",
                            time.perf_counter(), control=control)


def limits(store: str = "bf16") -> dict:
    cell = {"bf16": "clip768-bf16-10m.uniform-k100",
            "sq8": "clip768-sq8-10m.uniform-k100"}[store]
    return spec.limits(cell)
