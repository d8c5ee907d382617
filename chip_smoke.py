#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n 10000000]

Phases:
  1. environment and build: the card, the versions, one ``nvcc`` per CUDA
     source (all started together);
  2. every kernel against its plain PyTorch version on the card, at small
     ragged shapes (dot bf16, dot f32, l2 f32, SQ8; F = 1 and 2 DNF terms);
  3. the main path at real size: a 10M x 768 bf16 index with 10 int16
     attributes built on the card from given assignments, served by
     ``SearchEngine(k=10, n_probes=7, q_block=64, prune="auto")`` in batches
     of 256 queries under three traffic mixes.  Kernel launch counts are set
     to 0 just before and read just after; results are checked against the
     port's ``search_reference`` and scored for recall against an exact
     brute-force oracle;
  4. each kernel on one full-size batch: held against its plain version,
     timed beside its bound.

Prints the card's name and power limit, a JSON line describing every
kernel, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises, and the script exits non-zero without that line.  Exits
non-zero at once where no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16, f32 FMA
NEG_INF = -3.0e38
TS_RANGE = 10_000  # timestamp attribute range (benchmarks/bench_search.py)
M_ATTRS = 10
DIM = 768
Q = 256
K_TOP = 10
N_PROBES = 7
HOT_TOPICS = 8
WARMUP, BATCHES = 2, 5
N_CHECK = 16  # queries per batch held against search_reference


def log(msg):
    print(msg, flush=True)


def ms(fn, reps):
    """Median device time of ``fn`` in ms over ``reps`` calls (CUDA events)."""
    import torch

    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check_scan(name, got, want):
    """Kernel output against the plain version: npass exact, vals within
    rtol 1e-5 + atol 1e-5·max|score|, ids exact where the score is apart
    from its neighbours by more than that tolerance.  Returns max |err|."""
    import torch

    gv, gi, gn = got
    wv, wi, wn = want
    if not torch.equal(gn, wn):
        raise AssertionError(f"{name}: npass differs")
    live = wv > NEG_INF / 2
    if not torch.equal(gv > NEG_INF / 2, live):
        raise AssertionError(f"{name}: a different set of rows passed")
    scale = float(wv[live].abs().max()) if bool(live.any()) else 1.0
    atol = 1e-5 * scale
    err = (gv - wv).abs()
    err = torch.where(live, err, 0.0)
    max_err = float(err.max())
    if bool((err > atol + 1e-5 * wv.abs()).any()):
        raise AssertionError(f"{name}: vals off by up to {max_err}")
    big = torch.full_like(wv[..., :1], float("inf"))
    gap_prev = torch.cat([big, wv[..., :-1] - wv[..., 1:]], -1)
    gap_next = torch.cat([wv[..., :-1] - wv[..., 1:], big], -1)
    clear = live & (torch.minimum(gap_prev, gap_next) > 2 * atol)
    if not torch.equal(torch.where(clear, gi, 0), torch.where(clear, wi, 0)):
        raise AssertionError(f"{name}: ids differ away from near-ties")
    if not bool((gi[~live] == -1).all()):
        raise AssertionError(f"{name}: pads carry ids")
    return max_err


def small_cases(dev, gen):
    """Phase 2 operands: (name, args, kwargs) at small ragged shapes."""
    import torch

    kc, vpad, d, m, qb, n_tiles, u_cap = 7, 328, 100, M_ATTRS, 72, 3, 6
    for variant in ("dot-bf16", "dot-f32", "l2-f32", "sq8"):
        for f in (1, 2):
            def ri(lo, hi, shape, dtype):
                return torch.randint(lo, hi, shape, generator=gen, device=dev,
                                     dtype=dtype)

            vec = torch.randn((kc, vpad, d), generator=gen, device=dev)
            queries = torch.randn((n_tiles * qb, d), generator=gen, device=dev)
            norms = scales = None
            if variant == "sq8":
                scales = vec.abs().amax(-1) / 127.0
                vec = torch.clamp(torch.round(vec / scales[..., None]),
                                  -127, 127).to(torch.int8)
            elif variant == "dot-bf16":
                vec, queries = vec.bfloat16(), queries.bfloat16()
            if variant == "l2-f32":
                norms = (vec ** 2).sum(-1)
            args = (
                ri(0, kc, (n_tiles * u_cap,), torch.int32),
                torch.arange(n_tiles, device=dev, dtype=torch.int32
                             ).repeat_interleave(u_cap),
                ri(1, u_cap + 1, (n_tiles,), torch.int32),
                queries.contiguous(),
                ri(-8, 3, (n_tiles * qb, f, m), torch.int16),
                ri(3, 14, (n_tiles * qb, f, m), torch.int16),
                vec.contiguous(), ri(0, 16, (kc, vpad, m), torch.int16),
                ri(-1, 10**6, (kc, vpad), torch.int32), norms, scales,
            )
            kw = dict(metric="l2" if variant == "l2-f32" else "dot",
                      k=K_TOP, q_block=qb)
            yield f"{variant} F={f}", args, kw


def make_index(n, dev, gen):
    """The topic-mixture dataset of benchmarks/bench_search.py::build_sweep
    at full width, generated on the card in chunks, and its index."""
    import torch

    from repro_torch.core import HybridSpec, build_from_assignments
    from repro_torch.core.ivf import default_n_clusters

    kc = default_n_clusters(n)
    centers = torch.randn((kc, DIM), generator=gen, device=dev)
    centers /= centers.norm(dim=-1, keepdim=True)
    topic = (torch.arange(n, device=dev) * kc) // n  # equal-sized topics
    band = TS_RANGE // kc
    core = torch.empty((n, DIM), dtype=torch.bfloat16, device=dev)
    attrs = torch.randint(0, 16, (n, M_ATTRS), generator=gen, device=dev,
                          dtype=torch.int16)
    step = 1 << 20
    for r0 in range(0, n, step):
        t = topic[r0:r0 + step]
        x = centers[t] + 0.05 * torch.randn((t.shape[0], DIM), generator=gen,
                                            device=dev)
        core[r0:r0 + step] = (x / x.norm(dim=-1, keepdim=True)).bfloat16()
        ts = t * band + torch.randint(0, max(band, 1), t.shape, generator=gen,
                                      device=dev)
        attrs[r0:r0 + step, 0] = ts.to(torch.int16)
    spec = HybridSpec(dim=DIM, n_attrs=M_ATTRS, core_dtype=torch.bfloat16)
    index, stats = build_from_assignments(spec, centers, core, attrs, topic,
                                          device=dev)
    return index, stats, centers


def mix_batch(mix, centers, dev, gen):
    """One batch of Q queries (bf16-representable f32) and its FilterSpec."""
    import torch

    from repro_torch.core import FilterSpec, match_all

    kc = centers.shape[0]
    if mix == "uniform":
        topics = torch.randint(0, kc, (Q,), generator=gen, device=dev)
    else:  # hot: a few popular topics take the whole batch
        hot = torch.randint(0, kc, (HOT_TOPICS,), generator=gen, device=dev)
        topics = hot[torch.randint(0, HOT_TOPICS, (Q,), generator=gen,
                                   device=dev)]
    x = centers[topics] + 0.05 * torch.randn((Q, DIM), generator=gen, device=dev)
    queries = (x / x.norm(dim=-1, keepdim=True)).bfloat16().float()
    fspec = match_all(Q, M_ATTRS, device=dev)
    if mix == "hot_window":  # ~5% time window per query
        w = TS_RANGE // 20
        start = torch.randint(0, TS_RANGE - w + 1, (Q,), generator=gen,
                              device=dev)
        lo, hi = fspec.lo.clone(), fspec.hi.clone()
        lo[:, 0, 0] = start.to(torch.int16)
        hi[:, 0, 0] = (start + w - 1).to(torch.int16)
        fspec = FilterSpec(lo=lo, hi=hi)
    return queries, fspec


def check_against_reference(mix, index, queries, fspec, res):
    """N_CHECK queries of a batch against search_reference on the card."""
    import torch

    from repro_torch.core import FilterSpec, can_match, search_centroids
    from repro_torch.core import search_reference

    sel = slice(0, N_CHECK)
    fs = FilterSpec(lo=fspec.lo[sel], hi=fspec.hi[sel])
    ref = search_reference(index, queries[sel], fs, k=K_TOP, n_probes=N_PROBES)
    got = (res.scores[sel], res.ids[sel])
    check_scan(f"{mix} vs search_reference",
               (got[0], got[1], res.n_passed[sel]),
               (ref.scores, ref.ids, ref.n_passed))
    # the engine skips probes the summaries prove empty; the reference
    # scans every probe
    probes, _ = search_centroids(index, queries[sel], N_PROBES)
    p = probes.long()
    cm = torch.gather(can_match(index.summaries, fs.lo, fs.hi), 1, p)
    live = (index.ids >= 0).sum(-1)
    if not torch.equal((live[p] * cm).sum(-1).int(), res.n_scanned[sel]):
        raise AssertionError(f"{mix}: n_scanned differs")
    if not torch.equal((~cm).sum(-1).int(), res.n_pruned[sel]):
        raise AssertionError(f"{mix}: n_pruned differs")


def exact_oracle(index, queries, fspec, chunk=256):
    """Exact filtered top-k over every live row, brute_force over chunks of
    clusters merged through the top-k monoid."""
    from repro_torch.core import brute_force
    from repro_torch.core.topk import merge_topk

    best = None
    d, m = index.vectors.shape[-1], index.attrs.shape[-1]
    for c0 in range(0, index.n_clusters, chunk):
        ids = index.ids[c0:c0 + chunk].reshape(-1)
        live = ids >= 0
        r = brute_force(index.vectors[c0:c0 + chunk].reshape(-1, d)[live],
                        index.attrs[c0:c0 + chunk].reshape(-1, m)[live],
                        queries, fspec, k=K_TOP, ids=ids[live])
        part = (r.scores, r.ids)
        best = part if best is None else merge_topk(best, part, K_TOP)
    return best


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n", type=int, default=10_000_000)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script runs the port on a card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"{SRC / 'repro_torch'} is missing: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import SearchEngine, recall_at_k
    from repro_torch.core.search import SearchResult
    from repro_torch.kernels import build
    from repro_torch.kernels.filtered_scan import filtered_scan as fs_mod
    from repro_torch.kernels.filtered_scan.ref import (
        filtered_scan_tiled_ref, live_slots)

    t_all = time.perf_counter()
    # ---- phase 1: environment and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    for name, rep in build.build_all().items():
        ptxas = [ln.strip() for ln in rep["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"built {name} in {rep['seconds']:.2f} s; " + " | ".join(ptxas))
    log(f"phase 1 (build) {time.perf_counter() - t0:.2f} s")

    # ---- phase 2: kernels against their plain versions, small shapes ----
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    for name, a, kw in small_cases(dev, gen):
        got = fs_mod.filtered_scan_tiled(*a, **kw)
        torch.cuda.synchronize()
        err = check_scan(name, got, filtered_scan_tiled_ref(*a, **kw))
        log(f"filtered_scan_tiled {name}: ok, max |err| {err:.3e}")
    log(f"phase 2 (kernel checks) {time.perf_counter() - t0:.2f} s")

    # ---- phase 3: the main path at real size ----
    t0 = time.perf_counter()
    index, stats, centers = make_index(args.n, dev, gen)
    torch.cuda.synchronize()
    gib = index.nbytes() / 2**30
    log(f"index: N={stats.n_vectors} K={index.n_clusters} Vpad={index.vpad} "
        f"D={DIM} bf16 M={M_ATTRS} int16, {gib:.2f} GiB, dropped "
        f"{stats.n_dropped}; built in {time.perf_counter() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if stats.n_dropped:
        raise AssertionError("the build dropped rows")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    engine = SearchEngine(index, k=K_TOP, n_probes=N_PROBES, q_block=64,
                          prune="auto")
    mixes = ("hot", "uniform", "hot_window")
    batches = {mix: [mix_batch(mix, centers, dev, gen)
                     for _ in range(WARMUP + BATCHES)] for mix in mixes}
    timings = {}
    results = {}
    t0 = time.perf_counter()
    fs_mod.LAUNCHES = 0
    for mix in mixes:
        rows = []
        for i, (queries, fspec) in enumerate(batches[mix]):
            before = fs_mod.LAUNCHES
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            plan = engine.plan(queries, fspec)
            ev[1].record()
            res = engine.execute(plan)
            ev[2].record()
            ev[2].synchronize()
            if fs_mod.LAUNCHES == before:
                raise AssertionError(f"{mix} batch {i}: no kernel launch")
            if i >= WARMUP:
                rows.append((ev[0].elapsed_time(ev[1]),
                             ev[1].elapsed_time(ev[2]),
                             ev[0].elapsed_time(ev[2])))
        results[mix] = (batches[mix][-1], res, plan)
        timings[mix] = rows
    launches = fs_mod.LAUNCHES
    t_main = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    if launches < len(mixes) * (WARMUP + BATCHES):
        raise AssertionError(f"filtered_scan_tiled launched {launches} times")
    for mix in mixes:
        plan_ms, scan_ms, whole = (statistics.median(c) for c in zip(*timings[mix]))
        (queries, fspec), res, plan = results[mix]
        n_live = int(plan.n_unique.sum())
        log(f"{mix}: plan {plan_ms:.3f} ms, scan+merge {scan_ms:.3f} ms, batch "
            f"{whole:.3f} ms (medians of {BATCHES}), QPS {Q / whole * 1e3:.1f}; "
            f"u_cap {plan.u_cap}, live slots {n_live}, pruned probes "
            f"{int(res.n_pruned.sum())}, mean passed rows "
            f"{float(res.n_passed.float().mean()):.1f}")
    log(f"main path: {launches} launches of filtered_scan_tiled in "
        f"{len(mixes) * (WARMUP + BATCHES)} batches, {t_main:.2f} s; peak "
        f"memory while serving {serve_peak:.2f} GiB")

    for mix in mixes:
        (queries, fspec), res, _ = results[mix]
        if res.scores.shape != (Q, K_TOP) or not bool(torch.isfinite(res.scores).all()):
            raise AssertionError(f"{mix}: malformed scores")
        check_against_reference(mix, index, queries, fspec, res)
        oracle = exact_oracle(index, queries, fspec)
        rec = recall_at_k(res, SearchResult(oracle[0], oracle[1], None, None))
        log(f"{mix}: {N_CHECK} queries match search_reference; recall@{K_TOP} "
            f"vs exact brute force over all {stats.n_vectors} rows: {rec:.4f}")
    log(f"phase 3 (main path) {time.perf_counter() - t_all:.2f} s since start")

    # ---- phase 4: the kernel on one full-size batch ----
    t0 = time.perf_counter()
    _, _, plan = results["uniform"]
    a = (plan.slot_cluster, plan.slot_tile, plan.n_unique, plan.queries_pad,
         plan.lo_pad, plan.hi_pad, index.vectors, index.attrs, index.ids,
         None, None)
    kw = dict(metric="dot", k=K_TOP, q_block=plan.q_block)
    got = fs_mod.filtered_scan_tiled(*a, **kw)
    want = filtered_scan_tiled_ref(*a, **kw)
    max_err = check_scan("full-size uniform batch", got, want)
    kernel_ms = ms(lambda: fs_mod.filtered_scan_tiled(*a, **kw), 10)
    plain_ms = ms(lambda: filtered_scan_tiled_ref(*a, **kw), 3)
    live = live_slots(plan.slot_tile, plan.n_unique)
    n_live = int(live.sum())
    n_clusters = int(torch.unique(plan.slot_cluster[live]).numel())
    s, qb = plan.slot_cluster.shape[0], plan.q_block
    f, m = plan.lo_pad.shape[1:]
    row_bytes = DIM * 2 + m * 2 + 4  # vector, attributes, id
    nbytes = (n_clusters * index.vpad * row_bytes
              + plan.queries_pad.numel() * 2 + 2 * plan.lo_pad.numel() * 2
              + 2 * s * 4 + plan.n_unique.numel() * 4  # inputs
              + s * qb * (K_TOP * 8 + 4))  # outputs
    ops = 2 * qb * index.vpad * DIM * n_live
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_OPS["bf16"] * 1e3
    bound_ms = max(byte_ms, op_ms)
    log(f"filtered_scan_tiled full size: {n_live} live slots over {n_clusters} "
        f"clusters; kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.3f} ms (bytes {byte_ms:.3f} ms, bf16 ops {op_ms:.3f} ms; "
        f"f32 FMA ops {ops / PEAK_OPS['f32'] * 1e3:.3f} ms); "
        f"{ops / kernel_ms / 1e9:.1f} TFLOP/s achieved; max |err| {max_err:.3e}")
    log(f"phase 4 (kernel timing) {time.perf_counter() - t0:.2f} s; total "
        f"{time.perf_counter() - t_all:.2f} s")

    kernels = [dict(
        name="filtered_scan_tiled", route="cuda",
        source="src/repro_torch/kernels/filtered_scan/csrc/filtered_scan_tiled.cu",
        replaces="src/repro/kernels/filtered_scan/filtered_scan.py:360",
        launches=launches, max_abs_err=max_err, ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if byte_ms >= op_ms else "operations",
        library_ms=None,
    )]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
