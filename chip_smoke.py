#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--n 10000000] [--disk-n N] [--variants]

Phases:
  1. environment and build: the card, the versions, one ``nvcc`` per CUDA
     source (all started together), and the count of tensor-core
     instructions (HGMMA, HMMA) in each library's SASS;
  2. every kernel against its plain PyTorch version on the card, at small
     ragged shapes: filtered_scan_tiled and the per-probe filtered_scan
     over their dtype pairs and metrics (F = 1 and 2 DNF terms; the tiled
     scan also at k = 33, 100 and 257), centroid_topk over dot/l2 x
     f32/bf16 and T = 1, 7, 32, 33, 56, 200 and K with tied centroids, and
     a case where every score is below 0;
  3. the main path at real size: a 10M x 768 bf16 index with 10 int16
     attributes built on the card from given assignments, served by
     ``SearchEngine(k=10, n_probes=7, q_block=64, prune="auto")`` in batches
     of 256 queries under three traffic mixes.  Kernel launch counts are set
     to 0 just before and read just after; results are checked against the
     port's ``search_reference`` and scored for recall against an exact
     brute-force oracle;
  3b. the one-shard sharded search (``make_sharded_search``, per-probe and
     tiled backends) on the same batches, and ``search_fused`` on one batch
     per mix, with the launch counts set to 0 just before and read just
     after; each result is checked against ``search_reference`` and the
     engine's;
  3c. the disk tier: the phase-3 index written with the port's
     ``save_index`` (layout 3, 2 shards) under ``build/``, opened as a
     ``DiskIVFIndex`` whose cache holds half the records, and served through
     ``SearchEngine`` with ``pipeline="off"`` and ``"on"`` on 1 warm-up and
     3 timed batches of each mix; every batch is held against the RAM
     engine's result, and each (executor, mix) prints its batch time split
     into plan, fetch wait and scan+merge, the bytes fetched and moved to
     the card, the H2D bound of its distinct bytes (the card's pinned copy
     rate, measured once), the overlap ratio and the cache's hit rate.
     ``--disk-n`` serves a separate, smaller index in phases 3c and 3d;
  3d. live updates on phase 3c's checkpoint: a 256 MiB ``DeltaTier``
     attached to a fresh ``DiskIVFIndex`` over it; 1% of the cold rows
     tombstoned (uniform, with cluster hints) and up to 1% more added from
     the build's topic mixture (no cluster past its free slots); the
     three mixes served through both executors and one batch at k = 100,
     then ``compact_deltas`` + ``refresh`` and the same batches again; then
     hot_window widened with ``t_max=4·n_probes`` and ``"auto"``.  Every
     batch is held against a RAM engine over a rebuild at the same logical
     state (``build_from_assignments`` over the live base rows and the
     adds), each widened plan against the same plan computed on the CPU,
     its results against an exact search over its probes, and its recall
     against the unwidened plan's; hot also through a sync engine with an
     8 GiB device cache, whose refresh must drop exactly the rewritten
     clusters' entries.  The checkpoint is deleted at the end;
  3e. (run between 3c and 3d, on 3c's checkpoint before 3d republishes
     it) the device cache: an 8 GiB ``DeviceBlockCache`` per executor on
     3c's batches, each equal to the RAM engine's; sub-partitions:
     ``build_partitions(attrs=[1], max_subs=4096)`` written as a layout-4
     checkpoint beside 3c's (shard files hard-linked), served on cat_eq
     and cat_mixed traffic by both executors with ``partitions="auto"``
     and ``"off"`` (results equal bit for bit), and by the RAM tier over
     ``attach`` where the card holds it; termination: the RAM engine on
     the three mixes untruncated, ``"exact"`` (ids and scores equal bit
     for bit) and ``"bounded"`` (equal to an exact top-k over the probes
     its merge kept), and one disk batch with ``"exact"``;
  3f. (run between 3e and 3d, on 3c's checkpoint) serving and the index
     build: the launcher (``repro_torch.launch.serve.main``) ``--load``-ing
     the checkpoint on the RAM tier and on the disk tier with an 8 GiB
     device cache and a 256 MiB delta tier, 10 full batches of 256 each,
     every response held against a RAM engine; a ``SearchServer`` over
     ``make_fused_search_fn`` fed phase 3's batches of each mix as
     requests, every response held against phase 3's engine; the build's
     k-means at full size on the topic mixture (``minibatch_kmeans``, 100
     steps of 4096, and ``assign``, timed; 65,536 sampled assignments held
     against an f64 argmax), the lists' lengths and what the scatter would
     allocate (``build_ivf`` itself where that fits); and the launcher's
     own build path at the largest N whose index the card holds (capped for
     the host's numpy data), with the tiled kernel's f32 x f32 time on its
     index;
  3g. (run between 3f and 3d, on 3c's checkpoint) the sharded ring: a
     loopback ``open_sharded`` ring of 3 peers, each caching a third of
     3c's budget, the disk index's own store as the fallback, through both
     executors on the three mixes (1 warm-up + 2 batches each), printing
     the batch time, remote blocks, L1 hits and misses and blocks per
     node; the same over the socket wire, sync on hot and hot_window,
     pipelined on hot_window (uniform once, sync, while the phase is under
     RING_SOCKET_UNIFORM_S old), with the
     bytes on the wire a batch and their rate beside the fetch's own read
     and assembly rates; chaos: one peer killed and one browned out through
     ``faults.inject``, every batch equal, failovers counted and the
     engine's degraded batches, then the peers back and the circuits closed
     by ``probe_peers``, the next batch served remotely, and the kill
     without a fallback raising a ``TransportError``; ``termination=
     "exact"`` through the segmented-fetch executor on uniform and
     hot_window, equal to the untruncated ring batch bit for bit; an 8 GiB
     device cache over the ring (warm batches count ``device_hits``); the
     launcher with ``--cache-shards 3 --cache-transport socket
     --device-cache-mb 8192``, every response held against a RAM engine.
     Inside 3d, a loopback ring opened before ``compact_deltas`` serves
     one hot batch before and after ``refresh``, each equal to the
     rebuild, the second with L1 invalidations and no stale answer;
  3h. (run between 3g and 3d, on 3c's checkpoint) the multi-shard search:
     6 spawned ranks as a (data=2, model=3) ``torch.distributed`` mesh on
     the one card (gloo), each holding its K/6 clusters of the checkpoint
     (``storage.load_index_shard``, only its record range read), the
     sharded search through both backends on 1 warm-up + 2 batches of each
     mix, each batch's plan, scan and tree merge timed on every rank;
     every batch at ``p_cap_slack = 6`` (nothing can overflow) equal on
     every rank to the one-shard search (phase 3b's) on the same batch,
     the default slack's overflow logged and its answers held to the
     reference's invariants; rank 3 dropped through ``shard_ok`` (no id of
     its clusters, every id passing its filter, no more live results); a
     ``SearchServer`` on rank 0 driving the others (``lead`` / ``follow``)
     on the uniform batches, the last with one shard failed in
     ``ShardHealth`` (served degraded); one ``compressed_psum_tree`` over
     the 6 ranks against the mean computed in the parent.  The ranks'
     kernel launches are summed into the kernels line;
  3i. (run right after phase 2, before phase 3 allocates anything) the
     examples, training and the recsys models: each port example
     (``examples/torch/*.py``) at its own size on the card, its printed
     claims held; the four recsys configs at their published widths
     (din, sasrec, bst, wide_deep with 40 fields x 1,048,576 x 32), 3
     ``Trainer`` steps each from ``recsys_batch`` at a batch of 256 (AdamW;
     wide_deep also Adafactor), the first step's loss and parameters held
     against the same step on the CPU (rtol 1e-4; wide_deep's
     ``vocab_sparse`` cut, and the cut printed, only where MemAvailable
     cannot hold its CPU step); sasrec's restart (4 steps straight against
     2 + a checkpoint + a fresh ``Trainer`` + 2) equal bit for bit; SASRec
     retrieval: ``config()`` user vectors for 256 histories querying an
     index over all 1,048,576 L2-normalised item rows (K = 1024, f32,
     D = 50) with the example's filters at k = 100, T = 16, through
     ``search_fused`` and ``SearchEngine``, each held against
     ``search_reference`` and ``brute_force`` and timed; both scans against
     their plain versions at D = 18, 32, 50, 64 f32 and on the retrieval's
     full-size operands (timed beside plain and bound).  The examples' and
     the retrieval's launches count into the kernels line;
  4. each kernel on one full-size batch: held against its plain version,
     timed beside its bound (and beside ``torch.matmul`` + ``torch.topk``
     for centroid_topk); filtered_scan_tiled on both of its full-size
     operand sets: the engine's (bf16 queries) and the sharded tiled
     backend's (f32 queries against the bf16 index), and on the engine's
     at k = 100; centroid_topk at T = n_probes and at T = 56 (the widest
     plan of ``t_max="auto"``), and timed at T = 8, 32, 128 and K; the
     per-probe filtered_scan on the per-probe slot table of each mix, pads
     included (with ``--variants``, also its compile-time variants,
     FS_VARIANT_DEFINES).

Prints the card's name and power limit, a JSON line describing every
kernel, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
check raises, and the script exits non-zero without that line.  Exits
non-zero at once where no CUDA device is present.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

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
DISK_WARMUP, DISK_BATCHES = 1, 3  # per (executor, mix) in phase 3c
LIVE_WARMUP, LIVE_BATCHES = 1, 2  # per (executor, mix) in phase 3d
DELTA_BUDGET_MB = 256  # the reference's --delta-budget-mb
TOMB_SHARE = ADD_SHARE = 0.01  # of the base rows: 100,000 each at N = 10M
K_WIDE = 100  # the paper's Table 1 k
T_WIDE = 8 * N_PROBES  # the widest t_max="auto" plan
N_CHECK = 16  # queries per batch held against search_reference
SPIN_CYCLES = 200_000_000  # ~0.1 s at ~2 GHz: longer than a timed run takes to issue


def log(msg):
    print(msg, flush=True)


def ms(fn, reps, queued=True):
    """Median time of one call of ``fn`` in ms over ``reps`` calls, between
    CUDA events.  ``queued``: the calls wait behind a spin of the card
    (``torch.cuda._sleep``) while the host issues them all, so the time is
    the card's alone (gaps between launches included) and not the host's
    Python, checks and allocations; else each call is timed from an idle
    card, the host's issue time included."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    times = []
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
        for i in range(reps):
            ev[i].record()
            fn()
        ev[reps].record()
        ev[reps].synchronize()
        times = [ev[i].elapsed_time(ev[i + 1]) for i in range(reps)]
    else:
        for i in range(reps):
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
    return statistics.median(times)


def check_topk(name, gv, gi, wv, wi, w_next=None):
    """Top-k lists against their plain version: vals within rtol 1e-5 +
    atol 1e-5·max|val|, ids exact where the value is apart from its
    neighbours by more than twice that atol, pads (NEG_INF) with id -1.
    ``w_next`` is the plain version's next value past the list, if known:
    the last entry is then a near-tie when it lies that close to it.
    Returns max |err|."""
    import torch

    live = wv > NEG_INF / 2
    if not torch.equal(gv > NEG_INF / 2, live):
        raise AssertionError(f"{name}: a different set of entries passed")
    scale = float(wv[live].abs().max()) if bool(live.any()) else 1.0
    atol = 1e-5 * scale
    err = (gv - wv).abs()
    err = torch.where(live, err, 0.0)
    max_err = float(err.max()) if err.numel() else 0.0
    if bool((err > atol + 1e-5 * wv.abs()).any()):
        raise AssertionError(f"{name}: vals off by up to {max_err}")
    big = torch.full_like(wv[..., :1], float("inf"))
    last = big if w_next is None else wv[..., -1:] - w_next[..., None]
    gap_prev = torch.cat([big, wv[..., :-1] - wv[..., 1:]], -1)
    gap_next = torch.cat([wv[..., :-1] - wv[..., 1:], last], -1)
    clear = live & (torch.minimum(gap_prev, gap_next) > 2 * atol)
    if not torch.equal(torch.where(clear, gi, 0), torch.where(clear, wi, 0)):
        raise AssertionError(f"{name}: ids differ away from near-ties")
    if not bool((gi[~live] == -1).all()):
        raise AssertionError(f"{name}: pads carry ids")
    return max_err


def check_scan(name, got, want, want_next=None):
    """Tiled scan output against the plain version: npass exact, then
    :func:`check_topk` on (vals, ids); ``want_next`` is the plain version
    run for k + 1 (its last value is the next one past the list).  Returns
    max |err|."""
    import torch

    if not torch.equal(got[2], want[2]):
        raise AssertionError(f"{name}: npass differs")
    w_next = None if want_next is None else want_next[0][..., -1]
    return check_topk(name, got[0], got[1], want[0], want[1], w_next)


def plain_scan(args, kw):
    """filtered_scan_tiled's plain version, and its run for k + 1."""
    from repro_torch.kernels.filtered_scan.ref import filtered_scan_tiled_ref

    return (filtered_scan_tiled_ref(*args, **kw),
            filtered_scan_tiled_ref(*args, **{**kw, "k": kw["k"] + 1}))


def sass_counts(lib):
    """Tensor-core instructions in a built library's SASS (cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "HMMA")}


def tiled_bound(slot_cluster, live, queries, lo, n_unique, qb, vpad,
                k=K_TOP, v_bytes=2, peak="bf16", d=DIM):
    """filtered_scan_tiled's least time on the card for these operands:
    (bound_ms, byte_ms, op_ms, n_live, n_clusters).  Bytes: the distinct
    clusters' rows (vectors of ``v_bytes`` a value, int16 attributes,
    int32 ids) read once, the queries, bounds and slot tables, and the
    outputs; operations: 2·QB·Vpad·D per live slot at the ``peak`` rate
    (bf16 vectors: the bf16 tensor cores; f32: f32 FMA)."""
    import torch

    n_live = int(live.sum())
    n_clusters = int(torch.unique(slot_cluster[live]).numel())
    s = slot_cluster.shape[0]
    m = lo.shape[2]
    row_bytes = d * v_bytes + m * 2 + 4
    nbytes = (n_clusters * vpad * row_bytes
              + queries.numel() * queries.element_size() + 2 * lo.numel() * 2
              + 2 * s * 4 + (0 if n_unique is None else n_unique.numel() * 4)
              + s * qb * (k * 8 + 4))
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * qb * vpad * d * n_live / PEAK_OPS[peak] * 1e3
    return max(byte_ms, op_ms), byte_ms, op_ms, n_live, n_clusters


def per_probe_bound(slot_cluster, slot_query, queries, lo, n_clusters, vpad,
                    d=DIM, m=M_ATTRS, v_bytes=2):
    """The per-probe filtered_scan's least time on the card for a slot
    table, whatever implements it.  Bytes: the distinct in-range clusters'
    rows (vectors of ``v_bytes`` a value, int16 attributes, int32 ids)
    read once, the
    queries, bounds and slot tables, and the [P, Vpad] f32 output written
    once.  Operations: 2·Vpad·D per distinct (cluster, query) pair (slots
    of one pair have one output) at the f32 FMA peak."""
    import torch

    p = slot_cluster.shape[0]
    nq = queries.shape[0]
    ok = ((slot_cluster >= 0) & (slot_cluster < n_clusters) & (slot_query >= 0)
          & (slot_query < nq))
    sc, sq = slot_cluster[ok].long(), slot_query[ok].long()
    n_clusters_read = int(torch.unique(sc).numel())
    n_pairs = int(torch.unique(sc * nq + sq).numel())
    row_bytes = d * v_bytes + m * 2 + 4  # vector, attributes, id
    small = (queries.numel() * queries.element_size() + 2 * lo.numel() * 2
             + 2 * p * 4 + p * vpad * 4)  # + the output
    nbytes = n_clusters_read * vpad * row_bytes + small
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 2 * n_pairs * vpad * d / PEAK_OPS["f32"] * 1e3
    return dict(slots=p, clusters=n_clusters_read, pairs=n_pairs,
                bytes=nbytes, byte_ms=byte_ms, op_ms=op_ms,
                bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations",
                streamed_ms=(p * vpad * row_bytes + small)
                / HBM_BYTES_PER_S * 1e3)


def check_scores(name, got, want):
    """Masked [P, Vpad] scores against the plain version: the same rows
    pass, values within rtol 1e-5 + atol 1e-5·max|score|.  Returns
    max |err|."""
    import torch

    live = want > NEG_INF / 2
    if not torch.equal(got > NEG_INF / 2, live):
        raise AssertionError(f"{name}: a different set of rows passed")
    scale = float(want[live].abs().max()) if bool(live.any()) else 1.0
    err = torch.where(live, (got - want).abs(), 0.0)
    max_err = float(err.max())
    if bool((err > 1e-5 * scale + 1e-5 * want.abs()).any()):
        raise AssertionError(f"{name}: scores off by up to {max_err}")
    return max_err


def check_centroids(name, queries, centroids, t, metric="dot"):
    """centroid_topk against its plain version (run for T + 1, so a swap
    at the list's end is judged against the next centroid).  Returns the
    kernel's (vals, ids) and max |err|."""
    from repro_torch.kernels.centroid_topk import centroid_topk as ct_mod
    from repro_torch.kernels.centroid_topk.ref import centroid_topk_ref

    got = ct_mod.centroid_topk(queries, centroids, t=t, metric=metric)
    kn = min(t + 1, centroids.shape[0])
    wv, wi = centroid_topk_ref(queries, centroids, t=kn, metric=metric)
    w_next = wv[:, t] if kn > t else None
    err = check_topk(name, got[0], got[1], wv[:, :t], wi[:, :t], w_next)
    tie = got[0][:, 1:] == got[0][:, :-1]
    if not bool((got[1][:, 1:][tie] > got[1][:, :-1][tie]).all()):
        raise AssertionError(f"{name}: a tie did not go to the lower id")
    return got, err


def small_cases(dev, gen):
    """Phase 2 operands: (name, args, kwargs) at small ragged shapes."""
    import torch

    kc, vpad, d, m, qb, n_tiles, u_cap = 7, 328, 100, M_ATTRS, 72, 3, 6
    for variant in ("dot-bf16", "dot-f32", "l2-f32", "sq8", "dot-f32q-bf16v",
                    "l2-f32q-bf16v"):
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
            elif variant.endswith("f32q-bf16v"):
                vec = vec.bfloat16()
            if variant.startswith("l2"):
                norms = (vec.float() ** 2).sum(-1)
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
            kw = dict(metric="l2" if variant.startswith("l2") else "dot",
                      k=K_TOP, q_block=qb)
            yield f"{variant} F={f}", args, kw
            if f == 1 and variant in ("dot-bf16", "dot-f32", "sq8"):
                for k in (33, K_WIDE, 257):  # 2, 4 list slots; the sort body
                    yield f"{variant} F={f} k={k}", args, dict(kw, k=k)


def centroid_cases(dev, gen):
    """Phase 2 operands of centroid_topk: (name, queries, centroids, t,
    metric); K = 333 fills no whole 128-centroid tile, duplicated centroids
    tie exactly, and one case has every score below 0."""
    import torch

    kc, d, q = 333, 100, 37
    cents = torch.randn((kc, d), generator=gen, device=dev)
    cents[[40, 41, 300]] = cents[7].clone()
    queries = torch.cat([cents[[7, 7]],
                         torch.randn((q - 2, d), generator=gen, device=dev)])
    for metric in ("dot", "l2"):
        for dtype in (torch.float32, torch.bfloat16):
            for t in (1, 7, 32, 33, T_WIDE, 200, kc):
                yield (f"{metric} {str(dtype)[6:]} T={t}", queries.to(dtype),
                       cents.to(dtype), t, metric)
    pos = torch.rand((4, 8), generator=gen, device=dev) + 0.1
    neg = -(torch.rand((96, 8), generator=gen, device=dev) + 0.1)
    yield "all scores negative", pos, neg, 4, "dot"


def per_probe_cases(dev, gen):
    """Phase 2 operands of the per-probe filtered_scan: (name, args,
    kwargs) for its five variants, F = 1 and 2, D = 100 (scalar loads) and
    96 (16-byte loads); a run of slots scans one cluster."""
    import torch

    kc, vpad, m, q, p = 7, 300, M_ATTRS, 9, 40
    for variant in ("dot-bf16", "dot-f32", "dot-f32q-bf16v", "sq8", "l2-f32"):
        for f in (1, 2):
            for d in (100, 96):
                def ri(lo, hi, shape, dtype):
                    return torch.randint(lo, hi, shape, generator=gen,
                                         device=dev, dtype=dtype)

                vec = torch.randn((kc, vpad, d), generator=gen, device=dev)
                queries = torch.randn((q, d), generator=gen, device=dev)
                norms = scales = None
                if variant == "sq8":
                    scales = vec.abs().amax(-1) / 127.0
                    vec = torch.clamp(torch.round(vec / scales[..., None]),
                                      -127, 127).to(torch.int8)
                elif variant == "dot-bf16":
                    vec, queries = vec.bfloat16(), queries.bfloat16()
                elif variant == "dot-f32q-bf16v":
                    vec = vec.bfloat16()
                else:
                    norms = (vec ** 2).sum(-1) if variant == "l2-f32" else None
                slot_cluster = torch.cat([
                    torch.full((8,), 3, device=dev, dtype=torch.int32),
                    ri(0, kc, (p - 8,), torch.int32)])
                args = (slot_cluster, ri(0, q, (p,), torch.int32),
                        queries.contiguous(), ri(-8, 3, (q, f, m), torch.int16),
                        ri(3, 14, (q, f, m), torch.int16), vec.contiguous(),
                        ri(0, 16, (kc, vpad, m), torch.int16),
                        ri(-1, 10**6, (kc, vpad), torch.int32), norms, scales)
                kw = dict(metric="l2" if variant == "l2-f32" else "dot")
                yield f"{variant} F={f} D={d}", args, kw


# The per-probe filtered_scan.cu's compile-time experiment switches, each
# timed by --variants beside the shipped build: what each stage adds.
FS_VARIANT_DEFINES = {
    "the plan alone": ("-DFS_VARIANT=3",),
    "plan + streaming the rows": ("-DFS_VARIANT=1",),
    "+ sums and epilogue, each pair to one slot": ("-DFS_VARIANT=2",),
    "one thread a row (FS_SPLIT=1)": ("-DFS_SPLIT=1",),
}


def time_variants(fs_mod, tables):
    """Times the FS_VARIANT_DEFINES builds of the per-probe filtered_scan on
    each mix's slot table (the shipped build's times are phase 4's).  The
    variants are launched through the wrapper with their library put in
    place of the shipped one, which is restored after."""
    import ctypes

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    paths = build.build_variants(fs_mod.PER_PROBE_SOURCE, FS_VARIANT_DEFINES)
    log(f"built {len(paths)} variants of filtered_scan in "
        f"{time.perf_counter() - t0:.2f} s")
    shipped = build.load(fs_mod.PER_PROBE_SOURCE)
    try:
        for name, path in paths.items():
            build._LIBS[fs_mod.PER_PROBE_SOURCE] = ctypes.CDLL(str(path))
            times = {mix: ms(lambda pa=pa: fs_mod.filtered_scan(*pa), 10)
                     for mix, pa in tables.items()}
            log(f"filtered_scan variant {name} {FS_VARIANT_DEFINES[name]}: "
                + ", ".join(f"{mix} {t:.3f} ms" for mix, t in times.items()))
    finally:
        build._LIBS[fs_mod.PER_PROBE_SOURCE] = shipped


def make_data(n, dev, gen):
    """The topic-mixture dataset of benchmarks/bench_search.py::build_sweep
    at full width, generated on the card in chunks: (core bf16 [n, D],
    attrs int16 [n, M], topic [n], centers [K, D])."""
    import torch

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
    return core, attrs, topic, centers


def make_index(n, dev, gen):
    """:func:`make_data`'s dataset and its index, built from the topics as
    assignments."""
    import torch

    from repro_torch.core import HybridSpec, build_from_assignments

    core, attrs, topic, centers = make_data(n, dev, gen)
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


def probe_agreement(index, queries):
    """[Q] bool: the sharded search's probes (probe_centroids, the kernel)
    are the same set as search_centroids' (torch.matmul).  Where they are
    not, check_centroids must find only near-ties of the centroid scores."""
    from repro_torch.core import search_centroids
    from repro_torch.kernels.centroid_topk import probe_centroids

    got = probe_centroids(queries, index.centroids, t=N_PROBES)[1]
    want = search_centroids(index, queries, N_PROBES)[0]
    agree = (got.sort(-1).values == want.sort(-1).values).all(-1)
    if not bool(agree.all()):
        check_centroids("probe sets", queries, index.centroids, N_PROBES)
    return agree


def check_sharded(name, index, queries, fspec, res, eng, agree):
    """A sharded-search batch: no overflow, N_CHECK queries against
    search_reference and the whole batch against the engine's result, on
    the queries whose probe sets agree."""
    from repro_torch.core import FilterSpec, search_reference

    if res.scores.shape != (Q, K_TOP) or not bool(res.scores.isfinite().all()):
        raise AssertionError(f"{name}: malformed scores")
    if int(res.n_scanned.abs().max()) != 0 or int(res.n_passed.abs().max()):
        raise AssertionError(f"{name}: overflow count or n_passed not 0")
    sel = slice(0, N_CHECK)
    ref = search_reference(index, queries[sel],
                           FilterSpec(lo=fspec.lo[sel], hi=fspec.hi[sel]),
                           k=K_TOP, n_probes=N_PROBES)
    a = agree[sel]
    check_topk(f"{name} vs search_reference", res.scores[sel][a],
               res.ids[sel][a], ref.scores[a], ref.ids[a])
    check_topk(f"{name} vs the engine", res.scores[agree], res.ids[agree],
               eng.scores[agree], eng.ids[agree])


def check_fused(name, index, queries, fspec, res, eng):
    """A search_fused batch against search_reference (N_CHECK queries,
    counters exact) and the engine (the whole batch, n_passed exact)."""
    import torch

    from repro_torch.core import FilterSpec, search_reference

    sel = slice(0, N_CHECK)
    ref = search_reference(index, queries[sel],
                           FilterSpec(lo=fspec.lo[sel], hi=fspec.hi[sel]),
                           k=K_TOP, n_probes=N_PROBES)
    check_topk(f"{name} vs search_reference", res.scores[sel], res.ids[sel],
               ref.scores, ref.ids)
    for c in ("n_scanned", "n_passed"):
        if not torch.equal(getattr(res, c)[sel], getattr(ref, c)):
            raise AssertionError(f"{name}: {c} differs from search_reference")
    check_topk(f"{name} vs the engine", res.scores, res.ids, eng.scores,
               eng.ids)
    if not torch.equal(res.n_passed, eng.n_passed):
        raise AssertionError(f"{name}: n_passed differs from the engine")


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


def host_available():
    """The host's MemAvailable, bytes (/proc/meminfo)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("/proc/meminfo has no MemAvailable")


def meminfo():
    """Page cache and dirty pages of the host, GiB (/proc/meminfo)."""
    vals = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, rest = line.split(":", 1)
            if key in ("MemAvailable", "Cached", "Dirty"):
                vals[key] = int(rest.split()[0]) / 2**20
    return ", ".join(f"{k} {v:.2f} GiB" for k, v in vals.items())


def page_cache_share(paths):
    """Share of the files' pages resident in the OS page cache (mincore
    over a private read mapping of each file)."""
    import ctypes
    import mmap

    libc = ctypes.CDLL(None, use_errno=True)
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
    page = mmap.PAGESIZE
    resident = total = 0
    for path in paths:
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            mm = mmap.mmap(f.fileno(), size, access=mmap.ACCESS_COPY)
            try:
                buf = (ctypes.c_char * size).from_buffer(mm)
                vec = (ctypes.c_ubyte * ((size + page - 1) // page))()
                if libc.mincore(ctypes.addressof(buf), size, vec) != 0:
                    raise OSError(ctypes.get_errno(), "mincore failed")
                resident += int((np.frombuffer(vec, np.uint8) & 1).sum())
                total += len(vec)
                del buf
            finally:
                mm.close()
    return resident / max(total, 1)


def h2d_rate(dev):
    """The card's pinned host-to-device copy rate, bytes/s: one 1 GiB
    pinned tensor, the median of 5 copies between CUDA events."""
    import torch

    src = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    t = ms(lambda: dst.copy_(src, non_blocking=True), 5)
    del src, dst
    return (1 << 30) / (t / 1e3)


def block_bytes(man):
    """Bytes of one cluster's block on the card: every record field but
    its generation stamp."""
    from repro_torch.core import storage

    return sum(int(np.prod(f["shape"])) * storage.np_dtype(f["dtype"]).itemsize
               for f in man["fields"] if f["name"] != "gen")


def same_result(name, got, want):
    """A disk-tier batch against the RAM engine's: ids identical, the
    counters exact, scores within rtol 1e-5."""
    import torch

    if not torch.equal(got.ids, want.ids):
        raise AssertionError(f"{name}: ids differ from the RAM engine")
    for c in ("n_scanned", "n_passed", "n_pruned"):
        if not torch.equal(getattr(got, c), getattr(want, c)):
            raise AssertionError(f"{name}: {c} differs from the RAM engine")
    live = want.scores > NEG_INF / 2
    err = (got.scores - want.scores).abs()
    if bool((err > 1e-5 * want.scores.abs())[live].any()):
        raise AssertionError(f"{name}: scores differ beyond rtol 1e-5")
    return float(err[live].max()) if bool(live.any()) else 0.0


def disk_budget(ckpt, kc, record_stride):
    """A resident budget of the resident set plus half the records."""
    from repro_torch.core import DiskIVFIndex

    with DiskIVFIndex.open(str(ckpt)) as probe:
        overhead = probe.resident_bytes()  # empty cache: resident set
    return overhead, overhead + (kc // 2) * record_stride


def disk_phase(index, batches, ram_results, dev, *, reset_launches,
               launches, rate):
    """Phase 3c: ``index`` written with the port's save_index, opened as a
    DiskIVFIndex under a budget of half its records, and served through
    SearchEngine with both executors on each mix's first DISK_WARMUP +
    DISK_BATCHES batches; every batch held against the RAM engine's
    result.  Returns the launch counts of the disk runs, the rows, and the
    checkpoint, which the caller deletes (phase 3d serves it)."""
    import torch

    from repro_torch.core import DiskIVFIndex, SearchEngine
    from repro_torch.core import storage

    ckpt = ROOT / "build" / "disk_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    kc = index.n_clusters
    n_shards = 2 if kc % 2 == 0 else 1
    ok = False
    try:
        free = shutil.disk_usage(ckpt.parent).free
        log(f"disk tier: {free / 2**30:.2f} GiB free under {ckpt.parent} "
            f"before the write; host memory: {meminfo()}")
        t0 = time.perf_counter()
        storage.save_index(index, str(ckpt), n_shards=n_shards, layout=3)
        t_write = time.perf_counter() - t0
        man = storage.load_manifest(str(ckpt))
        paths = storage.shard_paths(str(ckpt), man)
        size = sum(p.stat().st_size for p in ckpt.iterdir())
        log(f"save_index (layout 3, {n_shards} shards): {size / 2**30:.3f} GiB "
            f"({kc} records of {man['record_stride'] / 1e6:.3f} MB) in "
            f"{t_write:.2f} s, {size / t_write / 1e9:.2f} GB/s; host memory "
            f"after: {meminfo()}; shard pages in the page cache "
            f"{page_cache_share(paths):.4f}")

        overhead, budget = disk_budget(ckpt, kc, man["record_stride"])
        disk = DiskIVFIndex.open(str(ckpt), resident_budget_bytes=budget)
        bb = block_bytes(man)
        rows = {}
        try:
            log(f"DiskIVFIndex.open: budget {budget / 2**30:.3f} GiB = "
                f"resident set {overhead / 2**20:.2f} MiB + "
                f"{disk.cache.capacity_records} of {kc} records; a block on "
                f"the card {bb / 1e6:.3f} MB; pinned H2D "
                f"{rate / 1e9:.2f} GB/s")
            reset_launches()
            for pipeline in ("off", "on"):
                eng = SearchEngine(disk, k=K_TOP, n_probes=N_PROBES,
                                   q_block=64, prune="auto", pipeline=pipeline,
                                   pipeline_depth=2, operand_cache="auto")
                try:
                    for mix in batches:
                        rows[pipeline, mix] = serve_disk(
                            eng, disk, mix, batches[mix], ram_results[mix],
                            bb, rate)
                finally:
                    eng.close()
            disk_launches = launches()
            fetch_breakdown(disk, rows["off", "uniform"].pop("plan_obj"), bb,
                            rate, dev)
            log(f"disk tier: launches {disk_launches} in "
                f"{2 * len(batches) * (DISK_WARMUP + DISK_BATCHES)} batches; "
                f"host memory: {meminfo()}; shard pages in the page cache "
                f"{page_cache_share(paths):.4f}")
        finally:
            disk.close()
        if disk_launches["filtered_scan_tiled"] < 2 * len(batches) * (
                DISK_WARMUP + DISK_BATCHES):
            raise AssertionError("the disk tier did not launch "
                                 "filtered_scan_tiled on every batch")
        for (pipeline, mix), r in rows.items():
            log(f"disk tier pipeline={pipeline} {mix}: batch {r['batch']:.3f} "
                f"ms = plan {r['plan']:.3f} + fetch wait {r['fetch']:.3f} + "
                f"scan+merge {r['scan']:.3f} (medians of {DISK_BATCHES}); "
                f"{r['gb_store']:.3f} GB through the store, {r['gb_card']:.3f} "
                f"GB to the card ({r['gb_distinct']:.3f} GB distinct), "
                f"{r['gbps']:.2f} GB/s to the card over the "
                f"{'fetch stage' if pipeline == 'off' else 'execute stage'}; "
                f"H2D bound of the distinct bytes {r['bound']:.3f} ms; "
                f"overlap_ratio {r['overlap']:.4f}; blocks_fetched "
                f"{r['fetched']:.1f} / blocks_reused {r['reused']:.1f} a "
                f"batch; cache hit "
                f"rate {r['hit_rate']:.4f}; max |err| vs RAM {r['err']:.3e}")
        ok = True
        return disk_launches, rows, ckpt
    finally:
        if not ok:
            shutil.rmtree(ckpt, ignore_errors=True)


def fetch_breakdown(disk, plan, bb, rate, dev, label="sync uniform batch"):
    """The sync fetch of one planned batch split into its host steps, run
    twice (the second is printed): every distinct record read from the
    shard files past the cache (``ShardReader.read``), the blocks assembled
    in pinned memory with their copies enqueued on a side stream
    (``assemble_blocks``), and the wait for those copies."""
    import torch

    from repro_torch.core import blockstore

    flat = np.asarray(plan.slot_cluster).reshape(-1)
    uniq, local = blockstore.first_need_unique(flat)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = {int(c): disk.reader.read(c) for c in uniq}
        t1 = time.perf_counter()
        blocks = blockstore.assemble_blocks(flat, uniq, local, recs,
                                            disk.blockstore.spec,
                                            as_device=True, device=dev)
        t2 = time.perf_counter()
        blockstore.wait_blocks(blocks)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        del blocks, recs
    rec_gb = len(uniq) * disk.reader.stride / 1e9
    blk_gb = len(uniq) * bb / 1e9
    log(f"disk tier fetch steps, {label} ({len(uniq)} distinct "
        f"clusters): read {rec_gb:.3f} GB of records {(t1 - t0) * 1e3:.3f} ms "
        f"({rec_gb / (t1 - t0):.2f} GB/s); assemble {blk_gb:.3f} GB in pinned "
        f"memory and enqueue the copies {(t2 - t1) * 1e3:.3f} ms "
        f"({blk_gb / (t2 - t1):.2f} GB/s); copies still running after that "
        f"{(t3 - t2) * 1e3:.3f} ms (alone at the measured H2D rate "
        f"{blk_gb * 1e9 / rate * 1e3:.3f} ms)")


def serve_disk(eng, disk, mix, batch_list, ram_list, bb, rate):
    """One mix through the disk tier: DISK_WARMUP + DISK_BATCHES batches,
    each held against the RAM engine's; returns the timed batches' medians
    and sums per batch."""
    import torch

    st, cs = eng.stats, disk.cache.stats
    rows, err = [], 0.0
    for i, ((queries, fspec), want) in enumerate(zip(batch_list, ram_list)):
        before = (st.blocks_fetched, st.blocks_reused, st.io_wait_s,
                  st.io_total_s, cs.hits, cs.misses)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        plan = eng.plan(queries, fspec)
        ev[1].record()
        if eng.pipeline == "off":
            operands = eng.fetch(plan)
            ev[2].record()
            res = eng.scan_merge(plan, operands)
            eng.stats.batches += 1
        else:
            res = eng.execute(plan)
            ev[2].record()
        ev[3].record()
        ev[3].synchronize()
        name = f"disk tier pipeline={eng.pipeline} {mix} batch {i}"
        if res.scores.shape != (Q, K_TOP) or not bool(res.scores.isfinite().all()):
            raise AssertionError(f"{name}: malformed scores")
        err = max(err, same_result(name, res, want))
        if i < DISK_WARMUP:
            continue
        d = [a - b for a, b in zip(
            (st.blocks_fetched, st.blocks_reused, st.io_wait_s, st.io_total_s,
             cs.hits, cs.misses), before)]
        sc = np.asarray(plan.slot_cluster).reshape(plan.n_tiles, plan.u_cap)
        distinct = len(np.unique(sc))
        to_card = (distinct if eng.pipeline == "off"
                   else sum(len(np.unique(t)) for t in sc))
        plan_ms = ev[0].elapsed_time(ev[1])
        if eng.pipeline == "off":
            fetch_ms = ev[1].elapsed_time(ev[2])
            scan_ms = ev[2].elapsed_time(ev[3])
            stage_ms = fetch_ms
        else:
            stage_ms = ev[1].elapsed_time(ev[3])
            fetch_ms = d[2] * 1e3
            scan_ms = stage_ms - fetch_ms
        rows.append(dict(
            batch=ev[0].elapsed_time(ev[3]), plan=plan_ms, fetch=fetch_ms,
            scan=scan_ms, gb_store=d[0] * disk.reader.stride / 1e9,
            gb_card=to_card * bb / 1e9, gb_distinct=distinct * bb / 1e9,
            gbps=to_card * bb / (stage_ms / 1e3) / 1e9,
            bound=distinct * bb / rate * 1e3,
            overlap=(max(0.0, 1 - d[2] / d[3]) if d[3] > 0 else 0.0),
            fetched=d[0], reused=d[1], hits=d[4], misses=d[5]))
    out = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    for k in ("fetched", "reused", "hits", "misses"):
        out[k] = sum(r[k] for r in rows) / len(rows)
    out["hit_rate"] = out["hits"] / max(out["hits"] + out["misses"], 1)
    out["err"] = err
    out["plan_obj"] = plan  # the last batch's plan, for fetch_breakdown
    return out


def same_as_rebuild(name, got, want):
    """A live batch against the rebuild's: ids equal except at near-ties,
    scores within rtol 1e-5 (check_topk), n_passed exact.  Returns
    max |err|."""
    import torch

    if got.scores.shape != want.scores.shape or not bool(
            got.scores.isfinite().all()):
        raise AssertionError(f"{name}: malformed scores")
    err = check_topk(name, got.scores, got.ids, want.scores, want.ids)
    if not torch.equal(got.n_passed, want.n_passed):
        raise AssertionError(f"{name}: n_passed differs from the rebuild")
    return err


def rebuild_index(index, tomb_ids, core_new, attrs_new, ids_new, assign_new,
                  dev, chunk=256):
    """A from-scratch index at the live state: ``index``'s live rows minus
    the tombstoned ids, cluster by cluster in slot order, then the adds in
    add order, each under its cluster (the order a republish writes)."""
    import torch

    from repro_torch.core import build_from_assignments

    kc, vpad, d = index.vectors.shape
    live = (index.ids >= 0) & ~torch.isin(index.ids, tomb_ids)
    n_base = int(live.sum())
    n = n_base + core_new.shape[0]
    core = torch.empty((n, d), dtype=index.vectors.dtype, device=dev)
    attrs = torch.empty((n, index.attrs.shape[-1]), dtype=torch.int16,
                        device=dev)
    ids = torch.empty((n,), dtype=torch.int32, device=dev)
    clusters = torch.empty((n,), dtype=torch.long, device=dev)
    o = 0
    for c0 in range(0, kc, chunk):  # chunks: no [N, D] gather temporary
        lv = live[c0:c0 + chunk]
        m = int(lv.sum())
        core[o:o + m] = index.vectors[c0:c0 + chunk][lv]
        attrs[o:o + m] = index.attrs[c0:c0 + chunk][lv]
        ids[o:o + m] = index.ids[c0:c0 + chunk][lv]
        clusters[o:o + m] = torch.arange(c0, c0 + lv.shape[0],
                                         device=dev)[:, None].expand(lv.shape)[lv]
        o += m
    core[o:], attrs[o:], ids[o:], clusters[o:] = (core_new, attrs_new,
                                                  ids_new, assign_new)
    rebuilt, stats = build_from_assignments(
        index.spec, index.centroids, core, attrs, clusters, ids=ids,
        device=dev)
    del core, attrs, ids, clusters
    return rebuilt, stats, n_base


def reference_over_probes(index, queries, fspec, plan, k, rows):
    """Exact filtered top-k of each of ``rows`` queries over the rows of the
    probes its plan kept (``probe_ok``), on ``index``: what a search over
    those probes must return."""
    import torch

    from repro_torch.core import FilterSpec, filter_mask
    from repro_torch.core.topk import masked_topk

    sc = torch.as_tensor(plan.slot_cluster, device=index.ids.device).long()
    sop = torch.as_tensor(plan.slot_of_probe, device=sc.device).long()
    ok = torch.as_tensor(plan.probe_ok, device=sc.device)
    vals, ids = [], []
    for i in range(rows):
        cl = sc[sop[i][ok[i]]]
        m = index.ids[cl] >= 0
        m &= filter_mask(FilterSpec(lo=fspec.lo[i:i + 1], hi=fspec.hi[i:i + 1]),
                         index.attrs[cl][None])[0]
        s = index.vectors[cl].float() @ queries[i].float()
        flat_s, flat_m = s.reshape(1, -1), m.reshape(1, -1)
        pad = max(k - flat_s.shape[1], 0)  # fewer rows than k
        if pad:
            flat_s = torch.cat([flat_s, flat_s.new_zeros((1, pad))], 1)
            flat_m = torch.cat([flat_m, flat_m.new_zeros((1, pad))], 1)
        v, j = masked_topk(flat_s, flat_m, k, ids=torch.cat(
            [index.ids[cl].reshape(1, -1),
             index.ids.new_full((1, pad), -1)], 1))
        vals.append(v[0])
        ids.append(j[0])
    return torch.stack(vals), torch.stack(ids)


def serve_live(eng, mix, batch_list, want_list):
    """One mix through an engine with a delta tier: LIVE_WARMUP +
    LIVE_BATCHES batches, each held against the rebuild's result.  The sync
    executor's batches are split into plan, fetch, scan+merge and the delta
    fold (CUDA events); returns the timed batches' medians."""
    import torch

    rows, err = [], 0.0
    for i, ((queries, fspec), want) in enumerate(zip(batch_list, want_list)):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        plan = eng.plan(queries, fspec)
        ev[1].record()
        if eng.pipeline == "off":
            operands = eng.fetch(plan)
            ev[2].record()
            res = eng.scan_merge(plan, operands)
            ev[3].record()
            res = eng._fold_delta(plan, res)
            eng.stats.batches += 1
        else:
            res = eng.execute(plan)
            ev[2].record()
            ev[3].record()
        ev[4].record()
        ev[4].synchronize()
        err = max(err, same_as_rebuild(
            f"live pipeline={eng.pipeline} {mix} batch {i}", res, want))
        if i >= LIVE_WARMUP:
            rows.append(dict(batch=ev[0].elapsed_time(ev[4]),
                             plan=ev[0].elapsed_time(ev[1]),
                             fold=ev[3].elapsed_time(ev[4])))
    out = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    out["err"] = err
    out["plan_obj"] = plan
    return out


def live_phase(index, centers, ckpt, dev, gen, *, reset_launches, launches):
    """Phase 3d: live updates on the checkpoint of phase 3c (``index``'s):
    a DiskIVFIndex with a DELTA_BUDGET_MB delta tier takes TOMB_SHARE of
    the base rows as deletes and up to ADD_SHARE as adds, and serves the
    three mixes through both executors and at k = K_WIDE, before and after
    ``compact_deltas`` + ``refresh``, every batch held against a rebuild
    at the same logical state; then hot_window through widened plans.
    Returns the launch counts of the live runs and the figures to print."""
    import torch

    from repro_torch.core import (
        DeltaTier, DiskIVFIndex, SearchEngine, compact_deltas, open_sharded,
        recall_at_k, storage)
    from repro_torch.core import delta as delta_lib
    from repro_torch.core import engine as engine_lib
    from repro_torch.core import kmeans
    from repro_torch.core.devicecache import DeviceBlockCache
    from repro_torch.core.search import SearchResult
    from repro_torch.core.summaries import ClusterSummaries

    t_phase = time.perf_counter()
    kc, vpad = index.n_clusters, index.vpad
    man = storage.load_manifest(str(ckpt))
    _, budget = disk_budget(ckpt, kc, man["record_stride"])
    disk = DiskIVFIndex.open(str(ckpt), resident_budget_bytes=budget)
    tier = disk.delta = DeltaTier.for_index(disk, DELTA_BUDGET_MB)
    log(f"live updates: delta tier of {DELTA_BUDGET_MB} MiB = "
        f"{tier.capacity} rows of {DeltaTier.row_bytes(disk)} B on {tier.device}")
    engines = {}
    try:
        # ---- deletes: uniform over the cold ids, with cluster hints ----
        live = index.ids >= 0
        n_base = int(live.sum())
        cluster_of = torch.full((int(index.ids.max()) + 1,), -1,
                                dtype=torch.long, device=dev)
        cluster_of[index.ids[live].long()] = torch.arange(
            kc, device=dev)[:, None].expand(live.shape)[live]
        n_tombs, n_draw = int(TOMB_SHARE * n_base), int(ADD_SHARE * n_base)
        cold = index.ids[live]
        tomb_ids = cold[torch.randperm(n_base, generator=gen, device=dev)
                        [:n_tombs]]
        hints = cluster_of[tomb_ids.long()]
        t0 = time.perf_counter()
        n_dead = tier.tombstone(tomb_ids.cpu().numpy(), hints.cpu().numpy())
        t_tomb = time.perf_counter() - t0

        # ---- adds: the build's topic mixture, within each cluster's room ----
        band = TS_RANGE // kc
        topics = torch.randint(0, kc, (n_draw,), generator=gen, device=dev)
        x = centers[topics] + 0.05 * torch.randn((n_draw, DIM), generator=gen,
                                                 device=dev)
        core_new = (x / x.norm(dim=-1, keepdim=True)).bfloat16()
        attrs_new = torch.randint(0, 16, (n_draw, M_ATTRS), generator=gen,
                                  device=dev, dtype=torch.int16)
        attrs_new[:, 0] = (topics * band + torch.randint(
            0, max(band, 1), (n_draw,), generator=gen, device=dev)).to(
                torch.int16)
        assign = kmeans.assign(core_new.float(), disk.centroids).long()
        room = (vpad - disk.counts.long()
                + torch.bincount(hints, minlength=kc))
        order = torch.argsort(assign, stable=True)
        a_sorted = assign[order]
        starts = torch.searchsorted(a_sorted, torch.arange(kc, device=dev))
        keep = torch.zeros(n_draw, dtype=torch.bool, device=dev)
        keep[order] = (torch.arange(n_draw, device=dev) - starts[a_sorted]
                       < room[a_sorted])
        core_new, attrs_new = core_new[keep], attrs_new[keep]
        assign = assign[keep]
        n_add = core_new.shape[0]
        ids_new = (int(index.ids.max()) + 1 + torch.arange(
            n_add, device=dev)).int()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tier.add(core_new, attrs_new, ids_new)
        torch.cuda.synchronize()
        t_add = time.perf_counter() - t0
        log(f"live updates: tombstoned {n_dead} cold rows in {t_tomb:.3f} s "
            f"({n_dead / t_tomb:.0f} rows/s); added {n_add} of {n_draw} drawn "
            f"rows (the rest would overflow their cluster's free slots) in "
            f"{t_add:.3f} s ({n_add / t_add:.0f} rows/s); delta "
            f"{tier.stats()}")

        # ---- the rebuild at the same logical state ----
        t0 = time.perf_counter()
        rebuilt, rstats, n_kept = rebuild_index(
            index, tomb_ids, core_new, attrs_new, ids_new, assign, dev)
        torch.cuda.synchronize()
        if rstats.n_dropped:
            raise AssertionError("the rebuild dropped rows")
        log(f"rebuild: {n_kept} live base rows + {n_add} adds, K={kc} "
            f"Vpad={rebuilt.vpad}, {rebuilt.nbytes() / 2**30:.2f} GiB, in "
            f"{time.perf_counter() - t0:.2f} s; card memory "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; host memory: "
            f"{meminfo()}")
        del core_new, attrs_new
        torch.cuda.empty_cache()
        ref_eng = SearchEngine(rebuilt, k=K_TOP, n_probes=N_PROBES,
                               q_block=64, prune="auto")
        mixes = ("hot", "uniform", "hot_window")
        batches = {mix: [mix_batch(mix, centers, dev, gen)
                         for _ in range(LIVE_WARMUP + LIVE_BATCHES)]
                   for mix in mixes}
        wants = {mix: [ref_eng.search(q, f) for q, f in batches[mix]]
                 for mix in mixes}
        wide_batch = batches["uniform"][-1]
        want_wide = SearchEngine(rebuilt, k=K_WIDE, n_probes=N_PROBES,
                                 q_block=64, prune="auto").search(*wide_batch)
        for pipeline in ("off", "on"):
            engines[pipeline] = SearchEngine(
                disk, k=K_TOP, n_probes=N_PROBES, q_block=64, prune="auto",
                pipeline=pipeline, pipeline_depth=2, operand_cache="auto")
        engines["wide"] = SearchEngine(disk, k=K_WIDE, n_probes=N_PROBES,
                                       q_block=64, prune="auto",
                                       pipeline="off")
        # a sync engine with a device cache on the hot mix: its entries of
        # the clusters the republish rewrites must drop at its refresh
        dc = DeviceBlockCache(disk.blockstore.spec, DEVICE_CACHE_MB << 20,
                              heat_fn=disk.cache.probe_heat, device=dev)
        engines["dc"] = SearchEngine(disk, k=K_TOP, n_probes=N_PROBES,
                                     q_block=64, prune="auto", pipeline="off",
                                     device_cache=dc)
        # phase 3g (g): a loopback ring over the checkpoint across the
        # republish; its refresh reopens the peers, and its L1 drops exactly
        # the superseded records it is asked for again
        ring = open_sharded(str(ckpt), n_nodes=RING_NODES,
                            capacity_records=max(
                                disk.cache.capacity_records // RING_NODES, 1),
                            fallback=disk.blockstore)
        engines["ring"] = SearchEngine(disk, blockstore=ring, k=K_TOP,
                                       n_probes=N_PROBES, q_block=64,
                                       prune="auto", pipeline="off")

        rows = {}
        reset_launches()
        for stage in ("before", "after"):
            if stage == "after":  # the republish, then the flip
                gens_before = disk.gens.copy()
                t0 = time.perf_counter()
                rep = compact_deltas(str(ckpt), tier)
                t_compact = time.perf_counter() - t0
                t0 = time.perf_counter()
                changed = engines["off"].refresh()
                t_refresh = time.perf_counter() - t0
                if not changed or tier.stats()["rows"] != 0:
                    raise AssertionError("the refresh did not adopt the "
                                         "republished generation")
                log(f"republish: compact_deltas {t_compact:.2f} s ({rep}); "
                    f"refresh {t_refresh:.3f} s; delta {tier.stats()}")
                resident = dc.resident_ids()
                st0 = dc.stats()
                engines["dc"].refresh()
                rewritten = set(np.nonzero(disk.gens > gens_before)[0].tolist())
                stale = [c for c in resident if c in rewritten]
                dropped = dc.stats()["invalidations"] - st0["invalidations"]
                if (set(dc.resident_ids()) != set(resident) - rewritten
                        or dropped != len(stale) + st0["tiles"]):
                    raise AssertionError(
                        f"device cache: {dropped} invalidations for "
                        f"{len(stale)} stale entries and {st0['tiles']} tiles")
                dc_inval = dict(resident=len(resident), rewritten=len(
                    rewritten), dropped=dropped, tiles=st0["tiles"])
                log(f"republish: device cache refresh dropped {dropped} = "
                    f"{len(stale)} entries of rewritten clusters (of "
                    f"{len(resident)} resident; {len(rewritten)} clusters "
                    f"rewritten) + {st0['tiles']} memoized tiles")
            for pipeline in ("off", "on"):
                for mix in mixes:
                    before = launches()["filtered_scan_tiled"]
                    rows[stage, pipeline, mix] = serve_live(
                        engines[pipeline], mix, batches[mix], wants[mix])
                    if launches()["filtered_scan_tiled"] - before < len(
                            batches[mix]):
                        raise AssertionError(f"live {stage} {pipeline} {mix}: "
                                             "not every batch launched "
                                             "filtered_scan_tiled")
            if stage == "after":
                engines["ring"].refresh()
            before = launches()["filtered_scan_tiled"]
            s0 = ring.stats()
            t0 = time.perf_counter()
            got = engines["ring"].search(*batches["hot"][-1])
            torch.cuda.synchronize()
            ring_ms = (time.perf_counter() - t0) * 1e3
            err = same_as_rebuild(f"live {stage} ring hot", got,
                                  wants["hot"][-1])
            s1 = ring.stats()
            if launches()["filtered_scan_tiled"] == before:
                raise AssertionError(f"live {stage} ring: no launch")
            rows[stage, "ring"] = dict(
                batch=ring_ms, err=err,
                l1_invalidations=s1["l1_invalidations"]
                - s0["l1_invalidations"],
                stale=s1["stale_answers"], remote=s1["remote_blocks"]
                - s0["remote_blocks"], l1_hits=s1["l1_hits"] - s0["l1_hits"])
            if stage == "after" and (rows[stage, "ring"]["l1_invalidations"]
                                     == 0 or s1["stale_answers"]):
                raise AssertionError(f"live ring after the republish: "
                                     f"{rows[stage, 'ring']}")
            rows[stage, "dc", "hot"] = serve_live(
                engines["dc"], "hot", batches["hot"], wants["hot"])
            rows[stage, "dc", "hot"]["hit_rate"] = dc.hit_rate()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            got = engines["wide"].search(*wide_batch)
            ev[1].record()
            ev[1].synchronize()
            same_as_rebuild(f"live {stage} k={K_WIDE}", got, want_wide)
            rows[stage, "wide"] = ev[0].elapsed_time(ev[1])
            if stage == "before":
                # the delta scan alone on the uniform batch's plan
                plan = rows[stage, "off", "uniform"]["plan_obj"]
                snap = plan.delta_snap
                scan_ms = ms(lambda: delta_lib.scan_snapshot(
                    snap, plan.queries, plan.queries_pad, plan.lo_pad,
                    plan.hi_pad, plan.geo_probes, plan.geo_valid,
                    metric="dot", k=K_TOP, n_clusters=kc), 5)

        # ---- widening: hot_window through t_max plans ----
        queries, fspec = batches["hot_window"][-1]
        static = rows["after", "off", "hot_window"]
        static_res = engines["off"].search(queries, fspec)
        oracle = exact_oracle(rebuilt, queries, fspec)
        r_static = recall_at_k(static_res, SearchResult(oracle[0], oracle[1],
                                                        None, None))
        summ = disk.summaries
        summ_cpu = ClusterSummaries(**{f: getattr(summ, f).cpu() for f in (
            "amin", "amax", "hist", "edges_lo", "edges_hi")})
        wide_rows = {}
        for t_max in (4 * N_PROBES, "auto"):
            eng = SearchEngine(disk, k=K_TOP, n_probes=N_PROBES, q_block=64,
                               prune="auto", pipeline="off", t_max=t_max)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            plan = eng.plan(queries, fspec)
            res = eng.execute(plan)
            ev[1].record()
            ev[1].synchronize()
            eng.close()
            # the plan on the card and on the CPU from the same resident state
            width = {}
            tables = {}
            for name, d_, sm in (("card", dev, summ),
                                 ("cpu", torch.device("cpu"), summ_cpu)):
                args = [a.to(d_) for a in (disk.centroids, disk.counts,
                                           queries, fspec.lo, fspec.hi)]
                tm = engine_lib.resolve_t_max(t_max, sm, args[1], args[3],
                                              args[4], N_PROBES, kc)
                width[name] = tm
                cap = min(plan.q_block * tm, kc)
                tables[name] = engine_lib.plan_fused_tiled(
                    *args, metric="dot", n_probes=N_PROBES,
                    q_block=plan.q_block, u_cap=cap,
                    cast_dtype=torch.bfloat16, summaries=sm, t_max=tm)
            if width["card"] != width["cpu"] or width["card"] is None:
                raise AssertionError(f"t_max={t_max}: widths {width}")
            for j, fld in enumerate(("slot_cluster", "slot_tile",
                                     "slot_of_probe", "probe_ok",
                                     "n_unique")):
                if not torch.equal(tables["card"][j].cpu(), tables["cpu"][j]):
                    raise AssertionError(f"t_max={t_max}: {fld} differs "
                                         "between the card and the CPU")
            ref = reference_over_probes(rebuilt, queries, fspec, plan, K_TOP,
                                        N_CHECK)
            check_topk(f"widened t_max={t_max} vs an exact search over its "
                       "probes", res.scores[:N_CHECK], res.ids[:N_CHECK], *ref)
            rec = recall_at_k(res, SearchResult(oracle[0], oracle[1], None,
                                                None))
            if rec < r_static:
                raise AssertionError(f"t_max={t_max}: recall {rec} below the "
                                     f"unwidened plan's {r_static}")
            wide_rows[str(t_max)] = dict(
                width=width["card"], ms=ev[0].elapsed_time(ev[1]), recall=rec,
                live_probes=int(torch.as_tensor(plan.probe_ok).sum()),
                u_cap=plan.u_cap)
        live_launches = launches()
        log(f"live phase (3d) {time.perf_counter() - t_phase:.2f} s")
        return live_launches, dict(
            rows=rows, scan_ms=scan_ms, t_tomb=t_tomb, t_add=t_add,
            n_dead=n_dead, n_add=n_add, t_compact=t_compact,
            t_refresh=t_refresh, wide=wide_rows, r_static=r_static,
            static_ms=static["batch"], dc_inval=dc_inval)
    finally:
        for eng in engines.values():
            eng.close()
        if "ring" in engines:
            ring.close()
        disk.close()


def print_live(fig):
    """Phase 3d's figures."""
    rows = fig["rows"]
    for stage in ("before", "after"):
        for pipeline in ("off", "on"):
            for mix in ("hot", "uniform", "hot_window"):
                r = rows[stage, pipeline, mix]
                fold = (f", delta fold {r['fold']:.3f} ms "
                        f"({r['fold'] / r['batch']:.1%} of the batch)"
                        if pipeline == "off" else "")
                log(f"live {stage} the republish, pipeline={pipeline} {mix}: "
                    f"batch {r['batch']:.3f} ms (median of {LIVE_BATCHES}), "
                    f"plan {r['plan']:.3f} ms{fold}; max |err| vs the rebuild "
                    f"{r['err']:.3e}")
        log(f"live {stage} the republish, k={K_WIDE} uniform batch (sync): "
            f"{rows[stage, 'wide']:.3f} ms")
        r = rows[stage, "ring"]
        log(f"live {stage} the republish, loopback ring (sync, phase 3g "
            f"(g)) hot: batch {r['batch']:.3f} ms; L1 invalidations "
            f"{r['l1_invalidations']}, L1 hits {r['l1_hits']}, remote blocks "
            f"{r['remote']}, stale answers {r['stale']}; max |err| vs the "
            f"rebuild {r['err']:.3e}")
        r = rows[stage, "dc", "hot"]
        log(f"live {stage} the republish, device cache (sync) hot: batch "
            f"{r['batch']:.3f} ms (median of {LIVE_BATCHES}); cache hit rate "
            f"so far {r['hit_rate']:.4f}; max |err| vs the rebuild "
            f"{r['err']:.3e}")
    log(f"live: delta scan alone {fig['scan_ms']:.3f} ms a uniform batch "
        f"({fig['n_add']} delta rows, card time); add {fig['n_add']} rows "
        f"{fig['n_add'] / fig['t_add']:.0f} rows/s; tombstone "
        f"{fig['n_dead']} rows {fig['n_dead'] / fig['t_tomb']:.0f} rows/s; "
        f"compact_deltas {fig['t_compact']:.2f} s; refresh "
        f"{fig['t_refresh']:.3f} s")
    for t_max, w in fig["wide"].items():
        log(f"widened hot_window t_max={t_max} (width {w['width']}, u_cap "
            f"{w['u_cap']}, {w['live_probes']} live probes): batch "
            f"{w['ms']:.3f} ms against {fig['static_ms']:.3f} ms unwidened; "
            f"recall@{K_TOP} {w['recall']:.4f} against {fig['r_static']:.4f}; "
            f"plan equal to the CPU's, results equal to an exact search over "
            f"its probes")


DEVICE_CACHE_MB = 8192  # about half of the 15.8 GB of cluster records
PART_ATTR = 1  # attr1: uniform over 16 values, one per-value entry each
PART_MAX_SUBS = 4096  # build_partitions' default cap
PART_WARMUP, PART_BATCHES = 1, 2  # per (executor, mix, routing) in phase 3e
TERM_WARMUP, TERM_BATCHES = 1, 3  # per (mix, termination) in phase 3e
EPSILON = 0.1


def cat_batch(mix, centers, dev, gen):
    """Phase 3e's catalogue traffic: Q uniform-topic queries filtering
    attr1 == 0 (``cat_eq``, every probe routes to a sub-partition), or
    every other one attr1 == 0 and the rest attr1 == v, v uniform in
    [2, 16) (``cat_mixed``: those route to an entry without subs, so every
    tile mixes sub-partitions and parents)."""
    import torch

    from repro_torch.core import FilterSpec

    queries, fspec = mix_batch("uniform", centers, dev, gen)
    lo, hi = fspec.lo.clone(), fspec.hi.clone()
    val = torch.zeros((Q,), dtype=torch.int16, device=dev)
    if mix == "cat_mixed":  # every other query: each tile mixes both kinds
        val[1::2] = torch.randint(2, 16, (Q // 2,), generator=gen,
                                  device=dev, dtype=torch.int16)
    lo[:, 0, PART_ATTR] = hi[:, 0, PART_ATTR] = val
    return queries, FilterSpec(lo=lo, hi=hi)


def over_kept(index, queries, fspec, plan, k, rows):
    """Exact filtered top-k of each of ``rows`` queries over the rows of the
    probes whose fragments its terminated merge kept (``plan.term.kept``):
    what a bounded result must equal."""
    from types import SimpleNamespace

    kept = SimpleNamespace(slot_cluster=plan.slot_cluster,
                           slot_of_probe=plan.slot_of_probe,
                           probe_ok=plan.term.kept)
    return reference_over_probes(index, queries, fspec, kept, k, rows)


def device_cache_part(ckpt, budget, batches, ram_results, dev, launches):
    """Phase 3e (a): the phase-3c checkpoint under phase 3c's host budget
    plus a DEVICE_CACHE_MB device cache (a fresh one per executor), both
    executors, each mix's phase-3c batches; every batch held against the
    RAM engine's.  Returns the rows to print and the tiled launches."""
    import torch

    from repro_torch.core import DiskIVFIndex, SearchEngine
    from repro_torch.core.devicecache import DeviceBlockCache

    rows = {}
    n0 = launches()["filtered_scan_tiled"]
    disk = DiskIVFIndex.open(str(ckpt), resident_budget_bytes=budget)
    try:
        for pipeline in ("off", "on"):
            dc = DeviceBlockCache(disk.blockstore.spec, DEVICE_CACHE_MB << 20,
                                  heat_fn=disk.cache.probe_heat, device=dev)
            eng = SearchEngine(disk, k=K_TOP, n_probes=N_PROBES, q_block=64,
                               prune="auto", pipeline=pipeline,
                               device_cache=dc)
            try:
                for mix, blist in batches.items():
                    out = []
                    for i, ((queries, fspec), want) in enumerate(
                            zip(blist, ram_results[mix])):
                        before = (dict(dc.stats()), dc.bytes_copied,
                                  eng.stats.io_wait_s)
                        ev = [torch.cuda.Event(enable_timing=True)
                              for _ in range(4)]
                        ev[0].record()
                        plan = eng.plan(queries, fspec)
                        ev[1].record()
                        if pipeline == "off":
                            operands = eng.fetch(plan)
                            ev[2].record()
                            res = eng.scan_merge(plan, operands)
                            eng.stats.batches += 1
                        else:
                            res = eng.execute(plan)
                            ev[2].record()
                        ev[3].record()
                        ev[3].synchronize()
                        err = same_result(f"device cache pipeline={pipeline} "
                                          f"{mix} batch {i}", res, want)
                        if i < DISK_WARMUP:
                            continue
                        st = dc.stats()
                        hits = st["hits"] - before[0]["hits"]
                        misses = st["misses"] - before[0]["misses"]
                        fetch = (ev[1].elapsed_time(ev[2]) if pipeline == "off"
                                 else (eng.stats.io_wait_s - before[2]) * 1e3)
                        out.append(dict(
                            batch=ev[0].elapsed_time(ev[3]), fetch=fetch,
                            hit_rate=hits / max(hits + misses, 1),
                            tile_hits=st["tile_hits"]
                            - before[0]["tile_hits"],
                            gb=(dc.bytes_copied - before[1]) / 1e9,
                            evictions=st["evictions"]
                            - before[0]["evictions"],
                            resident=st["resident_bytes"], err=err))
                    rows[pipeline, mix] = {
                        key: statistics.median(r[key] for r in out)
                        for key in out[0]}
            finally:
                eng.close()
            del eng, dc  # the engine holds the cache's entries
            torch.cuda.empty_cache()
    finally:
        disk.close()
    return rows, launches()["filtered_scan_tiled"] - n0


def write_partitions(index, ckpt, dev):
    """Phase 3e (b): ``build_partitions(index, attrs=[PART_ATTR])`` and a
    layout-4 checkpoint beside phase 3c's: the shard files and resident
    files hard-linked from it (their bytes are what save_index(layout=4)
    writes), the partition region, the extended generation vector and the
    manifest written anew.  Returns (build, directory, figures)."""
    from repro_torch.core import partitions as partitions_lib
    from repro_torch.core import storage

    t0 = time.perf_counter()
    build = partitions_lib.build_partitions(index, attrs=[PART_ATTR],
                                            max_subs=PART_MAX_SUBS)
    t_build = time.perf_counter() - t0
    cat = build.catalog
    kc = cat.n_base
    part_dir = ROOT / "build" / "partition_checkpoint"
    shutil.rmtree(part_dir, ignore_errors=True)
    part_dir.mkdir(parents=True)
    man = storage.load_manifest(str(ckpt))
    for f in os.listdir(ckpt):
        if f not in (storage.MANIFEST, storage.GENS_FILE):
            os.link(ckpt / f, part_dir / f)
    t0 = time.perf_counter()
    gens = storage.load_gens(str(ckpt), man)
    gens = np.concatenate([gens, gens[cat.parent.astype(np.int64)]])
    storage.write_partition_region(str(part_dir), man, build, gens[kc:])
    storage._atomic_save(str(part_dir / storage.GENS_FILE),
                         lambda p: storage._np_save(p, gens))
    man.update(layout=4, has_partitions=True,
               partitions=dict(n_subs=build.n_subs, n_entries=cat.n_entries))
    storage._atomic_save(str(part_dir / storage.MANIFEST),
                         lambda p: open(p, "w").write(json.dumps(man, indent=2)))
    t_write = time.perf_counter() - t0
    region = (part_dir / storage.PARTITION_DATA).stat().st_size
    values, per_value = np.unique(cat.sub_lo[:, PART_ATTR], return_counts=True)
    caps, per_cap = np.unique(build.vpads, return_counts=True)
    fig = dict(t_build=t_build, t_write=t_write, region=region,
               n_subs=build.n_subs, n_entries=cat.n_entries,
               catalog=cat.nbytes(),
               per_value=dict(zip(values.tolist(), per_value.tolist())),
               vpads=dict(zip(caps.tolist(), per_cap.tolist())),
               mean_rows=float(cat.sub_counts.mean()) if build.n_subs else 0)
    return build, part_dir, fig


def tile_heights(plan, vpad_of):
    """The row height of each tile's block: its tallest live record."""
    sc = np.asarray(plan.slot_cluster).reshape(plan.n_tiles, plan.u_cap)
    nu = np.asarray(plan.n_unique)
    return [int(vpad_of[sc[t, :max(int(nu[t]), 1)]].max())
            for t in range(plan.n_tiles)]


def partition_part(index, build, part_dir, budget, centers, dev, gen,
                   launches):
    """Phase 3e (b): the layout-4 checkpoint on the disk tier, both
    executors, cat_eq and cat_mixed, ``partitions="auto"`` against
    ``"off"`` on the same batches: ids, scores and n_passed identical (the
    kernel scores a row alike in a short sub block and in its parent);
    then, where the card holds it, the RAM tier over the attached index.
    Returns the rows, the RAM figures and the tiled launches."""
    import torch

    from repro_torch.core import DiskIVFIndex, SearchEngine
    from repro_torch.core import partitions as partitions_lib
    from repro_torch.core import storage

    kc = build.catalog.n_base
    vpad_of = np.concatenate([np.full(kc, index.vpad), build.vpads])
    man = storage.load_manifest(str(part_dir))
    stride_of = np.asarray(
        [man["record_stride"]] * kc
        + [storage.partition_record_layout(man, int(v))[1]
           for v in build.vpads], np.int64)
    n0 = launches()["filtered_scan_tiled"]
    mixes = ("cat_eq", "cat_mixed")
    batches = {mix: [cat_batch(mix, centers, dev, gen)
                     for _ in range(PART_WARMUP + PART_BATCHES)]
               for mix in mixes}
    rows = {}
    disk = DiskIVFIndex.open(str(part_dir), resident_budget_bytes=budget)
    try:
        for pipeline in ("off", "on"):
            engs = {mode: SearchEngine(disk, k=K_TOP, n_probes=N_PROBES,
                                       q_block=64, prune="auto",
                                       pipeline=pipeline, partitions=mode)
                    for mode in ("auto", "off")}
            try:
                for mix in mixes:
                    for mode, eng in engs.items():
                        out, results = [], []
                        for i, (queries, fspec) in enumerate(batches[mix]):
                            hits0 = eng.stats.partition_hits
                            fetched0 = eng.stats.blocks_fetched
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            plan = eng.plan(queries, fspec)
                            res = eng.execute(plan)
                            torch.cuda.synchronize()
                            t_batch = (time.perf_counter() - t0) * 1e3
                            results.append(res)
                            if i < PART_WARMUP:
                                continue
                            sc = np.asarray(plan.slot_cluster)
                            live = np.unique(sc)
                            out.append(dict(
                                batch=t_batch,
                                hits=eng.stats.partition_hits - hits0,
                                fetched=eng.stats.blocks_fetched - fetched0,
                                gb=float(stride_of[live].sum()) / 1e9,
                                heights=tile_heights(plan, vpad_of),
                                scanned=float(res.n_scanned.float().mean())))
                        rows[pipeline, mix, mode] = (out, results)
                    for i, (a, b) in enumerate(zip(rows[pipeline, mix, "auto"][1],
                                                   rows[pipeline, mix, "off"][1])):
                        name = f"routed vs flat pipeline={pipeline} {mix} batch {i}"
                        if not (torch.equal(a.ids, b.ids)
                                and torch.equal(a.scores, b.scores)
                                and torch.equal(a.n_passed, b.n_passed)):
                            raise AssertionError(f"{name}: results differ")
                        if bool((a.n_scanned > b.n_scanned).any()):
                            raise AssertionError(f"{name}: routed scans more")
            finally:
                for eng in engs.values():
                    eng.close()
    finally:
        disk.close()
    disk_launches = launches()["filtered_scan_tiled"] - n0

    # the RAM tier: attach pads every sub to Vpad, a second index beside
    # phase 3's (which phases 3d and 4 still serve)
    need = (index.nbytes() * (index.n_clusters + build.n_subs)
            // index.n_clusters)
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    if need + (2 << 30) > free:
        ram = dict(cut=f"attach needs {need / 2**30:.2f} GiB, "
                   f"{free / 2**30:.2f} GiB free beside phase 3's index")
    else:
        t0 = time.perf_counter()
        attached = partitions_lib.attach(index, build)
        torch.cuda.synchronize()
        t_attach = time.perf_counter() - t0
        ram = dict(t_attach=t_attach, gib=attached.nbytes() / 2**30, rows={})
        try:
            for mix in mixes:
                for mode in ("auto", "off"):
                    eng = SearchEngine(attached, k=K_TOP, n_probes=N_PROBES,
                                       q_block=64, prune="auto",
                                       partitions=mode)
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    res_list, times = [], []
                    for i, (queries, fspec) in enumerate(batches[mix]):
                        ev[0].record()
                        res_list.append(eng.search(queries, fspec))
                        ev[1].record()
                        ev[1].synchronize()
                        if i >= PART_WARMUP:
                            times.append(ev[0].elapsed_time(ev[1]))
                    ram["rows"][mix, mode] = (statistics.median(times),
                                              res_list)
                for i, (a, b) in enumerate(zip(ram["rows"][mix, "auto"][1],
                                               ram["rows"][mix, "off"][1])):
                    if not (torch.equal(a.ids, b.ids)
                            and torch.equal(a.scores, b.scores)):
                        raise AssertionError(f"RAM routed vs flat {mix} "
                                             f"batch {i}: results differ")
                    # the flat RAM plan is the disk tier's flat plan
                    flat_disk = rows["off", mix, "off"][1][i]
                    same_result(f"RAM flat vs disk flat {mix} batch {i}", b,
                                flat_disk)
        finally:
            del attached
            torch.cuda.empty_cache()
    return rows, ram, disk_launches, launches()["filtered_scan_tiled"] - n0


def termination_part(index, batches, ckpt, budget, dev, launches):
    """Phase 3e (c): the RAM engine over phase 3's index on each mix,
    untruncated, ``termination="exact"`` and ``"bounded"`` (ε = EPSILON),
    TERM_WARMUP + TERM_BATCHES batches each; then one sync uniform disk
    batch with "exact" over the checkpoint's bounds.  Gates: "exact" gives
    the untruncated ids and scores bit for bit, ``n_scanned`` and
    ``n_passed`` no higher (equal where no pair was dropped: a dropped
    probe's rows are not scanned, so not counted); "bounded" equals an
    exact top-k over the probes its merge kept.  Returns the rows and the
    tiled launches."""
    import torch

    from repro_torch.core import DiskIVFIndex, SearchEngine, recall_at_k
    from repro_torch.core.search import SearchResult

    n0 = launches()["filtered_scan_tiled"]
    rows = {}
    engines = {mode: SearchEngine(
        index, k=K_TOP, n_probes=N_PROBES, q_block=64, prune="auto",
        termination=None if mode == "none" else mode,
        epsilon=EPSILON if mode == "bounded" else 0.0)
        for mode in ("none", "exact", "bounded")}
    for mix, blist in batches.items():
        blist = blist[:TERM_WARMUP + TERM_BATCHES]
        base = []
        for mode, eng in engines.items():
            out = []
            for i, (queries, fspec) in enumerate(blist):
                st0 = (eng.stats.probes_terminated,
                       eng.stats.term_segments_skipped)
                l0 = launches()["filtered_scan_tiled"]
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                plan = eng.plan(queries, fspec)
                res = eng.execute(plan)
                ev[1].record()
                ev[1].synchronize()
                name = f"termination={mode} {mix} batch {i}"
                dropped = eng.stats.probes_terminated - st0[0]
                if mode == "none":
                    base.append(res)
                else:
                    want = base[i]
                    if mode == "exact":
                        if not (torch.equal(res.ids, want.ids)
                                and torch.equal(res.scores, want.scores)):
                            raise AssertionError(f"{name}: differs from the "
                                                 "untruncated batch")
                        for c in ("n_scanned", "n_passed"):
                            got, ref = getattr(res, c), getattr(want, c)
                            if bool((got > ref).any()) or (
                                    dropped == 0 and not torch.equal(got, ref)):
                                raise AssertionError(f"{name}: {c}")
                    else:
                        ref = over_kept(index, queries, fspec, plan, K_TOP,
                                        N_CHECK)
                        check_topk(f"{name} vs an exact top-k over its kept "
                                   "probes", res.scores[:N_CHECK],
                                   res.ids[:N_CHECK], *ref)
                if i < TERM_WARMUP:
                    continue
                term = plan.term
                out.append(dict(
                    batch=ev[0].elapsed_time(ev[1]),
                    launches=launches()["filtered_scan_tiled"] - l0,
                    dropped=dropped,
                    skipped=eng.stats.term_segments_skipped - st0[1],
                    syncs=(0 if term is None
                           else plan.n_tiles * (term.n_seg - 1)),
                    seg=0 if term is None else term.seg,
                    recall=recall_at_k(res, SearchResult(
                        base[i].scores, base[i].ids, None, None))))
            rows[mix, mode] = {key: statistics.median(r[key] for r in out)
                               for key in out[0]}
    for eng in engines.values():
        eng.close()
    # one sync uniform disk batch over the checkpoint's bounds
    queries, fspec = batches["uniform"][0]
    disk = DiskIVFIndex.open(str(ckpt), resident_budget_bytes=budget)
    try:
        res = {}
        # untruncated, exact, untruncated: the first fills the host cache
        for mode in (None, "exact", None):
            eng = SearchEngine(disk, k=K_TOP, n_probes=N_PROBES, q_block=64,
                               prune="auto", pipeline="off", termination=mode)
            t0 = time.perf_counter()
            res[mode] = eng.search(queries, fspec)
            torch.cuda.synchronize()
            rows["disk", str(mode)] = dict(
                batch=(time.perf_counter() - t0) * 1e3,
                dropped=eng.stats.probes_terminated)
            eng.close()
        if not (torch.equal(res["exact"].ids, res[None].ids)
                and torch.equal(res["exact"].scores, res[None].scores)):
            raise AssertionError("disk termination=exact differs from the "
                                 "untruncated batch")
    finally:
        disk.close()
    return rows, launches()["filtered_scan_tiled"] - n0


def print_phase_3e(dc_rows, part_fig, part_rows, ram, term_rows):
    """Phase 3e's figures."""
    for (pipeline, mix), r in dc_rows.items():
        log(f"device cache pipeline={pipeline} {mix}: batch {r['batch']:.3f} "
            f"ms, fetch wait {r['fetch']:.3f} ms (medians of "
            f"{DISK_BATCHES}); device hit rate {r['hit_rate']:.4f}, tile-memo "
            f"hits {r['tile_hits']:.1f}, {r['gb']:.3f} GB copied to the card, "
            f"evictions {r['evictions']:.1f} a batch, resident "
            f"{r['resident'] / 2**30:.3f} GiB; max |err| vs RAM "
            f"{r['err']:.3e}")
    f = part_fig
    log(f"partitions: build_partitions(attrs=[{PART_ATTR}], max_subs="
        f"{PART_MAX_SUBS}) {f['t_build']:.2f} s: {f['n_entries']} entries, "
        f"{f['n_subs']} subs (per value {f['per_value']}), "
        f"mean {f['mean_rows']:.1f} rows, capacities {f['vpads']}; catalog "
        f"{f['catalog'] / 2**20:.2f} MiB; region {f['region'] / 1e9:.3f} GB "
        f"written in {f['t_write']:.2f} s")
    for (pipeline, mix, mode), (out, _) in part_rows.items():
        med = {k: statistics.median(r[k] for r in out)
               for k in ("batch", "hits", "fetched", "gb", "scanned")}
        heights = sorted({h for r in out for h in r["heights"]})
        log(f"partitions={mode} pipeline={pipeline} {mix}: batch "
            f"{med['batch']:.3f} ms (median of {PART_BATCHES}), "
            f"partition_hits {med['hits']:.0f}, tile heights {heights}, "
            f"{med['gb']:.3f} GB of records, blocks_fetched "
            f"{med['fetched']:.0f}, mean n_scanned {med['scanned']:.1f}")
    if "cut" in ram:
        log(f"partitions RAM tier cut: {ram['cut']}")
    else:
        log(f"partitions RAM tier: attach {ram['t_attach']:.2f} s, "
            f"{ram['gib']:.2f} GiB; " + "; ".join(
                f"{mix} {mode} {t:.3f} ms" for (mix, mode), (t, _)
                in ram["rows"].items()) + " (medians); routed equals flat")
    for key, r in term_rows.items():
        if key[0] == "disk":
            continue
        mix, mode = key
        log(f"termination={mode} {mix}: batch {r['batch']:.3f} ms (median of "
            f"{TERM_BATCHES}), recall@{K_TOP} vs untruncated "
            f"{r['recall']:.4f}, probes terminated {r['dropped']:.1f}, "
            f"segments skipped {r['skipped']:.1f}, scan launches "
            f"{r['launches']:.1f}, host syncs {r['syncs']:.1f} (segment "
            f"{r['seg']:.0f} slots)")
    log(f"termination disk uniform (sync, after a warm-up batch): "
        f"untruncated {term_rows['disk', 'None']['batch']:.3f} ms, exact "
        f"{term_rows['disk', 'exact']['batch']:.3f} ms, probes terminated "
        f"{term_rows['disk', 'exact']['dropped']}; equal")


# ---- phase 3f: serving and the index build at full size ----

SERVE_REQUESTS = 10 * Q  # the launcher's --requests: 10 full batches
SERVE_WAIT_S = 0.05  # the gated server's max_wait_s: every batch fills
KM_STEPS, KM_BATCH = 100, 4096  # build_ivf's minibatch defaults
ASSIGN_CHUNK = 65536  # build_ivf's assign_chunk default
N_SAMPLE = 65536  # rows whose assignment is held against an f64 argmax
# f32 may pick the other centroid where the f64 top-two gap is below this:
# a score 2 x·c - ||c||² of unit-norm rows and centroids (||c|| <= 1) over
# D = 768 f32 products is off by at most 3·D·2^-24 = 1.4e-4
ASSIGN_GAP = 2e-4
BUILD_PROBE_N = 250_000  # the launcher's k-means run here to reckon its lists
LAUNCH_CLUSTERS, LAUNCH_STEPS = 128, 40  # the launcher's --clusters, steps
LAUNCH_ROW_BYTES = DIM * 4 + M_ATTRS * 2 + 4  # f32 vector, attributes, id
LAUNCH_BATCH = 32  # the launcher's --batch default
LAUNCH_REQUESTS = 10 * LAUNCH_BATCH  # 10 full batches
# synthetic_embeddings' host peak a row: the f64 draw beside its f32 copy
# and the gathered centre rows, plus an int64 attribute column
HOST_ROW_BYTES = DIM * (8 + 4 + 4) + M_ATTRS * 2 + 8


def run_launcher(argv):
    """``repro_torch.launch.serve.main(argv)`` in this process; its lines
    are logged but the per-key metrics dump (main returns the metrics).
    Returns (main's result, seconds)."""
    import contextlib
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            out = serve.main(argv)
    finally:
        for line in buf.getvalue().splitlines():
            if not line.startswith("  "):
                log(f"  launcher: {line}")
    return out, time.perf_counter() - t0


def responses_vs_engine(name, resps, queries, engine, lo=None, hi=None):
    """Server responses for ``queries`` (numpy [R, D]; filter rows ``lo`` /
    ``hi`` numpy [R, F, M], or match_all) against ``engine`` on the same
    queries in batches of Q, by the near-tie rule.  Returns max |err|."""
    import torch

    from repro_torch.core import FilterSpec, match_all

    dev = engine.device
    want_s, want_i = [], []
    for r0 in range(0, len(queries), Q):
        q = torch.from_numpy(queries[r0:r0 + Q]).to(dev)
        f = (match_all(q.shape[0], engine.index.spec.n_attrs, device=dev)
             if lo is None else
             FilterSpec(lo=torch.from_numpy(lo[r0:r0 + Q]).to(dev),
                        hi=torch.from_numpy(hi[r0:r0 + Q]).to(dev)))
        res = engine.search(q, f)
        want_s.append(res.scores.cpu())
        want_i.append(res.ids.cpu())
    got_s = torch.from_numpy(np.stack([r.scores for r in resps]))
    got_i = torch.from_numpy(np.stack([r.ids for r in resps]))
    return check_topk(name, got_s, got_i, torch.cat(want_s),
                      torch.cat(want_i))


def latency_fig(out, n_tiled, err, secs):
    """One launcher or server run's figures."""
    lat = np.asarray([r.latency_s for r in out["responses"]]) * 1e3
    st = out["stats"]
    return dict(qps=out["qps"], p50=float(np.percentile(lat, 50)),
                p99=float(np.percentile(lat, 99)), batches=st["batches"],
                fill=st["requests"] / st["batches"], wall=out["wall_s"],
                engine_ms=st["total_latency_s"] / st["batches"] * 1e3,
                wall_ms=out["wall_s"] / st["batches"] * 1e3,
                launches=n_tiled, err=err, secs=secs,
                metrics=out.get("metrics"))


def serve_part(d_index, index, engine, batches, ckpt, launches,
               reset_launches):
    """Phase 3f (a) and (b): the launcher ``--load``-ing phase 3c's
    checkpoint on both tiers, each response held against a RAM engine over
    the checkpoint's index; then a ``SearchServer`` over
    ``make_fused_search_fn(index)`` fed phase 3's batches of each mix as
    requests (hot_window's filter rows through ``fspec_row``), each
    response held against phase 3's engine.  Launch counts are read right
    after each run, before its checks.  Returns the figures."""
    import torch

    from repro_torch.core import SearchEngine
    from repro_torch.core.serving import SearchServer, make_fused_search_fn

    fig = {}
    ram_engine = SearchEngine(d_index, k=K_TOP, n_probes=N_PROBES,
                              q_block=64, prune="auto")
    for tier, extra in (("ram", []), ("disk", [
            "--device-cache-mb", str(DEVICE_CACHE_MB),
            "--delta-budget-mb", str(DELTA_BUDGET_MB)])):
        torch.cuda.synchronize()
        reset_launches()
        out, secs = run_launcher(
            ["--load", str(ckpt), "--tier", tier, "--k", str(K_TOP),
             "--probes", str(N_PROBES), "--batch", str(Q), "--requests",
             str(SERVE_REQUESTS)] + extra)
        n_tiled = launches()["filtered_scan_tiled"]
        st = out["stats"]
        if not n_tiled or st["requests"] != SERVE_REQUESTS or st[
                "batches"] < SERVE_REQUESTS // Q:
            raise AssertionError(f"launcher {tier}: {st}, {n_tiled} "
                                 "filtered_scan_tiled launches")
        err = responses_vs_engine(f"launcher {tier}", out["responses"],
                                  out["queries"], ram_engine)
        fig["launcher", tier] = latency_fig(out, n_tiled, err, secs)
        del out
        torch.cuda.empty_cache()
    ram_engine.close()

    fn = make_fused_search_fn(index, k=K_TOP, n_probes=N_PROBES, q_block=64,
                              prune="auto")
    for mix, blist in batches.items():
        qs = np.concatenate([q.cpu().numpy() for q, _ in blist])
        lo = np.concatenate([f.lo.cpu().numpy() for _, f in blist])
        hi = np.concatenate([f.hi.cpu().numpy() for _, f in blist])
        server = SearchServer(fn, batch_size=Q, dim=DIM, n_attrs=M_ATTRS,
                              n_terms=lo.shape[1], n_shards=1,
                              max_wait_s=SERVE_WAIT_S)
        torch.cuda.synchronize()
        reset_launches()
        server.start()
        try:
            t0 = time.perf_counter()
            futs = [server.submit(qs[i], (lo[i], hi[i]))
                    for i in range(len(qs))]
            resps = [f.get(timeout=300) for f in futs]
            wall = time.perf_counter() - t0
        finally:
            server.stop()
        n_tiled = launches()["filtered_scan_tiled"]
        if not n_tiled:
            raise AssertionError(f"server {mix}: no filtered_scan_tiled launch")
        err = responses_vs_engine(f"server {mix}", resps, qs, engine, lo, hi)
        out = dict(responses=resps, qps=len(qs) / wall, wall_s=wall,
                   stats=dict(server.stats))
        fig["server", mix] = latency_fig(out, n_tiled, err, wall)
    fn.close()
    return fig


def inertia(x, centroids):
    """Sum over rows of the squared distance to the nearest centroid, in
    chunks of ASSIGN_CHUNK rows (f32 scores, an f64 sum)."""
    import torch

    from repro_torch.core import kmeans as km

    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for r0 in range(0, x.shape[0], ASSIGN_CHUNK):
        xb = x[r0:r0 + ASSIGN_CHUNK].float()
        s = km.pairwise_neg_dist2(xb, centroids)
        total += (torch.sum(xb * xb, -1) - s.amax(-1)).double().sum()
    return float(total)


def check_assignments(core, centroids, assignments, gen):
    """N_SAMPLE rows' assignments against an f64 argmax on the CPU over the
    card's centroids: equal except where the f64 top-two gap is under
    ASSIGN_GAP.  Returns (rows that differ, smallest gap of the sample)."""
    import torch

    idx = torch.randint(0, core.shape[0], (N_SAMPLE,), generator=gen,
                        device=core.device)
    c = centroids.double().cpu()
    c2 = (c * c).sum(-1)
    xs = core[idx].double().cpu()
    got = assignments[idx].long().cpu()
    n_diff, min_gap = 0, float("inf")
    for r0 in range(0, N_SAMPLE, 16384):
        s = 2.0 * xs[r0:r0 + 16384] @ c.T - c2[None, :]
        top2 = torch.topk(s, 2, dim=-1)
        gap = top2.values[:, 0] - top2.values[:, 1]
        diff = got[r0:r0 + 16384] != top2.indices[:, 0]
        if bool((diff & (gap >= ASSIGN_GAP)).any()):
            raise AssertionError(
                "assign differs from the f64 argmax at a top-two gap of "
                f"{float(gap[diff].max()):.3e} >= {ASSIGN_GAP}")
        n_diff += int(diff.sum())
        min_gap = min(min_gap, float(gap.min()))
    return n_diff, min_gap


def build_part(args, dev, launches, reset_launches):
    """Phase 3f (c): the build's k-means at full size on phase 3's topic
    mixture (generated anew on the card as make_data does): the port's
    ``minibatch_kmeans`` (KM_STEPS x KM_BATCH) and ``assign`` (chunks of
    ASSIGN_CHUNK), each timed with CUDA events, the assignments of
    N_SAMPLE rows held against an f64 argmax, the inertia before and
    after, the list lengths and what ``build_from_assignments`` would
    allocate; ``build_ivf`` whole where that fits beside phase 3's index.
    Then the launcher's own build path (``--n N --dim 768 --n-attrs 10``)
    at the largest N whose index the card holds (reckoned from the
    launcher's k-means lists at BUILD_PROBE_N rows, scaled) and whose
    data the host's MemAvailable holds, its responses held against a RAM
    engine, and the tiled kernel's f32 x f32 time on its index.  Draws
    from its own generator, so the phases after it see ``gen`` as before.
    Returns the figures."""
    import torch

    from repro_torch.core import HybridSpec, SearchEngine, build_ivf
    from repro_torch.core import kmeans as km
    from repro_torch.core import match_all
    from repro_torch.core.ivf import default_n_clusters, round_up
    from repro_torch.data import synthetic_embeddings
    from repro_torch.kernels.filtered_scan import filtered_scan as fs_mod
    from repro_torch.kernels.filtered_scan.ref import (
        filtered_scan_tiled_ref, live_slots)

    fig = {}
    bgen = torch.Generator(dev).manual_seed(args.seed + 1)
    core, attrs, _, _ = make_data(args.n, dev, bgen)
    n, kc = core.shape[0], default_n_clusters(core.shape[0])
    st0 = km.init_from_sample(torch.Generator(dev).manual_seed(args.seed),
                              core, kc)  # minibatch_kmeans' first draw
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    st = km.minibatch_kmeans(torch.Generator(dev).manual_seed(args.seed),
                             core, n_clusters=kc, n_steps=KM_STEPS,
                             batch_size=KM_BATCH)
    ev[1].record()
    a = km.assign(core, st.centroids, chunk=ASSIGN_CHUNK)
    ev[2].record()
    ev[2].synchronize()
    fig.update(n=n, kc=kc, t_minibatch=ev[0].elapsed_time(ev[1]),
               t_assign=ev[1].elapsed_time(ev[2]),
               assign_op_ms=2 * n * kc * DIM / PEAK_OPS["f32"] * 1e3,
               assign_byte_ms=(n * DIM * 2 + kc * DIM * 4 + n * 4)
               / HBM_BYTES_PER_S * 1e3)
    fig["n_diff"], fig["min_gap"] = check_assignments(core, st.centroids, a,
                                                      bgen)
    fig["inertia0"] = inertia(core, st0.centroids)
    fig["inertia1"] = inertia(core, st.centroids)
    if not fig["inertia1"] < fig["inertia0"]:
        raise AssertionError("minibatch_kmeans did not lower the inertia")
    counts = torch.bincount(a.long(), minlength=kc)
    vpad = max(round_up(int(counts.max()), 128), 128)
    row_bytes = DIM * 2 + M_ATTRS * 2 + 4  # bf16 vector, attributes, id
    fig.update(max_len=int(counts.max()), mean_len=float(counts.float().mean()),
               p99_len=float(torch.quantile(counts.float(), 0.99)),
               empty=int((counts == 0).sum()), vpad=vpad,
               alloc=kc * vpad * row_bytes)
    free, _ = torch.cuda.mem_get_info()
    free += torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    fig["free"] = free
    if fig["alloc"] * 1.1 + (2 << 30) <= free:
        spec = HybridSpec(dim=DIM, n_attrs=M_ATTRS, core_dtype=torch.bfloat16)
        t0 = time.perf_counter()
        bi, bstats = build_ivf(torch.Generator(dev).manual_seed(args.seed),
                               spec, core, attrs, n_clusters=kc, device=dev)
        torch.cuda.synchronize()
        fig["build_ivf"] = dict(secs=time.perf_counter() - t0,
                                vpad=bstats.vpad, gib=bi.nbytes() / 2**30,
                                dropped=bstats.n_dropped)
        del bi
    else:
        fig["build_ivf_cut"] = (
            f"build_ivf at N={n} would allocate {fig['alloc'] / 1e9:.1f} GB "
            f"of lists (Vpad {vpad}) beside {free / 1e9:.1f} GB free")
    del core, attrs, a, st, st0
    torch.cuda.empty_cache()

    # the launcher's own build: reckon its longest list from its k-means
    x0 = torch.from_numpy(synthetic_embeddings(0, BUILD_PROBE_N, DIM)).to(dev)
    lst = km.minibatch_kmeans(torch.Generator(dev).manual_seed(0), x0,
                              n_clusters=LAUNCH_CLUSTERS,
                              n_steps=LAUNCH_STEPS,
                              batch_size=min(KM_BATCH, BUILD_PROBE_N))
    c0 = torch.bincount(km.assign(x0, lst.centroids, chunk=ASSIGN_CHUNK
                                  ).long(), minlength=LAUNCH_CLUSTERS)
    share = int(c0.max()) / BUILD_PROBE_N  # the longest list's share
    del x0, lst
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    free += torch.cuda.memory_reserved() - torch.cuda.memory_allocated()

    def need(nn):  # lists (longest list's share + 25%), the data, slack
        vp = max(round_up(int(share * nn * 1.25) + 1, 128), 128)
        return LAUNCH_CLUSTERS * vp * LAUNCH_ROW_BYTES + nn * DIM * 4 + (4 << 30)

    n_fit = 100_000
    while need(n_fit + 100_000) <= 0.9 * free:
        n_fit += 100_000
    avail = host_available()
    n_host = int(0.85 * avail / HOST_ROW_BYTES) // 100_000 * 100_000
    n_run = min(n_fit, n_host)
    fig.update(share=share, n_fit=n_fit, n_host=n_host, host_avail=avail,
               n_run=n_run, reckoned=need(n_run))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, secs = run_launcher(["--n", str(n_run), "--dim", str(DIM),
                              "--n-attrs", str(M_ATTRS),
                              "--batch", str(LAUNCH_BATCH),
                              "--requests", str(LAUNCH_REQUESTS)])
    n_tiled = launches()["filtered_scan_tiled"]
    lidx = out["index"]
    fig["launcher"] = latency_fig(out, n_tiled, 0.0, secs)
    fig["launcher"].update(
        vpad=lidx.vpad, gib=lidx.nbytes() / 2**30,
        peak=torch.cuda.max_memory_allocated() / 2**30,
        max_len=int(lidx.counts.max()))
    if not n_tiled:
        raise AssertionError("launcher build path: no filtered_scan_tiled "
                             "launch")
    # each query is a unit row of the index: q·q = 1 where its list is
    # among its probes (the lists come from l2 k-means, the probes from dot
    # scores against centroids of unequal norms, so not always)
    top = np.asarray([r.scores[0] for r in out["responses"]])
    fig["launcher"]["self_share"] = float(np.mean(np.abs(top - 1.0) < 1e-5))
    eng = SearchEngine(lidx, k=K_TOP, n_probes=N_PROBES, q_block=64,
                       prune="auto")
    fig["launcher"]["err"] = responses_vs_engine(
        "launcher build path", out["responses"], out["queries"], eng)
    # the tiled kernel on this index: f32 queries x f32 vectors
    qb = LAUNCH_BATCH  # the launcher's q_block
    q = torch.from_numpy(out["queries"]).to(dev)
    eng32 = SearchEngine(lidx, k=K_TOP, n_probes=N_PROBES, q_block=qb,
                         prune="auto")
    plan = eng32.plan(q, match_all(q.shape[0], M_ATTRS, device=dev))
    ka = (plan.slot_cluster, plan.slot_tile, plan.n_unique, plan.queries_pad,
          plan.lo_pad, plan.hi_pad, lidx.vectors, lidx.attrs, lidx.ids,
          None, None)
    kw = dict(metric="dot", k=K_TOP, q_block=plan.q_block)
    body = fs_mod.tiled_body(DIM, M_ATTRS, 1, "dot", torch.float32,
                             torch.float32)
    f_err = check_scan("launcher index f32 x f32",
                       fs_mod.filtered_scan_tiled(*ka, **kw),
                       *plain_scan(ka, kw))
    f_ms = ms(lambda: fs_mod.filtered_scan_tiled(*ka, **kw), 10)
    f_plain = ms(lambda: filtered_scan_tiled_ref(*ka, **kw), 3)
    f_bound, f_byte, f_op, f_live, f_cl = tiled_bound(
        plan.slot_cluster, live_slots(plan.slot_tile, plan.n_unique),
        plan.queries_pad, plan.lo_pad, plan.n_unique, plan.q_block,
        lidx.vpad, v_bytes=4, peak="f32")
    fig["f32"] = dict(ms=f_ms, plain_ms=f_plain, bound_ms=f_bound,
                      bound_by="bytes" if f_byte >= f_op else "operations",
                      max_abs_err=f_err, body=body, live_slots=f_live,
                      clusters=f_cl, vpad=lidx.vpad, q_block=qb,
                      byte_ms=f_byte, op_ms=f_op)
    eng.close()
    eng32.close()
    del out, lidx, eng, eng32, plan, ka
    torch.cuda.empty_cache()
    return fig


def print_phase_3f(sfig, bfig):
    """Phase 3f's figures."""
    for key, r in sfig.items():
        log(f"{key[0]} {key[1]}: {r['batches']} batches (mean fill "
            f"{r['fill']:.1f} of {Q}), QPS {r['qps']:.1f}, latency p50 "
            f"{r['p50']:.3f} ms p99 {r['p99']:.3f} ms; a batch: engine "
            f"(queries' H2D, search, D2H) {r['engine_ms']:.3f} ms of "
            f"{r['wall_ms']:.3f} ms wall; {r['launches']} filtered_scan_tiled launches; max "
            f"|err| vs the RAM engine {r['err']:.3e}")
        if r["metrics"] is not None:
            log(f"{key[0]} {key[1]} metrics: "
                + json.dumps(r["metrics"], sort_keys=True))
    b = bfig
    log(f"k-means at N={b['n']} x {DIM} bf16, K={b['kc']}: minibatch_kmeans "
        f"({KM_STEPS} x {KM_BATCH}) {b['t_minibatch']:.3f} ms; assign "
        f"(chunks of {ASSIGN_CHUNK}) {b['t_assign']:.3f} ms against a bound "
        f"of {max(b['assign_op_ms'], b['assign_byte_ms']):.3f} ms (f32 ops "
        f"{b['assign_op_ms']:.3f} ms, bytes {b['assign_byte_ms']:.3f} ms), "
        f"{2 * b['n'] * b['kc'] * DIM / b['t_assign'] / 1e9:.1f} TFLOP/s; "
        f"inertia {b['inertia0']:.1f} before, {b['inertia1']:.1f} after; "
        f"{N_SAMPLE} sampled assignments equal the f64 argmax but "
        f"{b['n_diff']} (all at a top-two gap < {ASSIGN_GAP}; smallest gap "
        f"{b['min_gap']:.3e})")
    log(f"k-means lists: max {b['max_len']}, mean {b['mean_len']:.1f}, p99 "
        f"{b['p99_len']:.1f}, empty {b['empty']} (max / mean "
        f"{b['max_len'] / b['mean_len']:.2f}); build_from_assignments would "
        f"take Vpad {b['vpad']} and allocate {b['alloc'] / 1e9:.2f} GB of "
        f"lists ({b['vpad'] * b['kc'] / b['n']:.2f} slots a row); "
        f"{b['free'] / 1e9:.2f} GB free")
    if "build_ivf" in b:
        r = b["build_ivf"]
        log(f"build_ivf at N={b['n']}: {r['secs']:.2f} s, Vpad {r['vpad']}, "
            f"{r['gib']:.2f} GiB, dropped {r['dropped']}")
    else:
        log(f"phase 3f cut: {b['build_ivf_cut']}")
    log(f"launcher build reckoned: the longest of {LAUNCH_CLUSTERS} lists "
        f"holds {b['share']:.4f} of the rows at N={BUILD_PROBE_N}; the card "
        f"holds N={b['n_fit']}; the host's MemAvailable "
        f"{b['host_avail'] / 2**30:.2f} GiB holds N={b['n_host']} at "
        f"{HOST_ROW_BYTES} B a row; run at N={b['n_run']} (reckoned "
        f"{b['reckoned'] / 1e9:.2f} GB on the card)")
    if b["n_run"] < b["n_fit"]:
        log(f"phase 3f cut: the launcher's build path at N={b['n_run']}, not "
            f"{b['n_fit']}: the host's MemAvailable holds its numpy data "
            f"only to N={b['n_host']}")
    r = b["launcher"]
    log(f"launcher build path N={b['n_run']}: {r['secs']:.2f} s with data "
        f"and build; index Vpad {r['vpad']} (max list {r['max_len']}), "
        f"{r['gib']:.2f} GiB, peak {r['peak']:.2f} GiB; {r['batches']} "
        f"batches, QPS {r['qps']:.1f}, p50 {r['p50']:.3f} ms, p99 "
        f"{r['p99']:.3f} ms; {r['launches']} filtered_scan_tiled launches; "
        f"{r['self_share']:.4f} of the queries found their own row first; "
        f"max |err| vs the RAM engine {r['err']:.3e}")
    f = b["f32"]
    log(f"filtered_scan_tiled on the launcher's index, f32 queries x f32 "
        f"vectors ({f['body']} body), q_block {f['q_block']}, Vpad "
        f"{f['vpad']}: {f['live_slots']} live slots over {f['clusters']} "
        f"clusters; kernel {f['ms']:.3f} ms, plain {f['plain_ms']:.3f} ms, "
        f"bound {f['bound_ms']:.3f} ms (bytes {f['byte_ms']:.3f} ms, f32 FMA "
        f"ops {f['op_ms']:.3f} ms), kernel / bound "
        f"{f['ms'] / f['bound_ms']:.2f}; max |err| {f['max_abs_err']:.3e}")


# ---- phase 3g: the sharded ring ----

RING_NODES = 3
RING_WARMUP, RING_BATCHES = 1, 2  # per (transport, executor, mix) in 3g
RING_REQUESTS = 5 * Q  # the ring launcher's --requests
RING_SOCKET_UNIFORM_S = 100.0  # socket runs uniform once if 3g is younger
CHAOS_LATENCY_S = 0.2  # the browned-out peer's added latency a fetch
CHAOS_BREAKER = dict(failure_threshold=1, cooldown_s=1.0,
                     half_open_successes=1, brownout_latency_s=0.1,
                     latency_alpha=1.0)


def ring_delta(s1, s0):
    """The ring counters one batch moved (two ``stats()`` snapshots)."""
    out = {k: s1[k] - s0[k] for k in (
        "remote_blocks", "l1_hits", "l1_misses", "failovers",
        "redirected_blocks", "fallback_blocks", "device_hits",
        "fetches_skipped", "stale_answers")}
    out["node_blocks"] = {n: s1["per_node"][n]["blocks_served"]
                          - s0["per_node"].get(n, {}).get("blocks_served", 0)
                          for n in s1["per_node"]}
    out["wire_blocks"] = sum(s1["per_node"][n].get("blocks", 0)
                             - s0["per_node"].get(n, {}).get("blocks", 0)
                             for n in s1["per_node"]
                             if s1["per_node"][n].get("kind") == "socket")
    return out


def ring_batches(name, eng, store, blist, wants, *, warmup=RING_WARMUP,
                 split=True):
    """``blist`` through ``eng`` (over the ring ``store``), each batch held
    against the RAM engine's ``wants``.  With ``split``, a sync engine's
    fetch stage is timed apart (CUDA events around plan, fetch and
    scan+merge, as phase 3c times it); else each batch is one
    ``execute``.  Returns the timed batches' rows and the last result."""
    import torch

    split = split and eng.pipeline == "off"
    rows, res = [], None
    for i, ((queries, fspec), want) in enumerate(zip(blist, wants)):
        s0 = store.stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        plan = eng.plan(queries, fspec)
        ev[1].record()
        if split:
            operands = eng.fetch(plan)
            ev[2].record()
            res = eng.scan_merge(plan, operands)
            eng.stats.batches += 1
        else:
            res = eng.execute(plan)
            ev[2].record()
        ev[3].record()
        ev[3].synchronize()
        err = same_result(f"{name} batch {i}", res, want)
        if i < warmup:
            continue
        row = ring_delta(store.stats(), s0)
        row.update(batch=ev[0].elapsed_time(ev[3]), err=err,
                   fetch=ev[1].elapsed_time(ev[2]) if split else None,
                   plan_obj=plan)
        rows.append(row)
    return rows, res


def ring_row(rows):
    """Medians of the timed batches (the per-node counts summed)."""
    out = {k: statistics.median(r[k] for r in rows)
           for k in ("batch", "err", "remote_blocks", "l1_hits", "l1_misses",
                     "wire_blocks")}
    if rows[0]["fetch"] is not None:
        out["fetch"] = statistics.median(r["fetch"] for r in rows)
    out["node_blocks"] = {n: sum(r["node_blocks"][n] for r in rows)
                          / len(rows) for n in rows[0]["node_blocks"]}
    out["n"] = len(rows)
    return out


def trim_host_memory():
    """Hands the C heap's free pages back to the OS (glibc
    ``malloc_trim``): the ring's fetch and server threads leave GBs of
    freed record buffers in their malloc arenas, which the machine's memory
    limit counts until they are trimmed.  Returns MemAvailable after, GiB."""
    import ctypes
    import gc

    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)
    return host_available() / 2**30


class RingRun:
    """Phase 3g's shared state: the disk index over 3c's checkpoint (its
    store is every ring's fallback), the RAM engine's results for each
    batch, the figures and the tiled launches of each part."""

    def __init__(self, d_index, ckpt, budget, batches, dev, launches,
                 reset_launches):
        from repro_torch.core import DiskIVFIndex, SearchEngine

        self.ckpt, self.batches, self.dev = ckpt, batches, dev
        self.launches, self.reset_launches = launches, reset_launches
        self.ram = SearchEngine(d_index, k=K_TOP, n_probes=N_PROBES,
                                q_block=64, prune="auto")
        self.wants = {mix: [self.ram.search(q, f) for q, f in blist]
                      for mix, blist in batches.items()}
        self.disk = DiskIVFIndex.open(str(ckpt), resident_budget_bytes=budget)
        self.cap = max(self.disk.cache.capacity_records // RING_NODES, 1)
        self.fig, self.n_launch = {}, {}
        self.t0 = time.perf_counter()

    def ring(self, transport, **extra):
        from repro_torch.core import open_sharded

        extra.setdefault("fallback", self.disk.blockstore)
        return open_sharded(str(self.ckpt), n_nodes=RING_NODES,
                            transport=transport, capacity_records=self.cap,
                            timeout_s=120.0, **extra)

    def engine(self, store, pipeline="off", **extra):
        from repro_torch.core import SearchEngine

        return SearchEngine(self.disk, blockstore=store, pipeline=pipeline,
                            k=K_TOP, n_probes=N_PROBES, q_block=64,
                            prune="auto", **extra)

    def part(self, name, fn, *args):
        """Runs one part with the launch counts set to 0 just before and
        read just after (each part must launch the tiled kernel), or the
        count ``fn`` returns, read before its checks; the part's rings are
        gone when it returns, and the heap is trimmed."""
        import torch

        t0 = time.perf_counter()
        torch.cuda.synchronize()
        self.reset_launches()
        n = fn(self, *args)
        torch.cuda.synchronize()
        self.n_launch[name] = (self.launches()["filtered_scan_tiled"]
                               if n is None else n)
        if not self.n_launch[name]:
            raise AssertionError(f"ring {name}: no filtered_scan_tiled launch")
        self.fig[name + "_s"] = time.perf_counter() - t0
        self.fig[name + "_mem"] = trim_host_memory()
        log(f"ring ({name}) {self.fig[name + '_s']:.2f} s; host memory after "
            f"(trimmed): {meminfo()}")

    def close(self):
        self.disk.close()
        self.ram.close()


def ring_loopback_part(run):
    """(a) a loopback ring, both executors, the three mixes; then on the
    same ring (d) termination "exact" through the segmented fetch on
    uniform and hot_window, equal to the untruncated ring batch bit for
    bit, and (e) an 8 GiB device cache on hot."""
    import torch

    from repro_torch.core.devicecache import DeviceBlockCache

    n_run = RING_WARMUP + RING_BATCHES
    ring = run.ring("loopback")
    base = {}
    try:
        for pipeline in ("off", "on"):
            eng = run.engine(ring, pipeline)
            try:
                for mix, blist in run.batches.items():
                    rows, res = ring_batches(
                        f"ring loopback pipeline={pipeline} {mix}", eng, ring,
                        blist[:n_run], run.wants[mix])
                    run.fig["a", pipeline, mix] = ring_row(rows)
                    if pipeline == "off":
                        base[mix] = (blist[n_run - 1], res)
            finally:
                eng.close()
        n_a = run.launches()["filtered_scan_tiled"]
        t0 = time.perf_counter()
        eng = run.engine(ring, termination="exact")
        try:
            for mix in ("uniform", "hot_window"):
                (queries, fspec), want = base[mix]
                s0 = ring.stats()
                l0 = run.launches()["filtered_scan_tiled"]
                st0 = (eng.stats.probes_terminated,
                       eng.stats.term_segments_skipped)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                plan = eng.plan(queries, fspec)
                res = eng.execute(plan)
                torch.cuda.synchronize()
                batch_ms = (time.perf_counter() - t1) * 1e3
                if not (torch.equal(res.ids, want.ids)
                        and torch.equal(res.scores, want.scores)):
                    raise AssertionError(f"ring termination=exact {mix}: "
                                         "differs from the untruncated ring "
                                         "batch")
                for c in ("n_scanned", "n_passed"):
                    if bool((getattr(res, c) > getattr(want, c)).any()):
                        raise AssertionError(f"ring termination {mix}: {c}")
                d = ring_delta(ring.stats(), s0)
                run.fig["d", mix] = dict(
                    batch=batch_ms, skipped=d["fetches_skipped"],
                    remote=d["remote_blocks"],
                    dropped=eng.stats.probes_terminated - st0[0],
                    seg_skipped=eng.stats.term_segments_skipped - st0[1],
                    launches=run.launches()["filtered_scan_tiled"] - l0,
                    syncs=plan.n_tiles * (plan.term.n_seg - 1),
                    segments=plan.n_tiles * plan.term.n_seg)
        finally:
            eng.close()
        n_d = run.launches()["filtered_scan_tiled"] - n_a
        run.fig["d_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dc = DeviceBlockCache(run.disk.blockstore.spec, DEVICE_CACHE_MB << 20,
                              heat_fn=run.disk.cache.probe_heat,
                              device=run.dev)
        eng = run.engine(ring, device_cache=dc)
        try:
            rows, _ = ring_batches("ring device cache hot", eng, ring,
                                   run.batches["hot"][:n_run],
                                   run.wants["hot"])
        finally:
            eng.close()
        if not all(r["device_hits"] > 0 for r in rows):
            raise AssertionError("ring device cache: a warm batch had no "
                                 "device hits")
        run.fig["e"] = dict(ring_row(rows), device_hits=statistics.median(
            r["device_hits"] for r in rows), hit_rate=dc.hit_rate())
        run.fig["e_s"] = time.perf_counter() - t0
        n_e = run.launches()["filtered_scan_tiled"] - n_a - n_d
        if not (n_d and n_e):
            raise AssertionError(f"ring (d) {n_d} / (e) {n_e} launches")
        run.n_launch["d"], run.n_launch["e"] = n_d, n_e
    finally:
        ring.close()


def ring_socket_part(run, rate):
    """(b) the same over the socket wire: the sync executor on hot and
    hot_window, the pipelined one on hot_window (cut: a hot batch moves
    ~4.9 GB over the wire, ~13 s, and the sync executor already gives its
    rate); uniform once, sync, while the phase is under
    RING_SOCKET_UNIFORM_S old.  The fetch's own read and assembly rates on
    the last sync batch's plan are logged beside the wire's."""
    from repro_torch.core.transport import _encode_records

    n_run = RING_WARMUP + RING_BATCHES
    ring = run.ring("socket")
    try:
        run.fig["wire_record"] = len(_encode_records(
            run.disk.blockstore.get([0])))
        log("phase 3g cut: the pipelined executor over the socket ring runs "
            "hot_window only (a hot batch moves ~4.9 GB over the wire)")
        for pipeline, mixes in (("off", ("hot", "hot_window")),
                                ("on", ("hot_window",))):
            eng = run.engine(ring, pipeline)
            try:
                for mix in mixes:
                    rows, _ = ring_batches(
                        f"ring socket pipeline={pipeline} {mix}", eng, ring,
                        run.batches[mix][:n_run], run.wants[mix])
                    run.fig["b", pipeline, mix] = ring_row(rows)
                if pipeline == "on":
                    continue
                fetch_breakdown(run.disk, rows[-1]["plan_obj"],
                                block_bytes(run.disk.man), rate, run.dev,
                                label="ring phase, sync hot_window batch")
                age = time.perf_counter() - run.t0
                if age < RING_SOCKET_UNIFORM_S:
                    rows, _ = ring_batches(
                        "ring socket pipeline=off uniform", eng, ring,
                        run.batches["uniform"][:1], run.wants["uniform"],
                        warmup=0)
                    run.fig["b", "off", "uniform"] = ring_row(rows)
                else:
                    log(f"phase 3g cut: socket uniform not run (phase 3g "
                        f"already {age:.1f} s old)")
            finally:
                eng.close()
    finally:
        ring.close()


def ring_chaos_part(run):
    """(c) peer 1 killed and peer 2 browned out through ``faults.inject``
    on uniform: every batch equal, failovers counted, the engine's batches
    degraded; then both peers back, the circuits closed by
    ``probe_peers`` and the next batch served by them; then the kill
    without a fallback, which must raise a ``TransportError``."""
    from repro_torch.core import TransportError, faults
    from repro_torch.core.health import CLOSED

    blist, wants = run.batches["uniform"], run.wants["uniform"]
    ring = run.ring("loopback", breaker_kwargs=CHAOS_BREAKER)
    try:
        faults.inject(ring, 1, faults.kill_peer())
        faults.inject(ring, 2, faults.brownout_peer(CHAOS_LATENCY_S))
        eng = run.engine(ring)
        try:
            rows, _ = ring_batches("ring chaos uniform", eng, ring, blist[:2],
                                   wants, warmup=0, split=False)
            s = ring.stats()
            degraded = eng.stats.degraded_batches
            if s["failovers"] + s["redirected_blocks"] == 0 or not degraded:
                raise AssertionError(f"ring chaos: no failover ({s})")
            chaos = dict(ring_row(rows), failovers=s["failovers"],
                         redirected=s["redirected_blocks"],
                         fallback=s["fallback_blocks"],
                         health=dict(s["health"]), degraded=degraded,
                         injected={n: ring.transports[n].stats()["injected"]
                                   for n in (1, 2)})
            for n in (1, 2):  # the peers come back
                ring.transports[n] = ring.transports[n].inner
            t1 = time.perf_counter()
            while (any(ring.health.state(n) != CLOSED for n in (1, 2))
                   and time.perf_counter() - t1 < 30.0):
                ring.probe_peers()
                time.sleep(0.1)
            if ring.degraded:
                raise AssertionError("ring chaos: the circuits did not close "
                                     "after recovery")
            chaos["recovery_s"] = time.perf_counter() - t1
            rows, _ = ring_batches("ring chaos recovered uniform", eng, ring,
                                   blist[2:3], wants[2:], warmup=0,
                                   split=False)
            nb = rows[0]["node_blocks"]
            if not (nb[1] > 0 and nb[2] > 0):
                raise AssertionError(f"ring chaos: not served remotely after "
                                     f"recovery ({nb})")
            chaos["recovered"] = ring_row(rows)
        finally:
            eng.close()
    finally:
        ring.close()
    ring = run.ring("loopback", fallback=None)
    try:
        faults.inject(ring, 1, faults.kill_peer())
        eng = run.engine(ring)
        try:
            eng.search(*blist[0])
        except TransportError as e:
            chaos["no_fallback"] = f"{type(e).__name__}: {e}"
        else:
            raise AssertionError("ring without a fallback: a killed peer "
                                 "raised no TransportError")
        finally:
            eng.close()
    finally:
        ring.close()
    run.fig["c"] = chaos


def ring_launcher_part(run):
    """(f) the launcher over a socket ring with an 8 GiB device cache,
    every response held against the RAM engine."""
    out, secs = run_launcher(
        ["--load", str(run.ckpt), "--tier", "disk", "--k", str(K_TOP),
         "--probes", str(N_PROBES), "--batch", str(Q), "--requests",
         str(RING_REQUESTS), "--cache-shards", str(RING_NODES),
         "--cache-transport", "socket", "--device-cache-mb",
         str(DEVICE_CACHE_MB)])
    n_tiled = run.launches()["filtered_scan_tiled"]
    st = out["stats"]
    if not n_tiled or st["requests"] != RING_REQUESTS:
        raise AssertionError(f"ring launcher: {st}, {n_tiled} launches")
    if out["metrics"].get("store.kind") != "sharded":
        raise AssertionError("ring launcher: the store is not the ring")
    err = responses_vs_engine("ring launcher", out["responses"],
                              out["queries"], run.ram)
    lf = latency_fig(out, n_tiled, err, secs)
    lf["metrics"] = {k: v for k, v in out["metrics"].items()
                     if (k.startswith("store.") and "per_node" not in k)
                     or k.startswith("engine.degraded")
                     or k.startswith("device_cache.hit")}
    run.fig["f"] = lf
    return n_tiled


def ring_phase(d_index, ckpt, budget, batches, dev, *, rate, launches,
               reset_launches):
    """Phase 3g: the sharded ring over phase 3c's checkpoint, RING_NODES
    peers each caching a RING_NODES-th of 3c's budget, the disk index's own
    store as the fallback: (a), (d), (e) on a loopback ring
    (:func:`ring_loopback_part`), (b) over the socket wire, (c) chaos, (f)
    the launcher.  Every batch is held against the RAM engine's.  Returns
    the figures and the tiled launches of each part."""
    import torch

    log(f"ring: host MemAvailable {host_available() / 2**30:.2f} GiB before "
        f"the phase, {trim_host_memory():.2f} GiB after a heap trim")
    run = RingRun(d_index, ckpt, budget, batches, dev, launches,
                  reset_launches)
    try:
        log(f"ring: {RING_NODES} peers over {ckpt}, {run.cap} records each "
            f"({run.cap * run.disk.man['record_stride'] / 2**30:.3f} GiB; "
            f"3c's budget {run.disk.cache.capacity_records} records), the "
            f"disk index's own store as the fallback; host memory: "
            f"{meminfo()}")
        run.part("a", ring_loopback_part)
        run.n_launch["a"] -= run.n_launch["d"] + run.n_launch["e"]
        run.fig["a_s"] -= run.fig["d_s"] + run.fig["e_s"]
        run.part("b", ring_socket_part, rate)
        run.part("c", ring_chaos_part)
        run.part("f", ring_launcher_part)
    finally:
        run.close()
    torch.cuda.empty_cache()
    run.fig["secs"] = time.perf_counter() - run.t0
    run.fig["mem_end"] = trim_host_memory()
    return run.fig, run.n_launch


def print_phase_3g(fig):
    """Phase 3g's figures."""
    def nodes(r):
        return ", ".join(f"node {n} {v:.1f}"
                         for n, v in sorted(r["node_blocks"].items()))

    for tr in ("a", "b"):
        for key, r in fig.items():
            if not (isinstance(key, tuple) and key[0] == tr):
                continue
            _, pipeline, mix = key
            fetch = (f", fetch {r['fetch']:.3f} ms" if "fetch" in r else "")
            wire = ""
            if tr == "b":
                gb = r["wire_blocks"] * fig["wire_record"] / 1e9
                wire = (f"; {gb:.3f} GB over the wire a batch"
                        + (f", {gb / (r['fetch'] / 1e3):.2f} GB/s over the "
                           "fetch stage" if "fetch" in r else ""))
            log(f"ring {'loopback' if tr == 'a' else 'socket'} "
                f"pipeline={pipeline} {mix}: batch {r['batch']:.3f} ms"
                f"{fetch} (median of {r['n']}); "
                f"remote blocks {r['remote_blocks']:.1f}, L1 hits "
                f"{r['l1_hits']:.1f} misses {r['l1_misses']:.1f}; blocks a "
                f"batch by node: {nodes(r)}{wire}; max |err| vs RAM "
                f"{r['err']:.3e}")
    log(f"ring socket: one record {fig['wire_record'] / 1e6:.3f} MB on the "
        "wire (npz)")
    c = fig["c"]
    log(f"ring chaos (loopback, uniform, peer 1 killed, peer 2 +"
        f"{CHAOS_LATENCY_S} s a fetch): batch {c['batch']:.3f} ms; failovers "
        f"{c['failovers']}, redirected blocks {c['redirected']}, fallback "
        f"blocks {c['fallback']}, health {c['health']}, degraded batches "
        f"{c['degraded']}, injected {c['injected']}; recovered through "
        f"probe_peers in {c['recovery_s']:.2f} s; the next batch "
        f"{c['recovered']['batch']:.3f} ms with blocks by node "
        f"{nodes(c['recovered'])}; without a fallback: {c['no_fallback']}")
    for mix in ("uniform", "hot_window"):
        d = fig["d", mix]
        log(f"ring termination=exact (segmented fetch) {mix}: batch "
            f"{d['batch']:.3f} ms, equal to the untruncated ring batch; "
            f"fetches skipped {d['skipped']}, probes dropped {d['dropped']}, "
            f"segments skipped {d['seg_skipped']} of {d['segments']}, "
            f"{d['launches']} launches, {d['syncs']} boundary syncs, "
            f"{d['remote']} remote blocks")
    e = fig["e"]
    log(f"ring + {DEVICE_CACHE_MB} MiB device cache (sync) hot: batch "
        f"{e['batch']:.3f} ms; device hits {e['device_hits']:.1f} a warm "
        f"batch (store's device_hits), hit rate {e['hit_rate']:.4f}; remote "
        f"blocks {e['remote_blocks']:.1f}")
    f = fig["f"]
    log(f"ring launcher (--cache-shards {RING_NODES} --cache-transport socket "
        f"--device-cache-mb {DEVICE_CACHE_MB}): {f['batches']} batches, QPS "
        f"{f['qps']:.1f}, latency p50 {f['p50']:.3f} ms p99 {f['p99']:.3f} "
        f"ms; {f['launches']} filtered_scan_tiled launches; max |err| vs the "
        f"RAM engine {f['err']:.3e}; " + json.dumps(f["metrics"],
                                                     sort_keys=True))
    log("ring part times: " + ", ".join(
        f"({p}) {fig[p + '_s']:.2f} s" for p in "abcdef") + "; host "
        "MemAvailable after each trimmed part: " + ", ".join(
            f"({p}) {fig[p + '_mem']:.2f} GiB" for p in "abcf")
        + f"; after the phase {fig['mem_end']:.2f} GiB")


# ---- phase 3h: the multi-shard search over torch.distributed ----

SHARD_MESH = ((2, 3), ("data", "model"))  # 6 ranks on the card, gloo
N_RANKS = 6
RANK_WARMUP, RANK_BATCHES = 1, 2  # per (backend, slack, mix) in 3h
RANK_TIMEOUT_S = 300  # every collective's limit: a hung rank fails the run
STRAGGLER = 3  # the rank whose shard_ok is false
FAILED_SHARD = 1  # the shard marked failed in the server's ShardHealth
COMPRESS_SHAPES = {"emb": (1024, DIM), "proj": (DIM, DIM), "bias": (DIM,)}


def grads_of(rank, dev):
    """Rank ``rank``'s gradient tree for the compression check, from a
    seed: ~5.5 MB of f32."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 + rank)
    return {k: torch.randn(s, generator=gen, device=dev)
            for k, s in COMPRESS_SHAPES.items()}


def shard_rank(rank, work, ckpt, device):
    """One rank of phase 3h (spawned): its shard of 3c's checkpoint read
    from its record range, the sharded search over the (data=2, model=3)
    mesh on every batch of ``work/inputs.npz`` (both backends, at slack S
    and at the default), the straggler drop, the server (rank 0 leads, the
    others follow) and the compressed all-reduce.  Writes its results and
    launch counts to ``work/rank{rank}.pt``."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.core import FilterSpec, storage
    from repro_torch.core import distributed as dist_lib
    from repro_torch.core.serving import SearchServer
    from repro_torch.distributed import compressed_psum_tree
    from repro_torch.kernels.centroid_topk import centroid_topk as ct_mod
    from repro_torch.kernels.filtered_scan import filtered_scan as fs_mod
    from repro_torch.launch import mesh as mesh_lib

    work = Path(work)
    dev = torch.device(device)
    backend = mesh_lib.init_process_group(
        rank, N_RANKS, init_method=f"file://{work / 'store'}", device=dev,
        timeout_s=RANK_TIMEOUT_S)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = mesh_lib.make_mesh(*SHARD_MESH, device_type=dev.type)
        t0 = time.perf_counter()
        shard = storage.load_index_shard(str(ckpt), rank, N_RANKS,
                                         target_shards=N_RANKS, device=dev)
        torch.cuda.synchronize()
        out = dict(backend=backend, coordinate=list(mesh.get_coordinate()),
                   load_s=time.perf_counter() - t0,
                   shard_gib=shard.nbytes() / 2**30,
                   k_local=shard.vectors.shape[0])
        dist.barrier()
        out["mem_loaded"] = host_available() / 2**30
        inputs = dict(np.load(work / "inputs.npz"))  # read once, not per key
        mixes = [str(m) for m in inputs["mixes"]]

        def batch(mix, i):
            lo = torch.from_numpy(inputs[f"{mix}/lo"][i]).to(dev)
            hi = torch.from_numpy(inputs[f"{mix}/hi"][i]).to(dev)
            return (torch.from_numpy(inputs[f"{mix}/queries"][i]).to(dev),
                    FilterSpec(lo=lo, hi=hi))

        def search(backend_, slack):
            return dist_lib.make_sharded_search(
                "dot", q_total=Q, n_clusters=shard.n_clusters, mesh=mesh,
                device=dev,
                cfg=dist_lib.ShardedSearchConfig(
                    k=K_TOP, n_probes=N_PROBES, scan_q_block=64,
                    backend=backend_, prune="auto", p_cap_slack=slack))

        ct_mod.LAUNCHES = fs_mod.LAUNCHES = fs_mod.PER_PROBE_LAUNCHES = 0
        searches = {}
        for backend_ in ("pallas_tiled", "pallas"):
            for slack_name, slack in (("gate", float(N_RANKS)),
                                      ("default", 2.0)):
                fn, info = searches[backend_, slack_name] = search(backend_,
                                                                   slack)
                out[backend_, slack_name, "p_cap"] = info["p_cap"]
                for mix in mixes:
                    for i in range(len(inputs[f"{mix}/queries"])):
                        queries, fspec = batch(mix, i)
                        dist.barrier()
                        torch.cuda.synchronize()
                        t = [time.perf_counter()]
                        plan = fn.plan(shard, queries, fspec)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                        vals, ids = fn.scan(shard, plan)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                        res = fn.merge(plan, vals, ids)
                        torch.cuda.synchronize()
                        t.append(time.perf_counter())
                        live = (plan.u_count if backend_ == "pallas_tiled"
                                else plan.slot_valid.sum())
                        out[backend_, slack_name, mix, i] = dict(
                            ids=res.ids.cpu(), scores=res.scores.cpu(),
                            overflow=int(res.n_scanned[0]),
                            live_slots=int(plan.slot_valid.sum()),
                            scan_slots=int(live),
                            ms=[(b - a) * 1e3 for a, b in zip(t, t[1:])]
                            + [(t[-1] - t[0]) * 1e3])
        # the straggler: shard STRAGGLER dropped from every mix's last batch
        ok = torch.ones((N_RANKS,), dtype=torch.bool, device=dev)
        ok[STRAGGLER] = False
        for backend_ in ("pallas_tiled", "pallas"):
            fn, _ = searches[backend_, "gate"]
            for mix in mixes:
                res = fn(shard, *batch(mix, -1), ok)
                out[backend_, "straggler", mix] = dict(
                    ids=res.ids.cpu(), scores=res.scores.cpu())
        # the server: rank 0 serves the uniform batches as requests
        fn, _ = searches["pallas_tiled", "gate"]
        if rank == 0:
            lead = dist_lib.lead(fn, shard)
            server = SearchServer(lead, batch_size=Q, dim=DIM,
                                  n_attrs=M_ATTRS, n_terms=1,
                                  n_shards=N_RANKS, max_wait_s=SERVE_WAIT_S,
                                  device=dev)
            server.start()
            try:
                served = []
                for i in range(len(inputs["uniform/queries"])):
                    if i == len(inputs["uniform/queries"]) - 1:
                        for _ in range(4):
                            server.health.report(FAILED_SHARD, failed=True)
                    futs = [server.submit(inputs["uniform/queries"][i][j],
                                          (inputs["uniform/lo"][i][j],
                                           inputs["uniform/hi"][i][j]))
                            for j in range(Q)]
                    resp = [f.get(timeout=RANK_TIMEOUT_S) for f in futs]
                    served.append(dict(
                        ids=torch.from_numpy(np.stack([r.ids for r in resp])),
                        scores=torch.from_numpy(np.stack(
                            [r.scores for r in resp])),
                        degraded=[bool(r.degraded) for r in resp]))
            finally:
                server.stop()
                lead.stop()
            out["served"] = served
            out["server_stats"] = dict(server.stats)
            out["ok_mask"] = server.health.ok_mask().tolist()
        else:
            out["followed"] = dist_lib.follow(fn, shard)
        out["launches"] = {"centroid_topk": ct_mod.LAUNCHES,
                           "filtered_scan_tiled": fs_mod.LAUNCHES,
                           "filtered_scan": fs_mod.PER_PROBE_LAUNCHES}
        # one compressed all-reduce over the 6 ranks
        grads = grads_of(rank, dev)
        err = {k: torch.zeros_like(v) for k, v in grads.items()}
        compressed_psum_tree(grads, err, dist.group.WORLD, N_RANKS)  # warm
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, new_err = compressed_psum_tree(grads, err, dist.group.WORLD,
                                             N_RANKS)
        torch.cuda.synchronize()
        out["compress_ms"] = (time.perf_counter() - t0) * 1e3
        out["compress_mean"] = {k: v.cpu() for k, v in mean.items()}
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def ids_pass_filter(index, ids, fspec):
    """[Q, k] bool: each live id's attribute row passes its query's filter
    (pads count as passing)."""
    import torch

    from repro_torch.core import filter_mask

    flat = index.ids.reshape(-1)
    live = flat >= 0
    pos = torch.full((int(flat.max()) + 1,), -1, dtype=torch.long,
                     device=flat.device)
    pos[flat[live].long()] = torch.nonzero(live).squeeze(1)
    ids = ids.to(flat.device).long()
    rows = pos[ids.clamp(min=0)]
    attrs = index.attrs.reshape(-1, index.attrs.shape[-1])[rows.clamp(min=0)]
    ok = filter_mask(fspec, attrs) & (rows >= 0)
    return ok | (ids < 0)


def shard_phase(d_index, ckpt, batches, dev):
    """Phase 3h: N_RANKS spawned ranks as a (data=2, model=3) mesh on the
    card (gloo), each holding its K/S clusters of 3c's checkpoint, read from
    its record range.  Every batch of both backends at p_cap_slack = S is
    held against the one-shard sharded search (phase 3b's) on the same
    batch; the default slack's overflow is logged and its results held to
    the reference's invariants; the straggler, the server and the
    compressed all-reduce are checked.  Returns the figures and the ranks'
    summed launches."""
    import torch
    import torch.multiprocessing as mp

    from repro_torch.core.distributed import (
        ShardedSearchConfig, make_sharded_search)
    from repro_torch.distributed import compressed_psum_tree

    t_phase = time.perf_counter()
    fig = dict(mem_before=trim_host_memory())
    n_run = RANK_WARMUP + RANK_BATCHES
    mixes = list(batches)
    work = ROOT / "build" / "shard_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    arrays = {"mixes": np.array(mixes)}
    for mix in mixes:
        blist = batches[mix][:n_run]
        arrays[f"{mix}/queries"] = np.stack([q.cpu().numpy() for q, _ in blist])
        arrays[f"{mix}/lo"] = np.stack([f.lo.cpu().numpy() for _, f in blist])
        arrays[f"{mix}/hi"] = np.stack([f.hi.cpu().numpy() for _, f in blist])
    np.savez(work / "inputs.npz", **arrays)
    # phase 3b's one-shard search on the same batches: what every batch
    # at slack S must equal
    wants = {}
    for backend in ("pallas_tiled", "pallas"):
        fn, _ = make_sharded_search(
            "dot", q_total=Q, n_clusters=d_index.n_clusters, device=dev,
            cfg=ShardedSearchConfig(k=K_TOP, n_probes=N_PROBES,
                                    scan_q_block=64, backend=backend,
                                    prune="auto"))
        for mix in mixes:
            for i, (queries, fspec) in enumerate(batches[mix][:n_run]):
                res = fn(d_index, queries, fspec)
                wants[backend, mix, i] = (res.scores.cpu(), res.ids.cpu())
    torch.cuda.synchronize()
    log(f"shard phase: {N_RANKS} ranks as a {SHARD_MESH[0]} {SHARD_MESH[1]} "
        f"mesh over {ckpt}; host MemAvailable {fig['mem_before']:.2f} GiB "
        "before the ranks load (heap trimmed)")
    t0 = time.perf_counter()
    mp.start_processes(shard_rank, args=(str(work), str(ckpt), str(dev)),
                       nprocs=N_RANKS, start_method="spawn")  # re-raises
    fig["ranks_s"] = time.perf_counter() - t0
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(N_RANKS)]
    shutil.rmtree(work, ignore_errors=True)
    fig["mem_loaded"] = ranks[0]["mem_loaded"]
    fig["ranks"] = [{k: r[k] for k in ("backend", "coordinate", "load_s",
                                       "shard_gib", "k_local")}
                    for r in ranks]
    fig["p_cap"] = {(b, s): ranks[0][b, s, "p_cap"]
                    for b in ("pallas_tiled", "pallas")
                    for s in ("gate", "default")}
    r0 = ranks[0]
    for backend in ("pallas_tiled", "pallas"):
        for mix in mixes:
            for i in range(n_run):
                name = f"shard {backend} {mix} batch {i}"
                gate = r0[backend, "gate", mix, i]
                for r in ranks[1:]:  # every rank ends with the answer
                    if not torch.equal(r[backend, "gate", mix, i]["ids"],
                                       gate["ids"]):
                        raise AssertionError(f"{name}: ranks disagree")
                if gate["overflow"]:
                    raise AssertionError(f"{name}: overflow at slack S")
                wv, wi = wants[backend, mix, i]
                err = check_topk(f"{name} vs one shard", gate["scores"],
                                 gate["ids"], wv, wi)
                fig[backend, mix, i] = dict(
                    err=err, ms=[r[backend, "gate", mix, i]["ms"]
                                 for r in ranks],
                    live=[r[backend, "gate", mix, i]["live_slots"]
                          for r in ranks],
                    scan=[r[backend, "gate", mix, i]["scan_slots"]
                          for r in ranks])
                d = r0[backend, "default", mix, i]
                fig[backend, mix, i]["overflow"] = d["overflow"]
                fig[backend, mix, i]["default_ms"] = [
                    r[backend, "default", mix, i]["ms"] for r in ranks]
                # the default slack: a counted degradation, never a better
                # or a different answer where nothing overflowed
                if d["overflow"] == 0:
                    check_topk(f"{name} default slack", d["scores"], d["ids"],
                               gate["scores"], gate["ids"])
                elif bool((d["scores"] > gate["scores"]
                           + 1e-6 * gate["scores"].abs()).any()):
                    raise AssertionError(f"{name} default slack: a score "
                                         "above the full search's")
        for mix in mixes:
            queries, fspec = batches[mix][n_run - 1]
            strag = r0[backend, "straggler", mix]
            full = r0[backend, "gate", mix, n_run - 1]
            kl = ranks[0]["k_local"]
            gone = d_index.ids[STRAGGLER * kl:(STRAGGLER + 1) * kl]
            got = strag["ids"].to(dev)
            if bool(torch.isin(got[got >= 0], gone[gone >= 0]).any()):
                raise AssertionError(f"straggler {backend} {mix}: an id of "
                                     "the dropped shard")
            if not bool(ids_pass_filter(d_index, got, fspec).all()):
                raise AssertionError(f"straggler {backend} {mix}: an id "
                                     "fails its filter")
            if int((strag["ids"] >= 0).sum()) > int((full["ids"] >= 0).sum()):
                raise AssertionError(f"straggler {backend} {mix}: more live "
                                     "results than the full batch")
            fig[backend, "straggler", mix] = int(
                (strag["ids"] != full["ids"]).any(-1).sum())
    # the server: every response equal to the search's (each query's
    # answer is its own at slack S, however the server batches it); the
    # last requests served with FAILED_SHARD dropped
    served = r0["served"]
    for i, s in enumerate(served[:-1]):
        gate = r0["pallas_tiled", "gate", "uniform", i]
        if not torch.equal(s["ids"], gate["ids"]) or any(s["degraded"]):
            raise AssertionError(f"server batch {i}: differs from the search")
    if not all(served[-1]["degraded"]):
        raise AssertionError("server: the failed shard's batch is not "
                             "degraded")
    kl = ranks[0]["k_local"]
    gone = d_index.ids[FAILED_SHARD * kl:(FAILED_SHARD + 1) * kl]
    got = served[-1]["ids"].to(dev)
    if bool(torch.isin(got[got >= 0], gone[gone >= 0]).any()):
        raise AssertionError("server: an id of the failed shard")
    n_batches = r0["server_stats"]["batches"]
    if [r["followed"] for r in ranks[1:]] != [n_batches] * (N_RANKS - 1):
        raise AssertionError(f"server: {n_batches} batches served, followed "
                             f"{[r['followed'] for r in ranks[1:]]}")
    fig["server"] = dict(r0["server_stats"], ok_mask=r0["ok_mask"])
    # the compressed all-reduce against the mean computed here
    outs = [compressed_psum_tree(grads_of(r, dev),
                                 {k: torch.zeros(s, device=dev)
                                  for k, s in COMPRESS_SHAPES.items()},
                                 None, 1)[0] for r in range(N_RANKS)]
    c_err = 0.0
    for k in COMPRESS_SHAPES:
        want = torch.stack([o[k] for o in outs]).sum(0) / N_RANKS
        got = r0["compress_mean"][k].to(dev)
        c_err = max(c_err, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-6, atol=1e-7):
            raise AssertionError(f"compressed_psum_tree {k}: off by {c_err}")
    fig["compress"] = dict(
        ms=[r["compress_ms"] for r in ranks], err=c_err,
        mb=sum(np.prod(s) for s in COMPRESS_SHAPES.values()) * 4 / 1e6)
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    for k in ("centroid_topk", "filtered_scan_tiled", "filtered_scan"):
        if not all(r["launches"][k] for r in ranks):
            raise AssertionError(f"shard phase: a rank never launched {k}")
    fig["launches"] = launches
    fig["secs"] = time.perf_counter() - t_phase
    fig["mem_end"] = trim_host_memory()
    return fig, launches


def print_phase_3h(fig):
    """Phase 3h's figures: per batch, rank 0's plan / scan / merge ms and
    the slowest rank's batch, each rank's live slots, the overflow at the
    default slack."""
    for r, info in enumerate(fig["ranks"]):
        log(f"shard rank {r}: {info['backend']} at {info['coordinate']}, "
            f"{info['k_local']} clusters, {info['shard_gib']:.2f} GiB loaded "
            f"in {info['load_s']:.2f} s")
    log(f"shard phase: host MemAvailable {fig['mem_before']:.2f} GiB before "
        f"the ranks load, {fig['mem_loaded']:.2f} GiB with every shard "
        f"loaded, {fig['mem_end']:.2f} GiB after (trimmed); p_cap "
        + ", ".join(f"{b} {s} {v}" for (b, s), v in fig["p_cap"].items()))
    for key, row in fig.items():
        if not (isinstance(key, tuple) and len(key) == 3
                and isinstance(key[2], int)):
            continue
        backend, mix, i = key
        p, s, m, b = row["ms"][0]
        worst = max(x[3] for x in row["ms"])
        dworst = max(x[3] for x in row["default_ms"])
        log(f"shard {backend} {mix} batch {i}{' (warm-up)' if i < RANK_WARMUP else ''}: "
            f"rank 0 plan {p:.3f} ms, scan {s:.3f} ms, tree merge {m:.3f} "
            f"ms, batch {b:.3f} ms; slowest rank's batch {worst:.3f} ms; "
            f"live slots by rank {row['live']}, scanned slots {row['scan']}; "
            f"at the default slack: overflow {row['overflow']}, slowest "
            f"batch {dworst:.3f} ms; max |err| vs one shard {row['err']:.3e}")
    for key, n in fig.items():
        if isinstance(key, tuple) and key[1] == "straggler":
            log(f"shard straggler {key[0]} {key[2]} (rank {STRAGGLER} "
                f"dropped): {n} of {Q} queries changed, none with an id of "
                "its clusters, every id passes its filter")
    srv = fig["server"]
    log(f"shard server (rank 0 leads, {N_RANKS - 1} follow): "
        f"{srv['batches']} batches, {srv['requests']} requests, degraded "
        f"batches {srv['degraded_batches']} (shard {FAILED_SHARD} failed in "
        f"ShardHealth, ok mask {srv['ok_mask']}), latency "
        f"{srv['total_latency_s'] / srv['batches'] * 1e3:.3f} ms a batch")
    c = fig["compress"]
    log(f"shard compressed_psum_tree over {N_RANKS} ranks, {c['mb']:.2f} MB "
        f"f32: {max(c['ms']):.3f} ms (slowest rank), max |err| vs the mean "
        f"{c['err']:.3e}")
    log(f"shard phase {fig['secs']:.2f} s (ranks {fig['ranks_s']:.2f} s); "
        f"launches {fig['launches']}")


# ---- phase 3i: the examples, training and the recsys models ----

EXAMPLES = ("quickstart", "kmeans_index_build", "filtered_search_serving",
            "train_embedder", "recsys_retrieval")
RECSYS_ARCHS = ("din", "sasrec", "bst", "wide_deep")
RECSYS_BATCH = 256
RECSYS_STEPS = 3  # Trainer steps of each config on the card
RESTART_STEPS = 4  # sasrec straight, against half, a checkpoint and half
RECSYS_LR = 1e-3
CPU_STEP_BYTES = 8  # host bytes a CPU step holds per parameter byte
RETRIEVAL_K, RETRIEVAL_T = 100, 16
RETRIEVAL_KC, RETRIEVAL_KMEANS = 1024, 60
RETRIEVAL_M = 4  # category, price bucket, in stock, region
SLICE_WIDTHS = (18, 32, 50, 64)  # the slice's f32 embedding widths


def load_example(name):
    """``examples/torch/<name>.py`` by file path (``examples/torch`` is a
    directory named ``torch``: never on ``sys.path``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_part(launches):
    """Phase 3i (a): each port example at its own size on the card, its
    printed claims held.  Returns {name: (seconds, launches by kernel)}."""
    import torch

    out = {}
    ckpt = ROOT / "build" / "embedder_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        for name in EXAMPLES:
            argv = ["--device", "cuda"]
            if name == "train_embedder":
                argv += ["--ckpt-dir", str(ckpt)]
            before = launches()
            t0 = time.perf_counter()
            log(f"---- example {name} ----")
            res = load_example(name).main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            after = launches()
            out[name] = (secs, {k: after[k] - before[k] for k in after})
            if name == "quickstart":
                ok = res["fused_identical"] and res["self_ids"] == list(
                    range(res["n"], res["n"] + 5))
                claim = (f"fused identical {res['fused_identical']}, "
                         f"self-retrieval {res['self_ids']}")
            elif name == "kmeans_index_build":
                mb, ll = res["minibatch"]["recall"], res["lloyd"]["recall"]
                ok = ll >= mb and res["restored_recall"] == ll
                claim = (f"recall minibatch {mb:.3f} lloyd {ll:.3f}, after "
                         f"restore {res['restored_recall']:.3f}")
            elif name == "filtered_search_serving":
                ok = res["responses_equal"]
                claim = (f"{res['batches']} batches, every response equal "
                         f"to the engine's, {res['qps']:.1f} QPS")
            elif name == "train_embedder":
                losses = res["losses"]
                ok = (losses[-1] <= losses[0] / 10 and res["recall"] >= 0.70
                      and res["hit1"] >= 0.85)
                claim = (f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
                         f"recall@10 {res['recall']:.3f}, hit@1 "
                         f"{res['hit1']:.2f}")
            else:
                ok = res["filters_ok"]
                claim = (f"recall@100 {res['recall']:.3f}, {res['n_cand']} "
                         "candidates a user, every one passing its filter")
            if not ok:
                raise AssertionError(f"example {name}: {claim}")
            log(f"example {name}: {claim}; {secs:.2f} s, launches "
                f"{out[name][1]}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return out


def recsys_loss(cfg):
    from repro_torch.models.recsys import RecsysBatch, loss_fn

    return lambda p, b: loss_fn(p, cfg, RecsysBatch(**b))


def recsys_feeder(cfg, seed):
    from repro_torch.data import ShardedFeeder, recsys_batch

    return ShardedFeeder(
        lambda s, i: recsys_batch(s, i, RECSYS_BATCH, cfg.seq_len,
                                  cfg.n_dense, cfg.n_sparse, cfg.vocab_items,
                                  cfg.vocab_sparse), seed=seed)


def recsys_trainer(cfg, params, optimizer, device, ckpt_dir=None,
                   total=RECSYS_STEPS):
    from repro_torch.train.train_loop import Trainer, TrainLoopConfig

    return Trainer(recsys_loss(cfg), params, TrainLoopConfig(
        total_steps=total, ckpt_every=2, ckpt_dir=ckpt_dir, log_every=1000,
        lr=RECSYS_LR, warmup=0, optimizer=optimizer), device=device)


def run_steps(trainer, feeder, n):
    """``n`` steps one at a time: (losses, each step's ms on the host's
    clock after a ``synchronize``)."""
    import torch

    losses, step_ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses += trainer.run(feeder, max_steps=1)["loss"]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms


STEP_OUTLIERS = 1e-3  # share of a leaf's elements a first step may flip


def step_close(name, got, want, lr=RECSYS_LR):
    """A first training step's parameter on the card against the CPU's:
    all but STEP_OUTLIERS of the elements within rtol 1e-4, atol 1e-6, and
    every element within that plus 2·lr.  A first AdamW or Adafactor step
    is g / (|g| + eps) an element (|step| <= 1): where the gradient is at
    f32 rounding level (a sum that cancels), the two devices' rounding
    gives it another size or sign, which moves the element by up to 2·lr
    more; anywhere else the step agrees.  Returns (max relative error
    where |err| > 1e-6, elements past rtol 1e-4)."""
    import torch

    err = (got - want).abs()
    near = err <= 1e-4 * want.abs() + 1e-6
    outliers = int((~near).sum())
    if outliers > STEP_OUTLIERS * want.numel() or bool(
            (err > 1e-4 * want.abs() + 1e-6 + 2 * lr).any()):
        raise AssertionError(f"{name}: {outliers} of {want.numel()} elements "
                             f"differ from the CPU step, by up to "
                             f"{float(err.max()):.3e}")
    big = err > 1e-6
    rel = float((err[big] / want.abs()[big].clamp(min=1e-30)).max()
                ) if bool(big.any()) else 0.0
    return rel, outliers


def recsys_step_part(dev, seed):
    """Phase 3i (b): each recsys config at its published widths, 3 Trainer
    steps on the card (AdamW; wide_deep also Adafactor); the first held
    against the same step on the CPU from the same parameters (loss and
    every parameter rtol 1e-4).  Returns a row a run."""
    import dataclasses
    import importlib

    import torch

    from repro_torch.models.recsys import init_params
    from repro_torch.train.tree import leaves_with_paths, tree_map

    rows = []
    for arch in RECSYS_ARCHS:
        cfg = importlib.import_module(f"repro_torch.configs.{arch}").config()
        for optimizer in (("adamw", "adafactor") if arch == "wide_deep"
                          else ("adamw",)):
            # the CPU step holds about CPU_STEP_BYTES a parameter byte, plus
            # the two host copies held for the comparison
            run_cfg = cfg
            nbytes = 4 * (cfg.vocab_items * cfg.embed_dim + cfg.n_sparse
                          * cfg.vocab_sparse * (cfg.embed_dim + 1))
            avail = host_available()
            cut = None
            if (CPU_STEP_BYTES + 2) * nbytes > 0.8 * avail:
                keep = max(int(0.8 * avail / (CPU_STEP_BYTES + 2) / 4
                               / max(cfg.n_sparse * (cfg.embed_dim + 1), 1)
                               ), 1024)
                run_cfg = dataclasses.replace(cfg, vocab_sparse=min(
                    keep, cfg.vocab_sparse))
                cut = (f"vocab_sparse {cfg.vocab_sparse} -> "
                       f"{run_cfg.vocab_sparse}: MemAvailable "
                       f"{avail / 2**30:.2f} GiB holds no full CPU step")
                log(f"phase 3i cut: {arch} {optimizer} {cut}")
            gen = torch.Generator(dev).manual_seed(seed)
            params = init_params(gen, run_cfg, device=dev)
            host = tree_map(lambda x: x.cpu(), params)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            trainer = recsys_trainer(run_cfg, params, optimizer, dev)
            del params
            feeder = recsys_feeder(run_cfg, seed)
            try:
                losses, step_ms = run_steps(trainer, feeder, 1)
                first = {"/".join(p): x.cpu() for p, x in
                         leaves_with_paths(trainer.params)}
                more, more_ms = run_steps(trainer, feeder, RECSYS_STEPS - 1)
            finally:
                feeder.close()
            peak = torch.cuda.max_memory_allocated() / 2**30
            n_params = sum(x.numel() for x in first.values())
            del trainer
            torch.cuda.empty_cache()
            mem_before = host_available() / 2**30
            t0 = time.perf_counter()
            cpu = recsys_trainer(run_cfg, host, optimizer, "cpu")
            del host
            feeder = recsys_feeder(run_cfg, seed)
            try:
                cpu_loss = cpu.run(feeder, max_steps=1)["loss"]
            finally:
                feeder.close()
            cpu_s = time.perf_counter() - t0
            mem_cpu = host_available() / 2**30
            if not np.allclose(losses[0], cpu_loss[0], rtol=1e-4, atol=0):
                raise AssertionError(f"{arch} {optimizer}: loss "
                                     f"{losses[0]} on the card, {cpu_loss[0]} "
                                     "on the CPU")
            max_rel, outliers = 0.0, 0
            for path, want in leaves_with_paths(cpu.params):
                key = "/".join(path)
                rel, out = step_close(f"{arch} {optimizer} {key}", first[key],
                                      want)
                max_rel, outliers = max(max_rel, rel), outliers + out
            del cpu, first
            trim_host_memory()
            rows.append(dict(
                arch=arch, optimizer=optimizer, cut=cut, params=n_params,
                param_gib=nbytes / 2**30, losses=losses + more,
                step_ms=step_ms + more_ms, peak_gib=peak, cpu_s=cpu_s,
                cpu_loss=cpu_loss[0], max_rel=max_rel, outliers=outliers,
                mem_before=mem_before, mem_cpu=mem_cpu))
            log(f"recsys {arch} {optimizer}: {n_params} parameters "
                f"({nbytes / 2**30:.2f} GiB), losses "
                f"{[round(x, 6) for x in losses + more]}, step ms "
                f"{[round(x, 3) for x in step_ms + more_ms]}, peak "
                f"{peak:.2f} GiB on the card; first step equal to the CPU's "
                f"(loss {cpu_loss[0]:.6f}, max rel err {max_rel:.2e} where "
                f"|err| > 1e-6, {outliers} elements past rtol 1e-4; CPU "
                f"step {cpu_s:.2f} s, MemAvailable {mem_before:.2f} GiB "
                f"before, {mem_cpu:.2f} after)")
    return rows


def restart_part(dev, seed):
    """Phase 3i (b): sasrec at full width, RESTART_STEPS steps straight
    against half, a checkpoint, a fresh Trainer from the same initial
    parameters and the other half: every parameter and state leaf equal
    bit for bit."""
    import importlib

    import torch

    from repro_torch.models.recsys import init_params
    from repro_torch.train.tree import leaves_with_paths, tree_map

    cfg = importlib.import_module("repro_torch.configs.sasrec").config()
    init = init_params(torch.Generator(dev).manual_seed(seed + 1), cfg,
                       device=dev)
    ckpt = ROOT / "build" / "restart_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        runs = []
        for d, steps in ((None, None), (ckpt, RESTART_STEPS // 2),
                         (ckpt, None)):
            trainer = recsys_trainer(
                cfg, tree_map(torch.clone, init), "adamw", dev,
                ckpt_dir=None if d is None else str(d), total=RESTART_STEPS)
            feeder = recsys_feeder(cfg, seed)
            try:
                trainer.run(feeder, max_steps=steps)
            finally:
                feeder.close()
            runs.append(trainer)
        straight, half, resumed = runs
        if (half.step, resumed.step, straight.step) != (
                RESTART_STEPS // 2, RESTART_STEPS, RESTART_STEPS):
            raise AssertionError("restart: wrong step counts")
        want = dict(leaves_with_paths({"params": straight.params,
                                       "opt": straight.opt_state}))
        n = 0
        for path, got in leaves_with_paths({"params": resumed.params,
                                            "opt": resumed.opt_state}):
            if not torch.equal(got, want[path]):
                raise AssertionError(f"restart: {'/'.join(path)} differs")
            n += 1
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    secs = time.perf_counter() - t0
    log(f"restart (sasrec, {RESTART_STEPS} steps straight against "
        f"{RESTART_STEPS // 2} + checkpoint + {RESTART_STEPS // 2}): all "
        f"{n} parameter and state leaves equal bit for bit; {secs:.2f} s")
    return dict(leaves=n, secs=secs)


def width_cases(dev, gen):
    """f32 operands of both scans at the slice's embedding widths (M = 4),
    the tiled scan at k = 10 and 100: ("tiled" | "per_probe", name, args,
    kwargs)."""
    import torch

    kc, vpad, m, qb, n_tiles, u_cap, q, p = 6, 264, RETRIEVAL_M, 16, 3, 5, 9, 40

    def ri(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    for d in SLICE_WIDTHS:
        vec = torch.randn((kc, vpad, d), generator=gen, device=dev)
        attrs = ri(0, 8, (kc, vpad, m), torch.int16)
        ids = ri(-1, 10**6, (kc, vpad), torch.int32)
        queries = torch.randn((n_tiles * qb, d), generator=gen, device=dev)
        lo = ri(-8, 3, (n_tiles * qb, 1, m), torch.int16)
        hi = ri(3, 9, (n_tiles * qb, 1, m), torch.int16)
        for k in (K_TOP, K_WIDE):
            yield "tiled", f"D={d} k={k}", (
                ri(0, kc, (n_tiles * u_cap,), torch.int32),
                torch.arange(n_tiles, device=dev, dtype=torch.int32
                             ).repeat_interleave(u_cap),
                ri(1, u_cap + 1, (n_tiles,), torch.int32), queries, lo, hi,
                vec, attrs, ids, None, None), dict(metric="dot", k=k,
                                                   q_block=qb)
        yield "per_probe", f"D={d}", (
            ri(0, kc, (p,), torch.int32), ri(0, q, (p,), torch.int32),
            queries[:q].contiguous(), lo[:q].contiguous(), hi[:q].contiguous(),
            vec, attrs, ids, None, None), dict(metric="dot")


def retrieval_part(dev, seed, launches):
    """Phase 3i (c): SASRec ``config()`` user vectors for RECSYS_BATCH
    histories as queries of a hybrid index over all of its L2-normalised
    item rows (K = 1024, 60 k-means steps, f32), filtered as the example
    does, k = 100, T = 16, through ``search_fused`` and ``SearchEngine``:
    both held against ``search_reference`` (ids by the near-tie rule) and
    against ``brute_force`` (recall@100, every id passing its filter);
    each path's batch timed with CUDA events.  Returns (fig, the launches
    of the searches, the operands for the D = 50 kernel checks)."""
    import importlib

    import torch

    from repro_torch.core import (FilterBuilder, HybridSpec, SearchEngine,
                                  brute_force, build_ivf, from_builders,
                                  recall_at_k, search_reference)
    from repro_torch.core.hybrid import l2_normalize
    from repro_torch.core.search import search_centroids
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.filtered_scan import search_fused
    from repro_torch.models.recsys import (RecsysBatch, init_params,
                                           user_embedding)

    cfg = importlib.import_module("repro_torch.configs.sasrec").config()
    gen = torch.Generator(dev).manual_seed(seed + 2)
    params = init_params(gen, cfg, device=dev)
    arrays = recsys_batch(seed, 0, RECSYS_BATCH, cfg.seq_len, cfg.n_dense,
                          cfg.n_sparse, cfg.vocab_items, cfg.vocab_sparse)
    batch = RecsysBatch(**{k: torch.as_tensor(v, device=dev)
                           for k, v in arrays.items()})
    with torch.no_grad():
        users = l2_normalize(user_embedding(params, cfg, batch)).contiguous()
        items = l2_normalize(params["item_table"])
    del params
    rng = np.random.default_rng(seed)
    attrs_np = rng.integers(0, 8, (cfg.vocab_items, RETRIEVAL_M)).astype(
        np.int16)
    attrs = torch.as_tensor(attrs_np, device=dev)
    t0 = time.perf_counter()
    index, stats = build_ivf(
        torch.Generator(dev).manual_seed(seed + 3),
        HybridSpec(dim=cfg.embed_dim, n_attrs=RETRIEVAL_M,
                   core_dtype=torch.float32), items, attrs,
        n_clusters=RETRIEVAL_KC, kmeans_steps=RETRIEVAL_KMEANS, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"retrieval index: {cfg.vocab_items} SASRec item rows D="
        f"{cfg.embed_dim} f32, K={index.n_clusters}, Vpad={index.vpad}, "
        f"longest list {stats.max_list_len} (mean "
        f"{stats.mean_list_len:.0f}); built in {build_s:.2f} s")
    fspec = from_builders([FilterBuilder(RETRIEVAL_M).eq(0, u % 8).ge(2, 1)
                           for u in range(RECSYS_BATCH)], device=dev)
    kw = dict(k=RETRIEVAL_K, n_probes=RETRIEVAL_T)
    ref = search_reference(index, users, fspec, **kw)
    oracle = brute_force(items, attrs, users, fspec, k=RETRIEVAL_K)
    engine = SearchEngine(index, q_block=64, prune="auto", **kw)

    def timed(fn, reps=3):
        res = fn()  # warm-up
        times = []
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            res = fn()
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        return res, statistics.median(times)

    before = launches()
    paths = {}
    paths["search_fused"] = timed(lambda: search_fused(index, users, fspec,
                                                       **kw))
    paths["engine"] = timed(lambda: engine.search(users, fspec))
    after = launches()
    searched = {k: after[k] - before[k] for k in after}
    if not (searched["filtered_scan"] and searched["filtered_scan_tiled"]):
        raise AssertionError(f"retrieval: a path missed its kernel "
                             f"{searched}")
    paths["search_reference"] = timed(
        lambda: search_reference(index, users, fspec, **kw))
    paths["brute_force"] = timed(
        lambda: brute_force(items, attrs, users, fspec, k=RETRIEVAL_K))
    fig = dict(build_s=build_s, vpad=index.vpad, kc=index.n_clusters,
               max_list=stats.max_list_len, paths={})
    rec_ref = recall_at_k(ref, oracle)
    for name, (res, batch_ms) in paths.items():
        rec = recall_at_k(res, oracle)
        err = 0.0
        if name in ("search_fused", "engine"):
            err = check_topk(f"retrieval {name}", res.scores, res.ids,
                             ref.scores, ref.ids)
            if abs(rec - rec_ref) > 0.005:
                raise AssertionError(f"retrieval {name}: recall {rec} "
                                     f"against the reference's {rec_ref}")
        ids = res.ids.cpu().numpy()
        for u in range(RECSYS_BATCH):
            live = ids[u][ids[u] >= 0]
            if not ((attrs_np[live, 0] == u % 8).all()
                    and (attrs_np[live, 2] >= 1).all()):
                raise AssertionError(f"retrieval {name}: user {u}'s "
                                     "candidates fail the filter")
        fig["paths"][name] = dict(ms=batch_ms, recall=rec, max_abs_err=err)
        log(f"retrieval {name}: batch of {RECSYS_BATCH} {batch_ms:.3f} ms "
            f"(median of 3, CUDA events), recall@{RETRIEVAL_K} {rec:.4f} "
            f"against brute force; every candidate passes its filter"
            + (f"; equal to search_reference by the near-tie rule, max "
               f"|err| {err:.3e}" if name in ("search_fused", "engine")
               else ""))
    plan = engine.plan(users, fspec)
    probe_ids, _ = search_centroids(index, users, RETRIEVAL_T)
    slot_query = torch.repeat_interleave(
        torch.arange(RECSYS_BATCH, dtype=torch.int32, device=dev),
        RETRIEVAL_T)
    operands = dict(
        tiled=((plan.slot_cluster, plan.slot_tile, plan.n_unique,
                plan.queries_pad, plan.lo_pad, plan.hi_pad, index.vectors,
                index.attrs, index.ids, None, None),
               dict(metric="dot", k=RETRIEVAL_K, q_block=plan.q_block)),
        per_probe=((probe_ids.reshape(-1).contiguous(), slot_query, users,
                    fspec.lo.contiguous(), fspec.hi.contiguous(),
                    index.vectors, index.attrs, index.ids, None, None), {}),
        vpad=index.vpad, kc=index.n_clusters, d=cfg.embed_dim)
    engine.close()
    return fig, searched, operands


def slice_kernels(dev, gen, operands):
    """Phase 3i (c): both scans against their plain versions at the
    slice's f32 widths (small shapes) and on the retrieval's full-size
    D = 50 operands, k = 100, each timed beside its plain version and its
    bound (the card's time alone).  Launches here are comparisons and
    count nowhere."""
    import torch

    from repro_torch.kernels.filtered_scan import filtered_scan as fs_mod
    from repro_torch.kernels.filtered_scan.ref import (
        filtered_scan_ref, filtered_scan_tiled_ref, live_slots)

    for kind, name, a, kw in width_cases(dev, gen):
        if kind == "tiled":
            got = fs_mod.filtered_scan_tiled(*a, **kw)
            torch.cuda.synchronize()
            err = check_scan(f"filtered_scan_tiled f32 {name}", got,
                             *plain_scan(a, kw))
        else:
            got = fs_mod.filtered_scan(*a, **kw)
            torch.cuda.synchronize()
            err = check_scores(f"filtered_scan f32 {name}", got,
                               filtered_scan_ref(*a, **kw))
        log(f"{'filtered_scan_tiled' if kind == 'tiled' else 'filtered_scan'}"
            f" f32 {name}: ok, max |err| {err:.3e}")
    out = {}
    a, kw = operands["tiled"]
    d, vpad = operands["d"], operands["vpad"]
    body = fs_mod.tiled_body(d, RETRIEVAL_M, 1, "dot", torch.float32,
                             torch.float32)
    err = check_scan("retrieval full size, tiled, D=50 k=100",
                     fs_mod.filtered_scan_tiled(*a, **kw), *plain_scan(a, kw))
    k_ms = ms(lambda: fs_mod.filtered_scan_tiled(*a, **kw), 10)
    p_ms = ms(lambda: filtered_scan_tiled_ref(*a, **kw), 3)
    plan_live = live_slots(a[1], a[2])
    b_ms, byte_ms, op_ms, n_live, n_cl = tiled_bound(
        a[0], plan_live, a[3], a[4], a[2], kw["q_block"], vpad,
        k=RETRIEVAL_K, v_bytes=4, peak="f32", d=d)
    out["filtered_scan_tiled"] = dict(
        d=d, k=RETRIEVAL_K, body=body, live_slots=n_live, clusters=n_cl,
        ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
        bound_by="bytes" if byte_ms >= op_ms else "operations",
        max_abs_err=err)
    log(f"filtered_scan_tiled retrieval full size (D={d} f32 x f32, "
        f"{body} body, k={RETRIEVAL_K}): {n_live} live slots over {n_cl} "
        f"clusters, Vpad {vpad}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
        f"bound {b_ms:.3f} ms (bytes {byte_ms:.3f}, f32 FMA ops "
        f"{op_ms:.3f}), kernel / bound {k_ms / b_ms:.2f}; max |err| "
        f"{err:.3e}")
    a, kw = operands["per_probe"]
    err = check_scores("retrieval full size, per-probe, D=50",
                       fs_mod.filtered_scan(*a), filtered_scan_ref(*a))
    k_ms = ms(lambda: fs_mod.filtered_scan(*a), 10)
    p_ms = ms(lambda: filtered_scan_ref(*a), 3)
    b = per_probe_bound(a[0], a[1], a[2], a[3], operands["kc"], vpad, d=d,
                        m=RETRIEVAL_M, v_bytes=4)
    out["filtered_scan"] = dict(d=d, slots=b["slots"], ms=k_ms,
                                plain_ms=p_ms, bound_ms=b["bound_ms"],
                                bound_by=b["bound_by"], max_abs_err=err)
    log(f"filtered_scan retrieval full size (D={d} f32, scalar loads): "
        f"P={b['slots']} slots over {b['clusters']} clusters, {b['pairs']} "
        f"pairs; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
        f"{b['bound_ms']:.3f} ms ({b['bound_by']}), kernel / bound "
        f"{k_ms / b['bound_ms']:.2f}; max |err| {err:.3e}")
    return out


def slice_phase(dev, gen, seed, launches, reset_launches):
    """Phase 3i: the examples, the recsys models under the Trainer, the
    bit-for-bit restart and the SASRec retrieval at full width.  Launch
    counts are set to 0 before and read after the examples and the
    retrieval's searches.  Returns (fig, launches)."""
    import torch

    t_phase = time.perf_counter()
    fig = dict(mem_start=host_available() / 2**30)
    reset_launches()
    fig["examples"] = example_part(launches)
    ex_launches = launches()
    torch.cuda.empty_cache()
    fig["recsys"] = recsys_step_part(dev, seed)
    fig["restart"] = restart_part(dev, seed)
    torch.cuda.empty_cache()
    reset_launches()
    fig["retrieval"], searched, operands = retrieval_part(dev, seed,
                                                          launches)
    fig["kernels"] = slice_kernels(dev, gen, operands)
    del operands
    torch.cuda.empty_cache()
    fig["mem_end"] = trim_host_memory()
    fig["secs"] = time.perf_counter() - t_phase
    total = {k: ex_launches[k] + searched[k] for k in ex_launches}
    return fig, total


def print_phase_3i(fig):
    ex = fig["examples"]
    log("phase 3i examples (s): " + ", ".join(
        f"{name} {secs:.2f}" for name, (secs, _) in ex.items()))
    for r in fig["recsys"]:
        steady = r["step_ms"][1:] or r["step_ms"]
        log(f"phase 3i {r['arch']} {r['optimizer']}: step "
            f"{statistics.median(steady):.3f} ms (steps 2-{RECSYS_STEPS}; "
            f"first {r['step_ms'][0]:.3f}), peak {r['peak_gib']:.2f} GiB, "
            f"{r['params']} parameters" + (f"; cut: {r['cut']}" if r["cut"]
                                           else ""))
    ret = fig["retrieval"]
    log("phase 3i retrieval: " + ", ".join(
        f"{name} {p['ms']:.3f} ms recall@{RETRIEVAL_K} {p['recall']:.4f}"
        for name, p in ret["paths"].items())
        + f"; build {ret['build_s']:.2f} s")
    log(f"phase 3i: host MemAvailable {fig['mem_start']:.2f} GiB at the "
        f"start, {fig['mem_end']:.2f} at the end; {fig['secs']:.2f} s")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n", type=int, default=10_000_000)
    p.add_argument("--disk-n", type=int, default=None,
                   help="serve a separate index of this many vectors in "
                   "phase 3c (default: the phase-3 index)")
    p.add_argument("--variants", action="store_true",
                   help="also time the per-probe filtered_scan's compile-time "
                   "variants (FS_VARIANT_DEFINES) on each mix's slot table")
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
    from repro_torch.core import storage as storage_lib
    from repro_torch.core.distributed import (
        BACKENDS, ShardedSearchConfig, make_sharded_search)
    from repro_torch.core.search import SearchResult
    from repro_torch.kernels import build
    from repro_torch.kernels.centroid_topk import centroid_topk as ct_mod
    from repro_torch.kernels.centroid_topk.ref import centroid_topk_ref
    from repro_torch.kernels.filtered_scan import filtered_scan as fs_mod
    from repro_torch.kernels.filtered_scan import search_fused
    from repro_torch.kernels.filtered_scan.ref import (
        filtered_scan_ref, filtered_scan_tiled_ref, live_slots)

    def reset_launches():
        ct_mod.LAUNCHES = fs_mod.LAUNCHES = fs_mod.PER_PROBE_LAUNCHES = 0

    def launches():
        return {"centroid_topk": ct_mod.LAUNCHES,
                "filtered_scan_tiled": fs_mod.LAUNCHES,
                "filtered_scan": fs_mod.PER_PROBE_LAUNCHES}

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
        tc = sass_counts(rep["path"])
        log(f"built {name} in {rep['seconds']:.2f} s; SASS tensor-core "
            f"instructions {tc}; " + " | ".join(ptxas))
        if name == "filtered_scan_tiled" and not tc["HGMMA"] + tc["HMMA"]:
            raise AssertionError("filtered_scan_tiled has no tensor-core "
                                 "instructions")
    for qdt in (torch.bfloat16, torch.float32):  # the two full-size pairs
        body = fs_mod.tiled_body(DIM, M_ATTRS, 1, "dot", qdt, torch.bfloat16)
        if body != "tensor_cores":
            raise AssertionError(f"filtered_scan_tiled {qdt} x bf16 at "
                                 f"D={DIM} runs on the {body} body")
    log(f"phase 1 (build) {time.perf_counter() - t0:.2f} s")

    # ---- phase 2: kernels against their plain versions, small shapes ----
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    for name, a, kw in small_cases(dev, gen):
        got = fs_mod.filtered_scan_tiled(*a, **kw)
        torch.cuda.synchronize()
        err = check_scan(name, got, *plain_scan(a, kw))
        log(f"filtered_scan_tiled {name}: ok, max |err| {err:.3e}")
    for name, q_, c_, t, metric in centroid_cases(dev, gen):
        got, err = check_centroids(name, q_, c_, t, metric)
        if not bool((got[1] >= 0).all()):
            raise AssertionError(f"centroid_topk {name}: -1 probes")
        log(f"centroid_topk {name}: ok, max |err| {err:.3e}")
    for name, a, kw in per_probe_cases(dev, gen):
        got = fs_mod.filtered_scan(*a, **kw)
        torch.cuda.synchronize()
        err = check_scores(name, got, filtered_scan_ref(*a, **kw))
        log(f"filtered_scan {name}: ok, max |err| {err:.3e}")
    log(f"phase 2 (kernel checks) {time.perf_counter() - t0:.2f} s")

    # ---- phase 3i: the examples, training and the recsys models (first
    # of the phases: the host's and the card's memory are at their freest)
    t0 = time.perf_counter()
    slice_fig, slice_launches = slice_phase(dev, gen, args.seed, launches,
                                            reset_launches)
    print_phase_3i(slice_fig)
    log(f"phase 3i (examples, training, recsys) {time.perf_counter() - t0:.2f}"
        f" s; {time.perf_counter() - t_all:.2f} s since start; launches "
        f"{slice_launches}")

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
    reset_launches()
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
    engine_launches = launches()
    t_main = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    n_tiled = engine_launches["filtered_scan_tiled"]
    if n_tiled < len(mixes) * (WARMUP + BATCHES):
        raise AssertionError(f"filtered_scan_tiled launched {n_tiled} times")
    for mix in mixes:
        plan_ms, scan_ms, whole = (statistics.median(c) for c in zip(*timings[mix]))
        (queries, fspec), res, plan = results[mix]
        n_live = int(plan.n_unique.sum())
        log(f"{mix}: plan {plan_ms:.3f} ms, scan+merge {scan_ms:.3f} ms, batch "
            f"{whole:.3f} ms (medians of {BATCHES}), QPS {Q / whole * 1e3:.1f}; "
            f"u_cap {plan.u_cap}, live slots {n_live}, pruned probes "
            f"{int(res.n_pruned.sum())}, mean passed rows "
            f"{float(res.n_passed.float().mean()):.1f}")
    log(f"main path: {n_tiled} launches of filtered_scan_tiled in "
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

    # ---- phase 3b: the one-shard sharded search and search_fused ----
    t0 = time.perf_counter()
    reset_launches()
    sharded, sharded_times, searches = {}, {}, {}
    for backend in BACKENDS:
        fn, info = searches[backend] = make_sharded_search(
            "dot", q_total=Q, n_clusters=index.n_clusters,
            cfg=ShardedSearchConfig(k=K_TOP, n_probes=N_PROBES,
                                    scan_q_block=64, backend=backend,
                                    prune="auto"))
        scan = "filtered_scan_tiled" if backend == "pallas_tiled" else "filtered_scan"
        for mix in mixes:
            rows = []
            for i, (queries, fspec) in enumerate(batches[mix]):
                before = launches()
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                splan = fn.plan(index, queries, fspec)
                ev[1].record()
                res = fn.execute(index, splan)
                ev[2].record()
                ev[2].synchronize()
                after = launches()
                for kname in ("centroid_topk", scan):
                    if after[kname] == before[kname]:
                        raise AssertionError(f"sharded {backend} {mix} batch "
                                             f"{i}: no {kname} launch")
                if int(res.n_scanned.max()) != 0:
                    raise AssertionError(f"sharded {backend} {mix}: overflow")
                if i >= WARMUP:
                    rows.append((ev[0].elapsed_time(ev[1]),
                                 ev[1].elapsed_time(ev[2]),
                                 ev[0].elapsed_time(ev[2])))
            sharded[backend, mix] = (res, splan)
            sharded_times[backend, mix] = rows
    fused, fused_ms = {}, {}
    for mix in mixes:
        queries, fspec = batches[mix][-1]
        before = launches()["filtered_scan"]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fused[mix] = search_fused(index, queries, fspec, k=K_TOP,
                                  n_probes=N_PROBES)
        ev[1].record()
        ev[1].synchronize()
        fused_ms[mix] = ev[0].elapsed_time(ev[1])
        if launches()["filtered_scan"] == before:
            raise AssertionError(f"search_fused {mix}: no filtered_scan launch")
    sharded_launches = launches()
    log(f"sharded path: p_cap {info['p_cap']}, launches {sharded_launches} "
        f"in {len(BACKENDS) * len(mixes) * (WARMUP + BATCHES)} sharded and "
        f"{len(mixes)} search_fused batches, {time.perf_counter() - t0:.2f} s")
    for backend in BACKENDS:
        for mix in mixes:
            plan_ms, scan_ms, whole = (statistics.median(c) for c in
                                       zip(*sharded_times[backend, mix]))
            log(f"sharded {backend} {mix}: probe+dispatch {plan_ms:.3f} ms, "
                f"scan+merge {scan_ms:.3f} ms, batch {whole:.3f} ms (medians "
                f"of {BATCHES}), QPS {Q / whole * 1e3:.1f}")
    for mix in mixes:
        (queries, fspec), eng, _ = results[mix]
        agree = probe_agreement(index, queries)
        for backend in BACKENDS:
            check_sharded(f"sharded {backend} {mix}", index, queries, fspec,
                          sharded[backend, mix][0], eng, agree)
        check_fused(f"search_fused {mix}", index, queries, fspec, fused[mix],
                    eng)
        log(f"{mix}: the sharded search (both backends) and search_fused "
            f"({fused_ms[mix]:.3f} ms, one batch) match search_reference and "
            f"the engine; {int((~agree).sum())} queries left out for probe "
            "sets that differ at a near-tie")
    log(f"phase 3b (sharded path) {time.perf_counter() - t_all:.2f} s since "
        "start")

    # ---- phase 3c: the disk tier ----
    t0 = time.perf_counter()
    rate = h2d_rate(dev)
    n_disk = DISK_WARMUP + DISK_BATCHES
    d_index, d_engine, d_centers = index, engine, centers
    d_batches = {mix: batches[mix][:n_disk] for mix in mixes}
    if args.disk_n not in (None, args.n):
        log(f"phase 3c cut: a separate index of N={args.disk_n} vectors "
            f"(--disk-n) in place of N={args.n}")
        d_index, d_stats, d_centers = make_index(args.disk_n, dev, gen)
        if d_stats.n_dropped:
            raise AssertionError("the phase-3c build dropped rows")
        d_engine = SearchEngine(d_index, k=K_TOP, n_probes=N_PROBES,
                                q_block=64, prune="auto")
        d_batches = {mix: [mix_batch(mix, d_centers, dev, gen)
                           for _ in range(n_disk)] for mix in mixes}
    ram_results = {mix: [d_engine.search(q, f) for q, f in d_batches[mix]]
                   for mix in mixes}
    disk_launches, _, ckpt = disk_phase(
        d_index, d_batches, ram_results, dev, reset_launches=reset_launches,
        launches=launches, rate=rate)
    del d_engine
    log(f"phase 3c (disk tier) {time.perf_counter() - t0:.2f} s; "
        f"{time.perf_counter() - t_all:.2f} s since start")

    # ---- phase 3e: device cache, sub-partitions, termination (before 3d
    # republishes the checkpoint) ----
    t0 = time.perf_counter()
    ok = False
    try:
        man = storage_lib.load_manifest(str(ckpt))
        _, budget = disk_budget(ckpt, d_index.n_clusters, man["record_stride"])
        reset_launches()
        dc_rows, dc_launches = device_cache_part(
            ckpt, budget, d_batches, ram_results, dev, launches)
        log(f"phase 3e device cache {time.perf_counter() - t0:.2f} s")
        build, part_dir, part_fig = write_partitions(d_index, ckpt, dev)
        try:
            part_rows, ram_part, _, part_launches = partition_part(
                d_index, build, part_dir, budget, d_centers, dev, gen,
                launches)
        finally:
            shutil.rmtree(part_dir, ignore_errors=True)
        del build
        log(f"phase 3e partitions {time.perf_counter() - t0:.2f} s")
        term_rows, term_launches = termination_part(
            index, batches, ckpt, budget, dev, launches)
        e_launches = launches()
        ok = True
    finally:
        if not ok:
            shutil.rmtree(ckpt, ignore_errors=True)
    del ram_results
    torch.cuda.empty_cache()
    print_phase_3e(dc_rows, part_fig, part_rows, ram_part, term_rows)
    log(f"phase 3e (device cache, partitions, termination) "
        f"{time.perf_counter() - t0:.2f} s; {time.perf_counter() - t_all:.2f} "
        f"s since start; launches {e_launches} (device cache {dc_launches}, "
        f"partitions {part_launches}, termination {term_launches} of "
        f"filtered_scan_tiled)")

    # ---- phase 3f: serving and the index build (before 3d republishes
    # the checkpoint) ----
    t0 = time.perf_counter()
    try:
        serve_fig = serve_part(d_index, index, engine, batches, ckpt,
                               launches, reset_launches)
        log(f"phase 3f serving {time.perf_counter() - t0:.2f} s")
        build_fig = build_part(args, dev, launches, reset_launches)
    except BaseException:
        shutil.rmtree(ckpt, ignore_errors=True)
        raise
    f_launches = (sum(r["launches"] for r in serve_fig.values())
                  + build_fig["launcher"]["launches"])
    print_phase_3f(serve_fig, build_fig)
    log(f"phase 3f (serving, build) {time.perf_counter() - t0:.2f} s; "
        f"{time.perf_counter() - t_all:.2f} s since start; {f_launches} "
        "launches of filtered_scan_tiled")

    # ---- phase 3g: the sharded ring (before 3d republishes the
    # checkpoint) ----
    t0 = time.perf_counter()
    try:
        ring_fig, ring_launches = ring_phase(
            d_index, ckpt, budget, d_batches, dev, rate=rate,
            launches=launches, reset_launches=reset_launches)
    except BaseException:
        shutil.rmtree(ckpt, ignore_errors=True)
        raise
    print_phase_3g(ring_fig)
    log(f"phase 3g (sharded ring) {time.perf_counter() - t0:.2f} s; "
        f"{time.perf_counter() - t_all:.2f} s since start; "
        f"filtered_scan_tiled launches by part {ring_launches}")

    # ---- phase 3h: the multi-shard search (before 3d republishes the
    # checkpoint) ----
    t0 = time.perf_counter()
    try:
        shard_fig, shard_launches = shard_phase(d_index, ckpt, d_batches, dev)
    except BaseException:
        shutil.rmtree(ckpt, ignore_errors=True)
        raise
    print_phase_3h(shard_fig)
    log(f"phase 3h (multi-shard search) {time.perf_counter() - t0:.2f} s; "
        f"{time.perf_counter() - t_all:.2f} s since start; launches "
        f"{shard_launches}")

    # ---- phase 3d: live updates on the disk tier ----
    t0 = time.perf_counter()
    try:
        live_launches, live_fig = live_phase(
            d_index, d_centers, ckpt, dev, gen,
            reset_launches=reset_launches, launches=launches)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del d_index
    torch.cuda.empty_cache()
    print_live(live_fig)
    log(f"phase 3d (live updates) {time.perf_counter() - t0:.2f} s; "
        f"{time.perf_counter() - t_all:.2f} s since start; launches "
        f"{live_launches}")

    # ---- phase 4: each kernel on one full-size batch ----
    t0 = time.perf_counter()
    _, _, plan = results["uniform"]
    a = (plan.slot_cluster, plan.slot_tile, plan.n_unique, plan.queries_pad,
         plan.lo_pad, plan.hi_pad, index.vectors, index.attrs, index.ids,
         None, None)
    kw = dict(metric="dot", k=K_TOP, q_block=plan.q_block)
    got = fs_mod.filtered_scan_tiled(*a, **kw)
    max_err = check_scan("full-size uniform batch", got, *plain_scan(a, kw))
    kernel_ms = ms(lambda: fs_mod.filtered_scan_tiled(*a, **kw), 10)
    plain_ms = ms(lambda: filtered_scan_tiled_ref(*a, **kw), 3)
    bound_ms, byte_ms, op_ms, n_live, n_clusters = tiled_bound(
        plan.slot_cluster, live_slots(plan.slot_tile, plan.n_unique),
        plan.queries_pad, plan.lo_pad, plan.n_unique, plan.q_block,
        index.vpad)
    ops = op_ms * PEAK_OPS["bf16"] / 1e3
    log(f"filtered_scan_tiled full size, engine operands "
        f"({plan.queries_pad.dtype} queries x bf16): {n_live} live slots "
        f"over {n_clusters} clusters; kernel {kernel_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms (bytes {byte_ms:.3f} ms, "
        f"bf16 ops {op_ms:.3f} ms; f32 FMA ops "
        f"{ops / PEAK_OPS['f32'] * 1e3:.3f} ms); "
        f"{ops / kernel_ms / 1e9:.1f} TFLOP/s achieved, kernel / bound "
        f"{kernel_ms / bound_ms:.2f}; max |err| {max_err:.3e}")
    # the same operands at the paper's k = 100 (four list slots a lane)
    kw100 = dict(kw, k=K_WIDE)
    w_err = check_scan(f"full-size uniform batch, k={K_WIDE}",
                       fs_mod.filtered_scan_tiled(*a, **kw100),
                       *plain_scan(a, kw100))
    w_ms = ms(lambda: fs_mod.filtered_scan_tiled(*a, **kw100), 10)
    w_plain = ms(lambda: filtered_scan_tiled_ref(*a, **kw100), 3)
    w_bound, w_byte, w_op, _, _ = tiled_bound(
        plan.slot_cluster, live_slots(plan.slot_tile, plan.n_unique),
        plan.queries_pad, plan.lo_pad, plan.n_unique, plan.q_block,
        index.vpad, k=K_WIDE)
    log(f"filtered_scan_tiled full size, engine operands, k={K_WIDE}: kernel "
        f"{w_ms:.3f} ms (k={K_TOP}: {kernel_ms:.3f} ms), plain {w_plain:.3f} "
        f"ms, bound {w_bound:.3f} ms (bytes {w_byte:.3f} ms, bf16 ops "
        f"{w_op:.3f} ms), kernel / bound {w_ms / w_bound:.2f}; max |err| "
        f"{w_err:.3e}")
    kernels = [dict(
        name="filtered_scan_tiled", route="cuda",
        source="src/repro_torch/kernels/filtered_scan/csrc/filtered_scan_tiled.cu",
        replaces="src/repro/kernels/filtered_scan/filtered_scan.py:360",
        launches=(engine_launches["filtered_scan_tiled"]
                  + sharded_launches["filtered_scan_tiled"]
                  + disk_launches["filtered_scan_tiled"]
                  + e_launches["filtered_scan_tiled"]
                  + f_launches
                  + sum(ring_launches.values())
                  + shard_launches["filtered_scan_tiled"]
                  + live_launches["filtered_scan_tiled"]
                  + slice_launches["filtered_scan_tiled"]),
        max_abs_err=max_err, ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by="bytes" if byte_ms >= op_ms else "operations",
        library_ms=None,
        wide=dict(k=K_WIDE, ms=w_ms, plain_ms=w_plain, bound_ms=w_bound,
                  bound_by="bytes" if w_byte >= w_op else "operations",
                  max_abs_err=w_err),
        f32={k: build_fig["f32"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "vpad")},
        recsys=slice_fig["kernels"]["filtered_scan_tiled"],
    )]

    # the sharded tiled backend's own operands: f32 queries against the
    # bf16 index, dedup pads passed as cluster -1
    tsearch, _ = searches["pallas_tiled"]
    _, tplan = sharded["pallas_tiled", "uniform"]
    u_live = (torch.arange(tplan.u_cluster.shape[0], device=dev)
              < tplan.u_count)
    ta = (torch.where(u_live, tplan.u_cluster, -1), tplan.u_tile, None,
          tplan.queries_in, tplan.lo_in, tplan.hi_in, index.vectors,
          index.attrs, index.ids, None, None)
    tkw = dict(metric="dot", k=K_TOP, q_block=tsearch.scan_q_block)
    t_err = check_scan("full-size uniform batch, sharded tiled operands",
                       fs_mod.filtered_scan_tiled(*ta, **tkw),
                       *plain_scan(ta, tkw))
    t_ms = ms(lambda: fs_mod.filtered_scan_tiled(*ta, **tkw), 10)
    t_plain = ms(lambda: filtered_scan_tiled_ref(*ta, **tkw), 3)
    t_bound, t_byte, t_op, t_live, t_clusters = tiled_bound(
        ta[0], u_live, tplan.queries_in, tplan.lo_in, None,
        tsearch.scan_q_block, index.vpad)
    log(f"filtered_scan_tiled full size, sharded tiled operands "
        f"({tplan.queries_in.dtype} queries x bf16): {t_live} live of "
        f"{ta[0].shape[0]} slots over {t_clusters} clusters; kernel "
        f"{t_ms:.3f} ms, plain {t_plain:.3f} ms, bound {t_bound:.3f} ms "
        f"(bytes {t_byte:.3f} ms, bf16 ops {t_op:.3f} ms), kernel / bound "
        f"{t_ms / t_bound:.2f}; max |err| {t_err:.3e}")

    # centroid_topk: the uniform batch's queries against every centroid
    queries = batches["uniform"][-1][0]
    cents = index.centroids
    kc = cents.shape[0]
    _, ct_err = check_centroids("centroid_topk full size", queries, cents,
                                N_PROBES)
    ct_ms = ms(lambda: ct_mod.centroid_topk(queries, cents, t=N_PROBES), 20)
    ct_plain = ms(lambda: centroid_topk_ref(queries, cents, t=N_PROBES), 5)
    ct_lib = ms(lambda: torch.topk(torch.matmul(queries, cents.T), N_PROBES),
                20)
    ct_wall = ms(lambda: ct_mod.centroid_topk(queries, cents, t=N_PROBES), 20,
                 queued=False)
    lib_wall = ms(lambda: torch.topk(torch.matmul(queries, cents.T),
                                     N_PROBES), 20, queued=False)
    ct_bytes = (Q * DIM + kc * DIM) * 4 + Q * N_PROBES * 8
    ct_ops = 2 * Q * kc * DIM
    ct_byte_ms = ct_bytes / HBM_BYTES_PER_S * 1e3
    ct_op_ms = ct_ops / PEAK_OPS["f32"] * 1e3
    log(f"centroid_topk full size: Q={Q} K={kc} D={DIM} f32 T={N_PROBES}; "
        f"kernel {ct_ms:.3f} ms, plain {ct_plain:.3f} ms, torch.matmul + "
        f"torch.topk {ct_lib:.3f} ms, bound {max(ct_byte_ms, ct_op_ms):.3f} ms "
        f"(bytes {ct_byte_ms:.4f} ms, f32 FMA ops {ct_op_ms:.4f} ms); "
        f"{ct_ops / ct_ms / 1e9:.2f} TFLOP/s achieved; max |err| {ct_err:.3e}; "
        f"from an idle card, host issue included: kernel {ct_wall:.3f} ms, "
        f"torch.matmul + torch.topk {lib_wall:.3f} ms")
    # at T = 56, the widest t_max="auto" plan (two list slots a lane)
    tw = min(T_WIDE, kc)
    _, cw_err = check_centroids(f"centroid_topk full size T={tw}",
                                queries, cents, tw)
    cw_ms = ms(lambda: ct_mod.centroid_topk(queries, cents, t=tw), 20)
    cw_plain = ms(lambda: centroid_topk_ref(queries, cents, t=tw), 5)
    cw_lib = ms(lambda: torch.topk(torch.matmul(queries, cents.T), tw), 20)
    cw_byte_ms = ((Q * DIM + kc * DIM) * 4 + Q * tw * 8
                  ) / HBM_BYTES_PER_S * 1e3
    sweep = {t_: (ms(lambda t_=t_: ct_mod.centroid_topk(queries, cents, t=t_),
                     20),
                  ms(lambda t_=t_: torch.topk(torch.matmul(queries, cents.T),
                                              t_), 20))
             for t_ in sorted({8, 32, 128, kc} & set(range(1, kc + 1)))}
    log("centroid_topk full size, kernel / torch.matmul + torch.topk ms: "
        + ", ".join(f"T={t_} {a:.3f} / {b:.3f}" for t_, (a, b)
                    in sweep.items()))
    log(f"centroid_topk full size T={tw}: kernel {cw_ms:.3f} ms "
        f"(T={N_PROBES}: {ct_ms:.3f} ms), plain {cw_plain:.3f} ms, "
        f"torch.matmul + torch.topk {cw_lib:.3f} ms, bound "
        f"{max(cw_byte_ms, ct_op_ms):.3f} ms; max |err| {cw_err:.3e}")
    kernels.append(dict(
        name="centroid_topk", route="cuda",
        source="src/repro_torch/kernels/centroid_topk/csrc/centroid_topk.cu",
        replaces="src/repro/kernels/centroid_topk/centroid_topk.py:82",
        launches=(sharded_launches["centroid_topk"]
                  + shard_launches["centroid_topk"]
                  + slice_launches["centroid_topk"]), max_abs_err=ct_err,
        ms=ct_ms, plain_ms=ct_plain, bound_ms=max(ct_byte_ms, ct_op_ms),
        bound_by="bytes" if ct_byte_ms >= ct_op_ms else "operations",
        library_ms=ct_lib,
        wide=dict(t=tw, ms=cw_ms, plain_ms=cw_plain,
                  bound_ms=max(cw_byte_ms, ct_op_ms),
                  bound_by="bytes" if cw_byte_ms >= ct_op_ms else "operations",
                  max_abs_err=cw_err, library_ms=cw_lib),
    ))

    # filtered_scan: each mix's per-probe slot table, pads included, as the
    # sharded search passes it
    fs_mixes, fs_tables = {}, {}
    for mix in mixes:
        _, splan = sharded["pallas", mix]
        pa = fs_tables[mix] = (
            splan.slot_cluster, splan.slot_query, splan.queries_in,
            splan.lo_in, splan.hi_in, index.vectors, index.attrs, index.ids,
            None, None)
        err = check_scores(f"filtered_scan full size {mix}",
                           fs_mod.filtered_scan(*pa), filtered_scan_ref(*pa))
        k_ms = ms(lambda: fs_mod.filtered_scan(*pa), 10)
        p_ms = ms(lambda: filtered_scan_ref(*pa), 3)
        b = per_probe_bound(splan.slot_cluster, splan.slot_query,
                            splan.queries_in, splan.lo_in, index.n_clusters,
                            index.vpad)
        fs_mixes[mix] = dict(
            slots=b["slots"], live_slots=int(splan.slot_valid.sum()),
            clusters=b["clusters"], pairs=b["pairs"], ms=k_ms, plain_ms=p_ms,
            bound_ms=b["bound_ms"], bound_by=b["bound_by"], max_abs_err=err)
        log(f"filtered_scan full size {mix}: P={b['slots']} slots "
            f"({fs_mixes[mix]['live_slots']} live) over {b['clusters']} "
            f"clusters, {b['pairs']} distinct (cluster, query) pairs; kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b['bound_ms']:.3f} ms "
            f"(bytes {b['byte_ms']:.3f} ms, f32 FMA ops {b['op_ms']:.3f} ms; "
            f"{b['streamed_ms']:.3f} ms if every slot streams its own "
            f"cluster), kernel / bound {k_ms / b['bound_ms']:.2f}; "
            f"{b['bytes'] / k_ms / 1e6:.1f} GB/s of distinct bytes; max |err| "
            f"{err:.3e}")
    if args.variants:
        time_variants(fs_mod, fs_tables)
    uni = fs_mixes["uniform"]
    kernels.append(dict(
        name="filtered_scan", route="cuda",
        source="src/repro_torch/kernels/filtered_scan/csrc/filtered_scan.cu",
        replaces="src/repro/kernels/filtered_scan/filtered_scan.py:160",
        launches=(sharded_launches["filtered_scan"]
                  + shard_launches["filtered_scan"]
                  + slice_launches["filtered_scan"]),
        max_abs_err=uni["max_abs_err"], ms=uni["ms"], plain_ms=uni["plain_ms"],
        bound_ms=uni["bound_ms"], bound_by=uni["bound_by"], library_ms=None,
        mixes=fs_mixes, recsys=slice_fig["kernels"]["filtered_scan"],
    ))
    log(f"phase 4 (kernel timing) {time.perf_counter() - t0:.2f} s; total "
        f"{time.perf_counter() - t_all:.2f} s")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
