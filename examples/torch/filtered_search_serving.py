"""End-to-end serving example on the card through the port: the
micro-batching server over the search execution engine, a straggler
demonstration, the disk tier, the device cache, bound-driven termination,
the sharded cache ring, live updates and filter-specialized
sub-partitions; the counterpart of ``examples/filtered_search_serving.py``
(whose docstring draws the engine's stages and the cache hierarchy).

Every search below runs through :class:`repro_torch.core.engine.
SearchEngine`, so through the tiled ``filtered_scan_tiled`` kernel on the
card: plan (centroid top-k, summary pruning, per-tile probe dedup) →
fetch (a ``BlockStore``: resident, local disk, or the sharded ring, with
the per-batch operand cache and the cross-batch device cache) → scan +
merge.

    PYTHONPATH=src python examples/torch/filtered_search_serving.py
    PYTHONPATH=src python examples/torch/filtered_search_serving.py \\
        --device cpu --n 8000 --requests 48 --term-n 4000 --part-n 6000

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
CUDA is absent.  Every claim it prints is checked (a failed one raises);
``main`` returns the numbers behind them.
"""

import argparse
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.core import FilterSpec, HybridSpec, match_all, storage
from repro_torch.core.disk import DiskIVFIndex
from repro_torch.core.engine import SearchEngine
from repro_torch.core.hybrid import ATTR_MAX, ATTR_MIN
from repro_torch.core.ivf import build_from_assignments
from repro_torch.core.kmeans import assign, minibatch_kmeans
from repro_torch.core.serving import SearchServer, make_fused_search_fn
from repro_torch.data import synthetic_attributes, synthetic_embeddings
from repro_torch.device import resolve_device


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _same_ids(a, b) -> bool:
    return bool(torch.equal(a.cpu(), b.cpu()))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--term-n", type=int, default=20_000,
                    help="rows of the termination demo's corpus")
    ap.add_argument("--part-n", type=int, default=24_000,
                    help="rows of the sub-partition demo's corpus")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu")
    return ap.parse_args(argv)


def serve_part(core, attrs, centroids, search_fn, batch_size, n_requests,
               rng, dev, out):
    """The micro-batching server over ``search_fn``: concurrent filtered
    clients, every response held against the engine on the same queries."""
    n, d = core.shape
    m = attrs.shape[1]
    server = SearchServer(
        search_fn, batch_size=batch_size, dim=d, n_attrs=m, n_terms=1,
        n_shards=8, max_wait_s=0.002, device=dev,
    )
    server.start()
    print(f"serving {n_requests} concurrent filtered queries "
          f"(micro-batch {batch_size}) ...")
    rows = rng.integers(0, n, n_requests)
    queries = core[rows]
    # filter within the query's own content category (users browse a
    # category and search inside it)
    cats = (assign(torch.as_tensor(queries, device=dev), centroids).cpu()
            .numpy() % 8)
    lo = np.full((n_requests, 1, m), ATTR_MIN, np.int16)
    hi = np.full((n_requests, 1, m), ATTR_MAX, np.int16)
    lo[:, 0, 0] = hi[:, 0, 0] = cats  # WHERE attr0 == cat
    responses = [None] * n_requests
    latencies = []
    lock = threading.Lock()

    def client(i):
        resp = server.search_blocking(queries[i], (lo[i], hi[i]))
        with lock:
            responses[i] = resp
            latencies.append(resp.latency_s)

    t0 = time.time()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_requests)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    wall = time.time() - t0
    server.stop()
    _check(all(r is not None for r in responses), "a request got no answer")
    for cat, r in zip(cats, responses):
        live = r.ids[r.ids >= 0]
        _check(len(live) > 0, "a request found nothing")
        _check(bool((attrs[live, 0] == cat).all()), "filter violated!")
    # every response equals the engine's answer on the same queries
    got = torch.from_numpy(np.stack([r.ids for r in responses]))
    want = []
    for r0 in range(0, n_requests, batch_size):
        q = torch.as_tensor(queries[r0:r0 + batch_size], device=dev)
        f = FilterSpec(lo=torch.from_numpy(lo[r0:r0 + batch_size]).to(dev),
                       hi=torch.from_numpy(hi[r0:r0 + batch_size]).to(dev))
        want.append(search_fn.engine.search(q, f).ids.cpu())
    _check(torch.equal(got, torch.cat(want)),
           "a server response differs from the engine's")
    lat = np.asarray(latencies) * 1e3
    print(f"done in {wall:.2f}s → {n_requests/wall:.0f} QPS")
    print(f"latency p50 {np.percentile(lat, 50):.1f}ms  "
          f"p95 {np.percentile(lat, 95):.1f}ms  "
          f"p99 {np.percentile(lat, 99):.1f}ms")
    print(f"batches {server.stats['batches']}, "
          f"avg batch {server.stats['requests']/server.stats['batches']:.1f}, "
          f"all filters satisfied, every response equal to the engine's ✓")
    out.update(qps=n_requests / wall, p50_ms=float(np.percentile(lat, 50)),
               p99_ms=float(np.percentile(lat, 99)),
               batches=server.stats["batches"], responses_equal=True)

    # --- straggler degradation: drop a shard, results stay sound ---
    for _ in range(5):  # EWMA needs sustained failures to cross threshold
        server.health.report(3, failed=True)
    _check(not server.health.ok_mask()[3], "shard 3 still healthy")
    print(f"shard 3 marked unhealthy → ok_mask {server.health.ok_mask()}; "
          "merges continue degraded (associative top-k monoid)")


def disk_part(index, ckpt, core, search_fn, batch_size, k, rng, dev, out):
    """The disk tier, pruning and the device cache over one checkpoint,
    each batch equal to the RAM tier's; returns the batch for later parts."""
    n = core.shape[0]
    m = index.spec.n_attrs
    budget = index.nbytes() // 4  # serve from ~25% of the RAM footprint
    with DiskIVFIndex.open(ckpt, resident_budget_bytes=budget,
                           device=dev) as disk:
        # q_block=8 → 4 tiles per batch of 32: the pipeline's grain
        engine = SearchEngine(disk, k=k, n_probes=7, q_block=8,
                              pipeline="on", pipeline_depth=2, device=dev)
        queries = torch.as_tensor(core[rng.integers(0, n, batch_size)],
                                  device=dev)
        fspec = match_all(batch_size, m, device=dev)
        disk.prefetch_for_queries(queries, 7, q_block=8)
        ram_scores, ram_ids = search_fn(queries, fspec, None)
        res = engine.search(queries, fspec)
        _check(_same_ids(ram_ids, res.ids), "disk ids differ from RAM")
        print(f"disk tier: resident {disk.resident_bytes()/2**20:.1f} "
              f"MiB of {index.nbytes()/2**20:.1f} MiB index "
              f"(budget {budget/2**20:.1f} MiB), ids identical to RAM ✓")
        print(f"pipelined executor: {engine.stats.tiles_scanned} tiles, "
              f"overlap {engine.stats.overlap_ratio:.2f}, adaptive u_cap "
              f"{engine.stats.last_u_cap} of worst-case "
              f"{min(8 * 7, disk.n_clusters)}")

        # selective filter: the summaries prove most probed clusters hold
        # no passing row, so the plan prunes them
        lo = np.full((batch_size, 1, m), ATTR_MIN, np.int16)
        hi = np.full((batch_size, 1, m), ATTR_MAX, np.int16)
        lo[:, 0, 0] = hi[:, 0, 0] = 3  # WHERE attr0 == 3
        sel = FilterSpec(lo=torch.from_numpy(lo).to(dev),
                         hi=torch.from_numpy(hi).to(dev))
        pruned = engine.search(queries, sel)
        unpruned = disk.search(queries, sel, k=k, n_probes=7, q_block=8,
                               prune="off")
        _check(_same_ids(pruned.ids, unpruned.ids), "pruning changed ids")
        n_pruned = int(pruned.n_pruned.sum())
        print(f"filtered (attr0==3): pruned {n_pruned} of "
              f"{7 * batch_size} probes, scanned "
              f"{int(pruned.n_scanned.sum())} vs "
              f"{int(unpruned.n_scanned.sum())} rows, slot table "
              f"{engine.stats.last_u_cap} slots, ids identical ✓")
        print(f"operand cache: {engine.stats.blocks_fetched} blocks "
              f"fetched, {engine.stats.blocks_reused} reused across "
              f"tiles of their batch")
        engine.close()

        # --- cross-batch device cache: the top of the hierarchy ---
        dc_engine = SearchEngine(disk, k=k, n_probes=7, q_block=8,
                                 pipeline="on", device_cache=64 * 2**20,
                                 device=dev)
        cold = dc_engine.search(queries, fspec)
        fetched_cold = dc_engine.stats.blocks_fetched
        warm = dc_engine.search(queries, fspec)
        _check(_same_ids(ram_ids, cold.ids) and _same_ids(ram_ids, warm.ids),
               "device-cache ids differ from RAM")
        _check(dc_engine.stats.blocks_fetched == fetched_cold,
               "the warm pass fetched blocks")
        dcs = dc_engine.device_cache.stats()
        print(f"device cache: warm pass fetched 0 blocks "
              f"({dcs['hits']} device hits, hit rate "
              f"{dcs['hit_rate']:.2f}, "
              f"{dcs['resident_bytes']/2**20:.1f} MiB resident), "
              f"ids identical ✓")
        dc_engine.close()
    out.update(n_pruned=n_pruned, device_hits=dcs["hits"])
    return queries, fspec, ram_ids


def termination_part(m, k, n_rows, dev, out):
    """Bound-driven early termination on a separable-topic corpus:
    ``"exact"`` equals the untruncated result, ``"bounded"`` trades recall
    for latency."""
    tk, tn, td, tq_n = 16, n_rows, 128, 64
    trng = np.random.default_rng(12)
    tbase = trng.standard_normal((tk // 2, td)).astype(np.float32)
    tbase /= np.linalg.norm(tbase, axis=-1, keepdims=True)
    tstep = trng.standard_normal((tk // 2, td)).astype(np.float32)
    tstep /= np.linalg.norm(tstep, axis=-1, keepdims=True)
    tcent = np.empty((tk, td), np.float32)
    tcent[0::2] = tbase
    twin = tbase + 0.25 * tstep
    tcent[1::2] = twin / np.linalg.norm(twin, axis=-1, keepdims=True)
    ttopic = (np.arange(tn) * tk) // tn
    tcore = tcent[ttopic] + 0.05 * trng.standard_normal(
        (tn, td)).astype(np.float32)
    tcore /= np.linalg.norm(tcore, axis=-1, keepdims=True)
    ts_range = 10_000
    tband = ts_range // tk
    tattrs = trng.integers(0, 16, (tn, m)).astype(np.int16)
    tattrs[:, 0] = (ttopic * tband
                    + trng.integers(0, tband, tn)).astype(np.int16)
    tattrs[:, 1] = ttopic.astype(np.int16)
    # planted attribute outliers pin every cluster's summary interval to
    # the full range, so the termination tiers, not the planner, drop
    # cross-topic probes; the two populations are disjoint
    bin_ts = (np.arange(tk) * (ts_range - 1)) // (tk - 1)
    for t in range(tk):
        rows = np.where(ttopic == t)[0]
        tattrs[rows[:tk], 0] = bin_ts.astype(np.int16)
        tattrs[rows[tk:3 * tk], 1] = np.repeat(
            np.arange(tk), 2).astype(np.int16)
    tindex, _ = build_from_assignments(
        HybridSpec(dim=td, n_attrs=m, core_dtype=torch.float32),
        tcent, tcore, tattrs, ttopic.astype(np.int32), device=dev)
    # selective stream: three hot topics, a thin window in the topic's own
    # time band AND the topic's category
    tpairs = trng.permutation(tk // 2)[:3]
    hot3 = 2 * tpairs + trng.integers(0, 2, 3)
    hot = hot3[trng.integers(0, 3, tq_n)]
    tq = torch.as_tensor(tcent[hot] + 0.01 * trng.standard_normal(
        (tq_n, td)).astype(np.float32), device=dev)
    tlo = np.full((tq_n, 1, m), ATTR_MIN, np.int16)
    thi = np.full((tq_n, 1, m), ATTR_MAX, np.int16)
    w = 50
    start = hot * tband + trng.integers(0, tband - w, tq_n)
    tlo[:, 0, 0] = start.astype(np.int16)
    thi[:, 0, 0] = (start + w - 1).astype(np.int16)
    tlo[:, 0, 1] = thi[:, 0, 1] = hot.astype(np.int16)
    tsel = FilterSpec(lo=torch.from_numpy(tlo).to(dev),
                      hi=torch.from_numpy(thi).to(dev))

    base_eng = SearchEngine(tindex, k=k, n_probes=4, q_block=tq_n,
                            prune="on", device=dev)
    base = base_eng.search(tq, tsel)
    base_eng.close()
    base_ids = [set(int(v) for v in row if v >= 0)
                for row in base.ids.cpu().numpy()]
    sweep = []
    for label, term, eps in (("off", None, 0.0),
                             ("exact", "exact", 0.0),
                             ("eps=0.01", "bounded", 0.01),
                             ("eps=0.05", "bounded", 0.05)):
        teng = SearchEngine(tindex, k=k, n_probes=4, q_block=tq_n,
                            prune="on", termination=term, epsilon=eps,
                            device=dev)
        res = teng.search(tq, tsel)  # warm-up
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            res = teng.search(tq, tsel)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
        ms = float(np.median(walls)) * 1e3
        got = [set(int(v) for v in row if v >= 0)
               for row in res.ids.cpu().numpy()]
        recall = float(np.mean([len(b & g) / max(len(b), 1)
                                for b, g in zip(base_ids, got)]))
        if term == "exact":  # the contract, not a measurement
            _check(_same_ids(res.ids, base.ids),
                   "exact termination changed ids")
        sweep.append((label, ms, recall, teng.stats.probes_terminated,
                      teng.stats.term_segments_skipped))
        teng.close()
    print("termination sweep (separable-topic corpus, thin band+"
          "category filter):")
    print("  mode      batch-ms  recall@10  probes-dropped  seg-skips")
    for label, ms, recall, dropped, skips in sweep:
        print(f"  {label:9s} {ms:8.2f} {recall:10.3f} {dropped:13d} "
              f"{skips:9d}")
    print("  (exact is bit-identical by construction; ε trades "
          "bounded recall for latency)")
    out["termination"] = sweep


def ring_part(ckpt, queries, fspec, ram_ids, k, dev, out):
    """The sharded cluster cache: three in-process peers over one full
    checkpoint copy; a killed peer fails over to the local copy and comes
    back through an active probe, ids identical throughout."""
    from repro_torch.core import blockstore as bstore
    from repro_torch.core import faults

    store = bstore.open_sharded(
        ckpt, n_nodes=3, transport="loopback",
        breaker_kwargs=dict(failure_threshold=1, cooldown_s=0.05,
                            half_open_successes=1), device=dev)
    try:
        with DiskIVFIndex.open(ckpt, device=dev) as disk:
            engine = SearchEngine(disk, k=k, n_probes=7, q_block=8,
                                  pipeline="on", blockstore=store,
                                  device=dev)
            res = engine.search(queries, fspec)
            _check(_same_ids(ram_ids, res.ids), "ring ids differ from RAM")
            s = store.stats()
            served = {node: v["blocks_served"]
                      for node, v in s["per_node"].items()}
            print(f"sharded cache (3 nodes): ids identical to RAM ✓, "
                  f"blocks per node {served}, L1 hits {s['l1_hits']}")

            # kill a node mid-run: the next two fetch ops against peer 1
            # are refused, then the peer comes back
            faults.inject(store, 1, (faults.FaultRule("refuse", count=2),))
            with store._l1_lock:
                store._l1.clear()  # force refetching through the ring
            res2 = engine.search(queries, fspec)
            _check(_same_ids(ram_ids, res2.ids),
                   "failover ids differ from RAM")
            s = store.stats()
            print(f"node 1 killed mid-run: ids identical ✓ — "
                  f"failovers {s['failovers']}, blocks served by the "
                  f"local fallback {s['fallback_blocks']}, node 1 "
                  f"circuit {s['health'][1]}")
            deadline = time.monotonic() + 30
            while store.health.state(1) != "closed":
                _check(time.monotonic() < deadline, "node 1 never recovered")
                store.probe_peers()
                time.sleep(0.06)
            print("node 1 back: circuit closed via active probe, "
                  "remote fetches resume — no restart")
            out.update(failovers=s["failovers"],
                       fallback_blocks=s["fallback_blocks"])
            engine.close()
    finally:
        store.close()


def live_part(ckpt, core, n, m, k, rng, dev, out):
    """Live updates under the server: an add is searchable the next batch,
    a tombstone masks it, and a republish is adopted between batches."""
    from repro_torch.core import compact_deltas

    with DiskIVFIndex.open(ckpt, device=dev) as disk:
        live_fn = make_fused_search_fn(disk, k=k, n_probes=7, q_block=8,
                                       delta_budget_mb=4.0,
                                       device_cache_mb=32.0, device=dev)
        tier = live_fn.delta
        live = SearchServer(live_fn, batch_size=8, dim=core.shape[1],
                            n_attrs=m, n_terms=1, n_shards=8,
                            max_wait_s=0.002, device=dev)
        live.start()
        try:
            # add → searchable the very next batch, no rebuild
            v_new = core[rng.integers(0, n)] * 0.9 + 0.1
            row = np.full((1, m), 3, np.int16)
            tier.add(v_new[None], row, np.asarray([n + 7]))
            resp = live.search_blocking(v_new)
            _check(int(resp.ids[0]) == n + 7, "the live add is not found")
            print(f"live add: id {n + 7} is its own nearest neighbor "
                  "one batch after the write ✓")

            # tombstone → masked immediately, the next candidate surfaces
            tier.tombstone(np.asarray([n + 7]))
            resp = live.search_blocking(v_new)
            _check(n + 7 not in set(int(i) for i in resp.ids),
                   "the tombstoned row is still served")
            print("live delete: tombstone masks the row in the next "
                  "batch, k results still returned ✓")

            # background republish + between-batch adoption
            more = core[rng.integers(0, n, 16)] + 0.01
            tier.add(more, np.full((16, m), 3, np.int16),
                     np.arange(n + 100, n + 116))
            st = compact_deltas(ckpt, tier)
            live.request_refresh()          # adopted between batches
            while tier.stats()["pending"]:  # next batches drain the flip
                live.search_blocking(v_new)
            _check(tier.stats()["rows"] == 0, "the delta is not empty")
            metrics = live_fn.metrics()
            print(f"republish: {st.clusters_rewritten} clusters rewritten "
                  f"at gen {st.gen_max}, {st.rows_folded} rows folded, "
                  f"delta empty again; invalidations — host cache "
                  f"{metrics['store.invalidations']}, device cache "
                  f"{metrics['device_cache.invalidations']} (only "
                  "rewritten blocks at both layers) ✓")
            out.update(clusters_rewritten=st.clusters_rewritten)
        finally:
            live.stop()
            live_fn.close()


def partition_part(d, m, k, n_rows, dev, out):
    """Filter-specialized sub-partitions on an attribute uncorrelated with
    content (a timestamp): a thin window routes to narrow sub-clusters,
    a wide one falls back to the flat plan, ids identical both ways."""
    from repro_torch.core import build_partitions

    pn, pts_range, pwin = n_rows, 6_000, 150
    prng = np.random.default_rng(5)
    pcore = synthetic_embeddings(3, pn, d)
    pattrs = synthetic_attributes(3, pn, m, cardinalities=[8])
    pattrs[:, 0] = prng.integers(0, pts_range, pn).astype(np.int16)
    pcore_t = torch.as_tensor(pcore, device=dev)
    pstate = minibatch_kmeans(torch.Generator(dev).manual_seed(3), pcore_t,
                              n_clusters=16, n_steps=30,
                              batch_size=min(4096, pn))
    passign = assign(pcore_t, pstate.centroids)
    pindex, _ = build_from_assignments(
        HybridSpec(dim=d, n_attrs=m, core_dtype=torch.float32),
        pstate.centroids, pcore_t, pattrs, passign, device=dev)
    pbuild = build_partitions(pindex, attrs=[0])
    with tempfile.TemporaryDirectory() as pdir:
        storage.save_index(pindex, pdir, n_shards=2, layout=4,
                           partitions=pbuild)
        with DiskIVFIndex.open(pdir, device=dev) as pdisk:
            cat = pdisk.partitions
            routed = SearchEngine(pdisk, k=k, n_probes=4, q_block=8,
                                  partitions="auto", device=dev)
            flat = SearchEngine(pdisk, k=k, n_probes=4, q_block=8,
                                partitions="off", device=dev)
            pq = torch.as_tensor(pcore[prng.integers(0, pn, 32)], device=dev)
            # coherent traffic: the whole batch shares one thin
            # time window, so it routes to one catalog entry
            lo = np.full((32, 1, m), ATTR_MIN, np.int16)
            hi = np.full((32, 1, m), ATTR_MAX, np.int16)
            start = int(prng.integers(0, pts_range - pwin))
            lo[:, 0, 0], hi[:, 0, 0] = start, start + pwin - 1
            thin = FilterSpec(lo=torch.from_numpy(lo).to(dev),
                              hi=torch.from_numpy(hi).to(dev))
            r = routed.search(pq, thin)
            f = flat.search(pq, thin)
            _check(_same_ids(r.ids, f.ids), "routed ids differ from flat")
            _check(routed.stats.partition_hits > 0, "nothing was routed")
            hits = routed.stats.partition_hits
            rows_r = int(r.n_scanned.sum())
            rows_f = int(f.n_scanned.sum())
            print(f"sub-partitions: catalog {cat.n_entries} entries / "
                  f"{cat.n_subs} subs over {cat.n_base} clusters "
                  f"({cat.nbytes()/2**10:.1f} KiB resident)")
            print(f"  thin window (width {pwin} of {pts_range}): routed "
                  f"scans {rows_r} rows vs flat {rows_f} "
                  f"({rows_f/max(rows_r, 1):.1f}× fewer), "
                  f"{hits} routed queries, ids identical ✓")
            # a predicate wider than any catalog entry declines the route
            # and runs the flat plan verbatim, counted
            lo[:, 0, 0], hi[:, 0, 0] = 0, pts_range // 2
            wide = FilterSpec(lo=torch.from_numpy(lo).to(dev),
                              hi=torch.from_numpy(hi).to(dev))
            r2 = routed.search(pq, wide)
            f2 = flat.search(pq, wide)
            _check(_same_ids(r2.ids, f2.ids), "fallback ids differ")
            _check(routed.stats.partition_hits == hits, "a wide route hit")
            _check(routed.stats.partition_fallbacks > 0, "no fallback")
            print(f"  wide window (width {pts_range // 2}): no entry "
                  f"subsumes it → flat fallback "
                  f"({routed.stats.partition_fallbacks} queries), "
                  "ids identical ✓")
            out.update(routed_rows=rows_r, flat_rows=rows_f,
                       partition_hits=hits)
            routed.close()
            flat.close()


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    n, d, m, k = args.n, 64, 6, 10
    batch_size = 32
    out = {}
    print(f"building index N={n} D={d} M={m} on {dev} ...")
    core = synthetic_embeddings(0, n, d)
    attrs = synthetic_attributes(0, n, m, cardinalities=[8])
    # attr0: a content-correlated category, modeled as the content
    # partition's group id, so the cluster summaries can prune probes
    core_t = torch.as_tensor(core, device=dev)
    state = minibatch_kmeans(torch.Generator(dev).manual_seed(0), core_t,
                             n_clusters=100, n_steps=40,
                             batch_size=min(4096, n))
    assignment = assign(core_t, state.centroids)
    attrs[:, 0] = (assignment.cpu().numpy() % 8).astype(np.int16)
    spec = HybridSpec(dim=d, n_attrs=m, core_dtype=torch.float32)
    index, _ = build_from_assignments(spec, state.centroids, core_t, attrs,
                                      assignment, device=dev)

    # the tiled fused path: the micro-batch's overlapping probes are
    # deduped per query tile, so each hot cluster streams once a batch
    search_fn = make_fused_search_fn(index, k=k, n_probes=7,
                                     q_block=batch_size, device=dev)
    search_fn(torch.zeros((batch_size, d), device=dev),
              match_all(batch_size, m, device=dev), None)  # warm-up
    _sync(dev)
    rng = np.random.default_rng(1)
    try:
        serve_part(core, attrs, state.centroids, search_fn, batch_size,
                   args.requests, rng, dev, out)
        with tempfile.TemporaryDirectory() as ckpt:
            storage.save_index(index, ckpt, n_shards=4)
            queries, fspec, ram_ids = disk_part(
                index, ckpt, core, search_fn, batch_size, k, rng, dev, out)
            termination_part(m, k, args.term_n, dev, out)
            ring_part(ckpt, queries, fspec, ram_ids, k, dev, out)
            live_part(ckpt, core, n, m, k, rng, dev, out)
    finally:
        search_fn.close()
    partition_part(d, m, k, args.part_n, dev, out)
    return out


if __name__ == "__main__":
    main()
