"""Serving launcher: builds (or loads) a hybrid index on the card and serves
batched filtered queries through the micro-batching server; the port of
``repro.launch.serve``.

Two tiers:

  * ``--tier ram``  — the whole index lives in device memory.
  * ``--tier disk`` — only centroids, counts and summaries stay resident;
    flat lists page in from a checkpoint through the probe-driven cluster
    cache, capped by ``--resident-budget-mb`` (hot clusters are pinned).

    PYTHONPATH=src python -m repro_torch.launch.serve --n 100000 --requests 128
    PYTHONPATH=src python -m repro_torch.launch.serve --load <index_dir>
    PYTHONPATH=src python -m repro_torch.launch.serve --load <index_dir> \\
        --tier disk --resident-budget-mb 64
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --n 4000

``--tier disk --cache-shards N`` (N > 1) fetches through a sharded ring of
N peer caches over the checkpoint (``--cache-transport loopback|socket``,
``--cache-fallback``, ``--peer-timeout-s``, ``--peer-retries``,
``--probe-interval-s``).

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
CUDA is absent.
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch


def _sample_queries(disk_index, max_clusters: int = 4) -> np.ndarray:
    """Demo query pool from a few paged-in clusters — O(clusters) memory,
    never the whole index."""
    rows = []
    for cid in range(min(max_clusters, disk_index.n_clusters)):
        rec = disk_index.reader.read(cid)
        live = rec["ids"] >= 0
        v = rec["vectors"][live].float()
        if disk_index.quantized:
            v = v * rec["scales"][live][:, None]
        rows.append(v.numpy())
    return np.concatenate(rows, 0)


def _rows(pool, idx) -> np.ndarray:
    """Rows ``idx`` of the query pool as f32 numpy; the pool is a host
    array or a tensor on the card (a loaded index's padded lists, which
    numpy cannot hold as bf16)."""
    if isinstance(pool, torch.Tensor):
        sel = torch.as_tensor(np.asarray(idx), device=pool.device)
        return pool[sel].float().cpu().numpy()
    return np.asarray(pool[idx], np.float32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--n-attrs", type=int, default=6)
    ap.add_argument("--clusters", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--probes", type=int, default=7)
    ap.add_argument("--load", default=None, help="index dir to restore")
    ap.add_argument("--save", default=None, help="index dir to persist")
    ap.add_argument("--tier", choices=("ram", "disk"), default="ram",
                    help="disk = page clusters from the checkpoint on demand")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu "
                         "(every kernel's plain PyTorch version)")
    ap.add_argument("--resident-budget-mb", type=int, default=None,
                    help="disk tier: cap on resident bytes (centroids + "
                         "counts + summaries + cluster cache); default = "
                         "unbounded cache")
    ap.add_argument("--prune", choices=("auto", "on", "off"), default="auto",
                    help="filter-aware probe pruning from the resident "
                         "cluster attribute summaries; auto = prune when "
                         "the index carries summaries")
    ap.add_argument("--t-max", default=None,
                    help="adaptive probe widening cap: refill pruned probes "
                         "from next-best unpruned centroids up to this rank "
                         "(an int, or 'auto' to pick the per-batch cap from "
                         "the summaries' expected passing mass)")
    ap.add_argument("--pipeline", choices=("auto", "on", "off"),
                    default="auto",
                    help="double-buffered executor: scan tile i while tile "
                         "i+1's clusters gather in the background (auto = "
                         "on for the disk tier); identical results")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="cluster gathers kept in flight ahead of the scan")
    ap.add_argument("--cache-shards", type=int, default=1,
                    help="disk tier: shard the cluster cache over this many "
                         "peer stores (consistent-hash ring; 1 = local "
                         "cache only)")
    ap.add_argument("--cache-transport", choices=("loopback", "socket"),
                    default="loopback",
                    help="sharded-cache peer transport: in-process, or "
                         "the length-prefixed socket protocol behind a "
                         "local server per peer")
    ap.add_argument("--operand-cache", choices=("auto", "on", "off"),
                    default="auto",
                    help="per-batch operand reuse: fetch each cluster "
                         "block through the store once per batch and let "
                         "the batch's tiles share the records (auto = on "
                         "for store fetch)")
    ap.add_argument("--u-cap-ladder", choices=("pow2", "fine"),
                    default="pow2",
                    help="slot-table bucket ladder: fine adds x1.5 "
                         "midpoints")
    ap.add_argument("--cache-fallback", choices=("on", "off"), default="on",
                    help="sharded cache: serve an unhealthy peer's "
                         "clusters from the local copy (results unchanged; "
                         "off = peer errors fail the batch)")
    ap.add_argument("--peer-timeout-s", type=float, default=30.0,
                    help="sharded cache, socket transport: per-request "
                         "deadline")
    ap.add_argument("--peer-retries", type=int, default=1,
                    help="sharded cache, socket transport: reconnect "
                         "retries per fetch")
    ap.add_argument("--probe-interval-s", type=float, default=None,
                    help="sharded cache: active health-probe period "
                         "(seconds; default: passive detection only)")
    ap.add_argument("--delta-budget-mb", type=float, default=None,
                    help="disk tier, layout-v3 checkpoint: attach a delta "
                         "tier of this many MiB and run a live "
                         "add/tombstone/compact demo phase (new vectors "
                         "searchable the very next batch)")
    ap.add_argument("--compact-every", type=int, default=0,
                    help="delta tier: republish (compact_deltas + between-"
                         "batch refresh) every this many live updates "
                         "(0 = never republish during the demo)")
    ap.add_argument("--compact-rows", type=int, default=0,
                    help="delta tier: pressure-driven republish when the "
                         "delta holds at least this many rows (0 = off)")
    ap.add_argument("--compact-stale-frac", type=float, default=0.0,
                    help="delta tier: pressure-driven republish when "
                         "pending tombstones exceed this fraction of the "
                         "cold tier's live rows (0 = off)")
    ap.add_argument("--device-cache-mb", type=float, default=None,
                    help="disk tier: cross-batch device-resident block "
                         "cache of this many MiB, heat-weighted LRU keyed "
                         "on (cluster_id, gen)")
    ap.add_argument("--delta-quantize", choices=("auto", "on"),
                    default="auto",
                    help="delta tier: store delta rows SQ8-quantized even "
                         "over a float cold tier; auto = match the cold "
                         "tier")
    ap.add_argument("--termination", choices=("exact", "bounded"),
                    default=None,
                    help="bound-driven early termination: drop probes that "
                         "provably (exact, bit-identical) or probably "
                         "(bounded, recall >= 1-epsilon) cannot enter the "
                         "top-k")
    ap.add_argument("--epsilon", type=float, default=0.0,
                    help="bounded termination: per-query probability "
                         "budget for dropping a probe that might hold a "
                         "top-k hit (needs --termination bounded)")
    ap.add_argument("--partition-attrs", default=None,
                    help="build filter-specialized sub-partitions along "
                         "these attribute indices (comma-separated, or "
                         "'auto') and persist them as a layout-v4 "
                         "checkpoint on --save / the disk-tier "
                         "auto-checkpoint")
    ap.add_argument("--partition-max-depth", type=int, default=3,
                    help="sliding-window ladder depth for ordered "
                         "partition attributes")
    ap.add_argument("--partitions", choices=("auto", "on", "off"),
                    default="auto",
                    help="planner-side partition routing (auto = route "
                         "when the index carries a catalog; results are "
                         "bit-identical either way)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text exposition of the flat "
                         "engine metrics at http://127.0.0.1:PORT/metrics "
                         "(0 = any free port)")
    args = ap.parse_args(argv)
    if args.t_max is not None and args.t_max != "auto":
        args.t_max = int(args.t_max)
    return args


def _start_metrics(metrics_text, port: int):
    """A Prometheus text endpoint on 127.0.0.1:``port`` in a daemon
    thread; returns the server (``shutdown()`` stops it)."""
    import http.server
    import threading

    class _MetricsHandler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_error(404)
                return
            body = metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # keep the demo output clean
            pass

    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                            _MetricsHandler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def main(argv=None) -> dict:
    """Runs the launcher on ``argv`` (default: the command line).  Returns
    what it served: ``queries`` [R, D] f32, ``responses``, the server's
    ``stats``, ``qps``, ``wall_s``, the engine's ``metrics``, on the RAM
    tier the ``index``, with a delta tier its ``delta`` stats and, with
    ``--metrics-port``, the ``metrics_url``."""
    args = parse_args(argv)

    from repro_torch.core import HybridSpec, build_ivf, storage
    from repro_torch.core.disk import DiskIVFIndex
    from repro_torch.core.serving import SearchServer, make_fused_search_fn
    from repro_torch.data import synthetic_attributes, synthetic_embeddings
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)

    def _save_checkpoint(idx, directory, n_shards=4):
        """Persists the index; with --partition-attrs, additionally builds
        the filter-specialized sub-partition plane (storage layout v4)."""
        if args.partition_attrs is None:
            storage.save_index(idx, directory, n_shards=n_shards)
            return
        from repro_torch.core import partitions as partitions_lib

        p_attrs = (None if args.partition_attrs == "auto"
                   else [int(a) for a in args.partition_attrs.split(",")])
        build = partitions_lib.build_partitions(
            idx, attrs=p_attrs, max_depth=args.partition_max_depth)
        storage.save_index(idx, directory, n_shards=n_shards, layout=4,
                           partitions=build)
        print(f"partitioned checkpoint: {build.n_subs} sub-partitions, "
              f"{build.catalog.n_entries} catalog entries")

    index_dir = args.load
    index = None
    tmp_dir = None
    if args.load and args.tier == "disk":
        # Disk tier: never materialize the index — query vectors for the
        # demo traffic are sampled from a few paged-in clusters instead.
        pass
    elif args.load:
        index = storage.load_index(args.load, device=dev)
        # the padded lists as the query pool, pad rows included, sampled
        # on the card
        core = index.vectors.reshape(-1, index.spec.dim)
        print(f"restored index: K={index.n_clusters}, "
              f"{int(index.counts.sum())} vectors")
    else:
        core = synthetic_embeddings(0, args.n, args.dim)
        attrs = synthetic_attributes(0, args.n, args.n_attrs,
                                     cardinalities=[8])
        spec = HybridSpec(dim=args.dim, n_attrs=args.n_attrs,
                          core_dtype=torch.float32)
        gen = torch.Generator(dev).manual_seed(0)
        index, stats = build_ivf(gen, spec, core, attrs,
                                 n_clusters=args.clusters, kmeans_steps=40,
                                 device=dev)
        print(f"built index: K={index.n_clusters}, "
              f"mean list {stats.mean_list_len:.0f}")
        if args.save:
            _save_checkpoint(index, args.save)
            print(f"persisted to {args.save}")
            index_dir = args.save

    if args.tier == "disk":
        if index_dir is None:  # disk tier needs a checkpoint to page from
            index_dir = tmp_dir = tempfile.mkdtemp(prefix="ivf_disk_")
            _save_checkpoint(index, index_dir)
            print(f"wrote disk-tier checkpoint to {index_dir}")
        budget = (args.resident_budget_mb * 1024 * 1024
                  if args.resident_budget_mb else None)
        serving_index = DiskIVFIndex.open(
            index_dir, resident_budget_bytes=budget, device=dev)
        print(f"disk tier: K={serving_index.n_clusters}, record stride "
              f"{serving_index.reader.stride} B, budget "
              f"{budget or 'unbounded'}")
        if index is None:  # --load: sample demo queries from a few clusters
            core = _sample_queries(serving_index)
    else:
        serving_index = index

    if args.cache_shards > 1 and args.tier != "disk":
        raise SystemExit("--cache-shards needs --tier disk")
    if args.delta_budget_mb is not None and args.tier != "disk":
        raise SystemExit("--delta-budget-mb needs --tier disk (the RAM "
                         "tier mutates in place via core.update)")
    if args.device_cache_mb is not None and args.tier != "disk":
        raise SystemExit("--device-cache-mb needs --tier disk (the RAM "
                         "tier is already device-resident)")
    search_fn = make_fused_search_fn(
        serving_index, k=args.k, n_probes=args.probes, q_block=args.batch,
        prune=args.prune, t_max=args.t_max, pipeline=args.pipeline,
        pipeline_depth=args.pipeline_depth,
        operand_cache=args.operand_cache, u_cap_ladder=args.u_cap_ladder,
        cache_shards=args.cache_shards,
        cache_transport=args.cache_transport,
        cache_fallback=args.cache_fallback == "on",
        peer_timeout_s=args.peer_timeout_s,
        peer_retries=args.peer_retries,
        probe_interval_s=args.probe_interval_s,
        delta_budget_mb=args.delta_budget_mb,
        delta_quantize=args.delta_quantize,
        device_cache_mb=args.device_cache_mb,
        termination=args.termination, epsilon=args.epsilon,
        partitions=args.partitions, device=dev,
    )
    out = {}
    metrics_httpd = None
    if args.metrics_port is not None:
        metrics_httpd = _start_metrics(search_fn.metrics_text,
                                       args.metrics_port)
        out["metrics_url"] = (f"http://127.0.0.1:"
                              f"{metrics_httpd.server_address[1]}/metrics")
        print(f"metrics: {out['metrics_url']}")

    if search_fn.blockstore is not None and args.cache_shards > 1:
        bs = search_fn.blockstore
        print(f"sharded cluster cache: {args.cache_shards} nodes "
              f"({args.cache_transport} transport), ring "
              f"{bs.ownership.__class__.__name__}")

    server = SearchServer(
        search_fn, batch_size=args.batch, dim=serving_index.spec.dim,
        n_attrs=serving_index.spec.n_attrs, n_terms=1, n_shards=8,
        device=dev,
    )
    server.start()
    try:
        rng = np.random.default_rng(1)
        # one draw per request, as the reference draws them
        idx = [int(rng.integers(0, len(core))) for _ in range(args.requests)]
        queries = _rows(core, idx)
        t0 = time.time()
        futs = [server.submit(q) for q in queries]
        resps = [f.get(timeout=120) for f in futs]
        wall = time.time() - t0
        lat = np.asarray([r.latency_s for r in resps]) * 1e3
        qps = args.requests / wall
        print(f"{args.requests} requests in {wall:.2f}s "
              f"({qps:.0f} QPS), p50 {np.percentile(lat, 50):.1f}ms "
              f"p99 {np.percentile(lat, 99):.1f}ms, "
              f"batches {server.stats['batches']}")
        out.update(queries=queries, responses=resps, qps=qps,
                   wall_s=wall, stats=dict(server.stats))

        if args.delta_budget_mb is not None:
            # Live-update phase: each step adds a vector (searchable the
            # very next batch), every 4th step tombstones a recent add, and
            # every --compact-every steps the delta folds into the cold
            # tier and the serving loop flips generation between batches.
            from repro_torch.core.delta import (compact_deltas,
                                                republish_pressure)

            tier = search_fn.delta
            rng2 = np.random.default_rng(2)
            base = 1_000_000_000  # demo id space, clear of checkpoint ids
            steps = min(args.requests, 64)
            dim, m = serving_index.spec.dim, serving_index.spec.n_attrs
            for step in range(steps):
                v = _rows(core, int(rng2.integers(0, len(core))))
                v = v + 0.01 * rng2.standard_normal(dim).astype(np.float32)
                a = rng2.integers(0, 8, (1, m)).astype(np.int16)
                tier.add(v[None], a, np.asarray([base + step]))
                if step % 4 == 3:
                    tier.tombstone(np.asarray([base + step - 2]))
                trigger = None
                if args.compact_every and (step + 1) % args.compact_every == 0:
                    trigger = "manual"
                if trigger is None:
                    trigger = republish_pressure(
                        tier,
                        rows_watermark=args.compact_rows or None,
                        stale_frac=args.compact_stale_frac or None,
                        n_live=int(serving_index.man["n_live"]),
                    )
                if trigger is not None:
                    st = compact_deltas(index_dir, tier, trigger=trigger)
                    server.request_refresh()
                    print(f"republished ({st.trigger}): "
                          f"{st.clusters_rewritten} clusters "
                          f"(gen {st.gen_max}), folded {st.rows_folded} "
                          f"rows, reclaimed {st.rows_reclaimed}")
                server.search_blocking(v)  # drains any pending refresh first
            tst = tier.stats()
            print(f"live updates: {steps} adds, {tst['tombstoned']} "
                  f"tombstones, {tst['commits']} republish commits, "
                  f"{tst['live_rows']} rows still in RAM delta")
            out["delta"] = tst
    finally:
        server.stop()
        if metrics_httpd is not None:
            metrics_httpd.shutdown()
            metrics_httpd.server_close()
    # one flat metrics surface (engine / store / cache / delta under
    # dotted keys)
    out["metrics"] = search_fn.engine.metrics()
    for key, val in sorted(out["metrics"].items()):
        print(f"  {key} = {val}")
    if args.tier == "disk":
        on_disk = serving_index.reader.stride * serving_index.n_clusters
        print(f"resident {serving_index.resident_bytes() / 2**20:.1f} MiB "
              f"(index on disk {on_disk / 2**20:.1f} MiB)")
        search_fn.close()
        serving_index.close()
        if tmp_dir is not None:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    else:
        search_fn.close()
        out["index"] = serving_index
    return out


if __name__ == "__main__":
    main()
