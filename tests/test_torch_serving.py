"""The port's serving layer against the JAX package's: the micro-batching
``SearchServer`` and ``make_fused_search_fn`` over both tiers.

``make_fused_search_fn`` is held against the reference's on the same
reference-written checkpoint (the disk tier, its path handed to both) and
on the same index carried across with ``index_from_arrays`` (the RAM
tier): ids exact, scores rtol 1e-5, the engines' deterministic counters
exact, through pruning, widening, the delta tier, the device cache,
termination and sub-partition routing.  The server's cases are the
reference's (shard health, the drain deadline, the end-to-end loop) plus
the padding of tail batches and the refresh between batches.  Over the
sharded ring (``cache_shards > 1``) the function serves the reference's
results; the ring's own cases are in ``test_torch_sharded.py``.
"""

import queue
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import partitions as jpart
from repro.core import serving as jsrv
from repro.core import storage as js
from repro_torch.core import filters as tf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import search as tsearch
from repro_torch.core import serving as tsrv
from repro_torch.core.disk import DiskIVFIndex
from repro_torch.core.storage import GenerationMismatchError

N, D, M, KC = 1536, 32, 6, 12
TS_RANGE = 6000
K, NP, QB = 10, 4, 8

# Engine counters that depend only on the traffic (not on timing)
COUNTERS = ("engine.batches", "engine.tiles_scanned", "engine.blocks_fetched",
            "engine.blocks_reused", "engine.probes_terminated",
            "engine.term_segments_skipped", "engine.partition_hits",
            "engine.partition_fallbacks", "engine.partition_rows_scanned",
            "engine.flat_rows_scanned", "engine.delta_folds",
            "engine.delta_skips", "engine.last_u_cap", "device_cache.hits",
            "device_cache.misses", "device_cache.puts", "delta.rows",
            "delta.tombstones", "partitions.subs")


def _topic_data():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.05 * rng.standard_normal((N, D)).astype(
        np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    band = TS_RANGE // KC
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    attrs[:, 0] = (topic * band + rng.integers(0, band, N)).astype(np.int16)
    return centers, core, attrs, topic


def _jax_index():
    """Lists of 128 rows in 256 slots: room for the delta tier's folds."""
    centers, core, attrs, topic = _topic_data()
    spec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jnp.float32)
    index, _ = jivf.build_from_assignments(
        spec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic), vpad=256, ids=jnp.arange(N))
    return index


def _carry(ji):
    arrays = {f: np.asarray(getattr(ji, f)) for f in (
        "centroids", "vectors", "attrs", "ids", "counts")}
    arrays.update({f: np.asarray(getattr(ji.summaries, f)) for f in (
        "amin", "amax", "hist", "edges_lo", "edges_hi")})
    spec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32)
    return tivf.index_from_arrays(arrays, spec, device="cpu")


def _batch(q, filt, seed=7):
    _, core, _, _ = _topic_data()
    qs = (core[5:5 + q] + 0.01).astype(np.float32)
    lo = np.full((q, 1, M), -32768, np.int16)
    hi = np.full((q, 1, M), 32767, np.int16)
    if filt == "window":
        start = np.random.default_rng(seed).integers(
            0, TS_RANGE - TS_RANGE // KC, q)
        lo[:, 0, 0], hi[:, 0, 0] = start, start + TS_RANGE // KC - 1
    return qs, lo, hi


def _call(jfn, tfn, qs, lo, hi):
    js_, ji_ = jfn(jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo),
                                                 hi=jnp.asarray(hi)), None)
    ts_, ti_ = tfn(torch.from_numpy(qs), tf.FilterSpec(
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi)), None)
    np.testing.assert_array_equal(np.asarray(ji_), ti_.numpy())
    np.testing.assert_allclose(np.asarray(js_), ts_.numpy(), rtol=1e-5)


def _same_counters(jfn, tfn):
    want, got = jfn.metrics(), tfn.metrics()
    assert set(got) == set(want)
    for key in COUNTERS:
        assert (key in want) == (key in got), key
        if key in want:
            assert got[key] == want[key], key


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    ji = _jax_index()
    ckpt = str(tmp_path_factory.mktemp("serve") / "ck")
    js.save_index(ji, ckpt, n_shards=2)
    part = str(tmp_path_factory.mktemp("serve") / "part")
    js.save_index(ji, part, n_shards=2, layout=4,
                  partitions=jpart.build_partitions(ji, attrs=[1]))
    v2 = str(tmp_path_factory.mktemp("serve") / "v2")
    js.save_index(ji, v2, n_shards=2, layout=2)
    return ji, ckpt, part, v2


# ---- make_fused_search_fn against the reference's ----


RAM_KNOBS = {
    "default": {},
    "prune_off": dict(prune="off"),
    "t_max": dict(t_max=8),
    "exact": dict(termination="exact"),
}


@pytest.mark.parametrize("knobs", sorted(RAM_KNOBS))
def test_ram_fn_matches_reference(built, knobs):
    ji = built[0]
    kw = dict(k=K, n_probes=NP, q_block=QB, **RAM_KNOBS[knobs])
    jfn = jsrv.make_fused_search_fn(ji, **kw)
    tfn = tsrv.make_fused_search_fn(_carry(ji), device="cpu", **kw)
    try:
        for filt in ("none", "window"):
            _call(jfn, tfn, *_batch(16, filt))
        _same_counters(jfn, tfn)
        assert tfn.index.vectors.device.type == "cpu"
        assert tfn.delta is None and tfn.device_cache is None
    finally:
        jfn.close()
        tfn.close()


DISK_KNOBS = {
    "sync": dict(pipeline="off"),
    "pipelined": dict(pipeline="on"),
    "device_cache": dict(device_cache_mb=8, pipeline="off"),
    "exact": dict(termination="exact", pipeline="off"),
    "t_max_auto": dict(t_max="auto"),
    "budget": dict(resident_budget_bytes=200_000),
}


@pytest.mark.parametrize("knobs", sorted(DISK_KNOBS))
def test_disk_fn_matches_reference(built, knobs):
    _, ckpt, _, _ = built
    kw = dict(k=K, n_probes=NP, q_block=QB, **DISK_KNOBS[knobs])
    jfn = jsrv.make_fused_search_fn(ckpt, **kw)
    tfn = tsrv.make_fused_search_fn(ckpt, device="cpu", **kw)
    try:
        assert isinstance(tfn.index, DiskIVFIndex)
        for filt in ("none", "window", "none"):
            _call(jfn, tfn, *_batch(16, filt))
        _same_counters(jfn, tfn)
        if "device_cache_mb" in kw:
            assert tfn.device_cache.stats()["hits"] > 0
            assert tfn.index.device_cache is tfn.device_cache
            assert "repro_device_cache_hits" in tfn.metrics_text()
    finally:
        jfn.close()
        tfn.close()


@pytest.mark.parametrize("routing", ["auto", "off"])
def test_partitioned_fn_matches_reference(built, routing):
    _, _, part, _ = built
    kw = dict(k=K, n_probes=NP, q_block=QB, partitions=routing)
    jfn = jsrv.make_fused_search_fn(part, **kw)
    tfn = tsrv.make_fused_search_fn(part, device="cpu", **kw)
    qs, lo, hi = _batch(16, "none")
    lo[:, 0, 1] = hi[:, 0, 1] = 3  # attr1 == 3: routes to a sub-partition
    try:
        _call(jfn, tfn, qs, lo, hi)
        _same_counters(jfn, tfn)
        hits = tfn.metrics()["engine.partition_hits"]
        assert (hits > 0) == (routing == "auto")
    finally:
        jfn.close()
        tfn.close()


def test_delta_fn_matches_reference(built, tmp_path):
    """delta_budget_mb: the same adds and tombstones through both tiers'
    search_fn.delta, then a republish adopted through refresh()."""
    ji = built[0]
    jck, tck = str(tmp_path / "j"), str(tmp_path / "t")
    js.save_index(ji, jck, n_shards=2)
    js.save_index(ji, tck, n_shards=2)
    kw = dict(k=K, n_probes=NP, q_block=QB, delta_budget_mb=1.0)
    jfn = jsrv.make_fused_search_fn(jck, **kw)
    tfn = tsrv.make_fused_search_fn(tck, device="cpu", **kw)
    try:
        assert tfn.index.delta is tfn.delta
        rng = np.random.default_rng(4)
        _, core, _, topic = _topic_data()
        add = (core[rng.integers(0, N, 24)] + 0.02 * rng.standard_normal(
            (24, D))).astype(np.float32)
        add /= np.linalg.norm(add, axis=-1, keepdims=True)
        add_attrs = rng.integers(0, TS_RANGE, (24, M)).astype(np.int16)
        new_ids = np.arange(N, N + 24)
        dead = rng.choice(N, 16, replace=False)
        for fn in (jfn, tfn):
            fn.delta.add(add, add_attrs, new_ids)
            fn.delta.tombstone(dead, clusters=topic[dead])
            fn.delta.tombstone(new_ids[:3])
        for filt in ("none", "window"):
            _call(jfn, tfn, *_batch(16, filt))
        _same_counters(jfn, tfn)
        jdelta.compact_deltas(jck, jfn.delta)
        from repro_torch.core.delta import compact_deltas

        compact_deltas(tck, tfn.delta)
        assert jfn.refresh() and tfn.refresh()
        _call(jfn, tfn, *_batch(16, "none"))
        assert tfn.delta.stats()["commits"] == jfn.delta.stats()["commits"]
    finally:
        jfn.close()
        tfn.close()


def test_fn_checks_in_reference_order(built):
    ji, ckpt, _, v2 = built
    ram = _carry(ji)
    kw = dict(k=K, n_probes=NP, device="cpu")
    with pytest.raises(ValueError, match="delta_budget_mb"):
        tsrv.make_fused_search_fn(ram, delta_budget_mb=1.0, **kw)
    with pytest.raises(GenerationMismatchError):
        tsrv.make_fused_search_fn(v2, delta_budget_mb=1.0, **kw)
    with DiskIVFIndex.open(v2, device="cpu") as disk:
        with pytest.raises(GenerationMismatchError):
            tsrv.make_fused_search_fn(disk, delta_budget_mb=1.0, **kw)
    with pytest.raises(ValueError, match="cache_shards"):
        tsrv.make_fused_search_fn(ram, cache_shards=2, **kw)
    # over a checkpoint the sharded ring serves the reference's results
    for extra in ({}, dict(termination="exact")):
        tfn = tsrv.make_fused_search_fn(ckpt, cache_shards=2, **extra, **kw)
        jfn = jsrv.make_fused_search_fn(ckpt, k=K, n_probes=NP,
                                        cache_shards=2, **extra)
        try:
            _call(jfn, tfn, *_batch(16, "window"))
            _same_counters(jfn, tfn)
            assert tfn.blockstore.stats()["kind"] == "sharded"
        finally:
            tfn.close()
            jfn.close()
    with pytest.raises(ValueError, match="device_cache_mb"):
        tsrv.make_fused_search_fn(ram, device_cache_mb=8, **kw)
    with pytest.raises(NotImplementedError, match="backend"):
        tsrv.make_fused_search_fn(ram, backend="xla", **kw)


def test_disk_fn_equals_ram_fn(built):
    """The reference's test_serving_fn_disk_tier, on the port: a checkpoint
    path serves the disk tier with the RAM tier's results."""
    ji, ckpt, _, _ = built
    ram_fn = tsrv.make_fused_search_fn(_carry(ji), k=5, n_probes=4,
                                       q_block=8, device="cpu")
    disk_fn = tsrv.make_fused_search_fn(ckpt, k=5, n_probes=4, q_block=8,
                                        device="cpu")
    try:
        q = torch.from_numpy(_topic_data()[1][:8])
        fs = tf.match_all(8, M, device="cpu")
        rs, ri = ram_fn(q, fs, None)
        ds, di = disk_fn(q, fs, None)
        assert torch.equal(ri, di)
        np.testing.assert_allclose(rs.numpy(), ds.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert disk_fn.index.resident_bytes() > 0
    finally:
        ram_fn.close()
        disk_fn.close()


# ---- SearchServer ----


def test_shard_health_probation():
    h = tsrv.ShardHealth(4, threshold=0.15, decay=0.5)
    assert h.ok_mask().all()
    h.report(2, failed=True)
    h.report(2, failed=True)
    assert not h.ok_mask()[2] and h.ok_mask()[[0, 1, 3]].all()
    assert h.degraded
    for _ in range(6):
        h.report(2, failed=False)
    assert h.ok_mask().all() and not h.degraded  # probation ends


def test_serving_loop_end_to_end():
    """The reference's test_serving_loop_end_to_end on a port index built
    by build_ivf: every database row finds itself first."""
    rng = np.random.default_rng(0)
    n, d, m = 600, 12, 3
    core = rng.standard_normal((n, d)).astype(np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    attrs = rng.integers(0, 5, (n, m)).astype(np.int16)
    spec = thy.HybridSpec(dim=d, n_attrs=m, core_dtype=torch.float32)
    index, _ = tivf.build_ivf(torch.Generator().manual_seed(0), spec, core,
                              attrs, n_clusters=6, kmeans_mode="lloyd",
                              kmeans_steps=4, device="cpu")

    def search_fn(queries, fspec, shard_ok):
        del shard_ok
        res = tsearch.search_reference(index, queries, fspec, k=5,
                                       n_probes=4)
        return res.scores, res.ids

    server = tsrv.SearchServer(search_fn, batch_size=8, dim=d, n_attrs=m,
                               n_terms=1, n_shards=4, max_wait_s=0.01,
                               device="cpu")
    server.start()
    try:
        futs = [server.submit(core[i]) for i in range(20)]
        resps = [f.get(timeout=60) for f in futs]
    finally:
        server.stop()
    for i, r in enumerate(resps):
        assert r.ids.shape == (5,) and r.ids[0] == i and not r.degraded
    assert server.stats["requests"] == 20
    assert server.stats["batches"] >= 3


def test_server_pads_tail_and_matches_fn(built):
    """20 requests queued before the server starts: batches of 8, 8 and a
    tail of 4 padded to 8; each response equals the wrapped function's row,
    filters included."""
    ji = built[0]
    fn = tsrv.make_fused_search_fn(_carry(ji), k=K, n_probes=NP, q_block=QB,
                                   device="cpu")
    shapes = []

    def recording(queries, fspec, shard_ok):
        shapes.append((tuple(queries.shape), tuple(fspec.lo.shape),
                       tuple(shard_ok.shape)))
        return fn(queries, fspec, shard_ok)

    qs, lo, hi = _batch(20, "window")
    want_s, want_i = fn(torch.from_numpy(qs), tf.FilterSpec(
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi)))
    server = tsrv.SearchServer(recording, batch_size=8, dim=D, n_attrs=M,
                               n_terms=1, n_shards=3, max_wait_s=0.05,
                               device="cpu")
    futs = [server.submit(qs[i], (lo[i], hi[i])) for i in range(20)]
    server.start()
    try:
        resps = [f.get(timeout=60) for f in futs]
    finally:
        server.stop()
        fn.close()
    assert shapes == [((8, D), (8, 1, M), (3,))] * 3
    assert [r.batched_with for r in resps] == [8] * 16 + [4] * 4
    for i, r in enumerate(resps):
        np.testing.assert_array_equal(r.ids, want_i[i].numpy())
        np.testing.assert_allclose(r.scores, want_s[i].numpy(), rtol=1e-5)
        assert r.latency_s > 0
    assert server.stats == dict(batches=3, requests=20, degraded_batches=0,
                                total_latency_s=server.stats[
                                    "total_latency_s"], refreshes=0)


def test_server_refresh_between_batches():
    """A refresh asked for while a batch is in flight is taken after that
    batch and before the next, once."""
    events = []
    entered, release = threading.Event(), threading.Event()

    def search_fn(queries, fspec, shard_ok):
        events.append("search")
        entered.set()
        release.wait(10)
        q = queries.shape[0]
        return torch.zeros((q, 2)), torch.zeros((q, 2), dtype=torch.int32)

    search_fn.refresh = lambda: events.append("refresh")
    server = tsrv.SearchServer(search_fn, batch_size=4, dim=3, n_attrs=2,
                               n_terms=1, n_shards=1, max_wait_s=0.01,
                               device="cpu")
    server.start()
    try:
        fut = server.submit(np.zeros(3, np.float32))
        assert entered.wait(10)
        server.request_refresh()  # mid-batch
        release.set()
        fut.get(timeout=10)
        server.search_blocking(np.zeros(3, np.float32), timeout=10)
    finally:
        server.stop()
    assert events == ["search", "refresh", "search"]
    assert server.stats["refreshes"] == 1
    # a search_fn without refresh: the request is a no-op
    plain = tsrv.SearchServer(lambda *a: None, batch_size=4, dim=3,
                              n_attrs=2, n_terms=1, n_shards=1, device="cpu")
    plain.request_refresh()
    plain._maybe_refresh()
    assert plain.stats["refreshes"] == 0


def _mk_request(t_enqueue):
    fut = queue.Queue(maxsize=1)
    return tsrv.Request(np.zeros(4, np.float32), np.zeros((1, 2), np.int16),
                        np.zeros((1, 2), np.int16), fut, t_enqueue)


def _server(batch_size, max_wait_s):
    return tsrv.SearchServer(lambda *a: None, batch_size=batch_size, dim=4,
                             n_attrs=2, n_terms=1, n_shards=1,
                             max_wait_s=max_wait_s, device="cpu")


def test_drain_respects_deadline_under_trickle():
    """An aged request plus a slow trickle of arrivals must not stretch
    batch assembly: the deadline anchors at the oldest request."""
    server = _server(32, 0.2)
    server._q.put(_mk_request(time.monotonic() - 10.0))  # aged request
    stop = threading.Event()

    def trickle():
        while not stop.is_set():
            server._q.put(_mk_request(time.monotonic()))
            time.sleep(0.05)

    t = threading.Thread(target=trickle, daemon=True)
    t.start()
    try:
        t0 = time.monotonic()
        batch = server._drain()
        elapsed = time.monotonic() - t0
    finally:
        stop.set()
        t.join(timeout=2)
    assert not t.is_alive()
    assert batch, "drain returned nothing"
    assert elapsed < 0.1, f"drain blocked {elapsed:.3f}s past the deadline"


def test_drain_still_batches_fresh_requests():
    server = _server(8, 0.1)
    now = time.monotonic()
    for _ in range(3):
        server._q.put(_mk_request(now))
    t0 = time.monotonic()
    batch = server._drain()
    assert len(batch) == 3
    assert time.monotonic() - t0 <= 0.5


def test_drain_full_batch_returns_early():
    server = _server(4, 5.0)
    now = time.monotonic()
    for _ in range(4):
        server._q.put(_mk_request(now))
    t0 = time.monotonic()
    assert len(server._drain()) == 4
    assert time.monotonic() - t0 < 1.0  # never waited for the deadline


def test_server_needs_cuda_unless_cpu(built, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsrv.make_fused_search_fn(built[1], k=K, n_probes=NP)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsrv.SearchServer(lambda *a: None, batch_size=4, dim=4, n_attrs=2,
                          n_terms=1, n_shards=1)
