"""The port's disk tier and pipelined engine against the JAX package's, on
the same checkpoint.

One checkpoint per metric is written by the JAX package (the index built
from one numpy seed) and opened by both packages.  The port's
``DiskIVFIndex`` is held against the JAX ``DiskIVFIndex`` (``backend=
"xla"``) and against the port's RAM ``SearchEngine`` over the same index:
ids and the n_scanned / n_passed / n_pruned counters identical, scores
within rtol 1e-5 (f32 sums taken in another order).  Cache counters, fetch
lists, engine counters and the metrics key set are held exactly.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blockstore as jbs
from repro.core import disk as jdisk
from repro.core import engine as jeng
from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import probes as jp
from repro.core import storage as js
from repro_torch.core import blockstore as tbs
from repro_torch.core import delta as tdelta
from repro_torch.core import disk as tdisk
from repro_torch.core import engine as teng
from repro_torch.core import filters as tf
from repro_torch.core import probes as tp
from repro_torch.core import storage as ts

N, D, M, KC = 1536, 32, 6, 10


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = rng.integers(0, KC, N)
    core = centers[topic] + 0.3 * rng.standard_normal((N, D)).astype(np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    attrs = rng.integers(0, 10, (N, M)).astype(np.int16)
    attrs[:, 0] = topic * 10 + rng.integers(0, 10, N)  # banded by topic
    return centers, core, attrs, topic.astype(np.int32)


def _jax_index(metric, dtype=jnp.float32, quantized=False):
    centers, core, attrs, topic = _data()
    spec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=dtype, metric=metric)
    index, _ = jivf.build_from_assignments(
        spec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic))
    return jivf.quantize_index(index) if quantized else index


@pytest.fixture(scope="module", params=["dot", "l2"])
def built(request, tmp_path_factory):
    """(jax disk index, port disk index, port RAM index, checkpoint dir)."""
    ckpt = str(tmp_path_factory.mktemp(f"disk_{request.param}"))
    js.save_index(_jax_index(request.param), ckpt, n_shards=2)
    jd = jdisk.DiskIVFIndex.open(ckpt)
    td = tdisk.DiskIVFIndex.open(ckpt, device="cpu")
    yield jd, td, ts.load_index(ckpt, device="cpu"), ckpt
    jd.close()
    td.close()


def _queries(q, filt, seed=1):
    centers, _, _, _ = _data()
    rng = np.random.default_rng(seed)
    qs = (centers[rng.integers(0, KC, q)]
          + 0.3 * rng.standard_normal((q, D))).astype(np.float32)
    if filt == "selective":
        fs = jf.from_builders([jf.FilterBuilder(M).le(0, 35).ge(1, 2)
                               for _ in range(q)])
    else:
        fs = jf.match_all(q, M)
    lo, hi = np.array(fs.lo), np.array(fs.hi)
    return (jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo), hi=jnp.asarray(hi)),
            torch.from_numpy(qs),
            tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi)))


def _assert_same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy(),
                                  err_msg=msg)
    np.testing.assert_allclose(np.asarray(want.scores), got.scores.numpy(),
                               rtol=1e-5, err_msg=msg)
    for c in ("n_scanned", "n_passed", "n_pruned"):
        np.testing.assert_array_equal(np.asarray(getattr(want, c)),
                                      getattr(got, c).numpy(),
                                      err_msg=f"{msg} {c}")


EXECUTORS = {  # name: engine knobs
    "sync": dict(pipeline="off"),
    "pipelined": dict(pipeline="on", operand_cache="on"),
    "pipelined-no-operand-cache": dict(pipeline="on", operand_cache="off"),
}
STAT_FIELDS = ("batches", "pipelined_batches", "tiles_scanned",
               "blocks_fetched", "blocks_reused", "last_u_cap")


@pytest.mark.parametrize("executor", list(EXECUTORS))
@pytest.mark.parametrize("filt", ["match_all", "selective"])
@pytest.mark.parametrize("q", [5, 21, 32])
def test_disk_tier_matches_jax_disk_tier_and_ram_engine(built, q, filt,
                                                         executor):
    jd, td, ram, _ = built
    jq, jfs, tq, tfs = _queries(q, filt)
    kw = dict(k=10, n_probes=4, q_block=16, v_block=128, **EXECUTORS[executor])
    je = jeng.SearchEngine(jd, backend="xla", **kw)
    te = teng.SearchEngine(td, device="cpu", **kw)
    try:
        want = je.search(jq, jfs)
        got = te.search(tq, tfs)
    finally:
        je.close()
        te.close()
    _assert_same(want, got, f"{executor} vs the JAX disk tier")
    _assert_same(teng.SearchEngine(ram, device="cpu", k=10, n_probes=4,
                                   q_block=16).search(tq, tfs),
                 got, f"{executor} vs the RAM engine")
    for f in STAT_FIELDS:
        assert getattr(te.stats, f) == getattr(je.stats, f), f
    if filt == "selective":
        assert got.n_pruned.sum() > 0


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("variant", ["bf16", "sq8"])
def test_disk_tier_bf16_and_sq8(tmp_path, variant, pipeline):
    """bf16 records travel as raw 16-bit words; SQ8 records as int8 codes
    and f32 scales."""
    index = (_jax_index("dot", jnp.bfloat16) if variant == "bf16"
             else _jax_index("dot", quantized=True))
    js.save_index(index, str(tmp_path), n_shards=2)
    jq, jfs, tq, tfs = _queries(21, "selective", seed=2)
    kw = dict(k=8, n_probes=4, q_block=8, pipeline=pipeline)
    with jdisk.DiskIVFIndex.open(str(tmp_path)) as jd, \
            tdisk.DiskIVFIndex.open(str(tmp_path), device="cpu") as td:
        want = jd.search(jq, jfs, backend="xla", **kw)
        got = td.search(tq, tfs, **kw)
        assert td.store_dtype == (torch.bfloat16 if variant == "bf16"
                                  else torch.int8)
    _assert_same(want, got)
    ram = ts.load_index(str(tmp_path), device="cpu")
    _assert_same(teng.search_fused_tiled(ram, tq, tfs, k=8, n_probes=4,
                                         q_block=8, device="cpu"), got)


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_resident_blockstore_matches_reference(built, pipeline):
    jd, _, ram, ckpt = built
    jram = js.load_index(ckpt)
    jq, jfs, tq, tfs = _queries(40, "selective", seed=3)
    kw = dict(k=10, n_probes=4, q_block=16, pipeline=pipeline)
    jstore, tstore = jbs.ResidentBlockStore(jram), tbs.ResidentBlockStore(ram)
    je = jeng.SearchEngine(jram, backend="xla", blockstore=jstore, **kw)
    te = teng.SearchEngine(ram, device="cpu", blockstore=tstore, **kw)
    try:
        _assert_same(je.search(jq, jfs), te.search(tq, tfs))
    finally:
        je.close()
        te.close()
        jstore.close()
        tstore.close()
    assert tstore.stats() == jstore.stats()
    for f in STAT_FIELDS:
        assert getattr(te.stats, f) == getattr(je.stats, f), f


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_submit_result_across_batches(built, pipeline):
    """Batches started with submit() and finished with result(), two in
    flight at once, give the results of search()."""
    _, td, ram, _ = built
    batches = [_queries(q, f, seed=s)[2:] for q, f, s in
               ((32, "match_all", 4), (21, "selective", 5))]
    eng = teng.SearchEngine(td, device="cpu", k=10, n_probes=4, q_block=16,
                            pipeline=pipeline, pipeline_depth=2)
    try:
        pending = [eng.submit(q, f) for q, f in batches]
        got = [eng.result(p) for p in pending]
    finally:
        eng.close()
    ram_eng = teng.SearchEngine(ram, device="cpu", k=10, n_probes=4,
                                q_block=16)
    for (q, f), res in zip(batches, got):
        _assert_same(ram_eng.search(q, f), res)
    assert eng.stats.batches == 2
    assert eng.stats.pipelined_batches == (2 if pipeline == "on" else 0)


def test_legacy_gather_paths(built):
    """gather_fn=index.gather (with its gather_submit/gather_wait pair) and
    a plain gather_fn give the store path's results; the gathered blocks
    equal the reference's on every addressed row."""
    jd, td, ram, _ = built
    _, _, tq, tfs = _queries(32, "selective", seed=6)
    want = teng.SearchEngine(ram, device="cpu", k=10, n_probes=4,
                             q_block=16).search(tq, tfs)
    for fn in (td.gather, lambda sc: td.gather(sc)):
        for pipeline in ("off", "on"):
            eng = teng.SearchEngine(td, device="cpu", k=10, n_probes=4,
                                    q_block=16, gather_fn=fn,
                                    pipeline=pipeline)
            try:
                _assert_same(want, eng.search(tq, tfs), pipeline)
            finally:
                eng.close()
    sc = np.array([3, 3, 7, 1, 7, 0, 9, 9], np.int32)
    jb = jd.gather(sc)
    tb = td.gather_wait(td.gather_submit(sc))
    np.testing.assert_array_equal(np.asarray(jb[0]), tb[0].numpy())
    u = int(tb[0].max()) + 1  # the port keeps one row per distinct cluster
    for j, t in zip(jb[1:], tb[1:]):
        assert (j is None) == (t is None)
        if t is not None:
            np.testing.assert_array_equal(np.asarray(j)[:u], t.numpy())
            assert t.shape[0] == u


def test_dead_record_matches_reference(built):
    jd, td, _, _ = built
    want = jbs.dead_record(jbs.BlockSpec.from_index(jd))
    got = tbs.dead_record(tbs.BlockSpec.from_index(td))
    assert set(want) == set(got)
    for f in want:
        np.testing.assert_array_equal(np.asarray(want[f]), got[f].numpy(),
                                      err_msg=f)
        assert np.asarray(want[f]).dtype == got[f].numpy().dtype, f


def _budget(ckpt, records):
    man = js.load_manifest(ckpt)
    overhead = (KC * D * 4 + KC * 4 + js.load_summaries(ckpt, man).nbytes()
                + js.load_bounds(ckpt, man).nbytes())
    return overhead + records * man["record_stride"] + 100


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_cache_counters_and_budget_match_reference(built, pipeline):
    """One call sequence through a cache sized for 4 of 10 clusters with
    pin refreshes every 2 batches: the same hits, misses, evictions, pinned
    set and engine counters as the reference, exact results, and the
    resident set under budget throughout."""
    *_, ram, ckpt = built
    budget = _budget(ckpt, 4)
    kw = dict(resident_budget_bytes=budget, pin_refresh=2, pin_fraction=0.5)
    ekw = dict(k=8, n_probes=4, q_block=8, pipeline=pipeline)
    with jdisk.DiskIVFIndex.open(ckpt, **kw) as jd, \
            tdisk.DiskIVFIndex.open(ckpt, device="cpu", **kw) as td:
        assert td.cache.capacity_records == jd.cache.capacity_records == 4
        je = jeng.SearchEngine(jd, backend="xla", **ekw)
        te = teng.SearchEngine(td, device="cpu", **ekw)
        ram_eng = teng.SearchEngine(ram, device="cpu", k=8, n_probes=4,
                                    q_block=8)
        try:
            for rep in range(5):
                jq, jfs, tq, tfs = _queries(16, ("match_all", "selective")[
                    rep % 2], seed=10 + rep)
                want = je.search(jq, jfs)
                got = te.search(tq, tfs)
                _assert_same(want, got, f"batch {rep}")
                _assert_same(ram_eng.search(tq, tfs), got, f"batch {rep}")
                assert td.resident_bytes() <= budget
                assert td.resident_bytes() == jd.resident_bytes()
                assert vars(td.cache.stats) == vars(jd.cache.stats)
                assert td.cache.pinned == jd.cache.pinned
        finally:
            je.close()
            te.close()
        assert td.cache.stats.evictions > 0 and td.cache.pinned
        for f in STAT_FIELDS:
            assert getattr(te.stats, f) == getattr(je.stats, f), f
        assert te.blockstore.stats() == je.blockstore.stats()


def test_budget_too_small_and_v1_rejected(built, tmp_path):
    jd, _, ram, ckpt = built
    with pytest.raises(ValueError, match="resident_budget_bytes"):
        tdisk.DiskIVFIndex.open(ckpt, resident_budget_bytes=64, device="cpu")
    ts.save_index(ram, str(tmp_path), n_shards=2, layout=1)
    with pytest.raises(ValueError, match="layout-v2"):
        tdisk.DiskIVFIndex.open(str(tmp_path), device="cpu")


def test_shard_reader_records_match_reference(built):
    jd, td, _, _ = built
    for cid in range(KC):
        want, got = jd.reader.read(cid), td.reader.read(cid)
        assert set(want) == set(got)
        for f in want:
            np.testing.assert_array_equal(np.asarray(want[f]),
                                          got[f].numpy(), err_msg=f)


def test_prefetch_for_queries(built):
    """The prefetch plan pages exactly the clusters the search then needs,
    on the background thread, so the search misses nothing; with a widened
    plan (``t_max``) too, and the widened disk search equals the widened
    RAM engine and the JAX disk tier."""
    jd, _, ram, ckpt = built
    jq, jfs, tq, tfs = _queries(16, "selective", seed=7)
    with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as td:
        td.prefetch_for_queries(tq, 4, q_block=16, fspec=tfs)
        td.cache.drain()
        assert td.cache.stats.prefetched > 0
        before = td.cache.stats.misses
        got = td.search(tq, tfs, k=8, n_probes=4, q_block=16)
        assert td.cache.stats.misses == before
        _assert_same(teng.search_fused_tiled(ram, tq, tfs, k=8, n_probes=4,
                                             q_block=16, device="cpu"), got)
        td.prefetch_for_queries(tq, 4, q_block=16, fspec=tfs, t_max=8)
        td.cache.drain()
        before = td.cache.stats.misses
        got = td.search(tq, tfs, k=8, n_probes=4, q_block=16, t_max=8)
        assert td.cache.stats.misses == before
        _assert_same(teng.search_fused_tiled(ram, tq, tfs, k=8, n_probes=4,
                                             q_block=16, t_max=8,
                                             device="cpu"), got)
        _assert_same(jd.search(jq, jfs, k=8, n_probes=4, q_block=16,
                               t_max=8, backend="xla"), got)
        with pytest.raises(ValueError, match="t_max"):
            td.prefetch_for_queries(tq, 4, fspec=tfs, t_max=3)


def test_refresh_adopts_a_republished_checkpoint(tmp_path):
    """A republish with bumped generations: refresh() picks it up and the
    next fetch invalidates exactly the rewritten clusters, as in the
    reference; with a delta tier attached, refresh commits its pending
    freeze, as the reference's does."""
    index = _jax_index("dot")
    q = _queries(16, "match_all", seed=8)
    counts = {}
    for pkg, disk in (("jax", jdisk), ("port", tdisk)):
        d = str(tmp_path / pkg)
        js.save_index(index, d, n_shards=2)
        kw = {} if pkg == "jax" else dict(device="cpu")
        with disk.DiskIVFIndex.open(d, **kw) as di:
            qq, ff = q[:2] if pkg == "jax" else q[2:]
            ekw = dict(backend="xla") if pkg == "jax" else {}
            di.search(qq, ff, k=8, n_probes=4, q_block=16, **ekw)
            gens = np.zeros(KC, np.int64)
            gens[[1, 4]] = 1
            js.save_index(index, d, n_shards=2, gens=gens)
            assert di.refresh()
            assert not di.refresh()
            di.search(qq, ff, k=8, n_probes=4, q_block=16, **ekw)
            counts[pkg] = vars(di.cache.stats).copy()
            if pkg == "port":
                di.delta = tdelta.DeltaTier.for_index(di, 1)
                di.delta.freeze()
                assert di.delta.stats()["pending"]
                assert not di.refresh()
                assert not di.delta.stats()["pending"]
                assert di.delta.stats()["commits"] == 1
                di.delta = None
    assert counts["port"] == counts["jax"]
    assert counts["port"]["invalidations"] > 0


@pytest.mark.parametrize("u_cap", [4, 9, 40])
def test_fetch_lists_match_reference(u_cap):
    rng = np.random.default_rng(u_cap)
    probes = rng.integers(0, 30, (48, 5)).astype(np.int32)
    valid = rng.random((48, 5)) < 0.8
    sc, _, _, _, nu = jp.plan_probe_tiles(
        jnp.asarray(probes), q_block=16, u_cap=u_cap,
        probe_valid=jnp.asarray(valid))
    tsc, tnu = torch.from_numpy(np.array(sc)), torch.from_numpy(np.array(nu))
    np.testing.assert_array_equal(jp.fetch_order(sc, nu, u_cap),
                                  tp.fetch_order(tsc, tnu, u_cap))
    for fn in ("tile_fetch_lists", "tile_release_lists"):
        want = getattr(jp, fn)(sc, nu, u_cap)
        got = getattr(tp, fn)(tsc, tnu, u_cap)
        assert len(want) == len(got) == 3
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g, err_msg=fn)


# Reference metrics of features the port does not have yet: none.
UNPORTED_METRICS: set = set()


def test_metrics_key_set_matches_reference(built):
    jd, td, _, _ = built
    jq, jfs, tq, tfs = _queries(32, "selective", seed=9)
    kw = dict(k=10, n_probes=4, q_block=16, pipeline="on")
    je = jeng.SearchEngine(jd, backend="xla", **kw)
    te = teng.SearchEngine(td, device="cpu", **kw)
    try:
        je.search(jq, jfs)
        te.search(tq, tfs)
        want = set(je.metrics())
        got = te.metrics()
        assert set(got) == want - UNPORTED_METRICS
        for k in ("engine.blocks_fetched", "engine.blocks_reused",
                  "engine.tiles_scanned", "engine.pipelined_batches"):
            assert got[k] == je.metrics()[k], k
        assert 0.0 <= got["engine.overlap_ratio"] <= 1.0
        text = te.metrics_text()
        assert "repro_engine_blocks_fetched" in text
        for stage in ("plan", "fetch", "scan", "merge"):
            assert f'stage="{stage}"' in text
        json.dumps(got)  # scalar values only
    finally:
        je.close()
        te.close()
