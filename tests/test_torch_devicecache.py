"""The port's cross-batch device block cache against the JAX package's, on
the same checkpoint.

With a ``DeviceBlockCache`` the port's disk tier must return its own
cache-free sync results bit for bit (ids, scores, ``n_scanned``,
``n_passed``), cold and warm, and the reference's with ids and counters
exact and scores within rtol 1e-5.  The cache's counters (hits, misses,
puts, evictions, invalidations, tile hits) match the reference's on the
same traffic.  The unit cases are the reference's: the byte budget,
eviction by heat, a budget below one entry, stale generations, precise
invalidation, the pure-peek ``filter_missing`` and the tile memo.  The
sharded store's case is in ``test_torch_sharded.py``; the serving
function's cases are in ``test_torch_serving.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import blockstore as jbs
from repro.core import delta as jdelta
from repro.core import devicecache as jdc
from repro.core import disk as jdisk
from repro.core import engine as jeng
from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import storage as js
from repro_torch.core import blockstore as tbs
from repro_torch.core import delta as tdelta
from repro_torch.core import devicecache as tdc
from repro_torch.core import disk as tdisk
from repro_torch.core import engine as teng
from repro_torch.core import filters as tf

N, D, M, KC = 1536, 32, 6, 12
TS_RANGE = 6000
K, NP, QB = 10, 4, 8
BUDGET = 64 * 2**20


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


def _jax_index(vpad_headroom=0, quantized=False):
    centers, core, attrs, topic = _topic_data()
    spec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jnp.float32,
                          metric="dot")
    vpad = (int(np.bincount(topic, minlength=KC).max()) + vpad_headroom
            if vpad_headroom else None)
    index, _ = jivf.build_from_assignments(
        spec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic), vpad=vpad, ids=jnp.arange(N))
    return jivf.quantize_index(index) if quantized else index


def _batch(q, filt, offset=5):
    _, core, _, _ = _topic_data()
    qs = core[offset:offset + q] + 0.01
    lo = np.full((q, 1, M), -32768, np.int16)
    hi = np.full((q, 1, M), 32767, np.int16)
    if filt == "window":
        start = np.random.default_rng(7).integers(
            0, TS_RANGE - TS_RANGE // KC, q)
        lo[:, 0, 0], hi[:, 0, 0] = start, start + TS_RANGE // KC - 1
    elif filt == "band":  # below every checkpoint timestamp band but one
        lo[:, 0, 0], hi[:, 0, 0] = 100, 900
    return qs.astype(np.float32), lo, hi


def _jq(qs, lo, hi):
    return jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo),
                                          hi=jnp.asarray(hi))


def _tq(qs, lo, hi):
    return torch.from_numpy(qs), tf.FilterSpec(lo=torch.from_numpy(lo),
                                               hi=torch.from_numpy(hi))


def _assert_identical(a, b, msg=""):
    for f in ("ids", "scores", "n_scanned", "n_passed"):
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(),
                                      err_msg=f"{msg} {f}")


def _assert_same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy(),
                                  err_msg=msg)
    np.testing.assert_allclose(np.asarray(want.scores), got.scores.numpy(),
                               rtol=1e-5, err_msg=msg)
    for c in ("n_scanned", "n_passed", "n_pruned"):
        np.testing.assert_array_equal(np.asarray(getattr(want, c)),
                                      getattr(got, c).numpy(), err_msg=c)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("devcache"))
    js.save_index(_jax_index(), ckpt, n_shards=2)
    return ckpt


# ---- parity ----


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("prune", ["off", "on"])
def test_device_cache_parity_matrix(built, prune, pipeline):
    """Cold and warm passes equal the cache-free sync search, and the
    reference's device-cache engine: results, engine and cache counters."""
    q = 21  # ragged multi-tile at q_block=8
    kw = dict(k=K, n_probes=NP, q_block=QB, prune=prune, pipeline=pipeline)
    with tdisk.DiskIVFIndex.open(built, device="cpu") as td, \
            jdisk.DiskIVFIndex.open(built) as jd:
        te = teng.SearchEngine(td, device="cpu", device_cache=BUDGET, **kw)
        je = jeng.SearchEngine(jd, backend="xla", device_cache=BUDGET, **kw)
        for filt in ("match_all", "window"):
            batch = _batch(q, filt)
            sync = teng.SearchEngine(td, device="cpu", gather_fn=td.gather,
                                     **dict(kw, pipeline="off"))
            want = sync.search(*_tq(*batch))
            for tag in ("cold", "warm"):
                got = te.search(*_tq(*batch))
                _assert_identical(want, got, f"{tag} {filt}")
                _assert_same(je.search(*_jq(*batch)), got, f"{tag} vs ref")
        st = te.device_cache.stats()
        assert st == je.device_cache.stats()
        assert st["hits"] > 0 and st["puts"] == st["misses"]
        for c in ("blocks_fetched", "blocks_reused", "tiles_scanned"):
            assert getattr(te.stats, c) == getattr(je.stats, c), c
        te.close()
        je.close()


def test_device_cache_sq8_parity(tmp_path):
    ckpt = str(tmp_path / "sq8")
    js.save_index(_jax_index(quantized=True), ckpt, n_shards=2)
    batch = _batch(21, "match_all", offset=0)
    kw = dict(k=K, n_probes=NP, q_block=QB)
    with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as td, \
            jdisk.DiskIVFIndex.open(ckpt) as jd:
        want = teng.SearchEngine(td, device="cpu", **kw).search(*_tq(*batch))
        te = teng.SearchEngine(td, device="cpu", pipeline="on",
                               device_cache=BUDGET, **kw)
        je = jeng.SearchEngine(jd, backend="xla", pipeline="on",
                               device_cache=BUDGET, **kw)
        for tag in ("cold", "warm"):
            got = te.search(*_tq(*batch))
            _assert_identical(want, got, tag)
            _assert_same(je.search(*_jq(*batch)), got, tag)
        assert te.device_cache.stats() == je.device_cache.stats()
        assert te.device_cache.stats()["hits"] > 0


def test_gap_refetch_counts_distinct_blocks(built):
    """A cache of two entries churns within a batch, so later tiles re-pull
    blocks an earlier tile fetched; ``blocks_fetched`` still counts each
    distinct block once, and the results stay the same."""
    batch = _batch(21, "match_all")
    kw = dict(k=K, n_probes=NP, q_block=QB)
    with tdisk.DiskIVFIndex.open(built, device="cpu") as td:
        ref = teng.SearchEngine(td, device="cpu", pipeline="off", **kw)
        r0 = ref.search(*_tq(*batch))
        spec = tbs.BlockSpec.from_index(td)
        tiny = 2 * tdc.record_nbytes(spec)
        eng = teng.SearchEngine(td, device="cpu", pipeline="on",
                                device_cache=tiny, **kw)
        assert eng.device_cache.capacity_records == 2
        _assert_identical(r0, eng.search(*_tq(*batch)), "tiny cache")
        assert eng.device_cache.stats()["evictions"] > 0
        assert eng.stats.blocks_fetched == ref.stats.blocks_fetched
        with jdisk.DiskIVFIndex.open(built) as jd:
            je = jeng.SearchEngine(jd, backend="xla", pipeline="on",
                                   device_cache=tiny, **kw)
            je.search(*_jq(*batch))
            assert je.device_cache.stats() == eng.device_cache.stats()
            assert je.stats.blocks_fetched == eng.stats.blocks_fetched


@pytest.mark.parametrize("value", [8 * 2**20, True, "instance"])
def test_device_cache_requires_store(value):
    """On a RAM index every form of the knob raises as the reference's."""
    ji = _jax_index()
    from repro_torch.core import ivf as tivf
    from repro_torch.core.hybrid import HybridSpec

    centers, core, attrs, topic = _topic_data()
    ti, _ = tivf.build_from_assignments(
        HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32), centers,
        core, attrs, topic, device="cpu")
    tv = (tdc.DeviceBlockCache(_mini_spec(), 1024, device="cpu")
          if value == "instance" else value)
    jv = jdc.DeviceBlockCache(_jmini_spec(), 1024) if value == "instance" \
        else value
    with pytest.raises(ValueError, match="device_cache"):
        teng.SearchEngine(ti, k=K, n_probes=NP, device="cpu", device_cache=tv)
    with pytest.raises(ValueError, match="device_cache"):
        jeng.SearchEngine(ji, k=K, n_probes=NP, device_cache=jv)


# ---- the cache itself ----


def _mini_spec():
    return tbs.BlockSpec(vpad=8, dim=4, n_attrs=2, has_norms=False,
                         quantized=False, store_dtype=torch.float32)


def _jmini_spec():
    return jbs.BlockSpec(vpad=8, dim=4, n_attrs=2, has_norms=False,
                         quantized=False, store_dtype=np.dtype(np.float32))


def _mini_rec(cid, gen=0, rows=8):
    rng = np.random.default_rng(cid)
    return {
        "vectors": torch.from_numpy(
            rng.standard_normal((rows, 4)).astype(np.float32)),
        "attrs": torch.from_numpy(
            rng.integers(0, 9, (rows, 2)).astype(np.int16)),
        "ids": torch.arange(rows, dtype=torch.int32) + cid * 100,
        "gen": torch.tensor([gen], dtype=torch.int32),
    }


def _cache(n_entries, heat=None, extra=0):
    spec = _mini_spec()
    return tdc.DeviceBlockCache(
        spec, n_entries * tdc.record_nbytes(spec) + extra, heat_fn=heat,
        device="cpu")


def test_record_nbytes_matches_reference():
    for has_norms, quantized in ((False, False), (True, False),
                                 (False, True)):
        t = tbs.BlockSpec(vpad=256, dim=64, n_attrs=5, has_norms=has_norms,
                          quantized=quantized,
                          store_dtype=torch.int8 if quantized
                          else torch.bfloat16)
        j = jbs.BlockSpec(vpad=256, dim=64, n_attrs=5, has_norms=has_norms,
                          quantized=quantized,
                          store_dtype=np.dtype(np.int8) if quantized
                          else np.dtype(jnp.bfloat16))
        assert tdc.record_nbytes(t) == jdc.record_nbytes(j)


def test_budget_enforced_and_eviction_by_heat():
    heat = {0: 50.0, 1: 1.0, 2: 40.0, 3: 2.0}
    cache = _cache(3, heat=lambda c: heat.get(c, 0.0))
    assert cache.capacity_records == 3
    cache.put_records({c: _mini_rec(c) for c in (0, 1, 2)})
    assert cache.stats()["entries"] == 3
    assert cache.resident_bytes <= cache.budget_bytes
    # a 4th entry evicts the coldest (1), not the LRU-oldest (0, heat 50)
    cache.put_records({3: _mini_rec(3)})
    st = cache.stats()
    assert st["entries"] == 3 and st["evictions"] == 1
    hits, missing = cache.get_many([0, 1, 2, 3])
    assert missing == [1] and set(hits) == {0, 2, 3}


def test_budget_below_one_entry_is_compose_only():
    cache = _cache(1, extra=-1)
    assert cache.capacity_records == 0
    out = cache.put_records({5: _mini_rec(5)})
    assert 5 in out
    assert cache.stats()["entries"] == 0 and cache.resident_bytes == 0


def test_entries_own_their_storage_and_pad_short_records():
    """Each entry owns its tensors (not a view of a batch buffer), and a
    short (sub-partition) record is padded to Vpad with the assembler's
    fill: zero vectors, ids -1."""
    cache = _cache(4)
    out = cache.put_records({1: _mini_rec(1, rows=3), 2: _mini_rec(2)})
    e1, e2 = out[1], out[2]
    assert e1.vectors.shape == (8, 4)
    assert e1.vectors.untyped_storage().data_ptr() != \
        e2.vectors.untyped_storage().data_ptr()
    assert e1.vectors.untyped_storage().nbytes() == 8 * 4 * 4
    assert (e1.ids[3:] == -1).all() and (e1.vectors[3:] == 0).all()
    np.testing.assert_array_equal(e1.ids[:3].numpy(), [100, 101, 102])
    flat = np.array([2, 1, 2], np.int32)
    uniq, local = tbs.first_need_unique(flat)
    host = tbs.assemble_blocks(flat, uniq, local,
                               {1: _mini_rec(1, rows=8), 2: _mini_rec(2)},
                               _mini_spec())
    composed = cache.compose([out[int(c)] for c in uniq])
    np.testing.assert_array_equal(composed[0][0].numpy(), host[1][0].numpy())
    assert composed[3] is None and composed[4] is None


def test_stale_generation_never_served():
    cache = _cache(8)
    cache.put_records({7: _mini_rec(7, gen=1)})
    hits, missing = cache.get_many([7], gens=np.asarray([2]))
    assert hits == {} and missing == [7]
    assert cache.stats()["invalidations"] == 1
    cache.put_records({7: _mini_rec(7, gen=2)})
    cache.put_records({7: _mini_rec(7, gen=1)})  # never downgrades
    hits, _ = cache.get_many([7], gens=np.asarray([2]))
    assert hits[7].gen == 2


def test_invalidate_below_is_precise():
    cache = _cache(8)
    cache.put_records({c: _mini_rec(c) for c in (0, 1, 2)})
    gens = np.zeros(KC, np.int64)
    gens[1] = 3
    assert cache.invalidate_below(gens) == 1
    hits, missing = cache.get_many([0, 1, 2])
    assert missing == [1] and set(hits) == {0, 2}
    assert cache.clear() == 2


def test_filter_missing_is_pure_peek():
    cache = _cache(8)
    cache.put_records({0: _mini_rec(0)})
    before = cache.stats()
    np.testing.assert_array_equal(cache.filter_missing(np.asarray([0, 4, 9])),
                                  [4, 9])
    np.testing.assert_array_equal(
        cache.filter_missing(np.asarray([0, 4]), np.asarray([1, 0])), [0, 4])
    assert cache.stats() == before


def test_tile_memo_exact_repeat_and_budget_yield():
    nb = tdc.record_nbytes(_mini_spec())
    cache = _cache(8)
    ents = cache.put_records({c: _mini_rec(c, gen=1) for c in (0, 1)})
    blocks = cache.compose([ents[0], ents[1]])
    cache.put_tile([0, 1], 4, [ents[0], ents[1]], blocks)
    assert cache.stats()["tiles"] == 1
    assert cache.resident_bytes == 2 * nb + 4 * nb
    assert cache.get_tile([0, 1], 4, np.asarray([1, 1])) is blocks
    assert cache.stats()["hits"] == 2 and cache.stats()["tile_hits"] == 1
    assert cache.get_tile([0, 1], 5) is None
    assert cache.get_tile([1, 0], 4) is None
    assert cache.get_tile([0, 1], 4, np.asarray([2, 1])) is None
    st = cache.stats()
    assert st["tiles"] == 0 and st["invalidations"] == 1
    tight = _cache(2)
    e2 = tight.put_records({c: _mini_rec(c) for c in (0, 1)})
    tight.put_tile([0, 1], 2, [e2[0], e2[1]], tight.compose([e2[0], e2[1]]))
    assert tight.stats()["tiles"] == 0
    mid = _cache(4)
    e3 = mid.put_records({c: _mini_rec(c) for c in (0, 1)})
    mid.put_tile([0, 1], 2, [e3[0], e3[1]], mid.compose([e3[0], e3[1]]))
    assert mid.stats()["tiles"] == 1
    mid.put_records({2: _mini_rec(2), 3: _mini_rec(3)})
    st = mid.stats()
    assert st["entries"] == 4 and st["tiles"] == 0
    assert mid.resident_bytes <= mid.budget_bytes


# ---- the generation plane, end to end ----


def _open_live(tmp_path):
    ckpt = str(tmp_path / "ck")
    js.save_index(_jax_index(vpad_headroom=96), ckpt, n_shards=2)
    disk = tdisk.DiskIVFIndex.open(ckpt, device="cpu")
    disk.delta = tdelta.DeltaTier.for_index(disk, 8.0)
    return disk, ckpt


def _adds(n, seed=9, clusters=2):
    centers, _, _, _ = _topic_data()
    rng = np.random.default_rng(seed)
    add = (centers[rng.integers(0, clusters, n)]
           + 0.01 * rng.standard_normal((n, D))).astype(np.float32)
    add /= np.linalg.norm(add, axis=-1, keepdims=True)
    return add, rng.integers(0, 16, (n, M)).astype(np.int16)


def test_republish_invalidates_exactly_rewritten(tmp_path):
    disk, ckpt = _open_live(tmp_path)
    kw = dict(k=K, n_probes=NP, q_block=QB)
    eng = teng.SearchEngine(disk, device="cpu", pipeline="on",
                            device_cache=BUDGET, **kw)
    plain = teng.SearchEngine(disk, device="cpu", **kw)
    batch = _tq(*_batch(21, "match_all"))
    eng.search(*batch)
    resident_before = set(eng.device_cache._entries)
    assert len(resident_before) >= 4
    add, attrs = _adds(24)  # lands in clusters 0 and 1 only
    disk.delta.add(add, attrs, np.arange(N, N + 24))
    tdelta.compact_deltas(ckpt, disk.delta, trigger="rows")
    tiles_before = list(eng.device_cache._tiles)
    inval_pre = eng.device_cache.stats()["invalidations"]
    assert eng.refresh()
    dropped = eng.device_cache.stats()["invalidations"] - inval_pre
    gens_now = np.asarray(disk.gens)
    expect = {c for c in resident_before if int(gens_now[c]) > 0}
    stale_tiles = [key for key in tiles_before
                   if any(int(gens_now[c]) > 0 for c in key[0])]
    assert expect and dropped == len(expect) + len(stale_tiles)
    assert set(eng.device_cache._entries) == resident_before - expect
    assert set(eng.device_cache._tiles) == set(tiles_before) - set(
        stale_tiles)
    _assert_identical(plain.search(*batch), eng.search(*batch),
                      "post-republish")
    assert eng.device_cache.stats()["hits"] > 0
    eng.close()
    plain.close()
    disk.close()


def test_stale_device_block_never_scanned_before_refresh(tmp_path):
    """A gen-0 entry of a rewritten cluster, re-inserted after the refresh,
    is refused at lookup by the plan's expected generations."""
    disk, ckpt = _open_live(tmp_path)
    kw = dict(k=K, n_probes=NP, q_block=QB)
    eng = teng.SearchEngine(disk, device="cpu", pipeline="on",
                            device_cache=BUDGET, **kw)
    batch = _tq(*_batch(21, "match_all"))
    eng.search(*batch)
    add, attrs = _adds(16)
    disk.delta.add(add, attrs, np.arange(N, N + 16))
    tdelta.compact_deltas(ckpt, disk.delta)
    assert eng.refresh()
    rewritten = [c for c in range(KC) if int(disk.gens[c]) > 0]
    cid = rewritten[0]
    stale = dict(disk.reader.read(cid))
    stale["gen"] = torch.tensor([0], dtype=torch.int32)
    eng.device_cache._entries.pop(cid, None)
    eng.device_cache.put_records({cid: stale})
    inval_pre = eng.device_cache.stats()["invalidations"]
    plain = teng.SearchEngine(disk, device="cpu", **kw)
    _assert_identical(plain.search(*batch), eng.search(*batch),
                      "stale entry refused")
    assert eng.device_cache.stats()["invalidations"] > inval_pre
    eng.close()
    plain.close()
    disk.close()


def test_delta_skip_with_device_cache(tmp_path):
    """The delta fold's skips with a device cache: invisible in results,
    counted as the reference counts them."""
    disk, ckpt = _open_live(tmp_path)
    jd = jdisk.DiskIVFIndex.open(ckpt)
    jd.delta = jdelta.DeltaTier.for_index(jd, 8.0)
    add, attrs = _adds(30, clusters=KC)
    attrs[:, 0] = 20000 + np.arange(30) % 10
    for t in (disk.delta, jd.delta):
        t.add(add, attrs, np.arange(N, N + 30))
    kw = dict(k=K, n_probes=NP, q_block=QB)
    eng = teng.SearchEngine(disk, device="cpu", device_cache=BUDGET, **kw)
    plain = teng.SearchEngine(disk, device="cpu", **kw)
    je = jeng.SearchEngine(jd, backend="xla", device_cache=BUDGET, **kw)
    for filt in ("band", "match_all"):
        batch = _batch(21, filt)
        got = eng.search(*_tq(*batch))
        _assert_identical(plain.search(*_tq(*batch)), got, filt)
        _assert_same(je.search(*_jq(*batch)), got, filt)
    assert (eng.stats.delta_skips, eng.stats.delta_folds) == (1, 1)
    assert (je.stats.delta_skips, je.stats.delta_folds) == (1, 1)
    for e in (eng, plain, je):
        e.close()
    disk.close()
    jd.close()


def test_metrics_text_exposition(built):
    batch = _batch(8, "match_all", offset=0)
    kw = dict(k=K, n_probes=NP, q_block=QB, device_cache=8 * 2**20)
    with tdisk.DiskIVFIndex.open(built, device="cpu") as td, \
            jdisk.DiskIVFIndex.open(built) as jd:
        eng = teng.SearchEngine(td, device="cpu", **kw)
        je = jeng.SearchEngine(jd, backend="xla", **kw)
        for _ in range(2):
            eng.search(*_tq(*batch))
            je.search(*_jq(*batch))
        got, want = eng.metrics(), je.metrics()
        assert set(got) == set(want)
        for key in want:
            if key.startswith("device_cache."):
                assert got[key] == want[key], key
        text = eng.metrics_text()
    lines = text.splitlines()
    assert "# TYPE repro_engine_batches counter" in lines
    assert "repro_engine_batches 2" in lines
    assert "# TYPE repro_device_cache_hits counter" in lines
    assert "# TYPE repro_device_cache_resident_bytes gauge" in lines
    for counter in ("repro_device_cache_hits", "repro_device_cache_misses",
                    "repro_device_cache_evictions",
                    "repro_device_cache_invalidations"):
        assert any(ln.startswith(counter + " ") for ln in lines), counter
    for ln in lines:
        if not ln.startswith("#"):
            assert len(ln.rsplit(" ", 1)) == 2, ln
