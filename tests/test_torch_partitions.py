"""The port's filter-specialized sub-partitions (storage layout 4, planner
routing) against the JAX package's, on the same numpy inputs.

The index is the reference's own partition fixture: a topic mixture whose
attr0 timestamp is uniform and independent of the topic, so summary
pruning is blind to a time window and only the sub-partition layout
distinguishes a routed plan.  Catalogs, records and checkpoint bytes match
exactly.  A routed search is held against the flat search
(``partitions="off"``) of both packages: against the port's flat search
ids and scores are equal bit for bit (the plain scan scores each row
alone, whatever its block's height); against the reference's flat search
ids are equal and scores agree within rtol 1e-5 (f32 sums taken in
another order; l2 scores, differences of unit-size terms, also within
atol 1e-6).  The reference's own routed-vs-flat test fails here on
XLA's rounding over shorter blocks (ROADMAP C.6), so its flat search is
the yardstick.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import delta as jdelta
from repro.core import disk as jdisk
from repro.core import engine as jeng
from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import partitions as jpart
from repro.core import storage as js
from repro.core import update as jup
from repro_torch.core import blockstore as tbs
from repro_torch.core import delta as tdelta
from repro_torch.core import disk as tdisk
from repro_torch.core import engine as teng
from repro_torch.core import filters as tf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import partitions as tpart
from repro_torch.core import storage as ts
from repro_torch.core import update as tup

N, D, M, KC = 1536, 32, 6, 12
TS_RANGE = 6000
K, NP, QB = 10, 4, 8
W = 150  # a window under the finest ladder stride: always routed
VARIANTS = {  # name: (metric, quantized)
    "dot-f32": ("dot", False), "l2-f32": ("l2", False),
    "dot-sq8": ("dot", True),
}


def _data():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.05 * rng.standard_normal((N, D)).astype(
        np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    attrs[:, 0] = rng.integers(0, TS_RANGE, N).astype(np.int16)
    return centers, core, attrs, topic.astype(np.int32)


def _jax_index(metric, quantized):
    centers, core, attrs, topic = _data()
    spec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jnp.float32,
                          metric=metric)
    vpad = int(np.bincount(topic, minlength=KC).max()) + 96
    index, _ = jivf.build_from_assignments(
        spec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic), vpad=vpad, ids=jnp.arange(N))
    return jivf.quantize_index(index) if quantized else index


def _carry(ji, metric):
    """The JAX index's fields into the port (on the CPU)."""
    arrays = {f: np.asarray(getattr(ji, f)) for f in
              ("centroids", "vectors", "attrs", "ids", "counts")}
    for f in ("norms", "scales"):
        if getattr(ji, f) is not None:
            arrays[f] = np.asarray(getattr(ji, f))
    for f in ("amin", "amax", "hist", "edges_lo", "edges_hi"):
        arrays[f] = np.asarray(getattr(ji.summaries, f))
    spec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32,
                          metric=metric)
    return tivf.index_from_arrays(arrays, spec, device="cpu")


def _carry_build(jb):
    cat = jb.catalog
    return tpart.build_from_arrays(
        {f: getattr(cat, f) for f in tpart.CATALOG_FIELDS}, cat.n_base,
        jb.records, jb.vpads)


@pytest.fixture(scope="module", params=list(VARIANTS))
def built(request, tmp_path_factory):
    """(variant, jax index, port index, jax build, port build, layout-4
    checkpoint the JAX package wrote)."""
    metric, quantized = VARIANTS[request.param]
    ji = _jax_index(metric, quantized)
    jb = jpart.build_partitions(ji, attrs=[0])
    ti = _carry(ji, metric)
    tb = tpart.build_partitions(ti, attrs=[0])
    ckpt = str(tmp_path_factory.mktemp(f"part_{request.param}"))
    js.save_index(ji, ckpt, n_shards=2, layout=4, partitions=jb)
    return request.param, ji, ti, jb, tb, ckpt


def _queries(q, width=W, seed=11):
    _, core, _, _ = _data()
    rng = np.random.default_rng(seed)
    qs = (core[rng.integers(0, N, q)]
          + 0.01 * rng.standard_normal((q, D))).astype(np.float32)
    lo = np.full((q, 1, M), -32768, np.int16)
    hi = np.full((q, 1, M), 32767, np.int16)
    start = np.random.default_rng(7).integers(0, TS_RANGE - width, q)
    lo[:, 0, 0] = start
    hi[:, 0, 0] = start + width - 1
    return qs, lo, hi


def _jq(qs, lo, hi):
    return jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo),
                                          hi=jnp.asarray(hi))


def _tq(qs, lo, hi):
    return torch.from_numpy(qs), tf.FilterSpec(lo=torch.from_numpy(lo),
                                               hi=torch.from_numpy(hi))


def _assert_equal_build(jb, tb):
    for f in tpart.CATALOG_FIELDS:
        want, got = getattr(jb.catalog, f), getattr(tb.catalog, f)
        assert want.dtype == got.dtype, f
        np.testing.assert_array_equal(want, got, err_msg=f)
    assert tb.catalog.n_base == jb.catalog.n_base
    np.testing.assert_array_equal(jb.vpads, tb.vpads)
    assert len(jb.records) == len(tb.records)
    for jr, tr in zip(jb.records, tb.records):
        assert set(jr) == set(tr)
        for name in jr:
            np.testing.assert_array_equal(np.asarray(jr[name]),
                                          tr[name].numpy(), err_msg=name)


def _assert_same(want, got, msg="", exact=False):
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy(),
                                  err_msg=msg)
    if exact:
        np.testing.assert_array_equal(np.asarray(want.scores),
                                      got.scores.numpy(), err_msg=msg)
    else:
        # l2 scores are ‖q‖² - 2q·x + ‖x‖² of unit vectors near their query:
        # terms of size 1 cancel, so the absolute error is the f32 one of 1
        np.testing.assert_allclose(np.asarray(want.scores),
                                   got.scores.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=msg)


# ---- routing ----


def _rand_catalog(rng, n_entries, m):
    lo = rng.integers(-60, 40, (n_entries, m)).astype(np.int16)
    hi = (lo + rng.integers(0, 80, (n_entries, m))).astype(np.int16)
    full = rng.random((n_entries, m)) < 0.6
    lo[full], hi[full] = thy.ATTR_MIN, thy.ATTR_MAX
    # as the builder, every entry constrains its partition attribute
    allfull = np.nonzero(full.all(axis=1))[0]
    keep = rng.integers(0, m, allfull.size)
    lo[allfull, keep] = rng.integers(-60, 40, allfull.size)
    hi[allfull, keep] = lo[allfull, keep] + rng.integers(0, 80, allfull.size)
    arrays = dict(
        pred_lo=lo, pred_hi=hi, members=np.full((n_entries, 1), -1, np.int32),
        entry_rows=rng.integers(1, 50, n_entries).astype(np.int64),
        parent=np.zeros(0, np.int32), sub_lo=np.zeros((0, m), np.int16),
        sub_hi=np.zeros((0, m), np.int16), sub_counts=np.zeros(0, np.int32),
        sub_amin=np.zeros((0, m), np.int16),
        sub_amax=np.zeros((0, m), np.int16))
    return (jpart.PartitionCatalog(n_base=1, **arrays),
            tpart.PartitionCatalog(n_base=1, **arrays))


@pytest.mark.parametrize("seed", range(4))
def test_route_matches_reference(seed):
    """Routing and subsumption: the port's router picks the reference's
    entry on random boxes (ties in entry rows included), the first on a
    tie, -1 where nothing subsumes."""
    rng = np.random.default_rng(seed)
    for _ in range(15):
        m = int(rng.integers(1, 5))
        jc, tc = _rand_catalog(rng, int(rng.integers(1, 24)), m)
        q, n_terms = int(rng.integers(1, 16)), int(rng.integers(1, 3))
        lo = rng.integers(-60, 40, (q, n_terms, m)).astype(np.int16)
        hi = (lo + rng.integers(-10, 40, (q, n_terms, m))).astype(np.int16)
        full = rng.random((q, n_terms, m)) < 0.7
        lo[full], hi[full] = thy.ATTR_MIN, thy.ATTR_MAX
        np.testing.assert_array_equal(jc.route(lo, hi), tc.route(lo, hi))
        np.testing.assert_array_equal(
            jc.route(lo, hi), tc.route(torch.from_numpy(lo),
                                       torch.from_numpy(hi)))


def test_route_unfiltered_and_void_fall_back():
    _, tc = _rand_catalog(np.random.default_rng(1), 8, 3)
    lo = np.full((5, 1, 3), thy.ATTR_MIN, np.int16)
    hi = np.full((5, 1, 3), thy.ATTR_MAX, np.int16)
    assert np.all(tc.route(lo, hi) == -1), "match-all must not route"
    lo[:, 0, 0], hi[:, 0, 0] = 5, 4  # void term
    assert np.all(tc.route(lo, hi) == -1), "all-void must not route"


def test_to_base_traffic_and_choose_attrs(built):
    _, ji, ti, jb, tb, _ = built
    ids = np.arange(KC + tb.n_subs)
    np.testing.assert_array_equal(jb.catalog.to_base(ids),
                                  tb.catalog.to_base(ids))
    assert tb.catalog.nbytes() == jb.catalog.nbytes()
    _, lo, hi = _queries(9)
    jr, tr = jpart.FilterTrafficRecorder(M), tpart.FilterTrafficRecorder(M)
    jr.observe(lo, hi)
    tr.observe(torch.from_numpy(lo), torch.from_numpy(hi))
    assert tr.stats() == jr.stats()
    assert tpart.choose_attrs(ti.summaries, tr) == jpart.choose_attrs(
        ji.summaries, jr) == [0]
    assert tpart.choose_attrs(ti.summaries) == jpart.choose_attrs(
        ji.summaries)


# ---- the build and layout 4 ----


def test_build_partitions_matches_reference(built):
    _, _, _, jb, tb, _ = built
    assert tb.n_subs > 0 and tb.catalog.n_entries > 0
    _assert_equal_build(jb, tb)
    _assert_equal_build(jb, _carry_build(jb))


@pytest.mark.parametrize("max_subs", [5, 4096])
def test_build_partitions_ladder_and_cap(max_subs):
    """A per-value attribute (16 distinct values) and the sub cap."""
    ji = _jax_index("dot", False)
    ti = _carry(ji, "dot")
    kw = dict(attrs=[2, 0], max_subs=max_subs, base_windows=4, max_depth=2)
    _assert_equal_build(jpart.build_partitions(ji, **kw),
                        tpart.build_partitions(ti, **kw))


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if not f.endswith(".tmp")}


def _assert_same_checkpoint(d1, d2):
    """Every file equal byte for byte, but the bounds (f32 sums): the
    radius within 4 ULP, the l2 slack within 4 ULP of the largest stored
    squared norm."""
    want, got = _dir_bytes(d1), _dir_bytes(d2)
    assert set(want) == set(got)
    for f in want:
        if f == "bounds_radius.npy":
            a = np.load(os.path.join(d1, f)).view(np.int32).astype(np.int64)
            b = np.load(os.path.join(d2, f)).view(np.int32).astype(np.int64)
            assert np.abs(a - b).max() <= 4, f
        elif f == "bounds_slack.npy":
            x2 = float((ts.load_index(d1, device="cpu").vectors.float() ** 2)
                       .sum(-1).max())
            np.testing.assert_allclose(
                np.load(os.path.join(d1, f)), np.load(os.path.join(d2, f)),
                rtol=0, atol=4 * float(np.spacing(np.float32(max(x2, 1.0)))))
        else:
            assert want[f] == got[f], f


def test_layout4_files_byte_identical(built, tmp_path):
    """Both writers write the same files (the bounds within a few ULP), and
    each package loads the other's checkpoint."""
    variant, ji, ti, jb, tb, ckpt = built
    mine = str(tmp_path / "port")
    ts.save_index(ti, mine, n_shards=2, layout=4, partitions=tb)
    _assert_same_checkpoint(ckpt, mine)
    man = ts.load_manifest(ckpt)
    np.testing.assert_array_equal(ts.load_gens(ckpt, man),
                                  js.load_gens(ckpt, js.load_manifest(ckpt)))
    for d in (ckpt, mine):  # both loaders, both writers
        jl, tl = js.load_index(d), ts.load_index(d, device="cpu")
        assert tl.n_clusters == jl.n_clusters == KC + tb.n_subs
        for f in ("vectors", "attrs", "ids", "counts", "centroids"):
            np.testing.assert_array_equal(np.asarray(getattr(jl, f)),
                                          getattr(tl, f).numpy(), err_msg=f)
        for f in tpart.CATALOG_FIELDS:
            np.testing.assert_array_equal(getattr(jl.partitions, f),
                                          getattr(tl.partitions, f))
    recs = ts.load_partition_records(ckpt, man)
    for jr, tr in zip(js.load_partition_records(ckpt, js.load_manifest(ckpt)),
                      recs):
        for name in jr:
            np.testing.assert_array_equal(np.asarray(jr[name]),
                                          tr[name].numpy())


def test_layout4_gens_and_guards(tmp_path):
    ji = _jax_index("dot", False)
    ti = _carry(ji, "dot")
    tb = tpart.build_partitions(ti, attrs=[0])
    with pytest.raises(ValueError, match="partitions="):
        ts.save_index(ti, str(tmp_path / "a"), layout=4)
    with pytest.raises(ValueError, match="layout=4"):
        ts.save_index(ti, str(tmp_path / "a"), partitions=tb)
    gens = np.arange(KC, dtype=np.int64)
    ts.save_index(ti, str(tmp_path / "g"), n_shards=2, layout=4,
                  partitions=tb, gens=gens)
    got = ts.load_gens(str(tmp_path / "g"), ts.load_manifest(str(tmp_path / "g")))
    np.testing.assert_array_equal(got[:KC], gens)
    np.testing.assert_array_equal(got[KC:], gens[tb.catalog.parent])
    with pytest.raises(ts.GenerationMismatchError):
        ts.save_index(ti, str(tmp_path / "h"), layout=4, partitions=tb,
                      gens=np.zeros(3, np.int64))
    with pytest.raises(ValueError, match="target_shards"):
        ts.load_index(str(tmp_path / "g"), target_shards=5, device="cpu")


def test_attach_matches_reference(built):
    _, ji, ti, jb, tb, _ = built
    ja, ta = jpart.attach(ji, jb), tpart.attach(ti, tb)
    for f in ("centroids", "vectors", "attrs", "ids", "counts", "norms",
              "scales"):
        if getattr(ja, f) is None:
            assert getattr(ta, f) is None
            continue
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)),
                                      getattr(ta, f).numpy(), err_msg=f)
    for f in ("amin", "amax", "hist"):
        np.testing.assert_array_equal(np.asarray(getattr(ja.summaries, f)),
                                      getattr(ta.summaries, f).numpy())
    assert ta.partitions is tb.catalog


# ---- routed against flat ----


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("store", ["ram", "resident", "disk"])
def test_routed_matches_flat(built, store, pipeline):
    """Routed against flat over the port's RAM engine (attached subs), its
    resident store and its disk tier: bitwise against the port's flat
    search, within rtol 1e-5 against the reference's."""
    variant, ji, ti, jb, tb, ckpt = built
    qs, lo, hi = _queries(21)  # ragged multi-tile at q_block=8
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on", pipeline=pipeline)
    je = jeng.SearchEngine(ji, backend="xla", **kw)
    want = je.search(*_jq(qs, lo, hi))
    attached = tpart.attach(ti, tb)
    disk = None
    if store == "ram":
        idx, extra = attached, {}
    elif store == "resident":
        idx, extra = attached, dict(blockstore=tbs.ResidentBlockStore(
            attached))
    else:
        disk = tdisk.DiskIVFIndex.open(ckpt, device="cpu")
        idx, extra = disk, {}
    try:
        flat = teng.SearchEngine(idx, device="cpu", partitions="off",
                                 **extra, **kw)
        routed = teng.SearchEngine(idx, device="cpu", partitions="auto",
                                   **extra, **kw)
        r0 = flat.search(*_tq(qs, lo, hi))
        r1 = routed.search(*_tq(qs, lo, hi))
        _assert_same(r0, r1, f"{store} routed vs the port's flat", exact=True)
        _assert_same(want, r1, f"{store} routed vs the reference's flat")
        np.testing.assert_array_equal(np.asarray(want.n_scanned),
                                      r0.n_scanned.numpy())
        assert routed.stats.partition_hits == 21
        assert flat.stats.partition_hits == 0
        # the routed plan scans each probed cluster's in-window rows only
        assert (r1.n_scanned <= r0.n_scanned).all()
        assert r1.n_scanned.sum() < r0.n_scanned.sum()
        assert routed.stats.partition_rows_scanned == int(r1.n_scanned.sum())
        routed.close()
        flat.close()
    finally:
        if disk is not None:
            disk.close()
        if "blockstore" in extra:
            extra["blockstore"].close()


def test_routed_counters_match_reference_engine(built):
    """With the same catalog, the port's routed plan makes the reference's
    routing decisions and slot tables; a routed disk batch's blocks are
    as tall as its tallest record."""
    variant, ji, ti, jb, tb, ckpt = built
    qs, lo, hi = _queries(16)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on", pipeline="on")
    jd = jdisk.DiskIVFIndex.open(ckpt)
    td = tdisk.DiskIVFIndex.open(ckpt, device="cpu")
    try:
        je = jeng.SearchEngine(jd, backend="xla", **kw)
        te = teng.SearchEngine(td, device="cpu", **kw)
        jp, tp = je.plan(*_jq(qs, lo, hi)), te.plan(*_tq(qs, lo, hi))
        np.testing.assert_array_equal(jp.route, tp.route)
        for f in ("slot_cluster", "slot_of_probe", "probe_ok", "n_unique"):
            np.testing.assert_array_equal(np.asarray(getattr(jp, f)),
                                          np.asarray(getattr(tp, f)),
                                          err_msg=f)
        want, got = je.execute(jp), te.execute(tp)
        _assert_same(want, got, "disk routed")
        for c in ("partition_hits", "partition_fallbacks",
                  "partition_rows_scanned", "flat_rows_scanned",
                  "blocks_fetched"):
            assert getattr(te.stats, c) == getattr(je.stats, c), c
        ops = te.fetch(tp)
        sub_rows = int(tb.vpads.max())
        assert ops[1].shape[1] <= sub_rows < ti.vpad
        je.close()
        te.close()
    finally:
        jd.close()
        td.close()


def test_unroutable_predicate_is_flat(built):
    """A window wider than every entry declines: the flat plan, n_scanned
    included, and each such query counts as a fallback."""
    _, ji, ti, jb, tb, _ = built
    qs, lo, hi = _queries(16, width=TS_RANGE // 2)
    attached = tpart.attach(ti, tb)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on")
    flat = teng.SearchEngine(attached, device="cpu", partitions="off", **kw)
    routed = teng.SearchEngine(attached, device="cpu", partitions="auto", **kw)
    r0, r1 = flat.search(*_tq(qs, lo, hi)), routed.search(*_tq(qs, lo, hi))
    _assert_same(r0, r1, "fallback", exact=True)
    np.testing.assert_array_equal(r0.n_scanned.numpy(), r1.n_scanned.numpy())
    assert routed.stats.partition_hits == 0
    assert routed.stats.partition_fallbacks == 16
    je = jeng.SearchEngine(jpart.attach(ji, jb), backend="xla", **kw)
    je.search(*_jq(qs, lo, hi))
    assert je.stats.partition_fallbacks == routed.stats.partition_fallbacks
    with pytest.raises(ValueError, match="partitions='on'"):
        teng.SearchEngine(ti, device="cpu", partitions="on", **kw).search(
            *_tq(qs, lo, hi))


# ---- updates over a partitioned index ----


def test_resync_partitions_matches_reference(built):
    _, ji, ti, jb, tb, _ = built
    ja, ta = jpart.attach(ji, jb), tpart.attach(ti, tb)
    parent = int(tb.catalog.parent[0])
    jo = jup.tombstone(ja, jnp.full(8, parent), jnp.arange(8))
    to = tup.tombstone(ta, torch.full((8,), parent), torch.arange(8))
    jo.partitions, to.partitions = ja.partitions, ta.partitions
    jo, to = jup.resync_partitions(jo), tup.resync_partitions(to)
    assert to.partitions.sub_counts.sum() < tb.catalog.sub_counts.sum()
    for f in tpart.CATALOG_FIELDS:
        np.testing.assert_array_equal(getattr(jo.partitions, f),
                                      getattr(to.partitions, f), err_msg=f)
    for f in ("vectors", "attrs", "ids", "counts"):
        np.testing.assert_array_equal(np.asarray(getattr(jo, f)),
                                      getattr(to, f).numpy(), err_msg=f)
    qs, lo, hi = _queries(16)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on")
    flat = teng.SearchEngine(to, device="cpu", partitions="off", **kw)
    routed = teng.SearchEngine(to, device="cpu", **kw)
    _assert_same(flat.search(*_tq(qs, lo, hi)),
                 routed.search(*_tq(qs, lo, hi)), "post-resync", exact=True)
    assert tup.resync_partitions(ti) is ti


def _updates(centers, seed=5, n=64):
    rng = np.random.default_rng(seed)
    add = (centers[rng.integers(0, KC, n)]
           + 0.05 * rng.standard_normal((n, D))).astype(np.float32)
    add /= np.linalg.norm(add, axis=-1, keepdims=True)
    add_attrs = rng.integers(0, 16, (n, M)).astype(np.int16)
    add_attrs[:, 0] = rng.integers(0, TS_RANGE, n).astype(np.int16)
    dead = rng.choice(N, 48, replace=False)
    return add, add_attrs, dead


def test_compact_deltas_on_layout4(tmp_path):
    """A live tier over a layout-4 checkpoint: routed equals flat before and
    after the republish, the republish writes the reference's files (subs
    of touched parents rebuilt, their generations bumped), and the RAM
    delta tier over an attached index assigns rows to base clusters."""
    centers, _, _, topic = _data()
    ji = _jax_index("dot", False)
    jb = jpart.build_partitions(ji, attrs=[0])
    base = str(tmp_path / "base")
    js.save_index(ji, base, n_shards=2, layout=4, partitions=jb)
    dirs = {p: str(tmp_path / p) for p in ("jax", "port")}
    for d in dirs.values():
        shutil.copytree(base, d)
    add, add_attrs, dead = _updates(centers)
    new_ids = np.arange(N, N + 64, dtype=np.int64)
    disk = tdisk.DiskIVFIndex.open(dirs["port"], device="cpu")
    tier = tdelta.DeltaTier.for_index(disk, 8.0)
    disk.delta = tier
    jdisk_ = jdisk.DiskIVFIndex.open(dirs["jax"])
    jt = jdelta.DeltaTier.for_index(jdisk_, 8.0)
    qs, lo, hi = _queries(16)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on")
    flat = teng.SearchEngine(disk, device="cpu", partitions="off", **kw)
    routed = teng.SearchEngine(disk, device="cpu", **kw)
    for t in (tier, jt):
        t.add(add, add_attrs, new_ids)
        t.tombstone(dead, clusters=topic[dead])
        t.tombstone(new_ids[:8])
    _assert_same(flat.search(*_tq(qs, lo, hi)),
                 routed.search(*_tq(qs, lo, hi)), "live", exact=True)
    want = jdelta.compact_deltas(dirs["jax"], jt)
    got = tdelta.compact_deltas(dirs["port"], tier)
    assert vars(got) == vars(want) and got.clusters_rewritten > 0
    _assert_same_checkpoint(dirs["jax"], dirs["port"])
    gens = ts.load_gens(dirs["port"], ts.load_manifest(dirs["port"]))
    assert (gens[KC:] > 0).any()
    assert routed.refresh()
    flat.refresh()
    r0, r1 = flat.search(*_tq(qs, lo, hi)), routed.search(*_tq(qs, lo, hi))
    _assert_same(r0, r1, "after the republish", exact=True)
    je = jeng.SearchEngine(js.load_index(dirs["jax"]), backend="xla",
                           partitions="off", **kw)
    _assert_same(je.search(*_jq(qs, lo, hi)), r1, "vs the reference rebuild")
    assert routed.stats.partition_hits > 0
    for e in (flat, routed):
        e.close()
    disk.close()
    jdisk_.close()
    # a RAM tier over an attached index assigns rows to base clusters
    ta = tpart.attach(_carry(ji, "dot"), _carry_build(jb))
    rt = tdelta.DeltaTier(ta, 128)
    jr = jdelta.DeltaTier(jpart.attach(ji, jb), 128)
    rt.add(add, add_attrs, new_ids)
    jr.add(add, add_attrs, new_ids)
    np.testing.assert_array_equal(np.asarray(jr.snapshot().clusters),
                                  rt.snapshot().clusters.numpy())
    assert rt.n_clusters == KC


def test_delta_envelope_skip_on_layout4(tmp_path):
    """The tier's per-attribute envelope skips a disjoint fold over a
    layout-4 checkpoint, and folds an overlapping one, as the
    reference's."""
    ji = _jax_index("dot", False)
    ckpt = str(tmp_path / "ck")
    js.save_index(ji, ckpt, n_shards=2, layout=4,
                  partitions=jpart.build_partitions(ji, attrs=[0]))
    centers, _, _, _ = _data()
    add, add_attrs, _ = _updates(centers, seed=9, n=16)
    add_attrs[:, 0] = np.random.default_rng(9).integers(100, 200, 16)
    td = tdisk.DiskIVFIndex.open(ckpt, device="cpu")
    jd = jdisk.DiskIVFIndex.open(ckpt)
    td.delta, jd.delta = (tdelta.DeltaTier.for_index(td, 8.0),
                          jdelta.DeltaTier.for_index(jd, 8.0))
    for t in (td.delta, jd.delta):
        t.add(add, add_attrs, np.arange(N, N + 16, dtype=np.int64))
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on")
    te = teng.SearchEngine(td, device="cpu", **kw)
    je = jeng.SearchEngine(jd, backend="xla", **kw)
    qs, lo, hi = _queries(8)
    for a, b in ((4000, 4200), (100, 250)):
        lo[:, 0, 0], hi[:, 0, 0] = a, b
        _assert_same(je.search(*_jq(qs, lo, hi)),
                     te.search(*_tq(qs, lo, hi)), f"window [{a}, {b}]")
    assert te.stats.delta_interval_skips == je.stats.delta_interval_skips == 1
    assert te.stats.delta_folds == je.stats.delta_folds == 1
    te.close()
    je.close()
    td.close()
    jd.close()


def test_partition_metrics_match_reference(built):
    variant, ji, ti, jb, tb, ckpt = built
    qs, lo, hi = _queries(16)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on", pipeline="on")
    jd = jdisk.DiskIVFIndex.open(ckpt)
    td = tdisk.DiskIVFIndex.open(ckpt, device="cpu")
    je = jeng.SearchEngine(jd, backend="xla", **kw)
    te = teng.SearchEngine(td, device="cpu", **kw)
    try:
        je.search(*_jq(qs, lo, hi))
        te.search(*_tq(qs, lo, hi))
        want, got = je.metrics(), te.metrics()
        for key in want:
            if key.startswith(("partitions.", "filter_traffic.",
                               "engine.partition", "engine.flat_rows")):
                assert got[key] == want[key], key
        assert set(got) == set(want)
        text = te.metrics_text()
        assert "# TYPE repro_engine_partition_hits counter" in text
        assert "repro_partitions_subs" in text
    finally:
        je.close()
        te.close()
        jd.close()
        td.close()
