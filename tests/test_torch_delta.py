"""The port's RAM delta tier and republish against the JAX package's, and
the live two-tier search against a from-scratch rebuild.

Both packages start from one index (built by the JAX package from a numpy
seed) and take the same adds and deletes.  Held against the reference:
``DeltaTier`` add / tombstone / snapshot / count_adjustment / stats,
``scan_snapshot``, ``mask_tombstones``, ``snapshot_summary`` /
``snapshot_reach``, the engine with a delta tier on the RAM and disk tiers
and both executors, before and after a republish, and ``compact_deltas``'
files byte for byte.  Ids and counters are exact; scores agree within rtol
1e-5, atol 1e-6 (f32 sums taken in another order; the rows are unit
vectors, so a score near 0 carries an absolute rounding of ~1e-7).  Three
kinds of f32 values are sums XLA and PyTorch take in another order, and
agree within 4 ULP instead of bit for bit: the l2 norms of added rows (in
the snapshot and in the republished records), the score bounds' radius,
and their slack (a difference of two squared norms: within 4 ULP of those
norms).  Every other byte of the republished checkpoint is equal.

The live search is also held against a RAM engine over a rebuild at the
same logical state (ids and ``n_passed`` exact, scores as above).  The
reference's own late-tombstone case (a delete landing while a republish is
pending) fails on this tree, so the port's counterpart is held against the
rebuild alone.
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
from repro.core import storage as js
from repro_torch.core import delta as tdelta
from repro_torch.core import disk as tdisk
from repro_torch.core import engine as teng
from repro_torch.core import filters as tf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import kmeans as tkm

N, D, M, KC, TS = 1536, 32, 6, 12, 6000
K, NP, QB = 10, 5, 8
VARIANTS = {  # name: (metric, quantized)
    "dot": ("dot", False),
    "l2": ("l2", False),
    "sq8": ("dot", True),
}


def _data(seed=3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.05 * rng.standard_normal((N, D)).astype(
        np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    band = TS // KC
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    attrs[:, 0] = (topic * band + rng.integers(0, band, N)).astype(np.int16)
    return centers, core, attrs, topic.astype(np.int32)


def _specs(metric):
    return (jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jnp.float32,
                           metric=metric),
            thy.HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32,
                           metric=metric))


def _jax_index(variant):
    metric, quantized = VARIANTS[variant]
    centers, core, attrs, topic = _data()
    vpad = int(np.bincount(topic, minlength=KC).max()) + 96  # fold headroom
    ji, _ = jivf.build_from_assignments(
        _specs(metric)[0], jnp.asarray(centers), jnp.asarray(core),
        jnp.asarray(attrs), jnp.asarray(topic), vpad=vpad, ids=jnp.arange(N))
    return jivf.quantize_index(ji) if quantized else ji


def _carry(ji, metric):
    """The JAX index as the port's (the same arrays)."""
    arrays = {f: getattr(ji, f) for f in ("centroids", "vectors", "attrs",
                                          "ids", "counts", "norms", "scales")}
    arrays = {f: None if a is None else np.asarray(a) for f, a in arrays.items()}
    for f in ("amin", "amax", "hist", "edges_lo", "edges_hi"):
        arrays[f] = np.asarray(getattr(ji.summaries, f))
    return tivf.index_from_arrays(arrays, _specs(metric)[1], device="cpu")


class Logical:
    """The logical state a rebuild is built from: every row ever added
    (checkpoint rows, then delta adds in add order) and which are alive."""

    def __init__(self):
        self.centers, self.core, self.attrs, topic = _data()
        self.ids = np.arange(N)
        self.clusters = topic.astype(np.int64)
        self.alive = np.ones(N, bool)

    def add(self, core, attrs, ids):
        a = tkm.assign(torch.from_numpy(core), torch.from_numpy(self.centers))
        self.core = np.concatenate([self.core, core])
        self.attrs = np.concatenate([self.attrs, attrs])
        self.ids = np.concatenate([self.ids, ids])
        self.clusters = np.concatenate([self.clusters, a.numpy()])
        self.alive = np.concatenate([self.alive, np.ones(len(core), bool)])

    def kill(self, ids):
        self.alive[np.isin(self.ids, ids)] = False

    def cluster_of(self, ids):
        return self.clusters[np.searchsorted(self.ids, ids)]

    def rebuild_engine(self, variant, **kw):
        metric, quantized = VARIANTS[variant]
        m = self.alive
        idx, _ = tivf.build_from_assignments(
            _specs(metric)[1], self.centers, self.core[m], self.attrs[m],
            self.clusters[m], ids=self.ids[m], device="cpu")
        if quantized:
            idx = tivf.quantize_index(idx)
        return teng.SearchEngine(idx, device="cpu", **kw)


def _updates(seed=11, n_add=40, n_kill=60):
    """A batch of adds near existing rows (new ids) and cold deletes."""
    rng = np.random.default_rng(seed)
    _, core, attrs, _ = _data()
    pick = rng.integers(0, N, n_add)
    new = core[pick] + 0.02 * rng.standard_normal((n_add, D)).astype(np.float32)
    new /= np.linalg.norm(new, axis=-1, keepdims=True)
    new_attrs = attrs[pick].copy()
    new_ids = np.arange(100_000 + 1000 * seed, 100_000 + 1000 * seed + n_add)
    kill = rng.choice(N, n_kill, replace=False)
    return new.astype(np.float32), new_attrs, new_ids, kill


def _queries(q, seed=5, width=600):
    rng = np.random.default_rng(seed)
    centers = _data()[0]
    qs = (centers[rng.integers(0, KC, q)]
          + 0.05 * rng.standard_normal((q, D))).astype(np.float32)
    lo = np.full((q, 1, M), -32768, np.int16)
    hi = np.full((q, 1, M), 32767, np.int16)
    half = q // 2  # half the batch filtered by a time window
    start = rng.integers(0, TS - width, half)
    lo[:half, 0, 0], hi[:half, 0, 0] = start, start + width - 1
    return (qs, jf.FilterSpec(lo=jnp.asarray(lo), hi=jnp.asarray(hi)),
            tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi)))


def _assert_same(want, got, counters=("n_scanned", "n_passed", "n_pruned"),
                 msg=""):
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy(),
                                  err_msg=msg)
    np.testing.assert_allclose(np.asarray(want.scores), got.scores.numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=msg)
    for c in counters:
        np.testing.assert_array_equal(np.asarray(getattr(want, c)),
                                      getattr(got, c).numpy(),
                                      err_msg=f"{msg} {c}")


def _assert_matches_rebuild(live, oracle, msg=""):
    _assert_same(oracle, live, counters=("n_passed",), msg=msg)


def _tiers(ji, ti, quantize="auto", capacity=256):
    return (jdelta.DeltaTier(ji, capacity, quantize=quantize),
            tdelta.DeltaTier(ti, capacity, quantize=quantize))


# ---- the tier ----


@pytest.mark.parametrize("quantize", ["auto", "on"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tier_add_tombstone_snapshot_match_reference(variant, quantize):
    ji = _jax_index(variant)
    ti = _carry(ji, VARIANTS[variant][0])
    jt, tt = _tiers(ji, ti, quantize)
    new, new_attrs, new_ids, kill = _updates()
    for t in (jt, tt):
        assert t.snapshot() is None
        assert t.add(new[:25], new_attrs[:25], new_ids[:25]) == 25
        assert t.add(new[25:], new_attrs[25:], new_ids[25:]) == 15
    hints = Logical().cluster_of(kill)
    hints[:5] = -1  # unknown clusters
    want_n = jt.tombstone(np.concatenate([kill, new_ids[:4], kill[:3]]),
                          np.concatenate([hints, [-1] * 7]))
    got_n = tt.tombstone(np.concatenate([kill, new_ids[:4], kill[:3]]),
                         np.concatenate([hints, [-1] * 7]))
    assert got_n == want_n == 64
    js_, ts_ = jt.snapshot(), tt.snapshot()
    assert tt.snapshot() is ts_  # cached until the next mutation
    n = ts_.n_rows
    assert n == js_.n_rows == 40
    for f in ("vectors", "attrs", "ids", "clusters", "norms", "scales"):
        w, g = getattr(js_, f), getattr(ts_, f)
        assert (w is None) == (g is None), f
        if w is None:
            continue
        if f == "norms":
            assert _ulps(np.asarray(w)[:n], g[:n].numpy()).max() <= 4
        else:
            np.testing.assert_array_equal(np.asarray(w)[:n], g[:n].numpy(),
                                          err_msg=f)
    np.testing.assert_array_equal(js_.tombstones, ts_.tombstones.numpy())
    np.testing.assert_array_equal(js_.attr_lo, ts_.attr_lo)
    np.testing.assert_array_equal(js_.attr_hi, ts_.attr_hi)
    np.testing.assert_array_equal(jt.count_adjustment(KC),
                                  tt.count_adjustment(KC))
    assert tt.stats() == jt.stats()
    assert tdelta.DeltaTier.for_index(ti, 1, quantize).capacity == \
        jdelta.DeltaTier.for_index(ji, 1, quantize).capacity


@pytest.mark.parametrize("quantize", ["auto", "on"])
@pytest.mark.parametrize("variant", ["dot", "l2"])
def test_scan_snapshot_matches_reference(variant, quantize):
    metric = VARIANTS[variant][0]
    ji = _jax_index(variant)
    ti = _carry(ji, metric)
    jt, tt = _tiers(ji, ti, quantize)
    new, new_attrs, new_ids, kill = _updates(seed=12, n_add=60)
    for t in (jt, tt):
        t.add(new, new_attrs, new_ids)
        t.tombstone(new_ids[::5])
        t.tombstone(kill)
    qs, jfs, tfs = _queries(21)
    plan = jeng.plan_fused_tiled(
        ji.centroids, ji.counts, jnp.asarray(qs), jfs.lo, jfs.hi,
        metric=metric, n_probes=NP, q_block=QB, u_cap=KC,
        cast_dtype=np.dtype(np.float32), summaries=ji.summaries)
    qpad, lo_pad, hi_pad, geo, geo_ok = (np.asarray(plan[i])
                                         for i in (5, 6, 7, 9, 10))
    want = jdelta.scan_snapshot(jt.snapshot(), jnp.asarray(qs),
                                jnp.asarray(qpad), jnp.asarray(lo_pad),
                                jnp.asarray(hi_pad), jnp.asarray(geo),
                                jnp.asarray(geo_ok), metric=metric, k=K)
    snap = tt.snapshot()
    got = tdelta.scan_snapshot(snap, torch.from_numpy(qs),
                               torch.from_numpy(qpad), torch.from_numpy(lo_pad),
                               torch.from_numpy(hi_pad), torch.from_numpy(geo),
                               torch.from_numpy(geo_ok), metric=metric, k=K)
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    np.testing.assert_allclose(np.asarray(want[0]), got[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    for w, g in zip(want[2:], got[2:]):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert (got[1] >= 0).any() and got[3].sum() > 0
    # the reach without the scan, and the one-cluster summary
    np.testing.assert_array_equal(
        np.asarray(jdelta.snapshot_reach(jt.snapshot(), jnp.asarray(geo),
                                         jnp.asarray(geo_ok))),
        tdelta.snapshot_reach(snap, torch.from_numpy(geo),
                              torch.from_numpy(geo_ok), KC).numpy())
    jsu, tsu = jdelta.snapshot_summary(jt.snapshot()), \
        tdelta.snapshot_summary(snap)
    for f in ("amin", "amax", "hist", "edges_lo", "edges_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jsu, f)),
                                      getattr(tsu, f).numpy(), err_msg=f)
    # tombstone masking of a cold ids operand
    ids = np.asarray(ji.ids)
    np.testing.assert_array_equal(
        np.asarray(jdelta.mask_tombstones(jnp.asarray(ids),
                                          jt.snapshot().tombstones)),
        tdelta.mask_tombstones(torch.from_numpy(ids),
                               snap.tombstones).numpy())


def test_tier_guards():
    ji = _jax_index("dot")
    ti = _carry(ji, "dot")
    tt = tdelta.DeltaTier(ti, 16)
    new, new_attrs, new_ids, _ = _updates(n_add=20)
    tt.add(new[:10], new_attrs[:10], new_ids[:10])
    with pytest.raises(tdelta.DeltaOverflowError):
        tt.add(new[10:], new_attrs[10:], new_ids[10:])
    assert tt.stats()["rows"] == 10  # nothing of the refused batch landed
    with pytest.raises(ValueError):
        tdelta.DeltaTier(ti, 0)
    with pytest.raises(ValueError):
        tdelta.DeltaTier(ti, 8, quantize="off")
    tt.freeze()
    with pytest.raises(RuntimeError, match="in flight"):
        tt.freeze()
    assert tt.commit() and not tt.commit()
    assert tt.stats()["rows"] == 0 and tt.stats()["commits"] == 1


def test_republish_pressure_matches_reference():
    ji = _jax_index("dot")
    ti = _carry(ji, "dot")
    jt, tt = _tiers(ji, ti)
    new, new_attrs, new_ids, kill = _updates()
    cases = [dict(), dict(rows_watermark=30), dict(rows_watermark=41),
             dict(stale_frac=0.01, n_live=N), dict(stale_frac=0.5, n_live=N)]
    for t in (jt, tt):
        t.add(new, new_attrs, new_ids)
        t.tombstone(kill)
    for kw in cases:
        assert tdelta.republish_pressure(tt, **kw) == \
            jdelta.republish_pressure(jt, **kw), kw
    tt.freeze()
    assert tdelta.republish_pressure(tt, rows_watermark=1) is None


# ---- the engine, RAM tier ----


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ram_engine_with_delta_matches_reference_and_rebuild(variant,
                                                             pipeline):
    ji = _jax_index(variant)
    ti = _carry(ji, VARIANTS[variant][0])
    jt, tt = _tiers(ji, ti)
    state = Logical()
    new, new_attrs, new_ids, kill = _updates(seed=13, n_add=50)
    hints = state.cluster_of(kill)
    for t in (jt, tt):
        t.add(new, new_attrs, new_ids)
        t.tombstone(kill, hints)
        t.tombstone(new_ids[:6])
    state.add(new, new_attrs, new_ids)
    state.kill(np.concatenate([kill, new_ids[:6]]))
    kw = dict(k=K, n_probes=NP, q_block=QB, pipeline=pipeline)
    je = jeng.SearchEngine(ji, backend="xla", delta=jt, **kw)
    te = teng.SearchEngine(ti, device="cpu", delta=tt, **kw)
    qs, jfs, tfs = _queries(19)
    got = te.search(torch.from_numpy(qs), tfs)
    _assert_same(je.search(jnp.asarray(qs), jfs), got)
    _assert_matches_rebuild(got, state.rebuild_engine(variant, **kw).search(
        torch.from_numpy(qs), tfs))
    for name in ("delta_folds", "delta_skips", "delta_interval_skips"):
        assert getattr(te.stats, name) == getattr(je.stats, name), name
    assert te.stats.delta_folds == 1
    m = te.metrics()
    assert m["delta.rows"] == 50 and m["delta.tombstones"] == len(kill)
    assert 'stage="delta_fold"' in te.metrics_text()


def test_delta_fold_skips_match_reference():
    """A batch whose filters miss every delta row skips the scan (the
    envelope test first, then the segment's summary) and adds the reach to
    ``n_scanned``, as the reference does."""
    ji = _jax_index("dot")
    ti = _carry(ji, "dot")
    jt, tt = _tiers(ji, ti)
    new, new_attrs, new_ids, _ = _updates(seed=14)
    new_attrs[:, 1] = 3
    new_attrs[::2, 1] = 9  # attribute 1 takes the values 3 and 9 only
    for t in (jt, tt):
        t.add(new, new_attrs, new_ids)
    kw = dict(k=K, n_probes=NP, q_block=QB)
    je = jeng.SearchEngine(ji, backend="xla", delta=jt, **kw)
    te = teng.SearchEngine(ti, device="cpu", delta=tt, **kw)
    qs, _, _ = _queries(16, seed=6)
    for a1 in ((12, 15), (5, 7)):  # outside the envelope; inside it, no mass
        lo = np.full((16, 1, M), -32768, np.int16)
        hi = np.full((16, 1, M), 32767, np.int16)
        lo[:, 0, 1], hi[:, 0, 1] = a1
        _assert_same(
            je.search(jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo),
                                                     hi=jnp.asarray(hi))),
            te.search(torch.from_numpy(qs),
                      tf.FilterSpec(lo=torch.from_numpy(lo),
                                    hi=torch.from_numpy(hi))))
    assert te.stats.delta_skips == je.stats.delta_skips == 2
    assert te.stats.delta_interval_skips == je.stats.delta_interval_skips == 1
    assert te.stats.delta_folds == je.stats.delta_folds == 0


# ---- the disk tier and the republish ----


def _checkpoints(tmp_path, variant):
    ji = _jax_index(variant)
    base = str(tmp_path / "base")
    js.save_index(ji, base, n_shards=2)
    dirs = {}
    for pkg in ("jax", "port"):
        dirs[pkg] = str(tmp_path / pkg)
        shutil.copytree(base, dirs[pkg])
    return ji, dirs


def _files(d):
    return sorted(f for f in os.listdir(d) if not f.endswith(".tmp"))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def _assert_same_files(d1, d2):
    """Every file equal byte for byte, but for the f32 sums: the records'
    norms fields and the bounds' radius within 4 ULP, the slack within 4
    ULP of the largest squared norm."""
    assert _files(d1) == _files(d2)
    man = js.load_manifest(d1)
    norms_fld = next((f for f in man["fields"] if f["name"] == "norms"), None)
    top = 0.0
    for f in _files(d1):
        a = open(os.path.join(d1, f), "rb").read()
        b = open(os.path.join(d2, f), "rb").read()
        if f.startswith("shard_") and norms_fld is not None:
            ra = np.frombuffer(a, np.uint8).reshape(-1, man["record_stride"])
            rb = np.frombuffer(b, np.uint8).reshape(-1, man["record_stride"])
            o, nb = norms_fld["offset"], 4 * man["vpad"]
            na = np.ascontiguousarray(ra[:, o:o + nb]).view(np.float32)
            nb_ = np.ascontiguousarray(rb[:, o:o + nb]).view(np.float32)
            assert _ulps(na, nb_).max() <= 4, f
            top = max(top, float(np.abs(na).max()))
            rest = np.ones(man["record_stride"], bool)
            rest[o:o + nb] = False
            assert np.array_equal(ra[:, rest], rb[:, rest]), f
        elif f == "bounds_radius.npy":
            assert _ulps(np.load(os.path.join(d1, f)),
                         np.load(os.path.join(d2, f))).max() <= 4, f
        elif f == "bounds_slack.npy":
            np.testing.assert_allclose(
                np.load(os.path.join(d1, f)), np.load(os.path.join(d2, f)),
                rtol=0, atol=4 * float(np.spacing(np.float32(max(top, 1.0)))))
        else:
            assert a == b, f


# an SQ8 index's tier is SQ8 whatever quantize says: one case for it
@pytest.mark.parametrize("variant,quantize", [
    ("dot", "auto"), ("dot", "on"), ("l2", "auto"), ("l2", "on"),
    ("sq8", "auto"),
])
def test_compact_deltas_writes_the_reference_files(tmp_path, variant,
                                                   quantize):
    ji, dirs = _checkpoints(tmp_path, variant)
    ti = _carry(ji, VARIANTS[variant][0])
    jt, tt = _tiers(ji, ti, quantize)
    new, new_attrs, new_ids, kill = _updates(seed=15, n_add=70)
    hints = Logical().cluster_of(kill)
    for t in (jt, tt):
        t.add(new, new_attrs, new_ids)
        t.tombstone(kill, hints)
        t.tombstone(new_ids[:5])
    want = jdelta.compact_deltas(dirs["jax"], jt, trigger="rows")
    got = tdelta.compact_deltas(dirs["port"], tt, trigger="rows")
    assert vars(got) == vars(want)
    assert got.clusters_rewritten > 0 and got.rows_folded == 65
    _assert_same_files(dirs["jax"], dirs["port"])
    # nothing left to fold: no rewrite
    assert jt.commit() and tt.commit()
    again = tdelta.compact_deltas(dirs["port"], tt)
    assert vars(again) == vars(jdelta.compact_deltas(dirs["jax"], jt))
    assert again.clusters_rewritten == 0


def test_compact_deltas_refuses_unversioned_checkpoints(tmp_path):
    ji = _jax_index("dot")
    d = str(tmp_path / "v2")
    js.save_index(ji, d, n_shards=2, layout=2)
    with pytest.raises(tdelta.storage.GenerationMismatchError):
        tdelta.compact_deltas(d)


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_disk_tier_with_delta_before_and_after_republish(tmp_path, variant,
                                                        pipeline):
    """Live adds and deletes on the disk tier, then a republish and a
    refresh, then more: every batch equals the JAX disk tier's and a
    rebuild's at the same logical state."""
    ji, dirs = _checkpoints(tmp_path, variant)
    jd = jdisk.DiskIVFIndex.open(dirs["jax"])
    td = tdisk.DiskIVFIndex.open(dirs["port"], device="cpu")
    jd.delta, td.delta = _tiers(jd, td)
    state = Logical()
    kw = dict(k=K, n_probes=NP, q_block=QB, pipeline=pipeline)
    je = jeng.SearchEngine(jd, backend="xla", **kw)
    te = teng.SearchEngine(td, device="cpu", **kw)
    try:
        for step, seed in enumerate((16, 17, 18)):
            new, new_attrs, new_ids, kill = _updates(seed=seed, n_add=30,
                                                     n_kill=25)
            kill = kill[state.alive[np.searchsorted(state.ids, kill)]]
            hints = state.cluster_of(kill)
            for t in (jd.delta, td.delta):
                t.add(new, new_attrs, new_ids)
                t.tombstone(kill, hints)
            state.add(new, new_attrs, new_ids)
            state.kill(kill)
            qs, jfs, tfs = _queries(24, seed=seed)
            got = te.search(torch.from_numpy(qs), tfs)
            _assert_same(je.search(jnp.asarray(qs), jfs), got,
                         msg=f"step {step}")
            _assert_matches_rebuild(got, state.rebuild_engine(
                variant, **kw).search(torch.from_numpy(qs), tfs),
                msg=f"step {step}")
            if step == 1:  # republish, then flip between batches
                st = tdelta.compact_deltas(dirs["port"], td.delta)
                assert vars(st) == vars(jdelta.compact_deltas(dirs["jax"],
                                                              jd.delta))
                assert te.refresh() and je.refresh()
                assert td.delta.stats()["rows"] == 0
                got = te.search(torch.from_numpy(qs), tfs)
                _assert_same(je.search(jnp.asarray(qs), jfs), got)
                _assert_matches_rebuild(got, state.rebuild_engine(
                    variant, **kw).search(torch.from_numpy(qs), tfs))
        for key in ("engine.delta_folds", "delta.commits", "delta.adds",
                    "cache.invalidations"):
            assert te.metrics()[key] == je.metrics()[key], key
    finally:
        je.close()
        te.close()
        jd.close()
        td.close()


def test_late_tombstone_during_pending_republish(tmp_path):
    """A delete of a frozen delta row while the republish runs: the row was
    written live to the new generation, so the commit replays the delete
    there.  Held against a rebuild (the reference fails this case)."""
    ji, dirs = _checkpoints(tmp_path, "dot")
    td = tdisk.DiskIVFIndex.open(dirs["port"], device="cpu")
    td.delta = tdelta.DeltaTier.for_index(td, 1)
    state = Logical()
    kw = dict(k=K, n_probes=NP, q_block=QB)
    te = teng.SearchEngine(td, device="cpu", **kw)
    try:
        new, new_attrs, new_ids, _ = _updates(seed=19, n_add=40)
        td.delta.add(new, new_attrs, new_ids)
        state.add(new, new_attrs, new_ids)
        qs, _, tfs = _queries(16, seed=19)
        q = torch.from_numpy(qs)
        # the republish freezes the segment; a late add and a late delete
        # of a frozen row land while it is pending
        st = tdelta.compact_deltas(dirs["port"], td.delta)
        assert st.rows_folded == 40
        late, late_attrs, late_ids, _ = _updates(seed=20, n_add=5)
        td.delta.add(late, late_attrs, late_ids)
        state.add(late, late_attrs, late_ids)
        gone = new_ids[[0, 7]]
        assert td.delta.tombstone(gone) == 2
        state.kill(gone)
        # before the flip: the old generation plus the live segment
        _assert_matches_rebuild(te.search(q, tfs),
                                state.rebuild_engine("dot", **kw).search(
                                    q, tfs))
        assert te.refresh()
        st = td.delta.stats()
        assert st["rows"] == 5 and st["tombstones"] == 2
        got = te.search(q, tfs)
        _assert_matches_rebuild(got, state.rebuild_engine("dot", **kw).search(
            q, tfs))
        assert not np.isin(got.ids.numpy(), gone).any()
    finally:
        te.close()
        td.close()


def test_tier_concurrent_adds_and_tombstones():
    """More threads than cores add disjoint batches and tombstone rows,
    with a short switch interval: no add or delete is lost, and the
    snapshot, the id map and the counters agree."""
    import sys
    import threading

    ji = _jax_index("dot")
    ti = _carry(ji, "dot")
    n_threads = min((os.cpu_count() or 4) + 2, 16)
    per, rounds = 3, 8
    tt = tdelta.DeltaTier(ti, n_threads * per * rounds)
    new, new_attrs, _, kill = _updates(seed=21, n_add=per, n_kill=n_threads)

    def work(w):
        for r in range(rounds):
            base = 200_000 + (w * rounds + r) * per
            tt.add(new, new_attrs, np.arange(base, base + per))
            tt.tombstone([base, int(kill[w])])  # one own row, one cold row

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,))
                   for w in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    st = tt.stats()
    n = n_threads * per * rounds
    assert st["rows"] == st["adds"] == n
    assert st["live_rows"] == n - n_threads * rounds
    assert st["tombstones"] == n_threads
    assert st["tombstoned"] == n_threads * rounds + n_threads
    snap = tt.snapshot()
    ids = snap.ids[:n].numpy()
    assert len(set(ids[ids >= 0].tolist())) == st["live_rows"]
    assert sorted(snap.tombstones[snap.tombstones >= 0].tolist()) == sorted(
        int(k) for k in kill[:n_threads])
