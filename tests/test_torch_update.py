"""Online updates in the port against the JAX package: ``kmeans.assign``,
the summaries' maintenance (``widen_for_add``, ``rebuild_cluster``,
``rebuild_cluster_bounds``) and every function of ``core/update.py`` on
f32, bf16 and SQ8 indexes.

Both sides start from the same index (built by the JAX package, carried to
the port as numpy arrays) and take the same numpy batches.  Every field of
the resulting indexes is compared exactly (bf16 as its bit patterns); the
l2 norms of added rows and the score bounds are f32 sums taken in another
order and agree within rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import kmeans as jkm
from repro.core import summaries as jsum
from repro.core import update as jup
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import kmeans as tkm
from repro_torch.core import summaries as tsum
from repro_torch.core import update as tup

N, D, M, KC = 900, 16, 3, 9
VARIANTS = {  # name: (metric, jax dtype, torch dtype, quantized)
    "dot-f32": ("dot", jnp.float32, torch.float32, False),
    "l2-f32": ("l2", jnp.float32, torch.float32, False),
    "dot-bf16": ("dot", jnp.bfloat16, torch.bfloat16, False),
    "sq8": ("dot", jnp.float32, torch.float32, True),
}
FIELDS = ("centroids", "vectors", "attrs", "ids", "counts", "norms", "scales")
SUMMARY = ("amin", "amax", "hist", "edges_lo", "edges_hi")


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    topic = rng.integers(0, KC, n)
    core = (centers[topic] + 0.4 * rng.standard_normal((n, D))).astype(
        np.float32)
    attrs = rng.integers(-50, 50, (n, M)).astype(np.int16)
    return centers, core, attrs, topic.astype(np.int32)


def _words(a):
    """numpy view of a field, bf16 as int16 bit patterns."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tw(t):
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _indexes(variant, vpad=None):
    metric, jd, td, quantized = VARIANTS[variant]
    centers, core, attrs, topic = _data()
    spec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jd, metric=metric)
    ji, _ = jivf.build_from_assignments(
        spec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic), vpad=vpad)
    if quantized:
        ji = jivf.quantize_index(ji)
    arrays = {f: getattr(ji, f) for f in FIELDS}
    arrays = {f: None if a is None else np.asarray(a) for f, a in arrays.items()}
    for f in SUMMARY:
        arrays[f] = np.asarray(getattr(ji.summaries, f))
    tspec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=td, metric=metric)
    return ji, tivf.index_from_arrays(arrays, tspec, device="cpu")


def _assert_same_index(ji, ti, norms_rtol=0.0):
    for f in FIELDS:
        want, got = getattr(ji, f), getattr(ti, f)
        assert (want is None) == (got is None), f
        if want is None:
            continue
        if f == "norms" and norms_rtol:
            np.testing.assert_allclose(_words(want), _tw(got), rtol=norms_rtol)
        else:
            np.testing.assert_array_equal(_words(want), _tw(got), err_msg=f)
    for f in SUMMARY:
        np.testing.assert_array_equal(np.asarray(getattr(ji.summaries, f)),
                                      getattr(ti.summaries, f).numpy(),
                                      err_msg=f)


# ---- kmeans ----


@pytest.mark.parametrize("chunk", [None, 64, 1000])
def test_assign_matches_reference(chunk):
    centers, core, _, _ = _data(1)
    cents = centers.copy()
    cents[5] = cents[2]  # an exact tie: the lower id wins
    x = np.concatenate([core, cents[[2, 2]]])
    want = np.asarray(jkm.assign(jnp.asarray(x), jnp.asarray(cents),
                                 chunk=chunk))
    got = tkm.assign(torch.from_numpy(x), torch.from_numpy(cents), chunk=chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    assert (got[-2:] == 2).all()
    np.testing.assert_allclose(
        np.asarray(jkm.pairwise_neg_dist2(jnp.asarray(x), jnp.asarray(cents))),
        tkm.pairwise_neg_dist2(torch.from_numpy(x),
                               torch.from_numpy(cents)).numpy(),
        rtol=1e-5, atol=1e-5)


# ---- summaries maintenance ----


def test_widen_for_add_matches_reference():
    ji, ti = _indexes("dot-f32")
    rng = np.random.default_rng(2)
    a = rng.integers(0, KC, 40).astype(np.int32)
    attrs = rng.integers(-500, 500, (40, M)).astype(np.int16)
    ok = rng.random(40) < 0.7
    want = jsum.widen_for_add(ji.summaries, jnp.asarray(a),
                              jnp.asarray(attrs), jnp.asarray(ok))
    got = tsum.widen_for_add(ti.summaries, torch.from_numpy(a),
                             torch.from_numpy(attrs), torch.from_numpy(ok))
    for f in SUMMARY:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)
    assert not np.array_equal(np.asarray(want.amin),
                              np.asarray(ji.summaries.amin))


@pytest.mark.parametrize("dead", [0, 5, "all"])
def test_rebuild_cluster_matches_reference(dead):
    ji, ti = _indexes("dot-f32")
    c = 4
    ids = np.asarray(ji.ids[c]).copy()
    if dead == "all":
        ids[:] = -1
    else:
        ids[:dead] = -1
    attrs = np.asarray(ji.attrs[c])
    want = jsum.rebuild_cluster(ji.summaries, jnp.asarray(attrs),
                                jnp.asarray(ids), c)
    got = tsum.rebuild_cluster(ti.summaries, torch.from_numpy(attrs),
                               torch.from_numpy(ids), c)
    for f in SUMMARY:
        np.testing.assert_array_equal(np.asarray(getattr(want, f)),
                                      getattr(got, f).numpy(), err_msg=f)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rebuild_cluster_bounds_matches_reference(variant):
    ji, ti = _indexes(variant)
    jb = jsum.build_bounds(ji.centroids, ji.vectors, ji.ids, ji.norms,
                           ji.scales)
    tb = tsum.build_bounds(ti.centroids, ti.vectors, ti.ids, ti.norms,
                           ti.scales)
    c = 3
    ids = np.asarray(ji.ids[c]).copy()
    ids[5:] = -1  # five live rows left: the bounds shrink

    def row(x):
        return None if x is None else x[c]

    want = jsum.rebuild_cluster_bounds(
        jb, ji.centroids[c], ji.vectors[c], jnp.asarray(ids), row(ji.norms),
        row(ji.scales), c)
    got = tsum.rebuild_cluster_bounds(
        tb, ti.centroids[c], ti.vectors[c], torch.from_numpy(ids),
        row(ti.norms), row(ti.scales), c)
    np.testing.assert_allclose(np.asarray(want.radius), got.radius.numpy(),
                               rtol=1e-6)
    # slack is ||x||^2 - norms: within 4 ULP of the squared norms it
    # subtracts (each side sums ||x||^2 in its own order)
    big = float(np.abs(np.asarray(ji.norms)).max()) if ji.norms is not None else 0
    np.testing.assert_allclose(np.asarray(want.slack), got.slack.numpy(),
                               rtol=0, atol=4 * np.spacing(np.float32(big)))
    assert np.asarray(want.radius)[c] != np.asarray(jb.radius)[c]


# ---- update.py ----


def _batch(seed, n):
    _, core, attrs, _ = _data(seed, n)
    return core, attrs, np.arange(10_000 + 100 * seed, 10_000 + 100 * seed + n)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_add_vectors_matches_reference(variant):
    ji, ti = _indexes(variant)
    for seed, n in ((3, 25), (4, 1), (5, 60)):
        core, attrs, ids = _batch(seed, n)
        ji, jdrop = jup.add_vectors(ji, jnp.asarray(core), jnp.asarray(attrs),
                                    jnp.asarray(ids))
        ti, tdrop = tup.add_vectors(ti, core, attrs, ids)
        assert tdrop == int(jdrop)
        _assert_same_index(ji, ti, norms_rtol=1e-6)


@pytest.mark.parametrize("variant", ["dot-f32", "sq8"])
def test_add_vectors_drops_on_vpad_overflow(variant):
    """A full list drops the rows past Vpad and reports them, as the
    reference does; the summaries cover only the rows that landed."""
    ji, ti = _indexes(variant, vpad=128)
    core, attrs, ids = _batch(6, 400)
    ji, jdrop = jup.add_vectors(ji, jnp.asarray(core), jnp.asarray(attrs),
                                jnp.asarray(ids))
    before = ti
    ti, tdrop = tup.add_vectors(ti, core, attrs, ids)
    assert tdrop == int(jdrop) > 0
    _assert_same_index(ji, ti)
    assert not torch.equal(before.ids, ti.ids)  # the input was not modified
    assert (ti.counts <= 128).all()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tombstone_stale_and_compaction_match_reference(variant):
    ji, ti = _indexes(variant)
    rng = np.random.default_rng(7)
    cl = rng.integers(0, KC, 60).astype(np.int32)
    sl = rng.integers(0, 100, 60).astype(np.int32)
    cl[:2], sl[:2] = [KC + 3, 1], [0, 5000]  # out of range: ignored
    ji = jup.tombstone(ji, jnp.asarray(cl[2:]), jnp.asarray(sl[2:]))
    ti = tup.tombstone(ti, cl, sl)
    _assert_same_index(ji, ti)
    np.testing.assert_array_equal(np.asarray(jup.stale_counts(ji)),
                                  tup.stale_counts(ti).numpy())
    assert tup.stale_counts(ti).sum() > 0
    jc = jup.compact_cluster(ji, 2)
    tc = tup.compact_cluster(ti, 2)
    _assert_same_index(jc, tc)
    ji, jn = jup.compact_stale(ji, threshold=3)
    ti, tn = tup.compact_stale(ti, threshold=3)
    assert tn == jn > 0
    _assert_same_index(ji, ti)
    np.testing.assert_array_equal(np.asarray(jup.stale_counts(ji)),
                                  tup.stale_counts(ti).numpy())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resync_partitions(variant):
    """Sub-partitions attached from one reference build: after the same
    tombstones and adds in a parent, the port's resync rebuilds the sub
    rows and the catalog exactly as the reference's; an index without
    sub-partitions passes through."""
    from repro.core import partitions as jpart
    from repro_torch.core import partitions as tpart

    ji, ti = _indexes(variant, vpad=160)
    assert tup.resync_partitions(ti) is ti
    jb = jpart.build_partitions(ji, attrs=[0], base_windows=4, max_depth=2)
    tb = tpart.build_from_arrays(
        {f: getattr(jb.catalog, f) for f in tpart.CATALOG_FIELDS},
        jb.catalog.n_base, jb.records, jb.vpads)
    ja, ta = jpart.attach(ji, jb), tpart.attach(ti, tb)
    parent = int(tb.catalog.parent[0])
    jo = jup.tombstone(ja, jnp.full(6, parent), jnp.arange(6))
    to = tup.tombstone(ta, torch.full((6,), parent), torch.arange(6))
    _, core, attrs, _ = _data(seed=4, n=12)
    jo, _ = jup.add_vectors(jo, jnp.asarray(core), jnp.asarray(attrs),
                            jnp.arange(N, N + 12))
    to, _ = tup.add_vectors(to, core, attrs, torch.arange(N, N + 12))
    jo.partitions, to.partitions = ja.partitions, ta.partitions
    jo, to = jup.resync_partitions(jo), tup.resync_partitions(to)
    for f in tpart.CATALOG_FIELDS:
        np.testing.assert_array_equal(getattr(jo.partitions, f),
                                      getattr(to.partitions, f), err_msg=f)
    assert (to.partitions.sub_counts != tb.catalog.sub_counts).any()
    _assert_same_index(jo, to, norms_rtol=1e-6)
