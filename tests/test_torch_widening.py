"""Adaptive probe widening (``t_max``) in the port against the JAX package:
``filters.selectivity``, ``summaries.expected_passing``, the widened branch
of ``plan_fused_tiled``, ``t_max="auto"``'s per-batch resolution and the
engine with ``t_max`` on both executors and both tiers.

Slot tables, ``probe_ok``, the geometric probe sets, selectivities, ids and
counters are exact; scores agree within rtol 1e-5 (f32 sums taken in
another order).  The sampled selectivity draws its rows from a torch
generator, which the reference's numpy stream cannot reproduce: the test
hands the port's sample rows to the reference's exact mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import disk as jdisk
from repro.core import engine as jeng
from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import storage as js
from repro.core import summaries as jsum
from repro_torch.core import disk as tdisk
from repro_torch.core import engine as teng
from repro_torch.core import filters as tf
from repro_torch.core import ivf as tivf
from repro_torch.core import search as tsearch
from repro_torch.core import summaries as tsum

N, D, M, KC, TS = 3000, 24, 3, 24, 2400


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.3 * rng.standard_normal((N, D)).astype(np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    attrs[:, 0] = topic * (TS // KC) + rng.integers(0, TS // KC, N)
    return centers, core, attrs, topic.astype(np.int32)


def _indexes(metric="dot"):
    centers, core, attrs, topic = _data()
    jspec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jnp.float32,
                           metric=metric)
    ji, _ = jivf.build_from_assignments(
        jspec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic))
    arrays = {f: np.asarray(getattr(ji, f)) for f in (
        "centroids", "vectors", "attrs", "ids", "counts")}
    arrays["norms"] = None if ji.norms is None else np.asarray(ji.norms)
    for f in ("amin", "amax", "hist", "edges_lo", "edges_hi"):
        arrays[f] = np.asarray(getattr(ji.summaries, f))
    from repro_torch.core import hybrid as thy
    tspec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32,
                           metric=metric)
    return ji, tivf.index_from_arrays(arrays, tspec, device="cpu")


def _queries(q, filt, seed=1):
    """Queries near random topics; ``window``: a time window of
    ``width`` values per query (selective), ``mixed``: half windows, half
    match-all."""
    rng = np.random.default_rng(seed)
    centers = _data()[0]
    qs = (centers[rng.integers(0, KC, q)]
          + 0.3 * rng.standard_normal((q, D))).astype(np.float32)
    lo = np.full((q, 2, M), -32768, np.int16)
    hi = np.full((q, 2, M), 32767, np.int16)
    lo[:, 1], hi[:, 1] = 32767, -32768  # void spare term
    if filt in ("window", "narrow", "mixed"):
        width = 60 if filt == "narrow" else 240
        start = rng.integers(0, TS - width, q)
        rows = slice(None) if filt != "mixed" else slice(0, q // 2)
        lo[rows, 0, 0] = start[rows]
        hi[rows, 0, 0] = start[rows] + width - 1
    return qs, lo, hi


def _fs(lo, hi):
    return (jf.FilterSpec(lo=jnp.asarray(lo), hi=jnp.asarray(hi)),
            tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi)))


def _assert_same(jr, tr, counters=("n_scanned", "n_passed", "n_pruned")):
    np.testing.assert_array_equal(np.asarray(jr.ids), tr.ids.numpy())
    np.testing.assert_allclose(np.asarray(jr.scores), tr.scores.numpy(),
                               rtol=1e-5)
    for c in counters:
        np.testing.assert_array_equal(np.asarray(getattr(jr, c)),
                                      getattr(tr, c).numpy(), err_msg=c)


# ---- filters.selectivity ----


@pytest.mark.parametrize("chunk", [7, 4096])
@pytest.mark.parametrize("filt", ["window", "narrow", "mixed", "match_all"])
def test_selectivity_exact_matches_reference(filt, chunk):
    _, _, attrs, _ = _data()
    _, lo, hi = _queries(13, filt)
    jfs, tfs = _fs(lo, hi)
    want = np.asarray(jf.selectivity(jfs, jnp.asarray(attrs), chunk=chunk))
    got = tf.selectivity(tfs, torch.from_numpy(attrs), chunk=chunk)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("sample_size", [1, 500, 2999])
def test_selectivity_sampled_matches_reference_on_the_same_rows(sample_size):
    _, _, attrs, _ = _data()
    _, lo, hi = _queries(9, "mixed")
    jfs, tfs = _fs(lo, hi)
    rows = tf.sample_rows(N, sample_size, seed=3).numpy()
    assert len(set(rows.tolist())) == sample_size  # distinct rows
    want = np.asarray(jf.selectivity(jfs, jnp.asarray(attrs[rows])))
    got = tf.selectivity(tfs, torch.from_numpy(attrs),
                         sample_size=sample_size, seed=3, chunk=64)
    np.testing.assert_array_equal(want, got.numpy())
    # a sample at least N wide is the exact mode
    np.testing.assert_array_equal(
        tf.selectivity(tfs, torch.from_numpy(attrs), sample_size=N).numpy(),
        np.asarray(jf.selectivity(jfs, jnp.asarray(attrs))))


# ---- summaries.expected_passing, auto t_max ----


@pytest.mark.parametrize("filt", ["window", "narrow", "mixed", "match_all"])
def test_expected_passing_matches_reference(filt):
    ji, ti = _indexes()
    _, lo, hi = _queries(11, filt)
    lo[3, 1], hi[3, 1] = 0, 5  # a second live term on one query
    counts = np.asarray(ji.counts).copy()
    counts[2] = 0  # an empty cluster
    want = np.asarray(jsum.expected_passing(
        ji.summaries, jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(counts)))
    got = tsum.expected_passing(ti.summaries, torch.from_numpy(lo),
                                torch.from_numpy(hi), torch.from_numpy(counts))
    np.testing.assert_allclose(want, got.numpy(), rtol=1e-6)
    fw = np.asarray(jeng._batch_pass_fraction(
        ji.summaries, jnp.asarray(counts), jnp.asarray(lo), jnp.asarray(hi)))
    fg = teng._batch_pass_fraction(ti.summaries, torch.from_numpy(counts),
                                   torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_allclose(fw, fg.numpy(), rtol=1e-6)


@pytest.mark.parametrize("n_probes", [2, 3, 5])
@pytest.mark.parametrize("filt", ["window", "narrow", "mixed", "match_all"])
def test_resolve_auto_t_max_matches_reference(filt, n_probes):
    ji, ti = _indexes()
    _, lo, hi = _queries(16, filt, seed=4)
    want = jeng.resolve_auto_t_max(ji.summaries, ji.counts, jnp.asarray(lo),
                                   jnp.asarray(hi), n_probes, KC)
    got = teng.resolve_auto_t_max(ti.summaries, ti.counts,
                                  torch.from_numpy(lo), torch.from_numpy(hi),
                                  n_probes, KC)
    assert got == want
    if filt == "narrow":
        assert got is not None  # a selective batch widens
    assert teng.resolve_auto_t_max(None, ti.counts, torch.from_numpy(lo),
                                   torch.from_numpy(hi), n_probes, KC) is None
    assert teng.AUTO_T_FACTORS == jeng.AUTO_T_FACTORS


# ---- the widened plan ----


@pytest.mark.parametrize("t_max", [None, 6, 12, KC])
@pytest.mark.parametrize("filt", ["window", "narrow", "match_all"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_plan_matches_reference(metric, filt, t_max):
    ji, ti = _indexes(metric)
    qs, lo, hi = _queries(21, filt, seed=2)
    n_probes, qb = 3, 8
    width = n_probes if t_max is None else t_max
    kw = dict(metric=metric, n_probes=n_probes, q_block=qb,
              u_cap=min(qb * width, KC), t_max=t_max)
    want = jeng.plan_fused_tiled(
        ji.centroids, ji.counts, jnp.asarray(qs), jnp.asarray(lo),
        jnp.asarray(hi), cast_dtype=np.dtype(np.float32),
        summaries=ji.summaries, **kw)
    got = teng.plan_fused_tiled(
        ti.centroids, ti.counts, torch.from_numpy(qs), torch.from_numpy(lo),
        torch.from_numpy(hi), cast_dtype=torch.float32,
        summaries=ti.summaries, **kw)
    assert len(got) == len(want) == 11
    names = ("slot_cluster", "slot_tile", "slot_of_probe", "probe_ok",
             "n_unique", "queries_pad", "lo_pad", "hi_pad", "n_pruned",
             "geo_probes", "geo_valid")
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=name)
    if t_max is not None and filt == "narrow":
        # pruned probes were refilled: more live probes than the static plan
        static = teng.plan_fused_tiled(
            ti.centroids, ti.counts, torch.from_numpy(qs),
            torch.from_numpy(lo), torch.from_numpy(hi),
            cast_dtype=torch.float32, summaries=ti.summaries,
            **{**kw, "t_max": None, "u_cap": min(qb * n_probes, KC)})
        assert got[3].sum() > static[3].sum()


def test_plan_without_summaries_ignores_t_max():
    ji, ti = _indexes()
    qs, lo, hi = _queries(10, "narrow")
    got = teng.plan_fused_tiled(
        ti.centroids, ti.counts, torch.from_numpy(qs), torch.from_numpy(lo),
        torch.from_numpy(hi), metric="dot", n_probes=3, q_block=8, u_cap=24,
        cast_dtype=torch.float32)
    want = jeng.plan_fused_tiled(
        ji.centroids, ji.counts, jnp.asarray(qs), jnp.asarray(lo),
        jnp.asarray(hi), metric="dot", n_probes=3, q_block=8, u_cap=24,
        cast_dtype=np.dtype(np.float32))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


# ---- the engine ----


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("t_max", [6, 12, "auto"])
@pytest.mark.parametrize("filt", ["narrow", "mixed", "match_all"])
def test_engine_t_max_matches_reference(filt, t_max, pipeline):
    ji, ti = _indexes()
    qs, lo, hi = _queries(37, filt, seed=6)
    jfs, tfs = _fs(lo, hi)
    kw = dict(k=8, n_probes=3, q_block=16, t_max=t_max, pipeline=pipeline)
    je = jeng.SearchEngine(ji, backend="xla", **kw)
    te = teng.SearchEngine(ti, device="cpu", **kw)
    jr = je.search(jnp.asarray(qs), jfs)
    tr = te.search(torch.from_numpy(qs), tfs)
    _assert_same(jr, tr)
    assert te.stats.last_u_cap == je.stats.last_u_cap
    te.close()
    je.close()


def test_widened_results_equal_reference_over_the_widened_probes():
    """The widened engine's answer is the exact filtered top-k over the
    probes its plan chose, and its recall against brute force is no lower
    than the static plan's."""
    _, ti = _indexes()
    qs, lo, hi = _queries(32, "narrow", seed=8)
    _, tfs = _fs(lo, hi)
    q = torch.from_numpy(qs)
    static = teng.SearchEngine(ti, k=8, n_probes=3, q_block=16, device="cpu")
    wide = teng.SearchEngine(ti, k=8, n_probes=3, q_block=16, t_max=12,
                             device="cpu")
    plan = wide.plan(q, tfs)
    got = wide.execute(plan)
    # the probes the plan kept, per query: exact top-k over their rows
    sop = torch.as_tensor(plan.slot_of_probe)[:32].long()
    ok = torch.as_tensor(plan.probe_ok)[:32]
    clusters = torch.as_tensor(plan.slot_cluster)[sop]
    for i in range(32):
        cl = clusters[i][ok[i]].long()
        rows_ok = ti.ids[cl] >= 0
        mask = rows_ok & tf.filter_mask(
            tf.FilterSpec(lo=tfs.lo[i:i + 1], hi=tfs.hi[i:i + 1]),
            ti.attrs[cl][None])[0]
        sc = (ti.vectors[cl].float() @ q[i])
        sc = torch.where(mask, sc, -3.0e38).reshape(-1)
        vals, idx = torch.sort(sc, descending=True, stable=True)
        ids = torch.full((8,), -1, dtype=torch.int32)
        top = min(8, vals.numel())  # a query may keep no probe at all
        ids[:top] = torch.where(vals[:top] > -1.5e38,
                                ti.ids[cl].reshape(-1)[idx[:top]], -1)
        np.testing.assert_array_equal(ids.numpy(), got.ids[i].numpy())
    _, core, attrs, _ = _data()
    oracle = tsearch.brute_force(torch.from_numpy(core),
                                 torch.from_numpy(attrs), q, tfs, k=8)
    r_wide = tsearch.recall_at_k(got, oracle)
    r_static = tsearch.recall_at_k(static.search(q, tfs), oracle)
    assert r_wide >= r_static


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    ji, _ = _indexes()
    ckpt = str(tmp_path_factory.mktemp("widen"))
    js.save_index(ji, ckpt, n_shards=2)
    jd = jdisk.DiskIVFIndex.open(ckpt)
    td = tdisk.DiskIVFIndex.open(ckpt, device="cpu")
    yield jd, td
    jd.close()
    td.close()


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("t_max", [12, "auto"])
def test_disk_tier_t_max_matches_reference(disk, t_max, pipeline):
    jd, td = disk
    qs, lo, hi = _queries(40, "narrow", seed=9)
    jfs, tfs = _fs(lo, hi)
    kw = dict(k=8, n_probes=3, q_block=16, t_max=t_max, pipeline=pipeline)
    je = jeng.SearchEngine(jd, backend="xla", **kw)
    te = teng.SearchEngine(td, device="cpu", **kw)
    try:
        _assert_same(je.search(jnp.asarray(qs), jfs),
                     te.search(torch.from_numpy(qs), tfs))
        assert te.stats.blocks_fetched == je.stats.blocks_fetched
    finally:
        je.close()
        te.close()


def test_t_max_validation():
    _, ti = _indexes()
    qs, lo, hi = _queries(8, "narrow")
    _, tfs = _fs(lo, hi)
    with pytest.raises(ValueError, match="t_max"):
        teng.SearchEngine(ti, k=5, n_probes=3, t_max="wide", device="cpu")
    with pytest.raises(ValueError, match="t_max"):
        teng.SearchEngine(ti, k=5, n_probes=3, t_max=2, device="cpu").search(
            torch.from_numpy(qs), tfs)
    # t_max == n_probes and prune="off" plan the static width
    for kw in (dict(t_max=3), dict(t_max=12, prune="off")):
        eng = teng.SearchEngine(ti, k=5, n_probes=3, device="cpu", **kw)
        assert eng.plan(torch.from_numpy(qs), tfs).width == 3
