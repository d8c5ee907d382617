"""The port's bound-driven termination against the JAX package's, on the
same numpy inputs.

The index is the reference's own termination fixture: near-duplicate
cluster pairs with near-orthogonal pairs between them, so a query's
bounds on the other pairs' clusters fall below its running kth and the
provable drops fire.  ``termination="exact"`` must return the untruncated
search's ids and scores bit for bit, on the RAM and disk tiers, with a live
delta and over routed sub-partition slots; its ``n_scanned`` and
``n_passed`` are no higher (a dropped probe's rows are not scanned).
Against the reference: ids and counters exact, scores within rtol 1e-5
(l2 scores, differences of unit-size terms, also within atol 1e-6), the
termination state (bounds, masses, the bound-ordered slot tables) within
rtol 1e-5 in f64, the dropped-pair counts equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import given, needs_hypothesis, settings, st

from repro.core import delta as jdelta
from repro.core import disk as jdisk
from repro.core import engine as jeng
from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import probes as jp
from repro.core import storage as js
from repro.kernels.filtered_scan.filtered_scan import (
    fold_running_topk as jfold,
)
from repro_torch.core import delta as tdelta
from repro_torch.core import disk as tdisk
from repro_torch.core import engine as teng
from repro_torch.core import filters as tf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import partitions as tpart
from repro_torch.core import probes as tp
from repro_torch.core import storage as ts
from repro_torch.core.topk import masked_topk
from repro_torch.kernels.filtered_scan.filtered_scan import (
    fold_running_topk as tfold,
)

N, D, M = 1536, 32, 6
KC = 16
TS_RANGE = 6000
K, NP, QB = 10, 4, 8


def _twin_data():
    """Twin-pair topics (see the reference's ``tests/test_termination.py``):
    attr0 a topic-owned time band, attr1 the topic id, planted rows that
    pin every cluster's summary to the full range."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal((KC // 2, D)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    step = rng.standard_normal((KC // 2, D)).astype(np.float32)
    step /= np.linalg.norm(step, axis=-1, keepdims=True)
    centers = np.empty((KC, D), np.float32)
    centers[0::2] = base
    twin = base + 0.25 * step
    centers[1::2] = twin / np.linalg.norm(twin, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.05 * rng.standard_normal((N, D)).astype(
        np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    band_of = rng.permutation(KC)
    band = TS_RANGE // KC
    tstamp = band_of[topic] * band + rng.integers(0, band, N)
    cat = topic.copy()
    bin_ts = (np.arange(KC) * (TS_RANGE - 1)) // (KC - 1)
    for t in range(KC):
        rows = np.where(topic == t)[0]
        tstamp[rows[:KC]] = bin_ts
        cat[rows[KC:3 * KC]] = np.repeat(np.arange(KC), 2)
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    attrs[:, 0] = tstamp.astype(np.int16)
    attrs[:, 1] = cat.astype(np.int16)
    return centers, core, attrs, topic.astype(np.int32), band_of


def _indexes(metric, quantized=False):
    centers, core, attrs, topic, _ = _twin_data()
    jspec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jnp.float32,
                           metric=metric)
    tspec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32,
                           metric=metric)
    ji, _ = jivf.build_from_assignments(
        jspec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic))
    ti, _ = tivf.build_from_assignments(tspec, centers, core, attrs, topic,
                                        device="cpu")
    if quantized:
        ji, ti = jivf.quantize_index(ji), tivf.quantize_index(ti)
    return ji, ti


def _stream(q, seed=17, selectivity=0.03):
    """Tight queries on three hot topics, a thin attr0 window inside the
    topic's band and attr1 == topic."""
    centers, _, _, _, band_of = _twin_data()
    rng = np.random.default_rng(seed)
    band = TS_RANGE // KC
    w = max(int(selectivity * TS_RANGE), 1)
    pairs = rng.permutation(KC // 2)[:3]
    hot = 2 * pairs + rng.integers(0, 2, 3)
    topics = hot[rng.integers(0, 3, q)]
    qs = (centers[topics]
          + 0.01 * rng.standard_normal((q, D))).astype(np.float32)
    lo = np.full((q, 1, M), -32768, np.int16)
    hi = np.full((q, 1, M), 32767, np.int16)
    start = band_of[topics] * band + rng.integers(0, max(band - w, 1), q)
    lo[:, 0, 0] = start
    hi[:, 0, 0] = start + w - 1
    lo[:, 0, 1] = hi[:, 0, 1] = topics
    return qs, lo, hi


def _jq(qs, lo, hi):
    return jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo),
                                          hi=jnp.asarray(hi))


def _tq(qs, lo, hi):
    return torch.from_numpy(qs), tf.FilterSpec(lo=torch.from_numpy(lo),
                                               hi=torch.from_numpy(hi))


_INDEXES = {}


def _cached_indexes(metric, quantized=False):
    key = (metric, quantized)
    if key not in _INDEXES:
        _INDEXES[key] = _indexes(metric, quantized)
    return _INDEXES[key]


@pytest.fixture(scope="module", params=["dot", "l2"])
def built(request, tmp_path_factory):
    """(metric, jax index, port index, checkpoint the JAX package wrote)."""
    ji, ti = _cached_indexes(request.param)
    ckpt = str(tmp_path_factory.mktemp(f"term_{request.param}"))
    js.save_index(ji, ckpt, n_shards=2)
    return request.param, ji, ti, ckpt


def _assert_bitwise(base, term, msg=""):
    np.testing.assert_array_equal(base.ids.numpy(), term.ids.numpy(),
                                  err_msg=msg)
    np.testing.assert_array_equal(base.scores.numpy(), term.scores.numpy(),
                                  err_msg=msg)
    # a dropped probe's rows are never scanned, so they count neither as
    # scanned nor as passing (the reference's accounting)
    assert (term.n_passed <= base.n_passed).all(), msg
    assert (term.n_scanned <= base.n_scanned).all(), msg


def _assert_same(want, got, msg=""):
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy(),
                                  err_msg=msg)
    np.testing.assert_allclose(np.asarray(want.scores), got.scores.numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=msg)
    for c in ("n_scanned", "n_passed", "n_pruned"):
        np.testing.assert_array_equal(np.asarray(getattr(want, c)),
                                      getattr(got, c).numpy(), err_msg=c)


# ---- the primitives ----


@pytest.mark.parametrize("seed", range(3))
def test_bound_order_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n_tiles, u_cap, qpad, w = 3, 12, 24, 5
    sc = rng.integers(0, 40, n_tiles * u_cap).astype(np.int32)
    nu = rng.integers(0, u_cap + 1, n_tiles).astype(np.int32)
    sop = (rng.integers(0, u_cap, (qpad, w))
           + (np.arange(qpad) // 8 % n_tiles)[:, None] * u_cap).astype(
        np.int32)
    bound = rng.standard_normal((n_tiles, u_cap)).astype(np.float32)
    bound[:, 3] = bound[:, 5]  # a tie: the stable order keeps position
    want = jp.bound_order(sc, nu, sop, bound, u_cap)
    got = tp.bound_order(torch.from_numpy(sc), nu, sop, bound, u_cap)
    for w_, g in zip(want, got):
        np.testing.assert_array_equal(w_, g)


@pytest.mark.parametrize("k", [1, 4, 10])
def test_fold_running_topk_matches_reference(k):
    rng = np.random.default_rng(k)
    s, qb = 6, 8
    svals = np.round(rng.standard_normal((s, qb, k)), 1).astype(np.float32)
    sids = rng.integers(0, 1000, (s, qb, k)).astype(np.int32)
    run_v = np.sort(np.round(rng.standard_normal((qb, k)), 1))[:, ::-1]
    run_v = np.ascontiguousarray(run_v).astype(np.float32)
    run_v[0] = -3.0e38  # an empty running list
    run_i = rng.integers(0, 1000, (qb, k)).astype(np.int32)
    alive = rng.random((qb, s)) < 0.6
    wv, wi = jfold(jnp.asarray(run_v), jnp.asarray(run_i),
                   jnp.asarray(svals), jnp.asarray(sids), jnp.asarray(alive),
                   k=k)
    gv, gi = tfold(*(torch.from_numpy(a) for a in
                     (run_v, run_i, svals, sids, alive)), k=k)
    np.testing.assert_array_equal(np.asarray(wv), gv.numpy())
    np.testing.assert_array_equal(np.asarray(wi), gi.numpy())


def test_scan_pads_lists_longer_than_the_block():
    """k above a block's height (a routed tile of short records): the
    list past Vpad is (NEG_INF, -1), as the reference kernel leaves it."""
    from repro.kernels.filtered_scan.filtered_scan import (
        filtered_scan_tiled as jscan,
    )
    from repro_torch.kernels.filtered_scan.filtered_scan import (
        filtered_scan_tiled as tscan,
    )

    rng = np.random.default_rng(0)
    kc, vpad, qb = 3, 16, 8
    vec = rng.standard_normal((kc, vpad, D)).astype(np.float32)
    attrs = rng.integers(0, 4, (kc, vpad, M)).astype(np.int16)
    ids = np.arange(kc * vpad, dtype=np.int32).reshape(kc, vpad)
    ids[1, 10:] = -1
    qs = rng.standard_normal((qb, D)).astype(np.float32)
    lo = np.full((qb, 1, M), -32768, np.int16)
    hi = np.full((qb, 1, M), 32767, np.int16)
    hi[:, 0, 2] = 1
    sc = np.array([0, 1, 2], np.int32)
    st_ = np.zeros(3, np.int32)
    want = jscan(*(jnp.asarray(a) for a in (sc, st_, qs, lo, hi, vec, attrs,
                                           ids)), k=24, q_block=qb,
                 v_block=16, interpret=True)
    got = tscan(*(torch.from_numpy(a) for a in (sc, st_)), None,
                *(torch.from_numpy(a) for a in (qs, lo, hi, vec, attrs, ids)),
                k=24, q_block=qb)
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())
    np.testing.assert_allclose(np.asarray(want[0]), got[0].numpy(),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(want[2]), got[2].numpy())
    assert (got[1][:, :, vpad:] == -1).all()


# ---- the termination state ----


def test_term_state_matches_reference(built):
    """The plan's bounds, masses and best-bound-first slot tables equal the
    reference's (compared in f64, rtol 1e-5: the bounds are two packages'
    f32 sums)."""
    metric, ji, ti, _ = built
    qs, lo, hi = _stream(21)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on",
              termination="bounded", epsilon=0.05)
    jplan = jeng.SearchEngine(ji, backend="xla", **kw).plan(*_jq(qs, lo, hi))
    tplan = teng.SearchEngine(ti, device="cpu", **kw).plan(*_tq(qs, lo, hi))
    jt, tt = jplan.term, tplan.term
    assert (tt.epsilon, tt.seg, tt.n_seg, tt.cap) == (
        jt.epsilon, jt.seg, jt.n_seg, jt.cap)
    np.testing.assert_array_equal(jt.valid, tt.valid)
    for f in ("ub", "lb", "mass"):
        a, b = getattr(jt, f), getattr(tt, f)
        assert a.dtype == b.dtype, f  # ub, lb f64; mass the summaries' f32
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for f in ("slot_cluster", "slot_of_probe", "probe_ok", "n_unique"):
        np.testing.assert_array_equal(np.asarray(getattr(jplan, f)),
                                      np.asarray(getattr(tplan, f)),
                                      err_msg=f)


# ---- termination="exact": the untruncated result ----


@pytest.mark.parametrize("variant", ["dot-f32", "l2-f32", "dot-sq8"])
@pytest.mark.parametrize("prune", ["off", "on"])
@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_exact_identity_ram(variant, prune, pipeline):
    """(SQ8 with l2 is not a pair the scan kernels take.)"""
    metric, kind = variant.split("-")
    ji, ti = _cached_indexes(metric, kind == "sq8")
    qs, lo, hi = _stream(21)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune=prune, pipeline=pipeline)
    base = teng.SearchEngine(ti, device="cpu", **kw)
    term = teng.SearchEngine(ti, device="cpu", termination="exact", **kw)
    r0, r1 = base.search(*_tq(qs, lo, hi)), term.search(*_tq(qs, lo, hi))
    _assert_bitwise(r0, r1, f"{variant} prune={prune} pipe={pipeline}")
    assert term.stats.probes_terminated > 0, "provable exits never fired"
    if pipeline == "off":
        je = jeng.SearchEngine(ji, backend="xla", termination="exact", **kw)
        _assert_same(je.search(*_jq(qs, lo, hi)), r1, "vs the reference")
        for c in ("probes_terminated", "term_segments_skipped",
                  "tiles_scanned"):
            assert getattr(term.stats, c) == getattr(je.stats, c), c


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("prune", ["off", "on"])
def test_exact_identity_disk(built, prune, pipeline):
    """The disk tier, over the checkpoint's own bounds."""
    metric, ji, ti, ckpt = built
    qs, lo, hi = _stream(21)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune=prune, pipeline=pipeline)
    with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
        assert disk.bounds is not None
        base = teng.SearchEngine(disk, device="cpu", **kw)
        term = teng.SearchEngine(disk, device="cpu", termination="exact", **kw)
        r0, r1 = base.search(*_tq(qs, lo, hi)), term.search(*_tq(qs, lo, hi))
        _assert_bitwise(r0, r1, f"disk prune={prune} pipe={pipeline}")
        assert term.stats.probes_terminated > 0
        base.close()
        term.close()
    if pipeline == "off":
        with jdisk.DiskIVFIndex.open(ckpt) as jd:
            je = jeng.SearchEngine(jd, backend="xla", termination="exact",
                                   **kw)
            _assert_same(je.search(*_jq(qs, lo, hi)), r1, "disk vs reference")
            assert je.stats.probes_terminated == term.stats.probes_terminated


def test_exact_identity_delta_live(built, tmp_path):
    """A live delta tier (adds, cold and delta tombstones): the fold runs
    after the terminated scan and keeps the identity."""
    metric, ji, ti, ckpt = built
    centers, _, _, topic, _ = _twin_data()
    rng = np.random.default_rng(11)
    add = (centers[rng.integers(0, KC, 48)]
           + 0.05 * rng.standard_normal((48, D))).astype(np.float32)
    add /= np.linalg.norm(add, axis=-1, keepdims=True)
    add_attrs = rng.integers(0, TS_RANGE, (48, M)).astype(np.int16)
    dead = rng.choice(N, 32, replace=False)
    qs, lo, hi = _stream(21)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on")
    with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk, \
            jdisk.DiskIVFIndex.open(ckpt) as jd:
        for d, mod in ((disk, tdelta), (jd, jdelta)):
            d.delta = mod.DeltaTier.for_index(d, 8.0)
            d.delta.add(add, add_attrs, np.arange(N, N + 48, dtype=np.int64))
            d.delta.tombstone(dead, clusters=topic[dead])
            d.delta.tombstone(np.arange(N, N + 5, dtype=np.int64))
        base = teng.SearchEngine(disk, device="cpu", **kw)
        term = teng.SearchEngine(disk, device="cpu", termination="exact", **kw)
        r0, r1 = base.search(*_tq(qs, lo, hi)), term.search(*_tq(qs, lo, hi))
        _assert_bitwise(r0, r1, "delta live")
        assert term.stats.probes_terminated > 0
        je = jeng.SearchEngine(jd, backend="xla", termination="exact", **kw)
        _assert_same(je.search(*_jq(qs, lo, hi)), r1, "delta vs reference")


@pytest.mark.parametrize("store", ["ram", "disk"])
def test_exact_identity_routed_slots(built, store, tmp_path):
    """Routed sub-partition slots are bounded by their parent's row
    (``to_base``): the terminated routed search equals the untruncated
    routed and flat searches."""
    metric, ji, ti, _ = built
    build = tpart.build_partitions(ti, attrs=[1])
    assert build.n_subs > 0
    if store == "ram":
        idx = tpart.attach(ti, build)
    else:
        ts.save_index(ti, str(tmp_path), n_shards=2, layout=4,
                      partitions=build)
        idx = tdisk.DiskIVFIndex.open(str(tmp_path), device="cpu")
    qs, lo, hi = _stream(21)
    lo[:, 0, 0], hi[:, 0, 0] = -32768, 32767  # route on attr1 alone
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on")
    flat = teng.SearchEngine(idx, device="cpu", partitions="off", **kw)
    base = teng.SearchEngine(idx, device="cpu", **kw)
    term = teng.SearchEngine(idx, device="cpu", termination="exact", **kw)
    r_flat = flat.search(*_tq(qs, lo, hi))
    r0, r1 = base.search(*_tq(qs, lo, hi)), term.search(*_tq(qs, lo, hi))
    _assert_bitwise(r0, r1, f"{store} routed")
    np.testing.assert_array_equal(r_flat.ids.numpy(), r1.ids.numpy())
    np.testing.assert_array_equal(r_flat.scores.numpy(), r1.scores.numpy())
    assert term.stats.partition_hits == 21
    assert term.stats.probes_terminated > 0
    if store == "disk":
        idx.close()


# ---- termination="bounded" ----


def _over_kept(index, qs, lo, hi, plan, k):
    """Exact filtered top-k of each query over the rows of the probes whose
    fragments its merge kept (``plan.term.kept``)."""
    from repro_torch.core import FilterSpec, filter_mask

    sc = torch.as_tensor(np.asarray(plan.slot_cluster)).long()
    sop = torch.as_tensor(np.asarray(plan.slot_of_probe)).long()
    kept = torch.as_tensor(plan.term.kept)
    vals, ids = [], []
    for i in range(qs.shape[0]):
        cl = sc[sop[i][kept[i]]]
        m = index.ids[cl] >= 0
        m &= filter_mask(FilterSpec(lo=torch.from_numpy(lo[i:i + 1]),
                                    hi=torch.from_numpy(hi[i:i + 1])),
                         index.attrs[cl][None])[0]
        s = torch.einsum("cvd,d->cv", index.vectors[cl].float(),
                         torch.from_numpy(qs[i]))
        if index.scales is not None:
            s = s * index.scales[cl]
        if index.spec.metric == "l2":
            s = 2.0 * s - index.norms[cl] - float((qs[i] ** 2).sum())
        v, j = masked_topk(s.reshape(1, -1), m.reshape(1, -1), k,
                           ids=index.ids[cl].reshape(1, -1))
        vals.append(v[0])
        ids.append(j[0])
    return torch.stack(vals), torch.stack(ids)


@pytest.mark.parametrize("epsilon", [0.02, 0.2])
def test_bounded_drops_match_reference(built, epsilon):
    """The same pairs are dropped as the reference's at the same ε (the
    same counts and results), and the result is the exact top-k over the
    probes the merge kept."""
    metric, ji, ti, _ = built
    qs, lo, hi = _stream(21)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on",
              termination="bounded", epsilon=epsilon)
    te = teng.SearchEngine(ti, device="cpu", **kw)
    je = jeng.SearchEngine(ji, backend="xla", **kw)
    plan = te.plan(*_tq(qs, lo, hi))
    got = te.execute(plan)
    want = je.search(*_jq(qs, lo, hi))
    _assert_same(want, got, f"bounded eps={epsilon}")
    for c in ("probes_terminated", "term_segments_skipped"):
        assert getattr(te.stats, c) == getattr(je.stats, c), c
    vals, ids = _over_kept(ti, qs, lo, hi, plan, K)
    np.testing.assert_array_equal(ids.numpy(), got.ids.numpy())
    np.testing.assert_allclose(vals.numpy(), got.scores.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert (plan.term.kept <= np.asarray(plan.probe_ok)).all()


# ---- soundness ----


def test_bounds_sound_vs_bruteforce(built):
    """Each (query, cluster) upper bound dominates the true max stored
    score, over the port's own bounds."""
    metric, _, ti, _ = built
    eng = teng.SearchEngine(ti, device="cpu", k=K, n_probes=NP, q_block=QB,
                            termination="exact")
    bounds = eng._resolve_bounds()
    radius = bounds.radius.double().numpy()
    slack = bounds.slack.double().numpy()
    vec = ti.vectors.double().numpy()
    live = ti.ids.numpy() >= 0
    C = ti.centroids.double().numpy()
    qs, _, _ = _stream(8)
    for q in qs.astype(np.float64):
        for c in range(KC):
            rows = vec[c][live[c]]
            if metric == "dot":
                true_max = float(np.max(rows @ q))
                ub = float(q @ C[c]) + float(np.linalg.norm(q)) * radius[c]
            else:
                true_max = float(np.max(2.0 * rows @ q
                                        - np.sum(rows * rows, axis=-1)))
                near = max(float(np.linalg.norm(q - C[c])) - radius[c], 0.0)
                ub = float(q @ q) - near * near + slack[c]
            assert true_max <= ub + 1e-3 + 1e-4 * abs(ub), (c, true_max, ub)


def test_dropped_probe_never_held_topk(built):
    """Across random selective streams (drops firing every batch) the
    terminated engine returns the untruncated engine's results."""
    metric, _, ti, _ = built
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on")
    base = teng.SearchEngine(ti, device="cpu", **kw)
    term = teng.SearchEngine(ti, device="cpu", termination="exact", **kw)
    for seed in range(5):
        qs, lo, hi = _stream(16, seed=100 + seed)
        _assert_bitwise(base.search(*_tq(qs, lo, hi)),
                        term.search(*_tq(qs, lo, hi)), f"seed={seed}")
    assert term.stats.probes_terminated > 0


def _recall(base_ids, ids):
    hit = sum(len(set(a.tolist()) & set(b.tolist()))
              for a, b in zip(base_ids.numpy(), ids.numpy()))
    return hit / base_ids.numel()


@pytest.fixture(scope="module")
def dot_index():
    return _cached_indexes("dot")[1]


@needs_hypothesis
@settings(max_examples=6, deadline=None)
@given(e1=st.floats(0.0, 0.4), e2=st.floats(0.0, 0.4),
       seed=st.integers(0, 2**16))
def test_recall_monotone_in_epsilon(dot_index, e1, e2, seed):
    """A growing ε drops a superset of pairs (the decision is made once, at
    the first boundary, from an ε-independent kth), so recall against the
    untruncated search does not rise."""
    lo_e, hi_e = sorted((e1, e2))
    qs, lo, hi = _stream(16, seed=seed)
    kw = dict(k=K, n_probes=NP, q_block=QB, prune="on")
    r0 = teng.SearchEngine(dot_index, device="cpu", **kw).search(
        *_tq(qs, lo, hi))
    recalls = []
    for eps in (lo_e, hi_e):
        eng = teng.SearchEngine(dot_index, device="cpu",
                                termination="bounded", epsilon=eps, **kw)
        recalls.append(_recall(r0.ids, eng.search(*_tq(qs, lo, hi)).ids))
    assert recalls[1] <= recalls[0] + 1e-12, (lo_e, hi_e, recalls)


def test_terminated_scan_signatures_bounded(dot_index):
    """After the first batch, varied streams of the same shape add no scan
    signature (segment widths come from a bounded set)."""
    eng = teng.SearchEngine(dot_index, device="cpu", k=K, n_probes=NP,
                            q_block=QB, prune="on", termination="bounded",
                            epsilon=0.01)
    eng.search(*_tq(*_stream(16, seed=900)))
    warm = teng.scan_compile_count()
    for seed in range(901, 907):
        eng.search(*_tq(*_stream(16, seed=seed,
                                 selectivity=0.03 if seed % 2 else 0.08)))
    assert teng.scan_compile_count() == warm


def test_termination_knobs_and_metrics(built):
    metric, ji, ti, _ = built
    kw = dict(k=K, n_probes=NP, q_block=QB)
    for bad in (dict(termination="fast"), dict(epsilon=0.1),
                dict(termination="bounded", epsilon=1.0)):
        with pytest.raises(ValueError):
            teng.SearchEngine(ti, device="cpu", **kw, **bad)
        with pytest.raises(ValueError):
            jeng.SearchEngine(ji, backend="xla", **kw, **bad)
    qs, lo, hi = _stream(16)
    te = teng.SearchEngine(ti, device="cpu", termination="exact", **kw)
    je = jeng.SearchEngine(ji, backend="xla", termination="exact", **kw)
    te.search(*_tq(qs, lo, hi))
    je.search(*_jq(qs, lo, hi))
    want, got = je.metrics(), te.metrics()
    for key in ("engine.probes_terminated", "engine.term_segments_skipped"):
        assert got[key] == want[key] > -1, key
    assert set(got) == set(want)
    assert "# TYPE repro_engine_probes_terminated counter" in te.metrics_text()
