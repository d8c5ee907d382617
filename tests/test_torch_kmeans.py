"""The port's index build against the JAX package's: synthetic data, the
hybrid helpers, k-means and ``build_ivf``.

The data generators are numpy in both packages and must be byte for byte
equal; the hybrid concat/split and the attribute encoders exact.  K-means
cannot share random streams across the two frameworks, so its steps and
loops are held against the reference's own ``lloyd_step`` /
``minibatch_step`` from the same state on the same batches: assignments
and counts exact on tie-free fixtures (the f64 top-two score gap of every
row above 1e-4, asserted), centroids and inertia at rtol 1e-5 (atol 1e-6
for coordinates near 0): ``index_add_`` and ``segment_sum`` sum in another
order.  ``build_ivf`` is held against ``build_from_assignments`` over its
own centroids in both packages, index arrays exact (the l2 norms, f32 sums
in another order, at rtol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import kmeans as jkm
from repro.data import pipeline as jdata
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import kmeans as tkm
from repro_torch.data import pipeline as tdata

N, D, KC, TOPICS = 2000, 16, 12, 12
GAP = 1e-4  # f64 top-two score gap every row must clear (tie-free)


def _topics(seed=0, n=N, noise=0.15, with_centers=False):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((TOPICS, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = rng.integers(0, TOPICS, n)
    x = centers[topic] + noise * rng.standard_normal((n, D)).astype(
        np.float32)
    x = (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
    return (x, centers) if with_centers else x


def _min_gap(x, c):
    """Smallest f64 gap between a row's best and second-best score."""
    s = 2.0 * x.astype(np.float64) @ c.astype(np.float64).T - np.sum(
        c.astype(np.float64) ** 2, -1)[None, :]
    top2 = np.sort(s, -1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


def _init(data_seed, seed=1):
    """Data and a tie-free start: each topic centre moved a little."""
    x, centers = _topics(data_seed, with_centers=True)
    rng = np.random.default_rng(seed)
    return x, (centers + 0.1 * rng.standard_normal(centers.shape)).astype(
        np.float32)


def _states(c0):
    js = jkm.KMeansState(centroids=jnp.asarray(c0),
                         counts=jnp.zeros((c0.shape[0],), jnp.float32),
                         step=jnp.zeros((), jnp.int32))
    ts = tkm.KMeansState(torch.from_numpy(c0.copy()),
                         torch.zeros(c0.shape[0]))
    return js, ts


def _close(a, b, msg=""):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                               atol=1e-6, err_msg=msg)


# ---- data ----


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_synthetic_embeddings_byte_identical(seed):
    for n, dim, kc in ((500, 16, 64), (37, 5, 3)):
        a = jdata.synthetic_embeddings(seed, n, dim, n_clusters=kc)
        b = tdata.synthetic_embeddings(seed, n, dim, n_clusters=kc)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("card", [None, [8], [2, 5, 300]])
@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_attributes_byte_identical(seed, card):
    a = jdata.synthetic_attributes(seed, 400, 4, cardinalities=card)
    b = tdata.synthetic_attributes(seed, 400, 4, cardinalities=card)
    assert a.dtype == b.dtype == np.int16 and a.tobytes() == b.tobytes()


def test_data_package_exports():
    import repro_torch.data as td

    assert td.synthetic_embeddings is tdata.synthetic_embeddings
    assert td.synthetic_attributes is tdata.synthetic_attributes


# ---- hybrid ----


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_concat_split_hybrid_exact(dtype):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(0)
    core = rng.standard_normal((50, 6)).astype(np.float32)
    attrs = rng.integers(-200, 200, (50, 3)).astype(np.int16)
    jspec = jhy.HybridSpec(dim=6, n_attrs=3, core_dtype=jd)
    tspec = thy.HybridSpec(dim=6, n_attrs=3, core_dtype=td)
    jh = jhy.concat_hybrid(jspec, core, attrs)
    th = thy.concat_hybrid(tspec, core, attrs, device="cpu")
    assert th.dtype == td and tuple(th.shape) == (50, 9)
    np.testing.assert_array_equal(np.asarray(jh, np.float32),
                                  th.float().numpy())
    jc, ja = jhy.split_hybrid(jspec, jh)
    tc, ta = thy.split_hybrid(tspec, th)
    np.testing.assert_array_equal(np.asarray(jc, np.float32),
                                  tc.float().numpy())
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    # the round trip: attrs small enough for the core dtype come back exact
    np.testing.assert_array_equal(ta.numpy(), attrs)
    with pytest.raises(ValueError):
        thy.split_hybrid(tspec, th[:, :8])


def test_encode_numeric_attr_exact():
    v = np.asarray([-5.0, 0.0, 0.25, 0.5, 1.0, 7.5, 10.0, 12.0, np.pi])
    for lo, hi in ((0.0, 10.0), (-1.0, 1.0), (2.0, 2.5)):
        np.testing.assert_array_equal(jhy.encode_numeric_attr(v, lo, hi),
                                      thy.encode_numeric_attr(v, lo, hi))
    out = thy.encode_numeric_attr(v, 0.0, 10.0)  # clipping at both ends
    assert out[0] == thy.ATTR_MIN and out[-2] == thy.ATTR_MAX
    with pytest.raises(ValueError):  # an empty range
        thy.encode_numeric_attr(v, 1.0, 1.0)
    with pytest.raises(ValueError):
        jhy.encode_numeric_attr(v, 1.0, 1.0)


def test_encode_categorical_attr_exact():
    vocab = {"red": 0, "green": 1, "blue": 7}
    vals = ["blue", "red", "red", "green"]
    np.testing.assert_array_equal(jhy.encode_categorical_attr(vals, vocab),
                                  thy.encode_categorical_attr(vals, vocab))
    with pytest.raises(KeyError):  # an unknown key
        thy.encode_categorical_attr(["mauve"], vocab)
    with pytest.raises(KeyError):
        jhy.encode_categorical_attr(["mauve"], vocab)
    big = {i: i for i in range(65537)}
    with pytest.raises(ValueError):
        thy.encode_categorical_attr([0], big)


# ---- k-means steps ----


def test_pairwise_and_assign_match_reference():
    x, c = _init(2)
    assert _min_gap(x, c) > GAP
    np.testing.assert_allclose(
        np.asarray(jkm.pairwise_neg_dist2(jnp.asarray(x), jnp.asarray(c))),
        tkm.pairwise_neg_dist2(torch.from_numpy(x), torch.from_numpy(c)),
        rtol=1e-5, atol=1e-6)
    want = np.asarray(jkm.assign(jnp.asarray(x), jnp.asarray(c), chunk=300))
    for chunk in (None, 300, 4096):
        np.testing.assert_array_equal(
            want, tkm.assign(torch.from_numpy(x), torch.from_numpy(c),
                             chunk=chunk).numpy())


@pytest.mark.parametrize("chunk", [N, 384])
def test_lloyd_step_matches_reference(chunk):
    x, c0 = _init(0)
    assert _min_gap(x, c0) > GAP
    js, ts = _states(c0)
    js1, jin = jkm.lloyd_step(js, jnp.asarray(x))
    ts1, tin = tkm.lloyd_step(ts, torch.from_numpy(x), chunk=chunk)
    np.testing.assert_array_equal(np.asarray(js1.counts), ts1.counts.numpy())
    _close(js1.centroids, ts1.centroids, "centroids")
    np.testing.assert_allclose(float(jin), float(tin), rtol=1e-5)
    assert ts1.step == int(js1.step) == 1


@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_ieee_f32_leaves_the_callers_precision(precision):
    """The port's f32 products (centroid scores, k-means) run under
    ``device.ieee_f32``: full f32 inside, nested and from several threads,
    and the caller's ``set_float32_matmul_precision`` (and the legacy
    ``allow_tf32`` flag it sets) as it found them after, the products equal
    to the reference's at any setting."""
    import threading

    from repro_torch.core.search import centroid_scores
    from repro_torch.device import ieee_f32

    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        before = (torch.get_float32_matmul_precision(),
                  torch.backends.cuda.matmul.allow_tf32)
        inside = []

        def work():
            with ieee_f32():
                with ieee_f32():
                    inside.append(torch.get_float32_matmul_precision())
                inside.append(torch.get_float32_matmul_precision())

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert inside == ["highest"] * 8
        x, c = _init(3)
        got = tkm.pairwise_neg_dist2(torch.from_numpy(x), torch.from_numpy(c))
        scores = centroid_scores(torch.from_numpy(c),
                                 torch.ones(c.shape[0]), torch.from_numpy(x),
                                 metric="dot")
        after = (torch.get_float32_matmul_precision(),
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        torch.set_float32_matmul_precision(saved)
    assert after == before and before[0] == precision
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jkm.pairwise_neg_dist2(jnp.asarray(x),
                                                        jnp.asarray(c))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scores.numpy(), x @ c.T, rtol=1e-5, atol=1e-5)


def test_ieee_f32_reaches_other_threads_and_keeps_their_setting():
    """``device.ieee_f32``'s reach across threads (PyTorch's precision
    setting is process-wide): while a block is open in another thread this
    one reads "highest", and its own setting comes back when the block
    closes; a setting this thread makes while the block is open is kept,
    not overwritten by the block's caller's."""
    import threading

    from repro_torch.device import ieee_f32

    opened, release = threading.Event(), threading.Event()

    def hold():
        with ieee_f32():
            opened.set()
            release.wait(30)

    def open_elsewhere():
        opened.clear()
        release.clear()
        thread = threading.Thread(target=hold)
        thread.start()
        assert opened.wait(30)
        return thread

    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        thread = open_elsewhere()
        during = torch.get_float32_matmul_precision()
        release.set()
        thread.join(timeout=30)
        after = torch.get_float32_matmul_precision()
        thread = open_elsewhere()
        torch.set_float32_matmul_precision("medium")
        release.set()
        thread.join(timeout=30)
        kept = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(saved)
    assert (during, after, kept) == ("highest", "high", "medium")


def test_lloyd_step_keeps_empty_centroids():
    x, c0 = _init(0)
    c0[3] = 100.0  # far from every row: gets no member
    js, ts = _states(c0)
    js1, _ = jkm.lloyd_step(js, jnp.asarray(x))
    ts1, _ = tkm.lloyd_step(ts, torch.from_numpy(x))
    assert float(ts1.counts[3]) == 0.0
    np.testing.assert_array_equal(ts1.centroids[3].numpy(), c0[3])
    _close(js1.centroids, ts1.centroids)


def test_minibatch_step_matches_reference():
    x, c0 = _init(1)
    js, ts = _states(c0)
    rng = np.random.default_rng(5)
    for i in range(4):
        idx = rng.integers(0, N, 256)
        assert _min_gap(x[idx], np.asarray(js.centroids)) > GAP
        js = jkm.minibatch_step(js, jnp.asarray(x[idx]))
        ts = tkm.minibatch_step(ts, torch.from_numpy(x[idx]))
        np.testing.assert_array_equal(np.asarray(js.counts),
                                      ts.counts.numpy(), err_msg=f"step {i}")
        _close(js.centroids, ts.centroids, f"step {i}")
    assert ts.step == int(js.step) == 4


def test_minibatch_loop_matches_reference_steps():
    """The port's loop helper against the reference's step looped, from the
    same state over the same index sequence."""
    x, c0 = _init(4, seed=2)
    js, ts = _states(c0)
    rng = np.random.default_rng(9)
    seq = [rng.integers(0, N, 128) for _ in range(30)]
    for idx in seq:
        assert _min_gap(x[idx], np.asarray(js.centroids)) > GAP
        js = jkm.minibatch_step(js, jnp.asarray(x[idx]))
    ts = tkm.run_minibatch(ts, torch.from_numpy(x),
                           [torch.from_numpy(i) for i in seq])
    np.testing.assert_array_equal(np.asarray(js.counts), ts.counts.numpy())
    _close(js.centroids, ts.centroids)
    assert ts.step == 30


def test_lloyd_loop_matches_reference_steps():
    x, c0 = _init(3, seed=4)
    js, ts = _states(c0)
    jtrace = []
    for _ in range(6):
        assert _min_gap(x, np.asarray(js.centroids)) > GAP
        js, inertia = jkm.lloyd_step(js, jnp.asarray(x))
        jtrace.append(float(inertia))
    ts, ttrace = tkm.run_lloyd(ts, torch.from_numpy(x), 6, chunk=512)
    np.testing.assert_array_equal(np.asarray(js.counts), ts.counts.numpy())
    _close(js.centroids, ts.centroids)
    np.testing.assert_allclose(jtrace, ttrace.numpy(), rtol=1e-5)
    assert ttrace.dtype == torch.float32 and ts.step == 6


def test_init_from_sample_distinct_and_replaced():
    x = torch.from_numpy(_topics(0))
    st = tkm.init_from_sample(torch.Generator().manual_seed(0), x, KC)
    rows = {tuple(r) for r in st.centroids.numpy().tolist()}
    assert len(rows) == KC  # n >= k: distinct rows
    assert st.centroids.dtype == torch.float32 and st.step == 0
    assert float(st.counts.abs().sum()) == 0.0
    small = x[:5]
    st = tkm.init_from_sample(torch.Generator().manual_seed(0), small, 16)
    rows = [tuple(r) for r in st.centroids.numpy().tolist()]
    assert len(set(rows)) <= 5 and len(rows) == 16  # n < k: rows reused
    assert set(rows) <= {tuple(r) for r in small.numpy().tolist()}


def test_minibatch_kmeans_reduces_inertia_like_reference():
    """The reference's own test, on the port, and the two final inertias
    within 10% of each other on the same data."""
    rng = np.random.default_rng(5)
    core = rng.standard_normal((1024, 8)).astype(np.float32)

    def inertia(x, c):
        x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
        s = 2 * x @ c.T - np.sum(c * c, -1)[None, :]
        return float(np.sum(np.sum(x * x, -1) - s.max(-1)))

    x = torch.from_numpy(core)
    st0 = tkm.init_from_sample(torch.Generator().manual_seed(2), x, 16)
    st = tkm.minibatch_kmeans(torch.Generator().manual_seed(2), x,
                              n_clusters=16, n_steps=50, batch_size=256)
    assert st.step == 50
    assert inertia(core, st.centroids) < inertia(core, st0.centroids) * 0.9
    jst = jkm.minibatch_kmeans(jax.random.key(2), jnp.asarray(core),
                               n_clusters=16, n_steps=50, batch_size=256)
    ref = inertia(core, jst.centroids)
    assert abs(inertia(core, st.centroids) - ref) <= 0.1 * ref


def test_kmeans_lloyd_trace_decreases():
    x = torch.from_numpy(_topics(6))
    st, trace = tkm.kmeans_lloyd(torch.Generator().manual_seed(0), x,
                                 n_clusters=KC, n_iters=5)
    assert trace.shape == (5,) and st.step == 5
    assert bool((trace[1:] <= trace[:-1] * (1 + 1e-6)).all())


# ---- build_ivf ----


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_same_index(ji, ti):
    for f in ("centroids", "vectors", "attrs", "ids", "counts"):
        t = getattr(ti, f)
        np.testing.assert_array_equal(
            _np(getattr(ji, f)),
            t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy(),
            err_msg=f)
    assert (ji.norms is None) == (ti.norms is None)
    if ji.norms is not None:
        np.testing.assert_allclose(np.asarray(ji.norms), ti.norms.numpy(),
                                   rtol=1e-6)
    for f in ("amin", "amax", "hist", "edges_lo", "edges_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(ji.summaries, f)),
                                      getattr(ti.summaries, f).numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("mode", ["minibatch", "lloyd"])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_build_ivf_matches_build_from_assignments(metric, mode):
    core = _topics(8)
    attrs = np.random.default_rng(8).integers(0, 9, (N, 3)).astype(np.int16)
    tspec = thy.HybridSpec(dim=D, n_attrs=3, core_dtype=torch.bfloat16,
                           metric=metric)
    jspec = jhy.HybridSpec(dim=D, n_attrs=3, core_dtype=jnp.bfloat16,
                           metric=metric)
    ti, tstats = tivf.build_ivf(
        torch.Generator().manual_seed(0), tspec, core, attrs, n_clusters=KC,
        kmeans_mode=mode, kmeans_steps=8, kmeans_batch=512,
        assign_chunk=700, device="cpu")
    assert tstats.kmeans_steps == 8 and tstats.n_dropped == 0
    ids = ti.ids.numpy()
    np.testing.assert_array_equal(np.sort(ids[ids >= 0]), np.arange(N))
    cent = ti.centroids.numpy()
    assert _min_gap(core, cent) > GAP
    # the port's own build over its centroids
    assign = tkm.assign(torch.from_numpy(core), ti.centroids)
    again, astats = tivf.build_from_assignments(tspec, cent, core, attrs,
                                                assign, device="cpu")
    for f in ("centroids", "vectors", "attrs", "ids", "counts", "norms"):
        a, b = getattr(ti, f), getattr(again, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), f
    assert dataclasses.replace(astats, kmeans_steps=8) == tstats
    # the reference's build over the same centroids
    jassign = jkm.assign(jnp.asarray(core), jnp.asarray(cent))
    ji, jstats = jivf.build_from_assignments(
        jspec, jnp.asarray(cent), jnp.asarray(core), jnp.asarray(attrs),
        jassign)
    _assert_same_index(ji, ti)
    assert dataclasses.asdict(dataclasses.replace(jstats, kmeans_steps=8)) \
        == dataclasses.asdict(tstats)


def test_build_ivf_default_clusters_and_unknown_mode():
    core = _topics(9, n=1500)
    attrs = np.zeros((1500, 2), np.int16)
    spec = thy.HybridSpec(dim=D, n_attrs=2, core_dtype=torch.float32)
    idx, stats = tivf.build_ivf(torch.Generator().manual_seed(1), spec, core,
                                attrs, kmeans_steps=3, device="cpu")
    assert idx.n_clusters == tivf.default_n_clusters(1500) == 1
    assert stats.max_list_len == 1500 and stats.vpad == 1536
    with pytest.raises(ValueError, match="kmeans_mode"):
        tivf.build_ivf(torch.Generator(), spec, core, attrs,
                       kmeans_mode="given", device="cpu")
