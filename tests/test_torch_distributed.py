"""The sharded search: the port's dispatch functions against the reference's
for 1, 2 and 4 shards, one shard's scan + merge against the reference's pure
function, and the one-shard ``make_sharded_search`` against the reference's
on a one-device mesh.

Slot tables, overflow counts, ranks, ids and n_scanned / n_passed must be
identical; scores agree to rtol 1e-5 (f32 sums taken in another order).
The reference's full search compiles for ~10 s per configuration, so its
five configurations are built once per module.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import distributed as jdist
from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro_torch.core import distributed as tdist
from repro_torch.core import filters as tf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import search as tsearch
from repro_torch.core.blockstore import RangeOwnership

KC = 16


def _np(x):
    return np.asarray(x)


def _probes(q=13, t=3, seed=0, with_valid=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, KC, (q, t)).astype(np.int32)
    valid = rng.random((q, t)) < 0.7 if with_valid else None
    return ids, valid


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_dispatch_probes_matches_reference(n_shards, with_valid, overflow):
    ids, valid = _probes(seed=n_shards, with_valid=with_valid)
    q, t = ids.shape
    p_cap = 8 if overflow else jdist.probe_capacity(q, t, n_shards)
    assert tdist.probe_capacity(q, t, n_shards) == jdist.probe_capacity(
        q, t, n_shards)
    kw = dict(n_shards=n_shards, k_local=KC // n_shards, p_cap=p_cap)
    want = jdist.dispatch_probes(_j(ids), probe_valid=_j(valid), **kw)
    got = tdist.dispatch_probes(_t(ids), probe_valid=_t(valid), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert (int(got[3]) > 0) == overflow


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_dispatch_probes_tiled_matches_reference(n_shards, with_valid,
                                                 overflow):
    ids, valid = _probes(seed=10 + n_shards, with_valid=with_valid)
    q, t = ids.shape
    p_cap = 8 if overflow else jdist.probe_capacity(q, t, n_shards)
    q_block = 4
    n_tiles = -(-q // q_block)
    k_local = KC // n_shards
    kw = dict(n_shards=n_shards, k_local=k_local, p_cap=p_cap,
              u_cap=max(1, min(p_cap, k_local * n_tiles)), q_block=q_block)
    want = jdist.dispatch_probes_tiled(_j(ids), probe_valid=_j(valid), **kw)
    got = tdist.dispatch_probes_tiled(_t(ids), probe_valid=_t(valid), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_dispatch_with_an_explicit_ownership_map():
    ids, _ = _probes(seed=5)
    own = RangeOwnership(2, KC // 2)
    kw = dict(n_shards=2, k_local=KC // 2, p_cap=24)
    want = jdist.dispatch_probes(_j(ids), **kw)
    got = tdist.dispatch_probes(_t(ids), ownership=own, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert own.nodes == (0, 1) and own.owner_of(9) == 1 and own.local_of(9) == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_within_query_matches_reference(seed):
    rng = np.random.default_rng(seed)
    sq = rng.integers(0, 6, 40).astype(np.int32)
    sv = rng.random(40) < 0.6
    want = jdist._rank_within_query(_j(sq), _j(sv), 5)
    got = tdist._rank_within_query(_t(sq), _t(sv), 5)
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ---- one shard's scan + merge, and the whole search ----

N, D, M, TS = 3000, 32, 3, 1600


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


def _indexes(metric, store):
    """Both packages' index over the same data; ``store`` is "f32", "bf16"
    or "sq8" (int8 rows with per-row scales, dot only)."""
    centers, core, attrs, topic = _data()
    bf16 = store == "bf16"
    jspec = jhy.HybridSpec(dim=D, n_attrs=M, metric=metric,
                           core_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tspec = thy.HybridSpec(dim=D, n_attrs=M, metric=metric,
                           core_dtype=torch.bfloat16 if bf16 else torch.float32)
    ji, _ = jivf.build_from_assignments(
        jspec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic))
    ti, _ = tivf.build_from_assignments(tspec, centers, core, attrs, topic,
                                        device="cpu")
    if store == "sq8":
        ji, ti = jivf.quantize_index(ji), tivf.quantize_index(ti)
    return ji, ti


def _queries(q, window, seed=1):
    """f32 queries that bf16 cannot represent, and their filters."""
    rng = np.random.default_rng(seed)
    centers, *_ = _data()
    qs = centers[rng.integers(0, KC, q)] + 0.3 * rng.standard_normal((q, D))
    qs = qs.astype(np.float32)
    lo = np.full((q, 1, M), -32768, np.int16)
    hi = np.full((q, 1, M), 32767, np.int16)
    if window:  # ~5% of the time range per query: the planner prunes
        start = rng.integers(0, TS - 80, q)
        lo[:, 0, 0], hi[:, 0, 0] = start, start + 79
    assert not np.array_equal(
        qs, np.asarray(jnp.asarray(qs).astype(jnp.bfloat16).astype(jnp.float32)))
    return qs, lo, hi


@pytest.mark.parametrize("metric,store,backend", [
    ("dot", "bf16", "pallas_tiled"), ("dot", "bf16", "pallas"),
    ("l2", "f32", "pallas_tiled"), ("l2", "f32", "pallas"),
    ("dot", "sq8", "pallas_tiled"), ("dot", "sq8", "pallas"),
])
def test_local_shard_search_matches_reference(metric, store, backend):
    ji, ti = _indexes(metric, store)
    qs, lo, hi = _queries(21, window=True, seed=2)
    q, t, k, qb = 21, 3, 6, 8
    probe_ids = np.asarray(jax.lax.top_k(
        jnp.asarray(qs) @ ji.centroids.T, t)[1]).astype(np.int32)
    tiled = backend == "pallas_tiled"
    p_cap = jdist.probe_capacity(q, t, 1)
    if tiled:
        qpad = -(-q // qb) * qb
        tables = jdist.dispatch_probes_tiled(
            jnp.asarray(probe_ids), n_shards=1, k_local=KC, p_cap=p_cap,
            u_cap=min(p_cap, KC * qpad // qb), q_block=qb)
        pad = np.concatenate([qs, np.repeat(qs[-1:], qpad - q, 0)])
        lo_in = np.concatenate([lo, np.repeat(lo[-1:], qpad - q, 0)])
        hi_in = np.concatenate([hi, np.repeat(hi[-1:], qpad - q, 0)])
    else:
        tables = jdist.dispatch_probes(jnp.asarray(probe_ids), n_shards=1,
                                       k_local=KC, p_cap=p_cap)
        pad, lo_in, hi_in = qs, lo, hi
    sc, sq, sv = (_np(x)[0] for x in tables[:3])
    uc, ut, us = ((_np(x)[0] for x in tables[4:7]) if tiled
                  else (None, None, None))
    norms = ji.norms if metric == "l2" else None
    kw = dict(metric=metric, k=k, t=t, q_block=qb)
    # the reference scans the tiled dedup pads, the port skips them: no
    # probe reads a pad, so the answers agree
    want = jdist._local_shard_search(
        ji.vectors, ji.attrs, ji.ids, norms, ji.scales, _j(pad), _j(lo_in),
        _j(hi_in), _j(sc), _j(sq), _j(sv), _j(uc), _j(ut), _j(us),
        v_block=128, backend=backend + "_interpret", **kw)
    u_count = _t(_np(tables[7])[0]) if tiled else None
    got = tdist._local_shard_search(
        ti.vectors, ti.attrs, ti.ids, ti.norms if metric == "l2" else None,
        ti.scales, _t(pad), _t(lo_in), _t(hi_in), _t(sc), _t(sq), _t(sv),
        _t(uc), _t(ut), _t(us), u_count, backend=backend, **kw)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=1e-5)


CONFIGS = {  # name: (metric, index store, backend, prune, window, p_cap_slack)
    "dot-bf16-tiled-prune": ("dot", "bf16", "pallas_tiled", "auto", True, 2.0),
    "dot-bf16-probe-overflow": ("dot", "bf16", "pallas", "off", False, 0.5),
    "l2-f32-tiled": ("l2", "f32", "pallas_tiled", "off", False, 2.0),
    "l2-f32-probe-prune": ("l2", "f32", "pallas", "on", True, 2.0),
    "dot-sq8-probe": ("dot", "sq8", "pallas", "off", False, 2.0),
}
Q, K_TOP, T = 37, 10, 3


@pytest.fixture(scope="module", params=list(CONFIGS))
def sharded(request):
    """The reference's one-device sharded search and the port's, on the
    same index, queries and filters."""
    metric, store, backend, prune, window, slack = CONFIGS[request.param]
    ji, ti = _indexes(metric, store)
    qs, lo, hi = _queries(Q, window)
    common = dict(k=K_TOP, n_probes=T, scan_q_block=16, prune=prune,
                  p_cap_slack=slack)
    mesh = Mesh(np.array(jax.devices()[:1]), ("x",))
    jfn, _, jinfo = jdist.make_sharded_search(
        mesh, metric, q_total=Q, n_clusters=KC,
        cfg=jdist.ShardedSearchConfig(backend=backend + "_interpret",
                                      use_centroid_kernel=True,
                                      quantized=store == "sq8", **common))
    jr = jfn(ji, jnp.asarray(qs),
             jf.FilterSpec(lo=jnp.asarray(lo), hi=jnp.asarray(hi)))
    tfn, tinfo = tdist.make_sharded_search(
        metric, q_total=Q, n_clusters=KC, device="cpu",
        cfg=tdist.ShardedSearchConfig(backend=backend, **common))
    assert tinfo["p_cap"] == jinfo["p_cap"] and tinfo["k_local"] == KC
    fspec = tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))
    tr = tfn(ti, torch.from_numpy(qs), fspec)
    return request.param, jr, tr, (ti, qs, fspec, tfn)


def test_sharded_search_matches_reference_sharded_search(sharded):
    name, jr, tr, _ = sharded
    np.testing.assert_array_equal(_np(jr.ids), tr.ids.numpy())
    np.testing.assert_allclose(_np(jr.scores), tr.scores.numpy(), rtol=1e-5)
    for c in ("n_scanned", "n_passed"):
        np.testing.assert_array_equal(_np(getattr(jr, c)),
                                      getattr(tr, c).numpy(), err_msg=c)
    assert (tr.n_scanned.numpy() > 0).all() == ("overflow" in name)
    assert (tr.n_passed.numpy() == 0).all()


def test_sharded_search_matches_search_reference_and_drops_shards(sharded):
    name, _, tr, (ti, qs, fspec, tfn) = sharded
    if "overflow" not in name:  # every probe scanned: the reference's answer
        ref = tsearch.search_reference(ti, torch.from_numpy(qs), fspec,
                                       k=K_TOP, n_probes=T)
        np.testing.assert_array_equal(ref.ids.numpy(), tr.ids.numpy())
        np.testing.assert_allclose(ref.scores.numpy(), tr.scores.numpy(),
                                   rtol=1e-5, atol=1e-5)
    dropped = tfn(ti, torch.from_numpy(qs), fspec,
                  shard_ok=torch.zeros((1,), dtype=torch.bool))
    assert (dropped.ids.numpy() == -1).all()
    assert (dropped.scores.numpy() == tdist.NEG_INF).all()


def test_make_sharded_search_rejects_what_is_not_ported():
    """The reference's interpret and XLA backends have no counterpart; a
    mesh whose shard count does not divide K raises as the reference's
    does, before any collective (so stand-in meshes that carry only the
    axis names and sizes reach the check in both packages); more than one
    shard needs a mesh."""
    cfg = tdist.ShardedSearchConfig()
    for backend in ("pallas_interpret", "pallas_tiled_interpret", "xla_map",
                    "xla_vmap", "xla_tiled"):
        with pytest.raises(ValueError, match="device"):
            tdist.make_sharded_search(
                "dot", q_total=8, n_clusters=KC, device="cpu",
                cfg=tdist.ShardedSearchConfig(backend=backend))
    names, sizes = ("data", "model"), (2, 3)
    jmesh = types.SimpleNamespace(axis_names=names, shape=dict(zip(names,
                                                                   sizes)))
    tmesh = types.SimpleNamespace(mesh_dim_names=names, shape=sizes)
    with pytest.raises(ValueError) as want:
        jdist.make_sharded_search(jmesh, "dot", q_total=8, n_clusters=KC,
                                  cfg=jdist.ShardedSearchConfig())
    with pytest.raises(ValueError) as got:
        tdist.make_sharded_search("dot", q_total=8, n_clusters=KC, cfg=cfg,
                                  mesh=tmesh, device="cpu")
    head = f"K={KC} must divide over 6 shards;"
    assert str(want.value).startswith(head), want.value
    assert str(got.value).startswith(head), got.value
    with pytest.raises(ValueError, match="needs a mesh"):
        tdist.make_sharded_search("dot", q_total=8, n_clusters=KC, cfg=cfg,
                                  n_shards=2, device="cpu")
