"""repro_torch filters and cluster summaries against the reference: all
outputs are integer or bool, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters as jf
from repro.core import summaries as js
from repro_torch.core import filters as tf
from repro_torch.core import summaries as ts


def _builders(n_attrs, mod):
    out = []
    for q in range(6):
        b = mod.FilterBuilder(n_attrs=n_attrs)
        if q % 3 == 0:
            b.between(0, -5, 10)
        if q % 3 == 1:
            b.isin(1, [2, 7]).ge(2, 0)
        if q == 5:
            b.le(3, -40000)  # clamps to ATTR_MIN: one-value interval
        out.append(b)
    return out


def test_builders_and_match_all_match_reference():
    jspec = jf.from_builders(_builders(4, jf), n_terms=3)
    tspec = tf.from_builders(_builders(4, tf), n_terms=3, device="cpu")
    np.testing.assert_array_equal(np.asarray(jspec.lo), tspec.lo.numpy())
    np.testing.assert_array_equal(np.asarray(jspec.hi), tspec.hi.numpy())
    jm, tm = jf.match_all(5, 4, n_terms=2), tf.match_all(5, 4, n_terms=2,
                                                         device="cpu")
    np.testing.assert_array_equal(np.asarray(jm.lo), tm.lo.numpy())
    np.testing.assert_array_equal(np.asarray(jm.hi), tm.hi.numpy())


@pytest.mark.parametrize("query_idx", [False, True])
def test_filter_mask_matches_reference(query_idx):
    rng = np.random.default_rng(0)
    jspec = jf.from_builders(_builders(4, jf), n_terms=3)
    tspec = tf.from_builders(_builders(4, tf), n_terms=3, device="cpu")
    attrs = rng.integers(-20, 20, (6, 3, 50, 4)).astype(np.int16)
    if query_idx:
        qidx = rng.integers(0, 6, (6, 3, 50))
        jm = jf.filter_mask(jspec, jnp.asarray(attrs), jnp.asarray(qidx))
        tm = tf.filter_mask(tspec, torch.from_numpy(attrs),
                            torch.from_numpy(qidx))
    else:
        jm = jf.filter_mask(jspec, jnp.asarray(attrs))
        tm = tf.filter_mask(tspec, torch.from_numpy(attrs))
    assert np.asarray(jm).any() and not np.asarray(jm).all()
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())


def _lists(seed, k=12, vpad=128, m=3):
    rng = np.random.default_rng(seed)
    attrs = rng.integers(-300, 300, (k, vpad, m)).astype(np.int16)
    ids = rng.integers(0, 1000, (k, vpad)).astype(np.int32)
    ids[rng.random((k, vpad)) < 0.3] = -1
    ids[2] = -1  # an empty cluster: void interval, zero mass
    return attrs, ids


@pytest.mark.parametrize("n_bins", [1, 7, 16])
def test_attr_bins_matches_reference(n_bins):
    rng = np.random.default_rng(n_bins)
    a = rng.integers(-32768, 32768, (40, 3)).astype(np.int16)
    elo = np.array([-100, 0, -32768], np.int16)
    ehi = np.array([100, 0, 32767], np.int16)  # one zero-width range
    jb = js.attr_bins(jnp.asarray(a), jnp.asarray(elo), jnp.asarray(ehi), n_bins)
    tb = ts.attr_bins(torch.from_numpy(a), torch.from_numpy(elo),
                      torch.from_numpy(ehi), n_bins)
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


@pytest.mark.parametrize("edges", [False, True])
def test_build_summaries_matches_reference(edges):
    attrs, ids = _lists(1)
    e = (np.array([-50, -300, 0], np.int16), np.array([50, 299, 10], np.int16))
    jsum = js.build_summaries(jnp.asarray(attrs), jnp.asarray(ids), n_bins=8,
                              edges=e if edges else None)
    tsum = ts.build_summaries(torch.from_numpy(attrs), torch.from_numpy(ids),
                              n_bins=8, edges=e if edges else None)
    for f in ("amin", "amax", "hist", "edges_lo", "edges_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jsum, f)),
                                      getattr(tsum, f).numpy(), err_msg=f)


def test_can_match_matches_reference():
    attrs, ids = _lists(2)
    rng = np.random.default_rng(3)
    q, f, m = 9, 3, 3
    lo = rng.integers(-400, 300, (q, f, m)).astype(np.int16)
    hi = (lo + rng.integers(0, 120, (q, f, m))).astype(np.int16)
    lo[0, 1] = 32767  # a void term
    hi[0, 1] = -32768
    lo[1, 0] = -32768  # bounds outside the edges
    hi[1, 0] = 32767
    lo[2, :, 0], hi[2, :, 0] = 5000, 6000  # beyond every edge: nothing
    jsum = js.build_summaries(jnp.asarray(attrs), jnp.asarray(ids), n_bins=16)
    tsum = ts.build_summaries(torch.from_numpy(attrs), torch.from_numpy(ids),
                              n_bins=16)
    jc = np.asarray(js.can_match(jsum, jnp.asarray(lo), jnp.asarray(hi)))
    tc = ts.can_match(tsum, torch.from_numpy(lo), torch.from_numpy(hi)).numpy()
    assert jc.any() and not jc.all()
    np.testing.assert_array_equal(jc, tc)
