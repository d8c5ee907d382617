"""repro_torch.core.ivf against repro.core.ivf, field by field.

Integer fields, bf16/f32/int8 storage and the summaries must be identical;
the f32 norms and SQ8 scales are sums or maxima computed in another order,
held to rtol 1e-6.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf

N, D, M, K = 1500, 24, 3, 12
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cent = rng.standard_normal((K, D)).astype(np.float32)
    assign = rng.integers(0, K - 1, N).astype(np.int32)  # cluster K-1 empty
    core = (cent[assign] + 0.2 * rng.standard_normal((N, D))).astype(np.float32)
    attrs = rng.integers(-50, 50, (N, M)).astype(np.int16)
    return cent, core, attrs, assign


def _build(metric, dtype, vpad=None, quantize=False):
    cent, core, attrs, assign = _data()
    jd, td = DTYPES[dtype]
    jspec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jd, metric=metric)
    tspec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=td, metric=metric)
    ji, jstats = jivf.build_from_assignments(
        jspec, jnp.asarray(cent), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(assign), vpad=vpad)
    ti, tstats = tivf.build_from_assignments(tspec, cent, core, attrs, assign,
                                             vpad=vpad, device="cpu")
    if quantize:
        ji, ti = jivf.quantize_index(ji), tivf.quantize_index(ti)
    return ji, jstats, ti, tstats, tspec


def _np(x):
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _assert_same_index(ji, ti):
    for f in ("centroids", "vectors", "attrs", "ids", "counts"):
        np.testing.assert_array_equal(_np(getattr(ji, f)),
                                      getattr(ti, f).float().numpy()
                                      if getattr(ti, f).dtype == torch.bfloat16
                                      else getattr(ti, f).numpy(), err_msg=f)
    for f in ("norms", "scales"):
        a, b = getattr(ji, f), getattr(ti, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6,
                                       err_msg=f)
    for f in ("amin", "amax", "hist", "edges_lo", "edges_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(ji.summaries, f)),
                                      getattr(ti.summaries, f).numpy(),
                                      err_msg=f)


@pytest.mark.parametrize("metric,dtype,quantize", [
    ("dot", "f32", False), ("dot", "bf16", False), ("l2", "f32", False),
    ("l2", "bf16", False), ("dot", "f32", True),
])
def test_build_from_assignments_matches_reference(metric, dtype, quantize):
    ji, jstats, ti, tstats, _ = _build(metric, dtype, quantize=quantize)
    _assert_same_index(ji, ti)
    assert ti.vectors.dtype == (torch.int8 if quantize else DTYPES[dtype][1])
    assert dataclasses.asdict(jstats) == dataclasses.asdict(tstats)
    np.testing.assert_array_equal(np.asarray(jivf.validity_mask(ji)),
                                  tivf.validity_mask(ti).numpy())


def test_capacity_drops_match_reference():
    ji, jstats, ti, tstats, _ = _build("dot", "f32", vpad=128)
    assert tstats.n_dropped > 0
    assert dataclasses.asdict(jstats) == dataclasses.asdict(tstats)
    _assert_same_index(ji, ti)


def test_dequantize_rows_matches_reference():
    ji, _, ti, _, _ = _build("dot", "f32", quantize=True)
    np.testing.assert_array_equal(
        np.asarray(jivf.dequantize_rows(ji.vectors, ji.scales)),
        tivf.dequantize_rows(ti.vectors, ti.scales).numpy())


@pytest.mark.parametrize("metric,dtype,quantize", [
    ("dot", "bf16", False), ("l2", "f32", False), ("dot", "f32", True),
])
def test_index_from_arrays_carries_reference_state(metric, dtype, quantize):
    ji, _, ti, _, tspec = _build(metric, dtype, quantize=quantize)
    arrays = {f: np.asarray(getattr(ji, f)) for f in (
        "centroids", "vectors", "attrs", "ids", "counts")}
    arrays.update(
        norms=None if ji.norms is None else np.asarray(ji.norms),
        scales=None if ji.scales is None else np.asarray(ji.scales),
        **{f: np.asarray(getattr(ji.summaries, f)) for f in (
            "amin", "amax", "hist", "edges_lo", "edges_hi")})
    carried = tivf.index_from_arrays(arrays, tspec, device="cpu")
    assert carried.vectors.dtype == ti.vectors.dtype
    _assert_same_index(ji, carried)


def test_default_n_clusters_and_round_up():
    for n in (1, 999, 5000, 1_000_000, 10_000_000):
        assert tivf.default_n_clusters(n) == jivf.default_n_clusters(n)
    assert tivf.default_n_clusters(10_000_000) == 3162
    assert tivf.round_up(3163, 128) == jivf.round_up(3163, 128) == 3200
