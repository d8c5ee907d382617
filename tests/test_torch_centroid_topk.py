"""The streaming centroid top-T: the port's plain version against the
Pallas kernel (interpret mode) and its jnp oracle, ``probe_centroids``
against the reference's, and the wrapper's dispatch by device.  The CUDA
kernel itself is held against the plain version in test_torch_gpu.py.

Tolerances: values rtol 1e-5 / atol 1e-5 (f32 sums taken in another order;
bf16 inputs are cast to f32 exactly on both sides); ids exact (random
continuous scores, no ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.centroid_topk import centroid_topk as jax_centroid_topk
from repro.kernels.centroid_topk import centroid_topk_ref as jax_ref
from repro.kernels.centroid_topk import probe_centroids as jax_probe_centroids
from repro_torch.kernels.centroid_topk import centroid_topk as tct_mod
from repro_torch.kernels.centroid_topk import (
    centroid_topk_ref,
    probe_centroids,
)

tct = tct_mod.centroid_topk


def _inputs(q, k, d, seed, bf16=False):
    rng = np.random.default_rng(seed)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    cents = rng.standard_normal((k, d)).astype(np.float32)
    tq, tc = torch.from_numpy(queries), torch.from_numpy(cents)
    jq, jc = jnp.asarray(queries), jnp.asarray(cents)
    if bf16:
        tq, tc = tq.bfloat16(), tc.bfloat16()
        jq, jc = jq.astype(jnp.bfloat16), jc.astype(jnp.bfloat16)
    return (tq, tc), (jq, jc)


def _assert_same(got, want):
    gv, gi = (x.numpy() for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gi, wi)
    assert gi.dtype == np.int32


@pytest.mark.parametrize(
    "q,k,d,t,qb,kb,metric,bf16",
    [  # the shapes of tests/test_kernel_centroid_topk.py, plus bf16
        (8, 64, 16, 4, 8, 32, "dot", False),
        (16, 128, 32, 7, 8, 64, "dot", False),
        (4, 256, 64, 3, 4, 128, "dot", False),
        (8, 64, 16, 4, 8, 32, "l2", False),
        (32, 512, 8, 16, 16, 128, "dot", False),
        (8, 64, 32, 4, 8, 32, "dot", True),
        (8, 64, 32, 5, 8, 32, "l2", True),
    ],
)
def test_plain_version_matches_pallas_kernel_and_oracle(q, k, d, t, qb, kb,
                                                        metric, bf16):
    (tq, tc), (jq, jc) = _inputs(q, k, d, seed=q * k + t, bf16=bf16)
    got = tct(tq, tc, t=t, metric=metric)
    _assert_same(got, jax_centroid_topk(jq, jc, t=t, q_block=qb, k_block=kb,
                                        metric=metric, interpret=True))
    _assert_same(got, jax_ref(jq, jc, t=t, metric=metric))
    _assert_same(centroid_topk_ref(tq, tc, t=t, metric=metric), got)


@pytest.mark.parametrize("k,t", [(96, 4), (160, 5), (64, 1)])
def test_probe_centroids_matches_reference_where_padding_cannot_win(k, t):
    # positive operands: every dot score is > 0, so the reference's zero
    # padded centroids never win
    rng = np.random.default_rng(k + t)
    queries = rng.uniform(0.1, 1.0, (6, 8)).astype(np.float32)
    cents = rng.uniform(0.1, 1.0, (k, 8)).astype(np.float32)
    want = jax_probe_centroids(jnp.asarray(queries), jnp.asarray(cents), t=t,
                               q_block=4, k_block=64, interpret=True)
    got = probe_centroids(torch.from_numpy(queries), torch.from_numpy(cents),
                          t=t)
    _assert_same(got, want)


def test_probe_centroids_keeps_real_probes_where_all_scores_are_negative():
    # every real dot score < 0: the reference's padded zero centroids win
    # and are masked to -1 (ROADMAP C); the port returns the oracle's ids
    rng = np.random.default_rng(7)
    queries = rng.uniform(0.1, 1.0, (4, 8)).astype(np.float32)
    cents = -rng.uniform(0.1, 1.0, (96, 8)).astype(np.float32)
    jq, jc = jnp.asarray(queries), jnp.asarray(cents)
    oracle = jax_ref(jq, jc, t=4)
    faulty = jax_probe_centroids(jq, jc, t=4, q_block=4, k_block=64,
                                 interpret=True)
    assert (np.asarray(faulty[1]) == -1).any()  # the case shows the fault
    got = probe_centroids(torch.from_numpy(queries), torch.from_numpy(cents),
                          t=4)
    _assert_same(got, oracle)
    assert (got[1].numpy() >= 0).all()


def test_ties_go_to_the_lower_centroid_id():
    rng = np.random.default_rng(3)
    cents = rng.standard_normal((40, 16)).astype(np.float32)
    cents[[5, 17, 33]] = cents[2]  # duplicated centroids tie exactly
    queries = cents[[2, 2, 9]] + 0.0
    for metric in ("dot", "l2"):
        vals, ids = tct(torch.from_numpy(queries), torch.from_numpy(cents),
                        t=6, metric=metric)
        np.testing.assert_array_equal(ids.numpy()[:2, :4], [[2, 5, 17, 33]] * 2)
        _, jids = jax_ref(jnp.asarray(queries), jnp.asarray(cents), t=6,
                          metric=metric)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_wrapper_takes_plain_path_for_cpu_tensors_and_checks_arguments():
    (tq, tc), _ = _inputs(5, 30, 12, seed=1)
    before = tct_mod.LAUNCHES
    got = tct(tq, tc, t=3)
    want = centroid_topk_ref(tq, tc, t=3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tct_mod.LAUNCHES == before  # no kernel launch on the CPU path
    with pytest.raises(ValueError, match="unsupported device"):
        tct(tq.to("meta"), tc.to("meta"), t=3)
    with pytest.raises(ValueError):
        tct(tq, tc, t=31)  # t > K
    with pytest.raises(ValueError):
        tct(tq, tc, t=3, metric="cos")
