"""repro_torch.core.topk against repro.core.topk on tie-heavy fixtures.

Values are small integers, so every row is full of exact ties: ids must
match exactly (the earliest position wins among equal values), values
exactly (no arithmetic happens).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk as jtopk
from repro_torch.core import topk as ttopk


def _ties(seed, shape):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 4, shape).astype(np.float32)
    ids = rng.integers(0, 1000, shape).astype(np.int32)
    return vals, ids


def test_top_k_keeps_first_index_tie_order():
    x = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0])
    _, idx = ttopk.top_k(x, 3)
    assert idx.tolist() == [1, 2, 4]


@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("with_ids", [False, True])
def test_masked_topk_matches_reference(with_mask, with_ids):
    vals, ids = _ties(0, (6, 40))
    mask = np.random.default_rng(1).random((6, 40)) < 0.2  # few pass
    jm = jnp.asarray(mask) if with_mask else None
    tm = torch.from_numpy(mask) if with_mask else None
    jv, ji = jtopk.masked_topk(jnp.asarray(vals), jm, 10,
                               ids=jnp.asarray(ids) if with_ids else None)
    tv, ti = ttopk.masked_topk(torch.from_numpy(vals), tm, 10,
                               ids=torch.from_numpy(ids) if with_ids else None)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert ti.dtype == torch.int32


def test_merge_topk_matches_reference():
    av, ai = _ties(2, (5, 8))
    bv, bi = _ties(3, (5, 8))
    jv, ji = jtopk.merge_topk((jnp.asarray(av), jnp.asarray(ai)),
                              (jnp.asarray(bv), jnp.asarray(bi)), 8)
    tv, ti = ttopk.merge_topk((torch.from_numpy(av), torch.from_numpy(ai)),
                              (torch.from_numpy(bv), torch.from_numpy(bi)), 8)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


@pytest.mark.parametrize("n", [1, 2, 5, 7, 8])
@pytest.mark.parametrize("axis", [0, 1])
def test_merge_topk_many_matches_reference(n, axis):
    shape = [3, 3, 6]
    shape[axis] = n
    vals, ids = _ties(4 + n, tuple(shape))
    vals[..., 4:] = jtopk.NEG_INF  # ragged fragments, as per-slot top-k pads
    ids[..., 4:] = -1
    jv, ji = jtopk.merge_topk_many(jnp.asarray(vals), jnp.asarray(ids), 6, axis)
    tv, ti = ttopk.merge_topk_many(torch.from_numpy(vals),
                                   torch.from_numpy(ids), 6, axis)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
