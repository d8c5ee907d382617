"""repro_torch.core.probes against repro.core.probes: integer outputs, held
exactly, including pruned probes (``probe_valid``) and u_cap overflow."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import probes as jp
from repro_torch.core import probes as tp


def _keys(seed, r=4, l=24, space=10):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, space, (r, l)).astype(np.int32)
    valid = rng.random((r, l)) < 0.7
    valid[1] = False  # an all-invalid row
    return keys, valid


@pytest.mark.parametrize("cap", [3, 10, 24])
@pytest.mark.parametrize("with_valid", [False, True])
def test_dedup_rows_matches_reference(cap, with_valid):
    keys, valid = _keys(cap)
    jv = jnp.asarray(valid) if with_valid else None
    tv = torch.from_numpy(valid) if with_valid else None
    jt, js, jc = jp.dedup_rows(jnp.asarray(keys), jv, cap)
    tt, ts, tc = tp.dedup_rows(torch.from_numpy(keys), tv, cap)
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    sel = valid if with_valid else np.ones_like(valid)
    # slot_of is junk where invalid (both sides only promise >= 0 there)
    np.testing.assert_array_equal(np.asarray(js)[sel], ts.numpy()[sel])
    assert (ts.numpy() >= 0).all()


@pytest.mark.parametrize("u_cap", [4, 9, 40])
@pytest.mark.parametrize("with_valid", [False, True])
def test_plan_probe_tiles_matches_reference(u_cap, with_valid):
    rng = np.random.default_rng(u_cap)
    probe_ids = rng.integers(0, 30, (16, 5)).astype(np.int32)
    valid = rng.random((16, 5)) < 0.6
    jout = jp.plan_probe_tiles(jnp.asarray(probe_ids), q_block=8, u_cap=u_cap,
                               probe_valid=jnp.asarray(valid) if with_valid else None)
    tout = tp.plan_probe_tiles(torch.from_numpy(probe_ids), q_block=8,
                               u_cap=u_cap,
                               probe_valid=torch.from_numpy(valid) if with_valid else None)
    names = ("slot_cluster", "slot_tile", "slot_of_probe", "probe_ok", "n_unique")
    for name, j, t in zip(names, jout, tout):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
    if u_cap == 4:
        assert not tout[3].all()  # overflowed probes are reported


def test_plan_probe_tiles_rejects_ragged_q():
    with pytest.raises(ValueError):
        tp.plan_probe_tiles(torch.zeros((10, 2), dtype=torch.int32),
                            q_block=8, u_cap=4)


@pytest.mark.parametrize("q", [8, 13])
def test_pad_to_tiles_matches_reference(q):
    rng = np.random.default_rng(q)
    x = rng.integers(-5, 5, (q, 2, 3)).astype(np.int16)
    b = rng.random((q, 4)) < 0.5
    np.testing.assert_array_equal(np.asarray(jp.pad_to_tiles(jnp.asarray(x), 8)),
                                  tp.pad_to_tiles(torch.from_numpy(x), 8).numpy())
    np.testing.assert_array_equal(np.asarray(jp.pad_to_tiles(jnp.asarray(b), 8)),
                                  tp.pad_to_tiles(torch.from_numpy(b), 8).numpy())
