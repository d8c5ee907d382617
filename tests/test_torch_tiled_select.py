"""The CUDA tiled scan's streaming selection, step by step on the CPU.

``ref.tiled_select_ref`` runs the kernel's selection in plain PyTorch
(128-row chunks in position order, the first sorted whole, or at one slot
a lane (k <= 32) cut to its candidates at or above the k-th of the lanes'
maxima, then the candidates above each row's running k-th compacted,
sorted and merged 32 at a time by the kernel's bitonic networks).  On tie-heavy operands (small
integer bf16 queries and rows: every dot exact, many equal) it must give
the plain version's lists and the Pallas kernel's (interpret mode) bit for
bit at every list width's edge: values, ids and pass counts exact.  The
Pallas kernel runs once, at k = 256: a top-k under one total order is the
prefix of any longer one.  The CUDA kernel itself is held against the
plain version on the same data in test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.filtered_scan.filtered_scan import (
    filtered_scan_tiled as pallas_filtered_scan_tiled,
)
from repro_torch.core.topk import NEG_INF, top_k
from repro_torch.kernels.filtered_scan.ref import (
    chunked_topk,
    filtered_scan_tiled_ref,
    tiled_select_ref,
)

KS = (1, 2, 10, 31, 32, 33, 64, 100, 128, 129, 256)  # list widths' edges
VPAD = 288  # not a multiple of the 128-row chunk
Q_BLOCK = 8


def _tie_case(seed=0, n_tiles=2, u_cap=3, kc=4, d=16, m=3):
    """Operands whose dots are small integers: queries and rows in -2..2
    (bf16-exact), so equal scores abound.  Query rows 0-1 of each tile pass
    a handful of rows only (fewer than most k), rows 2-3 about half, the
    rest every live row; about 5% of the rows are dead (id -1)."""
    rng = np.random.default_rng(seed)
    qpad, s = n_tiles * Q_BLOCK, n_tiles * u_cap
    lo = np.full((qpad, 1, m), -32768, np.int16)
    hi = np.full((qpad, 1, m), 32767, np.int16)
    for t in range(n_tiles):
        r0 = t * Q_BLOCK
        lo[r0:r0 + 2, 0, 0], hi[r0:r0 + 2, 0, 0] = 0, 0  # attr 0 == 0
        lo[r0:r0 + 2, 0, 1], hi[r0:r0 + 2, 0, 1] = 0, 2
        lo[r0 + 2:r0 + 4, 0, 1], hi[r0 + 2:r0 + 4, 0, 1] = 0, 4
    ids = rng.permutation(kc * VPAD).astype(np.int32).reshape(kc, VPAD)
    ids[rng.random((kc, VPAD)) < 0.05] = -1
    return dict(
        slot_cluster=rng.integers(0, kc, s).astype(np.int32),
        slot_tile=np.repeat(np.arange(n_tiles, dtype=np.int32), u_cap),
        n_unique=np.array([u_cap, u_cap - 1], np.int32)[:n_tiles],
        queries=rng.integers(-2, 3, (qpad, d)).astype(np.float32),
        lo=lo, hi=hi,
        vectors=rng.integers(-2, 3, (kc, VPAD, d)).astype(np.float32),
        attrs=np.stack([rng.integers(0, 40, (kc, VPAD)),
                        rng.integers(0, 10, (kc, VPAD)),
                        rng.integers(0, 10, (kc, VPAD))], -1).astype(np.int16),
        ids=ids,
    )


def _torch_args(c):
    def t(x):
        return torch.from_numpy(x)

    return (t(c["slot_cluster"]), t(c["slot_tile"]), t(c["n_unique"]),
            t(c["queries"]).to(torch.bfloat16), t(c["lo"]), t(c["hi"]),
            t(c["vectors"]).to(torch.bfloat16), t(c["attrs"]), t(c["ids"]),
            None, None)


def _live(c):
    u_cap = len(c["slot_cluster"]) // len(c["n_unique"])
    pos = np.arange(len(c["slot_cluster"])) - c["slot_tile"] * u_cap
    return pos < c["n_unique"][c["slot_tile"]]


@pytest.fixture(scope="module")
def case():
    c = _tie_case()
    j = {name: jnp.asarray(x) for name, x in c.items()}
    pallas = pallas_filtered_scan_tiled(
        j["slot_cluster"], j["slot_tile"], j["queries"].astype(jnp.bfloat16),
        j["lo"], j["hi"], j["vectors"].astype(jnp.bfloat16), j["attrs"],
        j["ids"], metric="dot", k=max(KS), q_block=Q_BLOCK, v_block=128,
        interpret=True)
    return c, [np.asarray(x) for x in pallas]


@pytest.mark.parametrize("k", KS)
def test_selection_matches_plain_version_and_pallas_kernel(case, k):
    c, pallas = case
    args = _torch_args(c)
    kw = dict(metric="dot", k=k, q_block=Q_BLOCK)
    got = tiled_select_ref(*args, **kw)
    want = filtered_scan_tiled_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    vals, ids, npass = (x.numpy() for x in got)
    live = _live(c)
    assert not live.all()
    np.testing.assert_array_equal(vals[live], pallas[0][live, :, :k])
    np.testing.assert_array_equal(ids[live], pallas[1][live, :, :k])
    np.testing.assert_array_equal(npass[live], pallas[2][live])
    # the data is what the test needs: ties inside the lists, and rows with
    # fewer than k passing rows (pads) beside full ones
    real = vals[live] > NEG_INF / 2
    if k > 1:
        assert ((vals[live][..., 1:] == vals[live][..., :-1])
                & real[..., 1:]).any()
        assert (~real).any() and real.all(-1).any()


def test_selection_on_sorted_and_constant_rows():
    """Ascending rows (every candidate beats the running k-th, the most
    merges) and constant rows (every candidate ties): positions as the
    stable sort gives them."""
    g = torch.Generator().manual_seed(1)
    x = torch.sort(torch.randn((6, 700), generator=g), -1).values
    x = torch.cat([x, torch.full((2, 700), 3.0)])
    for k in (1, 33, 129, 256):
        v, p = chunked_topk(x, k)
        wv, wp = top_k(x, k)
        assert torch.equal(v, wv) and torch.equal(p, wp)
    with pytest.raises(ValueError):
        chunked_topk(x, 257)


def test_one_slot_first_chunk_floor():
    """k <= 32 (one slot a lane): the first chunk keeps only its candidates
    at or above the k-th of the lanes' maxima.  Rows whose best values all
    sit in one lane (the floor far below the k-th), in every lane, in
    order and in reverse, and rows of equal values: the lists are top_k's
    at every k."""
    g = torch.Generator().manual_seed(2)
    lane0 = torch.randn((3, 300), generator=g)
    lane0[:, 0:128:32] += 10.0  # the chunk's best four: all in lane 0
    lane0[:, 1:128:32] += 9.0  # the next four: all in lane 1
    x = torch.cat([
        lane0,
        torch.sort(torch.randn((2, 300), generator=g), -1).values,
        torch.sort(torch.randn((2, 300), generator=g), -1,
                   descending=True).values,
        torch.full((1, 300), -1.5),
        torch.where(torch.rand((2, 300), generator=g) < 0.9, NEG_INF,
                    torch.randn((2, 300), generator=g)),  # few passing
    ])
    for k in range(1, 33):
        v, p = chunked_topk(x, k)
        wv, wp = top_k(x, k)
        real = wv > NEG_INF / 2  # pads: the kernel's position is PAD_POS
        assert torch.equal(v, wv), k
        assert torch.equal(p[real], wp[real]), k
    assert (~real).any()  # at k = 32 the few-passing rows end in pads
