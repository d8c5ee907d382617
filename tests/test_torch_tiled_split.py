"""The tiled scan's tensor-core arithmetic for f32 x f32 and SQ8, in plain
PyTorch (``split_scan_ref``: f32 values split into three bf16 terms, the
six products hh, hm, hl, mh, mm, lh for f32 x f32, three for SQ8's exact
int8 rows), against the Pallas kernel in interpret mode on the same numpy
operands, beside the plain version (``filtered_scan_tiled_ref``).  The CUDA
bodies are held against both in test_torch_gpu.py.

Data: Gaussian rows, rows whose values span six decades, and near-cancelling
dots (queries along one direction, vectors orthogonal to it, so that each
dot is ~20x below the sum of its products' magnitudes).

Tolerances: check_topk's, values rtol 1e-5 + atol 1e-5·max|value| (f32
sums in another order); pass counts exact; ids exact except where a value
lies within twice that atol of a neighbour in the list or of the next value
past it (a near-tie that another summation order may swap).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.filtered_scan.filtered_scan import (
    filtered_scan_tiled as pallas_filtered_scan_tiled,
)
from repro_torch.core.topk import NEG_INF
from repro_torch.kernels.filtered_scan.ref import (
    bf16_terms,
    filtered_scan_tiled_ref,
    split_scan_ref,
)

PAIRS = {"dot-f32": ("dot", False), "l2-f32": ("l2", False),
         "sq8": ("dot", True)}
DATA = ("gauss", "decades", "cancel")
CANCEL = 100.0  # the shared direction's weight in the cancelling rows


def _rows(kind, rng, n, d, u, side):
    """[n, d] f32 rows of a data set; ``u`` is the cancelling direction."""
    x = rng.standard_normal((n, d))
    if kind == "decades":
        x *= 10.0 ** rng.uniform(-3, 3, (n, d))
    elif kind == "cancel":
        if side == "q":  # queries along u
            x += CANCEL * u
        else:  # vectors orthogonal to u, as large
            x = CANCEL * (x - np.outer(x @ u, u)) + rng.standard_normal((n, d))
    return x.astype(np.float32)


def _case(pair, kind, d, f, *, seed=0, q_block=8, n_tiles=2, kc=4, vpad=256,
          m=3, u_cap=4):
    """numpy operands: S = n_tiles·u_cap slots, tile-major, some dead."""
    metric, quantized = PAIRS[pair]
    rng = np.random.default_rng(seed)
    qpad, s = n_tiles * q_block, n_tiles * u_cap
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    vec = _rows(kind, rng, kc * vpad, d, u, "v").reshape(kc, vpad, d)
    c = dict(
        slot_cluster=rng.integers(0, kc, s).astype(np.int32),
        slot_tile=np.repeat(np.arange(n_tiles, dtype=np.int32), u_cap),
        n_unique=rng.integers(1, u_cap + 1, n_tiles).astype(np.int32),
        queries=_rows(kind, rng, qpad, d, u, "q"),
        lo=rng.integers(-20, 5, (qpad, f, m)).astype(np.int16),
        hi=rng.integers(5, 30, (qpad, f, m)).astype(np.int16),
        attrs=rng.integers(-25, 25, (kc, vpad, m)).astype(np.int16),
        ids=rng.integers(-1, 10**6, (kc, vpad)).astype(np.int32),
        norms=None, scales=None,
    )
    c["n_unique"][0] = min(c["n_unique"][0], u_cap - 1)  # a dead slot
    if quantized:
        c["scales"] = (np.abs(vec).max(-1) / 127.0).astype(np.float32)
        vec = np.clip(np.round(vec / c["scales"][..., None]), -127, 127)
        vec = vec.astype(np.int8)
    c["vectors"] = vec
    if metric == "l2":
        c["norms"] = (vec.astype(np.float32) ** 2).sum(-1)
    return c, dict(metric=metric, q_block=q_block)


def _torch_args(c):
    return tuple(None if c[key] is None else torch.from_numpy(c[key])
                 for key in ("slot_cluster", "slot_tile", "n_unique",
                             "queries", "lo", "hi", "vectors", "attrs", "ids",
                             "norms", "scales"))


def _pallas(c, kw, k):
    args = tuple(None if c[key] is None else jnp.asarray(c[key])
                 for key in ("slot_cluster", "slot_tile", "queries", "lo",
                             "hi", "vectors", "attrs", "ids", "norms",
                             "scales"))
    out = pallas_filtered_scan_tiled(*args, interpret=True, v_block=128, k=k,
                                     **kw)
    return tuple(np.asarray(x) for x in out)


def _live(c):
    u_cap = len(c["slot_cluster"]) // len(c["n_unique"])
    pos = np.arange(len(c["slot_cluster"])) - c["slot_tile"] * u_cap
    return pos < c["n_unique"][c["slot_tile"]]


def _share(got, want):
    """max |got - want| over the tolerance, on the entries that passed."""
    gv, wv = got[0], want[0]
    live = wv > NEG_INF / 2
    atol = 1e-5 * np.abs(wv[live]).max(initial=1.0)
    err = np.where(live, np.abs(gv - wv), 0.0)
    return float((err / (atol + 1e-5 * np.abs(wv))).max())


def _assert_close(got, want, w_next, rows):
    """check_topk's rule on the live slots' rows: npass exact, values
    within the tolerance, ids exact away from near-ties."""
    gv, gi, gn = (x.numpy()[rows] for x in got)
    wv, wi, wn = (x[rows] for x in want)
    w_next = w_next[rows]
    np.testing.assert_array_equal(gn, wn)
    live = wv > NEG_INF / 2
    np.testing.assert_array_equal(gv > NEG_INF / 2, live)
    assert _share((gv, gi), (wv, wi)) <= 1.0
    atol = 1e-5 * np.abs(wv[live]).max(initial=1.0)
    gap = wv[..., :-1] - wv[..., 1:]
    big = np.full(wv.shape[:-1] + (1,), np.inf)
    prev = np.concatenate([big, gap], -1)
    nxt = np.concatenate([gap, (wv[..., -1] - w_next)[..., None]], -1)
    clear = live & (np.minimum(prev, nxt) > 2 * atol)
    np.testing.assert_array_equal(np.where(clear, gi, 0),
                                  np.where(clear, wi, 0))
    assert (gi[~live] == -1).all()


# each (pair, D, data) once, F = 1 and 2 alternating over the data sets
CASES = [(pair, d, kind, 1 + i % 2) for pair in PAIRS for d in (50, 97, 768)
         for i, kind in enumerate(DATA)]


@pytest.mark.parametrize("pair,d,kind,f", CASES)
def test_split_and_plain_match_pallas_kernel(pair, d, kind, f):
    c, kw = _case(pair, kind, d, f, seed=d)
    args = _torch_args(c)
    rows = _live(c)
    assert not rows.all()
    for k in (10, 100):
        want = _pallas(c, kw, k)
        # the value past each list, from the plain version's longer list
        w_next = filtered_scan_tiled_ref(*args, k=k + 1, **kw)[0][..., -1]
        for ref in (filtered_scan_tiled_ref, split_scan_ref):
            got = ref(*args, k=k, **kw)
            _assert_close(got, want, w_next.numpy(), rows)
            vals, ids, npass = (x.numpy() for x in got)
            assert (vals[~rows] == NEG_INF).all() and (ids[~rows] == -1).all()
            assert (npass[~rows] == 0).all()


@pytest.mark.parametrize("d", [50, 97])
def test_three_products_break_the_tolerance_on_cancelling_dots(d):
    """Why the f32 x f32 body keeps six products: hh, hm and mh alone drop
    hl, lh and mm, up to 2^-16 of each product, which the sum of the
    products' magnitudes carries past the tolerance where the dots
    cancel; the six hold it."""
    c, kw = _case("dot-f32", "cancel", d, 1, seed=d)
    args = _torch_args(c)
    rows = _live(c)
    want = tuple(x[rows] for x in _pallas(c, kw, 10))
    six = tuple(x.numpy()[rows] for x in split_scan_ref(*args, k=10, **kw))
    three = tuple(x.numpy()[rows] for x in split_scan_ref(
        *args, k=10, max_order=1, **kw))
    assert _share(six, want) < 0.25
    assert _share(three, want) > 1.0


def test_bf16_terms_are_exact_and_bf16():
    """h + m + l equals the f32 value (24 significant bits in three terms
    of 8), each term is bf16, and each lies below 2^-8 of the one before."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-30, 30, 4096)
                          ).astype(np.float32))
    h, m, low = bf16_terms(x, 3)
    assert torch.equal((h + m) + low, x)
    for t in (h, m, low):
        assert torch.equal(t.bfloat16().float(), t)
    assert bool((m.abs() <= h.abs() * 2.0 ** -8).all())
    assert bool((low.abs() <= m.abs() * 2.0 ** -8).all())
