"""CUDA-only tests of the port: each hand-written kernel against its plain
version, and the engine, the sharded search, ``search_fused``, the disk
tier and the sharded ring on the card against the same entry points on the
CPU.

They need a card and skip without one; this file imports no JAX, so it
also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: scores rtol 1e-5, atol 1e-5·max|score|; ids exact except at
near-ties (values closer than twice that atol to a neighbour), because the
kernels take their sums in another order than the plain versions: the
tiled scan on the tensor cores (bf16 products, f32 accumulators, f32
queries as three bf16 terms), the others in another f32 FMA order.  Pass
counts and the search counters are integers and stay exact.
"""

import os

import numpy as np
import pytest
import torch

from repro_torch.core import blockstore as tbs
from repro_torch.core import disk as tdisk
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as teng
from repro_torch.core import storage as tstorage
from repro_torch.core import filters as tf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core.topk import NEG_INF
from repro_torch.kernels.centroid_topk import centroid_topk as tct
from repro_torch.kernels.centroid_topk.ref import centroid_topk_ref
from repro_torch.kernels.filtered_scan import filtered_scan as tfs
from repro_torch.kernels.filtered_scan import search_fused
from repro_torch.kernels.filtered_scan.ref import (
    filtered_scan_ref,
    filtered_scan_tiled_ref,
    live_slots,
    split_scan_ref,
)

pytestmark = pytest.mark.gpu

VARIANTS = {  # name: (metric, vectors dtype, quantized)
    "dot-f32": ("dot", torch.float32, False),
    "dot-bf16": ("dot", torch.bfloat16, False),
    "l2-f32": ("l2", torch.float32, False),
    "l2-bf16": ("l2", torch.bfloat16, False),
    "sq8": ("dot", torch.int8, True),
    # f32 queries against bf16 vectors, as the sharded search passes them
    "dot-f32q-bf16v": ("dot", "f32q-bf16v", False),
    "l2-f32q-bf16v": ("l2", "f32q-bf16v", False),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(variant, f, dev, *, seed=0, n_tiles=3, q_block=72, kc=6, vpad=200,
          d=97, m=3, u_cap=5, k=7, all_live=False):
    metric, vdt, quantized = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    qpad, s = n_tiles * q_block, n_tiles * u_cap

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    vec = rng.standard_normal((kc, vpad, d)).astype(np.float32)
    queries = t(rng.standard_normal((qpad, d)).astype(np.float32))
    norms = scales = None
    if quantized:
        sc = (np.abs(vec).max(-1) / 127.0).astype(np.float32)
        vec = np.clip(np.round(vec / sc[..., None]), -127, 127).astype(np.int8)
        scales = t(sc)
    vectors = t(vec)
    if vdt == "f32q-bf16v":
        vectors = vectors.to(torch.bfloat16)
    elif not quantized:
        vectors = vectors.to(vdt)
        queries = queries.to(vdt)
    if metric == "l2":
        norms = (vectors.float() ** 2).sum(-1).contiguous()
    args = (
        t(rng.integers(0, kc, s).astype(np.int32)),
        t(np.repeat(np.arange(n_tiles, dtype=np.int32), u_cap)),
        None if all_live else t(rng.integers(1, u_cap + 1, n_tiles).astype(np.int32)),
        queries,
        t(rng.integers(-20, 5, (qpad, f, m)).astype(np.int16)),
        t(rng.integers(5, 30, (qpad, f, m)).astype(np.int16)),
        vectors,
        t(rng.integers(-25, 25, (kc, vpad, m)).astype(np.int16)),
        t(rng.integers(-1, 60, (kc, vpad)).astype(np.int32)),
        norms, scales,
    )
    return args, dict(metric=metric, k=k, q_block=q_block)


def _assert_topk_close(got, want, w_next=None, ties_by_id=True):
    """Top-k lists against the plain version's: the same entries live
    (above NEG_INF/2; pads carry id -1), values within rtol 1e-5 / atol
    1e-5·max|value|, ids exact where the value stands apart from its
    neighbours (and from ``w_next``, the plain version's next value past
    the list, where given) by more than twice that atol: sums in another
    order may swap near-ties.  ``ties_by_id``: equal values in ascending id
    order (the lower id wins a tie; the scan's ties go by row instead)."""
    gv, gi = (x.cpu().numpy() for x in got)
    wv, wi = (x.cpu().numpy() for x in want)
    live = wv > NEG_INF / 2
    np.testing.assert_array_equal(gv > NEG_INF / 2, live)
    atol = 1e-5 * max(np.abs(wv[live]).max(initial=0), 1)
    np.testing.assert_allclose(np.where(live, gv, 0), np.where(live, wv, 0),
                               rtol=1e-5, atol=atol)
    gap = np.abs(np.diff(wv, axis=-1))
    big = np.full(wv.shape[:-1] + (1,), np.inf)
    last = big if w_next is None else np.abs(wv[..., -1:] - w_next[..., None])
    clear = live & (np.minimum(np.concatenate([big, gap], -1),
                               np.concatenate([gap, last], -1)) > 2 * atol)
    np.testing.assert_array_equal(np.where(clear, gi, 0), np.where(clear, wi, 0))
    assert (gi[~live] == -1).all()
    if ties_by_id:
        tie = (gv[..., 1:] == gv[..., :-1]) & live[..., 1:]
        assert (gi[..., 1:][tie] > gi[..., :-1][tie]).all()


def _assert_close(got, want, want_next=None):
    """Tiled scan output: npass exact, then the top-k lists (ids by the
    near-tie rule; ``want_next`` is the plain version run for k + 1)."""
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())
    w_next = None if want_next is None else want_next[0][..., -1].cpu().numpy()
    _assert_topk_close(got[:2], want[:2], w_next, ties_by_id=False)


def _plain_with_next(args, kw):
    """The plain version's output, and its run for k + 1 (the next value)."""
    return (filtered_scan_tiled_ref(*args, **kw),
            filtered_scan_tiled_ref(*args, **{**kw, "k": kw["k"] + 1}))


@pytest.mark.parametrize("f", [1, 2])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kernel_matches_plain_version(cuda, variant, f):
    # ragged: D not a multiple of the kernel's depth step, Vpad not a
    # multiple of its row chunk, QB above one CTA's 64 rows
    args, kw = _case(variant, f, cuda)
    before = tfs.LAUNCHES
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES == before + 1
    _assert_close(got, *_plain_with_next(args, kw))


@pytest.mark.parametrize("k,all_live", [(1, True), (32, False), (10, True)])
def test_kernel_edge_k_and_all_live(cuda, k, all_live):
    args, kw = _case("dot-bf16", 1, cuda, seed=k, q_block=16, vpad=128,
                     d=64, k=k, all_live=all_live)
    got = tfs.filtered_scan_tiled(*args, **kw)
    _assert_close(got, *_plain_with_next(args, kw))


# (qb, k, F): each k and each F meets a tile below, at and above 64 rows
TILINGS = [(8, 32, 1), (32, 1, 2), (64, 32, 2), (128, 1, 1)]


@pytest.mark.parametrize("qb,k,f", TILINGS)
@pytest.mark.parametrize("d", [97, 100, 768])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tiled_kernel_tilings(cuda, variant, d, qb, k, f):
    # Vpad = 333: no whole 128-row chunk of the tensor-core body, nor of the
    # FMA body's 64; D = 97 and 100 take the scalar staging loads, 768 the
    # 16-byte copies (a ring of 12 depth tiles per chunk)
    args, kw = _case(variant, f, cuda, seed=d + qb, n_tiles=2, q_block=qb,
                     kc=5, vpad=333, d=d, u_cap=4, k=k)
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    _assert_close(got, *_plain_with_next(args, kw))


def test_tiled_kernel_mostly_pads(cuda):
    # 8 tiles of 40 slots with 1-2 live each, and live slots whose cluster is
    # out of range: every pad is (NEG_INF, -1, 0)
    args, kw = _case("dot-bf16", 2, cuda, seed=5, n_tiles=8, q_block=64,
                     kc=6, vpad=256, d=768, u_cap=40, k=10)
    args = list(args)
    args[2] = torch.tensor([1, 2, 1, 1, 2, 1, 1, 2], dtype=torch.int32,
                           device=cuda)
    sc = args[0].clone()
    sc[1::40] = -1
    sc[2::80] = 6  # == K: out of range
    args[0] = sc
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    want = _plain_with_next(args, kw)
    _assert_close(got, *want)
    pad = ~live_slots(args[1], args[2]) | (sc < 0) | (sc >= 6)
    assert int(pad.sum()) > 300
    assert (got[0][pad] == NEG_INF).all() and (got[1][pad] == -1).all()
    assert (got[2][pad] == 0).all()


@pytest.mark.parametrize("variant,d,m,f,body", [
    ("dot-bf16", 768, 10, 2, "tensor_cores"),
    ("l2-bf16", 97, 3, 1, "tensor_cores"),
    ("dot-f32q-bf16v", 768, 10, 2, "tensor_cores"),
    ("dot-f32", 768, 10, 2, "tensor_cores"),
    ("sq8", 768, 10, 2, "tensor_cores"),
    ("dot-bf16", 1100, 10, 2, "fma"),  # the resident query tile is too large
    ("dot-bf16", 128, 17, 1, "fma"),   # more attributes than it stages
])
def test_tiled_kernel_body_choice(cuda, variant, d, m, f, body):
    metric, vdt, quantized = VARIANTS[variant]
    qdt = (torch.float32 if quantized or vdt in ("f32q-bf16v", torch.float32)
           else vdt)
    vdt = torch.bfloat16 if vdt == "f32q-bf16v" else vdt
    assert tfs.tiled_body(d, m, f, metric, qdt, vdt) == body
    args, kw = _case(variant, f, cuda, seed=d, n_tiles=1, q_block=64, kc=3,
                     vpad=160, d=d, m=m, u_cap=3, k=10)
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    _assert_close(got, *_plain_with_next(args, kw))


# the f32 x f32 and SQ8 tensor-core bodies: each (QB, D) meets every k
NEW_PAIRS = ["dot-f32", "l2-f32", "sq8"]
SPLIT_SHAPES = [(qb, d) for qb in (32, 40, 72) for d in (50, 64, 97, 100, 768)]


def _split_with_next(args, kw):
    """split_scan_ref's output, and its run for k + 1."""
    return (split_scan_ref(*args, **kw),
            split_scan_ref(*args, **{**kw, "k": kw["k"] + 1}))


@pytest.mark.parametrize("qb,d", SPLIT_SHAPES)
@pytest.mark.parametrize("variant", NEW_PAIRS)
def test_tensor_core_f32_and_sq8_bodies(cuda, variant, qb, d):
    """f32 x f32 (dot, l2) and SQ8 on the tensor cores against the plain
    version and against the split they compute: QB at, above and across
    the 32-row warp tiling, D ragged (50, 97, 100: scalar staging) and
    whole (64, 768: 16-byte copies), k over 1, 2, 4 and 8 list slots."""
    args, kw = _case(variant, 2, cuda, seed=qb + d, n_tiles=2, q_block=qb,
                     kc=5, vpad=333, d=d, u_cap=4)
    metric, vdt, quantized = VARIANTS[variant]
    assert tfs.tiled_body(d, 3, 2, metric, torch.float32,
                          torch.int8 if quantized else vdt) == "tensor_cores"
    for k in (1, 10, 33, 100, 256):
        kw["k"] = k
        before = tfs.LAUNCHES
        got = tfs.filtered_scan_tiled(*args, **kw)
        torch.cuda.synchronize()
        assert tfs.LAUNCHES == before + 1
        _assert_close(got, *_plain_with_next(args, kw))
        _assert_close(got, *_split_with_next(args, kw))


def _unaligned(t):
    """A copy of ``t`` whose data starts 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    off = 4 // t.element_size()
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 and out.is_contiguous()
    return out


@pytest.mark.parametrize("which", ["queries", "vectors"])
@pytest.mark.parametrize("variant", NEW_PAIRS)
def test_tensor_core_bodies_unaligned_operands(cuda, variant, which):
    """An operand off a 16-byte boundary takes the scalar staging, to the
    same lists bit for bit as the 16-byte copies."""
    args, kw = _case(variant, 1, cuda, seed=7, q_block=40, vpad=300, d=64,
                     k=33)
    aligned = tfs.filtered_scan_tiled(*args, **kw)
    args = list(args)
    i = 3 if which == "queries" else 6
    args[i] = _unaligned(args[i])
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    for j in range(3):
        assert torch.equal(got[j], aligned[j])
    _assert_close(got, *_plain_with_next(args, kw))


@pytest.mark.parametrize("variant", NEW_PAIRS)
def test_tensor_core_bodies_pads_and_out_of_range(cuda, variant):
    """Dedup pads, cluster -1 and cluster K among live slots: every pad is
    (NEG_INF, -1, 0), every live slot equal to the plain version's."""
    args, kw = _case(variant, 2, cuda, seed=5, n_tiles=4, q_block=32, kc=6,
                     vpad=256, d=768, u_cap=20, k=10)
    args = list(args)
    args[2] = torch.tensor([1, 3, 2, 1], dtype=torch.int32, device=cuda)
    sc = args[0].clone()
    sc[1::20] = -1
    sc[2::40] = 6  # == K: out of range
    args[0] = sc
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    _assert_close(got, *_plain_with_next(args, kw))
    pad = ~live_slots(args[1], args[2]) | (sc < 0) | (sc >= 6)
    assert int(pad.sum()) > 60
    assert (got[0][pad] == NEG_INF).all() and (got[1][pad] == -1).all()
    assert (got[2][pad] == 0).all()


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fma_entry_point_matches_plain_version(cuda, variant, k):
    """The FMA body, which still serves M > 16 and bf16 queries at D >
    ~1000, through its own entry point on every pair: the plain version's
    lists, and no count on the search path's counter."""
    args, kw = _case(variant, 2, cuda, seed=k, q_block=72, vpad=300, d=97,
                     k=k)
    before = tfs.LAUNCHES
    got = tfs.launch_tiled_fma(*args, kw["metric"], k, kw["q_block"])
    torch.cuda.synchronize()
    assert tfs.LAUNCHES == before
    _assert_close(got, *_plain_with_next(args, kw))
    with pytest.raises(ValueError):
        tfs.launch_tiled_fma(*args, kw["metric"], 257, kw["q_block"])


ANY_K_VPAD = 300


@pytest.mark.parametrize("k", [1, 10, 32, 33, 100, 256, 257, ANY_K_VPAD])
@pytest.mark.parametrize("variant", ["dot-bf16", "l2-f32q-bf16v", "dot-f32",
                                     "sq8"])
def test_kernel_any_k(cuda, variant, k):
    """Every k up to Vpad: the register lists (1, 2, 4 or 8 slots a lane,
    both bodies) and, past 256, the sort body; equal scores go to the
    earlier row, as in the plain version.  Past Vpad (a routed tile of
    short records) the list ends in (NEG_INF, -1), as the plain
    version's."""
    args, kw = _case(variant, 1, cuda, seed=k, q_block=40, vpad=ANY_K_VPAD,
                     d=64, k=k)
    before = tfs.LAUNCHES
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES == before + 1
    if k < ANY_K_VPAD:
        _assert_close(got, *_plain_with_next(args, kw))
    else:
        _assert_close(got, filtered_scan_tiled_ref(*args, **kw))
    long_kw = {**kw, "k": ANY_K_VPAD + 5}
    longer = tfs.filtered_scan_tiled(*args, **long_kw)
    _assert_close(longer, filtered_scan_tiled_ref(*args, **long_kw))
    assert (longer[1][:, :, ANY_K_VPAD:] == -1).all()
    with pytest.raises(ValueError):
        tfs.filtered_scan_tiled(*args, **{**kw, "k": 0})


# the streaming selection on tie-heavy data: every list width's edge
TIE_KS = [1, 10, 31, 32, 33, 64, 100, 128, 129, 256]
TIE_PAIRS = ["dot-bf16", "l2-bf16", "dot-f32q-bf16v", "dot-f32", "sq8"]


def _tie_case(variant, dev, k, seed=0, n_tiles=2, q_block=40, kc=4, vpad=288,
              d=16, m=3, u_cap=3):
    """Operands whose scores are small integers, exact on every body (rows
    and queries in -2..2; SQ8 scales 1; l2 norms integers), so equal
    scores abound: the kernel's lists must equal the plain version's bit
    for bit, ties going to the earlier row.  Vpad is not a multiple of the
    128-row chunk; query rows 0-3 of each tile pass a handful of rows (a
    list of pads behind them), rows 4-7 about half, the rest every live
    row; about 5% of the rows are dead."""
    metric, vdt, quantized = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    qpad, s = n_tiles * q_block, n_tiles * u_cap

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    lo = np.full((qpad, 1, m), -32768, np.int16)
    hi = np.full((qpad, 1, m), 32767, np.int16)
    for r0 in range(0, qpad, q_block):
        lo[r0:r0 + 4, 0, 0], hi[r0:r0 + 4, 0, 0] = 0, 0
        lo[r0:r0 + 4, 0, 1], hi[r0:r0 + 4, 0, 1] = 0, 2
        lo[r0 + 4:r0 + 8, 0, 1], hi[r0 + 4:r0 + 8, 0, 1] = 0, 4
    ids = rng.permutation(kc * vpad).astype(np.int32).reshape(kc, vpad)
    ids[rng.random((kc, vpad)) < 0.05] = -1
    vec = rng.integers(-2, 3, (kc, vpad, d)).astype(np.float32)
    queries = t(rng.integers(-2, 3, (qpad, d)).astype(np.float32))
    scales = norms = None
    if quantized:
        vectors = t(vec.astype(np.int8))
        scales = t(np.ones((kc, vpad), np.float32))
    elif vdt == "f32q-bf16v":
        vectors = t(vec).to(torch.bfloat16)
    else:
        vectors, queries = t(vec).to(vdt), queries.to(vdt)
    if metric == "l2":
        norms = (vectors.float() ** 2).sum(-1).contiguous()
    attrs = np.stack([rng.integers(0, 40, (kc, vpad)),
                      rng.integers(0, 10, (kc, vpad)),
                      rng.integers(0, 10, (kc, vpad))], -1).astype(np.int16)
    args = (t(rng.integers(0, kc, s).astype(np.int32)),
            t(np.repeat(np.arange(n_tiles, dtype=np.int32), u_cap)),
            t(np.array([u_cap, u_cap - 1], np.int32)), queries, t(lo), t(hi),
            vectors, t(attrs), t(ids), norms, scales)
    return args, dict(metric=metric, k=k, q_block=q_block)


def _assert_equal_lists(got, want):
    """Values, ids and pass counts bit for bit, and the data holding what
    the case needs: ties inside the lists, pads beside full lists."""
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    vals = want[0]
    real = vals > NEG_INF / 2
    if vals.shape[-1] > 1:
        assert ((vals[..., 1:] == vals[..., :-1]) & real[..., 1:]).any()
        assert (~real).any() and real.all(-1).any()


@pytest.mark.parametrize("k", TIE_KS)
@pytest.mark.parametrize("variant", TIE_PAIRS)
def test_tiled_kernel_exact_ties(cuda, variant, k):
    """The shipped body (tensor cores at these shapes) on every dtype pair
    at every list width's edge: the plain version's lists bit for bit."""
    args, kw = _tie_case(variant, cuda, k)
    metric, vdt, quantized = VARIANTS[variant]
    assert tfs.tiled_body(16, 3, 1, metric, args[3].dtype,
                          args[6].dtype) == "tensor_cores"
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    _assert_equal_lists(got, filtered_scan_tiled_ref(*args, **kw))


@pytest.mark.parametrize("k", TIE_KS)
@pytest.mark.parametrize("variant", TIE_PAIRS)
def test_fma_body_exact_ties(cuda, variant, k):
    """The FMA body through its own entry point on the same data."""
    args, kw = _tie_case(variant, cuda, k)
    got = tfs.launch_tiled_fma(*args, kw["metric"], k, kw["q_block"])
    torch.cuda.synchronize()
    _assert_equal_lists(got, filtered_scan_tiled_ref(*args, **kw))


@pytest.mark.parametrize("k", range(1, 33))
@pytest.mark.parametrize("variant", TIE_PAIRS)
def test_one_slot_fold_exact_ties(cuda, variant, k):
    """k <= 32, one list slot a lane (the bitonic fold; the first chunk cut
    to its candidates at or above the k-th of the lanes' maxima) on every
    dtype pair: the plain version's lists bit for bit, ties to the earlier
    row."""
    args, kw = _tie_case(variant, cuda, k, seed=k)
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    want = filtered_scan_tiled_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    vals = want[0]
    real = vals > NEG_INF / 2
    if k > 1:
        assert ((vals[..., 1:] == vals[..., :-1]) & real[..., 1:]).any()
    if k >= 10:
        assert (~real).any() and real.all(-1).any()


# the tensor-core body's pairs, each metric it takes
TC_VARIANTS = ["dot-bf16", "l2-bf16", "dot-f32q-bf16v", "dot-f32", "l2-f32",
               "sq8"]


@pytest.mark.parametrize("d", [64, 768])
@pytest.mark.parametrize("variant", TC_VARIANTS)
def test_tma_ring_matches_scalar_staging(cuda, variant, d):
    """Rows 16-byte aligned with a 16-byte multiple stride take the TMA
    ring; the same operands through a view 4 bytes off a 16-byte boundary
    (queries or vectors) take the scalar staging.  The lists are equal bit
    for bit, at 1, 2 and 4 list slots, QB across the warp tilings and Vpad
    not a multiple of the 128-row chunk."""
    args, kw = _case(variant, 2, cuda, seed=d, n_tiles=2, q_block=40, kc=5,
                     vpad=333, d=d, u_cap=4)
    for k in (10, 33, 100):
        kw["k"] = k
        tma = tfs.filtered_scan_tiled(*args, **kw)
        for i in (3, 6):  # queries, vectors
            staged_args = list(args)
            staged_args[i] = _unaligned(args[i])
            staged = tfs.filtered_scan_tiled(*staged_args, **kw)
            torch.cuda.synchronize()
            for j in range(3):
                assert torch.equal(staged[j], tma[j]), (k, i, j)
        _assert_close(tma, *_plain_with_next(args, kw))


@pytest.mark.parametrize("variant", ["dot-bf16", "dot-f32q-bf16v", "dot-f32",
                                     "sq8"])
def test_cluster_major_order(cuda, variant):
    """The tensor-core body launches its CTAs by (cluster, slot), pads last:
    a plan where every tile probes cluster 2, beside other clusters, dedup
    pads, clusters -1 and K, over 320 slots (more than one CTA of the order
    kernel ranks).  Each slot's lists are its own (the plain version's),
    every pad is (NEG_INF, -1, 0), and two runs are equal bit for bit."""
    args, kw = _case(variant, 2, cuda, seed=13, n_tiles=8, q_block=64,
                     kc=6, vpad=256, d=768, u_cap=40, k=10)
    args = list(args)
    args[2] = torch.tensor([40, 3, 40, 17, 1, 40, 25, 9], dtype=torch.int32,
                           device=cuda)
    sc = args[0].clone()
    sc[0::40] = 2  # every tile's first slot: cluster 2
    sc[7::80] = -1
    sc[9::80] = 6  # == K: out of range
    args[0] = sc
    got = tfs.filtered_scan_tiled(*args, **kw)
    again = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    _assert_close(got, *_plain_with_next(args, kw))
    pad = ~live_slots(args[1], args[2]) | (sc < 0) | (sc >= 6)
    assert int(pad.sum()) > 100 and bool((~pad & (sc == 2))[0::40].all())
    assert (got[0][pad] == NEG_INF).all() and (got[1][pad] == -1).all()
    assert (got[2][pad] == 0).all()


def test_f32_products_ignore_the_callers_tf32(cuda):
    """Under ``torch.set_float32_matmul_precision("high")`` (TF32 allowed)
    the plan's slot tables and the k-means assignments are full f32's: the
    port pins its f32 products (``device.ieee_f32``) and gives the
    caller's setting back.  On this data a TF32 product would move some
    probes and some assignments."""
    from repro_torch.core import kmeans as tkm
    from repro_torch.core.filters import match_all

    rng = np.random.default_rng(0)
    d, kc, q = 256, 512, 256
    cents = torch.from_numpy(rng.standard_normal((kc, d)).astype(
        np.float32)).to(cuda)
    queries = torch.from_numpy(rng.standard_normal((q, d)).astype(
        np.float32)).to(cuda)
    rows = torch.from_numpy(rng.standard_normal((8192, d)).astype(
        np.float32)).to(cuda)
    counts = torch.ones((kc,), dtype=torch.int32, device=cuda)
    fspec = match_all(q, 3, device=cuda)

    def plan():
        return teng.plan_fused_tiled(
            cents, counts, queries, fspec.lo, fspec.hi, metric="dot",
            n_probes=7, q_block=64, u_cap=64 * 7, cast_dtype=torch.float32)

    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        want, want_a = plan(), tkm.assign(rows, cents, chunk=4096)
        f32_top = torch.topk(queries @ cents.T, 7).indices
        torch.set_float32_matmul_precision("high")
        tf32_top = torch.topk(queries @ cents.T, 7).indices
        tf32_a = torch.argmax(2.0 * (rows @ cents.T)
                              - (cents * cents).sum(-1)[None, :], -1)
        got, got_a = plan(), tkm.assign(rows, cents, chunk=4096)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    assert (tf32_top != f32_top).any()  # the data tells TF32 from f32
    assert (tf32_a.int() != want_a).any()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got_a, want_a)


def _index(variant, dev):
    metric, vdt, quantized = VARIANTS[variant]
    rng = np.random.default_rng(0)
    kc, n, d, m = 16, 4000, 32, 3
    centers = rng.standard_normal((kc, d)).astype(np.float32)
    topic = (np.arange(n) * kc) // n
    core = (centers[topic] + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    attrs = rng.integers(0, 16, (n, m)).astype(np.int16)
    attrs[:, 0] = topic * 100 + rng.integers(0, 100, n)
    spec = thy.HybridSpec(dim=d, n_attrs=m, metric=metric,
                          core_dtype=torch.float32 if quantized else vdt)
    index, _ = tivf.build_from_assignments(spec, centers, core, attrs, topic,
                                           device=dev)
    return tivf.quantize_index(index) if quantized else index


@pytest.mark.parametrize("variant", ["dot-f32", "dot-bf16", "l2-f32", "sq8"])
def test_engine_on_card_matches_engine_on_cpu(cuda, variant):
    rng = np.random.default_rng(1)
    q = 37
    qs = torch.from_numpy(rng.standard_normal((q, 32)).astype(np.float32))
    lo = np.full((q, 1, 3), -32768, np.int16)
    hi = np.full((q, 1, 3), 32767, np.int16)
    start = rng.integers(0, 1500, q)
    lo[:, 0, 0], hi[:, 0, 0] = start, start + 99
    fspec = tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))
    kw = dict(k=10, n_probes=4, q_block=16)
    cr = teng.SearchEngine(_index(variant, "cpu"), device="cpu", **kw).search(
        qs, fspec)
    before = tfs.LAUNCHES
    gr = teng.SearchEngine(_index(variant, cuda), **kw).search(
        qs.to(cuda), fspec.to(cuda))
    assert tfs.LAUNCHES == before + 1  # the card's path went through the kernel
    _assert_topk_close((gr.scores, gr.ids), (cr.scores, cr.ids),
                       ties_by_id=False)
    for c in ("n_scanned", "n_passed", "n_pruned"):
        assert torch.equal(getattr(cr, c), getattr(gr, c).cpu()), c


def test_engine_tracer_times_scan_and_merge_on_the_card(cuda):
    """Off, the card's scan and merge observe nothing (a host clock would
    time the enqueue); on, their CUDA events' time, resolved without a
    sync of their own.  The plan reads nothing to the host: the u_cap cut
    and the traffic recorder read after it (``result.*``), counted either
    way, and every plan counts as sync-free."""
    rng = np.random.default_rng(2)
    q = 37
    qs = torch.from_numpy(rng.standard_normal((q, 32)).astype(np.float32))
    fspec = tf.FilterSpec(
        lo=torch.full((q, 1, 3), -32768, dtype=torch.int16),
        hi=torch.full((q, 1, 3), 32767, dtype=torch.int16)).to(cuda)
    eng = teng.SearchEngine(_index("dot-bf16", cuda), k=10, n_probes=4,
                            q_block=16, pipeline="off")
    tr = eng.tracer
    eng.search(qs.to(cuda), fspec)
    assert "scan" not in tr.stages and "merge" not in tr.stages
    assert tr.stages["plan"].total == 1
    n = 3
    with eng.tracing():
        for _ in range(n):
            eng.search(qs.to(cuda), fspec)
    s = tr.summary()
    assert not tr._pending
    for name in ("repro.scan", "repro.merge", "repro.plan.tiles"):
        assert s["spans"][name]["count"] == n, name
        assert s["spans"][name]["device_s"] > 0, name
    assert s["spans"]["repro.plan"]["device_s"] is None
    assert s["reads"] == {site: n for site in (
        "result.provision", "result.traffic")}
    for stage in ("scan", "merge"):
        assert tr.stages[stage].total == n, stage
    assert sum(tr.reads.values()) == 2 * (n + 1)
    assert eng.stats.sync_free_plans == eng.stats.batches == n + 1


@pytest.mark.parametrize("kind", ["none", "terms", "window"])
def test_engine_two_in_flight_matches_one_at_a_time_on_the_card(cuda, kind):
    """Batch i+1 planned before batch i's answers are read (its plan reads
    nothing to the host) gives the answers, counts and u_cap cut of one
    batch at a time with the plan's reads made in the plan; the time
    window prunes, so there the deferred cut engages."""
    rng = np.random.default_rng(3)
    q, nb = 37, 4
    index = _index("dot-bf16", cuda)
    batches = []
    for _ in range(nb):
        qs = torch.from_numpy(rng.standard_normal((q, 32)).astype(np.float32))
        lo = np.full((q, 2, 3), -32768, np.int16)
        hi = np.full((q, 2, 3), 32767, np.int16)
        if kind == "terms":  # two terms, nothing pruned
            hi[:, 0, 1] = 7
            lo[:, 1, 2] = 9
        else:
            lo[:, 1], hi[:, 1] = 1, 0  # a void second term
        if kind == "window":  # topics 0-3 of 16
            start = rng.integers(0, 300, q)
            lo[:, 0, 0], hi[:, 0, 0] = start, start + 99
        fspec = tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))
        batches.append((qs.to(cuda), fspec.to(cuda)))
    kw = dict(k=10, n_probes=4, q_block=8, pipeline="off")
    ref = teng.SearchEngine(index, **kw)
    ref._defer_reads = False  # the plan-time reads, on the card
    want = [ref.search(*b) for b in batches]
    eng = teng.SearchEngine(index, **kw)
    got = []
    pend = eng.submit(*batches[0])
    for i in range(nb):
        res = eng.result(pend)
        if i + 1 < nb:
            pend = eng.submit(*batches[i + 1])
        got.append(res)
    for i, (w, g) in enumerate(zip(want, got)):
        for f in ("scores", "ids", "n_scanned", "n_passed", "n_pruned"):
            assert torch.equal(getattr(w, f), getattr(g, f)), (i, f)
    assert dict(ref.tracer.reads) == {s: nb for s in (
        "plan.route.lo", "plan.route.hi", "plan.provision")}
    assert dict(eng.tracer.reads) == {s: nb for s in (
        "result.provision", "result.traffic")}
    assert eng.stats.sync_free_plans == nb and ref.stats.sync_free_plans == 0
    assert eng.stats.u_cap_hist == ref.stats.u_cap_hist
    if kind == "window":
        assert eng.stats.last_u_cap < min(8 * 4, 16)
    assert eng.traffic.stats() == ref.traffic.stats()
    eng.close()
    ref.close()


@pytest.mark.parametrize("t", [1, 7, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_centroid_topk_matches_plain_version(cuda, metric, dtype, t):
    # ragged: Q not a multiple of the CTA's 16 queries, K of its 128-centroid
    # tile, D of its depth step; duplicated centroids force exact ties
    rng = np.random.default_rng(t)
    cents = rng.standard_normal((333, 97)).astype(np.float32)
    cents[[40, 41, 300]] = cents[7]
    queries = np.concatenate([cents[[7, 7]], rng.standard_normal((35, 97))])
    q = torch.from_numpy(queries.astype(np.float32)).to(cuda, dtype)
    c = torch.from_numpy(cents).to(cuda, dtype)
    before = tct.LAUNCHES
    got = tct.centroid_topk(q, c, t=t, metric=metric)
    torch.cuda.synchronize()
    assert tct.LAUNCHES == before + 1
    _assert_topk_close(got, centroid_topk_ref(q, c, t=t, metric=metric))
    if t >= 4:  # the duplicated group, lowest id first
        np.testing.assert_array_equal(got[1][:2, :4].cpu().numpy(),
                                      [[7, 40, 41, 300]] * 2)


@pytest.mark.parametrize("q", [1, 37, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_centroid_topk_split_k_merge(cuda, metric, dtype, q):
    # K = 1000: 8 chunks of 128 centroids, the last one partial; centroid 7
    # repeated in chunks 1, 2 and 7, so the merge across chunks decides the
    # ties (lower id first); T = 32; D = 768 takes the 16-byte copies in f32
    rng = np.random.default_rng(q)
    cents = rng.standard_normal((1000, 768)).astype(np.float32)
    cents[[130, 300, 999]] = cents[7]
    queries = rng.standard_normal((q, 768)).astype(np.float32)
    queries[0] = cents[7]
    qt = torch.from_numpy(queries).to(cuda, dtype)
    ct = torch.from_numpy(cents).to(cuda, dtype)
    got = tct.centroid_topk(qt, ct, t=32, metric=metric)
    torch.cuda.synchronize()
    wv, wi = centroid_topk_ref(qt, ct, t=33, metric=metric)
    _assert_topk_close(got, (wv[:, :32], wi[:, :32]), wv[:, 32].cpu().numpy())
    np.testing.assert_array_equal(got[1][0, :4].cpu().numpy(), [7, 130, 300, 999])


def test_centroid_topk_keeps_real_probes_where_all_scores_are_negative(cuda):
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.uniform(0.1, 1, (4, 8)).astype(np.float32)).to(cuda)
    c = -torch.from_numpy(rng.uniform(0.1, 1, (96, 8)).astype(np.float32)).to(cuda)
    got = tct.centroid_topk(q, c, t=4)
    _assert_topk_close(got, centroid_topk_ref(q, c, t=4))
    assert (got[1] >= 0).all()


@pytest.mark.parametrize("t", [32, 33, 56, 200, 333])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_centroid_topk_any_t(cuda, dtype, t):
    """Every T up to K = 333 (three chunks, the last partial): chunk lists
    of min(T, 128), merged in registers up to T = 256 and by rank past it;
    a centroid repeated in every chunk keeps its copies in id order."""
    rng = np.random.default_rng(t)
    cents = rng.standard_normal((333, 97)).astype(np.float32)
    cents[[40, 200, 300]] = cents[7]
    queries = np.concatenate([cents[[7]], rng.standard_normal((40, 97))])
    q = torch.from_numpy(queries.astype(np.float32)).to(cuda, dtype)
    c = torch.from_numpy(cents).to(cuda, dtype)
    for metric in ("dot", "l2"):
        before = tct.LAUNCHES
        got = tct.centroid_topk(q, c, t=t, metric=metric)
        torch.cuda.synchronize()
        assert tct.LAUNCHES == before + 1
        want = centroid_topk_ref(q, c, t=min(t + 1, 333), metric=metric)
        w_next = want[0][:, t].cpu().numpy() if t < 333 else None
        _assert_topk_close(got, (want[0][:, :t], want[1][:, :t]), w_next)
        np.testing.assert_array_equal(got[1][0, :4].cpu().numpy(),
                                      [7, 40, 200, 300])


@pytest.mark.parametrize("t", [100, 128, 129, 9000])
def test_centroid_topk_many_chunks(cuda, t):
    """K = 9000 (71 chunks): the shared-memory sort merge at T = 100, the
    merge by rank past it (with its bound at T = 128), up to T = K."""
    rng = np.random.default_rng(t)
    cents = rng.standard_normal((9000, 24)).astype(np.float32)
    cents[[500, 8999]] = cents[3]
    queries = np.concatenate([cents[[3]], rng.standard_normal((19, 24))])
    q = torch.from_numpy(queries.astype(np.float32)).to(cuda)
    c = torch.from_numpy(cents).to(cuda)
    got = tct.centroid_topk(q, c, t=t)
    want = centroid_topk_ref(q, c, t=min(t + 1, 9000))
    w_next = want[0][:, t].cpu().numpy() if t < 9000 else None
    _assert_topk_close(got, (want[0][:, :t], want[1][:, :t]), w_next)
    np.testing.assert_array_equal(got[1][0, :3].cpu().numpy(), [3, 500, 8999])


def _legacy_case(variant, f, dev, *, d=97, vpad=300, p=40, seed=0):
    args, kw = _case(variant, f, dev, seed=seed, d=d, vpad=vpad, q_block=9,
                     n_tiles=1)
    rng = np.random.default_rng(seed)
    kc = args[6].shape[0]
    # repeated slots on one cluster, and pad-like slots (cluster 0, query 0)
    sc = np.concatenate([np.full(8, 3), rng.integers(0, kc, p - 12),
                         np.zeros(4)]).astype(np.int32)
    sq = np.concatenate([rng.integers(0, 9, p - 4), np.zeros(4)]).astype(np.int32)
    return ((torch.from_numpy(sc).to(dev), torch.from_numpy(sq).to(dev))
            + args[3:], dict(metric=kw["metric"]))


def _assert_scores_close(got, want):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    live = w > NEG_INF / 2
    np.testing.assert_array_equal(g > NEG_INF / 2, live)
    scale = max(np.abs(w[live]).max(initial=0), 1)
    np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("d", [97, 128])  # scalar loads, 16-byte loads
@pytest.mark.parametrize("f", [1, 2])
@pytest.mark.parametrize("variant", ["dot-bf16", "dot-f32", "dot-f32q-bf16v",
                                     "sq8", "l2-f32", "l2-bf16"])
def test_filtered_scan_matches_plain_version(cuda, variant, f, d):
    args, kw = _legacy_case(variant, f, cuda, d=d)
    before = tfs.PER_PROBE_LAUNCHES
    got = tfs.filtered_scan(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.PER_PROBE_LAUNCHES == before + 1
    _assert_scores_close(got, filtered_scan_ref(*args, **kw))


def test_filtered_scan_many_queries(cuda):
    """Q = 2^20 + 8 queries: the plan's sort words widen their query field
    with Q; slots reach the last queries, repeat pairs, and fall out of
    range."""
    q, d, m, kc, vpad = (1 << 20) + 8, 16, 2, 5, 40
    rng = np.random.default_rng(3)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(cuda)

    queries = t(rng.standard_normal((q, d)).astype(np.float32))
    lo = np.full((q, 1, m), -32768, np.int16)
    hi = np.full((q, 1, m), 32767, np.int16)
    lo[-8:, 0, 0] = 0
    sq = np.concatenate([np.arange(q - 8, q), np.arange(q - 8, q),
                         rng.integers(0, q, 40), [5, q, -1, 5]])
    sc = np.concatenate([rng.integers(0, kc, 56), [1, 1, 1, kc]])
    args = (t(sc.astype(np.int32)), t(sq.astype(np.int32)), queries, t(lo),
            t(hi), t(rng.standard_normal((kc, vpad, d)).astype(np.float32)),
            t(rng.integers(-5, 5, (kc, vpad, m)).astype(np.int16)),
            t(rng.integers(-1, 99, (kc, vpad)).astype(np.int32)))
    got = tfs.filtered_scan(*args)
    torch.cuda.synchronize()
    inr = slice(0, 57)  # the in-range slots; the last three are out of range
    _assert_scores_close(got[inr], filtered_scan_ref(
        args[0][inr], args[1][inr], *args[2:]))
    assert (got[57:] == NEG_INF).all()


def _schedule_case(schedule, variant, dev, d):
    """Slot tables that stress the kernel's cluster-major schedule (pairs
    collapsed, chunks of at most 8 queries, work items of 128 rows):
    returns (args, kwargs, bad) with bad [P] bool the slots out of range."""
    rng = np.random.default_rng(7)
    vpad, q, p = {"one-cluster-many-queries": (300, 20, 60),
                  "all-pads": (129, 9, 40),
                  "pads-fan-out": (256, 9, 2000),
                  "scattered-duplicates": (200, 9, 64),
                  "out-of-range": (300, 9, 30),
                  "single-slot": (131, 9, 1),
                  "more-slots-than-one-plan": (40, 9, 9000)}[schedule]
    args, kw = _case(variant, 2, dev, seed=7, d=d, vpad=vpad, q_block=q,
                     n_tiles=1)
    kc = args[6].shape[0]
    if schedule == "one-cluster-many-queries":  # 20 queries: three chunks
        sc, sq = np.full(p, 2), np.arange(p) % q
    elif schedule in ("all-pads", "pads-fan-out"):
        sc, sq = np.zeros(p), np.zeros(p)
    elif schedule == "scattered-duplicates":  # 8 pairs, repeats apart
        sc = np.tile(np.array([1, 4, 1, 0, 5, 4, 2, 3]), p // 8)
        sq = np.tile(np.array([3, 3, 5, 0, 8, 3, 1, 1]), p // 8)
    elif schedule == "out-of-range":
        sc, sq = rng.integers(0, kc, p), rng.integers(0, q, p)
        sc[[0, 5, 6]] = [-1, kc, -7]
        sq[[1, 6, 9]] = [-1, q, q + 4]
    elif schedule == "single-slot":
        sc, sq = np.array([kc - 1]), np.array([q - 1])
    else:  # 9000 slots: two plans of at most 8192
        sc, sq = rng.integers(0, kc, p), rng.integers(0, q, p)
        sc[::3] = 0
        sq[::3] = 0
    bad = (sc < 0) | (sc >= kc) | (sq < 0) | (sq >= q)

    def t(x):
        return torch.from_numpy(x.astype(np.int32)).to(dev)

    return (t(sc), t(sq)) + args[3:], dict(metric=kw["metric"]), bad


SCHEDULES = ["one-cluster-many-queries", "all-pads", "pads-fan-out",
             "scattered-duplicates", "out-of-range", "single-slot",
             "more-slots-than-one-plan"]


@pytest.mark.parametrize("d", [97, 128])
@pytest.mark.parametrize("variant", ["dot-bf16", "dot-f32", "dot-f32q-bf16v",
                                     "sq8", "l2-f32", "l2-bf16"])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_filtered_scan_schedules(cuda, schedule, variant, d):
    """The kernel against the plain version on slot tables that collapse
    into few pairs, fan one pair out to many slots, span several chunks of
    one cluster or several plans, or hold slots out of range (rows of
    NEG_INF; the plain version is run on the slots in range)."""
    args, kw, bad = _schedule_case(schedule, variant, cuda, d)
    before = tfs.PER_PROBE_LAUNCHES
    got = tfs.filtered_scan(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.PER_PROBE_LAUNCHES == before + 1
    assert got.shape == (args[0].shape[0], args[5].shape[1])
    ok = torch.from_numpy(~bad).to(cuda)
    want = filtered_scan_ref(args[0][ok], args[1][ok], *args[2:], **kw)
    _assert_scores_close(got[ok], want)
    assert bool((got[~ok] == NEG_INF).all())


def test_filtered_scan_rejects_unsupported_dtype_pairs(cuda):
    args, kw = _legacy_case("dot-f32", 1, cuda)
    args = list(args)
    args[2] = args[2].bfloat16()  # bf16 queries against f32 vectors
    with pytest.raises(TypeError):
        tfs.filtered_scan(*args, **kw)


def _sharded_batch(q=37):
    rng = np.random.default_rng(2)
    qs = torch.from_numpy(rng.standard_normal((q, 32)).astype(np.float32))
    lo = np.full((q, 1, 3), -32768, np.int16)
    hi = np.full((q, 1, 3), 32767, np.int16)
    start = rng.integers(0, 1500, q)
    lo[:, 0, 0], hi[:, 0, 0] = start, start + 399
    return qs, tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))


@pytest.mark.parametrize("backend", ["pallas", "pallas_tiled"])
@pytest.mark.parametrize("variant", ["dot-f32", "dot-bf16", "l2-f32", "sq8"])
def test_sharded_search_on_card_matches_cpu(cuda, variant, backend):
    qs, fspec = _sharded_batch()
    q = qs.shape[0]
    metric = VARIANTS[variant][0]
    cfg = tdist.ShardedSearchConfig(k=10, n_probes=4, scan_q_block=16,
                                    backend=backend)
    res = []
    for dev, launches in ((torch.device("cpu"), 0), (cuda, 1)):
        fn, _ = tdist.make_sharded_search(metric, q_total=q, n_clusters=16,
                                          cfg=cfg, device=dev)
        before = (tct.LAUNCHES, tfs.LAUNCHES + tfs.PER_PROBE_LAUNCHES)
        res.append(fn(_index(variant, dev), qs.to(dev), fspec.to(dev)))
        after = (tct.LAUNCHES, tfs.LAUNCHES + tfs.PER_PROBE_LAUNCHES)
        # the card's path went through both kernels, the CPU's through none
        assert after == (before[0] + launches, before[1] + launches)
    cr, gr = res
    np.testing.assert_array_equal(cr.ids.numpy(), gr.ids.cpu().numpy())
    np.testing.assert_allclose(cr.scores.numpy(), gr.scores.cpu().numpy(),
                               rtol=1e-5)
    assert (gr.n_scanned == 0).all() and (gr.n_passed == 0).all()


def _two_rank_main(rank, work, variant, backend):
    """One of two ranks on the card(s): its shard of the index, the
    sharded search over a (model=2) mesh, its result and launches saved."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    tmesh.init_process_group(rank, 2, init_method=f"file://{work}/store",
                             timeout_s=120)
    try:
        mesh = tmesh.make_mesh((2,), ("model",))
        qs, fspec = _sharded_batch()
        fn, info = tdist.make_sharded_search(
            VARIANTS[variant][0], q_total=qs.shape[0], n_clusters=16,
            mesh=mesh, cfg=tdist.ShardedSearchConfig(
                k=10, n_probes=4, scan_q_block=16, backend=backend))
        shard = tdist.local_shard(_index(variant, "cuda"), rank, 2)
        before = (tct.LAUNCHES, tfs.LAUNCHES + tfs.PER_PROBE_LAUNCHES)
        res = fn(shard, qs.cuda(), fspec.to("cuda"))
        after = (tct.LAUNCHES, tfs.LAUNCHES + tfs.PER_PROBE_LAUNCHES)
        np.savez(os.path.join(work, f"rank{rank}.npz"),
                 ids=res.ids.cpu().numpy(), scores=res.scores.cpu().numpy(),
                 n_scanned=res.n_scanned.cpu().numpy(),
                 launches=np.subtract(after, before),
                 backend=dist.get_backend())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("variant,backend", [("dot-bf16", "pallas_tiled"),
                                             ("l2-f32", "pallas")])
def test_two_ranks_on_card_match_one_shard(cuda, tmp_path, variant, backend):
    """Two spawned ranks (gloo on one card, NCCL on two) each scan their
    half of the index with the kernels and tree-merge to the one-shard
    search's answer."""
    import torch.multiprocessing as mp

    qs, fspec = _sharded_batch()
    fn, _ = tdist.make_sharded_search(
        VARIANTS[variant][0], q_total=qs.shape[0], n_clusters=16,
        cfg=tdist.ShardedSearchConfig(k=10, n_probes=4, scan_q_block=16,
                                      backend=backend))
    want = fn(_index(variant, cuda), qs.to(cuda), fspec.to(cuda))
    mp.start_processes(_two_rank_main, args=(str(tmp_path), variant, backend),
                       nprocs=2, start_method="spawn")  # joins; re-raises
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert str(got["backend"]) == ("nccl" if torch.cuda.device_count() >= 2
                                       else "gloo")
        assert (got["launches"] == 1).all(), got["launches"]
        _assert_topk_close((torch.from_numpy(got["scores"]),
                            torch.from_numpy(got["ids"])),
                           (want.scores.cpu(), want.ids.cpu()),
                           ties_by_id=False)
        assert (got["n_scanned"] == 0).all()


@pytest.mark.parametrize("variant", ["dot-f32", "dot-bf16", "l2-f32", "sq8"])
def test_search_fused_on_card_matches_cpu(cuda, variant):
    rng = np.random.default_rng(3)
    qs = torch.from_numpy(rng.standard_normal((21, 32)).astype(np.float32))
    fspec = tf.match_all(21, 3, device="cpu")
    cr = search_fused(_index(variant, "cpu"), qs, fspec, k=10, n_probes=4,
                      device="cpu")
    before = tfs.PER_PROBE_LAUNCHES
    gr = search_fused(_index(variant, cuda), qs.to(cuda), fspec.to(cuda),
                      k=10, n_probes=4)
    assert tfs.PER_PROBE_LAUNCHES == before + 1
    np.testing.assert_array_equal(cr.ids.numpy(), gr.ids.cpu().numpy())
    np.testing.assert_allclose(cr.scores.numpy(), gr.scores.cpu().numpy(),
                               rtol=1e-5)
    for c in ("n_scanned", "n_passed"):
        assert torch.equal(getattr(cr, c), getattr(gr, c).cpu()), c


def _window_batch(q, seed, width=400):
    rng = np.random.default_rng(seed)
    qs = torch.from_numpy(rng.standard_normal((q, 32)).astype(np.float32))
    lo = np.full((q, 1, 3), -32768, np.int16)
    hi = np.full((q, 1, 3), 32767, np.int16)
    start = rng.integers(0, 1600 - width, q)
    lo[:, 0, 0], hi[:, 0, 0] = start, start + width - 1
    return qs, tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))


def _disk_budget(path, records):
    """A resident budget that holds ``records`` cluster records."""
    man = tstorage.load_manifest(str(path))
    with tdisk.DiskIVFIndex.open(str(path), device="cpu") as d:
        overhead = d.resident_bytes()  # an empty cache: the resident set
    return overhead + records * man["record_stride"]


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("variant", ["dot-f32", "dot-bf16", "l2-f32", "sq8"])
def test_disk_tier_on_card_matches_cpu(cuda, tmp_path, variant, pipeline):
    """The disk tier on the card (blocks assembled in pinned memory, copied
    on a side stream, scanned by the kernel) against the disk tier on the
    CPU (the plain version), under a cache that holds 5 of 16 clusters."""
    tstorage.save_index(_index(variant, "cpu"), str(tmp_path), n_shards=2)
    qs, fspec = _window_batch(37, 4)
    kw = dict(k=10, n_probes=4, q_block=16, pipeline=pipeline)
    budget = _disk_budget(tmp_path, 5)
    with tdisk.DiskIVFIndex.open(str(tmp_path), device="cpu",
                                 resident_budget_bytes=budget) as cd:
        cr = cd.search(qs, fspec, **kw)
    with tdisk.DiskIVFIndex.open(str(tmp_path),
                                 resident_budget_bytes=budget) as gd:
        assert gd.centroids.device.type == "cuda"
        before = tfs.LAUNCHES
        gr = gd.search(qs.to(cuda), fspec.to(cuda), **kw)
        assert vars(gd.cache.stats) == vars(cd.cache.stats)
    # one launch for the batch, or one per tile of 16 queries
    assert tfs.LAUNCHES == before + (1 if pipeline == "off" else 3)
    _assert_topk_close((gr.scores, gr.ids), (cr.scores, cr.ids),
                       ties_by_id=False)
    for c in ("n_scanned", "n_passed", "n_pruned"):
        assert torch.equal(getattr(cr, c), getattr(gr, c).cpu()), c


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("variant", ["dot-bf16", "l2-f32", "sq8"])
def test_live_updates_on_card_match_cpu(cuda, tmp_path, variant, pipeline):
    """A delta tier on the card (its buffers, the delta scan and the
    tombstone mask there) against one on the CPU, through the same adds and
    deletes, a republish and a refresh: the same results at every step, the
    same republished checkpoint, and the tiled kernel at k = 40 (two list
    slots a lane) and k = 100 (four)."""
    from repro_torch.core import delta as tdelta

    rng = np.random.default_rng(9)
    index = _index(variant, "cpu")
    new = (index.centroids[rng.integers(0, 16, 60)].numpy()
           + 0.3 * rng.standard_normal((60, 32))).astype(np.float32)
    new_attrs = rng.integers(0, 16, (60, 3)).astype(np.int16)
    new_attrs[:, 0] = rng.integers(0, 1600, 60)
    new_ids = np.arange(10_000, 10_060)
    kill = rng.choice(4000, 300, replace=False)
    ckpt = {}
    for side in ("cpu", "card"):
        ckpt[side] = tmp_path / side
        tstorage.save_index(index, str(ckpt[side]), n_shards=2)
    qs, fspec = _window_batch(37, 5)
    results = {}
    for side, dev in (("cpu", "cpu"), ("card", cuda)):
        with tdisk.DiskIVFIndex.open(str(ckpt[side]), device=dev) as d:
            d.delta = tdelta.DeltaTier.for_index(d, 1)
            assert d.delta.device.type == torch.device(dev).type
            d.delta.add(new, new_attrs, new_ids)
            d.delta.tombstone(np.concatenate([kill, new_ids[:5]]))
            out = []
            for k in (10, 40, 100):
                eng = teng.SearchEngine(d, k=k, n_probes=4, q_block=16,
                                        pipeline=pipeline, device=dev)
                out.append(eng.search(qs.to(dev), fspec.to(dev)))
                eng.close()
            stats = tdelta.compact_deltas(str(ckpt[side]), d.delta)
            assert d.refresh() and d.delta.stats()["rows"] == 0
            eng = teng.SearchEngine(d, k=10, n_probes=4, q_block=16,
                                    pipeline=pipeline, device=dev)
            out.append(eng.search(qs.to(dev), fspec.to(dev)))
            eng.close()
            results[side] = (out, vars(stats))
    assert results["card"][1] == results["cpu"][1]
    for cr, gr in zip(results["cpu"][0], results["card"][0]):
        _assert_topk_close((gr.scores, gr.ids), (cr.scores, cr.ids),
                           ties_by_id=False)
        for c in ("n_scanned", "n_passed", "n_pruned"):
            assert torch.equal(getattr(cr, c), getattr(gr, c).cpu()), c
    for f in sorted(os.listdir(ckpt["cpu"])):
        # f32 sums in the card's own order: the bounds, and the l2 norms of
        # the added rows in the shard records
        if f.startswith("bounds_") or (variant == "l2-f32"
                                       and f.startswith("shard_")):
            continue
        assert (ckpt["cpu"] / f).read_bytes() == \
            (ckpt["card"] / f).read_bytes(), f


@pytest.mark.parametrize("depth", [1, 3])
def test_pipelined_stream_handoff(cuda, tmp_path, depth):
    """Tiles fetched on the engine's worker and copied on side streams,
    ``depth`` of them in flight under a cache that churns, give the sync
    run's ids (operand cache on and off)."""
    tstorage.save_index(_index("dot-bf16", "cpu"), str(tmp_path), n_shards=2)
    qs, fspec = _window_batch(150, 5, width=1000)  # 10 tiles of 16
    qs, fspec = qs.to(cuda), fspec.to(cuda)
    kw = dict(k=10, n_probes=6, q_block=16)
    with tdisk.DiskIVFIndex.open(
            str(tmp_path), resident_budget_bytes=_disk_budget(tmp_path, 4),
            pin_refresh=3) as gd:
        sync = gd.search(qs, fspec, pipeline="off", **kw)
        for oc in ("on", "off"):
            eng = teng.SearchEngine(gd, pipeline="on", pipeline_depth=depth,
                                    operand_cache=oc, **kw)
            try:
                for _ in range(2):
                    got = eng.search(qs, fspec)
                    assert torch.equal(got.ids, sync.ids), oc
                    np.testing.assert_allclose(got.scores.cpu().numpy(),
                                               sync.scores.cpu().numpy(),
                                               rtol=1e-5)
                    for c in ("n_scanned", "n_passed", "n_pruned"):
                        assert torch.equal(getattr(got, c),
                                           getattr(sync, c)), c
                pending = [eng.submit(qs, fspec) for _ in range(2)]
                for p in pending:
                    assert torch.equal(eng.result(p).ids, sync.ids)
            finally:
                eng.close()
            assert eng.stats.tiles_scanned == 4 * 10
        assert gd.cache.stats.evictions > 0


def test_assemble_blocks_pinned_copy(cuda):
    """assemble_blocks(as_device=True): pinned host blocks copied on a side
    stream equal a plain .to("cuda") of the host blocks, a short record's
    dead-row fill included."""
    rng = np.random.default_rng(6)
    spec = tbs.BlockSpec(vpad=64, dim=24, n_attrs=3, has_norms=True,
                         quantized=True, store_dtype=torch.bfloat16)

    def rec(rows, cid):
        return {
            "vectors": torch.from_numpy(rng.standard_normal(
                (rows, 24)).astype(np.float32)).bfloat16(),
            "attrs": torch.from_numpy(rng.integers(
                0, 9, (rows, 3)).astype(np.int16)),
            "ids": torch.arange(rows, dtype=torch.int32) + 1000 * cid,
            "norms": torch.rand(rows), "scales": torch.rand(rows),
            "gen": torch.zeros(1, dtype=torch.int64),
        }

    recs = {c: rec(64 if c != 7 else 40, c) for c in (2, 5, 7, 11)}
    flat = np.array([5, 5, 7, 2, 11, 7, 2, 2], np.int32)
    uniq, local = tbs.first_need_unique(flat)
    host = tbs.assemble_blocks(flat, uniq, local, recs, spec)
    blocks = tbs.assemble_blocks(flat, uniq, local, recs, spec,
                                 as_device=True, device=cuda)
    assert isinstance(blocks, tbs.DeviceBlocks)
    got = tbs.wait_blocks(blocks)
    assert (host[3][list(uniq).index(7), 40:] == -1).all()  # dead rows
    for h, g in zip(host, got):
        assert g.device.type == "cuda"
        assert torch.equal(h.to(cuda), g)


# ---- the device cache, sub-partitions and termination on the card ----


def _one_tile(args, s_take=None):
    """A case's operands as one query tile: every slot serves tile 0."""
    (sc, _, _, queries, lo, hi, *rest) = args
    qb = queries.shape[0] // 3
    sc = sc if s_take is None else sc[:s_take]
    return (sc.contiguous(), torch.zeros_like(sc), None, queries[:qb],
            lo[:qb], hi[:qb], *rest), qb


@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("variant", ["dot-bf16", "dot-f32", "l2-f32",
                                     "sq8", "dot-f32q-bf16v"])
def test_tiled_kernel_segments_bitwise(cuda, variant, k):
    """Per-slot outputs do not depend on which slots share a launch: the
    scans of a slot table's segments, concatenated, equal the whole-table
    scan bit for bit, and so does a shuffled table's (the terminated
    executor's exactness rests on this)."""
    args, kw = _case(variant, 2, cuda, seed=3, u_cap=12, vpad=200)
    args, qb = _one_tile(args)
    kw.update(k=k, q_block=qb)
    whole = tfs.filtered_scan_tiled(*args, **kw)
    sc = args[0]
    for seg in (4, 5):
        parts = [tfs.filtered_scan_tiled(
            sc[p:p + seg].contiguous(), torch.zeros_like(sc[p:p + seg]),
            *args[2:], **kw) for p in range(0, sc.shape[0], seg)]
        for j in range(3):
            assert torch.equal(torch.cat([x[j] for x in parts]), whole[j])
    perm = torch.randperm(sc.shape[0], generator=torch.Generator().manual_seed(1))
    shuf = tfs.filtered_scan_tiled(sc[perm.to(cuda)].contiguous(),
                                   *args[1:], **kw)
    for j in range(3):
        assert torch.equal(shuf[j], whole[j][perm.to(cuda)])


@pytest.mark.parametrize("k", [10, 100, 200])
@pytest.mark.parametrize("variant", ["dot-bf16", "l2-f32", "sq8",
                                     "dot-f32q-bf16v"])
def test_tiled_kernel_short_blocks_bitwise(cuda, variant, k):
    """A row's score depends neither on its position nor on its block's
    height: the live rows of 384-row clusters moved, in order, into a
    128-row block scan to the same lists bit for bit (routed against flat);
    a list longer than the short block ends in (NEG_INF, -1), as the plain
    version's."""
    args, kw = _case(variant, 1, cuda, seed=5, vpad=384, u_cap=6)
    args, qb = _one_tile(args)
    kw.update(k=k, q_block=qb)
    (sc, st, _, q, lo, hi, vec, attrs, ids, norms, scales) = args
    rng = np.random.default_rng(2)
    kc = vec.shape[0]
    keep = np.zeros((kc, 384), bool)
    for c in range(kc):  # up to 128 rows spread over the tall cluster
        keep[c, np.sort(rng.choice(384, int(rng.integers(20, 129)),
                                   replace=False))] = True
    keep_t = torch.from_numpy(keep).to(cuda)
    flat_ids = torch.where(keep_t, ids, -1)
    short = [torch.zeros((kc, 128) + tuple(a.shape[2:]), dtype=a.dtype,
                         device=cuda) for a in (vec, attrs)]
    s_ids = torch.full((kc, 128), -1, dtype=torch.int32, device=cuda)
    s_aux = [None if a is None else torch.zeros((kc, 128), device=cuda)
             for a in (norms, scales)]
    for c in range(kc):
        rows = torch.from_numpy(np.nonzero(keep[c])[0]).to(cuda)
        n = rows.shape[0]
        short[0][c, :n], short[1][c, :n] = vec[c, rows], attrs[c, rows]
        s_ids[c, :n] = ids[c, rows]
        for dst, src in zip(s_aux, (norms, scales)):
            if src is not None:
                dst[c, :n] = src[c, rows]
    tall = tfs.filtered_scan_tiled(sc, st, None, q, lo, hi, vec, attrs,
                                   flat_ids, norms, scales, **kw)
    got = tfs.filtered_scan_tiled(sc, st, None, q, lo, hi, short[0],
                                  short[1], s_ids, *s_aux, **kw)
    for j in range(3):
        assert torch.equal(got[j], tall[j]), j
    want = filtered_scan_tiled_ref(*(a.cpu() if a is not None else None for a in
                                     (sc, st, None, q, lo, hi, short[0],
                                      short[1], s_ids, *s_aux)), **kw)
    _assert_close(got, want)
    if k > 128:
        assert (got[1][:, :, 128:] == -1).all()


def _cache_records(spec, rng, rows_of):
    out = {}
    for c, rows in rows_of.items():
        rec = {"vectors": torch.from_numpy(rng.standard_normal(
                   (rows, spec.dim)).astype(np.float32)).to(spec.store_dtype),
               "attrs": torch.from_numpy(rng.integers(
                   0, 9, (rows, spec.n_attrs)).astype(np.int16)),
               "ids": torch.arange(rows, dtype=torch.int32) + 1000 * c,
               "gen": torch.zeros(1, dtype=torch.int64)}
        if spec.has_norms:
            rec["norms"] = (rec["vectors"].float() ** 2).sum(-1)
        out[c] = rec
    return out


def test_device_cache_compose_matches_host_assembly(cuda):
    """Blocks stacked on the card from cache entries (records copied on the
    cache's side stream, short records padded) equal the host assembly of
    the same records at the entry height, field for field, and scan bit
    for bit like it."""
    from repro_torch.core.devicecache import DeviceBlockCache

    rng = np.random.default_rng(8)
    spec = tbs.BlockSpec(vpad=256, dim=64, n_attrs=3, has_norms=True,
                         quantized=False, store_dtype=torch.bfloat16)
    recs = _cache_records(spec, rng, {3: 256, 8: 128, 1: 256, 6: 200})
    cache = DeviceBlockCache(spec, 16 * 2**20, device=cuda)
    flat = np.array([8, 3, 3, 6, 1, 8], np.int32)
    uniq, local = tbs.first_need_unique(flat)
    entries = cache.put_records(recs)
    blocks = cache.handoff(local, cache.compose([entries[int(c)]
                                                 for c in uniq]))
    assert isinstance(blocks, tbs.DeviceBlocks)
    got = tbs.wait_blocks(blocks)
    host = tbs.assemble_blocks(flat, uniq, local, recs, spec)
    for h, g in zip(host, got):
        assert (h is None) == (g is None)
        if h is not None:
            assert torch.equal(h.to(cuda), g)
    qs = torch.randn(16, 64, device=cuda).bfloat16()
    lo = torch.full((16, 1, 3), -32768, dtype=torch.int16, device=cuda)
    hi = torch.full((16, 1, 3), 32767, dtype=torch.int16, device=cuda)
    hi[:, 0, 1] = 5
    st = torch.zeros(6, dtype=torch.int32, device=cuda)
    kw = dict(metric="l2", k=10, q_block=16)
    a = tfs.filtered_scan_tiled(got[0], st, None, qs, lo, hi, *got[1:5], **kw)
    b = tfs.filtered_scan_tiled(host[0].to(cuda), st, None, qs, lo, hi,
                                *(x.to(cuda) for x in host[1:5]), **kw)
    for j in range(3):
        assert torch.equal(a[j], b[j])


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("variant", ["dot-bf16", "l2-f32", "sq8"])
def test_device_cache_on_card_matches_cpu(cuda, tmp_path, variant, pipeline):
    """The disk tier with a device cache on the card, cold and warm, against
    the disk tier without one: the same results as on the CPU, and the
    card's own runs with and without the cache equal bit for bit."""
    tstorage.save_index(_index(variant, "cpu"), str(tmp_path), n_shards=2)
    qs, fspec = _window_batch(37, 4, width=800)
    kw = dict(k=10, n_probes=4, q_block=16, pipeline=pipeline)
    budget = _disk_budget(tmp_path, 5)
    with tdisk.DiskIVFIndex.open(str(tmp_path), device="cpu",
                                 resident_budget_bytes=budget) as cd:
        cr = cd.search(qs, fspec, **kw)
    with tdisk.DiskIVFIndex.open(str(tmp_path),
                                 resident_budget_bytes=budget) as gd:
        plain = gd.search(qs.to(cuda), fspec.to(cuda), **kw)
        eng = teng.SearchEngine(gd, device_cache=6 * gd.man["record_stride"],
                                **kw)
        for _ in range(3):
            gr = eng.search(qs.to(cuda), fspec.to(cuda))
            for f in ("ids", "scores", "n_scanned", "n_passed"):
                assert torch.equal(getattr(gr, f), getattr(plain, f)), f
        st = eng.device_cache.stats()
        assert st["hits"] > 0 and st["evictions"] > 0
        eng.close()
    _assert_topk_close((gr.scores, gr.ids), (cr.scores, cr.ids),
                       ties_by_id=False)


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("variant", ["dot-bf16", "l2-f32", "sq8"])
def test_routed_and_terminated_on_card(cuda, tmp_path, variant, pipeline):
    """On the card, over a layout-4 checkpoint: the routed search equals the
    flat one bit for bit (short sub blocks), ``termination="exact"`` equals
    the untruncated search bit for bit, and a device cache changes
    nothing; each against the CPU by the near-tie rule."""
    from repro_torch.core import partitions as tpart

    index = _index(variant, "cpu")
    build = tpart.build_partitions(index, attrs=[1])
    tstorage.save_index(index, str(tmp_path), n_shards=2, layout=4,
                        partitions=build)
    qs, fspec = _window_batch(37, 6, width=1500)
    fspec.lo[:, 0, 1] = fspec.hi[:, 0, 1] = 3  # attr1 == 3: routed
    kw = dict(k=10, n_probes=4, q_block=16, pipeline=pipeline)
    out = {}
    for side, dev in (("cpu", "cpu"), ("card", cuda)):
        with tdisk.DiskIVFIndex.open(str(tmp_path), device=dev) as d:
            runs = {}
            for name, extra in (("flat", dict(partitions="off")),
                                ("routed", {}),
                                ("term", dict(termination="exact")),
                                ("cached", dict(device_cache=2**24))):
                eng = teng.SearchEngine(d, device=dev, **kw, **extra)
                runs[name] = eng.search(qs.to(dev), fspec.to(dev))
                if name != "flat":
                    assert eng.stats.partition_hits == 37
                eng.close()
            out[side] = runs
    card = out["card"]
    for name in ("routed", "term", "cached"):
        for f in ("ids", "scores"):
            assert torch.equal(getattr(card[name], f),
                               getattr(card["flat"], f)), (name, f)
    assert (card["routed"].n_scanned <= card["flat"].n_scanned).all()
    for name, cr in out["cpu"].items():
        _assert_topk_close((card[name].scores, card[name].ids),
                           (cr.scores, cr.ids), ties_by_id=False)
        assert torch.equal(cr.n_scanned, card[name].n_scanned.cpu()), name


# ---- the sharded ring on the card ----


@pytest.mark.parametrize("transport", ["loopback", "socket"])
@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("variant", ["dot-bf16", "l2-f32", "sq8"])
def test_ring_on_card_matches_cpu(cuda, tmp_path, variant, pipeline,
                                  transport):
    """A 3-node ring (host records, fetched by peer threads, assembled in
    pinned memory and copied by the engine) feeding the engine on the card:
    the card's local-store run bit for bit, the CPU's plain path by the
    near-tie rule, and the ring's counters equal to the CPU ring's."""
    tstorage.save_index(_index(variant, "cpu"), str(tmp_path), n_shards=2)
    qs, fspec = _window_batch(37, 4, width=800)
    kw = dict(k=10, n_probes=4, q_block=16, pipeline=pipeline)
    out, stats = {}, {}
    for side, dev in (("cpu", "cpu"), ("card", cuda)):
        ring = tbs.open_sharded(str(tmp_path), n_nodes=3, transport=transport,
                                timeout_s=5.0, device=dev)
        try:
            with tdisk.DiskIVFIndex.open(str(tmp_path), device=dev) as d:
                out[side] = d.search(qs.to(dev), fspec.to(dev),
                                     blockstore=ring, **kw)
                if side == "card":
                    local = d.search(qs.to(dev), fspec.to(dev), **kw)
            stats[side] = ring.stats()
        finally:
            ring.close()
    for f in ("ids", "scores", "n_scanned", "n_passed"):
        assert torch.equal(getattr(out["card"], f), getattr(local, f)), f
    cr, gr = out["cpu"], out["card"]
    _assert_topk_close((gr.scores, gr.ids), (cr.scores, cr.ids),
                       ties_by_id=False)
    for c in ("n_scanned", "n_passed"):
        assert torch.equal(getattr(cr, c), getattr(gr, c).cpu()), c
    for key in ("l1_hits", "l1_misses", "remote_blocks", "fallback_blocks"):
        assert stats["card"][key] == stats["cpu"][key], key
    assert stats["card"]["remote_blocks"] > 0


def _twin_index(dev):
    """Near-duplicate cluster pairs, near-orthogonal pairs between them,
    attr0 a topic-owned time band and attr1 the topic id (the termination
    tests' fixture): bound-driven drops fire, and a later segment's
    clusters can be dead before they are fetched."""
    rng = np.random.default_rng(5)
    kc, n, d, m, ts_range = 16, 1536, 32, 6, 6000
    base = rng.standard_normal((kc // 2, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    step = rng.standard_normal((kc // 2, d)).astype(np.float32)
    step /= np.linalg.norm(step, axis=-1, keepdims=True)
    centers = np.empty((kc, d), np.float32)
    centers[0::2] = base
    twin = base + 0.25 * step
    centers[1::2] = twin / np.linalg.norm(twin, axis=-1, keepdims=True)
    topic = (np.arange(n) * kc) // n
    core = centers[topic] + 0.05 * rng.standard_normal((n, d)).astype(
        np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    band_of = rng.permutation(kc)
    band = ts_range // kc
    tstamp = band_of[topic] * band + rng.integers(0, band, n)
    cat = topic.copy()
    bin_ts = (np.arange(kc) * (ts_range - 1)) // (kc - 1)
    for t in range(kc):
        rows = np.where(topic == t)[0]
        tstamp[rows[:kc]] = bin_ts
        cat[rows[kc:3 * kc]] = np.repeat(np.arange(kc), 2)
    attrs = rng.integers(0, 16, (n, m)).astype(np.int16)
    attrs[:, 0] = tstamp.astype(np.int16)
    attrs[:, 1] = cat.astype(np.int16)
    spec = thy.HybridSpec(dim=d, n_attrs=m, core_dtype=torch.float32)
    index, _ = tivf.build_from_assignments(spec, centers, core, attrs,
                                           topic.astype(np.int32), device=dev)
    # 8 tight queries on three hot topics, a thin window in the topic's band
    qrng = np.random.default_rng(1)
    w = int(0.03 * ts_range)
    pairs = qrng.permutation(kc // 2)[:3]
    hot = 2 * pairs + qrng.integers(0, 2, 3)
    topics = hot[qrng.integers(0, 3, 8)]
    qs = (centers[topics] + 0.01 * qrng.standard_normal((8, d))).astype(
        np.float32)
    lo = np.full((8, 1, m), -32768, np.int16)
    hi = np.full((8, 1, m), 32767, np.int16)
    start = band_of[topics] * band + qrng.integers(0, max(band - w, 1), 8)
    lo[:, 0, 0], hi[:, 0, 0] = start, start + w - 1
    lo[:, 0, 1] = hi[:, 0, 1] = topics
    fspec = tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))
    return index, torch.from_numpy(qs), fspec


def test_segmented_terminated_on_card(cuda, tmp_path):
    """The segmented-fetch terminated executor on the card: each scanned
    segment's blocks (1-row dead records beside full clusters) fetched
    through the ring and scanned by the tiled kernel, equal to the
    untruncated ring batch bit for bit, with skipped fetches; against the
    CPU's segmented run by the near-tie rule, counters exact."""
    index, qs, fspec = _twin_index("cpu")
    tstorage.save_index(index, str(tmp_path), n_shards=2)
    kw = dict(k=10, n_probes=6, q_block=8, prune="on", pipeline="off")
    out, skipped = {}, {}
    for side, dev in (("cpu", "cpu"), ("card", cuda)):
        ring = tbs.open_sharded(str(tmp_path), n_nodes=3, device=dev)
        try:
            with tdisk.DiskIVFIndex.open(str(tmp_path), device=dev) as d:
                base = teng.SearchEngine(d, blockstore=ring, device=dev, **kw)
                r0 = base.search(qs.to(dev), fspec.to(dev))
                before = (ring.stats()["fetches_skipped"], tfs.LAUNCHES)
                term = teng.SearchEngine(d, blockstore=ring, device=dev,
                                         termination="exact", **kw)
                plan = term.plan(qs.to(dev), fspec.to(dev))
                r1 = term.execute(plan)
                skipped[side] = ring.stats()["fetches_skipped"] - before[0]
                if side == "card":  # one launch per scanned segment
                    assert tfs.LAUNCHES - before[1] == (
                        plan.n_tiles * plan.term.n_seg
                        - term.stats.term_segments_skipped) > 0
                for f in ("ids", "scores"):
                    assert torch.equal(getattr(r0, f), getattr(r1, f)), f
                assert (r1.n_scanned <= r0.n_scanned).all()
                assert term.stats.probes_terminated > 0
                out[side] = (r1, term.stats.probes_terminated)
                base.close()
                term.close()
        finally:
            ring.close()
    assert skipped["card"] > 0 and skipped["card"] == skipped["cpu"]
    (cr, cdrop), (gr, gdrop) = out["cpu"], out["card"]
    assert gdrop == cdrop
    _assert_topk_close((gr.scores, gr.ids), (cr.scores, cr.ids),
                       ties_by_id=False)
    for c in ("n_scanned", "n_passed"):
        assert torch.equal(getattr(cr, c), getattr(gr, c).cpu()), c


# ---- the index build and the serving entry point on the card ----


def _kmeans_data(seed=0, n=3000, d=32, kc=12):
    """Unit-norm rows around ``kc`` topics and a start of the topic
    centres moved a little: every row's top-two centroid gap is wide."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((kc, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    x = centers[rng.integers(0, kc, n)] + 0.15 * rng.standard_normal(
        (n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    c0 = centers + 0.1 * rng.standard_normal(centers.shape).astype(np.float32)
    return x.astype(np.float32), c0.astype(np.float32)


def _near_tie_free(x, c, gap=1e-4):
    """[N] bool: rows whose f64 top-two centroid score gap exceeds ``gap``
    (there f32 sums in any order pick the same centroid)."""
    x, c = np.asarray(x, np.float64), np.asarray(c, np.float64)
    s = 2 * x @ c.T - (c * c).sum(-1)[None, :]
    top2 = np.sort(s, -1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > gap


def test_kmeans_steps_on_card_match_cpu(cuda):
    """lloyd_step (in chunks) and minibatch_step on the card against the
    plain CPU path from the same state on the same batches: counts exact on
    rows clear of near-ties, centroids and inertia at rtol 1e-5."""
    from repro_torch.core import kmeans as tkm

    x, c0 = _kmeans_data()
    assert _near_tie_free(x, c0).all()
    xt = torch.from_numpy(x)
    ga = tkm.assign(xt.to(cuda), torch.from_numpy(c0).to(cuda), chunk=700)
    ok = _near_tie_free(x, c0)
    np.testing.assert_array_equal(
        ga.cpu().numpy()[ok], tkm.assign(xt, torch.from_numpy(c0)).numpy()[ok])
    states = {}
    for dev in ("cpu", cuda):
        st = tkm.KMeansState(torch.from_numpy(c0).to(dev),
                             torch.zeros(c0.shape[0], device=dev))
        st, inertia = tkm.lloyd_step(st, xt.to(dev), chunk=1024)
        rng = np.random.default_rng(3)
        for _ in range(5):
            idx = torch.from_numpy(rng.integers(0, x.shape[0], 256)).to(dev)
            st = tkm.minibatch_step(st, xt.to(dev)[idx])
        states[str(dev)] = (st, float(inertia))
    (cs, ci), (gs, gi) = states["cpu"], states[str(cuda)]
    np.testing.assert_array_equal(gs.counts.cpu().numpy(), cs.counts.numpy())
    np.testing.assert_allclose(gs.centroids.cpu().numpy(),
                               cs.centroids.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gi, ci, rtol=1e-5)
    assert gs.step == cs.step == 6


@pytest.mark.parametrize("metric", ["dot", "l2"])
def test_build_ivf_on_card_matches_cpu(cuda, metric):
    """build_ivf on the card (its own k-means stream) against the plain CPU
    path on the card's centroids: the same lists, row for row."""
    from repro_torch.core import kmeans as tkm

    x, _ = _kmeans_data(seed=1)
    attrs = np.random.default_rng(1).integers(0, 9, (x.shape[0], 3)).astype(
        np.int16)
    spec = thy.HybridSpec(dim=32, n_attrs=3, core_dtype=torch.bfloat16,
                          metric=metric)
    gi, gstats = tivf.build_ivf(torch.Generator(cuda).manual_seed(0), spec,
                                x, attrs, n_clusters=12, kmeans_steps=20,
                                kmeans_batch=512, assign_chunk=1000,
                                device=cuda)
    assert gi.vectors.device.type == cuda.type and gstats.kmeans_steps == 20
    cent = gi.centroids.cpu()
    assert _near_tie_free(x, cent.numpy()).all()
    ci, cstats = tivf.build_from_assignments(
        spec, cent, x, attrs, tkm.assign(torch.from_numpy(x), cent),
        device="cpu")
    for f in ("vectors", "attrs", "ids", "counts"):
        assert torch.equal(getattr(gi, f).cpu(), getattr(ci, f)), f
    if metric == "l2":
        np.testing.assert_allclose(gi.norms.cpu().numpy(), ci.norms.numpy(),
                                   rtol=1e-6)
    assert gstats.vpad == cstats.vpad and gstats.n_dropped == 0


def test_search_server_on_card_matches_engine(cuda):
    """A SearchServer over a card make_fused_search_fn: 40 requests with
    window filters (batches of 16, the tail padded) equal the engine's
    result for the same batch."""
    from repro_torch.core import serving as tsrv

    index = _index("dot-bf16", cuda)
    qs, fspec = _window_batch(40, 8)
    fn = tsrv.make_fused_search_fn(index, k=10, n_probes=4, q_block=16,
                                   device=cuda)
    want = teng.SearchEngine(index, k=10, n_probes=4, q_block=16,
                             device=cuda).search(qs.to(cuda),
                                                 fspec.to(cuda))
    server = tsrv.SearchServer(fn, batch_size=16, dim=32, n_attrs=3,
                               n_terms=1, n_shards=1, max_wait_s=0.05,
                               device=cuda)
    lo, hi = fspec.lo.numpy(), fspec.hi.numpy()
    futs = [server.submit(qs[i].numpy(), (lo[i], hi[i])) for i in range(40)]
    before = tfs.LAUNCHES
    server.start()
    try:
        resps = [f.get(timeout=120) for f in futs]
    finally:
        server.stop()
        fn.close()
    assert tfs.LAUNCHES > before
    assert server.stats["batches"] == 3
    got = (torch.from_numpy(np.stack([r.scores for r in resps])),
           torch.from_numpy(np.stack([r.ids for r in resps])))
    _assert_topk_close(got, (want.scores, want.ids), ties_by_id=False)


def test_launcher_on_card(cuda, tmp_path):
    """python -m repro_torch.launch.serve at a small size on the card: the
    build path on the RAM tier, then the disk tier with a device cache and
    a delta tier over the saved checkpoint."""
    import contextlib
    import io

    from repro_torch.launch import serve

    small = ["--n", "4000", "--dim", "32", "--clusters", "8", "--requests",
             "48", "--batch", "16", "--n-attrs", "4"]
    before = tfs.LAUNCHES
    with contextlib.redirect_stdout(io.StringIO()):
        out = serve.main(small + ["--save", str(tmp_path / "ck")])
        assert out["index"].vectors.device.type == cuda.type
        assert all(abs(r.scores[0] - 1.0) < 1e-5 for r in out["responses"])
        disk = serve.main(["--load", str(tmp_path / "ck"), "--tier", "disk",
                           "--device-cache-mb", "16", "--delta-budget-mb",
                           "1", "--compact-every", "16", "--requests", "32",
                           "--batch", "8"])
    assert tfs.LAUNCHES > before
    assert out["stats"]["requests"] == 48 and disk["stats"]["requests"] == 32
    assert disk["metrics"]["device_cache.puts"] > 0
    assert disk["delta"]["commits"] >= 1


# ---- the NCCL branch, the examples, training and recsys on the card ----

@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("d", [18, 32, 50])
def test_tiled_kernel_f32_at_the_recsys_widths(cuda, d, k):
    """The f32 x f32 body at the recsys embedding widths (D = 50 rows are
    no multiple of 16 bytes: the scalar staging) and the retrieval's
    k = 100."""
    args, kw = _case("dot-f32", 1, cuda, d=d, k=k, vpad=260)
    before = tfs.LAUNCHES
    got = tfs.filtered_scan_tiled(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES == before + 1
    _assert_close(got, *_plain_with_next(args, kw))


@pytest.mark.parametrize("d", [18, 32, 50])
def test_filtered_scan_f32_at_the_recsys_widths(cuda, d):
    """The per-probe kernel where D·4 is no multiple of 16 (18, 50: the
    scalar loads) and where it is (32)."""
    args, kw = _legacy_case("dot-f32", 1, cuda, d=d)
    before = tfs.PER_PROBE_LAUNCHES
    got = tfs.filtered_scan(*args, **kw)
    torch.cuda.synchronize()
    assert tfs.PER_PROBE_LAUNCHES == before + 1
    _assert_scores_close(got, filtered_scan_ref(*args, **kw))


def _one_rank_nccl_main(rank, work):
    """The only rank of a one-card group: ``choose_backend(1, "cuda")``
    takes NCCL.  The sharded search on a (1, 1) mesh through both backends
    and ``sharded_embedding_bag`` over the mesh's model group."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.recsys import sharded_embedding_bag

    backend = tmesh.init_process_group(rank, 1,
                                       init_method=f"file://{work}/store",
                                       timeout_s=120)
    try:
        mesh = tmesh.make_mesh((1, 1), ("data", "model"))
        qs, fspec = _sharded_batch()
        out = {"backend": np.array(backend)}
        shard = tdist.local_shard(_index("dot-f32", "cuda"), 0, 1)
        for name in ("pallas", "pallas_tiled"):
            fn, _ = tdist.make_sharded_search(
                "dot", q_total=qs.shape[0], n_clusters=16, mesh=mesh,
                cfg=tdist.ShardedSearchConfig(k=10, n_probes=4,
                                              scan_q_block=16, backend=name))
            res = fn(shard, qs.cuda(), fspec.to("cuda"))
            out[f"{name}/ids"] = res.ids.cpu().numpy()
            out[f"{name}/scores"] = res.scores.cpu().numpy()
        table, ids = _bag_data()
        for mode in ("sum", "mean"):
            out[f"bag/{mode}"] = sharded_embedding_bag(
                table.cuda(), ids.cuda(), mesh, mode=mode).cpu().numpy()
        np.savez(os.path.join(work, "nccl.npz"), **out)
    finally:
        dist.destroy_process_group()


def _bag_data():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 50, (9, 6)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    return (torch.from_numpy(rng.standard_normal((50, 8)).astype(np.float32)),
            torch.from_numpy(ids))


def test_one_rank_nccl_group_matches_the_meshless_search(cuda, tmp_path):
    """A spawned rank alone on the card takes the NCCL branch; its sharded
    search on a (1, 1) mesh equals the search without a mesh, and the
    sharded embedding bag over its model group the plain bag."""
    import torch.multiprocessing as mp

    from repro_torch.models.recsys import embedding_bag

    mp.start_processes(_one_rank_nccl_main, args=(str(tmp_path),), nprocs=1,
                       start_method="spawn")  # joins; re-raises
    got = np.load(tmp_path / "nccl.npz")
    assert str(got["backend"]) == "nccl"
    qs, fspec = _sharded_batch()
    for name in ("pallas", "pallas_tiled"):
        fn, _ = tdist.make_sharded_search(
            "dot", q_total=qs.shape[0], n_clusters=16,
            cfg=tdist.ShardedSearchConfig(k=10, n_probes=4, scan_q_block=16,
                                          backend=name))
        want = fn(_index("dot-f32", cuda), qs.to(cuda), fspec.to(cuda))
        np.testing.assert_array_equal(got[f"{name}/ids"],
                                      want.ids.cpu().numpy())
        np.testing.assert_array_equal(got[f"{name}/scores"],
                                      want.scores.cpu().numpy())
    table, ids = _bag_data()
    for mode in ("sum", "mean"):
        np.testing.assert_allclose(
            got[f"bag/{mode}"], embedding_bag(table, ids, mode=mode).numpy(),
            rtol=1e-6, atol=1e-7)


def _load_example(name):
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), "..", "examples", "torch",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"card_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_examples_on_card(cuda, tmp_path):
    """Each port example on the card at a tiny size, with its claims held
    and its search paths through the kernels."""
    before = (tfs.LAUNCHES, tfs.PER_PROBE_LAUNCHES)
    out = _load_example("quickstart").main(["--n", "5000"])
    assert out["fused_identical"] and out["self_ids"] == list(
        range(5000, 5005))
    assert tfs.PER_PROBE_LAUNCHES > before[1]
    out = _load_example("kmeans_index_build").main(["--n", "8000"])
    assert out["lloyd"]["recall"] >= out["minibatch"]["recall"]
    assert out["restored_recall"] == out["lloyd"]["recall"]
    out = _load_example("filtered_search_serving").main(
        ["--n", "8000", "--requests", "48", "--term-n", "4000",
         "--part-n", "6000"])
    assert out["responses_equal"] and out["routed_rows"] < out["flat_rows"]
    assert tfs.LAUNCHES > before[0]
    out = _load_example("train_embedder").main(
        ["--steps", "60", "--corpus", "3000", "--ckpt-dir", str(tmp_path)])
    assert out["losses"][-1] < out["losses"][0] / 10
    assert out["recall"] >= 0.6 and out["hit1"] >= 0.85
    out = _load_example("recsys_retrieval").main(["--items", "20000"])
    assert out["filters_ok"] and out["n_cand"] == 100


RECSYS = ("din", "sasrec", "bst", "wide_deep")


def _recsys_trainer(arch, dev, params, optimizer="adamw", ckpt_dir=None,
                    total=3):
    import importlib

    from repro_torch.models.recsys import RecsysBatch, loss_fn
    from repro_torch.train.train_loop import Trainer, TrainLoopConfig

    cfg = importlib.import_module(f"repro_torch.configs.{arch}").smoke_config()
    tcfg = TrainLoopConfig(total_steps=total, ckpt_every=2, ckpt_dir=ckpt_dir,
                           log_every=100, lr=1e-3, warmup=0,
                           optimizer=optimizer)
    return cfg, Trainer(lambda p, b: loss_fn(p, cfg, RecsysBatch(**b)),
                        params, tcfg, device=dev)


def _recsys_feeder(cfg):
    from repro_torch.data import ShardedFeeder, recsys_batch

    return ShardedFeeder(
        lambda s, i: recsys_batch(s, i, 64, cfg.seq_len, cfg.n_dense,
                                  cfg.n_sparse, cfg.vocab_items,
                                  cfg.vocab_sparse), seed=0)


def _recsys_params(arch):
    import importlib

    from repro_torch.models.recsys import init_params

    cfg = importlib.import_module(f"repro_torch.configs.{arch}").smoke_config()
    return init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def _train_leaves(trainer):
    from repro_torch.train.tree import leaves_with_paths

    return {"/".join(p): x.detach().cpu()
            for p, x in leaves_with_paths({"params": trainer.params,
                                           "opt": trainer.opt_state})}


@pytest.mark.parametrize("arch,optimizer", [(a, "adamw") for a in RECSYS]
                         + [("wide_deep", "adafactor")])
def test_recsys_step_on_card_matches_cpu(cuda, arch, optimizer):
    """One Trainer step of each smoke config on the card against the same
    step on the CPU from the same parameters: the loss and the optimizer
    state within rtol 1e-4; the parameters too, but for at most 0.1% of a
    leaf's elements, which may differ by up to 2·lr: a first step is
    g / (|g| + eps) an element, so a gradient at f32 rounding level (a sum
    that cancels) takes another size or sign on the other device."""
    from repro_torch.train.checkpoint import params_from_numpy
    from repro_torch.train.tree import tree_map

    host = tree_map(lambda x: x.numpy(), _recsys_params(arch))
    runs = []
    for dev in ("cpu", cuda):
        cfg, trainer = _recsys_trainer(arch, dev,
                                       params_from_numpy(host, dev),
                                       optimizer)
        feeder = _recsys_feeder(cfg)
        try:
            hist = trainer.run(feeder, max_steps=1)
        finally:
            feeder.close()
        runs.append((hist, trainer))
    (ch, ct), (gh, gt) = runs
    assert gt.params["item_table"].device.type == cuda.type
    np.testing.assert_allclose(gh["loss"], ch["loss"], rtol=1e-4)
    cl, gl = _train_leaves(ct), _train_leaves(gt)
    lr = ct.cfg.lr
    for key in cl:
        want, got = cl[key].numpy(), gl[key].numpy()
        if not key.startswith("params/"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                       err_msg=key)
            continue
        err = np.abs(got - want)
        off = err > 1e-4 * np.abs(want) + 1e-6
        assert off.sum() <= 1e-3 * want.size, (key, int(off.sum()))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6 + 2 * lr,
                                   err_msg=key)


def test_recsys_restart_on_card_is_bit_for_bit(cuda, tmp_path):
    """sasrec (duplicate ids in every batch): 4 steps straight against 2
    steps, a checkpoint, a fresh Trainer and 2 more — identical parameters
    and optimizer state bit for bit."""
    params = _recsys_params("sasrec")

    def run(ckpt, max_steps=None):
        from repro_torch.train.checkpoint import params_from_numpy
        from repro_torch.train.tree import tree_map

        cfg, trainer = _recsys_trainer(
            "sasrec", cuda, params_from_numpy(
                tree_map(lambda x: x.numpy(), params), cuda),
            ckpt_dir=str(ckpt), total=4)
        feeder = _recsys_feeder(cfg)
        try:
            trainer.run(feeder, max_steps=max_steps)
        finally:
            feeder.close()
        return trainer

    straight = run(tmp_path / "a")
    assert run(tmp_path / "b", max_steps=2).step == 2
    resumed = run(tmp_path / "b")
    assert resumed.step == straight.step == 4
    want, got = _train_leaves(straight), _train_leaves(resumed)
    for key in want:
        assert torch.equal(got[key], want[key]), key


# ---- the LM family, DimeNet, expert parallelism and the launcher ----

LM_SMOKE = ("chatglm3_6b", "deepseek_moe_16b", "deepseek_v3_671b",
            "gemma3_12b", "gemma3_27b")


def _lm_cfg(name):
    import importlib

    return importlib.import_module(f"repro_torch.configs.{name}"
                                   ).smoke_config()


def _lm_host(cfg, seed=0):
    from repro_torch.models.transformer import init_params

    return init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _on(tree, dev):
    from repro_torch.train.tree import tree_map

    return tree_map(lambda x: x.to(dev), tree)


@pytest.mark.parametrize("name", LM_SMOKE)
def test_lm_smoke_on_card_matches_cpu(cuda, name):
    """forward, lm_loss and its gradients, prefill + 6 decode steps of each
    LM smoke config (f32) on the card against the CPU: rtol 1e-4, atol 1e-5
    (gradients atol 1e-6)."""
    from repro_torch.models import decoding as dec
    from repro_torch.models import transformer as tr
    from repro_torch.train.tree import leaves, unflatten_like

    cfg = _lm_cfg(name)
    host = _lm_host(cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    labels[:, -1] = -1
    out = []
    for dev in ("cpu", cuda):
        params = _on(host, dev)
        t, lab = (torch.from_numpy(a).to(dev) for a in (tokens, labels))
        flat = [x.clone().requires_grad_(True) for x in leaves(params)]
        loss, _ = tr.lm_loss(unflatten_like(params, flat), cfg, t, lab)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        with torch.no_grad():
            h, _ = tr.forward(params, cfg, t)
            pre, cache = dec.prefill(params, cfg, t[:, :18], 24)
            dp = dec.decode_layout(params, cfg)
            steps = [dec.decode_step(dp, cfg, cache, t[:, j], j)[0].cpu()
                     for j in range(18, 24)]
        out.append((loss.item(), h.cpu(), pre.cpu(), steps,
                    [None if g is None else g.cpu() for g in grads]))
    (cl, ch, cp, cs, cg), (gl, gh, gp, gs, gg) = out
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    torch.testing.assert_close(gh, ch, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gp, cp, rtol=1e-4, atol=1e-5)
    for a, b in zip(gs, cs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for a, b in zip(gg, cg):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_dimenet_step_on_card_matches_cpu(cuda):
    """One Trainer step of DimeNet's smoke config on a sampled batch, on the
    card against the CPU: the loss rtol 1e-4 (the scatter-adds use atomics
    on the card), and the parameters as the recsys steps hold them."""
    from repro_torch.configs import dimenet as dcfg
    from repro_torch.models.gnn import GraphBatch, init_params, loss_fn
    from repro_torch.models.gnn.sampler import (
        make_graph_batch_arrays, random_graph, sample_subgraph)
    from repro_torch.train.train_loop import Trainer, TrainLoopConfig

    cfg = dcfg.smoke_config()
    rng = np.random.default_rng(0)
    g = random_graph(rng, 500, 6, cfg.d_feat, cfg.d_out)
    nodes, es, ed = sample_subgraph(rng, g, np.arange(32, dtype=np.int32),
                                    [5, 3])
    arrs = make_graph_batch_arrays(g, nodes, es, ed, n_pad=512, e_pad=1024,
                                   t_pad=4096)
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    res = []
    for dev in ("cpu", cuda):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in arrs.items()}
        gb = GraphBatch(**{k: batch[k] for k in (
            "node_feat", "positions", "edge_src", "edge_dst", "edge_mask",
            "trip_in", "trip_out", "trip_mask", "graph_id")})
        trainer = Trainer(lambda p, b: loss_fn(p, cfg, gb, b["labels"]),
                          _on(host, dev), TrainLoopConfig(
                              total_steps=1, log_every=100, lr=1e-3,
                              warmup=0), device=dev)
        loss = trainer._train_step(trainer.params, trainer.opt_state,
                                   {"labels": batch["labels"]}, 0, 1.0)
        res.append(({k: v.cpu() for k, v in loss[0].items()
                     if k != "blocks"} | {f"blocks/{k}": v.cpu() for k, v in
                                          loss[0]["blocks"].items()},
                    float(loss[2]["loss"])))
    (cp, cl), (gp, gl) = res
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    for key in cp:
        err = (gp[key] - cp[key]).abs()
        off = err > 1e-4 * cp[key].abs() + 1e-6
        assert int(off.sum()) <= 1e-3 * cp[key].numel(), key
        torch.testing.assert_close(gp[key], cp[key], rtol=1e-4,
                                   atol=1e-6 + 2e-3)


def _ep_rank_main(rank, work):
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    from repro_torch.models import transformer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    backend = tmesh.init_process_group(rank, 2,
                                       init_method=f"file://{work}/store",
                                       timeout_s=120)
    try:
        mesh = tmesh.make_mesh((1, 2), ("data", "model"))
        cfg = _lm_cfg("deepseek_moe_16b")
        params = _on(_lm_host(cfg), "cuda")
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 16)).astype(np.int32)).cuda()
        out = {"backend": np.array(backend)}
        import dataclasses
        for combine in ("psum", "scatter"):
            c = dataclasses.replace(cfg, moe_combine=combine)
            with torch.no_grad():
                h, _ = tr.forward(tr.local_params(params, c, mesh), c, tokens,
                                  mesh=mesh)
            out[combine] = h.cpu().numpy()
        np.savez(os.path.join(work, f"ep_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_expert_parallel_two_ranks_on_card(cuda, tmp_path):
    """Two gloo ranks sharing the card, (data=1, model=2): the
    expert-parallel forward with both combines equals the single-device
    forward (rtol 1e-5)."""
    import torch.multiprocessing as mp

    from repro_torch.models import transformer as tr

    mp.start_processes(_ep_rank_main, args=(str(tmp_path),), nprocs=2,
                       start_method="spawn")  # joins; re-raises
    cfg = _lm_cfg("deepseek_moe_16b")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32)).to(cuda)
    with torch.no_grad():
        want, _ = tr.forward(_on(_lm_host(cfg), cuda), cfg, tokens)
    for rank in range(2):
        got = np.load(tmp_path / f"ep_{rank}.npz")
        assert str(got["backend"]) == "gloo"
        for combine in ("psum", "scatter"):
            np.testing.assert_allclose(got[combine], want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_bf16_checkpoint_round_trip_on_card(cuda, tmp_path):
    """chatglm3-6b's smoke config in bf16 on the card: 2 steps, a
    checkpoint, a fresh Trainer and 2 more equal 4 straight bit for bit."""
    import dataclasses

    from repro_torch.data import ShardedFeeder, lm_batch
    from repro_torch.models.transformer import lm_loss
    from repro_torch.train.train_loop import Trainer, TrainLoopConfig
    from repro_torch.train.tree import leaves_with_paths

    cfg = dataclasses.replace(_lm_cfg("chatglm3_6b"), dtype=torch.bfloat16)
    host = _lm_host(cfg)

    def run(ckpt, max_steps=None):
        trainer = Trainer(
            lambda p, b: lm_loss(p, cfg, b["tokens"], b["labels"]),
            _on(host, cuda), TrainLoopConfig(
                total_steps=4, ckpt_every=2, ckpt_dir=str(ckpt),
                log_every=100, lr=1e-3, warmup=0), device=cuda)
        feeder = ShardedFeeder(lambda s, i: lm_batch(s, i, 4, 32, 512),
                               seed=0)
        try:
            trainer.run(feeder, max_steps=max_steps)
        finally:
            feeder.close()
        return trainer

    straight = run(tmp_path / "a")
    assert run(tmp_path / "b", max_steps=2).step == 2
    resumed = run(tmp_path / "b")
    want = dict(leaves_with_paths({"p": straight.params,
                                   "o": straight.opt_state}))
    assert straight.params["embed"].dtype == torch.bfloat16
    for path, got in leaves_with_paths({"p": resumed.params,
                                        "o": resumed.opt_state}):
        assert got.dtype == want[path].dtype and torch.equal(got, want[path])


@pytest.mark.parametrize("arch", ["chatglm3-6b", "deepseek-moe-16b",
                                  "gemma3-12b", "dimenet", "wide-deep"])
def test_launch_train_main_on_card(cuda, arch):
    """``launch.train.main`` on the card (its default device) for 3 steps
    from parameters drawn on the CPU: the first loss equals the CPU run's
    (rtol 1e-4), every loss finite."""
    import importlib

    from repro_torch.launch import train as launcher

    if arch == "dimenet":
        from repro_torch.models.gnn import init_params
        module = importlib.import_module("repro_torch.configs.dimenet")
    elif arch in launcher.LM_ARCHS:
        from repro_torch.models.transformer import init_params
        module = launcher.LM_ARCHS[arch]
    else:
        from repro_torch.models.recsys import init_params
        module = launcher.RECSYS_ARCHS[arch]
    cfg = module.smoke_config()
    host = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    argv = ["--arch", arch, "--steps", "3"]
    card = launcher.main(argv, params=host)
    cpu = launcher.main(argv + ["--device", "cpu"], params=host)
    np.testing.assert_allclose(card["loss"][0], cpu["loss"][0], rtol=1e-4)
    assert all(np.isfinite(card["loss"]))


# ---- the kernels' custom ops (the dry-run's trace passes through them) ----
def _op_case(dev, seed=3, kc=7, vpad=150, d=97, m=3, f=2, q=40, p=29):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return dict(
        queries=t(rng.standard_normal((q, d)).astype(np.float32)),
        vectors=t(rng.standard_normal((kc, vpad, d)).astype(np.float32)),
        attrs=t(rng.integers(0, 6, (kc, vpad, m)).astype(np.int16)),
        ids=t(np.arange(kc * vpad, dtype=np.int32).reshape(kc, vpad)),
        lo=t(np.zeros((q, f, m), np.int16)),
        hi=t(rng.integers(2, 6, (q, f, m)).astype(np.int16)),
        slot_cluster=t(rng.integers(0, kc, p).astype(np.int32)),
        slot_query=t(rng.integers(0, q, p).astype(np.int32)),
    )


def test_centroid_topk_op_on_the_card(cuda):
    """``torch.ops.repro_torch.centroid_topk`` on CUDA tensors launches the
    kernel (one count) and agrees with the plain version."""
    x = _op_case(cuda)
    cents = x["vectors"][:, 0].contiguous()
    before = tct.LAUNCHES
    vals, ids = torch.ops.repro_torch.centroid_topk(x["queries"], cents, 3,
                                                    "dot")
    torch.cuda.synchronize()
    assert tct.LAUNCHES == before + 1
    wv, wi = centroid_topk_ref(x["queries"], cents, t=3)
    torch.testing.assert_close(vals, wv, rtol=1e-5, atol=1e-5)
    assert torch.equal(ids, wi)


def test_filtered_scan_op_on_the_card(cuda):
    """``torch.ops.repro_torch.filtered_scan`` launches the per-probe kernel
    and agrees with the plain version."""
    x = _op_case(cuda)
    args = (x["slot_cluster"], x["slot_query"], x["queries"], x["lo"],
            x["hi"], x["vectors"], x["attrs"], x["ids"], None, None, "dot")
    before = tfs.PER_PROBE_LAUNCHES
    got = torch.ops.repro_torch.filtered_scan(*args)
    torch.cuda.synchronize()
    assert tfs.PER_PROBE_LAUNCHES == before + 1
    want = filtered_scan_ref(*args[:-1], metric="dot")
    live = want > NEG_INF / 2
    assert torch.equal(got > NEG_INF / 2, live)
    torch.testing.assert_close(got[live], want[live], rtol=1e-5,
                               atol=1e-5 * float(want[live].abs().max()))


def test_filtered_scan_tiled_op_on_the_card(cuda):
    """``torch.ops.repro_torch.filtered_scan_tiled`` launches the tiled
    kernel and agrees with the plain version (k past Vpad included)."""
    x = _op_case(cuda)
    qb = 8
    s = x["slot_cluster"].shape[0]
    tile = (torch.arange(s, device=cuda) % 5).int()
    args = (x["slot_cluster"], tile, None, x["queries"], x["lo"], x["hi"],
            x["vectors"], x["attrs"], x["ids"], None, None, "dot", 160, qb)
    before = tfs.LAUNCHES
    vals, ids, npass = torch.ops.repro_torch.filtered_scan_tiled(*args)
    torch.cuda.synchronize()
    assert tfs.LAUNCHES == before + 1
    wv, wi, wn = filtered_scan_tiled_ref(*args[:11], metric="dot", k=160,
                                         q_block=qb)
    assert vals.shape == wv.shape and ids.dtype == wi.dtype
    assert torch.equal(npass, wn)
    live = wv > NEG_INF / 2
    assert torch.equal(vals > NEG_INF / 2, live)
    torch.testing.assert_close(vals[live], wv[live], rtol=1e-5,
                               atol=1e-5 * float(wv[live].abs().max()))
