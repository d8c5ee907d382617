"""CUDA-only tests of the port: the hand-written kernel against its plain
version, and the engine on the card against the engine on the CPU.

They need a card and skip without one; this file imports no JAX, so it
also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: scores rtol 1e-5, atol 1e-5·max|score| (f32 sums taken in
another order); ids and pass counts exact (continuous random scores).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine as teng
from repro_torch.core import filters as tf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core.topk import NEG_INF
from repro_torch.kernels.filtered_scan import filtered_scan as tfs
from repro_torch.kernels.filtered_scan.ref import filtered_scan_tiled_ref

pytestmark = pytest.mark.gpu

VARIANTS = {  # name: (metric, vectors dtype, quantized)
    "dot-f32": ("dot", torch.float32, False),
    "dot-bf16": ("dot", torch.bfloat16, False),
    "l2-f32": ("l2", torch.float32, False),
    "l2-bf16": ("l2", torch.bfloat16, False),
    "sq8": ("dot", torch.int8, True),
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
    if not quantized:
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


def _assert_close(got, want):
    gv, gi, gn = (x.cpu().numpy() for x in got)
    wv, wi, wn = (x.cpu().numpy() for x in want)
    np.testing.assert_array_equal(gn, wn)
    scale = max(np.abs(wv[wv > NEG_INF / 2]).max(initial=0), 1)
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_array_equal(gi, wi)


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
    _assert_close(got, filtered_scan_tiled_ref(*args, **kw))


@pytest.mark.parametrize("k,all_live", [(1, True), (32, False), (10, True)])
def test_kernel_edge_k_and_all_live(cuda, k, all_live):
    args, kw = _case("dot-bf16", 1, cuda, seed=k, q_block=16, vpad=128,
                     d=64, k=k, all_live=all_live)
    got = tfs.filtered_scan_tiled(*args, **kw)
    _assert_close(got, filtered_scan_tiled_ref(*args, **kw))


def test_kernel_rejects_large_k(cuda):
    args, kw = _case("dot-f32", 1, cuda, k=33, vpad=128)
    with pytest.raises(NotImplementedError):
        tfs.filtered_scan_tiled(*args, **kw)


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
    np.testing.assert_array_equal(cr.ids.numpy(), gr.ids.cpu().numpy())
    np.testing.assert_allclose(cr.scores.numpy(), gr.scores.cpu().numpy(),
                               rtol=1e-5)
    for c in ("n_scanned", "n_passed", "n_pruned"):
        assert torch.equal(getattr(cr, c), getattr(gr, c).cpu()), c
