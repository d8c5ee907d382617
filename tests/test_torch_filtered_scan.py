"""The tiled filtered scan: the port's plain version against the Pallas
kernel (interpret mode), and the wrapper's dispatch by device.  The CUDA
kernel itself is held against the plain version in test_torch_gpu.py.

Tolerances: scores rtol 1e-5 / atol 1e-5 (f32 sums taken in another
order); ids and pass counts exact (random continuous scores, no ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.filtered_scan.filtered_scan import (
    filtered_scan_tiled as pallas_filtered_scan_tiled,
)
from repro_torch.core.topk import NEG_INF
from repro_torch.kernels.filtered_scan import filtered_scan as tfs
from repro_torch.kernels.filtered_scan.ref import filtered_scan_tiled_ref

VARIANTS = {  # name: (metric, vectors dtype, quantized)
    "dot-f32": ("dot", np.float32, False),
    "dot-bf16": ("dot", "bf16", False),
    "l2-f32": ("l2", np.float32, False),
    "l2-bf16": ("l2", "bf16", False),
    "sq8": ("dot", np.int8, True),
    # f32 queries against bf16 vectors, as the sharded tiled search passes
    "dot-f32q-bf16v": ("dot", "f32q-bf16v", False),
    "l2-f32q-bf16v": ("l2", "f32q-bf16v", False),
}


def _case(variant, f, *, seed=0, n_tiles=2, q_block=8, kc=5, vpad=256,
          d=40, m=3, u_cap=4):
    """numpy operands for one variant; S = n_tiles·u_cap slots, tile-major."""
    metric, vdt, quantized = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    qpad = n_tiles * q_block
    s = n_tiles * u_cap
    c = dict(
        slot_cluster=rng.integers(0, kc, s).astype(np.int32),
        slot_tile=np.repeat(np.arange(n_tiles, dtype=np.int32), u_cap),
        n_unique=rng.integers(1, u_cap + 1, n_tiles).astype(np.int32),
        queries=rng.standard_normal((qpad, d)).astype(np.float32),
        lo=rng.integers(-20, 5, (qpad, f, m)).astype(np.int16),
        hi=rng.integers(5, 30, (qpad, f, m)).astype(np.int16),
        attrs=rng.integers(-25, 25, (kc, vpad, m)).astype(np.int16),
        ids=rng.integers(-1, 60, (kc, vpad)).astype(np.int32),
        norms=None, scales=None,
    )
    vec = rng.standard_normal((kc, vpad, d)).astype(np.float32)
    if quantized:
        c["scales"] = (np.abs(vec).max(-1) / 127.0).astype(np.float32)
        vec = np.clip(np.round(vec / c["scales"][..., None]), -127, 127)
        vec = vec.astype(np.int8)
    c["vectors"] = vec
    if metric == "l2":
        c["norms"] = (vec.astype(np.float32) ** 2).sum(-1)
    kw = dict(metric=metric, k=7, q_block=q_block)
    return c, kw, vdt if isinstance(vdt, str) else None


def _torch_args(c, bf16, device="cpu"):
    """``bf16``: "bf16" casts queries and vectors, "f32q-bf16v" the vectors
    only, None neither."""
    def t(x):
        return None if x is None else torch.from_numpy(x).to(device)

    q, v = t(c["queries"]), t(c["vectors"])
    if bf16:
        v = v.to(torch.bfloat16)
    if bf16 == "bf16":
        q = q.to(torch.bfloat16)
    return (t(c["slot_cluster"]), t(c["slot_tile"]), t(c["n_unique"]), q,
            t(c["lo"]), t(c["hi"]), v, t(c["attrs"]), t(c["ids"]),
            t(c["norms"]), t(c["scales"]))


def _jax_args(c, bf16):
    def j(x):
        return None if x is None else jnp.asarray(x)

    q, v = j(c["queries"]), j(c["vectors"])
    if bf16:
        v = v.astype(jnp.bfloat16)
    if bf16 == "bf16":
        q = q.astype(jnp.bfloat16)
    return (j(c["slot_cluster"]), j(c["slot_tile"]), q, j(c["lo"]),
            j(c["hi"]), v, j(c["attrs"]), j(c["ids"]), j(c["norms"]),
            j(c["scales"]))


def _live(c):
    u_cap = len(c["slot_cluster"]) // len(c["n_unique"])
    pos = np.arange(len(c["slot_cluster"])) - c["slot_tile"] * u_cap
    return pos < c["n_unique"][c["slot_tile"]]


def _assert_close(got, want, rows=slice(None)):
    gv, gi, gn = (x.cpu().numpy()[rows] for x in got)
    wv, wi, wn = (np.asarray(x)[rows] for x in want)
    np.testing.assert_array_equal(gn, wn)
    np.testing.assert_allclose(gv, wv, rtol=1e-5,
                               atol=1e-5 * max(np.abs(wv[wv > NEG_INF / 2]).max(initial=0), 1))
    np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("f", [1, 2])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ref_matches_pallas_kernel_on_live_slots(variant, f):
    c, kw, bf16 = _case(variant, f)
    want = pallas_filtered_scan_tiled(*_jax_args(c, bf16), interpret=True,
                                      v_block=128, **kw)
    got = filtered_scan_tiled_ref(*_torch_args(c, bf16), **kw)
    live = _live(c)
    assert not live.all()
    _assert_close(got, want, rows=live)
    vals, ids, npass = (x.numpy() for x in got)
    assert (vals[~live] == NEG_INF).all() and (ids[~live] == -1).all()
    assert (npass[~live] == 0).all()


def test_wrapper_takes_plain_path_for_cpu_tensors():
    c, kw, bf16 = _case("dot-f32", 2, seed=1)
    before = tfs.LAUNCHES
    got = tfs.filtered_scan_tiled(*_torch_args(c, bf16), **kw)
    want = filtered_scan_tiled_ref(*_torch_args(c, bf16), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tfs.LAUNCHES == before  # no kernel launch on the CPU path


def test_wrapper_rejects_other_devices_and_sq8_l2():
    c, kw, bf16 = _case("dot-f32", 1)
    args = [None if a is None else a.to("meta") for a in _torch_args(c, bf16)]
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.filtered_scan_tiled(*args, **kw)
    c, kw, _ = _case("sq8", 1)
    args = list(_torch_args(c, False))
    args[9] = torch.ones(args[6].shape[:2])  # norms beside scales
    with pytest.raises(NotImplementedError):
        tfs.filtered_scan_tiled(*args, **dict(kw, metric="l2"))


@pytest.mark.parametrize("pair", ["i8-without-scales", "bf16q-f32v"])
def test_wrapper_refuses_on_the_cpu_the_pairs_the_kernel_refuses(pair):
    """int8 rows without their scales would give unscaled scores on the
    plain route: the CPU refuses what the card refuses."""
    variant = "sq8" if pair == "i8-without-scales" else "dot-f32"
    c, kw, bf16 = _case(variant, 1)
    args = list(_torch_args(c, bf16))
    if pair == "i8-without-scales":
        args[10] = None
    else:
        args[3] = args[3].bfloat16()
    with pytest.raises(TypeError, match="not a pair the kernel takes"):
        tfs.filtered_scan_tiled(*args, **kw)
