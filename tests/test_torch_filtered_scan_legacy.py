"""The per-probe filtered scan and ``search_fused``: the port's plain version
against the Pallas kernel (interpret mode), and the port's ``search_fused``
against the reference's on the same indexes.  The CUDA kernel itself is
held against the plain version in test_torch_gpu.py.

Tolerances: scores rtol 1e-5 / atol 1e-5·max|score| (f32 sums taken in
another order); the NEG_INF mask, ids and the n_scanned / n_passed
counters exact (random continuous scores, no ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.kernels.filtered_scan import filtered_scan as jax_filtered_scan
from repro.kernels.filtered_scan import search_fused as jax_search_fused
from repro_torch.core import filters as tf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import search as tsearch
from repro_torch.core.topk import NEG_INF
from repro_torch.kernels.filtered_scan import filtered_scan as tfs
from repro_torch.kernels.filtered_scan import filtered_scan_ref, search_fused

VARIANTS = {  # name: (metric, query dtype, vector dtype, quantized)
    "dot-f32": ("dot", "f32", "f32", False),
    "dot-bf16": ("dot", "bf16", "bf16", False),
    "dot-f32q-bf16v": ("dot", "f32", "bf16", False),
    "l2-f32": ("l2", "f32", "f32", False),
    "sq8": ("dot", "f32", "i8", True),
}


def _case(variant, f, *, seed=0, p=70, q=9, kc=5, vpad=256, d=40, m=3):
    """numpy operands; P = 70 slots spans two of the plain version's chunks
    of 64, and every cluster is scanned by several slots."""
    metric, _, _, quantized = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    c = dict(
        slot_cluster=rng.integers(0, kc, p).astype(np.int32),
        slot_query=rng.integers(0, q, p).astype(np.int32),
        queries=rng.standard_normal((q, d)).astype(np.float32),
        lo=rng.integers(-20, 5, (q, f, m)).astype(np.int16),
        hi=rng.integers(5, 30, (q, f, m)).astype(np.int16),
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
    return c, metric


def _torch_args(c, variant):
    _, qdt, vdt, _ = VARIANTS[variant]

    def t(x):
        return None if x is None else torch.from_numpy(x)

    q, v = t(c["queries"]), t(c["vectors"])
    q = q.bfloat16() if qdt == "bf16" else q
    v = v.bfloat16() if vdt == "bf16" else v
    return (t(c["slot_cluster"]), t(c["slot_query"]), q, t(c["lo"]),
            t(c["hi"]), v, t(c["attrs"]), t(c["ids"]), t(c["norms"]),
            t(c["scales"]))


def _jax_args(c, variant):
    _, qdt, vdt, _ = VARIANTS[variant]

    def j(x):
        return None if x is None else jnp.asarray(x)

    q, v = j(c["queries"]), j(c["vectors"])
    q = q.astype(jnp.bfloat16) if qdt == "bf16" else q
    v = v.astype(jnp.bfloat16) if vdt == "bf16" else v
    return (j(c["slot_cluster"]), j(c["slot_query"]), q, j(c["lo"]),
            j(c["hi"]), v, j(c["attrs"]), j(c["ids"]), j(c["norms"]),
            j(c["scales"]))


def _assert_scores(got, want):
    got, want = got.numpy(), np.asarray(want)
    live = want > NEG_INF / 2
    np.testing.assert_array_equal(got > NEG_INF / 2, live)
    scale = max(np.abs(want[live]).max(initial=0), 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("f", [1, 2])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plain_version_matches_pallas_kernel(variant, f):
    c, metric = _case(variant, f)
    want = jax_filtered_scan(*_jax_args(c, variant), metric=metric,
                             v_block=128, interpret=True)
    got = tfs.filtered_scan(*_torch_args(c, variant), metric=metric)
    assert got.shape == (70, 256) and got.dtype == torch.float32
    _assert_scores(got, want)


SCHEDULES = {  # name: (slot_cluster, slot_query) for P = 70, Q = 9, K = 5
    # 6 distinct (cluster, query) pairs repeated, the repeats apart
    "heavy-duplication": (np.tile([1, 4, 1, 0, 4, 2], 12)[:70],
                          np.tile([3, 3, 5, 0, 3, 8], 12)[:70]),
    # every slot a dispatch pad (cluster 0, query 0)
    "all-pads": (np.zeros(70), np.zeros(70)),
    # one cluster probed by all 9 queries, and pads after the live slots
    "one-cluster-many-queries": (np.concatenate([np.full(54, 2), np.zeros(16)]),
                                 np.concatenate([np.arange(54) % 9,
                                                 np.zeros(16)])),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_plain_version_matches_pallas_kernel_on_schedules(schedule, variant):
    """Slot tables whose slots share (cluster, query) pairs, as the
    sharded search's dispatch pads do: every slot's row is the pair's
    scores, whichever slot carries it."""
    c, metric = _case(variant, 2, seed=3)
    sc, sq = SCHEDULES[schedule]
    c["slot_cluster"], c["slot_query"] = sc.astype(np.int32), sq.astype(np.int32)
    want = jax_filtered_scan(*_jax_args(c, variant), metric=metric,
                             v_block=128, interpret=True)
    got = tfs.filtered_scan(*_torch_args(c, variant), metric=metric)
    assert got.shape == (70, 256) and got.dtype == torch.float32
    _assert_scores(got, want)
    # slots of one pair hold one row
    for p in range(1, 70):
        same = np.flatnonzero((sc[:p] == sc[p]) & (sq[:p] == sq[p]))
        if same.size:
            assert torch.equal(got[p], got[same[0]])


def test_wrapper_takes_plain_path_for_cpu_tensors_and_checks_arguments():
    c, metric = _case("l2-f32", 2, seed=1)
    args = _torch_args(c, "l2-f32")
    before = tfs.PER_PROBE_LAUNCHES
    got = tfs.filtered_scan(*args, metric=metric)
    assert torch.equal(got, filtered_scan_ref(*args, metric=metric))
    assert tfs.PER_PROBE_LAUNCHES == before  # no kernel launch on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.filtered_scan(*[None if a is None else a.to("meta") for a in args],
                          metric=metric)
    with pytest.raises(ValueError, match="norms"):
        tfs.filtered_scan(*args[:8], None, None, metric="l2")
    c, _ = _case("sq8", 1)
    args = list(_torch_args(c, "sq8"))
    args[8] = torch.ones(args[5].shape[:2])  # norms beside scales
    with pytest.raises(NotImplementedError):
        tfs.filtered_scan(*args, metric="l2")


@pytest.mark.parametrize("pair", ["i8-without-scales", "bf16q-f32v"])
def test_wrapper_refuses_on_the_cpu_the_pairs_the_kernel_refuses(pair):
    """int8 rows without their scales would give unscaled scores on the
    plain route: the CPU refuses what the card refuses."""
    variant = "sq8" if pair == "i8-without-scales" else "dot-f32"
    c, _ = _case(variant, 1)
    args = list(_torch_args(c, variant))
    if pair == "i8-without-scales":
        args[9] = None
    else:
        args[2] = args[2].bfloat16()
    with pytest.raises(TypeError, match="not a pair the kernel takes"):
        tfs.filtered_scan(*args, metric="dot")


# ---- search_fused on whole indexes ----

N, D, M, KC = 3000, 32, 4, 12
INDEXES = {  # name: (metric, jax dtype, torch dtype, quantized)
    "dot-f32": ("dot", jnp.float32, torch.float32, False),
    "dot-bf16": ("dot", jnp.bfloat16, torch.bfloat16, False),
    "l2-f32": ("l2", jnp.float32, torch.float32, False),
    "sq8": ("dot", jnp.float32, torch.float32, True),
}


def _indexes(variant):
    metric, jd, td, quantized = INDEXES[variant]
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    topic = ((np.arange(N) * KC) // N).astype(np.int32)
    core = (centers[topic]
            + 0.4 * rng.standard_normal((N, D))).astype(np.float32)
    attrs = rng.integers(0, 8, (N, M)).astype(np.int16)
    jspec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jd, metric=metric)
    tspec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=td, metric=metric)
    ji, _ = jivf.build_from_assignments(
        jspec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic))
    ti, _ = tivf.build_from_assignments(tspec, centers, core, attrs, topic,
                                        device="cpu")
    if quantized:
        ji, ti = jivf.quantize_index(ji), tivf.quantize_index(ti)
    return ji, ti, core


@pytest.mark.parametrize("variant", list(INDEXES))
def test_search_fused_matches_reference_search_fused(variant):
    ji, ti, core = _indexes(variant)
    q = 12
    rng = np.random.default_rng(1)
    qs = (core[rng.integers(0, N, q)]
          + 0.1 * rng.standard_normal((q, D))).astype(np.float32)
    lo = np.full((q, 1, M), 0, np.int16)
    hi = np.full((q, 1, M), 7, np.int16)
    hi[:, 0, 0] = rng.integers(1, 5, q)  # a filter on the first attribute
    jr = jax_search_fused(
        ji, jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo), hi=jnp.asarray(hi)),
        k=10, n_probes=4, v_block=128, interpret=True)
    fspec = tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))
    tr = search_fused(ti, torch.from_numpy(qs), fspec, k=10, n_probes=4,
                      device="cpu")
    np.testing.assert_array_equal(np.asarray(jr.ids), tr.ids.numpy())
    np.testing.assert_allclose(np.asarray(jr.scores), tr.scores.numpy(),
                               rtol=1e-5, atol=1e-5)
    for name in ("n_scanned", "n_passed"):
        np.testing.assert_array_equal(np.asarray(getattr(jr, name)),
                                      getattr(tr, name).numpy(), err_msg=name)
    if variant != "dot-bf16":  # search_fused casts the queries to bf16 there
        ref = tsearch.search_reference(ti, torch.from_numpy(qs), fspec, k=10,
                                       n_probes=4)
        np.testing.assert_array_equal(ref.ids.numpy(), tr.ids.numpy())
        for name in ("n_scanned", "n_passed"):
            np.testing.assert_array_equal(getattr(ref, name).numpy(),
                                          getattr(tr, name).numpy())
