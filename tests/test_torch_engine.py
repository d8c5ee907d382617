"""The port's SearchEngine (sync RAM tier) against the reference engine and
the reference/brute-force paths, on the same numpy inputs.

Ids and the n_scanned / n_passed / n_pruned counters must be identical;
scores agree to rtol 1e-5 (f32 sums taken in another order).  The data is
a topic mixture with a topic-correlated timestamp attribute, so window
filters make the planner prune.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro_torch.core import engine as teng
from repro_torch.core import filters as tf
from repro_torch.core import hybrid as thy
from repro_torch.core import ivf as tivf
from repro_torch.core import search as tsearch

N, D, M, KC, TS = 4000, 32, 3, 16, 1600
VARIANTS = {  # name: (metric, jax dtype, torch dtype, quantized)
    "dot-f32": ("dot", jnp.float32, torch.float32, False),
    "dot-bf16": ("dot", jnp.bfloat16, torch.bfloat16, False),
    "l2-f32": ("l2", jnp.float32, torch.float32, False),
    "sq8": ("dot", jnp.float32, torch.float32, True),
}
SRC = Path(__file__).resolve().parents[1] / "src"


def _data(seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.3 * rng.standard_normal((N, D)).astype(np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    attrs[:, 0] = topic * (TS // KC) + rng.integers(0, TS // KC, N)
    return centers, core, attrs, topic.astype(np.int32)


def _indexes(variant):
    metric, jd, td, quantized = VARIANTS[variant]
    centers, core, attrs, topic = _data()
    jspec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jd, metric=metric)
    tspec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=td, metric=metric)
    ji, _ = jivf.build_from_assignments(
        jspec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic))
    ti, _ = tivf.build_from_assignments(tspec, centers, core, attrs, topic,
                                        device="cpu")
    if quantized:
        ji, ti = jivf.quantize_index(ji), tivf.quantize_index(ti)
    return ji, ti, core, attrs


def _queries(q, filt, seed=1):
    rng = np.random.default_rng(seed)
    centers, *_ = _data()
    qs = centers[rng.integers(0, KC, q)] + 0.3 * rng.standard_normal((q, D))
    qs = qs.astype(np.float32)
    lo = np.full((q, 2, M), -32768, np.int16)
    hi = np.full((q, 2, M), 32767, np.int16)
    lo[:, 1], hi[:, 1] = 32767, -32768  # void spare term
    if filt == "window":  # ~5% of the time range per query
        start = rng.integers(0, TS - 80, q)
        lo[:, 0, 0], hi[:, 0, 0] = start, start + 79
    return qs, lo, hi


def _assert_same(jr, tr, counters=("n_scanned", "n_passed", "n_pruned")):
    np.testing.assert_array_equal(np.asarray(jr.ids), tr.ids.numpy())
    np.testing.assert_allclose(np.asarray(jr.scores), tr.scores.numpy(),
                               rtol=1e-5)
    for c in counters:
        np.testing.assert_array_equal(np.asarray(getattr(jr, c)),
                                      getattr(tr, c).numpy(), err_msg=c)


@pytest.mark.parametrize("filt", ["match_all", "window"])
@pytest.mark.parametrize("prune", ["off", "auto"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_matches_reference_engine(variant, prune, filt):
    ji, ti, _, _ = _indexes(variant)
    qs, lo, hi = _queries(37, filt)  # ragged: 37 queries in tiles of 16
    kw = dict(k=10, n_probes=4, q_block=16, prune=prune)
    jr = jeng.SearchEngine(ji, backend="xla", **kw).search(
        jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo), hi=jnp.asarray(hi)))
    eng = teng.SearchEngine(ti, device="cpu", **kw)
    tr = eng.search(torch.from_numpy(qs),
                    tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi)))
    _assert_same(jr, tr)
    if prune == "auto" and filt == "window":
        assert tr.n_pruned.sum() > 0
    if variant != "dot-bf16":  # the engine casts queries to bf16 there
        ref = tsearch.search_reference(
            ti, torch.from_numpy(qs),
            tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi)),
            k=10, n_probes=4)
        np.testing.assert_array_equal(ref.ids.numpy(), tr.ids.numpy())
        if prune == "off":  # pruned probes are not scanned
            np.testing.assert_array_equal(ref.n_scanned.numpy(),
                                          tr.n_scanned.numpy())
        np.testing.assert_array_equal(ref.n_passed.numpy(), tr.n_passed.numpy())


@pytest.mark.parametrize("provision", [
    dict(adaptive_u_cap=True), dict(adaptive_u_cap=False),
    dict(u_cap=8), dict(adaptive_u_cap=True, u_cap_ladder="fine"),
])
def test_engine_provisioning_matches_reference_engine(provision):
    ji, ti, _, _ = _indexes("dot-f32")
    qs, lo, hi = _queries(40, "window", seed=3)
    kw = dict(k=10, n_probes=6, q_block=16, **provision)
    jeng_ = jeng.SearchEngine(ji, backend="xla", **kw)
    teng_ = teng.SearchEngine(ti, device="cpu", **kw)
    jr = jeng_.search(jnp.asarray(qs),
                      jf.FilterSpec(lo=jnp.asarray(lo), hi=jnp.asarray(hi)))
    tr = teng_.search(torch.from_numpy(qs),
                      tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi)))
    _assert_same(jr, tr)
    assert teng_.stats.last_u_cap == jeng_.stats.last_u_cap
    if provision.get("adaptive_u_cap"):
        assert teng_.stats.last_u_cap < min(16 * 6, KC)  # the table shrank


def test_carried_index_and_functional_entry_point():
    ji, ti, core, attrs = _indexes("l2-f32")
    arrays = {f: np.asarray(getattr(ji, f)) for f in (
        "centroids", "vectors", "attrs", "ids", "counts", "norms")}
    arrays.update({f: np.asarray(getattr(ji.summaries, f)) for f in (
        "amin", "amax", "hist", "edges_lo", "edges_hi")})
    carried = tivf.index_from_arrays(arrays, ti.spec, device="cpu")
    qs, lo, hi = _queries(20, "window", seed=4)
    jr = jeng.search_fused_tiled(
        ji, jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo), hi=jnp.asarray(hi)),
        k=5, n_probes=3, q_block=8, backend="xla")
    tr = teng.search_fused_tiled(
        carried, torch.from_numpy(qs),
        tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi)),
        k=5, n_probes=3, q_block=8, device="cpu")
    _assert_same(jr, tr)


def test_recall_against_brute_force():
    _, ti, core, attrs = _indexes("dot-f32")
    qs, lo, hi = _queries(32, "match_all", seed=5)
    fspec = tf.FilterSpec(lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))
    res = teng.SearchEngine(ti, k=10, n_probes=KC, q_block=16,
                            device="cpu").search(torch.from_numpy(qs), fspec)
    oracle = tsearch.brute_force(torch.from_numpy(core), torch.from_numpy(attrs),
                                 torch.from_numpy(qs), fspec, k=10)
    assert tsearch.recall_at_k(res, oracle) == 1.0  # every cluster probed


def test_port_runs_without_jax_or_repro():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from repro_torch.core import (HybridSpec, SearchEngine,
                                      ShardedSearchConfig,
                                      build_from_assignments, match_all,
                                      make_sharded_search)
        from repro_torch.core.distributed import dispatch_probes_tiled
        from repro_torch.kernels.centroid_topk import probe_centroids
        from repro_torch.kernels.centroid_topk.centroid_topk import (
            centroid_topk)
        from repro_torch.kernels.filtered_scan import search_fused
        from repro_torch.kernels.filtered_scan.filtered_scan import (
            filtered_scan)
        rng = np.random.default_rng(0)
        core = rng.standard_normal((500, 16)).astype(np.float32)
        assign = rng.integers(0, 4, 500)
        spec = HybridSpec(dim=16, n_attrs=2, core_dtype=torch.float32,
                          metric="l2")
        index, _ = build_from_assignments(
            spec, core[:4], core, rng.integers(0, 9, (500, 2)), assign,
            device="cpu")
        res = SearchEngine(index, k=5, n_probes=4, device="cpu").search(
            torch.from_numpy(core[:10]), match_all(10, 2, device="cpu"))
        assert (res.ids[:, 0].numpy() == np.arange(10)).all()
        q, fs = torch.from_numpy(core[:10]), match_all(10, 2, device="cpu")
        res = search_fused(index, q, fs, k=5, n_probes=4, device="cpu")
        assert (res.ids[:, 0].numpy() == np.arange(10)).all()
        for backend in ("pallas", "pallas_tiled"):
            fn, _ = make_sharded_search(
                "l2", q_total=10, n_clusters=4, device="cpu",
                cfg=ShardedSearchConfig(k=5, n_probes=4, backend=backend))
            assert (fn(index, q, fs).ids[:, 0].numpy() == np.arange(10)).all()
        # the disk tier on bf16 vectors: save, open, search both executors
        import tempfile
        from repro_torch.core import DiskIVFIndex
        from repro_torch.core.storage import load_index, save_index
        spec = HybridSpec(dim=16, n_attrs=2, core_dtype=torch.bfloat16,
                          metric="l2")
        index, _ = build_from_assignments(
            spec, core[:4], core, rng.integers(0, 9, (500, 2)), assign,
            device="cpu")
        qb = torch.from_numpy(core[:10]).bfloat16().float()
        with tempfile.TemporaryDirectory() as d:
            save_index(index, d, n_shards=2)
            assert torch.equal(load_index(d, device="cpu").vectors.view(
                torch.int16), index.vectors.view(torch.int16))
            with DiskIVFIndex.open(d, device="cpu") as disk:
                for pipeline in ("off", "on"):
                    res = disk.search(qb, match_all(10, 2, device="cpu"),
                                      k=5, n_probes=4, q_block=8,
                                      pipeline=pipeline)
                    assert (res.ids[:, 0].numpy() == np.arange(10)).all()
        # the launcher: synthetic data, build_ivf, the server
        import contextlib, io
        from repro_torch.launch import serve
        with contextlib.redirect_stdout(io.StringIO()):
            out = serve.main(["--device", "cpu", "--n", "800", "--dim", "8",
                              "--clusters", "4", "--probes", "3",
                              "--requests", "16", "--batch", "8"])
        assert len(out["responses"]) == 16
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.") or m == "repro"
               or m.startswith("repro.") or m == "ml_dtypes"
               or m.startswith("ml_dtypes.")]
        assert not bad, bad
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


@pytest.mark.parametrize("knob,value", [("backend", "xla")])
def test_engine_raises_on_unported_knob(knob, value):
    """``backend`` has no counterpart (the tensors' device picks the
    kernel); the default is accepted and an unknown keyword is refused."""
    _, ti, _, _ = _indexes("dot-f32")
    with pytest.raises(NotImplementedError, match="backend"):
        teng.SearchEngine(ti, k=5, n_probes=2, device="cpu", **{knob: value})
    teng.SearchEngine(ti, k=5, n_probes=2, device="cpu", backend=None)
    with pytest.raises(TypeError):
        teng.SearchEngine(ti, k=5, n_probes=2, device="cpu", no_such_knob=1)


@pytest.mark.parametrize("knob,value", [
    ("epsilon", 0.1), ("termination", "bounded"), ("device_cache", object()),
    ("partitions", "off"), ("device_cache", 64), ("termination", "exact"),
    ("device_cache", True), ("partitions", "on"),
])
def test_engine_takes_the_a6_knobs(knob, value):
    """The device cache, partition and termination knobs on a RAM index:
    the port's engine gives the JAX engine's result on a window-filtered
    batch, or raises the same exception type (a device cache needs a
    store, ``partitions="on"`` a catalog, ε a bounded termination)."""
    ji, ti, _, _ = _indexes("dot-f32")
    qs, lo, hi = _queries(40, "window", seed=5)
    kw = dict(k=10, n_probes=3, q_block=16, **{knob: value})

    def run(make, search):
        try:
            return make().search(*search), None
        except Exception as e:  # the same type on both sides
            return None, type(e)

    want, want_err = run(
        lambda: jeng.SearchEngine(ji, backend="xla", **kw),
        (jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo),
                                        hi=jnp.asarray(hi))))
    got, got_err = run(
        lambda: teng.SearchEngine(ti, device="cpu", **kw),
        (torch.from_numpy(qs), tf.FilterSpec(lo=torch.from_numpy(lo),
                                             hi=torch.from_numpy(hi))))
    assert got_err is want_err
    if want is not None:
        _assert_same(want, got)


@pytest.mark.parametrize("knob,value", [
    ("t_max", "auto"), ("t_max", 8), ("delta", "tier"),
])
def test_engine_takes_the_ported_update_knobs(knob, value):
    """The knobs live updates and widening brought: the port's engine with
    each equals the JAX engine with it on a window-filtered batch (a delta
    tier holding the same adds and deletes on both sides)."""
    from repro.core import delta as jdelta
    from repro_torch.core import delta as tdelta

    ji, ti, core, attrs = _indexes("dot-f32")
    qs, lo, hi = _queries(40, "window", seed=5)
    jkw, tkw = {knob: value}, {knob: value}
    if knob == "delta":
        rng = np.random.default_rng(5)
        new = core[:30] + 0.01 * rng.standard_normal((30, D)).astype(np.float32)
        new_ids = np.arange(N, N + 30)
        jkw["delta"], tkw["delta"] = (jdelta.DeltaTier(ji, 64),
                                      tdelta.DeltaTier(ti, 64))
        for tier in (jkw["delta"], tkw["delta"]):
            tier.add(new, attrs[:30], new_ids)
            tier.tombstone(np.arange(0, N, 7))
    kw = dict(k=10, n_probes=3, q_block=16)
    want = jeng.SearchEngine(ji, backend="xla", **kw, **jkw).search(
        jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo), hi=jnp.asarray(hi)))
    got = teng.SearchEngine(ti, device="cpu", **kw, **tkw).search(
        torch.from_numpy(qs), tf.FilterSpec(lo=torch.from_numpy(lo),
                                            hi=torch.from_numpy(hi)))
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy())
    np.testing.assert_allclose(np.asarray(want.scores), got.scores.numpy(),
                               rtol=1e-5)
    for c in ("n_scanned", "n_passed", "n_pruned"):
        np.testing.assert_array_equal(np.asarray(getattr(want, c)),
                                      getattr(got, c).numpy(), err_msg=c)


@pytest.mark.parametrize("knobs", [
    dict(pipeline="on", pipeline_depth=3), dict(pipeline="auto"),
    dict(operand_cache="off"), dict(gather_fn=print),
])
def test_engine_takes_the_ported_fetch_knobs(knobs):
    """The fetch-stage knobs the disk tier brought are accepted; "auto"
    pipelines only when there is something to fetch."""
    _, ti, _, _ = _indexes("dot-f32")
    eng = teng.SearchEngine(ti, k=5, n_probes=2, device="cpu", **knobs)
    want = knobs.get("pipeline", "on" if "gather_fn" in knobs else "off")
    assert eng.pipeline == ("off" if want == "auto" else want)
    with pytest.raises(ValueError, match="operand_cache"):
        teng.SearchEngine(ti, k=5, n_probes=2, device="cpu",
                          operand_cache="on")  # no store to cache from


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    centers, core, attrs, topic = _data()
    spec = thy.HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tivf.build_from_assignments(spec, centers, core, attrs, topic)
    with pytest.raises(RuntimeError, match="CUDA"):
        tivf.index_from_arrays({}, spec)
    with pytest.raises(RuntimeError, match="CUDA"):
        tf.match_all(4, M)
    _, ti, _, _ = _indexes("dot-f32")
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.SearchEngine(ti, k=5, n_probes=2)


# Public names of repro.core the port does not have yet, by ROADMAP item.
UNPORTED_CORE = set()


def test_core_exports_match_reference():
    """``repro_torch.core`` exports every public name of ``repro.core``
    except the unported ones; a name that gets ported leaves the list."""
    import repro.core
    import repro_torch.core

    got = {n for n in dir(repro_torch.core) if not n.startswith("_")}
    missing = set(repro.core.__all__) - UNPORTED_CORE - got
    assert not missing, sorted(missing)
    assert not UNPORTED_CORE & got, sorted(UNPORTED_CORE & got)
    assert set(repro_torch.core.__all__) <= got


def test_filtered_scan_kernel_exports_match_reference():
    """The package exports the reference's names, ``search_fused_tiled``
    included; ``filtered_scan`` names the module there (it holds the
    launch counters), by design."""
    import repro.kernels.filtered_scan as jk
    import repro_torch.kernels.filtered_scan as tk

    assert set(jk.__all__) - {"filtered_scan"} == set(tk.__all__)
    for name in tk.__all__:
        assert callable(getattr(tk, name)), name
    assert tk.search_fused_tiled is teng.search_fused_tiled
