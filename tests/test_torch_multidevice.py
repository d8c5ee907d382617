"""The multi-shard search over ``torch.distributed`` against the reference's
``make_sharded_search`` on a JAX mesh; the merge tree, gradient compression,
the mesh factory and the shard reader.

The port's side: 4 gloo ranks on the CPU as a (data=2, model=2) mesh, one
spawn group for the whole module (rendezvous through a file in the test's
temporary directory: no TCP port), each rank writing its results there.
The reference's side: ``make_sharded_search`` on a (2, 2) mesh of 4 fake
CPU devices, in a subprocess (this file run as a script with
``--reference``), with its CPU executors (``xla_tiled`` for the tiled
backend, ``xla_map`` for the per-probe one).  The reference builds the
index; the ranks carry it across with ``ivf.index_from_arrays``.

Ids, ``n_scanned`` and ``n_passed`` must be identical, scores agree to
rtol 1e-5.  Both multi-process runs end in their own timeouts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"

N, D, M, KC, Q, K_TOP, T = 4096, 32, 4, 16, 16, 20, 4
QB = 8  # the tiled scan's query tile
WORLD, MESH_SHAPE, AXES = 4, (2, 2), ("data", "model")
TS_RANGE = 8192
TIMEOUT_S = 300  # each of the reference's subprocess and the rank group
PG_TIMEOUT_S = 120  # a collective that waits longer fails its rank
JAX_BACKEND = {"pallas_tiled": "xla_tiled", "pallas": "xla_map"}
LEAVES = ("centroids", "vectors", "attrs", "ids", "counts", "norms", "scales")
SUMMARY_FIELDS = ("amin", "amax", "hist", "edges_lo", "edges_hi")

# name: (metric, backend, prune, p_cap_slack, dropped shard)
RUNS = {f"{metric}-{backend}-prune_{prune}": (metric, backend, prune, 2.0,
                                               None)
        for metric in ("dot", "l2") for backend in ("pallas_tiled", "pallas")
        for prune in ("on", "off")}
for _b in ("pallas_tiled", "pallas"):
    RUNS[f"straggler-{_b}"] = ("dot", _b, "off", 2.0, 3)
    RUNS[f"overflow-{_b}"] = ("dot", _b, "off", 0.25, None)


def make_data(seed=0):
    """The selftest's topic mixture (one cluster per topic, a topic-banded
    time attribute) and Q queries with a window on it ~3 topics wide, so
    the summaries prune most probes."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.3 * rng.standard_normal((N, D)).astype(
        np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    band = TS_RANGE // KC
    attrs = rng.integers(0, 8, (N, M)).astype(np.int16)
    attrs[:, 0] = (topic * band + rng.integers(0, band, N)).astype(np.int16)
    rows = rng.integers(0, N, Q)
    queries = core[rows] + 0.05 * rng.standard_normal((Q, D)).astype(
        np.float32)
    lo = np.full((Q, 1, M), -32768, np.int16)
    hi = np.full((Q, 1, M), 32767, np.int16)
    start = rng.integers(0, TS_RANGE - 3 * band, Q)
    lo[:, 0, 0] = start
    hi[:, 0, 0] = start + 3 * band - 1
    lo[:, 0, 1] = 1  # and attr1 >= 1
    return dict(centers=centers, core=core, attrs=attrs,
                topic=topic.astype(np.int32), queries=queries.astype(
                    np.float32), lo=lo, hi=hi)


def merge_inputs(seed=7, rows=6, k=5):
    """Per-shard candidate lists ``[WORLD, rows, k]`` full of ties (values
    drawn from four levels, pads among them) with distinct ids."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 4, (WORLD, rows, k)).astype(np.float32)
    vals = -np.sort(-vals, -1)
    ids = (np.arange(WORLD)[:, None, None] * 1000
           + np.arange(rows)[None, :, None] * 10
           + np.arange(k)[None, None, :]).astype(np.int32)
    pad = rng.random((WORLD, rows, k)) < 0.15
    vals[pad] = -3.0e38
    ids[pad] = -1
    return vals, ids


def grads_tree(rank):
    """A small nested tree of f32 gradients and residuals for one rank."""
    rng = np.random.default_rng(100 + rank)

    def f(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    # no tuples: the reference takes every tuple in the tree for a leaf
    grads = {"w": f(64, 32), "b": f(32), "layers": [f(16), [f(8, 8)]]}
    err = {"w": f(64, 32, scale=1e-3), "b": f(32, scale=1e-3),
           "layers": [f(16, scale=1e-3), [f(8, 8, scale=1e-3)]]}
    return grads, err


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---- the reference's side (run as a script) ----

def _reference(work: Path):
    import jax
    import jax.numpy as jnp

    from repro import compat
    from repro.core import distributed as jdist
    from repro.core import topk as jtopk
    from repro.core.filters import FilterSpec
    from repro.core.hybrid import HybridSpec
    from repro.core.ivf import build_from_assignments
    from repro.core.search import search_reference
    from repro.launch import mesh as jmesh
    from jax.sharding import PartitionSpec as P

    assert len(jax.devices()) == WORLD, jax.devices()
    data = make_data()
    mesh = jax.make_mesh(MESH_SHAPE, AXES)
    out = {}
    queries = jnp.asarray(data["queries"])
    fspec = FilterSpec(lo=jnp.asarray(data["lo"]), hi=jnp.asarray(data["hi"]))
    indexes = {}
    for metric in ("dot", "l2"):
        spec = HybridSpec(dim=D, n_attrs=M, metric=metric,
                          core_dtype=jnp.float32)
        index, _ = build_from_assignments(
            spec, jnp.asarray(data["centers"]), jnp.asarray(data["core"]),
            jnp.asarray(data["attrs"]), jnp.asarray(data["topic"]))
        indexes[metric] = index
        for f in LEAVES:
            if getattr(index, f) is not None:
                out[f"{metric}/{f}"] = np.asarray(getattr(index, f))
        for f in SUMMARY_FIELDS:
            out[f"{metric}/{f}"] = np.asarray(getattr(index.summaries, f))
        # on the unsharded index: under jax 0.9 it refuses device-put
        # sharded arrays (tests/dist_selftest.py:78)
        ref = search_reference(index, queries, fspec, k=K_TOP, n_probes=T)
        out[f"{metric}/reference/ids"] = np.asarray(ref.ids)
        out[f"{metric}/reference/scores"] = np.asarray(ref.scores)
    searches = {}  # one compiled search a configuration
    for name, (metric, backend, prune, slack, drop) in RUNS.items():
        key = (metric, backend, prune, slack)
        if key not in searches:
            cfg = jdist.ShardedSearchConfig(
                k=K_TOP, n_probes=T, scan_q_block=QB,
                backend=JAX_BACKEND[backend], prune=prune, p_cap_slack=slack)
            fn, shardings, info = jdist.make_sharded_search(
                mesh, metric, q_total=Q, n_clusters=KC, cfg=cfg)
            searches[key] = jax.jit(fn), shardings, info
        fn, shardings, info = searches[key]
        index = indexes[metric]
        placed = dataclasses.replace(index, **{
            f: jax.device_put(getattr(index, f), shardings[f])
            for f in shardings if getattr(index, f) is not None})
        ok = jnp.ones((WORLD,), jnp.bool_)
        if drop is not None:
            ok = ok.at[drop].set(False)
        res = fn(placed, queries, fspec, ok)
        for c in ("ids", "scores", "n_scanned", "n_passed"):
            out[f"{name}/{c}"] = np.asarray(getattr(res, c))
        out[f"{name}/p_cap"] = np.int64(info["p_cap"])
    # the merge tree on tied inputs, every device's output stacked
    vals, ids = merge_inputs()
    k = vals.shape[-1]

    def stacked(fn):
        def local(v, i):
            mv, mi = fn(v[0], i[0])
            return mv[None], mi[None]
        spec = P(AXES)
        return compat.shard_map(local, mesh=mesh, in_specs=(spec, spec),
                                out_specs=(spec, spec), check=False)

    for name, fn in (
            ("model", lambda v, i: jtopk.merge_topk_axis(v, i, k, "model")),
            ("data", lambda v, i: jtopk.merge_topk_axis(v, i, k, "data")),
            ("tree", lambda v, i: jtopk.topk_tree_merge(
                v, i, k, ("model", "data")))):
        mv, mi = stacked(fn)(jnp.asarray(vals), jnp.asarray(ids))
        out[f"merge/{name}/vals"] = np.asarray(mv)
        out[f"merge/{name}/ids"] = np.asarray(mi)
    try:
        jdist.make_sharded_search(mesh, "dot", q_total=Q, n_clusters=KC + 2,
                                  cfg=jdist.ShardedSearchConfig())
    except ValueError as e:
        out["raise/k"] = np.array(str(e))
    try:
        jmesh.make_production_mesh()
    except RuntimeError as e:
        out["raise/mesh"] = np.array(str(e))
    np.savez(work / "reference.npz", **out)


def _meshes():
    """The production meshes' shapes and names in both packages: the
    reference's over 512 fake devices, the port's over a fake process
    group of 256 and 512 ranks."""
    import jax
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh

    out = {}
    for multi in (False, True):
        m = jmesh.make_production_mesh(multi_pod=multi)
        out[f"reference/{multi}"] = dict(
            shape=[m.shape[a] for a in m.axis_names], names=list(m.axis_names),
            dp=list(jmesh.dp_axes(m)), n=jmesh.n_chips(m))
        world = 512 if multi else 256
        dist.init_process_group("fake", store=FakeStore(), rank=world - 1,
                                world_size=world)
        try:
            t = tmesh.make_production_mesh(multi_pod=multi, device_type="cpu")
            out[f"port/{multi}"] = dict(
                shape=list(t.shape), names=list(t.mesh_dim_names),
                dp=list(tmesh.dp_axes(t)), n=tmesh.n_chips(t),
                coordinate=list(t.get_coordinate()))
        finally:
            dist.destroy_process_group()
    assert len(jax.devices()) == 512
    print(json.dumps(out))


# ---- the port's side: one rank of the spawn group ----

def _port_index(ref, metric, device="cpu"):
    from repro_torch.core.hybrid import HybridSpec
    from repro_torch.core.ivf import index_from_arrays

    arrays = {f: ref.get(f"{metric}/{f}") for f in LEAVES + SUMMARY_FIELDS}
    spec = HybridSpec(dim=D, n_attrs=M, metric=metric,
                      core_dtype=torch.float32)
    return index_from_arrays(arrays, spec, device=device)


def _fspec(data, device="cpu"):
    from repro_torch.core.filters import FilterSpec

    return FilterSpec(lo=torch.from_numpy(data["lo"]).to(device),
                      hi=torch.from_numpy(data["hi"]).to(device))


def _rank_main(rank: int, work: str):
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    torch.set_num_threads(1)
    work = Path(work)
    backend = tmesh.init_process_group(
        rank, WORLD, init_method=f"file://{work / 'store'}", device="cpu",
        timeout_s=PG_TIMEOUT_S)
    try:
        out = _rank_cases(rank, work)
        out["backend"] = np.array(backend)
        np.savez(work / f"port_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def _rank_cases(rank: int, work: Path) -> dict:
    import torch.distributed as dist

    from repro_torch.core import distributed as tdist
    from repro_torch.core import topk as ttopk
    from repro_torch.core.serving import SearchServer
    from repro_torch.distributed import compressed_psum_tree
    from repro_torch.launch import mesh as tmesh

    ref = dict(np.load(work / "reference.npz"))
    data = make_data()
    mesh = tmesh.make_mesh(MESH_SHAPE, AXES, device_type="cpu")
    queries = torch.from_numpy(data["queries"])
    fspec = _fspec(data)
    shards = {m: tdist.local_shard(_port_index(ref, m), rank, WORLD)
              for m in ("dot", "l2")}
    out = {"coordinate": np.array(mesh.get_coordinate())}
    for name, (metric, backend, prune, slack, drop) in RUNS.items():
        fn, info = tdist.make_sharded_search(
            metric, q_total=Q, n_clusters=KC, mesh=mesh, device="cpu",
            cfg=tdist.ShardedSearchConfig(
                k=K_TOP, n_probes=T, scan_q_block=QB, backend=backend,
                prune=prune, p_cap_slack=slack))
        ok = torch.ones((WORLD,), dtype=torch.bool)
        if drop is not None:
            ok[drop] = False
        res = fn(shards[metric], queries, fspec, ok)
        for c in ("ids", "scores", "n_scanned", "n_passed"):
            out[f"{name}/{c}"] = getattr(res, c).numpy()
        out[f"{name}/p_cap"] = np.int64(info["p_cap"])
        out[f"{name}/shard_id"] = np.int64(info["shard_id"])
        out[f"{name}/live_slots"] = np.int64(
            int(fn.plan(shards[metric], queries, fspec, ok).slot_valid.sum()))
    out["shardings"] = np.array(json.dumps(info["shardings"]))

    # the server on rank 0 drives the others through lead / follow
    fn, _ = tdist.make_sharded_search(
        "dot", q_total=Q, n_clusters=KC, mesh=mesh, device="cpu",
        cfg=tdist.ShardedSearchConfig(k=K_TOP, n_probes=T, scan_q_block=QB,
                                      backend="pallas_tiled"))
    if rank == 0:
        search_fn = tdist.lead(fn, shards["dot"])
        server = SearchServer(search_fn, batch_size=Q, dim=D, n_attrs=M,
                              n_terms=1, n_shards=WORLD, max_wait_s=0.05,
                              device="cpu")
        server.start()
        try:
            for part in ("full", "degraded"):
                if part == "degraded":
                    for _ in range(4):
                        server.health.report(2, failed=True)
                    out["server/ok_mask"] = server.health.ok_mask()
                futs = [server.submit(data["queries"][i],
                                      (data["lo"][i], data["hi"][i]))
                        for i in range(Q)]
                resp = [f.get(timeout=PG_TIMEOUT_S) for f in futs]
                out[f"server/{part}/ids"] = np.stack([r.ids for r in resp])
                out[f"server/{part}/scores"] = np.stack(
                    [r.scores for r in resp])
                out[f"server/{part}/degraded"] = np.array(
                    [r.degraded for r in resp])
        finally:
            server.stop()
            search_fn.stop()
        out["server/stats"] = np.array(json.dumps(server.stats))
    else:
        out["server/followed"] = np.int64(tdist.follow(fn, shards["dot"]))

    # the merge tree on tied inputs
    vals, ids = merge_inputs()
    v, i = torch.from_numpy(vals[rank]), torch.from_numpy(ids[rank])
    k = vals.shape[-1]
    groups = {a: mesh.get_group(a) for a in AXES}
    for name, got in (
            ("model", ttopk.merge_topk_axis(v, i, k, groups["model"])),
            ("data", ttopk.merge_topk_axis(v, i, k, groups["data"])),
            ("tree", ttopk.topk_tree_merge(v, i, k, (groups["model"],
                                                     groups["data"])))):
        out[f"merge/{name}/vals"] = got[0].numpy()
        out[f"merge/{name}/ids"] = got[1].numpy()

    # gradient compression over the whole group
    grads, err = grads_tree(rank)
    g, e = compressed_psum_tree(_map(torch.from_numpy, grads),
                                _map(torch.from_numpy, err), dist.group.WORLD,
                                WORLD)
    for j, (gl, el) in enumerate(zip(_leaves(g), _leaves(e))):
        out[f"compress/mean/{j}"] = gl.numpy()
        out[f"compress/err/{j}"] = el.numpy()

    # what raises on a real mesh
    try:
        tdist.make_sharded_search("dot", q_total=Q, n_clusters=KC + 2,
                                  mesh=mesh, device="cpu",
                                  cfg=tdist.ShardedSearchConfig())
    except ValueError as exc:
        out["raise/k"] = np.array(str(exc))
    try:
        tmesh.make_production_mesh(device_type="cpu")
    except RuntimeError as exc:
        out["raise/mesh"] = np.array(str(exc))
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


# ---- the tests ----

def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env.update(extra)
    return env


def _script(*argv, devices):
    proc = subprocess.run(
        [sys.executable, str(Path(__file__)), *argv], capture_output=True,
        text=True, timeout=TIMEOUT_S, env=_env(
            XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
            JAX_PLATFORMS="cpu"))
    if proc.returncode:
        raise AssertionError(f"{argv} failed\nSTDOUT:\n{proc.stdout}\n"
                             f"STDERR:\n{proc.stderr}")
    return proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run, then the port's 4-rank group, on the same
    data; returns (reference, [each rank's results])."""
    import torch.multiprocessing as mp

    work = tmp_path_factory.mktemp("multidevice")
    _script("--reference", str(work), devices=WORLD)
    ctx = mp.start_processes(_rank_main, args=(str(work),), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):  # re-raises a rank's exception
            if time.monotonic() > deadline:
                raise AssertionError(f"the rank group ran past {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    ref = dict(np.load(work / "reference.npz"))
    port = [dict(np.load(work / f"port_{r}.npz")) for r in range(WORLD)]
    return ref, port


def _same(got, want, name):
    np.testing.assert_array_equal(got[f"{name}/ids"], want[f"{name}/ids"],
                                  err_msg=name)
    np.testing.assert_allclose(got[f"{name}/scores"], want[f"{name}/scores"],
                               rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_search_matches_reference_sharded_search(runs, name):
    """Every rank ends with the reference's answer: ids, n_scanned (the
    global overflow count) and n_passed exact, scores rtol 1e-5."""
    ref, port = runs
    for rank, got in enumerate(port):
        assert int(got[f"{name}/shard_id"]) == rank
        assert int(got[f"{name}/p_cap"]) == int(ref[f"{name}/p_cap"])
        _same(got, ref, name)
        for c in ("n_scanned", "n_passed"):
            np.testing.assert_array_equal(got[f"{name}/{c}"],
                                          ref[f"{name}/{c}"], err_msg=c)
    assert (port[0][f"{name}/n_scanned"] > 0).all() == ("overflow" in name)
    assert (port[0][f"{name}/n_passed"] == 0).all()


@pytest.mark.parametrize("name", [n for n in RUNS
                                  if n.startswith(("dot-", "l2-"))])
def test_sharded_search_matches_one_shard_search(runs, name):
    """S = 4 equals the port's own S = 1 search on the whole index, and the
    reference's exact search over the same probes."""
    from repro_torch.core import distributed as tdist

    ref, port = runs
    metric, backend, prune, slack, _ = RUNS[name]
    data = make_data()
    fn, info = tdist.make_sharded_search(
        metric, q_total=Q, n_clusters=KC, device="cpu",
        cfg=tdist.ShardedSearchConfig(k=K_TOP, n_probes=T, scan_q_block=QB,
                                      backend=backend, prune=prune,
                                      p_cap_slack=slack))
    assert info["n_shards"] == 1 and info["shardings"]["vectors"] == ()
    one = fn(_port_index(ref, metric), torch.from_numpy(data["queries"]),
             _fspec(data))
    want = {f"{name}/ids": one.ids.numpy(), f"{name}/scores": one.scores.numpy()}
    _same(port[0], want, name)
    np.testing.assert_array_equal(port[0][f"{name}/ids"],
                                  ref[f"{metric}/reference/ids"])
    # pruning takes slots, never answers
    live = sum(int(p[f"{name}/live_slots"]) for p in port)
    assert live < Q * T if prune == "on" else live == Q * T
    assert (port[0][f"{name}/ids"] >= 0).mean() > 0.5


@pytest.mark.parametrize("backend", ["pallas_tiled", "pallas"])
def test_straggler_drop_is_a_sound_partial_merge(runs, backend):
    """Shard 3 dropped (tests/dist_selftest.py's checks): no id from its
    clusters, every id passes the filter, no more live results than the
    full search."""
    ref, port = runs
    name, full = f"straggler-{backend}", f"dot-{backend}-prune_off"
    got = port[0][f"{name}/ids"]
    k_local = KC // WORLD
    dropped = ref["dot/ids"][3 * k_local:4 * k_local]
    assert not np.isin(got[got >= 0], dropped[dropped >= 0]).any()
    data = make_data()
    for q, row in enumerate(got):
        a = data["attrs"][row[row >= 0]]
        assert ((a >= data["lo"][q, 0]) & (a <= data["hi"][q, 0])).all()
    assert (got >= 0).sum() <= (port[0][f"{full}/ids"] >= 0).sum()
    assert not np.array_equal(got, port[0][f"{full}/ids"])


def test_overflow_is_counted(runs):
    ref, port = runs
    for backend in ("pallas_tiled", "pallas"):
        name = f"overflow-{backend}"
        live = sum(int(p[f"{name}/live_slots"]) for p in port)
        # every live probe either took a slot or was counted
        assert live + int(port[0][f"{name}/n_scanned"][0]) == Q * T
        assert int(ref[f"{name}/n_scanned"][0]) > 0


@pytest.mark.parametrize("name", ["model", "data", "tree"])
def test_merge_tree_matches_reference_at_ties(runs, name):
    """merge_topk_axis over each axis and topk_tree_merge over model →
    data, on lists full of ties: values and the id chosen at each tie equal
    the reference's on every rank."""
    ref, port = runs
    for rank, got in enumerate(port):
        np.testing.assert_array_equal(got[f"merge/{name}/vals"],
                                      ref[f"merge/{name}/vals"][rank])
        np.testing.assert_array_equal(got[f"merge/{name}/ids"],
                                      ref[f"merge/{name}/ids"][rank])
    vals, _ = merge_inputs()
    assert (np.diff(vals, axis=-1) == 0).mean() > 0.3  # ties are common


def test_server_drives_the_ranks(runs):
    """A SearchServer on rank 0 over lead(): every response equals the
    sharded search; with shard 2 failed in ShardHealth the requests are
    served degraded, with no id of its clusters; each follower served every
    batch the server did."""
    ref, port = runs
    p0 = port[0]
    np.testing.assert_array_equal(p0["server/full/ids"],
                                  port[1]["dot-pallas_tiled-prune_on/ids"])
    np.testing.assert_allclose(p0["server/full/scores"],
                               port[1]["dot-pallas_tiled-prune_on/scores"],
                               rtol=1e-6)
    assert not p0["server/full/degraded"].any()
    assert p0["server/degraded/degraded"].all()
    np.testing.assert_array_equal(p0["server/ok_mask"],
                                  np.arange(WORLD) != 2)
    k_local = KC // WORLD
    dropped = ref["dot/ids"][2 * k_local:3 * k_local]
    ids = p0["server/degraded/ids"]
    assert not np.isin(ids[ids >= 0], dropped[dropped >= 0]).any()
    stats = json.loads(str(p0["server/stats"]))
    assert stats["batches"] >= 2 and stats["degraded_batches"] >= 1
    assert stats["requests"] == 2 * Q
    followed = [int(p["server/followed"]) for p in port[1:]]
    assert followed == [stats["batches"]] * (WORLD - 1)


def test_compression_over_the_group_matches_reference_mean(runs):
    """compressed_psum_tree over the 4 ranks: the mean of the reference's
    single-replica outputs (rtol 1e-6), each rank's residual exact."""
    from repro.distributed import compression as jcomp

    _, port = runs
    outs = [jcomp.compressed_psum_tree(*grads_tree(r), None, 1)
            for r in range(WORLD)]
    means = [np.mean([np.asarray(_leaves(o[0])[j]) for o in outs], 0)
             for j in range(len(_leaves(outs[0][0])))]
    for rank, got in enumerate(port):
        for j, want in enumerate(means):
            np.testing.assert_allclose(got[f"compress/mean/{j}"], want,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(
                got[f"compress/err/{j}"], np.asarray(_leaves(outs[rank][1])[j]))


def test_compression_one_replica_matches_reference_exactly():
    import jax.numpy as jnp

    from repro.distributed import compression as jcomp
    from repro_torch.distributed import compression as tcomp

    grads, err = grads_tree(0)
    jg, je = jcomp.compressed_psum_tree(grads, err, None, 1)
    tg, te = tcomp.compressed_psum_tree(_map(torch.from_numpy, grads),
                                        _map(torch.from_numpy, err), None, 1)
    for a, b in zip(_leaves(tg) + _leaves(te), _leaves(jg) + _leaves(je)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = grads["w"]
    q, s = tcomp.quantize_int8(torch.from_numpy(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        tcomp.dequantize_int8(q, s).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))
    assert tcomp.compression_ratio(_map(torch.from_numpy, grads)) == \
        jcomp.compression_ratio(grads)
    zeros = tcomp.init_error_feedback(_map(torch.from_numpy, grads))
    for a, b in zip(_leaves(zeros), _leaves(jcomp.init_error_feedback(grads))):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mesh_and_process_group(runs):
    """The ranks started gloo on the CPU, sit row-major on the (2, 2) mesh,
    report the reference's leaf placements, and raise as the reference does
    for a K that does not divide and a mesh larger than the world."""
    ref, port = runs
    for rank, got in enumerate(port):
        assert str(got["backend"]) == "gloo"
        assert list(got["coordinate"]) == [rank // 2, rank % 2]
        k_head = str(ref["raise/k"]).split(";")[0]
        assert str(got["raise/k"]).startswith(k_head + ";")
        assert "(16, 16) needs 256" in str(got["raise/mesh"])
        assert "needs 256 devices, have 4" in str(ref["raise/mesh"])
    sh = json.loads(str(port[0]["shardings"]))
    assert sh["centroids"] == sh["summaries"] == []
    for f in ("vectors", "attrs", "ids", "counts", "norms", "scales"):
        assert sh[f] == list(AXES)


def test_production_mesh_matches_reference():
    from repro_torch.launch import mesh as tmesh

    out = json.loads(_script("--meshes", devices=512).strip().splitlines()[-1])
    for multi in ("False", "True"):
        want, got = out[f"reference/{multi}"], out[f"port/{multi}"]
        assert {k: got[k] for k in want} == want
        # the last rank sits at the mesh's last coordinate, row-major
        assert got["coordinate"] == [s - 1 for s in got["shape"]]
    assert tmesh.choose_backend(4, "cpu") == "gloo"
    assert tmesh.choose_backend(4, "cuda") == (
        "nccl" if torch.cuda.device_count() >= 4 else "gloo")


# ---- the shard reader ----

def _index_bytes_equal(a, b):
    assert a.spec == b.spec
    for f in LEAVES:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert torch.equal(x.contiguous().view(torch.uint8),
                               y.contiguous().view(torch.uint8)), f
    for f in SUMMARY_FIELDS:
        assert torch.equal(getattr(a.summaries, f), getattr(b.summaries, f)), f


@pytest.mark.parametrize("layout", [2, 3])
@pytest.mark.parametrize("store", ["bf16", "sq8-l2"])
def test_load_index_shard_equals_load_index_sliced(tmp_path, layout, store):
    """Each shard read from its record range equals load_index sliced, byte
    for byte: ranges inside one shard file, across both files, and past K
    into target_shards padding."""
    from repro_torch.core import distributed as tdist
    from repro_torch.core import storage
    from repro_torch.core.hybrid import HybridSpec
    from repro_torch.core.ivf import build_from_assignments, quantize_index

    data = make_data()
    metric = "l2" if "l2" in store else "dot"
    spec = HybridSpec(dim=D, n_attrs=M, metric=metric,
                      core_dtype=torch.bfloat16 if store == "bf16"
                      else torch.float32)
    index, _ = build_from_assignments(spec, data["centers"], data["core"],
                                      data["attrs"], data["topic"],
                                      device="cpu")
    if store.startswith("sq8"):
        index = quantize_index(index)
    storage.save_index(index, str(tmp_path), n_shards=2, layout=layout)
    for n_shards, target in ((4, None), (2, None), (3, 3), (6, 6), (3, 6)):
        whole = storage.load_index(str(tmp_path), target_shards=target,
                                   device="cpu")
        for s in range(n_shards):
            got = storage.load_index_shard(str(tmp_path), s, n_shards,
                                           target_shards=target, device="cpu")
            _index_bytes_equal(got, tdist.local_shard(whole, s, n_shards))
    with pytest.raises(ValueError, match="must divide over 3"):
        storage.load_index_shard(str(tmp_path), 0, 3, device="cpu")


def test_load_index_shard_rejects_other_layouts(tmp_path):
    from repro_torch.core import storage
    from repro_torch.core.hybrid import HybridSpec
    from repro_torch.core.ivf import build_from_assignments

    data = make_data()
    index, _ = build_from_assignments(
        HybridSpec(dim=D, n_attrs=M, core_dtype=torch.float32),
        data["centers"], data["core"], data["attrs"], data["topic"],
        device="cpu")
    storage.save_index(index, str(tmp_path), n_shards=2, layout=1)
    with pytest.raises(ValueError, match="layouts 2 and 3"):
        storage.load_index_shard(str(tmp_path), 0, 2, device="cpu")
    with pytest.raises(ValueError, match="out of"):
        storage.save_index(index, str(tmp_path / "v3"), n_shards=2)
        storage.load_index_shard(str(tmp_path / "v3"), 4, 4, device="cpu")


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference(Path(sys.argv[2]))
    elif sys.argv[1] == "--meshes":
        _meshes()
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]}")
