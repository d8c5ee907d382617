"""The port's sharded ring (``ShardedBlockStore`` over ``HashRing``, its
transports, circuit breakers and fallback, and the segmented-fetch
terminated executor) against the JAX package's, on the same checkpoints.

Each checkpoint is written by the JAX package from one numpy seed and
opened by both.  A sharded batch must equal the port's own RAM tier (or
its local-store sync path) bit for bit, and the reference's sharded batch
with ids and the n_scanned / n_passed counters exact and scores within
rtol 1e-5 (l2 scores also within atol 1e-6): through both executors,
under every fault class, with the segmented terminated executor, a device
cache and routed sub-partitions.  ``HashRing.owner_of`` equals the
reference's for every cluster id, before and after ``remove_node``, and
the ring's ``stats()`` keys and counters equal the reference's on the same
call sequences.  These are the reference's ``tests/test_blockstore.py``,
``tests/test_transport_faults.py`` and the sharded cases of
``tests/test_device_cache.py``, ``tests/test_partitions.py`` and
``tests/test_termination.py`` on the port.  Socket tests bind port 0 and
use deadlines of at most 5 s.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the port's termination and partition fixtures, on the ring here
import test_torch_partitions as tpt
import test_torch_termination as tt

from repro.core import blockstore as jbs
from repro.core import disk as jdisk
from repro.core import engine as jeng
from repro.core import faults as jfaults
from repro.core import filters as jf
from repro.core import hybrid as jhy
from repro.core import ivf as jivf
from repro.core import probes as jp
from repro.core import serving as jsrv
from repro.core import storage as js
from repro.core import transport as jtr
from repro_torch.core import blockstore as tbs
from repro_torch.core import disk as tdisk
from repro_torch.core import engine as teng
from repro_torch.core import faults as tfaults
from repro_torch.core import filters as tf
from repro_torch.core import probes as tp
from repro_torch.core import serving as tsrv
from repro_torch.core import storage as ts
from repro_torch.core.health import CLOSED, OPEN

N, D, M, KC = 1536, 32, 6, 12
TS_RANGE = 6000
K, NP, QB = 10, 4, 8
KW = dict(k=K, n_probes=NP, q_block=QB, v_block=128)
Q = 21  # ragged multi-tile at q_block=8: 3 tiles, several store gets


def _topic_data():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((KC, D)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    topic = (np.arange(N) * KC) // N
    core = centers[topic] + 0.05 * rng.standard_normal((N, D)).astype(
        np.float32)
    core /= np.linalg.norm(core, axis=-1, keepdims=True)
    band = TS_RANGE // KC
    attrs = rng.integers(0, 16, (N, M)).astype(np.int16)
    attrs[:, 0] = (topic * band + rng.integers(0, band, N)).astype(np.int16)
    return core, attrs, topic, centers


def _jax_index(metric="dot", quantized=False):
    core, attrs, topic, centers = _topic_data()
    spec = jhy.HybridSpec(dim=D, n_attrs=M, core_dtype=jnp.float32,
                          metric=metric)
    index, _ = jivf.build_from_assignments(
        spec, jnp.asarray(centers), jnp.asarray(core), jnp.asarray(attrs),
        jnp.asarray(topic))
    return jivf.quantize_index(index) if quantized else index


@pytest.fixture(scope="module", params=["dot", "l2"])
def built(request, tmp_path_factory):
    """(metric, port RAM index, checkpoint the JAX package wrote)."""
    ckpt = str(tmp_path_factory.mktemp(f"ring_{request.param}"))
    js.save_index(_jax_index(request.param), ckpt, n_shards=2)
    return request.param, ts.load_index(ckpt, device="cpu"), ckpt


def _batch(q=Q, filt="none", offset=5):
    core = _topic_data()[0]
    qs = (core[offset:offset + q] + 0.01).astype(np.float32)
    lo = np.full((q, 1, M), -32768, np.int16)
    hi = np.full((q, 1, M), 32767, np.int16)
    if filt == "window":
        start = np.random.default_rng(7).integers(
            0, TS_RANGE - TS_RANGE // KC, q)
        lo[:, 0, 0], hi[:, 0, 0] = start, start + TS_RANGE // KC - 1
    return qs, lo, hi


def _jq(qs, lo, hi):
    return jnp.asarray(qs), jf.FilterSpec(lo=jnp.asarray(lo),
                                          hi=jnp.asarray(hi))


def _tq(qs, lo, hi):
    return torch.from_numpy(qs), tf.FilterSpec(lo=torch.from_numpy(lo),
                                               hi=torch.from_numpy(hi))


def _assert_bitwise(want, got, msg=""):
    for f in ("ids", "scores", "n_scanned", "n_passed"):
        np.testing.assert_array_equal(getattr(want, f).numpy(),
                                      getattr(got, f).numpy(),
                                      err_msg=f"{msg} {f}")


def _assert_same(want, got, msg=""):
    """A reference result against a port result."""
    np.testing.assert_array_equal(np.asarray(want.ids), got.ids.numpy(),
                                  err_msg=msg)
    np.testing.assert_allclose(np.asarray(want.scores), got.scores.numpy(),
                               rtol=1e-5, atol=1e-6, err_msg=msg)
    for c in ("n_scanned", "n_passed"):
        np.testing.assert_array_equal(np.asarray(getattr(want, c)),
                                      getattr(got, c).numpy(),
                                      err_msg=f"{msg} {c}")


# The ring's deterministic counters (the per-node entries hold the peers'
# own cache stats, compared separately)
RING_COUNTERS = ("kind", "nodes", "self_node", "l1_hits", "l1_misses",
                 "l1_records", "l1_invalidations", "remote_blocks", "health",
                 "failovers", "redirected_blocks", "fallback_blocks",
                 "stale_answers", "device_hits", "fetches_skipped",
                 "retries", "deadline_misses", "has_fallback")
PEER_COUNTERS = ("kind", "name", "hits", "misses", "evictions",
                 "invalidations", "errors", "blocks_served")


def _assert_same_stats(jstore, tstore, msg=""):
    want, got = jstore.stats(), tstore.stats()
    assert set(got) == set(want), msg
    for key in RING_COUNTERS:
        assert got[key] == want[key], f"{msg} {key}"
    assert set(got["per_node"]) == set(want["per_node"]), msg
    for node, w in want["per_node"].items():
        g = got["per_node"][node]
        assert set(g) == set(w), f"{msg} node {node}"
        for key in PEER_COUNTERS:
            if key in w:
                assert g[key] == w[key], f"{msg} node {node} {key}"


# ---- the ring: ownership ----


def test_hash_ring_matches_reference_before_and_after_removal():
    cids = np.arange(5000)
    for nodes in (range(3), range(4), [7, 2, 9], ["a", "b", "c"]):
        jr, tr = jbs.HashRing(nodes), tbs.HashRing(nodes)
        want, got = jr.owner_of(cids), tr.owner_of(cids)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for node in list(nodes)[:2]:
            np.testing.assert_array_equal(tr.without(node).owner_of(cids),
                                          jr.without(node).owner_of(cids))
    assert tbs._hash_point("3#17") == jbs._hash_point("3#17")
    ids = np.asarray([0, 1, 2**31 - 1, 2**40, -5], np.int64)
    np.testing.assert_array_equal(tbs._mix64(ids), jbs._mix64(ids))


def test_hash_ring_deterministic_and_covering():
    ring = tbs.HashRing(range(3))
    owners = ring.owner_of(np.arange(1000))
    np.testing.assert_array_equal(owners,
                                  tbs.HashRing(range(3)).owner_of(
                                      np.arange(1000)))
    assert set(np.unique(owners)) == {0, 1, 2}
    with pytest.raises(ValueError, match="at least one node"):
        tbs.HashRing([])


def test_hash_ring_removal_moves_only_removed_nodes_keys():
    ring = tbs.HashRing(range(4))
    cids = np.arange(5000)
    before = ring.owner_of(cids)
    after = ring.without(2).owner_of(cids)
    kept = before != 2
    np.testing.assert_array_equal(after[kept], before[kept])
    assert not (after == 2).any()
    assert (before == 2).sum() > 0


def test_split_fetch_by_owner_matches_reference():
    ring = tbs.HashRing(range(3))
    fetch = np.asarray([9, 4, 11, 0, 7, 2, 5], np.int64)
    alive = np.asarray([True, False, True, True, True, False, True])
    for kw in (dict(), dict(alive=alive)):
        want = jp.split_fetch_by_owner(fetch, ring.owner_of, **kw)
        got = tp.split_fetch_by_owner(fetch, ring.owner_of, **kw)
        assert set(got) == set(want)
        for o in want:
            assert got[o].dtype == np.int64
            np.testing.assert_array_equal(got[o], want[o])
    owners = ring.owner_of(fetch)
    parts = tp.split_fetch_by_owner(fetch, ring.owner_of)
    for o, sub in parts.items():
        np.testing.assert_array_equal(sub, fetch[owners == o])  # order kept
    assert sorted(np.concatenate(list(parts.values()))) == sorted(fetch)
    assert tp.split_fetch_by_owner([], ring.owner_of) == {}
    got = tp.split_fetch_by_owner(np.asarray([4, 9, 2, 7, 11]),
                                  lambda c: c % 2,
                                  alive=[True, False, True, True, False])
    np.testing.assert_array_equal(got[0], [4, 2])
    np.testing.assert_array_equal(got[1], [7])
    assert tp.split_fetch_by_owner([4, 9], lambda c: c % 2,
                                   alive=np.zeros(2, bool)) == {}


def test_range_ownership_routes_to_the_scanning_shard():
    n_shards, k_local = 4, 3
    own = tbs.RangeOwnership(n_shards, k_local)
    store = tbs.ShardedBlockStore(
        {i: tbs.LoopbackTransport(None) for i in range(n_shards)},
        ownership=own)
    try:
        cids = np.arange(n_shards * k_local)
        parts = tp.split_fetch_by_owner(cids, store.ownership.owner_of)
        for o, sub in parts.items():
            assert (sub // k_local == o).all()
        with pytest.raises(ValueError, match="HashRing"):
            store.remove_node(0)
        with pytest.raises(ValueError, match="HashRing"):
            store.add_node(9, tbs.LoopbackTransport(None))
    finally:
        store.close()


def test_membership_errors():
    store = tbs.ShardedBlockStore({0: tbs.LoopbackTransport(None)})
    try:
        with pytest.raises(ValueError, match="last node"):
            store.remove_node(0)
        with pytest.raises(KeyError):
            store.add_node(0, tbs.LoopbackTransport(None))
    finally:
        store.close()
    with pytest.raises(ValueError, match="at least one transport"):
        tbs.ShardedBlockStore({})
    with pytest.raises(ValueError, match="transport"):
        tbs.open_sharded("unused", n_nodes=2, transport="carrier-pigeon",
                         device="cpu")


# ---- the ring: counters against the reference ----


def test_ring_stats_match_reference_on_the_same_calls(built):
    """The same get sequence (gens, alive masks, a small L1, a membership
    change, a killed peer with and without its circuit open) through both
    packages' loopback rings: equal keys and counters, equal records."""
    _, _, ckpt = built
    kw = dict(n_nodes=3, l1_records=4, capacity_records=6,
              breaker_kwargs=dict(failure_threshold=1, cooldown_s=60.0))
    jstore = jbs.open_sharded(ckpt, **kw)
    tstore = tbs.open_sharded(ckpt, device="cpu", **kw)
    gens = np.zeros(KC, np.int64)
    rng = np.random.default_rng(0)
    try:
        for step in range(12):
            cids = rng.permutation(KC)[:int(rng.integers(1, 8))]
            call = {}
            if step % 3 == 1:
                call["gens"] = gens[cids]
            if step % 4 == 2:
                call["alive"] = rng.random(len(cids)) < 0.6
            if step == 6:
                jstore.remove_node(2)
                tstore.remove_node(2)
            if step == 8:
                jfaults.inject(jstore, 1, jfaults.kill_peer())
                tfaults.inject(tstore, 1, tfaults.kill_peer())
            want, got = jstore.get(cids, **call), tstore.get(cids, **call)
            assert set(got) == set(want), step
            for c in want:
                np.testing.assert_array_equal(got[c]["ids"].numpy(),
                                              want[c]["ids"])
            _assert_same_stats(jstore, tstore, f"step {step}")
        for st in (jstore, tstore):  # node 1's clusters, its circuit open
            with st._l1_lock:
                st._l1.clear()
            st.get(np.arange(KC))
        _assert_same_stats(jstore, tstore, "redirected")
        s = tstore.stats()
        assert s["failovers"] == 1 and s["redirected_blocks"] > 0
        assert s["fetches_skipped"] > 0 and s["health"][1] == OPEN
        assert tstore.degraded
        tstore.note_device_hits(5)
        jstore.note_device_hits(5)
        _assert_same_stats(jstore, tstore, "device hits")
    finally:
        jstore.close()
        tstore.close()


def test_stale_peer_answers_are_reserved_fresh(built):
    """A peer that lags a republish answers below the published minimum
    generation: with a fallback the answer is re-served fresh and counted
    (``stale_answers``), without one it raises."""
    _, _, ckpt = built

    class Stale:
        def __init__(self, store):
            self.store = store

        def fetch(self, cids, gens=None):
            recs = self.store.get(cids)
            return {c: dict(r, gen=torch.tensor([-1])) for c, r in
                    recs.items()}

        def stats(self):
            return {}

        def close(self):
            pass

    peer = tbs.LocalBlockStore.open(ckpt, device="cpu")
    fb = tbs.LocalBlockStore.open(ckpt, device="cpu")
    store = tbs.ShardedBlockStore({0: Stale(peer)}, fallback=fb)
    bare = tbs.ShardedBlockStore({0: Stale(peer)})
    try:
        cids = np.asarray([0, 3, 5])
        got = store.get(cids, gens=np.zeros(3, np.int64))
        assert all(tbs.record_gen(r) == 0 for r in got.values())
        s = store.stats()
        assert s["stale_answers"] == 3 and s["fallback_blocks"] == 3
        with pytest.raises(ts.GenerationMismatchError, match="stale"):
            bare.get(cids, gens=np.zeros(3, np.int64))
    finally:
        store.close()
        bare.close()
        peer.close()
        fb.close()


def test_l1_invalidated_by_a_newer_generation(built):
    _, _, ckpt = built
    peer = tbs.LocalBlockStore.open(ckpt, device="cpu")
    store = tbs.ShardedBlockStore({0: tbs.LoopbackTransport(peer),
                                   1: tbs.LoopbackTransport(peer)})
    try:
        owners = store.ownership.owner_of(np.arange(KC))
        assert store.self_node is None
        cids = np.arange(KC)
        store.get(cids)
        store.get(cids)
        assert store.l1_hits == KC
        # a caller that demands gen 1 sees every L1 record as superseded;
        # the peers (gen 0 on disk) then answer stale and, without a
        # fallback, raise
        with pytest.raises(ts.GenerationMismatchError):
            store.get(cids[:1], gens=[1])
        assert store.l1_invalidations == 1
        assert set(np.unique(owners)) <= {0, 1}
    finally:
        store.close()
        peer.close()


# ---- store parity through the engine ----


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("prune", ["off", "on"])
def test_stores_match_sync_local_path(built, prune, pipeline):
    """A loopback ring of three peers through the engine: the port's
    local-store sync path bit for bit, the reference's ring within rtol
    1e-5, and the ring's counters equal to the reference's."""
    _, _, ckpt = built
    kw = dict(KW, prune=prune)
    for filt in ("none", "window"):
        b = _batch(filt=filt)
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
            sync = teng.SearchEngine(disk, gather_fn=disk.gather,
                                     pipeline="off", device="cpu",
                                     **kw).search(*_tq(*b))
        tstore = tbs.open_sharded(ckpt, n_nodes=3, device="cpu")
        jstore = jbs.open_sharded(ckpt, n_nodes=3)
        try:
            with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
                got = disk.search(*_tq(*b), pipeline=pipeline,
                                  blockstore=tstore, **kw)
            with jdisk.DiskIVFIndex.open(ckpt) as jd:
                want = jd.search(*_jq(*b), pipeline=pipeline,
                                 blockstore=jstore, backend="xla", **kw)
            tag = f"{filt} prune={prune} pipeline={pipeline}"
            _assert_bitwise(sync, got, tag)
            _assert_same(want, got, tag)
            _assert_same_stats(jstore, tstore, tag)
            assert tstore.stats()["remote_blocks"] > 0
        finally:
            tstore.close()
            jstore.close()


def test_sharded_sq8_matches_ram(tmp_path):
    ji = _jax_index("dot", quantized=True)
    ckpt = str(tmp_path / "sq8")
    js.save_index(ji, ckpt, n_shards=2)
    ram = ts.load_index(ckpt, device="cpu")
    b = _batch()
    want = teng.search_fused_tiled(ram, *_tq(*b), device="cpu", **KW)
    store = tbs.open_sharded(ckpt, n_nodes=3, device="cpu")
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
            got = disk.search(*_tq(*b), pipeline="on", blockstore=store,
                              **KW)
        _assert_bitwise(want, got, "sq8 sharded")
    finally:
        store.close()


def test_resident_store_as_sharded_peers(built):
    """A RAM-tier ring of three ResidentBlockStore peers serves the RAM
    engine's results."""
    _, ram, _ = built
    b = _batch(16, offset=0)
    want = teng.search_fused_tiled(ram, *_tq(*b), device="cpu", **KW)
    peers = {i: tbs.LoopbackTransport(tbs.ResidentBlockStore(ram))
             for i in range(3)}
    store = tbs.ShardedBlockStore(peers)
    try:
        eng = teng.SearchEngine(ram, blockstore=store, pipeline="on",
                                device="cpu", **KW)
        _assert_bitwise(want, eng.search(*_tq(*b)), "resident sharded")
        assert eng.stats.blocks_fetched > 0
        assert store.stats()["remote_blocks"] > 0
    finally:
        store.close()


def test_ring_rebalance_mid_run_identical_results(built):
    """A node leaves the ring between batches: results stay those of the
    RAM tier; only the removed node's clusters change owner."""
    _, ram, ckpt = built
    batches = [_batch(16, offset=i * 16) for i in range(4)]
    refs = [teng.search_fused_tiled(ram, *_tq(*b), device="cpu", **KW)
            for b in batches]
    store = tbs.open_sharded(ckpt, n_nodes=3, l1_records=2, device="cpu")
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
            eng = teng.SearchEngine(disk, blockstore=store, pipeline="on",
                                    device="cpu", **KW)
            before = store.ownership.owner_of(np.arange(KC))
            for b, ref in zip(batches[:2], refs[:2]):
                _assert_bitwise(ref, eng.search(*_tq(*b)), "pre-removal")
            store.remove_node(1)
            after = store.ownership.owner_of(np.arange(KC))
            for b, ref in zip(batches, refs):
                _assert_bitwise(ref, eng.search(*_tq(*b)), "post-removal")
            eng.close()
        kept = before != 1
        np.testing.assert_array_equal(after[kept], before[kept])
        assert 1 not in set(np.unique(after)) and 1 not in store.transports
    finally:
        store.close()


def test_socket_sharded_search_identical(built):
    _, ram, ckpt = built
    b = _batch(16, offset=0)
    want = teng.search_fused_tiled(ram, *_tq(*b), device="cpu", **KW)
    store = tbs.open_sharded(ckpt, n_nodes=2, transport="socket",
                             timeout_s=5.0, device="cpu")
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
            got = disk.search(*_tq(*b), pipeline="on", blockstore=store,
                              **KW)
        _assert_bitwise(want, got, "socket sharded")
        stats = store.stats()
        assert sum(n["blocks_served"] for n in stats["per_node"].values()) > 0
        assert stats["per_node"][0]["kind"] == "socket"
    finally:
        store.close()


def test_port_ring_over_reference_servers(built):
    """A mixed fleet: the port's ring whose peers are the reference's
    ``BlockStoreServer``s over the reference's stores serves the port's
    RAM results."""
    _, ram, ckpt = built
    b = _batch()
    want = teng.search_fused_tiled(ram, *_tq(*b), device="cpu", **KW)
    jstores = [jbs.LocalBlockStore.open(ckpt) for _ in range(3)]
    servers = [jtr.BlockStoreServer(s) for s in jstores]
    store = tbs.ShardedBlockStore(
        {i: tbs.SocketTransport(s.host, s.port, timeout=5.0)
         for i, s in enumerate(servers)}, owned_servers=servers)
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
            for pipeline in ("off", "on"):
                got = disk.search(*_tq(*b), pipeline=pipeline,
                                  blockstore=store, **KW)
                _assert_bitwise(want, got, f"mixed fleet {pipeline}")
    finally:
        store.close()
        for s in jstores:
            s.close()


def test_sharded_socket_self_node_disabled(built):
    """Behind a socket every peer costs a round trip, so no node skips the
    L1; loopback keeps the co-located fast path."""
    *_, ckpt = built
    sock = tbs.open_sharded(ckpt, n_nodes=2, transport="socket",
                            timeout_s=5.0, device="cpu")
    loop = tbs.open_sharded(ckpt, n_nodes=2, transport="loopback",
                            device="cpu")
    try:
        assert sock.self_node is None
        assert loop.self_node == 0
        assert set(sock.get([0, 1, 2, 3])) == {0, 1, 2, 3}
        sock.get([0, 1, 2, 3])
        assert sock.l1_hits == 4
        loop.get(np.arange(KC))
        loop.get(np.arange(KC))
        own0 = int((loop.ownership.owner_of(np.arange(KC)) == 0).sum())
        s = loop.stats()
        assert s["l1_hits"] == KC - own0  # self-owned clusters bypass it
        assert s["remote_blocks"] == KC - own0
    finally:
        sock.close()
        loop.close()


def test_probe_thread_runs_and_stops(built):
    *_, ckpt = built
    store = tbs.open_sharded(ckpt, n_nodes=2, probe_interval_s=0.01,
                             device="cpu")
    try:
        assert store._prober is not None and store._prober.is_alive()
    finally:
        store.close()
    assert not store._prober.is_alive()


# ---- faults: the matrix, fail-fast, degraded batches, recovery ----

ERROR_KINDS = ("refuse", "disconnect", "truncate")
BREAKER = dict(failure_threshold=1, cooldown_s=60.0)


def _fault_rules(mod, kind):
    if kind in ERROR_KINDS:  # the first op passes, then the peer dies
        return (mod.FaultRule(kind, after=1),), BREAKER
    if kind == "latency":  # a bounded spike: absorbed, never tripped
        return (mod.FaultRule("latency", latency_s=0.02, count=2),), BREAKER
    # brownout: answers slowly forever, the EWMA tripwire
    return ((mod.FaultRule("latency", latency_s=0.06),),
            dict(BREAKER, brownout_latency_s=0.02, latency_alpha=1.0))


def _run_faulted(pkg, ckpt, kind, prune, pipeline):
    """Two batches through a 3-node ring with peer 1 faulted, the L1
    dropped between them (batch 1 warms the peer, batch 2 hits the armed
    fault).  Returns (last result, ring stats)."""
    bs, faults, disk_cls = ((jbs, jfaults, jdisk.DiskIVFIndex) if pkg == "j"
                            else (tbs, tfaults, tdisk.DiskIVFIndex))
    rules, breaker = _fault_rules(faults, kind)
    extra = {} if pkg == "j" else dict(device="cpu")
    store = bs.open_sharded(ckpt, n_nodes=3, breaker_kwargs=breaker, **extra)
    faults.inject(store, 1, rules)
    b = _batch()
    q = _jq(*b) if pkg == "j" else _tq(*b)
    kw = dict(KW, prune=prune, pipeline=pipeline, blockstore=store)
    if pkg == "j":
        kw["backend"] = "xla"
    try:
        with disk_cls.open(ckpt, **extra) as disk:
            for _ in range(2):
                got = disk.search(*q, **kw)
                with store._l1_lock:
                    store._l1.clear()
        return got, store.stats()
    finally:
        store.close()


@pytest.mark.parametrize("pipeline", ["off", "on"])
@pytest.mark.parametrize("prune", ["off", "on"])
@pytest.mark.parametrize("kind", list(ERROR_KINDS) + ["latency",
                                                       "brownout"])
def test_fault_matrix_bit_identical(built, kind, prune, pipeline):
    """Whatever fault fires, every batch completes with the healthy sync
    path's results; error faults count failovers exactly as the
    reference's ring does on the same schedule."""
    _, _, ckpt = built
    b = _batch()
    with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
        ref = disk.search(*_tq(*b), prune=prune, **KW)
    got, s = _run_faulted("t", ckpt, kind, prune, pipeline)
    tag = f"{kind} prune={prune} pipeline={pipeline}"
    _assert_bitwise(ref, got, tag)
    if kind in ERROR_KINDS:
        assert s["failovers"] >= 1 and s["fallback_blocks"] > 0
        assert s["health"][1] == OPEN
        _, want = _run_faulted("j", ckpt, kind, prune, pipeline)
        for key in ("failovers", "redirected_blocks", "fallback_blocks",
                    "remote_blocks", "l1_hits", "l1_misses", "health"):
            assert s[key] == want[key], f"{tag} {key}"
    elif kind == "latency":
        assert s["failovers"] == 0 and s["health"][1] == CLOSED
    else:
        assert s["health"][1] == OPEN and s["fallback_blocks"] > 0


def test_no_fallback_preserves_fail_fast(built):
    """Without an availability floor the typed transport error surfaces."""
    _, _, ckpt = built
    store = tbs.open_sharded(ckpt, n_nodes=3, fallback=None, device="cpu")
    tfaults.inject(store, 1, tfaults.kill_peer())
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
            with pytest.raises(tbs.TransportError):
                disk.search(*_tq(*_batch()), pipeline="off",
                            blockstore=store, **KW)
    finally:
        store.close()


def test_engine_counts_degraded_batches(built):
    _, _, ckpt = built
    b = _batch()
    with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
        ref = disk.search(*_tq(*b), prune="off", **KW)
    out = {}
    for pkg, bs, faults, disk_cls, eng_cls, extra in (
            ("t", tbs, tfaults, tdisk.DiskIVFIndex, teng.SearchEngine,
             dict(device="cpu")),
            ("j", jbs, jfaults, jdisk.DiskIVFIndex, jeng.SearchEngine, {})):
        store = bs.open_sharded(ckpt, n_nodes=3, breaker_kwargs=BREAKER,
                                **extra)
        faults.inject(store, 1, faults.kill_peer())
        try:
            with disk_cls.open(ckpt, **extra) as disk:
                eng = eng_cls(disk, blockstore=store, pipeline="on",
                              prune="off",
                              **(dict(KW, **extra) if pkg == "t"
                                 else dict(KW, backend="xla")))
                q = _tq(*b) if pkg == "t" else _jq(*b)
                got = eng.search(*q)
                eng.search(*q)
                out[pkg] = eng.metrics()
                if pkg == "t":
                    _assert_bitwise(ref, got, "degraded engine batch")
                eng.close()
        finally:
            store.close()
    assert out["t"]["engine.degraded_batches"] == 2
    for key in ("engine.degraded_batches", "engine.blocks_fetched",
                "store.failovers", "store.redirected_blocks",
                "store.fallback_blocks"):
        assert out["t"][key] == out["j"][key], key
    assert set(out["t"]) == set(out["j"])


def test_recovery_closes_circuit_and_resumes_remote(built):
    """A peer dead for 2 ops, then answering again: the active probe
    closes the circuit and remote fetches resume without a restart."""
    _, _, ckpt = built
    store = tbs.open_sharded(
        ckpt, n_nodes=3, device="cpu",
        breaker_kwargs=dict(failure_threshold=1, cooldown_s=0.05,
                            half_open_successes=1))
    tfaults.inject(store, 1, (tfaults.FaultRule("refuse", after=0,
                                                count=2),))
    b = _batch()
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
            ref = disk.search(*_tq(*b), prune="off", **KW)
            got = disk.search(*_tq(*b), prune="off", blockstore=store, **KW)
            _assert_bitwise(ref, got, "during outage")
            assert store.health.state(1) == OPEN and store.degraded
            deadline = time.monotonic() + 5
            while (store.health.state(1) != CLOSED
                   and time.monotonic() < deadline):
                store.probe_peers()
                time.sleep(0.06)
            assert store.health.state(1) == CLOSED
            assert not store.degraded
            with store._l1_lock:
                store._l1.clear()
            before = store.stats()["per_node"][1]["blocks_served"]
            store.get(np.arange(KC))
            assert store.stats()["per_node"][1]["blocks_served"] > before
            got = disk.search(*_tq(*b), prune="off", blockstore=store, **KW)
            _assert_bitwise(ref, got, "after recovery")
    finally:
        store.close()


def test_socket_peer_killed_mid_stream(built):
    """The real wire: one of three servers is closed mid-run; batches
    complete with the same results and the stats report the failover."""
    _, _, ckpt = built
    store = tbs.open_sharded(ckpt, n_nodes=3, transport="socket",
                             timeout_s=5.0, retries=1, device="cpu",
                             breaker_kwargs=BREAKER)
    b = _batch()
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
            ref = disk.search(*_tq(*b), prune="off", **KW)
            got = disk.search(*_tq(*b), prune="off", pipeline="on",
                              blockstore=store, **KW)
            _assert_bitwise(ref, got, "healthy ring")
            store._owned_servers[1].close()  # the kill
            store._owned_servers[1].close()  # idempotent
            with store._l1_lock:
                store._l1.clear()
            got = disk.search(*_tq(*b), prune="off", pipeline="on",
                              blockstore=store, **KW)
            _assert_bitwise(ref, got, "one peer dead")
        s = store.stats()
        assert s["failovers"] >= 1 or s["redirected_blocks"] > 0
        assert s["fallback_blocks"] > 0 and s["health"][1] == OPEN
    finally:
        store.close()


# ---- the device cache over the ring ----


def test_device_cache_sharded_counts_avoided_fetches(built):
    _, ram, ckpt = built
    b = _batch()
    want = teng.search_fused_tiled(ram, *_tq(*b), device="cpu", **KW)
    tstore = tbs.open_sharded(ckpt, n_nodes=3, device="cpu")
    jstore = jbs.open_sharded(ckpt, n_nodes=3)
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk, \
                jdisk.DiskIVFIndex.open(ckpt) as jd:
            eng = teng.SearchEngine(disk, blockstore=tstore, pipeline="on",
                                    device_cache=64 * 2**20, device="cpu",
                                    **KW)
            je = jeng.SearchEngine(jd, blockstore=jstore, pipeline="on",
                                   device_cache=64 * 2**20, backend="xla",
                                   **KW)
            _assert_bitwise(want, eng.search(*_tq(*b)), "cold")
            je.search(*_jq(*b))
            cold = eng.stats.blocks_fetched
            _assert_bitwise(want, eng.search(*_tq(*b)), "warm")
            je.search(*_jq(*b))
            assert eng.stats.blocks_fetched == cold
            assert tstore.stats()["device_hits"] > 0
            _assert_same_stats(jstore, tstore, "device-cached ring")
            # termination over a device-cached ring keeps the whole-batch
            # fetch (the segmented mode needs the ring without a cache)
            term = teng.SearchEngine(disk, blockstore=tstore,
                                     pipeline="off", termination="exact",
                                     device_cache=64 * 2**20, device="cpu",
                                     **KW)
            got = term.search(*_tq(*b))
            for f in ("ids", "scores"):
                assert torch.equal(getattr(want, f), getattr(got, f)), f
            assert (got.n_scanned <= want.n_scanned).all()
            assert term.stats.probes_terminated > 0
            assert tstore.stats()["fetches_skipped"] == 0
            eng.close()
            term.close()
    finally:
        tstore.close()
        jstore.close()


# ---- the serving function over the ring ----


@pytest.mark.parametrize("transport", ["loopback", "socket"])
def test_serving_fn_sharded_cache(built, transport):
    _, ram, ckpt = built
    b = _batch(8, offset=0)
    ram_fn = tsrv.make_fused_search_fn(ram, k=5, n_probes=4, q_block=8,
                                       device="cpu")
    fn = tsrv.make_fused_search_fn(ckpt, k=5, n_probes=4, q_block=8,
                                   cache_shards=3, cache_transport=transport,
                                   peer_timeout_s=5.0, device="cpu")
    jfn = jsrv.make_fused_search_fn(ckpt, k=5, n_probes=4, q_block=8,
                                    cache_shards=3,
                                    cache_transport=transport)
    try:
        rs, ri = ram_fn(*_tq(*b), None)
        s, i = fn(*_tq(*b), None)
        js_, ji_ = jfn(*_jq(*b), None)
        assert torch.equal(ri, i) and torch.equal(rs, s)
        np.testing.assert_array_equal(np.asarray(ji_), i.numpy())
        np.testing.assert_allclose(np.asarray(js_), s.numpy(), rtol=1e-5,
                                   atol=1e-6)
        stats = fn.blockstore.stats()
        assert stats["kind"] == "sharded" and len(stats["per_node"]) == 3
        assert stats["has_fallback"]
        assert not fn.degraded()
        # per-node capacity: the index's own cache split three ways
        cap = fn.index.cache.capacity_records // 3
        for node in fn.blockstore._owned_stores:
            assert node.cache.capacity_records == cap
        assert fn.blockstore.fallback is fn.index.blockstore
        _assert_same_stats(jfn.blockstore, fn.blockstore, transport)
    finally:
        fn.close()
        jfn.close()
        ram_fn.close()
    assert fn.blockstore._fan._shutdown


def test_serving_fn_ring_knobs_reach_the_store(built):
    *_, ckpt = built
    fn = tsrv.make_fused_search_fn(
        ckpt, k=5, n_probes=4, q_block=8, cache_shards=2,
        cache_transport="socket", cache_l1_records=3, cache_fallback=False,
        peer_timeout_s=2.5, peer_retries=3,
        breaker_kwargs=dict(failure_threshold=5), probe_interval_s=60.0,
        device="cpu")
    try:
        st = fn.blockstore
        assert st.l1_records == 3 and st.fallback is None
        assert st.probe_interval_s == 60.0 and st._prober.is_alive()
        for t in st.transports.values():
            assert t.timeout == 2.5 and t.retries == 3
        assert st.health.breaker(0).failure_threshold == 5
        fn(*_tq(*_batch(8)), None)
    finally:
        fn.close()
    assert not st._prober.is_alive()


def test_serving_fn_cache_shards_needs_disk(built):
    _, ram, _ = built
    with pytest.raises(ValueError, match="cache_shards"):
        tsrv.make_fused_search_fn(ram, k=5, n_probes=4, cache_shards=2,
                                  device="cpu")


# ---- the segmented-fetch terminated executor ----


@pytest.fixture(scope="module", params=["dot", "l2"])
def twin_ckpt(request, tmp_path_factory):
    """The reference's termination fixture (twin-pair topics) as a
    checkpoint the JAX package wrote."""
    ji, ti = tt._cached_indexes(request.param)
    ckpt = str(tmp_path_factory.mktemp(f"twin_{request.param}"))
    js.save_index(ji, ckpt, n_shards=2)
    return request.param, ti, ckpt


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_segmented_terminated_matches_untruncated_ring(twin_ckpt, pipeline):
    """``termination="exact"`` over a ring: the untruncated ring batch bit
    for bit (the segmented fetch on the sync executor, whole-tile fetches
    on the pipelined one), and the reference's terminated ring batch with
    the same drops, skipped fetches and ring counters."""
    metric, ti, ckpt = twin_ckpt
    qs, lo, hi = tt._stream(21)
    kw = dict(k=tt.K, n_probes=tt.NP, q_block=tt.QB, prune="on",
              pipeline=pipeline)
    tstore = tbs.open_sharded(ckpt, n_nodes=3, device="cpu")
    jstore = jbs.open_sharded(ckpt, n_nodes=3)
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk, \
                jdisk.DiskIVFIndex.open(ckpt) as jd:
            base = teng.SearchEngine(disk, device="cpu", **kw)
            term = teng.SearchEngine(disk, blockstore=tstore,
                                     termination="exact", device="cpu", **kw)
            je = jeng.SearchEngine(jd, blockstore=jstore, backend="xla",
                                   termination="exact", **kw)
            r0 = base.search(*tt._tq(qs, lo, hi))
            r1 = term.search(*tt._tq(qs, lo, hi))
            want = je.search(*tt._jq(qs, lo, hi))
            tt._assert_bitwise(r0, r1, f"{metric} ring exact")
            _assert_same(want, r1, f"{metric} vs reference")
            assert term.stats.probes_terminated > 0
            assert term.stats.probes_terminated == je.stats.probes_terminated
            assert (term.stats.term_segments_skipped
                    == je.stats.term_segments_skipped)
            assert term.stats.blocks_fetched == je.stats.blocks_fetched
            assert term.metrics()["engine.scan_compilations"] == \
                je.metrics()["engine.scan_compilations"]
            _assert_same_stats(jstore, tstore, f"{metric} term ring")
            base.close()
            term.close()
    finally:
        tstore.close()
        jstore.close()


def test_segmented_terminated_skips_dead_fetches(twin_ckpt):
    """One tile of 8 queries at 6 probes: clusters first needed by a later
    segment whose every pair is dead by then are never fetched; they are
    scanned as 1-row dead records, and the batch still equals the
    untruncated ring batch bit for bit and the reference's terminated ring
    batch (ids, n_scanned of the fetched rows only, skipped fetches)."""
    metric, _, ckpt = twin_ckpt
    qs, lo, hi = tt._stream(8, seed=1)
    kw = dict(k=tt.K, n_probes=6, q_block=8, prune="on", pipeline="off")
    tstore = tbs.open_sharded(ckpt, n_nodes=3, device="cpu")
    jstore = jbs.open_sharded(ckpt, n_nodes=3)
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk, \
                jdisk.DiskIVFIndex.open(ckpt) as jd:
            base = teng.SearchEngine(disk, blockstore=tstore, device="cpu",
                                     **kw)
            r0 = base.search(*tt._tq(qs, lo, hi))
            term = teng.SearchEngine(disk, blockstore=tstore,
                                     termination="exact", device="cpu", **kw)
            skipped0 = tstore.stats()["fetches_skipped"]
            r1 = term.search(*tt._tq(qs, lo, hi))
            je = jeng.SearchEngine(jd, blockstore=jstore, backend="xla",
                                   termination="exact", **kw)
            want = je.search(*tt._jq(qs, lo, hi))
            tt._assert_bitwise(r0, r1, f"{metric} skipped fetches")
            _assert_same(want, r1, f"{metric} vs reference")
            assert tstore.stats()["fetches_skipped"] - skipped0 > 0
            assert (tstore.stats()["fetches_skipped"] - skipped0
                    == jstore.stats()["fetches_skipped"])
            assert term.stats.blocks_fetched == je.stats.blocks_fetched
            base.close()
            term.close()
    finally:
        tstore.close()
        jstore.close()


def test_fetch_segment_stands_in_dead_records(twin_ckpt):
    """A segment whose clusters are all dead but one: the dead ones are
    not fetched (``fetches_skipped``), they enter the blocks as 1-row
    all-dead records beside the live cluster's full height, and are not
    cached for a later tile."""
    _, _, ckpt = twin_ckpt
    store = tbs.open_sharded(ckpt, n_nodes=3, device="cpu")
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk:
            eng = teng.SearchEngine(disk, blockstore=store,
                                    termination="exact", device="cpu",
                                    k=tt.K, n_probes=tt.NP, q_block=tt.QB)
            plan = eng.plan(*tt._tq(*tt._stream(8)))
            seg_sc = np.asarray([3, 5, 5, 9], np.int64)
            alive = np.zeros((tt.QB, 4), bool)
            alive[2, 0] = True  # only cluster 3 has a live pair
            ops = {}
            rows, vec, attrs, ids, norms, scales = eng._fetch_segment(
                plan, seg_sc, alive, ops)
            assert list(ops) == [3]
            assert store.stats()["fetches_skipped"] == 2
            np.testing.assert_array_equal(rows.numpy(), [0, 1, 1, 2])
            assert vec.shape[0] == 3 and vec.shape[1] == disk.vpad
            assert (ids[1:] == -1).all() and (ids[0] >= 0).any()
            assert (vec[1:] == 0).all()
            # the same clusters alive later are fetched for real
            eng._fetch_segment(plan, seg_sc, np.ones((tt.QB, 4), bool), ops)
            assert sorted(ops) == [3, 5, 9]
            assert store.stats()["fetches_skipped"] == 2
            eng.close()
    finally:
        store.close()


def test_sharded_store_skips_dead_fetches(built):
    _, ram, _ = built
    out = {}
    for pkg, bs, idx in (("t", tbs, ram), ("j", jbs, None)):
        if idx is None:
            idx = _jax_index(built[0])
        peers = {i: bs.LoopbackTransport(bs.ResidentBlockStore(idx))
                 for i in range(3)}
        store = bs.ShardedBlockStore(peers)
        try:
            recs = store.get([0, 1, 2, 3], alive=[True, False, True, False])
            assert sorted(recs) == [0, 2]
            assert store.stats()["fetches_skipped"] == 2
            recs = store.get([1, 3], alive=[True, True])
            assert sorted(recs) == [1, 3]
            out[pkg] = store.stats()
        finally:
            store.close()
    for key in RING_COUNTERS:
        assert out["t"][key] == out["j"][key], key


def test_exact_identity_sharded_serving_fn(twin_ckpt):
    """The reference's test_exact_identity_sharded: two serving functions
    over a 2-node ring, untruncated and ``termination="exact"``."""
    metric, _, ckpt = twin_ckpt
    qs, lo, hi = tt._stream(21)
    kw = dict(k=tt.K, n_probes=tt.NP, q_block=tt.QB, cache_shards=2)
    base_fn = tsrv.make_fused_search_fn(ckpt, device="cpu", **kw)
    term_fn = tsrv.make_fused_search_fn(ckpt, termination="exact",
                                        device="cpu", **kw)
    jterm = jsrv.make_fused_search_fn(ckpt, termination="exact", **kw)
    try:
        s0, i0 = base_fn(*tt._tq(qs, lo, hi), True)
        s1, i1 = term_fn(*tt._tq(qs, lo, hi), True)
        js1, ji1 = jterm(*tt._jq(qs, lo, hi), True)
        assert torch.equal(i0, i1) and torch.equal(s0, s1)
        np.testing.assert_array_equal(np.asarray(ji1), i1.numpy())
        np.testing.assert_allclose(np.asarray(js1), s1.numpy(), rtol=1e-5,
                                   atol=1e-6)
        assert term_fn.engine.stats.probes_terminated > 0
        assert (term_fn.engine.stats.probes_terminated
                == jterm.engine.stats.probes_terminated)
        _assert_same_stats(jterm.blockstore, term_fn.blockstore, metric)
    finally:
        base_fn.close()
        term_fn.close()
        jterm.close()


# ---- routed sub-partitions over the ring ----


@pytest.fixture(scope="module", params=["dot-f32", "l2-f32", "dot-sq8"])
def part_built(request, tmp_path_factory):
    metric, quantized = tpt.VARIANTS[request.param]
    ji = tpt._jax_index(metric, quantized)
    jb = tpt.jpart.build_partitions(ji, attrs=[0])
    ti = tpt._carry(ji, metric)
    tb = tpt.tpart.build_partitions(ti, attrs=[0])
    ckpt = str(tmp_path_factory.mktemp(f"ring_part_{request.param}"))
    js.save_index(ji, ckpt, n_shards=2, layout=4, partitions=jb)
    return request.param, ji, ti, tb, ckpt


@pytest.mark.parametrize("pipeline", ["off", "on"])
def test_routed_matches_flat_sharded_resident(part_built, pipeline):
    """The reference's sharded-resident store case: three ResidentBlockStore
    peers over the attached index.  Routed equals the port's flat search
    bit for bit, and the reference's flat search within rtol 1e-5."""
    variant, ji, ti, tb, _ = part_built
    qs, lo, hi = tpt._queries(21)
    kw = dict(k=tpt.K, n_probes=tpt.NP, q_block=tpt.QB, prune="on",
              pipeline=pipeline)
    want = jeng.SearchEngine(ji, backend="xla", **kw).search(
        *tpt._jq(qs, lo, hi))
    attached = tpt.tpart.attach(ti, tb)
    store = tbs.ShardedBlockStore(
        {i: tbs.LoopbackTransport(tbs.ResidentBlockStore(attached))
         for i in range(3)})
    try:
        flat = teng.SearchEngine(attached, blockstore=store, device="cpu",
                                 partitions="off", **kw)
        routed = teng.SearchEngine(attached, blockstore=store, device="cpu",
                                   partitions="auto", **kw)
        r0 = flat.search(*tpt._tq(qs, lo, hi))
        r1 = routed.search(*tpt._tq(qs, lo, hi))
        tpt._assert_same(r0, r1, f"{variant} routed vs flat", exact=True)
        tpt._assert_same(want, r1, f"{variant} routed vs the reference")
        assert routed.stats.partition_hits == 21
        assert flat.stats.partition_hits == 0
        assert r1.n_scanned.sum() < r0.n_scanned.sum()
    finally:
        store.close()


def test_routed_matches_flat_sharded_terminated(part_built):
    """The segmented terminated executor fetches sub-partitions through the
    ring: the port's flat untruncated search bit for bit, the reference's
    routed terminated ring batch within rtol 1e-5 with equal counters."""
    variant, _, _, _, ckpt = part_built
    qs, lo, hi = tpt._queries(16)
    kw = dict(k=tpt.K, n_probes=tpt.NP, q_block=tpt.QB, prune="on")
    tstore = tbs.open_sharded(ckpt, n_nodes=3, device="cpu")
    jstore = jbs.open_sharded(ckpt, n_nodes=3)
    try:
        with tdisk.DiskIVFIndex.open(ckpt, device="cpu") as disk, \
                jdisk.DiskIVFIndex.open(ckpt) as jd:
            flat = teng.SearchEngine(disk, device="cpu", partitions="off",
                                     **kw).search(*tpt._tq(qs, lo, hi))
            routed = teng.SearchEngine(disk, blockstore=tstore,
                                       termination="exact",
                                       partitions="auto", device="cpu",
                                       **kw)
            r1 = routed.search(*tpt._tq(qs, lo, hi))
            je = jeng.SearchEngine(jd, blockstore=jstore, backend="xla",
                                   termination="exact", partitions="auto",
                                   **kw)
            want = je.search(*tpt._jq(qs, lo, hi))
            tpt._assert_same(flat, r1, f"{variant} vs flat", exact=True)
            tpt._assert_same(want, r1, f"{variant} vs reference")
            np.testing.assert_array_equal(np.asarray(want.n_scanned),
                                          r1.n_scanned.numpy())
            assert routed.stats.partition_hits == je.stats.partition_hits > 0
            _assert_same_stats(jstore, tstore, variant)
            routed.close()
    finally:
        tstore.close()
        jstore.close()
