"""Pluggable cluster-block fetch layer: the port of ``repro.core.blockstore``.

    BlockStore protocol
        get(cluster_ids)  -> {cid: record}      synchronous fetch
        submit(ids)/wait(h)                     async pair the pipelined
                                                executor drives
        stats()                                 observability

    ResidentBlockStore   RAM tier: per-cluster copies of the resident
                         ``[K, Vpad, ...]`` arrays.
    LocalBlockStore      the disk tier: ShardReader + ClusterCache.
    ShardedBlockStore    a consistent-hash ring (:class:`HashRing`) over N
                         peer stores keyed on cluster id: each pod holds one
                         index copy, the ring decides whose cache owns each
                         cluster, fetch lists are split per owner and
                         fetched concurrently, and remote blocks land in a
                         small local L1.  Peers sit behind a transport
                         (:mod:`~repro_torch.core.transport`: in-process
                         loopback, or the deadline-bounded socket wire),
                         per-peer circuit breakers
                         (:mod:`~repro_torch.core.health`) route around a
                         dead or slow peer, and a ``fallback`` store (the
                         pod's own full copy) serves its clusters meanwhile.

A record is a dict of CPU tensors (``vectors``, ``attrs``, ``ids``,
``norms``?, ``scales``?, ``gen``); no store or fetch thread touches the
card.  :func:`assemble_blocks` packs records into the scan's batch-local
blocks; with ``as_device`` on a CUDA device it assembles them in pinned
host memory and copies them on a side stream, and :func:`wait_blocks`
hands them to the consumer's stream.

Every store returns the same per-cluster records, so any store composed
with the engine yields the results of the RAM tier: ring membership
changes, peer failures and failover change only where blocks come from.
``RangeOwnership`` is the sharded dispatch's ownership map.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.partitions import SUB_ALIGN
from repro_torch.device import resolve_device

Record = Dict[str, torch.Tensor]


def record_gen(rec: Record) -> int:
    """Generation stamped on a cluster record (0 for pre-v3 records)."""
    g = rec.get("gen")
    return int(g[0]) if g is not None else 0


# ---------------------------------------------------------------------------
# Block geometry + assembly (shared by every store and the engine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """Static geometry of one cluster record: everything an assembler needs
    to pack records into the scan's batch-local blocks."""

    vpad: int
    dim: int
    n_attrs: int
    has_norms: bool
    quantized: bool
    store_dtype: torch.dtype

    @classmethod
    def from_index(cls, index) -> "BlockSpec":
        """The spec of any index with the resident surface (IVFFlatIndex or
        DiskIVFIndex)."""
        has_norms = (index.man["has_norms"] if hasattr(index, "man")
                     else getattr(index, "norms", None) is not None)
        return cls(vpad=int(index.vpad), dim=int(index.spec.dim),
                   n_attrs=int(index.spec.n_attrs), has_norms=bool(has_norms),
                   quantized=bool(index.quantized),
                   store_dtype=index.store_dtype)

    @classmethod
    def from_manifest(cls, man: dict) -> "BlockSpec":
        from repro_torch.core import storage

        spec = storage.spec_from_manifest(man)
        return cls(vpad=int(man["vpad"]), dim=int(spec.dim),
                   n_attrs=int(spec.n_attrs), has_norms=bool(man["has_norms"]),
                   quantized=bool(man["quantized"]),
                   store_dtype=storage.torch_dtype(man["store_dtype"]))


def first_need_unique(flat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Unique cluster ids in *first-occurrence* order + inverse map: fetches
    load clusters in the order the scan first touches them."""
    uniq_sorted, first, inv_sorted = np.unique(
        flat, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")  # sorted-pos -> need order
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return uniq_sorted[order], rank[inv_sorted.reshape(-1)]


class DeviceBlocks(tuple):
    """Blocks copied to a CUDA device on a side stream; ``ready`` is the
    event recorded after the copies.  Pass them through :func:`wait_blocks`
    before use."""

    ready: torch.cuda.Event


def assemble_blocks(flat: np.ndarray, uniq: np.ndarray, local: np.ndarray,
                    recs: Dict[int, Record], spec: BlockSpec,
                    as_device: bool = False, device=None) -> Tuple:
    """Packs per-cluster records into batch-local blocks.

    ``flat`` is the slot list, ``uniq``/``local`` the first-need unique ids
    and slot -> row map from :func:`first_need_unique`, ``recs`` the records
    a store returned.  Returns ``(local [S] int32, vectors [U, Vpad, D],
    attrs [U, Vpad, M], ids [U, Vpad], norms, scales)``: one row per
    distinct cluster (U = ``len(uniq)``; the reference allocates S rows, of
    which only these U are ever addressed, so results are the same).  The
    row height is the tallest record's; a shorter record's tail keeps the
    dead-row fill (ids -1, scales 1) the kernel masks.

    ``as_device`` moves the blocks to ``device``: on a CUDA device they are
    assembled in pinned host memory and copied on a side stream, and come
    back as :class:`DeviceBlocks` for :func:`wait_blocks`.
    """
    dev = torch.device("cpu") if device is None else resolve_device(device)
    pin = as_device and dev.type == "cuda"
    n = len(uniq)
    d, m = spec.dim, spec.n_attrs
    vpad = spec.vpad
    if n:
        vpad = max(int(recs[int(c)]["ids"].shape[0]) for c in uniq)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=pin)

    local_t = empty((flat.shape[0],), torch.int32)
    local_t.copy_(torch.from_numpy(np.ascontiguousarray(local, np.int32)))
    vectors = empty((n, vpad, d), spec.store_dtype)
    attrs = empty((n, vpad, m), torch.int16)
    ids = empty((n, vpad), torch.int32)
    norms = empty((n, vpad), torch.float32) if spec.has_norms else None
    scales = empty((n, vpad), torch.float32) if spec.quantized else None
    for i, cid in enumerate(uniq):
        rec = recs[int(cid)]
        rows = int(rec["ids"].shape[0])
        vectors[i, :rows].copy_(rec["vectors"])
        attrs[i, :rows].copy_(rec["attrs"])
        ids[i, :rows].copy_(rec["ids"])
        if norms is not None:
            norms[i, :rows].copy_(rec["norms"])
        if scales is not None:
            scales[i, :rows].copy_(rec["scales"])
        if rows < vpad:  # dead-row fill of a short record's tail
            vectors[i, rows:] = 0
            attrs[i, rows:] = 0
            ids[i, rows:] = -1
            if norms is not None:
                norms[i, rows:] = 0
            if scales is not None:
                scales[i, rows:] = 1
    out = (local_t, vectors, attrs, ids, norms, scales)
    if not pin:
        return out
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        blocks = DeviceBlocks(None if a is None else a.to(dev, non_blocking=True)
                              for a in out)
    blocks.ready = torch.cuda.Event()
    blocks.ready.record(side)
    return blocks


def wait_blocks(blocks) -> Tuple:
    """Hands blocks to the current stream: it waits for the side stream's
    copies, and the tensors are marked as used on it, so the caching
    allocator does not recycle them while its work is queued.  Blocks that
    were not copied on a side stream pass through."""
    if not isinstance(blocks, DeviceBlocks):
        return tuple(blocks)
    dev = next(a.device for a in blocks if a is not None)
    stream = torch.cuda.current_stream(dev)
    stream.wait_event(blocks.ready)
    for a in blocks:
        if a is not None:
            a.record_stream(stream)
    return tuple(blocks)


def dead_record(spec: BlockSpec) -> Record:
    """A minimal all-dead cluster record (every id -1, neutral fills)."""
    rec: Record = {
        "vectors": torch.zeros((1, spec.dim), dtype=spec.store_dtype),
        "attrs": torch.zeros((1, spec.n_attrs), dtype=torch.int16),
        "ids": torch.full((1,), -1, dtype=torch.int32),
        "gen": torch.zeros((1,), dtype=torch.int64),
    }
    if spec.has_norms:
        rec["norms"] = torch.zeros((1,), dtype=torch.float32)
    if spec.quantized:
        rec["scales"] = torch.ones((1,), dtype=torch.float32)
    return rec


# ---------------------------------------------------------------------------
# Ownership: who serves a cluster
# ---------------------------------------------------------------------------


def _hash_point(key: str) -> int:
    """Stable 64-bit ring point for a (node, replica) label."""
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


def _mix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: cluster id -> ring position (the
    uint64 products wrap on purpose)."""
    with np.errstate(over="ignore"):
        z = np.asarray(x).astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


class HashRing:
    """Consistent-hash ring over node ids, keyed on cluster id.

    Each node contributes ``replicas`` virtual points; a cluster is owned by
    the first point clockwise from its hash.  Removing a node reassigns only
    that node's clusters, so a rebalance moves data, never results.
    """

    def __init__(self, nodes: Sequence, replicas: int = 64):
        nodes = tuple(nodes)
        if not nodes:
            raise ValueError("HashRing needs at least one node")
        self.nodes = nodes
        self.replicas = replicas
        pts = []
        for n in nodes:
            for r in range(replicas):
                pts.append((_hash_point(f"{n}#{r}"), n))
        pts.sort(key=lambda p: p[0])
        self._hashes = np.asarray([p[0] for p in pts], np.uint64)
        self._owners = np.asarray([nodes.index(p[1]) for p in pts], np.int64)

    def owner_of(self, cluster_ids) -> np.ndarray:
        """Vectorized owner lookup: [n] cluster ids -> [n] node ids (an
        object array where a node id is not an integer)."""
        h = _mix64(np.asarray(cluster_ids, np.int64))
        idx = np.searchsorted(self._hashes, h, side="right")
        idx = idx % len(self._hashes)
        if any(not isinstance(n, (int, np.integer)) for n in self.nodes):
            return np.asarray(self.nodes, object)[self._owners[idx]]
        return np.asarray(self.nodes, np.int64)[self._owners[idx]]

    def without(self, node) -> "HashRing":
        """A new ring with ``node`` removed (its clusters reassigned)."""
        rest = tuple(n for n in self.nodes if n != node)
        return HashRing(rest, replicas=self.replicas)


@dataclasses.dataclass(frozen=True)
class RangeOwnership:
    """Contiguous range sharding: node ``s`` owns ``[s·k_local, (s+1)·k_local)``.

    The ownership map of the sharded dispatch
    (:func:`repro_torch.core.distributed.dispatch_probes`).  ``owner_of`` /
    ``local_of`` are plain integer arithmetic, so they take ints and integer
    tensors alike.
    """

    n_nodes: int
    k_local: int

    @property
    def nodes(self) -> Tuple[int, ...]:
        return tuple(range(self.n_nodes))

    def owner_of(self, cluster_ids):
        return cluster_ids // self.k_local

    def local_of(self, cluster_ids):
        return cluster_ids % self.k_local


# ---------------------------------------------------------------------------
# Stores
# ---------------------------------------------------------------------------


# Guards first-time pool creation for every store instance, so two racing
# first submits cannot build two pools (which would break the
# submission-order guarantee).
_POOL_INIT_LOCK = threading.Lock()


class _AsyncStoreMixin:
    """submit/wait over a single-worker pool: handles resolve strictly in
    submission order, which keeps the pipelined executor's per-tile waits
    aligned with its per-tile submits."""

    _pool: Optional[ThreadPoolExecutor] = None
    _pool_closed: bool = False

    def _ensure_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            with _POOL_INIT_LOCK:
                if self._pool_closed:
                    raise RuntimeError(
                        f"submit on a closed {type(self).__name__}")
                if self._pool is None:
                    self._pool = ThreadPoolExecutor(
                        max_workers=1,
                        thread_name_prefix=f"{type(self).__name__}-fetch")
        return self._pool

    def submit(self, cluster_ids, gens=None) -> Future:
        """Starts fetching ``cluster_ids`` off-thread; returns a handle.
        Raises ``RuntimeError`` after :meth:`close`."""
        if gens is None:
            return self._ensure_pool().submit(self.get, cluster_ids)
        return self._ensure_pool().submit(self.get, cluster_ids, gens=gens)

    def wait(self, handle: Future) -> Dict[int, Record]:
        """Blocks until a :meth:`submit` handle's records are ready."""
        return handle.result()

    def _shutdown_pool(self):
        with _POOL_INIT_LOCK:
            self._pool_closed = True
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)


class ResidentBlockStore(_AsyncStoreMixin):
    """RAM tier: per-cluster host copies of the resident ``[K, Vpad, ...]``
    arrays, so the same engine code can treat the RAM tier as one more
    store.  The engine's resident path bypasses it."""

    def __init__(self, index):
        self.index = index
        self.spec = BlockSpec.from_index(index)
        self._gets = 0
        self._blocks = 0

    def get(self, cluster_ids, gens=None) -> Dict[int, Record]:
        # gens is accepted for protocol uniformity: the resident arrays are
        # the current generation, so records are stamped gen 0
        cids = np.asarray(cluster_ids, np.int64).reshape(-1)
        self._gets += 1
        self._blocks += len(cids)
        out: Dict[int, Record] = {}
        index = self.index
        # attached sub-partitions sit in the resident arrays at the parent's
        # Vpad; their records are cut to the sub's own aligned height, so
        # the assembler's batch height (and the scan) shrinks with them
        cat = getattr(index, "partitions", None)
        for cid in cids:
            cid = int(cid)
            rows = index.vpad
            if cat is not None and cid >= cat.n_base:
                n = max(int(cat.sub_counts[cid - cat.n_base]), 1)
                rows = min(-(-n // SUB_ALIGN) * SUB_ALIGN, rows)
            rec: Record = {
                "vectors": index.vectors[cid, :rows].cpu(),
                "attrs": index.attrs[cid, :rows].cpu(),
                "ids": index.ids[cid, :rows].cpu(),
                "gen": torch.zeros((1,), dtype=torch.int64),
            }
            if self.spec.has_norms:
                rec["norms"] = index.norms[cid, :rows].float().cpu()
            if self.spec.quantized:
                rec["scales"] = index.scales[cid, :rows].float().cpu()
            out[cid] = rec
        return out

    def refresh(self):
        """No-op: the resident arrays are always the current generation."""

    def stats(self) -> dict:
        return dict(kind="resident", gets=self._gets, blocks=self._blocks)

    def close(self):
        self._shutdown_pool()


class LocalBlockStore(_AsyncStoreMixin):
    """One host's disk tier: ShardReader + ClusterCache behind the protocol.

    ``get`` pages records through the cache (misses load inline,
    deduplicated against in-flight prefetches); the gather methods assemble
    whole slot lists, ``gather_submit`` on the store's worker, with the
    copy to ``device`` on a side stream.
    """

    def __init__(self, reader, cache, spec: BlockSpec, name: str = "local",
                 device="cuda"):
        self.reader = reader
        self.cache = cache
        self.spec = spec
        self.name = name
        self.device = resolve_device(device)

    @classmethod
    def open(cls, directory: str, *, capacity_records: Optional[int] = None,
             pin_fraction: float = 0.5, pin_refresh: int = 64,
             name: str = "local", device="cuda") -> "LocalBlockStore":
        """Opens one view of a layout-2/3/4 checkpoint (on layout 4 the
        cache's id range covers the sub-partitions too)."""
        from repro_torch.core import storage
        from repro_torch.core.disk import ClusterCache, ShardReader

        man = storage.load_manifest(directory)
        storage.check_complete(directory, man)
        reader = ShardReader(directory, man)
        n_total = man["n_clusters"]
        if man.get("has_partitions"):
            n_total += int(man["partitions"]["n_subs"])
        cap = (n_total if capacity_records is None
               else min(int(capacity_records), n_total))
        cache = ClusterCache(reader, capacity_records=max(cap, 1),
                             n_clusters=n_total, pin_fraction=pin_fraction,
                             pin_refresh=pin_refresh)
        return cls(reader, cache, BlockSpec.from_manifest(man), name=name,
                   device=device)

    def get(self, cluster_ids, gens=None) -> Dict[int, Record]:
        cids = np.asarray(cluster_ids, np.int64).reshape(-1)
        if len(cids) == 0:
            return {}
        g = None if gens is None else np.asarray(gens).reshape(-1)
        return self.cache.get_many(cids, gens=g)

    def refresh(self):
        """Adopts a republished checkpoint: reopens the shard reader.
        Cached records are not flushed: the next gen-stamped fetch
        invalidates exactly the rewritten clusters."""
        self.reader.reopen()

    # ---- whole-list gathers ----
    def gather(self, slot_cluster) -> Tuple:
        """Synchronous whole-list gather: records -> host blocks with
        slot-local ids."""
        flat = np.asarray(slot_cluster).reshape(-1)
        uniq, local = first_need_unique(flat)
        return assemble_blocks(flat, uniq, local, self.get(uniq), self.spec)

    def gather_submit(self, slot_cluster) -> Future:
        """Async gather: pages, assembles and copies to the store's device
        on the store's worker.  The worker's misses load inline, not through
        the cache's prefetch (which would count every miss as a hit)."""
        flat = np.asarray(slot_cluster).reshape(-1)
        uniq, local = first_need_unique(flat)
        return self._ensure_pool().submit(
            lambda: assemble_blocks(flat, uniq, local, self.get(uniq),
                                    self.spec, as_device=True,
                                    device=self.device))

    def gather_wait(self, handle: Future) -> Tuple:
        return wait_blocks(handle.result())

    def stats(self) -> dict:
        s = self.cache.stats
        return dict(
            kind="local", name=self.name, hits=s.hits, misses=s.misses,
            evictions=s.evictions, prefetched=s.prefetched, errors=s.errors,
            invalidations=s.invalidations,
            hit_rate=round(self.cache.hit_rate, 4),
            resident_bytes=self.cache.resident_bytes(),
        )

    def close(self):
        self._shutdown_pool()
        self.cache.stop()
        self.reader.close()


# ---------------------------------------------------------------------------
# Transports live in repro_torch.core.transport; re-exported here, as the
# reference's blockstore re-exports them
# ---------------------------------------------------------------------------

from repro_torch.core.transport import (  # noqa: E402,F401  (re-export)
    BlockStoreServer,
    LoopbackTransport,
    SocketTransport,
    TransportError,
    TransportTimeout,
    _decode_records,
    _encode_records,
    _recv_frame,
    _send_frame,
)


# ---------------------------------------------------------------------------
# The sharded store
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StoreStats:
    """Degradation accounting for a sharded store: how often the fetch path
    routed around an unhealthy peer."""

    failovers: int = 0          # peer sub-fetches that failed mid-request
    #                             and were re-served by the fallback
    redirected_blocks: int = 0  # blocks routed straight to the fallback
    #                             because the owner's circuit was open
    fallback_blocks: int = 0    # blocks the local full copy served
    stale_answers: int = 0      # peer answers below the published minimum
    #                             generation, re-served fresh
    device_hits: int = 0        # blocks the engine's device cache served:
    #                             fetches this store never saw
    fetches_skipped: int = 0    # clusters dropped from the fetch list
    #                             because every (query, probe) pair on them
    #                             was already dead at a segment boundary


class ShardedBlockStore(_AsyncStoreMixin):
    """Consistent-hash sharded cluster fetch over N peer stores.

    ``transports`` maps node id -> transport; ``ownership`` (default: a
    :class:`HashRing` over the node ids) decides which peer serves each
    cluster.  ``get`` splits the request per owner
    (:func:`repro_torch.core.probes.split_fetch_by_owner`, first-need order
    kept) and fetches the owners concurrently on a fan-out pool; fetched
    blocks land in a small L1 LRU (gen-checked against the caller's minimum
    generations), so repeat probes do not re-cross the ring.
    ``self_node`` marks the co-located peer: its blocks skip the L1 and do
    not count as remote.

    Ring membership is mutable (:meth:`remove_node` / :meth:`add_node`);
    only ownership moves.  With a ``fallback`` store (the pod's own full
    copy), peer failures are absorbed: a per-peer circuit breaker
    (``health``) watches every peer fetch, an open peer's clusters go to the
    fallback (``redirected_blocks``; ``adopt_fallback`` lands them in the
    L1), a sub-fetch that fails mid-request is re-served by it
    (``failovers``), and a stale peer answer is re-served fresh
    (``stale_answers``).  When a breaker's cooldown lapses, the next fetch
    for that peer is the half-open probe; :meth:`probe_peers` (or the
    ``probe_interval_s`` thread) pings open peers.  Without a fallback,
    peer errors raise.  Records stay CPU tensors: no thread here makes a
    CUDA call.
    """

    def __init__(self, transports: Dict[int, object], *,
                 ownership=None, l1_records: int = 64,
                 self_node: Optional[int] = None,
                 owned_stores: Sequence = (), owned_servers: Sequence = (),
                 fallback=None, owns_fallback: bool = False,
                 adopt_fallback: bool = True, health=None,
                 breaker_kwargs: Optional[dict] = None,
                 probe_interval_s: Optional[float] = None):
        from repro_torch.core.health import PeerHealth

        if not transports:
            raise ValueError("ShardedBlockStore needs at least one transport")
        self.transports = dict(transports)
        self.ownership = ownership or HashRing(sorted(self.transports))
        self.self_node = self_node
        self.l1_records = l1_records
        self._l1: "collections.OrderedDict[int, Record]" = (
            collections.OrderedDict())
        self._l1_lock = threading.Lock()
        self._fan = ThreadPoolExecutor(
            max_workers=max(len(self.transports), 1),
            thread_name_prefix="shard-fetch")
        self._stats_lock = threading.Lock()
        self.l1_hits = 0
        self.l1_misses = 0
        self.l1_invalidations = 0
        self.remote_blocks = 0
        self.node_blocks: Dict[int, int] = {n: 0 for n in self.transports}
        # teardown ownership (stores and servers built by open_sharded)
        self._owned_stores = list(owned_stores)
        self._owned_servers = list(owned_servers)
        self.fallback = fallback
        self._owns_fallback = owns_fallback
        self.adopt_fallback = adopt_fallback
        self.health = health or PeerHealth(self.transports,
                                           breaker_kwargs=breaker_kwargs)
        self.store_stats = StoreStats()
        self.probe_interval_s = probe_interval_s
        self._probe_stop = threading.Event()
        self._prober: Optional[threading.Thread] = None
        if probe_interval_s:
            self._prober = threading.Thread(
                target=self._probe_loop, daemon=True,
                name="shard-health-probe")
            self._prober.start()

    # ---- ring membership ----
    def remove_node(self, node: int):
        """Drops a peer from the ring; its clusters re-route to the
        surviving peers (consistent hashing moves only those)."""
        if len(self.transports) <= 1:
            raise ValueError("cannot remove the last node")
        if node not in self.transports:
            raise KeyError(node)
        if isinstance(self.ownership, HashRing):
            self.ownership = self.ownership.without(node)
        else:
            raise ValueError(
                "remove_node needs a HashRing ownership (static maps like "
                "RangeOwnership have no rebalance story)")
        t = self.transports.pop(node)
        t.close()
        self.health.drop(node)
        if self.self_node == node:
            self.self_node = None

    def add_node(self, node: int, transport):
        if node in self.transports:
            raise KeyError(f"node {node} already present")
        if not isinstance(self.ownership, HashRing):
            raise ValueError("add_node needs a HashRing ownership")
        self.transports[node] = transport
        self.node_blocks.setdefault(node, 0)
        self.ownership = HashRing(sorted(self.transports),
                                  replicas=self.ownership.replicas)

    # ---- fetch ----
    def _l1_get(self, cids: np.ndarray,
                exp: Optional[Dict[int, int]] = None
                ) -> Tuple[Dict[int, Record], List[int]]:
        found: Dict[int, Record] = {}
        missing: List[int] = []
        invalid = 0
        with self._l1_lock:
            for cid in cids:
                cid = int(cid)
                rec = self._l1.get(cid)
                if rec is not None and exp is not None and \
                        record_gen(rec) < exp.get(cid, 0):
                    del self._l1[cid]  # superseded by a republish
                    invalid += 1
                    rec = None
                if rec is None:
                    missing.append(cid)
                else:
                    self._l1.move_to_end(cid)
                    found[cid] = rec
        with self._stats_lock:
            self.l1_hits += len(found)
            self.l1_misses += len(missing)
            self.l1_invalidations += invalid
        return found, missing

    def _l1_put(self, recs: Dict[int, Record]):
        with self._l1_lock:
            for cid, rec in recs.items():
                self._l1[cid] = rec
                self._l1.move_to_end(cid)
            while len(self._l1) > self.l1_records:
                self._l1.popitem(last=False)

    def get(self, cluster_ids, gens=None, alive=None) -> Dict[int, Record]:
        """Fetches records through the ring.  ``alive`` (parallel bool)
        drops clusters whose every (query, probe) pair is already dead
        before the per-owner split (``fetches_skipped``): no peer RPC is
        dispatched for them."""
        from repro_torch.core import probes as probes_lib

        cids = np.asarray(cluster_ids, np.int64).reshape(-1)
        if len(cids) == 0:
            return {}
        if alive is not None:
            keep = np.asarray(alive, bool).reshape(-1)
            n_skip = int((~keep).sum())
            if n_skip:
                with self._stats_lock:
                    self.store_stats.fetches_skipped += n_skip
                cids = cids[keep]
                if gens is not None:
                    gens = np.asarray(gens).reshape(-1)[keep]
                if len(cids) == 0:
                    return {}
        exp: Optional[Dict[int, int]] = None
        if gens is not None:
            exp = {int(c): int(g)
                   for c, g in zip(cids, np.asarray(gens).reshape(-1))}
        # self-owned clusters never enter the L1 (the co-located peer's own
        # cache holds them), so they bypass the L1 probe, which would book
        # a structural miss per lookup
        if self.self_node is not None:
            owners_all = np.asarray(self.ownership.owner_of(cids))
            self_cids = cids[owners_all == self.self_node]
            peer_cids = cids[owners_all != self.self_node]
        else:
            self_cids = cids[:0]
            peer_cids = cids
        out, missing = self._l1_get(peer_cids, exp)
        missing = list(self_cids) + missing
        if not missing:
            return out
        per_owner = probes_lib.split_fetch_by_owner(
            np.asarray(missing, np.int64), self.ownership.owner_of)
        futs = {}
        fallback_cids: List[int] = []
        for owner, sub in per_owner.items():
            if (self.fallback is not None and owner != self.self_node
                    and not self.health.allow(owner)):
                # circuit open and cooldown not lapsed: the local full copy
                # serves this peer's clusters (when the cooldown has
                # lapsed, allow() grants the half-open token and this
                # sub-fetch is the probe)
                fallback_cids.extend(int(c) for c in sub)
                with self._stats_lock:
                    self.store_stats.redirected_blocks += len(sub)
                continue
            sub_gens = (None if exp is None else
                        np.asarray([exp.get(int(c), 0) for c in sub],
                                   np.int64))
            futs[owner] = (sub, self._fan.submit(self._fetch_peer, owner,
                                                 sub, sub_gens))
        for owner, (sub, fut) in futs.items():
            try:
                recs = fut.result()
            except Exception:
                # _fetch_peer already fed the breaker; without a fallback
                # the error surfaces, and the co-located peer failing is a
                # local fault, not a ring event
                if self.fallback is None or owner == self.self_node:
                    raise
                fallback_cids.extend(int(c) for c in sub)
                with self._stats_lock:
                    self.store_stats.failovers += 1
                continue
            if exp is not None and owner != self.self_node:
                # a peer that has not adopted a republish answers with the
                # superseded record: re-serve it through the fallback,
                # never accept it, never L1 it
                stale = [cid for cid, rec in recs.items()
                         if record_gen(rec) < exp.get(cid, 0)]
                if stale:
                    with self._stats_lock:
                        self.store_stats.stale_answers += len(stale)
                    if self.fallback is None:
                        from repro_torch.core import storage

                        raise storage.GenerationMismatchError(
                            f"peer {owner} served stale generations for "
                            f"clusters {stale[:8]} and no fallback store "
                            f"is configured")
                    for cid in stale:
                        recs.pop(cid)
                    fallback_cids.extend(stale)
            out.update(recs)
            with self._stats_lock:
                self.node_blocks[owner] = (self.node_blocks.get(owner, 0)
                                           + len(recs))
                if owner != self.self_node:
                    self.remote_blocks += len(recs)
            if owner != self.self_node:
                self._l1_put(recs)
        if fallback_cids:
            fb = np.asarray(fallback_cids, np.int64)
            if exp is None:
                recs = self.fallback.get(fb)
            else:
                recs = self.fallback.get(fb, gens=np.asarray(
                    [exp.get(int(c), 0) for c in fallback_cids], np.int64))
            out.update(recs)
            with self._stats_lock:
                self.store_stats.fallback_blocks += len(recs)
            if self.adopt_fallback:
                self._l1_put(recs)
        return out

    def _fetch_peer(self, owner, sub, gens=None) -> Dict[int, Record]:
        """One peer sub-fetch with passive health signals: its latency
        feeds the breaker's EWMA, any exception is a failure vote."""
        t0 = time.monotonic()
        try:
            if gens is None:
                recs = self.transports[owner].fetch(sub)
            else:
                recs = self.transports[owner].fetch(sub, gens=gens)
        except Exception:
            if owner != self.self_node:
                self.health.on_failure(owner)
            raise
        if owner != self.self_node:
            self.health.on_success(owner, time.monotonic() - t0)
        return recs

    def refresh(self):
        """Adopts a republished checkpoint ring-wide: reopens every owned
        peer store and the fallback.  The L1 is not cleared: the next
        gen-stamped fetch invalidates exactly the rewritten clusters
        (``l1_invalidations``)."""
        for st in self._owned_stores:
            r = getattr(st, "refresh", None)
            if r is not None:
                r()
        if self.fallback is not None:
            r = getattr(self.fallback, "refresh", None)
            if r is not None:
                r()

    def note_device_hits(self, n: int):
        """Counts blocks a device-resident cache served instead of this
        ring (:class:`~repro_torch.core.devicecache.DeviceBlockCache`)."""
        with self._stats_lock:
            self.store_stats.device_hits += n

    # ---- health ----
    @property
    def degraded(self) -> bool:
        """True while any peer's circuit is not closed (the engine counts
        the batches served in this state)."""
        return self.health.degraded

    def probe_peers(self) -> int:
        """One active-probe pass: pings every non-closed peer whose breaker
        grants a token.  Returns how many probes succeeded."""
        ok = 0
        for node, t in list(self.transports.items()):
            if node == self.self_node:
                continue
            ping = getattr(t, "ping", None)
            if ping is None:
                continue
            ok += int(self.health.probe(node, ping))
        return ok

    def _probe_loop(self):
        while not self._probe_stop.wait(self.probe_interval_s):
            self.probe_peers()

    def stats(self) -> dict:
        with self._stats_lock:
            per_node = {}
            retries = deadline_misses = 0
            for n, t in self.transports.items():
                s = dict(t.stats() if hasattr(t, "stats") else {})
                s["blocks_served"] = self.node_blocks.get(n, 0)
                retries += s.get("retries", 0)
                deadline_misses += s.get("timeouts", 0)
                per_node[n] = s
            return dict(
                kind="sharded", nodes=sorted(self.transports),
                self_node=self.self_node, l1_hits=self.l1_hits,
                l1_misses=self.l1_misses, l1_records=len(self._l1),
                l1_invalidations=self.l1_invalidations,
                remote_blocks=self.remote_blocks, per_node=per_node,
                health={n: s["state"]
                        for n, s in self.health.snapshot().items()},
                failovers=self.store_stats.failovers,
                redirected_blocks=self.store_stats.redirected_blocks,
                fallback_blocks=self.store_stats.fallback_blocks,
                stale_answers=self.store_stats.stale_answers,
                device_hits=self.store_stats.device_hits,
                fetches_skipped=self.store_stats.fetches_skipped,
                retries=retries, deadline_misses=deadline_misses,
                has_fallback=self.fallback is not None)

    def close(self):
        self._probe_stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5)
        self._shutdown_pool()
        self._fan.shutdown(wait=True)
        for t in self.transports.values():
            t.close()
        for s in self._owned_servers:
            s.close()
        for st in self._owned_stores:
            st.close()
        if self._owns_fallback and self.fallback is not None:
            self.fallback.close()


def open_sharded(directory: str, *, n_nodes: int,
                 transport: str = "loopback",
                 capacity_records: Optional[int] = None,
                 l1_records: int = 64, self_node: Optional[int] = 0,
                 pin_fraction: float = 0.5, pin_refresh: int = 64,
                 fallback="open", adopt_fallback: bool = True,
                 timeout_s: float = 30.0, retries: int = 1,
                 breaker_kwargs: Optional[dict] = None,
                 probe_interval_s: Optional[float] = None,
                 device="cuda") -> ShardedBlockStore:
    """Opens an N-node sharded fetch layer over one checkpoint directory.

    Every node opens its own reader and cache over the same checkpoint
    (``capacity_records`` is the per-node cap); ``transport="socket"`` runs
    each peer behind a :class:`BlockStoreServer` and talks to it over the
    deadline-bounded wire (``timeout_s`` / ``retries``).  ``self_node``
    applies to the loopback transport only: behind a socket every peer
    costs a round trip, so its blocks belong in the L1.

    ``fallback``: ``"open"`` (the default) opens one more view of the
    checkpoint as the local full copy; a store instance is used as it is
    (e.g. the pod's own ``DiskIVFIndex.blockstore``); None disables
    failover (peer errors raise).  ``breaker_kwargs`` tune the per-peer
    circuit breakers; ``probe_interval_s`` starts the active-probe thread.
    ``device`` is the device the opened stores' own gathers copy to (the
    ring's records stay on the host).  The returned store owns its nodes,
    servers and an opened fallback: ``close()`` tears them down.
    """
    if transport not in ("loopback", "socket"):
        raise ValueError(f"transport must be 'loopback'|'socket', got "
                         f"{transport!r}")
    if transport != "loopback":
        self_node = None
    stores = [
        LocalBlockStore.open(directory, capacity_records=capacity_records,
                             pin_fraction=pin_fraction,
                             pin_refresh=pin_refresh, name=f"node{i}",
                             device=device)
        for i in range(n_nodes)
    ]
    servers: List[BlockStoreServer] = []
    if transport == "loopback":
        transports = {i: LoopbackTransport(s) for i, s in enumerate(stores)}
    else:
        servers = [BlockStoreServer(s) for s in stores]
        transports = {
            i: SocketTransport(srv.host, srv.port, timeout=timeout_s,
                               retries=retries, spec=stores[i].spec)
            for i, srv in enumerate(servers)
        }
    owns_fallback = isinstance(fallback, str) and fallback == "open"
    if owns_fallback:
        fallback = LocalBlockStore.open(
            directory, capacity_records=capacity_records,
            pin_fraction=pin_fraction, pin_refresh=pin_refresh,
            name="fallback", device=device)
    return ShardedBlockStore(
        transports, ownership=HashRing(range(n_nodes)),
        l1_records=l1_records, self_node=self_node,
        owned_stores=stores, owned_servers=servers,
        fallback=fallback, owns_fallback=owns_fallback,
        adopt_fallback=adopt_fallback, breaker_kwargs=breaker_kwargs,
        probe_interval_s=probe_interval_s)
