"""Pluggable cluster-block fetch layer: the port of ``repro.core.blockstore``
(the single-host stores).

    BlockStore protocol
        get(cluster_ids)  -> {cid: record}      synchronous fetch
        submit(ids)/wait(h)                     async pair the pipelined
                                                executor drives
        stats()                                 observability

    ResidentBlockStore   RAM tier: per-cluster copies of the resident
                         ``[K, Vpad, ...]`` arrays.
    LocalBlockStore      the disk tier: ShardReader + ClusterCache.

A record is a dict of CPU tensors (``vectors``, ``attrs``, ``ids``,
``norms``?, ``scales``?, ``gen``).  :func:`assemble_blocks` packs records
into the scan's batch-local blocks; with ``as_device`` on a CUDA device it
assembles them in pinned host memory and copies them on a side stream, and
:func:`wait_blocks` hands them to the consumer's stream.

Every store returns the same per-cluster records, so any store composed
with the engine yields the results of the RAM tier.  ``RangeOwnership`` is
the sharded dispatch's ownership map; the consistent-hash ring, the sharded
store and its transports are not ported yet (ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Tuple

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
