"""Disk-resident index tier: the port of ``repro.core.disk``.

:class:`DiskIVFIndex` serves a layout-2/3/4 checkpoint (``core/storage.py``)
with only the resident set in memory:

  * **Resident set**, on the index's device: centroids ``[K, D]``, counts
    ``[K]``, the attribute summaries and score bounds; on the host the
    generation vector, the manifest's offset arithmetic and, on layout 4,
    the partition catalog.  Everything the plan needs before it knows which
    lists to touch.
  * **Paged set**: per-cluster records read from the shard files through
    :class:`ClusterCache`, a host LRU keyed by cluster id, capped so
    ``resident_bytes() <= resident_budget_bytes``; the most-probed clusters
    are pinned against eviction.
  * **Probe-driven fill**: ``prefetch_for_queries`` plans a batch and pages
    its clusters in, in the order the scan first needs them
    (``probes.fetch_order``), on a background thread.

Search runs through the same engine and tiled kernel as the RAM tier: the
engine's fetch stage pulls records through the index's
:class:`~repro_torch.core.blockstore.LocalBlockStore` and scans batch-local
gathered blocks with slot-local cluster ids, with the same results.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import blockstore as blockstore_lib
from repro_torch.core import storage
from repro_torch.core.hybrid import HybridSpec
from repro_torch.device import resolve_device


class ShardReader:
    """Reader of layout-2/3/4 shard files, one cluster record per read.

    Thread-safe: a read copies the record out of the file (``pread``) into
    a fresh host buffer and returns per-field tensor views of it.  Every
    record carries a ``gen`` field, read from layout-3 records and 0 for
    layout 2, so gen-keyed cache layers treat both alike.  On layout 4, ids
    ``>= n_base`` are sub-partitions, read from ``partitions.bin`` at their
    own stride through the resident byte-offset table.
    """

    def __init__(self, directory: str, man: dict):
        if man["layout"] not in (2, 3, 4):
            raise ValueError(
                "DiskIVFIndex requires a layout-v2/v3/v4 checkpoint; re-save "
                "it with storage.save_index(index, dir): v1 .npz shards are "
                "not cluster-addressable")
        self.directory = directory
        self._lock = threading.Lock()
        self._apply_manifest(man)

    def _apply_manifest(self, man: dict):
        self.man = man
        self.paths = storage.shard_paths(self.directory, man)
        self.kl = man["n_clusters"] // man["n_shards"]
        self.stride: int = man["record_stride"]
        self.fields = self._field_table(man["fields"])
        self.n_base = man["n_clusters"]
        # opened eagerly: a lazy open after a republish rename would read
        # the new file against the old counts and gens.  Files a reopen
        # replaces close when the last read racing it drops them.
        self._files = [open(p, "rb", buffering=0) for p in self.paths]
        # layout 4: the sub-partition region, one (fields, stride) per sub
        self._part_file = None
        self._part_offsets: Optional[np.ndarray] = None
        self._part_layouts: List[Tuple] = []
        if man.get("has_partitions"):
            self._part_offsets = np.asarray(np.load(os.path.join(
                self.directory, storage.PARTITION_OFFSETS)), np.int64)
            for vp in storage.load_partition_vpads(self.directory):
                fields, stride = storage.partition_record_layout(man, int(vp))
                self._part_layouts.append((self._field_table(fields), stride))
            self._part_file = open(os.path.join(
                self.directory, storage.PARTITION_DATA), "rb", buffering=0)

    @staticmethod
    def _field_table(fields):
        return [(f["name"], storage.torch_dtype(f["dtype"]), tuple(f["shape"]),
                 f["offset"], int(np.prod(f["shape"]))
                 * storage.np_dtype(f["dtype"]).itemsize) for f in fields]

    def reopen(self, man: Optional[dict] = None):
        """Re-reads the manifest and reopens the shard files: the local half
        of a generation flip.  Reads racing the swap may still return
        old-generation records, which the gen-keyed caches catch."""
        with self._lock:
            self._apply_manifest(
                man if man is not None
                else storage.load_manifest(self.directory))

    def read(self, cid: int) -> Dict[str, torch.Tensor]:
        """Reads cluster ``cid``'s record into one host buffer and returns
        per-field views into it."""
        cid = int(cid)
        if cid >= self.n_base:
            return self._read_partition(cid - self.n_base)
        s, r = divmod(cid, self.kl)
        files, fields, stride = self._files, self.fields, self.stride
        rec = self._pread(files[s], r * stride, stride, fields,
                          f"cluster {cid} from {self.paths[s]}")
        if "gen" not in rec:  # layout 2: pre-generation records are gen 0
            rec["gen"] = torch.zeros((1,), dtype=torch.int64)
        return rec

    def _read_partition(self, p: int) -> Dict[str, torch.Tensor]:
        layouts, f = self._part_layouts, self._part_file
        if f is None or p >= len(layouts):
            raise ValueError(f"sub-partition {p} out of range for this "
                             f"checkpoint ({len(layouts)} subs)")
        fields, stride = layouts[p]
        return self._pread(f, int(self._part_offsets[p]), stride, fields,
                           f"sub-partition {p}")

    @staticmethod
    def _pread(f, offset: int, stride: int, fields, what: str):
        buf = np.empty(stride, np.uint8)
        got = os.preadv(f.fileno(), [buf], offset)
        if got != stride:
            raise OSError(f"short read of {what}: {got} of {stride} bytes")
        raw = torch.from_numpy(buf)
        return {name: raw[o:o + nb].view(dt).reshape(shape)
                for name, dt, shape, o, nb in fields}

    def close(self):
        for f in self._files:
            f.close()
        if self._part_file is not None:
            self._part_file.close()


@dataclasses.dataclass
class CacheStats:
    hits: int = 0        # served from cache (incl. waits on in-flight loads)
    misses: int = 0      # loaded synchronously by the requesting thread
    evictions: int = 0
    prefetched: int = 0  # loaded by the background thread
    errors: int = 0      # prefetch-thread load failures (retried inline)
    stalled_waits: int = 0  # waits on an in-flight load that outlived the
    #                         waiter timeout; the waiter loaded inline
    invalidations: int = 0  # cached records dropped for a newer expected
    #                         generation


class ClusterCache:
    """Host LRU over cluster records, with probe-driven prefetch and
    hot-cluster pinning.

    * ``get_many`` is the synchronous path: returns every requested record,
      loading misses inline (deduplicated against in-flight prefetches).
    * ``prefetch`` enqueues ids to a daemon thread.
    * Every ``pin_refresh`` batches, the ``pin_fraction`` most-probed
      clusters are pinned: the LRU never evicts them.  Capacity is a hard
      cap either way: the cache holds at most ``capacity_records`` records.
    """

    def __init__(self, reader: ShardReader, *, capacity_records: int,
                 n_clusters: int, pin_fraction: float = 0.5,
                 pin_refresh: int = 64, waiter_timeout_s: float = 30.0):
        if capacity_records < 1:
            raise ValueError("capacity_records must be >= 1")
        if not 0.0 <= pin_fraction <= 1.0:
            raise ValueError(f"pin_fraction must be in [0, 1], got "
                             f"{pin_fraction}")
        self.reader = reader
        self.record_nbytes = reader.stride
        self.capacity_records = capacity_records
        # at least one slot always stays evictable, so an insert never has
        # to evict a pinned record to stay within capacity
        self.pin_records = min(int(pin_fraction * capacity_records),
                               max(capacity_records - 1, 0))
        self.pin_refresh = pin_refresh
        self.waiter_timeout_s = waiter_timeout_s
        self.stats = CacheStats()
        self._entries: "collections.OrderedDict[int, dict]" = (
            collections.OrderedDict())
        self._inflight: Dict[int, list] = {}  # cid -> [Event, record|None]
        self._probe_count = np.zeros(n_clusters, np.int64)
        self._pinned: set = set()
        self._batches = 0
        self._lock = threading.Lock()
        self._stopped = False
        self._queue: "queue.Queue[Optional[int]]" = queue.Queue()
        self._worker = threading.Thread(target=self._prefetch_loop,
                                        daemon=True)
        self._worker.start()

    # ---- internal (lock held) ----
    def _insert_locked(self, cid: int, rec: dict):
        if cid in self._entries:
            self._entries.move_to_end(cid)
            return
        while len(self._entries) >= self.capacity_records:
            victim = next(
                (c for c in self._entries if c not in self._pinned), None)
            if victim is None:  # everything pinned: fall back to plain LRU
                victim = next(iter(self._entries))
            del self._entries[victim]
            self.stats.evictions += 1
        self._entries[cid] = rec

    def _refresh_pins_locked(self):
        if self.pin_records == 0:
            return
        order = np.argsort(self._probe_count)[::-1][: self.pin_records]
        self._pinned = {int(c) for c in order if self._probe_count[c] > 0}

    def _load(self, cid: int, *, prefetched: bool) -> dict:
        # on a read failure the in-flight entry is still resolved (with the
        # exception), or a waiter would hang
        try:
            rec = self.reader.read(cid)
        except BaseException as e:
            with self._lock:
                holder = self._inflight.pop(cid, None)
            if holder is not None:
                holder[1] = e
                holder[0].set()
            raise
        with self._lock:
            holder = self._inflight.pop(cid, None)
            self._insert_locked(cid, rec)
            if prefetched:
                self.stats.prefetched += 1
        if holder is not None:
            holder[1] = rec
            holder[0].set()
        return rec

    def _prefetch_loop(self):
        while True:
            cid = self._queue.get()
            try:
                if cid is None:
                    return
                self._load(cid, prefetched=True)
            except Exception:
                # a failed prefetch is a missed hint (get_many retries
                # inline), but it is counted: a failing disk would otherwise
                # turn every prefetched batch into synchronous reads unseen
                with self._lock:
                    self.stats.errors += 1
            finally:
                self._queue.task_done()

    def _validated(self, cid: int, rec: dict, exp: Optional[Dict[int, int]]
                   ) -> dict:
        """Gen-checks a freshly loaded or waiter-delivered record: below
        the expected generation the reader is reopened and the record read
        once more; a second stale read raises."""
        if exp is None or cid not in exp:
            return rec
        want = exp[cid]
        if blockstore_lib.record_gen(rec) >= want:
            return rec
        with self._lock:
            self._entries.pop(cid, None)
            self.stats.invalidations += 1
        self.reader.reopen()
        rec = self._load(cid, prefetched=False)
        got = blockstore_lib.record_gen(rec)
        if got < want:
            raise storage.GenerationMismatchError(
                f"cluster {cid}: shard on disk serves gen {got} but gen "
                f">= {want} was published: checkpoint republish incomplete "
                "or rolled back")
        return rec

    # ---- public ----
    def probe_heat(self, cid: int) -> int:
        """Observed probe count for one cluster."""
        return int(self._probe_count[int(cid)])

    def get_many(self, cids: Sequence[int],
                 gens: Optional[Sequence[int]] = None) -> Dict[int, dict]:
        """Returns {cid: record} for every id, blocking on disk as needed.

        ``gens`` (parallel to ``cids``) carries the minimum acceptable
        generation per cluster; cached records below it are dropped
        (``stats.invalidations``) and re-read.
        """
        exp: Optional[Dict[int, int]] = None
        if gens is not None:
            exp = {int(c): int(g) for c, g in zip(cids, gens)}
        out: Dict[int, dict] = {}
        to_load: List[int] = []
        waiters: List[Tuple[int, list]] = []
        with self._lock:
            self._batches += 1
            for cid in cids:
                self._probe_count[int(cid)] += 1
            if self._batches % self.pin_refresh == 0:
                self._refresh_pins_locked()
            for cid in cids:
                cid = int(cid)
                if cid in self._entries:
                    rec = self._entries[cid]
                    if (exp is not None and cid in exp
                            and blockstore_lib.record_gen(rec) < exp[cid]):
                        del self._entries[cid]  # stale generation
                        self.stats.invalidations += 1
                        self._inflight[cid] = [threading.Event(), None]
                        to_load.append(cid)
                        self.stats.misses += 1
                        continue
                    self._entries.move_to_end(cid)
                    out[cid] = rec
                    self.stats.hits += 1
                elif cid in self._inflight:  # prefetch already racing
                    waiters.append((cid, self._inflight[cid]))
                    self.stats.hits += 1
                else:
                    self._inflight[cid] = [threading.Event(), None]
                    to_load.append(cid)
                    self.stats.misses += 1
        for i, cid in enumerate(to_load):
            try:
                out[cid] = self._validated(
                    cid, self._load(cid, prefetched=False), exp)
            except BaseException as e:
                # resolve this call's other registrations too, or threads
                # waiting on them hang
                with self._lock:
                    for rest in to_load[i + 1:]:
                        holder = self._inflight.pop(rest, None)
                        if holder is not None:
                            holder[1] = e
                            holder[0].set()
                raise
        for cid, holder in waiters:
            # bounded wait: a hung loader must not hang every batch that
            # raced its load
            if not holder[0].wait(timeout=self.waiter_timeout_s):
                with self._lock:
                    self.stats.stalled_waits += 1
                out[cid] = self._load(cid, prefetched=False)
            elif isinstance(holder[1], BaseException):  # prefetch failed;
                out[cid] = self._load(cid, prefetched=False)  # retry inline
            else:
                out[cid] = holder[1]
            out[cid] = self._validated(cid, out[cid], exp)
        return out

    def prefetch(self, cids: Sequence[int]):
        """Queues cluster loads on the background thread (fire and forget);
        a no-op after :meth:`stop`."""
        with self._lock:
            if self._stopped:
                return
            # enqueued under the lock of the in-flight registration, so a
            # concurrent stop() cannot slip its sentinel in between
            for cid in cids:
                cid = int(cid)
                if cid in self._entries or cid in self._inflight:
                    continue
                self._inflight[cid] = [threading.Event(), None]
                self._queue.put(cid)

    def drain(self):
        """Blocks until every queued prefetch has landed; a no-op after
        :meth:`stop`."""
        with self._lock:
            if self._stopped:
                return
        self._queue.join()

    def stop(self):
        """Stops the prefetch thread.  Idempotent."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
        self._queue.put(None)
        self._worker.join(timeout=10)

    def resident_bytes(self) -> int:
        return len(self._entries) * self.record_nbytes

    @property
    def pinned(self) -> frozenset:
        return frozenset(self._pinned)

    @property
    def hit_rate(self) -> float:
        tot = self.stats.hits + self.stats.misses
        return self.stats.hits / tot if tot else 0.0


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.nbytes)


def _resident_overhead(centroids, counts, summaries, bounds=None,
                       partitions=None) -> int:
    """Bytes of the always-resident set (everything except the cluster
    cache): the one formula the budget check in ``open`` and
    ``resident_bytes()`` share."""
    return _nbytes(centroids) + _nbytes(counts) + (
        summaries.nbytes() if summaries is not None else 0
    ) + (bounds.nbytes() if bounds is not None else 0) + (
        partitions.nbytes() if partitions is not None else 0)


class DiskIVFIndex:
    """Disk-resident serving view of a layout-2/3/4 checkpoint.

    Only centroids, counts, summaries, bounds, the partition catalog and
    offset arithmetic stay in memory (the first four on ``device``); flat
    lists and sub-partition records page through
    :class:`ClusterCache` under ``resident_budget_bytes``.  Satisfies the
    ``.spec / .centroids / .counts`` contract of the plan and plugs into the
    engine through its ``blockstore``, so RAM and disk tiers share one
    search implementation and return the same results.

    ``gens`` holds the per-cluster generation vector the plan pins fetches
    to; :meth:`refresh` flips to a republished checkpoint between batches.
    ``delta`` is the RAM delta tier the engine folds into every batch
    (attach a :class:`~repro_torch.core.delta.DeltaTier`), and
    ``device_cache`` a :class:`~repro_torch.core.devicecache.
    DeviceBlockCache` that engines built over this index pick up.
    ``partitions`` is the layout-4 catalog (None before layout 4).
    """

    def __init__(self, directory: str, man: dict, spec: HybridSpec,
                 centroids: np.ndarray, counts: np.ndarray,
                 reader: ShardReader, cache: ClusterCache,
                 resident_budget_bytes: Optional[int],
                 summaries=None, bounds=None, partitions=None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.directory = directory
        self.man = man
        self.spec = spec
        self.centroids = torch.from_numpy(centroids).to(self.device)
        self.counts = torch.from_numpy(counts).to(self.device)
        self.reader = reader
        self.cache = cache
        self.resident_budget_bytes = resident_budget_bytes
        self.summaries = summaries
        self.bounds = bounds
        self.partitions = partitions
        self.gens = storage.load_gens(directory, man)
        self.delta = None
        self.device_cache = None
        self._overhead = _resident_overhead(centroids, counts, summaries,
                                            bounds, partitions)
        self.blockstore = blockstore_lib.LocalBlockStore(
            reader, cache, blockstore_lib.BlockSpec.from_manifest(man),
            device=self.device)

    @classmethod
    def open(cls, directory: str, *,
             resident_budget_bytes: Optional[int] = None,
             pin_fraction: float = 0.5, pin_refresh: int = 64,
             device="cuda") -> "DiskIVFIndex":
        """Opens a checkpoint for disk-tier serving on ``device``.

        ``resident_budget_bytes`` caps the resident set plus the cluster
        cache; ``None`` sizes the cache to hold every cluster.
        """
        dev = resolve_device(device)
        man = storage.load_manifest(directory)
        storage.check_complete(directory, man)
        reader = ShardReader(directory, man)
        centroids = np.load(os.path.join(directory, "centroids.npy"))
        counts = np.load(os.path.join(directory, "counts.npy"))
        summaries = storage.load_summaries(directory, man, device=dev)
        bounds = storage.load_bounds(directory, man, device=dev)
        partitions = storage.load_partitions(directory, man)
        overhead = _resident_overhead(centroids, counts, summaries, bounds,
                                      partitions)
        # sub-partitions are cluster records past the base id space
        n_total = man["n_clusters"] + (
            partitions.n_subs if partitions is not None else 0)
        if resident_budget_bytes is None:
            cap = n_total
        else:
            cap = (int(resident_budget_bytes) - overhead) // reader.stride
            if cap < 1:
                raise ValueError(
                    f"resident_budget_bytes={resident_budget_bytes} cannot "
                    f"hold the resident set ({overhead} B, incl. attribute "
                    f"summaries) plus one cluster record ({reader.stride} B)")
            cap = min(cap, n_total)
        cache = ClusterCache(reader, capacity_records=cap, n_clusters=n_total,
                             pin_fraction=pin_fraction,
                             pin_refresh=pin_refresh)
        return cls(directory, man, storage.spec_from_manifest(man),
                   centroids, counts, reader, cache, resident_budget_bytes,
                   summaries=summaries, bounds=bounds, partitions=partitions,
                   device=dev)

    # ---- IVFFlatIndex-compatible surface (what search paths touch) ----
    @property
    def n_clusters(self) -> int:
        return self.man["n_clusters"]

    @property
    def vpad(self) -> int:
        return self.man["vpad"]

    @property
    def quantized(self) -> bool:
        return self.man["quantized"]

    @property
    def store_dtype(self) -> torch.dtype:
        return storage.torch_dtype(self.man["store_dtype"])

    def resident_bytes(self) -> int:
        """Current bytes held for this index (resident set + cache)."""
        return self._overhead + self.cache.resident_bytes()

    def refresh(self) -> bool:
        """Adopts a republished checkpoint between batches: re-reads the
        manifest and generation vector and, when the generations moved,
        swaps in the new counts, summaries, bounds, catalog and gens and
        reopens the
        shard reader.  Cached records are not flushed: the next fetch
        carries the new expected gens, so exactly the rewritten clusters
        invalidate.  Then commits the attached delta tier's pending freeze
        (the folded rows leave RAM; late tombstones carry over).  Returns
        whether the on-disk generation changed."""
        man = storage.load_manifest(self.directory)
        gens = storage.load_gens(self.directory, man)
        changed = not np.array_equal(gens, self.gens)
        if changed:
            storage.check_complete(self.directory, man)
            self.reader.reopen(man)
            self.man = man
            counts = np.load(os.path.join(self.directory, "counts.npy"))
            self.counts = torch.from_numpy(counts).to(self.device)
            self.summaries = storage.load_summaries(self.directory, man,
                                                    device=self.device)
            self.bounds = storage.load_bounds(self.directory, man,
                                              device=self.device)
            self.partitions = storage.load_partitions(self.directory, man)
            self.gens = gens
            self._overhead = _resident_overhead(
                self.centroids, self.counts, self.summaries, self.bounds,
                self.partitions)
        if self.delta is not None:
            self.delta.commit()
        return changed

    # ---- paging (delegates to the BlockStore fetch layer) ----
    def gather(self, slot_cluster) -> Tuple:
        """Maps the plan's global cluster ids to batch-local rows, pages
        the distinct clusters through the cache, and returns host blocks
        ``(local_ids [S], vectors [U, Vpad, D], attrs, ids, norms,
        scales)``."""
        return self.blockstore.gather(slot_cluster)

    def gather_submit(self, slot_cluster) -> Future:
        """Starts paging, assembling and copying ``slot_cluster``'s blocks
        to the index's device off-thread; finish with :meth:`gather_wait`,
        exactly once per handle."""
        return self.blockstore.gather_submit(slot_cluster)

    def gather_wait(self, handle: Future) -> Tuple:
        """The blocks of a :meth:`gather_submit` handle, handed to the
        current stream; re-raises a load failure."""
        return self.blockstore.gather_wait(handle)

    def prefetch(self, cluster_ids):
        """Background-loads clusters (e.g. ``probes.fetch_order`` output)."""
        self.cache.prefetch(np.asarray(cluster_ids).reshape(-1))

    def prefetch_for_queries(self, queries, n_probes: int,
                             q_block: int = 64, fspec=None,
                             prune: str = "auto",
                             t_max: Optional[int] = None):
        """Plans the next batch's probes and starts paging them in, in the
        order the scan first needs them.  Pass the ``q_block``, ``fspec``,
        ``prune`` and ``t_max`` the search will use: with the filters in
        hand, clusters the summaries prove empty are never read, and the
        plan has the search's width."""
        from repro_torch.core import probes as probes_lib
        from repro_torch.core.engine import (
            plan_fused_tiled,
            resolve_prune,
            resolve_t_max,
        )
        from repro_torch.core.filters import FilterSpec, match_all

        queries = torch.as_tensor(queries, device=self.device)
        q = queries.shape[0]
        qb = min(q_block, ((q + 7) // 8) * 8)
        if fspec is None:  # no filters known yet: geometry-only plan
            fspec = match_all(q, self.spec.n_attrs, device=self.device)
            summ = None
        else:
            fspec = FilterSpec(lo=torch.as_tensor(fspec.lo, device=self.device),
                               hi=torch.as_tensor(fspec.hi, device=self.device))
            summ = resolve_prune(self, prune)
        t_max = resolve_t_max(t_max, summ, self.counts, fspec.lo, fspec.hi,
                              n_probes, self.n_clusters)
        width = n_probes if t_max is None else t_max
        u_cap = min(qb * width, self.n_clusters)
        cast_dtype = torch.float32 if self.quantized else self.store_dtype
        slot_cluster, _, _, _, n_unique, *_ = plan_fused_tiled(
            self.centroids, self.counts, queries, fspec.lo, fspec.hi,
            metric=self.spec.metric, n_probes=n_probes, q_block=qb,
            u_cap=u_cap, cast_dtype=cast_dtype, summaries=summ, t_max=t_max)
        self.prefetch(probes_lib.fetch_order(slot_cluster, n_unique, u_cap))

    # ---- search ----
    def search(self, queries, fspec, *, k: int, n_probes: int,
               q_block: int = 64, v_block: int = 256,
               u_cap: Optional[int] = None, prune: str = "auto", t_max=None,
               pipeline: str = "off", pipeline_depth: int = 2,
               blockstore=None, operand_cache: str = "auto",
               device_cache=None, termination: Optional[str] = None,
               epsilon: float = 0.0, **unported):
        """Disk-tier filtered search with the RAM path's contract and ids.
        ``pipeline="on"`` scans tile *i* while tile *i+1*'s clusters page
        in, with the same results."""
        from repro_torch.core.engine import SearchEngine

        eng = SearchEngine(
            self, k=k, n_probes=n_probes, q_block=q_block, v_block=v_block,
            u_cap=u_cap, prune=prune, t_max=t_max, pipeline=pipeline,
            pipeline_depth=pipeline_depth, blockstore=blockstore,
            operand_cache=operand_cache, device_cache=device_cache,
            termination=termination, epsilon=epsilon, device=self.device,
            **unported)
        try:
            return eng.search(queries, fspec)
        finally:
            eng.close()

    def close(self):
        """Stops the prefetch thread and the fetch worker.  Idempotent."""
        self.blockstore.close()

    def __enter__(self) -> "DiskIVFIndex":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
