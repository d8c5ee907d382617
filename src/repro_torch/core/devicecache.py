"""Cross-batch device-resident cluster-block cache (heat-weighted LRU): the
port of ``repro.core.devicecache``.

The disk tier's per-batch operand cache stops paying the store for a
cluster more than once per batch, but the next batch pays the host
assembly and the copy to the card again.  This cache keeps each hot
cluster's record on the card across batches, keyed on ``(cluster_id,
gen)`` like every host cache layer:

  * a **hit** costs a dict lookup: no read, no host assembly, no H2D.  The
    scan's blocks are composed on the card by stacking entries (one row
    per distinct cluster, as ``blockstore.assemble_blocks`` lays them out;
    every entry is ``spec.vpad`` rows tall, sub-partition records padded
    with the assembler's dead-row fill), so results match the host path.
  * a **miss** is fetched through the store as before; the record crosses
    to the card once and becomes the entry the batch composes from.
  * eviction is **heat-weighted LRU** under a byte budget: among the
    ``HEAT_WINDOW`` least-recently-used entries, the one with the lowest
    probe heat goes first (``heat_fn``, the disk cache's
    ``ClusterCache.probe_heat``, else the cache's own request counts).
  * :meth:`DeviceBlockCache.invalidate_below` (called from
    ``SearchEngine.refresh``) drops exactly the entries a republish made
    stale; lookups also carry the batch's expected generations, so a stale
    entry is never served before the refresh lands.
  * a **composed-tile memo** returns the blocks of an exact repeat of a
    cluster set verbatim.  Tiles are derived data: they only use budget
    the entries leave free and evict (plain LRU) before any entry.

Storage on the card.  Every entry owns its own tensors (a row cut out of
a batch block would keep the whole block alive, and the byte budget would
lie).  Records are staged in pinned host memory and copied on the cache's
side stream, one allocation per field and entry; composition runs on the
same stream, so it is ordered after the copies it reads, and its blocks
come back as :class:`~repro_torch.core.blockstore.DeviceBlocks` that the
consumer takes through ``blockstore.wait_blocks`` (which marks them used
on its stream).  An evicted entry's memory is recycled only by later work
on the side stream, after the compositions that read it.  A lock guards
the tables: the pipelined executor's worker admits entries while the main
thread composes.  On the CPU the same code runs without streams.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.blockstore import (
    BlockSpec,
    DeviceBlocks,
    Record,
    record_gen,
)
from repro_torch.device import resolve_device


def record_nbytes(spec: BlockSpec) -> int:
    """Device bytes of one cluster's entry under ``spec``."""
    v = spec.vpad
    item = torch.tensor([], dtype=spec.store_dtype).element_size()
    n = v * spec.dim * item     # vectors
    n += v * spec.n_attrs * 2   # attrs (int16)
    n += v * 4                  # ids (int32)
    if spec.has_norms:
        n += v * 4
    if spec.quantized:
        n += v * 4
    return n


@dataclasses.dataclass
class DeviceEntry:
    """One cluster's record on the cache's device, ``spec.vpad`` rows."""

    gen: int
    vectors: torch.Tensor            # [Vpad, D] store dtype
    attrs: torch.Tensor              # [Vpad, M] int16
    ids: torch.Tensor                # [Vpad] int32
    norms: Optional[torch.Tensor]    # [Vpad] f32 (l2 only)
    scales: Optional[torch.Tensor]   # [Vpad] f32 (SQ8 only)


_FIELDS = ("vectors", "attrs", "ids", "norms", "scales")


class DeviceBlockCache:
    """``(cluster_id, gen)``-keyed LRU of device-resident cluster records.

    Thread-safe.  Entries handed out by :meth:`get_many` stay valid after a
    concurrent eviction: eviction drops the cache's reference, never the
    tensors a batch in flight composes from.
    """

    # eviction scans this many LRU-oldest entries and evicts the coldest
    HEAT_WINDOW = 8

    def __init__(self, spec: BlockSpec, budget_bytes: int,
                 heat_fn: Optional[Callable[[int], float]] = None,
                 device="cuda"):
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        self.spec = spec
        self.device = resolve_device(device)
        self.budget_bytes = int(budget_bytes)
        self.entry_nbytes = record_nbytes(spec)
        self.capacity_records = self.budget_bytes // self.entry_nbytes
        self.heat_fn = heat_fn
        self._entries: "OrderedDict[int, DeviceEntry]" = OrderedDict()
        self._requests: Dict[int, int] = {}  # fallback heat: cid -> lookups
        # composed-tile memo: (cids tuple, s) -> (gens tuple, blocks tuple)
        self._tiles: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._tile_bytes = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.invalidations = 0
        self.tile_hits = 0
        self.tile_puts = 0
        self.bytes_copied = 0  # host -> device bytes of admitted records

    # ---- lookup ----
    def get_many(self, cids: Sequence[int],
                 gens: Optional[np.ndarray] = None
                 ) -> Tuple[Dict[int, DeviceEntry], List[int]]:
        """Resident entries for ``cids`` and the misses (first-need order
        kept).  ``gens`` aligns with ``cids`` and carries the batch's
        expected minimum generations: an entry below its minimum is
        dropped (an invalidation) and reported missing, never served."""
        hits: Dict[int, DeviceEntry] = {}
        missing: List[int] = []
        with self._lock:
            for j, c in enumerate(cids):
                cid = int(c)
                self._requests[cid] = self._requests.get(cid, 0) + 1
                e = self._entries.get(cid)
                if e is not None and gens is not None \
                        and e.gen < int(gens[j]):
                    del self._entries[cid]
                    self.invalidations += 1
                    e = None
                if e is None:
                    self.misses += 1
                    missing.append(cid)
                else:
                    self.hits += 1
                    self._entries.move_to_end(cid)
                    hits[cid] = e
        return hits, missing

    def filter_missing(self, cids: np.ndarray,
                       gens: Optional[np.ndarray] = None) -> np.ndarray:
        """The subset of ``cids`` the store must be asked for: a pure peek
        (no stats, no LRU touch; :meth:`get_many` at assembly time is the
        lookup that counts)."""
        with self._lock:
            keep = []
            for j, c in enumerate(cids):
                e = self._entries.get(int(c))
                if e is None or (gens is not None and e.gen < int(gens[j])):
                    keep.append(j)
        return np.asarray(cids)[keep]

    # ---- composed-tile memo ----
    def get_tile(self, cids: Sequence[int], s: int,
                 gens: Optional[np.ndarray] = None) -> Optional[Tuple]:
        """The memoized blocks for this exact cluster set, or None.  A memo
        whose members fell below the batch's expected generations is
        dropped (an invalidation), never served.  A hit counts every
        member as a device hit."""
        key = (tuple(int(c) for c in cids), int(s))
        with self._lock:
            hit = self._tiles.get(key)
            if hit is None:
                return None
            tile_gens, blocks = hit
            if gens is not None and any(
                    g < int(gens[j]) for j, g in enumerate(tile_gens)):
                self._drop_tile(key)
                self.invalidations += 1
                return None
            self._tiles.move_to_end(key)
            self.tile_hits += 1
            self.hits += len(key[0])
            return blocks

    def put_tile(self, cids: Sequence[int], s: int,
                 entries: Sequence[DeviceEntry], blocks: Tuple) -> None:
        """Memoizes a composed tile in budget the entries leave free,
        LRU-evicting older tiles to fit; a tile that still does not fit is
        not memoized.  A tile counts ``s`` entries of budget, as the
        reference's ``[S, Vpad]`` composition does."""
        nbytes = int(s) * self.entry_nbytes
        key = (tuple(int(c) for c in cids), int(s))
        with self._lock:
            room = self.budget_bytes - len(self._entries) * self.entry_nbytes
            if nbytes > room:
                return
            while self._tile_bytes + nbytes > room and self._tiles:
                self._drop_tile(next(iter(self._tiles)))
                self.evictions += 1
            if self._tile_bytes + nbytes > room:
                return
            if key in self._tiles:
                self._drop_tile(key)
            self._tiles[key] = (tuple(e.gen for e in entries), blocks)
            self._tile_bytes += nbytes
            self.tile_puts += 1

    def _drop_tile(self, key) -> None:
        """Removes one memoized tile (lock held)."""
        del self._tiles[key]
        self._tile_bytes -= key[1] * self.entry_nbytes

    def _shrink_tiles_to_room(self) -> None:
        """Evicts LRU tiles until the memo fits the budget the entries
        leave (lock held): tiles always yield to entries."""
        room = self.budget_bytes - len(self._entries) * self.entry_nbytes
        while self._tile_bytes > room and self._tiles:
            self._drop_tile(next(iter(self._tiles)))
            self.evictions += 1

    # ---- insert ----
    def put_records(self, recs: Dict[int, Record]
                    ) -> Dict[int, DeviceEntry]:
        """Copies fetched host records to the card and admits them
        (evicting the coldest LRU-tail entries while over budget).  Returns
        the entries for every record, admitted or not: the caller composes
        from them, so a record crosses to the card once."""
        out: Dict[int, DeviceEntry] = {}
        fresh: List[Tuple[int, int, Record]] = []
        for cid, rec in recs.items():
            cid = int(cid)
            gen = record_gen(rec)
            with self._lock:
                old = self._entries.get(cid)
            if old is not None and old.gen >= gen:
                out[cid] = old
            else:
                fresh.append((cid, gen, rec))
        for (cid, gen, _), e in zip(fresh, self._entries_from_records(
                [r for _, _, r in fresh])):
            e.gen = gen
            out[cid] = e
            if self.capacity_records == 0:
                continue  # budget below one entry: compose only, no admit
            with self._lock:
                self._entries[cid] = e
                self._entries.move_to_end(cid)
                self.puts += 1
                while len(self._entries) > self.capacity_records:
                    self._evict_one()
                self._shrink_tiles_to_room()
        return out

    def _entries_from_records(self, recs: List[Record]) -> List[DeviceEntry]:
        """Entries for host records, padded to ``spec.vpad`` rows with the
        assembler's fill (zeros, ids -1, unit scales).  On the card the
        records are staged in one pinned buffer per field and copied on
        the side stream into one allocation per field and entry."""
        if not recs:
            return []
        spec, n, vpad = self.spec, len(recs), self.spec.vpad
        pin = self.device.type == "cuda"
        shapes = dict(vectors=((vpad, spec.dim), spec.store_dtype, 0),
                      attrs=((vpad, spec.n_attrs), torch.int16, 0),
                      ids=((vpad,), torch.int32, -1))
        if spec.has_norms:
            shapes["norms"] = ((vpad,), torch.float32, 0)
        if spec.quantized:
            shapes["scales"] = ((vpad,), torch.float32, 1)
        staged = {}
        for name, (shape, dtype, fill) in shapes.items():
            buf = torch.empty((n,) + shape, dtype=dtype, pin_memory=pin)
            for i, rec in enumerate(recs):
                rows = int(rec["ids"].shape[0])
                buf[i, :rows].copy_(rec[name])
                if rows < vpad:
                    buf[i, rows:] = fill
            staged[name] = buf
        if not pin:
            return [DeviceEntry(gen=0, **{
                f: staged[f][i].clone() if f in staged else None
                for f in _FIELDS}) for i in range(n)]
        with torch.cuda.stream(self._stream):
            entries = [DeviceEntry(gen=0, **{
                f: (staged[f][i].to(self.device, non_blocking=True)
                    if f in staged else None) for f in _FIELDS})
                for i in range(n)]
        with self._lock:
            self.bytes_copied += n * self.entry_nbytes
        return entries

    def _evict_one(self):
        """Drops the coldest of the ``HEAT_WINDOW`` LRU-oldest entries
        (lock held)."""
        window = []
        for cid in self._entries:  # insertion order = LRU order
            window.append(cid)
            if len(window) >= self.HEAT_WINDOW:
                break
        victim = min(window, key=self._heat)
        del self._entries[victim]
        self.evictions += 1

    def _heat(self, cid: int) -> float:
        if self.heat_fn is not None:
            try:
                return float(self.heat_fn(cid))
            except Exception:
                pass
        return float(self._requests.get(cid, 0))

    # ---- invalidation ----
    def invalidate_below(self, gens: np.ndarray) -> int:
        """Drops every entry (and memoized tile) whose generation is below
        the published vector: exactly the clusters a republish rewrote.
        Returns the count."""
        g = np.asarray(gens)
        dropped = 0
        with self._lock:
            for cid in [c for c, e in self._entries.items()
                        if c < g.shape[0] and e.gen < int(g[c])]:
                del self._entries[cid]
                dropped += 1
            for key in [k for k, (tgens, _) in self._tiles.items()
                        if any(c < g.shape[0] and tg < int(g[c])
                               for c, tg in zip(k[0], tgens))]:
                self._drop_tile(key)
                dropped += 1
            self.invalidations += dropped
        return dropped

    def clear(self) -> int:
        with self._lock:
            n = len(self._entries) + len(self._tiles)
            self._entries.clear()
            self._tiles.clear()
            self._tile_bytes = 0
        return n

    # ---- composition ----
    def compose(self, entries: Sequence[DeviceEntry]) -> Tuple:
        """Stacks entries (first-need order) into the scan's ``(vectors
        [U, Vpad, D], attrs, ids, norms, scales)`` blocks on the card: one
        row per distinct cluster, as ``assemble_blocks`` lays them out.
        On the card the stack runs on the side stream, after the copies
        that made the entries."""
        def stack():
            return tuple(
                None if getattr(entries[0], f) is None
                else torch.stack([getattr(e, f) for e in entries])
                for f in _FIELDS)

        if self._stream is None:
            return stack()
        with torch.cuda.stream(self._stream):
            return stack()

    def handoff(self, local: np.ndarray, blocks: Tuple):
        """The engine's fetch output ``(local [S], *blocks)``: on the card
        a :class:`DeviceBlocks` whose ``ready`` event follows every copy
        and stack queued so far on the side stream (pass it through
        ``blockstore.wait_blocks``); on the CPU a plain tuple."""
        local = np.ascontiguousarray(local, np.int32)
        if self._stream is None:
            return (torch.from_numpy(local),) + tuple(blocks)
        with torch.cuda.stream(self._stream):
            out = DeviceBlocks(
                (torch.from_numpy(local).to(self.device, non_blocking=True),)
                + tuple(blocks))
            out.ready = torch.cuda.Event()
            out.ready.record(self._stream)
        return out

    # ---- observability ----
    def resident_ids(self) -> List[int]:
        """The cluster ids with a resident entry, LRU-oldest first."""
        with self._lock:
            return list(self._entries)

    @property
    def resident_bytes(self) -> int:
        return len(self._entries) * self.entry_nbytes + self._tile_bytes

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return dict(
                hits=self.hits, misses=self.misses, puts=self.puts,
                evictions=self.evictions, invalidations=self.invalidations,
                tile_hits=self.tile_hits, tile_puts=self.tile_puts,
                entries=len(self._entries), tiles=len(self._tiles),
                resident_bytes=(len(self._entries) * self.entry_nbytes
                                + self._tile_bytes),
                capacity_records=self.capacity_records,
                budget_bytes=self.budget_bytes, hit_rate=self.hit_rate(),
            )
