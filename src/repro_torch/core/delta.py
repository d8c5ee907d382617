"""RAM delta tier and generation-tagged republish (live updates): the port
of ``repro.core.delta``.

  * :class:`DeltaTier` — a byte-bounded append segment (vectors, attrs,
    ids, cluster assignments, a tombstone set) whose buffers live on the
    index's device.  ``SearchEngine`` scans it exactly every batch
    (:func:`scan_snapshot`, the cold scan's row arithmetic) and folds the
    fragment into the top-k monoid after the merge; tombstones mask cold
    hits by id inside the cold scan, so the next cold candidate surfaces
    as a rebuild without the deleted rows would rank it.
  * :func:`compact_deltas` — the republish: folds the frozen delta rows and
    tombstones into their cluster records on disk, rewrites only the
    touched shards, bumps each rewritten cluster's generation, then
    ``counts.npy`` / ``gens.npy`` / the manifest.  The files are the
    reference's byte for byte.
  * The freeze/commit handshake — ``compact_deltas`` freezes the segment's
    prefix; adds keep landing behind it and tombstones of frozen rows are
    queued; :meth:`DeltaTier.commit` (called by ``DiskIVFIndex.refresh``
    between batches) drops the republished prefix and replays the queued
    tombstones against the new cold generation.

Search over the live two-tier index returns what a from-scratch rebuild at
the same logical state returns: the delta scan scores rows as the cold scan
does; a delta row only competes for queries whose geometric top-``n_probes``
holds its cluster (``geo_probes``/``geo_valid`` of the plan); and the
planner sees tombstone- and append-adjusted cluster counts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import kmeans as kmeans_lib
from repro_torch.core import storage
from repro_torch.core import summaries as summaries_lib
from repro_torch.core import topk as topk_lib
from repro_torch.core.blockstore import BlockSpec
from repro_torch.core.hybrid import ATTR_MAX, ATTR_MIN, make_hybrid
from repro_torch.core.update import quantize_rows


class DeltaOverflowError(RuntimeError):
    """The RAM delta segment is full: republish (``compact_deltas`` and
    ``refresh``) before adding more rows.  Raised instead of dropping: a
    lost add is a correctness bug in a live-serving tier."""


# ---------------------------------------------------------------------------
# Snapshot and scans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeltaSnapshot:
    """Immutable per-batch view of the delta segment.

    ``vectors/attrs/clusters/norms/scales`` reference the tier's append
    buffers on its device (rows at and beyond ``n_rows`` are not scanned);
    ``ids`` is a copy (a tombstone writes the buffer in place).
    ``tombstones`` is the cold-id tombstone set as a sorted int32 tensor
    front-padded with ``-2`` to a power of two (``-2`` never matches a real
    id or the dead-slot sentinel -1).
    """

    n_rows: int
    vectors: torch.Tensor            # [cap, D] store dtype
    attrs: torch.Tensor              # [cap, M] int16
    ids: torch.Tensor                # [cap] int32 (-1 = dead)
    clusters: torch.Tensor           # [cap] int32
    norms: Optional[torch.Tensor]    # [cap] f32 (l2 only)
    scales: Optional[torch.Tensor]   # [cap] f32 (SQ8 only)
    tombstones: Optional[torch.Tensor]
    version: int = 0
    # the one-cluster summary over the live rows (snapshot_summary), built
    # on first use; None is a valid built value (no live rows)
    summary: object = None
    summary_ready: bool = False
    # per-attribute [M] envelope over the segment's rows (host int16): a
    # filter disjoint from it on any attribute matches no delta row
    attr_lo: Optional[np.ndarray] = None
    attr_hi: Optional[np.ndarray] = None


def mask_tombstones(ids: torch.Tensor, tombs: torch.Tensor) -> torch.Tensor:
    """Replaces tombstoned ids with -1 (the scan's dead-slot sentinel).

    ``tombs`` is a snapshot's sorted, -2-padded set; applied to the ids
    operand of the cold scan, so its masked top-k surfaces the next live
    candidate.
    """
    idx = torch.searchsorted(tombs, ids)
    hit = tombs[torch.clamp(idx, max=tombs.shape[0] - 1)] == ids
    return torch.where(hit, -1, ids)


def _member(geo: torch.Tensor, geo_ok: torch.Tensor, clusters: torch.Tensor,
            n_clusters: Optional[int]) -> torch.Tensor:
    """[Qpad, C] bool — whether row c's cluster is in query q's geometric
    probe set, through a ``[Qpad, K]`` table gathered by cluster (no
    ``[Qpad, T, C]`` compare).  ``n_clusters`` None: K from the ids."""
    qpad = geo.shape[0]
    if n_clusters is None:
        n_clusters = max(int(geo.max()) if geo.numel() else 0,
                         int(clusters.max()) if clusters.numel() else 0) + 1
    table = torch.zeros((qpad, n_clusters), dtype=torch.bool,
                        device=geo.device)
    rows = torch.arange(qpad, device=geo.device)[:, None].expand(geo.shape)
    table[rows[geo_ok], geo.long()[geo_ok]] = True
    return table[:, clusters.long()]


def _filter_rows(attrs: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor
                 ) -> torch.Tensor:
    """[Qpad, C] bool — the DNF test of rows ``attrs [C, M]`` against each
    query's bounds ``[Qpad, F, M]``, one term and one attribute at a time."""
    a = attrs.int()
    out = torch.zeros((lo.shape[0], a.shape[0]), dtype=torch.bool,
                      device=a.device)
    for f in range(lo.shape[1]):
        term = torch.ones_like(out)
        for m in range(lo.shape[2]):
            am = a[None, :, m]
            term &= (am >= lo[:, f, m, None].int()) & (am <= hi[:, f, m, None].int())
        out |= term
    return out


def scan_snapshot(snap: DeltaSnapshot, queries, queries_pad, lo_pad, hi_pad,
                  geo, geo_ok, *, metric: str, k: int,
                  n_clusters: Optional[int] = None):
    """Exact scan of the snapshot's delta rows: ``[Qpad, k]`` values and
    ids, and per-query ``n_scanned`` / ``n_passed``.

    The cold scan's row arithmetic: queries as the plan cast them, then
    f32; rows store dtype to f32; ``q·v`` (times the SQ8 scale; l2
    ``2·s − ‖v‖²`` and the per-query ``−‖q‖²`` after the top-k), an f32
    matmul without TF32; the DNF interval mask; and membership: a row
    counts for a query only when the query's geometric top-``n_probes``
    holds the row's cluster.  Only the live prefix ``[:n_rows]`` is read
    (at least ``k`` columns, so the top-k always has its width).
    """
    cap = snap.ids.shape[0]
    n = min(max(snap.n_rows, k), cap)
    q32 = queries_pad.float()
    v32 = snap.vectors[:n].float()
    scores = q32 @ v32.T  # [Qpad, n]
    if snap.scales is not None:
        scores = scores * snap.scales[None, :n]
    if metric == "l2":
        scores = 2.0 * scores - snap.norms[None, :n]
    ids = snap.ids[:n]
    live = (ids >= 0) & (torch.arange(n, device=ids.device) < snap.n_rows)
    reach = _member(geo, geo_ok, snap.clusters[:n], n_clusters) & live[None, :]
    mask = _filter_rows(snap.attrs[:n], lo_pad, hi_pad) & reach
    dvals, dids = topk_lib.masked_topk(scores, mask, k,
                                       ids=ids[None, :].expand(scores.shape))
    if metric == "l2":
        q2 = torch.zeros((queries_pad.shape[0],), dtype=torch.float32,
                         device=q32.device)
        q2[:queries.shape[0]] = torch.sum(queries.float() ** 2, -1)
        dvals = torch.where(dvals > topk_lib.NEG_INF / 2, dvals - q2[:, None],
                            dvals)
    return (dvals, dids, reach.sum(-1, dtype=torch.int32),
            mask.sum(-1, dtype=torch.int32))


DELTA_SUMMARY_BINS = 8


def snapshot_summary(snap: DeltaSnapshot):
    """One-cluster interval/histogram summary over the snapshot's live rows
    (None when it has none): ``can_match`` false for every query proves the
    delta scan's mask is all zero, so the fold can be skipped.  Built once
    per snapshot, from the snapshot's own ids copy."""
    if snap.summary_ready:
        return snap.summary
    n = snap.n_rows
    live = torch.zeros(snap.ids.shape[0], dtype=torch.bool,
                       device=snap.ids.device)
    live[:n] = snap.ids[:n] >= 0
    if not bool(live.any()):
        summ = None
    else:
        ids_row = torch.where(live, snap.ids, -1).int()
        summ = summaries_lib.build_summaries(
            snap.attrs[None], ids_row[None], n_bins=DELTA_SUMMARY_BINS)
    snap.summary = summ
    snap.summary_ready = True
    return summ


def _delta_reach(geo, geo_ok, clusters, ids, n_rows, n_clusters):
    """[Qpad] delta rows each query's scan would reach (live and a member
    of its geometric probe set): the scan's ``n_scanned`` without the scan."""
    n = min(n_rows, ids.shape[0])
    live = ids[:n] >= 0
    return (_member(geo, geo_ok, clusters[:n], n_clusters)
            & live[None, :]).sum(-1, dtype=torch.int32)


def snapshot_reach(snap: DeltaSnapshot, geo, geo_ok,
                   n_clusters: Optional[int] = None):
    """Per-query ``n_scanned`` of a skipped delta fold, equal to what the
    full scan would have reported."""
    return _delta_reach(geo, geo_ok, snap.clusters, snap.ids, snap.n_rows,
                        n_clusters)


def _pack_tombstones(tombs, device) -> Optional[torch.Tensor]:
    if not tombs:
        return None
    arr = np.fromiter(tombs, np.int64, len(tombs)).astype(np.int32)
    arr.sort()
    p = 1 << (len(arr) - 1).bit_length()
    out = np.full(p, -2, np.int32)
    out[p - len(arr):] = arr  # front-padded: stays sorted, -2 never matches
    return torch.from_numpy(out).to(device)


# ---------------------------------------------------------------------------
# The tier
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FrozenDelta:
    """The segment prefix a republish folds to disk: host copies, so late
    tombstones on the live buffers cannot change what lands mid-write."""

    n0: int
    ids: np.ndarray
    clusters: np.ndarray
    vectors: torch.Tensor  # [n0, D] store dtype, on the host
    attrs: np.ndarray
    norms: Optional[np.ndarray]
    scales: Optional[np.ndarray]
    tombs: frozenset
    # tombstones that hit a frozen row while the republish ran: the row went
    # to the new cold generation live, so commit() replays the delete there
    late_tombs: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)


class DeltaTier:
    """Byte-bounded append segment over a cold index, on its device.

    ``add`` mirrors ``update.add_vectors`` (same centroid assignment, SQ8
    quantization and norms), so a republish or a rebuild stores the same
    rows.  ``tombstone`` kills delta rows in place and records cold-row
    deletes in the tombstone set, with optional cluster hints that keep the
    planner's adjusted counts in step with a rebuild.  Thread-safe; a
    snapshot is immutable for the batch that took it.
    """

    def __init__(self, index, capacity: int, quantize: str = "auto"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if quantize not in ("auto", "on"):
            raise ValueError(f"quantize must be 'auto'|'on', got "
                             f"{quantize!r}")
        bspec = BlockSpec.from_index(index)
        self.spec = index.spec
        self.metric = index.spec.metric
        # quantize="on" stores SQ8 rows even over a float cold tier (about
        # 4x the rows per byte); the delta scan then scores the quantized
        # rows and a republish dequantizes them to the cold store dtype
        self.quantized = bool(bspec.quantized) or quantize == "on"
        self.quantize = quantize
        self.capacity = int(capacity)
        self.device = index.centroids.device
        # a partitioned RAM index carries sub centroids past the base ids;
        # delta rows are assigned to base clusters (the membership mask and
        # the republish key on base ids)
        cat = getattr(index, "partitions", None)
        self.n_clusters = (int(index.n_clusters) if cat is None
                           else int(cat.n_base))
        self._centroids = index.centroids[:self.n_clusters]
        self._store_dtype = (torch.int8 if self.quantized
                             else index.store_dtype)
        d, m, dev = bspec.dim, bspec.n_attrs, self.device
        self._vectors = torch.zeros((capacity, d), dtype=self._store_dtype,
                                    device=dev)
        self._attrs = torch.zeros((capacity, m), dtype=torch.int16,
                                  device=dev)
        self._ids = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
        self._clusters = torch.zeros((capacity,), dtype=torch.int32,
                                     device=dev)
        self._norms = (torch.zeros((capacity,), dtype=torch.float32,
                                   device=dev) if bspec.has_norms else None)
        self._scales = (torch.zeros((capacity,), dtype=torch.float32,
                                    device=dev) if self.quantized else None)
        # host mirrors of ids and clusters for the bookkeeping
        self._ids_h = np.full((capacity,), -1, np.int32)
        self._clusters_h = np.zeros((capacity,), np.int32)
        # per-attribute envelope over appended rows (empty: lo > hi)
        self._attr_lo = np.full((m,), ATTR_MAX, np.int16)
        self._attr_hi = np.full((m,), ATTR_MIN, np.int16)
        self._n = 0
        self._id2row: Dict[int, int] = {}
        self._tombs: set = set()
        self._tomb_clusters: Dict[int, int] = {}  # cold id -> cluster hint
        self._pending: Optional[FrozenDelta] = None
        self._version = 0
        self._lock = threading.Lock()
        self._adds = 0
        self._tombstoned = 0
        self._commits = 0
        self._snap_cache: Optional[Tuple[int, Optional[DeltaSnapshot]]] = None
        self._adj_cache: Optional[Tuple[int, Optional[np.ndarray]]] = None

    @staticmethod
    def row_bytes(index, quantize: str = "auto") -> int:
        """Bytes one delta row takes (vector, attrs, id, cluster, norm,
        scale)."""
        bspec = BlockSpec.from_index(index)
        quantized = bool(bspec.quantized) or quantize == "on"
        item = 1 if quantized else torch.tensor(
            [], dtype=index.store_dtype).element_size()
        return (bspec.dim * item + bspec.n_attrs * 2 + 4 + 4
                + (4 if bspec.has_norms else 0) + (4 if quantized else 0))

    @classmethod
    def for_index(cls, index, budget_mb: float,
                  quantize: str = "auto") -> "DeltaTier":
        """Sizes the segment from a byte budget (the reference's
        ``--delta-budget-mb``)."""
        cap = max(int(budget_mb * 2 ** 20) // cls.row_bytes(index, quantize),
                  8)
        return cls(index, capacity=cap, quantize=quantize)

    # ---- mutation ----
    def add(self, core, attrs, ids) -> int:
        """Appends a batch of hybrid rows; returns the rows added.  Raises
        :class:`DeltaOverflowError` when the batch would overflow the
        budget."""
        core_t, attrs_t = make_hybrid(self.spec, core, attrs,
                                      device=self.device)
        assign = kmeans_lib.assign(core_t.float(), self._centroids)
        if self.quantized:
            codes, scales = quantize_rows(core_t)
            rows = codes.to(torch.int8)
        else:
            rows, scales = core_t.to(self._store_dtype), None
        norms = (torch.sum(core_t.float() ** 2, -1)
                 if self._norms is not None else None)
        ids_np = np.asarray(torch.as_tensor(ids).cpu(), np.int32).reshape(-1)
        cl_np = assign.cpu().numpy().astype(np.int32)
        a16 = attrs_t.short()
        b = ids_np.shape[0]
        env = ((a16.amin(0).cpu().numpy(), a16.amax(0).cpu().numpy())
               if b else None)
        with self._lock:
            if self._n + b > self.capacity:
                raise DeltaOverflowError(
                    f"delta segment full: {self._n}+{b} > capacity "
                    f"{self.capacity} rows — run compact_deltas() and "
                    f"refresh() before adding more")
            lo = self._n
            sl = slice(lo, lo + b)
            self._vectors[sl] = rows
            self._attrs[sl] = a16
            self._clusters[sl] = assign
            if self._norms is not None:
                self._norms[sl] = norms
            if self._scales is not None:
                self._scales[sl] = scales
            # ids last: a row is dead until its id lands
            self._ids[sl] = torch.from_numpy(ids_np).to(self.device)
            self._ids_h[sl] = ids_np
            self._clusters_h[sl] = cl_np
            if env is not None:
                np.minimum(self._attr_lo, env[0], out=self._attr_lo)
                np.maximum(self._attr_hi, env[1], out=self._attr_hi)
            for j in range(b):
                self._id2row[int(ids_np[j])] = lo + j
            self._n += b
            self._adds += b
            self._version += 1
        return b

    def tombstone(self, ids, clusters=None) -> int:
        """Deletes rows by id; returns how many were newly tombstoned.

        Delta rows die in place.  Other ids are cold rows: they join the
        tombstone set the cold scan masks, and ``clusters`` (aligned
        per-id hints, -1 = unknown) keeps the planner's adjusted counts
        exact.
        """
        ids_np = np.asarray(ids, np.int64).reshape(-1)
        hints = (None if clusters is None
                 else np.asarray(clusters, np.int64).reshape(-1))
        n_new = 0
        with self._lock:
            dead = []
            for j, _id in enumerate(int(i) for i in ids_np):
                row = self._id2row.pop(_id, None)
                if row is not None:
                    dead.append(row)
                    n_new += 1
                    if self._pending is not None and row < self._pending.n0:
                        # a frozen row being written live to the new cold
                        # generation: replay the delete there at commit
                        self._pending.late_tombs.append(
                            (_id, int(self._clusters_h[row])))
                    continue
                if _id in self._tombs:
                    continue
                self._tombs.add(_id)
                n_new += 1
                if hints is not None and hints[j] >= 0:
                    self._tomb_clusters[_id] = int(hints[j])
            if dead:
                rows = np.asarray(dead, np.int64)
                self._ids_h[rows] = -1
                self._ids[torch.from_numpy(rows).to(self.device)] = -1
            self._tombstoned += n_new
            self._version += 1
        return n_new

    # ---- per-batch views ----
    def snapshot(self) -> Optional[DeltaSnapshot]:
        """The batch's immutable view (None when the tier is empty), cached
        by version: batches with no mutation between them share one."""
        with self._lock:
            if (self._snap_cache is not None
                    and self._snap_cache[0] == self._version):
                return self._snap_cache[1]
            if self._n == 0 and not self._tombs:
                snap = None
            else:
                snap = DeltaSnapshot(
                    n_rows=self._n, vectors=self._vectors, attrs=self._attrs,
                    ids=self._ids.clone(), clusters=self._clusters,
                    norms=self._norms, scales=self._scales,
                    tombstones=_pack_tombstones(self._tombs, self.device),
                    version=self._version,
                    attr_lo=self._attr_lo.copy(),
                    attr_hi=self._attr_hi.copy(),
                )
            self._snap_cache = (self._version, snap)
            return snap

    def count_adjustment(self, n_clusters: int) -> Optional[np.ndarray]:
        """[K] int32 live delta adds minus hinted cold tombstones: what the
        planner adds to the cold counts so its empty-cluster mask agrees
        with a rebuild.  None when all zero."""
        with self._lock:
            if (self._adj_cache is not None
                    and self._adj_cache[0] == self._version):
                return self._adj_cache[1]
            adj = np.zeros(n_clusters, np.int32)
            n = self._n
            if n:
                live = self._ids_h[:n] >= 0
                np.add.at(adj, self._clusters_h[:n][live], 1)
            for c in self._tomb_clusters.values():
                adj[c] -= 1
            out = adj if adj.any() else None
            self._adj_cache = (self._version, out)
            return out

    # ---- republish handshake ----
    def freeze(self) -> FrozenDelta:
        """Copies the segment prefix and the tombstone set to the host for a
        republish; adds keep landing behind the freeze.  One republish at a
        time."""
        with self._lock:
            if self._pending is not None:
                raise RuntimeError(
                    "a republish is already in flight (freeze without "
                    "commit) — refresh() the serving index first")
            n0 = self._n

            def host(t):
                return None if t is None else t[:n0].cpu().numpy()

            fro = FrozenDelta(
                n0=n0, ids=self._ids_h[:n0].copy(),
                clusters=self._clusters_h[:n0].copy(),
                vectors=self._vectors[:n0].cpu(), attrs=host(self._attrs),
                norms=host(self._norms), scales=host(self._scales),
                tombs=frozenset(self._tombs),
            )
            self._pending = fro
            return fro

    def commit(self) -> bool:
        """Drops the republished prefix (the new cold generation serves
        those rows) and replays the queued late tombstones against it.
        Called between batches; False when no republish was in flight."""
        with self._lock:
            fro = self._pending
            if fro is None:
                return False
            n0, n = fro.n0, self._n
            keep = n - n0
            bufs = [self._vectors, self._attrs, self._clusters, self._ids]
            bufs += [b for b in (self._norms, self._scales) if b is not None]
            for buf in bufs:
                buf[:keep] = buf[n0:n].clone()
            self._ids[keep:n] = -1
            for arr in (self._ids_h, self._clusters_h):
                arr[:keep] = arr[n0:n].copy()
            self._ids_h[keep:n] = -1
            self._n = keep
            # the envelope only ever widened: recompute it from the rows
            # that survive, so the fold's skip test regains its bite
            m = self._attrs.shape[1]
            self._attr_lo = np.full((m,), ATTR_MAX, np.int16)
            self._attr_hi = np.full((m,), ATTR_MIN, np.int16)
            live = self._ids_h[:keep] >= 0
            if live.any():
                rows = self._attrs[:keep][torch.from_numpy(live).to(
                    self.device)]
                self._attr_lo = rows.amin(0).cpu().numpy().astype(np.int16)
                self._attr_hi = rows.amax(0).cpu().numpy().astype(np.int16)
            self._id2row = {int(i): r for r, i in enumerate(self._ids_h[:keep])
                            if i >= 0}
            # folded tombstones are gone from the new records
            self._tombs -= fro.tombs
            for _id in fro.tombs:
                self._tomb_clusters.pop(_id, None)
            # deletes that raced the republish: live in the new generation,
            # masked there from the next batch on
            for _id, c in fro.late_tombs:
                self._tombs.add(_id)
                self._tomb_clusters[_id] = c
            self._pending = None
            self._version += 1
            self._commits += 1
            return True

    # ---- observability ----
    def stats(self) -> Dict[str, object]:
        with self._lock:
            return dict(
                rows=self._n,
                live_rows=int((self._ids_h[:self._n] >= 0).sum()),
                capacity=self.capacity,
                tombstones=len(self._tombs),
                adds=self._adds,
                tombstoned=self._tombstoned,
                commits=self._commits,
                pending=self._pending is not None,
                version=self._version,
            )


# ---------------------------------------------------------------------------
# Republish
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RepublishStats:
    """What one ``compact_deltas`` run rewrote."""

    clusters_rewritten: int
    shards_rewritten: int
    rows_folded: int        # delta rows written into cluster records
    rows_reclaimed: int     # dead (tombstoned or stale) slots dropped
    tombstones_applied: int
    gen_max: int
    # what scheduled it: "manual", "every", "rows" or "stale"
    trigger: str = "manual"


def republish_pressure(tier: DeltaTier, *,
                       rows_watermark: Optional[int] = None,
                       stale_frac: Optional[float] = None,
                       n_live: int = 0) -> Optional[str]:
    """Which watermark, if any, says the tier should republish now:
    ``"rows"`` (the segment's row count reached ``rows_watermark``) or
    ``"stale"`` (tombstones over ``n_live`` reached ``stale_frac``); None
    otherwise, and always None while a republish is pending."""
    st = tier.stats()
    if st["pending"]:
        return None
    if rows_watermark is not None and st["rows"] >= rows_watermark > 0:
        return "rows"
    if stale_frac is not None and stale_frac > 0:
        if st["tombstones"] / max(int(n_live), 1) >= stale_frac:
            return "stale"
    return None


def compact_deltas(directory: str, tier: Optional[DeltaTier] = None, *,
                   include_stale: bool = True,
                   trigger: str = "manual") -> RepublishStats:
    """Folds the tier's frozen rows and tombstones into the checkpoint.

    Rewrites only the shards holding touched clusters: each touched
    cluster's record keeps its live rows in slot order, then the delta rows
    in add order (the stable scatter a rebuild performs); its summary and
    bound rows are rebuilt exactly and its generation bumped; then
    ``counts.npy``, ``gens.npy``, the summaries, the bounds and the
    manifest follow, each atomically, the manifest last.  A serving index
    keeps reading its old files until ``refresh()`` flips it between
    batches, which also commits the freeze taken here.

    ``include_stale`` also folds clusters whose only debt is tombstoned
    slots under the count (the ``stale_counts`` debt).  On a layout-4
    checkpoint every sub-partition of a touched cluster is rebuilt from the
    folded record and its generation bumped (:func:`_republish_partitions`).
    """
    man = storage.load_manifest(directory)
    if man.get("layout", 1) < 3:
        raise storage.GenerationMismatchError(
            f"compact_deltas needs a generation-tagged (layout 3) "
            f"checkpoint, found layout {man.get('layout', 1)} at "
            f"{directory!r} — re-save with save_index(..., layout=3)")
    paths = storage.check_complete(directory, man)
    gens = storage.load_gens(directory, man)
    counts = np.array(np.load(os.path.join(directory, "counts.npy")),
                      np.int32)
    k, n_shards, vpad = man["n_clusters"], man["n_shards"], man["vpad"]
    kl = k // n_shards
    # shard fields as numpy words (bfloat16 as int16)
    parts = [{name: storage.host_words(t) for name, t in
              storage.read_shard_fields(p, man).items()} for p in paths]

    frozen = tier.freeze() if tier is not None else None
    if frozen is not None and frozen.n0:
        f_live = np.nonzero(frozen.ids >= 0)[0]
    else:
        f_live = np.zeros(0, np.int64)
    tombs = frozen.tombs if frozen is not None else frozenset()
    tomb_arr = (np.fromiter(tombs, np.int64, len(tombs)) if tombs
                else np.zeros(0, np.int64))

    per_cluster: Dict[int, List[int]] = {}
    for i in f_live:
        per_cluster.setdefault(int(frozen.clusters[i]), []).append(int(i))
    touched = set(per_cluster)
    tombstones_applied = 0
    hits = []  # per shard: [kl, Vpad] slots holding a tombstoned id
    for s, part in enumerate(parts):
        ids_s = part["ids"]  # [kl, Vpad]
        if tomb_arr.size:
            hit = np.isin(ids_s, tomb_arr)
            hits.append(hit)
            tombstones_applied += int(hit.sum())
            touched.update(s * kl + lc for lc in np.nonzero(hit.any(1))[0])
        if include_stale:
            crow = counts[s * kl:(s + 1) * kl]
            within = np.arange(vpad)[None, :] < crow[:, None]
            touched.update(s * kl + lc for lc in np.nonzero(
                (within & (ids_s < 0)).any(1))[0])

    if not touched:
        # nothing to publish; the empty freeze is dropped at the next commit
        return RepublishStats(0, 0, 0, 0, 0, int(gens.max(initial=0)),
                              trigger=trigger)

    summ = storage.load_summaries(directory, man, device="cpu")
    bounds = storage.load_bounds(directory, man, device="cpu")
    centroids = (np.load(os.path.join(directory, "centroids.npy"))
                 if bounds is not None else None)
    field_names = [f["name"] for f in man["fields"] if f["name"] != "gen"]
    frozen_fields = {}
    if frozen is not None:
        f_vectors = frozen.vectors
        if tier.quantized and not man.get("quantized", False):
            # a forced-SQ8 tier over a float checkpoint: codes times scales,
            # cast to the cold store dtype
            f_vectors = (f_vectors.float()
                         * torch.from_numpy(frozen.scales)[:, None]).to(
                storage.torch_dtype(man["store_dtype"]))
        frozen_fields = dict(vectors=storage.host_words(f_vectors),
                             attrs=frozen.attrs, ids=frozen.ids,
                             norms=frozen.norms, scales=frozen.scales)
    vdtype = man["store_dtype"]
    rows_folded = rows_reclaimed = 0
    for c in sorted(touched):
        s, lc = divmod(c, kl)
        part = parts[s]
        old_ids = part["ids"][lc]
        cnt = int(counts[c])
        keep = (np.arange(vpad) < cnt) & (old_ids >= 0)
        if tomb_arr.size:
            keep &= ~hits[s][lc]
        keep_idx = np.nonzero(keep)[0]  # stable slot order
        add_rows = per_cluster.get(c, [])
        n_new = len(keep_idx) + len(add_rows)
        if n_new > vpad:
            raise ValueError(
                f"cluster {c} overflows vpad={vpad} with {n_new} rows "
                f"after folding {len(add_rows)} delta rows — the cluster "
                f"needs a split/rebuild, not a republish")
        for name in field_names:
            row = part[name][lc]
            new = np.zeros_like(row)
            if name == "ids":
                new[:] = -1
            new[:len(keep_idx)] = row[keep_idx]
            if add_rows:
                new[len(keep_idx):n_new] = frozen_fields[name][add_rows]
            part[name][lc] = new
        part["gen"][lc, 0] = gens[c] + 1
        gens[c] += 1
        rows_folded += len(add_rows)
        rows_reclaimed += cnt - len(keep_idx)
        counts[c] = n_new
        ids_row = torch.from_numpy(part["ids"][lc])
        if summ is not None:
            summ = summaries_lib.rebuild_cluster(
                summ, torch.from_numpy(part["attrs"][lc]), ids_row, c)
        if bounds is not None:
            bounds = summaries_lib.rebuild_cluster_bounds(
                bounds, torch.from_numpy(centroids[c]),
                storage.to_tensor(part["vectors"][lc], vdtype), ids_row,
                (torch.from_numpy(part["norms"][lc])
                 if "norms" in part else None),
                (torch.from_numpy(part["scales"][lc])
                 if man.get("quantized", False) else None),
                c)

    part_build = (_republish_partitions(directory, man, parts, counts, gens,
                                        touched, field_names)
                  if man.get("has_partitions") else None)

    # rewrite only the shards that hold touched clusters, then the resident
    # files, each atomically, the manifest last
    stride = man["record_stride"]
    shards_touched = sorted({c // kl for c in touched})
    for s in shards_touched:
        def _bin_save(p, s=s):
            with open(p, "wb") as f:
                rec = np.zeros(stride, np.uint8)
                for lc in range(kl):
                    rec[:] = 0
                    for fld in man["fields"]:
                        raw = np.ascontiguousarray(
                            parts[s][fld["name"]][lc]).view(np.uint8).reshape(-1)
                        o = fld["offset"]
                        rec[o:o + raw.size] = raw
                    f.write(rec.tobytes())

        storage._atomic_save(paths[s], _bin_save)

    storage._atomic_save(os.path.join(directory, "counts.npy"),
                         lambda p: storage._np_save(p, counts))
    storage._atomic_save(os.path.join(directory, storage.GENS_FILE),
                         lambda p: storage._np_save(p, gens))
    if summ is not None:
        for field, fname in storage.SUMMARY_FILES.items():
            storage._atomic_save(
                os.path.join(directory, fname),
                lambda p, f=field: storage._np_save(
                    p, getattr(summ, f).cpu().numpy()))
    if bounds is not None:
        for field, fname in storage.BOUNDS_FILES.items():
            storage._atomic_save(
                os.path.join(directory, fname),
                lambda p, f=field: storage._np_save(
                    p, getattr(bounds, f).cpu().numpy()))
    if part_build is not None:
        storage.write_partition_region(directory, man, part_build, gens[k:])
    man["n_live"] = int(counts.sum())

    def _write_manifest(p):
        with open(p, "w") as f:
            f.write(json.dumps(man, indent=2))

    storage._atomic_save(os.path.join(directory, storage.MANIFEST),
                         _write_manifest)
    return RepublishStats(
        clusters_rewritten=len(touched),
        shards_rewritten=len(shards_touched),
        rows_folded=rows_folded,
        rows_reclaimed=rows_reclaimed,
        tombstones_applied=tombstones_applied,
        gen_max=int(gens.max(initial=0)),
        trigger=trigger,
    )


def _republish_partitions(directory: str, man: dict, parts, counts: np.ndarray,
                          gens: np.ndarray, touched, field_names):
    """The partition plane of a republish: each sub of a touched base
    cluster is rebuilt from the folded record with the build's row rule
    (``partitions.select_sub_rows``), its generation (past the base ids in
    ``gens``, updated in place) bumped; the catalog's counts, intervals and
    entry rows follow.  Sub capacities only grow.  Returns the
    :class:`~repro_torch.core.partitions.PartitionBuild` to write."""
    from repro_torch.core import partitions as partitions_lib

    k, vpad = man["n_clusters"], man["vpad"]
    kl = k // man["n_shards"]
    dtypes = {f["name"]: f["dtype"] for f in man["fields"]}
    cat = storage.load_partitions(directory, man)
    records = storage.load_partition_records(directory, man)
    vpads = np.asarray(storage.load_partition_vpads(directory),
                       np.int64).copy()
    parent = np.asarray(cat.parent, np.int64)
    sub_counts = np.asarray(cat.sub_counts, np.int32).copy()
    sub_amin = np.asarray(cat.sub_amin, np.int16).copy()
    sub_amax = np.asarray(cat.sub_amax, np.int16).copy()
    resubbed = np.nonzero(np.isin(parent, np.fromiter(
        touched, np.int64, len(touched))))[0]
    for p in resubbed:
        p = int(p)
        c = int(parent[p])
        s, lc = divmod(c, kl)
        part = parts[s]
        rows = partitions_lib.select_sub_rows(
            part["attrs"][lc], part["ids"][lc], int(counts[c]),
            np.asarray(cat.sub_lo[p]), np.asarray(cat.sub_hi[p]))
        n = int(rows.size)
        vp = max(int(vpads[p]),
                 min(partitions_lib._round_up(max(n, 1),
                                              partitions_lib.SUB_ALIGN), vpad),
                 n)
        vpads[p] = vp
        rec = {}
        for name in field_names:
            src = part[name][lc]
            new = np.zeros((vp,) + src.shape[1:], src.dtype)
            if name == "ids":
                new[:] = -1
            if n:
                new[:n] = src[rows]
            rec[name] = storage.to_tensor(new, dtypes[name])
        records[p] = rec
        sub_counts[p] = n
        if n:
            sub_amin[p] = part["attrs"][lc][rows].min(axis=0)
            sub_amax[p] = part["attrs"][lc][rows].max(axis=0)
        else:
            sub_amin[p] = ATTR_MAX
            sub_amax[p] = ATTR_MIN
        gens[k + p] += 1
    return partitions_lib.PartitionBuild(
        catalog=cat.resynced(counts, sub_counts, sub_amin, sub_amax),
        records=records, vpads=vpads.astype(np.int32))
