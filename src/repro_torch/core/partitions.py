"""Filter-specialized sub-partitions: the port of ``repro.core.partitions``.

A **sub-partition** re-slices one cluster along a popular attribute
predicate: its record holds the parent's live rows inside a selection box,
in the parent's slot order, padded to a multiple of :data:`SUB_ALIGN` rows
(never past the parent's Vpad).  A resident :class:`PartitionCatalog` maps
predicate boxes (entries) to sub ids ``[n_base, n_base + P)``; the planner
picks, per query, the narrowest entry whose box subsumes the query's
filter and remaps that query's probes from base ids to sub ids.  Every
layer below the planner keys on ``(cluster_id, gen)``, so subs are just
more clusters with shorter records.

Exactness: an entry subsumes a filter iff every non-void DNF term's box
lies inside the entry's box on every attribute, so no passing row lives
outside the entry's rows; ``members[e, c] = -1`` means "scan the parent",
always exact.  A sub keeps its parent's slot order, so its candidates tie
like the parent's.

The catalog and the routing are host-side numpy, as in the reference;
records are dicts of CPU tensors (bf16 kept as bf16), like every record
of the port's stores.  :func:`build_from_arrays` carries a reference
``PartitionBuild`` across as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hybrid import ATTR_MAX, ATTR_MIN

# Sub-partition rows are padded to a multiple of this, like the reference's
# lane width (the CUDA kernel streams 128-row chunks).
SUB_ALIGN = 128

CATALOG_FIELDS = ("pred_lo", "pred_hi", "members", "entry_rows", "parent",
                  "sub_lo", "sub_hi", "sub_counts", "sub_amin", "sub_amax")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _np(x) -> np.ndarray:
    """A tensor (any device) or array as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class PartitionCatalog:
    """Resident predicate -> sub-cluster routing table (host-side numpy).

    E entries (predicate boxes) and P subs (materialized records); sub ids
    live in ``[n_base, n_base + P)``.
    """

    pred_lo: np.ndarray     # [E, M] int16 — entry predicate box (lo)
    pred_hi: np.ndarray     # [E, M] int16 — entry predicate box (hi)
    members: np.ndarray     # [E, K_base] int32 — sub cid, or -1 = parent
    entry_rows: np.ndarray  # [E] int64 — rows reachable via the entry
    parent: np.ndarray      # [P] int32 — base cluster each sub re-slices
    sub_lo: np.ndarray      # [P, M] int16 — selection box that built the sub
    sub_hi: np.ndarray      # [P, M] int16
    sub_counts: np.ndarray  # [P] int32 — live rows per sub
    sub_amin: np.ndarray    # [P, M] int16 — per-sub attribute intervals
    sub_amax: np.ndarray    # [P, M] int16
    n_base: int

    @property
    def n_entries(self) -> int:
        return int(self.pred_lo.shape[0])

    @property
    def n_subs(self) -> int:
        return int(self.parent.shape[0])

    @property
    def n_attrs(self) -> int:
        return int(self.pred_lo.shape[1])

    def nbytes(self) -> int:
        return sum(getattr(self, f).nbytes for f in CATALOG_FIELDS)

    def route(self, lo, hi) -> np.ndarray:
        """Narrowest subsuming entry per query, or -1 (flat path).

        ``lo, hi``: [Q, n_terms, M] int16 filter boxes (void terms have
        lo > hi on some attribute).  An entry subsumes a query iff every
        non-void term's box lies inside the entry box on every attribute
        and the query has a non-void term; the entry reaching the fewest
        rows wins (the first on a tie).
        """
        lo = np.asarray(_np(lo), np.int16)
        hi = np.asarray(_np(hi), np.int16)
        if lo.ndim == 2:  # a single query
            lo, hi = lo[None], hi[None]
        nonvoid = np.all(lo <= hi, axis=-1)  # [Q, T]
        cont = np.all(
            (self.pred_lo[None, None, :, :] <= lo[:, :, None, :])
            & (hi[:, :, None, :] <= self.pred_hi[None, None, :, :]),
            axis=-1)  # [Q, T, E]
        ok = np.all(cont | ~nonvoid[:, :, None], axis=1)  # [Q, E]
        ok &= nonvoid.any(axis=1)[:, None]
        rows = np.where(ok, self.entry_rows[None, :], np.iinfo(np.int64).max)
        best = np.argmin(rows, axis=1).astype(np.int32)
        return np.where(ok.any(axis=1), best, np.int32(-1))

    def resynced(self, base_counts: np.ndarray, sub_counts: np.ndarray,
                 sub_amin: np.ndarray, sub_amax: np.ndarray
                 ) -> "PartitionCatalog":
        """The catalog after its subs were rebuilt from their parents: new
        per-sub counts and intervals, and the entry rows the router ranks
        by recomputed (a member's sub rows, else its parent's count)."""
        k = self.n_base
        mem = np.asarray(self.members, np.int64)
        entry_rows = np.where(
            mem >= 0, sub_counts[np.clip(mem - k, 0, None)].astype(np.int64),
            np.asarray(base_counts[:k], np.int64)[None, :]).sum(axis=1)
        return dataclasses.replace(self, entry_rows=entry_rows,
                                   sub_counts=sub_counts, sub_amin=sub_amin,
                                   sub_amax=sub_amax)

    def to_base(self, cids: np.ndarray) -> np.ndarray:
        """Sub ids -> their parents' base ids (identity on base ids): the
        bridge to base-width arrays (centroids, bounds, summaries)."""
        cids = np.asarray(cids)
        out = cids.copy()
        is_sub = cids >= self.n_base
        if is_sub.any():
            out[is_sub] = self.parent[cids[is_sub] - self.n_base]
        return out


@dataclasses.dataclass
class PartitionBuild:
    """A catalog plus the sub-partition records to persist."""

    catalog: PartitionCatalog
    records: List[Dict[str, torch.Tensor]]  # per sub: vectors/attrs/ids/...
    vpads: np.ndarray  # [P] int32 — per-sub padded capacity

    @property
    def n_subs(self) -> int:
        return len(self.records)


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: an exact int16 view
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def build_from_arrays(catalog: Dict[str, np.ndarray], n_base: int,
                      records: Sequence[Dict[str, np.ndarray]],
                      vpads) -> PartitionBuild:
    """The port's :class:`PartitionBuild` from a reference build's arrays:
    ``catalog`` maps each :class:`PartitionCatalog` field to numpy,
    ``records`` are the per-sub field dicts (bf16 as ``ml_dtypes``
    arrays), ``vpads`` the per-sub capacities."""
    cat = PartitionCatalog(n_base=int(n_base), **{
        f: np.asarray(catalog[f]).copy() for f in CATALOG_FIELDS})
    recs = [{name: _to_tensor(np.asarray(a)) for name, a in rec.items()}
            for rec in records]
    return PartitionBuild(catalog=cat, records=recs,
                          vpads=np.asarray(vpads, np.int32).copy())


class FilterTrafficRecorder:
    """Counts which attributes live filter traffic constrains.

    The engine calls :meth:`observe` per planned batch; :meth:`top_attrs`
    feeds the partition builder the attributes worth specializing for.
    Thread-safe.
    """

    def __init__(self, n_attrs: int):
        self.n_attrs = int(n_attrs)
        self.constrained = np.zeros(self.n_attrs, np.int64)
        self.queries = 0
        self._lock = threading.Lock()

    def observe(self, lo, hi) -> None:
        lo, hi = _np(lo), _np(hi)
        nonvoid = np.all(lo <= hi, axis=-1, keepdims=True)  # [Q, T, 1]
        narrowed = (lo > ATTR_MIN) | (hi < ATTR_MAX)        # [Q, T, M]
        per_query = np.any(narrowed & nonvoid, axis=1)      # [Q, M]
        with self._lock:
            self.constrained += per_query.sum(axis=0).astype(np.int64)
            self.queries += int(lo.shape[0])

    def top_attrs(self, n: int = 2) -> List[int]:
        with self._lock:
            counts = self.constrained.copy()
        order = np.argsort(-counts, kind="stable")
        return [int(a) for a in order[:n] if counts[a] > 0]

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return dict(queries=int(self.queries),
                        constrained=self.constrained.tolist())


def choose_attrs(summaries, traffic: Optional[FilterTrafficRecorder] = None,
                 n: int = 2) -> List[int]:
    """Partition-attribute choice: observed filter traffic first, the
    summaries' global value spread as the cold-start fallback."""
    if traffic is not None:
        top = traffic.top_attrs(n)
        if top:
            return top
    if summaries is None:
        return []
    spread = (_np(summaries.edges_hi).astype(np.int32)
              - _np(summaries.edges_lo).astype(np.int32))
    order = np.argsort(-spread, kind="stable")
    return [int(a) for a in order[:n] if spread[a] > 0]


def _ladder_windows(glo: int, ghi: int, *, base_windows: int,
                    max_depth: int) -> List[Tuple[int, int]]:
    """Sliding-window ladder over [glo, ghi]: level l has n = base·2^l
    windows of width 2·range/n at stride range/n, so any query interval of
    width <= range/n lies inside some level-l window."""
    windows: List[Tuple[int, int]] = []
    span = max(int(ghi) - int(glo), 1)
    for level in range(max_depth):
        n = base_windows * (2 ** level)
        if n >= 2 * span:  # windows narrower than one value: stop
            break
        stride = span / n
        width = 2 * stride
        for i in range(n):
            wlo = int(np.floor(glo + i * stride))
            whi = int(np.ceil(glo + i * stride + width))
            windows.append((int(np.clip(wlo, ATTR_MIN, ATTR_MAX)),
                            int(np.clip(whi, ATTR_MIN, ATTR_MAX))))
    return windows


def build_partitions(index, *, attrs: Optional[Sequence[int]] = None,
                     max_depth: int = 3, base_windows: int = 8,
                     max_values: int = 32, max_subs: int = 4096,
                     traffic: Optional[FilterTrafficRecorder] = None
                     ) -> PartitionBuild:
    """Builds the partition catalog and sub-partition records of an index
    (the reference's rule, entry for entry and sub for sub).

    For each chosen attribute, low-cardinality values (<= ``max_values``
    distinct) get per-value entries and ordered ranges the sliding-window
    ladder.  Per (entry, cluster) a sub is materialized only when the
    window's live rows are a strict subset of the parent's; identical row
    subsets are shared across entries, and at most ``max_subs`` subs are
    made (later entries scan the parent).  The selection runs on host
    copies of attrs, ids and counts; the rows are gathered from the index
    where it lives, one cluster at a time.
    """
    A = _np(index.attrs)      # [K, Vpad, M]
    ids = _np(index.ids)      # [K, Vpad]
    counts = _np(index.counts)
    k, vpad, m = A.shape

    if attrs is None:
        attrs = choose_attrs(index.summaries, traffic)
    attrs = [int(a) for a in attrs]
    for a in attrs:
        if not 0 <= a < m:
            raise ValueError(f"partition attr {a} out of range [0, {m})")

    slot = np.arange(vpad)[None, :]
    live = (slot < counts[:, None]) & (ids >= 0)  # [K, Vpad]
    live_counts = live.sum(axis=1).astype(np.int64)

    # entry predicate boxes: full-range except the partition attribute
    entry_boxes: List[Tuple[int, int, int]] = []  # (attr, wlo, whi)
    for a in attrs:
        vals = A[:, :, a][live]
        if vals.size == 0:
            continue
        distinct = np.unique(vals)
        if distinct.size <= max_values:
            for v in distinct:
                entry_boxes.append((a, int(v), int(v)))
        else:
            glo, ghi = int(vals.min()), int(vals.max())
            for wlo, whi in _ladder_windows(glo, ghi,
                                            base_windows=base_windows,
                                            max_depth=max_depth):
                entry_boxes.append((a, wlo, whi))

    # materialize subs, sharing identical row subsets per cluster
    sub_key: Dict[Tuple[int, bytes], int] = {}
    sub_rows: List[np.ndarray] = []  # selected slot indices, slot order
    sub_parent: List[int] = []
    sub_box: List[Tuple[int, int, int]] = []
    members = np.full((len(entry_boxes), k), -1, np.int32)
    entry_rows = np.zeros(len(entry_boxes), np.int64)
    for e, (a, wlo, whi) in enumerate(entry_boxes):
        col = A[:, :, a]
        sel = live & (col >= wlo) & (col <= whi)
        nsel = sel.sum(axis=1).astype(np.int64)
        for c in range(k):
            if nsel[c] == live_counts[c]:
                entry_rows[e] += live_counts[c]  # the window covers it all
                continue
            rows = np.nonzero(sel[c])[0].astype(np.int32)
            key = (c, rows.tobytes())
            p = sub_key.get(key)
            if p is None:
                if len(sub_rows) >= max_subs:
                    entry_rows[e] += live_counts[c]  # cap hit: parent scan
                    continue
                p = len(sub_rows)
                sub_key[key] = p
                sub_rows.append(rows)
                sub_parent.append(c)
                sub_box.append((a, wlo, whi))
            members[e, c] = k + p
            entry_rows[e] += int(nsel[c])

    n_subs = len(sub_rows)
    records: List[Dict[str, torch.Tensor]] = []
    vpads = np.zeros(n_subs, np.int32)
    sub_counts = np.zeros(n_subs, np.int32)
    sub_amin = np.full((n_subs, m), ATTR_MAX, np.int16)
    sub_amax = np.full((n_subs, m), ATTR_MIN, np.int16)
    sub_lo = np.full((n_subs, m), ATTR_MIN, np.int16)
    sub_hi = np.full((n_subs, m), ATTR_MAX, np.int16)
    d = index.vectors.shape[-1]
    for p, rows in enumerate(sub_rows):
        c = sub_parent[p]
        n = int(rows.size)
        # aligned, but never taller than the parent (a small index may have
        # Vpad < SUB_ALIGN)
        vp = min(max(_round_up(n, SUB_ALIGN), SUB_ALIGN), vpad)
        vp = max(vp, n, 1)
        rows_t = torch.from_numpy(rows.astype(np.int64)).to(
            index.vectors.device)
        rec = {
            "vectors": torch.zeros((vp, d), dtype=index.vectors.dtype),
            "attrs": torch.zeros((vp, m), dtype=torch.int16),
            "ids": torch.full((vp,), -1, dtype=torch.int32),
        }
        if n:
            rec["vectors"][:n] = index.vectors[c, rows_t].cpu()
            rec["attrs"][:n] = torch.from_numpy(A[c, rows])
            rec["ids"][:n] = torch.from_numpy(ids[c, rows])
            sub_amin[p] = A[c, rows].min(axis=0)
            sub_amax[p] = A[c, rows].max(axis=0)
        for name, src in (("norms", index.norms), ("scales", index.scales)):
            if src is not None:
                col = torch.zeros((vp,), dtype=src.dtype)
                if n:
                    col[:n] = src[c, rows_t].cpu()
                rec[name] = col
        records.append(rec)
        vpads[p] = vp
        sub_counts[p] = n
        a, wlo, whi = sub_box[p]
        sub_lo[p, a] = np.int16(np.clip(wlo, ATTR_MIN, ATTR_MAX))
        sub_hi[p, a] = np.int16(np.clip(whi, ATTR_MIN, ATTR_MAX))

    pred_lo = np.full((len(entry_boxes), m), ATTR_MIN, np.int16)
    pred_hi = np.full((len(entry_boxes), m), ATTR_MAX, np.int16)
    for e, (a, wlo, whi) in enumerate(entry_boxes):
        pred_lo[e, a] = np.int16(np.clip(wlo, ATTR_MIN, ATTR_MAX))
        pred_hi[e, a] = np.int16(np.clip(whi, ATTR_MIN, ATTR_MAX))

    catalog = PartitionCatalog(
        pred_lo=pred_lo, pred_hi=pred_hi, members=members,
        entry_rows=entry_rows, parent=np.asarray(sub_parent, np.int32),
        sub_lo=sub_lo, sub_hi=sub_hi, sub_counts=sub_counts,
        sub_amin=sub_amin, sub_amax=sub_amax, n_base=k)
    return PartitionBuild(catalog=catalog, records=records, vpads=vpads)


def select_sub_rows(attrs_row: np.ndarray, ids_row: np.ndarray, count: int,
                    box_lo: np.ndarray, box_hi: np.ndarray) -> np.ndarray:
    """Slot indices of a cluster's live rows inside a sub's selection box,
    in slot order: the one rule build, resync and compaction share."""
    attrs_row, ids_row = _np(attrs_row), _np(ids_row)
    slot = np.arange(ids_row.shape[0])
    live = (slot < int(count)) & (ids_row >= 0)
    inside = np.all((attrs_row >= box_lo[None, :])
                    & (attrs_row <= box_hi[None, :]), axis=1)
    return np.nonzero(live & inside)[0].astype(np.int32)


def attach(index, build: PartitionBuild):
    """RAM-tier attach: extends the index's per-cluster arrays with the
    sub-partition lists (padded to the parent Vpad, on the index's device)
    and hangs the catalog off the result as ``partitions``.

    The planner reads only rows ``[:n_base]``; sub rows are scan targets,
    so their summary rows are void and their centroids copy the parent's.
    Each field is written once into its extended array on the index's
    device, so the peak holds the old and the new arrays.
    """
    from repro_torch.core import summaries as summaries_lib

    cat = build.catalog
    p = build.n_subs
    if p == 0:
        index.partitions = cat
        return index
    dev = index.vectors.device
    k = index.n_clusters

    def extend(base, key, fill):
        out = torch.empty((k + p,) + tuple(base.shape[1:]), dtype=base.dtype,
                          device=dev)
        out[:k] = base
        out[k:] = fill
        for j, rec in enumerate(build.records):
            rows = rec[key].shape[0]
            out[k + j, :rows] = rec[key].to(dev)
        return out

    parent = torch.from_numpy(cat.parent.astype(np.int64)).to(dev)
    out = dataclasses.replace(
        index,
        centroids=torch.cat([index.centroids, index.centroids[parent]]),
        vectors=extend(index.vectors, "vectors", 0),
        attrs=extend(index.attrs, "attrs", 0),
        ids=extend(index.ids, "ids", -1),
        counts=torch.cat([index.counts, torch.from_numpy(
            cat.sub_counts.astype(np.int32)).to(dev)]),
        norms=(None if index.norms is None
               else extend(index.norms, "norms", 0)),
        scales=(None if index.scales is None
                else extend(index.scales, "scales", 0)),
        summaries=(None if index.summaries is None
                   else summaries_lib.pad_clusters(index.summaries, k + p)),
    )
    out.partitions = cat
    return out
