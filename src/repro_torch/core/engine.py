"""Search execution engine: plan → fetch → scan → merge, both tiers.

The port of ``repro.core.engine``:

    plan   — :func:`plan_fused_tiled` over resident state: centroid top-T,
             filter-aware probe pruning (exact mode, or widened to refill
             pruned probes from the geometric top-``t_max``), the partition
             remap (a routed query's probes swap base clusters for the
             catalog entry's sub-partitions), per-tile probe dedup; with
             ``adaptive_u_cap`` the slot tables are then cut to the
             smallest bucket covering the observed unique counts.  With a
             delta tier, the batch's snapshot is taken here and the planner
             sees its adjusted cluster counts.  With ``termination``, each
             tile's slots are reordered best-bound-first.  On the card the
             plan reads nothing to the host that it does not need to
             enqueue its own work: the filter bounds for the traffic
             recorder and the u_cap cut's unique count are copied without a
             wait and read where they are first needed (after the scan is
             enqueued; before the tables are first used), so ``submit``
             returns with the plan enqueued and batch *i+1*'s plan overlaps
             batch *i*'s scan (:mod:`~repro_torch.core.hostcopy`).
    fetch  — RAM tier: the resident ``[K, Vpad, ...]`` arrays (a no-op).
             Disk tier: the plan's fetch list pages through a
             :mod:`~repro_torch.core.blockstore` store (a local cache, or a
             ``ShardedBlockStore`` ring of peer caches) into batch-local
             blocks with slot-local cluster ids, assembled in pinned host
             memory and copied to the card on a side stream; a per-batch
             *operand cache* pulls each cluster through the store once per
             batch, however many tiles probe it, and a cross-batch
             *device cache* (:mod:`~repro_torch.core.devicecache`) keeps
             hot clusters on the card and composes blocks there.
    scan   — the tiled filtered scan kernel over the slot tables; with
             ``termination``, per tile in slot segments, dropping the
             (query, slot) pairs whose score bound cannot reach the running
             top-k (:meth:`SearchEngine._scan_tile_terminated`).  Over a
             ``ShardedBlockStore`` without a device cache, the sync
             terminated executor fetches each segment right before its scan,
             so a cluster every query has dropped is never fetched.
    merge  — monoid top-k across each query's probes, the l2 constant
             fix-up and the scan accounting (:func:`_scan_merge_tiled`);
             then the delta fold: the RAM delta tier's exact scan merged in
             through the same monoid (tombstoned cold ids are masked in the
             scan's ids operand).

Two executors share those stages and return the same results:

  * **sync** (``pipeline="off"``) — one fetch for the whole batch, one scan
    over all ``n_tiles · u_cap`` slots.
  * **pipelined** (``pipeline="on"``) — while tile *i* scans on the card, a
    worker fetches and assembles tile *i+1*'s clusters and copies them on a
    side stream (``pipeline_depth`` tiles in flight).  ``submit`` /
    ``result`` extend the overlap across batches.

The reference's ``backend`` knob has no counterpart: the port picks the
kernel by the tensors' device.  ``stats.degraded_batches`` counts batches
served while the store routed around an unhealthy peer.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import blockstore as blockstore_lib
from repro_torch.core import probes as probes_lib
from repro_torch.core import summaries as summaries_lib
from repro_torch.core import topk as topk_lib
from repro_torch.core.filters import FilterSpec
from repro_torch.core.hostcopy import DeferredObserver, HostCopy, host_copies
from repro_torch.core.hybrid import ATTR_MAX, ATTR_MIN
from repro_torch.core.ivf import round_up
from repro_torch.core.search import SearchResult, centroid_scores
from repro_torch.core.spans import NO_SPAN, Tracer, render_stage_histograms
from repro_torch.device import resolve_device
from repro_torch.kernels.filtered_scan.filtered_scan import (
    filtered_scan_tiled,
    fold_running_topk,
)


def plan_fused_tiled(centroids: torch.Tensor, counts: torch.Tensor,
                     queries: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     *, metric: str, n_probes: int, q_block: int, u_cap: int,
                     cast_dtype: torch.dtype,
                     summaries: Optional[summaries_lib.ClusterSummaries] = None,
                     t_max: Optional[int] = None,
                     route_entry: Optional[torch.Tensor] = None,
                     members: Optional[torch.Tensor] = None):
    """Plan stage: centroid probe + per-tile dedup over resident state.

    Returns ``(slot_cluster, slot_tile, slot_of_probe, probe_ok, n_unique,
    queries_pad, lo_pad, hi_pad, n_pruned, geo_probes, geo_valid)``;
    queries and bounds come back padded to whole ``q_block`` tiles with
    edge rows.  ``geo_probes``/``geo_valid`` ``[Qpad, n_probes]`` are each
    query's geometric top-``n_probes`` (before widening and pruning): the
    delta tier's membership mask.

    With ``summaries`` the plan drops probes whose cluster provably holds
    no row passing the query's filter (results unchanged).  ``t_max`` (>
    n_probes, with summaries) widens the plan: each query's probes are
    refilled with its next-best unpruned centroids of the geometric
    top-``t_max``, ranked by (centroid score, expected passing rows), so a
    selective filter keeps ``n_probes`` productive probes.  Unfiltered
    queries prune nothing and plan as without ``t_max``.

    ``route_entry [Q]`` (-1 = flat) with ``members [E, K_base]`` (-1 = scan
    the parent) remaps routed queries' probes from base ids to the chosen
    catalog entry's sub-partition ids, after the centroid top-k (sub
    centroids are never scored) and before the per-tile dedup, so sub ids
    flow into the slot tables and fetch lists.  ``geo_probes`` stays
    base-id (the delta tier's membership is over base clusters).
    """
    scores = centroid_scores(centroids, counts, queries, metric=metric)
    q = queries.shape[0]
    if summaries is None:
        cvals, probe_ids = topk_lib.top_k(scores, n_probes)  # [Q, T]
        probe_ids = probe_ids.int()
        geo_ids, geo_ok = probe_ids, cvals > topk_lib.NEG_INF / 2
        probe_valid = None
        n_pruned = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    else:
        cm = summaries_lib.can_match(summaries, lo, hi)  # [Q, K]
        width = n_probes if t_max is None else t_max
        cvals, cand = topk_lib.top_k(scores, width)  # [Q, W] geometric order
        cm_c = torch.gather(cm, 1, cand)
        real = cvals > topk_lib.NEG_INF / 2  # exclude empty clusters
        geo_ids, geo_ok = cand[:, :n_probes].int(), real[:, :n_probes]
        # probes a geometry-only plan would scan that the filter proved empty
        n_pruned = (~cm_c[:, :n_probes] & real[:, :n_probes]).sum(-1).int()
        if t_max is None:
            probe_ids = cand.int()
            probe_valid = cm_c & real
        else:
            # re-rank by (centroid score, expected passing rows): the
            # estimate only breaks exact score ties; keep each query's first
            # n_probes unpruned candidates.  Two stable sorts, the secondary
            # key first: the reference's lexsort order.
            epass = summaries_lib.expected_passing(summaries, lo, hi, counts)
            ep_c = torch.gather(epass, 1, cand)
            order = torch.argsort(-ep_c, dim=1, stable=True)
            order = torch.gather(order, 1, torch.argsort(
                torch.gather(-cvals, 1, order), dim=1, stable=True))
            cand = torch.gather(cand, 1, order)
            ok = torch.gather(cm_c & real, 1, order)
            rank = torch.cumsum(ok.int(), dim=1) - 1
            probe_ids = cand.int()
            probe_valid = ok & (rank < n_probes)
    if members is not None:
        # partition remap: a routed query swaps each probed base cluster for
        # the entry's sub-partition of it (member -1: keep the parent)
        ent = torch.clamp(route_entry, min=0).long()
        sub = members[ent[:, None], probe_ids.long()]  # [Q, W]
        probe_ids = torch.where((route_entry[:, None] >= 0) & (sub >= 0),
                                sub, probe_ids).int()
    probe_pad = probes_lib.pad_to_tiles(probe_ids, q_block)
    valid_pad = (None if probe_valid is None
                 else probes_lib.pad_to_tiles(probe_valid, q_block))
    queries_pad = probes_lib.pad_to_tiles(queries.to(cast_dtype), q_block)
    lo_pad = probes_lib.pad_to_tiles(lo, q_block)
    hi_pad = probes_lib.pad_to_tiles(hi, q_block)
    slot_cluster, slot_tile, slot_of_probe, probe_ok, n_unique = (
        probes_lib.plan_probe_tiles(probe_pad, q_block=q_block, u_cap=u_cap,
                                    probe_valid=valid_pad))
    return (slot_cluster, slot_tile, slot_of_probe, probe_ok, n_unique,
            queries_pad.contiguous(), lo_pad.contiguous(), hi_pad.contiguous(),
            n_pruned, probes_lib.pad_to_tiles(geo_ids, q_block),
            probes_lib.pad_to_tiles(geo_ok, q_block))


def _scan_merge_tiled(
    slot_cluster, slot_tile, slot_of_probe, probe_ok, n_unique,
    queries, queries_pad, lo_pad, hi_pad, vectors, attrs, ids, norms, scales,
    *, metric: str, k: int, q: int, q_block: int, tracer: Tracer,
) -> SearchResult:
    """Scan + merge: scan the planned slots, merge per-probe fragments
    (the spans ``repro.scan`` and ``repro.merge`` of ``tracer``).

    Dedup pad slots are skipped by the scan; the merge never reads one for
    a probe with ``probe_ok`` (a live probe points at a live slot).
    """
    with tracer.span("repro.scan", device=True, stage="scan"):
        svals, sids, snpass = filtered_scan_tiled(
            slot_cluster, slot_tile, n_unique, queries_pad, lo_pad, hi_pad,
            vectors, attrs, ids, norms, scales, metric=metric, k=k,
            q_block=q_block)
    with tracer.span("repro.merge", device=True, stage="merge"):
        # a probe's slot scans exactly its cluster: live rows per probe
        # through the slot tables
        live_per_slot = (ids >= 0).sum(-1)[slot_cluster.long()]  # [S]
        return _merge_fragments(svals, sids, snpass, slot_of_probe,
                                probe_ok, probe_ok, queries, live_per_slot,
                                metric=metric, k=k, q=q, q_block=q_block)


def _merge_fragments(svals, sids, snpass, slot_of_probe, pair_ok, scan_ok,
                     queries, live_per_slot, *, metric: str, k: int, q: int,
                     q_block: int) -> SearchResult:
    """Merge stage: per-probe candidate fragments, then the monoid merge
    across each query's probes, the l2 constant and the scan accounting.

    ``pair_ok [Qpad, W]`` masks the fragments that enter the merge (probes
    that overflowed u_cap or were pruned; in a bound-terminated tile also
    the ε-dropped pairs, whose fragments may exist because another query
    kept the segment, while provably dropped pairs of a scanned segment
    stay in: their rows are strictly below the final kth).  ``scan_ok``
    counts ``n_scanned`` over the slots that were scanned.  ``svals/sids
    [S, QB, k]``, ``snpass [S, QB]`` hold filler where a slot was never
    scanned."""
    sop = slot_of_probe.long()
    row = (torch.arange(sop.shape[0], device=sop.device) % q_block)[:, None]
    vals_qt = torch.where(pair_ok[..., None], svals[sop, row],
                          topk_lib.NEG_INF)  # [Qpad, W, k]
    ids_qt = torch.where(pair_ok[..., None], sids[sop, row], -1)
    npass_qt = torch.where(pair_ok, snpass[sop, row], 0)  # [Qpad, W]
    vals, out_ids = topk_lib.merge_topk_many(vals_qt, ids_qt, k, axis=1)
    vals, out_ids = vals[:q], out_ids[:q]
    if metric == "l2":
        q2 = torch.sum(queries.float() ** 2, -1)
        vals = torch.where(vals > topk_lib.NEG_INF / 2,
                           vals - q2[:q, None], vals)
    n_passed = npass_qt[:q].sum(-1).int()
    n_scanned = (live_per_slot[sop[:q]] * scan_ok[:q]).sum(-1).int()
    return SearchResult(vals, out_ids, n_scanned, n_passed)


def u_cap_buckets(full_cap: int, lo: int = 8,
                  ladder: str = "pow2") -> Tuple[int, ...]:
    """The fixed u_cap bucket set for ``full_cap``: ``(8, 16, 32, ...,
    full_cap)``; ``ladder="fine"`` adds the ×1.5 midpoints."""
    if ladder not in ("pow2", "fine"):
        raise ValueError(f"ladder must be 'pow2'|'fine', got {ladder!r}")
    caps = []
    b = lo
    while b < full_cap:
        caps.append(b)
        if ladder == "fine":
            mid = (b * 3) // 2
            if mid < full_cap:
                caps.append(mid)
        b *= 2
    caps.append(full_cap)
    return tuple(sorted(set(caps)))


def _batch_pass_fraction(summaries, counts, lo, hi) -> torch.Tensor:
    """[Q] expected passing fraction of each query's filter, from the
    resident summaries (the tier-agnostic selectivity estimate)."""
    ep = summaries_lib.expected_passing(summaries, lo, hi, counts)  # [Q, K]
    tot = torch.clamp(counts.float().sum(), min=1.0)
    return ep.sum(1) / tot


# t_max="auto" widening factors over n_probes: powers of two, so a serving
# mix triggers a bounded set of plan widths.
AUTO_T_FACTORS = (2, 4, 8)


def resolve_auto_t_max(summaries, counts, lo, hi, n_probes: int,
                       n_clusters: int,
                       factors: Tuple[int, ...] = AUTO_T_FACTORS
                       ) -> Optional[int]:
    """Per-batch probe widening for ``t_max="auto"``: a batch whose filters
    pass about 1/f of the rows (median over its queries, from the
    summaries' expected passing mass) widens to ``f·n_probes`` for the
    largest factor f it needs; an unfiltered batch returns None (the static
    plan)."""
    if summaries is None:
        return None
    sel = float(np.median(_batch_pass_fraction(summaries, counts, lo,
                                               hi).cpu().numpy()))
    need = 1.0 / max(sel, 1e-9)
    factor = 1
    for f in factors:
        if need >= f:
            factor = f
    if factor == 1:
        return None
    return min(factor * n_probes, n_clusters)


def resolve_t_max(t_max, summaries, counts, lo, hi, n_probes: int,
                  n_clusters: int) -> Optional[int]:
    """The plan width knob as the plan takes it: ``"auto"`` resolved for
    this batch, validated against ``n_probes``, capped at K, and None where
    widening means nothing (no pruning, or no wider than ``n_probes``)."""
    if t_max == "auto":
        t_max = resolve_auto_t_max(summaries, counts, lo, hi, n_probes,
                                   n_clusters)
    if t_max is None:
        return None
    if t_max < n_probes:
        raise ValueError(f"t_max={t_max} < n_probes={n_probes}")
    t_max = min(t_max, n_clusters)
    if summaries is None or t_max == n_probes:
        return None
    return t_max


def resolve_prune(index, prune: str):
    """The summaries to plan with (``"auto"``: iff the index has them;
    ``"on"``: demanded; ``"off"``: never)."""
    summ = getattr(index, "summaries", None)
    if prune == "off":
        return None
    if prune == "on":
        if summ is None:
            raise ValueError("prune='on' but the index has no cluster "
                             "summaries — build with with_summaries=True, "
                             "or use prune='auto'")
        return summ
    if prune == "auto":
        return summ
    raise ValueError(f"prune must be 'auto'|'on'|'off', got {prune!r}")


@dataclasses.dataclass
class TileWork:
    """One query tile's slice of a :class:`SearchPlan` (host-side).

    ``fetch`` is the tile's *novel* cluster list (ids no earlier tile
    needed, in first-need order); ``release`` lists the clusters no *later*
    tile needs, which the per-batch operand cache frees after this tile.
    """

    tile: int
    slot_cluster: np.ndarray  # [u_cap] int32 — global cluster per slot
    n_unique: int             # live slots (the rest are pads)
    fetch: np.ndarray         # novel clusters, first-need order
    release: np.ndarray       # clusters whose last need is this tile


@dataclasses.dataclass
class TermState:
    """Per-batch bound-driven termination state (host-side numpy), built by
    :meth:`SearchEngine._prepare_termination` after the slot tables were
    permuted best-bound-first: every array indexes ``(tile, query-row,
    slot position)`` in scan order.  ``ub`` already carries the rounding
    margin."""

    epsilon: float      # ε-drop threshold (0 in termination="exact")
    seg: int            # slot positions per segment (a multiple of 4)
    n_seg: int          # segments per tile
    cap: int            # true table width (seg · n_seg >= cap)
    ub: np.ndarray      # [n_tiles, QB, cap_pad] f64 — score upper bound
    lb: np.ndarray      # [n_tiles, QB, cap_pad] f64 — rough lower bound
    mass: np.ndarray    # [n_tiles, QB, cap_pad] — expected passing rows
    valid: np.ndarray   # [n_tiles, QB, cap_pad] bool — real (q, slot) pair
    # [Qpad, W] bool, filled by the scan: the probes whose fragments entered
    # each query's merge (the universe a bounded result is exact over)
    kept: Optional[np.ndarray] = None


@dataclasses.dataclass
class SearchPlan:
    """Everything the fetch/scan/merge stages need, produced by plan().

    Slot tables stay on the index's device on the sync RAM path, and come
    to the host as numpy when the executor needs them per tile (pipelined
    mode, disk fetch lists); the scan stage takes either.
    """

    q: int
    q_block: int
    n_tiles: int
    u_cap: int               # provisioned table width (post-bucketing)
    width: int               # probe table width (n_probes)
    slot_cluster: Any        # [n_tiles·u_cap] int32
    slot_tile: Any           # [n_tiles·u_cap] int32
    slot_of_probe: Any       # [Qpad, T] int32
    probe_ok: Any            # [Qpad, T] bool
    n_unique: Any            # [n_tiles] int32
    queries: torch.Tensor    # [Q, D] original (l2 constant)
    # [Qpad, D] original dtype, tile-padded: read by the per-tile executor
    # only, so built lazily (None on sync plans)
    queries_orig_pad: Optional[torch.Tensor]
    queries_pad: torch.Tensor  # [Qpad, D] cast to the scan dtype
    lo_pad: torch.Tensor
    hi_pad: torch.Tensor
    n_pruned: torch.Tensor   # [Q] int32
    # each query's geometric top-n_probes (before widening and pruning):
    # the delta tier's membership mask; set when the batch has a snapshot
    geo_probes: Optional[torch.Tensor] = None  # [Qpad, T] int32
    geo_valid: Optional[torch.Tensor] = None   # [Qpad, T] bool
    # expected per-cluster generation vector at plan time (layout-3 disk
    # tier): every fetch of the batch carries it
    gens: Optional[np.ndarray] = None
    # per-tile work items, built lazily by tile_work()
    tiles: Optional[List[TileWork]] = None
    # per-batch operand cache: (cluster, gen) -> host record, filled as
    # tiles' fetches land, freed after each record's last tile
    operands: Optional[Dict[Tuple[int, int], dict]] = None
    # (cluster, gen) keys counted in blocks_fetched for this batch
    fetched_keys: Optional[set] = None
    # the delta segment as this batch sees it (appends after plan() land
    # in the next batch)
    delta_snap: Any = None
    # per-query catalog entry (-1 = flat); None without an active catalog
    route: Optional[np.ndarray] = None  # [Q] int32
    # bound-driven termination state (None when the knob is off)
    term: Optional[TermState] = None
    # the adaptive u_cap cut's [n_tiles] maximum on its way to the host,
    # where the cut waits until the tables are first used
    # (SearchEngine.provision); None once cut, or where the plan cut them
    u_max: Optional[HostCopy] = None
    # the batch's place in the engine's deferred filter-traffic queue
    traffic_ticket: Optional[int] = None

    def tile_work(self) -> List[TileWork]:
        """Materializes (and caches) the per-tile work items with their
        novel-cluster fetch lists.  Requires host tables."""
        if self.tiles is None:
            sc = np.asarray(self.slot_cluster).reshape(self.n_tiles,
                                                       self.u_cap)
            nu = np.asarray(self.n_unique)
            fetches = probes_lib.tile_fetch_lists(sc, nu, self.u_cap)
            releases = probes_lib.tile_release_lists(sc, nu, self.u_cap)
            self.tiles = [
                TileWork(tile=i, slot_cluster=sc[i], n_unique=int(nu[i]),
                         fetch=fetches[i], release=releases[i])
                for i in range(self.n_tiles)
            ]
        return self.tiles


@dataclasses.dataclass
class PendingSearch:
    """A batch started by :meth:`SearchEngine.submit`: its plan plus any
    tile fetches already in flight.  Finish with
    :meth:`SearchEngine.result`."""

    plan: SearchPlan
    inflight: Optional[Dict] = None


@dataclasses.dataclass
class EngineStats:
    """Per-engine execution counters."""

    batches: int = 0
    pipelined_batches: int = 0
    tiles_scanned: int = 0
    # distinct scan-stage signatures this engine was first to dispatch in
    # the process (the reference's jit-compile count, same keys)
    scan_compilations: int = 0
    # fetch-stage overlap accounting (pipelined disk tier)
    io_wait_s: float = 0.0    # time execute() blocked on a tile's fetch
    io_total_s: float = 0.0   # submit→completion span of every fetch
    last_u_cap: int = 0
    u_cap_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    # BlockStore fetch path accounting
    blocks_fetched: int = 0   # per-cluster blocks pulled through the store
    blocks_reused: int = 0    # slots served from the per-batch operand cache
    # batches completed while the store reported a non-closed peer circuit
    # (the fallback serves the same records, so results do not change)
    degraded_batches: int = 0
    # batches whose result folded a non-empty delta segment
    delta_folds: int = 0
    # batches whose delta scan was skipped because the segment's summary
    # (or its interval envelope) proved no live delta row passes any filter
    delta_skips: int = 0
    # of those, skipped by the per-attribute envelope alone
    delta_interval_skips: int = 0
    # bound-driven termination: (query, slot) pairs dropped before their
    # segment was scanned, and slot segments skipped whole
    probes_terminated: int = 0
    term_segments_skipped: int = 0
    # partition plane: queries routed to a catalog entry, constrained
    # queries no entry subsumes, and cold-scan rows split by route
    partition_hits: int = 0
    partition_fallbacks: int = 0
    partition_rows_scanned: int = 0
    flat_rows_scanned: int = 0
    # plans that read no device value to the host: they return as soon as
    # their work is enqueued (sync_free_plans / batches: the share); the
    # port's own, so metrics_text() alone exports it
    sync_free_plans: int = 0

    @property
    def overlap_ratio(self) -> float:
        """Fraction of fetch time hidden behind compute (1 = fully
        overlapped, 0 = fully serial)."""
        if self.io_total_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self.io_wait_s / self.io_total_s)


def _flatten_metrics(out: Dict[str, Any], prefix: str, obj: Any) -> None:
    """Recursively flattens nested stats into ``prefix.key`` scalar entries
    (dicts recurse; numbers, bools, strings and None pass through; anything
    else is stringified)."""
    if isinstance(obj, dict):
        for key, val in obj.items():
            _flatten_metrics(out, f"{prefix}.{key}", val)
    elif isinstance(obj, (bool, int, float, str)) or obj is None:
        out[prefix] = obj
    elif isinstance(obj, (np.integer, np.floating)):
        out[prefix] = obj.item()
    else:
        out[prefix] = str(obj)


# Metric leaf names that are monotonically increasing counts, rendered as
# Prometheus counters; every other numeric metric is a gauge.
_PROM_COUNTERS = frozenset((
    "batches", "pipelined_batches", "tiles_scanned", "scan_compilations",
    "blocks_fetched", "blocks_reused", "degraded_batches", "hits",
    "misses", "puts", "evictions", "invalidations", "prefetched", "errors",
    "stalled_waits",
    "gets", "blocks", "scan_compile_count", "delta_folds", "delta_skips",
    "delta_interval_skips", "adds", "tombstoned", "commits", "tile_hits",
    "tile_puts", "probes_terminated", "term_segments_skipped",
    "partition_hits", "partition_fallbacks", "partition_rows_scanned",
    "flat_rows_scanned", "sync_free_plans",
))


# EngineStats fields the reference does not have: left out of metrics(),
# whose key set is the reference's, and rendered by metrics_text().
_PORT_ONLY_STATS = ("sync_free_plans",)


def _prom_name(key: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in key)
    return out if not out[:1].isdigit() else f"_{out}"


def render_prometheus(metrics: Dict[str, Any], prefix: str = "repro") -> str:
    """Flat dotted-key metrics → Prometheus text exposition format.

    Dots become underscores (``engine.blocks_fetched`` →
    ``repro_engine_blocks_fetched``); booleans render as 0/1 gauges;
    strings as an info-style labeled sample (``repro_engine_backend{value=
    "cuda"} 1``); None is skipped.
    """
    lines: List[str] = []
    for key in sorted(metrics):
        val = metrics[key]
        if val is None:
            continue
        name = _prom_name(f"{prefix}.{key}")
        leaf = key.rsplit(".", 1)[-1]
        kind = "counter" if leaf in _PROM_COUNTERS else "gauge"
        if isinstance(val, bool):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {int(val)}")
        elif isinstance(val, (int, float)):
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {val}")
        else:
            label = str(val).replace("\\", "\\\\").replace('"', '\\"')
            lines.append(f"# TYPE {name} gauge")
            lines.append(f'{name}{{value="{label}"}} 1')
    return "\n".join(lines) + "\n"


# Process-wide registry of the scan-stage signatures dispatched so far
# (the reference's jit cache is process-wide too).
_SCAN_KEYS: set = set()


def scan_compile_count() -> int:
    """Number of distinct scan-stage signatures this process has run."""
    return len(_SCAN_KEYS)


# Reference knobs without a counterpart: name -> (default, why).
_UNPORTED = {
    "backend": (None, "the port picks the kernel by the tensors' device"),
}


def _reject_unported(knobs: dict):
    for name, value in knobs.items():
        if name not in _UNPORTED:
            raise TypeError(f"SearchEngine got an unexpected keyword {name!r}")
        default, why = _UNPORTED[name]
        if value != default:
            raise NotImplementedError(f"{name}={value!r} is not ported: {why}")


class SearchEngine:
    """The tiled fused search, both tiers, both executors.

    Knobs: ``k``, ``n_probes``, ``q_block`` (query-tile height), ``v_block``
    (accepted for parity with the reference; the CUDA kernel picks its own
    row chunk), ``u_cap`` (pinned slot-table width) or ``adaptive_u_cap``
    (bucketed from the observed unique counts, the default when ``u_cap``
    is None) with ``u_cap_ladder``/``u_cap_bucket_set``, ``prune``, and:

      * ``t_max`` — adaptive probe widening (an int > ``n_probes``, or
        ``"auto"``: per batch from the summaries' expected passing mass);
        needs pruning, else the plan is the static one.
      * ``delta`` — a :class:`~repro_torch.core.delta.DeltaTier` to fold
        into every batch (default: the index's ``delta`` attribute).

      * ``pipeline`` — ``"off"``: one whole-batch fetch and scan;
        ``"on"``: per-tile fetch/scan overlap (same results); ``"auto"``:
        on iff the engine fetches through a store or a gather function.
      * ``pipeline_depth`` — tile fetches kept in flight ahead of the scan.
      * ``operand_cache`` — per-batch reuse of fetched cluster records
        (store path only; ``"auto"``/``"on"``/``"off"``):
        ``blocks_reused`` counts slots served from it.
      * ``device_cache`` — a :class:`~repro_torch.core.devicecache.
        DeviceBlockCache`, or a byte budget to build one (default: the
        index's ``device_cache`` attribute); store path only.  It keeps
        clusters on the card across batches and subsumes the operand
        cache.
      * ``partitions`` — ``"auto"``: route through the index's partition
        catalog when it has one; ``"on"``: demand one; ``"off"``: the flat
        plan.
      * ``termination`` — ``"exact"``: scan each tile's slots
        best-bound-first in segments and drop the (query, slot) pairs whose
        score bound is below the running kth (the same results, fewer slot
        scans); ``"bounded"`` with ``epsilon``: also drop pairs whose
        chance of holding a top-k row is at most ε under the bound model
        (the exact top-k over the surviving probes).

    ``index`` needs the resident surface (``spec / centroids / counts /
    n_clusters / store_dtype / quantized / summaries``) plus one fetch
    source: resident ``vectors/attrs/ids/norms/scales`` (RAM tier), a
    ``blockstore`` (the index's own, or passed explicitly), a
    ``gather_fn``, or the index's ``gather`` method (with
    ``gather_submit``/``gather_wait`` for the async fetch).

    ``device`` must be the index's device; it defaults to CUDA and raises
    when CUDA is absent and the CPU was not asked for.
    """

    def __init__(self, index, *, k: int, n_probes: int,
                 q_block: int = 64, v_block: int = 256,
                 u_cap: Optional[int] = None,
                 gather_fn: Optional[Callable] = None, blockstore=None,
                 prune: str = "auto", pipeline: str = "auto",
                 pipeline_depth: int = 2,
                 adaptive_u_cap: Optional[bool] = None,
                 u_cap_bucket_set: Optional[Tuple[int, ...]] = None,
                 u_cap_ladder: str = "pow2", operand_cache: str = "auto",
                 t_max=None, delta=None, device_cache=None,
                 termination: Optional[str] = None, epsilon: float = 0.0,
                 partitions: str = "auto", device="cuda", **unported):
        _reject_unported(unported)
        if termination not in (None, "exact", "bounded"):
            raise ValueError(f"termination must be None|'exact'|'bounded', "
                             f"got {termination!r}")
        if not 0.0 <= float(epsilon) < 1.0:
            raise ValueError(f"epsilon must be in [0, 1), got {epsilon!r}")
        if epsilon > 0.0 and termination != "bounded":
            raise ValueError("epsilon > 0 requires termination='bounded'")
        if partitions not in ("auto", "on", "off"):
            raise ValueError(f"partitions must be 'auto'|'on'|'off', got "
                             f"{partitions!r}")
        if isinstance(t_max, str) and t_max != "auto":
            raise ValueError(f"t_max must be an int, 'auto' or None, got "
                             f"{t_max!r}")
        self.device = resolve_device(device)
        if index.centroids.device.type != self.device.type:
            raise ValueError(f"index lives on {index.centroids.device}, "
                             f"engine asked for {self.device}")
        if pipeline not in ("auto", "on", "off"):
            raise ValueError(f"pipeline must be 'auto'|'on'|'off', got "
                             f"{pipeline!r}")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if operand_cache not in ("auto", "on", "off"):
            raise ValueError(f"operand_cache must be 'auto'|'on'|'off', got "
                             f"{operand_cache!r}")
        if u_cap_ladder not in ("pow2", "fine"):
            raise ValueError(f"u_cap_ladder must be 'pow2'|'fine', got "
                             f"{u_cap_ladder!r}")
        resolve_prune(index, prune)  # validates the knob
        self.index = index
        self.k = k
        self.n_probes = n_probes
        self.q_block = q_block
        self.v_block = v_block
        self.u_cap = u_cap
        self.prune = prune
        self.t_max = t_max
        self._delta = delta
        self.pipeline_depth = pipeline_depth
        self.u_cap_bucket_set = u_cap_bucket_set
        self.u_cap_ladder = u_cap_ladder
        self.operand_cache = operand_cache
        self.partitions = partitions
        self.termination = termination
        self.epsilon = float(epsilon)
        # filter-traffic recorder and the planner's base-width views and
        # device member table, built on first use
        self._traffic = None
        self._base_memo = None
        self._members_memo = None
        self._bounds_cache = None  # (key, ClusterBounds) lazy-build memo
        self.backend = self.device.type
        # fetch source: an explicit gather_fn wins; otherwise an explicit or
        # index-provided store; otherwise the index's own gather; otherwise
        # the resident arrays (RAM tier)
        self._store = None
        if gather_fn is not None:
            self._gather_fn = gather_fn
        else:
            self._store = (blockstore if blockstore is not None
                           else getattr(index, "blockstore", None))
            self._gather_fn = (self._store_gather if self._store is not None
                               else getattr(index, "gather", None))
        self._bspec = (blockstore_lib.BlockSpec.from_index(index)
                       if self._store is not None else None)
        if operand_cache == "on" and self._store is None:
            raise ValueError("operand_cache='on' needs a BlockStore fetch "
                             "path (disk tier or explicit blockstore=)")
        # cross-batch device cache: an explicit instance or byte budget
        # wins, else the index's attached one
        dc = (device_cache if device_cache is not None
              else getattr(index, "device_cache", None))
        if dc is not None and self._store is None:
            raise ValueError("device_cache needs a BlockStore fetch path "
                             "(disk tier or explicit blockstore=)")
        if isinstance(dc, (int, float)):
            from repro_torch.core.devicecache import DeviceBlockCache

            heat = getattr(getattr(index, "cache", None), "probe_heat", None)
            dc = DeviceBlockCache(self._bspec, int(dc), heat_fn=heat,
                                  device=self.device)
        self._device_cache = dc
        # async pair available iff the source IS the index's own gather
        self._async_src = (
            index if (self._store is None and self._gather_fn is not None
                      and getattr(index, "gather_submit", None) is not None
                      and self._gather_fn == index.gather)
            else None)
        self.pipeline = (pipeline if pipeline != "auto"
                         else ("on" if self._gather_fn is not None else "off"))
        self.adaptive_u_cap = (
            (u_cap is None) if adaptive_u_cap is None else adaptive_u_cap)
        if self.adaptive_u_cap and u_cap is not None:
            raise ValueError("u_cap and adaptive_u_cap are exclusive")
        self._pool: Optional[ThreadPoolExecutor] = None
        # spans, host-read counters and the per-stage latency histograms
        # (appended to metrics_text()); tracing off until enabled
        self.tracer = Tracer(self.device)
        self.stats = EngineStats()
        # on the card a copy to the host is asynchronous: the plan starts
        # the reads it does not need to enqueue its own work and leaves
        # them to where their values are first needed
        self._defer_reads = self.device.type == "cuda"
        self._observations = DeferredObserver(
            self._observe_traffic,
            lambda: self.tracer.host_read("result.traffic"))

    def tracing(self):
        """A context with the engine's tracing on (:mod:`~repro_torch.core.
        spans`); ``self.tracer.summary()`` reads what it recorded."""
        return self.tracer.tracing()

    def _dev(self, x):
        """A table or operand on the engine's device (None passes)."""
        return None if x is None else torch.as_tensor(x, device=self.device)

    def _delta_tier(self):
        return self._delta if self._delta is not None else getattr(
            self.index, "delta", None)

    # ---- partition routing (plan side) ----
    def _resolve_partitions(self):
        """The catalog to route with (``"auto"``: the index's, if any;
        ``"on"``: demanded; ``"off"``: None, the flat plan)."""
        cat = getattr(self.index, "partitions", None)
        if self.partitions == "off":
            return None
        if self.partitions == "on" and cat is None:
            raise ValueError(
                "partitions='on' but the index has no partition catalog — "
                "save the checkpoint with layout 4 (save_index(partitions="
                "build_partitions(...))) or use partitions='auto'")
        return cat

    def _n_base(self) -> int:
        """The planner's cluster count: the base clusters of a partitioned
        index (its sub rows are scan targets only)."""
        cat = getattr(self.index, "partitions", None)
        return cat.n_base if cat is not None else self.index.n_clusters

    def _base_views(self, cat, summ):
        """Base-width views of centroids, counts and summaries.  A RAM index
        with attached subs carries them inline; planning over them would
        probe duplicated sub centroids, so the planner slices to
        ``[:n_base]``, memoized until the arrays are swapped."""
        index = self.index
        cents = index.centroids
        nb = cat.n_base
        if cents.shape[0] == nb:
            return cents, index.counts, summ
        memo = self._base_memo
        if memo is None or memo[0] is not cents:
            base_summ = None
            if index.summaries is not None:
                base_summ = dataclasses.replace(
                    index.summaries, amin=index.summaries.amin[:nb],
                    amax=index.summaries.amax[:nb],
                    hist=index.summaries.hist[:nb])
            memo = self._base_memo = (cents, cents[:nb], index.counts[:nb],
                                      base_summ)
        return memo[1], memo[2], (memo[3] if summ is not None else None)

    def _members_device(self, cat):
        """The catalog's ``[E, K_base]`` member table on the index's device,
        memoized per catalog."""
        memo = self._members_memo
        if memo is None or memo[0] is not cat:
            memo = self._members_memo = (cat, torch.from_numpy(
                np.asarray(cat.members, np.int32)).to(
                    self.index.centroids.device))
        return memo[1]

    def _route_partitions(self, cat, fspec: FilterSpec):
        """Host-side narrowest-subsuming-entry routing and traffic
        recording.  Returns ``(route, route_entry, members, ticket)``: the
        [Q] entry per query (-1 = flat) and the plan's remap operands, None
        where no query routes (the flat plan), and the batch's ticket in
        the deferred traffic queue (None where it was observed here).

        Without a catalog, bounds on the engine's device are copied to the
        host without a wait, and the recorder sees them after the batch's
        scan is enqueued (:meth:`_finish`); a catalog routes on them here."""
        if (cat is None and self._defer_reads
                and all(isinstance(x, torch.Tensor)
                        and x.device.type == self.device.type
                        for x in (fspec.lo, fspec.hi))):
            ticket = None
            if self.partitions != "off":
                ticket = self._observations.put(
                    host_copies((fspec.lo, fspec.hi)))
            return None, None, None, ticket
        with self.tracer.host_read("plan.route.lo"):
            lo_np = probes_lib._host(fspec.lo)
        with self.tracer.host_read("plan.route.hi"):
            hi_np = probes_lib._host(fspec.hi)
        if self.partitions != "off":
            self._observe_traffic(lo_np, hi_np)
        if cat is None:
            return None, None, None, None
        route = cat.route(lo_np, hi_np)
        hits = int(np.sum(route >= 0))
        self.stats.partition_hits += hits
        # fallbacks: queries that constrain some attribute but that no entry
        # subsumes (an unfiltered query's layout is simply the flat one)
        nonvoid = np.all(lo_np <= hi_np, axis=-1)  # [Q, T]
        narrowed = np.any((lo_np > ATTR_MIN) | (hi_np < ATTR_MAX), axis=-1)
        constrained = np.any(nonvoid & narrowed, axis=-1)
        self.stats.partition_fallbacks += int(np.sum(constrained
                                                     & (route < 0)))
        if hits == 0:
            return route, None, None, None
        dev = self.index.centroids.device
        return (route, torch.from_numpy(route).to(dev),
                self._members_device(cat), None)

    def _observe_traffic(self, lo_np, hi_np):
        if self._traffic is None:
            from repro_torch.core.partitions import FilterTrafficRecorder

            self._traffic = FilterTrafficRecorder(int(lo_np.shape[-1]))
        self._traffic.observe(lo_np, hi_np)

    @property
    def traffic(self):
        """The engine's filter-traffic recorder (the partition builder's
        attribute-choice input), with every planned batch observed; None
        until a batch was planned."""
        self._observations.drain()
        return self._traffic

    # ---- plan ----
    def plan(self, queries, fspec: FilterSpec) -> SearchPlan:
        """Plans at the sound worst-case table width; with
        ``adaptive_u_cap`` the tables are then cut to a bucket (on the card
        where the sync executor first uses them: :meth:`provision`).  The
        tables come to the host when the executor needs them per tile.  A
        plan that reads nothing to the host counts in
        ``stats.sync_free_plans``."""
        reads = self.tracer.reads
        n_read = sum(reads.values())
        with self.tracer.span("repro.plan", stage="plan"):
            plan = self._plan(queries, fspec)
        if sum(reads.values()) == n_read:
            self.stats.sync_free_plans += 1
        return plan

    def _plan(self, queries, fspec: FilterSpec) -> SearchPlan:
        tr = self.tracer
        index = self.index
        dev = index.centroids.device
        queries = torch.as_tensor(queries, device=dev)
        lo = torch.as_tensor(fspec.lo, device=dev)
        hi = torch.as_tensor(fspec.hi, device=dev)
        q = queries.shape[0]
        qb = min(self.q_block, round_up(q, 8))
        summ = resolve_prune(index, self.prune)
        # probing geometry runs over the base clusters: sub ids enter only
        # through the plan's remap, and a RAM index with attached subs is
        # planned over its base rows even with routing off
        cat = self._resolve_partitions()
        cat_any = getattr(index, "partitions", None)
        centroids, counts, kc = index.centroids, index.counts, index.n_clusters
        if cat_any is not None:
            kc = cat_any.n_base
            centroids, counts, summ = self._base_views(cat_any, summ)
        with tr.span("repro.plan.route"):
            route, route_entry, members, ticket = self._route_partitions(
                cat, fspec)
        # the batch's view of the delta segment; the planner sees the counts
        # a rebuild would (centroid_scores masks empty clusters by count)
        tier = self._delta_tier()
        snap = tier.snapshot() if tier is not None else None
        if snap is not None:
            adj = tier.count_adjustment(kc)
            if adj is not None:
                counts = counts + torch.from_numpy(adj).to(dev)
        with (tr.host_read("plan.t_max")
              if self.t_max == "auto" and summ is not None else NO_SPAN):
            t_max = resolve_t_max(self.t_max, summ, counts, lo, hi,
                                  self.n_probes, kc)
        width = self.n_probes if t_max is None else t_max
        # remapped probes draw from base and sub ids, so a tile's unique
        # count can exceed the base cluster count
        k_total = kc + (cat.n_subs if cat is not None else 0)
        full_cap = min(qb * width, k_total)
        cap = full_cap if self.u_cap is None else self.u_cap
        cast_dtype = torch.float32 if index.quantized else index.store_dtype
        with tr.span("repro.plan.tiles", device=True):
            (slot_cluster, slot_tile, slot_of_probe, probe_ok, n_unique,
             queries_pad, lo_pad, hi_pad, n_pruned, geo_probes,
             geo_valid) = plan_fused_tiled(
                centroids, counts, queries, lo, hi,
                metric=index.spec.metric, n_probes=self.n_probes,
                q_block=qb, u_cap=cap, cast_dtype=cast_dtype, summaries=summ,
                t_max=t_max, route_entry=route_entry, members=members)
        plan = SearchPlan(
            q=q, q_block=qb, n_tiles=queries_pad.shape[0] // qb, u_cap=cap,
            width=width, slot_cluster=slot_cluster,
            slot_tile=slot_tile, slot_of_probe=slot_of_probe,
            probe_ok=probe_ok, n_unique=n_unique, queries=queries,
            queries_orig_pad=(probes_lib.pad_to_tiles(queries, qb)
                              if self.pipeline == "on" else None),
            queries_pad=queries_pad, lo_pad=lo_pad, hi_pad=hi_pad,
            n_pruned=n_pruned, gens=self._plan_gens(),
            geo_probes=geo_probes if snap is not None else None,
            geo_valid=geo_valid if snap is not None else None,
            delta_snap=snap, route=route, traffic_ticket=ticket,
        )
        host_tables = (self.pipeline == "on" or self._gather_fn is not None
                       or self.termination is not None)
        if self.adaptive_u_cap:
            with tr.span("repro.plan.provision"):
                if (self._defer_reads and not host_tables
                        and self.t_max != "auto"):
                    # the cut's value is read where the tables are first
                    # used (provision): the plan does not wait for it
                    plan.u_max = host_copies((plan.n_unique.max(),))
                else:
                    self._provision(plan)
        if host_tables:
            self._host_tables(plan)
        if self.termination is not None:
            # reorders the slot tables best-bound-first before any fetch
            # list exists, so fetches follow the scan order
            self._prepare_termination(plan, summ, counts)
        if plan.u_max is None:
            self._note_u_cap(plan)
        return plan

    def _note_u_cap(self, plan: SearchPlan):
        self.stats.last_u_cap = plan.u_cap
        self.stats.u_cap_hist[plan.u_cap] = (
            self.stats.u_cap_hist.get(plan.u_cap, 0) + 1)

    def _plan_gens(self) -> Optional[np.ndarray]:
        """Per-cluster expected generations for this batch's fetches (None
        on a RAM index: every gen is implicitly 0)."""
        g = getattr(self.index, "gens", None)
        return None if g is None else np.asarray(g)

    def _host_tables(self, plan: SearchPlan):
        with self.tracer.host_read("plan.tables"):
            for name in ("slot_cluster", "slot_tile", "slot_of_probe",
                         "probe_ok", "n_unique"):
                t = getattr(plan, name)
                if isinstance(t, torch.Tensor):
                    setattr(plan, name, t.cpu().numpy())

    def provision(self, plan: SearchPlan):
        """Applies a plan's deferred u_cap cut: reads the unique count the
        plan copied to the host without a wait (site ``result.provision``)
        and cuts the tables as a plan-time cut would.  A no-op where the
        plan cut them itself or the cut was applied; :meth:`fetch` and
        :meth:`scan_merge` call it before they use the tables."""
        u_max = plan.u_max
        if u_max is None:
            return
        plan.u_max = None
        with self.tracer.host_read("result.provision"):
            max_u = int(u_max.wait()[0])
        self._cut(plan, max_u)
        self._note_u_cap(plan)

    def _provision(self, plan: SearchPlan):
        """Adaptive u_cap at plan time: reads the [n_tiles] counts'
        maximum on the host, then :meth:`_cut`."""
        with self.tracer.host_read("plan.provision"):
            max_u = int(plan.n_unique.max())
        self._cut(plan, max_u)

    def _cut(self, plan: SearchPlan, max_u: int):
        """Cuts the slot tables to the smallest bucket covering every
        tile's unique count ``max_u`` (only pad slots are cut, so results
        are unchanged)."""
        full = plan.u_cap
        max_u = max(max_u, 1)
        buckets = self.u_cap_bucket_set or u_cap_buckets(
            full, ladder=self.u_cap_ladder)
        bucket = next((b for b in sorted(buckets) if b >= max_u), full)
        bucket = min(bucket, full)
        if bucket == full:
            return
        plan.slot_cluster = (plan.slot_cluster.reshape(plan.n_tiles, full)
                             [:, :bucket].reshape(-1))
        plan.slot_tile = torch.repeat_interleave(
            torch.arange(plan.n_tiles, dtype=torch.int32,
                         device=plan.slot_tile.device), bucket)
        # re-base flat probe→slot pointers from stride `full` to `bucket`;
        # overflow-clipped pointers of not-ok probes stay in range
        t_idx = torch.div(plan.slot_of_probe, full, rounding_mode="floor")
        s = plan.slot_of_probe - t_idx * full
        plan.slot_of_probe = (t_idx * bucket
                              + torch.clamp(s, max=bucket - 1)).int()
        plan.u_cap = bucket

    # ---- bound-driven termination (plan side) ----
    def _resolve_bounds(self):
        """The per-cluster score bounds: the index's own (the disk tier's
        ``storage.load_bounds``), else built from the resident flat lists
        and memoized until the arrays are swapped."""
        index = self.index
        b = getattr(index, "bounds", None)
        if b is not None:
            return b
        vectors = getattr(index, "vectors", None)
        if vectors is None:
            raise ValueError(
                "termination needs per-cluster score bounds, but the index "
                "has neither a `bounds` attribute nor resident vectors to "
                "build them from; re-save the checkpoint (save_index writes "
                "bounds_radius.npy / bounds_slack.npy)")
        scales = getattr(index, "scales", None)
        cached = self._bounds_cache
        if (cached is not None and cached[0] is vectors
                and cached[1] is scales):
            return cached[2]
        b = summaries_lib.build_bounds(index.centroids, vectors, index.ids,
                                       getattr(index, "norms", None), scales)
        self._bounds_cache = (vectors, scales, b)
        return b

    def _prepare_termination(self, plan: SearchPlan, summ, counts):
        """Builds the batch's :class:`TermState` and reorders each tile's
        slots best-bound-first (host-side numpy, f64 where it matters).

        Per (query, slot) pair the upper bound on any row's kernel-space
        score comes from resident state only: the centroid product plus a
        Cauchy-Schwarz ``‖q‖·radius`` term (dot), or ``‖q‖² − max(d −
        radius, 0)²`` shifted by the cluster's norm slack (l2, before the
        ``‖q‖²`` fix-up), over the cast queries the kernel scores, widened
        by a dtype-aware rounding margin.  Routed slots hold sub ids: they
        are bounded by their parent's row (a sub holds a subset of its
        parent's rows under the same centroid).
        """
        index = self.index
        qb, cap, n_tiles = plan.q_block, plan.u_cap, plan.n_tiles
        qpad = qb * n_tiles
        bounds = self._resolve_bounds()
        sc = np.asarray(plan.slot_cluster).reshape(n_tiles, cap)
        cat = self._resolve_partitions()
        if cat is not None:
            sc = cat.to_base(sc)

        # which (tile, query row, slot) pairs are real probes
        sop = np.asarray(plan.slot_of_probe)
        pok = np.asarray(plan.probe_ok)
        tt, ss = np.divmod(sop, cap)
        qi = np.broadcast_to((np.arange(qpad, dtype=np.int32) % qb)[:, None],
                             sop.shape)
        valid = np.zeros((n_tiles, qb, cap), bool)
        valid[tt[pok], qi[pok], ss[pok]] = True

        l2 = index.spec.metric == "l2"
        with self.tracer.host_read("term.prepare"):
            qt = plan.queries_pad.float().cpu().numpy().reshape(n_tiles, qb,
                                                                -1)
            C = index.centroids.float().cpu().numpy()
            radius = bounds.radius.float().cpu().numpy()
            slack = bounds.slack.float().cpu().numpy() if l2 else None
            # the ε model's mass: expected passing rows of the pair's
            # cluster under the query's filter (live counts without
            # summaries)
            if summ is not None:
                ep = summaries_lib.expected_passing(
                    summ, plan.lo_pad, plan.hi_pad, counts).cpu().numpy()
            else:
                cnt = counts.float().cpu().numpy()
        csel = C[sc]  # [n_tiles, cap, D]
        rsel = radius[sc][:, None, :]
        if not l2:
            cs = np.einsum("tqd,tsd->tqs", qt, csel)
            qn = np.linalg.norm(qt, axis=-1)[:, :, None]
            ub = cs + qn * rsel
            lb = cs - qn * rsel
        else:  # l2: kernel space 2q·x − norms_row
            qt64 = qt.astype(np.float64)
            c64 = csel.astype(np.float64)
            # ‖q − c‖ in f64: the expanded form cancels in f32 when q ≈ c,
            # and an over-estimated d would break the upper bound
            cs64 = np.einsum("tqd,tsd->tqs", qt64, c64)
            q2 = np.sum(qt64 * qt64, axis=-1)[:, :, None]
            c2 = np.sum(c64 * c64, axis=-1)[:, None, :]
            d = np.sqrt(np.maximum(q2 - 2.0 * cs64 + c2, 0.0))
            near = np.maximum(d - rsel, 0.0)
            ssel = slack[sc][:, None, :]
            ub = q2 - near * near + ssel
            lb = q2 - (d + rsel) ** 2
        # rounding margin: the kernel accumulates in f32 from operands that
        # may be 16-bit
        itemsize = torch.tensor([], dtype=index.store_dtype).element_size()
        tol = 1e-2 if (not index.quantized and itemsize == 2) else 1e-4
        # f64 state: the ε model subtracts the running kth (NEG_INF while a
        # query's list is not full), which overflows in f32
        ub = ub.astype(np.float64) + (1e-3 + tol * np.abs(ub))
        lb = lb.astype(np.float64)

        if summ is not None:
            mass = np.take_along_axis(ep.reshape(n_tiles, qb, -1),
                                      sc[:, None, :], axis=2)
        else:
            mass = np.broadcast_to(cnt[sc][:, None, :],
                                   (n_tiles, qb, cap)).copy()

        # best-bound-first: each tile's live slots by descending max-over-
        # queries upper bound; probe pointers remapped, state co-permuted
        slot_bound = np.where(valid, ub, -np.inf).max(axis=1)
        plan.slot_cluster, plan.slot_of_probe, perm = probes_lib.bound_order(
            plan.slot_cluster, plan.n_unique, plan.slot_of_probe, slot_bound,
            cap)
        pq = perm[:, None, :]
        ub = np.take_along_axis(ub, pq, axis=2)
        lb = np.take_along_axis(lb, pq, axis=2)
        mass = np.take_along_axis(mass, pq, axis=2)
        valid = np.take_along_axis(valid, pq, axis=2)

        # about 4 segments a tile, widths a multiple of 4, so the segment
        # shapes come from a bounded set
        seg = max(4, ((-(-cap // 4) + 3) // 4) * 4)
        n_seg = -(-cap // seg)
        cap_pad = n_seg * seg
        if cap_pad > cap:
            padw = ((0, 0), (0, 0), (0, cap_pad - cap))
            ub = np.pad(ub, padw, constant_values=-np.inf)
            lb = np.pad(lb, padw, constant_values=-np.inf)
            mass = np.pad(mass, padw, constant_values=0.0)
            valid = np.pad(valid, padw, constant_values=False)
        plan.term = TermState(
            epsilon=self.epsilon if self.termination == "bounded" else 0.0,
            seg=seg, n_seg=n_seg, cap=cap, ub=ub, lb=lb, mass=mass,
            valid=valid, kept=np.zeros(np.shape(plan.probe_ok), bool))

    # ---- fetch ----
    @property
    def blockstore(self):
        """The store the fetch stage routes through (None when the engine
        reads resident arrays or a gather function)."""
        return self._store

    @property
    def _use_operand_cache(self) -> bool:
        return self._store is not None and self.operand_cache != "off"

    @property
    def device_cache(self):
        """The cross-batch device block cache (None when off)."""
        return self._device_cache

    def _note_device_hits(self, n: int):
        """Tells a store that counts them how many blocks the device cache
        served (fetches that never happened)."""
        note = getattr(self._store, "note_device_hits", None)
        if n > 0 and note is not None:
            note(n)

    def _count_fetched(self, plan: Optional[SearchPlan], cids):
        """``blocks_fetched`` on the operand-cache path: each distinct
        ``(cluster, gen)`` block counts once per batch, even when a gap
        fallback re-pulls a block an earlier tile fetched."""
        if plan is None:
            self.stats.blocks_fetched += len(cids)
            return
        if plan.fetched_keys is None:
            plan.fetched_keys = set()
        gens = plan.gens
        for c in cids:
            cid = int(c)
            key = (cid, int(gens[cid]) if gens is not None else 0)
            if key not in plan.fetched_keys:
                plan.fetched_keys.add(key)
                self.stats.blocks_fetched += 1

    def _store_gather(self, slot_cluster, gens: Optional[np.ndarray] = None,
                      plan: Optional[SearchPlan] = None):
        """Whole-list gather through the store (the sync executor's fetch
        stage); each fetched cluster carries its expected generation."""
        flat = np.asarray(slot_cluster).reshape(-1)
        uniq, local = blockstore_lib.first_need_unique(flat)
        if self._device_cache is not None:
            return self._device_gather(flat, uniq, local, gens, plan=plan)
        recs = self._store.get(uniq, gens=None if gens is None else gens[uniq])
        self.stats.blocks_fetched += len(recs)
        return blockstore_lib.assemble_blocks(
            flat, uniq, local, recs, self._bspec, as_device=True,
            device=self.device)

    def _device_gather(self, flat, uniq, local, gens,
                       plan: Optional[SearchPlan] = None):
        """Device-cache-aware gather: resident clusters come straight from
        the device cache (no read, no host assembly, no copy); only the
        misses cross the store and the bus, once, and are admitted.  The
        blocks are composed on the card."""
        dc = self._device_cache
        egens = None if gens is None else gens[uniq]
        s = flat.shape[0]
        tile = dc.get_tile(uniq, s, egens)
        if tile is not None:  # an exact repeat: the composed blocks
            self._note_device_hits(len(uniq))
            self.stats.blocks_reused += len(uniq)
            return dc.handoff(local, tile)
        hits, missing = dc.get_many(uniq, egens)
        self._note_device_hits(len(hits))
        self.stats.blocks_reused += len(hits)
        if missing:
            marr = np.asarray(missing, np.int64)
            recs = self._store.get(marr,
                                   gens=None if gens is None else gens[marr])
            self._count_fetched(plan, recs)
            hits.update(dc.put_records(recs))
        entries = [hits[int(c)] for c in uniq]
        blocks = dc.compose(entries)
        dc.put_tile(uniq, s, entries, blocks)
        return dc.handoff(local, blocks)

    def _expected_gens(self, plan: SearchPlan, cids) -> Optional[np.ndarray]:
        """Expected generations for a fetch list, from the plan's vector."""
        if plan.gens is None:
            return None
        return plan.gens[np.asarray(cids, np.int64)]

    def fetch(self, plan: SearchPlan):
        """Whole-batch fetch stage (sync executor): the resident arrays on
        the RAM tier, one gather over the plan's slot list otherwise."""
        self.provision(plan)
        index = self.index
        if self._gather_fn is None:
            return (self._dev(plan.slot_cluster), index.vectors, index.attrs,
                    index.ids, index.norms, index.scales)
        with self.tracer.span("repro.fetch", stage="fetch"):
            if (self._store is not None
                    and self._gather_fn == self._store_gather):
                out = self._store_gather(plan.slot_cluster, gens=plan.gens,
                                         plan=plan)
            else:
                out = self._gather_fn(plan.slot_cluster)
            return tuple(self._dev(a)
                         for a in blockstore_lib.wait_blocks(out))

    # ---- scan + merge ----
    def _count_scan(self, key: Tuple):
        if key not in _SCAN_KEYS:
            _SCAN_KEYS.add(key)
            self.stats.scan_compilations += 1

    def _scan_key(self, plan: SearchPlan, *, q: int, qpad: int, s: int,
                  q_block: int, vectors, norms, scales) -> Tuple:
        """The reference's scan signature: statics and operand shapes.
        Gathered operands count as the reference's ``[S, Vpad, D]`` blocks
        (the port allocates one row per distinct cluster instead)."""
        rows = s if self._gather_fn is not None else vectors.shape[0]
        return (
            self.backend, self.index.spec.metric, self.k, q, q_block,
            self.v_block, s, qpad, plan.width,
            (rows,) + tuple(vectors.shape[1:]), str(vectors.dtype),
            str(plan.queries_pad.dtype), tuple(plan.lo_pad.shape[1:]),
            norms is None, scales is None,
        )

    def _mask_tombstones(self, plan: SearchPlan, ids):
        """Masks the snapshot's tombstoned ids out of the cold scan's ids
        operand (not the merged result), so the scan's top-k surfaces the
        next live candidate, as a rebuild without the deleted rows would."""
        snap = plan.delta_snap
        if snap is None or snap.tombstones is None:
            return ids
        from repro_torch.core import delta as delta_lib

        return delta_lib.mask_tombstones(ids, snap.tombstones.to(ids.device))

    def _fold_delta(self, plan: SearchPlan, res: SearchResult) -> SearchResult:
        """Merge stage, tier two: the delta segment's exact scan folded into
        the cold result through the same top-k monoid (cold wins ties, as
        the concat order of a rebuilt index's merge).  Skipped, with only
        the reach count added to ``n_scanned``, where the segment's
        interval envelope or its summary proves no filter can match."""
        snap = plan.delta_snap
        if snap is None or snap.n_rows == 0:
            return res
        with self.tracer.span("repro.delta_fold", stage="delta_fold"):
            return self._fold_snapshot(plan, snap, res)

    def _fold_snapshot(self, plan: SearchPlan, snap,
                       res: SearchResult) -> SearchResult:
        from repro_torch.core import delta as delta_lib

        q, kc = plan.q, self._n_base()
        tr = self.tracer

        def skipped(count_reach=True):
            self.stats.delta_skips += 1
            if not count_reach:
                return res
            dscan = delta_lib.snapshot_reach(snap, plan.geo_probes,
                                             plan.geo_valid, kc)
            return dataclasses.replace(
                res, n_scanned=res.n_scanned + dscan[:q])

        # per-attribute envelope pre-test: every non-void term disjoint
        # from the segment's [M] lo/hi envelope on some attribute
        if snap.attr_lo is not None and snap.attr_hi is not None:
            lo, hi = plan.lo_pad, plan.hi_pad
            alo = torch.from_numpy(snap.attr_lo).to(lo.device)
            ahi = torch.from_numpy(snap.attr_hi).to(lo.device)
            nonvoid = (lo <= hi).all(-1)  # [Qpad, F]
            overlap = ((lo <= ahi) & (hi >= alo)).all(-1)
            with tr.host_read("delta.envelope"):
                any_overlap = bool((nonvoid & overlap).any())
            if not any_overlap:
                self.stats.delta_interval_skips += 1
                return skipped()
        summ = delta_lib.snapshot_summary(snap)
        if summ is None:  # no live rows: the reach is zero
            return skipped(count_reach=False)
        with tr.host_read("delta.can_match"):
            any_match = bool(summaries_lib.can_match(summ, plan.lo_pad,
                                                     plan.hi_pad).any())
        if not any_match:
            return skipped()
        dvals, dids, dscan, dpass = delta_lib.scan_snapshot(
            snap, plan.queries, plan.queries_pad, plan.lo_pad, plan.hi_pad,
            plan.geo_probes, plan.geo_valid, metric=self.index.spec.metric,
            k=self.k, n_clusters=kc)
        vals, out_ids = topk_lib.merge_topk(
            (res.scores, res.ids), (dvals[:q], dids[:q]), self.k)
        self.stats.delta_folds += 1
        return dataclasses.replace(
            res, scores=vals, ids=out_ids,
            n_scanned=res.n_scanned + dscan[:q],
            n_passed=res.n_passed + dpass[:q])

    def scan_merge(self, plan: SearchPlan, operands) -> SearchResult:
        """Whole-batch scan/merge over fetched operands (sync executor)."""
        self.provision(plan)
        slot_cluster, vectors, attrs, ids, norms, scales = operands
        ids = self._mask_tombstones(plan, ids)
        self._count_scan(self._scan_key(
            plan, q=plan.q, qpad=plan.n_tiles * plan.q_block,
            s=plan.n_tiles * plan.u_cap, q_block=plan.q_block,
            vectors=vectors, norms=norms, scales=scales))
        res = _scan_merge_tiled(
            slot_cluster, self._dev(plan.slot_tile),
            self._dev(plan.slot_of_probe), self._dev(plan.probe_ok),
            self._dev(plan.n_unique), plan.queries, plan.queries_pad,
            plan.lo_pad, plan.hi_pad, vectors, attrs, ids, norms, scales,
            metric=self.index.spec.metric, k=self.k, q=plan.q,
            q_block=plan.q_block, tracer=self.tracer)
        return dataclasses.replace(res, n_pruned=plan.n_pruned)

    def _scan_tile(self, plan: SearchPlan, i: int, operands) -> SearchResult:
        """Scan/merge one query tile (pipelined executor): the whole-batch
        stage on one tile, with the tile's own unique count and a zero
        ``slot_tile``; per-slot arithmetic is the same, so tile results
        concatenate to the sync result."""
        slot_cluster, vectors, attrs, ids, norms, scales = operands
        ids = self._mask_tombstones(plan, ids)
        qb, cap = plan.q_block, plan.u_cap
        if plan.queries_orig_pad is None:  # plan was built for a sync run
            plan.queries_orig_pad = probes_lib.pad_to_tiles(plan.queries, qb)
        rows = slice(i * qb, (i + 1) * qb)
        sop = np.asarray(plan.slot_of_probe[rows]) - i * cap  # tile-local
        self._count_scan(self._scan_key(
            plan, q=qb, qpad=qb, s=cap, q_block=qb,
            vectors=vectors, norms=norms, scales=scales))
        return _scan_merge_tiled(
            slot_cluster,
            torch.zeros((cap,), dtype=torch.int32, device=self.device),
            self._dev(sop), self._dev(plan.probe_ok[rows]),
            self._dev(plan.n_unique[i:i + 1]),
            plan.queries_orig_pad[rows], plan.queries_pad[rows],
            plan.lo_pad[rows], plan.hi_pad[rows],
            vectors, attrs, ids, norms, scales,
            metric=self.index.spec.metric, k=self.k, q=qb, q_block=qb,
            tracer=self.tracer)

    def _fetch_segment(self, plan: SearchPlan, seg_sc: np.ndarray,
                       alive_seg: np.ndarray, ops: Dict[int, dict]):
        """Per-segment fetch of the sharded terminated executor.

        The segment's clusters not in the batch-scoped ``ops`` cache are
        fetched through the ring, minus those whose every (query, probe)
        pair is already dead at the boundary (``alive=``: the store drops
        them before the per-owner split and counts ``fetches_skipped``).
        Those are scanned as 1-row all-dead :func:`~repro_torch.core.
        blockstore.dead_record` stand-ins (every row masked, and the
        batch's row height stays the tallest live record's) and are not
        cached, so a later tile where they are alive fetches them.  Every
        candidate a skipped cluster could hold is below the final kth, so
        results stay exact.  Returns the segment's blocks, assembled in
        pinned memory and copied to the card on a side stream."""
        spec = self._bspec
        uniq, local = blockstore_lib.first_need_unique(seg_sc)
        slot_alive = alive_seg.any(axis=0)  # [seg]
        cid_alive = np.zeros(len(uniq), bool)
        np.logical_or.at(cid_alive, local, slot_alive)
        need = np.asarray([j for j, c in enumerate(uniq) if int(c) not in ops],
                          np.int64)
        if need.size:
            need_ids = uniq[need]
            recs = self._store.get(
                need_ids, gens=self._expected_gens(plan, need_ids),
                alive=cid_alive[need])
            self._count_fetched(plan, recs)
            for c, r in recs.items():
                ops[int(c)] = r
        dead = None
        view = {}
        for c in uniq:
            r = ops.get(int(c))
            if r is None:  # skipped this segment: an all-dead stand-in
                if dead is None:
                    dead = blockstore_lib.dead_record(spec)
                r = dead
            view[int(c)] = r
        return blockstore_lib.assemble_blocks(
            seg_sc, uniq, local, view, spec, as_device=True,
            device=self.device)

    def _scan_tile_terminated(self, plan: SearchPlan, i: int, operands,
                              block_rows: int,
                              ops: Optional[Dict[int, dict]] = None
                              ) -> SearchResult:
        """Bound-driven scan of one query tile: its slots in best-bound-first
        segments, the running top-k folded on the card after each, and at
        each boundary the remaining (query, slot) pairs dropped whose upper
        bound is below the query's running kth (provably out: the kth only
        rises) or, in ε mode at the first boundary, whose chance of holding
        a top-k row is at most ε.  A segment no live pair needs is not
        scanned.  Per-slot fragments do not depend on which slots share a
        launch, so ``termination="exact"`` reproduces the untruncated scan.

        ``operands`` are the tile's ``(slot rows, vectors, attrs, ids,
        norms, scales)``; ``block_rows`` is the row count the reference's
        operand blocks have (the scan-signature count).  ``operands=None``
        runs the *segmented-fetch* mode (sharded ring): each scanned
        segment's clusters are fetched right before its scan through
        :meth:`_fetch_segment`, so boundary drops shrink the remote fetch
        lists; ``ops`` is the batch-scoped record cache, and ``n_scanned``
        counts only the rows actually fetched.
        """
        tr = self.tracer
        term = plan.term
        qb, cap, k = plan.q_block, plan.u_cap, self.k
        seg, n_seg = term.seg, term.n_seg
        cap_pad = n_seg * seg
        metric = self.index.spec.metric
        dev = self.device
        if plan.queries_orig_pad is None:
            plan.queries_orig_pad = probes_lib.pad_to_tiles(plan.queries, qb)
        rows = slice(i * qb, (i + 1) * qb)
        sop = np.asarray(plan.slot_of_probe[rows]) - i * cap
        pok = np.asarray(plan.probe_ok[rows])
        q_pad, lo_pad, hi_pad = (plan.queries_pad[rows], plan.lo_pad[rows],
                                 plan.hi_pad[rows])
        segmented = operands is None
        if segmented:
            sc = np.asarray(plan.slot_cluster).reshape(
                plan.n_tiles, cap)[i].astype(np.int64)
        else:
            slot_rows, vectors, attrs, ids, norms, scales = operands
            ids = self._mask_tombstones(plan, ids)
            with tr.host_read("term.slot_rows"):
                sc = probes_lib._host(slot_rows).reshape(-1).astype(np.int32)
        # pad to the segmented width by repeating the last slot (a pad
        # position holds no valid pair, so it is never scanned)
        if cap_pad > cap:
            sc = np.concatenate([sc, np.repeat(sc[-1:], cap_pad - cap)])
        u = int(np.asarray(plan.n_unique)[i])
        if segmented:
            # filled per scanned segment from the rows actually fetched
            live_per_slot = torch.zeros((cap_pad,), dtype=torch.int64,
                                        device=dev)
        else:
            sc_dev = torch.from_numpy(sc).to(dev)
            live_per_slot = (ids >= 0).sum(-1)[sc_dev.long()]  # [cap_pad]
        zeros_tile = torch.zeros((seg,), dtype=torch.int32, device=dev)

        alive = term.valid[i].copy()  # [qb, cap_pad]
        eps_dropped = np.zeros((qb, cap_pad), bool)
        scanned = np.zeros((n_seg,), bool)
        run_vals = torch.full((qb, k), topk_lib.NEG_INF, dtype=torch.float32,
                              device=dev)
        run_ids = torch.full((qb, k), -1, dtype=torch.int32, device=dev)
        frags: List[Optional[Tuple]] = []
        for si in range(n_seg):
            p0, p1 = si * seg, (si + 1) * seg
            alive_seg = alive[:, p0:p1]
            if not alive_seg.any():
                self.stats.term_segments_skipped += 1
                frags.append(None)
            else:
                scanned[si] = True
                if segmented:
                    with tr.span("repro.fetch", stage="fetch"):
                        blocks = blockstore_lib.wait_blocks(
                            self._fetch_segment(plan, sc[p0:p1], alive_seg,
                                                ops))
                        seg_rows, vectors, attrs, ids, norms, scales = (
                            self._dev(a) for a in blocks)
                    ids = self._mask_tombstones(plan, ids)
                    live_per_slot[p0:p1] = (ids >= 0).sum(-1)[seg_rows.long()]
                    scan_sc = seg_rows
                else:
                    scan_sc = sc_dev[p0:p1]
                self._count_scan((
                    "term", self.backend, metric, k, qb, self.v_block, seg,
                    (block_rows,) + tuple(vectors.shape[1:]),
                    str(vectors.dtype), str(q_pad.dtype),
                    tuple(lo_pad.shape[1:]), norms is None, scales is None))
                # the segment's dedup pads (positions >= u) are skipped
                n_live = torch.tensor([min(max(u - p0, 0), seg)],
                                      dtype=torch.int32, device=dev)
                with tr.span("repro.scan", device=True, stage="scan"):
                    svals, sids, snpass = filtered_scan_tiled(
                        scan_sc, zeros_tile, n_live, q_pad, lo_pad, hi_pad,
                        vectors, attrs, ids, norms, scales, metric=metric,
                        k=k, q_block=qb)
                    run_vals, run_ids = fold_running_topk(
                        run_vals, run_ids, svals, sids,
                        torch.from_numpy(alive_seg).to(dev), k=k)
                frags.append((svals, sids, snpass))
            if si + 1 >= n_seg:
                break
            # boundary: the remaining pairs' bounds against the running kth
            # (one host sync per boundary)
            with tr.host_read("term.kth"):
                kth = run_vals[:, k - 1].double().cpu().numpy()
            kth_real = kth > topk_lib.NEG_INF / 2
            rest = np.s_[:, p1:]
            drop = (alive[rest] & kth_real[:, None]
                    & (term.ub[i][rest] < kth[:, None]))
            if si == 0 and term.epsilon > 0.0:
                # the ε decision is made once, at the first boundary, from an
                # ε-independent kth: a higher ε drops a superset of a lower
                # ε's pairs, so recall is monotone in ε
                ub_r, lb_r = term.ub[i][rest], term.lb[i][rest]
                p_hit = np.clip((ub_r - kth[:, None])
                                / np.maximum(ub_r - lb_r, 1e-12), 0.0, 1.0)
                p_hit = np.where(kth_real[:, None], p_hit, 1.0)
                p_any = 1.0 - np.power(
                    1.0 - np.minimum(p_hit, 1.0 - 1e-12), term.mass[i][rest])
                edrop = alive[rest] & (p_any <= term.epsilon)
                eps_dropped[rest] |= edrop
                drop = drop | edrop
            self.stats.probes_terminated += int(drop.sum())
            alive[rest] &= ~drop
        # never-scanned segments contribute all-masked filler fragments
        filler = None
        for si in range(n_seg):
            if frags[si] is None:
                if filler is None:
                    filler = (
                        torch.full((seg, qb, k), topk_lib.NEG_INF,
                                   dtype=torch.float32, device=dev),
                        torch.full((seg, qb, k), -1, dtype=torch.int32,
                                   device=dev),
                        torch.zeros((seg, qb), dtype=torch.int32, device=dev))
                frags[si] = filler
        # a probe's fragments enter the merge iff its segment was scanned
        # and it was not ε-dropped
        scanned_pos = np.repeat(scanned, seg)
        qi = np.broadcast_to(np.arange(qb)[:, None], sop.shape)
        scan_ok = pok & scanned_pos[sop]
        pair_ok = scan_ok & ~eps_dropped[qi, sop]
        term.kept[rows] = pair_ok
        with tr.span("repro.merge", device=True, stage="merge"):
            svals_all, sids_all, snpass_all = (
                torch.cat([f[j] for f in frags]) for j in range(3))
            return _merge_fragments(
                svals_all, sids_all, snpass_all, self._dev(sop),
                self._dev(pair_ok), self._dev(scan_ok),
                plan.queries_orig_pad[rows], live_per_slot, metric=metric,
                k=k, q=qb, q_block=qb)

    def _execute_terminated_sync(self, plan: SearchPlan) -> SearchResult:
        """Sync executor with termination: one whole-batch fetch, then per
        tile the segmented scan (its decisions need the tile's running
        kth).  Over a sharded ring without a device cache, the segmented
        fetch instead (:meth:`_execute_terminated_segmented`)."""
        if (self._device_cache is None and isinstance(
                self._store, blockstore_lib.ShardedBlockStore)):
            return self._execute_terminated_segmented(plan)
        operands = self.fetch(plan)
        with self.tracer.host_read("term.slot_rows"):
            slot_rows = probes_lib._host(operands[0]).reshape(plan.n_tiles,
                                                              plan.u_cap)
        rows = (plan.n_tiles * plan.u_cap if self._gather_fn is not None
                else operands[1].shape[0])
        parts: List[SearchResult] = []
        for i in range(plan.n_tiles):
            parts.append(self._scan_tile_terminated(
                plan, i, (slot_rows[i],) + tuple(operands[1:]), rows))
            self.stats.tiles_scanned += 1
        return self._merge_parts(plan, parts)

    def _execute_terminated_segmented(self, plan: SearchPlan
                                      ) -> SearchResult:
        """Terminated executor over a sharded ring: a fetch per scanned
        segment in place of one whole-batch gather, so a cluster every
        query has dropped at a segment boundary is never dispatched to its
        owner (``StoreStats.fetches_skipped``).  Scores and ids stay
        exact; ``n_scanned`` counts only the rows actually fetched."""
        ops: Dict[int, dict] = {}
        parts: List[SearchResult] = []
        for i in range(plan.n_tiles):
            # a segment's blocks hold one row per slot in the reference
            parts.append(self._scan_tile_terminated(
                plan, i, None, plan.term.seg, ops=ops))
            self.stats.tiles_scanned += 1
        return self._merge_parts(plan, parts)

    def _note_partition_rows(self, plan: SearchPlan, res: SearchResult):
        """Splits the batch's cold-scan rows by route (partition or flat):
        the partition plane's effectiveness gauge.  No host sync without
        an active catalog."""
        if plan.route is None:
            return
        with self.tracer.host_read("result.partition_rows"):
            ns = res.n_scanned.cpu().numpy()
        hit = plan.route >= 0
        self.stats.partition_rows_scanned += int(ns[hit].sum())
        self.stats.flat_rows_scanned += int(ns[~hit].sum())

    def _sync_batch(self, plan: SearchPlan) -> SearchResult:
        if plan.term is not None:
            return self._execute_terminated_sync(plan)
        return self.scan_merge(plan, self.fetch(plan))

    # ---- executors ----
    def execute(self, plan: SearchPlan) -> SearchResult:
        self.stats.batches += 1
        if self.pipeline == "on":
            res = self._execute_pipelined(plan)
        else:
            res = self._sync_batch(plan)
        return self._finish(plan, res)

    def _finish(self, plan: SearchPlan, res: SearchResult) -> SearchResult:
        """The batch's tail once its scan and merge are enqueued: the
        partition rows, the delta fold, and the traffic recorder fed the
        batch's filter bounds if its plan left them on their way."""
        self._note_partition_rows(plan, res)
        res = self._fold_delta(plan, res)
        self._note_degraded()
        if plan.traffic_ticket is not None:
            self._observations.drain(upto=plan.traffic_ticket)
        return res

    def _note_degraded(self):
        """Counts batches served while the fetch store was routing around
        an unhealthy peer (failover keeps results the same, so this counter
        is its only visible trace)."""
        if self._store is not None and getattr(self._store, "degraded",
                                               False):
            self.stats.degraded_batches += 1

    def submit(self, queries, fspec: FilterSpec) -> PendingSearch:
        """Starts a batch: plans it and (pipelined, with a fetch source)
        launches its first ``pipeline_depth`` tile fetches at once, so that
        batch *i+1*'s clusters page in behind batch *i*'s scan.  Finish
        with :meth:`result`."""
        plan = self.plan(queries, fspec)
        self.stats.batches += 1
        if self.pipeline != "on" or self._gather_fn is None:
            return PendingSearch(plan=plan, inflight=None)
        depth = min(self.pipeline_depth, plan.n_tiles)
        return PendingSearch(plan=plan,
                             inflight=self._start_inflight(plan, depth))

    def result(self, pending: PendingSearch) -> SearchResult:
        """Finishes a :meth:`submit`-started batch (scan + merge)."""
        plan = pending.plan
        if pending.inflight is not None:
            res = self._run_tiles(plan, pending.inflight)
        elif self.pipeline == "on":
            res = self._execute_pipelined(plan)
        else:
            res = self._sync_batch(plan)
        return self._finish(plan, res)

    def _tile_operands(self, plan: SearchPlan, i: int):
        """RAM-tier per-tile operands: the resident arrays and the tile's
        global slot ids."""
        index = self.index
        sc = plan.slot_cluster.reshape(plan.n_tiles, plan.u_cap)[i]
        return (self._dev(sc), index.vectors, index.attrs, index.ids,
                index.norms, index.scales)

    def _ensure_pool(self) -> ThreadPoolExecutor:
        """The engine's single fetch/assembly worker: tasks run strictly in
        submission order, keeping per-tile waits aligned with submits."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="engine-fetch")
        return self._pool

    def _start_inflight(self, plan: SearchPlan, depth: int) -> Dict:
        """Prepares a pipelined batch (operand cache and per-tile novel
        fetch lists on the store path) and launches the first ``depth``
        tile fetches.  The device cache subsumes the operand cache: the
        per-tile novel lists still bound what crosses the store, and reuse
        within and across batches rides the device entries."""
        if self._device_cache is not None:
            plan.tile_work()
        elif self._use_operand_cache:
            plan.operands = {}
            plan.tile_work()
        return {i: self._submit(plan, i) for i in range(depth)}

    def _assemble_tile(self, plan: SearchPlan, i: int, h_store):
        """Engine-worker half of the store fetch: wait for the store's
        records, merge them into the batch operand cache (when on), assemble
        tile *i*'s blocks and copy them to the card on a side stream, all
        off the scan thread.  With the operand cache, a cluster several
        tiles share crosses the store once per batch (``blocks_reused``)."""
        recs = self._store.wait(h_store)
        if self._device_cache is not None or plan.operands is not None:
            self._count_fetched(plan, recs)
        else:
            self.stats.blocks_fetched += len(recs)
        sc = plan.slot_cluster.reshape(plan.n_tiles, plan.u_cap)[i]
        uniq, local = blockstore_lib.first_need_unique(sc)
        if self._device_cache is not None:
            return self._assemble_tile_device(plan, uniq, local, recs,
                                              sc.shape[0])
        if plan.operands is None:
            return blockstore_lib.assemble_blocks(
                sc, uniq, local, recs, self._bspec, as_device=True,
                device=self.device)
        gens = plan.gens

        def gkey(c):
            cid = int(c)
            return (cid, int(gens[cid]) if gens is not None else 0)

        ops = plan.operands
        for c, r in recs.items():
            ops[gkey(c)] = r
        # fetch lists and slot tables always agree; a gap is fetched inline
        # rather than scanned stale
        missing = [int(c) for c in uniq if gkey(c) not in ops]
        if missing:
            more = self._store.get(np.asarray(missing, np.int64),
                                   gens=self._expected_gens(plan, missing))
            self._count_fetched(plan, more)
            for c, r in more.items():
                ops[gkey(c)] = r
        self.stats.blocks_reused += max(len(uniq) - len(recs) - len(missing),
                                        0)
        view = {int(c): ops[gkey(c)] for c in uniq}
        out = blockstore_lib.assemble_blocks(
            sc, uniq, local, view, self._bspec, as_device=True,
            device=self.device)
        # free records whose last consuming tile is this one
        if plan.tiles is not None:
            for c in plan.tiles[i].release:
                ops.pop(gkey(c), None)
        return out

    def _assemble_tile_device(self, plan: SearchPlan, uniq, local, recs,
                              s: int):
        """Device-cache half of :meth:`_assemble_tile`: the tile's blocks are
        composed on the card from resident entries plus this tile's
        fetches, which cross to the card once and are admitted.  An entry
        evicted between submit and assembly is fetched again inline, never
        scanned stale."""
        dc = self._device_cache
        egens = self._expected_gens(plan, uniq)
        tile = dc.get_tile(uniq, s, egens)
        if tile is not None:  # an exact repeat: the composed blocks
            self._note_device_hits(len(uniq))
            self.stats.blocks_reused += len(uniq)
            dc.put_records(recs)  # admit this tile's fetches regardless
            return dc.handoff(local, tile)
        hits, missing = dc.get_many(uniq, egens)
        self._note_device_hits(len(hits))
        self.stats.blocks_reused += len(hits)
        entries = dict(hits)
        entries.update(dc.put_records(recs))
        gap = [c for c in missing if c not in entries]
        if gap:
            more = self._store.get(np.asarray(gap, np.int64),
                                   gens=self._expected_gens(plan, gap))
            self._count_fetched(plan, more)
            entries.update(dc.put_records(more))
        ordered = [entries[int(c)] for c in uniq]
        blocks = dc.compose(ordered)
        dc.put_tile(uniq, s, ordered, blocks)
        return dc.handoff(local, blocks)

    def _submit(self, plan: SearchPlan, i: int):
        """Starts tile *i*'s fetch; returns (handle, t_submit, done_box).
        The handle yields tile *i*'s blocks for :func:`wait_blocks`."""
        t0 = time.monotonic()
        done = [None]  # completion timestamp, set by the done-callback
        sc = plan.slot_cluster.reshape(plan.n_tiles, plan.u_cap)[i]
        if self._store is not None:
            if self._device_cache is not None:
                # this tile's novel clusters that are not on the card (a
                # peek: an entry evicted before assembly is fetched there)
                novel = plan.tile_work()[i].fetch
                fetch_ids = self._device_cache.filter_missing(
                    novel, self._expected_gens(plan, novel))
            elif self._use_operand_cache:
                # only clusters no earlier tile of this batch needed
                fetch_ids = plan.tile_work()[i].fetch
            else:
                fetch_ids, _ = blockstore_lib.first_need_unique(sc)
            h_store = self._store.submit(
                fetch_ids, gens=self._expected_gens(plan, fetch_ids))
            h = self._ensure_pool().submit(self._assemble_tile, plan, i,
                                           h_store)
        elif self._async_src is not None:
            h = self._async_src.gather_submit(sc)
        else:
            # a plain gather_fn runs on the engine's worker, so its IO
            # still overlaps the scan
            h = self._ensure_pool().submit(self._gather_fn, sc)
        h.add_done_callback(lambda _: done.__setitem__(0, time.monotonic()))
        return h, t0, done

    def _wait(self, handle_rec):
        handle, t_submit, done = handle_rec
        t0 = time.monotonic()
        with self.tracer.span("repro.fetch"):
            if self._async_src is not None:
                out = self._async_src.gather_wait(handle)
            else:
                out = handle.result()
        t1 = time.monotonic()
        self.stats.io_wait_s += t1 - t0
        self.tracer.observe_stage("fetch", t1 - t0)
        # submit→completion span: a fetch that finished long before this
        # wait counts its own duration (the callback may lag result() by a
        # beat; then t1 stands in)
        t_done = done[0] if done[0] is not None else t1
        self.stats.io_total_s += max(t_done - t_submit, 0.0)
        return tuple(self._dev(a) for a in blockstore_lib.wait_blocks(out))

    def _execute_pipelined(self, plan: SearchPlan) -> SearchResult:
        """Double-buffered executor: scan tile *i* while tiles
        *i+1 … i+depth* are fetched.  The RAM tier runs per-tile scans over
        the resident arrays.  A single-tile batch with a fetch source has
        nothing to overlap with and takes the sync path (cross-batch
        overlap comes from :meth:`submit`/:meth:`result`)."""
        if plan.n_tiles < 2 and self._gather_fn is not None:
            return self._sync_batch(plan)
        if self._gather_fn is None:
            self.stats.pipelined_batches += 1
            parts = []
            for i in range(plan.n_tiles):
                parts.append(self._scan_one(plan, i,
                                            self._tile_operands(plan, i)))
                self.stats.tiles_scanned += 1
            return self._merge_parts(plan, parts)
        depth = min(self.pipeline_depth, plan.n_tiles)
        return self._run_tiles(plan, self._start_inflight(plan, depth))

    def _run_tiles(self, plan: SearchPlan, inflight: Dict) -> SearchResult:
        """Drains a pipelined batch: wait for tile i's fetch, keep
        ``depth`` fetches in flight, scan, concatenate.  On a failure the
        remaining handles are still waited (their errors dropped), so the
        cache ends consistent, then the first error propagates."""
        self.stats.pipelined_batches += 1
        n = plan.n_tiles
        depth = max(len(inflight), 1)
        parts: List[SearchResult] = []
        try:
            for i in range(n):
                operands = self._wait(inflight.pop(i))
                if i + depth < n:
                    inflight[i + depth] = self._submit(plan, i + depth)
                parts.append(self._scan_one(plan, i, operands))
                self.stats.tiles_scanned += 1
        except BaseException:
            for handle_rec in inflight.values():
                try:
                    handle_rec[0].result()
                except BaseException:
                    pass
            raise
        return self._merge_parts(plan, parts)

    def _scan_one(self, plan: SearchPlan, i: int, operands) -> SearchResult:
        """One tile of the pipelined executor, terminated or not."""
        if plan.term is None:
            return self._scan_tile(plan, i, operands)
        rows = (plan.u_cap if self._gather_fn is not None
                else operands[1].shape[0])
        return self._scan_tile_terminated(plan, i, operands, rows)

    def _merge_parts(self, plan: SearchPlan,
                     parts: List[SearchResult]) -> SearchResult:
        with self.tracer.span("repro.merge", device=True, stage="merge"):
            res = SearchResult(
                *(torch.cat([getattr(p, f) for p in parts])[: plan.q]
                  for f in ("scores", "ids", "n_scanned", "n_passed")))
        return dataclasses.replace(res, n_pruned=plan.n_pruned)

    def search(self, queries, fspec: FilterSpec) -> SearchResult:
        return self.execute(self.plan(queries, fspec))

    def refresh(self) -> bool:
        """Flips the engine to the latest published generation, strictly
        between batches: reopens the store's reader, reloads the index's
        resident state and commits any pending delta freeze (the index's
        ``refresh`` does), then drops the device cache's entries of exactly
        the rewritten clusters.  Gen-keyed host caches need no flush.
        Returns True when a new generation was picked up."""
        if self._store is not None:
            store_refresh = getattr(self._store, "refresh", None)
            if store_refresh is not None:
                store_refresh()
        idx_refresh = getattr(self.index, "refresh", None)
        changed = bool(idx_refresh()) if idx_refresh is not None else False
        if self._device_cache is not None:
            # the new generation vector names exactly the rewritten
            # clusters: only their device entries drop
            gens = self._plan_gens()
            if gens is not None:
                self._device_cache.invalidate_below(gens)
        return changed

    # ---- observability ----
    def metrics(self) -> Dict[str, Any]:
        """One flat dict of engine, store, cache, device-cache, delta,
        partition and filter-traffic counters under the reference's dotted
        keys (``engine.batches``, ``store.hits``, ``device_cache.hits``,
        ``partitions.subs``, ...), scalar values only."""
        out: Dict[str, Any] = {}
        eng = dataclasses.asdict(self.stats)
        for key in _PORT_ONLY_STATS:
            del eng[key]
        eng["overlap_ratio"] = self.stats.overlap_ratio
        eng["pipeline"] = self.pipeline
        eng["backend"] = self.backend
        eng["scan_compile_count"] = scan_compile_count()
        _flatten_metrics(out, "engine", eng)
        if self._store is not None:
            store_stats = getattr(self._store, "stats", None)
            if callable(store_stats):
                _flatten_metrics(out, "store", store_stats())
        cache = getattr(self.index, "cache", None)
        cstats = getattr(cache, "stats", None) if cache is not None else None
        if cstats is not None:
            c = dataclasses.asdict(cstats)
            c["hit_rate"] = cache.hit_rate
            _flatten_metrics(out, "cache", c)
        if self._device_cache is not None:
            _flatten_metrics(out, "device_cache", self._device_cache.stats())
        tier = self._delta_tier()
        if tier is not None:
            _flatten_metrics(out, "delta", tier.stats())
        cat = getattr(self.index, "partitions", None)
        if cat is not None:
            _flatten_metrics(out, "partitions", dict(
                entries=cat.n_entries, subs=cat.n_subs,
                catalog_bytes=cat.nbytes()))
        if self.traffic is not None:
            _flatten_metrics(out, "filter_traffic", self._traffic.stats())
        return out

    def metrics_text(self) -> str:
        """:meth:`metrics` in Prometheus text exposition format, plus the
        port's own engine counters, the per-stage latency histograms, the
        host-read counters and the span totals (:mod:`~repro_torch.core.
        spans`)."""
        port = {f"engine.{key}": getattr(self.stats, key)
                for key in _PORT_ONLY_STATS}
        return (render_prometheus(self.metrics())
                + render_prometheus(port)
                + render_stage_histograms(self.tracer.stages)
                + self.tracer.render())

    def close(self):
        self._observations.drain()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def search_fused_tiled(index, queries, fspec: FilterSpec, *, k: int,
                       n_probes: int, q_block: int = 64, v_block: int = 256,
                       u_cap: Optional[int] = None, gather_fn=None,
                       blockstore=None, prune: str = "auto",
                       pipeline: str = "off", pipeline_depth: int = 2,
                       adaptive_u_cap: bool = False,
                       u_cap_ladder: str = "pow2",
                       operand_cache: str = "auto", t_max=None, delta=None,
                       termination: Optional[str] = None,
                       epsilon: float = 0.0, partitions: str = "auto",
                       device="cuda", **unported) -> SearchResult:
    """Query-tiled, probe-deduplicated fused search: a one-batch
    :class:`SearchEngine` (same contract as ``search_reference``)."""
    eng = SearchEngine(
        index, k=k, n_probes=n_probes, q_block=q_block, v_block=v_block,
        u_cap=u_cap, gather_fn=gather_fn, blockstore=blockstore, prune=prune,
        pipeline=pipeline, pipeline_depth=pipeline_depth,
        adaptive_u_cap=adaptive_u_cap, u_cap_ladder=u_cap_ladder,
        operand_cache=operand_cache, t_max=t_max, delta=delta,
        termination=termination, epsilon=epsilon, partitions=partitions,
        device=device, **unported)
    try:
        return eng.search(queries, fspec)
    finally:
        eng.close()
