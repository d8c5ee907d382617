"""Sharded filtered search: probe dispatch, each shard's scan + merge and
the tree merge over a mesh — the port of ``repro.core.distributed``.

Sharding model (the reference's): the index's cluster axis is range-sharded
over S shards, shard ``s`` owning clusters ``[s·K/S, (s+1)·K/S)``; queries,
centroids, summaries and filters are replicated.  A probe (q, t) is owned by
exactly one shard.  Dispatch sorts the probes by owner, ranks them within
their owner and scatters them into a static ``[S, P_cap]`` slot table; probes
past ``P_cap`` are counted, not silently lost (``SearchResult.n_scanned``
carries the count).  Each shard scans its slots — per probe (``backend=
"pallas"``), or deduplicated per (query tile, cluster) with a streaming
top-k (``"pallas_tiled"``) — and folds them into a per-query top-k; the
shards' answers are then merged.

A shard is one rank of a ``torch.distributed`` process group laid out as a
:class:`~torch.distributed.device_mesh.DeviceMesh`
(:mod:`repro_torch.launch.mesh`).  The search is SPMD: every rank calls it
with the same replicated inputs and its own ``[K/S, Vpad, D]`` slice of the
index (:func:`local_shard`, or ``storage.load_index_shard`` from a
checkpoint); every rank computes the same slot table and takes its own row;
the per-rank top-k is tree-merged by all-gathers of ``[Q, k]`` over the mesh
axes in reverse (``model → data → pod``), so every rank ends with the
answer.  Without a mesh the search is the one-shard case: the merge is one
``masked_topk`` over the shard's own k entries and needs no process group.

Straggler mitigation: the merge is a monoid, so ``shard_ok`` drops a
shard's contribution and the result stays a valid, lower-recall answer.
:func:`lead` and :func:`follow` drive the ranks from one controller, the
counterpart of JAX's single-controller call: rank 0 broadcasts each batch
(with its ``shard_ok``) to the other ranks, which wait in a follow loop, so
a ``SearchServer`` on rank 0 serves the sharded search.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import probes as probes_lib
from repro_torch.core import summaries as summaries_lib
from repro_torch.core import topk as topk_lib
from repro_torch.core.blockstore import RangeOwnership
from repro_torch.core.engine import resolve_prune
from repro_torch.core.filters import FilterSpec
from repro_torch.core.ivf import IVFFlatIndex, round_up
from repro_torch.core.search import SearchResult
from repro_torch.device import resolve_device
from repro_torch.kernels.centroid_topk.ops import probe_centroids
from repro_torch.kernels.filtered_scan.filtered_scan import (
    filtered_scan,
    filtered_scan_tiled,
)

# The reference's names for the two scans; its interpret-mode and XLA
# backends have no counterpart, since here the tensors' device picks the
# route (CPU: plain PyTorch, CUDA: the kernels).
BACKENDS = ("pallas", "pallas_tiled")
NEG_INF = topk_lib.NEG_INF


def probe_capacity(q: int, t: int, n_shards: int, slack: float = 2.0) -> int:
    """Static P_cap: expected load × slack, multiple of 8, at least 8."""
    expect = (q * t + n_shards - 1) // n_shards
    cap = int(expect * slack) + 1
    return max(8, ((cap + 7) // 8) * 8)


def _scatter_drop(shape, rows, cols, values, fill=0):
    """``full(shape, fill).at[rows, cols].set(values, mode="drop")``: rows
    whose destination lies outside ``shape`` land in a spare row and
    column that are cut off (no host sync, unlike boolean indexing)."""
    r, c = shape[:2]
    out = torch.full((r + 1, c + 1) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    keep = (rows >= 0) & (rows < r) & (cols >= 0) & (cols < c)
    out[torch.where(keep, rows, r), torch.where(keep, cols, c)] = values
    return out[:r, :c].contiguous()


def dispatch_probes(probe_ids: torch.Tensor, *, n_shards: int, k_local: int,
                    p_cap: int, probe_valid: Optional[torch.Tensor] = None,
                    ownership=None):
    """Builds the probe slot table (the same on every shard).

    Args:
      probe_ids: [Q, T] global cluster ids.
      n_shards: S, shards holding the index.
      k_local: clusters per shard (K/S, contiguous ranges).
      p_cap: static per-shard slot capacity.
      probe_valid: optional [Q, T] bool — probes the filter-aware planner
        pruned go to a sentinel owner past every shard: they take no slot,
        are never scanned and never count as overflow.
      ownership: optional map with ``owner_of``/``local_of`` (default
        :class:`RangeOwnership` ``(n_shards, k_local)``).

    Returns:
      slot_cluster [S, P_cap] int32 — local cluster id per slot (0 for pads),
      slot_query   [S, P_cap] int32 — query row per slot (0 for pads),
      slot_valid   [S, P_cap] bool,
      n_overflowed scalar int32 — live probes dropped by capacity.
    """
    if ownership is None:
        ownership = RangeOwnership(n_shards, k_local)
    q, t = probe_ids.shape
    dev = probe_ids.device
    flat = probe_ids.reshape(-1).long()
    owner = ownership.owner_of(flat)
    local = ownership.local_of(flat)
    query = torch.repeat_interleave(torch.arange(q, device=dev), t)
    if probe_valid is not None:
        # the sentinel owner sorts after every shard; its rows are dropped
        owner = torch.where(probe_valid.reshape(-1), owner, n_shards)

    order = torch.argsort(owner, stable=True)
    owner_s = owner[order]
    starts = torch.searchsorted(owner_s, torch.arange(n_shards + 1, device=dev))
    rank = torch.arange(q * t, device=dev) - starts[owner_s.clamp(0, n_shards)]

    shape = (n_shards, p_cap)
    sc = _scatter_drop(shape, owner_s, rank, local[order].int())
    sq = _scatter_drop(shape, owner_s, rank, query[order].int())
    sv = _scatter_drop(shape, owner_s, rank,
                       torch.ones_like(owner_s, dtype=torch.bool))
    n_overflowed = ((rank >= p_cap) & (owner_s < n_shards)).sum().int()
    return sc, sq, sv, n_overflowed


def dispatch_probes_tiled(probe_ids: torch.Tensor, *, n_shards: int,
                          k_local: int, p_cap: int, u_cap: int, q_block: int,
                          probe_valid: Optional[torch.Tensor] = None,
                          ownership=None):
    """Probe dispatch plus per-shard (query tile, cluster) deduplication.

    Per shard, the valid probes are deduplicated by ``(query_tile,
    local_cluster)``, so a cluster probed by many queries of a tile is
    scanned once.  Returns the four :func:`dispatch_probes` outputs plus:
      u_cluster [S, u_cap] int32 — local cluster per unique slot (pads
                repeat the last unique one),
      u_tile    [S, u_cap] int32 — query tile per unique slot,
      slot_of   [S, P_cap] int32 — unique-slot index of each probe,
      u_count   [S] int32 — live unique slots per shard.
    """
    sc, sq, sv, n_overflowed = dispatch_probes(
        probe_ids, n_shards=n_shards, k_local=k_local, p_cap=p_cap,
        probe_valid=probe_valid, ownership=ownership)
    tile = torch.div(sq, q_block, rounding_mode="floor")
    key = tile * k_local + sc  # [S, P_cap]
    table, slot_of, u_count = probes_lib.dedup_rows(key, sv, u_cap)
    # u_cap = min(p_cap, k_local·n_tiles) can never overflow; clip anyway
    slot_of = torch.clamp(slot_of, max=u_cap - 1)
    u_cluster = table % k_local
    u_tile = torch.div(table, k_local, rounding_mode="floor")
    return sc, sq, sv, n_overflowed, u_cluster, u_tile, slot_of, u_count


def _rank_within_query(slot_query: torch.Tensor, slot_valid: torch.Tensor,
                       t: int) -> torch.Tensor:
    """Rank of each slot among the valid slots serving the same query,
    clipped to T - 1 (a query has exactly T probes)."""
    p = slot_query.shape[0]
    key = torch.where(slot_valid, slot_query.long(), 2**30)
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    first = torch.searchsorted(key_s, key_s, side="left")
    rank = torch.zeros((p,), dtype=torch.int32, device=slot_query.device)
    rank[order] = (torch.arange(p, device=key.device) - first).int()
    return torch.clamp(rank, max=t - 1)


def _local_shard_search(
    vectors: torch.Tensor,  # [K_local, Vpad, D]
    attrs: torch.Tensor,
    ids: torch.Tensor,
    norms: Optional[torch.Tensor],
    scales: Optional[torch.Tensor],
    queries: torch.Tensor,  # [Q, D] replicated (tiled: padded to tiles)
    lo: torch.Tensor,
    hi: torch.Tensor,
    slot_cluster: torch.Tensor,  # [P_cap]
    slot_query: torch.Tensor,  # [P_cap]
    slot_valid: torch.Tensor,  # [P_cap] bool (already gated by shard_ok)
    u_cluster: Optional[torch.Tensor] = None,  # [U] (tiled)
    u_tile: Optional[torch.Tensor] = None,  # [U]
    slot_of: Optional[torch.Tensor] = None,  # [P_cap] → index into U
    u_count: Optional[torch.Tensor] = None,  # scalar: live slots of U (tiled)
    *,
    metric: str,
    k: int,
    t: int,
    q_block: int,
    backend: str,
):
    """One shard's contribution: its scan over its slots → per-query top-k.

    Tiled: the four tiled operands are required.  The dedup pads of
    ``u_cluster`` (slots from ``u_count`` on) repeat the last unique slot
    and no probe reads them, so they are passed to the scan as cluster -1
    and skipped.  Per probe: every slot's row of scores is written, pads
    included, and masked afterwards; the kernel computes each distinct
    (cluster, query) pair once, so the pads (all cluster 0, query 0) cost
    one pair and their rows are copies of its scores.
    """
    q = queries.shape[0]
    if backend == "pallas_tiled":
        live = torch.arange(u_cluster.shape[0], device=u_cluster.device)
        scan_cluster = torch.where(live < u_count, u_cluster, -1)
        uvals, uids, _ = filtered_scan_tiled(
            scan_cluster, u_tile, None, queries, lo, hi, vectors, attrs, ids,
            norms, scales, metric=metric, k=k, q_block=q_block)
        sop = slot_of.long()
        row = slot_query.long() % q_block
        svals = torch.where(slot_valid[:, None], uvals[sop, row], NEG_INF)
        sids = torch.where(slot_valid[:, None], uids[sop, row], -1)
    elif backend == "pallas":
        scores = filtered_scan(
            slot_cluster, slot_query, queries, lo, hi, vectors, attrs, ids,
            norms, scales, metric=metric)  # [P_cap, Vpad]
        scores = torch.where(slot_valid[:, None], scores, NEG_INF)
        slot_ids = ids[slot_cluster.long()]  # [P_cap, Vpad]
        svals, sids = topk_lib.masked_topk(scores, None, k, ids=slot_ids)
    else:
        raise ValueError(backend)

    rank = _rank_within_query(slot_query, slot_valid, t).long()
    safe_q = torch.where(slot_valid, slot_query.long(), q)  # pads: out of range
    qvals = _scatter_drop((q, t, k), safe_q, rank, svals, fill=NEG_INF)
    qids = _scatter_drop((q, t, k), safe_q, rank, sids, fill=-1)
    return topk_lib.masked_topk(qvals.reshape(q, t * k), None, k,
                                ids=qids.reshape(q, t * k))


@dataclasses.dataclass(frozen=True)
class ShardedSearchConfig:
    """The reference's config without its TPU tiling (``q_block``,
    ``k_block``, ``v_block``), ``use_centroid_kernel`` (probe selection is
    ``probe_centroids`` on every device) and ``quantized`` (the index's own
    ``scales`` say whether it is SQ8)."""

    k: int = 100
    n_probes: int = 7  # paper's T
    p_cap_slack: float = 2.0
    scan_q_block: int = 64  # query-tile height QB of the tiled scan
    backend: str = "pallas"  # "pallas" (per probe) | "pallas_tiled"
    # filter-aware probe pruning from the index's cluster summaries:
    # "auto" prunes iff the index has them, "on" requires them, "off" never
    prune: str = "auto"


@dataclasses.dataclass
class ShardedPlan:
    """What the scan + merge needs, from :meth:`ShardedSearch.plan`."""

    q: int
    queries: torch.Tensor  # [Q, D] as given (l2 constant)
    queries_in: torch.Tensor  # scan queries (tiled: padded to whole tiles)
    lo_in: torch.Tensor
    hi_in: torch.Tensor
    slot_cluster: torch.Tensor  # [P_cap] int32, this shard's row
    slot_query: torch.Tensor  # [P_cap] int32
    slot_valid: torch.Tensor  # [P_cap] bool, gated by shard_ok
    n_overflowed: torch.Tensor  # scalar int32
    u_cluster: Optional[torch.Tensor] = None  # [u_cap] (tiled)
    u_tile: Optional[torch.Tensor] = None
    slot_of: Optional[torch.Tensor] = None  # [P_cap]
    u_count: Optional[torch.Tensor] = None  # scalar


class ShardedSearch:
    """One rank's sharded search: ``search(index, queries, fspec,
    shard_ok=None) -> SearchResult``, or its stages :meth:`plan` (probe
    centroids, prune, dispatch), :meth:`scan` (this shard's slots → its
    per-query top-k) and :meth:`merge` (the tree merge over the mesh);
    :meth:`execute` is scan + merge.

    ``index`` is this rank's shard (its ``k_local`` clusters, replicated
    centroids and summaries).  Like the reference, ``n_scanned`` carries the
    dispatch's overflow count (over every shard) for every query and
    ``n_passed`` is zeros.
    """

    def __init__(self, metric: str, cfg: ShardedSearchConfig, *, p_cap: int,
                 k_local: int, scan_q_block: int, u_cap: int,
                 device: torch.device, n_shards: int = 1, shard_id: int = 0,
                 groups: tuple = ()):
        self.metric = metric
        self.cfg = cfg
        self.p_cap = p_cap
        self.k_local = k_local
        self.scan_q_block = scan_q_block
        self.u_cap = u_cap
        self.device = device
        self.n_shards = n_shards
        self.shard_id = shard_id
        self.groups = groups  # merge order: model → data → pod

    def plan(self, index: IVFFlatIndex, queries: torch.Tensor,
             fspec: FilterSpec, shard_ok: Optional[torch.Tensor] = None
             ) -> ShardedPlan:
        cfg = self.cfg
        dev = index.vectors.device
        if dev.type != self.device.type:
            raise ValueError(f"index lives on {dev}, search built for "
                             f"{self.device}")
        if index.vectors.shape[0] != self.k_local:
            raise ValueError(
                f"index holds {index.vectors.shape[0]} clusters, shard "
                f"{self.shard_id} of {self.n_shards} owns {self.k_local}: "
                "pass the rank's shard (local_shard / load_index_shard)")
        if shard_ok is None:
            shard_ok = torch.ones((self.n_shards,), dtype=torch.bool, device=dev)
        # §4.4 step 2: probe centroids (replicated)
        _, probe_ids = probe_centroids(queries, index.centroids,
                                       t=cfg.n_probes, metric=self.metric)
        # filter-aware prune mask (replicated, like the plan stage)
        summ = resolve_prune(index, cfg.prune)
        probe_valid = None
        if summ is not None:
            cm = summaries_lib.can_match(summ, fspec.lo, fspec.hi)  # [Q, K]
            probe_valid = torch.gather(cm, 1, probe_ids.long())
        qb = self.scan_q_block
        sid = self.shard_id
        kw = dict(n_shards=self.n_shards, k_local=self.k_local,
                  p_cap=self.p_cap, probe_valid=probe_valid)
        # dispatch: replicated compute, each rank takes its own row
        if cfg.backend == "pallas_tiled":
            sc, sq, sv, n_drop, uc, ut, uslot, ucount = dispatch_probes_tiled(
                probe_ids, u_cap=self.u_cap, q_block=qb, **kw)
            tiled = dict(u_cluster=uc[sid], u_tile=ut[sid],
                         slot_of=uslot[sid], u_count=ucount[sid])
            queries_in = probes_lib.pad_to_tiles(queries, qb).contiguous()
            lo_in = probes_lib.pad_to_tiles(fspec.lo, qb).contiguous()
            hi_in = probes_lib.pad_to_tiles(fspec.hi, qb).contiguous()
        else:
            sc, sq, sv, n_drop = dispatch_probes(probe_ids, **kw)
            tiled = {}
            queries_in = queries.contiguous()
            lo_in, hi_in = fspec.lo.contiguous(), fspec.hi.contiguous()
        return ShardedPlan(
            q=queries.shape[0], queries=queries, queries_in=queries_in,
            lo_in=lo_in, hi_in=hi_in, slot_cluster=sc[sid],
            slot_query=sq[sid], slot_valid=sv[sid] & shard_ok[sid],
            n_overflowed=n_drop, **tiled)

    def scan(self, index: IVFFlatIndex, plan: ShardedPlan):
        """This shard's per-query top-k ``(vals, ids)`` over its slots,
        ``[Q_in, k]`` (``Q_in``: the tiled scan's padded rows)."""
        return _local_shard_search(
            index.vectors, index.attrs, index.ids,
            index.norms if self.metric == "l2" else None,
            index.scales,  # None unless SQ8
            plan.queries_in, plan.lo_in, plan.hi_in, plan.slot_cluster,
            plan.slot_query, plan.slot_valid, plan.u_cluster, plan.u_tile,
            plan.slot_of, plan.u_count, metric=self.metric, k=self.cfg.k,
            t=self.cfg.n_probes, q_block=self.scan_q_block,
            backend=self.cfg.backend)

    def merge(self, plan: ShardedPlan, vals: torch.Tensor,
              out_ids: torch.Tensor) -> SearchResult:
        """The tree merge over the mesh (every rank gets the answer); with
        one shard and no mesh, one ``masked_topk`` over its k entries."""
        k = self.cfg.k
        if self.groups:
            vals, out_ids = topk_lib.topk_tree_merge(vals, out_ids, k,
                                                     self.groups)
        else:
            vals, out_ids = topk_lib.masked_topk(vals, None, k, ids=out_ids)
        q = plan.q
        vals, out_ids = vals[:q], out_ids[:q]
        if self.metric == "l2":
            q2 = torch.sum(plan.queries.float() ** 2, -1, keepdim=True)
            vals = torch.where(vals > NEG_INF / 2, vals - q2, vals)
        zero = torch.zeros((q,), dtype=torch.int32, device=vals.device)
        return SearchResult(vals, out_ids, zero + plan.n_overflowed, zero)

    def execute(self, index: IVFFlatIndex, plan: ShardedPlan) -> SearchResult:
        return self.merge(plan, *self.scan(index, plan))

    def __call__(self, index: IVFFlatIndex, queries: torch.Tensor,
                 fspec: FilterSpec, shard_ok: Optional[torch.Tensor] = None
                 ) -> SearchResult:
        return self.execute(index, self.plan(index, queries, fspec, shard_ok))


def make_sharded_search(metric: str, *, q_total: int, n_clusters: int,
                        cfg: ShardedSearchConfig, mesh=None,
                        axis_names=None, n_shards: int = 1, device="cuda"):
    """Builds the sharded search step of this rank.

    With a ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh`),
    the cluster axis is split over ``axis_names`` (default: every mesh
    axis): S is the product of their sizes, this rank's shard id is its
    coordinate over them, row-major (for a mesh over the whole world, the
    global rank), and the merge runs over their process groups in reverse.
    Without one, ``n_shards`` must be 1.

    Returns ``(search_fn, info)``: ``search_fn(index, queries, fspec,
    shard_ok=None) -> SearchResult`` (a :class:`ShardedSearch`), and
    ``info`` with ``p_cap``, ``k_local``, ``n_shards``, ``shard_id``, the
    dispatch's ``ownership`` map and ``shardings``: for each index leaf, the
    mesh axes its cluster axis is split over (``()``: replicated), the
    reference's ``NamedSharding`` dict.  ``device`` defaults to CUDA and
    raises when CUDA is absent and the CPU was not asked for.
    """
    dev = resolve_device(device)
    if metric not in ("dot", "l2"):
        raise ValueError(metric)
    if cfg.backend not in BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS}, got {cfg.backend!r}: in the "
            "port the tensors' device picks the route")
    axes = ()
    if mesh is not None:
        names = tuple(mesh.mesh_dim_names)
        axes = tuple(axis_names or names)
        sizes = [mesh.shape[names.index(a)] for a in axes]
        n_shards = math.prod(sizes)
    elif n_shards != 1:
        raise ValueError(f"n_shards={n_shards} needs a mesh: pass mesh= (a "
                         "DeviceMesh over the ranks, launch.mesh.make_mesh)")
    if n_clusters % n_shards:
        raise ValueError(
            f"K={n_clusters} must divide over {n_shards} shards; pad K at "
            "build time (storage.pad_k, or load with target_shards).")
    shard_id, groups = 0, ()
    if mesh is not None:
        coord = mesh.get_coordinate()
        for a, size in zip(axes, sizes):
            shard_id = shard_id * size + coord[names.index(a)]
        groups = tuple(mesh.get_group(a) for a in reversed(axes))
        for a, g in zip(reversed(axes), groups):
            # the merge lays out candidates in group-rank order, which must
            # be the mesh coordinate (the reference's all_gather order)
            if dist.get_rank(g) != coord[names.index(a)]:
                raise ValueError(f"axis {a!r}: group rank "
                                 f"{dist.get_rank(g)} is not the mesh "
                                 f"coordinate {coord[names.index(a)]}")
    k_local = n_clusters // n_shards
    p_cap = probe_capacity(q_total, cfg.n_probes, n_shards, cfg.p_cap_slack)
    scan_qb = min(cfg.scan_q_block, round_up(q_total, 8))
    n_tiles = round_up(q_total, scan_qb) // scan_qb
    u_cap = max(1, min(p_cap, k_local * n_tiles))
    search = ShardedSearch(metric, cfg, p_cap=p_cap, k_local=k_local,
                           scan_q_block=scan_qb, u_cap=u_cap, device=dev,
                           n_shards=n_shards, shard_id=shard_id,
                           groups=groups)
    shardings = dict(centroids=(), summaries=(), vectors=axes, attrs=axes,
                     ids=axes, norms=axes, scales=axes, counts=axes)
    return search, dict(p_cap=p_cap, k_local=k_local, n_shards=n_shards,
                        shard_id=shard_id, shardings=shardings,
                        ownership=RangeOwnership(n_shards, k_local))


def local_shard(index: IVFFlatIndex, shard_id: int, n_shards: int
                ) -> IVFFlatIndex:
    """Shard ``shard_id`` of ``index``: the per-cluster leaves over
    ``[s·K/S, (s+1)·K/S)`` (views), the centroids and summaries whole (the
    placement of the reference's ``jax.device_put(index, shardings)``)."""
    k = index.n_clusters
    if k % n_shards:
        raise ValueError(f"K={k} must divide over {n_shards} shards; pad K "
                         "first (storage.pad_k)")
    kl = k // n_shards
    sl = slice(shard_id * kl, (shard_id + 1) * kl)
    return dataclasses.replace(
        index, vectors=index.vectors[sl], attrs=index.attrs[sl],
        ids=index.ids[sl], counts=index.counts[sl],
        norms=None if index.norms is None else index.norms[sl],
        scales=None if index.scales is None else index.scales[sl])


# ---- driving the ranks from one controller ----

_HEADER = 5  # stop, Q, D, F, M


def _broadcast_batch(queries, lo, hi, shard_ok):
    """Sends one batch from rank 0 (the header first, so the other ranks
    can allocate); gloo has no int16, so the bounds go as int32."""
    q, d = queries.shape
    _, f, m = lo.shape
    header = torch.tensor([0, q, d, f, m], dtype=torch.int64,
                          device=queries.device)
    dist.broadcast(header, src=0)
    for t in (queries.contiguous(), lo.int(), hi.int(),
              shard_ok.to(torch.uint8)):
        dist.broadcast(t, src=0)


def lead(search: ShardedSearch, index: IVFFlatIndex):
    """Rank 0's side of the driver: a ``search_fn(queries, fspec,
    shard_ok=None) -> (scores, ids)`` for a ``SearchServer`` that sends each
    batch to the other ranks (each in :func:`follow`) and then searches it
    (queries travel, and are searched, as f32).  ``search_fn.stop()`` ends
    their follow loops."""
    def search_fn(queries, fspec, shard_ok=None):
        queries = queries.float()
        if shard_ok is None:
            shard_ok = torch.ones((search.n_shards,), dtype=torch.bool,
                                  device=queries.device)
        _broadcast_batch(queries, fspec.lo, fspec.hi, shard_ok)
        res = search(index, queries, fspec, shard_ok)
        return res.scores, res.ids

    def stop():
        header = torch.zeros((_HEADER,), dtype=torch.int64,
                             device=search.device)
        header[0] = 1
        dist.broadcast(header, src=0)

    search_fn.stop = stop
    return search_fn


def follow(search: ShardedSearch, index: IVFFlatIndex) -> int:
    """Every other rank's side: receives rank 0's batches and searches each
    (its shard's scan and its part of the merge) until ``stop``.  Returns
    the number of batches served."""
    dev = search.device
    n = 0
    while True:
        header = torch.zeros((_HEADER,), dtype=torch.int64, device=dev)
        dist.broadcast(header, src=0)
        stop, q, d, f, m = (int(v) for v in header.tolist())
        if stop:
            return n
        queries = torch.empty((q, d), dtype=torch.float32, device=dev)
        lo = torch.empty((q, f, m), dtype=torch.int32, device=dev)
        hi = torch.empty_like(lo)
        ok = torch.empty((search.n_shards,), dtype=torch.uint8, device=dev)
        for t in (queries, lo, hi, ok):
            dist.broadcast(t, src=0)
        search(index, queries, FilterSpec(lo=lo.short(), hi=hi.short()),
               ok.bool())
        n += 1
