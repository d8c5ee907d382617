"""Search execution engine, sync RAM tier: plan → fetch → scan → merge.

The port of ``repro.core.engine`` for ``SearchEngine(pipeline="off")``
over a RAM-resident index:

    plan   — :func:`plan_fused_tiled` over resident state: centroid top-T,
             filter-aware probe pruning (exact mode), per-tile probe dedup;
             with ``adaptive_u_cap`` the slot tables are then cut to the
             smallest bucket covering the observed unique counts.
    fetch  — the resident ``[K, Vpad, ...]`` arrays (a no-op).
    scan   — the tiled filtered scan kernel over the slot tables.
    merge  — monoid top-k across each query's probes, the l2 constant
             fix-up and the scan accounting (:func:`_scan_merge_tiled`).

Every other engine knob of the reference (disk tier, pipelining, delta
tier, caches, partitions, termination, widening) is not ported yet and
raises ``NotImplementedError`` when set.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import probes as probes_lib
from repro_torch.core import summaries as summaries_lib
from repro_torch.core import topk as topk_lib
from repro_torch.core.filters import FilterSpec
from repro_torch.core.ivf import IVFFlatIndex, round_up
from repro_torch.core.search import SearchResult, centroid_scores
from repro_torch.device import resolve_device
from repro_torch.kernels.filtered_scan.filtered_scan import filtered_scan_tiled


def plan_fused_tiled(centroids: torch.Tensor, counts: torch.Tensor,
                     queries: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     *, metric: str, n_probes: int, q_block: int, u_cap: int,
                     cast_dtype: torch.dtype,
                     summaries: Optional[summaries_lib.ClusterSummaries] = None):
    """Plan stage: centroid probe + per-tile dedup over resident state.

    Returns ``(slot_cluster, slot_tile, slot_of_probe, probe_ok, n_unique,
    queries_pad, lo_pad, hi_pad, n_pruned)``; queries and bounds come back
    padded to whole ``q_block`` tiles with edge rows.  With ``summaries``
    the plan drops probes whose cluster provably holds no row passing the
    query's filter (results unchanged).
    """
    scores = centroid_scores(centroids, counts, queries, metric=metric)
    q = queries.shape[0]
    cvals, probe_ids = topk_lib.top_k(scores, n_probes)  # [Q, T]
    probe_ids = probe_ids.int()
    if summaries is None:
        probe_valid = None
        n_pruned = torch.zeros((q,), dtype=torch.int32, device=queries.device)
    else:
        cm = summaries_lib.can_match(summaries, lo, hi)  # [Q, K]
        cm_c = torch.gather(cm, 1, probe_ids.long())  # [Q, T]
        real = cvals > topk_lib.NEG_INF / 2  # exclude empty clusters
        n_pruned = (~cm_c & real).sum(-1).int()
        probe_valid = cm_c & real
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
            n_pruned)


def _scan_merge_tiled(
    slot_cluster, slot_tile, slot_of_probe, probe_ok, n_unique,
    queries, queries_pad, lo_pad, hi_pad, vectors, attrs, ids, norms, scales,
    *, metric: str, k: int, q: int, q_block: int,
) -> SearchResult:
    """Scan + merge: scan the planned slots, merge per-probe fragments.

    Dedup pad slots are skipped by the scan; the merge never reads one for
    a probe with ``probe_ok`` (a live probe points at a live slot).
    """
    qpad = queries_pad.shape[0]
    svals, sids, snpass = filtered_scan_tiled(
        slot_cluster, slot_tile, n_unique, queries_pad, lo_pad, hi_pad,
        vectors, attrs, ids, norms, scales, metric=metric, k=k,
        q_block=q_block)

    # per-probe candidate fragments, then the monoid merge across T probes;
    # probes that overflowed u_cap or were pruned are masked out
    sop = slot_of_probe.long()
    row = (torch.arange(qpad, device=sop.device) % q_block)[:, None]
    vals_qt = svals[sop, row]  # [Qpad, T, k]
    ids_qt = sids[sop, row]
    npass_qt = snpass[sop, row]  # [Qpad, T]
    vals_qt = torch.where(probe_ok[..., None], vals_qt, topk_lib.NEG_INF)
    ids_qt = torch.where(probe_ok[..., None], ids_qt, -1)
    npass_qt = torch.where(probe_ok, npass_qt, 0)
    vals, out_ids = topk_lib.merge_topk_many(vals_qt, ids_qt, k, axis=1)
    vals, out_ids = vals[:q], out_ids[:q]

    if metric == "l2":
        q2 = torch.sum(queries.float() ** 2, -1)  # [Q]
        vals = torch.where(vals > topk_lib.NEG_INF / 2, vals - q2[:, None], vals)

    n_passed = npass_qt[:q].sum(-1).int()
    # a probe's slot scans exactly its cluster: live rows per probe through
    # the slot tables
    live_per_row = (ids >= 0).sum(-1)  # [K]
    live_per_slot = live_per_row[slot_cluster.long()]  # [S]
    n_scanned = (live_per_slot[sop[:q]] * probe_ok[:q]).sum(-1).int()
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
class SearchPlan:
    """Everything the fetch/scan/merge stages need, produced by plan().
    Slot tables stay on the index's device."""

    q: int
    q_block: int
    n_tiles: int
    u_cap: int               # provisioned table width (post-bucketing)
    slot_cluster: torch.Tensor   # [n_tiles·u_cap] int32
    slot_tile: torch.Tensor      # [n_tiles·u_cap] int32
    slot_of_probe: torch.Tensor  # [Qpad, T] int32
    probe_ok: torch.Tensor       # [Qpad, T] bool
    n_unique: torch.Tensor       # [n_tiles] int32
    queries: torch.Tensor        # [Q, D] original (l2 constant)
    queries_pad: torch.Tensor    # [Qpad, D] cast to the scan dtype
    lo_pad: torch.Tensor
    hi_pad: torch.Tensor
    n_pruned: torch.Tensor       # [Q] int32


@dataclasses.dataclass
class EngineStats:
    """Per-engine execution counters."""

    batches: int = 0
    last_u_cap: int = 0
    u_cap_hist: Dict[int, int] = dataclasses.field(default_factory=dict)


# Reference knobs the port does not have yet: name → (default, ROADMAP item).
_UNPORTED = {
    "pipeline": ("off", "A.4 pipelined executor"),
    "pipeline_depth": (2, "A.4 pipelined executor"),
    "blockstore": (None, "A.4 disk tier and block stores"),
    "gather_fn": (None, "A.4 disk tier and block stores"),
    "operand_cache": ("auto", "A.4 disk tier and block stores"),
    "delta": (None, "A.5 live updates"),
    "device_cache": (None, "A.6 device cache"),
    "partitions": ("auto", "A.6 sub-partition routing"),
    "termination": (None, "A.6 bound-driven termination"),
    "epsilon": (0.0, "A.6 bound-driven termination"),
    "t_max": (None, "A.3 adaptive probe widening"),
    "backend": (None, "the port picks the kernel by the tensors' device"),
}


def _reject_unported(index, knobs: dict):
    for name, value in knobs.items():
        if name not in _UNPORTED:
            raise TypeError(f"SearchEngine got an unexpected keyword {name!r}")
        default, item = _UNPORTED[name]
        ok = value == default or (name == "pipeline" and value == "auto")
        if not ok:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (ROADMAP {item})")
    if getattr(index, "partitions", None) is not None:
        raise NotImplementedError(
            "an index with a partition catalog is not ported yet "
            "(ROADMAP A.6 sub-partition routing)")


class SearchEngine:
    """The tiled fused search over a RAM-resident index (sync executor).

    Knobs: ``k``, ``n_probes``, ``q_block`` (query-tile height), ``v_block``
    (accepted for parity with the reference; the CUDA kernel picks its own
    row chunk), ``u_cap`` (pinned slot-table width) or ``adaptive_u_cap``
    (bucketed from the observed unique counts, the default when ``u_cap``
    is None) with ``u_cap_ladder``/``u_cap_bucket_set``, and ``prune``.

    ``device`` must be the index's device; it defaults to CUDA and raises
    when CUDA is absent and the CPU was not asked for.
    """

    def __init__(self, index: IVFFlatIndex, *, k: int, n_probes: int,
                 q_block: int = 64, v_block: int = 256,
                 u_cap: Optional[int] = None, prune: str = "auto",
                 adaptive_u_cap: Optional[bool] = None,
                 u_cap_bucket_set: Optional[Tuple[int, ...]] = None,
                 u_cap_ladder: str = "pow2", device="cuda", **unported):
        _reject_unported(index, unported)
        self.device = resolve_device(device)
        if index.vectors.device.type != self.device.type:
            raise ValueError(f"index lives on {index.vectors.device}, engine "
                             f"asked for {self.device}")
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
        self.u_cap_bucket_set = u_cap_bucket_set
        self.u_cap_ladder = u_cap_ladder
        self.adaptive_u_cap = (
            (u_cap is None) if adaptive_u_cap is None else adaptive_u_cap
        )
        if self.adaptive_u_cap and u_cap is not None:
            raise ValueError("u_cap and adaptive_u_cap are exclusive")
        self.stats = EngineStats()

    # ---- plan ----
    def plan(self, queries, fspec: FilterSpec) -> SearchPlan:
        """Plans at the sound worst-case table width; with
        ``adaptive_u_cap`` the tables are then cut to a bucket."""
        index = self.index
        dev = index.vectors.device
        queries = torch.as_tensor(queries, device=dev)
        lo = torch.as_tensor(fspec.lo, device=dev)
        hi = torch.as_tensor(fspec.hi, device=dev)
        q = queries.shape[0]
        qb = min(self.q_block, round_up(q, 8))
        summ = resolve_prune(index, self.prune)
        full_cap = min(qb * self.n_probes, index.n_clusters)
        cap = full_cap if self.u_cap is None else self.u_cap
        cast_dtype = torch.float32 if index.quantized else index.store_dtype
        (slot_cluster, slot_tile, slot_of_probe, probe_ok, n_unique,
         queries_pad, lo_pad, hi_pad, n_pruned) = plan_fused_tiled(
            index.centroids, index.counts, queries, lo, hi,
            metric=index.spec.metric, n_probes=self.n_probes, q_block=qb,
            u_cap=cap, cast_dtype=cast_dtype, summaries=summ)
        plan = SearchPlan(
            q=q, q_block=qb, n_tiles=queries_pad.shape[0] // qb, u_cap=cap,
            slot_cluster=slot_cluster, slot_tile=slot_tile,
            slot_of_probe=slot_of_probe, probe_ok=probe_ok, n_unique=n_unique,
            queries=queries, queries_pad=queries_pad, lo_pad=lo_pad,
            hi_pad=hi_pad, n_pruned=n_pruned,
        )
        if self.adaptive_u_cap:
            self._provision(plan)
        self.stats.last_u_cap = plan.u_cap
        self.stats.u_cap_hist[plan.u_cap] = (
            self.stats.u_cap_hist.get(plan.u_cap, 0) + 1)
        return plan

    def _provision(self, plan: SearchPlan):
        """Adaptive u_cap: cut the slot tables to the smallest bucket
        covering every tile's unique count (only pad slots are cut, so
        results are unchanged).  Reads the [n_tiles] counts on the host."""
        full = plan.u_cap
        max_u = max(int(plan.n_unique.max()), 1)
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

    # ---- fetch / scan + merge ----
    def fetch(self, plan: SearchPlan):
        """RAM tier: the resident arrays, indexed by the plan's slots."""
        index = self.index
        return (plan.slot_cluster, index.vectors, index.attrs, index.ids,
                index.norms, index.scales)

    def scan_merge(self, plan: SearchPlan, operands) -> SearchResult:
        """Whole-batch scan/merge over fetched operands."""
        slot_cluster, vectors, attrs, ids, norms, scales = operands
        res = _scan_merge_tiled(
            slot_cluster, plan.slot_tile, plan.slot_of_probe, plan.probe_ok,
            plan.n_unique, plan.queries, plan.queries_pad, plan.lo_pad,
            plan.hi_pad, vectors, attrs, ids, norms, scales,
            metric=self.index.spec.metric, k=self.k, q=plan.q,
            q_block=plan.q_block)
        return dataclasses.replace(res, n_pruned=plan.n_pruned)

    def execute(self, plan: SearchPlan) -> SearchResult:
        self.stats.batches += 1
        return self.scan_merge(plan, self.fetch(plan))

    def search(self, queries, fspec: FilterSpec) -> SearchResult:
        return self.execute(self.plan(queries, fspec))


def search_fused_tiled(index: IVFFlatIndex, queries, fspec: FilterSpec, *,
                       k: int, n_probes: int, q_block: int = 64,
                       v_block: int = 256, u_cap: Optional[int] = None,
                       prune: str = "auto", adaptive_u_cap: bool = False,
                       u_cap_ladder: str = "pow2", device="cuda",
                       **unported) -> SearchResult:
    """Query-tiled, probe-deduplicated fused search: a one-batch
    :class:`SearchEngine` (same contract as ``search_reference``)."""
    eng = SearchEngine(
        index, k=k, n_probes=n_probes, q_block=q_block, v_block=v_block,
        u_cap=u_cap, prune=prune, adaptive_u_cap=adaptive_u_cap,
        u_cap_ladder=u_cap_ladder, device=device, **unported)
    return eng.search(queries, fspec)
