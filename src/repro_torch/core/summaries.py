"""Per-cluster attribute summaries and score bounds: the port of
``repro.core.summaries`` (the parts the probe plan and the checkpoint
writer need).

  * ``amin/amax [K, M] int16`` — closed per-cluster intervals over every
    live row; a DNF term disjoint from them in ANY attribute matches nothing.
  * ``hist [K, M, B] int32`` — fixed-width per-attribute count histograms
    over ``[edges_lo, edges_hi]``; a term whose covered bins hold zero rows
    matches nothing.

Both tests may only fail to prune, never prune a cluster that holds a
passing row, so a pruned plan returns the same ids as an unpruned one.
Maintenance keeps that contract: an add widens the intervals and adds
histogram mass (:func:`widen_for_add`), a tombstone leaves the summaries
stale-wide, and a compaction rebuilds the cluster's row exactly
(:func:`rebuild_cluster`, :func:`rebuild_cluster_bounds`).
:func:`expected_passing` turns the histograms into a ranking signal for
probe widening.

:class:`ClusterBounds` holds the per-cluster geometric statistics
(``radius``, ``slack``) that ``storage.save_index`` writes beside the
summaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.hybrid import ATTR_MAX, ATTR_MIN

DEFAULT_N_BINS = 16


@dataclasses.dataclass
class ClusterSummaries:
    """Resident per-cluster attribute metadata (shapes above).

    An empty cluster carries the void interval ``[ATTR_MAX, ATTR_MIN]`` and
    zero histogram mass, so it never matches any term.
    """

    amin: torch.Tensor  # [K, M] int16
    amax: torch.Tensor  # [K, M] int16
    hist: torch.Tensor  # [K, M, B] int32
    edges_lo: torch.Tensor  # [M] int16
    edges_hi: torch.Tensor  # [M] int16

    @property
    def n_clusters(self) -> int:
        return self.amin.shape[0]

    @property
    def n_attrs(self) -> int:
        return self.amin.shape[1]

    @property
    def n_bins(self) -> int:
        return self.hist.shape[-1]

    def nbytes(self) -> int:
        return sum(
            a.numel() * a.element_size()
            for a in (self.amin, self.amax, self.hist,
                      self.edges_lo, self.edges_hi)
        )


def attr_bins(attrs: torch.Tensor, edges_lo: torch.Tensor,
              edges_hi: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32 bin index of each attribute value, clipped into ``[0, n_bins)``.

    Values outside the edge range land in the edge bins (sound for the
    zero-mass test).  Floor division, as the reference's int32 ``//``.
    """
    lo = edges_lo.int()
    span = torch.clamp(edges_hi.int() - lo + 1, min=1)
    b = torch.div((attrs.int() - lo) * n_bins, span, rounding_mode="floor")
    return torch.clamp(b, 0, n_bins - 1).int()


# Clusters per step of the summary build: bounds the [chunk, Vpad, M]
# temporaries at full index size.
_BUILD_CHUNK = 256


def build_summaries(attrs: torch.Tensor, ids: torch.Tensor, *,
                    n_bins: int = DEFAULT_N_BINS,
                    edges: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    ) -> ClusterSummaries:
    """Builds summaries from the index's flat lists.

    Args:
      attrs: [K, Vpad, M] int16 attribute lists.
      ids:   [K, Vpad] int32 — rows with ``ids < 0`` are excluded.
      n_bins: histogram width B.
      edges: optional fixed ``(edges_lo, edges_hi)``; default = the observed
        global min/max over live rows.
    """
    k, _, m = attrs.shape
    dev = attrs.device
    live = ids >= 0
    amin = torch.empty((k, m), dtype=torch.int16, device=dev)
    amax = torch.empty((k, m), dtype=torch.int16, device=dev)
    for c0 in range(0, k, _BUILD_CHUNK):
        a = attrs[c0:c0 + _BUILD_CHUNK].int()
        lv = live[c0:c0 + _BUILD_CHUNK, :, None]
        amin[c0:c0 + _BUILD_CHUNK] = torch.where(lv, a, ATTR_MAX).amin(1).short()
        amax[c0:c0 + _BUILD_CHUNK] = torch.where(lv, a, ATTR_MIN).amax(1).short()
    if edges is None:
        # global min/max over live rows == over per-cluster intervals (an
        # empty cluster's void interval never wins either reduction)
        if bool(live.any()):
            edges_lo = amin.amin(0)
            edges_hi = amax.amax(0)
        else:
            edges_lo = torch.full((m,), ATTR_MIN, dtype=torch.int16, device=dev)
            edges_hi = torch.full((m,), ATTR_MAX, dtype=torch.int16, device=dev)
    else:
        edges_lo = torch.as_tensor(edges[0], device=dev).short()
        edges_hi = torch.as_tensor(edges[1], device=dev).short()
    hist = torch.zeros((k * m * n_bins,), dtype=torch.int32, device=dev)
    for c0 in range(0, k, _BUILD_CHUNK):
        a = attrs[c0:c0 + _BUILD_CHUNK]
        bins = attr_bins(a, edges_lo, edges_hi, n_bins).long()  # [c, V, M]
        kk = torch.arange(c0, c0 + a.shape[0], device=dev)[:, None, None]
        mm = torch.arange(m, device=dev)[None, None, :]
        flat = ((kk * m + mm) * n_bins + bins).reshape(-1)
        add = live[c0:c0 + _BUILD_CHUNK, :, None].expand(a.shape).reshape(-1)
        hist.index_add_(0, flat, add.int())
    return ClusterSummaries(
        amin=amin, amax=amax, hist=hist.reshape(k, m, n_bins),
        edges_lo=edges_lo, edges_hi=edges_hi,
    )


def rebuild_cluster(summaries: ClusterSummaries, attrs_row: torch.Tensor,
                    ids_row: torch.Tensor, cluster: int) -> ClusterSummaries:
    """Recomputes one cluster's summary row exactly (compaction, rebuilds),
    keeping the global edges so the histogram stays comparable with its
    neighbours.  Returns new summaries; the input is not modified."""
    live = ids_row >= 0  # [Vpad]
    a = attrs_row.int()
    amin = summaries.amin.clone()
    amax = summaries.amax.clone()
    hist = summaries.hist.clone()
    amin[cluster] = torch.where(live[:, None], a, ATTR_MAX).amin(0).short()
    amax[cluster] = torch.where(live[:, None], a, ATTR_MIN).amax(0).short()
    m, n_bins = summaries.n_attrs, summaries.n_bins
    bins = attr_bins(attrs_row, summaries.edges_lo, summaries.edges_hi,
                     n_bins).long()  # [Vpad, M]
    row = torch.zeros((m * n_bins,), dtype=torch.int32, device=hist.device)
    flat = (torch.arange(m, device=bins.device)[None, :] * n_bins + bins)
    row.index_add_(0, flat.reshape(-1),
                   live[:, None].expand(bins.shape).reshape(-1).int())
    hist[cluster] = row.reshape(m, n_bins)
    return dataclasses.replace(summaries, amin=amin, amax=amax, hist=hist)


def widen_for_add(summaries: ClusterSummaries, assignments: torch.Tensor,
                  attrs_new: torch.Tensor, ok: torch.Tensor
                  ) -> ClusterSummaries:
    """Folds a batch of appended rows into the summaries: intervals widen
    by scatter-min/max and each row adds histogram mass at its bins; rows
    with ``ok == False`` (capacity drops) are left out, so the summaries
    keep describing exactly the rows the index holds."""
    b, m = attrs_new.shape
    a = assignments.long()
    a_hi = torch.where(ok[:, None], attrs_new, ATTR_MAX).short()
    a_lo = torch.where(ok[:, None], attrs_new, ATTR_MIN).short()
    amin = summaries.amin.scatter_reduce(0, a[:, None].expand(b, m), a_hi,
                                         "amin")
    amax = summaries.amax.scatter_reduce(0, a[:, None].expand(b, m), a_lo,
                                         "amax")
    bins = attr_bins(attrs_new, summaries.edges_lo, summaries.edges_hi,
                     summaries.n_bins).long()  # [B, M]
    hist = summaries.hist.clone()
    hist.index_put_(
        (a[:, None].expand(b, m), torch.arange(m, device=a.device)[None, :]
         .expand(b, m), bins),
        ok[:, None].expand(b, m).int(), accumulate=True)
    return dataclasses.replace(summaries, amin=amin, amax=amax, hist=hist)


def _bin_mass(summaries: ClusterSummaries, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """[Q, F, K, M] int32 — histogram mass of each term's covered bins
    (``blo..bhi`` inclusive) per cluster and attribute."""
    n_bins = summaries.n_bins
    kc, m = summaries.amin.shape
    # cdf[..., b] = rows in bins < b
    cdf = torch.cat(
        [torch.zeros_like(summaries.hist[..., :1]),
         torch.cumsum(summaries.hist, dim=-1).int()], dim=-1
    )  # [K, M, B+1]
    blo = attr_bins(lo, summaries.edges_lo, summaries.edges_hi, n_bins).long()
    bhi = attr_bins(hi, summaries.edges_lo, summaries.edges_hi, n_bins).long()
    kk = torch.arange(kc, device=cdf.device)[None, None, :, None]
    mm = torch.arange(m, device=cdf.device)[None, None, None, :]
    return cdf[kk, mm, (bhi + 1)[:, :, None, :]] - cdf[kk, mm, blo[:, :, None, :]]


def can_match(summaries: ClusterSummaries, lo: torch.Tensor,
              hi: torch.Tensor) -> torch.Tensor:
    """[Q, K] bool — can any live row of cluster k pass query q's filter?

    A cluster can match iff SOME DNF term overlaps its summary in EVERY
    attribute: interval intersection ``max(term_lo, amin) <= min(term_hi,
    amax)`` (void-term safe) and nonzero histogram mass over the term's
    covered bins.  False guarantees zero passing rows.
    """
    amin = summaries.amin.int()[None, None]  # [1, 1, K, M]
    amax = summaries.amax.int()[None, None]
    tlo = lo.int()[:, :, None, :]  # [Q, F, 1, M]
    thi = hi.int()[:, :, None, :]
    overlap = torch.maximum(tlo, amin) <= torch.minimum(thi, amax)
    nonzero = _bin_mass(summaries, lo, hi) > 0
    per_term = torch.all(overlap & nonzero, dim=-1)  # [Q, F, K]
    return torch.any(per_term, dim=1)  # [Q, K]


def expected_passing(summaries: ClusterSummaries, lo: torch.Tensor,
                     hi: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[Q, K] f32 — histogram-mass estimate of the rows passing each filter.

    Per term and attribute, the covered-bin mass (partial bins included,
    so it over-estimates) over the cluster's live rows is a passing
    fraction; attributes multiply (independence, in attribute order),
    terms add, and the estimate is clipped to the live count.  A ranking
    signal only: pruning never rides on it.
    """
    # [K, M] live rows (the same count under each attribute)
    total = torch.clamp(summaries.hist.sum(-1), min=1)
    frac = _bin_mass(summaries, lo, hi).float() / total[None, None]
    per_term = frac[..., 0] if frac.shape[-1] else torch.ones(
        frac.shape[:-1], device=frac.device)
    for a in range(1, frac.shape[-1]):
        per_term = per_term * frac[..., a]
    void = (lo > hi).any(-1)  # [Q, F]: voided spare terms pass nothing
    per_term = torch.where(void[:, :, None], 0.0, per_term)  # [Q, F, K]
    c = counts.float()[None, :]
    return torch.minimum(per_term.sum(1) * c, c)


def pad_clusters(summaries: ClusterSummaries, k_new: int) -> ClusterSummaries:
    """Pads the cluster axis with void (never-matching) summary rows."""
    k, m = summaries.amin.shape
    if k_new < k:
        raise ValueError(f"cannot shrink K: {k} -> {k_new}")
    if k_new == k:
        return summaries
    dk = k_new - k
    dev = summaries.amin.device
    return dataclasses.replace(
        summaries,
        amin=torch.cat([summaries.amin, torch.full(
            (dk, m), ATTR_MAX, dtype=torch.int16, device=dev)]),
        amax=torch.cat([summaries.amax, torch.full(
            (dk, m), ATTR_MIN, dtype=torch.int16, device=dev)]),
        hist=torch.cat([summaries.hist, torch.zeros(
            (dk, m, summaries.n_bins), dtype=torch.int32, device=dev)]),
    )


@dataclasses.dataclass
class ClusterBounds:
    """Resident per-cluster geometric statistics for per-probe score bounds.

    ``radius[c]`` is the max distance from cluster ``c``'s centroid to any
    live stored row (SQ8 rows measured dequantized); ``slack[c]`` is the max
    of ``‖x̂‖² − norms_row`` over live rows (l2; 0 for dot).  An empty
    cluster carries ``radius == slack == 0``.
    """

    radius: torch.Tensor  # [K] f32
    slack: torch.Tensor   # [K] f32

    @property
    def n_clusters(self) -> int:
        return self.radius.shape[0]

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (self.radius, self.slack))


# Clusters per step of the bounds build: the f32 cast and the difference
# are [chunk, Vpad, D] temporaries, not [K, Vpad, D] ones.
_BOUNDS_CHUNK = 64


def build_bounds(centroids: torch.Tensor, vectors: torch.Tensor,
                 ids: torch.Tensor, norms: Optional[torch.Tensor] = None,
                 scales: Optional[torch.Tensor] = None) -> ClusterBounds:
    """Builds the per-cluster score-bound statistics from the flat lists,
    ``_BOUNDS_CHUNK`` clusters at a time (the per-cluster maxima do not
    depend on the chunking).

    Args mirror the index's resident arrays: ``vectors [K, Vpad, D]`` (store
    dtype; int8 codes with ``scales`` under SQ8), ``ids [K, Vpad]`` (rows
    with ``ids < 0`` excluded), ``norms [K, Vpad]`` for l2.
    """
    k = vectors.shape[0]
    dev = vectors.device
    radius = torch.empty((k,), dtype=torch.float32, device=dev)
    slack = torch.zeros((k,), dtype=torch.float32, device=dev)
    for c0 in range(0, k, _BOUNDS_CHUNK):
        sl = slice(c0, c0 + _BOUNDS_CHUNK)
        radius[sl], slack[sl] = _bounds_rows(
            vectors[sl], ids[sl], centroids[sl],
            None if norms is None else norms[sl],
            None if scales is None else scales[sl])
    return ClusterBounds(radius=radius, slack=slack)


def _bounds_rows(vectors, ids, centroids, norms, scales):
    """(radius, slack) [c] of clusters ``vectors [c, Vpad, D]`` (store
    dtype, SQ8 codes with ``scales``) over their live rows."""
    x32 = vectors.float()
    if scales is not None:
        x32 = x32 * scales.float()[..., None]
    live = ids >= 0
    diff = x32 - centroids.float()[:, None, :]
    d2 = (diff * diff).sum(-1)  # [c, Vpad]
    del diff
    # d2 >= 0: masking dead rows to 0 keeps the max sound and gives an
    # empty cluster radius 0
    radius = torch.sqrt(torch.where(live, d2, 0.0).amax(1))
    slack = torch.zeros_like(radius)
    if norms is not None:
        s = (x32 * x32).sum(-1) - norms.float()
        s = torch.where(live, s, float("-inf")).amax(1)
        slack = torch.where(live.any(1), s, 0.0)
    return radius, slack


def rebuild_cluster_bounds(bounds: ClusterBounds, centroid_row: torch.Tensor,
                           vectors_row: torch.Tensor, ids_row: torch.Tensor,
                           norms_row: Optional[torch.Tensor],
                           scales_row: Optional[torch.Tensor],
                           cluster: int) -> ClusterBounds:
    """Recomputes one cluster's bound row exactly (compaction, rebuilds).
    Returns new bounds; the input is not modified."""
    radius, slack = _bounds_rows(
        vectors_row[None], ids_row[None], centroid_row[None],
        None if norms_row is None else norms_row[None],
        None if scales_row is None else scales_row[None])
    out_r, out_s = bounds.radius.clone(), bounds.slack.clone()
    out_r[cluster] = radius[0]
    out_s[cluster] = slack[0]
    return ClusterBounds(radius=out_r, slack=out_s)
