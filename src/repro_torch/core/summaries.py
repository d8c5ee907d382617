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
    # mass of bins blo..bhi inclusive, per (query, term, cluster, attr)
    hi_mass = cdf[kk, mm, (bhi + 1)[:, :, None, :]]
    lo_mass = cdf[kk, mm, blo[:, :, None, :]]
    nonzero = (hi_mass - lo_mass) > 0
    per_term = torch.all(overlap & nonzero, dim=-1)  # [Q, F, K]
    return torch.any(per_term, dim=1)  # [Q, K]


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
    cents = centroids.float()
    for c0 in range(0, k, _BOUNDS_CHUNK):
        sl = slice(c0, c0 + _BOUNDS_CHUNK)
        x32 = vectors[sl].float()
        if scales is not None:
            x32 = x32 * scales[sl].float()[..., None]
        live = ids[sl] >= 0
        diff = x32 - cents[sl][:, None, :]
        d2 = (diff * diff).sum(-1)  # [c, Vpad]
        del diff
        # d2 >= 0: masking dead rows to 0 keeps the max sound and gives an
        # empty cluster radius 0
        radius[sl] = torch.sqrt(torch.where(live, d2, 0.0).amax(1))
        if norms is not None:
            s = (x32 * x32).sum(-1) - norms[sl].float()
            s = torch.where(live, s, float("-inf")).amax(1)
            slack[sl] = torch.where(live.any(1), s, 0.0)
    return ClusterBounds(radius=radius, slack=slack)
