"""Filtered similarity search over the hybrid index (paper §4.4): the port
of ``repro.core.search``.

  * :func:`brute_force`      — exact oracle over flat arrays.
  * :func:`search_reference` — the paper's five steps in plain torch: probe
    T centroids, gather the probed lists, mask by filter, score, merge.
    Materializes the ``[Q, T, Vpad, D]`` gather: for tests and spot checks.

The fast path is ``repro_torch.core.engine.SearchEngine``.  All return
``SearchResult(scores [Q,k] f32, ids [Q,k] int32)``; ids are -1 where fewer
than k vectors pass, and scores are "larger is more similar" (dot, or
``-||q-v||²`` for metric="l2").
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import topk as topk_lib
from repro_torch.core.filters import FilterSpec, filter_mask
from repro_torch.core.ivf import IVFFlatIndex, validity_mask


@dataclasses.dataclass
class SearchResult:
    scores: torch.Tensor  # [Q, k] f32
    ids: torch.Tensor  # [Q, k] int32, -1 = no hit
    n_scanned: torch.Tensor  # [Q] int32 — candidates scanned
    n_passed: torch.Tensor  # [Q] int32 — candidates passing the filter
    # [Q] int32 — probes the filter-aware planner pruned; None on paths
    # without a plan stage (reference, brute force)
    n_pruned: Optional[torch.Tensor] = None


def centroid_scores(centroids: torch.Tensor, counts: torch.Tensor,
                    queries: torch.Tensor, *, metric: str) -> torch.Tensor:
    """[Q, K] centroid scores with empty clusters (``counts == 0``) masked
    to NEG_INF so the probe budget never lands on them."""
    q32 = queries.float()
    if metric == "dot":
        scores = q32 @ centroids.T
    else:
        scores = 2.0 * (q32 @ centroids.T) - torch.sum(
            centroids * centroids, -1
        )[None, :]
    return torch.where(counts[None, :] > 0, scores, topk_lib.NEG_INF)


def search_centroids(index: IVFFlatIndex, queries: torch.Tensor,
                     n_probes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """§4.4 step 2: T nearest non-empty centroids per query.
    Returns ([Q, T] int32 ids, [Q, T] scores)."""
    scores = centroid_scores(index.centroids, index.counts, queries,
                             metric=index.spec.metric)
    vals, ids = topk_lib.top_k(scores, n_probes)
    return ids.int(), vals


def search_reference(index: IVFFlatIndex, queries: torch.Tensor,
                     fspec: FilterSpec, *, k: int, n_probes: int
                     ) -> SearchResult:
    """Plain-torch §4.4 pipeline. Shapes: queries [Q, D]; fspec len Q."""
    q = queries.shape[0]
    probe_ids, _ = search_centroids(index, queries, n_probes)  # [Q, T]
    p = probe_ids.long()
    vecs = index.vectors[p].float()  # [Q, T, Vpad, D]
    attr = index.attrs[p]  # [Q, T, Vpad, M]
    ids = index.ids[p]  # [Q, T, Vpad]
    valid = validity_mask(index)[p]
    qidx = torch.arange(q, device=queries.device)[:, None, None].expand(
        attr.shape[:-1])
    mask = valid & filter_mask(fspec, attr, query_idx=qidx)

    q32 = queries.float()
    dots = torch.einsum("qd,qtvd->qtv", q32, vecs)
    if index.scales is not None:  # SQ8: fold the per-vector scale into the dot
        dots = dots * index.scales[p]
    if index.spec.metric == "dot":
        scores = dots
    else:
        q2 = torch.sum(q32 * q32, dim=-1)[:, None, None]
        scores = 2.0 * dots - index.norms[p] - q2  # -(||q-v||²)
    vals, out_ids = topk_lib.masked_topk(
        scores.reshape(q, -1), mask.reshape(q, -1), k, ids=ids.reshape(q, -1))
    n_scanned = valid.reshape(q, -1).sum(-1).int()
    n_passed = mask.reshape(q, -1).sum(-1).int()
    return SearchResult(vals, out_ids, n_scanned, n_passed)


def brute_force(vectors: torch.Tensor, attrs: torch.Tensor,
                queries: torch.Tensor, fspec: FilterSpec, *, k: int,
                metric: str = "dot", ids: Optional[torch.Tensor] = None
                ) -> SearchResult:
    """Exact filtered search over flat [N, D] / [N, M] arrays (the oracle)."""
    q = queries.shape[0]
    n = vectors.shape[0]
    q32 = queries.float()
    v32 = vectors.float()
    dots = q32 @ v32.T  # [Q, N]
    if metric == "dot":
        scores = dots
    else:
        scores = (2.0 * dots - torch.sum(v32 * v32, -1)[None, :]
                  - torch.sum(q32 * q32, -1)[:, None])
    amask = filter_mask(fspec, attrs.expand((q,) + tuple(attrs.shape)))
    if ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=vectors.device)
    vals, out_ids = topk_lib.masked_topk(scores, amask, k,
                                         ids=ids.expand(q, n))
    n_scanned = torch.full((q,), n, dtype=torch.int32, device=vectors.device)
    n_passed = amask.sum(-1).int()
    return SearchResult(vals, out_ids, n_scanned, n_passed)


def recall_at_k(result: SearchResult, oracle: SearchResult) -> float:
    """Fraction of oracle ids recovered (standard ANN recall@k)."""
    res = result.ids.cpu().numpy()
    ref = oracle.ids.cpu().numpy()
    ref_live = ref >= 0  # [Q, k']
    hit = np.logical_and(
        ref[:, :, None] == res[:, None, :], ref_live[:, :, None]
    ).any(-1)  # res -1 pads never equal a live ref id
    total = int(ref_live.sum())
    return int(hit.sum()) / max(total, 1)
