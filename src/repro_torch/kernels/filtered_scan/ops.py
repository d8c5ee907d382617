"""Index-level fused filtered search over the per-probe scan: the port of
``repro.kernels.filtered_scan.ops.search_fused``.

The query-tiled successor is :func:`repro_torch.core.engine.
search_fused_tiled`.
"""

from __future__ import annotations

import torch

from repro_torch.core import topk as topk_lib
from repro_torch.core.filters import FilterSpec
from repro_torch.core.ivf import IVFFlatIndex
from repro_torch.core.search import SearchResult, search_centroids
from repro_torch.device import resolve_device
from repro_torch.kernels.filtered_scan.filtered_scan import filtered_scan


def search_fused(index: IVFFlatIndex, queries: torch.Tensor, fspec: FilterSpec,
                 *, k: int, n_probes: int, device="cuda") -> SearchResult:
    """Single-device fused search (paper §4.4) through the per-probe scan.

    Probes the T best non-empty centroids, scans each (query, probe) slot
    into masked ``[Q·T, Vpad]`` scores, and takes each query's top-k over
    its ``T·Vpad`` candidates.  ``device`` must be the index's device; it
    defaults to CUDA and raises when CUDA is absent and the CPU was not
    asked for.
    """
    dev = resolve_device(device)
    if index.vectors.device.type != dev.type:
        raise ValueError(f"index lives on {index.vectors.device}, search "
                         f"asked for {dev}")
    q = queries.shape[0]
    probe_ids, _ = search_centroids(index, queries, n_probes)  # [Q, T]
    slot_cluster = probe_ids.reshape(-1).contiguous()  # [Q·T]
    slot_query = torch.repeat_interleave(
        torch.arange(q, dtype=torch.int32, device=queries.device), n_probes)
    cast = torch.float32 if index.quantized else index.vectors.dtype
    scores = filtered_scan(
        slot_cluster, slot_query, queries.to(cast).contiguous(),
        fspec.lo.contiguous(), fspec.hi.contiguous(), index.vectors,
        index.attrs, index.ids, index.norms, index.scales,
        metric=index.spec.metric,
    )  # [Q·T, Vpad]

    if index.spec.metric == "l2":
        # add back the per-query -||q||^2 so scores match the oracle
        q2 = torch.sum(queries.float() ** 2, -1)  # [Q]
        scores = torch.where(scores > topk_lib.NEG_INF / 2,
                             scores - q2[slot_query.long()][:, None], scores)

    out_ids = index.ids[slot_cluster.long()]  # [Q·T, Vpad]
    vpad = scores.shape[-1]
    vals, ids = topk_lib.masked_topk(scores.reshape(q, n_probes * vpad), None,
                                     k, ids=out_ids.reshape(q, n_probes * vpad))
    n_passed = (scores > topk_lib.NEG_INF / 2).reshape(q, -1).sum(-1).int()
    n_scanned = (out_ids >= 0).reshape(q, -1).sum(-1).int()
    return SearchResult(vals, ids, n_scanned, n_passed)
