"""Probe selection over the centroid table: the port of
``repro.kernels.centroid_topk.ops.probe_centroids``."""

from __future__ import annotations

import torch

from repro_torch.kernels.centroid_topk.centroid_topk import centroid_topk


def probe_centroids(queries: torch.Tensor, centroids: torch.Tensor, *, t: int,
                    metric: str = "dot"):
    """Returns (values [Q, T] f32, probe_ids [Q, T] int32): the function of
    ``centroid_topk_ref`` for any Q and K.

    The reference pads K to a multiple of its TPU block with zero centroids
    and masks their wins to id -1; where every real score is below 0 (l2
    whenever ``‖q − c‖ > ‖q‖``, or anti-aligned dot queries) those zero
    scores win and it returns -1 probes.  The CUDA kernel takes any K, so
    nothing is padded and that cannot arise here.  Empty clusters are not
    masked, as in the reference.
    """
    return centroid_topk(queries, centroids, t=t, metric=metric)
