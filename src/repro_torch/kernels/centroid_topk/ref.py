"""Plain PyTorch version of the streaming centroid top-T (the kernel's
contract): the port of ``repro.kernels.centroid_topk.ref``.

The CPU path of :func:`repro_torch.kernels.centroid_topk.centroid_topk.
centroid_topk`, and what the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.topk import top_k
from repro_torch.device import ieee_f32


def centroid_topk_ref(queries: torch.Tensor, centroids: torch.Tensor, *,
                      t: int, metric: str = "dot"):
    """Returns (values [Q, T] f32, ids [Q, T] int32): each query's T best
    centroids by ``q·c`` (dot) or ``2·q·c − ‖c‖²`` (l2), computed in f32;
    ties go to the lower centroid id."""
    q32 = queries.float()
    c32 = centroids.float()
    with ieee_f32():
        scores = q32 @ c32.T
    if metric == "l2":
        scores = 2.0 * scores - torch.sum(c32 * c32, -1)[None, :]
    vals, ids = top_k(scores, t)
    return vals, ids.int()
