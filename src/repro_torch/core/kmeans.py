"""Nearest-centroid assignment (paper §4.2 step 2): the port of the two
functions of ``repro.core.kmeans`` that serving needs.  Training k-means
itself is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def pairwise_neg_dist2(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``-(||x - c||^2)`` up to a per-row constant: ``2 x·c - ||c||^2``,
    [B, K] f32."""
    x = x.float()
    c = c.float()
    return 2.0 * (x @ c.T) - torch.sum(c * c, dim=-1)[None, :]


def assign(x: torch.Tensor, centroids: torch.Tensor, *,
           chunk: Optional[int] = None) -> torch.Tensor:
    """Nearest-centroid assignment, int32 [N]; ties go to the lower
    centroid id (``argmax`` returns the first maximum).

    ``chunk`` bounds the ``[chunk, K]`` score intermediate for large N·K.
    """
    if chunk is None or x.shape[0] <= chunk:
        return torch.argmax(pairwise_neg_dist2(x, centroids), dim=-1).int()
    return torch.cat([
        torch.argmax(pairwise_neg_dist2(x[i:i + chunk], centroids), dim=-1)
        for i in range(0, x.shape[0], chunk)
    ]).int()
