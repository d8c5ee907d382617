"""Top-k primitives and the distributed merge tree (paper §4.4 step 5):
the port of ``repro.core.topk``.

``torch.topk`` does not keep ``lax.top_k``'s tie order (the lowest index
wins among equal values), so every selection here is a stable descending
sort cut to ``k``: equal values keep their input order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

# Finite stand-in for -inf: survives bf16 casts and keeps top-k total-ordered.
NEG_INF = -3.0e38


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: (values, int64 indices), ties to
    the lowest index."""
    if k > x.shape[-1]:
        raise ValueError(f"k={k} exceeds the axis length {x.shape[-1]}")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_topk(scores: torch.Tensor, mask: Optional[torch.Tensor], k: int,
                ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis with invalid entries masked out.

    Returns (values [..., k] f32, ids [..., k] int32).  Masked-out slots that
    survive into the top-k carry value NEG_INF and id -1.
    """
    s = scores.float()
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    vals, idx = top_k(s, k)
    if ids is not None:
        out_ids = torch.gather(ids.expand(s.shape), -1, idx)
    else:
        out_ids = idx
    out_ids = torch.where(vals > NEG_INF / 2, out_ids.int(), -1)
    return vals, out_ids.int()


def merge_topk(a: Tuple[torch.Tensor, torch.Tensor],
               b: Tuple[torch.Tensor, torch.Tensor], k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Monoid combine: best k of the union of two candidate sets (``a``
    wins ties)."""
    vals = torch.cat([a[0], b[0]], dim=-1)
    ids = torch.cat([a[1], b[1]], dim=-1)
    return masked_topk(vals, None, k, ids=ids)


def merge_topk_many(vals: torch.Tensor, ids: torch.Tensor, k: int, axis: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Folds N candidate sets along ``axis`` down to one top-k per row.

    The same balanced tree of :func:`merge_topk` combines, in the same
    concat order, as the reference: that order decides which id wins a tie.
    """
    vals = torch.movedim(vals, axis, -2)  # [..., N, k]
    ids = torch.movedim(ids, axis, -2)
    n = vals.shape[-2]
    while n > 1:
        half = n // 2
        a = (vals[..., :half, :], ids[..., :half, :])
        b = (vals[..., half: 2 * half, :], ids[..., half: 2 * half, :])
        mv, mi = merge_topk(a, b, k)
        if n % 2:
            vals = torch.cat([mv, vals[..., -1:, :]], dim=-2)
            ids = torch.cat([mi, ids[..., -1:, :]], dim=-2)
        else:
            vals, ids = mv, mi
        n = vals.shape[-2]
    return vals[..., 0, :], ids[..., 0, :]


def merge_topk_axis(vals: torch.Tensor, ids: torch.Tensor, k: int, group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-gathers ``[..., k]`` candidate lists over the process group
    ``group`` (one mesh axis) and re-selects the best ``k`` on every member.

    The gathered lists are laid out member 0's first, in group-rank order
    (the member's coordinate along the mesh axis), as the reference's
    ``all_gather`` → ``moveaxis(0, -2)`` → reshape: that order decides which
    id wins a tie.  Payload per stage is ``[axis, ..., k]``.
    """
    n = dist.get_world_size(group)
    gv = [torch.empty_like(vals) for _ in range(n)]
    gi = [torch.empty_like(ids) for _ in range(n)]
    # the list form: gloo does not assure all_gather_into_tensor on CUDA
    dist.all_gather(gv, vals.contiguous(), group=group)
    dist.all_gather(gi, ids.contiguous(), group=group)
    return masked_topk(torch.cat(gv, -1), None, k, ids=torch.cat(gi, -1))


def topk_tree_merge(vals: torch.Tensor, ids: torch.Tensor, k: int, groups
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical merge over the mesh axes' process groups, in the order
    given (``model → data → pod``)."""
    for group in groups:
        vals, ids = merge_topk_axis(vals, ids, k, group)
    return vals, ids
