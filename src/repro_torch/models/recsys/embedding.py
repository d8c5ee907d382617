"""EmbeddingBag for the port: the port of ``repro.models.recsys.embedding``.

Two layouts:
  * fixed-width bags [B, L] with -1 padding (recsys histories) —
    :func:`embedding_bag`;
  * ragged multi-hot bags (flat ids + bag ids) — :func:`embedding_bag_ragged`,
    torch ``nn.EmbeddingBag`` semantics.

Lookups clamp ``-1`` to row 0 and mask that row out, as the reference does
(``jnp.take`` fills out-of-range rows; a torch gather asserts on the card,
so ids must stay below the vocabulary).  Rows are gathered with
``torch.nn.functional.embedding``: its CUDA backward sorts the ids and
accumulates each row's duplicates in order, so a training step's gradient
is the same on every run (``index_select``'s backward uses atomics).

Sharding: tables are vocab-range sharded over the mesh's ``model`` group
(:func:`sharded_embedding_bag`): each rank looks up only the ids in its
range (others give 0 rows) and an all-reduce over ``model`` assembles the
bag sums — the classic vocab-parallel embedding, with traffic [B, D]
instead of gathering table rows across ranks.  It replaces the reference's
``shard_map`` + ``psum``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import all_reduce_sum

# std of a standard normal truncated to [-2, 2]: jax.nn.initializers'
# truncated normals divide their stddev by it
_TRUNC_STD = 0.87962566103423978


def truncated_normal(gen: torch.Generator, shape, stddev: float,
                     dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.initializers.truncated_normal(stddev)``: a normal of
    deviation ``stddev`` cut at two of its deviations (so its own
    deviation is ``_TRUNC_STD · stddev``), drawn from ``gen`` on its
    device."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, std=stddev, a=-2 * stddev, b=2 * stddev,
                                generator=gen)
    return t.to(dtype)


def glorot_normal(gen: torch.Generator, shape, dtype=torch.float32
                  ) -> torch.Tensor:
    """``jax.nn.initializers.glorot_normal()``: a truncated normal whose own
    variance is 2 / (fan_in + fan_out) (the last two axes)."""
    fan = shape[-2] + shape[-1]
    return truncated_normal(gen, shape, math.sqrt(2.0 / fan) / _TRUNC_STD,
                            dtype)


def init_table(gen: torch.Generator, vocab: int, dim: int,
               dtype=torch.float32, stddev: float = 0.02) -> torch.Tensor:
    return truncated_normal(gen, (vocab, dim), stddev, dtype)


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``max(ids, 0)``: [..., D]."""
    return F.embedding(torch.clamp(ids, min=0).long(), table)


def embedding_bag(
    table: torch.Tensor,  # [V, D]
    ids: torch.Tensor,  # [..., L] int32, -1 = padding
    *,
    mode: str = "sum",
    weights: Optional[torch.Tensor] = None,  # [..., L]
) -> torch.Tensor:
    """Fixed-width bag lookup+reduce. Returns [..., D]."""
    mask = (ids >= 0).to(table.dtype)[..., None]
    rows = _lookup(table, ids)  # [..., L, D]
    if weights is not None:
        rows = rows * weights[..., None].to(table.dtype)
    rows = rows * mask
    s = torch.sum(rows, dim=-2)
    if mode == "sum":
        return s
    if mode == "mean":
        n = torch.clamp(torch.sum(mask, dim=-2), min=1.0)
        return s / n
    if mode == "max":
        neg = torch.where(mask > 0, rows, float("-inf"))
        return torch.amax(neg, dim=-2)
    raise ValueError(mode)


def _segment_sum(rows: torch.Tensor, seg: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows summed by segment id (an accumulating
    ``index_put_``, sorted on the card rather than atomic)."""
    out = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_put_((seg.long(),), rows, accumulate=True)


def embedding_bag_ragged(
    table: torch.Tensor,  # [V, D]
    flat_ids: torch.Tensor,  # [NNZ] int32
    bag_ids: torch.Tensor,  # [NNZ] int32 — which bag each id belongs to
    n_bags: int,
    *,
    mode: str = "sum",
    weights: Optional[torch.Tensor] = None,  # [NNZ]
) -> torch.Tensor:
    """Ragged (true multi-hot) bags. Returns [n_bags, D]."""
    rows = _lookup(table, flat_ids)
    valid = (flat_ids >= 0).to(table.dtype)[:, None]
    if weights is not None:
        rows = rows * weights[:, None].to(table.dtype)
    rows = rows * valid
    s = _segment_sum(rows, bag_ids, n_bags)
    if mode == "sum":
        return s
    if mode == "mean":
        n = _segment_sum(valid, bag_ids, n_bags)
        return s / torch.clamp(n, min=1.0)
    raise ValueError(mode)


def range_rows(table: torch.Tensor, ids: torch.Tensor, lo: int):
    """Rows of a table shard holding global rows ``[lo, lo + len(table))``
    at ``ids`` (-1 padding allowed): (rows [..., D], zero where an id is
    out of the range, and that validity [...])."""
    v_local = table.shape[0]
    rel = ids.long() - lo
    valid = (rel >= 0) & (rel < v_local) & (ids >= 0)
    rows = F.embedding(torch.clamp(rel, 0, v_local - 1), table)
    return rows * valid[..., None].to(rows.dtype), valid


def sharded_embedding_bag(
    table: torch.Tensor,  # [V / n_model, D]: this rank's vocab range
    ids: torch.Tensor,  # [..., L]: this rank's rows of the batch
    mesh,
    *,
    mode: str = "sum",
    device="cuda",
) -> torch.Tensor:
    """Vocab-parallel bag lookup: a local-range lookup, then an all-reduce
    over the mesh's ``model`` group.

    Rank ``r`` of the ``model`` group holds rows ``[r·V_l, (r+1)·V_l)`` of
    the global table (``V_l = table.shape[0]``); every rank of the group
    passes the same ``ids`` (its data-parallel rows).  ``mode`` is
    ``"sum"`` or ``"mean"`` (the counts are all-reduced too).  The
    gradient of a loss replicated over the group is, on each rank, its
    rows of the unsharded table's gradient.  ``table`` must live on
    ``device`` (default the card; raises where CUDA is absent).
    """
    dev = resolve_device(device)
    if table.device.type != dev.type:
        raise ValueError(f"table lives on {table.device}, asked for {dev}")
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    group = mesh.get_group("model")
    rows, valid = range_rows(table, ids,
                             mesh.get_local_rank("model") * table.shape[0])
    out = all_reduce_sum(torch.sum(rows, dim=-2), group)
    if mode == "mean":
        n = all_reduce_sum(
            torch.sum(valid.to(rows.dtype), dim=-1, keepdim=True), group)
        out = out / torch.clamp(n, min=1.0)
    return out
