"""The production layouts of the dry-run's cells: what one rank of a mesh
runs on its local shards, with the collectives that GSPMD inserts for the
reference written out (``launch.specs`` builds the cells from these).

Gradient conventions (``launch.mesh``): a weight gathered over a
data-parallel axis (an FSDP shard) reduce-scatters its gradient
(:func:`~repro_torch.launch.mesh.gather_dim`); a ``model`` shard stays a
shard (Megatron tensor parallelism, ``models.transformer.
TensorParallel``); a weight replicated over a data-parallel axis has its
gradient all-reduced over it after the backward (:func:`sync_grads`), as
``DistributedDataParallel`` does.  The loss is the mean over the
data-parallel ranks' local means.

Everything here is eager PyTorch over ``torch.distributed`` process groups,
so the same code runs a real step on the card (a one-rank ``(1, 1)`` mesh,
``chip_smoke.py``) and a fake one under ``FakeTensorMode`` over the fake
process group (``launch.dryrun``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch.launch.mesh import (
    all_gather_dim,
    all_reduce,
    all_reduce_sum,
    axis_size,
    gather_dim,
    reduce_scatter_dim,
)
from repro_torch.train.optimizer import split_order
from repro_torch.train.tree import (
    leaves,
    leaves_with_paths,
    tree_map,
    unflatten_like,
)

# the stacked layer trees of the LM ([L, ...] leaves, one layer gathered at
# a time) and the routed-expert leaves that the MoE layer gathers itself
_STACKS = ("blocks", "moe_blocks", "blocks_local", "blocks_global",
           "blocks_tail", "block")
_EXPERTS = ("wg", "wu", "wd")


# ------------------------------------------------------------- groups ---
def axes_group(mesh, axes: Sequence[str]):
    """The process group over ``axes`` of ``mesh`` (None for none): one
    axis's group, or the default group where ``axes`` are every axis (a
    rank's index over them, row-major, is then its global rank)."""
    axes = tuple(axes)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if tuple(mesh.mesh_dim_names) == axes:
        if dist.get_world_size() != math.prod(mesh.shape):
            raise ValueError("every mesh axis is the default group only "
                             "where the mesh holds every rank")
        return dist.group.WORLD
    raise NotImplementedError(f"a group over the axes {axes}")


def _sum_over(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for a in axes:
        x = all_reduce(x, mesh.get_group(a))
    return x


def _gather(x: torch.Tensor, spec, mesh, sum_axes: Sequence[str],
            offset: int = 0, keep: Sequence[str] = ()) -> torch.Tensor:
    """``x`` (a local shard of ``spec``, leading ``offset`` dims dropped)
    all-gathered over every mesh axis that splits it but ``keep``, the
    minor axis first (``optimizer.split_order``: an ``OrderedShard``'s
    order, else the mesh's), so the chunks land in the order the
    reference's ``NamedSharding`` lays them out."""
    names = list(mesh.mesh_dim_names)
    for i in reversed(split_order(spec.placements)):
        p = spec.placements[i]
        if names[i] not in keep:
            group = mesh.get_group(names[i])
            fn = gather_dim if names[i] in sum_axes else all_gather_dim
            x = fn(x, group, p.dim - offset)
    return x


# ------------------------------------------------------------------ LM ---
class _GatheredStack:
    """A stacked ``[L, ...]`` leaf whose layer ``i`` is all-gathered over
    its FSDP axes when the layer takes it (``transformer.layer``), so one
    layer's gathered weights live at a time; routed experts stay local
    (the expert-parallel MoE gathers their FSDP shards itself)."""

    def __init__(self, local, spec, mesh, sum_axes, keep, gather: bool):
        self.local, self.spec, self.mesh = local, spec, mesh
        self.sum_axes, self.keep, self.gather = sum_axes, keep, gather

    @property
    def shape(self):
        return self.spec.shape

    def __getitem__(self, i):
        x = self.local[i]
        if not self.gather:
            return x
        return _gather(x, self.spec, self.mesh, self.sum_axes, offset=1,
                       keep=self.keep)


def lm_view(params, params_abs, mesh, sum_axes: Sequence[str],
            tp_axis: str = "model"):
    """The parameter tree the LM's functions take, from this rank's local
    shards: every leaf all-gathered over the axes that split it but
    ``tp_axis`` (its tensor-parallel shard stays, ``transformer.
    TensorParallel``), top-level leaves now and stacked layer leaves at
    their layer; routed experts local.  ``sum_axes``: the axes whose
    gathers sum the gradient (the data-parallel FSDP axes of a train
    step)."""
    out = []
    keep = (tp_axis,)
    specs = dict(leaves_with_paths(params_abs))
    for path, x in leaves_with_paths(params):
        spec = specs[path]
        stacked = any(p in _STACKS for p in path)
        expert = "moe" in path and path[-1] in _EXPERTS
        if stacked:
            out.append(_GatheredStack(x, spec, mesh, sum_axes, keep,
                                      gather=not expert))
        else:
            out.append(_gather(x, spec, mesh, sum_axes, keep=keep))
    return unflatten_like(params, out)


def dp_mean(loss: torch.Tensor, mesh, dp: Sequence[str]) -> torch.Tensor:
    """The mean of the data-parallel ranks' local means (equal shares)."""
    n = 1
    for a in dp:
        loss = all_reduce_sum(loss, mesh.get_group(a))
        n *= axis_size(mesh, a)
    return loss / torch.tensor(float(n), device=loss.device)


def sync_grads(grads: list, specs: list, mesh, dp: Sequence[str]) -> list:
    """Every gradient all-reduced over each data-parallel axis that does
    not split its leaf (the axes that split it summed it already)."""
    names = tuple(mesh.mesh_dim_names)
    out = []
    for g, spec in zip(grads, specs):
        split = spec.sharded_axes(names)
        out.append(_sum_over(g, mesh, [a for a in dp if a not in split]))
    return out


def global_norm(grads: list, specs: list, mesh) -> torch.Tensor:
    """The norm of the global gradient from local shards: each leaf's
    squares divided by the ranks holding the same shard, summed over every
    rank."""
    names = tuple(mesh.mesh_dim_names)
    dev = grads[0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for g, spec in zip(grads, specs):
        copies = math.prod(
            n for n, p in zip(spec.mesh_shape, spec.placements)
            if not isinstance(p, Shard))
        total = total + torch.sum(torch.square(g.float())) / torch.tensor(
            float(copies), device=dev)
    return torch.sqrt(_sum_over(total, mesh, names))


def clip(grads: list, specs: list, mesh, max_norm: float):
    g = global_norm(grads, specs, mesh)
    one = torch.tensor(1.0, dtype=torch.float32, device=g.device)
    scale = torch.minimum(one, torch.tensor(max_norm, device=g.device)
                          / torch.clamp(g, min=1e-9))
    return [x * scale.to(x.dtype) for x in grads], g


def donate_(args, new) -> None:
    """Writes ``new`` into the argument tensors ``args`` in place (the
    counterpart of the reference's donated buffers)."""
    for a, b in zip(leaves(args), leaves(new)):
        a.copy_(b)


def _live(params):
    """``params`` as fresh autograd leaves over the same storage."""
    return tree_map(lambda x: x.detach().requires_grad_(
        x.is_floating_point()), params)


def _grads(loss, live) -> list:
    xs = leaves(live)
    need = [x for x in xs if x.requires_grad]
    got = iter(torch.autograd.grad(loss, need, allow_unused=True))
    out = []
    for x in xs:
        g = next(got) if x.requires_grad else None
        out.append(torch.zeros_like(x) if g is None else g)
    return out


def lm_train_step(params, opt_state, tokens, labels, *, cfg, opt_cfg,
                  params_abs, opt_abs, mesh, dp):
    """One LM train step of the reference's cell (loss, global-norm clip
    to 1.0, the optimizer at lr 1e-4) on this rank's shards; the new
    parameters and state are written into the arguments."""
    from repro_torch.models.transformer import TensorParallel, lm_loss
    from repro_torch.train.optimizer import adafactor_update, adamw_update

    fsdp = (cfg.fsdp_axis,) if cfg.fsdp_axis else ()
    live = _live(params)
    view = lm_view(live, params_abs, mesh, fsdp)
    loss, _ = lm_loss(view, cfg, tokens, labels, mesh=mesh, dp_axes=dp,
                      tp=TensorParallel(mesh))
    loss = dp_mean(loss, mesh, dp)
    specs = leaves(params_abs)
    grads = sync_grads(_grads(loss, live), specs, mesh, dp)
    with torch.no_grad():
        grads, gnorm = clip(grads, specs, mesh, 1.0)
        lr = torch.tensor(1e-4, dtype=torch.float32, device=tokens.device)
        grads = unflatten_like(params, grads)
        if opt_cfg.name == "adafactor":
            new_p, new_s = adafactor_update(
                grads, opt_state, params, lr, opt_cfg, shapes=params_abs,
                psum=lambda x, spec, dims: _sum_over(x, mesh, [
                    a for a, p in zip(mesh.mesh_dim_names, spec.placements)
                    if isinstance(p, Shard) and p.dim in dims]))
        else:
            new_p, new_s = adamw_update(grads, opt_state, params, lr,
                                        opt_cfg)
        donate_(params, new_p)
        donate_(opt_state, new_s)
    return params, opt_state, loss.detach(), gnorm


# ----------------------------------------------------------------- GNN ---
def gnn_train_step(params, opt_state, g, labels, *, cfg, opt_cfg, mesh):
    """One DimeNet train step with edges and triplets split over every
    rank (``models.gnn.forward(edge_group=...)``); the loss is the whole
    graph's, the same on every rank, and so are the gradients."""
    from repro_torch.models.gnn.dimenet import loss_fn
    from repro_torch.train.optimizer import adamw_update

    group = axes_group(mesh, tuple(mesh.mesh_dim_names))
    live = _live(params)
    loss, _ = loss_fn(live, cfg, g, labels, edge_group=group)
    grads = _grads(loss, live)
    with torch.no_grad():
        lr = torch.tensor(1e-3, dtype=torch.float32, device=labels.device)
        new_p, new_s = adamw_update(unflatten_like(params, grads), opt_state,
                                    params, lr, opt_cfg)
        donate_(params, new_p)
        donate_(opt_state, new_s)
    return params, opt_state, loss.detach()


# -------------------------------------------------------------- recsys ---
class ShardedBags:
    """``embedding_bag`` for the recsys models where the big tables are
    split by row over every rank (rank r holds rows ``[r·V_l, (r+1)·V_l)``).

    A lookup all-gathers the ids over the data axes (every rank then holds
    the whole batch's), takes its own rows (a masked local gather), and
    reduce-scatters the partial bags back to the batch's data-parallel
    split, summed over ``model`` by an all-reduce.  The gradient of a
    table is its rows of the whole batch's.  Other tables are looked up
    locally (``embedding_bag``).
    """

    def __init__(self, params, params_abs, mesh, dp: Sequence[str]):
        names = tuple(mesh.mesh_dim_names)
        self.mesh, self.dp = mesh, tuple(dp)
        self.sharded = {
            id(x) for x, spec in zip(leaves(params), leaves(params_abs))
            if spec.sharded_axes(names)}
        self.world = axes_group(mesh, names)
        self.rank = dist.get_rank(self.world)
        self.rest = tuple(a for a in names if a not in self.dp)

    def __call__(self, table, ids, *, mode="sum", weights=None):
        from repro_torch.models.recsys.embedding import (
            embedding_bag, range_rows,
        )

        if id(table) not in self.sharded:
            return embedding_bag(table, ids, mode=mode, weights=weights)
        if weights is not None or mode not in ("sum", "mean"):
            raise NotImplementedError("row-sharded bags take sum or mean")
        mesh = self.mesh
        ids_all = ids
        for a in reversed(self.dp):
            ids_all = all_gather_dim(ids_all, mesh.get_group(a), 0)
        rows, _ = range_rows(table, ids_all, self.rank * table.shape[0])
        s = torch.sum(rows, dim=-2)
        if self.dp:
            for a in self.dp:
                s = reduce_scatter_dim(s, mesh.get_group(a), 0)
            for a in self.rest:
                s = all_reduce_sum(s, mesh.get_group(a))
        else:
            s = all_reduce_sum(s, self.world)
        if mode == "mean":
            n = torch.sum((ids >= 0).to(s.dtype), dim=-1, keepdim=True)
            s = s / torch.clamp(n, min=1.0)
        return s


def recsys_forward(params, batch, *, cfg, params_abs, mesh, dp):
    from repro_torch.models.recsys.models import forward

    return forward(params, cfg, batch,
                   bag=ShardedBags(params, params_abs, mesh, dp))


def recsys_train_step(params, opt_state, batch, *, cfg, opt_cfg, params_abs,
                      mesh, dp):
    """One recsys train step (AdamW at lr 1e-3) on this rank's shards."""
    from repro_torch.models.recsys.models import loss_fn
    from repro_torch.train.optimizer import adamw_update

    live = _live(params)
    bags = ShardedBags(live, params_abs, mesh, dp)
    loss, _ = loss_fn(live, cfg, batch, bag=bags)
    loss = dp_mean(loss, mesh, dp)
    grads = sync_grads(_grads(loss, live), leaves(params_abs), mesh, dp)
    with torch.no_grad():
        lr = torch.tensor(1e-3, dtype=torch.float32, device=loss.device)
        new_p, new_s = adamw_update(unflatten_like(params, grads), opt_state,
                                    params, lr, opt_cfg)
        donate_(params, new_p)
        donate_(opt_state, new_s)
    return params, opt_state, loss.detach()


def recsys_retrieval(params, batch, candidates, *, cfg, params_abs, mesh,
                     dp, k: int):
    """``retrieval_scores`` over candidates split by row over every rank:
    each rank's top-k of its rows, all-gathered, then the top-k of those
    (ties to the lower candidate row, as one ``lax.top_k``)."""
    from repro_torch.core import topk as topk_lib
    from repro_torch.models.recsys.models import user_embedding

    bags = ShardedBags(params, params_abs, mesh, dp)
    u = user_embedding(params, cfg, batch, bag=bags)  # [B, D]
    scores = u.float() @ candidates.float().T
    vals, idx = topk_lib.top_k(scores, k)
    idx = idx + bags.rank * candidates.shape[0]
    vals = all_gather_dim(vals, bags.world, 1)
    idx = all_gather_dim(idx, bags.world, 1)
    top, pos = topk_lib.top_k(vals, k)
    return top, torch.gather(idx, 1, pos).int()


# ----------------------------------------------------------- paper-ivf ---
def ivf_search_step(centroids, vectors, attrs, ids, counts, scales, queries,
                    lo, hi, shard_ok, *, mesh, quantized: bool,
                    p_cap_slack: float, q_total: int, n_clusters: int,
                    k: int, n_probes: int):
    """The paper's §4.4 search of one rank over its clusters
    (``make_sharded_search`` with the per-probe backend over every mesh
    axis): probe selection by ``centroid_topk``, the per-probe
    ``filtered_scan``, the tree merge.  Returns (scores, ids, n_scanned)."""
    from repro_torch.core.distributed import (
        ShardedSearchConfig, make_sharded_search,
    )
    from repro_torch.core.filters import FilterSpec
    from repro_torch.core.hybrid import HybridSpec
    from repro_torch.core.ivf import IVFFlatIndex

    cfg = ShardedSearchConfig(k=k, n_probes=n_probes, p_cap_slack=p_cap_slack,
                              backend="pallas")
    search, _ = make_sharded_search("dot", q_total=q_total,
                                    n_clusters=n_clusters, cfg=cfg, mesh=mesh,
                                    device=vectors.device)
    index = IVFFlatIndex(
        spec=HybridSpec(dim=vectors.shape[-1], n_attrs=attrs.shape[-1]),
        centroids=centroids, vectors=vectors, attrs=attrs, ids=ids,
        counts=counts, norms=None, scales=scales if quantized else None)
    res = search(index, queries, FilterSpec(lo=lo, hi=hi), shard_ok)
    return res.scores, res.ids, res.n_scanned
