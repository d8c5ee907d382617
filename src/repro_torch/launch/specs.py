"""Cell registry: every assigned (architecture × input-shape) as one rank's
step over local shards, with abstract arguments and production placements;
the port of ``repro.launch.specs``.

40 assigned cells + the paper's own search step (``paper-ivf ×
search_1b``) and the reference's §Perf variants, 46 rows in all.  Skips
(the reference's): long_500k for pure full-attention archs.

An argument is an :class:`ArgSpec`: a global shape, a dtype and DTensor
placements over the mesh (``train.optimizer.to_placements`` of the
reference's ``PartitionSpec``).  Its :meth:`ArgSpec.local_shape` is the
rank's shard, as ``NamedSharding.shard_shape`` gives it.  A cell's ``fn``
is the step one rank runs on its local shards (``launch.dryrun``
materializes them as fake tensors): the collectives that GSPMD inserts for
the reference are explicit here.

  * paper-ivf: the sharded search over every mesh axis
    (``core.distributed.make_sharded_search``), its per-probe backend (the
    reference's ``xla_map`` / ``xla_vmap``), so ``centroid_topk`` and the
    per-probe ``filtered_scan`` are on the path.
  * recsys: tables of >= 100,000 rows split by row over every rank
    (``launch.layouts.ShardedBags``), the batch over the data axes, the
    dense weights replicated (their gradients all-reduced).
  * DimeNet: edges and triplets split over every rank, nodes replicated
    (``models.gnn.forward(edge_group=...)``).
  * LM: parameters and optimizer state laid out by ``param_pspecs`` and
    the optimizer's state placements, tokens over the data axes.  FSDP
    shards are all-gathered at their layer (``launch.layouts.lm_view``),
    the ``model`` shards stay: the step runs Megatron tensor parallelism
    (``models.transformer.TensorParallel``) with the expert-parallel MoE
    (``_moe_ffn``) over the mesh.  Decode caches are split by sequence as
    the reference's ``kv_spec`` splits them, and attention over them
    combines partial softmaxes across the split.

Two variants per cell, with the reference's config changes: ``exec``
(``remat`` on, blocked attention) and ``cost`` (no remat, one attention
block).  Eager tracing sees every layer, so neither needs probes;
:func:`lm_probe_plan` is kept for the reference's linear synthesis.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (
    bst as bst_cfg,
    chatglm3_6b,
    deepseek_moe_16b,
    deepseek_v3_671b,
    dimenet as dimenet_cfg,
    din as din_cfg,
    gemma3_12b,
    gemma3_27b,
    sasrec as sasrec_cfg,
    wide_deep as wide_deep_cfg,
)
from repro_torch.launch.mesh import dp_axes, production_shape
from repro_torch.train.optimizer import to_placements
from repro_torch.train.tree import leaves, tree_map

LM_ARCHS = {
    "deepseek-v3-671b": deepseek_v3_671b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "gemma3-12b": gemma3_12b,
    "gemma3-27b": gemma3_27b,
    "chatglm3-6b": chatglm3_6b,
}
RECSYS_ARCHS = {
    "din": din_cfg,
    "sasrec": sasrec_cfg,
    "bst": bst_cfg,
    "wide-deep": wide_deep_cfg,
}

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")

ALL_ARCHS = (
    list(LM_ARCHS) + ["dimenet"] + list(RECSYS_ARCHS) + ["paper-ivf"]
)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str  # train | prefill | decode | serve | search
    fn: Callable  # one rank's step over local shards
    args: tuple  # trees of ArgSpec
    meta: Dict[str, Any]
    donate: Tuple[int, ...] = ()
    skip_reason: Optional[str] = None


def list_cells() -> list:
    """All (arch, shape) pairs, with skip markers."""
    out = []
    for a in LM_ARCHS:
        for s in LM_SHAPES:
            skip = None
            if s == "long_500k" and not LM_ARCHS[a].config().sub_quadratic:
                skip = ("pure full attention on every layer (no windowed/"
                        "linear component) — long_500k skipped per DESIGN.md §6")
            out.append((a, s, skip))
    # §Perf hillclimb variants (EXPERIMENTS.md) — collective-bound MoE trains
    out.append(("deepseek-v3-671b", "train_4k_moescatter", None))
    out.append(("deepseek-moe-16b", "train_4k_moescatter", None))
    for s in GNN_SHAPES:
        out.append(("dimenet", s, None))
    out.append(("dimenet", "ogb_products_bf16", None))  # §Perf variant
    for a in RECSYS_ARCHS:
        for s in RECSYS_SHAPES:
            out.append((a, s, None))
    out.append(("paper-ivf", "search_1b", None))
    # §Perf hillclimb variants of the paper cell (EXPERIMENTS.md)
    out.append(("paper-ivf", "search_1b_sq8", None))
    out.append(("paper-ivf", "search_1b_sq8_tight", None))
    return out


# ============================================================ meshes ===
class MeshSpec(NamedTuple):
    """A mesh's axis names and sizes, without a process group: enough to
    build a cell's arguments (``launch.mesh.make_production_mesh`` gives
    the ``DeviceMesh`` its step runs on)."""

    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def production_mesh_spec(multi_pod: bool) -> MeshSpec:
    shape, axes = production_shape(multi_pod)
    return MeshSpec(axes, shape)


def mesh_spec(mesh) -> MeshSpec:
    """A ``DeviceMesh`` or ``MeshSpec`` as a ``MeshSpec``."""
    return MeshSpec(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _size(mesh, axes) -> int:
    names = list(mesh.mesh_dim_names)
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return math.prod(mesh.shape[names.index(a)] for a in axes)


# ========================================================= arguments ===
class ArgSpec:
    """An abstract argument: its global shape and dtype, and its DTensor
    placements over a mesh of ``mesh_shape`` (one a mesh dimension).  A
    leaf of the training trees (``train.tree``), like a tensor."""

    __slots__ = ("shape", "dtype", "placements", "mesh_shape")

    def __init__(self, shape, dtype, placements, mesh_shape):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = dtype
        self.placements = tuple(placements)
        self.mesh_shape = tuple(mesh_shape)

    def __repr__(self):
        return (f"ArgSpec({self.shape}, {self.dtype}, {self.placements}, "
                f"{self.mesh_shape})")

    def local_shape(self) -> Tuple[int, ...]:
        """This rank's shard (rank 0's, the largest): each mesh dimension
        that shards a tensor dimension divides it, rounding up."""
        out = list(self.shape)
        for size, p in zip(self.mesh_shape, self.placements):
            if isinstance(p, Shard):
                out[p.dim] = -(-out[p.dim] // size)
        return tuple(out)

    def local_nbytes(self) -> int:
        return math.prod(self.local_shape()) * self.dtype.itemsize

    def sharded_axes(self, names: Sequence[str]) -> Tuple[str, ...]:
        """The mesh axes (of ``names``) that split this argument."""
        return tuple(a for a, p in zip(names, self.placements)
                     if isinstance(p, Shard))


def arg(shape, dtype, mesh, spec=()) -> ArgSpec:
    """An ``ArgSpec`` from a ``PartitionSpec``-shaped ``spec``."""
    m = mesh_spec(mesh)
    return ArgSpec(shape, dtype, to_placements(spec, m.mesh_dim_names),
                   m.shape)


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(p, (Shard, Replicate)) for p in x)


def _arg_tree(shapes, placements, mesh):
    """A tree of ``ArgSpec`` from a tree of fake tensors (or ``TensorSpec``)
    and a matching tree of placement tuples."""
    m = mesh_spec(mesh)
    if _is_placements(placements):
        return ArgSpec(tuple(shapes.shape), shapes.dtype, placements, m.shape)
    if isinstance(placements, dict):
        return {k: _arg_tree(shapes[k], placements[k], mesh)
                for k in placements}
    if isinstance(placements, tuple) and hasattr(placements, "_fields"):
        return type(placements)(*(_arg_tree(s, p, mesh)
                                  for s, p in zip(shapes, placements)))
    if isinstance(placements, (list, tuple)):
        return type(placements)(_arg_tree(s, p, mesh)
                                for s, p in zip(shapes, placements))
    raise TypeError(f"not a placement tree: {type(placements)}")


def _replicated_like(tree, mesh):
    n = len(mesh_spec(mesh).shape)
    return tree_map(lambda _: (Replicate(),) * n, tree)


def arg_leaves(args) -> list:
    """The cell's ``ArgSpec`` leaves in the reference's flattening order
    (a graph batch's ``n_graphs`` is static, not an argument)."""
    return [a for a in leaves(args) if isinstance(a, ArgSpec)]


def argument_bytes(args) -> int:
    """Per-rank argument bytes: the sum of the local shards."""
    return sum(a.local_nbytes() for a in arg_leaves(args))


class _HostReadsAsZero(TorchDispatchMode):
    """Reads of a tensor's value on the host (``.item()``, ``if t:``) give
    0 (False): an initializer's resampling loop then ends at once, which
    changes no shape."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            return False if args[0].dtype == torch.bool else 0
        return func(*args, **(kwargs or {}))


class Shape:
    """A tensor's shape and dtype (the reference's ``ShapeDtypeStruct``);
    a leaf of the training trees."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape, self.dtype = tuple(shape), dtype


def fake_shapes(fn, *a, **kw):
    """``fn``'s output tree as ``Shape`` leaves, run on fake tensors (no
    memory; ``Shape`` leaves of the arguments become empty fake tensors):
    the counterpart of the reference's ``jax.eval_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake(x):
        return (torch.empty(x.shape, dtype=x.dtype)
                if isinstance(x, Shape) else x)

    with FakeTensorMode(), _HostReadsAsZero():
        out = fn(*tree_map(fake, list(a)), **kw)
        return tree_map(lambda t: Shape(t.shape, t.dtype)
                        if isinstance(t, torch.Tensor) else t, out)


def _cpu_gen():
    return torch.Generator("cpu").manual_seed(0)


# =============================================================== LM cells ===
def _lm_override(cfg, layers: Optional[Tuple[int, ...]]):
    """Builds a reduced-depth probe config (same width, fewer layers).

    MoE archs: layers=(n_dense, n_moe); dense archs: layers=(n_layers,).
    """
    if layers is None:
        return cfg
    if cfg.moe is not None:
        nd, nm = layers
        return dataclasses.replace(
            cfg, n_layers=nd + nm,
            moe=dataclasses.replace(cfg.moe, first_dense_layers=nd),
        )
    (nl,) = layers
    return dataclasses.replace(cfg, n_layers=nl)


def _lm_param_shapes(cfg):
    """The parameter tree's shapes (the fields that set no shape, such as
    the parallel plan and the variant's switches, normalized away so that
    the cells of one architecture share one evaluation)."""
    return _lm_param_shapes_of(dataclasses.replace(
        cfg, remat=True, attn_block_k=1024, scan_unroll=False,
        fsdp_axis="data", moe_ep_axes=("model",), moe_combine="psum"))


@functools.lru_cache(maxsize=16)
def _lm_param_shapes_of(cfg):
    from repro_torch.models.transformer import init_params

    return fake_shapes(lambda: init_params(_cpu_gen(), cfg, device="cpu"))


def _lm_train_cell(arch: str, mesh, variant: str,
                   layers: Optional[Tuple[int, ...]] = None,
                   moe_combine: str = "psum") -> Cell:
    from repro_torch.launch import layouts
    from repro_torch.models.transformer import param_pspecs
    from repro_torch.train.optimizer import (
        OptimizerConfig, adafactor_init, adafactor_state_pspecs, adamw_init,
        adamw_state_pspecs,
    )

    cfg = LM_ARCHS[arch].config()
    b, s = 256, 4096
    if variant == "cost":
        cfg = dataclasses.replace(cfg, scan_unroll=True, attn_block_k=s,
                                  remat=False)
    cfg = dataclasses.replace(_lm_override(cfg, layers),
                              moe_combine=moe_combine)
    dp = dp_axes(mesh)
    names = mesh_spec(mesh).mesh_dim_names
    # 671B needs factored optimizer state to fit (see train/optimizer.py)
    opt_name = "adafactor" if cfg.n_params() > 1e11 else "adamw"
    opt_cfg = OptimizerConfig(name=opt_name, weight_decay=0.0)

    params_shape = _lm_param_shapes(cfg)
    pspecs = param_pspecs(cfg, names)
    if opt_name == "adafactor":
        opt_shape = fake_shapes(adafactor_init, params_shape, opt_cfg)
        opt_pspecs = adafactor_state_pspecs(pspecs, params_shape, opt_cfg)
    else:
        opt_shape = fake_shapes(adamw_init, params_shape)
        opt_pspecs = adamw_state_pspecs(pspecs)
    params_abs = _arg_tree(params_shape, pspecs, mesh)
    opt_abs = _arg_tree(opt_shape, opt_pspecs, mesh)
    tok = arg((b, s), torch.int32, mesh, (dp, None))

    def train_step(params, opt_state, tokens, labels):
        return layouts.lm_train_step(
            params, opt_state, tokens, labels, cfg=cfg, opt_cfg=opt_cfg,
            params_abs=params_abs, opt_abs=opt_abs, mesh=mesh, dp=dp)

    tokens_total = b * s
    n_layer_flops = 6 * cfg.n_active_params() * tokens_total
    return Cell(
        arch, "train_4k", "train", train_step,
        (params_abs, opt_abs, tok, tok),
        meta=dict(
            model_flops=float(n_layer_flops),
            tokens=tokens_total,
            loop_trip_counts={"dense": cfg.n_dense_layers,
                              "moe": cfg.n_moe_layers},
            optimizer=opt_name,
        ),
        donate=(0, 1),
    )


def _lm_prefill_cell(arch: str, mesh, variant: str,
                     layers: Optional[Tuple[int, ...]] = None) -> Cell:
    from repro_torch.launch import layouts
    from repro_torch.models.decoding import prefill
    from repro_torch.models.transformer import param_pspecs

    cfg = LM_ARCHS[arch].config()
    b, s = 32, 32768
    if variant == "cost":
        cfg = dataclasses.replace(cfg, scan_unroll=True, attn_block_k=4096,
                                  remat=False)
    cfg = _lm_override(cfg, layers)
    dp = dp_axes(mesh)
    names = mesh_spec(mesh).mesh_dim_names

    params_abs = _arg_tree(_lm_param_shapes(cfg), param_pspecs(cfg, names),
                           mesh)

    @torch.no_grad()
    def prefill_step(params, tokens):
        from repro_torch.models.transformer import TensorParallel

        tp = TensorParallel(mesh)
        view = layouts.lm_view(params, params_abs, mesh, dp)
        logits, cache = prefill(view, cfg, tokens, s_max=s, mesh=mesh,
                                dp_axes=dp, tp=tp)
        # last-token logits (gathered over the vocabulary) + decode cache
        return tp.gather(logits[:, -1, :], -1), cache

    tok = arg((b, s), torch.int32, mesh, (dp, None))
    return Cell(
        arch, "prefill_32k", "prefill", prefill_step, (params_abs, tok),
        meta=dict(
            model_flops=float(2 * cfg.n_active_params() * b * s),
            tokens=b * s,
            loop_trip_counts={"layers": cfg.n_layers},
        ),
    )


def _lm_decode_cell(arch: str, shape: str, mesh, variant: str,
                    layers: Optional[Tuple[int, ...]] = None,
                    batch: Optional[int] = None) -> Cell:
    from repro_torch.launch import layouts
    from repro_torch.models.decoding import (
        cache_spec, decode_layout, decode_step,
    )
    from repro_torch.models.transformer import param_pspecs

    cfg = LM_ARCHS[arch].config()
    cfg = _lm_override(cfg, layers)
    if shape == "decode_32k":
        b, s_max = 128, 32768
    else:  # long_500k
        b, s_max = 1, 524288
    b = b if batch is None else batch
    m = mesh_spec(mesh)
    dp = dp_axes(mesh)
    # serving plan: no FSDP regather per token; 256-expert archs widen EP
    # over ("model", "data"), model major as the reference's spec
    # (to_placements makes them OrderedShard; moe.ep_rank linearises so)
    ep = (("model", "data")
          if (cfg.moe and cfg.moe.n_routed % (16 * 16) == 0)
          else ("model",))
    cfg = dataclasses.replace(cfg, fsdp_axis=None, moe_ep_axes=ep,
                              remat=False)
    if variant == "cost":
        cfg = dataclasses.replace(cfg, scan_unroll=True)

    pspecs = param_pspecs(cfg, m.mesh_dim_names)
    params_shape = _lm_param_shapes(cfg)
    if cfg.sub_quadratic:  # decode layout re-lays the blocks
        params_shape = fake_shapes(decode_layout, params_shape, cfg)
        blk = pspecs.pop("blocks")
        pspecs["blocks_local"] = blk
        pspecs["blocks_global"] = blk
        if "blocks_tail" in params_shape:
            pspecs["blocks_tail"] = blk
    params_abs = _arg_tree(params_shape, pspecs, mesh)

    # cache shardings: batch over dp when divisible, KV length over the rest
    cspec = cache_spec(cfg, b, s_max)
    n_dp = _size(m, dp)
    b_axes = dp if b % n_dp == 0 else None
    s_axes = (("model",) if b_axes is not None
              else tuple(m.mesh_dim_names))  # B=1: KV length over everything
    n_s = _size(m, s_axes)

    def kv_spec(leaf):
        # [n_stack, B, S_cache, ...] — shard S_cache only if divisible
        s_ax = s_axes if leaf.shape[2] % n_s == 0 else None
        rest = (None,) * (len(leaf.shape) - 3)
        return arg(leaf.shape, leaf.dtype, mesh, (None, b_axes, s_ax) + rest)

    cache_abs = {name: tuple(kv_spec(x) for x in pair)
                 for name, pair in cspec.items()}
    split = {any(isinstance(p, Shard) and p.dim == 2 for p in a.placements)
             for a in leaves(cache_abs)}
    if len(split) != 1:
        raise NotImplementedError(
            "a decode cache split by sequence in some stacks only")
    kv_axes = s_axes if split == {True} else ()
    tok = arg((b,), torch.int32, mesh, (b_axes,))
    pos = arg((), torch.int32, mesh)
    step_dp = dp if b_axes is not None else ()

    @torch.no_grad()
    def step(params, cache, tokens, pos):
        from torch._subclasses.fake_tensor import is_fake

        from repro_torch.models.transformer import TensorParallel

        # a fake position has no value: the trace decodes at the last one
        pos = s_max - 1 if is_fake(pos) else int(pos)
        view = layouts.lm_view(params, params_abs, mesh, ())
        return decode_step(view, cfg, cache, tokens, pos, mesh=mesh,
                           dp_axes=step_dp,
                           kv_group=layouts.axes_group(mesh, kv_axes),
                           tp=TensorParallel(mesh))

    n_rounds = cfg.n_layers // cfg.global_every if cfg.sub_quadratic else 0
    return Cell(
        arch, shape, "decode", step, (params_abs, cache_abs, tok, pos),
        meta=dict(
            model_flops=float(2 * cfg.n_active_params() * b),
            tokens=b,
            loop_trip_counts=(
                {"rounds": n_rounds} if cfg.sub_quadratic
                else {"dense": cfg.n_dense_layers, "moe": cfg.n_moe_layers}
            ),
            ep_axes=ep,
            s_max=s_max,
        ),
        donate=(1,),
    )


# ============================================================== GNN cells ===
GNN_SHAPE_DEFS = {
    # n_nodes, n_edges, d_feat, trip_per_edge, readout, n_graphs, batch note
    "full_graph_sm": dict(n=2816, e=11264, d_feat=1433, tpe=8,
                          readout="node", n_graphs=1),
    "minibatch_lg": dict(n=172032, e=172032, d_feat=602, tpe=12,
                         readout="node", n_graphs=1),
    "ogb_products": dict(n=2449408, e=61866496, d_feat=100, tpe=8,
                         readout="node", n_graphs=1),
    "molecule": dict(n=3840, e=8192, d_feat=16, tpe=8,
                     readout="graph", n_graphs=128),
    # §Perf iteration: bf16 messages halve the cross-shard gather traffic
    # of the collective-bound ogb_products cell (EXPERIMENTS.md)
    "ogb_products_bf16": dict(n=2449408, e=61866496, d_feat=100, tpe=8,
                              readout="node", n_graphs=1,
                              dtype=torch.bfloat16),
}


def _gnn_cell(shape: str, mesh, variant: str) -> Cell:
    from repro_torch.launch import layouts
    from repro_torch.models.gnn.dimenet import GraphBatch, init_params
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init

    sd = GNN_SHAPE_DEFS[shape]
    cfg = dimenet_cfg.config(
        d_feat=sd["d_feat"],
        d_out=1 if sd["readout"] == "graph" else 47,
        readout=sd["readout"],
    )
    if variant == "cost":
        cfg = dataclasses.replace(cfg, scan_unroll=True)
    if sd.get("dtype") is not None:  # §Perf: bf16 message variant
        cfg = dataclasses.replace(cfg, dtype=sd["dtype"])
    n, e, t = sd["n"], sd["e"], sd["e"] * sd["tpe"]
    all_axes = tuple(mesh.mesh_dim_names)
    shard1 = (all_axes,)  # 1-D arrays over every chip

    opt_cfg = OptimizerConfig(name="adamw", weight_decay=0.0)
    params_shape = fake_shapes(
        lambda: init_params(_cpu_gen(), cfg, device="cpu"))
    params_abs = _arg_tree(params_shape, _replicated_like(params_shape, mesh),
                           mesh)
    opt_shape = fake_shapes(adamw_init, params_shape)
    opt_abs = _arg_tree(opt_shape, _replicated_like(opt_shape, mesh), mesh)
    g_abs = GraphBatch(
        node_feat=arg((n, sd["d_feat"]), torch.float32, mesh),
        positions=arg((n, 3), torch.float32, mesh),
        edge_src=arg((e,), torch.int32, mesh, shard1),
        edge_dst=arg((e,), torch.int32, mesh, shard1),
        edge_mask=arg((e,), torch.bool, mesh, shard1),
        trip_in=arg((t,), torch.int32, mesh, shard1),
        trip_out=arg((t,), torch.int32, mesh, shard1),
        trip_mask=arg((t,), torch.bool, mesh, shard1),
        graph_id=arg((n,), torch.int32, mesh),
        n_graphs=sd["n_graphs"],
    )
    labels = arg(
        (sd["n_graphs"],) if sd["readout"] == "graph" else (n,),
        torch.float32 if sd["readout"] == "graph" else torch.int32, mesh)

    def train_step(params, opt_state, g, labels):
        return layouts.gnn_train_step(params, opt_state, g, labels, cfg=cfg,
                                      opt_cfg=opt_cfg, mesh=mesh)

    d = cfg.d_hidden
    flops = 3 * 2 * (  # fwd(+bwd×2) matmul-dominant terms
        e * 3 * d * d  # embedding block
        + cfg.n_blocks * (
            2 * e * d * d  # msg/src projections
            + t * cfg.n_bilinear * d * d  # bilinear triplet interaction
            + 2 * e * d * d  # residual MLP
            + n * d * d  # output block
        )
    )
    return Cell(
        "dimenet", shape, "train", train_step,
        (params_abs, opt_abs, g_abs, labels),
        meta=dict(model_flops=float(flops), tokens=n,
                  loop_trip_counts={"blocks": cfg.n_blocks}),
        donate=(0, 1),
    )


# =========================================================== recsys cells ===
RECSYS_SHAPE_DEFS = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_cand=1_048_576, kind="retrieval"),
}

ROW_SHARDED_MIN_ROWS = 100_000  # tables this long are split by row


def _recsys_cell(arch: str, shape: str, mesh, variant: str) -> Cell:
    from repro_torch.launch import layouts
    from repro_torch.models.recsys.models import RecsysBatch, init_params
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init

    cfg = RECSYS_ARCHS[arch].config()
    sd = RECSYS_SHAPE_DEFS[shape]
    b = sd["batch"]
    m = mesh_spec(mesh)
    dp = dp_axes(mesh)
    b_axes = dp if b % _size(m, dp) == 0 else None
    all_axes = tuple(m.mesh_dim_names)

    def spec_tree(shapes):
        def one(leaf):
            if len(leaf.shape) == 2 and leaf.shape[0] >= ROW_SHARDED_MIN_ROWS:
                return to_placements((all_axes, None), all_axes)
            return to_placements((), all_axes)

        return tree_map(one, shapes)

    params_shape = fake_shapes(
        lambda: init_params(_cpu_gen(), cfg, device="cpu"))
    params_abs = _arg_tree(params_shape, spec_tree(params_shape), mesh)

    L = max(cfg.seq_len, 1)
    batch_abs = RecsysBatch(
        dense=arg((b, cfg.n_dense), torch.float32, mesh, (b_axes, None)),
        sparse=arg((b, max(cfg.n_sparse, 1)), torch.int32, mesh,
                   (b_axes, None)),
        hist=arg((b, L), torch.int32, mesh, (b_axes, None)),
        target=arg((b,), torch.int32, mesh, (b_axes,)),
        label=arg((b,), torch.float32, mesh, (b_axes,)),
    )

    mlp_flops = 0
    prev = cfg.embed_dim * 4 + cfg.n_dense
    for hdim in cfg.mlp_dims:
        mlp_flops += 2 * prev * hdim
        prev = hdim
    attn_flops = (
        2 * cfg.seq_len * cfg.seq_len * cfg.embed_dim * max(cfg.n_blocks, 1)
        if cfg.arch in ("sasrec", "bst") else
        2 * cfg.seq_len * 4 * cfg.embed_dim * sum(cfg.attn_mlp_dims or (1,))
    )
    per_ex = mlp_flops + attn_flops
    step_dp = dp if b_axes is not None else ()

    if sd["kind"] == "train":
        opt_cfg = OptimizerConfig(name="adamw", weight_decay=0.0)
        opt_shape = fake_shapes(adamw_init, params_shape)
        opt_abs = _arg_tree(opt_shape, spec_tree(opt_shape), mesh)

        def step(params, opt_state, batch):
            return layouts.recsys_train_step(
                params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg,
                params_abs=params_abs, mesh=mesh, dp=step_dp)

        args = (params_abs, opt_abs, batch_abs)
        flops = 3 * b * per_ex
        donate = (0, 1)
    elif sd["kind"] == "serve":
        @torch.no_grad()
        def step(params, batch):
            return layouts.recsys_forward(params, batch, cfg=cfg,
                                          params_abs=params_abs, mesh=mesh,
                                          dp=step_dp)

        args = (params_abs, batch_abs)
        flops = b * per_ex
        donate = ()
    else:  # retrieval
        n_cand = sd["n_cand"]
        cands = arg((n_cand, cfg.embed_dim), torch.float32, mesh,
                    (all_axes, None))

        @torch.no_grad()
        def step(params, batch, candidates):
            return layouts.recsys_retrieval(
                params, batch, candidates, cfg=cfg, params_abs=params_abs,
                mesh=mesh, dp=step_dp, k=100)

        args = (params_abs, batch_abs, cands)
        flops = b * (per_ex + 2 * n_cand * cfg.embed_dim)
        donate = ()

    return Cell(
        arch, shape, sd["kind"], step, args,
        meta=dict(model_flops=float(flops), tokens=b, loop_trip_counts={}),
        donate=donate,
    )


# =========================================================== paper-ivf =====
IVF_SHAPE = dict(q=1024, k_clusters=32768, vpad=36864, d=768, m=10, f=2,
                 k=100, n_probes=7)


def _ivf_cell(mesh, variant: str, *, quantized: bool = False,
              p_cap_slack: float = 2.0, shape_name: str = "search_1b",
              size: Optional[Dict[str, int]] = None) -> Cell:
    """The paper's §4.4 search over the 1B-vector index (Table 1 scale).

    ``quantized``/``p_cap_slack`` are the §Perf hillclimb levers: SQ8 lists
    halve the dominant HBM stream; tighter dispatch slack cuts the padded
    probe slots each chip scans.  Both variants run the per-probe scan
    (the reference's ``xla_map`` and ``xla_vmap``, one computation).
    ``size`` overrides entries of ``IVF_SHAPE`` (an index one card holds).
    """
    from repro_torch.core.distributed import probe_capacity

    sh = dict(IVF_SHAPE, **(size or {}))
    q, k_clusters, vpad, d, m, f = (sh["q"], sh["k_clusters"], sh["vpad"],
                                    sh["d"], sh["m"], sh["f"])
    ms = mesh_spec(mesh)
    chips = math.prod(ms.shape)
    all_axes = tuple(ms.mesh_dim_names)
    p_cap = probe_capacity(q, sh["n_probes"], chips, p_cap_slack)
    k_local = k_clusters // chips

    def step(centroids, vectors, attrs, ids, counts, scales, queries, lo,
             hi, shard_ok):
        from repro_torch.launch import layouts

        return layouts.ivf_search_step(
            centroids, vectors, attrs, ids, counts, scales, queries, lo, hi,
            shard_ok, mesh=mesh, quantized=quantized,
            p_cap_slack=p_cap_slack, q_total=q, n_clusters=k_clusters,
            k=sh["k"], n_probes=sh["n_probes"])

    vec_dtype = torch.int8 if quantized else torch.bfloat16
    shard = (all_axes,)
    args = (
        arg((k_clusters, d), torch.float32, mesh),  # centroids
        arg((k_clusters, vpad, d), vec_dtype, mesh, shard),
        arg((k_clusters, vpad, m), torch.int16, mesh, shard),
        arg((k_clusters, vpad), torch.int32, mesh, shard),
        arg((k_clusters,), torch.int32, mesh, shard),
        arg((k_clusters, vpad) if quantized else (k_clusters, 1),
            torch.float32, mesh, shard),
        arg((q, d), torch.float32, mesh),  # queries (replicated)
        arg((q, f, m), torch.int16, mesh),
        arg((q, f, m), torch.int16, mesh),
        arg((chips,), torch.bool, mesh),
    )
    v_mean = 31250  # paper Table 1
    flops = float(q * 7 * v_mean * d * 2 + q * k_clusters * d * 2)
    return Cell(
        "paper-ivf", shape_name, "search", step, args,
        meta=dict(
            model_flops=flops, tokens=q,
            loop_trip_counts={"slots": p_cap},
            p_cap=p_cap, k_local=k_local,
            n_vectors=int(1e9), vpad=vpad, quantized=quantized,
            p_cap_slack=p_cap_slack,
        ),
    )


# ============================================================== dispatch ===
def build_cell(arch: str, shape: str, mesh, variant: str = "exec",
               layers: Optional[Tuple[int, ...]] = None,
               batch: Optional[int] = None) -> Cell:
    """The cell's step and abstract arguments.  ``mesh`` is a
    ``DeviceMesh`` (the step runs on its process groups) or a ``MeshSpec``
    (the arguments and meta only).  ``layers`` cuts an LM's depth and
    ``batch`` a decode cell's batch (a cell one card holds)."""
    if batch is not None and shape not in ("decode_32k", "long_500k"):
        raise ValueError("batch cuts a decode cell only")
    if arch in LM_ARCHS:
        if shape == "train_4k":
            return _lm_train_cell(arch, mesh, variant, layers)
        if shape == "train_4k_moescatter":  # §Perf: rs-combine MoE output
            return _lm_train_cell(arch, mesh, variant, layers,
                                  moe_combine="scatter")
        if shape == "prefill_32k":
            return _lm_prefill_cell(arch, mesh, variant, layers)
        if shape in ("decode_32k", "long_500k"):
            return _lm_decode_cell(arch, shape, mesh, variant, layers, batch)
        raise ValueError(shape)
    if arch == "dimenet":
        return _gnn_cell(shape, mesh, variant)
    if arch in RECSYS_ARCHS:
        return _recsys_cell(arch, shape, mesh, variant)
    if arch == "paper-ivf":
        if shape == "search_1b":
            return _ivf_cell(mesh, variant)
        if shape == "search_1b_sq8":  # §Perf iteration 1: SQ8 lists
            return _ivf_cell(mesh, variant, quantized=True,
                             shape_name=shape)
        if shape == "search_1b_sq8_tight":  # §Perf iter 2: + slack 1.25
            return _ivf_cell(mesh, variant, quantized=True,
                             p_cap_slack=1.25, shape_name=shape)
        raise ValueError(shape)
    raise ValueError(arch)


def lm_probe_plan(arch: str, shape: str):
    """Probe layer-counts and the linear synthesis for full-depth cost.

    Returns (probes, solve) where probes is a list of layer tuples and
    solve(*costs) maps the probes' costs to the full-depth value.  Costs
    combine linearly because every layer of a stack costs the same and the
    per-layer parameter ops (optimizer, grads) are elementwise in L.  The
    port's eager trace sees every layer, so ``launch.dryrun`` traces full
    depth; this plan is the reference's, held against that trace.
    """
    cfg = LM_ARCHS[arch].config()
    is_decode = shape in ("decode_32k", "long_500k")
    if cfg.moe is not None:
        nd, nm = cfg.n_dense_layers, cfg.n_moe_layers
        probes = [(1, 1), (1, 3), (2, 1)]

        def solve(f11, f13, f21):
            bm = (f13 - f11) / 2.0
            bd = f21 - f11
            const = f11 - bd - bm
            return const + bd * nd + bm * nm

        return probes, solve
    if cfg.sub_quadratic and is_decode:
        g = cfg.global_every
        rounds = cfg.n_layers // g
        tail = cfg.n_layers - rounds * g
        probes = [(g,), (2 * g,), (g + 2,)]

        def solve(f6, f12, f8):
            br = f12 - f6
            const = f6 - br
            bt = (f8 - f6) / 2.0
            return const + br * rounds + bt * tail

        return probes, solve
    nl = cfg.n_layers
    probes = [(2,), (4,)]

    def solve(f2, f4):
        bl = (f4 - f2) / 2.0
        const = f2 - 2 * bl
        return const + bl * nl

    return probes, solve
