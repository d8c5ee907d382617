"""Optimizers: AdamW and Adafactor (factored second moments); the port of
``repro.train.optimizer``.

Both are functional over trees of tensors (``train/tree.py``):
``init(params) -> state``, ``update(grads, state, params, lr) ->
(new_params, new_state)``, with ``lr`` an f32 tensor.  The states are
NamedTuples whose fields mirror the parameter tree leaf by leaf, so a
checkpoint's keys are the reference's (``opt/m/...``, ``opt/count``).

Every scalar the reference computes in f32 (the schedule, AdamW's bias
corrections ``1 - b ** c``, Adafactor's ``c ** -decay_rate``) is computed
here on f32 tensors, and every division is by a tensor: the card turns a
division by a Python scalar into a reciprocal multiply, which rounds
otherwise.

State shardings are ``torch.distributed.tensor`` placements: one
``Shard(tensor_dim)`` or ``Replicate()`` a mesh dimension, the DTensor form
of the reference's ``PartitionSpec`` (:func:`to_placements` converts one).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Sequence, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.train.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # "adamw" | "adafactor"
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999  # adafactor: decay exponent handled separately
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    factored_min_dim: int = 128
    decay_rate: float = 0.8


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr``, then a half cosine to 0 at ``total``;
    ``lr(step)`` takes an integer tensor and returns an f32 tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = _f32(base_lr, step) * torch.minimum(
            step / _f32(max(warmup, 1), step), _f32(1.0, step))
        t = torch.clamp((step - _f32(warmup, step))
                        / _f32(max(total - warmup, 1), step), 0, 1)
        cos = _f32(base_lr, step) * _f32(0.5, step) * (
            1 + torch.cos(_f32(math.pi, step) * t))
        return torch.where(step < warmup, warm, cos)

    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled to at most max_norm, its global norm)``."""
    g = global_norm(tree)
    scale = torch.minimum(
        _f32(1.0, g), _f32(max_norm, g) / torch.clamp(g, min=1e-9))
    return tree_map(lambda x: x * scale.to(x.dtype), tree), g


# ------------------------------------------------------------------ adamw ---
class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def adamw_init(params) -> AdamWState:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = leaves(params)
    dev = first[0].device if first else None
    return AdamWState(m=tree_map(zeros32, params), v=tree_map(zeros32, params),
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def adamw_update(grads, state: AdamWState, params, lr: torch.Tensor,
                 cfg: OptimizerConfig):
    c = state.count + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - _f32(b1, c) ** c.to(torch.float32)
    bc2 = 1 - _f32(b2, c) ** c.to(torch.float32)

    def upd(p, g, m, v):
        g32 = g.float()
        m2 = b1 * m + (1 - b1) * g32
        v2 = b2 * v + (1 - b2) * g32 * g32
        step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return _Updated((p.float() - lr * step).to(p.dtype), m2, v2)

    out = tree_map(upd, params, grads, state.m, state.v)
    return _pick(out, 0), AdamWState(_pick(out, 1), _pick(out, 2), c)


class _Updated:
    """One leaf's (parameter, first stat, second stat) after an update: a
    leaf to ``tree_map``, unlike a tuple."""

    __slots__ = ("items",)

    def __init__(self, *items):
        self.items = items


def _pick(out, i):
    return tree_map(lambda t: t.items[i], out)


# -------------------------------------------------------------- adafactor ---
class AdafactorState(NamedTuple):
    v_row: Any  # factored stats ([..., R] per >=2-D leaf) or full v (1-D)
    v_col: Any
    count: torch.Tensor


def _factored(shape, min_dim) -> bool:
    return len(shape) >= 2 and shape[-1] >= min_dim and shape[-2] >= min_dim


def adafactor_init(params, cfg: OptimizerConfig) -> AdafactorState:
    def rows(p):
        if _factored(p.shape, cfg.factored_min_dim):
            return torch.zeros(p.shape[:-1], dtype=torch.float32,
                               device=p.device)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def cols(p):
        if _factored(p.shape, cfg.factored_min_dim):
            return torch.zeros(p.shape[:-2] + p.shape[-1:],
                               dtype=torch.float32, device=p.device)
        return torch.zeros((1,), dtype=torch.float32, device=p.device)  # unused

    first = leaves(params)
    dev = first[0].device if first else None
    return AdafactorState(
        v_row=tree_map(rows, params), v_col=tree_map(cols, params),
        count=torch.zeros((), dtype=torch.int32, device=dev))


def adafactor_update(grads, state: AdafactorState, params, lr: torch.Tensor,
                     cfg: OptimizerConfig):
    c = state.count + 1
    beta2 = 1.0 - c.to(torch.float32) ** _f32(-cfg.decay_rate, c)

    def upd(p, g, vr, vc):
        g32 = g.float()
        g2 = g32 * g32 + 1e-30
        if _factored(p.shape, cfg.factored_min_dim):
            vr2 = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
            vc2 = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
            r = vr2 / torch.clamp(torch.mean(vr2, dim=-1, keepdim=True),
                                  min=1e-30)
            step = g32 / (torch.sqrt(r)[..., None]
                          * torch.sqrt(vc2)[..., None, :] + cfg.eps)
        else:
            vr2 = beta2 * vr + (1 - beta2) * g2
            vc2 = vc
            step = g32 / (torch.sqrt(vr2) + cfg.eps)
        # update clipping (Adafactor's RMS-1 rule)
        rms = torch.sqrt(torch.mean(step * step) + 1e-30)
        step = step / torch.clamp(rms, min=1.0)
        step = step + cfg.weight_decay * p.float()
        return _Updated((p.float() - lr * step).to(p.dtype), vr2, vc2)

    out = tree_map(upd, params, grads, state.v_row, state.v_col)
    return _pick(out, 0), AdafactorState(_pick(out, 1), _pick(out, 2), c)


# ------------------------------------------------------- state shardings ---
def to_placements(spec: Sequence, axis_names: Sequence[str]) -> tuple:
    """A ``PartitionSpec``-shaped spec (an entry a tensor dimension: None,
    a mesh axis name, or a tuple of names) as DTensor placements (one a
    mesh dimension of ``axis_names``)."""
    out = [Replicate()] * len(axis_names)
    for dim, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for name in names:
            out[list(axis_names).index(name)] = Shard(dim)
    return tuple(out)


def _is_placements(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(p, (Shard, Replicate)) for p in x)


def _map_specs(fn, specs, *rest):
    """``fn`` over the placement tuples of a spec tree (a placement tuple
    is a tuple, so the generic ``tree_map`` would walk into it)."""
    if _is_placements(specs):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v, *(r[i] for r in rest))
                           for i, v in enumerate(specs))
    raise TypeError(f"not a placement tree: {type(specs)}")


def _mesh_ndim(specs) -> int:
    found = []
    _map_specs(lambda s: found.append(len(s)), specs)
    return found[0] if found else 1


def adamw_state_pspecs(param_pspecs) -> AdamWState:
    """m/v inherit the parameter placements exactly (same shapes)."""
    return AdamWState(m=param_pspecs, v=param_pspecs,
                      count=(Replicate(),) * _mesh_ndim(param_pspecs))


def adafactor_state_pspecs(param_pspecs, param_shapes,
                           cfg: OptimizerConfig) -> AdafactorState:
    """v_row drops the last parameter dimension's sharding, v_col the
    second-to-last (later dimensions shift down by one).  Non-factored
    leaves keep the full placements (v_row) / are replicated (v_col).
    Keeping factored stats sharded like their parent matters: a replicated
    row stat for [58, 256, 7168] experts would be 425 GB a chip.
    ``param_shapes`` is a tree of shape tuples beside the placements."""
    def rows(spec, shp):
        if _factored(shp, cfg.factored_min_dim):
            last = len(shp) - 1
            return tuple(Replicate() if p == Shard(last) else p for p in spec)
        return spec

    def cols(spec, shp):
        if _factored(shp, cfg.factored_min_dim):
            n = len(shp)
            return tuple(Replicate() if p == Shard(n - 2)
                         else Shard(n - 2) if p == Shard(n - 1) else p
                         for p in spec)
        return (Replicate(),) * len(spec)

    shapes = _shape_tree(param_shapes)
    return AdafactorState(
        v_row=_map_specs(rows, param_pspecs, shapes),
        v_col=_map_specs(cols, param_pspecs, shapes),
        count=(Replicate(),) * _mesh_ndim(param_pspecs))


def _shape_tree(shapes):
    """Shape tuples as opaque leaves for ``_map_specs``'s walk."""
    if isinstance(shapes, dict):
        return {k: _shape_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_shape_tree(v) for v in shapes]
    if hasattr(shapes, "shape"):
        return tuple(shapes.shape)
    return tuple(shapes)


# ------------------------------------------------------------- dispatcher ---
def make_optimizer(cfg: OptimizerConfig
                   ) -> Tuple[Callable, Callable]:
    if cfg.name == "adamw":
        return (lambda p: adamw_init(p),
                lambda g, s, p, lr: adamw_update(g, s, p, lr, cfg))
    if cfg.name == "adafactor":
        return (lambda p: adafactor_init(p, cfg),
                lambda g, s, p, lr: adafactor_update(g, s, p, lr, cfg))
    raise ValueError(cfg.name)
