"""DimeNet [arXiv:2003.03123] — directional message passing with triplet
(k→j→i) angular features: the port of ``repro.models.gnn.dimenet``.

Message passing is gathers (``index_select``) and scatter-adds
(``index_add_``, the reference's ``jax.ops.segment_sum``) over explicit
edge and triplet index lists.  On the card ``index_add_`` accumulates with
atomics, so a segment's sum changes order from run to run: the card agrees
with the CPU within rounding, not bit for bit.

Faithfulness notes (as the reference's):
  * graphs without 3-D coordinates get synthetic positions, and the node
    featurizer is a linear map of ``d_feat`` features (DimeNet's atom-type
    embedding generalized); the molecule shape uses the model as published;
  * the 2-D spherical basis is sine-radial × Legendre-angular with the
    paper's p=6 smooth envelope (the m=0 Fourier-Bessel surrogate), laid out
    ``[T, S·R]`` angle major, radial minor, so ``w_sbf`` carries across;
  * triplets are capped per edge (static shapes; ``sampler.py``).

With ``edge_group`` (a process group) the edges and triplets are split
over its ranks, the nodes replicated, as the reference's production cell
lays them out: each rank computes its edges' messages, all-gathers the
source messages its triplets read, reduce-scatters the triplet sums back
to the edges' owners and all-reduces each block's node sums
(:class:`EdgeSplit`).

Parameters keep the reference's keys, with the blocks' leaves stacked
``[n_blocks, ...]``, so its ``init_params`` output carries across leaf for
leaf (``train.checkpoint.params_from_numpy``).  Every division by a
constant divides by an f32 tensor: the card turns a division by a Python
scalar into a reciprocal multiply, which rounds otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    all_reduce_sum,
    gather_dim,
    reduce_scatter_dim,
    sum_grad,
)
from repro_torch.models.recsys.embedding import glorot_normal


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_feat: int = 128  # input node feature width (varies per shape)
    d_out: int = 32  # classes (node tasks) or 1 (graph regression)
    cutoff: float = 5.0
    envelope_p: int = 6
    readout: str = "node"  # "node" | "graph"
    dtype: Any = torch.float32
    # the reference's dry-run cost variant (unrolls its layer scan); the
    # port's blocks are a Python loop, so it has no effect here
    scan_unroll: bool = False

    def n_params(self) -> int:
        d = self.d_hidden
        per_block = (
            d * d * 4  # message MLPs
            + self.n_bilinear * d * d  # bilinear tensor
            + self.n_spherical * self.n_radial * self.n_bilinear
            + self.n_radial * d
            + d * d * 2  # output block
        )
        return self.d_feat * d + 3 * d * d + self.n_blocks * per_block \
            + d * self.d_out


def scaled_down_gnn(cfg: DimeNetConfig, **overrides) -> DimeNetConfig:
    small = dict(n_blocks=2, d_hidden=32, n_bilinear=2, n_spherical=3,
                 n_radial=4, d_feat=16, d_out=4)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# ------------------------------------------------------------- the bases ---
def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` by the reference's square-and-multiply (``lax.
    integer_pow``): the envelope's terms cancel near the cutoff, so the
    product order shows."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def envelope(d: torch.Tensor, cutoff: float, p: int) -> torch.Tensor:
    """Smooth polynomial cutoff u(d) (paper eq. 8), zero at d=cutoff."""
    x = torch.clamp(d / _f32(cutoff, d), 0.0, 1.0)
    a = -(p + 1) * (p + 2) / 2.0
    b = p * (p + 2)
    c = -p * (p + 1) / 2.0
    return (1.0 + a * _integer_pow(x, p) + b * _integer_pow(x, p + 1)
            + c * _integer_pow(x, p + 2))


def radial_basis(d: torch.Tensor, n_radial: int, cutoff: float, p: int
                 ) -> torch.Tensor:
    """e_RBF(d) [.., n_radial]: envelope · sin(nπ d/c)/d (paper eq. 7)."""
    n = torch.arange(1, n_radial + 1, dtype=torch.float32, device=d.device)
    ds = torch.clamp(d[..., None], min=1e-6)
    env = envelope(d, cutoff, p)[..., None]
    c = _f32(cutoff, d)
    return env * torch.sin(n * math.pi * ds / c) / ds * torch.sqrt(
        _f32(2.0, d) / c)


def _legendre(cos_t: torch.Tensor, n: int) -> torch.Tensor:
    """P_0..P_{n-1}(cosθ) via the recurrence. [.., n]."""
    outs = [torch.ones_like(cos_t), cos_t]
    for l in range(2, n):
        outs.append(
            ((2 * l - 1) * cos_t * outs[-1] - (l - 1) * outs[-2])
            / _f32(l, cos_t))
    return torch.stack(outs[:n], dim=-1)


def spherical_basis(d: torch.Tensor, cos_angle: torch.Tensor,
                    n_spherical: int, n_radial: int, cutoff: float, p: int
                    ) -> torch.Tensor:
    """e_SBF(d_kj, θ) [.., n_spherical · n_radial], angle major."""
    rad = radial_basis(d, n_radial, cutoff, p)  # [.., R]
    ang = _legendre(cos_angle, n_spherical)  # [.., S]
    out = rad[..., None, :] * ang[..., :, None]  # [.., S, R]
    return out.reshape(out.shape[:-2] + (n_spherical * n_radial,))


# ----------------------------------------------------------------- init ----
def _dense(gen, din, dout, dtype):
    return glorot_normal(gen, (din, dout), dtype)


def init_params(gen: torch.Generator, cfg: DimeNetConfig, *, device="cuda"
                ) -> Dict[str, Any]:
    """Random parameters with the reference's keys, shapes and
    distributions, drawn from ``gen`` (a generator on ``device``; the
    reference's ``jax.random`` stream cannot be reproduced: carry its
    parameters across to hold the two packages against each other)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params asked for {dev}")
    d, dt = cfg.d_hidden, cfg.dtype
    nsr = cfg.n_spherical * cfg.n_radial
    p: Dict[str, Any] = {
        "feat_proj": _dense(gen, cfg.d_feat, d, dt),
        "rbf_embed": _dense(gen, cfg.n_radial, d, dt),
        "msg_embed": _dense(gen, 3 * d, d, dt),
        "out_proj": _dense(gen, d, cfg.d_out, dt),
    }
    blocks = []
    for _ in range(cfg.n_blocks):
        w_bil = torch.randn((cfg.n_bilinear, d, d), generator=gen,
                            device=dev) * 0.02
        blocks.append({
            "w_msg": _dense(gen, d, d, dt),
            "w_src": _dense(gen, d, d, dt),
            "w_sbf": _dense(gen, nsr, cfg.n_bilinear, dt),
            "w_bil": w_bil.to(dt),
            "w_res1": _dense(gen, d, d, dt),
            "w_res2": _dense(gen, d, d, dt),
            "w_rbf_out": _dense(gen, cfg.n_radial, d, dt),
            "w_out": _dense(gen, d, d, dt),
        })
    p["blocks"] = {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}
    return p


# --------------------------------------------------------------- forward ---
@dataclasses.dataclass
class GraphBatch:
    """Static-shape graph with explicit triplets.

    node_feat   [N, d_feat]
    positions   [N, 3]
    edge_src    [E] int32 (j of message j→i)      edge_dst [E] int32 (i)
    edge_mask   [E] bool (padding)
    trip_in     [T] int32 — edge index of (k→j)   trip_out [T] int32 — (j→i)
    trip_mask   [T] bool
    graph_id    [N] int32 (graph readout; zeros for single graph)
    n_graphs    int
    """

    node_feat: torch.Tensor
    positions: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_mask: torch.Tensor
    trip_in: torch.Tensor
    trip_out: torch.Tensor
    trip_mask: torch.Tensor
    graph_id: torch.Tensor
    n_graphs: int = 1


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(x, 0, idx.long())


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int
                 ) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``x`` summed by segment id."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg.long(), x)


class EdgeSplit:
    """Edges and triplets split over ``group`` (None: one rank holds all):
    rank r holds edges ``[r·E_l, (r+1)·E_l)`` and its triplets, whose
    ``trip_in`` / ``trip_out`` index the global edge list."""

    def __init__(self, group, e_local: int):
        self.group = group
        n = 1 if group is None else torch.distributed.get_world_size(group)
        self.e_total = e_local * n

    def gather(self, x):
        """Every rank's edge rows, in edge order (the gradient summed)."""
        return x if self.group is None else gather_dim(x, self.group, 0)

    def scatter(self, x):
        """A global [E, ...] partial sum → this rank's edges, summed."""
        return x if self.group is None else reduce_scatter_dim(
            x, self.group, 0)

    def node_sum(self, x):
        """Node rows summed over the ranks (replicated after)."""
        return x if self.group is None else all_reduce_sum(x, self.group)

    def shared(self, x):
        """A replicated value used on this rank's edges: its gradient is
        summed over the ranks."""
        return x if self.group is None else sum_grad(x, self.group)


def _block(m, bp, sbf, rbf, g: GraphBatch, n: int, e: int,
           split: EdgeSplit = None):
    """One interaction block: (messages', the nodes' contribution)."""
    act = F.silu
    split = split or EdgeSplit(None, m.shape[0])
    # w_out acts on the replicated node sums; the rest on this rank's edges
    bp = {k: (v if k == "w_out" else split.shared(v)) for k, v in bp.items()}
    # directional aggregation over triplets
    m_kj = _take(split.gather(act(m @ bp["w_src"])), g.trip_in)  # [T, d]
    sbf_emb = sbf @ bp["w_sbf"]  # [T, n_bilinear]
    inter = torch.einsum("td,bdf->tbf", m_kj, bp["w_bil"])  # [T, B, d]
    inter = torch.einsum("tbf,tb->tf", inter, sbf_emb)  # [T, d]
    inter = torch.where(g.trip_mask[:, None], inter, 0.0)
    agg = split.scatter(_segment_sum(inter, g.trip_out, split.e_total))
    m2 = act(m @ bp["w_msg"]) + agg
    m2 = m2 + act(act(m2 @ bp["w_res1"]) @ bp["w_res2"])  # residual MLP
    m2 = torch.where(g.edge_mask[:, None], m2, 0.0)
    # output block: per-node contribution
    t_i = split.node_sum(
        _segment_sum(m2 * (rbf @ bp["w_rbf_out"]), g.edge_dst, n))
    return m2, act(t_i @ bp["w_out"])


def forward(params: Dict[str, Any], cfg: DimeNetConfig, g: GraphBatch, *,
            remat: bool = False, edge_group=None) -> torch.Tensor:
    """Returns [N, d_out] (node readout) or [n_graphs, d_out] (graph).

    ``remat=True`` recomputes each block in the backward
    (``torch.utils.checkpoint``) instead of keeping its ``[T, n_bilinear,
    d]`` intermediate: the values and gradients are the same.
    ``edge_group``: the edges and triplets of ``g`` are this rank's shards
    over that process group (:class:`EdgeSplit`); every rank returns the
    same output.
    """
    act = F.silu
    n = g.node_feat.shape[0]
    e = g.edge_src.shape[0]
    split = EdgeSplit(edge_group, e)

    h = act(g.node_feat.to(cfg.dtype) @ params["feat_proj"])  # [N, d]

    # geometry
    dvec = _take(g.positions, g.edge_dst) - _take(g.positions, g.edge_src)
    dist = torch.sqrt(torch.clamp(torch.sum(dvec * dvec, -1), min=1e-12))
    rbf = radial_basis(dist, cfg.n_radial, cfg.cutoff, cfg.envelope_p)
    # bases are evaluated in f32 (trig/envelope precision) then cast to the
    # working dtype
    rbf = torch.where(g.edge_mask[:, None], rbf, 0.0).to(cfg.dtype)

    # triplet angle at j between (k→j) and (j→i): cosθ = -d_kj·d_ji/(|..||..|)
    dvec_all = split.gather(dvec)
    v_in = _take(dvec_all, g.trip_in)  # k→j
    v_out = _take(dvec_all, g.trip_out)  # j→i
    num = torch.sum(v_in * v_out, -1)
    den = torch.clamp(torch.linalg.vector_norm(v_in, dim=-1)
                      * torch.linalg.vector_norm(v_out, dim=-1), min=1e-12)
    cos_t = torch.clamp(num / den, -1.0, 1.0)
    d_in = _take(split.gather(dist), g.trip_in)
    sbf = spherical_basis(d_in, cos_t, cfg.n_spherical, cfg.n_radial,
                          cfg.cutoff, cfg.envelope_p)
    sbf = torch.where(g.trip_mask[:, None], sbf, 0.0).to(cfg.dtype)

    # embedding block: m_ji = σ(W [h_j ‖ h_i ‖ rbf_emb])
    h = split.shared(h)
    m = act(torch.cat(
        [_take(h, g.edge_src), _take(h, g.edge_dst),
         act(rbf @ split.shared(params["rbf_embed"]))], dim=-1)
        @ split.shared(params["msg_embed"]))
    m = torch.where(g.edge_mask[:, None], m, 0.0)

    acc = torch.zeros((n, cfg.d_hidden), dtype=cfg.dtype,
                      device=g.node_feat.device)
    blocks = params["blocks"]
    for i in range(blocks["w_msg"].shape[0]):
        bp = {k: v[i] for k, v in blocks.items()}
        if remat and torch.is_grad_enabled():
            m, contrib = checkpoint(_block, m, bp, sbf, rbf, g, n, e, split,
                                    use_reentrant=False)
        else:
            m, contrib = _block(m, bp, sbf, rbf, g, n, e, split)
        acc = acc + contrib

    out = acc @ params["out_proj"]  # [N, d_out]
    if cfg.readout == "graph":
        out = _segment_sum(out, g.graph_id, g.n_graphs)
    return out


def loss_fn(params, cfg: DimeNetConfig, g: GraphBatch, labels: torch.Tensor,
            label_mask: Optional[torch.Tensor] = None, *, remat: bool = False,
            edge_group=None) -> Tuple[torch.Tensor, Dict]:
    """Node tasks: masked softmax CE. Graph tasks: MSE regression."""
    out = forward(params, cfg, g, remat=remat, edge_group=edge_group)
    if cfg.readout == "graph":
        err = (out[..., 0] - labels.float()) ** 2
        return torch.mean(err), {"mse": torch.mean(err)}
    logits = out.float()
    lse = torch.logsumexp(logits, -1)
    gold = torch.gather(logits, -1, torch.clamp(labels, min=0).long()[:, None]
                        )[:, 0]
    mask = (labels >= 0).float()
    if label_mask is not None:
        mask = mask * label_mask.float()
    loss = torch.sum((lse - gold) * mask) / torch.clamp(torch.sum(mask),
                                                        min=1.0)
    return loss, {"n_labeled": torch.sum(mask)}
