"""Mixture-of-Experts FFN with sort-based dispatch and expert parallelism:
the port of ``repro.models.moe``.

Dispatch is the probe-dispatch pattern turned inward: (token, choice)
pairs are sorted by expert (a stable sort, as ``jnp.argsort``), ranked
within expert, and scattered into a static ``[E_local, C]`` slot table — no
one-hot dispatch matmuls.  Capacity overflow drops (token, choice) pairs,
never whole tokens, and the drop count is returned.  Every local expert
runs over all of its ``C`` slots, so a step reads every expert's weights.

Expert parallelism (``transformer._moe_ffn`` with a ``DeviceMesh``):
experts are split over the mesh's EP axes while every rank routes all of
its tokens; the combine is an all-reduce over the EP groups whose backward
is the identity (``launch.mesh.all_reduce_sum``).  Single-device path:
identical math with ``E_local = E``.

Ties: the router's top-k puts the lower expert first among equal scores
(``lax.top_k``), through a stable descending sort.  Out-of-range slot
writes (the reference's ``mode="drop"``) go to a spare row that is cut
off.  The combine's scatter-add (``index_add_``) uses atomics on the card,
so its sums change order from run to run.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.topk import top_k
from repro_torch.launch.mesh import all_reduce_sum, axis_size
from repro_torch.models.config import MoEConfig
from repro_torch.models.layers import act_fn, init_truncated


def init_moe_params(gen: torch.Generator, d_model: int, cfg: MoEConfig,
                    dtype, n_layers: Optional[int] = None) -> dict:
    """One MoE layer's parameters (the reference's keys, shapes and
    distributions), or ``n_layers`` of them stacked on a leading axis."""
    fe, e = cfg.d_ff_expert, cfg.n_routed
    lead = () if n_layers is None else (n_layers,)
    dev = gen.device
    p = {
        "router": init_truncated(gen, lead + (d_model, e), torch.float32),
        "router_bias": torch.zeros(lead + (e,), dtype=torch.float32,
                                   device=dev),
        "wg": init_truncated(gen, lead + (e, d_model, fe), dtype),
        "wu": init_truncated(gen, lead + (e, d_model, fe), dtype),
        "wd": init_truncated(gen, lead + (e, fe, d_model), dtype),
    }
    if cfg.n_shared:
        fs = fe * cfg.n_shared
        p["shared_wg"] = init_truncated(gen, lead + (d_model, fs), dtype)
        p["shared_wu"] = init_truncated(gen, lead + (d_model, fs), dtype)
        p["shared_wd"] = init_truncated(gen, lead + (fs, d_model), dtype)
    return p


def router_scores(x: torch.Tensor, router_w: torch.Tensor,
                  bias: torch.Tensor, cfg: MoEConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (top-k weights [N,k], top-k ids [N,k], full probs [N,E])."""
    logits = x.float() @ router_w  # [N, E]
    if cfg.router_score == "sigmoid_norm":  # DeepSeek-V3
        scores = torch.sigmoid(logits)
        sel = scores + bias if cfg.use_routing_bias else scores
        _, ids = top_k(sel, cfg.top_k)
        w = torch.gather(scores, -1, ids)
        w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
        probs = scores / torch.clamp(torch.sum(scores, -1, keepdim=True),
                                     min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        sel = probs + bias if cfg.use_routing_bias else probs
        _, ids = top_k(sel, cfg.top_k)
        w = torch.gather(probs, -1, ids)
    return w.float(), ids.int(), probs


def aux_load_balance_loss(probs: torch.Tensor, ids: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E · Σ_e f_e · P_e."""
    n, k = ids.shape
    counts = torch.bincount(ids.reshape(-1).long(),
                            minlength=n_experts).float()
    f = counts / torch.tensor(n * k, dtype=torch.float32,
                              device=counts.device)
    p = torch.mean(probs, dim=0)
    return n_experts * torch.sum(f * p)


def _dispatch_table(
    ids: torch.Tensor,  # [N, k] global expert ids
    weights: torch.Tensor,  # [N, k]
    *,
    e_lo: int,  # first local expert id
    e_local: int,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Builds [E_local, C] (token_idx, weight, valid) tables + drop count."""
    n, k = ids.shape
    dev = ids.device
    flat_e = ids.reshape(-1).long()  # [N*k]
    flat_w = weights.reshape(-1)
    flat_t = torch.arange(n, dtype=torch.int32,
                          device=dev).repeat_interleave(k)
    local_e = flat_e - e_lo
    mine = (local_e >= 0) & (local_e < e_local)
    sort_key = torch.where(mine, local_e, e_local)  # foreign → tail bucket
    order = torch.argsort(sort_key, stable=True)
    key_s = sort_key[order]
    starts = torch.searchsorted(key_s, torch.arange(e_local, device=dev))
    rank = torch.arange(n * k, device=dev) - starts[
        torch.clamp(key_s, max=e_local - 1)]
    ok = (key_s < e_local) & (rank < capacity)

    # entries that are not ok write to a spare row e_local, cut off after
    # (the reference's out-of-range writes with mode="drop")
    dst_e = torch.where(ok, key_s, e_local)
    dst_c = torch.where(ok, rank, 0)
    src_t = flat_t[order]
    src_w = flat_w[order]
    shape = (e_local + 1, capacity)
    tok_tab = torch.zeros(shape, dtype=torch.int32, device=dev)
    w_tab = torch.zeros(shape, dtype=torch.float32, device=dev)
    v_tab = torch.zeros(shape, dtype=torch.bool, device=dev)
    tok_tab.index_put_((dst_e, dst_c), torch.where(ok, src_t, 0))
    w_tab.index_put_((dst_e, dst_c), torch.where(ok, src_w, 0.0))
    v_tab.index_put_((dst_e, dst_c), ok)
    n_dropped = torch.sum((key_s < e_local) & (rank >= capacity)).int()
    return tok_tab[:e_local], w_tab[:e_local], v_tab[:e_local], n_dropped


def ep_rank(mesh, ep_axes: Sequence[str]) -> int:
    """This rank's linearized index over ``ep_axes`` (major axis first)."""
    idx = 0
    for a in ep_axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def moe_ffn_local(
    x: torch.Tensor,  # [N, D] local tokens (replicated over the EP axes)
    params: dict,  # expert weights already LOCAL: wg/wu/wd [E_local, ...]
    cfg: MoEConfig,
    *,
    mesh=None,
    ep_axes: Tuple[str, ...] = (),
    act: str = "silu",
    capacity: Optional[int] = None,
    combine: bool = True,  # False: caller combines (e.g. reduce-scatter)
) -> Tuple[torch.Tensor, dict]:
    """Routed-experts FFN. Caller adds the shared-expert branch.

    With ``ep_axes`` (axes of ``mesh``) this rank holds experts
    ``[e_lo, e_lo + E_local)``, ``e_lo`` from its linearized index over
    those axes; ``combine`` all-reduces the output and the drop count over
    them.  Returns (out [N, D], metrics{aux_loss, n_dropped}).
    """
    n, d = x.shape
    e = cfg.n_routed
    e_local = params["wg"].shape[0]
    e_lo = ep_rank(mesh, ep_axes) * e_local if ep_axes else 0
    if capacity is None:
        capacity = max(8, int(cfg.capacity_factor * n * cfg.top_k / e + 0.999))
        capacity = ((capacity + 7) // 8) * 8

    w, ids, probs = router_scores(
        x, params["router"], params["router_bias"], cfg
    )
    tok_tab, w_tab, v_tab, n_dropped = _dispatch_table(
        ids, w, e_lo=e_lo, e_local=e_local, capacity=capacity
    )

    xg = torch.index_select(x, 0, tok_tab.reshape(-1).long()).reshape(
        e_local, capacity, d
    )  # [E_local, C, D]
    h = act_fn(act)(
        torch.einsum("ecd,edf->ecf", xg, params["wg"])
    ) * torch.einsum("ecd,edf->ecf", xg, params["wu"])
    y = torch.einsum("ecf,efd->ecd", h, params["wd"])  # [E_local, C, D]
    y = y * torch.where(v_tab, w_tab, 0.0)[..., None].to(y.dtype)

    out = torch.zeros((n, d), dtype=y.dtype, device=x.device)
    out = out.index_add(0, tok_tab.reshape(-1).long(), y.reshape(-1, d))
    if ep_axes and combine:
        for a in ep_axes:
            group = mesh.get_group(a)
            out = all_reduce_sum(out, group)
            n_dropped = all_reduce_sum(n_dropped, group)

    aux = aux_load_balance_loss(probs, ids, e)
    return out, dict(aux_loss=aux, n_dropped=n_dropped)


def shared_expert_ffn(x: torch.Tensor, params: dict, act: str = "silu"
                      ) -> torch.Tensor:
    h = act_fn(act)(x @ params["shared_wg"]) * (x @ params["shared_wu"])
    return h @ params["shared_wd"]
