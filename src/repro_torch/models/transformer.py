"""LM family: one parameterized decoder covering the five assigned archs;
the port of ``repro.models.transformer``.

  deepseek-v3-671b  — MLA attention, 1 shared + 256 routed top-8 (sigmoid
                      router, aux-loss-free bias), 3 dense lead layers, MTP
  deepseek-moe-16b  — MHA, 2 shared + 64 routed top-6, 1 dense lead layer
  gemma3-12b/27b    — GQA, 5:1 local:global sliding window, dual RoPE theta,
                      qk-norm, sandwich norms, tied embeddings
  chatglm3-6b       — 2-group MQA, partial rotary (0.5), SwiGLU, qkv bias

Parameters keep the reference's tree: each stack's leaves are stacked
``[L, ...]`` (``blocks``, ``moe_blocks``, ``mtp/block``), so the
reference's ``init_params`` output carries across leaf for leaf
(``train.checkpoint.params_from_numpy``).  The layer stack is a Python
loop over the stacked leaves; each layer takes its window from
``window_pattern`` and its local or global RoPE table by it (window 0 is a
global layer), as the reference's scan selects them.  ``remat=True``
recomputes each layer in the backward (``torch.utils.checkpoint``), which
changes no value.

With a ``DeviceMesh`` the MoE FFN runs expert-parallel (``_moe_ffn``):
each rank holds its experts (``local_params``), the activations stay
replicated over ``model`` and split over the data axes, and the expert
weights are all-gathered over ``fsdp_axis`` inside the layer.  Everything
else runs replicated: the port has no tensor- or sequence-parallel layout.
Gradients through the mesh path follow the reference's unchecked
``shard_map``: the combine's all-reduce passes the gradient through (each
rank's share); the port's ``Trainer`` trains without a mesh.

Sharding plan (``param_pspecs``, DTensor placements of the reference's
PartitionSpecs; Megatron TP on "model", DP/FSDP on "data"):
  embed [V, D]            (model, fsdp)   vocab-parallel
  wq/wk/wv, w_gate/w_up   (-, fsdp, model) column-parallel
  wo, w_down              (-, model, fsdp) row-parallel
  experts [L, E, ...]     (-, ep, ...)    expert-parallel
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    all_gather_dim,
    all_reduce_sum,
    axis_size,
    reduce_scatter_dim,
)
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import TransformerConfig
from repro_torch.models.layers import (
    apply_rope,
    flash_attention,
    gated_mlp,
    init_truncated,
    rms_norm,
    rope_tables,
)
from repro_torch.train.optimizer import to_placements
from repro_torch.train.tree import tree_map


# ------------------------------------------------------------------ init ---
def _zeros(gen, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def _init_attn(gen, cfg: TransformerConfig, n_layers: int
               ) -> Dict[str, torch.Tensor]:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dt = cfg.dtype
    L = n_layers
    if cfg.mla is not None:
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        p = {
            "wq_a": init_truncated(gen, (L, d, m.q_lora_rank), dt),
            "q_ln": _zeros(gen, (L, m.q_lora_rank), dt),
            "wq_b": init_truncated(gen, (L, m.q_lora_rank, h * qk), dt),
            "wkv_a": init_truncated(
                gen, (L, d, m.kv_lora_rank + m.qk_rope_dim), dt),
            "kv_ln": _zeros(gen, (L, m.kv_lora_rank), dt),
            "wk_b": init_truncated(
                gen, (L, m.kv_lora_rank, h, m.qk_nope_dim), dt),
            "wv_b": init_truncated(
                gen, (L, m.kv_lora_rank, h, m.v_head_dim), dt),
            "wo": init_truncated(gen, (L, h * m.v_head_dim, d), dt),
        }
    else:
        p = {
            "wq": init_truncated(gen, (L, d, h * dh), dt),
            "wk": init_truncated(gen, (L, d, hkv * dh), dt),
            "wv": init_truncated(gen, (L, d, hkv * dh), dt),
            "wo": init_truncated(gen, (L, h * dh, d), dt),
        }
        if cfg.qkv_bias:
            p["bq"] = _zeros(gen, (L, h * dh), dt)
            p["bk"] = _zeros(gen, (L, hkv * dh), dt)
            p["bv"] = _zeros(gen, (L, hkv * dh), dt)
    if cfg.qk_norm:
        width = (cfg.d_head if cfg.mla is None
                 else cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)
        p["q_norm"] = _zeros(gen, (L, width), dt)
        p["k_norm"] = _zeros(gen, (L, width), dt)
    return p


def _init_block(gen, cfg: TransformerConfig, n_layers: int, d_ff: int,
                is_moe: bool) -> Dict[str, Any]:
    d, dt, L = cfg.d_model, cfg.dtype, n_layers
    blk: Dict[str, Any] = {
        "ln1": _zeros(gen, (L, d), dt),
        "ln2": _zeros(gen, (L, d), dt),
        "attn": _init_attn(gen, cfg, L),
    }
    if cfg.sandwich_norm:
        blk["ln1_post"] = _zeros(gen, (L, d), dt)
        blk["ln2_post"] = _zeros(gen, (L, d), dt)
    if is_moe:
        blk["moe"] = moe_lib.init_moe_params(gen, d, cfg.moe, dt, n_layers=L)
    else:
        blk["mlp"] = {
            "wg": init_truncated(gen, (L, d, d_ff), dt),
            "wu": init_truncated(gen, (L, d, d_ff), dt),
            "wd": init_truncated(gen, (L, d_ff, d), dt),
        }
    return blk


def init_params(gen: torch.Generator, cfg: TransformerConfig, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters with the reference's keys, shapes and
    distributions, drawn from ``gen`` on ``device`` (a full-width model is
    drawn where it lives, never built on the host and copied).  The
    reference's ``jax.random`` stream cannot be reproduced: carry its
    parameters across to hold the two packages against each other."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params asked for {dev}")
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": init_truncated(gen, (cfg.vocab_size, d), cfg.dtype),
        "final_norm": _zeros(gen, (d,), cfg.dtype),
    }
    d_ff_dense = cfg.moe.d_ff_dense if cfg.moe else cfg.d_ff
    if cfg.n_dense_layers:
        params["blocks"] = _init_block(gen, cfg, cfg.n_dense_layers,
                                       d_ff_dense, is_moe=False)
    if cfg.n_moe_layers:
        params["moe_blocks"] = _init_block(gen, cfg, cfg.n_moe_layers, 0,
                                           is_moe=True)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_truncated(gen, (d, cfg.vocab_size),
                                           cfg.dtype)
    if cfg.mtp_depth:
        params["mtp"] = {
            "norm_h": _zeros(gen, (d,), cfg.dtype),
            "norm_e": _zeros(gen, (d,), cfg.dtype),
            "proj": init_truncated(gen, (2 * d, d), cfg.dtype),
            "block": _init_block(gen, cfg, 1, d_ff_dense, is_moe=False),
            "final_norm": _zeros(gen, (d,), cfg.dtype),
        }
    return params


# ------------------------------------------------------------- shardings ---
def param_pspecs(cfg: TransformerConfig,
                 axis_names: Sequence[str] = ("data", "model")
                 ) -> Dict[str, Any]:
    """Placements tree matching init_params (leading L axis unsharded): the
    reference's PartitionSpecs (TP on "model", FSDP on ``cfg.fsdp_axis``,
    experts over ``cfg.moe_ep_axes``) as DTensor placements over a mesh of
    ``axis_names`` (``train.optimizer.to_placements``)."""
    f = cfg.fsdp_axis
    ep = tuple(cfg.moe_ep_axes)

    def P(*spec):
        return to_placements(spec, axis_names)

    col = P(None, f, "model")  # [L, D, F]
    row = P(None, "model", f)  # [L, F, D]
    rep1 = P(None, None)  # [L, D]
    if cfg.mla is not None:
        attn = {
            "wq_a": P(None, f, None),
            "q_ln": rep1,
            "wq_b": P(None, f, "model"),
            "wkv_a": P(None, f, None),
            "kv_ln": rep1,
            "wk_b": P(None, f, "model", None),
            "wv_b": P(None, f, "model", None),
            "wo": row,
        }
    else:
        attn = {"wq": col, "wk": col, "wv": col, "wo": row}
        if cfg.qkv_bias:
            attn.update({"bq": P(None, "model"), "bk": P(None, "model"),
                         "bv": P(None, "model")})
    if cfg.qk_norm:
        attn["q_norm"] = rep1
        attn["k_norm"] = rep1

    def block_specs(is_moe):
        b = {"ln1": rep1, "ln2": rep1, "attn": dict(attn)}
        if cfg.sandwich_norm:
            b["ln1_post"] = rep1
            b["ln2_post"] = rep1
        if is_moe:
            b["moe"] = {
                "router": P(None, f, None),
                "router_bias": P(None, None),
                "wg": P(None, ep, f, None),
                "wu": P(None, ep, f, None),
                "wd": P(None, ep, None, f),
            }
            if cfg.moe.n_shared:
                b["moe"].update({
                    "shared_wg": col, "shared_wu": col, "shared_wd": row,
                })
        else:
            b["mlp"] = {"wg": col, "wu": col, "wd": row}
        return b

    specs: Dict[str, Any] = {
        "embed": P("model", f),
        "final_norm": P(None),
    }
    if cfg.n_dense_layers:
        specs["blocks"] = block_specs(False)
    if cfg.n_moe_layers:
        specs["moe_blocks"] = block_specs(True)
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(f, "model")
    if cfg.mtp_depth:
        specs["mtp"] = {
            "norm_h": P(None),
            "norm_e": P(None),
            "proj": P(f, None),
            "block": block_specs(False),
            "final_norm": P(None),
        }
    return specs


def local_params(params: Dict[str, Any], cfg: TransformerConfig, mesh
                 ) -> Dict[str, Any]:
    """This rank's view of the full parameter tree for ``forward(...,
    mesh=mesh)``: the routed experts ``wg``/``wu``/``wd`` [L, E, ...] cut to
    the rank's experts (its linearized index over ``moe_ep_axes``) and, with
    ``fsdp_axis`` set, to its FSDP shard of the ``d_model`` axis (as the
    reference's ``shard_map`` in_specs split them); everything else whole."""
    if "moe_blocks" not in params:
        return params
    ep = tuple(cfg.moe_ep_axes)
    n_ep = int(np.prod([axis_size(mesh, a) for a in ep]))
    e_idx = moe_lib.ep_rank(mesh, ep)
    moe = dict(params["moe_blocks"]["moe"])
    for name, d_axis in (("wg", 2), ("wu", 2), ("wd", 3)):
        w = torch.chunk(moe[name], n_ep, dim=1)[e_idx]
        if cfg.fsdp_axis is not None:
            w = torch.chunk(w, axis_size(mesh, cfg.fsdp_axis), dim=d_axis)[
                mesh.get_local_rank(cfg.fsdp_axis)]
        moe[name] = w.contiguous()
    out = dict(params)
    out["moe_blocks"] = dict(params["moe_blocks"], moe=moe)
    return out


# --------------------------------------------------------------- forward ---
def _gqa_attention(x, p, cfg: TransformerConfig, sin, cos, window,
                   q_offset=0):
    b, s, d = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    rd = int(dh * cfg.rotary_pct)
    q = apply_rope(q, sin, cos, rd)
    k = apply_rope(k, sin, cos, rd)
    out = flash_attention(
        q, k, v, window=window, q_offset=q_offset,
        block_k=min(cfg.attn_block_k, s),
    )
    return out.reshape(b, s, h * dh) @ p["wo"], (k, v)


def _mla_attention(x, p, cfg: TransformerConfig, sin, cos, window,
                   q_offset=0):
    """MLA training/prefill path (expanded); decode uses the absorbed path."""
    m = cfg.mla
    b, s, d = x.shape
    h = cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    cq = rms_norm(x @ p["wq_a"], p["q_ln"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(b, s, h, qk)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]

    ckv_full = x @ p["wkv_a"]  # [B,S,kvr+rope]
    c_kv = rms_norm(ckv_full[..., : m.kv_lora_rank], p["kv_ln"], cfg.norm_eps)
    k_rope = ckv_full[..., m.kv_lora_rank:][:, :, None, :]  # [B,S,1,rope]

    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope, sin, cos)

    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, p["wk_b"])
    v = torch.einsum("bsr,rhd->bshd", c_kv, p["wv_b"])
    k = torch.cat(
        [k_nope, k_rope.expand(b, s, h, m.qk_rope_dim)], -1
    )
    q_full = torch.cat([q_nope, q_rope], -1)
    out = flash_attention(
        q_full, k, v, window=window, q_offset=q_offset,
        block_k=min(cfg.attn_block_k, s), softmax_scale=qk ** -0.5,
    )
    out = out.reshape(b, s, h * m.v_head_dim) @ p["wo"]
    # cache payload for prefill: the latent pair (what MLA stores)
    return out, (c_kv, k_rope[:, :, 0, :])


def _moe_ffn(x, moe_params, cfg: TransformerConfig, mesh,
             dp_axes: Tuple[str, ...]):
    """Expert FFN + shared expert. x: [B, S, D].

    With a mesh: experts split over ``moe_ep_axes`` (``local_params``);
    with ``fsdp_axis`` set the rank's FSDP shards of its experts are
    all-gathered here, inside the layer, so a layer's gathered weights live
    only for that layer.  Tokens are all-gathered over any EP axis that also
    carries data (and the rank's own rows taken back after).  The combine
    is an all-reduce over the EP axes ("psum") or, with ``moe_combine=
    "scatter"``, a reduce-scatter over ``model`` on the sequence dim,
    all-gathered back to the replicated layout the port keeps.
    """
    b, s, d = x.shape
    mcfg = cfg.moe
    ep_axes = tuple(cfg.moe_ep_axes) if mesh is not None else ()
    fsdp = cfg.fsdp_axis if mesh is not None else None
    # reduce-scatter combine is valid when EP is the single "model" axis and
    # the sequence divides it (not decode S=1, not multi-axis EP)
    use_scatter = (
        cfg.moe_combine == "scatter" and mesh is not None
        and ep_axes == ("model",) and s % axis_size(mesh, "model") == 0
    )
    wg, wu, wd = moe_params["wg"], moe_params["wu"], moe_params["wd"]
    if fsdp is not None:
        group = mesh.get_group(fsdp)
        wg = all_gather_dim(wg, group, 1)
        wu = all_gather_dim(wu, group, 1)
        wd = all_gather_dim(wd, group, 2)
    # tokens must be replicated over any EP axis that is also a dp axis
    rep = [a for a in dp_axes if a in ep_axes]
    xl = x
    for a in rep:
        xl = all_gather_dim(xl, mesh.get_group(a), 0)
    n = xl.shape[0] * xl.shape[1]
    p_local = {"wg": wg, "wu": wu, "wd": wd, "router": moe_params["router"],
               "router_bias": moe_params["router_bias"]}
    out, metrics = moe_lib.moe_ffn_local(
        xl.reshape(n, d), p_local, mcfg, mesh=mesh, ep_axes=ep_axes,
        act=cfg.act, combine=not use_scatter,
    )
    out = out.reshape(xl.shape)
    dropped = metrics["n_dropped"]
    if use_scatter:  # combine partial expert outputs, sequence-sharded
        group = mesh.get_group("model")
        out = all_gather_dim(reduce_scatter_dim(out, group, 1), group, 1)
        dropped = all_reduce_sum(dropped, group)
    for a in reversed(rep):
        out = torch.chunk(out, axis_size(mesh, a), dim=0)[
            mesh.get_local_rank(a)]
    if mcfg.n_shared:
        out = out + gated_mlp(
            x, moe_params["shared_wg"], moe_params["shared_wu"],
            moe_params["shared_wd"], cfg.act,
        )
    return out, metrics["aux_loss"], dropped


def _block_apply(h, blk_params, cfg: TransformerConfig, sin, cos, window,
                 is_moe: bool, mesh, dp_axes, q_offset=0):
    """One transformer block. Returns (h, kv_payload, aux, dropped)."""
    attn_in = rms_norm(h, blk_params["ln1"], cfg.norm_eps)
    attn_fn = _mla_attention if cfg.mla is not None else _gqa_attention
    attn_out, kv = attn_fn(attn_in, blk_params["attn"], cfg, sin, cos,
                           window, q_offset)
    if cfg.sandwich_norm:
        attn_out = rms_norm(attn_out, blk_params["ln1_post"], cfg.norm_eps)
    h = h + attn_out

    mlp_in = rms_norm(h, blk_params["ln2"], cfg.norm_eps)
    if is_moe:
        mlp_out, aux, dropped = _moe_ffn(mlp_in, blk_params["moe"], cfg,
                                         mesh, dp_axes)
    else:
        mlp_out = gated_mlp(mlp_in, blk_params["mlp"]["wg"],
                            blk_params["mlp"]["wu"],
                            blk_params["mlp"]["wd"], cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        dropped = torch.zeros((), dtype=torch.int32, device=h.device)
    if cfg.sandwich_norm:
        mlp_out = rms_norm(mlp_out, blk_params["ln2_post"], cfg.norm_eps)
    return h + mlp_out, kv, aux, dropped


def layer(stack: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked block tree."""
    return tree_map(lambda x: x[i], stack)


def _run_stack(h, stack, cfg, windows, sin_l, cos_l, sin_g, cos_g,
               is_moe, mesh, dp_axes, collect_kv=False, q_offset=0):
    """The layers of a stacked block in order. windows: [L] per-layer."""
    def apply(hc, blk, sin, cos, w):
        return _block_apply(hc, blk, cfg, sin, cos, w, is_moe, mesh,
                            dp_axes, q_offset)

    kvs, aux, dropped = [], [], []
    for i, w in enumerate(int(x) for x in windows):
        sin, cos = (sin_g, cos_g) if w == 0 else (sin_l, cos_l)
        blk = layer(stack, i)
        if cfg.remat and torch.is_grad_enabled():
            h, kv, a, dr = checkpoint(apply, h, blk, sin, cos, w,
                                      use_reentrant=False)
        else:
            h, kv, a, dr = apply(h, blk, sin, cos, w)
        if collect_kv:
            kvs.append(kv)
        aux.append(a)
        dropped.append(dr)
    kv = (tuple(torch.stack(parts) for parts in zip(*kvs)) if collect_kv
          else None)
    return h, kv, torch.sum(torch.stack(aux)), torch.sum(torch.stack(dropped))


def _rope_dim(cfg: TransformerConfig) -> int:
    return (cfg.mla.qk_rope_dim if cfg.mla is not None
            else int(cfg.d_head * cfg.rotary_pct))


def _embed(params, cfg: TransformerConfig, tokens: torch.Tensor):
    """Token embeddings (``F.embedding``: its backward on the card sorts
    the ids rather than adding with atomics, so a step repeats bit for
    bit)."""
    h = F.embedding(tokens.long(), params["embed"])
    if cfg.scale_embed:
        h = h * torch.tensor(np.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def forward(
    params: Dict[str, Any],
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [B, S] int32
    *,
    mesh=None,
    dp_axes: Tuple[str, ...] = ("data",),
    collect_kv: bool = False,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-sequence forward. Returns (hidden [B,S,D], aux dict).

    aux carries moe metrics and (if collect_kv) the per-layer cache payloads
    for prefill.  With a ``DeviceMesh``, ``tokens`` are this rank's rows
    and ``params`` its ``local_params``.
    """
    b, s = tokens.shape
    h = _embed(params, cfg, tokens)  # [B,S,D]
    positions = q_offset + torch.arange(s, device=h.device)
    rd = _rope_dim(cfg)
    sin_l, cos_l = rope_tables(positions, rd, cfg.rope_theta)
    theta_g = cfg.rope_theta_global or cfg.rope_theta
    sin_g, cos_g = rope_tables(positions, rd, theta_g)

    wp = cfg.window_pattern()
    aux: Dict[str, Any] = {}
    kv_all = []
    if cfg.n_dense_layers:
        h, kv, aux_l, drop = _run_stack(
            h, params["blocks"], cfg, wp[: cfg.n_dense_layers], sin_l, cos_l,
            sin_g, cos_g, False, mesh, dp_axes, collect_kv, q_offset,
        )
        kv_all.append(kv)
        aux["moe_aux_loss"] = aux_l
        aux["moe_dropped"] = drop
    if cfg.n_moe_layers:
        h, kv, aux_l, drop = _run_stack(
            h, params["moe_blocks"], cfg, wp[cfg.n_dense_layers:], sin_l,
            cos_l, sin_g, cos_g, True, mesh, dp_axes, collect_kv, q_offset,
        )
        kv_all.append(kv)
        aux["moe_aux_loss"] = aux.get("moe_aux_loss", 0.0) + aux_l
        aux["moe_dropped"] = aux.get("moe_dropped", 0) + drop
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if collect_kv:
        aux["kv"] = kv_all
    return h, aux


def logits_from_hidden(params, cfg, h):
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    logits = h @ head.to(h.dtype)
    if cfg.logit_softcap > 0:
        c = torch.tensor(cfg.logit_softcap, dtype=logits.dtype,
                         device=logits.device)
        logits = c * torch.tanh(logits / c)
    return logits


def _ce(params, cfg, hid, lab):
    """(summed token CE over labels >= 0, their count)."""
    lg = logits_from_hidden(params, cfg, hid).float()
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, torch.clamp(lab, min=0).long()[..., None]
                        )[..., 0]
    mask = (lab >= 0).float()
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def lm_loss(
    params: Dict[str, Any],
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [B, S]
    labels: torch.Tensor,  # [B, S] (-1 = ignore)
    *,
    mesh=None,
    dp_axes: Tuple[str, ...] = ("data",),
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Causal LM loss (+ MTP auxiliary loss + MoE balance loss)."""
    h, aux = forward(params, cfg, tokens, mesh=mesh, dp_axes=dp_axes)
    total, denom = _ce(params, cfg, h, labels)
    metrics = {"ce_tokens": denom}

    if cfg.mtp_depth:
        # predict t+2: combine h_t with embedding of token t+1 (=labels_t)
        mtp = params["mtp"]
        e_next = F.embedding(torch.clamp(labels, min=0).long(),
                             params["embed"])
        comb = torch.cat(
            [rms_norm(h, mtp["norm_h"], cfg.norm_eps),
             rms_norm(e_next, mtp["norm_e"], cfg.norm_eps)], -1
        ) @ mtp["proj"]
        blk = layer(mtp["block"], 0)  # unstack L=1
        s = comb.shape[1]
        sin, cos = rope_tables(torch.arange(s, device=comb.device),
                               _rope_dim(cfg), cfg.rope_theta)
        h2, _kv, _aux, _drop = _block_apply(
            comb, blk, cfg, sin, cos, 0, False, mesh, dp_axes
        )
        h2 = rms_norm(h2, mtp["final_norm"], cfg.norm_eps)
        labels_mtp = torch.cat(
            [labels[:, 1:], torch.full_like(labels[:, :1], -1)], dim=1
        )
        mtp_total, mtp_denom = _ce(params, cfg, h2, labels_mtp)
        total = total + cfg.mtp_loss_weight * mtp_total
        metrics["mtp_tokens"] = mtp_denom

    loss = total / torch.clamp(denom, min=1.0)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_coef * aux.get("moe_aux_loss", 0.0)
        metrics["moe_aux_loss"] = aux.get("moe_aux_loss", 0.0)
        metrics["moe_dropped"] = aux.get("moe_dropped", 0)
    return loss, metrics
