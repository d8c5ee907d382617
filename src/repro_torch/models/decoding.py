"""Serving paths: prefill, KV caches, single-token decode; the port of
``repro.models.decoding``.

Cache layouts:

  * uniform mode (no sliding windows — deepseek/chatglm): caches stacked per
    layer ``[L, B, S, ...]`` (``"dense"``, ``"moe"``).
  * gemma mode (window + global_every): layers run in *rounds* of
    (G−1 local + 1 global).  Local layers keep **ring buffers of length W**
    (the window, slot ``p % W``), global layers the full ``s_max``; trailing
    local layers are the ``"tail"``.
  * MLA decode uses the absorbed formulation: scores are taken directly
    against the latent cache (``q̃ = q_nope·W_uk``), and the attention output
    is computed in latent space then expanded through ``W_uv``; the cache is
    ``[S, kv_lora + rope]`` wide.

With ``kv_group`` (a process group) every cache's sequence axis is split
over its ranks, as the reference's serving plan shards it (rank r holds
positions ``[r·S_l, (r+1)·S_l)`` of each cache, a ring's slots alike):
the rank that holds the write position writes it, and attention combines
each rank's partial softmax (its max, sum and weighted values, all-reduced
over the group).

The decode step assumes a shared scalar position (synchronous batch
decode).  It writes the new token's keys and values into the cache's
tensors in place and returns the same cache.  A write position past the
cache's end is clamped to its last slot, as the reference's
``dynamic_update_slice`` clamps its start index.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import all_reduce
from repro_torch.models.config import TransformerConfig
from repro_torch.models.layers import (
    apply_rope,
    gated_mlp,
    rms_norm,
    rope_tables,
)
from repro_torch.models.transformer import (
    _embed,
    _moe_ffn,
    forward,
    layer,
    logits_from_hidden,
)
from repro_torch.train.tree import tree_map

_MASKED = -1e30


class TensorSpec(NamedTuple):
    """A cache tensor's shape and dtype (the reference's
    ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: Any


# ------------------------------------------------------------ utilities ---
def _rope_at(pos: int, dim: int, theta: float, device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) [1, dim/2] at a scalar position (broadcasts over batch)."""
    return rope_tables(torch.tensor([pos], device=device), dim, theta)


def _ring_valid(pos: int, w: int, device) -> torch.Tensor:
    """Which ring slots hold a position (the one stored in slot j at
    write-time ``pos`` is ``pos - (pos - j) mod w``) that is not negative."""
    slots = torch.arange(w, device=device)
    return pos - torch.remainder(pos - slots, w) >= 0


class KVSplit:
    """A decode cache's sequence axis split over ``group`` (None: whole);
    ``s_local`` is this rank's share of positions or ring slots."""

    def __init__(self, group, s_local: int):
        self.group = group
        n = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        self.s_local = s_local
        self.offset = rank * s_local
        self.total = s_local * n

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a [total] row (validity over slots)."""
        return x[self.offset:self.offset + self.s_local]

    def reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        return x if self.group is None else all_reduce(x, self.group, op)


def _softmax_rows(logits, values, eq: str, split):
    """Softmax over the last axis of ``logits`` applied to ``values``
    (``eq``): whole, or combined from each rank's part of the axis."""
    m = torch.amax(logits, dim=-1, keepdim=True)
    if split is None or split.group is None:
        p = torch.exp(logits - m)
        l = torch.sum(p, dim=-1, keepdim=True)
        return torch.einsum(eq, p / torch.clamp(l, min=1e-30), values)
    m = split.reduce(m, dist.ReduceOp.MAX)
    p = torch.exp(logits - m)
    l = split.reduce(torch.sum(p, dim=-1, keepdim=True))
    out = split.reduce(torch.einsum(eq, p, values))
    return out / torch.clamp(l, min=1e-30)


def _attend_cache(q, k_cache, v_cache, valid, scale, split=None):
    """q [B,1,H,dh] vs cache [B,S,Hkv,dh(v)] with explicit key validity."""
    b, _, h, dh = q.shape
    hkv = k_cache.shape[2]
    g = h // hkv
    qg = q.reshape(b, hkv, g, dh).float() * scale
    logits = torch.einsum("bkgd,bjkd->bkgj", qg, k_cache.float())
    logits = torch.where(valid[None, None, None, :], logits, _MASKED)
    out = _softmax_rows(logits, v_cache.float(), "bkgj,bjkd->bkgd", split)
    return out.reshape(b, 1, h, -1)


def _write(cache: torch.Tensor, x: torch.Tensor, slot: int, split=None):
    """``cache[:, slot] = x[:, 0]`` in place, the slot clamped into range
    (with a split cache, on the rank that holds the slot)."""
    if split is None:
        cache[:, min(slot, cache.shape[1] - 1)] = x[:, 0].to(cache.dtype)
        return
    slot = min(slot, split.total - 1) - split.offset
    if 0 <= slot < split.s_local:
        cache[:, slot] = x[:, 0].to(cache.dtype)


# ----------------------------------------------------- per-layer decodes ---
def _gqa_decode(x, p, cfg: TransformerConfig, kc, vc, pos: int, theta,
                ring_w: int = 0, kv_group=None, tp=None):
    """x [B,1,D]; kc/vc [B,S,Hkv,dh], written in place. Returns out
    (under ``tp``: this rank's partial product, its heads' rows of wo)."""
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if tp is not None:  # every head: the cache holds them all
        q, k, v = (tp.gather(t, -1) for t in (q, k, v))
    q = q.reshape(b, 1, h, dh)
    k = k.reshape(b, 1, hkv, dh)
    v = v.reshape(b, 1, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    rd = int(dh * cfg.rotary_pct)
    sin, cos = _rope_at(pos, rd, theta, x.device)
    q = apply_rope(q, sin, cos, rd)
    k = apply_rope(k, sin, cos, rd)

    split = None if kv_group is None else KVSplit(kv_group, kc.shape[1])
    if ring_w:
        slot = pos % ring_w
        valid = _ring_valid(pos, ring_w, x.device)
    else:
        slot = pos
        n = kc.shape[1] if split is None else split.total
        valid = torch.arange(n, device=x.device) <= pos
    if split is not None:
        valid = split.local(valid)
    _write(kc, k, slot, split)
    _write(vc, v, slot, split)
    out = _attend_cache(q, kc, vc, valid, dh ** -0.5, split)
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    if tp is not None:
        width = tp.heads(h) * dh
        out = out[..., tp.rank * width:(tp.rank + 1) * width]
    return out @ p["wo"]


def _mla_decode(x, p, cfg: TransformerConfig, ckv_c, kr_c, pos: int, theta,
                kv_group=None, tp=None):
    """Absorbed MLA decode. ckv_c [B,S,kvr], kr_c [B,S,rope], in place.
    Under ``tp`` the absorbed queries of every head are gathered (the
    cache serves them all) and this rank expands its heads."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads if tp is None else tp.heads(cfg.n_heads)
    qk = m.qk_nope_dim + m.qk_rope_dim

    cq = rms_norm(x @ p["wq_a"], p["q_ln"], cfg.norm_eps)
    q = (cq @ p["wq_b"]).reshape(b, 1, h, qk)
    q_nope, q_rope = q[..., : m.qk_nope_dim], q[..., m.qk_nope_dim:]
    sin, cos = _rope_at(pos, m.qk_rope_dim, theta, x.device)
    q_rope = apply_rope(q_rope, sin, cos)

    ckv_full = x @ p["wkv_a"]  # [B,1,kvr+rope]
    c_kv = rms_norm(ckv_full[..., : m.kv_lora_rank], p["kv_ln"], cfg.norm_eps)
    k_rope = apply_rope(
        ckv_full[..., m.kv_lora_rank:][:, :, None, :], sin, cos
    )[:, :, 0, :]
    split = None if kv_group is None else KVSplit(kv_group, ckv_c.shape[1])
    _write(ckv_c, c_kv, pos, split)
    _write(kr_c, k_rope, pos, split)

    # absorbed scores: q̃_h = W_uk,hᵀ q_nope  →  [B,H,kvr]
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                         p["wk_b"].float())
    q_pe = q_rope[:, 0].float()
    if tp is not None:
        q_abs, q_pe = tp.gather(q_abs, 1), tp.gather(q_pe, 1)
    logits = (
        torch.einsum("bhr,bsr->bhs", q_abs, ckv_c.float())
        + torch.einsum("bhe,bse->bhs", q_pe, kr_c.float())
    ) * (qk ** -0.5)
    n = ckv_c.shape[1] if split is None else split.total
    valid = torch.arange(n, device=x.device) <= pos
    if split is not None:
        valid = split.local(valid)
    logits = torch.where(valid[None, None, :], logits, _MASKED)
    o_lat = _softmax_rows(logits, ckv_c.float(), "bhs,bsr->bhr", split)
    if tp is not None:
        o_lat = o_lat[:, tp.rank * h:(tp.rank + 1) * h]
    out = torch.einsum("bhr,rhd->bhd", o_lat, p["wv_b"].float())
    return out.reshape(b, 1, h * m.v_head_dim).to(x.dtype) @ p["wo"]


def _block_decode(h, blk, cfg: TransformerConfig, c0, c1, pos, theta,
                  is_moe, ring_w, mesh, dp_axes, kv_group=None, tp=None):
    attn_in = rms_norm(h, blk["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        attn_out = _mla_decode(attn_in, blk["attn"], cfg, c0, c1, pos, theta,
                               kv_group, tp)
    else:
        attn_out = _gqa_decode(attn_in, blk["attn"], cfg, c0, c1, pos, theta,
                               ring_w, kv_group, tp)
    if tp is not None:
        attn_out = tp.reduce(attn_out)
    if cfg.sandwich_norm:
        attn_out = rms_norm(attn_out, blk["ln1_post"], cfg.norm_eps)
    h = h + attn_out
    mlp_in = rms_norm(h, blk["ln2"], cfg.norm_eps)
    if is_moe:
        mlp_out, _, _ = _moe_ffn(mlp_in, blk["moe"], cfg, mesh, dp_axes, tp)
    else:
        mlp_out = gated_mlp(mlp_in, blk["mlp"]["wg"], blk["mlp"]["wu"],
                            blk["mlp"]["wd"], cfg.act)
        if tp is not None:
            mlp_out = tp.reduce(mlp_out)
    if cfg.sandwich_norm:
        mlp_out = rms_norm(mlp_out, blk["ln2_post"], cfg.norm_eps)
    return h + mlp_out


# -------------------------------------------------------- cache factory ---
def cache_spec(cfg: TransformerConfig, batch: int, s_max: int
               ) -> Dict[str, Any]:
    """Shapes and dtypes of the decode cache (``TensorSpec`` pairs)."""
    dt = cfg.dtype
    m = cfg.mla

    def kv_shapes(n, s):
        if m is not None:
            return (TensorSpec((n, batch, s, m.kv_lora_rank), dt),
                    TensorSpec((n, batch, s, m.qk_rope_dim), dt))
        shape = (n, batch, s, cfg.n_kv_heads, cfg.d_head)
        return TensorSpec(shape, dt), TensorSpec(shape, dt)

    if not cfg.sub_quadratic:
        spec: Dict[str, Any] = {}
        if cfg.n_dense_layers:
            spec["dense"] = kv_shapes(cfg.n_dense_layers, s_max)
        if cfg.n_moe_layers:
            spec["moe"] = kv_shapes(cfg.n_moe_layers, s_max)
        return spec

    g = cfg.global_every
    n_rounds = cfg.n_layers // g
    n_tail = cfg.n_layers - n_rounds * g  # trailing local layers
    w = min(cfg.window, s_max)
    spec = {
        "local": kv_shapes(n_rounds * (g - 1), w),
        "global": kv_shapes(n_rounds, s_max),
    }
    if n_tail:
        spec["tail"] = kv_shapes(n_tail, w)
    return spec


def init_cache(cfg: TransformerConfig, batch: int, s_max: int, *,
               device="cuda") -> Dict[str, Any]:
    dev = resolve_device(device)
    return {name: tuple(torch.zeros(s.shape, dtype=s.dtype, device=dev)
                        for s in pair)
            for name, pair in cache_spec(cfg, batch, s_max).items()}


def _gemma_layers(cfg: TransformerConfig):
    """(local, global, tail) layer indices in round-execution order."""
    g = cfg.global_every
    n_rounds = cfg.n_layers // g
    local_idx = [r * g + j for r in range(n_rounds) for j in range(g - 1)]
    global_idx = [r * g + (g - 1) for r in range(n_rounds)]
    tail_idx = list(range(n_rounds * g, cfg.n_layers))
    return local_idx, global_idx, tail_idx


def decode_layout(params: Dict[str, Any], cfg: TransformerConfig
                  ) -> Dict[str, Any]:
    """Re-lays stacked block params for decode.

    Uniform archs: identity.  Gemma mode: blocks [L, ...] →
    {"local": [R·(G−1), ...], "global": [R, ...], "tail": [L_rem, ...]}
    in round-execution order (a one-time copy at server start).
    """
    if not cfg.sub_quadratic:
        return params
    local_idx, global_idx, tail_idx = _gemma_layers(cfg)
    blocks = params["blocks"]

    def take(idx):
        return tree_map(lambda x: torch.index_select(
            x, 0, torch.tensor(idx, dtype=torch.long, device=x.device)),
            blocks)

    out = dict(params)
    out["blocks_local"] = take(local_idx)
    out["blocks_global"] = take(global_idx)
    if tail_idx:
        out["blocks_tail"] = take(tail_idx)
    del out["blocks"]
    return out


# ------------------------------------------------------------ the steps ---
@torch.no_grad()
def decode_step(
    params: Dict[str, Any],
    cfg: TransformerConfig,
    cache: Dict[str, Any],
    tokens: torch.Tensor,  # [B] int32
    pos,  # int (or a 0-d tensor): the current write position
    *,
    mesh=None,
    dp_axes: Tuple[str, ...] = ("data",),
    kv_group=None,
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token for the whole batch (``params`` from ``decode_layout``).
    Returns (logits [B, V], the cache, written in place).  ``kv_group``:
    the caches hold this rank's part of their sequence axis (module
    docstring); ``tp``: the weights are this rank's tensor-parallel shards
    (``transformer.TensorParallel``), the logits gathered whole."""
    pos = int(pos)
    h = _embed(params, cfg, tokens[:, None], tp)  # [B,1,D]
    theta_l = cfg.rope_theta
    theta_g = cfg.rope_theta_global or cfg.rope_theta

    def run(h, stack, pair, is_moe, theta, ring_w):
        for i in range(pair[0].shape[0]):
            h = _block_decode(h, layer(stack, i), cfg, pair[0][i], pair[1][i],
                              pos, theta, is_moe, ring_w, mesh, dp_axes,
                              kv_group, tp)
        return h

    if not cfg.sub_quadratic:
        if cfg.n_dense_layers:
            h = run(h, params["blocks"], cache["dense"], False, theta_l, 0)
        if cfg.n_moe_layers:
            h = run(h, params["moe_blocks"], cache["moe"], True, theta_l, 0)
    else:
        gm1 = cfg.global_every - 1
        loc, glo = cache["local"], cache["global"]
        for r in range(cfg.n_layers // cfg.global_every):
            for j in range(r * gm1, (r + 1) * gm1):
                h = _block_decode(h, layer(params["blocks_local"], j), cfg,
                                  loc[0][j], loc[1][j], pos, theta_l, False,
                                  cfg.window, mesh, dp_axes, kv_group, tp)
            h = _block_decode(h, layer(params["blocks_global"], r), cfg,
                              glo[0][r], glo[1][r], pos, theta_g, False, 0,
                              mesh, dp_axes, kv_group, tp)
        if "blocks_tail" in params:
            h = run(h, params["blocks_tail"], cache["tail"], False, theta_l,
                    cfg.window)

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_from_hidden(params, cfg, h, tp)[:, 0, :]  # [B, V]
    if tp is not None:
        logits = tp.gather(logits, -1)
    return logits, cache


@torch.no_grad()
def prefill(
    params: Dict[str, Any],
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [B, S]
    s_max: int,
    *,
    mesh=None,
    dp_axes: Tuple[str, ...] = ("data",),
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Full-prompt pass; returns (logits [B, S, V], decode cache @ s_max).
    Under ``tp`` the logits are this rank's vocabulary range and the cache
    holds its heads."""
    b, s = tokens.shape
    h, aux = forward(params, cfg, tokens, mesh=mesh, dp_axes=dp_axes,
                     collect_kv=True, tp=tp)
    logits = logits_from_hidden(params, cfg, h, tp)
    kv_stacks = aux["kv"]  # list per stack: (k|ckv [L,B,S,...], v|kr)

    def to_cache(pair, s_cache):
        def pad_or_ring(x):
            if s_cache >= s:  # linear cache, pad tail
                out = x.new_zeros(x.shape[:2] + (s_cache,) + x.shape[3:])
                out[:, :, :s] = x
                return out
            # ring: keep the last s_cache positions at slot p % W
            w = s_cache
            slots = torch.remainder(torch.arange(s - w, s, device=x.device),
                                    w)
            out = x.new_zeros(x.shape[:2] + (w,) + x.shape[3:])
            out[:, :, slots] = x[:, :, s - w:]
            return out

        return tuple(pad_or_ring(x) for x in pair)

    cache: Dict[str, Any] = {}
    if not cfg.sub_quadratic:
        i = 0
        if cfg.n_dense_layers:
            cache["dense"] = to_cache(kv_stacks[i], s_max)
            i += 1
        if cfg.n_moe_layers:
            cache["moe"] = to_cache(kv_stacks[i], s_max)
    else:
        w = cfg.window  # ring length
        pair = kv_stacks[0]  # single dense stack [L, ...]
        local_idx, global_idx, tail_idx = _gemma_layers(cfg)

        def pick(idx):
            sel = torch.tensor(idx, dtype=torch.long, device=pair[0].device)
            return tuple(torch.index_select(x, 0, sel) for x in pair)

        cache["local"] = to_cache(pick(local_idx), min(w, s_max))
        cache["global"] = to_cache(pick(global_idx), s_max)
        if tail_idx:
            cache["tail"] = to_cache(pick(tail_idx), min(w, s_max))
    return logits, cache


@torch.no_grad()
def greedy_generate(params, cfg, prompt, n_new: int, s_max: int, *,
                    mesh=None, device="cuda") -> torch.Tensor:
    """Prefill + greedy decode (tests, examples): [B, n_new] int32 tokens.
    ``params`` live on ``device`` (default the card; raises where CUDA is
    absent); ``prompt`` [B, S] is moved there."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, asked "
                         f"for {dev}")
    prompt = torch.as_tensor(np.asarray(prompt) if not isinstance(
        prompt, torch.Tensor) else prompt).to(dev)
    b, s = prompt.shape
    dparams = decode_layout(params, cfg)
    logits, cache = prefill(params, cfg, prompt, s_max, mesh=mesh)
    tok = torch.argmax(logits[:, -1, :], -1).int()
    outs = [tok]
    for i in range(n_new - 1):
        logits_i, cache = decode_step(dparams, cfg, cache, tok, s + i,
                                      mesh=mesh)
        tok = torch.argmax(logits_i, -1).int()
        outs.append(tok)
    return torch.stack(outs, dim=1)  # [B, n_new]
