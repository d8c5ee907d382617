"""Shared transformer layers: norms, RoPE, attention (GQA / windowed /
blockwise online softmax), gated MLPs: the port of
``repro.models.layers``.

  * ``flash_attention`` is the reference's blockwise online softmax over KV
    blocks in plain PyTorch (a Python loop over the blocks): O(S·blk) live
    scores instead of O(S²).  The reference's is XLA code, not a Pallas
    kernel, so the port has no kernel for it.  Masked scores are -1e30,
    never -inf, so a fully masked row stays finite.
  * Sliding windows are a mask parameter, not a code path: local and
    global layers share one function (window 0 is global).
  * ``decode_attention`` is one token's plain einsum + softmax over a cache.

Every division by a constant that the reference computes as a Python
scalar divides by an f32 tensor here (the card turns a division by a
Python scalar into a reciprocal multiply, which rounds otherwise).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

BIG_WINDOW = 2**30
_MASKED = -1e30
_DRAW_ELEMS = 1 << 28  # the largest f32 draw init_truncated makes at once

IntLike = Union[int, torch.Tensor]


# ----------------------------------------------------------------- init ----
def init_truncated(gen: torch.Generator, shape, dtype, stddev: float = 0.02
                   ) -> torch.Tensor:
    """``jax.nn.initializers.truncated_normal(stddev)`` drawn from ``gen``
    on its device, a slice of the leading axis at a time where the leaf is
    large, so a bf16 leaf never holds its whole size in f32 at once."""
    from repro_torch.models.recsys.embedding import truncated_normal

    shape = tuple(shape)
    if math.prod(shape) <= _DRAW_ELEMS or len(shape) < 2:
        return truncated_normal(gen, shape, stddev, dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = _DRAW_ELEMS // math.prod(shape[1:])
    if rows == 0:  # one slice of the leading axis is itself too large
        for i in range(shape[0]):
            out[i] = init_truncated(gen, shape[1:], dtype, stddev)
        return out
    for i in range(0, shape[0], rows):
        n = min(rows, shape[0] - i)
        out[i:i + n] = truncated_normal(gen, (n,) + shape[1:], stddev, dtype)
    return out


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + scale`` gain (``scale`` starts at 0)."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


# ----------------------------------------------------------------- rope ----
def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sin, cos) tables [*, dim/2] f32 for given positions."""
    dev = positions.device
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=dev) \
        / torch.tensor(dim, dtype=torch.float32, device=dev)
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv  # [*, dim/2]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Rotates the first ``rotary_dim`` dims of x [..., S, H, dh] (pairwise,
    NEOX-style split halves). sin/cos: [S, rotary_dim/2]."""
    dh = x.shape[-1]
    rd = rotary_dim or dh
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = torch.chunk(xr.float(), 2, dim=-1)
    s = sin[..., None, :]  # [S, 1, rd/2] broadcast over heads
    c = cos[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.cat([o1, o2], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < dh else out


# ------------------------------------------------------------ attention ----
def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: IntLike,
                causal: bool) -> torch.Tensor:
    """[Sq, Sk] bool; window<=0 means unbounded (global layer)."""
    w = torch.as_tensor(window, device=q_pos.device)
    w = torch.where(w > 0, w, BIG_WINDOW)
    d = q_pos[:, None] - k_pos[None, :]
    m = d < w
    if causal:
        m = m & (d >= 0)
    return m


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, dh]
    k: torch.Tensor,  # [B, Sk, Hkv, dh]
    v: torch.Tensor,  # [B, Sk, Hkv, dhv]
    *,
    window: IntLike = 0,
    causal: bool = True,
    q_offset: IntLike = 0,
    block_k: int = 1024,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Blockwise-softmax attention (GQA-aware). Returns [B, Sq, H, dhv].

    One online-softmax pass over KV blocks; [B, Sq, H, block_k] live scores.
    Raises when ``Sk`` is not a multiple of ``min(block_k, Sk)``.
    """
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dhv = v.shape[-1]
    g = h // hkv
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    blk = min(block_k, sk)
    if sk % blk:
        raise ValueError(f"Sk={sk} must be divisible by block_k={blk}")
    nblk = sk // blk
    dev = q.device

    qg = q.reshape(b, sq, hkv, g, dh).float() * scale
    q_pos = torch.as_tensor(q_offset, device=dev) + torch.arange(sq,
                                                                 device=dev)
    m = torch.full((b, sq, hkv, g), _MASKED, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, g, dhv), dtype=torch.float32, device=dev)
    for bi in range(nblk):
        kblk = k[:, bi * blk:(bi + 1) * blk].float()
        vblk = v[:, bi * blk:(bi + 1) * blk].float()
        s = torch.einsum("bqkgd,bjkd->bqkgj", qg, kblk)  # [B,Sq,Hkv,G,blk]
        k_pos = bi * blk + torch.arange(blk, device=dev)
        mask = _block_mask(q_pos, k_pos, window, causal)  # [Sq, blk]
        s = torch.where(mask[None, :, None, None, :], s, _MASKED)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgj,bjkd->bqkgd", p,
                                                   vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, dhv).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # [B, 1, H, dh]
    k_cache: torch.Tensor,  # [B, S, Hkv, dh]
    v_cache: torch.Tensor,  # [B, S, Hkv, dhv]
    *,
    position: torch.Tensor,  # [B] current write position
    window: IntLike = 0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over a KV cache (attends to < position+1)."""
    b, _, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = softmax_scale if softmax_scale is not None else dh ** -0.5
    dev = q.device
    qg = q.reshape(b, hkv, g, dh).float() * scale
    logits = torch.einsum("bkgd,bjkd->bkgj", qg,
                          k_cache.float())  # [B,Hkv,G,S]
    pos_k = torch.arange(s, device=dev)[None, :]  # [1, S]
    w = torch.as_tensor(window, device=dev)
    w = torch.where(w > 0, w, BIG_WINDOW)
    dist = position.to(dev)[:, None] - pos_k
    valid = (dist >= 0) & (dist < w)  # [B, S]
    logits = torch.where(valid[:, None, None, :], logits, _MASKED)
    mx = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - mx)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgj,bjkd->bkgd", p / torch.clamp(l, min=1e-30),
                       v_cache.float())
    return out.reshape(b, 1, h, -1).to(q.dtype)


# ---------------------------------------------------------------- mlps -----
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU/GeGLU: down( act(x·gate) ⊙ (x·up) )."""
    h = act_fn(act)(x @ w_gate) * (x @ w_up)
    return h @ w_down
