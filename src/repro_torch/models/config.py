"""Model configuration dataclasses shared by the LM family: the port of
``repro.models.config``.

``dtype`` is a torch dtype.  ``remat`` maps to ``torch.utils.checkpoint``
(a layer recomputed in the backward; no value changes); ``scan_unroll``
is the reference's dry-run cost variant and has no effect here (the layer
stack is a Python loop); ``fsdp_axis``, ``moe_ep_axes`` and ``moe_combine``
name the axes of a ``torch.distributed`` ``DeviceMesh``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    n_shared: int
    d_ff_expert: int
    first_dense_layers: int = 0  # leading dense layers (DeepSeek: 1 or 3)
    d_ff_dense: int = 0  # d_ff of those leading dense layers
    capacity_factor: float = 1.25
    router_score: str = "softmax"  # "softmax" | "sigmoid_norm" (DeepSeek-V3)
    aux_loss_coef: float = 0.001
    # DeepSeek-V3 aux-loss-free balancing keeps a per-expert bias added to
    # routing scores (updated out-of-band by the trainer, not by grads).
    use_routing_bias: bool = False


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None  # gemma3: 1e6 on global layers
    rotary_pct: float = 1.0  # chatglm3: 0.5 ("RoPE 2d" partial rotary)
    window: int = 0  # sliding window width for local layers (0 = none)
    global_every: int = 0  # every Nth layer is global (gemma3: 6 → 5:1)
    act: str = "silu"
    qk_norm: bool = False  # gemma3
    sandwich_norm: bool = False  # gemma3: post-attn/post-ffn norms too
    scale_embed: bool = False  # gemma: embed × sqrt(d_model)
    qkv_bias: bool = False  # chatglm3
    mtp_loss_weight: float = 0.1
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mtp_depth: int = 0  # DeepSeek-V3 multi-token prediction modules
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    remat: bool = True
    attn_block_k: int = 1024
    logit_softcap: float = 0.0
    # The reference's dry-run cost variant (unrolls its layer scans); no
    # effect in the port.
    scan_unroll: bool = False
    # Parallelism plan (the mesh axes of the expert-parallel MoE FFN).
    fsdp_axis: Optional[str] = "data"
    moe_ep_axes: Tuple[str, ...] = ("model",)
    # "psum": the MoE output is all-reduced over the EP axes; "scatter": it
    # is reduce-scattered over `model` on the sequence dim (the port keeps
    # no sequence-parallel layout, so the shards are all-gathered back).
    moe_combine: str = "psum"  # "psum" | "scatter"

    # ----- derived -----
    @property
    def n_dense_layers(self) -> int:
        return self.moe.first_dense_layers if self.moe else self.n_layers

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers if self.moe else 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch has a bounded-window component (long_500k eligible)."""
        return self.window > 0 and self.global_every > 1

    def window_pattern(self) -> np.ndarray:
        """[n_layers] int32 — per-layer window (0 = global/full attention)."""
        w = np.zeros(self.n_layers, np.int32)
        if self.window > 0:
            w[:] = self.window
            if self.global_every > 0:
                # every global_every-th layer is global (gemma3: layers
                # 5, 11, ... full attention; 5 local before each)
                w[self.global_every - 1 :: self.global_every] = 0
            else:
                w[:] = self.window
        return w

    def n_params(self) -> int:
        """Approximate parameter count (embeddings included once)."""
        d, dh = self.d_model, self.d_head
        if self.mla is not None:
            m = self.mla
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        else:
            attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
                + self.n_heads * dh * d
        dense_mlp = 3 * d * (self.moe.d_ff_dense if self.moe else self.d_ff)
        total = self.n_dense_layers * (attn + dense_mlp)
        if self.moe:
            e = self.moe
            expert = 3 * d * e.d_ff_expert
            per_moe = attn + e.n_routed * expert + e.n_shared * expert \
                + d * e.n_routed
            total += self.n_moe_layers * per_moe
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        e = self.moe
        expert = 3 * d * e.d_ff_expert
        full = self.n_params()
        inactive = self.n_moe_layers * (e.n_routed - e.top_k) * expert
        return full - inactive


def scaled_down(cfg: TransformerConfig, **overrides) -> TransformerConfig:
    """Smoke-test reduction: same family/topology, tiny dims."""
    small = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        d_head=32,
        d_ff=256,
        vocab_size=512,
        dtype=torch.float32,
        remat=False,
        attn_block_k=64,
    )
    if cfg.window:
        small["window"] = 16
    if cfg.moe:
        small["moe"] = dataclasses.replace(
            cfg.moe,
            n_routed=8,
            top_k=min(cfg.moe.top_k, 2),
            n_shared=min(cfg.moe.n_shared, 1),
            d_ff_expert=64,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            d_ff_dense=256,
            # generous capacity: batch-independent routing makes smoke tests
            # (prefill == forward) deterministic; full configs keep 1.25
            capacity_factor=8.0,
        )
    if cfg.mla:
        small["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
            v_head_dim=32,
        )
        small["d_head"] = 48  # nope+rope
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
