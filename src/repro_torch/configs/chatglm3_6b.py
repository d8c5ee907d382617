"""chatglm3-6b [arXiv:2406.12793; hf].

28L d_model=4096 32H (2-group MQA, kv=2) d_ff=13696 vocab=65024,
partial rotary 0.5 ("RoPE 2d"), qkv bias, SwiGLU.  Pure full attention ⇒
long_500k skipped per DESIGN.md §6.
"""

from repro_torch.models.config import TransformerConfig, scaled_down

ARCH_ID = "chatglm3-6b"
FAMILY = "lm"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_head=128,
        d_ff=13696,
        vocab_size=65024,
        rope_theta=1e4,
        rotary_pct=0.5,
        qkv_bias=True,
        act="silu",
        tie_embeddings=False,
    )


def smoke_config() -> TransformerConfig:
    return scaled_down(config(), n_kv_heads=2)
