"""gemma3-27b [hf:google/gemma-3-27b-pt; unverified tier].

62L d_model=5376 32H (GQA kv=16, d_head 128) d_ff=21504 vocab=262144,
5:1 local:global sliding window, dual RoPE theta, qk-norm, sandwich norms.
Hybrid local/global ⇒ long_500k RUNS for this arch.
"""

from repro_torch.models.config import TransformerConfig, scaled_down

ARCH_ID = "gemma3-27b"
FAMILY = "lm"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        d_head=128,
        d_ff=21504,
        vocab_size=262144,
        rope_theta=1e4,
        rope_theta_global=1e6,
        window=1024,
        global_every=6,
        act="gelu",
        qk_norm=True,
        sandwich_norm=True,
        scale_embed=True,
        tie_embeddings=True,
    )


def smoke_config() -> TransformerConfig:
    return scaled_down(config(), global_every=2)
