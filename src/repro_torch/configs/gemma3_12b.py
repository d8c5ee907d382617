"""gemma3-12b [hf:google/gemma-3-12b-pt; unverified tier].

48L d_model=3840 16H (GQA kv=8, d_head 256) d_ff=15360 vocab=262144,
5:1 local:global sliding window (1024), dual RoPE theta (10k local / 1M
global), qk-norm, sandwich norms, tied embeddings, 128k context.
Hybrid local/global ⇒ long_500k RUNS for this arch (local layers cache only
their 1024-token window).
"""

from repro_torch.models.config import TransformerConfig, scaled_down

ARCH_ID = "gemma3-12b"
FAMILY = "lm"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv_heads=8,
        d_head=256,
        d_ff=15360,
        vocab_size=262144,
        rope_theta=1e4,
        rope_theta_global=1e6,
        window=1024,
        global_every=6,  # 5 local : 1 global
        act="gelu",
        qk_norm=True,
        sandwich_norm=True,
        scale_embed=True,
        tie_embeddings=True,
    )


def smoke_config() -> TransformerConfig:
    return scaled_down(config(), global_every=2)
