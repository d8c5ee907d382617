"""deepseek-moe-16b [arXiv:2401.06066; hf].

28L d_model=2048 16H (MHA), 2 shared + 64 routed top-6 fine-grained experts
(d_ff 1408), first layer dense (d_ff 10944), vocab 102 400.  Pure full
attention ⇒ long_500k skipped per DESIGN.md §6.
"""

from repro_torch.models.config import (
    MoEConfig, TransformerConfig, scaled_down)

ARCH_ID = "deepseek-moe-16b"
FAMILY = "lm"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_head=128,
        d_ff=10944,
        vocab_size=102400,
        rope_theta=1e4,
        moe=MoEConfig(
            n_routed=64,
            top_k=6,
            n_shared=2,
            d_ff_expert=1408,
            first_dense_layers=1,
            d_ff_dense=10944,
            capacity_factor=1.25,
            router_score="softmax",
            aux_loss_coef=0.001,
        ),
        tie_embeddings=False,
    )


def smoke_config() -> TransformerConfig:
    return scaled_down(config())
