"""deepseek-v3-671b [arXiv:2412.19437; hf].

61L d_model=7168 128H, MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 /
v 128), 1 shared + 256 routed top-8 experts (sigmoid router, aux-loss-free
bias), expert d_ff 2048, first 3 layers dense (d_ff 18432), vocab 129 280,
MTP depth 1.  Pure full attention on every layer (MLA compresses KV *width*,
not length) ⇒ long_500k is skipped per DESIGN.md §6.
"""

from repro_torch.models.config import (
    MLAConfig, MoEConfig, TransformerConfig, scaled_down)

ARCH_ID = "deepseek-v3-671b"
FAMILY = "lm"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_head=192,  # qk_nope + qk_rope
        d_ff=18432,
        vocab_size=129280,
        rope_theta=1e4,
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_dim=128,
            qk_rope_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            n_routed=256,
            top_k=8,
            n_shared=1,
            d_ff_expert=2048,
            first_dense_layers=3,
            d_ff_dense=18432,
            capacity_factor=1.25,
            router_score="sigmoid_norm",
            use_routing_bias=True,
        ),
        mtp_depth=1,
        tie_embeddings=False,
    )


def smoke_config() -> TransformerConfig:
    return scaled_down(config())
