"""din [arXiv:1706.06978; paper tier].

embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80, target-attention
interaction.  The paper's IVF index serves this arch's candidate-generation
stage (retrieval_cand) — DESIGN.md §5.
"""

import dataclasses

from repro_torch.models.recsys.models import RecsysConfig

ARCH_ID = "din"
FAMILY = "recsys"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        arch="din",
        embed_dim=18,
        seq_len=100,
        n_dense=13,
        attn_mlp_dims=(80, 40),
        mlp_dims=(200, 80),
        vocab_items=1_048_576,
    )


def smoke_config() -> RecsysConfig:
    return dataclasses.replace(
        config(), vocab_items=1000, seq_len=12,
    )
