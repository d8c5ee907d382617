"""bst [arXiv:1905.06874; paper tier] — Behavior Sequence Transformer.

embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256; transformer
over [history ‖ target] then MLP CTR head.
"""

import dataclasses

from repro_torch.models.recsys.models import RecsysConfig

ARCH_ID = "bst"
FAMILY = "recsys"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        arch="bst",
        embed_dim=32,
        seq_len=20,
        n_dense=13,
        n_blocks=1,
        n_heads=8,
        mlp_dims=(1024, 512, 256),
        vocab_items=1_048_576,
    )


def smoke_config() -> RecsysConfig:
    return dataclasses.replace(
        config(), vocab_items=1000, seq_len=8, mlp_dims=(64, 32),
    )
