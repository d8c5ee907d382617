"""wide-deep [arXiv:1606.07792; paper tier].

n_sparse=40 embed_dim=32 mlp=1024-512-256, concat interaction; linear wide
path over the fused sparse-field table.
"""

import dataclasses

from repro_torch.models.recsys.models import RecsysConfig

ARCH_ID = "wide-deep"
FAMILY = "recsys"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        arch="wide_deep",
        embed_dim=32,
        n_sparse=40,
        n_dense=13,
        mlp_dims=(1024, 512, 256),
        vocab_items=1_048_576,
        vocab_sparse=1_048_576,
        seq_len=0,
    )


def smoke_config() -> RecsysConfig:
    return dataclasses.replace(
        config(), vocab_items=1000, vocab_sparse=500, n_sparse=6,
        mlp_dims=(64, 32),
    )
