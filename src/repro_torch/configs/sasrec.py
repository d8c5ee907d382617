"""sasrec [arXiv:1808.09781; paper tier].

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50, causal self-attention over the
item history, dot-product next-item scoring (natively retrieval-friendly).
"""

import dataclasses

from repro_torch.models.recsys.models import RecsysConfig

ARCH_ID = "sasrec"
FAMILY = "recsys"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID,
        arch="sasrec",
        embed_dim=50,
        seq_len=50,
        n_dense=13,
        n_blocks=2,
        n_heads=1,
        vocab_items=1_048_576,
    )


def smoke_config() -> RecsysConfig:
    return dataclasses.replace(config(), vocab_items=1000, seq_len=12)
