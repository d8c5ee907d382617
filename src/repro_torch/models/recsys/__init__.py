"""The recsys models of the port (``repro.models.recsys``)."""

from repro_torch.models.recsys.embedding import (
    embedding_bag,
    embedding_bag_ragged,
    init_table,
    sharded_embedding_bag,
)
from repro_torch.models.recsys.models import (
    RecsysBatch,
    RecsysConfig,
    forward,
    init_params,
    loss_fn,
    retrieval_scores,
    user_embedding,
)

__all__ = [
    "RecsysBatch", "RecsysConfig", "embedding_bag", "embedding_bag_ragged",
    "forward", "init_params", "init_table", "loss_fn", "retrieval_scores",
    "sharded_embedding_bag", "user_embedding",
]
